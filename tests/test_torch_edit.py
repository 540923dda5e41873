"""Parity of the port's single-scene editing path (--backbone dvgo) with
the JAX package, on the CPU, at a small size: the 3-D grid sampler, the
registered decoders, the DVGO field loaded from one synthetic .dvgo file by
both packages, one SDS train step (albedo, and lambertian with the autograd
normal), the staged eval frame, the config and the checkpoint round trip.
Inputs come from numpy seeds; SD runs random-nano in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu import cameras as jcam
from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.models import decoders as jdec
from dreamfusion_tpu.models import kailu as jkailu
from dreamfusion_tpu.models.networks import build_model as j_build_model
from dreamfusion_tpu.models.networks import make_field_fns as j_field_fns
from dreamfusion_tpu.ops import grid_sample as jgs
from dreamfusion_tpu.ops import marching as jmarch
from dreamfusion_tpu.training import trainer as jtrainer
from dreamfusion_tpu.training.optimizers import build_optimizer as j_build_opt

from dreamfusion_torch.config import Config as TConfig
from dreamfusion_torch.config import parse_config
from dreamfusion_torch.models import decoders as tdec
from dreamfusion_torch.models import kailu as tkailu
from dreamfusion_torch.models.networks import build_model as t_build_model
from dreamfusion_torch.ops import grid_sample as tgs
from dreamfusion_torch.ops import marching as tmarch
from dreamfusion_torch.training import trainer as ttrainer
from dreamfusion_torch.training.optimizers import build_optimizer as t_build_opt
from dreamfusion_torch.weights import from_jax_grid_state, from_jax_params

from test_torch_marching import SMALL, _close, _refresh, _t
from test_torch_sd import random_params
from test_torch_train import (_sd_pair, _step_draws,  # noqa: F401
                              concrete_shading, f32_groupnorm)

CPU = torch.device("cpu")


# -- (g) the grid sampler ---------------------------------------------------------

def test_grid_sample_3d_forward_and_both_gradients_match_jax():
    """Values, d/d(position) and d/d(grid) of the differentiable sampler,
    and the grid-only backward (differentiable=False), 1e-5 of the largest
    entry; coordinates outside [0, 1] clamp to the border."""
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(5, 6, 7, 4)).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, (300, 3)).astype(np.float32)
    cot = rng.normal(size=(300, 5)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda g, p: jgs.grid_sample_3d(g, p),
                         jnp.asarray(grid), jnp.asarray(x))
    gg_j, gx_j = vjp(jnp.asarray(cot))
    gt, xt = _t(grid).requires_grad_(True), _t(x).requires_grad_(True)
    out = tgs.grid_sample_3d(gt, xt)
    (out * _t(cot)).sum().backward()
    _close(out, out_j, 1e-5)
    _close(gt.grad, gg_j, 1e-5)
    _close(xt.grad, gx_j, 1e-5)
    assert np.abs(np.asarray(gx_j)).max() > 0

    g2, x2 = _t(grid).requires_grad_(True), _t(x).requires_grad_(True)
    out2 = tgs.grid_sample_3d(g2, x2, differentiable=False)
    (out2 * _t(cot)).sum().backward()
    gg2_j = jax.grad(lambda g: jnp.sum(jgs.grid_sample_3d(
        g, jnp.asarray(x), differentiable=False) * cot))(jnp.asarray(grid))
    _close(out2, out_j, 1e-5)
    _close(g2.grad, gg2_j, 1e-5)
    assert x2.grad is None


def test_resize_grid_and_max_pool_match_jax():
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(3, 5, 6, 4)).astype(np.float32)
    _close(tgs.resize_grid_trilinear(_t(grid), (7, 9, 5)),
           jgs.resize_grid_trilinear(jnp.asarray(grid), (7, 9, 5)), 1e-5)
    for ks in (3, 5):
        got = tgs.max_pool_3d(_t(grid), ks)
        assert got.shape == grid.shape
        _close(got, jgs.max_pool_3d(jnp.asarray(grid), ks), 1e-5)


# -- (h) the decoders ---------------------------------------------------------------

@pytest.mark.parametrize("name,depth", [("resmlp", 3), ("resmlp", 5),
                                        ("basicmlp", 4), ("mlp", 2)])
def test_decoders_match_jax_through_from_jax_params(name, depth):
    kw = dict(in_dim=20, out_dim=3, width=16, depth=depth, k0_dim=6)
    jm, tm = jdec.get_MLP(name, **kw), tdec.get_MLP(name, **kw)
    assert type(tm).__name__ == type(jm).__name__
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 20))), depth)
    tm.load_state_dict(from_jax_params(params))
    x = np.random.default_rng(2).normal(size=(64, 20)).astype(np.float32)
    _close(tm(_t(x)), jm.apply(params, jnp.asarray(x)), 1e-5)
    fresh = tdec.get_MLP(name, **kw)
    assert not fresh.dense_out.bias.abs().any()            # zero final bias
    with pytest.raises(KeyError):
        tdec.get_MLP("shadowmlp", **kw)


# -- (i) one .dvgo file, both packages -------------------------------------------------

def _write_dvgo(path, rgbnet="resmlp", seed=0, ws=(8, 8, 8)):
    """A torch-lightning-style .dvgo checkpoint (the format of
    tests/test_dvgo.py:150-171) from a numpy seed: a dense ball (density
    +25 inside radius 0.6 of the box, -5 outside, noise 1) so that rays hit
    something; k0 6 channels, rgbnet 16 x 3, PE 2 / 2."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    lin = [np.linspace(-1, 1, n) for n in ws]
    r = np.sqrt(sum(g ** 2 for g in np.meshgrid(*lin, indexing="ij")))
    density = np.where(r < 0.6, 25.0, -5.0) + rng.normal(size=ws)
    state = {
        "density": torch.from_numpy(density.astype(np.float32))[None, None],
        "k0": t(1, 6, *ws),
        "xyz_min": torch.tensor([-1.0, -1, -1]),
        "xyz_max": torch.tensor([1.0, 1, 1]),
        "voxel_size_ratio": torch.tensor(1.0),
    }
    seq = {"resmlp": ("0", "2.net", "3"), "mlp": ("0", "2", "4")}[rgbnet]
    dims = ((16, 6 + 15 + 15), (16, 16), (3, 16))
    for key, (o, i) in zip(seq, dims):
        state[f"rgbnet.net.{key}.weight"] = t(o, i) / np.sqrt(i)
        state[f"rgbnet.net.{key}.bias"] = 0.1 * t(o)
    ckpt = {"state_dict": state,
            "hyper_parameters": {"params": {"cfg": {"fine_model_and_render": {
                "rgbnet": rgbnet, "rgbnet_width": 16, "rgbnet_depth": 3,
                "posbase_pe": 2, "viewbase_pe": 2, "alpha_init": 1e-6,
                "stepsize": 0.5}}}}}
    torch.save(ckpt, path)
    return state


def _edit_pair(path, cfg_kw, seed=3):
    """The JAX editing field with its params (numpy-filled, then the .dvgo
    file loaded by the JAX package) and the port's field: its background
    net through from_jax_params, its scene through its own loader."""
    kw = dict(cfg_kw, backbone="dvgo", pretrained_dvgo=path)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jm = j_build_model(jcfg)
    params = random_params(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)),
        method=jm.init_all), seed)
    params = jm.load_pretrained(params, path)
    params = jax.tree.map(np.asarray, params)
    tm = t_build_model(tcfg, CPU, torch.Generator().manual_seed(0))
    flat = from_jax_params(params)
    assert set(flat) == set(tm.state_dict())
    tm.load_state_dict({k: v for k, v in flat.items()
                        if not k.startswith("main.")}, strict=False)
    tm.load_pretrained(path)
    for k, v in tm.state_dict().items():        # both loaders agree, exactly
        assert torch.equal(v, flat[k]), k
    return jcfg, jm, params, tcfg, tm


@pytest.mark.parametrize("rgbnet", ["resmlp", "mlp"])
def test_dvgo_edit_network_matches_jax(tmp_path, rgbnet):
    """peek_dvgo_checkpoint equal; the loaded state equal exactly (ResMLP
    and BasicMLP naming); from_jax_params passes the 4-D grids through;
    common, normal (autograd, also under no_grad) and background 1e-5."""
    path = str(tmp_path / "scene.dvgo")
    state = _write_dvgo(path, rgbnet)
    assert tkailu.peek_dvgo_checkpoint(path) == jkailu.peek_dvgo_checkpoint(path)
    jcfg, jm, params, tcfg, tm = _edit_pair(path, dict(text="x"))
    assert tm.main.density.shape == (1, 8, 8, 8)
    assert tm.main.k0.shape == (6, 8, 8, 8)
    assert torch.equal(tm.main.density, state["density"][0])
    assert type(tm.main.rgbnet).__name__ == type(
        jm.bind(params).main.rgbnet).__name__
    np.testing.assert_allclose(tm.main.act_shift, jm.bind(params).main.act_shift)
    np.testing.assert_allclose(tm.main.voxel_size,
                               jm.bind(params).main.voxel_size)

    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    sig_j, alb_j = jm.apply(params, jnp.asarray(x), method=jm.common)
    inside = np.abs(np.asarray(x)).max(-1) <= 0.8       # 1.25 scale
    assert inside.any() and (~inside).any()
    with torch.no_grad():
        sig, alb = tm.common(_t(x))
        nrm = tm.normal(_t(x))
        bg = tm.background(_t(x))
        dens = tm.density(_t(x))
    _close(sig, sig_j, 1e-5)
    _close(alb, alb_j, 1e-5)
    assert np.allclose(alb.numpy()[~inside], 0.5) and float(sig.max()) > 50
    _close(nrm, jm.apply(params, jnp.asarray(x), method=jm.normal), 1e-5)
    assert float(nrm.abs().max()) > 0.5 and not nrm.requires_grad
    _close(bg, jm.apply(params, jnp.asarray(x), method=jm.background), 1e-5)
    assert torch.equal(dens["sigma"], sig)
    _close(tm.main.query_alpha(_t(x)),
           jm.apply(params, jnp.asarray(x),
                    method=lambda m, p: m.main.query_alpha(p)), 1e-5)


def test_softplus_matches_jax_around_act_shift():
    """sigma = softplus(density + act_shift) with act_shift ~ -13.8:
    torch's softplus (linear above its threshold of 20) against
    jax.nn.softplus, 1e-6 relative, from deep in the tail to far above."""
    shift = np.log(1.0 / (1.0 - 1e-6) - 1.0)
    d = np.linspace(-40.0, 80.0, 2401).astype(np.float32)
    got = torch.nn.functional.softplus(_t(d) + shift).numpy()
    ref = np.asarray(jax.nn.softplus(jnp.asarray(d) + shift))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-30)


# -- (j) one train step --------------------------------------------------------------------

def _shading_key(jcfg, step, code):
    """A PRNG key whose shading draw (trainer.py:84) gives `code`."""
    for n in range(100):
        key = jax.random.PRNGKey(100 + n)
        k_shade = jax.random.split(key, 5)[1]
        if int(jtrainer._shading_schedule(k_shade, step,
                                          jcfg.albedo_iters)[0]) == code:
            return key
    raise AssertionError(f"no draw of shading code {code} found")


def _lambertian_key(jcfg, step):
    return _shading_key(jcfg, step, 1)


def test_edit_train_step_matches_jax_and_grids_stay_frozen(
        tmp_path, f32_groupnorm, concrete_shading):
    """One SDS step with albedo shading and one with lambertian shading
    (the autograd normal and the orient loss): loss rel 1e-4, rgbnet and
    bg_net gradients 1e-3 of each leaf's largest entry. The port keeps no
    graph through the normal; JAX differentiates through it (second order),
    which reaches only the frozen grids, so the trainable leaves agree
    (the orient loss, a sum over f32 autograd normals, to 1e-3). Both steps
    run on the same parameters. The frozen grids get no gradient, sit in no
    optimizer group and are bitwise unchanged after two optimizer steps."""
    path = str(tmp_path / "scene.dvgo")
    _write_dvgo(path)
    cfg_kw = dict(SMALL, albedo_iters=1)
    jcfg, jm, params, tcfg, tm = _edit_pair(path, cfg_kw)
    opt, sched = t_build_opt(tcfg, tm)
    grouped = {id(p) for g in opt.param_groups for p in g["params"]}
    names = dict(tm.named_parameters())
    frozen = [k for k in names if k.startswith(("main.density", "main.k0"))]
    assert frozen == ["main.density", "main.k0"]
    for k, p in names.items():
        assert (id(p) in grouped) == (k not in frozen) == p.requires_grad, k
    before = {k: v.clone() for k, v in tm.state_dict().items()}

    jg, tg = _sd_pair()
    text_z = np.random.default_rng(5).normal(size=(6, 2, 77, 16)).astype(np.float32)
    jstate = jmarch.init_grid_state(1, 16)
    tstate = tmarch.init_grid_state(1, 16, CPU)
    jstate, tstate = _refresh(jm, params, tm, cfg_kw, jstate, tstate,
                              jax.random.PRNGKey(6), 0)
    assert 0.02 < float(tstate.occ.float().mean()) < 0.9

    K = cfg_kw["grid_K"]
    for step_idx, key, code in ((0, jax.random.PRNGKey(7), 0),
                                (1, _lambertian_key(jcfg, 1), 1)):
        jfn = jtrainer.make_grads_fn(jcfg, jm, jg, "grid", grid_K=K)
        jloss, jmet, jgrads = jfn(params, jnp.int32(step_idx), jg.params,
                                  jnp.asarray(text_z), key, jstate)
        tfn = ttrainer.make_grads_fn(tcfg, tm, tg, grid_K=K)
        tloss, tmet = tfn(step_idx, _t(text_z), tstate,
                          draws=_step_draws(key, cfg_kw))
        assert tmet["shading_code"] == int(jmet["shading_code"]) == code
        _close(tloss, jloss, 1e-4)
        if code == 1:
            assert float(tmet["loss_orient"]) > 0
            _close(tmet["loss_orient"], jmet["loss_orient"], 1e-3)
        flat = from_jax_params(jax.tree.map(np.asarray, jgrads))
        for k, p in names.items():
            if k in frozen:
                assert p.grad is None, k
            else:
                assert float(flat[k].abs().max()) > 0, k
                _close(p.grad, flat[k].numpy(), 1e-3)

    for _ in range(2):                  # two Adam steps on the last gradients
        opt.step()
        sched.step()
    after = tm.state_dict()
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
    for k in ("main.rgbnet.dense_in.weight", "main.rgbnet.res_0.net.weight",
              "main.rgbnet.dense_out.bias", "bg_net.dense_0.weight"):
        assert not torch.equal(after[k], before[k]), k


def test_edit_step_that_reaches_no_parameter_steps_adam_as_optax(
        tmp_path, f32_groupnorm, concrete_shading):
    """--bg_radius 0 (no background net): a textureless step's loss reaches
    no trainable parameter. jax.grad gives zeros there and optax's Adam
    still decays its moments, advances its count and moves rgbnet by about
    the learning rate; the port's step must do the same. One albedo step
    (Adam on the JAX gradients on both sides, as in the grid backbone's
    step test), then a textureless step and two Adam updates on the port's
    own gradients of it: after each update, every rgbnet leaf 1e-6 and
    Adam's moments 1e-5 of each leaf's largest entry, and the step count,
    against optax."""
    path = str(tmp_path / "scene.dvgo")
    _write_dvgo(path)
    cfg_kw = dict(SMALL, albedo_iters=1, bg_radius=0.0)
    jcfg, jm, params, tcfg, tm = _edit_pair(path, cfg_kw)
    assert tm.bg_net is None
    tx = j_build_opt(jcfg, params, frozen_prefixes=jm.frozen_prefixes)
    opt_state = tx.init(params)
    opt, sched = t_build_opt(tcfg, tm)
    trainable = {k: p for k, p in tm.named_parameters() if p.requires_grad}
    assert sorted(trainable) == sorted(
        k for k in tm.state_dict() if k.startswith("main.rgbnet."))

    jg, tg = _sd_pair()
    text_z = np.random.default_rng(5).normal(size=(6, 2, 77, 16)).astype(np.float32)
    jstate = jmarch.init_grid_state(1, 16)
    tstate = tmarch.init_grid_state(1, 16, CPU)
    jstate, tstate = _refresh(jm, params, tm, cfg_kw, jstate, tstate,
                              jax.random.PRNGKey(6), 0)

    def rgbnet_leaves(tree):
        return {k: v.numpy() for k, v in from_jax_params(jax.tree.map(
            np.asarray, {"params": {"main": {"rgbnet": tree["params"]["main"][
                "rgbnet"]}}})).items()}

    K = cfg_kw["grid_K"]
    n_updates = 0
    for step_idx, (key, code, updates_here) in enumerate((
            (jax.random.PRNGKey(7), 0, 1), (_shading_key(jcfg, 1, 2), 2, 2))):
        jfn = jtrainer.make_grads_fn(jcfg, jm, jg, "grid", grid_K=K)
        jloss, jmet, jgrads = jfn(params, jnp.int32(step_idx), jg.params,
                                  jnp.asarray(text_z), key, jstate)
        tfn = ttrainer.make_grads_fn(tcfg, tm, tg, grid_K=K)
        tloss, tmet = tfn(step_idx, _t(text_z), tstate,
                          draws=_step_draws(key, cfg_kw))
        assert tmet["shading_code"] == int(jmet["shading_code"]) == code
        _close(tloss, jloss, 1e-4)
        jflat = rgbnet_leaves(jgrads)
        if code == 0:
            # Adam's first step moves a leaf by lr * sign(g): feed both
            # sides one gradient, so that the steps after compare like
            # with like
            for k, p in trainable.items():
                _close(p.grad, jflat[k], 1e-3)
                p.grad = torch.from_numpy(jflat[k]).clone()
        else:
            for k, p in trainable.items():
                assert p.grad is not None and not p.grad.any(), k
                assert not jflat[k].any(), k
        for _ in range(updates_here):
            updates, opt_state = tx.update(jgrads, opt_state, params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
            before = {k: p.detach().clone() for k, p in trainable.items()}
            opt.step()
            sched.step()
            n_updates += 1

            adam = opt_state.inner_states["net"].inner_state[0]
            want, mu, nu = (rgbnet_leaves(t)
                            for t in (params, adam.mu, adam.nu))
            for k, p in trainable.items():
                _close(p.detach(), want[k], 1e-6)
                assert not torch.equal(p.detach(), before[k]), k  # it moved
                st = opt.state[p]
                assert int(st["step"]) == int(adam.count) == n_updates
                _close(st["exp_avg"], mu[k], 1e-5)
                _close(st["exp_avg_sq"], nu[k], 1e-5)
    for k in tm.frozen_prefixes:
        assert not dict(tm.named_parameters())[k].requires_grad


# -- (k) the staged eval frame ------------------------------------------------------------

@pytest.mark.parametrize("bg_radius", [1.4, 0.0])
def test_staged_eval_of_the_edit_field_matches_jax_direct_render(tmp_path,
                                                                 bg_radius):
    """The staged 16 x 16 eval frame (group 32) of the dvgo field against
    the JAX package's direct full-K render_grid of the same pose, rtol 1e-4
    / atol 1e-5; eval_table_bf16 stays at its default and must not reach a
    field without a table."""
    path = str(tmp_path / "scene.dvgo")
    _write_dvgo(path)
    kw = dict(text="x", grid_ray=True, fp16=False, grid_size=32, max_steps=64,
              grid_K=32, H=16, W=16, bg_radius=bg_radius)
    jcfg, jm, params, tcfg, tm = _edit_pair(path, kw)
    assert tcfg.eval_table_bf16 and not tm.has_table
    gs = jmarch.make_update_extra_state(jcfg, jm)(
        params, jmarch.init_grid_state(1, 32), jax.random.PRNGKey(0))
    b = jcam.sample_test_batch(jnp.array([0]), 10, jcfg)
    o, d = b["rays_o"][0], b["rays_d"][0]
    ref = jax.jit(lambda p, gs, o, d: jmarch.render_grid(
        jax.random.PRNGKey(0), j_field_fns(jm, p)._replace(normal=None), gs,
        o, d, bound=1.0, min_near=jcfg.min_near, max_steps=64, K=32,
        bg_radius=bg_radius, light_d=jcam.safe_normalize(o[0]),
        perturb=False))(params, gs, o, d)
    render = ttrainer.make_staged_grid_eval(tcfg.replace(max_ray_batch=32),
                                            tm, 16, 16)
    out = render(_t(o), _t(d), from_jax_grid_state(gs, CPU))
    for k in ("image", "weights_sum", "depth"):
        np.testing.assert_allclose(
            out[k].numpy().reshape(ref[k].shape), np.asarray(ref[k]),
            rtol=1e-4, atol=1e-5)
    assert float(out["weights_sum"].max()) > 0.5         # the ball is hit


# -- (l) config and checkpoints ----------------------------------------------------------------

def test_parse_config_and_trainer_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "scene.dvgo")
    state = _write_dvgo(path)
    cfg = parse_config(["--backbone", "dvgo", "--pretrained_dvgo", path, "-O"])
    assert (cfg.backbone, cfg.pretrained_dvgo) == ("dvgo", path)
    assert cfg.grid_ray and cfg.dir_text and cfg.fp16
    assert parse_config([]).backbone == "grid"
    # the vanilla backbone is built since path A landed; a backbone the port
    # does not know is refused, and the message lists the choices
    assert type(t_build_model(cfg.replace(backbone="vanilla"), CPU)
                ).__name__ == "NeRFVanillaNetwork"
    with pytest.raises(NotImplementedError, match="vanilla"):
        t_build_model(cfg.replace(backbone="tcnn"), CPU)

    cfg = cfg.replace(text="x", guidance="none", h=8, w=8, grid_size=8,
                      max_steps=32, iters=2, H=8, W=8, test_size=1,
                      device="cpu", workspace=str(tmp_path / "ws"))
    tr = ttrainer.Trainer("e", cfg, use_checkpoint="scratch")
    assert torch.equal(tr.model.main.density, state["density"][0])
    assert torch.equal(tr.model.main.rgbnet.res_0.net.weight,
                       state["rgbnet.net.2.net.weight"])
    tr.train(max_steps=2, log_interval=1, checkpoint_at_end=False)
    with torch.no_grad():       # a trained colour MLP differs from the file's
        tr.model.main.rgbnet.dense_in.weight.add_(0.25)
    tr.save_checkpoint()
    tr2 = ttrainer.Trainer("e", cfg, use_checkpoint="latest")
    assert tr2.step == 2
    for (k, a), b in zip(tr.model.state_dict().items(),
                         tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert not torch.equal(tr2.model.main.rgbnet.dense_in.weight,
                           state["rgbnet.net.0.weight"])
    assert not tr2.model.main.density.requires_grad
    assert torch.equal(tr.grid_state.occ, tr2.grid_state.occ)
    frames = tr2.test(write_video=False)
    assert frames[0].shape == (8, 8, 3)
