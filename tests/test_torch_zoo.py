"""The port's DVGO model zoo (dreamfusion_torch/models/zoo.py) against the
JAX package's (dreamfusion_tpu/models/zoo.py), on the CPU.

Each field is initialised by the JAX package at world_size (8, 8, 8), k0 4
(NeRFWoNN 12), width 16, with the (field, decoder) pairs of
tests/test_zoo.py; its tree loads into the port's field with strict=True
(weights.from_jax_params), and the JAX key's draws are rebuilt and injected
(FastFFL: the jitter from k_ray, the corner choice uniform(k_noise)).
Compared on 8 rays: every output of render at 1e-5 of its largest entry,
and the gradient of an MSE loss for every parameter at 1e-4 of the leaf's
largest entry. FastFFL picks a corner by sum(cdf < u): a u within 1e-6 of
a cdf entry may pick another corner in the other package, so such samples
are counted and their rays left out of the comparison.

Two DVGOTrainer steps across a pg_scale milestone (DVGO360, FastFFL) are
held against the JAX trainer with the same draws; the DVGO360
contractions and the NeRFWoNN SH colour against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.models import zoo as jz
from dreamfusion_tpu.training import dvgo_trainer as jt

from dreamfusion_torch.models import dvgo as td
from dreamfusion_torch.models import zoo as tz
from dreamfusion_torch.training import dvgo_trainer as tt
from dreamfusion_torch.weights import from_jax_params

from test_torch_dvgo_pretrain import CPU, _np, _rays
from test_torch_dvgo_trainer import _batches

NEAR, FAR = 0.5, 5.0
N_RAYS = 8
PE = dict(rgbnet_name="basicmlp", rgbnet_width=16, rgbnet_depth=3,
          posbase_pe=2, viewbase_pe=2)
# the (field, decoder) pairs of tests/test_zoo.py:24-34
ZOO_CASES = {
    "dvp_fine": dict(k0_dim=4, **PE),
    "nwnn_fine": dict(k0_dim=12, rgbnet_name=None),
    "ffl_fine": dict(k0_dim=4, density_noise=0.5, **PE),
    "fastffl_fine": dict(k0_dim=4, **PE),
    "dvgo360_fine": dict(k0_dim=4, **PE),
}


@functools.lru_cache(maxsize=None)
def _jax_init(name, kw_items):
    jf = jz.get_field(name, **dict(kw_items))
    o, d, vd = _rays(4)
    init = jax.jit(functools.partial(
        jf.init, near=NEAR, far=FAR, bg=1.0,
        n_samples=jf.n_render_samples(FAR), method=jf.render))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), o, d, vd))
    params["params"]["density"] = params["params"]["density"] * 3 + 2
    return jf, params


def field_pair(name, kw):
    """(JAX field, its params with the density raised so that rays hit
    something, the port's field holding them: strict load). The JAX init
    of each case runs once per process."""
    kw = dict(world_size=(8, 8, 8), alpha_init=1e-2, **kw)
    jf, params = _jax_init(name, tuple(sorted(kw.items())))
    params = jax.tree.map(np.copy, params)
    tf = tz.get_field(name, **kw)
    tf.load_state_dict(from_jax_params(params), strict=True)
    return jf, params, tf


def rebuilt_draws(field, key, n_rays, n_samples):
    """The draws the JAX field takes from `key` in its render, as the
    port's keyword tensors (the names of the port field's draw_spec)."""
    from dreamfusion_torch.models.osr import OSR_Fine_V3

    names = field.draw_spec(n_rays, n_samples)
    if isinstance(field, OSR_Fine_V3):   # V3-V6, RGI: the key is the jitter's
        k_ray = k_other = key
    else:                                # (k_ray, k_noise) or (k_ray, k_jit)
        k_ray, k_other = jax.random.split(key)
    draws = {"jitter": jax.random.uniform(k_ray, (n_rays, 1))}
    if "noise" in names:
        draws["noise"] = jax.random.normal(k_other, (n_rays, n_samples))
    if "choice_u" in names:
        draws["choice_u"] = jax.random.uniform(k_other,
                                               (n_rays, n_samples, 1))
    if "shadow_jitter" in names:
        draws["shadow_jitter"] = jax.random.normal(k_other,
                                                   (n_rays, n_samples, 9))
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def close(a, b, rel=1e-5, err_msg=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape, err_msg)
    np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=err_msg)


def render_and_grad_parity(name, kw, key_seed=3, ray_keep=None):
    """Render N_RAYS rays in both packages with the same draws and compare
    the outputs (1e-5) and every parameter's gradient of an MSE loss
    (1e-4). The JAX side runs eagerly: under jit XLA rounds the sample
    positions otherwise, and a sample on a face of the box can fall out of
    it. ray_keep(tf, o, d, vd, draws, S) -> bool [N] (optional): the
    rays the comparison holds. Returns (port render, JAX render, keep)."""
    jf, params, tf = field_pair(name, kw)
    o, d, vd = _rays(N_RAYS)
    S = jf.n_render_samples(FAR)
    key = jax.random.PRNGKey(key_seed)
    draws = rebuilt_draws(tf, key, N_RAYS, S)
    keep = np.ones(N_RAYS, bool) if ray_keep is None else \
        ray_keep(tf, o, d, vd, draws, S)
    assert keep.any()
    tgt = np.random.default_rng(4).uniform(size=(N_RAYS, 3)).astype(np.float32)

    def jloss(p):
        r = jf.apply(p, o, d, vd, near=NEAR, far=FAR, bg=1.0, n_samples=S,
                     key=key, method=jf.render)
        return jnp.mean((r["rgb_marched"][keep] - tgt[keep]) ** 2), r

    (jl, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tf.render(torch.from_numpy(o), torch.from_numpy(d),
                    torch.from_numpy(vd), near=NEAR, far=FAR, bg=1.0,
                    n_samples=S, **draws)
    loss = ((out["rgb_marched"][keep] - torch.from_numpy(tgt)[keep]) ** 2
            ).mean()
    loss.backward()
    assert sorted(out) == sorted(jout)
    for k in jout:
        close(out[k][keep], np.asarray(jout[k])[keep], err_msg=k)
    close(loss, jl)
    grads = from_jax_params(jax.tree.map(np.asarray, jgrad))
    assert sorted(grads) == sorted(n for n, _ in tf.named_parameters())
    for n, p in tf.named_parameters():
        close(p.grad, grads[n], rel=1e-4, err_msg=n)
    return out, jout, keep


def test_registry_names_and_classes():
    from dreamfusion_tpu.models import osr as _josr  # noqa: F401
    from dreamfusion_torch.models import osr as _tosr  # noqa: F401

    assert sorted(tz.field_registry) == sorted(jz.field_registry)
    for name, cls in jz.field_registry.items():
        assert tz.field_registry[name].__name__ == cls.__name__, name
        assert issubclass(tz.field_registry[name], td.DVGOField), name
    assert tz.get_field("dvgo360_coarse", world_size=(4, 4, 4)).__class__ \
        is tz.DVGO360
    assert tz.get_field("dvgo_coarse", world_size=(4, 4, 4)).__class__ \
        is td.DVGOField


@pytest.mark.parametrize("name", sorted(ZOO_CASES))
def test_params_load_strictly(name):
    """The JAX tree of each pair fills the port's field exactly: every
    Linear is sized from what the field feeds its decoder."""
    _, params, tf = field_pair(name, ZOO_CASES[name])
    want = from_jax_params(params)
    for k, v in tf.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("name", ["dvp_fine", "nwnn_fine", "ffl_fine",
                                  "dvgo360_fine"])
def test_render_and_gradients_match(name):
    out, _, _ = render_and_grad_parity(name, ZOO_CASES[name])
    live = int((out["weights"] > 1e-7).sum())
    assert 0 < live < out["weights"].numel()


def _fastffl_untied(tf, o, d, vd, draws, S, eps=1e-6):
    """Rays none of whose live samples has a u within eps of a cdf entry
    of its corner weights (ties may pick another corner in JAX)."""
    with torch.no_grad():
        pts, oob = td.sample_ray(
            torch.from_numpy(o), torch.from_numpy(d), near=NEAR, far=FAR,
            xyz_min=tf.mins, xyz_max=tf.maxs, voxel_size=tf.voxel_size,
            stepsize=tf.stepsize, n_samples=S, jitter=draws["jitter"])
        alpha = torch.where(oob, 0.0, tf.query_alpha(pts))
        _, w = tf._liif_features(pts, torch.from_numpy(vd)[:, None].expand(
            pts.shape))
        cdf = torch.cumsum(w, -1) + 1e-3
        tie = ((cdf - draws["choice_u"]).abs() < eps).any(-1) \
            & (alpha > tf.alpha_thres)
    print(f"FastFFL: {int(tie.sum())} of {int((alpha > tf.alpha_thres).sum())}"
          " live samples within 1e-6 of a cdf entry")
    return ~tie.any(-1).numpy()


def test_fastffl_render_and_gradients_match_off_ties():
    out, jout, keep = render_and_grad_parity(
        "fastffl_fine", ZOO_CASES["fastffl_fine"], ray_keep=_fastffl_untied)
    # and without the draw, FFL's expected blend (eval)
    jf, params, tf = field_pair("fastffl_fine", ZOO_CASES["fastffl_fine"])
    o, d, vd = _rays(N_RAYS)
    S = jf.n_render_samples(FAR)
    ref = jf.apply(params, o, d, vd, near=NEAR, far=FAR, bg=1.0,
                   n_samples=S, method=jf.render)
    with torch.no_grad():
        got = tf.render(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(vd), near=NEAR, far=FAR, bg=1.0,
                        n_samples=S)
    for k in ref:
        close(got[k], ref[k], err_msg=k)


def test_ffl_liif_weights_partition_and_match():
    jf, params, tf = field_pair("ffl_fine", ZOO_CASES["ffl_fine"])
    pts = np.random.default_rng(2).uniform(-0.9, 0.9, (16, 3)).astype(
        np.float32)
    vd = np.tile(np.array([[0.0, 0, 1.0]], np.float32), (16, 1))
    pred, w = jf.apply(params, pts, vd, method=jf._liif_features)
    with torch.no_grad():
        tpred, tw = tf._liif_features(torch.from_numpy(pts),
                                      torch.from_numpy(vd))
    close(tpred, pred)
    close(tw, w)
    np.testing.assert_allclose(_np(tw.sum(-1)), 1.0, atol=1e-3)


def test_nwnn_sh_colour_matches():
    jf, params, tf = field_pair("nwnn_fine", ZOO_CASES["nwnn_fine"])
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    vd = rng.normal(size=(32, 3)).astype(np.float32)
    ref = jf.apply(params, pts, vd, method=jf.query_rgb)
    with torch.no_grad():
        close(tf.query_rgb(torch.from_numpy(pts), torch.from_numpy(vd)), ref)
    with pytest.raises(ValueError, match="3 \\* degree"):
        tz.NeRFWoNN(world_size=(4, 4, 4), k0_dim=6)


def test_dvgo360_contractions_match():
    kw = dict(world_size=(8, 8, 8), k0_dim=3, bg_dis=0.2,
              xyz_min=(-1.0, -0.5, -2.0), xyz_max=(1.0, 1.5, 0.0))
    jf, tf = jz.DVGO360(**kw), tz.DVGO360(**kw)
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(64, 3)) * 4).astype(np.float32)
    pts[:8] = rng.uniform(-0.4, 0.4, (8, 3))          # inner on every axis
    pts[8:16, 0] = 0.0                                 # the centre of axis 0
    p = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(0), pts,
                                         method=jf.normalize))
    for m in ("world_to_contract", "normalize"):
        close(getattr(tf, m)(torch.from_numpy(pts)),
              jf.apply(p, pts, method=getattr(jf, m)), err_msg=m)
    c = jf.apply(p, pts, method=jf.world_to_contract)
    close(tf.contract_to_world(torch.from_numpy(np.asarray(c))),
          jf.apply(p, c, method=jf.contract_to_world))
    back = _np(tf.contract_to_world(tf.world_to_contract(torch.from_numpy(pts))))
    np.testing.assert_allclose(back, pts, rtol=1e-4, atol=1e-4)


def jax_trainer_draws(tf, n_steps, n_rays, n_samples, seed=0):
    """The draws of the JAX trainer's steps: its key after the init split,
    split once per step (dvgo_trainer.py fit), each step's key as the
    render's."""
    key = jax.random.split(jax.random.PRNGKey(seed))[0]
    out = []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        out.append(rebuilt_draws(tf, k, n_rays, n_samples))
    return out


def trainer_steps_parity(name, kw, n_batch=40):
    """Two DVGOTrainer steps, a pg_scale milestone before the second (the
    grids re-interpolated, the optimizer rebuilt), against the JAX trainer
    from the same parameters, batches and draws: every parameter to 1e-4
    of its largest entry."""
    base = 6 * 6 * 6
    ws = jt.world_size_for((-1, -1, -1), (1, 1, 1), base)
    kw = dict(world_size=ws, alpha_init=1e-2, **kw)
    stage = jt.DVGOStageConfig(n_iters=2, lr_density=0.1, lr_k0=0.1,
                               lr_rgbnet=1e-2, batch_size=n_batch,
                               pg_scale=(1,))
    jf = jz.get_field(name, **kw)
    o, d, vd = _rays(4)
    params = jax.tree.map(np.asarray, jf.init(
        jax.random.PRNGKey(0), o, d, vd, near=1.0, far=5.0, bg=1.0,
        n_samples=jf.n_render_samples(5.0), method=jf.render))
    params["params"]["density"] = params["params"]["density"] + 1.0
    _, batches = _batches(2, n=n_batch)
    ref = jt.DVGOTrainer(jf, stage, near=1.0, far=5.0)
    ref.params = params
    ref.opt_state = ref.tx.init(params)
    ref.fit(batches, num_voxels_base=base)

    tf = tz.get_field(name, **kw)
    tr = tt.DVGOTrainer(tf, tt.DVGOStageConfig(**vars(stage)), near=1.0,
                        far=5.0, device=CPU)
    tf.load_state_dict(from_jax_params(params), strict=True)
    # the JAX trainer's draws: step 1 renders after the milestone, with the
    # finer grid's sample count
    n0 = tf.n_render_samples(5.0)
    n1 = tz.get_field(name, **dict(kw, world_size=jt.world_size_for(
        (-1, -1, -1), (1, 1, 1), 2 * base))).n_render_samples(5.0)
    d0 = jax_trainer_draws(tf, 2, n_batch, n0)[0]
    d1 = jax_trainer_draws(tf, 2, n_batch, n1)[1]
    tr.fit(batches, num_voxels_base=base, draws=lambda it: (d0, d1)[it])
    assert tf.world_size == ref.field.world_size
    assert type(tf) is tz.field_registry[name]
    want = from_jax_params(ref.params)
    got = tf.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        close(got[k], w, rel=1e-4, err_msg=k)
    return tr


@pytest.mark.parametrize("name", ["dvgo360_fine", "fastffl_fine"])
def test_trainer_steps_across_pg_scale_match(name):
    trainer_steps_parity(name, ZOO_CASES[name])
