"""Parity of the port's train options with the JAX package, on the CPU:
pose jitter, cone stepping (march_rays_cone_plain, the plain version of
kernel F) and the staged eval's march-everything fallback, a whole -O step
with both, the parameter EMA and its checkpoints, and Shampoo.

Draws are reproduced from the JAX key tree and injected, weights carried
over with weights.from_jax_params. Tolerances: cameras 1e-5 (f32 trig in
two libraries); cone march counts equal on every ray and ts / dts to rtol
1e-5 / atol 1e-6; the -O step at test_torch_train.py's tolerances (loss
rel 1e-4, gradients 1e-3 of each leaf's largest entry, metrics 1e-5); the
fallback frame 1e-4 / 1e-5 (test_train_e2e.py:384); ema_update 1e-7;
Shampoo 1e-4 of each leaf's largest entry (f32 Newton iterations in
another library's matmul order).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu import cameras as jcam
from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.models import networks as jnet
from dreamfusion_tpu.ops import marching as jmarch
from dreamfusion_tpu.ops.composite import near_far_from_aabb as j_near_far
from dreamfusion_tpu.training import optimizers as jopt
from dreamfusion_tpu.training import shampoo as jshampoo
from dreamfusion_tpu.training import trainer as jtrainer

from dreamfusion_torch import cameras as tcam
from dreamfusion_torch.config import Config as TConfig
from dreamfusion_torch.config import parse_config
from dreamfusion_torch.models import networks as tnet
from dreamfusion_torch.ops import marching as tmarch
from dreamfusion_torch.training import optimizers as topt
from dreamfusion_torch.training import shampoo as tshampoo
from dreamfusion_torch.training import trainer as ttrainer
from dreamfusion_torch.weights import _convert, from_jax_params

from test_torch_eval import _eval_setup, _np
from test_torch_marching import (SMALL, _close, _compare_grads, _nerf_pair,
                                 _refresh, _t)
from test_torch_o2 import _projection_pair
from test_torch_ops import _pose_draws
from test_torch_train import _step_draws, concrete_shading  # noqa: F401

CPU = torch.device("cpu")


def _jitter_draws(key, B):
    """The pose-jitter draws of the JAX key tree (cameras.py:93, 122-125)."""
    k_pose, _ = jax.random.split(key)
    _, _, _, _, k_cj, k_tj, k_un = jax.random.split(k_pose, 7)
    return {"center_u": _t(jax.random.uniform(k_cj, (B, 3))),
            "target_n": _t(jax.random.normal(k_tj, (B, 3))),
            "up_n": _t(jax.random.normal(k_un, (B, 3)))}


# -- pose jitter -----------------------------------------------------------------

def test_jittered_cameras_match_jax():
    """rand_poses with jitter: centers + U[-0.1, 0.1), targets + N(0, 0.2^2),
    up + N(0, 0.02^2) before normalising, the JAX draws injected: 1e-5."""
    B, h, w = 8, 12, 10
    jcfg = JConfig(h=h, w=w, batch_size=B, jitter_pose=True)
    tcfg = TConfig(h=h, w=w, batch_size=B, jitter_pose=True)
    key = jax.random.PRNGKey(21)
    ref = jcam.sample_train_batch(key, jcfg)
    draws = {**_pose_draws(key, B, jcfg), **_jitter_draws(key, B)}
    got = tcam.sample_train_batch(tcfg, draws=draws, device=CPU)
    for k in ("rays_o", "rays_d"):
        _close(got[k], ref[k], 1e-5)
    np.testing.assert_array_equal(got["dir"].numpy(), np.asarray(ref["dir"]))
    plain = jcam.sample_train_batch(key, JConfig(h=h, w=w, batch_size=B))
    assert float(jnp.abs(plain["rays_o"] - ref["rays_o"]).max()) > 1e-3


def test_jitter_off_keeps_the_draw_stream():
    """Without jitter the batch takes exactly the draws it took before the
    option existed (radius, u_sphere, u_orbit, u_select, fov, in that order),
    so a seeded run's stream is unchanged; with it, three more follow."""
    cfg = TConfig(h=4, w=4, batch_size=3)
    g = torch.Generator().manual_seed(5)
    got = tcam.sample_train_batch(cfg, generator=g, device=CPU)
    r = torch.Generator().manual_seed(5)
    draws = {"radius": torch.rand(3, generator=r) * 0.5 + 1.0,
             "u_sphere": torch.rand(3, 3, generator=r),
             "u_orbit": torch.rand(3, 2, generator=r),
             "u_select": torch.rand(3, generator=r),
             "fov": torch.rand((), generator=r) * 30.0 + 40.0}
    assert torch.equal(g.get_state(), r.get_state())
    ref = tcam.sample_train_batch(cfg, draws=draws, device=CPU)
    assert torch.equal(got["rays_d"], ref["rays_d"])
    g2 = torch.Generator().manual_seed(5)
    tcam.sample_train_batch(cfg.replace(jitter_pose=True), generator=g2,
                            device=CPU)
    assert not torch.equal(g2.get_state(), g.get_state())


# -- cone stepping -----------------------------------------------------------------

def _slab_rays():
    """The rays and slab grid of tests/test_marching.py:248-283."""
    H = 32
    occ = np.zeros((1, H, H, H), bool)
    occ[0, :, :, 12:20] = True
    rng = np.random.RandomState(3)
    o = np.array([[0.0, 0.0, -2.5]] * 8)
    d = rng.normal(size=(8, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return occ, o.astype(np.float32), d.astype(np.float32), 1.0, 256, 128


def _random_rays(bound, seed=0, N=4096, H=32):
    """N seeded rays from outside the box through its middle, and a seeded
    random grid of every cascade (10% of the cells set); K = 16 truncates
    some rays."""
    rng = np.random.default_rng(seed)
    C = 1 + int(np.ceil(np.log2(max(bound, 1.0))))
    occ = rng.random((C, H, H, H)) < 0.1
    o = rng.normal(size=(N, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * rng.uniform(
        1.5, 3.0, (N, 1)) * bound / 1.5
    d = rng.uniform(-0.5, 0.5, (N, 3)) * bound - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return occ, o.astype(np.float32), d.astype(np.float32), bound, 256, 16


def _compare_marches(ref, got, label):
    jc, tc = np.asarray(ref.counts), got.counts.numpy()
    bad = np.nonzero(jc != tc)[0]
    for i in bad[:5]:
        print(f"{label}: ray {i} counts JAX {jc[i]} port {tc[i]}")
    assert bad.size == 0, (label, bad[:10])
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for k in ("ts", "dts"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{label} {k}")


@pytest.mark.parametrize("rays,dt_gamma,perturb", [
    ("slab", 1 / 128, False), ("slab", 0.05, False),
    ("bound1", 1 / 128, False), ("bound1", 1 / 128, True),
    ("bound1", 0.05, True), ("bound2", 1 / 128, False),
    ("bound2", 1 / 128, True), ("bound2", 0.05, False)])
def test_cone_march_matches_jax(rays, dt_gamma, perturb):
    """march_rays(dt_gamma > 0) on the CPU (march_rays_cone_plain) against
    the JAX scan: C = 1, and bound 2 (C = 2, the mip level from position
    and dt), with and without the start perturbation (JAX's draw
    injected)."""
    occ, o, d, bound, max_steps, K = (_slab_rays() if rays == "slab" else
                                      _random_rays(float(rays[-1])))
    aabb = jnp.array([-bound] * 3 + [bound] * 3, jnp.float32)
    near, far = j_near_far(jnp.asarray(o), jnp.asarray(d), aabb, 0.1)
    key = jax.random.PRNGKey(5) if perturb else None
    ref = jmarch.march_rays(key, jnp.asarray(occ), jnp.asarray(o),
                            jnp.asarray(d), near, far, bound=bound,
                            max_steps=max_steps, K=K, dt_gamma=dt_gamma,
                            perturb=perturb)
    u = (_t(jax.random.uniform(key, (o.shape[0],))) if perturb else None)
    got = tmarch.march_rays(_t(occ), _t(o), _t(d), _t(near), _t(far),
                            bound=bound, max_steps=max_steps, K=K,
                            dt_gamma=dt_gamma, perturb=perturb, perturb_u=u)
    _compare_marches(ref, got, f"{rays} g={dt_gamma} perturb={perturb}")
    assert int(got.counts.sum()) > 0
    if rays != "slab" and dt_gamma < 0.01:
        assert (got.counts > K).any()


def test_cone_constants_are_f32():
    """dt_gamma, dt_min, dt_max and 2 / H come rounded to f32 once."""
    g, lo, hi, cell = tmarch.cone_constants(0.02, 512, 2, 128)
    for v, want in ((g, 0.02), (lo, 2 * 3 ** 0.5 / 512),
                    (hi, 2 * 3 ** 0.5 * 2 / 128), (cell, 2 / 128)):
        assert v == float(np.float32(want))


# -- a whole -O step with cone stepping and jitter --------------------------------

def test_o_step_with_dt_gamma_and_jitter_matches_jax(concrete_shading):
    """One -O train step with --dt_gamma 1/128 and --jitter_pose against JAX
    make_grads_fn, the guidance a fixed projection of the image (SDS's own
    parity in a whole step is tests/test_torch_train.py's); max_steps 512
    so that dt grows with t (dt_min = 2 sqrt(3) / 512 < t / 128 past t =
    0.89)."""
    cfg_kw = dict(SMALL, dt_gamma=1 / 128, jitter_pose=True, max_steps=512,
                  guidance="none")
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    jm, params, tm = _nerf_pair(4)
    jg, tg = _projection_pair(cfg_kw)
    text_z = np.zeros((6, 1), np.float32)
    jstate = jmarch.init_grid_state(1, 16)
    tstate = tmarch.init_grid_state(1, 16, CPU)
    jstate, tstate = _refresh(jm, params, tm, cfg_kw, jstate, tstate,
                              jax.random.PRNGKey(6), 0)
    key = jax.random.PRNGKey(7)
    K = cfg_kw["grid_K"]
    jfn = jtrainer.make_grads_fn(jcfg, jm, jg, "grid", grid_K=K)
    jloss, jmet, jgrads = jfn(params, jnp.int32(0), jg.params,
                              jnp.asarray(text_z), key, jstate)
    draws = _step_draws(key, cfg_kw)
    draws.update(_jitter_draws(jax.random.split(key, 5)[0],
                               jcfg.batch_size))
    tfn = ttrainer.make_grads_fn(tcfg, tm, tg, grid_K=K)
    tloss, tmet = tfn(0, _t(text_z), tstate, draws=draws)
    _close(tloss, jloss, 1e-4)
    _compare_grads(jgrads, tm, 1e-3)
    for k in ("count_q95", "live_q95", "mean_count"):
        _close(tmet[k], jmet[k], 1e-5)
    assert float(tmet["mean_count"]) > 1.0


# -- the staged eval's fallback (dt_gamma > 0) -----------------------------------

def test_fallback_eval_matches_jax_and_direct(monkeypatch):
    """The staged frame with dt_gamma = 0.02 (16 x 16, grid 32, max_steps
    64, grid_K 32, f32 table; groups of 32) against JAX
    make_staged_grid_eval's fallback frame and against the port's own
    direct render_grid: 1e-4 / 1e-5. The march goes through march_rays
    once per group (kernel F's call on the GPU) and no kernel-C call."""
    jcfg, jm, params, gs, tcfg, tm, tgs = _eval_setup(1.0, "f32")
    jcfg = jcfg.replace(dt_gamma=0.02)
    tcfg = tcfg.replace(dt_gamma=0.02)
    b = jcam.sample_test_batch(jnp.array([0]), 10, jcfg)
    o, d = b["rays_o"][0], b["rays_d"][0]
    jframe = jtrainer.make_staged_grid_eval(jcfg, jm, 16, 16, chunk=64,
                                            group=32)(params, o, d, gs)
    fns = tnet.make_field_fns(tm)._replace(normal=None)
    direct = tmarch.render_grid(fns, tgs, _t(o), _t(d), bound=1.0,
                                min_near=tcfg.min_near, max_steps=64, K=32,
                                dt_gamma=0.02, bg_radius=tcfg.bg_radius,
                                light_d=tcam.safe_normalize(_t(o)[0]),
                                perturb=False)
    calls = {"march": 0, "compact": 0}
    march_fn = ttrainer.march_rays

    def march_spy(*a, **kw):
        calls["march"] += 1
        assert kw["dt_gamma"] == 0.02
        return march_fn(*a, **kw)

    def compact_spy(*a, **kw):
        calls["compact"] += 1
        raise AssertionError("the fallback composites dense")

    monkeypatch.setattr(ttrainer, "march_rays", march_spy)
    monkeypatch.setattr(tmarch, "composite_compact", compact_spy)
    timings = {}
    out = ttrainer.make_staged_grid_eval(tcfg, tm, 16, 16)(
        _t(o), _t(d), tgs, timings=timings)
    assert calls == {"march": 8, "compact": 0}
    assert set(timings) == {"bg", "march", "shade", "finish"}
    for k in ("image", "weights_sum", "depth"):
        np.testing.assert_allclose(_np(out[k]), np.asarray(jframe[k]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(out[k]).reshape(direct[k].shape),
                                   _np(direct[k]), rtol=1e-4, atol=1e-5)
    assert float(out["weights_sum"].max()) > 1e-3


# -- EMA -------------------------------------------------------------------------------

def test_ema_update_matches_jax():
    """decay e + (1 - decay) p, both factors in f32: JAX's ema_update as
    written (eager), 1e-7. (Inside the JAX package's jitted train step XLA
    contracts it to fma(e, decay, (1 - decay) p), one ulp away at times.)"""
    rng = np.random.default_rng(0)
    e = {"a": rng.normal(size=(7, 5)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in e.items()}
    for decay in (0.95, 0.9, 0.5):
        ref = jopt.ema_update(e, p, decay)
        got = {k: _t(v).clone() for k, v in e.items()}
        topt.ema_update(got, {k: _t(v) for k, v in p.items()}, decay)
        for k in e:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=0, atol=1e-7)


def _tiny_argv(ws, *extra):
    return ["-O", "--text", "x", "--guidance", "none", "--h", "8", "--w",
            "8", "--grid_size", "8", "--max_steps", "32", "--H", "12", "--W",
            "12", "--device", "cpu", "--workspace", str(ws), "--iters", "4",
            "--albedo_iters", "2", *extra]


def test_trainer_ema_is_the_chain_of_its_parameters(tmp_path):
    """Three steps: the EMA starts at the parameters and after each step
    equals decay e + (1 - decay) p of the new parameters, in f32."""
    cfg = parse_config(_tiny_argv(tmp_path, "--ema_decay", "0.9",
                                  "--dt_gamma", "0.02", "--jitter_pose"))
    tr = ttrainer.Trainer("t", cfg, use_checkpoint="scratch")
    chain = {k: p.detach().numpy().copy()
             for k, p in tr.model.named_parameters()}
    for k, v in tr.ema.items():
        np.testing.assert_array_equal(v.numpy(), chain[k])
    d, c = np.float32(0.9), np.float32(1.0 - 0.9)
    for _ in range(3):
        tr.train_step()
        for k, p in tr.model.named_parameters():
            chain[k] = chain[k] * d + p.detach().numpy() * c
    moved = max(float(np.abs(chain[k] - p.detach().numpy()).max())
                for k, p in tr.model.named_parameters())
    assert moved > 0
    for k, v in tr.ema.items():
        np.testing.assert_array_equal(v.numpy(), chain[k])


def test_best_checkpoint_holds_the_ema_and_latest_the_step(tmp_path):
    """tests/test_train_e2e.py:132-155 on the port: best.pt loads the EMA
    weights of step 2 (the EMA with them), latest loads step 4, and the two
    differ."""
    cfg = parse_config(_tiny_argv(tmp_path, "--ema_decay", "0.5",
                                  "--val_size", "1"))
    tr = ttrainer.Trainer("t", cfg, use_checkpoint="scratch")
    tr.train(max_steps=2, log_interval=1)
    tr.evaluate(step=2, size=1)
    assert tr.stats["best_result"] is not None
    best = {k: v.clone() for k, v in tr.ema.items()}
    tr.train(max_steps=4, log_interval=1)
    tr.save_checkpoint()
    t_best = ttrainer.Trainer("t", cfg, use_checkpoint="best")
    t_latest = ttrainer.Trainer("t", cfg, use_checkpoint="latest")
    assert (t_best.step, t_latest.step) == (2, 4)
    for k, p in t_best.model.named_parameters():
        assert torch.equal(p.detach(), best[k]), k
        assert torch.equal(t_best.ema[k], best[k]), k
    for k, v in t_latest.ema.items():
        assert torch.equal(v, tr.ema[k]), k
    diffs = [float((a - b).abs().max()) for a, b in zip(
        t_best.model.state_dict().values(),
        t_latest.model.state_dict().values())]
    assert max(diffs) > 0


# -- Shampoo -------------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 4])
def test_matrix_inverse_pth_root_matches_jax(p):
    """Seeded SPD matrices (one, and a batch of three): 1e-4 relative."""
    rng = np.random.default_rng(p)
    A = []
    for n in (8, 8, 8):
        m = rng.normal(size=(n, n)).astype(np.float32)
        A.append(m @ m.T + 0.1 * np.eye(n, dtype=np.float32))
    A = np.stack(A)
    got = tshampoo.matrix_inverse_pth_root(_t(A), p)
    for i in range(3):
        ref = np.asarray(jshampoo.matrix_inverse_pth_root(jnp.asarray(A[i]),
                                                          p))
        _close(got[i], ref, 1e-4)
        _close(tshampoo.matrix_inverse_pth_root(_t(A[i]), p), ref, 1e-4)


def _perturbed(tree, rel, seed=1):
    """Every entry of a tree of arrays times (1 +- rel), the signs seeded;
    rel 0 leaves it as it is."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: jnp.asarray(
        np.asarray(v) * (1 + rel * rng.choice([-1.0, 1.0], np.shape(v))),
        jnp.float32), tree)


def _rel_gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


CONTROLS = [(rel, seed) for rel in (2.0 ** -24, 2.0 ** -23)
            for seed in (1, 2, 3)]


def _shampoo_tol(control):
    """1e-4 of the leaf's largest entry, or 3x the largest change that
    CONTROLS (gradients times 1 +- 2^-24 or 2^-23, three sign patterns
    each) make in JAX's own result where that is larger. Rank-deficient
    statistics (a 1-D leaf's first g g^T; a table block of 128 rows and 2
    columns) leave the f32 Newton iteration ill-conditioned (cond ~1e10
    after the ridge): both packages land ~3% from float64 there, and JAX
    moves by 0.6-2.7% under a 2^-24 change of the gradients (ROADMAP
    queue 3)."""
    return max(1e-4, 3.0 * control)


def test_shampoo_matches_jax_over_12_updates():
    """block_size 8, refresh every 2, a decaying schedule: a ragged 20 x 6
    leaf (blocks 8 + 8 + 4 rows), the same leaf stored transposed (as the
    port's Linear weights are: the update is the transpose of JAX's), a
    1-D leaf of 11 and a scalar, 12 updates on seeded gradients: each
    leaf's update within 1e-4 of its largest entry or the rounding control
    (_shampoo_tol)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (20, 6), "b": (11,), "s": ()}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in
            shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in
              shapes.items()} for _ in range(12)]
    iters = 30

    def sched(count):
        return 0.05 * 0.1 ** jnp.minimum(count / iters, 1.0)

    tx = jshampoo.shampoo(sched, block_size=8, update_preconditioner_every=2)
    update = jax.jit(tx.update)

    def run_jax(rel=0.0, seed=0):
        jp = {k: jnp.asarray(v) for k, v in init.items()}
        state = tx.init(jp)
        for i, g in enumerate(grads):
            u, state = update(_perturbed(g, rel, 100 * seed + i), state, jp)
            jp = {k: jp[k] + u[k] for k in jp}
        return {k: np.asarray(v) - init[k] for k, v in jp.items()}

    ref = run_jax()
    controls = [run_jax(rel, seed) for rel, seed in CONTROLS]
    tp = {k: torch.nn.Parameter(_t(v).clone()) for k, v in init.items()}
    tp["wt"] = torch.nn.Parameter(_t(init["w"]).t().contiguous())
    opt = tshampoo.Shampoo(list(tp.values()), lr=0.05, block_size=8,
                           update_preconditioner_every=2)
    lr = torch.optim.lr_scheduler.LambdaLR(opt,
                                           topt.lambda_decay(iters, offset=1))
    for g in grads:
        for k in shapes:
            tp[k].grad = _t(g[k]).clone()
        tp["wt"].grad = _t(g["w"]).t().contiguous()
        opt.step()
        lr.step()
    got = {k: (tp[k].detach() - _t(init[k])).numpy() for k in shapes}
    got["wt"] = (tp["wt"].detach().t() - _t(init["w"])).numpy()
    for k, v in got.items():
        name = "w" if k == "wt" else k
        ctl = max(_rel_gap(c[name], ref[name]) for c in controls)
        _close(v, ref[name], _shampoo_tol(ctl))


def test_shampoo_block_regions_cover_the_leaf():
    """The -O table's 903,480 x 2 rows: 7,058 blocks of 128 x 2 and a
    ragged one of 56 x 2; blocks and back are the identity."""
    regions = tshampoo.block_regions((903_480, 2), 128)
    assert [(r[0][1], r[0][2], r[1][1], r[1][2]) for r in regions] == [
        (7058, 128, 1, 2), (1, 56, 1, 2)]
    x = torch.randn(20, 11)
    out = torch.empty_like(x)
    for r in tshampoo.block_regions(x.shape, 8):
        out[tuple(s[0] for s in r)] = tshampoo._from_blocks(
            tshampoo._to_blocks(x, r), r)
    assert torch.equal(out, x)


def _small_spec(cls):
    """A grid spec of one level of 17^3 rows (38 blocks of 128 and a ragged
    one), so that JAX's per-block Shampoo compiles in seconds."""
    def make(**kw):
        return cls(**{**kw, "num_levels": 1, "desired_resolution": None})
    return make


def _to_jax_tree(jtree, tensors):
    """Port tensors (state-dict names and layout) -> a flax-shaped tree."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jtree)
    out = []
    for path, arr in leaves:
        keys = [str(p.key) for p in path]
        keys = keys[1:] if keys[0] == "params" else keys
        key, _ = _convert(".".join(keys), np.asarray(arr))
        v = tensors[key].detach().numpy()
        out.append(jnp.asarray(v.T if keys[-1] == "kernel" else v))
    return jax.tree_util.tree_unflatten(treedef, out)


def test_trainer_shampoo_step_matches_jax_build_optimizer(monkeypatch,
                                                         tmp_path):
    """One step of a tiny -O trainer with --optimizer shampoo (two groups,
    the table at 10x LR, the schedule at count 1): its parameter update
    against JAX build_optimizer + tx.update on the same gradients (the
    port's), 1e-4 of each leaf's largest update or the rounding control
    (_shampoo_tol)."""
    monkeypatch.setattr(jnet, "GridEncoderSpec",
                        _small_spec(jnet.GridEncoderSpec))
    monkeypatch.setattr(tnet, "GridEncoderSpec",
                        _small_spec(tnet.GridEncoderSpec))
    jm, params, tm = _nerf_pair(3)
    assert tm.embeddings.shape[0] < 5_000
    cfg = parse_config(_tiny_argv(tmp_path, "--optimizer", "shampoo",
                                  "--lr", "0.01")).replace(fp16=False)
    tr = ttrainer.Trainer("t", cfg, model=tm, use_checkpoint="scratch")
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tr.update_grid(0)
    tr.train_step()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    jcfg = JConfig(**{f: getattr(cfg, f) for f in ("lr", "iters",
                                                   "optimizer", "adam_b1",
                                                   "adam_b2", "adam_eps")})
    jp = _to_jax_tree(params, before)
    tx = jopt.build_optimizer(jcfg, jp)
    jg = _to_jax_tree(params, grads)

    # jitted: XLA CPU crashes compiling the eager per-block lax.cond of a
    # second update
    update = jax.jit(tx.update)

    def jax_update(g):
        upd, _ = update(g, tx.init(jp), jp)
        return from_jax_params(jax.tree.map(np.asarray, upd))

    ref = jax_update(jg)
    controls = [jax_update(_perturbed(jg, rel, seed))
                for rel, seed in CONTROLS]
    for k, p in tm.named_parameters():
        ctl = max(_rel_gap(c[k], ref[k]) for c in controls)
        _close(p.detach() - before[k], ref[k].numpy(), _shampoo_tol(ctl))
    assert float((tm.embeddings.detach() - before["embeddings"]).abs()
                 .max()) > 0


def test_unknown_optimizer_raises(tmp_path):
    cfg = parse_config(_tiny_argv(tmp_path, "--optimizer", "sgd"))
    with pytest.raises(ValueError, match="adam, shampoo"):
        ttrainer.Trainer("t", cfg, use_checkpoint="scratch")
