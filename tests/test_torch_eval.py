"""Parity of the port's staged eval with the JAX package, on the CPU.

Module by module (same numpy inputs, JAX on the CPU; Pallas kernels in
interpret mode): the plain versions of kernels C and D against the JAX
kernels, the pooled classify grid, the coarse hit window, the windowed
march with and without its density payload, probe_density, the compact
compositor (and a numpy emulation of kernel C's order against its plain
version and against kernel B-fwd's on the expanded layout), the test
cameras and the bf16-table encode. Ints and bools
match exactly, floats to 1e-5 unless a test says why not. Then the whole
staged eval at 16 x 16 against the JAX package's direct render_grid (f32
table 1e-4 / 1e-5, bf16 table 5e-2 / 2e-2, the tolerances of
tests/test_train_e2e.py:281), at one cascade and at --bound 2, and
Trainer.evaluate / Trainer.test against the JAX eval loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu import cameras as jcam
from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.models.networks import make_field_fns as j_field_fns
from dreamfusion_tpu.ops import marching as jmarch
from dreamfusion_tpu.ops.composite import near_far_from_aabb as j_near_far

from dreamfusion_torch import cameras as tcam
from dreamfusion_torch import trace
from dreamfusion_torch.config import Config as TConfig
from dreamfusion_torch.ops import marching as tmarch
from dreamfusion_torch.ops import probe as tprobe
from dreamfusion_torch.training import trainer as ttrainer
from dreamfusion_torch.weights import from_jax_grid_state

from test_torch_cuda import _crossing_rays
from test_torch_marching import _nerf_pair, _t
from test_torch_ops import _kernel_b_emulation, _warp_scan, _warp_sum

CPU = torch.device("cpu")
BOX = [-1.0] * 3 + [1.0] * 3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _close(a, b, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)


def _rays(n, seed, origin_scale=4.0):
    """n rays from a cube of side origin_scale around the box, unit
    directions, and their near/far against [-1, 1]^3 (numpy f32)."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(size=(n, 3)) * origin_scale
         - origin_scale / 2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = j_near_far(jnp.asarray(o), jnp.asarray(d), jnp.array(BOX),
                           0.05)
    return o, d, np.asarray(near), np.asarray(far)


def _occ(seed, shape, p):
    return np.random.default_rng(seed).uniform(size=shape) < p


# -- kernels C and D: plain versions vs the JAX kernels ------------------------

def test_probe_select_small_plain_matches_jax_interpret():
    """K4 (interpret mode) vs the port's plain gather on the pooled 32^3
    grid's size, u8 payloads above 1, a padded tail: exact."""
    from dreamfusion_tpu.ops.pallas_probe import probe_select_small

    rng = np.random.default_rng(9)
    T = 32768
    tab = rng.integers(0, 256, T).astype(np.uint8)
    idx = rng.integers(0, T, 5001).astype(np.int32)
    ref = probe_select_small(jnp.asarray(tab), jnp.asarray(idx),
                             interpret=True)
    got = tprobe.probe_select_small(_t(tab), _t(idx))
    assert got.dtype == torch.uint8
    _eq(got.float(), ref)
    assert tprobe.fits(T) and tprobe.fits(512 * 128)
    assert not tprobe.fits(128 ** 3) and not tprobe.fits(1000)


def _ray_major_ids(rng, T, n_tail):
    """Ray-major compact ids (runs of 0-40 samples a ray, some rays empty)
    followed by an invalid tail of id 0 (marching.py:667-674)."""
    lens = rng.integers(0, 41, T)
    lens[rng.uniform(size=T) < 0.3] = 0
    runs = np.repeat(np.arange(T), lens)
    return np.concatenate([runs, np.zeros(n_tail, np.int64)]).astype(
        np.int32), runs.shape[0]


def test_scatter_add_wide_plain_matches_jax_interpret_and_oracle():
    """K3 (interpret mode) rounds the updates to bf16 for its matmul: held
    at 2e-2 of the largest update (test_pallas_scatter.py:82); the f32
    .at[].add oracle at 1e-6. The ids are ray-major runs with an invalid
    tail of id 0 whose updates are zero."""
    from dreamfusion_tpu.ops.pallas_scatter import matmul_scatter_add_wide

    rng = np.random.default_rng(3)
    T = 256
    idx, n_valid = _ray_major_ids(rng, T, 1500)
    upd = rng.normal(size=(idx.shape[0], 6)).astype(np.float32)
    upd[n_valid:] = 0.0
    got = tmarch.scatter_add_wide_plain(_t(idx), _t(upd), T)
    upd16 = np.zeros((16, idx.shape[0]), np.float32)
    upd16[:6] = upd.T
    ref = np.asarray(matmul_scatter_add_wide(jnp.asarray(idx),
                                             jnp.asarray(upd16), T,
                                             interpret=True))[:, :6]
    scale = np.abs(upd).max()
    _close(got / scale, ref / scale, atol=2e-2)
    oracle = np.asarray(jnp.zeros((T, 6)).at[jnp.asarray(idx)].add(
        jnp.asarray(upd)))
    _close(got, oracle, atol=1e-6)


# -- marching, eval side -------------------------------------------------------

@pytest.mark.parametrize("C", [1, 2])
def test_pool_and_dilate_occ_match_jax(C):
    occ = _occ(0, (C, 32, 32, 32), 0.01)
    _eq(tmarch.pool_occ(_t(occ), 4), jmarch.pool_occ(jnp.asarray(occ), 4))
    _eq(tmarch.dilate_occ(_t(occ)), jmarch.dilate_occ(jnp.asarray(occ)))
    for args in ((512, 128, 4), (64, 32, 4)):
        assert tmarch.max_pooled_stride(*args) == jmarch.max_pooled_stride(*args)
    assert tmarch.max_coarse_stride(512, 128) == jmarch.max_coarse_stride(512, 128)


@pytest.mark.parametrize("C,stride", [(1, 4), (2, 1)])
def test_coarse_hit_window_matches_jax(C, stride):
    """Counts exact, the [t_lo, t_hi] bracket to 1e-5; at one cascade on
    the pooled grid (the K4 route), at two on the fine grid."""
    occ = _occ(1, (C, 32, 32, 32), 0.02)
    grid = jmarch.pool_occ(jnp.asarray(occ), 4) if C == 1 else jnp.asarray(occ)
    bound = float(2 ** (C - 1))
    o, d, near, far = _rays(300, 2, origin_scale=4.0 * bound)
    near, far = j_near_far(jnp.asarray(o), jnp.asarray(d),
                           jnp.array([-bound] * 3 + [bound] * 3), 0.05)
    ref = jmarch.coarse_hit_window(grid, o, d, near, far, bound=bound,
                                   max_steps=128, stride=stride)
    got = tmarch.coarse_hit_window(_t(np.asarray(grid)), _t(o), _t(d),
                                   _t(near), _t(far), bound=bound,
                                   max_steps=128, stride=stride)
    _eq(got[0], ref[0])
    assert int(ref[0].max()) > 0 and int(ref[0].min()) == 0
    _close(got[1], ref[1])
    _close(got[2], ref[2])
    cnt = tmarch.coarse_hit_counts(_t(np.asarray(grid)), _t(o), _t(d),
                                   _t(near), _t(far), bound=bound,
                                   max_steps=128, stride=stride)
    _eq(cnt, jmarch.coarse_hit_counts(grid, o, d, near, far, bound=bound,
                                      max_steps=128, stride=stride))


@pytest.mark.parametrize("payload", [False, True])
def test_march_rays_window_matches_jax(payload):
    """The windowed march over the coarse bracket, with the density payload
    (the single-cascade eval) and without: valid and counts exact, ts,
    dts and the payload 1e-5."""
    occ = _occ(3, (1, 32, 32, 32), 0.03)
    dgrid = (np.where(occ, 50.0, 0.0) + np.random.default_rng(4).uniform(
        size=occ.shape) * 0.5).astype(np.float32)
    occ = dgrid > 10.0
    o, d, near, far = _rays(128, 5)
    _, t_lo, _ = jmarch.coarse_hit_window(jmarch.pool_occ(jnp.asarray(occ),
                                                          4),
                                          o, d, near, far, bound=1.0,
                                          max_steps=128, stride=8)
    kw = dict(bound=1.0, max_steps=128, S=64, K=48)
    jkw = dict(kw, density_grid=jnp.asarray(dgrid),
               occ_thresh=jnp.float32(10.0)) if payload else kw
    tkw = dict(kw, density_grid=_t(dgrid),
               occ_thresh=torch.tensor(10.0)) if payload else kw
    m_j, s_j = jmarch.march_rays_window(jnp.asarray(occ), o, d, near, far,
                                        t_lo, **jkw)
    m_t, s_t = tmarch.march_rays_window(_t(occ), _t(o), _t(d), _t(near),
                                        _t(far), _t(np.asarray(t_lo)), **tkw)
    _eq(m_t.valid, m_j.valid)
    _eq(m_t.counts, m_j.counts)
    assert int(m_j.counts.max()) > 0
    _close(m_t.ts, m_j.ts)
    _close(m_t.dts, m_j.dts)
    if payload:
        _close(s_t, s_j)
    else:
        assert s_t is None and s_j is None


def test_probe_density_matches_jax():
    dgrid = np.random.default_rng(6).uniform(
        size=(1, 32, 32, 32)).astype(np.float32) * 30.0
    o, d, near, _ = _rays(64, 7)
    ts = (near[:, None] + 0.02 * np.arange(40)[None, :]).astype(np.float32)
    _close(tmarch.probe_density(_t(dgrid), _t(o), _t(d), _t(ts), 1.0),
           jmarch.probe_density(jnp.asarray(dgrid), o, d, ts, 1.0))


def _compact_inputs(N, K, M, opaque, seed=42):
    """A compact buffer of budget M for N rays of up to K + 2 marched
    samples (numpy f32 samples, zero sigma and delta past the valid total)
    and its map from both packages, which must be equal."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 3, N).astype(np.int32)
    cm_j = jmarch.make_compact_map(jnp.asarray(counts), K, M)
    cm_t = tmarch.make_compact_map(_t(counts), K, M)
    for a, b in zip(cm_t, cm_j):
        _eq(a, b)
    valid_m = np.asarray(cm_j.valid_m)
    sigma_c = (rng.uniform(size=M) * (40.0 if opaque else 3.0)
               * valid_m).astype(np.float32)
    color_c = rng.uniform(size=(M, 3)).astype(np.float32)
    t_c = rng.uniform(size=M).astype(np.float32) * 2.0 + 0.1
    dt_c = (rng.uniform(size=M) * 0.1 * valid_m).astype(np.float32)
    return (sigma_c, color_c, t_c, dt_c), cm_j, cm_t


COMPACT_CASES = [(37, 16, 256, 0.0, False), (37, 16, 96, 1e-4, False),
                 (256, 16, 2048, 1e-4, True)]


@pytest.mark.parametrize("N,K,M,T_thresh,opaque", COMPACT_CASES)
def test_composite_compact_matches_jax(N, K, M, T_thresh, opaque):
    """The compact compositor (pattern of test_marching.py:647) against
    the JAX package's, same compact buffer: values 1e-5, live counts
    exact. The port's per-ray sums run through scatter_add_wide_plain."""
    samples, cm_j, cm_t = _compact_inputs(N, K, M, opaque)
    ref = jmarch.composite_compact(*samples, cm_j, N, T_thresh,
                                   use_pallas=False)
    got = tmarch.composite_compact(*(_t(x) for x in samples), cm_t, N,
                                   T_thresh)
    for a, b in zip(got[:3], ref[:3]):
        _close(a, b)
    _eq(got[3], ref[3])


@pytest.mark.parametrize("N,K,M,T_thresh,opaque",
                         COMPACT_CASES + [(256, 16, 2048, 0.0, True)])
def test_composite_compact_plain_matches_jax_pallas_interpret(N, K, M,
                                                              T_thresh,
                                                              opaque):
    """The port's plain compact compositor against the JAX package's with
    K3 (matmul_scatter_add_wide) in interpret mode. K3 rounds its updates
    to bf16 for the matmul, so values are held at 2e-2 of the largest per-ray
    sum of each output; the live counts (0/1 updates, exact in bf16) exactly."""
    samples, cm_j, cm_t = _compact_inputs(N, K, M, opaque)
    ref = jmarch.composite_compact(*samples, cm_j, N, T_thresh,
                                   use_pallas=True)
    got = tmarch.composite_compact_plain(*(_t(x) for x in samples), cm_t, N,
                                         T_thresh)
    for a, b in zip(got[:3], ref[:3]):
        b = np.asarray(b)
        _close(a, b, atol=2e-2 * np.abs(b).max())
    _eq(got[3], ref[3])
    assert float(got[1].max()) > 0.1           # rays with content


def _emulate_kernel_c(sig, col, t, dt, offs, cnt, T_thresh):
    """numpy emulation of csrc/fused_composite.cu::composite_compact_kernel,
    vectorised over rays: one warp per ray over chunks of 32 samples of its
    segment [offs, offs + cnt) (lanes past the segment read zeros), the
    chunk helper it shares with B-fwd (inclusive shuffle scan of l =
    log(1 - alpha + 1e-15), T from the exclusive scan plus the carry, the
    stop after a chunk that ends at T <= T_thresh), per-lane sums (rgb
    float p = lane + 32 r of a chunk is sample p // 3's channel p % 3) and
    one butterfly sum. Returns ([N, 6] rows [w, w t, w rgb, live], [N,
    max cnt] live mask by segment position)."""
    f32, one = np.float32, np.float32(1)
    N = offs.shape[0]
    lanes = np.arange(32)
    kmax = int(cnt.max())
    flat = col.reshape(-1)
    acc = np.zeros((N, 6, 32), f32)
    mask = np.zeros((N, kmax), bool)
    carry = np.zeros(N, f32)
    going = np.ones(N, bool)
    for k0 in range(0, kmax, 32):
        inside = (k0 + lanes)[None, :] < cnt[:, None]
        m = np.where(inside, offs[:, None] + k0 + lanes[None, :], 0)
        sg, d, tt = (np.where(inside, x[m], 0).astype(f32)
                     for x in (sig, dt, t))
        alpha = (one - np.exp(-(sg * d).astype(f32))).astype(f32)
        l = np.log((one - alpha + f32(1e-15)).astype(f32)).astype(f32)
        incl = _warp_scan(l)
        excl = np.concatenate([np.zeros((N, 1), f32), incl[:, :-1]], 1)
        T = np.exp((carry[:, None] + excl).astype(f32)).astype(f32)
        on = (T > f32(T_thresh)) & going[:, None]
        wk = np.where(on, alpha * T, 0).astype(f32)
        acc[:, 0] += wk
        acc[:, 1] += wk * tt
        left = 3 * np.clip(cnt - k0, 0, 32)
        for r in range(3):
            p = lanes + 32 * r
            ok = p[None, :] < left[:, None]
            q = np.where(ok, 3 * (offs[:, None] + k0) + p[None, :], 0)
            contrib = (wk[:, p // 3] * np.where(ok, flat[q], 0)).astype(f32)
            for ch in range(3):
                acc[:, 2 + ch] += np.where(p % 3 == ch, contrib, 0).astype(f32)
        acc[:, 5] += on & inside
        mask[:, k0:k0 + 32] = (on & inside)[:, :kmax - k0]
        carry = np.where(going, (carry + incl[:, 31]).astype(f32), carry)
        going = going & (np.exp(carry) > f32(T_thresh))
    return _warp_sum(acc), mask


@pytest.mark.parametrize("N,K,M,T_thresh,opaque",
                         COMPACT_CASES + [(256, 16, 2048, 0.0, True),
                                          (64, 100, 4000, 1e-4, False)])
def test_kernel_c_order_matches_composite_compact_plain(N, K, M, T_thresh,
                                                        opaque):
    """Kernel C's order (a warp scan per ray with a chunk carry, l from
    1 - alpha, the stop) against the plain two-pass flat cumsum with l from
    exp(-tau): the two l differ by rounding only, so values 1e-6; live
    counts exact. The last case has segments of up to 100 samples, so
    rays span several chunks."""
    samples, _, cm_t = _compact_inputs(N, K, M, opaque)
    got, _ = _emulate_kernel_c(*samples, cm_t.offs.numpy(), cm_t.cnt.numpy(),
                               T_thresh)
    ref = tmarch.composite_compact_plain(*(_t(x) for x in samples), cm_t, N,
                                         T_thresh)
    for a, b in ((got[:, 2:5], ref[0]), (got[:, 0], ref[1]),
                 (got[:, 1], ref[2])):
        _close(a, b, atol=1e-6)
    _eq(got[:, 5], ref[3])


def test_kernel_c_mask_is_kernel_b_fwd_mask_on_the_expanded_layout():
    """On the crossing rays (4,096 rays whose T at sample k* is swept across
    T_thresh in single ulps of sigma; test_torch_cuda.py::_crossing_rays),
    laid out compactly with cnt in (k*, 128], kernel C's emulated mask
    equals kernel B's emulated mask (d_rgb with g_rgb = (1, 0, 0) is w_k)
    on compact_expand of the same buffer on every ray, and the sums are
    the same bits: chunk k of a segment is chunk k of the expanded ray,
    and the dropped slots add l = 0 and w = 0."""
    N, K, T = 4096, 128, 1e-4
    sig, rgb, dt, ts, kstar = (x.numpy() for x in
                               _crossing_rays(N, K, T, torch.device("cpu")))
    cnt = np.random.default_rng(15).integers(kstar + 1, K + 1)
    offs = np.cumsum(cnt) - cnt
    keep = np.arange(K)[None, :] < cnt[:, None]
    comp = [x[keep] for x in (sig, dt, ts, rgb)]
    rows, mask_c = _emulate_kernel_c(comp[0], comp[3], comp[2], comp[1],
                                     offs, cnt, T)
    cm = tmarch.make_compact_map(_t(cnt), K, int(cnt.sum()))
    _eq(cm.offs, offs)
    expanded = [tmarch.compact_expand(_t(x), cm).numpy() for x in comp]
    z = np.zeros(N, np.float32)
    g_rgb = np.zeros((N, 3), np.float32)
    g_rgb[:, 0] = 1.0
    (ws, dep, col), (_, d_rgb) = _kernel_b_emulation(
        expanded[0], expanded[3], expanded[1], expanded[2], z, z, g_rgb, T)
    mask_b = d_rgb[..., 0] > 0
    live_k = mask_b[np.arange(N), kstar]
    assert live_k.any() and not live_k.all()
    _eq(mask_b[:, :mask_c.shape[1]], mask_c)
    assert not mask_b[:, mask_c.shape[1]:].any()
    _eq(rows[:, 5], mask_b.sum(1))
    for a, b in ((rows[:, 0], ws), (rows[:, 1], dep), (rows[:, 2:5], col)):
        _eq(a, b)


def test_sample_test_batch_matches_jax():
    cfg = dict(text="x", H=12, W=20)
    for i, size in ((0, 5), (3, 5), (7, 100)):
        ref = jcam.sample_test_batch(jnp.array([i]), size, JConfig(**cfg))
        got = tcam.sample_test_batch(i, size, TConfig(**cfg), device=CPU)
        _close(got["rays_o"], ref["rays_o"])
        _close(got["rays_d"], ref["rays_d"])
        _eq(got["dir"], ref["dir"])
        assert (got["H"], got["W"]) == (12, 20)


def test_bf16_table_encode_matches_jax():
    """The bf16 table view (model.clone(table_bf16=True) in JAX): the
    same bf16 corner values and an f32 blend, so 1e-5 of the f32 output;
    and the view moves the output off the f32 encode."""
    jm, params, tm = _nerf_pair(1)
    x = np.random.default_rng(8).uniform(-1, 1, (500, 3)).astype(np.float32)
    jm16 = jm.clone(table_bf16=True)
    ref = jm16.apply(params, jnp.asarray(x), method=lambda m, x: m.encode(x))
    with torch.no_grad():
        got = tm.encode(_t(x), table_bf16=True)
        f32 = tm.encode(_t(x))
    _close(got, ref)
    assert float((got - f32).abs().max()) > 1e-6


# -- the staged eval end to end ------------------------------------------------

def _eval_setup(bound, tables, seed=0):
    """A JAX grid NeRF (f32) with its refreshed occupancy grid, and the
    port's copies; the 16 x 16 -O eval config of test_train_e2e.py:254."""
    kw = dict(text="x", grid_ray=True, fp16=False, grid_size=32,
              max_steps=64, grid_K=32, H=16, W=16, bound=bound,
              eval_table_bf16=(tables == "bf16"))
    jcfg = JConfig(**kw)
    jm, params, tm = _nerf_pair(seed)
    gs = jmarch.init_grid_state(jcfg.cascade, jcfg.grid_size)
    gs = jmarch.make_update_extra_state(jcfg, jm)(params, gs,
                                                  jax.random.PRNGKey(seed))
    tcfg = TConfig(**kw, max_ray_batch=32)
    return jcfg, jm, params, gs, tcfg, tm, from_jax_grid_state(gs, CPU)


def _jax_direct(jcfg, jm, params, gs, i, size):
    """The JAX package's direct full-K render_grid of orbit frame i."""
    b = jcam.sample_test_batch(jnp.array([i]), size, jcfg)
    o, d = b["rays_o"][0], b["rays_d"][0]

    @jax.jit
    def direct(params, gs, o, d):
        fns = j_field_fns(jm, params)._replace(normal=None)
        return jmarch.render_grid(jax.random.PRNGKey(0), fns, gs, o, d,
                                  bound=jcfg.bound, min_near=jcfg.min_near,
                                  max_steps=jcfg.max_steps, K=jcfg.grid_K,
                                  bg_radius=jcfg.bg_radius,
                                  light_d=jcam.safe_normalize(o[0]),
                                  perturb=False)

    return direct(params, gs, o, d), o, d


def _recorded_stages(fn):
    """fn() with the span recorder on -> (what it returned, the names of
    the eval/ spans it entered, the prefix cut)."""
    trace.reset()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    stages = {k.removeprefix("eval/") for k in trace.table()
              if k.startswith("eval/")}
    trace.reset()
    return out, stages


@pytest.mark.parametrize("bound,tables", [(1.0, "f32"), (1.0, "bf16"),
                                          (2.0, "f32")])
def test_staged_eval_matches_jax_direct_render(bound, tables):
    """Staged eval (group 32, so 8 groups of which some are background
    only) against JAX's direct render_grid of the same frame. bound 2 has
    two cascades: classify on the fine grid at stride 1, dense shade at the
    live bucket through the fused compositor."""
    jcfg, jm, params, gs, tcfg, tm, tgs = _eval_setup(bound, tables)
    ref, o, d = _jax_direct(jcfg, jm, params, gs, 0, 10)
    render = ttrainer.make_staged_grid_eval(tcfg, tm, 16, 16)
    out, stages = _recorded_stages(lambda: render(_t(o), _t(d), tgs))
    assert stages == {"classify", "bg", "march", "shade", "finish"}
    rtol, atol = (1e-4, 1e-5) if tables == "f32" else (5e-2, 2e-2)
    for k in ("image", "weights_sum", "depth"):
        np.testing.assert_allclose(_np(out[k]).reshape(ref[k].shape),
                                   np.asarray(ref[k]), rtol=rtol, atol=atol)
    ws = np.asarray(ref["weights_sum"]).reshape(8, 32)
    assert (ws.max(1) > 1e-3).any()                 # the frame has content


def test_staged_eval_routes_to_the_kernels(monkeypatch):
    """At one cascade the classify probes the pooled 8^3 grid through
    probe_select_small once a frame and every shaded group composites
    through composite_compact: the calls the GPU takes kernels D and C
    for."""
    jcfg, jm, params, gs, tcfg, tm, tgs = _eval_setup(1.0, "f32")
    calls = {"probe": [], "compact": 0}
    probe_fn, compact_fn = tprobe.probe_select_small, tmarch.composite_compact

    def probe_spy(tab, idx):
        calls["probe"].append(tab.shape[0])
        return probe_fn(tab, idx)

    def compact_spy(*args):
        calls["compact"] += 1
        return compact_fn(*args)

    monkeypatch.setattr(tprobe, "probe_select_small", probe_spy)
    monkeypatch.setattr(tmarch, "composite_compact", compact_spy)
    b = tcam.sample_test_batch(0, 10, tcfg, device=CPU)
    ttrainer.make_staged_grid_eval(tcfg, tm, 16, 16)(
        b["rays_o"][0], b["rays_d"][0], tgs)
    assert calls["probe"] == [8 ** 3]
    assert calls["compact"] > 0


def test_trainer_evaluate_matches_jax_eval_loss_and_writes_pngs(tmp_path):
    """Trainer.evaluate over 2 validation frames: the eval loss (lambda_entropy
    x the binary entropy of weights_sum) of the JAX direct renders to 1e-4
    relative, the PNGs decode (stdlib writer) to the frame, a best
    checkpoint; Trainer.test writes the orbit frames."""
    from PIL import Image

    jcfg, jm, params, gs, tcfg, tm, tgs = _eval_setup(1.0, "f32")
    cfg = tcfg.replace(guidance="none", val_size=2, test_size=2,
                       workspace=str(tmp_path), device="cpu")
    tr = ttrainer.Trainer("t", cfg, use_checkpoint="scratch")
    tr.model.load_state_dict(tm.state_dict())
    tr.grid_state = tgs
    loss = tr.evaluate(step=7)
    ref = 0.0
    for i in range(2):
        out, _, _ = _jax_direct(jcfg, jm, params, gs, i, 2)
        a = jnp.clip(out["weights_sum"], 1e-5, 1 - 1e-5)
        ref += jcfg.lambda_entropy * float(jnp.mean(
            -a * jnp.log2(a) - (1 - a) * jnp.log2(1 - a)))
    np.testing.assert_allclose(loss, ref / 2, rtol=1e-4)
    assert tr.stats["best_result"] == loss
    assert (tmp_path / "checkpoints" / "best.pt").exists()
    png = tmp_path / "validation" / "t_000007_0001_rgb.png"
    img = np.asarray(Image.open(png))
    frame = tr._render_orbit_frame(1, 2, 16, 16)
    want = (frame["image"].clamp(0, 1) * 255).to(torch.uint8).numpy()
    _eq(img, want)
    assert np.asarray(Image.open(str(png).replace("rgb", "depth"))).shape \
        == (16, 16)
    frames = tr.test(write_video=False)
    assert len(frames) == 2 and frames[0].shape == (16, 16, 3)
    assert sorted(p.name for p in (tmp_path / "results").iterdir()) == [
        "t_0000_rgb.png", "t_0001_rgb.png"]


def test_window_lattice_is_bitwise_the_full_march_lattice():
    """The windowed march computes lattice point k0 + j as near + dt (k0 +
    j), the full march's own formula, so its points are bitwise the full
    march's; the JAX package's (near + k0 dt) + j dt is not, which at 800^2
    let 4 of 640,000 staged pixels differ from the direct render by up to
    1.4e-2 (ROADMAP.md, queue 3)."""
    occ = _occ(3, (1, 32, 32, 32), 0.03)
    o, d, near, far = _rays(512, 11)
    t_lo = (near + np.random.default_rng(12).uniform(size=512) * 1.5
            ).astype(np.float32)
    kw = dict(bound=1.0, max_steps=128, S=128, K=128)
    m_t, _ = tmarch.march_rays_window(_t(occ), _t(o), _t(d), _t(near),
                                      _t(far), _t(t_lo), **kw)
    dt = 2.0 * np.sqrt(3.0) / 128
    k0 = np.floor((t_lo - near) / np.float32(dt))
    full = _t(near)[:, None] + dt * torch.arange(256, dtype=torch.float32)
    want = torch.gather(full, 1, _t(k0).long()[:, None] + torch.arange(128))
    lattice = _t(near)[:, None] + dt * (_t(k0)[:, None]
                                        + torch.arange(128).float())
    assert torch.equal(lattice, want)
    emitted = m_t.ts[m_t.valid]
    assert emitted.numel() > 0
    assert torch.isin(emitted, want).all()
    jax_lattice = (near + k0 * np.float32(dt))[:, None] + np.float32(dt) \
        * np.arange(128, dtype=np.float32)[None, :]
    assert (jax_lattice != want.numpy()).any()   # the rounding gap exists


@pytest.mark.parametrize("cascade", [1, 2])
def test_march_window_groups_off_the_card_keep_the_torch_march(monkeypatch,
                                                               cascade):
    """On CPU tensors, and with a grid of several cascades, the staged
    eval's group march stays PyTorch's and calls no kernel: five flagged
    groups of six (the densest first, spans below, on and past the S
    ladder) each equal march_rays_window at the S their span picks with
    the live cut written out here (several cascades: no cut, live total
    -1), and their stats come back as one host list."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops.composite import near_far_from_aabb

    def boom(*args, **kw):
        raise AssertionError("a CUDA kernel was called on the CPU path")

    monkeypatch.setattr(kcuda, "launch", boom)
    H, group, G, K, max_steps, bound = 32, 32, 6, 12, 128, float(cascade)
    rng = np.random.default_rng(7 + cascade)
    dgrid = (rng.uniform(size=(cascade, H, H, H)) * np.where(
        _occ(3, (cascade, H, H, H), 0.2), 200.0, 1.0)).astype(np.float32)
    mean = np.float32(dgrid.mean())
    gs = tmarch.GridState(_t(dgrid), _t(dgrid > min(mean, 10.0)),
                          torch.tensor(mean))
    aabb = torch.tensor([-bound] * 3 + [bound] * 3)
    o, d, _, _ = _rays(G * group, 5, origin_scale=4.0 * bound)
    o, d = _t(o), _t(d)
    near, _ = near_far_from_aabb(o, d, aabb, 0.05)
    t_lo = near + _t(rng.uniform(size=G * group).astype(np.float32)) * 0.5
    perm = torch.from_numpy(rng.permutation(G * group))
    spans = [40.0, 3.0, 100.0, 64.0, 1000.0]
    gspan = torch.tensor([0.0] + spans[::-1])
    ladder = (16, 32, 48, 64, 80, 96, 128)
    logt = ttrainer._LIVE_LOGT
    n0 = dict(kcuda.launch_counts)
    marched, stats = tmarch.march_window_groups(
        gs, o, d, perm, t_lo, gspan, len(spans), group=group, aabb=aabb,
        min_near=0.05, density_thresh=10.0, live_logt=logt, bound=bound,
        max_steps=max_steps, S_ladder=ladder, K=K)
    assert kcuda.launch_counts == n0
    assert len(marched) == len(stats) == len(spans)
    cut = 0
    for b, ((ridx, o_g, d_g, m, nears, fars), st) in enumerate(
            zip(marched, stats)):
        g = G - 1 - b
        assert torch.equal(ridx, perm[g * group:(g + 1) * group])
        assert torch.equal(o_g, o[ridx]) and torch.equal(d_g, d[ridx])
        S = next((s for s in ladder if s >= spans[b]), 128)
        want_n, want_f = near_far_from_aabb(o[ridx], d[ridx], aabb, 0.05)
        want, sig = tmarch.march_rays_window(
            gs.occ, o[ridx], d[ridx], want_n, want_f, t_lo[ridx],
            bound=bound, max_steps=max_steps, S=S, K=K,
            density_grid=gs.density_grid,
            occ_thresh=torch.clamp(gs.mean_density, max=10.0))
        gcount = float(torch.clamp(want.counts, max=K).max())
        if cascade == 1:
            depth = torch.cumsum(torch.clamp(sig, min=0.0) * want.dts
                                 * want.valid, 1)
            depth_ex = torch.cat([torch.zeros(group, 1), depth[:, :-1]], 1)
            live = want.valid & (depth_ex < logt)
            n_live = live.sum(1)
            want_st = [float(n_live.max()), gcount, float(n_live.sum())]
            cut += int((n_live < want.valid.sum(1)).sum())
        else:
            assert sig is None
            live = want.valid
            want_st = [gcount, gcount, -1.0]
        _eq(nears, want_n)
        _eq(fars, want_f)
        _eq(m.ts, want.ts)
        _eq(m.dts, want.dts)
        _eq(m.valid, live)
        _eq(m.counts, live.sum(1))
        assert st == want_st, (b, st, want_st)
    assert max(st[1] for st in stats) == K       # some ray fills its slots
    assert (cut > 0) == (cascade == 1)           # the live cut bites
