"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Inputs come from numpy seeds (or from the JAX key tree, for the camera
draws) and go through both implementations. The port runs its plain
PyTorch paths here: a CPU tensor never reaches a CUDA kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu import cameras as jcam
from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.ops import activation as jact
from dreamfusion_tpu.ops import composite as jcomp
from dreamfusion_tpu.ops import encoders as jenc
from dreamfusion_tpu.ops.grid_encoder import GridEncoderSpec as JSpec
from dreamfusion_tpu.ops.pallas_composite import composite_fused as j_fused

from dreamfusion_torch import cameras as tcam
from dreamfusion_torch.config import Config as TConfig
from dreamfusion_torch.ops import activation as tact
from dreamfusion_torch.ops import composite as tcomp
from dreamfusion_torch.ops import encoders as tenc
from dreamfusion_torch.ops import fused_composite as tfused
from dreamfusion_torch.ops.grid_encoder import GridEncoderSpec as TSpec
from dreamfusion_torch.ops.grid_encoder import (_level_consts,
                                                grid_encoder_bwd_plain)


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _pose_draws(key, B, cfg):
    """The JAX sample_train_batch key tree (cameras.py:92,194) -> draws."""
    k_pose, k_fov = jax.random.split(key)
    k_r, k_u, k_sph, k_tp, _, _, _ = jax.random.split(k_pose, 7)
    return {
        "radius": _t(jax.random.uniform(k_r, (B,), minval=cfg.radius_range[0],
                                        maxval=cfg.radius_range[1])),
        "u_sphere": _t(jax.random.uniform(k_sph, (B, 3))),
        "u_orbit": _t(jax.random.uniform(k_tp, (B, 2))),
        "u_select": _t(jax.random.uniform(k_u, (B,))),
        "fov": _t(jax.random.uniform(k_fov, (), minval=cfg.fovy_range[0],
                                     maxval=cfg.fovy_range[1])),
    }


def test_cameras_match_jax_with_injected_draws():
    """Poses, view buckets and rays with the JAX draws injected; tolerance
    1e-5 absolute (trig in float32 on two libraries)."""
    B, h, w = 8, 12, 10
    jcfg = JConfig(h=h, w=w, batch_size=B)
    tcfg = TConfig(h=h, w=w, batch_size=B)
    key = jax.random.PRNGKey(11)
    ref = jcam.sample_train_batch(key, jcfg)
    draws = _pose_draws(key, B, jcfg)
    got = tcam.sample_train_batch(tcfg, draws=draws,
                                  device=torch.device("cpu"))
    assert np.array_equal(_n(got["dir"]), np.asarray(ref["dir"]))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(_n(got[k]), np.asarray(ref[k]), atol=1e-5)
    # both branches of the sphere/orbit choice were exercised
    sel = _n(draws["u_select"]) < jcfg.uniform_sphere_rate
    assert sel.any() and (~sel).any()
    # the view-direction buckets on a grid of angles
    th = np.linspace(0, math.pi, 37, dtype=np.float32)
    ph = np.linspace(0, 2 * math.pi, 41, dtype=np.float32)
    T, P = np.meshgrid(th, ph)
    ov, fr = math.radians(30), math.radians(60)
    np.testing.assert_array_equal(
        _n(tcam.get_view_direction(_t(T), _t(P), ov, fr)),
        np.asarray(jcam.get_view_direction(jnp.asarray(T), jnp.asarray(P),
                                           ov, fr)))


def test_trunc_exp_and_freq_encode_match_jax():
    """trunc_exp value and clamped gradient, freq_encode values (1e-6)."""
    x = np.linspace(-20, 20, 101).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    yt = tact.trunc_exp(xt)
    yt.sum().backward()
    np.testing.assert_allclose(_n(yt), np.asarray(jact.trunc_exp(x)),
                               rtol=1e-6)
    gj = jax.grad(lambda v: jnp.sum(jact.trunc_exp(v)))(jnp.asarray(x))
    np.testing.assert_allclose(_n(xt.grad), np.asarray(gj), rtol=1e-6)
    d = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(_n(tenc.freq_encode(_t(d), 6)),
                               np.asarray(jenc.freq_encode(jnp.asarray(d), 6)),
                               atol=1e-6)


def _comp_inputs(seed, N, K, scale=20.0):
    rng = np.random.default_rng(seed)
    sig = (rng.uniform(size=(N, K)) * scale).astype(np.float32)
    rgb = rng.uniform(size=(N, K, 3)).astype(np.float32)
    dt = (rng.uniform(size=(N, K)) * 0.05 + 0.01).astype(np.float32)
    ts = (np.cumsum(dt, -1) + rng.uniform(size=(N, 1))).astype(np.float32)
    # a masked tail (sigma = dt = 0) like the renderer's invalid slots
    tail = np.arange(K)[None, :] >= rng.integers(K // 2, K + 1, (N, 1))
    sig[tail] = 0.0
    dt[tail] = 0.0
    g = [rng.normal(size=s).astype(np.float32) for s in ((N,), (N,), (N, 3))]
    return sig, rgb, dt, ts, g


def test_composite_and_near_far_match_jax():
    """Plain compositor values and autograd grads vs the JAX compositor
    (1e-5), with the T_thresh mask; near/far including misses (1e-5)."""
    sig, rgb, dt, ts, (gws, gd, gc) = _comp_inputs(0, 64, 48)
    st, rt = _t(sig).requires_grad_(True), _t(rgb).requires_grad_(True)
    out = tcomp.composite(st, rt, _t(dt), _t(ts), T_thresh=1e-4)
    ref = jcomp.composite(sig, rgb, dt, ts, T_thresh=1e-4)
    for a, b in ((out.weights_sum, ref.weights_sum), (out.depth, ref.depth),
                 (out.rgb, ref.rgb), (out.weights, ref.weights)):
        np.testing.assert_allclose(_n(a), np.asarray(b), atol=1e-5)
    (out.weights_sum * _t(gws)).sum().add((out.depth * _t(gd)).sum()).add(
        (out.rgb * _t(gc)).sum()).backward()

    def lj(s, r):
        o = jcomp.composite(s, r, dt, ts, T_thresh=1e-4)
        return (jnp.sum(o.weights_sum * gws) + jnp.sum(o.depth * gd)
                + jnp.sum(o.rgb * gc))

    gs, gr = jax.grad(lj, argnums=(0, 1))(jnp.asarray(sig), jnp.asarray(rgb))
    np.testing.assert_allclose(_n(st.grad), np.asarray(gs), atol=1e-5)
    np.testing.assert_allclose(_n(rt.grad), np.asarray(gr), atol=1e-5)

    rng = np.random.default_rng(1)
    o = rng.normal(size=(200, 3)).astype(np.float32) * 2
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d[:5, 1:] = 0.0                                    # axis-parallel rays
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    nt, ft = tcomp.near_far_from_aabb(_t(o), _t(d), _t(aabb), 0.1)
    nj, fj = jcomp.near_far_from_aabb(o, d, aabb, 0.1)
    assert (np.asarray(nj) >= np.asarray(fj)).any()     # some rays miss
    np.testing.assert_allclose(_n(nt), np.asarray(nj), rtol=1e-5)
    np.testing.assert_allclose(_n(ft), np.asarray(fj), rtol=1e-5)


def _warp_scan(x):
    """Inclusive Hillis-Steele scan over the last axis (32 lanes) in
    float32, in the order of the kernel's __shfl_up_sync steps."""
    x = x.astype(np.float32)
    for off in (1, 2, 4, 8, 16):
        y = np.zeros_like(x)
        y[..., off:] = x[..., :-off]
        x = (x + y).astype(np.float32)
    return x


def _warp_sum(x):
    """Butterfly sum over the last axis (32 lanes) by __shfl_xor_sync, in
    float32; every lane ends with the total, lane 0's is returned."""
    x = x.astype(np.float32)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = (x + x[..., lanes ^ off]).astype(np.float32)
    return x[..., 0]


def _warp_suffix_scan(x):
    """Inclusive suffix sum over the last axis (32 lanes) in float32, in
    the order of the kernel's __shfl_down_sync steps."""
    x = x.astype(np.float32)
    for off in (1, 2, 4, 8, 16):
        y = np.zeros_like(x)
        y[..., :-off] = x[..., off:]
        x = (x + y).astype(np.float32)
    return x


def _kernel_b_emulation(sig, rgb, dt, ts, g_ws, g_d, g_rgb, T_thresh):
    """The algorithm of csrc/fused_composite.cu, vectorised over rays: one
    warp per ray over chunks of 32 samples (lanes past K read zeros). The
    chunk helper both kernels share: the inclusive shuffle scan of l =
    log(1 - alpha + 1e-15), T from the exclusive scan plus the carry, the
    mask exp(log T) > T_thresh, the stop after a chunk that ends at T <=
    T_thresh. The forward: per-lane sums (rgb float p = lane + 32 r of a
    chunk is sample p // 3's channel p % 3), one butterfly sum at the end.
    The backward: the same chunks' T and mask, then the chunks in reverse
    with u = w G (G = g_ws + g_d t + g_rgb . c) summed by a shuffle-down
    suffix scan plus the later chunks' total, d_sigma = delta (T (1 -
    alpha) G - S). Holds the kernels' arithmetic to the JAX formulas here,
    where no GPU can run them."""
    N, K = sig.shape
    f32 = np.float32
    one = f32(1)
    lanes = np.arange(32)
    acc = np.zeros((N, 5, 32), f32)       # w, w t, rgb by channel; per lane
    carry = np.zeros(N, f32)
    going = np.ones(N, bool)
    chunks = []                           # per chunk: lane values for pass 2
    flat = rgb.reshape(N, 3 * K)
    for k0 in range(0, K, 32):
        k = k0 + lanes
        inside = k < K
        kk = np.minimum(k, K - 1)
        sg = np.where(inside, sig[:, kk], 0).astype(f32)
        d = np.where(inside, dt[:, kk], 0).astype(f32)
        t = np.where(inside, ts[:, kk], 0).astype(f32)
        c = np.where(inside[:, None], rgb[:, kk], 0).astype(f32)   # [N,32,3]
        alpha = (one - np.exp(-(sg * d).astype(f32))).astype(f32)
        l = np.log((one - alpha + f32(1e-15)).astype(f32)).astype(f32)
        incl = _warp_scan(l)
        excl = np.concatenate([np.zeros((N, 1), f32), incl[:, :-1]], 1)
        T = np.exp((carry[:, None] + excl).astype(f32)).astype(f32)
        on = (T > f32(T_thresh)) & going[:, None]
        wk = np.where(on, alpha * T, 0).astype(f32)
        chunks.append((k0, inside, d, t, c, alpha, T, on, wk))
        acc[:, 0] += wk
        acc[:, 1] += wk * t
        for r in range(3):
            p = lanes + 32 * r
            ok = p < 3 * (K - k0)
            vals = np.where(ok, flat[:, np.minimum(3 * k0 + p, 3 * K - 1)], 0)
            contrib = (wk[:, p // 3] * vals).astype(f32)
            for ch in range(3):
                acc[:, 2 + ch] += np.where((p % 3) == ch, contrib, 0).astype(f32)
        carry = np.where(going, (carry + incl[:, 31]).astype(f32), carry)
        going = going & (np.exp(carry) > f32(T_thresh))
    sums = _warp_sum(acc)
    ws, dep, col = sums[:, 0], sums[:, 1], sums[:, 2:]

    d_sig = np.zeros_like(sig)
    d_rgb = np.zeros_like(rgb)
    s_later = np.zeros(N, f32)
    for k0, inside, d, t, c, alpha, T, on, wk in reversed(chunks):
        t_next = np.where(on, T * (one - alpha), 0).astype(f32)
        G = (g_ws[:, None] + g_d[:, None] * t
             + (g_rgb[:, None, :] * c).sum(-1)).astype(f32)
        suffix = _warp_suffix_scan(wk * G)
        after = np.concatenate([suffix[:, 1:], np.zeros((N, 1), f32)], 1)
        ds = d * (t_next * G - (after + s_later[:, None]))
        n_in = int(inside.sum())
        d_sig[:, k0:k0 + n_in] = ds[:, :n_in]
        d_rgb[:, k0:k0 + n_in] = (g_rgb[:, None, :] * wk[..., None])[:, :n_in]
        s_later = (s_later + suffix[:, 0]).astype(f32)
    return (ws, dep, col), (d_sig, d_rgb)


@pytest.mark.parametrize("K", [16, 32, 48, 96, 128, 256])
def test_fused_composite_matches_jax(K):
    """composite_fused (plain path) vs the JAX Pallas kernel in interpret
    mode and vs autodiff of the JAX compositor: values 1e-5, grads 1e-4
    relative to the largest entry (log-space prefix vs running product).
    Opaque rays cross T_thresh = 1e-4 inside the K samples."""
    N, T_thresh = 300, 1e-4
    sig, rgb, dt, ts, (gws, gd, gc) = _comp_inputs(K, N, K, scale=60.0)
    st, rt = _t(sig).requires_grad_(True), _t(rgb).requires_grad_(True)
    out = tfused.composite_fused(st, rt, _t(dt), _t(ts), T_thresh)
    ws, depth, col = j_fused(jnp.asarray(sig), jnp.asarray(rgb),
                             jnp.asarray(dt), jnp.asarray(ts), True, T_thresh)
    for a, b in ((out.weights_sum, ws), (out.depth, depth), (out.rgb, col)):
        np.testing.assert_allclose(_n(a), np.asarray(b), atol=1e-5)
    ref = jcomp.composite(sig, rgb, dt, ts, T_thresh=T_thresh)
    np.testing.assert_allclose(_n(out.rgb), np.asarray(ref.rgb), atol=1e-5)
    # rays that cross the threshold before their last valid sample
    trans = np.exp(np.cumsum(-sig * dt, -1))
    assert ((trans < T_thresh).any(-1)).sum() > N // 4

    loss = ((out.weights_sum * _t(gws)).sum() + (out.depth * _t(gd)).sum()
            + (out.rgb * _t(gc)).sum())
    loss.backward()

    def lj(s, r, fused):
        if fused:
            a, b, c = j_fused(s, r, jnp.asarray(dt), jnp.asarray(ts), True,
                              T_thresh)
        else:
            o = jcomp.composite(s, r, dt, ts, T_thresh=T_thresh)
            a, b, c = o.weights_sum, o.depth, o.rgb
        return jnp.sum(a * gws) + jnp.sum(b * gd) + jnp.sum(c * gc)

    for fused in (True, False):
        gs, gr = jax.grad(lj, argnums=(0, 1))(jnp.asarray(sig),
                                              jnp.asarray(rgb), fused)
        for a, b in ((st.grad, gs), (rt.grad, gr)):
            b = np.asarray(b)
            np.testing.assert_allclose(_n(a), b, atol=1e-4 * np.abs(b).max())

    # the kernel's own algorithm, emulated, against the same references
    (e_ws, e_d, e_rgb), (e_ds, e_dr) = _kernel_b_emulation(
        sig, rgb, dt, ts, gws, gd, gc, T_thresh)
    for a, b in ((e_ws, ws), (e_d, depth), (e_rgb, col)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(e_ds, _n(st.grad),
                               atol=1e-4 * np.abs(_n(st.grad)).max())
    np.testing.assert_allclose(e_dr, _n(rt.grad),
                               atol=1e-4 * np.abs(_n(rt.grad)).max())


def test_crossing_rays_separate_the_two_log_sum_orders():
    """The card's crossing test (test_torch_cuda.py::
    test_fused_composite_masks_agree_across_the_crossing) can see a
    backward whose log T runs in another order than the forward's: on its
    4,096 rays, emulated in float32 numpy, the chunked warp scan plus
    carry (the helper both kernels share) and a sequential sum (the
    earlier thread-per-ray B-bwd's order) put T at k* on different sides of
    T_thresh on some rays, and in
    each group of k* the sweep leaves T at k* above T_thresh on some rays
    and not on others."""
    from test_torch_cuda import _crossing_rays

    f32, T_thresh = np.float32, 1e-4
    sig, _, dt, _, kstar = _crossing_rays(4096, 128, T_thresh,
                                          torch.device("cpu"))
    sig, dt, kstar = sig.numpy(), dt.numpy(), kstar.numpy()
    alpha = (f32(1) - np.exp(-(sig * dt).astype(f32))).astype(f32)
    l = np.log((f32(1) - alpha + f32(1e-15)).astype(f32)).astype(f32)
    N, K = l.shape
    scan, seq = np.zeros((N, K), f32), np.zeros((N, K), f32)
    carry, run = np.zeros(N, f32), np.zeros(N, f32)
    for k0 in range(0, K, 32):
        incl = _warp_scan(l[:, k0:k0 + 32])
        excl = np.concatenate([np.zeros((N, 1), f32), incl[:, :-1]], 1)
        scan[:, k0:k0 + 32] = (carry[:, None] + excl).astype(f32)
        carry = (carry + incl[:, 31]).astype(f32)
    for k in range(K):
        seq[:, k] = run
        run = (run + l[:, k]).astype(f32)
    rows = np.arange(N)
    live_scan = np.exp(scan[rows, kstar]) > f32(T_thresh)
    live_seq = np.exp(seq[rows, kstar]) > f32(T_thresh)
    for k in (7, 40, 77, 120):
        assert live_scan[kstar == k].any() and not live_scan[kstar == k].all()
    assert (live_scan != live_seq).sum() >= 5


def _grid_specs():
    kw = dict(input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
              log2_hashmap_size=16, desired_resolution=2048)
    return (JSpec(scatter_impl="xla", gridtype="tiled", **kw),
            TSpec(gridtype="tiled", **kw))


def test_grid_encoder_forward_and_table_grad_match_jax():
    """All 16 tiled levels at B = 4096: outputs to 1e-6 absolute, the table
    gradient (index_add_ plain path) to 1e-5 relative to its largest entry
    (scatter sums in another order). Includes out-of-bounds samples."""
    jspec, tspec = _grid_specs()
    assert jspec.geometry == tspec.geometry
    rng = np.random.default_rng(5)
    B = 4096
    emb = (rng.uniform(-1, 1, (tspec.table_size, 2)) * 0.1).astype(np.float32)
    x = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    x[:16, 0] = rng.uniform(1.001, 1.1, 16)           # out of bounds
    cot = rng.normal(size=(B, 32)).astype(np.float32)

    et = _t(emb).requires_grad_(True)
    out_t = tspec(et, _t(x))
    (out_t * _t(cot)).sum().backward()
    out_j, vjp = jax.vjp(lambda e: jspec(e, jnp.asarray(x)), jnp.asarray(emb))
    np.testing.assert_allclose(_n(out_t), np.asarray(out_j), atol=1e-6)
    oob = (np.abs(x) > 1).any(-1)
    assert oob.any() and not np.abs(_n(out_t)[oob]).any()
    (g_j,) = vjp(jnp.asarray(cot))
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(_n(et.grad), g_j, atol=1e-5 * np.abs(g_j).max())

    # kernel A's contract on the same residuals: the plain scatter equals
    # the autograd table gradient exactly
    base, w, _ = tspec.residuals(_t(x))
    cot_t = torch.where(torch.from_numpy(oob)[:, None], 0.0, _t(cot))
    d = grid_encoder_bwd_plain(base, w, cot_t.reshape(B, 16, 2),
                               _level_consts(tspec, torch.device("cpu")))
    np.testing.assert_array_equal(_n(d), _n(et.grad))


def test_corner_index_matches_jax_uint32():
    """Row index arithmetic of the tiled grid (linear strides, wrapping at
    2^32) in int64 masked to 32 bits equals the JAX uint32 arithmetic
    exactly, with table sizes small and large against the strides."""
    rng = np.random.default_rng(7)
    coords = rng.integers(0, 1 << 31, (512, 3)).astype(np.int64)
    for log2_size in (14, 19):
        kw = dict(num_levels=16, log2_hashmap_size=log2_size,
                  desired_resolution=2048)
        js, ts_ = JSpec(gridtype="tiled", **kw), TSpec(gridtype="tiled", **kw)
        for lvl in (0, 5, 15):
            a = ts_._corner_index_fn(lvl)(torch.from_numpy(coords))
            b = js._corner_index_fn(lvl)(jnp.asarray(coords.astype(np.uint32)))
            np.testing.assert_array_equal(_n(a), np.asarray(b))
            assert ts_._corner_offsets(lvl) == js._corner_offsets(lvl)
