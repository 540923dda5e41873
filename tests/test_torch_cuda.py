"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels are built from
dreamfusion_torch/csrc at first use) and skip elsewhere. Run them on the
GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_grid_encoder_bwd_kernel_matches_index_add(dev):
    """Kernel A vs index_add_ at all 16 tiled levels; atomics sum in
    another order, so 1e-5 of the largest entry."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_encoder as ge

    spec = ge.GridEncoderSpec(num_levels=16, level_dim=2, base_resolution=16,
                              log2_hashmap_size=16, desired_resolution=2048,
                              gridtype="tiled")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(50_000, 3, device=dev, generator=g) * 2 - 1
    base, w, _ = spec.residuals(x)
    cot = torch.randn(x.shape[0], 16, 2, device=dev, generator=g)
    cot[:100] = 0.0                                  # skipped samples
    consts = ge._level_consts(spec, dev)
    n0 = kcuda.launch_counts["grid_encoder_bwd"]
    d_k = ge.grid_encoder_bwd(base, w, cot, consts)
    assert kcuda.launch_counts["grid_encoder_bwd"] == n0 + 1
    d_p = ge.grid_encoder_bwd_plain(base, w, cot, consts)
    torch.cuda.synchronize()
    assert (d_k - d_p).abs().max() <= 1e-5 * d_p.abs().max()


def _ray_positions(R, K, seed, dev):
    """R straight rays on the renderer's lattice (step 2 sqrt(3) / 512),
    K samples each, ray after ray: at the coarse levels some 20 consecutive
    samples share a cell, so their updates land on the same rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.rand(R, 1, 3, device=dev, generator=g) * 1.2 - 0.6
    d = torch.nn.functional.normalize(
        torch.randn(R, 1, 3, device=dev, generator=g), dim=-1)
    t = torch.arange(K, device=dev)[None, :, None] * (2 * math.sqrt(3) / 512)
    return (o + d * t).clamp(-1.0, 1.0).reshape(-1, 3)


_TILED = dict(level_dim=2, gridtype="tiled")


_MAIN = dict(num_levels=16, base_resolution=16, log2_hashmap_size=16,
             desired_resolution=2048)


@pytest.mark.parametrize("spec_kw,zero_cot", [
    (_MAIN, False),
    (dict(num_levels=4, base_resolution=8, per_level_scale=1.5,
          log2_hashmap_size=12), False),
    (dict(num_levels=3, base_resolution=64, log2_hashmap_size=19), False),
    (dict(num_levels=1, base_resolution=15, log2_hashmap_size=16), False),
    (_MAIN, True)],
    ids=["rays, main spec", "small levels only (at most 4,096 rows)",
         "large levels only (at least 274,632 rows)",
         "K1b level of 4,096 rows", "all-zero cotangent"])
def test_grid_encoder_bwd_kernel_on_rays(dev, spec_kw, zero_cot):
    """Kernel A vs index_add_ on ray-ordered samples (2,000 rays of 128
    samples, a dead tail on every ray), on the main spec, on specs of small
    levels only (many lanes of a warp on one cell) and of large levels only
    (few), and on one level of 4,096 rows. Atomics sum in another order:
    2e-5 of the largest entry (an all-zero cotangent gives an all-zero
    gradient exactly)."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_encoder as ge

    spec = ge.GridEncoderSpec(**spec_kw, **_TILED)
    consts = ge._level_consts(spec, dev)
    R, K = 2000, 128
    x = _ray_positions(R, K, 7, dev)
    base, w, _ = spec.residuals(x)
    g = torch.Generator(device=dev).manual_seed(8)
    cot = torch.randn(R * K, spec.num_levels, 2, device=dev, generator=g)
    n_live = torch.randint(1, K + 1, (R, 1), device=dev, generator=g)
    live = (torch.arange(K, device=dev)[None] < n_live).reshape(-1)
    cot = cot * live[:, None, None] * (0.0 if zero_cot else 1.0)
    n0 = kcuda.launch_counts["grid_encoder_bwd"]
    d_k = ge.grid_encoder_bwd(base, w, cot, consts)
    assert kcuda.launch_counts["grid_encoder_bwd"] == n0 + 1
    d_p = ge.grid_encoder_bwd_plain(base, w, cot, consts)
    torch.cuda.synchronize()
    if zero_cot:
        assert not d_k.any()
    else:
        assert (d_k - d_p).abs().max() <= 2e-5 * d_p.abs().max()


@pytest.mark.parametrize("spec_kw,B", [
    (dict(), 100_000),
    (dict(num_levels=4, base_resolution=8, per_level_scale=1.5,
          log2_hashmap_size=9), 20_000)])
def test_grid_encoder_bwd_rows_kernel_matches_index_add(dev, spec_kw, B):
    """Kernel E vs index_add_ per level and corner, through the encoder's
    backward: the default 16-level hash spec and a 4-level one with tiny
    tables; points outside the box among them. Atomics sum in another
    order, so 2e-5 of the largest entry."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_encoder as ge

    spec = ge.GridEncoderSpec(gridtype="hash", **spec_kw)
    assert any(spec.hashed_levels)
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.rand(B, 3, device=dev, generator=g) * 2 - 1) * 1.05
    emb = spec.init(g, dev).requires_grad_(True)
    cot = torch.randn(B, spec.output_dim, device=dev, generator=g)
    n0 = dict(kcuda.launch_counts)
    out = spec(emb, x)
    (out * cot).sum().backward()
    assert kcuda.launch_counts["grid_encoder_bwd_rows"] \
        == n0["grid_encoder_bwd_rows"] + 1
    assert kcuda.launch_counts["grid_encoder_bwd"] == n0["grid_encoder_bwd"]
    rows, w, oob = spec.residuals_rows(x)
    cot_in = (cot * (~oob)[:, None]).reshape(B, spec.num_levels, 2)
    d_p = ge.grid_encoder_bwd_rows_plain(rows, w, cot_in, spec.table_size)
    torch.cuda.synchronize()
    assert oob.any() and not out[oob].abs().any()
    assert (emb.grad - d_p).abs().max() <= 2e-5 * d_p.abs().max()


def _unit_points_on_faces(spec, B, seed, dev):
    """x01 [B, 3] f32: a quarter uniform in the unit box, half on cell faces
    of a random level (per dimension with probability 1/2: x01 = (m -
    shift) / scale for an integer m of that level), a quarter outside the
    box on either side."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, 3))
    scales, resolutions = spec.geometry[0], spec.geometry[1]
    lvl = rng.integers(0, spec.num_levels, B)
    sc = np.array(scales)[lvl][:, None]
    m = np.floor(rng.uniform(size=(B, 3)) * np.array(resolutions)[lvl][:, None])
    face = (rng.uniform(size=(B, 3)) < 0.5) & (np.arange(B) % 4 < 2)[:, None]
    x = np.where(face, ((m - 0.5) / sc).astype(np.float32), x)
    out = np.arange(B) % 4 == 3
    x[out] = np.where(rng.uniform(size=(out.sum(), 3)) < 0.5,
                      rng.uniform(-0.3, 0.0, (out.sum(), 3)),
                      rng.uniform(1.0001, 1.3, (out.sum(), 3)))
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize("spec_kw,B", [
    (dict(), 100_000),
    (dict(num_levels=4, base_resolution=8, per_level_scale=1.5,
          log2_hashmap_size=9), 20_000)],
    ids=["default hash spec", "4 levels of 512 rows"])
def test_grid_encoder_bwd_rows_kernel_on_cell_faces(dev, spec_kw, B):
    """Kernel E, which forms corners, weights and rows from x01 itself, vs
    its plain version (corner_rows + index_add_) on points on cell faces
    and outside the box, every cotangent non-zero: 2e-5 of the largest
    entry (atomics sum in another order; at a face either corner choice
    moves the gradient by rounding only). Through the encoder (the box's
    outside reads zeros, its cotangent is zero) one E launch a backward
    and none of A, against the same plain version."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_encoder as ge

    spec = ge.GridEncoderSpec(gridtype="hash", **spec_kw)
    x01 = _unit_points_on_faces(spec, B, 11, dev)
    g = torch.Generator(device=dev).manual_seed(12)
    cot = torch.randn(B, spec.num_levels, 2, device=dev, generator=g)
    d_k = ge.grid_encoder_bwd_rows_cuda(spec, x01, cot)
    d_p = ge.grid_encoder_bwd_rows_plain(*spec.corner_rows(x01), cot,
                                         spec.table_size)
    torch.cuda.synchronize()
    assert (d_k - d_p).abs().max() <= 2e-5 * d_p.abs().max()

    emb = spec.init(g, dev).requires_grad_(True)
    n0 = dict(kcuda.launch_counts)
    out = spec(emb, x01 * 2 - 1)
    (out * cot.reshape(B, -1)).sum().backward()
    assert kcuda.launch_counts["grid_encoder_bwd_rows"] \
        == n0["grid_encoder_bwd_rows"] + 1
    assert kcuda.launch_counts["grid_encoder_bwd"] == n0["grid_encoder_bwd"]
    rows, w, oob = spec.residuals_rows(x01 * 2 - 1)
    d_p = ge.grid_encoder_bwd_rows_plain(rows, w, cot * (~oob)[:, None, None],
                                         spec.table_size)
    torch.cuda.synchronize()
    assert oob.sum() >= B // 4
    assert (emb.grad - d_p).abs().max() <= 2e-5 * d_p.abs().max()


@pytest.mark.parametrize("K", [32, 128])
def test_fused_composite_kernels_match_plain(dev, K):
    """Kernels B-fwd / B-bwd vs the plain formulas, rays crossing
    T_thresh; fwd 1e-5, bwd 1e-4 of the largest entry."""
    from dreamfusion_torch.ops import fused_composite as fc

    g = torch.Generator(device=dev).manual_seed(K)
    N, T = 1000, 1e-4
    sig = torch.rand(N, K, device=dev, generator=g) * 600.0
    sig[::2] *= 0.02
    rgb = torch.rand(N, K, 3, device=dev, generator=g)
    dt = torch.full((N, K), 2 * math.sqrt(3) / 512, device=dev)
    ts = torch.cumsum(dt, -1) + 0.3
    gws, gd = (torch.randn(N, device=dev, generator=g) for _ in range(2))
    gc = torch.randn(N, 3, device=dev, generator=g)
    for a, b in zip(fc.composite_fwd_cuda(sig, rgb, dt, ts, T),
                    fc.composite_fwd_plain(sig, rgb, dt, ts, T)):
        assert (a - b).abs().max() <= 1e-5
    for a, b in zip(fc.composite_bwd_cuda(sig, rgb, dt, ts, gws, gd, gc, T),
                    fc.composite_bwd_plain(sig, rgb, dt, ts, gws, gd, gc, T)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    # autograd through the Function reaches both kernels
    s = sig.clone().requires_grad_(True)
    out = fc.composite_fused(s, rgb, dt, ts, T)
    out.rgb.sum().backward()
    assert torch.isfinite(s.grad).all()


def _composite_rays(N, K, seed, dev):
    """Rays on the 512-step lattice in four kinds, by n % 4: opaque at once
    (T_thresh crossed in the first chunk of 32 samples), crossing in a
    later chunk, all-zero sigma, and thin (never crossing); a dead tail of
    sigma = delta = 0 on every ray."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt0 = 2 * math.sqrt(3) / 512
    scale = torch.tensor([3000.0, 60.0, 0.0, 5.0], device=dev)
    sig = torch.rand(N, K, device=dev, generator=g) \
        * scale[torch.arange(N, device=dev) % 4][:, None]
    n_live = torch.randint(1, K + 1, (N, 1), device=dev, generator=g)
    live = (torch.arange(K, device=dev)[None] < n_live).float()
    sig, dt = sig * live, torch.full((N, K), dt0, device=dev) * live
    ts = torch.cumsum(dt, -1) + 0.3
    rgb = torch.rand(N, K, 3, device=dev, generator=g)
    grads = (torch.randn(N, device=dev, generator=g),
             torch.randn(N, device=dev, generator=g),
             torch.randn(N, 3, device=dev, generator=g))
    return sig, rgb, dt, ts.contiguous(), grads


@pytest.mark.parametrize("N", [1, 4096, 4097])
@pytest.mark.parametrize("K", [1, 16, 32, 33, 48, 64, 96, 128, 192, 256])
def test_fused_composite_kernels_every_K(dev, K, N):
    """B-fwd (a warp per ray, chunks of 32 samples, ragged last chunk) and
    B-bwd vs the plain formulas at every K of the trainer's ladder, K = 1
    and 33, and N around a multiple of the forward's 8 rays a block; rays
    that cross T_thresh = 1e-4 in the first chunk and in a later one, and
    rays of zero sigma. fwd 1e-5, bwd 1e-4 of the largest entry."""
    from dreamfusion_torch.ops import fused_composite as fc

    T = 1e-4
    sig, rgb, dt, ts, (gws, gd, gc) = _composite_rays(N, K, K * 7 + N, dev)
    for a, b in zip(fc.composite_fwd_cuda(sig, rgb, dt, ts, T),
                    fc.composite_fwd_plain(sig, rgb, dt, ts, T)):
        assert (a - b).abs().max() <= 1e-5
    for a, b in zip(fc.composite_bwd_cuda(sig, rgb, dt, ts, gws, gd, gc, T),
                    fc.composite_bwd_plain(sig, rgb, dt, ts, gws, gd, gc, T)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp_min(1e-30)
    if N == 4096 and K >= 64:
        trans = torch.exp(torch.cumsum(-sig * dt, -1))
        first = (trans[:, :32] <= T).any(-1)
        later = (trans <= T).any(-1) & ~first
        assert first.any() and later.any() and (sig == 0).all(-1).any()


def test_fused_composite_backward_mask_is_the_forwards(dev):
    """A ray whose second sample sits where the running product and the
    log-space form of T disagree about T_thresh: f0 = 1 - alpha_0 + 1e-15
    with exp(log f0) > f0 on the card, T_thresh = f0. The log-space form
    (the plain version, the JAX VJP and both kernels) keeps samples 1.. live;
    the running product would drop them. Samples 1.. have sigma = 0, so the
    log sum stays exactly log f0 and only the mask decides their
    d_sigma."""
    from dreamfusion_torch.ops import fused_composite as fc

    dt0 = 2 * math.sqrt(3) / 512
    s = torch.linspace(1300.0, 1400.0, 200_001, device=dev)
    alpha = 1.0 - torch.exp(-s * dt0)
    f0 = 1.0 - alpha + 1e-15
    pick = torch.nonzero(torch.exp(torch.log(f0)) > f0)[0, 0]
    T = float(f0[pick])
    K = 40
    sig = torch.zeros(1, K, device=dev)
    sig[0, 0] = s[pick]
    dt = torch.full((1, K), dt0, device=dev)
    ts = torch.cumsum(dt, -1)
    g = torch.Generator(device=dev).manual_seed(5)
    rgb = torch.rand(1, K, 3, device=dev, generator=g)
    gws, gd, gc = torch.ones(1, device=dev), torch.ones(1, device=dev), \
        torch.ones(1, 3, device=dev)
    ds_k, dr_k = fc.composite_bwd_cuda(sig, rgb, dt, ts, gws, gd, gc, T)
    ds_p, dr_p = fc.composite_bwd_plain(sig, rgb, dt, ts, gws, gd, gc, T)
    torch.cuda.synchronize()
    assert (ds_p[0, 1:] != 0).all()                  # live by the log form
    assert torch.equal(ds_k != 0, ds_p != 0)
    assert (ds_k - ds_p).abs().max() <= 1e-4 * ds_p.abs().max()
    for a, b in zip(fc.composite_fwd_cuda(sig, rgb, dt, ts, T),
                    fc.composite_fwd_plain(sig, rgb, dt, ts, T)):
        assert (a - b).abs().max() <= 1e-5


def _crossing_rays(N, K, T_thresh, dev):
    """Rays on the 512-step lattice whose T at one sample k* (7, 40, 77 or
    120 by n % 4: lanes of chunks 0-3) is swept across T_thresh: sample 0
    has alpha ~0.9, k* - 2 samples share the rest of the log sum but ~4,
    sample k* - 1 takes that ~4 at the sigma whose log terms sum to
    log(T_thresh) in f64, moved by n // 4 - N / 8 ulps (single ulps of
    sigma, ~0.4 ulp of log T each), and alpha at k* is ~0.05. Every sigma
    is > 0, after k* too (sigma delta uniform in [0.1, 0.5])."""
    f32 = np.float32
    rng = np.random.default_rng(13)
    dt0 = f32(2 * math.sqrt(3) / 512)
    kstar = np.array([7, 40, 77, 120])[np.arange(N) % 4]
    sd = rng.uniform(0.1, 0.5, (N, K))
    sd[:, 0] = 2.3
    rows = np.arange(N)
    sd[rows, kstar] = 0.0513

    def log_terms(s):
        a = (f32(1) - np.exp(-(s * dt0).astype(f32))).astype(f32)
        return np.log((f32(1) - a + f32(1e-15)).astype(f32)).astype(np.float64)

    sig = (sd / dt0).astype(f32)
    for k in np.unique(kstar):
        sel = kstar == k
        sig[np.ix_(sel, np.arange(1, k - 1))] = f32(
            (-math.log(T_thresh) - 2.3 - 4.0) / (k - 2) / dt0)
        need = math.log(T_thresh) - log_terms(sig[sel, :k - 1]).sum(1)
        sig[sel, k - 1] = (-need / dt0).astype(f32)
    step = (rows // 4 - N // 8).astype(np.int32)
    sig[rows, kstar - 1] = (sig[rows, kstar - 1].view(np.int32) + step).view(f32)
    sig = torch.from_numpy(sig).to(dev)
    dt = torch.full((N, K), float(dt0), device=dev)
    ts = torch.cumsum(dt, -1) + 0.3
    g = torch.Generator(device=dev).manual_seed(14)
    rgb = torch.rand(N, K, 3, device=dev, generator=g)
    return sig, rgb, dt, ts.contiguous(), torch.from_numpy(kstar).to(dev)


def test_fused_composite_masks_agree_across_the_crossing(dev):
    """B-bwd's mask is B-fwd's, bit for bit, on 4,096 rays swept in
    single-ulp steps of sigma across T_thresh at sample k*, sigma > 0 on
    both sides and beyond. With g_rgb = (1, 0, 0) and g_ws = g_d = 0,
    B-bwd's d_rgb[..., 0] is its w_k, so its sum over k equals B-fwd's
    weights_sum to 1e-6 on every ray (the two sums' rounding is ~3e-7);
    a sample live in one kernel and masked in the other moves it by alpha
    T = 5e-6. Both kernels against the plain versions at their tolerances
    (fwd 1e-5, bwd 1e-4 of the largest entry). The plain version sums log
    T by torch.cumsum, in another order, so on a ray whose T at k* lies
    within rounding of T_thresh its mask may differ from the kernels' at
    k*: d_sigma, whose largest entry is ~1e3 times a sample's T, is held
    on the rays where the masks agree, and a ray where they differ must
    differ at k* alone."""
    from dreamfusion_torch.ops import fused_composite as fc

    N, K, T = 4096, 128, 1e-4
    sig, rgb, dt, ts, kstar = _crossing_rays(N, K, T, dev)
    gws, gd = torch.zeros(N, device=dev), torch.zeros(N, device=dev)
    gc = torch.zeros(N, 3, device=dev)
    gc[:, 0] = 1.0
    ws, depth, col = fc.composite_fwd_cuda(sig, rgb, dt, ts, T)
    d_sig, d_rgb = fc.composite_bwd_cuda(sig, rgb, dt, ts, gws, gd, gc, T)
    plain_f = fc.composite_fwd_plain(sig, rgb, dt, ts, T)
    ps, pr = fc.composite_bwd_plain(sig, rgb, dt, ts, gws, gd, gc, T)
    torch.cuda.synchronize()
    assert (sig > 0).all()
    rows = torch.arange(N, device=dev)
    trans = fc._excl_log_trans(sig, dt)[1]
    live_k = trans[rows, kstar] > T
    for k in (7, 40, 77, 120):                  # the sweep crosses T_thresh
        assert live_k[kstar == k].any() and not live_k[kstar == k].all()
    assert (d_rgb[..., 0].sum(-1) - ws).abs().max() <= 1e-6

    for a, b in zip((ws, depth, col), plain_f):
        assert (a - b).abs().max() <= 1e-5
    assert (d_rgb - pr).abs().max() <= 1e-4 * pr.abs().max()
    mask_k = d_rgb[..., 0] != 0                 # w_k > 0 iff live (alpha > 0)
    differ = mask_k != (trans > T)
    agree = ~differ.any(-1)
    assert (d_sig - ps)[agree].abs().max() <= 1e-4 * ps.abs().max()
    assert torch.equal(differ.nonzero()[:, 1], kstar[differ.any(-1)])


def test_fused_composite_autograd_reaches_both_kernels(dev):
    """composite_fused's forward launches B-fwd and its backward B-bwd."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import fused_composite as fc

    sig, rgb, dt, ts, _ = _composite_rays(4096, 128, 3, dev)
    s = sig.clone().requires_grad_(True)
    r = rgb.clone().requires_grad_(True)
    n0 = dict(kcuda.launch_counts)
    out = fc.composite_fused(s, r, dt, ts, 1e-4)
    (out.rgb.sum() + out.weights_sum.sum() + out.depth.sum()).backward()
    assert kcuda.launch_counts["composite_fwd"] == n0["composite_fwd"] + 1
    assert kcuda.launch_counts["composite_bwd"] == n0["composite_bwd"] + 1
    d_sig, d_rgb = fc.composite_bwd_plain(
        sig, rgb, dt, ts, torch.ones(4096, device=dev),
        torch.ones(4096, device=dev), torch.ones(4096, 3, device=dev), 1e-4)
    torch.cuda.synchronize()
    assert (s.grad - d_sig).abs().max() <= 1e-4 * d_sig.abs().max()
    assert (r.grad - d_rgb).abs().max() <= 1e-4 * d_rgb.abs().max()


@pytest.mark.parametrize("B,N,H,D", [(2, 4096, 8, 40), (1, 4096, 1, 512),
                                     (1, 200, 2, 40), (1, 200, 1, 512),
                                     (1, 4096, 2, 64), (2, 1024, 3, 24)])
def test_flash_attention_kernels_match_plain(dev, B, N, H, D):
    """attention_fwd / attention_bwd vs attention_plain (f32 scores and
    softmax) on bf16 inputs: bf16 outputs, and P and dS enter the products
    in bf16, so 1e-2 (values) and 2e-2 (gradients) of the largest entry.
    The main path's UNet and VAE shapes, ragged tiles of both forms, the
    narrow form's widest head (64) and a head below one 16-deep step."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(D)
    q, k, v, do = (torch.randn(B, N, H, D, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n0 = dict(kcuda.launch_counts)
    out = fa.flash_attention(*leaves, 1.0 / math.sqrt(D))
    grads = torch.autograd.grad(out, leaves, do)
    assert kcuda.launch_counts["attention_fwd"] == n0["attention_fwd"] + 1
    assert kcuda.launch_counts["attention_bwd"] == n0["attention_bwd"] + 1
    ref_leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
    ref = fa.attention_plain(*ref_leaves, 1.0 / math.sqrt(D))
    refs = torch.autograd.grad(ref, ref_leaves, do.float())
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max() <= 1e-2 * ref.abs().max()
    for a, b in zip(grads, refs):
        assert (a.float() - b).abs().max() <= 2e-2 * b.abs().max()


@pytest.mark.parametrize("B,N,H,D", [(1, 300, 5, 80), (2, 130, 3, 24)])
def test_flash_attention_scratch_chunks_match_one_pass(dev, monkeypatch, B,
                                                       N, H, D):
    """The wrappers' walk over (b, h) pairs in chunks of scratch gives the
    same bits as one pass: each pair's products do not depend on the
    chunk."""
    from dreamfusion_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(B * N)
    q, k, v, do = (torch.randn(B, N, H, D, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    small = 2 * N * fa.scratch_cols(N) * 6    # two pairs a chunk, either pass
    o, lse = fa.attention_fwd_cuda(q, k, v, scale)
    grads = fa.attention_bwd_cuda(q, k, v, o, lse, do, scale)
    monkeypatch.setattr(fa, "SCRATCH_BYTES", small)
    o2, lse2 = fa.attention_fwd_cuda(q, k, v, scale)
    grads2 = fa.attention_bwd_cuda(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert len(fa.scratch_chunks(B, H, N, 4, small)[1]) > 1
    for a, b in zip((o, lse, *grads), (o2, lse2, *grads2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T,J", [(32768, 20_001), (65536, 4096 * 32),
                                 (128, 3)])
def test_probe_select_kernel_matches_take(dev, T, J):
    """Kernel D vs the element gather, exact: the pooled 32^3 grid, the
    largest table (dynamic shared memory above 48 KB), a tail of J % 4."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import probe

    g = torch.Generator(device=dev).manual_seed(T)
    tab = torch.randint(0, 256, (T,), generator=g, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    idx = torch.randint(0, T, (J,), generator=g, device=dev,
                        dtype=torch.int32)
    n0 = kcuda.launch_counts["probe_select_small"]
    got = probe.probe_select_small(tab, idx)
    assert kcuda.launch_counts["probe_select_small"] == n0 + 1
    # an index view that is not 16-byte aligned
    got_view = probe.probe_select_small_cuda(tab, idx[1:])
    torch.cuda.synchronize()
    assert torch.equal(got, probe.probe_select_small_plain(tab, idx))
    assert torch.equal(got_view, got[1:])


_COMPACT_COUNTS = (128, 0, 1, 31, 32, 33)


def _compact_buffer(N, M, dev, seed):
    """A ray-major compact buffer (marching.make_compact_map, K = 128) of N
    rays whose marched counts cycle through _COMPACT_COUNTS, at budget M
    (scaled by floor when M is below the total), with samples on the
    512-step lattice: sigma delta uniform in [0, 2.7), so segments of 31
    samples and more cross T_thresh = 1e-4; sigma zero past the valid
    total."""
    from dreamfusion_torch.ops import marching

    counts = torch.tensor(_COMPACT_COUNTS, device=dev).repeat(N // 6 + 1)[:N]
    cm = marching.make_compact_map(counts, 128, M)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt0 = 2 * math.sqrt(3) / 512
    sig = torch.rand(M, device=dev, generator=g) * 400.0 * cm.valid_m
    col = torch.rand(M, 3, device=dev, generator=g)
    t = 0.5 + torch.rand(M, device=dev, generator=g) * 3.0
    dt = torch.full((M,), dt0, device=dev)
    return (sig, col, t, dt), cm


@pytest.mark.parametrize("N", [1, 4096, 4097])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("T_thresh", [0.0, 1e-4])
def test_composite_compact_kernel_matches_plain(dev, N, scaled, T_thresh):
    """Kernel C (the compact compositor, one launch) against the plain
    two-pass compositor: segments of 0, 1, 31, 32, 33 and 128 samples, the
    full budget and one scaled to 60% of the marched total, T_thresh 0
    and 1e-4. l is log(1 - alpha + 1e-15) in the kernel and log(exp(-tau)
    + 1e-15) in the plain version, summed in another order: values 1e-5
    of the largest per-ray sum, plus one sample's alpha T (<= T_thresh) on
    a ray whose live count differs; live counts differ by at most 1, on at
    most 0.1% of the rays. The plain version runs on the CPU copy of the
    inputs: its flat f32 cumsum over the ~150,000 samples is sequential
    there and within 1e-6 of a float64 evaluation, while the card's
    parallel scan drifted by up to 8.3e-5 on these inputs (the kernel:
    5.4e-7)."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import marching

    total = sum(_COMPACT_COUNTS[i % 6] for i in range(N))
    M = int(total * 0.6) if scaled else total + 77
    samples, cm = _compact_buffer(N, M, dev, seed=N)
    n0 = kcuda.launch_counts["composite_compact"]
    got = marching.composite_compact(*samples, cm, N, T_thresh)
    assert kcuda.launch_counts["composite_compact"] == n0 + 1
    ref = marching.composite_compact_plain(
        *(x.cpu() for x in samples),
        marching.CompactMap(*(x.cpu() for x in cm)), N, T_thresh)
    got = [x.cpu() for x in got]
    samples = [x.cpu() for x in samples]
    assert N == 1 or bool((cm.cnt == 0).any())
    differ = got[3] != ref[3]
    assert (got[3] - ref[3]).abs().max() <= 1
    assert int(differ.sum()) <= 0.001 * N
    for a, b in zip(got[:3], ref[:3]):
        a, b = a.reshape(N, -1), b.reshape(N, -1)
        tol = 1e-5 * b.abs().max() + differ[:, None] * 1.01 * T_thresh * (
            1.0 + samples[1].max() + samples[2].max())
        assert ((a - b).abs() <= tol).all()
    assert float(ref[1].max()) > 0.5


def test_composite_compact_kernel_mask_is_b_fwd_mask(dev):
    """Kernel C against kernel B-fwd on compact_expand of the same buffer:
    the crossing rays (T at sample k* swept across T_thresh in single ulps
    of sigma) laid out compactly with cnt in (k*, 128]. Chunk k of a
    segment is chunk k of the expanded ray and the dropped slots add l = 0
    and w = 0, so the live counts equal the number of samples B-bwd (whose
    mask is B-fwd's bit for bit) gives a weight > 0 (every sigma > 0), and
    weights_sum, depth and rgb are the same bits."""
    from dreamfusion_torch.ops import fused_composite as fc
    from dreamfusion_torch.ops import marching

    N, K, T = 4096, 128, 1e-4
    sig, rgb, dt, ts, kstar = _crossing_rays(N, K, T, dev)
    g = torch.Generator(device=dev).manual_seed(16)
    cnt = kstar + 1 + (torch.rand(N, device=dev, generator=g)
                       * (K - kstar)).long()
    cm = marching.make_compact_map(cnt, K, int(cnt.sum()))
    keep = torch.arange(K, device=dev)[None, :] < cnt[:, None]
    comp = [x[keep].contiguous() for x in (sig, rgb, ts, dt)]
    rgb_c, ws_c, dep_c, live = fc.composite_compact_cuda(
        comp[0], comp[1], comp[2], comp[3], cm, N, T)
    exp = [marching.compact_expand(x, cm).contiguous() for x in comp]
    ws, dep, col = fc.composite_fwd_cuda(exp[0], exp[1], exp[3], exp[2], T)
    z = torch.zeros(N, device=dev)
    gc = torch.zeros(N, 3, device=dev)
    gc[:, 0] = 1.0
    _, d_rgb = fc.composite_bwd_cuda(exp[0], exp[1], exp[3], exp[2], z, z,
                                     gc, T)
    torch.cuda.synchronize()
    w_pos = (d_rgb[..., 0] > 0).sum(1)
    live_k = d_rgb[torch.arange(N, device=dev), kstar, 0] > 0
    assert live_k.any() and not live_k.all()
    assert torch.equal(live, w_pos.float())
    for a, b in ((ws_c, ws), (dep_c, dep), (rgb_c, col)):
        assert torch.equal(a, b)


def test_grid_encoder_bwd_kernel_on_stratified_samples(dev):
    """Kernel A vs index_add_ at the -O2 step's layout: 4,096 rays x 128
    samples between each ray's near and far, clipped to the box, so every
    one of the 524,288 samples is inside and live; 1e-5 of the largest
    entry."""
    from dreamfusion_torch.ops import grid_encoder as ge

    spec = ge.GridEncoderSpec(**_MAIN, **_TILED)
    g = torch.Generator(device=dev).manual_seed(3)
    o = torch.nn.functional.normalize(
        torch.randn(4096, 1, 3, device=dev, generator=g), dim=-1) * 1.4
    d = torch.nn.functional.normalize(
        torch.rand(4096, 1, 3, device=dev, generator=g) * 0.6 - 0.3 - o, dim=-1)
    z = 0.4 + 2.0 * torch.sort(torch.rand(4096, 128, 1, device=dev,
                                          generator=g), 1).values
    x = (o + d * z).clamp(-1.0, 1.0).reshape(-1, 3)
    base, w, _ = spec.residuals(x)
    cot = torch.randn(x.shape[0], 16, 2, device=dev, generator=g)
    consts = ge._level_consts(spec, dev)
    d_k = ge.grid_encoder_bwd_cuda(base, w, cot, consts)
    d_p = ge.grid_encoder_bwd_plain(base, w, cot, consts)
    torch.cuda.synchronize()
    assert (d_k - d_p).abs().max() <= 1e-5 * d_p.abs().max()


def test_o2_step_on_the_gpu_matches_the_cpu(dev, monkeypatch):
    """One small lambertian -O2 step (grid field, 16 x 16 rays, 16 + 16
    samples, f32, a fixed positive projection of the image as the
    guidance) on the GPU against the same step on the CPU with the same
    weights and draws, the CPU taking the GPU step's importance samples
    (sample_pdf follows the last bits of the coarse weights). The loss and
    each gradient leaf (L2-relative) are held to 1e-4 or 3x the most that
    CPU control steps move them: the camera radius changed by 2^-24, and
    the density MLP's outputs moved by 2^-23 (the finite-difference
    normals of a young field turn with an ulp of sigma). Kernel A
    launches 7 times."""
    import copy

    from dreamfusion_torch import renderer
    from dreamfusion_torch.config import Config
    from dreamfusion_torch.guidance import Guidance
    from dreamfusion_torch.models.networks import build_model
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.training import trainer as tr

    cfg = Config(text="x", h=16, w=16, dir_text=True, fp16=False,
                 num_steps=16, upsample_steps=16, albedo_iters=0)
    cpu = torch.device("cpu")
    m_cpu = build_model(cfg, cpu, torch.Generator().manual_seed(0))
    m_gpu = copy.deepcopy(m_cpu).to(dev)
    rng = np.random.default_rng(0)
    N = cfg.h * cfg.w
    G = torch.from_numpy(rng.uniform(size=(1, 16, 16, 3)).astype(np.float32))
    draws = {"radius": [1.2], "u_sphere": [[0.3, 0.6, 0.2]],
             "u_orbit": [[0.5, 0.25]], "u_select": [0.7], "fov": 50.0,
             "bg": rng.uniform(size=(N, 3)), "light_n": rng.normal(size=3),
             "perturb_u": rng.uniform(size=(N, 16)),
             "pdf_u": rng.uniform(size=(N, 16))}
    pdf, sampled = renderer.sample_pdf, {}

    def step(model, device, scale=1.0, noise=None):
        def pdf_fixed(*args, **kw):
            if "z" not in sampled:
                sampled["z"] = pdf(*args, **kw).cpu()
            return sampled["z"].to(device)

        monkeypatch.setattr(renderer, "sample_pdf", pdf_fixed)
        g = torch.Generator().manual_seed(noise or 0)
        hook = model.sigma_net.register_forward_hook(
            lambda mod, inp, out: out + 2.0 ** -23 * (torch.randint(
                0, 2, out.shape, generator=g) * 2 - 1).to(out.device)
            if noise is not None else None)
        guid = Guidance("projection", {}, None,
                        lambda tz, rgb, draws=None, gen=None:
                        (rgb * G.to(rgb.device)).mean())
        d = {k: torch.as_tensor(np.asarray(v)).float().to(device)
             for k, v in draws.items()}
        d["radius"] = d["radius"] * scale
        d["shade_u"] = 0.3
        try:
            loss, _ = tr.make_grads_fn(cfg, model, guid)(
                1, torch.zeros(6, 1, device=device), None, draws=d)
        finally:
            hook.remove()
        return float(loss), {k: p.grad.cpu() for k, p in
                             model.named_parameters()}

    def l2(a, b):
        return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
                for k in b}

    n0 = kcuda.launch_counts["grid_encoder_bwd"]
    lg, gg = step(m_gpu, dev)
    assert kcuda.launch_counts["grid_encoder_bwd"] == n0 + 7
    lc, gc = step(m_cpu, cpu)
    ctrl, ctrl_loss = {k: 0.0 for k in gc}, 0.0
    for kw in (dict(scale=1 + 2.0 ** -24), dict(scale=1 - 2.0 ** -24),
               dict(noise=1), dict(noise=2)):
        lp, gp = step(m_cpu, cpu, **kw)
        ctrl = {k: max(ctrl[k], v) for k, v in l2(gp, gc).items()}
        ctrl_loss = max(ctrl_loss, abs(lp - lc))
    assert abs(lg - lc) <= max(1e-4 * abs(lc), 3 * ctrl_loss)
    gap = l2(gg, gc)
    for k in gc:
        assert gap[k] <= max(1e-4, 3 * ctrl[k]), (k, gap[k], ctrl[k])


@pytest.mark.parametrize("bound,dt_gamma,perturb", [(1.0, 1 / 128, True),
                                                    (2.0, 0.05, False)])
def test_march_cone_kernel_is_bitwise_its_plain_version(dev, bound, dt_gamma,
                                                        perturb):
    """Kernel F against march_rays_cone_plain on the card: 2,048 seeded rays
    through a seeded grid (C = 1, and C = 2 at bound 2), K = 16 so that at
    dt_gamma 1/128 some rays overflow: counts, ts, dts and valid the same
    bits; one launch per call of march_rays."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import marching
    from dreamfusion_torch.ops.composite import near_far_from_aabb

    g = torch.Generator(device=dev).manual_seed(3)
    C = 1 if bound == 1.0 else 2
    occ = torch.rand(C, 64, 64, 64, device=dev, generator=g) < 0.1
    o = torch.nn.functional.normalize(
        torch.randn(2048, 3, device=dev, generator=g), dim=-1) * 2.5 * bound
    d = torch.nn.functional.normalize(
        (torch.rand(2048, 3, device=dev, generator=g) - 0.5) * bound - o,
        dim=-1)
    aabb = torch.tensor([-bound] * 3 + [bound] * 3, device=dev)
    near, far = near_far_from_aabb(o, d, aabb, 0.1)
    u = torch.rand(2048, device=dev, generator=g) if perturb else None
    kw = dict(bound=bound, max_steps=512, K=16, dt_gamma=dt_gamma,
              perturb=perturb, perturb_u=u)
    n0 = kcuda.launch_counts["march_cone"]
    got = marching.march_rays(occ, o, d, near, far, **kw)
    assert kcuda.launch_counts["march_cone"] == n0 + 1
    t0 = near
    if perturb:
        gm, lo, hi, _ = marching.cone_constants(dt_gamma, 512, C, 64)
        t0 = near + torch.clamp(near * gm, lo, hi) * u
    ref = marching.march_rays_cone_plain(occ, o, d, t0, far, bound=bound,
                                         max_steps=512, K=16,
                                         dt_gamma=dt_gamma)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if dt_gamma < 0.01:
        assert bool((ref.counts > 16).any())


def test_march_cone_kernel_refuses_bad_inputs(dev):
    """The wrapper checks device, dtype, shape and contiguity."""
    from dreamfusion_torch.ops import marching

    occ = torch.zeros(1, 8, 8, 8, dtype=torch.bool, device=dev)
    o = torch.zeros(4, 3, device=dev)
    t = torch.zeros(4, device=dev)
    kw = dict(bound=1.0, max_steps=8, K=4, dt_gamma=0.01)
    with pytest.raises(TypeError):
        marching.march_rays_cone_cuda(occ.float(), o, o, t, t, **kw)
    with pytest.raises(ValueError):
        marching.march_rays_cone_cuda(occ, o.cpu(), o, t, t, **kw)
    with pytest.raises(ValueError):
        marching.march_rays_cone_cuda(occ, o.t().contiguous().t(), o, t,
                                      t[:3], **kw)


def _plain_grid_grad(grid, x01, cot):
    """(out, d grid) of sum(grid_sample_3d_plain(grid, x01) * cot)."""
    from dreamfusion_torch.ops import grid_sample as gs

    g = grid.detach().clone().requires_grad_(True)
    out = gs.grid_sample_3d_plain(g, x01)
    (out * cot).sum().backward()
    return out.detach(), g.grad


@pytest.mark.parametrize("C", [1, 12])
def test_grid_sample_kernels_match_plain_on_dvgo_rays(dev, C):
    """Kernel G through grid_sample_3d against the plain gather, at a
    159^3 grid and 1,024 rays of the ball scene's camera ring
    (chip_smoke.dvgo_ring_samples) x 954 samples, the
    cotangent zeroed past the box by DVGO's torch.where: one launch each
    way; the forward within 1e-6 of its largest value, the grid gradient
    within 1e-5 of its largest entry (atomics add in another order)."""
    from chip_smoke import dvgo_ring_samples
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_sample as gs

    x01, oob = dvgo_ring_samples(1024, 7, dev)
    assert float(oob.float().mean()) > 0.5
    g = torch.Generator(device=dev).manual_seed(C)
    grid = torch.randn(C, 159, 159, 159, device=dev, generator=g)
    cot = torch.where(oob[:, None], 0.0,
                      torch.randn(x01.shape[0], C, device=dev, generator=g))
    n0 = dict(kcuda.launch_counts)
    gk = grid.clone().requires_grad_(True)
    out = gs.grid_sample_3d(gk, x01.reshape(1024, 954, 3))
    assert out.shape == (1024, 954, C)
    (out.reshape(-1, C) * cot).sum().backward()
    assert kcuda.launch_counts["grid_sample_fwd"] == n0["grid_sample_fwd"] + 1
    assert kcuda.launch_counts["grid_sample_bwd"] == n0["grid_sample_bwd"] + 1
    out_p, d_p = _plain_grid_grad(grid, x01, cot)
    torch.cuda.synchronize()
    out = out.detach().reshape(-1, C)
    assert (out - out_p).abs().max() <= 1e-6 * out_p.abs().max()
    assert (gk.grad - d_p).abs().max() <= 1e-5 * d_p.abs().max()


@pytest.mark.parametrize("C", [1, 12])
def test_grid_sample_kernels_on_the_faces_and_past_them(dev, C):
    """Positions exactly at 0 and 1, on grid nodes, and past the box on
    either side (every combination over the three axes, each repeated 5
    times in a row so that lanes of a warp share a voxel), and 4,096
    random ones in [-0.2, 1.2], on a [C, 5, 6, 7] grid (odd planes: the
    float2 atomics' alignment varies by channel); a NaN cotangent reaches
    the same entries as through the plain gather; an all-zero cotangent
    gives a zero gradient."""
    from dreamfusion_torch.ops import grid_sample as gs

    g = torch.Generator(device=dev).manual_seed(11)
    grid = torch.randn(C, 5, 6, 7, device=dev, generator=g)
    v = torch.tensor([-0.5, 0.0, 1 / 3, 0.5, 1.0, 1.5], device=dev)
    edge = torch.cartesian_prod(v, v, v).repeat_interleave(5, 0)
    x01 = torch.cat([edge, torch.rand(4096, 3, device=dev, generator=g)
                     * 1.4 - 0.2]).contiguous()
    cot = torch.randn(x01.shape[0], C, device=dev, generator=g)
    out = gs.grid_sample_fwd_cuda(grid, x01)
    d = gs.grid_sample_bwd_cuda(x01, cot, grid.shape)
    out_p, d_p = _plain_grid_grad(grid, x01, cot)
    torch.cuda.synchronize()
    assert (out - out_p).abs().max() <= 1e-6 * out_p.abs().max()
    assert (d - d_p).abs().max() <= 1e-5 * d_p.abs().max()
    zero = gs.grid_sample_bwd_cuda(x01, torch.zeros_like(cot), grid.shape)
    assert torch.equal(zero, torch.zeros_like(grid))
    cot[1000, C - 1] = float("nan")
    d = gs.grid_sample_bwd_cuda(x01, cot, grid.shape)
    _, d_p = _plain_grid_grad(grid, x01, cot)
    assert int(d_p.isnan().sum()) > 0
    assert torch.equal(d.isnan(), d_p.isnan())


def test_grid_sample_deterministic_mode_backward_repeats_bitwise(dev):
    """Under torch's deterministic mode the forward is still kernel G's and
    the backward the ordered index_put_ accumulation: two backward passes
    give the same bits, within 1e-5 of the atomic backward's result."""
    from chip_smoke import dvgo_ring_samples
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_sample as gs

    x01, oob = dvgo_ring_samples(256, 3, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    grid = torch.randn(12, 159, 159, 159, device=dev, generator=g)
    cot = torch.where(oob[:, None], 0.0,
                      torch.randn(x01.shape[0], 12, device=dev, generator=g))
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    n0 = dict(kcuda.launch_counts)
    grads = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for _ in range(2):
            gk = grid.clone().requires_grad_(True)
            (gs.grid_sample_3d(gk, x01) * cot).sum().backward()
            grads.append(gk.grad)
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    assert kcuda.launch_counts["grid_sample_fwd"] == n0["grid_sample_fwd"] + 2
    assert kcuda.launch_counts["grid_sample_bwd"] == n0["grid_sample_bwd"]
    d = gs.grid_sample_bwd_cuda(x01, cot, grid.shape)
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])
    assert (grads[0] - d).abs().max() <= 1e-5 * d.abs().max()


def test_grid_sample_position_gradient_keeps_the_plain_gather(dev):
    """A position that requires grad (the editing field's and OSR's
    autograd normals) launches no kernel and gets the plain version's
    value and gradients bit for bit."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_sample as gs

    g = torch.Generator(device=dev).manual_seed(5)
    grid = torch.randn(2, 9, 8, 7, device=dev, generator=g)
    x = torch.rand(3000, 3, device=dev, generator=g) * 1.2 - 0.1
    cot = torch.randn(3000, 2, device=dev, generator=g)
    res = []
    n0 = dict(kcuda.launch_counts)
    for fn in (gs.grid_sample_3d, gs.grid_sample_3d_plain):
        gk = grid.clone().requires_grad_(True)
        xk = x.clone().requires_grad_(True)
        out = fn(gk, xk)
        (out * cot).sum().backward()
        res.append((out.detach(), gk.grad, xk.grad))
    assert kcuda.launch_counts == n0
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_dvgo_render_launches_kernel_g_twice_each_way(dev, monkeypatch):
    """One DVGO fine render and backward on the ball scene's rays (512 rays,
    a 96^3 grid, k0 12): the density at every sample and k0 at the live
    ones, 2 forward and 2 backward launches; loss and gradients against
    the same step through the plain gather (1e-5 of each leaf's largest
    entry)."""
    from dreamfusion_torch.models.dvgo import DVGOField
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_sample as gs

    from chip_smoke import ball_ring_rays

    rays_d, rays_o, viewdirs, target = (torch.from_numpy(a).to(dev) for a in
                                        ball_ring_rays(512, 9))
    field = DVGOField(world_size=(96, 96, 96), k0_dim=12,
                      rgbnet_name="resmlp", rgbnet_width=128,
                      alpha_init=1e-2).to(dev)
    field.reset_parameters(torch.Generator(device=dev).manual_seed(2))
    jitter = torch.rand(512, 1, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))

    def step():
        field.zero_grad()
        r = field.render(rays_o, rays_d, viewdirs, near=2.0, far=6.0,
                         bg=1.0, n_samples=field.n_render_samples(6.0),
                         jitter=jitter)
        loss = ((r["rgb_marched"] - target) ** 2).mean()
        loss.backward()
        return float(loss.detach()), {k: p.grad.clone()
                             for k, p in field.named_parameters()}

    n0 = dict(kcuda.launch_counts)
    loss, grads = step()
    assert kcuda.launch_counts["grid_sample_fwd"] == n0["grid_sample_fwd"] + 2
    assert kcuda.launch_counts["grid_sample_bwd"] == n0["grid_sample_bwd"] + 2
    monkeypatch.setattr(gs, "kernel_grid", lambda grid: False)
    loss_p, grads_p = step()
    assert abs(loss - loss_p) <= 1e-6 * abs(loss_p)
    for k, gp in grads_p.items():
        assert (grads[k] - gp).abs().max() <= 1e-5 * gp.abs().max(), k


def _encode_points(spec, B, seed):
    """x [B, 3] f32 for bound 1: a quarter uniform in the box, a quarter
    within one ulp of a lattice point of the finest level (x01 = (m -
    shift) / scale for an integer m, then x = 2 x01 - 1 moved by -1, 0 or
    +1 ulp), an eighth on the box's corners (every coordinate +-1), an
    eighth with one coordinate +-1, a quarter with one coordinate outside
    the box."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, 3))
    q = B // 4
    scale, res = spec.geometry[0][-1], spec.geometry[1][-1]
    m = rng.integers(1, res, (q, 3))
    near = ((m - 0.5) / scale * 2 - 1).astype(np.float32)
    step = rng.integers(-1, 2, (q, 3))
    near = np.where(step > 0, np.nextafter(near, np.float32(2)),
                    np.where(step < 0, np.nextafter(near, np.float32(-2)),
                             near))
    x[q:2 * q] = near
    e = q // 2
    x[2 * q:2 * q + e] = np.where(rng.uniform(size=(e, 3)) < 0.5, -1.0, 1.0)
    rows = np.arange(2 * q + e, 3 * q)
    x[rows, rng.integers(0, 3, rows.size)] = np.where(
        rng.uniform(size=rows.size) < 0.5, -1.0, 1.0)
    rows = np.arange(3 * q, B)
    x[rows, rng.integers(0, 3, rows.size)] = (
        np.where(rng.uniform(size=rows.size) < 0.5, -1.0, 1.0)
        * rng.uniform(1.0001, 1.3, rows.size))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("spec_kw,dtype", [
    (dict(_MAIN, **_TILED), torch.float32),
    (dict(_MAIN, **_TILED), torch.bfloat16),
    (dict(gridtype="hash", log2_hashmap_size=19), torch.float32)],
    ids=["-O tiled spec, f32 table", "-O tiled spec, bf16 table",
         "hash spec 2^19, f32 table"])
def test_grid_encoder_fwd_kernel_matches_plain(dev, spec_kw, dtype):
    """Kernel H vs its plain version (the CPU gather and blend level by
    level) on uniform points, points within one ulp of a lattice point of
    the finest level (an FMA or another floor would move their weights),
    points on +-bound and points outside the box; B = 100,003, so neither
    B nor B L is a multiple of the block. The corner rows and weights are
    the plain version's bit for bit and each product is rounded alike, so
    only the order of the 8-term sum differs: a few ulps of the largest
    term, held to 1e-6 of the table's largest magnitude. Out-of-box rows
    are exactly 0."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_encoder as ge

    spec = ge.GridEncoderSpec(**spec_kw)
    rng = np.random.default_rng(21)
    emb = torch.from_numpy(rng.uniform(-0.1, 0.1, (spec.table_size, 2))
                           .astype(np.float32)).to(dtype)
    B = 100_003
    x = _encode_points(spec, B, 22)
    ref = spec.encode(emb, x)
    n0 = kcuda.launch_counts["grid_encoder_fwd"]
    got = ge.grid_encoder_fwd_cuda(spec, emb.to(dev), x.to(dev), 1.0)
    torch.cuda.synchronize()
    assert kcuda.launch_counts["grid_encoder_fwd"] == n0 + 1
    assert got.shape == (B, spec.num_levels, 2) and got.dtype == torch.float32
    got = got.cpu()
    oob = (x.abs() > 1).any(-1)
    assert int(oob.sum()) == B - 3 * (B // 4)
    assert torch.equal(got[oob], torch.zeros_like(got[oob]))
    assert got[~oob].abs().max() > 0
    assert (got - ref).abs().max() <= 1e-6 * emb.float().abs().max()


def test_grid_encoder_fwd_kernel_refuses_bad_inputs(dev):
    """A CUDA tensor launches kernel H or raises: a half-precision table,
    float64 positions handed to the kernel's wrapper, positions left on
    the CPU and a 2-D spec are refused before any launch."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_encoder as ge

    spec = ge.GridEncoderSpec(**_MAIN, **_TILED)
    emb = torch.zeros(spec.table_size, 2, device=dev)
    x = torch.zeros(8, 3, device=dev)
    n0 = kcuda.launch_counts["grid_encoder_fwd"]
    with pytest.raises(TypeError):
        spec(emb.half(), x)
    with pytest.raises(TypeError):
        ge.grid_encoder_fwd_cuda(spec, emb, x.double(), 1.0)
    with pytest.raises(ValueError):
        spec(emb, x.cpu())
    flat = ge.GridEncoderSpec(input_dim=2, num_levels=2)
    with pytest.raises(ValueError):
        flat(torch.zeros(flat.table_size, 2, device=dev), x[:, :2])
    assert kcuda.launch_counts["grid_encoder_fwd"] == n0


@pytest.mark.parametrize("spec_kw", [dict(_MAIN, **_TILED),
                                     dict(gridtype="hash")],
                         ids=["-O tiled spec", "hash spec"])
def test_grid_encoder_call_builds_residuals_only_for_autograd(dev, spec_kw,
                                                              monkeypatch):
    """Through the encoder on the card: under no_grad one kernel H launch
    and no residuals (residuals and residuals_rows raise); with grad one
    kernel H launch for the same output bit for bit, and one backward
    kernel (A for the tiled spec, E for the hashed) in the backward."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_encoder as ge

    spec = ge.GridEncoderSpec(**spec_kw)
    g = torch.Generator(device=dev).manual_seed(23)
    emb = spec.init(g, dev).requires_grad_(True)
    x = (torch.rand(50_000, 3, device=dev, generator=g) * 2 - 1) * 1.05
    bwd = "grid_encoder_bwd_rows" if any(spec.hashed_levels) \
        else "grid_encoder_bwd"
    n0 = dict(kcuda.launch_counts)
    out = spec(emb, x)
    out.sum().backward()
    n1 = dict(kcuda.launch_counts)
    assert n1["grid_encoder_fwd"] == n0["grid_encoder_fwd"] + 1
    assert n1[bwd] == n0[bwd] + 1

    def boom(*a, **k):
        raise AssertionError("residuals built under no_grad")

    for name in ("residuals", "residuals_rows"):
        monkeypatch.setattr(ge.GridEncoderSpec, name, boom)
    with torch.no_grad():
        got = spec(emb, x)
    torch.cuda.synchronize()
    assert kcuda.launch_counts["grid_encoder_fwd"] == n1["grid_encoder_fwd"] + 1
    assert torch.equal(got, out.detach())


def test_staged_eval_frame_launches_kernel_h_once_per_field_query(
        dev, monkeypatch):
    """One staged-eval frame (32 x 32, groups of 256 rays, bf16 table) of a
    small grid field: kernel H launches once per field query and neither
    backward kernel launches; no residuals are built."""
    from dreamfusion_torch import cameras
    from dreamfusion_torch.config import Config
    from dreamfusion_torch.models.networks import build_model
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import grid_encoder as ge
    from dreamfusion_torch.ops import marching
    from dreamfusion_torch.training import trainer as tr

    cfg = Config(text="x", grid_ray=True, grid_size=32, max_steps=64,
                 grid_K=32, H=32, W=32, max_ray_batch=256,
                 eval_table_bf16=True)
    g = torch.Generator(device=dev).manual_seed(24)
    model = build_model(cfg, dev, g)
    with torch.no_grad():
        model.embeddings.uniform_(-0.1, 0.1, generator=g)
    gs = marching.update_grid(
        model.density, marching.init_grid_state(cfg.cascade, cfg.grid_size,
                                                dev),
        bound=cfg.bound, density_thresh=cfg.density_thresh, generator=g)
    b = cameras.sample_test_batch(0, 10, cfg, device=dev)
    render = tr.make_staged_grid_eval(cfg, model, cfg.H, cfg.W)

    def boom(*a, **k):
        raise AssertionError("residuals built in the staged eval")

    for name in ("residuals", "residuals_rows"):
        monkeypatch.setattr(ge.GridEncoderSpec, name, boom)
    queries = []
    encode = model.encode
    monkeypatch.setattr(model, "encode", lambda *a, **k: (
        queries.append(a[0].shape[0]), encode(*a, **k))[1])
    n0 = dict(kcuda.launch_counts)
    out = render(b["rays_o"][0], b["rays_d"][0], gs)
    torch.cuda.synchronize()
    launched = {k: v - n0[k] for k, v in kcuda.launch_counts.items()}
    assert queries and launched["grid_encoder_fwd"] == len(queries)
    assert launched["grid_encoder_bwd"] == launched["grid_encoder_bwd_rows"] == 0
    assert float(out["weights_sum"].max()) > 1e-3


# the orbit cells' configurations
_ORBITS = {"grid": "grid_sd15", "dvgo": "dvgo_sd15"}


@pytest.mark.parametrize("kind", ["grid", "dvgo"])
def test_march_window_kernel_matches_the_torch_march(dev, tmp_path, kind):
    """Kernel W against the torch march (march_window_groups_plain) on the
    groups of an 800^2 orbit frame of each orbit cell's configuration
    (chip_smoke.orbit_scene: its seeded field and grid state): the frame's
    own flagged groups; every group of the frame at S 64, 128, 256 and 512
    in turn (K 128) with every 53rd ray turned to miss the box (the
    frame's 1,024 padding rays among them); and the frame's groups at a K
    below the most emits a ray has (at most 16), so rays fill their slots
    and stop early in both scenes. Held as chip_smoke.compare_march_window
    holds it (the kernels phase's check): bitwise but for slots whose
    exclusive optical depth lies within 1e-5 relative of the live cut,
    which are counted. One launch a call; the cut shortens rays at K
    128."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import marching

    from chip_smoke import compare_march_window, frame_march_args, orbit_scene

    cfg, model, gs = orbit_scene(_ORBITS[kind], str(tmp_path))
    (_, o, d, perm, t_lo, gspan, n), kw = frame_march_args(cfg, model, gs)
    G, K = gspan.shape[0], kw["K"]
    assert K == 128 and 0 < n < G and o.shape[0] > cfg.H * cfg.W
    miss = torch.arange(0, o.shape[0], 53, device=dev)
    o2, d2, t2 = o.clone(), d.clone(), t_lo.clone()
    o2[miss] = 3.0
    d2[miss] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    t2[miss] = 1e9                       # classify's t_lo for a miss
    forced = [float((64, 128, 256, 512)[b % 4]) for b in range(G)]
    ref, _ = marching.march_window_groups_plain(gs, o, d, perm, t_lo, gspan,
                                                n, **kw)
    most = max(int((r[3].dts > 0).sum(1).max()) for r in ref)
    small_K = min(16, max(most - 1, 1))
    cases = [("frame", (o, d, perm, t_lo, gspan, n), kw),
             ("S ladder, misses", (o2, d2, perm, t2, torch.tensor(
                 forced[::-1], device=dev), G), kw),
             (f"K {small_K}", (o, d, perm, t_lo, gspan, n),
              dict(kw, K=small_K))]
    for label, args, kw_ in cases:
        n0 = kcuda.launch_counts["march_window"]
        got, gst = marching.march_window_groups_cuda(gs, *args, **kw_)
        assert kcuda.launch_counts["march_window"] == n0 + 1
        ref, rst = marching.march_window_groups_plain(gs, *args, **kw_)
        torch.cuda.synchronize()
        assert len(got) == args[-1]
        seen = compare_march_window(gs, got, gst, ref, rst, K=kw_["K"],
                                    live_logt=kw_["live_logt"],
                                    bound=kw_["bound"], label=label)
        print(f"[{kind}, {label}] {len(got)} groups: slots within 1e-5 of "
              f"the cut {seen['near_cut']}, of them on the other side "
              f"{seen['flipped']}; rays the cut shortens {seen['cut_rays']}, "
              f"rays with K emits {seen['full']}")
        if label.startswith("K "):
            assert seen["full"] > 0
        else:
            assert seen["cut_rays"] > 0


@pytest.mark.parametrize("kind,mean_limit,max_limit",
                         [("grid", 0.3, 4), ("dvgo", 5e-3, 3)])
def test_staged_frame_through_kernel_w_keeps_the_cells_limits(
        dev, tmp_path, monkeypatch, kind, mean_limit, max_limit):
    """A staged 800^2 orbit frame with kernel W against the same frame
    through the torch march, both written as Trainer._save_frame writes
    them (8 bits): within the cell's frame_mean_gap and frame_max_gap
    limits (benchmark/cells/grid_sd15.eval_orbit.json,
    dvgo_sd15.edit_orbit.json); kernel W launches once a frame, and not
    at all with the torch march."""
    from dreamfusion_torch import cameras
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import marching
    from dreamfusion_torch.training import trainer as tr

    from chip_smoke import orbit_scene

    cfg, model, gs = orbit_scene(_ORBITS[kind], str(tmp_path))
    render = tr.make_staged_grid_eval(cfg, model, cfg.H, cfg.W)
    b = cameras.sample_test_batch(7, 100, cfg, H=cfg.H, W=cfg.W, device=dev)

    def frame():
        out = render(b["rays_o"][0], b["rays_d"][0], gs)
        return (out["image"].clamp(0, 1) * 255).to(torch.uint8)

    n0 = kcuda.launch_counts["march_window"]
    new = frame()
    assert kcuda.launch_counts["march_window"] == n0 + 1
    monkeypatch.setattr(marching, "march_window_groups_cuda",
                        marching.march_window_groups_plain)
    old = frame()
    assert kcuda.launch_counts["march_window"] == n0 + 1
    gap = (new.int() - old.int()).abs()
    print(f"[{kind}] staged frame, kernel W vs the torch march: mean gap "
          f"{float(gap.float().mean()):.6g}, max {int(gap.max())} levels")
    assert float(gap.float().mean()) <= mean_limit
    assert int(gap.max()) <= max_limit


def test_march_window_groups_keeps_the_torch_march_for_cascades(dev):
    """A grid of two cascades on the card keeps the torch march (kernel W
    probes a single cascade's density EMA): no launch, the plain result."""
    from dreamfusion_torch.ops import cuda as kcuda
    from dreamfusion_torch.ops import marching

    g = torch.Generator(device=dev).manual_seed(9)
    dgrid = torch.rand(2, 32, 32, 32, device=dev, generator=g) * 20.0
    gs = marching.GridState(dgrid, dgrid > 10.0, dgrid.mean())
    group, G = 64, 4
    o = torch.nn.functional.normalize(
        torch.randn(G * group, 3, device=dev, generator=g), dim=-1) * 5.0
    d = torch.nn.functional.normalize(
        torch.rand(G * group, 3, device=dev, generator=g) - 0.5 - o, dim=-1)
    t_lo = torch.full((G * group,), 3.0, device=dev)
    perm = torch.randperm(G * group, device=dev, generator=g)
    spans = [200.0, 30.0]
    gspan = torch.tensor([0.0, 0.0] + spans[::-1], device=dev)
    kw = dict(group=group, aabb=torch.tensor([-2.0] * 3 + [2.0] * 3,
                                             device=dev),
              min_near=0.1, density_thresh=10.0, live_logt=11.05236,
              bound=2.0, max_steps=256, S_ladder=(32, 64, 128, 256), K=32)
    n0 = kcuda.launch_counts["march_window"]
    got, gst = marching.march_window_groups(gs, o, d, perm, t_lo, gspan,
                                            len(spans), **kw)
    ref, rst = marching.march_window_groups_plain(gs, o, d, perm, t_lo,
                                                  gspan, len(spans), **kw)
    assert kcuda.launch_counts["march_window"] == n0
    assert gst == rst and all(s[2] == -1.0 for s in gst)
    for gr, rr in zip(got, ref):
        for a, b in zip(gr[:3] + gr[4:] + tuple(gr[3]),
                        rr[:3] + rr[4:] + tuple(rr[3])):
            assert torch.equal(a, b)


def test_march_window_kernel_refuses_bad_inputs(dev):
    """The wrapper checks dtypes, shapes, that the rays are whole groups
    and that the flagged groups are among them."""
    from dreamfusion_torch.ops import marching

    gs = marching.init_grid_state(1, 8, dev)
    o = torch.zeros(64, 3, device=dev)
    perm = torch.arange(64, device=dev)
    t_lo = torch.zeros(64, device=dev)
    gspan = torch.ones(2, device=dev)
    kw = dict(group=32, aabb=torch.tensor([-1.0] * 3 + [1.0] * 3, device=dev),
              min_near=0.1, density_thresh=10.0, live_logt=11.05236,
              bound=1.0, max_steps=64, S_ladder=(8, 16, 64), K=16)
    with pytest.raises(TypeError):
        marching.march_window_groups_cuda(gs, o, o, perm.int(), t_lo, gspan,
                                          1, **kw)
    with pytest.raises(ValueError):
        marching.march_window_groups_cuda(gs, o, o, perm, t_lo, gspan[:1],
                                          1, **kw)
    with pytest.raises(ValueError):
        marching.march_window_groups_cuda(gs, o, o, perm, t_lo, gspan, 3,
                                          **kw)
    with pytest.raises(ValueError):
        marching.march_window_groups_cuda(gs, o, o.cpu(), perm, t_lo, gspan,
                                          1, **kw)
    with pytest.raises(ValueError):
        marching.march_window_groups_cuda(gs, o, o, perm, t_lo, gspan, 1,
                                          **dict(kw, S_ladder=tuple(range(
                                              1, 9))))
