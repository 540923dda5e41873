"""Occupancy-grid ray marching, train side (counterpart of
dreamfusion_tpu/ops/marching.py; reference raymarching/ and
nerf/renderer.py:446-613).

- ``GridState`` / ``update_grid``: the density-grid EMA and occupancy
  threshold, with the JAX package's partial (quarter-lattice) refreshes.
- ``march_rays`` (dt_gamma = 0): every lattice point t0 + k*dt is tested
  against the occupancy grid at once, then the emitted samples are
  compacted to the first K per ray (``_compact``). With dt_gamma > 0 (cone
  stepping: dt grows with t) it takes ``march_rays_cone``: kernel F
  (csrc/march_cone.cu, a thread per ray) on a CUDA tensor,
  ``march_rays_cone_plain`` (max_steps masked steps) on a CPU tensor.
- ``march_window_groups``: the staged eval's windowed march of a frame's
  flagged ray groups with its sigma-EMA live cut: kernel W
  (csrc/march_window.cu, every group in one launch) on a CUDA tensor with
  a single-cascade grid, ``march_window_groups_plain`` (a group at a time,
  ``march_rays_window``) otherwise.
- ``make_compact_map`` / ``compact_expand``: the field is queried at a
  global budget of M samples; when the marched total exceeds M every ray
  keeps floor(count * M / total) samples (the JAX truncation semantics).
- ``render_grid`` / ``shade_march``: field query, fused compositing
  (ops/fused_composite.py, kernels B-fwd/B-bwd on the GPU), background,
  orient loss and the count statistics the trainer's K/M pickers read;
  under the recorder's spans render/march, render/field (the field
  queries with their finite-difference normals) and render/composite
  (dreamfusion_torch.trace), kept out of torch.profiler's trace.
- ``composite_compact``: the staged eval's compositor on the compact buffer
  (kernel C on the GPU).

Random draws (march perturbation, light direction, grid jitter) can be
injected, as everywhere in the port.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dreamfusion_torch import trace
from dreamfusion_torch.cameras import safe_normalize
from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.ops import cuda, fused_composite, probe
from dreamfusion_torch.ops.composite import CompositeOut, near_far_from_aabb
from dreamfusion_torch.ops.fused_composite import composite_fused

SQRT3 = math.sqrt(3.0)


class GridState(NamedTuple):
    density_grid: torch.Tensor   # [CAS, H, H, H] f32 EMA of sigma
    occ: torch.Tensor            # [CAS, H, H, H] bool
    mean_density: torch.Tensor   # [] f32


def init_grid_state(cascade: int, grid_size: int,
                    device: Optional[torch.device] = None) -> GridState:
    H = grid_size
    device = resolve_device(device)
    return GridState(
        density_grid=torch.zeros(cascade, H, H, H, device=device),
        occ=torch.zeros(cascade, H, H, H, dtype=torch.bool, device=device),
        mean_density=torch.zeros((), device=device))


def grid_cells(H: int, partial: Optional[Tuple[int, int]],
               device: torch.device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cell centres in [-1, 1]^3 ([n, 3]) and, for a partial refresh, the
    flat indices of the selected cells."""
    lin = 2.0 * torch.arange(H, dtype=torch.float32, device=device) / (H - 1) - 1.0
    X, Y, Z = torch.meshgrid(lin, lin, lin, indexing="ij")
    xyzs = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)
    if partial is None:
        return xyzs, None
    phase, parts = partial
    n_cells = H ** 3
    sel = (phase % parts) + parts * torch.arange(n_cells // parts,
                                                 device=device)
    sel = torch.clamp(sel, max=n_cells - 1)
    return xyzs[sel], sel


@torch.no_grad()
def update_grid(density_fn, state: GridState, *, bound: float,
                density_thresh: float, decay: float = 0.95,
                partial: Optional[Tuple[int, int]] = None,
                generator: Optional[torch.Generator] = None,
                jitter: Optional[torch.Tensor] = None) -> GridState:
    """One occupancy refresh (reference nerf/renderer.py:562-613).

    jitter (optional): [CAS, n, 3] uniform in [0, 1), the per-cell position
    jitter of each cascade. partial=(phase, parts) refreshes the cells whose
    flat index is phase mod parts; the rest only decay."""
    CAS, H = state.density_grid.shape[0], state.density_grid.shape[1]
    dev = state.density_grid.device
    xyzs, sel = grid_cells(H, partial, dev)
    new_levels = []
    for cas in range(CAS):
        cas_bound = min(2 ** cas, bound)
        half = cas_bound / H
        u = (jitter[cas] if jitter is not None else
             torch.rand(xyzs.shape, generator=generator, device=dev))
        pts = xyzs * (cas_bound - half) + (u * 2.0 - 1.0) * half
        sig = density_fn(pts)["sigma"].float()
        if sel is not None:
            full = torch.full((H ** 3,), -1.0, device=dev)
            sig = full.index_copy(0, sel, sig)
        new_levels.append(sig.reshape(H, H, H))
    grid = torch.maximum(state.density_grid * decay, torch.stack(new_levels))
    mean_density = grid.mean()
    occ = grid > torch.clamp(mean_density, max=density_thresh)
    return GridState(density_grid=grid, occ=occ, mean_density=mean_density)


def refresh_partial(refresh_idx: int) -> Optional[Tuple[int, int]]:
    """The first 4 refreshes are full; then each covers one quarter
    (make_update_extra_state, marching.py:196-201)."""
    return None if refresh_idx < 4 else (refresh_idx % 4, 4)


class MarchOut(NamedTuple):
    ts: torch.Tensor      # [N, K] sample positions along rays
    dts: torch.Tensor     # [N, K] step sizes
    valid: torch.Tensor   # [N, K] bool
    counts: torch.Tensor  # [N] emitted samples before truncation


def _lattice_points(rays_o, rays_d, ts, bound: float):
    """Per-axis positions of the lattice points ts [N, S], clamped to the
    box: three [N, S] tensors."""
    return [torch.clamp(rays_o[:, d:d + 1] + ts * rays_d[:, d:d + 1],
                        -bound, bound) for d in range(3)]


def _flat_cells(x, mip_bound, H: int) -> torch.Tensor:
    """Flat int32 cell index of per-axis positions x in [-mip_bound,
    mip_bound] on an H^3 grid."""
    n = [torch.clamp(0.5 * (x[d] / mip_bound + 1.0) * H, 0.0, H - 1.0)
         .to(torch.int32) for d in range(3)]
    return (n[0] * H + n[1]) * H + n[2]


def _probe_gather(occ_flat: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Bool occupancy [T] at int32 indices flat -> bool, flat's shape.
    Small tables (the staged eval's pooled grid) take probe_select_small,
    kernel D on the GPU, where the JAX package takes K4
    (marching.py:350-360)."""
    if probe.fits(occ_flat.shape[0]):
        vals = probe.probe_select_small(occ_flat.to(torch.uint8),
                                        flat.reshape(-1))
        return (vals != 0).reshape(flat.shape)
    return occ_flat[flat]


def _probe_occupancy(occ, rays_o, rays_d, ts, bound: float) -> torch.Tensor:
    """Occupancy at lattice points ts [N, S] -> bool [N, S]; the cascade
    level follows from the position (mip from dt is 0 on this lattice)."""
    C, H = occ.shape[0], occ.shape[1]
    x = _lattice_points(rays_o, rays_d, ts, bound)
    if C == 1:
        return _probe_gather(occ.reshape(-1), _flat_cells(x, bound, H))
    mx = torch.maximum(x[0].abs(), torch.maximum(x[1].abs(), x[2].abs()))
    level = torch.clamp(
        (torch.floor(torch.log2(torch.clamp(mx, min=1e-30))) + 1.0)
        .to(torch.int32), 0, C - 1)
    mip_bound = torch.clamp(torch.exp2(level.float()), max=bound)
    flat = _flat_cells(x, mip_bound, H) + level * H ** 3
    return _probe_gather(occ.reshape(-1), flat)


def probe_density(density_grid, rays_o, rays_d, ts,
                  bound: float) -> torch.Tensor:
    """Nearest-cell density-EMA lookups at points ts [N, S] -> f32 [N, S]
    (single cascade; the same cells as _probe_occupancy, so the staged
    eval's live estimate agrees with the occupancy its march used)."""
    H = density_grid.shape[1]
    flat = _flat_cells(_lattice_points(rays_o, rays_d, ts, bound), bound, H)
    return density_grid[0].reshape(-1)[flat].float()


def pool_occ(occ: torch.Tensor, factor: int) -> torch.Tensor:
    """factor^3 max-pool of the occupancy grid, then a 3^3 dilation at the
    coarse resolution: a cell is set iff any fine voxel within one coarse
    block of it is occupied, so a ray probe of the result with spacing <=
    2 coarse blocks never misses a fine emit (marching.py:430-442)."""
    pooled = F.max_pool3d(occ.float(), factor, factor) > 0
    return dilate_occ(pooled)


def max_pooled_stride(max_steps: int, grid_size: int, factor: int) -> int:
    """Largest sound probe stride against pool_occ(occ, factor)."""
    s = int((4.0 * max_steps * factor) / (2.0 * SQRT3 * grid_size))
    return max(1, min(s, max_steps // 4))


def dilate_occ(occ: torch.Tensor) -> torch.Tensor:
    """3x3x3 max-pool dilation of the occupancy grid, per cascade."""
    return F.max_pool3d(occ.float(), 3, 1, 1) > 0


def max_coarse_stride(max_steps: int, grid_size: int) -> int:
    """Largest sound probe stride against the dilated fine grid."""
    s = int((4.0 * max_steps) / (2.0 * SQRT3 * grid_size))
    return max(1, min(s, 8))


def _coarse_hits(occ_coarse, rays_o, rays_d, nears, fars, *, bound: float,
                 max_steps: int, stride: int):
    """Probe hits [N, S] at every stride-th lattice point, and their
    spacing."""
    S = max_steps // stride
    spacing = stride * 2.0 * SQRT3 / max_steps
    ts = nears[:, None] + spacing * torch.arange(
        S, dtype=torch.float32, device=nears.device)[None, :]
    alive = ts < (fars[:, None] + spacing)   # pad far so tail probes land
    hits = _probe_occupancy(occ_coarse, rays_o, rays_d, ts, bound) & alive
    return hits, spacing


@torch.no_grad()
def coarse_hit_counts(occ_dilated, rays_o, rays_d, nears, fars, *,
                      bound: float, max_steps: int,
                      stride: int) -> torch.Tensor:
    """Conservative per-ray hit counts (marching.py:473-489): 0 proves the
    full march emits nothing."""
    hits, _ = _coarse_hits(occ_dilated, rays_o, rays_d, nears, fars,
                           bound=bound, max_steps=max_steps, stride=stride)
    return hits.sum(1)


@torch.no_grad()
def coarse_hit_window(occ_coarse, rays_o, rays_d, nears, fars, *,
                      bound: float, max_steps: int, stride: int):
    """coarse_hit_counts plus a [t_lo, t_hi] bracket of every possible fine
    emit (marching.py:492-516); rays without hits get t_lo = t_hi = near.
    Returns (counts [N], t_lo [N], t_hi [N])."""
    hits, spacing = _coarse_hits(occ_coarse, rays_o, rays_d, nears, fars,
                                 bound=bound, max_steps=max_steps,
                                 stride=stride)
    counts = hits.sum(1)
    idx = torch.arange(hits.shape[1], dtype=torch.float32,
                       device=hits.device)[None, :]
    first = torch.where(hits, idx, math.inf).amin(1)
    last = torch.where(hits, idx, -math.inf).amax(1)
    has = counts > 0
    t_lo = torch.where(has, nears + (first - 1.0) * spacing, nears)
    t_lo = torch.maximum(t_lo, nears)
    t_hi = torch.where(has, nears + (last + 1.0) * spacing, nears)
    t_hi = torch.minimum(t_hi, fars + spacing)
    return counts, t_lo, t_hi


@torch.no_grad()
def march_rays_window(occ, rays_o, rays_d, nears, fars, t_lo, *,
                      bound: float, max_steps: int, S: int, K: int,
                      density_grid: Optional[torch.Tensor] = None,
                      occ_thresh=None):
    """Uniform-lattice march over S lattice points from the first aligned
    lattice index >= t_lo (eval only, no perturbation; marching.py:519-553).
    With density_grid and occ_thresh (min(mean_density, density_thresh)) a
    single-cascade march probes the sigma EMA instead of the bool grid
    (occupancy is exactly sigma_ema > occ_thresh) and carries the probed
    sigma through compaction. Returns (MarchOut, sigma_est [N, K] or
    None).

    The lattice point k0 + j is computed as near + dt * (k0 + j), exactly
    as the full march computes point k (near + dt * k), so the window's
    points are bitwise the full march's. The JAX package computes
    (near + k0 dt) + j dt, which rounds differently; a point that lies on a
    cell face can then land in the other cell, and a sample appears or
    vanishes (ROADMAP.md, queue 3)."""
    dt = 2.0 * SQRT3 / max_steps
    k0 = torch.floor((t_lo - nears) / dt)
    ts = nears[:, None] + dt * (k0[:, None] + torch.arange(
        S, dtype=torch.float32, device=nears.device)[None, :])
    alive = ts < fars[:, None]
    dts = torch.full_like(ts, dt)
    if density_grid is not None and occ.shape[0] == 1:
        sig = probe_density(density_grid, rays_o, rays_d, ts, bound)
        return _compact(ts, dts, (sig > occ_thresh) & alive, K, payload=sig)
    emits = _probe_occupancy(occ, rays_o, rays_d, ts, bound) & alive
    return _compact(ts, dts, emits, K)[0], None


def window_length(span: float, ladder: Sequence[int]) -> int:
    """The first S of the ascending S ladder that covers `span` lattice
    points, else the ladder's last."""
    return next((s for s in ladder if s >= span), ladder[-1])


@torch.no_grad()
def march_window_live(gs: GridState, o, d, t_lo, aabb, *, min_near: float,
                      density_thresh: float, live_logt: float, bound: float,
                      max_steps: int, S: int, K: int):
    """Windowed march of one ray group + (live bucket, count bucket, live
    total) [3]: with a single cascade a slot stays valid while the sigma
    EMA's exclusive optical depth along its ray is below live_logt; the
    total is -1 where the live estimate is not built (cascade > 1). Returns
    (MarchOut with counts the valid slots, nears, fars, stats)."""
    nears, fars = near_far_from_aabb(o, d, aabb, min_near)
    thresh = torch.clamp(gs.mean_density, max=density_thresh)
    m, sig_est = march_rays_window(
        gs.occ, o, d, nears, fars, t_lo, bound=bound, max_steps=max_steps,
        S=S, K=K, density_grid=gs.density_grid, occ_thresh=thresh)
    gcount = torch.clamp(m.counts, max=K).max().float()
    if sig_est is None:
        glive, ltot = gcount, torch.full_like(gcount, -1.0)
    else:
        depth = torch.cumsum(torch.clamp(sig_est, min=0.0) * m.dts * m.valid,
                             1)
        depth_ex = torch.cat([torch.zeros_like(depth[:, :1]),
                              depth[:, :-1]], 1)
        # a prefix of valid: the estimated optical depth is monotone
        live = m.valid & (depth_ex < live_logt)
        m = m._replace(valid=live)
        live_counts = live.sum(1)
        glive, ltot = live_counts.max().float(), live_counts.sum().float()
    m = m._replace(counts=m.valid.sum(1))
    return m, nears, fars, torch.stack([glive, gcount, ltot])


@torch.no_grad()
def march_window_groups_plain(gs: GridState, o, d, perm, t_lo, gspan,
                              n: int, *, group: int, aabb, min_near: float,
                              density_thresh: float, live_logt: float,
                              bound: float, max_steps: int,
                              S_ladder: Sequence[int], K: int):
    """march_window_groups, one group after another (march_window_live),
    each group's S from its span taken to the host, the groups' stats to
    the host in one transfer."""
    G = gspan.shape[0]
    marched, stats = [], []
    for b, span in enumerate(gspan[G - n:].flip(0).tolist()):
        g = G - 1 - b
        ridx = perm[g * group:(g + 1) * group]
        o_g, d_g = o[ridx], d[ridx]
        m, nears, fars, st = march_window_live(
            gs, o_g, d_g, t_lo[ridx], aabb, min_near=min_near,
            density_thresh=density_thresh, live_logt=live_logt, bound=bound,
            max_steps=max_steps, S=window_length(span, S_ladder), K=K)
        marched.append((ridx, o_g, d_g, m, nears, fars))
        stats.append(st)
    return marched, (torch.stack(stats).cpu().tolist() if stats else [])


@torch.no_grad()
def march_window_groups_cuda(gs: GridState, o, d, perm, t_lo, gspan,
                             n: int, *, group: int, aabb, min_near: float,
                             density_thresh: float, live_logt: float,
                             bound: float, max_steps: int,
                             S_ladder: Sequence[int], K: int):
    """Kernel W: march_window_groups_plain's contract for a single-cascade
    grid, every group in one launch (csrc/march_window.cu). The kernel
    picks each group's S from gspan on the device; its stats come to the
    host in one transfer. The per-group outputs are views of [n, group,
    ...] buffers."""
    if n == 0:
        return [], []
    dev = o.device
    Np, G = o.shape[0], gspan.shape[0]
    H = gs.density_grid.shape[1]
    if Np != G * group:
        raise ValueError(f"{Np} rays are not {G} groups of {group}")
    if not 0 < n <= G:
        raise ValueError(f"{n} flagged groups of {G}")
    if not 0 < len(S_ladder) <= 7:
        raise ValueError(f"the S ladder has 1 to 7 rungs, got {S_ladder}")
    cuda.require(o, "o", torch.float32, (Np, 3))
    cuda.require(d, "d", torch.float32, (Np, 3), dev)
    cuda.require(perm, "perm", torch.int64, (Np,), dev)
    cuda.require(t_lo, "t_lo", torch.float32, (Np,), dev)
    cuda.require(gspan, "gspan", torch.float32, (G,), dev)
    cuda.require(aabb, "aabb", torch.float32, (6,), dev)
    cuda.require(gs.density_grid, "density_grid", torch.float32,
                 (1, H, H, H), dev)
    cuda.require(gs.mean_density, "mean_density", torch.float32, (), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    o_g, d_g = (torch.empty(n, group, 3, **f32) for _ in range(2))
    nears, fars = (torch.empty(n, group, **f32) for _ in range(2))
    ts, dts = (torch.empty(n, group, K, **f32) for _ in range(2))
    valid = torch.empty(n, group, K, dtype=torch.bool, device=dev)
    counts = torch.empty(n, group, dtype=torch.int64, device=dev)
    stats = torch.zeros(n, 3, dtype=torch.int32, device=dev)
    ladder = list(S_ladder) + [S_ladder[-1]] * (7 - len(S_ladder))
    cuda.launch("march_window", dev, *(t.data_ptr() for t in (
        o, d, perm, t_lo, gspan, aabb, gs.density_grid, gs.mean_density,
        o_g, d_g, nears, fars, ts, dts, valid, counts, stats)),
        G - 1, n, group, K, H, *ladder, float(min_near), float(bound),
        2.0 * SQRT3 / max_steps, float(density_thresh), float(live_logt))
    marched = [(perm[(G - 1 - b) * group:(G - b) * group], o_g[b], d_g[b],
                MarchOut(ts[b], dts[b], valid[b], counts[b]), nears[b],
                fars[b]) for b in range(n)]
    return marched, [[float(v) for v in row] for row in stats.cpu().tolist()]


def march_window_groups(gs: GridState, o, d, perm, t_lo, gspan, n: int,
                        **kw):
    """The staged eval's march of its n flagged ray groups, the last n of
    the sort: group b < n is the sorted group g = G - 1 - b (the densest
    first; G = gspan.shape[0]), its rays perm[g group:(g + 1) group],
    marched over the window of S = window_length(gspan[g], S_ladder)
    lattice points from t_lo, with the sigma-EMA live cut
    (march_window_live). gspan [G] holds the groups' span maxima on the
    device. Kernel W (one launch) on a CUDA tensor with a single-cascade grid;
    otherwise a group at a time in PyTorch. Returns ([(ridx, o_g, d_g,
    MarchOut, nears, fars)] and the host's [[glive, gcount, ltot]], one a
    group)."""
    if o.is_cuda and gs.density_grid.shape[0] == 1:
        return march_window_groups_cuda(gs, o, d, perm, t_lo, gspan, n, **kw)
    return march_window_groups_plain(gs, o, d, perm, t_lo, gspan, n, **kw)


def _compact(ts, dts, emits, K: int,
             payload: Optional[torch.Tensor] = None):
    """Move the emitted samples of each ray, in order, to its first K
    slots (the sort on key = t-or-inf of marching.py:580-613); an optional
    per-sample payload rides along. Returns (MarchOut, payload [N, K] or
    None)."""
    key = torch.where(emits, ts, torch.full_like(ts, math.inf))
    key_sorted, order = torch.sort(key, dim=1)
    dt_sorted = torch.gather(dts, 1, order)
    pay_sorted = (torch.gather(payload, 1, order) if payload is not None
                  else None)
    S = ts.shape[1]
    if S < K:
        key_sorted = F.pad(key_sorted, (0, K - S), value=math.inf)
        dt_sorted = F.pad(dt_sorted, (0, K - S))
        if pay_sorted is not None:
            pay_sorted = F.pad(pay_sorted, (0, K - S))
    counts = emits.sum(1)
    k_ar = torch.arange(K, device=ts.device)[None, :]
    valid = k_ar < torch.clamp(counts, max=K)[:, None]
    zero = torch.zeros((), device=ts.device)
    pay_out = (torch.where(valid, pay_sorted[:, :K], zero)
               if pay_sorted is not None else None)
    return MarchOut(ts=torch.where(valid, key_sorted[:, :K], zero),
                    dts=torch.where(valid, dt_sorted[:, :K], zero),
                    valid=valid, counts=counts), pay_out


@torch.no_grad()
def march_rays(occ, rays_o, rays_d, nears, fars, *, bound: float,
               max_steps: int, K: int, dt_gamma: float = 0.0,
               perturb: bool = False,
               generator: Optional[torch.Generator] = None,
               perturb_u: Optional[torch.Tensor] = None) -> MarchOut:
    """Fixed-K occupancy-grid marching (marching.py:231-307). dt_gamma = 0:
    the uniform lattice (marching.py:556-577); dt_gamma > 0: cone stepping
    (march_rays_cone). perturb_u (optional): [N] uniform in [0, 1); the
    start moves by dt * u, dt the start's step size."""
    N = rays_o.shape[0]
    if dt_gamma != 0.0:
        g, dt_min, dt_max, _ = cone_constants(dt_gamma, max_steps,
                                              occ.shape[0], occ.shape[1])
        t0 = nears
        if perturb:
            if perturb_u is None:
                perturb_u = torch.rand(N, generator=generator,
                                       device=rays_o.device)
            t0 = t0 + torch.clamp(t0 * g, dt_min, dt_max) * perturb_u
        return march_rays_cone(occ, rays_o, rays_d, t0, fars, bound=bound,
                               max_steps=max_steps, K=K, dt_gamma=dt_gamma)
    dt = 2.0 * SQRT3 / max_steps
    t0 = nears
    if perturb:
        if perturb_u is None:
            perturb_u = torch.rand(N, generator=generator,
                                   device=rays_o.device)
        t0 = t0 + dt * perturb_u
    ts = t0[:, None] + dt * torch.arange(max_steps, dtype=torch.float32,
                                         device=rays_o.device)[None, :]
    emits = _probe_occupancy(occ, rays_o, rays_d, ts, bound) & (ts < fars[:, None])
    return _compact(ts, torch.full_like(ts, dt), emits, K)[0]


def _f32(x: float) -> float:
    return float(np.float32(x))


def cone_constants(dt_gamma: float, max_steps: int, C: int, H: int):
    """(dt_gamma, dt_min, dt_max, 2 / H) rounded to f32 once, as the JAX
    package's f32 arithmetic takes them (marching.py:262-263, 283): the
    plain version and kernel F both use these values."""
    return (_f32(dt_gamma), _f32(2.0 * SQRT3 / max_steps),
            _f32(2.0 * SQRT3 * (2 ** (C - 1)) / H), _f32(2.0 / H))


def _mip_level(x: torch.Tensor, dt: torch.Tensor, H: int,
               C: int) -> torch.Tensor:
    """max(mip from the position, mip from dt), each floor(log2(max(m,
    1e-30))) + 1 clamped to [0, C-1] (marching.py:210-218) -> int32 [N]."""
    def expo(m):
        return torch.clamp((torch.floor(torch.log2(torch.clamp(m, min=1e-30)))
                            + 1.0).to(torch.int32), 0, C - 1)
    return torch.maximum(expo(x.abs().amax(-1)), expo(dt * H * 0.5))


@torch.no_grad()
def march_rays_cone_plain(occ, rays_o, rays_d, t0, fars, *, bound: float,
                          max_steps: int, K: int,
                          dt_gamma: float) -> MarchOut:
    """Cone-stepping march (marching.py:248-307), the plain version of
    kernel F: exactly max_steps steps over all rays. A step probes the
    occupancy at t (the cascade level from the position and dt); an
    occupied cell emits (t, dt) and advances t by dt, an empty one advances
    with dt re-clamped at every sub-step up to the next voxel face (the
    CUDA do/while, raymarching.cu:396-399), masked per ray, until no ray is
    short of its target. t0 [N] is the (perturbed) start. Returns the first
    K emits of each ray in order and counts = every emit (_compact)."""
    C, H = occ.shape[0], occ.shape[1]
    g, dt_min, dt_max, cell = cone_constants(dt_gamma, max_steps, C, H)
    occ_flat = occ.reshape(-1)
    tiny = torch.where(rays_d >= 0, torch.full_like(rays_d, 1e-15),
                       torch.full_like(rays_d, -1e-15))
    inv_d = torch.reciprocal(torch.where(rays_d.abs() < 1e-15, tiny, rays_d))
    half_sign = 0.5 * torch.sign(rays_d)

    def advance(tv):
        return tv + torch.clamp(tv * g, dt_min, dt_max)

    t = t0
    ts, dts, emits = [], [], []
    for _ in range(max_steps):
        x = torch.clamp(rays_o + t[:, None] * rays_d, -bound, bound)
        dt = torch.clamp(t * g, dt_min, dt_max)
        level = (_mip_level(x, dt, H, C) if C > 1
                 else torch.zeros_like(t, dtype=torch.int32))
        mip = torch.clamp(torch.exp2(level.float()), max=bound)
        n = torch.clamp(0.5 * (x / mip[:, None] + 1.0) * H, 0.0,
                        H - 1.0).to(torch.int32)
        flat = (n[:, 0] * H + n[:, 1]) * H + n[:, 2] + level * H ** 3
        alive = t < fars
        emit = occ_flat[flat] & alive
        nb = (n.float() + 0.5 + half_sign) * cell - 1.0
        t_axis = (nb * mip[:, None] - x) * inv_d
        target = torch.where(emit, t, t + torch.clamp(t_axis.amin(-1),
                                                      min=0.0))
        tv = torch.where(alive, advance(t), t)
        short = (tv < target) & alive
        while bool(short.any()):
            tv = torch.where(short, advance(tv), tv)
            short = (tv < target) & alive
        ts.append(t)
        dts.append(dt)
        emits.append(emit)
        t = tv
    return _compact(torch.stack(ts, 1), torch.stack(dts, 1),
                    torch.stack(emits, 1), K)[0]


@torch.no_grad()
def march_rays_cone_cuda(occ, rays_o, rays_d, t0, fars, *, bound: float,
                         max_steps: int, K: int,
                         dt_gamma: float) -> MarchOut:
    """Kernel F: march_rays_cone_plain's contract, one thread per ray."""
    N = rays_o.shape[0]
    C, H = occ.shape[0], occ.shape[1]
    dev = rays_o.device
    g, dt_min, dt_max, cell = cone_constants(dt_gamma, max_steps, C, H)
    cuda.require(rays_o, "rays_o", torch.float32, (N, 3))
    cuda.require(rays_d, "rays_d", torch.float32, (N, 3), dev)
    cuda.require(t0, "t0", torch.float32, (N,), dev)
    cuda.require(fars, "fars", torch.float32, (N,), dev)
    cuda.require(occ, "occ", torch.bool, (C, H, H, H), dev)
    ts = torch.empty(N, K, dtype=torch.float32, device=dev)
    dts = torch.empty(N, K, dtype=torch.float32, device=dev)
    valid = torch.empty(N, K, dtype=torch.bool, device=dev)
    counts = torch.empty(N, dtype=torch.int64, device=dev)
    cuda.launch("march_cone", dev, rays_o.data_ptr(), rays_d.data_ptr(),
                t0.data_ptr(), fars.data_ptr(), occ.data_ptr(), ts.data_ptr(),
                dts.data_ptr(), valid.data_ptr(), counts.data_ptr(), N, K,
                max_steps, C, H, float(bound), g, dt_min, dt_max, cell)
    return MarchOut(ts=ts, dts=dts, valid=valid, counts=counts)


def march_rays_cone(occ, rays_o, rays_d, t0, fars, **kw) -> MarchOut:
    """Kernel F on a CUDA tensor, the plain version on a CPU tensor."""
    if rays_o.is_cuda:
        return march_rays_cone_cuda(occ, rays_o.contiguous(),
                                    rays_d.contiguous(), t0.contiguous(),
                                    fars.contiguous(), **kw)
    return march_rays_cone_plain(occ, rays_o, rays_d, t0, fars, **kw)


class CompactMap(NamedTuple):
    pos: torch.Tensor       # [N, K] slot -> compact index (M = dropped)
    fwd_flat: torch.Tensor  # [M] compact index -> flat slot n*K + k
    valid_m: torch.Tensor   # [M] bool
    ray_of_m: torch.Tensor  # [M] compact index -> ray
    offs: torch.Tensor      # [N] first compact index of each ray
    cnt: torch.Tensor       # [N] kept sample count per ray


@torch.no_grad()
def make_compact_map(counts: torch.Tensor, K: int, M: int) -> CompactMap:
    """Slot <-> compact maps (marching.py:644-674): per-ray counts capped at
    K, then scaled by min(1, M / total) and floored."""
    N = counts.shape[0]
    dev = counts.device
    c = torch.clamp(counts, max=K).long()
    total = c.sum()
    scale = torch.clamp(M / torch.clamp(total, min=1).float(), max=1.0)
    c2 = torch.floor(c.float() * scale).long()
    cum = torch.cumsum(c2, 0)
    offs = cum - c2
    total2 = cum[-1]
    k_ar = torch.arange(K, device=dev)[None, :]
    pos = torch.where(k_ar < c2[:, None], offs[:, None] + k_ar,
                      torch.full_like(k_ar, M))
    m_ar = torch.arange(M, device=dev)
    keep = cum < M
    hist = torch.zeros(M, dtype=torch.long, device=dev).index_add_(
        0, cum[keep], torch.ones_like(cum[keep]))
    r = torch.clamp(torch.cumsum(hist, 0), max=N - 1)
    k_m = m_ar - offs[r]
    valid_m = m_ar < total2
    fwd_flat = torch.where(valid_m, r * K + torch.clamp(k_m, 0, K - 1),
                           torch.zeros_like(r))
    return CompactMap(pos=pos, fwd_flat=fwd_flat, valid_m=valid_m,
                      ray_of_m=torch.where(valid_m, r, torch.zeros_like(r)),
                      offs=offs, cnt=c2)


class _CompactExpand(torch.autograd.Function):
    """[M, ...] compact values -> [N, K, ...] slots (dropped slots read 0).
    The map is injective over the valid entries, so the backward is a
    gather along fwd_flat (marching.py:677-704): no scatter, whose
    duplicate 'dropped' index would serialise the accumulation."""

    @staticmethod
    def forward(ctx, vals_c, pos, fwd_flat, valid_m):
        ctx.save_for_backward(fwd_flat, valid_m)
        ctx.slots = pos.shape
        zero = vals_c.new_zeros((1,) + vals_c.shape[1:])
        return torch.cat([vals_c, zero], 0)[pos]

    @staticmethod
    def backward(ctx, cot):
        fwd_flat, valid_m = ctx.saved_tensors
        N, K = ctx.slots
        d = cot.reshape((N * K,) + cot.shape[2:])[fwd_flat]
        mask = valid_m.reshape((-1,) + (1,) * (d.ndim - 1))
        return torch.where(mask, d, torch.zeros_like(d)), None, None, None


def compact_expand(vals_c: torch.Tensor, cmap: CompactMap) -> torch.Tensor:
    """[M, ...] compact values -> [N, K, ...] slots; dropped slots read 0."""
    return _CompactExpand.apply(vals_c, cmap.pos, cmap.fwd_flat, cmap.valid_m)


def scatter_add_wide_plain(idx: torch.Tensor, upd: torch.Tensor,
                           T: int) -> torch.Tensor:
    """idx [J] int in [0, T), upd [J, C] -> [T, C] f32 row sums
    (``zeros([T, C]).at[idx].add(upd)``; the contract of
    dreamfusion_tpu/ops/pallas_scatter.py::matmul_scatter_add_wide, summed
    in f32 where the TPU kernel rounds the updates to bf16)."""
    out = torch.zeros(T, upd.shape[1], device=upd.device, dtype=torch.float32)
    return out.index_add_(0, idx.long(), upd.float())


@torch.no_grad()
def composite_compact_plain(sigma_c, color_c, t_c, dt_c, cmap: CompactMap,
                            N: int, T_thresh: float = 0.0):
    """Alpha-composite directly on the ray-major compact sample buffer
    (marching.py:716-792; the eval path, forward only). Samples that the
    compaction dropped have alpha 0 in the dense path, so this is exact,
    not an approximation.

    Transmittance is a per-ray exclusive prefix of l = log(exp(-tau) +
    1e-15) in the flat [M] buffer, in two passes so the running f32 sum
    stays near zero: pass 1 takes approximate per-ray totals from a plain
    cumsum, pass 2 injects minus the previous ray's total at each ray start.
    The per-ray sums of [w, w*t, w*rgb, live] are one scatter_add_wide_plain
    (``index_add_``). Returns (rgb [N,3], weights_sum [N], depth_sum [N],
    live_counts [N])."""
    tau = sigma_c.float() * dt_c.float()
    alpha = 1.0 - torch.exp(-tau)
    l = torch.log(torch.exp(-tau) + 1e-15)
    zero = l.new_zeros(1)
    offs, ends = cmap.offs, cmap.offs + cmap.cnt
    A1 = torch.cat([zero, torch.cumsum(l, 0)])
    S_approx = A1[ends] - A1[offs]
    resets = -torch.cat([zero, S_approx[:-1]])
    z = l.index_add(0, torch.clamp(offs - 1, min=0),
                    torch.where(offs > 0, resets, torch.zeros_like(resets)))
    A2 = torch.cat([zero, torch.cumsum(z, 0)])
    excl = A2[:-1] - A2[offs][cmap.ray_of_m]
    trans = torch.exp(torch.clamp(excl, max=0.0))
    w = alpha * trans
    if T_thresh > 0.0:
        w = torch.where(trans > T_thresh, w, torch.zeros_like(w))
    w = torch.where(cmap.valid_m, w, torch.zeros_like(w))
    live = (cmap.valid_m & (trans > T_thresh)).float()
    color = color_c.float()
    upd = torch.stack([w, w * t_c.float(), w * color[:, 0], w * color[:, 1],
                       w * color[:, 2], live], dim=-1)
    acc = scatter_add_wide_plain(cmap.ray_of_m, upd, N)
    return acc[:, 2:5], acc[:, 0], acc[:, 1], acc[:, 5]


def composite_compact(sigma_c, color_c, t_c, dt_c, cmap: CompactMap, N: int,
                      T_thresh: float = 0.0):
    """Composite the compact buffer: (rgb [N,3], weights_sum [N], depth_sum
    [N], live_counts [N]). Kernel C on a CUDA tensor, the plain two-pass
    form on a CPU tensor."""
    if sigma_c.is_cuda:
        return fused_composite.composite_compact_cuda(
            *(x.float().contiguous() for x in (sigma_c, color_c, t_c, dt_c)),
            cmap, N, T_thresh)
    return composite_compact_plain(sigma_c, color_c, t_c, dt_c, cmap, N,
                                   T_thresh)


def render_grid(fns, grid_state: GridState, rays_o, rays_d, *,
                bound: float = 1.0, min_near: float = 0.1,
                max_steps: int = 512, K: int = 128, dt_gamma: float = 0.0,
                bg_radius: float = 1.4, light_d=None,
                ambient_ratio: float = 1.0, shading_code: int = 0,
                bg_color=None, perturb: bool = False, T_thresh: float = 1e-4,
                compute_normal_losses: bool = False,
                compact_M: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                light_n: Optional[torch.Tensor] = None,
                perturb_u: Optional[torch.Tensor] = None,
                smooth_n: Optional[torch.Tensor] = None,
                aabb: Optional[Sequence[float]] = None
                ) -> Dict[str, torch.Tensor]:
    """Full grid-accelerated render (the reference's run_cuda,
    renderer.py:446-559). Draws (optional): light_n [3] standard normal
    (light_d = normalize(rays_o[0] + light_n)), perturb_u [N], smooth_n
    (standard normal, the smoothness-loss jitter). aabb (optional, the
    eval's cfg.aabb_infer): the ray box (xmin, ymin, zmin, xmax, ymax,
    zmax) in place of +-bound."""
    dev = rays_o.device
    aabb = torch.tensor(list(aabb) if aabb is not None
                        else [-bound] * 3 + [bound] * 3, dtype=torch.float32,
                        device=dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    if light_d is None:
        if light_n is None:
            light_n = torch.randn(3, generator=generator, device=dev)
        light_d = safe_normalize(rays_o[0] + light_n)
    with trace.span("render/march", profile=False):
        march = march_rays(grid_state.occ, rays_o.detach(), rays_d.detach(),
                           nears, fars, bound=bound, max_steps=max_steps,
                           K=K, dt_gamma=dt_gamma, perturb=perturb,
                           generator=generator, perturb_u=perturb_u)
    return shade_march(fns, march, rays_o, rays_d, nears, fars, K=K,
                       bound=bound, light_d=light_d,
                       ambient_ratio=ambient_ratio, shading_code=shading_code,
                       bg_radius=bg_radius, bg_color=bg_color,
                       T_thresh=T_thresh,
                       compute_normal_losses=compute_normal_losses,
                       compact_M=compact_M, generator=generator,
                       smooth_n=smooth_n)


def shade_march(fns, march: MarchOut, rays_o, rays_d, nears, fars, *, K: int,
                bound: float, light_d, ambient_ratio: float = 1.0,
                shading_code: int = 0, bg_radius: float = 1.4, bg_color=None,
                T_thresh: float = 1e-4, compute_normal_losses: bool = False,
                compact_M: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                smooth_n: Optional[torch.Tensor] = None,
                compact_composite: bool = False) -> Dict[str, torch.Tensor]:
    """Field query + compositing over pre-marched samples
    (marching.py:849-1031). compact_M < N*K queries the field at M
    compacted samples instead of all N*K slots; compact_composite (the
    staged eval, forward only) then composites the compact buffer directly
    (composite_compact: kernel C, the compact compositor) instead of
    expanding it for the fused compositor (kernel B)."""
    N = rays_o.shape[0]
    if K < march.ts.shape[1]:
        march = MarchOut(march.ts[:, :K], march.dts[:, :K],
                         march.valid[:, :K], march.counts)
    cmap = None
    compact = compact_M is not None and compact_M < N * K
    if compact and compact_composite and compute_normal_losses:
        raise ValueError("compact_composite is the forward-only eval path; "
                         "it computes no normal losses")
    with trace.span("render/field", profile=False):
        valid_f = march.valid.float()
        xyzs = torch.clamp(rays_o[:, None, :]
                           + rays_d[:, None, :] * march.ts[..., None],
                           -bound, bound)
        dirs = rays_d[:, None, :].expand(xyzs.shape)
        if compact:
            cmap = make_compact_map(march.counts, K, compact_M)
            t_c = march.ts.reshape(-1)[cmap.fwd_flat]
            o_c = rays_o[cmap.ray_of_m]
            d_c = rays_d[cmap.ray_of_m]
            xyz_c = torch.clamp(o_c + d_c * t_c[:, None], -bound, bound)
            sigma_c, color_c, normal_c = fns.field(xyz_c, d_c, light_d,
                                                   ambient_ratio, shading_code)
            sigma_c = torch.where(cmap.valid_m, sigma_c,
                                  torch.zeros_like(sigma_c))
            if not compact_composite:
                sigma = compact_expand(sigma_c, cmap) * valid_f
                color = compact_expand(color_c, cmap)
                kept = cmap.pos < compact_M
                dts = march.dts * (march.valid & kept).float()
        else:
            sigma, color, normal = fns.field(xyzs.reshape(-1, 3),
                                             dirs.reshape(-1, 3), light_d,
                                             ambient_ratio, shading_code)
            sigma = sigma.reshape(N, K) * valid_f
            color = color.reshape(N, K, 3)
            dts = march.dts * valid_f

    with trace.span("render/composite", profile=False):
        if compact and compact_composite:
            dt_c = march.dts.reshape(-1)[cmap.fwd_flat]
            rgb, ws, depth_sum, live_counts = composite_compact(
                sigma_c, color_c, t_c, dt_c, cmap, N, T_thresh)
            out = CompositeOut(weights=None, weights_sum=ws, depth=depth_sum,
                               rgb=rgb)
        else:
            fused = composite_fused(sigma, color, dts, march.ts, T_thresh)
            out = CompositeOut(weights=None, weights_sum=fused.weights_sum,
                               depth=fused.depth, rgb=fused.rgb)
            # unmasked transmittance of the detached densities: the orient
            # loss's weights and the live count (marching.py:966-1018)
            with torch.no_grad():
                alphas_sg = 1.0 - torch.exp(-sigma.detach() * dts)
                trans_sg = torch.cumprod(torch.cat(
                    [torch.ones(N, 1, device=sigma.device),
                     1.0 - alphas_sg + 1e-15], 1), 1)[:, :-1]
                live_counts = (march.valid & (trans_sg > T_thresh)
                               ).sum(1).float()

    results: Dict[str, torch.Tensor] = {}
    if compute_normal_losses:
        with trace.span("render/field", profile=False):
            normal = (compact_expand(normal_c, cmap) if cmap is not None
                      else normal.reshape(N, K, 3))
            w_sg = alphas_sg * trans_sg * valid_f
            loss_orient = w_sg * torch.clamp((normal * dirs).sum(-1),
                                             min=0.0) ** 2
            results["loss_orient"] = loss_orient.sum(-1).mean()
            if fns.normal is not None:
                if cmap is not None:
                    if smooth_n is None:
                        smooth_n = torch.randn(xyz_c.shape,
                                               generator=generator,
                                               device=xyz_c.device)
                    np_c = fns.normal(xyz_c + smooth_n * 1e-2)
                    diff = torch.where(cmap.valid_m[:, None], normal_c - np_c,
                                       torch.zeros_like(np_c)).abs()
                    n_valid = torch.clamp(cmap.valid_m.sum(), min=1)
                    results["loss_smooth"] = diff.sum() / (3.0 * n_valid)
                else:
                    if smooth_n is None:
                        smooth_n = torch.randn(xyzs.shape, generator=generator,
                                               device=xyzs.device)
                    normal_p = fns.normal((xyzs + smooth_n * 1e-2)
                                          .reshape(-1, 3))
                    results["loss_smooth"] = (
                        normal - normal_p.reshape(N, K, 3)).abs().mean()

    with trace.span("render/composite", profile=False):
        if bg_radius > 0 and fns.background is not None:
            bg = fns.background(rays_d)
        elif bg_color is not None:
            bg = bg_color
        else:
            bg = torch.ones(N, 3, device=rays_o.device)
        image = out.rgb + (1.0 - out.weights_sum)[:, None] * bg
        depth = torch.clamp(out.depth - nears, min=0.0) / torch.clamp(
            fars - nears, min=1e-6)

        counts = march.counts.float()
        results.update({
            "image": image,
            "depth": depth,
            "weights_sum": out.weights_sum,
            "mask": nears < fars,
            "mean_count": counts.mean(),
            "count_q95": torch.quantile(counts, 0.95),
            "live_q95": torch.quantile(live_counts, 0.95),
            "n_field_samples": torch.tensor(
                cmap.fwd_flat.shape[0] if cmap is not None else N * K),
        })
    return results
