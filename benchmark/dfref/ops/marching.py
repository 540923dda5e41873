"""Occupancy-grid ray marching and compositing (stable-dreamfusion's
raymarching/ and nerf/renderer.py:446-613), in plain PyTorch for the
benchmark's reference.

- ``GridState`` / ``update_grid``: the density-grid EMA and occupancy
  threshold;
- ``march_rays`` (dt_gamma = 0): every lattice point t0 + k*dt is tested
  against the occupancy grid at once, then the emitted samples are
  compacted to the first K per ray (``_compact``);
- ``render_grid`` / ``shade_march``: field query at every one of the N*K
  slots, compositing (ops/composite.py, differentiated by autograd),
  background, orient loss and the count statistics.

Random draws (march perturbation, light direction, grid jitter) can be
injected."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dfref.cameras import safe_normalize
from dfref.ops.composite import composite, near_far_from_aabb

SQRT3 = math.sqrt(3.0)


class GridState(NamedTuple):
    density_grid: torch.Tensor   # [CAS, H, H, H] f32 EMA of sigma
    occ: torch.Tensor            # [CAS, H, H, H] bool
    mean_density: torch.Tensor   # [] f32


def init_grid_state(cascade: int, grid_size: int,
                    device: Optional[torch.device] = None) -> GridState:
    H = grid_size
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


def _probe_occupancy(occ, rays_o, rays_d, ts, bound: float) -> torch.Tensor:
    """Occupancy at lattice points ts [N, S] -> bool [N, S]; the cascade
    level follows from the position (mip from dt is 0 on this lattice)."""
    C, H = occ.shape[0], occ.shape[1]
    x = _lattice_points(rays_o, rays_d, ts, bound)
    if C == 1:
        return occ.reshape(-1)[_flat_cells(x, bound, H)]
    mx = torch.maximum(x[0].abs(), torch.maximum(x[1].abs(), x[2].abs()))
    level = torch.clamp(
        (torch.floor(torch.log2(torch.clamp(mx, min=1e-30))) + 1.0)
        .to(torch.int32), 0, C - 1)
    mip_bound = torch.clamp(torch.exp2(level.float()), max=bound)
    flat = _flat_cells(x, mip_bound, H) + level * H ** 3
    return occ.reshape(-1)[flat]


def _compact(ts, dts, emits, K: int) -> MarchOut:
    """Move the emitted samples of each ray, in order, to its first K
    slots (the sort on key = t-or-inf of marching.py:580-613)."""
    key = torch.where(emits, ts, torch.full_like(ts, math.inf))
    key_sorted, order = torch.sort(key, dim=1)
    dt_sorted = torch.gather(dts, 1, order)
    S = ts.shape[1]
    if S < K:
        key_sorted = F.pad(key_sorted, (0, K - S), value=math.inf)
        dt_sorted = F.pad(dt_sorted, (0, K - S))
    counts = emits.sum(1)
    k_ar = torch.arange(K, device=ts.device)[None, :]
    valid = k_ar < torch.clamp(counts, max=K)[:, None]
    zero = torch.zeros((), device=ts.device)
    return MarchOut(ts=torch.where(valid, key_sorted[:, :K], zero),
                    dts=torch.where(valid, dt_sorted[:, :K], zero),
                    valid=valid, counts=counts)


@torch.no_grad()
def march_rays(occ, rays_o, rays_d, nears, fars, *, bound: float,
               max_steps: int, K: int, dt_gamma: float = 0.0,
               perturb: bool = False,
               generator: Optional[torch.Generator] = None,
               perturb_u: Optional[torch.Tensor] = None) -> MarchOut:
    """Fixed-K occupancy-grid marching on the uniform lattice
    (dt_gamma = 0; marching.py:556-577). perturb_u (optional): [N] uniform in [0, 1); the
    start moves by dt * u, dt the start's step size."""
    N = rays_o.shape[0]
    if dt_gamma != 0.0:
        raise ValueError("the reference marches the uniform lattice only")
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
    return _compact(ts, torch.full_like(ts, dt), emits, K)


def render_grid(fns, grid_state: GridState, rays_o, rays_d, *,
                bound: float = 1.0, min_near: float = 0.1,
                max_steps: int = 512, K: int = 128, dt_gamma: float = 0.0,
                bg_radius: float = 1.4, light_d=None,
                ambient_ratio: float = 1.0, shading_code: int = 0,
                bg_color=None, perturb: bool = False, T_thresh: float = 1e-4,
                compute_normal_losses: bool = False,
                generator: Optional[torch.Generator] = None,
                light_n: Optional[torch.Tensor] = None,
                perturb_u: Optional[torch.Tensor] = None,
                aabb: Optional[Sequence[float]] = None
                ) -> Dict[str, torch.Tensor]:
    """Full grid-accelerated render (the reference's run_cuda,
    renderer.py:446-559). Draws (optional): light_n [3] standard normal
    (light_d = normalize(rays_o[0] + light_n)), perturb_u [N]. aabb (optional): the ray
    box (xmin, ymin, zmin, xmax, ymax, zmax) in place of +-bound."""
    dev = rays_o.device
    aabb = torch.tensor(list(aabb) if aabb is not None
                        else [-bound] * 3 + [bound] * 3, dtype=torch.float32,
                        device=dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    if light_d is None:
        if light_n is None:
            light_n = torch.randn(3, generator=generator, device=dev)
        light_d = safe_normalize(rays_o[0] + light_n)
    march = march_rays(grid_state.occ, rays_o.detach(), rays_d.detach(),
                       nears, fars, bound=bound, max_steps=max_steps, K=K,
                       dt_gamma=dt_gamma, perturb=perturb, generator=generator,
                       perturb_u=perturb_u)
    return shade_march(fns, march, rays_o, rays_d, nears, fars, K=K,
                       bound=bound, light_d=light_d,
                       ambient_ratio=ambient_ratio, shading_code=shading_code,
                       bg_radius=bg_radius, bg_color=bg_color,
                       T_thresh=T_thresh,
                       compute_normal_losses=compute_normal_losses)


def shade_march(fns, march: MarchOut, rays_o, rays_d, nears, fars, *, K: int,
                bound: float, light_d, ambient_ratio: float = 1.0,
                shading_code: int = 0, bg_radius: float = 1.4, bg_color=None,
                T_thresh: float = 1e-4, compute_normal_losses: bool = False,
                ) -> Dict[str, torch.Tensor]:
    """Field query at all N*K slots and compositing over pre-marched
    samples (marching.py:849-1031)."""
    N = rays_o.shape[0]
    if K < march.ts.shape[1]:
        march = MarchOut(march.ts[:, :K], march.dts[:, :K],
                         march.valid[:, :K], march.counts)
    valid_f = march.valid.float()
    xyzs = torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * march.ts[..., None],
                       -bound, bound)
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    sigma, color, normal = fns.field(xyzs.reshape(-1, 3), dirs.reshape(-1, 3),
                                     light_d, ambient_ratio, shading_code)
    sigma = sigma.reshape(N, K) * valid_f
    color = color.reshape(N, K, 3)
    dts = march.dts * valid_f
    out = composite(sigma, color, dts, march.ts, T_thresh)
    # unmasked transmittance of the detached densities: the orient loss's
    # weights and the live count (marching.py:966-1018)
    with torch.no_grad():
        alphas_sg = 1.0 - torch.exp(-sigma.detach() * dts)
        trans_sg = torch.cumprod(torch.cat(
            [torch.ones(N, 1, device=sigma.device),
             1.0 - alphas_sg + 1e-15], 1), 1)[:, :-1]
        live_counts = (march.valid & (trans_sg > T_thresh)).sum(1).float()

    results: Dict[str, torch.Tensor] = {}
    if compute_normal_losses:
        normal = normal.reshape(N, K, 3)
        w_sg = alphas_sg * trans_sg * valid_f
        loss_orient = w_sg * torch.clamp((normal * dirs).sum(-1), min=0.0) ** 2
        results["loss_orient"] = loss_orient.sum(-1).mean()

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
        "n_field_samples": torch.tensor(N * K),
    })
    return results
