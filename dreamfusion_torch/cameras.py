"""Camera sampling and ray generation (counterpart of dreamfusion_tpu/cameras.py).

Conventions match the JAX package and the reference (nerf/provider.py,
nerf/utils.py): y-up world, cameras look at the origin with up = (0,-1,0),
cam2world poses [B,4,4], pixel centres at +0.5.

Every random draw can be injected: the JAX package draws with threefry and
PyTorch with Philox, so the parity tests compute the draws on the JAX side
and hand the same numbers in. A draw that is not given comes from the
``torch.Generator`` passed in.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from dreamfusion_torch.device import resolve_device

# View-direction buckets (reference: nerf/provider.py:52-69).
DIR_TEXTS = ("front", "side", "back", "side", "overhead", "bottom")
# the injectable draws of rand_poses
POSE_DRAWS = ("radius", "u_sphere", "u_orbit", "u_select", "center_u",
              "target_n", "up_n")


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """x / ||x|| with a clamped norm (reference: nerf/utils.py:39-40)."""
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def _uniform(shape, generator, device, lo: float = 0.0, hi: float = 1.0):
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


def get_view_direction(thetas: torch.Tensor, phis: torch.Tensor,
                       overhead: float, front: float) -> torch.Tensor:
    """Bucket (theta, phi) [radians] into the 6 DIR_TEXTS classes."""
    res = torch.zeros(thetas.shape, dtype=torch.int64, device=thetas.device)
    res = torch.where((phis >= front) & (phis < math.pi),
                      torch.ones_like(res), res)
    res = torch.where((phis >= math.pi) & (phis < math.pi + front),
                      torch.full_like(res, 2), res)
    res = torch.where(phis >= math.pi + front, torch.full_like(res, 3), res)
    res = torch.where(thetas <= overhead, torch.full_like(res, 4), res)
    res = torch.where(thetas >= math.pi - overhead, torch.full_like(res, 5),
                      res)
    return res


def _lookat_poses(centers: torch.Tensor, targets: torch.Tensor,
                  up_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cam2world poses looking from centers to targets (y-down up vector);
    up_noise [size, 3] (pose jitter) is added to the up vector before it
    is normalised."""
    size = centers.shape[0]
    forward = safe_normalize(targets - centers)
    up = torch.tensor([0.0, -1.0, 0.0], device=centers.device).expand(size, 3)
    right = safe_normalize(torch.cross(forward, up, dim=-1))
    up = torch.cross(right, forward, dim=-1)
    up = safe_normalize(up if up_noise is None else up + up_noise)
    poses = torch.eye(4, device=centers.device).repeat(size, 1, 1)
    poses[:, :3, :3] = torch.stack((right, up, forward), dim=-1)
    poses[:, :3, 3] = centers
    return poses


def rand_poses(size: int, *, radius_range=(1.0, 1.5),
               theta_range=(0.0, 100.0), phi_range=(0.0, 360.0),
               angle_overhead: float = 30.0, angle_front: float = 60.0,
               uniform_sphere_rate: float = 0.5, jitter: bool = False,
               generator: Optional[torch.Generator] = None,
               device: Optional[torch.device] = None,
               radius: Optional[torch.Tensor] = None,
               u_sphere: Optional[torch.Tensor] = None,
               u_orbit: Optional[torch.Tensor] = None,
               u_select: Optional[torch.Tensor] = None,
               center_u: Optional[torch.Tensor] = None,
               target_n: Optional[torch.Tensor] = None,
               up_n: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random orbit-camera poses (reference: nerf/provider.py:72-141).

    Draws (all optional): radius [size] in radius_range, u_sphere [size,3]
    and u_orbit [size,2] uniform in [0,1), u_select [size] uniform in
    [0,1) (< uniform_sphere_rate picks the sphere candidate). With jitter
    (pose jitter, nerf/provider.py:116-128) also center_u [size,3] uniform
    in [0,1) (centers move by U[-0.1, 0.1)), target_n and up_n [size,3]
    standard normal (targets move by N(0, 0.2^2), the up vector by
    N(0, 0.02^2)); they are drawn after the others and only with jitter,
    so the draw stream without it is unchanged.
    Returns (poses [size,4,4], dirs [size] int64, thetas, phis)."""
    device = resolve_device(device)
    theta_range = tuple(map(math.radians, theta_range))
    phi_range = tuple(map(math.radians, phi_range))
    overhead = math.radians(angle_overhead)
    front = math.radians(angle_front)
    if radius is None:
        radius = _uniform((size,), generator, device, *radius_range)
    if u_sphere is None:
        u_sphere = _uniform((size, 3), generator, device)
    if u_orbit is None:
        u_orbit = _uniform((size, 2), generator, device)
    if u_select is None:
        u_select = _uniform((size,), generator, device)

    unit = safe_normalize(torch.stack(
        [(u_sphere[:, 0] - 0.5) * 2.0, u_sphere[:, 1],
         (u_sphere[:, 2] - 0.5) * 2.0], dim=-1))
    thetas_sph = torch.arccos(torch.clamp(unit[:, 1], -1.0, 1.0))
    phis_sph = torch.atan2(unit[:, 0], unit[:, 2])
    phis_sph = torch.where(phis_sph < 0, phis_sph + 2 * math.pi, phis_sph)
    centers_sph = unit * radius[:, None]

    thetas_orb = theta_range[0] + u_orbit[:, 0] * (theta_range[1] - theta_range[0])
    phis_orb = phi_range[0] + u_orbit[:, 1] * (phi_range[1] - phi_range[0])
    centers_orb = torch.stack([
        radius * torch.sin(thetas_orb) * torch.sin(phis_orb),
        radius * torch.cos(thetas_orb),
        radius * torch.sin(thetas_orb) * torch.cos(phis_orb)], dim=-1)

    use_sphere = u_select < uniform_sphere_rate
    thetas = torch.where(use_sphere, thetas_sph, thetas_orb)
    phis = torch.where(use_sphere, phis_sph, phis_orb)
    centers = torch.where(use_sphere[:, None], centers_sph, centers_orb)
    targets = torch.zeros_like(centers)
    up_noise = None
    if jitter:
        if center_u is None:
            center_u = _uniform((size, 3), generator, device)
        if target_n is None:
            target_n = torch.randn((size, 3), generator=generator,
                                   device=device)
        if up_n is None:
            up_n = torch.randn((size, 3), generator=generator, device=device)
        centers = centers + (center_u * 0.2 - 0.1)
        targets = targets + target_n * 0.2
        up_noise = up_n * 0.02
    poses = _lookat_poses(centers, targets, up_noise)
    dirs = get_view_direction(thetas, phis, overhead, front)
    return poses, dirs, thetas, phis


def circle_poses(phi_deg, radius: float = 1.25, theta_deg: float = 60.0,
                 angle_overhead: float = 30.0, angle_front: float = 60.0,
                 device: Optional[torch.device] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic orbit poses for the 360-degree test loop (reference:
    nerf/provider.py:144-175). phi_deg: a number or [B] degrees. Returns
    (poses [B,4,4], dirs [B])."""
    device = resolve_device(device)
    phi = torch.deg2rad(torch.atleast_1d(torch.as_tensor(
        phi_deg, dtype=torch.float32, device=device)))
    theta = torch.full_like(phi, math.radians(theta_deg))
    centers = torch.stack([radius * torch.sin(theta) * torch.sin(phi),
                           radius * torch.cos(theta),
                           radius * torch.sin(theta) * torch.cos(phi)], dim=-1)
    poses = _lookat_poses(centers, torch.zeros_like(centers))
    dirs = get_view_direction(theta, phi, math.radians(angle_overhead),
                              math.radians(angle_front))
    return poses, dirs


def get_rays(poses: torch.Tensor, intrinsics: Tuple[float, float, float, float],
             H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image rays: poses [B,4,4], intrinsics (fx, fy, cx, cy) ->
    (rays_o, rays_d) each [B, H*W, 3] (reference: nerf/utils.py:42-106)."""
    fx, fy, cx, cy = intrinsics
    dev = poses.device
    x = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :]
    y = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None]
    xs = ((x - cx) / fx).expand(H, W)
    ys = ((y - cy) / fy).expand(H, W)
    dirs_cam = torch.stack([xs, ys, torch.ones(H, W, device=dev)],
                           dim=-1).reshape(-1, 3)
    dirs_cam = safe_normalize(dirs_cam)
    rays_d = torch.einsum("nk,bjk->bnj", dirs_cam, poses[:, :3, :3])
    rays_o = poses[:, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def fov_to_focal(fov_deg: torch.Tensor, pixels: int) -> torch.Tensor:
    """focal = pixels / (2 tan(fov/2)) (reference: nerf/provider.py:212)."""
    return pixels / (2.0 * torch.tan(torch.deg2rad(fov_deg) / 2.0))


def sample_train_batch(cfg, *, generator: Optional[torch.Generator] = None,
                       device: Optional[torch.device] = None,
                       B: Optional[int] = None,
                       draws: Optional[Dict[str, torch.Tensor]] = None):
    """One training batch of cameras + rays (reference: NeRFDataset(train),
    nerf/provider.py:202-236).

    draws (optional): radius, u_sphere, u_orbit, u_select, and with
    cfg.jitter_pose center_u, target_n, up_n (see rand_poses), and fov []
    in degrees. Returns rays_o/rays_d [B, h*w, 3] and dir [B]."""
    B = B or cfg.batch_size
    device = resolve_device(device)
    draws = draws or {}
    poses, dirs, _, _ = rand_poses(
        B, radius_range=cfg.radius_range, angle_overhead=cfg.angle_overhead,
        angle_front=cfg.angle_front, uniform_sphere_rate=cfg.uniform_sphere_rate,
        jitter=cfg.jitter_pose, generator=generator, device=device,
        **{k: draws.get(k) for k in POSE_DRAWS})
    fov = draws.get("fov")
    if fov is None:
        fov = _uniform((), generator, device, *cfg.fovy_range)
    focal = fov_to_focal(torch.as_tensor(fov, dtype=torch.float32,
                                         device=device), cfg.h)
    rays_o, rays_d = get_rays(poses, (focal, focal, cfg.w / 2.0, cfg.h / 2.0),
                              cfg.h, cfg.w)
    return {"rays_o": rays_o, "rays_d": rays_d, "dir": dirs,
            "H": cfg.h, "W": cfg.w}


def sample_test_batch(index, size: int, cfg, H: Optional[int] = None,
                      W: Optional[int] = None,
                      device: Optional[torch.device] = None):
    """Deterministic test/val batch: frame index of size on a circle orbit at
    theta = 60 degrees, radius 1.2 * r_max, mean fov (reference:
    nerf/provider.py:214-222). Returns rays_o/rays_d [B, H*W, 3], dir [B]."""
    H = H or cfg.H
    W = W or cfg.W
    device = resolve_device(device)
    index = torch.atleast_1d(torch.as_tensor(index, device=device))
    phi_deg = index.float() / size * 360.0
    poses, dirs = circle_poses(phi_deg, radius=cfg.radius_range[1] * 1.2,
                               theta_deg=60.0,
                               angle_overhead=cfg.angle_overhead,
                               angle_front=cfg.angle_front, device=device)
    fov = (cfg.fovy_range[0] + cfg.fovy_range[1]) / 2.0
    focal = fov_to_focal(torch.tensor(fov, device=device), H)
    rays_o, rays_d = get_rays(poses, (focal, focal, W / 2.0, H / 2.0), H, W)
    return {"rays_o": rays_o, "rays_d": rays_d, "dir": dirs, "H": H, "W": W}
