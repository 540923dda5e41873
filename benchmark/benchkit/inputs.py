"""Inputs made from the run's seed, on the device, in a few large calls;
the program and the reference receive the same ones.

- ``seed_streams``: independent generators for each kind of input, from
  one seed of any size (a seed above 2^63 is folded);
- ``asset_generator``: the configuration's asset, from its own seed;
- ``fill_lecun``: the weights of a module's Linear and Conv2d layers from
  one flat normal draw in the type they are stored in, scaled by
  1/sqrt(fan_in); biases 0, norm scales 1, norm shifts 0;
- ``sds_feed``: the draws of the checked SDS steps (cameras, shading,
  background, light, march jitter, VAE posterior noise, timestep, latent
  noise);
- ``text_embeddings``: stand-ins for CLIP's per-direction prompts;
- ``ball_rays``: the ball scene in the Blender layout, analytically: ray
  batches and their targets for DVGO pretraining."""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn

STREAMS = ("field", "sd", "text", "feed", "grid")
_T0 = time.perf_counter()


def note(what: str) -> None:
    """A set-up stage's end on standard error, in seconds since import,
    with the card's allocation peak so far."""
    peak = ""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        peak = f"  (peak {torch.cuda.max_memory_allocated() / 2 ** 30:.4f} GiB)"
    print(f"[setup] {time.perf_counter() - _T0:8.2f} s  {what}{peak}",
          file=sys.stderr, flush=True)


def fold(seed: int) -> int:
    """A seed of any size as a generator's seed."""
    return int(seed) % (2 ** 63 - 1)


def seed_streams(seed: int, device) -> Dict[str, torch.Generator]:
    base = fold(seed)
    out = {}
    for i, name in enumerate(STREAMS):
        g = torch.Generator(device=device)
        g.manual_seed((base * 1_000_003 + 7919 * (i + 1)) % (2 ** 63 - 1))
        out[name] = g
    return out


def asset_generator(config: Dict, device) -> torch.Generator:
    """The generator of the configuration's asset (the field that SDS
    trains, or the orbit renders): its ``asset_seed``, the same for every
    run, so that the asset's occupancy, and with it the work a step or a
    frame does, is the same whatever the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(config["asset_seed"]))
    return g


def _weighted_layers(module: nn.Module) -> List[nn.Module]:
    return [m for m in module.modules()
            if isinstance(m, (nn.Linear, nn.Conv2d))]


@torch.no_grad()
def fill_lecun(module: nn.Module, generator: torch.Generator,
               dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Weights N(0, 1/fan_in), drawn as one flat tensor of `dtype` and
    scaled in it, then copied into the module's parameters (whatever
    their type); biases 0; every other parameter (norm scales and shifts)
    1 for a `weight`, 0 for a `bias`. The same seed gives the same values
    to a bf16 module and to an f32 one."""
    layers = _weighted_layers(module)
    total = sum(m.weight.numel() for m in layers)
    dev = next(module.parameters()).device
    flat = torch.randn(total, generator=generator, device=dev, dtype=dtype)
    off = 0
    for m in layers:
        n = m.weight.numel()
        fan_in = m.weight[0].numel()
        w = flat[off:off + n].view(m.weight.shape) * (1.0 / math.sqrt(fan_in))
        m.weight.copy_(w)
        off += n
    for name, p in module.named_parameters():
        if any(p is m.weight for m in layers):
            continue
        if name.endswith("bias"):
            p.zero_()
        elif name.endswith("weight"):
            p.fill_(1.0)
    return module


def text_embeddings(n_dirs: int, dim: int, generator: torch.Generator,
                    device) -> torch.Tensor:
    """[n_dirs, 2, 77, dim] (uncond, cond) standard normals."""
    return torch.randn(n_dirs, 2, 77, dim, generator=generator, device=device)


def sds_feed(cfg, n: int, latent: int, t_range, generator: torch.Generator,
             device) -> Dict[str, torch.Tensor]:
    """n steps of SDS draws, stacked; ``feed_step`` picks one. Cameras
    (radius, u_sphere, u_orbit, u_select, fov), shade_u, bg, light_n,
    perturb_u, vae_eps, t, noise."""
    B, N = cfg.batch_size, cfg.h * cfg.w
    g, dev = generator, device
    lo, hi = cfg.radius_range
    flo, fhi = cfg.fovy_range

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    return {
        "radius": lo + (hi - lo) * u(n, B),
        "u_sphere": u(n, B, 3),
        "u_orbit": u(n, B, 2),
        "u_select": u(n, B),
        "fov": flo + (fhi - flo) * u(n),
        "shade_u": u(n).cpu(),
        "bg": u(n, B * N, 3),
        "light_n": torch.randn(n, 3, generator=g, device=dev),
        "perturb_u": u(n, B * N),
        "vae_eps": torch.randn(n, B, latent, latent, 4, generator=g,
                               device=dev),
        "t": torch.randint(t_range[0], t_range[1] + 1, (n, B),
                           generator=g, device=dev),
        "noise": torch.randn(n, B, latent, latent, 4, generator=g, device=dev),
    }


def feed_step(feed: Dict[str, torch.Tensor], i: int) -> Dict:
    """The draws of step i; shade_u as a host float."""
    d = {k: v[i] for k, v in feed.items()}
    d["shade_u"] = float(d["shade_u"])
    return d


# -- the ball scene (Blender layout) ------------------------------------------------

BLENDER_ANGLE_X = 0.6911112070083618      # nerf_synthetic's camera_angle_x


def _pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """NeRF's pose_spherical (load_blender.py): c2w [4, 4]."""
    t = np.eye(4)
    t[2, 3] = radius
    c, s = math.cos(phi / 180 * math.pi), math.sin(phi / 180 * math.pi)
    rot_phi = np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                        [0, 0, 0, 1]], dtype=np.float64)
    c, s = math.cos(theta / 180 * math.pi), math.sin(theta / 180 * math.pi)
    rot_theta = np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0],
                          [0, 0, 0, 1]], dtype=np.float64)
    c2w = rot_theta @ rot_phi @ t
    return np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], dtype=np.float64) @ c2w


def ball_rays(scene: Dict, n_batches: int, batch: int, seed: int):
    """n_batches batches of `batch` training rays of the ball scene, drawn
    from the seed: (rays_d, rays_o, viewdirs, target) float32 numpy
    arrays each, the order DVGO's ray loader yields. The scene is the
    configuration's, the same for every seed: scene["views"] views on the
    upper hemisphere at the scene's camera radius, placed by
    scene["pose_seed"], pixels of scene["size"]^2 pinhole images with
    nerf_synthetic's field of view (OpenGL camera axes: y up, looking along
    -z); the ball of radius scene["radius"] at the origin coloured 0.5 +
    0.5 n by its unit normal on a white background. The seed draws which
    view and pixel each ray of each batch is."""
    poses = np.random.RandomState(scene["pose_seed"])
    size, n_views = scene["size"], scene["views"]
    focal = 0.5 * size / math.tan(0.5 * BLENDER_ANGLE_X)
    c2ws = np.stack([_pose_spherical(poses.uniform(-180, 180),
                                     poses.uniform(-80, -5),
                                     scene["camera_radius"])
                     for _ in range(n_views)])
    rng = np.random.RandomState(int(seed) % (2 ** 32))
    total = n_batches * batch
    view = rng.randint(0, n_views, total)
    px = rng.randint(0, size, total) + 0.5
    py = rng.randint(0, size, total) + 0.5
    dirs = np.stack([(px - 0.5 * size) / focal, -(py - 0.5 * size) / focal,
                     -np.ones(total)], -1)
    rot = c2ws[view, :3, :3]
    rays_d = np.einsum("nij,nj->ni", rot, dirs)
    rays_o = c2ws[view, :3, 3]
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    b = (rays_o * viewdirs).sum(-1)
    disc = b * b - ((rays_o * rays_o).sum(-1) - scene["radius"] ** 2)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    normal = (rays_o + t[:, None] * viewdirs) / scene["radius"]
    target = np.where(hit[:, None], 0.5 + 0.5 * normal, 1.0)
    out = []
    for i in range(n_batches):
        s = slice(i * batch, (i + 1) * batch)
        out.append(tuple(a[s].astype(np.float32)
                         for a in (rays_d, rays_o, viewdirs, target)))
    return out


def write_dvgo(path: str, spec: Dict, generator: torch.Generator,
               device) -> None:
    """A .dvgo checkpoint (torch-lightning layout: state_dict and
    hyper_parameters) of a DVGO fine model at spec's widths, from the seed:
    density a noisy ball in the +-1 box, clamp((radius - r) * slope, -10,
    30) plus noise of std `noise` (with DVGO's act_shift the surface lies
    inside the ramp); k0 standard normal; a width x depth residual colour
    MLP on k0 and the PE 5 / 4 encodings, N(0, 1/fan_in), biases 0."""
    world, k0_dim, width = spec["world"], spec["k0_dim"], spec["rgbnet_width"]
    g, dev = generator, device
    lin = torch.linspace(-1.0, 1.0, world, device=dev)
    X, Y, Z = torch.meshgrid(lin, lin, lin, indexing="ij")
    r = torch.sqrt(X * X + Y * Y + Z * Z)
    density = torch.clamp((spec["radius"] - r) * spec["slope"], -10.0, 30.0) \
        + spec["noise"] * torch.randn(world, world, world, generator=g,
                                      device=dev)
    in_dim = k0_dim + (3 + 3 * spec["posbase_pe"] * 2) \
        + (3 + 3 * spec["viewbase_pe"] * 2)

    def lin_w(o, i):
        return torch.randn(o, i, generator=g, device=dev) / math.sqrt(i)

    state = {
        "density": density[None, None],
        "k0": torch.randn(1, k0_dim, world, world, world, generator=g,
                          device=dev),
        "xyz_min": torch.tensor([-1.0, -1.0, -1.0]),
        "xyz_max": torch.tensor([1.0, 1.0, 1.0]),
        "voxel_size_ratio": torch.tensor(1.0),
        "rgbnet.net.0.weight": lin_w(width, in_dim),
        "rgbnet.net.0.bias": torch.zeros(width),
    }
    n_res = spec["rgbnet_depth"] - 2
    for i in range(n_res):
        state[f"rgbnet.net.{2 + i}.net.weight"] = lin_w(width, width)
        state[f"rgbnet.net.{2 + i}.net.bias"] = torch.zeros(width)
    state[f"rgbnet.net.{2 + n_res}.weight"] = lin_w(3, width)
    state[f"rgbnet.net.{2 + n_res}.bias"] = torch.zeros(3)
    state = {k: v.cpu().contiguous() for k, v in state.items()}
    torch.save({"state_dict": state, "hyper_parameters": {"params": {"cfg": {
        "fine_model_and_render": {
            "rgbnet": "resmlp", "rgbnet_width": width,
            "rgbnet_depth": spec["rgbnet_depth"],
            "posbase_pe": spec["posbase_pe"],
            "viewbase_pe": spec["viewbase_pe"],
            "alpha_init": spec["alpha_init"],
            "stepsize": spec["stepsize"]}}}}}, path)
