"""Batched full-image rendering of DVGO fields and orbit-video tooling
(counterpart of dreamfusion_tpu/training/image_renderer.py; reference
frameworks/nerf/renderers/image_renderer.py and
frameworks/nerf/interface/render_views.py): look-at and spherical pose
builders, ``ImageRenderer`` (chunked per-view rendering), orbit frames,
``snap_shot`` and the CLI exporter:

    python -m dreamfusion_torch.training.image_renderer scene.dvgo \\
        --out round_views.gif --num_imgs 16 --H 256 --W 256

The CLI writes a GIF when imageio is installed, and otherwise one PNG per
frame (``<out stem>_NNNN.png``, by the trainer's ``write_png``), saying so.
It renders on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List

import numpy as np
import torch


def look_at_to_c2w(C: np.ndarray, p: np.ndarray,
                   up=(0.1, 0.1, 1.0)) -> np.ndarray:
    """cam2world looking from C to p with +z-ish up
    (render_views.py:57-69)."""
    up = np.asarray(up, np.float64)
    up = up / np.linalg.norm(up)
    L = np.asarray(p, np.float64) - np.asarray(C, np.float64)
    s = np.cross(L, up)
    u = np.cross(s, L)
    R = np.stack([s, u, -L])
    R = (R / np.linalg.norm(R, axis=1, keepdims=True)).T
    ret = np.zeros((4, 4), np.float32)
    ret[:3, :3] = R
    ret[:3, 3] = C
    ret[3, 3] = 1.0
    return ret


def cord_spherical(radius: float, theta_deg: float,
                   phi_deg: float) -> np.ndarray:
    """Spherical coords with +z pole (render_views.py:72-77)."""
    t, p = math.radians(theta_deg), math.radians(phi_deg)
    return radius * np.array([math.sin(t) * math.cos(p),
                              math.sin(t) * math.sin(p), math.cos(t)],
                             np.float32)


class ImageRenderer:
    """Render full views of a DVGO field in ray chunks of `batch_size`
    (image_renderer.py:4-61), on the field's device, without gradients."""

    def __init__(self, field, *, near: float, far: float,
                 bg=(1.0, 1.0, 1.0), batch_size: int = 4096,
                 key: str = "rgb_marched", **ray_kwargs):
        self.field = field
        self.near, self.far = near, far
        self.device = field.density.device
        self.bg = torch.as_tensor(bg, dtype=torch.float32, device=self.device)
        self.bs = batch_size
        self.key = key
        self.ray_kwargs = ray_kwargs
        self.n_samples = field.n_render_samples(far)

    @torch.no_grad()
    def renderView(self, H: int, W: int, K: np.ndarray,
                   render_pose: np.ndarray) -> np.ndarray:
        from dreamfusion_torch.datasets.rays import get_rays_of_a_view

        ro, rd, vd = get_rays_of_a_view(H, W, np.asarray(K),
                                        np.asarray(render_pose),
                                        **self.ray_kwargs)
        flat = [torch.as_tensor(np.ascontiguousarray(a).reshape(-1, 3),
                                device=self.device) for a in (ro, rd, vd)]
        outs = []
        for s in range(0, flat[0].shape[0], self.bs):
            o, d, v = (a[s:s + self.bs] for a in flat)
            outs.append(self.field.render(
                o, d, v, near=self.near, far=self.far, bg=self.bg,
                n_samples=self.n_samples)[self.key])
        img = torch.cat(outs).float().cpu().numpy()
        return img.reshape(H, W, -1)

    def renderViews(self, HW_list, K_list, render_poses) -> List[np.ndarray]:
        return [self.renderView(H, W, K, pose)
                for (H, W), K, pose in zip(HW_list, K_list, render_poses)]


def _intrinsics(H: int, W: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                    np.float32)


def render_round_views(renderer: ImageRenderer, H: int, W: int, focal: float,
                       num_imgs: int = 16, center=(0.0, 0.0, 0.0),
                       dis: float = 1.0, theta_deg: float = 60.0
                       ) -> List[np.ndarray]:
    """Orbit around `center` at distance `dis` (render_views.py:80-97)."""
    K = _intrinsics(H, W, focal)
    frames = []
    for i in range(num_imgs):
        C = np.asarray(center) + cord_spherical(dis, theta_deg,
                                                360.0 * i / num_imgs)
        frames.append(renderer.renderView(
            H, W, K, look_at_to_c2w(C, np.asarray(center))))
    return frames


def snap_shot(renderer: ImageRenderer, H: int, W: int, focal: float,
              position, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Single look-at frame (render_views.py:99-150)."""
    return renderer.renderView(H, W, _intrinsics(H, W, focal),
                               look_at_to_c2w(np.asarray(position),
                                              np.asarray(target)))


def load_dvgo_field(path: str, device=None):
    """A .dvgo checkpoint -> models/dvgo.DVGOField holding its grids and
    colour MLP, on `device` (default the GPU). The field takes the file's
    alpha_init, stepsize and voxel_size_ratio; the JAX package's CLI builds
    its field with the defaults (alpha_init 1e-6), which misplaces the
    density of a fine model trained at alpha_init 1e-2."""
    from dreamfusion_torch.device import resolve_device
    from dreamfusion_torch.models.kailu import (_read_dvgo_ckpt, _dvgo_meta,
                                                load_dvgo_state)
    from dreamfusion_torch.models.zoo import get_field

    state, hparams = _read_dvgo_ckpt(path)
    meta = _dvgo_meta(state, hparams)
    field = get_field("dvgo_fine", world_size=meta["world_size"],
                      k0_dim=meta["k0_dim"],
                      rgbnet_name=meta.get("rgbnet_name", "resmlp"),
                      rgbnet_width=meta.get("rgbnet_width", 128),
                      rgbnet_depth=meta.get("rgbnet_depth", 3),
                      posbase_pe=meta.get("posbase_pe", 5),
                      viewbase_pe=meta.get("viewbase_pe", 4),
                      xyz_min=meta["xyz_min"], xyz_max=meta["xyz_max"],
                      alpha_init=meta.get("alpha_init", 1e-6),
                      stepsize=meta.get("stepsize", 0.5),
                      voxel_size_ratio=meta["voxel_size_ratio"])
    load_dvgo_state(field, state)
    return field.to(resolve_device(device)).eval()


def main(argv=None):
    """CLI video export from a .dvgo checkpoint (render_views.py:158-178)."""
    ap = argparse.ArgumentParser("render_views")
    ap.add_argument("checkpoint", help=".dvgo checkpoint path")
    ap.add_argument("--out", default="round_views.gif")
    ap.add_argument("--num_imgs", type=int, default=16)
    ap.add_argument("--H", type=int, default=256)
    ap.add_argument("--W", type=int, default=256)
    ap.add_argument("--focal", type=float, default=300.0)
    ap.add_argument("--dis", type=float, default=2.0)
    ap.add_argument("--near", type=float, default=0.1)
    ap.add_argument("--far", type=float, default=6.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    field = load_dvgo_field(args.checkpoint, args.device)
    r = ImageRenderer(field, near=args.near, far=args.far)
    frames = [(np.clip(f, 0, 1) * 255).astype(np.uint8)
              for f in render_round_views(r, args.H, args.W, args.focal,
                                          num_imgs=args.num_imgs,
                                          dis=args.dis)]
    try:
        import imageio
    except ImportError:
        from dreamfusion_torch.training.trainer import write_png

        stem = os.path.splitext(args.out)[0]
        paths = [f"{stem}_{i:04d}.png" for i in range(len(frames))]
        for p, f in zip(paths, frames):
            write_png(p, f)
        print(f"imageio is not installed: wrote {len(paths)} PNG frames "
              f"{paths[0]} .. {paths[-1]} in place of {args.out}")
        return paths
    imageio.mimwrite(args.out, frames, fps=10, loop=0)
    print(f"wrote {args.out}")
    return [args.out]


if __name__ == "__main__":
    main()
