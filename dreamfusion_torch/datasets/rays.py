"""Per-view ray generation and training-ray gathering (numpy; the port's
copy of dreamfusion_tpu/datasets/rays.py).

Rebuilds datasets/nerf/utils.py (get_rays / get_rays_omni / ndc_rays /
get_rays_of_a_view) and the ray-gathering samplers in
datasets/nerf/nerf_dataset.py:140-284: 'random'/'flatten' (all rays),
'in_alpha_channel'/'stanford' (alpha-masked), 'in_maskcache' (prefiltered by
a coarse model's free-space mask).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def get_rays_np(H: int, W: int, K: np.ndarray, c2w: np.ndarray, *,
                inverse_y: bool = False, flip_x: bool = False,
                flip_y: bool = False, mode: str = "center",
                rng: Optional[np.random.RandomState] = None):
    """Pinhole rays for one view (reference: datasets/nerf/utils.py:43-84)."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    if mode == "center":
        i, j = i + 0.5, j + 0.5
    elif mode == "random":
        rng = rng or np.random
        i = i + rng.rand(H, W).astype(np.float32)
        j = j + rng.rand(H, W).astype(np.float32)
    elif mode != "lefttop":
        raise NotImplementedError(mode)
    if flip_x:
        i = i[:, ::-1]
    if flip_y:
        j = j[::-1, :]
    if inverse_y:
        dirs = np.stack([(i - K[0, 2]) / K[0, 0],
                         (j - K[1, 2]) / K[1, 1], np.ones_like(i)], -1)
    else:
        dirs = np.stack([(i - K[0, 2]) / K[0, 0],
                         -(j - K[1, 2]) / K[1, 1], -np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def get_rays_omni_np(H: int, W: int, c2w: np.ndarray, *, flip_x: bool = False,
                     flip_y: bool = False, mode: str = "center"):
    """Panoramic/omnidirectional rays (reference: datasets/nerf/utils.py:86-131):
    equirectangular theta over width, phi over height."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    if mode == "center":
        i, j = i + 0.5, j + 0.5
    if flip_x:
        i = i[:, ::-1]
    if flip_y:
        j = j[::-1, :]
    theta = (i / W) * 2.0 * np.pi - np.pi
    phi = (0.5 - j / H) * np.pi
    dirs = np.stack([np.cos(phi) * np.sin(theta), -np.sin(phi),
                     -np.cos(phi) * np.cos(theta)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def ndc_rays_np(H, W, focal, near, rays_o, rays_d):
    """Shift to NDC space (reference: datasets/nerf/utils.py:134-151,
    the standard NeRF llff transform)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2]
                                       - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2]
                                       - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return (np.stack([o0, o1, o2], -1).astype(np.float32),
            np.stack([d0, d1, d2], -1).astype(np.float32))


def get_rays_of_a_view(H, W, K, c2w, *, ndc: bool = False,
                       inverse_y: bool = False, flip_x: bool = False,
                       flip_y: bool = False, mode: str = "center",
                       img_type: str = "plane", **_):
    if img_type == "panoramic":
        rays_o, rays_d = get_rays_omni_np(H, W, c2w, flip_x=flip_x,
                                          flip_y=flip_y, mode=mode)
    else:
        rays_o, rays_d = get_rays_np(H, W, K, c2w, inverse_y=inverse_y,
                                     flip_x=flip_x, flip_y=flip_y, mode=mode)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    if ndc:
        rays_o, rays_d = ndc_rays_np(H, W, K[0][0], 1.0, rays_o, rays_d)
    return rays_o, rays_d, viewdirs


def gather_training_rays(data_dict: Dict, cfg_data: Dict, split: str = "i_train",
                         ray_sampler: str = "random",
                         mask_fn=None) -> Tuple[np.ndarray, ...]:
    """Flatten all rays of a split into [N, ...] arrays
    (reference: nerf_dataset.py:86-139 + get_training_rays* variants).

    ray_sampler:
      'random'/'flatten'   — every pixel of every view
      'stanford'/'in_alpha_channel' — keep only pixels with alpha > 0
      'in_maskcache'       — additionally drop rays whose full segment lies
                             in known free space (mask_fn: pts -> bool)
      'random_depth'       — like 'random' but the target keeps the depth
                             channel appended by the caller (load_depths
                             mode, nerf_dataset.py:89-96)
    Returns (rgb, rays_o, rays_d, viewdirs, imsz). When data_dict carries
    'depths' and ray_sampler is 'random_depth', the depth is concatenated
    as a 4th target channel.
    """
    HW = np.asarray(data_dict["HW"])
    Ks = np.asarray(data_dict["Ks"])
    poses = np.asarray(data_dict["poses"])
    indexes = np.asarray(data_dict[split])
    images = data_dict["images"]

    depths = data_dict.get("depths")
    rgb_all, ro_all, rd_all, vd_all, imsz = [], [], [], [], []
    for idx in indexes:
        H, W = int(HW[idx][0]), int(HW[idx][1])
        img = np.asarray(images[idx], dtype=np.float32)
        if ray_sampler == "random_depth" and depths is not None:
            img = np.concatenate(
                [img[..., :3], np.asarray(depths[idx], np.float32)[..., None]],
                axis=-1)
        rays_o, rays_d, viewdirs = get_rays_of_a_view(
            H, W, Ks[idx], poses[idx], **{k: v for k, v in cfg_data.items()
                                          if k in ("ndc", "inverse_y", "flip_x",
                                                   "flip_y", "mode", "img_type")})
        rgb = img.reshape(-1, img.shape[-1])
        ro = rays_o.reshape(-1, 3)
        rd = rays_d.reshape(-1, 3)
        vd = viewdirs.reshape(-1, 3)
        if ray_sampler in ("stanford", "in_alpha_channel") and rgb.shape[-1] == 4:
            keep = rgb[:, 3] > 0
            rgb, ro, rd, vd = rgb[keep][:, :3], ro[keep], rd[keep], vd[keep]
        if ray_sampler == "in_maskcache" and mask_fn is not None:
            keep = np.asarray(mask_fn(ro, rd))
            rgb, ro, rd, vd = rgb[keep], ro[keep], rd[keep], vd[keep]
        keep_ch = 4 if ray_sampler == "random_depth" else 3
        rgb_all.append(rgb[..., :keep_ch])
        ro_all.append(ro)
        rd_all.append(rd)
        vd_all.append(vd)
        imsz.append(len(rgb))
    return (np.concatenate(rgb_all), np.concatenate(ro_all),
            np.concatenate(rd_all), np.concatenate(vd_all), np.array(imsz))


class ErrorMapRaySampler:
    """Error-map-weighted ray sampler for image-supervised training.

    Rebuilds the reference's error-map subsampling (nerf/utils.py:73-83):
    each view keeps a 128x128 coarse error map; rays are importance-sampled
    from it (ops/misc.sample_rays_with_error_map) and the map is EMA-updated
    from the per-ray loss of the step that consumed them
    (torch-ngp heritage: error_map = 0.1*old + 0.9*err). Iterating yields
    (rays_d, rays_o, viewdirs, rgb) batches like the plain loaders; a
    trainer that reports per-ray errors calls update_last() after its step.

    The view is drawn from numpy's RandomState(seed), as in the JAX
    package; the cells and their jitter from `generator` (torch), or from
    ``draw_fn(error_map [128, 128]) -> (cells [N], jitter [2, N])`` when one
    is given (the parity tests inject the JAX package's draws there).
    """

    def __init__(self, data_dict: Dict, cfg_data: Dict, batch_size: int,
                 split: str = "i_train", seed: int = 0, res: int = 128,
                 generator=None, draw_fn=None):
        import torch

        HW = np.asarray(data_dict["HW"])
        Ks = np.asarray(data_dict["Ks"])
        poses = np.asarray(data_dict["poses"])
        self.batch_size = batch_size
        self.res = res
        self.views = []
        for idx in np.asarray(data_dict[split]):
            H, W = int(HW[idx][0]), int(HW[idx][1])
            ro, rd, vd = get_rays_of_a_view(
                H, W, Ks[idx], poses[idx],
                **{k: v for k, v in cfg_data.items()
                   if k in ("ndc", "inverse_y", "flip_x", "flip_y", "mode",
                            "img_type")})
            img = np.asarray(data_dict["images"][idx], np.float32)[..., :3]
            self.views.append(dict(
                H=H, W=W, rgb=img.reshape(-1, 3),
                ro=np.asarray(ro).reshape(-1, 3),
                rd=np.asarray(rd).reshape(-1, 3),
                vd=np.asarray(vd).reshape(-1, 3)))
        self.error_map = np.ones((len(self.views), res * res), np.float32)
        self._gen = (generator if generator is not None
                     else torch.Generator().manual_seed(seed))
        self._draw_fn = draw_fn
        self._rng = np.random.RandomState(seed)
        self._last = None

    def __iter__(self):
        import torch

        from dreamfusion_torch.ops.misc import sample_rays_with_error_map

        while True:
            v = int(self._rng.randint(len(self.views)))
            view = self.views[v]
            em = torch.from_numpy(self.error_map[v]).reshape(self.res,
                                                             self.res)
            cells = jitter = None
            if self._draw_fn is not None:
                cells, jitter = self._draw_fn(em)
            inds, inds_coarse = sample_rays_with_error_map(
                em, self.batch_size, view["H"], view["W"], cells=cells,
                jitter=jitter, generator=self._gen)
            inds = inds.numpy()
            self._last = (v, inds_coarse.numpy())
            yield (view["rd"][inds], view["ro"][inds], view["vd"][inds],
                   view["rgb"][inds])

    def update_last(self, per_ray_err) -> None:
        """EMA-update the coarse error map from the last batch's per-ray
        squared error (nerf/utils.py error-map update)."""
        if self._last is None:
            return
        v, inds_coarse = self._last
        err = np.asarray(per_ray_err, np.float32)
        em = self.error_map[v]
        em[inds_coarse] = 0.1 * em[inds_coarse] + 0.9 * err
        self._last = None
