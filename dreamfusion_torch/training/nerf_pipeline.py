"""The two-stage DVGO pipeline: coarse -> fine -> test PSNR -> .dvgo
(counterpart of dreamfusion_tpu/training/nerf_pipeline.py; reference
frameworks/nerf/train_nerf_models.py:39-173):

1. load the dataset, compute the coarse box from the camera frusta;
2. train DVGO_Coarse;
3. compute the fine box from the coarse geometry; build the MaskCache;
4. train DVGO_Fine;
5. render the test split's rays, report their PSNR, save the .dvgo
   checkpoint (the lightning layout that models/kailu.py and the
   reference read).

    out = train_nerf_models({"cfg_data": {"dataset_type": "blender",
                                          "datadir": "<scene>"},
                             "save_name": "scene.dvgo"})
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from dreamfusion_torch.datasets import load_data
from dreamfusion_torch.datasets.provider import ArrayDataset, DataLoaderLite
from dreamfusion_torch.datasets.rays import gather_training_rays
from dreamfusion_torch.models.dvgo import DVGOField, MaskCacheData
from dreamfusion_torch.training.dvgo_trainer import (
    DVGOStageConfig, DVGOTrainer, compute_bbox_by_cam_frustrm,
    compute_bbox_by_coarse_geo, world_size_for)

DEFAULTS = dict(
    coarse=dict(num_voxels=1024000, alpha_init=1e-6, stepsize=0.5,
                rgbnet=None, k0_dim=3),
    fine=dict(num_voxels=160 ** 3, alpha_init=1e-2, stepsize=0.5,
              rgbnet="resmlp", k0_dim=12, rgbnet_width=128, rgbnet_depth=3,
              posbase_pe=5, viewbase_pe=4, mask_cache_thres=1e-3,
              bbox_thres=1e-3),
)


def _loader(data_dict, cfg_data, split, sampler, batch_size, mask_fn=None,
            cap=None):
    rgb, ro, rd, vd, _ = gather_training_rays(
        data_dict, cfg_data, split=split, ray_sampler=sampler, mask_fn=mask_fn)
    ds = ArrayDataset(rd, ro, vd, rgb)
    if cap and len(ds) > cap:
        keep = np.random.RandomState(0).permutation(len(ds))[:cap]
        ds = ds.select(keep)
    return DataLoaderLite(ds, batch_size, shuffle=(split == "i_train"))


def train_nerf_models(params: Dict[str, Any], log_fn=print,
                      device=None) -> Dict[str, Any]:
    """params: {'cfg_data': {...load_data args...}, 'cfg_data_dict': {...ray
    generation options...}, 'coarse_model': {...}, 'coarse_train':
    DVGOStageConfig keywords, 'fine_model': {...}, 'fine_train': {...},
    'save_name': path, 'log_every': iterations between log lines} (or
    'data_dict' in place of 'cfg_data'). Trains on
    `device` (default the GPU). Returns {'test_psnr', 'save_path',
    'fine_trainer', 'coarse_trainer', 'mask_cache'}."""
    cfg_data = params["cfg_data"]
    cfg_ray = params.get("cfg_data_dict", {})
    data = params.get("data_dict") or load_data(cfg_data)
    bkgd = tuple(params.get("bkgd", (1.0, 1.0, 1.0)))
    batch_size = params.get("batch_size", 8192)
    sampler = params.get("ray_sampler", "random")

    # -- coarse stage (train_nerf_models.py:67-92) ------------------------------
    cm = {**DEFAULTS["coarse"], **params.get("coarse_model", {})}
    ct = DVGOStageConfig(**params.get("coarse_train", {}))
    xyz_min, xyz_max = compute_bbox_by_cam_frustrm(data, cfg_ray)
    ws = world_size_for(xyz_min, xyz_max, cm["num_voxels"])
    coarse = DVGOField(world_size=ws, k0_dim=cm["k0_dim"],
                       rgbnet_name=cm["rgbnet"], xyz_min=xyz_min,
                       xyz_max=xyz_max, alpha_init=cm["alpha_init"],
                       stepsize=cm["stepsize"])
    log_fn(f"[coarse] bbox {xyz_min} ~ {xyz_max}, world_size {ws}")
    tr_c = DVGOTrainer(coarse, ct, near=data["near"], far=data["far"],
                       bg=bkgd, device=device)
    train_dl = _loader(data, cfg_ray, "i_train", sampler, batch_size)
    log_every = params.get("log_every", 500)
    tr_c.fit(train_dl, num_voxels_base=cm["num_voxels"], log_every=log_every,
             log_fn=lambda i, l: log_fn(f"[coarse {i}] {l}"))

    # -- fine stage (train_nerf_models.py:98-126) --------------------------------
    fm = {**DEFAULTS["fine"], **params.get("fine_model", {})}
    ft = DVGOStageConfig(**params.get("fine_train", {}))
    xyz_min_f, xyz_max_f = compute_bbox_by_coarse_geo(tr_c.field,
                                                      fm["bbox_thres"])
    ws_f = world_size_for(xyz_min_f, xyz_max_f, fm["num_voxels"])
    fine = DVGOField(world_size=ws_f, k0_dim=fm["k0_dim"],
                     rgbnet_name=fm["rgbnet"], rgbnet_width=fm["rgbnet_width"],
                     rgbnet_depth=fm["rgbnet_depth"],
                     posbase_pe=fm["posbase_pe"], viewbase_pe=fm["viewbase_pe"],
                     xyz_min=xyz_min_f, xyz_max=xyz_max_f,
                     alpha_init=fm["alpha_init"], stepsize=fm["stepsize"])
    log_fn(f"[fine] bbox {xyz_min_f} ~ {xyz_max_f}, world_size {ws_f}")

    mask_cache = MaskCacheData(
        coarse.xyz_min, coarse.xyz_max, tr_c.field.density.detach(),
        coarse.act_shift, coarse.voxel_size_ratio, fm["mask_cache_thres"])

    tr_f = DVGOTrainer(fine, ft, near=data["near"], far=data["far"],
                       bg=bkgd, device=device)
    train_dl = _loader(data, cfg_ray, "i_train", sampler, batch_size)
    tr_f.fit(train_dl, num_voxels_base=fm["num_voxels"], log_every=log_every,
             log_fn=lambda i, l: log_fn(f"[fine {i}] {l}"))

    # -- test (train_nerf_models.py:134-171) ----------------------------------------
    test_dl = _loader(data, cfg_ray, "i_test", "random", batch_size, cap=819200)
    test_psnr = tr_f.evaluate(test_dl, max_batches=params.get("max_test_batches"))
    log_fn(f"[test] psnr {test_psnr:.2f}")

    save_path = params.get("save_name")
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        tr_f.save_dvgo(save_path)
        log_fn(f"[save] {save_path}")

    return {"test_psnr": test_psnr, "save_path": save_path,
            "fine_trainer": tr_f, "coarse_trainer": tr_c,
            "mask_cache": mask_cache}
