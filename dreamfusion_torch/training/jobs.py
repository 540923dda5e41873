"""Backend-driven training entry and experiment templates (counterpart of
dreamfusion_tpu/training/jobs.py; reference frameworks/
train_single_model.py:36-79 and frameworks/nerf/jobs_for_new_nerf.py):

- ``train_model(params)``: the job-side entry: seed, run the DVGO
  pipeline (training/nerf_pipeline.py) with torch's deterministic
  algorithms when params["deterministic"] (the default), log the test PSNR
  and the model weight hash (the determinism probe), save the .dvgo
  through the backend. It trains on the GPU unless params["device"] is
  "cpu";
- ``params_for_nerf``: the experiment template, and ``submit_nerf_jobs``
  its random sweeps.

    from dreamfusion_torch.utils import backend
    backend.submit("dreamfusion_torch.training.jobs:train_model",
                   params_for_nerf("/data/nerf_synthetic/ficus",
                                   save_name="ficus.dvgo"))
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def train_model(params: Dict[str, Any]):
    """Job-side entry (launched by backend.submit('dreamfusion_torch.'
    'training.jobs:train_model', params)); returns the test PSNR."""
    from dreamfusion_torch.training.nerf_pipeline import train_nerf_models
    from dreamfusion_torch.utils import backend
    from dreamfusion_torch.utils.tools import get_model_weight_hash, parse_params

    params = parse_params(params)
    seed = params.get("seed", 0)
    np.random.seed(seed)
    torch.manual_seed(seed)
    backend.log_params(params)

    # params["deterministic"] (parse_params' default True): torch's
    # deterministic algorithms for the run, so that the same seed gives the
    # same weights (the CPU's index_put accumulation is otherwise unordered)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(bool(params["deterministic"]),
                                       warn_only=True)
    try:
        result = train_nerf_models(params, log_fn=backend.log,
                                   device=params.get("device"))
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    backend.log_metric("test/psnr", result["test_psnr"])
    whash = get_model_weight_hash(result["fine_trainer"].field)
    backend.log(f"model weight hash: {whash}")
    if result.get("save_path") and os.path.exists(result["save_path"]):
        backend.save_artifact(result["save_path"])
    return result["test_psnr"]


def params_for_nerf(scene_dir: str, dataset_type: str = "blender",
                    save_name: Optional[str] = None, sweep: bool = False
                    ) -> Dict[str, Any]:
    """Experiment template (jobs_for_new_nerf.py:9-89). With sweep=True the
    list-valued entries become random_params choice points."""
    base: Dict[str, Any] = {
        "project_name": "new_nerf",
        "cfg_data": {"dataset_type": dataset_type, "datadir": scene_dir},
        "batch_size": 8192,
        "coarse_train": {"n_iters": 5000, "lr_density": 0.1, "lr_k0": 0.1},
        "fine_train": {"n_iters": 20000, "lr_density": 0.1, "lr_k0": 0.1,
                       "lr_rgbnet": 1e-3,
                       "pg_scale": (1000, 2000, 3000)},
        "fine_model": {"num_voxels": 160 ** 3, "rgbnet": "resmlp"},
        "save_name": save_name or os.path.join("ckpts", "scene.dvgo"),
    }
    if sweep:
        base["fine_train"]["lr_rgbnet"] = [1e-3, 3e-3, 1e-2]
        base["fine_model"]["rgbnet"] = ["resmlp", "basicmlp"]
        base["seed"] = [0, 1, 2]
    return base


def submit_nerf_jobs(scene_dir: str, number_jobs: int = 6, **kw):
    """(jobs_for_new_nerf.py:89)"""
    from dreamfusion_torch.utils.tools import submit_jobs

    return submit_jobs(
        lambda: params_for_nerf(scene_dir, sweep=True, **kw),
        "dreamfusion_torch.training.jobs:train_model",
        number_jobs=number_jobs, project_name="new_nerf")
