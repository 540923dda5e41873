"""Results and experiment tooling (counterpart of
dreamfusion_tpu/utils/results.py), the reference's small utilities:
- gather_tb.py       collect the tensorboard logdirs of finished jobs;
- copy_models.py     copy checkpoints out of job directories by filter;
- results_extract.py tabulate a metric across jobs;
- tools.find_best_gpus (utils/tools.py:337-346) -> pick_devices: the first
  n CUDA devices, in order (the JAX package picks its first n devices the
  same way; the reference picked by free memory).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _iter_job_dirs(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        if "params.json" in filenames or "metrics.jsonl" in filenames:
            yield dirpath


def load_job(job_dir: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {"dir": job_dir, "params": {}, "metrics": {}}
    pj = os.path.join(job_dir, "params.json")
    if os.path.exists(pj):
        with open(pj) as f:
            out["params"] = json.load(f)
    mj = os.path.join(job_dir, "metrics.jsonl")
    if os.path.exists(mj):
        with open(mj) as f:
            lines = f.readlines()
        for line in lines:
            rec = json.loads(line)
            for k, v in rec.items():
                if k != "time":
                    out["metrics"].setdefault(k, []).append(v)
    return out


def get_targets(root: str, params_filter: Optional[Dict] = None) -> List[Dict]:
    """Jobs whose logged params contain params_filter
    (utils/tools.py:16-106)."""
    params_filter = params_filter or {}
    hits = []
    for d in _iter_job_dirs(root):
        job = load_job(d)
        if all(str(job["params"].get(k)) == str(repr(v) if not isinstance(v, str) else v)
               or str(job["params"].get(k)) == str(v)
               for k, v in params_filter.items()):
            hits.append(job)
    return hits


def results_extract(root: str, metric: str = "test/psnr") -> List[Dict]:
    """Tabulate the final value of `metric` per job (results_extract.py)."""
    rows = []
    for d in _iter_job_dirs(root):
        job = load_job(d)
        vals = job["metrics"].get(metric)
        if vals:
            rows.append({"dir": d, metric: vals[-1], "params": job["params"]})
    return sorted(rows, key=lambda r: -r[metric])


def copy_models(root: str, out_dir: str, pattern: str = ".dvgo",
                params_filter: Optional[Dict] = None) -> List[str]:
    """Copy checkpoint artifacts of matching jobs (copy_models.py)."""
    os.makedirs(out_dir, exist_ok=True)
    copied = []
    for job in get_targets(root, params_filter):
        for f in os.listdir(job["dir"]):
            if f.endswith(pattern):
                src = os.path.join(job["dir"], f)
                dst = os.path.join(out_dir, os.path.basename(job["dir"]) + "_" + f)
                shutil.copy(src, dst)
                copied.append(dst)
    return copied


def gather_tb(root: str, out_dir: str) -> List[str]:
    """Symlink every job's tensorboard logdir under out_dir (gather_tb.py)."""
    os.makedirs(out_dir, exist_ok=True)
    links = []
    for d in _iter_job_dirs(root):
        tb = os.path.join(d, "tensorboard.txt")
        if os.path.exists(tb):
            with open(tb) as f:
                target = f.read().strip()
            link = os.path.join(out_dir, os.path.basename(d))
            if target and os.path.isdir(target) and not os.path.exists(link):
                os.symlink(os.path.abspath(target), link)
                links.append(link)
    return links


def pick_devices(n: int = 1) -> List[torch.device]:
    """The first n CUDA devices (positional, as in the JAX package)."""
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def mean_results(root: str, metric: str, params_filter: Optional[Dict] = None
                 ) -> float:
    """Mean of a metric over matching jobs (utils/tools.py:105-106)."""
    vals = [job["metrics"][metric][-1]
            for job in get_targets(root, params_filter)
            if metric in job["metrics"]]
    return float(np.mean(vals)) if vals else float("nan")
