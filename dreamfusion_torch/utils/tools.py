"""Experiment tooling (counterpart of dreamfusion_tpu/utils/tools.py;
reference utils/tools.py).

- random_params: the recursive sweep grammar: a list means "choose one",
  a tuple is a literal, a ``_no_choice`` key suffix protects a list
  (tools.py:256-282);
- submit_jobs: the dedupe loop that samples parameter sets until
  ``number_jobs`` distinct ones are submitted (tools.py:224-253);
- parse_params: defaults, the lr / learning_rate / max_lr aliases and the
  per-device batch size (tools.py:137-194); with ``devices`` > 1 the
  backend is the port's data parallelism, "data_parallel"
  (parallel/sharding.py; the JAX package names its shard_map);
- get_model_weight_hash: a sha256 over a module's state dict, the
  determinism probe (tools.py:109-112);
- skip_if_excuted: memoise the last call of an expensive function
  (tools.py:369-385).
"""

from __future__ import annotations

import hashlib
import json
from copy import deepcopy
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch


def random_params(val):
    if isinstance(val, list):
        idx = np.random.randint(len(val))
        return random_params(val[idx])
    if isinstance(val, tuple):
        return tuple(random_params(v) for v in val)
    if isinstance(val, dict):
        ret = {}
        for key, values in val.items():
            if isinstance(values, list) and key.endswith("_no_choice"):
                ret[key[:-10]] = values
            else:
                ret[key] = random_params(values)
        return ret
    if isinstance(val, np.integer):
        return int(val)
    if isinstance(val, np.floating):
        return float(val)
    return val


def tuples_to_lists(val):
    if isinstance(val, (list, tuple)):
        return [tuples_to_lists(v) for v in val]
    if isinstance(val, dict):
        return {k: tuples_to_lists(v) for k, v in val.items()}
    return val


def parse_params(params: Dict[str, Any]) -> Dict[str, Any]:
    defaults = {
        "precision": "bf16",
        "deterministic": True,
        "devices": 1,
        "num_epochs": 1,
    }
    params = {**defaults, **params}
    if "backend" not in params:
        params["backend"] = None if params["devices"] == 1 else "data_parallel"

    if "dataset" in params and isinstance(params["dataset"], str):
        params["dataset"] = {"name": params["dataset"]}
    if "dataset" in params:
        ds = params["dataset"]
        if "total_batch_size" in ds and "batch_size" not in ds:
            ds["batch_size"] = ds["total_batch_size"] // params["devices"]
        if "total_batch_size" not in ds and "batch_size" in ds:
            ds["total_batch_size"] = ds["batch_size"] * params["devices"]

    for groups in [("learning_rate", "lr", "max_lr")]:
        for key in groups:
            if key in params:
                val = params[key]
                for key2 in groups:
                    params[key2] = val
                break
    return params


_submitted_history: List[Dict] = []


def submit_jobs(param_generator: Callable[[], Dict], command: str,
                number_jobs: int = 1, project_name: Optional[str] = None,
                backend=None, max_tries: int = 1000) -> List[Dict]:
    """Sample distinct parameter sets and submit each as a job
    (tools.py:224-253). `command` is 'module:function'."""
    from dreamfusion_torch.utils import backend as default_backend

    be = backend or default_backend
    submitted: List[Dict] = []
    for idx in range(number_jobs):
        hyper = None
        for _ in range(max_tries):
            cand = random_params(param_generator())
            if cand not in submitted and cand not in _submitted_history:
                hyper = cand
                break
        if hyper is None:
            break
        submitted.append(deepcopy(hyper))
        _submitted_history.append(deepcopy(hyper))
        hyper.setdefault("seed", 2018011328)
        hyper.setdefault("project_name", project_name)
        be.submit(command, hyper)
        be.log(f"submitted task {idx}: {json.dumps(_safe(hyper))[:200]}")
    return submitted


def _safe(d):
    return {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                else repr(v)) for k, v in d.items()}


def _flat_tensors(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flat_tensors(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def get_model_weight_hash(model) -> str:
    """sha256 over a module's state dict (or a nested dict of tensors or
    arrays): the sorted names and the bytes of each tensor, the
    determinism probe (tools.py:109-112)."""
    tree = model.state_dict() if isinstance(model, torch.nn.Module) else model
    h = hashlib.sha256()
    for name, leaf in sorted(_flat_tensors(tree).items()):
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
        h.update(name.encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


_excuted_buffer: Dict[str, str] = {}
_excuted_results: Dict[str, Any] = {}


def skip_if_excuted(func):
    def wrapper(*args, **kwargs):
        key = func.__name__
        sig = str({"args": args, "kwargs": kwargs})
        if _excuted_buffer.get(key) != sig:
            _excuted_results[key] = func(*args, **kwargs)
            _excuted_buffer[key] = sig
        return deepcopy(_excuted_results[key])

    return wrapper
