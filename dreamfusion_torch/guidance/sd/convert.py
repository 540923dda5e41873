"""Load diffusers-layout Stable Diffusion UNet and VAE weights into the
port's modules (counterpart of dreamfusion_tpu/guidance/sd/convert.py).

The port's modules carry the diffusers names with ``_`` where diffusers
nests with ``.`` (``down_blocks_0_resnets_1.conv1.weight`` for
``down_blocks.0.resnets.1.conv1.weight``), and the same layouts (Linear
[out, in], Conv OIHW), so a name matches when both agree after removing
every separator and lower-casing. Older diffusers VAEs name the mid-block
attention ``query`` / ``key`` / ``value`` / ``proj_attn`` and store it as
1x1 convolutions; those are matched by alias and squeezed to [out, in].

    sd = load_module_dir("<sd dir>/unet")      # name -> numpy array
    unet.load_state_dict(convert_state_dict(sd, unet.state_dict()))

``convert_state_dict`` raises, naming the keys, on a parameter of the
module that the file lacks, a tensor of the file that matches no
parameter, and a shape that differs. ``.safetensors`` files are read by
the small reader here (the format is an 8-byte little-endian header
length, a JSON header, then raw little-endian tensor data); ``.bin`` files
by ``torch.load(weights_only=True)``.

A whole diffusers SD directory also holds the CLIP text encoder and its
BPE tokenizer, which the port does not have; ``build_sd_guidance`` refuses
a directory for that reason.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Mapping

import numpy as np
import torch

_ALIASES = {  # old diffusers VAE attention names
    "query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out_0",
}

# safetensors dtype names -> numpy dtypes (little-endian); bf16 is read as
# its raw 16 bits and widened to f32 below
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
              "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
              "U8": "u1", "BOOL": "?"}


def _norm(name: str) -> str:
    for old, new in _ALIASES.items():
        name = re.sub(rf"(^|\.){old}(\.|$)", rf"\1{new}\2", name)
    return re.sub(r"[^0-9a-zA-Z]", "", name).lower()


def convert_state_dict(diffusers_sd: Mapping[str, np.ndarray],
                       template: Mapping[str, torch.Tensor]
                       ) -> Dict[str, np.ndarray]:
    """Map a diffusers state dict (name -> array) onto the keys of
    `template` (a module's state_dict; meta tensors do: only shapes are
    read). Returns {template key: array} without copying the data; raises
    ValueError on any missing, unmatched or shape-mismatched parameter."""
    lookup = {_norm(k): k for k in template}
    if len(lookup) != len(template):
        raise ValueError("template keys collide after normalisation")
    out: Dict[str, np.ndarray] = {}
    unmatched, mismatched = [], []
    for name, w in diffusers_sd.items():
        key = lookup.get(_norm(name))
        if key is None:
            unmatched.append(name)
            continue
        w = np.asarray(w)
        shape = tuple(template[key].shape)
        if w.ndim == 4 and len(shape) == 2 and w.shape[2:] == (1, 1):
            w = w[:, :, 0, 0]          # old VAE attention: 1x1 conv -> dense
        if tuple(w.shape) != shape:
            mismatched.append(f"{name}: {tuple(w.shape)} vs {shape} at {key}")
            continue
        out[key] = w
    missing = [k for k in template if k not in out]
    errors = []
    if missing:
        errors.append(f"{len(missing)} parameters missing from the "
                      f"checkpoint: {missing[:8]}")
    if unmatched:
        errors.append(f"{len(unmatched)} checkpoint tensors match no "
                      f"parameter: {unmatched[:8]}")
    if mismatched:
        errors.append(f"{len(mismatched)} shape mismatches: {mismatched[:8]}")
    if errors:
        raise ValueError("; ".join(errors))
    return out


def load_converted(module: torch.nn.Module,
                   diffusers_sd: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """convert_state_dict onto `module` and copy the values in (cast to
    each parameter's dtype and device)."""
    conv = convert_state_dict(diffusers_sd, module.state_dict())
    module.load_state_dict({k: torch.from_numpy(
        np.array(v, np.float32)) for k, v in conv.items()}, strict=True)
    return module


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A .safetensors file -> {name: numpy array} (bf16 widened to f32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {dtype}, "
                             "which this reader does not take")
        lo, hi = info["data_offsets"]
        arr = np.frombuffer(data[lo:hi], dtype=_ST_DTYPES[dtype])
        if dtype == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        shape = tuple(info["shape"])
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{path}: tensor {name} holds {arr.size} "
                             f"values for shape {shape}")
        out[name] = arr.reshape(shape)
    return out


def load_module_dir(path: str) -> Dict[str, np.ndarray]:
    """A diffusers-format module directory (``unet/``, ``vae/``) -> its
    state dict as numpy arrays."""
    for fname in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        f = os.path.join(path, fname)
        if os.path.exists(f):
            return read_safetensors(f)
    for fname in ("diffusion_pytorch_model.bin", "pytorch_model.bin"):
        f = os.path.join(path, fname)
        if os.path.exists(f):
            sd = torch.load(f, map_location="cpu", weights_only=True)
            return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no model weights found under {path}")
