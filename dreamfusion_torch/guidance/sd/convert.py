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

``diffusers_names`` maps the port's keys back (``down_blocks_0_resnets_1.``
-> ``down_blocks.0.resnets.1.``), and ``write_safetensors`` writes a
``.safetensors`` file, so a directory can be written from the port's
modules without the safetensors package.

``convert_state_dict`` raises, naming the keys, on a parameter of the
module that the file lacks, a tensor of the file that matches no
parameter, and a shape that differs. ``.safetensors`` files are read by
the small reader here (the format is an 8-byte little-endian header
length, a JSON header, then raw little-endian tensor data); ``.bin`` files
by ``torch.load(weights_only=True)``.

``load_sd_dir(sd_dir, unet, vae)`` loads a whole diffusers SD directory,
as the JAX package's ``load_sd_params`` does: ``unet/`` and ``vae/`` as
above, the CLIP text encoder of ``text_encoder/`` (its config.json and
weights, through weights.load_hf_clip onto guidance/clip.
CLIPTextTransformer) and the BPE tokenizer of ``tokenizer/``
(guidance/tokenizer.py). It returns the modules and ``text_encode(prompts)
-> [n, 77, D]``, the last hidden state after the final LayerNorm.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Callable, Dict, Mapping, Optional, Tuple

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


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> None:
    """{name: numpy array} -> a .safetensors file: the u64 little-endian
    header length, the JSON header (dtype, shape, data_offsets), then the
    raw little-endian bytes in the header's order."""
    names = {np.dtype(v).str: k for k, v in _ST_DTYPES.items()
             if k != "BF16"}
    header, off = {"__metadata__": {"format": "pt"}}, 0
    arrays = {}
    for name, v in tensors.items():
        arr = np.ascontiguousarray(v, v.dtype.newbyteorder("<"))
        if arr.dtype.str not in names:
            raise ValueError(f"tensor {name}: dtype {arr.dtype} has no "
                             "safetensors name here")
        header[name] = {"dtype": names[arr.dtype.str],
                        "shape": list(arr.shape),
                        "data_offsets": [off, off + arr.nbytes]}
        arrays[name] = arr
        off += arr.nbytes
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for arr in arrays.values():
            f.write(arr.tobytes())


def diffusers_names(state_dict: Mapping[str, object]) -> Dict[str, object]:
    """The port's UNet / VAE keys -> diffusers' names (the values kept):
    ``_N_`` and a trailing ``_N`` nest with dots, as does ``mid_block_``;
    ``time_embedding.linear_N`` keeps its underscore."""
    out = {}
    for key, v in state_dict.items():
        name = re.sub(r"_(\d+)_", r".\1.", key)
        name = re.sub(r"_(\d+)(?=\.|$)", r".\1", name)
        name = re.sub(r"time_embedding\.linear\.(\d)", r"time_embedding.linear_\1",
                      name)
        out[name.replace("mid_block_", "mid_block.")] = v
    return out


def load_module_dir(path: str) -> Dict[str, np.ndarray]:
    """A diffusers or transformers module directory (``unet/``, ``vae/``,
    ``text_encoder/``, a CLIP directory) -> its state dict as numpy
    arrays."""
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


SD_DIR_PARTS = ("unet", "vae", "text_encoder", "tokenizer")


def check_sd_dir(sd_dir: str) -> None:
    """Raise FileNotFoundError, naming what is missing, unless sd_dir holds
    the four parts load_sd_dir reads."""
    missing = [p for p in SD_DIR_PARTS
               if not os.path.isdir(os.path.join(sd_dir, p))]
    if missing:
        raise FileNotFoundError(
            f"{sd_dir} is not a whole diffusers SD directory: no "
            f"{', '.join(p + '/' for p in missing)}")


def load_sd_dir(sd_dir: str, unet: torch.nn.Module, vae: torch.nn.Module,
                device: Optional[torch.device] = None
                ) -> Tuple[torch.nn.Module, torch.nn.Module, torch.nn.Module,
                           Callable]:
    """A diffusers-layout SD directory -> (unet, vae, text encoder,
    text_encode). The UNet and VAE weights are copied into the given
    modules (f32; the caller casts them); the text encoder is a
    guidance/clip.CLIPTextTransformer in f32 on `device` (default: the
    UNet's device), frozen. text_encode(prompts) -> f32 [n, 77, D]; it
    carries the tokenizer and the text model as attributes."""
    from dreamfusion_torch.guidance.clip import CLIPTextTransformer
    from dreamfusion_torch.guidance.tokenizer import CLIPBPETokenizer
    from dreamfusion_torch.weights import load_hf_clip

    check_sd_dir(sd_dir)
    load_converted(unet, load_module_dir(os.path.join(sd_dir, "unet")))
    load_converted(vae, load_module_dir(os.path.join(sd_dir, "vae")))
    te_dir = os.path.join(sd_dir, "text_encoder")
    with open(os.path.join(te_dir, "config.json")) as f:
        te_cfg = json.load(f)
    text_model = CLIPTextTransformer(te_cfg)
    load_hf_clip(text_model, load_module_dir(te_dir), prefix="text_model.")
    if device is None:
        device = next(unet.parameters()).device
    text_model = text_model.to(device).eval().requires_grad_(False)
    tokenizer = CLIPBPETokenizer.from_dir(os.path.join(sd_dir, "tokenizer"))

    def text_encode(prompts):
        ids = torch.from_numpy(tokenizer(list(prompts))).to(device)
        with torch.no_grad():
            return text_model.last_hidden_state(ids)

    text_encode.tokenizer, text_encode.text_model = tokenizer, text_model
    return unet, vae, text_model, text_encode
