"""Parameter conversion from the JAX package's flax trees to the port's
state dicts.

``from_jax_params(np_tree)`` takes a nested dict of numpy arrays (a flax
``params`` tree, with or without its top ``{"params": ...}`` level) and
returns a flat PyTorch state dict. The port's modules carry the flax
module names, so the conversion is mechanical:
- Dense ``kernel`` [in, out] -> ``weight`` [out, in];
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- GroupNorm / LayerNorm ``scale`` -> ``weight``;
- ``bias``, the grid table ``embeddings``, the DVGO grids ``density`` and
  ``k0`` (4-D, but not kernels), an ``embedding`` table and CLIP's
  ``class_embedding`` and ``logit_scale`` unchanged.
It covers the NeRF fields (tables, MLPs, background net; the vanilla
field's ``sigma_net.block_i.{dense,norm}``, ``block_0.skip`` and
``dense_out``; the editing field's ``main.density``, ``main.k0``,
``main.rgbnet.*``), the SD UNet and VAE, and the CLIP model of
guidance/clip.py (a FlaxCLIPModel's tree); a VAE tree fills the whole
port VAE, its ``decoder`` and ``post_quant_conv`` included.

``from_jax_dvgo(np_tree)`` is from_jax_params for a DVGOField tree
(``density``, ``k0``, ``rgbnet/dense_in|res_N|dense_out`` or ``dense_N``),
checked for both grids.

``from_hf_clip(hf_sd, template, prefix)`` maps a transformers CLIP state
dict (``text_model.encoder.layers.N.self_attn.q_proj.weight``, ...; the
layouts are already torch's) onto the port's CLIP modules of
guidance/clip.py: ``*_embedding.weight`` becomes ``*_embedding.embedding``,
the ``position_ids`` buffer older checkpoints hold is checked to be
0..n-1 and dropped, and guidance/sd/convert.convert_state_dict raises on a
missing, extra or mis-shaped tensor. ``prefix`` ("text_model.") takes a
CLIPTextModel's dict onto a bare CLIPTextTransformer (SD's text encoder);
``load_hf_clip`` copies the result in.

``from_jax_grid_state(state)`` carries the occupancy-grid state across, so
that both packages render a frame from the same grid.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.ops.marching import GridState

def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if k == "params" and not prefix:
            flat.update(_flatten(v, prefix))
            continue
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, name + "."))
        else:
            flat[name] = np.asarray(v)
    return flat


def _convert(name: str, arr: np.ndarray):
    base, _, leaf = name.rpartition(".")
    stem = f"{base}." if base else ""
    if leaf == "kernel":
        if arr.ndim == 2:
            return stem + "weight", arr.T
        if arr.ndim == 4:
            return stem + "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {arr.ndim} at {name}")
    if leaf == "scale":
        return stem + "weight", arr
    return name, arr


def from_jax_params(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves) -> PyTorch state dict (f32 tensors)."""
    out = {}
    for name, arr in _flatten(np_tree).items():
        key, val = _convert(name, arr)
        out[key] = torch.from_numpy(np.array(val, np.float32, order="C"))
    return out


def from_jax_dvgo(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX DVGOField params tree -> the port DVGOField's state dict."""
    sd = from_jax_params(np_tree)
    missing = [k for k in ("density", "k0") if k not in sd]
    if missing:
        raise ValueError(f"not a DVGOField tree: no {missing}")
    return sd


def from_hf_clip(hf_sd: Mapping[str, np.ndarray],
                 template: Mapping[str, torch.Tensor],
                 prefix: str = "") -> Dict[str, np.ndarray]:
    """transformers CLIP names -> the keys of `template` (the state dict of
    a port CLIP module); see the module docstring."""
    from dreamfusion_torch.guidance.sd.convert import convert_state_dict

    renamed: Dict[str, np.ndarray] = {}
    for name, arr in hf_sd.items():
        if prefix and name.startswith(prefix):
            name = name[len(prefix):]
        if name.endswith("position_ids"):
            arr = np.asarray(arr)
            if not np.array_equal(arr.reshape(-1), np.arange(arr.size)):
                raise ValueError(f"{name} is not 0..{arr.size - 1}")
            continue
        renamed[re.sub(r"(token|position)_embedding\.weight$", r"\1_embedding.embedding",
                       name)] = arr
    return convert_state_dict(renamed, template)


def load_hf_clip(module: torch.nn.Module, hf_sd: Mapping[str, np.ndarray],
                 prefix: str = "") -> torch.nn.Module:
    """from_hf_clip onto `module`, copied in as f32."""
    conv = from_hf_clip(hf_sd, module.state_dict(), prefix)
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in conv.items()}, strict=True)
    return module


def from_jax_grid_state(state: Any,
                        device: Optional[torch.device] = None) -> GridState:
    """A JAX ``GridState`` with numpy-convertible leaves density_grid
    [C,H,H,H] f32, occ [C,H,H,H] bool and mean_density [] -> the port's
    GridState on `device` (default: the GPU, as the port's builders)."""
    leaves = state._asdict()
    dev = resolve_device(device)
    return GridState(
        density_grid=torch.from_numpy(np.array(leaves["density_grid"],
                                               np.float32)).to(dev),
        occ=torch.from_numpy(np.array(leaves["occ"], bool)).to(dev),
        mean_density=torch.tensor(float(np.asarray(leaves["mean_density"])),
                                  dtype=torch.float32, device=dev))
