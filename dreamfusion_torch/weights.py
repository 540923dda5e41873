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

``from_jax_grid_state(state)`` carries the occupancy-grid state across, so
that both packages render a frame from the same grid.
"""

from __future__ import annotations

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
