# Plain PyTorch for the benchmark's reference, after the program's
# dreamfusion_torch/models/kailu.py; it imports nothing of the program.
"""Single-scene editing: frozen DVGO geometry + SDS-tunable colour MLP
(counterpart of dreamfusion_tpu/models/kailu.py; reference
NeRFNetwork_Kailu, nerf/network.py:224-312). A pretrained DVGO fine model
is loaded, its density and k0 grids are frozen, and only the colour MLP
(rgbnet) and the background net train under text guidance.

- coordinate remap world -> DVGO space: y/z swap + 1.25 scale about the
  box centre (network.py:245-249);
- sigma = softplus(density + act_shift) * 10 on the frozen grid
  (network.py:260), zero outside the box;
- albedo = rgbnet(k0 features, PE) queried with the fixed view direction
  1/sqrt(3) (network.py:265-266); 0.5 outside the box;
- trainable: rgbnet and the background net (network.py:270-283); the
  ``build_optimizer`` reads ``frozen_prefixes``.
"""

from __future__ import annotations

import math
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dfref.models.dvgo import DVGOField
from dfref.models.networks import _BaseNeRF


class DVGOEditNetwork(_BaseNeRF):
    """The trainer's and the renderer's view of a DVGO scene."""

    # parameters the optimizer leaves alone (network.py:271-273)
    frozen_prefixes = ("main.density", "main.k0")

    def __init__(self, bound: float = 1.0, bg_radius: float = 1.4,
                 world_size: Tuple[int, int, int] = (96, 96, 96),
                 k0_dim: int = 12, rgbnet_name: str = "resmlp",
                 rgbnet_width: int = 128, rgbnet_depth: int = 3,
                 posbase_pe: int = 5, viewbase_pe: int = 4,
                 xyz_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0),
                 xyz_max: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 alpha_init: float = 1e-6, stepsize: float = 0.5,
                 voxel_size_ratio: float = 1.0,
                 num_layers_bg: int = 2, hidden_dim_bg: int = 64):
        super().__init__(bound, bg_radius)
        self.main = DVGOField(
            world_size=world_size, k0_dim=k0_dim, rgbnet_name=rgbnet_name,
            rgbnet_width=rgbnet_width, rgbnet_depth=rgbnet_depth,
            posbase_pe=posbase_pe, viewbase_pe=viewbase_pe, xyz_min=xyz_min,
            xyz_max=xyz_max, alpha_init=alpha_init, stepsize=stepsize,
            voxel_size_ratio=voxel_size_ratio)
        self._init_bg_net(num_layers_bg, hidden_dim_bg, torch.float32)
        self.pretrained_state: Optional[Dict[str, torch.Tensor]] = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.main.reset_parameters(generator)
        if self.bg_net is not None:
            self.bg_net.reset_parameters(generator)

    def to_our_coor(self, x: torch.Tensor) -> torch.Tensor:
        """world [-bound, bound] -> DVGO scene coords (network.py:245-249)."""
        scaled = ((x + self.bound) / (2.0 * self.bound))[..., [0, 2, 1]]
        scaled = (scaled - 0.5) * 1.25 + 0.5
        return scaled * (self.main.maxs - self.main.mins) + self.main.mins

    def _inside(self, x: torch.Tensor):
        pts = self.to_our_coor(x)
        inside = ((pts <= self.main.maxs) & (pts >= self.main.mins)).all(-1)
        return inside, torch.clamp(pts, self.main.mins, self.main.maxs)

    def _sigma(self, inside, pts_safe) -> torch.Tensor:
        density = torch.where(inside, self.main.sample_density(pts_safe),
                              torch.zeros_like(pts_safe[..., 0]))
        return F.softplus(density + self.main.act_shift) * 10.0

    def common(self, x: torch.Tensor):
        """x [N,3] in [-bound,bound] -> (sigma [N], albedo [N,3])."""
        inside, pts_safe = self._inside(x)
        sigma = self._sigma(inside, pts_safe)
        vd = torch.ones_like(pts_safe) / math.sqrt(3.0)   # network.py:265
        rgb = self.main.query_rgb(pts_safe, vd)
        albedo = torch.where(inside[..., None], rgb, torch.full_like(rgb, 0.5))
        return sigma, albedo

    @classmethod
    def from_config(cls, cfg) -> "DVGOEditNetwork":
        """The field of cfg.pretrained_dvgo: the file is read once, for the
        module's sizes and, into ``pretrained_state``, for the weights that
        ``load_pretrained`` copies in after the initialisation."""
        kw: Dict[str, Any] = dict(bound=cfg.bound, bg_radius=cfg.bg_radius)
        state = None
        if cfg.pretrained_dvgo:
            state, hparams = _read_dvgo_ckpt(cfg.pretrained_dvgo)
            kw.update(_dvgo_meta(state, hparams))
        model = cls(**kw)
        model.pretrained_state = state
        return model

    def load_pretrained(self, path: Optional[str] = None) -> None:
        """Fill density, k0 and rgbnet from a .dvgo checkpoint: the file at
        `path`, or without one the state that from_config read (it is
        dropped afterwards)."""
        if path is not None:
            state = _read_dvgo_ckpt(path)[0]
        else:
            state, self.pretrained_state = self.pretrained_state, None
        if state is None:
            raise ValueError("no .dvgo checkpoint given or read")
        load_dvgo_state(self.main, state)


# -- .dvgo checkpoints (torch-lightning files) -----------------------------------

def _read_dvgo_ckpt(path: str):
    """(state_dict, hyper_parameters) of a .dvgo file. Tensors and plain
    containers load with weights_only=True; a lightning checkpoint that
    pickles other objects (only from a source you trust) needs the full
    unpickler."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt), ckpt.get("hyper_parameters", {})


def _dvgo_meta(state, hparams) -> Dict[str, Any]:
    meta: Dict[str, Any] = {
        "world_size": tuple(int(s) for s in state["density"].shape[-3:]),
        "k0_dim": int(state["k0"].shape[-4]),
        "xyz_min": tuple(float(v) for v in state["xyz_min"]),
        "xyz_max": tuple(float(v) for v in state["xyz_max"]),
        "voxel_size_ratio": float(state.get("voxel_size_ratio", 1.0)),
    }
    try:
        cfg = hparams["params"]["cfg"]["fine_model_and_render"]
    except (KeyError, TypeError):
        return meta
    meta.update(
        rgbnet_name=cfg.get("rgbnet", "resmlp"),
        rgbnet_width=int(cfg.get("rgbnet_width", 128)),
        rgbnet_depth=int(cfg.get("rgbnet_depth", 3)),
        posbase_pe=int(cfg.get("posbase_pe", 5)),
        viewbase_pe=int(cfg.get("viewbase_pe", 4)),
        alpha_init=float(cfg.get("alpha_init", 1e-6)),
        stepsize=float(cfg.get("stepsize", 0.5)),
    )
    return meta


def load_dvgo_state(field: DVGOField, state: Dict[str, torch.Tensor]) -> None:
    """Copy the grids and the rgbnet weights of a .dvgo state dict into the
    field. The grids lose their leading batch dimension; the rgbnet's
    Sequential names (net.0, net.i.net for a residual layer, net.<last>)
    map in order onto dense_in / res_i.net / dense_out (ResMLP) or
    dense_i / dense_out (BasicMLP); weights keep torch's [out, in]."""
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for k, v in state.items():
        m = re.match(r"rgbnet\.net\.(\d+)(?:\.net)?\.(weight|bias)", k)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = v
    with torch.no_grad():
        field.density.copy_(state["density"][0])
        field.k0.copy_(state["k0"][0])
        if not layers:
            return
        n = len(layers)
        if hasattr(field.rgbnet, "dense_in"):
            names = (["dense_in"] + [f"res_{i}.net" for i in range(n - 2)]
                     + ["dense_out"])
        else:
            names = [f"dense_{i}" for i in range(n - 1)] + ["dense_out"]
        for name, idx in zip(names, sorted(layers)):
            lin = field.rgbnet.get_submodule(name)
            lin.weight.copy_(layers[idx]["weight"])
            lin.bias.copy_(layers[idx]["bias"])
