"""The tiled multiresolution grid encoder of stable-dreamfusion's grid
field (gridencoder/, gridtype 'tiled'), in plain PyTorch for the
benchmark's reference.

- level scale = exp2(l * log2(per_level_scale)) * base_resolution - 1,
  resolution = ceil(scale) + 1;
- position = x01 * scale + 0.5, trilinear over the 8 corners;
- row index: linear strides while the stride is at most the level's
  table size (uint32 arithmetic, done here in int64 masked to 32 bits),
  then % size;
- per-level table sizes capped at 2**log2_hashmap_size, rounded up to a
  multiple of 8, one flat [T, C] table; init U(-1e-4, 1e-4); a position
  outside [-bound, bound] encodes to 0.

The encoding is a gather (``index_select``) and a trilinear blend;
autograd gives the table's gradient. No gradient reaches the positions
(the reference's calc_grad_inputs=False)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

_U32 = (1 << 32) - 1


@dataclass(frozen=True)
class GridEncoderSpec:
    """Static geometry of the grid encoder (reference grid.py:92-133)."""
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: float = 2048.0
    gridtype: str = "tiled"

    def __post_init__(self):
        if self.gridtype != "tiled":
            raise ValueError("the reference holds the tiled grid only")

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def levels(self):
        """Per level (scale, size, offset, strides by dimension)."""
        pls = math.exp2(math.log2(self.desired_resolution
                                  / self.base_resolution)
                        / (self.num_levels - 1))
        out, offset = [], 0
        for lvl in range(self.num_levels):
            scale = math.exp2(lvl * math.log2(pls)) * self.base_resolution - 1
            resolution = int(math.ceil(scale)) + 1
            res_alloc = int(math.ceil(self.base_resolution * pls ** lvl))
            size = min(2 ** self.log2_hashmap_size,
                       (res_alloc + 1) ** self.input_dim)
            size = int(math.ceil(size / 8) * 8)
            stride, strides = 1, []
            for _ in range(self.input_dim):
                if stride > size:
                    break
                strides.append(stride)
                stride = (stride * (resolution + 1)) & _U32
            out.append((scale, size, offset, strides))
            offset += size
        return out

    @property
    def table_size(self) -> int:
        _, size, offset, _ = self.levels()[-1]
        return offset + size

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        """Flat [T, level_dim] table, U(-1e-4, 1e-4)."""
        u = torch.rand(self.table_size, self.level_dim, generator=generator,
                       device=device)
        return u * 2e-4 - 1e-4

    def __call__(self, embeddings: torch.Tensor, inputs: torch.Tensor,
                 bound: float = 1.0) -> torch.Tensor:
        """Encode positions in [-bound, bound] -> [..., L*C] features."""
        prefix = inputs.shape[:-1]
        D = self.input_dim
        x01 = ((inputs.detach().reshape(-1, D).float() + bound)
               / (2.0 * bound))
        oob = ((x01 < 0.0) | (x01 > 1.0)).any(-1)
        corners = torch.tensor([[(c >> d) & 1 for d in range(D)]
                                for c in range(1 << D)], device=x01.device)
        outs = []
        for scale, size, offset, strides in self.levels():
            pos = x01 * scale + 0.5
            pos_grid = torch.floor(pos)
            frac = pos - pos_grid
            # a negative coordinate (an out-of-range input) reads 0, as
            # float -> uint32 saturates
            coords = (pos_grid.clamp(min=0.0).long()[None]
                      + corners[:, None, :]) & _U32          # [8, B, D]
            idx = torch.zeros(coords.shape[:-1], dtype=torch.int64,
                              device=x01.device)
            for d, s in enumerate(strides):
                idx = (idx + coords[..., d] * s) & _U32
            rows = idx % size + offset
            w = torch.where(corners[:, None, :].bool(), frac[None],
                            1.0 - frac[None]).prod(-1)        # [8, B]
            vals = embeddings.index_select(0, rows.reshape(-1)).reshape(
                *rows.shape, -1).float()
            outs.append((w[..., None] * vals).sum(0))
        out = torch.stack(outs, dim=1).reshape(x01.shape[0], -1)
        out = torch.where(oob[:, None], torch.zeros_like(out), out)
        return out.reshape(*prefix, self.output_dim)
