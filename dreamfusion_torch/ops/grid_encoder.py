"""Multiresolution hash / tiled grid encoder (counterpart of
dreamfusion_tpu/ops/grid_encoder.py; reference gridencoder/).

Geometry, index arithmetic, init and the out-of-bounds -> 0 rule follow the
JAX package exactly:
- level scale = exp2(l * log2(per_level_scale)) * base_resolution - 1,
  resolution = ceil(scale) + 1;
- position = x01 * scale + 0.5, trilinear over the 8 corners;
- row index: linear strides while stride <= table size; a level of the
  "hash" grid type whose stride ends above its table size takes the
  spatial hash instead (XOR of coord_d * prime_d); then % size. The
  arithmetic is uint32 in the reference, done here in int64 masked to 32
  bits (torch has no full uint32 multiply). The stride itself wraps at
  2^32, so a very fine level can end below its table size and stay linear;
- per-level table sizes capped at 2**log2_hashmap_size, rounded up to a
  multiple of 8, flat [T, C] table; init U(-1e-4, 1e-4).

The forward is ``GridEncoderSpec.encode``: kernel H
(csrc/grid_encoder_fwd.cu) on a CUDA tensor, every level in one launch from
the positions and the level table of kernel E; on the CPU the plain gather
plus trilinear blend that kernel H follows (the JAX forward is XLA
``take``, not a Pallas kernel). The backward's residuals are built only
where autograd will read them: grad enabled and a table that requires
grad. Under no_grad (the staged eval, the occupancy refresh, the mesh
export) kernel H alone runs. With grad, the one autograd Function
``_EncodeLevels`` runs that forward and saves the residuals of the
backward the spec takes, which follows the JAX package
(grid_encoder.py:461-464, 513-524):
- every level affine (the tiled grid, or a hash spec so small that no level
  hashes): corner c of a sample with corner-0 row ``base`` lives at
  ``(base + corner_off_c) % size``. The residuals are ``residuals()``'s
  base_all and w_all; the backward launches kernel A
  (csrc/grid_encoder_bwd.cu) on CUDA and runs ``grid_encoder_bwd_plain`` on
  the CPU;
- any level hashed: every corner of every level goes through the index
  function (a hashed corner is not ``base + offset``). The only residual
  is the unit positions ``x01`` [B, D]; the backward launches kernel E (the
  second entry of csrc/grid_encoder_bwd.cu), which forms the corners,
  weights and rows from ``x01`` itself, on CUDA, and on the CPU rebuilds
  the rows ``[L, 8, B]`` (``corner_rows``) for
  ``grid_encoder_bwd_rows_plain``;
- ``differentiable_inputs=True``: plain autograd through the gather, which
  also gives d(out)/d(position) with d(frac)/dx = scale (the reference's
  calc_grad_inputs); no custom backward.

Otherwise gradients w.r.t. the positions are not propagated (reference
default calc_grad_inputs=False).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.ops import cuda

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = (1 << 32) - 1


@functools.lru_cache(maxsize=None)
def _level_geometry(num_levels, base_resolution, per_level_scale,
                    log2_hashmap_size, input_dim, align_corners):
    """Static per-level (scale, resolution, size, offset) and total rows.
    Cached: an encoder call reads it several times per level. The lists
    are shared between callers, which only read them."""
    max_params = 2 ** log2_hashmap_size
    S = math.log2(per_level_scale)
    scales, resolutions, sizes, offsets = [], [], [], []
    offset = 0
    for lvl in range(num_levels):
        scale = math.exp2(lvl * S) * base_resolution - 1.0
        resolution = int(math.ceil(scale)) + 1
        res_alloc = int(math.ceil(base_resolution * per_level_scale ** lvl))
        params = min(max_params,
                     (res_alloc if align_corners else res_alloc + 1) ** input_dim)
        params = int(math.ceil(params / 8) * 8)
        scales.append(scale)
        resolutions.append(resolution)
        sizes.append(params)
        offsets.append(offset)
        offset += params
    return scales, resolutions, sizes, offsets, offset


@dataclass(frozen=True)
class GridEncoderSpec:
    """Static geometry of the grid encoder (reference grid.py:92-133)."""
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: Optional[float] = None
    gridtype: str = "hash"      # 'hash' | 'tiled'
    align_corners: bool = False
    # True keeps d(out)/d(position) (plain autograd, no kernel)
    differentiable_inputs: bool = False

    def __post_init__(self):
        if self.gridtype not in ("hash", "tiled"):
            raise ValueError(f"gridtype must be 'hash' or 'tiled', got "
                             f"{self.gridtype!r}")
        if self.desired_resolution is not None:
            pls = math.exp2(math.log2(self.desired_resolution
                                      / self.base_resolution)
                            / (self.num_levels - 1))
            object.__setattr__(self, "per_level_scale", pls)
            object.__setattr__(self, "desired_resolution", None)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def geometry(self):
        return _level_geometry(self.num_levels, self.base_resolution,
                               self.per_level_scale, self.log2_hashmap_size,
                               self.input_dim, self.align_corners)

    @property
    def table_size(self) -> int:
        return self.geometry[4]

    def init(self, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> torch.Tensor:
        """Flat [T, level_dim] table, U(-1e-4, 1e-4)."""
        u = torch.rand(self.table_size, self.level_dim, generator=generator,
                       device=resolve_device(device))
        return u * 2e-4 - 1e-4

    def _strides(self, level: int):
        """(linear strides by dimension, whether the level hashes). The
        stride wraps at 2^32 like the reference's uint32, and the hash
        decision reads the wrapped value."""
        _, resolutions, sizes, _, _ = self.geometry
        size = sizes[level]
        mult = resolutions[level] if self.align_corners else resolutions[level] + 1
        stride, strides = 1, {}
        for d in range(self.input_dim):
            if stride > size:
                break
            strides[d] = stride
            stride = (stride * mult) & _U32
        return strides, self.gridtype == "hash" and stride > size

    @property
    def hashed_levels(self) -> Tuple[bool, ...]:
        return tuple(self._strides(lvl)[1] for lvl in range(self.num_levels))

    def _corner_index_fn(self, level: int):
        """fn(coords [..., D] int64) -> flat row [...] (offset included),
        get_grid_index of gridencoder.cu:54-72 with uint32 wrap-around."""
        _, _, sizes, offsets, _ = self.geometry
        size, offset = sizes[level], offsets[level]
        strides, hashed = self._strides(level)

        def index_fn(coords: torch.Tensor) -> torch.Tensor:
            coords = coords.long() & _U32
            idx = torch.zeros(coords.shape[:-1], dtype=torch.int64,
                              device=coords.device)
            if hashed:
                # every dimension enters the hash; mask each product to 32
                # bits before the XOR (int64 products wrap modulo 2^64,
                # which keeps their low 32 bits)
                for d in range(self.input_dim):
                    idx = idx ^ ((coords[..., d] * _PRIMES[d]) & _U32)
            else:
                for d, s in strides.items():
                    idx = (idx + coords[..., d] * s) & _U32
            return idx % size + offset

        return index_fn

    def _corner_offsets(self, level: int) -> Optional[Tuple[int, ...]]:
        """(corner_index - corner0_index) % size for the 2^D corners, or
        None where the level hashes (its corners are not affine)."""
        _, _, sizes, _, _ = self.geometry
        strides, hashed = self._strides(level)
        if hashed:
            return None
        offs = []
        for corner in range(1 << self.input_dim):
            o = sum(s for d, s in strides.items() if (corner >> d) & 1)
            offs.append(o % sizes[level])
        return tuple(offs)

    def level_table(self, device: torch.device) -> torch.Tensor:
        """[L, 2 + 2^D] int32: size, offset, corner offsets per level (the
        kernel's constant table)."""
        _, _, sizes, offsets, _ = self.geometry
        rows = []
        for lvl in range(self.num_levels):
            rows.append([sizes[lvl], offsets[lvl], *self._corner_offsets(lvl)])
        return torch.tensor(rows, dtype=torch.int32, device=device)

    def _unit_positions(self, inputs: torch.Tensor, bound: float):
        """Positions [..., D] in [-bound, bound] -> (x01 transposed [D, B],
        oob [B] bool)."""
        x = inputs.reshape(-1, self.input_dim).float()
        x01 = (x + bound) / (2.0 * bound)
        return x01.t(), ((x01 < 0.0) | (x01 > 1.0)).any(-1)

    def _level_corners(self, xT: torch.Tensor, lvl: int):
        """(integer corner-0 coordinates [D, B] int64, weights [2^D, B])."""
        pos = xT * self.geometry[0][lvl] + (0.0 if self.align_corners else 0.5)
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid           # d(frac)/dx = scale (floor: 0)
        ws = []
        for corner in range(1 << self.input_dim):
            w = torch.ones_like(frac[0])
            for d in range(self.input_dim):
                w = w * (frac[d] if (corner >> d) & 1 else 1.0 - frac[d])
            ws.append(w)
        # float -> uint32 saturates in the JAX package (a negative
        # coordinate, which only an out-of-range input has, reads 0)
        coords = pos_grid.detach().clamp(min=0.0).long().clamp(max=_U32)
        return coords, torch.stack(ws)

    def _level_rows(self, pos_grid: torch.Tensor, lvl: int) -> torch.Tensor:
        """Global table rows [2^D, B] int64 of the 2^D corners, each through
        the index function: corner c is at pos_grid + bits(c), which on a
        hashed level is not a row offset from corner 0."""
        index_fn = self._corner_index_fn(lvl)
        bits = torch.tensor([[(c >> d) & 1 for d in range(self.input_dim)]
                             for c in range(1 << self.input_dim)],
                            dtype=torch.int64, device=pos_grid.device)
        return index_fn(pos_grid.t()[None, :, :] + bits[:, None, :])

    def residuals(self, inputs: torch.Tensor, bound: float = 1.0):
        """Positions [B, D] in [-bound, bound] -> (base_all [L,B] int32
        local corner-0 rows, w_all [L, 2^D, B] f32 weights, oob [B] bool).
        These are the JAX VJP's residuals and kernel A's inputs (every
        level affine)."""
        xT, oob = self._unit_positions(inputs, bound)
        offsets = self.geometry[3]
        bases, weights = [], []
        for lvl in range(self.num_levels):
            pos_grid, w8 = self._level_corners(xT, lvl)
            idx0 = self._corner_index_fn(lvl)(pos_grid.t())
            bases.append((idx0 - offsets[lvl]).to(torch.int32))
            weights.append(w8)
        return torch.stack(bases), torch.stack(weights), oob

    def corner_rows(self, x01: torch.Tensor):
        """Unit positions [B, D] -> (rows [L, 2^D, B] int32 global table
        rows of the corners, level offsets included; w_all [L, 2^D, B] f32):
        what kernel E computes from x01 for itself."""
        xT = x01.t()
        rows, weights = [], []
        for lvl in range(self.num_levels):
            pos_grid, w8 = self._level_corners(xT, lvl)
            rows.append(self._level_rows(pos_grid, lvl).to(torch.int32))
            weights.append(w8)
        return torch.stack(rows), torch.stack(weights)

    def residuals_rows(self, inputs: torch.Tensor, bound: float = 1.0):
        """Positions [B, D] -> (rows, w_all as in corner_rows; oob [B]
        bool): the JAX VJP's residuals of an encoder with a hashed level
        (grid_encoder.py:261-266)."""
        xT, oob = self._unit_positions(inputs, bound)
        return (*self.corner_rows(xT.t()), oob)

    def rows_level_table(self, device: torch.device) -> torch.Tensor:
        """[L, 8] int32, kernel E's constant table: per level the scale
        and the shift as f32 bits (the float32 values `_level_corners`
        computes with), size, offset, the uint32 strides by dimension (0
        where a dimension is not in the affine sum) and the hashed flag."""
        scales, _, sizes, offsets, _ = self.geometry
        f32_bits = lambda v: int(torch.tensor(v, dtype=torch.float32)  # noqa: E731
                                 .view(torch.int32))
        as_i32 = lambda v: v - (1 << 32) if v >= 1 << 31 else v  # noqa: E731
        rows = []
        for lvl in range(self.num_levels):
            strides, hashed = self._strides(lvl)
            rows.append([f32_bits(scales[lvl]),
                         f32_bits(0.0 if self.align_corners else 0.5),
                         sizes[lvl], offsets[lvl],
                         *(as_i32(strides.get(d, 0))
                           for d in range(self.input_dim)), int(hashed)])
        return torch.tensor(rows, dtype=torch.int32, device=device)

    def _gather_levels(self, embeddings, xT) -> torch.Tensor:
        """Gather + trilinear blend level by level -> [B, L, C] (f32); the
        rows and weights of one level at a time."""
        outs = []
        for lvl in range(self.num_levels):
            pos_grid, w8 = self._level_corners(xT, lvl)
            vals = embeddings[self._level_rows(pos_grid, lvl)]   # [2^D, B, C]
            outs.append((w8[..., None] * vals.float()).sum(0))
        return torch.stack(outs, dim=1)

    def encode(self, embeddings: torch.Tensor, x: torch.Tensor,
               bound: float = 1.0) -> torch.Tensor:
        """Positions [B, D] -> [B, L, C] f32 features, zero outside the
        box, with no residuals: kernel H on CUDA, the plain gather on the
        CPU."""
        if embeddings.is_cuda or x.is_cuda:
            return grid_encoder_fwd_cuda(self, embeddings, x, bound)
        xT, oob = self._unit_positions(x, bound)
        out = self._gather_levels(embeddings, xT)
        return torch.where(oob[:, None, None], 0.0, out)

    def __call__(self, embeddings: torch.Tensor, inputs: torch.Tensor,
                 bound: float = 1.0) -> torch.Tensor:
        """Encode positions in [-bound, bound] -> [..., L*C] features."""
        prefix = inputs.shape[:-1]
        x = inputs.reshape(-1, self.input_dim).float().contiguous()
        if self.differentiable_inputs:
            # plain autograd: the gather's transpose is the table gradient,
            # and the weights carry d/d(position)
            xT, oob = self._unit_positions(x, bound)
            out = self._gather_levels(embeddings, xT)
        elif not (torch.is_grad_enabled() and embeddings.requires_grad):
            return self.encode(embeddings, x, bound).reshape(
                *prefix, self.output_dim)
        else:
            consts = _level_consts(self, embeddings.device)
            with torch.no_grad():
                if consts.hashed:
                    xT, oob = self._unit_positions(x, bound)
                    saved = (xT.t(),)
                else:
                    base_all, w_all, oob = self.residuals(x, bound)
                    saved = (base_all, w_all)
            out = _EncodeLevels.apply(embeddings, x, bound, self, consts,
                                      *saved)
        # zero outside the box; with a custom backward this also zeroes
        # those samples' cotangent, which the backward kernels then skip
        out = torch.where(oob[:, None, None], 0.0, out)
        return out.reshape(*prefix, self.output_dim)


class _LevelConsts:
    """Per-device constants of one spec: kernels E and H's [L, 8] table
    (``rows_level_table``) for every spec; for a spec whose levels are all
    affine also kernel A's [L, 10] table (``level_table``) and its corner
    offsets as tensors, which are None where a level hashes."""

    def __init__(self, spec: GridEncoderSpec, device: torch.device):
        self.rows_table = spec.rows_level_table(device)
        self.total = spec.table_size
        self.hashed = any(spec.hashed_levels)
        self.table = self.sizes = self.offsets = self.corner_offs = None
        if not self.hashed:
            self.table = spec.level_table(device)
            self.sizes = self.table[:, 0].long()
            self.offsets = self.table[:, 1].long()
            self.corner_offs = self.table[:, 2:].long()     # [L, 8]


_CONSTS: Dict[Tuple[GridEncoderSpec, str], _LevelConsts] = {}


def _level_consts(spec: GridEncoderSpec, device: torch.device) -> _LevelConsts:
    key = (spec, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = _LevelConsts(spec, device)
    return _CONSTS[key]


def _corner_rows(consts: _LevelConsts, base_all: torch.Tensor, lvl: int):
    """[8, B] flat table rows of the 8 corners at level lvl."""
    base = base_all[lvl].long()
    return (base[None, :] + consts.corner_offs[lvl][:, None]) \
        % consts.sizes[lvl] + consts.offsets[lvl]


def grid_encoder_bwd_plain(base_all, w_all, cot, consts: _LevelConsts
                           ) -> torch.Tensor:
    """d_emb [T, C]: index_add_ of w_c * cot for the 8 corners per level."""
    L = base_all.shape[0]
    d = torch.zeros(consts.total, cot.shape[-1], device=cot.device,
                    dtype=torch.float32)
    for lvl in range(L):
        rows = _corner_rows(consts, base_all, lvl)
        for c in range(rows.shape[0]):
            d.index_add_(0, rows[c], w_all[lvl, c][:, None] * cot[:, lvl, :])
    return d


def grid_encoder_bwd_cuda(base_all, w_all, cot, consts: _LevelConsts
                          ) -> torch.Tensor:
    """Kernel A: same contract as grid_encoder_bwd_plain (C = 2, 8 corners)."""
    L, B = base_all.shape
    dev = base_all.device
    cuda.require(base_all, "base_all", torch.int32, (L, B))
    cuda.require(w_all, "w_all", torch.float32, (L, 8, B), dev)
    cuda.require(cot, "cot", torch.float32, (B, L, 2), dev)
    cuda.require(consts.table, "level table", torch.int32, (L, 10), dev)
    d = torch.zeros(consts.total, 2, device=dev, dtype=torch.float32)
    cuda.launch("grid_encoder_bwd", dev, base_all.data_ptr(), w_all.data_ptr(),
                cot.data_ptr(), consts.table.data_ptr(), d.data_ptr(), L, B)
    return d


def grid_encoder_bwd(base_all, w_all, cot, consts: _LevelConsts):
    if cot.is_cuda:
        return grid_encoder_bwd_cuda(base_all, w_all, cot, consts)
    return grid_encoder_bwd_plain(base_all, w_all, cot, consts)


# -- encoders with a hashed level: the residual is the unit positions -----------

def grid_encoder_bwd_rows_plain(rows, w_all, cot, total: int) -> torch.Tensor:
    """d_emb [T, C]: d_emb[rows[l, c, j]] += w_all[l, c, j] * cot[j, l] by
    index_add_ per level and corner, summed in f32 (the JAX package's f32
    ``.at[].add``, grid_encoder.py:268-272). With ``spec.corner_rows(x01)``
    it is kernel E's plain version."""
    d = torch.zeros(total, cot.shape[-1], device=cot.device,
                    dtype=torch.float32)
    for lvl in range(rows.shape[0]):
        for c in range(rows.shape[1]):
            d.index_add_(0, rows[lvl, c].long(),
                         w_all[lvl, c][:, None] * cot[:, lvl, :])
    return d


def grid_encoder_bwd_rows_cuda(spec: GridEncoderSpec, x01: torch.Tensor,
                               cot: torch.Tensor) -> torch.Tensor:
    """Kernel E: the table gradient [T, 2] of an encoder with a hashed level
    from the unit positions x01 [B, 3] and the cotangent cot [B, L, 2], all
    levels in one launch; same contract as grid_encoder_bwd_rows_plain on
    spec.corner_rows(x01)."""
    B, L = x01.shape[0], spec.num_levels
    dev = x01.device
    cuda.require(x01, "x01", torch.float32, (B, 3))
    cuda.require(cot, "cot", torch.float32, (B, L, 2), dev)
    if spec.input_dim != 3 or spec.level_dim != 2:
        raise ValueError("kernel E takes 3-D positions and 2 features a level")
    d = torch.zeros(spec.table_size, 2, device=dev, dtype=torch.float32)
    cuda.launch("grid_encoder_bwd_rows", dev, x01.data_ptr(), cot.data_ptr(),
                _level_consts(spec, dev).rows_table.data_ptr(), d.data_ptr(),
                L, B)
    return d


def grid_encoder_bwd_rows(spec: GridEncoderSpec, x01, cot):
    if cot.is_cuda:
        return grid_encoder_bwd_rows_cuda(spec, x01, cot)
    return grid_encoder_bwd_rows_plain(*spec.corner_rows(x01), cot,
                                       spec.table_size)


class _EncodeLevels(torch.autograd.Function):
    """emb [T, C], positions x [B, D] and the backward's residuals ->
    [B, L, C] by ``spec.encode``. The residuals are kernel A's inputs
    base_all [L, B] and w_all [L, 8, B] when every level is affine, else
    the unit positions x01 [B, D] alone, from which kernel E forms the
    corners (the rows and weights of the forward's gather are never
    kept)."""

    @staticmethod
    def forward(ctx, emb, x, bound, spec, consts, *residuals):
        ctx.save_for_backward(*residuals)
        ctx.spec, ctx.consts, ctx.emb_dtype = spec, consts, emb.dtype
        return spec.encode(emb, x, bound)

    @staticmethod
    def backward(ctx, cot):
        residuals = ctx.saved_tensors
        cot = cot.float().contiguous()
        if ctx.consts.hashed:
            d = grid_encoder_bwd_rows(ctx.spec, *residuals, cot)
        else:
            d = grid_encoder_bwd(*residuals, cot, ctx.consts)
        return (d.to(ctx.emb_dtype), None, None, None, None,
                *(None for _ in residuals))


# -- kernel H: the forward of every spec, all levels in one launch ------------

def grid_encoder_fwd_cuda(spec: GridEncoderSpec, emb: torch.Tensor,
                          x: torch.Tensor, bound: float) -> torch.Tensor:
    """Kernel H: features [B, L, 2] f32 of positions x [B, 3] f32 in
    [-bound, bound] from the table emb [T, 2] (f32 or bf16), zero outside
    the box; same contract as spec.encode on the CPU (the plain gather and
    blend, _gather_levels)."""
    B, L = x.shape[0], spec.num_levels
    dev = x.device
    if spec.input_dim != 3 or spec.level_dim != 2:
        raise ValueError("kernel H takes 3-D positions and 2 features a level")
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel H reads an f32 or bf16 table, got {emb.dtype}")
    cuda.require(x, "x", torch.float32, (B, 3))
    cuda.require(emb, "table", emb.dtype, (spec.table_size, 2), dev)
    out = torch.empty(B, L, 2, device=dev, dtype=torch.float32)
    cuda.launch("grid_encoder_fwd", dev, x.data_ptr(), emb.data_ptr(),
                int(emb.dtype == torch.bfloat16),
                _level_consts(spec, dev).rows_table.data_ptr(),
                out.data_ptr(), bound, 2.0 * bound, L, B)
    return out
