"""Differentiable trilinear 3-D grid sampling, align_corners=True
(counterpart of dreamfusion_tpu/ops/grid_sample.py).

Replaces torch's F.grid_sample as DVGO's grid sampler uses it
(frameworks/nerf/modules/dvgo_coarse.py:67-73). The plain version,
``grid_sample_3d_plain``, is written out as a gather of the 8 corners and a
blend, like the JAX module: the editing field's normal differentiates the
sample with respect to the position, which the reference had to patch in
(nerf/network.py:232-233). The JAX module reaches no Pallas kernel; this
one launches kernel G (``csrc/grid_sample.cu``: one-pass forward, atomic
grid backward that skips zero cotangents), which replaces autograd's
sort-based backward of the plain version's index (see the source's note).

``grid_sample_3d`` takes the kernels when the grid is a CUDA float32 tensor
and the position carries no gradient (``differentiable=False``, a position
that does not require grad, or grad mode off); else the plain version,
which is also the CPU path and the tests' oracle. Under torch's
deterministic mode the kernels' backward is replaced by an ordered
accumulation (``grid_sample_bwd_ordered``).

Convention: ``grid_sample_3d(grid [C, X, Y, Z], xyz01 [..., 3]) -> [..., C]``
with xyz01[..., i] in [0, 1] indexing axis i at xyz01 * (S_i - 1).
Out-of-range coordinates clamp to the border (DVGO masks out-of-box points
before sampling).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dreamfusion_torch.ops import cuda


def _corners(sizes: Sequence[int], x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx8 [8, B] int64 flat voxel indices, w8 [8, B] weights) of
    positions x [3, B]; w8 carries x's gradient."""
    hi = torch.tensor([s - 1.0 for s in sizes], device=x.device)[:, None]
    # maximum / minimum, not clamp: at a coordinate on the border they pass
    # half the position gradient, as jnp.clip does in the JAX package
    pos = torch.minimum(torch.maximum(x * hi, torch.zeros_like(hi)), hi)
    p0 = torch.floor(pos).detach()
    frac = pos - p0
    p0 = p0.long()
    strides = (sizes[1] * sizes[2], sizes[2], 1)

    idx_corners, w_corners = [], []
    for corner in range(8):
        w = torch.ones_like(frac[0])
        idx = torch.zeros_like(p0[0])
        for d in range(3):
            if (corner >> d) & 1:
                w = w * frac[d]
                idx = idx + torch.clamp(p0[d] + 1, max=sizes[d] - 1) * strides[d]
            else:
                w = w * (1.0 - frac[d])
                idx = idx + p0[d] * strides[d]
        idx_corners.append(idx)
        w_corners.append(w)
    return torch.stack(idx_corners), torch.stack(w_corners)


def grid_sample_3d_plain(grid: torch.Tensor, xyz01: torch.Tensor,
                         differentiable: bool = True) -> torch.Tensor:
    """grid [C, X, Y, Z]; xyz01 [..., 3] in [0, 1] -> [..., C].

    differentiable=True keeps d(out)/d(xyz01) (the editing field's autograd
    normal needs it); False detaches the position, so only the grid gets a
    gradient."""
    C = grid.shape[0]
    prefix = xyz01.shape[:-1]
    if not differentiable:
        xyz01 = xyz01.detach()
    x = xyz01.reshape(-1, 3).float().t()                       # [3, B]
    idx8, w8 = _corners(grid.shape[1:], x)                     # [8, B]
    flat = grid.reshape(C, -1).t()                                # [XYZ, C]
    out = (w8[..., None] * flat[idx8].float()).sum(0)
    return out.reshape(*prefix, C)


def _grid_dims(shape: Sequence[int]) -> Tuple[int, int, int, int]:
    if len(shape) != 4:
        raise ValueError(f"grid must be [C, X, Y, Z], got {tuple(shape)}")
    C, X, Y, Z = (int(s) for s in shape)
    if X * Y * Z >= 2 ** 31:
        raise ValueError(f"kernel G indexes a channel with int32: "
                         f"{X} x {Y} x {Z} voxels is too many")
    return C, X, Y, Z


def grid_sample_fwd_cuda(grid: torch.Tensor, x01: torch.Tensor
                         ) -> torch.Tensor:
    """Kernel G's forward: grid [C, X, Y, Z] f32, x01 [B, 3] f32 -> [B, C];
    grid_sample_3d_plain's values."""
    C, X, Y, Z = _grid_dims(grid.shape)
    B, dev = x01.shape[0], grid.device
    cuda.require(grid, "grid", torch.float32)
    cuda.require(x01, "x01", torch.float32, (B, 3), dev)
    out = torch.empty(B, C, device=dev, dtype=torch.float32)
    cuda.launch("grid_sample_fwd", dev, grid.data_ptr(), x01.data_ptr(),
                out.data_ptr(), C, X, Y, Z, B)
    return out


def grid_sample_bwd_cuda(x01: torch.Tensor, cot: torch.Tensor,
                         shape: Sequence[int]) -> torch.Tensor:
    """Kernel G's backward: the gradient [C, X, Y, Z] of a grid of `shape`
    from the positions x01 [B, 3] and the cotangent cot [B, C] (f32), by
    atomics; samples whose cotangent is 0.0 in every channel add nothing."""
    C, X, Y, Z = _grid_dims(shape)
    B, dev = x01.shape[0], x01.device
    cuda.require(x01, "x01", torch.float32, (B, 3))
    cuda.require(cot, "cot", torch.float32, (B, C), dev)
    d = torch.zeros(C, X, Y, Z, device=dev, dtype=torch.float32)
    cuda.launch("grid_sample_bwd", dev, x01.data_ptr(), cot.data_ptr(),
                d.data_ptr(), C, X, Y, Z, B)
    return d


def grid_sample_bwd_ordered(x01: torch.Tensor, cot: torch.Tensor,
                            shape: Sequence[int]) -> torch.Tensor:
    """The same gradient as grid_sample_bwd_cuda by torch's ordered
    index_put_ accumulation (deterministic on the card, as autograd's
    backward of the plain version's index), over the samples whose
    cotangent is not 0.0 in every channel: the deterministic-mode route."""
    C, sizes = shape[0], tuple(shape[1:])
    live = (cot != 0).any(-1)
    cot = cot[live]
    idx8, w8 = _corners(sizes, x01[live].t())
    d = torch.zeros(sizes[0] * sizes[1] * sizes[2], C, device=cot.device,
                    dtype=torch.float32)
    d.index_put_((idx8.reshape(-1),), (w8[..., None] * cot).reshape(-1, C),
                 accumulate=True)
    return d.t().contiguous().view(C, *sizes)


class _GridSample(torch.autograd.Function):
    """grid [C, X, Y, Z] f32, x01 [B, 3] f32 -> [B, C] by kernel G; the
    position is saved, the gradient goes to the grid alone."""

    @staticmethod
    def forward(ctx, grid, x01):
        ctx.save_for_backward(x01)
        ctx.shape = tuple(grid.shape)
        return grid_sample_fwd_cuda(grid, x01)

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        if not ctx.needs_input_grad[0]:
            return None, None
        (x01,) = ctx.saved_tensors
        cot = cot.float().contiguous()
        if torch.are_deterministic_algorithms_enabled():
            return grid_sample_bwd_ordered(x01, cot, ctx.shape), None
        return grid_sample_bwd_cuda(x01, cot, ctx.shape), None


def kernel_grid(grid: torch.Tensor) -> bool:
    """Whether kernel G takes this grid: a CUDA float32 tensor."""
    return grid.is_cuda and grid.dtype == torch.float32


def position_needs_grad(xyz01: torch.Tensor, differentiable: bool) -> bool:
    """Whether grid_sample_3d has to keep d(out)/d(xyz01): the written-out
    gather's route (the editing field's and OSR's autograd normals)."""
    return (differentiable and xyz01.requires_grad
            and torch.is_grad_enabled())


def grid_sample_3d(grid: torch.Tensor, xyz01: torch.Tensor,
                   differentiable: bool = True) -> torch.Tensor:
    """grid [C, X, Y, Z]; xyz01 [..., 3] in [0, 1] -> [..., C] (f32).

    differentiable=True keeps d(out)/d(xyz01) when the position requires
    grad; False detaches the position, so only the grid gets a gradient.
    Kernel G on a CUDA float32 grid whose position needs no gradient, else
    grid_sample_3d_plain."""
    if kernel_grid(grid) and not position_needs_grad(xyz01, differentiable):
        x = xyz01.detach().reshape(-1, 3).float().contiguous()
        out = _GridSample.apply(grid.contiguous(), x)
        return out.reshape(*xyz01.shape[:-1], grid.shape[0])
    return grid_sample_3d_plain(grid, xyz01, differentiable)


def resize_grid_trilinear(grid: torch.Tensor, new_size) -> torch.Tensor:
    """Trilinear re-interpolation of a [C, X, Y, Z] grid to (X', Y', Z'),
    align_corners=True: DVGO's progressive grid scaling
    (frameworks/nerf/modules/dvgo_fine.py:35-42)."""
    nx, ny, nz = new_size
    lin = [torch.linspace(0.0, 1.0, n, device=grid.device)
           for n in (nx, ny, nz)]
    pts = torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=-1)
    out = grid_sample_3d(grid, pts.reshape(-1, 3))                # [n, C]
    return out.t().reshape(grid.shape[0], nx, ny, nz)


def max_pool_3d(grid: torch.Tensor, ks: int = 3) -> torch.Tensor:
    """Same-padded max-pool (stride 1) over the spatial dims of
    [C, X, Y, Z] (MaskCache's F.max_pool3d,
    frameworks/nerf/modules/utils.py:22)."""
    return F.max_pool3d(grid[None], ks, stride=1, padding=ks // 2)[0]
