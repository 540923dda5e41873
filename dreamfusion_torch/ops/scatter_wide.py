"""Row scatter-add of narrow rows (counterpart of
dreamfusion_tpu/ops/pallas_scatter.py::matmul_scatter_add_wide).

``scatter_add_wide(idx, upd, T)`` returns ``zeros([T, C]).at[idx].add(upd)``
in f32 for ``upd [J, C]``: the staged eval's compact compositor
(``marching.composite_compact``) sums its per-sample weights, depth, colour
and live flags into per-ray rows with it. On a CUDA tensor it launches
kernel C (csrc/scatter_wide.cu: warp-level run sums, one atomic per run and
channel); on a CPU tensor it runs ``scatter_add_wide_plain``
(``index_add_``), which is also what the kernel is held against on the card.

The TPU kernel does the scatter as a one-hot matmul on the MXU and rounds
the updates to bf16; the port sums in f32, as the JAX package's own
off-TPU path (``.at[].add``) does.
"""

from __future__ import annotations

import ctypes

import torch

from dreamfusion_torch.ops import cuda

CHANNELS = 6                # [w, w*t, w*r, w*g, w*b, live]


def scatter_add_wide_plain(idx: torch.Tensor, upd: torch.Tensor,
                           T: int) -> torch.Tensor:
    """idx [J] int in [0, T), upd [J, C] f32 -> [T, C] f32 row sums."""
    out = torch.zeros(T, upd.shape[1], device=upd.device, dtype=torch.float32)
    return out.index_add_(0, idx.long(), upd.float())


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    lib = cuda.library("scatter_wide")
    if not getattr(lib, "_typed", False):
        lib.scatter_add_wide.argtypes = [_VP, _VP, _VP, _LL, _I, _VP]
        lib.scatter_add_wide.restype = _I
        lib._typed = True
    return lib


def scatter_add_wide_cuda(idx: torch.Tensor, upd: torch.Tensor,
                          T: int) -> torch.Tensor:
    """Kernel C: same contract as scatter_add_wide_plain, int32 ids and
    the compositor's CHANNELS channels."""
    J = upd.shape[0]
    cuda.require(upd, "upd", torch.float32, (J, CHANNELS))
    cuda.require(idx, "idx", torch.int32, (J,), upd.device)
    out = torch.zeros(T, CHANNELS, device=upd.device, dtype=torch.float32)
    err = _lib().scatter_add_wide(idx.data_ptr(), upd.data_ptr(),
                                  out.data_ptr(), J, T,
                                  cuda.stream_ptr(upd.device))
    cuda.check_launch(err, "scatter_add_wide")
    cuda.launch_counts["scatter_add_wide"] += 1
    return out


def scatter_add_wide(idx: torch.Tensor, upd: torch.Tensor,
                     T: int) -> torch.Tensor:
    if upd.is_cuda:
        return scatter_add_wide_cuda(idx, upd, T)
    return scatter_add_wide_plain(idx, upd, T)
