"""Small-table probe gather (counterpart of
dreamfusion_tpu/ops/pallas_probe.py).

``probe_select_small(table_u8, flat_idx)`` returns ``table_u8[flat_idx]``
for a u8 table of at most ``MAX_ROWS`` x 128 entries: the staged eval's
classify pass probes the pooled occupancy grid (32^3 cells) with it at
every coarse lattice point of the frame. On a CUDA tensor it launches
kernel D (csrc/probe_select.cu, the table staged in shared memory); on a
CPU tensor it runs ``probe_select_small_plain``, the element gather, which
is also what the kernel is held against on the card.

The values come back as u8 (the caller tests ``!= 0``); the TPU kernel's
f32 output was a layout convenience of its one-hot matmul.
"""

from __future__ import annotations

import torch

from dreamfusion_torch.ops import cuda

MAX_ROWS = 512           # pallas_probe._MAX_ROWS: tables of <= 512 x 128


def fits(table_size: int) -> bool:
    """Whether a table of this many entries takes the probe kernel (the JAX
    package's routing condition, marching.py:350-352)."""
    return table_size % 128 == 0 and table_size // 128 <= MAX_ROWS


def probe_select_small_plain(table_u8: torch.Tensor,
                             flat_idx: torch.Tensor) -> torch.Tensor:
    """table_u8 [T] u8, flat_idx [J] int in [0, T) -> [J] u8."""
    return table_u8[flat_idx.long()]


def probe_select_small_cuda(table_u8: torch.Tensor,
                            flat_idx: torch.Tensor) -> torch.Tensor:
    """Kernel D: same contract as probe_select_small_plain, int32 indices."""
    T, J = table_u8.shape[0], flat_idx.shape[0]
    if not fits(T):
        raise ValueError(f"table of {T} entries: the probe kernel takes a "
                         f"multiple of 128 up to {MAX_ROWS * 128}")
    cuda.require(table_u8, "table_u8", torch.uint8, (T,))
    cuda.require(flat_idx, "flat_idx", torch.int32, (J,), table_u8.device)
    if table_u8.data_ptr() % 16:
        table_u8 = table_u8.clone()
    if flat_idx.data_ptr() % 16:          # the kernel reads 4 ids at a time
        flat_idx = flat_idx.clone()
    out = torch.empty(J, dtype=torch.uint8, device=table_u8.device)
    cuda.launch("probe_select", table_u8.device, table_u8.data_ptr(),
                flat_idx.data_ptr(), out.data_ptr(), T, J)
    return out


def probe_select_small(table_u8: torch.Tensor,
                       flat_idx: torch.Tensor) -> torch.Tensor:
    if table_u8.is_cuda:
        return probe_select_small_cuda(table_u8, flat_idx)
    return probe_select_small_plain(table_u8, flat_idx)
