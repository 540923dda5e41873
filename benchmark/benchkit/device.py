"""The card a run uses, and its published peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
float32 outside them, 3.35 TB/s of HBM3. A share of a peak is stated
against these, with the card's power limit beside it (``describe``)."""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict, Optional

import torch

H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def require_cards(n: int) -> Optional[str]:
    """None when n CUDA devices are there, else why not."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark runs on a GPU"
    if torch.cuda.device_count() < n:
        return (f"the cell asks for {n} GPUs and torch sees "
                f"{torch.cuda.device_count()}")
    return None


def power_limit_w() -> Optional[float]:
    """The card's power limit from nvidia-smi (None where it cannot be read)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(count: int, peak_bytes: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes),
            "power_limit_w": power_limit_w()}


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / H100_BYTES_PER_S)
