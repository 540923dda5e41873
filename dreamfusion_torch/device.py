"""Device selection for the port's entry points.

The port runs on the GPU. The CPU is used only when a caller asks for it by
name (the parity tests do); a missing GPU is an error, never a quiet
fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None or "cuda" -> the current CUDA device (raises without a GPU);
    "cpu" -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dreamfusion_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' (or --device cpu) to run the plain PyTorch "
            "path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
