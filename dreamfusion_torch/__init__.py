"""dreamfusion_torch: the PyTorch / CUDA (Hopper) port of dreamfusion_tpu.

The module layout mirrors ``dreamfusion_tpu`` so each part has an obvious
counterpart there. This package imports torch and numpy only; the JAX
package is its reference in the parity tests and nowhere else.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit ``cpu`` they raise
(``dreamfusion_torch.device.resolve_device``).
"""

from dreamfusion_torch.device import resolve_device

__all__ = ["resolve_device"]
