"""The controls' lower precision: float8 e4m3 with one scale a tensor (its
largest magnitude onto e4m3's 448), the step below bf16. A control is the
reference computed this way in the program's place (PERF.md §2)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3, in x's type; the gradient passes straight
    through."""
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / 448.0
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float()
         * scale).to(x.dtype)
    return x + (q - x).detach()


def fp8_mlp(mlp) -> None:
    """A field MLP (dfref.models.networks.MLP) computed in float8: each
    layer fed its weight and its input rounded."""

    def forward(x, mlp=mlp):
        x = x.float()
        for i in range(mlp.num_layers):
            lin = getattr(mlp, f"dense_{i}")
            x = F.linear(fp8(x), fp8(lin.weight), lin.bias)
            if i != mlp.num_layers - 1:
                x = F.relu(x)
        return x

    mlp.forward = forward


def fp8_linears(module: torch.nn.Module) -> None:
    """Every Linear of a trained module (the DVGO rgbnet) computed in
    float8: its weight and its input rounded at each call, the gradient
    passing straight through to the float32 weight."""
    for m in module.modules():
        if isinstance(m, torch.nn.Linear):
            m.forward = (lambda x, lin=m:
                         F.linear(fp8(x), fp8(lin.weight), lin.bias))


def fp8_module(module: torch.nn.Module) -> None:
    """Every Linear / Conv2d of the module computed in float8: its weight
    rounded once, its input rounded at each call."""
    for m in module.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            with torch.no_grad():
                m.weight.copy_(fp8(m.weight))
            m.register_forward_pre_hook(
                lambda _m, args: (fp8(args[0]),) + tuple(args[1:]))


def fp8_field(model) -> None:
    """The grid field computed in float8: its table rounded once, and its
    MLPs (sigma_net, bg_net) as fp8_mlp."""
    with torch.no_grad():
        model.embeddings.copy_(fp8(model.embeddings))
    for mlp in (model.sigma_net, model.bg_net):
        if mlp is not None:
            fp8_mlp(mlp)
