"""Optimizer, LR schedule and parameter EMA (counterpart of
dreamfusion_tpu/training/optimizers.py; reference main.py:128-131).

Two parameter groups: the grid encoder's table at 10x the base LR
(network_grid.py:170-181) and everything else at the base LR, under the
LambdaLR 0.1 ** min(step / iters, 1) stepped every iteration. Parameters
under the model's ``frozen_prefixes`` (DVGO editing, network.py:271-283)
stop requiring a gradient and enter no group, where the JAX package gives
them optax ``set_to_zero``.

``cfg.optimizer``: "adam" is Adam(betas=(b1, b2), eps), whose update m_hat
/ (sqrt(v_hat) + eps) is optax's, at the schedule of optax's 0-based
count; "shampoo" is training/shampoo.py with beta1 = b1, at the schedule
of its 1-based count. The JAX package passes b2 to its shampoo() wrapper,
which does not forward it (optimizers.py:58, 75): its statistics are
unweighted sums, and so are the port's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dreamfusion_torch.training.shampoo import Shampoo

OPTIMIZERS = ("adam", "shampoo")


def lambda_decay(iters: int, offset: int = 0):
    """0.1 ** min((step + offset) / iters, 1) (main.py:131)."""
    return lambda step: 0.1 ** min((step + offset) / iters, 1.0)


def build_optimizer(cfg, model: torch.nn.Module
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer {cfg.optimizer!r}: choose from "
                         f"{', '.join(OPTIMIZERS)}")
    frozen = tuple(getattr(model, "frozen_prefixes", ()))
    enc, net = [], []
    for name, p in model.named_parameters():
        if frozen and name.startswith(frozen):
            p.requires_grad_(False)
            continue
        (enc if "embeddings" in name else net).append(p)
    groups = [g for g in ({"params": net, "lr": cfg.lr},
                          {"params": enc, "lr": cfg.lr * 10.0})
              if g["params"]]
    if cfg.optimizer == "shampoo":
        opt = Shampoo(groups, lr=cfg.lr, beta1=cfg.adam_b1)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda_decay(cfg.iters, offset=1))
    opt = torch.optim.Adam(groups, betas=(cfg.adam_b1, cfg.adam_b2),
                           eps=cfg.adam_eps)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda_decay(cfg.iters))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, in that order
    and with both factors rounded to f32 as the JAX package's f32 arithmetic
    takes them (optimizers.py:79-83; torch.lerp rounds otherwise)."""
    d, c = float(np.float32(decay)), float(np.float32(1.0 - decay))
    for k, e in ema.items():
        e.copy_(e * d + params[k].float() * c)
