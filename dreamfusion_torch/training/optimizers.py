"""Optimizer and LR schedule (counterpart of
dreamfusion_tpu/training/optimizers.py; reference main.py:128-131).

Adam(betas=(b1, b2), eps) with two parameter groups: the grid encoder's
table at 10x the base LR (network_grid.py:170-181) and everything else at
the base LR, under the LambdaLR 0.1 ** min(step / iters, 1) stepped every
iteration. torch's Adam update m_hat / (sqrt(v_hat) + eps) is optax's.
Parameters under the model's ``frozen_prefixes`` (DVGO editing,
network.py:271-283) stop requiring a gradient and enter no group, where
the JAX package gives them optax ``set_to_zero``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def lambda_decay(iters: int):
    """0.1 ** min(step / iters, 1) (main.py:131)."""
    return lambda step: 0.1 ** min(step / iters, 1.0)


def build_optimizer(cfg, model: torch.nn.Module
                    ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    frozen = tuple(getattr(model, "frozen_prefixes", ()))
    enc, net = [], []
    for name, p in model.named_parameters():
        if frozen and name.startswith(frozen):
            p.requires_grad_(False)
            continue
        (enc if "embeddings" in name else net).append(p)
    groups = [{"params": net, "lr": cfg.lr},
              {"params": enc, "lr": cfg.lr * 10.0}]
    opt = torch.optim.Adam([g for g in groups if g["params"]],
                           betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda_decay(cfg.iters))
    return opt, sched
