"""Optimizer and LR-schedule factory for the DVGO module training stack
(counterpart of dreamfusion_tpu/training/schedules.py; reference
frameworks/nerf/modules/lightning_base.py:36-76).

- optimizers: SGD (momentum 0.9, nesterov) and Adam, each after an
  additive weight decay (optax's ``add_decayed_weights`` before the
  optimizer: g + wd * p), at params['max_lr'];
- schedules, all per step and read at the optimizer's 0-based step count,
  as optax reads them:
    ExpLR_step      lr * step_decay ** step
    StepLR_step     lr * step_decay ** floor(step / decay_steps)
    StepAutoLR_step lr * 0.1 ** floor(step / int(0.8 * steps_per_epoch))
    OneCycLR        optax.cosine_onecycle_schedule (pct_start 0.3,
                    div_factor 25, final_div_factor 1e4) over
                    (steps_per_epoch + 1) * num_epochs steps
  Unknown names give a constant lr (the reference prints "lr_scheduler not
  found!" and returns None).

The formulas are optax's, written out: torch's OneCycleLR and StepLR give
other values (OneCycleLR anneals from its own initial lr at other
boundaries). ``make_module_optimizer`` returns a ModuleOptimizer whose
``step(params, grads)`` updates the parameters in place.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

_DEFAULTS = dict(optimizer="Adam", lr_scheduler="ExpLR_step",
                 step_decay=0.9999, decay_steps=1000, steps_per_epoch=0,
                 num_epochs=1, max_lr=0.1, weight_decay=5e-4)


def _exponential_decay(init: float, transition_steps: int, rate: float):
    """optax.exponential_decay(staircase=True)."""
    return lambda step: init * rate ** math.floor(step / transition_steps)


def _cosine_onecycle(transition_steps: int, peak_value: float,
                     pct_start: float = 0.3, div_factor: float = 25.0,
                     final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule, optax's piecewise form written out:
    the values peak / div_factor, peak, peak / (div_factor *
    final_div_factor) at steps 0, int(pct_start * T) and T, cosine
    interpolation between them, the last value from T on."""
    bounds = np.array([0, int(pct_start * transition_steps),
                       int(transition_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    sizes = bounds[1:] - bounds[:-1]

    def sched(step):
        with np.errstate(divide="ignore", invalid="ignore"):
            inside = (bounds[:-1] <= step) & (step < bounds[1:])
            pct = (step - bounds[:-1]) / sizes
            start, end = values[:-1], values[1:]
            interp = end - (end - start) / 2.0 * (np.cos(np.pi * pct) + 1.0)
            return float(inside.dot(interp)
                         + (bounds[-1] <= step) * values[-1])

    return sched


def make_lr_schedule(params: Dict) -> Callable[[int], float]:
    p = {**_DEFAULTS, **params}
    max_lr = p["max_lr"]
    name = p["lr_scheduler"]
    if name == "ExpLR_step":
        return lambda step: max_lr * p["step_decay"] ** step
    if name == "StepLR_step":
        return _exponential_decay(max_lr, p["decay_steps"], p["step_decay"])
    if name == "StepAutoLR_step":
        size = max(int(p["steps_per_epoch"] * 0.8), 1)
        return _exponential_decay(max_lr, size, 0.1)
    if name == "OneCycLR":
        total = (p["steps_per_epoch"] + 1) * p["num_epochs"]
        return _cosine_onecycle(max(total, 1), max_lr)
    return lambda step: max_lr  # reference: scheduler None -> constant lr


class ModuleOptimizer:
    """add_decayed_weights, then SGD (momentum 0.9, nesterov) or Adam
    (0.9, 0.999, eps 1e-8), at the schedule of the 0-based step count."""

    def __init__(self, kind: str, sched: Callable[[int], float],
                 weight_decay: float):
        self.kind, self.sched, self.wd = kind, sched, weight_decay
        self.count = 0
        self.state: List[Dict[str, torch.Tensor]] = []

    @torch.no_grad()
    def step(self, params: Iterable[torch.Tensor],
             grads: Iterable[torch.Tensor]) -> None:
        params, grads = list(params), list(grads)
        if not self.state:
            self.state = [{"m": torch.zeros_like(p), "v": torch.zeros_like(p)}
                          for p in params]
        lr = self.sched(self.count)
        self.count += 1
        for p, g, st in zip(params, grads, self.state):
            g = g + self.wd * p
            if self.kind == "SGD":     # optax.trace(0.9, nesterov=True)
                st["m"] = g + 0.9 * st["m"]
                u = g + 0.9 * st["m"]
            else:
                st["m"] = 0.1 * g + 0.9 * st["m"]
                st["v"] = 0.001 * g * g + 0.999 * st["v"]
                m_hat = st["m"] / (1.0 - 0.9 ** self.count)
                v_hat = st["v"] / (1.0 - 0.999 ** self.count)
                u = m_hat / (torch.sqrt(v_hat) + 1e-8)
            p.add_(-lr * u)


def make_module_optimizer(params: Dict) -> ModuleOptimizer:
    """choose_optimizer + choose_scheduler composed into one optimizer."""
    p = {**_DEFAULTS, **params}
    if p["optimizer"] not in ("SGD", "Adam"):
        raise AssertionError("optimizer not implemented")  # lightning_base.py:45
    return ModuleOptimizer(p["optimizer"], make_lr_schedule(p),
                           p["weight_decay"])
