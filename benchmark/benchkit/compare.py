"""The numbers that decide a training cell's `correct`.

Per leaf (parameter) the program's norm and the reference's are compared
as a gap of norms, |‖program‖ - ‖reference‖|, over the larger of the
reference's norm of that leaf and of the median leaf (some gradients are
all but zero). The worst leaf is the number compared. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone: they are left out of the change (``moving``)."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def worst_gap(prog: Dict[str, float], ref: Dict[str, float],
              keys: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(worst relative gap of norms, its leaf); a leaf the program has
    no reading of (no optimizer state: it never moved) reads 0."""
    keys = list(keys if keys is not None else ref)
    med = statistics.median(ref[k] for k in ref)
    worst, leaf = 0.0, ""
    for k in keys:
        gap = abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


def moving(ref_grads: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= 1e-3 * med]


def leaf_gaps(prog: Dict, ref: Dict) -> Dict[str, List[float]]:
    """Each leaf's gap of first-gradient norms, of change norms, and its
    reference gradient's norm (for calibration)."""
    med_g = statistics.median(ref["grads"].values())
    med_c = statistics.median(ref["change"].values())
    return {k: [abs(prog["grads"].get(k, 0.0) - ref["grads"][k])
                / max(ref["grads"][k], med_g),
                abs(prog["change"].get(k, 0.0) - ref["change"][k])
                / max(ref["change"][k], med_c), ref["grads"][k]]
            for k in ref["grads"]}


def train_readings(prog: Dict, ref: Dict,
                   loss_scales: Optional[List[float]] = None
                   ) -> Dict[str, float]:
    """The numbers a training cell compares: the worst checked step's loss
    gap (over the reference loss's size, or over `loss_scales`), the worst
    leaf's gap of first-gradient norms and of change norms (the change over
    the leaves that move)."""
    scales = loss_scales or [abs(r) for r in ref["losses"]]
    loss = max(abs(p - r) / max(s, 1e-30) for p, r, s in
               zip(prog["losses"], ref["losses"], scales))
    grad, _ = worst_gap(prog["grads"], ref["grads"])
    change, _ = worst_gap(prog["change"], ref["change"], moving(ref["grads"]))
    return {"loss_gap": loss, "grad_norm_gap": grad,
            "change_norm_gap": change}
