"""Block-partitioned Shampoo with Adagrad grafting (counterpart of
dreamfusion_tpu/training/shampoo.py; reference optimizer.py).

Every parameter of at least one dimension is cut into blocks of at most
``block_size`` along each axis. Each block keeps one statistic per axis,
G_a = sum g g^T contracted over the other axes (unweighted sums: the JAX
package's beta2 = 1.0), and its preconditioners P_a = G_a^(-1/p), p = 2 x
ndim, from a coupled Newton iteration. A block's step is g contracted with
each P_a along its leading axis in turn, as JAX's
``tensordot(out, P, ((0,), (0,)))`` contracts it: P_0^T g P_1 for a matrix.
The leaf's step takes the norm of the Adagrad step g / (sqrt(diag) +
1e-12), where diag already holds this step's g^2 (grafting); scalars take
the Adagrad step alone. Nesterov momentum: m = beta1 m + u, step = beta1 m
+ u, and the parameter moves by -lr step.

The preconditioners refresh when count <= 1 or count % every == 0, count
being the 1-based count after this step's increment; the learning rate of
a step is schedule(count) with the same count (``build_optimizer`` shifts
its LambdaLR by one for that, where Adam's follows optax's 0-based count).

The matrix products are plain batched products, as the JAX package leaves
them to XLA: the blocks of a leaf that share a shape are stacked into [B,
n, n] and go through ``torch.bmm`` together (the -O table's 903,480 x 2
rows make 7,058 blocks of 128 x 2 and one ragged block of 56 x 2), in f32
with TF32 off.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import List, Tuple

import torch

NEWTON_ITERS = 20
RIDGE_EPS = 1e-6
GRAFT_EPS = 1e-12


def _matrix_power(a: torch.Tensor, n: int) -> torch.Tensor:
    """a^n (n >= 1) by squaring, in jnp.linalg.matrix_power's order."""
    if n == 1:
        return a
    if n == 2:
        return a @ a
    if n == 3:
        return (a @ a) @ a
    z = result = None
    while n > 0:
        z = a if z is None else z @ z
        n, bit = divmod(n, 2)
        if bit:
            result = z if result is None else result @ z
    return result


def matrix_inverse_pth_root(A: torch.Tensor, p: int,
                            num_iters: int = NEWTON_ITERS,
                            ridge_epsilon: float = RIDGE_EPS) -> torch.Tensor:
    """A^(-1/p) for symmetric PSD A [..., n, n] by the coupled Newton
    iteration (shampoo.py:26-56): the trace-normalised A plus a ridge, the
    iteration started at z = 1 / ||A||_F, the trace scale undone at the
    end."""
    A = A.float()
    n = A.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=A.device)
    tr = torch.clamp(A.diagonal(dim1=-2, dim2=-1).sum(-1) / n, min=1e-30)
    A = A / tr[..., None, None] + ridge_epsilon * eye
    alpha = -1.0 / p
    z = 1.0 / torch.clamp(torch.sqrt((A * A).sum((-2, -1))), min=1e-30)
    X = torch.pow(z, -alpha)[..., None, None] * eye
    M = z[..., None, None] * A
    for _ in range(num_iters):
        T = (1.0 - alpha) * eye + alpha * M
        X = X @ T
        M = _matrix_power(T, p) @ M
    return X / torch.pow(tr, -alpha)[..., None, None]


Region = Tuple[Tuple[slice, int, int], ...]   # per axis: (slice, blocks, size)


def block_regions(shape, block_size: int) -> List[Region]:
    """The blocks of a leaf (shampoo.py:59-60, 85-93), grouped by shape:
    along each axis the full blocks, then the ragged rest; each combination
    is one region of equal blocks."""
    per_axis = []
    for dim in shape:
        full = dim // block_size
        opts = []
        if full:
            opts.append((slice(0, full * block_size), full, block_size))
        if dim % block_size:
            opts.append((slice(full * block_size, dim), 1, dim % block_size))
        per_axis.append(opts)
    return list(itertools.product(*per_axis))


def _to_blocks(x: torch.Tensor, region: Region) -> torch.Tensor:
    """x[region] -> [B, *block] (its blocks stacked)."""
    d = len(region)
    y = x[tuple(r[0] for r in region)]
    y = y.reshape([v for r in region for v in (r[1], r[2])])
    y = y.permute(*range(0, 2 * d, 2), *range(1, 2 * d, 2))
    return y.reshape(-1, *(r[2] for r in region))


def _from_blocks(y: torch.Tensor, region: Region) -> torch.Tensor:
    """Inverse of _to_blocks: [B, *block] -> the region's [*shape]."""
    d = len(region)
    y = y.reshape(*(r[1] for r in region), *(r[2] for r in region))
    y = y.permute(*(v for a in range(d) for v in (a, d + a)))
    return y.reshape([r[1] * r[2] for r in region])


def _axis_stats(y: torch.Tensor, axis: int) -> torch.Tensor:
    """[B, *block] -> [B, n_a, n_a]: y contracted with itself over every
    block axis but `axis`."""
    m = y.movedim(axis + 1, 1).reshape(y.shape[0], y.shape[axis + 1], -1)
    return torch.bmm(m, m.transpose(1, 2))


def _precondition(y: torch.Tensor, precond: List[torch.Tensor]) -> torch.Tensor:
    """Contract the leading block axis of y with P_a, axis after axis; the
    axes cycle back to their order (shampoo.py:124-128)."""
    B = y.shape[0]
    for P in precond:
        rest = y.shape[2:]
        m = y.reshape(B, y.shape[1], -1).transpose(1, 2)
        y = torch.bmm(m, P).reshape(B, *rest, P.shape[-1])
    return y


@contextlib.contextmanager
def _no_tf32():
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


class Shampoo(torch.optim.Optimizer):
    """torch.optim form of the JAX package's ``shampoo`` (shampoo.py:67-171)
    with its defaults (Adagrad grafting, Nesterov, refresh from count 1).
    ``lr`` is the group's learning rate at the step (its scheduler sets it
    to schedule(count), see the module docstring)."""

    def __init__(self, params, lr: float, block_size: int = 128,
                 beta1: float = 0.9, update_preconditioner_every: int = 10):
        super().__init__(params, dict(lr=lr, block_size=block_size,
                                      beta1=beta1,
                                      every=update_preconditioner_every))

    def _init_state(self, p: torch.Tensor, block_size: int):
        state = self.state[p]
        state["step"] = 0
        state["momentum"] = torch.zeros_like(p)
        state["diag"] = torch.zeros_like(p)
        stats, precond = [], []
        for region in (block_regions(p.shape, block_size) if p.ndim else []):
            B = 1
            for r in region:
                B *= r[1]
            stats.append([torch.zeros(B, r[2], r[2], device=p.device)
                          for r in region])
            precond.append([torch.eye(r[2], device=p.device).expand(
                B, r[2], r[2]).clone() for r in region])
        state["stats"], state["precond"] = stats, precond

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Shampoo.step takes no closure")
        with _no_tf32():
            for group in self.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        self._step_param(p, p.grad, group)

    def _step_param(self, p, g, group):
        state = self.state[p]
        if not state:
            self._init_state(p, group["block_size"])
        count = state["step"] + 1
        state["step"] = count
        refresh = count <= 1 or count % group["every"] == 0
        diag = state["diag"]
        diag.add_(g * g)
        graft = g / (torch.sqrt(diag) + GRAFT_EPS)
        if p.ndim == 0:
            u = graft
        else:
            pre = torch.empty_like(g)
            regions = block_regions(p.shape, group["block_size"])
            for region, stats, precond in zip(regions, state["stats"],
                                              state["precond"]):
                y = _to_blocks(g, region)
                for a, s in enumerate(stats):
                    s.add_(_axis_stats(y, a))
                if refresh:
                    precond[:] = [matrix_inverse_pth_root(s, 2 * p.ndim)
                                  for s in stats]
                pre[tuple(r[0] for r in region)] = _from_blocks(
                    _precondition(y, precond), region)
            g_norm = torch.linalg.vector_norm(graft)
            p_norm = torch.clamp(torch.linalg.vector_norm(pre), min=1e-16)
            u = pre * (g_norm / p_norm)
        b1 = group["beta1"]
        mom = state["momentum"]
        mom.mul_(b1).add_(u)
        p.add_((b1 * mom + u) * -group["lr"])
