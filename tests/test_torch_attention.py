"""The port's attention (dreamfusion_torch.guidance.sd.layers.attention_core
and ops.flash_attention) against the JAX package's attention_core, on the
CPU, and the flash kernels' tiled algorithm emulated in float64.

The JAX side runs its einsum branch, as it does off the TPU; the stock
Pallas flash kernel that its flash branch reaches runs only on a TPU. The
CUDA kernels themselves are held against ``attention_plain`` on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance.sd import layers as jlayers

from dreamfusion_torch.guidance.sd import layers as tlayers
from dreamfusion_torch.ops import flash_attention as fa


def _qkv(B, N, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, N, H, D)).astype(np.float32) * m
            for m in (2.0, 1.0, 1.0)]


@pytest.mark.parametrize("shape", [(1, 2048, 2, 8), (2, 512, 1, 24)])
def test_attention_plain_matches_jax(shape):
    """Values and the vjp of q, k, v against the JAX einsum branch, f32;
    1e-5 of the largest entry (sums over N in another order)."""
    B, N, H, D = shape
    q, k, v = _qkv(B, N, H, D, seed=N)
    g = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    scale = 1.0 / math.sqrt(D)

    out_j, vjp = jax.vjp(lambda a, b, c: jlayers.attention_core(
        a, b, c, scale, jnp.float32, impl="einsum"), q, k, v)
    grads_j = vjp(jnp.asarray(g))

    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out_t = fa.flash_attention(qt, kt, vt, scale)       # CPU: the plain path
    grads_t = torch.autograd.grad(out_t, (qt, kt, vt), torch.from_numpy(g))
    for a, b in zip((out_t, *grads_t), (out_j, *grads_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("Nq,Nk,dtype,flash", [
    (4096, 4096, torch.bfloat16, True),     # UNet / VAE self-attention at 64^2
    (2048, 2048, torch.bfloat16, True),
    (4096, 77, torch.bfloat16, False),      # cross-attention
    (1024, 1024, torch.bfloat16, False),    # below the JAX threshold
    (2560, 2560, torch.bfloat16, True),
    (2304, 2304, torch.bfloat16, False),    # not a multiple of 512
    (4096, 4096, torch.float32, False),     # f32 stays on the einsum branch
])
def test_attention_routing_follows_jax_flash_branch(Nq, Nk, dtype, flash):
    """The port takes the kernels where the JAX package takes its flash
    branch (on the TPU), for bf16 inputs."""
    assert tlayers.use_flash(Nq, Nk, dtype) is flash
    assert flash is (jlayers._use_flash(Nq, Nk, impl="flash")
                     and dtype == torch.bfloat16)


def test_attention_core_flash_route_on_cpu_is_plain():
    """A bf16 self-attention at a flash shape takes flash_attention, whose
    CPU path is attention_plain (f32 scores); other shapes the einsum."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(1, 2048, 1, 16, seed=3))
    out = tlayers.attention_core(q, k, v, 0.25, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, fa.attention_plain(q, k, v, 0.25))


def _emulate_fwd(q, k, v, scale, BQ, BK):
    """The forward kernel's schedule for one head: query tiles of BQ rows,
    key tiles of BK with the ragged edge masked, a running base-2 max m and
    sum l, the output rescaled by exp2(m_old - m_new) per tile."""
    N, D = q.shape
    sl = scale / math.log(2.0)
    o = torch.zeros_like(q)
    lse = torch.zeros(N, dtype=q.dtype)
    for q0 in range(0, N, BQ):
        qt = q[q0:q0 + BQ]
        m = torch.full((qt.shape[0],), -math.inf, dtype=q.dtype)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for k0 in range(0, N, BK):
            s = (qt @ k[k0:k0 + BK].T) * sl
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.exp2(s - m_new[:, None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p @ v[k0:k0 + BK]
            m = m_new
        o[q0:q0 + BQ] = acc / l[:, None]
        lse[q0:q0 + BQ] = m + torch.log2(l)
    return o, lse


def _emulate_bwd(q, k, v, o, lse, do, scale, BQ, BK):
    """The backward kernels' schedule: delta = rowsum(do * o); dk, dv per
    key tile over all query tiles; dq per query tile over all key tiles;
    P recomputed from the base-2 lse."""
    N, _ = q.shape
    sl = scale / math.log(2.0)
    delta = (do * o).sum(-1)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))

    def tile(q0, k0):
        p = torch.exp2((q[q0:q0 + BQ] @ k[k0:k0 + BK].T) * sl
                       - lse[q0:q0 + BQ, None])
        dp = do[q0:q0 + BQ] @ v[k0:k0 + BK].T
        return p, p * (dp - delta[q0:q0 + BQ, None])

    for k0 in range(0, N, BK):
        for q0 in range(0, N, BQ):
            p, ds = tile(q0, k0)
            dv[k0:k0 + BK] += p.T @ do[q0:q0 + BQ]
            dk[k0:k0 + BK] += scale * ds.T @ q[q0:q0 + BQ]
    for q0 in range(0, N, BQ):
        for k0 in range(0, N, BK):
            _, ds = tile(q0, k0)
            dq[q0:q0 + BQ] += scale * ds @ k[k0:k0 + BK]
    return dq, dk, dv


@pytest.mark.parametrize("N,D,BQ,BK", [(200, 40, 64, 64), (96, 512, 32, 16),
                                       (130, 48, 32, 32)])
def test_flash_kernel_schedule_matches_plain(N, D, BQ, BK):
    """The kernels' tiling, online softmax, base-2 lse and two-pass backward
    give softmax attention and its gradient exactly (float64, 1e-10 of the
    largest entry), including a ragged last tile."""
    q, k, v = (torch.from_numpy(x[0, :, 0].astype(np.float64))
               for x in _qkv(1, N, 1, D, seed=D))
    do = torch.from_numpy(np.random.default_rng(2).normal(size=(N, D)))
    scale = 1.0 / math.sqrt(D)
    o, lse = _emulate_fwd(q, k, v, scale, BQ, BK)

    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref = fa.attention_plain(qr[None, :, None], kr[None, :, None],
                             vr[None, :, None], scale)[0, :, 0]
    refs = torch.autograd.grad(ref, (qr, kr, vr), do)
    got = (o, *_emulate_bwd(q, k, v, o, lse, do, scale, BQ, BK))
    for a, b in zip(got, (ref, *refs)):
        b = b.detach()
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())
