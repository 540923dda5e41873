"""The port's attention (dreamfusion_torch.guidance.sd.layers.attention_core
and ops.flash_attention) against the JAX package's attention_core, on the
CPU, and the flash kernels' schedules emulated in float64.

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


def _box(x, r0, c0, rows, cols):
    """A rows x cols box of the matrix x at (r0, c0), zero past its ends:
    what a TMA load puts in shared memory."""
    t = x.new_zeros(rows, cols)
    part = x[r0:r0 + rows, c0:c0 + cols]
    t[:part.shape[0], :part.shape[1]] = part
    return t


def _gemm(a, b, M, ncols):
    """C [M, ncols] = A B as gemm_kernel walks it: 128 x 128 output tiles,
    64-deep K tiles, both operands zero past their ends; only the rows and
    columns < (M, ncols) are kept (stored)."""
    K = max(a.shape[1], b.shape[0])
    c = a.new_zeros(-(-M // 128) * 128, -(-ncols // 128) * 128)
    for m0 in range(0, M, 128):
        for n0 in range(0, ncols, 128):
            for k0 in range(0, K, 64):
                c[m0:m0 + 128, n0:n0 + 128] += (_box(a, m0, k0, 128, 64)
                                                @ _box(b, k0, n0, 64, 128))
    return c[:M, :ncols]


def _emulate_fwd_narrow(q, k, v, scale):
    """attn_fwd_narrow on one head: 64-row query tiles (one consumer
    warpgroup's), key tiles of 128 with the head padded to 64 by zeros and
    the ragged keys at -inf, a running base-2 max m and sum l, the output
    rescaled by exp2(m_old - m_new) per tile; o = O / l, lse = m + log2 l."""
    N, D = q.shape
    sl = scale / math.log(2.0)
    o, lse = torch.zeros_like(q), torch.zeros(N, dtype=q.dtype)
    for q0 in range(0, N, 64):
        qt = _box(q, q0, 0, 64, fa.NARROW_HEAD_DIM)
        m = torch.full((64,), -math.inf, dtype=q.dtype)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for k0 in range(0, N, 128):
            s = qt @ _box(k, k0, 0, 128, fa.NARROW_HEAD_DIM).T
            s[:, max(N - k0, 0):] = -math.inf
            m_new = torch.maximum(m, s.max(-1).values * sl)
            p = torch.exp2(s * sl - m_new[:, None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p @ _box(v, k0, 0, 128,
                                                  fa.NARROW_HEAD_DIM)
            m = m_new
        n = min(64, N - q0)
        o[q0:q0 + n] = (acc / l[:, None])[:n, :D]
        lse[q0:q0 + n] = (m + torch.log2(l))[:n]
    return o, lse


def _scratch(chunk, N, Np, dtype=torch.float64):
    """Scratch as torch.empty leaves it: NaN, so that an entry read before
    it is written shows in the result."""
    return torch.full((chunk, N, Np), math.nan, dtype=dtype)


def _emulate_fwd_wide(q, k, v, scale, scratch_bytes):
    """The wide heads' materialized forward over [B, N, H, D], (b, h) pairs
    in the wrapper's chunks: S = scale log2(e) Q K^T into f32 scratch
    [pairs, N, Np] (columns N..Np-1 at -inf), the row pass (lse, P =
    exp2(S - lse) into bf16 scratch, 0 past N), O = P V in 128-column tiles
    of the head (the column split of O)."""
    B, N, H, D = q.shape
    sl = scale / math.log(2.0)
    Np = fa.scratch_cols(N)
    chunk, chunks = fa.scratch_chunks(B, H, N, 4 + 2, scratch_bytes)
    S, P = _scratch(chunk, N, Np), _scratch(chunk, N, Np)
    o, lse = torch.zeros_like(q), torch.zeros(B, H, N, dtype=q.dtype)
    for p0, npairs in chunks:
        for z in range(npairs):
            b, h = divmod(p0 + z, H)
            s = _gemm(q[b, :, h], k[b, :, h].T, N, Np) * sl
            s[:, N:] = -math.inf
            S[z] = s
        for z in range(npairs):                     # attn_softmax_rows
            b, h = divmod(p0 + z, H)
            lse[b, h] = torch.logsumexp(S[z, :, :N] * math.log(2.0), -1) \
                / math.log(2.0)
            P[z] = torch.exp2(S[z] - lse[b, h][:, None])
        for z in range(npairs):
            b, h = divmod(p0 + z, H)
            o[b, :, h] = _gemm(P[z], v[b, :, h], N, D)
    return o, lse


def _emulate_bwd(q, k, v, o, lse, do, scale, scratch_bytes):
    """The materialized backward over [B, N, H, D]: delta = rowsum(do o),
    then per (b, h) pair, in the wrapper's chunks of scratch: (a) P =
    exp2(scale log2(e) Q K^T - lse), (b) dS = P (dO V^T - delta), both
    [N, Np] with zero padding; (c) dV = P^T dO, (d) dK = scale dS^T Q, (e)
    dQ = scale dS K."""
    B, N, H, D = q.shape
    sl = scale / math.log(2.0)
    Np = fa.scratch_cols(N)
    delta = (do * o).sum(-1).permute(0, 2, 1)        # [B, H, N]
    chunk, chunks = fa.scratch_chunks(B, H, N, 2 + 2, scratch_bytes)
    P, dS = _scratch(chunk, N, Np), _scratch(chunk, N, Np)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for p0, npairs in chunks:
        for z in range(npairs):
            b, h = divmod(p0 + z, H)
            qh, kh, vh, doh = (x[b, :, h] for x in (q, k, v, do))
            p = torch.exp2(_gemm(qh, kh.T, N, Np) * sl - lse[b, h][:, None])
            p[:, N:] = 0.0
            P[z] = p
            dS[z] = P[z] * (_gemm(doh, vh.T, N, Np) - delta[b, h][:, None])
            dv[b, :, h] = _gemm(P[z].T, doh, N, D)
            dk[b, :, h] = scale * _gemm(dS[z].T, qh, N, D)
            dq[b, :, h] = scale * _gemm(dS[z], kh, N, D)
    return dq, dk, dv


@pytest.mark.parametrize("B,N,H,D,scratch_bytes", [
    (1, 200, 1, 40, fa.SCRATCH_BYTES),      # the UNet's width, ragged tiles
    (1, 96, 1, 512, fa.SCRATCH_BYTES),      # the VAE's width
    (1, 130, 1, 48, fa.SCRATCH_BYTES),
    (2, 70, 3, 24, 4 * 70 * 72 * 4),        # backward chunks of 4 pairs
    (1, 40, 3, 80, 2 * 40 * 40 * 6),        # wide, chunks of 2 pairs
])
def test_flash_kernel_schedule_matches_plain(B, N, H, D, scratch_bytes):
    """The kernels' schedules (the fused narrow forward's tiles and online
    softmax, the wide forward's materialized S / P with the column split of
    O, the materialized backward's five products and two epilogues, in
    chunks of (b, h) pairs, the base-2 lse) give softmax attention and its
    gradient exactly (float64, 1e-10 of the largest entry), including
    ragged last tiles and the scratch padding."""
    q, k, v = (torch.from_numpy(x.astype(np.float64))
               for x in _qkv(B, N, H, D, seed=D))
    do = torch.from_numpy(np.random.default_rng(2).normal(size=(B, N, H, D)))
    scale = 1.0 / math.sqrt(D)
    if D <= fa.NARROW_HEAD_DIM:
        o, lse = torch.zeros_like(q), torch.zeros(B, H, N, dtype=q.dtype)
        for b in range(B):
            for h in range(H):
                o[b, :, h], lse[b, h] = _emulate_fwd_narrow(
                    q[b, :, h], k[b, :, h], v[b, :, h], scale)
    else:
        o, lse = _emulate_fwd_wide(q, k, v, scale, scratch_bytes)

    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref = fa.attention_plain(qr, kr, vr, scale)
    refs = torch.autograd.grad(ref, (qr, kr, vr), do)
    lse_ref = torch.logsumexp(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale,
                              -1) / math.log(2.0)
    got = (o, lse, *_emulate_bwd(q, k, v, o, lse, do, scale, scratch_bytes))
    for a, b in zip(got, (ref, lse_ref, *refs)):
        b = b.detach()
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())


@pytest.mark.parametrize("B,H,N,per_entry,budget,chunk", [
    (1, 1, 4096, 4, 256 * 2 ** 20, 1),      # the VAE's backward: 64 MB a pair
    (2, 8, 4096, 4, 256 * 2 ** 20, 4),      # 16 pairs in chunks of 4
    (2, 8, 4096, 6, 256 * 2 ** 20, 2),      # a wide forward's S and P
    (1, 3, 70, 4, 1, 1),                    # a budget below one pair
    (3, 5, 100, 2, 10 ** 9, 15),            # all pairs in one chunk
])
def test_scratch_chunks_cover_pairs_under_budget(B, H, N, per_entry, budget,
                                                 chunk):
    """The wrappers' walk over (b, h) pairs: every pair once, in order, in
    chunks whose [pairs, N, Np] scratch stays under the budget (one pair a
    chunk when even one is over it); Np is N rounded up to 8."""
    Np = fa.scratch_cols(N)
    assert Np % 8 == 0 and N <= Np < N + 8
    got, chunks = fa.scratch_chunks(B, H, N, per_entry, budget)
    assert got == chunk
    assert [p for p0, n in chunks for p in range(p0, p0 + n)] == list(range(B * H))
    assert all(0 < n <= chunk for _, n in chunks)
    assert chunk == 1 or chunk * N * Np * per_entry <= budget
