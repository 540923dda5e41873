"""Flash attention with its backward (counterpart of the flash branch of
dreamfusion_tpu/guidance/sd/layers.py::attention_core, which reaches the
stock Pallas TPU flash-attention kernel).

``flash_attention(q, k, v, scale)``: q, k, v [B, N, H, D] bf16 ->
softmax(scale q k^T) v per head, [B, N, H, D] bf16, with the scores, the
softmax and the sums in f32. On a CUDA tensor it launches the hand-written
kernels of csrc/flash_attention.cu (``attention_fwd``, and
``attention_bwd`` when autograd asks for the gradient); on a CPU tensor it
runs ``attention_plain``, which autograd differentiates and which is also
what the kernels are held against on the card.

The forward takes the fused kernel for heads up to ``NARROW_HEAD_DIM``
wide (SD v1.5's UNet's 40, SDXL's 64) and the materialized schedule (S,
row softmax, P V on one wgmma GEMM) for wider ones (the VAE's 512); the
backward is materialized at every width. Their [pairs, N, Np] scratch is
allocated here, and the (b, h) pairs are walked in chunks that keep it
under ``SCRATCH_BYTES``.
"""

from __future__ import annotations

import torch

from dreamfusion_torch.ops import cuda

MAX_HEAD_DIM = 512      # widest head the kernels take (the VAE's 512)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """[B, N, H, D] -> [B, N, H, D] in q's dtype; scores and softmax in f32
    (f64 for f64 inputs)."""
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = (x.to(ct).transpose(1, 2) for x in (q, k, v))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(p, vf).transpose(1, 2).to(q.dtype)


# -- kernel wrappers -----------------------------------------------------------

NARROW_HEAD_DIM = 64    # widest head of the fused forward kernel
# scratch of the materialized schedule (wide forward: S f32 + P bf16;
# backward: P + dS bf16, each [pairs, N, Np]) is kept under this many bytes
SCRATCH_BYTES = 256 * 2 ** 20

def scratch_cols(N: int) -> int:
    """Row length Np of the [pairs, N, Np] scratch: N rounded up to 8, so
    that each row is a multiple of 16 bytes in bf16 (a TMA stride)."""
    return -(-N // 8) * 8


def scratch_chunks(B: int, H: int, N: int, bytes_per_entry: int,
                   budget: int):
    """(pairs a chunk, [(first pair, pairs), ...]) for walking the B * H
    (b, h) pairs with at most `budget` bytes of [pairs, N, Np] scratch
    (bytes_per_entry per entry; at least one pair a chunk)."""
    pairs = B * H
    per_pair = N * scratch_cols(N) * bytes_per_entry
    chunk = max(1, min(pairs, budget // max(per_pair, 1)))
    return chunk, [(p0, min(chunk, pairs - p0)) for p0 in range(0, pairs, chunk)]


def _check_inputs(q, k, v):
    if q.ndim != 4:
        raise ValueError(f"q must be [B, N, H, D], got {tuple(q.shape)}")
    B, N, H, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda.require(t, name, torch.bfloat16, (B, N, H, D), q.device)
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head width {D}: the kernels take multiples of 8 up "
                         f"to {MAX_HEAD_DIM} (TMA strides are multiples of "
                         f"16 bytes)")
    return B, N, H, D


def attention_fwd_cuda(q, k, v, scale: float):
    """Forward kernels -> (o [B, N, H, D] bf16, lse [B, H, N] f32, base 2).
    Heads up to NARROW_HEAD_DIM wide take the fused kernel in one launch;
    wider heads the materialized schedule, (b, h) pairs in chunks."""
    B, N, H, D = _check_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32)
    Np = scratch_cols(N)
    if D <= NARROW_HEAD_DIM:
        chunks, s_ptr, p_ptr = [(0, B * H)], None, None
    else:
        chunk, chunks = scratch_chunks(B, H, N, 4 + 2, SCRATCH_BYTES)
        S = torch.empty(chunk, N, Np, device=q.device, dtype=torch.float32)
        P = torch.empty(chunk, N, Np, device=q.device, dtype=torch.bfloat16)
        s_ptr, p_ptr = S.data_ptr(), P.data_ptr()
    for p0, n in chunks:
        cuda.launch("attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), lse.data_ptr(), s_ptr, p_ptr,
                    B, N, H, D, Np, p0, n, float(scale), count=False)
    cuda.launch_counts["attention_fwd"] += 1
    return o, lse


def attention_bwd_cuda(q, k, v, o, lse, do, scale: float):
    """Backward kernels -> (dq, dk, dv), each [B, N, H, D] bf16: delta,
    then the five products of the materialized schedule, (b, h) pairs in
    chunks."""
    B, N, H, D = _check_inputs(q, k, v)
    cuda.require(o, "o", torch.bfloat16, (B, N, H, D), q.device)
    cuda.require(do, "do", torch.bfloat16, (B, N, H, D), q.device)
    cuda.require(lse, "lse", torch.float32, (B, H, N), q.device)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    Np = scratch_cols(N)
    chunk, chunks = scratch_chunks(B, H, N, 2 + 2, SCRATCH_BYTES)
    P, dS = (torch.empty(chunk, N, Np, device=q.device, dtype=torch.bfloat16)
             for _ in range(2))
    cuda.launch("attention_bwd_delta", q.device, o.data_ptr(), do.data_ptr(),
                delta.data_ptr(), B, N, H, D)
    for p0, n in chunks:
        cuda.launch("attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), P.data_ptr(), dS.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, H, D,
                    Np, p0, n, float(scale), count=False)
    cuda.launch_counts["attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = (x.contiguous() for x in (q, k, v))
        o, lse = attention_fwd_cuda(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd_cuda(
            q, k, v, o, lse, do.to(torch.bfloat16).contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(scale q k^T) v over [B, N, H, D]: the kernels on a CUDA
    tensor, ``attention_plain`` on a CPU tensor."""
    if q.is_cuda:
        return _FlashAttention.apply(q, k, v, float(scale))
    return attention_plain(q, k, v, scale)
