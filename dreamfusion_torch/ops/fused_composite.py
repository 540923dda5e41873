"""Fused volume compositor with an analytic backward (counterpart of
dreamfusion_tpu/ops/pallas_composite.py).

``composite_fused(sigmas, rgbs, deltas, ts, T_thresh)`` returns
(weights_sum [N], depth [N], rgb [N,3]) and differentiates to sigmas and
rgbs only (zero for deltas and ts, as in the JAX VJP). On a CUDA tensor it
launches the hand-written kernels of csrc/fused_composite.cu (B-fwd and
B-bwd); on a CPU tensor it runs ``composite_fwd_plain`` /
``composite_bwd_plain``, the formulas of pallas_composite.py:61-115 in
PyTorch, which are also what the kernels are held against on the card.
The library's third kernel, C, is the staged eval's compact compositor:
``composite_compact_cuda``, dispatched to by ``marching.composite_compact``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dreamfusion_torch.ops import cuda


class FusedOut(NamedTuple):
    weights_sum: torch.Tensor
    depth: torch.Tensor
    rgb: torch.Tensor


# -- plain versions ------------------------------------------------------------

def _excl_log_trans(sig, dt):
    alpha = 1.0 - torch.exp(-sig * dt)
    logs = torch.log(1.0 - alpha + 1e-15)
    excl = torch.cumsum(logs, dim=-1) - logs
    return alpha, torch.exp(excl)


def composite_fwd_plain(sig, rgb, dt, ts, T_thresh: float):
    """sig, dt, ts [N,K], rgb [N,K,3] (f32) -> (ws [N], depth [N], rgb [N,3])."""
    alpha, trans = _excl_log_trans(sig, dt)
    w = alpha * trans
    if T_thresh > 0.0:
        w = torch.where(trans > T_thresh, w, torch.zeros_like(w))
    return w.sum(-1), (w * ts).sum(-1), (w[..., None] * rgb).sum(-2)


def _suffix_excl(x):
    """sum_{k>i} x_k along the last axis."""
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), -1), (-1,)) - x


def composite_bwd_plain(sig, rgb, dt, ts, g_ws, g_depth, g_rgb,
                        T_thresh: float):
    """The analytic VJP (pallas_composite.py:83-115) -> (dsig [N,K],
    drgb [N,K,3])."""
    alpha, trans = _excl_log_trans(sig, dt)
    w = alpha * trans
    t_next = trans * (1.0 - alpha)
    if T_thresh > 0.0:
        m = (trans > T_thresh).to(w.dtype)
        w = w * m
        t_next = t_next * m
    acc = g_ws[:, None] * (t_next - _suffix_excl(w))
    acc = acc + g_depth[:, None] * (t_next * ts - _suffix_excl(w * ts))
    for c in range(3):
        acc = acc + g_rgb[:, c:c + 1] * (t_next * rgb[..., c]
                                          - _suffix_excl(w * rgb[..., c]))
    return dt * acc, g_rgb[:, None, :] * w[..., None]


# -- kernel wrappers -----------------------------------------------------------

def _check_inputs(sig, rgb, dt, ts):
    N, K = sig.shape
    cuda.require(sig, "sigmas", torch.float32, (N, K))
    cuda.require(rgb, "rgbs", torch.float32, (N, K, 3), sig.device)
    cuda.require(dt, "deltas", torch.float32, (N, K), sig.device)
    cuda.require(ts, "ts", torch.float32, (N, K), sig.device)
    return N, K


def composite_fwd_cuda(sig, rgb, dt, ts, T_thresh: float):
    """Kernel B-fwd: same contract as composite_fwd_plain."""
    N, K = _check_inputs(sig, rgb, dt, ts)
    ws = torch.empty(N, device=sig.device, dtype=torch.float32)
    depth = torch.empty_like(ws)
    out_rgb = torch.empty(N, 3, device=sig.device, dtype=torch.float32)
    cuda.launch("composite_fwd", sig.device, sig.data_ptr(), rgb.data_ptr(),
                dt.data_ptr(), ts.data_ptr(), ws.data_ptr(), depth.data_ptr(),
                out_rgb.data_ptr(), N, K, float(T_thresh))
    return ws, depth, out_rgb


def composite_bwd_cuda(sig, rgb, dt, ts, g_ws, g_depth, g_rgb,
                       T_thresh: float):
    """Kernel B-bwd: same contract as composite_bwd_plain."""
    N, K = _check_inputs(sig, rgb, dt, ts)
    cuda.require(g_ws, "g_weights_sum", torch.float32, (N,), sig.device)
    cuda.require(g_depth, "g_depth", torch.float32, (N,), sig.device)
    cuda.require(g_rgb, "g_rgb", torch.float32, (N, 3), sig.device)
    d_sig = torch.empty_like(sig)
    d_rgb = torch.empty_like(rgb)
    cuda.launch("composite_bwd", sig.device, sig.data_ptr(), rgb.data_ptr(),
                dt.data_ptr(), ts.data_ptr(), g_ws.data_ptr(),
                g_depth.data_ptr(), g_rgb.data_ptr(), d_sig.data_ptr(),
                d_rgb.data_ptr(), N, K, float(T_thresh))
    return d_sig, d_rgb


def composite_compact_cuda(sigma_c, color_c, t_c, dt_c, cmap, N: int,
                           T_thresh: float = 0.0):
    """Kernel C (composite_compact_kernel): the contract of
    marching.composite_compact_plain in one launch, a warp per ray over its
    segment [offs, offs + cnt) of the compact buffer with B-fwd's
    transmittance helper, so l is log(1 - alpha + 1e-15) as in B-fwd. f32
    contiguous samples, cmap a marching.CompactMap (int64 offs and cnt);
    every ray's row is written. Returns (rgb [N,3], weights_sum [N],
    depth_sum [N], live_counts [N])."""
    M = sigma_c.shape[0]
    dev = sigma_c.device
    cuda.require(sigma_c, "sigma_c", torch.float32, (M,))
    cuda.require(color_c, "color_c", torch.float32, (M, 3), dev)
    cuda.require(t_c, "t_c", torch.float32, (M,), dev)
    cuda.require(dt_c, "dt_c", torch.float32, (M,), dev)
    cuda.require(cmap.offs, "offs", torch.int64, (N,), dev)
    cuda.require(cmap.cnt, "cnt", torch.int64, (N,), dev)
    acc = torch.empty(N, 6, device=dev, dtype=torch.float32)
    cuda.launch("composite_compact", dev, sigma_c.data_ptr(),
                color_c.data_ptr(), dt_c.data_ptr(), t_c.data_ptr(),
                cmap.offs.data_ptr(), cmap.cnt.data_ptr(), acc.data_ptr(), N,
                M, float(T_thresh))
    return acc[:, 2:5], acc[:, 0], acc[:, 1], acc[:, 5]


def composite_fwd(sig, rgb, dt, ts, T_thresh: float):
    if sig.is_cuda:
        return composite_fwd_cuda(sig, rgb, dt, ts, T_thresh)
    return composite_fwd_plain(sig, rgb, dt, ts, T_thresh)


def composite_bwd(sig, rgb, dt, ts, g_ws, g_depth, g_rgb, T_thresh: float):
    if sig.is_cuda:
        return composite_bwd_cuda(sig, rgb, dt, ts, g_ws, g_depth, g_rgb,
                                  T_thresh)
    return composite_bwd_plain(sig, rgb, dt, ts, g_ws, g_depth, g_rgb,
                               T_thresh)


class _CompositeFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, rgbs, deltas, ts, T_thresh):
        args = tuple(x.detach().float().contiguous()
                     for x in (sigmas, rgbs, deltas, ts))
        ws, depth, rgb = composite_fwd(*args, T_thresh)
        ctx.save_for_backward(*args)
        ctx.T_thresh = T_thresh
        return ws, depth, rgb

    @staticmethod
    def backward(ctx, g_ws, g_depth, g_rgb):
        grads = tuple(g.float().contiguous() for g in (g_ws, g_depth, g_rgb))
        d_sig, d_rgb = composite_bwd(*ctx.saved_tensors, *grads, ctx.T_thresh)
        return d_sig, d_rgb, None, None, None


def composite_fused(sigmas: torch.Tensor, rgbs: torch.Tensor,
                    deltas: torch.Tensor, ts: torch.Tensor,
                    T_thresh: float = 0.0) -> FusedOut:
    """sigmas [N,K], rgbs [N,K,3], deltas [N,K], ts [N,K] ->
    FusedOut(weights_sum [N], depth [N], rgb [N,3])."""
    return FusedOut(*_CompositeFused.apply(sigmas, rgbs, deltas, ts,
                                           float(T_thresh)))
