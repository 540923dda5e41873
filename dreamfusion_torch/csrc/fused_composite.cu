// Fused volume compositor, forward and analytic backward.
//
// Replaces the TPU kernel dreamfusion_tpu/ops/pallas_composite.py::
// composite_fused (bodies _fwd_kernel and _bwd_kernel).
//
// Per ray n over its K samples (row-major [N, K], rgb [N, K, 3]):
//   alpha_k = 1 - exp(-sigma_k * delta_k)
//   l_k     = log(1 - alpha_k + 1e-15)
//   T_k     = exp(sum_{j<k} l_j)                    (exclusive)
//   w_k     = alpha_k * T_k  where T_k > T_thresh, else 0
//   weights_sum = sum w_k, depth = sum w_k t_k, rgb = sum w_k c_k
// the log-space form of the plain version (ops/fused_composite.py) and of
// the JAX kernel. T is non-increasing along a ray, so the mask is a prefix.
//
// Forward (kernel B-fwd): one warp per ray, eight rays a block. Lanes take
// consecutive samples, so each chunk of 32 samples loads sigma, delta and
// t as one 128-byte row each and rgb as three coalesced rows of 32 floats.
// Per chunk: l_k, an inclusive warp scan of l by shuffles, T_k from the
// exclusive scan plus the carry of the earlier chunks, the mask, and the
// lane's running sums; the rgb floats a lane loaded belong to samples
// p / 3 of the chunk, whose w it takes by a shuffle. The walk stops after
// the chunk whose end has T <= T_thresh (warp-uniform: the carry is the
// same on every lane); the five sums are reduced across the warp once at
// the end. Any K: lanes past K read sigma = delta = 0 (l = 0, w = 0).
//
// Backward (kernel B-bwd; the closed form of pallas_composite.py:83-115
// and of the reference's raymarching.cu:501-693):
//   drgb_k   = g_rgb * w_k
//   dsigma_k = delta_k * [ g_ws (T_{k+1} - S_w) + g_d (T_{k+1} t_k - S_wt)
//                          + sum_c g_c (T_{k+1} c_k - S_wc) ]
// with T_{k+1} = T_k (1 - alpha_k) on live samples, S_* the sums over the
// live samples after k, and 0 for masked samples. Gradients for delta and
// t are zero, as in the JAX VJP. One thread owns a ray: the first pass
// walks the log sum and finds the live prefix with the forward's mask
// formula, exp(log T_k) > T_thresh (the sum runs in sequence here and by a
// warp scan there, so a sample whose T lies within rounding of T_thresh
// can fall on either side in the two); the second walks that prefix in
// reverse with running suffix sums and recovers T_k from the log sum. The
// TPU kernel keeps an [N, K] transmittance residual and forms prefix and
// suffix sums as triangular MXU matmuls; no [N, K] residual is stored here.
//
// What bounds them on Hopper: bytes. The forward reads 24 bytes per live
// sample and writes 20 bytes per ray; the backward reads those again and
// writes 16 bytes per sample slot. The backward's thread-per-ray loads are
// strided across the warp; a warp-per-ray backward is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRaysPerBlock = 8;        // warps of the forward's blocks

__global__ void __launch_bounds__(kRaysPerBlock * 32)
composite_fwd_kernel(const float* __restrict__ sig,
                     const float* __restrict__ rgb,
                     const float* __restrict__ dt,
                     const float* __restrict__ ts,
                     float* __restrict__ ws, float* __restrict__ depth,
                     float* __restrict__ out_rgb, int N, int K,
                     float T_thresh) {
  const int lane = threadIdx.x & 31;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kRaysPerBlock +
                    (threadIdx.x >> 5);
  if (n >= N) return;                   // the whole warp
  const int64_t o = n * K;
  const float* c_row = rgb + 3 * o;
  // lane's rgb float p = lane + 32 r of a chunk is channel (lane + 2 r) % 3
  float s_w = 0.0f, s_d = 0.0f, s_c[3] = {0.0f, 0.0f, 0.0f};
  float carry = 0.0f;                   // log T at the chunk's first sample
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    float sg = 0.0f, d = 0.0f, t = 0.0f;
    if (k < K) {
      sg = sig[o + k];
      d = dt[o + k];
      t = ts[o + k];
    }
    const float alpha = 1.0f - expf(-sg * d);
    const float l = logf(1.0f - alpha + 1e-15f);
    float incl = l;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float T = expf(carry + excl);
    const float wk = T > T_thresh ? alpha * T : 0.0f;
    s_w += wk;
    s_d += wk * t;
    const int left = 3 * (K - k0);      // rgb floats of the row from here
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = lane + 32 * r;
      const float wp = __shfl_sync(kFull, wk, p / 3);
      if (p < left) s_c[r] += wp * c_row[3 * k0 + p];
    }
    carry += __shfl_sync(kFull, incl, 31);
    if (expf(carry) <= T_thresh) break;
  }
  float v[5] = {s_w, s_d, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int ch = (lane + 2 * r) % 3;
    v[2] += ch == 0 ? s_c[r] : 0.0f;
    v[3] += ch == 1 ? s_c[r] : 0.0f;
    v[4] += ch == 2 ? s_c[r] : 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 5; ++i) v[i] += __shfl_xor_sync(kFull, v[i], off);
  }
  if (lane == 0) {
    ws[n] = v[0];
    depth[n] = v[1];
    out_rgb[3 * n] = v[2];
    out_rgb[3 * n + 1] = v[3];
    out_rgb[3 * n + 2] = v[4];
  }
}

__global__ void composite_bwd_kernel(const float* __restrict__ sig,
                                     const float* __restrict__ rgb,
                                     const float* __restrict__ dt,
                                     const float* __restrict__ ts,
                                     const float* __restrict__ g_ws,
                                     const float* __restrict__ g_depth,
                                     const float* __restrict__ g_rgb,
                                     float* __restrict__ d_sig,
                                     float* __restrict__ d_rgb,
                                     int N, int K, float T_thresh) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int64_t o = static_cast<int64_t>(n) * K;

  // pass 1: the live prefix, decided with the forward's log-space formula
  float logT = 0.0f;
  int n_live = 0;
  for (int k = 0; k < K; ++k) {
    if (expf(logT) <= T_thresh) break;
    const float alpha = 1.0f - expf(-sig[o + k] * dt[o + k]);
    logT += logf(1.0f - alpha + 1e-15f);
    n_live = k + 1;
  }
  for (int k = n_live; k < K; ++k) {
    d_sig[o + k] = 0.0f;
    d_rgb[3 * (o + k)] = 0.0f;
    d_rgb[3 * (o + k) + 1] = 0.0f;
    d_rgb[3 * (o + k) + 2] = 0.0f;
  }

  // pass 2: reverse walk with suffix sums over the live samples after k
  const float gw = g_ws[n], gd = g_depth[n];
  const float gr = g_rgb[3 * n], gg = g_rgb[3 * n + 1], gb = g_rgb[3 * n + 2];
  float S_w = 0.0f, S_d = 0.0f, S_r = 0.0f, S_g = 0.0f, S_b = 0.0f;
  for (int k = n_live - 1; k >= 0; --k) {
    const float d = dt[o + k];
    const float alpha = 1.0f - expf(-sig[o + k] * d);
    logT -= logf(1.0f - alpha + 1e-15f);      // now log T_k (exclusive)
    const float Tk = expf(logT);
    const float w = alpha * Tk;
    const float t_next = Tk * (1.0f - alpha);
    const float t = ts[o + k];
    const float* c = rgb + 3 * (o + k);
    const float acc = gw * (t_next - S_w) + gd * (t_next * t - S_d) +
                      gr * (t_next * c[0] - S_r) + gg * (t_next * c[1] - S_g) +
                      gb * (t_next * c[2] - S_b);
    d_sig[o + k] = d * acc;
    d_rgb[3 * (o + k)] = gr * w;
    d_rgb[3 * (o + k) + 1] = gg * w;
    d_rgb[3 * (o + k) + 2] = gb * w;
    S_w += w;
    S_d += w * t;
    S_r += w * c[0];
    S_g += w * c[1];
    S_b += w * c[2];
  }
}

constexpr int kThreads = 128;           // the backward's threads a block

unsigned blocks_for(int N, int per_block) {
  return static_cast<unsigned>((N + per_block - 1) / per_block);
}

}  // namespace

extern "C" int composite_fwd(const void* sig, const void* rgb, const void* dt,
                             const void* ts, void* ws, void* depth,
                             void* out_rgb, int N, int K, float T_thresh,
                             void* stream) {
  if (N == 0) return 0;
  composite_fwd_kernel<<<blocks_for(N, kRaysPerBlock), kRaysPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(rgb),
      static_cast<const float*>(dt), static_cast<const float*>(ts),
      static_cast<float*>(ws), static_cast<float*>(depth),
      static_cast<float*>(out_rgb), N, K, T_thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_bwd(const void* sig, const void* rgb, const void* dt,
                             const void* ts, const void* g_ws,
                             const void* g_depth, const void* g_rgb,
                             void* d_sig, void* d_rgb, int N, int K,
                             float T_thresh, void* stream) {
  if (N == 0) return 0;
  composite_bwd_kernel<<<blocks_for(N, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(rgb),
      static_cast<const float*>(dt), static_cast<const float*>(ts),
      static_cast<const float*>(g_ws), static_cast<const float*>(g_depth),
      static_cast<const float*>(g_rgb), static_cast<float*>(d_sig),
      static_cast<float*>(d_rgb), N, K, T_thresh);
  return static_cast<int>(cudaGetLastError());
}
