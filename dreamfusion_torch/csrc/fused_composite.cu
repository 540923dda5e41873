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
// Both kernels run one warp per ray, eight rays a block. Lanes take
// consecutive samples, so each chunk of 32 samples loads sigma, delta and
// t as one 128-byte row each and rgb as three coalesced rows of 32 floats.
// Any K: lanes past K read sigma = delta = 0 (l = 0, w = 0).
//
// The mask, bit for bit the same in both. One __device__ helper,
// chunk_trans, computes a chunk's alpha, l, the inclusive warp scan of l by
// shuffles, T_k = exp(carry + exclusive scan) and the chunk's log sum; the
// carry (log T at the chunk's first sample) is the sum of the earlier
// chunks' log sums, added in chunk order; the walk stops after the chunk
// whose end has exp(carry) <= T_thresh (warp-uniform: every lane holds the
// carry). Both kernels call the helper on the same inputs in the same
// order, and its adds and the product sigma * delta are __fadd_rn /
// __fmul_rn, which the compiler cannot contract into FMAs, so neither
// kernel's surroundings can change how T is rounded (the build has no
// --use_fast_math). Every sample's T, its mask and the stop are therefore
// the same bits in the forward and the backward. The TPU kernel gets the
// same guarantee by keeping an [N, K] transmittance residual; none is
// stored here.
//
// Forward (kernel B-fwd): per chunk, the helper, the mask and the lane's
// running sums; the rgb floats a lane loaded belong to samples p / 3 of the
// chunk, whose w it takes by a shuffle. The five sums are reduced across
// the warp once at the end.
//
// Backward (kernel B-bwd; the closed form of pallas_composite.py:83-115
// and of the reference's raymarching.cu:501-693):
//   drgb_k   = g_rgb * w_k
//   dsigma_k = delta_k * [ g_ws (T_{k+1} - S_w) + g_d (T_{k+1} t_k - S_wt)
//                          + sum_c g_c (T_{k+1} c_k - S_wc) ]
// with T_{k+1} = T_k (1 - alpha_k) on live samples, S_* the sums over the
// live samples after k, and 0 for masked samples. Gradients for delta and
// t are zero, as in the JAX VJP. The bracket is linear in the sums, so it
// is T_{k+1} G_k - S_k with G_k = g_ws + g_d t_k + sum_c g_c c_k and S_k
// the sum of u_j = w_j G_j over the live samples after k: one suffix sum,
// not five. Pass 1 walks the chunks as the forward does and keeps each
// chunk's carry (shared memory, a float per chunk and warp). Pass 2 walks
// the chunks up to the stop in reverse: it recomputes T_k with the helper
// from the chunk's saved carry, gathers each lane's three colour channels
// from the three rgb rows by shuffles, and forms S_k by a shuffle-down
// suffix scan of u plus the sum of the later chunks. Chunks after the stop
// get zeros, written as coalesced rows. drgb is written as three coalesced
// rows with the forward's channel bookkeeping.
//
// What bounds them on Hopper: bytes. The forward reads 24 bytes per live
// sample and writes 20 bytes per ray; the backward reads those again and
// writes 16 bytes per sample slot. At the train shape (N = 4,096) a block
// of 8 rays gives 512 blocks, all resident at once on the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRaysPerBlock = 8;        // warps of a block, one per ray

struct ChunkTrans {
  float alpha;                          // of the lane's sample
  float T;                              // exp(log T) at the lane's sample
  float total;                          // the chunk's log sum (every lane)
};

// One chunk of 32 samples of a ray, lane `lane` holding one sample (sigma
// = delta = 0 past K), given the carry, log T at the chunk's first sample.
// The one place either kernel computes T: see the header.
__device__ __forceinline__ ChunkTrans chunk_trans(float sg, float d,
                                                  float carry, int lane) {
  const float alpha = 1.0f - expf(-__fmul_rn(sg, d));
  const float l = logf(__fadd_rn(1.0f - alpha, 1e-15f));
  float incl = l;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, y);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  return {alpha, expf(__fadd_rn(carry, excl)),
          __shfl_sync(kFull, incl, 31)};
}

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
    const ChunkTrans ch = chunk_trans(sg, d, carry, lane);
    const float wk = ch.T > T_thresh ? ch.alpha * ch.T : 0.0f;
    s_w += wk;
    s_d += wk * t;
    const int left = 3 * (K - k0);      // rgb floats of the row from here
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = lane + 32 * r;
      const float wp = __shfl_sync(kFull, wk, p / 3);
      if (p < left) s_c[r] += wp * c_row[3 * k0 + p];
    }
    carry = __fadd_rn(carry, ch.total);
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

__global__ void __launch_bounds__(kRaysPerBlock * 32)
composite_bwd_kernel(const float* __restrict__ sig,
                     const float* __restrict__ rgb,
                     const float* __restrict__ dt,
                     const float* __restrict__ ts,
                     const float* __restrict__ g_ws,
                     const float* __restrict__ g_depth,
                     const float* __restrict__ g_rgb,
                     float* __restrict__ d_sig, float* __restrict__ d_rgb,
                     int N, int K, float T_thresh) {
  extern __shared__ float saved_carry[];     // [kRaysPerBlock][chunks]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kRaysPerBlock + warp;
  if (n >= N) return;                   // the whole warp
  const int chunks = (K + 31) / 32;
  float* carries = saved_carry + warp * chunks;
  const int64_t o = n * K;
  const float* c_row = rgb + 3 * o;
  float* dc_row = d_rgb + 3 * o;

  // pass 1: the forward's walk, keeping each chunk's carry
  int n_live = 0;                       // chunks up to and with the stop
  float carry = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    float sg = 0.0f, d = 0.0f;
    if (k < K) {
      sg = sig[o + k];
      d = dt[o + k];
    }
    if (lane == 0) carries[n_live] = carry;
    carry = __fadd_rn(carry, chunk_trans(sg, d, carry, lane).total);
    ++n_live;
    if (expf(carry) <= T_thresh) break;
  }
  __syncwarp();
  for (int k0 = 32 * n_live; k0 < K; k0 += 32) {
    if (k0 + lane < K) d_sig[o + k0 + lane] = 0.0f;
    const int left = 3 * (K - k0);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = lane + 32 * r;
      if (p < left) dc_row[3 * k0 + p] = 0.0f;
    }
  }

  // pass 2: the live chunks in reverse, with the suffix sum of u = w G
  const float gw = g_ws[n], gd = g_depth[n];
  const float gc[3] = {g_rgb[3 * n], g_rgb[3 * n + 1], g_rgb[3 * n + 2]};
  float g_slot[3];                      // g of the channel of float lane+32r
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int ch = (lane + 2 * r) % 3;
    g_slot[r] = ch == 0 ? gc[0] : (ch == 1 ? gc[1] : gc[2]);
  }
  float s_later = 0.0f;                 // sum of u over the later chunks
  for (int c = n_live - 1; c >= 0; --c) {
    const int k0 = 32 * c;
    const int k = k0 + lane;
    float sg = 0.0f, d = 0.0f, t = 0.0f;
    if (k < K) {
      sg = sig[o + k];
      d = dt[o + k];
      t = ts[o + k];
    }
    const int left = 3 * (K - k0);
    float row[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = lane + 32 * r;
      row[r] = p < left ? c_row[3 * k0 + p] : 0.0f;
    }
    const ChunkTrans ch = chunk_trans(sg, d, carries[c], lane);
    const bool on = ch.T > T_thresh;
    const float w = on ? ch.alpha * ch.T : 0.0f;
    const float t_next = on ? ch.T * (1.0f - ch.alpha) : 0.0f;
    // channel j of this lane's sample is float q = 3 lane + j of the
    // chunk: row q / 32, lane q % 32
    float G = gw + gd * t;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int q = 3 * lane + j;
      const float a0 = __shfl_sync(kFull, row[0], q & 31);
      const float a1 = __shfl_sync(kFull, row[1], q & 31);
      const float a2 = __shfl_sync(kFull, row[2], q & 31);
      G += gc[j] * (q < 32 ? a0 : (q < 64 ? a1 : a2));
    }
    const float u = w * G;
    float suffix = u;                   // sum of u over lanes >= this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(kFull, suffix, off);
      if (lane + off < 32) suffix += y;
    }
    float after = __shfl_down_sync(kFull, suffix, 1);
    if (lane == 31) after = 0.0f;
    if (k < K) d_sig[o + k] = d * (t_next * G - (after + s_later));
    s_later += __shfl_sync(kFull, suffix, 0);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = lane + 32 * r;
      const float wp = __shfl_sync(kFull, w, p / 3);
      if (p < left) dc_row[3 * k0 + p] = g_slot[r] * wp;
    }
  }
}

unsigned blocks_for(int N) {
  return static_cast<unsigned>((N + kRaysPerBlock - 1) / kRaysPerBlock);
}

}  // namespace

extern "C" int composite_fwd(const void* sig, const void* rgb, const void* dt,
                             const void* ts, void* ws, void* depth,
                             void* out_rgb, int N, int K, float T_thresh,
                             void* stream) {
  if (N == 0) return 0;
  composite_fwd_kernel<<<blocks_for(N), kRaysPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(rgb),
      static_cast<const float*>(dt), static_cast<const float*>(ts),
      static_cast<float*>(ws), static_cast<float*>(depth),
      static_cast<float*>(out_rgb), N, K, T_thresh);
  return static_cast<int>(cudaGetLastError());
}

// The saved carries take kRaysPerBlock * ceil(K / 32) floats of shared
// memory; past the 48 KB a launch gets without opting in (K > 49,152) the
// launch is refused with cudaErrorInvalidValue.
extern "C" int composite_bwd(const void* sig, const void* rgb, const void* dt,
                             const void* ts, const void* g_ws,
                             const void* g_depth, const void* g_rgb,
                             void* d_sig, void* d_rgb, int N, int K,
                             float T_thresh, void* stream) {
  if (N == 0) return 0;
  const size_t smem = sizeof(float) * kRaysPerBlock * ((K + 31) / 32);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  composite_bwd_kernel<<<blocks_for(N), kRaysPerBlock * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(rgb),
      static_cast<const float*>(dt), static_cast<const float*>(ts),
      static_cast<const float*>(g_ws), static_cast<const float*>(g_depth),
      static_cast<const float*>(g_rgb), static_cast<float*>(d_sig),
      static_cast<float*>(d_rgb), N, K, T_thresh);
  return static_cast<int>(cudaGetLastError());
}
