// Fused volume compositor, forward and analytic backward, and the staged
// eval's compact compositor.
//
// Replaces the TPU kernels dreamfusion_tpu/ops/pallas_composite.py::
// composite_fused (bodies _fwd_kernel and _bwd_kernel) and dreamfusion_tpu/
// ops/pallas_scatter.py::matmul_scatter_add_wide as dreamfusion_tpu/ops/
// marching.py::composite_compact calls it (the per-ray sums of the compact
// buffer).
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
// All three kernels run one warp per ray, eight rays a block. Lanes take
// consecutive samples, so each chunk of 32 samples loads sigma, delta and
// t as one 128-byte row each and rgb as three coalesced rows of 32 floats.
// Any K: lanes past K read sigma = delta = 0 (l = 0, w = 0).
//
// The mask, bit for bit the same in all three. One __device__ helper,
// chunk_trans, computes a chunk's alpha, l, the inclusive warp scan of l by
// shuffles, T_k = exp(carry + exclusive scan) and the chunk's log sum; the
// carry (log T at the chunk's first sample) is the sum of the earlier
// chunks' log sums, added in chunk order; the walk stops after the chunk
// whose end has exp(carry) <= T_thresh (warp-uniform: every lane holds the
// carry). The kernels call the helper on the same inputs in the same
// order, and its adds and the product sigma * delta are __fadd_rn /
// __fmul_rn, which the compiler cannot contract into FMAs, so no kernel's
// surroundings can change how T is rounded (the build has no
// --use_fast_math). Every sample's T, its mask and the stop are therefore
// the same bits in the forward, the backward and the compact kernel. The
// TPU kernel gets the same guarantee by keeping an [N, K] transmittance
// residual; none is stored here.
//
// Forward (kernel B-fwd): per chunk, the helper, the mask and the lane's
// running sums (add_chunk: the rgb floats a lane loaded belong to samples
// p / 3 of the chunk, whose w it takes by a shuffle). The five sums are
// reduced across the warp once at the end (warp_totals).
//
// Compact (kernel C, the staged eval's compositor): the same walk over a
// ray's segment [offs[n], offs[n] + cnt[n]) of the ray-major compact
// buffer (marching.make_compact_map), with B-fwd's add_chunk and
// warp_totals and a sixth sum, the live count (samples with T > T_thresh).
// Every ray's row [w, w t, w r, w g, w b, live] is written, zeros for an
// empty segment: no zeroed output, no atomics. The TPU's form (a flat
// two-pass cumsum for T, then a one-hot matmul scatter of the per-sample
// products into rays) exists because a scatter is slow on the TPU; the
// buffer is ray-major, so here the per-ray sums are a segmented reduction.
// Chunk k of a segment holds its samples 32k..32k+31, as chunk k of the
// same ray in B-fwd on compact_expand of the buffer; the slots that the
// compaction dropped read sigma = delta = 0 there, so l = 0 and w = 0, and
// every sum B-fwd adds for them is +0. The two kernels' masks and sums are
// therefore the same bits on the same samples.
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
// sample and writes 20 bytes per ray; the compact kernel reads the same
// per live sample plus 16 bytes of segment per ray and writes 24; the
// backward reads the forward's bytes again and writes 16 bytes per sample
// slot. At N = 4,096 rays a block of 8 rays gives 512 blocks, all resident
// at once on the 132 SMs. The compact kernel replaces the ~50 eager
// launches of the TPU form's prologue and scatter with one.

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
// The one place any of the kernels computes T: see the header.
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

// A lane's running sums over a ray's chunks: w, w t, and w c over the rgb
// floats p = lane + 32 r of each chunk (channel (lane + 2 r) % 3).
struct LaneSums {
  float w = 0.0f, d = 0.0f;
  float c[3] = {0.0f, 0.0f, 0.0f};
};

// Adds one chunk's masked weights wk; c_chunk points at the chunk's first
// rgb float, of which `left` belong to the ray. The products are explicit
// FMAs, so the kernels that share this helper round them alike.
__device__ __forceinline__ void add_chunk(LaneSums& s, float wk, float t,
                                          const float* c_chunk, int left,
                                          int lane) {
  s.w = __fadd_rn(s.w, wk);
  s.d = __fmaf_rn(wk, t, s.d);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int p = lane + 32 * r;
    const float wp = __shfl_sync(kFull, wk, p / 3);
    if (p < left) s.c[r] = __fmaf_rn(wp, c_chunk[p], s.c[r]);
  }
}

// The warp's totals [w, w t, r, g, b], in every lane: the lane's three rgb
// sums are one per channel, then a butterfly sum.
__device__ __forceinline__ void warp_totals(const LaneSums& s, int lane,
                                            float v[5]) {
  v[0] = s.w;
  v[1] = s.d;
  v[2] = v[3] = v[4] = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int ch = (lane + 2 * r) % 3;
    if (ch == 0) v[2] = s.c[r];
    if (ch == 1) v[3] = s.c[r];
    if (ch == 2) v[4] = s.c[r];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 5; ++i) v[i] += __shfl_xor_sync(kFull, v[i], off);
  }
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
  // the row's rgb base, out of the loop: forming the 64-bit address per
  // chunk made this kernel ~20% slower on an H100
  const float* c_row = rgb + 3 * o;
  LaneSums s;
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
    add_chunk(s, wk, t, c_row + 3 * k0, 3 * (K - k0), lane);
    carry = __fadd_rn(carry, ch.total);
    if (expf(carry) <= T_thresh) break;
  }
  float v[5];
  warp_totals(s, lane, v);
  if (lane == 0) {
    ws[n] = v[0];
    depth[n] = v[1];
    out_rgb[3 * n] = v[2];
    out_rgb[3 * n + 1] = v[3];
    out_rgb[3 * n + 2] = v[4];
  }
}

// out[n] = [w, w t, w r, w g, w b, live] over the ray's segment of the
// compact buffer (sig, dt, ts [M], rgb [M, 3]); segments are clipped to
// [0, M), so no read leaves the buffer whatever offs and cnt hold.
__global__ void __launch_bounds__(kRaysPerBlock * 32)
composite_compact_kernel(const float* __restrict__ sig,
                         const float* __restrict__ rgb,
                         const float* __restrict__ dt,
                         const float* __restrict__ ts,
                         const int64_t* __restrict__ offs,
                         const int64_t* __restrict__ cnt,
                         float* __restrict__ out, int N, int64_t M,
                         float T_thresh) {
  const int lane = threadIdx.x & 31;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kRaysPerBlock +
                    (threadIdx.x >> 5);
  if (n >= N) return;                   // the whole warp
  const int64_t o = offs[n];
  int64_t c = (o >= 0 && o < M) ? cnt[n] : 0;   // the segment's length
  if (c > M - o) c = M - o;
  const float* c_seg = rgb + 3 * o;
  LaneSums s;
  float live = 0.0f;
  float carry = 0.0f;
  for (int64_t k0 = 0; k0 < c; k0 += 32) {
    const int64_t k = k0 + lane;
    float sg = 0.0f, d = 0.0f, t = 0.0f;
    if (k < c) {
      sg = sig[o + k];
      d = dt[o + k];
      t = ts[o + k];
    }
    const ChunkTrans ch = chunk_trans(sg, d, carry, lane);
    const bool on = ch.T > T_thresh;
    const float wk = on ? ch.alpha * ch.T : 0.0f;
    if (on && k < c) live += 1.0f;
    const int in_seg = c - k0 < 32 ? static_cast<int>(c - k0) : 32;
    add_chunk(s, wk, t, c_seg + 3 * k0, 3 * in_seg, lane);
    carry = __fadd_rn(carry, ch.total);
    if (expf(carry) <= T_thresh) break;
  }
  float v[5];
  warp_totals(s, lane, v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    live += __shfl_xor_sync(kFull, live, off);
  if (lane == 0) {
    float* row = out + 6 * n;
#pragma unroll
    for (int i = 0; i < 5; ++i) row[i] = v[i];
    row[5] = live;
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

extern "C" int composite_compact(const void* sig, const void* rgb,
                                 const void* dt, const void* ts,
                                 const void* offs, const void* cnt, void* out,
                                 int N, long long M, float T_thresh,
                                 void* stream) {
  if (N == 0) return 0;
  composite_compact_kernel<<<blocks_for(N), kRaysPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(rgb),
      static_cast<const float*>(dt), static_cast<const float*>(ts),
      static_cast<const int64_t*>(offs), static_cast<const int64_t*>(cnt),
      static_cast<float*>(out), N, static_cast<int64_t>(M), T_thresh);
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
