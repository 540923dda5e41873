// Flash attention, forward and backward, for the SD UNet's and VAE's
// self-attention over 64x64 latents (N = 4,096 tokens).
//
// Replaces the TPU kernel that dreamfusion_tpu/guidance/sd/layers.py::
// attention_core reaches on its flash branch (layers.py:125-131): the
// stock jax.experimental.pallas.ops.tpu.flash_attention, forward and
// backward.
//
// Contract (per batch b and head h):
//   q, k, v, o  [B, N, H, D] bf16, contiguous: the JAX layout at
//               attention_core, heads are not transposed out
//   o    = softmax(scale * q k^T) v, scores, softmax and sums in f32
//   lse  [B, H, N] f32, written by the forward: log2 of the row sums of
//        exp2(scale * log2(e) * q k^T), i.e. the base-2 log-sum-exp
//   backward: dq, dk, dv [B, N, H, D] bf16 from do [B, N, H, D] bf16, with
//   delta [B, H, N] f32 scratch = rowsum(do * o).
//
// What bounds it on Hopper: tensor-core operations, 4 N^2 D per head
// forward and 10 N^2 D backward (the scores are recomputed) against
// 989 TFLOP/s in bf16; the bytes (q, k, v, o once) are a few MB. The design
// is the FlashAttention-2 schedule: the [N, N] scores never reach device
// memory. A block owns a tile of query rows (forward, dq) or of key rows
// (dk, dv) and loops over the other axis itself, where the TPU kernel
// walked a sequential grid axis with m / l / acc in VMEM scratch. The
// products are warp-level bf16 tensor-core tiles (WMMA 16x16x16, f32
// accumulation) read from shared memory, and the accumulators live in
// shared memory too, so one kernel covers head widths 40 (UNet, padded to
// 48) and 512 (VAE mid-block) without spilling registers. The
// backward takes two passes (dk/dv over query tiles, dq over key tiles)
// and so needs no atomics. Not yet fast: no TMA, no wgmma, no double
// buffering, and every accumulator tile goes through shared memory at
// every step; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Tile sizes: query rows (BQ) and key rows (BK) per block for the forward
// (F*) and the backward (B*); the UNet's narrow heads take 64-row tiles, the
// VAE's 512-wide head smaller ones to fit shared memory.
template <int DP>
struct Tiles {
  static constexpr bool kWide = DP > 128;
  static constexpr int FQ = kWide ? 32 : 64, FK = kWide ? 32 : 64;
  static constexpr int BQ = kWide ? 32 : 64, BK = kWide ? 16 : 64;
};

constexpr size_t fwd_smem(int DP, int BQ, int BK) {
  return (size_t(BQ) * DP + 2 * BK * DP + BQ * BK) * 2 +
         (size_t(BQ) * BK + BQ * DP + 2 * BQ) * 4;
}
constexpr size_t dkdv_smem(int DP, int BQ, int BK) {
  return (size_t(2) * BK * DP + 2 * BQ * DP + 2 * BQ * BK) * 2 +
         (size_t(2) * BQ * BK + 2 * BK * DP + 2 * BQ) * 4;
}
constexpr size_t dq_smem(int DP, int BQ, int BK) {
  return (size_t(2) * BQ * DP + 2 * BK * DP + BQ * BK) * 2 +
         (size_t(2) * BQ * BK + BQ * DP + 2 * BQ) * 4;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + ROWS) of one head (row n at src + n * stride) into
// dst [ROWS][DP], zero past N and past D; 16-byte loads where aligned.
template <int ROWS, int DP>
__device__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                          int N, int64_t stride, int D) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int n = row0 + r;
    union { uint4 u; unsigned short h[8]; } val;
    val.u = make_uint4(0, 0, 0, 0);
    if (n < N && c < D) {
      const bf16* p = src + n * stride + c;
      if (c + 8 <= D && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        val.u = *reinterpret_cast<const uint4*>(p);
      } else {
        const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
        for (int j = 0; j < 8 && c + j < D; ++j) val.h[j] = ps[j];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val.u;
  }
}

// Rows [row0, row0 + ROWS) of an f32 tile [ROWS][DP] in shared memory,
// times `mul`, to bf16 rows of one head, columns < D.
template <int ROWS, int DP>
__device__ void store_rows(bf16* __restrict__ dst, const float* src, int row0,
                           int N, int64_t stride, int D, float mul,
                           const float* row_div) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int n = row0 + r;
    if (n >= N) continue;
    float x = src[r * DP + c] * mul;
    if (row_div != nullptr) x /= row_div[r];
    dst[n * stride + c] = __float2bfloat16(x);
  }
}

// C [M][NC] (f32, shared, row-major, ldc) = (ACC ? C : 0) + A [M][KD] B [KD][NC].
// A is row-major (lda), or stored transposed if A_T: A(m, k) = a[k * lda + m].
// B is row-major (ldb), or stored transposed if B_T: B(k, n) = b[n * ldb + k].
// The 16x16 output tiles are dealt out to the block's warps.
template <int M, int NC, int KD, bool A_T, bool B_T, bool ACC>
__device__ void mma_tiles(float* c, int ldc, const bf16* a, int lda,
                          const bf16* b, int ldb) {
  constexpr int TM = M / 16, TN = NC / 16, TK = KD / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < TM * TN; t += kWarps) {
    const int tm = t / TN, tn = t % TN;
    float* cp = c + tm * 16 * ldc + tn * 16;
    FragC acc;
    if (ACC) {
      wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.0f);
    }
    for (int kk = 0; kk < TK; ++kk) {
      typename std::conditional<A_T, FragAT, FragA>::type fa;
      typename std::conditional<B_T, FragBT, FragB>::type fb;
      wmma::load_matrix_sync(fa, A_T ? a + kk * 16 * lda + tm * 16
                                     : a + tm * 16 * lda + kk * 16, lda);
      wmma::load_matrix_sync(fb, B_T ? b + tn * 16 * ldb + kk * 16
                                     : b + kk * 16 * ldb + tn * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
  }
}

// -- forward -------------------------------------------------------------------

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int N, int H, int D, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);     // [BQ][DP]
  bf16* sK = sQ + BQ * DP;                      // [BK][DP]
  bf16* sV = sK + BK * DP;                      // [BK][DP]
  bf16* sP = sV + BK * DP;                      // [BQ][BK] probabilities
  float* sS = reinterpret_cast<float*>(sP + BQ * BK);  // [BQ][BK] scores
  float* sO = sS + BQ * BK;                     // [BQ][DP] output accumulator
  float* sM = sO + BQ * DP;                     // [BQ] running max (base 2)
  float* sL = sM + BQ;                          // [BQ] running sum

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t head = (static_cast<int64_t>(b) * N * H + h) * D;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<BQ, DP>(sQ, q + head, q0, N, stride, D);
  for (int i = threadIdx.x; i < BQ * DP; i += kThreads) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    sM[i] = -INFINITY;
    sL[i] = 0.0f;
  }
  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();
    load_rows<BK, DP>(sK, k + head, k0, N, stride, D);
    load_rows<BK, DP>(sV, v + head, k0, N, stride, D);
    __syncthreads();
    mma_tiles<BQ, BK, DP, false, true, false>(sS, BK, sQ, DP, sK, DP);
    __syncthreads();
    // online softmax, one warp per row: new max, rescale sum and output
    for (int r = warp; r < BQ; r += kWarps) {
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) {
        if (k0 + c < N) mx = fmaxf(mx, sS[r * BK + c] * scale_log2);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float p = k0 + c < N ? exp2f(sS[r * BK + c] * scale_log2 - m_new)
                                   : 0.0f;
        sP[r * BK + c] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = exp2f(m_old - m_new);
      for (int c = lane; c < DP; c += 32) sO[r * DP + c] *= alpha;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncthreads();
    mma_tiles<BQ, DP, BK, false, false, true>(sO, DP, sP, BK, sV, DP);
  }
  __syncthreads();
  store_rows<BQ, DP>(o + head, sO, q0, N, stride, D, 1.0f, sL);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    if (q0 + r < N) lse[static_cast<int64_t>(bh) * N + q0 + r] = sM[r] + log2f(sL[r]);
  }
}

// -- backward ------------------------------------------------------------------

// delta[b, h, n] = sum_d do[b, n, h, d] * o[b, n, h, d]; one warp a row.
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      float* __restrict__ delta, int B, int N, int H, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(B) * N * H) return;
  const bf16* po = o + row * D;
  const bf16* pd = dout + row * D;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) {
    s += __bfloat162float(po[c]) * __bfloat162float(pd[c]);
  }
  s = warp_sum(s);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bn = row / H;
    const int n = static_cast<int>(bn % N);
    const int64_t b = bn / N;
    delta[(b * H + h) * N + n] = s;
  }
}

// Per-row statistics of query rows [q0, q0 + BQ) into shared memory.
template <int BQ>
__device__ void load_stats(float* s_lse, float* s_delta, const float* lse,
                           const float* delta, int64_t bh, int q0, int N) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int n = q0 + r;
    s_lse[r] = n < N ? lse[bh * N + n] : 0.0f;
    s_delta[r] = n < N ? delta[bh * N + n] : 0.0f;
  }
}

// P = exp2(S * scale_log2 - lse) and dS = P * (dP - delta) on one
// [BQ][BK] tile, zero outside the valid rows and columns.
template <int BQ, int BK>
__device__ void softmax_grad_tile(bf16* sP, bf16* sdS, const float* sS,
                                  const float* sdP, const float* s_lse,
                                  const float* s_delta, int q0, int k0, int N,
                                  float scale_log2) {
  for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
    const int r = i / BK, c = i % BK;
    const bool valid = q0 + r < N && k0 + c < N;
    const float p = valid ? exp2f(sS[i] * scale_log2 - s_lse[r]) : 0.0f;
    if (sP != nullptr) sP[i] = __float2bfloat16(p);
    sdS[i] = __float2bfloat16(p * (sdP[i] - s_delta[r]));
  }
}

// dk, dv for key rows [k0, k0 + BK), looping over all query tiles.
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int N, int H, int D,
                     float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);     // [BK][DP]
  bf16* sV = sK + BK * DP;                      // [BK][DP]
  bf16* sQ = sV + BK * DP;                      // [BQ][DP]
  bf16* sdO = sQ + BQ * DP;                     // [BQ][DP]
  bf16* sP = sdO + BQ * DP;                     // [BQ][BK]
  bf16* sdS = sP + BQ * BK;                     // [BQ][BK]
  float* sS = reinterpret_cast<float*>(sdS + BQ * BK);  // [BQ][BK]
  float* sdP = sS + BQ * BK;                    // [BQ][BK]
  float* sdK = sdP + BQ * BK;                   // [BK][DP]
  float* sdV = sdK + BK * DP;                   // [BK][DP]
  float* s_lse = sdV + BK * DP;                 // [BQ]
  float* s_delta = s_lse + BQ;                  // [BQ]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t head = (static_cast<int64_t>(b) * N * H + h) * D;
  const int k0 = blockIdx.x * BK;

  load_rows<BK, DP>(sK, k + head, k0, N, stride, D);
  load_rows<BK, DP>(sV, v + head, k0, N, stride, D);
  for (int i = threadIdx.x; i < BK * DP; i += kThreads) sdK[i] = sdV[i] = 0.0f;
  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();
    load_rows<BQ, DP>(sQ, q + head, q0, N, stride, D);
    load_rows<BQ, DP>(sdO, dout + head, q0, N, stride, D);
    load_stats<BQ>(s_lse, s_delta, lse, delta, bh, q0, N);
    __syncthreads();
    mma_tiles<BQ, BK, DP, false, true, false>(sS, BK, sQ, DP, sK, DP);
    mma_tiles<BQ, BK, DP, false, true, false>(sdP, BK, sdO, DP, sV, DP);
    __syncthreads();
    softmax_grad_tile<BQ, BK>(sP, sdS, sS, sdP, s_lse, s_delta, q0, k0, N,
                              scale_log2);
    __syncthreads();
    mma_tiles<BK, DP, BQ, true, false, true>(sdV, DP, sP, BK, sdO, DP);
    mma_tiles<BK, DP, BQ, true, false, true>(sdK, DP, sdS, BK, sQ, DP);
  }
  __syncthreads();
  store_rows<BK, DP>(dk + head, sdK, k0, N, stride, D, scale, nullptr);
  store_rows<BK, DP>(dv + head, sdV, k0, N, stride, D, 1.0f, nullptr);
}

// dq for query rows [q0, q0 + BQ), looping over all key tiles.
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int N, int H, int D, float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);     // [BQ][DP]
  bf16* sdO = sQ + BQ * DP;                     // [BQ][DP]
  bf16* sK = sdO + BQ * DP;                     // [BK][DP]
  bf16* sV = sK + BK * DP;                      // [BK][DP]
  bf16* sdS = sV + BK * DP;                     // [BQ][BK]
  float* sS = reinterpret_cast<float*>(sdS + BQ * BK);  // [BQ][BK]
  float* sdP = sS + BQ * BK;                    // [BQ][BK]
  float* sdQ = sdP + BQ * BK;                   // [BQ][DP]
  float* s_lse = sdQ + BQ * DP;                 // [BQ]
  float* s_delta = s_lse + BQ;                  // [BQ]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t head = (static_cast<int64_t>(b) * N * H + h) * D;
  const int q0 = blockIdx.x * BQ;

  load_rows<BQ, DP>(sQ, q + head, q0, N, stride, D);
  load_rows<BQ, DP>(sdO, dout + head, q0, N, stride, D);
  load_stats<BQ>(s_lse, s_delta, lse, delta, bh, q0, N);
  for (int i = threadIdx.x; i < BQ * DP; i += kThreads) sdQ[i] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();
    load_rows<BK, DP>(sK, k + head, k0, N, stride, D);
    load_rows<BK, DP>(sV, v + head, k0, N, stride, D);
    __syncthreads();
    mma_tiles<BQ, BK, DP, false, true, false>(sS, BK, sQ, DP, sK, DP);
    mma_tiles<BQ, BK, DP, false, true, false>(sdP, BK, sdO, DP, sV, DP);
    __syncthreads();
    softmax_grad_tile<BQ, BK>(nullptr, sdS, sS, sdP, s_lse, s_delta, q0, k0,
                              N, scale_log2);
    __syncthreads();
    mma_tiles<BQ, DP, BK, false, false, true>(sdQ, DP, sdS, BK, sK, DP);
  }
  __syncthreads();
  store_rows<BQ, DP>(dq + head, sdQ, q0, N, stride, D, scale, nullptr);
}

// -- launchers -----------------------------------------------------------------

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int DP>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
               int B, int N, int H, int D, float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<DP>::FQ, BK = Tiles<DP>::FK;
  constexpr size_t smem = fwd_smem(DP, BQ, BK);
  auto kernel = attn_fwd_kernel<DP, BQ, BK>;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, N, H, D, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* delta, bf16* dq, bf16* dk,
               bf16* dv, int B, int N, int H, int D, float scale,
               cudaStream_t stream) {
  constexpr int BQ = Tiles<DP>::BQ, BK = Tiles<DP>::BK;
  constexpr size_t smem_kv = dkdv_smem(DP, BQ, BK);
  constexpr size_t smem_q = dq_smem(DP, BQ, BK);
  auto kv = attn_bwd_dkdv_kernel<DP, BQ, BK>;
  auto kq = attn_bwd_dq_kernel<DP, BQ, BK>;
  if (int err = prepare(kv, smem_kv)) return err;
  if (int err = prepare(kq, smem_q)) return err;
  kv<<<dim3((N + BK - 1) / BK, B * H), kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, N, H, D, scale * kLog2e, scale);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  kq<<<dim3((N + BQ - 1) / BQ, B * H), kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, N, H, D, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

// Head widths are padded with zeros to the next of these (a multiple of 16):
// the main path's heads are 40 wide (UNet at 64x64 latents) and 512 (VAE).
#define FOR_EACH_WIDTH(X) X(48) X(512)

int padded_width(int D) {
#define PICK(W) if (D <= W) return W;
  FOR_EACH_WIDTH(PICK)
#undef PICK
  return -1;
}

static_assert(fwd_smem(512, 32, 32) <= 232448, "forward tile too large");
static_assert(dkdv_smem(512, 32, 16) <= 232448, "dk/dv tile too large");
static_assert(dq_smem(512, 32, 16) <= 232448, "dq tile too large");

}  // namespace

extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int N, int H, int D,
                             float scale, void* stream) {
  if (B * H == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *pq = static_cast<const bf16*>(q), *pk = static_cast<const bf16*>(k),
             *pv = static_cast<const bf16*>(v);
  bf16* po = static_cast<bf16*>(o);
  float* pl = static_cast<float*>(lse);
  switch (padded_width(D)) {
#define CASE(W) case W: return launch_fwd<W>(pq, pk, pv, po, pl, B, N, H, D, scale, s);
    FOR_EACH_WIDTH(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int N, int H, int D, float scale, void* stream) {
  if (B * H == 0 || N == 0) return 0;
  const int width = padded_width(D);
  if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *pq = static_cast<const bf16*>(q), *pk = static_cast<const bf16*>(k),
             *pv = static_cast<const bf16*>(v), *pdo = static_cast<const bf16*>(dout);
  const float* pl = static_cast<const float*>(lse);
  float* pd = static_cast<float*>(delta);
  bf16 *pdq = static_cast<bf16*>(dq), *pdk = static_cast<bf16*>(dk),
       *pdv = static_cast<bf16*>(dv);
  const int64_t rows = static_cast<int64_t>(B) * N * H;
  attn_bwd_delta_kernel<<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                          kThreads, 0, s>>>(static_cast<const bf16*>(o), pdo, pd,
                                            B, N, H, D);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  switch (width) {
#define CASE(W) case W: return launch_bwd<W>(pq, pk, pv, pdo, pl, pd, pdq, pdk, pdv, B, N, H, D, scale, s);
    FOR_EACH_WIDTH(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
