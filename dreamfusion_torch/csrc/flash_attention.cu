// Flash attention, forward and backward, for the SD UNet's and VAE's
// self-attention over 64x64 latents (N = 4,096 tokens), written for Hopper
// (sm_90a): TMA loads completed on mbarriers, wgmma with f32 accumulators
// in registers.
//
// Replaces the TPU kernel that dreamfusion_tpu/guidance/sd/layers.py::
// attention_core reaches on its flash branch (layers.py:125-131): the
// stock jax.experimental.pallas.ops.tpu.flash_attention, forward and
// backward.
//
// Contract (per batch b and head h):
//   q, k, v, o  [B, N, H, D] bf16, contiguous: the JAX layout at
//               attention_core, heads are not transposed out; D % 8 == 0
//               (TMA strides are multiples of 16 bytes), D <= 512
//   o    = softmax(scale * q k^T) v, scores, softmax and sums in f32
//   lse  [B, H, N] f32, written by the forward: log2 of the row sums of
//        exp2(scale * log2(e) * q k^T), i.e. the base-2 log-sum-exp
//   backward: dq, dk, dv [B, N, H, D] bf16 from do [B, N, H, D] bf16, with
//   delta [B, H, N] f32 = rowsum(do * o).
//
// What bounds it on Hopper: tensor-core operations, 4 N^2 D per head
// forward and 10 N^2 D backward, against 989 TFLOP/s in bf16; the bytes
// (q, k, v, o, lse once) are a few MB. What the design does about it:
//
// * Narrow heads (D <= 64; the UNet's 40): attn_fwd_narrow, the
//   FlashAttention-3 schedule. One producer warpgroup issues TMA loads (Q
//   once, K and V tiles of 128 keys into a ring of three stages with full
//   and empty mbarriers) and gives its registers to two consumer
//   warpgroups (setmaxnreg), each of which owns 64 query rows. S = Q K^T is
//   a chain of wgmma.m64n128k16 into registers; the online softmax runs on
//   the accumulator layout (row max and sum over the 4 threads of a row,
//   exp2 with the base-2 scale); P becomes the register A operand of
//   O += P V (wgmma.m64n64k16, V read through an MN-major descriptor); O, m
//   and l never leave registers. Tile j's S and tile j-1's P V are issued
//   together, in turns that two named barriers pass between the consumer
//   warpgroups, so that one's softmax runs under the other's products. The
//   head is padded to 64 columns by TMA's out-of-bounds zero fill, so that
//   every row is one 128-byte swizzle row, the layout all operands here
//   share; Q K^T skips the fourth 16-deep step for heads up to 48 wide, so
//   the MMA work at D = 40 is 1.4x the unpadded (P V stays 64 wide).
//   On an H100 at the UNet's shape it runs within a few percent of SDPA's
//   time, ~28% of the bound; neither a polynomial exp2 on the FMA pipes for
//   part of the scores nor skipping the rescale of O while the row max
//   grows by less than 8 made it faster.
// * Wide heads (64 < D <= 512; the VAE's 512): the materialized schedule,
//   on one warp-specialized wgmma GEMM (gemm_kernel: C = A B, 128 x 128
//   output tiles, a four-stage TMA ring of 64-deep K tiles, operands K- or
//   MN-major as the descriptor says) with fused epilogues. Forward: S =
//   scale log2(e) Q K^T in f32, a row pass (P = exp2(S - lse) in bf16, lse),
//   O = P V. At one head of 512 and N = 4,096 the fused form has 64 query
//   tiles for 132 SMs and a 512-deep QK^T of narrow wgmmas; the GEMMs run
//   1,024 and 128 tiles, and the [N, N] round trip (S f32 64 MB, P 32 MB)
//   costs ~0.03 ms at 3.35 TB/s, mostly in the 50 MB L2.
// * Backward (every width): delta = rowsum(do o) (attn_bwd_delta), then
//   per (b, h): (a) P = exp2(scale log2(e) Q K^T - lse), bf16; (b) dS =
//   P (dO V^T - delta), bf16; (c) dV = P^T dO; (d) dK = scale dS^T Q; (e)
//   dQ = scale dS K: 10 N^2 D operations, where a fused flash backward at
//   D = 512 would need dK and dV of 64 keys in registers (256 KB, the whole
//   register file of an SM). P and dS enter their products in bf16, and dS
//   takes P as stored. The caller owns the scratch (P, dS [pairs, N, Np],
//   Np = N rounded up to 8) and walks the (b, h) pairs in chunks.
//
// TMA descriptors are encoded on the host in the launchers;
// cuTensorMapEncodeTiled, a libcuda entry point, is reached through
// cudaGetDriverEntryPoint (no link flag). wgmma, TMA and mbarriers are inline PTX.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kThreads = 3 * kWG;        // producer + two consumer warpgroups
constexpr int kNarrow = 64;              // widest head of the narrow kernel (NARROW_HEAD_DIM
                                         // in ops/flash_attention.py)
constexpr uint32_t kAtom = 64 * 128;     // 64 rows of one 128-byte swizzle row

// -- PTX helpers -----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait of more than 2^34 clocks (seconds) means a broken pipeline: it traps,
// so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (int spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done) {
      if (spin == 0) {
        t0 = clock64();
      } else if (clock64() - t0 > (1ll << 34)) {
        __trap();
      }
    }
  }
}

// One 4-D box of `map` at coordinates (c0, c1, c2, c3) into shared memory at
// dst; completion (the box's bytes) is reported to the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// K-major operands: rows of 128 bytes (64 bf16 along K), 8-row groups
// `sbo` = 1024 bytes apart; a 16-deep K step adds 32 bytes to the start.
// MN-major operands: 64 bf16 along M or N in a 128-byte row, K along the
// rows; `sbo` = 1024 between 8-row groups of K, `lbo` between 64-wide
// atoms along M or N; a 16-deep K step adds 2,048 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define D8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A (64 x 16, shared) B (16 x 128, shared); TA / TB: 0 = K-major,
// 1 = MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[32] += A (64 x 16, registers: the accumulator layout packed to bf16)
// B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma accumulator layout of m64nN: thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 and that + 8; register i holds column
// 8 (i / 4) + 2 (t % 4) + (i % 2) of row (i / 2) % 2.
__device__ __forceinline__ int acc_row(int t) { return 16 * (t / 32) + (t % 32) / 4; }
__device__ __forceinline__ int acc_col(int t) { return 2 * (t % 4); }

// -- forward, narrow heads ------------------------------------------------------

constexpr int kFQ = 128;                 // query rows of a block
constexpr int kFK = 128;                 // keys of a tile
constexpr int kFStages = 3;
constexpr uint32_t kFTile = 128 * 128;   // a Q, K or V tile: 128 rows x 128 B
constexpr size_t kFwdSmem = 1024 + (1 + 2 * kFStages) * kFTile + 8 * (1 + 2 * kFStages);

// Named barriers 1 and 2 pass the turn to issue wgmmas between the two
// consumer warpgroups (barrier 0 is __syncthreads').
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(2 * kWG) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(2 * kWG) : "memory");
}

// The online softmax of one tile of scores on the accumulator layout: keys
// at or past `lim` (the ragged last tile) to -inf, the running base-2 max m
// updated (alpha = exp2(m_old - m_new)), sc replaced by exp2(scale_log2 sc
// - m) and this thread's share of each row's sum of it.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&alpha)[2], float (&sum)[2],
                                             int lim, int col, float scale_log2) {
  if (lim < kFK) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (8 * (i / 4) + col + (i % 2) >= lim) sc[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if ((i / 2) % 2 == r) mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    sum[r] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m[r]));
    sum[r] += sc[i];
  }
}

// P in bf16 as the A operand of P V: for keys 16 kb .. 16 kb + 15 the
// fragment is the accumulator registers 8 kb .. 8 kb + 7, in pairs.
__device__ __forceinline__ void pack_probs(uint32_t (&pp)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) pp[kb][e] = pack_bf16(sc[8 * kb + 2 * e], sc[8 * kb + 2 * e + 1]);
  }
}

// KSTEPS: 16-deep steps of Q K^T, 3 for heads up to 48 wide (the padding
// past 48 is zeros), else 4.
template <int KSTEPS>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_narrow(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                float* __restrict__ lse, int N, int H, int D, int pair0,
                float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kFTile;                  // [stage][128 keys][64]
  const uint32_t sV = sK + kFStages * kFTile;       // [stage][128 keys][64]
  const uint32_t bar_q = sV + kFStages * kFTile;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * kFStages;

  const int pair = pair0 + blockIdx.y, b = pair / H, h = pair % H;
  const int q0 = blockIdx.x * kFQ;
  const int n_tiles = (N + kFK - 1) / kFK;
  const int wg = threadIdx.x / kWG;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kFTile);
      tma_load(sQ, &map_q, 0, h, q0, b, bar_q);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kFStages;
        if (j >= kFStages) mbar_wait(bar_empty + 8 * s, ((j / kFStages) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * kFTile);
        tma_load(sK + s * kFTile, &map_k, 0, h, j * kFK, b, bar_full + 8 * s);
        tma_load(sV + s * kFTile, &map_v, 0, h, j * kFK, b, bar_full + 8 * s);
      }
    }
  } else {
    // consumers. Tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued
    // together in this warpgroup's turn, so that the softmax of S_j runs
    // while the other warpgroup's products hold the tensor cores (the
    // FlashAttention-3 ping-pong); the last P V follows the loop.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int c = wg - 1;                   // rows q0 + 64c .. q0 + 64c + 63
    const int t = threadIdx.x % kWG;
    const int r0 = acc_row(t), col = acc_col(t);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};    // running max of scale_log2 * s
    float l[2] = {0.0f, 0.0f};              // this thread's share of the row sum
    float sc[64];
    uint32_t pp[8][4];                      // P of the previous tile, bf16 pairs
    float alpha[2], sum[2];
    const uint64_t dq = make_desc(sQ + c * kAtom, 16, 1024);
    if (c == 1) turn_pass(1);               // warpgroup 0 takes the first turn
    mbar_wait(bar_q, 0);

    // tile 0: S only (no wgmma sits in a conditional path: ptxas would
    // serialize them)
    mbar_wait(bar_full, 0);
    turn_wait(1 + c);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      wgmma_ss_n128<0, 0>(sc, dq + 2 * kk, make_desc(sK, 16, 1024) + 2 * kk, kk > 0);
    }
    wgmma_commit();
    if (c == 0 || n_tiles > 1) turn_pass(2 - c);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m, alpha, sum, N, col, scale_log2);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = sum[r];
    pack_probs(pp, sc);

    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kFStages, sp = (j - 1) % kFStages;
      mbar_wait(bar_full + 8 * s, (j / kFStages) & 1);
      const uint64_t dk = make_desc(sK + s * kFTile, 16, 1024);
      const uint64_t dv = make_desc(sV + sp * kFTile, 1024, 1024);
      turn_wait(1 + c);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        wgmma_ss_n128<0, 0>(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) wgmma_rs_n64(acc, pp[kb], dv + (2048 >> 4) * kb);
      wgmma_commit();
      if (c == 0 || j + 1 < n_tiles) turn_pass(2 - c);
      wgmma_wait<1>();                      // S_j is done, P V may still run
      fence_regs(sc);
      softmax_tile(sc, m, alpha, sum, N - j * kFK, col, scale_log2);
      wgmma_wait<0>();                      // O += P_{j-1} V_{j-1} is done
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * sp);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i / 2) % 2];
      pack_probs(pp, sc);
    }
    {
      const uint64_t dv = make_desc(sV + ((n_tiles - 1) % kFStages) * kFTile, 1024, 1024);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) wgmma_rs_n64(acc, pp[kb], dv + (2048 >> 4) * kb);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int n = q0 + 64 * c + r0 + 8 * r;
      if (n >= N) continue;
      const float inv = 1.0f / l[r];
      bf16* row = o + ((static_cast<int64_t>(b) * N + n) * H + h) * D;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int cc = 8 * jb + col;
        if (cc < D) {
          *reinterpret_cast<uint32_t*>(row + cc) =
              pack_bf16(acc[4 * jb + 2 * r] * inv, acc[4 * jb + 2 * r + 1] * inv);
        }
      }
      if (col == 0) lse[static_cast<int64_t>(pair) * N + n] = m[r] + log2f(l[r]);
    }
  }
}

// -- the GEMM of the materialized schedule ----------------------------------

constexpr int kGM = 128, kGN = 128, kGK = 64, kGStages = 4;
constexpr uint32_t kGTile = 128 * 128;   // an A or a B tile of a stage: 16 KB
constexpr size_t kGemmSmem = 1024 + 2 * kGStages * kGTile + 16 * kGStages;

enum Epilogue {
  kEpiScores = 0,   // S (f32 scratch) = alpha C; columns N..Np-1 -inf
  kEpiProbs = 1,    // P (bf16 scratch) = exp2(alpha C - lse[row]); padding 0
  kEpiDScores = 2,  // dS (bf16 scratch) = P (C - delta[row])
  kEpiOut = 3,      // [B, N, H, D] bf16 = alpha C, columns < D
};

struct GemmArgs {
  int Kdim;        // contraction length
  int N, Np, H, D, pair0;
  int a_scratch, b_scratch;   // operand coordinates (x, 0, y, z) or (x, h, y, b)
  void* out;
  const bf16* probs;          // kEpiDScores: P
  const float* rowvec;        // lse (kEpiProbs) or delta (kEpiDScores), [B H, N]
  float alpha;
};

// C [M, Ncols] = A [M, Kdim] B [Kdim, Ncols] for the (b, h) pair
// pair0 + blockIdx.z; one 128 x 128 tile of C a block, rows 64 c .. 64 c + 63
// to consumer warpgroup c. A_MN / B_MN: the operand is MN-major in memory
// (A(m, k) at row k, column m of its tensor), else K-major.
template <int A_MN, int B_MN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const GemmArgs args) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sA = base, sB = base + kGStages * kGTile;
  const uint32_t bar_full = sB + kGStages * kGTile;
  const uint32_t bar_empty = bar_full + 8 * kGStages;

  const int z = blockIdx.z, pair = args.pair0 + z;
  const int b = pair / args.H, h = pair % args.H;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int k_tiles = (args.Kdim + kGK - 1) / kGK;
  const int wg = threadIdx.x / kWG;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if (threadIdx.x == 0) {
      const int a1 = args.a_scratch ? 0 : h, a3 = args.a_scratch ? z : b;
      const int b1 = args.b_scratch ? 0 : h, b3 = args.b_scratch ? z : b;
      for (int t = 0; t < k_tiles; ++t) {
        const int s = t % kGStages, k0 = t * kGK;
        if (t >= kGStages) mbar_wait(bar_empty + 8 * s, ((t / kGStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * kGTile);
        if (A_MN) {
          tma_load(sA + s * kGTile, &map_a, m0, a1, k0, a3, full);
          tma_load(sA + s * kGTile + kAtom, &map_a, m0 + 64, a1, k0, a3, full);
        } else {
          tma_load(sA + s * kGTile, &map_a, k0, a1, m0, a3, full);
        }
        if (B_MN) {
          tma_load(sB + s * kGTile, &map_b, n0, b1, k0, b3, full);
          tma_load(sB + s * kGTile + kAtom, &map_b, n0 + 64, b1, k0, b3, full);
        } else {
          tma_load(sB + s * kGTile, &map_b, k0, b1, n0, b3, full);
        }
      }
    }
  } else {
    const int c = wg - 1;
    const int t = threadIdx.x % kWG;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    // a 16-deep K step: 32 bytes along a K-major row, 16 rows of an MN-major tile
    constexpr uint32_t step_a = A_MN ? 2048 >> 4 : 32 >> 4;
    constexpr uint32_t step_b = B_MN ? 2048 >> 4 : 32 >> 4;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kGStages;
      mbar_wait(bar_full + 8 * s, (kt / kGStages) & 1);
      const uint64_t da = make_desc(sA + s * kGTile + c * kAtom, 16, 1024);
      const uint64_t db = make_desc(sB + s * kGTile, B_MN ? kAtom : 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128<A_MN, B_MN>(d, da + step_a * kk, db + step_b * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();                      // the previous tile's products are done
      if (kt > 0) mbar_arrive(bar_empty + 8 * ((kt - 1) % kGStages));
    }
    wgmma_wait<0>();
    fence_regs(d);

    const int N = args.N, Np = args.Np;
    const int col = acc_col(t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * c + acc_row(t) + 8 * r;
      if (row >= N) continue;
      const int64_t srow = (static_cast<int64_t>(z) * N + row) * Np;
      float rv = 0.0f;
      if (EPI == kEpiProbs || EPI == kEpiDScores) {
        rv = args.rowvec[static_cast<int64_t>(pair) * N + row];
      }
#pragma unroll
      for (int jb = 0; jb < 16; ++jb) {
        const int cc = n0 + 8 * jb + col;
        const float x0 = d[4 * jb + 2 * r], x1 = d[4 * jb + 2 * r + 1];
        if (EPI == kEpiOut) {
          if (cc < args.D) {
            bf16* out = static_cast<bf16*>(args.out) +
                        ((static_cast<int64_t>(b) * N + row) * args.H + h) * args.D;
            *reinterpret_cast<uint32_t*>(out + cc) =
                pack_bf16(x0 * args.alpha, x1 * args.alpha);
          }
        } else if (cc < Np) {
          if (EPI == kEpiScores) {
            float2 v;
            v.x = cc < N ? x0 * args.alpha : -INFINITY;
            v.y = cc + 1 < N ? x1 * args.alpha : -INFINITY;
            *reinterpret_cast<float2*>(static_cast<float*>(args.out) + srow + cc) = v;
          } else if (EPI == kEpiProbs) {
            const float p0 = cc < N ? fast_exp2(fmaf(x0, args.alpha, -rv)) : 0.0f;
            const float p1 = cc + 1 < N ? fast_exp2(fmaf(x1, args.alpha, -rv)) : 0.0f;
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(args.out) + srow + cc) =
                pack_bf16(p0, p1);
          } else {
            const __nv_bfloat162 p =
                *reinterpret_cast<const __nv_bfloat162*>(args.probs + srow + cc);
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(args.out) + srow + cc) =
                pack_bf16(__low2float(p) * (x0 - rv), __high2float(p) * (x1 - rv));
          }
        }
      }
    }
  }
}

// -- row passes -------------------------------------------------------------------

// Running (max, sum of exp2(x - max)) pairs merged; -inf maxima carry nothing.
__device__ __forceinline__ void merge_ml(float& m, float& l, float m2, float l2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    l = l2;
    return;
  }
  const float mx = fmaxf(m, m2);
  l = l * exp2f(m - mx) + l2 * exp2f(m2 - mx);
  m = mx;
}

// Wide forward: one block a row of S (base-2 logits, f32): lse, and P =
// exp2(S - lse) in bf16 over the row's Np columns (0 past N).
__global__ void __launch_bounds__(256)
attn_softmax_rows(const float* __restrict__ S, bf16* __restrict__ P,
                  float* __restrict__ lse, int N, int Np, int pair0) {
  __shared__ float sm[8], sl[8];
  const int row = blockIdx.x, z = blockIdx.y;
  const int64_t off = (static_cast<int64_t>(z) * N + row) * Np;
  const float* s = S + off;
  float m = -INFINITY, l = 0.0f;
  for (int c = threadIdx.x * 4; c < N; c += 256 * 4) {
    const float4 x = *reinterpret_cast<const float4*>(s + c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < N) merge_ml(m, l, xs[e], 1.0f);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge_ml(m, l, m2, l2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  m = sm[0];
  l = sl[0];
  for (int w = 1; w < 8; ++w) merge_ml(m, l, sm[w], sl[w]);
  const float row_lse = m + log2f(l);
  if (threadIdx.x == 0) lse[(static_cast<int64_t>(pair0) + z) * N + row] = row_lse;
  bf16* p = P + off;
  for (int c = threadIdx.x * 4; c < Np; c += 256 * 4) {
    const float4 x = *reinterpret_cast<const float4*>(s + c);
    uint2 v;
    v.x = pack_bf16(c < N ? exp2f(x.x - row_lse) : 0.0f,
                    c + 1 < N ? exp2f(x.y - row_lse) : 0.0f);
    v.y = pack_bf16(c + 2 < N ? exp2f(x.z - row_lse) : 0.0f,
                    c + 3 < N ? exp2f(x.w - row_lse) : 0.0f);
    *reinterpret_cast<uint2*>(p + c) = v;
  }
}

// delta[b, h, n] = sum_d do[b, n, h, d] * o[b, n, h, d]; one warp a row.
__global__ void __launch_bounds__(128)
attn_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               float* __restrict__ delta, int B, int N, int H, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(B) * N * H) return;
  const bf16* po = o + row * D;
  const bf16* pd = dout + row * D;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) {
    s += __bfloat162float(po[c]) * __bfloat162float(pd[c]);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bn = row / H;
    const int n = static_cast<int>(bn % N);
    const int64_t b = bn / N;
    delta[(b * H + h) * N + n] = s;
  }
}

// -- host side --------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kErrNoEncoder = 900;      // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 1000;        // + the CUresult of a refused encode

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 tensor map (dim0 contiguous, then dim1..dim3 at the given byte
// strides) read in boxes of 64 x 1 x rows x 1, 128-byte swizzle, zeros out
// of bounds.
int make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
             uint64_t d2, uint64_t d3, uint64_t s1, uint64_t s2, uint64_t s3,
             uint32_t rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {s1, s2, s3};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// [B, N, H, D] as (D, H, N, B)
int map_bnhd(CUtensorMap* map, const void* p, int B, int N, int H, int D, uint32_t rows) {
  const uint64_t e = sizeof(bf16);
  return make_map(map, p, D, H, N, B, e * D, e * H * D, e * N * H * D, rows);
}

// scratch [pairs, N, Np] as (Np, 1, N, pairs)
int map_scratch(CUtensorMap* map, const void* p, int pairs, int N, int Np, uint32_t rows) {
  const uint64_t e = sizeof(bf16);
  return make_map(map, p, Np, 1, N, pairs, e * Np, e * Np, e * N * Np, rows);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// C = A B over pairs [pair0, pair0 + pairs): M rows, ncols columns.
template <int A_MN, int B_MN, int EPI>
int gemm(const CUtensorMap& ma, const CUtensorMap& mb, const GemmArgs& args, int M,
         int ncols, int pairs, cudaStream_t stream) {
  auto kernel = gemm_kernel<A_MN, B_MN, EPI>;
  if (int err = prepare(kernel, kGemmSmem)) return err;
  const dim3 grid((ncols + kGN - 1) / kGN, (M + kGM - 1) / kGM, pairs);
  kernel<<<grid, kThreads, kGemmSmem, stream>>>(ma, mb, args);
  return static_cast<int>(cudaGetLastError());
}

// The rows of a box: 128 for a K-major operand, 64 (two boxes) for MN-major.
constexpr uint32_t kRowsK = 128, kRowsMN = 64;

}  // namespace

// Forward over the (b, h) pairs [pair0, pair0 + pairs). Narrow heads ignore
// the scratch; wide heads use S (f32) and P (bf16), each [pairs, N, Np].
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, void* S, void* P, int B, int N, int H, int D,
                             int Np, int pair0, int pairs, float scale, void* stream) {
  if (pairs == 0 || N == 0) return 0;
  if (D % 8 != 0 || D > 512) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  if (D <= kNarrow) {
    CUtensorMap mq, mk, mv;
    if (int err = map_bnhd(&mq, q, B, N, H, D, kFQ)) return err;
    if (int err = map_bnhd(&mk, k, B, N, H, D, kFK)) return err;
    if (int err = map_bnhd(&mv, v, B, N, H, D, kFK)) return err;
    auto kernel = D <= 48 ? attn_fwd_narrow<3> : attn_fwd_narrow<4>;
    if (int err = prepare(kernel, kFwdSmem)) return err;
    const dim3 grid((N + kFQ - 1) / kFQ, pairs);
    kernel<<<grid, kThreads, kFwdSmem, st>>>(mq, mk, mv, static_cast<bf16*>(o),
                                             static_cast<float*>(lse), N, H, D,
                                             pair0, scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap mq, mk, mp, mv;
  if (int err = map_bnhd(&mq, q, B, N, H, D, kRowsK)) return err;
  if (int err = map_bnhd(&mk, k, B, N, H, D, kRowsK)) return err;
  if (int err = map_scratch(&mp, P, pairs, N, Np, kRowsK)) return err;
  if (int err = map_bnhd(&mv, v, B, N, H, D, kRowsMN)) return err;
  GemmArgs a = {D, N, Np, H, D, pair0, 0, 0, S, nullptr, nullptr, scale_log2};
  if (int err = gemm<0, 0, kEpiScores>(mq, mk, a, N, N, pairs, st)) return err;
  attn_softmax_rows<<<dim3(N, pairs), 256, 0, st>>>(
      static_cast<const float*>(S), static_cast<bf16*>(P), static_cast<float*>(lse), N,
      Np, pair0);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  a.Kdim = N;
  a.a_scratch = 1;
  a.out = o;
  a.alpha = 1.0f;
  return gemm<0, 1, kEpiOut>(mp, mv, a, N, D, pairs, st);
}

// delta = rowsum(do * o) over all rows; before attention_bwd.
extern "C" int attention_bwd_delta(const void* o, const void* dout, void* delta, int B,
                                   int N, int H, int D, void* stream) {
  const int64_t rows = static_cast<int64_t>(B) * N * H;
  if (rows == 0) return 0;
  attn_bwd_delta<<<static_cast<unsigned>((rows + 3) / 4), 128, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), B, N, H, D);
  return static_cast<int>(cudaGetLastError());
}

// Backward over the (b, h) pairs [pair0, pair0 + pairs), with P and dS
// scratch [pairs, N, Np] bf16.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* P, void* dS, void* dq, void* dk, void* dv, int B,
                             int N, int H, int D, int Np, int pair0, int pairs,
                             float scale, void* stream) {
  if (pairs == 0 || N == 0) return 0;
  if (D % 8 != 0 || D > 512) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap q_k, k_k, v_k, do_k, q_mn, k_mn, do_mn, p_mn, ds_mn, ds_k;
  if (int err = map_bnhd(&q_k, q, B, N, H, D, kRowsK)) return err;
  if (int err = map_bnhd(&k_k, k, B, N, H, D, kRowsK)) return err;
  if (int err = map_bnhd(&v_k, v, B, N, H, D, kRowsK)) return err;
  if (int err = map_bnhd(&do_k, dout, B, N, H, D, kRowsK)) return err;
  if (int err = map_bnhd(&q_mn, q, B, N, H, D, kRowsMN)) return err;
  if (int err = map_bnhd(&k_mn, k, B, N, H, D, kRowsMN)) return err;
  if (int err = map_bnhd(&do_mn, dout, B, N, H, D, kRowsMN)) return err;
  if (int err = map_scratch(&p_mn, P, pairs, N, Np, kRowsMN)) return err;
  if (int err = map_scratch(&ds_mn, dS, pairs, N, Np, kRowsMN)) return err;
  if (int err = map_scratch(&ds_k, dS, pairs, N, Np, kRowsK)) return err;
  const float* pl = static_cast<const float*>(lse);
  const float* pd = static_cast<const float*>(delta);
  const bf16* pp = static_cast<const bf16*>(P);
  // (a) P = exp2(scale log2(e) Q K^T - lse)
  GemmArgs a = {D, N, Np, H, D, pair0, 0, 0, P, nullptr, pl, scale * kLog2e};
  if (int err = gemm<0, 0, kEpiProbs>(q_k, k_k, a, N, N, pairs, st)) return err;
  // (b) dS = P (dO V^T - delta)
  a.out = dS;
  a.probs = pp;
  a.rowvec = pd;
  a.alpha = 1.0f;
  if (int err = gemm<0, 0, kEpiDScores>(do_k, v_k, a, N, N, pairs, st)) return err;
  // (c) dV = P^T dO: A = P^T (MN-major), B = dO (N-major)
  a.Kdim = N;
  a.a_scratch = 1;
  a.out = dv;
  if (int err = gemm<1, 1, kEpiOut>(p_mn, do_mn, a, N, D, pairs, st)) return err;
  // (d) dK = scale dS^T Q
  a.out = dk;
  a.alpha = scale;
  if (int err = gemm<1, 1, kEpiOut>(ds_mn, q_mn, a, N, D, pairs, st)) return err;
  // (e) dQ = scale dS K
  a.out = dq;
  return gemm<0, 1, kEpiOut>(ds_k, k_mn, a, N, D, pairs, st);
}
