// Grid-encoder backward scatters: the table gradient of the
// multiresolution grid encoder, all levels in one launch. Two entries:
// grid_encoder_bwd (kernel A, encoders whose levels are all affine: the
// tiled grid) and grid_encoder_bwd_rows (kernel E, encoders with a hashed
// level; described above its kernel below).
//
// Kernel A
// --------
// Replaces the TPU kernels dreamfusion_tpu/ops/pallas_scatter.py::
// matmul_scatter_add_oct_binned (bodies _scatter_kernel_oct_binned_t /
// _scatter_kernel_oct_binned) and ::matmul_scatter_add_oct (bodies
// _scatter_kernel_oct2 / _scatter_kernel_oct), called per level from
// dreamfusion_tpu/ops/grid_encoder.py::_make_encode_levels_oct._bwd.
//
// Contract (the JAX VJP's residuals, unchanged):
//   base [L, B] int32   local row of corner 0 of sample j at level l
//   w    [L, 8, B] f32  trilinear corner weights
//   cot  [B, L, 2] f32  cotangent of the encoder output
//   table [L, 10] int32 per level: size, offset, 8 corner offsets (each in
//                       [0, size))
//   d_emb [T, 2] f32    zero-initialised by the caller; receives
//     d_emb[offset_l + (base + corner_off_{l,c}) % size_l, k] += w[c] * cot[k]
//
// What bounds it on Hopper: atomics. Each (sample, level) reads 4 + 32 + 8
// bytes and makes 8 row updates into a 7.2 MB table that stays in the 50
// MB L2. The samples arrive ray-ordered and a ray marches 0.0034 of the
// unit box a step, so at the coarse levels some 2-20 consecutive samples
// share a cell, and their updates land on the same rows: plain atomics
// serialize there. The TPU kernels sort the updates and multiply one-hot
// windows on the MXU because the TPU has no scatter hardware; none of that
// is kept. Instead, consecutive lanes of a warp take consecutive samples of
// one level. A __match_any_sync on corner 0's row finds the lanes of one
// cell (the same corner-0 row gives the same 8 rows); a segmented shuffle
// sum over each contiguous run of such lanes leaves the run's 8 float2 sums
// on its first lane, which alone updates the 8 rows, with one float2 atomic
// (sm_90) each (a cell met again later in the warp starts a run of its
// own). On the fine levels, where lanes rarely share a cell, the match
// costs no measurable time, so every level takes it. A block-private
// accumulator in shared memory for the small levels was measured and
// dropped: after the match it bought nothing at the main path's shapes and
// was slower on a single level of 4,096 rows.
// The grid is (runs of kRun samples, levels). Samples whose cotangent is
// zero (masked or out-of-bounds) make no updates, and a warp with none live
// skips the step. The sums stay in f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTableCols = 10;
constexpr int kThreadsA = 512;
constexpr int kRun = 2048;      // samples a block takes
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreadsA, 2)
grid_encoder_bwd_kernel(const int32_t* __restrict__ base,
                        const float* __restrict__ w,
                        const float* __restrict__ cot,
                        const int32_t* __restrict__ table,
                        float* __restrict__ d_emb, int L, int B) {
  const int l = blockIdx.y;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kRun;
  const int64_t end = start + kRun < B ? start + kRun : B;
  const int32_t* g = table + l * kTableCols;
  const uint32_t size = static_cast<uint32_t>(__ldg(g));
  const int64_t offset = __ldg(g + 1);
  uint32_t coff[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) coff[c] = static_cast<uint32_t>(__ldg(g + 2 + c));

  const int lane = threadIdx.x & 31;
  const float* wl = w + static_cast<int64_t>(l) * 8 * B;
  // the cotangent of the lane's next sample is loaded one step ahead
  auto load_cot = [&](int64_t j) {
    return j < end ? make_float2(cot[(j * L + l) * 2], cot[(j * L + l) * 2 + 1])
                   : make_float2(0.0f, 0.0f);
  };
  float2 next = load_cot(start + threadIdx.x);
  // the loop bound is the warp's first sample, so all 32 lanes stay in
  // step for the shuffles
  for (int64_t j0 = start + (threadIdx.x & ~31); j0 < end; j0 += kThreadsA) {
    const int64_t j = j0 + lane;
    const float c0 = next.x, c1 = next.y;
    next = load_cot(j + kThreadsA);
    const bool live = c0 != 0.0f || c1 != 0.0f;
    if (__ballot_sync(kFull, live) == 0) continue;

    // corner 0's row; a dead lane's key matches no live lane's
    const uint32_t b = live ? static_cast<uint32_t>(base[static_cast<int64_t>(l) * B + j])
                            : kFull;
    float v[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wc = live ? wl[static_cast<int64_t>(c) * B + j] : 0.0f;
      v[2 * c] = wc * c0;
      v[2 * c + 1] = wc * c1;
    }
    const unsigned group = __match_any_sync(kFull, b);
    // the run of the group from this lane up, and whether the lane heads it
    const unsigned up = ~(group >> lane);
    const int len = up ? __ffs(up) - 1 : 32 - lane;
    const bool head = live && (lane == 0 || !((group >> (lane - 1)) & 1u));
    // segmented suffix sums: after the step of width `off` a lane holds
    // the sum over [lane, lane + 2 off) of its run
    const int longest = __reduce_max_sync(kFull, live ? len : 1);
    for (int off = 1; off < longest; off <<= 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float o = __shfl_down_sync(kFull, v[i], off);
        if (off < len) v[i] += o;
      }
    }
    if (!head) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t row = b + coff[c];
      if (row >= size) row -= size;
      // one 8-byte vector atomic per row (sm_90)
      atomicAdd(reinterpret_cast<float2*>(d_emb) + offset + row,
                make_float2(v[2 * c], v[2 * c + 1]));
    }
  }
}

// Kernel E
// --------
// Replaces the TPU kernel dreamfusion_tpu/ops/pallas_scatter.py::
// matmul_scatter_add (body _scatter_kernel), called once per level from
// dreamfusion_tpu/ops/grid_encoder.py::_make_encode_levels._encode_levels_bwd
// for every level of an encoder that has a hashed level.
//
// Contract (the JAX VJP's residuals; a hashed corner is not an offset from
// corner 0, so the 8 rows are given, not derived):
//   rows [L, 8, B] int32  global table rows of the 8 corners (level
//                         offsets included), each in [0, T)
//   w    [L, 8, B] f32    trilinear corner weights
//   cot  [B, L, 2] f32    cotangent of the encoder output
//   d_emb [T, 2] f32      zero-initialised by the caller; receives
//     d_emb[rows[l, c, j], k] += w[l, c, j] * cot[j, l, k]
//
// What bounds it on Hopper: bytes and atomics. Each (sample, level) reads
// 32 + 32 + 8 bytes and makes 8 float2 atomicAdds. At the default hash spec
// (16 levels, 2^19 rows a level) the table is 57 MB, more than the 50 MB L2
// as a whole; threads walk level by level, so the live working set is one
// or two levels (4 MB each) and the atomics resolve in L2, but the rows of
// the hashed levels are spread at random, so the atomics of a warp share
// no sector. The TPU kernel splits each index into radix digits,
// builds one-hot matrices and multiplies them on the MXU (updates rounded
// to bf16) because the TPU has no scatter hardware; none of that is kept:
// the card has L2 atomics, and the sum stays in f32. One thread per
// (sample, level), consecutive threads on consecutive samples of one level,
// so the row and weight reads coalesce. Samples whose cotangent is zero
// (masked or out-of-bounds) make no atomics. A row outside [0, T) is
// skipped rather than written. Computing the hash in the kernel from
// corner 0's integer coordinates would save the reads of `rows`; that is
// later work.
__global__ void grid_encoder_bwd_rows_kernel(const int32_t* __restrict__ rows,
                                             const float* __restrict__ w,
                                             const float* __restrict__ cot,
                                             float* __restrict__ d_emb,
                                             int L, int B, int T) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(L) * B) return;
  const int l = static_cast<int>(t / B);
  const int64_t j = t - static_cast<int64_t>(l) * B;

  const float c0 = cot[(j * L + l) * 2];
  const float c1 = cot[(j * L + l) * 2 + 1];
  if (c0 == 0.0f && c1 == 0.0f) return;

  const int64_t at = static_cast<int64_t>(l) * 8 * B + j;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int32_t row = rows[at + static_cast<int64_t>(c) * B];
    const float wc = w[at + static_cast<int64_t>(c) * B];
    if (static_cast<uint32_t>(row) >= static_cast<uint32_t>(T)) continue;
    // one 8-byte vector atomic per row (sm_90): each float adds atomically
    atomicAdd(reinterpret_cast<float2*>(d_emb) + row,
              make_float2(wc * c0, wc * c1));
  }
}

}  // namespace

extern "C" int grid_encoder_bwd_rows(const void* rows, const void* w,
                                     const void* cot, void* d_emb, int L,
                                     int B, int T, void* stream) {
  const int64_t n = static_cast<int64_t>(L) * B;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  grid_encoder_bwd_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const float*>(w),
      static_cast<const float*>(cot), static_cast<float*>(d_emb), L, B, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_encoder_bwd(const void* base, const void* w,
                                const void* cot, const void* table,
                                void* d_emb, int L, int B, void* stream) {
  if (static_cast<int64_t>(L) * B == 0) return 0;
  const dim3 grid(static_cast<unsigned>((B + kRun - 1) / kRun),
                  static_cast<unsigned>(L));
  grid_encoder_bwd_kernel<<<grid, kThreadsA, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(base), static_cast<const float*>(w),
      static_cast<const float*>(cot), static_cast<const int32_t*>(table),
      static_cast<float*>(d_emb), L, B);
  return static_cast<int>(cudaGetLastError());
}
