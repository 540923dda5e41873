// Grid-encoder backward scatters: the table gradient of the
// multiresolution grid encoder, all levels in one launch. Two entries:
// grid_encoder_bwd (kernel A, encoders whose levels are all affine: the
// tiled grid) and grid_encoder_bwd_rows (kernel E, encoders with a hashed
// level; described above its kernel below). Both sum the updates of lanes
// that share a cell with run_sums before their atomics.
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

// The lanes of a warp whose keys are equal form a match group; within each
// contiguous run of one group, the segmented shuffle sums leave the run's
// 16 sums on its first lane. Returns whether this lane heads a run and is
// live, i.e. whether it issues the run's atomics. A dead lane's key must
// match no live lane's. All 32 lanes call it together.
__device__ __forceinline__ bool run_sums(float (&v)[16], uint32_t key,
                                         bool live, int lane) {
  const unsigned group = __match_any_sync(kFull, key);
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
  return head;
}

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
    if (!run_sums(v, b, live, lane)) continue;
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
// Contract (computes what the JAX VJP computes from its residuals, but
// from the positions: the kernel forms the corners, weights and rows
// itself, so the encoder keeps only x01 for its backward):
//   x01  [B, 3] f32    positions in the unit box (the encoder's
//                      (x + bound) / (2 bound))
//   cot  [B, L, 2] f32 cotangent of the encoder output
//   table [L, 8] int32 per level: scale (f32 bits; the float32 the
//                      plain version multiplies by), shift (f32 bits: 0.5,
//                      or 0 with align_corners), size, offset, the three
//                      uint32 strides (0 for a dimension outside the
//                      affine sum), hashed (0 or 1)
//   d_emb [T, 2] f32   zero-initialised by the caller; receives
//     d_emb[row(l, c, j), k] += w(l, c, j) * cot[j, l, k]
// where, as in GridEncoderSpec._level_corners and _corner_index_fn (the
// JAX package's grid_encoder.py:396, the reference's gridencoder.cu:54-72):
//   pos_d = x01_d * scale + shift   (two roundings, no FMA), frac_d = pos_d
//   - floor(pos_d); corner 0 = floor(pos) clamped to [0, 2^32 - 1]; w(c) =
//   the product over d, in dimension order from 1, of frac_d or 1 - frac_d
//   by bit d of c; row(c) = offset + h % size with h, in uint32, the XOR of
//   coord_d * prime_d on a hashed level and the sum of coord_d * stride_d
//   on the others. The sums stay in f32 (the TPU kernel rounds its updates
//   to bf16, a layout choice of that chip).
//
// What bounds it on Hopper: the L2's rate of atomic operations, about 65 G
// a second whether each adds 8 or 16 bytes (measured: 8 float2 atomics a
// (sample, level) ran at 63-67 G/s, reading rows and weights or not). Each
// (sample, level) reads 12 + 8 bytes and makes 8 row updates; at the
// default hash spec (16 levels, 2^19 rows a level) the table is 57 MB,
// more than the 50 MB L2. The grid is level-major (blockIdx.y = level;
// blocks start in order of their linear index), so the live working set
// is about one level's rows, <= 4 MB, and the atomics resolve in L2. So
// the design cuts operations. Corners c and c + 1 differ by one step in x;
// where their rows are the two halves of one 16-byte pair, which on a
// hashed level (prime 1 in x) is whenever x is even and on an affine level
// whenever the row is even, the two updates go as one float4 atomic
// (sm_90): 6 operations a (sample, level) on average in place of 8. The
// other rows of a hashed level are spread at random, so the atomics of a
// warp share no sector there. On an affine level corner c's row depends
// on corner 0's row alone (kernel A's identity; it holds while the affine
// sum stays below 2^32 or the size divides 2^32, i.e. for every point
// within 10^4 box widths), so lanes that share a cell match on it and one
// lane issues the run's atomics, with run_sums as in kernel A. The TPU
// kernel splits each index into radix digits, builds one-hot matrices and
// multiplies them on the MXU because the TPU has no scatter hardware; none
// of that is kept. The earlier form of this kernel read the rows and
// weights from [L, 8, B] residuals, 64 bytes a (sample, level) more.
// Samples whose cotangent is zero (masked or out of the box) make no
// atomics; a warp with none live returns.

constexpr int kTableColsE = 8;
constexpr int kThreadsE = 256;
constexpr uint32_t kPrime1 = 2654435761u, kPrime2 = 805459861u;

// floor(pos) as the plain version's saturating cast: negative -> 0, at or
// above 2^32 -> 2^32 - 1
__device__ __forceinline__ uint32_t grid_coord(float pos_floor) {
  if (!(pos_floor > 0.0f)) return 0u;
  if (pos_floor >= 4294967296.0f) return 0xffffffffu;
  return static_cast<uint32_t>(pos_floor);
}

__global__ void __launch_bounds__(kThreadsE)
grid_encoder_bwd_rows_kernel(const float* __restrict__ x01,
                             const float* __restrict__ cot,
                             const int32_t* __restrict__ table,
                             float* __restrict__ d_emb, int L, int B) {
  const int l = blockIdx.y;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreadsE + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int32_t* g = table + l * kTableColsE;
  const float scale = __int_as_float(__ldg(g));
  const float shift = __int_as_float(__ldg(g + 1));
  const uint32_t size = static_cast<uint32_t>(__ldg(g + 2));
  const int64_t offset = __ldg(g + 3);
  const uint32_t s0 = static_cast<uint32_t>(__ldg(g + 4));
  const uint32_t s1 = static_cast<uint32_t>(__ldg(g + 5));
  const uint32_t s2 = static_cast<uint32_t>(__ldg(g + 6));
  const bool hashed = __ldg(g + 7) != 0;     // the same in the whole block

  float2 ct = make_float2(0.0f, 0.0f);
  if (j < B) ct = *reinterpret_cast<const float2*>(cot + (j * L + l) * 2);
  const bool live = ct.x != 0.0f || ct.y != 0.0f;
  if (__ballot_sync(kFull, live) == 0) return;   // the whole warp

  float frac[3];
  uint32_t cell[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float x = live ? x01[j * 3 + d] : 0.0f;
    const float pos = __fadd_rn(__fmul_rn(x, scale), shift);
    const float pg = floorf(pos);
    frac[d] = __fsub_rn(pos, pg);
    cell[d] = grid_coord(pg);
  }
  auto row_of = [&](int c) -> int64_t {
    const uint32_t x = cell[0] + (c & 1), y = cell[1] + ((c >> 1) & 1),
                   z = cell[2] + ((c >> 2) & 1);
    const uint32_t h = hashed ? x ^ (y * kPrime1) ^ (z * kPrime2)
                              : x * s0 + y * s1 + z * s2;
    return offset + h % size;
  };
  float v[16];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float wc = 1.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      wc = __fmul_rn(wc, (c >> d) & 1 ? frac[d] : __fsub_rn(1.0f, frac[d]));
    v[2 * c] = wc * ct.x;
    v[2 * c + 1] = wc * ct.y;
  }
  if (hashed) {
    if (!live) return;
  } else {
    // affine level: corner 0's row is the match key (rows < T < 2^32 - 1,
    // so a dead lane's key matches no live lane's)
    const uint32_t key = live ? static_cast<uint32_t>(row_of(0)) : kFull;
    if (!run_sums(v, key, live, lane)) return;
  }
  // corners c and c + 1 (one step in x) whose rows are the two halves of
  // one 16-byte pair go as one float4 atomic (sm_90)
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    const int64_t r0 = row_of(c), r1 = row_of(c + 1);
    if ((r0 ^ r1) == 1) {
      const float4 u = r0 < r1
          ? make_float4(v[2 * c], v[2 * c + 1], v[2 * c + 2], v[2 * c + 3])
          : make_float4(v[2 * c + 2], v[2 * c + 3], v[2 * c], v[2 * c + 1]);
      atomicAdd(reinterpret_cast<float4*>(d_emb) + (r0 >> 1), u);
    } else {
      float2* out = reinterpret_cast<float2*>(d_emb);
      atomicAdd(out + r0, make_float2(v[2 * c], v[2 * c + 1]));
      atomicAdd(out + r1, make_float2(v[2 * c + 2], v[2 * c + 3]));
    }
  }
}

}  // namespace

extern "C" int grid_encoder_bwd_rows(const void* x01, const void* cot,
                                     const void* table, void* d_emb, int L,
                                     int B, void* stream) {
  if (static_cast<int64_t>(L) * B == 0) return 0;
  const dim3 grid(static_cast<unsigned>((B + kThreadsE - 1) / kThreadsE),
                  static_cast<unsigned>(L));
  grid_encoder_bwd_rows_kernel<<<grid, kThreadsE, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x01), static_cast<const float*>(cot),
      static_cast<const int32_t*>(table), static_cast<float*>(d_emb), L, B);
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
