// Kernel H: the multiresolution grid encoder's forward, all levels in one
// launch.
//
// Replaces no TPU kernel: the JAX package's forward is XLA `take` plus the
// trilinear blend (dreamfusion_tpu/ops/grid_encoder.py). The port's plain
// version (GridEncoderSpec._gather_levels / encode_fwd) takes some 1,120
// PyTorch launches a call at 16 levels: per level the unit positions,
// floor and weights, the rows of 8 corners, a gather, a product and a sum,
// then a stack; in a field query of the grid field that is 98% of its
// launches. This kernel is the forward twin of kernel E
// (grid_encoder_bwd.cu): it forms the unit positions, the corners, weights
// and rows of every level itself and writes only the features.
//
// Contract:
//   x     [B, 3] f32    positions in [-bound, bound]
//   emb   [T, 2]        the table, f32 or bf16 (emb_bf16 = 1)
//   table [L, 8] int32  kernel E's per-level table
//                       (GridEncoderSpec.rows_level_table): scale and
//                       shift as f32 bits, size, offset, the three uint32
//                       strides (0 for a dimension outside the affine
//                       sum), hashed (0 or 1)
//   out   [B, L, 2] f32 out[j, l] = sum over the corners c = 0..7, in
//                       order, of w(l, c, j) * emb[row(l, c, j)], and 0
//                       where x01_j lies outside [0, 1]^3
// where, as in GridEncoderSpec._unit_positions, _level_corners and
// _corner_index_fn: x01_d = (x_d + bound) / (2 bound) (two roundings; the
// caller passes 2 bound rounded to f32, as torch rounds the scalar; torch
// on the card multiplies by the scalar's reciprocal instead, the same
// value where the bound is a power of two, as the configs' 1 and 2),
// outside when any x01_d < 0 or > 1; pos_d = x01_d * scale + shift (two
// roundings, no FMA), frac_d = pos_d - floor(pos_d), corner 0 = floor(pos)
// clamped to [0, 2^32 - 1]; w(c) = the product over d, in dimension order
// from 1, of frac_d or 1 - frac_d by bit d of c; row(c) = offset + h %
// size with h, in uint32, the XOR of coord_d * prime_d on a hashed level
// and the sum of coord_d * stride_d on the others. Every rounding is
// spelled out with the _rn intrinsics, so a corner row is the plain
// version's row bit for bit, also where pos lies within an ulp of a
// lattice point; the blend may differ from the plain version's only in
// the order of the 8-term sum. On an affine level the plain path forms
// corner c's row as (row0 + corner_off_c) % size (kernel A's identity);
// the two agree while the affine sum stays below 2^32, which holds inside
// the box.
//
// What bounds it on Hopper: the loads of table rows. Each (sample, level)
// reads 12 bytes of position (shared by the level's 16 lanes) and 8 rows
// of 4 (bf16) or 8 (f32) bytes, and writes 8 bytes. The eval's tiled table
// (903,480 rows) is 3.6 MB in bf16 and 7.2 MB in f32, so the rows come
// from the 50 MB L2; the bytes that must cross device memory are the
// positions in and the features out, 140 bytes a sample. The design keeps
// all of it in one pass: one thread per (sample, level) with the level
// fastest, so that a warp's 32 float2 stores are one coalesced 256-byte
// write and the 8 row loads of a thread are independent and in flight
// together; the level table sits in shared memory transposed
// ([column][level]), so the lanes of a warp read it without bank
// conflicts. Out-of-box samples read nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;
constexpr int kThreads = 256;
constexpr uint32_t kPrime1 = 2654435761u, kPrime2 = 805459861u;

// floor(pos) as the plain version's saturating cast: negative -> 0, at or
// above 2^32 -> 2^32 - 1
__device__ __forceinline__ uint32_t grid_coord(float pos_floor) {
  if (!(pos_floor > 0.0f)) return 0u;
  if (pos_floor >= 4294967296.0f) return 0xffffffffu;
  return static_cast<uint32_t>(pos_floor);
}

// one row of the table as two floats: an 8-byte load of f32, or a 4-byte
// load of two bf16 (element 0 in the low half; bf16 -> f32 is exact)
template <bool kBf16>
__device__ __forceinline__ float2 load_row(const void* emb, int64_t row) {
  if (kBf16) {
    const uint32_t u = __ldg(static_cast<const uint32_t*>(emb) + row);
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xffff0000u));
  }
  return __ldg(static_cast<const float2*>(emb) + row);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
grid_encoder_fwd_kernel(const float* __restrict__ x,
                        const void* __restrict__ emb,
                        const int32_t* __restrict__ table,
                        float2* __restrict__ out, float bound,
                        float two_bound, int L, int64_t n) {
  extern __shared__ int32_t cols[];           // [kCols][L]
  for (int i = threadIdx.x; i < L * kCols; i += kThreads)
    cols[(i % kCols) * L + i / kCols] = table[i];
  __syncthreads();
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  const int64_t j = t / L;
  const int l = static_cast<int>(t - j * L);

  float x01[3];
  bool inside = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x01[d] = __fdiv_rn(__fadd_rn(__ldg(x + j * 3 + d), bound), two_bound);
    inside = inside && !(x01[d] < 0.0f || x01[d] > 1.0f);
  }
  float2 acc = make_float2(0.0f, 0.0f);
  if (inside) {
    const float scale = __int_as_float(cols[l]);
    const float shift = __int_as_float(cols[L + l]);
    const uint32_t size = static_cast<uint32_t>(cols[2 * L + l]);
    const int64_t offset = cols[3 * L + l];
    const uint32_t s0 = static_cast<uint32_t>(cols[4 * L + l]);
    const uint32_t s1 = static_cast<uint32_t>(cols[5 * L + l]);
    const uint32_t s2 = static_cast<uint32_t>(cols[6 * L + l]);
    const bool hashed = cols[7 * L + l] != 0;
    float frac[3];
    uint32_t cell[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float pos = __fadd_rn(__fmul_rn(x01[d], scale), shift);
      const float pg = floorf(pos);
      frac[d] = __fsub_rn(pos, pg);
      cell[d] = grid_coord(pg);
    }
    float2 v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t cx = cell[0] + (c & 1), cy = cell[1] + ((c >> 1) & 1),
                     cz = cell[2] + ((c >> 2) & 1);
      const uint32_t h = hashed ? cx ^ (cy * kPrime1) ^ (cz * kPrime2)
                                : cx * s0 + cy * s1 + cz * s2;
      v[c] = load_row<kBf16>(emb, offset + h % size);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float wc = 1.0f;
#pragma unroll
      for (int d = 0; d < 3; ++d)
        wc = __fmul_rn(wc, (c >> d) & 1 ? frac[d] : __fsub_rn(1.0f, frac[d]));
      acc.x = __fadd_rn(acc.x, __fmul_rn(wc, v[c].x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(wc, v[c].y));
    }
  }
  out[t] = acc;
}

}  // namespace

extern "C" int grid_encoder_fwd(const void* x, const void* emb, int emb_bf16,
                                const void* table, void* out, float bound,
                                float two_bound, int L, int B, void* stream) {
  const int64_t n = static_cast<int64_t>(L) * B;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(L) * kCols * sizeof(int32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* tab = static_cast<const int32_t*>(table);
  float2* o = static_cast<float2*>(out);
  if (emb_bf16)
    grid_encoder_fwd_kernel<true><<<blocks, kThreads, smem, s>>>(
        xf, emb, tab, o, bound, two_bound, L, n);
  else
    grid_encoder_fwd_kernel<false><<<blocks, kThreads, smem, s>>>(
        xf, emb, tab, o, bound, two_bound, L, n);
  return static_cast<int>(cudaGetLastError());
}
