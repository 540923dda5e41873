// Kernel G: trilinear sampling of a [C, X, Y, Z] voxel grid, align_corners
// (DVGO's density and k0 grids), forward and the grid's gradient. Two
// entries: grid_sample_fwd and grid_sample_bwd.
//
// Replaces no TPU kernel: the JAX package's grid_sample_3d
// (dreamfusion_tpu/ops/grid_sample.py) is a written-out gather that XLA
// lowers, and reaches no Pallas kernel. It was added because that gather,
// written out in PyTorch (ops/grid_sample.py::grid_sample_3d_plain),
// materialises [8, B] indices, [8, B] weights and [8, B, C] values, and
// autograd's backward of its index sorts all 8 B indices and sums each run
// of equal indices serially in one warp. In DVGO pretraining most samples
// lie past the box and clamp onto a few border voxels (one took 427,514
// base-corner hits in a batch of 8,192 rays of 954 samples), so a few warps
// added millions of terms each and that backward took four fifths of a
// step. Those samples' cotangents are exactly zero (the field masks them
// with torch.where before the loss).
//
// Contract (ops/grid_sample.py, the plain version's arithmetic):
//   grid [C, X, Y, Z] f32  channel-major, read in place
//   x01  [B, 3] f32        positions; axis d indexes x01_d * (S_d - 1)
//   out  [B, C] f32        forward: out[j, k] = sum_c w_c(j) grid[k, corner_c(j)]
//   cot  [B, C] f32        backward: the cotangent of out
//   d_grid [C, X, Y, Z] f32 zero-initialised by the caller; receives
//     d_grid[k, corner_c(j)] += w_c(j) * cot[j, k]
// where pos_d = min(max(x01_d * (S_d - 1), 0), S_d - 1) (a NaN position
// reads as 0, so no address leaves the grid), p0_d = floor(pos_d), frac_d =
// pos_d - p0_d; corner c takes p0_d + bit d of c on axis d, clamped to
// S_d - 1; w_c is the product over d = 0, 1, 2, from 1.0, of frac_d or
// 1 - frac_d by bit d of c. The forward adds the 8 terms in corner order.
// Every product and sum is rounded on its own (no FMA), as in the plain
// version. X * Y * Z < 2^31.
//
// What bounds it on Hopper. The forward: the gathers' sector traffic
// through L1 and L2, far above its bytes (each sample reads 12 bytes of
// position and writes 4 C bytes). Its 8 C corner values are scattered
// loads, one 32-byte sector each unless lanes share it; the samples arrive
// ray by ray, about two to a voxel, so neighbouring lanes share some, and
// the density grid (16 MB at 160^3) stays in the 50 MB L2. One pass,
// corners and weights in registers: nothing of the plain version's 8 B
// intermediates is written. The backward: the L2's rate of atomic
// operations. A sample whose cotangent is 0.0 in every channel is skipped
// (adding an exact zero changes no sum; a NaN is not skipped), which drops
// the clamped samples and, with them, every duplicate-heavy address: the
// samples inside the box fall on distinct voxels but for about two in a row
// along a ray. Consecutive lanes take consecutive samples; a
// __match_any_sync on corner 0's index finds the lanes of one voxel (the
// same corner 0 gives the same 8 corners), a segmented shuffle sum over
// each contiguous run of such lanes leaves the run's sums on its first
// lane, which alone issues the run's atomics (kernel A's run_sums,
// grid_encoder_bwd.cu). Corners c and c + 4 differ by one step in z, the
// contiguous axis: where the lower one's address is 8-byte aligned the two
// go as one float2 atomic (sm_90), so a (sample, channel) costs 6 atomics
// on average in place of 8. A warp with no live sample returns at once.
// The sums stay in f32; atomics add in no fixed order (under PyTorch's
// deterministic mode the wrapper takes an ordered accumulation instead).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The 8 corners (index within a channel plane) and weights of one sample.
__device__ __forceinline__ void corners(const float* __restrict__ x01,
                                        int X, int Y, int Z,
                                        uint32_t (&idx)[8], float (&w)[8]) {
  const int S[3] = {X, Y, Z};
  int lo[3], hi[3];
  float frac[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float top = static_cast<float>(S[d] - 1);
    const float pos = fminf(fmaxf(__fmul_rn(__ldg(x01 + d), top), 0.0f), top);
    const float p0 = floorf(pos);
    frac[d] = __fsub_rn(pos, p0);
    lo[d] = static_cast<int>(p0);
    hi[d] = min(lo[d] + 1, S[d] - 1);
  }
  const uint32_t sx = static_cast<uint32_t>(Y) * Z, sy = Z;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float wc = 1.0f;
    uint32_t i = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const bool up = (c >> d) & 1;
      wc = __fmul_rn(wc, up ? frac[d] : __fsub_rn(1.0f, frac[d]));
      const uint32_t coord = static_cast<uint32_t>(up ? hi[d] : lo[d]);
      i += coord * (d == 0 ? sx : d == 1 ? sy : 1u);
    }
    idx[c] = i;
    w[c] = wc;
  }
}

__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_kernel(const float* __restrict__ grid,
                       const float* __restrict__ x01,
                       float* __restrict__ out, int C, int X, int Y, int Z,
                       int64_t B) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= B) return;
  uint32_t idx[8];
  float w[8];
  corners(x01 + j * 3, X, Y, Z, idx, w);
  const int64_t plane = static_cast<int64_t>(X) * Y * Z;
  const float* g = grid;
#pragma unroll 1
  for (int k = 0; k < C; ++k, g += plane) {
    float acc = __fmul_rn(w[0], __ldg(g + idx[0]));
#pragma unroll
    for (int c = 1; c < 8; ++c)
      acc = __fadd_rn(acc, __fmul_rn(w[c], __ldg(g + idx[c])));
    out[j * C + k] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
grid_sample_bwd_kernel(const float* __restrict__ x01,
                       const float* __restrict__ cot,
                       float* __restrict__ d_grid, int C, int X, int Y,
                       int Z, int64_t B) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const float* ct = cot + j * C;
  bool live = false;
  if (j < B)
    for (int k = 0; k < C && !live; ++k) live = ct[k] != 0.0f;  // NaN: live
  if (__ballot_sync(kFull, live) == 0) return;   // the whole warp

  uint32_t idx[8];
  float w[8];
  if (live) {
    corners(x01 + j * 3, X, Y, Z, idx, w);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) idx[c] = 0, w[c] = 0.0f;
  }
  // runs of lanes on one voxel; a dead lane's key (indices < 2^31) matches
  // no live lane's
  const unsigned group = __match_any_sync(kFull, live ? idx[0] : kFull);
  const unsigned up = ~(group >> lane);
  const int len = up ? __ffs(up) - 1 : 32 - lane;
  const bool head = live && (lane == 0 || !((group >> (lane - 1)) & 1u));
  const int longest = __reduce_max_sync(kFull, live ? len : 1);

  const int64_t plane = static_cast<int64_t>(X) * Y * Z;
  float* g = d_grid;
#pragma unroll 1
  for (int k = 0; k < C; ++k, g += plane) {
    const float ck = live ? ct[k] : 0.0f;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = __fmul_rn(w[c], ck);
    // segmented suffix sums: after the step of width `off` a lane holds the
    // sum over [lane, lane + 2 off) of its run
    for (int off = 1; off < longest; off <<= 1) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float o = __shfl_down_sync(kFull, v[c], off);
        if (off < len) v[c] = __fadd_rn(v[c], o);
      }
    }
    if (!head) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* a = g + idx[c];
      if (idx[c + 4] == idx[c]) {               // z clamped at the face
        atomicAdd(a, __fadd_rn(v[c], v[c + 4]));
      } else if ((reinterpret_cast<uintptr_t>(a) & 7) == 0) {
        atomicAdd(reinterpret_cast<float2*>(a), make_float2(v[c], v[c + 4]));
      } else {
        atomicAdd(a, v[c]);
        atomicAdd(a + 1, v[c + 4]);
      }
    }
  }
}

unsigned blocks(int64_t B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int grid_sample_fwd(const void* grid, const void* x01, void* out,
                               int C, int X, int Y, int Z, int64_t B,
                               void* stream) {
  if (B * C == 0) return 0;
  grid_sample_fwd_kernel<<<blocks(B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<const float*>(x01),
      static_cast<float*>(out), C, X, Y, Z, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_sample_bwd(const void* x01, const void* cot, void* d_grid,
                               int C, int X, int Y, int Z, int64_t B,
                               void* stream) {
  if (B * C == 0) return 0;
  grid_sample_bwd_kernel<<<blocks(B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x01), static_cast<const float*>(cot),
      static_cast<float*>(d_grid), C, X, Y, Z, B);
  return static_cast<int>(cudaGetLastError());
}
