// Windowed lattice march of the staged eval, every flagged group of a
// frame in one launch: kernel W.
//
// It has no Pallas counterpart. The JAX package writes the windowed march
// as XLA ops (dreamfusion_tpu/ops/marching.py::march_rays_window, :519-553,
// with its sort-based _compact at :580-613) called once per ray group from
// the staged eval's loop (dreamfusion_tpu/training/trainer.py:221-859).
// The port's plain version is the same chain of eager ops
// (dreamfusion_torch/ops/marching.py::march_window_groups_plain: the slab
// test, the lattice, the density probe, the sort and gathers of _compact,
// the sigma-EMA live cut and the group's three statistics), some 100
// launches a group; this kernel computes all of it for all flagged groups.
//
// Contract. Inputs: the frame's padded rays rays_o, rays_d [Np, 3] f32,
// classify's perm [Np] int64 and t_lo [Np] f32 (the emit window's start),
// the groups' span maxima gspan [G] f32 (Np = G group), the ray box aabb
// [6] f32, the single-cascade density EMA [H, H, H] f32 and mean_density
// [] f32 (on the device: no host read). Group b of the n flagged groups
// (b = 0 the densest) is the sorted group g = top - b, its rays perm[g
// group + i]. Per ray (row b group + i) it writes o_g, d_g [., 3]; nears,
// fars [.]; ts, dts [., K] f32 and valid [., K] u8; counts [.] int64; and
// adds the group's (glive, gcount, ltot) into stats [n, 3] int32 (zeroed
// by the caller).
//
// Semantics, every f32 operation the plain version's as PyTorch computes
// it on the card, in its order (__fmul_rn / __fadd_rn / __fdiv_rn where
// nvcc could contract or approximate; PyTorch's CUDA division of a tensor
// by a Python float multiplies by the float reciprocal, so that is done
// here too):
//  1. near / far: the slab test of ops/composite.near_far_from_aabb
//     (misses 1e9, near clamped to min_near).
//  2. S: the first rung of the S ladder (ascending) >= gspan[g], else
//     the last. k0 = floor((t_lo - near) * (1 / dt)); t_j = near + dt
//     (k0 + j), j < S: the full march's own formula, so the window's
//     points are bitwise the full march's.
//  3. alive = t_j < far.
//  4. The cell of clamp(o + t_j d, -bound, bound) as marching.
//     _lattice_points and _flat_cells compute it.
//  5. emit = sigma > min(mean_density, density_thresh) and alive.
//  6. The first K emits go, in order, to the slots with (t_j, dt); t_j
//     rises strictly along a ray, so _compact's sort is this order-
//     preserving compaction and no sort is needed. Slots past the emits
//     read 0. gcount = max over rays of min(emits, K).
//  7. The live cut: a slot stays live while the exclusive running sum of
//     max(sigma, 0) dt over the ray's slots is below live_logt; the first
//     slot that reaches it and every later one drop (a prefix, as in the
//     plain version, whose sum is monotone). valid marks the live slots,
//     counts their number; glive is their maximum over the group, ltot
//     their sum.
// The running sum is a warp scan and not PyTorch's cumsum, so it may round
// differently: a slot whose exclusive sum lies within rounding of the cut
// can land on the other side. Everything else is the plain version's bits.
//
// Design for Hopper. The S lattice points of a ray are independent (unlike
// kernel F's serial DDA), so a warp takes a ray and its lanes walk j in
// chunks of 32: the compaction's slot is a __ballot_sync + __popc prefix,
// the live cut's sum a shuffle scan carried across chunks. A ray stops at
// its far end or when its K slots are full. The 8 MB density EMA (128^3)
// stays in the 50 MB L2. A block holds 8 rays of one group; their maxima
// and live sum (integers, exact in any order) are reduced in shared memory
// and added with one atomic each a block. Bound: the outputs, 9 bytes a
// slot and 40 a ray, written once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLadder = 7;
constexpr unsigned kFull = 0xffffffffu;

struct Ladder {
  int s[kLadder];
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// the flat index of the density cell holding o + t d (clamped to the box)
__device__ __forceinline__ int flat_cell(const float o[3], const float d[3],
                                         float t, float bound,
                                         float inv_bound, float Hf, int H) {
  int n[3];
  for (int a = 0; a < 3; ++a) {
    const float x = clampf(__fadd_rn(o[a], __fmul_rn(t, d[a])), -bound, bound);
    const float u = __fmul_rn(
        __fmul_rn(0.5f, __fadd_rn(__fmul_rn(x, inv_bound), 1.0f)), Hf);
    n[a] = static_cast<int>(clampf(u, 0.0f, Hf - 1.0f));
  }
  return (n[0] * H + n[1]) * H + n[2];
}

__global__ void __launch_bounds__(kThreads)
march_window_kernel(const float* __restrict__ rays_o,
                    const float* __restrict__ rays_d,
                    const long long* __restrict__ perm,
                    const float* __restrict__ t_lo,
                    const float* __restrict__ gspan,
                    const float* __restrict__ aabb,
                    const float* __restrict__ density,
                    const float* __restrict__ mean_density,
                    float* __restrict__ o_g, float* __restrict__ d_g,
                    float* __restrict__ nears, float* __restrict__ fars,
                    float* __restrict__ ts, float* __restrict__ dts,
                    uint8_t* __restrict__ valid,
                    long long* __restrict__ counts, int* __restrict__ stats,
                    int top, int group, int K, int H, Ladder ladder,
                    float min_near, float bound, float dt,
                    float density_thresh, float live_logt) {
  __shared__ int s_live[kWarps];
  __shared__ int s_emit[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int g = top - b;
  const int i = blockIdx.x * kWarps + warp;
  int n_live = 0, n_emit = 0;
  if (i < group) {
    const long long row = static_cast<long long>(b) * group + i;
    const long long r = perm[static_cast<long long>(g) * group + i];
    float o[3], d[3];
    float near = -INFINITY, far = INFINITY;
    for (int a = 0; a < 3; ++a) {
      o[a] = rays_o[3 * r + a];
      d[a] = rays_d[3 * r + a];
      const float dd = fabsf(d[a]) < 1e-15f
                           ? (d[a] >= 0.0f ? 1e-15f : -1e-15f) : d[a];
      const float rd = __fdiv_rn(1.0f, dd);
      const float t0 = __fmul_rn(__fadd_rn(aabb[a], -o[a]), rd);
      const float t1 = __fmul_rn(__fadd_rn(aabb[3 + a], -o[a]), rd);
      near = fmaxf(near, fminf(t0, t1));
      far = fminf(far, fmaxf(t0, t1));
    }
    if (far < near) {
      near = 1e9f;
      far = 1e9f;
    }
    near = fmaxf(near, min_near);
    if (lane < 3) {
      o_g[3 * row + lane] = rays_o[3 * r + lane];
      d_g[3 * row + lane] = rays_d[3 * r + lane];
    } else if (lane == 3) {
      nears[row] = near;
      fars[row] = far;
    }
    const float span = gspan[g];
    int S = ladder.s[kLadder - 1];
    for (int k = 0; k < kLadder; ++k) {
      if (static_cast<float>(ladder.s[k]) >= span) {
        S = ladder.s[k];
        break;
      }
    }
    const float k0 = floorf(__fmul_rn(__fadd_rn(t_lo[r], -near),
                                      __fdiv_rn(1.0f, dt)));
    const float md = *mean_density;
    const float thresh = md > density_thresh ? density_thresh : md;
    const float inv_bound = __fdiv_rn(1.0f, bound);
    const float Hf = static_cast<float>(H);
    float* ts_r = ts + row * K;
    float* dts_r = dts + row * K;
    uint8_t* valid_r = valid + row * K;
    const unsigned below = (1u << lane) - 1u;
    float carry = 0.0f;   // the running sum before this chunk
    int cut = -1;         // the first slot the live cut drops, once found
    int base = 0;         // emits before this chunk
    for (int c = 0; c < S && base < K; c += 32) {
      const int j = c + lane;
      const float t = __fadd_rn(
          near, __fmul_rn(dt, __fadd_rn(k0, static_cast<float>(j))));
      float sig = 0.0f;
      bool emit = false;
      if (j < S && t < far) {
        sig = density[flat_cell(o, d, t, bound, inv_bound, Hf, H)];
        emit = sig > thresh;
      }
      const unsigned mask = __ballot_sync(kFull, emit);
      const int slot = base + __popc(mask & below);
      const bool kept = emit && slot < K;
      const float term = kept ? __fmul_rn(fmaxf(sig, 0.0f), dt) : 0.0f;
      float incl = term;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl = __fadd_rn(incl, v);
      }
      const float prev = __shfl_up_sync(kFull, incl, 1);
      const float depth_ex = __fadd_rn(carry, lane == 0 ? 0.0f : prev);
      if (kept) {
        ts_r[slot] = t;
        dts_r[slot] = dt;
      }
      const unsigned over = __ballot_sync(kFull,
                                          kept && !(depth_ex < live_logt));
      if (cut < 0 && over != 0u) {
        const int first = __ffs(over) - 1;
        cut = base + __popc(mask & ((1u << first) - 1u));
      }
      carry = __fadd_rn(carry, __shfl_sync(kFull, incl, 31));
      base += __popc(mask);
      // t rises along the ray: past far in lane 31, past far for good
      if (!(__shfl_sync(kFull, t, 31) < far)) break;
    }
    n_emit = min(base, K);
    n_live = cut < 0 ? n_emit : cut;
    for (int k = lane; k < K; k += 32) {
      valid_r[k] = k < n_live ? 1 : 0;
      if (k >= n_emit) {
        ts_r[k] = 0.0f;
        dts_r[k] = 0.0f;
      }
    }
    if (lane == 0) counts[row] = n_live;
  }
  if (lane == 0) {
    s_live[warp] = n_live;
    s_emit[warp] = n_emit;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int glive = 0, gcount = 0, ltot = 0;
    for (int w = 0; w < kWarps; ++w) {
      glive = max(glive, s_live[w]);
      gcount = max(gcount, s_emit[w]);
      ltot += s_live[w];
    }
    if (gcount > 0) {
      atomicMax(stats + 3 * b, glive);
      atomicMax(stats + 3 * b + 1, gcount);
      atomicAdd(stats + 3 * b + 2, ltot);
    }
  }
}

}  // namespace

extern "C" int march_window(const void* rays_o, const void* rays_d,
                            const void* perm, const void* t_lo,
                            const void* gspan, const void* aabb,
                            const void* density, const void* mean_density,
                            void* o_g, void* d_g, void* nears, void* fars,
                            void* ts, void* dts, void* valid, void* counts,
                            void* stats, int top, int n_groups, int group,
                            int K, int H, int s0, int s1, int s2, int s3,
                            int s4, int s5, int s6, float min_near,
                            float bound, float dt, float density_thresh,
                            float live_logt, void* stream) {
  const Ladder ladder = {{s0, s1, s2, s3, s4, s5, s6}};
  bool ok = n_groups >= 0 && n_groups <= 65535 && top >= n_groups - 1 &&
            group > 0 && K > 0 && H > 0;
  for (int k = 0; k < kLadder; ++k) ok = ok && ladder.s[k] > 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups == 0) return 0;
  const dim3 blocks(static_cast<unsigned>((group + kWarps - 1) / kWarps),
                    static_cast<unsigned>(n_groups));
  march_window_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const long long*>(perm), static_cast<const float*>(t_lo),
      static_cast<const float*>(gspan), static_cast<const float*>(aabb),
      static_cast<const float*>(density),
      static_cast<const float*>(mean_density), static_cast<float*>(o_g),
      static_cast<float*>(d_g), static_cast<float*>(nears),
      static_cast<float*>(fars), static_cast<float*>(ts),
      static_cast<float*>(dts), static_cast<uint8_t*>(valid),
      static_cast<long long*>(counts), static_cast<int*>(stats), top, group,
      K, H, ladder, min_near, bound, dt, density_thresh, live_logt);
  return static_cast<int>(cudaGetLastError());
}
