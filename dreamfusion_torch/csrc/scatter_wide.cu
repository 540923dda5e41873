// Row scatter-add of narrow f32 rows: out[idx[j], c] += upd[j, c]. The
// staged eval's compact compositor sums its per-sample
// [w, w*t, w*r, w*g, w*b, live] into per-ray rows with it.
//
// Replaces the TPU kernel dreamfusion_tpu/ops/pallas_scatter.py::
// matmul_scatter_add_wide (bodies _scatter_kernel_wide2, the default, and
// _scatter_kernel_wide), called from dreamfusion_tpu/ops/marching.py::
// composite_compact.
//
// Contract:
//   idx [J] int32 in [0, T)
//   upd [J, 6] f32, row-major (the compositor's six channels: the TPU
//       kernel's 16 were its lane layout)
//   out [T, 6] f32, zero-initialised by the caller
// Updates are summed in f32 (the TPU kernel rounds them to bf16 for its
// MXU product; the JAX package's f32 `.at[].add` is the oracle here).
//
// Right for any idx, fast for runs of equal ids. The compact buffer is
// ray-major, so its ids come in runs, one per ray; but the invalid tail
// (m >= the valid total) maps to row 0 with zero updates, so the ids are
// sorted only over the valid prefix (marching.py:667-674). The kernel
// assumes no order: runs are found per warp from the ids themselves.
//
// What bounds it on Hopper: bytes, J * (4 + 4C) in and T * 4C out, and the
// atomics. One thread per update, 32 consecutive updates per warp: each
// lane compares its id with its neighbours' (shuffles) to find where the
// runs of equal ids start and end, a segmented suffix sum over the warp
// (five shuffle steps per channel) leaves each run's total in its first
// lane, and that lane issues one f32 atomicAdd per channel whose total is
// not zero. A ray's samples then cost one atomic per channel per warp they
// span instead of one per sample, and zero sums (the invalid tail, samples
// past the transmittance cut) cost none, so the tail's row 0 sees no
// contention. The TPU kernel's one-hot matmul over a VMEM-resident output
// has no counterpart here: L2 atomics do the scatter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int C = 6;

__global__ void scatter_wide_kernel(const int32_t* __restrict__ idx,
                                    const float* __restrict__ upd,
                                    float* __restrict__ out, int64_t J,
                                    int T) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = j < J;
  const int key = live ? idx[j] : -1;
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = live ? upd[j * C + c] : 0.0f;

  const int prev = __shfl_up_sync(kFull, key, 1);
  const int next = __shfl_down_sync(kFull, key, 1);
  const bool head = lane == 0 || prev != key;
  // stop: this lane's run ends within the span summed so far
  int stop = (lane == 31 || next != key) ? 1 : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float o[C];
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = __shfl_down_sync(kFull, v[c], off);
    const int ostop = __shfl_down_sync(kFull, stop, off);
    if (!stop) {          // the run goes on past lane + off - 1 <= 31
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] += o[c];
      stop = ostop;
    }
  }
  if (head && live && key >= 0 && key < T) {
    float* row = out + static_cast<int64_t>(key) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (v[c] != 0.0f) atomicAdd(row + c, v[c]);
    }
  }
}

}  // namespace

extern "C" int scatter_add_wide(const void* idx, const void* upd, void* out,
                                long long J, int T, void* stream) {
  if (J == 0) return 0;
  const int64_t blocks = (J + kThreads - 1) / kThreads;
  scatter_wide_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(upd),
      static_cast<float*>(out), static_cast<int64_t>(J), T);
  return static_cast<int>(cudaGetLastError());
}
