// Small-table probe gather: out[j] = table[idx[j]] for a u8 table of at
// most 65,536 entries (the staged eval's pooled occupancy grid).
//
// Replaces the TPU kernel dreamfusion_tpu/ops/pallas_probe.py::
// probe_select_small (body _probe_kernel), which
// dreamfusion_tpu/ops/marching.py::_probe_gather routes small tables to:
// the classify pass probes the pooled 32^3 occupancy grid (32,768 cells) at
// ~20.6 M lattice points of an 800^2 frame.
//
// Contract:
//   table [T] uint8, T a multiple of 16 and at most 65,536, 16-byte aligned
//   idx   [J] int32 in [0, T), 16-byte aligned
//   out   [J] uint8, 4-byte aligned: out[j] = table[idx[j]]
// An index outside [0, T) is clamped into it (the contract excludes such
// indices; the clamp only keeps the shared-memory read in bounds).
//
// What bounds it on Hopper: bytes. Each probe reads a 4-byte index and
// writes one byte; the table is read once per block. The TPU kernel picks
// the table row with a one-hot matmul on the MXU and the lane with a masked
// reduce, because a TPU core cannot gather from VMEM by address. A Hopper
// thread can: each block copies the whole table into shared memory with
// 16-byte loads (32 KB for the pooled grid; above 48 KB the launcher opts in
// to more dynamic shared memory), then each thread reads four indices with
// one 16-byte load, looks the four bytes up in shared memory and writes them
// with one 4-byte store, in a grid-stride loop over as many blocks as fit on
// the card at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTable = 65536;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void probe_select_kernel(const uint8_t* __restrict__ table,
                                    const int32_t* __restrict__ idx,
                                    uint8_t* __restrict__ out, int T,
                                    int64_t J) {
  extern __shared__ __align__(16) uint8_t tab[];
  const uint4* src = reinterpret_cast<const uint4*>(table);
  uint4* dst = reinterpret_cast<uint4*>(tab);
  for (int i = threadIdx.x; i < T / 16; i += blockDim.x) dst[i] = src[i];
  __syncthreads();

  const uint32_t last = static_cast<uint32_t>(T - 1);
  const int64_t n4 = J / 4;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < n4; q += stride) {
    const int4 v = idx4[q];
    const uint32_t b0 = tab[min(static_cast<uint32_t>(v.x), last)];
    const uint32_t b1 = tab[min(static_cast<uint32_t>(v.y), last)];
    const uint32_t b2 = tab[min(static_cast<uint32_t>(v.z), last)];
    const uint32_t b3 = tab[min(static_cast<uint32_t>(v.w), last)];
    out4[q] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
  }
  if (blockIdx.x == 0) {
    for (int64_t j = n4 * 4 + threadIdx.x; j < J; j += blockDim.x) {
      out[j] = tab[min(static_cast<uint32_t>(idx[j]), last)];
    }
  }
}

}  // namespace

extern "C" int probe_select(const void* table, const void* idx, void* out,
                            int T, long long J, void* stream) {
  if (T <= 0 || T > kMaxTable || T % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (J == 0) return 0;
  const size_t smem = static_cast<size_t>(T);
  cudaError_t err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(probe_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, probe_select_kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int64_t needed = (J / 4 + kThreads - 1) / kThreads;
  int64_t blocks = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (needed < blocks) blocks = needed > 0 ? needed : 1;
  probe_select_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<uint8_t*>(out), T, static_cast<int64_t>(J));
  return static_cast<int>(cudaGetLastError());
}
