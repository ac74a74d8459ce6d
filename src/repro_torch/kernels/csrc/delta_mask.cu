// Changed-page mask from two digest tables:
//
//   mask[r] = new[r, 0] != old[r, 0] || new[r, 1] != old[r, 1]   (as a bool byte)
//
// Replaces repro/kernels/delta_mask.py::delta_mask_pallas (body
// _delta_kernel), the second half of the checkpoint layer's delta scan.
//
// Bound: 17 bytes per row (two 8-byte digest rows read, a 1-byte bool
// written), a few microseconds of traffic even for the whole state of a
// billion-parameter model, so one call is bound by its launch latency and
// its host path.
//
// Design: one thread per row; neighbouring threads read neighbouring
// rows, so a warp's loads are contiguous 256-byte spans.  The kernel
// writes the torch.bool result itself (0 or 1 in each byte), so a call is
// one launch with no conversion after it.  The TPU kernel pads the rows to
// its 256-row tile; here the last block masks its tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
delta_mask_kernel(const int32_t* __restrict__ new_d, const int32_t* __restrict__ old_d,
                  uint8_t* __restrict__ out, int64_t n) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const bool changed = (__ldg(new_d + 2 * r) != __ldg(old_d + 2 * r)) |
                       (__ldg(new_d + 2 * r + 1) != __ldg(old_d + 2 * r + 1));
  out[r] = changed ? 1 : 0;
}

}  // namespace

// new_d, old_d: n rows of two 32-bit digests; out: n bool bytes (0 or 1).
// Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).  The caller checks sizes, types and contiguity.
extern "C" int delta_mask_bool(const int32_t* new_d, const int32_t* old_d, uint8_t* out,
                               int64_t n, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  delta_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(new_d, old_d, out, n);
  return static_cast<int>(cudaGetLastError());
}
