// Diagonal linear recurrence h_t = a_t * h_{t-1} + x_t over (B, T, D),
// float32, with h_{-1} = 0.
//
// Replaces repro/kernels/linear_scan.py::linear_scan_pallas (body
// _scan_kernel), the RG-LRU prefill scan of models/recurrent.py.
//
// Bound: HBM traffic.  Each element costs 12 bytes (read a, read x,
// write h) against 2 flops, far below the card's ridge point, so the
// least time is 12 * B * T * D bytes over the memory rate.
//
// Design: the TPU kernel walks time as its sequential grid axis and keeps
// h in VMEM scratch.  Here one thread owns one (b, d) channel and loops
// over T, keeping the carry in a register; neighbouring threads take
// neighbouring d, so each warp's loads and stores of one time step are
// one coalesced 128-byte line.  The loop is unrolled by kUnroll: the
// kUnroll loads of a and x are issued before the dependent chain of
// multiply-adds, so every thread keeps 2 * kUnroll loads in flight to
// hide HBM latency.  Multiply and add are rounded separately
// (__fmul_rn / __fadd_rn, no contraction into an FMA) so the result is
// bit-identical to the plain PyTorch loop in kernels/ref.py.
//
// The parallelism is B * D threads; the chunked two-pass scan over T
// that would add more is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
linear_scan_f32_kernel(const float* __restrict__ a, const float* __restrict__ x,
                       float* __restrict__ h, int64_t T, int64_t D) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * T * D + d;
  const float* ap = a + base;
  const float* xp = x + base;
  float* hp = h + base;

  float carry = 0.0f;
  int64_t t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float av[kUnroll];
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(ap + (t + u) * D);
      xv[u] = __ldg(xp + (t + u) * D);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = __fadd_rn(__fmul_rn(av[u], carry), xv[u]);
      hp[(t + u) * D] = carry;
    }
  }
  for (; t < T; ++t) {
    carry = __fadd_rn(__fmul_rn(__ldg(ap + t * D), carry), __ldg(xp + t * D));
    hp[t * D] = carry;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).  The caller checks shapes, types and contiguity.
extern "C" int linear_scan_f32(const float* a, const float* x, float* h,
                               int64_t B, int64_t T, int64_t D, void* stream) {
  if (B == 0 || T == 0 || D == 0) return 0;
  const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  linear_scan_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, x, h, T, D);
  return static_cast<int>(cudaGetLastError());
}
