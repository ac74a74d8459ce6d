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
// h in VMEM scratch.  Here each (b, d) channel stays one sequential chain
// over t, so the result is bit-identical to the plain PyTorch loop in
// kernels/ref.py: multiply and add are rounded separately (__fmul_rn /
// __fadd_rn, no contraction into an FMA) and nothing is re-associated.
// What bounds such a chain on the card is not arithmetic (512 dependent
// multiply-adds take ~3 us) but how many bytes are in flight: HBM needs
// about 3.35 TB/s x ~0.7 us = ~2.3 MB outstanding to run at its rate.
// So one warp owns a tile of 32 consecutive channels of one batch row
// (one 128-byte line per time step) and streams time through a ring of
// kStages chunks of kChunk steps in shared memory, filled by cp.async:
// while the warp runs the chain over chunk c, the copies of chunks
// c+1 .. c+kStages-1 are in flight, 40 KB a warp and ~12.8 MB across the
// card at (4, 512, 2560).  Each lane copies and reads only its own
// channel's column, so a lane's cp.async.wait_group is all the
// synchronisation there is.  The copies are 4 bytes a lane (one
// coalesced 128-byte line a warp), which takes any D: a ragged channel
// tile masks its lanes, a ragged last chunk its steps, and nothing is
// padded in device memory.  The outputs go out as coalesced 128-byte
// stores, one line per step.  What is left at (4, 512, 2560) is the
// pipeline's fill and drain (16 chunks a warp); at (4, 8192, 2560) they
// are amortised (PERF.md).  In side-by-side trials a shallower ring was
// slower at the long shape and 16-byte copies were no faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;     // channels per warp (one lane each)
constexpr int kChunk = 32;    // time steps per ring stage
constexpr int kStages = 6;    // ring depth: kStages - 1 chunks in flight

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kTile)
linear_scan_f32_kernel(const float* __restrict__ a, const float* __restrict__ x,
                       float* __restrict__ h, int64_t T, int64_t D) {
  __shared__ float ring[kStages][2][kChunk][kTile];   // 48 KB, all of static shared memory
  const int lane = threadIdx.x;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kTile + lane;
  const bool live = d < D;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * T * D + d;
  const float* ap = a + base;
  const float* xp = x + base;
  float* hp = h + base;
  const int64_t n_chunks = (T + kChunk - 1) / kChunk;

  // one commit group per chunk, empty past the end, so that
  // wait_group<kStages - 1> always means "chunk c has landed"
  auto issue = [&](int64_t c) {
    if (live && c < n_chunks) {
      const int64_t t0 = c * kChunk;
      const int steps = static_cast<int>(T - t0 < kChunk ? T - t0 : kChunk);
      float(*stage)[kChunk][kTile] = ring[c % kStages];
      for (int u = 0; u < steps; ++u) {
        cp_async4(&stage[0][u][lane], ap + (t0 + u) * D);
        cp_async4(&stage[1][u][lane], xp + (t0 + u) * D);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  float carry = 0.0f;
  for (int64_t c = 0; c < n_chunks; ++c) {
    // the stage refilled here held chunk c - 1, which this lane has consumed
    issue(c + kStages - 1);
    cp_async_wait<kStages - 1>();
    if (!live) continue;
    const float(*stage)[kChunk][kTile] = ring[c % kStages];
    const int64_t t0 = c * kChunk;
    if (t0 + kChunk <= T) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        carry = __fadd_rn(__fmul_rn(stage[0][u][lane], carry), stage[1][u][lane]);
        hp[(t0 + u) * D] = carry;
      }
    } else {
      for (int u = 0; t0 + u < T; ++u) {
        carry = __fadd_rn(__fmul_rn(stage[0][u][lane], carry), stage[1][u][lane]);
        hp[(t0 + u) * D] = carry;
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).  The caller checks shapes, types and contiguity.
extern "C" int linear_scan_f32(const float* a, const float* x, float* h,
                               int64_t B, int64_t T, int64_t D, void* stream) {
  if (B == 0 || T == 0 || D == 0) return 0;
  const dim3 grid(static_cast<unsigned>((D + kTile - 1) / kTile), static_cast<unsigned>(B));
  linear_scan_f32_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(a, x, h, T, D);
  return static_cast<int>(cudaGetLastError());
}
