// Per-page polynomial digest of a leaf's raw bytes, two 32-bit lanes:
//
//   digest[p, m] = sum_i (x[p, i] + SALT) * A_m^(W-1-i)   (mod 2^32)
//
// where x[p, i] is the i-th little-endian 32-bit word of page p, W is the
// page's word count padded to a multiple of the digest block (512 words),
// and every word past the leaf's bytes or past the page is a zero word
// (it still contributes SALT * A_m^(W-1-i)).
//
// Replaces repro/kernels/page_digest.py::page_digest_pallas (body
// _digest_kernel), the checkpoint layer's delta scan.
//
// Bound: HBM traffic.  Each page is read once (its padded bytes); the
// arithmetic is about 20 integer operations per 16 bytes, far below the
// card's integer rate, so the least time is the leaf's padded bytes over
// the memory rate.
//
// Design: the TPU kernel walks word blocks as a sequential grid axis and
// carries the Horner accumulator in VMEM.  Blocks here run in no order,
// but the digest is a sum mod 2^32 of per-word terms, so any split gives
// the same bits.  One thread block owns one page.  Thread t takes the
// 16-byte vectors v = t, t + 256, t + 512, ... (coalesced 16-byte loads,
// four in flight per thread), folds each vector's four words with
// Horner in A (x0 A^3 + x1 A^2 + x2 A + x3) and its vectors with Horner
// in A^1024 (the stride between them), then shifts its sum by
// A^(W-4-4*v_last), the weight of its last word.  A warp-shuffle and
// shared-memory sum adds the 256 partial sums, all in uint32, whose
// wrap-around is the mod 2^32 of the definition.  The leaf is read in
// place: bytes past its end are treated as zero, so no padded copy is
// made; a page that is not 16-byte aligned, or the ragged tail, takes a
// byte-wise path.  The constants (A_0, A_1, SALT) come from the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ uint32_t pow_u32(uint32_t a, uint64_t e) {
  uint32_t r = 1;
  while (e) {
    if (e & 1) r *= a;
    a *= a;
    e >>= 1;
  }
  return r;
}

// Little-endian word of the 4 bytes at `byte` of the page, zero past `avail`.
__device__ __forceinline__ uint32_t word_at(const uint8_t* page, int64_t avail, int64_t byte) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (byte + j < avail) w |= static_cast<uint32_t>(page[byte + j]) << (8 * j);
  }
  return w;
}

struct Lanes {
  uint32_t a0, a0_2, a0_3, q0;   // A_0, A_0^2, A_0^3, A_0^(4 * kThreads)
  uint32_t a1, a1_2, a1_3, q1;
  uint32_t salt;
  uint32_t acc0 = 0, acc1 = 0;

  __device__ __forceinline__ void fold(uint4 x) {
    const uint32_t x0 = x.x + salt, x1 = x.y + salt, x2 = x.z + salt, x3 = x.w + salt;
    acc0 = acc0 * q0 + (x0 * a0_3 + x1 * a0_2 + x2 * a0 + x3);
    acc1 = acc1 * q1 + (x0 * a1_3 + x1 * a1_2 + x2 * a1 + x3);
  }
};

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* shared) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? shared[lane] : 0u;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
page_digest_kernel(const uint8_t* __restrict__ data, int64_t n_bytes, int64_t page_bytes,
                   int64_t page_words, uint32_t a0, uint32_t a1, uint32_t salt,
                   int32_t* __restrict__ out) {
  __shared__ uint32_t shared[kThreads / 32];
  const int64_t p = blockIdx.x;
  const uint8_t* page = data + p * page_bytes;
  const int64_t left = n_bytes - p * page_bytes;
  const int64_t avail = left < page_bytes ? left : page_bytes;   // data bytes in this page
  const int64_t n_vec = page_words / 4;                          // 16-byte vectors, padded page
  const bool aligned = (reinterpret_cast<uintptr_t>(page) & 15) == 0;
  const int64_t n_fast = aligned ? avail / 16 : 0;               // vectors wholly in the data

  Lanes s;
  s.a0 = a0; s.a0_2 = a0 * a0; s.a0_3 = a0 * a0 * a0; s.q0 = pow_u32(a0, 4 * kThreads);
  s.a1 = a1; s.a1_2 = a1 * a1; s.a1_3 = a1 * a1 * a1; s.q1 = pow_u32(a1, 4 * kThreads);
  s.salt = salt;

  int64_t v = threadIdx.x;
  for (; v + (kUnroll - 1) * kThreads < n_fast; v += kUnroll * kThreads) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      x[u] = __ldg(reinterpret_cast<const uint4*>(page + (v + u * kThreads) * 16));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s.fold(x[u]);
  }
  for (; v < n_fast; v += kThreads) s.fold(__ldg(reinterpret_cast<const uint4*>(page + v * 16)));
  for (; v < n_vec; v += kThreads) {
    const int64_t b = v * 16;
    s.fold(make_uint4(word_at(page, avail, b), word_at(page, avail, b + 4),
                      word_at(page, avail, b + 8), word_at(page, avail, b + 12)));
  }
  if (v > threadIdx.x) {
    // shift by the weight of this thread's last word, i = 4 * v_last + 3
    const uint64_t e = static_cast<uint64_t>(page_words - 4 - 4 * (v - kThreads));
    s.acc0 *= pow_u32(a0, e);
    s.acc1 *= pow_u32(a1, e);
  }
  const uint32_t d0 = block_sum(s.acc0, shared);
  const uint32_t d1 = block_sum(s.acc1, shared);
  if (threadIdx.x == 0) {
    out[2 * p] = static_cast<int32_t>(d0);
    out[2 * p + 1] = static_cast<int32_t>(d1);
  }
}

}  // namespace

// Digests of the ceil(n_bytes / page_bytes) pages of `data` into
// out[n_pages][2] (the uint32 bits as int32).  page_words is the padded
// word count of one page (page_bytes / 4 rounded up to the digest
// block).  Launches on `stream`; returns the cudaError_t of the launch
// (0 on success).  The caller checks sizes, types and contiguity.
extern "C" int page_digest_u8(const uint8_t* data, int64_t n_bytes, int64_t page_bytes,
                              int64_t page_words, uint32_t a0, uint32_t a1, uint32_t salt,
                              int32_t* out, int64_t n_pages, void* stream) {
  if (n_pages == 0) return 0;
  if (page_bytes <= 0 || page_bytes % 4 != 0 || page_words % 4 != 0 ||
      page_words * 4 < page_bytes || n_pages > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  page_digest_kernel<<<static_cast<unsigned>(n_pages), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      data, n_bytes, page_bytes, page_words, a0, a1, salt, out);
  return static_cast<int>(cudaGetLastError());
}
