// Hopper building blocks shared by the port's tensor-core attention kernels
// (flash_attention_sm90.cu, forward; flash_attention_bwd_sm90.cu, backward):
// mbarriers, named barriers, TMA loads of 128-byte swizzled 64-column bf16
// atoms through a 4-d (D, T, heads, batch) tensor map, wgmma descriptors,
// the wgmma forms the kernels use (bf16: m64n64k16 with A from shared memory
// or registers, m64n128k16 and m64n32k16 with both from shared memory, B K-
// or (m64n128k16) MN-major; fp16: m64n64k16 from shared memory, and
// m64n64k16 and m64n128k16 with A from registers and B MN-major; float32
// accumulators),
// register reallocation between warpgroups, the tensor map's encoding
// through the CUDA runtime, and the scaled fp16 copies both libraries' fp16
// products read.
// Included once per source, each built into its own library.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAtom = 64;    // bf16 columns of one 128-byte swizzle atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// 2^x, one MUFU instruction (relative error ~2^-22; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// whether the phase of parity `parity` has completed (the current phase or
// the one before it), without waiting
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed.  Every wait ends
// within one tile's work; one that does not is a fault of the kernel, and
// trapping turns it into a failed launch instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint32_t spins = 0;
  do {
    if (++spins > (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 64-column x rows box of a 4-d (D, T, heads, batch) tensor map into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma descriptor of a tile of 128-byte rows, 128-byte swizzled, in 1024-byte
// groups of 8 rows; the leading and stride byte offsets are both that group
// (for a K-major tile the leading offset is not read; for an MN-major
// 64-column tile the 8-row groups step along K)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// the same for an MN-major tile of two 64-column atoms `lbo` bytes apart:
// the leading byte offset steps from one atom to the next along MN
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the last committed group done (groups complete in order)
__device__ __forceinline__ void wgmma_wait_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator (or of
// the registers an A operand is read from) across the asynchronous wgmma
// that owns it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// x, opaque to the compiler: a tile's base address passed through it where
// a loop issues wgmma keeps the descriptors computed from it (64-bit, one a
// 16-column step) from being hoisted out of the loop into registers
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads: wait
// for all of them, or arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the registers a thread of this warpgroup may hold from here on; every
// warp of the warpgroup executes it
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d (64 x 64 float32) (+)= A (64 x 16 bf16) . B (16 x 64 bf16), A and B in shared
// memory, both K-major and 128-byte swizzled; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = A . B, as wgmma_ss with scale_d = 0, d an output only: its earlier
// values are not read, so they need not stay live
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d (64 x 64 float32) (+)= A (64 x 16 bf16, four registers a thread, the layout of
// a float32 accumulator's 16 columns) . B (16 x 64 bf16, shared memory, MN-major:
// B's 64 columns contiguous, 128-byte swizzled).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128 float32) (+)= A (64 x 16 bf16) . B (16 x 128 bf16), A and B in
// shared memory, both K-major and 128-byte swizzled (B: 128 rows of 128
// bytes, 16 groups of 8 rows); scale_d = 0 overwrites d.  Thread t holds
// d[4j .. 4j+3] = rows r, r, r + 8, r + 8 and columns 8j + c, 8j + c + 1 of
// each 8-column group j, as the m64n64k16 form does for j < 8.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = A (64 x 16) . B (16 x 128), as wgmma_ss_n128 with scale_d = 0, d an
// output only: its earlier values are not read, so they need not stay live
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d (64 x 32 float32) (+)= A (64 x 16 bf16) . B (16 x 32 bf16), A and B in
// shared memory, both K-major and 128-byte swizzled (B: 32 rows of 128
// bytes); scale_d = 0 overwrites d.  Thread t holds d[4j .. 4j+3] for j < 4,
// as the m64n64k16 form does.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = A . B, as wgmma_ss_n32 with scale_d = 0, d an output only
__device__ __forceinline__ void wgmma_ss_n32_first(float (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d (64 x 128 float32, two 64-column halves) += A (64 x 16 bf16, shared
// memory, K-major) . B (16 x 128 bf16, shared memory, MN-major: two
// 64-column atoms, desc_mn), both 128-byte swizzled
__device__ __forceinline__ void wgmma_ss_tb_n128(float (&d)[2][32], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]),
        "+f"(d[0][6]), "+f"(d[0][7]), "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]), "+f"(d[0][16]),
        "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]),
        "+f"(d[0][22]), "+f"(d[0][23]), "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]),
        "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]),
        "+f"(d[1][6]), "+f"(d[1][7]), "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]), "+f"(d[1][16]),
        "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]),
        "+f"(d[1][22]), "+f"(d[1][23]), "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]),
        "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// wgmma_ss and wgmma_ss_first on fp16 operands
__device__ __forceinline__ void wgmma_ss_f16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_first_f16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d (64 x 128 float32, two 64-column halves) += A (64 x 16 fp16, four
// registers a thread in the layout of a float32 accumulator's 16 columns) .
// B (16 x 128 fp16, shared memory, MN-major: two 64-column atoms, desc_mn)
__device__ __forceinline__ void wgmma_rs_n128_f16(float (&d)[2][32], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]),
        "+f"(d[0][6]), "+f"(d[0][7]), "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]), "+f"(d[0][16]),
        "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]),
        "+f"(d[0][22]), "+f"(d[0][23]), "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]),
        "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]),
        "+f"(d[1][6]), "+f"(d[1][7]), "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]), "+f"(d[1][16]),
        "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]),
        "+f"(d[1][22]), "+f"(d[1][23]), "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]),
        "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// wgmma_rs on fp16 operands: d (64 x 64 float32) += A (64 x 16 fp16, four
// registers a thread) . B (16 x 64 fp16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_f16(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// makes this thread's ordinary stores to shared memory visible to the
// asynchronous proxy (wgmma operands, TMA), once a barrier orders them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// two floats as the packed bf16 pair of a wgmma A register (first in the low half)
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// two floats as the packed fp16 pair of a wgmma A register (first in the low
// half), each rounded once to nearest (cvt.rn.f16x2.f32)
__device__ __forceinline__ uint32_t pack_f16(float a, float b) {
  __half2 x = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&x);
}

// a 1-d copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda at link time)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// (D, T, heads, batch) view of 16-bit elements (bf16 unless `type` says
// otherwise) with element strides st, sh, sb; boxes of 64 columns x `rows`
// rows, 128-byte swizzled, zeros past every edge.  A
// dimension of size 1 is never stepped, so its stride is replaced by a
// valid one (TMA wants strides that are multiples of 16 bytes).
bool make_map(CUtensorMap* map, const void* base, int64_t D, int64_t T, int64_t H, int64_t B,
              int64_t st, int64_t sh, int64_t sb, int rows,
              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const int64_t dummy = (D * 2 + 15) / 16 * 16;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(T == 1 ? dummy : st * 2),
                                 static_cast<cuuint64_t>(H == 1 ? dummy : sh * 2),
                                 static_cast<cuuint64_t>(B == 1 ? dummy : sb * 2)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kAtom), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Scaled fp16 copies of bf16 tensors (the backward's q, k, v and do at head
// widths up to 128, the forward's v at 65-128), each times a power of two
// 2^e of its own, e = fp16_exponent(max |x|): (a0) absmax_kernel reduces
// each tensor's largest |x| to partial maxima, one a block, (a1)
// convert_kernel reduces those to the exponents, writes the copies and
// hands the exponents once to the caller's epilogue (convert_fp16 launches
// both).
// ---------------------------------------------------------------------------

constexpr int kConvThreads = 256;
// (a0) runs 4 kConvBlocks blocks over its n tensors, conv_blocks(n) = 4
// kConvBlocks / n a tensor, so that one tensor alone still fills the card,
// each writing one partial maximum; (a1) as many a tensor it copies
constexpr int kConvBlocks = 256;

// The power of two e that takes bf16 values of largest magnitude m (given by
// a float's bits) into fp16: 2^15 <= m 2^e <= 65280 (bf16's largest
// mantissa), so nothing overflows fp16's 65504, and every value of 2^-32 m
// or more converts exactly (an fp16 normal, or a subnormal multiple of
// 2^-24: a bf16 value has 8 significant bits).  At most 127 (m zero or
// below 2^-112: m 2^127 < 2^15 then).  flash_attention_bwd_sm90.py's
// fp16_exponent mirrors it.
__device__ __forceinline__ int fp16_exponent(uint32_t m) {
  const int e8 = static_cast<int>((m >> 23) & 0xff);
  return e8 == 0 ? 127 : min(142 - e8, 127);
}

// 2^e, -126 <= e <= 127
__device__ __forceinline__ float exp2i(int e) { return __int_as_float((e + 127) << 23); }

// one (B, H, T, D) bf16 tensor, unit stride in D: its element strides and rows B H T
struct Src16 {
  const __nv_bfloat16* x;
  int64_t sb, sh, st, H, T, rows;
};
struct ConvArgs {
  Src16 t[4];        // the tensors whose maxima (a0) takes and (a1) reduces
  __half* out[4];    // fp16 copies of the first ones, contiguous (B, H, T, D)
  int64_t D;
  int n;             // tensors in t (at most 4)
};

// the blocks a tensor of (a0) and (a1) over n tensors, and its partial maxima
__host__ __device__ __forceinline__ int conv_blocks(int n) { return 4 * kConvBlocks / n; }

// f(row, its first element) for this block's share of t's rows, a
// contiguous range walked kConvThreads / LANES rows at a time, LANES
// threads a row of 8 columns each (8 up to 64 columns, 16 above:
// convert_fp16): the row's (batch, head, position) found by division once,
// then stepped
template <int LANES, class F>
__device__ __forceinline__ void for_rows(const Src16& t, F f) {
  constexpr int step = kConvThreads / LANES;
  const int64_t per = (t.rows + gridDim.x - 1) / gridDim.x;
  const int64_t last = static_cast<int64_t>(blockIdx.x + 1) * per;
  const int64_t end = last < t.rows ? last : t.rows;
  int64_t row = static_cast<int64_t>(blockIdx.x) * per + threadIdx.x / LANES;
  if (row >= end) return;
  int64_t i = row % t.T, h = (row / t.T) % t.H, b = row / t.T / t.H;
  for (; row < end; row += step) {
    f(row, t.x + b * t.sb + h * t.sh + i * t.st);
    for (i += step; i >= t.T; i -= t.T)
      if (++h == t.H) { h = 0; ++b; }
  }
}

// the largest of x over the block's threads (unsigned: float bits of magnitudes)
__device__ __forceinline__ uint32_t block_max(uint32_t x) {
  __shared__ uint32_t warp_max[kConvThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x / 32] = x;
  __syncthreads();
  x = 0;
#pragma unroll
  for (int w = 0; w < kConvThreads / 32; ++w) x = max(x, warp_max[w]);
  return x;
}

// (a0) block (i, t): the largest |x| of its share of tensor t's rows
// (for_rows), as a float's bits, into parts[t][i].  8 columns a lane; bf16
// magnitudes compare as unsigned integers (a NaN above every number).
template <int LANES>
__global__ void __launch_bounds__(kConvThreads)
absmax_kernel(const __grid_constant__ ConvArgs a, uint32_t* parts) {
  const int col = 8 * (threadIdx.x % LANES);
  uint32_t m = 0;   // two bf16 magnitudes
  if (col < a.D)
    for_rows<LANES>(a.t[blockIdx.y], [&](int64_t, const __nv_bfloat16* x0) {
      const uint4 x = *reinterpret_cast<const uint4*>(x0 + col);
      m = __vmaxu2(m, x.x & 0x7fff7fffu);
      m = __vmaxu2(m, x.y & 0x7fff7fffu);
      m = __vmaxu2(m, x.z & 0x7fff7fffu);
      m = __vmaxu2(m, x.w & 0x7fff7fffu);
    });
  m = block_max(max(m & 0xffffu, m >> 16) << 16);
  if (threadIdx.x == 0) parts[blockIdx.y * gridDim.x + blockIdx.x] = m;
}

// (a1) block (i, t): its share of tensor t's rows, times 2^e_t, to fp16;
// block (0, 0) also calls epi(e), e the exponents of all a.n tensors.
// Every block reduces the partial maxima of all of them (at most 4 KB), so
// that no launch of its own has to.
template <int LANES, class Epilogue>
__global__ void __launch_bounds__(kConvThreads)
convert_kernel(const __grid_constant__ ConvArgs a, const uint32_t* parts, const Epilogue epi) {
  __shared__ int e_s[4];
  if (threadIdx.x < a.n * 32) {   // warp w: tensor w's partial maxima
    const int w = threadIdx.x / 32;
    uint32_t m = 0;
    const int per = conv_blocks(a.n);
    for (int i = threadIdx.x & 31; i < per; i += 32) m = max(m, parts[w * per + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) e_s[w] = fp16_exponent(m);
  }
  __syncthreads();
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) epi(e_s);
  __half* out = a.out[blockIdx.y];
  const float mul = exp2i(e_s[blockIdx.y]);
  const int col = 8 * (threadIdx.x % LANES);
  if (col >= a.D) return;
  for_rows<LANES>(a.t[blockIdx.y], [&](int64_t row, const __nv_bfloat16* x0) {
    const uint4 x = *reinterpret_cast<const uint4*>(x0 + col);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    uint4 h;
    uint32_t* hw = reinterpret_cast<uint32_t*>(&h);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x2[e]);
      hw[e] = pack_f16(f.x * mul, f.y * mul);
    }
    *reinterpret_cast<uint4*>(out + row * a.D + col) = h;
  });
}

// (a0) over a.n tensors into `parts` (4 kConvBlocks uint32), then (a1)
// writing the copies of the first `copies` of them, on `stream`; the first
// cudaError_t
template <int LANES, class Epilogue>
cudaError_t convert_fp16_lanes(const ConvArgs& a, int copies, uint32_t* parts,
                               const Epilogue& epi, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(conv_blocks(a.n));
  absmax_kernel<LANES><<<dim3(blocks, a.n), kConvThreads, 0, stream>>>(a, parts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  convert_kernel<LANES, Epilogue>
      <<<dim3(blocks, copies), kConvThreads, 0, stream>>>(a, parts, epi);
  return cudaGetLastError();
}
template <class Epilogue>
cudaError_t convert_fp16(const ConvArgs& a, int copies, uint32_t* parts, const Epilogue& epi,
                         cudaStream_t stream) {
  return a.D <= 64 ? convert_fp16_lanes<8>(a, copies, parts, epi, stream)
                   : convert_fp16_lanes<16>(a, copies, parts, epi, stream);
}

}  // namespace
