// GQA online-softmax (flash) attention, forward, for bfloat16 q, k and v on
// Hopper's tensor cores:
//
//   out[b, h, i] = sum_j p_ij v[b, h / G, j] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij) over the live keys j of row i,
//   s_ij = D^-0.5 (q[b, h, i] . k[b, h / G, j]), optionally softcap * tanh(s / softcap),
//
// with G = Hq / Hkv query heads per kv head.  Key j is live for row i when
// j < Tk, (causal) j <= qpos and (window) j > qpos - window, where
// qpos = q_offset + i.  A row with no live key comes out as zeros.  The
// output is bfloat16; m, l and the accumulator are float32.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (body
// _attn_kernel) for bfloat16 inputs, which the reference's long-context
// serving path computes for every attention over more than 4096 kv
// positions (models/layers.py _blockwise_attention, its jnp twin).
// Float32 inputs go to csrc/flash_attention.cu, which keeps the
// reference's float32 products.
//
// Bound: operations.  Each live (query, key) pair costs 4 * D flops (the
// score's dot and the value's multiply-add) against 2 * D bytes of q and
// out per query and of k and v per key; at a long prompt that is far
// above the card's ridge point, so the kernel runs both products as
// wgmma on the bf16 tensor cores (989 TFLOP/s).
//
// Design (FlashAttention-3's building blocks, kept simple):
// - One block per NC * 64 query rows of one (b, q-head): NC warpgroups of
//   64 rows each, NC = 3 for head widths up to 128 (168 registers a
//   thread) and 2 above (up to 255, for the wider accumulator).  Thread 0
//   issues every TMA load: the q tiles and the first k/v tiles at the
//   start, then each later k/v tile into the stage of the tile before
//   last, once every warp has released that stage.  A third warpgroup of
//   rows, rather than a producer warpgroup, makes each k/v tile serve
//   more query rows.
// - The block walks only the 64-key tiles that one of its rows can see
//   (causal, window, q_offset), so a sliding window costs O(T * window), as
//   the TPU kernel's pl.when skip makes it; a warpgroup skips the tiles
//   none of its own rows sees, and masks only the tiles that cross a mask
//   edge.
// - q, k and v arrive by TMA into a ring of stages in shared memory, in
//   128-byte swizzled 64-column atoms: the head dimension is read as D
//   columns of a 4-d tensor map (D, T, heads, batch) with the tensors' own
//   strides, so k and v are read in place as the projection's strided
//   views; columns past D (D = 120: 8 of the 128) come in as zeros (the
//   tensor map's out-of-bounds fill), add nothing to a dot and are never
//   stored.  Rows past Tq or Tk come in as zeros too.  A full mbarrier
//   per stage says its tiles have landed, an empty one that every warp
//   is done with them.
// - S = q k^T is a wgmma with both operands in shared memory (K-major),
//   accumulated in float32; the scale D^-0.5 is applied to S in float32,
//   so q is not rounded again after scaling as it would be if the scaled
//   q were fed to the tensor cores (the reference scales q in float32).
// - The online softmax runs on the accumulator's registers: each thread
//   holds two rows' 16 columns, so the row max and sum are two quad
//   shuffles.  A probability is one FFMA and one exp2 (float32, MUFU) of
//   the unscaled score; the reference point of the exponentials moves
//   only when a row's max grows by more than 8 in exp2 units, so most
//   tiles skip the accumulator's rescaling (the same softmax, with p < 256).
// - P V is a wgmma with P from registers: the float32 accumulator of S has
//   the register layout of the bf16 A operand, so P never goes through
//   shared memory.  P rounded once to bf16 misses the per-element gate
//   (2^-7 |want| + 1e-4) on long rows, so P is split into two bf16 parts,
//   hi = bf16(p) and lo = bf16(p - hi), and P V is the sum of two wgmma
//   (hi V + lo V, exact products, float32 sums): p is carried to ~2^-16
//   relative, as close as a float32 p for the gate.
// - Head widths up to 256 (multiples of 8): the accumulator is D / 64
//   blocks of a 64 x 64 wgmma tile, each its own 32 registers a thread.

#include <math_constants.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBM = 64;      // query rows per consumer warpgroup
constexpr int kBN = 64;      // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// DP: the head width rounded up to a multiple of 64 (the width of the tiles)
template <int DP>
struct Cfg {
  // warpgroups, 64 query rows each: three at 168 registers a thread, two
  // (up to 255 registers) where the accumulator is wider than 128 columns
  static constexpr int kNC = DP <= 128 ? 3 : 2;
  static constexpr int kThreads = 128 * kNC;
  static constexpr int kStages = DP <= 128 ? 4 : (DP <= 192 ? 3 : 2);   // k/v ring depth
  static constexpr int kNB = DP / kAtom;                   // 64-column blocks
  static constexpr int kQBytes = kBM * DP * 2;             // one warpgroup's q tile
  static constexpr int kKVBytes = kBN * DP * 2;            // one k (or v) tile
  static constexpr int kSmem =
      1024 + kNC * kQBytes + 2 * kStages * kKVBytes + 8 * (2 * kStages + 1);
};

struct Params {
  void* o;
  float* lse;   // (B, Hq, Tq) row log-sum-exp, or null: not written
  int64_t Hq, Tq, Tk, D, group;
  int64_t window, q_offset;
  int causal, has_window, has_softcap;
  float softcap, scale, scale_log2;
};

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms and wgmma descriptors want 1024-byte aligned tiles
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                                   // kNC q tiles
  uint8_t* ks = qs + C::kNC * C::kQBytes;               // kStages k tiles
  uint8_t* vs = ks + C::kStages * C::kKVBytes;          // kStages v tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + C::kStages * C::kKVBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // the last query tiles see the most keys: start them first
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * (C::kNC * kBM);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = static_cast<int>(h / p.group);

  // the key tiles that any row of this block can see
  const int64_t rows_end = q0 + C::kNC * kBM < p.Tq ? q0 + C::kNC * kBM : p.Tq;
  const int64_t q_first = p.q_offset + q0;
  const int64_t q_last = p.q_offset + rows_end - 1;
  int64_t k_end = p.Tk;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0) k_begin = q_first - p.window + 1;
  k_begin = k_begin / kBN * kBN;
  const int n_tiles = k_end > k_begin ? static_cast<int>((k_end - k_begin + kBN - 1) / kBN) : 0;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kNC * 4);   // lane 0 of every warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues the q tiles and the first kStages k/v tiles; later
  // tiles it issues from inside the loop below, into the stage of the tile
  // before last once every warp has released it
  auto issue_kv = [&](int t) {
    const int s = t % C::kStages;
    mbar_expect_tx(&full[s], 2 * C::kKVBytes);
    const int kt = static_cast<int>(k_begin + static_cast<int64_t>(t) * kBN);
    for (int nb = 0; nb < C::kNB; ++nb) {
      tma_load(ks + s * C::kKVBytes + nb * kBN * 128, &kmap, &full[s], nb * kAtom, kt, hk, b);
      tma_load(vs + s * C::kKVBytes + nb * kBN * 128, &vmap, &full[s], nb * kAtom, kt, hk, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, C::kNC * C::kQBytes);
    for (int c = 0; c < C::kNC; ++c)
      for (int nb = 0; nb < C::kNB; ++nb)
        tma_load(qs + c * C::kQBytes + nb * kBM * 128, &qmap, qbar, nb * kAtom,
                 static_cast<int>(q0 + c * kBM), h, b);
    for (int t = 0; t < C::kStages && t < n_tiles; ++t) issue_kv(t);
  }

  // ---- consumer warpgroup wg: query rows q0 + wg * 64 ... + 63
  const int lane = tid & 31;
  const int warp = (tid / 32) & 3;
  const int r0 = warp * 16 + lane / 4;     // this thread's rows: r0 and r0 + 8
  const int c2 = (lane & 3) * 2;           // and columns 8j + c2, 8j + c2 + 1
  const int64_t wq0 = q0 + wg * kBM;
  const int64_t qa = p.q_offset + wq0;                                   // first row
  const int64_t qb = p.q_offset + (wq0 + kBM < p.Tq ? wq0 + kBM : p.Tq) - 1;   // last row
  const int64_t pos0 = qa + r0;
  const int64_t pos1 = pos0 + 8;
  const uint32_t q_base = smem_u32(qs + wg * C::kQBytes);

  float o[C::kNB][32];
#pragma unroll
  for (int nb = 0; nb < C::kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.0f;
  // Scores stay unscaled (or capped, then in log2 units); f turns them into
  // log2 units, so each probability is one FFMA and one exp2:
  // p = exp2(f s - f m).  m is the reference point of the exponentials.
  const float f = p.has_softcap ? 1.0f : p.scale_log2;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.0f, l1 = 0.0f;         // this thread's share of the row sums

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::kStages;
    const int64_t kt = k_begin + static_cast<int64_t>(t) * kBN;
    mbar_wait(&full[s], (t / C::kStages) & 1);
    const bool dead = wq0 >= p.Tq || kt >= p.Tk || (p.causal && kt > qb) ||
                      (p.has_window && kt + kBN - 1 <= qa - p.window);
    if (!dead) {
      const uint32_t k_base = smem_u32(ks + s * C::kKVBytes);
      const uint32_t v_base = smem_u32(vs + s * C::kKVBytes);

      // S = q k^T over the head width, 16 columns a step
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      reg_fence(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(sc, desc(q_base + (kk / 4) * kBM * 128 + (kk % 4) * 32),
                 desc(k_base + (kk / 4) * kBN * 128 + (kk % 4) * 32), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // softcap, masks of the tiles that cross a mask edge, row max
      const bool all_live = kt + kBN <= p.Tk && (!p.causal || kt + kBN - 1 <= qa) &&
                            (!p.has_window || kt > qb - p.window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i];
        if (p.has_softcap) x = p.softcap * tanhf(x * p.scale / p.softcap) * kLog2e;
        if (!all_live) {
          const int64_t kpos = kt + (i / 4) * 8 + c2 + (i & 1);
          const int64_t qpos = (i & 2) ? pos1 : pos0;
          const bool live = kpos < p.Tk && (!p.causal || kpos <= qpos) &&
                            (!p.has_window || kpos > qpos - p.window);
          if (!live) x = -CUDART_INF_F;
        }
        sc[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      // the four threads of a quad hold one row's 64 columns
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // The row max moves the reference point m of the exponentials only
      // when it grows by more than 2^8 (in exp2 units): below that, p stays
      // under 256 and the accumulator needs no rescaling.  A row that has
      // seen no live key yet keeps m = -inf, alpha = 1 and p = 0.
      const bool up0 = (mx0 - m0) * f > 8.0f;
      const bool up1 = (mx1 - m1) * f > 8.0f;
      const float alpha0 = up0 ? ex2((m0 - mx0) * f) : 1.0f;
      const float alpha1 = up1 ? ex2((m1 - mx1) * f) : 1.0f;
      if (up0) m0 = mx0;
      if (up1) m1 = mx1;
      const float mf0 = m0 == -CUDART_INF_F ? 0.0f : m0 * f;
      const float mf1 = m1 == -CUDART_INF_F ? 0.0f : m1 * f;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float pr = ex2(fmaf(sc[i], f, (i & 2) ? -mf1 : -mf0));
        sc[i] = pr;
        if (i & 2) sum1 += pr;
        else sum0 += pr;
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      if (__any_sync(0xffffffffu, up0 || up1)) {
#pragma unroll
        for (int nb = 0; nb < C::kNB; ++nb)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[nb][i] *= (i & 2) ? alpha1 : alpha0;
      }

      // P = hi + lo, each bf16, in the A-operand layout: register r of the
      // 16-key step kk holds sc[8kk + 2r], sc[8kk + 2r + 1]
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sc[8 * kk + 2 * r];
          const float c = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
          const float2 hf = __bfloat1622float2(hi);
          phi[kk][r] = pack_bf16(hi);
          plo[kk][r] = pack_bf16(__floats2bfloat162_rn(a - hf.x, c - hf.y));
        }

      // O += P_hi V + P_lo V, one 64-column block of the head at a time
#pragma unroll
      for (int nb = 0; nb < C::kNB; ++nb) reg_fence(o[nb]);
      wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < C::kNB; ++nb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv = desc(v_base + nb * kBN * 128 + kk * 16 * 128);
          wgmma_rs(o[nb], phi[kk], dv, 1);
          wgmma_rs(o[nb], plo[kk], dv, 1);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < C::kNB; ++nb) reg_fence(o[nb]);
    }
    // this warp has finished reading stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && t >= 1 && t - 1 + C::kStages < n_tiles) {
      mbar_wait(&empty[(t - 1) % C::kStages], ((t - 1) / C::kStages) & 1);
      issue_kv(t - 1 + C::kStages);
    }
    __syncwarp();
  }

  // out = acc / l; a row with no live key has l == 0 and comes out as zeros
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = l0 == 0.0f ? 1.0f : l0;
  const float d1 = l1 == 0.0f ? 1.0f : l1;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                      (static_cast<int64_t>(b) * p.Hq + h) * p.Tq * p.D;
  const int64_t row0 = wq0 + r0;
  const int64_t row1 = row0 + 8;
  // log-sum-exp of each row's scores: m f is in log2 units of the scaled score
  if (p.lse != nullptr && (lane & 3) == 0) {
    float* lse = p.lse + (static_cast<int64_t>(b) * p.Hq + h) * p.Tq;
    if (row0 < p.Tq) lse[row0] = l0 == 0.0f ? -CUDART_INF_F : (m0 * f + log2f(l0)) * kLn2;
    if (row1 < p.Tq) lse[row1] = l1 == 0.0f ? -CUDART_INF_F : (m1 * f + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int nb = 0; nb < C::kNB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * kAtom + 8 * j + c2;   // D is even: col < D covers col + 1
      if (col >= p.D) continue;
      if (row0 < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(og + row0 * p.D + col) =
            __floats2bfloat162_rn(o[nb][4 * j] / d0, o[nb][4 * j + 1] / d0);
      if (row1 < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(og + row1 * p.D + col) =
            __floats2bfloat162_rn(o[nb][4 * j + 2] / d1, o[nb][4 * j + 3] / d1);
    }
}

template <int DP>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const Params& p,
           int64_t B, cudaStream_t stream) {
  using C = Cfg<DP>;
  static bool configured = false;   // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_sm90_kernel<DP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int64_t rows = C::kNC * kBM;
  const dim3 grid(static_cast<unsigned>((p.Tq + rows - 1) / rows), static_cast<unsigned>(p.Hq),
                  static_cast<unsigned>(B));
  flash_attention_sm90_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, Tq, D), k and v: (B, Hkv, Tk, D), bfloat16, each with unit
// stride in D and the given strides (in elements) in its first three
// dimensions, every base address and stride a multiple of 16 bytes; o:
// contiguous (B, Hq, Tq, D) bfloat16.  8 <= D <= 256 with D a multiple of
// 8, Hq a multiple of Hkv, Tk >= 1.  lse: contiguous float32 (B, Hq, Tq)
// for each row's log-sum-exp (-inf where a row sees no key), or null.
// Launches on `stream`; returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for arguments the kernel does not take or
// a tensor map CUDA refuses).
// The caller checks shapes, types and devices.
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                        int64_t B, int64_t Hq, int64_t Hkv, int64_t Tq,
                                        int64_t Tk, int64_t D, int64_t q_sb, int64_t q_sh,
                                        int64_t q_st, int64_t k_sb, int64_t k_sh, int64_t k_st,
                                        int64_t v_sb, int64_t v_sh, int64_t v_st, int causal,
                                        int has_window, int64_t window, int64_t q_offset,
                                        int has_softcap, float softcap, float scale,
                                        void* lse, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (D < 8 || D > 256 || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 ||
      Tk < 1 || Tq > 0x7fffffff || Tk > 0x7fffffff)
    return static_cast<int>(bad);
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  const int64_t DP = (D + 63) / 64 * 64;
  CUtensorMap qm, km, vm;
  const int rows = 64;   // kBM == kBN
  if (!make_map(&qm, q, D, Tq, Hq, B, q_st, q_sh, q_sb, rows) ||
      !make_map(&km, k, D, Tk, Hkv, B, k_st, k_sh, k_sb, rows) ||
      !make_map(&vm, v, D, Tk, Hkv, B, v_st, v_sh, v_sb, rows))
    return static_cast<int>(bad);
  Params p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.Hq = Hq; p.Tq = Tq; p.Tk = Tk; p.D = D; p.group = Hq / Hkv;
  p.window = window; p.q_offset = q_offset;
  p.causal = causal; p.has_window = has_window; p.has_softcap = has_softcap;
  p.softcap = softcap; p.scale = scale; p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DP) {
    case 64: return launch<64>(qm, km, vm, p, B, s);
    case 128: return launch<128>(qm, km, vm, p, B, s);
    case 192: return launch<192>(qm, km, vm, p, B, s);
    default: return launch<256>(qm, km, vm, p, B, s);
  }
}
