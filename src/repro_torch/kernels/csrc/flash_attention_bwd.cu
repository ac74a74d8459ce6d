// GQA online-softmax (flash) attention, backward: the gradients of
//
//   o[b, h, i] = sum_j p_ij v[b, h / G, j],   p_ij = exp(s_ij - lse_i),
//   s_ij = D^-0.5 (q[b, h, i] . k[b, h / G, j]), optionally c tanh(s / c),
//
// over the live keys j of row i (j < Tk, causal j <= qpos, window
// j > qpos - window, qpos = q_offset + i), given the forward's output o and
// its row log-sum-exp lse (-inf for a row with no live key):
//
//   delta_i = sum_d do_id o_id,  dp_ij = do_i . v_j,
//   ds_ij = p_ij (dp_ij - delta_i)  (times 1 - (s_ij / c)^2 under a softcap),
//   dq_i = D^-0.5 sum_j ds_ij k_j,  dk_j = D^-0.5 sum_i ds_ij q_i,  dv_j = sum_i p_ij do_i,
//
// dk and dv summed over the G query heads of each kv head.  q, k, v, o, do
// and the gradients are float32, and so is the arithmetic; bfloat16 inputs
// go to csrc/flash_attention_bwd_sm90.cu, on the tensor cores.
//
// Replaces no TPU kernel: repro/kernels/flash_attention.py is forward only,
// and the reference trains through its jnp twin (models/layers.py
// _blockwise_attention), whose gradient jax.grad takes.  This kernel is
// that gradient on the card, for every float32 attention over more than
// 4096 kv positions in a training step.  Its plain version is
// kernels/ref.py::ref_flash_attention_backward.
//
// Bound: operations.  Each live (query, key) pair costs 10 * D flops: S
// recomputed (2D), dP (2D), dV, dK and dQ (2D each), against a few bytes
// of q, k, v, o, do and the gradients per row; at a long sequence that is
// far above the card's ridge point.  It runs float32 FMAs on the CUDA
// cores (67 TFLOP/s), where every instruction that is not an FMA takes an
// issue slot from one.
//
// Three launches, no atomics (two calls on one input give bit-equal
// gradients, one writer per gradient element):
//   (a) delta_kernel: delta = rowsum(do * o), one warp a row.
//   (b) dkdv_kernel: one block per (key tile of BK keys, kv head, batch).
//       K and V of its tile stay in shared memory while it walks the G
//       query heads of its kv head and, for each, the BQ-row query tiles
//       that see one of its keys (causal and window limits, with
//       q_offset).  Per tile it recomputes S = q k^T and dP = do v^T, turns
//       them into P and dS in shared memory, and accumulates dV += P^T do
//       and dK += dS^T q in registers; it writes dK and dV once.
//   (c) dq_kernel: one block per (query tile of BQ rows, query head,
//       batch): q, do, lse and delta stay in shared memory while it walks
//       the live key tiles, recomputes S, dP and dS as (b) does, and
//       accumulates dQ += dS k in registers; it writes dQ once.
// Both passes recompute S and dP: 14 D' flops executed a live pair against
// the bound's 10 D (D' = D rounded up to 64, 128 or 256 columns in the
// gradient products; the score products stop at D rounded up to 8).
//
// Design for the card.  256 threads a block, one block an SM (the
// accumulators need up to ~230 registers a thread).  Tiles (Pass): at D' =
// 128 both passes take 64 query rows by 64 keys; at D' = 64 a dK/dV block
// holds 128 keys against 64-row query tiles and a dQ block 128 rows against
// 64-key tiles, so that a thread's register tile stays 64 products wide; at
// D' = 256, 32 by 32.
// - Loads: the tiles a pass walks (q, do, lse and delta of the next query
//   tile in (b); k and v of the next key tile in (c)) come in through
//   cp.async into a two-stage ring, issued before this tile's arithmetic,
//   so they overlap it; one barrier a tile separates the stages.  16-byte
//   copies where D, the strides and the bases allow, else 4-byte copies.
//   Dead tiles are never loaded; rows past Tq or Tk are zero-filled.
// - Register tiles.  Thread (a, b), a = 4 (warp / 2) + lane / 8 and
//   b = 8 (warp % 2) + lane % 8, holds the score rows a + 16i by keys
//   b + 16j: each float4 read of q or do along D feeds 4 NJ FMAs, each of
//   k or v 4 MI (16 at D' <= 128).  In (b) it then holds keys KPT a ..
//   KPT a + KPT - 1 by the float4 columns b + 16jj of dK and dV, reading a
//   row of P and of dS as vectors and q, do as float4 (64 FMAs from 6
//   reads at D' = 128); in (c) rows RPT a .. of dQ by the same columns,
//   reading dS^T (the transpose, so a thread's rows are one vector) and k.
//   The row loops of the products step by 8, so that every swizzle below
//   is a constant of the unrolled body.  A warp spans 4 values of a and 8
//   of b, so every read is one shared memory wavefront.  Rows of q, do, k
//   and v are D' floats whose 16-byte chunks are XOR-swizzled by row & 7;
//   P and dS by (row & 3) << 1 and dS^T by key & 7, so neither their writes
//   nor their reads conflict.
// - The masks once a tile: a tile that every row of the block sees whole
//   runs no test; a tile on a mask edge tests two small integers an element
//   against bounds computed once a row.  A row with lse = -inf (it sees no
//   key) and a padding row take lse2 = +inf, so their p is exactly 0 and
//   their dq exactly 0.  The softcap is a template argument.
// - The exponential is ex2 of one FFMA: s (D^-0.5 log2 e) - lse log2 e.
//
// What bounds it (tools/profile_flash_attention.py, PERF.md): the S and dP
// loop, 8 FMAs a float4 read, in both passes; the copies are hidden and the
// masks cost little.
//
// Built with -DFLASH_PHASE_CLOCKS (tools/profile_flash_attention.py only),
// every warp of (b) and (c) adds the SM clocks it spends in each phase of
// the tile loop to flash_bwd_phase_clocks[pass]: waiting for the tile's
// copies (and the barrier), issuing the next tile's copies, the S and dP
// loop, the softmax and masks (with the P, dS stores and their barrier),
// the gradient products.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#ifdef FLASH_PHASE_CLOCKS
__device__ unsigned long long flash_bwd_phase_clocks[2][5];
#define PHASE(k)                       \
  {                                    \
    const long long now = clock64();   \
    phase_clocks[k] += now - phase_at; \
    phase_at = now;                    \
  }
#else
#define PHASE(k)
#endif

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;   // (B, Hq, Tq) contiguous
  float* delta;       // (B, Hq, Tq) contiguous, written by (a)
  float* dq;          // contiguous (B, Hq, Tq, D)
  float* dk;          // contiguous (B, Hkv, Tk, D)
  float* dv;
  int64_t Hq, Hkv, Tq, Tk, D, group;
  int64_t q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_st, do_sb, do_sh, do_st;
  int64_t window, q_offset;
  int causal, has_window, vec;
  float softcap, scale;
};

// One pass's tiles: BQ query rows by BK keys of DP columns (D rounded up to
// 64, 128 or 256).
template <int DP_, int BQ_, int BK_>
struct Pass {
  static constexpr int DP = DP_, BQ = BQ_, BK = BK_;
  static constexpr int MI = BQ / 16;    // score rows a thread
  static constexpr int NJ = BK / 16;    // score keys a thread
  static constexpr int KPT = BK / 16;   // dK, dV keys a thread
  static constexpr int RPT = BQ / 16;   // dQ rows a thread
  static constexpr int NC = DP / 64;    // gradient float4 columns a thread
  static constexpr int kRow = BQ * DP;  // floats of a q or do tile
  static constexpr int kKey = BK * DP;  // floats of a k or v tile
  static constexpr int kScore = BQ * BK;
  // (b): k, v [BK][DP]; q, do [2][BQ][DP]; p, ds [BQ][BK]; lse, delta [2][BQ]
  static constexpr size_t kSmemKV = sizeof(float) * (2 * kKey + 4 * kRow + 2 * kScore + 4 * BQ);
  // (c): q, do [BQ][DP]; k, v [2][BK][DP]; ds^T [BK][BQ]; lse, delta [BQ]
  static constexpr size_t kSmemQ = sizeof(float) * (2 * kRow + 4 * kKey + kScore + 2 * BQ);
};

// The passes at DP columns: (b)'s and (c)'s tiles
template <int DP>
struct Cfg {
  using KV = Pass<DP, DP == 256 ? 32 : 64, DP == 256 ? 32 : (DP == 64 ? 128 : 64)>;
  using Q = Pass<DP, DP == 256 ? 32 : (DP == 64 ? 128 : 64), DP == 256 ? 32 : 64>;
  static_assert(KV::kSmemKV <= 232448 && Q::kSmemQ <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x, one MUFU instruction (relative error ~2^-22; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Offsets in floats.  A row of q, do, k or v: DP floats, chunk c at
// c ^ (row & 7).  P and dS [BQ][BK]: chunk c of row r at c ^ ((r & 3) << 1).
// dS^T [BK][BQ]: chunk c of key k at c ^ (k & 7).
template <int DP>
__device__ __forceinline__ int row_at(int r, int chunk) {
  return r * DP + ((chunk ^ (r & 7)) << 2);
}
template <int BK>
__device__ __forceinline__ int score_at(int r, int key) {
  return r * BK + ((((key >> 2) ^ ((r & 3) << 1))) << 2) + (key & 3);
}
template <int BQ>
__device__ __forceinline__ int score_t_at(int key, int r) {
  return key * BQ + ((((r >> 2) ^ (key & 7))) << 2) + (r & 3);
}

// N consecutive floats from index `first` of a swizzled row at `row` whose
// chunks sit at chunk ^ swz (float4s, or a float2 for N = 2)
template <int N>
__device__ __forceinline__ void load_vec(const float* row, int first, int swz, float (&out)[N]) {
  if constexpr (N == 2) {
    const float2 x =
        *reinterpret_cast<const float2*>(row + (((first >> 2) ^ swz) << 2) + (first & 3));
    out[0] = x.x;
    out[1] = x.y;
  } else {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(row + ((((first >> 2) + c) ^ swz) << 2));
      out[4 * c] = x.x;
      out[4 * c + 1] = x.y;
      out[4 * c + 2] = x.z;
      out[4 * c + 3] = x.w;
    }
  }
}

// Copy rows [0, ROWS) of a (rows, D) view into swizzled shared rows of DP
// floats, row r from src + r * rs for r < n and zeros past n.  Columns past
// D are not written (zero from the start).  16-byte copies take a fixed
// chunk a thread, its source pointer stepping a row stride at a time.
template <int DP, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, int n, const float* src, int64_t rs, int D,
                                          bool vec) {
  constexpr int kC = DP / 4;               // chunks a row
  constexpr int kStep = kThreads / kC;     // rows a pass of the block
  static_assert(ROWS % kStep == 0, "whole passes");
  const int tid = threadIdx.x;
  if (vec) {
    const int c = tid % kC, r0 = tid / kC;
    if (4 * c >= D) return;
    const float* from = src + r0 * rs + 4 * c;
    const int64_t step = kStep * rs;
#pragma unroll
    for (int m = 0; m < ROWS / kStep; ++m, from += step) {
      const int r = r0 + kStep * m;
      cp_async16(dst + row_at<DP>(r, c), r < n ? from : src, r < n ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      cp_async4(dst + row_at<DP>(r, c >> 2) + (c & 3), r < n ? src + r * rs + c : src,
                r < n ? 4 : 0);
    }
  }
}

// lse and delta of rows [0, BQ) from row q0 of head row `bh`: zeros past n
template <int BQ>
__device__ __forceinline__ void copy_stats(float* lse_s, float* delta_s, const Params& p,
                                           int64_t bh, int64_t q0, int n) {
  const int tid = threadIdx.x;
  if (tid < 2 * BQ) {
    const int r = tid % BQ;
    const float* src = (tid < BQ ? p.lse : p.delta) + bh * p.Tq + q0;
    cp_async4((tid < BQ ? lse_s : delta_s) + r, r < n ? src + r : src, r < n ? 4 : 0);
  }
}

// Does every row of query tile q0 (n rows) see every key of key tile kt
// (BK keys)?  Then the tile runs no mask test.
template <int BK>
__device__ __forceinline__ bool tile_interior(const Params& p, int64_t q0, int n, int64_t kt) {
  const int64_t q_first = p.q_offset + q0, q_last = p.q_offset + q0 + n - 1;
  return kt + BK <= p.Tk && (!p.causal || kt + BK - 1 <= q_first) &&
         (!p.has_window || kt > q_last - p.window);
}

// The score tile of BQ query rows (q, do at qs, dos) by BK keys (k, v at
// ks, vs): thread (a, b) computes s and dp of rows a + 16i, keys b + 16j,
// over d4 float4 chunks of D (d4 even; chunks past D are zero).  Rows
// a + 16i share a & 7, keys b + 16j share b & 7, so a chunk's swizzled
// offset is one XOR for all of a thread's rows and one for its keys.
template <class T>
__device__ __forceinline__ void score_tile(const float* qs, const float* dos, const float* ks,
                                           const float* vs, int d4, int a, int b,
                                           float (&s)[T::MI][T::NJ], float (&dp)[T::MI][T::NJ]) {
  constexpr int DP = T::DP;
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) s[i][j] = dp[i][j] = 0.0f;
  const float* q_a = qs + a * DP;
  const float* g_a = dos + a * DP;
  const float* k_b = ks + b * DP;
  const float* v_b = vs + b * DP;
  const int xa = a & 7, xb = b & 7;
#pragma unroll 2
  for (int ch = 0; ch < d4; ch += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oa = ((ch + h) ^ xa) << 2, ob = ((ch + h) ^ xb) << 2;
      float4 qa[T::MI], ga[T::MI];
#pragma unroll
      for (int i = 0; i < T::MI; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(q_a + 16 * i * DP + oa);
        ga[i] = *reinterpret_cast<const float4*>(g_a + 16 * i * DP + oa);
      }
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(k_b + 16 * j * DP + ob);
        const float4 vv = *reinterpret_cast<const float4*>(v_b + 16 * j * DP + ob);
#pragma unroll
        for (int i = 0; i < T::MI; ++i) {
          s[i][j] = fmaf(qa[i].x, kk.x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kk.y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kk.z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kk.w, s[i][j]);
          dp[i][j] = fmaf(ga[i].x, vv.x, dp[i][j]);
          dp[i][j] = fmaf(ga[i].y, vv.y, dp[i][j]);
          dp[i][j] = fmaf(ga[i].z, vv.z, dp[i][j]);
          dp[i][j] = fmaf(ga[i].w, vv.w, dp[i][j]);
        }
      }
    }
  }
}

// s and dp of the tile (q0, kt) into p and ds in place: rows a + 16i, keys
// b + 16j.  lse_s, delta_s: the tile's rows' statistics, n of them live.
// Masks only when the tile is not interior.
template <class T, bool CAP>
__device__ __forceinline__ void softmax_tile(const Params& p, const float* lse_s,
                                             const float* delta_s, int64_t q0, int n, int64_t kt,
                                             int a, int b, float (&s)[T::MI][T::NJ],
                                             float (&dp)[T::MI][T::NJ]) {
  const bool edge = !tile_interior<T::BK>(p, q0, n, kt);
  const float c = p.scale * kLog2e;
  const float cap_in = p.scale / p.softcap;
#pragma unroll
  for (int i = 0; i < T::MI; ++i) {
    const int r = a + 16 * i;
    const float lse = lse_s[r];
    // +inf: p = 0 on a row that sees no key and on a padding row
    const float lse2 = r < n && lse != -CUDART_INF_F ? lse * kLog2e : CUDART_INF_F;
    const float delta = delta_s[r];
    int lo = 0, hi = T::BK - 1;   // this row's live keys of the tile, relative to kt
    if (edge) {
      const int64_t qpos = p.q_offset + q0 + r;
      int64_t h = p.Tk - 1 - kt;
      if (p.causal && qpos - kt < h) h = qpos - kt;
      const int64_t l = p.has_window ? qpos - p.window + 1 - kt : 0;
      hi = h < -1 ? -1 : (h > T::BK ? T::BK : static_cast<int>(h));
      lo = l < 0 ? 0 : (l > T::BK ? T::BK : static_cast<int>(l));
    }
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
      const int kc = b + 16 * j;
      float pr, ds;
      if (CAP) {
        const float t = tanhf(s[i][j] * cap_in);
        pr = ex2(fmaf(p.softcap * t, kLog2e, -lse2));
        ds = pr * (dp[i][j] - delta) * (1.0f - t * t);
      } else {
        pr = ex2(fmaf(s[i][j], c, -lse2));
        ds = pr * (dp[i][j] - delta);
      }
      if (edge && (kc < lo || kc > hi)) pr = ds = 0.0f;
      s[i][j] = pr;
      dp[i][j] = ds;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
delta_kernel(const Params p, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t i = row % p.Tq, bh = row / p.Tq, h = bh % p.Hq, b = bh / p.Hq;
  const float* o = p.o + b * p.o_sb + h * p.o_sh + i * p.o_st;
  const float* g = p.dout + b * p.do_sb + h * p.do_sh + i * p.do_st;
  float acc = 0.0f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(o[d], g[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// the float4 columns b + 16jj (jj < NC) of a thread's gradient rows, as
// floats 4 (b + 16jj) .. + 3, stored to the row at `out` (D columns)
template <int NC>
__device__ __forceinline__ void store_row(float* out, const float (&x)[4 * NC], float scale,
                                          int b, int D) {
#pragma unroll
  for (int jj = 0; jj < NC; ++jj) {
    const int col = 4 * (b + 16 * jj);
    if (col >= D) continue;
    if ((D & 3) == 0) {
      *reinterpret_cast<float4*>(out + col) =
          make_float4(x[4 * jj] * scale, x[4 * jj + 1] * scale, x[4 * jj + 2] * scale,
                      x[4 * jj + 3] * scale);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < D) out[col + e] = x[4 * jj + e] * scale;
    }
  }
}

template <int DP, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const Params p) {
  using T = typename Cfg<DP>::KV;
  constexpr int BK = T::BK, BQ = T::BQ, KPT = T::KPT, NC = T::NC;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + T::kKey;
  float* qs = vs + T::kKey;           // [2][BQ][DP]
  float* dos = qs + 2 * T::kRow;      // [2][BQ][DP]
  float* ps = dos + 2 * T::kRow;      // [BQ][BK]
  float* dss = ps + T::kScore;        // [BQ][BK]
  float* lse_s = dss + T::kScore;     // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;    // [2][BQ]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a = 4 * (warp >> 1) + (lane >> 3), b = 8 * (warp & 1) + (lane & 7);
  const int D = static_cast<int>(p.D);
  const int d4 = ((D + 3) >> 2) + (((D + 3) >> 2) & 1);   // float4 chunks, even
  const int64_t kt = static_cast<int64_t>(blockIdx.x) * BK;
  const int64_t hk = blockIdx.y, bz = blockIdx.z;
  const int nk = static_cast<int>(p.Tk - kt < BK ? p.Tk - kt : BK);

  for (int i = tid; i < static_cast<int>(T::kSmemKV / 16); i += kThreads)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  // the query rows that see one of keys [kt, kt + nk), in whole tiles
  int64_t i_lo = 0, i_hi = p.Tq;
  if (p.causal && kt - p.q_offset > i_lo) i_lo = kt - p.q_offset;
  if (p.has_window && kt + nk - 1 + p.window - p.q_offset < i_hi)
    i_hi = kt + nk - 1 + p.window - p.q_offset;
  i_lo = i_lo / BQ * BQ;
  const int64_t n_qt = i_hi > i_lo ? (i_hi - i_lo + BQ - 1) / BQ : 0;
  const int64_t tiles = p.group * n_qt;   // (head, query tile) pairs, head-major

  auto load_tile = [&](int64_t h, int64_t q0, int stage) {
    const int n = static_cast<int>(p.Tq - q0 < BQ ? p.Tq - q0 : BQ);
    copy_rows<DP, BQ>(qs + stage * T::kRow, n, p.q + bz * p.q_sb + h * p.q_sh + q0 * p.q_st,
                      p.q_st, D, p.vec);
    copy_rows<DP, BQ>(dos + stage * T::kRow, n,
                      p.dout + bz * p.do_sb + h * p.do_sh + q0 * p.do_st, p.do_st, D, p.vec);
    copy_stats<BQ>(lse_s + stage * BQ, delta_s + stage * BQ, p, bz * p.Hq + h, q0, n);
  };
  copy_rows<DP, BK>(ks, nk, p.k + bz * p.k_sb + hk * p.k_sh + kt * p.k_st, p.k_st, D, p.vec);
  copy_rows<DP, BK>(vs, nk, p.v + bz * p.v_sb + hk * p.v_sh + kt * p.v_st, p.v_st, D, p.vec);
  if (tiles > 0) load_tile(hk * p.group, i_lo, 0);
  cp_async_commit();

  float dk[KPT][4 * NC], dv[KPT][4 * NC];
#pragma unroll
  for (int u = 0; u < KPT; ++u)
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) dk[u][e] = dv[u][e] = 0.0f;

#ifdef FLASH_PHASE_CLOCKS
  long long phase_clocks[5] = {0, 0, 0, 0, 0};
  long long phase_at = clock64();
#endif
  int stage = 0;
  int64_t h = hk * p.group, q0 = i_lo;   // this tile's head and first row
  for (int64_t t = 0; t < tiles; ++t, stage ^= 1) {
    const int n = static_cast<int>(p.Tq - q0 < BQ ? p.Tq - q0 : BQ);
    // the next tile: the next query tile of this head, or the first of the next head
    const bool head_ends = q0 + BQ >= i_lo + n_qt * BQ;
    const int64_t h_next = head_ends ? h + 1 : h, q0_next = head_ends ? i_lo : q0 + BQ;
    cp_async_wait_all();
    __syncthreads();   // tile t has landed for all; every thread is done with tile t - 1
    PHASE(0)
    if (t + 1 < tiles) load_tile(h_next, q0_next, stage ^ 1);
    cp_async_commit();
    PHASE(1)
    const float* qst = qs + stage * T::kRow;
    const float* dost = dos + stage * T::kRow;
    float s[T::MI][T::NJ], dp[T::MI][T::NJ];
    score_tile<T>(qst, dost, ks, vs, d4, a, b, s, dp);
    PHASE(2)
    softmax_tile<T, CAP>(p, lse_s + stage * BQ, delta_s + stage * BQ, q0, n, kt, a, b, s, dp);
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) {
        ps[score_at<BK>(a + 16 * i, b + 16 * j)] = s[i][j];
        dss[score_at<BK>(a + 16 * i, b + 16 * j)] = dp[i][j];
      }
    __syncthreads();   // P and dS of the tile are whole
    PHASE(3)
    // dV += P^T do, dK += dS^T q: keys KPT a + u, columns 4 (b + 16jj) + e;
    // rows r8 + k, k < 8, so that r & 7 = k
#pragma unroll 1
    for (int r8 = 0; r8 < BQ; r8 += 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = r8 + k;
        float pv[KPT], dsv[KPT];
        load_vec<KPT>(ps + r * BK, KPT * a, (k & 3) << 1, pv);
        load_vec<KPT>(dss + r * BK, KPT * a, (k & 3) << 1, dsv);
        float4 gq[NC], gd[NC];
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) {
          const int off = r * DP + ((((b ^ k) + 16 * jj)) << 2);
          gq[jj] = *reinterpret_cast<const float4*>(qst + off);
          gd[jj] = *reinterpret_cast<const float4*>(dost + off);
        }
#pragma unroll
        for (int u = 0; u < KPT; ++u)
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) {
            dv[u][4 * jj + 0] = fmaf(pv[u], gd[jj].x, dv[u][4 * jj + 0]);
            dv[u][4 * jj + 1] = fmaf(pv[u], gd[jj].y, dv[u][4 * jj + 1]);
            dv[u][4 * jj + 2] = fmaf(pv[u], gd[jj].z, dv[u][4 * jj + 2]);
            dv[u][4 * jj + 3] = fmaf(pv[u], gd[jj].w, dv[u][4 * jj + 3]);
            dk[u][4 * jj + 0] = fmaf(dsv[u], gq[jj].x, dk[u][4 * jj + 0]);
            dk[u][4 * jj + 1] = fmaf(dsv[u], gq[jj].y, dk[u][4 * jj + 1]);
            dk[u][4 * jj + 2] = fmaf(dsv[u], gq[jj].z, dk[u][4 * jj + 2]);
            dk[u][4 * jj + 3] = fmaf(dsv[u], gq[jj].w, dk[u][4 * jj + 3]);
          }
      }
    }
    PHASE(4)
    h = h_next;
    q0 = q0_next;
  }
  cp_async_wait_all();   // no copy outlives the block
#ifdef FLASH_PHASE_CLOCKS
  if (lane == 0)
    for (int k = 0; k < 5; ++k)
      atomicAdd(&flash_bwd_phase_clocks[0][k], static_cast<unsigned long long>(phase_clocks[k]));
#endif

  float* dkg = p.dk + ((bz * p.Hkv + hk) * p.Tk + kt) * p.D;
  float* dvg = p.dv + ((bz * p.Hkv + hk) * p.Tk + kt) * p.D;
#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    const int r = KPT * a + u;
    if (r >= nk) continue;
    store_row<NC>(dkg + r * p.D, dk[u], p.scale, b, D);
    store_row<NC>(dvg + r * p.D, dv[u], 1.0f, b, D);
  }
}

template <int DP, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const Params p) {
  using T = typename Cfg<DP>::Q;
  constexpr int BK = T::BK, BQ = T::BQ, RPT = T::RPT, NC = T::NC;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + T::kRow;
  float* ks = dos + T::kRow;          // [2][BK][DP]
  float* vs = ks + 2 * T::kKey;       // [2][BK][DP]
  float* dst = vs + 2 * T::kKey;      // [BK][BQ], dS transposed
  float* lse_s = dst + T::kScore;     // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a = 4 * (warp >> 1) + (lane >> 3), b = 8 * (warp & 1) + (lane & 7);
  const int D = static_cast<int>(p.D);
  const int d4 = ((D + 3) >> 2) + (((D + 3) >> 2) & 1);
  // the last query tiles see the most keys: start them first
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BQ;
  const int64_t h = blockIdx.y, bz = blockIdx.z, hk = h / p.group;
  const int nq = static_cast<int>(p.Tq - q0 < BQ ? p.Tq - q0 : BQ);

  for (int i = tid; i < static_cast<int>(T::kSmemQ / 16); i += kThreads)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  // the key tiles that any row of this block can see
  const int64_t q_first = p.q_offset + q0, q_last = p.q_offset + q0 + nq - 1;
  int64_t k_end = p.Tk;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0) k_begin = q_first - p.window + 1;
  k_begin = k_begin / BK * BK;

  const float* kg = p.k + bz * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + bz * p.v_sb + hk * p.v_sh;
  auto load_kv = [&](int64_t kt, int stage) {
    const int n = static_cast<int>(p.Tk - kt < BK ? p.Tk - kt : BK);
    copy_rows<DP, BK>(ks + stage * T::kKey, n, kg + kt * p.k_st, p.k_st, D, p.vec);
    copy_rows<DP, BK>(vs + stage * T::kKey, n, vg + kt * p.v_st, p.v_st, D, p.vec);
  };
  copy_rows<DP, BQ>(qs, nq, p.q + bz * p.q_sb + h * p.q_sh + q0 * p.q_st, p.q_st, D, p.vec);
  copy_rows<DP, BQ>(dos, nq, p.dout + bz * p.do_sb + h * p.do_sh + q0 * p.do_st, p.do_st, D,
                    p.vec);
  copy_stats<BQ>(lse_s, delta_s, p, bz * p.Hq + h, q0, nq);
  if (k_begin < k_end) load_kv(k_begin, 0);
  cp_async_commit();

  float dq[RPT][4 * NC];
#pragma unroll
  for (int u = 0; u < RPT; ++u)
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) dq[u][e] = 0.0f;

#ifdef FLASH_PHASE_CLOCKS
  long long phase_clocks[5] = {0, 0, 0, 0, 0};
  long long phase_at = clock64();
#endif
  int stage = 0;
  for (int64_t kt = k_begin; kt < k_end; kt += BK, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // tile kt has landed for all; every thread is done with tile kt - BK
    PHASE(0)
    if (kt + BK < k_end) load_kv(kt + BK, stage ^ 1);
    cp_async_commit();
    PHASE(1)
    const float* kst = ks + stage * T::kKey;
    float s[T::MI][T::NJ], dp[T::MI][T::NJ];
    score_tile<T>(qs, dos, kst, vs + stage * T::kKey, d4, a, b, s, dp);
    PHASE(2)
    softmax_tile<T, CAP>(p, lse_s, delta_s, q0, nq, kt, a, b, s, dp);
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) dst[score_t_at<BQ>(b + 16 * j, a + 16 * i)] = dp[i][j];
    __syncthreads();   // dS of the tile is whole
    PHASE(3)
    // dQ += dS k: rows RPT a + u, columns 4 (b + 16jj) + e; keys c8 + k,
    // k < 8, so that c & 7 = k
#pragma unroll 1
    for (int c8 = 0; c8 < BK; c8 += 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = c8 + k;
        float dsv[RPT];
        load_vec<RPT>(dst + c * BQ, RPT * a, k, dsv);
        float4 kv[NC];
#pragma unroll
        for (int jj = 0; jj < NC; ++jj)
          kv[jj] = *reinterpret_cast<const float4*>(kst + c * DP + (((b ^ k) + 16 * jj) << 2));
#pragma unroll
        for (int u = 0; u < RPT; ++u)
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) {
            dq[u][4 * jj + 0] = fmaf(dsv[u], kv[jj].x, dq[u][4 * jj + 0]);
            dq[u][4 * jj + 1] = fmaf(dsv[u], kv[jj].y, dq[u][4 * jj + 1]);
            dq[u][4 * jj + 2] = fmaf(dsv[u], kv[jj].z, dq[u][4 * jj + 2]);
            dq[u][4 * jj + 3] = fmaf(dsv[u], kv[jj].w, dq[u][4 * jj + 3]);
          }
      }
    }
    PHASE(4)
  }
  cp_async_wait_all();
#ifdef FLASH_PHASE_CLOCKS
  if (lane == 0)
    for (int k = 0; k < 5; ++k)
      atomicAdd(&flash_bwd_phase_clocks[1][k], static_cast<unsigned long long>(phase_clocks[k]));
#endif

  float* dqg = p.dq + ((bz * p.Hq + h) * p.Tq + q0) * p.D;
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = RPT * a + u;
    if (r < nq) store_row<NC>(dqg + r * p.D, dq[u], p.scale, b, D);
  }
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DP, bool CAP>
int launch(const Params& p, int64_t B, cudaStream_t stream) {
  using KV = typename Cfg<DP>::KV;
  using Q = typename Cfg<DP>::Q;
  cudaError_t err = configure(dkdv_kernel<DP, CAP>, KV::kSmemKV);
  if (err == cudaSuccess) err = configure(dq_kernel<DP, CAP>, Q::kSmemQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = B * p.Hq * p.Tq;
  const int64_t warps = kThreads / 32;
  delta_kernel<<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0, stream>>>(p,
                                                                                          rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.Tk > 0) {
    const dim3 grid_kv(static_cast<unsigned>((p.Tk + KV::BK - 1) / KV::BK),
                       static_cast<unsigned>(p.Hkv), static_cast<unsigned>(B));
    dkdv_kernel<DP, CAP><<<grid_kv, kThreads, KV::kSmemKV, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_q(static_cast<unsigned>((p.Tq + Q::BQ - 1) / Q::BQ),
                    static_cast<unsigned>(p.Hq), static_cast<unsigned>(B));
  dq_kernel<DP, CAP><<<grid_q, kThreads, Q::kSmemQ, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dispatch(const Params& p, bool softcap, int64_t B, cudaStream_t stream) {
  return softcap ? launch<DP, true>(p, B, stream) : launch<DP, false>(p, B, stream);
}

int head_pad(int64_t D) { return D <= 64 ? 64 : (D <= 128 ? 128 : 256); }

template <int DP>
void blocks(int64_t* out) {
  out[0] = DP;
  out[1] = Cfg<DP>::KV::BK;
  out[2] = Cfg<DP>::KV::BQ;
  out[3] = Cfg<DP>::Q::BQ;
  out[4] = Cfg<DP>::Q::BK;
  out[5] = kThreads;
}

}  // namespace
// q: (B, Hq, Tq, D), k and v: (B, Hkv, Tk, D), o and dout: (B, Hq, Tq, D),
// each with unit stride in D and the given strides (in elements) in its
// first three dimensions, all float32; lse: contiguous float32
// (B, Hq, Tq); delta: contiguous float32 (B, Hq, Tq) scratch; dq, dk, dv:
// contiguous float32, of q's, k's and v's shapes.  1 <= D <= 256, Hq a
// multiple of Hkv.  Launches three kernels on `stream` (two when Tk == 0:
// dk and dv are empty); returns the first cudaError_t (0 on success).  The
// caller checks shapes, types and devices.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int64_t B, int64_t Hq,
    int64_t Hkv, int64_t Tq, int64_t Tk, int64_t D, int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st, int64_t do_sb, int64_t do_sh, int64_t do_st,
    int causal, int has_window, int64_t window, int64_t q_offset, int has_softcap,
    float softcap, float scale, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || Hkv > 65535 ||
      B > 65535 || Tq > 0x7fffffff || Tk > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk; p.D = D; p.group = Hq / Hkv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_st = do_st;
  p.window = window; p.q_offset = q_offset;
  p.causal = causal; p.has_window = has_window;
  p.softcap = has_softcap ? softcap : 1.0f; p.scale = scale;
  // 16-byte copies need D, every stride and every base on 16-byte boundaries
  const int64_t strides =
      q_sb | q_sh | q_st | k_sb | k_sh | k_st | v_sb | v_sh | v_st | do_sb | do_sh | do_st | D;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  p.vec = (strides & 3) == 0 && (bases & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cap = has_softcap != 0;
  switch (head_pad(D)) {
    case 64: return dispatch<64>(p, cap, B, s);
    case 128: return dispatch<128>(p, cap, B, s);
    default: return dispatch<256>(p, cap, B, s);
  }
}

// The blocks the kernels run at head width D (1 <= D <= 256), which the
// wrapper mirrors (flash_attention_bwd.py::block_config): out = {columns
// held, keys a dK/dV block, query rows of its tiles, query rows a dQ block,
// keys of its tiles, threads a block}; cudaErrorInvalidValue for another D.
extern "C" int flash_attention_bwd_blocks(int64_t D, int64_t* out) {
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_pad(D)) {
    case 64: blocks<64>(out); break;
    case 128: blocks<128>(out); break;
    default: blocks<256>(out);
  }
  return 0;
}

#ifdef FLASH_PHASE_CLOCKS
// copies the two passes' five phase sums out ((b) then (c)), or zeroes
// them when `out` is null; returns the cudaError_t
extern "C" int flash_bwd_phase_clocks_read(unsigned long long* out) {
  if (out == nullptr) {
    const unsigned long long zero[2][5] = {};
    return static_cast<int>(cudaMemcpyToSymbol(flash_bwd_phase_clocks, zero, sizeof(zero)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, flash_bwd_phase_clocks, sizeof(flash_bwd_phase_clocks)));
}
#endif
