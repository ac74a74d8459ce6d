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
// that gradient on the card, for every attention over more than 4096 kv
// positions in a training step.  Its plain version is
// kernels/ref.py::ref_flash_attention_backward.
//
// Bound: operations.  Each live (query, key) pair costs 10 * D flops here:
// S recomputed (2D), dP (2D), dV, dK and dQ (2D each), against a few bytes
// of q, k, v, o, do and the gradients per row; at a long sequence that is
// far above the card's ridge point.  It runs float32 FMAs on the CUDA
// cores (67 TFLOP/s).
//
// Design (FlashAttention-2's backward, kept simple, with no atomics, so
// that two calls on one input give bit-equal gradients):
//   (a) delta_kernel: delta = rowsum(do * o), one warp a row, float32.
//   (b) dkdv_kernel: one block per (key tile of BK keys, kv head, batch).
//       K and V of its tile stay in shared memory; it walks the G query
//       heads of its kv head and, for each, the BQ-row query tiles that
//       see one of its keys (the causal and window limits, with
//       q_offset), loading q, do, lse and delta of each.  From them it
//       recomputes S, P = exp(S - lse) and dP = do V^T, puts P and dS in
//       shared memory, and accumulates dV += P^T do and dK += dS^T q in
//       registers; it writes dK and dV once.
//   (c) dq_kernel: one block per (query tile of BQ rows, query head,
//       batch): q, do, lse and delta stay in shared memory while it walks
//       the live key tiles, recomputes S, P, dP and dS as (b) does, and
//       accumulates dQ += dS K in registers; it writes dQ once.
// 256 threads a block as 16 x 16: for the score tile, thread (ty, tx)
// holds rows ty + 16i and keys tx + 16j; for the gradient tiles, rows
// ty + 16i and the float4 columns 4 (tx + 16jj).  Shared rows are padded by
// one float4, so that sixteen lanes reading sixteen rows hit distinct
// banks; the score tiles' rows are padded by 16 floats, so that the two
// row groups of a warp write distinct banks.  Columns past D are zero in
// shared memory and never stored; rows past Tq or Tk are zero and masked.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, Hq, Tq) contiguous
  float* delta;       // (B, Hq, Tq) contiguous, written by (a)
  void* dq;           // contiguous (B, Hq, Tq, D)
  void* dk;           // contiguous (B, Hkv, Tk, D)
  void* dv;
  int64_t Hq, Hkv, Tq, Tk, D, group;
  int64_t q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_st, do_sb, do_sh, do_st;
  int64_t window, q_offset;
  int causal, has_window, has_softcap;
  float softcap, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// DP: columns held in shared memory (D rounded up to 64, 128 or 256); BK
// keys and BQ query rows a tile.
template <int DP, int BK, int BQ>
struct Layout {
  static constexpr int kS = DP + 4;     // row stride of q, do, k, v tiles (floats)
  static constexpr int kSP = BK + 16;   // row stride of the P and dS tiles
  static constexpr int kMI = BQ / 16;   // score rows a thread
  static constexpr int kNJ = BK / 16;   // score keys a thread
  static constexpr int kNC = DP / 64;   // gradient float4 columns a thread
  static constexpr int kRow = BQ * kS;
  static constexpr int kKey = BK * kS;
  static constexpr int kTile = BQ * kSP;
  // q, do [BQ][kS]; k, v [BK][kS]; p, ds [BQ][kSP]; lse, delta [BQ]
  static constexpr size_t kSmem = sizeof(float) * (2 * kRow + 2 * kKey + 2 * kTile + 2 * BQ);
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// rows [0, n) of a (rows, D) view with row stride `rs` into shared rows of
// `stride` floats, as float32; rows [n, rows) as zeros.  Columns past D are
// left alone (zero from the start).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, int rows, const T* src,
                                          int64_t rs, int n, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[r * stride + c] = r < n ? to_f(src[r * rs + c]) : 0.0f;
  }
}

__device__ __forceinline__ bool key_live(const Params& p, int64_t qpos, int64_t kpos) {
  return kpos < p.Tk && (!p.causal || kpos <= qpos) && (!p.has_window || kpos > qpos - p.window);
}

// The score tile of BQ query rows by BK keys, from q, do, k and v in
// shared memory: P at p_s and dS at ds_s (unscaled: dq and dk take D^-0.5
// at the end).  Rows at or past Tq, keys at or past Tk, masked pairs and
// rows with lse = -inf give 0.
template <int DP, int BK, int BQ>
__device__ __forceinline__ void score_tile(const Params& p, const float* qs, const float* dos,
                                           const float* ks, const float* vs, const float* lse_s,
                                           const float* delta_s, float* p_s, float* ds_s,
                                           int64_t q0, int64_t kt) {
  using L = Layout<DP, BK, BQ>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[L::kMI][L::kNJ], dp[L::kMI][L::kNJ];
#pragma unroll
  for (int i = 0; i < L::kMI; ++i)
#pragma unroll
    for (int j = 0; j < L::kNJ; ++j) s[i][j] = dp[i][j] = 0.0f;
  const int d4 = (static_cast<int>(p.D) + 3) >> 2;
  for (int c = 0; c < d4; ++c) {
    float4 a[L::kMI], g[L::kMI];
#pragma unroll
    for (int i = 0; i < L::kMI; ++i) {
      a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * L::kS + 4 * c);
      g[i] = *reinterpret_cast<const float4*>(dos + (ty + 16 * i) * L::kS + 4 * c);
    }
#pragma unroll
    for (int j = 0; j < L::kNJ; ++j) {
      const float4 kk = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * L::kS + 4 * c);
      const float4 vv = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * L::kS + 4 * c);
#pragma unroll
      for (int i = 0; i < L::kMI; ++i) {
        s[i][j] = fmaf(a[i].x, kk.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, kk.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, kk.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, kk.w, s[i][j]);
        dp[i][j] = fmaf(g[i].x, vv.x, dp[i][j]);
        dp[i][j] = fmaf(g[i].y, vv.y, dp[i][j]);
        dp[i][j] = fmaf(g[i].z, vv.z, dp[i][j]);
        dp[i][j] = fmaf(g[i].w, vv.w, dp[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L::kMI; ++i) {
    const int r = ty + 16 * i;
    const int64_t qi = q0 + r;
    const float lse2 = lse_s[r] * kLog2e;
    const bool row_live = qi < p.Tq && lse_s[r] != -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < L::kNJ; ++j) {
      const int kc = tx + 16 * j;
      float pr = 0.0f, ds = 0.0f;
      if (row_live && key_live(p, p.q_offset + qi, kt + kc)) {
        float x = s[i][j] * p.scale;
        float dcap = 1.0f;
        if (p.has_softcap) {
          const float t = tanhf(x / p.softcap);
          x = p.softcap * t;
          dcap = 1.0f - t * t;
        }
        pr = exp2f(fmaf(x, kLog2e, -lse2));
        ds = pr * (dp[i][j] - delta_s[r]) * dcap;
      }
      p_s[r * L::kSP + kc] = pr;
      ds_s[r * L::kSP + kc] = ds;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const Params p, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t i = row % p.Tq, bh = row / p.Tq, h = bh % p.Hq, b = bh / p.Hq;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + i * p.o_st;
  const T* g = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + i * p.do_st;
  float acc = 0.0f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(to_f(o[d]), to_f(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

template <typename T, int DP, int BK, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const Params p) {
  using L = Layout<DP, BK, BQ>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + L::kRow;
  float* ks = dos + L::kRow;
  float* vs = ks + L::kKey;
  float* p_s = vs + L::kKey;
  float* ds_s = p_s + L::kTile;
  float* lse_s = ds_s + L::kTile;
  float* delta_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = static_cast<int>(p.D);
  const int64_t kt = static_cast<int64_t>(blockIdx.x) * BK;
  const int64_t hk = blockIdx.y, b = blockIdx.z;

  for (int i = tid; i < static_cast<int>(L::kSmem / 16); i += kThreads)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const int nk = static_cast<int>(p.Tk - kt < BK ? p.Tk - kt : BK);
  load_rows(ks, L::kS, BK, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + kt * p.k_st,
            p.k_st, nk, D);
  load_rows(vs, L::kS, BK, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + kt * p.v_st,
            p.v_st, nk, D);

  // the query rows that see one of keys [kt, kt + nk)
  int64_t i_lo = 0, i_hi = p.Tq;
  if (p.causal && kt - p.q_offset > i_lo) i_lo = kt - p.q_offset;
  if (p.has_window && kt + nk - 1 + p.window - p.q_offset < i_hi)
    i_hi = kt + nk - 1 + p.window - p.q_offset;
  i_lo = i_lo / BQ * BQ;

  float dk[L::kNJ][L::kNC][4], dv[L::kNJ][L::kNC][4];
#pragma unroll
  for (int i = 0; i < L::kNJ; ++i)
#pragma unroll
    for (int jj = 0; jj < L::kNC; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][jj][e] = dv[i][jj][e] = 0.0f;

  for (int64_t g = 0; g < p.group; ++g) {
    const int64_t h = hk * p.group + g;
    const float* lse_h = p.lse + (b * p.Hq + h) * p.Tq;
    const float* delta_h = p.delta + (b * p.Hq + h) * p.Tq;
    for (int64_t q0 = i_lo; q0 < i_hi; q0 += BQ) {
      const int nq = static_cast<int>(p.Tq - q0 < BQ ? p.Tq - q0 : BQ);
      __syncthreads();   // every thread is done with the last tile's q, do, p and ds
      load_rows(qs, L::kS, BQ,
                static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_st, p.q_st, nq, D);
      load_rows(dos, L::kS, BQ,
                static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + q0 * p.do_st,
                p.do_st, nq, D);
      for (int r = tid; r < BQ; r += kThreads) {
        lse_s[r] = r < nq ? lse_h[q0 + r] : -CUDART_INF_F;
        delta_s[r] = r < nq ? delta_h[q0 + r] : 0.0f;
      }
      __syncthreads();
      score_tile<DP, BK, BQ>(p, qs, dos, ks, vs, lse_s, delta_s, p_s, ds_s, q0, kt);
      __syncthreads();
      // dV += P^T do, dK += dS^T q: keys ty + 16i, columns 4 (tx + 16jj)
      for (int r = 0; r < nq; ++r) {
        float pv[L::kNJ], dsv[L::kNJ];
        float4 gv[L::kNC], qv[L::kNC];
#pragma unroll
        for (int i = 0; i < L::kNJ; ++i) {
          pv[i] = p_s[r * L::kSP + ty + 16 * i];
          dsv[i] = ds_s[r * L::kSP + ty + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < L::kNC; ++jj) {
          gv[jj] = *reinterpret_cast<const float4*>(dos + r * L::kS + 4 * (tx + 16 * jj));
          qv[jj] = *reinterpret_cast<const float4*>(qs + r * L::kS + 4 * (tx + 16 * jj));
        }
#pragma unroll
        for (int i = 0; i < L::kNJ; ++i)
#pragma unroll
          for (int jj = 0; jj < L::kNC; ++jj) {
            dv[i][jj][0] = fmaf(pv[i], gv[jj].x, dv[i][jj][0]);
            dv[i][jj][1] = fmaf(pv[i], gv[jj].y, dv[i][jj][1]);
            dv[i][jj][2] = fmaf(pv[i], gv[jj].z, dv[i][jj][2]);
            dv[i][jj][3] = fmaf(pv[i], gv[jj].w, dv[i][jj][3]);
            dk[i][jj][0] = fmaf(dsv[i], qv[jj].x, dk[i][jj][0]);
            dk[i][jj][1] = fmaf(dsv[i], qv[jj].y, dk[i][jj][1]);
            dk[i][jj][2] = fmaf(dsv[i], qv[jj].z, dk[i][jj][2]);
            dk[i][jj][3] = fmaf(dsv[i], qv[jj].w, dk[i][jj][3]);
          }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + ((b * p.Hkv + hk) * p.Tk + kt) * p.D;
  T* dvg = static_cast<T*>(p.dv) + ((b * p.Hkv + hk) * p.Tk + kt) * p.D;
#pragma unroll
  for (int i = 0; i < L::kNJ; ++i) {
    const int r = ty + 16 * i;
    if (r >= nk) continue;
#pragma unroll
    for (int jj = 0; jj < L::kNC; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (tx + 16 * jj) + e;
        if (col < D) {
          dkg[r * p.D + col] = from_f<T>(dk[i][jj][e] * p.scale);
          dvg[r * p.D + col] = from_f<T>(dv[i][jj][e]);
        }
      }
  }
}

template <typename T, int DP, int BK, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const Params p) {
  using L = Layout<DP, BK, BQ>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + L::kRow;
  float* ks = dos + L::kRow;
  float* vs = ks + L::kKey;
  float* p_s = vs + L::kKey;
  float* ds_s = p_s + L::kTile;
  float* lse_s = ds_s + L::kTile;
  float* delta_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = static_cast<int>(p.D);
  // the last query tiles see the most keys: start them first
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BQ;
  const int64_t h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int nq = static_cast<int>(p.Tq - q0 < BQ ? p.Tq - q0 : BQ);

  for (int i = tid; i < static_cast<int>(L::kSmem / 16); i += kThreads)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  load_rows(qs, L::kS, BQ, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_st,
            p.q_st, nq, D);
  load_rows(dos, L::kS, BQ,
            static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + q0 * p.do_st, p.do_st,
            nq, D);
  const float* lse_h = p.lse + (b * p.Hq + h) * p.Tq;
  const float* delta_h = p.delta + (b * p.Hq + h) * p.Tq;
  for (int r = tid; r < BQ; r += kThreads) {
    lse_s[r] = r < nq ? lse_h[q0 + r] : -CUDART_INF_F;
    delta_s[r] = r < nq ? delta_h[q0 + r] : 0.0f;
  }

  // the key tiles that any row of this block can see
  const int64_t q_first = p.q_offset + q0, q_last = p.q_offset + q0 + nq - 1;
  int64_t k_end = p.Tk;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0) k_begin = q_first - p.window + 1;
  k_begin = k_begin / BK * BK;

  float dq[L::kMI][L::kNC][4];
#pragma unroll
  for (int i = 0; i < L::kMI; ++i)
#pragma unroll
    for (int jj = 0; jj < L::kNC; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][jj][e] = 0.0f;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int64_t kt = k_begin; kt < k_end; kt += BK) {
    const int nk = static_cast<int>(p.Tk - kt < BK ? p.Tk - kt : BK);
    __syncthreads();   // every thread is done with the last tile's k and ds
    load_rows(ks, L::kS, BK, kg + kt * p.k_st, p.k_st, nk, D);
    load_rows(vs, L::kS, BK, vg + kt * p.v_st, p.v_st, nk, D);
    __syncthreads();
    score_tile<DP, BK, BQ>(p, qs, dos, ks, vs, lse_s, delta_s, p_s, ds_s, q0, kt);
    __syncthreads();
    // dQ += dS K: rows ty + 16i, columns 4 (tx + 16jj)
    for (int c = 0; c < nk; ++c) {
      float dsv[L::kMI];
      float4 kv[L::kNC];
#pragma unroll
      for (int i = 0; i < L::kMI; ++i) dsv[i] = ds_s[(ty + 16 * i) * L::kSP + c];
#pragma unroll
      for (int jj = 0; jj < L::kNC; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(ks + c * L::kS + 4 * (tx + 16 * jj));
#pragma unroll
      for (int i = 0; i < L::kMI; ++i)
#pragma unroll
        for (int jj = 0; jj < L::kNC; ++jj) {
          dq[i][jj][0] = fmaf(dsv[i], kv[jj].x, dq[i][jj][0]);
          dq[i][jj][1] = fmaf(dsv[i], kv[jj].y, dq[i][jj][1]);
          dq[i][jj][2] = fmaf(dsv[i], kv[jj].z, dq[i][jj][2]);
          dq[i][jj][3] = fmaf(dsv[i], kv[jj].w, dq[i][jj][3]);
        }
    }
  }

  T* dqg = static_cast<T*>(p.dq) + ((b * p.Hq + h) * p.Tq + q0) * p.D;
#pragma unroll
  for (int i = 0; i < L::kMI; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
#pragma unroll
    for (int jj = 0; jj < L::kNC; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (tx + 16 * jj) + e;
        if (col < D) dqg[r * p.D + col] = from_f<T>(dq[i][jj][e] * p.scale);
      }
  }
}

template <typename T, int DP, int BK, int BQ>
int launch(const Params& p, int64_t B, cudaStream_t stream) {
  using L = Layout<DP, BK, BQ>;
  const int64_t rows = B * p.Hq * p.Tq;
  const int64_t warps = kThreads / 32;
  delta_kernel<T><<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0, stream>>>(
      p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.Tk > 0) {
    err = cudaFuncSetAttribute(dkdv_kernel<T, DP, BK, BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_kv(static_cast<unsigned>((p.Tk + BK - 1) / BK),
                       static_cast<unsigned>(p.Hkv), static_cast<unsigned>(B));
    dkdv_kernel<T, DP, BK, BQ><<<grid_kv, kThreads, L::kSmem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(dq_kernel<T, DP, BK, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((p.Tq + BQ - 1) / BQ), static_cast<unsigned>(p.Hq),
                    static_cast<unsigned>(B));
  dq_kernel<T, DP, BK, BQ><<<grid_q, kThreads, L::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int64_t B, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64, 64, 64>(p, B, stream);
  if (p.D <= 128) return launch<T, 128, 64, 64>(p, B, stream);
  return launch<T, 256, 32, 32>(p, B, stream);
}

}  // namespace

// q: (B, Hq, Tq, D), k and v: (B, Hkv, Tk, D), o and dout: (B, Hq, Tq, D),
// each with unit stride in D and the given strides (in elements) in its
// first three dimensions, all float32; lse: contiguous float32
// (B, Hq, Tq); delta: contiguous float32 (B, Hq, Tq) scratch; dq, dk, dv:
// contiguous float32, of q's, k's and v's shapes.  1 <= D <= 256, Hq a multiple of Hkv.  Launches
// three kernels on `stream` (two when Tk == 0: dk and dv are empty);
// returns the first cudaError_t (0 on success).  The caller checks shapes,
// types and devices.
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
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk; p.D = D; p.group = Hq / Hkv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_st = do_st;
  p.window = window; p.q_offset = q_offset;
  p.causal = causal; p.has_window = has_window; p.has_softcap = has_softcap;
  p.softcap = softcap; p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<float>(p, B, s);
}
