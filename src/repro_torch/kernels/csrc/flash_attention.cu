// GQA online-softmax (flash) attention, forward:
//
//   out[b, h, i] = sum_j p_ij v[b, h / G, j] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij) over the live keys j of row i,
//   s_ij = (D^-0.5 q[b, h, i]) . k[b, h / G, j], optionally softcap * tanh(s / softcap),
//
// with G = Hq / Hkv query heads per kv head.  Key j is live for row i when
// j < Tk, (causal) j <= qpos and (window) j > qpos - window, where
// qpos = q_offset + i.  A row with no live key comes out as zeros.  Inputs,
// sums and output are float32 (bfloat16 inputs go to
// csrc/flash_attention_sm90.cu, on the tensor cores).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (body
// _attn_kernel) for float32 inputs, which the reference's serving path
// computes for every attention over more than 4096 kv positions
// (models/layers.py _blockwise_attention, its jnp twin).
//
// Bound: operations.  Each live (query, key) pair costs 4 * D flops (the
// score's dot and the value's multiply-add) against 2 * D bytes of q and
// out per query and of k and v per key, so at a long prompt the work is
// far above the card's ridge point.  The arithmetic is the reference's
// float32, here on the CUDA cores (67 TFLOP/s): float32 inputs keep
// float32 products, as the 2e-5 parity gate asks.
//
// Design: the TPU kernel walks the kv blocks as the sequential innermost
// grid axis with m, l and the accumulator in VMEM scratch.  Here one block
// owns BQ stacked query rows: `rows` consecutive positions of `heads`
// query heads that share one kv head (kernels/flash_attention.py::tiling),
// so each K/V tile is read once for the whole group.  It loops over the
// BK-key tiles that any of its rows can see, so a sliding window costs
// O(T * window) as the TPU kernel's pl.when skip makes it; dead tiles are
// never loaded, and the masks are evaluated only on a tile that some row
// sees in part.
//
// Register tiles.  Each warp owns 8 rows; its lane (rg, kg), rg = lane /
// 16, kg = lane % 16, holds the rows rg + 2i (i < 4) by the keys kg + 16j
// (j < BK / 16) of the score tile, and the same 4 rows by the float4
// columns 4 (kg + 16 jj) of the output, so that m, l and the accumulator
// stay in registers (at most 128 a thread: 16 warps a block, one block an
// SM).  The score loop reads q and k as float4 along D, every read feeding
// 16 FMAs; a half-warp reads one q row (a broadcast) and 16 keys.  q rows
// are padded by one 16-byte chunk and k's chunks are XOR-swizzled by key,
// so no read conflicts.  The probabilities go to a warp-private slice of
// shared memory (chunks swizzled by row group) and come back as float4
// along the keys for the P.V product, against float4 rows of V; no other
// warp reads them, so that costs no block barrier.  Per tile, the row
// max is one shuffle reduction over the 16 lanes of a row group; the row
// sum stays per lane and is reduced once at the end.  The exponential is
// ex2 of one FFMA (log2(e) folded into the scale; m kept in log2 units),
// and the accumulator is rescaled only when the max of a row of the warp
// grows.
//
// K and V tiles come in through cp.async into a two-stage ring: tile j+1's
// copies are issued before tile j's arithmetic, so they overlap it; one
// block barrier a tile separates the stages.  A head width D <= 256 takes
// the smallest of three layouts (DP = 64, 128, 256 columns; BQ = 128, 128,
// 64 rows; BK = 64, 64, 32 keys) that holds it; the columns past D are zero
// in shared memory and never stored, rows past Tq or Tk are zero-filled by
// the copies, and nothing is padded in device memory.  Strided q, k and v
// are read in place: 16-byte copies where D, the strides and the bases
// allow, else 4-byte copies.
//
// What bounds it (tools/profile_flash_attention.py, PERF.md): neither
// loop fills the schedulers' issue slots with FMAs, and every tile has
// two latency-bound phases, issuing the next tile's copies and the
// softmax, that the barrier keeps in step across all warps of the block.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// Built with -DFLASH_PHASE_CLOCKS (tools/profile_flash_attention.py only),
// every warp adds the SM clocks it spends in each phase of the tile loop
// to flash_phase_clocks: waiting at the barrier, issuing the next tile's
// copies, the score loop, the softmax, the P.V loop.
#ifdef FLASH_PHASE_CLOCKS
__device__ unsigned long long flash_phase_clocks[5];
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

constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerThread = 4;   // rows rg + 2i of the warp's 8
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;   // (B, Hq, Tq) row log-sum-exp, or null: not written
  int64_t Hq, Tq, Tk, D, group;
  int64_t q_sb, q_sh, q_st;   // strides in elements; the last dimension has stride 1
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t window, q_offset;
  int64_t rows, heads, head_chunks;   // positions and query heads per block
  int causal, has_window, has_softcap, vec;
  float softcap, scale;
};

// DP: columns held in shared memory, BQ: stacked rows a block, KJ: keys a
// lane in the score tile (BK = 16 KJ).
template <int DP, int BQ, int KJ>
struct Layout {
  static constexpr int kWarps = BQ / kRowsPerWarp;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBK = 16 * KJ;
  static constexpr int kOutChunks = DP / 64;  // output float4 columns a lane
  static constexpr int kQS = DP + 4;          // q row stride (floats)
  // q [BQ][kQS], k [2][BK][DP] swizzled, v [2][BK][DP], p [BQ][BK] swizzled
  static constexpr int kQ = BQ * kQS;
  static constexpr int kK = 2 * kBK * DP;
  static constexpr int kV = 2 * kBK * DP;
  static constexpr int kP = BQ * kBK;
  static constexpr size_t kSmem = sizeof(float) * (kQ + kK + kV + kP);
  static_assert(DP / 4 >= 8 && kBK / 4 >= 8, "the swizzles span 8 chunks");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
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

// Copy `n` rows of D floats into shared memory, row r from row_ptr(r), or
// zeros where row_ptr(r) is null: rows of `Stride` floats, their 16-byte
// chunks XOR-swizzled by row & 7 when kSwizzle.  Columns past D are not
// written.  16-byte copies take a fixed chunk a thread; 4-byte copies
// (D, a stride or a base off 16 bytes) one float a step.
template <int DP, int Stride, bool kSwizzle, int kThreads, typename RowPtr>
__device__ __forceinline__ void copy_rows(float* dst, int n, int D, bool vec, int tid,
                                          const float* any, RowPtr row_ptr) {
  constexpr int kC = DP / 4;   // chunks a row
  static_assert(kThreads % kC == 0, "threads cover whole rows");
  if (vec) {
    const int c = tid % kC;
    if (4 * c >= D) return;
    for (int r = tid / kC; r < n; r += kThreads / kC) {
      const float* src = row_ptr(r);
      float* out = dst + r * Stride + ((kSwizzle ? c ^ (r & 7) : c) << 2);
      cp_async16(out, src ? src + 4 * c : any, src ? 16 : 0);
    }
  } else {
    for (int i = tid; i < n * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const float* src = row_ptr(r);
      float* out = dst + r * Stride + ((kSwizzle ? (c >> 2) ^ (r & 7) : c >> 2) << 2) + (c & 3);
      cp_async4(out, src ? src + c : any, src ? 4 : 0);
    }
  }
}

template <int DP, int BQ, int KJ>
__global__ void __launch_bounds__(Layout<DP, BQ, KJ>::kThreads, 1)
flash_attention_kernel(const Params p) {
  using L = Layout<DP, BQ, KJ>;
  constexpr int BK = L::kBK;
  constexpr int NC = L::kOutChunks;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + L::kQ;
  float* vs = ks + L::kK;
  float* ps = vs + L::kV;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = lane >> 4;   // rows rg + 2i
  const int kg = lane & 15;   // keys kg + 16j; output chunks kg + 16jj
  const int D = static_cast<int>(p.D);
  const int R = static_cast<int>(p.rows);
  // the last query tiles see the most keys: start them first
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * R;
  const int64_t hk = blockIdx.y / p.head_chunks;
  const int64_t h0 = hk * p.group + (blockIdx.y % p.head_chunks) * p.heads;   // first q head
  const int64_t h_end = (hk + 1) * p.group;
  const int64_t b = blockIdx.z;

  const float* qg = p.q + b * p.q_sb;
  const float* kgl = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vgl = p.v + b * p.v_sb + hk * p.v_sh;

  // zeros everywhere: the columns past D and what the copies leave alone
  for (int i = tid; i < static_cast<int>(L::kSmem / 16); i += L::kThreads)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  // this warp's rows: one head (rows is a multiple of 16), positions
  const int wrow = warp * kRowsPerWarp;
  const int64_t head = h0 + wrow / R;
  const int64_t pos0 = q0 + wrow % R + rg;          // row i at pos0 + 2i
  const bool head_ok = head < h_end;

  // the positions of the block, and the key tiles any of them can see
  const int64_t q_first = p.q_offset + q0;
  const int64_t q_last = p.q_offset + (q0 + R < p.Tq ? q0 + R : p.Tq) - 1;
  int64_t k_end = p.Tk;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0) k_begin = q_first - p.window + 1;
  k_begin = k_begin / BK * BK;

  auto q_row = [&](int r) -> const float* {
    const int64_t hh = h0 + r / R, pp = q0 + r % R;
    return (hh < h_end && pp < p.Tq) ? qg + hh * p.q_sh + pp * p.q_st : nullptr;
  };
  auto load_kv = [&](int64_t kt, int stage) {
    const int64_t n = p.Tk - kt;
    copy_rows<DP, DP, true, L::kThreads>(ks + stage * BK * DP, BK, D, p.vec, tid, p.k,
                                         [&](int r) -> const float* {
                                           return r < n ? kgl + (kt + r) * p.k_st : nullptr;
                                         });
    copy_rows<DP, DP, false, L::kThreads>(vs + stage * BK * DP, BK, D, p.vec, tid, p.v,
                                          [&](int r) -> const float* {
                                            return r < n ? vgl + (kt + r) * p.v_st : nullptr;
                                          });
  };
  copy_rows<DP, L::kQS, false, L::kThreads>(qs, BQ, D, p.vec, tid, p.q, q_row);
  if (k_begin < k_end) load_kv(k_begin, 0);
  cp_async_commit();

  // log2 units: t = s * c, p = exp2(t - m) = exp(s - m / c)
  const float c = p.has_softcap ? kLog2e : p.scale * kLog2e;
  const float cap_in = p.scale / p.softcap;
  const int d4 = (D + 3) >> 2;

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][4 * NC];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.0f;
  }
  // this warp's probabilities; row rg + 2i's chunks are XOR-swizzled by
  // 4 rg, so that the two rows of one write lie in different banks
  float* pw = ps + wrow * BK + rg * BK;   // row i at pw + 2i BK
  const float* qrow = qs + (wrow + rg) * L::kQS;   // row i at qrow + 2i kQS
  const float* krow = ks + kg * DP;                // key j at krow + 16j DP, swizzled by kg & 7

#ifdef FLASH_PHASE_CLOCKS
  long long phase_clocks[5] = {0, 0, 0, 0, 0};
  long long phase_at = clock64();
#endif
  int stage = 0;
  for (int64_t kt = k_begin; kt < k_end; kt += BK, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // tile kt has landed for all; every warp is done with tile kt - BK
    PHASE(0)
    if (kt + BK < k_end) load_kv(kt + BK, stage ^ 1);
    cp_async_commit();
    PHASE(1)
    const float* kst = krow + stage * BK * DP;
    const float* vst = vs + stage * BK * DP + 4 * kg;

    // scores: rows rg + 2i, keys kg + 16j
    float s[kRowsPerThread][KJ];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int ch = 0; ch < d4; ++ch) {
      float4 a[kRowsPerThread], kv[KJ];
      const float* kr = kst + ((ch ^ (kg & 7)) << 2);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        a[i] = *reinterpret_cast<const float4*>(qrow + 2 * i * L::kQS + 4 * ch);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kr + 16 * j * DP);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(a[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, kv[j].w, s[i][j]);
        }
    }

    PHASE(2)
    // online softmax, the four rows side by side; masks only where some
    // row of the block sees the tile in part
    const bool edge = kt + BK > p.Tk || (p.causal && kt + BK - 1 > q_first) ||
                      (p.has_window && kt <= q_last - p.window);
    uint32_t live = 0xffffffffu;   // bit i * KJ + j
    float mx[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int64_t qpos = p.q_offset + pos0 + 2 * i;
      mx[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        if (p.has_softcap) s[i][j] = p.softcap * tanhf(s[i][j] * cap_in);
        if (edge) {
          const int64_t kpos = kt + kg + 16 * j;
          const bool ok = kpos < p.Tk && (!p.causal || kpos <= qpos) &&
                          (!p.has_window || kpos > qpos - p.window);
          if (!ok) live &= ~(1u << (i * KJ + j));
        }
        if (live >> (i * KJ + j) & 1u) mx[i] = fmaxf(mx[i], s[i][j]);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    float m_new[kRowsPerThread];
    bool grew = false;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      m_new[i] = mx[i] > kNegInf ? fmaxf(m[i], mx[i] * c) : m[i];
      grew |= m_new[i] > m[i];
    }
    // rescale only when some row of the warp has a new max
    if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float alpha = m_new[i] > m[i] ? ex2(m[i] - m_new[i]) : 1.0f;
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < 4 * NC; ++j) acc[i][j] *= alpha;
        m[i] = m_new[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float e = (live >> (i * KJ + j) & 1u) ? ex2(fmaf(s[i][j], c, -m[i])) : 0.0f;
        sum += e;
        // key kg + 16j: chunk (kg >> 2) + 4j, swizzled
        pw[2 * i * BK + ((((kg >> 2) + 4 * j) ^ (4 * rg)) << 2) + (kg & 3)] = e;
      }
      l[i] += sum;
    }
    __syncwarp();
    PHASE(3)

    // acc += P V: rows rg + 2i, columns 4 (kg + 16 jj) .. + 3
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[kRowsPerThread];
      const float* prow = pw + ((((kk >> 2) ^ (4 * rg))) << 2);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = *reinterpret_cast<const float4*>(prow + 2 * i * BK);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[NC];
#pragma unroll
        for (int jj = 0; jj < NC; ++jj)
          vv[jj] = *reinterpret_cast<const float4*>(vst + (kk + u) * DP + 64 * jj);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float pr = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) {
            acc[i][4 * jj + 0] = fmaf(pr, vv[jj].x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(pr, vv[jj].y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(pr, vv[jj].z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(pr, vv[jj].w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
    PHASE(4)
  }
  cp_async_wait_all();   // no copy outlives the block
#ifdef FLASH_PHASE_CLOCKS
  if (lane == 0)
    for (int k = 0; k < 5; ++k)
      atomicAdd(&flash_phase_clocks[k], static_cast<unsigned long long>(phase_clocks[k]));
#endif

  // each lane summed its own keys: the row sum is over the row group
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  if (!head_ok) return;
  float* og = p.o + (b * p.Hq + head) * p.Tq * p.D;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t pos = pos0 + 2 * i;
    if (pos >= p.Tq) continue;
    // log-sum-exp of the row's scores: m is in log2 units of the scaled score
    if (p.lse != nullptr && kg == 0)
      p.lse[(b * p.Hq + head) * p.Tq + pos] =
          l[i] == 0.0f ? -CUDART_INF_F : (m[i] + log2f(l[i])) * kLn2;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];   // no live key: zeros
    float* orow = og + pos * p.D;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int col = 4 * (kg + 16 * jj);
      const float4 r = make_float4(acc[i][4 * jj] / denom, acc[i][4 * jj + 1] / denom,
                                   acc[i][4 * jj + 2] / denom, acc[i][4 * jj + 3] / denom);
      if ((D & 3) == 0) {
        if (col < D) *reinterpret_cast<float4*>(orow + col) = r;
      } else {
        if (col < D) orow[col] = r.x;
        if (col + 1 < D) orow[col + 1] = r.y;
        if (col + 2 < D) orow[col + 2] = r.z;
        if (col + 3 < D) orow[col + 3] = r.w;
      }
    }
  }
}

template <int DP, int BQ, int KJ>
int launch(const Params& p, int64_t B, int64_t Hkv, cudaStream_t stream) {
  using L = Layout<DP, BQ, KJ>;
  if (p.rows * p.heads != BQ) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DP, BQ, KJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.Tq + p.rows - 1) / p.rows),
                  static_cast<unsigned>(Hkv * p.head_chunks), static_cast<unsigned>(B));
  flash_attention_kernel<DP, BQ, KJ><<<grid, L::kThreads, L::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, Tq, D), k and v: (B, Hkv, Tk, D), each with unit stride in D
// and the given strides (in elements) in its first three dimensions; o:
// contiguous (B, Hq, Tq, D), all float32.  1 <= D <= head_pad, Hq a
// multiple of Hkv.  The tiling (kernels/flash_attention.py::tiling) is
// head_pad columns (64, 128 or 256) and blocks of `rows` positions of
// `heads` query heads, rows a multiple of 16 and rows * heads the
// layout's 128 (head_pad 64, 128) or 64 (head_pad 256) stacked rows.
// lse: contiguous float32 (B, Hq, Tq) for each row's log-sum-exp (-inf
// where a row sees no key), or null.  Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes,
// types and devices.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int64_t B, int64_t Hq, int64_t Hkv, int64_t Tq,
                                   int64_t Tk, int64_t D, int64_t q_sb, int64_t q_sh,
                                   int64_t q_st, int64_t k_sb, int64_t k_sh, int64_t k_st,
                                   int64_t v_sb, int64_t v_sh, int64_t v_st, int causal,
                                   int has_window, int64_t window, int64_t q_offset,
                                   int has_softcap, float softcap, float scale,
                                   int64_t head_pad, int64_t rows, int64_t heads,
                                   void* lse, void* stream) {
  if (D < 1 || D > head_pad || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 ||
      rows < 16 || rows % 16 != 0 || heads < 1 || (Tq + rows - 1) / rows > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.Hq = Hq; p.Tq = Tq; p.Tk = Tk; p.D = D; p.group = Hq / Hkv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.window = window; p.q_offset = q_offset;
  p.rows = rows; p.heads = heads; p.head_chunks = (p.group + heads - 1) / heads;
  p.causal = causal; p.has_window = has_window; p.has_softcap = has_softcap;
  p.softcap = softcap; p.scale = scale;
  // 16-byte copies need D, every stride and every base on 16-byte boundaries
  const int64_t strides = q_sb | q_sh | q_st | k_sb | k_sh | k_st | v_sb | v_sh | v_st | D;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  p.vec = (strides & 3) == 0 && (bases & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_pad) {
    case 64: return launch<64, 128, 4>(p, B, Hkv, s);
    case 128: return launch<128, 128, 4>(p, B, Hkv, s);
    case 256: return launch<256, 64, 2>(p, B, Hkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef FLASH_PHASE_CLOCKS
// copies the five phase sums out (or zeroes them when `out` is null);
// returns the cudaError_t
extern "C" int flash_phase_clocks_read(unsigned long long* out) {
  if (out == nullptr) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(flash_phase_clocks, zero, sizeof(zero)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, flash_phase_clocks, sizeof(flash_phase_clocks)));
}
#endif
