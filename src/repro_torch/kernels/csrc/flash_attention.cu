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
// of 256 threads owns 64 query rows of one (b, q-head) and loops over the
// 64-key tiles that any of its rows can see, so a sliding window costs
// O(T * window) as the TPU kernel's pl.when skip makes it; dead tiles are
// never loaded.  Per tile the block stages K and V in shared memory as
// float32 (the 64 scaled q rows stay there, transposed, for the whole
// loop), and each thread computes a 4 x 4 patch of the 64 x 64 scores:
// 4 consecutive rows, the keys tc, tc+16, tc+32, tc+48.  The 16 threads
// that share a row are one half-warp, so the row max and row sum of the
// online softmax are shuffles; m and l of its 4 rows and the thread's
// 4 x (4 * NG) patch of the 64 x D accumulator stay in registers.  The
// probabilities go through shared memory (transposed) to the P.V product.
// Column d of the accumulator lives in group d / 64, so D <= 256 takes at
// most four groups; the columns past D are zero in shared memory and
// never stored, so D need not be a multiple of anything.  Shared memory
// rows are padded so that the score loop reads K without bank conflicts.
// exp and tanh are the accurate expf / tanhf (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kQS = kBQ + 4;   // row stride of the transposed q tile (floats)
constexpr int kPS = kBQ + 4;   // row stride of the transposed probability tile
constexpr float kNegInf = -1e30f;


__host__ __device__ constexpr int k_stride(int D) { return (D % 2) ? D : D + 1; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t Hq, Tq, Tk, D, group;
  int64_t q_sb, q_sh, q_st;   // strides in elements; the last dimension has stride 1
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t window, q_offset;
  int causal, has_window, has_softcap;
  float softcap, scale;
};

// Shared memory: qt [D][kQS] (scaled q, transposed), ks [kBK][k_stride(D)],
// vs [kBK][64 * NG] (columns past D zero), pt [kBK][kPS] (probabilities,
// transposed).  Every part is a multiple of 16 bytes.
template <int NG>
size_t smem_bytes(int64_t D) {
  return sizeof(float) * (static_cast<size_t>(D) * kQS + static_cast<size_t>(kBK) * k_stride(D) +
                          static_cast<size_t>(kBK) * 64 * NG + static_cast<size_t>(kBK) * kPS);
}

template <int NG>
__global__ void __launch_bounds__(kThreads, NG <= 2 ? 2 : 1)
flash_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = static_cast<int>(p.D);
  const int KS = k_stride(D);
  constexpr int VS = 64 * NG;
  float* qt = smem;
  float* ks = qt + D * kQS;
  float* vs = ks + kBK * KS;
  float* pt = vs + kBK * VS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tc = lane & 15;                 // key / column index within the patch
  const int tr = warp * 2 + (lane >> 4);    // rows tr*4 .. tr*4+3
  // the last query tiles see the most keys: start them first
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / p.group;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // q tile, scaled in float32, transposed; rows past Tq are zero
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const bool ok = q0 + r < p.Tq;
    for (int d = lane; d < D; d += 32)
      qt[d * kQS + r] = ok ? qg[(q0 + r) * p.q_st + d] * p.scale : 0.0f;
  }
  // the value columns past D stay zero for the whole loop
  for (int i = tid; i < kBK * (VS - D); i += kThreads) {
    const int c = i / (VS - D);
    vs[c * VS + D + i % (VS - D)] = 0.0f;
  }

  // the key tiles that any row of this block can see
  const int64_t q_last = p.q_offset + (q0 + kBQ < p.Tq ? q0 + kBQ : p.Tq) - 1;
  const int64_t q_first = p.q_offset + q0;
  int64_t k_end = p.Tk;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0) k_begin = q_first - p.window + 1;
  k_begin = k_begin / kBK * kBK;

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.0f;
  }

  for (int64_t kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int c = warp; c < kBK; c += kThreads / 32) {
      const bool ok = kt + c < p.Tk;
      const float* kr = kg + (kt + c) * p.k_st;
      const float* vr = vg + (kt + c) * p.v_st;
      for (int d = lane; d < D; d += 32) {
        ks[c * KS + d] = ok ? kr[d] : 0.0f;
        vs[c * VS + d] = ok ? vr[d] : 0.0f;
      }
    }
    __syncthreads();

    // scores: rows tr*4+i, keys tc+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kQS + tr * 4);
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tc + 16 * j) * KS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] = fmaf(a.x, kv[j], s[0][j]);
        s[1][j] = fmaf(a.y, kv[j], s[1][j]);
        s[2][j] = fmaf(a.z, kv[j], s[2][j]);
        s[3][j] = fmaf(a.w, kv[j], s[3][j]);
      }
    }

    // online softmax over this tile, one row per half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = p.q_offset + q0 + tr * 4 + i;
      bool live[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = kt + tc + 16 * j;
        live[j] = kpos < p.Tk && (!p.causal || kpos <= qpos) &&
                  (!p.has_window || kpos > qpos - p.window);
        float x = s[i][j];
        if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
        s[i][j] = live[j] ? x : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tc + 16 * j) * kPS + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V: rows tr*4+i, columns g*64 + tc*4 + jj
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + c * kPS + tr * 4);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + c * VS + g * 64 + tc * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(pr[i], vv.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pr[i], vv.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pr[i], vv.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pr[i], vv.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

  float* og = static_cast<float*>(p.o) + ((b * p.Hq + h) * p.Tq) * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + tr * 4 + i;
    if (row >= p.Tq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];   // no live key: zeros
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = g * 64 + tc * 4 + jj;
        if (col < D) og[row * p.D + col] = acc[i][g * 4 + jj] / denom;
      }
  }
}

template <int NG>
int launch(const Params& p, int64_t B, cudaStream_t stream) {
  const size_t smem = smem_bytes<NG>(p.D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's unified memory as shared memory: two blocks fit at D <= 120
  err = cudaFuncSetAttribute(flash_attention_kernel<NG>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.Tq + kBQ - 1) / kBQ), static_cast<unsigned>(p.Hq),
                  static_cast<unsigned>(B));
  flash_attention_kernel<NG><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const Params& p, int64_t B, cudaStream_t stream) {
  switch ((p.D + 63) / 64) {
    case 1: return launch<1>(p, B, stream);
    case 2: return launch<2>(p, B, stream);
    case 3: return launch<3>(p, B, stream);
    default: return launch<4>(p, B, stream);
  }
}

}  // namespace

// q: (B, Hq, Tq, D), k and v: (B, Hkv, Tk, D), each with unit stride in D
// and the given strides (in elements) in its first three dimensions; o:
// contiguous (B, Hq, Tq, D), all float32.  1 <= D <= 256, Hq a multiple of
// Hkv.  Launches on `stream`;
// returns the cudaError_t of the launch (0 on success).  The caller checks
// shapes, types and devices.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int64_t B, int64_t Hq, int64_t Hkv, int64_t Tq,
                                   int64_t Tk, int64_t D, int64_t q_sb, int64_t q_sh,
                                   int64_t q_st, int64_t k_sb, int64_t k_sh, int64_t k_st,
                                   int64_t v_sb, int64_t v_sh, int64_t v_st, int causal,
                                   int has_window, int64_t window, int64_t q_offset,
                                   int has_softcap, float softcap, float scale, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 ||
      (Tq + kBQ - 1) / kBQ > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.Hq = Hq; p.Tq = Tq; p.Tk = Tk; p.D = D; p.group = Hq / Hkv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.window = window; p.q_offset = q_offset;
  p.causal = causal; p.has_window = has_window; p.has_softcap = has_softcap;
  p.softcap = softcap; p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_d(p, B, s);
}
