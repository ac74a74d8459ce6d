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
// wgmma on the bf16 tensor cores (989 TFLOP/s).  A call with one query
// row (a decode step's cross-attention) is bound by the bytes of k and v.
//
// Shared by both configurations below (FlashAttention-3's building blocks):
// - q, k and v arrive by TMA into a ring of stages in shared memory, in
//   128-byte swizzled 64-column atoms: the head dimension is read as D
//   columns of a 4-d tensor map (D, T, heads, batch) with the tensors' own
//   strides, so k and v are read in place as the projection's strided
//   views; columns past D (D = 120: 8 of the 128) come in as zeros (the
//   tensor map's out-of-bounds fill), add nothing to a dot and are never
//   stored.  Rows past Tq or Tk come in as zeros too.  A full mbarrier
//   per stage says its tiles have landed, an empty one that every warp
//   is done with them.
// - A block walks only the key tiles that one of its rows can see (causal,
//   window, q_offset), so a sliding window costs O(T * window), as the TPU
//   kernel's pl.when skip makes it; tiles that cross a mask edge are masked
//   element by element.
// - S = q k^T is a wgmma with both operands in shared memory (K-major),
//   accumulated in float32; the scale D^-0.5 is applied to S in float32,
//   so q is not rounded again after scaling as it would be if the scaled
//   q were fed to the tensor cores (the reference scales q in float32).
// - The online softmax runs on the accumulator's registers: each thread
//   holds two rows' columns, so the row max and sum are two quad shuffles.
//   A probability is one FFMA and one exp2 (float32, MUFU) of the unscaled
//   score; the reference point of the exponentials moves only when a row's
//   max grows by more than 8 in exp2 units, so most tiles skip the
//   accumulator's rescaling (the same softmax, with p < 256).
// - P V is a wgmma with P from registers: the float32 accumulator of S has
//   the register layout of the bf16 A operand, so P never goes through
//   shared memory.  P rounded once to bf16 misses the per-element gate
//   (2^-7 |want| + 1e-4) on long rows, so P is split into two bf16 parts,
//   hi = bf16(p) and lo = bf16(p - hi), and P V is the sum of two wgmma
//   (hi V + lo V, exact products, float32 sums): p is carried to ~2^-16
//   relative, as close as a float32 p for the gate.  P rounded once to fp16
//   misses it too where a row's weight sits on a few keys (peaked scores,
//   tools/emulate_fp16_attention.py --peaked), at any count of keys.
//
// Head widths 136-256 (recurrentgemma's 256; namespace d256): two consumer
// warpgroups of 64 query rows that take turns at the tensor cores, over the
// same 64 rows of two query heads of a kv head where the group is even
// (each k and v tile, read once, serves both heads: recurrentgemma's ten
// query heads over one kv head re-read k and v ten times a row block) and
// else over 128 rows of one head; 64-key tiles of the head's four
// 64-column atoms (narrower heads read as 256 columns: the atoms past D are
// zeroed in shared memory once and never loaded).  The accumulator of 64 x 256 float32 is 128
// registers a thread, S and the two P parts 32 each: a producer warpgroup
// (384 threads) or warp (288, three warps on one of the SM's four register
// files) would leave ptxas 168 registers a thread to plan the wgmma
// pipeline for, so the block is the two consumers alone (256 threads, 255
// registers), and in its turn a consumer issues the previous tile's P V and
// this tile's S together.  Its thread 0 issues every TMA load after passing
// its turn, without waiting unless the stage of a tile its warpgroup needs
// next is still held.  k and v have rings of their own (two and three
// stages of 32 KB beside 64 KB of q): a k tile is released once both
// consumers' S has read it, a v tile once their P V has, so the next S's
// tile loads while the P V of the one before is still to run.
//
// Head widths 65-128 (danube's 120, olmo's 128; namespace d128): the
// structure of the widths up to 64 below, over the head's two 64-column
// atoms.  One block per 128 query rows, 128-key tiles (S is one m64n128k16
// wgmma a 16-column step, eight steps) and three warpgroups: a producer
// whose one thread issues every TMA load into a ring of three stages, and
// two consumers of 64 rows that take turns at the tensor cores.  The
// softcap is a template argument and the mask a test once a tile
// (online_softmax).  A consumer runs the previous tile's P V, waits, then
// issues this tile's S and waits: with a producer warpgroup the block has
// 384 threads, and ptxas plans the wgmma pipeline for the 168 registers a
// thread that allows, whatever setmaxnreg grants the consumers at run time
// (it does allocate up to the 240 granted, but serialises every wgmma of a
// kernel whose operands in flight do not fit 168: "C7512 ... insufficient
// register resources"); the accumulator (64 registers), S (64) and P (64
// in two parts, 32 in one) are never all live.  P V in two bf16 parts is
// two thirds of a tile's tensor time (6 D' flops a pair with S).  P V in
// one fp16 part, P' = p 2^7 against an fp16 copy of v (4 D' a pair), ran
// the 128-row blocks whose every row sees 1024 keys or more until one
// rounding of P was found to miss the limit on peaked scores (git history
// keeps that design).  By SM clocks (PERF.md) a consumer spends half of
// its turn in the softmax, more than its products take at the card's
// rate, and a sixth draining P V and S.  Two
// consumers alone at 256 threads (255 registers: this tile's S, then the
// previous tile's P V, two commit groups, the exponentials while P V runs,
// or one commit as at 136-256; k and v rings of three stages each, the
// consumers' warps issuing the loads on a fixed schedule) drained for ~50
// clocks instead of ~530, but spent ~180-260 issuing loads and ~240-270
// waiting for them, and their softmax grew by ~150: 0.3-4.0 % slower than
// this design at olmo's and danube's serving and training shapes, and at
// olmo's serving shape slower than this design without the programmatic
// launch and the shifted exponentials; 64-key tiles were slower too.
//
// Head widths up to 64 (seamless's 64): one block per NC * 64 query rows,
// 128-key tiles (S is one m64n128k16 wgmma a 16-column step) and NC + 1
// warpgroups: a producer whose one thread issues every TMA load into a ring
// of five stages and NC consumer warpgroups of 64 rows.  The caller picks
// NC by the rows a block it passes (flash_attention_sm90.py::block_rows):
// 1 up to 64 query rows (a decode step); above, 3 (192 rows, 512 threads)
// where the call's waves of such blocks hold no more rows of an SM's time
// than those of 128-row blocks (seamless's encoder), else 2.
// The consumers take turns at the tensor cores (named barrier 1 + w,
// passed on to 1 + (w + 1) % NC), so that a consumer's softmax runs while
// the others' products run (ping-pong).  P V in two bf16 parts is two
// thirds of a tile's tensor time (6 D' flops a pair with S; 768 clocks of
// a 128-key tile at the SM's rate): with two consumers a softmax (~1600
// clocks a turn, PERF.md) cannot hide behind the other's products, with
// three it has two consumers' to hide behind, and each k and v tile, read
// once, serves 192 rows.  In its turn a consumer runs the previous tile's
// P V, waits, then issues this tile's S (the accumulator, S and two P
// parts, 160 registers, are never all live); see d64::Cfg for the
// registers.  One fp16 part of P with v converted to fp16 in shared memory
// by the producer's idle warps ran the blocks whose rows see 1024 keys or
// more, 9 % faster at the encoder than two parts, until one rounding of P
// was found to miss the limit on peaked scores (git history keeps it).

// Split keys (widths up to 64): a call with few blocks (fewer than two
// waves, and only where S ranges fill the waves better, see
// flash_attention_sm90.py::split_count) cuts the live key span
// into S contiguous ranges of whole 512-key chunks, and each block takes
// one (row block, range).  It writes its range's output o_s = acc / l in
// float32 and lse_s = m + log(l) (-inf and zeros for a row that sees no
// key in the range) to scratch, and the last block of a row block to finish
// its range (an arrival counter a row block) merges them in the same
// launch: lse = logsumexp_s lse_s, o = sum_s exp(lse_s - lse) o_s in
// bfloat16 (merge_ranges).  Split is a template argument, so the kernel
// that does not split compiles without the merge.

#include <math_constants.h>

#include "sm90_common.cuh"

#ifdef FLASH_PHASE_CLOCKS
// Built with -DFLASH_PHASE_CLOCKS (tools/profile_flash_attention.py only),
// every consumer warp of the d128 and d64 kernels adds the SM clocks it
// spends in each phase of its tile loop to flash_fwd_sm90_phase_clocks[pass]
// (pass 0 the d128 kernel, 1 the d64 kernels that do not split, 2 those
// that do): waiting for a stage's loads; waiting for the turn; the products
// issued and the turn passed; waiting for P V to drain; waiting for S; the
// softmax (with the accumulator's rescale); P split into its parts.  The
// last entry counts the warp's turns in the loop (tiles after its first).
constexpr int kFwdPhases = 8;
constexpr int kFwdPasses = 3;
__device__ unsigned long long flash_fwd_sm90_phase_clocks[kFwdPasses][kFwdPhases];
#define PHASE(k)                       \
  {                                    \
    const long long now = clock64();   \
    phase_clocks[k] += now - phase_at; \
    phase_at = now;                    \
  }
#define PHASE_START                                  \
  long long phase_clocks[kFwdPhases] = {};           \
  long long phase_at = clock64();
#define PHASE_TURN ++phase_clocks[kFwdPhases - 1];
#define PHASE_END(pass)                                                              \
  if ((threadIdx.x & 31) == 0)                                                       \
    for (int k = 0; k < kFwdPhases; ++k)                                             \
      atomicAdd(&flash_fwd_sm90_phase_clocks[pass][k],                               \
                static_cast<unsigned long long>(phase_clocks[k]));
#else
#define PHASE(k)
#define PHASE_START
#define PHASE_TURN
#define PHASE_END(pass)
#endif

namespace {

constexpr int kBM = 64;      // query rows per consumer warpgroup
constexpr int kSplitKeys = 512;   // a split range is a whole number of these chunks
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// Head widths up to 64: a producer warpgroup, NC consumer warpgroups of 64
// query rows, 128-key tiles, split keys.
// ---------------------------------------------------------------------------

namespace d64 {
constexpr int kKeys = 128;                 // keys a tile
constexpr int kQBytes = kBM * kAtom * 2;   // one consumer's q tile
constexpr int kKVBytes = kKeys * kAtom * 2;

// NC consumer warpgroups: 1 up to 64 query rows (a decode step), else 2 or
// 3 (the rows a block the caller passes).  The launch allocates 3 x 168
// registers a thread at NC = 2 and 4 x 128 at NC = 3, which setmaxnreg
// moves from the producer to the consumers (24 + 2 x 240, 24 + 3 x 160).
// ptxas plans the code for the launch's budget whatever setmaxnreg grants:
// at NC = 3 the consumer's SASS names no register above the launch's 128
// (PERF.md gives ptxas's report and the SASS's highest register and spill
// instructions a build).  So the NC = 3 consumer is fitted to 128: the
// accumulator (32) beside S (64) or beside P's two parts (64), never all
// three, and few loop scalars (the tile range and the bounds of the tiles
// every row sees whole); the rows' positions and the block's indices are
// read again where a masked tile or the store needs them, and q's address
// is opaque to the loop, so that its four wgmma descriptors are computed
// anew each turn instead of held (held, they spilled).  64-key halves of a
// tile (S and P 32 registers each) fit with room to spare but cost more a
// key.  What sets a tile's pace is not its exponentials on MUFU (16 a
// clock an SM, as many clocks a 128 x 128 tile as its wgmma at D = 64 by
// the throughput table): with every ex2 of the tile loop a multiply
// instead, the encoder's call ran no faster (PERF.md), so no exponential
// goes to the FMA pipe.
template <int NC>
struct Cfg {
  static constexpr int kNC = NC;
  static constexpr int kRows = NC * kBM;             // query rows a block
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = NC == 3 ? 160 : 240;
  static constexpr int kStages = 5;
  // q tiles, the k and v rings, the full and empty barriers a stage and q's
  static constexpr int kSmem = 1024 + NC * kQBytes + 2 * kStages * kKVBytes + 8 * (2 * kStages + 1);
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};
}  // namespace d64

struct D64Params {
  void* o;
  float* lse;        // (B, Hq, Tq) row log-sum-exp, or null: not written
  float* o_part;     // split: (B, Hq, S, Tq, D) float32 o_s, else null
  float* lse_part;   // split: (B, Hq, S, Tq) float32 lse_s
  int64_t Hq, Tq, Tk, D;
  int group;
  int64_t window, q_offset;
  int64_t split_lo;     // split ranges: chunks of kSplitKeys from split_lo
  int split_chunks, splits;
  int causal, has_window, has_softcap;
  float softcap, scale, scale_log2;
  float cap_scale;      // scale / softcap
  unsigned* arrivals;   // split: one zeroed counter a (batch, head, row block)
};

struct TileRange {
  int64_t begin;   // first key of the first tile
  int n;           // tiles
};

// The TILE-key tiles that rows q0 .. rows_end - 1 can see within split
// range s.  Range s starts at chunk floor(s * n / S) from split_lo and ends
// where range s + 1 starts; the last range runs to the end of the keys.
// Range bounds are multiples of 512 keys, so tiles never cross them.
template <int TILE>
__device__ __forceinline__ TileRange tile_range(const D64Params& p, int64_t q0, int64_t rows_end,
                                                int s) {
  const int64_t q_first = p.q_offset + q0;
  const int64_t q_last = p.q_offset + rows_end - 1;
  int64_t k_end = p.Tk;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0) k_begin = q_first - p.window + 1;
  k_begin = k_begin / TILE * TILE;
  // 32-bit: the entry point holds splits * split_chunks under 2^31
  const int64_t r_lo = p.split_lo + kSplitKeys * static_cast<int64_t>(s * p.split_chunks /
                                                                     p.splits);
  if (r_lo > k_begin) k_begin = r_lo;
  if (s + 1 < p.splits) {
    const int64_t r_hi =
        p.split_lo + kSplitKeys * static_cast<int64_t>((s + 1) * p.split_chunks / p.splits);
    if (r_hi < k_end) k_end = r_hi;
  }
  TileRange r;
  r.begin = k_begin;
  r.n = k_end > k_begin ? static_cast<int>((k_end - k_begin + TILE - 1) / TILE) : 0;
  return r;
}

// Sets to -inf the scores of a thread's share of a tile of 2N keys from kt
// (see online_softmax) that its rows at positions pos0 and pos1 do not see.
// The bounds are taken once a tile as 32-bit column offsets from kt + c2,
// so that an element costs two compares with constants and a select.
template <int N>
__device__ __forceinline__ void mask_tile(float (&sc)[N], const D64Params& p, int64_t kt,
                                          int64_t pos0, int64_t pos1, int c2) {
  constexpr int64_t kTile = 2 * N;
  // offsets are read against [0, kTile): clamping to [-1, kTile] keeps every compare
  const auto edge = [](int64_t x) {
    return static_cast<int>(x < -1 ? -1 : (x > kTile ? kTile : x));
  };
  const int64_t base = kt + c2;
  int64_t hi0 = p.Tk - base, hi1 = hi0, lo0 = 0, lo1 = 0;   // live: lo <= j < hi
  if (p.causal) {
    hi0 = pos0 - base + 1 < hi0 ? pos0 - base + 1 : hi0;
    hi1 = pos1 - base + 1 < hi1 ? pos1 - base + 1 : hi1;
  }
  if (p.has_window) {
    lo0 = pos0 - p.window + 1 - base;
    lo1 = pos1 - p.window + 1 - base;
  }
  const int h0 = edge(hi0), h1 = edge(hi1), g0 = edge(lo0), g1 = edge(lo1);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = (i / 4) * 8 + (i & 1);
    const bool live = (i & 2) ? (j >= g1 && j < h1) : (j >= g0 && j < h0);
    sc[i] = live ? sc[i] : -CUDART_INF_F;
  }
}

// One tile's online softmax on a thread's share of S = q k^T: N scores, the
// columns 8j + c2 and 8j + c2 + 1 of rows r0 (sc[4j], sc[4j + 1]) and r0 + 8
// (sc[4j + 2], sc[4j + 3]) for j < N / 4, a tile of 2N keys.  Applies the
// softcap, and where the tile crosses a mask edge (all_live false) the mask
// (mask(sc): mask_tile), moves the reference points m0, m1, turns sc into
// p in place and updates l0, l1 (sums of p).  alpha0, alpha1
// rescale the accumulator.  CAP: 1 or 0 where the caller fixes the softcap
// at compile time, else p.has_softcap.  Every exponential is one ex2 on
// MUFU (d64::Cfg says why none moved to the FMA pipe).
template <int N, int CAP = -1, class Mask>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], const D64Params& p, bool all_live,
                                             const Mask& mask, float f, float& m0, float& m1,
                                             float& l0, float& l1, float& alpha0,
                                             float& alpha1) {
  // The softcap and the mask are uniform branches taken once a tile, not
  // once an element (a branch an element costs more than the exponentials).
  if (CAP < 0 ? p.has_softcap != 0 : CAP != 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] = p.softcap * tanhf(sc[i] * p.cap_scale) * kLog2e;
  }
  if (!all_live) mask(sc);
  // the row max and sum in four independent chains each, so that the
  // reductions do not wait on one long dependency chain
  float mx[2][4] = {{m0, m0, m0, m0}, {m1, m1, m1, m1}};
#pragma unroll
  for (int i = 0; i < N; ++i)
    mx[(i >> 1) & 1][(i & 1) + 2 * ((i >> 2) & 1)] =
        fmaxf(mx[(i >> 1) & 1][(i & 1) + 2 * ((i >> 2) & 1)], sc[i]);
  float mx0 = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
  float mx1 = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
  // the four threads of a quad hold one row's columns
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
  alpha0 = up0 ? ex2((m0 - mx0) * f) : 1.0f;
  alpha1 = up1 ? ex2((m1 - mx1) * f) : 1.0f;
  if (up0) m0 = mx0;
  if (up1) m1 = mx1;
  const float mf0 = m0 == -CUDART_INF_F ? 0.0f : m0 * f;
  const float mf1 = m1 == -CUDART_INF_F ? 0.0f : m1 * f;
  float sum[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float pr = ex2(fmaf(sc[i], f, (i & 2) ? -mf1 : -mf0));
    sc[i] = pr;
    sum[(i >> 1) & 1][(i & 1) + 2 * ((i >> 2) & 1)] += pr;
  }
  l0 = l0 * alpha0 + ((sum[0][0] + sum[0][1]) + (sum[0][2] + sum[0][3]));
  l1 = l1 * alpha1 + ((sum[1][0] + sum[1][1]) + (sum[1][2] + sum[1][3]));
}

// softmax_tile of the tile from kt, whose mask edges it finds itself: qa, qb
// the positions of the warpgroup's first and last rows, pos0, pos1 this
// thread's
template <int N, int CAP = -1>
__device__ __forceinline__ void online_softmax(float (&sc)[N], const D64Params& p, int64_t kt,
                                               int64_t qa, int64_t qb, int64_t pos0,
                                               int64_t pos1, int c2, float f, float& m0,
                                               float& m1, float& l0, float& l1, float& alpha0,
                                               float& alpha1) {
  constexpr int kTile = 2 * N;
  const bool all_live = kt + kTile <= p.Tk && (!p.causal || kt + kTile - 1 <= qa) &&
                        (!p.has_window || kt > qb - p.window);
  softmax_tile<N, CAP>(
      sc, p, all_live, [&](float(&s)[N]) { mask_tile(s, p, kt, pos0, pos1, c2); }, f, m0, m1,
      l0, l1, alpha0, alpha1);
}

// P = hi + lo, each bf16, in the A-operand layout: register r of the
// 16-key step kk holds sc[8kk + 2r], sc[8kk + 2r + 1].  hi is p truncated
// (the upper half of its bits, a byte permute), lo = bf16(p - hi), as the
// backward kernel splits P: p is kept to ~2^-16 relative.
template <int KK>
__device__ __forceinline__ void split_p(const float (&sc)[8 * KK], uint32_t (&phi)[KK][4],
                                        uint32_t (&plo)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = sc[8 * kk + 2 * r];
      const float c = sc[8 * kk + 2 * r + 1];
      const uint32_t ha = __float_as_uint(a) & 0xffff0000u;
      const uint32_t hc = __float_as_uint(c) & 0xffff0000u;
      phi[kk][r] = __byte_perm(ha, hc, 0x7632);
      plo[kk][r] = pack_bf16(__floats2bfloat162_rn(a - __uint_as_float(ha),
                                                  c - __uint_as_float(hc)));
    }
}

// out = acc / l for this thread's rows row0 and row0 + 8 (columns 8j + c2,
// 8j + c2 + 1 of each 64-column block): bf16 o and the row lse, or in a
// split this range's float32 o_s and lse_s.  A row with no live key has
// l == 0 and comes out as zeros, its lse as -inf.
template <int NB>
__device__ __forceinline__ void store_rows(const D64Params& p, float (&o)[NB][32], float l0, float l1,
                                           float m0, float m1, float f, int b, int h, int s,
                                           int64_t row0, int c2, int lane) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // l >= 1 (the row max's own p) or 0: 1 / l by MUFU.RCP, no division's slow path
  const float d0 = __fdividef(1.0f, l0 == 0.0f ? 1.0f : l0);
  const float d1 = __fdividef(1.0f, l1 == 0.0f ? 1.0f : l1);
  const int64_t row1 = row0 + 8;
  // log-sum-exp of each row's scores: m f is in log2 units of the scaled score
  const float lse0 = l0 == 0.0f ? -CUDART_INF_F : (m0 * f + log2f(l0)) * kLn2;
  const float lse1 = l1 == 0.0f ? -CUDART_INF_F : (m1 * f + log2f(l1)) * kLn2;
  const int64_t bh = static_cast<int64_t>(b) * p.Hq + h;
  if (p.o_part == nullptr) {
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + bh * p.Tq * p.D;
    if (p.lse != nullptr && (lane & 3) == 0) {
      float* lse = p.lse + bh * p.Tq;
      if (row0 < p.Tq) lse[row0] = lse0;
      if (row1 < p.Tq) lse[row1] = lse1;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * kAtom + 8 * j + c2;   // D is even: col < D covers col + 1
        if (col >= p.D) continue;
        if (row0 < p.Tq)
          *reinterpret_cast<__nv_bfloat162*>(og + row0 * p.D + col) =
              __floats2bfloat162_rn(o[nb][4 * j] * d0, o[nb][4 * j + 1] * d0);
        if (row1 < p.Tq)
          *reinterpret_cast<__nv_bfloat162*>(og + row1 * p.D + col) =
              __floats2bfloat162_rn(o[nb][4 * j + 2] * d1, o[nb][4 * j + 3] * d1);
      }
    return;
  }
  const int64_t part = (bh * p.splits + s) * p.Tq;
  float* og = p.o_part + part * p.D;
  if ((lane & 3) == 0) {
    if (row0 < p.Tq) p.lse_part[part + row0] = lse0;
    if (row1 < p.Tq) p.lse_part[part + row1] = lse1;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * kAtom + 8 * j + c2;
      if (col >= p.D) continue;
      if (row0 < p.Tq)
        *reinterpret_cast<float2*>(og + row0 * p.D + col) =
            make_float2(o[nb][4 * j] * d0, o[nb][4 * j + 1] * d0);
      if (row1 < p.Tq)
        *reinterpret_cast<float2*>(og + row1 * p.D + col) =
            make_float2(o[nb][4 * j + 2] * d1, o[nb][4 * j + 3] * d1);
    }
}

// 1 if `pred` holds for any of the `threads` threads at named barrier `id`,
// which it also waits at, as bar_sync does
__device__ __forceinline__ bool bar_any(int id, int threads, bool pred) {
  int out;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.s32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\n"
      "selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(out)
      : "r"(static_cast<int>(pred)), "r"(id), "r"(threads)
      : "memory");
  return out != 0;
}

constexpr int kMergeBar = 5;   // the consumers' named barrier (1 + w are their turns)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// The split's merge, run by the NC consumer warpgroups of every block of a
// split call once it has written its range's o_s and lse_s.  After a
// barrier of the consumers, thread 0 counts the block's arrival at its row
// block's counter with an acquire-release atomicInc (it releases the whole
// block's partials, as the barrier ordered them before it, and acquires the
// other ranges'); atomicInc wraps the count to 0 at the last of the S
// ranges, so the counters stay zero between calls.  The block that arrives
// last merges the row block's rows over the ranges in range order, with the
// arithmetic of a warp a row: lse = logsumexp_s lse_s and
// o = sum_s exp(lse_s - lse) o_s in float32, written in bfloat16; a row
// whose every lse_s is -inf comes out as zeros and lse -inf.  Where the
// row block's partials fit the k and v ring (free once the tiles are done:
// up to 4 ranges of 128 rows of 64 columns, hundreds of a decode step's
// row), they come in by cp.async all at once, one trip to L2, and the merge
// runs from shared memory, a warp a row; else a warp a row reads them from
// L2.  The partials are read through L2 (cp.async.cg, ld.global.cg), where
// the other blocks wrote them.  The block's indices are read again here
// (volatile), not kept in registers across the tile loop.
template <int NC>
__device__ __forceinline__ void merge_ranges(const D64Params& p) {
  using C = d64::Cfg<NC>;
  constexpr int kThreadsC = NC * 128;
  constexpr int kStageFloats = 2 * C::kStages * d64::kKVBytes / 4;
  unsigned tid, bx, nbx, h, b;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(bx));
  asm volatile("mov.u32 %0, %%nctaid.x;\n" : "=r"(nbx));
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(h));
  asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(b));
  bar_sync(kMergeBar, kThreadsC);   // every consumer thread has stored its o_s and lse_s
  const int S = p.splits;
  const int64_t bh = static_cast<int64_t>(b) * p.Hq + h;
  const unsigned n_rb = nbx / S, rb = bx / S;
  bool last = false;
  if (tid == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
                 : "=r"(old)
                 : "l"(p.arrivals + bh * n_rb + rb), "r"(S - 1)
                 : "memory");
    last = old == static_cast<unsigned>(S - 1);
  }
  if (!bar_any(kMergeBar, kThreadsC, last)) return;
  const int64_t Tq = p.Tq;
  const int64_t q0 = static_cast<int64_t>(n_rb - 1 - rb) * C::kRows;
  const int rows = static_cast<int>(q0 + C::kRows < Tq ? C::kRows : Tq - q0);
  const int D = static_cast<int>(p.D);
  const int lane = tid & 31, warp = tid >> 5;
  const int col = 2 * lane;
  const float* ls = p.lse_part + bh * S * Tq + q0;        // range s, row q0 + r at s Tq + r
  const float* os = p.o_part + (bh * S * Tq + q0) * D;    // range s, row q0 + r at (s Tq + r) D
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (bh * Tq + q0) * D;
  const int l_floats = (S * rows + 3) & ~3;
  if (static_cast<int64_t>(S) * rows * D + l_floats + rows <= kStageFloats) {
    extern __shared__ uint8_t smem_raw[];
    float* lw = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) +
                                         NC * d64::kQBytes);   // [S][rows] lse_s, then weights
    float* o_s = lw + l_floats;                                // [S][rows][D]
    float* lse = o_s + S * rows * D;                           // [rows]
    for (int s = 0; s < S; ++s) {
      for (int r = tid; r < rows; r += kThreadsC) cp_async4(lw + s * rows + r, ls + s * Tq + r);
      for (int i = tid; i < rows * D / 4; i += kThreadsC)
        cp_async16(o_s + s * rows * D + 4 * i, os + s * Tq * D + 4 * i);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    bar_sync(kMergeBar, kThreadsC);
    for (int r = tid; r < rows; r += kThreadsC) {
      float mx = -CUDART_INF_F;
      for (int s = 0; s < S; ++s) mx = fmaxf(mx, lw[s * rows + r]);
      float total = -CUDART_INF_F;
      if (mx != -CUDART_INF_F) {
        float sum = 0.0f;
        for (int s = 0; s < S; ++s) sum += expf(lw[s * rows + r] - mx);
        total = mx + logf(sum);
      }
      for (int s = 0; s < S; ++s) lw[s * rows + r] = expf(lw[s * rows + r] - total);
      lse[r] = total;
    }
    bar_sync(kMergeBar, kThreadsC);
    if (col < D)
      for (int r = warp; r < rows; r += kThreadsC / 32) {
        float a0 = 0.0f, a1 = 0.0f;
        for (int s = 0; s < S; ++s) {
          const float w = lw[s * rows + r];
          const float2 x = *reinterpret_cast<const float2*>(o_s + (s * rows + r) * D + col);
          a0 = fmaf(w, x.x, a0);
          a1 = fmaf(w, x.y, a1);
        }
        const bool seen = lse[r] != -CUDART_INF_F;
        *reinterpret_cast<__nv_bfloat162*>(og + r * D + col) =
            __floats2bfloat162_rn(seen ? a0 : 0.0f, seen ? a1 : 0.0f);
      }
    if (p.lse != nullptr)
      for (int r = tid; r < rows; r += kThreadsC) p.lse[bh * Tq + q0 + r] = lse[r];
    return;
  }
  // more than the ring holds: a warp a row, reading the partials from L2
  for (int r = warp; r < rows; r += kThreadsC / 32) {
    float mx = -CUDART_INF_F;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, __ldcg(ls + s * Tq + r));
    float total = -CUDART_INF_F;
    if (mx != -CUDART_INF_F) {
      float sum = 0.0f;
      for (int s = 0; s < S; ++s) sum += expf(__ldcg(ls + s * Tq + r) - mx);
      total = mx + logf(sum);
    }
    if (col < D) {
      float a0 = 0.0f, a1 = 0.0f;
      if (total != -CUDART_INF_F)
        for (int s = 0; s < S; ++s) {
          const float w = expf(__ldcg(ls + s * Tq + r) - total);
          const float2 x = __ldcg(reinterpret_cast<const float2*>(os + (s * Tq + r) * D + col));
          a0 = fmaf(w, x.x, a0);
          a1 = fmaf(w, x.y, a1);
        }
      *reinterpret_cast<__nv_bfloat162*>(og + r * D + col) = __floats2bfloat162_rn(a0, a1);
    }
    if (p.lse != nullptr && lane == 0) p.lse[bh * Tq + q0 + r] = total;
  }
}

// floor(a / d) for d > 0
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t d) {
  return a >= 0 ? a / d : -((d - 1 - a) / d);
}

// The thread's lane and the block's x index, read from the special
// registers where they are used (volatile: not kept in a register from an
// earlier read)
__device__ __forceinline__ int lane_now() {
  unsigned v;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(v));
  return static_cast<int>(v);
}
__device__ __forceinline__ unsigned block_x() {
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  return v;
}

// Width up to 64: the first of the two query rows (it and 8 below) of this
// consumer thread of a block of kRows rows (flash_attention_d64_kernel)
template <int kRows>
__device__ __forceinline__ int64_t d64_row0(const D64Params& p) {
  unsigned tid, nbx;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  asm volatile("mov.u32 %0, %%nctaid.x;\n" : "=r"(nbx));
  const int64_t n_rb = nbx / p.splits;
  return (n_rb - 1 - block_x() / p.splits) * kRows + (tid / 128) * kBM + ((tid / 32) & 3) * 16 +
         (tid & 31) / 4;
}

// Width 64 or less: a producer warpgroup and NC consumer warpgroups (see the
// top of the file).  SPLIT: the call cuts its keys into ranges, and the
// blocks merge them (merge_ranges).
template <int NC, bool SPLIT>
__global__ void __launch_bounds__(d64::Cfg<NC>::kThreads, 1)
flash_attention_d64_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const D64Params p) {
  using namespace d64;
  using C = d64::Cfg<NC>;
  constexpr int kNC = C::kNC, kRows = C::kRows, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                               // kNC q tiles
  uint8_t* ks = qs + kNC * kQBytes;                 // kStages k tiles
  uint8_t* vs = ks + kStages * kKVBytes;            // kStages v tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * kKVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int split = static_cast<int>(blockIdx.x % p.splits);
  const int64_t n_rb = gridDim.x / p.splits;
  const int64_t q0 = (n_rb - 1 - blockIdx.x / p.splits) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int64_t rows_end = q0 + kRows < p.Tq ? q0 + kRows : p.Tq;
  const TileRange tr = tile_range<kKeys>(p, q0, rows_end, split);
  const int n_tiles = tr.n;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kNC * 4);   // lane 0 of every consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kNC) {
    // ---- producer: one thread keeps the ring full
    regs_dealloc<C::kProducerRegs>();
    if (tid == kNC * 128) {
      mbar_expect_tx(qbar, kNC * kQBytes);
      for (int c = 0; c < kNC; ++c)
        tma_load(qs + c * kQBytes, &qmap, qbar, 0, static_cast<int>(q0 + c * kBM), h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kKVBytes);
        const int kt = static_cast<int>(tr.begin + static_cast<int64_t>(t) * kKeys);
        tma_load(ks + s * kKVBytes, &kmap, &full[s], 0, kt, hk, b);
        tma_load(vs + s * kKVBytes, &vmap, &full[s], 0, kt, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + wg * 64 ... + 63
    regs_alloc<C::kConsumerRegs>();
    // The tile loop keeps the softmax's state, the tile range and the
    // bounds of the tiles every row of the warpgroup sees whole; a masked
    // tile and the store read the thread's row and the block's indices
    // again (d64_row0, volatile), so that no register holds them across
    // the loop (at NC = 3 a thread has 128, see Cfg).
    const int lane = tid & 31;
    const uint32_t q_base = smem_u32(qs + wg * kQBytes);
    const float f = p.has_softcap ? 1.0f : p.scale_log2;
    int live_lo, live_hi;   // tiles [live_lo, live_hi) are live for every row
    {
      const int64_t wq0 = q0 + wg * kBM;
      const int64_t qa = p.q_offset + wq0;
      const int64_t qb = p.q_offset + (wq0 + kBM < p.Tq ? wq0 + kBM : p.Tq) - 1;
      int64_t hi = floor_div(p.Tk - tr.begin, kKeys);
      if (p.causal) {
        const int64_t c = floor_div(qa - tr.begin + 1, kKeys);
        hi = c < hi ? c : hi;
      }
      const int64_t lo = p.has_window ? floor_div(qb - p.window - tr.begin, kKeys) + 1 : 0;
      const auto tiles = [&](int64_t x) {
        return static_cast<int>(x < 0 ? 0 : (x > n_tiles ? n_tiles : x));
      };
      live_lo = tiles(lo);
      live_hi = tiles(hi);
    }
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
    float l0 = 0.0f, l1 = 0.0f;
    float o[1][32];
    float sc[64];
    uint32_t phi[8][4], plo[8][4];   // P's bf16 hi and lo parts
#pragma unroll
    for (int i = 0; i < 32; ++i) o[0][i] = 0.0f;
    // S = q k^T with the k tile in stage st (q's address opaque, so that
    // its four descriptors are not held in registers across the loop)
    auto issue_s = [&](int st) {
      const uint32_t q_base_t = opaque(q_base);
      const uint32_t k_base = smem_u32(ks + st * kKVBytes);
      wgmma_ss_n128_first(sc, desc(q_base_t), desc(k_base));
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)
        wgmma_ss_n128(sc, desc(q_base_t + kk * 32), desc(k_base + kk * 32), 1);
    };
    // O += P_hi V + P_lo V with the v tile in stage st
    auto issue_pv = [&](int st) {
      const uint32_t v_base = smem_u32(vs + st * kKVBytes);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = desc(v_base + kk * 16 * 128);
        wgmma_rs(o[0], phi[kk], dv, 1);
        wgmma_rs(o[0], plo[kk], dv, 1);
      }
    };
    auto fence_pv = [&]() {
      reg_fence(o[0]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        reg_fence(phi[kk]);
        reg_fence(plo[kk]);
      }
    };
    // this warp has finished reading stage st
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    float alpha0, alpha1;
    auto softmax = [&](int t) {
      softmax_tile<64>(
          sc, p, t >= live_lo && t < live_hi,
          [&](float(&s)[64]) {
            const int64_t pos0 = p.q_offset + d64_row0<kRows>(p);
            mask_tile(s, p, tr.begin + static_cast<int64_t>(t) * kKeys, pos0, pos0 + 8,
                      (lane_now() & 3) * 2);
          },
          f, m0, m1, l0, l1, alpha0, alpha1);
    };

    // Ping-pong: named barrier 1 + w is consumer w's turn at the tensor
    // cores, passed on to consumer w + 1 (mod NC).  In its turn a consumer
    // runs the previous tile's P V, waits, issues this tile's S and passes
    // the turn; the next consumer's products then run while this one waits
    // for S and runs its softmax.  Every consumer takes n_tiles + 1 turns;
    // the last one starts by passing the first turn to consumer 0 and does
    // not pass its own last one, so every arrival is waited for.  Every
    // wgmma is issued on a path without branches (tile 0's S alone, the
    // last P V alone), and P V ends before S starts, so S can take the
    // registers P leaves: the accumulator, S and P (160 registers a thread
    // in two parts) are never all live at once.
    const int mine = 1 + wg;
    const int other = 1 + (wg + 1) % NC;
    mbar_wait(qbar, 0);
    if (n_tiles > 0) {
      if (NC > 1 && wg == NC - 1) bar_arrive(other, 2 * 128);
      mbar_wait(&full[0], 0);
      if (NC > 1) bar_sync(mine, 2 * 128);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      if (NC > 1) bar_arrive(other, 2 * 128);
      wgmma_wait_all();
      reg_fence(sc);
      softmax(0);
      split_p(sc, phi, plo);
      PHASE_START
      for (int t = 1; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int sp = (t - 1) % kStages;   // the stage of tile t - 1
        PHASE_TURN
        mbar_wait(&full[s], (t / kStages) & 1);
        PHASE(0)
        if (NC > 1) bar_sync(mine, 2 * 128);
        PHASE(1)
        fence_pv();
        wgmma_fence();
        issue_pv(sp);
        wgmma_commit();
        PHASE(2)
        wgmma_wait_all();
        PHASE(3)
        fence_pv();
        release(sp);
        wgmma_fence();
        issue_s(s);
        wgmma_commit();
        if (NC > 1) bar_arrive(other, 2 * 128);
        PHASE(2)
        wgmma_wait_all();
        PHASE(4)
        reg_fence(sc);
        softmax(t);
        // alpha is 1 on most tiles (the reference point moves rarely); the
        // multiply costs less than a branch
#pragma unroll
        for (int i = 0; i < 32; ++i) o[0][i] *= (i & 2) ? alpha1 : alpha0;
        PHASE(5)
        split_p(sc, phi, plo);
        PHASE(6)
      }
      PHASE_END(SPLIT ? 2 : 1)
      const int sp = (n_tiles - 1) % kStages;
      if (NC > 1) bar_sync(mine, 2 * 128);
      fence_pv();
      wgmma_fence();
      issue_pv(sp);
      wgmma_commit();
      if (NC > 1 && wg != NC - 1) bar_arrive(other, 2 * 128);
      wgmma_wait_all();
      fence_pv();
      release(sp);
    }
    unsigned by, bz;
    asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(by));
    asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(bz));
    const int ln = lane_now();
    store_rows(p, o, l0, l1, m0, m1, f, static_cast<int>(bz), static_cast<int>(by),
               SPLIT ? static_cast<int>(block_x() % p.splits) : 0, d64_row0<kRows>(p),
               (ln & 3) * 2, ln);
    if constexpr (SPLIT) merge_ranges<NC>(p);
  }
}

// ---------------------------------------------------------------------------
// Head widths 65-128 (danube's 120, olmo's 128): a producer warpgroup and
// two consumer warpgroups of 64 query rows, 128-key tiles of the head's two
// 64-column atoms.
// ---------------------------------------------------------------------------

namespace d128 {
constexpr int kKeys = 128;                     // keys a tile
constexpr int kNB = 2;                         // 64-column atoms of the head
constexpr int kQBytes = kBM * kNB * kAtom * 2;     // one consumer's q tile, atom nb at 8 KB nb
constexpr int kKVBytes = kKeys * kNB * kAtom * 2;  // one k (or v) tile, atom nb at 16 KB nb
constexpr int kConsumers = 2;
constexpr int kRows = kConsumers * kBM;        // query rows a block
constexpr int kThreads = 128 * (kConsumers + 1);
// setmaxnreg: 24 + 2 x 240 is the 3 x 168 a thread the launch allocates
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 3;
constexpr int kSmem = 1024 + kConsumers * kQBytes + 2 * kStages * kKVBytes + 8 * (2 * kStages + 1);
static_assert(kSmem <= 232448, "over the 227 KB a block may use");
}  // namespace d128

// Width 65-128: a producer warpgroup and two consumer warpgroups (see the
// top of the file).  The softcap is a template argument; D64Params carries
// the call (no key splits).  The blocks walk the rows last rows first.
template <bool CAP>
__global__ void __launch_bounds__(d128::kThreads, 1)
flash_attention_d128_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, const D64Params p) {
  using namespace d128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                               // kConsumers q tiles
  uint8_t* ks = qs + kConsumers * kQBytes;          // kStages k tiles
  uint8_t* vs = ks + kStages * kKVBytes;            // kStages v tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * kKVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x;
  // the role of this thread's warpgroup, the same in every lane
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // the last query rows see the most keys: start them first
  const int64_t last = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x);
  const int64_t q0 = last * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int64_t rows_end = q0 + kRows < p.Tq ? q0 + kRows : p.Tq;
  const TileRange tr = tile_range<kKeys>(p, q0, rows_end, 0);
  const int n_tiles = tr.n;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);   // lane 0 of every consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full
    regs_dealloc<kProducerRegs>();
    if (tid == kConsumers * 128) {
      mbar_expect_tx(qbar, kConsumers * kQBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int nb = 0; nb < kNB; ++nb)
          tma_load(qs + c * kQBytes + nb * kBM * 128, &qmap, qbar, nb * kAtom,
                   static_cast<int>(q0 + c * kBM), h, b);
      int s = 0;
      uint32_t phase = 0;
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= kStages) mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], 2 * kKVBytes);
        const int kt = static_cast<int>(tr.begin) + t * kKeys;
        for (int nb = 0; nb < kNB; ++nb) {
          tma_load(ks + s * kKVBytes + nb * kKeys * 128, &kmap, &full[s], nb * kAtom, kt, hk, b);
          tma_load(vs + s * kKVBytes + nb * kKeys * 128, &vmap, &full[s], nb * kAtom, kt, hk, b);
        }
        if (++s == kStages) { s = 0; phase ^= 1; }
      }
    }
    return;
  }
  regs_alloc<kConsumerRegs>();

  // ---- consumer warpgroup wg: query rows q0 + wg * 64 ... + 63
  const int lane = tid & 31;
  const int warp = (tid / 32) & 3;
  const int r0 = warp * 16 + lane / 4;
  const int c2 = (lane & 3) * 2;
  const int64_t wq0 = q0 + wg * kBM;
  const int64_t qa = p.q_offset + wq0;
  const int64_t qb = p.q_offset + (wq0 + kBM < p.Tq ? wq0 + kBM : p.Tq) - 1;
  const int64_t pos0 = qa + r0;
  const int64_t pos1 = pos0 + 8;
  const uint32_t q_base = smem_u32(qs + wg * kQBytes);
  const float f = CAP ? 1.0f : p.scale_log2;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.0f, l1 = 0.0f;
  float o[kNB][32];
  float sc[64];
  uint32_t phi[8][4], plo[8][4];   // P's bf16 hi and lo parts
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.0f;
  // S = q k^T over the head's two atoms with the k tile in stage st
  auto issue_s = [&](int st) {
    const uint32_t k_base = smem_u32(ks + st * kKVBytes);
    const uint32_t q_base_t = opaque(q_base);
    wgmma_ss_n128_first(sc, desc(q_base_t), desc(k_base));
#pragma unroll
    for (int kk = 1; kk < 8; ++kk)
      wgmma_ss_n128(sc, desc(q_base_t + (kk / 4) * kBM * 128 + (kk % 4) * 32),
                    desc(k_base + (kk / 4) * kKeys * 128 + (kk % 4) * 32), 1);
  };
  // O += P_hi V + P_lo V with the v tile in stage st, atom by atom
  auto issue_pv = [&](int st) {
    const uint32_t v_base = smem_u32(vs + st * kKVBytes);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = desc(v_base + nb * kKeys * 128 + kk * 16 * 128);
        wgmma_rs(o[nb], phi[kk], dv, 1);
        wgmma_rs(o[nb], plo[kk], dv, 1);
      }
  };
  auto fence_pv = [&]() {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) reg_fence(o[nb]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      reg_fence(phi[kk]);
      reg_fence(plo[kk]);
    }
  };
  // this warp has finished reading stage st
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  float alpha0, alpha1;
  auto softmax = [&](int t) {
    online_softmax<64, CAP>(sc, p, tr.begin + static_cast<int64_t>(t) * kKeys, qa, qb, pos0, pos1,
                            c2, f, m0, m1, l0, l1, alpha0, alpha1);
  };
  // 64 multiplies a thread: skipped where no row of the warp moved its
  // reference point (most tiles), a branch the whole warp takes alike
  auto rescale = [&]() {
    if (!__any_sync(0xffffffffu, alpha0 != 1.0f || alpha1 != 1.0f)) return;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] *= (i & 2) ? alpha1 : alpha0;
  };

  // Ping-pong, as flash_attention_d64_kernel's: named barrier 1 + w is
  // consumer w's turn at the tensor cores.  In its turn a consumer runs the
  // previous tile's P V, waits, then issues this tile's S, passes the turn
  // and waits for it (see the top of the file).
  const int mine = 1 + wg;
  const int other = 1 + (wg ^ 1);
  mbar_wait(qbar, 0);
  if (n_tiles > 0) {
    if (wg == kConsumers - 1) bar_arrive(other, kConsumers * 128);
    mbar_wait(&full[0], 0);
    bar_sync(mine, kConsumers * 128);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    bar_arrive(other, kConsumers * 128);
    wgmma_wait_all();
    reg_fence(sc);
    softmax(0);
    split_p(sc, phi, plo);
    int s = 0, sp = 0;
    uint32_t phase = 0;
    PHASE_START
#pragma unroll 1
    for (int t = 1; t < n_tiles; ++t) {
      sp = s;                                 // the stage of tile t - 1
      if (++s == kStages) { s = 0; phase ^= 1; }
      PHASE_TURN
      mbar_wait(&full[s], phase);
      PHASE(0)
      bar_sync(mine, kConsumers * 128);
      PHASE(1)
      fence_pv();
      wgmma_fence();
      issue_pv(sp);
      wgmma_commit();
      PHASE(2)
      wgmma_wait_all();
      PHASE(3)
      fence_pv();
      release(sp);
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      bar_arrive(other, kConsumers * 128);
      PHASE(2)
      wgmma_wait_all();
      PHASE(4)
      reg_fence(sc);
      softmax(t);
      rescale();
      PHASE(5)
      split_p(sc, phi, plo);
      PHASE(6)
    }
    PHASE_END(0)
    bar_sync(mine, kConsumers * 128);
    fence_pv();
    wgmma_fence();
    issue_pv(s);
    wgmma_commit();
    if (wg != kConsumers - 1) bar_arrive(other, kConsumers * 128);
    wgmma_wait_all();
    fence_pv();
    release(s);
  }
  store_rows(p, o, l0, l1, m0, m1, f, b, h, 0, wq0 + r0, c2, lane);
}

// ---------------------------------------------------------------------------
// Head widths 136-256 (recurrentgemma's 256): two consumer warpgroups of 64
// query rows that take turns at the tensor cores, 64-key tiles of the
// head's four 64-column atoms, k and v in rings of their own.
// ---------------------------------------------------------------------------

namespace d256 {
constexpr int kKeys = 64;                          // keys a tile
constexpr int kNB = 4;                             // 64-column atoms of the head
constexpr int kAtomBytes = kKeys * 128;            // one atom of a 64-row tile
constexpr int kTileBytes = kNB * kAtomBytes;       // a consumer's q tile, a k or a v tile
constexpr int kConsumers = 2;
// query rows a block: the consumers' 64 each of one head, or (an even
// group) 64 rows of two query heads, the same (row, head) pairs a block
constexpr int kRows = kConsumers * kBM;
constexpr int kThreads = 128 * kConsumers;
constexpr int kStagesK = 2;
constexpr int kStagesV = 3;
constexpr int kBuffers = kConsumers + kStagesK + kStagesV;
constexpr int kSmem = 1024 + kBuffers * kTileBytes + 8 * (2 * (kStagesK + kStagesV) + 1);
static_assert(kBM == kKeys, "q, k and v tiles share one layout");
static_assert(kSmem <= 232448, "over the 227 KB a block may use");
}  // namespace d256

// Width 136-256: two consumer warpgroups and no producer (see the top of
// the file).  The softcap is a template argument; D64Params carries the
// call (no key splits).
template <bool CAP>
__global__ void __launch_bounds__(d256::kThreads, 1)
flash_attention_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, const D64Params p) {
  using namespace d256;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                               // kConsumers q tiles
  uint8_t* ks = qs + kConsumers * kTileBytes;       // kStagesK k tiles
  uint8_t* vs = ks + kStagesK * kTileBytes;         // kStagesV v tiles
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vs + kStagesV * kTileBytes);
  uint64_t* kempty = kfull + kStagesK;
  uint64_t* vfull = kempty + kStagesK;
  uint64_t* vempty = vfull + kStagesV;
  uint64_t* qbar = vempty + kStagesV;

  const int tid = threadIdx.x;
  // the warpgroup of this thread, the same in every lane
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // An even group: the consumers take the same 64 rows of two query heads
  // of one kv head, so that each k and v tile serves both (half the k and
  // v bytes a flop of the other layout, where they take 64 rows each of
  // one head)
  const bool pair = p.group % 2 == 0;
  const int rows = pair ? kBM : kRows;
  // the last query rows see the most keys: start them first
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * rows;
  const int h0 = pair ? 2 * blockIdx.y : blockIdx.y;   // the block's first query head
  const int b = blockIdx.z;
  const int hk = h0 / p.group;
  const int64_t rows_end = q0 + rows < p.Tq ? q0 + rows : p.Tq;
  const TileRange tr = tile_range<kKeys>(p, q0, rows_end, 0);
  const int n_tiles = tr.n;
  // the head's atoms that hold a column below D: TMA loads only these, and
  // the others of every buffer are zeroed once here (they add nothing to S)
  const int na = static_cast<int>((p.D + kAtom - 1) / kAtom);
  if (na < kNB) {
    const int words = (kNB - na) * kAtomBytes / 16;   // 16-byte words a buffer
    for (int i = tid; i < kBuffers * words; i += kThreads)
      reinterpret_cast<uint4*>(qs + (i / words) * kTileBytes + na * kAtomBytes)[i % words] =
          make_uint4(0u, 0u, 0u, 0u);
    fence_async_shared();
  }

  if (tid == 0) {
    for (int s = 0; s < kStagesK; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], kConsumers * 4);   // lane 0 of every warp
    }
    for (int s = 0; s < kStagesV; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], kConsumers * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // k (or v) tile t into its stage of the k (v) ring
  auto issue = [&](uint8_t* ring, const CUtensorMap* map, uint64_t* full, int stages, int t) {
    const int s = t % stages;
    mbar_expect_tx(&full[s], na * kAtomBytes);
    const int kt = static_cast<int>(tr.begin) + t * kKeys;
    for (int nb = 0; nb < na; ++nb)
      tma_load(ring + s * kTileBytes + nb * kAtomBytes, map, &full[s], nb * kAtom, kt, hk, b);
  };
  int next_k = kStagesK < n_tiles ? kStagesK : n_tiles;   // thread 0: the next tiles to issue
  int next_v = kStagesV < n_tiles ? kStagesV : n_tiles;
  if (tid == 0) {
    mbar_expect_tx(qbar, kConsumers * na * kAtomBytes);
    for (int c = 0; c < kConsumers; ++c)
      for (int nb = 0; nb < na; ++nb)
        tma_load(qs + c * kTileBytes + nb * kAtomBytes, &qmap, qbar, nb * kAtom,
                 static_cast<int>(pair ? q0 : q0 + c * kBM), pair ? h0 + c : h0, b);
    for (int t = 0; t < next_k; ++t) issue(ks, &kmap, kfull, kStagesK, t);
    for (int t = 0; t < next_v; ++t) issue(vs, &vmap, vfull, kStagesV, t);
  }
  // thread 0: issue every later k and v tile whose stage both warpgroups
  // have released, waiting only for the stage of a tile its warpgroup
  // needs next (k of tile need_k, v of need_v), which the turns have
  // released by then: a wait never holds for long, and none can hang
  auto refill_ring = [&](uint8_t* ring, const CUtensorMap* map, uint64_t* full,
                         uint64_t* empty, int stages, int& next, int need) {
    for (; next < n_tiles; ++next) {
      const int prev = next - stages;   // the last tile in next's stage
      uint64_t* bar = &empty[prev % stages];
      const uint32_t ph = (prev / stages) & 1;
      if (!mbar_test(bar, ph)) {
        if (next > need) break;
        mbar_wait(bar, ph);
      }
      issue(ring, map, full, stages, next);
    }
  };
  auto refill = [&](int need_k, int need_v) {
    if (tid != 0) return;
    refill_ring(ks, &kmap, kfull, kempty, kStagesK, next_k, need_k);
    refill_ring(vs, &vmap, vfull, vempty, kStagesV, next_v, need_v);
  };

  // ---- consumer warpgroup wg: query rows wq0 ... wq0 + 63 of head h
  const int lane = tid & 31;
  const int warp = (tid / 32) & 3;
  const int r0 = warp * 16 + lane / 4;
  const int c2 = (lane & 3) * 2;
  const int64_t wq0 = pair ? q0 : q0 + wg * kBM;
  const int h = pair ? h0 + wg : h0;
  const int64_t qa = p.q_offset + wq0;
  const int64_t qb = p.q_offset + (wq0 + kBM < p.Tq ? wq0 + kBM : p.Tq) - 1;
  const int64_t pos0 = qa + r0;
  const int64_t pos1 = pos0 + 8;
  const uint32_t q_base = smem_u32(qs + wg * kTileBytes);
  const float f = CAP ? 1.0f : p.scale_log2;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.0f, l1 = 0.0f;
  float o[kNB][32];
  float sc[32];
  uint32_t phi[4][4], plo[4][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.0f;
  // S = q k^T over the head's four atoms with the k tile in stage st
  auto issue_s = [&](int st) {
    const uint32_t k_base = smem_u32(ks + st * kTileBytes);
    const uint32_t q_base_t = opaque(q_base);
    wgmma_ss_first(sc, desc(q_base_t), desc(k_base));
#pragma unroll
    for (int kk = 1; kk < 4 * kNB; ++kk) {
      const uint32_t off = (kk / 4) * kAtomBytes + (kk % 4) * 32;
      wgmma_ss(sc, desc(q_base_t + off), desc(k_base + off), 1);
    }
  };
  // O += P_hi V + P_lo V with the v tile in stage st, atom by atom
  auto issue_pv = [&](int st) {
    const uint32_t v_base = smem_u32(vs + st * kTileBytes);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc(v_base + nb * kAtomBytes + kk * 16 * 128);
        wgmma_rs(o[nb], phi[kk], dv, 1);
        wgmma_rs(o[nb], plo[kk], dv, 1);
      }
  };
  auto fence_pv = [&]() {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) reg_fence(o[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      reg_fence(phi[kk]);
      reg_fence(plo[kk]);
    }
  };
  // this warp has finished reading stage st of a ring
  auto release = [&](uint64_t* empty, int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  float alpha0, alpha1;
  auto softmax = [&](int t) {
    online_softmax<32, CAP>(sc, p, tr.begin + static_cast<int64_t>(t) * kKeys, qa, qb, pos0,
                            pos1, c2, f, m0, m1, l0, l1, alpha0, alpha1);
  };
  // 128 multiplies a thread: skipped where no row of the warp moved its
  // reference point (most tiles), a branch the whole warp takes alike
  auto rescale = [&]() {
    if (!__any_sync(0xffffffffu, alpha0 != 1.0f || alpha1 != 1.0f)) return;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] *= (i & 2) ? alpha1 : alpha0;
  };

  // Turns, as flash_attention_d128_kernel's (named barrier 1 + w is
  // consumer w's), but in its turn a consumer issues the previous tile's
  // P V and this tile's S together and waits for both after passing the
  // turn: at 256 threads the accumulator (128 registers), the two P parts
  // (32) and S (32) fit the 255 a thread ptxas plans for.
  const int mine = 1 + wg;
  const int other = 1 + (wg ^ 1);
  mbar_wait(qbar, 0);
  if (n_tiles > 0) {
    if (wg == kConsumers - 1) bar_arrive(other, kThreads);
    mbar_wait(&kfull[0], 0);
    bar_sync(mine, kThreads);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    bar_arrive(other, kThreads);
    refill(1, 0);
    __syncwarp();
    wgmma_wait_all();
    reg_fence(sc);
    release(kempty, 0);
    softmax(0);
    split_p(sc, phi, plo);
    int sk = 0, sv = 0;            // the k stage of tile t, the v stage of tile t - 1
    uint32_t phk = 0, phv = 0;
#pragma unroll 1
    for (int t = 1; t < n_tiles; ++t) {
      if (++sk == kStagesK) { sk = 0; phk ^= 1; }
      mbar_wait(&vfull[sv], phv);
      mbar_wait(&kfull[sk], phk);
      bar_sync(mine, kThreads);
      fence_pv();
      wgmma_fence();
      issue_pv(sv);
      issue_s(sk);
      wgmma_commit();
      bar_arrive(other, kThreads);
      refill(t + 1, t);
      __syncwarp();
      wgmma_wait_all();
      fence_pv();
      reg_fence(sc);
      release(vempty, sv);
      release(kempty, sk);
      if (++sv == kStagesV) { sv = 0; phv ^= 1; }
      softmax(t);
      rescale();
      split_p(sc, phi, plo);
    }
    mbar_wait(&vfull[sv], phv);
    bar_sync(mine, kThreads);
    fence_pv();
    wgmma_fence();
    issue_pv(sv);
    wgmma_commit();
    if (wg != kConsumers - 1) bar_arrive(other, kThreads);
    wgmma_wait_all();
    fence_pv();
    release(vempty, sv);
  }
  store_rows(p, o, l0, l1, m0, m1, f, b, h, 0, wq0 + r0, c2, lane);
}

template <typename Kernel>
int configure(Kernel kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <bool CAP>
int launch_d128(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                const D64Params& p, int64_t B, cudaStream_t stream) {
  static bool configured = false;   // the attribute is per kernel, set once
  if (!configured) {
    const int err = configure(flash_attention_d128_kernel<CAP>, d128::kSmem);
    if (err != 0) return err;
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>((p.Tq + d128::kRows - 1) / d128::kRows),
                  static_cast<unsigned>(p.Hq), static_cast<unsigned>(B));
  flash_attention_d128_kernel<CAP><<<grid, d128::kThreads, d128::kSmem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool CAP>
int launch_d256(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                const D64Params& p, int64_t B, cudaStream_t stream) {
  static bool configured = false;   // the attribute is per kernel, set once
  if (!configured) {
    const int err = configure(flash_attention_d256_kernel<CAP>, d256::kSmem);
    if (err != 0) return err;
    configured = true;
  }
  // an even group: 64 rows of two query heads a block, else 128 rows of one
  const bool pair = p.group % 2 == 0;
  const int64_t rows = pair ? kBM : d256::kRows;
  const dim3 grid(static_cast<unsigned>((p.Tq + rows - 1) / rows),
                  static_cast<unsigned>(pair ? p.Hq / 2 : p.Hq), static_cast<unsigned>(B));
  flash_attention_d256_kernel<CAP><<<grid, d256::kThreads, d256::kSmem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, bool SPLIT>
int launch_d64(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
               const D64Params& p, int64_t B, cudaStream_t stream) {
  using C = d64::Cfg<NC>;
  static bool configured = false;   // the attribute is per kernel, set once
  if (!configured) {
    const int err = configure(flash_attention_d64_kernel<NC, SPLIT>, C::kSmem);
    if (err != 0) return err;
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>((p.Tq + C::kRows - 1) / C::kRows * p.splits),
                  static_cast<unsigned>(p.Hq), static_cast<unsigned>(B));
  flash_attention_d64_kernel<NC, SPLIT><<<grid, C::kThreads, C::kSmem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, Tq, D), k and v: (B, Hkv, Tk, D), bfloat16, each with unit
// stride in D and the given strides (in elements) in its first three
// dimensions, every base address and stride a multiple of 16 bytes; o:
// contiguous (B, Hq, Tq, D) bfloat16.  8 <= D <= 256 with D a multiple of
// 8, Hq a multiple of Hkv, Tk >= 1.  lse: contiguous float32 (B, Hq, Tq)
// for each row's log-sum-exp (-inf where a row sees no key), or null.
// splits: 1, or S > 1 ranges of the keys, range s starting split_lo +
// 512 floor(s split_chunks / S) (split_chunks >= S), the last one running
// to Tk; then o_part (B, Hq, S, Tq, D) and lse_part (B, Hq, S, Tq), both
// contiguous float32, take each range's output, and the same launch merges
// them into o (and lse), counting arrivals in `arrivals`: B Hq ceil(Tq /
// rows) zeroed uint32, zero again when the launch ends, used by no other
// launch in flight.  rows: the query rows a block, 64, 128 or 192 at D <= 64
// (64 exactly when Tq <= 64: flash_attention_sm90.py::block_rows picks
// them), 128 above.
// Launches on `stream`; returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for arguments the kernel does not
// take or a tensor map CUDA refuses).
// The caller checks shapes, types and devices.
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                        int64_t B, int64_t Hq, int64_t Hkv, int64_t Tq,
                                        int64_t Tk, int64_t D, int64_t q_sb, int64_t q_sh,
                                        int64_t q_st, int64_t k_sb, int64_t k_sh, int64_t k_st,
                                        int64_t v_sb, int64_t v_sh, int64_t v_st, int causal,
                                        int has_window, int64_t window, int64_t q_offset,
                                        int has_softcap, float softcap, float scale,
                                        void* lse, int64_t splits, int64_t split_lo,
                                        int64_t split_chunks, void* o_part, void* lse_part,
                                        void* arrivals, int64_t rows, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (D < 8 || D > 256 || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 ||
      Tk < 1 || Tq > 0x7fffffff || Tk > 0x7fffffff || splits < 1 || splits > 65535)
    return static_cast<int>(bad);
  if (splits > 1 && (o_part == nullptr || lse_part == nullptr || arrivals == nullptr ||
                     split_chunks < splits ||
                     split_lo < 0 || split_lo % kSplitKeys != 0 ||
                     splits * split_chunks > 0x7fffffff))
    return static_cast<int>(bad);
  if (D <= 64 ? (rows != 64 && rows != 128 && rows != 192) || (rows == 64) != (Tq <= kBM)
              : rows != 128)
    return static_cast<int>(bad);
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  const int64_t DP = (D + 63) / 64 * 64;
  if (DP > 64 && splits > 1) return static_cast<int>(bad);   // split keys at D <= 64 only
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap qm, km, vm;
  const int kv_rows = DP == 64 ? d64::kKeys : (DP == 128 ? d128::kKeys : d256::kKeys);
  if (!make_map(&qm, q, D, Tq, Hq, B, q_st, q_sh, q_sb, kBM) ||
      !make_map(&km, k, D, Tk, Hkv, B, k_st, k_sh, k_sb, kv_rows) ||
      !make_map(&vm, v, D, Tk, Hkv, B, v_st, v_sh, v_sb, kv_rows))
    return static_cast<int>(bad);
  D64Params p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.o_part = splits > 1 ? static_cast<float*>(o_part) : nullptr;
  p.lse_part = splits > 1 ? static_cast<float*>(lse_part) : nullptr;
  p.Hq = Hq; p.Tq = Tq; p.Tk = Tk; p.D = D; p.group = static_cast<int>(Hq / Hkv);
  p.window = window; p.q_offset = q_offset;
  p.splits = static_cast<int>(splits);
  p.split_lo = splits > 1 ? split_lo : 0;
  p.split_chunks = splits > 1 ? static_cast<int>(split_chunks) : 0;
  p.causal = causal; p.has_window = has_window; p.has_softcap = has_softcap;
  p.softcap = softcap; p.scale = scale; p.scale_log2 = scale * kLog2e;
  p.cap_scale = has_softcap ? scale / softcap : 0.0f;
  p.arrivals = splits > 1 ? static_cast<unsigned*>(arrivals) : nullptr;
  if (DP > 128)
    return has_softcap ? launch_d256<true>(qm, km, vm, p, B, s) : launch_d256<false>(qm, km, vm, p, B, s);
  if (DP == 128)
    return has_softcap ? launch_d128<true>(qm, km, vm, p, B, s) : launch_d128<false>(qm, km, vm, p, B, s);
  // one, two or three consumer warpgroups a block
  if (rows == d64::Cfg<1>::kRows)
    return splits > 1 ? launch_d64<1, true>(qm, km, vm, p, B, s)
                      : launch_d64<1, false>(qm, km, vm, p, B, s);
  if (rows == d64::Cfg<3>::kRows)
    return splits > 1 ? launch_d64<3, true>(qm, km, vm, p, B, s)
                      : launch_d64<3, false>(qm, km, vm, p, B, s);
  return splits > 1 ? launch_d64<2, true>(qm, km, vm, p, B, s)
                    : launch_d64<2, false>(qm, km, vm, p, B, s);
}

#ifdef FLASH_PHASE_CLOCKS
// the kernels' phase clocks (kFwdPasses x kFwdPhases) into out, or zeroed
// when out is null
extern "C" int flash_fwd_sm90_phase_clocks_read(unsigned long long* out) {
  if (out == nullptr) {
    const unsigned long long zero[kFwdPasses][kFwdPhases] = {};
    return static_cast<int>(cudaMemcpyToSymbol(flash_fwd_sm90_phase_clocks, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, flash_fwd_sm90_phase_clocks,
                                               sizeof(flash_fwd_sm90_phase_clocks)));
}
#endif
