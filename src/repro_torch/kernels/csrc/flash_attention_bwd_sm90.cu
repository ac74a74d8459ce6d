// GQA online-softmax (flash) attention, backward, for bfloat16 q, k, v, o
// and do on Hopper's tensor cores: the gradients of
//
//   o[b, h, i] = sum_j p_ij v[b, h / G, j],   p_ij = exp(s_ij - lse_i),
//   s_ij = D^-0.5 (q[b, h, i] . k[b, h / G, j]), optionally c tanh(s / c),
//
// over the live keys j of row i (j < Tk, causal j <= qpos, window
// j > qpos - window, qpos = q_offset + i), given the forward's output o and
// its row log-sum-exp lse (natural log, float32, -inf for a row with no live
// key):
//
//   delta_i = sum_d do_id o_id,  dp_ij = do_i . v_j,
//   ds_ij = p_ij (dp_ij - delta_i)  (times 1 - (s_ij / c)^2 under a softcap),
//   dq_i = D^-0.5 sum_j ds_ij k_j,  dk_j = D^-0.5 sum_i ds_ij q_i,  dv_j = sum_i p_ij do_i,
//
// dk and dv summed over the G query heads of each kv head.  The gradients
// come out in bfloat16; every sum is float32.
//
// Replaces no TPU kernel: repro/kernels/flash_attention.py is forward only,
// and the reference trains through its jnp twin, whose gradient jax.grad
// takes (repro/models/layers.py _blockwise_attention, :159).  This kernel is
// that gradient on the card for bfloat16 inputs, for every attention over
// more than 4096 kv positions in a training step; float32 inputs go to
// csrc/flash_attention_bwd.cu.  Its plain version is
// kernels/ref.py::ref_flash_attention_backward.
//
// Bound: operations.  The gradients need 8 D flops a live (query, key) pair
// (dP, dV, dK, dQ), 10 D with S recomputed; against a few bytes of q, k, v,
// o, do and the gradients per row that is far above the card's ridge point
// at a long sequence, so every product is a wgmma on the tensor cores.  This
// design executes 14 D' flops a pair at head widths up to 128 (D' = D
// rounded up to 64: S and dP in both passes, dV, dK and dQ once), on fp16
// operands, and 20 D' from 136, where P and dS go to the tensor cores in
// two bf16 parts (below).
//
// Design (FlashAttention-3's backward building blocks, kept deterministic:
// no atomics, one writer per gradient element, so two calls on one input
// give bit-equal gradients, as the kill/restart resume needs):
//   (a) stats_kernel: a warp a row (eight lanes at D <= 64) writes delta =
//       rowsum(do * o) in float32 and the row's lse in log2 units, +inf for
//       a row with no live key and for the rows that pad Tq to a multiple
//       of 64: P = exp2(x - lse2) is then exactly 0 on those rows by that
//       test, whatever x is, so their dq is exactly 0 and they add nothing
//       to dk and dv.
//   (b) dK and dV: one block per key block of a kv head; it walks the G
//       query heads' live 64-row query tiles, streamed through a ring of
//       stages (q and do by TMA, lse2 and delta by bulk copies) while its k
//       and v tiles stay in shared memory, and writes dK and dV once.  Per
//       tile S^T = K Q^T and dP^T = V dO^T are wgmma with both operands in
//       shared memory (K-major, the forward's S = Q K^T with the roles
//       swapped); P^T and dS^T then sit in the accumulator's registers in
//       the layout of a bf16 A operand, so dV += P^T dO and dK += dS^T Q are
//       wgmma with A from registers and dO, Q as MN-major B tiles.
//   (c) dQ: one block per query-row block of a query head, holding q and do
//       while k and v stream through the ring: S = Q K^T, dP = dO V^T
//       (shared-memory wgmma), then dQ += dS K with dS from registers.
// Both passes walk only the tiles some of their rows or keys see (causal,
// window, q_offset) and mask only the tiles that cross a mask edge.  q, k, v
// and do are read by TMA through 4-d (D, T, heads, batch) tensor maps over
// the tensors' own strides in 128-byte swizzled 64-column atoms; columns
// past D come in as zeros (D = 120 reads as 128) and are never stored.
// From head width 136, P and dS go to the tensor cores in two bf16 parts
// each, hi (x truncated) and lo = bf16(x - hi), as the forward's P on its
// short rows.  Rounded once to bf16 (2^-8 relative), each broke the
// gradients' limit (2^-7 |want| + 1e-3 max|want|) where the sums cancel: dS
// put dk at 1.73 of it on the sweep's (2, 4, 64, 32) case, P put dv at 1.20
// at danube's training shape.  In two parts x is carried to ~2^-17
// relative, at the cost of one more product each (14 D' flops a pair become
// 20 D').  The scale D^-0.5 multiplies S in float32 and dq, dk once at the
// end.
//
// Head widths up to 128 instead run every product on fp16 operands (wgmma
// .f16.f16, at the bf16 rate), P and dS rounded once to fp16 (2^-11
// relative).  Two launches first copy q, k and v to fp16, each times a power
// of two 2^e of its own, e = 15 - floor(log2 max|x|) (fp16_exponent: the
// largest value lands in [2^15, 65280], under fp16's 65504, and every value
// of 2^-32 max|x| or more converts exactly, a bf16 value having 8
// significant bits), and stats_kernel converts do as it reads it.  Products
// of such operands are exact in the float32 sums, so S and dP are the bf16
// design's times 2^(eq + ek) and 2^(ev + ed), undone in float32 where S
// already takes D^-0.5 (Fp16Scales).  P goes as P 2^15 (exp2 of x - lse2 +
// 15, P <= 1), and dS as P 2^15 (dP - delta) 2^(ev + ed - 40): |dS| <= 2 D
// max|do| max|v|, so at D <= 128 it stays under 2^15 (1 + 2^-7), while a
// real step's dS sits far above fp16's smallest normal (2^-14) whatever the
// sizes of do and v (a mean loss's gradient, do ~ 2^-16, included).  The
// three gradients' sums are scaled back as they are stored.  So the dK/dV
// pass does 8 D' flops a pair and dQ 6 D', 14 D' in all against 20 D'.  Why
// not one bf16 rounding: its 2^-8 broke the limit (above); fp16's 2^-11
// does not, and the scales take fp16's narrower range out of play.  A
// float32 emulation of this arithmetic (tests/test_torch_attention_grad.py)
// gives at most 0.877 of the limit at chip_smoke.py's FLASH_BWD_D64_CASES
// and 0.84 at its FLASH_D128_CASES (do at O(1) and times 2^-16, q and k at
// 1e5 and 1e-5, v at 1e-6).  The forward (flash_attention_sm90.cu) rounds
// P once to fp16 only on rows that see 1024 keys or more: its limit,
// 2^-7 |want| + 1e-4 with no max|want| term, is missed on rows that see
// fewer, whose outputs average fewer rounded values
// (tools/emulate_fp16_attention.py).
//
// Head widths up to 64 (seamless's 64; namespace d64), on the fp16 copies:
// two consumer warpgroups of 64 keys (b) or 64 query rows (c) take turns at
// the tensor cores (a named barrier each), over a ring of eight stages.  In
// its turn a consumer issues this tile's S and dP, then the previous tile's
// gradient products, as two commit groups, and passes the turn; it waits
// for the first group only, runs this tile's exponentials while its
// gradient products and the other consumer's products run, then waits for
// them and rounds P and dS to fp16 into the registers they have read.  So
// the tensor cores do not run dry inside a turn.  (c) adds a producer warp
// (288 threads), whose one thread issues every load and alone waits for
// stages to empty: three warps on one of the SM's four register files give
// ptxas 168 registers a thread (an over-allocation fails to launch), room
// for dQ, S, dP and dS (112).  (b) is its two consumers alone (256
// threads, 255 registers): dK, dV, S^T, dP^T, P^T and dS^T in flight are
// 160 registers of operands, and at 288 threads ptxas serialised every
// wgmma of the pass (C7512).  Its consumers issue the loads on a fixed
// schedule, tile t + 5 in turn t by the consumer of its parity, into the
// stage of tile t - 3 that the turns have freed; a load instruction holds
// its thread for hundreds of clocks, so each of the four copies of a tile
// has a warp of its own.  The exponentials stay on MUFU: a polynomial on
// the FMA pipe for 1/8 to 1/2 of them slowed both passes (PERF.md).  The
// softcap is a template argument and the mask a test once a tile: a fully
// live tile's elements run without a branch, and every wgmma is issued
// from branch-free code.
//
// Head widths 65-128 (danube's 120, olmo's 128; namespace d128): turns at
// the tensor cores over tiles of the head's two 64-column atoms, on
// the fp16 copies, the softcap a template argument, the mask a test once a
// tile.  (c) is a producer warpgroup, whose one thread issues every load
// into a ring of five stages and alone waits for stages to empty, and two
// consumer warpgroups of 64 query rows; a consumer runs the previous tile's
// dQ, waits, then issues this tile's S and dP (issued beside the dQ, they
// made ptxas serialise the pass's wgmma: below).  (b) is two consumer
// warpgroups of 64 keys and no producer: their dK and dV take 128 registers
// a thread, and with a producer warpgroup (384 threads) ptxas plans the
// wgmma pipeline for 168 registers a thread whatever setmaxnreg grants, and
// serialised every wgmma and spilled (its "C7512 ... insufficient register
// resources"); at 256 threads it has 255.  There the consumers issue the
// loads after passing the turn, each tile's six copies over the four warps
// of the consumer of its parity, on a fixed schedule that the turns alone
// make safe over the ring of four stages (no empty barrier): one thread
// issuing them all held its warpgroup's next wgmma for ~1660 clocks a turn
// (PERF.md).  The gradient products are one m64n128k16 a 16-row step over
// both atoms of the B tile (MN-major), P^T, dS^T or dS from registers.
//
// Head widths 136-256 (recurrentgemma's 256; namespace d256; narrower heads
// read as 256 columns, the atoms past D zeroed in shared memory once and
// never loaded): a block of both passes is two consumer warpgroups over one
// 64-row tile of keys (b) or query rows (c), 256 threads, no producer.  The
// gradients of 64 rows by 256 columns are 128 float32 registers a thread
// each, so the two warpgroups split their columns: consumer w holds dK and
// dV (b), or dQ (c), of the head's atoms 2 w and 2 w + 1.  Each tile's S and
// dP are computed once between them, consumer w taking the 32 query columns
// (b) or keys (c) 32 w ... + 31 (m64n32k16 wgmma), and its P and dS go
// into shared memory as the two bf16 parts of a 64 x 64 K-major A operand,
// which both consumers' gradient products read (wgmma with A and B from
// shared memory; one m64n128k16 covers a consumer's two atoms, so a step
// reads A once for 128 columns).  A tile is: S and dP (whose wait also ends the previous
// tile's gradient products), P and dS, a barrier of both consumers (the
// parts are free), the parts stored, a barrier, and the gradient products
// issued and left running, with the next tile's loads: issued before the
// P and dS work instead, they slowed its shared-memory traffic more than
// they gained.  The rings have two stages of 64 KB (the parts and the
// resident tiles take the rest); in (c) v runs a tile further ahead than k.
// So the dK/dV pass does 12 D' flops a pair; splitting dK and dV by
// columns over two blocks, each recomputing S^T and dP^T, does 16 D'.  A
// dK/dV block loops over the G query heads: at recurrentgemma's MQA
// training shape, (1, 1, 8192) keys make 128 blocks, one wave on 132 SMs,
// so no block splits its heads.
//
// Built with -DFLASH_PHASE_CLOCKS (tools/profile_flash_attention.py only),
// every consumer warp of the d256 and d64 passes (b) and (c) and of the
// d128 pass (b) adds the SM clocks it spends in each phase of the tile loop
// to flash_bwd_sm90_phase_clocks[pass] (kClockPhases below).

#include <math_constants.h>

#include "sm90_common.cuh"

#ifdef FLASH_PHASE_CLOCKS
// d256 (passes 0 and 1): waiting for the tile's loads; S and dP issued; S
// and dP waited for (the wait also ends the previous tile's gradient
// products); the stage released and the next tile issued; P and dS; the
// barrier before the parts; the parts stored; their proxy fence; their
// barrier; the gradient products issued.  d64 (passes 2 and 3): waiting
// for the tile's loads; waiting for the turn; the products issued and the
// turn passed; a later tile's loads issued ((b)); the products waited for;
// P and dS rounded to fp16 (and, in (c), the stage released); P and dS.
// d128 (pass 4, (b)): the d64 phases, the last entry counting the warp's
// turns in the loop (tiles after its first).
constexpr int kClockPhases = 10;
__device__ unsigned long long flash_bwd_sm90_phase_clocks[5][kClockPhases];
#define PHASE(k)                       \
  {                                    \
    const long long now = clock64();   \
    phase_clocks[k] += now - phase_at; \
    phase_at = now;                    \
  }
#define PHASE_START                                  \
  long long phase_clocks[kClockPhases] = {};         \
  long long phase_at = clock64();
#define PHASE_TURN ++phase_clocks[kClockPhases - 1];
#define PHASE_END(pass)                                                              \
  if ((threadIdx.x & 31) == 0)                                                       \
    for (int k = 0; k < kClockPhases; ++k)                                           \
      atomicAdd(&flash_bwd_sm90_phase_clocks[pass][k],                               \
                static_cast<unsigned long long>(phase_clocks[k]));
#else
#define PHASE(k)
#define PHASE_START
#define PHASE_TURN
#define PHASE_END(pass)
#endif

namespace {

constexpr int kRows = 64;   // rows (keys or query rows) of one wgmma tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStatThreads = 256;

struct Params {
  const float* lse;          // (B, Hq, Tq) natural log, contiguous
  float* lse2;               // (B, Hq, Tq_pad): lse in log2 units, +inf on dead rows
  float* delta;              // (B, Hq, Tq_pad)
  __nv_bfloat16* dq;         // contiguous (B, Hq, Tq, D)
  __nv_bfloat16* dk;         // contiguous (B, Hkv, Tk, D)
  __nv_bfloat16* dv;
  int64_t Hq, Hkv, Tq, Tk, Tq_pad, D, group;
  int64_t window, q_offset;
  int causal, has_window, has_softcap;
  float softcap, scale, scale_log2;
};

// ---------------------------------------------------------------------------
// Head widths up to 128 run every product on fp16 copies of q, k, v and do,
// each times a power of two of its own (sm90_common.cuh's fp16_exponent):
// convert_fp16 takes the four tensors' largest |x| and writes the copies of
// q, k and v and the scales below, and stats_kernel converts do as it
// reads it.
// ---------------------------------------------------------------------------

constexpr int kPShift = 15;        // P goes to fp16 as P 2^15 (<= 2^15, under fp16's 65504)
constexpr int kDsShift = 40;       // and dS as P 2^15 (dP - delta) 2^(ev + ed - 40)
constexpr float kDpMul = 0x1p-40f;   // 2^-kDsShift

// written by the conversion, read by stats_kernel and the d64 and d128 passes
struct Fp16Scales {
  float mul_do;      // 2^ed: do's conversion
  float delta_mul;   // 2^(ev + ed - kDsShift): delta into the units of dP's sums times kDpMul
  float s_log2;      // scale log2(e) 2^-(eq + ek): S's sums to log2 units
  float cap_scale;   // scale / c 2^-(eq + ek) (softcap c)
  float dq_mul, dk_mul, dv_mul;   // the gradients' sums to their values (dq, dk times scale)
};
// the scratch of the conversion, in floats: the partial maxima of q, k, v
// and do, then Fp16Scales (flash_attention_bwd_sm90_aux_floats reports it)
constexpr int kAuxFloats = 4 * kConvBlocks + 8;
static_assert(sizeof(Fp16Scales) <= 8 * sizeof(float), "Fp16Scales outgrew its scratch");

// the conversion's epilogue: the Fp16Scales from the exponents of q, k, v, do
struct ScalesOut {
  Fp16Scales* sc;
  float scale, softcap;
  int has_softcap;
  __device__ void operator()(const int* e) const {
    const int eq = e[0], ek = e[1], ev = e[2], ed = e[3];
    const int ds = ev + ed + kPShift - kDsShift;   // dS's fp16 values are dS 2^ds
    sc->mul_do = exp2i(ed);
    sc->delta_mul = ldexpf(1.0f, ev + ed - kDsShift);
    sc->s_log2 = ldexpf(scale * kLog2e, -(eq + ek));
    sc->cap_scale = has_softcap ? ldexpf(scale / softcap, -(eq + ek)) : 0.0f;
    sc->dq_mul = ldexpf(scale, -(ds + ek));
    sc->dk_mul = ldexpf(scale, -(ds + eq));
    sc->dv_mul = ldexpf(1.0f, -(kPShift + ed));
  }
};

// a 64 x 64 float32 accumulator as four k-steps of an fp16 A operand, each
// value rounded once (cvt.rn.f16x2.f32): register r of step kk holds
// columns 16 kk + (r / 2) 8 + c2 of row r0 + (r % 2) 8, i.e. d[8 kk + 2 r],
// d[8 kk + 2 r + 1] (first in the low half)
__device__ __forceinline__ void to_a16(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_f16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// two rows of a 64-row tile: bf16 pairs of d (times `mul`) at columns
// 64 nb + 8 j + c2 < D of rows row0 and row0 + 8 below `rows`
__device__ __forceinline__ void store_rows(__nv_bfloat16* g, const float (&d)[32], int nb,
                                           int c2, int64_t row0, int64_t rows, int64_t D,
                                           float mul) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = nb * kAtom + 8 * j + c2;   // D is even: col < D covers col + 1
    if (col >= D) continue;
    if (row0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(g + row0 * D + col) =
          __floats2bfloat162_rn(d[4 * j] * mul, d[4 * j + 1] * mul);
    if (row0 + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(g + (row0 + 8) * D + col) =
          __floats2bfloat162_rn(d[4 * j + 2] * mul, d[4 * j + 3] * mul);
  }
}

// (a) LANES lanes a row of (B, Hq, Tq_pad), 8 columns each (8 up to 64
// columns, four rows a warp; else the whole warp): delta and lse2.  With
// f16 (the passes at D <= 128) also do's fp16 copy, do 2^ed, into do16;
// delta goes in the units of those passes' dP sums (delta_mul) and lse2
// less kPShift, so that exp2(x - lse2) is P 2^15.
template <int LANES>
__global__ void __launch_bounds__(kStatThreads)
stats_kernel(const Params p, const __nv_bfloat16* o, const __nv_bfloat16* dout, int64_t o_sb,
             int64_t o_sh, int64_t o_st, int64_t do_sb, int64_t do_sh, int64_t do_st,
             int64_t rows, const Fp16Scales* f16, __half* do16) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * (kStatThreads / 32) + threadIdx.x / 32) * (32 / LANES) +
      (threadIdx.x & 31) / LANES;
  const int lane = threadIdx.x & (LANES - 1);
  const bool in = row < rows;   // every lane stays for the shuffles below
  const int64_t i = row % p.Tq_pad, bh = row / p.Tq_pad, h = bh % p.Hq, b = bh / p.Hq;
  float acc = 0.0f;
  float l2 = CUDART_INF_F;
  if (in && i < p.Tq) {
    const int d = 8 * lane;   // 8 columns a lane, 16-byte loads (D and strides: multiples of 8)
    if (d < p.D) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + b * o_sb + h * o_sh + i * o_st + d);
      const uint4 gv =
          *reinterpret_cast<const uint4*>(dout + b * do_sb + h * do_sh + i * do_st + d);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const float mul = f16 != nullptr ? f16->mul_do : 0.0f;
      uint4 hv;
      uint32_t* hw = reinterpret_cast<uint32_t*>(&hv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 gf = __bfloat1622float2(g2[e]);
        acc = fmaf(of.x, gf.x, acc);
        acc = fmaf(of.y, gf.y, acc);
        hw[e] = pack_f16(gf.x * mul, gf.y * mul);
      }
      if (f16 != nullptr) *reinterpret_cast<uint4*>(do16 + (bh * p.Tq + i) * p.D + d) = hv;
    }
    const float l = p.lse[bh * p.Tq + i];
    if (l != -CUDART_INF_F) l2 = l * kLog2e - (f16 != nullptr ? kPShift : 0);
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && lane == 0) {
    p.lse2[row] = l2;
    p.delta[row] = f16 != nullptr ? acc * f16->delta_mul : acc;
  }
}

// ---------------------------------------------------------------------------
// Head widths up to 64: a producer warp and two consumer warpgroups that
// take turns at the tensor cores, on the fp16 copies.
// ---------------------------------------------------------------------------

namespace d64 {
constexpr int kConsumers = 2;                     // consumer warpgroups a block
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kQThreads = kConsumerThreads + 32;  // (c): and one producer warp
constexpr int kBlockRows = kConsumers * kRows;    // keys a (b) block, query rows a (c) block
constexpr int kTile = kRows * kAtom * 2;          // one 64 x 64 fp16 tile
constexpr int kStages = 8;                        // ring depth of both passes
// (b): tile t + kAhead is issued in turn t, into the stage of tile t - 3,
// which both consumers are done with by then (dkdv_kernel)
constexpr int kAhead = kStages - 3;
// (b): two k and two v tiles; a stage: q, do, 64 lse2 and 64 delta
constexpr int kSmemKV = 1024 + 2 * kConsumers * kTile + kStages * (2 * kTile + 2 * kRows * 4) +
                        8 * (kStages + 1);
// (c): two q and two do tiles; a stage: k, v
constexpr int kSmemQ = 1024 + 2 * kConsumers * kTile + 2 * kStages * kTile + 8 * (2 * kStages + 1);
static_assert(kSmemKV <= 232448 && kSmemQ <= 232448, "over the 227 KB a block may use");

// this configuration's own, so that the wider kernels compile from their
// unchanged Params (narrow fills it from theirs); the d128 kernels take it too
struct Params {
  const float* lse2;         // (B, Hq, Tq_pad): lse in log2 units, +inf on dead rows
  const float* delta;        // (B, Hq, Tq_pad)
  __nv_bfloat16* dq;         // contiguous (B, Hq, Tq, D)
  __nv_bfloat16* dk;         // contiguous (B, Hkv, Tk, D)
  __nv_bfloat16* dv;
  int64_t Tq, Tk, Tq_pad, D, window, q_offset;
  int Hq, Hkv, group;
  int causal, has_window;
  float scale, scale_log2;
  float cap_scale, cap_log2;   // softcap: scale / c and c log2(e)
};

// d = A B^T over the 64 columns of the head, A and B 64-row K-major fp16
// tiles; d an output only
__device__ __forceinline__ void gemm_ss64(float (&d)[32], uint32_t a, uint32_t b) {
  wgmma_ss_first_f16(d, desc(a), desc(b));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) wgmma_ss_f16(d, desc(a + kk * 32), desc(b + kk * 32), 1);
}

// d += A . B with A (64 x 64 fp16) from registers and B a 64-row fp16 tile
// read MN-major
__device__ __forceinline__ void gemm_rs64(float (&d)[32], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_f16(d, a[kk], desc(b + kk * 16 * 128));
}

template <int N>
__device__ __forceinline__ void fence_parts(uint32_t (&x)[4][N]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) reg_fence(x[kk]);
}

// p = exp(s' - lse) and ds = p (dp - delta) (times the softcap's
// derivative) from the raw score s, in place
template <bool CAP>
__device__ __forceinline__ void grad_elem(float& s, float& dp, float lse2, float delta,
                                          const Params& p) {
  if (CAP) {
    const float t = tanhf(s * p.cap_scale);
    const float pr = ex2(fmaf(t, p.cap_log2, -lse2));
    dp = pr * (dp - delta) * (1.0f - t * t);
    s = pr;
  } else {
    const float pr = ex2(fmaf(s, p.scale_log2, -lse2));
    dp = pr * (dp - delta);
    s = pr;
  }
}

// the fp16 passes' grad_elem (D <= 128): P' = P 2^15 and dS' = P' (dP
// 2^-40 - delta) (times the softcap's derivative) from the sums of S and dP
// over the fp16 copies: lse2 and delta are stats_kernel's for these passes,
// s_log2 and cap_scale Fp16Scales'
template <bool CAP>
__device__ __forceinline__ void grad_elem16(float& s, float& dp, float lse2, float delta,
                                            float s_log2, float cap_scale, const Params& p) {
  if (CAP) {
    const float t = tanhf(s * cap_scale);
    const float pr = ex2(fmaf(t, p.cap_log2, -lse2));
    dp = pr * fmaf(dp, kDpMul, -delta) * (1.0f - t * t);
    s = pr;
  } else {
    const float pr = ex2(fmaf(s, s_log2, -lse2));
    dp = pr * fmaf(dp, kDpMul, -delta);
    s = pr;
  }
}

// one element's P and dS: grad_elem16 on the fp16 passes (F16), else grad_elem
template <bool CAP, bool F16>
__device__ __forceinline__ void grad_pair(float& s, float& dp, float lse2, float delta,
                                          float s_log2, float cap_scale, const Params& p) {
  if constexpr (F16)
    grad_elem16<CAP>(s, dp, lse2, delta, s_log2, cap_scale, p);
  else
    grad_elem<CAP>(s, dp, lse2, delta, p);
}

__device__ __forceinline__ bool live(const Params& p, int64_t qpos, int64_t kpos) {
  return kpos < p.Tk && (!p.causal || kpos <= qpos) && (!p.has_window || kpos > qpos - p.window);
}

// (b) one tile: S^T and dP^T (keys r0, r0 + 8 by query columns 8 j + c2,
// + 1, N / 4 columns of 8) to P^T and dS^T in place (F16: P'^T and dS'^T,
// grad_elem16 with s_log2 and cap_scale); lse2, delta: the rows of those
// columns.  A tile that crosses a mask edge (edge) zeroes the dead pairs: qa
// is the first column's query position, k0 this thread's first key.
template <bool CAP, int N, bool F16 = false>
__device__ __forceinline__ void kv_probs(float (&st)[N], float (&dpt)[N], const float* lse2,
                                         const float* delta, int c2, const Params& p, bool edge,
                                         int64_t qa, int64_t k0, float s_log2 = 0.0f,
                                         float cap_scale = 0.0f) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + c2);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + c2);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      grad_pair<CAP, F16>(st[4 * j + e], dpt[4 * j + e], (e & 1) ? l.y : l.x,
                          (e & 1) ? dl.y : dl.x, s_log2, cap_scale, p);
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool on = live(p, qa + (i / 4) * 8 + c2 + (i & 1), k0 + ((i & 2) ? 8 : 0));
      st[i] = on ? st[i] : 0.0f;
      dpt[i] = on ? dpt[i] : 0.0f;
    }
  }
}

// (c) one tile: S and dP (rows r0, r0 + 8 by keys 8 j + c2, + 1, N / 4
// columns of 8) to dS in sc (F16: dS'); pos0, pos1: the two rows'
// positions, kt the first column's key
template <bool CAP, int N, bool F16 = false>
__device__ __forceinline__ void q_probs(float (&sc)[N], float (&dp)[N], float l0, float l1,
                                        float d0, float d1, int c2, const Params& p, bool edge,
                                        int64_t pos0, int64_t pos1, int64_t kt,
                                        float s_log2 = 0.0f, float cap_scale = 0.0f) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    grad_pair<CAP, F16>(sc[i], dp[i], (i & 2) ? l1 : l0, (i & 2) ? d1 : d0, s_log2, cap_scale, p);
    sc[i] = dp[i];
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (!live(p, (i & 2) ? pos1 : pos0, kt + (i / 4) * 8 + c2 + (i & 1))) sc[i] = 0.0f;
  }
}

// (b) dK and dV of 128 keys of one kv head: consumer warpgroup w holds keys
// kt + 64 w ... + 63.  No producer: at 256 threads a thread has 255
// registers, room for the previous tile's dV and dK in flight beside this
// tile's S^T and dP^T (160 registers of operands; at 288 threads ptxas
// planned the wgmma pipeline for 168 and serialised it, C7512).  The
// consumers issue the loads themselves, on a fixed schedule (below).
template <bool CAP>
__global__ void __launch_bounds__(kConsumerThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
            const Params p, const Fp16Scales* __restrict__ f16) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;                               // kConsumers k tiles
  uint8_t* vs = ks + kConsumers * kTile;            // kConsumers v tiles
  uint8_t* qs = vs + kConsumers * kTile;            // kStages q tiles
  uint8_t* dos = qs + kStages * kTile;              // kStages do tiles
  float* lse_s = reinterpret_cast<float*>(dos + kStages * kTile);   // kStages x 64
  float* delta_s = lse_s + kStages * kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + kStages * kRows);
  uint64_t* kbar = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int64_t kt = static_cast<int64_t>(blockIdx.x) * kBlockRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  // the 64-row query tiles that see one of keys [kt, k_last]: the same for
  // every query head of the group
  const int64_t k_last = (kt + kBlockRows < p.Tk ? kt + kBlockRows : p.Tk) - 1;
  int64_t i_lo = 0, i_hi = p.Tq;
  if (p.causal && kt - p.q_offset > i_lo) i_lo = kt - p.q_offset;
  if (p.has_window && k_last + p.window - p.q_offset < i_hi) i_hi = k_last + p.window - p.q_offset;
  i_lo &= ~static_cast<int64_t>(kRows - 1);
  const int n_qt = i_hi > i_lo ? static_cast<int>((i_hi - i_lo + kRows - 1) / kRows) : 0;
  const int n_iter = p.group * n_qt;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(kbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile u: query head hk G + u / n_qt, rows i_lo + 64 (u % n_qt) ...
  // Consumer u % 2 issues tile u, lane 0 of its warp c copy c: 0 the
  // barrier's bytes and q, 1 do, 2 lse2, 3 delta (a copy may land before
  // the bytes are expected: the phase ends only with warp 0's arrival).  A
  // load instruction holds its thread for hundreds of clocks, and every
  // consumer warp waits at the next wgmma for the slowest of its
  // warpgroup, so one thread issuing all of them cost the pass 7 %
  // (PERF.md).  Each such thread steps the head and the rows (h,
  // qi) from one tile to the next instead of dividing.
  const int copy = (tid & 31) == 0 ? (tid / 32) & 3 : -1;
  int h = hk * p.group, qi = 0;
  auto issue = [&](int u) {
    if (copy < 0) return;
    if ((u & 1) != wg) {   // the other consumer's tile: step past it
      if (++qi == n_qt) {
        qi = 0;
        ++h;
      }
      return;
    }
    const int s = u % kStages;
    const int64_t q0 = i_lo + static_cast<int64_t>(qi) * kRows;
    const int64_t row = (static_cast<int64_t>(b) * p.Hq + h) * p.Tq_pad + q0;
    if (copy == 0) {
      mbar_expect_tx(&full[s], 2 * kTile + 2 * kRows * 4);
      tma_load(qs + s * kTile, &qmap, &full[s], 0, static_cast<int>(q0), h, b);
    } else if (copy == 1) {
      tma_load(dos + s * kTile, &domap, &full[s], 0, static_cast<int>(q0), h, b);
    } else if (copy == 2) {
      bulk_load(lse_s + s * kRows, p.lse2 + row, kRows * 4, &full[s]);
    } else {
      bulk_load(delta_s + s * kRows, p.delta + row, kRows * 4, &full[s]);
    }
    if (++qi == n_qt) {
      qi = 0;
      ++h;
    }
  };
  if (tid == 0) {
    mbar_expect_tx(kbar, 2 * kConsumers * kTile);
    for (int c = 0; c < kConsumers; ++c) {
      tma_load(ks + c * kTile, &kmap, kbar, 0, static_cast<int>(kt + c * kRows), hk, b);
      tma_load(vs + c * kTile, &vmap, kbar, 0, static_cast<int>(kt + c * kRows), hk, b);
    }
  }
  for (int u = 0; u <= kAhead && u < n_iter; ++u) issue(u);

  // ---- consumer warpgroup wg: keys kw ... kw + 63
  const int lane = tid & 31;
  const int warp = (tid / 32) & 3;
  const int r0 = warp * 16 + lane / 4;     // this thread's keys: kw + r0 and kw + r0 + 8
  const int c2 = (lane & 3) * 2;           // and query columns 8j + c2, 8j + c2 + 1
  const int64_t kw = kt + wg * kRows;
  const uint32_t q_s0 = smem_u32(qs);
  const uint32_t do_s0 = smem_u32(dos);

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
  float st[32], dpt[32];
  uint32_t ph[4][4], sh[4][4];   // P'^T and dS'^T in fp16
  const float s_log2 = f16->s_log2;
  const float cap_scale = CAP ? f16->cap_scale : 0.0f;
  const uint32_t k_base = smem_u32(ks + wg * kTile);
  const uint32_t v_base = smem_u32(vs + wg * kTile);
  mbar_wait(kbar, 0);

  // S^T = K Q^T and dP^T = V dO^T of the tile in stage s
  auto issue_s = [&](int s) {
    gemm_ss64(st, k_base, q_s0 + s * kTile);
    gemm_ss64(dpt, v_base, do_s0 + s * kTile);
  };
  // dV += P'^T dO, dK += dS'^T Q of the tile in stage s
  auto issue_grad = [&](int s) {
    gemm_rs64(dv, ph, do_s0 + s * kTile);
    gemm_rs64(dk, sh, q_s0 + s * kTile);
  };
  auto fence_grad = [&]() {
    reg_fence(dv);
    reg_fence(dk);
    fence_parts(ph);
    fence_parts(sh);
  };
  // P'^T and dS'^T of the tile in stage s, query tile qt, in place ...
  auto probs = [&](int s, int qt) {
    reg_fence(st);
    reg_fence(dpt);
    const int64_t q0 = i_lo + static_cast<int64_t>(qt) * kRows;
    const int64_t qa = p.q_offset + q0;                                          // first row
    const int64_t qb = p.q_offset + (q0 + kRows < p.Tq ? q0 + kRows : p.Tq) - 1;  // last row
    const bool edge = !(kw + kRows <= p.Tk && (!p.causal || kw + kRows - 1 <= qa) &&
                        (!p.has_window || kw > qb - p.window));
    kv_probs<CAP, 32, true>(st, dpt, lse_s + s * kRows, delta_s + s * kRows, c2, p, edge, qa,
                            kw + r0, s_log2, cap_scale);
  };
  // ... rounded to fp16 into the A operands of the gradient products
  auto parts = [&]() {
    to_a16(st, ph);
    to_a16(dpt, sh);
  };

  // Ping-pong: named barrier 1 + w is consumer w's turn at the tensor
  // cores, passed on to the other consumer.  In its turn a consumer issues
  // this tile's S^T and dP^T, then the previous tile's dV and dK, as two
  // commit groups, and passes the turn; it waits for the first group only
  // and turns S^T, dP^T into P^T, dS^T while its dV and dK and the other
  // consumer's products run, then waits for them and rounds P^T, dS^T into
  // the registers they have read.  Every consumer takes n_iter + 1 turns;
  // consumer 1 starts by passing the first turn to consumer 0 and does not
  // pass its own last one, so every arrival is waited for.  Every wgmma is
  // issued from branch-free code (tile 0's S^T alone, the last dV and dK
  // alone).  A tile none of a consumer's pairs sees runs as a masked tile:
  // its P and dS are zero.
  const int mine = 1 + wg;
  const int other = 1 + (wg ^ 1);
  if (n_iter > 0) {
    if (wg == kConsumers - 1) bar_arrive(other, kConsumerThreads);
    mbar_wait(&full[0], 0);
    bar_sync(mine, kConsumerThreads);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    bar_arrive(other, kConsumerThreads);
    wgmma_wait_all();
    probs(0, 0);
    parts();
    int qt = 0, s = 0, sp = 0;
    uint32_t phase = 0;
    PHASE_START
#pragma unroll 1
    for (int t = 1; t < n_iter; ++t) {
      sp = s;                                 // the stage of tile t - 1
      if (++s == kStages) { s = 0; phase ^= 1; }
      if (++qt == n_qt) qt = 0;
      mbar_wait(&full[s], phase);
      PHASE(0)
      bar_sync(mine, kConsumerThreads);
      PHASE(1)
      fence_grad();
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      issue_grad(sp);
      wgmma_commit();
      bar_arrive(other, kConsumerThreads);
      PHASE(2)
      // tile t + kAhead into the stage of tile t - 3, which both consumers
      // are done with: each waited for its gradient products of tile t - 3
      // in its turn t - 2, before the other consumer's turn t - 1 and this
      // one's turn t began; so no stage needs an empty barrier
      if (t + kAhead < n_iter) issue(t + kAhead);
      __syncwarp();
      PHASE(3)
      wgmma_wait_but_one();
      PHASE(4)
      probs(s, qt);
      PHASE(6)
      wgmma_wait_all();
      PHASE(4)
      fence_grad();
      parts();
      PHASE(5)
    }
    PHASE_END(2)
    bar_sync(mine, kConsumerThreads);
    fence_grad();
    wgmma_fence();
    issue_grad(s);
    wgmma_commit();
    if (wg != kConsumers - 1) bar_arrive(other, kConsumerThreads);
    wgmma_wait_all();
    fence_grad();
  }

  const int64_t off = (static_cast<int64_t>(b) * p.Hkv + hk) * p.Tk * p.D;
  store_rows(p.dk + off, dk, 0, c2, kw + r0, p.Tk, p.D, f16->dk_mul);
  store_rows(p.dv + off, dv, 0, c2, kw + r0, p.Tk, p.D, f16->dv_mul);
}

// (c) dQ of 128 query rows of one query head: consumer warpgroup w holds
// rows q0 + 64 w ... + 63, beside a producer warp
template <bool CAP>
__global__ void __launch_bounds__(kQThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
          const Params p, const Fp16Scales* __restrict__ f16) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                               // kConsumers q tiles
  uint8_t* dos = qs + kConsumers * kTile;           // kConsumers do tiles
  uint8_t* ks = dos + kConsumers * kTile;           // kStages k tiles
  uint8_t* vs = ks + kStages * kTile;               // kStages v tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // the last query rows see the most keys: start them first
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;

  // the 64-key tiles that any row of this block can see
  const int64_t rows_end = q0 + kBlockRows < p.Tq ? q0 + kBlockRows : p.Tq;
  const int64_t q_first = p.q_offset + q0;
  const int64_t q_last = p.q_offset + rows_end - 1;
  int64_t k_end = p.Tk;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0) k_begin = q_first - p.window + 1;
  k_begin &= ~static_cast<int64_t>(kRows - 1);
  const int n_tiles = k_end > k_begin ? static_cast<int>((k_end - k_begin + kRows - 1) / kRows) : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int t) {
    const int s = t % kStages;
    const int k0 = static_cast<int>(k_begin + static_cast<int64_t>(t) * kRows);
    mbar_expect_tx(&full[s], 2 * kTile);
    tma_load(ks + s * kTile, &kmap, &full[s], 0, k0, hk, b);
    tma_load(vs + s * kTile, &vmap, &full[s], 0, k0, hk, b);
  };
  auto load_q = [&]() {
    mbar_expect_tx(qbar, 2 * kConsumers * kTile);
    for (int c = 0; c < kConsumers; ++c) {
      tma_load(qs + c * kTile, &qmap, qbar, 0, static_cast<int>(q0 + c * kRows), h, b);
      tma_load(dos + c * kTile, &domap, qbar, 0, static_cast<int>(q0 + c * kRows), h, b);
    }
  };
  if (wg == kConsumers) {
    // ---- producer: one thread streams the key tiles through the ring
    if (tid == kConsumerThreads) {
      load_q();
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= kStages) mbar_wait(&empty[t % kStages], ((t / kStages) - 1) & 1);
        issue(t);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows wq0 ... wq0 + 63
  const int lane = tid & 31;
  const int warp = (tid / 32) & 3;
  const int r0 = warp * 16 + lane / 4;     // this thread's rows: r0 and r0 + 8
  const int c2 = (lane & 3) * 2;           // and keys 8j + c2, 8j + c2 + 1
  const int64_t wq0 = q0 + wg * kRows;
  const int64_t qa = p.q_offset + wq0;
  const int64_t qb = p.q_offset + (wq0 + kRows < p.Tq ? wq0 + kRows : p.Tq) - 1;
  const int64_t pos0 = qa + r0;
  const int64_t pos1 = pos0 + 8;
  const int64_t srow = (static_cast<int64_t>(b) * p.Hq + h) * p.Tq_pad + wq0 + r0;
  const bool in0 = wq0 + r0 < p.Tq_pad, in1 = wq0 + r0 + 8 < p.Tq_pad;
  const float l2_0 = in0 ? p.lse2[srow] : CUDART_INF_F;
  const float l2_1 = in1 ? p.lse2[srow + 8] : CUDART_INF_F;
  const float dl0 = in0 ? p.delta[srow] : 0.0f;
  const float dl1 = in1 ? p.delta[srow + 8] : 0.0f;
  const uint32_t k_s0 = smem_u32(ks);
  const uint32_t v_s0 = smem_u32(vs);

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.0f;
  float sc[32], dp[32];
  uint32_t dh[4][4];   // dS' in fp16
  const float s_log2 = f16->s_log2;
  const float cap_scale = CAP ? f16->cap_scale : 0.0f;
  const uint32_t q_base = smem_u32(qs + wg * kTile);
  const uint32_t do_base = smem_u32(dos + wg * kTile);
  mbar_wait(qbar, 0);

  // S = Q K^T and dP = dO V^T of the tile in stage s
  auto issue_s = [&](int s) {
    gemm_ss64(sc, q_base, k_s0 + s * kTile);
    gemm_ss64(dp, do_base, v_s0 + s * kTile);
  };
  // dQ += dS' K of the tile in stage s
  auto issue_grad = [&](int s) { gemm_rs64(dq, dh, k_s0 + s * kTile); };
  auto fence_grad = [&]() {
    reg_fence(dq);
    fence_parts(dh);
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  auto probs = [&](int t) {
    reg_fence(sc);
    reg_fence(dp);
    const int64_t kt = k_begin + static_cast<int64_t>(t) * kRows;
    const bool edge = !(kt + kRows <= p.Tk && (!p.causal || kt + kRows - 1 <= qa) &&
                        (!p.has_window || kt > qb - p.window));
    q_probs<CAP, 32, true>(sc, dp, l2_0, l2_1, dl0, dl1, c2, p, edge, pos0, pos1, kt, s_log2,
                           cap_scale);
  };

  // the turns of dkdv_kernel, over key tiles: this tile's S and dP, then
  // the previous tile's dQ, two commit groups, dS computed while dQ runs
  // (dS', S, dP and dQ: 112 registers)
  const int mine = 1 + wg;
  const int other = 1 + (wg ^ 1);
  if (n_tiles > 0) {
    if (wg == kConsumers - 1) bar_arrive(other, kConsumerThreads);
    mbar_wait(&full[0], 0);
    bar_sync(mine, kConsumerThreads);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    bar_arrive(other, kConsumerThreads);
    wgmma_wait_all();
    probs(0);
    to_a16(sc, dh);
    PHASE_START
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int sp = (t - 1) % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      PHASE(0)
      bar_sync(mine, kConsumerThreads);
      PHASE(1)
      fence_grad();
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      issue_grad(sp);
      wgmma_commit();
      bar_arrive(other, kConsumerThreads);
      PHASE(2)
      wgmma_wait_but_one();
      PHASE(4)
      probs(t);
      PHASE(6)
      wgmma_wait_all();
      PHASE(4)
      fence_grad();
      release(sp);
      to_a16(sc, dh);
      PHASE(5)
    }
    PHASE_END(3)
    const int sp = (n_tiles - 1) % kStages;
    bar_sync(mine, kConsumerThreads);
    fence_grad();
    wgmma_fence();
    issue_grad(sp);
    wgmma_commit();
    if (wg != kConsumers - 1) bar_arrive(other, kConsumerThreads);
    wgmma_wait_all();
    fence_grad();
    release(sp);
  }

  __nv_bfloat16* dqg = p.dq + (static_cast<int64_t>(b) * p.Hq + h) * p.Tq * p.D;
  store_rows(dqg, dq, 0, c2, wq0 + r0, p.Tq, p.D, f16->dq_mul);
}

template <bool CAP>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           const CUtensorMap& dom, const Params& p, const Fp16Scales* f16, int64_t B,
           cudaStream_t stream) {
  static bool configured = false;   // the attributes are per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<CAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(dq_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid_kv(static_cast<unsigned>((p.Tk + kBlockRows - 1) / kBlockRows),
                     static_cast<unsigned>(p.Hkv), static_cast<unsigned>(B));
  dkdv_kernel<CAP><<<grid_kv, kConsumerThreads, kSmemKV, stream>>>(qm, km, vm, dom, p, f16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((p.Tq + kBlockRows - 1) / kBlockRows),
                    static_cast<unsigned>(p.Hq), static_cast<unsigned>(B));
  dq_kernel<CAP><<<grid_q, kQThreads, kSmemQ, stream>>>(qm, km, vm, dom, p, f16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace d64

// ---------------------------------------------------------------------------
// Head widths 65-128 (danube's 120): two consumer warpgroups that take turns
// at the tensor cores over tiles of the head's two 64-column atoms; (c)
// beside a producer warpgroup.
// ---------------------------------------------------------------------------

namespace d128 {
using d64::Params;   // the D <= 64 kernels' own, filled alike (narrow below)
constexpr int kConsumers = 2;                     // consumer warpgroups a block
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;  // (c): and one producer warpgroup
constexpr int kBlockRows = kConsumers * kRows;    // keys a (b) block, query rows a (c) block
constexpr int kNB = 2;                            // 64-column atoms of the head
constexpr int kTile = kRows * kNB * kAtom * 2;    // one 64 x 128 fp16 tile, atom nb at 8 KB nb
// setmaxnreg in (c): the producer gives up registers so that each consumer
// thread holds 240; 24 + 2 x 240 is the 3 x 168 a thread the launch allocates
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStagesKV = 4;                      // ring depth of (b): q, do, lse2, delta
constexpr int kStagesQ = 5;                       // ring depth of (c): k, v
// (b): two k and two v tiles; a stage: q, do, 64 lse2 and 64 delta
constexpr int kSmemKV = 1024 + 2 * kConsumers * kTile +
                        kStagesKV * (2 * kTile + 2 * kRows * 4) + 8 * (kStagesKV + 1);
// (c): two q and two do tiles; a stage: k, v
constexpr int kSmemQ = 1024 + 2 * kConsumers * kTile + 2 * kStagesQ * kTile + 8 * (2 * kStagesQ + 1);
static_assert(kSmemKV <= 232448 && kSmemQ <= 232448, "over the 227 KB a block may use");

// d = A B^T over the head's 128 columns, A and B 64-row K-major fp16 tiles
// of two atoms; d an output only
__device__ __forceinline__ void gemm_ss128(float (&d)[32], uint32_t a, uint32_t b) {
  a = opaque(a);
  b = opaque(b);
  wgmma_ss_first_f16(d, desc(a), desc(b));
#pragma unroll
  for (int kk = 1; kk < 8; ++kk) {
    const uint32_t off = (kk / 4) * kRows * 128 + (kk % 4) * 32;
    wgmma_ss_f16(d, desc(a + off), desc(b + off), 1);
  }
}

// d += A . B over the head's 128 columns: A (64 x 64 fp16) from registers, B
// a 64-row fp16 tile of two atoms read MN-major, one m64n128k16 a k-step
__device__ __forceinline__ void gemm_rs128(float (&d)[kNB][32], const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n128_f16(d, a[kk], desc_mn(b + kk * 16 * 128, kRows * 128));
}

// (b) dK and dV of 128 keys of one kv head: consumer warpgroup w holds keys
// kt + 64 w ... + 63, its dK and dV (64 x 128 float32 each) in 128
// registers a thread.  No producer: with one, ptxas plans the wgmma
// pipeline for the 168 registers a thread of 384 (whatever setmaxnreg
// grants), and the two accumulators beside the parts do not fit it, so it
// serialised every wgmma and spilled.  The consumers issue the loads
// themselves, on a fixed schedule (below).
template <bool CAP>
__global__ void __launch_bounds__(kConsumerThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
            const Params p, const Fp16Scales* __restrict__ f16) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;                               // kConsumers k tiles
  uint8_t* vs = ks + kConsumers * kTile;            // kConsumers v tiles
  uint8_t* qs = vs + kConsumers * kTile;            // kStagesKV q tiles
  uint8_t* dos = qs + kStagesKV * kTile;            // kStagesKV do tiles
  float* lse_s = reinterpret_cast<float*>(dos + kStagesKV * kTile);   // kStagesKV x 64
  float* delta_s = lse_s + kStagesKV * kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + kStagesKV * kRows);
  uint64_t* kbar = full + kStagesKV;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int64_t kt = static_cast<int64_t>(blockIdx.x) * kBlockRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  // the 64-row query tiles that see one of keys [kt, k_last]: the same for
  // every query head of the group
  const int64_t k_last = (kt + kBlockRows < p.Tk ? kt + kBlockRows : p.Tk) - 1;
  int64_t i_lo = 0, i_hi = p.Tq;
  if (p.causal && kt - p.q_offset > i_lo) i_lo = kt - p.q_offset;
  if (p.has_window && k_last + p.window - p.q_offset < i_hi) i_hi = k_last + p.window - p.q_offset;
  i_lo &= ~static_cast<int64_t>(kRows - 1);
  const int n_qt = i_hi > i_lo ? static_cast<int>((i_hi - i_lo + kRows - 1) / kRows) : 0;
  const int n_iter = p.group * n_qt;

  if (tid == 0) {
    for (int s = 0; s < kStagesKV; ++s) mbar_init(&full[s], 1);
    mbar_init(kbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile u: query head hk G + u / n_qt, rows i_lo + 64 (u % n_qt) ...
  // Consumer u % 2 issues tile u, lane 0 of its warp c: 0 the barrier's
  // bytes, q's first atom and lse2, 1 q's second atom and delta, 2 and 3
  // do's two atoms (a copy may land before the bytes are expected: the
  // phase ends only with warp 0's arrival).  One thread issuing all six
  // (the design before) spent ~1660 clocks a turn on them while its
  // warpgroup's next wgmma waited (PERF.md).  Each such thread steps the
  // head and the rows (h, qi) from one tile to the next instead of
  // dividing.
  const int copy = (tid & 31) == 0 ? (tid / 32) & 3 : -1;
  int h = hk * p.group, qi = 0;
  auto issue = [&](int u) {
    if (copy < 0) return;
    if ((u & 1) == wg) {
      const int s = u % kStagesKV;
      const int q0 = static_cast<int>(i_lo) + qi * kRows;
      const int64_t row = (static_cast<int64_t>(b) * p.Hq + h) * p.Tq_pad + q0;
      if (copy < 2) {
        if (copy == 0) mbar_expect_tx(&full[s], 2 * kTile + 2 * kRows * 4);
        tma_load(qs + s * kTile + copy * kRows * 128, &qmap, &full[s], copy * kAtom, q0, h, b);
        bulk_load((copy == 0 ? lse_s : delta_s) + s * kRows,
                  (copy == 0 ? p.lse2 : p.delta) + row, kRows * 4, &full[s]);
      } else {
        tma_load(dos + s * kTile + (copy - 2) * kRows * 128, &domap, &full[s],
                 (copy - 2) * kAtom, q0, h, b);
      }
    }
    if (++qi == n_qt) {   // the next tile, whichever consumer issues it
      qi = 0;
      ++h;
    }
  };
  // this consumer's k and v tiles, then the ring's first tiles
  if (tid == 0) mbar_expect_tx(kbar, 2 * kConsumers * kTile);
  if (copy >= 0)
    tma_load((copy < 2 ? ks : vs) + wg * kTile + (copy & 1) * kRows * 128,
             copy < 2 ? &kmap : &vmap, kbar, (copy & 1) * kAtom,
             static_cast<int>(kt + wg * kRows), hk, b);
  for (int u = 0; u < kStagesKV && u < n_iter; ++u) issue(u);
  __syncwarp();

  // ---- consumer warpgroup wg: keys kw ... kw + 63
  const int lane = tid & 31;
  const int warp = (tid / 32) & 3;
  const int r0 = warp * 16 + lane / 4;     // this thread's keys: kw + r0 and kw + r0 + 8
  const int c2 = (lane & 3) * 2;           // and query columns 8j + c2, 8j + c2 + 1
  const int64_t kw = kt + wg * kRows;
  const uint32_t q_s0 = smem_u32(qs);
  const uint32_t do_s0 = smem_u32(dos);

  float dk[kNB][32], dv[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[nb][i] = dv[nb][i] = 0.0f;
  float st[32], dpt[32];
  uint32_t ph[4][4], sh[4][4];   // P'^T and dS'^T in fp16
  const float s_log2 = f16->s_log2;
  const float cap_scale = CAP ? f16->cap_scale : 0.0f;
  const uint32_t k_base = smem_u32(ks + wg * kTile);
  const uint32_t v_base = smem_u32(vs + wg * kTile);
  mbar_wait(kbar, 0);

  // S^T = K Q^T and dP^T = V dO^T of the tile in stage s
  auto issue_s = [&](int s) {
    gemm_ss128(st, k_base, q_s0 + s * kTile);
    gemm_ss128(dpt, v_base, do_s0 + s * kTile);
  };
  // dV += P'^T dO, dK += dS'^T Q of the tile in stage s
  auto issue_grad = [&](int s) {
    gemm_rs128(dv, ph, do_s0 + s * kTile);
    gemm_rs128(dk, sh, q_s0 + s * kTile);
  };
  auto fence_grad = [&]() {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      reg_fence(dv[nb]);
      reg_fence(dk[nb]);
    }
    d64::fence_parts(ph);
    d64::fence_parts(sh);
  };
  // P'^T and dS'^T of the tile in stage s, query tile qt, in fp16
  auto probs = [&](int s, int qt) {
    reg_fence(st);
    reg_fence(dpt);
    const int64_t q0 = i_lo + static_cast<int64_t>(qt) * kRows;
    const int64_t qa = p.q_offset + q0;                                          // first row
    const int64_t qb = p.q_offset + (q0 + kRows < p.Tq ? q0 + kRows : p.Tq) - 1;  // last row
    const bool edge = !(kw + kRows <= p.Tk && (!p.causal || kw + kRows - 1 <= qa) &&
                        (!p.has_window || kw > qb - p.window));
    d64::kv_probs<CAP, 32, true>(st, dpt, lse_s + s * kRows, delta_s + s * kRows, c2, p, edge, qa,
                                 kw + r0, s_log2, cap_scale);
  };
  auto parts = [&]() {
    to_a16(st, ph);
    to_a16(dpt, sh);
  };

  // Ping-pong: in its turn a consumer runs the previous tile's dV and dK,
  // waits for them, issues this tile's S^T and dP^T and passes the turn.
  // (Issued together, the two accumulators, S^T, dP^T and the previous
  // tile's P'^T and dS'^T are 224 registers of operands: ptxas spilled at
  // 255 and the pass ran 3-4 % slower; PERF.md.)  Loads: in its turn t
  // consumer 0 is done with tile t - 1 and consumer 1, whose turn t - 1
  // passed this one, with tile t - 2, so consumer 0 issues tile t + 2 into
  // that stage when t + 2 is even; in consumer 1's turn t consumer 0 is done
  // with tile t - 1 too, so consumer 1 issues tile t + 3 when it is odd.
  // No stage needs an empty barrier, and a tile is issued two or three
  // turns before it is needed.
  const int mine = 1 + wg;
  const int other = 1 + (wg ^ 1);
  const int ahead = kStagesKV - 2 + wg;
  if (n_iter > 0) {
    if (wg == kConsumers - 1) bar_arrive(other, kConsumerThreads);
    mbar_wait(&full[0], 0);
    bar_sync(mine, kConsumerThreads);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    bar_arrive(other, kConsumerThreads);
    wgmma_wait_all();
    probs(0, 0);
    parts();
    int qt = 0, s = 0, sp = 0;
    uint32_t phase = 0;
    PHASE_START
#pragma unroll 1
    for (int t = 1; t < n_iter; ++t) {
      sp = s;                                 // the stage of tile t - 1
      if (++s == kStagesKV) { s = 0; phase ^= 1; }
      if (++qt == n_qt) qt = 0;
      PHASE_TURN
      mbar_wait(&full[s], phase);
      PHASE(0)
      bar_sync(mine, kConsumerThreads);
      PHASE(1)
      fence_grad();
      wgmma_fence();
      issue_grad(sp);
      wgmma_commit();
      PHASE(2)
      wgmma_wait_all();
      PHASE(4)
      fence_grad();
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      bar_arrive(other, kConsumerThreads);
      PHASE(2)
      if (t + ahead >= kStagesKV && t + ahead < n_iter) issue(t + ahead);
      __syncwarp();
      PHASE(3)
      wgmma_wait_all();
      PHASE(4)
      probs(s, qt);
      PHASE(6)
      parts();
      PHASE(5)
    }
    PHASE_END(4)
    bar_sync(mine, kConsumerThreads);
    fence_grad();
    wgmma_fence();
    issue_grad(s);
    wgmma_commit();
    if (wg != kConsumers - 1) bar_arrive(other, kConsumerThreads);
    wgmma_wait_all();
    fence_grad();
  }

  const int64_t off = (static_cast<int64_t>(b) * p.Hkv + hk) * p.Tk * p.D;
  const float dk_mul = f16->dk_mul, dv_mul = f16->dv_mul;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    store_rows(p.dk + off, dk[nb], nb, c2, kw + r0, p.Tk, p.D, dk_mul);
    store_rows(p.dv + off, dv[nb], nb, c2, kw + r0, p.Tk, p.D, dv_mul);
  }
}

// (c) dQ of 128 query rows of one query head: consumer warpgroup w holds
// rows q0 + 64 w ... + 63
template <bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
          const Params p, const Fp16Scales* __restrict__ f16) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                               // kConsumers q tiles
  uint8_t* dos = qs + kConsumers * kTile;           // kConsumers do tiles
  uint8_t* ks = dos + kConsumers * kTile;           // kStagesQ k tiles
  uint8_t* vs = ks + kStagesQ * kTile;              // kStagesQ v tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStagesQ * kTile);
  uint64_t* empty = full + kStagesQ;
  uint64_t* qbar = empty + kStagesQ;

  const int tid = threadIdx.x;
  // the role of this thread's warpgroup, the same in every lane
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // the last query rows see the most keys: start them first
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;

  // the 64-key tiles that any row of this block can see
  const int64_t rows_end = q0 + kBlockRows < p.Tq ? q0 + kBlockRows : p.Tq;
  const int64_t q_first = p.q_offset + q0;
  const int64_t q_last = p.q_offset + rows_end - 1;
  int64_t k_end = p.Tk;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0) k_begin = q_first - p.window + 1;
  k_begin &= ~static_cast<int64_t>(kRows - 1);
  const int n_tiles = k_end > k_begin ? static_cast<int>((k_end - k_begin + kRows - 1) / kRows) : 0;

  if (tid == 0) {
    for (int s = 0; s < kStagesQ; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread streams the key tiles through the ring
    regs_dealloc<kProducerRegs>();
    if (tid == kConsumerThreads) {
      mbar_expect_tx(qbar, 2 * kConsumers * kTile);
      for (int c = 0; c < kConsumers; ++c)
        for (int nb = 0; nb < kNB; ++nb) {
          const int r = static_cast<int>(q0 + c * kRows);
          tma_load(qs + c * kTile + nb * kRows * 128, &qmap, qbar, nb * kAtom, r, h, b);
          tma_load(dos + c * kTile + nb * kRows * 128, &domap, qbar, nb * kAtom, r, h, b);
        }
      int s = 0;
      uint32_t phase = 0;
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= kStagesQ) mbar_wait(&empty[s], phase ^ 1);
        const int k0 = static_cast<int>(k_begin) + t * kRows;
        mbar_expect_tx(&full[s], 2 * kTile);
        for (int nb = 0; nb < kNB; ++nb) {
          tma_load(ks + s * kTile + nb * kRows * 128, &kmap, &full[s], nb * kAtom, k0, hk, b);
          tma_load(vs + s * kTile + nb * kRows * 128, &vmap, &full[s], nb * kAtom, k0, hk, b);
        }
        if (++s == kStagesQ) { s = 0; phase ^= 1; }
      }
    }
    return;
  }
  regs_alloc<kConsumerRegs>();

  // ---- consumer warpgroup wg: query rows wq0 ... wq0 + 63
  const int lane = tid & 31;
  const int warp = (tid / 32) & 3;
  const int r0 = warp * 16 + lane / 4;     // this thread's rows: r0 and r0 + 8
  const int c2 = (lane & 3) * 2;           // and keys 8j + c2, 8j + c2 + 1
  const int64_t wq0 = q0 + wg * kRows;
  const int64_t qa = p.q_offset + wq0;
  const int64_t qb = p.q_offset + (wq0 + kRows < p.Tq ? wq0 + kRows : p.Tq) - 1;
  const int64_t pos0 = qa + r0;
  const int64_t pos1 = pos0 + 8;
  const int64_t srow = (static_cast<int64_t>(b) * p.Hq + h) * p.Tq_pad + wq0 + r0;
  const bool in0 = wq0 + r0 < p.Tq_pad, in1 = wq0 + r0 + 8 < p.Tq_pad;
  const float l2_0 = in0 ? p.lse2[srow] : CUDART_INF_F;
  const float l2_1 = in1 ? p.lse2[srow + 8] : CUDART_INF_F;
  const float dl0 = in0 ? p.delta[srow] : 0.0f;
  const float dl1 = in1 ? p.delta[srow + 8] : 0.0f;
  const uint32_t k_s0 = smem_u32(ks);
  const uint32_t v_s0 = smem_u32(vs);

  float dq[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[nb][i] = 0.0f;
  float sc[32], dp[32];
  uint32_t dh[4][4];   // dS' in fp16
  const float s_log2 = f16->s_log2;
  const float cap_scale = CAP ? f16->cap_scale : 0.0f;
  const uint32_t q_base = smem_u32(qs + wg * kTile);
  const uint32_t do_base = smem_u32(dos + wg * kTile);
  mbar_wait(qbar, 0);

  // S = Q K^T and dP = dO V^T of the tile in stage s
  auto issue_s = [&](int s) {
    gemm_ss128(sc, q_base, k_s0 + s * kTile);
    gemm_ss128(dp, do_base, v_s0 + s * kTile);
  };
  // dQ += dS' K of the tile in stage s
  auto issue_grad = [&](int s) { gemm_rs128(dq, dh, k_s0 + s * kTile); };
  auto fence_grad = [&]() {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) reg_fence(dq[nb]);
    d64::fence_parts(dh);
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  auto probs = [&](int t) {
    reg_fence(sc);
    reg_fence(dp);
    const int64_t kt = k_begin + static_cast<int64_t>(t) * kRows;
    const bool edge = !(kt + kRows <= p.Tk && (!p.causal || kt + kRows - 1 <= qa) &&
                        (!p.has_window || kt > qb - p.window));
    d64::q_probs<CAP, 32, true>(sc, dp, l2_0, l2_1, dl0, dl1, c2, p, edge, pos0, pos1, kt,
                                s_log2, cap_scale);
    to_a16(sc, dh);
  };

  // the turns of dkdv_kernel, over key tiles: the previous tile's dQ, a
  // wait, then this tile's S and dP.  Issued together (the accumulator, the
  // previous dS, S and dP: 144 registers in flight) they made ptxas
  // serialise every wgmma of the pass at 384 threads (C7512), and the pass
  // took 2.33 ms against 1.22 at olmo's training shape (PERF.md)
  const int mine = 1 + wg;
  const int other = 1 + (wg ^ 1);
  if (n_tiles > 0) {
    if (wg == kConsumers - 1) bar_arrive(other, kConsumerThreads);
    mbar_wait(&full[0], 0);
    bar_sync(mine, kConsumerThreads);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    bar_arrive(other, kConsumerThreads);
    wgmma_wait_all();
    probs(0);
    int s = 0, sp = 0;
    uint32_t phase = 0;
#pragma unroll 1
    for (int t = 1; t < n_tiles; ++t) {
      sp = s;
      if (++s == kStagesQ) { s = 0; phase ^= 1; }
      mbar_wait(&full[s], phase);
      bar_sync(mine, kConsumerThreads);
      fence_grad();
      wgmma_fence();
      issue_grad(sp);
      wgmma_commit();
      wgmma_wait_all();
      fence_grad();
      release(sp);
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      bar_arrive(other, kConsumerThreads);
      wgmma_wait_all();
      probs(t);
    }
    bar_sync(mine, kConsumerThreads);
    fence_grad();
    wgmma_fence();
    issue_grad(s);
    wgmma_commit();
    if (wg != kConsumers - 1) bar_arrive(other, kConsumerThreads);
    wgmma_wait_all();
    fence_grad();
    release(s);
  }

  __nv_bfloat16* dqg = p.dq + (static_cast<int64_t>(b) * p.Hq + h) * p.Tq * p.D;
  const float dq_mul = f16->dq_mul;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) store_rows(dqg, dq[nb], nb, c2, wq0 + r0, p.Tq, p.D, dq_mul);
}

// (the kernels' names qualified: d64::Params would bring d64's in by
// argument-dependent lookup)
template <bool CAP>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           const CUtensorMap& dom, const Params& p, const Fp16Scales* f16, int64_t B,
           cudaStream_t stream) {
  static bool configured = false;   // the attributes are per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(d128::dkdv_kernel<CAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(d128::dq_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid_kv(static_cast<unsigned>((p.Tk + kBlockRows - 1) / kBlockRows),
                     static_cast<unsigned>(p.Hkv), static_cast<unsigned>(B));
  d128::dkdv_kernel<CAP><<<grid_kv, kConsumerThreads, kSmemKV, stream>>>(qm, km, vm, dom, p, f16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((p.Tq + kBlockRows - 1) / kBlockRows),
                    static_cast<unsigned>(p.Hq), static_cast<unsigned>(B));
  d128::dq_kernel<CAP><<<grid_q, kThreads, kSmemQ, stream>>>(qm, km, vm, dom, p, f16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace d128

// ---------------------------------------------------------------------------
// Head widths 136-256 (recurrentgemma's 256): two consumer warpgroups over
// one 64-row block, each holding half of the gradient's columns and
// computing half of S and dP, the bf16 parts of P and dS shared in shared
// memory.
// ---------------------------------------------------------------------------

namespace d256 {
using d64::Params;   // filled by narrow, as the D <= 128 kernels'
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers;
constexpr int kNB = 4;                        // 64-column atoms of the head
constexpr int kNBw = kNB / kConsumers;        // atoms of the gradient a consumer holds
constexpr int kHalf = kRows / kConsumers;     // columns of S (and dP) a consumer computes
constexpr int kAtomBytes = kRows * 128;       // one atom of a 64-row tile
constexpr int kTile = kNB * kAtomBytes;       // one 64 x 256 bf16 tile
constexpr int kPart = kAtomBytes;             // one 64 x 64 bf16 part of P or dS
constexpr int kStages = 2;                    // ring depth of both passes
constexpr int kBarFree = 1, kBarReady = 2;    // the consumers' named barriers
// (b): k and v, then the ring's q and do tiles; the parts P^T hi, lo and
// dS^T hi, lo; a stage's 64 lse2 and 64 delta
constexpr int kSmemKV = 1024 + (2 + 2 * kStages) * kTile + 4 * kPart + kStages * 2 * kRows * 4 +
                        8 * (kStages + 1);
// (c): q and do, then the k and v rings' tiles; the parts dS hi and lo
constexpr int kSmemQ = 1024 + (2 + 2 * kStages) * kTile + 2 * kPart + 8 * (2 * kStages + 1);
static_assert(kSmemKV <= 232448 && kSmemQ <= 232448, "over the 227 KB a block may use");
static_assert(kStages == 2, "a tile's stage is the other one of the tile before");

// zero the atoms past the head's first na of `n` consecutive tiles: TMA
// loads only those na, and the others add nothing to S or dP
__device__ __forceinline__ void zero_atoms(uint8_t* tiles, int n, int na, int tid) {
  if (na >= kNB) return;
  const int words = (kNB - na) * kAtomBytes / 16;   // 16-byte words a tile
  for (int i = tid; i < n * words; i += kThreads)
    reinterpret_cast<uint4*>(tiles + (i / words) * kTile + na * kAtomBytes)[i % words] =
        make_uint4(0u, 0u, 0u, 0u);
  fence_async_shared();
}

// d = A B^T over the head's four atoms for 32 rows of B: A and B 64-row
// K-major tiles, b the address of B's row 32 w; d an output only
__device__ __forceinline__ void gemm_half(float (&d)[16], uint32_t a, uint32_t b) {
  a = opaque(a);
  b = opaque(b);
  wgmma_ss_n32_first(d, desc(a), desc(b));
#pragma unroll
  for (int kk = 1; kk < 4 * kNB; ++kk) {
    const uint32_t off = (kk / 4) * kAtomBytes + (kk % 4) * 32;
    wgmma_ss_n32(d, desc(a + off), desc(b + off), 1);
  }
}

// four 8 x 8 bf16 matrices into shared memory: lanes 8 m ... 8 m + 7 give
// the addresses of matrix m's rows, and register m of each lane holds its
// fragment of matrix m (row lane / 4, columns 2 (lane % 4) and + 1), the
// layout of a wgmma accumulator's 8-column groups
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// a warp's share of a 64 x 32 float32 accumulator (its 16 rows, columns
// col0 ... col0 + 31) into the 64 x 64 bf16 parts hi and lo of an A
// operand, K-major and 128-byte swizzled (16-byte chunk c of row r at chunk
// c ^ (r & 7)), one stmatrix of four 8 x 8 matrices a part and 8 rows:
// hi = x truncated, lo = bf16(x - hi), as to_a splits
__device__ __forceinline__ void put_parts(uint32_t hi, uint32_t lo, const float (&d)[16], int warp,
                                          int lane, int col0) {
  uint32_t h[2][4], l[2][4];   // [rows 8 e ...][8-column group j]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = d[4 * j + 2 * e];
      const float c = d[4 * j + 2 * e + 1];
      const uint32_t ha = __float_as_uint(a) & 0xffff0000u;
      const uint32_t hc = __float_as_uint(c) & 0xffff0000u;
      h[e][j] = __byte_perm(ha, hc, 0x7632);
      l[e][j] = pack_bf16(__floats2bfloat162_rn(a - __uint_as_float(ha), c - __uint_as_float(hc)));
    }
  // this lane's row: row lane % 8 of matrix lane / 8, the column group
  // col0 / 8 + lane / 8
  const int i = lane & 7;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = warp * 16 + 8 * e + i;
    const uint32_t off = row * 128 + ((((col0 >> 3) + (lane >> 3)) ^ i) << 4);
    stmatrix_x4(hi + off, h[e]);
    stmatrix_x4(lo + off, l[e]);
  }
}

// d[i] += (hi + lo) . B[:, atom nb0 + i] for i < kNBw (= 2): hi, lo the 64 x
// 64 parts of A in shared memory (K-major), B a 64-row tile read MN-major,
// both atoms in one m64n128k16 (a step reads A once for 128 columns)
static_assert(kNBw == 2, "a consumer's two atoms are one 128-column wgmma");
__device__ __forceinline__ void gemm_parts(float (&d)[kNBw][32], uint32_t hi, uint32_t lo,
                                           uint32_t b, int nb0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_mn(b + nb0 * kAtomBytes + kk * 16 * 128, kAtomBytes);
    wgmma_ss_tb_n128(d, desc(hi + kk * 32), db);
    wgmma_ss_tb_n128(d, desc(lo + kk * 32), db);
  }
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(d[i]);
}

// (b) dK and dV of 64 keys of one kv head.  Consumer w computes S^T and
// dP^T for query columns 32 w ... + 31 of each tile and holds dK and dV of
// the head's atoms 2 w and 2 w + 1 (128 registers a thread).  Per tile: S^T
// and dP^T (which also waits for the previous tile's dV and dK), P^T and
// dS^T, a barrier (both consumers' previous dV, dK have read the parts),
// the parts stored, a barrier, then dV += P^T dO and dK += dS^T Q issued
// and left running, and thread 0 issues tile t + 1's loads into the stage of
// tile t - 1, which every warp's wait before the barriers has freed.
template <bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
            const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;                                // the k tile
  uint8_t* vs = ks + kTile;                          // the v tile
  uint8_t* qs = vs + kTile;                          // kStages q tiles
  uint8_t* dos = qs + kStages * kTile;               // kStages do tiles
  uint8_t* parts = dos + kStages * kTile;            // P^T hi, lo, dS^T hi, lo
  float* lse_s = reinterpret_cast<float*>(parts + 4 * kPart);   // kStages x 64
  float* delta_s = lse_s + kStages * kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + kStages * kRows);
  uint64_t* kbar = full + kStages;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int64_t kt = static_cast<int64_t>(blockIdx.x) * kRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  // the 64-row query tiles that see one of keys [kt, k_last]: the same for
  // every query head of the group
  const int64_t k_last = (kt + kRows < p.Tk ? kt + kRows : p.Tk) - 1;
  int64_t i_lo = 0, i_hi = p.Tq;
  if (p.causal && kt - p.q_offset > i_lo) i_lo = kt - p.q_offset;
  if (p.has_window && k_last + p.window - p.q_offset < i_hi) i_hi = k_last + p.window - p.q_offset;
  i_lo &= ~static_cast<int64_t>(kRows - 1);
  const int n_qt = i_hi > i_lo ? static_cast<int>((i_hi - i_lo + kRows - 1) / kRows) : 0;
  const int n_iter = p.group * n_qt;
  const int na = static_cast<int>((p.D + kAtom - 1) / kAtom);
  zero_atoms(ks, 2 + 2 * kStages, na, tid);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(kbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t: query head hk G + t / n_qt, rows i_lo + 64 (t % n_qt) ...
  auto issue = [&](int t) {
    const int s = t % kStages;
    const int h = hk * p.group + t / n_qt;
    const int q0 = static_cast<int>(i_lo) + (t % n_qt) * kRows;
    mbar_expect_tx(&full[s], 2 * na * kAtomBytes + 2 * kRows * 4);
    for (int nb = 0; nb < na; ++nb) {
      tma_load(qs + s * kTile + nb * kAtomBytes, &qmap, &full[s], nb * kAtom, q0, h, b);
      tma_load(dos + s * kTile + nb * kAtomBytes, &domap, &full[s], nb * kAtom, q0, h, b);
    }
    const int64_t row = (static_cast<int64_t>(b) * p.Hq + h) * p.Tq_pad + q0;
    bulk_load(lse_s + s * kRows, p.lse2 + row, kRows * 4, &full[s]);
    bulk_load(delta_s + s * kRows, p.delta + row, kRows * 4, &full[s]);
  };
  if (tid == 0) {
    mbar_expect_tx(kbar, 2 * na * kAtomBytes);
    for (int nb = 0; nb < na; ++nb) {
      tma_load(ks + nb * kAtomBytes, &kmap, kbar, nb * kAtom, static_cast<int>(kt), hk, b);
      tma_load(vs + nb * kAtomBytes, &vmap, kbar, nb * kAtom, static_cast<int>(kt), hk, b);
    }
    for (int t = 0; t < kStages && t < n_iter; ++t) issue(t);
  }

  // ---- consumer warpgroup wg: query columns col0 ... col0 + 31 of S^T
  const int lane = tid & 31;
  const int warp = (tid / 32) & 3;
  const int r0 = warp * 16 + lane / 4;     // this thread's keys: kt + r0 and kt + r0 + 8
  const int c2 = (lane & 3) * 2;           // and query columns col0 + 8j + c2, + 1
  const int col0 = wg * kHalf;
  const uint32_t k_base = smem_u32(ks);
  const uint32_t v_base = smem_u32(vs);
  const uint32_t ph = smem_u32(parts), pl = ph + kPart, sh = pl + kPart, sl = sh + kPart;
  float dk[kNBw][32], dv[kNBw][32];
#pragma unroll
  for (int i = 0; i < kNBw; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[i][e] = dv[i][e] = 0.0f;
  float st[16], dpt[16];
  mbar_wait(kbar, 0);

  int s = 0, qt = 0;
  uint32_t phase = 0;
  PHASE_START
#pragma unroll 1
  for (int t = 0; t < n_iter; ++t) {
    mbar_wait(&full[s], phase);
    PHASE(0)
    const uint32_t q_s = smem_u32(qs + s * kTile);
    const uint32_t do_s = smem_u32(dos + s * kTile);
    wgmma_fence();
    gemm_half(st, k_base, q_s + col0 * 128);
    gemm_half(dpt, v_base, do_s + col0 * 128);
    wgmma_commit();
    PHASE(1)
    wgmma_wait_all();
    fence_acc(dk);
    fence_acc(dv);
    reg_fence(st);
    reg_fence(dpt);
    PHASE(2)
    const int64_t q0 = i_lo + static_cast<int64_t>(qt) * kRows;
    const int64_t qa = p.q_offset + q0;                                          // first row
    const int64_t qb = p.q_offset + (q0 + kRows < p.Tq ? q0 + kRows : p.Tq) - 1;  // last row
    const bool edge = !(kt + kRows <= p.Tk && (!p.causal || kt + kRows - 1 <= qa) &&
                        (!p.has_window || kt > qb - p.window));
    PHASE(3)
    d64::kv_probs<CAP>(st, dpt, lse_s + s * kRows + col0, delta_s + s * kRows + col0, c2, p,
                       edge, qa + col0, kt + r0);
    PHASE(4)
    bar_sync(kBarFree, kThreads);
    PHASE(5)
    put_parts(ph, pl, st, warp, lane, col0);
    put_parts(sh, sl, dpt, warp, lane, col0);
    PHASE(6)
    fence_async_shared();
    PHASE(7)
    bar_sync(kBarReady, kThreads);
    PHASE(8)
    wgmma_fence();
    gemm_parts(dv, ph, pl, do_s, kNBw * wg);
    gemm_parts(dk, sh, sl, q_s, kNBw * wg);
    wgmma_commit();
    // the previous tile's stage (its dV, dK, S^T and dP^T ended at every
    // warp's wait before the barriers): tile t + 1 loads into it while this
    // tile's products run.  Issued earlier, at that wait, the loads slowed
    // the P, dS and part stores that share the SM's shared memory with them
    // more than they gained (PERF.md)
    if (tid == 0 && t > 0 && t + 1 < n_iter) issue(t + 1);
    // dV and dK end within this tile: left in flight across the next
    // tile's S^T and dP^T they made ptxas serialise every wgmma (C7515),
    // and the next tile's loads take longer than they do
    wgmma_wait_all();
    fence_acc(dk);
    fence_acc(dv);
    PHASE(9)
    if (++s == kStages) { s = 0; phase ^= 1; }
    if (++qt == n_qt) qt = 0;
  }
  wgmma_wait_all();
  fence_acc(dk);
  fence_acc(dv);
  PHASE(2)
  PHASE_END(0)

  const int64_t off = (static_cast<int64_t>(b) * p.Hkv + hk) * p.Tk * p.D;
#pragma unroll
  for (int i = 0; i < kNBw; ++i) {
    store_rows(p.dk + off, dk[i], kNBw * wg + i, c2, kt + r0, p.Tk, p.D, p.scale);
    store_rows(p.dv + off, dv[i], kNBw * wg + i, c2, kt + r0, p.Tk, p.D, 1.0f);
  }
}

// (c) dQ of 64 query rows of one query head.  Consumer w computes S and dP
// for keys 32 w ... + 31 of each tile and holds dQ of the head's atoms 2 w
// and 2 w + 1 (64 registers a thread); a tile runs as (b)'s, with dS in
// two parts shared.  k and v have rings of their own: v serves only dP, so
// its stage is free once S and dP are, and v runs two tiles ahead.
template <bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
          const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                                // the q tile
  uint8_t* dos = qs + kTile;                         // the do tile
  uint8_t* ks = dos + kTile;                         // kStages k tiles
  uint8_t* vs = ks + kStages * kTile;                // kStages v tiles
  uint8_t* parts = vs + kStages * kTile;             // dS hi, lo
  uint64_t* kfull = reinterpret_cast<uint64_t*>(parts + 2 * kPart);
  uint64_t* vfull = kfull + kStages;
  uint64_t* qbar = vfull + kStages;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // the last query rows see the most keys: start them first
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;

  // the 64-key tiles that any row of this block can see
  const int64_t rows_end = q0 + kRows < p.Tq ? q0 + kRows : p.Tq;
  const int64_t q_first = p.q_offset + q0;
  const int64_t q_last = p.q_offset + rows_end - 1;
  int64_t k_end = p.Tk;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (p.has_window && q_first - p.window + 1 > 0) k_begin = q_first - p.window + 1;
  k_begin &= ~static_cast<int64_t>(kRows - 1);
  const int n_tiles = k_end > k_begin ? static_cast<int>((k_end - k_begin + kRows - 1) / kRows) : 0;
  const int na = static_cast<int>((p.D + kAtom - 1) / kAtom);
  zero_atoms(qs, 2 + 2 * kStages, na, tid);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // key tile t's k (or v) tile into its ring's stage t % kStages
  auto issue = [&](uint8_t* ring, const CUtensorMap* map, uint64_t* full, int t) {
    const int s = t % kStages;
    const int k0 = static_cast<int>(k_begin) + t * kRows;
    mbar_expect_tx(&full[s], na * kAtomBytes);
    for (int nb = 0; nb < na; ++nb)
      tma_load(ring + s * kTile + nb * kAtomBytes, map, &full[s], nb * kAtom, k0, hk, b);
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * na * kAtomBytes);
    for (int nb = 0; nb < na; ++nb) {
      tma_load(qs + nb * kAtomBytes, &qmap, qbar, nb * kAtom, static_cast<int>(q0), h, b);
      tma_load(dos + nb * kAtomBytes, &domap, qbar, nb * kAtom, static_cast<int>(q0), h, b);
    }
    for (int t = 0; t < kStages && t < n_tiles; ++t) {
      issue(ks, &kmap, kfull, t);
      issue(vs, &vmap, vfull, t);
    }
  }

  // ---- consumer warpgroup wg: keys col0 ... col0 + 31 of each tile's S
  const int lane = tid & 31;
  const int warp = (tid / 32) & 3;
  const int r0 = warp * 16 + lane / 4;     // this thread's rows: r0 and r0 + 8
  const int c2 = (lane & 3) * 2;           // and keys col0 + 8j + c2, + 1
  const int col0 = wg * kHalf;
  const int64_t qa = p.q_offset + q0;
  const int64_t qb = p.q_offset + rows_end - 1;
  const int64_t pos0 = qa + r0;
  const int64_t pos1 = pos0 + 8;
  // rows past Tq are below Tq_pad, where lse2 is +inf: P and dS are 0 there
  const int64_t srow = (static_cast<int64_t>(b) * p.Hq + h) * p.Tq_pad + q0 + r0;
  const float l2_0 = p.lse2[srow], l2_1 = p.lse2[srow + 8];
  const float dl0 = p.delta[srow], dl1 = p.delta[srow + 8];
  const uint32_t q_base = smem_u32(qs);
  const uint32_t do_base = smem_u32(dos);
  const uint32_t dh = smem_u32(parts), dl = dh + kPart;
  float dq[kNBw][32];
#pragma unroll
  for (int i = 0; i < kNBw; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[i][e] = 0.0f;
  float sc[16], dp[16];
  mbar_wait(qbar, 0);

  int s = 0;
  uint32_t phase = 0;
  PHASE_START
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(&kfull[s], phase);
    mbar_wait(&vfull[s], phase);
    PHASE(0)
    const uint32_t k_s = smem_u32(ks + s * kTile);
    const uint32_t v_s = smem_u32(vs + s * kTile);
    wgmma_fence();   // (no register fence on dQ, in flight: as in (b))
    gemm_half(sc, q_base, k_s + col0 * 128);
    gemm_half(dp, do_base, v_s + col0 * 128);
    wgmma_commit();
    PHASE(1)
    wgmma_wait_all();
    fence_acc(dq);
    reg_fence(sc);
    reg_fence(dp);
    PHASE(2)
    const int64_t kt = k_begin + static_cast<int64_t>(t) * kRows;
    const bool edge = !(kt + kRows <= p.Tk && (!p.causal || kt + kRows - 1 <= qa) &&
                        (!p.has_window || kt > qb - p.window));
    PHASE(3)
    d64::q_probs<CAP>(sc, dp, l2_0, l2_1, dl0, dl1, c2, p, edge, pos0, pos1, kt + col0);
    PHASE(4)
    bar_sync(kBarFree, kThreads);
    PHASE(5)
    put_parts(dh, dl, sc, warp, lane, col0);
    PHASE(6)
    fence_async_shared();
    PHASE(7)
    bar_sync(kBarReady, kThreads);
    PHASE(8)
    wgmma_fence();
    gemm_parts(dq, dh, dl, k_s, kNBw * wg);
    wgmma_commit();
    // every warp's wait before the barriers ended the previous tile's dQ and
    // this tile's S and dP: k of tile t + 1 goes into the previous tile's k
    // stage, v of tile t + 2 into this tile's v stage (v serves dP alone),
    // while this tile's dQ runs
    if (tid == 0) {
      if (t > 0 && t + 1 < n_tiles) issue(ks, &kmap, kfull, t + 1);
      if (t + 2 < n_tiles) issue(vs, &vmap, vfull, t + 2);
    }
    PHASE(9)
    if (++s == kStages) { s = 0; phase ^= 1; }
  }
  wgmma_wait_all();
  fence_acc(dq);
  PHASE(2)
  PHASE_END(1)

  __nv_bfloat16* dqg = p.dq + (static_cast<int64_t>(b) * p.Hq + h) * p.Tq * p.D;
#pragma unroll
  for (int i = 0; i < kNBw; ++i)
    store_rows(dqg, dq[i], kNBw * wg + i, c2, q0 + r0, p.Tq, p.D, p.scale);
}

template <bool CAP>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           const CUtensorMap& dom, const Params& p, int64_t B, cudaStream_t stream) {
  static bool configured = false;   // the attributes are per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(d256::dkdv_kernel<CAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(d256::dq_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemQ);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid_kv(static_cast<unsigned>((p.Tk + kRows - 1) / kRows),
                     static_cast<unsigned>(p.Hkv), static_cast<unsigned>(B));
  d256::dkdv_kernel<CAP><<<grid_kv, kThreads, kSmemKV, stream>>>(qm, km, vm, dom, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((p.Tq + kRows - 1) / kRows),
                    static_cast<unsigned>(p.Hq), static_cast<unsigned>(B));
  d256::dq_kernel<CAP><<<grid_q, kThreads, kSmemQ, stream>>>(qm, km, vm, dom, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace d256

// the Params of the D <= 128 kernels, filled from the wide one's
d64::Params narrow(const Params& w) {
  d64::Params p;
  p.lse2 = w.lse2;
  p.delta = w.delta;
  p.dq = w.dq;
  p.dk = w.dk;
  p.dv = w.dv;
  p.Tq = w.Tq; p.Tk = w.Tk; p.Tq_pad = w.Tq_pad; p.D = w.D;
  p.window = w.window; p.q_offset = w.q_offset;
  p.Hq = static_cast<int>(w.Hq); p.Hkv = static_cast<int>(w.Hkv);
  p.group = static_cast<int>(w.group);
  p.causal = w.causal; p.has_window = w.has_window;
  p.scale = w.scale; p.scale_log2 = w.scale_log2;
  p.cap_scale = w.has_softcap ? w.scale / w.softcap : 0.0f;
  p.cap_log2 = w.softcap * kLog2e;
  return p;
}

int blocks(int64_t* out, int64_t keys, int64_t splits, int64_t kv_threads, int64_t rows,
           int64_t q_threads) {
  const int64_t v[8] = {keys, splits, kv_threads, rows, q_threads, kRows, kRows, kRows};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}


}  // namespace

// q, o, dout: (B, Hq, Tq, D), k and v: (B, Hkv, Tk, D), bfloat16, each with
// unit stride in D and the given strides (in elements) in its first three
// dimensions, every base address and stride a multiple of 16 bytes; lse:
// contiguous float32 (B, Hq, Tq), the forward's row log-sum-exp (-inf where
// a row sees no key); stats: contiguous float32 scratch of 2 x B x Hq x
// Tq_pad (Tq_pad = Tq rounded up to 64), 16-byte aligned; dq, dk, dv:
// contiguous, of q's, k's and v's shapes, bfloat16.  At D <= 128 also q16,
// k16, v16, do16: contiguous fp16 scratch of q's, k's, v's and q's shapes,
// and aux: float32 scratch of kAuxFloats, all 16-byte aligned (null at
// other widths).  8 <= D <= 256 with D a multiple of 8, Hq a multiple of
// Hkv, Tk >= 1.  Launches three kernels on `stream` (five at D <= 128: the
// maxima and q, k, v's conversion first); returns the first cudaError_t
// (0 on success; cudaErrorInvalidValue for arguments the kernel does not
// take or a tensor map CUDA refuses).  The caller checks shapes, types and
// devices.
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* stats, void* dq, void* dk, void* dv, void* q16, void* k16,
    void* v16, void* do16, void* aux, int64_t B, int64_t Hq, int64_t Hkv, int64_t Tq,
    int64_t Tk, int64_t D, int64_t q_sb, int64_t q_sh, int64_t q_st, int64_t k_sb,
    int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t o_sb,
    int64_t o_sh, int64_t o_st, int64_t do_sb, int64_t do_sh, int64_t do_st, int causal,
    int has_window, int64_t window, int64_t q_offset, int has_softcap, float softcap,
    float scale, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (D < 8 || D > 256 || D % 8 != 0 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 ||
      Hkv > 65535 || B > 65535 || Tk < 1 || Tq > 0x7fffff00 || Tk > 0x7fffffff)
    return static_cast<int>(bad);
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  const int64_t DP = (D + 63) / 64 * 64;
  const bool f16 = DP <= 128;
  if (f16 && (q16 == nullptr || k16 == nullptr || v16 == nullptr || do16 == nullptr ||
              aux == nullptr))
    return static_cast<int>(bad);
  CUtensorMap qm, km, vm, dom;
  if (f16) {   // the fp16 copies, contiguous
    const CUtensorMapDataType h = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    if (!make_map(&qm, q16, D, Tq, Hq, B, D, Tq * D, Hq * Tq * D, kRows, h) ||
        !make_map(&km, k16, D, Tk, Hkv, B, D, Tk * D, Hkv * Tk * D, kRows, h) ||
        !make_map(&vm, v16, D, Tk, Hkv, B, D, Tk * D, Hkv * Tk * D, kRows, h) ||
        !make_map(&dom, do16, D, Tq, Hq, B, D, Tq * D, Hq * Tq * D, kRows, h))
      return static_cast<int>(bad);
  } else if (!make_map(&qm, q, D, Tq, Hq, B, q_st, q_sh, q_sb, kRows) ||
             !make_map(&km, k, D, Tk, Hkv, B, k_st, k_sh, k_sb, kRows) ||
             !make_map(&vm, v, D, Tk, Hkv, B, v_st, v_sh, v_sb, kRows) ||
             !make_map(&dom, dout, D, Tq, Hq, B, do_st, do_sh, do_sb, kRows)) {
    return static_cast<int>(bad);
  }
  Params p;
  p.Tq_pad = (Tq + kRows - 1) / kRows * kRows;
  const int64_t stat_rows = B * Hq * p.Tq_pad;
  p.lse = static_cast<const float*>(lse);
  p.lse2 = static_cast<float*>(stats);
  p.delta = p.lse2 + stat_rows;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk; p.D = D; p.group = Hq / Hkv;
  p.window = window; p.q_offset = q_offset;
  p.causal = causal; p.has_window = has_window; p.has_softcap = has_softcap;
  p.softcap = softcap; p.scale = scale; p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* parts = static_cast<uint32_t*>(aux);
  Fp16Scales* sc = f16 ? reinterpret_cast<Fp16Scales*>(parts + 4 * kConvBlocks) : nullptr;
  if (f16) {
    const auto src = [](const void* x, int64_t sb, int64_t sh, int64_t st, int64_t H,
                        int64_t T, int64_t B) {
      return Src16{static_cast<const __nv_bfloat16*>(x), sb, sh, st, H, T, B * H * T};
    };
    const ConvArgs a{{src(q, q_sb, q_sh, q_st, Hq, Tq, B), src(k, k_sb, k_sh, k_st, Hkv, Tk, B),
                      src(v, v_sb, v_sh, v_st, Hkv, Tk, B),
                      src(dout, do_sb, do_sh, do_st, Hq, Tq, B)},
                     {static_cast<__half*>(q16), static_cast<__half*>(k16),
                      static_cast<__half*>(v16), static_cast<__half*>(do16)},
                     D, 4};
    // the maxima of all four, the copies of q, k and v (stats_kernel converts do)
    const cudaError_t err = convert_fp16(a, 3, parts, ScalesOut{sc, scale, softcap, has_softcap}, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // eight lanes a row up to 64 columns (four rows a warp), a warp above
  const __nv_bfloat16* o16 = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* g16 = static_cast<const __nv_bfloat16*>(dout);
  const int64_t warps = kStatThreads / 32;
  if (D <= 64)
    stats_kernel<8><<<static_cast<unsigned>((stat_rows + 4 * warps - 1) / (4 * warps)),
                      kStatThreads, 0, s>>>(p, o16, g16, o_sb, o_sh, o_st, do_sb, do_sh, do_st,
                                            stat_rows, sc, static_cast<__half*>(do16));
  else
    stats_kernel<32><<<static_cast<unsigned>((stat_rows + warps - 1) / warps), kStatThreads, 0,
                       s>>>(p, o16, g16, o_sb, o_sh, o_st, do_sb, do_sh, do_st, stat_rows, sc,
                            static_cast<__half*>(do16));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const d64::Params n = narrow(p);
  switch (DP) {
    case 64:
      return p.has_softcap ? d64::launch<true>(qm, km, vm, dom, n, sc, B, s)
                           : d64::launch<false>(qm, km, vm, dom, n, sc, B, s);
    case 128:
      return p.has_softcap ? d128::launch<true>(qm, km, vm, dom, n, sc, B, s)
                           : d128::launch<false>(qm, km, vm, dom, n, sc, B, s);
    default:
      return p.has_softcap ? d256::launch<true>(qm, km, vm, dom, n, B, s)
                           : d256::launch<false>(qm, km, vm, dom, n, B, s);
  }
}

// the floats of the scratch `aux` at D <= 128
extern "C" int flash_attention_bwd_sm90_aux_floats() { return kAuxFloats; }

// The blocks of both passes at head width D (8 <= D <= 256), which the
// wrapper mirrors (flash_attention_bwd_sm90.py::block_config): out[0..7] =
// keys a dK/dV block, the blocks that split one key block's columns,
// threads a dK/dV block, query rows a dQ block, threads a dQ block, query
// rows a tile of the dK/dV pass, keys a tile of the dQ pass, and the rows
// the scratch pads Tq to.  Returns cudaErrorInvalidValue for another D.
extern "C" int flash_attention_bwd_sm90_blocks(int64_t D, int64_t* out) {
  if (D < 8 || D > 256 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch ((D + 63) / 64 * 64) {
    case 64:
      return blocks(out, d64::kBlockRows, 1, d64::kConsumerThreads, d64::kBlockRows,
                    d64::kQThreads);
    case 128:
      return blocks(out, d128::kBlockRows, 1, d128::kConsumerThreads, d128::kBlockRows,
                    d128::kThreads);
    default: return blocks(out, kRows, 1, d256::kThreads, kRows, d256::kThreads);
  }
}

#ifdef FLASH_PHASE_CLOCKS
// copies the phase sums out (d256's (b) and (c), then d64's, then d128's
// (b), kClockPhases each), or zeroes them when `out` is null; returns the
// cudaError_t
extern "C" int flash_bwd_sm90_phase_clocks_read(unsigned long long* out) {
  if (out == nullptr) {
    const unsigned long long zero[5][kClockPhases] = {};
    return static_cast<int>(cudaMemcpyToSymbol(flash_bwd_sm90_phase_clocks, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, flash_bwd_sm90_phase_clocks,
                                               sizeof(flash_bwd_sm90_phase_clocks)));
}
#endif
