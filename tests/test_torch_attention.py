"""Long-context attention in the port vs the JAX reference.

Above 4096 kv positions the reference computes attention blockwise
(``models/layers.py::_blockwise_attention``, the jnp twin of the Pallas
``flash_attention_pallas``); the port sends it to ``ops.flash_attention``,
whose plain version ``ref_flash_attention`` runs here on the CPU and
whose CUDA kernel runs on the card (``chip_smoke.py`` holds the kernel
against the plain version there).  These tests hold the plain version to
the Pallas kernel in interpret mode and to ``_blockwise_attention`` at
the tolerances of ``tests/test_kernels.py`` (2e-5 in float32, 3e-2 in
bf16), the port's ``attention_core`` to the reference's at 4100 kv
positions, and greedy generation on 4200-token prompts to
``repro.launch.serve.generate`` (last prefill logits within 1e-4, tokens
equal).  Inputs are made with numpy from a seed.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.distributed.axes import clear_logical_rules
from repro.kernels.flash_attention import flash_attention_pallas
from repro.launch.serve import generate as jgenerate
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_sm90 as tfa90
from repro_torch.kernels import ref as tref
from repro_torch.launch.serve import generate
from repro_torch.models import build_model
from repro_torch.models import layers as TL

torch.set_num_threads(2)

TOL = {np.float32: 2e-5, jnp.bfloat16: 3e-2}     # tests/test_kernels.py:84, :93
LOGIT_TOL = 1e-4
LONG_T0, LONG_NEW = 4200, 4                      # > BLOCKWISE_KV_THRESHOLD


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything asks for the CUDA library."""
    def refuse(name):
        raise AssertionError(f"CUDA build of {name!r} requested")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(tfa, "_fn", None)
    monkeypatch.setattr(tfa90, "_fn", None)


def _qkv(B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    return q, k, v


def _torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype is jnp.bfloat16 else t


def _np(t):
    return t.float().numpy()


# (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, dtype): the cases of
# tests/test_kernels.py:65-104, then D = 120 GQA with a window (the long
# serving path's head width) and D = 256 MQA
PALLAS_CASES = [
    (2, 4, 2, 64, 64, 32, True, None, None, np.float32),      # GQA causal
    (1, 8, 1, 37, 37, 16, True, None, None, np.float32),      # MQA, ragged T
    (2, 2, 2, 50, 70, 8, False, None, None, np.float32),      # cross-ish, pad_k
    (1, 4, 2, 96, 96, 64, True, 24, None, np.float32),        # sliding window
    (1, 2, 1, 1, 40, 16, True, None, None, np.float32),       # decode shape
    (1, 4, 4, 128, 128, 128, True, None, None, np.float32),   # TPU-aligned
    (1, 4, 2, 64, 64, 32, True, None, None, jnp.bfloat16),    # bf16
    (1, 2, 2, 32, 32, 16, True, None, 20.0, np.float32),      # softcap
    (1, 8, 2, 150, 150, 120, True, 40, None, np.float32),     # D = 120 GQA, window
    (1, 4, 1, 40, 72, 256, True, None, None, np.float32),     # D = 256 MQA
]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap,dtype", PALLAS_CASES)
def test_ref_flash_attention_matches_pallas(B, Hq, Hkv, Tq, Tk, D, causal, window, softcap,
                                            dtype):
    q, k, v = _qkv(B, Hq, Hkv, Tq, Tk, D, seed=Tq * 1000 + D)
    qo = Tk - Tq if causal else 0
    want = flash_attention_pallas(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                                  jnp.asarray(v, dtype), causal=causal, window=window,
                                  q_offset=qo, softcap=softcap, interpret=True)
    # chunks of 32 keys: the online softmax carries its state across slices
    got = tref.ref_flash_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                                   causal=causal, window=window, q_offset=qo,
                                   softcap=softcap, chunk=32)
    assert got.dtype == (torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("causal,window,softcap,q_offset", [
    (True, None, None, 2100 - 300),      # causal, queries at the end
    (True, 700, None, 2100 - 300),       # window: early chunks fully masked
    (False, None, 30.0, 0),              # softcap, no mask
    (True, None, None, -50),             # rows before the first key: zeros
])
def test_ref_flash_attention_matches_blockwise(causal, window, softcap, q_offset):
    q, k, v = _qkv(1, 4, 2, 300, 2100, 16, seed=3)   # 3 chunks of 1024, the last ragged
    want = JL._blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window, q_offset=q_offset,
                                   softcap=softcap, chunk=1024)
    got = tref.ref_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal, window=window,
                                   q_offset=q_offset, softcap=softcap, chunk=1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL[np.float32])
    if q_offset < 0:
        assert not got[:, :, :-q_offset].any()


@pytest.mark.parametrize("window", [None, 8])
def test_attention_core_blockwise_matches_jax(window):
    """Tk = 4100 > BLOCKWISE_KV_THRESHOLD: both packages take the blockwise path."""
    T = 4100
    assert TL.BLOCKWISE_KV_THRESHOLD == JL.BLOCKWISE_KV_THRESHOLD < T
    # the CPU path walks the keys in the plain version's default chunk
    chunk = inspect.signature(tref.ref_flash_attention).parameters["chunk"].default
    assert TL.BLOCKWISE_CHUNK == chunk == JL.BLOCKWISE_CHUNK
    q, k, v = _qkv(1, 4, 2, T, T, 16, seed=9)
    kw = dict(causal=True, window=window, q_offset=0, softcap=None)
    want = JL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = TL.attention_core(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL[np.float32])


def test_ops_flash_attention_on_cpu_runs_the_plain_version(no_build):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 70, 90, 24, seed=4))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True, window=30, q_offset=20)
    want = tref.ref_flash_attention(q, k, v, causal=True, window=30, q_offset=20)
    assert torch.equal(got, want)
    assert ops.launch_counts() == {"linear_scan": 0, "page_digest": 0, "delta_mask": 0,
                                   "flash_attention": 0, "flash_attention_sm90": 0,
                                   "flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0}


def test_ops_flash_attention_refuses_autograd_off_the_cpu(no_build):
    """Off the CPU a call that autograd records takes the kernels too:
    on the meta device it reaches the kernel's wrapper, whose check
    raises before anything is built or launched, with grad on and off."""
    q, k, v = (torch.empty(1, 2, 8, 16, device="meta", requires_grad=True) for _ in range(3))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v)      # recorded: _FlashAttention's forward
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v)      # reaches the kernel's wrapper, which checks
    assert ops.launch_counts() == before


@pytest.mark.parametrize("case", ["cpu_tensor", "dtype", "mixed_dtype", "head_dim", "groups",
                                  "rank", "stride", "meta_device", "no_kv_heads"])
def test_cuda_wrapper_rejects_bad_inputs_before_building(case, no_build):
    q, k, v = (torch.rand(1, 4, 8, 16), torch.rand(1, 2, 8, 16), torch.rand(1, 2, 8, 16))
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        q = q.to(torch.bfloat16)
    elif case == "head_dim":
        q, k, v = torch.rand(1, 4, 8, 264), torch.rand(1, 2, 8, 264), torch.rand(1, 2, 8, 264)
    elif case == "groups":
        k, v = torch.rand(1, 3, 8, 16), torch.rand(1, 3, 8, 16)
    elif case == "rank":
        q = q[0]
    elif case == "stride":
        k = torch.rand(1, 2, 16, 8).transpose(2, 3)
    elif case == "meta_device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    elif case == "no_kv_heads":
        k, v = torch.rand(1, 0, 8, 16), torch.rand(1, 0, 8, 16)
    before = tfa.launches
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_attention_cuda(q, k, v)
    assert tfa.launches == before


# (Hq, Hkv, D) -> (head_pad, rows, heads): the float32 kernel's layout for
# the head width and its stacking of a GQA group into 128 rows (64 at 256
# columns): the long path's 4-head groups, MQA, no grouping, a group of 3
# (the last block of a group holds an empty head), D off every layout
TILINGS = [
    ((32, 8, 120), (128, 32, 4)),
    ((8, 1, 120), (128, 16, 8)),
    ((4, 4, 128), (128, 128, 1)),
    ((6, 2, 64), (64, 64, 2)),
    ((32, 1, 64), (64, 16, 8)),
    ((4, 2, 256), (256, 32, 2)),
    ((2, 2, 256), (256, 64, 1)),
    ((4, 2, 8), (64, 64, 2)),
    ((4, 2, 100), (128, 64, 2)),
    ((4, 2, 33), (64, 64, 2)),
]


@pytest.mark.parametrize("shape,want", TILINGS)
def test_tiling_stacks_the_group_into_whole_warps(shape, want):
    Hq, Hkv, D = shape
    t = tfa.tiling(Hq, Hkv, D)
    assert tuple(t) == want
    assert D <= t.head_pad and t.rows % 16 == 0
    assert t.rows * t.heads == (64 if t.head_pad == 256 else 128)


@pytest.mark.parametrize("Hq,Hkv,Tq,D", [(32, 8, 100, 120), (6, 2, 70, 64), (32, 1, 20, 64),
                                         (4, 4, 129, 128), (4, 2, 33, 256)])
def test_tiling_covers_every_query_row_once(Hq, Hkv, Tq, D):
    """The kernel's grid over a tiling, (position tiles, kv heads x head
    chunks): stacked row r of block (x, y) is head h0 + r // rows at
    position q0 + r % rows, kept when both are in range; every (head,
    position) is computed by exactly one block."""
    t = tfa.tiling(Hq, Hkv, D)
    group = Hq // Hkv
    chunks = -(-group // t.heads)
    seen = []
    for x in range(-(-Tq // t.rows)):
        for y in range(Hkv * chunks):
            hk, h0 = y // chunks, (y // chunks) * group + (y % chunks) * t.heads
            for r in range(t.rows * t.heads):
                head, pos = h0 + r // t.rows, x * t.rows + r % t.rows
                if head < (hk + 1) * group and pos < Tq:
                    seen.append((head, pos))
    assert sorted(seen) == [(h, i) for h in range(Hq) for i in range(Tq)]


# ------------------------------------------- the bf16 tensor-core kernel's arithmetic
BF16_REL, BF16_FLOOR = 2.0 ** -7, 1e-4     # chip_smoke.py's per-element limit for bf16


def _tensor_core_model(q, k, v, *, window, q_offset, p_parts, tile=64):
    """Plain PyTorch rounding as ``csrc/flash_attention_sm90.cu`` does, for
    one (batch, head), causal: bf16 q and k multiplied exactly and summed
    in float32, scaled by D^-0.5 in float32; the online softmax over
    64-key tiles in float32, whose reference point m moves only when a
    row's max grows by more than 8 in exp2 units (so p < 256); P rounded
    to bf16 in ``p_parts`` parts (hi = bf16(p), lo = bf16(p - hi)) and
    each part's product with the bf16 v summed in float32; l from the
    unrounded p; bf16 output."""
    Tq, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    qpos = q_offset + torch.arange(Tq)[:, None]
    m = torch.full((Tq, 1), -1e30)
    l = torch.zeros((Tq, 1))
    acc = torch.zeros((Tq, D))
    for j0 in range(0, k.shape[0], tile):
        kpos = torch.arange(j0, min(j0 + tile, k.shape[0]))[None, :]
        live = (kpos <= qpos) & (kpos > qpos - window)
        if not live.any():
            continue
        s = (qf @ kf[j0:j0 + tile].T) * D ** -0.5
        s = s.masked_fill(~live, -1e30)
        mx = s.amax(-1, keepdim=True)
        m_new = torch.where(mx - m > 8 * np.log(2.0), mx, m)
        p = torch.exp(s - m_new).masked_fill(~live, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        rest = p
        for _ in range(p_parts):
            part = rest.bfloat16().float()
            acc = acc + part @ vf[j0:j0 + tile]
            rest = rest - part
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).bfloat16()


@pytest.mark.parametrize("p_parts", [2, 1])
def test_tensor_core_rounding_holds_the_bf16_limit_only_with_p_in_two_parts(p_parts):
    """One head over 4352 keys, window 4096: the rows see ~4096 keys each,
    where an output is ~0.03 and one bf16 ulp of it is the limit.  P in
    two bf16 parts (the kernel's design) stays within 2^-7 |want| + 1e-4
    of the plain version; P rounded once does not."""
    Tq, Tk, D, window = 256, 4352, 120, 4096
    q, k, v = (torch.from_numpy(x[0, 0]).bfloat16() for x in _qkv(1, 1, 1, Tq, Tk, D, seed=17))
    got = _tensor_core_model(q, k, v, window=window, q_offset=Tk - Tq, p_parts=p_parts)
    want = tref.ref_flash_attention(q[None, None], k[None, None], v[None, None], causal=True,
                                    window=window, q_offset=Tk - Tq)[0, 0]
    diff = (got.float() - want.float()).abs()
    share = float((diff / (BF16_REL * want.float().abs() + BF16_FLOOR)).max())
    assert float(diff.max()) <= TOL[jnp.bfloat16]
    if p_parts == 2:
        assert share <= 1.0, share
    else:
        assert share > 1.0, share


# ---------- one fp16 part of P at head widths up to 128 (rows that see 1024 keys)
def _live_keys(Tq, Tk, *, causal, window, q_offset, lo=0):
    """Each row's live keys of [lo, Tk), counted one by one."""
    qpos = q_offset + np.arange(Tq)[:, None]
    kpos = np.arange(lo, Tk)[None, :]
    live = np.ones((Tq, Tk - lo), dtype=bool)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    return live.sum(1)


@pytest.mark.parametrize("Tq,Tk,D,kw", [
    (3000, 3000, 128, dict(causal=True, window=None, q_offset=0)),      # olmo's mask
    (8192, 8192, 120, dict(causal=True, window=4096, q_offset=0)),      # danube's
    (1200, 1500, 72, dict(causal=True, window=None, q_offset=300)),
    (1200, 2000, 120, dict(causal=True, window=None, q_offset=-500)),
    (2000, 1500, 96, dict(causal=True, window=None, q_offset=-1300)),
    (2500, 2500, 128, dict(causal=True, window=1100, q_offset=0)),
    (1500, 3000, 128, dict(causal=True, window=1000, q_offset=1179)),   # a window under 1024
    (3000, 1300, 128, dict(causal=True, window=None, q_offset=0)),      # Tq > Tk
    (3000, 2000, 120, dict(causal=True, window=1500, q_offset=0)),      # rows past Tk
    (2500, 1300, 96, dict(causal=False, window=1200, q_offset=0)),      # window past the last key
    (2500, 1300, 96, dict(causal=False, window=1200, q_offset=-700)),
    (130, 1300, 128, dict(causal=False, window=None, q_offset=0)),      # no mask
    (130, 1000, 128, dict(causal=False, window=None, q_offset=0)),      # under 1024 keys at all
    (1, 2000, 96, dict(causal=False, window=None, q_offset=0)),         # one query row
    (1, 2000, 96, dict(causal=True, window=None, q_offset=50)),
    (1, 2000, 96, dict(causal=True, window=None, q_offset=1999)),
    (3000, 3000, 64, dict(causal=True, window=None, q_offset=0)),       # D <= 64: causal
    (3000, 3000, 136, dict(causal=True, window=None, q_offset=0)),
    # up to 64 columns: 128-row blocks above 64 query rows, none up to 64
    (2500, 2500, 48, dict(causal=True, window=1500, q_offset=0)),
    (1500, 3000, 64, dict(causal=True, window=1000, q_offset=1179)),    # a window under 1024
    (200, 1150, 64, dict(causal=True, window=None, q_offset=950)),
    (1200, 2000, 32, dict(causal=True, window=None, q_offset=-500)),
    (1500, 1300, 64, dict(causal=False, window=1200, q_offset=0)),      # window past the last key
    (512, 32768, 64, dict(causal=False, window=None, q_offset=0)),      # seamless's cross
    (1, 2000, 64, dict(causal=False, window=None, q_offset=0)),         # one query row
    (64, 2000, 64, dict(causal=False, window=None, q_offset=0)),
    (65, 2000, 64, dict(causal=False, window=None, q_offset=0)),
    (1200, 1400, 64, dict(causal=True, window=None, q_offset=126)),     # a block one key short
    (1500, 1232, 64, dict(causal=False, window=1200, q_offset=0)),      # the last row on an edge
    # split calls, counted per key range
    (512, 32768, 64, dict(causal=False, window=None, q_offset=0, splits=3)),
    (200, 4000, 64, dict(causal=False, window=None, q_offset=0, splits=6)),
    (300, 2600, 64, dict(causal=False, window=None, q_offset=0, splits=2)),
    (3000, 3000, 64, dict(causal=True, window=None, q_offset=0, splits=2)),
    (1500, 4000, 64, dict(causal=True, window=2100, q_offset=2500, splits=3)),
    (1200, 2048, 64, dict(causal=False, window=1024, q_offset=2000, splits=3)),
])
def test_one_part_blocks_match_a_count_of_each_rows_keys(Tq, Tk, D, kw):
    """``one_part_ranges`` (from the mask and the key ranges alone, in
    closed form) against a count of every row's live keys in each range:
    at widths up to 128 exactly the 128-row blocks whose rows all see
    ``ONE_PART_KEYS`` keys or more of the range, one contiguous range of
    them a key range (none up to 64 rows at 64 columns or less, the
    decode step's configuration); none at other widths.  Without a split
    ``one_part_blocks`` gives the same blocks."""
    kw = dict(kw)
    splits = kw.pop("splits", 1)
    got = tfa90.one_part_ranges(Tq, Tk, D, splits, **kw)
    rows = tfa90.block_rows(Tq, D)
    ranges = tref.split_ranges(Tq, Tk, splits, **kw)
    assert len(got) == len(ranges)
    for (lo, hi), (a, b) in zip(got, ranges):
        keys = _live_keys(Tq, min(b, Tk), lo=a, **kw)
        want = [r for r in range(-(-Tq // rows))
                if D <= 128 and (D > 64 or Tq > 64)
                and keys[r * rows:(r + 1) * rows].min() >= tfa90.ONE_PART_KEYS]
        assert list(range(lo, hi)) == want
        assert lo <= hi
    if splits == 1:
        assert tfa90.one_part_blocks(Tq, Tk, D, **kw) == got[0]


def _round_p(p, one_part):
    """P as the tensor cores take it: rounded once to fp16 as p 2^7 (one
    part), or hi = p truncated to bf16 plus lo = bf16(p - hi) (two)."""
    if one_part:
        return (p * 2.0 ** 7).half().float() * 2.0 ** -7
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    return hi + (p - hi).bfloat16().float()


def _one_part_forward_model(q, k, v, *, causal, window, q_offset, softcap, splits=1):
    """``csrc/flash_attention_sm90.cu``'s arithmetic at head widths up to 128
    in float32 on the CPU, block by block: bf16 q and k multiplied exactly
    and summed in float32, D^-0.5 (and the softcap) in float32; the online
    softmax over the 128-key tiles a block walks in its key range (its
    first row's window start rounded down to a tile, up to its last row's
    causal end), its reference point moving only when a row's max grows by
    more than 8 in exp2 units; P V on the blocks of ``one_part_ranges``
    from P rounded once to fp16 (p 2^7) and v in fp16 (at 65-128 v's copy
    times one power of two, ``fp16_copy``; up to 64 each tile of the
    block's walk times its own, ``fp16_tiles``, the sums so far dropped
    where the power falls by more than 2^126), on the others from P in two
    bf16 parts and the bf16 v; l from the unrounded p; each range's o_s =
    acc / l and lse_s, merged by ``ref_merge_attention``; bf16 output."""
    from repro_torch.kernels.flash_attention_bwd_sm90 import V_TILE, fp16_copy, fp16_tiles
    B, Hq, Tq, D = q.shape
    Tk, G = k.shape[2], Hq // k.shape[1]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    kf, vf = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    if D > 64:
        v16, ev = fp16_copy(v)
        v_copy = (v16.float() * torch.exp2(-ev.float())).repeat_interleave(G, dim=1)
    rows = tfa90.block_rows(Tq, D)
    ranges = tref.split_ranges(Tq, Tk, splits, **mask)
    one = tfa90.one_part_ranges(Tq, Tk, D, splits, **mask)
    o_s = torch.zeros((B, Hq, splits, Tq, D))
    lse_s = torch.full((B, Hq, splits, Tq), float("-inf"))
    for s, ((a, b), (lo, hi)) in enumerate(zip(ranges, one)):
        for rb in range(-(-Tq // rows)):
            r0, r1 = rb * rows, min(Tq, (rb + 1) * rows)
            qpos = q_offset + torch.arange(r0, r1)[:, None]
            k_end = min(b, Tk, q_offset + r1) if causal else min(b, Tk)
            k_begin = max(0, q_offset + r0 - window + 1) if window is not None else 0
            k_begin = max(k_begin // V_TILE * V_TILE, a)
            n = max(0, -(-(k_end - k_begin) // V_TILE))
            one_part = lo <= rb < hi
            if one_part and D <= 64:
                v16, ev = fp16_tiles(v[:, :, k_begin:min(k_begin + n * V_TILE, Tk)], n)
                v_tiles = (v16.float().unflatten(-2, (n, V_TILE))
                           * torch.exp2(-ev.float())[..., None, None]).repeat_interleave(G, dim=1)
                ev = ev.repeat_interleave(G, dim=1)
                e_acc = torch.full((B, Hq), 127)
            m = torch.full((B, Hq, r1 - r0, 1), -1e30)
            l = torch.zeros((B, Hq, r1 - r0, 1))
            acc = torch.zeros((B, Hq, r1 - r0, D))
            for t in range(n):
                j0 = k_begin + t * V_TILE
                j1 = min(j0 + V_TILE, Tk)
                kpos = torch.arange(j0, j1)[None, :]
                live = torch.ones((r1 - r0, j1 - j0), dtype=torch.bool)
                if causal:
                    live &= kpos <= qpos
                if window is not None:
                    live &= kpos > qpos - window
                sc = (q[:, :, r0:r1].float() @ kf[:, :, j0:j1].transpose(-1, -2)) * D ** -0.5
                if softcap is not None:
                    sc = softcap * torch.tanh(sc / softcap)
                sc = sc.masked_fill(~live, -1e30)
                mx = sc.amax(-1, keepdim=True)
                m_new = torch.where(mx - m > 8 * np.log(2.0), mx, m)
                p = torch.exp(sc - m_new).masked_fill(~live, 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                if not one_part:
                    pv = _round_p(p, False) @ vf[:, :, j0:j1]
                elif D > 64:
                    pv = _round_p(p, True) @ v_copy[:, :, j0:j1]
                else:
                    pv = _round_p(p, True) @ v_tiles[:, :, t, :j1 - j0]
                    drop = (ev[:, :, t] - e_acc < -126)[..., None, None]
                    acc = torch.where(drop, torch.zeros_like(acc), acc)
                    e_acc = ev[:, :, t]
                acc = acc * alpha + pv
                m = m_new
            dead = l == 0
            o_s[:, :, s, r0:r1] = acc / torch.where(dead, torch.ones_like(l), l)
            lse_s[:, :, s, r0:r1] = torch.where(dead, float("-inf"), m + torch.log(l))[..., 0]
    if splits == 1:
        return o_s[:, :, 0].bfloat16()
    return tref.ref_merge_attention(o_s, lse_s)[0].bfloat16()


# chip_smoke.py's forward cases at head widths 65-128 (B, Hq, Hkv, Tq, Tk, D,
# mask): its FLASH_D128_CASES, its FLASH_CASES (q_offset Tk - Tq when causal),
# all in bf16, and its FLASH_D128_ONE_PART_CASES; then at widths up to 64
# its FLASH_D64_ONE_PART_CASES, FLASH_D64_CASES and FLASH_SPLIT_CASES, each
# at the key ranges it runs at on the card (``splits``, else the wrapper's
# own at an H100's 132 SMs)
_FWD_CASES = [
    (1, 4, 4, 200, 300, 72, dict(causal=True, q_offset=100)),
    (1, 8, 2, 300, 300, 96, dict(causal=True, window=24)),
    (1, 8, 2, 200, 300, 120, dict(causal=True, q_offset=100, softcap=20.0)),
    (2, 4, 4, 130, 333, 128, dict(causal=False)),
    (1, 8, 2, 200, 300, 120, dict(causal=True, q_offset=-40)),
    (1, 8, 2, 321, 1500, 128, dict(causal=True, window=100, q_offset=1179, softcap=30.0)),
    (1, 8, 2, 1, 1000, 96, dict(causal=False)),
    (1, 4, 4, 1100, 1100, 128, dict(causal=True)),
    (1, 4, 4, 128, 128, 128, dict(causal=True)),
    (1, 8, 2, 300, 1500, 120, dict(causal=True, window=100, q_offset=1200)),
    (1, 32, 8, 1, 5000, 120, dict(causal=True, window=4096, q_offset=4999)),
    (1, 4, 2, 200, 4200, 120, dict(causal=True, window=64, q_offset=4000, softcap=30.0)),
    (1, 4, 4, 200, 1150, 72, dict(causal=True, q_offset=950)),
    (1, 8, 2, 2500, 2500, 96, dict(causal=True, window=1500)),
    (1, 8, 2, 300, 1300, 120, dict(causal=True, q_offset=1000, softcap=20.0)),
    (2, 4, 4, 130, 1100, 128, dict(causal=False)),
    (1, 4, 2, 1500, 1300, 128, dict(causal=False, window=1200)),
    (1, 4, 4, 130, 1024, 128, dict(causal=False)),
    (1, 4, 2, 256, 1536, 128, dict(causal=True, q_offset=1280, softcap=30.0)),
    (1, 8, 2, 2200, 2200, 120, dict(causal=True, window=1100)),
    # FLASH_D128_CASES' cases for the dK/dV pass's ring
    (1, 4, 4, 128, 700, 128, dict(causal=False)),
    (1, 4, 4, 256, 300, 96, dict(causal=False)),
    (1, 8, 2, 900, 900, 120, dict(causal=True)),
    # FLASH_D64_ONE_PART_CASES
    (2, 4, 4, 130, 1100, 64, dict(causal=False, splits=1)),
    (1, 4, 4, 200, 1150, 64, dict(causal=True, q_offset=950, splits=1)),
    (1, 8, 2, 2500, 2500, 48, dict(causal=True, window=1500, splits=1)),
    (1, 8, 2, 300, 1300, 32, dict(causal=True, q_offset=1000, softcap=20.0, splits=1)),
    (1, 4, 2, 1500, 1300, 64, dict(causal=False, window=1200, splits=1)),
    (1, 4, 2, 300, 2600, 64, dict(causal=False, splits=2)),
    (1, 4, 2, 300, 2600, 64, dict(causal=False, splits=4)),
    # FLASH_D64_CASES
    (2, 8, 2, 300, 1500, 64, dict(causal=True, window=100, q_offset=1200)),
    (1, 4, 2, 200, 4200, 64, dict(causal=True, window=64, softcap=30.0, q_offset=4000)),
    (1, 4, 1, 130, 300, 48, dict(causal=False)),
    (2, 4, 4, 129, 129, 64, dict(causal=False, window=17)),
    (1, 4, 2, 300, 300, 64, dict(causal=True, q_offset=-40)),
    (1, 2, 2, 1000, 1000, 16, dict(causal=True)),
    (2, 4, 2, 64, 3000, 64, dict(causal=True, q_offset=2936)),
    # FLASH_SPLIT_CASES
    (1, 4, 2, 1500, 1600, 64, dict(causal=True, window=600, q_offset=-20, splits=2)),
    (1, 4, 2, 1200, 2048, 64, dict(causal=False, window=1024, q_offset=2000, splits=3)),
    (2, 4, 2, 37, 5000, 64, dict(causal=True, window=3000, q_offset=4963, splits=4)),
    (1, 4, 1, 1, 4100, 32, dict(causal=False, softcap=25.0, splits=8)),
    (2, 8, 2, 200, 3000, 48, dict(causal=False, splits=5)),
    (1, 4, 2, 200, 4000, 64, dict(causal=False, splits=6)),
]
# input scales (q, k, v): chip_smoke.py's FLASH_FP16_SCALES without do's, v
# far above fp16's largest value (the output scales with v, so its limit's
# floor is 1e-4 in v's units there: 1e-4 of an output of 1e5 is under
# float32's resolution), and v whose 128-key tiles alternate between 1 and
# 2^-20 ("tiles")
_FWD_SCALES = {"1": (1, 1, 1), "q 1e5 k 1e-5": (1e5, 1e-5, 1), "q 1e-5 k 1e5": (1e-5, 1e5, 1),
               "v 1e-6": (1, 1, 1e-6), "v 1e5": (1, 1, 1e5), "v tiles 2^20 apart": (1, 1, "tiles")}


def _scaled_inputs(B, Hq, Hkv, Tq, Tk, D, scales, seed):
    """q, k, v standard normal times ``scales`` in bf16; v's scale "tiles"
    takes key j times 2^-20 where j // 128 is odd."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, c in zip(((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)), scales):
        x = rng.standard_normal(shape).astype(np.float32)
        if c == "tiles":
            c = (2.0 ** (-20 * ((np.arange(Tk) // 128) % 2)))[:, None].astype(np.float32)
        out.append(torch.from_numpy(x * c).bfloat16())
    return out


@pytest.mark.parametrize("scales", list(_FWD_SCALES))
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,kw", _FWD_CASES)
def test_one_part_forward_emulation_within_the_chip_limit(B, Hq, Hkv, Tq, Tk, D, kw, scales):
    """The forward kernel's arithmetic (one fp16 part of P on the rule's row
    blocks, two bf16 parts elsewhere; up to 64 columns v in fp16 tile by
    tile, at the card's key ranges) against the plain forward, per element
    within 2^-7 |want| + 1e-4 (``chip_smoke.py``'s FLASH_BF16_REL and
    _FLOOR, the limit the card holds the kernel to)."""
    q, k, v = _scaled_inputs(B, Hq, Hkv, Tq, Tk, D, _FWD_SCALES[scales], seed=Tq * 7 + Tk + D)
    kw = dict(kw)
    mask = dict(causal=kw["causal"], window=kw.get("window"), q_offset=kw.get("q_offset", 0))
    splits = kw.pop("splits", None) or tfa90.split_count(B, Hq, Tq, Tk, D, **mask,
                                                         sm_count=132)
    got = _one_part_forward_model(q, k, v, softcap=kw.get("softcap"), splits=splits, **mask)
    want = tref.ref_flash_attention(q, k, v, **kw)
    diff = (got.float() - want.float()).abs()
    unit = max(1.0, _FWD_SCALES[scales][2]) if scales != "v tiles 2^20 apart" else 1.0
    share = float((diff / (BF16_REL * want.float().abs() + BF16_FLOOR * unit)).max())
    assert share <= 1.0, f"{share:.3f} of the limit"


@pytest.mark.parametrize("case", ["above fp16's largest", "below fp16's normal range",
                                  "zero tiles", "tiles past Tk", "tiles 2^20 apart",
                                  "a rise past 2^64"])
def test_fp16_tiles_convert_each_tile_exactly(case):
    """The plain version of the forward kernel's conversion of v up to 64
    columns (``fp16_tiles``: each 128-key tile times 2^e_t, ``fp16_exponent``
    of its largest |v| within [-112, 112]): no value overflows fp16, and
    back in float32 every value that lands at or above fp16's normal range
    is exact, the rest under it.  A tile of zeros (or past Tk) keeps the
    exponent before it (112 before any other), and an exponent rises by at
    most ``EXP_RISE`` a tile."""
    from repro_torch.kernels import flash_attention_bwd_sm90 as tfab90
    rng = np.random.default_rng(3)
    T, n = 700, None
    x = rng.standard_normal((2, 3, T, 48)).astype(np.float32)
    tile = (np.arange(T) // 128)[:, None]
    x = {"above fp16's largest": x * 3e9, "below fp16's normal range": x * 1e-7,
         "zero tiles": x * (tile % 2 == 1), "tiles past Tk": x,
         "tiles 2^20 apart": x * 2.0 ** (-20 * (tile % 2)),
         "a rise past 2^64": x * np.where(tile == 0, 1e30, 1e-20)}[case]
    if case == "tiles past Tk":
        n = 8                                    # two tiles wholly past T = 700
    v = torch.from_numpy(x).bfloat16()
    h, e = tfab90.fp16_tiles(v, n)
    n = e.shape[-1]
    assert h.dtype == torch.float16 and h.shape == (2, 3, n * 128, 48)
    assert bool(torch.isfinite(h).all()) and float(h.float().abs().max()) <= 65280.0
    vt = torch.nn.functional.pad(v.float(), (0, 0, 0, n * 128 - T)).unflatten(-2, (n, 128))
    amax = vt.abs().amax(dim=(-2, -1))
    prev = torch.full(e.shape[:-1], 112, dtype=torch.int32)
    for t in range(n):
        own = tfab90.fp16_exponent(amax[..., t]).clamp(-112, 112)
        want = torch.where(amax[..., t] == 0, prev, torch.minimum(own, prev + 64))
        assert torch.equal(e[..., t], want)
        prev = want
    h = h.float().unflatten(-2, (n, 128))
    normal = h.abs() >= 2.0 ** -14
    back = h * torch.exp2(-e.float())[..., None, None]
    assert torch.equal(back[normal], vt[normal])
    assert bool((back[~normal].abs() < 2.0 ** -14 * torch.exp2(-e.float())[..., None, None]
                 .expand_as(back)[~normal]).all())
    if case == "zero tiles":                     # tiles 0, 2 and 4 are zeros
        assert bool((e[..., 0] == 112).all())
        assert torch.equal(e[..., 2], e[..., 1]) and torch.equal(e[..., 4], e[..., 3])
    if case == "tiles past Tk":
        assert torch.equal(e[..., 6], e[..., 5]) and torch.equal(e[..., 7], e[..., 5])
    if case == "a rise past 2^64":
        assert torch.equal(e[..., 1], e[..., 0] + 64)
    else:
        assert int(normal.sum()) >= 0.99 * int((vt != 0).sum())


@pytest.mark.parametrize("device,dtypes,route", [
    ("cpu", ("bf16",) * 3, "plain"),
    ("cpu", ("f32",) * 3, "plain"),
    ("meta", ("bf16",) * 3, "sm90"),
    ("meta", ("f32",) * 3, "f32"),
    ("meta", ("bf16", "f32", "bf16"), "f32"),
])
def test_ops_flash_attention_picks_the_kernel_by_device_and_dtype(device, dtypes, route,
                                                                  monkeypatch, no_build):
    """A CPU tensor runs the plain version; off the CPU, all-bf16 inputs go
    to the tensor-core kernel and anything else to the float32 kernel
    (whose checks refuse mixed types).  The wrappers are replaced by
    recorders; the meta device stands for a card without faking one."""
    called = []
    monkeypatch.setattr(tfa, "flash_attention_cuda", lambda *a, **kw: called.append("f32"))
    monkeypatch.setattr(tfa90, "flash_attention_sm90_cuda",
                        lambda *a, **kw: called.append("sm90"))
    monkeypatch.setattr(tref, "ref_flash_attention", lambda *a, **kw: called.append("plain"))
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    q, k, v = (torch.zeros(1, 4, 8, 16, device=device, dtype=dt[d]) for d in dtypes)
    ops.flash_attention(q, k, v, causal=True, window=4)
    assert called == [route]


@pytest.mark.parametrize("case,error,match", [
    ("float32", TypeError, "bfloat16 inputs only"),
    ("mixed", TypeError, "bfloat16 inputs only"),
    ("head_dim", ValueError, "multiple of 8"),
    ("stride", ValueError, "multiples of 8 elements"),
    ("base", ValueError, "16-byte boundary"),
    ("cpu_tensor", ValueError, "CUDA tensors"),
])
def test_sm90_wrapper_rejects_bad_inputs_before_building(case, error, match, no_build):
    """The tensor-core kernel raises on what it does not take, the device
    last; nothing falls back to the float32 kernel or the plain version."""
    q, k, v = (torch.zeros(2, 4, 8, 16, dtype=torch.bfloat16) for _ in range(3))
    if case == "float32":
        q, k, v = q.float(), k.float(), v.float()
    elif case == "mixed":
        v = v.float()
    elif case == "head_dim":
        q, k, v = (torch.zeros(2, 4, 8, 20, dtype=torch.bfloat16) for _ in range(3))
    elif case == "stride":
        # (B, T, H, D) storage with rows of 20 elements, seen as (B, H, T, 16)
        k = torch.zeros(2, 8, 4, 20, dtype=torch.bfloat16)[..., :16].transpose(1, 2)
    elif case == "base":
        k = torch.zeros(2 * 4 * 8 * 16 + 4, dtype=torch.bfloat16)[4:].view(2, 4, 8, 16)
        assert k.data_ptr() % 16 == 8
    before = tfa90.launches
    with pytest.raises(error, match=match):
        tfa90.flash_attention_sm90_cuda(q, k, v)
    assert tfa90.launches == before


# ------------------------------------------------------- the slice, end to end
_SLICE = {}


def _slice(arch):
    """Reduced arch in both packages with shared parameters and two
    4200-token prompts; the reference's greedy tokens and last prefill
    logits, computed once."""
    if arch not in _SLICE:
        clear_logical_rules()
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        jmodel = jbuild_model(jcfg)
        jparams = jax.jit(lambda r: jmodel.init(r)[0])(jax.random.PRNGKey(2))
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, cfg.vocab_size, LONG_T0).astype(np.int32) for _ in range(2)]
        max_len = LONG_T0 + LONG_NEW
        tokens = jnp.asarray(np.stack(prompts))
        jlogits, _ = jax.jit(jmodel.prefill)(jparams, {"tokens": tokens},
                                             jmodel.init_cache(2, max_len))
        want = jgenerate(jmodel, jparams, prompts, max_new=LONG_NEW, max_len=max_len,
                         mesh=None)
        _SLICE[arch] = cfg, params, prompts, np.asarray(jlogits), want
    return _SLICE[arch]


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "olmo-1b", "recurrentgemma-2b"])
def test_long_prompt_generate_matches_jax(arch):
    cfg, params, prompts, jlogits, want = _slice(arch)
    model = build_model(cfg)
    max_len = LONG_T0 + LONG_NEW
    ops.reset_launch_counts()
    with torch.inference_mode():
        cache = model.init_cache(2, max_len, device="cpu")
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(np.stack(prompts)).long()},
                                  cache)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0, atol=LOGIT_TOL)
    got = generate(model, params, prompts, max_new=LONG_NEW, max_len=max_len, device="cpu")
    assert ops.launch_counts()["flash_attention"] == 0     # the CPU runs the plain version
    for g, w in zip(got, want):
        if not np.array_equal(g, w):
            top2 = np.sort(jlogits, axis=-1)[:, -2:]
            print(f"{arch}: greedy tokens differ; reference top-2 margin at the prefill "
                  f"{top2[:, 1] - top2[:, 0]}")
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (LONG_T0 + LONG_NEW,)
