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


# ---------- one fp16 part of P at head widths 65-128 (rows that see 1024 keys)
def _live_keys(Tq, Tk, *, causal, window, q_offset):
    """Each row's live keys, counted one by one."""
    qpos = q_offset + np.arange(Tq)[:, None]
    kpos = np.arange(Tk)[None, :]
    live = np.ones((Tq, Tk), dtype=bool)
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
    (3000, 3000, 64, dict(causal=True, window=None, q_offset=0)),       # outside 65-128
    (3000, 3000, 136, dict(causal=True, window=None, q_offset=0)),
])
def test_one_part_blocks_match_a_count_of_each_rows_keys(Tq, Tk, D, kw):
    """``one_part_blocks`` (from the mask alone, in closed form) against a
    count of every row's live keys: at 65-128 columns exactly the 128-row
    blocks whose rows all see ``ONE_PART_KEYS`` keys or more, one
    contiguous range of them; none at other widths."""
    lo, hi = tfa90.one_part_blocks(Tq, Tk, D, **kw)
    keys = _live_keys(Tq, Tk, **kw)
    rows = tfa90.block_rows(Tq, D)
    want = [b for b in range(-(-Tq // rows))
            if 64 < D <= 128 and keys[b * rows:(b + 1) * rows].min() >= tfa90.ONE_PART_KEYS]
    assert list(range(lo, hi)) == want
    assert lo <= hi


def _round_p(p, one_part):
    """P as the tensor cores take it: rounded once to fp16 as p 2^7 (one
    part), or hi = p truncated to bf16 plus lo = bf16(p - hi) (two)."""
    if one_part:
        return (p * 2.0 ** 7).half().float() * 2.0 ** -7
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    return hi + (p - hi).bfloat16().float()


def _one_part_forward_model(q, k, v, *, causal, window, q_offset, softcap):
    """``csrc/flash_attention_sm90.cu``'s arithmetic at head widths 65-128 in
    float32 on the CPU: bf16 q and k multiplied exactly and summed in
    float32, D^-0.5 (and the softcap) in float32; the online softmax over
    128-key tiles, its reference point moving only when a row's max grows
    by more than 8 in exp2 units; P V on the row blocks of
    ``one_part_blocks`` from P rounded once to fp16 (p 2^7) and v's scaled
    fp16 copy (``fp16_copy``), on the others from P in two bf16 parts and
    the bf16 v; l from the unrounded p; bf16 output."""
    from repro_torch.kernels.flash_attention_bwd_sm90 import fp16_copy
    B, Hq, Tq, D = q.shape
    Tk, G = k.shape[2], Hq // k.shape[1]
    kf, vf = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    v16, ev = fp16_copy(v)
    v16f = (v16.float() * torch.exp2(-ev.float())).repeat_interleave(G, dim=1)
    lo, hi = tfa90.one_part_blocks(Tq, Tk, D, causal=causal, window=window, q_offset=q_offset)
    rows = torch.arange(Tq)
    one = ((rows >= lo * 128) & (rows < hi * 128))[:, None]
    qf = q.float()
    qpos = q_offset + rows[:, None]
    m = torch.full((B, Hq, Tq, 1), -1e30)
    l = torch.zeros((B, Hq, Tq, 1))
    acc = torch.zeros((B, Hq, Tq, D))
    for j0 in range(0, Tk, 128):
        kpos = torch.arange(j0, min(j0 + 128, Tk))[None, :]
        live = torch.ones((Tq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            live &= kpos <= qpos
        if window is not None:
            live &= kpos > qpos - window
        if not live.any():
            continue
        s = (qf @ kf[:, :, j0:j0 + 128].transpose(-1, -2)) * D ** -0.5
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~live, -1e30)
        mx = s.amax(-1, keepdim=True)
        m_new = torch.where(mx - m > 8 * np.log(2.0), mx, m)
        p = torch.exp(s - m_new).masked_fill(~live, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv1 = _round_p(p, True) @ v16f[:, :, j0:j0 + 128]
        pv2 = _round_p(p, False) @ vf[:, :, j0:j0 + 128]
        acc = acc * alpha + torch.where(one, pv1, pv2)
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).bfloat16()


# chip_smoke.py's forward cases at head widths 65-128 (B, Hq, Hkv, Tq, Tk, D,
# mask): its FLASH_D128_CASES, its FLASH_CASES (q_offset Tk - Tq when causal),
# all in bf16, and its FLASH_D128_ONE_PART_CASES
_D128_FWD_CASES = [
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
]
# input scales (q, k, v): chip_smoke.py's FLASH_FP16_SCALES without do's
_FWD_SCALES = {"1": (1, 1, 1), "q 1e5 k 1e-5": (1e5, 1e-5, 1), "q 1e-5 k 1e5": (1e-5, 1e5, 1),
               "v 1e-6": (1, 1, 1e-6)}


@pytest.mark.parametrize("scales", list(_FWD_SCALES))
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,kw", _D128_FWD_CASES)
def test_one_part_forward_emulation_within_the_chip_limit(B, Hq, Hkv, Tq, Tk, D, kw, scales):
    """The forward kernel's arithmetic at 65-128 (one fp16 part of P on the
    rule's row blocks, two bf16 parts elsewhere) against the plain forward,
    per element within 2^-7 |want| + 1e-4 (``chip_smoke.py``'s
    FLASH_BF16_REL and _FLOOR, the limit the card holds the kernel to)."""
    rng = np.random.default_rng(Tq * 7 + Tk + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * c).bfloat16()
               for shape, c in zip(((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)),
                                   _FWD_SCALES[scales]))
    mask = dict(causal=kw["causal"], window=kw.get("window"), q_offset=kw.get("q_offset", 0))
    got = _one_part_forward_model(q, k, v, softcap=kw.get("softcap"), **mask)
    want = tref.ref_flash_attention(q, k, v, **kw)
    diff = (got.float() - want.float()).abs()
    share = float((diff / (BF16_REL * want.float().abs() + BF16_FLOOR)).max())
    assert share <= 1.0, f"{share:.3f} of the limit"


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
