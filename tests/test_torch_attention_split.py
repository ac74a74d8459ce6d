"""The bf16 attention kernel's split path in the port vs the JAX reference.

A call of ``flash_attention_sm90`` with few blocks cuts its live keys into
ranges (``flash_attention_sm90.split_count``, ``ref.split_ranges``), one
block per (row block, range) writes the range's float32 output and row
log-sum-exp, and the last block of each row block to finish merges them.
The kernel runs only on the card (``chip_smoke.py`` holds it to these
plain versions there); these tests hold the plain versions,
``ref.ref_flash_attention_partials`` and ``ref.ref_merge_attention``, to
``ref.ref_flash_attention`` and to the reference's Pallas kernel in
interpret mode (2e-5 in float32, the tolerance of
``tests/test_kernels.py``), and the choice of ranges to the shapes the
serving and training paths give the kernel.  Inputs are made with numpy
from a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.distributed.axes import clear_logical_rules
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention_sm90 as tfa90
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

TOL = 2e-5                     # tests/test_kernels.py:84, float32
SM_COUNT = 132                 # an H100 SXM's SMs


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    clear_logical_rules()


def _qkv(B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Tq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32))


# (B, Hq, Hkv, Tq, Tk, D, causal, window, q_offset, softcap, splits)
SPLIT_CASES = {
    "decode": (1, 2, 1, 1, 2100, 16, False, None, 0, None, 3),          # Tk off the ranges
    "ragged_causal": (1, 4, 2, 37, 2100, 16, True, None, 2063, None, 4),
    "window_before_first_key": (1, 2, 2, 1500, 1600, 16, True, 600, -20, None, 2),
    "window_past_last_key": (1, 2, 1, 1200, 2048, 16, False, 1024, 2000, None, 3),
    "softcap": (1, 2, 1, 37, 3000, 16, False, None, 0, 20.0, 2),
    "gqa_window": (2, 4, 2, 64, 2600, 32, True, 700, 2536, None, 2),
    # a decode step over 9 ranges, the seamless decode's count, merged in order
    "decode_9_ranges": (1, 4, 2, 1, 9 * 512 + 300, 64, False, None, 0, None, 9),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_and_merge_match_plain_and_pallas(case):
    B, Hq, Hkv, Tq, Tk, D, causal, window, q_offset, softcap, splits = SPLIT_CASES[case]
    q, k, v = _qkv(B, Hq, Hkv, Tq, Tk, D, seed=Tq + Tk)
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o_s, lse_s = tref.ref_flash_attention_partials(tq, tk, tv, splits, **kw)
    assert o_s.shape == (B, Hq, splits, Tq, D) and lse_s.shape == (B, Hq, splits, Tq)
    assert o_s.dtype == lse_s.dtype == torch.float32
    got, lse = tref.ref_merge_attention(o_s, lse_s)
    want, want_lse = tref.ref_flash_attention(tq, tk, tv, return_lse=True, **kw)
    assert not torch.isnan(got).any() and not torch.isnan(lse).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    dead = torch.isinf(want_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    np.testing.assert_allclose(lse[~dead].numpy(), want_lse[~dead].numpy(), rtol=TOL, atol=TOL)
    assert not got[dead].any()
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=TOL, atol=TOL)


def test_partials_of_a_range_no_row_sees_are_zero_with_lse_minus_inf():
    """A causal window with rows before the first key: rows 0-19 see no key
    at all, and the rows late in the window see nothing of the first range
    (nor the early rows of the second): zeros and -inf there, no NaN."""
    B, Hq, Hkv, Tq, Tk, D, causal, window, q_offset, softcap, splits = \
        SPLIT_CASES["window_before_first_key"]
    q, k, v = (torch.from_numpy(x) for x in _qkv(B, Hq, Hkv, Tq, Tk, D, seed=5))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o_s, lse_s = tref.ref_flash_attention_partials(q, k, v, splits, **kw)
    assert tref.split_ranges(Tq, Tk, splits, **kw) == [(0, 512), (512, 1600)]
    pos = q_offset + np.arange(Tq)
    first_blind = (pos < 0) | (pos - window + 1 >= 512)       # sees nothing of [0, 512)
    second_blind = pos < 512                                   # nor of [512, 1600)
    for s, blind in enumerate((first_blind, second_blind)):
        assert torch.isneginf(lse_s[:, :, s, blind]).all()
        assert torch.isfinite(lse_s[:, :, s, ~blind]).all()
        assert not o_s[:, :, s, blind].any()
    assert not torch.isnan(o_s).any()


def test_merge_weighs_each_range_by_its_lse():
    """Two ranges whose lse differ by 30: the merge is the high range's
    output within float32 rounding, not the ranges' mean; a row whose
    ranges are all -inf merges to zeros and -inf."""
    o_s = torch.stack([torch.full((1, 1, 2, 4), 1.0), torch.full((1, 1, 2, 4), 3.0)], dim=2)
    lse_s = torch.tensor([[[[0.0, float("-inf")], [30.0, float("-inf")]]]])
    o, lse = tref.ref_merge_attention(o_s, lse_s)
    assert torch.allclose(o[0, 0, 0], torch.full((4,), 3.0), rtol=1e-6, atol=0)
    assert float(lse[0, 0, 0]) == pytest.approx(30.0 + np.log1p(np.exp(-30.0)), rel=1e-7)
    assert torch.equal(o[0, 0, 1], torch.zeros(4)) and float(lse[0, 0, 1]) == float("-inf")


# (q shape, k/v length, causal, window, q_offset) of every call the
# serving and training paths give the bf16 kernel
NO_SPLIT = {
    "danube_prefill": ((4, 32, 8192, 120), 8192, True, 4096, 0),
    "seamless_encoder": ((4, 16, 32768, 64), 32768, False, None, 0),
    "danube_train": ((1, 32, 8192, 120), 8192, True, 4096, 0),
    "seamless_train_encoder": ((2, 16, 8192, 64), 8192, False, None, 0),
    "seamless_train_cross": ((2, 16, 2048, 64), 8192, False, None, 0),
    **{f"danube_train_shard_{r}": ((1, 32, 2048, 120), 8192, True, 4096, 2048 * r)
       for r in range(4)},
    # 256 and 128 blocks, two and one full waves: split, they fill no fewer
    "seamless_cross_prefill": ((4, 16, 512, 64), 32768, False, None, 0),
    "cross_prefill_256_rows": ((4, 16, 256, 64), 32768, False, None, 0),
    # 128 blocks of 192 rows, one wave (192 of 128 rows would take two):
    # no split fills fewer
    "cross_prefill_384_rows": ((4, 16, 384, 64), 32768, False, None, 0),
    # 128 blocks of 128 rows (two of 192 rows hold 192 rows of an SM's time)
    "rows_200": ((4, 16, 200, 64), 32768, False, None, 0),
    # seamless's encoder on one row of its batch: 16 x 171 blocks of 192
    "seamless_encoder_one_row": ((1, 16, 32768, 64), 32768, False, None, 0),
}
SPLIT = {
    "seamless_cross_decode": ((4, 16, 1, 64), 32768, False, None, 0),
    # 192 blocks of 192 rows, a wave and a half: 2 ranges fill three waves
    # of half blocks
    "rows_513": ((4, 16, 513, 64), 2048, False, None, 0),
    # 192 blocks of 128 rows (as many of 192 rows): 2 ranges as above
    "rows_256_of_96_heads": ((2, 48, 256, 64), 32768, False, None, 0),
}


@pytest.mark.parametrize("name", list(NO_SPLIT) + list(SPLIT))
def test_split_count_splits_only_calls_of_few_blocks(name):
    """A call splits only below two waves of blocks, and only into ranges
    that take fewer waves of whole blocks for its work: ceil(blocks S /
    SMs) / S below ceil(blocks / SMs) (a decode step's 64 blocks in 2, not
    the 9 that four waves would take; the prefill's 256 not at all)."""
    (B, Hq, Tq, D), Tk, causal, window, q_offset = {**NO_SPLIT, **SPLIT}[name]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    S = tfa90.split_count(B, Hq, Tq, Tk, D, sm_count=SM_COUNT, **kw)
    blocks = B * Hq * -(-Tq // tfa90.block_rows(B, Hq, Tq, D, SM_COUNT))
    waves = [-(-blocks * s // SM_COUNT) / s for s in range(1, S + 1)]
    assert (S > 1) == (name in SPLIT)
    assert S == 1 or (blocks < 2 * SM_COUNT and waves[-1] == min(waves) < waves[0])
    assert S in (1, 2)                     # the serving shapes' counts on an H100
    assert S == tfa90.split_count(B, Hq, Tq, Tk, D, sm_count=SM_COUNT, **kw)   # pure
    ranges = tref.split_ranges(Tq, Tk, S, **kw)
    assert len(ranges) == S
    if S > 1:
        assert all(b - a >= tref.SPLIT_KEYS for a, b in ranges)          # 8 tiles of 64 keys
        assert all(a % tref.SPLIT_KEYS == 0 for a, _ in ranges)


@pytest.mark.parametrize("name,S", [("seamless_cross_decode", None),
                                    ("seamless_cross_prefill", None),
                                    ("causal_window", 4), ("window_ahead", 3)])
@pytest.mark.parametrize("tile", [64, 128])
def test_split_ranges_cover_each_live_tile_once(name, S, tile):
    """Every key tile that some row sees lies in exactly one range, whole:
    the kernel's blocks walk the tiles of their range, and none is
    counted twice or left out."""
    shapes = {**SPLIT, **NO_SPLIT, "causal_window": ((1, 1, 300, 64), 6000, True, 1500, 4000),
              "window_ahead": ((1, 1, 1200, 64), 2048, False, 1024, 2000)}
    (B, Hq, Tq, D), Tk, causal, window, q_offset = shapes[name]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if S is None:
        S = tfa90.split_count(B, Hq, Tq, Tk, D, sm_count=SM_COUNT, **kw)
    ranges = tref.split_ranges(Tq, Tk, S, **kw)
    pos = q_offset + np.arange(Tq)
    keys = np.arange(Tk)
    live = np.ones((Tq, Tk), bool)
    if causal:
        live &= keys[None] <= pos[:, None]
    if window is not None:
        live &= keys[None] > pos[:, None] - window
    live_tiles = {j // tile for j in np.nonzero(live.any(0))[0]}
    owners = {t: [i for i, (a, b) in enumerate(ranges) if a <= t * tile < b] for t in live_tiles}
    assert all(len(o) == 1 for o in owners.values())
    # a tile never straddles a range's end, except past the last range's keys
    assert all(ranges[o[0]][1] >= min((t + 1) * tile, Tk) for t, o in owners.items())


def test_split_plan_is_the_kernels_reading_of_the_ranges():
    """The kernel starts range s at lo + 512 floor(s chunks / S) from the
    (lo, chunks) the wrapper passes; that is ``split_ranges``'s start."""
    for (B, Hq, Tq, D), Tk, causal, window, q_offset in SPLIT.values():
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        S = tfa90.split_count(B, Hq, Tq, Tk, D, sm_count=SM_COUNT, **kw)
        lo, chunks = tfa90.split_plan(Tq, Tk, S, **kw)
        starts = [lo + tref.SPLIT_KEYS * (s * chunks // S) for s in range(S)]
        assert starts == [a for a, _ in tref.split_ranges(Tq, Tk, S, **kw)]
    assert tfa90.split_plan(37, 5000, 1, causal=True, window=None, q_offset=4963) == (0, 0)


@pytest.mark.parametrize("splits", [0, 4])
def test_split_plan_refuses_more_ranges_than_chunks(splits):
    """1500 live keys hold two whole 512-key chunks: 4 ranges (or 0) raise."""
    with pytest.raises(ValueError):
        tfa90.split_plan(1500, 1600, splits, causal=True, window=600, q_offset=-20)


def _rows_case(B, Hq, Tq, D, want, id=None):
    return pytest.param(B, Hq, Tq, D, want, id=id or f"{B}x{Hq}-{Tq}-{D}-{want}")


@pytest.mark.parametrize("B,Hq,Tq,D,want", [
    # one head: one consumer up to 64 rows, else two (one wave either way,
    # or two waves of 171 blocks of 192 rows against two of 256 of 128)
    *(_rows_case(1, 1, Tq, D, want, id=f"{Tq}-{D}-{want}") for Tq, D, want in [
        (1, 64, 64), (64, 32, 64), (65, 64, 128), (32768, 64, 128), (1, 120, 128),
        (8192, 128, 128), (100, 256, 128), (200, 72, 128), (64, 96, 128), (8192, 120, 128),
        (333, 128, 128), (300, 136, 128)]),
    # seamless at D = 64 over B x 16 heads: the encoder 192 (83 waves against
    # 125), its last block 128 rows; the training encoder 128 (11 waves of
    # 192 against 16 of 128); the cross-attention 128 (two waves either
    # way); a decode step 64; 200 rows 128 (one wave either way), 513 rows
    # 192 (two waves of 192 rows, three of 128); wider than 64, always 128
    _rows_case(4, 16, 32768, 64, 192), _rows_case(1, 16, 32768, 64, 192),
    _rows_case(2, 16, 8192, 64, 128), _rows_case(4, 16, 512, 64, 128),
    _rows_case(4, 16, 1, 64, 64), _rows_case(4, 16, 200, 64, 128),
    _rows_case(4, 16, 513, 64, 192), _rows_case(4, 16, 384, 48, 192),
    _rows_case(4, 16, 32768, 128, 128),
])
def test_block_rows_follow_the_kernels_configurations(B, Hq, Tq, D, want):
    """``block_rows`` picks 192 rows (three consumers) only where its waves
    hold no more rows of an SM's time than 128-row blocks', a pure function
    of the shape and the SM count; the blocks cover every row once."""
    rows = tfa90.block_rows(B, Hq, Tq, D, SM_COUNT)
    assert rows == want
    assert rows == tfa90.block_rows(B, Hq, Tq, D, SM_COUNT)
    if D <= 64 and Tq > 64:
        held = {r: -(-(B * Hq * -(-Tq // r)) // SM_COUNT) * r for r in (128, 192)}
        assert (rows == 192) == (held[192] <= held[128])
    starts = range(0, Tq, rows)
    assert sum(min(Tq, a + rows) - a for a in starts) == Tq
