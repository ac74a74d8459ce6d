"""The port's page digest and delta mask vs the JAX reference, bit for bit.

On the CPU the port runs the plain versions (``repro_torch.kernels.ref``
behind ``ops``); these tests hold them to the JAX oracle
(``repro.kernels.ref``), to the Pallas kernels in interpret mode and to
the numpy digest of the blob client (``host_page_digest``), with no
tolerance: checkpoints of the two packages must carry the same digests.
The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against the plain versions there); here the tests check that their
wrappers refuse bad input before anything is built, and that a CPU
tensor never reaches them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.distributed.axes import clear_logical_rules
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.delta_mask import delta_mask_pallas
from repro.kernels.hostdigest import host_page_digest
from repro.kernels.page_digest import page_digest_pallas
from repro_torch.kernels import build, ops
from repro_torch.kernels import delta_mask as tdm
from repro_torch.kernels import hostdigest as thostdigest
from repro_torch.kernels import page_digest as tpd
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

_jax_digest = jax.jit(jref.ref_page_digest)


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything asks for a CUDA library."""
    def refuse(name):
        raise AssertionError(f"CUDA build of {name!r} requested")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(tpd, "_fn", None)
    monkeypatch.setattr(tdm, "_fn", None)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _host_digests(data: bytes, psize: int) -> np.ndarray:
    n_pages = -(-len(data) // psize)
    return np.array([host_page_digest(data[p * psize:(p + 1) * psize], psize)
                     for p in range(n_pages)], dtype=np.uint64).astype(np.uint32).reshape(-1, 2)


# ------------------------------------------------------------ word domain
@pytest.mark.parametrize("n_pages,n_words", [(1, 512), (3, 512), (8, 1024), (17, 1536)])
def test_ref_page_digest_matches_jax_pallas_and_host(n_pages, n_words):
    # the shapes of tests/test_kernels.py
    words = np.random.default_rng(n_pages).integers(0, 2**32, (n_pages, n_words),
                                                    dtype=np.uint32)
    got = _u32(tref.ref_page_digest(torch.from_numpy(words.view(np.int32))))
    want = np.asarray(_jax_digest(jnp.asarray(words)))
    pallas = np.asarray(page_digest_pallas(jnp.asarray(words), interpret=True))
    host = _host_digests(words.tobytes(), n_words * 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, host)


# ------------------------------------------------------------ byte domain
@pytest.mark.parametrize("psize,total", [
    (64 * 1024, 3 * 64 * 1024),   # whole pages, block-aligned
    (4096, 4096 * 2 + 100),       # short tail page
    (100, 7 * 100),               # page smaller than one digest block
    (8, 8),                       # degenerate single tiny page
])
def test_ops_page_digest_of_bytes_matches_reference(psize, total):
    # the (psize, total) cases of tests/test_dedup.py
    data = np.random.default_rng(total).integers(0, 256, size=total, dtype=np.uint8)
    got = _u32(ops.page_digest(torch.from_numpy(data), page_bytes=psize))
    jwords = jops.as_page_words(jnp.asarray(data), psize)
    np.testing.assert_array_equal(ops.as_page_words(torch.from_numpy(data), psize).numpy()
                                  .view(np.uint32), np.asarray(jwords))
    np.testing.assert_array_equal(got, np.asarray(_jax_digest(jwords)))
    np.testing.assert_array_equal(got, np.asarray(page_digest_pallas(jwords, interpret=True)))
    np.testing.assert_array_equal(got, _host_digests(data.tobytes(), psize))


def _leaf(kind: str):
    """(torch leaf, its raw bytes) for a leaf of the checkpoint's dtypes."""
    rng = np.random.default_rng(7)
    n = {"odd_bf16": 5001, "small_f32": 37}.get(kind, 5000)
    x = rng.standard_normal(n).astype(np.float32)
    if kind in ("bf16", "odd_bf16"):
        arr = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))     # ml_dtypes bfloat16
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    elif kind == "int32":
        arr = (x * 1000).astype(np.int32)
        t = torch.from_numpy(arr.copy())
    else:
        arr = x
        t = torch.from_numpy(arr.copy())
    return t, arr.tobytes()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int32", "odd_bf16", "small_f32"])
def test_ops_page_digest_of_leaves_matches_reference(kind):
    # odd_bf16: 10002 bytes, not a multiple of 4; small_f32: under one page
    psize = 4096
    t, raw = _leaf(kind)
    got = _u32(ops.page_digest(t, page_bytes=psize))
    # the reference checkpointer's call: bytes padded to whole words
    padded = raw + b"\0" * ((-len(raw)) % 4)
    want = np.asarray(jops.page_digest(jnp.asarray(np.frombuffer(padded, np.uint8)),
                                       page_bytes=psize))
    pallas = np.asarray(page_digest_pallas(
        jops.as_page_words(jnp.asarray(np.frombuffer(padded, np.uint8)), psize),
        interpret=True))
    assert got.shape == (-(-len(raw) // psize), 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _host_digests(raw, psize))


def test_page_digest_sensitive_to_order_and_single_bits():
    words = np.zeros((4, 512), np.uint32)
    words[1, 0] = words[2, 137] = words[3, 511] = 1
    d = _u32(tref.ref_page_digest(torch.from_numpy(words.view(np.int32))))
    assert len({tuple(r) for r in d}) == 4
    x = np.random.default_rng(1).integers(0, 2**32, (1, 512), dtype=np.uint32)
    rev = np.ascontiguousarray(x[:, ::-1])
    a, b = (tref.ref_page_digest(torch.from_numpy(v.view(np.int32))) for v in (x, rev))
    assert not torch.equal(a, b)


def test_digest_constants_are_the_reference_constants():
    from repro.kernels import hostdigest as jhostdigest
    assert thostdigest.DIGEST_MULTS == jhostdigest.DIGEST_MULTS
    assert thostdigest.DIGEST_SALT == jhostdigest.DIGEST_SALT
    assert thostdigest.DIGEST_BLOCK_WORDS == jops.DIGEST_BLOCK_WORDS
    assert tpd.padded_page_words(100) == 512 and tpd.padded_page_words(256 * 1024) == 65536


# ------------------------------------------------------------ delta mask
def test_ops_delta_mask_matches_reference():
    # the case of tests/test_kernels.py
    new = np.random.default_rng(42).integers(0, 2**32, (300, 2), dtype=np.uint32)
    old = new.copy()
    old[17, 0] += 1
    old[255, 1] += 3
    got = ops.delta_mask(torch.from_numpy(new.view(np.int32)), torch.from_numpy(old.view(np.int32)))
    want = np.asarray(jref.ref_delta_mask(jnp.asarray(new), jnp.asarray(old)))
    pallas = np.asarray(delta_mask_pallas(jnp.asarray(new), jnp.asarray(old), interpret=True)) != 0
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert int(got.sum()) == 2


# ------------------------------------------------------------ dispatch and wrappers
def test_cpu_dispatch_never_builds(no_build):
    ops.reset_launch_counts()
    d = ops.page_digest(torch.arange(3000, dtype=torch.float32), page_bytes=4096)
    m = ops.delta_mask(d, d.clone())
    assert d.shape == (3, 2) and not bool(m.any())
    assert ops.launch_counts() == {"linear_scan": 0, "page_digest": 0, "delta_mask": 0,
                                   "flash_attention": 0, "flash_attention_sm90": 0,
                                   "flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0}


@pytest.mark.parametrize("case", ["cpu_tensor", "dtype", "rank", "contiguity", "page_bytes"])
def test_page_digest_wrapper_rejects_bad_inputs_before_building(case, no_build):
    data, psize = torch.zeros(4096, dtype=torch.uint8), 1024
    if case == "dtype":
        data = torch.zeros(1024, dtype=torch.float32)
    elif case == "rank":
        data = data.reshape(64, 64)
    elif case == "contiguity":
        data = data[::2]
    elif case == "page_bytes":
        psize = 1022
    with pytest.raises((ValueError, TypeError)):
        tpd.page_digest_cuda(data, psize)
    assert tpd.launches == 0


@pytest.mark.parametrize("case", ["cpu_tensor", "dtype", "shape", "width", "contiguity"])
def test_delta_mask_wrapper_rejects_bad_inputs_before_building(case, no_build):
    new = torch.zeros(8, 2, dtype=torch.int32)
    old = torch.zeros(8, 2, dtype=torch.int32)
    if case == "dtype":
        new, old = new.long(), old.long()
    elif case == "shape":
        old = torch.zeros(9, 2, dtype=torch.int32)
    elif case == "width":
        new, old = torch.zeros(8, 3, dtype=torch.int32), torch.zeros(8, 3, dtype=torch.int32)
    elif case == "contiguity":
        new, old = torch.zeros(2, 8, dtype=torch.int32).T, torch.zeros(2, 8, dtype=torch.int32).T
    with pytest.raises((ValueError, TypeError)):
        tdm.delta_mask_cuda(new, old)
    assert tdm.launches == 0
