"""The port's kernels and their plain versions vs the JAX reference.

On the CPU the port runs each kernel's plain PyTorch version; these tests
hold it to the JAX oracle and to the Pallas kernel in interpret mode, at
the tolerances of ``tests/test_kernels.py``.  The CUDA kernel itself runs
only on the card (``chip_smoke.py`` holds it against the plain version
there); here the tests check that its wrapper validates its inputs
before anything is built, and that a CPU tensor never reaches it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.distributed.axes import clear_logical_rules
from repro.kernels import ref as jref
from repro.kernels.linear_scan import linear_scan_pallas
from repro_torch.kernels import build, ops
from repro_torch.kernels import linear_scan as tls
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

_jax_scan = jax.jit(jref.ref_linear_scan)
_jax_attention = jax.jit(jref.ref_attention, static_argnames=("causal", "window", "q_offset"))


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


def _scan_inputs(B, T, D, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, T, D)).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    return a, x


@pytest.mark.parametrize("B,T,D", [(2, 64, 32), (3, 100, 17), (1, 1, 8), (4, 257, 130)])
def test_ref_linear_scan_matches_jax(B, T, D):
    a, x = _scan_inputs(B, T, D)
    got = tref.ref_linear_scan(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    want = np.asarray(_jax_scan(jnp.asarray(a), jnp.asarray(x)))
    pallas = np.asarray(linear_scan_pallas(jnp.asarray(a), jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_ref_linear_scan_h0_matches_jax():
    a, x = _scan_inputs(3, 40, 24, seed=1)
    h0 = np.random.default_rng(2).standard_normal((3, 24)).astype(np.float32)
    got = tref.ref_linear_scan(torch.from_numpy(a), torch.from_numpy(x),
                               torch.from_numpy(h0)).numpy()
    want = np.asarray(_jax_scan(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ref_linear_scan_is_exclusive_prefix_correct():
    # h_0 must equal x_0 (no pre-existing state)
    a = torch.full((1, 4, 2), 0.5)
    x = torch.ones((1, 4, 2))
    h = tref.ref_linear_scan(a, x)
    np.testing.assert_allclose(h[0, 0].numpy(), [1.0, 1.0])
    np.testing.assert_allclose(h[0, 1].numpy(), [1.5, 1.5])


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything asks for the CUDA library."""
    def refuse(name):
        raise AssertionError(f"CUDA build of {name!r} requested")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(tls, "_fn", None)


def test_ops_linear_scan_on_cpu_never_touches_the_extension(no_build):
    a, x = _scan_inputs(2, 33, 16, seed=3)
    ops.reset_launch_counts()
    got = ops.linear_scan(torch.from_numpy(a), torch.from_numpy(x))
    want = tref.ref_linear_scan(torch.from_numpy(a), torch.from_numpy(x))
    assert torch.equal(got, want)
    assert ops.launch_counts() == {"linear_scan": 0, "page_digest": 0, "delta_mask": 0,
                                   "flash_attention": 0, "flash_attention_sm90": 0,
                                   "flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0}


@pytest.mark.parametrize("case", ["cpu_tensor", "dtype", "shape", "rank", "contiguity",
                                  "meta_device", "mixed_device"])
def test_cuda_wrapper_rejects_bad_inputs_before_building(case, no_build):
    a = torch.rand(2, 8, 4)
    x = torch.rand(2, 8, 4)
    if case == "dtype":
        a, x = a.double(), x.double()
    elif case == "shape":
        x = torch.rand(2, 8, 5)
    elif case == "rank":
        a, x = a[0], x[0]
    elif case == "contiguity":
        a, x = a.transpose(1, 2), x.transpose(1, 2)
    elif case == "meta_device":
        a, x = a.to("meta"), x.to("meta")
    elif case == "mixed_device":
        a = a.to("meta")
    before = tls.launches
    with pytest.raises((ValueError, TypeError)):
        tls.linear_scan_cuda(a, x)
    assert tls.launches == before


def test_build_targets_hopper_and_keys_on_sources():
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}
    path = build.library_path("linear_scan")
    assert path.parent == build.BUILD_DIR and path.name.startswith("liblinear_scan-")


@pytest.mark.parametrize(
    "B,Hq,Hkv,Tq,Tk,D,causal,window",
    [
        (2, 4, 2, 64, 64, 32, True, None),     # GQA causal
        (1, 8, 1, 37, 37, 16, True, None),     # MQA, ragged T
        (2, 2, 2, 50, 70, 8, False, None),     # cross-ish
        (1, 4, 2, 96, 96, 64, True, 24),       # sliding window
        (1, 2, 1, 1, 40, 16, True, None),      # decode shape
    ],
)
def test_ref_attention_matches_jax(B, Hq, Hkv, Tq, Tk, D, causal, window):
    rng = np.random.default_rng(42)
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    qo = Tk - Tq if causal else 0
    got = tref.ref_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=causal, window=window, q_offset=qo).numpy()
    want = np.asarray(_jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, window=window, q_offset=qo))
    np.testing.assert_allclose(got, want, atol=2e-5)
