"""Port vs JAX reference: the xLSTM blocks (mLSTM and sLSTM).

Reduced xlstm-350m in float32 (9 layers: 7 mLSTM, an sLSTM, an mLSTM;
d_rnn 64, 4 heads of 16), with parameters from the JAX init handed over
through ``params_from_jax`` and activations and states made with numpy
from a seed.  Each block is held to the reference's at atol 1e-4 on its
output and final state (the mLSTM's matrix memory C relative to its
largest entry): the mLSTM in chunks of 4 over 18 steps (padding, state
carried across chunks) and at its default chunk, from a zero and from a
given state, and one decode step; the sLSTM likewise.  The full
forward, prefill and decode against the reference are in
``test_torch_models.py``; here the port's own decode is held to its
teacher forcing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.distributed.axes import clear_logical_rules
from repro.models import build_model as jbuild_model
from repro.models import recurrent as JR
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import lm as TLM
from repro_torch.models import recurrent as TR

torch.set_num_threads(2)

ARCH = "xlstm-350m"
ATOL = 1e-4
B, T = 2, 18
MODES = ["fresh", "from_state", "decode_step"]


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


_PAIR = {}


def _pair():
    if not _PAIR:
        jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
        assert (cfg.n_layers, cfg.rnn_width, cfg.n_heads) == (9, 64, 4)
        jparams = jax.jit(lambda r: jbuild_model(jcfg).init(r)[0])(jax.random.PRNGKey(1))
        _PAIR.update(jcfg=jcfg, cfg=cfg, jparams=jparams,
                     params=params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return _PAIR


def _block(kind):
    """Layer 0 of the pattern position holding ``kind``, in both packages."""
    pr = _pair()
    p_idx = pr["cfg"].block_pattern.index(kind)
    jp = jax.tree.map(lambda l: l[0], pr["jparams"]["groups"][p_idx]["mixer"])
    tp = {k: v[0] for k, v in pr["params"]["groups"][p_idx]["mixer"].items()}
    return pr["jcfg"], pr["cfg"], jp, tp


def _state(shapes, rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _close(got, want, key=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if key == "C" else 1.0
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("mode", MODES + ["chunk4_from_state"])
def test_mlstm_block_matches_jax(mode):
    jcfg, cfg, jp, tp = _block("mlstm")
    rng = np.random.default_rng(21)
    Tx = 1 if mode == "decode_step" else T
    chunk = 4 if mode.startswith("chunk4") else 256
    x = rng.standard_normal((B, Tx, cfg.d_model)).astype(np.float32)
    jstate = tstate = None
    if mode != "fresh":
        H, dh = cfg.n_heads, cfg.rnn_width // cfg.n_heads
        st = _state({"C": (B, H, dh, dh), "n": (B, H, dh), "m": (B, H),
                     "conv": (B, cfg.conv_width - 1, cfg.rnn_width)}, rng)
        jstate = {k: jnp.asarray(v) for k, v in st.items()}
        tstate = {k: torch.from_numpy(v) for k, v in st.items()}
    jy, jnew = jax.jit(lambda p, x, s: JR.apply_mlstm(p, jcfg, x, s, chunk=chunk))(
        jp, jnp.asarray(x), jstate)
    ty, tnew = TR.apply_mlstm(tp, cfg, torch.from_numpy(x), tstate, chunk=chunk)
    _close(ty, jy)
    for key in ("C", "n", "m", "conv"):
        assert tnew[key].dtype == torch.float32
        _close(tnew[key], jnew[key], key)


@pytest.mark.parametrize("mode", MODES)
def test_slstm_block_matches_jax(mode):
    jcfg, cfg, jp, tp = _block("slstm")
    rng = np.random.default_rng(23)
    Tx = 1 if mode == "decode_step" else T
    x = rng.standard_normal((B, Tx, cfg.d_model)).astype(np.float32)
    jstate = tstate = None
    if mode != "fresh":
        st = _state({k: (B, cfg.rnn_width) for k in ("c", "n", "h", "m")}, rng)
        st["n"] = np.abs(st["n"]) + 0.5       # a normaliser is a sum of positive gates
        jstate = {k: jnp.asarray(v) for k, v in st.items()}
        tstate = {k: torch.from_numpy(v) for k, v in st.items()}
    jy, jnew = jax.jit(lambda p, x, s: JR.apply_slstm(p, jcfg, x, s))(jp, jnp.asarray(x), jstate)
    ty, tnew = TR.apply_slstm(tp, cfg, torch.from_numpy(x), tstate)
    _close(ty, jy)
    for key in ("c", "n", "h", "m"):
        _close(tnew[key], jnew[key], key)


def test_decode_matches_teacher_forcing():
    """The port's own cached decode reproduces its full forward (the
    property of ``tests/test_models.py::test_decode_matches_teacher_forcing``,
    which runs xlstm-350m), through mLSTM chunks of 12 then single steps."""
    pr = _pair()
    cfg, params = pr["cfg"], pr["params"]
    model = build_model(cfg)
    T0 = 12
    toks = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int64))
    with torch.inference_mode():
        x = params["embed"]["table"][toks]
        full = TLM._logits(params, cfg, TLM.apply_stack_train(params, cfg, x, torch.arange(T))[0])
        cache = model.init_cache(B, T + 4, device="cpu")
        lg, cache = model.prefill(params, {"tokens": toks[:, :T0]}, cache)
        errs = [float((lg - full[:, T0 - 1]).abs().max())]
        for t in range(T0, T):
            lg, cache = model.decode_step(params, toks[:, t], t, cache)
            errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < ATOL, errs
    m_state = cache["groups"][cfg.block_pattern.index("mlstm")]
    assert m_state["C"].dtype == torch.float32 and m_state["conv"].dtype == torch.float32
