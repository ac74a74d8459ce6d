"""Port vs JAX reference: RG-LRU block, full forward, prefill and decode.

Parameters come from the JAX ``model.init`` and reach the port through
``params_from_jax``; token ids and activations are made with numpy from
a seed.  Reduced configs in float32: recurrentgemma-2b (4 layers: rglru,
rglru, local attention with window 8, rglru), olmo-1b as a second
case for the non-parametric LayerNorm, SwiGLU and full attention, and
h2o-danube-3-4b for sliding-window attention on every layer (window 8),
RMSNorm and an untied ``lm_head``.

Tolerance: atol 1e-4 on logits (and on block outputs and state).  The
port scans sequentially where the reference's CPU path runs an
associative scan, and its einsums sum in another order, so the two agree
to float32 rounding accumulated over a few layers, not bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.distributed.axes import clear_logical_rules
from repro.models import build_model as jbuild_model
from repro.models import lm as JLM
from repro.models import recurrent as JR
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import lm as TLM
from repro_torch.models import recurrent as TR

torch.set_num_threads(2)

ATOL = 1e-4
ARCHS = ["recurrentgemma-2b", "olmo-1b", "h2o-danube-3-4b"]
B, T, T0 = 2, 18, 12      # T0 > window 8: the local cache is rolled at prefill


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


class Pair:
    """One reduced arch in both packages, with shared parameters and tokens."""

    def __init__(self, arch):
        clear_logical_rules()
        self.jcfg = jget_config(arch).reduced()
        self.cfg = get_config(arch).reduced()
        assert self.cfg == type(self.cfg)(**vars(self.jcfg))
        self.jmodel = jbuild_model(self.jcfg)
        self.model = build_model(self.cfg)
        jparams = jax.jit(lambda r: self.jmodel.init(r)[0])(jax.random.PRNGKey(1))
        self.np_params = jax.tree.map(np.asarray, jparams)
        self.jparams = jparams
        self.params = params_from_jax(self.np_params, self.cfg, device="cpu")
        rng = np.random.default_rng(7)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, T)).astype(np.int32)


_PAIRS = {}


def pair(arch) -> Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def test_config_copies_match_reference():
    from repro.configs import ARCH_IDS as JIDS
    from repro_torch.configs import ARCH_IDS
    assert ARCH_IDS == JIDS
    for arch in ARCH_IDS:
        assert vars(get_config(arch)) == vars(jget_config(arch)), arch
        assert get_config(arch).param_count() == jget_config(arch).param_count()


@pytest.mark.parametrize("mode", ["fresh", "from_state", "decode_step"])
def test_rglru_block_matches_jax(mode):
    pr = pair("recurrentgemma-2b")
    cfg = pr.cfg
    rng = np.random.default_rng(11)
    Tx = 1 if mode == "decode_step" else 9
    x = rng.standard_normal((B, Tx, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda l: l[0], pr.jparams["groups"][0]["mixer"])
    tp = {k: v[0] for k, v in pr.params["groups"][0]["mixer"].items()}
    jstate = tstate = None
    if mode != "fresh":
        h = rng.standard_normal((B, cfg.rnn_width)).astype(np.float32)
        conv = rng.standard_normal((B, cfg.conv_width - 1, cfg.rnn_width)).astype(np.float32)
        jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        tstate = {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}
    jy, jnew = jax.jit(lambda p, x, s: JR.apply_rglru(p, pr.jcfg, x, s))(jp, jnp.asarray(x), jstate)
    ty, tnew = TR.apply_rglru(tp, cfg, torch.from_numpy(x), tstate)
    _close(ty, jy)
    _close(tnew["h"], jnew["h"])
    _close(tnew["conv"], jnew["conv"])


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_stack_train_logits_match_jax(arch):
    pr = pair(arch)
    toks = pr.tokens
    jx = pr.jparams["embed"]["table"][jnp.asarray(toks)]

    @jax.jit
    def jfwd(params, x):
        h, _ = JLM.apply_stack_train(params, pr.jcfg, x, jnp.arange(T))
        return JLM._logits(params, pr.jcfg, h)

    want = jfwd(pr.jparams, jx)
    tx = pr.params["embed"]["table"][torch.from_numpy(toks).long()]
    h, aux = TLM.apply_stack_train(pr.params, pr.cfg, tx, torch.arange(T))
    _close(TLM._logits(pr.params, pr.cfg, h), want)
    assert float(aux) == 0.0


def _jax_prefill_and_decode(pr, max_len):
    cache = pr.jmodel.init_cache(B, max_len)
    prefill = jax.jit(pr.jmodel.prefill)
    decode = jax.jit(pr.jmodel.decode_step)
    lg, cache = prefill(pr.jparams, {"tokens": jnp.asarray(pr.tokens[:, :T0])}, cache)
    prefill_out = (lg, cache)
    steps = []
    for t in range(T0, T):
        lg, cache = decode(pr.jparams, jnp.asarray(pr.tokens[:, t]), jnp.asarray(t, jnp.int32), cache)
        steps.append(lg)
    return prefill_out, steps


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of a prompt longer than the local window (rolled cache),
    then T - T0 = 6 decode steps, against the reference's logits."""
    pr = pair(arch)
    max_len = T + 4
    (jlg, jcache), jsteps = _jax_prefill_and_decode(pr, max_len)
    toks = torch.from_numpy(pr.tokens).long()
    cache = pr.model.init_cache(B, max_len, device="cpu")
    with torch.inference_mode():
        lg, cache = pr.model.prefill(pr.params, {"tokens": toks[:, :T0]}, cache)
        _close(lg, jlg)
        for key in ("k", "v", "pos"):    # every attention cache, rolled or not
            for p_idx, kind in enumerate(pr.cfg.block_pattern):
                if key in cache["groups"][p_idx]:
                    _close(cache["groups"][p_idx][key], jcache["groups"][p_idx][key])
        for i, t in enumerate(range(T0, T)):
            lg, cache = pr.model.decode_step(pr.params, toks[:, t], t, cache)
            _close(lg, jsteps[i])
    assert len(jsteps) == 6


def test_local_cache_is_window_limited_and_rolled():
    pr = pair("recurrentgemma-2b")
    cache = pr.model.init_cache(B, T + 4, device="cpu")
    p_local = pr.cfg.block_pattern.index("local")
    assert cache["groups"][p_local]["k"].shape[3] == pr.cfg.window
    with torch.inference_mode():
        pr.model.prefill(pr.params, {"tokens": torch.from_numpy(pr.tokens[:, :T0]).long()}, cache)
    pos = cache["groups"][p_local]["pos"][0]
    # slot = pos % window, holding the last `window` positions of the prompt
    want = [p for p in range(T0 - pr.cfg.window, T0)]
    assert sorted(pos.tolist()) == want
    assert all(int(p) % pr.cfg.window == s for s, p in enumerate(pos.tolist()))


def test_decode_matches_teacher_forcing():
    """The port's own cached decode reproduces its full forward (the
    property of ``tests/test_models.py::test_decode_matches_teacher_forcing``)."""
    pr = pair("recurrentgemma-2b")
    toks = torch.from_numpy(pr.tokens).long()
    with torch.inference_mode():
        x = pr.params["embed"]["table"][toks]
        full = TLM._logits(pr.params, pr.cfg, TLM.apply_stack_train(
            pr.params, pr.cfg, x, torch.arange(T))[0])
        cache = pr.model.init_cache(B, T + 4, device="cpu")
        lg, cache = pr.model.prefill(pr.params, {"tokens": toks[:, :T0]}, cache)
        errs = [float((lg - full[:, T0 - 1]).abs().max())]
        for t in range(T0, T):
            lg, cache = pr.model.decode_step(pr.params, toks[:, t], t, cache)
            errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < ATOL, errs


@pytest.mark.parametrize("what", ["moe", "mlstm", "loss", "encdec"])
def test_unported_paths_raise(what):
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        if what == "moe":
            build_model(get_config("olmoe-1b-7b").reduced()).init(gen)
        elif what == "mlstm":
            build_model(get_config("xlstm-350m").reduced()).init(gen)
        elif what == "loss":
            # the loss itself is ported; rematerialisation is not
            pr = pair("olmo-1b")
            zeros = torch.zeros(1, 4, dtype=torch.long)
            pr.model.loss_fn(pr.params, {"tokens": zeros, "labels": zeros}, "full")
        else:
            build_model(get_config("seamless-m4t-large-v2").reduced())
