"""Port vs JAX reference: the encoder-decoder (seamless-m4t-large-v2).

Reduced seamless-m4t-large-v2 in float32 (2 encoder + 2 decoder layers,
d_model 64, 4 heads of 16, d_ff 96, vocab 257).  Parameters come from the
JAX ``model.init`` through ``params_from_jax``; frame embeddings and
tokens are made with numpy from a seed.  The reference runs with no mesh
and no logical rules.

Tolerances: atol 1e-4 on encoder outputs, memories and logits (the two
packages sum in other orders), 1e-5 on the loss and its gradients (as
``tests/test_torch_train.py``), 2e-2 for decode against teacher forcing
(``tests/test_models.py``).  The long case runs 4100 encoder frames,
past the blockwise threshold of 4096: the reference's attention takes
``_blockwise_attention`` and the port's takes ``ops.flash_attention``
(its plain version on the CPU) for the encoder, the cross-attention of
the prefill and the one-query cross-attention of each decode step.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.distributed.axes import clear_logical_rules
from repro.models import build_model as jbuild_model
from repro.models import encdec as JED
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.launch.serve import generate
from repro_torch.models import build_model
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models.param_util import tree_leaves
from repro_torch.train import optimizer as topt
from repro_torch.train.step import TrainStepBuilder

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
ATOL, LOSS_ATOL, TEACHER_TOL = 1e-4, 1e-5, 2e-2
B, S, T, T0 = 2, 24, 12, 8          # batch, encoder frames, decoder tokens, prompt
LONG_S, LONG_T0, LONG_DECODES = 4100, 4, 2


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


class Pair:
    """Reduced seamless in both packages, with shared parameters."""

    def __init__(self):
        clear_logical_rules()
        self.jcfg = jget_config(ARCH).reduced()
        self.cfg = get_config(ARCH).reduced()
        assert self.cfg == type(self.cfg)(**vars(self.jcfg))
        assert (self.cfg.n_enc_layers, self.cfg.n_layers, self.cfg.d_model) == (2, 2, 64)
        self.jmodel = jbuild_model(self.jcfg)
        self.model = build_model(self.cfg)
        self.jparams = jax.jit(lambda r: self.jmodel.init(r)[0])(jax.random.PRNGKey(1))
        self.params = params_from_jax(jax.tree.map(np.asarray, self.jparams), self.cfg,
                                      device="cpu")

    def inputs(self, batch=B, frames=S, tokens=T, seed=7):
        """Frame embeddings (float32) and token ids, numpy, from ``seed``."""
        rng = np.random.default_rng(seed)
        frames = rng.standard_normal((batch, frames, self.cfg.d_model)).astype(np.float32)
        toks = rng.integers(0, self.cfg.vocab_size, (batch, tokens)).astype(np.int32)
        return frames, toks


_PAIR = []


def pair() -> Pair:
    if not _PAIR:
        _PAIR.append(Pair())
    return _PAIR[0]


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _loss_batches(cfg, batch=B, seed=13):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((batch, S, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (batch, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, T)).astype(np.int32)
    labels[:, :3] = -1
    jb = {"enc_embeds": jnp.asarray(frames), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(labels)}
    tb = {"enc_embeds": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens).long(),
          "labels": torch.from_numpy(labels).long()}
    return jb, tb


@pytest.mark.parametrize("what", ["encode", "cross_memories", "decode_train"])
def test_encoder_memories_and_decoder_match_jax(what):
    pr = pair()
    frames, toks = pr.inputs()
    jenc = jax.jit(lambda p, x: JED.encode(p, pr.jcfg, x))(pr.jparams, jnp.asarray(frames))
    with torch.inference_mode():
        enc = TED.encode(pr.params, pr.cfg, torch.from_numpy(frames))
        if what == "encode":
            _close(enc, jenc)
        elif what == "cross_memories":
            jk, jv = jax.jit(lambda p, e: JED.cross_memories(p, pr.jcfg, e))(pr.jparams, jenc)
            k, v = TED.cross_memories(pr.params, pr.cfg, enc)
            assert tuple(k.shape) == jk.shape == (pr.cfg.n_layers, B, pr.cfg.n_kv_heads, S,
                                                  pr.cfg.head_dim)
            assert k.is_contiguous() and v.is_contiguous()
            _close(k, jk)
            _close(v, jv)
        else:
            want = jax.jit(lambda p, t, e: JED.decode_train(p, pr.jcfg, t, e))(
                pr.jparams, jnp.asarray(toks), jenc)
            got = TED.decode_train(pr.params, pr.cfg, torch.from_numpy(toks).long(), enc)
            assert tuple(got.shape) == (B, T, pr.cfg.vocab_size)
            _close(got, want)


@pytest.mark.parametrize("cross", [False, True])
def test_cross_attention_blocks_have_no_bias_or_qk_norm(cross):
    """``init_attention(..., cross=True)`` leaves out the QKV bias and the
    qk-norm scales that a config asks for, as the reference does."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), qkv_bias=True, qk_norm=True)
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), qkv_bias=True, qk_norm=True)
    jp = JL.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32, cross=cross)
    tp = TL.init_attention(torch.Generator().manual_seed(0), cfg, torch.float32, cross=cross)
    assert set(tp) == set(jp)
    for key in tp:
        assert tuple(tp[key].shape) == jp[key][0].shape
    assert ({"bq", "bk", "bv", "q_scale", "k_scale"} <= set(tp)) != cross


def test_encdec_loss_and_grads_match_jax():
    pr = pair()
    jb, tb = _loss_batches(pr.cfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(pr.jmodel.loss_fn, has_aux=True))(
        pr.jparams, jb)
    live = [t.detach().clone().requires_grad_() for t in jax.tree.leaves(pr.params)]
    params = jax.tree.unflatten(jax.tree.structure(pr.params), live)
    loss, m = pr.model.loss_fn(params, tb)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=LOSS_ATOL)
    assert set(m) == set(jm) == {"ce", "zloss", "tokens"}
    for k in m:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=0, atol=LOSS_ATOL)
    assert float(m["tokens"]) == B * (T - 3)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        assert tuple(g.shape) == w.shape
        _close(g, w, atol=LOSS_ATOL)


def _jax_serve(pr, frames, toks, prompt, max_len):
    """The reference's prefill of ``prompt`` tokens, then one decode step
    per remaining token: (prefill logits, cache, memories, step logits)."""
    prefill, decode = jax.jit(pr.jmodel.prefill), jax.jit(pr.jmodel.decode_step)
    lg, cache, mem = prefill(pr.jparams, {"enc_embeds": jnp.asarray(frames),
                                          "tokens": jnp.asarray(toks[:, :prompt])},
                             pr.jmodel.init_cache(toks.shape[0], max_len))
    first = (lg, cache, mem)
    steps = []
    for t in range(prompt, toks.shape[1]):
        lg, cache = decode(pr.jparams, jnp.asarray(toks[:, t]), jnp.asarray(t, jnp.int32),
                           cache, mem)
        steps.append(lg)
    return first, steps


def _port_serve(pr, frames, toks, prompt, max_len):
    with torch.inference_mode():
        lg, cache, mem = pr.model.prefill(
            pr.params, {"enc_embeds": torch.from_numpy(frames),
                        "tokens": torch.from_numpy(toks[:, :prompt]).long()},
            pr.model.init_cache(toks.shape[0], max_len, device="cpu"))
        first = (lg.clone(), {k: v.clone() for k, v in cache.items()}, mem)
        steps = []
        for t in range(prompt, toks.shape[1]):
            lg, cache = pr.model.decode_step(pr.params, torch.from_numpy(toks[:, t]).long(), t,
                                             cache, mem)
            steps.append(lg)
    return first, steps


def test_prefill_and_decode_match_jax():
    """The facade's prefill (logits, the decoder's caches, the memories)
    and T - T0 decode steps against the reference's."""
    pr = pair()
    frames, toks = pr.inputs()
    (jlg, jcache, jmem), jsteps = _jax_serve(pr, frames, toks, T0, T + 2)
    (lg, cache, mem), steps = _port_serve(pr, frames, toks, T0, T + 2)
    _close(lg, jlg)
    for key in ("k", "v", "pos"):
        assert tuple(cache[key].shape) == jcache[key].shape
        _close(cache[key], jcache[key])
    _close(mem[0], jmem[0])
    _close(mem[1], jmem[1])
    assert len(steps) == len(jsteps) == T - T0
    for got, want in zip(steps, jsteps):
        _close(got, want)


def test_decode_matches_teacher_forcing():
    """The port's own prefill plus single-step decodes reproduce
    ``decode_train`` over the whole sequence."""
    pr = pair()
    frames, toks = pr.inputs(seed=9)
    with torch.inference_mode():
        enc = TED.encode(pr.params, pr.cfg, torch.from_numpy(frames))
        full = TED.decode_train(pr.params, pr.cfg, torch.from_numpy(toks).long(), enc)
    (lg, _, _), steps = _port_serve(pr, frames, toks, T0, T + 2)
    errs = [float((lg - full[:, T0 - 1]).abs().max())]
    errs += [float((s - full[:, t]).abs().max()) for t, s in zip(range(T0, T), steps)]
    assert max(errs) < TEACHER_TOL, errs


def test_remat_policies_agree():
    """``encdec_loss`` at "none", "full" and "dots": the same loss (rtol
    1e-6) and gradients (rtol 2e-4, atol 1e-6; the reference's bounds,
    tests/test_models.py::test_remat_policies_agree), and the reference's
    loss at each policy within 1e-5."""
    pr = pair()
    jb, tb = _loss_batches(pr.cfg, seed=17)
    out = {}
    for policy in ("none", "full", "dots"):
        live = [t.detach().clone().requires_grad_() for t in jax.tree.leaves(pr.params)]
        params = jax.tree.unflatten(jax.tree.structure(pr.params), live)
        loss, _ = pr.model.loss_fn(params, tb, policy)
        out[policy] = float(loss.detach()), torch.autograd.grad(loss, live)
        jloss, _ = jax.jit(lambda p, b: pr.jmodel.loss_fn(p, b, policy))(pr.jparams, jb)
        np.testing.assert_allclose(out[policy][0], float(jloss), rtol=0, atol=LOSS_ATOL)
    for policy in ("full", "dots"):
        np.testing.assert_allclose(out[policy][0], out["none"][0], rtol=1e-6)
        for a, b in zip(out[policy][1], out["none"][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)
    with pytest.raises(ValueError):
        pr.model.loss_fn(pr.params, tb, "some")


def test_train_step_accumulation_matches_joined_batch():
    """``TrainStepBuilder`` with accum=2 cuts every batch leaf, the frame
    embeddings too, and matches accum=1 on the joined batch."""
    pr = pair()
    _, tb = _loss_batches(pr.cfg, batch=4, seed=19)
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100, clip_norm=None)
    out = {}
    for accum in (1, 2):
        builder = TrainStepBuilder(pr.model, opt=opt, accum=accum)
        state = builder.init_state(torch.Generator().manual_seed(0))
        state, m = builder.train_step_fn()(state, tb)
        out[accum] = state, float(m["loss"]), float(m["tokens"])
    (s1, l1, n1), (s2, l2, n2) = out[1], out[2]
    assert (n1, n2) == (4 * (T - 3), 2 * (T - 3))   # a microbatch's tokens
    np.testing.assert_allclose(l2, l1, atol=1e-6)
    # after one step mu = (1 - b1) * grad: the accumulated gradient itself
    for a, b in zip(tree_leaves(s1["opt"]["mu"]), tree_leaves(s2["opt"]["mu"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-4, atol=1e-6)


def test_long_memory_takes_the_blockwise_path(monkeypatch):
    """4100 frames: the reference's encoder and cross-attention go through
    ``_blockwise_attention`` and the port's through ``ops.flash_attention``
    (its plain version here), in the prefill and in every decode step;
    logits within 1e-4."""
    pr = pair()
    frames, toks = pr.inputs(batch=1, frames=LONG_S, tokens=LONG_T0 + LONG_DECODES, seed=21)
    assert LONG_S > JL.BLOCKWISE_KV_THRESHOLD
    jcalls, tcalls = [], []
    blockwise, flash = JL._blockwise_attention, tops.flash_attention

    def jcounted(q, k, v, **kw):
        jcalls.append((q.shape, k.shape, kw["causal"]))
        return blockwise(q, k, v, **kw)

    def tcounted(q, k, v, **kw):
        tcalls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(JL, "_blockwise_attention", jcounted)
    monkeypatch.setattr(tops, "flash_attention", tcounted)
    max_len = LONG_T0 + LONG_DECODES + 2
    (jlg, _, _), jsteps = _jax_serve(pr, frames, toks, LONG_T0, max_len)
    (lg, _, mem), steps = _port_serve(pr, frames, toks, LONG_T0, max_len)
    _close(lg, jlg)
    for got, want in zip(steps, jsteps):
        _close(got, want)
    assert tuple(mem[0].shape) == (pr.cfg.n_layers, 1, pr.cfg.n_kv_heads, LONG_S,
                                   pr.cfg.head_dim)
    # the reference traces its scan bodies once: an encoder, a cross prefill
    # and a cross decode call, all over the 4100 frames, none causal
    heads, dh, n = pr.cfg.n_heads, pr.cfg.head_dim, pr.cfg.n_layers
    assert {(q[2], k[2], c) for q, k, c in jcalls} == {(LONG_S, LONG_S, False),
                                                       (LONG_T0, LONG_S, False),
                                                       (1, LONG_S, False)}
    kv = (1, heads, LONG_S, dh)
    want = ([((1, heads, LONG_S, dh), kv, False)] * pr.cfg.n_enc_layers
            + [((1, heads, LONG_T0, dh), kv, False)] * n
            + [((1, heads, 1, dh), kv, False)] * n * LONG_DECODES)
    assert tcalls == want


def test_generate_and_init_lm_refuse_an_encoder_decoder():
    """``generate`` and ``lm.init_lm`` are decoder-only, as in the
    reference; each says where an encoder-decoder goes instead."""
    pr = pair()
    with pytest.raises(NotImplementedError, match="Model.prefill"):
        generate(pr.model, pr.params, [np.arange(4)], max_new=2, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        TLM.init_lm(torch.Generator(), pr.cfg)
