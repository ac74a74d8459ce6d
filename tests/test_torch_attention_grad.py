"""Gradients through the port's kernels vs the JAX reference.

Above 4096 kv positions the reference trains through
``models/layers.py::_blockwise_attention`` (plain jnp, differentiated by
``jax.grad``) and its RG-LRU through ``kernels/ops.py::linear_scan``.  The
port records ``ops.flash_attention`` with ``ops._FlashAttention``, whose
backward is ``ref.ref_flash_attention_backward`` here on the CPU (the CUDA
kernel ``flash_attention_bwd`` on the card, held to that plain version by
``chip_smoke.py``), and ``ops.linear_scan`` through the custom op
``repro_torch::linear_scan``, whose gradient is the reversed scan.

These tests hold, with inputs made by numpy from a seed:
* the attention's gradients through ``ops.flash_attention`` (and the plain
  backward at a small chunk) to ``jax.grad`` of ``_blockwise_attention``,
  the loss ``sum(out * w)``: 2e-5 x max|want| in float32 and 3e-2 x
  max|want| in bf16 per gradient (``tests/test_kernels.py:84, :93``,
  scaled to the gradient);
* the plain row log-sum-exp to a direct ``logsumexp`` of the masked scores;
* the loss and every parameter gradient of a reduced danube decoder
  (2 layers, GQA, window) at 4100 tokens, of a reduced olmo-1b (2 layers,
  MHA, plain causal) at 4100 tokens and of a reduced seamless at 4100
  frames to ``jax.value_and_grad`` of the reference at 1e-5
  (``tests/test_torch_train.py``);
* the scan's gradient through ``ops.linear_scan`` to ``jax.grad`` of the
  reference's ``linear_scan`` (1e-5, ``tests/test_kernels.py``) and a
  reduced recurrentgemma's gradients at 1e-5, its scan recorded by the
  custom op;
* the dry run: a fake-tensor train step past 4096 kv positions traces,
  counting the backward's 8 B Hq D FLOPs a live pair;
* the bf16 backward's fp16 operands at head widths up to 128: its scale
  rule (``flash_attention_bwd_sm90.fp16_exponent``) converts every bf16
  value within 2^-30 of a tensor's largest exactly and overflows nowhere,
  and a float32 emulation of the kernel's arithmetic (scaled fp16 copies, P
  and dS rounded once to fp16) stays within ``chip_smoke.py``'s backward
  limit (2^-7 |want| + 1e-3 max|want|) of the plain backward at the shapes
  of its ``FLASH_BWD_D64_CASES`` and ``FLASH_D128_CASES``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.distributed.axes import clear_logical_rules
from repro.kernels import ops as jops
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro_torch.checkpoint.blobckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import hlo as H
from repro_torch.launch.specs import build_cell
from repro_torch.models import build_model
from repro_torch.models.param_util import tree_map

torch.set_num_threads(2)

GRAD_TOL = {np.float32: 2e-5, jnp.bfloat16: 3e-2}   # x max|want|: tests/test_kernels.py:84, :93
LSE_TOL = 1e-5
SCAN_TOL = 1e-5                                      # tests/test_kernels.py
LOSS_ATOL = 1e-5                                     # tests/test_torch_train.py
LONG_T = 4100                                        # > BLOCKWISE_KV_THRESHOLD


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


def _inputs(B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    w = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    return q, k, v, w


def _torch(x, dtype, grad=False):
    t = torch.from_numpy(x)
    t = t.to(torch.bfloat16) if dtype is jnp.bfloat16 else t
    return t.requires_grad_(grad)


def _jax_grads(q, k, v, w, dtype, chunk, **kw):
    def loss(q, k, v):
        out = JL._blockwise_attention(q, k, v, chunk=chunk, **kw)
        return jnp.sum(out.astype(jnp.float32) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(g, np.float32) for g in grads]


def _assert_grads(got, want, tol, what):
    for name, g, w in zip("qkv", got, want):
        assert tuple(g.shape) == w.shape, (what, name)
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0,
                                   atol=tol * float(np.abs(w).max()), err_msg=f"{what} d{name}")


# (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset, chunk, dtype):
# causal GQA with Tk off the chunk, no mask, a window over cross lengths
# (groups of 4), softcap, rows before the first key (fully masked), cross
# attention with no mask, and bf16 with a window and with a softcap
GRAD_CASES = [
    (2, 4, 2, 40, 40, 16, True, None, None, 0, 16, np.float32),
    (1, 4, 4, 30, 30, 8, False, None, None, 0, 16, np.float32),
    (1, 4, 1, 50, 70, 16, True, 20, None, 20, 32, np.float32),
    (1, 2, 2, 30, 60, 16, True, None, 2.0, 30, 16, np.float32),
    (1, 4, 2, 40, 40, 16, True, None, None, -10, 16, np.float32),
    (2, 4, 2, 12, 70, 16, False, None, None, 0, 32, np.float32),
    (1, 4, 2, 40, 50, 16, True, 12, None, 10, 16, jnp.bfloat16),
    (1, 4, 4, 30, 30, 16, False, None, 3.0, 0, 16, jnp.bfloat16),
]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap,q_offset,chunk,dtype",
                         GRAD_CASES)
def test_flash_attention_gradients_match_blockwise(B, Hq, Hkv, Tq, Tk, D, causal, window,
                                                   softcap, q_offset, chunk, dtype):
    q, k, v, w = _inputs(B, Hq, Hkv, Tq, Tk, D, seed=Tq * 100 + Tk)
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    want = _jax_grads(q, k, v, w, dtype, chunk, **kw)
    tq, tk, tv = (_torch(x, dtype, grad=True) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), (tq, tk, tv))
    assert [g.dtype for g in got] == [tq.dtype] * 3
    _assert_grads(got, want, GRAD_TOL[dtype], "ops")
    # the plain backward over chunks of the reference's size
    o, lse = tref.ref_flash_attention(tq.detach(), tk.detach(), tv.detach(), chunk=chunk,
                                      return_lse=True, **kw)
    do = _torch(w, dtype)
    plain = tref.ref_flash_attention_backward(tq.detach(), tk.detach(), tv.detach(), o, lse,
                                              do, chunk=chunk, **kw)
    _assert_grads(plain, want, GRAD_TOL[dtype], f"plain, chunk {chunk}")
    if q_offset < 0:        # rows before the first key: no gradient at all
        assert not got[0][:, :, :-q_offset].any()
        assert torch.isinf(lse[:, :, :-q_offset]).all()


@pytest.mark.parametrize("causal,window,softcap,q_offset", [
    (True, None, None, 30), (True, 9, None, 30), (False, None, 2.0, 0), (True, None, None, -7)])
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(causal, window, softcap, q_offset):
    B, Hq, Hkv, Tq, Tk, D = 1, 4, 2, 40, 70, 16
    q, k, v, _ = _inputs(B, Hq, Hkv, Tq, Tk, D, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = tref.ref_flash_attention(tq, tk, tv, causal=causal, window=window,
                                      q_offset=q_offset, softcap=softcap, chunk=16,
                                      return_lse=True)
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     tq.double().reshape(B, Hkv, Hq // Hkv, Tq, D) * D ** -0.5, tk.double())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = q_offset + torch.arange(Tq)[:, None]
    kpos = torch.arange(Tk)[None, :]
    live = torch.ones(Tq, Tk, dtype=torch.bool)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), -1).reshape(B, Hq, Tq)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Tq)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    np.testing.assert_allclose(lse[fin].numpy(), want[fin].numpy(), rtol=0, atol=LSE_TOL)


# ------------------------------------------------------------- the slice
def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path): np.asarray(v)
            for path, v in flat}


def _loss_and_grads_match(arch, jcfg, cfg, jbatch, tbatch):
    """The port's loss and every parameter gradient against the
    reference's ``jax.value_and_grad`` from the same parameters; returns
    the port's gradients by path."""
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(lambda r: jmodel.init(r)[0])(jax.random.PRNGKey(1))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, jbatch)
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    loss, _ = build_model(cfg).loss_fn(params, tbatch)
    leaves = flatten_with_paths(params)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=LOSS_ATOL)
    want = _paths(jgrads)
    got = {k: g.numpy() for (k, _), g in zip(leaves, grads)}
    assert set(got) == set(want), arch
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=LOSS_ATOL, err_msg=f"{arch} {k}")
    return got


def _count_attention(monkeypatch):
    """Record the kv length of every ``ops.flash_attention`` call that
    autograd records."""
    calls = []
    real = ops.flash_attention

    def counted(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if out.grad_fn is not None:
            calls.append((type(out.grad_fn).__name__, k.shape[2]))
        return out

    monkeypatch.setattr(ops, "flash_attention", counted)
    return calls


def test_danube_step_past_4096_matches_jax(monkeypatch):
    """Reduced h2o-danube3-4b (2 layers, 4 heads over 2 kv heads, window
    700) at 1 x 4100 tokens: both layers' attention is blockwise."""
    arch = "h2o-danube-3-4b"
    jcfg, cfg = jget_config(arch).reduced(window=700), get_config(arch).reduced(window=700)
    assert cfg.n_layers == 2 and cfg.n_kv_heads < cfg.n_heads
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (1, LONG_T + 1)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:].copy()
    calls = _count_attention(monkeypatch)
    _loss_and_grads_match(arch, jcfg, cfg,
                          {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                          {"tokens": torch.from_numpy(tokens).long(),
                           "labels": torch.from_numpy(labels).long()})
    assert calls == [("_FlashAttentionBackward", LONG_T)] * cfg.n_layers


def test_recurrentgemma_step_past_4096_matches_jax(monkeypatch):
    """Reduced recurrentgemma-2b (rglru, rglru, local, rglru; 4 heads over
    one kv head, window 8) at 1 x 4100 tokens: the local layer's attention
    is blockwise, the RG-LRUs' scans are the custom op's."""
    arch = "recurrentgemma-2b"
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    assert cfg.block_pattern[:3] == ("rglru", "rglru", "local") and cfg.n_kv_heads == 1
    rng = np.random.default_rng(23)
    toks = rng.integers(0, cfg.vocab_size, (1, LONG_T + 1)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:].copy()
    calls = _count_attention(monkeypatch)
    _loss_and_grads_match(arch, jcfg, cfg,
                          {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                          {"tokens": torch.from_numpy(tokens).long(),
                           "labels": torch.from_numpy(labels).long()})
    assert calls == [("_FlashAttentionBackward", LONG_T)]


def test_olmo_step_past_4096_matches_jax(monkeypatch):
    """Reduced olmo-1b (2 layers, 4 heads over 4 kv heads, full causal
    attention, no window) at 1 x 4100 tokens: both layers' attention is
    blockwise under the plain causal mask."""
    arch = "olmo-1b"
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    assert cfg.n_layers == 2 and cfg.window is None and cfg.n_kv_heads == cfg.n_heads
    rng = np.random.default_rng(33)
    toks = rng.integers(0, cfg.vocab_size, (1, LONG_T + 1)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:].copy()
    calls = _count_attention(monkeypatch)
    _loss_and_grads_match(arch, jcfg, cfg,
                          {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                          {"tokens": torch.from_numpy(tokens).long(),
                           "labels": torch.from_numpy(labels).long()})
    assert calls == [("_FlashAttentionBackward", LONG_T)] * cfg.n_layers


def test_seamless_step_past_4096_frames_matches_jax(monkeypatch):
    """Reduced seamless-m4t-large-v2 (2 + 2 layers) over 4100 frames and
    12 tokens: the encoder's self-attention and every cross-attention are
    blockwise, the decoder's self-attention dense."""
    arch = "seamless-m4t-large-v2"
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    rng = np.random.default_rng(13)
    frames = rng.standard_normal((1, LONG_T, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    labels[:, :3] = -1
    calls = _count_attention(monkeypatch)
    _loss_and_grads_match(
        arch, jcfg, cfg,
        {"enc_embeds": jnp.asarray(frames), "tokens": jnp.asarray(tokens),
         "labels": jnp.asarray(labels)},
        {"enc_embeds": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens).long(),
         "labels": torch.from_numpy(labels).long()})
    assert calls == [("_FlashAttentionBackward", LONG_T)] * (cfg.n_enc_layers + cfg.n_layers)


# ------------------------------------------------------------- the scan
@pytest.mark.parametrize("B,T,D", [(2, 64, 32), (3, 100, 17), (1, 1, 8)])
def test_linear_scan_gradient_matches_jax(B, T, D):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 0.999, (B, T, D)).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = rng.standard_normal((B, T, D)).astype(np.float32)
    want = jax.grad(lambda a, x: jnp.sum(jops.linear_scan(a, x) * w), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(x))
    ta, tx = torch.from_numpy(a).requires_grad_(), torch.from_numpy(x).requires_grad_()
    h = ops.linear_scan(ta, tx)
    assert "repro_torch_linear_scan" in type(h.grad_fn).__name__
    got = torch.autograd.grad((h * torch.from_numpy(w)).sum(), (ta, tx))
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), rtol=SCAN_TOL, atol=SCAN_TOL)


def test_recurrentgemma_step_gradients_match_jax(monkeypatch):
    """Reduced recurrentgemma-2b (rglru, rglru, local, rglru) at 2 x 24:
    every scan is recorded by the custom op (the gradient that the card
    runs as the reversed CUDA scan), and the loss and every gradient, the
    RG-LRU's leaves nonzero, agree with the reference."""
    arch = "recurrentgemma-2b"
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:].copy()
    grad_fns = []
    real = ops.linear_scan

    def recorded(a, x):
        h = real(a, x)
        grad_fns.append(type(h.grad_fn).__name__)
        return h

    monkeypatch.setattr(ops, "linear_scan", recorded)
    got = _loss_and_grads_match(arch, jcfg, cfg,
                                {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                                {"tokens": torch.from_numpy(tokens).long(),
                                 "labels": torch.from_numpy(labels).long()})
    n_rglru = sum(1 for i in range(cfg.n_layers)
                  if cfg.block_pattern[i % len(cfg.block_pattern)] == "rglru")
    assert len(grad_fns) == n_rglru == 3
    assert all("repro_torch_linear_scan" in n for n in grad_fns), grad_fns
    rglru = [k for k in got if k.split("/")[-1] in ("wx", "conv", "w_a", "w_i", "lam")]
    assert len(rglru) == 5 * n_rglru
    for k in rglru:
        assert np.isfinite(got[k]).all() and np.abs(got[k]).max() > 0, k


# ------------------------------------------------------------- the dry run
def test_dry_run_traces_a_train_step_past_4096():
    """A reduced danube train step over 1 x 4100 tokens on fake tensors
    (``launch.specs.build_cell`` with no mesh, as the (1, 1) record): it
    traces, and ``hlo.StepTrace`` counts each layer's attention forward at
    4 B Hq D and backward at 8 B Hq D FLOPs a live pair."""
    cfg = get_config("h2o-danube-3-4b").reduced(window=700)
    cell = ShapeCell("train_4100", "train", LONG_T, 1)
    prog = build_cell(cfg, cell, None, remat_policy="none", accum=1, device="cpu")
    with prog.fake_mode:
        args = prog.placed_args()
        trace = H.StepTrace()
        with trace:
            state, metrics = prog.fn(*args)
        assert tuple(metrics["loss"].shape) == ()
    pairs = ops.live_pairs(LONG_T, LONG_T, True, cfg.window, 0)
    per = cfg.n_heads * cfg.head_dim * pairs
    flops = H.cost_analysis_dict(trace)
    assert flops["flops repro_torch.flash_attention"] == cfg.n_layers * 4 * per
    assert flops["flops repro_torch.flash_attention_backward"] == cfg.n_layers * 8 * per


# ------------------------------------------------------------- the wrapper
@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything asks for the CUDA library."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_bwd as tfab

    def refuse(name):
        raise AssertionError(f"CUDA build of {name!r} requested")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(tfab, "_fn", None)
    return tfab


@pytest.mark.parametrize("case", ["cpu_tensor", "meta_device", "half", "bfloat16",
                                  "mixed_dtype", "o_shape", "lse_shape", "lse_dtype",
                                  "do_stride", "head_dim"])
def test_backward_wrapper_rejects_bad_inputs_before_building(case, no_build):
    q, k, v = torch.rand(1, 4, 8, 16), torch.rand(1, 2, 8, 16), torch.rand(1, 2, 8, 16)
    o, do, lse = torch.rand(1, 4, 8, 16), torch.rand(1, 4, 8, 16), torch.rand(1, 4, 8)
    if case == "meta_device":
        q, k, v, o, do, lse = (t.to("meta") for t in (q, k, v, o, do, lse))
    elif case == "half":
        q, k, v, o, do = (t.half() for t in (q, k, v, o, do))
    elif case == "bfloat16":   # the tensor-core backward's inputs
        q, k, v, o, do = (t.to(torch.bfloat16) for t in (q, k, v, o, do))
    elif case == "mixed_dtype":
        do = do.to(torch.bfloat16)
    elif case == "o_shape":
        o = o[:, :, :7]
    elif case == "lse_shape":
        lse = lse[:, :2]
    elif case == "lse_dtype":
        lse = lse.double()
    elif case == "do_stride":
        do = torch.rand(1, 4, 16, 8).transpose(2, 3)
    elif case == "head_dim":
        q, k, v, o, do = (torch.rand(*t.shape[:3], 264) for t in (q, k, v, o, do))
    before = no_build.launches
    with pytest.raises((ValueError, TypeError)):
        no_build.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    assert no_build.launches == before


@pytest.fixture
def no_build_sm90(monkeypatch):
    """Fail the test if anything asks for the CUDA library (tensor-core
    backward)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_bwd_sm90 as tfab90

    def refuse(name):
        raise AssertionError(f"CUDA build of {name!r} requested")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(tfab90, "_fn", None)
    return tfab90


@pytest.mark.parametrize("case", ["cpu_tensor", "meta_device", "float32", "mixed_dtype",
                                  "o_shape", "do_shape", "lse_shape", "lse_dtype",
                                  "head_dim_not_8", "head_dim_over_256", "kv_stride"])
def test_sm90_backward_wrapper_rejects_bad_inputs_before_building(case, no_build_sm90):
    """The bf16 tensor-core backward refuses what its kernel does not take,
    before any build and without counting a launch."""
    bf = torch.bfloat16
    q, k, v = (torch.rand(1, 4, 8, 16, dtype=bf), torch.rand(1, 2, 8, 16, dtype=bf),
               torch.rand(1, 2, 8, 16, dtype=bf))
    o, do, lse = torch.rand(1, 4, 8, 16, dtype=bf), torch.rand(1, 4, 8, 16, dtype=bf), \
        torch.rand(1, 4, 8)
    if case == "meta_device":
        q, k, v, o, do, lse = (t.to("meta") for t in (q, k, v, o, do, lse))
    elif case == "float32":
        q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    elif case == "mixed_dtype":
        do = do.float()
    elif case == "o_shape":
        o = o[:, :, :7]
    elif case == "do_shape":
        do = do[:, :3]
    elif case == "lse_shape":
        lse = lse[:, :2]
    elif case == "lse_dtype":
        lse = lse.double()
    elif case == "head_dim_not_8":
        q, k, v, o, do = (torch.rand(*t.shape[:3], 12, dtype=bf) for t in (q, k, v, o, do))
    elif case == "head_dim_over_256":
        q, k, v, o, do = (torch.rand(*t.shape[:3], 264, dtype=bf) for t in (q, k, v, o, do))
    elif case == "kv_stride":
        # a (B, Tk, Hkv, 20) projection cut to 16 columns: row stride 20 elements
        k, v = (torch.rand(1, 8, 2, 20, dtype=bf)[..., :16].transpose(1, 2) for _ in range(2))
    before = no_build_sm90.launches
    with pytest.raises((ValueError, TypeError)):
        no_build_sm90.flash_attention_bwd_sm90_cuda(q, k, v, o, lse, do)
    assert no_build_sm90.launches == before


# --------------------------------------- the tensor-core backward's blocks
# up to 64 (seamless's): two consumer warpgroups, the dK/dV pass's alone (256
# threads), the dQ pass's beside a producer warp (288)
_D64 = (128, 1, 256, 128, 288, 64, 64, 64)
# 65-128 (danube's 120 reads as 128): two consumer warpgroups, the dQ pass's
# beside a producer warpgroup
_D128 = (128, 1, 256, 128, 384, 64, 64, 64)
# 136-256 (recurrentgemma's 256): two consumer warpgroups over one 64-row
# tile, each holding half of the gradient's columns
_WIDE = (64, 1, 256, 64, 256, 64, 64, 64)


@pytest.mark.parametrize("shape,blocks,stats", [
    ((2, 16, 8192, 64), _D64, (2, 2, 16, 8192)),       # seamless's encoder
    ((2, 16, 2048, 64), _D64, (2, 2, 16, 2048)),       # its cross-attention's queries
    ((1, 8, 200, 32), _D64, (2, 1, 8, 256)),
    ((1, 8, 1, 8), _D64, (2, 1, 8, 64)),
    ((1, 32, 8192, 120), _D128, (2, 1, 32, 8192)),     # danube's
    ((1, 4, 200, 72), _D128, (2, 1, 4, 256)),
    ((2, 8, 130, 96), _D128, (2, 2, 8, 192)),
    ((1, 8, 1, 120), _D128, (2, 1, 8, 64)),
    ((1, 4, 333, 128), _D128, (2, 1, 4, 384)),
    ((2, 16, 8192, 128), _D128, (2, 2, 16, 8192)),     # olmo-1b's training step
    ((1, 4, 100, 136), _WIDE, (2, 1, 4, 128)),
    ((2, 8, 130, 256), _WIDE, (2, 2, 8, 192)),
    ((1, 10, 8192, 256), _WIDE, (2, 1, 10, 8192)),     # recurrentgemma's training step
])
def test_backward_blocks_follow_the_kernels_configurations(shape, blocks, stats):
    """The wrapper's plan of the bf16 backward's blocks (``chip_smoke.py``
    holds ``block_config`` to the compiled kernel's own report on the card):
    keys and rows a block, threads, tile widths, and the scratch it
    allocates for q of ``shape`` (B, Hq, Tq, D)."""
    from repro_torch.kernels import flash_attention_bwd_sm90 as tfab90
    B, Hq, Tq, D = shape
    assert tuple(tfab90.block_config(D)) == blocks
    assert tfab90.stats_shape(B, Hq, Tq, D) == stats
    assert tfab90.converts_to_fp16(D) == (blocks != _WIDE)   # the passes up to 128


@pytest.mark.parametrize("D", [0, 12, 68, 124, 132, 264])
def test_backward_blocks_refuse_widths_the_kernel_does_not_take(D):
    from repro_torch.kernels import flash_attention_bwd_sm90 as tfab90
    with pytest.raises(ValueError):
        tfab90.block_config(D)


# ------------------------------------------- the float32 backward's blocks
@pytest.mark.parametrize("D,blocks", [
    (1, (64, 128, 64, 128, 64, 256)), (8, (64, 128, 64, 128, 64, 256)),
    (33, (64, 128, 64, 128, 64, 256)),
    (64, (64, 128, 64, 128, 64, 256)),                 # seamless's
    (65, (128, 64, 64, 64, 64, 256)), (120, (128, 64, 64, 64, 64, 256)),   # danube's 120
    (128, (128, 64, 64, 64, 64, 256)), (129, (256, 32, 32, 32, 32, 256)),
    (256, (256, 32, 32, 32, 32, 256)),
])
def test_float32_backward_blocks_follow_the_kernels_configurations(D, blocks):
    """The wrapper's plan of the float32 backward's blocks (``chip_smoke.py``
    holds ``block_config`` to the compiled kernel's own report on the card):
    columns held, a dK/dV block's keys and its tiles' rows, a dQ block's rows
    and its tiles' keys, threads."""
    from repro_torch.kernels import flash_attention_bwd as tfab
    assert tuple(tfab.block_config(D)) == blocks


@pytest.mark.parametrize("D", [0, 257])
def test_float32_backward_blocks_refuse_widths_the_kernel_does_not_take(D):
    from repro_torch.kernels import flash_attention_bwd as tfab
    with pytest.raises(ValueError):
        tfab.block_config(D)


# -------------------- the fp16 operands of the bf16 backward up to 128
def _bf16_values(top):
    """Every finite bf16 value of magnitude ``top`` (a bf16 value) or less,
    both signs, as a bf16 tensor."""
    bits = torch.arange(0, 0x8000, dtype=torch.int32)
    x = (bits << 16).view(torch.float32).to(torch.bfloat16)   # exact: the low bits are 0
    x = x[torch.isfinite(x) & (x.float() <= float(top))]
    return torch.cat([x, -x])


@pytest.mark.parametrize("top", [1e-8, 1.0, 3e38])
def test_fp16_scale_converts_near_the_max_exactly_and_never_overflows(top):
    """The kernel's conversion of a bf16 tensor to fp16 (``fp16_copy``: times
    2^e, ``fp16_exponent`` of its largest magnitude): back in float32 every
    value within 2^-30 of the largest is exact, and no value overflows fp16
    (at largest magnitudes 1e-8, 1, and 3e38, far above fp16's 65504)."""
    from repro_torch.kernels import flash_attention_bwd_sm90 as tfab90
    m = torch.tensor(top, dtype=torch.bfloat16)
    x = _bf16_values(m)
    h, e = tfab90.fp16_copy(x)
    assert h.dtype == torch.float16 and bool(torch.isfinite(h).all())
    assert float(h.float().abs().max()) <= 65280.0            # fp16's largest is 65504
    assert int(e) == int(tfab90.fp16_exponent(m)) == 15 - int(np.floor(np.log2(float(m))))
    back = h.float() * torch.exp2(-e.float())
    near = x.float().abs() >= float(m) * 2.0 ** -30
    assert int(near.sum()) > 60 * 128                         # 30 binades, 128 values each
    assert torch.equal(back[near], x.float()[near])


def test_fp16_exponent_stays_in_range():
    """Zero and magnitudes below 2^-112 take 2^127 (the largest the kernel
    multiplies by); the rest 15 - floor(log2 max)."""
    from repro_torch.kernels import flash_attention_bwd_sm90 as tfab90
    m = torch.tensor([0.0, 2.0 ** -120, 2.0 ** -112, 2.0 ** -100, 1.5, 65504.0, 3e38])
    assert tfab90.fp16_exponent(m).tolist() == [127, 127, 127, 115, 15, 0, -112]


def _emulated_fp16_backward(q, k, v, o, lse, do, causal=True, window=None, q_offset=0,
                            softcap=None):
    """The arithmetic of ``csrc/flash_attention_bwd_sm90.cu``'s passes at
    head widths up to 128, in float32 on the CPU: S and dP from the scaled fp16
    copies (exact products, float32 sums), P' = P 2^15 from the stats
    launch's lse less 15 (log2 units), dS' = P' (dP 2^-40 - delta 2^(ev + ed
    - 40)), P' and dS' rounded once to fp16, the three gradients' sums
    scaled back; bf16 gradients."""
    from repro_torch.kernels import flash_attention_bwd_sm90 as tfab90
    B, Hq, Tq, D = q.shape
    Hkv, Tk, G = k.shape[1], k.shape[2], Hq // k.shape[1]
    (q16, eq), (k16, ek), (v16, ev), (do16, ed) = (tfab90.fp16_copy(t) for t in (q, k, v, do))
    eq, ek, ev, ed = (int(e) for e in (eq, ek, ev, ed))
    scale, log2e = D ** -0.5, 1.4426950408889634
    qf = q16.float().reshape(B, Hkv, G, Tq, D)
    dof = do16.float().reshape(B, Hkv, G, Tq, D)
    kf, vf = k16.float()[:, :, None], v16.float()[:, :, None]
    s = qf @ kf.transpose(-1, -2)                                  # (B, Hkv, G, Tq, Tk)
    lse2 = (lse.float() * log2e - 15).reshape(B, Hkv, G, Tq, 1)
    lse2 = torch.where(torch.isinf(lse2), torch.inf, lse2)         # dead rows: P = 0
    if softcap is None:
        p = torch.exp2(s * (scale * log2e * 2.0 ** -(eq + ek)) - lse2)
    else:
        t = torch.tanh(s * (scale / softcap * 2.0 ** -(eq + ek)))
        p = torch.exp2(t * (softcap * log2e) - lse2)
    qpos = q_offset + torch.arange(Tq)[:, None]
    kpos = torch.arange(Tk)[None, :]
    live = torch.ones(Tq, Tk, dtype=torch.bool)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    p = torch.where(live, p, 0.0)
    delta = (do.float() * o.float()).sum(-1).reshape(B, Hkv, G, Tq, 1) * 2.0 ** (ev + ed - 40)
    ds = p * (dof @ vf.transpose(-1, -2) * 2.0 ** -40 - delta)
    if softcap is not None:
        ds = ds * (1 - t * t)
    p16, ds16 = p.half().float(), ds.half().float()
    e_ds = ev + ed + 15 - 40                                       # dS' = dS 2^e_ds
    dq = (ds16 @ kf) * (scale * 2.0 ** -(e_ds + ek))
    dk = (ds16.transpose(-1, -2) @ qf).sum(2) * (scale * 2.0 ** -(e_ds + eq))
    dv = (p16.transpose(-1, -2) @ dof).sum(2) * 2.0 ** -(15 + ed)
    return (dq.reshape(B, Hq, Tq, D).bfloat16(), dk.bfloat16(), dv.bfloat16())


# chip_smoke.py's FLASH_BWD_D64_CASES (B, Hq, Hkv, Tq, Tk, D, mask)
_D64_CASES = [
    (1, 4, 4, 200, 300, 64, dict(causal=False)),
    (1, 8, 2, 200, 300, 64, dict(causal=False)),
    (1, 4, 2, 200, 300, 64, dict(causal=True, q_offset=100)),
    (1, 4, 2, 200, 300, 64, dict(causal=True, q_offset=-40)),
    (1, 4, 2, 300, 300, 64, dict(causal=True, window=24)),
    (1, 4, 2, 200, 300, 64, dict(causal=True, q_offset=100, softcap=20.0)),
    (1, 8, 2, 1, 1000, 64, dict(causal=False)),
    (1, 4, 2, 200, 300, 32, dict(causal=True, q_offset=100)),
    (1, 8, 2, 1100, 1100, 64, dict(causal=True)),
    (1, 4, 4, 700, 1300, 48, dict(causal=False)),
    (1, 4, 4, 64, 300, 64, dict(causal=False)),
]
# chip_smoke.py's FLASH_D128_CASES at head widths 65-128 (B, Hq, Hkv, Tq, Tk,
# D, mask)
_D128_CASES = [
    (1, 4, 4, 200, 300, 72, dict(causal=True, q_offset=100)),
    (1, 8, 2, 300, 300, 96, dict(causal=True, window=24)),
    (1, 8, 2, 200, 300, 120, dict(causal=True, q_offset=100, softcap=20.0)),
    (2, 4, 4, 130, 333, 128, dict(causal=False)),
    (1, 8, 2, 200, 300, 120, dict(causal=True, q_offset=-40)),
    (1, 8, 2, 321, 1500, 128, dict(causal=True, window=100, q_offset=1179, softcap=30.0)),
    (1, 8, 2, 1, 1000, 96, dict(causal=False)),
    (1, 4, 4, 1100, 1100, 128, dict(causal=True)),
    (1, 4, 4, 128, 700, 128, dict(causal=False)),
    (1, 4, 4, 256, 300, 96, dict(causal=False)),
    (1, 8, 2, 900, 900, 120, dict(causal=True)),
]
# input scales (q, k, v, do): do at O(1) and at a mean loss's gradient size;
# q above fp16's largest value with k below its normal range, scores unchanged
# (and the other way round); v below fp16's normal range
_FP16_SCALES = {"do 1": (1, 1, 1, 1), "do 2^-16": (1, 1, 1, 2.0 ** -16),
                "q 1e5 k 1e-5": (1e5, 1e-5, 1, 1), "q 1e-5 k 1e5": (1e-5, 1e5, 1, 1),
                "v 1e-6": (1, 1, 1e-6, 1)}


@pytest.mark.parametrize("scales", list(_FP16_SCALES))
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,kw", _D128_CASES + _D64_CASES)
def test_fp16_backward_emulation_within_the_chip_limit(B, Hq, Hkv, Tq, Tk, D, kw, scales):
    """The kernel's arithmetic up to 128 (fp16 operands, P and dS rounded
    once) against the plain backward, per gradient within 2^-7 |want| +
    1e-3 max|want| (``chip_smoke.py``'s FLASH_BWD_BF16_REL and _FLOOR, the
    limit the card holds the kernel to); rows that see no key get dq 0."""
    rng = np.random.default_rng(Tq * 7 + Tk + D)
    bf = torch.bfloat16
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * c).to(bf)
                   for shape, c in zip(((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D),
                                        (B, Hq, Tq, D)), _FP16_SCALES[scales]))
    o, lse = tref.ref_flash_attention(q, k, v, return_lse=True, **kw)
    got = _emulated_fp16_backward(q, k, v, o, lse, do, **kw)
    want = tref.ref_flash_attention_backward(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff, wf = (g.float() - w.float()).abs(), w.float().abs()
        share = float((diff / (2.0 ** -7 * wf + 1e-3 * wf.max())).max())
        assert share <= 1.0, f"{name}: {share:.3f} of the limit"
    dead = torch.isinf(lse)
    assert not got[0][dead].any()
