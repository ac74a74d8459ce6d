"""The port's training path vs the JAX reference, and within torch.

Loss, gradients, the AdamW update and a 16-step loss curve are held to
the JAX reference run with no mesh and no logical rules
(``model.loss_fn`` and ``adamw_update`` under a plain ``jax.jit``), from
the same parameters (handed over through ``convert``) and the same
batches (made with numpy).  Gradient accumulation and the kill/restart
resume are checked within torch.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.distributed.axes import clear_logical_rules
from repro.models import build_model as jbuild_model
from repro.train import optimizer as jopt
from repro_torch.checkpoint import BlobCheckpointer
from repro_torch.checkpoint.blobckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import BlobSeerService
from repro_torch.data import ByteTokenizer, CorpusWriter, ShardedReader
from repro_torch.models import build_model
from repro_torch.models.param_util import tree_leaves, tree_map
from repro_torch.train import optimizer as topt
from repro_torch.train.step import TrainStepBuilder

torch.set_num_threads(2)

VOCAB = ByteTokenizer().vocab_size + 1
STEPS = 16
CKPT_AT = 8
LOSS_CURVE_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


def _cfgs():
    return (jget_config("olmo-1b").reduced(vocab_size=VOCAB),
            get_config("olmo-1b").reduced(vocab_size=VOCAB))


_JAX = {}


def _jax_params(seed=0):
    if seed not in _JAX:
        jcfg, _ = _cfgs()
        jmodel = jbuild_model(jcfg)
        _JAX[seed] = jmodel, jax.jit(lambda r: jmodel.init(r)[0])(jax.random.PRNGKey(seed))
    return _JAX[seed]


def _batch(B, T, seed, masked=0):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (B, T + 1)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:].copy()
    labels[:, :masked] = -1
    return tokens, labels


def _jax_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path): np.asarray(v)
            for path, v in flat}


def test_lm_loss_and_grads_match_jax():
    jmodel, jparams = _jax_params()
    _, cfg = _cfgs()
    tokens, labels = _batch(3, 16, seed=1, masked=2)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, jbatch)

    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    loss, m = build_model(cfg).loss_fn(
        params, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, [p for _, p in flatten_with_paths(params)])

    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5)
    for k in ("ce", "zloss", "aux", "tokens"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), atol=1e-5)
    want = _jax_paths(jgrads)
    got = {k: g.numpy() for (k, _), g in zip(flatten_with_paths(params), grads)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_adamw_update_matches_jax():
    cfg = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0,
               warmup_steps=2, total_steps=10, min_lr_frac=0.1)
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": [rng.standard_normal(13).astype(np.float32)]}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * s).astype(np.float32),
                          params) for s in (0.1, 3.0, 0.01)]   # the second is clipped
    jcfg = jopt.AdamWConfig(**cfg)
    jupdate = jax.jit(lambda g, o, p: jopt.adamw_update(jcfg, g, o, p))
    jp = jax.tree.map(jnp.asarray, params)
    jo = jopt.adamw_init(jp)
    tp = tree_map(torch.from_numpy, jax.tree.map(np.copy, params))
    to = topt.adamw_init(tp)
    for g in grads:
        jp, jo, jstats = jupdate(jax.tree.map(jnp.asarray, g), jo, jp)
        tp, to, tstats = topt.adamw_update(topt.AdamWConfig(**cfg),
                                           tree_map(torch.from_numpy, g), to, tp)
        np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]), rtol=1e-6)
        for jt, tt in [(jp, tp), (jo["mu"], to["mu"]), (jo["nu"], to["nu"]),
                       (jo["master"], to["master"])]:
            for a, b in zip(jax.tree.leaves(jt), tree_leaves(tt)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    assert int(to["count"]) == int(jo["count"]) == 3


def test_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    steps = np.arange(0, 45, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: jopt.schedule(jopt.AdamWConfig(**cfg), s))(steps))
    got = topt.schedule(topt.AdamWConfig(**cfg), torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_grad_accumulation_matches_joined_batch():
    """accum=2 over a 2x batch == accum=1 on the same batch (same grads)."""
    _, cfg = _cfgs()
    tokens, labels = _batch(8, 16, seed=4)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100, clip_norm=None)
    out = {}
    for accum in (1, 2):
        b = TrainStepBuilder(build_model(cfg), opt=opt, accum=accum)
        state = b.init_state(torch.Generator().manual_seed(0))
        state, m = b.train_step_fn()(state, batch)
        out[accum] = state, float(m["loss"])
    (s1, l1), (s2, l2) = out[1], out[2]
    np.testing.assert_allclose(l2, l1, atol=1e-6)
    # after one step mu = (1 - b1) * grad: the accumulated gradient itself
    for a, b in zip(tree_leaves(s1["opt"]["mu"]), tree_leaves(s2["opt"]["mu"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-4, atol=1e-6)


def test_loss_curve_tracks_jax():
    """16 steps from the same converted state on the same batches."""
    jmodel, jparams = _jax_params()
    _, cfg = _cfgs()
    opt = dict(lr=1e-3, warmup_steps=4, total_steps=STEPS)
    jcfg = jopt.AdamWConfig(**opt)

    @jax.jit
    def jstep(state, batch):
        (loss, _), grads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
            state["params"], batch)
        params, o, _ = jopt.adamw_update(jcfg, grads, state["opt"], state["params"])
        return {"params": params, "opt": o, "step": state["step"] + 1}, loss

    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    step = TrainStepBuilder(build_model(cfg), opt=topt.AdamWConfig(**opt)).train_step_fn()
    jl, tl = [], []
    for s in range(STEPS):
        tokens, labels = _batch(4, 32, seed=100 + s)
        jstate, loss = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                      "labels": jnp.asarray(labels)})
        jl.append(float(loss))
        state, m = step(state, {"tokens": torch.from_numpy(tokens),
                                "labels": torch.from_numpy(labels)})
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_CURVE_RTOL)
    assert tl[-1] < tl[0]


# ------------------------------------------------------------ kill / restart
def _setup(svc):
    c = svc.client("trainer")
    tok = ByteTokenizer()
    w = CorpusWriter(c, psize=4096)
    rng = np.random.default_rng(0)
    for i in range(60):
        n = int(rng.integers(40, 120))
        w.append_tokens(tok.encode(f"doc {i}: " + " ".join(
            f"w{int(rng.integers(0, 40))}" for _ in range(n))))
    _, cfg = _cfgs()
    builder = TrainStepBuilder(
        build_model(cfg), opt=topt.AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=STEPS))
    return c, w, builder


def _run(ckpt, state, step, reader, lo, hi, losses):
    for s in range(lo, hi):
        tokens, labels = reader.next_batch()
        state, m = step(state, {"tokens": torch.from_numpy(tokens),
                                "labels": torch.from_numpy(labels)})
        losses.append(float(m["loss"]))
        if s + 1 == CKPT_AT:
            ckpt.save(state, step=s + 1, extra={"reader": reader.state_dict()})
    return state


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def test_kill_restart_resumes_bit_identically(deterministic):
    # ---- uninterrupted run ----
    c, w, builder = _setup(BlobSeerService(n_providers=4, n_meta_shards=2))
    ckpt = BlobCheckpointer(c, psize=4096, header_pages=32)
    reader = ShardedReader(c, w.blob_id, batch=4, seq_len=32)
    ref_losses = []
    ref_state = _run(ckpt, builder.init_state(torch.Generator().manual_seed(0)),
                     builder.train_step_fn(), reader, 0, STEPS, ref_losses)

    # ---- interrupted run: train to CKPT_AT, crash, resume ----
    c2, w2, builder2 = _setup(BlobSeerService(n_providers=4, n_meta_shards=2))
    ckpt2 = BlobCheckpointer(c2, psize=4096, header_pages=32)
    reader2 = ShardedReader(c2, w2.blob_id, batch=4, seq_len=32)
    losses = []
    state = _run(ckpt2, builder2.init_state(torch.Generator().manual_seed(0)),
                 builder2.train_step_fn(), reader2, 0, CKPT_AT, losses)
    del state, reader2  # crash: in-memory training state lost

    restored, mani = ckpt2.restore(builder2.abstract_state(), with_manifest=True,
                                   device="cpu")
    assert mani["step"] == CKPT_AT and int(restored["step"]) == CKPT_AT
    reader3 = ShardedReader(c2, w2.blob_id, batch=4, seq_len=32,
                            state=mani["extra"]["reader"])
    state = _run(ckpt2, restored, builder2.train_step_fn(), reader3, CKPT_AT, STEPS, losses)

    assert losses == ref_losses
    for (k, a), (_, b) in zip(flatten_with_paths(ref_state), flatten_with_paths(state)):
        assert torch.equal(a, b), k
