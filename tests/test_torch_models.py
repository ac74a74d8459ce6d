"""Port vs JAX reference: RG-LRU block, full forward, prefill and decode,
rematerialisation, the VLM frontend splice and the parameter trees.

Parameters come from the JAX ``model.init`` and reach the port through
``params_from_jax``; token ids and activations are made with numpy from
a seed.  Reduced configs in float32: recurrentgemma-2b (4 layers: rglru,
rglru, local attention with window 8, rglru), olmo-1b as a second
case for the non-parametric LayerNorm, SwiGLU and full attention,
h2o-danube-3-4b for sliding-window attention on every layer (window 8),
RMSNorm and an untied ``lm_head``, xlstm-350m (9 layers: 7 mLSTM, an
sLSTM, an mLSTM), olmoe-1b-7b and granite-moe-1b-a400m (MoE FFNs, whose
aux loss the forward returns), and internvl2-76b with ``vision_embeds``.

Tolerance: atol 1e-4 on logits (and on block outputs and state).  The
port scans sequentially where the reference's CPU path runs an
associative scan, and its einsums sum in another order, so the two agree
to float32 rounding accumulated over a few layers, not bit for bit.
"""

import json
import os

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
ARCHS = ["recurrentgemma-2b", "olmo-1b", "h2o-danube-3-4b", "xlstm-350m", "olmoe-1b-7b",
         "granite-moe-1b-a400m"]
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
        h, aux = JLM.apply_stack_train(params, pr.jcfg, x, jnp.arange(T))
        return JLM._logits(params, pr.jcfg, h), aux

    want, want_aux = jfwd(pr.jparams, jx)
    tx = pr.params["embed"]["table"][torch.from_numpy(toks).long()]
    h, aux = TLM.apply_stack_train(pr.params, pr.cfg, tx, torch.arange(T))
    _close(TLM._logits(pr.params, pr.cfg, h), want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-6)
    assert (float(aux) > 0) == pr.cfg.moe


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


@pytest.mark.parametrize("what", ["mesh"])
def test_unported_paths_raise(what):
    """A mesh other than 1x1 without its launcher raises, naming the
    launcher (``test_launch_train_under_the_launcher`` runs it)."""
    from repro_torch.launch.train import main as train_main
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train_main(["--mesh", "2x1", "--device", "cpu", "--quiet"])


def test_launch_train_under_the_launcher(tmp_path):
    """``launch.train --mesh 2x1 --strategy tp_fsdp --device cpu`` trains
    under ``torch.distributed.run`` (two gloo ranks, checkpoints written
    by rank 0): its losses are the one-device run's within 1e-5."""
    import socket
    import subprocess
    import sys

    from repro_torch.launch.train import main as train_main

    args = ["--device", "cpu", "--steps", "6", "--ckpt-every", "3", "--seq", "32",
            "--batch", "4", "--quiet"]
    want = train_main(args)["losses"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "localhost", "--master-port", str(port),
         os.path.join(here, "torch_mesh_worker.py"), "train-main", str(tmp_path / "losses.json"),
         *args, "--mesh", "2x1", "--strategy", "tp_fsdp"],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    got = json.loads((tmp_path / "losses.json").read_text())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-1b-a400m", "xlstm-350m",
                                  "internvl2-76b", "seamless-m4t-large-v2"])
def test_params_from_jax_gives_the_port_init_tree(arch):
    """The JAX tree, converted, has the keys, shapes and dtypes of the
    port's own init, bf16 leaves and float32 ones (norms, the MoE router,
    the mLSTM gates) alike, the encoder-decoder's stacks too."""
    clear_logical_rules()
    jcfg = jget_config(arch).reduced(dtype="bfloat16")
    cfg = get_config(arch).reduced(dtype="bfloat16")
    jparams = jbuild_model(jcfg).abstract()[0]
    np_tree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jparams)
    got = params_from_jax(np_tree, cfg, device="cpu")
    want = build_model(cfg).init(torch.Generator().manual_seed(0))
    g, w = jax.tree_util.tree_flatten_with_path(got), jax.tree_util.tree_flatten_with_path(want)
    assert g[1] == w[1]
    for (path, a), (_, b) in zip(g[0], w[0]):
        assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype), path
    assert {str(a.dtype) for a in jax.tree.leaves(want)} == {"torch.bfloat16", "torch.float32"}


def _loss_batch(cfg, seed=13):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels[:, :3] = -1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    if cfg.frontend is not None:
        ve = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        jb["vision_embeds"], tb["vision_embeds"] = jnp.asarray(ve), torch.from_numpy(ve)
    return jb, tb


@pytest.mark.parametrize("arch", ["xlstm-350m", "granite-moe-1b-a400m"])
def test_remat_policies_agree(arch):
    """``lm_loss`` at "none", "full" and "dots": the same loss (rtol 1e-6)
    and gradients (rtol 2e-4, atol 1e-6; the reference's own bounds,
    tests/test_models.py::test_remat_policies_agree), and the loss of the
    JAX package within 1e-5."""
    pr = pair(arch)
    jb, tb = _loss_batch(pr.cfg)
    jloss, _ = jax.jit(pr.jmodel.loss_fn)(pr.jparams, jb)
    out = {}
    for policy in ("none", "full", "dots"):
        live = [t.detach().clone().requires_grad_() for t in jax.tree.leaves(pr.params)]
        params = jax.tree.unflatten(jax.tree.structure(pr.params), live)
        loss, _ = pr.model.loss_fn(params, tb, policy)
        out[policy] = float(loss.detach()), torch.autograd.grad(loss, live)
    np.testing.assert_allclose(out["none"][0], float(jloss), rtol=0, atol=1e-5)
    for policy in ("full", "dots"):
        np.testing.assert_allclose(out[policy][0], out["none"][0], rtol=1e-6)
        for a, b in zip(out[policy][1], out["none"][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)
    with pytest.raises(ValueError):
        pr.model.loss_fn(pr.params, tb, "some")


def test_vlm_splice_matches_jax():
    """internvl2-76b's stub frontend: ``vision_embeds`` replace the first
    ``n_frontend_tokens`` embeddings in the loss and the prefill."""
    pr = pair("internvl2-76b")
    jb, tb = _loss_batch(pr.cfg)
    jloss, jm = jax.jit(pr.jmodel.loss_fn)(pr.jparams, jb)
    loss, m = pr.model.loss_fn(pr.params, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(m["ce"].detach()), float(jm["ce"]), rtol=0, atol=ATOL)
    jb.pop("labels"), tb.pop("labels")
    jlg, _ = jax.jit(pr.jmodel.prefill)(pr.jparams, jb, pr.jmodel.init_cache(B, T + 4))
    with torch.inference_mode():
        lg, _ = pr.model.prefill(pr.params, tb, pr.model.init_cache(B, T + 4, device="cpu"))
        plain, _ = pr.model.prefill(pr.params, {"tokens": tb["tokens"]},
                                    pr.model.init_cache(B, T + 4, device="cpu"))
    _close(lg, jlg)
    assert float((lg - plain).abs().max()) > 10 * ATOL   # the splice reached the logits


def test_dots_policy_keeps_the_plain_products():
    """Backward recomputes every product of a pattern group at "full", and
    at "dots" all but the ones without batch dimensions (``mm``, and the
    batch-1 ``bmm`` that ``torch.einsum`` makes of them): here the
    attention projections and the router, 5 a layer."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
            return func(*args, **(kwargs or {}))

    pr = pair("granite-moe-1b-a400m")
    _, tb = _loss_batch(pr.cfg)
    counts = {}
    for policy in ("none", "full", "dots"):
        live = [t.detach().clone().requires_grad_() for t in jax.tree.leaves(pr.params)]
        loss, _ = pr.model.loss_fn(jax.tree.unflatten(jax.tree.structure(pr.params), live),
                                   tb, policy)
        with Products() as products:
            torch.autograd.grad(loss, live)
        counts[policy] = products.n
    per_layer = (counts["full"] - counts["none"]) // pr.cfg.n_layers
    assert counts["full"] - counts["dots"] == 5 * pr.cfg.n_layers, counts
    assert per_layer > 5, counts
