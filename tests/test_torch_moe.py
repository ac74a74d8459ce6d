"""Port vs JAX reference: the MoE layer, and the two MoE archs end to end.

Reduced olmoe-1b-7b and granite-moe-1b-a400m in float32 (4 experts,
top-2), with parameters from the JAX init handed over through
``params_from_jax`` and activations and tokens made with numpy from a
seed.  The layer is held to ``repro.models.moe.apply_moe`` at atol 1e-4
on its output and 1e-6 on the aux loss, with the chosen experts and the
kept (token, choice) pairs equal: at the default capacity, at a capacity
factor of 0.5 (choices are dropped), and regrouped (``moe_group=6`` over
18 tokens).  Then the loss and its gradients (1e-5), greedy generation
(tokens equal) and the training entry point.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.distributed.axes import clear_logical_rules
from repro.launch.serve import generate as jgenerate
from repro.models import build_model as jbuild_model
from repro.models import moe as JM
from repro.models.param_util import split_tree
from repro_torch.checkpoint import BlobCheckpointer
from repro_torch.checkpoint.blobckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import generate
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.models import moe as TM
from repro_torch.models.param_util import tree_map

torch.set_num_threads(2)

ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]
B, T = 2, 18
CASES = {"default": {}, "dropping": {"capacity_factor": 0.5}, "grouped": {"moe_group": 6}}


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


def _cfgs(arch, **over):
    return (dataclasses.replace(jget_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _jax_route(p, cfg, x):
    """The reference's routing steps (src/repro/models/moe.py:47-64): the
    chosen experts (B,T,K) and which (token, choice) pairs fit (B,T,K),
    which ``apply_moe`` computes but does not return."""
    Bx, Tx, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    capacity = max(1, int(cfg.capacity_factor * K * Tx / E))
    probs = jax.nn.softmax(jnp.einsum("btd,de->bte", x, p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.float32).transpose(0, 2, 1, 3).reshape(Bx, K * Tx, E)
    pos = ((jnp.cumsum(flat, axis=1) - flat) * flat).sum(-1)
    kept = (pos < capacity).reshape(Bx, K, Tx).transpose(0, 2, 1)
    return np.asarray(idx), np.asarray(kept)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, case):
    jcfg, cfg = _cfgs(arch, **CASES[case])
    jp = split_tree(JM.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32))[0]
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(lambda p, x: JM.apply_moe(p, jcfg, x))(jp, jnp.asarray(x))
    out, aux = TM.apply_moe(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)

    xg = x.reshape(-1, cfg.moe_group, cfg.d_model) if cfg.moe_group else x
    want_idx, want_kept = _jax_route(jp, jcfg, jnp.asarray(xg))
    _, idx, _, _, kept, _ = TM.route(tp, cfg, torch.from_numpy(xg))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    if case == "dropping":
        assert not want_kept.all()          # capacity 4 for 36 choices over 4 experts
    if case == "grouped":
        assert want_idx.shape == (B * T // 6, 6, cfg.top_k)


class Pair:
    """One reduced MoE arch in both packages, with shared parameters."""

    def __init__(self, arch):
        clear_logical_rules()
        self.jcfg, self.cfg = _cfgs(arch)
        self.jmodel = jbuild_model(self.jcfg)
        self.model = build_model(self.cfg)
        self.jparams = jax.jit(lambda r: self.jmodel.init(r)[0])(jax.random.PRNGKey(1))
        self.np_params = jax.tree.map(np.asarray, self.jparams)


_PAIRS = {}


def pair(arch) -> Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


def _jax_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path): np.asarray(v)
            for path, v in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    pr = pair(arch)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, pr.cfg.vocab_size, (3, 16)).astype(np.int32)
    labels = rng.integers(0, pr.cfg.vocab_size, (3, 16)).astype(np.int32)
    labels[:, :2] = -1
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(pr.jmodel.loss_fn, has_aux=True))(
        pr.jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})

    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_jax(pr.np_params, pr.cfg, device="cpu"))
    loss, m = pr.model.loss_fn(
        params, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, [p for _, p in flatten_with_paths(params)])

    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5)
    for k in ("ce", "zloss", "tokens"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), atol=1e-5)
    np.testing.assert_allclose(float(m["aux"].detach()), float(jm["aux"]), atol=1e-6)
    assert float(m["aux"].detach()) > 0.0
    want = _jax_paths(jgrads)
    got = {k: g.numpy() for (k, _), g in zip(flatten_with_paths(params), grads)}
    assert set(got) == set(want) and any("ffn/router" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    """Prefill, then single-token decode steps (capacity 1 per expert at
    T = 1, so routing at decode differs from teacher forcing; both
    packages decode the same way): the reference's tokens."""
    pr = pair(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, pr.cfg.vocab_size, 11).astype(np.int32) for _ in range(3)]
    kw = dict(max_new=10, max_len=11 + 10)
    want = jgenerate(pr.jmodel, pr.jparams, prompts, mesh=None, **kw)
    got = generate(pr.model, params_from_jax(pr.np_params, pr.cfg, device="cpu"), prompts,
                   device="cpu", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_train_main_granite_moe_on_cpu():
    """The training entry point on a (CLI-reduced) granite-moe: finite
    losses and two checkpoints in one lineage."""
    out = train_main(["--arch", "granite-moe-1b-a400m", "--device", "cpu", "--steps", "4",
                      "--ckpt-every", "2", "--seq", "16", "--batch", "2", "--d-model", "32",
                      "--layers", "2", "--heads", "4", "--d-ff", "32", "--corpus-docs", "20",
                      "--quiet"])
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    wi = out["state"]["params"]["groups"][0]["ffn"]["wi"]
    assert tuple(wi.shape) == (2, 4, 32, 32)
    ck = BlobCheckpointer(out["client"], out["ckpt_blob"], psize=16 * 1024, header_pages=16)
    assert [s for _, s in ck.steps()] == [2, 4]
