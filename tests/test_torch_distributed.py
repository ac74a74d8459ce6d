"""The port's distributed layer vs the JAX reference.

* Partitioning: ``get_rules`` and ``spec_for`` equal to the reference's
  for every strategy (with and without ``_uneven``/``_zero2``) on meshes
  (1, 1), (2, 4), (16, 16) and (2, 16, 16), given as stand-ins with
  ``axis_names`` and ``shape``, over every leaf of the parameter, cache,
  batch and memories trees of the ten configs at full width (abstract
  shapes, nothing allocated); ``Model.abstract()``'s axes tree equal to
  the reference's.
* The int8 gradient all-reduce at world 1, bit-equal to the reference's
  ``int8_allreduce_mean`` on the same uniform draws.
* Under a one-rank gloo group (a module fixture, destroyed at teardown):
  the train step of reduced olmo-1b for ``tp``, ``tp_fsdp``, ``tp_fsdp``
  with ``zero2`` and ``accum=2``, and ``dp_fsdp``, against the
  reference's ``TrainStepBuilder`` on a 1x1 mesh of Auto axes built
  here, and ``tp_serve_sm`` decode against the reference's.
* Two ranks, as two processes (``torch_mesh_worker.py``): ``tp_fsdp`` +
  ``zero2`` on mesh (2, 1), ``tp`` on (1, 2) and ``tp_serve_sm`` decode on
  (1, 2) with two kv heads and with one, against the reference's
  single-device numbers; the state rank 0 saved restores in the reference.

Tolerances are those of ``test_torch_train.py`` and ``test_decode_attn.py``:
loss and gradients 1e-5, AdamW moments 1e-6, parameters after a step
rtol 5e-4 (``tests/test_train.py:80``), decode logits rtol 2e-4 atol 2e-5.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, PartitionSpec as P

from repro.checkpoint import BlobCheckpointer as JBlobCheckpointer
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.core import BlobSeerService as JBlobSeerService
from repro.distributed import axes as JAX_AX
from repro.distributed import partitioning as JPT
from repro.distributed.axes import clear_logical_rules
from repro.distributed.collectives import int8_allreduce_mean as jint8_allreduce_mean
from repro.models import build_model as jbuild_model
from repro.train import optimizer as jopt
from repro.train.step import TrainStepBuilder as JTrainStepBuilder
from repro_torch.checkpoint.blobckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import axes as AX
from repro_torch.distributed import partitioning as PT
from repro_torch.distributed.collectives import (compressed_grad_mean,
                                                 int8_allreduce_mean_drawn)
from repro_torch.models import build_model
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.step import TrainStepBuilder

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_ATOL, GRAD_ATOL, MU_ATOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-6, 5e-4, 1e-6
DEC_RTOL, DEC_ATOL = 2e-4, 2e-5
ILL_CONDITIONED_MU = 1e-7
TWO_RANK_TIMEOUT = 300


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # the reference's TrainStepBuilder leaves logical-axis rules active,
    # which makes every later JAX ``constrain`` call raise
    clear_logical_rules()
    AX.clear_logical_rules()
    yield
    clear_logical_rules()
    AX.clear_logical_rules()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------- partitioning
class StandIn:
    """A mesh as ``spec_for`` reads it: axis names and their sizes."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
STRATEGIES = [base + suffix for base in JPT.RULESETS
              for suffix in ("", "_uneven", "_zero2", "_uneven_zero2")]
SPEC_BATCH, SPEC_LEN, SPEC_FRAMES = 32, 4096, 4096


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


_TREES = {}


def _trees(arch):
    """Abstract (value tree, axes tree) pairs of both packages for the
    parameters, cache, batches and memories of ``arch`` at full width."""
    if arch in _TREES:
        return _TREES[arch]
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    B, L = SPEC_BATCH, SPEC_LEN
    jcache = jax.eval_shape(lambda: jmodel.init_cache(B, L))
    tcache = model.init_cache(B, L, device="meta")
    sds = jax.ShapeDtypeStruct
    batch = {"tokens": sds((B, L), jnp.int32), "labels": sds((B, L), jnp.int32)}
    if cfg.frontend is not None:
        batch["vision_embeds"] = sds((B, cfg.n_frontend_tokens, cfg.d_model), jnp.float32)
    if cfg.arch_kind == "encdec":
        batch["enc_embeds"] = sds((B, SPEC_FRAMES, cfg.d_model), jnp.float32)
    tbatch = {k: torch.empty(v.shape, device="meta") for k, v in batch.items()}
    pairs = {
        "params": (jmodel.abstract(), model.abstract()),
        "cache": ((jcache, JPT.cache_axes_for(jcache)), (tcache, PT.cache_axes_for(tcache))),
        "batch": ((batch, JPT.batch_axes_for(batch)), (tbatch, PT.batch_axes_for(tbatch))),
    }
    tok = {"token": sds((B,), jnp.int32)}
    ttok = {"token": torch.empty((B,), device="meta")}
    pairs["token"] = ((tok, JPT.batch_axes_for(tok)), (ttok, PT.batch_axes_for(ttok)))
    if cfg.arch_kind == "encdec":
        shape = (cfg.n_layers, B, cfg.n_kv_heads, SPEC_FRAMES, cfg.head_dim)
        mem = (sds(shape, jnp.bfloat16),) * 2
        tmem = (torch.empty(shape, device="meta"),) * 2
        pairs["memories"] = ((mem, JPT.memories_axes_for(mem)),
                             (tmem, PT.memories_axes_for(tmem)))
    _TREES[arch] = pairs
    return pairs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_axes_equal_reference(arch):
    """``Model.abstract()`` allocates nothing, and its axes tree equals the
    reference's leaf for leaf, the stacked "layers" axes included; so do
    the cache, batch and memories axes."""
    from torch._subclasses.fake_tensor import FakeTensor

    for what, ((jtree, jaxes), (ttree, taxes)) in _trees(arch).items():
        jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
        assert sorted(tl, key=str) == sorted(jl, key=str), what
        for path, t in tl.items():
            assert tuple(t.shape) == tuple(jl[path].shape), (what, path)
            assert isinstance(t, FakeTensor) or t.device.type == "meta", (what, path)
            assert tuple(_at(taxes, path)) == tuple(_at(jaxes, path)), (what, path)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_spec_for_equals_reference(strategy):
    """``get_rules`` and ``spec_for`` (with its divisibility guard) equal
    the reference's for every leaf of every tree of the ten configs."""
    rules, jrules = PT.get_rules(strategy), JPT.get_rules(strategy)
    assert rules == jrules
    for shape, axes in MESHES:
        mesh = StandIn(shape, axes)
        for arch in ARCH_IDS:
            for what, ((jtree, jaxes), (ttree, taxes)) in _trees(arch).items():
                for path, leaf in _leaves(ttree):
                    names = tuple(_at(taxes, path))
                    want = JPT.spec_for(mesh, jrules, tuple(_at(jaxes, path)), leaf.shape)
                    got = PT.spec_for(mesh, rules, names, tuple(leaf.shape))
                    assert got == tuple(want), (shape, arch, what, path)


def test_logical_to_spec_drops_axes_the_mesh_lacks():
    """As the reference's: "pod" is dropped on a two-axis mesh, and an
    axis shards one dimension only."""
    mesh = StandIn((1, 1), ("data", "model"))
    for set_rules, to_spec, clear in ((AX.set_logical_rules, AX.logical_to_spec,
                                       AX.clear_logical_rules),
                                      (JAX_AX.set_logical_rules, JAX_AX.logical_to_spec,
                                       JAX_AX.clear_logical_rules)):
        set_rules(PT.get_rules("tp_fsdp"), mesh)
        try:
            assert tuple(to_spec(("batch", None, "embed_act"))) == ("data", None, None)
            assert tuple(to_spec(("mlp", "vocab"))) == ("model", None)
        finally:
            clear()


# ------------------------------------------------------------ one-rank group
@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group and a (1, 1) ("data", "model") mesh on it."""
    import torch.distributed as dist

    before = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        from repro_torch.launch.mesh import make_mesh

        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()
        if before is None:
            os.environ.pop("GLOO_SOCKET_IFNAME", None)
        else:
            os.environ["GLOO_SOCKET_IFNAME"] = before


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_allreduce_mean_bit_equal_to_reference(group, dtype):
    """World 1: the same uniform draws give the reference's result bit
    for bit (the scale's max and epsilon in the input dtype)."""
    rng = jax.random.PRNGKey(4)
    x = (jax.random.normal(jax.random.PRNGKey(3), (1000,)) * 0.3).astype(dtype)
    u = jax.random.uniform(rng, x.shape)      # the draws the reference makes inside
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = shard_map(lambda a, r: jint8_allreduce_mean(a, r, axis_name="data"), mesh=mesh,
                     in_specs=(P("data"), P()), out_specs=P("data"))(x, rng)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = int8_allreduce_mean_drawn(xt, torch.from_numpy(np.array(u)))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_compressed_grad_mean_within_one_step_of_the_grid(group):
    """Over a tree of plain and DTensor leaves (odd sizes: padded), each
    leaf comes back within scale/127 of itself at world 1, placements
    kept."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    gen = torch.Generator().manual_seed(0)
    grads = {"w": torch.randn(37, 5, generator=gen),
             "b": [torch.randn(3, generator=gen) * 1e-3],
             "d": distribute_tensor(torch.randn(8, 6, generator=gen), group,
                                    [Shard(0), Replicate()])}
    out = compressed_grad_mean(grads, group, "data", torch.Generator().manual_seed(1))
    for (k, a), (_, g) in zip(flatten_with_paths(out), flatten_with_paths(grads)):
        a, g = PT.full(a), PT.full(g)
        assert a.shape == g.shape and a.dtype == g.dtype, k
        assert float((a - g).abs().max()) <= float(g.abs().max()) / 127 * (1 + 1e-6), k
    assert out["d"].placements == grads["d"].placements


def _olmo(kv=None):
    jcfg, cfg = jget_config("olmo-1b").reduced(), get_config("olmo-1b").reduced()
    if kv is not None:
        jcfg, cfg = (dataclasses.replace(c, n_kv_heads=kv) for c in (jcfg, cfg))
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(lambda r: jmodel.init(r)[0])(jax.random.PRNGKey(0))
    return jcfg, cfg, jmodel, jax.tree.map(np.asarray, jparams)


def _train_batch(cfg, B=4, T=16, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def _assert_step_close(got_params, got_mu, loss, gnorm, want):
    """Loss, gradient norm and first moment (after one step, (1 - b1) x
    the clipped gradient) to their tolerances, and the parameters at
    rtol 5e-4.  Where the reference's first moment is under
    ``ILL_CONDITIONED_MU`` (a clipped gradient under 1e-6), the first
    AdamW update g / (|g| + eps) turns float rounding of g into
    differences up to the update itself, so there the parameters are
    held to the update's bound, lr."""
    np.testing.assert_allclose(loss, want["loss"], rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(gnorm, want["grad_norm"], rtol=0, atol=GRAD_ATOL)
    assert set(got_mu) == set(want["mu"]) and set(got_params) == set(want["params"])
    for k, a in got_mu.items():
        np.testing.assert_allclose(a, want["mu"][k], rtol=0, atol=MU_ATOL, err_msg=f"mu/{k}")
    for k, a in got_params.items():
        w, ill = want["params"][k], np.abs(want["mu"][k]) < ILL_CONDITIONED_MU
        np.testing.assert_allclose(a[~ill], w[~ill], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"params/{k}")
        assert np.all(np.abs(a[ill] - w[ill]) <= OPT["lr"]), f"params/{k}"


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path):
            np.asarray(v, np.float32) for path, v in flat}


@pytest.mark.parametrize("strategy,zero2,accum", [("tp", False, 1), ("tp_fsdp", False, 1),
                                                  ("tp_fsdp", True, 2), ("dp_fsdp", False, 1)])
def test_mesh_train_step_matches_reference_builder(group, strategy, zero2, accum):
    """One step at world 1 against the reference's ``TrainStepBuilder``
    under the same strategy on a 1x1 mesh of Auto axes."""
    jcfg, cfg, jmodel, np_params = _olmo()
    batch = _train_batch(cfg)
    jb = JTrainStepBuilder(jmodel, _jmesh(), strategy=strategy, opt=jopt.AdamWConfig(**OPT),
                           remat_policy="none", accum=accum, zero2=zero2)
    abstract, axes = jmodel.abstract()
    abatch = {k: jax.ShapeDtypeStruct(v.shape, jnp.int32) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jb.jit_train_step(abstract, axes, abatch)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    clear_logical_rules()
    want = {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
            "params": _paths(jstate["params"]), "mu": _paths(jstate["opt"]["mu"])}

    builder = TrainStepBuilder(build_model(cfg), group, strategy=strategy,
                               opt=AdamWConfig(**OPT), accum=accum, zero2=zero2)
    params = params_from_jax(np_params, cfg, device="cpu")
    state = builder.distribute_state(
        {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32)},
        src_data_rank=None)
    assert builder.zero2 == zero2
    state, m = builder.train_step_fn()(
        state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert int(state["step"]) == 1 and AX.current_rules() is None
    whole = lambda tree: {k: PT.full(t).float().numpy() for k, t in flatten_with_paths(tree)}
    _assert_step_close(whole(state["params"]), whole(state["opt"]["mu"]),
                       float(m["loss"]), float(m["grad_norm"]), want)


def _decode_inputs(cfg, B=2, T=12, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _jax_decode(jmodel, jparams, toks, t0, mesh=None, strategy=None):
    """Prefill ``toks[:, :t0]``, then teacher-forced decode steps; the
    logits of each (no mesh and no rules when ``mesh`` is None)."""
    B, T = toks.shape
    if mesh is not None:
        JAX_AX.set_logical_rules(JPT.get_rules(strategy), mesh)
    try:
        cache = jmodel.init_cache(B, max_len=T + 4)
        lg, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :t0])}, cache)
        outs = [np.asarray(lg)]
        for t in range(t0, T):
            lg, cache = jmodel.decode_step(jparams, jnp.asarray(toks[:, t]), jnp.asarray(t),
                                           cache)
            outs.append(np.asarray(lg))
    finally:
        clear_logical_rules()
    return np.stack(outs)


def _port_decode(cfg, params, toks, t0, mesh, strategy):
    model = build_model(cfg)
    builder = TrainStepBuilder(model, mesh, strategy=strategy)
    params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
    B, T = toks.shape
    cache = builder.shard_cache(model.init_cache(B, T + 4, device="cpu"))
    prefill, decode = builder.prefill_step_fn(), builder.decode_step_fn()
    toks = torch.from_numpy(toks).long()
    lg, cache = prefill(params, {"tokens": toks[:, :t0]}, cache)
    outs = [lg]
    for t in range(t0, T):
        lg, cache = decode(params, toks[:, t], t, cache)
        outs.append(lg)
    return torch.stack(outs).numpy()


@pytest.mark.parametrize("arch", ["olmo-1b", "h2o-danube-3-4b"])
def test_shard_decode_matches_reference(group, arch):
    """``tp_serve_sm`` prefill and decode (``sharded_decode_attention``)
    at world 1 against the reference's ``tp_serve_sm`` on a 1x1 mesh of
    Auto axes; h2o-danube3-4b's window cache wraps."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(lambda r: jmodel.init(r)[0])(jax.random.PRNGKey(1))
    toks = _decode_inputs(cfg)
    want = _jax_decode(jmodel, jparams, toks, 6, _jmesh(), "tp_serve_sm")
    got = _port_decode(cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"),
                       toks, 6, group, "tp_serve_sm")
    np.testing.assert_allclose(got, want, rtol=DEC_RTOL, atol=DEC_ATOL)


@pytest.mark.parametrize("arch", ["xlstm-350m", "seamless-m4t-large-v2"])
def test_unported_mesh_paths_raise(group, arch):
    """What the port does not run under a mesh raises NotImplementedError
    naming the op (or the refused path) and the strategy: training an
    xLSTM (``aten.log_sigmoid_backward`` has no sharding rule) and serving
    the encoder-decoder (its stacked memories)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    builder = TrainStepBuilder(model, group, strategy="tp")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_decode_inputs(cfg, T=8)).long()
    if arch == "xlstm-350m":
        state = builder.init_state(torch.Generator().manual_seed(0))
        with pytest.raises(NotImplementedError, match=r"log_sigmoid_backward.*strategy tp"):
            builder.train_step_fn()(state, {"tokens": toks, "labels": toks})
    else:
        params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
        batch = {"tokens": toks, "enc_embeds": torch.zeros(2, 8, cfg.d_model)}
        cache = builder.shard_cache(model.init_cache(2, 12, device="cpu"))
        with pytest.raises(NotImplementedError, match=r"memories.*strategy tp"):
            builder.prefill_step_fn()(params, batch, cache)


# ----------------------------------------------------------------- two ranks
def _jax_step(jmodel, np_params, batch, accum):
    """The reference's single-device step: gradients of each microbatch
    averaged in float32, then AdamW."""
    params = jax.tree.map(jnp.asarray, np_params)
    grad_fn = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))
    b = batch["tokens"].shape[0] // accum
    acc, losses = None, []
    for i in range(accum):
        mb = {k: jnp.asarray(v[i * b:(i + 1) * b]) for k, v in batch.items()}
        (loss, _), g = grad_fn(params, mb)
        g = jax.tree.map(lambda x: x.astype(jnp.float32) / accum, g)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        losses.append(float(loss))
    new_p, new_opt, stats = jopt.adamw_update(jopt.AdamWConfig(**OPT), acc,
                                              jopt.adamw_init(params), params)
    return {"loss": float(np.mean(np.asarray(losses, np.float32), dtype=np.float32)),
            "grad_norm": float(stats["grad_norm"]), "params": _paths(new_p),
            "mu": _paths(new_opt["mu"]), "state": {"params": new_p, "opt": new_opt}}


def _run_two_ranks(in_path, out_dir, *mode):
    """``torch_mesh_worker.py [mode] IN OUT`` as two gloo ranks; rank 0's
    ``out.npz``."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
                               *mode, str(in_path), str(out_dir)],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TWO_RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        f"rank {r}: " + "\n".join(line for line in log.splitlines() if "Error" in line)
        for r, log in enumerate(logs))
    return np.load(os.path.join(out_dir, "out.npz"))


def _step_outputs(out, name):
    """(params, mu, loss, grad norm) that a worker wrote for ``name``."""
    prefix = lambda what: {k[len(f"{name}/{what}/"):]: out[k] for k in out.files
                           if k.startswith(f"{name}/{what}/")}
    return ({k: v.astype(np.float32) for k, v in prefix("params").items()}, prefix("mu"),
            float(out[f"{name}/loss"]), float(out[f"{name}/grad_norm"]))


VOCAB_SPLIT = 512


def test_two_ranks_vocab_split_matches_reference(tmp_path):
    """``train_tp_vocab``: with an even vocabulary the "model" axis of mesh
    (1, 2) splits the logits' vocab dimension, and the loss's gold logit
    is taken from split logits.  One ``tp`` and one ``tp_fsdp`` step of
    reduced olmo-1b and one ``tp`` step of the reduced encoder-decoder
    against the reference's single-device step (``src/repro/models/lm.py``
    ``lm_loss``, ``encdec.py`` ``encdec_loss``)."""
    jcfg = dataclasses.replace(jget_config("olmo-1b").reduced(), vocab_size=VOCAB_SPLIT)
    jmodel = jbuild_model(jcfg)
    np_params = jax.tree.map(np.asarray, jax.jit(lambda r: jmodel.init(r)[0])(
        jax.random.PRNGKey(3)))
    batch = _train_batch(jcfg)
    ecfg = dataclasses.replace(jget_config("seamless-m4t-large-v2").reduced(),
                               vocab_size=VOCAB_SPLIT)
    emodel = jbuild_model(ecfg)
    e_params = jax.tree.map(np.asarray, jax.jit(lambda r: emodel.init(r)[0])(
        jax.random.PRNGKey(4)))
    ebatch = dict(_train_batch(ecfg, seed=5), enc_embeds=np.random.default_rng(6)
                  .standard_normal((4, 12, ecfg.d_model)).astype(np.float32))
    inputs = {f"olmo/{k}": v for k, v in _paths_raw(np_params).items()}
    inputs.update({f"batch/{k}": v for k, v in batch.items()})
    inputs.update({f"encdec/{k}": v for k, v in _paths_raw(e_params).items()})
    inputs.update({f"encdec_batch/{k}": v for k, v in ebatch.items()})
    inputs["meta"] = np.asarray(json.dumps({"opt": OPT, "vocab": VOCAB_SPLIT}))
    np.savez(tmp_path / "in.npz", **inputs)
    out = _run_two_ranks(tmp_path / "in.npz", tmp_path, "vocab")

    want = _jax_step(jmodel, np_params, batch, 1)
    for name in ("train_tp_vocab", "train_tp_fsdp_vocab"):
        _assert_step_close(*_step_outputs(out, name), want)
    _assert_step_close(*_step_outputs(out, "train_encdec_vocab"),
                       _jax_step(emodel, e_params, ebatch, 1))


def test_two_ranks_match_reference(tmp_path):
    """Two gloo ranks (two processes): ``tp_fsdp`` + ``zero2`` + ``accum=2``
    on (2, 1) and ``tp`` on (1, 2) train reduced olmo-1b (with ``tp`` also
    with one kv head: each rank's q heads read it, its gradient a partial
    sum over the ranks), and
    ``tp_serve_sm`` serves reduced h2o-danube3-4b on (1, 2) with two kv
    heads (the cache split by heads) and with one (split by sequence: the
    combine over ranks, and each rank's q heads reading the one kv head),
    each against the reference's single-device numbers; the state that
    rank 0 saved restores in the reference, byte-equal."""
    jcfg, cfg, jmodel, np_params = _olmo()
    batch = _train_batch(cfg)
    inputs = {f"olmo/{k}": v for k, v in _paths_raw(np_params).items()}
    _, _, jmodel_kv1, np_params_kv1 = _olmo(kv=1)
    inputs.update({f"olmo_kv1/{k}": v for k, v in _paths_raw(np_params_kv1).items()})
    inputs.update({f"batch/{k}": v for k, v in batch.items()})
    serve_want = {}
    scfg = get_config("h2o-danube-3-4b").reduced()
    toks = _decode_inputs(scfg)
    for name, kv in (("serve_kv2", 2), ("serve_kv1", 1)):
        jscfg = dataclasses.replace(jget_config("h2o-danube-3-4b").reduced(), n_kv_heads=kv)
        jsmodel = jbuild_model(jscfg)
        jp = jax.jit(lambda r: jsmodel.init(r)[0])(jax.random.PRNGKey(5))
        inputs.update({f"{name}/{k}": v for k, v in _paths_raw(jp).items()})
        serve_want[name] = _jax_decode(jsmodel, jp, toks, 6)
    inputs["serve/tokens"] = toks
    inputs["meta"] = np.asarray(json.dumps({"opt": OPT, "prefill": 6}))
    np.savez(tmp_path / "in.npz", **inputs)

    out = _run_two_ranks(tmp_path / "in.npz", tmp_path)

    for name, accum, jm, npp in (("train_zero2", 2, jmodel, np_params),
                                 ("train_tp", 1, jmodel, np_params),
                                 ("train_tp_kv1", 1, jmodel_kv1, np_params_kv1)):
        _assert_step_close(*_step_outputs(out, name), _jax_step(jm, npp, batch, accum))
    # a stacked wq is (layers, embed, q_heads, head)
    assert str(out["train_zero2/placements"]) == "(Shard(dim=1), Replicate())"  # fsdp
    assert str(out["train_tp/placements"]) == "(Replicate(), Shard(dim=2))"     # heads
    for name, want in serve_want.items():
        np.testing.assert_allclose(out[f"{name}/logits"], want, rtol=DEC_RTOL, atol=DEC_ATOL,
                                   err_msg=name)
    # a stacked cache k is (layers, batch, kv_heads, seq, head)
    assert str(out["serve_kv2/cache_placements"]) == "(Replicate(), Shard(dim=2))"
    assert str(out["serve_kv1/cache_placements"]) == "(Replicate(), Shard(dim=3))"

    # the checkpoint rank 0 wrote, read back by the reference
    spool = str(tmp_path / "spool")
    rck = JBlobCheckpointer(JBlobSeerService.restore(spool, spool + "/vm.wal", n_providers=4,
                                                     n_meta_shards=2).client(),
                            str(out["train_zero2/ckpt_blob"]), header_pages=16)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        {"params": np_params, "opt": jopt.adamw_init(np_params),
                         "step": np.zeros((), np.int32)})
    got = rck.restore(like)
    assert int(got["step"]) == 1 and int(got["opt"]["count"]) == 1
    for what, tree in (("params", got["params"]), ("mu", got["opt"]["mu"])):
        for k, v in _paths_raw(tree).items():
            assert v.tobytes() == out[f"train_zero2/{what}/{k}"].tobytes(), (what, k)


def _paths_raw(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path):
            np.asarray(v) for path, v in flat}
