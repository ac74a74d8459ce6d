"""The reference's last three strategies under a mesh, on four gloo
ranks, vs the JAX reference on one device.

``torch_mesh_worker.py strategies`` runs on mesh (2, 2), once for the
module (``run``); each case is one test:

* ``tp_serve_hd`` (``src/repro/distributed/partitioning.py:73-77``): the
  decode over a cache split on its head dimension, whose partial scores
  are all-reduced before the softmax and whose cache is never gathered;
  reduced qwen1.5-32b (3 heads and kv heads, head_dim 8) and reduced
  recurrentgemma-2b (1 kv head);
* ``_uneven`` (``partitioning.py:101-123``): heads and vocabularies split
  unevenly over "model" in ``torch.chunk``'s layout (3 heads as 2 + 1, an
  odd vocabulary as 258 + 257), where GSPMD pads;
* ``tp_fsdp_sp`` (``partitioning.py:13, 68``): with a batch of 1, the
  activations' sequence split over "data".

Parameters come from the reference's init through
``convert.params_from_jax``.  Tolerances are those of
``test_torch_distributed.py`` (``test_torch_mesh_splice_heads.py`` uses
them too): loss and gradients 1e-5, AdamW moments 1e-6, parameters rtol
5e-4, decode logits rtol 2e-4 atol 2e-5.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_distributed import (DEC_ATOL, DEC_RTOL, OPT, _assert_step_close,
                                    _decode_inputs, _jax_step, _join_ranks, _paths_raw,
                                    _start_ranks, _step_outputs, _train_batch)
# fixtures: the rules cleared around each test, the one-rank gloo group
from test_torch_distributed import _no_leaked_axis_rules, group  # noqa: F401
from test_torch_mesh_paths import _jax_pair, _prompts

from repro.launch.serve import generate as jgenerate
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import generate
from repro_torch.models import build_model

torch.set_num_threads(2)

QWEN3 = dict(n_heads=3, n_kv_heads=3)
RG3 = dict(n_heads=3, n_kv_heads=1, d_rnn=48, n_layers=3)
RG = dict(n_layers=3)                       # one pattern group: rglru, rglru, local
SERVE = {  # case: arch, strategy, config overrides, prefill length, (batch, length)
    "serve_hd_qwen": ("qwen1.5-32b", "tp_serve_hd", dict(QWEN3, d_head=8), 6, (2, 12)),
    "serve_hd_rg": ("recurrentgemma-2b", "tp_serve_hd", RG, 6, (2, 12)),
    "prefill_uneven_qwen": ("qwen1.5-32b", "tp_serve_uneven", QWEN3, 6, (2, 12)),
    # the window (8) binds, and the prefill rolls it into the cache
    "sp_prefill_danube": ("h2o-danube-3-4b", "tp_fsdp_sp", {}, 12, (1, 20)),
}
TRAIN = {  # case: arch, strategy, config overrides, batch rows
    "train_uneven_qwen": ("qwen1.5-32b", "tp_fsdp_uneven", QWEN3, 4),
    "train_uneven_rg": ("recurrentgemma-2b", "tp_fsdp_uneven", RG3, 4),
    "train_uneven_vocab": ("granite-moe-1b-a400m", "tp_uneven", dict(vocab_size=515), 4),
    "sp_train_rg": ("recurrentgemma-2b", "tp_fsdp_sp", RG, 1),
}
SP_SPLIT = "(Shard(dim=1), Replicate())"     # (B, T, D): the sequence over "data"
STRATEGIES = ["tp_serve_hd", "tp_serve_uneven", "tp_fsdp_sp"]
ENTRY_ARCH, MAX_NEW = "recurrentgemma-2b", 4
TRAIN_ARGV = ["--device", "cpu", "--steps", "2", "--seq", "16", "--batch", "2", "--d-model",
              "32", "--layers", "1", "--d-ff", "64", "--corpus-docs", "20", "--quiet"]


def _jax_decode(jmodel, np_params, toks, t0):
    """The reference with no mesh: a prefill of ``toks[:, :t0]``, then
    teacher-forced decode steps (jitted, one compile for all steps); the
    logits of each."""
    params = jax.tree.map(jnp.asarray, np_params)
    B, T = toks.shape
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    lg, cache = prefill(params, {"tokens": jnp.asarray(toks[:, :t0])},
                        jmodel.init_cache(B, max_len=T + 4))
    outs = [np.asarray(lg)]
    for t in range(t0, T):
        lg, cache = decode(params, jnp.asarray(toks[:, t]), jnp.asarray(t), cache)
        outs.append(np.asarray(lg))
    return np.stack(outs)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Rank 0's outputs of one four-rank run, and the reference's (computed
    while the ranks run)."""
    tmp = tmp_path_factory.mktemp("strategies")
    inputs, refs = {}, {}
    for seed, (case, (arch, _, over, t0, (B, T))) in enumerate(SERVE.items(), start=31):
        jcfg, jmodel, np_params = _jax_pair(arch, seed, **over)
        toks = _decode_inputs(jcfg, B=B, T=T, seed=seed + 10)
        inputs.update({f"{case}/{k}": v for k, v in _paths_raw(np_params).items()})
        inputs[f"{case}_in/tokens"] = toks
        refs[case] = lambda m=jmodel, p=np_params, x=toks, t0=t0: _jax_decode(m, p, x, t0)
    for seed, (case, (arch, _, over, B)) in enumerate(TRAIN.items(), start=41):
        jcfg, jmodel, np_params = _jax_pair(arch, seed, **over)
        batch = _train_batch(jcfg, B=B, seed=seed + 10)
        inputs.update({f"{case}/{k}": v for k, v in _paths_raw(np_params).items()})
        inputs.update({f"{case}_batch/{k}": v for k, v in batch.items()})
        refs[case] = lambda m=jmodel, p=np_params, b=batch: _jax_step(m, p, b, 1)
    meta = {"opt": OPT, "prefill": {c: v[3] for c, v in SERVE.items()},
            "serve": {c: v[:2] for c, v in SERVE.items()},
            "train": {c: v[:2] for c, v in TRAIN.items()},
            "over": {c: v[2] for c, v in list(SERVE.items()) + list(TRAIN.items())}}
    inputs["meta"] = np.asarray(json.dumps(meta))
    np.savez(tmp / "in.npz", **inputs)
    procs = _start_ranks(tmp / "in.npz", tmp, "strategies", world=4)
    try:
        want = {case: ref() for case, ref in refs.items()}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return _join_ranks(procs, tmp), want


def _logits_close(out, want, case):
    np.testing.assert_allclose(out[f"{case}/logits"], want[case], rtol=DEC_RTOL, atol=DEC_ATOL,
                               err_msg=case)


@pytest.mark.parametrize("case", ["serve_hd_qwen", "serve_hd_rg"])
def test_serve_hd_matches_reference(run, case):
    """``tp_serve_hd``: the prefill's and 6 teacher-forced decode steps'
    logits; the cache (stacked: layers, batch, kv_heads, seq, head) split
    over batch on "data" and on its head dimension over "model", its
    local head dimension halved after the last step (never gathered)."""
    out, want = run
    _logits_close(out, want, case)
    assert str(out[f"{case}/cache_placements"]) == "(Shard(dim=1), Shard(dim=4))"
    arch, _, over, _, (B, T) = SERVE[case]
    heads = over.get("n_kv_heads", 1)
    dh = over.get("d_head", 16)
    length = T + 4 if arch == "qwen1.5-32b" else 8          # recurrentgemma: the window
    assert tuple(out[f"{case}/cache_local_shape"])[1:] == (B // 2, heads, length, dh // 2)


def test_prefill_uneven_matches_reference(run):
    """``tp_serve_uneven``: 3 heads split 2 + 1 over "model" (rank 0 holds
    2 of the stacked wq's (layers, embed, q_heads, head)), the prefill's
    and decode steps' logits as one device's."""
    out, want = run
    _logits_close(out, want, "prefill_uneven_qwen")
    assert str(out["prefill_uneven_qwen/wq_placements"]) == "(Replicate(), Shard(dim=2))"
    assert tuple(out["prefill_uneven_qwen/wq_local_shape"])[2] == 2
    # 3 kv heads split alike: the cache too (stacked: layers, batch, kv_heads, ...)
    assert str(out["prefill_uneven_qwen/cache_placements"]) == "(Shard(dim=1), Shard(dim=2))"


@pytest.mark.parametrize("case", ["train_uneven_qwen", "train_uneven_rg"])
def test_train_uneven_matches_reference(run, case):
    """``tp_fsdp_uneven`` steps with 3 heads over a 2-way "model" axis (and
    the reduced configs' odd vocabulary, 257, split 129 + 128): loss,
    gradient norm, first moment and parameters as one device's."""
    out, want = run
    _assert_step_close(*_step_outputs(out, case), want[case])
    # the stacked wq: fsdp over "data" on embed, 3 heads unevenly over "model"
    assert str(out[f"{case}/placements"]) == "(Shard(dim=1), Shard(dim=2))"
    assert str(out[f"{case}/table_placements"]) == "(Shard(dim=1), Shard(dim=0))"
    assert tuple(out[f"{case}/table_local_shape"]) == (129, 32)


def test_train_uneven_vocab_matches_reference(run):
    """A ``tp_uneven`` step of reduced granite-moe-1b-a400m with a
    vocabulary of 515, split 258 + 257 over "model": the lookup, the tied
    logits, the loss and their gradients as one device's."""
    out, want = run
    _assert_step_close(*_step_outputs(out, "train_uneven_vocab"), want["train_uneven_vocab"])
    assert str(out["train_uneven_vocab/table_placements"]) == "(Replicate(), Shard(dim=0))"
    assert tuple(out["train_uneven_vocab/table_local_shape"]) == (258, 64)


def test_sp_train_matches_reference(run):
    """``tp_fsdp_sp`` with a batch of 1: a step of reduced recurrentgemma-2b
    (local attention with the q rows offset, the conv's W-1 steps from the
    previous rank, the scan over the gathered sequence), its activations'
    sequence split over "data"."""
    out, want = run
    _assert_step_close(*_step_outputs(out, "sp_train_rg"), want["sp_train_rg"])
    assert str(out["sp_train_rg/embed_placements"]) == SP_SPLIT


def test_sp_prefill_matches_reference(run):
    """``tp_fsdp_sp`` with a batch of 1: the prefill of reduced
    h2o-danube3-4b over 12 positions, longer than its window of 8, on a
    sequence split over "data", and decode steps after it."""
    out, want = run
    _logits_close(out, want, "sp_prefill_danube")
    assert str(out["sp_prefill_danube/embed_placements"]) == SP_SPLIT


_ENTRY = {}


def _entry_reference():
    """The reference's greedy tokens with no mesh, and the losses of
    ``launch.train`` under ``tp`` (computed once)."""
    if not _ENTRY:
        from repro_torch.launch.train import main as train_main

        jcfg, jmodel, np_params = _jax_pair(ENTRY_ARCH, 51, **RG)
        prompts = _prompts(jcfg, seed=52)
        _ENTRY.update(np_params=np_params, prompts=prompts, tokens=np.stack(jgenerate(
            jmodel, jax.tree.map(jnp.asarray, np_params), prompts, max_new=MAX_NEW,
            max_len=len(prompts[0]) + MAX_NEW)),
                      losses=train_main(TRAIN_ARGV + ["--strategy", "tp"])["losses"])
    return _ENTRY


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_entry_points_take_the_strategies(group, strategy):
    """``launch.serve.generate(mesh=..., strategy=...)`` and
    ``launch.train --strategy`` at world 1 (a one-rank gloo group, where
    every placement replicates): greedy tokens of reduced
    recurrentgemma-2b equal to the reference's ``generate`` with no mesh,
    and ``launch.train``'s losses equal to its ``tp`` run's."""
    from repro_torch.launch.train import main as train_main

    ref = _entry_reference()
    cfg = get_config(ENTRY_ARCH).reduced(**RG)
    got = generate(build_model(cfg), params_from_jax(ref["np_params"], cfg, device="cpu"),
                   ref["prompts"], max_new=MAX_NEW, max_len=len(ref["prompts"][0]) + MAX_NEW,
                   device="cpu", mesh=group, strategy=strategy)
    np.testing.assert_array_equal(np.stack(got), ref["tokens"])
    assert train_main(TRAIN_ARGV + ["--strategy", strategy])["losses"] == ref["losses"]
