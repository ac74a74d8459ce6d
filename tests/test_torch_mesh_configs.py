"""The configurations the reference runs under a mesh and the port once
did not, on four gloo ranks, vs the JAX reference on one device.

``torch_mesh_worker.py configs`` runs on mesh (2, 2), once for the
module (``run``); each case is one test:

* training past ``BLOCKWISE_KV_THRESHOLD`` (4096) kv positions, where
  ``ops.flash_attention`` and its backward run on each rank's local
  shards: reduced h2o-danube3-4b at 4160 tokens with its published window
  of 4096, under ``tp_fsdp_sp`` (batch 1, the sequence over "data": rank
  1's q rows start at 2080), ``tp_fsdp`` (batch 2) and ``tp_fsdp_uneven``
  (3 heads and 1 kv head, which "model" does not divide);
* the encoder-decoder under ``tp_serve_hd``, ``tp_serve_uneven``,
  ``tp_fsdp_uneven`` and ``tp_fsdp_sp``, with 3 heads and 3 kv heads of 8
  (neither divides "model"): prefills and teacher-forced decode steps,
  a step, and a ``tp_fsdp_sp`` step whose encoder runs over 4160 frames;
  under ``tp_serve_hd`` neither the memories nor the cache is ever
  gathered on its head dimension;
* the MoE (reduced olmoe-1b-7b and granite-moe-1b-a400m) and xLSTM
  (reduced xlstm-350m, one mLSTM and one sLSTM block) under
  ``tp_fsdp_sp`` with a batch of 1 and 64 tokens: a step, and a prefill
  with decode steps.

Parameters come from the reference's init through
``convert.params_from_jax``.  Tolerances are those of
``test_torch_distributed.py``: loss and gradients 1e-5, AdamW moments
1e-6, parameters rtol 5e-4, logits rtol 2e-4 atol 2e-5.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.train import optimizer as jopt
from test_torch_distributed import (DEC_ATOL, DEC_RTOL, OPT, _assert_step_close, _join_ranks,
                                    _paths, _paths_raw, _start_ranks, _step_outputs)
# fixture: the rules cleared around each test
from test_torch_distributed import _no_leaked_axis_rules  # noqa: F401
from test_torch_mesh_paths import _jax_pair
from test_torch_mesh_strategies import _jax_decode
from test_torch_moe import _jax_route

torch.set_num_threads(2)

DANUBE, SEAMLESS = "h2o-danube-3-4b", "seamless-m4t-large-v2"
LONG, HALF = 4160, 2080                        # past 4096 kv positions; a rank's half
WINDOW = dict(window=4096)                     # danube's published window
ENC3 = dict(n_heads=3, n_kv_heads=3, d_head=8)
XLSTM = dict(block_pattern=("mlstm", "slstm"), n_layers=2)
DROPPING = dict(capacity_factor=0.5)            # capacity 16 for 128 choices over 4 experts
TRAIN = {  # case: arch, strategy, config overrides, batch rows, tokens, encoder frames
    "long_sp_danube": (DANUBE, "tp_fsdp_sp", WINDOW, 1, LONG, None),
    "long_fsdp_danube": (DANUBE, "tp_fsdp", WINDOW, 2, LONG, None),
    "long_uneven_danube": (DANUBE, "tp_fsdp_uneven", dict(WINDOW, n_heads=3, n_kv_heads=1),
                           2, LONG, None),
    "uneven_train_encdec": (SEAMLESS, "tp_fsdp_uneven", ENC3, 4, 12, 10),
    "sp_train_encdec": (SEAMLESS, "tp_fsdp_sp", ENC3, 1, 16, LONG),
    "sp_train_olmoe": ("olmoe-1b-7b", "tp_fsdp_sp", {}, 1, 64, None),
    "sp_train_granite": ("granite-moe-1b-a400m", "tp_fsdp_sp", DROPPING, 1, 64, None),
    "sp_train_xlstm": ("xlstm-350m", "tp_fsdp_sp", XLSTM, 1, 64, None),
}
SERVE = {  # case: arch, strategy, config overrides, prefill, (batch, tokens), encoder frames
    "hd_serve_encdec": (SEAMLESS, "tp_serve_hd", ENC3, 5, (2, 9), 10),
    "uneven_serve_encdec": (SEAMLESS, "tp_serve_uneven", ENC3, 5, (2, 9), 10),
    "sp_prefill_encdec": (SEAMLESS, "tp_fsdp_sp", ENC3, 12, (1, 15), 64),
    "sp_serve_olmoe": ("olmoe-1b-7b", "tp_fsdp_sp", {}, 64, (1, 68), None),
    "sp_serve_granite": ("granite-moe-1b-a400m", "tp_fsdp_sp", DROPPING, 64, (1, 68), None),
    "sp_prefill_xlstm": ("xlstm-350m", "tp_fsdp_sp", XLSTM, 64, (1, 66), None),
}
SP_SPLIT = "(Shard(dim=1), Replicate())"     # (B, T, D): the sequence over "data"


def _batch(cfg, B, T, frames, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if frames is not None:
        batch["enc_embeds"] = rng.standard_normal((B, frames, cfg.d_model)).astype(np.float32)
    return batch


_PAIRS = {}


def _pair(arch, over, seed):
    """``_jax_pair`` of (arch, overrides), made once: cases of one
    configuration share its parameters (the seed of the first)."""
    key = (arch, json.dumps(over, sort_keys=True))
    if key not in _PAIRS:
        _PAIRS[key] = _jax_pair(arch, seed, **over)
    return _PAIRS[key]


def _jax_step(jmodel, np_params, batch):
    """The reference's single-device step, as ``test_torch_distributed``'s
    with one microbatch, the gradient and the AdamW update in one jit."""
    cfg = jopt.AdamWConfig(**OPT)

    def step(params, batch):
        (loss, _), g = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(params, batch)
        g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
        new_p, new_opt, stats = jopt.adamw_update(cfg, g, jopt.adamw_init(params), params)
        return loss, new_p, new_opt["mu"], stats["grad_norm"]

    loss, new_p, mu, gnorm = jax.jit(step)(jax.tree.map(jnp.asarray, np_params),
                                           {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss), "grad_norm": float(gnorm), "params": _paths(new_p),
            "mu": _paths(mu)}


def _jax_encdec_decode(jmodel, np_params, frames, toks, t0):
    """The reference's encoder-decoder with no mesh (jitted): a prefill of
    ``toks[:, :t0]`` over ``frames``, then teacher-forced decode steps
    over its memories; the logits of each."""
    params = jax.tree.map(jnp.asarray, np_params)
    B, T = toks.shape
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    lg, cache, mem = prefill(params, {"enc_embeds": jnp.asarray(frames),
                                      "tokens": jnp.asarray(toks[:, :t0])},
                             jmodel.init_cache(B, T + 4))
    outs = [np.asarray(lg)]
    for t in range(t0, T):
        lg, cache = decode(params, jnp.asarray(toks[:, t]), jnp.asarray(t), cache, mem)
        outs.append(np.asarray(lg))
    return np.stack(outs)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Rank 0's outputs of one four-rank run, and the reference's (computed
    while the ranks run)."""
    tmp = tmp_path_factory.mktemp("configs")
    inputs, refs, routers = {}, {}, {}
    for seed, (case, (arch, _, over, B, T, frames)) in enumerate(TRAIN.items(), start=61):
        jcfg, jmodel, np_params = _pair(arch, over, seed)
        routers[case] = _routers(jcfg, np_params)
        batch = _batch(jcfg, B, T, frames, seed + 10)
        inputs.update({f"{case}/{k}": v for k, v in _paths_raw(np_params).items()})
        inputs.update({f"{case}_batch/{k}": v for k, v in batch.items()})
        refs[case] = lambda m=jmodel, p=np_params, b=batch: _jax_step(m, p, b)
    for seed, (case, (arch, _, over, t0, (B, T), frames)) in enumerate(SERVE.items(), start=81):
        jcfg, jmodel, np_params = _pair(arch, over, seed)
        routers[case] = _routers(jcfg, np_params)
        batch = _batch(jcfg, B, T, frames, seed + 10)
        inputs.update({f"{case}/{k}": v for k, v in _paths_raw(np_params).items()})
        inputs[f"{case}_in/tokens"] = batch["tokens"]
        if frames is None:
            refs[case] = lambda m=jmodel, p=np_params, x=batch["tokens"], t0=t0: (
                _jax_decode(m, p, x, t0))
        else:
            inputs[f"{case}_in/frames"] = batch["enc_embeds"]
            refs[case] = lambda m=jmodel, p=np_params, b=batch, t0=t0: _jax_encdec_decode(
                m, p, b["enc_embeds"], b["tokens"], t0)
    meta = {"opt": OPT, "prefill": {c: v[3] for c, v in SERVE.items()},
            "serve": {c: v[:2] for c, v in SERVE.items()},
            "train": {c: v[:2] for c, v in TRAIN.items()},
            "over": {c: v[2] for c, v in list(SERVE.items()) + list(TRAIN.items())}}
    inputs["meta"] = np.asarray(json.dumps(meta))
    np.savez(tmp / "in.npz", **inputs)
    procs = _start_ranks(tmp / "in.npz", tmp, "configs", world=4)
    try:
        want = {case: ref() for case, ref in refs.items()}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return _join_ranks(procs, tmp), dict(want, routers=routers)


def _routers(jcfg, np_params):
    """(config, each MoE layer's router in layer order) of an MoE arch (its
    layers are one stacked pattern group), else None."""
    if not jcfg.moe:
        return None
    stacked = np_params["groups"][0]["ffn"]["router"]
    return jcfg, [stacked[i] for i in range(jcfg.n_layers)]


def _assert_routing_matches(out, want, case):
    """Every MoE routing of the run, layer after layer (a step's forward,
    or a prefill's and each decode step's), held to the reference's
    routing of the same rows (``src/repro/models/moe.py:47-64``): the kept
    (token, choice) pairs equal, so the dropped ones too.  Returns the
    number of pairs dropped."""
    jcfg, routers = want["routers"][case]
    calls = sorted({int(k.split("/")[-1]) for k in out.files
                    if k.startswith(f"{case}/route_kept/")})
    assert calls, case
    dropped = 0
    for i in calls:
        x = out[f"{case}/route_x/{i}"]
        _, kept = _jax_route({"router": jnp.asarray(routers[i % len(routers)])}, jcfg,
                             jnp.asarray(x))
        np.testing.assert_array_equal(out[f"{case}/route_kept/{i}"], kept, err_msg=f"{case} {i}")
        dropped += int((~kept).sum())
    return dropped


def _flash_calls(out, case):
    """Every rank's calls of ``ops.flash_attention``: [q shape, k shape,
    q_offset, window, recorded]."""
    return json.loads(str(out[f"{case}/flash_calls"]))


def _logits_close(out, want, case):
    np.testing.assert_allclose(out[f"{case}/logits"], want[case], rtol=DEC_RTOL, atol=DEC_ATOL,
                               err_msg=case)


def test_long_sp_train_matches_reference(run):
    """``tp_fsdp_sp`` with a batch of 1 at 4160 tokens: each rank's q rows
    are its half of the sequence (rank 1's start at 2080, so the window
    of 4096 and the causal mask both bind across the split), over the
    whole k and v, through the recorded op; the step as one device's."""
    out, want = run
    _assert_step_close(*_step_outputs(out, "long_sp_danube"), want["long_sp_danube"])
    assert str(out["long_sp_danube/embed_placements"]) == SP_SPLIT
    calls = _flash_calls(out, "long_sp_danube")
    # mesh (2, 2): ranks 0, 1 hold the first half ("data" 0), ranks 2, 3 the second
    for rank, rank_calls in enumerate(calls):
        assert len(rank_calls) == 2, rank                      # one a layer
        for q, k, off, window, recorded in rank_calls:
            assert q[2] == HALF and k[2] == LONG and window == 4096 and recorded
            assert off == HALF * (rank // 2), (rank, off)


@pytest.mark.parametrize("case", ["long_fsdp_danube", "long_uneven_danube"])
def test_long_train_matches_reference(run, case):
    """``tp_fsdp`` (batch 2) and ``tp_fsdp_uneven`` (3 heads split 2 + 1
    over "model", 1 kv head read by both ranks' q heads: its gradient a
    partial sum) at 4160 tokens: the recorded op on each rank's local
    rows and heads; the step as one device's."""
    out, want = run
    _assert_step_close(*_step_outputs(out, case), want[case])
    heads = [2, 1] if case == "long_uneven_danube" else [2, 2]
    for rank, rank_calls in enumerate(_flash_calls(out, case)):
        assert len(rank_calls) == 2, rank
        for q, k, off, _, recorded in rank_calls:
            assert q == [1, heads[rank % 2], LONG, 16] and k[2] == LONG and off == 0
            assert recorded


@pytest.mark.parametrize("case", ["hd_serve_encdec", "uneven_serve_encdec"])
def test_encdec_serve_matches_reference(run, case):
    """``tp_serve_hd`` (memories and cache split on their head dimension)
    and ``tp_serve_uneven`` (3 heads split 2 + 1): the prefill's and 4
    teacher-forced decode steps' logits of the reduced encoder-decoder.
    Under ``tp_serve_hd`` the memories and the cache are never gathered on
    their head dimension."""
    out, want = run
    _logits_close(out, want, case)
    if case == "hd_serve_encdec":
        # stacked: (layers, batch, kv_heads, frames or slots, head)
        assert str(out[f"{case}/memories_placements"]) == "(Shard(dim=1), Shard(dim=4))"
        assert str(out[f"{case}/cache_placements"]) == "(Shard(dim=1), Shard(dim=4))"
        assert json.loads(str(out[f"{case}/head_dim_gathers"])) == []


def test_encdec_uneven_train_matches_reference(run):
    """A ``tp_fsdp_uneven`` step of the reduced encoder-decoder with 3
    heads and 3 kv heads split 2 + 1 over "model"."""
    out, want = run
    _assert_step_close(*_step_outputs(out, "uneven_train_encdec"), want["uneven_train_encdec"])


def test_encdec_sp_train_matches_reference(run):
    """``tp_fsdp_sp`` with a batch of 1: a step whose encoder runs over
    4160 frames, its self-attention's q rows split over "data" (rank 1's
    start at 2080) and the cross-attention over the 4160 frames, both
    through the recorded op."""
    out, want = run
    _assert_step_close(*_step_outputs(out, "sp_train_encdec"), want["sp_train_encdec"])
    for rank, rank_calls in enumerate(_flash_calls(out, "sp_train_encdec")):
        enc = [c for c in rank_calls if c[0][2] == HALF]
        cross = [c for c in rank_calls if c[0][2] == 8]       # 16 tokens, halved
        assert len(enc) == 2 and len(cross) == 2, rank          # two layers of each
        assert all(c[1][2] == LONG and c[4] for c in enc + cross)
        assert all(c[2] == HALF * (rank // 2) for c in enc), rank


def test_encdec_sp_prefill_matches_reference(run):
    """``tp_fsdp_sp`` with a batch of 1: the prefill of the reduced
    encoder-decoder over 64 frames and 12 tokens, both split over "data",
    and 3 decode steps after it."""
    out, want = run
    _logits_close(out, want, "sp_prefill_encdec")
    assert str(out["sp_prefill_encdec/embed_placements"]) == SP_SPLIT


@pytest.mark.parametrize("case", ["sp_train_olmoe", "sp_train_granite", "sp_train_xlstm"])
def test_sp_moe_xlstm_train_matches_reference(run, case):
    """``tp_fsdp_sp`` with a batch of 1 and 64 tokens split over "data": a
    step of reduced olmoe-1b-7b and granite-moe-1b-a400m (capacity slots
    counted along the whole sequence, as one device counts them: the kept
    and dropped pairs the reference's; granite at a capacity factor of 0.5,
    so that pairs are dropped) and of reduced xlstm-350m (the conv across
    the split, the scans over the gathered sequence)."""
    out, want = run
    _assert_step_close(*_step_outputs(out, case), want[case])
    assert str(out[f"{case}/embed_placements"]) == SP_SPLIT
    if want["routers"][case] is not None:
        dropped = _assert_routing_matches(out, want, case)
        assert dropped > 0 or "granite" not in case, dropped


@pytest.mark.parametrize("case", ["sp_serve_olmoe", "sp_serve_granite", "sp_prefill_xlstm"])
def test_sp_moe_xlstm_serve_matches_reference(run, case):
    """``tp_fsdp_sp`` with a batch of 1: a prefill of 64 tokens split over
    "data" and teacher-forced decode steps after it (the MoE's routing of
    each held to the reference's)."""
    out, want = run
    _logits_close(out, want, case)
    assert str(out[f"{case}/embed_placements"]) == SP_SPLIT
    if want["routers"][case] is not None:
        _assert_routing_matches(out, want, case)
