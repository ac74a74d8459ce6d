"""The VLM splice and heads that the "model" axis does not divide, on
four gloo ranks, vs the JAX reference on one device.

``torch_mesh_worker.py splice-heads`` runs on mesh (2, 2): reduced
internvl2-76b under ``tp`` with ``vision_embeds`` spliced over a lookup
in a vocab-split table (the port once reduced the lookup's partial sum
after ``torch.cat`` and raised), and ``tp_fsdp`` train steps of reduced
recurrentgemma-2b and qwen1.5-32b with 3 heads (the port once unflattened
a gradient over merged heads split over "model" and raised).  Tolerances
are those of ``test_torch_distributed.py``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_distributed import (DEC_ATOL, DEC_RTOL, OPT, _assert_step_close,
                                    _decode_inputs, _jax_step, _paths_raw, _run_two_ranks,
                                    _step_outputs, _train_batch)
from test_torch_mesh_paths import _jax_pair

torch.set_num_threads(2)

VLM_VOCAB = 256                 # even: "model" splits the table and the logits
HEADS3 = {"recurrentgemma-2b": dict(n_heads=3, n_kv_heads=1, d_rnn=48, n_layers=3),
          "qwen1.5-32b": dict(n_heads=3, n_kv_heads=3)}


def _jax_vlm_decode(jmodel, jparams, toks, vision, t0):
    """The reference with no mesh: prefill of ``toks[:, :t0]`` with
    ``vision`` spliced over the first positions, then teacher-forced
    decode steps; the logits of each."""
    B, T = toks.shape
    cache = jmodel.init_cache(B, max_len=T + 4)
    lg, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :t0]),
                                         "vision_embeds": jnp.asarray(vision)}, cache)
    outs = [np.asarray(lg)]
    for t in range(t0, T):
        lg, cache = jmodel.decode_step(jparams, jnp.asarray(toks[:, t]), jnp.asarray(t), cache)
        outs.append(np.asarray(lg))
    return np.stack(outs)


def test_four_ranks_vlm_splice_and_uneven_heads_match_reference(tmp_path):
    """``torch_mesh_worker.py splice-heads`` on four gloo ranks, mesh
    (2, 2), each case against the reference on one device: under ``tp``,
    reduced internvl2-76b with ``vision_embeds`` spliced over a lookup in a
    table that "model" splits (``src/repro/models/lm.py`` ``_embed``), one
    train step and a prefill with decode steps; under ``tp_fsdp``, one
    train step each of reduced recurrentgemma-2b (3 heads, 1 kv head, its
    RG-LRU gates blocked by 3 heads) and reduced qwen1.5-32b (3 heads, QKV
    biases), whose heads "model" does not divide.  The heads need both
    axes: with "data" of 1 no gradient over merged heads is split."""
    inputs, want = {}, {}
    vlm = _jax_pair("internvl2-76b", 21, vocab_size=VLM_VOCAB)
    rng = np.random.default_rng(22)
    n_vis = vlm[0].n_frontend_tokens
    batch = dict(_train_batch(vlm[0], seed=23),
                 vision_embeds=rng.standard_normal((4, n_vis, vlm[0].d_model))
                 .astype(np.float32))
    inputs.update({f"vlm/{k}": v for k, v in _paths_raw(vlm[2]).items()})
    inputs.update({f"vlm_batch/{k}": v for k, v in batch.items()})
    want["train_vlm"] = _jax_step(vlm[1], vlm[2], batch, 1)
    toks = _decode_inputs(vlm[0], seed=24)
    vision = rng.standard_normal((toks.shape[0], n_vis, vlm[0].d_model)).astype(np.float32)
    inputs.update({f"prefill_vlm/{k}": v for k, v in _paths_raw(vlm[2]).items()})
    inputs.update({"prefill_vlm_in/tokens": toks, "prefill_vlm_in/vision_embeds": vision})
    want["prefill_vlm"] = _jax_vlm_decode(vlm[1], jax.tree.map(jnp.asarray, vlm[2]), toks,
                                          vision, 6)

    for seed, (arch, case) in enumerate((("recurrentgemma-2b", "rg"),
                                         ("qwen1.5-32b", "qwen")), start=25):
        jcfg, jmodel, np_params = _jax_pair(arch, seed, **HEADS3[arch])
        hbatch = _train_batch(jcfg, seed=seed + 10)
        inputs.update({f"{case}/{k}": v for k, v in _paths_raw(np_params).items()})
        inputs.update({f"{case}_batch/{k}": v for k, v in hbatch.items()})
        want[f"train_{case}_heads"] = _jax_step(jmodel, np_params, hbatch, 1)

    inputs["meta"] = np.asarray(json.dumps({"opt": OPT, "prefill": 6, "vocab": VLM_VOCAB,
                                            "heads": HEADS3}))
    np.savez(tmp_path / "in.npz", **inputs)
    out = _run_two_ranks(tmp_path / "in.npz", tmp_path, "splice-heads", world=4)

    for name in ("train_vlm", "train_rg_heads", "train_qwen_heads"):
        _assert_step_close(*_step_outputs(out, name), want[name])
    np.testing.assert_allclose(out["prefill_vlm/logits"], want["prefill_vlm"], rtol=DEC_RTOL,
                               atol=DEC_ATOL)
    # (vocab, embed): the lookup under the splice is a partial sum over "model"
    assert str(out["prefill_vlm/table_placements"]) == "(Replicate(), Shard(dim=0))"
