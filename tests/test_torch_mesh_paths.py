"""The port's mesh paths that once raised, vs the JAX reference.

Each of these ran under a mesh in the reference and raised, or failed in
DTensor, in the port before:

* ``generate(mesh=...)``: greedy tokens of reduced h2o-danube3-4b under
  ``tp_serve_sm`` at world 1 (a one-rank gloo group) equal the
  reference's ``generate`` with no mesh (``src/repro/launch/serve.py``);
* the decode step's lookup through ``layers.embed_lookup``, held to the
  reference's decode at world 1;
* two gloo ranks (``torch_mesh_worker.py paths``): reduced
  granite-moe-1b-a400m training on (1, 2), its experts split, and on
  (2, 1) (``src/repro/models/moe.py:76-83``), reduced xlstm-350m training
  on (1, 2), the reduced encoder-decoder's prefill and decode steps on
  (1, 2), its memories split by kv heads, and ``generate`` on (1, 2);
* ``launch.train --mesh 2x1 --resume-blob`` under
  ``torch.distributed.run``: the resumed losses equal the uninterrupted
  run's bit for bit (``src/repro/launch/train.py:113-128``).

Tolerances are those of ``test_torch_distributed.py``: loss and gradients
1e-5, AdamW moments 1e-6, parameters rtol 5e-4, decode logits rtol 2e-4
atol 2e-5, greedy tokens equal.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.launch.serve import generate as jgenerate
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import generate
from repro_torch.models import build_model
from test_torch_distributed import (DEC_ATOL, DEC_RTOL, OPT, _assert_step_close,
                                    _decode_inputs, _encdec_inputs, _free_port, _jax_decode,
                                    _jax_encdec_decode, _jax_step, _LookupSpy, _paths_raw,
                                    _port_decode, _run_two_ranks, _step_outputs, _train_batch)
# fixtures: the one-rank gloo group, and the rules cleared around each test
from test_torch_distributed import _no_leaked_axis_rules, group  # noqa: F401

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
SERVE_ARCH = "h2o-danube-3-4b"
XLSTM_BLOCKS = ("mlstm", "slstm")
LAUNCHER_TIMEOUT = 300


def _jax_pair(arch, seed, **over):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **over)
    jmodel = jbuild_model(jcfg)
    np_params = jax.tree.map(np.asarray, jax.jit(lambda r: jmodel.init(r)[0])(
        jax.random.PRNGKey(seed)))
    return jcfg, jmodel, np_params


def _prompts(cfg, B=2, T=7, seed=11):
    return list(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T))
                .astype(np.int32))


MAX_NEW = 5


def test_generate_under_a_mesh_matches_reference(group):
    """``generate(..., mesh=group, strategy="tp_serve_sm")`` at world 1:
    the reference's greedy tokens (its ``generate`` with no mesh)."""
    jcfg, jmodel, np_params = _jax_pair(SERVE_ARCH, 12)
    prompts = _prompts(jcfg)
    want = jgenerate(jmodel, jax.tree.map(jnp.asarray, np_params), prompts, max_new=MAX_NEW,
                     max_len=len(prompts[0]) + MAX_NEW)
    cfg = get_config(SERVE_ARCH).reduced()
    got = generate(build_model(cfg), params_from_jax(np_params, cfg, device="cpu"), prompts,
                   max_new=MAX_NEW, max_len=len(prompts[0]) + MAX_NEW, device="cpu",
                   mesh=group, strategy="tp_serve_sm")
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_mesh_decode_lookup_matches_reference(group, monkeypatch):
    """``tp_serve`` prefill and decode of reduced olmo-1b at world 1
    against the reference on one device; each decode step looks its token
    up through ``layers.embed_lookup`` (``F.embedding`` on a vocab-split
    table: DTensor of some torch versions has no rule for the raw index on
    a batch split over two mesh axes), as the prefill does."""
    jcfg, jmodel, np_params = _jax_pair("olmo-1b", 7)
    toks = _decode_inputs(jcfg)
    want = _jax_decode(jmodel, jax.tree.map(jnp.asarray, np_params), toks, 6)
    cfg = get_config("olmo-1b").reduced()
    spy = _LookupSpy(monkeypatch)
    spy.on = True
    got = _port_decode(cfg, params_from_jax(np_params, cfg, "cpu"), toks, 6, group, "tp_serve")
    assert spy.calls == toks.shape[1] - 6 + 1       # the prefill and every decode step
    np.testing.assert_allclose(got, want, rtol=DEC_RTOL, atol=DEC_ATOL)


def test_two_ranks_mesh_paths_match_reference(tmp_path):
    """``torch_mesh_worker.py paths`` on two gloo ranks, each case against
    the reference on one device: the MoE train step with its experts split
    over "model" (1, 2) and under fsdp (2, 1), the xLSTM train step on
    (1, 2), the encoder-decoder's prefill and decode steps on (1, 2) (its
    stacked memories split by kv heads), and greedy ``generate``."""
    inputs, want = {}, {}
    moe = _jax_pair("granite-moe-1b-a400m", 13)
    batch = _train_batch(moe[0], seed=14)
    inputs.update({f"moe/{k}": v for k, v in _paths_raw(moe[2]).items()})
    inputs.update({f"moe_batch/{k}": v for k, v in batch.items()})
    want["moe"] = _jax_step(moe[1], moe[2], batch, 1)

    xl = _jax_pair("xlstm-350m", 15, block_pattern=XLSTM_BLOCKS, n_layers=len(XLSTM_BLOCKS))
    xbatch = _train_batch(xl[0], T=12, seed=16)
    inputs.update({f"xlstm/{k}": v for k, v in _paths_raw(xl[2]).items()})
    inputs.update({f"xlstm_batch/{k}": v for k, v in xbatch.items()})
    want["xlstm"] = _jax_step(xl[1], xl[2], xbatch, 1)

    ed = _jax_pair("seamless-m4t-large-v2", 17)
    frames, toks = _encdec_inputs(ed[0])
    inputs.update({f"serve_encdec/{k}": v for k, v in _paths_raw(ed[2]).items()})
    inputs.update({"serve_encdec_in/frames": frames, "serve_encdec_in/tokens": toks})
    want["encdec"] = _jax_encdec_decode(ed[1], jax.tree.map(jnp.asarray, ed[2]), frames, toks, 5)

    dn = _jax_pair(SERVE_ARCH, 18)
    prompts = _prompts(dn[0], seed=19)
    inputs.update({f"generate/{k}": v for k, v in _paths_raw(dn[2]).items()})
    inputs["generate_in/prompts"] = np.stack(prompts)
    want["generate"] = np.stack(jgenerate(dn[1], jax.tree.map(jnp.asarray, dn[2]), prompts,
                                          max_new=MAX_NEW, max_len=len(prompts[0]) + MAX_NEW))

    inputs["meta"] = np.asarray(json.dumps({"opt": OPT, "prefill": 5, "max_new": MAX_NEW,
                                            "xlstm_blocks": list(XLSTM_BLOCKS)}))
    np.savez(tmp_path / "in.npz", **inputs)
    out = _run_two_ranks(tmp_path / "in.npz", tmp_path, "paths")

    for name in ("train_moe_tp", "train_moe_fsdp"):
        _assert_step_close(*_step_outputs(out, name), want["moe"])
    _assert_step_close(*_step_outputs(out, "train_xlstm"), want["xlstm"])
    np.testing.assert_allclose(out["serve_encdec/logits"], want["encdec"], rtol=DEC_RTOL,
                               atol=DEC_ATOL)
    # a stacked memory is (layers, batch, kv_heads, frames, head)
    assert str(out["serve_encdec/memories_placements"]) == "(Replicate(), Shard(dim=2))"
    np.testing.assert_array_equal(out["generate/tokens"], want["generate"])


def test_launch_train_resumes_under_a_mesh(tmp_path):
    """``launch.train --mesh 2x1 --strategy tp_fsdp --device cpu`` under
    ``torch.distributed.run``: 3 steps spooled, then ``--resume-blob`` from
    that spool to step 6 (rank 0 restores the deployment and reads the
    checkpoint whole, ``distribute_state`` scatters it), against 6 steps
    uninterrupted: the resumed losses equal, bit for bit."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"))
    out = tmp_path / "losses.json"
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "localhost", "--master-port", str(_free_port()),
         os.path.join(HERE, "torch_mesh_worker.py"), "train-resume", str(out),
         str(tmp_path / "spool"), "--device", "cpu", "--ckpt-every", "3", "--seq", "32",
         "--batch", "4", "--quiet", "--mesh", "2x1", "--strategy", "tp_fsdp"],
        env=env, capture_output=True, text=True, timeout=LAUNCHER_TIMEOUT)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    got = json.loads(out.read_text())
    assert len(got["whole"]) == 6 and got["first"] == got["whole"][:3]
    assert got["resumed"] == got["whole"][3:]
