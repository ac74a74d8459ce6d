"""The dry run of the serving cells whose mesh path once failed in the
port, each in a subprocess at full width on fake tensors over
the fake 256- or 512-rank mesh (``python -m repro_torch.launch.dryrun``),
each ``ok``.  One cell a class of fault, the cheapest (the training cells
are in ``test_torch_dryrun_train.py``):

* the decode step's lookup on 2 x 16 x 16 (olmo-1b ``decode_32k``);
* the MoE FFN's dispatch and combine over split experts (olmoe-1b-7b
  ``prefill_32k``);
* xLSTM under a mesh (xlstm-350m ``decode_32k``);
* the VLM splice after a vocab-split lookup (internvl2-76b
  ``prefill_32k``);
* serving the encoder-decoder, its stacked memories placed on the mesh
  (seamless-m4t-large-v2 ``prefill_32k``).

Where heads, kv heads and vocabulary all divide the axes, rank 0's traced
FLOPs are held to the analytic per-device count within 0.85-1.2
(``tests/test_costmodel.py``'s band).

Three cells run under a named strategy, each one the port once refused
(``STRATEGY_CELLS``): qwen1.5-32b ``prefill_32k`` under
``tp_serve_uneven`` (40 heads split unevenly over 16 ranks: traced FLOPs
at most 1.3 x the analytic count, which counts the padded split), and the
``decode_32k`` of qwen1.5-32b and recurrentgemma-2b under ``tp_serve_hd``
(the caches split on their head dimension: no cache gathered, under 1 GiB
of all-gathers a device, and nothing beyond the inputs but 1 GiB).

One reduced cell traces a step past 4096 kv positions on a split
sequence as two ranks of a fake 2 x 2 mesh: each rank's attention FLOPs
follow its own ``q_offset`` (``test_long_sp_train_flops_follow_q_offset``).
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DRYRUN_TIMEOUT = 300
BAND = (0.85, 1.2)

CELLS = [
    # arch, shape, mesh, extra flags, strategy of the record, FLOPs held to the band
    ("olmo-1b", "decode_32k", "multi", (), "tp_serve", True),
    ("olmoe-1b-7b", "prefill_32k", "single", (), "tp_serve", True),
    ("xlstm-350m", "decode_32k", "single", (), "tp_serve", False),
    ("internvl2-76b", "prefill_32k", "single", (), "tp_serve", False),
    ("seamless-m4t-large-v2", "prefill_32k", "single", (), "tp_serve", True),
]


def _dryrun(tmp_path, arch, shape, mesh, *flags):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(tmp_path), *flags],
        env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def _record(tmp_path, arch, shape, mesh, strategy):
    return json.load(open(tmp_path / f"{arch}_{shape}_{mesh}_{strategy}.json"))


@pytest.mark.parametrize("arch,shape,mesh,flags,strategy,in_band", CELLS,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CELLS])
def test_repaired_cell_traces(tmp_path, arch, shape, mesh, flags, strategy, in_band):
    _dryrun(tmp_path, arch, shape, mesh, *flags)
    rec = _record(tmp_path, arch, shape, mesh, strategy)
    assert rec["status"] == "ok", rec.get("error")
    if in_band:
        r = rec["cost_hlo_raw"]["flops"] / rec["roofline"]["flops_per_device"]
        assert BAND[0] < r < BAND[1], r



GIB = 2 ** 30
STRATEGY_CELLS = [
    # arch, shape, strategy, most traced / analytic FLOPs, most temp GiB, most all-gather GiB
    ("qwen1.5-32b", "prefill_32k", "tp_serve_uneven", 1.3, None, None),
    ("qwen1.5-32b", "decode_32k", "tp_serve_hd", None, 1.0, 1.0),
    ("recurrentgemma-2b", "decode_32k", "tp_serve_hd", None, 1.0, 1.0),
]


@pytest.mark.parametrize("arch,shape,strategy,flops_ratio,temp_gib,gather_gib", STRATEGY_CELLS,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in STRATEGY_CELLS])
def test_strategy_cell_traces(tmp_path, arch, shape, strategy, flops_ratio, temp_gib,
                              gather_gib):
    """The cell on 16 x 16 under ``strategy``, ``ok``, within its bounds:
    rank 0's traced FLOPs over the analytic count, the temporaries beyond
    the inputs (the caches are inputs, written in place), and the bytes
    all-gathered (a gathered qwen1.5-32b cache is 40 GiB a layer and step
    under ``tp_serve``)."""
    _dryrun(tmp_path, arch, shape, "single", "--strategy", strategy)
    rec = _record(tmp_path, arch, shape, "single", strategy)
    assert rec["status"] == "ok", rec.get("error")
    if flops_ratio is not None:
        r = rec["cost_hlo_raw"]["flops"] / rec["roofline"]["flops_per_device"]
        assert r <= flops_ratio, r
    if temp_gib is not None:
        assert rec["memory"]["temp_bytes"] <= temp_gib * GIB, rec["memory"]
    if gather_gib is not None:
        gathered = rec["collectives_hlo"]["bytes_by_op"].get("all-gather", 0)
        assert gathered <= gather_gib * GIB, rec["collectives_hlo"]


def test_step_trace_does_not_count_meta_tensors():
    """A tensor built on the meta device inside the trace (the encoder-
    decoder asks ``memories_axes_for`` for names with one, at the stack's
    global shape) holds no bytes: the peak counts only the fake tensors
    that stand for the device's buffers."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import hlo as H

    with FakeTensorMode():
        trace = H.StepTrace()
        with trace:
            big = torch.empty((24, 32, 16, 32768, 64), device="meta")
            small = torch.empty((1024, 256))
        assert big.device.type == "meta"
    assert trace.peak_bytes == small.numel() * small.element_size()


def test_seamless_prefill_temporaries_leave_out_the_meta_shape(tmp_path):
    """seamless-m4t-large-v2 ``prefill_32k`` on 16 x 16: its temporaries a
    device stay under 3 GiB (1.5 GiB traced; 96 GiB while the meta tensor
    of ``encdec.cross_memories`` was counted)."""
    _dryrun(tmp_path, "seamless-m4t-large-v2", "prefill_32k", "single")
    rec = _record(tmp_path, "seamless-m4t-large-v2", "prefill_32k", "single", "tp_serve")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["temp_bytes"] <= 3 * GIB, rec["memory"]


LONG_SP_SCRIPT = """
import dataclasses, functools, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import make_mesh
cfg = dataclasses.replace(get_config("h2o-danube-3-4b").reduced(), window=4096)
rec = trace_cell(cfg, ShapeCell("train_4160", "train", 4160, 1), 4,
                 functools.partial(make_mesh, (2, 2), ("data", "model"), device="cpu"),
                 "tp_fsdp_sp", remat="none", accum=1, device="cpu", rank=int(sys.argv[1]))
json.dump(rec, sys.stdout)
"""


def test_long_sp_train_flops_follow_q_offset():
    """A reduced h2o-danube3-4b step at 4160 tokens (its window of 4096)
    under ``tp_fsdp_sp`` with a batch of 1, traced on fake tensors over a
    fake 2 x 2 mesh as rank 0 and as rank 2: each rank holds 2080 q rows
    of 2 heads over the whole 4160 keys, and the recorded attention's FLOPs
    are those of its own rows' live pairs, at its ``q_offset`` (0 and
    2080): 4 D a pair forward, 8 D backward, for each of the 2 layers."""
    from repro_torch.kernels.ops import live_pairs

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    procs = {rank: subprocess.Popen([sys.executable, "-c", LONG_SP_SCRIPT, str(rank)], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                    cwd=ROOT)
             for rank in (0, 2)}       # one fake group a process
    recs = {}
    for rank, p in procs.items():
        out, err = p.communicate(timeout=DRYRUN_TIMEOUT)
        assert p.returncode == 0, err[-3000:]
        recs[rank] = json.loads(out)
    for rank, q_offset in ((0, 0), (2, 2080)):
        flops = recs[rank]["cost_hlo_raw"]
        pairs = 2 * live_pairs(2080, 4160, causal=True, window=4096, q_offset=q_offset)
        assert flops["flops repro_torch.flash_attention"] == 4 * 2 * 16 * pairs
        assert flops["flops repro_torch.flash_attention_backward"] == 8 * 2 * 16 * pairs
    # the second half's rows see the whole window: more pairs than the first's
    assert live_pairs(2080, 4160, causal=True, window=4096, q_offset=2080) > \
        live_pairs(2080, 4160, causal=True, window=4096, q_offset=0)
