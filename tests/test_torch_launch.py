"""The port's launch tooling vs the JAX reference's.

* ``launch/costmodel.py``: ``cell_costs`` equal to the reference's for
  every arch, shape, mesh ((1, 1), 16 x 16, 2 x 16 x 16, as stand-ins with
  a ``shape`` dict and a ``size``) and strategy, within relative 1e-12;
  ``specs.model_flops_for`` and ``_accum_for`` equal.
* The reference's scan-free probes (``tests/test_costmodel.py``): at
  world 1 and no mesh, the analytic FLOPs over the FLOPs of the port's
  step traced on fake tensors (``hlo.StepTrace``) within 0.85-1.2.
* ``hlo.Roofline``'s terms with the H100's constants and
  ``hlo.collective_stats`` over given records (the twins of
  ``tests/test_dryrun.py``'s roofline and parser tests).
* The custom ops of ``kernels/ops.py``: shape functions on fake tensors,
  the attention's FLOP formula, the scan's gradient.
* ``launch/dryrun.py`` in a subprocess (it brings up a fake process
  group, which this process never does): granite-moe-1b-a400m
  ``decode_32k`` and olmo-1b ``train_4k`` on the fake 256-rank mesh.
* ``launch/report.py``: the same records give byte-equal tables from
  both packages.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.distributed.axes import clear_logical_rules
from repro.launch import costmodel as JCM
from repro.launch import report as JREP
from repro.launch import specs as JSPECS
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.distributed import axes as AX
from repro_torch.kernels import ops
from repro_torch.launch import costmodel as CM
from repro_torch.launch import hlo as H
from repro_torch.launch import report as REP
from repro_torch.launch import specs as SPECS

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DRYRUN_TIMEOUT = 300
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    clear_logical_rules()
    AX.clear_logical_rules()
    yield
    clear_logical_rules()
    AX.clear_logical_rules()


class StandIn:
    """A mesh as both cost models read it: axis sizes and device count."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.size = int(np.prod(shape))


MESHES = [StandIn((1, 1), ("data", "model")), StandIn((16, 16), ("data", "model")),
          StandIn((2, 16, 16), ("pod", "data", "model"))]
STRATEGIES = ["tp", "tp_fsdp", "tp_fsdp_sp", "tp_fsdp_zero2", "tp_fsdp_uneven", "tp_serve",
              "tp_serve_hd", "tp_serve_sm", "dp_fsdp"]


def _close(a, b):
    return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))


# ------------------------------------------------------------- cost model
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_costs_equal_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    n = 0
    for name, cell in SHAPES.items():
        jcell = JSHAPES[name]
        assert SPECS.model_flops_for(cfg, cell) == JSPECS.model_flops_for(jcfg, jcell)
        for mesh in MESHES:
            accum = SPECS._accum_for(cfg, cell, mesh)
            assert accum == JSPECS._accum_for(jcfg, jcell, mesh), (name, mesh.shape)
            for strategy in STRATEGIES:
                for remat in ("full", "none"):
                    want = JCM.cell_costs(jcfg, jcell, mesh, strategy, remat, accum)
                    got = CM.cell_costs(cfg, cell, mesh, strategy, remat, accum)
                    where = (name, mesh.shape, strategy, remat)
                    for field in ("flops_per_device", "hbm_bytes_per_device",
                                  "collective_bytes_per_device", "global_flops"):
                        assert _close(getattr(got, field), getattr(want, field)), (field, where)
                    assert set(got.breakdown) == set(want.breakdown), where
                    for k, v in want.breakdown.items():
                        assert _close(got.breakdown[k], v), (k, where)
                    assert got.notes == want.notes, where
                    n += 1
    assert n == len(SHAPES) * len(MESHES) * len(STRATEGIES) * 2


BIG = dict(d_model=512, n_heads=8, n_kv_heads=8, d_head=64, d_ff=1536,
           vocab_size=8192)
PROBES = [
    ("olmo-1b", "train", 2, 512, dict(n_layers=1, **BIG), "none"),
    ("olmo-1b", "prefill", 2, 512, dict(n_layers=1, **BIG), "none"),
    ("olmo-1b", "decode", 4, 2048, dict(n_layers=1, **BIG), "none"),
    ("qwen3-32b", "train", 2, 512, dict(n_layers=1, **BIG), "none"),
    ("olmoe-1b-7b", "train", 2, 512, dict(n_layers=1, n_experts=8, top_k=2, **BIG), "none"),
    ("recurrentgemma-2b", "train", 2, 256, dict(n_layers=3, d_rnn=512, **BIG), "none"),
    ("seamless-m4t-large-v2", "train", 2, 512, dict(n_layers=1, n_enc_layers=1, **BIG), "none"),
    ("olmo-1b", "train", 2, 512, dict(n_layers=1, **BIG), "full"),
]


def _traced_flops(prog):
    trace = H.StepTrace()
    with prog.fake_mode:
        args = prog.placed_args()
        with trace:
            prog.fn(*args)
    return trace.flops


@pytest.mark.parametrize("arch,step,B,T,overrides,remat", PROBES,
                         ids=[f"{p[0]}-{p[1]}-{p[5]}" for p in PROBES])
def test_analytic_flops_close_to_traced(arch, step, B, T, overrides, remat):
    """The reference's scan-free probes, at world 1 with no mesh: the
    analytic count over the count of the port's step traced on fake
    tensors, in the reference's band (``tests/test_costmodel.py``)."""
    cfg = get_config(arch).reduced(**overrides)
    cell = ShapeCell(f"probe_{step}", step, T, B)
    prog = SPECS.build_cell(cfg, cell, None, strategy="tp", remat_policy=remat, accum=1,
                            device="cpu")
    ana = CM.cell_costs(cfg, cell, MESHES[0], "tp", remat, 1).flops_per_device
    r = ana / _traced_flops(prog)
    assert 0.85 < r < 1.2, f"{arch}/{step}/{remat}: analytic/traced = {r:.3f}"


# ------------------------------------------------------- roofline, collectives
def test_roofline_terms_h100():
    r = H.Roofline(flops=H.PEAK_FLOPS, hbm_bytes=H.HBM_BW / 2, collective_bytes=H.NVLINK_BW / 4,
                   n_chips=256, model_flops=H.PEAK_FLOPS * 256 * 0.5)
    assert (H.PEAK_FLOPS, H.HBM_BW, H.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(0.25)
    assert r.bottleneck == "compute"
    assert r.mfu_bound == pytest.approx(0.5)
    assert r.as_dict()["step_time_s"] == pytest.approx(1.0)


def test_collective_stats_of_records():
    records = [
        ("all_gather_into_tensor", (16, 1024), torch.bfloat16),
        ("wait_tensor", (16, 1024), torch.bfloat16),
        ("all_reduce", (512,), torch.float32),
        ("all_reduce", (2, 8), "float32"),
        ("reduce_scatter_tensor", (8, 8), torch.float32),
        ("collective-permute", (8, 8), torch.float32),
    ]
    st = H.collective_stats(records)
    assert st.count_by_op["all-gather"] == 1
    assert st.bytes_by_op["all-gather"] == 16 * 1024 * 2
    assert st.count_by_op["all-reduce"] == 2
    assert st.bytes_by_op["all-reduce"] == (512 + 16) * 4
    assert st.bytes_by_op["reduce-scatter"] == 8 * 8 * 4
    assert st.bytes_by_op["collective-permute"] == 8 * 8 * 4
    assert st.total_count == 5


# ------------------------------------------------------------- custom ops
def test_fake_tensors_take_the_shape_functions():
    """No plain loop runs on fake tensors: a 32768-step scan and a
    32768-key attention come back at once, the attention counted as
    4·B·Hq·D per live query-key pair and the scan as 0."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        a = torch.rand(2, 32768, 64)
        q, k = torch.randn(1, 4, 32768, 16), torch.randn(1, 2, 32768, 16)
        with FlopCounterMode(display=False) as fc:
            h = ops.linear_scan(a, a)
        assert isinstance(h, FakeTensor) and h.shape == a.shape and fc.get_total_flops() == 0
        with FlopCounterMode(display=False) as fc:
            o = ops.flash_attention(q, k, k, window=4096)
        assert o.shape == q.shape
        assert fc.get_total_flops() == 4 * 1 * 4 * 16 * ops.live_pairs(32768, 32768, True, 4096, 0)


@pytest.mark.parametrize("Tq,Tk,causal,window,q_offset", [
    (5, 9, True, None, 4), (5, 9, True, 3, 4), (7, 7, False, None, 0), (3, 10, False, 4, 2),
    (16, 16, True, 1, 0)])
def test_live_pairs_count_the_mask(Tq, Tk, causal, window, q_offset):
    want = sum(1 for i in range(Tq) for j in range(Tk)
               if (not causal or j <= q_offset + i) and (window is None or j > q_offset + i - window))
    assert ops.live_pairs(Tq, Tk, causal, window, q_offset) == want


def test_scan_custom_op_gradient_equals_the_plain_version():
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 9, 3, generator=g, dtype=torch.float64, requires_grad=True)
    x = torch.randn(2, 9, 3, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(2, 9, 3, generator=g, dtype=torch.float64)
    got = torch.autograd.grad((torch.ops.repro_torch.linear_scan(a, x) * w).sum(), (a, x))
    want = torch.autograd.grad((ref.ref_linear_scan(a, x) * w).sum(), (a, x))
    for gg, ww in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), ww.numpy(), rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------- dry run
def _dryrun(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
         "--mesh", "single", "--out", str(tmp_path), *args],
        env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out


def test_dryrun_decode_cell_subprocess(tmp_path):
    """granite-moe-1b-a400m ``decode_32k`` on the fake 16 x 16 mesh (the
    reference's ``test_dryrun_cell_subprocess``); its roofline is the
    reference's cost model at a 16 x 16 stand-in."""
    _dryrun(tmp_path, "--arch", "granite-moe-1b-a400m", "--shape", "decode_32k")
    rec = json.load(open(tmp_path / "granite-moe-1b-a400m_decode_32k_single_tp_serve.json"))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["roofline"]["n_chips"] == 256
    assert rec["roofline"]["step_time_s"] > 0
    want = JCM.cell_costs(jget_config("granite-moe-1b-a400m"), JSHAPES["decode_32k"],
                          MESHES[1], "tp_serve", "full", 1)
    assert rec["roofline"]["flops_per_device"] == pytest.approx(want.flops_per_device, rel=RTOL)
    assert rec["roofline"]["hbm_bytes_per_device"] == pytest.approx(want.hbm_bytes_per_device,
                                                                    rel=RTOL)
    assert rec["memory"]["argument_bytes"] > 0


def test_dryrun_train_cell_subprocess(tmp_path):
    """olmo-1b ``train_4k`` under ``tp_fsdp`` on the fake 16 x 16 mesh, one
    microbatch: its vocabulary is split over "model", so it reaches the
    repaired loss.  FSDP's all-gathers and reduce-scatters are recorded,
    and rank 0's traced FLOPs are the analytic per-device count within the
    reference's band (remat "none": the analytic "full" surcharge is
    calibrated to XLA's partial recompute, and torch recomputes the whole
    forward)."""
    _dryrun(tmp_path, "--arch", "olmo-1b", "--shape", "train_4k", "--accum", "1",
            "--remat", "none")
    rec = json.load(open(tmp_path / "olmo-1b_train_4k_single_tp_fsdp.json"))
    assert rec["status"] == "ok", rec.get("error")
    counts = rec["collectives_hlo"]["count_by_op"]
    assert counts.get("all-gather", 0) >= 1 and counts.get("reduce-scatter", 0) >= 1
    r = rec["roofline"]["flops_per_device"] / rec["cost_hlo_raw"]["flops"]
    assert 0.85 < r < 1.2, r


# ------------------------------------------------------------- report
def _records():
    roof = H.Roofline(flops=3e13, hbm_bytes=2e11, collective_bytes=5e10, n_chips=256,
                      model_flops=7e15).as_dict()
    ok = {"arch": "olmo-1b", "shape": "train_4k", "mesh": "single", "strategy": "tp_fsdp",
          "status": "ok", "compile_s": 9.87, "roofline": roof,
          "memory": {"argument_bytes": 64878600, "temp_bytes": 2 ** 34},
          "collectives_hlo": {"count_by_op": {"all-gather": 330, "reduce-scatter": 8,
                                              "all-reduce": 103}}}
    return [ok, dict(ok, mesh="multi"),
            {"arch": "olmo-1b", "shape": "long_500k", "mesh": "single", "status": "skipped",
             "reason": "full-attention arch: 500k decode is quadratic — skipped"},
            {"arch": "xlstm-350m", "shape": "train_4k", "mesh": "single",
             "strategy": "tp_fsdp", "status": "fail", "error": "NotImplementedError"},
            {"arch": "xlstm-350m", "shape": "prefill_32k", "mesh": "single",
             "strategy": "tp_serve", "status": "timeout", "error": "over 900 s"}]


def test_report_tables_equal_reference(tmp_path):
    recs = _records()
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert REP.load(str(tmp_path)) == JREP.load(str(tmp_path)) == recs
    assert REP.dryrun_table(recs) == JREP.dryrun_table(recs)
    assert REP.roofline_table(recs) == JREP.roofline_table(recs)
