"""Dry run of every (arch x shape x mesh) cell on fake tensors.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles
each cell for 512 fake XLA devices.  Here each cell brings up a process
group of the fake backend (``init_process_group("fake", store=FakeStore(),
rank=0, world_size=N)``: 256 ranks for ``single``, 512 for ``multi``),
lays ``launch/mesh.py::make_production_mesh`` over it (16 x 16, or
2 x 16 x 16), builds the cell (``launch/specs.py``) on fake tensors and
runs its step once as rank 0 under ``hlo.StepTrace``.  No kernel
launches and nothing is allocated: the kernels' custom ops give their
outputs' shapes (``kernels/ops.py``), and every collective DTensor issues
is recorded instead of run.

Each cell's record has the reference's schema, so that ``report.py``
tabulates the records of both packages alike:

* ``lower_s``: seconds to build the cell and lay its inputs on the mesh;
  ``compile_s``: seconds to trace the step (there is no compilation);
* ``memory.argument_bytes``: rank 0's local bytes of every input;
  ``memory.temp_bytes``: the peak of the fake storage the step's local
  ops held at once, beyond the inputs; ``memory.output_bytes``: rank 0's
  local bytes of the outputs, of which ``memory.alias_bytes`` are inputs
  updated in place;
* ``cost_hlo_raw``: the traced per-device counts (``flops``: rank 0's
  local products and attention, every loop iteration counted);
* ``collectives_hlo``: the collectives recorded, counted and summed by
  output bytes per op;
* ``analytic_breakdown``, ``analytic_notes`` and ``roofline``: the cost
  model (``launch/costmodel.py``) with the H100's constants.

A cell the port refuses is recorded as ``"status": "fail"`` with its
error, and ``main`` exits 1, as the reference's does.  A cell that runs
past its time limit (``CELL_TIMEOUT_S``) is recorded as ``"timeout"``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything, on the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch olmo-1b --shape train_4k --mesh single --accum 1
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import signal
import time
import traceback
from typing import Callable, Optional

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable
from repro_torch.launch import hlo as H
from repro_torch.launch.mesh import make_production_mesh

WORLD = {"single": 256, "multi": 512}        # ranks of make_production_mesh
CELL_TIMEOUT_S = 900


class CellTimeout(BaseException):
    """A cell ran past its time limit (a BaseException, so that no
    ``except Exception`` on the way swallows it)."""


def _local_tensors(tree):
    """Every tensor in ``tree`` as rank 0 holds it."""
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.distributed.partitioning import is_distributed

    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            yield t.to_local() if is_distributed(t) else t


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _alarm(signum, frame):
    raise CellTimeout()


def trace_cell(cfg, cell: ShapeCell, world_size: int, make_mesh: Callable, strategy: str,
               remat: str = "full", accum: Optional[int] = None,
               device: str = "cuda") -> dict:
    """Trace one cell as rank 0 of a fake group of ``world_size`` ranks,
    on the mesh ``make_mesh()`` lays over it; the record's measured fields
    (no ``status``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.costmodel import cell_costs
    from repro_torch.launch.specs import build_cell

    t0 = time.time()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        mesh = make_mesh()
        prog = build_cell(cfg, cell, mesh, strategy=strategy, remat_policy=remat,
                          accum=accum, device=device)
        trace = H.StepTrace()
        with prog.fake_mode:
            args = prog.placed_args()
            arg_bytes = sum(_nbytes(t) for t in _local_tensors(args))
            arg_storages = {id(t.untyped_storage()) for t in _local_tensors(args)}
            t_lower = time.time() - t0
            with trace:
                out = prog.fn(*args)
            t_trace = time.time() - t0 - t_lower
            out_storages = {id(t.untyped_storage()): _nbytes(t) for t in _local_tensors(out)}
        del args, out
        coll = H.collective_stats(trace.collectives)
        costs = cell_costs(cfg, cell, mesh, strategy, remat, prog.accum)
        roof = H.Roofline(
            flops=costs.flops_per_device,
            hbm_bytes=costs.hbm_bytes_per_device,
            collective_bytes=costs.collective_bytes_per_device,
            n_chips=world_size,
            model_flops=prog.model_flops,
        )
        return {
            "accum": prog.accum,
            "lower_s": round(t_lower, 2),
            "compile_s": round(t_trace, 2),
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": sum(out_storages.values()),
                "temp_bytes": trace.peak_bytes,
                "alias_bytes": sum(b for k, b in out_storages.items() if k in arg_storages),
            },
            "cost_hlo_raw": H.cost_analysis_dict(trace),
            "collectives_hlo": {
                "bytes_by_op": coll.bytes_by_op,
                "count_by_op": coll.count_by_op,
                "note": "rank 0's collectives as DTensor issued them, every loop iteration",
            },
            "analytic_breakdown": {k: float(v) for k, v in costs.breakdown.items()},
            "analytic_notes": costs.notes,
            "roofline": roof.as_dict(),
        }
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, mesh_kind: str, strategy: str,
             out_dir: str, remat: str = "full", accum=None,
             moe_group=None, tag_suffix: str = "", device: str = "cuda",
             timeout_s: int = CELL_TIMEOUT_S) -> dict:
    cfg = get_config(arch)
    if moe_group is not None:
        cfg = dataclasses.replace(cfg, moe_group=moe_group)
    cell = SHAPES[shape_name]
    ok, why = applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    if strategy == "auto":
        # training wants ZeRO-3 (params would not fit replicated across DP);
        # serving keeps params TP-sharded and resident (an FSDP all-gather
        # per decoded token would drown the step in collectives) and shards
        # the KV cache over kv_heads or, failing divisibility, seq
        strategy = "tp_fsdp" if cell.step == "train" else "tp_serve"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "strategy": strategy, "remat": remat}
    t0 = time.time()
    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(timeout_s)
    try:
        make = functools.partial(make_production_mesh, multi_pod=mesh_kind == "multi",
                                 device=device)
        rec.update(trace_cell(cfg, cell, WORLD[mesh_kind], make, strategy, remat, accum, device))
        rec["status"] = "ok"
        roof = rec["roofline"]
        print(f"[ok] {arch} {shape_name} {mesh_kind} {strategy}: "
              f"build {rec['lower_s']:.1f}s trace {rec['compile_s']:.1f}s "
              f"bottleneck={roof['bottleneck']} step={roof['step_time_s']*1e3:.2f}ms "
              f"mfu_bound={roof['mfu_bound'] if roof['mfu_bound'] is None else round(roof['mfu_bound'], 3)}",
              flush=True)
    except CellTimeout:
        rec.update({"status": "timeout", "error": f"over {timeout_s} s",
                    "seconds": round(time.time() - t0, 2)})
        print(f"[TIMEOUT] {arch} {shape_name} {mesh_kind} {strategy}: over {timeout_s} s",
              flush=True)
    except Exception as e:  # a failure here is a refusal or a bug of the port
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}"[:2000],
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[FAIL] {arch} {shape_name} {mesh_kind} {strategy}: "
              f"{type(e).__name__}: {str(e)[:300]}", flush=True)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{mesh_kind}_{strategy}{tag_suffix}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default=None, choices=["single", "multi", None])
    ap.add_argument("--strategy", default="auto")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--moe-group", type=int, default=None)
    ap.add_argument("--tag-suffix", default="")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    results = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                results.append(run_cell(arch, shape, mesh_kind, args.strategy,
                                        args.out, args.remat, args.accum,
                                        args.moe_group, args.tag_suffix, args.device))
    n = {s: sum(r["status"] == s for r in results) for s in ("ok", "skipped", "fail", "timeout")}
    print(f"\ndry-run: {n['ok']} ok / {n['skipped']} skipped / {n['fail']} FAILED / "
          f"{n['timeout']} TIMEOUT of {len(results)} cells")
    if n["fail"] or n["timeout"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
