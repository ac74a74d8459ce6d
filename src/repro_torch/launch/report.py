"""Generate EXPERIMENTS.md tables from dry-run artifacts.

    PYTHONPATH=src python -m repro.launch.report experiments/dryrun
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List


def load(dirpath: str) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        recs.append(json.load(open(p)))
    return recs


def fmt_bytes(x) -> str:
    if x is None:
        return "-"
    return f"{x/2**30:.2f}"


def dryrun_table(recs: List[Dict]) -> str:
    out = ["| arch | shape | mesh | strategy | status | compile_s | HBM args+temp (GiB/dev) | HLO collectives (count) |",
           "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | "
                       f"skipped ({r['reason'][:40]}…) | - | - | - |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r.get('strategy','-')} | **FAIL** | - | - | - |")
            continue
        mem = r["memory"]
        hbm = (mem.get("argument_bytes") or 0) + (mem.get("temp_bytes") or 0)
        coll = r["collectives_hlo"]["count_by_op"]
        coll_s = " ".join(f"{k.split('-')[-1]}:{v}" for k, v in sorted(coll.items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['strategy']} | ok "
            f"| {r['compile_s']} | {hbm/2**30:.1f} | {coll_s} |")
    return "\n".join(out)


def roofline_table(recs: List[Dict]) -> str:
    out = ["| arch | shape | strategy | compute (ms) | memory (ms) | collective (ms) | bottleneck | step (ms) | MODEL_FLOPS | useful frac | MFU bound |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok" or r["mesh"] != "single":
            continue
        rf = r["roofline"]
        uf = rf.get("useful_flops_fraction")
        mfu = rf.get("mfu_bound")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['strategy']} "
            f"| {rf['compute_s']*1e3:.2f} | {rf['memory_s']*1e3:.2f} "
            f"| {rf['collective_s']*1e3:.2f} | **{rf['bottleneck']}** "
            f"| {rf['step_time_s']*1e3:.2f} | {rf['model_flops']:.2e} "
            f"| {uf:.2f} | {mfu if mfu is None else round(mfu,3)} |")
    return "\n".join(out)


def main() -> None:
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"
    recs = load(d)
    print("## Dry-run matrix\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16x16)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
