"""The port's whole dry-run matrix on the card machine: every arch x shape
x mesh, strategy ``auto``, one ``repro_torch.launch.dryrun`` process per
arch, all at once (each process brings up its own fake process groups),
then the report.

    python3 tools/dryrun_matrix.py [--out DIR]

Each process's log goes to ``DIR/<arch>.log``; the records (one JSON a
cell) to ``DIR``; the two tables of ``repro_torch.launch.report`` to
``DIR/report.md``.  Exits 1 if any cell failed or ran out of time.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import ARCH_IDS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "experiments", "dryrun_torch"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    t0 = time.time()
    procs = {}
    for arch in ARCH_IDS:
        with open(os.path.join(args.out, f"{arch}.log"), "w") as log:
            procs[arch] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--out", args.out], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    rcs = {}
    while len(rcs) < len(procs):
        time.sleep(1)
        for arch, p in procs.items():
            if arch not in rcs and p.poll() is not None:
                rcs[arch] = p.returncode
                print(f"{arch}: exit {p.returncode} at {time.time() - t0:.0f} s", flush=True)
    report = subprocess.run([sys.executable, "-m", "repro_torch.launch.report", args.out],
                            cwd=ROOT, env=env, capture_output=True, text=True, check=True).stdout
    with open(os.path.join(args.out, "report.md"), "w") as f:
        f.write(report)
    print(report)
    print(f"matrix: {time.time() - t0:.0f} s; exits {rcs}")
    return 1 if any(rcs.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
