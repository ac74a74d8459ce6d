"""The port's boundary: it imports neither JAX nor the JAX package, and
its copies of the reference's numpy-only modules stay copies.

The storage planes (``core/``, ``store/``), the numpy page digest and
the corpus pipeline are kept in ``repro_torch`` as copies of the
reference's files with only their ``repro.`` import lines pointed at
``repro_torch.``; a checkpoint written by one package restores in the
other only while both write the same blob layout, WAL records and page
bytes, so any other edit fails here.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

COPIED = [f"core/{n}.py" for n in (
    "__init__", "sim", "transport", "pages", "placement", "dht", "segment_tree", "cache",
    "dedup_index", "provider", "version_manager", "blob", "service", "gc", "membership",
    "durability")] + [
    "store/__init__.py", "store/memory.py", "store/file.py", "store/s3.py",
    "kernels/hostdigest.py", "data/pipeline.py", "core/scenarios.py", "configs/shapes.py",
    "launch/report.py"]

_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib", "repro")
             or m.startswith(("jax.", "jaxlib.", "repro.")))
print(len([m for m in sys.modules if m.startswith("repro_torch")]), bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{ROOT}")
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules > 30, r.stdout      # every module of the port was imported


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_reference_up_to_imports(rel):
    ref = (SRC / "repro" / rel).read_text()
    want = "".join(_IMPORT.sub(r"\1repro_torch.", line)
                   for line in ref.splitlines(keepends=True))
    assert (SRC / "repro_torch" / rel).read_text() == want
