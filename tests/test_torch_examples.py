"""The port's twins of the two examples that drive the JAX stack,
``examples/train_e2e_torch.py`` and ``examples/branch_experiments_torch.py``,
on the CPU at a few steps: the crash-and-resume run's losses after the
crash equal an uninterrupted run's bit for bit, a fork adds no data page
to the store, and the trunk restores byte-equal after branching."""

import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

from repro.distributed.axes import clear_logical_rules
from repro_torch.checkpoint.blobckpt import flatten_with_paths
from repro_torch.distributed import axes as AX

torch.set_num_threads(2)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")
ARGS = ["--device", "cpu", "--steps", "12", "--ckpt-every", "3"]


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    clear_logical_rules()
    AX.clear_logical_rules()
    yield
    clear_logical_rules()
    AX.clear_logical_rules()


def _example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_e2e_resumes_bit_identically():
    ex = _example("train_e2e_torch")
    crashed = ex.main(ARGS + ["--crash-at", "6"])
    straight = ex.main(ARGS + ["--crash-at", "12"])
    assert crashed["resumed_at"] == 6 and straight["resumed_at"] == 12
    assert sorted(crashed["losses"]) == sorted(straight["losses"]) == list(range(12))
    assert [crashed["losses"][s] for s in range(6, 12)] == \
        [straight["losses"][s] for s in range(6, 12)]
    assert [s for _, s in crashed["lineage"]] == [3, 6, 9, 12]


def test_branches_share_pages_and_the_trunk_restores():
    out = _example("branch_experiments_torch").main(["--device", "cpu"])
    for name, b in out["branches"].items():
        # the fork copies nothing; 40 AdamW steps then move every parameter
        # and moment (the tied embedding gives every row a gradient), so the
        # branch's save writes each of its pages once
        assert b["fork_pages"] == 0, name
        assert 0 < b["pages_written"] <= b["pages_total"], name
        assert [s for _, s in b["lineage"]][-1] == 80, name
    assert out["branches"]["branch-lowlr"]["losses"] != out["branches"]["branch-highlr"]["losses"]
    trunk, restored = out["trunk"]["state"], out["trunk_restored"]
    pairs = list(zip(flatten_with_paths(trunk), flatten_with_paths(restored)))
    assert pairs and all(ka == kb and torch.equal(a, b) for (ka, a), (kb, b) in pairs)
    assert out["trunk_elements"] == sum(t.numel() for _, t in flatten_with_paths(trunk))
