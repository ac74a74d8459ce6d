"""The port's copy of the scenario library (``repro_torch.core.scenarios``)
against the reference's: every scenario of ``SCENARIOS`` at 16 clients,
seed 1, gives the same trace digest, the same per-client results and RPC
counters, and the same throughput figures from both packages (the wall
time aside).  ``train_serve`` checkpoints its numpy model state through
each package's own ``BlobCheckpointer``."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import scenarios as JSC
from repro.distributed.axes import clear_logical_rules
from repro_torch.core import scenarios as SC
from repro_torch.distributed import axes as AX

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    clear_logical_rules()
    AX.clear_logical_rules()
    yield
    clear_logical_rules()
    AX.clear_logical_rules()


def test_same_scenario_names():
    assert list(SC.SCENARIOS) == list(JSC.SCENARIOS)


def _figures(res):
    """Every field of a ``ScenarioResult`` (throughput, makespan, RPCs,
    client results, digest) but the wall time."""
    return {k: v for k, v in dataclasses.asdict(res).items() if k != "wall_seconds"}


@pytest.mark.parametrize("name", list(JSC.SCENARIOS))
def test_scenario_equal_to_reference(name):
    want = JSC.run_scenario(name, n_clients=16, seed=1)
    got = SC.run_scenario(name, n_clients=16, seed=1)
    assert got.trace_digest == want.trace_digest
    assert _figures(got) == _figures(want)
