"""Test isolation for the JAX reference's thread-local sharding rules.

``repro.train.step.TrainStepBuilder`` activates logical-axis rules with
``repro.distributed.axes.set_logical_rules`` inside its step functions
and never clears them, so a test that builds a train or serve step
leaves them active for every later test in the same process.  There,
with this jax's Explicit mesh axes, each ``constrain`` call raises.
Under ``pytest-xdist --dist loadfile`` which test files share a worker,
and in what order, depends on timing, so such a leak makes tests that
pass alone fail at random.  Clearing the rules before every test makes
each test start from the state it would have alone.
"""

import sys

import pytest


@pytest.fixture(autouse=True)
def _clear_leaked_logical_rules():
    axes = sys.modules.get("repro.distributed.axes")
    if axes is not None:
        axes.clear_logical_rules()
    yield
