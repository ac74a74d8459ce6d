"""Test isolation: fresh Hypothesis draws, and the JAX reference's
thread-local sharding rules cleared before every test.

Hypothesis saves every falsifying example in ``.hypothesis/`` and replays
it first in each later run from the same directory, so one failed draw
of a property test would decide every later run on that checkout.  The
profile loaded here turns that database off: each run draws its own
examples.  No test's ``max_examples``, deadline or seed changes.

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

try:
    from hypothesis import settings as _hypothesis_settings
except ImportError:    # the property tests fall back to fixed seeds
    pass
else:
    _hypothesis_settings.register_profile("fresh-draws", database=None)
    _hypothesis_settings.load_profile("fresh-draws")


@pytest.fixture(autouse=True)
def _clear_leaked_logical_rules():
    axes = sys.modules.get("repro.distributed.axes")
    if axes is not None:
        axes.clear_logical_rules()
    yield
