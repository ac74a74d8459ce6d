"""A traced step's collectives and FLOPs, and the roofline terms.

The counterpart of ``repro.launch.hlo``, which reads a compiled XLA
module: ``cost_analysis()`` for its FLOPs and the optimized HLO text for
its collectives.  The port has no HLO.  What stands in for it is one run
of the step on fake tensors (``launch/dryrun.py``) under
:class:`StepTrace`, a dispatch mode that sees every aten op rank 0 runs on
its local shards and every ``c10d_functional`` collective DTensor
issues, each with its output's shape and dtype.  ``collective_stats``
sums those outputs per op as the reference sums HLO output shapes (the
first-order payload; a ring all-reduce moves 2(N-1)/N x of it), and
``cost_analysis_dict`` gives the per-device FLOP count.  Unlike XLA's
count, which sees a loop body once, the trace runs every iteration.

Hardware model (one NVIDIA H100 SXM, data sheet): 989e12 FLOP/s bf16
dense on the tensor cores, 67e12 FLOP/s float32 on the CUDA cores,
3.35e12 B/s HBM3, and NVLink 4 at 450e9 B/s each way per card.  A mesh
of more than the 8 cards of one node crosses InfiniBand (about 50 GB/s a
card at NDR 400 Gb/s), so there the collective term is optimistic; there
is no topology model, as the reference has none.
"""

from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s per card (tensor cores)
F32_FLOPS = 67e12        # float32 FLOP/s per card outside the tensor cores
HBM_BW = 3.35e12         # bytes/s per card
NVLINK_BW = 450e9        # bytes/s each way per card

# c10d_functional op -> the reference's HLO op name
_OP_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional")


def _dtype_bytes(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype, device="meta").element_size()


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())


def collective_stats(records: Iterable[Tuple[str, Tuple[int, ...], object]]) -> CollectiveStats:
    """Count and sum the output bytes of recorded collectives per op.

    ``records``: (op, output shape, dtype) triples, the op a
    ``c10d_functional`` name (``all_gather_into_tensor``, ...) or the
    reference's (``all-gather``, ...), the dtype a ``torch.dtype`` or
    its name.  ``wait_tensor`` is not a collective and is skipped, as
    the reference skips ``-done``.
    """
    st = CollectiveStats()
    for op, shape, dtype in records:
        if op == "wait_tensor":
            continue
        op = _OP_NAMES.get(op, op)
        n = 1
        for d in shape:
            n *= int(d)
        st.bytes_by_op[op] = st.bytes_by_op.get(op, 0) + n * _dtype_bytes(dtype)
        st.count_by_op[op] = st.count_by_op.get(op, 0) + 1
    return st


def _in_sharding_propagation() -> bool:
    """Whether DTensor is running an op on global-shape fake tensors to
    learn its output's metadata (not work any rank does)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


class StepTrace(TorchDispatchMode):
    """Rank 0's work in a step: FLOPs of its local ops, the collectives
    DTensor issues, and the peak of the storage its local ops allocate.

    An op on DTensors is passed on (``NotImplemented``), so DTensor runs
    it on the local shards, and those local ops come back through this
    mode: FLOPs are counted at local shapes (``torch.utils.flop_counter``'s
    formulas, and those the port registers), never at DTensor's global
    ones.  Ops that DTensor's sharding propagation runs at global shapes
    to learn an output's metadata are not counted.  Allocations are
    tracked by storage: bytes live since the trace began, and their peak.
    The storages of ``inputs`` (tensors) are not allocations: a view of an
    input (a stacked layer's slice, ``to_local``) or an input written in
    place allocates nothing.
    """

    def __init__(self, inputs=()) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.collectives: List[Tuple[str, Tuple[int, ...], torch.dtype]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}
        self._inputs = [t.untyped_storage() for t in inputs]   # alive while traced
        for st in self._inputs:
            self._storages[id(st)] = 0

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            # a tensor on the meta device (a shape asked for its axis names)
            # holds no bytes on any device; a fake tensor's own device is
            # the one it stands for, its storage's is always meta
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            self._storages[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.collectives.append((func._opname, tuple(t.shape), t.dtype))
            return out
        if _in_sharding_propagation():
            return out
        formula = self._registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            name = str(func._overloadpacket)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        self._track(out)
        return out


def cost_analysis_dict(trace: StepTrace) -> Dict[str, float]:
    """The per-device counts of a traced step, as the reference's
    ``cost_analysis_dict`` of a compiled module: ``flops`` (rank 0's local
    matrix products and attention; vector ops are not counted), and
    ``flops <op>`` for each op that has a share of it."""
    out = {"flops": float(trace.flops)}
    out.update({f"flops {op}": float(n) for op, n in sorted(trace.flops_by_op.items())})
    return out


@dataclass
class Roofline:
    """Three-term roofline for one step on one card."""

    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    collective_bytes: float      # per-device collective payload bytes
    n_chips: int
    model_flops: Optional[float] = None  # analytic 6*N*D (global)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / (per-device flops x cards)."""
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / (self.flops * self.n_chips)

    @property
    def mfu_bound(self) -> Optional[float]:
        """Model-FLOPs utilization at the roofline step time."""
        if self.model_flops is None:
            return None
        return self.model_flops / (self.n_chips * PEAK_FLOPS * self.step_time_s)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "n_chips": self.n_chips,
        }
