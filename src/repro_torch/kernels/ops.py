"""Public kernel API of the port, dispatched by the tensor's device.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a CUDA
tensor goes to the hand-written kernel, which launches or raises.  There
is no switch and no fallback: the card always runs the kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import linear_scan as _ls
from repro_torch.kernels import ref as _ref


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t over (B, T, D), with h_{-1} = 0."""
    if a.device.type == "cpu":
        return _ref.ref_linear_scan(a, x)
    return _ls.linear_scan_cuda(a, x)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"linear_scan": _ls.launches}


def reset_launch_counts() -> None:
    _ls.launches = 0
