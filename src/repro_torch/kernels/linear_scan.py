"""CUDA kernel for the diagonal linear recurrence ``h_t = a_t h_{t-1} + x_t``.

Replaces ``repro/kernels/linear_scan.py::linear_scan_pallas``.  The
kernel (``csrc/linear_scan.cu``) keeps each (batch, channel) a sequential
chain over time, so it is bit-identical to its plain version
``repro_torch.kernels.ref.ref_linear_scan``.  It is bound by HBM traffic
at 12 bytes per element (read a, read x, write h); to keep enough of
those bytes in flight, each warp owns 32 consecutive channels and streams
time through a six-stage ring of 32-step chunks in shared memory, filled
by ``cp.async`` while the chain runs over the chunk before.  Any B <=
65535, T and D: a ragged channel tile or last chunk is masked, nothing is
padded and the input is never copied.

``launches`` counts the kernel's launches, and nothing else; a run reads
it to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
_MAX_GRID_Y = 65535

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("linear_scan").linear_scan_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.ndim != 3 or a.shape != x.shape:
        raise ValueError(f"linear_scan: a and x must be (B, T, D) of one shape, "
                         f"got {tuple(a.shape)} and {tuple(x.shape)}")
    if a.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"linear_scan: float32 only, got {a.dtype} and {x.dtype}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("linear_scan: a and x must be contiguous")
    if a.device.type != "cuda" or x.device != a.device:
        raise ValueError(f"linear_scan: the kernel takes CUDA tensors on one device, "
                         f"got {a.device} and {x.device}")
    if a.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"linear_scan: batch {a.shape[0]} exceeds {_MAX_GRID_Y}")


def linear_scan_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x: (B, T, D) float32 contiguous CUDA tensors -> h: (B, T, D)."""
    global launches
    _check(a, x)
    fn = _kernel()
    h = torch.empty_like(a)
    B, T, D = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), x.data_ptr(), h.data_ptr(), B, T, D, stream)
    if err != 0:
        raise RuntimeError(f"linear_scan: kernel launch failed with CUDA error {err}")
    launches += 1
    return h
