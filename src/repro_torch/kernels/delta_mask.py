"""CUDA kernel for the changed-page mask of two digest tables.

Replaces ``repro/kernels/delta_mask.py::delta_mask_pallas``.  The kernel
(``csrc/delta_mask.cu``) runs one thread per row and writes the
``torch.bool`` result itself, True where the row's two digests differ;
it moves 17 bytes a row and is bound by its launch, so a call is one
launch and a thin host path: the library is bound once, and the launch
takes the current stream of the tensors' device without a device guard
when that device is the current one.  Its plain version is
``repro_torch.kernels.ref.ref_delta_mask``.

``launches`` counts the kernel's launches, and nothing else; a run reads
it to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
# the current stream of a device as an int, in one call (what PyTorch's own
# generated code uses; ``torch.cuda.current_stream`` builds a Stream object).
# A CPU-only build of torch lacks it, and no call reaches the kernel there.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("delta_mask").delta_mask_bool
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(new: torch.Tensor, old: torch.Tensor) -> None:
    # the common case, every condition at once; the checks below name a failure
    if (new.is_cuda and new.dtype == torch.int32 and old.dtype == torch.int32
            and new.ndim == 2 and new.shape[1] == 2 and new.shape == old.shape
            and old.device == new.device and new.is_contiguous() and old.is_contiguous()):
        return
    if new.ndim != 2 or new.shape[1] != 2 or new.shape != old.shape:
        raise ValueError(f"delta_mask: new and old must be (n, 2) of one shape, "
                         f"got {tuple(new.shape)} and {tuple(old.shape)}")
    if new.dtype != torch.int32 or old.dtype != torch.int32:
        raise TypeError(f"delta_mask: int32 digests only, got {new.dtype} and {old.dtype}")
    if not (new.is_contiguous() and old.is_contiguous()):
        raise ValueError("delta_mask: new and old must be contiguous")
    if new.device.type != "cuda" or old.device != new.device:
        raise ValueError(f"delta_mask: the kernel takes CUDA tensors on one device, "
                         f"got {new.device} and {old.device}")


def delta_mask_cuda(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """new, old: (n, 2) int32 CUDA digest tables -> (n,) bool changed mask."""
    global launches
    _check(new, old)
    device = new.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return delta_mask_cuda(new, old)
    n = new.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=new.device)
    if n == 0:
        return out
    err = (_fn or _kernel())(new.data_ptr(), old.data_ptr(), out.data_ptr(), n,
                             _raw_stream(device))
    if err != 0:
        raise RuntimeError(f"delta_mask: kernel launch failed with CUDA error {err}")
    launches += 1
    return out
