"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``linear_scan`` — diagonal linear recurrence (RG-LRU prefill), CUDA
  C++ in ``csrc/linear_scan.cu``, built with ``nvcc`` and bound with
  ``ctypes`` (``build.py``).

Callers use ``repro_torch.kernels.ops``: it sends a CPU tensor to the
plain version in ``ref.py`` and a CUDA tensor to the kernel.  Nothing is
compiled when this package is imported; the first CUDA call builds.
"""
