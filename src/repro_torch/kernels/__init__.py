"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``linear_scan``: diagonal linear recurrence (RG-LRU prefill),
  ``csrc/linear_scan.cu``;
* ``page_digest``: per-page polynomial digest of a leaf's bytes (the
  checkpoint's delta scan), ``csrc/page_digest.cu``;
* ``delta_mask``: changed-page mask of two digest tables,
  ``csrc/delta_mask.cu``.

Each is CUDA C++ built with ``nvcc`` and bound with ``ctypes``
(``build.py``).  Callers use ``repro_torch.kernels.ops``: it sends a CPU
tensor to the plain version in ``ref.py`` and a CUDA tensor to the
kernel.  Nothing is compiled when this package is imported; the first
CUDA call builds.  ``hostdigest.py`` is the numpy digest of the blob
client and holds the digest constants every version uses.
"""
