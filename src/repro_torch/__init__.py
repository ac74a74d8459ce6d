"""PyTorch/CUDA port of the ``repro`` model and serving stack, for one
NVIDIA H100.

Modules mirror ``repro`` path for path (``repro_torch.models.layers`` is
the counterpart of ``repro.models.layers``).  The package imports
``torch`` and never ``jax`` nor anything of ``repro``: the numpy-only
modules it needs (configs, tokenizer) are kept here as copies.  Entry
points run on ``device="cuda"`` unless the caller passes ``"cpu"``; on
the CPU every hand-written kernel is replaced by its plain PyTorch
version (``repro_torch.kernels.ref``), chosen by the tensor's device.
"""
