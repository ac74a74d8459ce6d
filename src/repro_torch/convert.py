"""Load parameters and train states written by the JAX package into the port.

The port keeps the reference's parameter tree: the same dict keys,
``groups`` stacked along axis 0 (one entry per pattern position) and
``rest`` as a list, with the same shapes and layouts, and the
reference's train-state layout around it.  So converting is a walk over
the tree that turns numpy leaves into tensors on a device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _pattern_layout
from repro_torch.models.param_util import tree_leaves


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr)   # writable copy: JAX hands out read-only buffers
    if arr.dtype.name == "bfloat16":
        # numpy knows bfloat16 only through ml_dtypes, which torch does not
        # read: move the raw 16-bit words and reinterpret them.
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _walk(tree: Any, device):
    if isinstance(tree, dict):
        return {k: _walk(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, device) for v in tree]
    return _tensor(tree, device)


def params_from_jax(np_tree: Any, cfg: ModelConfig, device="cuda") -> dict:
    """Map a JAX parameter tree with numpy leaves onto the port's params."""
    n_groups, rest = _pattern_layout(cfg)
    want_groups = len(cfg.block_pattern) if n_groups > 0 else 0
    if len(np_tree["groups"]) != want_groups or len(np_tree["rest"]) != len(rest):
        raise ValueError(
            f"tree has {len(np_tree['groups'])} groups / {len(np_tree['rest'])} rest "
            f"layers; {cfg.name} needs {want_groups} / {len(rest)}")
    for stacked in np_tree["groups"]:
        lead = {np.shape(v)[0] for v in tree_leaves(stacked)}
        if lead != {n_groups}:
            raise ValueError(f"group leaves stack {sorted(lead)} layers, expected {n_groups}")
    return _walk(np_tree, device)



def state_from_jax(np_state: Any, cfg: ModelConfig, device="cuda") -> dict:
    """Map a JAX train state ``{"params", "opt": {mu, nu, master, count},
    "step"}`` with numpy leaves onto the port's (``train.step``)."""
    opt = np_state["opt"]
    return {
        "params": params_from_jax(np_state["params"], cfg, device),
        "opt": {
            "mu": params_from_jax(opt["mu"], cfg, device),
            "nu": params_from_jax(opt["nu"], cfg, device),
            "master": params_from_jax(opt["master"], cfg, device),
            "count": _tensor(np.asarray(opt["count"], np.int32), device),
        },
        "step": _tensor(np.asarray(np_state["step"], np.int32), device),
    }
