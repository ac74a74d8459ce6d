"""Parameter initialisers on an explicit generator and device.

The JAX package pairs every leaf with logical sharding axes; the port
runs on one device with no mesh, so its leaves are bare tensors.  Each
initialiser draws from the ``torch.Generator`` it is given and allocates
on that generator's device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import torch


def normal(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
           scale: float = 0.02) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def zeros(shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def stack_trees(trees: List[Dict]) -> Dict:
    """Stack identically-structured dicts of tensors along a new axis 0
    (the per-group layer axis of ``lm``'s pattern groups)."""
    out = {}
    for key, first in trees[0].items():
        if isinstance(first, dict):
            out[key] = stack_trees([t[key] for t in trees])
        else:
            out[key] = torch.stack([t[key] for t in trees])
    return out


def tree_map(fn, tree):
    """A tree of dicts and lists with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> Iterator:
    """Every leaf of a tree of dicts and lists, depth first."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        yield tree
        return
    for sub in tree:
        yield from tree_leaves(sub)


def index_tree(tree: Dict, i: int) -> Dict:
    """Entry ``i`` of a stacked tree, as views (writes reach the stack)."""
    return {k: index_tree(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}
