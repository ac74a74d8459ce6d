"""Parameter initialisers on an explicit generator and device.

Each initialiser draws from the ``torch.Generator`` it is given and
allocates on that generator's device.  The init functions return trees of
bare tensors; each leaf is tagged with its logical sharding axes by
:func:`leaf` (the reference pairs them as ``(array, axes)``), and
:func:`axes_tree` reads the tags back as the reference's axes twin tree,
which the partitioner (``distributed.partitioning``) maps onto a mesh.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import torch

AXES_ATTR = "logical_axes"


def leaf(t: torch.Tensor, *axes) -> torch.Tensor:
    """Tag ``t`` with one logical axis name (or None) per dimension and
    return it."""
    if t.ndim != len(axes):
        raise ValueError(f"shape {tuple(t.shape)} vs axes {axes}")
    setattr(t, AXES_ATTR, tuple(axes))
    return t


def axes_of(t: torch.Tensor) -> Tuple:
    axes = getattr(t, AXES_ATTR, None)
    if axes is None:
        raise ValueError(f"a {tuple(t.shape)} leaf carries no logical axes")
    return axes


def axes_tree(tree):
    """The logical axes of every leaf of a freshly initialised tree, in a
    twin tree of dicts and lists with tuple leaves."""
    return tree_map(axes_of, tree)


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
    (the per-group layer axis of ``lm``'s pattern groups); a tagged
    leaf's axes gain a leading ``"layers"``."""
    out = {}
    for key, first in trees[0].items():
        if isinstance(first, dict):
            out[key] = stack_trees([t[key] for t in trees])
        else:
            out[key] = torch.stack([t[key] for t in trees])
            axes = getattr(first, AXES_ATTR, None)
            if axes is not None:
                leaf(out[key], "layers", *axes)
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
