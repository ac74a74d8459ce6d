"""Partitioning rules: logical axes -> mesh axes, with divisibility
guards, and their placements on a torch ``DeviceMesh``.

The counterpart of ``repro.distributed.partitioning``; the rule tables,
``get_rules``, ``spec_for`` and the batch, cache and memories axes are
the reference's, value for value.  Strategies (``--strategy``):

* ``tp``        -- Megatron-style tensor parallelism over "model"
                   (heads / d_ff / vocab / experts), pure DP over
                   "data" (+ "pod").  Parameters replicated across DP.
* ``tp_fsdp``   -- ``tp`` + ZeRO-3: the "embed" dimension of every
                   weight is sharded over ("pod", "data").
* ``tp_fsdp_sp``-- ``tp_fsdp`` + sequence sharding of activations.
* ``tp_serve``, ``tp_serve_hd``, ``tp_serve_sm`` -- serving layouts of
                   the KV cache (``tp_serve_sm``: the hand-scheduled
                   ``decode_attn.sharded_decode_attention``).
* ``dp_fsdp``   -- pure data parallelism, parameters sharded for
                   storage over every mesh axis.

A mesh axis is dropped for a dimension it does not divide (kv_heads=8 on
a 16-way "model" axis, an odd vocab), unless the ``_uneven`` suffix lifts
the guard: where GSPMD pads, DTensor splits in ``torch.chunk``'s layout
(``local_range``).  A spec (one entry per dimension: an axis name, a tuple of
names or None) becomes DTensor placements through ``placements_for``:
mesh dimension i shards tensor dimension d (``Shard(d)``) where d's
entry names it, and replicates otherwise.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.axes import mesh_axis_names

# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------

_DP = ("pod", "data")     # data-parallel super-axis (collapses if absent)

RULESETS: Dict[str, Dict[str, Any]] = {
    "tp": {
        # parameters
        "vocab": "model",
        "embed": None,
        "mlp": "model",
        "q_heads": "model",
        "kv_heads": "model",
        "head": None,
        "experts": "model",
        "rnn": "model",
        "rnn_up": "model",
        "rnn_gate": "model",
        "rnn_gates": "model",
        "gates": None,
        "conv": None,
        "layers": None,
        # activations
        "batch": _DP,
        "seq": None,
        "embed_act": None,
        "heads_act": "model",
        "kv_act": "model",
        "kv_seq": None,
        "mlp_act": "model",
        "experts_act": "model",
        "vocab_act": "model",
    },
}

RULESETS["tp_fsdp"] = dict(RULESETS["tp"], embed=_DP)
RULESETS["tp_fsdp_sp"] = dict(RULESETS["tp_fsdp"], seq="data")
# Serving: the KV cache's sequence dimension takes "model" where kv_heads
# does not divide it (the used-axis guard prefers kv_heads).
RULESETS["tp_serve"] = dict(RULESETS["tp"], kv_seq="model")
# Head-dim cache sharding: decode writes stay local (the seq dim is whole).
RULESETS["tp_serve_hd"] = dict(RULESETS["tp"], kv_seq=None, head="model")

SHARD_DECODE_FLAG = "__shard_decode__"
# Hand-scheduled decode (decode_attn.py): local cache writes and an
# O(B·H·dh) combine instead of cache-sized collectives.
RULESETS["tp_serve_sm"] = dict(RULESETS["tp_serve"], **{SHARD_DECODE_FLAG: True})

_ALL = ("pod", "data", "model")
# Pure data parallelism for small models on big meshes: no tensor
# parallelism, the embed dim sharded over every axis for storage.
RULESETS["dp_fsdp"] = {
    "vocab": None, "embed": _ALL, "mlp": None, "q_heads": None,
    "kv_heads": None, "head": None, "experts": None, "rnn": None,
    "rnn_up": None, "rnn_gate": None, "rnn_gates": None, "gates": None,
    "conv": None, "layers": None,
    "batch": _ALL, "seq": None, "embed_act": None, "heads_act": None,
    "kv_act": None, "kv_seq": None, "mlp_act": None, "experts_act": None,
    "vocab_act": None,
}

UNEVEN_FLAG = "__uneven__"


def get_rules(strategy: str) -> Dict[str, Any]:
    """Resolve a strategy name.  Suffixes compose:

    * ``_uneven`` relaxes the divisibility guard: 40 heads on a 16-way
      axis shard as at most ceil(40/16)=3 a device instead of replicating;
    * ``_zero2`` is consumed by the step builder (hoisted parameter
      gather) and does not change the rule table.
    """
    base = strategy
    uneven = False
    for _ in range(2):
        if base.endswith("_uneven"):
            uneven = True
            base = base[: -len("_uneven")]
        if base.endswith("_zero2"):
            base = base[: -len("_zero2")]
    rules = dict(RULESETS[base])
    if uneven:
        rules[UNEVEN_FLAG] = True
    return rules


# ---------------------------------------------------------------------------
# spec construction with divisibility guards
# ---------------------------------------------------------------------------


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or of a stand-in whose
    ``shape`` maps names to sizes (as a JAX mesh's does)."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def spec_for(mesh, rules: Dict[str, Any], names: Sequence[Optional[str]],
             shape: Sequence[int]) -> Tuple:
    """The spec of one tensor given its logical names and shape."""
    axis_names = mesh_axis_names(mesh)
    sizes = mesh_sizes(mesh)
    parts = []
    used: set = set()
    uneven_ok = bool(rules.get(UNEVEN_FLAG))
    for dim, name in zip(shape, names):
        axis = rules.get(name) if name is not None else None
        if axis is None:
            parts.append(None)
            continue
        flat = (axis,) if isinstance(axis, str) else tuple(axis)
        flat = tuple(a for a in flat if a in axis_names and a not in used)
        total = math.prod(sizes[a] for a in flat) if flat else 1
        # divisibility guard: drop trailing axes until it divides, unless
        # uneven sharding is allowed and the dim spans the axis
        while flat and dim % total != 0 and not (uneven_ok and dim >= total):
            flat = flat[:-1]
            total = math.prod(sizes[a] for a in flat) if flat else 1
        if not flat:
            parts.append(None)
            continue
        used.update(flat)
        parts.append(flat if len(flat) > 1 else flat[0])
    return tuple(parts)


def placements_for(mesh, spec: Sequence) -> Tuple:
    """DTensor placements on ``mesh`` for a spec: ``Shard(d)`` on each
    mesh dimension that dimension d's entry names, ``Replicate()``
    elsewhere.  A tensor dimension over several mesh axes is split in
    mesh order (the outer axis first), as the entry must list them.  A
    mesh dimension of size 1 replicates: the same layout, and DTensor's
    view rules refuse to reshape a dimension of size 1 sharded over it."""
    from torch.distributed.tensor import Replicate, Shard

    axis_names = mesh_axis_names(mesh)
    out = [Replicate() for _ in axis_names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        flat = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [axis_names.index(a) for a in flat]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec entry {entry} splits a dimension against the mesh order {axis_names}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def map_twin(fn, tree, twin):
    """``fn(leaf, twin_leaf)`` over ``tree``'s dicts and lists; ``twin``
    has that structure above its leaves (an axes or placements tree,
    whose tuples are leaves)."""
    if isinstance(tree, dict):
        return {k: map_twin(fn, v, twin[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_twin(fn, v, twin[i]) for i, v in enumerate(tree)]
    return fn(tree, twin)


def placements_tree(mesh, rules: Dict[str, Any], tree, axes_tree):
    """Placements for every leaf of ``tree`` (tensors or anything with a
    ``shape``) given its twin axes tree."""
    return map_twin(
        lambda t, names: placements_for(mesh, spec_for(mesh, rules, names, t.shape)),
        tree, axes_tree)


def distribute_tree(mesh, tree, placements, src_data_rank: Optional[int] = 0):
    """``tree``'s tensors as DTensors with the twin ``placements`` (a None
    leaf stays a plain tensor, a DTensor as it is).  With
    ``src_data_rank`` 0 rank 0's values are scattered; with None every
    rank holds the same whole tensors and keeps its own slices."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, pl):
        if pl is None or is_distributed(t):
            return t
        return distribute_tensor(t, mesh, pl, src_data_rank=src_data_rank)

    return map_twin(one, tree, placements)


def shard_tree(mesh, rules: Dict[str, Any], tree, axes_tree, src_data_rank: Optional[int] = 0):
    """``tree``'s tensors as DTensors placed by the rules."""
    return distribute_tree(mesh, tree, placements_tree(mesh, rules, tree, axes_tree),
                           src_data_rank)


# ---------------------------------------------------------------------------
# batch / cache axes (path-based annotation)
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists; a path entry is
    a dict key (str) or a list index (int)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def batch_axes_for(batch_tree) -> Any:
    """Logical axes for an input batch dict (tokens/labels/embeds)."""
    def one(path, leaf):
        key = str(path[-1])
        if key in ("tokens", "labels"):
            return ("batch", "seq")
        if key in ("vision_embeds", "enc_embeds"):
            return ("batch", "seq", "embed_act")
        if key in ("token",):
            return ("batch",)
        return tuple([None] * len(leaf.shape))

    return _map_with_path(one, batch_tree)


def cache_axes_for(cache_tree) -> Any:
    """Logical axes for KV/state caches by leaf name + rank.

    Handles both the decoder layout ({"groups": [stacked...], "rest":
    [...]}) and the enc-dec layout (one stacked tree): a leaf whose rank
    exceeds its base form's by one carries a leading "layers" axis.
    """
    BASE = {
        "k": ("batch", "kv_heads", "kv_seq", "head"),
        "v": ("batch", "kv_heads", "kv_seq", "head"),
        "pos": (None,),
        "conv": ("batch", None, "rnn"),
        "C": ("batch", "q_heads", None, None),
    }
    AMBIG = {  # two legal base forms (mlstm vs slstm states)
        "h": [("batch", "rnn")],
        "n": [("batch", "q_heads", "head"), ("batch", "rnn")],
        "m": [("batch", "q_heads"), ("batch", "rnn")],
        "c": [("batch", "rnn")],
    }

    def one(path, leaf):
        key = next((e for e in reversed(path) if isinstance(e, str)), None)
        rank = len(leaf.shape)
        candidates = [BASE[key]] if key in BASE else AMBIG.get(key, [])
        for base in candidates:
            if rank == len(base):
                return base
            if rank == len(base) + 1:
                return ("layers",) + base
        return tuple([None] * rank)

    return _map_with_path(one, cache_tree)


def memories_axes_for(mem_tree) -> Any:
    """Cross-attention memories: (layers, B, H, T, Dh) leaves."""
    def one(path, leaf):
        rank = len(leaf.shape)
        if rank == 5:
            return ("layers", "batch", "kv_heads", None, "head")
        return tuple([None] * rank)

    return _map_with_path(one, mem_tree)


def is_distributed(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (a collective), anything
    else as it is."""
    return t.full_tensor() if is_distributed(t) else t


def local_range(mesh, placements, dim: int, size: int) -> Tuple[int, int]:
    """(offset, length) of this rank's slice of tensor dimension ``dim``
    (of ``size``) under ``placements``: mesh dimensions that shard it
    split it in mesh order, as DTensor does, in ``torch.chunk``'s layout:
    ceil(n / k) a rank, the last ranks shorter or empty where k does not
    divide n (40 heads over 16 ranks: 3 each on ranks 0-12, 1 on rank 13,
    none on 14 and 15)."""
    off, n = 0, size
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            c = -(-n // mesh.size(i))
            start = min(mesh.get_local_rank(i) * c, n)
            off, n = off + start, min(c, n - start)
    return off, n


def from_local(t: torch.Tensor, mesh, placements, shape: Sequence[int]):
    """``DTensor.from_local`` of a local result whose global ``shape`` is
    given (a dimension split unevenly has no global size that the local
    one implies); its global strides keep the local tensor's order of
    dimensions."""
    from torch.distributed.tensor import DTensor

    order = sorted(range(t.ndim), key=lambda d: t.stride(d), reverse=True)
    stride, s = [0] * t.ndim, 1
    for d in reversed(order):
        stride[d] = s
        s *= shape[d]
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))
