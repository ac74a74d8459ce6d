"""Train/serve step builders, on one device or under a mesh.

``TrainStepBuilder`` keeps the reference's state layout
(``{"params", "opt": {mu, nu, master, count}, "step"}``, as
``repro.train.step.TrainStepBuilder``) and its gradient accumulation:
with ``accum > 1`` the batch is cut into ``accum`` microbatches along
its first axis and their gradients are averaged in float32, in order.

With ``mesh=None`` everything runs on one device with plain tensors.
With a ``DeviceMesh`` the strategy's rules (``distributed.partitioning``)
place the state and the batch as DTensors, and every step runs with the
rules active, so the model's ``constrain`` calls take effect; plain
tensors the model makes (positions, masks) count as replicated.  Under
an fsdp strategy ``zero2`` gathers the parameters once a step, outside
the microbatch loop, to their tensor-parallel placements, and
reduce-scatters each microbatch's gradients into an fsdp-sharded float32
accumulator.  The step counter and AdamW's count stay plain tensors,
the same on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from repro_torch.distributed import axes as AX
from repro_torch.distributed import partitioning as PT
from repro_torch.models.param_util import tree_leaves, tree_map
from repro_torch.models.zoo import Model
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


class TrainStepBuilder:
    def __init__(self, model: Model, mesh=None, strategy: str = "tp",
                 opt: Optional[AdamWConfig] = None, remat_policy: str = "none",
                 accum: int = 1, zero2: bool = False) -> None:
        self.model = model
        self.mesh = mesh
        self.strategy = strategy
        self.rules = PT.get_rules(strategy)
        self.opt = opt or AdamWConfig()
        self.remat_policy = remat_policy
        self.accum = accum
        self.zero2 = zero2 and "fsdp" in strategy and mesh is not None
        self._param_axes = None

    # ----------------------------------------------------------------- helpers
    @contextlib.contextmanager
    def _activate(self):
        """The rules and mesh active, plain tensors taken as replicated."""
        if self.mesh is None:
            yield
            return
        from torch.distributed.tensor.experimental import implicit_replication

        try:
            with AX.logical_rules(self.rules, self.mesh), implicit_replication():
                yield
        except NotImplementedError as e:
            # an op with no sharding rule (DTensor names it), or a path
            # refused under a mesh: name the strategy too
            raise NotImplementedError(
                f"{e} [strategy {self.strategy} on mesh {self.mesh}]") from e

    def param_axes(self):
        if self._param_axes is None:
            self._param_axes = self.model.abstract()[1]
        return self._param_axes

    def param_shardings(self, params, rules=None):
        """Placements of every parameter (anything with a ``shape``)."""
        return PT.placements_tree(self.mesh, rules or self.rules, params, self.param_axes())

    def state_shardings(self, params) -> Dict[str, Any]:
        """Placements of the train state; None marks the scalars, which
        stay plain tensors."""
        p_shard = self.param_shardings(params)
        return {"params": p_shard,
                "opt": {"mu": p_shard, "nu": p_shard, "master": p_shard, "count": None},
                "step": None}

    def _shardings_for(self, tree, axes):
        return PT.placements_tree(self.mesh, self.rules, tree, axes)

    def batch_shardings(self, batch):
        return self._shardings_for(batch, PT.batch_axes_for(batch))

    def cache_shardings(self, cache):
        return self._shardings_for(cache, PT.cache_axes_for(cache))

    def memories_shardings(self, memories):
        return self._shardings_for(memories, PT.memories_axes_for(memories))

    def distribute(self, tree, shardings, src_data_rank: Optional[int] = 0):
        """``tree`` placed on the mesh by ``shardings`` (a None leaf stays a
        plain tensor).  With ``src_data_rank`` 0 rank 0's values are
        scattered; with None every rank holds the whole tree and keeps its
        slices (no traffic)."""
        return PT.distribute_tree(self.mesh, tree, shardings, src_data_rank)

    def distribute_state(self, state, src_data_rank: Optional[int] = 0):
        """A whole train state (as ``init_state`` on one device or a restore
        returns it) placed by ``state_shardings``."""
        return self.distribute(state, self.state_shardings(state["params"]), src_data_rank)

    def shard_batch(self, batch):
        """The global batch, held whole by every rank, as DTensors split
        by ``batch_shardings``: each rank keeps its slice."""
        if self.mesh is None:
            return batch
        return self.distribute(batch, self.batch_shardings(batch), src_data_rank=None)

    def shard_cache(self, cache):
        """A fresh (empty) cache placed by ``cache_shardings``; every rank
        makes the same one and keeps its slices."""
        if self.mesh is None:
            return cache
        return self.distribute(cache, self.cache_shardings(cache), src_data_rank=None)

    # -------------------------------------------------------------- train step
    def init_state(self, gen: torch.Generator) -> Dict[str, Any]:
        """Fresh parameters drawn from ``gen`` (on its device), zero
        optimizer.  Under a mesh every rank draws the same parameters from
        the same seed and keeps its slices."""
        params = self.model.init(gen)
        if self.mesh is not None:
            params = PT.shard_tree(self.mesh, self.rules, params, self.param_axes(),
                                   src_data_rank=None)
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32, device=gen.device)}

    def abstract_state(self) -> Dict[str, Any]:
        """The state's tree, shapes and dtypes without allocating any of
        it (fake tensors, whole), as the reference's ``jax.eval_shape`` of
        ``init_state``: the ``like`` argument of a checkpoint restore."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            params = self.model.init(torch.Generator())
            return {"params": params, "opt": adamw_init(params),
                    "step": torch.zeros((), dtype=torch.int32)}

    def _grads(self, params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = self.model.loss_fn(live, batch, self.remat_policy)
        grads = torch.autograd.grad(loss, list(tree_leaves(live)))
        return PT.full(loss.detach()), {k: PT.full(v.detach()) for k, v in metrics.items()}, grads

    def _microbatch(self, x, i: int):
        """Rows [i*b, (i+1)*b) of the global batch leaf ``x``, placed as
        ``x`` is (the microbatches of the reference's reshape)."""
        accum = self.accum
        if not PT.is_distributed(x):
            return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))[i]
        from torch.distributed.tensor import distribute_tensor

        b = x.shape[0] // accum
        return distribute_tensor(x.full_tensor()[i * b:(i + 1) * b], self.mesh, x.placements,
                                 src_data_rank=None)

    def _loss_and_grads(self, params, batch):
        """(loss, metrics, grads) of the global batch, microbatches
        accumulated in float32; under a mesh the gradients come placed as
        the parameters (partial sums reduce-scattered)."""
        accum = self.accum
        batch = self.shard_batch(batch)
        use = params
        if self.zero2:
            # one gather a step: the tensor-parallel placements, outside
            # the microbatch loop
            gathered = self.param_shardings(params, dict(self.rules, embed=None))
            use = PT.map_twin(lambda p, pl: p.redistribute(self.mesh, pl), params, gathered)
        if accum <= 1:
            loss, metrics, grads = self._grads(use, batch)
            if self.mesh is not None:
                grads = self._reduce_scatter(grads, params)
            return loss, metrics, grads
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in tree_leaves(params)]
        losses, metricses = [], []
        for i in range(accum):
            mb = {k: self._microbatch(v, i) for k, v in batch.items()}
            l, m, g = self._grads(use, mb)
            if self.mesh is not None:
                g = self._reduce_scatter(g, params)
            grads = [a + gg.float() / accum for a, gg in zip(grads, g)]
            losses.append(l)
            metricses.append(m)
        metrics = {k: torch.stack([m[k] for m in metricses]).mean(0) for k in metricses[0]}
        return torch.stack(losses).mean(), metrics, grads

    def grads_fn(self):
        """``fn(state, batch) -> (loss, grads)``: the step's forward and
        backward without the update; grads in ``tree_leaves`` order of
        the parameters, placed as they are under a mesh."""
        def fn(state, batch):
            with self._activate():
                loss, _, grads = self._loss_and_grads(state["params"], batch)
            return loss, grads

        return fn

    def train_step_fn(self):
        """``step(state, batch) -> (state, metrics)``.  The state is
        updated in place (see ``optimizer.adamw_update``) and returned.
        Under a mesh the batch is the global batch, each leaf either held
        whole by every rank or a DTensor (``shard_batch``)."""
        def step(state, batch):
            with self._activate():
                loss, metrics, grads = self._loss_and_grads(state["params"], batch)
                params, opt, stats = adamw_update(self.opt, grads, state["opt"], state["params"])
            new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
            return new_state, dict(metrics, loss=loss, **stats)

        return step

    @staticmethod
    def _reduce_scatter(grads, params):
        """Gradients placed as the (fsdp-sharded) parameters are: partial
        sums are reduce-scattered, replicated ones sliced."""
        return [g.redistribute(p.device_mesh, p.placements)
                for g, p in zip(grads, tree_leaves(params))]

    # -------------------------------------------------------------- serve steps
    def prefill_step_fn(self):
        """``step(params, batch, cache)`` with the rules active; logits
        come back whole on every rank (caches and memories stay placed)."""
        model = self.model

        def step(params, batch, cache):
            with self._activate(), torch.no_grad():
                out = model.prefill(params, self.shard_batch(batch), cache)
            return (PT.full(out[0]),) + tuple(out[1:])

        return step

    def decode_step_fn(self):
        """``step(params, token, pos, cache, *memories)`` with the rules
        active; logits whole on every rank."""
        model = self.model

        def step(params, token, pos, cache, *extras):
            with self._activate(), torch.no_grad():
                token = self.shard_batch({"token": token})["token"]
                logits, cache = model.decode_step(params, token, pos, cache, *extras)
            return PT.full(logits), cache

        return step
