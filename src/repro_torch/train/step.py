"""The single-device train step: forward, backward, AdamW.

``TrainStepBuilder`` keeps the reference's state layout
(``{"params", "opt": {mu, nu, master, count}, "step"}``, as
``repro.train.step.TrainStepBuilder``) and its gradient accumulation:
with ``accum > 1`` the batch is cut into ``accum`` microbatches along
its first axis and their gradients are averaged in float32, in order.
There is no mesh, no logical-axis rules and no ``zero2``: the port runs
on one device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.param_util import tree_leaves, tree_map
from repro_torch.models.zoo import Model
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


class TrainStepBuilder:
    def __init__(self, model: Model, opt: Optional[AdamWConfig] = None,
                 remat_policy: str = "none", accum: int = 1) -> None:
        self.model = model
        self.opt = opt or AdamWConfig()
        self.remat_policy = remat_policy
        self.accum = accum

    def init_state(self, gen: torch.Generator) -> Dict[str, Any]:
        """Fresh parameters drawn from ``gen`` (on its device), zero optimizer."""
        params = self.model.init(gen)
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32, device=gen.device)}

    def abstract_state(self) -> Dict[str, Any]:
        """The state's tree, shapes and dtypes without allocating any of
        it (fake tensors), as the reference's ``jax.eval_shape`` of
        ``init_state``: the ``like`` argument of a checkpoint restore."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            return self.init_state(torch.Generator())

    def _grads(self, params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = self.model.loss_fn(live, batch, self.remat_policy)
        grads = torch.autograd.grad(loss, list(tree_leaves(live)))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step_fn(self):
        """``step(state, batch) -> (state, metrics)``.  The state is
        updated in place (see ``optimizer.adamw_update``) and returned."""
        accum = self.accum

        def step(state, batch):
            params = state["params"]
            if accum <= 1:
                loss, metrics, grads = self._grads(params, batch)
            else:
                grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for p in tree_leaves(params)]
                losses, metricses = [], []
                for i in range(accum):
                    mb = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()}
                    l, m, g = self._grads(params, mb)
                    grads = [a + gg.float() / accum for a, gg in zip(grads, g)]
                    losses.append(l)
                    metricses.append(m)
                loss = torch.stack(losses).mean()
                metrics = {k: torch.stack([m[k] for m in metricses]).mean(0)
                           for k in metricses[0]}
            params, opt, stats = adamw_update(self.opt, grads, state["opt"], params)
            new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
            return new_state, dict(metrics, loss=loss, **stats)

        return step
