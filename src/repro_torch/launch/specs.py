"""Cell programs: (arch x shape) -> step function + abstract inputs.

The counterpart of ``repro.launch.specs``.  ``build_cell(...)`` returns
everything the dry run needs for one cell: the step function (the
builder's ``train_step_fn``, ``prefill_step_fn`` or ``decode_step_fn``),
fake tensors for every input at its global shape (the counterpart of the
reference's ``ShapeDtypeStruct``s: shapes and dtypes, no storage), and
their placements on the mesh from the strategy's rules (the builder's
``*_shardings``; None marks an input that stays a plain tensor).
``CellProgram.placed_args()`` lays the fake inputs on the mesh, each
rank's slice a fake tensor of its local shape.

MODEL_FLOPS convention: 6·N_active·tokens for training, 2·N_active·tokens
for inference (prefill counts the prompt, decode counts one token per
sequence).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed.partitioning import mesh_sizes
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.param_util import tree_map
from repro_torch.models.zoo import build_model
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.step import TrainStepBuilder

ENC_MEMORY_LEN = 4096  # encoder length backing enc-dec decode cells


def _accum_for(cfg: ModelConfig, cell: ShapeCell, mesh) -> int:
    """Microbatches of a train cell: the reference's rule, written to keep
    remat'd activations inside 16 GB chips (microbatch 1 a device for the
    32B+ archs), so both packages plan the same microbatches."""
    if cell.step != "train":
        return 1
    sizes = mesh_sizes(mesh)
    dp = 1
    for ax in ("pod", "data"):
        dp *= sizes.get(ax, 1)
    local = max(cell.global_batch // dp, 1)
    if cfg.d_model >= 5120:
        return local            # microbatch 1/device for the 32B+ archs
    return min(max(local // 2, 1), 8)


@dataclass
class CellProgram:
    arch: str
    shape: ShapeCell
    step_kind: str
    fn: Callable
    abstract_args: Tuple
    in_shardings: Tuple
    model_flops: float
    accum: int
    builder: TrainStepBuilder
    fake_mode: Any

    def placed_args(self) -> Tuple:
        """The abstract inputs laid on the mesh (a None placement leaves
        the input as it is; with no mesh every input stays whole).  Call
        inside ``fake_mode``."""
        if self.builder.mesh is None:
            return self.abstract_args
        return tuple(a if sh is None else self.builder.distribute(a, sh, src_data_rank=None)
                     for a, sh in zip(self.abstract_args, self.in_shardings))


def _batch_abstract(cfg: ModelConfig, cell: ShapeCell, with_labels: bool,
                    device: str) -> Dict:
    B, S = cell.global_batch, cell.seq_len
    dt = torch_dtype(cfg)
    tok = lambda: torch.empty((B, S), dtype=torch.int32, device=device)
    batch: Dict[str, Any] = {"tokens": tok()}
    if with_labels:
        batch["labels"] = tok()
    if cfg.frontend == "vision_stub":
        batch["vision_embeds"] = torch.empty((B, cfg.n_frontend_tokens, cfg.d_model),
                                             dtype=dt, device=device)
    if cfg.arch_kind == "encdec":
        batch["enc_embeds"] = torch.empty((B, S, cfg.d_model), dtype=dt, device=device)
    return batch


def model_flops_for(cfg: ModelConfig, cell: ShapeCell) -> float:
    n_active = cfg.active_param_count()
    if cell.step == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.step == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch  # decode: one token/sequence


def build_cell(
    cfg: ModelConfig,
    cell: ShapeCell,
    mesh,
    strategy: str = "tp_fsdp",
    remat_policy: str = "full",
    accum: Optional[int] = None,
    device: str = "cuda",
) -> CellProgram:
    """``mesh``: a ``DeviceMesh``, or None for the one-device path (then
    ``accum`` must be given)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = build_model(cfg)
    accum = accum if accum is not None else _accum_for(cfg, cell, mesh)
    builder = TrainStepBuilder(
        model, mesh, strategy=strategy, opt=AdamWConfig(),
        remat_policy=remat_policy, accum=accum,
        zero2="_zero2" in strategy,
    )
    mf = model_flops_for(cfg, cell)
    fake_mode = FakeTensorMode()

    def placed(shardings_fn, tree):
        """``tree``'s placements on the mesh; with no mesh (one device),
        None for every leaf."""
        if mesh is None:
            return tree_map(lambda _: None, tree)
        return shardings_fn(tree)

    common = dict(arch=cfg.name, shape=cell, builder=builder, fake_mode=fake_mode,
                  model_flops=mf)

    with fake_mode:
        params = model.init(torch.Generator(device=device))
        if cell.step == "train":
            state = {"params": params, "opt": adamw_init(params),
                     "step": torch.zeros((), dtype=torch.int32, device=device)}
            batch = _batch_abstract(cfg, cell, True, device)
            return CellProgram(
                step_kind="train", fn=builder.train_step_fn(),
                abstract_args=(state, batch),
                in_shardings=(placed(builder.state_shardings, params),
                              placed(builder.batch_shardings, batch)),
                accum=accum, **common)

        param_sh = placed(builder.param_shardings, params)
        if cell.step == "prefill":
            batch = _batch_abstract(cfg, cell, False, device)
            cache = model.init_cache(cell.global_batch, cell.seq_len, device=device)
            return CellProgram(
                step_kind="prefill", fn=builder.prefill_step_fn(),
                abstract_args=(params, batch, cache),
                in_shardings=(param_sh, placed(builder.batch_shardings, batch),
                              placed(builder.cache_shardings, cache)),
                accum=1, **common)

        # decode
        B = cell.global_batch
        token = torch.zeros((B,), dtype=torch.int64, device=device)
        cache = model.init_cache(B, cell.seq_len, device=device)
        args = [params, token, cell.seq_len - 1, cache]
        shardings = [param_sh, placed(builder.batch_shardings, {"token": token})["token"],
                     None, placed(builder.cache_shardings, cache)]
        if cfg.arch_kind == "encdec":
            shape = (cfg.n_layers, B, cfg.n_kv_heads, ENC_MEMORY_LEN, cfg.head_dim)
            mem = tuple(torch.empty(shape, dtype=torch_dtype(cfg), device=device)
                        for _ in range(2))
            args.append(mem)
            shardings.append(placed(builder.memories_shardings, mem))
        return CellProgram(
            step_kind="decode", fn=builder.decode_step_fn(),
            abstract_args=tuple(args), in_shardings=tuple(shardings),
            accum=1, **common)
