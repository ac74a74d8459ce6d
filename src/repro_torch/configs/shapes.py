"""Input-shape cells and per-arch applicability.

Every LM-family arch is paired with the four assigned shapes; ``step``
selects which program the dry-run lowers:

* ``train_4k``    -> train_step   (seq 4096, global batch 256)
* ``prefill_32k`` -> prefill_step (seq 32768, global batch 32)
* ``decode_32k``  -> serve_step   (1 new token, KV cache 32768, batch 128)
* ``long_500k``   -> serve_step   (1 new token, state at 524288, batch 1)
  — requires a sub-quadratic arch; skipped for full-attention archs
  (see DESIGN.md §Arch-applicability).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeCell:
    name: str
    step: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode is quadratic — skipped"
    return True, ""


def cells_for(cfg: ModelConfig) -> List[ShapeCell]:
    return [s for s in SHAPES.values() if applicable(cfg, s)[0]]
