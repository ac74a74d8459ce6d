"""Recurrent token mixer: the RG-LRU block of recurrentgemma (Griffin).

A plain function with an explicit state dict, so the same code serves a
full-sequence pass (the scan over the whole prompt, returning the final
state) and decode (one step from the carried state).  The diagonal
recurrence goes through ``kernels.ops.linear_scan``: the CUDA kernel on
the card, the plain loop on the CPU.

mLSTM and sLSTM (xLSTM) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.param_util import normal, zeros

# ---------------------------------------------------------------------------
# temporal conv
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv. x: (B,T,D); w: (W,D); state: (B,W-1,D)."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xx = torch.cat([state, x], dim=1)                   # (B, T+W-1, D)
    out = sum(xx[:, i : i + x.shape[1], :] * w[i] for i in range(W))
    new_state = xx[:, -(W - 1):, :] if W > 1 else state
    return out, new_state


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, r, w = cfg.d_model, cfg.rnn_width, cfg.conv_width
    lam = torch.linspace(0.001, 0.1, r, dtype=torch.float32, device=gen.device)
    return {
        "wx": normal(gen, (d, r), dtype),
        "wy": normal(gen, (d, r), dtype),
        "conv": normal(gen, (w, r), dtype, scale=0.1),
        "w_a": normal(gen, (r, r), dtype),
        "w_i": normal(gen, (r, r), dtype),
        # Λ init so that a = exp(-8 softplus(Λ) r) starts near 0.9..0.999
        "lam": torch.log(torch.expm1(lam)),
        "wo": normal(gen, (r, d), dtype),
    }


def apply_rglru(
    p: Dict, cfg: ModelConfig, x: torch.Tensor, state: Optional[Dict] = None
) -> Tuple[torch.Tensor, Dict]:
    """x: (B,T,D) -> (y, new_state). state={"h": (B,R), "conv": (B,W-1,R)}."""
    xb = x @ p["wx"]
    yb = x @ p["wy"]                                    # gate branch
    conv_state = state["conv"] if state is not None else None
    xb, new_conv = _causal_conv(xb, p["conv"], conv_state)

    xf = xb.float()
    r_gate = torch.sigmoid(xf @ p["w_a"].float())
    i_gate = torch.sigmoid(xf @ p["w_i"].float())
    log_a = -8.0 * F.softplus(p["lam"]) * r_gate        # (B,T,R)
    a = torch.exp(log_a)
    gated_x = xf * i_gate
    # input normalization: sqrt(1 - a^2) (Griffin eq. 4)
    scaled_x = gated_x * torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))

    h0 = state["h"].float() if state is not None else None
    if x.shape[1] == 1 and h0 is not None:
        h = (a[:, 0] * h0 + scaled_x[:, 0])[:, None]    # decode: one step
    else:
        if h0 is not None:
            # carried state folds into the first input (scaled_x is ours)
            scaled_x[:, 0] += a[:, 0] * h0
        h = kops.linear_scan(a, scaled_x)
    new_state = {"h": h[:, -1], "conv": new_conv}
    y = h.to(x.dtype) * F.gelu(yb, approximate="tanh")
    return y @ p["wo"], new_state


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    r, w = cfg.rnn_width, cfg.conv_width
    return {"h": zeros((batch, r), torch.float32, device),
            "conv": zeros((batch, w - 1, r), dtype, device)}
