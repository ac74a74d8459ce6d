"""Recurrent token mixers: RG-LRU (recurrentgemma), mLSTM + sLSTM (xLSTM).

Plain functions with an explicit state dict, so the same code serves a
full-sequence pass (the scan over the whole prompt, returning the final
state) and decode (one step from the carried state).  The RG-LRU's
diagonal recurrence goes through ``kernels.ops.linear_scan``: the CUDA
kernel on the card, the plain loop on the CPU.  The mLSTM's matrix
memory is the reference's chunked form (parallel within a chunk, a loop
over chunks carrying the state) and the sLSTM, whose gates see the
previous hidden state through a full matrix, a loop over time: neither
is the diagonal recurrence of ``linear_scan``, and the reference computes
both with plain array ops, as the port does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.param_util import leaf, normal, ones, zeros

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
        "wx": leaf(normal(gen, (d, r), dtype), "embed", "rnn"),
        "wy": leaf(normal(gen, (d, r), dtype), "embed", "rnn"),
        "conv": leaf(normal(gen, (w, r), dtype, scale=0.1), "conv", "rnn"),
        "w_a": leaf(normal(gen, (r, r), dtype), "rnn", "rnn_gate"),
        "w_i": leaf(normal(gen, (r, r), dtype), "rnn", "rnn_gate"),
        # Λ init so that a = exp(-8 softplus(Λ) r) starts near 0.9..0.999
        "lam": leaf(torch.log(torch.expm1(lam)), "rnn"),
        "wo": leaf(normal(gen, (r, d), dtype), "rnn", "embed"),
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


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory, chunked-parallel
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, r, h = cfg.d_model, cfg.rnn_width, cfg.n_heads
    dh = r // h
    dev = gen.device
    return {
        "w_up": leaf(normal(gen, (d, 2 * r), dtype), "embed", "rnn_up"),
        "conv": leaf(normal(gen, (cfg.conv_width, r), dtype, scale=0.1), "conv", "rnn"),
        "wq": leaf(normal(gen, (r, h, dh), dtype), "rnn", "q_heads", "head"),
        "wk": leaf(normal(gen, (r, h, dh), dtype), "rnn", "q_heads", "head"),
        "wv": leaf(normal(gen, (r, h, dh), dtype), "rnn", "q_heads", "head"),
        "w_if": leaf(normal(gen, (r, 2 * h), torch.float32), "rnn", "gates"),
        "b_if": leaf(torch.cat([zeros((h,), torch.float32, dev),
                                3.0 * ones((h,), torch.float32, dev)]), "gates"),
        "o_norm": leaf(ones((h, dh), torch.float32, dev), "q_heads", "head"),
        "w_down": leaf(normal(gen, (r, d), dtype), "rnn", "embed"),
    }


def _mlstm_chunk_scan(q, k, v, log_f, log_i, C, n, m, chunk: int):
    """Chunked mLSTM. q,k,v: (B,H,T,Dh); log_f/log_i: (B,H,T), float32.

    Stabilised exponential gating (xLSTM eq. 19-27) evaluated chunkwise:
    within a chunk every pair's decay is ``exp(F_t - F_s + i_s - m)``;
    across chunks the matrix state C (B,H,Dh,Dh), the normaliser n
    (B,H,Dh) and the stabiliser m (B,H) carry.  Returns (h, (C, n, m)).
    """
    B, H, T, Dh = q.shape
    pad = (-T) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_f = F.pad(log_f, (0, pad))
        log_i = F.pad(log_i, (0, pad), value=-1e30)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    hs = []
    for j in range(0, T + pad, chunk):
        qj, kj, vj = (t[:, :, j:j + chunk] for t in (q, k, v))
        fj, ij = log_f[..., j:j + chunk], log_i[..., j:j + chunk]
        Fc = torch.cumsum(fj, dim=-1)        # (B,H,c) cumulative log-forget
        Ftot = Fc[..., -1]
        a_log = Fc - fj + ij
        # intra-chunk pair decay: D[t,s] = F_t - F_s + i_s  (s<=t)
        Dmat = Fc[..., :, None] - Fc[..., None, :] + ij[..., None, :]
        Dmat = Dmat.masked_fill(~tri, float("-inf"))
        m_intra = Dmat.amax(dim=-1)                            # (B,H,c)
        m_inter = Fc + m[..., None]                            # carry path
        m_new_t = torch.maximum(m_intra, m_inter)              # (B,H,c)
        # intra contribution
        w = torch.exp(Dmat - m_new_t[..., None])               # (B,H,c,c)
        s = torch.einsum("bhtd,bhsd->bhts", qj, kj)            # scores
        h_intra = torch.einsum("bhts,bhsd->bhtd", w * s, vj)
        l_intra = torch.einsum("bhts,bhsd->bhtd", w, kj)       # for the normaliser
        n_intra = torch.einsum("bhtd,bhtd->bht", qj, l_intra)
        # inter contribution (state from earlier chunks)
        scale = torch.exp(m_inter - m_new_t)                   # (B,H,c)
        h_inter = torch.einsum("bhtd,bhde->bhte", qj, C) * scale[..., None]
        n_inter = torch.einsum("bhtd,bhd->bht", qj, n) * scale
        denom = torch.maximum((n_intra + n_inter).abs(), torch.exp(-m_new_t))
        hs.append((h_intra + h_inter) / denom[..., None])
        # state update to the end of the chunk
        m_end = torch.maximum(Ftot + m, (a_log + (Ftot[..., None] - Fc)).amax(dim=-1))
        dec = torch.exp(ij + Ftot[..., None] - Fc - m_end[..., None])   # (B,H,c)
        carry = torch.exp(Ftot + m - m_end)
        C = C * carry[..., None, None] + torch.einsum("bhs,bhsd,bhse->bhde", dec, kj, vj)
        n = n * carry[..., None] + torch.einsum("bhs,bhsd->bhd", dec, kj)
        m = m_end
    return torch.cat(hs, dim=2)[:, :, :T], (C, n, m)


def apply_mlstm(
    p: Dict, cfg: ModelConfig, x: torch.Tensor, state: Optional[Dict] = None,
    chunk: int = 256,
) -> Tuple[torch.Tensor, Dict]:
    """x: (B,T,D) -> (y, new_state).  state={"C": (B,H,Dh,Dh), "n": (B,H,Dh),
    "m": (B,H), all float32, "conv": (B,W-1,R) in the model's dtype}."""
    B, T, _ = x.shape
    r, H = cfg.rnn_width, cfg.n_heads
    dh = r // H
    xi, z = (x @ p["w_up"]).chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xi, new_conv = _causal_conv(xi, p["conv"], conv_state)
    xi_act = F.silu(xi)
    # projected in the model's dtype, cast to float32 afterwards (as the reference)
    q = torch.einsum("btr,rhk->bhtk", xi_act, p["wq"]) * (dh ** -0.5)
    k = torch.einsum("btr,rhk->bhtk", xi_act, p["wk"])
    v = torch.einsum("btr,rhk->bhtk", xi_act, p["wv"])
    gates = xi.float() @ p["w_if"] + p["b_if"]
    log_i, log_f = gates.chunk(2, dim=-1)                  # (B,T,H)
    log_f = F.logsigmoid(log_f).transpose(1, 2)            # (B,H,T)
    log_i = log_i.transpose(1, 2)                          # exp input gate (log-space)

    st = state if state is not None else init_mlstm_state(cfg, B, x.dtype, x.device)
    h, (C, n, m) = _mlstm_chunk_scan(q.float(), k.float(), v.float(), log_f, log_i,
                                     st["C"], st["n"], st["m"], chunk=min(chunk, max(T, 1)))
    h = h * p["o_norm"][None, :, None, :]
    h = h.transpose(1, 2).reshape(B, T, r).to(x.dtype)
    y = h * F.silu(z)
    return y @ p["w_down"], {"C": C, "n": n, "m": m, "conv": new_conv}


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    r, H, w = cfg.rnn_width, cfg.n_heads, cfg.conv_width
    dh = r // H
    return {
        "C": zeros((batch, H, dh, dh), torch.float32, device),
        "n": zeros((batch, H, dh), torch.float32, device),
        "m": torch.full((batch, H), -1e30, dtype=torch.float32, device=device),
        "conv": zeros((batch, w - 1, r), dtype, device),
    }


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, sequential
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, r = cfg.d_model, cfg.rnn_width
    return {
        "w_in": leaf(normal(gen, (d, 4 * r), dtype), "embed", "rnn_gates"),
        "r_rec": leaf(normal(gen, (r, 4 * r), dtype, scale=0.01), "rnn", "rnn_gates"),
        "b": leaf(zeros((4 * r,), torch.float32, gen.device), "rnn_gates"),
        "w_out": leaf(normal(gen, (r, d), dtype), "rnn", "embed"),
    }


def apply_slstm(
    p: Dict, cfg: ModelConfig, x: torch.Tensor, state: Optional[Dict] = None
) -> Tuple[torch.Tensor, Dict]:
    """Sequential sLSTM with exponential gating + stabiliser (xLSTM §2.1).
    state={"c", "n", "h", "m"}, each (B,R) float32."""
    B, T, _ = x.shape
    pre = (x @ p["w_in"]).float()
    if state is None:
        state = init_slstm_state(cfg, B, x.dtype, x.device)
    c, n, h, m = (state[k] for k in ("c", "n", "h", "m"))
    rrec = p["r_rec"].float()
    hs = []
    for t in range(T):
        g = pre[:, t] + h @ rrec + p["b"]
        zi, zf, zz, zo = g.chunk(4, dim=-1)
        log_f = F.logsigmoid(zf)
        m_new = torch.maximum(log_f + m, zi)
        i = torch.exp(zi - m_new)
        f = torch.exp(log_f + m - m_new)
        c = f * c + i * torch.tanh(zz)
        n = f * n + i
        h = torch.sigmoid(zo) * c / torch.clamp(n.abs(), min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    return y @ p["w_out"], {"c": c, "n": n, "h": h, "m": m}


def init_slstm_state(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    r = cfg.rnn_width
    return {
        "c": zeros((batch, r), torch.float32, device),
        "n": zeros((batch, r), torch.float32, device),
        "h": zeros((batch, r), torch.float32, device),
        "m": torch.full((batch, r), -1e30, dtype=torch.float32, device=device),
    }
