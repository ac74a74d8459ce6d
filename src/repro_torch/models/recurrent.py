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

Under a mesh both loops run on each rank's local slices (``local_scan``):
the mLSTM's for each (batch row, head), the sLSTM's for each batch row,
whole over its channels.  On fake tensors (the dry run) each loop is one
custom op with a shape function and a FLOP formula.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed import partitioning as PT
from repro_torch.distributed.axes import constrain
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import merge_heads
from repro_torch.models.param_util import leaf, normal, ones, zeros

# ---------------------------------------------------------------------------
# temporal conv
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv. x: (B,T,D); w: (W,D); state: (B,W-1,D).
    A DTensor ``x`` split over its sequence (``tp_fsdp_sp``) goes to
    ``_split_causal_conv``."""
    if PT.is_distributed(x) and any(p.is_shard(1) for p in x.placements):
        return _split_causal_conv(x, w, state)
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xx = torch.cat([state, x], dim=1)                   # (B, T+W-1, D)
    out = sum(xx[:, i : i + x.shape[1], :] * w[i] for i in range(W))
    new_state = xx[:, -(W - 1):, :] if W > 1 else state
    return out, new_state


def _split_causal_conv(x, w, state):
    """``_causal_conv`` of a sequence split over mesh axes, on each rank's
    local steps: a rank needs the W-1 steps before its first, the previous
    rank's last ones.  Every rank's last W-1 steps are all-gathered (W-1
    rows a rank, not the sequence); the first rank takes ``state``
    instead, and every rank's last steps are the new state of the last.
    The weight's gradient is a partial sum over the axes that split the
    rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    W = w.shape[0]
    B, T, D = x.shape
    xp = [p if p.is_shard() else Replicate() for p in x.placements]
    xl = x.redistribute(mesh, xp).to_local()
    t0, tl = PT.local_range(mesh, xp, 1, T)
    if tl < W - 1 or T % tl:
        raise NotImplementedError(f"a causal conv of width {W} over {tl} of {T} steps a rank")
    wp = [Shard(1) if p.is_shard(2) else Replicate() for p in xp]
    wl = w.redistribute(mesh, wp).to_local(
        grad_placements=[Partial() if p.is_shard(0) or p.is_shard(1) else q
                         for p, q in zip(xp, wp)])
    whole = [Replicate() if p.is_shard(1) else p for p in xp]
    tails = PT.from_local(xl[:, tl - (W - 1):], mesh, xp, (B, (T // tl) * (W - 1), D))
    # each rank reads only its neighbour's rows: their gradient is partial
    tails = tails.redistribute(mesh, whole).to_local(
        grad_placements=[Partial() if p.is_shard(1) else p for p in xp])   # (b, ranks*(W-1), d)
    # the previous rank's rows; on the first rank some rows times 0 (every
    # rank then takes part in their gradient's reduce-scatter) plus ``state``
    j = t0 // tl
    prev = tails[:, max(j - 1, 0) * (W - 1):max(j, 1) * (W - 1)] * float(j > 0)
    if state is not None:
        prev = prev + state.redistribute(mesh, whole).to_local() * float(j == 0)
    xx = torch.cat([prev, xl], dim=1)
    out = sum(xx[:, i:i + tl, :] * wl[i] for i in range(W))
    new_state = PT.from_local(tails[:, -(W - 1):], mesh, whole, (B, W - 1, D))
    return PT.from_local(out, mesh, xp, (B, T, D)), new_state


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
    # under a mesh the gates' products over the split width are partial sums,
    # reduced onto that width as xb is split: left to itself, DTensor
    # reduces them onto the sequence, and the gradient of w_a, w_i then
    # contracts the flattened (batch x seq) rows split over two mesh axes,
    # one of them strided, which its sharding propagation refuses
    r_gate = torch.sigmoid(constrain(xf @ p["w_a"].float(), "batch", "seq", "rnn"))
    i_gate = torch.sigmoid(constrain(xf @ p["w_i"].float(), "batch", "seq", "rnn"))
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


def local_scan(fn, placements, args, weights=()):
    """``fn(*args, *weights)`` on each rank's local slices, the outputs
    rebuilt as DTensors placed by ``placements``.

    For a recurrence that loops in Python (a chunk or a time step at a
    time): DTensor's dispatch of each op costs more than the op, and the
    loop makes thousands of them (32768 steps of an sLSTM prefill).
    ``placements`` split only dimensions that the recurrence keeps apart
    (dimension 0, batch, and for the mLSTM dimension 1, heads), so each
    rank's slice is computed alone.  Every tensor of ``args`` (a DTensor,
    or a plain tensor whole on every rank) is taken at ``placements``;
    each weight is gathered whole, its gradient a partial sum over the
    mesh axes that split the batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, distribute_tensor
    from torch.utils._pytree import tree_map

    mesh = next(a.device_mesh for a in args if PT.is_distributed(a))

    def local(t):
        if PT.is_distributed(t):
            return t.redistribute(mesh, placements).to_local()
        return distribute_tensor(t, mesh, placements, src_data_rank=None).to_local()

    grad = [Partial() if p.is_shard(0) else Replicate() for p in placements]
    ws = [w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grad)
          if PT.is_distributed(w) else w for w in weights]
    out = fn(*[local(a) for a in args], *ws)
    return tree_map(lambda t: DTensor.from_local(t, mesh, placements, run_check=False), out)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x))`` of the mLSTM's forget gate, which is a DTensor
    under a mesh, as ``-softplus(-x)``, jax.nn.log_sigmoid's own formula:
    DTensor shards softplus and its backward as pointwise ops, while
    ``aten.log_sigmoid_forward``/``_backward`` have no sharding rule.  The
    sLSTM's loop runs on local tensors and keeps ``F.logsigmoid``."""
    return -F.softplus(-x)


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


def _mlstm(q, k, v, log_f, log_i, C, n, m, chunk: int):
    """``_mlstm_chunk_scan``; on fake tensors (the dry run) the custom op
    ``repro_torch::mlstm_scan``, whose shape function stands for the loop
    over chunks."""
    if isinstance(q, FakeTensor):
        h, C, n, m = _mlstm_op(q, k, v, log_f, log_i, C, n, m, chunk)
        return h, (C, n, m)
    return _mlstm_chunk_scan(q, k, v, log_f, log_i, C, n, m, chunk)


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
    # under a mesh the products over the split "rnn" width are partial
    # sums, reduced here to the heads' layout (and the gates whole) before
    # the scan's nonlinear ops: left partial, DTensor reduces them onto
    # whichever dimension it picks, the chunk's time steps included.  The
    # product is the reference's einsum("btr,rhk->bhtk") as a matmul
    # broadcast over the heads: einsum's backward views the permuted
    # gradient of its (b t, h k) result, which DTensor runs as a view of the
    # local tensor and which fails where the batch is not split (a batch
    # of 1 on "data" of 2, as ``tp_fsdp_sp`` serves it)
    q, k, v = (constrain(torch.matmul(xi_act[:, None], p[w].transpose(0, 1)), "batch",
                         "heads_act", None, None) for w in ("wq", "wk", "wv"))
    q = q * (dh ** -0.5)
    gates = constrain(xi.float() @ p["w_if"], "batch", None, None) + p["b_if"]
    log_i, log_f = gates.chunk(2, dim=-1)                  # (B,T,H)
    log_f = _log_sigmoid(log_f).transpose(1, 2)            # (B,H,T)
    log_i = log_i.transpose(1, 2)                          # exp input gate (log-space)

    st = state if state is not None else init_mlstm_state(cfg, B, x.dtype, x.device)
    args = (q.float(), k.float(), v.float(), log_f, log_i, st["C"], st["n"], st["m"])
    scan = functools.partial(_mlstm, chunk=min(chunk, max(T, 1)))
    if PT.is_distributed(q):
        # independent for each (batch row, head): each rank scans its own
        from torch.distributed.tensor import Replicate

        qp = tuple(pl if pl.is_shard(0) or pl.is_shard(1) else Replicate() for pl in q.placements)
        h, (C, n, m) = local_scan(scan, qp, args)
    else:
        h, (C, n, m) = scan(*args)
    h = merge_heads(h * p["o_norm"][None, :, None, :]).to(x.dtype)
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
    args = (pre,) + tuple(state[k] for k in ("c", "n", "h", "m"))
    weights = (p["r_rec"].float(), p["b"])
    if PT.is_distributed(pre):
        # each rank runs its own batch rows, whole over the channels (a
        # step's h @ r_rec mixes all of them)
        from torch.distributed.tensor import Replicate

        bp = tuple(pl if pl.is_shard(0) else Replicate() for pl in pre.placements)
        y, (c, n, h, m) = local_scan(_slstm, bp, args, weights)
    else:
        y, (c, n, h, m) = _slstm(*args, *weights)
    return y.to(x.dtype) @ p["w_out"], {"c": c, "n": n, "h": h, "m": m}


def _slstm(pre, c, n, h, m, rrec, b):
    """``_slstm_scan``; on fake tensors (the dry run) the custom op
    ``repro_torch::slstm_scan``, whose shape function stands for the loop's
    thousands of steps."""
    if isinstance(pre, FakeTensor):
        y, c, n, h, m = _slstm_op(pre, c, n, h, m, rrec, b)
        return y, (c, n, h, m)
    return _slstm_scan(pre, c, n, h, m, rrec, b)


def _slstm_scan(pre, c, n, h, m, rrec, b):
    """The sLSTM's loop over time: (h of every step (B,T,R), (c, n, h, m))."""
    hs = []
    for t in range(pre.shape[1]):
        g = pre[:, t] + h @ rrec + b
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
    return torch.stack(hs, dim=1), (c, n, h, m)


def init_slstm_state(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    r = cfg.rnn_width
    return {
        "c": zeros((batch, r), torch.float32, device),
        "n": zeros((batch, r), torch.float32, device),
        "h": zeros((batch, r), torch.float32, device),
        "m": torch.full((batch, r), -1e30, dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# the recurrences' loops as custom ops, taken by fake tensors only
# ---------------------------------------------------------------------------
# Real tensors run the loops (``_mlstm_chunk_scan``, ``_slstm_scan``) under
# autograd; a fake tensor has nothing to compute, and the loops' thousands of
# dispatches a layer (32768 sLSTM steps a prefill) would outlast the dry run's
# time limit, so there each loop is one op with a shape function, a backward
# op with another, and FLOP formulas for the products the loop does.

_T = torch.Tensor


def _with_state(out):
    return (out[0],) + tuple(out[1])


@torch.library.custom_op("repro_torch::mlstm_scan", mutates_args=())
def _mlstm_op(q: _T, k: _T, v: _T, log_f: _T, log_i: _T, C: _T, n: _T, m: _T,
              chunk: int) -> Tuple[_T, _T, _T, _T]:
    return tuple(t.clone() for t in _with_state(
        _mlstm_chunk_scan(q, k, v, log_f, log_i, C, n, m, chunk)))


@_mlstm_op.register_fake
def _(q, k, v, log_f, log_i, C, n, m, chunk):
    return tuple(torch.empty_like(t) for t in (v, C, n, m))


@torch.library.custom_op("repro_torch::mlstm_scan_backward", mutates_args=())
def _mlstm_backward_op(q: _T, k: _T, v: _T, log_f: _T, log_i: _T, C: _T, n: _T, m: _T,
                       chunk: int, gh: _T, gC: _T, gn: _T, gm: _T) -> List[_T]:
    """The loop's gradients, by running it again under ``torch.func.vjp``."""
    _, vjp = torch.func.vjp(lambda *a: _with_state(_mlstm_chunk_scan(*a, chunk)),
                            q, k, v, log_f, log_i, C, n, m)
    return list(vjp((gh, gC, gn, gm)))


@_mlstm_backward_op.register_fake
def _(q, k, v, log_f, log_i, C, n, m, chunk, gh, gC, gn, gm):
    return [torch.empty_like(t) for t in (q, k, v, log_f, log_i, C, n, m)]


def _mlstm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:8])
    ctx.chunk = inputs[8]


def _mlstm_grads(ctx, gh, gC, gn, gm):
    return tuple(_mlstm_backward_op(*ctx.saved_tensors, ctx.chunk, gh, gC, gn, gm)) + (None,)


_mlstm_op.register_autograd(_mlstm_grads, setup_context=_mlstm_setup)


def _mlstm_flop_count(q_shape, chunk: int) -> int:
    """The loop's products over T padded to whole chunks of c: per chunk
    three (c x c x Dh) ones (scores, values, normaliser keys), two of
    (c x Dh x Dh) (the carried state read and updated) and three of
    (c x Dh) (the normalisers)."""
    B, H, T, Dh = q_shape
    Tp = -(-T // chunk) * chunk
    return 2 * B * H * Tp * (3 * chunk * Dh + 2 * Dh * Dh + 3 * Dh)


@register_flop_formula(torch.ops.repro_torch.mlstm_scan)
def _mlstm_flops(q_shape, *args, **kwargs) -> int:
    return _mlstm_flop_count(q_shape, args[7])


@register_flop_formula(torch.ops.repro_torch.mlstm_scan_backward)
def _mlstm_backward_flops(q_shape, *args, **kwargs) -> int:
    """Two gradient products for each of the loop's products."""
    return 2 * _mlstm_flop_count(q_shape, args[7])


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _slstm_op(pre: _T, c: _T, n: _T, h: _T, m: _T, rrec: _T,
              b: _T) -> Tuple[_T, _T, _T, _T, _T]:
    return tuple(t.clone() for t in _with_state(_slstm_scan(pre, c, n, h, m, rrec, b)))


@_slstm_op.register_fake
def _(pre, c, n, h, m, rrec, b):
    return (pre.new_empty(pre.shape[:2] + (rrec.shape[0],)),) + tuple(
        torch.empty_like(t) for t in (c, n, h, m))


@torch.library.custom_op("repro_torch::slstm_scan_backward", mutates_args=())
def _slstm_backward_op(pre: _T, c: _T, n: _T, h: _T, m: _T, rrec: _T, b: _T, gy: _T, gc: _T,
                       gn: _T, gh: _T, gm: _T) -> List[_T]:
    """The loop's gradients, by running it again under ``torch.func.vjp``."""
    _, vjp = torch.func.vjp(lambda *a: _with_state(_slstm_scan(*a)), pre, c, n, h, m, rrec, b)
    return list(vjp((gy, gc, gn, gh, gm)))


@_slstm_backward_op.register_fake
def _(pre, c, n, h, m, rrec, b, gy, gc, gn, gh, gm):
    return [torch.empty_like(t) for t in (pre, c, n, h, m, rrec, b)]


def _slstm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _slstm_grads(ctx, gy, gc, gn, gh, gm):
    return tuple(_slstm_backward_op(*ctx.saved_tensors, gy, gc, gn, gh, gm))


_slstm_op.register_autograd(_slstm_grads, setup_context=_slstm_setup)


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_flops(pre_shape, c_shape, n_shape, h_shape, m_shape, rrec_shape, b_shape,
                 *args, **kwargs) -> int:
    """h @ r_rec at every step."""
    B, T, _ = pre_shape
    return 2 * B * T * rrec_shape[0] * rrec_shape[1]


@register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def _slstm_backward_flops(pre_shape, c_shape, n_shape, h_shape, m_shape, rrec_shape, b_shape,
                          *args, **kwargs) -> int:
    """The gradients of h @ r_rec at every step, for h and for r_rec."""
    B, T, _ = pre_shape
    return 4 * B * T * rrec_shape[0] * rrec_shape[1]
