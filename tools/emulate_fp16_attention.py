#!/usr/bin/env python3
"""Emulates, on the CPU, the roundings the bf16 attention kernels could give
P and dS, and prints each one's share of ``chip_smoke.py``'s limits.

The bf16 backward (``csrc/flash_attention_bwd_sm90.cu``) holds each
gradient to 2^-7 |want| + 1e-3 max|want| of the plain backward
(``ref.ref_flash_attention_backward``), the forward holds its output to
2^-7 |want| + 1e-4 of the plain forward.  Here q, k, v and do are random
bf16 (standard normal, do also times 2^-16, a mean loss's gradient), the
mask causal, and the kernels' arithmetic is carried in float64 except for
one rounding of P and of dS before their products:

* backward, "bf16": P and dS rounded once to bf16 (what the two-part design
  avoids);
* backward, "fp16": the design up to 128 columns: q, k, v and do as fp16
  copies times ``fp16_exponent``'s powers of two, P as P 2^15 and dS as dS
  2^(ev + ed - 25), each rounded once to fp16;
* backward, "fp16, no scales": fp16 copies and roundings without the
  powers of two (where do is small, dS falls below fp16's normal range);
* forward, "fp16 P everywhere": P (exp(s - row max)) rounded once to fp16
  before P V, the row sum in float64; rows grouped by the keys they see;
* forward, "by the rule": the design up to 128 columns that the kernels
  dropped, P rounded once to fp16 (as p 2^7) on the 128-row blocks whose
  every row sees ``ONE_PART_KEYS`` keys or more (``one_part_blocks``), in
  two bf16 parts (hi = p truncated, lo = bf16(p - hi)) on the others; up
  to 64 columns v in fp16 tile by tile, each 128-key tile times a power of
  two of its own (``flash_attention_bwd_sm90.fp16_tiles``); rows grouped
  by the kind of their block;
* forward, with ``--keys-sweep``: rows that see N keys (N = 128 ... 2048,
  about ``--elements`` outputs each, ``--rows`` rows at a time, q, k, v
  random bf16 at D = ``--d``, 120 by default; up to 64 v in fp16 tile by
  tile as above), P rounded once to fp16 as p 2^7 against the exact P, the
  reference point the first 128 keys' max as the kernel's first tile sets
  it: the largest error over its allowance, max(2^-8 |o|, 0.9e-4) (an
  error under it cannot move a bf16 output two ulps, so it cannot break
  the limit), and over the limit itself.  Slow: minutes at the default
  size;
* forward, with ``--peaked``: rows whose scores peak on a few keys, as a
  trained model's do: each of ``--rows`` query rows (256 by default) is
  ``temp`` times the sum of ``hits`` of N random bf16 keys (temp 0.5, 1, 2;
  hits 1, 2, 4; N = 1100, 2048, 4096, 16384; D = 64 and 128), v random;
  P rounded once to fp16 (as p 2^7; up to 64 columns against v's tiles in
  fp16 as above) and in two bf16 parts, each against the plain forward:
  the largest share of the limit of each, and the mean weight of the
  ``hits`` largest probabilities of a row.

Each line is one JSON object: the case, and the largest share of the limit
per gradient (dq, dk, dv) or per group of rows.  No card is used; the
numbers are an emulation's, not the kernels'.

Usage, from the root of a checkout::

    python3 tools/emulate_fp16_attention.py [--seed N]
        [--keys-sweep [--elements N] [--rows N] [--d D]] [--peaked [--rows N]]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch  # noqa: E402

from repro_torch.kernels.flash_attention_bwd_sm90 import (  # noqa: E402
    fp16_exponent, fp16_tiles)
from repro_torch.kernels.ref import (ref_flash_attention,  # noqa: E402
                                     ref_flash_attention_backward)

BWD_REL, BWD_FLOOR = 2.0 ** -7, 1e-3      # chip_smoke.py FLASH_BWD_BF16_REL, _FLOOR
ONE_PART_KEYS, ONE_PART_ROWS = 1024, 128   # the dropped rule: keys a row, rows a block
FWD_REL, FWD_FLOOR = 2.0 ** -7, 1e-4      # chip_smoke.py FLASH_BF16_REL, _FLOOR
BWD_SHAPES = [(2, 4, 64, 32), (1, 4, 1024, 64), (1, 2, 2048, 64), (1, 4, 512, 128),
              (1, 2, 2048, 128), (1, 1, 4096, 120)]
FWD_SHAPES = [(1, 4, 1024, 128), (1, 4, 1024, 120), (1, 4, 2048, 128), (1, 4, 2048, 120),
              (1, 4, 2048, 64)]


def share(got, want, rel, floor_of_max):
    """Largest |got - want| / (rel |want| + floor): floor a multiple of
    max|want| (the backward's) or absolute (the forward's, as a tensor)."""
    diff, wf = (got.double() - want.double()).abs(), want.double().abs()
    return (diff / (rel * wf + floor_of_max)).amax().item()


def one_part_blocks(T, causal):
    """[lo, hi): the 128-row blocks of a (T, T) call, causal or unmasked,
    whose every row sees ``ONE_PART_KEYS`` keys or more (row i sees i + 1
    keys causal, T unmasked)."""
    lo = -(-(ONE_PART_KEYS - 1) // ONE_PART_ROWS) if causal else 0
    hi = -(-T // ONE_PART_ROWS)
    return (lo, hi) if T >= ONE_PART_KEYS and lo < hi else (0, 0)


def causal_probs(q, k, scale):
    """exp(s - lse) of causal attention in float64, and the lse."""
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    T = s.shape[-1]
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    lse = torch.logsumexp(s, -1, keepdim=True)
    return torch.exp(s - lse), s


def emulate_backward(q, k, v, o, do, how):
    """dq, dk, dv (bf16) with P and dS rounded once as ``how`` says."""
    D = q.shape[-1]
    scale = D ** -0.5
    if how == "fp16":
        e = {n: int(fp16_exponent(t.abs().max())) for n, t in zip("qkvd", (q, k, v, do))}
    else:
        e = dict.fromkeys("qkvd", 0)
    cast = (lambda t, n: (t.double() * 2.0 ** e[n]).half().double()) if how != "bf16" else \
        (lambda t, n: t.double())
    qh, kh, vh, dh = cast(q, "q"), cast(k, "k"), cast(v, "v"), cast(do, "d")
    p, _ = causal_probs(qh * 2.0 ** -e["q"], kh * 2.0 ** -e["k"], scale)
    delta = (do.double() * o.double()).sum(-1, keepdim=True)
    dp = (dh @ vh.transpose(-1, -2)) * 2.0 ** -(e["v"] + e["d"])
    ds = p * (dp - delta)
    if how == "bf16":
        pr, dsr, ps, dss = p.bfloat16().double(), ds.bfloat16().double(), 0, 0
    else:
        ps, dss = (15, e["v"] + e["d"] - 25) if how == "fp16" else (0, 0)
        pr = (p * 2.0 ** ps).half().double() * 2.0 ** -ps
        dsr = (ds * 2.0 ** dss).half().double() * 2.0 ** -dss
    dv = pr.transpose(-1, -2) @ (dh * 2.0 ** -e["d"])
    dk = dsr.transpose(-1, -2) @ (qh * 2.0 ** -e["q"]) * scale
    dq = dsr @ (kh * 2.0 ** -e["k"]) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def v_as_taken(v):
    """v (..., T, D) as the one-part P V takes it up to 64 columns: each
    128-key tile in fp16 times its own power of two (``fp16_tiles``), back
    in float64."""
    h, e = fp16_tiles(v)
    tiles = h.double().unflatten(-2, (e.shape[-1], 128)) * torch.exp2(-e.double())[..., None, None]
    return tiles.flatten(-3, -2)[..., :v.shape[-2], :]


def keys_sweep(g, elements, D=120, rows=4096):
    """One JSON line a key count N: the one-part rounding's largest error
    over rows that see N keys, against its allowance and the limit."""
    for N in (128, 192, 256, 384, 512, 768, 1024, 2048):
        worst_allow = worst_limit = 0.0
        n = 0
        while n < elements:
            q = torch.randn((rows, D), generator=g).bfloat16().float()
            k = torch.randn((rows, N, D), generator=g).bfloat16().float()
            v = torch.randn((rows, N, D), generator=g).bfloat16()
            vt = v_as_taken(v) if D <= 64 else v.double()
            v = v.double()
            s = torch.einsum("rd,rnd->rn", q, k) * D ** -0.5
            p = torch.exp(s - s[:, :128].amax(-1, keepdim=True))
            lsum = p.double().sum(-1, keepdim=True)
            want = torch.einsum("rn,rnd->rd", p.double(), v) / lsum
            got = torch.einsum("rn,rnd->rd", (p * 2.0 ** 7).half().double() * 2.0 ** -7, vt) / lsum
            err = (got - want).abs()
            allow = torch.maximum(want.abs() * 2.0 ** -8, torch.full_like(want, 0.9 * FWD_FLOOR))
            worst_allow = max(worst_allow, float((err / allow).max()))
            worst_limit = max(worst_limit, float((err / (FWD_REL * want.abs() + FWD_FLOOR)).max()))
            n += want.numel()
        print(json.dumps({"pass": "forward", "rounding": "fp16 P", "d": D, "keys": N,
                          "elements": n,
                          "max_err_over_allowance": worst_allow,
                          "max_err_over_limit": worst_limit}), flush=True)


def peaked(g, rows):
    """One JSON line a (D, N, temp, hits): the shares of the limit of one
    fp16 part and of two bf16 parts of P on rows whose scores peak."""
    for D in (64, 128):
        for N in (1100, 2048, 4096, 16384):
            for temp in (0.5, 1.0, 2.0):
                for hits in (1, 2, 4):
                    k = torch.randn((N, D), generator=g).bfloat16()
                    v = torch.randn((N, D), generator=g).bfloat16()
                    idx = torch.randint(0, N, (rows, hits), generator=g)
                    q = (k.float()[idx].sum(1) * temp).bfloat16()
                    want = ref_flash_attention(q[None, None], k[None, None], v[None, None],
                                               causal=False)[0, 0]
                    s = (q.double() @ k.double().T) * D ** -0.5
                    p = torch.exp(s - s.amax(-1, keepdim=True))
                    lsum = p.sum(-1, keepdim=True)
                    one = (p * 2.0 ** 7).half().double() * 2.0 ** -7
                    top = (p.float().view(torch.int32) & -65536).view(torch.float32).double()
                    two = top + (p - top).bfloat16().double()
                    v1 = v_as_taken(v) if D <= 64 else v.double()
                    floor = torch.tensor(FWD_FLOOR, dtype=torch.float64)
                    out = {name: share(((pp @ vv) / lsum).bfloat16(), want, FWD_REL, floor)
                           for name, pp, vv in (("one fp16 part", one, v1),
                                                ("two bf16 parts", two, v.double()))}
                    weight = float((p / lsum).topk(hits, -1).values.sum(-1).mean())
                    print(json.dumps({"pass": "forward", "rounding": "peaked scores", "d": D,
                                      "keys": N, "rows": rows, "temp": temp, "hits": hits,
                                      "top_weight": weight, "share": out}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys-sweep", action="store_true",
                    help="the forward's one-part rounding error by the keys a row sees")
    ap.add_argument("--elements", type=int, default=3_000_000,
                    help="outputs a key count in the sweep")
    ap.add_argument("--rows", type=int, default=None,
                    help="rows at a time in the sweep (4096), query rows with --peaked (256)")
    ap.add_argument("--peaked", action="store_true",
                    help="the forward's roundings of P on rows whose scores peak on a few keys")
    ap.add_argument("--d", type=int, default=120, help="head width of the sweep")
    args = ap.parse_args()
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    g = torch.Generator().manual_seed(args.seed)
    if args.keys_sweep:
        keys_sweep(g, args.elements, D=args.d, rows=args.rows or 4096)
        return
    if args.peaked:
        peaked(g, args.rows or 256)
        return
    for B, H, T, D in BWD_SHAPES:
        q, k, v, do = (torch.randn((B, H, T, D), generator=g).bfloat16() for _ in range(4))
        o, lse = ref_flash_attention(q, k, v, causal=True, return_lse=True)
        for do_scale in (1.0, 2.0 ** -16):
            d = (do.float() * do_scale).bfloat16()
            want = ref_flash_attention_backward(q, k, v, o, lse, d, causal=True)
            for how in ("bf16", "fp16", "fp16, no scales"):
                if how == "fp16, no scales" and do_scale == 1.0:
                    continue
                got = emulate_backward(q, k, v, o, d, how)
                shares = [share(a, w, BWD_REL, BWD_FLOOR * w.double().abs().max())
                          for a, w in zip(got, want)]
                print(json.dumps({"pass": "backward", "shape": [B, H, T, D],
                                  "do_scale": do_scale, "rounding": how,
                                  "share": dict(zip(("dq", "dk", "dv"), shares))}), flush=True)
    for B, H, T, D in FWD_SHAPES:
        q, k, v = (torch.randn((B, H, T, D), generator=g).bfloat16() for _ in range(3))
        for causal in (True, False):
            want = ref_flash_attention(q, k, v, causal=causal)
            s = (q.double() @ k.double().transpose(-1, -2)) * D ** -0.5
            if causal:
                s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
            p = torch.exp(s - s.amax(-1, keepdim=True))
            got = ((p.half().double() @ v.double()) / p.sum(-1, keepdim=True)).bfloat16()
            lo, hi = one_part_blocks(T, causal)
            one = torch.zeros(T, dtype=torch.bool)
            one[lo * ONE_PART_ROWS:hi * ONE_PART_ROWS] = True
            p1 = (p * 2.0 ** 7).half().double() * 2.0 ** -7
            top = (p.float().view(torch.int32) & -65536).view(torch.float32).double()
            p2 = top + (p - top).bfloat16().double()
            v1 = v_as_taken(v) if D <= 64 else v.double()
            ruled = ((torch.where(one[:, None], p1 @ v1, p2 @ v.double()))
                     / p.sum(-1, keepdim=True)).bfloat16()
            out = {}
            for name, rows in (("one-part blocks", one), ("two-part blocks", ~one)):
                if bool(rows.any()):
                    out[name] = share(ruled[:, :, rows], want[:, :, rows], FWD_REL,
                                      torch.tensor(FWD_FLOOR, dtype=torch.float64))
            print(json.dumps({"pass": "forward", "shape": [B, H, T, D], "causal": causal,
                              "rounding": "by the rule", "one_part_blocks": [lo, hi],
                              "share": out}), flush=True)
            keys = torch.arange(T) + 1 if causal else torch.full((T,), T)
            groups = {"under 128 keys": keys < 128, "128-255 keys": (keys >= 128) & (keys < 256),
                      "256 keys or more": keys >= 256}
            out = {}
            for name, rows in groups.items():
                if bool(rows.any()):
                    out[name] = share(got[:, :, rows], want[:, :, rows], FWD_REL,
                                      torch.tensor(FWD_FLOOR, dtype=torch.float64))
            print(json.dumps({"pass": "forward", "shape": [B, H, T, D], "causal": causal,
                              "rounding": "fp16 P everywhere", "share": out}), flush=True)


if __name__ == "__main__":
    main()
