"""Mixture-of-Experts layer on one device: the JAX package's
``models/moe.py`` (top-k softmax router, sort-based capacity dispatch,
SwiGLU experts, weighted combine), computed on the routed rows only.

The JAX ``grouped_ffn`` scatters the copies into an (E, C, d) buffer and
runs every expert over all C slots.  At inference C is the token count
rounded up to 8 (dropless), so that is 16x the routed products at
qwen3's prefill and all 128 experts' weights read for every decoded
token.  Here the same copies are kept and dropped (the first C of each
expert in a stable sort by expert, as ``jnp.argsort`` orders them) and
each expert's kept rows go through one ``torch.matmul`` each.  The
per-expert counts come to the host once per layer to cut the rows.

The combine adds a token's k weighted copies in the order the JAX
``.at[tok].add`` applies them, sorted by expert and rounded to the
activation dtype after each add, so bf16 rounds where JAX's does.
(``index_add_`` on the card adds with atomics, in an order that changes
from run to run.)

Not ported: expert parallelism (JAX's ``shard_map``/``psum`` branch),
shared experts and ``aux_load_balance_loss`` raise, naming their
``ROADMAP.md`` item.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import backend
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import silu

_LATER = "ROADMAP.md Queue 1 item 4.5 (the rest of the LM stack)"


def _normal(gen: torch.Generator, shape, scale: float, dtype):
    """Standard normal drawn in fp32 on ``gen``'s device, scaled, cast."""
    w = torch.randn(*shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's router (d, E) fp32 and experts wg, wu (E, d, f), wd
    (E, f, d) in ``cfg.dtype``, with the JAX package's scales."""
    if cfg.n_shared_experts:
        raise NotImplementedError(f"shared experts are not ported yet: "
                                  f"{_LATER}")
    d, ff, e = cfg.d_model, cfg.expert_ff, cfg.n_experts
    scale = d ** -0.5
    return {"router": _normal(gen, (d, e), scale, torch.float32),
            "wg": _normal(gen, (e, d, ff), scale, cfg.dtype),
            "wu": _normal(gen, (e, d, ff), scale, cfg.dtype),
            "wd": _normal(gen, (e, ff, d), ff ** -0.5, cfg.dtype)}


def grouped_ffn(x, idx, w, wg, wu, wd, capacity: int):
    """x (T, d); idx (T, k) expert ids; w (T, k) combine weights in x's
    dtype; wg, wu (E, d, f); wd (E, f, d).  Each expert keeps its first
    ``capacity`` copies in a stable sort by expert; the rest are dropped.
    Returns (T, d)."""
    t, d = x.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1).long()
    _, order = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=wg.shape[0]).tolist()
    tok = order // k
    xs = x[tok]                          # the copies, sorted by expert
    pieces, start = [], 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        kept = min(n, capacity)
        xe = xs[start:start + kept]
        pieces.append((silu(xe @ wg[e]) * (xe @ wu[e])) @ wd[e])
        if kept < n:                     # dropped copies add zero
            pieces.append(xs.new_zeros(n - kept, d))
        start += n
    y = torch.cat(pieces) * w.reshape(-1)[order][:, None]
    # regroup by token (stable: each token's copies stay in expert order)
    _, by_tok = torch.sort(tok, stable=True)
    y = y[by_tok].view(t, k, d)
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out


def _route(router_w, x, top_k: int):
    logits = x.float() @ router_w
    return backend.moe_router(logits, top_k)


def _capacity(tokens: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(math.ceil(tokens * top_k / n_experts * cf))
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def moe_apply(p: dict, cfg: ModelConfig, x, ep=None):
    """x (B, S, d) -> (B, S, d), the JAX package's inference dispatch
    (``inference=True``; the port serves, it does not train): capacity =
    T rounded up to 8, dropless, capped at twice the capacity factor's
    for T > 1024."""
    if ep is not None:
        raise NotImplementedError(f"expert parallelism is not ported yet: "
                                  f"{_LATER}")
    if "shared" in p:
        raise NotImplementedError(f"shared experts are not ported yet: "
                                  f"{_LATER}")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    w, idx = _route(p["router"], xt, cfg.top_k)
    w = w.to(x.dtype)
    t = b * s
    cap = max(8, -(-t // 8) * 8)
    if t > 1024:
        cap = min(cap, _capacity(t, cfg.n_experts, cfg.top_k,
                                 2.0 * cfg.capacity_factor))
    y = grouped_ffn(xt, idx, w, p["wg"], p["wu"], p["wd"], cap)
    return y.reshape(b, s, d)


def aux_load_balance_loss(p: dict, cfg: ModelConfig, x):
    raise NotImplementedError(f"the load-balance loss (training) is not "
                              f"ported yet: {_LATER}")
