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

Training (``inference=False``, JAX's default) keeps each expert's first
``_capacity(T, E, k, capacity_factor)`` copies and drops the rest; the
combine weights are differentiable through the router's autograd
Function, and the dropped copies add zero.  Serving passes
``inference=True`` (dropless up to 1024 tokens).

Shared experts (deepseek-v3's ``n_shared_experts``) are one dense SwiGLU
of ``expert_ff * n_shared_experts`` under ``p["shared"]``, always on, its
output added to the routed one (JAX ``models/moe.py``, and its
``Model._routed``, which adds the same sum).

Not ported: expert parallelism (JAX's ``shard_map``/``psum`` branch)
raises, naming its ``ROADMAP.md`` item.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import backend
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_init, silu

_LATER = "ROADMAP.md Queue 1 item 4.5 (the rest of the LM stack)"


# elements of an fp32 draw past which a narrower stack is drawn slab by
# slab (deepseek-v3's (256, 7168, 2048) expert stack is 15 GB in fp32)
_SLAB = 2 ** 28


def _fill_normal(out, gen: torch.Generator, scale: float):
    """``out`` filled with a standard normal drawn in fp32 on ``gen``'s
    device and scaled, in slabs of at most ``_SLAB`` elements along its
    first axis (a row larger than that is filled the same way)."""
    row = math.prod(out.shape[1:])
    if out.numel() <= _SLAB:
        out.copy_(torch.randn(out.shape, generator=gen, device=gen.device,
                              dtype=torch.float32).mul_(scale))
    elif row > _SLAB:
        for r in out:
            _fill_normal(r, gen, scale)
    else:
        step = _SLAB // row
        for i in range(0, out.shape[0], step):
            rows = min(step, out.shape[0] - i)
            out[i:i + rows] = torch.randn(
                rows, *out.shape[1:], generator=gen, device=gen.device,
                dtype=torch.float32).mul_(scale)
    return out


def _normal(gen: torch.Generator, shape, scale: float, dtype):
    """Standard normal drawn in fp32 on ``gen``'s device, scaled, cast.  A
    stack of more than ``_SLAB`` elements cast to a narrower dtype is
    drawn slab by slab (:func:`_fill_normal`), so the fp32 draw stays
    ~1 GB beside the result."""
    if math.prod(shape) <= _SLAB or dtype == torch.float32:
        w = torch.randn(*shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)
    return _fill_normal(torch.empty(shape, dtype=dtype, device=gen.device),
                        gen, scale)


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             n: int | None = None) -> dict:
    """One layer's router (d, E) fp32 and experts wg, wu (E, d, f), wd
    (E, f, d) in ``cfg.dtype``, with the JAX package's scales; with
    shared experts, their SwiGLU (d -> f * n_shared_experts) under
    ``"shared"``.  With ``n``, the leaves of ``n`` such layers (no shared
    experts) stacked along a new first axis, each layer drawn in turn
    straight into its slice, slab by slab (a Jamba period's MoE
    sublayers: no second copy of the stack, no fp32 draw of a whole
    expert stack)."""
    d, ff, e = cfg.d_model, cfg.expert_ff, cfg.n_experts
    scale = d ** -0.5
    leaves = {"router": ((d, e), scale, torch.float32),
              "wg": ((e, d, ff), scale, cfg.dtype),
              "wu": ((e, d, ff), scale, cfg.dtype),
              "wd": ((e, ff, d), ff ** -0.5, cfg.dtype)}
    if n is not None:
        if cfg.n_shared_experts:
            raise ValueError("stacked MoE layers take no shared experts")
        p = {k: torch.empty((n, *shape), dtype=dt, device=gen.device)
             for k, (shape, _, dt) in leaves.items()}
        for i in range(n):
            for k, (_, sc, _) in leaves.items():
                _fill_normal(p[k][i], gen, sc)
        return p
    p = {k: _normal(gen, shape, sc, dt)
         for k, (shape, sc, dt) in leaves.items()}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, ff * cfg.n_shared_experts, cfg.dtype)
    return p


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
    pieces = []
    # split and unbind, not an index per expert: an index's backward
    # would fill and add a gradient the size of all the copies (or of a
    # whole expert stack) for every expert
    for xe, n, g, u, dn in zip(xs.split(counts), counts, wg.unbind(0),
                               wu.unbind(0), wd.unbind(0)):
        if n == 0:
            continue
        kept = min(n, capacity)
        xe = xe[:kept]
        pieces.append((silu(xe @ g) * (xe @ u)) @ dn)
        if kept < n:                     # dropped copies add zero
            pieces.append(xs.new_zeros(n - kept, d))
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


def moe_apply(p: dict, cfg: ModelConfig, x, ep=None,
              inference: bool = False):
    """x (B, S, d) -> (B, S, d), the JAX package's dispatch.  Training
    (the default): capacity = ``_capacity(T, E, k, capacity_factor)``,
    over-capacity copies dropped.  ``inference``: capacity = T rounded up
    to 8, dropless, capped at twice the capacity factor's for T > 1024.
    The shared experts' SwiGLU, where the layer has one, is added to the
    routed output."""
    if ep is not None:
        raise NotImplementedError(f"expert parallelism is not ported yet: "
                                  f"{_LATER}")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    w, idx = _route(p["router"], xt, cfg.top_k)
    w = w.to(x.dtype)
    t = b * s
    if inference:
        cap = max(8, -(-t // 8) * 8)
        if t > 1024:
            cap = min(cap, _capacity(t, cfg.n_experts, cfg.top_k,
                                     2.0 * cfg.capacity_factor))
    else:
        cap = _capacity(t, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    y = grouped_ffn(xt, idx, w, p["wg"], p["wu"], p["wd"], cap)
    out = y.reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x)
    return out


def aux_load_balance_loss(p: dict, cfg: ModelConfig, x):
    """Switch-style load-balance auxiliary loss (E * sum over experts of
    the fraction of routed copies times the mean probability), the JAX
    package's, which no loss of either package adds."""
    b, s, d = x.shape
    logits = x.reshape(b * s, d).float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    _, idx = backend.moe_router(logits.detach(), cfg.top_k)
    frac = torch.bincount(idx.reshape(-1).long(),
                          minlength=cfg.n_experts).float() / idx.numel()
    return cfg.n_experts * (frac * probs.mean(0)).sum()
