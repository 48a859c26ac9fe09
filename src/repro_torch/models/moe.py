"""Mixture-of-Experts layer on one device: the JAX package's
``models/moe.py`` (top-k softmax router, sort-based capacity dispatch,
SwiGLU experts, weighted combine), with its static shapes: no value
comes to the host, so a CUDA graph of a decode step replays it.

The dispatch is JAX's ``grouped_ffn``: a stable sort of the copies by
expert, each expert's first copy found by ``searchsorted``, a copy kept
while its place in its expert is below the capacity C, the kept copies
scattered into an (E, C, d) buffer that batched products run the experts
over.  Where the copies are no more than the experts (T k <= E: every
decoded token, the engine decoding one at a time), that layout would
read every expert's weights for a few rows (qwen3: 1.2 GB a layer for
one token), so there each copy's expert weights are gathered instead
(``index_select``, a static (T k, d, f)) and its rows multiplied alone;
the values are those of the buffer's rows, the dropped copies masked
the same way.

The combine adds a token's k weighted copies in the order the JAX
``.at[tok].add`` applies them, sorted by expert and rounded to the
activation dtype after each add, so bf16 rounds where JAX's does.
(``index_add_`` on the card adds with atomics, in an order that changes
from run to run, and a replay would differ from the eager step.)

Training (``inference=False``, JAX's default) keeps each expert's first
``_capacity(T, E, k, capacity_factor)`` copies and drops the rest; the
combine weights are differentiable through the router's autograd
Function, and the dropped copies add zero.  Serving passes
``inference=True`` (dropless up to 1024 tokens).

Shared experts (deepseek-v3's ``n_shared_experts``) are one dense SwiGLU
of ``expert_ff * n_shared_experts`` under ``p["shared"]``, always on, its
output added to the routed one (JAX ``models/moe.py``, and its
``Model._routed``, which adds the same sum).

Expert parallelism (``ep``, JAX's ``shard_map`` branch): the experts are
split evenly over a process group; every process routes all its tokens
on the replicated router, dispatches only the copies whose expert it
holds (the others take no capacity) and the partial outputs are summed
over the group, one (T, d) all-reduce, as JAX's ``psum``.  Per-expert
capacity is the same with or without EP, so the kept copies are the
same.  The activations and the router enter the EP region through an
identity whose backward sums over the group, and the output leaves it
through the all-reduce whose backward is the identity (the loss after
it is the same on every process of the group), so autograd gives every
process the whole gradient of what it holds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models import backend
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_init, silu


@dataclasses.dataclass(frozen=True)
class EPContext:
    """How the MoE layer is placed (None = one process, all experts
    local): the process group holding the experts, its size and this
    process's rank in it (its expert slice); and the data-parallel group
    over which the batch is split, its size and this process's index in
    it.  Over the dp group the layer keeps the single-device semantics
    of the global batch: the capacity is that of all its tokens, and an
    expert keeps its first ``capacity`` copies in the global order (the
    processes' tokens in dp order), so a copy is kept or dropped as on
    one device."""

    group: Any = None
    n_shards: int = 1
    rank: int = 0
    dp_group: Any = None
    dp_size: int = 1
    dp_rank: int = 0


class _EnterEP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group
    (each process's gradient covers only its experts' copies)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _LeaveEP(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


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


def grouped_ffn(x, idx, w, wg, wu, wd, capacity: int, valid=None,
                offsets=None):
    """x (T, d); idx (T, k) expert ids; w (T, k) combine weights in x's
    dtype; wg, wu (E, d, f); wd (E, f, d); ``valid`` (T, k) bool or None
    (all valid).  Each expert keeps its first ``capacity`` copies in a
    stable sort by expert; the rest are dropped.  An invalid copy sorts
    as expert E, after every valid one, takes no capacity and adds zero.
    ``offsets`` ((E,) integer tensor on x's device, default 0): copies of
    each expert that other processes' tokens, earlier in the global
    order, already put before these (they count against its capacity).
    Static shapes throughout, no host read.  Returns (T, d)."""
    t, d = x.shape
    k = idx.shape[1]
    e = wg.shape[0]
    c = capacity
    n = t * k
    flat_e = idx.reshape(-1).long()
    if valid is not None:
        flat_e = torch.where(valid.reshape(-1), flat_e, e)
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(e + 1,
                                                       device=x.device))
    pos_in_e = torch.arange(n, device=x.device) - starts[sorted_e]
    if offsets is not None:
        pos_in_e = pos_in_e + torch.cat(
            [offsets.to(pos_in_e), pos_in_e.new_zeros(1)])[sorted_e]
    keep = (pos_in_e < c) & (sorted_e < e)
    tok = order // k
    xs = x[tok]                          # the copies, sorted by expert
    if n <= e:
        # each copy through its own expert's gathered weights
        ex = sorted_e.clamp(max=e - 1)
        xr = xs[:, None]
        h = silu(torch.bmm(xr, wg.index_select(0, ex))) \
            * torch.bmm(xr, wu.index_select(0, ex))
        y = torch.bmm(h, wd.index_select(0, ex))[:, 0]
    else:
        slot = torch.where(keep, sorted_e * c + pos_in_e, e * c)
        buf = x.new_zeros(e * c + 1, d).index_copy(0, slot, xs)
        xe = buf[:e * c].view(e, c, d)
        h = silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
        ye = torch.bmm(h, wd).view(e * c, d)
        y = ye[slot.clamp(max=e * c - 1)]
    y = torch.where(keep[:, None], y, 0.0) * w.reshape(-1)[order][:, None]
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


def moe_apply(p: dict, cfg: ModelConfig, x, ep: EPContext | None = None,
              inference: bool = False):
    """x (B, S, d) -> (B, S, d), the JAX package's dispatch.  Training
    (the default): capacity = ``_capacity(T, E, k, capacity_factor)``,
    over-capacity copies dropped.  ``inference``: capacity = T rounded up
    to 8, dropless, capped at twice the capacity factor's for T > 1024.
    The shared experts' SwiGLU, where the layer has one, is added to the
    routed output.  With ``ep`` of more than one shard, ``p`` holds this
    process's slice of the experts (``p_local``: E / n_shards of them,
    the full router) and ``x`` the same activations on every process of
    ``ep.group``; the output is the whole layer's on each."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    router_w = p["router"]
    split = ep is not None and ep.n_shards > 1
    if split:
        xt = _EnterEP.apply(xt, ep.group)
        router_w = _EnterEP.apply(router_w, ep.group)
    w, idx = _route(router_w, xt, cfg.top_k)
    w = w.to(x.dtype)
    dp = ep is not None and ep.dp_size > 1
    t = b * s * (ep.dp_size if dp else 1)
    if inference:
        cap = max(8, -(-t // 8) * 8)
        if t > 1024:
            cap = min(cap, _capacity(t, cfg.n_experts, cfg.top_k,
                                     2.0 * cfg.capacity_factor))
    else:
        cap = _capacity(t, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    offsets = _dp_offsets(idx, cfg.n_experts, ep) if dp else None
    if split:
        # capacity per expert is mesh-independent: the expected copies per
        # expert are T*k/E whether or not the experts are split
        e_loc = cfg.n_experts // ep.n_shards
        mine = torch.div(idx, e_loc, rounding_mode="floor") == ep.rank
        idx_loc = torch.where(mine, idx - ep.rank * e_loc, 0)
        y = grouped_ffn(xt, idx_loc, w, p["wg"], p["wu"], p["wd"], cap,
                        valid=mine, offsets=None if offsets is None else
                        offsets[ep.rank * e_loc:(ep.rank + 1) * e_loc])
        y = _LeaveEP.apply(y, ep.group)
    elif offsets is None:
        y = grouped_ffn(xt, idx, w, p["wg"], p["wu"], p["wd"], cap)
    else:
        y = grouped_ffn(xt, idx, w, p["wg"], p["wu"], p["wd"], cap,
                        offsets=offsets)
    out = y.reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x)
    return out


def _dp_offsets(idx, n_experts: int, ep: EPContext):
    """Per expert, the copies routed to it by the dp processes before this
    one, an (E,) tensor on idx's device (one all-gather of the (E,)
    counts over the dp group)."""
    counts = torch.bincount(idx.reshape(-1).long(), minlength=n_experts)
    every = [torch.empty_like(counts) for _ in range(ep.dp_size)]
    dist.all_gather(every, counts, group=ep.dp_group)
    return sum(every[:ep.dp_rank], torch.zeros_like(counts))


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
