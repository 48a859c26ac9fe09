"""Optimizers, the JAX package's ``train/optimizer.py`` on tensor dicts:
AdamW (moments in ``moment_dtype``) and a factored-second-moment variant
("adafactor" mode: bf16 first moment, row and column second moments).

The update is JAX's op for op in fp32: global-norm clipping, bias
correction, decoupled weight decay on leaves of two or more dims (the
layer-stacked leaves count their layer axis, as in JAX), params cast
back to their own dtype.  It is not ``torch.optim``: that would round
elsewhere.  Unlike JAX's pure update it writes the params and moments
in place, and it goes through each leaf piece by piece along its first
axis, so the fp32 temporaries stay one piece large (a layer-stacked
in_proj of falcon-mamba-7b is 4.3 G values; one fp32 copy of it would
be 17 GB).  The pieces change nothing: the update is elementwise, and a
factored leaf is cut only along an axis its row and column means do not
cross.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.convert import leaves, tree_map
from repro_torch.models.config import _DTYPES

_PIECE = 1 << 24            # values per piece of a leaf (64 MB in fp32)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # adafactor mode uses bf16 first moment


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the params' device
    m: Any              # first moment (adamw + adafactor)
    v: Any              # second moment (adamw) | None
    v_row: Any          # factored second moment (adafactor) | None
    v_col: Any


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac; a 0-d fp32 tensor."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clip((s - cfg.warmup_steps)
                      / max(cfg.total_steps - cfg.warmup_steps, 1),
                      0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def init(cfg: OptConfig, params: Any) -> OptState:
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    if cfg.kind == "adamw":
        mdt = _DTYPES[cfg.moment_dtype]

        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)

        return OptState(step, tree_map(zeros, params),
                        tree_map(zeros, params), None, None)
    # adafactor: bf16 m; factored fp32 v for matrices, full fp32 for vectors
    m = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                       device=p.device), params)
    v_row = tree_map(
        lambda p: torch.zeros(p.shape[:-1] if _factored(p.shape) else (1,),
                              dtype=torch.float32, device=p.device), params)
    v_col = tree_map(
        lambda p: torch.zeros(p.shape[:-2] + p.shape[-1:]
                              if _factored(p.shape) else p.shape,
                              dtype=torch.float32, device=p.device), params)
    return OptState(step, m, None, v_row, v_col)


def _pieces(p: torch.Tensor, cut: bool):
    """Slices of ``p``'s first axis, each at most ``_PIECE`` values (one
    whole-leaf slice when ``cut`` is false or the leaf is small)."""
    if not cut or p.dim() == 0 or p.numel() <= _PIECE:
        return [slice(None)]
    rows = max(1, _PIECE // max(p.numel() // p.shape[0], 1))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def leaf_square_sum(g: torch.Tensor) -> torch.Tensor:
    """sum(g^2) of one leaf in fp32, piece by piece."""
    return sum(g[sl].float().square().sum() for sl in _pieces(g, True))


def _global_norm(grads) -> torch.Tensor:
    total = 0     # over the leaves in JAX's order, as JAX adds them
    for g in leaves(grads):
        total = total + leaf_square_sum(g)
    return torch.sqrt(total)


def _mean(i: int, x: torch.Tensor, dim: int, axis: int) -> torch.Tensor:
    return torch.mean(x, dim)


def update(cfg: OptConfig, grads: Any, state: OptState, params: Any,
           gnorm: torch.Tensor | None = None, mean=_mean
           ) -> tuple[Any, OptState, dict]:
    """One step: writes ``params`` and the state's moments in place and
    returns (params, the new state, {"lr", "grad_norm"}).  ``gnorm``, the
    whole gradient's global norm, where ``grads`` is one process's shard
    of it (the mesh trainer); else it is taken from ``grads``.  ``mean(i,
    x, dim, axis)``: the mean of ``x`` over its axis ``dim``, which runs
    along axis ``axis`` (-1: columns, -2: rows) of leaf ``i`` (in
    ``leaves`` order); the factored moments take their means through it,
    so the mesh trainer can sum them over the processes that hold the
    rest of the leaf."""
    step = state.step + 1
    lr = schedule(cfg, step)
    if gnorm is None:
        gnorm = _global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    tf = step.float()
    bc1 = 1 - torch.full_like(tf, cfg.b1) ** tf
    bc2 = 1 - torch.full_like(tf, cfg.b2) ** tf
    adamw = cfg.kind == "adamw"
    moments = (zip(leaves(state.m), leaves(state.v)) if adamw else
               zip(leaves(state.m), leaves(state.v_row),
                   leaves(state.v_col)))
    for i, (p, g_leaf, mom) in enumerate(zip(leaves(params), leaves(grads),
                                             moments)):
        decay = p.dim() >= 2   # decoupled weight decay on matrices only
        fact = _factored(p.shape)
        # a factored leaf's means run over its last two axes: cut it only
        # along a leading (layer) axis
        for sl in _pieces(p, adamw or not fact or p.dim() >= 3):
            g = g_leaf[sl].float() * scale
            m_ = mom[0][sl]
            m_.copy_(cfg.b1 * m_.float() + (1 - cfg.b1) * g)
            if adamw:
                v_ = mom[1][sl]
                v_.copy_(cfg.b2 * v_.float() + (1 - cfg.b2) * g * g)
                step_ = (m_.float() / bc1) / (torch.sqrt(v_.float() / bc2)
                                              + cfg.eps)
            else:
                vr, vc = mom[1], mom[2][sl]
                if fact:
                    vr = vr[sl]
                    vr.copy_(cfg.b2 * vr + (1 - cfg.b2)
                             * mean(i, g * g, -1, -1))
                    vc.copy_(cfg.b2 * vc + (1 - cfg.b2)
                             * mean(i, g * g, -2, -2))
                    r = vr / bc2            # (..., rows)
                    c = vc / bc2            # (..., cols)
                    r_mean = mean(i, r, -1, -2)[..., None, None]
                    denom = torch.sqrt(
                        r[..., :, None] * c[..., None, :]
                        / torch.clamp_min(r_mean, 1e-30)) + cfg.eps
                else:
                    vc.copy_(cfg.b2 * vc + (1 - cfg.b2) * g * g)
                    denom = torch.sqrt(vc / bc2) + cfg.eps
                step_ = (m_.float() / bc1) / denom
            if decay:
                step_ = step_ + cfg.weight_decay * p[sl].float()
            p[sl] = p[sl].float() - lr * step_
    if adamw:
        new_state = OptState(step, state.m, state.v, None, None)
    else:
        new_state = OptState(step, state.m, None, state.v_row, state.v_col)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}


# ------------------------- state sharding specs -----------------------------


def opt_specs(cfg: OptConfig, param_spec_tree: Any, params_like: Any
              ) -> OptState:
    """Spec tree for the optimizer state (the JAX package's): moments
    mirror the param spec; factored vectors drop the corresponding dim
    (``v_row`` the last, ``v_col`` the second to last)."""
    if cfg.kind == "adamw":
        return OptState((), param_spec_tree, param_spec_tree, None, None)

    def row_spec(spec, p):
        if _factored(p.shape):
            return tuple(spec)[:-1] if len(spec) else ()
        return ()

    def col_spec(spec, p):
        t = tuple(spec)
        if _factored(p.shape):
            return t[:-2] + t[-1:] if len(t) >= 2 else ()
        return spec

    return OptState((), param_spec_tree, None,
                    _map_specs(row_spec, param_spec_tree, params_like),
                    _map_specs(col_spec, param_spec_tree, params_like))


def _map_specs(fn, specs, params):
    """``fn(spec, param)`` over a spec tree (tuples are its leaves) and
    the params tree beside it."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, params[k]) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, s, p) for s, p in zip(specs, params)]
    return fn(specs, params)
