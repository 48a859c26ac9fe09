"""Weights between the JAX package and the port.

Both keep the layout ``{"enc": [{w, b}] x 4, "lstm": [{wx, wh, b}] x 2,
"head": {w, b}}`` with ``x @ w`` products and LSTM gates packed
[i, f, g, o], so conversion is a plain copy of every leaf.  The JAX
side is handled as numpy arrays (``np.asarray`` of each leaf), so this
module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree):
    """``fn`` over every leaf of a params tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def from_jax(params_np, device: str | torch.device = "cuda") -> dict:
    """The port's params dict from the JAX pytree given as numpy arrays:
    float32, contiguous, on ``device``."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device), params_np)


def to_numpy(params) -> dict:
    """The port's params as numpy float32 arrays in the JAX pytree's
    structure (``jax.tree_util.tree_map(jnp.asarray, ...)`` restores it)."""
    return tree_map(lambda t: t.detach().cpu().numpy().astype(np.float32),
                    params)
