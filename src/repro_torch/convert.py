"""Weights between the JAX package and the port.

Both packages keep the same pytrees: the predictor's ``{"enc": [{w, b}]
x 4, "lstm": [{wx, wh, b}] x 2, "head": {w, b}}`` with ``x @ w`` products
and LSTM gates packed [i, f, g, o], and the LM's dict of layer-stacked
leaves (``models/lm.py``; an MoE layer's fp32 router beside its expert
stacks in the config's dtype).  So conversion is a plain copy of every
leaf.
The JAX side is handled as numpy arrays (``np.asarray`` of each leaf), so
this module needs no JAX: a JAX bfloat16 leaf arrives as a numpy array of
the ``bfloat16`` extension dtype, and its bits are carried over as they
are.
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


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # the bits, reinterpreted: exact
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def from_jax(params_np, device: str | torch.device = "cuda") -> dict:
    """The port's params dict from the JAX pytree given as numpy arrays,
    contiguous, on ``device``: bfloat16 leaves stay bfloat16 (bit for
    bit), every other leaf becomes float32."""
    return tree_map(lambda a: _leaf(a, device), params_np)


def to_numpy(params) -> dict:
    """The port's params as numpy float32 arrays in the JAX pytree's
    structure (bfloat16 widens to float32 exactly;
    ``jax.tree_util.tree_map(jnp.asarray, ...)`` restores the tree)."""
    return tree_map(lambda t: t.detach().float().cpu().numpy().astype(
        np.float32), params)
