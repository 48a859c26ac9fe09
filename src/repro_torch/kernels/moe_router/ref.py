"""Plain PyTorch version of the top-k softmax router, the JAX package's
``moe_router_ref``: an fp32 softmax (``jax.nn.softmax``'s formula), the
k largest probabilities, renormalised by their sum.

``lax.top_k`` (and the Pallas kernel's argmax passes) take the lower
index of two equal values; ``torch.topk`` promises no order on ties, so
the top k come from a stable descending sort instead."""
from __future__ import annotations

import torch


def moe_router_ref(logits, k: int):
    """logits (T, E), any float dtype -> (weights (T, k) fp32, indices
    (T, k) int32), in descending weight order, the lower index first on
    ties."""
    x = logits.float()
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    w, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-20)
    return w, idx.to(torch.int32)
