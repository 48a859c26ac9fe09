"""KV-cache utilities for the serving engine.

Caches are the model-defined pytrees (per layer group, stacked over
layers: k and v are (L, B, Hkv, S, hd); an MLA group's c_kv and k_rope
are (L, B, S, dc) and (L, B, S, dr); an SSM group's h and conv are
(L, B, Di, N) and (L, B, K-1, Di)).  This module allocates them at a
fixed max length, which decode then writes in place at each position,
and keeps the slot bookkeeping for continuous batching: each batch row is
a slot that can be re-assigned to a new request when its sequence
finishes.
"""
from __future__ import annotations

import torch

_SEQ_KEYS = ("k", "v", "c_kv", "k_rope")


def alloc_like(cache_specs, batch: int | None = None):
    """Zero caches shaped like ``cache_specs`` (tensors, or anything with
    ``shape``, ``dtype`` and ``device``), optionally re-batched: the batch
    dim is the one after the layer-stack dim."""

    def f(spec):
        shape = tuple(spec.shape)
        if batch is not None and len(shape) > 1:
            shape = (shape[0], batch) + shape[2:]
        return torch.zeros(shape, dtype=spec.dtype, device=spec.device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return f(node)

    return walk(cache_specs)


def pad_to_length(caches, target_len: int):
    """Every attention cache's seq axis right-padded with zeros to
    ``target_len``: one allocation of the full length per cache, with the
    prefill's keys and values copied in.  An SSM layer's recurrent state
    (``h``, ``conv``) has no seq axis and passes as it is."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k in _SEQ_KEYS and isinstance(v, torch.Tensor):
                ax = v.dim() - 2
                if target_len > v.shape[ax]:
                    shape = list(v.shape)
                    shape[ax] = target_len
                    full = torch.zeros(shape, dtype=v.dtype, device=v.device)
                    full.narrow(ax, 0, v.shape[ax]).copy_(v)
                    v = full
                out[k] = v
            else:
                out[k] = walk(v)
        return out

    return [walk(c) for c in caches]


class SlotManager:
    """Continuous-batching slot table: request id per batch row."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.slots: list[int | None] = [None] * n_slots

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def assign(self, req_id: int) -> int:
        i = self.free_slots()[0]
        self.slots[i] = req_id
        return i

    def release(self, slot: int) -> None:
        self.slots[slot] = None

    def active(self) -> dict[int, int]:
        return {i: r for i, r in enumerate(self.slots) if r is not None}
