"""KV-cache utilities for the serving engine.

Caches are the model-defined pytrees (per layer group, stacked over
layers: k and v are (L, B, Hkv, S, hd); an MLA group's c_kv and k_rope
are (L, B, S, dc) and (L, B, S, dr); an SSM group's h and conv are
(L, B, Di, N) and (L, B, K-1, Di); a hybrid group's are nested per
period, {"attn": {"k", "v"}: (P, B, Hkv, S, hd), "mamba": {"h": (P,
period - 1, B, Di, N), "conv": (P, period - 1, B, K-1, Di)}}; an
encoder-decoder's list begins with {"enc": (B, F, d)}, the encoder's
states, which have no seq axis to pad).  This module allocates them at a
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
    dim is the one after the layer-stack dim, after the period and
    sublayer dims in a hybrid group's ``mamba`` states, and the first of
    the encoder's states ``enc``."""

    def f(spec, ax):
        shape = list(spec.shape)
        if batch is not None and len(shape) > ax:
            shape[ax] = batch
        return torch.zeros(shape, dtype=spec.dtype, device=spec.device)

    def walk(node, ax=1):
        if isinstance(node, dict):
            return {k: walk(v, 0 if k == "enc" else
                            2 if k == "mamba" and isinstance(v, dict) else ax)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, ax) for v in node]
        return f(node, ax)

    return walk(cache_specs)


def pad_to_length(caches, target_len: int):
    """Every attention cache's seq axis (``ndim - 2``) right-padded with
    zeros to ``target_len``, in nested dicts too (a hybrid period's
    ``attn``): one allocation of the full length per cache, with the
    prefill's keys and values copied in.  An SSM layer's recurrent state
    (``h``, ``conv``) and the encoder's states (``enc``) have no seq axis
    and pass as they are."""

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
