"""Plain PyTorch version of single-token decode attention, op for op with
the JAX package's ``decode_attention_ref`` (grouped-GQA einsum, no
repeat of K/V)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, *, sm_scale: float | None = None,
                         kv_len: int | None = None):
    """q: (B, H, Dq); k: (B, Hkv, S, Dq); v: (B, Hkv, S, Dv) -> (B, H, Dv).
    Keys at positions >= ``kv_len`` are masked out."""
    b, h, dq = q.shape
    _, hkv, sk, _ = k.shape
    g = h // hkv
    sm_scale = sm_scale if sm_scale is not None else dq ** -0.5
    kv_len = kv_len if kv_len is not None else sk
    qg = q.reshape(b, hkv, g, dq)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k.float()) * sm_scale
    mask = torch.arange(sk, device=q.device)[None, None, None, :] < kv_len
    s = torch.where(mask, s, NEG_INF)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return out.reshape(b, h, -1).to(q.dtype)
