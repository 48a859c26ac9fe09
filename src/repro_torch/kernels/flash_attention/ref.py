"""Plain PyTorch version of flash attention (GQA + causal + padded-key
masking), op for op with the JAX package's ``attention_ref``.

GQA is a grouped einsum on the (B, Hkv, G, ...) view of q: K/V are never
repeated to H heads.  ``chunk_q``: queries are processed in blocks so
live score memory is O(chunk x S) instead of O(S^2); the math is the
same (each row still sees its full softmax).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _attn_block(q, k, v, q_off: int, sm_scale: float, causal: bool,
                kv_len: int):
    """q: (B, Hkv, G, Sq, D); k, v: (B, Hkv, Sk, D).  q_off: offset of
    this query block for causal masking."""
    sq, sk = q.shape[3], k.shape[2]
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) * sm_scale
    kpos = torch.arange(sk, device=q.device)
    mask = (kpos < kv_len)[None, :]
    if causal:
        qpos = q_off + torch.arange(sq, device=q.device)
        mask = mask & (qpos[:, None] >= kpos[None, :])
    s = torch.where(mask, s, NEG_INF)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())


def attention_ref(q, k, v, *, causal: bool = True,
                  sm_scale: float | None = None, kv_len: int | None = None,
                  chunk_q: int | None = 2048):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D).  fp32 softmax, output in
    q's dtype."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = h // hkv
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    kv_len = kv_len if kv_len is not None else sk
    qg = q.reshape(b, hkv, g, sq, d)
    if chunk_q is None or sq <= chunk_q or sq % chunk_q != 0:
        out = _attn_block(qg, k, v, 0, sm_scale, causal, kv_len)
    else:
        out = torch.cat([
            _attn_block(qg[:, :, :, i:i + chunk_q], k, v, i, sm_scale,
                        causal, kv_len)
            for i in range(0, sq, chunk_q)], dim=3)
    return out.reshape(b, h, sq, -1).to(q.dtype)
