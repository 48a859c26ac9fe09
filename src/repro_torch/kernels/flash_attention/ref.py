"""Plain PyTorch version of flash attention (GQA + causal + padded-key
masking), op for op with the JAX package's ``attention_ref``; the same
with the rows' log-sum-exp (:func:`attention_lse_ref`), and the plain
version of the backward kernel (:func:`flash_attention_bwd_ref`).

GQA is a grouped einsum on the (B, Hkv, G, ...) view of q: K/V are never
repeated to H heads.  ``chunk_q``: queries are processed in blocks so
live score memory is O(chunk x S) instead of O(S^2); the math is the
same (each row still sees its full softmax).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq: int, sk: int, q_off: int, causal: bool, kv_len: int,
          device):
    """(Sq, Sk) bool: keys before kv_len and, causal, at or before the
    query's position q_off + i."""
    kpos = torch.arange(sk, device=device)
    mask = (kpos < kv_len)[None, :]
    if causal:
        qpos = q_off + torch.arange(sq, device=device)
        mask = mask & (qpos[:, None] >= kpos[None, :])
    return mask


def _attn_block(q, k, v, q_off: int, sm_scale: float, causal: bool,
                kv_len: int, with_lse: bool = False):
    """q: (B, Hkv, G, Sq, D); k, v: (B, Hkv, Sk, D).  q_off: offset of
    this query block for causal masking.  With ``with_lse``, (out, the
    rows' log-sum-exp of the scaled scores (B, Hkv, G, Sq))."""
    sq, sk = q.shape[3], k.shape[2]
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) * sm_scale
    s = torch.where(_mask(sq, sk, q_off, causal, kv_len, q.device), s,
                    NEG_INF)
    m = s.amax(-1, keepdim=True)
    s = s - m
    p = torch.exp(s)
    l = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    p = p / l
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    if not with_lse:
        return out
    return out, (m + torch.log(l)).squeeze(-1)


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


def attention_lse_ref(q, k, v, *, causal: bool = True,
                      sm_scale: float | None = None,
                      chunk_q: int | None = 2048):
    """:func:`attention_ref` (the same ops, so the same bits) and the
    rows' log-sum-exp of the scaled, masked scores, fp32 (B, H, Sq),
    natural log: what the forward kernels hand their backward."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = h // hkv
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d)
    if chunk_q is None or sq <= chunk_q or sq % chunk_q != 0:
        starts, size = [0], sq
    else:
        starts, size = range(0, sq, chunk_q), chunk_q
    parts = [_attn_block(qg[:, :, :, i:i + size], k, v, i, sm_scale, causal,
                         sk, with_lse=True) for i in starts]
    out = parts[0][0] if len(parts) == 1 else torch.cat(
        [o for o, _ in parts], dim=3)
    lse = torch.cat([m for _, m in parts], dim=3)
    return (out.reshape(b, h, sq, -1).to(q.dtype),
            lse.reshape(b, h, sq))


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            sm_scale: float | None = None,
                            chunk_q: int = 1024):
    """dq, dk, dv (the inputs' dtypes) of :func:`attention_ref` for the
    output gradient ``do``, from the forward's o and lse (fp32, (B, H,
    Sq)), as the backward kernel computes them, fp32 inside:

        P = exp(sm_scale S - lse)   dV = P^T dO   dP = dO V^T
        dS = P (dP - delta), delta = rowsum(dO o)
        dQ = sm_scale dS K          dK = sm_scale dS^T Q

    Queries go ``chunk_q`` at a time, so the live score memory is
    O(chunk_q x Sk)."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = h // hkv
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    kf, vf = k.float(), v.float()
    qg = q.float().reshape(b, hkv, g, sq, d)
    dog = do.float().reshape(b, hkv, g, sq, d)
    delta = (dog * o.float().reshape(b, hkv, g, sq, d)).sum(-1)
    lse = lse.float().reshape(b, hkv, g, sq)
    dq = torch.empty_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i in range(0, sq, chunk_q):
        j = min(sq, i + chunk_q)
        qc, dc = qg[:, :, :, i:j], dog[:, :, :, i:j]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf) * sm_scale
        p = torch.where(_mask(j - i, sk, i, causal, sk, q.device),
                        torch.exp(s - lse[:, :, :, i:j, None]), 0.0)
        dv += torch.einsum("bhgqk,bhgqd->bhkd", p, dc)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dc, vf)
        ds = p * (dp - delta[:, :, :, i:j, None])
        dq[:, :, :, i:j] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) \
            * sm_scale
        dk += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc) * sm_scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
