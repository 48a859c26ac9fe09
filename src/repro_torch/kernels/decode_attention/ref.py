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


# bf16 outputs: the kernel rounds its fp32 result once, so each element
# lies within half a bf16 ulp of the fp32 plain version on the same
# inputs, plus this share of the largest |output| for fp32 sums taken in
# another order.  A P rounded to one bf16 before P.V lands ~1e-3 of the
# largest |output| past half an ulp at every kv_len >= 28.
BF16_EXCESS = 2.0 ** -16


def bf16_rounding_excess(got, want32) -> float:
    """max(|got - want32| - half a bf16 ulp of |want32|) / max|want32|:
    how far a bf16 output lies past the rounding of the fp32 result
    ``want32``; at most :data:`BF16_EXCESS` for a kernel that keeps P in
    fp32 (or as exact bf16 terms)."""
    want32 = want32.float()
    mag = want32.abs()
    _, e = torch.frexp(mag)          # mag in [2^(e-1), 2^e): ulp 2^(e-8)
    half_ulp = torch.where(mag == 0, torch.zeros_like(mag),
                           torch.ldexp(torch.ones_like(mag), e - 9))
    excess = ((got.float() - want32).abs() - half_ulp).max().item()
    return excess / max(mag.max().item(), 1e-30)


def decode_attention_split_ref(q, k, v, *, kv_len, n_splits: int,
                               split_keys: int,
                               sm_scale: float | None = None):
    """The kernel's split and merge, in plain PyTorch: split s takes the
    keys [s * split_keys, min(S, (s + 1) * split_keys)), masks those at or
    past ``kv_len`` (a host int or a 0-d tensor) and keeps (m, l, acc) =
    (max valid score, sum exp(s - m), sum exp(s - m) v) over the rest; a
    masked key weighs exactly 0, so its finite value adds nothing.  The
    splits merge in split order, each weighed by exp(m_s - max m).  A split
    with no valid key has m = -1e30, l = 0, acc = 0 and weighs 0.  The
    wrapper's split is ``ops.decode_split``'s, over ``kv_len`` keys for a
    host int and over all S for a tensor, whose splits past it hold no
    valid key."""
    b, h, dq = q.shape
    _, hkv, sk, _ = k.shape
    g = h // hkv
    dev = q.device
    sm_scale = sm_scale if sm_scale is not None else dq ** -0.5
    qg = q.reshape(b, hkv, g, dq).float()
    parts = []
    for s in range(n_splits):
        lo, hi = s * split_keys, min(sk, (s + 1) * split_keys)
        if hi <= lo:
            parts.append((torch.full((b, hkv, g), NEG_INF, device=dev),
                          torch.zeros(b, hkv, g, device=dev),
                          torch.zeros(b, hkv, g, v.shape[-1], device=dev)))
            continue
        valid = torch.arange(lo, hi, device=dev) < kv_len
        sc = torch.einsum("bhgd,bhkd->bhgk", qg,
                          k[:, :, lo:hi].float()) * sm_scale
        sc = torch.where(valid, sc, NEG_INF)
        m = sc.amax(-1)
        p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bhgk,bhkd->bhgd", p,
                                   v[:, :, lo:hi].float())))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    den = torch.zeros_like(mx)
    out = torch.zeros(b, hkv, g, v.shape[-1], device=dev)
    for m, l_s, acc in parts:
        f = torch.exp(m - mx)
        den = den + l_s * f
        out = out + acc * f[..., None]
    out = out / torch.clamp_min(den, 1e-30)[..., None]
    return out.reshape(b, h, -1).to(q.dtype)
