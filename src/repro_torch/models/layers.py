"""Shared transformer layers, the dense subset: RMSNorm, RoPE, SwiGLU and
GQA attention, in the JAX package's functional form (``*_init`` builds
param dicts, ``*_apply`` consumes them) and with its casts: norms and
RoPE compute in fp32 and cast back to the activation dtype.

Attention has three entry points: full causal (``attn_apply``, the
training path, differentiable), prefill (causal, returns the KV cache)
and decode (one token against a cache, written in place).  The score and
P @ V products are the kernels' (``backend``); the projections and the
MLP are plain ``torch.matmul``.
"""
from __future__ import annotations

import torch

from repro_torch.models import backend
from repro_torch.models.config import ModelConfig


def norm_init(d: int, device=None) -> dict:
    return {"w": torch.ones(d, dtype=torch.float32, device=device)}


def rms_norm(p: dict, x, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["w"]).to(x.dtype)


def dense_init(gen: torch.Generator, n_in: int, n_out: int, dtype):
    """(n_in, n_out) standard normal scaled by n_in^-0.5, drawn in fp32 on
    ``gen``'s device and cast to ``dtype``."""
    w = torch.randn(n_in, n_out, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * n_in ** -0.5).to(dtype)


# --------------------------------- RoPE ------------------------------------


def rope_table(seq: int, dim: int, theta: float = 1e4, device=None):
    """(seq, dim/2) cos/sin tables."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D) rotated pairwise; cos/sin: (S, D/2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cs = cos[None, :, None, :]
    sn = sin[None, :, None, :]
    return torch.cat([x1 * cs - x2 * sn, x2 * cs + x1 * sn],
                     dim=-1).to(x.dtype)


# -------------------------------- SwiGLU -----------------------------------


def mlp_init(gen: torch.Generator, d: int, ff: int, dtype) -> dict:
    return {"wg": dense_init(gen, d, ff, dtype),
            "wu": dense_init(gen, d, ff, dtype),
            "wd": dense_init(gen, ff, d, dtype)}


def silu(x):
    """``jax.nn.silu``'s formula op for op, x * (1 / (1 + exp(-x))), so a
    bf16 input rounds after each op as it does in JAX
    (``torch.nn.functional.silu`` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_apply(p: dict, x):
    h = silu(x @ p["wg"]) * (x @ p["wu"])
    return h @ p["wd"]


# ----------------------------- GQA attention -------------------------------


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, cfg.dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, cfg.dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, cfg.dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, d, cfg.dtype),
    }


def _qkv(p, cfg, x):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def _heads_first(x):
    """(B, S, H, D) -> contiguous (B, H, S, D), the kernels' layout."""
    return x.transpose(1, 2).contiguous()


def _attend(p, cfg: ModelConfig, x, cos, sin, causal: bool):
    """Full-sequence GQA attention: (out (B, S, d), k and v (B, Hkv, S,
    hd))."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kc, vc = _heads_first(k), _heads_first(v)
    o = backend.attention(_heads_first(q), kc, vc, causal=causal)
    return o.transpose(1, 2).reshape(b, s, -1) @ p["wo"], kc, vc


def attn_apply(p: dict, cfg: ModelConfig, x, cos, sin, *,
               causal: bool = True):
    """Full-sequence attention, the training path: differentiable
    (``flash_attention``'s autograd Function), no cache returned."""
    return _attend(p, cfg, x, cos, sin, causal)[0]


def attn_prefill(p: dict, cfg: ModelConfig, x, cos, sin, *,
                 causal: bool = True):
    """Causal attention returning the (B, Hkv, S, hd) KV cache."""
    out, kc, vc = _attend(p, cfg, x, cos, sin, causal)
    return out, {"k": kc, "v": vc}


def attn_decode(p: dict, cfg: ModelConfig, x, cache: dict, pos: int,
                cos_t, sin_t):
    """One-token decode. x: (B, 1, d); cache k/v: (B, Hkv, S, hd), written
    in place at ``pos`` (a host int; the JAX package returns an updated
    copy, the values are the same); cos_t/sin_t: (1, hd/2) at pos."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, cos_t, sin_t)[:, 0]          # (B, H, hd)
    k = apply_rope(k, cos_t, sin_t)[:, 0]          # (B, Hkv, hd)
    cache["k"][:, :, pos] = k
    cache["v"][:, :, pos] = v[:, 0]
    o = backend.decode_attention(q.contiguous(), cache["k"], cache["v"],
                                 kv_len=pos + 1)
    out = o.reshape(b, 1, -1) @ p["wo"]
    return out, cache
