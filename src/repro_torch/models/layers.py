"""Shared transformer layers: RMSNorm, RoPE, SwiGLU, GQA attention and
MLA (multi-head latent attention), in the JAX package's functional form (``*_init`` builds
param dicts, ``*_apply`` consumes them) and with its casts: norms and
RoPE compute in fp32 and cast back to the activation dtype.

Attention has three entry points: full causal (``attn_apply``, the
training path, differentiable), prefill (causal, returns the KV cache)
and decode (one token against a cache, written in place); the
encoder-decoder's cross-attention (``cross_attn_apply``) attends to the
encoder's states, non-causal and without RoPE, in every mode.  The score and
P @ V products are the kernels' (``backend``); the projections and the
MLP are plain ``torch.matmul``.

MLA (deepseek-v3) has the same three entry points.  Its attention is the
plain functions ``attention_ref`` / ``decode_attention_ref`` on every
device, as in the JAX package, which calls them directly: q and k have
dn + dr = 192 dims and v 128 in training and prefill, and the absorbed
decode attends 128 query heads to one latent "KV head" of dc + dr = 576
dims, outside the kernels' head dims and group sizes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
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


def _qkv(p, cfg, x, kv_src=None):
    """q from ``x``; k and v from ``kv_src`` (cross-attention), else from
    ``x``."""
    b, s, _ = x.shape
    kv_src = x if kv_src is None else kv_src
    sk = kv_src.shape[1]
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (kv_src @ p["wk"]).reshape(b, sk, cfg.n_kv_heads, cfg.hd)
    v = (kv_src @ p["wv"]).reshape(b, sk, cfg.n_kv_heads, cfg.hd)
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


def cross_attn_apply(p: dict, cfg: ModelConfig, x, enc):
    """Decoder cross-attention of x (B, S, d) over the encoder states enc
    (B, Se, d): no RoPE, non-causal, through ``backend.attention`` (on
    the card the flash kernel at Sq = S, Sk = Se).  Every call projects
    K and V from all of ``enc`` again, as the JAX package does: a decode
    step keeps no cross-attention cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, kv_src=enc)
    o = backend.attention(_heads_first(q), _heads_first(k), _heads_first(v),
                          causal=False)
    return o.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def attn_prefill(p: dict, cfg: ModelConfig, x, cos, sin, *,
                 causal: bool = True):
    """Causal attention returning the (B, Hkv, S, hd) KV cache."""
    out, kc, vc = _attend(p, cfg, x, cos, sin, causal)
    return out, {"k": kc, "v": vc}


def write_at(cache, dim: int, pos, x) -> None:
    """``cache``'s slice ``pos`` along ``dim`` set to ``x`` (its shape less
    that dim), in place.  ``pos`` is a host int or a 0-d integer tensor
    (JAX's traced scalar), written through ``index_copy_`` with a one-
    element index on the device: no value comes to the host, so a CUDA
    graph of the decode step replays it at any position."""
    if isinstance(pos, torch.Tensor):
        cache.index_copy_(dim, pos.reshape(1),
                          x.unsqueeze(dim).to(cache.dtype))
    else:
        cache.select(dim, pos).copy_(x)


def attn_decode(p: dict, cfg: ModelConfig, x, cache: dict, pos,
                cos_t, sin_t):
    """One-token decode. x: (B, 1, d); cache k/v: (B, Hkv, S, hd), written
    in place at ``pos`` (a host int or a 0-d integer tensor, JAX's scalar;
    the JAX package returns an updated copy, the values are the same);
    cos_t/sin_t: (1, hd/2) at pos.  The decode kernel takes ``kv_len =
    pos + 1`` in the same form: a tensor it reads on the device."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, cos_t, sin_t)[:, 0]          # (B, H, hd)
    k = apply_rope(k, cos_t, sin_t)[:, 0]          # (B, Hkv, hd)
    write_at(cache["k"], 2, pos, k)
    write_at(cache["v"], 2, pos, v[:, 0])
    o = backend.decode_attention(q.contiguous(), cache["k"], cache["v"],
                                 kv_len=pos + 1)
    out = o.reshape(b, 1, -1) @ p["wo"]
    return out, cache


# ------------------------ MLA (multi-head latent) ---------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dq, dc = cfg.q_lora_rank, cfg.kv_lora_rank
    dev = gen.device
    return {
        "wq_a": dense_init(gen, d, dq, cfg.dtype),
        "q_norm": norm_init(dq, dev),
        "wq_b": dense_init(gen, dq, h * (dn + dr), cfg.dtype),
        "wkv_a": dense_init(gen, d, dc + dr, cfg.dtype),
        "kv_norm": norm_init(dc, dev),
        "wkv_b": dense_init(gen, dc, h * (dn + dv), cfg.dtype),
        "wo": dense_init(gen, h * dv, d, cfg.dtype),
    }


def _mla_q(p, cfg, x, cos, sin):
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = rms_norm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps) @ p["wq_b"]
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope


def _mla_latent(p, cfg, x, cos, sin):
    """The compressed cache of ``x``: c_kv (B, S, dc) normed, k_rope
    (B, S, 1, dr) rotated."""
    dc = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    c_kv = rms_norm(p["kv_norm"], kv[..., :dc], cfg.norm_eps)
    return c_kv, apply_rope(kv[..., None, dc:], cos, sin)


def mla_apply(p: dict, cfg: ModelConfig, x, cos, sin):
    """Training path: expand K/V from the latent and run causal MHA
    through ``attention_ref`` (the plain function, as JAX: no kernel
    covers 192-dim q/k with 128-dim v)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope = _mla_q(p, cfg, x, cos, sin)
    c_kv, k_rope = _mla_latent(p, cfg, x, cos, sin)      # k_rope (B,S,1,dr)
    kvup = (c_kv @ p["wkv_b"]).reshape(b, s, h, -1)
    k_nope, v = kvup[..., :dn], kvup[..., dn:]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], -1)
    sm = (dn + dr) ** -0.5
    o = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True, sm_scale=sm)
    return o.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def mla_prefill(p: dict, cfg: ModelConfig, x, cos, sin):
    """Prefill storing only the compressed latent cache (MLA's memory
    win): cache = {c_kv: (B, S, dc), k_rope: (B, S, dr)}."""
    out = mla_apply(p, cfg, x, cos, sin)
    c_kv, k_rope = _mla_latent(p, cfg, x, cos, sin)
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0]}


def mla_decode(p: dict, cfg: ModelConfig, x, cache: dict, pos,
               cos_t, sin_t):
    """Absorbed-matrix decode entirely in latent space (DeepSeek-V2 §MLA):
    scores_h,s = <W_UK_h^T q_nope_h, c_s> + <q_rope_h, k_rope_s>;
    out_h = W_UV_h (sum_s p_s c_s).  The cache {c_kv: (B, S, dc),
    k_rope: (B, S, dr)} is written in place at ``pos`` (a host int or a
    0-d integer tensor) along axis 1.  The absorbed products run in fp32
    as JAX's einsums do, the attention through ``decode_attention_ref``
    (the plain function, as JAX: one latent "KV head" of dc + dr dims for
    all H query heads is no shape of the decode kernel; its mask takes a
    tensor ``kv_len``), and the output is cast to x's dtype."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dc = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, cfg, x, cos_t, sin_t)       # (B,1,H,*)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]            # (B,H,dn/dr)
    kv = (x @ p["wkv_a"])[:, 0]
    c_t = rms_norm(p["kv_norm"], kv[..., :dc], cfg.norm_eps)
    kr_t = apply_rope(kv[:, None, None, dc:], cos_t, sin_t)[:, 0, 0]
    write_at(cache["c_kv"], 1, pos, c_t)
    write_at(cache["k_rope"], 1, pos, kr_t)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    # absorb W_UK into q:  q_lat (B, H, dc)
    wkv_b = p["wkv_b"].reshape(dc, h, dn + dv)
    w_uk = wkv_b[..., :dn]                                  # (dc, H, dn)
    w_uv = wkv_b[..., dn:]                                  # (dc, H, dv)
    q_lat = torch.einsum("bhn,chn->bhc", q_nope.float(), w_uk.float())
    qq = torch.cat([q_lat, q_rope.float()], -1)
    kk = torch.cat([c_kv, k_rope], -1)[:, None]             # (B,1,S,dc+dr)
    sm = (dn + dr) ** -0.5
    o_lat = decode_attention_ref(qq, kk, c_kv[:, None], sm_scale=sm,
                                 kv_len=pos + 1)            # (B,H,dc)
    out = torch.einsum("bhc,chv->bhv", o_lat.float(), w_uv.float())
    out = out.reshape(b, 1, h * dv).to(x.dtype) @ p["wo"]
    return out, cache
