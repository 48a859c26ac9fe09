"""Mamba-1 block (falcon-mamba): the full-sequence (training) path, and
the serving pair, a prefill that also returns the recurrent state and a
one-token decode step against it.

in_proj -> (x, z); causal depthwise conv1d + silu on x; data-dependent
(delta, B, C) from x_proj; the selective scan (``backend.mamba_scan``:
the CUDA kernel on the card, its plain version on the CPU); gate by
silu(z); out_proj.  The JAX package's roundings are kept op for op, so
bf16 rounds where JAX run op by op rounds: the conv is a sum of K
products in the activation dtype (not ``conv1d``, whose summation and,
in fp32, TF32 would round elsewhere), silu is ``layers.silu``, softplus
is ``logaddexp(x, 0)`` on fp32, and delta goes back to the activation
dtype before the scan.

The prefill's scan is ``backend.mamba_scan_with_state`` (the same kernel,
also storing the final (B, D, N) state); the decode step is plain ops,
as in JAX, where no kernel runs it either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.encoder_lstm import softplus
from repro_torch.models import backend
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, silu


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's params on ``gen``'s device, with the JAX package's
    shapes, scales and dtypes (A = -exp(a_log), a_log = log(1..N) per
    channel; dt_bias, a_log and skip in fp32)."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dev = gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev)).expand(di, n).contiguous()
    conv_w = torch.randn(cfg.ssm_conv, di, generator=gen, device=dev,
                         dtype=torch.float32)
    return {
        "in_proj": dense_init(gen, d, 2 * di, cfg.dtype),
        "conv_w": (conv_w * cfg.ssm_conv ** -0.5).to(cfg.dtype),
        "conv_b": torch.zeros(di, dtype=cfg.dtype, device=dev),
        "x_proj": dense_init(gen, di, cfg.dt_rank + 2 * n, cfg.dtype),
        "dt_proj": dense_init(gen, cfg.dt_rank, di, cfg.dtype),
        "dt_bias": torch.zeros(di, dtype=torch.float32, device=dev),
        "a_log": a_log,
        "skip": torch.ones(di, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, cfg.dtype),
    }


def _conv1d_causal(x, w, b):
    """Depthwise causal conv. x: (B, L, Di); w: (K, Di).  The K products
    are added in order i = 0..K-1 in x's dtype, then the bias, as JAX's
    Python ``sum``."""
    k, ell = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + ell, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _ssm_inputs(p, cfg: ModelConfig, xc):
    """xc: (B, L, Di) post-conv activations -> (delta, B, C); delta in
    xc's dtype, B and C contiguous (B, L, N) for the kernel."""
    n, dtr = cfg.ssm_state, cfg.dt_rank
    proj = xc @ p["x_proj"]                        # (B, L, dtr + 2N)
    dt = proj[..., :dtr] @ p["dt_proj"]            # (B, L, Di)
    delta = softplus(dt.float() + p["dt_bias"])
    bmat = proj[..., dtr:dtr + n].contiguous()
    cmat = proj[..., dtr + n:].contiguous()
    return delta.to(xc.dtype), bmat, cmat


def mamba_apply(p: dict, cfg: ModelConfig, x):
    """Full-sequence path. x: (B, L, d) -> (B, L, d)."""
    di = cfg.d_inner
    xz = x @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    xc = silu(_conv1d_causal(xin, p["conv_w"], p["conv_b"]))
    delta, bmat, cmat = _ssm_inputs(p, cfg, xc)
    a = -torch.exp(p["a_log"])
    y = backend.mamba_scan(xc, delta, a, bmat, cmat, p["skip"])
    return (y * silu(z)) @ p["out_proj"]


def mamba_prefill(p: dict, cfg: ModelConfig, x):
    """Full-sequence pass that also returns the recurrent decode state.
    x: (B, L, d) -> (out (B, L, d), {"h": (B, Di, N) fp32, "conv":
    (B, K-1, Di) the last K-1 conv inputs, left-padded with zeros when
    L < K-1})."""
    di, k = cfg.d_inner, cfg.ssm_conv
    ell = x.shape[1]
    xz = x @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    xc = silu(_conv1d_causal(xin, p["conv_w"], p["conv_b"]))
    delta, bmat, cmat = _ssm_inputs(p, cfg, xc)
    a = -torch.exp(p["a_log"])
    y, hf = backend.mamba_scan_with_state(xc, delta, a, bmat, cmat,
                                          p["skip"])
    out = (y * silu(z)) @ p["out_proj"]
    conv_state = (xin[:, ell - (k - 1):, :] if ell >= k - 1
                  else F.pad(xin, (0, 0, k - 1 - ell, 0)))
    return out, {"h": hf, "conv": conv_state.contiguous()}


def mamba_decode(p: dict, cfg: ModelConfig, x, state: dict):
    """Single-token recurrent step. x: (B, 1, d); state {"h": (B, Di, N)
    fp32, "conv": (B, K-1, Di)}, written in place (the JAX package
    returns the new state; the values are the same).  Returns (out
    (B, 1, d), state)."""
    di = cfg.d_inner
    xz = x @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]                    # (B, 1, Di)
    window = torch.cat([state["conv"], xin], dim=1)        # (B, K, Di)
    xc = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = silu(xc)[:, None, :]                              # (B, 1, Di)
    delta, bmat, cmat = _ssm_inputs(p, cfg, xc)
    a = -torch.exp(p["a_log"])
    dt = delta[:, 0].float()                               # (B, Di)
    decay = torch.exp(dt[..., None] * a[None])
    h = decay * state["h"] + (dt * xc[:, 0])[..., None] \
        * bmat[:, 0].float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].float()) \
        + p["skip"] * xc[:, 0]
    out = (y[:, None].to(x.dtype) * silu(z)) @ p["out_proj"]
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return out, state
