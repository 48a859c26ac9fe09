"""Kernel dispatch of the LM stack.

The device decides: a CUDA tensor goes to the hand-written kernel (which
launches or raises), a CPU tensor to its plain version.  There is no
switch to select one or the other.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import (decode_attention as
                                                  _decode_kernel)
from repro_torch.kernels.flash_attention import (flash_attention as
                                                 _flash_kernel)
from repro_torch.kernels.mamba_scan import mamba_scan as _scan_kernel
from repro_torch.kernels.mamba_scan import (mamba_scan_with_state as
                                            _scan_state_kernel)
from repro_torch.kernels.moe_router import moe_router as _router_kernel


def attention(q, k, v, *, causal: bool = True):
    """q (B, H, Sq, D); k, v (B, Hkv, Sk, D) -> (B, H, Sq, D),
    differentiable (the backward is the plain version's)."""
    return _flash_kernel(q, k, v, causal)


def decode_attention(q, k, v, *, kv_len: int):
    """q (B, H, D); k, v (B, Hkv, S, D); the first ``kv_len`` keys."""
    return _decode_kernel(q, k, v, kv_len=kv_len)


def mamba_scan(u, delta, a, b, c, skip):
    """u, delta (B, L, D); a (D, N) fp32; b, c (B, L, N); skip (D,) fp32
    -> y (B, L, D), differentiable (on the card the backward is a
    kernel too)."""
    return _scan_kernel(u, delta, a, b, c, skip)


def mamba_scan_with_state(u, delta, a, b, c, skip):
    """As :func:`mamba_scan`, inference only -> (y (B, L, D), the state
    after the last step (B, D, N) fp32)."""
    return _scan_state_kernel(u, delta, a, b, c, skip)


def moe_router(logits, k: int):
    """logits (T, E) -> (weights (T, k) fp32, indices (T, k) int32),
    differentiable in the weights (the indices take no gradient)."""
    return _router_kernel(logits, k)
