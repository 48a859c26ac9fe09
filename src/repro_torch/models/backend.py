"""Kernel dispatch of the LM stack.

The device decides: a CUDA tensor goes to the hand-written kernel (which
launches or raises), a CPU tensor to its plain version.  There is no
switch to select one or the other.  Kernels the port does not have yet
raise ``NotImplementedError``; they never run a plain version instead.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import (decode_attention as
                                                  _decode_kernel)
from repro_torch.kernels.flash_attention import (flash_attention as
                                                 _flash_kernel)


def attention(q, k, v, *, causal: bool = True):
    """q (B, H, Sq, D); k, v (B, Hkv, Sk, D) -> (B, H, Sq, D)."""
    return _flash_kernel(q, k, v, causal)


def decode_attention(q, k, v, *, kv_len: int):
    """q (B, H, D); k, v (B, Hkv, S, D); the first ``kv_len`` keys."""
    return _decode_kernel(q, k, v, kv_len=kv_len)


def mamba_scan(u, delta, a, b, c, skip):
    raise NotImplementedError(
        "mamba_scan is not ported yet: ROADMAP.md Queue 1 item 2 (SSM "
        "serving)")


def moe_router(logits, k: int):
    raise NotImplementedError(
        "moe_router is not ported yet: ROADMAP.md Queue 1 item 1 (MoE "
        "serving)")
