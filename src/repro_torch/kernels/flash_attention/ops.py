"""Wrapper of the flash attention kernels (``csrc/flash_attention.cu``):
bf16 on the tensor cores (wgmma fed by TMA), fp32 on CUDA cores.

On CUDA tensors it launches the kernel of their dtype on the current
stream, or raises; on CPU tensors it runs the plain version
(:func:`attention_ref`).  It never pads: the kernels mask the ragged edge
of the sequence.

It is differentiable through a ``torch.autograd.Function``: the forward
is the kernel (or the plain version on the CPU) and keeps q, k and v;
the backward runs :func:`attention_ref` again under autograd and returns
its vector-Jacobian product, as the JAX package's custom VJP does (its
``_bwd``).  There is no backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
_MAX_GRID_Y = 65535               # fp32: a launch per 65535 of B * H;
                                  # bf16: its query tiles (of 128) on y


def _launcher(dtype: torch.dtype):
    fn = getattr(_build.library("flash_attention"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    ts = (q, k, v)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention inputs lie on different devices")
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _SYMBOLS:
        raise TypeError("flash_attention takes float32 or bfloat16 inputs "
                        f"of one dtype, got {[t.dtype for t in ts]}")
    if any(t.dim() != 4 for t in ts):
        raise ValueError("flash_attention takes q (B, H, Sq, D) and k, v "
                         "(B, Hkv, Sk, D), got "
                         f"{[tuple(t.shape) for t in ts]}")
    b, h, _, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, d) or v.shape != k.shape or hkv == 0 \
            or h % hkv:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def _forward(q, k, v, causal: bool, sm_scale: float | None):
    """The kernel of q's dtype (CUDA) or the plain version (CPU)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    if q.get_device() != torch.cuda.current_device():
        raise ValueError("flash_attention inputs must lie on the current "
                         "device")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    if q.dtype == torch.bfloat16 and -(-sq // 128) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention kernel: Sq = {sq} exceeds its "
                         f"grid")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    rc = _launcher(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
        h // hkv, sq, sk, d, scale, int(causal),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _build.count(flash_attention, 1 if q.dtype == torch.bfloat16
                 else -(-(b * h) // _MAX_GRID_Y))
    return out


class _Flash(torch.autograd.Function):
    """Forward: :func:`_forward`, keeping q, k and v.  Backward: the VJP
    of :func:`attention_ref` recomputed under autograd, the gradients in
    the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, sm_scale)

    @staticmethod
    def backward(ctx, g):
        xs = [t.detach().requires_grad_(w)
              for t, w in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            o = attention_ref(*xs, causal=ctx.causal, sm_scale=ctx.sm_scale)
            want = [t for t in xs if t.requires_grad]
            got = iter(torch.autograd.grad(o, want, g))
        return tuple(next(got) if t.requires_grad else None
                     for t in xs) + (None, None)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None):
    """GQA attention: q (B, H, Sq, D); k, v (B, Hkv, Sk, D), H % Hkv == 0;
    query head h reads KV head ``h // (H / Hkv)``.  Causal keeps
    ``qpos >= kpos``.  fp32 softmax, output in q's dtype.  Differentiable
    in q, k and v (the backward is the plain version's).
    ``flash_attention.launches`` counts kernel launches, forward ones
    only, a recompute under ``torch.utils.checkpoint`` included (CPU
    calls do not launch and do not count); ``flash_attention.recorded``
    those recorded into a CUDA graph being captured."""
    _check(q, k, v)
    return _Flash.apply(q, k, v, causal, sm_scale)


flash_attention.launches = 0
flash_attention.recorded = 0
