"""Wrapper of the flash attention kernels (``csrc/flash_attention.cu``):
bf16 on the tensor cores (wgmma fed by TMA), fp32 on CUDA cores.

On CUDA tensors it launches the kernel of their dtype on the current
stream, or raises; on CPU tensors it runs the plain version
(:func:`attention_ref`).  It never pads: the kernels mask the ragged edge
of the sequence.

It is differentiable through a ``torch.autograd.Function``.  On CUDA
tensors the forward kernel also writes its rows' log-sum-exp when a
backward will follow, and the backward is the backward kernel
(:func:`flash_attention_bwd`: dq, dk and dv from q, k, v, o, lse and
do).  The JAX package has no backward kernel: its custom VJP (``_bwd``)
differentiates ``attention_ref``, and on CPU tensors the Function's
backward does the same (autograd through :func:`attention_ref`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, flash_attention_bwd_ref)

_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_SYMBOLS = {torch.float32: "flash_attention_bwd_f32",
                torch.bfloat16: "flash_attention_bwd_bf16"}
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
_MAX_GRID_Y = 65535               # fp32: a launch per 65535 of B * H;
                                  # bf16: its query tiles (of 128) on y;
                                  # backward: its tiles of 64 on y
BWD_TILE = 64                     # the backward's streamed tiles (and
                                  # the fp32 passes' blocks)
BWD_BLOCK = 128                   # the bf16 passes' rows a block
# the query pass (dq and delta), the key pass (each query head's share of
# dk and dv), the sum of those shares over each KV head's group
BWD_LAUNCHES_PER_CALL = 3


def _function(symbol: str, argtypes):
    fn = getattr(_build.library("flash_attention"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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


def _check_kernel(name: str, *ts) -> None:
    """What the kernels take beyond :func:`_check`: the current CUDA
    device, a head dim in HEAD_DIMS, contiguous 16-byte-aligned tensors."""
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for {q.device}")
    if q.get_device() != torch.cuda.current_device():
        raise ValueError(f"{name} inputs must lie on the current device")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {q.shape[3]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} inputs must be 16-byte aligned")


def _forward(q, k, v, causal: bool, sm_scale: float | None,
             with_lse: bool = False):
    """The kernel of q's dtype (CUDA) or the plain version (CPU): the
    output and, on CUDA with ``with_lse``, the rows' log-sum-exp (fp32
    (B, H, Sq)), else None."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=sm_scale), \
            None
    _check_kernel("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, device=q.device, dtype=torch.float32)
           if with_lse else None)
    if q.numel() == 0:
        return out, lse
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    if q.dtype == torch.bfloat16 and -(-sq // 128) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention kernel: Sq = {sq} exceeds its "
                         f"grid")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    rc = _function(_SYMBOLS[q.dtype], _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, h // hkv, sq, sk, d,
        scale, int(causal), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _build.count(flash_attention, 1 if q.dtype == torch.bfloat16
                 else -(-(b * h) // _MAX_GRID_Y))
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        sm_scale: float | None = None):
    """dq, dk, dv (the inputs' dtypes) of :func:`flash_attention` for the
    output gradient ``do``, from its inputs, its output ``o`` and its
    rows' log-sum-exp ``lse`` (fp32 (B, H, Sq)).  On CUDA tensors the
    backward kernel of q's dtype, or raises; on CPU tensors its plain
    version :func:`flash_attention_bwd_ref`.
    ``flash_attention_bwd.launches`` counts kernel launches, three per
    call (CPU calls do not launch and do not count);
    ``flash_attention_bwd.recorded`` those recorded into a CUDA graph
    being captured."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)}"
                             f" {t.dtype} on {t.device} must be "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if lse is None or lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd needs the forward's lse "
                         f"{(b, h, sq)} float32 on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                       sm_scale)
    _check_kernel("flash_attention_bwd", q, k, v, o, do, lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    if sk == 0:
        raise ValueError("flash_attention_bwd needs at least one key")
    if -(-max(sq, sk) // BWD_TILE) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention_bwd kernel: Sq = {sq} or Sk = "
                         f"{sk} exceeds its grid")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    # the rows' delta (fp32 passes); bf16: their lse log2(e) and delta,
    # rows padded to whole blocks
    stats = torch.empty(b, h, 2 * -(-sq // BWD_BLOCK) * BWD_BLOCK,
                        device=q.device, dtype=torch.float32)
    ws = torch.empty(2, b, h, sk, d, device=q.device, dtype=torch.float32)
    rc = _function(_BWD_SYMBOLS[q.dtype], _BWD_ARGTYPES)(
        *(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv, stats,
                                 ws)),
        b, h, h // hkv, sq, sk, d, scale, int(causal),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {rc}")
    _build.count(flash_attention_bwd, BWD_LAUNCHES_PER_CALL)
    return dq, dk, dv


def bwd_kernel_attributes(head_dim: int) -> dict:
    """``cudaFuncGetAttributes`` of the bf16 backward's two passes at
    ``head_dim``: ``{"flash_bwd_dq_wgmma": (numRegs, localSizeBytes),
    "flash_bwd_dkdv_wgmma": (...)}``; a local size of 0 means nothing
    spilled.  Builds the kernels on first use."""
    out = (ctypes.c_int * 4)()
    fn = _function("flash_attention_bwd_attributes",
                   [ctypes.c_int, ctypes.c_void_p])
    rc = fn(head_dim, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_attributes({head_dim}): "
                           f"CUDA error {rc}")
    return {"flash_bwd_dq_wgmma": (out[0], out[1]),
            "flash_bwd_dkdv_wgmma": (out[2], out[3])}


class _Flash(torch.autograd.Function):
    """Forward: :func:`_forward`.  On CUDA tensors with ``keep_lse`` (a
    backward will follow) it keeps q, k, v, the output and its lse, and
    the backward is :func:`flash_attention_bwd`; on CPU tensors it keeps
    q, k and v, and the backward is the VJP of :func:`attention_ref`
    recomputed under autograd.  The gradients are in the inputs' dtypes;
    an input that needs none gets None."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, keep_lse):
        ctx.causal, ctx.sm_scale = causal, sm_scale
        keep = keep_lse and q.device.type == "cuda"
        out, lse = _forward(q, k, v, causal, sm_scale, with_lse=keep)
        ctx.save_for_backward(q, k, v, *((out, lse) if keep else ()))
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        if g.device.type == "cpu":
            xs = [t.detach().requires_grad_(w)
                  for t, w in zip(saved, need)]
            with torch.enable_grad():
                o = attention_ref(*xs, causal=ctx.causal,
                                  sm_scale=ctx.sm_scale)
                want = [t for t in xs if t.requires_grad]
                got = iter(torch.autograd.grad(o, want, g))
            grads = tuple(next(got) if t.requires_grad else None
                          for t in xs)
        else:
            grads = tuple(gr if w else None for gr, w in zip(
                flash_attention_bwd(*saved, g.contiguous(), ctx.causal,
                                    ctx.sm_scale), need))
        return grads + (None, None, None)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None):
    """GQA attention: q (B, H, Sq, D); k, v (B, Hkv, Sk, D), H % Hkv == 0;
    query head h reads KV head ``h // (H / Hkv)``.  Causal keeps
    ``qpos >= kpos``.  fp32 softmax, output in q's dtype.  Differentiable
    in q, k and v (on the card the backward kernel, on the CPU the plain
    version's VJP).  ``flash_attention.launches`` counts forward kernel
    launches, a recompute under ``torch.utils.checkpoint`` included, and
    ``flash_attention_bwd.launches`` backward ones (CPU calls do not
    launch and do not count); ``.recorded`` those recorded into a CUDA
    graph being captured."""
    _check(q, k, v)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _Flash.apply(q, k, v, causal, sm_scale, keep)


flash_attention.launches = flash_attention.recorded = 0
flash_attention_bwd.launches = flash_attention_bwd.recorded = 0
