"""Wrapper of the Mamba-1 selective-scan kernel (``csrc/mamba_scan.cu``),
with its gradient.

On CUDA tensors the forward launches the kernel on the current stream,
or raises; on CPU tensors it runs the plain version
(:func:`mamba_scan_ref`).  It takes any L and D and never pads: the
kernel masks the ragged edges.  The gradient is the JAX package's
(``kernels/mamba_scan/ops.py``'s custom VJP): the backward re-runs the
plain version on the saved inputs and differentiates it, so there is no
backward kernel.  That backward is a Python loop over L steps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

_SYMBOLS = {torch.float32: "mamba_scan_f32",
            torch.bfloat16: "mamba_scan_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
MAX_STATE = 32                # the kernel keeps N fp32 states in registers
_MAX_BATCH = 65535            # gridDim.y
_MAX_INT = 2**31 - 1


def _launcher(dtype: torch.dtype):
    fn = getattr(_build.library("mamba_scan"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(u, delta, a, b, c, skip) -> None:
    ts = (u, delta, a, b, c, skip)
    if not all(t.is_floating_point() for t in ts):
        raise TypeError("mamba_scan takes float tensors, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.device != u.device for t in ts):
        raise ValueError("mamba_scan inputs lie on different devices")
    if u.dim() != 3 or a.dim() != 2:
        raise ValueError(f"mamba_scan takes u (B, L, D) and a (D, N), got "
                         f"{tuple(u.shape)} and {tuple(a.shape)}")
    bsz, ell, d = u.shape
    n = a.shape[1]
    want = ((bsz, ell, d), (bsz, ell, d), (d, n), (bsz, ell, n),
            (bsz, ell, n), (d,))
    got = tuple(tuple(t.shape) for t in ts)
    if got != want:
        raise ValueError(f"mamba_scan shapes {got}, expected {want}")


def _check_kernel(u, delta, a, b, c, skip) -> None:
    """What the CUDA kernel takes beyond what the plain version does."""
    if u.get_device() != torch.cuda.current_device():
        raise ValueError("mamba_scan inputs must lie on the current device")
    io = (u, delta, b, c)
    if any(t.dtype != u.dtype for t in io) or u.dtype not in _SYMBOLS:
        raise TypeError("mamba_scan's kernel takes u, delta, b, c of one "
                        "dtype, float32 or bfloat16, got "
                        f"{[t.dtype for t in io]}")
    if a.dtype != torch.float32 or skip.dtype != torch.float32:
        raise TypeError("mamba_scan's kernel takes a and skip in float32, "
                        f"got {a.dtype} and {skip.dtype}")
    if not all(t.is_contiguous() for t in (u, delta, a, b, c, skip)):
        raise ValueError("mamba_scan inputs must be contiguous")
    bsz, ell, d = u.shape
    n = a.shape[1]
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"mamba_scan kernel: state size N = {n} is outside "
                         f"1..{MAX_STATE}")
    if bsz > _MAX_BATCH or u.numel() > _MAX_INT or b.numel() > _MAX_INT:
        raise ValueError(f"mamba_scan kernel: shape {tuple(u.shape)} "
                         f"exceeds its grid")


def _launch(u, delta, a, b, c, skip):
    y = torch.empty_like(u)
    if y.numel() == 0:
        return y
    bsz, ell, d = u.shape
    rc = _launcher(u.dtype)(
        u.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), skip.data_ptr(), y.data_ptr(), bsz, ell, d,
        a.shape[1], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{rc}")
    mamba_scan.launches += 1
    return y


class _Scan(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU), saving the
    six inputs.  Backward: the plain version re-run on them under
    autograd, as the JAX package's ``_bwd``; the gradients come in the
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, u, delta, a, b, c, skip):
        ctx.save_for_backward(u, delta, a, b, c, skip)
        if u.device.type == "cpu":
            return mamba_scan_ref(u, delta, a, b, c, skip)
        return _launch(u, delta, a, b, c, skip)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(w)
                  for t, w in zip(ctx.saved_tensors, need)]
            y = mamba_scan_ref(*xs)
            wrt = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(y, wrt, g, allow_unused=True,
                                           materialize_grads=True))
        return tuple(next(got) if w else None for w in need)


def mamba_scan(u, delta, a, b, c, skip):
    """u, delta: (B, L, D); a: (D, N); b, c: (B, L, N); skip: (D,) ->
    y (B, L, D) in u's dtype, with the fp32 recurrence of
    :func:`mamba_scan_ref`.  Differentiable in all six inputs.
    ``mamba_scan.launches`` counts kernel launches (CPU calls and the
    backward's plain re-run do not count)."""
    _check(u, delta, a, b, c, skip)
    if u.device.type == "cuda":
        _check_kernel(u, delta, a, b, c, skip)
    elif u.device.type != "cpu":
        raise ValueError(f"mamba_scan has no kernel for {u.device}")
    return _Scan.apply(u, delta, a, b, c, skip)


mamba_scan.launches = 0
