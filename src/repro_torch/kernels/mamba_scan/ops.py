"""Wrappers of the Mamba-1 selective-scan kernels (``csrc/mamba_scan.cu``),
forward and backward, joined by a ``torch.autograd.Function``.

On CUDA tensors each launches its kernel on the current stream, or
raises; on CPU tensors the forward runs :func:`mamba_scan_ref` and the
backward :func:`mamba_scan_bwd_ref`.  They take any L and D and never
pad: the kernels mask the ragged edges.  When a backward will follow,
the forward kernel also keeps the state entering every chunk of
``CHUNK`` steps, from which the backward kernel steps each chunk again
before sweeping it in reverse.  The gradients are the JAX package's
(``jax.vjp`` of the reference in its custom VJP); there the reference is
differentiated, here both directions are kernels.

:func:`mamba_scan_with_state` is the serving variant, inference only:
the same forward kernel also stores the state after the last step, which
a prefill hands to the recurrent decode.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import (CHUNK, mamba_scan_bwd_ref,
                                                mamba_scan_ref,
                                                mamba_scan_with_state_ref)

_SYMBOLS = {torch.float32: "mamba_scan_f32",
            torch.bfloat16: "mamba_scan_bf16"}
_BWD_SYMBOLS = {torch.float32: "mamba_scan_bwd_f32",
                torch.bfloat16: "mamba_scan_bwd_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])
MAX_STATE = 32                # the kernels keep N fp32 states in registers
BWD_LAUNCHES_PER_CALL = 2     # the sweep, then the sum of its partials
_MAX_INT = 2**31 - 1


def _function(symbol: str, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.library("mamba_scan"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
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
    """What the CUDA kernels take beyond what the plain versions do."""
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
    n = a.shape[1]
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"mamba_scan kernel: state size N = {n} is outside "
                         f"1..{MAX_STATE}")
    # the kernels index with 32-bit ints and launch one block per 32
    # channels of a batch row
    if u.numel() > _MAX_INT or b.numel() > _MAX_INT \
            or u.shape[0] * -(-u.shape[2] // 32) > _MAX_INT:
        raise ValueError(f"mamba_scan kernel: shape {tuple(u.shape)} "
                         f"exceeds its grid")


def _launch(u, delta, a, b, c, skip, keep_states: bool,
            keep_last: bool = False):
    """y, the states entering each chunk (or None), and the state after
    the last step (or None)."""
    bsz, ell, d = u.shape
    n = a.shape[1]
    y = torch.empty_like(u)
    states = (torch.empty(bsz, -(-ell // CHUNK), d, n, device=u.device,
                          dtype=torch.float32) if keep_states else None)
    last = (torch.empty(bsz, d, n, device=u.device, dtype=torch.float32)
            if keep_last else None)
    if y.numel() == 0:     # no step: the state is the zeros it started as
        return y, states, None if last is None else last.zero_()
    rc = _function(_SYMBOLS[u.dtype], _ARGTYPES)(
        u.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), skip.data_ptr(), y.data_ptr(),
        None if states is None else states.data_ptr(),
        None if last is None else last.data_ptr(), bsz, ell, d, n,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{rc}")
    # the serving variant counts apart from the training scan
    _build.count(mamba_scan_with_state if keep_last else mamba_scan)
    return y, states, last


def mamba_scan_bwd(u, delta, a, b, c, skip, g, states):
    """The backward kernels on CUDA tensors: the six gradients of
    :func:`mamba_scan` for the output gradient g (B, L, D, u's dtype,
    contiguous), each in its input's dtype, from the inputs and the
    ``states`` their forward kept.  ``mamba_scan_bwd.launches`` counts
    kernel launches, two per call."""
    bsz, ell, d = u.shape
    n = a.shape[1]
    if g.shape != u.shape or g.dtype != u.dtype or not g.is_contiguous() \
            or g.device != u.device:
        raise ValueError(f"mamba_scan_bwd: g {tuple(g.shape)} {g.dtype} "
                         f"must be a contiguous {tuple(u.shape)} {u.dtype} "
                         f"on {u.device}")
    want = (bsz, -(-ell // CHUNK), d, n)
    if states is None or tuple(states.shape) != want \
            or states.dtype != torch.float32 or not states.is_contiguous() \
            or states.device != u.device:
        raise ValueError(f"mamba_scan_bwd needs the forward's states "
                         f"{want} float32")
    grads = tuple(torch.empty_like(t) for t in (u, delta, a, b, c, skip))
    if u.numel() == 0:
        return tuple(t.zero_() for t in grads)
    ws = _function("mamba_scan_bwd_workspace", [ctypes.c_int] * 4,
                   ctypes.c_longlong)(bsz, ell, d, n)
    work = torch.empty(ws, device=u.device, dtype=torch.float32)
    du, ddelta, da, db, dc, dskip = grads
    rc = _function(_BWD_SYMBOLS[u.dtype], _BWD_ARGTYPES)(
        *(t.data_ptr() for t in (u, delta, a, b, c, skip, g, states, du,
                                 ddelta, da, db, dc, dskip, work)),
        bsz, ell, d, n, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan backward kernel launch failed: CUDA "
                           f"error {rc}")
    _build.count(mamba_scan_bwd, BWD_LAUNCHES_PER_CALL)
    return grads


class _Scan(torch.autograd.Function):
    """Forward: the kernel (CUDA), keeping the chunk states when asked,
    or the plain version (CPU).  Backward: the backward kernel (CUDA) or
    its plain version (CPU), the gradients in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, u, delta, a, b, c, skip, keep_states):
        if u.device.type == "cpu":
            y, states = mamba_scan_ref(u, delta, a, b, c, skip), None
        else:
            y, states, _ = _launch(u, delta, a, b, c, skip,
                                   keep_states)
        ctx.save_for_backward(u, delta, a, b, c, skip, states)
        return y

    @staticmethod
    def backward(ctx, g):
        *xs, states = ctx.saved_tensors
        if g.device.type == "cpu":
            grads = mamba_scan_bwd_ref(*xs, g, states)
        else:
            grads = mamba_scan_bwd(*xs, g.contiguous(), states)
        return tuple(gr if w else None
                     for gr, w in zip(grads, ctx.needs_input_grad)) + (None,)


def mamba_scan(u, delta, a, b, c, skip):
    """u, delta: (B, L, D); a: (D, N); b, c: (B, L, N); skip: (D,) ->
    y (B, L, D) in u's dtype, with the fp32 recurrence of
    :func:`mamba_scan_ref`.  Differentiable in all six inputs.
    ``mamba_scan.launches`` counts forward kernel launches and
    ``mamba_scan_bwd.launches`` backward ones (CPU calls do not count)."""
    _check(u, delta, a, b, c, skip)
    if u.device.type == "cuda":
        _check_kernel(u, delta, a, b, c, skip)
    elif u.device.type != "cpu":
        raise ValueError(f"mamba_scan has no kernel for {u.device}")
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u, delta, a, b, c, skip))
    return _Scan.apply(u, delta, a, b, c, skip, keep)


def mamba_scan_with_state(u, delta, a, b, c, skip):
    """As :func:`mamba_scan`, and the state after the last step: (y
    (B, L, D) in u's dtype, h_last (B, D, N) fp32), the plain version
    :func:`mamba_scan_with_state_ref`.  Inference only: inputs that
    require grad are refused.  ``mamba_scan_with_state.launches`` counts
    its kernel launches (CPU calls do not count)."""
    _check(u, delta, a, b, c, skip)
    if any(t.requires_grad for t in (u, delta, a, b, c, skip)):
        raise ValueError("mamba_scan_with_state is inference-only: an "
                         "input requires grad")
    if u.device.type == "cpu":
        return mamba_scan_with_state_ref(u, delta, a, b, c, skip)
    if u.device.type != "cuda":
        raise ValueError(f"mamba_scan has no kernel for {u.device}")
    _check_kernel(u, delta, a, b, c, skip)
    y, _, last = _launch(u, delta, a, b, c, skip, keep_states=False,
                         keep_last=True)
    return y, last


mamba_scan.launches = mamba_scan.recorded = 0
mamba_scan_bwd.launches = mamba_scan_bwd.recorded = 0
mamba_scan_with_state.launches = mamba_scan_with_state.recorded = 0
