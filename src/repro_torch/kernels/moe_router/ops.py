"""Wrapper of the top-k softmax router kernel (``csrc/moe_router.cu``).

On CUDA tensors it launches the kernel on the current stream, or raises;
on CPU tensors it runs the plain version (:func:`moe_router_ref`).  It
takes any number of tokens and never pads: the kernel gives each token
row a warp of its own.

The weights are differentiable in the logits through a
``torch.autograd.Function``: the backward is the gradient of
``w = p[idx] / max(sum p[idx], 1e-20)``, ``p = softmax(logits)``,
recomputed in plain PyTorch at the indices the forward chose, so a tie
can never make the backward take other experts than the forward did.
The indices take no gradient.  (The JAX package trains only through its
plain router, whose top-k is differentiated the same way: the gradient
reaches the chosen probabilities.)
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_router.ref import moe_router_ref, router_weights

_SYMBOLS = {torch.float32: "moe_router_f32",
            torch.bfloat16: "moe_router_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
MAX_EXPERTS = 512                 # 16 logits per lane of a warp
_MAX_TOKENS = 2**31 - 1


def _launcher(dtype: torch.dtype):
    fn = getattr(_build.library("moe_router"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(logits, k: int) -> None:
    if not logits.is_floating_point():
        raise TypeError(f"moe_router takes float logits, got {logits.dtype}")
    if logits.dim() != 2:
        raise ValueError("moe_router takes logits (T, E), got shape "
                         f"{tuple(logits.shape)}")
    e = logits.shape[1]
    if not isinstance(k, int) or not 0 < k <= e <= MAX_EXPERTS:
        raise ValueError(f"moe_router needs an int 0 < k <= E <= "
                         f"{MAX_EXPERTS}, got k={k!r}, E={e}")
    if not logits.is_contiguous():
        raise ValueError("moe_router logits must be contiguous")


def _forward(logits, k: int):
    """The kernel (CUDA) or the plain version (CPU)."""
    if logits.device.type == "cpu":
        return moe_router_ref(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_router has no kernel for {logits.device}")
    if logits.dtype not in _SYMBOLS:
        raise TypeError("moe_router's kernel takes float32 or bfloat16 "
                        f"logits, got {logits.dtype}")
    if logits.get_device() != torch.cuda.current_device():
        raise ValueError("moe_router logits must lie on the current device")
    t, e = logits.shape
    w = torch.empty(t, k, device=logits.device, dtype=torch.float32)
    idx = torch.empty(t, k, device=logits.device, dtype=torch.int32)
    if t == 0:
        return w, idx
    if t > _MAX_TOKENS:
        raise ValueError(f"moe_router kernel: {t} tokens exceed its grid")
    rc = _launcher(logits.dtype)(
        logits.data_ptr(), w.data_ptr(), idx.data_ptr(), t, e, k,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error "
                           f"{rc}")
    moe_router.launches += 1
    return w, idx


class _Router(torch.autograd.Function):
    """Forward: :func:`_forward`, keeping the logits and the indices.
    Backward: the VJP of :func:`router_weights` at those indices, in the
    logits' dtype."""

    @staticmethod
    def forward(ctx, logits, k):
        w, idx = _forward(logits, k)
        ctx.save_for_backward(logits, idx)
        ctx.mark_non_differentiable(idx)
        return w, idx

    @staticmethod
    def backward(ctx, gw, _gidx):
        logits, idx = ctx.saved_tensors
        x = logits.detach().requires_grad_()
        with torch.enable_grad():
            w = router_weights(x, idx)
            gx, = torch.autograd.grad(w, x, gw)
        return gx, None


def moe_router(logits, k: int):
    """logits (T, E) -> (weights (T, k) fp32, indices (T, k) int32): per
    token the k largest softmax probabilities, renormalised to sum to 1,
    in descending order, the lower expert index first on ties.  The
    weights are differentiable in the logits.  ``moe_router.launches``
    counts kernel launches (CPU calls do not count)."""
    _check(logits, k)
    return _Router.apply(logits, k)


moe_router.launches = 0
