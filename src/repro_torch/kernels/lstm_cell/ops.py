"""Wrapper of the fused LSTM cell kernel (``csrc/lstm_cell.cu``).

On CUDA tensors it launches the kernel on the current stream, or raises;
on CPU tensors it runs the plain version (:func:`lstm_cell_ref`), which
plain autograd differentiates.  It never pads: the kernel masks the
ragged edge of the batch.  On the card an input that requires grad sends
the call through :class:`_Cell`, whose forward launches the kernel and
whose backward differentiates the plain cell recomputed from the saved
inputs, as the JAX package's ``custom_vjp`` does; there is no backward
kernel.

A launch is counted in ``lstm_cell.launches`` where it runs.  While a
CUDA graph captures the current stream the kernel is recorded, not run:
the launch is counted in ``lstm_cell.recorded`` instead, and the graph's
replays add what it recorded to ``launches``
(``repro_torch.core.programs``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

_SYMBOLS = {torch.float32: "lstm_cell_f32", torch.bfloat16: "lstm_cell_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# the kernel's launch geometry (csrc/lstm_cell.cu): a block takes 8 hidden
# units (32 gate columns) and up to 8 batch rows, a warp each, and stages
# its slice of the weights and the bias and its rows of x and h in at most
# 227 KB of shared memory
_ROWS = 8
_SMEM_BYTES = 232448


def _launcher(dtype: torch.dtype):
    fn = getattr(_build.library("lstm_cell"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(x, h, c, wx, wh, b) -> None:
    ts = (x, h, c, wx, wh, b)
    if any(t.device != x.device for t in ts):
        raise ValueError("lstm_cell inputs lie on different devices")
    if any(t.dtype != x.dtype for t in ts) or x.dtype not in _SYMBOLS:
        raise TypeError("lstm_cell takes float32 or bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError(f"x and h must be 2-D, got {x.shape}, {h.shape}")
    bsz, n_in = x.shape
    hid = h.shape[1]
    want = ((bsz, n_in), (bsz, hid), (bsz, hid), (n_in, 4 * hid),
            (hid, 4 * hid), (4 * hid,))
    got = tuple(tuple(t.shape) for t in ts)
    if got != want:
        raise ValueError(f"lstm_cell shapes {got}, expected {want}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("lstm_cell inputs must be contiguous")


def smem_bytes(n_in: int, hid: int, elem: int) -> int:
    """Shared memory one block of the kernel takes (``smem_bytes`` in
    csrc/lstm_cell.cu): the (In + H + 1) x 32 weight and bias slice in the
    input dtype, then each of its 8 rows of x and h in fp32."""
    k_all = n_in + hid
    return ((k_all + 1) * 32 * elem + 15) // 16 * 16 \
        + 4 * _ROWS * ((k_all + 3) // 4 * 4)


def _check_launch(n_in: int, hid: int, elem: int) -> None:
    """Shapes the kernel's geometry takes (the plain version takes any);
    ``elem`` is the bytes of one input element."""
    if smem_bytes(n_in, hid, elem) > _SMEM_BYTES:
        raise ValueError(f"lstm_cell kernel: In={n_in}, H={hid} exceed its "
                         f"{_SMEM_BYTES} bytes of shared memory")


def _launch(x, h, c, wx, wh, b):
    """The kernel on the current stream: returns ``(h', c')``."""
    bsz, n_in, hid = x.shape[0], x.shape[1], h.shape[1]
    if x.get_device() != torch.cuda.current_device():
        raise ValueError("lstm_cell inputs must lie on the current device")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    if bsz == 0:
        return h_out, c_out
    _check_launch(n_in, hid, x.element_size())
    rc = _launcher(x.dtype)(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
        wh.data_ptr(), b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        bsz, n_in, hid, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        lstm_cell.recorded += 1
    else:
        lstm_cell.launches += 1
    return h_out, c_out


class _Cell(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU, where
    :func:`lstm_cell` itself never applies the Function).  Backward:
    autograd of :func:`lstm_cell_ref` recomputed from the six saved
    inputs (the JAX ``_lstm_cell_bwd``: ``jax.vjp(lstm_cell_ref, ...)``)."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        if x.device.type == "cpu":
            return lstm_cell_ref(x, h, c, wx, wh, b)
        return _launch(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, g_h, g_c):
        xs = [t.detach().requires_grad_(w)
              for t, w in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = lstm_cell_ref(*xs)
        want = [t for t in xs if t.requires_grad]
        got = iter(torch.autograd.grad(outs, want, (g_h, g_c)))
        return tuple(next(got) if t.requires_grad else None for t in xs)


def lstm_cell(x, h, c, wx, wh, b):
    """One fused LSTM cell step: returns ``(h', c')``.

    x (B, In); h, c (B, H); wx (In, 4H); wh (H, 4H); b (4H,); gates
    packed [i, f, g, o]; float32 or bfloat16, fp32 math.  Differentiable
    in all six inputs.  ``lstm_cell.launches`` counts kernel launches
    (CPU calls do not launch and do not count); ``lstm_cell.recorded``
    counts launches recorded into a CUDA graph being captured."""
    _check(x, h, c, wx, wh, b)
    if x.device.type == "cpu":
        return lstm_cell_ref(x, h, c, wx, wh, b)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell has no kernel for {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, h, c, wx, wh, b)):
        return _Cell.apply(x, h, c, wx, wh, b)
    return _launch(x, h, c, wx, wh, b)


lstm_cell.launches = 0
lstm_cell.recorded = 0
