"""Wrapper of the decode attention kernels (``csrc/decode_attention.cu``).

On CUDA tensors it launches the two kernels (split partials, then their
combine) on the current stream, or raises; on CPU tensors it runs the
plain version (:func:`decode_attention_ref`).  It never pads: the kernel
reads only the first ``kv_len`` keys of the cache.  Inference only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_SYMBOLS = {torch.float32: "decode_attention_f32",
            torch.bfloat16: "decode_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
MAX_GROUP = 16                    # query heads per KV head
KEYS_PER_SPLIT = 128              # keys per block of the first launch
LAUNCHES_PER_CALL = 2             # partials + combine, B * Hkv <= 65535
_MAX_GRID_Y = 65535               # a partials launch per 65535 of B * Hkv


def _launcher(dtype: torch.dtype):
    fn = getattr(_build.library("decode_attention"), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, kv_len: int) -> None:
    ts = (q, k, v)
    if any(t.requires_grad for t in ts):
        raise ValueError("decode_attention is inference-only: an input "
                         "requires grad")
    if any(t.device != q.device for t in ts):
        raise ValueError("decode_attention inputs lie on different devices")
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _SYMBOLS:
        raise TypeError("decode_attention takes float32 or bfloat16 inputs "
                        f"of one dtype, got {[t.dtype for t in ts]}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention takes q (B, H, D) and k, v "
                         f"(B, Hkv, S, D), got {[tuple(t.shape) for t in ts]}")
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, s, d) or hkv == 0 or h % hkv:
        raise ValueError(f"decode_attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if not isinstance(kv_len, int) or not 0 < kv_len <= s:
        raise ValueError(f"decode_attention needs an int 0 < kv_len <= {s}, "
                         f"got {kv_len!r}")


def decode_attention(q, k, v, kv_len: int | None = None,
                     sm_scale: float | None = None):
    """One token against a cache: q (B, H, D); k, v (B, Hkv, S, D); keys
    at positions >= ``kv_len`` (a host int, default S) are masked.
    Returns (B, H, D) in q's dtype.  ``decode_attention.launches`` counts
    kernel launches, two per CUDA call up to B * Hkv = 65535 and one more
    per further 65535 (CPU calls do not count)."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, sm_scale=sm_scale,
                                    kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention has no kernel for {q.device}")
    if q.get_device() != torch.cuda.current_device():
        raise ValueError("decode_attention inputs must lie on the current "
                         "device")
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    if d not in HEAD_DIMS or group > MAX_GROUP:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{HEAD_DIMS} and <= {MAX_GROUP} query heads per "
                         f"KV head, got D={d}, G={group}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("decode_attention inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out
    n_splits = -(-kv_len // KEYS_PER_SPLIT)
    part_o = torch.empty(b * hkv * n_splits * group * d, device=q.device,
                         dtype=torch.float32)
    part_ml = torch.empty(b * hkv * n_splits * group * 2, device=q.device,
                          dtype=torch.float32)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    rc = _launcher(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), b, hkv, group, s, kv_len, d,
        scale, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += -(-(b * hkv) // _MAX_GRID_Y) + 1
    return out


decode_attention.launches = 0
