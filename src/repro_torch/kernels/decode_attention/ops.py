"""Wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

On CUDA tensors it launches the kernel once on the current stream, or
raises; on CPU tensors it runs the plain version
(:func:`decode_attention_ref`).  The keys of each (b, KV head) are split
over the blocks of one thread block cluster by :func:`decode_split`,
from the card's SM count; the blocks merge through shared memory, so the
call needs no scratch memory.  It never pads.  Inference only.

``kv_len`` is a host int or a 0-d integer tensor on the inputs' device.
A host int sets the split, and the kernel reads only the first
``kv_len`` keys.  A tensor is read by the kernel itself: the split
follows the cache's length S, so the launch is the same at every
position and a CUDA graph of a decode step replays it (the serving
engine's); the keys past ``kv_len`` are then read and masked, and must
be finite (a slot's stale keys are).  Launches are counted in
``decode_attention.launches`` (``recorded`` while a graph captures).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_SYMBOLS = {torch.float32: "decode_attention_f32",
            torch.bfloat16: "decode_attention_bf16"}
_DEV_SYMBOLS = {torch.float32: "decode_attention_dev_f32",
                torch.bfloat16: "decode_attention_dev_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]
_DEV_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]
HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
MAX_GROUP = 16                    # query heads per KV head
LAUNCHES_PER_CALL = 1             # B * Hkv <= 65535
_MAX_GRID_Y = 65535               # a launch per 65535 of B * Hkv
_n_sm: dict[int, int] = {}        # device index -> SM count
# the split of one (b, KV head)'s keys over the blocks of a thread block
# cluster; the kernel exports both (decode_attention_limits) and the
# first launch checks them
KEYS_PER_STEP = 64                # rows of the kernel's TMA box
MAX_SPLITS = 16                   # blocks of one cluster


def decode_split(batch_heads: int, kv_len: int, n_sm: int) -> tuple[int, int]:
    """(n_splits, split_keys): how many blocks share the keys of one
    (b, KV head), and how many keys each takes (a multiple of the TMA
    box's 64 rows; the last split ragged).  Enough blocks that the
    B * Hkv clusters give every SM one, at most 16 (a cluster) and at most
    one per 64 keys; every split holds at least one key."""
    want = n_sm // batch_heads if batch_heads < n_sm else 1
    n = max(1, min(MAX_SPLITS, want, -(-kv_len // KEYS_PER_STEP)))
    split_keys = -(-kv_len // n)
    split_keys = -(-split_keys // KEYS_PER_STEP) * KEYS_PER_STEP
    return -(-kv_len // split_keys), split_keys


def _launcher(dtype: torch.dtype, device_len: bool = False):
    lib = _build.library("decode_attention")
    fn = getattr(lib, (_DEV_SYMBOLS if device_len else _SYMBOLS)[dtype])
    if fn.argtypes is None:
        box, splits = ctypes.c_int(), ctypes.c_int()
        lib.decode_attention_limits(ctypes.byref(box), ctypes.byref(splits))
        if (box.value, splits.value) != (KEYS_PER_STEP, MAX_SPLITS):
            raise RuntimeError(
                f"decode_attention kernel has a {box.value}-row box and "
                f"clusters of {splits.value}; decode_split assumes "
                f"{KEYS_PER_STEP} and {MAX_SPLITS}")
        fn.argtypes = _DEV_ARGTYPES if device_len else _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, kv_len) -> None:
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
    if isinstance(kv_len, torch.Tensor):
        if (kv_len.dim() or kv_len.dtype not in (torch.int32, torch.int64)
                or kv_len.device != q.device):
            raise ValueError(f"decode_attention takes kv_len as a host int "
                             f"or a 0-d int32 or int64 tensor on "
                             f"{q.device}, got "
                             f"{kv_len.dtype} {tuple(kv_len.shape)} on "
                             f"{kv_len.device}")
    elif not isinstance(kv_len, int) or not 0 < kv_len <= s:
        raise ValueError(f"decode_attention needs an int 0 < kv_len <= {s}, "
                         f"got {kv_len!r}")


def decode_attention(q, k, v, kv_len: int | torch.Tensor | None = None,
                     sm_scale: float | None = None):
    """One token against a cache: q (B, H, D); k, v (B, Hkv, S, D); keys
    at positions >= ``kv_len`` are masked: a host int (default S), or a
    0-d integer tensor on q's device with 0 < kv_len <= S, which the
    kernel reads on the card (rows past it must then be finite).
    Returns (B, H, D) in q's dtype.  ``decode_attention.launches`` counts
    kernel launches, one per CUDA call up to B * Hkv = 65535 and one more
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
    dev = q.get_device()
    if dev not in _n_sm:
        _n_sm[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    device_len = isinstance(kv_len, torch.Tensor)
    n_splits, split_keys = decode_split(b * hkv, s if device_len else kv_len,
                                        _n_sm[dev])
    _launch(q, k, v, out, kv_len, sm_scale, n_splits, split_keys)
    return out


def _launch(q, k, v, out, kv_len, sm_scale: float | None,
            n_splits: int, split_keys: int) -> None:
    """The kernel on checked CUDA tensors, with the split given (the
    on-card tests also force splits that hold no key); ``kv_len`` a host
    int, or a 0-d tensor the kernel reads (the split then covers S)."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    if isinstance(kv_len, torch.Tensor):
        kv = kv_len.to(torch.int32)
        rc = _launcher(q.dtype, device_len=True)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv.data_ptr(), b, hkv, h // hkv, s, d, n_splits, split_keys,
            scale, stream)
    else:
        rc = _launcher(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
            hkv, h // hkv, s, kv_len, d, n_splits, split_keys, scale,
            stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _build.count(decode_attention, -(-(b * hkv) // _MAX_GRID_Y))


decode_attention.launches = 0
decode_attention.recorded = 0
