"""The port's decode attention (on the CPU: its plain version) against the
JAX package's Pallas kernel in interpret mode (with an integer
``kv_len``) and its ``decode_attention_ref``, over the JAX sweep's
shapes — the masked tail and a cache length that is no multiple of the
Pallas block included — with the same numpy-seeded inputs (2e-5 fp32,
2e-2 bf16); and decode == the last row of flash attention, inside the
port."""
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import (decode_attention_ref as
                                            jax_ref)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from test_kernels import DECODE_SWEEP
from test_torch_flash_attention import DTYPES, _inputs, _np


@pytest.mark.parametrize("b,h,hkv,s,d,kvlen", DECODE_SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_matches_jax(b, h, hkv, s, d, kvlen, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        s + kvlen, [(b, h, d), (b, hkv, s, d), (b, hkv, s, d)], dtype)
    got = decode_attention(tq, tk, tv, kv_len=kvlen)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert decode_attention.launches == 0     # CPU tensors never launch
    tol = DTYPES[dtype][2]
    for want in (jax_decode(jq, jk, jv, kv_len=kvlen),         # Pallas
                 jax_ref(jq, jk, jv, kv_len=kvlen)):           # oracle
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_keys_past_kv_len_do_not_count():
    (_, q), (_, k), (_, v) = _inputs(
        3, [(1, 4, 16), (1, 2, 40, 16), (1, 2, 40, 16)], "float32")
    want = decode_attention(q, k[:, :, :17].contiguous(),
                            v[:, :, :17].contiguous())
    k[:, :, 17:] = float("nan")
    v[:, :, 17:] = 1e30
    got = decode_attention(q, k, v, kv_len=17)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_decode_matches_flash_last_row():
    """Decode of the last position == causal flash attention's last row."""
    (_, q), (_, k), (_, v) = _inputs(
        4, [(1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)], "float32")
    full = flash_attention(q, k, v, True)
    dec = decode_attention(q[:, :, -1].contiguous(), k, v, kv_len=128)
    np.testing.assert_allclose(_np(dec), _np(full[:, :, -1]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kv_len", [0, 41, 2.5])
def test_wrapper_refuses_a_bad_kv_len(kv_len):
    q = torch.zeros(1, 4, 16)
    kv = torch.zeros(1, 2, 40, 16)
    with pytest.raises(ValueError):
        decode_attention(q, kv, kv, kv_len=kv_len)

