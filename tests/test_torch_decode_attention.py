"""The port's decode attention (on the CPU: its plain version) against the
JAX package's Pallas kernel in interpret mode (with an integer
``kv_len``) and its ``decode_attention_ref``, over the JAX sweep's
shapes — the masked tail and a cache length that is no multiple of the
Pallas block included — with the same numpy-seeded inputs (2e-5 fp32,
2e-2 bf16); the plain version of the kernel's split-and-merge against
both, at one split, a ragged last split, splits with no valid key and
kv_len = 1, and the split arithmetic itself; the bf16 gate of the
on-card checks, which the split passes and a P rounded to one bf16
fails; and decode == the last row of flash attention, inside the
port."""
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import (decode_attention_ref as
                                            jax_ref)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention.ops import (MAX_SPLITS,
                                                     decode_split)
from repro_torch.kernels.decode_attention.ref import (
    BF16_EXCESS, bf16_rounding_excess, decode_attention_ref,
    decode_attention_split_ref)
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



# (b, h, hkv, s, d, kv_len, n_splits, split_keys); None: the wrapper's
# split on a 132-SM card
SPLIT_CASES = [
    (1, 8, 2, 512, 64, 40, None, None),        # one split
    (1, 8, 2, 1024, 64, 700, None, None),      # 11 x 64, the last ragged
    (2, 8, 2, 512, 32, 300, 4, 128),           # the last split holds none
    (1, 4, 1, 512, 16, 100, 16, 8),            # three hold none
    (1, 8, 2, 512, 64, 1, None, None),         # kv_len = 1
    (1, 8, 2, 512, 64, 1, 4, 8),               # kv_len = 1, three empty
    (1, 32, 4, 3072, 128, 3016, None, None),   # yi-6b, 16 x 192
]


@pytest.mark.parametrize("b,h,hkv,s,d,kvlen,n_splits,split_keys",
                         SPLIT_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_and_merge_matches_jax(b, h, hkv, s, d, kvlen, n_splits,
                                     split_keys, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        7 * s + kvlen, [(b, h, d), (b, hkv, s, d), (b, hkv, s, d)], dtype)
    if n_splits is None:
        n_splits, split_keys = decode_split(b * hkv, kvlen, 132)
    got = decode_attention_split_ref(tq, tk, tv, kv_len=kvlen,
                                     n_splits=n_splits,
                                     split_keys=split_keys)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    for want in (decode_attention_ref(tq, tk, tv, kv_len=kvlen),  # port
                 jax_decode(jq, jk, jv, kv_len=kvlen),             # Pallas
                 jax_ref(jq, jk, jv, kv_len=kvlen)):               # oracle
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("kv_len", [1, 7, 8, 28, 64, 65, 513, 3016, 4096,
                                    32768])
@pytest.mark.parametrize("batch_heads", [1, 4, 33, 132, 66000])
def test_decode_split_covers_every_key_once(batch_heads, kv_len):
    n, split_keys = decode_split(batch_heads, kv_len, 132)
    assert 1 <= n <= MAX_SPLITS and split_keys % 64 == 0
    assert (n - 1) * split_keys < kv_len <= n * split_keys
    if batch_heads >= 132:           # B * Hkv alone fills the card
        assert n == 1


def test_decode_split_at_yi_6b_decode():
    """B * Hkv = 4 on 132 SMs: one block per 64 keys up to 16, the
    cluster's size."""
    assert decode_split(4, 28, 132) == (1, 64)
    assert decode_split(4, 513, 132) == (9, 64)
    assert decode_split(4, 3016, 132) == (16, 192)
    assert decode_split(4, 4096, 132) == (16, 256)


def _single_bf16_p(q, k, v, kv_len):
    """A control the bf16 gate must reject: P rounded to one bf16 before
    P.V, as a tensor-core kernel that keeps no low term of P would do."""
    b, h, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    sc = torch.einsum("bhgd,bhkd->bhgk", qg,
                      k[:, :, :kv_len].float()) * d ** -0.5
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    o = torch.einsum("bhgk,bhkd->bhgd", p.bfloat16().float(),
                     v[:, :, :kv_len].float()) / p.sum(-1, keepdim=True)
    return o.reshape(b, h, d).bfloat16()


@pytest.mark.parametrize("kvlen", [1, 28, 513, 3016, 4096])
def test_bf16_gate_passes_the_split_and_rejects_a_single_bf16_p(kvlen):
    """yi-6b's decode shapes: the plain split-and-merge in bf16 (fp32 P,
    another summation order) lies within half a bf16 ulp of the fp32
    result plus BF16_EXCESS; P rounded to one bf16 lies past it at every
    kv_len with more than one key."""
    g = torch.Generator().manual_seed(kvlen)
    q, k, v = (torch.randn(sh, generator=g).bfloat16()
               for sh in ((1, 32, 128), (1, 4, 4096, 128),
                          (1, 4, 4096, 128)))
    want32 = decode_attention_ref(q.float(), k.float(), v.float(),
                                  kv_len=kvlen)
    n_splits, split_keys = decode_split(4, kvlen, 132)
    split = decode_attention_split_ref(q, k, v, kv_len=kvlen,
                                       n_splits=n_splits,
                                       split_keys=split_keys)
    assert bf16_rounding_excess(split, want32) <= BF16_EXCESS
    assert bf16_rounding_excess(decode_attention_ref(q, k, v, kv_len=kvlen),
                                want32) <= BF16_EXCESS
    control = bf16_rounding_excess(_single_bf16_p(q, k, v, kvlen), want32)
    if kvlen > 1:
        assert control > 10 * BF16_EXCESS
