"""The port's flash attention (on the CPU: its plain version, which the
wrapper runs for CPU tensors) against the JAX package's Pallas kernel in
interpret mode and its ``attention_ref``, over the JAX sweep's shapes and
yi-6b's head layout, with the same inputs made by numpy from a seed (the
sweep's tolerances: 2e-5 fp32, 2e-2 bf16).

The wrapper's autograd Function (the training path) is held against
``jax.grad`` through the Pallas kernel in interpret mode, whose custom
VJP differentiates ``attention_ref`` as the Function's backward does:
fp32 gradients within 1e-5 relative in norm (observed <= 4e-7, the
same ops in another framework), bf16 within 1e-3 (observed <= 4e-5: a
few elements a bf16 ulp apart, the transposes rounding where each
framework puts them).

The backward kernel's plain version (``flash_attention_bwd_ref``, what
the on-card tests hold the kernel to), fed ``attention_lse_ref``'s o and
lse, is held against the same ``jax.grad``: fp32 within 1e-5, bf16
within 5e-3 (see ``BWD_REL``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref)
from test_kernels import FLASH_SWEEP

# yi-6b's head layout (H = 32, Hkv = 4, D = 128) at a ragged causal
# prefill: the shape the on-card tests hold the kernels to
PATH = [(1, 32, 4, 300, 128, True)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, dtype):
    """Each array rounded to ``dtype`` once, then handed to both sides."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    out = []
    for s in shapes:
        a = np.asarray(jnp.asarray(rng.standard_normal(s, np.float32), jdt),
                       np.float32)
        out.append((jnp.asarray(a, jdt), torch.tensor(a, dtype=tdt)))
    return out


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,h,hkv,s,d,causal", FLASH_SWEEP + PATH)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_jax(b, h, hkv, s, d, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        s + d, [(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)], dtype)
    got = flash_attention(tq, tk, tv, causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert flash_attention.launches == 0      # CPU tensors never launch
    tol = DTYPES[dtype][2]
    for want in (jax_flash(jq, jk, jv, causal),                # Pallas
                 jax_ref(jq, jk, jv, causal=causal)):          # oracle
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_chunked_plain_version_matches_one_block():
    """``chunk_q`` splits the queries and keeps each row's softmax whole."""
    (_, q), (_, k), (_, v) = _inputs(
        7, [(1, 4, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16)], "float32")
    whole = attention_ref(q, k, v, causal=True, chunk_q=None)
    chunked = attention_ref(q, k, v, causal=True, chunk_q=16)
    np.testing.assert_allclose(_np(chunked), _np(whole), rtol=1e-6,
                               atol=1e-6)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError):          # 4 heads over 3 KV heads
        flash_attention(q, kv, kv)
    with pytest.raises(TypeError):
        flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError):          # no batch axis
        flash_attention(q[0], torch.zeros(2, 8, 16), torch.zeros(2, 8, 16))


GRAD_SHAPES = [(1, 4, 4, 128, 64, True), (1, 4, 2, 100, 128, True),
               (1, 2, 2, 64, 16, False), (2, 8, 2, 40, 16, True)]
GRAD_REL = {"float32": 1e-5, "bfloat16": 1e-3}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("b,h,hkv,s,d,causal", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_function_gradients_match_jax_grad_through_pallas(b, h, hkv, s, d,
                                                          causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        s * d + h, [(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)], dtype)
    g = np.random.default_rng(s).standard_normal((b, h, s, d), np.float32)
    jg = jnp.asarray(g, DTYPES[dtype][0])
    tg = torch.tensor(np.asarray(jg, np.float32), dtype=DTYPES[dtype][1])

    def loss(q, k, v):
        return jnp.sum((jax_flash(q, k, v, causal).astype(jnp.float32)
                        * jg.astype(jnp.float32)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = flash_attention(*xs, causal)
    got = torch.autograd.grad(out, xs, tg)
    assert flash_attention.launches == 0      # CPU tensors never launch
    for x, gt, w in zip(xs, got, want):
        assert gt.dtype == x.dtype and gt.shape == x.shape
        assert _rel(gt, w) <= GRAD_REL[dtype], _rel(gt, w)
    # the Function's backward is autograd through the plain version
    ys = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    plain = torch.autograd.grad(attention_ref(*ys, causal=causal), ys, tg)
    assert all(torch.equal(a, c) for a, c in zip(got, plain))


def test_function_gives_only_the_gradients_asked_for():
    (_, q), (_, k), (_, v) = _inputs(
        3, [(1, 4, 24, 16), (1, 2, 24, 16), (1, 2, 24, 16)], "float32")
    q.requires_grad_()
    (gq,) = torch.autograd.grad(flash_attention(q, k, v).sum(), [q])
    assert gq.shape == q.shape and torch.isfinite(gq).all()
    with torch.no_grad():                    # no graph: the plain forward
        assert not flash_attention(q, k, v).requires_grad


@pytest.mark.parametrize("chunk_q", [2048, 32])
@pytest.mark.parametrize("b,h,hkv,s,d,causal", FLASH_SWEEP + PATH)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lse_plain_version_keeps_the_output_and_the_log_sum_exp(
        b, h, hkv, s, d, causal, dtype, chunk_q):
    """``attention_lse_ref``'s o is ``attention_ref``'s bit for bit (one
    block, and 32-query chunks where S divides); its lse lies within
    1e-5 of a float64 log-sum-exp of the same scaled, masked scores."""
    (_, q), (_, k), (_, v) = _inputs(
        s + d + 1, [(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)], dtype)
    o, lse = attention_lse_ref(q, k, v, causal=causal, chunk_q=chunk_q)
    assert torch.equal(o, attention_ref(q, k, v, causal=causal,
                                        chunk_q=chunk_q))
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.double(),
                      k.double().repeat_interleave(h // hkv, 1)) * d ** -0.5
    if causal:
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                            float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(sc, -1).numpy(),
                               rtol=1e-5, atol=1e-5)


# the backward's plain version against jax.grad through the Pallas
# kernel: GRAD_SHAPES, a non-causal Sq != Sk (seamless's cross-attention
# in small) and GQA group 3 (minitron-4b's, phi4-mini's).  fp32: the
# same math in another order (observed <= 6e-7).  bf16: delta =
# rowsum(dO o) is taken from the bf16 o, each element rounded by up to
# 2^-9 of itself where JAX's VJP uses the fp32 o, and dq, dk follow dS =
# P (dP - delta) (observed <= 2e-3; dv, which reads no delta, <= 1.2e-4)
BWD_SHAPES = [(b, h, hkv, s, s, d, causal)
              for b, h, hkv, s, d, causal in GRAD_SHAPES] + [
    (1, 2, 2, 12, 40, 64, False), (2, 6, 2, 48, 48, 32, True)]
BWD_REL = {"float32": 1e-5, "bfloat16": 5e-3}


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", BWD_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_plain_version_matches_jax_grad_through_pallas(
        b, h, hkv, sq, sk, d, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        sq * d + h, [(b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)],
        dtype)
    g = np.random.default_rng(sq).standard_normal((b, h, sq, d), np.float32)
    jg = jnp.asarray(g, DTYPES[dtype][0])
    tg = torch.tensor(np.asarray(jg, np.float32), dtype=DTYPES[dtype][1])

    def loss(q, k, v):
        return jnp.sum((jax_flash(q, k, v, causal).astype(jnp.float32)
                        * jg.astype(jnp.float32)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    o, lse = attention_lse_ref(tq, tk, tv, causal=causal)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tg, causal)
    # the wrapper takes CPU tensors to the plain version, launching nothing
    assert all(torch.equal(a, c) for a, c in zip(
        got, flash_attention_bwd(tq, tk, tv, o, lse, tg, causal)))
    assert flash_attention_bwd.launches == 0
    for x, gt, w in zip((tq, tk, tv), got, want):
        assert gt.dtype == x.dtype and gt.shape == x.shape
        assert _rel(gt, w) <= BWD_REL[dtype], _rel(gt, w)


@pytest.mark.parametrize("chunk_q", [None, 16, 7])
def test_backward_plain_version_chunks_keep_the_sums(chunk_q):
    """``chunk_q`` (ragged last chunk included) only splits the queries:
    the gradients agree with one whole block within fp32 rounding."""
    (_, q), (_, k), (_, v), (_, g) = _inputs(
        11, [(2, 6, 40, 32), (2, 2, 40, 32), (2, 2, 40, 32),
             (2, 6, 40, 32)], "float32")
    o, lse = attention_lse_ref(q, k, v, causal=True)
    whole = flash_attention_bwd_ref(q, k, v, o, lse, g, True, chunk_q=40)
    got = flash_attention_bwd_ref(q, k, v, o, lse, g, True,
                                  chunk_q=chunk_q or 1024)
    for a, w in zip(got, whole):
        np.testing.assert_allclose(_np(a), _np(w), rtol=1e-5, atol=1e-6)


def test_backward_wrapper_refuses_what_it_does_not_take():
    (_, q), (_, k), (_, v) = _inputs(
        5, [(1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)], "float32")
    o, lse = attention_lse_ref(q, k, v)
    with pytest.raises(ValueError):          # no lse
        flash_attention_bwd(q, k, v, o, None, o)
    with pytest.raises(ValueError):          # lse of the wrong shape
        flash_attention_bwd(q, k, v, o, lse[:, :2], o)
    with pytest.raises(ValueError):          # do of another dtype
        flash_attention_bwd(q, k, v, o, lse, o.double())
    with pytest.raises(ValueError):          # o of another shape
        flash_attention_bwd(q, k, v, o[:, :, :4], lse, o)
