"""The port's top-k softmax router (on the CPU: its plain version, which
the wrapper runs for CPU tensors) against the JAX package's Pallas
kernel in interpret mode and its ``moe_router_ref``, over the JAX
sweep's shapes and one token, with the same numpy-seeded logits.  Index
sets must be equal and the weights, taken expert by expert, within
rtol 1e-5 / atol 1e-6 (the JAX sweep's tolerance); every row sums to 1.
Exact ties go to the lower expert index in all three, and so do
probabilities that underflow to 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_router import moe_router as jax_router
from repro.kernels.moe_router import moe_router_ref as jax_ref
from repro_torch.kernels.moe_router import moe_router, moe_router_ref
from test_kernels import ROUTER_SWEEP

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CASES = ROUTER_SWEEP + [(1, 128, 8), (1, 8, 2)]


def _logits(seed, shape, dtype):
    """Rounded to ``dtype`` once, then handed to both sides."""
    jdt, tdt = DTYPES[dtype]
    a = np.random.default_rng(seed).standard_normal(shape, np.float32)
    a = np.asarray(jnp.asarray(a, jdt), np.float32)
    return jnp.asarray(a, jdt), torch.tensor(a, dtype=tdt)


def _by_expert(w, idx):
    """Each row's (weights, indices) sorted by expert index."""
    w, idx = np.asarray(w, np.float32), np.asarray(idx)
    order = np.argsort(idx, axis=-1)
    return (np.take_along_axis(w, order, -1),
            np.take_along_axis(idx, order, -1))


def _same_routing(got, want):
    gw, gi = _by_expert(*got)
    ww, wi = _by_expert(*want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gw, ww, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t,e,k", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_router_matches_jax(t, e, k, dtype):
    jl, tl = _logits(t + e + k, (t, e), dtype)
    w, idx = moe_router(tl, k)
    assert (w.dtype, idx.dtype) == (torch.float32, torch.int32)
    assert w.shape == idx.shape == (t, k)
    assert moe_router.launches == 0          # CPU tensors never launch
    got = (w.numpy(), idx.numpy())
    for want in (jax_router(jl, k), jax_ref(jl, k)):     # Pallas, oracle
        _same_routing(got, want)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert (np.diff(got[0], axis=-1) <= 0).all()          # descending
    assert all(len(set(row)) == k for row in got[1])


def test_exact_ties_take_the_lower_index():
    rows = np.zeros((4, 16), np.float32)         # row 0: all tied
    rows[1, [5, 9, 12]] = 2.0                    # three tied maxima
    rows[2, 2], rows[2, [7, 1]] = 3.0, 2.0       # a tie across the k cut
    rows[3] = np.arange(16) % 4                  # four groups of ties
    want = np.array([[0, 1, 2, 3], [5, 9, 12, 0], [2, 1, 7, 0],
                     [3, 7, 11, 15]])
    for dtype in DTYPES:
        jl = jnp.asarray(rows, DTYPES[dtype][0])
        tl = torch.tensor(rows, dtype=DTYPES[dtype][1])
        for w, idx in (moe_router(tl, 4), moe_router_ref(tl, 4),
                       jax_router(jl, 4), jax_ref(jl, 4)):
            np.testing.assert_array_equal(np.asarray(idx), want)
            np.testing.assert_allclose(np.asarray(w).sum(-1), 1.0,
                                       rtol=1e-6)
        np.testing.assert_allclose(moe_router(tl, 4)[0].numpy(),
                                   np.asarray(jax_router(jl, 4)[0]),
                                   rtol=1e-6, atol=1e-7)


def _underflow_rows():
    """Rows whose probabilities underflow to 0 past a few experts, and the
    routing the reference gives them at k = 8: after the nonzero ones, the
    lowest unchosen indices among the zeros."""
    rows = np.full((4, 128), -200.0, np.float32)
    rows[0, 5] = 0.0                           # one nonzero p
    rows[1, [70, 3]] = 0.0                     # two, tied
    rows[2, [9, 100, 127]] = [0.0, -1.0, -2.0]
    rows[3] = -300.0                           # p = 1 at 64, 0 elsewhere
    rows[3, 64] = 0.0
    want = np.array([[5, 0, 1, 2, 3, 4, 6, 7], [3, 70, 0, 1, 2, 4, 5, 6],
                     [9, 100, 127, 0, 1, 2, 3, 4],
                     [64, 0, 1, 2, 3, 4, 5, 6]])
    return rows, want


@pytest.mark.parametrize("k", [8, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_underflowed_zeros_take_the_lowest_unchosen_index(dtype, k):
    rows, want = _underflow_rows()
    jl = jnp.asarray(rows, DTYPES[dtype][0])
    tl = torch.tensor(rows, dtype=DTYPES[dtype][1])
    results = (moe_router(tl, k), moe_router_ref(tl, k), jax_router(jl, k),
               jax_ref(jl, k))
    for w, idx in results:
        np.testing.assert_array_equal(np.asarray(idx), want[:, :k])
        np.testing.assert_allclose(np.asarray(w).sum(-1), 1.0, rtol=1e-6)
    for w, _ in results[1:]:
        np.testing.assert_allclose(results[0][0].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,k", [((8,), 2), ((2, 3, 8), 2),
                                     ((4, 8), 0), ((4, 8), 9),
                                     ((4, 513), 8)])
def test_wrapper_refuses_shapes_the_kernel_does_not_take(shape, k):
    with pytest.raises(ValueError):
        moe_router(torch.zeros(shape), k)


def test_wrapper_refuses_non_contiguous_and_integer_logits():
    with pytest.raises(ValueError, match="contiguous"):
        moe_router(torch.zeros(16, 8).t(), 2)
    with pytest.raises(TypeError):
        moe_router(torch.zeros(4, 8, dtype=torch.int32), 2)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for t, e, k in CASES + [(3000, 128, 8)]:
        logits = torch.randn(t, e, generator=torch.Generator().manual_seed(t))
        logits = logits.cuda()
        before = moe_router.launches
        got = moe_router(logits, k)
        torch.cuda.synchronize()
        assert moe_router.launches == before + 1
        want = moe_router_ref(logits, k)
        _same_routing(tuple(a.cpu() for a in got),
                      tuple(a.cpu() for a in want))
