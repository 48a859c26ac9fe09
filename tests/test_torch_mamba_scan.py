"""The port's selective scan on the CPU (its plain versions, reached
through the kernels' wrapper and its ``torch.autograd.Function``)
against the JAX package's ``mamba_scan_ref``, on the same numpy-seeded
inputs.

The JAX Pallas kernel cannot run on this jax (its ``pl.load`` is gone),
so the oracle is its reference, as ROADMAP.md Queue 3 says.  Forward:
``MAMBA_SWEEP`` of ``tests/test_kernels.py`` plus ragged shapes, fp32
within the sweep's 1e-4 (observed <= 1e-6: only exp and the order of the
N-sum differ) and bf16 within its 5e-2.  Backward: the plain version of
the backward kernel (``mamba_scan_bwd_ref``: chunk states, each chunk
stepped again, then swept in reverse) against ``jax.vjp`` of the
reference at the same shapes and at chunk lengths that do and do not
divide L, fp32 relative 1e-5 in norm (observed <= 3e-7: the sums run in
another order) and bf16 within the sweep's 5e-2; and against autograd of
the port's plain scan.  Gradients of all six inputs through the Function
against ``jax.vjp``, fp32, relative 1e-4 in norm.  The serving variant
(``mamba_scan_with_state``, y and the final state) against the JAX
package's ``_scan_with_state`` (the SSM prefill's scan) in the sweep's
tolerances, the final state fp32 within 1e-5 (observed <= 1e-6).  The
kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_ref
from repro.models.mamba import _scan_with_state as jax_with_state
from repro_torch.kernels.mamba_scan import (CHUNK, mamba_scan,
                                            mamba_scan_bwd_ref,
                                            mamba_scan_ref,
                                            mamba_scan_with_state,
                                            mamba_scan_with_state_ref,
                                            scan_states_ref)

# (b, l, d, n): tests/test_kernels.py MAMBA_SWEEP, then ragged shapes
MAMBA_SWEEP = [(1, 64, 128, 16), (2, 128, 64, 16), (1, 96, 256, 8)]
RAGGED = [(3, 77, 200, 5), (1, 1, 3, 1)]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run thousands of tiny ops, which
    threads do not speed up, and beside the suite's parallel workers
    extra threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, l, d, n, seed):
    """u, delta (softplus of a normal), a = -exp(normal), b, c, skip: the
    JAX sweep's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, l, d)).astype(np.float32)
    delta = np.logaddexp(rng.standard_normal((b, l, d)), 0).astype(
        np.float32)
    a = -np.exp(rng.standard_normal((d, n))).astype(np.float32)
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    skip = rng.standard_normal(d).astype(np.float32)
    return u, delta, a, bm, cm, skip


def _both(args, dtype):
    """The inputs for JAX and for the port: u, delta, b, c in ``dtype``
    (both round to nearest even), a and skip fp32."""
    io = (0, 1, 3, 4)
    jx = [jnp.asarray(x, dtype if i in io else "float32")
          for i, x in enumerate(args)]
    tx = [torch.tensor(x).to(getattr(torch, dtype) if i in io
                             else torch.float32)
          for i, x in enumerate(args)]
    return jx, tx


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,l,d,n", MAMBA_SWEEP + RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_matches_jax_reference(b, l, d, n, dtype):
    jx, tx = _both(_inputs(b, l, d, n, seed=b * l + d), dtype)
    want = _np(jax_ref(*jx))
    got = mamba_scan(*tx)
    assert got.dtype == tx[0].dtype and got.shape == (b, l, d)
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    # on the CPU the wrapper is the plain version, bit for bit
    assert torch.equal(got, mamba_scan_ref(*tx))


def test_plain_scan_takes_an_initial_state():
    args = _inputs(2, 9, 16, 4, seed=7)
    h0 = np.random.default_rng(8).standard_normal((2, 16, 4)).astype(
        np.float32)
    jx, tx = _both(args, "float32")
    want = _np(jax_ref(*jx, h0=jnp.asarray(h0)))
    np.testing.assert_allclose(_np(mamba_scan_ref(*tx, h0=torch.tensor(h0))),
                               want, **TOL["float32"])


def test_chunk_states_restart_the_plain_scan():
    """Each kept state, as h0 of the plain scan over the rest of the
    sequence, gives the same y bit for bit."""
    _, tx = _both(_inputs(2, 45, 24, 6, seed=9), "float32")
    u, delta, a, b, c, skip = tx
    states = scan_states_ref(u, delta, a, b, chunk=10)
    assert states.shape == (2, 5, 24, 6) and not states[:, 0].any()
    y = mamba_scan_ref(*tx)
    for k in range(1, 5):
        t0 = 10 * k
        rest = mamba_scan_ref(u[:, t0:], delta[:, t0:], a, b[:, t0:],
                              c[:, t0:], skip, h0=states[:, k])
        assert torch.equal(rest, y[:, t0:])


def _gradient_inputs(b, l, d, n, dtype, seed):
    args = _inputs(b, l, d, n, seed=seed)
    g = np.random.default_rng(seed + 1).standard_normal((b, l, d)).astype(
        np.float32)
    jx, tx = _both(args, dtype)
    return jx, tx, jnp.asarray(g, dtype), torch.tensor(g).to(
        getattr(torch, dtype))


def _within_norm(got, want, rel, names=("u", "delta", "a", "b", "c",
                                         "skip")):
    for name, gt, w in zip(names, got, want):
        gt, w = _np(gt).astype(np.float64), _np(w).astype(np.float64)
        err = np.linalg.norm(gt - w)
        assert err <= rel * np.linalg.norm(w), (name, err)


@pytest.mark.parametrize("b,l,d,n", MAMBA_SWEEP + RAGGED)
@pytest.mark.parametrize("chunk", [7, CHUNK])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(b, l, d, n, chunk, dtype):
    """All six gradients of the plain backward against ``jax.vjp`` of the
    JAX reference, in the inputs' dtypes.  Chunks of 7 divide L = 77 and
    not 64, 96 or 128; chunks of 32 the reverse."""
    jx, tx, jg, tg = _gradient_inputs(b, l, d, n, dtype, seed=b * l + d)
    _, vjp = jax.vjp(jax_ref, *jx)
    want = vjp(jg)
    got = mamba_scan_bwd_ref(*tx, tg, chunk=chunk)
    assert [t.dtype for t in got] == [t.dtype for t in tx]
    if dtype == "float32":
        _within_norm(got, want, 1e-5)
    else:
        for gt, w in zip(got, want):
            np.testing.assert_allclose(_np(gt), _np(w), **TOL[dtype])


@pytest.mark.parametrize("b,l,d,n,chunk", [(2, 40, 24, 6, 8),
                                           (1, 33, 16, 16, 32),
                                           (3, 5, 8, 3, 2)])
def test_plain_backward_matches_autograd_of_the_plain_scan(b, l, d, n,
                                                           chunk):
    _, tx, _, tg = _gradient_inputs(b, l, d, n, "float32", seed=l)
    xs = [t.clone().requires_grad_() for t in tx]
    want = torch.autograd.grad(mamba_scan_ref(*xs), xs, tg)
    states = scan_states_ref(*tx[:4], chunk=chunk)
    _within_norm(mamba_scan_bwd_ref(*tx, tg, states, chunk=chunk), want,
                 1e-5)


def test_function_backward_on_the_cpu_is_the_plain_backward():
    _, tx, _, tg = _gradient_inputs(2, 40, 24, 6, "float32", seed=11)
    xs = [t.clone().requires_grad_() for t in tx]
    got = torch.autograd.grad(mamba_scan(*xs), xs, tg)
    for gt, w in zip(got, mamba_scan_bwd_ref(*tx, tg)):
        assert torch.equal(gt, w)


@pytest.mark.parametrize("b,l,d,n", [(1, 32, 64, 8), (2, 17, 40, 16)])
def test_function_gradients_match_jax_vjp(b, l, d, n):
    """All six gradients of the autograd Function against ``jax.vjp`` of
    the reference, fp32, relative 1e-4 in norm."""
    args = _inputs(b, l, d, n, seed=l)
    g = np.random.default_rng(l + 1).standard_normal((b, l, d)).astype(
        np.float32)
    jx, tx = _both(args, "float32")
    _, vjp = jax.vjp(jax_ref, *jx)
    want = vjp(jnp.asarray(g))
    tx = [t.requires_grad_() for t in tx]
    got = torch.autograd.grad(mamba_scan(*tx), tx, torch.tensor(g))
    for name, gt, w in zip(("u", "delta", "a", "b", "c", "skip"), got, want):
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(_np(gt) - w) / np.linalg.norm(w)
        assert err <= 1e-4, (name, err)
        assert gt.dtype == torch.float32


def test_function_gradients_keep_the_input_dtypes():
    args = _inputs(1, 8, 16, 4, seed=3)
    _, tx = _both(args, "bfloat16")
    tx = [t.requires_grad_() for t in tx]
    y = mamba_scan(*tx)
    got = torch.autograd.grad(y.float().sum(), tx)
    assert [t.dtype for t in got] == [t.dtype for t in tx]
    assert all(torch.isfinite(t.float()).all() for t in got)


def test_only_the_inputs_asked_for_get_gradients():
    _, tx = _both(_inputs(1, 8, 16, 4, seed=4), "float32")
    u = tx[0].requires_grad_()
    (gu,) = torch.autograd.grad(mamba_scan(u, *tx[1:]).sum(), [u])
    assert gu.shape == u.shape


def test_wrapper_refuses_what_it_does_not_take():
    _, tx = _both(_inputs(1, 8, 16, 4, seed=5), "float32")
    u, delta, a, b, c, skip = tx
    before = mamba_scan.launches
    with pytest.raises(ValueError, match="shapes"):
        mamba_scan(u, delta, a, b[:, :4], c, skip)
    with pytest.raises(ValueError, match="shapes"):
        mamba_scan(u, delta, a, b, c, skip[:3])
    with pytest.raises(ValueError):
        mamba_scan(u[0], delta, a, b, c, skip)
    with pytest.raises(TypeError):
        mamba_scan(u, delta.to(torch.int32), a, b, c, skip)
    meta = [t.to("meta") for t in tx]
    with pytest.raises(ValueError, match="no kernel"):
        mamba_scan(*meta)
    with pytest.raises(ValueError, match="different devices"):
        mamba_scan(meta[0], *tx[1:])
    assert mamba_scan.launches == before


@pytest.mark.parametrize("b,l,d,n", MAMBA_SWEEP + RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_with_state_matches_jax_scan_with_state(b, l, d, n, dtype):
    """The plain serving variant (which the wrapper runs on the CPU)
    against the JAX prefill's ``_scan_with_state``: y in the sweep's
    tolerance, the final state (fp32 in both) within 1e-5; its y is the
    plain scan's bit for bit."""
    jx, tx = _both(_inputs(b, l, d, n, seed=b + l * d), dtype)
    jy, jh = jax_with_state(*jx)
    y, h = mamba_scan_with_state(*tx)
    assert y.dtype == tx[0].dtype and y.shape == (b, l, d)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype])
    np.testing.assert_allclose(_np(h), _np(jh), rtol=1e-5, atol=1e-5)
    assert torch.equal(y, mamba_scan_ref(*tx))
    y2, h2 = mamba_scan_with_state_ref(*tx)
    assert torch.equal(y2, y) and torch.equal(h2, h)


def test_scan_with_state_continues_from_its_final_state():
    """The final state of the first part, as h0 of the plain scan over
    the rest, gives the whole sequence's y bit for bit."""
    _, tx = _both(_inputs(2, 40, 24, 6, seed=11), "float32")
    y, _ = mamba_scan_with_state(*tx)
    first = [t[:, :25] if t.dim() == 3 else t for t in tx]
    rest = [t[:, 25:] if t.dim() == 3 else t for t in tx]
    _, h = mamba_scan_with_state(*first)
    assert torch.equal(mamba_scan_ref(*rest, h0=h), y[:, 25:])
    empty = [t[:, :0] if t.dim() == 3 else t for t in tx]
    y0, h0 = mamba_scan_with_state(*empty)
    assert y0.shape == (2, 0, 24) and not h0.any()


def test_scan_with_state_is_inference_only():
    _, tx = _both(_inputs(1, 8, 16, 4, seed=12), "float32")
    before = mamba_scan.launches
    with pytest.raises(ValueError, match="inference-only"):
        mamba_scan_with_state(tx[0].requires_grad_(), *tx[1:])
    with pytest.raises(ValueError, match="shapes"):
        mamba_scan_with_state(tx[0].detach(), tx[1], tx[2], tx[3][:, :4],
                              tx[4], tx[5])
    assert mamba_scan.launches == before
    assert mamba_scan_with_state.launches == 0    # CPU calls never launch
