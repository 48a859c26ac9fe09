"""The port's LSTM cell wrapper on the CPU (its plain version) against the
JAX package's fused Pallas cell (interpret mode, as tests/test_kernels.py
runs it) and its jnp oracle, plus the wrapper's input checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell import lstm_cell as jax_lstm_cell
from repro.kernels.lstm_cell import lstm_cell_ref as jax_lstm_cell_ref
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_ref
from test_kernels import LSTM_SWEEP

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype: str) -> dict:
    # tests/test_kernels.py's sweep tolerances
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(bsz, nin, hid, seed=6):
    rng = np.random.default_rng(seed)
    scale = (1.0, 1.0, 1.0, 0.2, 0.2, 0.1)
    shapes = ((bsz, nin), (bsz, hid), (bsz, hid), (nin, 4 * hid),
              (hid, 4 * hid), (4 * hid,))
    return [(rng.standard_normal(s) * k).astype(np.float32)
            for s, k in zip(shapes, scale)]


@pytest.mark.parametrize("bsz,nin,hid", LSTM_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cell_matches_jax_pallas_cell_and_oracle(bsz, nin, hid, dtype):
    jd, td = DTYPES[dtype]
    arrs = _inputs(bsz, nin, hid)
    before = lstm_cell.launches
    got = lstm_cell(*(torch.from_numpy(a).to(td) for a in arrs))
    assert lstm_cell.launches == before       # CPU tensors launch nothing
    assert all(g.dtype == td and g.shape == (bsz, hid) for g in got)
    j_args = [jnp.asarray(a, jd) for a in arrs]
    for want in (jax_lstm_cell(*j_args), jax_lstm_cell_ref(*j_args)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       **tol(dtype))


def test_plain_version_is_fp32_math_with_io_dtype():
    arrs = [torch.from_numpy(a) for a in _inputs(8, 32, 32)]
    h32, c32 = lstm_cell_ref(*arrs)
    h16, c16 = lstm_cell_ref(*(a.to(torch.bfloat16) for a in arrs))
    assert h16.dtype == torch.bfloat16 and c16.dtype == torch.bfloat16
    np.testing.assert_allclose(h16.float().numpy(), h32.numpy(),
                               rtol=2e-2, atol=2e-2)


def _bad(kind):
    args = [torch.from_numpy(a) for a in _inputs(4, 32, 32)]
    if kind == "shape":
        args[4] = args[4][:, :64]
    elif kind == "bias":
        args[5] = args[5][:64]
    elif kind == "dtype":
        args[1] = args[1].double()
    elif kind == "float64":
        args = [a.double() for a in args]
    elif kind == "contiguous":
        args[3] = args[3].t().contiguous().t()
    elif kind == "meta":
        args = [a.to("meta") for a in args]
    return args


@pytest.mark.parametrize("kind,exc", [
    ("shape", ValueError), ("bias", ValueError),
    ("dtype", TypeError), ("float64", TypeError),
    ("contiguous", ValueError), ("meta", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind, exc):
    with pytest.raises(exc):
        lstm_cell(*_bad(kind))


def test_empty_batch_returns_empty_outputs():
    args = [torch.from_numpy(a) for a in _inputs(0, 32, 32)]
    h, c = lstm_cell(*args)
    assert h.shape == (0, 32) and c.shape == (0, 32)


@pytest.mark.parametrize("elem", [4, 2])
def test_kernel_geometry_takes_the_path_and_sweep_shapes_only(elem):
    """A block of the kernel takes 8 hidden units and 8 batch rows and
    stages its (In + H + 1) x 32 slice of the weights and the bias and its
    rows of x and h in shared memory (at most 227 KB): the path's and the
    JAX sweep's shapes fit in both dtypes, and so does H that is no
    multiple of 8; a slice past 227 KB does not."""
    from repro_torch.kernels.lstm_cell import ops
    for _, nin, hid in LSTM_SWEEP + [(1, 32, 32), (16, 32, 32),
                                     (256, 32, 32), (8, 32, 257)]:
        ops._check_launch(nin, hid, elem)
    for nin, hid in [(32, 3000), (4000, 32), (2500, 2500)]:
        with pytest.raises(ValueError):
            ops._check_launch(nin, hid, elem)
    # fp32 elements take twice the room of bf16 ones
    assert ops.smem_bytes(1400, 128, 4) > ops._SMEM_BYTES \
        >= ops.smem_bytes(1400, 128, 2)
