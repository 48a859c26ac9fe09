"""On-card tests of the port: the CUDA kernels against their plain
versions, and the decision step's launches.  They need an NVIDIA Hopper
card and ``nvcc`` and skip elsewhere; run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed."""
import numpy as np
import pytest
import torch

from repro_torch.core.predictor import StragglerPredictor
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("bsz,nin,hid", [(1, 32, 32), (130, 32, 32),
                                         (256, 32, 32), (64, 128, 64)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_lstm_cell_kernel_matches_plain_version(cuda, bsz, nin, hid, dtype,
                                                atol):
    g = torch.Generator().manual_seed(bsz)
    args = [torch.randn(s, generator=g) * k for s, k in (
        ((bsz, nin), 1.0), ((bsz, hid), 1.0), ((bsz, hid), 1.0),
        ((nin, 4 * hid), 0.2), ((hid, 4 * hid), 0.2), ((4 * hid,), 0.1))]
    args = [a.to(cuda, dtype) for a in args]
    before = lstm_cell.launches
    got = lstm_cell(*args)
    torch.cuda.synchronize()
    assert lstm_cell.launches == before + 1
    for g_, w in zip(got, lstm_cell_ref(*args)):
        torch.testing.assert_close(g_.float(), w.float(), rtol=atol,
                                   atol=atol)


def test_fused_interval_launches_the_kernel_for_every_cell(cuda):
    pred = StragglerPredictor(n_hosts=8, max_tasks=4, device=cuda)
    ref = StragglerPredictor(n_hosts=8, max_tasks=4, device="cpu")
    rng = np.random.default_rng(0)
    for n in (1, 5, 16):
        row = rng.uniform(0, 1, (8, 11)).astype(np.float32)
        pred.push_host_row(row)
        ref.push_host_row(row)
        mt = rng.uniform(0, 1, (n, 4, 5)).astype(np.float32)
        q = np.full(n, 4.0, np.float32)
        before = lstm_cell.launches
        got = pred.predict_interval(mt, q)
        assert lstm_cell.launches == before + 2 * pred.horizon
        np.testing.assert_allclose(got, ref.predict_interval(mt, q),
                                   rtol=1e-5, atol=1e-6)
