"""On-card tests of the port: the CUDA kernels against their plain
versions, the decision step's launches, and a reduced LM served on the
card against the same model on the CPU.  They need an NVIDIA Hopper
card and ``nvcc`` and skip elsewhere; run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core.predictor import StragglerPredictor
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention)
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_ref
from repro_torch.models.lm import Model
from repro_torch.serve.engine import Engine, EngineConfig, Request

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


def _qkv(shapes, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(device, dtype) for s in shapes]


@pytest.mark.parametrize("b,h,hkv,s,d,causal", [
    (1, 4, 4, 128, 64, True), (2, 8, 1, 128, 128, True),
    (1, 2, 2, 192, 64, False), (1, 4, 2, 100, 128, True),
    (1, 4, 2, 37, 16, True), (1, 32, 4, 300, 128, True)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_matches_plain_version(cuda, b, h, hkv, s, d,
                                                      causal, dtype, atol):
    q, k, v = _qkv([(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)], dtype,
                   s + d, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, causal=causal).float(),
                               rtol=atol, atol=atol)


@pytest.mark.parametrize("b,h,hkv,s,d,kvlen", [
    (1, 4, 4, 512, 64, 512), (2, 8, 2, 1024, 128, 700),
    (1, 16, 2, 512, 128, 512), (1, 4, 1, 300, 64, 300),
    (1, 32, 4, 4096, 128, 1), (1, 32, 4, 4096, 128, 513),
    (1, 4, 2, 40, 16, 17)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_decode_attention_kernel_matches_plain_version(cuda, b, h, hkv, s,
                                                       d, kvlen, dtype,
                                                       atol):
    q, k, v = _qkv([(b, h, d), (b, hkv, s, d), (b, hkv, s, d)], dtype,
                   s + kvlen, cuda)
    want = decode_attention_ref(q, k, v, kv_len=kvlen)
    k[:, :, kvlen:] = float("nan")       # never read
    v[:, :, kvlen:] = float("nan")
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_len=kvlen)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    torch.testing.assert_close(got.float(), want.float(), rtol=atol,
                               atol=atol)


def test_reduced_engine_on_the_card_matches_the_cpu(cuda):
    cfg = dataclasses.replace(get_reduced("yi-6b"), param_dtype="float32")
    params = Model(cfg).init(0, "cpu")
    streams, launches = [], []
    for dev in ("cpu", cuda):
        eng = Engine(Model(cfg), convert.tree_map(lambda t: t.to(dev),
                                                  params),
                     EngineConfig(n_slots=2, max_len=64))
        rng = np.random.default_rng(0)
        for i in range(4):
            eng.submit(Request(req_id=i, tokens=rng.integers(0, cfg.vocab,
                                                             5 + 7 * i),
                               max_new=6))
        f0, d0 = flash_attention.launches, decode_attention.launches
        streams.append({r.req_id: r.out for r in eng.run()})
        launches.append((flash_attention.launches - f0,
                         decode_attention.launches - d0))
    assert streams[0] == streams[1]
    assert launches[0] == (0, 0)
    # one flash launch per layer per prefill, two decode launches per
    # layer per decoded token (5 of the 6 tokens of each request)
    assert launches[1] == (4 * cfg.n_layers, 4 * 5 * 2 * cfg.n_layers)
