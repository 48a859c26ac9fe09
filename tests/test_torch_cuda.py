"""On-card tests of the port: the CUDA kernels against their plain
versions (the flash and router autograd Functions' gradients and the
scan's serving variant too), the decision step's launches, START's
training through the cell's kernel and a START simulation on the card
against the CPU,
reduced LMs (dense, vlm, MoE with GQA or MLA, SSM, hybrid and
encoder-decoder) served on the card against the same model on the CPU,
reduced LMs of each family trained on the card against the CPU, IGRU-SD's
GRU on the card against the CPU, a 2-worker sweep on the card
against the serial run, the prediction service on the card against its
CPU twin and over TCP, the trainer's checkpoint drill, the pod
runtime's online Encoder-LSTM policy at 400 hosts against its CPU twin,
START's captured programs (CUDA graphs) and the trainer's captured step
against their eager runs.  They
need an NVIDIA Hopper card and ``nvcc`` and skip elsewhere; run them on
the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed."""
import dataclasses
import pickle
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import encoder_lstm as net
from repro_torch.core.predictor import StragglerPredictor
from repro_torch.core.start import STARTController
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import (
    BF16_EXCESS, bf16_rounding_excess, decode_attention_split_ref)
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_ref
from repro_torch.kernels.mamba_scan import (mamba_scan, mamba_scan_bwd,
                                            mamba_scan_bwd_ref,
                                            mamba_scan_ref,
                                            mamba_scan_with_state,
                                            mamba_scan_with_state_ref,
                                            scan_states_ref)
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.moe_router import moe_router, moe_router_ref
from repro_torch.launch import train as train_entry
from repro_torch.models.lm import Model
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.serve.kv_cache import pad_to_length
from repro_torch.service import (PredictionService, Profile, ServiceConfig,
                                 ServiceDaemon)
from repro_torch.sim import scenarios, sweep
from repro_torch.sim.engine import Simulation
from repro_torch.sim.techniques import baselines, start_tech
from repro_torch.train import optimizer as Opt
from repro_torch.train.checkpoint import VersionStore
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cell_args(bsz, nin, hid, dtype, device):
    g = torch.Generator().manual_seed(bsz)
    args = [torch.randn(s, generator=g) * k for s, k in (
        ((bsz, nin), 1.0), ((bsz, hid), 1.0), ((bsz, hid), 1.0),
        ((nin, 4 * hid), 0.2), ((hid, 4 * hid), 0.2), ((4 * hid,), 0.1))]
    return [a.to(device, dtype) for a in args]


# fp32: 1e-5 absolute, the products' sums in another order than the plain
# version's matmul (observed <= 8e-7); bf16: outputs within a bf16 ulp of
# the plain version's rounding of the same fp32 math, 2e-2 (the JAX sweep's)
CELL_TOL = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


# the path's job buckets (1, 16, 256), a ragged batch (7), the JAX sweep's
# shapes (8, 130 at In = H = 32; 64 at In = 128, H = 64)
@pytest.mark.parametrize("bsz,nin,hid", [(1, 32, 32), (7, 32, 32),
                                         (8, 32, 32), (16, 32, 32),
                                         (130, 32, 32), (256, 32, 32),
                                         (64, 128, 64)])
@pytest.mark.parametrize("dtype,atol", CELL_TOL)
def test_lstm_cell_kernel_matches_plain_version(cuda, bsz, nin, hid, dtype,
                                                atol):
    args = _cell_args(bsz, nin, hid, dtype, cuda)
    before = lstm_cell.launches
    got = lstm_cell(*args)
    torch.cuda.synchronize()
    assert lstm_cell.launches == before + 1
    for g_, w in zip(got, lstm_cell_ref(*args)):
        torch.testing.assert_close(g_.float(), w.float(), rtol=atol,
                                   atol=atol)


@pytest.mark.parametrize("bsz,nin,hid", [(33, 5, 7), (3, 11, 32),
                                         (9, 32, 257)])
@pytest.mark.parametrize("dtype,atol", CELL_TOL)
def test_lstm_cell_kernel_takes_unaligned_inputs(cuda, bsz, nin, hid, dtype,
                                                 atol):
    """H that is no multiple of 8, and every input a view one element past
    a 16-byte boundary: the weights load by plain loads, not 16-byte
    copies."""
    args = _cell_args(bsz, nin, hid, dtype, cuda)
    shifted = [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
               for t in args]
    assert all(t.data_ptr() % 16 for t in shifted)
    before = lstm_cell.launches
    for xs in (args, shifted):
        got = lstm_cell(*xs)
        torch.cuda.synchronize()
        for g_, w in zip(got, lstm_cell_ref(*args)):
            torch.testing.assert_close(g_.float(), w.float(), rtol=atol,
                                       atol=atol)
    assert lstm_cell.launches == before + 2


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


@pytest.mark.parametrize("bsz,nin,hid", [(1, 32, 32), (64, 32, 32),
                                         (33, 5, 7)])
@pytest.mark.parametrize("dtype,atol", CELL_TOL)
def test_lstm_cell_gradients_through_the_kernel(cuda, bsz, nin, hid, dtype,
                                                atol):
    """Inputs that require grad: the forward launches the kernel once
    inside the autograd Function, and the backward (the plain cell
    recomputed from the same inputs) gives autograd's gradients of the
    plain cell; the outputs of a call without grad carry no graph."""
    args = _cell_args(bsz, nin, hid, dtype, cuda)
    g = [torch.randn(bsz, hid, device=cuda).to(dtype) for _ in range(2)]
    grads = []
    for fn in (lstm_cell, lstm_cell_ref):
        xs = [t.clone().requires_grad_() for t in args]
        before = lstm_cell.launches
        outs = fn(*xs)
        torch.autograd.backward(outs, g)
        torch.cuda.synchronize()
        assert lstm_cell.launches == before + (fn is lstm_cell)
        grads.append([x.grad.float() for x in xs])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=atol, atol=atol)
    before = lstm_cell.launches
    with torch.no_grad():
        h, c = lstm_cell(*[t.clone().requires_grad_() for t in args])
    assert h.grad_fn is None and c.grad_fn is None
    assert lstm_cell.launches == before + 1


def _start_pair(n_hosts, max_tasks, cuda):
    """A controller on the card and one on the CPU with the same weights."""
    kw = dict(n_hosts=n_hosts, max_tasks=max_tasks, seed=0,
              beta_scale=300.0)
    dev = STARTController(device=cuda, **kw)
    cpu = STARTController(device="cpu", **kw)
    cpu.predictor.load_params(dev.predictor.params)
    return dev, cpu


def test_start_training_on_the_card_matches_the_cpu(cuda):
    """Three ``train_step``s of 64 on the card (10 cell launches each,
    through the kernel) and on the CPU from the same params: losses and
    params within 1e-5 relative."""
    dev, cpu = _start_pair(16, 10, cuda)
    rng = np.random.default_rng(0)
    dim = dev.predictor.input_dim
    xs = rng.uniform(0, 1, (5, 64, dim)).astype(np.float32)
    ys = np.stack([rng.uniform(1, 4, 64), rng.uniform(0.1, 3, 64)],
                  -1).astype(np.float32)
    out = {}
    for name, pred in (("cuda", dev.predictor), ("cpu", cpu.predictor)):
        x = torch.as_tensor(xs, device=pred.device)
        y = torch.as_tensor(ys, device=pred.device)
        params, opt, losses, launches = pred.params, pred.opt, [], []
        for _ in range(3):
            before = lstm_cell.launches
            params, opt, loss = net.train_step(params, opt, x, y, lr=1e-3)
            losses.append(float(loss))
            launches.append(lstm_cell.launches - before)
        out[name] = (losses, convert.to_numpy(params), launches)
    assert out["cuda"][2] == [10] * 3 and out["cpu"][2] == [0] * 3
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    rel, _ = chip_smoke.tree_rel(
        convert.from_jax(out["cuda"][1], "cpu"),
        convert.from_jax(out["cpu"][1], "cpu"))
    assert rel <= 1e-5


@pytest.mark.parametrize("cls", [start_tech.START, start_tech.STARTEager])
def test_start_simulation_on_the_card_matches_the_cpu(cuda, cls):
    """A short pretrain on the card, then the policy on the card and on
    the CPU in lockstep (``chip_smoke.lockstep``): E_S within the Tier-1
    bound, actions equal up to a boundary difference, 10 cell launches
    an interval that predicts."""
    ctrl = start_tech.pretrain(scenarios.make_config(
        "planetlab", seed=7, n_hosts=32, n_intervals=72), epochs=2,
        device=cuda)
    cfg = scenarios.make_config("overload", seed=1, n_hosts=32,
                                n_intervals=48)
    _, cpu = _start_pair(32, 10, cuda)
    cpu.predictor.load_params(ctrl.predictor.params)
    before = lstm_cell.launches
    r = chip_smoke.lockstep(Simulation(cfg, technique=cls(controller=ctrl)),
                            Simulation(cfg, technique=cls(controller=cpu)),
                            cfg.n_intervals)
    assert lstm_cell.launches - before == 10 * r["predicted"] > 0
    assert r["max_rel"] <= chip_smoke.TIER1_REL
    assert r["intervals"] >= cfg.n_intervals // 2


def _qkv(shapes, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(device, dtype) for s in shapes]


def _decode_fp32(q, k, v, kvlen):
    """The plain decode in fp32 on the same inputs: a bf16 output must be
    its rounding (bf16_rounding_excess <= BF16_EXCESS)."""
    return decode_attention_ref(q.float(), k.float(), v.float(),
                                kv_len=kvlen)


@pytest.mark.parametrize("b,h,hkv,s,d,causal", [
    (1, 4, 4, 128, 64, True), (2, 8, 1, 128, 128, True),
    (1, 2, 2, 192, 64, False), (1, 4, 2, 100, 128, True),
    (1, 4, 2, 37, 16, True), (1, 32, 4, 300, 128, True),
    # one tile of the bf16 kernel; each head dim at a ragged length; B = 2
    # non-causal GQA; yi-6b's longest prefill
    (1, 1, 1, 64, 128, True), (1, 4, 2, 100, 32, True),
    (1, 4, 2, 150, 64, True), (2, 8, 2, 200, 64, False),
    (1, 32, 4, 3000, 128, True),
    # the model paths' other GQA groups: 3 (minitron-4b, phi4-mini-3.8b),
    # 6 at internvl2-26b's 256 patches + 12 tokens (ragged keys), 8 at
    # H = 64 (deepseek-67b)
    (1, 24, 8, 300, 128, True), (1, 48, 8, 268, 128, True),
    (1, 64, 8, 300, 128, True)])
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


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", chip_smoke.FLASH_CROSS)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_at_the_encoder_decoders_shapes(
        cuda, b, h, hkv, sq, sk, d, causal, dtype, atol):
    """seamless-m4t-large-v2's non-causal attention: the decoder's
    cross-attention over 1024 frames at Sq = 1 (one live row of a query
    tile), 12, 300 and 3000, and the encoder's 1024 x 1024."""
    q, k, v = _qkv([(b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)], dtype,
                   sq + sk, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (b, h, sq, d)
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, causal=causal).float(),
                               rtol=atol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_takes_batch_heads_past_the_grid_limit(
        cuda, dtype):
    """B * H = 65600 > 65535: the fp32 kernel launches once per 65535
    rows of B * H on grid y, the bf16 one has B * H on x."""
    q, k, v = _qkv([(4100, 16, 20, 16), (4100, 4, 20, 16),
                    (4100, 4, 20, 16)], dtype, 5, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + (
        2 if dtype == torch.float32 else 1)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, causal=True).float(),
                               rtol=atol, atol=atol)


@pytest.mark.parametrize("sq,sk", [(100, 300), (300, 100), (1, 129)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_takes_unequal_query_and_key_lengths(
        cuda, sq, sk, causal, dtype, atol):
    q, k, v = _qkv([(1, 4, sq, 64), (1, 2, sk, 64), (1, 2, sk, 64)], dtype,
                   sq + sk, cuda)
    got = flash_attention(q, k, v, causal)
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, causal=causal).float(),
                               rtol=atol, atol=atol)


@pytest.mark.parametrize("b,h,hkv,s,d,kvlen", [
    (1, 4, 4, 512, 64, 512), (2, 8, 2, 1024, 128, 700),
    (1, 16, 2, 512, 128, 512), (1, 4, 1, 300, 64, 300),
    (1, 32, 4, 4096, 128, 1), (1, 32, 4, 4096, 128, 513),
    (1, 4, 2, 40, 16, 17), (1, 32, 4, 4096, 128, 28),
    (1, 32, 4, 4096, 128, 3016), (1, 32, 4, 4096, 128, 4096),
    (3, 32, 2, 100, 32, 77), (1, 64, 4, 600, 128, 600),
    # GQA groups 3, 6 and 8 at H = 64, as minitron-4b, internvl2-26b and
    # deepseek-67b decode
    (1, 24, 8, 4096, 128, 513), (1, 48, 8, 4096, 128, 3016),
    (1, 64, 8, 600, 128, 268),
    # H = Hkv = 16 at D = 64, as seamless-m4t-large-v2's decoder decodes
    *chip_smoke.DECODE_MHA])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_decode_attention_kernel_matches_plain_version(cuda, b, h, hkv, s,
                                                       d, kvlen, dtype,
                                                       atol):
    q, k, v = _qkv([(b, h, d), (b, hkv, s, d), (b, hkv, s, d)], dtype,
                   s + kvlen, cuda)
    want = decode_attention_ref(q, k, v, kv_len=kvlen)
    want32 = _decode_fp32(q, k, v, kvlen)
    k[:, :, kvlen:] = float("nan")       # never read
    v[:, :, kvlen:] = float("nan")
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_len=kvlen)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=atol,
                               atol=atol)
    if dtype == torch.bfloat16:
        assert bf16_rounding_excess(got, want32) <= BF16_EXCESS
    # one launch, no atomics: the same bits from run to run
    assert torch.equal(decode_attention(q, k, v, kv_len=kvlen), got)


@pytest.mark.parametrize("kvlen,n_splits,split_keys", [
    (100, 16, 8), (100, 4, 64), (1, 16, 8), (4096, 16, 256),
    (3016, 16, 192), (37, 3, 16), (600, 9, 72)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_decode_attention_kernel_takes_any_split(cuda, kvlen, n_splits,
                                                 split_keys, dtype, atol):
    """Forced splits, some with no valid key (they weigh 0), against the
    plain split-and-merge and the plain version."""
    q, k, v = _qkv([(1, 32, 128), (1, 4, 4096, 128), (1, 4, 4096, 128)],
                   dtype, kvlen + n_splits, cuda)
    want = decode_attention_ref(q, k, v, kv_len=kvlen)
    want32 = _decode_fp32(q, k, v, kvlen)
    split = decode_attention_split_ref(q.cpu(), k.cpu(), v.cpu(),
                                       kv_len=kvlen, n_splits=n_splits,
                                       split_keys=split_keys)
    k[:, :, kvlen:] = float("nan")
    v[:, :, kvlen:] = float("nan")
    got = torch.empty_like(q)
    decode_ops._launch(q, k, v, got, kvlen, None, n_splits, split_keys)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    for w in (want, split.to(cuda)):
        torch.testing.assert_close(got.float(), w.float(), rtol=atol,
                                   atol=atol)
    if dtype == torch.bfloat16:
        assert bf16_rounding_excess(got, want32) <= BF16_EXCESS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_takes_batch_heads_past_the_grid_limit(
        cuda, dtype):
    """B * Hkv = 66000 > 65535: two launches, one per 65535 rows on grid
    y."""
    q, k, v = _qkv([(33000, 4, 16), (33000, 2, 40, 16), (33000, 2, 40, 16)],
                   dtype, 6, cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_len=33)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        got.float(), decode_attention_ref(q, k, v, kv_len=33).float(),
        rtol=atol, atol=atol)
    if dtype == torch.bfloat16:
        assert bf16_rounding_excess(
            got, _decode_fp32(q, k, v, 33)) <= BF16_EXCESS


@pytest.mark.parametrize("t,e,k", [(256, 8, 2), (512, 128, 8),
                                   (300, 256, 8), (64, 16, 2), (1, 128, 8),
                                   (12, 128, 8), (3000, 128, 8),
                                   (5, 512, 32), (3, 40, 40),
                                   # jamba-1.5-large-398b's 16 experts
                                   *chip_smoke.ROUTER_JAMBA])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_router_kernel_matches_plain_version(cuda, t, e, k, dtype):
    g = torch.Generator().manual_seed(t + e)
    logits = torch.randn(t, e, generator=g).to(cuda, dtype)
    before = moe_router.launches
    w, idx = moe_router(logits, k)
    torch.cuda.synchronize()
    assert moe_router.launches == before + 1
    assert (w.dtype, idx.dtype, w.shape) == (torch.float32, torch.int32,
                                             (t, k))
    wr, ir = moe_router_ref(logits, k)
    # in order: the kernel picks as the stable sort does, ties included
    assert torch.equal(idx, ir)
    torch.testing.assert_close(w, wr, rtol=0.0, atol=1e-6)


def test_moe_router_kernel_takes_the_lower_index_on_ties(cuda):
    rows = torch.zeros(3, 128)
    rows[1, [5, 9, 100]] = 2.0
    rows[2] = torch.arange(128) % 4
    w, idx = moe_router(rows.to(cuda), 8)
    assert idx[0].tolist() == list(range(8))
    assert idx[1].tolist() == [5, 9, 100, 0, 1, 2, 3, 4]
    assert idx[2].tolist() == [3, 7, 11, 15, 19, 23, 27, 31]
    torch.testing.assert_close(w[0].cpu(), torch.full((8,), 0.125),
                               rtol=0.0, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_router_kernel_ranks_underflowed_zeros_by_index(cuda, dtype):
    """Probabilities that underflow to 0, with k above the number of
    nonzero ones: the lowest unchosen index among the zeros comes next, as
    in the plain version."""
    rows = torch.full((4, 128), -200.0)
    rows[0, 5] = 0.0                       # one nonzero p
    rows[1, [70, 3]] = 0.0                 # two, tied
    rows[2, [9, 100, 127]] = torch.tensor([0.0, -1.0, -2.0])
    rows[3, :] = -300.0                    # p = 1 at 64, 0 elsewhere
    rows[3, 64] = 0.0
    w, idx = moe_router(rows.to(cuda, dtype), 8)
    wr, ir = moe_router_ref(rows.to(cuda, dtype), 8)
    torch.cuda.synchronize()
    assert idx[0].tolist() == [5, 0, 1, 2, 3, 4, 6, 7]
    assert idx[1].tolist() == [3, 70, 0, 1, 2, 4, 5, 6]
    assert idx[2].tolist() == [9, 100, 127, 0, 1, 2, 3, 4]
    assert idx[3].tolist() == [64, 0, 1, 2, 3, 4, 5, 6]
    assert torch.equal(idx, ir)
    torch.testing.assert_close(w, wr, rtol=0.0, atol=1e-6)


def test_moe_router_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    before = moe_router.launches
    with pytest.raises(ValueError, match="contiguous"):
        moe_router(torch.zeros(128, 8, device=cuda).t(), 2)
    with pytest.raises(ValueError):
        moe_router(torch.zeros(4, 513, device=cuda), 8)
    with pytest.raises(ValueError):
        moe_router(torch.zeros(4, 8, device=cuda), 9)
    with pytest.raises(TypeError):
        moe_router(torch.zeros(4, 8, device=cuda, dtype=torch.float16), 2)
    assert moe_router.launches == before


def _bwd_within_bounds(got, want, dtype, q, k, v, g, causal):
    """The backward's bounds against a plain version's gradients
    ``want``: fp32 within chip_smoke.FLASH_BWD_REL relative in norm; bf16
    within ATTN_TOL elementwise and, in norm, within
    chip_smoke.FLASH_BWD_SDPA_FACTOR times SDPA's backward's own error
    (``enable_gqa``, the library's kernel) on the same inputs."""
    if dtype == torch.float32:
        bounds = [chip_smoke.FLASH_BWD_REL] * 3
    else:
        zs = [t.clone().requires_grad_() for t in (q, k, v)]
        lib = torch.autograd.grad(torch.nn.functional.
                                  scaled_dot_product_attention(
                                      *zs, is_causal=causal,
                                      enable_gqa=True), zs, g)
        bounds = [chip_smoke.FLASH_BWD_SDPA_FACTOR * chip_smoke._norm_rel(
            c, w) for c, w in zip(lib, want)]
    for x, gt, w, bound in zip((q, k, v), got, want, bounds):
        assert gt.dtype == x.dtype and gt.shape == x.shape
        assert torch.isfinite(gt.float()).all()
        if dtype == torch.bfloat16:
            torch.testing.assert_close(gt.float(), w.float(),
                                       **chip_smoke.ATTN_TOL[dtype])
        assert chip_smoke._norm_rel(gt, w) <= bound


@pytest.mark.parametrize("b,h,hkv,s,d,causal", [
    (1, 4, 4, 128, 64, True), (2, 8, 2, 100, 128, True),
    (1, 4, 2, 77, 32, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradients_through_the_function(cuda, b, h, hkv, s,
                                                        d, causal, dtype):
    """Through the Function: the kernel forward once, the backward kernel
    once (its three launches) and nothing else, the gradients in the
    inputs' dtypes and within the backward's bounds of autograd through
    the plain version."""
    q, k, v = _qkv(((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)), dtype,
                   s + d, cuda)
    g = torch.randn(b, h, s, d, generator=torch.Generator().manual_seed(s)
                    ).to(cuda, dtype)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*xs, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches - before[0] == 1
    assert flash_attention_bwd.launches == before[1]
    got = torch.autograd.grad(out, xs, g)
    torch.cuda.synchronize()
    assert flash_attention.launches - before[0] == 1
    assert flash_attention_bwd.launches - before[1] == \
        flash_ops.BWD_LAUNCHES_PER_CALL
    want = torch.autograd.grad(attention_ref(*ys, causal=causal), ys, g)
    _bwd_within_bounds(got, want, dtype, q, k, v, g, causal)


def _bwd_inputs(b, h, hkv, sq, sk, d, causal, dtype, seed, device):
    """q, k, v, the forward kernel's o and lse, and an output gradient."""
    q, k, v, g = _qkv([(b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                       (b, h, sq, d)], dtype, seed, device)
    o, lse = flash_ops._forward(q, k, v, causal, None, with_lse=True)
    return q, k, v, o, lse, g


# every head dim, the registry's GQA groups (1; 3: minitron-4b, phi4-mini;
# 6: internvl2-26b; 8: yi-6b, qwen3, deepseek-67b), one tile, ragged
# query and key edges, Sq != Sk both ways (causal keys past Sq get no
# gradient), seamless's cross-attention over its 1024 frames, one query
# row over 129 keys (non-causal: a causal row of one key has dS = 0 up
# to rounding, no gradient to hold in norm); the bf16 passes' 128-row
# blocks of two 64-row warpgroups: S = 65 (the second warpgroup holds
# one row or key and 63 past the edge), 1.5 blocks, causal Sq != Sk on
# 128-row boundaries both ways, D = 16 and 32 over two blocks
BWD_SHAPES = [(1, 1, 1, 64, 64, 16, False), (1, 4, 2, 100, 100, 16, True),
              (2, 6, 2, 77, 77, 32, True), (1, 4, 4, 130, 130, 32, False),
              (1, 6, 1, 150, 150, 64, True), (2, 8, 1, 40, 200, 64, False),
              (1, 16, 16, 12, 1024, 64, False), (1, 2, 2, 1, 129, 64, False),
              (1, 24, 8, 300, 300, 128, True),
              (1, 48, 8, 268, 268, 128, True),
              (1, 32, 4, 256, 256, 128, True), (1, 4, 2, 100, 300, 128, True),
              (1, 4, 2, 300, 100, 128, True),
              (1, 4, 2, 300, 100, 128, False),
              (1, 4, 2, 65, 65, 128, True), (1, 4, 2, 65, 65, 128, False),
              (1, 8, 2, 192, 192, 128, True), (1, 4, 2, 128, 320, 128, True),
              (1, 4, 2, 320, 128, 128, True), (1, 4, 2, 256, 256, 16, True),
              (1, 4, 2, 256, 256, 32, True)]


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain_version(
        cuda, b, h, hkv, sq, sk, d, causal, dtype):
    """The backward kernel against ``flash_attention_bwd_ref`` on the
    same o and lse, within the backward's bounds; one call, three
    launches."""
    q, k, v, o, lse, g = _bwd_inputs(b, h, hkv, sq, sk, d, causal, dtype,
                                     sq + sk + d, cuda)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, g, causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + \
        flash_ops.BWD_LAUNCHES_PER_CALL
    want = flash_attention_bwd_ref(q, k, v, o, lse, g, causal)
    _bwd_within_bounds(got, want, dtype, q, k, v, g, causal)


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (1, 4, 2, 100, 100, 16, True), (2, 24, 8, 300, 300, 128, True),
    (1, 16, 16, 300, 1024, 64, False), (1, 32, 4, 512, 512, 128, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_is_deterministic(cuda, b, h, hkv, sq,
                                                     sk, d, causal, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    args = _bwd_inputs(b, h, hkv, sq, sk, d, causal, dtype, 3, cuda)
    first = flash_attention_bwd(*args, causal)
    second = flash_attention_bwd(*args, causal)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_flash_attention_bwd_replays_bit_for_bit(cuda, dtype):
    """The backward recorded into a CUDA graph (its scratch from the
    graph's pool): the capture records three launches and runs none; a
    replay on new inputs copied into the captured ones is bit-equal to an
    eager call on them."""
    shape = (1, 8, 2, 200, 200, 64, True)
    args = _bwd_inputs(*shape, dtype, 5, cuda)
    flash_attention_bwd(*args, True)              # the opt-ins, eagerly
    torch.cuda.synchronize()
    launched = flash_attention_bwd.launches
    recorded = flash_attention_bwd.recorded
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention_bwd(*args, True)
    assert flash_attention_bwd.recorded == recorded + \
        flash_ops.BWD_LAUNCHES_PER_CALL
    assert flash_attention_bwd.launches == launched
    for seed in (6, 7):
        new = _bwd_inputs(*shape, dtype, seed, cuda)
        for dst, src in zip(args, new):
            dst.copy_(src)
        graph.replay()
        eager = flash_attention_bwd(*new, True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(out, eager)), seed


def test_flash_attention_bwd_takes_batch_heads_past_the_grid_limit(cuda):
    """B * H = 65600 > 65535 on the grids' x."""
    args = _bwd_inputs(4100, 16, 4, 20, 20, 16, True, torch.bfloat16, 9,
                       cuda)
    got = flash_attention_bwd(*args, True)
    want = flash_attention_bwd_ref(*args, True)
    for gt, w in zip(got, want):
        torch.testing.assert_close(gt.float(), w.float(),
                                   **chip_smoke.ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_forward_output_is_the_same_with_lse(cuda, dtype):
    """Serving's forward (no lse) and training's (with lse) write the
    same o bit for bit; the lse lies within 1e-5 of the plain version's
    float64 log-sum-exp."""
    q, k, v = _qkv([(1, 24, 300, 128), (1, 8, 300, 128), (1, 8, 300, 128)],
                   dtype, 4, cuda)
    plain, none = flash_ops._forward(q, k, v, True, None)
    with_lse, lse = flash_ops._forward(q, k, v, True, None, with_lse=True)
    torch.cuda.synchronize()
    assert none is None and torch.equal(plain, with_lse)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(),
                     k.double().repeat_interleave(3, 1)) * 128 ** -0.5
    s = s.masked_fill(torch.ones(300, 300, dtype=torch.bool,
                                 device=cuda).triu(1), float("-inf"))
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, -1),
                               rtol=1e-5, atol=1e-5)


def test_flash_attention_bwd_refuses_what_the_kernel_does_not_take(cuda):
    before = flash_attention_bwd.launches
    args = _bwd_inputs(1, 4, 2, 32, 32, 64, True, torch.float32, 1, cuda)
    q, k, v, o, lse, g = args
    with pytest.raises(ValueError, match="head_dim"):
        bad = [torch.zeros(1, 4 if i in (0, 3, 5) else 2, 32, 48,
                           device=cuda) for i in range(6)]
        bad[4] = lse
        flash_attention_bwd(*bad, True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, k, v, o, lse,
                            g.transpose(2, 3).contiguous().transpose(2, 3),
                            True)
    with pytest.raises(ValueError):              # mixed devices
        flash_attention_bwd(q, k.cpu(), v, o, lse, g, True)
    with pytest.raises(ValueError):              # do on the CPU
        flash_attention_bwd(q, k, v, o, lse, g.cpu(), True)
    with pytest.raises(ValueError):              # no lse
        flash_attention_bwd(q, k, v, o, None, g, True)
    assert flash_attention_bwd.launches == before


@pytest.mark.parametrize("t,e,k", [(3000, 128, 8), (300, 256, 8),
                                   (64, 16, 2)])
def test_moe_router_gradient_through_the_function(cuda, t, e, k):
    """The kernel forward once; the logits' gradient (at its indices)
    against autograd through the plain version, 1e-5 relative in norm,
    tie rows included."""
    logits = torch.randn(t, e, generator=torch.Generator().manual_seed(t))
    logits[: 3] = torch.tensor([0.0, 1.0, 2.0]).repeat(e)[:e] \
        .reshape(1, e).expand(3, e)
    logits = logits.to(cuda)
    gw = torch.randn(t, k, generator=torch.Generator().manual_seed(k)
                     ).to(cuda)
    x, y = (logits.clone().requires_grad_() for _ in range(2))
    before = moe_router.launches
    w, idx = moe_router(x, k)
    (got,) = torch.autograd.grad(w, x, gw)
    torch.cuda.synchronize()
    assert moe_router.launches == before + 1
    wr, ir = moe_router_ref(y, k)
    (want,) = torch.autograd.grad(wr, y, gw)
    assert torch.equal(idx, ir)
    assert (got.double() - want.double()).norm() <= \
        1e-5 * want.double().norm()


def test_moe_router_kernel_on_a_models_logits_at_256_experts(cuda):
    """E = 256, k = 8, as deepseek-v3 routes: the logits every MoE layer
    of a reduced deepseek-v3 widened to 256 experts hands the router in a
    prefill and a decode step on the card (one launch each), against the
    plain version on the same logits."""
    cfg = dataclasses.replace(get_reduced("deepseek-v3-671b"), n_experts=256,
                              top_k=8, param_dtype="float32")
    model = Model(cfg)
    params = model.init(0, cuda)
    seen = []
    real = chip_smoke.backend.moe_router

    def keep(logits, k):
        out = real(logits, k)
        seen.append((logits.clone(), k, out))
        return out

    chip_smoke.backend.moe_router = keep
    try:
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (1, 40)), device=cuda)
        before = moe_router.launches
        _, caches = model.prefill(params, {"tokens": toks})
        model.decode_step(params, chip_smoke.pad_to_length(caches, 48),
                          toks[:, -1:], 40)
        torch.cuda.synchronize()
    finally:
        chip_smoke.backend.moe_router = real
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert moe_router.launches - before == 2 * n_moe == len(seen)
    for logits, k, (w, idx) in seen:
        assert logits.shape[1] == 256 and k == 8
        wr, ir = moe_router_ref(logits, k)
        assert torch.equal(idx, ir)
        torch.testing.assert_close(w, wr, rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b", "minitron-4b",
                                  "phi4-mini-3.8b", "deepseek-67b",
                                  "internvl2-26b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_reduced_engine_on_the_card_matches_the_cpu(cuda, arch):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
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
        r0, s0 = moe_router.launches, mamba_scan_with_state.launches
        streams.append({r.req_id: r.out for r in eng.run()})
        launches.append((flash_attention.launches - f0,
                         decode_attention.launches - d0,
                         moe_router.launches - r0,
                         mamba_scan_with_state.launches - s0))
    assert streams[0] == streams[1]
    assert launches[0] == (0, 0, 0, 0)
    # one flash launch per attention layer per prefill, one decode launch
    # per attention layer per decoded token (5 of the 6 tokens of each
    # request), one router launch per MoE layer per prefill and per
    # decoded token, one scan launch per SSM layer per prefill (the SSM
    # decode is plain ops; MLA layers launch neither attention kernel)
    n = chip_smoke.layer_counts(cfg)
    n_attn, n_moe, n_ssm = n["attn"], n["moe"], n["ssm"]
    assert launches[1] == (4 * n_attn, 4 * 5 * n_attn, 4 * 6 * n_moe,
                           4 * n_ssm)


def test_reduced_encoder_decoder_on_the_card_matches_the_cpu(cuda):
    """seamless-m4t-large-v2 reduced, fp32, through ``prefill`` (with
    seeded frames) and greedy ``decode_step``s on the card and on the
    CPU from the same params: equal tokens, logits and the ``{"enc"}``
    cache within 2e-5; per prompt, flash launches once per encoder,
    self- and cross-attention layer in the prefill and once per
    cross-attention layer per decoded token, decode once per
    self-attention layer per decoded token."""
    cfg = dataclasses.replace(get_reduced("seamless-m4t-large-v2"),
                              param_dtype="float32")
    params = Model(cfg).init(0, "cpu")
    frames = torch.randn(1, cfg.frontend_tokens, cfg.d_model,
                         generator=torch.Generator().manual_seed(3))
    runs, launches = [], []
    for dev in ("cpu", cuda):
        model = Model(cfg)
        p = convert.tree_map(lambda t: t.to(dev), params)
        f0, d0 = flash_attention.launches, decode_attention.launches
        out = []
        for n in (5, 19):
            toks = torch.arange(n, device=dev)[None] % cfg.vocab
            logits, caches = model.prefill(p, {"tokens": toks,
                                               "frame_embeds": frames.to(dev)})
            enc = caches[0]["enc"].cpu()
            caches = pad_to_length(caches, n + 6)
            steps = [logits.cpu()]
            for j in range(5):
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                logits, caches = model.decode_step(p, caches, tok, n + j)
                steps.append(logits.cpu())
            out.append((enc, steps))
        runs.append(out)
        launches.append((flash_attention.launches - f0,
                         decode_attention.launches - d0))
    for (e0, s0), (e1, s1) in zip(*runs):
        torch.testing.assert_close(e1, e0, rtol=2e-5, atol=2e-5)
        for a, b in zip(s0, s1):
            assert torch.equal(a.argmax(-1), b.argmax(-1))
            torch.testing.assert_close(b, a, rtol=2e-5, atol=2e-5)
    n = chip_smoke.layer_counts(cfg)
    assert launches == [(0, 0), (
        2 * chip_smoke.flash_per_forward(n) + 2 * 5 * n["cross"],
        2 * 5 * n["attn"] * chip_smoke.LAUNCHES_PER_CALL)]


def _scan_inputs(b, l, d, n, dtype, device, seed):
    """The JAX sweep's distributions: u, b, c normal, delta a softplus of
    a normal, a = -exp(normal), skip normal; u, delta, b, c in ``dtype``,
    a and skip fp32."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(b, l, d, generator=g)
    delta = torch.nn.functional.softplus(torch.randn(b, l, d, generator=g))
    a = -torch.exp(torch.randn(d, n, generator=g))
    bm, cm = (torch.randn(b, l, n, generator=g) for _ in range(2))
    skip = torch.randn(d, generator=g)
    return ([t.to(device, dtype) for t in (u, delta)] + [a.to(device)]
            + [t.to(device, dtype) for t in (bm, cm)] + [skip.to(device)])


# the JAX sweep (tests/test_kernels.py MAMBA_SWEEP), ragged shapes (L
# no multiple of 32, D no multiple of the backward's 32 channels a block, N
# = 1, 4, 5, 8, 16 and 32; rows of 50 or 129 elements are not 16-byte
# aligned, so the backward loads its next chunk without cp.async), and
# falcon-mamba-7b's training shapes (B x L x d_inner x N)
SCAN_SHAPES = [(1, 64, 128, 16), (2, 128, 64, 16), (1, 96, 256, 8),
               (3, 77, 200, 5), (1, 1, 3, 1), (2, 33, 129, 32),
               (2, 33, 129, 4), (1, 70, 100, 8), (1, 40, 50, 16),
               (2, 64, 96, 32), (2, 256, 8192, 16), (4, 512, 8192, 16),
               chip_smoke.SCAN_JAMBA]


@pytest.mark.parametrize("b,l,d,n", SCAN_SHAPES)
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 1e-2, 1e-3)])
def test_mamba_scan_kernel_matches_plain_version(cuda, b, l, d, n, dtype,
                                                 rtol, atol):
    """fp32: the states agree bit for bit and y's N-sum runs in another
    order, an fp32 ulp of |y|.  bf16: ex2.approx moves the fp32 states by
    ~1e-6 of themselves, and y rounds to at most one bf16 ulp away."""
    args = _scan_inputs(b, l, d, n, dtype, cuda, seed=b * l + d)
    before = mamba_scan.launches
    got = mamba_scan(*args)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, l, d)
    torch.testing.assert_close(got.float(), mamba_scan_ref(*args).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("b,l,d,n", SCAN_SHAPES)
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 1e-2, 1e-3)])
def test_mamba_scan_with_state_kernel_matches_plain_version(cuda, b, l, d,
                                                            n, dtype, rtol,
                                                            atol):
    """The serving variant: y as ``mamba_scan``'s, the final state bit
    for bit in fp32 (the states step as the plain version's) and within
    1e-4 in bf16 (ex2.approx), one launch."""
    args = _scan_inputs(b, l, d, n, dtype, cuda, seed=b * l + d + 1)
    before = mamba_scan_with_state.launches, mamba_scan.launches
    y, h = mamba_scan_with_state(*args)
    torch.cuda.synchronize()
    assert (mamba_scan_with_state.launches, mamba_scan.launches) == (
        before[0] + 1, before[1])
    want_y, want_h = mamba_scan_with_state_ref(*args)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol,
                               atol=atol)
    if dtype == torch.float32:
        assert torch.equal(h, want_h)
    else:
        torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    assert torch.equal(y, mamba_scan(*args))
    with pytest.raises(ValueError, match="inference-only"):
        mamba_scan_with_state(args[0].clone().requires_grad_(), *args[1:])


# Gradients of the backward kernel against a plain version, per input,
# relative to the plain version's norm and to its largest element.  fp32:
# 1e-5 of both (observed <= 1e-6: the states agree bit for bit, the sums
# over d, n, t and b run in another order).  bf16: du, ddelta, dB and dC
# are rounded to bf16 from fp32 sums that differ in order, and the states
# come from ex2.approx, so an element can land one bf16 ulp (2^-8 of
# itself) from the plain version's: 2^-7 of the largest element, and 1e-3
# in norm (observed <= 1.7e-3 and 5e-5).
GRAD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2**-7)}


def _assert_grads_close(got, want, dtype):
    rel, max_rel = GRAD_TOL[dtype]
    for name, g, w in zip(("u", "delta", "a", "b", "c", "skip"), got, want):
        g, w = g.double(), w.double()
        assert (g - w).norm() <= rel * w.norm(), name
        assert (g - w).abs().max() <= max_rel * w.abs().max(), name


@pytest.mark.parametrize("b,l,d,n", [(1, 32, 64, 8), (2, 77, 200, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_gradients_through_the_kernel(cuda, b, l, d, n, dtype):
    """Through the Function: the forward kernel (keeping its chunk
    states) once and the backward kernels once (two launches); the
    gradients, in the inputs' dtypes, match autograd through the plain
    version."""
    args = _scan_inputs(b, l, d, n, dtype, cuda, seed=l)
    g = torch.randn(b, l, d, generator=torch.Generator().manual_seed(1)
                    ).to(cuda, dtype)
    xs = [t.clone().requires_grad_() for t in args]
    ref = [t.clone().requires_grad_() for t in args]
    before = mamba_scan.launches, mamba_scan_bwd.launches
    got = torch.autograd.grad(mamba_scan(*xs), xs, g)
    torch.cuda.synchronize()
    assert (mamba_scan.launches, mamba_scan_bwd.launches) == (
        before[0] + 1, before[1] + scan_ops.BWD_LAUNCHES_PER_CALL)
    want = torch.autograd.grad(mamba_scan_ref(*ref), ref, g)
    assert [t.dtype for t in got] == [t.dtype for t in args]
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("b,l,d,n", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_backward_kernel_matches_plain_versions(cuda, b, l, d, n,
                                                           dtype):
    """The chunk states the forward kernel keeps against
    ``scan_states_ref`` (fp32 bit for bit; bf16 within 1e-4, the drift of
    ex2.approx), then the backward kernel from them against the plain
    backward from the same states and against autograd through the plain
    scan."""
    args = _scan_inputs(b, l, d, n, dtype, cuda, seed=b + l + d)
    g = torch.randn(b, l, d, generator=torch.Generator().manual_seed(2)
                    ).to(cuda, dtype)
    _, states, _ = scan_ops._launch(*args, keep_states=True)
    want_states = scan_states_ref(*args[:4])
    if dtype == torch.float32:
        assert torch.equal(states, want_states)
    else:
        torch.testing.assert_close(states, want_states, rtol=1e-4,
                                   atol=1e-4)
    before = mamba_scan_bwd.launches
    got = mamba_scan_bwd(*args, g, states)
    again = mamba_scan_bwd(*args, g, states)
    torch.cuda.synchronize()
    assert mamba_scan_bwd.launches == before + 2 * \
        scan_ops.BWD_LAUNCHES_PER_CALL
    # fixed summation orders, no atomics: two calls agree bit for bit
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _assert_grads_close(got, mamba_scan_bwd_ref(*args, g, states), dtype)
    xs = [t.clone().requires_grad_() for t in args]
    _assert_grads_close(
        got, torch.autograd.grad(mamba_scan_ref(*xs), xs, g), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_backward_takes_unaligned_inputs(cuda, dtype):
    """u, delta and g one element past a 16-byte boundary: the backward
    loads each next chunk by plain loads, not cp.async, to the same
    gradients bit for bit."""
    args = _scan_inputs(2, 70, 256, 16, dtype, cuda, seed=5)
    g = torch.randn(2, 70, 256, generator=torch.Generator().manual_seed(5)
                    ).to(cuda, dtype)
    _, states, _ = scan_ops._launch(*args, keep_states=True)

    def shifted(t):
        return torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)

    moved = list(args)
    moved[0], moved[1] = shifted(args[0]), shifted(args[1])
    assert moved[0].data_ptr() % 16 and moved[0].is_contiguous()
    got = mamba_scan_bwd(*moved, shifted(g), states)
    want = mamba_scan_bwd(*args, g, states)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    _assert_grads_close(got, mamba_scan_bwd_ref(*args, g, states), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_takes_batches_past_the_grid_limit(cuda, dtype):
    """B = 70000 > 65535: the grids are flat over (batch row, channel
    block)."""
    args = _scan_inputs(70000, 3, 5, 4, dtype, cuda, seed=3)
    g = torch.randn(70000, 3, 5, generator=torch.Generator().manual_seed(3)
                    ).to(cuda, dtype)
    y, states, _ = scan_ops._launch(*args, keep_states=True)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-3))
    torch.testing.assert_close(y.float(), mamba_scan_ref(*args).float(),
                               **tol)
    _assert_grads_close(mamba_scan_bwd(*args, g, states),
                        mamba_scan_bwd_ref(*args, g, states), dtype)


def test_mamba_scan_backward_on_the_card_never_runs_the_plain_scan(
        cuda, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("the plain scan ran on the card")

    for name in ("mamba_scan_ref", "mamba_scan_bwd_ref"):
        monkeypatch.setattr(scan_ops, name, plain)
    args = _scan_inputs(2, 40, 64, 16, torch.float32, cuda, seed=4)
    xs = [t.requires_grad_() for t in args]
    before = mamba_scan_bwd.launches
    grads = torch.autograd.grad(mamba_scan(*xs).sum(), xs)
    torch.cuda.synchronize()
    assert mamba_scan_bwd.launches == before + scan_ops.BWD_LAUNCHES_PER_CALL
    assert all(torch.isfinite(t).all() for t in grads)


def test_mamba_scan_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    u, delta, a, b, c, skip = _scan_inputs(1, 8, 16, 4, torch.float32, cuda,
                                           seed=0)
    before = mamba_scan.launches
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(u.transpose(1, 2).contiguous().transpose(1, 2), delta, a,
                   b, c, skip)
    with pytest.raises(TypeError):
        mamba_scan(u, delta, a.bfloat16(), b, c, skip)
    with pytest.raises(TypeError):
        mamba_scan(u, delta.bfloat16(), a, b, c, skip)
    with pytest.raises(TypeError):
        mamba_scan(*(t.half() for t in (u, delta)), a, b.half(), c.half(),
                   skip)
    big = _scan_inputs(1, 4, 8, 33, torch.float32, cuda, seed=1)
    with pytest.raises(ValueError, match="state size"):
        mamba_scan(*big)
    assert mamba_scan.launches == before


def test_reduced_ssm_training_on_the_card_matches_the_cpu(cuda):
    """Three AdamW steps of the reduced falcon-mamba in fp32 on the card
    and on the CPU from the same params: each layer's forward scan
    launches twice per step (forward, and its recompute in the backward)
    and its backward kernels once (two launches)."""
    cfg = dataclasses.replace(get_reduced("falcon-mamba-7b"),
                              param_dtype="float32")
    params = Model(cfg).init(0, "cpu")
    losses, launches = [], []
    for dev in ("cpu", cuda):
        tr = Trainer(Model(cfg), mesh=None, device=dev)
        # a copy: the step updates the params in place
        p = convert.tree_map(lambda t: t.to(dev, copy=True), params)
        state = Opt.init(tr.opt_cfg, p)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=24,
                                      global_batch=2), device=dev)
        step = tr.compile_step()
        before = mamba_scan.launches, mamba_scan_bwd.launches
        out = []
        for i in range(3):
            p, state, m = step(p, state, data.batch(i))
            out.append(float(m["loss"]))
        launches.append((mamba_scan.launches - before[0],
                         mamba_scan_bwd.launches - before[1]))
        losses.append(out)
    per_step = 2 * cfg.n_layers * 3
    assert launches == [(0, 0), (per_step, per_step)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b",
                                  "minitron-4b", "phi4-mini-3.8b",
                                  "deepseek-67b", "internvl2-26b",
                                  "deepseek-v3-671b", "seamless-m4t-large-v2",
                                  "jamba-1.5-large-398b"])
def test_reduced_attention_training_on_the_card_matches_the_cpu(cuda, arch):
    """Three AdamW steps of the reduced dense, vlm (with patch
    embeddings), MoE, encoder-decoder (with frame embeddings: encoder,
    self- and cross-attention each launch flash) and hybrid models in
    fp32 on the card and on the CPU from the same params: each GQA
    layer's forward launches flash_attention (and each MoE layer the
    router) twice per step (the forward, and its recompute in the
    backward) and nothing in the backward, MLA layers none; a repeated
    step on the card is bit-equal."""
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
    params = Model(cfg).init(0, "cpu")
    losses, launches, finals = [], [], []
    for dev in ("cpu", cuda):
        tr = Trainer(Model(cfg), mesh=None, device=dev)
        p = convert.tree_map(lambda t: t.to(dev, copy=True), params)
        state = Opt.init(tr.opt_cfg, p)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4), device=dev)
        step = tr.compile_step()
        before = flash_attention.launches, moe_router.launches
        out = []
        for i in range(3):
            p, state, m = step(p, state, _with_patches(cfg, data.batch(i),
                                                       i))
            out.append(float(m["loss"]))
        launches.append((flash_attention.launches - before[0],
                         moe_router.launches - before[1]))
        losses.append(out)
        finals.append(p)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert launches == [(0, 0), (2 * chip_smoke.flash_per_forward(
        chip_smoke.layer_counts(cfg)) * 3, 2 * n_moe * 3)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    # the same step again from the same start: bit for bit
    tr = Trainer(Model(cfg), mesh=None, device=cuda)
    again = []
    for _ in range(2):
        p = convert.tree_map(lambda t: t.to(cuda, copy=True), params)
        p, _, m = tr.compile_step()(p, Opt.init(tr.opt_cfg, p), _with_patches(
            cfg, SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=4),
                             device=cuda).batch(0), 0))
        again.append((float(m["loss"]), p))
    assert again[0][0] == again[1][0] == losses[1][0]
    assert all(torch.equal(a, b) for a, b in zip(
        convert.leaves(again[0][1]), convert.leaves(again[1][1])))


def _with_patches(cfg, batch: dict, seed: int) -> dict:
    """A vlm batch gets seeded patch embeddings (the image stub), an
    encdec batch seeded frame embeddings (the audio stub), on the batch's
    device; other families' batches pass as they are."""
    key = {"vlm": "patch_embeds", "encdec": "frame_embeds"}.get(cfg.family)
    if key is None:
        return batch
    b = batch["tokens"].shape[0]
    pe = torch.randn(b, cfg.frontend_tokens, cfg.d_model,
                     generator=torch.Generator().manual_seed(seed))
    return dict(batch, **{key: pe.to(batch["tokens"].device, cfg.dtype)})


def _gru_inputs(seed: int = 0):
    """A GRU from ``gru_init`` with a nonzero bias, and T = 5 steps of 37
    histories (padded by ``_predict`` to 64) with their targets."""
    p = baselines.gru_init(seed, 3, 16)
    g = torch.Generator().manual_seed(seed)
    p["b"] = torch.randn(48, generator=g) * 0.5
    xs = torch.randn(5, 37, 3, generator=g)
    y = torch.rand(37, generator=g) * 2.5 + 0.5
    return p, xs, y


def test_igru_gru_on_the_card_matches_the_cpu(cuda):
    """IGRU-SD's GRU forward, and three ``_gru_step``s, on the card
    within 1e-5 of the same on the CPU from the same params; a policy's
    predictions on the card within 1e-5 of its CPU twin's."""
    p, xs, y = _gru_inputs()
    outs = {dev: baselines.gru_apply(convert.tree_map(
        lambda t: t.to(dev), p), xs.to(dev)).cpu() for dev in ("cpu", cuda)}
    np.testing.assert_allclose(outs[cuda], outs["cpu"], rtol=1e-5,
                               atol=1e-6)
    losses = {}
    for dev in ("cpu", cuda):
        params = convert.tree_map(lambda t: t.to(dev), p)
        opt = net.adam_init(params)
        losses[dev] = []
        for _ in range(3):
            params, opt, loss = baselines._gru_step(params, opt, xs.to(dev),
                                                    y.to(dev))
            losses[dev].append(float(loss))
    np.testing.assert_allclose(losses[cuda], losses["cpu"], rtol=1e-5)
    card, twin = (baselines.IGRUSD(device=d) for d in (cuda, "cpu"))
    card.params = convert.tree_map(lambda t: t.to(cuda), p)
    twin.params = p
    hist = xs.numpy()
    np.testing.assert_allclose(card._predict(hist), twin._predict(hist),
                               rtol=1e-5, atol=1e-6)


def test_igru_refuses_the_card_where_there_is_none(monkeypatch):
    """No fallback: asked for ``cuda`` where CUDA is absent, IGRU-SD
    raises, in its constructor and when a pickle made for the card is
    loaded there."""
    pickled = pickle.dumps(baselines.IGRUSD(device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        baselines.IGRUSD(device="cuda")
    pol = pickle.loads(pickled)
    assert pol.device.type == "cpu"
    pol.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        pickle.loads(pickle.dumps(pol))


def test_sweep_on_the_card_two_workers_equal_serial(cuda):
    """A 2-worker sweep of START, IGRU-SD (both on the card) and GRASS
    is bit-equal to the serial run, cell by cell; the pickled START and
    IGRU-SD unpickle onto the card in the workers (each runs a cell
    there, the pool warmed first), which load the parent's kernel
    libraries without building them again."""
    spec = sweep.SweepSpec(
        techniques=("start", "igru-sd", "grass"), seeds=(0, 1),
        scenarios=("planetlab", "overload"), n_hosts=16, n_intervals=24,
        arrival_rate=0.8, pretrain_epochs=2, igru_epochs=5, max_workers=1,
        technique_kwargs={"start": {"device": "cuda"},
                          "igru-sd": {"device": "cuda"}})
    serial = sweep.run(spec)
    libs = chip_smoke.built_libraries()
    try:
        sweep.warm_pool(2)
        parallel = sweep.run(dataclasses.replace(spec, max_workers=2))
    finally:
        sweep.shutdown_pool()
    assert libs and chip_smoke.built_libraries() == libs
    chip_smoke.cells_in_workers(parallel, ("start", "igru-sd"), "cuda")
    assert len(serial.cells) == len(parallel.cells) == 12
    for a, b in zip(serial.cells, parallel.cells):
        assert (a.scenario, a.technique, a.seed) == (b.scenario,
                                                     b.technique, b.seed)
        assert sweep.deterministic_summary(a.summary) == \
            sweep.deterministic_summary(b.summary), (a.technique, a.seed)
    tech = sweep.make_technique(
        "igru-sd", spec.cell_config("planetlab", 0),
        igru_epochs=spec.igru_epochs,
        technique_kwargs=spec.kwargs_for("igru-sd"))
    assert tech.params["wx"].device.type == "cuda"


# ------------------------------ the service --------------------------------

def _service_pair(tmp_path, cuda, tenants=4, **kw):
    """A service on the card and its CPU twin from one weight set (the
    twin's store is a copy of the card's), at 16 hosts, k = 0.5 so the
    seeded weights act."""
    prof = Profile(n_hosts=16, max_tasks=10, k=0.5, trigger="per_task")
    card = PredictionService(ServiceConfig(prof, ckpt_dir=str(
        tmp_path / "card"), device="cuda", **kw))
    shutil.copytree(tmp_path / "card", tmp_path / "cpu")
    twin = PredictionService(ServiceConfig(prof, ckpt_dir=str(
        tmp_path / "cpu"), device="cpu", **kw))
    streams = [chip_smoke.TenantStream(f"t{i}", 16, 10, i, max_jobs=12)
               for i in range(tenants)]
    for s in streams:
        for svc in (card, twin):
            assert svc.hello(s.tenant, prof.to_wire())["ok"]
    return card, twin, streams


def test_service_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Every tick on the card launches lstm_cell 10 times; the answers
    hold to the CPU twin's within the Tier-1 bound, with the actions
    held as the smoke holds them; a retrain (10 launches per train step
    and per shadow evaluation) decides as the twin does, with losses
    within 1e-5, and the promoted model stays in lockstep."""
    card, twin, streams = _service_pair(
        tmp_path, cuda, min_train_pairs=32, eval_holdback=8,
        train_epochs=2, train_lr=1e-3)
    r = chip_smoke.service_lockstep(card, twin, streams, 12)
    assert r["actions"] > 0
    before = lstm_cell.launches
    ra = card.retrain_now()
    launched = lstm_cell.launches - before
    rb = twin.retrain_now()
    steps = 2 * max(ra["train_pairs"] // 64, 1)
    assert launched == 10 * (steps + 2)
    for key in ("champion_loss", "candidate_loss", "final_train_loss"):
        assert abs(ra[key] - rb[key]) <= 1e-5 * abs(rb[key]), key
    assert (ra["promoted"], ra["version"]) == (rb["promoted"],
                                               rb["version"])
    chip_smoke.service_lockstep(card, twin, streams, 4, t0=12)


def test_daemon_on_the_card_answers_over_tcp_bit_for_bit(cuda):
    """A single tenant's answer over TCP from a daemon on the card equals
    the card's own predictor fed the same rows, bit for bit."""
    prof = Profile(n_hosts=16, max_tasks=10)
    stream = chip_smoke.TenantStream("t0", 16, 10, 3, max_jobs=6)
    snaps = [stream.step()[0] for _ in range(4)]
    with ServiceDaemon(ServiceConfig(prof, device="cuda")) as d:
        c = d.tcp_client("t0")
        assert c.hello(prof)["ok"]
        for snap in snaps:
            r = c.snapshot(snap)
        c.bye()
    pred = StragglerPredictor(n_hosts=16, max_tasks=10, device="cuda")
    for snap in snaps:
        pred.push_host_row(np.asarray(snap["m_h"], np.float32))
        m_t = np.stack([np.asarray(j["m_t"], np.float32).reshape(10, 5)
                        for j in snap["jobs"]])
        q = np.array([j["q"] for j in snap["jobs"]], np.float32)
        e_s = STARTController._sanitize_es(pred.predict_interval(m_t, q), q)
    assert [j["e_s"] for j in r["jobs"]] == [float(e) for e in e_s]


def test_version_store_restores_onto_the_card(cuda, tmp_path):
    pred = StragglerPredictor(n_hosts=4, max_tasks=3, device="cuda")
    store = VersionStore(str(tmp_path))
    store.save_version(0, pred.params)
    got = store.load_version(0, pred.params)
    for a, b in zip(convert.leaves(got), convert.leaves(pred.params)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_launch_train_resumes_on_the_card_bit_for_bit(cuda, tmp_path):
    argv = ["--arch", "falcon-mamba-7b", "--reduced", "--steps", "8",
            "--batch", "2", "--seq", "16", "--ckpt-every", "3", "--device",
            "cuda"]
    full = train_entry.main(argv)
    ck = ["--ckpt", str(tmp_path)]
    with pytest.raises(SystemExit) as killed:
        train_entry.main([*argv, *ck, "--kill-at", "4"])
    assert killed.value.code == 42
    resumed = train_entry.main([*argv, *ck, "--resume"])
    assert resumed["start"] == 3
    assert resumed["losses"] == full["losses"][3:]


def test_online_pod_policy_on_the_card_matches_the_cpu(cuda):
    """A 400-host ``start-pod-online`` run on the card (40 steps: 8
    windows, the network predicting from the second) holds to its CPU
    twin, as the smoke's pod phase holds it (the twin takes the card's
    weights after every fit): the same actions and summary, E_S within
    the Tier-1 bound and the epoch losses within 1e-5; every prediction
    and ``train_step`` launched ``lstm_cell`` 10 times."""
    from repro_torch.distributed.straggler_runtime import (
        OnlineStartPodPolicy, StragglerRuntime)
    card, twin = (StragglerRuntime(chip_smoke.pod_config(dev),
                                   policy=OnlineStartPodPolicy())
                  for dev in ("cuda", "cpu"))
    chip_smoke.prebuild(card)
    chip_smoke.prebuild(twin)
    assert card.policy.predictor.device.type == "cuda"
    before = lstm_cell.launches
    r = chip_smoke.pod_lockstep(card, twin, chip_smoke.pod_trace(40, 400),
                                sync=True)
    launched = lstm_cell.launches - before
    assert r["parted_at"] is None and r["max_rel"] <= chip_smoke.TIER1_REL
    assert r["max_loss_rel"] <= 1e-5
    assert r["net_predictions"] == 40 - 2 * 5 + 1
    assert launched == 10 * (r["net_predictions"] + r["train_steps"]) > 0


# ------------------------------ distribution --------------------------------


def test_compression_on_the_card_equals_the_cpu_twin(cuda, tmp_path):
    """EF-int8 and EF-top-k on CUDA tensors over a one-rank NCCL group
    against the same rounds on the CPU over gloo: every leaf's reduced
    value and residual bit-equal over three rounds, and top-k's kept
    index set equal (ties at zero broken by index on both)."""
    from torch_ranks import spawn
    got = spawn("compression_on_card", 1, tmp_path, dict(
        shapes={"w": (256, 128), "b": (300,), "e": (4, 64, 33)},
        frac=0.01), backend="nccl")[0]
    for scheme, checks in got.items():
        assert checks and all(ok for _, ok in checks), (scheme, checks)


def test_one_rank_nccl_mesh_step_is_the_unsharded_step(cuda, tmp_path):
    """Three mesh-trainer steps on a (1, 1) NCCL mesh against the
    unsharded step on the card from the same params, reduced demo-100m
    and qwen3 in fp32: losses and params bit-equal."""
    from torch_ranks import spawn
    cases = []
    for arch in ("demo-100m", "qwen3-moe-30b-a3b"):
        cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
        params = convert.to_numpy(Model(cfg).init(0, "cpu"))
        cases.append((cfg, params, 2, dict(lr=1e-2, warmup_steps=2,
                                           total_steps=50)))
    got = spawn("one_rank_mesh", 1, tmp_path, dict(cases=cases,
                                                   device="cuda"),
                backend="nccl")[0]
    for (mesh_losses, mesh_p), (losses, p) in got:
        assert mesh_losses == losses
        for a, b in zip(convert.leaves(mesh_p), convert.leaves(p)):
            np.testing.assert_array_equal(a, b)


# ------------------ captured programs (CUDA graphs) ------------------------


def _hist_and_jobs(rng, n_hosts, max_tasks, n):
    row = rng.uniform(0, 1, (n_hosts, 11)).astype(np.float32)
    mt = rng.uniform(0, 1, (n, max_tasks, 5)).astype(np.float32)
    q = rng.integers(1, max_tasks + 1, n).astype(np.float32)
    return row, mt, q


@pytest.mark.parametrize("per_task", [False, True])
def test_fused_step_replay_equals_the_eager_step(cuda, per_task):
    """Intervals at three batch shapes through the fused step's graphs
    (each key's first call its warm-up, the rest replays) against the
    eager ``_fused_step`` on the card on inputs and a ring assembled
    apart (the smoke's ``EagerIntervals``): bit for bit, with 10 cell
    launches an interval either way."""
    pred = StragglerPredictor(n_hosts=16, max_tasks=6, seed=2, device=cuda)
    rng = np.random.default_rng(3)
    eager = None
    for t in range(12):
        row, mt, q = _hist_and_jobs(rng, 16, 6, (1, 5, 16)[t % 3])
        eager = eager or chip_smoke.EagerIntervals(pred, [row])
        pred.push_host_row(row)
        before = lstm_cell.launches
        got = pred.predict_interval(mt, q, per_task=per_task)
        assert lstm_cell.launches - before == 2 * pred.horizon
        if per_task:
            got = np.concatenate([got[0][:, None], got[1]], axis=1)
        want = eager(row, mt, q, per_task)
        assert lstm_cell.launches - before == 4 * pred.horizon
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("per_task", [False, True])
def test_predict_tenants_replay_equals_eager(cuda, per_task):
    """Three ticks of a tenant batch (the serving batch's programs, then
    their replays) against the eager ``predict_sequence_opt`` and Pareto
    tail on the card: bit for bit."""
    from repro_torch.core import predictor as P
    pred = StragglerPredictor(n_hosts=16, max_tasks=6, seed=4, device=cuda)
    rng = np.random.default_rng(5)
    for _ in range(3):
        seqs = [rng.uniform(0, 1, (5, 16, 11)).astype(np.float32)
                for _ in range(3)]
        jobs = [_hist_and_jobs(rng, 16, 6, n)[1:] for n in (2, 1, 3)]
        got = pred.predict_tenants(seqs, [mt for mt, _ in jobs],
                                   [q for _, q in jobs], per_task=per_task)
        nb = pred.batch_size(6)
        xs = np.zeros((5, nb, pred.input_dim), np.float32)
        qp = np.ones(nb, np.float32)
        lo = 0
        for s, (mt, q) in zip(seqs, jobs):
            n = len(q)
            xs[:, lo:lo + n, :pred.host_dim] = s.reshape(5, 1, -1)
            xs[:, lo:lo + n, pred.host_dim:] = mt.reshape(1, n, -1)
            qp[lo:lo + n] = q
            lo += n
        xs[:, lo:, :pred.host_dim] = seqs[-1].reshape(5, 1, -1)
        ab = net.predict_sequence_opt(pred.params, torch.from_numpy(xs)
                                      .to(cuda))
        k = torch.tensor(pred.k, dtype=torch.float32, device=cuda)
        bs = torch.tensor(pred.beta_scale, dtype=torch.float32, device=cuda)
        q_d = torch.from_numpy(qp).to(cuda)
        if per_task:
            want = P._pareto_tail_per_task(
                ab, q_d, k, bs, torch.from_numpy(np.ascontiguousarray(
                    xs[-1, :, pred.host_dim:])).to(cuda)).cpu().numpy()
            got = np.concatenate([np.concatenate([e[:, None], s], axis=1)
                                  for e, s in got])
        else:
            want = P._pareto_tail(ab, q_d, k, bs)[3].cpu().numpy()
            got = np.concatenate(got)
        np.testing.assert_array_equal(got, want[:6])


def test_train_step_replay_equals_eager(cuda):
    """Five ``train_step``s through the program (``fit``'s path) and
    eagerly on the card from the same params and minibatches: losses,
    params and Adam state bit for bit; 10 cell launches a step each
    way."""
    pred = StragglerPredictor(n_hosts=16, max_tasks=6, seed=6, device=cuda)
    rng = np.random.default_rng(7)
    xs = rng.uniform(0, 1, (5, 40, pred.input_dim)).astype(np.float32)
    ys = rng.uniform(1, 3, (40, 2)).astype(np.float32)
    steps = net.Training(pred.params, pred.opt, xs, ys, 16, 1e-3)
    params, opt = pred.params, pred.opt
    xs_d, ys_d = torch.from_numpy(xs).to(cuda), torch.from_numpy(ys).to(cuda)
    before = lstm_cell.launches
    for _ in range(5):
        idx = rng.permutation(40)[:16]
        got = steps.step(idx)
        i_d = torch.from_numpy(idx).to(cuda)
        params, opt, loss = net.train_step(params, opt, xs_d[:, i_d],
                                           ys_d[i_d], lr=1e-3)
        assert got == float(loss)
    assert lstm_cell.launches - before == 2 * 5 * 10
    for a, b in zip(convert.leaves(steps.result()),
                    convert.leaves((params, opt))):
        assert torch.equal(a, b)


def test_gru_step_replay_equals_eager(cuda):
    """IGRU-SD's training through the ``gru_step`` program against the
    eager ``_gru_step`` on the card: params bit for bit."""
    pol = baselines.IGRUSD(seed=1, device=cuda)
    rng = np.random.default_rng(8)
    xs = rng.uniform(0, 1, (5, 64, 3)).astype(np.float32)
    y = rng.uniform(0.5, 2, 64).astype(np.float32)
    params, opt = pol.params, net.adam_init(pol.params)
    for _ in range(6):
        params, opt, _ = baselines._gru_step(
            params, opt, torch.from_numpy(xs).to(cuda),
            torch.from_numpy(y).to(cuda))
    pol.train(xs, y, epochs=6)
    for a, b in zip(convert.leaves(pol.params), convert.leaves(params)):
        assert torch.equal(a, b)


def test_replays_count_the_launches_they_replay(cuda):
    """N calls of one fused-step key: the first runs eagerly (10 cell
    launches) and captures (none counted), the others replay (10 each):
    10 N in all, the graph's record being 10."""
    from repro_torch.core import predictor as P
    from repro_torch.core import programs
    pred = StragglerPredictor(n_hosts=9, max_tasks=3, seed=1, device=cuda)
    rng = np.random.default_rng(9)
    before, replays = lstm_cell.launches, programs.stats["replays"]
    for _ in range(7):
        row, mt, q = _hist_and_jobs(rng, 9, 3, 3)
        pred.push_host_row(row)
        pred.predict_interval(mt, q)
    assert lstm_cell.launches - before == 7 * 10
    assert programs.stats["replays"] - replays == 6
    entries = [e for e in P.FUSED_STEP._entries.values()
               if e.key[3] == pred.host_dim]
    assert [e.launches for e in entries] == [{lstm_cell: 10}]


def test_a_capture_whose_program_syncs_raises(cuda):
    """A program that reads a value to the host cannot be captured: its
    first call raises (after its eager warm-up) instead of running
    eagerly, and the card works afterwards."""
    from repro_torch.core import programs
    prog = programs.Program("syncs", lambda x: x * float(x.sum()))
    e = prog.entry(("syncs",), lambda: (torch.ones(4, device=cuda),))
    with pytest.raises(RuntimeError):
        e.run()
    assert e.graph is None
    assert float((torch.ones(3, device=cuda) * 2).sum()) == 6.0


# --------------- the LM decode step as a CUDA graph (per slot) --------------


@pytest.mark.parametrize("b,h,hkv,s,d,kvlen", [
    # yi-6b's decode in a 4096-row slot: kv_len 1, 28, S / 2 and S
    *[(1, 32, 4, 4096, 128, n) for n in (1, 28, 2048, 4096)],
    (1, 4, 2, 40, 16, 17), (3, 32, 2, 100, 32, 77),
    (1, 24, 8, 4096, 128, 513), (1, 64, 8, 600, 128, 268),
    (1, 16, 16, 4096, 64, 28)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_decode_attention_reads_kv_len_on_the_card(cuda, b, h, hkv, s, d,
                                                   kvlen, dtype, atol):
    """``kv_len`` as a 0-d device tensor: the kernel reads it, its split
    follows S, and the rows past kv_len hold another request's keys and
    values (finite), which add nothing: against the plain version, the
    plain split-and-merge at the S-derived split, and bf16 rounding."""
    q, k, v = _qkv([(b, h, d), (b, hkv, s, d), (b, hkv, s, d)], dtype,
                   3 * s + kvlen, cuda)
    want = decode_attention_ref(q, k, v, kv_len=kvlen)
    want32 = _decode_fp32(q, k, v, kvlen)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_splits, split_keys = decode_ops.decode_split(b * hkv, s, n_sm)
    split = decode_attention_split_ref(q.cpu(), k.cpu(), v.cpu(),
                                       kv_len=torch.tensor(kvlen),
                                       n_splits=n_splits,
                                       split_keys=split_keys)
    kv32 = torch.tensor(kvlen, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_len=kv32)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    for w in (want, split.to(cuda)):
        torch.testing.assert_close(got.float(), w.float(), rtol=atol,
                                   atol=atol)
    if dtype == torch.bfloat16:
        assert bf16_rounding_excess(got, want32) <= BF16_EXCESS
    # an int64 kv_len, and the same bits from run to run
    assert torch.equal(decode_attention(q, k, v, kv_len=kv32.long()), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_decode_kernel_replays_at_changing_kv_len(cuda, dtype):
    """One launch captured into a CUDA graph with kv_len a device int32,
    replayed after the kv_len changed (1, 28, 2048, 4096, 700): each
    replay bit-equal to an eager launch at the same kv_len and within
    the plain version's tolerance; the capture records one launch and
    launches nothing."""
    q, k, v = _qkv([(1, 32, 128), (1, 4, 4096, 128), (1, 4, 4096, 128)],
                   dtype, 11, cuda)
    kv = torch.ones((), dtype=torch.int32, device=cuda)
    decode_attention(q, k, v, kv_len=kv)          # the opt-ins, eagerly
    torch.cuda.synchronize()
    launched, recorded = decode_attention.launches, decode_attention.recorded
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, kv_len=kv)
    assert decode_attention.recorded == recorded + 1
    assert decode_attention.launches == launched
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    for n in (1, 28, 2048, 4096, 700):
        kv.fill_(n)
        graph.replay()
        eager = decode_attention(q, k, v, kv_len=kv)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), n
        torch.testing.assert_close(
            out.float(), decode_attention_ref(q, k, v, kv_len=n).float(),
            rtol=atol, atol=atol)


class _LoggedEngine(Engine):
    """The engine, keeping every decoded step's logits: (request, position,
    logits)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.steps = []

    def _decode(self, slot, st):
        logits = super()._decode(slot, st)
        self.steps.append((st["req"].req_id, st["pos"], logits.clone()))
        return logits


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b", "jamba-1.5-large-398b",
                                  "deepseek-v3-671b", "internvl2-26b"])
def test_reduced_engine_replays_equal_the_eager_decode(cuda, arch):
    """Four requests through two slots of the engine (each slot's step
    captured once, then replayed; a reused slot keeps the earlier
    request's keys past its prompt): every step's logits bit-equal to the
    eager ``decode_step`` with the same tensor position on fresh caches,
    fed the same tokens; two captures."""
    from repro_torch.core import programs
    from repro_torch.serve.kv_cache import load_into, zeros_padded
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
    model = Model(cfg)
    params = model.init(0, cuda)
    eng = _LoggedEngine(model, params, EngineConfig(n_slots=2, max_len=64))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 5 + 7 * i) for i in range(4)]
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=p, max_new=6))
    captures = programs.stats["captures"]
    done = {r.req_id: r.out for r in eng.run()}
    assert programs.stats["captures"] - captures == 2
    for i, p in enumerate(prompts):
        toks = torch.as_tensor(p, device=cuda)[None]
        _, pre = model.prefill(params, {"tokens": toks})
        caches = zeros_padded(pre, 64)
        load_into(caches, pre)
        steps = [(pos, lg) for r, pos, lg in eng.steps if r == i]
        assert [pos for pos, _ in steps] == list(range(len(p),
                                                       len(p) + 5))
        for j, (pos, logits) in enumerate(steps):
            want, _ = model.decode_step(
                params, caches, torch.tensor([[done[i][j]]], device=cuda),
                torch.tensor(pos, device=cuda))
            assert torch.equal(logits, want), (i, j)


def test_replays_count_decode_and_router_launches(cuda):
    """Reduced qwen3 (GQA attention and a routed MoE in every layer)
    through the engine: each slot's entry records one ``decode_attention``
    and one ``moe_router`` launch per layer, and the counts over the run
    are exact: the warm-up's launches plus each replay's record."""
    from repro_torch.serve import programs as serve_programs
    cfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"),
                              param_dtype="float32")
    model = Model(cfg)
    params = model.init(0, cuda)
    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=48))
    for i in range(3):
        eng.submit(Request(req_id=i, tokens=np.arange(4 + i) % cfg.vocab,
                           max_new=5))
    d0, r0 = decode_attention.launches, moe_router.launches
    eng.run()
    torch.cuda.synchronize()
    n = chip_smoke.layer_counts(cfg)
    decoded = 3 * 4
    assert decode_attention.launches - d0 == n["attn"] * decoded
    assert moe_router.launches - r0 == n["moe"] * (3 + decoded)
    entries = [e for e in serve_programs.DECODE_STEP._entries.values()
               if e.key[0] is model]
    assert len(entries) == 2
    assert all(e.launches == {decode_attention: n["attn"],
                              moe_router: n["moe"]} for e in entries)


def test_slots_share_a_pool_and_capture_again_after_release(cuda):
    """An engine's slots capture into one memory pool; ``release`` drops
    their caches and graphs (the pool with them), and the next requests
    allocate and capture again, giving the same tokens."""
    from repro_torch.core import programs
    from repro_torch.serve import programs as serve_programs
    cfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"),
                              param_dtype="float32")
    model = Model(cfg)
    eng = Engine(model, model.init(0, cuda), EngineConfig(n_slots=2,
                                                          max_len=48))
    runs = []
    for _ in range(2):
        for i in range(3):
            eng.submit(Request(req_id=i, tokens=np.arange(5 + 3 * i)
                               % cfg.vocab, max_new=5))
        captures = programs.stats["captures"]
        runs.append({r.req_id: r.out for r in eng.run()})
        eng.done.clear()
        assert programs.stats["captures"] - captures == 2
        entries = [e for e in serve_programs.DECODE_STEP._entries.values()
                   if e.key[0] is model]
        assert len(entries) == 2
        assert entries[0].graph.pool() == entries[1].graph.pool()
        eng.release()
        assert not [e for e in serve_programs.DECODE_STEP._entries.values()
                    if e.key[0] is model]
    assert runs[0] == runs[1]


# ------------- the trainer's step as a CUDA graph (per state tree) ----------


def _train_pair(cfg, kind="adamw", n_micro=1, device="cuda"):
    """A trainer's compiled step and the eager ``make_train_step``, each
    with its own copy of the same seeded params and zero state."""
    from repro_torch.train.trainer import TrainConfig, make_train_step
    ocfg = Opt.OptConfig(kind=kind, lr=3e-3, warmup_steps=5,
                         total_steps=100)
    tcfg = TrainConfig(n_micro=n_micro)
    tr = Trainer(Model(cfg), mesh=None, opt_cfg=ocfg, tcfg=tcfg,
                 device=device)
    params = tr.model.init(0, device)
    mine = convert.tree_map(torch.clone, params)
    return (tr, params, Opt.init(ocfg, params), mine, Opt.init(ocfg, mine),
            make_train_step(tr.model, ocfg, tcfg))


def _state_tensors(state) -> list:
    return [t for t in convert.leaves(state) if t is not None]


def _hold_replays(cfg, kind="adamw", n_micro=1, steps=3):
    """``steps`` compiled steps (the warm-up, the capture, then replays)
    against as many eager steps: every loss, param and moment bit for
    bit; one capture, ``steps - 1`` replays, and the kernel launches of
    the run equal to ``steps`` times what one replay records."""
    from repro_torch.core import programs
    from repro_torch.train import programs as train_programs
    tr, p, s, q, t, eager = _train_pair(cfg, kind, n_micro)
    step = tr.compile_step()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4), device="cuda")
    batches = [_with_patches(cfg, data.batch(i), i) for i in range(steps)]
    captures, replays = programs.stats["captures"], programs.stats["replays"]
    chip_smoke.reset_launches()
    got = [step(p, s, b)[2]["loss"] for b in batches]
    torch.cuda.synchronize()
    launches = chip_smoke.kernel_launches()
    want = []
    for b in batches:       # the eager step returns a fresh step counter
        q, t, m = eager(q, t, b)
        want.append(m["loss"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(convert.leaves(p),
                                                 convert.leaves(q)))
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(s),
                                                 _state_tensors(t)))
    assert programs.stats["captures"] - captures == 1
    assert programs.stats["replays"] - replays == steps - 1
    entries = [e for e in train_programs.TRAIN_STEP._entries.values()
               if e.key[0] is tr.model]
    assert len(entries) == 1
    record = {w.__name__: n for w, n in entries[0].launches.items()}
    assert {k: v for k, v in launches.items() if v} == {
        k: steps * v for k, v in record.items()}
    # a step of n_micro microbatches launches what n_micro steps of one do
    per_step = chip_smoke.train_launches(cfg, n_micro)
    assert record == {k: v for k, v in per_step.items() if v}
    return entries[0]


@pytest.mark.parametrize("arch,kind,n_micro", [
    ("yi-6b", "adamw", 1), ("qwen3-moe-30b-a3b", "adamw", 1),
    ("deepseek-v3-671b", "adamw", 1), ("falcon-mamba-7b", "adamw", 1),
    ("internvl2-26b", "adamw", 1), ("seamless-m4t-large-v2", "adamw", 1),
    ("jamba-1.5-large-398b", "adamw", 1),
    ("qwen3-moe-30b-a3b", "adafactor", 2),
    ("falcon-mamba-7b", "adafactor", 1), ("yi-6b", "adamw", 2)])
def test_reduced_train_replays_equal_the_eager_step(cuda, arch, kind,
                                                    n_micro):
    """Reduced fp32 configs of each family: the trainer's compiled step
    (one capture a state tree) bit-equal to the eager step, its launches
    counted through the replays (``n_micro`` forwards and recomputations
    a step)."""
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
    entry = _hold_replays(cfg, kind, n_micro)
    assert entry.pool_bytes > 0 and entry.capture_ms > 0


@pytest.mark.parametrize("mode", ["thread_local", "global"])
def test_the_train_capture_records_the_backward_in_either_mode(
        cuda, mode, monkeypatch):
    """Autograd's backward runs on its own device thread: in either
    stream-capture mode its launches land in the captured graph and its
    allocations in the graph's pool, so the replays equal the eager
    step (the SSM's and the MoE layers' kernels, in the backward too)."""
    real = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(self, *a, **k):
        k["capture_error_mode"] = mode
        return real(self, *a, **k)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    for arch in ("qwen3-moe-30b-a3b", "falcon-mamba-7b"):
        cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
        _hold_replays(cfg)


def test_a_train_capture_that_fails_raises(cuda, monkeypatch):
    """A step that reads a value to the host inside its forward cannot be
    captured: the first call raises after its eager warm-up, nothing
    falls back, and the card works afterwards."""
    from repro_torch.models import moe as Moe
    from repro_torch.train import programs as train_programs
    real = Moe.grouped_ffn

    def reads(x, idx, *a, **k):
        int(idx.sum())
        return real(x, idx, *a, **k)

    monkeypatch.setattr(Moe, "grouped_ffn", reads)
    cfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"),
                              param_dtype="float32")
    tr, p, s, *_ = _train_pair(cfg)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                   global_batch=2), device="cuda").batch(0)
    with pytest.raises(RuntimeError):
        tr.compile_step()(p, s, batch)
    entries = [e for e in train_programs.TRAIN_STEP._entries.values()
               if e.key[0] is tr.model]
    assert [e.graph for e in entries] == [None]
    assert float((torch.ones(3, device=cuda) * 2).sum()) == 6.0


def test_the_loss_draws_no_random_numbers_on_the_card(cuda):
    from repro_torch.train.trainer import value_and_grad
    for arch in ("yi-6b", "falcon-mamba-7b", "seamless-m4t-large-v2"):
        cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
        model = Model(cfg)
        params = model.init(0, cuda)
        batch = _with_patches(cfg, SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=16, global_batch=2),
            device="cuda").batch(0), 0)
        before = torch.cuda.get_rng_state()
        loss, _ = value_and_grad(model, params, batch)
        assert torch.isfinite(loss)
        assert torch.equal(torch.cuda.get_rng_state(), before)
