#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of START on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py

Run from the repository root, on a machine with the card and ``nvcc``.
Phases:

1. environment: a CUDA card, TF32 and bf16 reduced-precision reductions
   off, the card's name and power limit;
2. build: every CUDA kernel of the port (``lstm_cell``,
   ``flash_attention``, ``decode_attention``, ``moe_router``,
   ``mamba_scan`` with its backward), from the sources in the checkout,
   one ``nvcc`` per source, all started together;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the JAX test sweep's shapes and its path's shapes, and timed
   beside the plain version and the PyTorch yardstick
   (``torch.lstm_cell``, ``scaled_dot_product_attention``, and for the
   router ``softmax`` + ``topk`` + renormalisation, since no one call
   computes it; no PyTorch call computes the selective scan or its
   gradient); the scan's backward kernel also against autograd through
   the plain scan, against a second call bit for bit, and timed beside
   it; the attention rows also print TFLOP/s and the share of the bound;
   the LSTM cell, decode attention, the router and the scan's backward
   also print their profiler device time per launch at the path's shapes,
   beside the bound and the floor of a launch (``torch.cuda._sleep(0)``,
   a kernel that spins 0 cycles); bf16 decode attention must also lie
   within half a
   bf16 ulp of the fp32 plain version, which a control with P rounded to
   one bf16 must fail;
4. the decision slice: ``STARTController`` at the paper's width (400
   hosts x 11 features, 10 tasks per job, horizon 5), fed seeded
   telemetry, in both triggers, on the card and on the CPU from the same
   weights: E_S agrees within the Tier-1 bound, actions agree, every
   LSTM cell of the card's run went through the kernel, one staged copy
   per warm interval; then the warm ms per interval for each batch
   bucket, and the device's busy ms per interval and the cell's device
   time per launch (beside its bound and the floor) at 1, 16 and 256
   jobs;
5. START training and simulation at the paper's width: the warmup
   (``collect_training_data(SimConfig(seed=7))``, 400 hosts x 288
   intervals); a training gate in fp32 on the card, three ``train_step``s
   of 64 (lr 1e-3) through the kernel, 10 ``lstm_cell`` launches a step,
   each loss within 1e-5 relative of the same loss through the plain cell
   (autograd of the plain version) from the same params, and step 1's
   gradients within 1e-5 relative in norm; then ``pretrain``'s fit (30
   epochs) on the card, warm ms per ``train_step`` split into forward,
   backward and Adam, and a profiled step (device busy, device ops, the
   cell's share); then the trained ``START`` and ``STARTEager`` on
   planetlab and overload at 400 hosts (288 intervals, arrival rate 1.2),
   each on the card and on the CPU from the same params in lockstep:
   E_S and the predicted straggler count within the Tier-1 bound every
   interval, the action streams equal up to their first difference,
   which must involve a boundary job, 10 ``lstm_cell`` launches an
   interval that predicts; warm ms per interval and each run's summary;
6. the paper's technique comparison at the paper's width (400 hosts x
   288 intervals, arrival rate 1.2, planetlab): IGRU-SD's training gate
   (three fp32 ``_gru_step``s on the sweep's seed-9 warmup on the card,
   each loss within 1e-5 relative of the same steps on the CPU from the
   same init); ``pretrain_igru`` (40 epochs, the sweep's) and the
   trained IGRU-SD on the card and on the CPU in lockstep on planetlab
   and overload (predictions within the Tier-1 bound every interval,
   the predicted straggler count equal up to tasks at the 1.5
   threshold, the action streams equal up to a first difference that
   involves a boundary task), and the GRU's host ms and device busy per
   call; ``sweep.run`` over the 14 techniques of ``FIELD``, seed 0,
   serially (the QoS keys and ms per interval of each; every START cell
   launches ``lstm_cell`` 10 times per interval that predicts); and a
   2-worker ``sweep.run`` of start, igru-sd and grass x seeds (0, 1)
   bit-equal, field by field, to the serial run;
7. LM serving, fp32: yi-6b at full width and depth (seeded weights),
   ``Engine(n_slots=4, max_len=4096)`` serving 6 seeded requests
   (prompts of 12 to 3000 tokens, 16 new tokens each); every prefill
   launches ``flash_attention`` once per layer and every decoded token
   ``decode_attention`` (one kernel) once per layer; the same token
   streams re-run under teacher forcing through the plain attention
   functions agree within 1e-4 on every step's logits, with equal greedy
   tokens except where the plain path's top-2 margin is under 1e-4;
8. LM serving, bf16 (the config's own dtype): the same requests, timed
   (TTFT per prompt length, warm decode ms per token, tokens/s), drift
   against the plain path, profiler device busy per token, and the
   serving entry point ``repro_torch.launch.serve`` once at yi-6b;
9. MoE serving, fp32: qwen3-moe-30b-a3b at full width, 12 of its 48
   layers (seeded weights), the same engine and requests; every MoE
   layer launches ``moe_router`` once per prefill and per decoded token;
   the teacher-forced re-run takes the plain attention and the plain
   router.  Routing may differ only where the plain path's k-th and
   (k+1)-th probabilities nearly tie (a hidden state moved by ~1e-6 can
   swap them); each request's logits are held to 1e-4, and its greedy
   tokens as in phase 7, on every step before its first routing
   difference;
10. MoE serving, bf16: qwen3-moe-30b-a3b at full width and depth, timed
   as in phase 8, with the routing differences counted, and
   ``repro_torch.launch.serve`` once at qwen3-moe-30b-a3b;
11. SSM training, fp32: falcon-mamba-7b at full width, 8 of its 64
   layers (seeded weights), three AdamW steps of ``Trainer`` on
   ``SyntheticLM`` batches of 2 x 256 tokens, every layer's forward and
   its recompute in the backward launching ``mamba_scan`` and its
   backward ``mamba_scan_bwd``; then from the params before each step the
   same loss through the plain scan (autograd of the plain version),
   within 1e-5 relative, and step 1's gradients within 1e-4 relative in
   norm;
12. SSM training, bf16: falcon-mamba-7b at full width, 32 of its 64
   layers, batches of 4 x 512 tokens, one warm step and three timed (ms
   per step, tokens/s), one step by its parts (forward / backward /
   optimizer, and the scan backward's share timed inside it),
   profiler device busy per step, peak memory; and
   ``repro_torch.launch.train`` once, reduced, on the card;
13. summary: one JSON line of kernel numbers, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Each phase prints its wall time.

Any failed check raises, so the script exits non-zero and prints no
result.  Without a CUDA card it exits non-zero in phase 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_default import PAPER  # noqa: E402
from repro_torch.core import encoder_lstm as net  # noqa: E402
from repro_torch.core import features  # noqa: E402
from repro_torch.core.start import STARTController  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    LAUNCHES_PER_CALL)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    BF16_EXCESS, bf16_rounding_excess)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.kernels.lstm_cell import (  # noqa: E402
    lstm_cell, lstm_cell_ref)
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_scan, mamba_scan_bwd, mamba_scan_bwd_ref, mamba_scan_ref,
    scan_states_ref)
from repro_torch.kernels.mamba_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.moe_router import (  # noqa: E402
    moe_router, moe_router_ref)
from repro_torch.launch import serve as serve_entry  # noqa: E402
from repro_torch.launch import train as train_entry  # noqa: E402
from repro_torch.models import backend  # noqa: E402
from repro_torch.models.lm import Model, full_precision  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine, EngineConfig, Request)
from repro_torch.serve.kv_cache import pad_to_length  # noqa: E402
from repro_torch.sim.config import SimConfig  # noqa: E402
from repro_torch.sim.engine import Simulation  # noqa: E402
from repro_torch.sim import sweep  # noqa: E402
from repro_torch.sim.scenarios import make_config  # noqa: E402
from repro_torch.sim.techniques import FIELD  # noqa: E402
from repro_torch.sim.techniques import baselines, start_tech  # noqa: E402
from repro_torch.train import optimizer as Opt  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.trainer import Trainer, value_and_grad  # noqa: E402

# (batch, n_in, hidden): the JAX package's kernel sweep
# (tests/test_kernels.py LSTM_SWEEP) and the paths' cell shapes: the
# decision's job buckets 1, 16 and 256, and START training's batch of 64
LSTM_SWEEP = [(8, 32, 32), (130, 32, 32), (64, 128, 64)]
PATH_SHAPES = [(1, 32, 32), (16, 32, 32), (64, 32, 32), (256, 32, 32)]
# fp32: max abs; bf16: the sweep's allclose tolerance
TOL = {torch.float32: dict(rtol=0.0, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
TIER1_REL, TIER1_ABS_FLOOR = 1e-5, 1e-6     # tests/tolerance.py

# H100 SXM published peaks (NVIDIA data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# paper Table 3 machine types: (cores, ram GB, disk GB, bw, power_max W,
# cost per interval, mix weight)
HOST_TYPES = [(2, 6.0, 320.0, 1.0, 273.0, 3.0, 12),
              (4, 4.0, 160.0, 1.5, 250.0, 4.0, 6),
              (4, 2.0, 160.0, 2.0, 240.0, 5.0, 2)]
# active jobs per interval: every batch bucket 1..256, 4 intervals each
BACKLOG = [1, 2, 3, 5, 8, 16, 24, 64, 100, 256]
INTERVALS_PER_STEP = 4
TIMED_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256]
PROFILED_BUCKETS = (1, 16, 256)     # the cell's batch is the job bucket
SEED = 0
# the `start` policy's adaptive k (sim/techniques/start_tech.py): k_lo on
# an idle cluster up to the paper's k = 1.5 at saturation
K_LO, K_HI = 1.0, PAPER["k"]
REPLACES = "src/repro/kernels/lstm_cell/lstm_cell.py:23"
SOURCE = "src/repro_torch/kernels/lstm_cell/csrc/lstm_cell.cu"

# (b, h, hkv, s, d, causal): the JAX package's flash sweep
# (tests/test_kernels.py FLASH_SWEEP), then yi-6b's prefill shapes
FLASH_SWEEP = [(1, 4, 4, 128, 64, True), (1, 4, 2, 256, 64, True),
               (2, 8, 1, 128, 128, True), (1, 2, 2, 192, 64, False),
               (1, 4, 2, 100, 128, True)]
FLASH_PATH = [(1, 32, 4, s, 128, True) for s in (12, 512, 2048, 3000)]
# timed: bf16 (the tensor-core kernel) at both long prefills, fp32 (the
# CUDA-core kernel) at 2048
FLASH_TIMED = {(2048, torch.bfloat16), (2048, torch.float32),
               (3000, torch.bfloat16)}
# (b, h, hkv, s, d, kv_len): the JAX decode sweep (DECODE_SWEEP), then
# yi-6b's decode shapes against a 4096-long cache
DECODE_SWEEP = [(1, 4, 4, 512, 64, 512), (2, 8, 2, 1024, 128, 700),
                (1, 16, 2, 512, 128, 512), (1, 4, 1, 300, 64, 300)]
DECODE_PATH = [(1, 32, 4, 4096, 128, n) for n in (1, 28, 513, 3016, 4096)]
DECODE_PROFILED = (28, 513, 3016, 4096)   # device time per launch
# fp32: max abs; bf16: the sweep's allclose tolerance
ATTN_TOL = {torch.float32: dict(rtol=0.0, atol=2e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# bf16 decode is held tighter as well: within half a bf16 ulp of the fp32
# plain version on the same inputs, plus BF16_EXCESS (2^-16) of the
# largest |output| (bf16_rounding_excess).  At every path shape past one
# key a control with P rounded to one bf16 before P.V must fail it.
BF16_FLOP_PER_S = 989e12     # dense tensor-core peak
FLASH = dict(source="src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py"
             ":36")
DECODE = dict(source="src/repro_torch/kernels/decode_attention/csrc/"
              "decode_attention.cu",
              replaces="src/repro/kernels/decode_attention/"
              "decode_attention.py:25")

# (tokens, experts, k): the JAX router sweep (tests/test_kernels.py
# ROUTER_SWEEP), then qwen3-moe-30b-a3b's router shapes (one decoded
# token, the shortest and the longest prompt)
ROUTER_SWEEP = [(256, 8, 2), (512, 128, 8), (300, 256, 8), (64, 16, 2)]
ROUTER_PATH = [(t, 128, 8) for t in (1, 12, 3000)]
ROUTER_ATOL = 1e-6           # weights, taken expert by expert, max abs
ROUTER = dict(source="src/repro_torch/kernels/moe_router/csrc/moe_router.cu",
              replaces="src/repro/kernels/moe_router/moe_router.py:24")

# LM serving: yi-6b at full width and depth, seeded weights
LM_ARCH = "yi-6b"
PROMPT_LENS = [12, 64, 300, 1000, 2048, 3000]
MAX_NEW, N_SLOTS, MAX_LEN = 16, 4, 4096
LOGIT_TOL = 1e-4             # fp32 engine vs plain path, max abs
DEVICE = "cuda"
# MoE serving: qwen3-moe-30b-a3b at full width; the fp32 gate keeps 12 of
# its 48 layers (8.1 B params, 32.4 GB: all 48 in fp32 are 122 GB)
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_GATE_LAYERS = 12
NEAR_TIE = 1e-5              # k-th vs (k+1)-th probability, relative
# (b, l, d, n): the JAX scan sweep (tests/test_kernels.py MAMBA_SWEEP),
# ragged shapes, then falcon-mamba-7b's training shapes (B x L x d_inner
# x N) of the fp32 gate and of the timed run
SCAN_SWEEP = [(1, 64, 128, 16), (2, 128, 64, 16), (1, 96, 256, 8),
              (3, 77, 200, 5), (1, 1, 3, 1), (2, 33, 129, 32)]
SCAN_PATH = [(2, 256, 8192, 16), (4, 512, 8192, 16)]
# fp32: 1e-5 of max(1, |y|): the states agree bit for bit and y's N-sum
# runs in another order, which moves y by an ulp of |y|, and |y| grows
# with L (an fp32 ulp is 1.5e-5 at |y| = 128); bf16: the fp32 y (its
# states from ex2.approx, ~1e-6 of themselves off) rounds to a bf16 value
# at most one ulp (2^-7 = 0.78% of |y|) away, so 1e-2 of |y|, plus 1e-3
# for fp32 sums that cancel to near 0
SCAN_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}
SCAN = dict(source="src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
            replaces="src/repro/kernels/mamba_scan/mamba_scan.py:31")
# the backward has no Pallas kernel: it replaces the custom VJP's _bwd,
# jax.vjp of the plain version
SCAN_BWD = dict(source=SCAN["source"],
                replaces="src/repro/kernels/mamba_scan/ops.py:44")
# gradients of the backward kernel against a plain version, per input,
# relative to the plain one's norm and to its largest element.  fp32: 1e-5
# (the states agree bit for bit; the sums over d, n, t and b run in
# another order).  bf16: du, ddelta, dB, dC are rounded to bf16 from fp32
# sums in another order, from ex2.approx states, so an element may land
# one bf16 ulp (2^-8 of itself) away: 2^-7 of the largest, 1e-3 in norm.
GRAD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2**-7)}
# special-function (ex2) results: 16 per clock per SM (NVIDIA's CUDA C++
# Programming Guide, compute capability 9.0) x 132 SMs x 1.98 GHz boost
SFU_PER_S = 16 * 132 * 1.98e9
# SSM training: falcon-mamba-7b at full width; the fp32 gate keeps 8 of
# 64 layers (1.38 B params x 16 B of params, grads and moments = 22 GB),
# the bf16 run 32 (3.91 B params x 12 B = 47 GB; 64 layers need 87 GB)
SSM_ARCH = "falcon-mamba-7b"
SSM_GATE_LAYERS, SSM_GATE_BATCH, SSM_GATE_SEQ = 8, 2, 256
SSM_LAYERS, SSM_BATCH, SSM_SEQ = 32, 4, 512
SSM_STEPS = 3
# OptConfig's default lr (3e-4) and launch.train's warmup rule (5 steps)
SSM_OPT = dict(warmup_steps=5, total_steps=100)
# the port's kernels by their names in a profiler trace
OUR_KERNELS = ("flash_wgmma_kernel", "flash_attention_kernel",
               "decode_kernel", "router_kernel", "scan_kernel",
               "scan_bwd_kernel", "scan_bwd_reduce_kernel")


# --------------------------------- phase 1 ---------------------------------

def environment() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[env] {torch.cuda.get_device_name(0)} "
          f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}, "
          f"{torch.cuda.device_count()} visible")
    return smi


# --------------------------------- phase 3 ---------------------------------

def cell_inputs(bsz, n_in, hid, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x, h, c = (torch.randn(bsz, d, generator=g) for d in (n_in, hid, hid))
    wx = torch.randn(n_in, 4 * hid, generator=g) * 0.2
    wh = torch.randn(hid, 4 * hid, generator=g) * 0.2
    b = torch.randn(4 * hid, generator=g) * 0.1
    return [t.to("cuda", dtype).contiguous() for t in (x, h, c, wx, wh, b)]


def time_ms(fn, reps: int = 500, warmup: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cell_bound(bsz, n_in, hid, elem_bytes) -> tuple[float, str]:
    """Least time for one cell call: each input read once and each output
    written once over HBM, or the fp32 operations over the fp32 peak
    (2 per multiply-add of the two products, 1 per bias add, and 9 per
    cell output for three sigmoids, two tanh and the update)."""
    nbytes = elem_bytes * (bsz * n_in + 2 * bsz * hid + n_in * 4 * hid
                           + hid * 4 * hid + 4 * hid + 2 * bsz * hid)
    ops = 2 * bsz * (n_in + hid) * 4 * hid + bsz * 4 * hid + 9 * bsz * hid
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(floor: float) -> dict:
    """The cell against its plain version at the sweep and path shapes,
    then timed at the path's: per call by CUDA events beside the plain
    version and ``torch.lstm_cell``, and by profiler device time per launch
    beside its bound and ``floor``, the floor of a launch (us)."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (bsz, n_in, hid) in enumerate(LSTM_SWEEP + PATH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            args = cell_inputs(bsz, n_in, hid, dtype, seed=i)
            got = lstm_cell(*args)
            want = lstm_cell_ref(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                g, w = g.float(), w.float()
                if not torch.isfinite(g).all():
                    raise AssertionError("lstm_cell: non-finite output")
                torch.testing.assert_close(g, w, **TOL[dtype])
                err = (g - w).abs().max().item()
                worst[dtype] = max(worst[dtype], err)
            print(f"[kernel] lstm_cell B={bsz} In={n_in} H={hid} "
                  f"{str(dtype)[6:]}: ok")
    print(f"[kernel] max abs err fp32 {worst[torch.float32]:.3e} "
          f"(bound 1e-5), bf16 {worst[torch.bfloat16]:.3e} (bound 2e-2)")

    rows = []
    for bsz, n_in, hid in PATH_SHAPES:
        x, h, c, wx, wh, b = cell_inputs(bsz, n_in, hid, torch.float32, 99)
        w_ih, w_hh = wx.t().contiguous(), wh.t().contiguous()
        zero = torch.zeros_like(b)
        lib = torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zero)
        torch.testing.assert_close(
            lib[0], lstm_cell_ref(x, h, c, wx, wh, b)[0], rtol=0.0, atol=1e-5)
        # alternate kernel and plain so drift in clocks hits both
        k1 = time_ms(lambda: lstm_cell(x, h, c, wx, wh, b))
        p1 = time_ms(lambda: lstm_cell_ref(x, h, c, wx, wh, b))
        p2 = time_ms(lambda: lstm_cell_ref(x, h, c, wx, wh, b))
        k2 = time_ms(lambda: lstm_cell(x, h, c, wx, wh, b))
        lib_ms = time_ms(lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b,
                                                  zero))
        bound_ms, bound_by = cell_bound(bsz, n_in, hid, 4)
        dev_us = launch_us(lambda: lstm_cell(x, h, c, wx, wh, b),
                           "lstm_cell_kernel", reps=40)
        row = dict(batch=bsz, n_in=n_in, hidden=hid, ms=min(k1, k2),
                   plain_ms=min(p1, p2), library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by, device_us=dev_us,
                   floor_us=floor)
        rows.append(row)
        print(f"[kernel] lstm_cell fp32 B={bsz}: kernel {row['ms']:.5f} ms "
              f"(runs {k1:.5f}, {k2:.5f}), plain {row['plain_ms']:.5f} ms, "
              f"torch.lstm_cell {lib_ms:.5f} ms, bound {bound_ms:.7f} ms "
              f"({bound_by}); device {dev_us:.3f} us per launch, "
              f"{bound_ms * 1e3:.4f} us bound, {floor:.3f} us floor of a "
              f"launch")
    return {"worst": worst, "timing": rows}


def time_auto(fn, budget_ms: float = 300.0) -> float:
    """``time_ms`` with as many calls as fit ``budget_ms`` (5 to 500)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    return time_ms(fn, reps=int(min(500, max(5, budget_ms / once))),
                   warmup=2)


def attn_bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time: bytes over HBM, or the products' FLOPs over the peak
    for the I/O type (bf16 tensor cores, fp32 CUDA cores)."""
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_work(b, h, hkv, s, d, causal, elem) -> tuple[float, float]:
    """FLOPs of the two products over the (query, key) pairs the mask
    keeps (4 D each), and bytes of q, k, v read once and o written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return (4.0 * d * pairs * b * h,
            elem * (2 * b * h * s * d + 2 * b * hkv * s * d))


def decode_work(b, h, hkv, d, kv_len, elem) -> tuple[float, float]:
    """FLOPs against the kv_len keys it needs, bytes of q, those keys and
    values, and o."""
    return (4.0 * d * kv_len * b * h,
            elem * (2 * b * h * d + 2 * b * hkv * kv_len * d))


def _compare(name, got, want, dtype, worst, label) -> None:
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(g, w, **ATTN_TOL[dtype])
    worst[dtype] = max(worst[dtype], (g - w).abs().max().item())
    print(f"[kernel] {name} {label} {str(dtype)[6:]}: ok")


def _timing(name, label, kernel, plain, library, dtype, work,
            library_name="sdpa") -> dict:
    """Kernel and plain alternated (so drift in clocks hits both), the
    library call, and the bound."""
    k1, p1 = time_auto(kernel), time_auto(plain)
    p2, k2 = time_auto(plain), time_auto(kernel)
    lib_ms = time_auto(library)
    bound_ms, bound_by = attn_bound(*work, dtype)
    ms = min(k1, k2)
    row = dict(shape=label, dtype=str(dtype)[6:], ms=ms,
               plain_ms=min(p1, p2), library_ms=lib_ms, bound_ms=bound_ms,
               bound_by=bound_by, tflop_s=work[0] / ms / 1e9,
               bound_share=bound_ms / ms)
    print(f"[kernel] {name} {label} {row['dtype']}: kernel {ms:.5f} "
          f"ms (runs {k1:.5f}, {k2:.5f}), {row['tflop_s']:.1f} TFLOP/s, "
          f"{row['bound_share']:.1%} of the bound; plain "
          f"{row['plain_ms']:.5f} ms, {library_name} {lib_ms:.5f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by})")
    return row


def check_flash() -> dict:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = []
    for i, (b, h, hkv, s, d, causal) in enumerate(FLASH_SWEEP + FLASH_PATH):
        label = f"B={b} H={h} Hkv={hkv} S={s} D={d} causal={causal}"
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(100 + i)
            q, k, v = (torch.randn(sh, generator=g).to("cuda", dtype)
                       for sh in ((b, h, s, d), (b, hkv, s, d),
                                  (b, hkv, s, d)))
            want = attention_ref(q, k, v, causal=causal)
            _compare("flash_attention", flash_attention(q, k, v, causal),
                     want, dtype, worst, label)
            if (b, h, hkv, s, d, causal) not in FLASH_PATH \
                    or (s, dtype) not in FLASH_TIMED:
                continue
            lib = sdpa(q, k, v, is_causal=causal, enable_gqa=True)
            torch.testing.assert_close(lib.float(), want.float(),
                                       **ATTN_TOL[torch.bfloat16])
            rows.append(_timing(
                "flash_attention", label,
                lambda: flash_attention(q, k, v, causal),
                lambda: attention_ref(q, k, v, causal=causal),
                lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
                dtype, flash_work(b, h, hkv, s, d, causal,
                                  q.element_size())))
    print(f"[kernel] flash_attention max abs err fp32 "
          f"{worst[torch.float32]:.3e} (bound 2e-5), bf16 "
          f"{worst[torch.bfloat16]:.3e} (bound 2e-2)")
    return {"worst": worst, "timing": rows}


def _device_ops(fn, reps: int) -> dict[str, list]:
    """Kernel (and copy) name -> [device ns, count] over ``reps`` calls of
    ``fn`` under torch.profiler, from the raw kineto events (parsing them
    into ``key_averages`` takes minutes for a training step's ~750 k
    kernels)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            o = ops.setdefault(e.name(), [0, 0])
            o[0] += e.duration_ns()
            o[1] += 1
    return ops


def launch_us(fn, name: str, reps: int = 20) -> float:
    """Mean profiler device time, in us, of one launch of the kernels
    whose name holds ``name``, over ``reps`` warm calls of ``fn``.  A
    window whose trace came back without them (the profiler drops a
    window's device events now and then) is taken again, up to 3 times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        hits = [v for k, v in _device_ops(fn, reps).items() if name in k]
        count = sum(c for _, c in hits)
        if count:
            return sum(t for t, _ in hits) / count / 1e3
    raise AssertionError(f"no launch of {name} in 3 profiles")


def floor_us() -> float:
    """The floor of a launch: ``torch.cuda._sleep(0)``, a one-thread
    kernel that spins 0 cycles."""
    us = launch_us(lambda: torch.cuda._sleep(0), "spin_kernel", reps=40)
    print(f"[kernel] floor of a launch (torch.cuda._sleep(0)): {us:.3f} us "
          f"device")
    return us


def single_bf16_p(q, k, v, kv_len):
    """The bf16 gate's control: decode with P rounded to one bf16 before
    P.V (a tensor-core kernel that keeps no low term of P)."""
    b, h, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    sc = torch.einsum("bhgd,bhkd->bhgk", qg,
                      k[:, :, :kv_len].float()) * d ** -0.5
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    o = torch.einsum("bhgk,bhkd->bhgd", p.bfloat16().float(),
                     v[:, :, :kv_len].float()) / p.sum(-1, keepdim=True)
    return o.reshape(b, h, d).bfloat16()


def check_decode(floor: float) -> dict:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    excess, control = -float("inf"), float("inf")   # bf16 gate readings
    rows, device = [], {}
    for i, (b, h, hkv, s, d, n) in enumerate(DECODE_SWEEP + DECODE_PATH):
        label = f"B={b} H={h} Hkv={hkv} S={s} D={d} kv_len={n}"
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(200 + i)
            q, k, v = (torch.randn(sh, generator=g).to("cuda", dtype)
                       for sh in ((b, h, d), (b, hkv, s, d), (b, hkv, s, d)))
            want = decode_attention_ref(q, k, v, kv_len=n)
            want32 = decode_attention_ref(q.float(), k.float(), v.float(),
                                          kv_len=n)
            if dtype == torch.bfloat16 and n > 1 \
                    and (b, h, hkv, s, d, n) in DECODE_PATH:
                c = bf16_rounding_excess(single_bf16_p(q, k, v, n), want32)
                if not c > BF16_EXCESS:
                    raise AssertionError(
                        f"decode_attention {label}: the bf16 gate passes a "
                        f"single-bf16 P ({c:.3e} <= {BF16_EXCESS:.3e})")
                control = min(control, c)
            k[:, :, n:] = float("nan")     # past kv_len: never read
            v[:, :, n:] = float("nan")
            got = decode_attention(q, k, v, kv_len=n)
            _compare("decode_attention", got, want, dtype, worst, label)
            if dtype == torch.bfloat16:
                e = bf16_rounding_excess(got, want32)
                if not e <= BF16_EXCESS:
                    raise AssertionError(
                        f"decode_attention {label}: bf16 output {e:.3e} of "
                        f"max|o| past half an ulp of the fp32 result "
                        f"(bound {BF16_EXCESS:.3e})")
                excess = max(excess, e)
            if (b, h, hkv, s, d, n) not in DECODE_PATH \
                    or n not in DECODE_PROFILED:
                continue
            us = launch_us(lambda: decode_attention(q, k, v, kv_len=n),
                           "::decode_kernel<")
            bound_ms, bound_by = attn_bound(
                *decode_work(b, h, hkv, d, n, q.element_size()), dtype)
            device[f"{str(dtype)[6:]} kv_len={n}"] = us
            print(f"[kernel] decode_attention {label} {str(dtype)[6:]}: "
                  f"{us:.3f} us device per launch ({us / floor:.2f}x the "
                  f"floor), bound {bound_ms * 1e3:.3f} us ({bound_by}, "
                  f"{bound_ms * 1e3 / us:.1%} of it)")
            if n != DECODE_PATH[-1][-1]:
                continue
            # on the serving path the cache comes cold from memory: 8
            # caches in turn, more than the 50 MB L2 in bf16
            caches = [(k.clone(), v.clone()) for _ in range(8)]
            turn = iter(range(10**9))

            def cold(q=q, n=n, caches=caches, turn=turn):
                kc, vc = caches[next(turn) % len(caches)]
                return decode_attention(q, kc, vc, kv_len=n)

            device[f"{str(dtype)[6:]} kv_len={n} cold"] = us_cold = \
                launch_us(cold, "::decode_kernel<", reps=32)
            print(f"[kernel] decode_attention {label} {str(dtype)[6:]}: "
                  f"{us_cold:.3f} us device per launch with the cache cold "
                  f"(8 caches of {2 * k.numel() * k.element_size() / 1e6:.1f}"
                  f" MB in turn)")
            del caches

            def lib(q=q, k=k, v=v, n=n):
                return sdpa(q[:, :, None], k[:, :, :n], v[:, :, :n],
                            enable_gqa=True)[:, :, 0]

            torch.testing.assert_close(lib().float(), want.float(),
                                       **ATTN_TOL[torch.bfloat16])
            rows.append(_timing(
                "decode_attention", label,
                lambda: decode_attention(q, k, v, kv_len=n),
                lambda: decode_attention_ref(q, k, v, kv_len=n), lib,
                dtype, decode_work(b, h, hkv, d, n, q.element_size())))
    print(f"[kernel] decode_attention max abs err fp32 "
          f"{worst[torch.float32]:.3e} (bound 2e-5), bf16 "
          f"{worst[torch.bfloat16]:.3e} (bound 2e-2)")
    print(f"[kernel] decode_attention bf16 past half an ulp of the fp32 "
          f"result, share of max|o|: kernel {excess:.3e}, single-bf16-P "
          f"control {control:.3e} at least (bound {BF16_EXCESS:.3e})")
    return {"worst": worst, "timing": rows, "device_us": device,
            "bf16_excess": excess, "bf16_control_excess": control}


def router_work(t, e, k, elem) -> tuple[float, float]:
    """fp32 operations (per logit: max, subtract, exp, sum, divide, and
    one compare per round; per chosen weight: add and divide) and bytes
    of the logits read once and the weights and indices written once."""
    return (float(t * e * (5 + k) + 2 * t * k), float(t * e * elem + t * k * 8))


def router_library(logits, k):
    """The PyTorch yardstick, three calls: softmax, topk, renormalise."""
    w, idx = torch.topk(torch.softmax(logits.float(), dim=-1), k)
    return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-20), idx


def _by_expert(w, idx):
    """Each row's (weights, indices) sorted by expert index."""
    idx, order = torch.sort(idx.long(), dim=-1)
    return torch.gather(w, -1, order), idx


def _compare_routing(label, got, want, worst, dtype) -> None:
    """Index sets equal (order-insensitive, as the JAX test compares),
    weights within ROUTER_ATOL expert by expert, rows summing to 1."""
    torch.cuda.synchronize()
    gw, gi = _by_expert(*got)
    ww, wi = _by_expert(*want)
    if not torch.isfinite(got[0]).all():
        raise AssertionError(f"moe_router {label}: non-finite weights")
    if not torch.equal(gi, wi):
        rows = (gi != wi).any(-1).nonzero()[:5, 0].tolist()
        raise AssertionError(f"moe_router {label}: index sets differ in "
                             f"rows {rows}")
    err = (gw - ww).abs().max().item()
    if not err <= ROUTER_ATOL:
        raise AssertionError(f"moe_router {label}: weights differ by {err}")
    torch.testing.assert_close(got[0].sum(-1), torch.ones_like(got[0][:, 0]),
                               rtol=1e-5, atol=1e-5)
    worst[dtype] = max(worst[dtype], err)


def check_router(floor: float) -> dict:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows, device = [], {}
    for i, (t, e, k) in enumerate(ROUTER_SWEEP + ROUTER_PATH):
        label = f"T={t} E={e} k={k}"
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(300 + i)
            logits = torch.randn(t, e, generator=g).to("cuda", dtype)
            want = moe_router_ref(logits, k)
            _compare_routing(label, moe_router(logits, k), want, worst, dtype)
            print(f"[kernel] moe_router {label} {str(dtype)[6:]}: ok")
            if (t, e, k) not in ROUTER_PATH or dtype != torch.float32:
                continue
            us = launch_us(lambda: moe_router(logits, k), "::router_kernel<")
            bound_ms, bound_by = attn_bound(
                *router_work(t, e, k, logits.element_size()), dtype)
            device[f"T={t}"] = us
            print(f"[kernel] moe_router {label} fp32: {us:.3f} us device per "
                  f"launch ({us / floor:.2f}x the floor), bound "
                  f"{bound_ms * 1e3:.4f} us ({bound_by})")
            if (t, e, k) != ROUTER_PATH[-1]:
                continue
            _compare_routing(f"{label} (library)", router_library(logits, k),
                             want, {dtype: 0.0}, dtype)
            rows.append(_timing(
                "moe_router", label, lambda: moe_router(logits, k),
                lambda: moe_router_ref(logits, k),
                lambda: router_library(logits, k), dtype,
                router_work(t, e, k, logits.element_size()),
                library_name="softmax+topk+renorm"))
    # exact ties: the lower expert index wins, in the order chosen
    for e, k in ((128, 8), (8, 2), (16, 4)):
        ties = torch.zeros(4, e)
        ties[1, [e - 1, 3, e // 2]] = 2.0           # three tied maxima
        ties[2] = torch.arange(e) % 4                # groups of ties
        ties[3, :k + 1] = 1.0                        # a tie across the cut
        for dtype in (torch.float32, torch.bfloat16):
            x = ties.to("cuda", dtype)
            w, idx = moe_router(x, k)
            wr, ir = moe_router_ref(x, k)
            torch.cuda.synchronize()
            if not (torch.equal(idx, ir) and idx[0].tolist() == list(range(k))
                    and idx[1, :3].tolist() == [3, e // 2, e - 1][:k]
                    and idx[3].tolist() == list(range(k))):
                raise AssertionError(f"moe_router ties E={e} k={k}: "
                                     f"{idx.tolist()} vs {ir.tolist()}")
            worst[dtype] = max(worst[dtype], (w - wr).abs().max().item())
        print(f"[kernel] moe_router exact ties E={e} k={k}: lower index "
              f"first, as the plain version")
    # probabilities that underflow to 0, k above the nonzero ones: the
    # lowest unchosen index among the zeros comes next
    rows_u = torch.full((4, 128), -200.0)
    rows_u[0, 5] = 0.0
    rows_u[1, [70, 3]] = 0.0
    rows_u[2, [9, 100, 127]] = torch.tensor([0.0, -1.0, -2.0])
    rows_u[3] = -300.0
    rows_u[3, 64] = 0.0
    want_u = [[5, 0, 1, 2, 3, 4, 6, 7], [3, 70, 0, 1, 2, 4, 5, 6],
              [9, 100, 127, 0, 1, 2, 3, 4], [64, 0, 1, 2, 3, 4, 5, 6]]
    for dtype in (torch.float32, torch.bfloat16):
        x = rows_u.to("cuda", dtype)
        w, idx = moe_router(x, 8)
        wr, ir = moe_router_ref(x, 8)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ir) and idx.tolist() == want_u):
            raise AssertionError(f"moe_router underflowed zeros: "
                                 f"{idx.tolist()} vs {ir.tolist()}")
        worst[dtype] = max(worst[dtype], (w - wr).abs().max().item())
    print("[kernel] moe_router underflowed zeros: the lowest unchosen index "
          "first, as the plain version")
    print(f"[kernel] moe_router max abs weight err fp32 "
          f"{worst[torch.float32]:.3e}, bf16 inputs "
          f"{worst[torch.bfloat16]:.3e} (bound {ROUTER_ATOL})")
    return {"worst": worst, "timing": rows, "device_us": device}


def scan_inputs(b, l, d, n, dtype, seed):
    """The JAX sweep's distributions (``test_mamba_scan_sweep``): u, b, c
    normal, delta a softplus of a normal, a = -exp(normal), skip normal;
    u, delta, b, c in ``dtype``, a and skip fp32, on the card."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(b, l, d, generator=g)
    delta = torch.nn.functional.softplus(torch.randn(b, l, d, generator=g))
    a = -torch.exp(torch.randn(d, n, generator=g))
    bm, cm = (torch.randn(b, l, n, generator=g) for _ in range(2))
    skip = torch.randn(d, generator=g)
    u, delta, bm, cm = (t.to("cuda", dtype) for t in (u, delta, bm, cm))
    return [u, delta, a.to("cuda"), bm, cm, skip.to("cuda")]


def scan_bound(b, l, d, n, elem) -> tuple[float, str]:
    """Least time for one scan: u, delta, b, c read once and y written
    once over HBM; or its operations, the larger of its fp32 multiplies
    and adds (6 per state per step, 3 per channel per step) over the fp32
    peak and its b*l*d*n exponentials over the special-function rate."""
    nbytes = elem * (3 * b * l * d + 2 * b * l * n) + 4 * (d * n + d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(b * l * d * (6 * n + 3) / FP32_FLOP_PER_S,
                b * l * d * n / SFU_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_scan() -> dict:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_rel = dict(worst)
    rows = []
    for i, (b, l, d, n) in enumerate(SCAN_SWEEP + SCAN_PATH):
        label = f"B={b} L={l} D={d} N={n}"
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(b, l, d, n, dtype, seed=400 + i)
            got = mamba_scan(*args)
            want = mamba_scan_ref(*args)
            torch.cuda.synchronize()
            g, w = got.float(), want.float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"mamba_scan {label}: non-finite output")
            torch.testing.assert_close(g, w, **SCAN_TOL[dtype])
            err = (g - w).abs().max().item()
            worst[dtype] = max(worst[dtype], err)
            worst_rel[dtype] = max(worst_rel[dtype], ((g - w).abs() / w.abs(
            ).clamp_min(1.0)).max().item())
            print(f"[kernel] mamba_scan {label} {str(dtype)[6:]}: ok, max "
                  f"abs err {err:.3e} at max |y| {w.abs().max().item():.1f}")
            if (b, l, d, n) not in SCAN_PATH:
                continue
            k1 = time_auto(lambda: mamba_scan(*args))
            p1 = time_auto(lambda: mamba_scan_ref(*args))
            p2 = time_auto(lambda: mamba_scan_ref(*args))
            k2 = time_auto(lambda: mamba_scan(*args))
            bound_ms, bound_by = scan_bound(b, l, d, n, args[0].element_size())
            prof = profile_window(f"mamba_scan {label} {str(dtype)[6:]}",
                                  lambda: mamba_scan(*args), 10)
            dev = prof["kernels"].get("scan_kernel", {}).get("ms")
            row = dict(shape=label, dtype=str(dtype)[6:], ms=min(k1, k2),
                       plain_ms=min(p1, p2), library_ms=None,
                       bound_ms=bound_ms, bound_by=bound_by, device_ms=dev)
            rows.append(row)
            print(f"[kernel] mamba_scan {label} {row['dtype']}: kernel "
                  f"{row['ms']:.5f} ms (runs {k1:.5f}, {k2:.5f}; device "
                  f"{dev} ms per launch), plain {row['plain_ms']:.5f} ms, "
                  f"no PyTorch call computes it, bound {bound_ms:.6f} ms "
                  f"({bound_by})")
    print(f"[kernel] mamba_scan max abs err fp32 {worst[torch.float32]:.3e} "
          f"(bound 1e-5 * max(1, |y|); relative to max(1, |y|) "
          f"{worst_rel[torch.float32]:.3e}), bf16 "
          f"{worst[torch.bfloat16]:.3e} (bound 1e-3 + 1e-2 * |y|)")
    return {"worst": worst, "worst_rel": worst_rel, "timing": rows}


def scan_bwd_bound(b, l, d, n, elem) -> tuple[float, str]:
    """Least time for one scan backward: u, delta, g, b, c and the saved
    chunk states read once, du, ddelta, db, dc, da and dskip written once,
    over HBM; or its operations, the larger of its fp32 multiplies and adds
    (19 per state per step, 8 per channel per step) over the fp32 peak and
    its b*l*d*n exponentials (the chunks stepped again) over the
    special-function rate."""
    chunks = -(-l // scan_ops.CHUNK)
    nbytes = (elem * (5 * b * l * d + 4 * b * l * n)
              + 4 * (b * chunks * d * n + 2 * d * n + 2 * d))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(b * l * d * (19 * n + 8) / FP32_FLOP_PER_S,
                b * l * d * n / SFU_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grad_errors(name, label, got, want, dtype) -> tuple[float, float]:
    """Holds each gradient to GRAD_TOL; returns the largest absolute error
    and the largest error relative to its plain gradient's largest
    element."""
    rel, max_rel = GRAD_TOL[dtype]
    worst = worst_abs = 0.0
    for x, g, w in zip(("u", "delta", "a", "b", "c", "skip"), got, want):
        g, w = g.double(), w.double()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {label}: non-finite d{x}")
        norm = (g - w).norm().item() / max(w.norm().item(), 1e-300)
        top = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-300)
        if not (norm <= rel and top <= max_rel):
            raise AssertionError(f"{name} {label}: d{x} differs by {norm:.3e}"
                                 f" in norm, {top:.3e} of its largest")
        worst = max(worst, top)
        worst_abs = max(worst_abs, (g - w).abs().max().item())
    return worst_abs, worst


def check_scan_bwd(floor: float) -> dict:
    """The forward kernel's chunk states against ``scan_states_ref``, then
    the backward kernels from them against the plain backward (same
    states) and against autograd through the plain scan, and a second call
    against the first, bit for bit; timed at the path's shapes beside both,
    each launch's device time beside the bound and ``floor``, the floor of
    a launch (us)."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_rel = dict(worst)
    rows = []
    for i, (b, l, d, n) in enumerate(SCAN_SWEEP + SCAN_PATH):
        label = f"B={b} L={l} D={d} N={n}"
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(b, l, d, n, dtype, seed=500 + i)
            g = torch.randn(b, l, d, generator=torch.Generator().manual_seed(
                600 + i)).to("cuda", dtype)
            _, states = scan_ops._launch(*args, keep_states=True)
            want_states = scan_states_ref(*args[:4])
            if dtype == torch.float32:
                if not torch.equal(states, want_states):
                    raise AssertionError(f"mamba_scan {label}: fp32 chunk "
                                         f"states differ from the plain ones")
            else:
                torch.testing.assert_close(states, want_states, rtol=1e-4,
                                           atol=1e-4)
            got = mamba_scan_bwd(*args, g, states)
            again = mamba_scan_bwd(*args, g, states)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"mamba_scan_bwd {label}: two calls "
                                     f"gave different gradients")
            del again
            a1, e1 = _grad_errors("mamba_scan_bwd", label, got,
                                  mamba_scan_bwd_ref(*args, g, states), dtype)
            xs = [t.clone().requires_grad_() for t in args]
            auto = torch.autograd.grad(mamba_scan_ref(*xs), xs, g)
            a2, e2 = _grad_errors("mamba_scan_bwd (autograd)", label, got,
                                  auto, dtype)
            del xs, auto
            worst[dtype] = max(worst[dtype], a1, a2)
            worst_rel[dtype] = max(worst_rel[dtype], e1, e2)
            print(f"[kernel] mamba_scan_bwd {label} {str(dtype)[6:]}: ok, "
                  f"largest error / largest gradient {e1:.3e} against the "
                  f"plain backward, {e2:.3e} against autograd; a second "
                  f"call equal bit for bit")
            if (b, l, d, n) not in SCAN_PATH:
                continue

            def plain_autograd(args=args, g=g):
                xs = [t.clone().requires_grad_() for t in args]
                return torch.autograd.grad(mamba_scan_ref(*xs), xs, g)

            k1 = time_auto(lambda: mamba_scan_bwd(*args, g, states))
            p1 = time_auto(lambda: mamba_scan_bwd_ref(*args, g, states))
            p2 = time_auto(lambda: mamba_scan_bwd_ref(*args, g, states))
            k2 = time_auto(lambda: mamba_scan_bwd(*args, g, states))
            auto_ms = time_auto(plain_autograd)
            bound_ms, bound_by = scan_bwd_bound(b, l, d, n,
                                                args[0].element_size())
            prof = profile_window(f"mamba_scan_bwd {label} {str(dtype)[6:]}",
                                  lambda: mamba_scan_bwd(*args, g, states),
                                  10)
            dev = {k: prof["kernels"].get(k, {}).get("ms")
                   for k in ("scan_bwd_kernel", "scan_bwd_reduce_kernel")}
            row = dict(shape=label, dtype=str(dtype)[6:], ms=min(k1, k2),
                       plain_ms=min(p1, p2), autograd_ms=auto_ms,
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                       device_ms=dev, floor_us=floor)
            rows.append(row)
            print(f"[kernel] mamba_scan_bwd {label} {row['dtype']}: device "
                  f"per launch {dev} ms, together "
                  f"{sum(v or 0.0 for v in dev.values()):.5f} ms against the "
                  f"bound {bound_ms:.5f} ms; floor of a launch {floor:.3f} "
                  f"us")
            print(f"[kernel] mamba_scan_bwd {label} {row['dtype']}: kernels "
                  f"{row['ms']:.5f} ms per call (runs {k1:.5f}, {k2:.5f}), "
                  f"plain backward "
                  f"{row['plain_ms']:.3f} ms, autograd through the plain scan "
                  f"(forward re-run and backward) {auto_ms:.3f} ms, no "
                  f"PyTorch call computes it, bound {bound_ms:.6f} ms "
                  f"({bound_by})")
    print(f"[kernel] mamba_scan_bwd largest error / largest gradient fp32 "
          f"{worst_rel[torch.float32]:.3e} (bound 1e-5), bf16 "
          f"{worst_rel[torch.bfloat16]:.3e} (bound 2^-7); max abs err fp32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}")
    return {"worst": worst, "worst_rel": worst_rel, "timing": rows}


# --------------------------------- phase 4 ---------------------------------

class Telemetry:
    """Seeded cluster and job backlog: hosts drawn from the paper's three
    Table-3 machine types, jobs of 2..max_tasks tasks whose tasks finish
    at random.  ``step(n_jobs)`` moves one interval on with ``n_jobs``
    active jobs and returns the controller's inputs for it."""

    def __init__(self, n_hosts: int, max_tasks: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.n_hosts, self.max_tasks = n_hosts, max_tasks
        kinds = self.rng.choice(len(HOST_TYPES), n_hosts,
                                p=np.array([t[6] for t in HOST_TYPES])
                                / sum(t[6] for t in HOST_TYPES))
        spec = np.array([HOST_TYPES[k][:6] for k in kinds], np.float64)
        self.cap = spec[:, :4]
        self.power_max, self.cost = spec[:, 4], spec[:, 5]
        self.base_util = self.rng.uniform(0.05, 0.6, (n_hosts, 4))
        self.jobs: dict[int, dict] = {}
        self.next_job = 0

    def _new_job(self) -> None:
        q = int(self.rng.integers(2, self.max_tasks + 1))
        self.jobs[self.next_job] = dict(
            q=q, deadline=bool(self.rng.random() < 0.5),
            req=self.rng.uniform(0.0, 1.0, (q, 4)).astype(np.float32),
            host=self.rng.integers(0, self.n_hosts, q),
            open=np.ones(q, bool))
        self.next_job += 1

    def step(self, n_jobs: int):
        while len(self.jobs) > n_jobs:
            del self.jobs[min(self.jobs)]
        for j, d in list(self.jobs.items()):
            d["open"] &= self.rng.random(d["q"]) > 0.25
            if not d["open"].any():
                del self.jobs[j]
        while len(self.jobs) < n_jobs:
            self._new_job()
        ids = np.array(sorted(self.jobs), np.int64)
        jobs = [self.jobs[j] for j in ids]
        n_tasks = np.zeros(self.n_hosts)
        for d in jobs:
            np.add.at(n_tasks, d["host"][d["open"]], 1)
        util = np.clip(self.base_util + self.rng.normal(
            0, 0.05, self.base_util.shape), 0.0, 1.0)
        m_h = features.host_matrix_np(util, self.cap, self.cost,
                                      self.power_max, n_tasks)
        counts = np.array([d["q"] for d in jobs])
        rows = np.repeat(np.arange(len(jobs)), counts)
        cols = np.concatenate([np.arange(q) for q in counts])
        m_t = features.task_matrix_batch_np(
            np.concatenate([d["req"] for d in jobs]),
            np.concatenate([d["host"] for d in jobs]),
            rows, cols, len(jobs), self.n_hosts, self.max_tasks)

        def incomplete(job):
            d = self.jobs[int(job)]
            slots = np.nonzero(d["open"])[0]
            return ([int(job) * self.max_tasks + int(s) for s in slots],
                    [int(d["host"][s]) for s in slots],
                    [int(s) for s in slots])

        return dict(
            m_h=m_h, straggler_counts=self.rng.poisson(0.2, self.n_hosts),
            job_ids=ids, m_t=m_t, q=counts.astype(np.float32),
            task_job=lambda tid: tid // self.max_tasks,
            open_counts=np.array([d["open"].sum() for d in jobs]),
            deadline=np.array([d["deadline"] for d in jobs]),
            incomplete_fn=incomplete, host_load=util[:, 0])


def decide(ctrl, tel: dict):
    """One interval of the `start` policy's calls into the controller."""
    ctrl.predictor.k = K_LO + (K_HI - K_LO) * float(tel["host_load"].mean())
    ctrl.observe_hosts(tel["m_h"])
    ctrl.observe_straggler_counts(tel["straggler_counts"])
    return ctrl.decide_arrays(tel["job_ids"], tel["m_t"], tel["q"],
                              tel["open_counts"], tel["deadline"],
                              tel["incomplete_fn"], host_load=tel["host_load"])


def _shares(m_t: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Per-task demand shares, as the predictor's per-task head splits E_S."""
    demand = m_t[..., :4].sum(-1)
    total = demand.sum(-1, keepdims=True)
    uniform = (np.arange(m_t.shape[1])[None] < q[:, None]) / np.maximum(
        q, 1.0)[:, None]
    return np.where(total > 0, demand / np.where(total > 0, total, 1.0),
                    uniform)


def boundary_jobs(ctrl: STARTController, tel: dict, e_s: np.ndarray) -> set:
    """Jobs whose decision may rightly flip between two runs that agree
    within the Tier-1 bound: E_S within the bound of an integer (the
    floor), or, in the per-task trigger, an open task's score within the
    bound of ``score_on`` or of another open task's score (the top-n
    cut)."""
    def tol(v):
        return TIER1_REL * np.maximum(np.abs(v), TIER1_ABS_FLOOR)

    out = set()
    scores = e_s[:, None] * _shares(tel["m_t"], tel["q"])
    for i, job in enumerate(tel["job_ids"]):
        if abs(e_s[i] - np.round(e_s[i])) <= tol(e_s[i]):
            out.add(int(job))
        if ctrl.trigger != "per_task":
            continue
        s = np.sort(scores[i][tel["incomplete_fn"](job)[2]])
        if (np.abs(s - ctrl.score_on) <= tol(s)).any() \
                or (np.diff(s) <= tol(s[1:])).any():
            out.add(int(job))
    return out


def _action_keys(actions) -> list[tuple]:
    return [(a.job_id, a.task_id, a.kind.value, a.target_host, a.source_host)
            for a in actions]


def es_drift(t: int, e_a: np.ndarray, e_b: np.ndarray,
             what: str = "E_S") -> float:
    """Largest relative difference of two runs' ``what`` (E_S unless
    named) at interval ``t``; raises past the Tier-1 bound or on a value
    that is not finite."""
    if not (np.isfinite(e_a).all() and np.isfinite(e_b).all()):
        raise AssertionError(f"interval {t}: {what} not finite")
    if not len(e_a):
        return 0.0
    rel = float((np.abs(np.asarray(e_a, np.float64) - e_b)
                 / np.maximum(np.abs(e_b), TIER1_ABS_FLOOR)).max())
    if rel > TIER1_REL:
        raise AssertionError(f"interval {t}: {what} drift {rel:.3e} > "
                             f"{TIER1_REL}")
    return rel


def hold_decisions(t, ctrl_a, ctrl_b, tel, e_a, keys_a, keys_b) -> int:
    """Hold run b's decision at interval ``t`` against run a's: the
    actions (keys whose first element is the job) and the trigger state
    (streaks, cooldowns, mitigated jobs) equal except for boundary jobs;
    ``tel["task_job"]`` maps a task id to its job.  After a permitted
    difference, b takes a's trigger state so later intervals compare
    like with like.  Returns the number of jobs that differ."""
    differ = {k[0] for k in set(keys_a) ^ set(keys_b)}
    for tid in set(ctrl_a._streak) | set(ctrl_b._streak) \
            | set(ctrl_a._cool) | set(ctrl_b._cool):
        if ctrl_a._streak.get(tid) != ctrl_b._streak.get(tid) \
                or ctrl_a._cool.get(tid) != ctrl_b._cool.get(tid):
            differ.add(int(tel["task_job"](tid)))
    differ |= set(ctrl_a._mitigated) ^ set(ctrl_b._mitigated)
    if differ:
        if not differ <= boundary_jobs(ctrl_a, tel, e_a):
            raise AssertionError(
                f"interval {t}: decisions differ for jobs {sorted(differ)} "
                f"away from any decision boundary")
        ctrl_b._mitigated = set(ctrl_a._mitigated)
        ctrl_b._streak = dict(ctrl_a._streak)
        ctrl_b._cool = dict(ctrl_a._cool)
    return len(differ)


def compare_interval(t, ctrl_a, ctrl_b, tel, acts_a, acts_b) -> dict:
    """Hold run b against run a on one interval: E_S within the Tier-1
    bound, actions and trigger state equal except for boundary jobs
    (:func:`hold_decisions`)."""
    ids = [int(j) for j in tel["job_ids"]]
    e_a = np.array([ctrl_a._es_cache[j] for j in ids], np.float32)
    e_b = np.array([ctrl_b._es_cache[j] for j in ids], np.float32)
    rel = es_drift(t, e_a, e_b)
    flips = hold_decisions(t, ctrl_a, ctrl_b, tel, e_a, _action_keys(acts_a),
                           _action_keys(acts_b))
    return dict(rel=rel, flips=flips)


def run_slice(dev_a: str, dev_b: str, n_hosts: int, max_tasks: int,
              backlog=BACKLOG, per_step: int = INTERVALS_PER_STEP,
              horizon: int = PAPER["horizon"]) -> dict:
    """Both triggers, each run on ``dev_a`` and ``dev_b`` from the same
    weights and telemetry, compared interval by interval."""
    out = {}
    for trigger in ("milestone", "per_task"):
        kw = dict(n_hosts=n_hosts, max_tasks=max_tasks, horizon=horizon,
                  seed=SEED, trigger=trigger)
        ctrl_a = STARTController(device=dev_a, **kw)
        ctrl_b = STARTController(device=dev_b, **kw)
        ctrl_b.predictor.load_params(ctrl_a.predictor.params)
        tel_gen = Telemetry(n_hosts, max_tasks, seed=SEED)
        worst, flips, actions, intervals = 0.0, 0, 0, 0
        for t, n_jobs in enumerate(np.repeat(backlog, per_step)):
            tel = tel_gen.step(int(n_jobs))
            acts_a = decide(ctrl_a, tel)
            acts_b = decide(ctrl_b, tel)
            r = compare_interval(t, ctrl_a, ctrl_b, tel, acts_a, acts_b)
            worst = max(worst, r["rel"])
            flips += r["flips"]
            actions += len(acts_a)
            intervals += 1
        out[trigger] = dict(intervals=intervals, max_rel=worst, flips=flips,
                            actions=actions,
                            h2d_stages=ctrl_a.predictor.h2d_stages)
        print(f"[slice] {trigger}: {intervals} intervals {dev_a} vs {dev_b}, "
              f"E_S max rel drift {worst:.3e}, {actions} actions, "
              f"{flips} boundary flips, "
              f"h2d_stages {out[trigger]['h2d_stages']}")
    return out


def time_buckets(n_hosts: int, max_tasks: int, floor: float,
                 reps: int = 20) -> dict:
    """Warm medians, in host ms per interval at a fixed active-job count
    per bucket, of the whole decision (``decide``), of its prediction
    (the predictor call, which ends in the E_S readback) and of its
    trigger and mitigation planning on the host; then, from a profiled
    window at buckets of 1, 16 and 256 jobs, the device's busy ms per
    interval and the kernel's own device time per launch beside its bound
    and ``floor``, the floor of a launch (us)."""
    out = {}
    for trigger in ("milestone", "per_task"):
        for nb in TIMED_BUCKETS:
            ctrl = STARTController(n_hosts=n_hosts, max_tasks=max_tasks,
                                   horizon=PAPER["horizon"], seed=SEED,
                                   trigger=trigger, device="cuda")
            tel_gen = Telemetry(n_hosts, max_tasks, seed=SEED + nb)
            whole, pred = [], []
            for _ in range(reps + 3):
                tel = tel_gen.step(nb)
                t0 = time.perf_counter()
                decide(ctrl, tel)
                t1 = time.perf_counter()
                tel = tel_gen.step(nb)
                ctrl.observe_hosts(tel["m_h"])
                t2 = time.perf_counter()
                if trigger == "per_task":
                    ctrl.predict_scores_batch(tel["job_ids"], tel["m_t"],
                                              tel["q"])
                else:
                    ctrl.predict_es_batch(tel["job_ids"], tel["m_t"],
                                          tel["q"])
                t3 = time.perf_counter()
                whole.append((t1 - t0) * 1e3)
                pred.append((t3 - t2) * 1e3)
            row = dict(ms=float(np.median(whole[3:])),
                       predict_ms=float(np.median(pred[3:])))
            row["trigger_ms"] = row["ms"] - row["predict_ms"]
            out[f"{trigger}/{nb}"] = row
        print(f"[slice] warm ms/interval {trigger} (bucket: whole = "
              f"predict + trigger): " + ", ".join(
                  f"{nb}: {out[f'{trigger}/{nb}']['ms']:.3f} = "
                  f"{out[f'{trigger}/{nb}']['predict_ms']:.3f} + "
                  f"{out[f'{trigger}/{nb}']['trigger_ms']:.3f}"
                  for nb in TIMED_BUCKETS))
    # profiled last: a profiler run may leave tracing costs behind
    for trigger in ("milestone", "per_task"):
        for nb in PROFILED_BUCKETS:
            ctrl = STARTController(n_hosts=n_hosts, max_tasks=max_tasks,
                                   horizon=PAPER["horizon"], seed=SEED,
                                   trigger=trigger, device="cuda")
            tel_gen = Telemetry(n_hosts, max_tasks, seed=SEED + nb)
            for _ in range(3):
                decide(ctrl, tel_gen.step(nb))
            out[f"{trigger}/{nb}"].update(profile_intervals(ctrl, tel_gen,
                                                            nb, floor))
    return out


def profile_intervals(ctrl, tel_gen, nb: int, floor: float,
                      reps: int = 10) -> dict:
    """Device time of ``reps`` decision intervals under torch.profiler:
    busy ms per interval (every kernel and copy) and the lstm_cell
    kernel's device time per launch, beside its bound at a batch of
    ``nb`` rows (the job bucket) and ``floor``, the floor of a launch
    (us)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            decide(ctrl, tel_gen.step(nb))
        torch.cuda.synchronize()
    busy_us, cell_us, cell_n, n_dev = 0.0, 0.0, 0, 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            busy_us += e.self_device_time_total
            n_dev += e.count
            if "lstm_cell_kernel" in e.key:
                cell_us += e.self_device_time_total
                cell_n += e.count
    bound_ms, _ = cell_bound(nb, *PATH_SHAPES[0][1:], 4)
    out = dict(device_busy_ms=busy_us / 1e3 / reps if busy_us else None,
               device_ops_per_interval=n_dev / reps,
               kernel_device_ms=cell_us / 1e3 / cell_n if cell_n else None,
               kernel_bound_ms=bound_ms, floor_us=floor)
    print(f"[profile] bucket {nb} {ctrl.trigger}: device busy "
          f"{out['device_busy_ms']} ms/interval over "
          f"{out['device_ops_per_interval']} kernels and copies, lstm_cell "
          f"{out['kernel_device_ms']} ms/launch on the device ({cell_n} "
          f"launches; bound {bound_ms * 1e3:.4f} us, floor of a launch "
          f"{floor:.3f} us)")
    return out


# --------------------------------- phase 5 ---------------------------------
# START's training and simulation at the paper's width

TRAIN_BATCH, TRAIN_LR = 64, 1e-3           # start_tech.pretrain's fit
TRAIN_GATE_STEPS = 3
TRAIN_REL = 1e-5         # losses and step-1 gradients, relative (in norm)
TRAIN_TIMED_STEPS = 20
PRETRAIN_EPOCHS = 30
CELLS_PER_STEP = 2 * PAPER["horizon"]      # LSTM layers x horizon
SIM_SCENARIOS = ("planetlab", "overload")
SIM_INTERVALS = 288                        # make_config's paper length
SIM_ARRIVAL = 1.2                          # the paper's Poisson rate


@contextlib.contextmanager
def plain_cell():
    """START's LSTM cells through the plain PyTorch version on the card,
    differentiated by autograd (the kernel's wrapper is not called)."""
    saved = net.lstm_cell
    net.lstm_cell = lstm_cell_ref
    try:
        yield
    finally:
        net.lstm_cell = saved


def start_controller(device: str, params=None) -> STARTController:
    """A controller as ``start_tech.pretrain`` builds it (paper width,
    beta in interval units), holding ``params`` when given."""
    cfg = SimConfig()
    ctrl = STARTController(n_hosts=cfg.n_hosts, max_tasks=cfg.max_tasks,
                           k=cfg.k, seed=SEED,
                           beta_scale=cfg.interval_seconds, device=device)
    if params is not None:
        ctrl.predictor.load_params(params)
    return ctrl


def start_warmup() -> tuple[np.ndarray, np.ndarray]:
    """``collect_training_data`` at the paper's width (``SimConfig``'s
    defaults: 400 hosts, 288 intervals), as ``pretrain`` runs it."""
    cfg = SimConfig(seed=7)
    t0 = time.perf_counter()
    xs, ys = start_tech.collect_training_data(cfg)
    host_s = time.perf_counter() - t0
    if xs.shape[0] != PAPER["horizon"] or xs.shape[1] != ys.shape[0] \
            or xs.shape[2] != features.input_dim(cfg.n_hosts, cfg.max_tasks):
        raise AssertionError(f"warmup data of shapes {xs.shape}, {ys.shape}")
    if not (np.isfinite(xs).all() and np.isfinite(ys).all()):
        raise AssertionError("warmup data not finite")
    print(f"[start] warmup: {cfg.n_hosts} hosts x {cfg.n_intervals} "
          f"intervals, xs {xs.shape}, ys {ys.shape} in {host_s:.3f} s host")
    return xs, ys


def start_train_gate(xs: np.ndarray, ys: np.ndarray) -> dict:
    """fp32 on the card.  The main path: ``TRAIN_GATE_STEPS`` of
    ``train_step`` through the kernel (launch count set to 0 just before
    and read just after, ``CELLS_PER_STEP`` a step).  Then, from the
    params before each step, the same loss through the plain cell (held
    to ``TRAIN_REL`` relative), and step 1's gradients both ways (held to
    ``TRAIN_REL`` relative in norm over the tree)."""
    pred = start_controller(DEVICE).predictor
    xs_d = torch.as_tensor(xs, device=DEVICE)
    ys_d = torch.as_tensor(ys, device=DEVICE)
    rng = np.random.default_rng(SEED)
    batches = [torch.as_tensor(rng.permutation(xs.shape[1])[:TRAIN_BATCH],
                               device=DEVICE)
               for _ in range(TRAIN_GATE_STEPS)]
    params, opt = pred.params, pred.opt
    befores, losses, per_step = [], [], []
    lstm_cell.launches = 0
    for idx in batches:
        befores.append(params)
        n0 = lstm_cell.launches
        params, opt, loss = net.train_step(params, opt, xs_d[:, idx],
                                           ys_d[idx], lr=TRAIN_LR)
        losses.append(float(loss))
        per_step.append(lstm_cell.launches - n0)
    launches = lstm_cell.launches
    if per_step != [CELLS_PER_STEP] * TRAIN_GATE_STEPS:
        raise AssertionError(f"lstm_cell launches per train_step {per_step},"
                             f" expected {CELLS_PER_STEP} each")
    if any(p.requires_grad for p in convert.leaves(params)):
        raise AssertionError("train_step returned params that require grad")
    worst = 0.0
    for i, (p, idx) in enumerate(zip(befores, batches)):
        with plain_cell():
            want, grads_p = net.loss_and_grads(p, xs_d[:, idx], ys_d[idx])
        rel = abs(losses[i] - float(want)) / abs(float(want))
        worst = max(worst, rel)
        if not (np.isfinite(losses[i]) and rel <= TRAIN_REL):
            raise AssertionError(f"train step {i + 1}: loss {losses[i]!r} "
                                 f"against the plain cell's {float(want)!r}")
        if i == 0:
            _, grads_k = net.loss_and_grads(p, xs_d[:, idx], ys_d[idx])
            g_rel, g_worst = tree_rel(grads_k, grads_p)
            if not g_rel <= TRAIN_REL:
                raise AssertionError(f"step-1 gradients {g_rel:.3e} apart "
                                     f"in norm (bound {TRAIN_REL})")
    print(f"[start] training gate fp32: {TRAIN_GATE_STEPS} train_steps of "
          f"{TRAIN_BATCH} through the kernel, losses {losses}; against the "
          f"plain cell: losses within {worst:.3e} relative, step-1 "
          f"gradients {g_rel:.3e} in norm (worst leaf {g_worst:.3e}), bound "
          f"{TRAIN_REL}; lstm_cell launches {per_step} a step")
    return dict(losses=losses, max_rel_loss=worst, grad_rel=g_rel,
                grad_worst_leaf=g_worst, launches=launches)


def _synced(fn):
    """``fn()`` and its host ms, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def start_train_timing(xs: np.ndarray, ys: np.ndarray) -> dict:
    """``pretrain``'s fit on the card (``PRETRAIN_EPOCHS`` epochs), then
    warm ms per ``train_step`` (median of the steps after the first), the
    same step by its parts (forward, backward, Adam), the part of the
    backward a backward kernel for the cell would replace (the cell's
    autograd Function recomputes the plain cell and differentiates it,
    ``CELLS_PER_STEP`` times a step), and one profiled window: device
    busy and device ops per step, the cell's share.  Returns the trained
    params with the numbers."""
    pred = start_controller(DEVICE).predictor
    _, fit_ms = _synced(lambda: pred.fit(xs, ys, epochs=PRETRAIN_EPOCHS,
                                         lr=TRAIN_LR))
    losses = pred.losses
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"fit's epoch losses {losses}")
    steps = PRETRAIN_EPOCHS * (xs.shape[1] // TRAIN_BATCH)
    trained = convert.tree_map(torch.Tensor.clone, pred.params)

    xs_d = torch.as_tensor(xs[:, :TRAIN_BATCH], device=DEVICE)
    ys_d = torch.as_tensor(ys[:TRAIN_BATCH], device=DEVICE)
    state = dict(params=pred.params, opt=pred.opt)

    def step():
        state["params"], state["opt"], loss = net.train_step(
            state["params"], state["opt"], xs_d, ys_d, lr=TRAIN_LR)
        return loss

    whole = [_synced(step)[1] for _ in range(TRAIN_TIMED_STEPS + 1)]
    fwd, bwd, adam = [], [], []
    for _ in range(TRAIN_TIMED_STEPS + 1):
        ps = convert.tree_map(lambda t: t.detach().requires_grad_(),
                              state["params"])
        with torch.enable_grad():
            loss, ms_f = _synced(lambda: net.mse_loss(ps, xs_d, ys_d))
            grads, ms_b = _synced(lambda: torch.autograd.grad(
                loss, convert.leaves(ps)))
        (state["params"], state["opt"]), ms_a = _synced(
            lambda: net.adam_update(state["params"],
                                    convert.unflatten(ps, grads),
                                    state["opt"], lr=TRAIN_LR))
        fwd.append(ms_f)
        bwd.append(ms_b)
        adam.append(ms_a)
    # the Function's backward, CELLS_PER_STEP times at the step's shapes
    g = torch.Generator().manual_seed(SEED)
    args = [t.to(DEVICE) for t in (
        torch.randn(TRAIN_BATCH, n, generator=g) for n in (32, 32, 32))] \
        + [state["params"]["lstm"][0][k] for k in ("wx", "wh", "b")]
    seed_grads = [torch.ones(TRAIN_BATCH, 32, device=DEVICE)] * 2

    def recompute():
        for _ in range(CELLS_PER_STEP):
            xs_c = [t.detach().requires_grad_() for t in args]
            with torch.enable_grad():
                torch.autograd.grad(lstm_cell_ref(*xs_c), xs_c, seed_grads)

    rec = [_synced(recompute)[1] for _ in range(TRAIN_TIMED_STEPS + 1)]
    rec_ops = sum(c for _, c in _device_ops(recompute, 3).values()) / 3
    ops = _device_ops(step, TRAIN_TIMED_STEPS)
    busy = sum(t for t, _ in ops.values()) / 1e6 / TRAIN_TIMED_STEPS
    n_ops = sum(c for _, c in ops.values()) / TRAIN_TIMED_STEPS
    cell = [v for k, v in ops.items() if "lstm_cell_kernel" in k]
    cell_ms = sum(t for t, _ in cell) / 1e6 / TRAIN_TIMED_STEPS
    cell_n = sum(c for _, c in cell) / TRAIN_TIMED_STEPS
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:5]
    out = dict(fit_ms=fit_ms, fit_steps=steps, epochs=PRETRAIN_EPOCHS,
               first_loss=losses[0], last_loss=losses[-1],
               step_ms=float(np.median(whole[1:])),
               forward_ms=float(np.median(fwd[1:])),
               backward_ms=float(np.median(bwd[1:])),
               adam_ms=float(np.median(adam[1:])),
               recompute_ms=float(np.median(rec[1:])),
               recompute_ops=rec_ops,
               device_busy_ms=busy, device_ops=n_ops,
               cell_device_ms=cell_ms, cell_launches=cell_n,
               top=[dict(op=k[:100], ms=t / 1e6 / TRAIN_TIMED_STEPS,
                         calls=c / TRAIN_TIMED_STEPS)
                    for k, (t, c) in top])
    print(f"[start] fit: {PRETRAIN_EPOCHS} epochs, {steps} train_steps of "
          f"{TRAIN_BATCH} in {fit_ms:.1f} ms host ({fit_ms / steps:.3f} ms "
          f"a step); epoch losses {losses[0]:.6f} -> {losses[-1]:.6f}")
    print(f"[start] warm ms per train_step {out['step_ms']:.3f} (median of "
          f"{TRAIN_TIMED_STEPS}): forward {out['forward_ms']:.3f} + "
          f"backward {out['backward_ms']:.3f} + Adam {out['adam_ms']:.3f}; "
          f"the cells' recompute and its gradient (the Function's "
          f"backward, {CELLS_PER_STEP} a step) {out['recompute_ms']:.3f} "
          f"ms, {rec_ops:.0f} device ops, "
          f"{out['recompute_ms'] / out['step_ms']:.1%} of the step")
    print(f"[profile] train_step: device busy {busy:.4f} ms over "
          f"{n_ops:.0f} kernels and copies a step; lstm_cell "
          f"{cell_n:.0f} launches ({cell_n / n_ops:.1%} of the ops), "
          f"{cell_ms:.4f} ms ({cell_ms / busy:.1%} of busy); top: "
          + "; ".join(f"{t['op']} {t['ms']:.4f} ms x{t['calls']:.0f}"
                      for t in out["top"]))
    return trained, out


class DecisionLog:
    """Wraps a START policy's ``decide`` (either package's): what each
    interval's decision saw (the active jobs, their M_T, q and open task
    slots, and E_S) and did (its actions, each with its job), for holding
    one run against another with :func:`boundary_jobs`."""

    def __init__(self, pol):
        self.pol, self.rec = pol, None
        self.actions = self.predicted = 0
        inner = pol.decide

        def decide(view):
            acts = inner(view)
            if view.event == "interval":
                self.rec = self._record(view, acts)
                self.actions += len(acts)
                self.predicted += len(self.rec["job_ids"]) > 0
            return acts

        pol.decide = decide

    def _record(self, view, acts) -> dict:
        jobs = view.jobs
        active = jobs.active()
        slots = {int(j): jobs.incomplete_tasks(j) - jobs.start[j]
                 for j in active}
        cache = self.pol.controller._es_cache
        task_job = view.tasks.job_id.copy()
        return dict(
            job_ids=active.copy(),
            task_job=task_job.__getitem__,
            m_t=start_tech._task_matrices(view, active),
            q=jobs.count[active].astype(np.float32),
            incomplete_fn=lambda job: (None, None, slots[int(job)]),
            e_s=np.array([cache[int(j)] for j in active], np.float32),
            es_sum=self.pol.predicted_straggler_count(),
            actions=[(int(view.tasks.job_id[a.task]), int(a.task),
                      str(a.kind), a.target) for a in acts])


def compare_decisions(t: int, log_a: DecisionLog, log_b: DecisionLog
                      ) -> dict:
    """Hold run b's decision at interval ``t`` against run a's: the same
    active jobs, E_S and the predicted straggler count within the Tier-1
    bound, actions and trigger state as :func:`hold_decisions` holds
    them.  Equal trigger states after a difference in the actions do not
    make the runs alike again: the actions part them (``diverged``)."""
    ra, rb = log_a.rec, log_b.rec
    if not np.array_equal(ra["job_ids"], rb["job_ids"]):
        raise AssertionError(f"interval {t}: active jobs differ before any "
                             f"decision did")
    rel = max(es_drift(t, ra["e_s"], rb["e_s"]),
              es_drift(t, np.array([ra["es_sum"]]),
                       np.array([rb["es_sum"]])))
    flips = hold_decisions(t, log_a.pol.controller, log_b.pol.controller,
                           ra, ra["e_s"], ra["actions"], rb["actions"])
    return dict(rel=rel, flips=flips,
                diverged=ra["actions"] != rb["actions"])


class GRULog:
    """Wraps an IGRU-SD policy's ``decide`` (either package's): what each
    interval's decision saw (its ready tasks, their elapsed and expected
    times and the GRU's predictions for them) and did (the predicted
    straggler count and its actions), for :func:`compare_gru`.
    ``preds(pol)`` returns the predictions of the policy's last
    decision, in the order of its ready tasks (default: the port's
    ``last_preds``)."""

    def __init__(self, pol, preds=None):
        self.pol, self.rec = pol, None
        self.actions = self.predicted = 0
        self.ready_counts: list[int] = []
        preds = preds or (lambda p: p.last_preds)
        inner = pol.decide

        def decide(view):
            if view.event != "interval":
                return inner(view)
            tt = view.tasks
            # the ready set as decide takes it, before decide flags any
            ready = [int(i) for i in np.nonzero(tt.active_mask())[0]
                     if len(pol.hist.get(int(i), [])) >= pol.HIST
                     and int(i) not in pol._flagged]
            acts = inner(view)
            p = np.asarray(preds(pol), np.float32)[:len(ready)] if ready \
                else np.zeros(0, np.float32)
            self.rec = dict(
                ready=ready, p=p,
                elapsed=np.array([view.now_s - float(tt.start_s[i])
                                  for i in ready]),
                expected=np.array([float(tt.work[i] / view.host_ips_mean)
                                   for i in ready]),
                count=pol.predicted_straggler_count(),
                actions=[(int(a.task), str(a.kind), a.target)
                         for a in acts])
            self.actions += len(acts)
            self.predicted += bool(ready)
            self.ready_counts.append(len(ready))
            return acts

        pol.decide = decide


def compare_gru(t: int, log_a: GRULog, log_b: GRULog) -> dict:
    """Hold run b's IGRU-SD decision at interval ``t`` against run a's:
    the same ready tasks, the GRU's predictions within the Tier-1 bound,
    the predicted straggler count equal up to tasks whose prediction
    lies within the bound of the 1.5 threshold, and the actions equal;
    where they differ, the difference must involve a boundary task (its
    prediction within the bound of 1.5, or its elapsed time within the
    bound of its expected time)."""
    ra, rb = log_a.rec, log_b.rec
    if ra["ready"] != rb["ready"]:
        raise AssertionError(f"interval {t}: ready tasks differ before any "
                             f"decision did")
    rel = es_drift(t, ra["p"], rb["p"], what="GRU prediction")

    def tol(v):
        return TIER1_REL * np.maximum(np.abs(v), TIER1_ABS_FLOOR)

    near_p = np.abs(ra["p"] - 1.5) <= tol(1.5)
    near = near_p | (np.abs(ra["elapsed"] - ra["expected"])
                     <= tol(ra["expected"]))
    boundary = {i for i, b in zip(ra["ready"], near) if b}
    if abs(ra["count"] - rb["count"]) > int(near_p.sum()):
        raise AssertionError(f"interval {t}: predicted straggler counts "
                             f"{ra['count']} and {rb['count']} with "
                             f"{int(near_p.sum())} boundary predictions")
    differ = {k[0] for k in set(ra["actions"]) ^ set(rb["actions"])}
    if differ and not differ & boundary:
        raise AssertionError(f"interval {t}: decisions differ for tasks "
                             f"{sorted(differ)} away from any decision "
                             f"boundary")
    return dict(rel=rel, flips=len(differ),
                diverged=ra["actions"] != rb["actions"])


def lockstep(sim_a, sim_b, n_intervals: int, log=DecisionLog,
             compare=compare_decisions) -> dict:
    """Step two simulations of the same policy interval by interval and
    hold b's decisions against a's (``compare``, over what ``log``
    records: :func:`compare_decisions` for START policies,
    :func:`compare_gru` with :class:`GRULog` for IGRU-SD) until their
    actions part or the run ends; a runs on to the end alone.  Returns
    the comparison, the intervals where a predicted and a's host ms per
    interval."""
    log_a = log(sim_a.technique)
    log_b = log(sim_b.technique)
    worst, flips, compared, parted, step_ms = 0.0, 0, 0, None, []
    for t in range(n_intervals):
        t0 = time.perf_counter()
        sim_a.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if parted is not None:
            continue
        sim_b.step()
        r = compare(t, log_a, log_b)
        worst = max(worst, r["rel"])
        flips += r["flips"]
        compared += 1
        if r["diverged"]:
            parted = t
    return dict(intervals=compared, parted_at=parted, max_rel=worst,
                flips=flips, actions_compared=log_b.actions,
                predicted=log_a.predicted, step_ms=step_ms)


def start_simulation(trained: dict) -> dict:
    """``START`` and ``STARTEager`` with the trained params on the paper's
    width, planetlab and overload, each run on the card and on the CPU
    from the same params in lockstep (:func:`lockstep`): the card's
    lstm_cell launches (``CELLS_PER_STEP`` an interval that predicts),
    warm host ms per interval (the whole step, and the policy's share as
    the engine logs it), and the card run's summary."""
    out = {}
    for scenario in SIM_SCENARIOS:
        cfg = make_config(scenario, seed=1, n_hosts=PAPER["n_hosts"],
                          n_intervals=SIM_INTERVALS,
                          arrival_rate=SIM_ARRIVAL)
        for cls in (start_tech.START, start_tech.STARTEager):
            sim_a = Simulation(cfg, technique=cls(
                controller=start_controller(DEVICE, trained)))
            sim_b = Simulation(cfg, technique=cls(
                controller=start_controller("cpu", trained)))
            lstm_cell.launches = 0
            r = lockstep(sim_a, sim_b, cfg.n_intervals)
            launches = lstm_cell.launches
            key = f"{cls.name}/{scenario}"
            if not r["predicted"] or \
                    launches != CELLS_PER_STEP * r["predicted"]:
                raise AssertionError(f"{key}: {launches} lstm_cell launches "
                                     f"over {r['predicted']} predictions")
            if r["intervals"] < 1 or r["actions_compared"] < 1:
                raise AssertionError(f"{key}: nothing compared: {r}")
            summary = sim_a.summary()
            if not all(np.isfinite(summary[k]) for k in (
                    "avg_execution_time_s", "energy_kwh",
                    "sla_violation_rate")):
                raise AssertionError(f"{key}: summary {summary}")
            ms = r.pop("step_ms")
            out[key] = dict(r, launches=launches,
                            ms_per_interval=float(np.median(ms[1:])),
                            policy_ms_per_interval=1e3 * float(np.median(
                                sim_a.log.overhead_s[1:])),
                            summary={k: summary[k] for k in (
                                "avg_execution_time_s", "energy_kwh",
                                "resource_contention", "sla_violation_rate",
                                "tasks_done", "tasks_total")})
            print(f"[start] {key}: card vs cpu over {r['intervals']} of "
                  f"{cfg.n_intervals} intervals (parted at "
                  f"{r['parted_at']}), E_S max rel drift "
                  f"{r['max_rel']:.3e}, {r['actions_compared']} actions, "
                  f"{r['flips']} boundary flips; lstm_cell launches "
                  f"{launches} over {r['predicted']} predicting intervals; "
                  f"warm {out[key]['ms_per_interval']:.3f} ms per interval "
                  f"(policy {out[key]['policy_ms_per_interval']:.3f}); "
                  f"{out[key]['summary']}")
    return out


# --------------------------------- phase 6 ---------------------------------
# the paper's technique comparison: IGRU-SD on the card and the grid

GRID_SCENARIO = "planetlab"
IGRU_EPOCHS = 40           # SweepSpec's igru_epochs
IGRU_GATE_STEPS = 3
IGRU_REL = 1e-5            # losses, relative
PARITY = ("start", "igru-sd", "grass")
PARITY_SEEDS = (0, 1)
PARITY_WORKERS = 2


def paper_spec(techniques, seeds=(0,)) -> sweep.SweepSpec:
    """A serial sweep on planetlab at the paper's width (400 hosts x 288
    intervals, arrival rate 1.2), the networks of START, START-eager and
    IGRU-SD on ``DEVICE``."""
    on_device = {"device": DEVICE}
    return sweep.SweepSpec(
        techniques=tuple(techniques), seeds=tuple(seeds),
        scenarios=(GRID_SCENARIO,), n_hosts=PAPER["n_hosts"],
        n_intervals=SIM_INTERVALS, arrival_rate=SIM_ARRIVAL,
        igru_epochs=IGRU_EPOCHS, max_workers=1,
        technique_kwargs={t: on_device for t in (
            "start", "start-eager", "igru-sd") if t in techniques})


def igru_train_gate() -> dict:
    """fp32 on the card: ``IGRU_GATE_STEPS`` of ``_gru_step`` on the
    training pairs of the sweep's seed-9 warmup at the paper's width,
    from ``gru_init(SEED)``; then the same steps on the CPU from the
    same init, each loss held to ``IGRU_REL`` relative."""
    spec = paper_spec(("igru-sd",))
    t0 = time.perf_counter()
    warm = sweep._warm_view(spec.cell_config(GRID_SCENARIO, 0))
    xs, ys = baselines.igru_training_data(warm)
    warm_s = time.perf_counter() - t0
    feats, hist = baselines.IGRUSD.FEATS, baselines.IGRUSD.HIST
    if xs.shape[0] != hist or xs.shape[2] != feats \
            or not np.isfinite(xs).all():
        raise AssertionError(f"IGRU-SD training data of shape {xs.shape}")
    losses = {}
    for dev in (DEVICE, "cpu"):
        params = baselines.gru_init(SEED, feats, 16, device=dev)
        opt = net.adam_init(params)
        x_d = torch.as_tensor(xs, device=dev)
        y_d = torch.as_tensor(ys, device=dev)
        losses[dev] = []
        for _ in range(IGRU_GATE_STEPS):
            params, opt, loss = baselines._gru_step(params, opt, x_d, y_d)
            losses[dev].append(float(loss))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[DEVICE],
                                                losses["cpu"])]
    if not (np.isfinite(losses[DEVICE]).all() and max(rel) <= IGRU_REL):
        raise AssertionError(f"IGRU-SD steps on the card {losses[DEVICE]} "
                             f"against the CPU's {losses['cpu']}")
    print(f"[paper] IGRU-SD training gate fp32: warmup {warm_s:.3f} s host, "
          f"{xs.shape[1]} training pairs; {IGRU_GATE_STEPS} _gru_steps on "
          f"the card {losses[DEVICE]}, within {max(rel):.3e} relative of "
          f"the CPU's (bound {IGRU_REL})")
    return dict(pairs=int(xs.shape[1]), losses=losses[DEVICE],
                cpu_losses=losses["cpu"], max_rel=max(rel))


def gru_profile(pol, n: int, reps: int = 20) -> dict:
    """IGRU-SD's prediction (``_predict``: padding, the upload, the GRU,
    the readback) on the histories of ``n`` of its tasks: host ms per
    call (it ends in a readback) and profiled device busy ms and ops."""
    full = [h for h in pol.hist.values() if len(h) >= pol.HIST][:n]
    xs = np.stack([np.stack(h[-pol.HIST:]) for h in full], axis=1)
    pol._predict(xs)
    _, ms = _synced(lambda: [pol._predict(xs) for _ in range(reps)])
    ops = _device_ops(lambda: pol._predict(xs), reps)
    return dict(jobs=len(full), padded=1 << (len(full) - 1).bit_length(),
                host_ms=ms / reps,
                busy_ms=sum(t for t, _ in ops.values()) / 1e6 / reps,
                ops=sum(c for _, c in ops.values()) / reps)


def igru_lockstep() -> dict:
    """``pretrain_igru`` (``IGRU_EPOCHS`` epochs on the seed-9 warmup, as
    the sweep trains it, cached for the grid), then the trained IGRU-SD
    on the card and on the CPU from the same params, on planetlab and
    overload at the paper's width, in lockstep (:func:`lockstep` with
    :func:`compare_gru`)."""
    spec = paper_spec(("igru-sd",))

    def trained():
        return sweep.make_technique(
            "igru-sd", spec.cell_config(GRID_SCENARIO, 0),
            igru_epochs=spec.igru_epochs,
            technique_kwargs=spec.kwargs_for("igru-sd"))

    t0 = time.perf_counter()
    trained()
    train_s = time.perf_counter() - t0
    out = dict(pretrain_s=train_s)
    for scenario in SIM_SCENARIOS:
        cfg = make_config(scenario, seed=1, n_hosts=PAPER["n_hosts"],
                          n_intervals=SIM_INTERVALS,
                          arrival_rate=SIM_ARRIVAL)
        card, twin = trained(), baselines.IGRUSD(device="cpu")
        twin.params = convert.tree_map(lambda t: t.cpu(), card.params)
        sim_a = Simulation(cfg, technique=card)
        sim_b = Simulation(cfg, technique=twin)
        logs = []

        def gru_log(pol):
            logs.append(GRULog(pol))
            return logs[-1]

        r = lockstep(sim_a, sim_b, cfg.n_intervals, log=gru_log,
                     compare=compare_gru)
        ms = r.pop("step_ms")
        if r["intervals"] < 1 or not r["predicted"] \
                or r["actions_compared"] < 1:
            raise AssertionError(f"igru-sd/{scenario}: nothing compared: "
                                 f"{r}")
        ready = [n for n in logs[0].ready_counts if n]
        out[scenario] = dict(r, ms_per_interval=float(np.median(ms[1:])),
                             gru=gru_profile(card, int(np.median(ready))))
        gru = out[scenario]["gru"]
        gru["idle_share"] = 1 - gru["busy_ms"] / out[scenario][
            "ms_per_interval"]
        print(f"[paper] igru-sd/{scenario}: card vs cpu over "
              f"{r['intervals']} of {cfg.n_intervals} intervals (parted at "
              f"{r['parted_at']}), prediction max rel drift "
              f"{r['max_rel']:.3e}, {r['actions_compared']} actions, "
              f"{r['flips']} boundary flips, {r['predicted']} predicting "
              f"intervals; warm {out[scenario]['ms_per_interval']:.3f} ms "
              f"per interval")
        print(f"[profile] igru-sd/{scenario}: the GRU on {gru['jobs']} ready "
              f"tasks (the run's median, padded to {gru['padded']}): "
              f"{gru['host_ms']:.4f} ms a call by the host clock, device "
              f"busy {gru['busy_ms']:.4f} ms over {gru['ops']:.0f} kernels "
              f"and copies; idle {gru['idle_share']:.1%} of the interval")
    print(f"[paper] pretrain_igru: {IGRU_EPOCHS} epochs in {train_s:.3f} s "
          f"host (the warmup cached)")
    return out


@contextlib.contextmanager
def start_cell_launches(out: dict):
    """Count, per cell of a serial ``sweep.run``, the ``lstm_cell``
    launches (set to 0 just before the cell, read just after) and the
    intervals in which a START policy predicted (had active jobs)."""
    inner_decide, inner_cell = start_tech.START.decide, sweep.run_cell
    predicted = [0]

    def decide(self, view):
        if view.event == "interval" and len(view.jobs.active()):
            predicted[0] += 1
        return inner_decide(self, view)

    def run_cell(spec, scenario, technique, seed, **kw):
        predicted[0] = 0
        lstm_cell.launches = 0
        res = inner_cell(spec, scenario, technique, seed, **kw)
        out[(scenario, technique, seed)] = (lstm_cell.launches,
                                            predicted[0])
        return res

    start_tech.START.decide, sweep.run_cell = decide, run_cell
    try:
        yield out
    finally:
        start_tech.START.decide, sweep.run_cell = inner_decide, inner_cell


def paper_grid() -> dict:
    """``sweep.run`` of every technique of ``FIELD`` on planetlab at the
    paper's width, seed 0, serially: the pretraining first (timed apart),
    then one line per technique with its QoS keys and ms per interval;
    every START cell must launch ``lstm_cell`` ``CELLS_PER_STEP`` times
    per interval that predicts."""
    spec = paper_spec(FIELD)
    t0 = time.perf_counter()
    for tech in spec.techniques:
        sweep.pretrain_payload(spec, GRID_SCENARIO, tech)
    pretrain_s = time.perf_counter() - t0
    counts: dict = {}
    with start_cell_launches(counts):
        res = sweep.run(spec)
    out = dict(pretrain_s=pretrain_s, run_s=res.wall_s, cells={})
    for c in res.cells:
        launches, predicted = counts[(c.scenario, c.technique, c.seed)]
        if c.technique.startswith("start") and (
                not predicted or launches != CELLS_PER_STEP * predicted):
            raise AssertionError(f"{c.technique}: {launches} lstm_cell "
                                 f"launches over {predicted} predictions")
        qos = {k: c.summary[k] for k in sweep.QOS_KEYS}
        if not all(np.isfinite(v) for v in qos.values()) \
                or c.summary["tasks_done"] < 1:
            raise AssertionError(f"{c.technique}: summary {c.summary}")
        row = dict(qos, ms_per_interval=1e3 * c.wall_s / SIM_INTERVALS,
                   policy_ms_per_interval=1e3 * c.summary["avg_overhead_s"],
                   lstm_cell_launches=launches, predicted=predicted,
                   tasks_done=c.summary["tasks_done"])
        out["cells"][c.technique] = row
        print(f"[grid] {c.technique}: {row['ms_per_interval']:.3f} ms per "
              f"interval (policy {row['policy_ms_per_interval']:.3f}), "
              + ", ".join(f"{k} {v:.6g}" for k, v in qos.items())
              + (f"; lstm_cell {launches} launches over {predicted} "
                 f"predicting intervals" if launches else ""))
    print(f"[grid] {len(res.cells)} cells at {PAPER['n_hosts']} hosts x "
          f"{SIM_INTERVALS} intervals: pretraining {pretrain_s:.1f} s, the "
          f"grid {res.wall_s:.1f} s host")
    return out


def built_libraries() -> dict:
    """The built kernel libraries, name -> modification time (a rebuild
    replaces the file, so a changed time means one was built again)."""
    return {p.name: p.stat().st_mtime_ns
            for p in _build.BUILD_DIR.glob("*.so")}


def cells_in_workers(res: sweep.SweepResult, techniques,
                     device: str) -> dict:
    """Technique -> the seeds of its cells in ``res`` that ran in a pool
    worker, not in this process.  Fails unless every technique of
    ``techniques`` ran at least one cell there, and each such cell with
    its network on a ``device`` device (the pickled policy unpickled
    there in the worker)."""
    out = {t: [c.seed for c in res.cells
               if c.technique == t and c.pid != os.getpid()]
           for t in techniques}
    wrong = [(c.technique, c.seed, c.device) for c in res.cells
             if c.technique in out and c.pid != os.getpid()
             and torch.device(c.device).type != device]
    if wrong or not all(out.values()):
        raise AssertionError(f"cells in the workers {out}, on the wrong "
                             f"device {wrong}: the workers' path was not "
                             f"driven")
    return out


def sweep_parity() -> dict:
    """``PARITY`` x ``PARITY_SEEDS`` on planetlab at the paper's width,
    serially and on ``PARITY_WORKERS`` spawned workers (warmed first, so
    the parent does not run the grid alone while they import): every
    cell's ``deterministic_summary`` must be equal bit for bit, field by
    field; START and IGRU-SD must each run a cell on the card in a
    worker, and no worker may build a kernel library again."""
    spec = paper_spec(PARITY, PARITY_SEEDS)
    serial = sweep.run(spec)
    libs = built_libraries()
    try:
        spawn_s = sweep.warm_pool(PARITY_WORKERS)
        parallel = sweep.run(dataclasses.replace(
            spec, max_workers=PARITY_WORKERS))
    finally:
        sweep.shutdown_pool()
    on_card = torch.device(DEVICE).type == "cuda"
    if on_card and (not libs or built_libraries() != libs):
        raise AssertionError(f"kernel libraries {libs} became "
                             f"{built_libraries()} in the parallel run")
    in_workers = cells_in_workers(parallel, ("start", "igru-sd"),
                                  torch.device(DEVICE).type)
    differ = []
    for a, b in zip(serial.cells, parallel.cells):
        da = sweep.deterministic_summary(a.summary)
        db = sweep.deterministic_summary(b.summary)
        key = (a.scenario, a.technique, a.seed)
        if key != (b.scenario, b.technique, b.seed) or set(da) != set(db):
            raise AssertionError(f"cells {key} and {b.technique, b.seed} "
                                 f"do not line up")
        differ += [f"{a.technique}/seed {a.seed}: {k} {da[k]!r} != "
                   f"{db[k]!r}" for k in da if da[k] != db[k]]
    if differ:
        raise AssertionError("serial and parallel sweeps differ: "
                             + "; ".join(differ))
    print(f"[paper] serial vs {PARITY_WORKERS} workers: {len(serial.cells)} "
          f"cells ({', '.join(PARITY)} x seeds {PARITY_SEEDS}) bit-equal in "
          f"every field; in the workers (seeds): {in_workers}, no library "
          f"rebuilt; serial {serial.wall_s:.1f} s, parallel "
          f"{parallel.wall_s:.1f} s host (the pool warmed before it in "
          f"{spawn_s:.1f} s)")
    return dict(cells=len(serial.cells), serial_s=serial.wall_s,
                parallel_s=parallel.wall_s, spawn_s=spawn_s,
                in_workers=in_workers)


# ------------------------------- phases 6 to 9 -------------------------------

class RouteLog:
    """``backend.moe_router`` as the model calls it: each call's indices
    are kept under the current step's key (``key``, set by the caller),
    one entry per MoE layer in order.  ``with_gap`` also keeps, per
    token, the relative gap between the k-th and (k+1)-th probability."""

    def __init__(self, router, with_gap: bool = False):
        self.router, self.with_gap = router, with_gap
        self.key = None
        self.calls: dict = {}

    def __call__(self, logits, k: int):
        w, idx = self.router(logits, k)
        gap = None
        if self.with_gap:
            top = torch.topk(torch.softmax(logits.float(), dim=-1), k + 1,
                             dim=-1).values
            gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        self.calls.setdefault(self.key, []).append((idx, gap))
        return w, idx


@contextlib.contextmanager
def routed_by(log: RouteLog):
    saved = backend.moe_router
    backend.moe_router = log
    try:
        yield log
    finally:
        backend.moe_router = saved


class Recorder:
    """The model as the engine sees it, keeping the logits of every call,
    prefill logits by prompt length, decode logits by position (the
    prompts' lengths are far enough apart that positions identify the
    request), and keying the router calls of each in ``log``."""

    def __init__(self, model: Model, log: RouteLog):
        self.model, self.log = model, log
        self.prefill_logits: dict[int, torch.Tensor] = {}
        self.decode_logits: dict[int, torch.Tensor] = {}

    def prefill(self, params, batch):
        n = batch["tokens"].shape[1]
        self.log.key = ("prefill", n)
        logits, caches = self.model.prefill(params, batch)
        self.prefill_logits[n] = logits
        return logits, caches

    def decode_step(self, params, caches, tokens, pos):
        self.log.key = ("decode", pos)
        logits, caches = self.model.decode_step(params, caches, tokens, pos)
        self.decode_logits[pos] = logits
        return logits, caches


@contextlib.contextmanager
def plain_path():
    """The model's attention and router through the plain PyTorch
    versions, on the card (the kernels' wrappers are not called); yields
    the router's log, with the top-k gaps."""
    saved = backend.attention, backend.decode_attention
    backend.attention = (lambda q, k, v, *, causal=True:
                         attention_ref(q, k, v, causal=causal))
    backend.decode_attention = (lambda q, k, v, *, kv_len:
                                decode_attention_ref(q, k, v, kv_len=kv_len))
    try:
        with routed_by(RouteLog(moe_router_ref, with_gap=True)) as log:
            yield log
    finally:
        backend.attention, backend.decode_attention = saved


def kernel_launches() -> dict:
    return dict(flash_attention=flash_attention.launches,
                decode_attention=decode_attention.launches,
                moe_router=moe_router.launches, lstm_cell=lstm_cell.launches,
                mamba_scan=mamba_scan.launches,
                mamba_scan_bwd=mamba_scan_bwd.launches)


def reset_launches() -> None:
    flash_attention.launches = decode_attention.launches = 0
    moe_router.launches = lstm_cell.launches = mamba_scan.launches = 0
    mamba_scan_bwd.launches = 0


def lm_prompts(vocab: int) -> list[np.ndarray]:
    assert all(b - a > MAX_NEW for a, b in zip(PROMPT_LENS,
                                               PROMPT_LENS[1:]))
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def serve_engine(model: Model, params, prompts) -> dict:
    """The main path: ``Engine`` serving every prompt, launch counts set
    to 0 just before and read just after."""
    log = RouteLog(backend.moe_router)
    rec = Recorder(model, log)
    eng = Engine(rec, params, EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN))
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=p, max_new=MAX_NEW))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with routed_by(log):
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    cfg = model.cfg
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    decoded = sum(len(r.out) - 1 for r in done)
    want = dict(flash_attention=cfg.n_layers * len(prompts),
                decode_attention=LAUNCHES_PER_CALL * cfg.n_layers * decoded,
                moe_router=n_moe * (len(prompts) + decoded), lstm_cell=0,
                mamba_scan=0, mamba_scan_bwd=0)
    if len(done) != len(prompts) or launches != want:
        raise AssertionError(f"engine: {len(done)} requests done, launches "
                             f"{launches}, expected {want}")
    tokens = sum(len(r.out) for r in done)
    print(f"[lm] engine served {len(done)} requests, {tokens} tokens in "
          f"{wall:.3f} s: flash_attention {launches['flash_attention']} "
          f"launches = {cfg.n_layers} x {len(prompts)} prefills, "
          f"decode_attention {launches['decode_attention']} = "
          f"{LAUNCHES_PER_CALL} x {cfg.n_layers} x {decoded} decoded tokens, "
          f"moe_router {launches['moe_router']} = {n_moe} x "
          f"({len(prompts)} prefills + {decoded} decoded tokens)")
    return dict(done=sorted(done, key=lambda r: r.req_id), rec=rec,
                routes=log.calls, wall_s=wall, tokens=tokens,
                launches=launches)


def route_diffs(eng_calls, plain_calls) -> tuple[int, list]:
    """One step's routing, engine against plain path, MoE layer by layer:
    (rows compared, [(layer, plain top-k gaps of the rows whose expert
    sets differ)] for the layers where any do)."""
    if len(eng_calls) != len(plain_calls):
        raise AssertionError(f"{len(eng_calls)} router calls in the engine, "
                             f"{len(plain_calls)} in the plain path")
    rows, out = 0, []
    for layer, ((idx, _), (p_idx, gap)) in enumerate(zip(eng_calls,
                                                         plain_calls)):
        differ = (torch.sort(idx, -1).values
                  != torch.sort(p_idx, -1).values).any(-1)
        rows += idx.shape[0]
        if differ.any():
            out.append((layer, gap[differ]))
    return rows, out


def teacher_forced(model: Model, params, prompts, served,
                   hold_routing: bool = True) -> dict:
    """Every step of every request re-run through the plain attention and
    router functions on the card, fed the engine's tokens: logits drift
    against the engine's, greedy agreement, the plain path's top-2 margin
    where they disagree, and the routing differences.  With
    ``hold_routing`` (the fp32 gate), every token whose experts differ at
    a request's first routing difference must be a near-tie of the plain
    path's k-th and (k+1)-th probability, and only the steps before it
    are measured; what follows it in that request (later layers and
    steps) is counted, not held."""
    rec, dev = served["rec"], params["embed"].device
    drift, drift_after, agree, total, flips = 0.0, 0.0, 0, 0, []
    routing = dict(rows=0, first=[], rows_after=0, steps_after=0)
    before = kernel_launches()
    with plain_path() as log:
        for p, req in zip(prompts, served["done"]):
            n = len(p)
            log.key = ("prefill", n)
            logits, caches = model.prefill(
                params, {"tokens": torch.as_tensor(p, device=dev)[None]})
            caches = pad_to_length(caches, n + MAX_NEW)
            steps = [(log.key, rec.prefill_logits[n], logits)]
            for j, tok in enumerate(req.out[:-1]):
                log.key = ("decode", n + j)
                logits, caches = model.decode_step(
                    params, caches, torch.tensor([[tok]], device=dev), n + j)
                steps.append((log.key, rec.decode_logits[n + j], logits))
            del caches
            flipped = False
            for j, (key, eng_l, plain_l) in enumerate(steps):
                rows, diffs = route_diffs(served["routes"].get(key, []),
                                          log.calls.get(key, []))
                routing["rows"] += rows
                if diffs and not flipped:
                    layer, gaps = diffs[0]
                    first = dict(req=req.req_id, step=j, layer=layer,
                                 tokens=len(gaps), gap=gaps.max().item())
                    if hold_routing and not first["gap"] <= NEAR_TIE:
                        raise AssertionError(f"routing differs away from a "
                                             f"top-k near-tie: {first}")
                    routing["first"].append(first)
                    diffs = diffs[1:]
                    flipped = True
                routing["rows_after"] += sum(len(g) for _, g in diffs)
                eng_l, plain_l = eng_l[0, -1], plain_l[0, -1]
                if not torch.isfinite(plain_l).all():
                    raise AssertionError("plain path: non-finite logits")
                d = (eng_l - plain_l).abs().max().item()
                if flipped and hold_routing:
                    drift_after = max(drift_after, d)
                    routing["steps_after"] += 1
                    continue
                drift = max(drift, d)
                total += 1
                if int(torch.argmax(plain_l)) == req.out[j]:
                    agree += 1
                    continue
                top2 = torch.topk(plain_l, 2).values
                flips.append(dict(req=req.req_id, step=j, token=req.out[j],
                                  plain_token=int(torch.argmax(plain_l)),
                                  margin=(top2[0] - top2[1]).item()))
            log.calls.clear()
    if kernel_launches() != before:
        raise AssertionError("the plain path launched a kernel")
    return dict(max_abs_drift=drift, agree=agree, steps=total, flips=flips,
                routing=routing, max_abs_drift_after_routing=drift_after)


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _routing_line(tf: dict) -> str:
    r = tf["routing"]
    return (f"routing: {len(r['first'])} requests with a routing "
            f"difference over {r['rows']} token-layer routings, first ones "
            f"{r['first']}; {r['rows_after']} differing routings after them "
            f"({r['steps_after']} steps held out, logit drift there "
            f"{tf['max_abs_drift_after_routing']:.3e})")


def lm_gate(arch: str, n_layers: int | None = None) -> dict:
    """fp32 at full width (and depth, unless ``n_layers`` cuts it), the
    correctness gate."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, param_dtype="float32",
                              n_layers=n_layers or full.n_layers)
    model = Model(cfg)
    matmul = torch.backends.cuda.matmul
    if (matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or matmul.allow_bf16_reduced_precision_reduction):
        raise AssertionError("reduced-precision products are on")
    t0 = time.perf_counter()
    params = model.init(SEED, DEVICE)
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name} fp32, {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B params, "
          f"init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = lm_prompts(cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    served = serve_engine(model, params, prompts)
    tf = teacher_forced(model, params, prompts, served)
    for f in tf["flips"]:
        print(f"[lm] fp32 boundary flip: {f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[lm] {cfg.name} fp32 engine vs plain path: max abs logit drift "
          f"{tf['max_abs_drift']:.3e} (bound {LOGIT_TOL}) over {tf['steps']} "
          f"steps, greedy tokens equal {tf['agree']}/{tf['steps']}, peak "
          f"{peak:.2f} GiB")
    if served["launches"]["moe_router"]:
        print(f"[lm] {cfg.name} fp32 {_routing_line(tf)}")
    if not tf["max_abs_drift"] <= LOGIT_TOL:
        raise AssertionError(f"fp32 logits drift {tf['max_abs_drift']}")
    bad = [f for f in tf["flips"] if f["margin"] >= LOGIT_TOL]
    if bad:
        raise AssertionError(f"fp32 greedy tokens differ away from a top-2 "
                             f"tie: {bad}")
    out = dict(n_layers=cfg.n_layers, launches=served["launches"],
               wall_s=served["wall_s"], tokens=served["tokens"],
               peak_gib=peak, **tf)
    del params, served
    free_cuda()
    return out


def _sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def lm_timing(arch: str) -> dict:
    """bf16, the config's own dtype, at full width and depth: the
    engine's run, warm TTFT per prompt length (prefill, cache padding and
    the first token, one request alone), warm decode ms per token, drift
    and routing differences against the plain path, and profiled windows
    of decode steps and of the longest prefill."""
    cfg = get_config(arch)
    model = Model(cfg)
    params = model.init(SEED, DEVICE)
    prompts = lm_prompts(cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    served = serve_engine(model, params, prompts)
    tf = teacher_forced(model, params, prompts, served, hold_routing=False)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[lm] {cfg.name} bf16 engine vs plain path: max abs logit drift "
          f"{tf['max_abs_drift']:.3e}, greedy tokens equal "
          f"{tf['agree']}/{tf['steps']}, peak {peak:.2f} GiB")
    if served["launches"]["moe_router"]:
        print(f"[lm] {cfg.name} bf16 {_routing_line(tf)}")

    def first_token(p):
        toks = torch.as_tensor(p, device=DEVICE)[None]
        logits, caches = model.prefill(params, {"tokens": toks})
        pad_to_length(caches, MAX_LEN)
        return int(torch.argmax(logits[:, -1], dim=-1)[0])

    ttft = {}
    for p in prompts:
        ttft[len(p)] = float(np.median([_sync_ms(lambda: first_token(p))
                                        for _ in range(3)]))
    decode_ms, decode_busy = {}, {}
    for n in (PROMPT_LENS[0], PROMPT_LENS[-1]):
        p = prompts[PROMPT_LENS.index(n)]
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(p, device=DEVICE)[None]})
        caches = pad_to_length(caches, MAX_LEN)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        times = []
        for j in range(MAX_NEW):
            def step(j=j):
                nonlocal tok
                out, _ = model.decode_step(params, caches, tok, n + j)
                tok = torch.argmax(out[:, -1], dim=-1)[:, None]
                int(tok[0, 0])
            times.append(_sync_ms(step))
        decode_ms[n] = float(np.median(times[2:]))
        decode_busy[n] = profile_decode(model, params, caches, tok,
                                        n + MAX_NEW)
        del caches
    longest = prompts[-1]
    prefill_busy = profile_window(
        f"prefill of {len(longest)} tokens", lambda: first_token(longest), 1)
    tok_s = served["tokens"] / served["wall_s"]
    print(f"[lm] {cfg.name} bf16 TTFT ms by prompt length (warm, alone): "
          f"{ttft}")
    print(f"[lm] {cfg.name} bf16 decode ms/token (B=1, warm median) by "
          f"context: {decode_ms}; engine {served['tokens']} tokens in "
          f"{served['wall_s']:.3f} s = {tok_s:.1f} tokens/s "
          f"({len(prompts)} requests, {N_SLOTS} slots, prefill included)")
    out = dict(ttft_ms=ttft, decode_ms=decode_ms, profile=decode_busy,
               prefill_profile=prefill_busy,
               engine_tok_per_s=tok_s, engine_wall_s=served["wall_s"],
               tokens=served["tokens"], launches=served["launches"],
               peak_gib=peak, max_abs_drift=tf["max_abs_drift"],
               agree=tf["agree"], steps=tf["steps"], flips=len(tf["flips"]),
               routing=dict(tf["routing"], first=len(tf["routing"]["first"])))
    del params, served
    free_cuda()
    return out


def profile_window(label: str, fn, reps: int) -> dict:
    """Device time of ``reps`` calls of ``fn`` under torch.profiler: busy
    ms per call (every kernel and copy) and the top device ops."""
    ops = _device_ops(fn, reps)
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:6]
    ours = {}
    for name in OUR_KERNELS:
        hits = [v for k, v in ops.items() if f"::{name}<" in k]
        if hits:
            ours[name] = dict(ms=sum(t for t, _ in hits) / 1e6 / reps,
                              calls=sum(c for _, c in hits) / reps)
    out = dict(device_busy_ms=sum(t for t, _ in ops.values()) / 1e6 / reps,
               device_ops=sum(c for _, c in ops.values()) / reps,
               top=[dict(op=k[:120], ms=t / 1e6 / reps, calls=c / reps)
                    for k, (t, c) in top], kernels=ours)
    print(f"[profile] {label}: device busy {out['device_busy_ms']:.4f} ms "
          f"per call over {out['device_ops']:.0f} kernels and copies; top: "
          + "; ".join(f"{t['op']} {t['ms']:.4f} ms x{t['calls']:.0f}"
                      for t in out['top']) + "; the port's kernels: "
          + "; ".join(f"{k} {v['ms']:.4f} ms x{v['calls']:.0f}"
                      for k, v in ours.items()))
    return out


def profile_decode(model, params, caches, tok, pos, reps: int = 8) -> dict:
    """``reps`` decode steps from ``pos`` under the profiler, per token."""
    state = dict(tok=tok, pos=pos)

    def step():
        out, _ = model.decode_step(params, caches, state["tok"],
                                   state["pos"])
        state["tok"] = torch.argmax(out[:, -1], dim=-1)[:, None]
        state["pos"] += 1

    return profile_window(f"decode from position {pos}, per token", step,
                          reps)


# ----------------------------- phases 10 and 11 -----------------------------

@contextlib.contextmanager
def plain_scan():
    """The model's selective scan through the plain PyTorch version, on
    the card, differentiated by autograd (neither kernel's wrapper is
    called)."""
    saved = backend.mamba_scan
    backend.mamba_scan = mamba_scan_ref
    try:
        yield
    finally:
        backend.mamba_scan = saved


def _ssm_trainer(n_layers: int, dtype: str | None = None):
    full = get_config(SSM_ARCH)
    cfg = dataclasses.replace(full, n_layers=n_layers,
                              param_dtype=dtype or full.param_dtype)
    model = Model(cfg)
    return cfg, model, Trainer(model, mesh=None,
                               opt_cfg=Opt.OptConfig(**SSM_OPT),
                               device=DEVICE)


def clone(tree: dict) -> dict:
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def tree_rel(got: dict, want: dict) -> tuple[float, float]:
    """||got - want|| / ||want|| over all leaves, and the worst leaf's."""
    num = den = worst = 0.0
    for g, w in zip(convert.leaves(got), convert.leaves(want)):
        d2 = (g.double() - w.double()).square().sum().item()
        w2 = w.double().square().sum().item()
        num, den = num + d2, den + w2
        worst = max(worst, (d2 / max(w2, 1e-300)) ** 0.5)
    return (num / den) ** 0.5, worst


def ssm_gate() -> dict:
    """fp32 at full width, ``SSM_GATE_LAYERS`` layers.  The main path:
    ``Trainer``'s steps through the kernel, launch counts set to 0 just
    before and read just after.  Then, from the params before each of its
    steps, the same loss through the plain scan (held to 1e-5 relative),
    and step 1's gradients both ways (held to 1e-4 relative in norm).
    Last, reported and not held, the plain path's own steps from the same
    start: Adam's first steps divide each gradient by its own magnitude,
    so where a gradient is near 0 the two paths' fp32 noise moves the
    params apart, and the losses drift apart step by step."""
    cfg, model, trainer = _ssm_trainer(SSM_GATE_LAYERS, "float32")
    matmul = torch.backends.cuda.matmul
    if (matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or matmul.allow_bf16_reduced_precision_reduction):
        raise AssertionError("reduced-precision products are on")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SSM_GATE_SEQ,
                                  global_batch=SSM_GATE_BATCH),
                       device=DEVICE)
    batches = [data.batch(i) for i in range(SSM_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    params, state = trainer.init_state(SEED)
    step = trainer.compile_step()
    snaps, losses = [], []
    torch.cuda.synchronize()
    reset_launches()
    for batch in batches:
        snaps.append(clone(params))
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    launches = kernel_launches()
    del params, state
    free_cuda()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, g_kern = value_and_grad(model, snaps[0], batches[0])
    before = kernel_launches()
    with plain_scan():
        with torch.no_grad():
            plain = [float(model.loss_fn(p, b))
                     for p, b in zip(snaps, batches)]
        _, g_plain = value_and_grad(model, snaps[0], batches[0])
        grad_rel, worst_leaf = tree_rel(g_kern, g_plain)
        del g_kern, g_plain, snaps[1:]
        free_cuda()
        p, st = snaps[0], Opt.init(trainer.opt_cfg, snaps[0])
        own = []
        for batch in batches:
            p, st, m = step(p, st, batch)
            own.append(float(m["loss"]))
        del p, st, snaps
        free_cuda()
    plain_launches = {k: v - before[k] for k, v in kernel_launches().items()}
    rel = [abs(k - q) / abs(q) for k, q in zip(losses, plain)]
    own_rel = [abs(k - q) / abs(q) for k, q in zip(losses, own)]
    print(f"[ssm] {cfg.name} fp32, {cfg.n_layers} layers "
          f"({cfg.param_count() / 1e9:.3f} B params), batches "
          f"{SSM_GATE_BATCH} x {SSM_GATE_SEQ}: losses {losses}; the plain "
          f"scan from the same params {plain}, max rel {max(rel):.3e} "
          f"(bound 1e-5); step-1 gradients rel {grad_rel:.3e} (bound 1e-4; "
          f"worst leaf {worst_leaf:.3e}); mamba_scan "
          f"{launches['mamba_scan']} and mamba_scan_bwd "
          f"{launches['mamba_scan_bwd']} launches = 2 x {cfg.n_layers} "
          f"layers x "
          f"{SSM_STEPS} steps; peak {peak:.2f} GiB. Not held: the plain "
          f"path's own steps {own}, rel {[f'{r:.3e}' for r in own_rel]}")
    want = {k: 0 for k in launches}
    want["mamba_scan"] = 2 * cfg.n_layers * SSM_STEPS
    want["mamba_scan_bwd"] = (scan_ops.BWD_LAUNCHES_PER_CALL * cfg.n_layers
                              * SSM_STEPS)
    if launches != want:
        raise AssertionError(f"kernel path launches {launches}, expected "
                             f"{want}")
    if any(plain_launches.values()):
        raise AssertionError(f"the plain path launched {plain_launches}")
    if not (np.isfinite(losses).all() and max(rel) <= 1e-5):
        raise AssertionError(f"losses {losses} vs plain {plain}")
    if not grad_rel <= 1e-4:
        raise AssertionError(f"step-1 gradients differ by {grad_rel}")
    return dict(n_layers=cfg.n_layers, losses=losses, plain_losses=plain,
                max_loss_rel=max(rel), grad_rel=grad_rel,
                worst_leaf_rel=worst_leaf, own_plain_losses=own,
                own_plain_rel=own_rel, launches=launches, peak_gib=peak)


@contextlib.contextmanager
def timed_scan_backward():
    """Yields a list that gets the host seconds of each call of the scan's
    backward (the backward kernels), each call between two
    synchronisations, inside whatever step runs meanwhile."""
    fn = scan_ops._Scan
    saved = fn.backward
    times: list[float] = []

    def backward(ctx, g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved(ctx, g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    fn.backward = staticmethod(backward)
    try:
        yield times
    finally:
        fn.backward = staticmethod(saved)


def ssm_timing() -> dict:
    """bf16, the config's own dtype, full width, ``SSM_LAYERS`` layers:
    one warm step and ``SSM_STEPS`` timed, then one step taken by its
    parts (forward, backward, optimizer) and one under the profiler."""
    cfg, model, trainer = _ssm_trainer(SSM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state = trainer.init_state(SEED)
    torch.cuda.synchronize()
    print(f"[ssm] {cfg.name} bf16, {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
          f"(params and AdamW moments)")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SSM_SEQ,
                                  global_batch=SSM_BATCH), device=DEVICE)
    step = trainer.compile_step()
    reset_launches()
    losses, times = [], []
    for i in range(1 + SSM_STEPS):
        batch = data.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    want = 2 * cfg.n_layers * (1 + SSM_STEPS)
    want_bwd = scan_ops.BWD_LAUNCHES_PER_CALL * cfg.n_layers * (1 + SSM_STEPS)
    if (launches["mamba_scan"] != want
            or launches["mamba_scan_bwd"] != want_bwd
            or sum(launches.values()) != want + want_bwd):
        raise AssertionError(f"launches {launches}, expected {want} scans "
                             f"and {want_bwd} scan backward launches")
    if not (np.isfinite(losses).all() and max(losses) > min(losses)):
        raise AssertionError(f"bf16 losses {losses}")
    step_ms = float(np.median(times[1:]))
    tokens = SSM_BATCH * SSM_SEQ

    # one step by its parts, the scan's backward timed inside it
    batch = data.batch(1 + SSM_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs = [t.detach().requires_grad_() for t in convert.leaves(params)]
    loss = model.loss_fn(convert.unflatten(params, xs), batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with timed_scan_backward() as scan_bwd:
        grads = torch.autograd.grad(loss, xs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    params, state, _ = Opt.update(trainer.opt_cfg,
                                  convert.unflatten(params, grads), state,
                                  params)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del xs, grads, loss
    split = dict(forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                 optimizer_ms=(t3 - t2) * 1e3)
    if len(scan_bwd) != cfg.n_layers:
        raise AssertionError(f"{len(scan_bwd)} scan backwards in a step")
    bwd_ms = sum(scan_bwd) * 1e3
    split_ms = (t3 - t0) * 1e3
    batch = data.batch(2 + SSM_STEPS)

    def one_step():
        nonlocal params, state
        params, state, m = step(params, state, batch)
        float(m["loss"])

    prof = profile_window(f"{cfg.name} bf16 training step", one_step, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(n_layers=cfg.n_layers, batch=SSM_BATCH, seq=SSM_SEQ,
               step_ms=step_ms, step_ms_all=times, tok_per_s=tokens
               / (step_ms / 1e3), losses=losses, launches=launches, **split,
               split_step_ms=split_ms, scan_backward_ms=bwd_ms,
               scan_backward_share=bwd_ms / split_ms,
               device_busy_ms=prof["device_busy_ms"],
               idle_share=1 - prof["device_busy_ms"] / step_ms,
               device_ops=prof["device_ops"], top=prof["top"],
               kernels=prof["kernels"], peak_gib=peak)
    print(f"[ssm] {cfg.name} bf16, {cfg.n_layers} layers, {SSM_BATCH} x "
          f"{SSM_SEQ} tokens per step: {step_ms:.1f} ms per step (warm "
          f"median of {SSM_STEPS}; all {[round(t, 1) for t in times]}), "
          f"{out['tok_per_s']:.1f} tokens/s; split forward "
          f"{split['forward_ms']:.1f} / backward {split['backward_ms']:.1f} / "
          f"optimizer {split['optimizer_ms']:.1f} ms; the scan backward "
          f"{bwd_ms:.1f} ms of it ({cfg.n_layers} calls, "
          f"{100 * out['scan_backward_share']:.1f}%); device busy "
          f"{prof['device_busy_ms']:.1f} ms per step (idle "
          f"{100 * out['idle_share']:.1f}%); losses {losses}; mamba_scan "
          f"{launches['mamba_scan']} and mamba_scan_bwd "
          f"{launches['mamba_scan_bwd']} launches = 2 x {cfg.n_layers} x "
          f"{1 + SSM_STEPS} steps; peak {peak:.2f} GiB")
    del params, state
    free_cuda()
    return out


# --------------------------------- main ------------------------------------

@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s wall")


def main() -> None:
    t_start = time.perf_counter()
    smi = environment()
    full_precision()
    with phase("build"):
        t0 = time.perf_counter()
        built = _build.build_all()
        print(f"[build] {built} in {time.perf_counter() - t0:.2f} s wall")
        for name in built:
            for line in _build.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")

    with phase("kernels vs plain"):
        floor = floor_us()
        cell = check_kernel(floor)
        flash = check_flash()
        decode = check_decode(floor)
        router = check_router(floor)
        scan = check_scan()
        scan_bwd = check_scan_bwd(floor)

    n_hosts, max_tasks = PAPER["n_hosts"], PAPER["max_tasks"]
    with phase("decision slice"):
        lstm_cell.launches = 0
        slice_stats = run_slice("cuda", "cpu", n_hosts, max_tasks)
        launches = lstm_cell.launches
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            raise AssertionError("TF32 is on with the predictor built")
        fused = sum(s["intervals"] for s in slice_stats.values())
        layers, horizon = 2, PAPER["horizon"]
        if launches != layers * horizon * fused:
            raise AssertionError(f"lstm_cell launched {launches} times over "
                                 f"{fused} fused intervals, expected "
                                 f"{layers * horizon} each")
        for trigger, s in slice_stats.items():
            # the first interval stages the ring and the packed batch
            if s["h2d_stages"] != s["intervals"] + 1:
                raise AssertionError(f"{trigger}: {s['h2d_stages']} staged "
                                     f"copies over {s['intervals']} "
                                     f"intervals")
        print(f"[slice] lstm_cell launches {launches} = {layers * horizon} x "
              f"{fused} fused intervals; one staged copy per warm interval")
        buckets = time_buckets(n_hosts, max_tasks, floor)

    with phase("START training and simulation"):
        xs, ys = start_warmup()
        start_gate = start_train_gate(xs, ys)
        trained, start_timing = start_train_timing(xs, ys)
        start_sims = start_simulation(trained)

    with phase("paper comparison"):
        igru_gate = igru_train_gate()
        igru_sims = igru_lockstep()
        grid = paper_grid()
        parity = sweep_parity()

    with phase(f"{LM_ARCH} fp32 gate"):
        gate = lm_gate(LM_ARCH)
    with phase(f"{LM_ARCH} bf16 timing and serve"):
        timing = lm_timing(LM_ARCH)
        served = serve_entry.main(["--arch", LM_ARCH, "--device", "cuda"])
        free_cuda()
    with phase(f"{MOE_ARCH} fp32 gate ({MOE_GATE_LAYERS} layers)"):
        moe_gate = lm_gate(MOE_ARCH, MOE_GATE_LAYERS)
    with phase(f"{MOE_ARCH} bf16 timing and serve"):
        moe_timing = lm_timing(MOE_ARCH)
        moe_served = serve_entry.main(["--arch", MOE_ARCH, "--device",
                                       "cuda"])
        free_cuda()
    with phase(f"{SSM_ARCH} fp32 training gate ({SSM_GATE_LAYERS} layers)"):
        ssm_fp32 = ssm_gate()
    with phase(f"{SSM_ARCH} bf16 training ({SSM_LAYERS} layers) and train"):
        ssm_bf16 = ssm_timing()
        trained = train_entry.main(["--arch", SSM_ARCH, "--reduced",
                                    "--steps", "5", "--device", "cuda"])
        if not np.isfinite([trained["first_loss"], trained["last_loss"]]
                           ).all():
            raise AssertionError(f"launch.train: {trained}")
        free_cuda()

    headline = cell["timing"][-1]
    kernels = [dict(
        name="lstm_cell", route="cuda", source=SOURCE, replaces=REPLACES,
        launches=launches, max_abs_err=cell["worst"][torch.float32],
        max_abs_err_bf16=cell["worst"][torch.bfloat16],
        ms=headline["ms"], kernel_ms=headline["ms"],
        plain_ms=headline["plain_ms"], bound_ms=headline["bound_ms"],
        bound_by=headline["bound_by"], library_ms=headline["library_ms"],
        shape=[headline["batch"], headline["n_in"], headline["hidden"]],
        device_ms=buckets[f"milestone/{TIMED_BUCKETS[-1]}"][
            "kernel_device_ms"],
        device_us={r["batch"]: r["device_us"] for r in cell["timing"]},
        floor_us=floor, per_shape=cell["timing"],
        launches_train_gate=start_gate["launches"],
        launches_sim={k: v["launches"] for k, v in start_sims.items()},
        launches_grid={k: v["lstm_cell_launches"]
                       for k, v in grid["cells"].items()
                       if v["lstm_cell_launches"]})]
    # launches: flash from yi-6b's bf16 serving run (the tensor-core
    # kernel, the one timed), decode from yi-6b's fp32 gate, the router
    # from qwen3's; times at the path's longest timed shape, attention in
    # bf16 (the config's own dtype; flash at S = 2048, its first bf16
    # row), the router in fp32 (its logits are fp32)
    for name, meta, res, runs in (
            ("flash_attention", FLASH, flash, timing),
            ("decode_attention", DECODE, decode, gate),
            ("moe_router", ROUTER, router, moe_gate)):
        want = "float32" if name == "moe_router" else "bfloat16"
        head = [r for r in res["timing"] if r["dtype"] == want][0]
        kernels.append(dict(
            name=name, route="cuda", **meta,
            launches=runs["launches"][name],
            max_abs_err=res["worst"][torch.float32],
            max_abs_err_bf16=res["worst"][torch.bfloat16],
            ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"],
            per_dtype=res["timing"],
            **({"device_us": res["device_us"], "floor_us": floor}
               if "device_us" in res else {}),
            **{key: res[key] for key in ("bf16_excess",
                                         "bf16_control_excess")
               if key in res}))
    # the scan: launches from the fp32 training gate, times at the timed
    # run's shape in bf16 (the config's own dtype); no PyTorch call
    # computes the selective scan, so library_ms is null
    head = [r for r in scan["timing"] if r["dtype"] == "bfloat16"
            and r["shape"] == "B={} L={} D={} N={}".format(*SCAN_PATH[-1])][0]
    kernels.append(dict(
        name="mamba_scan", route="cuda", **SCAN,
        launches=ssm_fp32["launches"]["mamba_scan"],
        max_abs_err=scan["worst"][torch.float32],
        max_abs_err_bf16=scan["worst"][torch.bfloat16],
        max_rel_err=scan["worst_rel"][torch.float32],
        ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=None, device_ms=head["device_ms"], shape=head["shape"],
        per_dtype=scan["timing"]))
    # its backward: launches from the fp32 training gate (two per call),
    # times at the timed run's shape in bf16; no PyTorch call computes the
    # scan's gradient, so library_ms is null
    head = [r for r in scan_bwd["timing"] if r["dtype"] == "bfloat16"
            and r["shape"] == "B={} L={} D={} N={}".format(*SCAN_PATH[-1])][0]
    kernels.append(dict(
        name="mamba_scan_bwd", route="cuda", **SCAN_BWD,
        launches=ssm_fp32["launches"]["mamba_scan_bwd"],
        max_abs_err=scan_bwd["worst"][torch.float32],
        max_abs_err_bf16=scan_bwd["worst"][torch.bfloat16],
        max_rel_err=scan_bwd["worst_rel"][torch.float32],
        ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
        autograd_ms=head["autograd_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
        device_ms=head["device_ms"], floor_us=floor, shape=head["shape"],
        per_dtype=scan_bwd["timing"]))
    print(json.dumps({"slice": slice_stats, "ms_per_interval": buckets}))
    print(json.dumps({"start_train_gate": start_gate,
                      "start_train": start_timing,
                      "start_sim": start_sims}))
    print(json.dumps({"igru_train_gate": igru_gate, "igru_sim": igru_sims,
                      "grid": grid, "sweep_parity": parity}))
    print(json.dumps({"lm_fp32": {k: v for k, v in gate.items()
                                  if k != "flips"},
                      "lm_bf16": timing, "serve": served}))
    print(json.dumps({"moe_fp32": {k: v for k, v in moe_gate.items()
                                   if k != "flips"},
                      "moe_bf16": moe_timing, "moe_serve": moe_served}))
    print(json.dumps({"ssm_fp32": ssm_fp32, "ssm_bf16": ssm_bf16,
                      "train": trained}))
    print(f"[time] total: {time.perf_counter() - t_start:.1f} s wall")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
