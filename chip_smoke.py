#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of START on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py

Run from the repository root, on a machine with the card and ``nvcc``.
Phases:

1. environment: a CUDA card, TF32 and bf16 reduced-precision reductions
   off, the card's name and power limit;
2. build: every CUDA kernel of the port (``lstm_cell``,
   ``flash_attention``, ``decode_attention``), from the sources in the
   checkout, one ``nvcc`` per source, all started together;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the JAX test sweep's shapes and its path's shapes, and timed
   beside the plain version and the one-call PyTorch yardstick
   (``torch.lstm_cell``, ``scaled_dot_product_attention``);
4. the decision slice: ``STARTController`` at the paper's width (400
   hosts x 11 features, 10 tasks per job, horizon 5), fed seeded
   telemetry, in both triggers, on the card and on the CPU from the same
   weights: E_S agrees within the Tier-1 bound, actions agree, every
   LSTM cell of the card's run went through the kernel, one staged copy
   per warm interval; then the warm ms per interval for each batch
   bucket;
5. LM serving, fp32: yi-6b at full width and depth (seeded weights),
   ``Engine(n_slots=4, max_len=4096)`` serving 6 seeded requests
   (prompts of 12 to 3000 tokens, 16 new tokens each); every prefill
   launches ``flash_attention`` once per layer and every decoded token
   ``decode_attention`` (two kernels) once per layer; the same token
   streams re-run under teacher forcing through the plain attention
   functions agree within 1e-4 on every step's logits, with equal greedy
   tokens except where the plain path's top-2 margin is under 1e-4;
6. LM serving, bf16 (the config's own dtype): the same requests, timed
   (TTFT per prompt length, warm decode ms per token, tokens/s), drift
   against the plain path, profiler device busy per token, and the
   serving entry point ``repro_torch.launch.serve`` once at yi-6b;
7. summary: one JSON line of kernel numbers, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result.  Without a CUDA card it exits non-zero in phase 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_default import PAPER  # noqa: E402
from repro_torch.core import features  # noqa: E402
from repro_torch.core.start import STARTController  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    LAUNCHES_PER_CALL)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.kernels.lstm_cell import (  # noqa: E402
    lstm_cell, lstm_cell_ref)
from repro_torch.launch import serve as serve_entry  # noqa: E402
from repro_torch.models import backend  # noqa: E402
from repro_torch.models.lm import Model, full_precision  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine, EngineConfig, Request)
from repro_torch.serve.kv_cache import pad_to_length  # noqa: E402

# (batch, n_in, hidden): the JAX package's kernel sweep
# (tests/test_kernels.py LSTM_SWEEP) and the decision path's cell shapes
LSTM_SWEEP = [(8, 32, 32), (130, 32, 32), (64, 128, 64)]
PATH_SHAPES = [(1, 32, 32), (16, 32, 32), (256, 32, 32)]
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
FLASH_PATH = [(1, 32, 4, s, 128, True) for s in (12, 512, 2048)]
# (b, h, hkv, s, d, kv_len): the JAX decode sweep (DECODE_SWEEP), then
# yi-6b's decode shapes against a 4096-long cache
DECODE_SWEEP = [(1, 4, 4, 512, 64, 512), (2, 8, 2, 1024, 128, 700),
                (1, 16, 2, 512, 128, 512), (1, 4, 1, 300, 64, 300)]
DECODE_PATH = [(1, 32, 4, 4096, 128, n) for n in (1, 513, 4096)]
# fp32: max abs; bf16: the sweep's allclose tolerance
ATTN_TOL = {torch.float32: dict(rtol=0.0, atol=2e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
BF16_FLOP_PER_S = 989e12     # dense tensor-core peak
FLASH = dict(source="src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py"
             ":36")
DECODE = dict(source="src/repro_torch/kernels/decode_attention/csrc/"
              "decode_attention.cu",
              replaces="src/repro/kernels/decode_attention/"
              "decode_attention.py:25")

# LM serving: yi-6b at full width and depth, seeded weights
LM_ARCH = "yi-6b"
PROMPT_LENS = [12, 64, 300, 1000, 2048, 3000]
MAX_NEW, N_SLOTS, MAX_LEN = 16, 4, 4096
LOGIT_TOL = 1e-4             # fp32 engine vs plain path, max abs
DEVICE = "cuda"


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


def check_kernel() -> dict:
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
        row = dict(batch=bsz, n_in=n_in, hidden=hid, ms=min(k1, k2),
                   plain_ms=min(p1, p2), library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        print(f"[kernel] lstm_cell fp32 B={bsz}: kernel {row['ms']:.5f} ms "
              f"(runs {k1:.5f}, {k2:.5f}), plain {row['plain_ms']:.5f} ms, "
              f"torch.lstm_cell {lib_ms:.5f} ms, bound {bound_ms:.7f} ms "
              f"({bound_by})")
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


def _timing(name, label, kernel, plain, library, dtype, work) -> dict:
    """Kernel and plain alternated (so drift in clocks hits both), the
    library call, and the bound."""
    k1, p1 = time_auto(kernel), time_auto(plain)
    p2, k2 = time_auto(plain), time_auto(kernel)
    lib_ms = time_auto(library)
    bound_ms, bound_by = attn_bound(*work, dtype)
    row = dict(shape=label, dtype=str(dtype)[6:], ms=min(k1, k2),
               plain_ms=min(p1, p2), library_ms=lib_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    print(f"[kernel] {name} {label} {row['dtype']}: kernel {row['ms']:.5f} "
          f"ms (runs {k1:.5f}, {k2:.5f}), plain {row['plain_ms']:.5f} ms, "
          f"sdpa {lib_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by})")
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
            if (b, h, hkv, s, d, causal) != FLASH_PATH[-1]:
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


def check_decode() -> dict:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = []
    for i, (b, h, hkv, s, d, n) in enumerate(DECODE_SWEEP + DECODE_PATH):
        label = f"B={b} H={h} Hkv={hkv} S={s} D={d} kv_len={n}"
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(200 + i)
            q, k, v = (torch.randn(sh, generator=g).to("cuda", dtype)
                       for sh in ((b, h, d), (b, hkv, s, d), (b, hkv, s, d)))
            want = decode_attention_ref(q, k, v, kv_len=n)
            k[:, :, n:] = float("nan")     # past kv_len: never read
            v[:, :, n:] = float("nan")
            _compare("decode_attention", decode_attention(q, k, v, kv_len=n),
                     want, dtype, worst, label)
            if (b, h, hkv, s, d, n) != DECODE_PATH[-1]:
                continue

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
    return {"worst": worst, "timing": rows}


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


def compare_interval(t, ctrl_a, ctrl_b, tel, acts_a, acts_b) -> dict:
    """Hold run b against run a on one interval: E_S within the Tier-1
    bound, actions equal except for boundary jobs.  After a permitted
    flip, b takes a's trigger state so later intervals compare like with
    like."""
    ids = [int(j) for j in tel["job_ids"]]
    e_a = np.array([ctrl_a._es_cache[j] for j in ids], np.float32)
    e_b = np.array([ctrl_b._es_cache[j] for j in ids], np.float32)
    if not (np.isfinite(e_a).all() and np.isfinite(e_b).all()):
        raise AssertionError(f"interval {t}: E_S not finite")
    rel = float((np.abs(e_a.astype(np.float64) - e_b)
                 / np.maximum(np.abs(e_b), TIER1_ABS_FLOOR)).max())
    if rel > TIER1_REL:
        raise AssertionError(f"interval {t}: E_S drift {rel:.3e} > "
                             f"{TIER1_REL}")
    flips = 0
    key_a, key_b = _action_keys(acts_a), _action_keys(acts_b)
    if key_a != key_b:
        differ = {k[0] for k in set(key_a) ^ set(key_b)}
        allowed = boundary_jobs(ctrl_a, tel, e_a)
        if not differ <= allowed:
            raise AssertionError(
                f"interval {t}: actions differ for jobs {sorted(differ)} "
                f"away from any decision boundary")
        flips = len(differ)
        ctrl_b._mitigated = set(ctrl_a._mitigated)
        ctrl_b._streak = dict(ctrl_a._streak)
        ctrl_b._cool = dict(ctrl_a._cool)
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


def time_buckets(n_hosts: int, max_tasks: int, reps: int = 20) -> dict:
    """Warm medians, in host ms per interval at a fixed active-job count
    per bucket, of the whole decision (``decide``), of its prediction
    (the predictor call, which ends in the E_S readback) and of its
    trigger and mitigation planning on the host; then, from a profiled
    window at the smallest and largest bucket, the device's busy ms per
    interval and the kernel's own device time per launch."""
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
        for nb in (TIMED_BUCKETS[0], TIMED_BUCKETS[-1]):
            ctrl = STARTController(n_hosts=n_hosts, max_tasks=max_tasks,
                                   horizon=PAPER["horizon"], seed=SEED,
                                   trigger=trigger, device="cuda")
            tel_gen = Telemetry(n_hosts, max_tasks, seed=SEED + nb)
            for _ in range(3):
                decide(ctrl, tel_gen.step(nb))
            out[f"{trigger}/{nb}"].update(profile_intervals(ctrl, tel_gen,
                                                            nb))
    return out


def profile_intervals(ctrl, tel_gen, nb: int, reps: int = 10) -> dict:
    """Device time of ``reps`` decision intervals under torch.profiler:
    busy ms per interval (every kernel and copy) and the lstm_cell
    kernel's device time per launch."""
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
    out = dict(device_busy_ms=busy_us / 1e3 / reps if busy_us else None,
               device_ops_per_interval=n_dev / reps,
               kernel_device_ms=cell_us / 1e3 / cell_n if cell_n else None)
    print(f"[profile] bucket {nb} {ctrl.trigger}: device busy "
          f"{out['device_busy_ms']} ms/interval over "
          f"{out['device_ops_per_interval']} kernels and copies, lstm_cell "
          f"{out['kernel_device_ms']} ms/launch on the device ({cell_n} "
          f"launches)")
    return out


# ------------------------------ phases 5 and 6 ------------------------------

class Recorder:
    """The model as the engine sees it, keeping the logits of every call:
    prefill logits by prompt length, decode logits by position (the
    prompts' lengths are far enough apart that positions identify the
    request)."""

    def __init__(self, model: Model):
        self.model = model
        self.prefill_logits: dict[int, torch.Tensor] = {}
        self.decode_logits: dict[int, torch.Tensor] = {}

    def prefill(self, params, batch):
        logits, caches = self.model.prefill(params, batch)
        self.prefill_logits[batch["tokens"].shape[1]] = logits
        return logits, caches

    def decode_step(self, params, caches, tokens, pos):
        logits, caches = self.model.decode_step(params, caches, tokens, pos)
        self.decode_logits[pos] = logits
        return logits, caches


@contextlib.contextmanager
def plain_attention():
    """The model's attention through the plain PyTorch versions, on the
    card (the kernels' wrappers are not called)."""
    saved = backend.attention, backend.decode_attention
    backend.attention = (lambda q, k, v, *, causal=True:
                         attention_ref(q, k, v, causal=causal))
    backend.decode_attention = (lambda q, k, v, *, kv_len:
                                decode_attention_ref(q, k, v, kv_len=kv_len))
    try:
        yield
    finally:
        backend.attention, backend.decode_attention = saved


def lm_prompts(vocab: int) -> list[np.ndarray]:
    assert all(b - a > MAX_NEW for a, b in zip(PROMPT_LENS,
                                               PROMPT_LENS[1:]))
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def serve_engine(model: Model, params, prompts) -> dict:
    """The main path: ``Engine`` serving every prompt, launch counts set
    to 0 just before and read just after."""
    rec = Recorder(model)
    eng = Engine(rec, params, EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN))
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=p, max_new=MAX_NEW))
    torch.cuda.synchronize()
    flash_attention.launches = decode_attention.launches = 0
    lstm_cell.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash_attention=flash_attention.launches,
                    decode_attention=decode_attention.launches,
                    lstm_cell=lstm_cell.launches)
    n_layers = model.cfg.n_layers
    decoded = sum(len(r.out) - 1 for r in done)
    want = dict(flash_attention=n_layers * len(prompts),
                decode_attention=LAUNCHES_PER_CALL * n_layers * decoded,
                lstm_cell=0)
    if len(done) != len(prompts) or launches != want:
        raise AssertionError(f"engine: {len(done)} requests done, launches "
                             f"{launches}, expected {want}")
    tokens = sum(len(r.out) for r in done)
    print(f"[lm] engine served {len(done)} requests, {tokens} tokens in "
          f"{wall:.3f} s: flash_attention {launches['flash_attention']} "
          f"launches = {n_layers} x {len(prompts)} prefills, "
          f"decode_attention {launches['decode_attention']} = "
          f"{LAUNCHES_PER_CALL} x {n_layers} x {decoded} decoded tokens")
    return dict(done=sorted(done, key=lambda r: r.req_id), rec=rec,
                wall_s=wall, tokens=tokens, launches=launches)


def teacher_forced(model: Model, params, prompts, served) -> dict:
    """Every step of every request re-run through the plain attention
    functions on the card, fed the engine's tokens: logits drift against
    the engine's, greedy agreement, and the plain path's top-2 margin
    where they disagree."""
    rec, dev = served["rec"], params["embed"].device
    drift, agree, total, flips = 0.0, 0, 0, []
    f0, d0 = flash_attention.launches, decode_attention.launches
    with plain_attention():
        for p, req in zip(prompts, served["done"]):
            toks = torch.as_tensor(p, device=dev)[None]
            logits, caches = model.prefill(params, {"tokens": toks})
            caches = pad_to_length(caches, len(p) + MAX_NEW)
            steps = [(rec.prefill_logits[len(p)], logits)]
            for j, tok in enumerate(req.out[:-1]):
                logits, caches = model.decode_step(
                    params, caches, torch.tensor([[tok]], device=dev),
                    len(p) + j)
                steps.append((rec.decode_logits[len(p) + j], logits))
            for j, (eng_l, plain_l) in enumerate(steps):
                eng_l, plain_l = eng_l[0, -1], plain_l[0, -1]
                if not torch.isfinite(plain_l).all():
                    raise AssertionError("plain path: non-finite logits")
                drift = max(drift, (eng_l - plain_l).abs().max().item())
                total += 1
                if int(torch.argmax(plain_l)) == req.out[j]:
                    agree += 1
                    continue
                top2 = torch.topk(plain_l, 2).values
                flips.append(dict(req=req.req_id, step=j, token=req.out[j],
                                  plain_token=int(torch.argmax(plain_l)),
                                  margin=(top2[0] - top2[1]).item()))
            del caches
    if (flash_attention.launches, decode_attention.launches) != (f0, d0):
        raise AssertionError("the plain path launched a kernel")
    return dict(max_abs_drift=drift, agree=agree, steps=total, flips=flips)


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def lm_gate() -> dict:
    """Phase 5: fp32 at full width and depth, the correctness gate."""
    cfg = dataclasses.replace(get_config(LM_ARCH), param_dtype="float32")
    model = Model(cfg)
    matmul = torch.backends.cuda.matmul
    if (matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or matmul.allow_bf16_reduced_precision_reduction):
        raise AssertionError("reduced-precision products are on")
    t0 = time.perf_counter()
    params = model.init(SEED, DEVICE)
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name} fp32: {cfg.param_count() / 1e9:.3f} B params, "
          f"init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = lm_prompts(cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    served = serve_engine(model, params, prompts)
    tf = teacher_forced(model, params, prompts, served)
    for f in tf["flips"]:
        print(f"[lm] fp32 boundary flip: {f}")
    print(f"[lm] fp32 engine vs plain path: max abs logit drift "
          f"{tf['max_abs_drift']:.3e} (bound {LOGIT_TOL}), greedy tokens "
          f"equal {tf['agree']}/{tf['steps']}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not tf["max_abs_drift"] <= LOGIT_TOL:
        raise AssertionError(f"fp32 logits drift {tf['max_abs_drift']}")
    bad = [f for f in tf["flips"] if f["margin"] >= LOGIT_TOL]
    if bad:
        raise AssertionError(f"fp32 greedy tokens differ away from a top-2 "
                             f"tie: {bad}")
    out = dict(launches=served["launches"], wall_s=served["wall_s"],
               tokens=served["tokens"], **tf)
    del params, served
    free_cuda()
    return out


def _sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def lm_timing() -> dict:
    """Phase 6: bf16, the config's own dtype: the engine's run, warm TTFT
    per prompt length (prefill, cache padding and the first token, one
    request alone), warm decode ms per token, drift against the plain
    path, and a profiled window of decode steps."""
    cfg = get_config(LM_ARCH)
    model = Model(cfg)
    params = model.init(SEED, DEVICE)
    prompts = lm_prompts(cfg.vocab)
    served = serve_engine(model, params, prompts)
    tf = teacher_forced(model, params, prompts, served)
    print(f"[lm] bf16 engine vs plain path: max abs logit drift "
          f"{tf['max_abs_drift']:.3e}, greedy tokens equal "
          f"{tf['agree']}/{tf['steps']}")

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
    print(f"[lm] bf16 TTFT ms by prompt length (warm, alone): {ttft}")
    print(f"[lm] bf16 decode ms/token (B=1, warm median) by context: "
          f"{decode_ms}; engine {served['tokens']} tokens in "
          f"{served['wall_s']:.3f} s = {tok_s:.1f} tokens/s "
          f"({len(prompts)} requests, {N_SLOTS} slots, prefill included)")
    out = dict(ttft_ms=ttft, decode_ms=decode_ms, profile=decode_busy,
               prefill_profile=prefill_busy,
               engine_tok_per_s=tok_s, engine_wall_s=served["wall_s"],
               tokens=served["tokens"], launches=served["launches"],
               max_abs_drift=tf["max_abs_drift"], agree=tf["agree"],
               steps=tf["steps"], flips=len(tf["flips"]))
    del params, served
    free_cuda()
    return out


def profile_window(label: str, fn, reps: int) -> dict:
    """Device time of ``reps`` calls of ``fn`` under torch.profiler: busy
    ms per call (every kernel and copy) and the top device ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in ops)
    top = sorted(ops, key=lambda o: -o[1])[:6]
    out = dict(device_busy_ms=busy_us / 1e3 / reps,
               device_ops=sum(c for *_, c in ops) / reps,
               top=[dict(op=k[:60], ms=t / 1e3 / reps, calls=c / reps)
                    for k, t, c in top])
    print(f"[profile] {label}: device busy {out['device_busy_ms']:.4f} ms "
          f"per call over {out['device_ops']:.0f} kernels and copies; top: "
          + "; ".join(f"{t['op']} {t['ms']:.4f} ms x{t['calls']:.0f}"
                      for t in out['top']))
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


# --------------------------------- main ------------------------------------

def main() -> None:
    smi = environment()
    full_precision()
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {built} in {time.perf_counter() - t0:.2f} s wall")
    for name in built:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    cell = check_kernel()
    flash = check_flash()
    decode = check_decode()

    n_hosts, max_tasks = PAPER["n_hosts"], PAPER["max_tasks"]
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
                                 f"copies over {s['intervals']} intervals")
    print(f"[slice] lstm_cell launches {launches} = {layers * horizon} x "
          f"{fused} fused intervals; one staged copy per warm interval")
    buckets = time_buckets(n_hosts, max_tasks)

    gate = lm_gate()
    timing = lm_timing()
    served = serve_entry.main(["--arch", LM_ARCH, "--device", "cuda"])
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
        per_shape=cell["timing"])]
    # attention: launches from the fp32 gate's engine run; times at the
    # path's largest shape in bf16, the config's own dtype
    for name, meta, res in (("flash_attention", FLASH, flash),
                            ("decode_attention", DECODE, decode)):
        head = [r for r in res["timing"] if r["dtype"] == "bfloat16"][0]
        kernels.append(dict(
            name=name, route="cuda", **meta,
            launches=gate["launches"][name],
            max_abs_err=res["worst"][torch.float32],
            max_abs_err_bf16=res["worst"][torch.bfloat16],
            ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"],
            per_dtype=res["timing"]))
    print(json.dumps({"slice": slice_stats, "ms_per_interval": buckets}))
    print(json.dumps({"lm_fp32": {k: v for k, v in gate.items()
                                  if k != "flips"},
                      "lm_bf16": timing, "serve": served}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
