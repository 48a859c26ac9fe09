#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of START on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py

Run from the repository root, on a machine with the card and ``nvcc``.
Phases:

1. environment: a CUDA card, TF32 and bf16 reduced-precision reductions
   off, the card's name and power limit;
2. build: every CUDA kernel of the port (``lstm_cell``,
   ``flash_attention`` with its backward, ``decode_attention``,
   ``moe_router``, ``mamba_scan`` with its backward), from the sources
   in the checkout,
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
   one bf16 must fail; the scan's serving variant
   (``mamba_scan_with_state``, y and the final state) against its plain
   version and timed at falcon-mamba-7b's longest prefill; the flash
   Function's backward kernel (``flash_attention_bwd``) against its
   plain version and autograd through the plain attention, a second call
   bit for bit, at yi-6b's S = 2048 and the training layouts (GQA groups
   1, 3, 6, 8, Sq != Sk, ragged), timed beside SDPA's backward; the
   router's Function's gradient against autograd through its plain
   version;
   flash and decode also at the GQA groups 3, 6 and 8 (64 heads) of the
   archs ported last, and the router at deepseek-v3's 256 experts;
   flash non-causal at Sq != Sk (seamless-m4t-large-v2's cross-attention
   over 1024 frames at Sq = 1, 12, 300, 3000, and its encoder's 1024 x
   1024), decode at H = Hkv = 16, D = 64, the router at Jamba's 16
   experts, top-2, and the scan at Jamba's d_inner 16384 (forward,
   backward, final state), each new shape timed with its device time;
4. the decision slice: ``STARTController`` at the paper's width (400
   hosts x 11 features, 10 tasks per job, horizon 5), fed seeded
   telemetry, in both triggers, on the card and on the CPU from the same
   weights: E_S agrees within the Tier-1 bound, actions agree, every
   LSTM cell of the card's run went through the kernel, one staged copy
   per warm interval; then the warm ms per interval for each batch
   bucket, and the device's busy ms per interval and the cell's device
   time per launch (beside its bound and the floor) at 1, 16 and 256
   jobs.  Every START program here and in the phases below runs as its
   CUDA graph (``repro_torch.core.programs``: captured once per shape
   key, replayed after);
4b. the captured programs at the slice's width: at 1, 16 and 256 jobs,
   80 intervals (E_S and per-task scores in turns) of the fused step's
   replays bit-equal to the eager ``_fused_step`` on inputs assembled
   independently, one staged copy and one graph replay a warm interval;
   host ms per warm interval at each bucket, the graph and the eager
   step in turns on the same telemetry and equal, and at 1, 16 and 256
   jobs a profiled window each way (device ops, host-to-device and
   device-to-host copies, one each for the graph, and busy ms per
   interval); 20 steps of START's ``train_step`` (paper width, 64 of 256
   seeded examples a step, as ``fit`` runs it) and of IGRU-SD's
   ``_gru_step``, graph and eager in turns, every loss, param and Adam
   state bit-equal, ms per step each way; ``autotune_unroll``'s pinned
   choice at 1, 16 and 256 jobs; the captures made, their ms and their
   pools' bytes;
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
6b. the sweep fabric: that serial grid served by a ``FabricCoordinator``
   here (``REPRO_FABRIC_KEY`` set, the kernel libraries shipped with the
   grid) through ``sweep.run(spec, fabric=...)`` to two node agents
   spawned on localhost, one running cells inline and one over a local
   pool of two lanes: every cell bit-equal to serial, START and IGRU-SD
   cells run on the card in agents, each START cell launching
   ``lstm_cell`` in its agent as often as serially (counted per cell in
   the process that ran it), no library built again, every current
   library shipped and byte-equal once installed elsewhere; then the same
   grid to two single-lane agents with ``REPRO_TEST_KILL_CELL`` armed, one
   SIGKILLed mid-unit holding a CUDA context (exit code -9), the grid
   still bit-equal; the fabric's wall time beside the serial and pool
   times, the cells of each node, steals and dropped duplicates, and the
   bytes shipped;
7. LM serving, fp32: yi-6b at full width and depth (seeded weights),
   ``Engine(n_slots=4, max_len=4096)`` serving 6 seeded requests
   (prompts of 12 to 3000 tokens, 16 new tokens each); every prefill
   launches ``flash_attention`` once per layer and every decoded token
   ``decode_attention`` (one kernel) once per layer; every engine here
   and below decodes by replay (``serve/programs.py``: one capture a
   slot, four in all, each replay counted with the launches it records);
   the same token
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
10. MoE serving, bf16: qwen3-moe-30b-a3b at full width, 8 of its 48
   layers, timed as in phase 8, with the routing differences counted, and
   ``repro_torch.launch.serve`` once at qwen3-moe-30b-a3b;
11. SSM training, fp32: falcon-mamba-7b at full width, 8 of its 64
   layers (seeded weights), three AdamW steps of ``Trainer`` on
   ``SyntheticLM`` batches of 2 x 256 tokens through its compiled step
   (``train/programs.py``: here and in every training phase below the
   first step runs eagerly and captures the step as a CUDA graph, the
   others replay it; one capture a state tree, its ms and pool bytes
   printed), every layer's forward and its recompute in the backward
   launching ``mamba_scan`` and its backward ``mamba_scan_bwd``, counted
   through the replays; then from the params before each step the same
   loss through the plain scan (autograd of the plain version), within
   1e-5 relative, step 1's gradients within 1e-4 relative in norm, and
   the eager ``make_train_step``'s three steps from the same start
   bit-equal to the compiled ones: every loss, and after them every
   param and moment (``train_gate``);
12. SSM training, bf16: falcon-mamba-7b at full width, 16 of its 64
   layers, batches of 4 x 512 tokens, the compiled step once warm (its
   capture) and three replays timed (ms per step, tokens/s) and one
   profiled, then the eager step on the same state the same way (host
   and device busy ms per step, graph beside eager), one step by its
   parts (forward / backward / optimizer, and the scan backward's share
   timed inside it), peak memory (``train_timing``); and
   ``repro_torch.launch.train`` once, reduced, on the card;
12a. SSM serving, fp32: falcon-mamba-7b at full width, 8 of its 64
   layers, the engine and requests of phase 7; every prefill launches
   ``mamba_scan_with_state`` once per layer (the decode is plain ops);
   teacher-forced against the plain scan as in phase 7, and a prefill
   of S tokens against a prefill of S - 1 and a decode step, within
   1e-4;
12b. SSM serving, bf16: the same, timed as in phase 8 (TTFT, ms per
   token, device busy and ops per token beside the weight-read bound),
   and ``repro_torch.launch.serve`` once at falcon-mamba-7b;
12c. dense training: yi-6b at full width, an fp32 gate at 4 layers as
   phase 11's (attention through ``flash_attention``'s autograd Function,
   2 forward launches per layer per step and the backward kernel's 3,
   against autograd through the plain attention); bf16 at 8 layers, 2 x
   2048 tokens, as phase 12, with the attention backward's share of the
   step and
   the plain path's loss curve from the same seed beside the kernels';
   ``repro_torch.launch.train`` once at its default arch, demo-100m;
12d. MoE training: qwen3-moe-30b-a3b at full width, the fp32 gate at 2
   layers (the router's Function also 2 launches per MoE layer per step;
   the copies the training capacity drops counted on the eager steps;
   those steps bit-equal to the replays, so the recompute routes as the
   forward), bf16 at 4 layers as phase 12c;
12e. the decoder-only archs ported last, each at full width with the
   depth cuts of ``NEW_LM``: minitron-4b and phi4-mini-3.8b (GQA group
   3), deepseek-67b (group 8 at 64 heads), internvl2-26b (group 6; its
   256 seeded patch embeddings before three of the prompts, through
   prefill and decode, fp32 against the plain path as in phase 7, and in
   its training batches) and deepseek-v3-671b (MLA through the plain
   attention functions, the dense prefix, the shared expert, 256-expert
   routing; its absorbed decode also against a longer prefill; its
   training with the expert count cut): each an fp32 serving gate as
   phases 7 and 9, bf16 serving as phase 8 (``launch.serve`` where the
   whole model fits), an fp32 training gate and bf16 training as phases
   12c and 12d, and ``repro_torch.launch.train --reduced`` on the card;
12f. the encoder-decoder and the hybrid: seamless-m4t-large-v2 whole
   (an fp32 serving gate through ``prefill`` / ``decode_step`` with 1024
   seeded frame embeddings beside each of phase 7's prompts, held to the
   plain path as phase 7, and prefill then decode against one longer
   prefill; the ``Engine`` and ``launch.train`` refuse a frameless
   request with ``KeyError: 'frame_embeds'``, as the JAX drivers do; bf16
   serving timed; an fp32 training gate and bf16 training as phase 12c,
   the frames in every batch) and jamba-1.5-large-398b at one period of
   full width with the expert count cut (an fp32 serving gate at 4
   experts through the ``Engine``, held to the plain path within twice
   the plain path's own distance from a float64 forward; bf16 serving at
   12 experts timed; the bf16 loss and gradients at 2 experts, twice,
   bit-equal, with no optimizer step; the reduced config's fp32
   training gate, ``launch.train`` and ``launch.serve``);
12g. decode graphs: in the fp32 gate and the bf16 run of one arch of
   each family (yi-6b, qwen3-moe-30b-a3b, deepseek-v3-671b,
   falcon-mamba-7b, seamless-m4t-large-v2 through ``decode_step``,
   Jamba), the compiled decode step on one slot's caches at 4096
   positions against the eager step (``decode_graphs``): 6 replayed
   tokens bit-equal to the eager step at the same tensor position
   (logits and caches), that step within the fp32 gate's bound of the
   host-int one at the 300-token prompt, one capture, the launches a
   replay records and, in bf16
   at the longest prompt, in the trace; host ms per token graph and
   eager side by side with device busy and ops.  Then this phase: the
   decode kernel reading kv_len from the device against its plain version
   at kv_len 1, 28, 2048 and 4096 of a 4096-row cache whose rows past
   kv_len hold another request's keys, one launch captured and replayed
   at changing kv_len bit-equal to eager launches, its device time at
   its S-derived split beside the host-int launch's at kv_len 28 and
   4096; and every family's results held together;
13. the multi-tenant prediction service at the paper's width
   (``Profile(n_hosts=400, max_tasks=10, horizon=5, k=1.5)``), in both
   triggers: a service on the card and its CPU twin from one weight set
   (the twin's VersionStore is a copy of the card's) fed 16 tenants'
   seeded streams (1 to 32 live jobs an interval, finished jobs reported
   with Pareto durations), every tenant queued before one ``tick`` of
   each, for 40 intervals: E_S and scores within the Tier-1 bound, the
   actions held as in phase 4, 10 ``lstm_cell`` launches a tick on the
   card, a dispatch at bucket 512; a retrain -> shadow-eval -> promote
   cycle on both (losses within 1e-5 relative, the same decision and
   version, 10 launches per ``train_step`` and per shadow evaluation),
   the promoted model in lockstep, a rollback on both, lockstep again;
   degraded mode (a pointer to a version never saved) in lockstep; then
   the host ms of one tick at 1, 4 and 16 tenants, a profiled 16-tenant
   tick (device busy, ops, the cell's device time at bucket 512 beside
   its bound); a ``ServiceDaemon`` over TCP answering 16 threaded
   ``ServiceClient``s (snapshots/s, round-trip p50 and p99, tenants a
   tick); a daemon killed and restarted mid-stream (each snapshot applied
   once, the promoted version served after it); and
   ``repro_torch.launch.train`` killed by ``--kill-at`` (exit 42) and
   resumed, its losses bit-equal to an uninterrupted run's;
14. the training-pod straggler runtime at the paper's width (400 hosts,
   horizon 5, k = 1.5): every policy registered for the ``pod``
   substrate (ten, IGRU-SD fitted first by ``pretrain_igru_pod`` on a
   15-step warm run, 150 epochs, on the card), each on a runtime on the
   card and on a CPU twin from the same weights, in lockstep over 200
   steps of ``examples/pod_baseline_grid.py``'s trace (Pareto(2.0)
   noise, host 5 at 2.5x): equal actions at every step and equal
   summaries, E_S (the tail fit's, the network's, the service's answer
   and scores) and IGRU-SD's predictions within the Tier-1 bound, the
   online policy's epoch losses within 1e-5 relative (a difference in
   the actions only at a boundary step, where the runs part);
   ``start-pod-online`` launches ``lstm_cell`` 10 times per network
   prediction and per ``train_step``, ``start-pod-service`` 10 times per
   tick; each policy's backups, evictions and sync barrier, host ms per
   step, the online policy's ``fit`` ms per window, and device busy and
   ops per step of the two Encoder-LSTM policies (one profiled window);
   ``start-pod-service`` against a ``ServiceDaemon`` over TCP, its
   answers equal to the in-process run's; and ``repro_torch.launch.train
   --simulate-stragglers --n-hosts 400`` on the card, its
   ``[start-runtime]`` lines, summary and E_S equal to a ``--device cpu``
   run's;
14b. distribution: a one-rank NCCL process group (a ``FileStore`` in a
   temp dir) and ``make_host_mesh(1, 1)``; yi-6b at full width and the
   fp32 gate's depth (4 layers, 2 x 256): three steps of
   ``Trainer(model, mesh)`` (params and AdamW moments as DTensors), the
   flash kernel launched twice per layer per step under the mesh path,
   every loss and param bit-equal to the unsharded ``make_train_step``
   from the same params on the card, host ms per step beside the
   unsharded step's; EF-int8 and EF-top-k (1%) of that model's gradient
   tree (1.2 B fp32 values), three error-feedback rounds each, ms per
   tree and the payload bytes against fp32, the embed and ``wq`` leaves'
   reduced values and residuals bit-equal to a CPU twin over gloo (top-k's
   kept index sets too); the params saved and restored onto a fresh
   (1, 1) mesh through ``restore(..., mesh=, specs=)`` and moved by
   ``elastic.reshard``, values equal; and ``repro_torch.launch.dryrun``
   for yi-6b and deepseek-v3-671b at train_4k on both production meshes,
   run beside it in a process of its own (the meta device, no card): the
   plan, per-device bytes and FLOPs.  One card holds one rank (NCCL puts
   no two ranks on one GPU); the multi-rank paths are held on the CPU;
15. summary: one JSON line of kernel numbers, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Each phase prints its wall time.

Any failed check raises, so the script exits non-zero and prints no
result.  Without a CUDA card it exits non-zero in phase 1.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import io
import json
import multiprocessing
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.paper_default import PAPER  # noqa: E402
from repro_torch import policy as registry  # noqa: E402
from repro_torch.core import encoder_lstm as net  # noqa: E402
from repro_torch.core import features, programs  # noqa: E402
from repro_torch.core import predictor as predictor_mod  # noqa: E402
from repro_torch.core.predictor import (  # noqa: E402
    StragglerPredictor, bucket_size)
from repro_torch.core.start import STARTController  # noqa: E402
from repro_torch.distributed.straggler_runtime import (  # noqa: E402
    RuntimeConfig, ServiceBackedPodPolicy, StragglerRuntime,
    pretrain_igru_pod)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    LAUNCHES_PER_CALL, decode_split)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    BF16_EXCESS, bf16_rounding_excess)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_lse_ref, attention_ref, flash_attention, flash_attention_bwd,
    flash_attention_bwd_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.lstm_cell import (  # noqa: E402
    lstm_cell, lstm_cell_ref)
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_scan, mamba_scan_bwd, mamba_scan_bwd_ref, mamba_scan_ref,
    mamba_scan_with_state, mamba_scan_with_state_ref, scan_states_ref)
from repro_torch.kernels.mamba_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.moe_router import (  # noqa: E402
    moe_router, moe_router_ref)
from repro_torch.kernels.moe_router import ops as router_ops  # noqa: E402
from repro_torch.launch import serve as serve_entry  # noqa: E402
from repro_torch.launch import train as train_entry  # noqa: E402
from repro_torch.models import backend  # noqa: E402
from repro_torch.models import moe as Moe  # noqa: E402
from repro_torch.models.lm import Model, full_precision, layer  # noqa: E402
from repro_torch.policy import wire  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine, EngineConfig, Request)
from repro_torch.serve import programs as serve_programs  # noqa: E402
from repro_torch.serve.kv_cache import (  # noqa: E402
    load_into, pad_to_length, zeros_padded)
from repro_torch.service import (  # noqa: E402
    PredictionService, Profile, ServiceClient, ServiceConfig, ServiceDaemon)
from repro_torch.sim.config import SimConfig  # noqa: E402
from repro_torch.sim.engine import Simulation  # noqa: E402
from repro_torch.sim import fabric, sweep  # noqa: E402
from repro_torch.sim.scenarios import make_config  # noqa: E402
from repro_torch.sim.techniques import FIELD  # noqa: E402
from repro_torch.sim.techniques import baselines, start_tech  # noqa: E402
from repro_torch.train import optimizer as Opt  # noqa: E402
from repro_torch.train import programs as train_programs  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.checkpoint import VersionStore  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    Trainer, make_train_step, value_and_grad)
from repro_torch.distributed import sharding as Sh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

# (batch, n_in, hidden): the JAX package's kernel sweep
# (tests/test_kernels.py LSTM_SWEEP) and the paths' cell shapes: the
# decision's job buckets 1, 16 and 256, and START training's batch of 64
LSTM_SWEEP = [(8, 32, 32), (130, 32, 32), (64, 128, 64)]
PATH_SHAPES = [(1, 32, 32), (16, 32, 32), (64, 32, 32), (256, 32, 32)]
# the pod runtime's cell batches: start-pod-online's and the pod service's
# predictions (one job: batch 1), and its fit's whole set of 1..40 windows
# (200 steps of horizon 5), one batch an epoch
POD_STEPS = 200
POD_SHAPES = [(b, 32, 32) for b in range(2, POD_STEPS // 5 + 1) if b != 16]
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
# the other GQA geometries of the model paths, checked after the path
# shapes (their seeds follow): group 3 (minitron-4b, phi4-mini-3.8b), 6
# (internvl2-26b, with its 256 patches before 12 and 3000 tokens: ragged
# key tiles) and 8 at H = 64 (deepseek-67b)
FLASH_GQA = [(1, 24, 8, 300, 128, True), (1, 24, 8, 3000, 128, True),
             (1, 48, 8, 268, 128, True), (1, 48, 8, 3256, 128, True),
             (1, 64, 8, 300, 128, True), (1, 64, 8, 3000, 128, True)]
# (b, h, hkv, sq, sk, d, causal): seamless-m4t-large-v2's non-causal
# geometries, H = Hkv = 16, D = 64: the decoder's cross-attention of a
# decode step (Sq = 1) and of prefills (12, 300, 3000 tokens) over the
# encoder's 1024 frames, and the encoder's self-attention (1024 x 1024);
# all timed in bf16 (the config's dtype)
FLASH_CROSS = [(1, 16, 16, sq, 1024, 64, False) for sq in (1, 12, 300, 3000)
               ] + [(1, 16, 16, 1024, 1024, 64, False)]
# the Function's gradients: yi-6b's head layout at S = 2048
FLASH_GRAD = (1, 32, 4, 2048, 128, True)
# (b, h, hkv, sq, sk, d, causal): the backward kernel at the training
# paths' other layouts: yi-6b / qwen3 (G = 8), minitron-4b / phi4-mini
# (G = 3), internvl2-26b (G = 6, its 256 patches before 256 tokens),
# seamless-m4t-large-v2's encoder self-attention and decoder cross-
# attention over its 1024 frames (G = 1, D = 64, non-causal, Sq != Sk),
# and ragged query and key edges (S = 100 and 77)
FLASH_GRAD_SWEEP = [(2, 32, 4, 256, 256, 128, True),
                    (2, 24, 8, 256, 256, 128, True),
                    (1, 48, 8, 512, 512, 128, True),
                    (1, 16, 16, 1024, 1024, 64, False),
                    (2, 16, 16, 256, 1024, 64, False),
                    (1, 32, 4, 100, 100, 128, True),
                    (2, 16, 16, 77, 77, 64, True)]
# the backward's gradients against both plain versions: fp32 within 1e-5
# relative in norm; bf16 within ATTN_TOL elementwise and, in norm, within
# twice SDPA's backward's own relative error on the same inputs
FLASH_BWD_REL = 1e-5
FLASH_BWD_SDPA_FACTOR = 2.0
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
# those geometries' decode against a 4096-long cache
DECODE_GQA = [(1, 24, 8, 4096, 128, 28), (1, 24, 8, 4096, 128, 3016),
              (1, 48, 8, 4096, 128, 269), (1, 48, 8, 4096, 128, 3272),
              (1, 64, 8, 4096, 128, 4096)]
# seamless's decoder self-attention (H = Hkv = 16, D = 64), timed
DECODE_MHA = [(1, 16, 16, 4096, 64, 28), (1, 16, 16, 4096, 64, 3016)]
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
# the backward has no Pallas kernel: it replaces the custom VJP's _bwd,
# jax.vjp of the plain version
FLASH_BWD = dict(source=FLASH["source"],
                 replaces="src/repro/kernels/flash_attention/ops.py:57")
DECODE = dict(source="src/repro_torch/kernels/decode_attention/csrc/"
              "decode_attention.cu",
              replaces="src/repro/kernels/decode_attention/"
              "decode_attention.py:25")

# (tokens, experts, k): the JAX router sweep (tests/test_kernels.py
# ROUTER_SWEEP), then qwen3-moe-30b-a3b's router shapes (one decoded
# token, the shortest and the longest prompt)
ROUTER_SWEEP = [(256, 8, 2), (512, 128, 8), (300, 256, 8), (64, 16, 2)]
ROUTER_PATH = [(t, 128, 8) for t in (1, 12, 3000)]
# deepseek-v3's router shapes (E = 256, k = 8), checked after the path's
ROUTER_V3 = [(t, 256, 8) for t in (1, 12, 3000)]
# jamba-1.5-large-398b's router, 16 experts, top-2, on a decode step's,
# a short prompt's and the longest prompt's logits (timed at 3000)
ROUTER_JAMBA = [(t, 16, 2) for t in (1, 12, 3000)]
ROUTER_ATOL = 1e-6           # weights, taken expert by expert, max abs
ROUTER = dict(source="src/repro_torch/kernels/moe_router/csrc/moe_router.cu",
              replaces="src/repro/kernels/moe_router/moe_router.py:24")

# LM serving: yi-6b at full width and depth, seeded weights
LM_ARCH = "yi-6b"
PROMPT_LENS = [12, 64, 300, 1000, 2048, 3000]
MAX_NEW, N_SLOTS, MAX_LEN = 16, 4, 4096
LOGIT_TOL = 1e-4             # fp32 engine vs plain path, max abs
# falcon-mamba-7b's 64 layers: fp32 rounding grows layer by layer, and
# the plain fp32 path itself lies up to 1.7e-3 from a float64 forward at
# S = 300 (logits ~4.5; ``ssm_against_fp64`` prints it), as far as the
# kernel path does; so the SSM's engine is held to 2e-3 against the plain
# path, and, against a float64 forward, to twice the plain path's own
# error
SSM_LOGIT_TOL = 2e-3
FP64_PROMPTS = 3             # the shortest prompts checked against fp64
DEVICE = "cuda"
# MoE serving: qwen3-moe-30b-a3b at full width; the fp32 gate keeps 12 of
# its 48 layers (8.1 B params, 32.4 GB: all 48 in fp32 are 122 GB)
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_GATE_LAYERS = 12
# the smoke's time: since the archs ported last joined it, the bf16 MoE
# serving run keeps 8 of qwen3's 48 layers (80-115 s a run at 48, 56-97
# at 24, 43 at 12), and falcon-mamba-7b's serving gate and bf16 serving
# run 8 of its 64 (the plain scan's teacher forcing took 80-100 s each
# at 64, 47-67 at 32, 26-32 at 16; cut again to 8 when the encoder-
# decoder and hybrid phases joined); ``launch.serve`` still serves both
# whole
MOE_SERVE_LAYERS = 8
SSM_SERVE_LAYERS = 8
NEAR_TIE = 1e-5              # k-th vs (k+1)-th probability, relative
# (b, l, d, n): the JAX scan sweep (tests/test_kernels.py MAMBA_SWEEP),
# ragged shapes, then falcon-mamba-7b's training shapes (B x L x d_inner
# x N) of the fp32 gate and of the timed run
SCAN_SWEEP = [(1, 64, 128, 16), (2, 128, 64, 16), (1, 96, 256, 8),
              (3, 77, 200, 5), (1, 1, 3, 1), (2, 33, 129, 32)]
SCAN_PATH = [(2, 256, 8192, 16), (4, 512, 8192, 16)]
# the serving variant's path: falcon-mamba-7b's prefill of the longest
# prompt (PROMPT_LENS[-1] tokens)
SCAN_PREFILL = (1, 3000, 8192, 16)
# jamba-1.5-large-398b's Mamba sublayers (d_inner 16384): its gradient
# run's shape (2 x 1024 tokens; forward and backward) and its prefill of
# the longest prompt (the serving variant); both timed
SCAN_JAMBA = (2, 1024, 16384, 16)
SCAN_JAMBA_PREFILL = (1, 3000, 16384, 16)
SCAN_TIMED = SCAN_PATH + [SCAN_JAMBA]
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
# the bf16 run 16 (2.07 B params x 12 B = 25 GB; 32 until the timing ran
# the eager step beside the graph, for the smoke's time; 64 layers need
# 87 GB)
SSM_ARCH = "falcon-mamba-7b"
SSM_GATE_LAYERS, SSM_GATE_BATCH, SSM_GATE_SEQ = 8, 2, 256
SSM_LAYERS, SSM_BATCH, SSM_SEQ = 16, 4, 512
# dense and MoE training at full width, batches of B x S tokens: the fp32
# gates at yi-6b's 4 layers (1.23 B params x 16 B of params, gradients and
# AdamW moments = 19.7 GB) and qwen3-moe-30b-a3b's 2 (1.87 B, 30.0 GB);
# the bf16 runs at yi-6b's 8 layers (16 until the timing ran the eager
# step beside the graph, for the smoke's time; 16 are 3.31 B params x
# 12 B = 39.7 GB) and qwen3's 4 (3.12 B, 37.5 GB), with room for the
# plain attention backward's (B, Hkv, G, S, S) fp32 scores at S = 2048
# (1.07 GB a layer)
DENSE_GATE_LAYERS, MOE_TRAIN_GATE_LAYERS = 4, 2
LM_GATE_BATCH, LM_GATE_SEQ = 2, 256
DENSE_LAYERS, MOE_TRAIN_LAYERS = 8, 4
LM_BATCH, LM_SEQ = 2, 2048
# the decoder-only archs ported last, each at full width: the fp32
# serving gate's and the bf16 serving run's layers (None: all; for the
# smoke's time, since the encoder-decoder and hybrid phases joined,
# deepseek-67b's bf16 serving keeps 24 layers (48 before, 27 s) and
# internvl2-26b's 24 of 48 (39.5 s whole); since the distribution phase
# joined, minitron-4b and phi4-mini-3.8b serve 16 of their 32 layers,
# deepseek-67b 8 / 12 and internvl2-26b 12 / 12: on an H100 (700 W) the
# whole smoke took 988.9-1111.4 s with the earlier depths; since the
# captured programs' phase joined, minitron-4b and phi4-mini-3.8b serve
# 8: the smoke took 1001.6 s with 16), whether
# ``launch.serve`` serves it whole, the fp32 training gate's (layers,
# expert count; None: the config's) at LM_GATE_BATCH x LM_GATE_SEQ, and
# the bf16 training run's (layers, batch, seq, expert count).  Depth is
# cut by memory (params: ``param_count``; training ~12 B a parameter in
# bf16, 16 in fp32 plus the gate's three snapshots, 12 more): deepseek-67b
# could serve 48 of 95 layers in bf16 (34.9 B params, 70 GB), its fp32 gate 16
# (12.75 B, 51 GB), its training gate 1 and bf16 training 4 (4.45 B, 53
# GB); internvl2-26b's fp32 gate 24 of 48 (10.5 B, 42 GB), training gate
# 2, bf16 training 8 (4.28 B, 51 GB); minitron-4b and phi4-mini-3.8b
# train 4 layers in the gate and 8 in bf16 (16 until the timing ran the
# eager step beside the graph, as internvl2-26b's 4 were 8).
# deepseek-v3-671b keeps its 3 dense MLA layers and 2 (bf16) or 1 (fp32)
# MoE layers of all 256 experts in serving (26.64 / 15.14 B); in training
# the 256 experts' AdamW moments alone (11.3 B x 8 B per MoE layer) pass
# the card, so its training cuts the expert count, the one width-like cut:
# 12 in the fp32 gate (4.39 B x 12 B of params and moments = 49.1 GiB
# beside the captured step's pool, the snapshots in host memory, as
# deepseek-67b's: its 1-layer gate's 2.37 B x 28 B ran out of the card;
# 16 experts, 4.57 B x 12 B = 51.0 GiB, ran out in the capture, whose
# private pool cannot hand back its split free blocks while it captures
# as the eager step's cache does), 32 in bf16 (5.24 B x 12 B = 63 GB) at
# 2 x 1024 tokens (its plain MLA attention's (B, 128, S, S) fp32 scores
# are 4.3 GB a temporary at 2 x 2048); top-8, the expert width, the MLA
# ranks and the dense prefix stay
NEW_LM = {
    "minitron-4b": dict(gate=8, serve=8, serve_entry=True,
                        train_gate=(4, None), train=(8, 2, 2048, None)),
    "phi4-mini-3.8b": dict(gate=8, serve=8, serve_entry=True,
                           train_gate=(4, None),
                           train=(8, 2, 2048, None)),
    "deepseek-67b": dict(gate=8, serve=12, serve_entry=False,
                         train_gate=(1, None), train=(4, 2, 2048, None),
                         host_snapshots=True),
    "internvl2-26b": dict(gate=12, serve=12, serve_entry=True,
                          train_gate=(2, None), train=(4, 2, 2048, None)),
    "deepseek-v3-671b": dict(gate=4, serve=5, serve_entry=False,
                             train_gate=(4, 12), train=(4, 2, 1024, 32),
                             host_snapshots=True),
}
# the vlm's prompts served after its patch embeddings
PATCH_PROMPTS = (12, 300, 3000)
# LM training: GATE_STEPS steps in each fp32 gate, 1 warm and TIMED_STEPS
# timed in each bf16 run; OptConfig's default lr (3e-4) and launch.train's
# warmup rule (5 steps)
GATE_STEPS = TIMED_STEPS = 3
LM_OPT = dict(warmup_steps=5, total_steps=100)
# the port's kernels by their names in a profiler trace
OUR_KERNELS = ("flash_wgmma_kernel", "flash_attention_kernel",
               "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma",
               "flash_bwd_dq_f32", "flash_bwd_dkdv_f32",
               "flash_bwd_group_sum", "decode_kernel", "router_kernel",
               "scan_kernel", "scan_bwd_kernel", "scan_bwd_reduce_kernel")


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
    for i, (bsz, n_in, hid) in enumerate(LSTM_SWEEP + PATH_SHAPES
                                         + POD_SHAPES):
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
            if (bsz, n_in, hid) not in POD_SHAPES:
                print(f"[kernel] lstm_cell B={bsz} In={n_in} H={hid} "
                      f"{str(dtype)[6:]}: ok")
    print(f"[kernel] lstm_cell B={POD_SHAPES[0][0]}..{POD_SHAPES[-1][0]} "
          f"(the pod's fit batches) In=H=32, fp32 and bf16: ok")
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
    """``time_ms`` with as many calls as fit ``budget_ms`` (5 to 500); a
    warm call longer than the budget (a plain scan at d_inner 16384) is
    its own measurement."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    if once >= budget_ms:
        return once
    return time_ms(fn, reps=int(min(500, max(5, budget_ms / once))),
                   warmup=2)


def attn_bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time: bytes over HBM, or the products' FLOPs over the peak
    for the I/O type (bf16 tensor cores, fp32 CUDA cores)."""
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_work(b, h, hkv, s, d, causal, elem,
               sk: int | None = None) -> tuple[float, float]:
    """FLOPs of the two products over the (query, key) pairs the mask
    keeps (4 D each), and bytes of q, k, v read once and o written once;
    ``sk`` keys (default ``s``) for the ``s`` queries."""
    sk = s if sk is None else sk
    pairs = sum(min(q + 1, sk) for q in range(s)) if causal else s * sk
    return (4.0 * d * pairs * b * h,
            elem * (2 * b * h * s * d + 2 * b * hkv * sk * d))


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
    for i, (b, h, hkv, s, d, causal) in enumerate(FLASH_SWEEP + FLASH_PATH
                                                  + FLASH_GQA):
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
    cross = []
    for i, (b, h, hkv, sq, sk, d, causal) in enumerate(FLASH_CROSS):
        label = f"B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} D={d} causal={causal}"
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(150 + i)
            q, k, v = (torch.randn(sh, generator=g).to("cuda", dtype)
                       for sh in ((b, h, sq, d), (b, hkv, sk, d),
                                  (b, hkv, sk, d)))
            want = attention_ref(q, k, v, causal=causal)
            _compare("flash_attention", flash_attention(q, k, v, causal),
                     want, dtype, worst, label)
            if dtype != torch.bfloat16:
                continue
            lib = sdpa(q, k, v, is_causal=causal)
            torch.testing.assert_close(lib.float(), want.float(),
                                       **ATTN_TOL[torch.bfloat16])
            cross.append(_timing(
                "flash_attention", label,
                lambda: flash_attention(q, k, v, causal),
                lambda: attention_ref(q, k, v, causal=causal),
                lambda: sdpa(q, k, v, is_causal=causal), dtype,
                flash_work(b, h, hkv, sq, d, causal, q.element_size(), sk)))
            cross[-1]["device_us"] = launch_us(
                lambda: flash_attention(q, k, v, causal),
                "::flash_wgmma_kernel<", required=False)
            print(f"[kernel] flash_attention {label} bf16: "
                  f"{cross[-1]['device_us']} us device per launch")
    print(f"[kernel] flash_attention max abs err fp32 "
          f"{worst[torch.float32]:.3e} (bound 2e-5), bf16 "
          f"{worst[torch.bfloat16]:.3e} (bound 2e-2)")
    return {"worst": worst, "timing": rows, "cross": cross}


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


def launch_us(fn, name: str, reps: int = 20,
              required: bool = True) -> float | None:
    """Mean profiler device time, in us, of one launch of the kernels
    whose name holds ``name``, over ``reps`` warm calls of ``fn``.  A
    window whose trace came back without them (the profiler drops a
    window's device events now and then) is taken again, up to 3 times;
    then it raises, or, unless ``required``, returns None (not
    measured)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        hits = [v for k, v in _device_ops(fn, reps).items() if name in k]
        count = sum(c for _, c in hits)
        if count:
            return sum(t for t, _ in hits) / count / 1e3
    if not required:
        print(f"[kernel] {name}: no device events in 3 profiles, not "
              f"measured")
        return None
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
    mha = []
    for i, (b, h, hkv, s, d, n) in enumerate(DECODE_SWEEP + DECODE_PATH
                                             + DECODE_GQA + DECODE_MHA):
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
            if (b, h, hkv, s, d, n) in DECODE_MHA:
                def lib(q=q, k=k, v=v, n=n):
                    return sdpa(q[:, :, None], k[:, :, :n],
                                v[:, :, :n])[:, :, 0]

                torch.testing.assert_close(lib().float(), want.float(),
                                           **ATTN_TOL[torch.bfloat16])
                mha.append(_timing(
                    "decode_attention", label,
                    lambda: decode_attention(q, k, v, kv_len=n),
                    lambda: decode_attention_ref(q, k, v, kv_len=n), lib,
                    dtype, decode_work(b, h, hkv, d, n, q.element_size())))
                mha[-1]["device_us"] = launch_us(
                    lambda: decode_attention(q, k, v, kv_len=n),
                    "::decode_kernel<", required=False)
                print(f"[kernel] decode_attention {label} "
                      f"{str(dtype)[6:]}: {mha[-1]['device_us']} us "
                      f"device per launch")
                continue
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
            "bf16_excess": excess, "bf16_control_excess": control,
            "mha": mha}


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
    jamba = []
    for i, (t, e, k) in enumerate(ROUTER_SWEEP + ROUTER_PATH + ROUTER_V3
                                  + ROUTER_JAMBA):
        label = f"T={t} E={e} k={k}"
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(300 + i)
            logits = torch.randn(t, e, generator=g).to("cuda", dtype)
            want = moe_router_ref(logits, k)
            _compare_routing(label, moe_router(logits, k), want, worst, dtype)
            print(f"[kernel] moe_router {label} {str(dtype)[6:]}: ok")
            if (t, e, k) == ROUTER_JAMBA[-1] and dtype == torch.float32:
                _compare_routing(f"{label} (library)",
                                 router_library(logits, k), want,
                                 {dtype: 0.0}, dtype)
                jamba.append(_timing(
                    "moe_router", label, lambda: moe_router(logits, k),
                    lambda: moe_router_ref(logits, k),
                    lambda: router_library(logits, k), dtype,
                    router_work(t, e, k, logits.element_size()),
                    library_name="softmax+topk+renorm"))
                jamba[-1]["device_us"] = launch_us(
                    lambda: moe_router(logits, k), "::router_kernel<",
                    required=False)
                print(f"[kernel] moe_router {label} fp32: "
                      f"{jamba[-1]['device_us']} us device per launch")
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
    return {"worst": worst, "timing": rows, "device_us": device,
            "jamba": jamba}


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


def scan_bound(b, l, d, n, elem, last: bool = False) -> tuple[float, str]:
    """Least time for one scan: u, delta, b, c read once and y written
    once over HBM (with ``last``, also the (B, D, N) fp32 final state);
    or its operations, the larger of its fp32 multiplies and adds (6 per
    state per step, 3 per channel per step) over the fp32 peak and its
    b*l*d*n exponentials over the special-function rate."""
    nbytes = (elem * (3 * b * l * d + 2 * b * l * n) + 4 * (d * n + d)
              + (4 * b * d * n if last else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(b * l * d * (6 * n + 3) / FP32_FLOP_PER_S,
                b * l * d * n / SFU_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_scan() -> dict:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_rel = dict(worst)
    rows = []
    for i, (b, l, d, n) in enumerate(SCAN_SWEEP + SCAN_TIMED):
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
            if (b, l, d, n) not in SCAN_TIMED:
                continue
            k1 = time_auto(lambda: mamba_scan(*args))
            p1 = time_auto(lambda: mamba_scan_ref(*args))
            p2 = time_auto(lambda: mamba_scan_ref(*args))
            k2 = time_auto(lambda: mamba_scan(*args))
            bound_ms, bound_by = scan_bound(b, l, d, n, args[0].element_size())
            prof = profile_window(f"mamba_scan {label} {str(dtype)[6:]}",
                                  lambda: mamba_scan(*args), 10,
                                  need=("scan_kernel",))
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


def check_scan_with_state() -> dict:
    """The serving variant against its plain version at ``check_scan``'s
    shapes and a falcon-mamba-7b prefill of the longest prompt: y to the
    scan's tolerances, the final state bit for bit in fp32 (the kernel
    steps the states as the plain version does) and within 1e-4 in bf16
    (ex2.approx).  Timed at the prefill's shape beside the plain version,
    and at the timed training shape beside ``mamba_scan`` (the cost of
    the final state's store)."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = []
    for i, (b, l, d, n) in enumerate(SCAN_SWEEP + SCAN_PATH
                                     + [SCAN_PREFILL, SCAN_JAMBA_PREFILL]):
        label = f"B={b} L={l} D={d} N={n}"
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(b, l, d, n, dtype, seed=700 + i)
            before = mamba_scan_with_state.launches
            y, h = mamba_scan_with_state(*args)
            want_y, want_h = mamba_scan_with_state_ref(*args)
            torch.cuda.synchronize()
            if mamba_scan_with_state.launches != before + 1:
                raise AssertionError("mamba_scan_with_state did not launch")
            if not (torch.isfinite(y.float()).all()
                    and torch.isfinite(h).all()):
                raise AssertionError(f"mamba_scan_with_state {label}: "
                                     f"non-finite output")
            torch.testing.assert_close(y.float(), want_y.float(),
                                       **SCAN_TOL[dtype])
            if dtype == torch.float32:
                if not torch.equal(h, want_h):
                    raise AssertionError(f"mamba_scan_with_state {label}: "
                                         f"fp32 final state differs")
            else:
                torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
            err = max((y.float() - want_y.float()).abs().max().item(),
                      (h - want_h).abs().max().item())
            worst[dtype] = max(worst[dtype], err)
            print(f"[kernel] mamba_scan_with_state {label} "
                  f"{str(dtype)[6:]}: ok, max abs err {err:.3e}")
            timed = ((b, l, d, n) in (SCAN_PREFILL, SCAN_JAMBA_PREFILL)
                     or ((b, l, d, n) == SCAN_PATH[-1]
                         and dtype == torch.bfloat16))
            if not timed:
                continue
            k1 = time_auto(lambda: mamba_scan_with_state(*args))
            s1 = time_auto(lambda: mamba_scan(*args))
            p1 = time_auto(lambda: mamba_scan_with_state_ref(*args))
            p2 = time_auto(lambda: mamba_scan_with_state_ref(*args))
            s2 = time_auto(lambda: mamba_scan(*args))
            k2 = time_auto(lambda: mamba_scan_with_state(*args))
            bound_ms, bound_by = scan_bound(b, l, d, n,
                                            args[0].element_size(),
                                            last=True)
            prof = profile_window(
                f"mamba_scan_with_state {label} {str(dtype)[6:]}",
                lambda: mamba_scan_with_state(*args), 10,
                need=("scan_kernel",))
            dev = prof["kernels"].get("scan_kernel", {}).get("ms")
            row = dict(shape=label, dtype=str(dtype)[6:], ms=min(k1, k2),
                       scan_ms=min(s1, s2), plain_ms=min(p1, p2),
                       library_ms=None, bound_ms=bound_ms,
                       bound_by=bound_by, device_ms=dev)
            rows.append(row)
            print(f"[kernel] mamba_scan_with_state {label} {row['dtype']}: "
                  f"kernel {row['ms']:.5f} ms (runs {k1:.5f}, {k2:.5f}; "
                  f"device {dev} ms per launch), mamba_scan alone "
                  f"{row['scan_ms']:.5f} ms, plain {row['plain_ms']:.3f} ms, "
                  f"no PyTorch call computes it, bound {bound_ms:.6f} ms "
                  f"({bound_by})")
    print(f"[kernel] mamba_scan_with_state max abs err fp32 "
          f"{worst[torch.float32]:.3e} (y: 1e-5 * max(1, |y|), final state "
          f"bit for bit), bf16 {worst[torch.bfloat16]:.3e}")
    return {"worst": worst, "timing": rows}


def _norm_rel(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    want = want.double()
    return ((got.double() - want).norm() / want.norm()).item()


def flash_bwd_ptxas(d: int) -> dict:
    """ptxas's verdict on the bf16 backward's two passes at head dim d,
    from the build log: bytes of spill stores, and the note where it
    serialised the kernel's wgmma (a C75xx "Potential Performance Loss"),
    else None."""
    log = _build.build_log("flash_attention").splitlines()
    out = {}
    for name in ("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma"):
        tag, spill, serial = f"{name}ILi{d}E", None, None
        for i, line in enumerate(log):
            if tag not in line:
                continue
            if "Compiling entry" in line and i + 2 < len(log):
                m = re.search(r"(\d+) bytes spill stores", log[i + 2])
                spill = int(m.group(1)) if m else None
            m = re.search(r"\(C75\d\d\)[^']*? in the function", line)
            if m:
                serial = m.group(0)[:-len(" in the function")]
        out[name] = {"spill_bytes": spill, "serialised": serial}
    return out


def check_flash_grad() -> dict:
    """The flash Function's backward kernel (``flash_attention_bwd``) at
    yi-6b's head layout and S = 2048 (FLASH_GRAD), then across the
    training layouts of FLASH_GRAD_SWEEP, fp32 and bf16: through the
    Function, one forward and BWD_LAUNCHES_PER_CALL backward launches; its
    gradients against ``flash_attention_bwd_ref`` (fed the forward
    kernel's own o and lse) and against autograd through
    ``attention_ref``: fp32 within FLASH_BWD_REL relative in norm, bf16
    within ATTN_TOL elementwise and, in norm, within FLASH_BWD_SDPA_FACTOR
    times SDPA's backward's (``enable_gqa``) own error against the same
    reference; a second call bit for bit.  Timed at FLASH_GRAD: the
    backward kernel alone beside its plain version, SDPA's backward (the
    library yardstick) and the bound; the Function's forward and
    backward, and autograd through ``attention_ref`` (the Function's
    backward before the kernel); beside the bf16 passes' device ms, their
    ``numRegs`` and ``localSizeBytes`` (``cudaFuncGetAttributes``) and
    ptxas's verdict (``flash_bwd_ptxas``)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, hkv, s, d, causal = FLASH_GRAD
    shapes = [(b, h, hkv, s, s, d, causal)] + FLASH_GRAD_SWEEP
    rows, sweep = [], []
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_rel = dict(worst)
    for i, (b, h, hkv, sq, sk, d, causal) in enumerate(shapes):
        label = (f"B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} D={d} "
                 f"causal={causal}")
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            gen = torch.Generator().manual_seed(800 + i)
            q, k, v, g = (torch.randn(sh, generator=gen).to("cuda", dtype)
                          for sh in ((b, h, sq, d), (b, hkv, sk, d),
                                     (b, hkv, sk, d), (b, h, sq, d)))
            xs = [t.clone().requires_grad_() for t in (q, k, v)]
            before = flash_attention.launches, flash_attention_bwd.launches
            out = flash_attention(*xs, causal)
            got = torch.autograd.grad(out, xs, g)
            torch.cuda.synchronize()
            fwd = 1 if bf16 else -(-(b * h) // 65535)
            launched = (flash_attention.launches - before[0],
                        flash_attention_bwd.launches - before[1])
            if launched != (fwd, flash_ops.BWD_LAUNCHES_PER_CALL):
                raise AssertionError(f"flash Function {label}: launches "
                                     f"{launched}, expected {fwd} forward, "
                                     f"{flash_ops.BWD_LAUNCHES_PER_CALL} "
                                     f"backward")
            o, lse = flash_ops._forward(q, k, v, causal, None, with_lse=True)
            if not torch.equal(o, out.detach()):
                raise AssertionError(f"flash forward {label}: o with lse "
                                     f"differs from the Function's")
            again = flash_attention_bwd(q, k, v, o, lse, g, causal)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd {label}: two "
                                     f"calls gave different gradients")
            del again
            refs = {"plain": flash_attention_bwd_ref(q, k, v, o, lse, g,
                                                     causal)}
            ys = [t.clone().requires_grad_() for t in (q, k, v)]
            refs["autograd"] = torch.autograd.grad(
                attention_ref(*ys, causal=causal), ys, g)
            zs = [t.clone().requires_grad_() for t in (q, k, v)]
            lib = (torch.autograd.grad(sdpa(*zs, is_causal=causal,
                                            enable_gqa=True), zs, g)
                   if bf16 else None)
            rel, lib_rel = {}, {}
            for ref, want in refs.items():
                rel[ref] = [_norm_rel(a, w) for a, w in zip(got, want)]
                bound = [FLASH_BWD_REL] * 3
                if bf16:
                    lib_rel[ref] = [_norm_rel(c, w)
                                    for c, w in zip(lib, want)]
                    bound = [FLASH_BWD_SDPA_FACTOR * r for r in lib_rel[ref]]
                for name, a, w, r, bnd in zip("qkv", got, want, rel[ref],
                                              bound):
                    if not torch.isfinite(a.float()).all():
                        raise AssertionError(f"flash_attention_bwd {label}: "
                                             f"non-finite d{name}")
                    if bf16:
                        torch.testing.assert_close(a.float(), w.float(),
                                                   **ATTN_TOL[dtype])
                    if not r <= bnd:
                        raise AssertionError(
                            f"flash_attention_bwd {label} {str(dtype)[6:]}: "
                            f"d{name} differs from the {ref} backward by "
                            f"{r:.3e} in norm (bound {bnd:.3e})")
                    worst[dtype] = max(worst[dtype],
                                       (a.float() - w.float()).abs().max()
                                       .item())
                worst_rel[dtype] = max(worst_rel[dtype], *rel[ref])
            flops, nbytes = flash_work(b, h, hkv, sq, d, causal,
                                       q.element_size(), sk=sk)
            # the backward's five products (dV = P^T dO, dP = dO V^T,
            # S = Q K^T again, dQ = dS K, dK = dS^T Q): 2.5x the forward's
            # FLOPs over the pairs the mask keeps; q, k, v, o, do and lse
            # read once, dq, dk, dv written once
            bound_ms, bound_by = attn_bound(2.5 * flops,
                                            2 * nbytes + 4 * b * h * sq,
                                            dtype)
            row = dict(shape=label, dtype=str(dtype)[6:], rel=rel,
                       sdpa_rel=lib_rel or None, bound_ms=bound_ms,
                       bound_by=bound_by)
            print(f"[kernel] flash_attention_bwd {label} {row['dtype']}: "
                  f"dq, dk, dv rel in norm against the plain backward "
                  f"{[f'{r:.2e}' for r in rel['plain']]}, against autograd "
                  f"{[f'{r:.2e}' for r in rel['autograd']]}"
                  + (f" (SDPA's {[f'{r:.2e}' for r in lib_rel['autograd']]};"
                     f" bound {FLASH_BWD_SDPA_FACTOR}x SDPA's)" if bf16 else
                     f" (bound {FLASH_BWD_REL})")
                  + "; a second call equal bit for bit")
            if i:
                sweep.append(row)
                del xs, ys, zs, got, refs, lib, out
                continue
            zs = [t.clone().requires_grad_() for t in (q, k, v)]
            out_s = sdpa(*zs, is_causal=causal, enable_gqa=True)

            def kernel():
                return flash_attention_bwd(q, k, v, o, lse, g, causal)

            def plain():
                return flash_attention_bwd_ref(q, k, v, o, lse, g, causal)

            def library():
                return torch.autograd.grad(out_s, zs, g, retain_graph=True)

            k1, p1 = time_auto(kernel), time_auto(plain)
            s1, s2 = time_auto(library), time_auto(library)
            p2, k2 = time_auto(plain), time_auto(kernel)
            f1 = time_auto(lambda: torch.autograd.grad(
                flash_attention(*xs, causal), xs, g))
            a1 = time_auto(lambda: torch.autograd.grad(
                attention_ref(*ys, causal=causal), ys, g))
            passes = (("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma") if bf16
                      else ("flash_bwd_dq_f32", "flash_bwd_dkdv_f32")) + (
                "flash_bwd_group_sum",)
            prof = profile_window(f"flash_attention_bwd {label} "
                                  f"{str(dtype)[6:]}", kernel, 10,
                                  need=passes)
            # the bf16 passes' registers a thread at launch and local
            # memory a thread (0 bytes: nothing spilled), and ptxas's
            # spills and serialised wgmma
            attrs = flash_ops.bwd_kernel_attributes(d) if bf16 else {}
            ptxas = flash_bwd_ptxas(d) if bf16 else None
            row.update(ms=min(k1, k2), plain_ms=min(p1, p2),
                       sdpa_bwd_ms=min(s1, s2), fwd_bwd_ms=f1,
                       autograd_ms=a1, device_ms={
                           n: prof["kernels"].get(n, {}).get("ms")
                           for n in passes},
                       num_regs={n: a[0] for n, a in attrs.items()},
                       local_bytes={n: a[1] for n, a in attrs.items()},
                       ptxas=ptxas)
            rows.append(row)
            print(f"[kernel] flash_attention_bwd {label} {row['dtype']}: "
                  f"kernel {row['ms']:.4f} ms (runs {k1:.4f}, {k2:.4f}; "
                  f"device ms per pass {row['device_ms']}"
                  + (f"; numRegs {row['num_regs']}, localSizeBytes "
                     f"{row['local_bytes']}, ptxas {ptxas}" if bf16 else "")
                  + "), "
                  f"plain {row['plain_ms']:.3f} ms, SDPA backward "
                  f"{row['sdpa_bwd_ms']:.4f} ms (runs {s1:.4f}, {s2:.4f}), "
                  f"bound {bound_ms:.4f} ms ({bound_by}); the Function's "
                  f"forward + backward {f1:.3f} ms, autograd through the "
                  f"plain version (recompute + VJP) {a1:.3f} ms")
            del xs, ys, zs, got, refs, lib, out, out_s
            free_cuda()
    print(f"[kernel] flash_attention_bwd largest error against the plain "
          f"versions fp32 {worst[torch.float32]:.3e} (max abs), "
          f"{worst_rel[torch.float32]:.3e} (in norm); bf16 "
          f"{worst[torch.bfloat16]:.3e}, {worst_rel[torch.bfloat16]:.3e}")
    return {"worst": worst, "worst_rel": worst_rel, "timing": rows,
            "sweep": sweep}


def check_router_grad() -> dict:
    """The router Function's logits gradient against autograd through
    ``moe_router_ref`` (its sort differentiated) at qwen3-moe-30b-a3b's
    prefill of 3000 tokens (E = 128, k = 8), fp32 logits: the same
    indices, the gradient within 1e-5 relative in norm.  Timed: the
    Function's forward and backward, the plain version's under autograd,
    and the library's (softmax + topk + renormalise) under autograd."""
    t, e, k = ROUTER_PATH[-1]
    gen = torch.Generator().manual_seed(900)
    logits = torch.randn(t, e, generator=gen).cuda()
    gw = torch.randn(t, k, generator=gen).cuda()
    xs, ys, zs = (logits.clone().requires_grad_() for _ in range(3))
    before = moe_router.launches
    w, idx = moe_router(xs, k)
    (got,) = torch.autograd.grad(w, xs, gw)
    torch.cuda.synchronize()
    if moe_router.launches != before + 1:
        raise AssertionError("the router Function did not launch once")
    wr, ir = moe_router_ref(ys, k)
    (want,) = torch.autograd.grad(wr, ys, gw)
    if not torch.equal(idx, ir):
        raise AssertionError("router Function: indices differ from the plain "
                             "version's")
    rel = ((got.double() - want.double()).norm()
           / want.double().norm()).item()
    err = (got - want).abs().max().item()
    if not (torch.isfinite(got).all() and rel <= 1e-5):
        raise AssertionError(f"router Function gradient differs by {rel}")

    def fwd_bwd(fn, x):
        def run():
            return torch.autograd.grad(fn(x, k)[0], x, gw)
        return run

    f1 = time_auto(fwd_bwd(moe_router, xs))
    p1 = time_auto(fwd_bwd(moe_router_ref, ys))
    lib = time_auto(fwd_bwd(router_library, zs))
    p2 = time_auto(fwd_bwd(moe_router_ref, ys))
    f2 = time_auto(fwd_bwd(moe_router, xs))
    row = dict(shape=f"T={t} E={e} k={k}", dtype="float32",
               fwd_bwd_ms=min(f1, f2), plain_fwd_bwd_ms=min(p1, p2),
               library_fwd_bwd_ms=lib, grad_rel=rel, max_abs_err=err)
    print(f"[kernel] moe_router Function T={t} E={e} k={k} fp32: logits "
          f"gradient against autograd through the plain version rel "
          f"{rel:.3e} (bound 1e-5), max abs {err:.3e}, same indices; "
          f"forward + backward {row['fwd_bwd_ms']:.4f} ms (runs {f1:.4f}, "
          f"{f2:.4f}), plain under autograd {row['plain_fwd_bwd_ms']:.4f} "
          f"ms, softmax+topk+renorm under autograd {lib:.4f} ms")
    return row


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
    for i, (b, l, d, n) in enumerate(SCAN_SWEEP + SCAN_TIMED):
        label = f"B={b} L={l} D={d} N={n}"
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(b, l, d, n, dtype, seed=500 + i)
            g = torch.randn(b, l, d, generator=torch.Generator().manual_seed(
                600 + i)).to("cuda", dtype)
            _, states, _ = scan_ops._launch(*args, keep_states=True)
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
            if (b, l, d, n) not in SCAN_TIMED:
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
                                  10, need=("scan_bwd_kernel",
                                            "scan_bwd_reduce_kernel"))
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


# --------------------------------- phase 4b --------------------------------
# the captured programs: each START program replayed from its CUDA graph,
# held to its eager function and timed beside it

GRAPH_JOBS = (1, 16, 256)       # job counts of the replay-vs-eager check
GRAPH_INTERVALS = 80            # the slice's intervals (2 triggers x 40)
GRAPH_PROFILED = 10             # warm intervals in a profiled window
GRAPH_STEPS = 20                # train_step and _gru_step, graph vs eager
GRAPH_TRAIN_N = 256             # START training examples at paper width
GRU_TRAIN = (5, 512, 3)         # IGRU-SD's training set: T, tasks, features


class EagerIntervals:
    """The decision step without graphs, as the predictor ran it before
    its programs were captured: the packed vector [k, beta_scale, newest
    row, q padded with 1, M_T padded with 0] staged from a pinned buffer,
    the eager ``_fused_step`` rolling a ring tensor of its own (built from
    ``hist``, the rows before the next call's, left-padded with the
    oldest), one readback."""

    def __init__(self, pred: StragglerPredictor, hist: list):
        self.pred = pred
        prev = list(hist[:-1]) or [hist[0]]
        while len(prev) < pred.horizon:
            prev.insert(0, prev[0])
        self.ring = torch.from_numpy(np.stack(
            prev[-pred.horizon:]).reshape(pred.horizon, -1)).to(DEVICE)
        self.bufs: dict[int, torch.Tensor] = {}

    def __call__(self, row: np.ndarray, mt: np.ndarray, q: np.ndarray,
                 per_task: bool = False) -> np.ndarray:
        p = self.pred
        n = mt.shape[0]
        nb = p.batch_size(n)
        hd, td = p.host_dim, p.task_dim
        staged = self.bufs.get(nb)
        if staged is None:
            staged = self.bufs[nb] = torch.zeros(
                2 + hd + nb * (1 + td), dtype=torch.float32,
                pin_memory=torch.device(DEVICE).type == "cuda")
        buf = staged.numpy()
        buf[0], buf[1] = np.float32(p.k), np.float32(p.beta_scale)
        buf[2:2 + hd] = row.reshape(-1)
        buf[2 + hd:2 + hd + nb] = 1.0
        buf[2 + hd:2 + hd + n] = q
        buf[2 + hd + nb:] = 0.0
        buf[2 + hd + nb:2 + hd + nb + n * td] = mt.reshape(-1)
        self.ring, out = predictor_mod._fused_step(
            p.params, self.ring, staged.to(DEVICE, non_blocking=True),
            nb=nb, task_dim=td, per_task=per_task)
        return out.cpu().numpy()[:n]


def graph_fused_parity(n_hosts: int, max_tasks: int) -> dict:
    """At each of ``GRAPH_JOBS``, ``GRAPH_INTERVALS`` intervals (every
    other one with per-task scores) of one predictor's fused-step
    programs against the eager ``_fused_step`` on inputs and a ring
    assembled apart (``EagerIntervals``): equal bit for bit.  Per warm
    interval, one staged copy and one graph replay."""
    out = {}
    for n_jobs in GRAPH_JOBS:
        pred = StragglerPredictor(n_hosts=n_hosts, max_tasks=max_tasks,
                                  horizon=PAPER["horizon"], seed=SEED,
                                  device=DEVICE)
        tel_gen = Telemetry(n_hosts, max_tasks, seed=SEED + n_jobs)
        eager, unequal, worst = None, 0, 0.0
        stages, replays = [], []
        for t in range(GRAPH_INTERVALS):
            tel = tel_gen.step(n_jobs)
            per_task = bool(t % 2)
            pred.k = K_LO + (K_HI - K_LO) * float(tel["host_load"].mean())
            row = np.ascontiguousarray(tel["m_h"], np.float32)
            eager = eager or EagerIntervals(pred, [row])
            pred.push_host_row(row)
            s0, r0 = pred.h2d_stages, programs.stats["replays"]
            got = pred.predict_interval(tel["m_t"], tel["q"],
                                        per_task=per_task)
            stages.append(pred.h2d_stages - s0)
            replays.append(programs.stats["replays"] - r0)
            if per_task:
                got = np.concatenate([got[0][:, None], got[1]], axis=1)
            want = eager(row, tel["m_t"], tel["q"], per_task)
            if not np.array_equal(got, want, equal_nan=True):
                unequal += 1
                worst = max(worst, float(np.nanmax(np.abs(got - want))))
        # the first interval stages the ring and the packed batch, and the
        # first of each trigger may capture (a key new to the process)
        # instead of replaying; the CPU (a rehearsal) replays nothing
        once = int(torch.device(DEVICE).type == "cuda")
        if stages != [2] + [1] * (GRAPH_INTERVALS - 1) \
                or max(replays[:2]) > once \
                or replays[2:] != [once] * (GRAPH_INTERVALS - 2):
            raise AssertionError(f"{n_jobs} jobs: staged copies {stages}, "
                                 f"replays {replays} an interval")
        if unequal:
            raise AssertionError(f"{n_jobs} jobs: {unequal} of "
                                 f"{GRAPH_INTERVALS} intervals differ from "
                                 f"the eager step, up to {worst:.3e}")
        out[n_jobs] = dict(intervals=GRAPH_INTERVALS, bucket=pred.batch_size(
            n_jobs), bit_equal=True, staged_per_warm_interval=1,
            replays_per_warm_interval=1)
        print(f"[graphs] {n_jobs} jobs: {GRAPH_INTERVALS} intervals "
              f"(E_S and per-task scores) replayed bit-equal to the eager "
              f"_fused_step; 1 staged copy and 1 graph replay a warm "
              f"interval")
    return out


def _copies(ops: dict, what: str) -> int:
    return sum(c for k, (_, c) in ops.items() if what in k)


def graph_intervals(n_hosts: int, max_tasks: int, reps: int = 20) -> dict:
    """Host ms per warm interval at each of ``TIMED_BUCKETS`` jobs, the
    graph path (``predict_interval``) and the eager step side by side in
    turns on the same telemetry; then a profiled window of
    ``GRAPH_PROFILED`` warm intervals each way at 1, 16 and 256 jobs: the
    device's ops, the host-to-device and device-to-host copies, busy ms
    per interval."""
    out = {}
    for nb in TIMED_BUCKETS:
        pred = StragglerPredictor(n_hosts=n_hosts, max_tasks=max_tasks,
                                  horizon=PAPER["horizon"], seed=SEED,
                                  device=DEVICE)
        tel_gen = Telemetry(n_hosts, max_tasks, seed=SEED + nb)
        hist = [np.ascontiguousarray(tel_gen.step(nb)["m_h"], np.float32)]
        eager = EagerIntervals(pred, hist)
        pred.push_host_row(hist[-1])
        graph_ms, eager_ms = [], []

        def both(tel, timed: bool):
            row = np.ascontiguousarray(tel["m_h"], np.float32)
            pred.push_host_row(row)
            t0 = time.perf_counter()
            got = pred.predict_interval(tel["m_t"], tel["q"])
            t1 = time.perf_counter()
            want = eager(row, tel["m_t"], tel["q"])
            t2 = time.perf_counter()
            if not np.array_equal(got, want, equal_nan=True):
                raise AssertionError(f"bucket {nb}: the replay and the "
                                     f"eager step differ")
            if timed:
                graph_ms.append((t1 - t0) * 1e3)
                eager_ms.append((t2 - t1) * 1e3)

        for i in range(reps + 3):
            both(tel_gen.step(nb), i >= 3)
        row = dict(graph_ms=float(np.median(graph_ms)),
                   eager_ms=float(np.median(eager_ms)))
        if nb in PROFILED_BUCKETS:
            tels = [tel_gen.step(nb) for _ in range(GRAPH_PROFILED)]
            it = iter(tels)

            def graph_one():
                tel = next(it)
                pred.push_host_row(np.ascontiguousarray(tel["m_h"],
                                                        np.float32))
                pred.predict_interval(tel["m_t"], tel["q"])

            g_ops = _device_ops(graph_one, GRAPH_PROFILED)
            it = iter(tels)

            def eager_one():
                tel = next(it)
                eager(np.ascontiguousarray(tel["m_h"], np.float32),
                      tel["m_t"], tel["q"])

            e_ops = _device_ops(eager_one, GRAPH_PROFILED)
            for name, ops in (("graph", g_ops), ("eager", e_ops)):
                row[f"{name}_device_ops"] = sum(
                    c for _, c in ops.values()) / GRAPH_PROFILED
                row[f"{name}_busy_ms"] = sum(
                    t for t, _ in ops.values()) / 1e6 / GRAPH_PROFILED
                row[f"{name}_h2d"] = _copies(ops, "HtoD") / GRAPH_PROFILED
                row[f"{name}_d2h"] = _copies(ops, "DtoH") / GRAPH_PROFILED
                row[f"{name}_cell_launches"] = sum(
                    c for k, (_, c) in ops.items()
                    if "lstm_cell_kernel" in k) / GRAPH_PROFILED
            print(f"[graphs] bucket {nb}: device ops per interval "
                  f"{row['graph_device_ops']} graph / "
                  f"{row['eager_device_ops']} eager; copies HtoD "
                  f"{row['graph_h2d']} / {row['eager_h2d']}, DtoH "
                  f"{row['graph_d2h']} / {row['eager_d2h']}; busy "
                  f"{row['graph_busy_ms']:.4f} / {row['eager_busy_ms']:.4f}"
                  f" ms")
            # the staged copies are counted exactly in graph_fused_parity;
            # a trace may miss the window's first copy, never adds one
            if row["graph_h2d"] > 1 or row["graph_d2h"] > 1:
                raise AssertionError(f"bucket {nb}: a warm interval traced "
                                     f"{row['graph_h2d']} staged copies and "
                                     f"{row['graph_d2h']} readbacks")
        out[nb] = row
    print("[graphs] host ms per warm interval (graph / eager): " + ", ".join(
        f"{nb}: {r['graph_ms']:.3f} / {r['eager_ms']:.3f}"
        for nb, r in out.items()))
    return out


def _bit_equal(got, want) -> bool:
    """Every tensor leaf of ``got`` equal to ``want``'s bit for bit
    (``want``'s moved to ``got``'s device; ``None`` leaves, an optimizer
    state's unused fields, skipped)."""
    a = [t for t in convert.leaves(got) if t is not None]
    b = [t for t in convert.leaves(want) if t is not None]
    return len(a) == len(b) and all(
        torch.equal(x, y.to(x.device)) for x, y in zip(a, b))


def graph_training() -> dict:
    """``GRAPH_STEPS`` Adam steps of START's ``train_step`` at the paper's
    width (64 of ``GRAPH_TRAIN_N`` seeded examples a step) through its
    program (``net.Training``, as ``fit`` runs it) and eagerly, in turns:
    every loss, every param and the Adam state bit-equal; ms per step
    each way; 10 ``lstm_cell`` launches a step each way.  Then IGRU-SD's
    ``_gru_step`` likewise on ``GRU_TRAIN``."""
    pred = start_controller(DEVICE).predictor
    rng = np.random.default_rng(SEED)
    xs = rng.uniform(0, 1, (PAPER["horizon"], GRAPH_TRAIN_N,
                            pred.input_dim)).astype(np.float32)
    ys = np.stack([rng.uniform(1, 4, GRAPH_TRAIN_N),
                   rng.uniform(0.1, 3, GRAPH_TRAIN_N)], -1).astype(np.float32)
    steps = net.Training(pred.params, pred.opt, xs, ys, TRAIN_BATCH,
                         TRAIN_LR)
    xs_d, ys_d = torch.from_numpy(xs).to(DEVICE), torch.from_numpy(ys).to(
        DEVICE)
    params, opt = pred.params, pred.opt
    g_loss, e_loss, g_ms, e_ms = [], [], [], []
    lstm_cell.launches = 0
    for _ in range(GRAPH_STEPS):
        idx = rng.permutation(GRAPH_TRAIN_N)[:TRAIN_BATCH]
        t0 = time.perf_counter()
        g_loss.append(steps.step(idx))
        t1 = time.perf_counter()
        idx_d = torch.from_numpy(idx).to(DEVICE)
        params, opt, loss = net.train_step(params, opt, xs_d[:, idx_d],
                                           ys_d[idx_d], lr=TRAIN_LR)
        e_loss.append(float(loss))
        t2 = time.perf_counter()
        g_ms.append((t1 - t0) * 1e3)
        e_ms.append((t2 - t1) * 1e3)
    launches = lstm_cell.launches
    g_params, g_opt = steps.result()
    if g_loss != e_loss or not _bit_equal((g_params, g_opt), (params, opt)):
        raise AssertionError(f"train_step graph vs eager: losses {g_loss} "
                             f"against {e_loss}, state equal "
                             f"{_bit_equal((g_params, g_opt), (params, opt))}")
    if launches != 2 * GRAPH_STEPS * CELLS_PER_STEP:
        raise AssertionError(f"lstm_cell launched {launches} times in "
                             f"{GRAPH_STEPS} steps each way")
    out = dict(train_step=dict(steps=GRAPH_STEPS, bit_equal=True,
                               graph_ms=float(np.median(g_ms[1:])),
                               eager_ms=float(np.median(e_ms[1:])),
                               first_graph_ms=g_ms[0], launches=launches))
    print(f"[graphs] train_step: {GRAPH_STEPS} steps graph and eager "
          f"bit-equal (losses, params, Adam state), ms per step "
          f"{out['train_step']['graph_ms']:.3f} graph / "
          f"{out['train_step']['eager_ms']:.3f} eager (first graph step, "
          f"its capture, {g_ms[0]:.1f}); lstm_cell {launches} launches")

    t, b, f = GRU_TRAIN
    params = baselines.gru_init(SEED, f, 16, device=DEVICE)
    x = rng.uniform(0, 1, (t, b, f)).astype(np.float32)
    y = rng.uniform(0.5, 2.0, b).astype(np.float32)
    steps = baselines.gru_training(params, x, y)
    x_d, y_d = torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)
    opt = net.adam_init(params)
    g_ms, e_ms, g_loss, e_loss = [], [], [], []
    for _ in range(GRAPH_STEPS):
        t0 = time.perf_counter()
        with programs.LOCK:
            g_loss.append(float(steps.run()))
        t1 = time.perf_counter()
        params, opt, loss = baselines._gru_step(params, opt, x_d, y_d)
        e_loss.append(float(loss))
        t2 = time.perf_counter()
        g_ms.append((t1 - t0) * 1e3)
        e_ms.append((t2 - t1) * 1e3)
    g_params, g_opt = steps.result()
    if g_loss != e_loss or not _bit_equal((g_params, g_opt), (params, opt)):
        raise AssertionError(f"_gru_step graph vs eager: losses {g_loss} "
                             f"against {e_loss}")
    out["gru_step"] = dict(steps=GRAPH_STEPS, bit_equal=True,
                           graph_ms=float(np.median(g_ms[1:])),
                           eager_ms=float(np.median(e_ms[1:])),
                           first_graph_ms=g_ms[0])
    print(f"[graphs] _gru_step: {GRAPH_STEPS} steps graph and eager "
          f"bit-equal, ms per step {out['gru_step']['graph_ms']:.3f} graph "
          f"/ {out['gru_step']['eager_ms']:.3f} eager")
    return out


def graphs_phase(n_hosts: int, max_tasks: int) -> dict:
    """Phase 4b: the captured programs against their eager functions,
    their host ms beside the eager path's, the captures made and
    ``autotune_unroll``'s choice per bucket."""
    before = dict(programs.stats)
    out = dict(fused=graph_fused_parity(n_hosts, max_tasks),
               intervals=graph_intervals(n_hosts, max_tasks))
    out.update(graph_training())
    pred = StragglerPredictor(n_hosts=n_hosts, max_tasks=max_tasks,
                              horizon=PAPER["horizon"], seed=SEED,
                              device=DEVICE)
    out["autotune_unroll"] = pred.autotune_unroll(buckets=PROFILED_BUCKETS)
    out["captures"] = {k: programs.stats[k] - before[k]
                       for k in ("captures", "capture_ms", "pool_bytes",
                                 "replays")}
    out["captures_total"] = dict(programs.stats)
    print(f"[graphs] autotune_unroll pinned {out['autotune_unroll']}; "
          f"{out['captures']['captures']} captures in the phase "
          f"({out['captures']['capture_ms']:.1f} ms, graph pools "
          f"{out['captures']['pool_bytes']} bytes), "
          f"{out['captures']['replays']} replays; process: "
          f"{programs.stats['captures']} captures, "
          f"{programs.stats['capture_ms']:.1f} ms, "
          f"{programs.stats['pool_bytes']} bytes")
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


def hold_cells(serial: sweep.SweepResult, other: sweep.SweepResult,
               label: str) -> None:
    """Fails unless every cell of ``other`` lines up with ``serial``'s and
    its ``deterministic_summary`` is equal bit for bit, field by field."""
    differ = []
    for a, b in zip(serial.cells, other.cells, strict=True):
        da = sweep.deterministic_summary(a.summary)
        db = sweep.deterministic_summary(b.summary)
        key = (a.scenario, a.technique, a.seed)
        if key != (b.scenario, b.technique, b.seed) or set(da) != set(db):
            raise AssertionError(f"cells {key} and {b.technique, b.seed} "
                                 f"do not line up")
        differ += [f"{a.technique}/seed {a.seed}: {k} {da[k]!r} != "
                   f"{db[k]!r}" for k in da if da[k] != db[k]]
    if differ:
        raise AssertionError(f"serial and {label} sweeps differ: "
                             + "; ".join(differ))


def sweep_parity() -> tuple[dict, sweep.SweepResult]:
    """``PARITY`` x ``PARITY_SEEDS`` on planetlab at the paper's width,
    serially and on ``PARITY_WORKERS`` spawned workers (warmed first, so
    the parent does not run the grid alone while they import): every
    cell's ``deterministic_summary`` must be equal bit for bit, field by
    field; START and IGRU-SD must each run a cell on the card in a
    worker, and no worker may build a kernel library again.  Returns the
    numbers and the serial result (the fabric phase holds its grid to
    it)."""
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
    hold_cells(serial, parallel, "parallel")
    print(f"[paper] serial vs {PARITY_WORKERS} workers: {len(serial.cells)} "
          f"cells ({', '.join(PARITY)} x seeds {PARITY_SEEDS}) bit-equal in "
          f"every field; in the workers (seeds): {in_workers}, no library "
          f"rebuilt; serial {serial.wall_s:.1f} s, parallel "
          f"{parallel.wall_s:.1f} s host (the pool warmed before it in "
          f"{spawn_s:.1f} s)")
    return dict(cells=len(serial.cells), serial_s=serial.wall_s,
                parallel_s=parallel.wall_s, spawn_s=spawn_s,
                in_workers=in_workers), serial


# --------------------------------- phase 6b ---------------------------------
# the sweep fabric: the parity grid served to node agents

FABRIC_KEY = "chip-smoke-fabric"    # REPRO_FABRIC_KEY while the phase runs
FABRIC_LANES = (1, 2)               # one agent inline, one over a local pool
FABRIC_KILL_LANES = (1, 1)          # the kill must land in an agent itself
FABRIC_KILL = ("planetlab", "start", 1)
FABRIC_TIMEOUT = 300.0              # a grid; agents are joined for 60 s


def _children(pid: int) -> list[int]:
    """The processes whose parent is ``pid`` (an agent's pool lanes)."""
    out = []
    for d in Path("/proc").iterdir():
        try:
            ppid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid:
            out.append(int(d.name))
    return out


def fabric_grid(spec: sweep.SweepSpec, lanes) -> dict:
    """Serve ``spec`` from a ``FabricCoordinator`` in this process (kernel
    libraries shipped with the grid) to node agents spawned on localhost,
    one per entry of ``lanes``; every agent is joined, or killed with its
    lanes.  Returns the result, the agents' exit codes and pids, the
    coordinator's stats and what the grid reply shipped."""
    ctx = multiprocessing.get_context("spawn")
    with fabric.FabricCoordinator(ship_cache=True) as coord:
        # an agent with a local pool has children: it cannot be daemonic
        procs = [ctx.Process(target=fabric.worker_main,
                             args=(coord.host, coord.port),
                             kwargs=dict(node=f"agent{i}", lanes=n),
                             daemon=n == 1)
                 for i, n in enumerate(lanes)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            # the user's entry point, its grid bounded in time
            res = sweep.run(spec, fabric=types.SimpleNamespace(
                run_grid=functools.partial(coord.run_grid,
                                           timeout=FABRIC_TIMEOUT)))
            wall_s = time.perf_counter() - t0
            shipped = dict(coord._cache_files)
            payload_bytes = len(coord._payload_blob)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    for child in _children(p.pid):
                        os.kill(child, signal.SIGKILL)
                    p.kill()
                    p.join(timeout=10)
        # after the agents left: a stolen copy still running when the
        # grid completed is counted once its agent reports it
        stats = coord.stats()
    return dict(res=res, wall_s=wall_s, stats=stats, shipped=shipped,
                payload_bytes=payload_bytes,
                exitcodes=[p.exitcode for p in procs],
                pids=[p.pid for p in procs])


def fabric_launches(serial: sweep.SweepResult,
                    res: sweep.SweepResult) -> int:
    """The ``lstm_cell`` launches of ``res``'s START cells, each counted
    in the process that ran it (``CellResult.lstm_cell_launches``); each
    must equal the serial run's count for that cell, which on the card is
    not 0."""
    total = 0
    on_card = torch.device(DEVICE).type == "cuda"
    for a, b in zip(serial.cells, res.cells):
        if a.technique.startswith("start"):
            if (on_card and not a.lstm_cell_launches) \
                    or b.lstm_cell_launches != a.lstm_cell_launches:
                raise AssertionError(
                    f"{b.technique}/seed {b.seed}: {b.lstm_cell_launches} "
                    f"lstm_cell launches in pid {b.pid}, "
                    f"{a.lstm_cell_launches} serially")
            total += b.lstm_cell_launches
    return total


def fabric_phase(serial: sweep.SweepResult, parity: dict) -> dict:
    """``sweep_parity``'s grid (``serial.spec``: start, igru-sd and grass x
    seeds 0, 1 at the paper's width, the networks on the card) served by
    the fabric with ``REPRO_FABRIC_KEY`` set: first to agents of
    ``FABRIC_LANES`` lanes, then, with ``REPRO_TEST_KILL_CELL`` armed at
    ``FABRIC_KILL``, to two single-lane agents one of which dies mid-unit
    holding a CUDA context.  Each grid must equal the serial one bit for
    bit; START and IGRU-SD must run cells on the card in agents, each
    START cell launching ``lstm_cell`` as often as serially; no library
    may be built again; the grid reply must ship every current library,
    and installing them elsewhere must give the same bytes."""
    spec = serial.spec
    libs = built_libraries()
    env = {k: os.environ.get(k) for k in ("REPRO_FABRIC_KEY",
                                         "REPRO_TEST_KILL_CELL")}
    os.environ["REPRO_FABRIC_KEY"] = FABRIC_KEY
    try:
        lstm_cell.launches = 0
        run = fabric_grid(spec, FABRIC_LANES)
        here = lstm_cell.launches
        with tempfile.TemporaryDirectory() as tmp:
            marker = Path(tmp) / "killed-once"
            os.environ["REPRO_TEST_KILL_CELL"] = ":".join(
                map(str, (*FABRIC_KILL, marker)))
            killed = fabric_grid(spec, FABRIC_KILL_LANES)
            fired = marker.exists()
            del os.environ["REPRO_TEST_KILL_CELL"]
            current = {_build.target(src).name: src
                       for src in _build.sources().values()}
            installed = Path(tmp) / "kernels"
            fabric.install_cache_files(run["shipped"], str(installed))
            same = set(run["shipped"]) == set(current) and all(
                (installed / n).read_bytes()
                == (_build.BUILD_DIR / n).read_bytes() for n in current)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    res = run["res"]
    hold_cells(serial, res, "fabric")
    hold_cells(serial, killed["res"], "killed-agent fabric")
    on_card = torch.device(DEVICE).type
    in_agents = cells_in_workers(res, ("start", "igru-sd"), on_card)
    launches = fabric_launches(serial, res)
    fabric_launches(serial, killed["res"])
    if on_card == "cuda" and (not libs or built_libraries() != libs):
        raise AssertionError(f"kernel libraries {libs} became "
                             f"{built_libraries()} in the fabric's runs")
    if on_card == "cuda" and not same:
        raise AssertionError(f"the grid shipped {sorted(run['shipped'])}, "
                             f"the checkout's libraries are "
                             f"{sorted(current)} (bytes equal: {same})")
    if run["exitcodes"] != [0] * len(FABRIC_LANES) or here:
        raise AssertionError(f"agents exited {run['exitcodes']}; "
                             f"{here} launches in this process")
    if not fired or sorted(killed["exitcodes"]) != [-9, 0]:
        raise AssertionError(f"kill drill: marker {fired}, agents exited "
                             f"{killed['exitcodes']}")
    by_pid = collections.Counter(c.pid for c in res.cells)
    first = run["pids"][0]
    nodes = {f"agent0 (lanes 1, pid {first})": by_pid.pop(first, 0),
             "agent1 (lanes 2), by lane": dict(by_pid)}
    shipped = sum(map(len, run["shipped"].values()))
    out = dict(cells=len(res.cells), wall_s=run["wall_s"],
               killed_wall_s=killed["wall_s"], serial_s=parity["serial_s"],
               pool_s=parity["parallel_s"], nodes=nodes,
               in_agents=in_agents, lstm_cell_launches=launches,
               stats=run["stats"], killed_stats=killed["stats"],
               killed_exitcodes=killed["exitcodes"],
               libraries_shipped=len(run["shipped"]),
               library_bytes=shipped, payload_bytes=run["payload_bytes"])
    print(f"[fabric] {len(res.cells)} cells ({', '.join(PARITY)} x seeds "
          f"{PARITY_SEEDS}) served to agents of {FABRIC_LANES} lanes with "
          f"REPRO_FABRIC_KEY: bit-equal to serial in every field; "
          f"{run['wall_s']:.1f} s wall from spawning the agents (serial "
          f"{parity['serial_s']:.1f} s, {PARITY_WORKERS} warm pool workers "
          f"{parity['parallel_s']:.1f} s) [{CARD}]")
    print(f"[fabric] cells by node: {nodes}; START and IGRU-SD in agents "
          f"on {on_card} (seeds): {in_agents}; lstm_cell {launches} "
          f"launches in the agents' START cells, each as serially, "
          f"{here} in this process")
    print(f"[fabric] steals {run['stats']['steals']}, duplicates dropped "
          f"{run['stats']['duplicates']}; shipped {len(run['shipped'])} "
          f"libraries, {shipped} bytes (every current one, installed "
          f"elsewhere byte-equal: {same}), "
          f"and {run['payload_bytes']} bytes of pretrained policies; no "
          f"library rebuilt")
    print(f"[fabric] kill drill: an agent SIGKILLed at {FABRIC_KILL} "
          f"(exit codes {killed['exitcodes']}), the grid bit-equal in "
          f"{killed['wall_s']:.1f} s, steals {killed['stats']['steals']}, "
          f"duplicates {killed['stats']['duplicates']}")
    return out


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


class RecordingEngine(Engine):
    """The engine as it serves, keeping the logits of every step, prefill
    logits by prompt length, decode logits by position (the prompts'
    lengths are far enough apart that positions identify the request),
    and keying the router calls of each in ``log``.  A slot's decode step
    replays its CUDA graph, which runs no Python: at the slot's capture
    the log holds the warm-up step's router calls, then the capture's,
    whose outputs every replay rewrites; after a replay those are read."""

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 log: RouteLog):
        super().__init__(model, params, cfg)
        self.log = log
        self.prefill_logits: dict[int, torch.Tensor] = {}
        self.decode_logits: dict[int, torch.Tensor] = {}
        self._routes: dict[int, list] = {}    # slot -> the capture's calls

    def _prefill(self, toks):
        n = toks.shape[1]
        self.log.key = ("prefill", n)
        logits, caches = super()._prefill(toks)
        self.prefill_logits[n] = logits
        return logits, caches

    def _decode(self, slot, st):
        key = self.log.key = ("decode", st["pos"])
        captures = programs.stats["captures"]
        logits = super()._decode(slot, st)
        calls = self.log.calls.setdefault(key, [])
        if programs.stats["captures"] > captures:
            self._routes[slot] = calls[len(calls) // 2:]
            del calls[len(calls) // 2:]
        elif not calls and slot in self._routes:
            calls.extend((idx.clone(), gap) for idx, gap in
                         self._routes[slot])
        self.decode_logits[st["pos"]] = logits.clone()
        return logits

    def release(self) -> None:
        self._routes.clear()     # tensors of the graphs' pools
        super().release()


@contextlib.contextmanager
def plain_path():
    """The model's attention, router and SSM prefill scan through the
    plain PyTorch versions, on the card (the kernels' wrappers are not
    called); yields the router's log, with the top-k gaps."""
    saved = (backend.attention, backend.decode_attention,
             backend.mamba_scan_with_state)
    backend.attention = (lambda q, k, v, *, causal=True:
                         attention_ref(q, k, v, causal=causal))
    backend.decode_attention = (lambda q, k, v, *, kv_len:
                                decode_attention_ref(q, k, v, kv_len=kv_len))
    backend.mamba_scan_with_state = mamba_scan_with_state_ref
    try:
        with routed_by(RouteLog(moe_router_ref, with_gap=True)) as log:
            yield log
    finally:
        (backend.attention, backend.decode_attention,
         backend.mamba_scan_with_state) = saved


def kernel_launches() -> dict:
    return dict(flash_attention=flash_attention.launches,
                flash_attention_bwd=flash_attention_bwd.launches,
                decode_attention=decode_attention.launches,
                moe_router=moe_router.launches, lstm_cell=lstm_cell.launches,
                mamba_scan=mamba_scan.launches,
                mamba_scan_bwd=mamba_scan_bwd.launches,
                mamba_scan_with_state=mamba_scan_with_state.launches)


def reset_launches() -> None:
    flash_attention.launches = flash_attention_bwd.launches = 0
    decode_attention.launches = 0
    moe_router.launches = lstm_cell.launches = mamba_scan.launches = 0
    mamba_scan_bwd.launches = mamba_scan_with_state.launches = 0


def layer_counts(cfg) -> dict:
    """Layers of each kind: self-attention through the kernels (GQA), MLA
    (the plain attention functions, as in the JAX package: no kernel),
    MoE, SSM (a hybrid period's Mamba sublayers), and an encoder-
    decoder's encoder layers and cross-attention sublayers (each one
    flash launch per forward, the cross-attention also one per decoded
    token)."""
    n_attn = sum(cfg.is_attention_layer(i) for i in range(cfg.n_layers))
    return dict(attn=0 if cfg.use_mla else n_attn,
                mla=n_attn if cfg.use_mla else 0,
                moe=sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)),
                ssm=(cfg.n_layers - n_attn
                     if cfg.family in ("ssm", "hybrid") else 0),
                enc=cfg.encoder_layers,
                cross=cfg.n_layers if cfg.encoder_layers else 0)


def flash_per_forward(n: dict) -> int:
    """flash_attention launches of one full-sequence forward."""
    return n["attn"] + n["enc"] + n["cross"]


def lm_prompts(vocab: int) -> list[np.ndarray]:
    assert all(b - a > MAX_NEW for a, b in zip(PROMPT_LENS,
                                               PROMPT_LENS[1:]))
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def serve_engine(model: Model, params, prompts) -> dict:
    """The main path: ``Engine`` serving every prompt, each slot's decode
    step captured once and replayed, launch counts (the replays' included)
    set to 0 just before and read just after."""
    log = RouteLog(backend.moe_router)
    eng = RecordingEngine(model, params, EngineConfig(n_slots=N_SLOTS,
                                                      max_len=MAX_LEN), log)
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=p, max_new=MAX_NEW))
    torch.cuda.synchronize()
    reset_launches()
    before = dict(programs.stats)
    t0 = time.perf_counter()
    with routed_by(log):
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    graphs = {k: programs.stats[k] - before[k] for k in before}
    eng.release()        # the slots' caches and graphs: the gates need room
    slots = min(N_SLOTS, len(prompts))
    if graphs["captures"] != (slots if DEVICE == "cuda" else 0):
        raise AssertionError(f"engine: {graphs['captures']} captures for "
                             f"{slots} slots")
    cfg = model.cfg
    n = layer_counts(cfg)
    decoded = sum(len(r.out) - 1 for r in done)
    want = dict(flash_attention=(flash_per_forward(n) * len(prompts)
                                 + n["cross"] * decoded),
                flash_attention_bwd=0,
                decode_attention=LAUNCHES_PER_CALL * n["attn"] * decoded,
                moe_router=n["moe"] * (len(prompts) + decoded), lstm_cell=0,
                mamba_scan=0, mamba_scan_bwd=0,
                mamba_scan_with_state=n["ssm"] * len(prompts))
    if len(done) != len(prompts) or launches != want:
        raise AssertionError(f"engine: {len(done)} requests done, launches "
                             f"{launches}, expected {want}")
    tokens = sum(len(r.out) for r in done)
    print(f"[lm] engine served {len(done)} requests, {tokens} tokens in "
          f"{wall:.3f} s, decode by replay: {graphs['captures']} captures "
          f"(one a slot, {graphs['capture_ms']:.1f} ms, pools "
          f"{graphs['pool_bytes']} B), {graphs['replays']} replays; "
          f"flash_attention {launches['flash_attention']} "
          f"launches = {n['attn']} x {len(prompts)} prefills, "
          f"decode_attention {launches['decode_attention']} = "
          f"{LAUNCHES_PER_CALL} x {n['attn']} x {decoded} decoded tokens, "
          f"moe_router {launches['moe_router']} = {n['moe']} x "
          f"({len(prompts)} prefills + {decoded} decoded tokens), "
          f"mamba_scan_with_state {launches['mamba_scan_with_state']} = "
          f"{n['ssm']} x {len(prompts)} prefills (the SSM decode is plain "
          f"ops)" + (f"; {n['mla']} MLA layers attend through the plain "
                     f"functions, no kernel" if n["mla"] else ""))
    return dict(done=sorted(done, key=lambda r: r.req_id), rec=eng,
                routes=log.calls, wall_s=wall, tokens=tokens,
                launches=launches, graphs=graphs)


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
    """Free what the card caches: the captured programs' graphs, pools and
    static buffers (``programs.clear``; a later call captures again) and
    the allocator's free blocks."""
    programs.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _routing_line(tf: dict) -> str:
    r = tf["routing"]
    return (f"routing: {len(r['first'])} requests with a routing "
            f"difference over {r['rows']} token-layer routings, first ones "
            f"{r['first']}; {r['rows_after']} differing routings after them "
            f"({r['steps_after']} steps held out, logit drift there "
            f"{tf['max_abs_drift_after_routing']:.3e})")


def lm_gate(arch: str, n_layers: int | None = None,
            experts: int | None = None) -> dict:
    """fp32 at full width (and depth, unless ``n_layers`` cuts it; the
    expert count, unless ``experts`` cuts it), the correctness gate."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, param_dtype="float32",
                              n_layers=n_layers or full.n_layers,
                              n_experts=experts or full.n_experts)
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
    fp64 = None
    if cfg.family == "hybrid":
        fp64 = hybrid_against_fp64(model, params, prompts[:FP64_PROMPTS])
    tol = SSM_LOGIT_TOL if cfg.family == "ssm" else LOGIT_TOL
    if fp64 is not None:
        # the plain path's own distance from float64, doubled, where it
        # passes LOGIT_TOL (as SSM_LOGIT_TOL was justified for falcon)
        tol = max(tol, 2 * max(e["plain"] for e in fp64.values()))
    print(f"[lm] {cfg.name} fp32 engine vs plain path: max abs logit drift "
          f"{tf['max_abs_drift']:.3e} (bound {tol}) over {tf['steps']} "
          f"steps, greedy tokens equal {tf['agree']}/{tf['steps']}, peak "
          f"{peak:.2f} GiB")
    if served["launches"]["moe_router"]:
        print(f"[lm] {cfg.name} fp32 {_routing_line(tf)}")
    if not tf["max_abs_drift"] <= tol:
        raise AssertionError(f"fp32 logits drift {tf['max_abs_drift']}")
    bad = [f for f in tf["flips"] if f["margin"] >= tol]
    if bad:
        raise AssertionError(f"fp32 greedy tokens differ away from a top-2 "
                             f"tie: {bad}")
    out = dict(n_layers=cfg.n_layers, n_experts=cfg.n_experts,
               params_b=cfg.param_count() / 1e9, launches=served["launches"],
               wall_s=served["wall_s"], tokens=served["tokens"],
               peak_gib=peak, logit_tol=tol, **tf)
    if cfg.family == "ssm":
        out["fp64"] = ssm_against_fp64(model, params,
                                       prompts[:FP64_PROMPTS])
    if fp64 is not None:
        out["fp64"] = fp64
    if cfg.family in ("ssm", "hybrid") or cfg.use_mla:
        # MLA: the absorbed latent decode against the expanded attention
        out["prefill_then_decode"] = prefill_then_decode(
            model, params, prompts[:3], tol)
    if cfg.family == "vlm":
        out["patches"] = frontend_serve(model, params, prompts, hold=True)
    out["graphs"] = served["graphs"]
    if arch in DECODE_GRAPH_ARCHS:
        out["decode_graphs"] = decode_graphs(arch, model, params, prompts[2],
                                             tol)
    del params, served
    free_cuda()
    return out


def _fp64_norm(cfg, w, x):
    return (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.norm_eps)
            * w.double())


def _fp64_silu(x):
    return x * torch.sigmoid(x)


def _fp64_mamba(cfg, p: dict, h):
    """One Mamba block in float64 from one layer's params: h (B, L, d)
    normed input -> (B, L, d), the plain scan stepped in float64."""
    di, n, dtr, k = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    p = {kk: v.double() for kk, v in p.items()}
    ell = h.shape[1]
    xz = h @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    xp = torch.nn.functional.pad(xin, (0, 0, k - 1, 0))
    xc = _fp64_silu(sum(xp[:, j:j + ell] * p["conv_w"][j] for j in range(k))
                    + p["conv_b"])
    proj = xc @ p["x_proj"]
    delta = torch.nn.functional.softplus(proj[..., :dtr] @ p["dt_proj"]
                                         + p["dt_bias"])
    bm, cm = proj[..., dtr:dtr + n], proj[..., dtr + n:]
    a = -torch.exp(p["a_log"])
    st = h.new_zeros(h.shape[0], di, n)
    ys = []
    for t in range(ell):
        st = (torch.exp(delta[:, t, :, None] * a) * st
              + (delta[:, t] * xc[:, t])[..., None] * bm[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", st, cm[:, t])
                  + p["skip"] * xc[:, t])
    return (torch.stack(ys, 1) * _fp64_silu(z)) @ p["out_proj"]


def _fp64_ssm_logits(model: Model, params, toks):
    """falcon-mamba's last-token prefill logits in float64, layer by
    layer from the fp32 params (the plain scan stepped in float64)."""
    cfg = model.cfg
    x = params["embed"][toks].double()
    for i in range(cfg.n_layers):
        p = {kk: v[i] for kk, v in params["g0"]["mamba"].items()}
        x = x + _fp64_mamba(cfg, p, _fp64_norm(
            cfg, params["g0"]["ln1"]["w"][i], x))
    return _fp64_norm(cfg, params["ln_f"]["w"], x)[:, -1:] \
        @ params["head"].double()


def _fp64_hybrid_logits(model: Model, params, toks):
    """A hybrid model's last-token prefill logits in float64 from its
    fp32 params, period by period: the Mamba sublayers as
    ``_fp64_mamba``, causal GQA attention with RoPE, top-k routing from
    float64 probabilities (dropless: the prompts here are short) and
    each expert's SwiGLU converted one expert at a time, so the float64
    copies stay a few GB beside the model."""
    cfg = model.cfg
    period, hd = cfg.attn_period, cfg.hd
    x = params["embed"][toks].double()
    b, s, _ = x.shape
    t = torch.arange(s, dtype=torch.float64, device=x.device)
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    cos, sin = torch.cos(torch.outer(t, inv)), torch.sin(torch.outer(t, inv))

    def rope(v):
        v1, v2 = v[..., :hd // 2], v[..., hd // 2:]
        c, sn = cos[None, :, None], sin[None, :, None]
        return torch.cat([v1 * c - v2 * sn, v2 * c + v1 * sn], -1)

    def swiglu(wg, wu, wd, v):
        return (_fp64_silu(v @ wg.double()) * (v @ wu.double())) \
            @ wd.double()

    for gp in range(cfg.n_layers // period):
        p = layer(params["g0"], gp)
        i_moe = i_ff = 0
        for j in range(period):
            h = _fp64_norm(cfg, p["ln"]["w"][2 * j], x)
            if j < period - 1:
                x = x + _fp64_mamba(cfg, layer(p["mamba"], j), h)
            else:
                a = {k: v.double() for k, v in p["attn"].items()}
                q = rope((h @ a["wq"]).view(b, s, cfg.n_heads, hd))
                kk = rope((h @ a["wk"]).view(b, s, cfg.n_kv_heads, hd))
                vv = (h @ a["wv"]).view(b, s, cfg.n_kv_heads, hd)
                g = cfg.n_heads // cfg.n_kv_heads
                kk, vv = (z.repeat_interleave(g, 2).transpose(1, 2)
                          for z in (kk, vv))
                sc = q.transpose(1, 2) @ kk.transpose(-1, -2) * hd ** -0.5
                sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool,
                                               device=x.device).triu(1),
                                    float("-inf"))
                o = torch.softmax(sc, -1) @ vv
                x = x + o.transpose(1, 2).reshape(b, s, -1) @ a["wo"]
            h = _fp64_norm(cfg, p["ln"]["w"][2 * j + 1], x)
            if j % cfg.moe_every == cfg.moe_every - 1:
                m = layer(p["moe"], i_moe)
                probs = torch.softmax(h @ m["router"].double(), -1)
                w, idx = torch.topk(probs, cfg.top_k, -1)
                w = w / w.sum(-1, keepdim=True)
                y = torch.zeros_like(h)
                for e in range(cfg.n_experts):
                    sel = (idx == e)
                    if sel.any():
                        we = (w * sel).sum(-1, keepdim=True)
                        y = y + we * swiglu(m["wg"][e], m["wu"][e],
                                            m["wd"][e], h)
                x = x + y
                i_moe += 1
            else:
                m = layer(p["mlp"], i_ff)
                x = x + swiglu(m["wg"], m["wu"], m["wd"], h)
                i_ff += 1
    return _fp64_norm(cfg, params["ln_f"]["w"], x)[:, -1:] \
        @ params["head"].double()


def hybrid_against_fp64(model: Model, params, prompts) -> dict:
    """A hybrid model's fp32 prefill logits through the kernels and
    through the plain path, each against a float64 forward from the same
    params (reported; the gate's bound takes the plain path's error)."""
    out = {}
    for p in prompts:
        toks = torch.as_tensor(p, device=DEVICE)[None]
        with torch.no_grad():
            kern, _ = model.prefill(params, {"tokens": toks})
            with plain_path():
                plain, _ = model.prefill(params, {"tokens": toks})
            exact = _fp64_hybrid_logits(model, params, toks)
        out[len(p)] = dict(kernel=(kern.double() - exact).abs().max().item(),
                           plain=(plain.double() - exact).abs().max().item(),
                           max_logit=exact.abs().max().item())
        del kern, plain, exact
        free_cuda()
    print(f"[lm] {model.cfg.name} fp32 prefill logits against a float64 "
          f"forward, max abs by S: {out}")
    return out


def ssm_against_fp64(model: Model, params, prompts) -> dict:
    """The SSM's prefill logits through the kernel and through the plain
    scan, each against a float64 forward from the same params: the
    kernel's error within twice the plain path's own (or LOGIT_TOL)."""
    out = {}
    for p in prompts:
        toks = torch.as_tensor(p, device=DEVICE)[None]
        with torch.no_grad():
            kern, _ = model.prefill(params, {"tokens": toks})
            with plain_path():
                plain, _ = model.prefill(params, {"tokens": toks})
            exact = _fp64_ssm_logits(model, params, toks)
        err = dict(kernel=(kern.double() - exact).abs().max().item(),
                   plain=(plain.double() - exact).abs().max().item(),
                   max_logit=exact.abs().max().item())
        out[len(p)] = err
        if not err["kernel"] <= max(2 * err["plain"], LOGIT_TOL):
            raise AssertionError(f"S = {len(p)}: the kernel path is "
                                 f"{err['kernel']} from float64, the plain "
                                 f"path {err['plain']}")
    print(f"[lm] {model.cfg.name} fp32 prefill logits against a float64 "
          f"forward, max abs by S (the kernel's held to twice the plain "
          f"path's): {out}")
    return out


def prefill_then_decode(model: Model, params, prompts, tol: float,
                        extra: dict | None = None) -> dict:
    """Prefill of a whole prompt against a prefill of all but its last
    token and a decode step of that token (for the SSM: the kernel's
    final state carried into the plain recurrent step; for an encdec,
    ``extra`` holds the frames, the ``{"enc"}`` cache carried): last-token
    logits within ``tol``, max abs."""
    drift = {}
    for p in prompts:
        toks = torch.as_tensor(p, device=DEVICE)[None]
        full, _ = model.prefill(params, {"tokens": toks, **(extra or {})})
        _, caches = model.prefill(params, {"tokens": toks[:, :-1],
                                           **(extra or {})})
        step, _ = model.decode_step(params, pad_to_length(caches, len(p)),
                                    toks[:, -1:], len(p) - 1)
        drift[len(p)] = (step - full).abs().max().item()
        del caches
    print(f"[lm] {model.cfg.name} fp32 prefill(S) vs prefill(S - 1) + "
          f"decode: max abs logit drift by S {drift} (bound {tol})")
    if not max(drift.values()) <= tol:
        raise AssertionError(f"prefill then decode drifts {drift}")
    return drift


def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in convert.leaves(params))


def _sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def lm_timing(arch: str, n_layers: int | None = None,
              experts: int | None = None) -> dict:
    """bf16, the config's own dtype, at full width and depth (unless
    ``n_layers`` cuts it): the engine's run, warm TTFT per prompt length
    (prefill, cache padding and the first token, one request alone), warm
    decode ms per token, drift and routing differences against the plain
    path, and profiled windows of decode steps and of the longest
    prefill; for a vlm, the same prompts after its patch embeddings.
    ``experts`` cuts the MoE layers' expert count."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers or full.n_layers,
                              n_experts=experts or full.n_experts)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, DEVICE)
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name} bf16, {cfg.n_layers} layers"
          + (f", {cfg.n_experts} experts" if cfg.n_experts else "")
          + f": {cfg.param_count() / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
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
    wbytes = weight_bytes(params)
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    print(f"[lm] {cfg.name} bf16 TTFT ms by prompt length (warm, alone): "
          f"{ttft}")
    busy = {n: round(v["device_busy_ms"], 3) for n, v in decode_busy.items()}
    ops = {n: round(v["device_ops"]) for n, v in decode_busy.items()}
    routed = ("; a decoded token reads only its routed experts"
              if cfg.n_experts else "")
    print(f"[lm] {cfg.name} bf16 per decoded token, by context: host "
          f"{decode_ms} ms, device busy {busy} ms over {ops} device ops; "
          f"the weight-read bound {wbytes / 1e9:.2f} GB / "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bound_ms:.2f} ms (all "
          f"weights read once{routed})")
    print(f"[lm] {cfg.name} bf16 decode ms/token (B=1, warm median) by "
          f"context: {decode_ms}; engine {served['tokens']} tokens in "
          f"{served['wall_s']:.3f} s = {tok_s:.1f} tokens/s "
          f"({len(prompts)} requests, {N_SLOTS} slots, prefill included)")
    out = dict(ttft_ms=ttft, decode_ms=decode_ms, profile=decode_busy,
               prefill_profile=prefill_busy, weight_gb=wbytes / 1e9,
               weight_read_bound_ms=bound_ms,
               n_layers=cfg.n_layers, n_experts=cfg.n_experts,
               params_b=cfg.param_count() / 1e9,
               engine_tok_per_s=tok_s, engine_wall_s=served["wall_s"],
               tokens=served["tokens"], launches=served["launches"],
               peak_gib=peak, max_abs_drift=tf["max_abs_drift"],
               agree=tf["agree"], steps=tf["steps"], flips=len(tf["flips"]),
               routing=dict(tf["routing"], first=len(tf["routing"]["first"])))
    if cfg.family == "vlm":
        out["patches"] = frontend_serve(model, params, prompts, hold=False)
    out["graphs"] = served["graphs"]
    if arch in DECODE_GRAPH_ARCHS:
        out["decode_graphs"] = decode_graphs(arch, model, params,
                                             prompts[-1], timed=True)
    del params, served
    free_cuda()
    return out


def frontend_embeds(cfg, seed: int = SEED):
    """A modality stub's inputs: ``frontend_tokens`` seeded embeddings at
    the model width, (1, P, d) on the card in the config's dtype (the
    vlm's image patches, the encdec's audio frames)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(1, cfg.frontend_tokens, cfg.d_model,
                       generator=g).to(DEVICE, cfg.dtype)


def frontend_serve(model: Model, params, prompts, hold: bool) -> dict:
    """``prefill`` with the stub's embeddings beside each prompt (a
    vlm's ``PATCH_PROMPTS``, prepended: decode positions P + S on; an
    encdec's every prompt, the frames through the encoder: positions S
    on), then ``MAX_NEW - 1`` greedy ``decode_step``s, through the kernels
    (launch counts set to 0 just before and read just after), then
    teacher-forced through the plain path: logit drift, greedy
    agreement, warm TTFT (the encoder's pass included).  With ``hold``
    (fp32) the drift must stay within LOGIT_TOL and the tokens may differ
    only at a top-2 tie.  An encdec's bf16 run also times warm decode ms
    per token at the shortest and longest prompt, each with a profiled
    window of decode steps."""
    cfg = model.cfg
    encdec = cfg.family == "encdec"
    key = "frame_embeds" if encdec else "patch_embeds"
    pe = frontend_embeds(cfg)
    p_len = 0 if encdec else pe.shape[1]
    sel = list(prompts) if encdec else [prompts[PROMPT_LENS.index(n)]
                                        for n in PATCH_PROMPTS]

    def prefill(p):
        toks = torch.as_tensor(p, device=DEVICE)[None]
        logits, caches = model.prefill(params, {"tokens": toks, key: pe})
        return logits, pad_to_length(caches, p_len + len(p) + MAX_NEW)

    slot = {}

    def run(p, forced=None):
        """The kernels' run decodes by replay on one slot's caches (one
        capture for every prompt, as the engine's slot), the plain one
        (``forced``) eagerly."""
        if forced is None:
            toks = torch.as_tensor(p, device=DEVICE)[None]
            logits, pre = model.prefill(params, {"tokens": toks, key: pe})
            caches = slot.setdefault("caches", zeros_padded(pre, MAX_LEN))
            load_into(caches, pre)
            del pre

            def decode(tok, pos):
                return serve_programs.decode_step(model, params, caches,
                                                  tok, pos)
        else:
            logits, caches = prefill(p)

            def decode(tok, pos):
                return model.decode_step(params, caches, tok, pos)[0]
        out, steps = [], [logits[0, -1]]
        for j in range(MAX_NEW - 1):
            tok = int(torch.argmax(steps[-1])) if forced is None \
                else forced[j]
            out.append(tok)
            logits = decode(torch.tensor([[tok]], device=DEVICE),
                            p_len + len(p) + j)
            steps.append(logits[0, -1].clone())
        out.append(int(torch.argmax(steps[-1])))
        return out, steps

    torch.cuda.synchronize()
    reset_launches()
    captures = programs.stats["captures"]
    t0 = time.perf_counter()
    kern = [run(p) for p in sel]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    slot.clear()
    with programs.LOCK:
        serve_programs.DECODE_STEP.prune()
    captures = programs.stats["captures"] - captures
    if captures != (1 if DEVICE == "cuda" else 0):
        raise AssertionError(f"{key}: {captures} captures for one slot")
    n = layer_counts(cfg)
    decoded = len(sel) * (MAX_NEW - 1)
    want = {k: 0 for k in launches}
    want.update(flash_attention=(flash_per_forward(n) * len(sel)
                                 + n["cross"] * decoded),
                decode_attention=LAUNCHES_PER_CALL * n["attn"] * decoded)
    if launches != want:
        raise AssertionError(f"{key}: launches {launches}, expected {want}")
    drift, agree, flips = 0.0, 0, []
    before = kernel_launches()
    with plain_path():
        for p, (toks, steps) in zip(sel, kern):
            _, plain = run(p, forced=toks)
            for j, (a, b) in enumerate(zip(steps, plain)):
                if not torch.isfinite(b).all():
                    raise AssertionError("plain path: non-finite logits")
                drift = max(drift, (a - b).abs().max().item())
                if int(torch.argmax(b)) == toks[j]:
                    agree += 1
                    continue
                top2 = torch.topk(b, 2).values
                flips.append(dict(s=len(p), step=j,
                                  margin=(top2[0] - top2[1]).item()))
    if kernel_launches() != before:
        raise AssertionError("the plain path launched a kernel")
    ttft = {}
    for p in sel:
        def first(p=p):
            logits, _ = prefill(p)
            int(torch.argmax(logits[0, -1]))

        ttft[p_len + len(p)] = float(np.median([_sync_ms(first)
                                                for _ in range(3)]))
    steps = len(sel) * MAX_NEW
    what = (f"{p_len} patch embeddings before {PATCH_PROMPTS} tokens"
            if not encdec else f"{pe.shape[1]} frames through the encoder "
            f"beside {PROMPT_LENS} tokens")
    print(f"[lm] {cfg.name} {str(cfg.dtype)[6:]} with {what}: launches "
          f"flash_attention {launches['flash_attention']} = "
          f"{flash_per_forward(n)} x {len(sel)} prefills"
          + (f" + {n['cross']} cross-attention x {decoded} decoded tokens"
             if encdec else "")
          + f", decode_attention {launches['decode_attention']} = "
          f"{n['attn']} x {decoded}; {sum(len(t) for t, _ in kern)} tokens "
          f"in {wall:.3f} s; kernels vs plain path max abs logit drift "
          f"{drift:.3e}, greedy tokens equal {agree}/{steps}; TTFT ms by "
          f"positions (warm) {ttft}")
    if hold:
        if not drift <= LOGIT_TOL:
            raise AssertionError(f"{key}: fp32 logits drift {drift}")
        bad = [f for f in flips if f["margin"] >= LOGIT_TOL]
        if bad:
            raise AssertionError(f"{key}: greedy tokens differ away from "
                                 f"a top-2 tie: {bad}")
    out = dict(stub_tokens=pe.shape[1], prompts=[len(p) for p in sel],
               launches=launches, max_abs_drift=drift, agree=agree,
               steps=steps, flips=len(flips), ttft_ms=ttft, wall_s=wall)
    if encdec and not hold:
        decode_ms, busy = {}, {}
        for p in (sel[0], sel[-1]):
            logits, caches = prefill(p)
            caches = pad_to_length(caches, MAX_LEN)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            times = []
            for j in range(MAX_NEW):
                def step(j=j):
                    nonlocal tok
                    o, _ = model.decode_step(params, caches, tok, len(p) + j)
                    tok = torch.argmax(o[:, -1], dim=-1)[:, None]
                    int(tok[0, 0])
                times.append(_sync_ms(step))
            decode_ms[len(p)] = float(np.median(times[2:]))
            busy[len(p)] = profile_decode(model, params, caches, tok,
                                          len(p) + MAX_NEW)
            del caches
        out.update(decode_ms=decode_ms, profile=busy,
                   prefill_profile=profile_window(
                       f"prefill of {len(sel[-1])} tokens and the "
                       f"encoder's {pe.shape[1]} frames",
                       lambda: prefill(sel[-1]), 1))
        print(f"[lm] {cfg.name} bf16 per decoded token, by context: host "
              f"{decode_ms} ms, device busy "
              f"{ {k: round(v['device_busy_ms'], 3) for k, v in busy.items()} }"
              f" ms over "
              f"{ {k: round(v['device_ops']) for k, v in busy.items()} } "
              f"device ops (the cross-attention's K and V projected from "
              f"all {pe.shape[1]} encoder states again every token)")
    return out


def profile_window(label: str, fn, reps: int, need: tuple = ()) -> dict:
    """Device time of ``reps`` calls of ``fn`` under torch.profiler: busy
    ms per call (every kernel and copy) and the top device ops.  A window
    whose trace lacks a kernel named in ``need`` (the profiler drops a
    window's device events now and then) is taken again, up to 3 times."""
    for _ in range(3):
        ops = _device_ops(fn, reps)
        ours = {}
        for name in OUR_KERNELS:
            hits = [v for k, v in ops.items() if f"::{name}<" in k]
            if hits:
                ours[name] = dict(ms=sum(t for t, _ in hits) / 1e6 / reps,
                                  calls=sum(c for _, c in hits) / reps)
        if all(n in ours for n in need):
            break
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:6]
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


# ---------------------- decode graphs (ROADMAP 4.6b) -----------------------
# One arch of each family the engine serves (dense GQA, MoE, MLA with
# shared experts and a dense prefix, SSM, encoder-decoder, hybrid) has its
# compiled decode step (``serve/programs.py``) held against the eager one
# at full width with the serving phases' depth cuts: in its fp32 gate at
# the 300-token prompt (bit for bit, and the tensor-position eager step
# within the gate's bound of the host-int one, whose split differs there:
# at 12 tokens both take one split and agree bit for bit), and in its
# bf16 run at the longest, also timed beside the eager step and profiled,
# the replay's launches held against the trace.  The other archs'
# engines decode by replay too, their launches counted.
DECODE_GRAPH_ARCHS = (LM_ARCH, MOE_ARCH, SSM_ARCH, "deepseek-v3-671b",
                      "seamless-m4t-large-v2", "jamba-1.5-large-398b")
DECODE_GRAPH_STEPS = 6      # tokens held bit for bit, each way
DECODE_GRAPHS: dict = {}    # arch -> {"float32": ..., "bfloat16": ...}
# the device-kv_len decode kernel (the graphs' one): yi-6b's decode in an
# S = 4096 slot at kv_len 1, 28, S / 2 and S, the rows past kv_len holding
# another request's keys; device time at 28 and 4096 beside the host-int
# launch; one launch captured and replayed at changing kv_len
DECODE_DEVICE = [(1, 32, 4, 4096, 128, n) for n in (1, 28, 2048, 4096)]
DECODE_DEVICE_TIMED = (28, 4096)
DECODE_REPLAYED = (1, 28, 2048, 4096, 700)


def slot_caches(pre) -> list:
    """A slot's caches at MAX_LEN with the prefill's ``pre`` copied in,
    as the engine keeps them."""
    caches = zeros_padded(pre, MAX_LEN)
    load_into(caches, pre)
    return caches


def replay_record(model: Model, params, caches) -> tuple[dict, object]:
    """(the launches one replay of the entry on ``caches`` adds, by
    kernel; the entry)."""
    ident = programs.identity(params, caches)
    entry, = [e for e in serve_programs.DECODE_STEP._entries.values()
              if e.key[0] is model and e.key[1] == ident]
    return {w.__name__: k for w, k in entry.launches.items()}, entry


def decode_graphs(arch: str, model: Model, params, prompt,
                  tol: float | None = None, extra: dict | None = None,
                  timed: bool = False) -> dict:
    """The compiled decode step against the eager one on one slot's
    caches at MAX_LEN, the prompt's prefill copied into three: for
    DECODE_GRAPH_STEPS greedy tokens each goes through the step's graph
    (its first call the warm-up and the capture, then replays), the eager
    ``decode_step`` at the same tensor position and the eager step at the
    host-int position: the replays' logits and caches bit-equal to the
    tensor path's, the tensor path within ``tol`` (the family's gate) of
    the host-int one, one capture, the launches a replay records, and the
    launch counts over the steps exact.  ``timed``: then MAX_NEW warm
    tokens each way (the graph against the eager host-int step, each on
    its own caches), host ms per token as the engine decodes (argmax and
    readback included), and a profiled window each way (device busy and
    ops), the replay's kernels counted in the trace against its
    record."""
    cfg = model.cfg
    dt = str(cfg.dtype)[6:]
    n = layer_counts(cfg)
    toks = torch.as_tensor(prompt, device=DEVICE)[None]
    logits, pre = model.prefill(params, {"tokens": toks, **(extra or {})})
    graph_c, tensor_c, int_c = (slot_caches(pre) for _ in range(3))
    del pre
    s0 = toks.shape[1]
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    before = dict(programs.stats)
    reset_launches()
    drift = 0.0
    for j in range(DECODE_GRAPH_STEPS):
        pos = s0 + j
        got = serve_programs.decode_step(model, params, graph_c, tok,
                                         pos).clone()
        want, _ = model.decode_step(params, tensor_c, tok,
                                    torch.tensor(pos, device=DEVICE))
        host, _ = model.decode_step(params, int_c, tok, pos)
        if not torch.equal(got, want):
            raise AssertionError(f"{cfg.name} {dt}: the replayed decode "
                                 f"step's logits differ from the eager "
                                 f"step's at position {pos}")
        drift = max(drift, (want - host).abs().max().item())
        tok = torch.argmax(got[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    launches = kernel_launches()
    if not all(torch.equal(a, b) for a, b in zip(convert.leaves(graph_c),
                                                 convert.leaves(tensor_c))):
        raise AssertionError(f"{cfg.name} {dt}: the replays' caches differ "
                             f"from the eager steps'")
    per_step = {k: v for k, v in dict(
        decode_attention=LAUNCHES_PER_CALL * n["attn"], moe_router=n["moe"],
        flash_attention=n["cross"]).items() if v}
    want = {k: 0 for k in launches}
    want.update({k: 3 * DECODE_GRAPH_STEPS * v for k, v in per_step.items()})
    if launches != want:
        raise AssertionError(f"{cfg.name} {dt}: launches over the steps "
                             f"{launches}, expected {want}")
    record, entry = replay_record(model, params, graph_c)
    captures = programs.stats["captures"] - before["captures"]
    if DEVICE == "cuda" and (record != per_step or captures != 1):
        raise AssertionError(f"{cfg.name} {dt}: a replay records {record}, "
                             f"expected {per_step}; {captures} captures")
    if tol is not None and not drift <= tol:
        raise AssertionError(f"{cfg.name} {dt}: the tensor-position step "
                             f"drifts {drift} from the host-int one "
                             f"(bound {tol})")
    out = dict(context=s0, steps=DECODE_GRAPH_STEPS, bit_equal=True,
               drift_tensor_vs_int=drift, tol=tol, record=record,
               launches=launches, captures=captures,
               capture_ms=entry.capture_ms, pool_bytes=entry.pool_bytes)
    print(f"[decode graphs] {cfg.name} {dt}, {cfg.n_layers} layers, from "
          f"position {s0}: {DECODE_GRAPH_STEPS} replayed tokens bit-equal "
          f"to the eager tensor-position step (logits and caches); that "
          f"step vs the host-int one: max abs logit drift {drift:.3e}"
          + (f" (bound {tol})" if tol is not None else "")
          + f"; a replay records {record}; {captures} capture, "
          f"{entry.capture_ms:.1f} ms, pool {entry.pool_bytes} B")
    if timed:
        out.update(decode_graph_timing(model, params, graph_c, int_c, tok,
                                       s0 + DECODE_GRAPH_STEPS, per_step))
    DECODE_GRAPHS.setdefault(arch, {})[dt] = out
    del graph_c, tensor_c, int_c, entry
    with programs.LOCK:
        serve_programs.DECODE_STEP.prune()
    return out


def decode_graph_timing(model: Model, params, graph_c, int_c, tok, pos,
                        per_step: dict) -> dict:
    """Host ms per warm token and a profiled window, the graph's replays
    against the eager host-int step, each on its own caches from
    ``pos``; the replay's kernels in the trace against ``per_step``."""
    cfg = model.cfg
    graph = dict(tok=tok, pos=pos)
    eager = dict(tok=tok, pos=pos)

    def graph_step():
        o = serve_programs.decode_step(model, params, graph_c, graph["tok"],
                                       graph["pos"])
        graph["tok"] = torch.argmax(o[:, -1], dim=-1)[:, None]
        graph["pos"] += 1

    def eager_step():
        o, _ = model.decode_step(params, int_c, eager["tok"], eager["pos"])
        eager["tok"] = torch.argmax(o[:, -1], dim=-1)[:, None]
        eager["pos"] += 1

    ms = {}
    for name, step, st in (("graph", graph_step, graph),
                           ("eager", eager_step, eager)):
        times = [_sync_ms(lambda: (step(), int(st["tok"][0, 0])))
                 for _ in range(MAX_NEW)]
        ms[name] = float(np.median(times[2:]))
    flash = ("flash_wgmma_kernel" if cfg.dtype == torch.bfloat16
             else "flash_attention_kernel")
    names = dict(decode_attention="decode_kernel", moe_router="router_kernel",
                 flash_attention=flash)
    need = tuple(names[k] for k in per_step)
    # a window whose trace lost device events (the profiler drops one now
    # and then) is taken again, up to PROFILE_TRIES windows
    for _ in range(PROFILE_TRIES):
        replays = profile_window(
            f"{cfg.name} decode graph replays from position "
            f"{graph['pos']}, per token", graph_step, 8, need=need)
        traced = {k: replays["kernels"].get(names[k], {}).get("calls", 0)
                  for k in per_step}
        if DEVICE != "cuda" or traced == per_step:
            break
        print(f"[decode graphs] {cfg.name}: the profiled window's trace "
              f"holds {traced} of a replay's {per_step} a token: profiled "
              f"again")
    else:
        raise AssertionError(f"{cfg.name}: a replay's kernels in the trace "
                             f"{traced}, its record {per_step}")
    prof = {"graph": replays, "eager": profile_window(
        f"{cfg.name} eager decode from position {eager['pos']}, per token",
        eager_step, 8)}
    busy = {k: round(v["device_busy_ms"], 4) for k, v in prof.items()}
    ops = {k: round(v["device_ops"], 1) for k, v in prof.items()}
    print(f"[decode graphs] {cfg.name} {str(cfg.dtype)[6:]} per token at "
          f"context {pos}: host ms graph {ms['graph']:.3f} / eager "
          f"{ms['eager']:.3f}; device busy ms {busy}, device ops {ops}; "
          f"the replay's kernels in the trace {traced}")
    return dict(host_ms=ms, busy_ms=busy, device_ops=ops, traced=traced,
                profile=prof)


def check_decode_device(floor: float) -> dict:
    """The decode kernel reading kv_len from the device (the captured
    step's launch): against the plain version at DECODE_DEVICE, the rows
    past kv_len finite keys and values of another request (not zeros, not
    NaN), the bf16 gate as ``check_decode``'s; device us per launch at the
    fixed split (from S) beside the host-int launch (its split from
    kv_len) at DECODE_DEVICE_TIMED; and one launch captured into a CUDA
    graph, replayed at each of DECODE_REPLAYED after the kv_len changed,
    bit-equal to an eager launch and within tolerance of the plain
    version."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    excess, device = -float("inf"), {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (b, h, hkv, s, d, n) in enumerate(DECODE_DEVICE):
        label = (f"B={b} H={h} Hkv={hkv} S={s} D={d} kv_len={n} (device "
                 f"kv_len, stale rows past it)")
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(300 + i)
            q, k, v = (torch.randn(sh, generator=g).to("cuda", dtype)
                       for sh in ((b, h, d), (b, hkv, s, d), (b, hkv, s, d)))
            want = decode_attention_ref(q, k, v, kv_len=n)
            want32 = decode_attention_ref(q.float(), k.float(), v.float(),
                                          kv_len=n)
            kv = torch.tensor(n, dtype=torch.int32, device="cuda")
            got = decode_attention(q, k, v, kv_len=kv)
            _compare("decode_attention", got, want, dtype, worst, label)
            if dtype == torch.bfloat16:
                e = bf16_rounding_excess(got, want32)
                if not e <= BF16_EXCESS:
                    raise AssertionError(
                        f"decode_attention {label}: bf16 output {e:.3e} of "
                        f"max|o| past half an ulp of the fp32 result")
                excess = max(excess, e)
            if n not in DECODE_DEVICE_TIMED:
                continue
            split = decode_split(b * hkv, s, n_sm)
            host_split = decode_split(b * hkv, n, n_sm)
            us = launch_us(lambda: decode_attention(q, k, v, kv_len=kv),
                           "::decode_kernel<")
            us_host = launch_us(lambda: decode_attention(q, k, v, kv_len=n),
                                "::decode_kernel<")
            device[f"{str(dtype)[6:]} kv_len={n}"] = dict(
                device_kv_len_us=us, split=list(split), host_int_us=us_host,
                host_int_split=list(host_split))
            print(f"[kernel] decode_attention {label} {str(dtype)[6:]}: "
                  f"{us:.3f} us device per launch at the split {split} of "
                  f"S, {us_host:.3f} us with a host-int kv_len at its split "
                  f"{host_split} ({us / floor:.2f}x / {us_host / floor:.2f}x "
                  f"the floor)")
    replayed = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(400)
        q, k, v = (torch.randn(sh, generator=g).to("cuda", dtype)
                   for sh in ((1, 32, 128), (1, 4, 4096, 128),
                              (1, 4, 4096, 128)))
        kv = torch.ones((), dtype=torch.int32, device="cuda")
        decode_attention(q, k, v, kv_len=kv)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = decode_attention(q, k, v, kv_len=kv)
        err = 0.0
        for n in DECODE_REPLAYED:
            kv.fill_(n)
            graph.replay()
            eager = decode_attention(q, k, v, kv_len=kv)
            torch.cuda.synchronize()
            if not torch.equal(out, eager):
                raise AssertionError(f"decode_attention {dtype}: the replay "
                                     f"at kv_len {n} differs from an eager "
                                     f"launch")
            want = decode_attention_ref(q, k, v, kv_len=n)
            _compare("decode_attention", out, want, dtype, worst,
                     f"replayed at kv_len={n}")
            err = max(err, (out.float() - want.float()).abs().max().item())
        replayed[str(dtype)[6:]] = err
        del graph
    print(f"[kernel] decode_attention with a device kv_len: max abs err "
          f"fp32 {worst[torch.float32]:.3e} (bound 2e-5), bf16 "
          f"{worst[torch.bfloat16]:.3e} (bound 2e-2), bf16 past half an ulp "
          f"{excess:.3e} of max|o|; one captured launch replayed at kv_len "
          f"{DECODE_REPLAYED} bit-equal to eager launches, max abs err "
          f"against the plain version {replayed}")
    return dict(worst={str(k)[6:]: v for k, v in worst.items()},
                bf16_excess=excess, device_us=device,
                replayed_kv_len=list(DECODE_REPLAYED), replayed_err=replayed)


def decode_graphs_phase(floor: float) -> dict:
    """The device-kv_len kernel's checks, then every family's decode
    graph results from its LM phases (each family present, bit-equal,
    one capture)."""
    kernel = check_decode_device(floor)
    missing = [a for a in DECODE_GRAPH_ARCHS
               if set(DECODE_GRAPHS.get(a, {})) != {"float32", "bfloat16"}]
    if missing:
        raise AssertionError(f"decode graphs not held for {missing}")
    for arch in DECODE_GRAPH_ARCHS:
        r = DECODE_GRAPHS[arch]
        t = r["bfloat16"]
        print(f"[decode graphs] {arch}: fp32 drift tensor vs int "
              f"{r['float32']['drift_tensor_vs_int']:.3e} (bound "
              f"{r['float32']['tol']}); a replay records "
              f"{r['bfloat16']['record']}; bf16 host ms per token graph "
              f"{t['host_ms']['graph']:.3f} / eager "
              f"{t['host_ms']['eager']:.3f}, busy {t['busy_ms']}, ops "
              f"{t['device_ops']}; pool "
              f"{t['pool_bytes']} B a slot, capture {t['capture_ms']:.1f} ms")
    return dict(kernel=kernel, archs={
        a: {dt: {k: v for k, v in r.items() if k != "profile"}
            for dt, r in DECODE_GRAPHS[a].items()}
        for a in DECODE_GRAPH_ARCHS})


# -------------------------- training phases --------------------------------
# Each family trains through its kernels: the SSM's scan forward and
# backward kernels, attention through flash_attention's autograd Function
# (the forward and backward kernels), the MoE router
# through moe_router's (the kernel forward, the weights' gradient at its
# indices backward).

@contextlib.contextmanager
def plain_training():
    """The model's attention, router and selective scan through the plain
    PyTorch versions, on the card, differentiated by autograd (no
    kernel's wrapper is called)."""
    saved = backend.attention, backend.moe_router, backend.mamba_scan
    backend.attention = (lambda q, k, v, *, causal=True:
                         attention_ref(q, k, v, causal=causal))
    backend.moe_router = moe_router_ref
    backend.mamba_scan = mamba_scan_ref
    try:
        yield
    finally:
        backend.attention, backend.moe_router, backend.mamba_scan = saved


def _trainer(arch: str, n_layers: int, dtype: str | None = None,
             experts: int | None = None, reduced: bool = False):
    full = (get_reduced if reduced else get_config)(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers,
                              param_dtype=dtype or full.param_dtype,
                              n_experts=experts or full.n_experts)
    model = Model(cfg)
    return cfg, model, Trainer(model, mesh=None,
                               opt_cfg=Opt.OptConfig(**LM_OPT),
                               device=DEVICE)


def tree_rel(got: dict, want: dict) -> tuple[float, float]:
    """||got - want|| / ||want|| over all leaves, and the worst leaf's."""
    num = den = worst = 0.0
    for g, w in zip(convert.leaves(got), convert.leaves(want)):
        d2 = (g.double() - w.double()).square().sum().item()
        w2 = w.double().square().sum().item()
        num, den = num + d2, den + w2
        worst = max(worst, (d2 / max(w2, 1e-300)) ** 0.5)
    return (num / den) ** 0.5, worst


def train_launches(cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` training steps: every layer's forward
    and its recompute in the backward launch its kernel (attention, each
    MoE layer's router, the scan); each attention call's backward and the
    scan's launch their backward kernels (three and two); the router's
    backward is plain PyTorch."""
    n = layer_counts(cfg)
    want = {k: 0 for k in kernel_launches()}
    want["flash_attention"] = 2 * flash_per_forward(n) * steps
    want["flash_attention_bwd"] = (flash_ops.BWD_LAUNCHES_PER_CALL
                                   * flash_per_forward(n) * steps)
    want["moe_router"] = 2 * n["moe"] * steps
    want["mamba_scan"] = 2 * n["ssm"] * steps
    want["mamba_scan_bwd"] = (scan_ops.BWD_LAUNCHES_PER_CALL * n["ssm"]
                              * steps)
    return want


@contextlib.contextmanager
def counting_drops():
    """Yields a list that gets, per ``grouped_ffn`` call (a MoE layer's
    forward or its recompute), the copies its capacity dropped."""
    real = Moe.grouped_ffn
    seen: list[int] = []

    def counting(x, idx, w, wg, wu, wd, capacity):
        counts = torch.bincount(idx.reshape(-1).long(),
                                minlength=wg.shape[0])
        seen.append(int((counts - capacity).clamp_min(0).sum()))
        return real(x, idx, w, wg, wu, wd, capacity)

    Moe.grouped_ffn = counting
    try:
        yield seen
    finally:
        Moe.grouped_ffn = real


def lm_batch(cfg, data: SyntheticLM, i: int) -> dict:
    """Step i's batch; a vlm's also carries its seeded patch embeddings
    (the loss drops their positions before the head), an encdec's its
    seeded frame embeddings (the encoder's inputs)."""
    b = data.batch(i)
    if cfg.family == "vlm":
        b["patch_embeds"] = frontend_embeds(cfg, SEED + i).expand(
            b["tokens"].shape[0], -1, -1).contiguous()
    if cfg.family == "encdec":
        b["frame_embeds"] = frontend_embeds(cfg, SEED + i).expand(
            b["tokens"].shape[0], -1, -1).contiguous()
    return b


def train_graph(model: Model, captures: int, replays: int) -> dict:
    """What ``model``'s compiled training steps did since the process-wide
    counts ``captures`` and ``replays`` (``train/programs.py``): captures
    and replays made, and each of its entries' capture ms, pool bytes and
    the kernel launches one replay records."""
    entries = [e for e in train_programs.TRAIN_STEP._entries.values()
               if e.key[0] is model]
    return dict(captures=programs.stats["captures"] - captures,
                replays=programs.stats["replays"] - replays,
                capture_ms=[e.capture_ms for e in entries],
                pool_bytes=[e.pool_bytes for e in entries],
                record=[{w.__name__: n for w, n in e.launches.items()}
                        for e in entries])


def _graph_line(g: dict) -> str:
    ms = ", ".join(f"{t:.1f}" for t in g["capture_ms"])
    gib = ", ".join(f"{b / 2**30:.2f}" for b in g["pool_bytes"])
    return (f"{g['captures']} capture ({ms} ms, pool {gib} GiB), "
            f"{g['replays']} replays")


def train_gate(arch: str, n_layers: int, batch: int, seq: int,
               experts: int | None = None,
               host_snapshots: bool = False, reduced: bool = False) -> dict:
    """fp32 at full width, ``n_layers`` layers.  The main path:
    ``Trainer.compile_step``'s ``GATE_STEPS`` steps through the kernels
    (``train/programs.py``: the first runs eagerly and captures the step
    as a CUDA graph, the others replay it; one capture), launch counts
    set to 0 just before and read just after.  Then, from the params
    before each of its steps, the same loss through the plain versions
    (held to 1e-5 relative), and step 1's gradients both ways (held to
    1e-4 relative in norm).  Then the eager ``make_train_step``'s
    ``GATE_STEPS`` steps from the same start, each loss bit-equal to the
    main path's (a replay does what the eager step does, and a MoE
    layer's recompute in the backward routes as its forward did), with
    the copies the MoE capacity drops counted on them (a count reads to
    the host, which a capture cannot hold); after them every param and
    moment bit-equal to the main path's last state, or, with
    ``host_snapshots`` (no room to keep that state), the params after
    each step bit-equal to the main path's.  Last, reported and not
    held, the plain path's own eager steps from the same start: Adam's
    first steps divide each gradient by its own magnitude, so where a
    gradient is near 0 the two paths' fp32 noise moves the params apart,
    and the losses drift apart step by step.  ``experts`` cuts the MoE
    layers' expert count; with ``host_snapshots`` the params before each
    step are kept in host memory (deepseek-v3's fp32 params, gradients
    and AdamW moments fill the card); ``reduced`` takes the arch's
    reduced config (its width too) in place of the full one."""
    cfg, model, trainer = _trainer(arch, n_layers, "float32", experts,
                                   reduced)
    keep = (lambda t: t.to("cpu", copy=True)) if host_snapshots \
        else (lambda t: t.clone())

    def fresh(tree):
        return convert.tree_map(lambda t: t.to(DEVICE, copy=True), tree)

    def on_card(tree):
        return convert.tree_map(lambda t: t.to(DEVICE), tree)
    matmul = torch.backends.cuda.matmul
    if (matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or matmul.allow_bf16_reduced_precision_reduction):
        raise AssertionError("reduced-precision products are on")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch), device=DEVICE)
    batches = [lm_batch(cfg, data, i) for i in range(GATE_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    params, state = trainer.init_state(SEED)
    step = trainer.compile_step()
    snaps, losses = [], []
    torch.cuda.synchronize()
    captures, replays = programs.stats["captures"], programs.stats["replays"]
    reset_launches()
    for b in batches:
        snaps.append(convert.tree_map(keep, params))
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    launches = kernel_launches()
    graph = train_graph(model, captures, replays)
    # the main path's last state, held against the eager steps' below
    final = None if host_snapshots else (params, state)
    del params, state
    free_cuda()                     # the entry, its graph and its pool
    peak = torch.cuda.max_memory_allocated() / 2**30
    # step 0's params on the card once for both gradients and its loss
    # (host snapshots cross the bus as few times as they can)
    p0 = on_card(snaps[0])
    before = kernel_launches()
    with plain_training():
        with torch.no_grad():
            plain = [float(model.loss_fn(on_card(p) if i else p0, b))
                     for i, (p, b) in enumerate(zip(snaps, batches))]
        _, g_plain = value_and_grad(model, p0, batches[0])
    plain_launches = {k: v - before[k] for k, v in kernel_launches().items()}
    if final is not None:
        del snaps[1:]               # room for the eager steps beside it
    _, g_kern = value_and_grad(model, p0, batches[0])
    grad_rel, worst_leaf = tree_rel(g_kern, g_plain)
    del g_kern, g_plain, p0
    free_cuda()
    # the eager step from the same start, bit for bit
    p = fresh(snaps[0])
    st = Opt.init(trainer.opt_cfg, p)
    eager = make_train_step(model, trainer.opt_cfg, trainer.tcfg)
    eager_losses, stepwise = [], []
    with counting_drops() as drops:
        for i, b in enumerate(batches):
            p, st, m = eager(p, st, b)
            eager_losses.append(float(m["loss"]))
            if final is None and i + 1 < len(snaps):
                stepwise.append(_bit_equal(p, snaps[i + 1]))
    bit = dict(losses=eager_losses == losses)
    if final is None:
        bit["params"] = all(stepwise)
    else:
        bit.update(params=_bit_equal(p, final[0]),
                   moments=_bit_equal(st, final[1]))
    del p, st, final, snaps[1:]
    free_cuda()
    with plain_training():
        p = on_card(snaps[0])
        st = Opt.init(trainer.opt_cfg, p)
        own = []
        for b in batches:
            p, st, m = eager(p, st, b)
            own.append(float(m["loss"]))
        del p, st, snaps
        free_cuda()
    rel = [abs(k - q) / abs(q) for k, q in zip(losses, plain)]
    own_rel = [abs(k - q) / abs(q) for k, q in zip(losses, own)]
    want = train_launches(cfg, GATE_STEPS)
    shown = {k: v for k, v in launches.items() if v or want[k]}
    n = layer_counts(cfg)
    dropped = sum(drops) // 2        # each forward ran again in the backward
    print(f"[train] {cfg.name} fp32, {cfg.n_layers} layers "
          f"({cfg.param_count() / 1e9:.3f} B params), batches {batch} x "
          f"{seq}: losses {losses}; the plain path from the same params "
          f"{plain}, max rel {max(rel):.3e} (bound 1e-5); step-1 gradients "
          f"rel {grad_rel:.3e} (bound 1e-4; worst leaf {worst_leaf:.3e}); "
          f"the compiled step {_graph_line(graph)}; the eager "
          f"make_train_step from the same start, bit-equal: losses "
          f"{bit['losses']}, params "
          + ("after each step " if "moments" not in bit else "")
          + f"{bit['params']}"
          + (f", moments {bit['moments']}" if "moments" in bit else "")
          + f"; launches {shown} = 2 x "
          f"({flash_per_forward(n)} attention, {n['moe']} MoE, {n['ssm']} "
          f"SSM) layers "
          f"x {GATE_STEPS} steps (forward and its recompute; the "
          f"attention backward {flash_ops.BWD_LAUNCHES_PER_CALL} and the "
          f"scan's {scan_ops.BWD_LAUNCHES_PER_CALL} per layer); "
          + (f"copies dropped by capacity {dropped} of "
             f"{GATE_STEPS * n['moe'] * batch * seq * cfg.top_k} routed "
             f"({GATE_STEPS} eager steps x {n['moe']} layers); " if n["moe"]
             else "")
          + f"peak {peak:.2f} GiB. Not held: the plain path's own steps "
          f"{own}, rel {[f'{r:.3e}' for r in own_rel]}")
    if launches != want:
        raise AssertionError(f"kernel path launches {launches}, expected "
                             f"{want}")
    if (graph["captures"], graph["replays"], len(graph["record"])) != (
            1, GATE_STEPS - 1, 1):
        raise AssertionError(f"the compiled step's entries {graph}")
    if any(plain_launches.values()):
        raise AssertionError(f"the plain path launched {plain_launches}")
    if not (np.isfinite(losses).all() and max(rel) <= 1e-5):
        raise AssertionError(f"losses {losses} vs plain {plain}")
    if not grad_rel <= 1e-4:
        raise AssertionError(f"step-1 gradients differ by {grad_rel}")
    if not all(bit.values()):
        raise AssertionError(f"the eager steps differ from the compiled "
                             f"ones: {bit}, {eager_losses} vs {losses}")
    return dict(n_layers=cfg.n_layers, batch=batch, seq=seq,
                n_experts=cfg.n_experts, losses=losses,
                plain_losses=plain, max_loss_rel=max(rel),
                grad_rel=grad_rel, worst_leaf_rel=worst_leaf, graph=graph,
                eager_bit_equal=bit, own_plain_losses=own,
                own_plain_rel=own_rel, launches=launches,
                dropped=dropped if n["moe"] else None, peak_gib=peak)


@contextlib.contextmanager
def timed_backwards():
    """Yields a dict that gets, per kernel Function (``mamba_scan``,
    ``flash_attention``, ``moe_router``), the host seconds of each call
    of its backward, each between two synchronisations, inside whatever
    step runs meanwhile."""
    fns = {"mamba_scan": scan_ops._Scan, "flash_attention": flash_ops._Flash,
           "moe_router": router_ops._Router}
    saved = {k: fn.backward for k, fn in fns.items()}
    times: dict[str, list[float]] = {k: [] for k in fns}

    def timed(name):
        def backward(ctx, *g):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](ctx, *g)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return out
        return staticmethod(backward)

    for k, fn in fns.items():
        fn.backward = timed(k)
    try:
        yield times
    finally:
        for k, fn in fns.items():
            fn.backward = staticmethod(saved[k])


def train_timing(arch: str, n_layers: int, batch: int, seq: int,
                 plain_curve: bool, experts: int | None = None) -> dict:
    """bf16, the config's own dtype, full width, ``n_layers`` layers: the
    compiled step (``Trainer.compile_step``) once warm (its eager warm-up
    and capture) and ``TIMED_STEPS`` replays timed, one replay under the
    profiler; then, its graph and pool freed, the eager
    ``make_train_step`` once warm and ``TIMED_STEPS`` timed, one under the
    profiler (host ms and device busy ms per step, the graph beside the
    eager step, on the same state); then one eager step taken by its
    parts (forward, backward, optimizer; each kernel Function's backward
    timed inside it).  With ``plain_curve``, the eager steps again from
    the same seed through the plain versions, their losses reported
    beside the kernels' (the bf16 flash kernel rounds P to bf16 before
    P @ V, the plain version does not).  ``experts`` cuts the MoE layers'
    expert count."""
    cfg, model, trainer = _trainer(arch, n_layers, experts=experts)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state = trainer.init_state(SEED)
    torch.cuda.synchronize()
    print(f"[train] {cfg.name} bf16, {cfg.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
          f"(params and AdamW moments)")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch), device=DEVICE)
    step = trainer.compile_step()
    steps = 1 + TIMED_STEPS
    captures, replays = programs.stats["captures"], programs.stats["replays"]
    reset_launches()
    losses, times = [], []
    for i in range(steps):
        b = lm_batch(cfg, data, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    want = train_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    graph = train_graph(model, captures, replays)
    if (graph["captures"], graph["replays"]) != (1, TIMED_STEPS):
        raise AssertionError(f"the compiled step's entries {graph}")
    if not (np.isfinite(losses).all() and max(losses) > min(losses)):
        raise AssertionError(f"bf16 losses {losses}")
    step_ms = float(np.median(times[1:]))
    tokens = batch * seq
    b = lm_batch(cfg, data, steps)

    def one_step():
        nonlocal params, state
        params, state, m = step(params, state, b)
        float(m["loss"])

    prof = profile_window(f"{cfg.name} bf16 training step (graph)",
                          one_step, 1)
    free_cuda()                     # the entry, its graph and its pool
    # the eager step on the same state: one warm, TIMED_STEPS timed, one
    # profiled
    eager = make_train_step(model, trainer.opt_cfg, trainer.tcfg)
    eager_times = []
    for i in range(1 + TIMED_STEPS):
        b = lm_batch(cfg, data, steps + 1 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = eager(params, state, b)
        float(m["loss"])
        torch.cuda.synchronize()
        eager_times.append((time.perf_counter() - t0) * 1e3)
    eager_ms = float(np.median(eager_times[1:]))

    def one_eager():
        nonlocal params, state
        params, state, m = eager(params, state, b)
        float(m["loss"])

    prof_eager = profile_window(f"{cfg.name} bf16 training step (eager)",
                                one_eager, 1)

    # one warm eager step by its parts, each Function's backward timed
    # inside it
    b = lm_batch(cfg, data, steps + 2 + TIMED_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs = [t.detach().requires_grad_() for t in convert.leaves(params)]
    loss = model.loss_fn(convert.unflatten(params, xs), b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with timed_backwards() as bwd:
        grads = torch.autograd.grad(loss, xs, materialize_grads=True)
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
    split_ms = (t3 - t0) * 1e3
    n = layer_counts(cfg)
    calls = {"mamba_scan": n["ssm"], "flash_attention": flash_per_forward(n),
             "moe_router": n["moe"]}
    if {k: len(v) for k, v in bwd.items()} != calls:
        raise AssertionError(f"backwards in a step {bwd}, expected {calls}")
    bwd_ms = {k: sum(v) * 1e3 for k, v in bwd.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(n_layers=cfg.n_layers, batch=batch, seq=seq,
               n_experts=cfg.n_experts, step_ms=step_ms, step_ms_all=times, tok_per_s=tokens
               / (step_ms / 1e3), losses=losses, launches=launches, **split,
               split_step_ms=split_ms, function_backward_ms=bwd_ms,
               function_backward_share={k: v / split_ms
                                        for k, v in bwd_ms.items()},
               device_busy_ms=prof["device_busy_ms"],
               idle_share=1 - prof["device_busy_ms"] / step_ms,
               device_ops=prof["device_ops"], top=prof["top"],
               kernels=prof["kernels"], peak_gib=peak, graph=graph,
               eager_step_ms=eager_ms, eager_step_ms_all=eager_times,
               eager_device_busy_ms=prof_eager["device_busy_ms"],
               eager_idle_share=1 - prof_eager["device_busy_ms"] / eager_ms,
               eager_device_ops=prof_eager["device_ops"])
    shown = {k: v for k, v in launches.items() if v}
    parts = "; ".join(
        f"the {k} backward {v:.1f} ms of it ({calls[k]} calls, "
        f"{100 * out['function_backward_share'][k]:.1f}%"
        + (", the backward kernel" if k == "flash_attention" else "")
        + ")" for k, v in bwd_ms.items())
    print(f"[train] {cfg.name} bf16, {cfg.n_layers} layers, {batch} x "
          f"{seq} tokens per step: {step_ms:.1f} ms per step (warm median "
          f"of {TIMED_STEPS}; all {[round(t, 1) for t in times]}), "
          f"{out['tok_per_s']:.1f} tokens/s; split forward "
          f"{split['forward_ms']:.1f} / backward {split['backward_ms']:.1f} "
          f"/ optimizer {split['optimizer_ms']:.1f} ms; {parts}; device "
          f"busy {prof['device_busy_ms']:.1f} ms per step (idle "
          f"{100 * out['idle_share']:.1f}%); losses {losses}; launches "
          f"{shown} over {steps} steps; peak {peak:.2f} GiB")
    print(f"[train] {cfg.name} bf16, {cfg.n_layers} layers, graph vs eager "
          f"on {CARD}: host {step_ms:.1f} vs {eager_ms:.1f} ms per step "
          f"(warm medians of {TIMED_STEPS}; eager all "
          f"{[round(t, 1) for t in eager_times]}), device busy "
          f"{prof['device_busy_ms']:.1f} vs "
          f"{prof_eager['device_busy_ms']:.1f} ms per step over "
          f"{prof['device_ops']:.0f} vs {prof_eager['device_ops']:.0f} "
          f"kernels and copies; the compiled step {_graph_line(graph)}")
    del params, state
    free_cuda()
    if plain_curve:
        params, state = trainer.init_state(SEED)
        plain = []
        with plain_training():
            for i in range(steps):
                params, state, m = eager(params, state,
                                         lm_batch(cfg, data, i))
                plain.append(float(m["loss"]))
        del params, state
        free_cuda()
        out["plain_losses"] = plain
        print(f"[train] {cfg.name} bf16 loss curve, kernels {losses} vs "
              f"the plain path {plain} from the same seed (reported, not "
              f"held: the bf16 kernel rounds P to bf16 before P @ V)")
    return out


def new_lm_phases(arch: str, plan: dict) -> dict:
    """One of ``NEW_LM``'s archs: its fp32 serving gate, bf16 serving
    (and ``launch.serve`` where it fits whole), the fp32 training gate,
    bf16 training and ``launch.train --reduced`` on the card."""
    out = {}
    with phase(f"{arch} fp32 gate ({plan['gate'] or 'all'} layers)"):
        out["fp32"] = lm_gate(arch, plan["gate"])
    with phase(f"{arch} bf16 timing ({plan['serve'] or 'all'} layers)"
               + (" and serve" if plan["serve_entry"] else "")):
        out["bf16"] = lm_timing(arch, plan["serve"])
        if plan["serve_entry"]:
            out["serve"] = serve_entry.main(["--arch", arch, "--device",
                                             "cuda"])
        free_cuda()
    layers, experts = plan["train_gate"]
    with phase(f"{arch} fp32 training gate ({layers} layers"
               + (f", {experts} experts" if experts else "") + ")"):
        out["train_fp32"] = train_gate(
            arch, layers, LM_GATE_BATCH, LM_GATE_SEQ, experts=experts,
            host_snapshots=plan.get("host_snapshots", False))
        free_cuda()
    layers, batch, seq, experts = plan["train"]
    with phase(f"{arch} bf16 training ({layers} layers"
               + (f", {experts} experts" if experts else "")
               + ") and train"):
        out["train_bf16"] = train_timing(arch, layers, batch, seq,
                                         plain_curve=False, experts=experts)
        free_cuda()
        out["train_entry"] = train_entry.main(
            ["--arch", arch, "--reduced", "--steps", "5", "--device",
             "cuda"])
        if not np.isfinite([out["train_entry"]["first_loss"],
                            out["train_entry"]["last_loss"]]).all():
            raise AssertionError(f"launch.train {arch}: "
                                 f"{out['train_entry']}")
        free_cuda()
    return out


# ------------------- the encoder-decoder and hybrid families ---------------
# seamless-m4t-large-v2 (2.04 B params, 4.1 GB in bf16) runs whole in every
# phase: its requests and batches carry 1024 seeded frame embeddings (the
# audio stub), which ``launch.serve``'s and the ``Engine``'s requests
# cannot (``KeyError: 'frame_embeds'``, as in the JAX package), so it
# serves through ``prefill`` / ``decode_step`` (``frontend_serve``).
# Training: the fp32 gate at 2 x 256 tokens (2.04 B x 16 B of params,
# gradients and AdamW moments, 32.6 GB, and the gate's three snapshots,
# 24.5 GB), bf16 at 2 x 2048 tokens.
# jamba-1.5-large-398b: ``n_layers`` must stay a multiple of its
# attention period (8), so the depth cut is one period; one full-width
# period still holds 45.24 B params (90.5 GB in bf16), so the expert
# count is the one further cut (top-2, the expert width 24576, d_inner
# 16384 and the period's layout stay): 4 experts in the fp32 serving
# gate (16.25 B, 65.0 GB), 12 in bf16 serving (35.57 B, 71.1 GB), 2 in
# the bf16 loss and gradients (11.41 B: 22.8 GB of params and 22.8 GB
# of gradients; no AdamW step: its fp32 moments and master-free update
# would need 12 B a param, 137 GB).  Its fp32 training gate and
# ``launch.train`` / ``launch.serve`` run the reduced config.
ENCDEC_ARCH = "seamless-m4t-large-v2"
HYBRID_ARCH = "jamba-1.5-large-398b"
ENCDEC_TRAIN = (2, 2048)                  # bf16 training, batch x tokens
HYBRID_EXPERTS = dict(gate=4, serve=12, grads=2)
HYBRID_GRADS = (2, 1024)                  # the gradient run, batch x tokens
# the reduced config's fp32 training gate: its plain scan, a step per
# token, takes most of the gate's time (29 s with launch.train and
# launch.serve at 2 x 256)
HYBRID_REDUCED_SEQ = 64


def frameless_refused(model: Model, params) -> dict:
    """An encdec request without frames, as ``launch.serve`` makes it:
    the ``Engine`` raises ``KeyError: 'frame_embeds'`` at its prefill, as
    the JAX engine does; so does ``launch.train``'s first step at the
    reduced config, as the JAX driver's."""
    eng = Engine(model, params, EngineConfig(n_slots=1, max_len=64))
    eng.submit(Request(req_id=0, tokens=np.arange(4), max_new=2))
    raised = []
    for run in (eng.step, lambda: train_entry.main(
            ["--arch", ENCDEC_ARCH, "--reduced", "--steps", "1", "--batch",
             "2", "--seq", "8", "--device", "cuda"])):
        try:
            run()
        except KeyError as e:
            raised.append(str(e))
    if raised != ["'frame_embeds'"] * 2:
        raise AssertionError(f"frameless requests raised {raised}")
    print("[lm] a request or batch without frames raises KeyError: "
          "'frame_embeds' in the Engine and in launch.train, as in the JAX "
          "package")
    return dict(engine="KeyError", train_entry="KeyError")


def encdec_gate(arch: str) -> dict:
    """fp32 at full width and depth: ``frontend_serve`` held to
    LOGIT_TOL, prefill(S) against prefill(S - 1) and a decode step (the
    ``{"enc"}`` cache carried), and the frameless request refused."""
    cfg = dataclasses.replace(get_config(arch), param_dtype="float32")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, DEVICE)
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name} fp32, {cfg.encoder_layers} + {cfg.n_layers} "
          f"layers: {cfg.param_count() / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = lm_prompts(cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    out = frontend_serve(model, params, prompts, hold=True)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["prefill_then_decode"] = prefill_then_decode(
        model, params, prompts[:3], LOGIT_TOL,
        extra={"frame_embeds": frontend_embeds(cfg)})
    out["frameless"] = frameless_refused(model, params)
    out["decode_graphs"] = decode_graphs(
        arch, model, params, prompts[2], LOGIT_TOL,
        extra={"frame_embeds": frontend_embeds(cfg)})
    out.update(n_layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
               params_b=cfg.param_count() / 1e9, logit_tol=LOGIT_TOL)
    print(f"[lm] {cfg.name} fp32 peak {out['peak_gib']:.2f} GiB")
    del params
    free_cuda()
    return out


def encdec_timing(arch: str) -> dict:
    """bf16 at full width and depth: ``frontend_serve`` timed (TTFT with
    the encoder's pass, decode ms per token, device busy and ops per
    token, the longest prefill profiled), drift against the plain path
    reported."""
    cfg = get_config(arch)
    model = Model(cfg)
    params = model.init(SEED, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    prompts = lm_prompts(cfg.vocab)
    out = frontend_serve(model, params, prompts, hold=False)
    out["decode_graphs"] = decode_graphs(
        arch, model, params, prompts[-1],
        extra={"frame_embeds": frontend_embeds(cfg)}, timed=True)
    wbytes = weight_bytes(params)
    out.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               weight_gb=wbytes / 1e9,
               weight_read_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3)
    print(f"[lm] {cfg.name} bf16 TTFT ms by prompt length with the "
          f"encoder's pass (warm, alone): {out['ttft_ms']}; decode ms per "
          f"token {out['decode_ms']}; weight-read bound "
          f"{out['weight_read_bound_ms']:.3f} ms; peak "
          f"{out['peak_gib']:.2f} GiB")
    del params
    free_cuda()
    return out


def hybrid_grads(arch: str, batch: int, seq: int, experts: int) -> dict:
    """bf16 at full width, one period, ``experts`` experts: the loss and
    its gradients (``trainer.value_and_grad``), the main path of training
    short of the optimizer (no AdamW step fits), twice from the same
    params and batch: every gradient finite, the second call bit-equal to
    the first (the first kept in host memory), each call's launches
    counted (every sublayer's forward and its recompute in the backward;
    the scan's backward two launches a call), each kernel Function's
    backward timed inside the first call, and one call profiled."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=full.attn_period,
                              n_experts=experts)
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, DEVICE)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch), device=DEVICE)
    b = lm_batch(cfg, data, 0)
    want = train_launches(cfg, 1)
    calls, times = [], []
    for i in range(2):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with timed_backwards() as bwd:
            loss, grads = value_and_grad(model, params, b)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        calls.append(kernel_launches())
        if i == 0:
            first_loss = float(loss)
            bwd_ms = {k: sum(v) * 1e3 for k, v in bwd.items() if v}
            finite = all(bool(torch.isfinite(g).all())
                         for g in convert.leaves(grads))
            kept = [g.to("cpu") for g in convert.leaves(grads)]
            del grads
            free_cuda()
    equal = float(loss) == first_loss and all(
        torch.equal(g.to("cpu"), k) for g, k in zip(convert.leaves(grads),
                                                     kept))
    del grads, kept
    free_cuda()

    def one():
        _, g = value_and_grad(model, params, b)
        del g

    prof = profile_window(f"{cfg.name} bf16 loss and gradients", one, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = layer_counts(cfg)
    print(f"[train] {cfg.name} bf16, one period ({cfg.n_layers} sublayers, "
          f"{experts} experts, {cfg.param_count() / 1e9:.3f} B params), "
          f"{batch} x {seq} tokens: loss {first_loss}, value_and_grad "
          f"{[round(t, 1) for t in times]} ms, the second bit-equal "
          f"{equal}, gradients finite {finite}; launches a call "
          f"{ {k: v for k, v in calls[0].items() if v} } = 2 x ("
          f"{n['attn']} attention, {n['moe']} MoE, {n['ssm']} Mamba) "
          f"sublayers, the scan's backward {scan_ops.BWD_LAUNCHES_PER_CALL} "
          f"x {n['ssm']}; Function backwards {bwd_ms} ms; device busy "
          f"{prof['device_busy_ms']:.1f} ms over {prof['device_ops']:.0f} "
          f"ops; peak {peak:.2f} GiB. No AdamW step: one period's fp32 "
          f"moments and update need 12 B a param")
    if calls != [want, want]:
        raise AssertionError(f"launches {calls}, expected {want} a call")
    if not (finite and np.isfinite(first_loss) and equal):
        raise AssertionError(f"gradients: finite {finite}, loss "
                             f"{first_loss}, repeat bit-equal {equal}")
    del params
    free_cuda()
    return dict(n_layers=cfg.n_layers, n_experts=experts, batch=batch,
                seq=seq, params_b=cfg.param_count() / 1e9, loss=first_loss,
                ms=times, launches=calls[0], repeat_bit_equal=equal,
                finite=finite, function_backward_ms=bwd_ms,
                device_busy_ms=prof["device_busy_ms"],
                device_ops=prof["device_ops"], top=prof["top"],
                kernels=prof["kernels"], peak_gib=peak)


def encdec_hybrid_phases() -> dict:
    """seamless-m4t-large-v2 whole (fp32 and bf16 serving, fp32 training
    gate, bf16 training) and jamba-1.5-large-398b at one period of full
    width with its expert count cut (fp32 serving gate, bf16 serving and
    ``Engine``, bf16 loss and gradients), its reduced config's fp32
    training gate, ``launch.serve`` and ``launch.train`` on the card."""
    out = {}
    with phase(f"{ENCDEC_ARCH} fp32 gate (all layers)"):
        out["encdec_fp32"] = encdec_gate(ENCDEC_ARCH)
    with phase(f"{ENCDEC_ARCH} bf16 timing (all layers)"):
        out["encdec_bf16"] = encdec_timing(ENCDEC_ARCH)
    full = get_config(ENCDEC_ARCH)
    with phase(f"{ENCDEC_ARCH} fp32 training gate (all layers)"):
        out["encdec_train_fp32"] = train_gate(
            ENCDEC_ARCH, full.n_layers, LM_GATE_BATCH, LM_GATE_SEQ)
        free_cuda()
    with phase(f"{ENCDEC_ARCH} bf16 training (all layers)"):
        out["encdec_train_bf16"] = train_timing(
            ENCDEC_ARCH, full.n_layers, *ENCDEC_TRAIN, plain_curve=False)
        free_cuda()
    period = get_config(HYBRID_ARCH).attn_period
    e = HYBRID_EXPERTS
    with phase(f"{HYBRID_ARCH} fp32 gate (1 period, {e['gate']} experts)"):
        out["hybrid_fp32"] = lm_gate(HYBRID_ARCH, period, e["gate"])
    with phase(f"{HYBRID_ARCH} bf16 timing (1 period, {e['serve']} "
               f"experts)"):
        out["hybrid_bf16"] = lm_timing(HYBRID_ARCH, period, e["serve"])
    with phase(f"{HYBRID_ARCH} bf16 loss and gradients (1 period, "
               f"{e['grads']} experts)"):
        out["hybrid_grads"] = hybrid_grads(HYBRID_ARCH, *HYBRID_GRADS,
                                           e["grads"])
    with phase(f"{HYBRID_ARCH} reduced: fp32 training gate, train and "
               f"serve"):
        out["hybrid_train_fp32"] = train_gate(
            HYBRID_ARCH, get_reduced(HYBRID_ARCH).n_layers, LM_GATE_BATCH,
            HYBRID_REDUCED_SEQ, reduced=True)
        free_cuda()
        out["hybrid_train_entry"] = train_entry.main(
            ["--arch", HYBRID_ARCH, "--reduced", "--steps", "5", "--device",
             "cuda"])
        out["hybrid_serve_entry"] = serve_entry.main(
            ["--arch", HYBRID_ARCH, "--reduced", "--device", "cuda"])
        if not np.isfinite([out["hybrid_train_entry"]["first_loss"],
                            out["hybrid_train_entry"]["last_loss"]]).all():
            raise AssertionError(f"launch.train {HYBRID_ARCH}: "
                                 f"{out['hybrid_train_entry']}")
        free_cuda()
    return out


# ----------------------------- phase 13 ------------------------------------
# The multi-tenant prediction service at the paper's width

SERVICE_TENANTS = 16
SERVICE_INTERVALS = 40        # phase a's seeded stream, per tenant
SERVICE_MAX_JOBS = 32         # live jobs of a tenant in an interval: 1..32
SERVICE_PROMOTED = 8          # intervals the promoted model serves, then
SERVICE_ROLLED_BACK = 4       # those after the rollback
SERVICE_DEGRADED = 6
SERVICE_MIN_PAIRS = 256       # replay pairs the buffer holds at the retrain
# the retrain's size: the newest 512 pairs (32 held back), 3 epochs of
# batches of 64 at start_tech.pretrain's learning rate
SERVICE_RETRAIN = dict(buffer_cap=512, train_epochs=3, train_lr=TRAIN_LR)
RETRAIN_REL = 1e-5            # shadow and training losses, relative
PARETO_DURATIONS = (2.5, 1.0)  # a finished job's task durations: alpha, beta
TICK_TENANTS = (1, 4, 16)     # tenants in a timed tick, 32 jobs each
TICK_REPS = 10
PROFILED_TICKS = 5
PROFILE_TRIES = 5             # profiled windows before busy ms is not measured
TCP_SNAPSHOTS = 40            # per client, 16 clients
DRILL_TENANTS, DRILL_BEFORE, DRILL_AFTER = 4, 3, 3
# launch.train's checkpoint drill: checkpoints at steps 4 and 8, killed
# after step 9, resumed from step 8
TRAIN_DRILL = ["--arch", SSM_ARCH, "--reduced", "--steps", "16", "--batch",
               "4", "--seq", "16", "--ckpt-every", "4"]
KILL_AT, RESUME_AT = 9, 8
CARD = "not measured"         # the card's name and power limit (phase 1)


def service_profile(trigger: str) -> Profile:
    return Profile(n_hosts=PAPER["n_hosts"], max_tasks=PAPER["max_tasks"],
                   horizon=PAPER["horizon"], k=PAPER["k"], trigger=trigger)


class TenantStream:
    """One tenant's seeded telemetry in wire form: :class:`Telemetry`'s
    cluster with 1..``max_jobs`` live jobs an interval; a job that leaves
    (its tasks all finished, or the backlog shrank) is reported once in
    ``done``, with Pareto durations for its tasks."""

    def __init__(self, tenant: str, n_hosts: int, max_tasks: int, seed: int,
                 max_jobs: int = SERVICE_MAX_JOBS):
        self.tenant, self.max_jobs = tenant, max_jobs
        self.tel = Telemetry(n_hosts, max_tasks, seed)
        self.seq = 0

    def step(self, n_jobs: int | None = None) -> tuple[dict, dict]:
        """The next snapshot (a ``snapshot`` request without its ``op``)
        and its :meth:`Telemetry.step` dict, which :func:`hold_decisions`
        reads; ``n_jobs`` fixes the live jobs (else 1..``max_jobs``)."""
        gen = self.tel
        qs = {j: d["q"] for j, d in gen.jobs.items()}
        tel = gen.step(int(gen.rng.integers(1, self.max_jobs + 1))
                       if n_jobs is None else n_jobs)
        alpha, beta = PARETO_DURATIONS
        done = [{"id": j, "times": beta * (1.0 + gen.rng.pareto(alpha, q))}
                for j, q in sorted(qs.items()) if j not in gen.jobs]
        jobs = []
        for i, j in enumerate(tel["job_ids"]):
            tids, hosts, slots = tel["incomplete_fn"](j)
            jobs.append(wire.job_to_wire(
                int(j), int(tel["q"][i]), tel["m_t"][i],
                open_count=len(tids), deadline=bool(tel["deadline"][i]),
                tasks=list(zip(tids, hosts, slots))))
        snap = wire.snapshot_to_wire(self.tenant, self.seq, tel["m_h"], jobs,
                                     done)
        self.seq += 1
        return snap, tel


def service_streams(n: int, prefix: str = "tenant",
                    seed: int = SEED) -> list:
    """``n`` tenants' streams at the paper's width."""
    return [TenantStream(f"{prefix}{i}", PAPER["n_hosts"],
                         PAPER["max_tasks"], seed + i) for i in range(n)]


def _answer_keys(res: dict) -> list[tuple]:
    """The actions of a service answer, each keyed by its job first."""
    return [(j["id"], a.get("task", -1), a["kind"], a.get("target"),
             a.get("host", -1)) for j in res["jobs"] for a in j["actions"]]


def hold_answers(t: int, svc_a, svc_b, tenant: str, tel: dict, ra: dict,
                 rb: dict) -> dict:
    """Hold service b's answer to one snapshot against service a's: both
    answered, with the same seq, version, degraded flag and repairs; E_S
    and the per-task scores within the Tier-1 bound; the actions and the
    tenant's trigger state as :func:`hold_decisions` holds them."""
    for r in (ra, rb):
        if not r.get("ok"):
            raise AssertionError(f"interval {t} {tenant}: {r}")
    for key in ("seq", "version", "degraded", "sanitized"):
        if ra[key] != rb[key]:
            raise AssertionError(f"interval {t} {tenant}: {key} "
                                 f"{ra[key]!r} != {rb[key]!r}")
    if [j["id"] for j in ra["jobs"]] != [j["id"] for j in rb["jobs"]]:
        raise AssertionError(f"interval {t} {tenant}: answered other jobs")
    e_a = np.array([j["e_s"] for j in ra["jobs"]])
    e_b = np.array([j["e_s"] for j in rb["jobs"]])
    rel = es_drift(t, e_a, e_b)
    if ra["jobs"] and "scores" in ra["jobs"][0]:
        rel = max(rel, es_drift(
            t, np.concatenate([j["scores"] for j in ra["jobs"]]),
            np.concatenate([j["scores"] for j in rb["jobs"]]),
            what="per-task scores"))
    flips = hold_decisions(t, svc_a.tenants[tenant].controller,
                           svc_b.tenants[tenant].controller, tel, e_a,
                           _answer_keys(ra), _answer_keys(rb))
    return dict(rel=rel, flips=flips)


def service_lockstep(svc_a, svc_b, streams, n: int, t0: int = 0,
                     launches_per_tick: int = CELLS_PER_STEP) -> dict:
    """Feed two services the same snapshots, every tenant's queued before
    one ``tick`` of each (so both group the tenants alike), for ``n``
    intervals, and hold b's answers against a's (:func:`hold_answers`).
    a's tick must launch ``lstm_cell`` ``launches_per_tick`` times."""
    worst, flips, actions = 0.0, 0, 0
    for t in range(t0, t0 + n):
        snaps = [s.step() for s in streams]
        pa = [svc_a.submit(s.tenant, snap)
              for s, (snap, _) in zip(streams, snaps)]
        pb = [svc_b.submit(s.tenant, snap)
              for s, (snap, _) in zip(streams, snaps)]
        before = lstm_cell.launches
        if svc_a.tick() != len(streams):
            raise AssertionError(f"interval {t}: the tick left tenants out")
        launched = lstm_cell.launches - before
        if svc_b.tick() != len(streams):
            raise AssertionError(f"interval {t}: the twin's tick left "
                                 f"tenants out")
        if launched != launches_per_tick:
            raise AssertionError(f"interval {t}: the tick launched "
                                 f"lstm_cell {launched} times, expected "
                                 f"{launches_per_tick}")
        for s, (_, tel), p, q in zip(streams, snaps, pa, pb):
            r = hold_answers(t, svc_a, svc_b, s.tenant, tel, p.result,
                             q.result)
            worst = max(worst, r["rel"])
            flips += r["flips"]
            actions += sum(len(j["actions"]) for j in p.result["jobs"])
    return dict(intervals=n, max_rel=worst, flips=flips, actions=actions)


def service_pair(trigger: str, root: Path, **cfg) -> tuple:
    """A service on the card and its CPU twin serving the same weights
    (the twin's VersionStore is a copy of the card's, whose version 0
    holds the card service's seeded weights), with the same tenants."""
    prof = service_profile(trigger)
    dir_a, dir_b = root / f"{trigger}-card", root / f"{trigger}-cpu"
    svc_a = PredictionService(ServiceConfig(
        prof, ckpt_dir=str(dir_a), device=DEVICE, **cfg))
    shutil.copytree(dir_a, dir_b)
    svc_b = PredictionService(ServiceConfig(
        prof, ckpt_dir=str(dir_b), device="cpu", **cfg))
    for a, b in zip(convert.leaves(svc_a.params),
                    convert.leaves(svc_b.params)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("the twin's weights differ from the card's")
    streams = service_streams(SERVICE_TENANTS)
    for s in streams:
        for svc in (svc_a, svc_b):
            r = svc.hello(s.tenant, prof.to_wire())
            if not r["ok"]:
                raise AssertionError(f"{s.tenant}: {r}")
    return svc_a, svc_b, streams


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), TIER1_ABS_FLOOR)


def service_retrain(svc_a, svc_b) -> dict:
    """One retrain -> shadow-eval -> promote cycle on each service: the
    card's losses within ``RETRAIN_REL`` of the twin's, the same decision
    and version, and ``lstm_cell`` launched 10 times per ``train_step`` of
    the fit and per shadow evaluation (two of them)."""
    pairs = len(svc_a.buffer)
    if pairs < SERVICE_MIN_PAIRS or len(svc_b.buffer) != pairs:
        raise AssertionError(f"replay buffers of {pairs} and "
                             f"{len(svc_b.buffer)} pairs at the retrain")
    before = lstm_cell.launches
    t0 = time.perf_counter()
    ra = svc_a.retrain_now()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = lstm_cell.launches - before
    rb = svc_b.retrain_now()
    n = ra["train_pairs"]
    steps = SERVICE_RETRAIN["train_epochs"] * max(n // TRAIN_BATCH, 1)
    if launched != CELLS_PER_STEP * (steps + 2):
        raise AssertionError(f"the retrain launched lstm_cell {launched} "
                             f"times, expected {CELLS_PER_STEP} x ({steps} "
                             f"train steps + 2 shadow evaluations)")
    rel = max(_rel(ra[k], rb[k]) for k in ("champion_loss",
                                           "candidate_loss",
                                           "final_train_loss"))
    if rel > RETRAIN_REL:
        raise AssertionError(f"retrain losses card {ra} vs cpu {rb}: "
                             f"{rel:.3e} > {RETRAIN_REL}")
    for key in ("promoted", "version", "train_pairs", "eval_pairs"):
        if ra[key] != rb[key]:
            raise AssertionError(f"retrain {key}: {ra[key]} != {rb[key]}")
    if not ra["promoted"]:
        raise AssertionError(f"the candidate was not promoted: {ra}")
    return dict(wall_s=wall_s, launches=launched, train_steps=steps,
                max_rel=rel, card=ra, cpu=rb)


def service_trigger(trigger: str, root: Path) -> dict:
    """Phases a-c of the service in one trigger: lockstep with the CPU
    twin, a retrain -> promote cycle, the promoted model in lockstep, a
    rollback on both, lockstep again; then degraded mode in lockstep."""
    svc_a, svc_b, streams = service_pair(trigger, root, **SERVICE_RETRAIN)
    out = dict(lockstep=service_lockstep(svc_a, svc_b, streams,
                                         SERVICE_INTERVALS))
    out["buckets"] = svc_a.stats()["buckets"]
    if bucket_size(SERVICE_TENANTS * SERVICE_MAX_JOBS) not in out["buckets"]:
        raise AssertionError(f"no dispatch reached bucket "
                             f"{SERVICE_TENANTS * SERVICE_MAX_JOBS}: "
                             f"{out['buckets']}")
    out["buffer_pairs"] = len(svc_a.buffer)
    out["retrain"] = service_retrain(svc_a, svc_b)
    t = SERVICE_INTERVALS
    out["promoted"] = service_lockstep(svc_a, svc_b, streams,
                                       SERVICE_PROMOTED, t0=t)
    ka, kb = svc_a.rollback_now(), svc_b.rollback_now()
    if not (ka["ok"] and ka == kb and ka["version"] == 0):
        raise AssertionError(f"rollback: card {ka}, cpu {kb}")
    out["rolled_back"] = service_lockstep(
        svc_a, svc_b, streams, SERVICE_ROLLED_BACK, t0=t + SERVICE_PROMOTED)
    out["stats"] = {k: v for k, v in svc_a.stats().items()
                    if isinstance(v, int)}
    # c: degraded mode, a pointer to a version that was never saved
    prof = service_profile(trigger)
    degraded = []
    for name, dev in (("card", DEVICE), ("cpu", "cpu")):
        d = root / f"{trigger}-degraded-{name}"
        d.mkdir()
        (d / "CURRENT").write_text(json.dumps({"current": 7,
                                               "history": []}))
        svc = PredictionService(ServiceConfig(prof, ckpt_dir=str(d),
                                              device=dev))
        if not svc.degraded:
            raise AssertionError("a missing version did not degrade")
        degraded.append(svc)
    streams = service_streams(SERVICE_TENANTS, prefix="degraded")
    for s in streams:
        for svc in degraded:
            svc.hello(s.tenant, prof.to_wire())
    out["degraded"] = service_lockstep(*degraded, streams, SERVICE_DEGRADED,
                                       launches_per_tick=0)
    out["degraded"]["answers"] = degraded[0].stats()["degraded_answers"]
    for key in ("lockstep", "promoted", "rolled_back", "degraded"):
        r = out[key]
        print(f"[service] {trigger} {key}: {r['intervals']} intervals x "
              f"{SERVICE_TENANTS} tenants, {DEVICE} vs cpu, E_S and scores "
              f"max rel drift {r['max_rel']:.3e}, {r['actions']} actions, "
              f"{r['flips']} boundary flips")
    r = out["retrain"]
    print(f"[service] {trigger} retrain: {r['card']['train_pairs']} train "
          f"+ {r['card']['eval_pairs']} eval pairs of {out['buffer_pairs']}, "
          f"{r['train_steps']} train steps, losses champion "
          f"{r['card']['champion_loss']:.6g} candidate "
          f"{r['card']['candidate_loss']:.6g} (max rel vs cpu "
          f"{r['max_rel']:.3e}), promoted to v{r['card']['version']}, "
          f"{r['launches']} lstm_cell launches, {r['wall_s']:.3f} s wall; "
          f"buckets {out['buckets']} [{CARD}]")
    return out


def service_timing() -> dict:
    """Host ms of one tick (the tick alone, snapshots already queued) at
    1, 4 and 16 tenants of 32 jobs each (buckets 32, 128 and 512), and a
    profiled window of 16-tenant ticks: device busy ms and device ops per
    tick, and ``lstm_cell``'s device time per launch at bucket 512 beside
    its bound."""
    prof = service_profile("milestone")
    svc = PredictionService(ServiceConfig(prof, device=DEVICE))
    streams = service_streams(SERVICE_TENANTS, prefix="timed")
    for s in streams:
        svc.hello(s.tenant, prof.to_wire())

    def queue(n):
        for s in streams[:n]:
            svc.submit(s.tenant, s.step(SERVICE_MAX_JOBS)[0])

    def tick(n):
        if svc.tick() != n:
            raise AssertionError("the tick left tenants out")

    out = {}
    for n in TICK_TENANTS:
        ms = []
        for i in range(TICK_REPS + 3):
            queue(n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tick(n)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"tick_ms_{n}"] = float(np.median(ms[3:]))

    def whole():
        queue(SERVICE_TENANTS)
        tick(SERVICE_TENANTS)

    # the counted launches must be exact in every window.  A window whose
    # trace came back short of them (the profiler drops some of a window's
    # device events now and then) is taken again, up to PROFILE_TRIES
    # times; if all are short, the window's device busy ms and ops are
    # not measured (the counter and the answers are checked all the same)
    expected = CELLS_PER_STEP * PROFILED_TICKS
    for _ in range(PROFILE_TRIES):
        before = lstm_cell.launches
        ops = _device_ops(whole, PROFILED_TICKS)
        launched = lstm_cell.launches - before
        cell = [v for k, v in ops.items() if "lstm_cell_kernel" in k]
        cell_n = sum(c for _, c in cell)
        if launched != expected:
            raise AssertionError(f"{PROFILED_TICKS} ticks: {launched} "
                                 f"lstm_cell launches counted, expected "
                                 f"{CELLS_PER_STEP} a tick")
        if cell_n == launched:
            break
        print(f"[service] the profiled window's trace holds {cell_n} of "
              f"{launched} lstm_cell launches: profiled again")
    complete = cell_n == launched
    if not complete:
        print(f"[service] {PROFILED_TICKS} ticks: {launched} lstm_cell "
              f"launches counted, {cell_n} in the trace, in "
              f"{PROFILE_TRIES} profiles: "
              f"the window's device busy ms and ops a tick are not "
              f"measured")
    nb = SERVICE_TENANTS * SERVICE_MAX_JOBS
    bound_ms, bound_by = cell_bound(nb, *PATH_SHAPES[0][1:], 4)
    out.update(
        trace_complete=complete,
        device_busy_ms_per_tick=(sum(t for t, _ in ops.values()) / 1e6
                                 / PROFILED_TICKS if complete else None),
        device_ops_per_tick=(sum(c for _, c in ops.values()) / PROFILED_TICKS
                             if complete else None),
        cell_launches_per_tick=launched / PROFILED_TICKS,
        cell_device_us=(sum(t for t, _ in cell) / cell_n / 1e3 if cell_n
                        else None),
        cell_bound_us=bound_ms * 1e3, cell_bound_by=bound_by, bucket=nb,
        top=[dict(op=k[:80], ms=t / 1e6 / PROFILED_TICKS,
                  calls=c / PROFILED_TICKS)
             for k, (t, c) in sorted(ops.items(),
                                     key=lambda kv: -kv[1][0])[:4]])

    def num(v, fmt):
        return "not measured" if v is None else format(v, fmt)

    print(f"[service] host ms of one tick (32 jobs a tenant): "
          + ", ".join(f"{n} tenants {out[f'tick_ms_{n}']:.3f}"
                      for n in TICK_TENANTS)
          + f"; {SERVICE_TENANTS}-tenant tick (bucket {nb}) under the "
          f"profiler: device "
          f"busy {num(out['device_busy_ms_per_tick'], '.4f')} ms over "
          f"{num(out['device_ops_per_tick'], '.0f')} kernels and copies a "
          f"tick, lstm_cell {out['cell_launches_per_tick']:.0f} launches a "
          f"tick at {num(out['cell_device_us'], '.3f')} us device each "
          f"(bound {out['cell_bound_us']:.4f} us, {bound_by}); top: "
          + "; ".join(f"{t['op']} {t['ms']:.4f} ms x{t['calls']:.0f}"
                      for t in out["top"]) + f" [{CARD}]")
    return out


def service_tcp() -> dict:
    """A ``ServiceDaemon(port=0)`` on the card answering 16
    ``ServiceClient``s, one thread each, each streaming
    ``TCP_SNAPSHOTS`` snapshots (made before the clock starts):
    snapshots/s, round-trip ms percentiles, ticks and tenants per tick."""
    prof = service_profile("milestone")
    streams = service_streams(SERVICE_TENANTS, prefix="tcp")
    snaps = [[s.step()[0] for _ in range(TCP_SNAPSHOTS)] for s in streams]
    rtt = [[] for _ in streams]
    errors: list = []
    start = threading.Barrier(len(streams) + 1, timeout=120)
    with ServiceDaemon(ServiceConfig(prof, device=DEVICE)) as d:
        def run(i):
            try:
                c = d.tcp_client(streams[i].tenant)
                r = c.hello(prof)
                if not r["ok"]:
                    raise AssertionError(r)
                start.wait()
                for snap in snaps[i]:
                    t0 = time.perf_counter()
                    r = c.snapshot(snap)
                    rtt[i].append((time.perf_counter() - t0) * 1e3)
                    if not r["ok"]:
                        raise AssertionError(r)
                c.bye()
            except Exception as e:     # raised again in the main thread
                errors.append(f"{streams[i].tenant}: {e!r}")
                start.abort()

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(streams))]
        for th in threads:
            th.start()
        start.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        st = d.service.stats()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"TCP clients failed: {errors}")
    all_rtt = np.concatenate(rtt)
    n = len(all_rtt)
    if st["snapshots"] != n:
        raise AssertionError(f"{st['snapshots']} snapshots applied of {n}")
    out = dict(snapshots=n, wall_s=wall, snapshots_per_s=n / wall,
               rtt_p50_ms=float(np.percentile(all_rtt, 50)),
               rtt_p99_ms=float(np.percentile(all_rtt, 99)),
               ticks=st["ticks"], tenants_per_tick=n / st["ticks"],
               buckets=st["buckets"])
    print(f"[service] TCP: {len(streams)} clients x {TCP_SNAPSHOTS} "
          f"snapshots in {wall:.3f} s = {out['snapshots_per_s']:.1f} "
          f"snapshots/s, round trip p50 {out['rtt_p50_ms']:.3f} ms p99 "
          f"{out['rtt_p99_ms']:.3f} ms, {st['ticks']} ticks, "
          f"{out['tenants_per_tick']:.2f} tenants a tick [{CARD}]")
    return out


def service_drill(root: Path, store: Path) -> dict:
    """Kill and restart a daemon mid-stream (the JAX package's
    ``test_daemon_kill_restart_mid_stream``, at the paper's width, on the
    card): the daemon serves version 1 of ``store`` (a copy, promoted),
    4 reconnecting clients stream 3 snapshots, the daemon stops, a new one
    binds the same port, and the clients go on with 3 more.  Each
    snapshot is applied exactly once, a resent one is answered from the
    cache, the promoted version serves after the restart, and the last
    answer equals, bit for bit, a predictor of version 1 fed the tenant's
    rows since the restart."""
    prof = service_profile("milestone")
    d = root / "drill"
    shutil.copytree(store, d)
    VersionStore(str(d)).promote(1)
    cfg = ServiceConfig(prof, ckpt_dir=str(d), device=DEVICE)
    streams = service_streams(DRILL_TENANTS, prefix="drill", seed=SEED + 100)
    snaps = [[s.step()[0] for _ in range(DRILL_BEFORE + DRILL_AFTER)]
             for s in streams]
    d1 = ServiceDaemon(cfg).start()
    port = d1.port
    clients = [ServiceClient("127.0.0.1", port, s.tenant, retries=8,
                             backoff_s=0.05) for s in streams]

    def send(i, c, snap):
        r = c.snapshot(snap)
        if not (r["ok"] and r["version"] == 1):
            raise AssertionError(f"{streams[i].tenant} seq {snap['seq']}: "
                                 f"{r}")
        return r

    try:
        for c in clients:
            if not c.hello(prof)["ok"]:
                raise AssertionError("hello refused")
        for k in range(DRILL_BEFORE):
            for i, c in enumerate(clients):
                send(i, c, snaps[i][k])
        applied_1 = d1.service.stats()["snapshots"]
    finally:
        d1.stop()
    d2 = None
    for _ in range(50):                # rebinding the same port
        try:
            d2 = ServiceDaemon(cfg, port=port).start()
            break
        except OSError:
            time.sleep(0.1)
    if d2 is None:
        raise AssertionError("could not rebind the daemon's port")
    try:
        last = None
        for k in range(DRILL_BEFORE, DRILL_BEFORE + DRILL_AFTER):
            for i, c in enumerate(clients):
                r = send(i, c, snaps[i][k])
                last = r if i == 0 else last
        again = clients[0].snapshot(snaps[0][-1])   # a reply "lost"
        st = d2.service.stats()
        for c in clients:
            c.bye()
    finally:
        d2.stop()
    want = (DRILL_TENANTS * DRILL_BEFORE, DRILL_TENANTS * DRILL_AFTER)
    if (applied_1, st["snapshots"]) != want or st["version"] != 1:
        raise AssertionError(f"applied {applied_1} + {st['snapshots']} "
                             f"snapshots, expected {want}; version "
                             f"{st['version']}")
    if not again.get("resent") or again["jobs"] != last["jobs"]:
        raise AssertionError(f"the resent snapshot was not answered from "
                             f"the cache: {again}")
    ref = _drill_reference(prof, d, snaps[0][DRILL_BEFORE:])
    got = np.array([j["e_s"] for j in last["jobs"]])
    if not np.array_equal(got, ref):
        raise AssertionError(f"after the restart E_S {got} != {ref}")
    print(f"[service] kill and restart: {applied_1} + {st['snapshots']} "
          f"snapshots applied once each across the restart, version "
          f"{st['version']} served after it, the resent one answered from "
          f"the cache, the last answer bit-equal to version 1 fed the rows "
          f"since the restart [{CARD}]")
    return dict(applied=[applied_1, st["snapshots"]], version=st["version"])


def _drill_reference(prof, store: Path, snaps: list) -> np.ndarray:
    """E_S of a predictor with the store's version 1, fed ``snaps`` as a
    tenant alone in its ticks is (its own fused step), sanitized as the
    service sanitizes it."""
    pred = StragglerPredictor(n_hosts=prof.n_hosts, max_tasks=prof.max_tasks,
                              k=prof.k, horizon=prof.horizon, device=DEVICE)
    pred.load_params(VersionStore(str(store)).load_version(1, pred.params))
    e_s = q = None
    for snap in snaps:
        pred.push_host_row(np.asarray(snap["m_h"], np.float32))
        m_t = np.stack([np.asarray(j["m_t"], np.float32).reshape(
            prof.max_tasks, features.TASK_FEATURES) for j in snap["jobs"]])
        q = np.array([j["q"] for j in snap["jobs"]], np.float32)
        e_s = pred.predict_interval(m_t, q)
    return STARTController._sanitize_es(e_s, q)


def train_resume(root: Path) -> dict:
    """``repro_torch.launch.train`` killed by ``--kill-at`` (exit 42) and
    resumed with ``--resume``: its losses from the resume step on equal
    an uninterrupted run's bit for bit."""
    full = train_entry.main([*TRAIN_DRILL, "--device", DEVICE])
    argv = [*TRAIN_DRILL, "--device", DEVICE, "--ckpt", str(root / "train")]
    try:
        train_entry.main([*argv, "--kill-at", str(KILL_AT)])
    except SystemExit as e:     # the drill's own exit, the one expected
        code = e.code
    else:
        code = 0
    if code != 42:
        raise AssertionError(f"--kill-at {KILL_AT} exited {code}, not 42")
    resumed = train_entry.main([*argv, "--resume"])
    want = full["losses"][RESUME_AT:]
    diff = max(abs(a - b) for a, b in zip(resumed["losses"], want))
    if resumed["start"] != RESUME_AT or resumed["losses"] != want:
        raise AssertionError(f"resumed at {resumed['start']}: losses "
                             f"{resumed['losses']} vs {want} (largest "
                             f"difference {diff:.3e})")
    print(f"[service] launch.train: killed at step {KILL_AT} (exit 42), "
          f"resumed from step {RESUME_AT}, {len(want)} losses bit-equal to "
          f"an uninterrupted run [{CARD}]")
    return dict(resumed_at=RESUME_AT, losses=len(want), max_diff=diff)


def service_phase() -> dict:
    """Phase 13: the service at the paper's width, both triggers."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="service-", dir=build))
    try:
        out = {trigger: service_trigger(trigger, root)
               for trigger in ("milestone", "per_task")}
        out["timing"] = service_timing()
        out["tcp"] = service_tcp()
        out["drill"] = service_drill(root, root / "milestone-card")
        out["train"] = train_resume(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------- phase 14 --------------------------------
# the training-pod straggler runtime at the paper's width

POD_SLOW, POD_SLOWDOWN = 5, 2.5   # examples/pod_baseline_grid.py's trace
POD_WARM_STEPS, POD_WARM_SEED = 15, 1
POD_IGRU_EPOCHS = 150
POD_PROFILED = ("start-pod-online", "start-pod-service")
POD_PROFILE_AT = 20             # profile steps 20..24: one window, one fit
POD_TCP_STEPS = 50
# start-pod-online's params after one fit (8 Adam steps) from equal
# weights and Adam state, card vs CPU, relative in norm (PR 22 measured
# 7.645e-08 at most over the 40 fits of the phase)
POD_FIT_DRIFT_REL = 1e-6
POD_TRAIN = ["--arch", SSM_ARCH, "--reduced", "--steps", "12",
             "--simulate-stragglers", "--n-hosts", str(PAPER["n_hosts"])]


def pod_trace(steps: int, n_hosts: int, seed: int = 0) -> np.ndarray:
    """(steps, n_hosts) step times, ``examples/pod_baseline_grid.py``'s
    generator: mild Pareto noise and host 5 running 2.5x slow."""
    rng = np.random.default_rng(seed)
    t = 1.0 + 0.05 * rng.pareto(2.0, (steps, n_hosts))
    t[:, POD_SLOW] *= POD_SLOWDOWN
    return t


def pod_config(device: str) -> RuntimeConfig:
    return RuntimeConfig(n_hosts=PAPER["n_hosts"], horizon=PAPER["horizon"],
                         k=PAPER["k"], device=device)


def pod_es_policy(pol):
    """The policy object whose ``_expected_stragglers`` the runtime's
    policy calls (``start-eager`` hands a pod view to its
    ``StartEagerPodPolicy``), or ``None`` for policies without one."""
    if hasattr(pol, "_pod_policy"):
        return pol._pod_policy()
    return pol if hasattr(pol, "_expected_stragglers") else None


def prebuild(rt) -> None:
    """Build an online policy's predictor before the first window (either
    package's), so its weights can be replaced and its ``fit`` timed."""
    if hasattr(rt.policy, "_ensure_predictor"):
        rt.policy._ensure_predictor(rt.cfg)


class PodLog:
    """Steps a pod runtime (either package's) and records what each
    ``decide`` predicted and did: E_S (each ``_expected_stragglers``
    call: the tail fit's or the network's; the service's answer and its
    per-task scores), IGRU-SD's predictions (``preds(pol)``, default the
    port's ``last_preds``), the online policy's epoch losses, and the
    actions.  It also counts the online policy's network predictions and
    ``train_step``s and times its ``fit`` (``timed``)."""

    def __init__(self, rt, preds=None, timed: bool = False):
        self.rt, self.es = rt, []
        pol = rt.policy
        self.name = pol.name
        self.preds = preds or (lambda p: p.last_preds)
        self.responses: list = []
        self.net_predictions = self.train_steps = 0
        self.fit_ms: list[float] = []
        target = pod_es_policy(pol)
        if target is not None:
            inner = target._expected_stragglers

            def es(view):
                v = inner(view)
                self.es.append(v)
                return v

            target._expected_stragglers = es
        if timed and getattr(pol, "predictor", None) is not None:
            fit = pol.predictor.fit

            def timed_fit(*a, **kw):
                out, ms = _synced(lambda: fit(*a, **kw))
                self.fit_ms.append(ms)
                return out

            pol.predictor.fit = timed_fit

    def step(self, times) -> dict:
        pol = self.rt.policy
        self.es = []
        epochs = len(pol.predictor.losses) \
            if getattr(pol, "predictor", None) is not None else 0
        self.rt.observe_step(times)
        acts = self.rt.decide()
        rec = dict(actions=[(str(a.kind), int(a.host), a.backup)
                            for a in acts],
                   es=np.array(self.es, np.float64))
        if self.name == "start-pod-service":
            resp = pol.last_response
            self.responses.append(resp)
            jobs = resp["jobs"] if resp and resp.get("ok") else []
            rec["es"] = np.array([j["e_s"] for j in jobs], np.float64)
            rec["scores"] = [np.array(j["scores"], np.float64)
                             for j in jobs]
        elif self.name == "igru-sd":
            p = self.preds(pol)
            rec["preds"] = None if p is None else np.asarray(p, np.float64)
        if getattr(pol, "predictor", None) is not None:
            rec["losses"] = list(pol.predictor.losses)
            pairs = pol.trained_pairs
            self.train_steps += (len(rec["losses"]) - epochs) \
                * max(1, pairs // 64)
            self.net_predictions += pairs >= pol.min_windows
        return rec


def pod_boundary(ra: dict, rb: dict) -> bool:
    """A step whose decision may rightly flip between two runs that agree
    within the Tier-1 bound: an E_S within the bound of an integer (its
    floor sizes the set), two per-task scores of the service within the
    bound of each other (the top-n cut; exact ties order the same on both),
    or an IGRU-SD prediction within the bound of its 1.5 threshold."""
    def tol(v):
        return TIER1_REL * np.maximum(np.abs(v), TIER1_ABS_FLOOR)

    for r in (ra, rb):
        e = r["es"]
        if len(e) and (np.abs(e - np.round(e)) <= tol(e)).any():
            return True
        for s in r.get("scores", ()):
            d = np.diff(np.sort(s))
            if ((d > 0) & (d <= tol(np.sort(s)[1:]))).any():
                return True
        p = r.get("preds")
        if p is not None and len(p) and (np.abs(p - 1.5) <= tol(1.5)).any():
            return True
    return False


def param_gap(src, dst) -> float:
    """How far ``dst``'s params (a port predictor's) lie from ``src``'s:
    relative, in norm over every leaf."""
    a = [t.detach().double().cpu() for t in convert.leaves(src.params)]
    b = [t.detach().double().cpu() for t in convert.leaves(dst.params)]
    num = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
    return (num / sum(float((x ** 2).sum()) for x in a)) ** 0.5


def sync_predictor(src, dst) -> float:
    """Give ``dst`` (a port predictor) ``src``'s params and Adam state, on
    ``dst``'s device; returns :func:`param_gap` before the copy."""
    rel = param_gap(src, dst)

    def to(tree):
        return convert.tree_map(lambda t: t.detach().to(dst.device).clone(),
                                tree)

    dst.params = to(src.params)
    dst.opt = net.AdamState(step=src.opt.step.detach().to(dst.device)
                            .clone(), mu=to(src.opt.mu), nu=to(src.opt.nu))
    return rel


def es_of_alpha(alpha, q: float, k: float):
    """Eq. 4 in float64 from the tail index alone (beta cancels):
    q * (k*alpha/(alpha-1))^(-alpha)."""
    a = np.asarray(alpha, np.float64)
    return q * (k * a / (a - 1.0)) ** (-a)


def es_condition(alpha, k: float):
    """|d ln E_S / d ln alpha| of Eq. 4: the factor by which E_S magnifies
    a relative error in alpha."""
    a = np.asarray(alpha, np.float64)
    return a * np.abs(1.0 / (a - 1.0) - np.log(k * a / (a - 1.0)))


def pod_lockstep(rt_a, rt_b, trace: np.ndarray, preds=None,
                 timed: bool = False, sync: bool = False) -> dict:
    """Step two pod runtimes of the same policy over ``trace`` and hold
    b's every step against a's: E_S (and the service's scores, IGRU-SD's
    predictions) within the Tier-1 bound, the online policy's epoch
    losses within ``TRAIN_REL``, and the actions equal; a difference in
    the actions is allowed only at a boundary step (:func:`pod_boundary`),
    and the runs part there (a runs on alone).  Runs that never part must
    end with equal ``summary()``s.  ``preds`` gives run a's IGRU-SD
    predictions (default: the port's ``last_preds``).  With ``sync`` (two
    port runtimes), b's online predictor takes a's params and Adam state
    after every fit, once its losses were held, so every fit and
    prediction starts from the same weights (``fit_drift``: how far b's
    params lay from a's after each fit, within ``POD_FIT_DRIFT_REL``)."""
    log_a = PodLog(rt_a, preds, timed=timed)
    log_b = PodLog(rt_b)
    worst = worst_loss = 0.0
    boundary, parted, step_ms, acted, fit_drift = [], None, [], 0, []
    synced = 0
    for t, times in enumerate(trace):
        t0 = time.perf_counter()
        ra = log_a.step(times)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if parted is not None:
            continue
        rb = log_b.step(times)
        if len(ra["es"]) != len(rb["es"]):
            raise AssertionError(f"step {t}: {len(ra['es'])} and "
                                 f"{len(rb['es'])} E_S predictions")
        worst = max(worst, es_drift(t, ra["es"], rb["es"]))
        for sa, sb in zip(ra.get("scores", ()), rb.get("scores", ())):
            worst = max(worst, es_drift(t, sa, sb, "per-task score"))
        if ra.get("preds") is not None and rb.get("preds") is not None:
            if ra["preds"].shape != rb["preds"].shape:
                raise AssertionError(f"step {t}: IGRU-SD predicted for "
                                     f"{len(ra['preds'])} and "
                                     f"{len(rb['preds'])} tasks")
            worst = max(worst, es_drift(t, ra["preds"], rb["preds"],
                                        "IGRU-SD prediction"))
        la, lb = ra.get("losses", []), rb.get("losses", [])
        if len(la) != len(lb):
            raise AssertionError(f"step {t}: {len(la)} and {len(lb)} epochs")
        for a, b in zip(la, lb):
            rel = abs(a - b) / max(abs(b), 1e-30)
            if not np.isfinite(a) or rel > TRAIN_REL:
                raise AssertionError(f"step {t}: epoch loss {a} vs {b} "
                                     f"(rel {rel:.3e} > {TRAIN_REL})")
            worst_loss = max(worst_loss, rel)
        if sync and len(la) != synced:
            synced = len(la)
            fit_drift.append(sync_predictor(rt_a.policy.predictor,
                                            rt_b.policy.predictor))
            if not fit_drift[-1] <= POD_FIT_DRIFT_REL:
                raise AssertionError(
                    f"step {t}: params {fit_drift[-1]:.3e} apart after a fit "
                    f"from equal weights (> {POD_FIT_DRIFT_REL})")
        edge = pod_boundary(ra, rb)
        if edge:
            boundary.append(t)
        acted += len(ra["actions"])
        if ra["actions"] != rb["actions"]:
            if not edge:
                raise AssertionError(
                    f"step {t}: actions {ra['actions']} and "
                    f"{rb['actions']} differ away from any decision "
                    f"boundary")
            parted = t
    sa, sb = rt_a.summary(), rt_b.summary()
    if parted is None and sa != sb:
        raise AssertionError(f"summaries differ: {sa} vs {sb}")
    return dict(steps=len(trace) if parted is None else parted + 1,
                parted_at=parted, boundary_steps=boundary, max_rel=worst,
                max_loss_rel=worst_loss, actions=acted, summary=sa,
                fit_drift=fit_drift,
                net_predictions=log_a.net_predictions,
                train_steps=log_a.train_steps, fit_ms=log_a.fit_ms,
                responses=log_a.responses, step_ms=step_ms)


def pod_online_drift(trace: np.ndarray) -> dict:
    """``start-pod-online`` on the card and on the CPU from equal initial
    weights, each training on its own (no weight sync).  Measures how the
    two runs' rounding differences grow through 320 Adam steps: the
    params' gap after each fit, and at each network prediction the
    relative gaps in E_S and in alpha beside E_S's condition number in
    alpha (:func:`es_condition`; beta cancels from Eq. 4), so a spike in
    the E_S gap reads as alpha's gap magnified, or not.  The gate is the
    synced lockstep's; this run fails only if the actions differ at a step
    where the two E_S do not lie on either side of an integer (the backup
    set is floor(E_S) hosts, the evictions follow the trace alone)."""
    runs = [StragglerRuntime(pod_config(dev), policy=registry.make(
        "start-pod-online")) for dev in (DEVICE, "cpu")]
    for rt in runs:
        prebuild(rt)
    start_gap = sync_predictor(runs[0].policy.predictor,
                               runs[1].policy.predictor)
    heads = ([], [])
    for rt, head in zip(runs, heads):
        pred = rt.policy.predictor
        inner = pred.predict_features

        def record(*a, inner=inner, head=head, **kw):
            out = inner(*a, **kw)
            head.append((float(out.alpha[0]), float(out.e_s[0])))
            return out

        pred.predict_features = record
    logs = [PodLog(rt) for rt in runs]
    n, k = PAPER["n_hosts"], PAPER["k"]
    per_window, parted, first_past, fit_gap, steps = [], None, None, [], []
    fits = 0
    for t, times in enumerate(trace):
        made = len(heads[0])
        ra, rb = (log.step(times) for log in logs)
        if len(ra["losses"]) != fits:
            fits = len(ra["losses"])
            fit_gap.append(param_gap(runs[0].policy.predictor,
                                     runs[1].policy.predictor))
        rel = float((np.abs(ra["es"] - rb["es"]) / np.maximum(
            np.abs(rb["es"]), TIER1_ABS_FLOOR)).max()) if len(ra["es"]) \
            else 0.0
        w = t // PAPER["horizon"]
        if w == len(per_window):
            per_window.append(0.0)
        per_window[w] = max(per_window[w], rel)
        if first_past is None and rel > TIER1_REL:
            first_past = t
        if len(heads[0]) > made:
            (aa, ea), (ab, eb) = heads[0][-1], heads[1][-1]
            kappa = float(es_condition(ab, k))
            steps.append(dict(
                step=t, es_gap=abs(ea - eb) / max(abs(eb), TIER1_ABS_FLOOR),
                alpha=ab, alpha_gap=abs(aa - ab) / abs(ab), kappa=kappa,
                own=max(abs(e - float(es_of_alpha(a, n, k)))
                        / max(float(es_of_alpha(a, n, k)), TIER1_ABS_FLOOR)
                        for a, e in ((aa, ea), (ab, eb))),
                fit_gap=fit_gap[-1]))
        if ra["actions"] != rb["actions"]:
            straddle = (np.floor(ra["es"]) != np.floor(rb["es"])).any() \
                if len(ra["es"]) == len(rb["es"]) else False
            if not straddle:
                raise AssertionError(
                    f"free-running step {t}: actions {ra['actions']} and "
                    f"{rb['actions']} differ, E_S {ra['es']} and {rb['es']} "
                    f"on the same side of every integer")
            parted = t
            break
    spikes = [s for s in steps if s["es_gap"] > TIER1_REL]
    return dict(per_window=per_window, first_past_tier1=first_past,
                parted_at=parted, start_gap=start_gap, fit_gap=fit_gap,
                spikes=spikes,
                max_alpha_gap=max((s["alpha_gap"] for s in steps),
                                  default=0.0),
                max_own=max((s["own"] for s in steps), default=0.0),
                explained=[s["es_gap"] / max(s["kappa"] * s["alpha_gap"],
                                             1e-30) for s in spikes])


def pod_igru(trace_warm: np.ndarray) -> tuple[dict, float]:
    """IGRU-SD fitted on the card by ``pretrain_igru_pod`` on a 15-step
    warm run (seed 1, 150 epochs), as ``examples/pod_baseline_grid.py``
    fits it: the trained params (on the card) and the fit's host ms."""
    warm = StragglerRuntime(pod_config(DEVICE))
    for times in trace_warm:
        warm.observe_step(times)
    tech = baselines.IGRUSD(seed=0, device=DEVICE)
    _, ms = _synced(lambda: pretrain_igru_pod(tech, warm,
                                              epochs=POD_IGRU_EPOCHS))
    if not all(torch.isfinite(t).all() for t in convert.leaves(tech.params)):
        raise AssertionError("IGRU-SD's pod pretraining: params not finite")
    return tech.params, ms


def pod_policy(name: str, device: str, igru_params=None):
    """A fresh policy of ``name``; IGRU-SD holds a copy of ``igru_params``
    on ``device`` (the others take the runtime's device)."""
    if name == "igru-sd":
        tech = baselines.IGRUSD(seed=0, device=device)
        tech.params = convert.tree_map(lambda t: t.detach().to(device)
                                       .clone(), igru_params)
        return tech
    return registry.make(name)


def pod_profile(name: str, trace: np.ndarray) -> dict:
    """A card run of ``name`` up to step ``POD_PROFILE_AT``, then one
    window of ``horizon`` steps (one fit for the online policy, one
    prediction a step) under the profiler: device busy ms and ops per
    step, and the cell's device time per launch."""
    rt = StragglerRuntime(pod_config(DEVICE), policy=registry.make(name))
    for times in trace[:POD_PROFILE_AT]:
        rt.observe_step(times)
        rt.decide()
    steps = iter(trace[POD_PROFILE_AT:])
    reps = PAPER["horizon"]

    def step():
        rt.observe_step(next(steps))
        rt.decide()

    ops = _device_ops(step, reps)
    cell = [v for k, v in ops.items() if "lstm_cell_kernel" in k]
    return dict(busy_ms=sum(v[0] for v in ops.values()) / reps / 1e6,
                ops=sum(v[1] for v in ops.values()) / reps,
                cell_launches=sum(c for _, c in cell),
                cell_device_us=(sum(t for t, _ in cell)
                                / max(1, sum(c for _, c in cell)) / 1e3))


def pod_tcp(trace: np.ndarray, responses: list) -> dict:
    """``start-pod-service`` against a port ``ServiceDaemon`` on
    localhost through a ``ServiceClient``, on the card, for the first
    ``POD_TCP_STEPS`` steps: every answer equal to the in-process card
    run's (``responses``): the same actions, E_S and scores within the
    Tier-1 bound (counted where bit-equal)."""
    cfg = pod_config(DEVICE)
    prof = Profile(n_hosts=cfg.n_hosts, max_tasks=cfg.n_hosts,
                   horizon=cfg.horizon, k=cfg.k, trigger="per_task",
                   hysteresis=2, cooldown=5)
    worst, equal, ms = 0.0, 0, []
    with ServiceDaemon(ServiceConfig(profile=prof, device=DEVICE),
                       port=0) as d:
        client = d.tcp_client("pod0")
        try:
            rt = StragglerRuntime(cfg, policy=ServiceBackedPodPolicy(
                client=client))
            for t, times in enumerate(trace[:POD_TCP_STEPS]):
                t0 = time.perf_counter()
                rt.observe_step(times)
                rt.decide()
                ms.append((time.perf_counter() - t0) * 1e3)
                got = rt.policy.last_response
                want = responses[t]
                if not got.get("ok") or not want.get("ok"):
                    raise AssertionError(f"step {t}: answers {got}, {want}")
                for jg, jw in zip(got["jobs"], want["jobs"], strict=True):
                    if jg["actions"] != jw["actions"]:
                        raise AssertionError(f"step {t}: TCP actions "
                                             f"{jg['actions']} vs in-process "
                                             f"{jw['actions']}")
                    worst = max(worst, es_drift(t, np.array([jg["e_s"]]),
                                                np.array([jw["e_s"]])),
                                es_drift(t, np.array(jg["scores"]),
                                         np.array(jw["scores"]),
                                         "per-task score"))
                    equal += jg["e_s"] == jw["e_s"] \
                        and jg["scores"] == jw["scores"]
        finally:
            client.close()
    return dict(steps=POD_TCP_STEPS, max_rel=worst, bit_equal=equal,
                ms_per_step=float(np.median(ms)),
                summary=rt.summary())


def recording_runtime(base) -> tuple[type, list]:
    """A subclass of ``base`` (either package's ``StragglerRuntime``)
    recording E_S after every ``decide``, and the list each runtime it
    builds is appended to."""
    made = []

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.es: list[float] = []
            made.append(self)

        def decide(self):
            acts = super().decide()
            self.es.append(self.expected_stragglers())
            return acts

    return Recorded, made


def pod_train() -> dict:
    """``repro_torch.launch.train --simulate-stragglers --n-hosts 400`` on
    the card and with ``--device cpu``: the ``[start-runtime]`` lines
    equal, the runtime's summaries equal and its E_S within the Tier-1
    bound every step."""
    runs = {}
    saved = train_entry.StragglerRuntime
    try:
        for dev in (DEVICE, "cpu"):
            train_entry.StragglerRuntime, made = recording_runtime(saved)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = train_entry.main([*POD_TRAIN, "--device", dev])
            rt, = made
            runs[dev] = dict(
                lines=[ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("[start-runtime]")],
                es=np.array(rt.es), summary=rt.summary(), out=out,
                device=rt.cfg.device)
    finally:
        train_entry.StragglerRuntime = saved
    a, b = runs[DEVICE], runs["cpu"]
    if a["device"] != DEVICE or not np.isfinite(a["out"]["losses"]).all():
        raise AssertionError(f"launch.train on {a['device']}: {a['out']}")
    if a["lines"] != b["lines"] or a["summary"] != b["summary"]:
        raise AssertionError(f"launch.train's runtime: {a['lines']} "
                             f"{a['summary']} vs {b['lines']} {b['summary']}")
    rel = es_drift(0, a["es"], b["es"])
    print(f"[pod] launch.train --simulate-stragglers --n-hosts "
          f"{PAPER['n_hosts']}: {len(a['lines'])} [start-runtime] lines and "
          f"the summary equal to --device cpu's ({a['summary']}), E_S over "
          f"{len(a['es'])} steps within {rel:.3e} (max E_S "
          f"{a['es'].max():.3e})")
    return dict(lines=a["lines"], summary=a["summary"], max_rel=rel,
                steps=len(a["es"]))


def pod_phase() -> dict:
    """Phase 14: every pod policy on a 400-host runtime on the card, each
    in lockstep with a CPU twin over 200 steps of one trace."""
    n_hosts = PAPER["n_hosts"]
    trace = pod_trace(POD_STEPS, n_hosts)
    igru, igru_ms = pod_igru(pod_trace(POD_WARM_STEPS, n_hosts,
                                       seed=POD_WARM_SEED))
    print(f"[pod] IGRU-SD fitted on a {POD_WARM_STEPS}-step warm run "
          f"({POD_IGRU_EPOCHS} epochs) on the card in {igru_ms:.1f} ms")
    names = registry.names("pod")
    if len(names) != 10:
        raise AssertionError(f"pod policies registered: {names}")
    out = {"names": names, "igru_pretrain_ms": igru_ms}
    for name in names:
        rt_a = StragglerRuntime(pod_config(DEVICE),
                                policy=pod_policy(name, DEVICE, igru))
        rt_b = StragglerRuntime(pod_config("cpu"),
                                policy=pod_policy(name, "cpu", igru))
        prebuild(rt_a)
        prebuild(rt_b)
        lstm_cell.launches = 0
        r = pod_lockstep(rt_a, rt_b, trace, timed=True,
                         sync=name == "start-pod-online")
        launches = lstm_cell.launches
        if name == "start-pod-online":
            want = CELLS_PER_STEP * (r["net_predictions"]
                                     + r["train_steps"])
        elif name == "start-pod-service":
            want = CELLS_PER_STEP * sum(bool(x and x.get("ok"))
                                        for x in r["responses"])
        else:
            want = 0
        if launches != want or (name in POD_PROFILED and not launches):
            raise AssertionError(f"{name}: {launches} lstm_cell launches, "
                                 f"expected {want}")
        ms = r.pop("step_ms")
        bar = rt_a.sync_barrier_s
        row = dict(r, launches=launches,
                   host_ms_median=float(np.median(ms[1:])),
                   host_ms_mean=float(np.mean(ms[1:])),
                   barrier_mean_s=float(np.mean(bar)),
                   barrier_p95_s=float(np.percentile(bar, 95)))
        row.pop("responses")
        if name == "start-pod-service":
            out["tcp"] = pod_tcp(trace, r["responses"])
        if name in POD_PROFILED:
            row["profile"] = pod_profile(name, trace)
        if name == "start-pod-online":
            row["free_running"] = d = pod_online_drift(trace)
            g = d["fit_gap"]
            print(f"[pod] start-pod-online free-running (no weight sync): "
                  f"E_S drift per window {[f'{x:.1e}' for x in d['per_window']]}"
                  f", past Tier-1 from step {d['first_past_tier1']}, actions "
                  f"part at {d['parted_at']}; params apart at the start "
                  f"{d['start_gap']:.3e}, after fits 1/5/10/20/30/{len(g)}: "
                  f"{[f'{g[i - 1]:.3e}' for i in (1, 5, 10, 20, 30, len(g)) if i <= len(g)]}"
                  f"; alpha gap at most {d['max_alpha_gap']:.3e}; E_S vs "
                  f"Eq. 4 of its own alpha (float64) within "
                  f"{d['max_own']:.3e} on both devices")
            for sp in d["spikes"]:
                print(f"[pod]   spike step {sp['step']}: E_S gap "
                      f"{sp['es_gap']:.3e}, alpha {sp['alpha']:.4f} gap "
                      f"{sp['alpha_gap']:.3e} x condition {sp['kappa']:.2f}"
                      f" = {sp['kappa'] * sp['alpha_gap']:.3e}, params "
                      f"{sp['fit_gap']:.3e} apart")
        fit = (f"; fit {np.median(r['fit_ms']):.2f} ms median per window "
               f"over {len(r['fit_ms'])} windows ({r['train_steps']} "
               f"train_steps), params {max(r['fit_drift']):.2e} apart "
               f"after a fit at most" if r["fit_ms"] else "")
        prof = (f"; device busy {row['profile']['busy_ms']:.4f} ms over "
                f"{row['profile']['ops']:.1f} ops per step, the cell "
                f"{row['profile']['cell_device_us']:.3f} us a launch"
                if "profile" in row else "")
        print(f"[pod] {name}: card vs cpu over {r['steps']} of "
              f"{len(trace)} steps (parted at {r['parted_at']}, boundary "
              f"steps {r['boundary_steps'][:5]}), max rel "
              f"{r['max_rel']:.3e} (losses {r['max_loss_rel']:.3e}); "
              f"{r['summary']['backup_shards']} backups, "
              f"{r['summary']['evictions']} evictions "
              f"{r['summary']['evicted_hosts']}, sync barrier mean "
              f"{row['barrier_mean_s']:.4f} p95 {row['barrier_p95_s']:.4f} s; "
              f"lstm_cell launches {launches}; host "
              f"{row['host_ms_median']:.3f} ms median / "
              f"{row['host_ms_mean']:.3f} mean per step{fit}{prof} [{CARD}]")
        out[name] = row
    tcp = out["tcp"]
    print(f"[pod] start-pod-service over TCP: {tcp['steps']} answers equal "
          f"to the in-process run's (max rel {tcp['max_rel']:.3e}, "
          f"{tcp['bit_equal']} bit-equal), {tcp['ms_per_step']:.3f} ms per "
          f"step [{CARD}]")
    out["train"] = pod_train()
    return out


# --------------------------------- main ------------------------------------

# -------------------------------- phase 14b --------------------------------

DIST_ARCH = LM_ARCH                 # yi-6b at full width
DIST_LAYERS = DENSE_GATE_LAYERS     # the fp32 training gate's depth
DIST_STEPS = 3
DIST_FRAC = 0.01                    # EF-top-k's kept share
DIST_ROUNDS = 3                     # error-feedback rounds
DIST_TWIN = ("embed", "g0.attn.wq")  # leaves held against the CPU twin
DIST_DRYRUN = ("yi-6b", "deepseek-v3-671b")


@contextlib.contextmanager
def one_rank_group(root: Path):
    """A one-process NCCL group (rendezvous through a ``FileStore`` under
    ``root``: no port) and a gloo group of the same process, for the CPU
    twin's collectives.  One card holds one rank: NCCL puts no two ranks
    on one GPU, so the multi-rank paths are held on the CPU's gloo ranks
    (``tests/test_torch_mesh_train.py`` and the others)."""
    import torch.distributed as dist
    card = DEVICE == "cuda"
    dist.init_process_group(
        "nccl" if card else "gloo", store=dist.FileStore(
            str(root / "store"), 1), rank=0, world_size=1,
        **(dict(device_id=torch.device("cuda", 0)) if card else {}))
    try:
        yield dist.new_group(backend="gloo")
    finally:
        dist.destroy_process_group()


def _leaf(tree, dotted: str):
    for key in dotted.split("."):
        tree = tree[key]
    return tree


def mesh_train_gate() -> tuple:
    """``Trainer(model, mesh)`` on a (1, 1) NCCL mesh, yi-6b at full width
    and the fp32 gate's depth: ``DIST_STEPS`` steps with the launch
    counts set to 0 just before and read just after (the flash kernel
    twice per layer per step, under the mesh path); then the unsharded
    ``make_train_step`` from a copy of the same params on the card, every
    loss and param bit-equal (at one rank each collective is a copy).
    Returns the record, the unsharded run's final params, the batches and
    the model."""
    cfg, model, _ = _trainer(DIST_ARCH, DIST_LAYERS, "float32")
    mesh = make_host_mesh(1, 1, device_type=DEVICE)
    tr = Trainer(model, mesh, opt_cfg=Opt.OptConfig(**LM_OPT),
                 device=DEVICE)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=LM_GATE_SEQ,
                                  global_batch=LM_GATE_BATCH), device=DEVICE)
    batches = [data.batch(i) for i in range(DIST_STEPS)]
    params = model.init(SEED, DEVICE)
    plain_params = convert.tree_map(lambda t: t.clone(), params)
    p, s = tr.shard_state(params)
    del params
    step = tr.compile_step()
    torch.cuda.synchronize()
    reset_launches()
    losses, mesh_ms = [], []
    for b in batches:
        (p, s, m), ms = _synced(lambda b=b: step(p, s, b))
        losses.append(float(m["loss"]))
        mesh_ms.append(ms)
    launches = kernel_launches()
    want = train_launches(cfg, DIST_STEPS)
    mesh_params = Sh.full_tree(p)
    del s
    free_cuda()
    plain = make_train_step(model, tr.opt_cfg, tr.tcfg)
    ps = Opt.init(tr.opt_cfg, plain_params)
    plain_losses, plain_ms = [], []
    for b in batches:
        (plain_params, ps, m), ms = _synced(
            lambda b=b: plain(plain_params, ps, b))
        plain_losses.append(float(m["loss"]))
        plain_ms.append(ms)
    equal = all(torch.equal(a, b) for a, b in zip(
        convert.leaves(mesh_params), convert.leaves(plain_params)))
    del ps, mesh_params
    free_cuda()
    print(f"[dist] {cfg.name} fp32, {cfg.n_layers} layers "
          f"({cfg.param_count() / 1e9:.3f} B params), batches "
          f"{LM_GATE_BATCH} x {LM_GATE_SEQ}, (1, 1) "
          f"{'NCCL' if DEVICE == 'cuda' else 'gloo'} mesh: losses "
          f"{losses}, unsharded {plain_losses}; params bit-equal {equal}; "
          f"host ms per step {[f'{x:.1f}' for x in mesh_ms]} against "
          f"{[f'{x:.1f}' for x in plain_ms]} unsharded; launches "
          f"{ {k: v for k, v in launches.items() if v} } (2 x "
          f"{DIST_LAYERS} layers x {DIST_STEPS} steps of flash); {CARD}")
    if launches != want:
        raise AssertionError(f"mesh path launches {launches}, expected "
                             f"{want}")
    if losses != plain_losses or not equal:
        raise AssertionError("the (1, 1) mesh step differs from the "
                             "unsharded step")
    if not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    return dict(n_layers=cfg.n_layers, batch=LM_GATE_BATCH,
                seq=LM_GATE_SEQ, losses=losses, plain_losses=plain_losses,
                bit_equal=equal, mesh_ms=mesh_ms, plain_ms=plain_ms,
                launches=launches, card=CARD), plain_params, batches, model


def compression_phase(params, batch, model, cpu_group) -> dict:
    """EF-int8 and EF-top-k (``DIST_FRAC``) of the step's whole gradient
    tree on the card (the NCCL group), ``DIST_ROUNDS`` error-feedback
    rounds each, timed per tree; the ``DIST_TWIN`` leaves in lockstep on
    the CPU (the gloo group): every round's reduced value and residual
    bit-equal, and top-k's kept index set equal."""
    from repro_torch.distributed import compression as C
    _, grads = value_and_grad(model, params, batch)
    n = sum(g.numel() for g in convert.leaves(grads))
    twin_g = {k: _leaf(grads, k).cpu() for k in DIST_TWIN}
    at = [[".".join(p) for p in Sh.leaf_paths(grads)].index(k)
          for k in sorted(DIST_TWIN)]
    out = {}
    for scheme in ("int8", "topk"):
        res = C.zero_residual(grads)
        twin_r = C.zero_residual(twin_g)
        rounds_ms, equal, kept = [], [], []
        for _ in range(DIST_ROUNDS):
            if scheme == "int8":
                (red, res), ms = _synced(
                    lambda res=res: C.ef_int8_reduce(grads, res))
                twin_red, twin_r = C.ef_int8_reduce(twin_g, twin_r,
                                                    cpu_group)
            else:
                i_card, i_cpu = [], []
                (red, res), ms = _synced(lambda res=res: C.ef_topk_reduce(
                    grads, res, frac=DIST_FRAC, kept=i_card))
                twin_red, twin_r = C.ef_topk_reduce(
                    twin_g, twin_r, cpu_group, DIST_FRAC, kept=i_cpu)
                kept += [torch.equal(i_card[i].cpu(), j)
                         for i, j in zip(at, i_cpu)]
                del i_card
            rounds_ms.append(ms)
            for k in DIST_TWIN:
                equal.append(torch.equal(_leaf(red, k).cpu(), twin_red[k])
                             and torch.equal(_leaf(res, k).cpu(),
                                             twin_r[k]))
            del red
        payload = n if scheme == "int8" else sum(
            max(1, int(g.numel() * DIST_FRAC)) * (4 + 8)
            for g in convert.leaves(grads))
        out[scheme] = dict(ms_per_tree=rounds_ms, bit_equal=all(equal),
                           kept_equal=all(kept) if kept else None,
                           payload_bytes=payload, fp32_bytes=4 * n)
        print(f"[dist] EF-{scheme} of the gradient tree ({n / 1e9:.3f} B "
              f"fp32 values, {len(convert.leaves(grads))} leaves), "
              f"{DIST_ROUNDS} rounds: ms per tree "
              f"{[f'{x:.2f}' for x in rounds_ms]}; {DIST_TWIN} reduced "
              f"values and residuals bit-equal to the CPU twin "
              f"{all(equal)}" + (f", kept index sets equal {all(kept)}"
                                  if kept else "")
              + f"; payload {payload} bytes against {4 * n} in fp32 "
              f"({payload / (4 * n):.4f}; "
              + ("int8 values, summed as int32 on the wire here, as JAX's "
                 "psum" if scheme == "int8" else
                 "fp32 values and int64 indices, reduced here as the "
                 "dense sum, as JAX's") + f"); {CARD}")
        del res
        free_cuda()
        if not all(equal) or (kept and not all(kept)):
            raise AssertionError(f"EF-{scheme} differs from the CPU twin")
    del grads
    free_cuda()
    return out


def elastic_round_trip(params, root: Path) -> dict:
    """The params sharded on a (1, 1) mesh, saved; then restored onto a
    fresh (1, 1) mesh through ``restore(..., mesh=, specs=)`` and moved
    there by ``reshard``: every value equal."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import elastic
    from repro_torch.train import checkpoint as ckpt
    mesh = make_host_mesh(1, 1, device_type=DEVICE)
    sharded = Sh.shard_tree(params, Sh.param_specs(params, mesh), mesh)
    (_, save_ms) = _synced(lambda: ckpt.save(str(root / "ckpt"), 1,
                                             sharded))
    fresh = DeviceMesh(DEVICE, torch.tensor([[0]]),
                       mesh_dim_names=("data", "model"))
    (back, restore_ms) = _synced(lambda: ckpt.restore(
        str(root / "ckpt"), 1, params, mesh=fresh,
        specs=Sh.param_specs(params, fresh)))
    restored = all(torch.equal(a.full_tensor(), b) for a, b in zip(
        convert.leaves(back), convert.leaves(params)))
    del back
    st = elastic.remesh(elastic.ElasticState(mesh=mesh), [])
    moved = elastic.reshard(sharded, mesh, st.mesh,
                            lambda t, m: Sh.param_specs(t, m))
    resharded = all(torch.equal(a.full_tensor(), b) for a, b in zip(
        convert.leaves(moved), convert.leaves(params)))
    del moved, sharded
    free_cuda()
    print(f"[dist] elastic round trip: saved in {save_ms:.0f} ms, "
          f"restored onto a fresh (1, 1) mesh in {restore_ms:.0f} ms (a "
          f"warm read), values equal {restored}; remesh generation "
          f"{st.generation}, reshard values equal {resharded}")
    if not (restored and resharded):
        raise AssertionError("the elastic round trip changed values")
    return dict(save_ms=save_ms, restore_ms=restore_ms, restored=restored,
                resharded=resharded)


def start_dryrun(root: Path) -> tuple[subprocess.Popen, Path]:
    """``python -m repro_torch.launch.dryrun`` for ``DIST_DRYRUN`` at
    train_4k on both meshes, started in the background (host work on
    the meta device; it never touches the card)."""
    out = root / "dryrun"
    cmd = [sys.executable, "-c",
           "import sys; from repro_torch.launch import dryrun; "
           "[dryrun.main(['--arch', a, '--shape', 'train_4k', '--mesh', "
           "'both', '--out', sys.argv[1]]) for a in sys.argv[2:]]",
           str(out), *DIST_DRYRUN]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent / "src"),
         os.environ.get("PYTHONPATH", "")]), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish_dryrun(proc: subprocess.Popen, out: Path) -> dict:
    text, _ = proc.communicate(timeout=300)
    if proc.returncode:
        raise AssertionError(f"the dry run failed:\n{text[-3000:]}")
    recs = {}
    for f in sorted(out.glob("*.json")):
        rec = json.loads(f.read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {f.name}: {rec}")
        recs[f.stem] = {k: rec[k] for k in (
            "optimizer", "n_micro", "fsdp", "layout", "per_device",
            "flops_per_device", "remat_flops_per_device",
            "collective_bytes_per_device", "plan_s")}
        pd = rec["per_device"]
        print(f"[dist] dry run {f.stem}: {rec['layout']}, "
              f"{rec['optimizer']}, n_micro {rec['n_micro']}, fsdp "
              f"{rec['fsdp']}; per device params "
              f"{pd['param_bytes'] / 2**30:.3f} GiB, optimizer state "
              f"{pd['opt_state_bytes'] / 2**30:.3f} GiB, batch "
              f"{pd['batch_bytes']} B, FLOPs "
              f"{rec['flops_per_device']:.4e} (+ recompute "
              f"{rec['remat_flops_per_device']:.4e}), collectives "
              f"{rec['collective_bytes_per_device']['total']:.4e} B; "
              f"{rec['plan_s']:.1f} s on the host")
    if len(recs) != 2 * len(DIST_DRYRUN):
        raise AssertionError(f"dry run records {sorted(recs)}")
    return recs


def distribution_phase() -> dict:
    """Phase 14b: the mesh trainer, compression, the elastic round trip
    and the dry run (see the module docstring)."""
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        proc, out = start_dryrun(root)
        try:
            with one_rank_group(root) as cpu_group:
                gate, params, batches, model = mesh_train_gate()
                comp = compression_phase(params, batches[0], model,
                                         cpu_group)
                elastic_rec = elastic_round_trip(params, root)
                del params
                free_cuda()
            dry = finish_dryrun(proc, out)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return dict(mesh_train=gate, compression=comp, elastic=elastic_rec,
                dryrun=dry)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s wall")


def main() -> None:
    global CARD
    t_start = time.perf_counter()
    smi = CARD = environment()
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
        scan_state = check_scan_with_state()
        flash_grad = check_flash_grad()
        router_grad = check_router_grad()
        free_cuda()

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
    with phase("captured programs"):
        graphs = graphs_phase(n_hosts, max_tasks)

    with phase("START training and simulation"):
        xs, ys = start_warmup()
        start_gate = start_train_gate(xs, ys)
        trained, start_timing = start_train_timing(xs, ys)
        start_sims = start_simulation(trained)

    with phase("paper comparison"):
        igru_gate = igru_train_gate()
        igru_sims = igru_lockstep()
        grid = paper_grid()
        parity, parity_serial = sweep_parity()
    with phase("fabric"):
        fabric_stats = fabric_phase(parity_serial, parity)

    with phase(f"{LM_ARCH} fp32 gate"):
        gate = lm_gate(LM_ARCH)
    with phase(f"{LM_ARCH} bf16 timing and serve"):
        timing = lm_timing(LM_ARCH)
        served = serve_entry.main(["--arch", LM_ARCH, "--device", "cuda"])
        free_cuda()
    with phase(f"{MOE_ARCH} fp32 gate ({MOE_GATE_LAYERS} layers)"):
        moe_gate = lm_gate(MOE_ARCH, MOE_GATE_LAYERS)
    with phase(f"{MOE_ARCH} bf16 timing ({MOE_SERVE_LAYERS} layers) and "
               f"serve"):
        moe_timing = lm_timing(MOE_ARCH, MOE_SERVE_LAYERS)
        moe_served = serve_entry.main(["--arch", MOE_ARCH, "--device",
                                       "cuda"])
        free_cuda()
    with phase(f"{SSM_ARCH} fp32 training gate ({SSM_GATE_LAYERS} layers)"):
        ssm_fp32 = train_gate(SSM_ARCH, SSM_GATE_LAYERS, SSM_GATE_BATCH,
                              SSM_GATE_SEQ)
        free_cuda()
    with phase(f"{SSM_ARCH} bf16 training ({SSM_LAYERS} layers) and train"):
        ssm_bf16 = train_timing(SSM_ARCH, SSM_LAYERS, SSM_BATCH, SSM_SEQ,
                                plain_curve=False)
        trained = train_entry.main(["--arch", SSM_ARCH, "--reduced",
                                    "--steps", "5", "--device", "cuda"])
        if not np.isfinite([trained["first_loss"], trained["last_loss"]]
                           ).all():
            raise AssertionError(f"launch.train: {trained}")
        free_cuda()
    with phase(f"{SSM_ARCH} fp32 serving gate ({SSM_SERVE_LAYERS} layers)"):
        ssm_serve_gate = lm_gate(SSM_ARCH, SSM_SERVE_LAYERS)
    with phase(f"{SSM_ARCH} bf16 timing ({SSM_SERVE_LAYERS} layers) and "
               f"serve"):
        ssm_serve_timing = lm_timing(SSM_ARCH, SSM_SERVE_LAYERS)
        ssm_served = serve_entry.main(["--arch", SSM_ARCH, "--device",
                                       "cuda"])
        free_cuda()
    with phase(f"{LM_ARCH} fp32 training gate ({DENSE_GATE_LAYERS} layers)"):
        dense_fp32 = train_gate(LM_ARCH, DENSE_GATE_LAYERS, LM_GATE_BATCH,
                                LM_GATE_SEQ)
        free_cuda()
    with phase(f"{LM_ARCH} bf16 training ({DENSE_LAYERS} layers) and "
               f"train"):
        dense_bf16 = train_timing(LM_ARCH, DENSE_LAYERS, LM_BATCH, LM_SEQ,
                                  plain_curve=True)
        # launch.train's default arch, demo-100m, at its full size
        demo = train_entry.main(["--steps", "5", "--device", "cuda"])
        if not np.isfinite([demo["first_loss"], demo["last_loss"]]).all():
            raise AssertionError(f"launch.train: {demo}")
        free_cuda()
    with phase(f"{MOE_ARCH} fp32 training gate ({MOE_TRAIN_GATE_LAYERS} "
               f"layers)"):
        moe_fp32 = train_gate(MOE_ARCH, MOE_TRAIN_GATE_LAYERS,
                              LM_GATE_BATCH, LM_GATE_SEQ)
        free_cuda()
    with phase(f"{MOE_ARCH} bf16 training ({MOE_TRAIN_LAYERS} layers)"):
        moe_bf16 = train_timing(MOE_ARCH, MOE_TRAIN_LAYERS, LM_BATCH,
                                LM_SEQ, plain_curve=True)
        free_cuda()
    new_lm = {arch: new_lm_phases(arch, plan)
              for arch, plan in NEW_LM.items()}
    eh = encdec_hybrid_phases()
    with phase("decode graphs"):
        graphs_lm = decode_graphs_phase(floor)
        free_cuda()
    with phase("prediction service"):
        service = service_phase()
        free_cuda()
    with phase("pod runtime"):
        pod = pod_phase()
        free_cuda()
    with phase("distribution"):
        dist_rec = distribution_phase()
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
                       if v["lstm_cell_launches"]},
        launches_fabric=fabric_stats["lstm_cell_launches"],
        launches_service={
            "per_tick": service["timing"]["cell_launches_per_tick"],
            "per_retrain": {t: service[t]["retrain"]["launches"]
                            for t in ("milestone", "per_task")},
            "retrain_train_steps": {t: service[t]["retrain"]["train_steps"]
                                    for t in ("milestone", "per_task")}},
        launches_pod={k: pod[k]["launches"] for k in POD_PROFILED},
        device_us_pod={k: pod[k]["profile"]["cell_device_us"]
                       for k in POD_PROFILED},
        device_us_service=service["timing"]["cell_device_us"],
        bound_us_service=service["timing"]["cell_bound_us"],
        batch_service=service["timing"]["bucket"])]
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
    # training: the Functions' launches per main path (two per layer per
    # step) and their gradients' checks and times
    kernels[1].update(launches_train=dense_fp32["launches"][
        "flash_attention"], launches_train_moe=moe_fp32["launches"][
        "flash_attention"], grad=flash_grad["timing"],
        grad_max_abs_err=flash_grad["worst"][torch.float32],
        grad_max_abs_err_bf16=flash_grad["worst"][torch.bfloat16])
    kernels[3].update(launches_train=moe_fp32["launches"]["moe_router"],
                      grad=router_grad)
    # the mesh trainer's steps (phase 14b) went through the flash kernel
    kernels[1]["launches_mesh_train"] = dist_rec["mesh_train"]["launches"][
        "flash_attention"]
    # the archs ported last: each kernel's launches in each one's fp32
    # serving gate and fp32 training gate (MLA layers launch neither
    # attention kernel); for the encoder-decoder and the hybrid, serving
    # from their fp32 gates, training from seamless's fp32 gate, Jamba's
    # gradient run (one value_and_grad call at full width) and its reduced
    # config's fp32 gate
    def new_arch_launches(i: int) -> None:
        name = kernels[i]["name"]
        kernels[i]["launches_new_archs"] = {
            **{arch: dict(serve=out["fp32"]["launches"][name],
                          train=out["train_fp32"]["launches"][name])
               for arch, out in new_lm.items()},
            ENCDEC_ARCH: dict(serve=eh["encdec_fp32"]["launches"][name],
                              train=eh["encdec_train_fp32"]["launches"][
                                  name]),
            HYBRID_ARCH: dict(serve=eh["hybrid_fp32"]["launches"][name],
                              grads=eh["hybrid_grads"]["launches"][name],
                              train_reduced=eh["hybrid_train_fp32"][
                                  "launches"][name])}

    for i in (1, 2, 3):
        new_arch_launches(i)
    # the new geometries' timed rows: flash non-causal at Sq != Sk, decode
    # at H = Hkv = 16, the router at E = 16 (Jamba's), the scan at
    # d_inner 16384
    kernels[1]["new_geometries"] = flash["cross"]
    kernels[2]["new_geometries"] = decode["mha"]
    # the decode step's graphs: the device-kv_len launch's checks and
    # times, and what one replay of each family's step launches
    kernels[2]["device_kv_len"] = graphs_lm["kernel"]
    for i in (1, 2, 3):
        kernels[i]["launches_a_replay"] = {
            arch: r["bfloat16"]["record"].get(kernels[i]["name"], 0)
            for arch, r in graphs_lm["archs"].items()}
    kernels[3]["new_geometries"] = router["jamba"]
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
    # the serving variant: launches from falcon-mamba-7b's fp32 serving
    # gate (one per layer per prefill), times at its longest prefill in
    # bf16; no PyTorch call computes the selective scan, so library_ms is
    # null
    head = [r for r in scan_state["timing"] if r["dtype"] == "bfloat16"
            and r["shape"] == "B={} L={} D={} N={}".format(*SCAN_PREFILL)][0]
    kernels.append(dict(
        name="mamba_scan_with_state", route="cuda", **SCAN,
        launches=ssm_serve_gate["launches"]["mamba_scan_with_state"],
        max_abs_err=scan_state["worst"][torch.float32],
        max_abs_err_bf16=scan_state["worst"][torch.bfloat16],
        ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=None, device_ms=head["device_ms"], shape=head["shape"],
        per_shape=scan_state["timing"]))
    for i, res, shape in ((4, scan, SCAN_JAMBA), (5, scan_bwd, SCAN_JAMBA),
                          (6, scan_state, SCAN_JAMBA_PREFILL)):
        new_arch_launches(i)
        kernels[i]["new_geometries"] = [
            r for r in res["timing"]
            if r["shape"] == "B={} L={} D={} N={}".format(*shape)]
    # the attention backward: launches from yi-6b's fp32 training gate
    # (three per attention call), times at FLASH_GRAD in bf16 (the
    # config's own dtype); SDPA's backward is the library call, its
    # errors beside the kernel's in each row
    head = [r for r in flash_grad["timing"] if r["dtype"] == "bfloat16"][0]
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda", **FLASH_BWD,
        launches=dense_fp32["launches"]["flash_attention_bwd"],
        max_abs_err=flash_grad["worst"][torch.float32],
        max_abs_err_bf16=flash_grad["worst"][torch.bfloat16],
        max_rel_err=flash_grad["worst_rel"][torch.float32],
        max_rel_err_bf16=flash_grad["worst_rel"][torch.bfloat16],
        ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
        autograd_ms=head["autograd_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["sdpa_bwd_ms"],
        shape=head["shape"], per_dtype=flash_grad["timing"],
        sweep=flash_grad["sweep"],
        launches_train_moe=moe_fp32["launches"]["flash_attention_bwd"],
        launches_mesh_train=dist_rec["mesh_train"]["launches"][
            "flash_attention_bwd"]))
    new_arch_launches(7)
    print(json.dumps({"slice": slice_stats, "ms_per_interval": buckets}))
    print(json.dumps({"graphs": graphs}))
    print(json.dumps({"start_train_gate": start_gate,
                      "start_train": start_timing,
                      "start_sim": start_sims}))
    print(json.dumps({"igru_train_gate": igru_gate, "igru_sim": igru_sims,
                      "grid": grid, "sweep_parity": parity}))
    print(json.dumps({"fabric": fabric_stats}, default=str))
    print(json.dumps({"lm_fp32": {k: v for k, v in gate.items()
                                  if k != "flips"},
                      "lm_bf16": timing, "serve": served}))
    print(json.dumps({"moe_fp32": {k: v for k, v in moe_gate.items()
                                   if k != "flips"},
                      "moe_bf16": moe_timing, "moe_serve": moe_served}))
    print(json.dumps({"ssm_fp32": ssm_fp32, "ssm_bf16": ssm_bf16,
                      "train": trained}))
    print(json.dumps({"ssm_serve_fp32": {k: v for k, v in
                                         ssm_serve_gate.items()
                                         if k != "flips"},
                      "ssm_serve_bf16": ssm_serve_timing,
                      "ssm_serve": ssm_served}))
    print(json.dumps({"dense_train_fp32": dense_fp32,
                      "dense_train_bf16": dense_bf16, "demo_train": demo,
                      "moe_train_fp32": moe_fp32,
                      "moe_train_bf16": moe_bf16}))
    print(json.dumps({"new_archs": {
        arch: {k: ({kk: vv for kk, vv in v.items() if kk != "flips"}
                   if k == "fp32" else v) for k, v in out.items()}
        for arch, out in new_lm.items()}}))
    print(json.dumps({"encdec_hybrid": {
        k: ({kk: vv for kk, vv in v.items() if kk != "flips"}
            if isinstance(v, dict) else v) for k, v in eh.items()}},
        default=str))
    print(json.dumps({"decode_graphs": graphs_lm}, default=str))
    print(json.dumps({"service": service}))
    print(json.dumps({"pod": pod}))
    print(json.dumps({"distribution": dist_rec}))
    print(f"[time] total: {time.perf_counter() - t_start:.1f} s wall")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
