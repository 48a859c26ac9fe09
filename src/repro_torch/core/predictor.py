"""Straggler Prediction module (paper Fig. 1 / Fig. 4): Encoder-LSTM -> Pareto,
in PyTorch, with its training (MSE against MLE-fitted (alpha, beta)
targets, paper §4.4).

The per-interval hot path is the **fused step** (``_fused_step``): the M_H
history lives in a device-resident ring that rolls on the device, the
encoder is hoisted out of the recurrence, the LSTM cells run through the
CUDA kernel, and the Pareto tail (with per-task scores when asked) is
computed on the device.  A warm interval uploads one packed vector from
a pinned host buffer (new M_H row + M_T batch + q + scalars, counted by
``h2d_stages``), replays one CUDA graph and reads back one E_S vector.
The readback synchronises, so the pinned buffer is free to refill on the
next interval.

Every program the JAX package jits here (the fused step, the idle
catch-up ``_ring_roll``, the Pareto tails, and the network's programs in
``encoder_lstm``) is a :class:`~repro_torch.core.programs.Program`: one
CUDA graph per shape key on the card, the same data flow run eagerly on
the CPU.  Batch shapes follow the JAX package exactly (power-of-two
buckets plus the exact-shape budget), so both packages see the same
batches, and :func:`fused_compile_count` / ``compile_count`` count
captures as JAX counts compiles.  The ring is a static buffer that every
fused-step graph of its shape rolls in place (JAX donates it); one
predictor at a time owns it, and another's next interval takes it back
(``programs.Resident``).  Weights are copied into a graph's buffers only
when they are not the ones loaded there.

Determinism follows the JAX package's tiers: the unfused path
(``predict_features`` -> ``predict_sequence`` -> ``_pareto_tail``) is
the reference; the fused step and the serving batch path restructure it
and agree within the Tier-1 bound (rel 1e-5).  A replayed graph runs the
kernels its eager function launches, on the same inputs.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.core import encoder_lstm as net
from repro_torch.core import features, pareto, programs


class Prediction(NamedTuple):
    alpha: np.ndarray      # (...,)
    beta: np.ndarray       # (...,)
    threshold: np.ndarray  # K  (...,)
    e_s: np.ndarray        # expected straggler count (...,)


def bucket_size(n: int) -> int:
    """Smallest power of two >= n (the batch-shape bucket)."""
    return max(1 << (int(n) - 1).bit_length(), 1) if n else 1


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    absent (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for and is not available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def fp32_ieee() -> None:
    """fp32 means IEEE fp32: turn TF32 off for matmuls and cuDNN (TF32
    would cost the Tier-1 bound).  Every model of the port calls it
    when it is built or unpickled, so a process that holds only one
    model (a sweep worker) has it off too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------- fused interval step ---------------------------
#
# Packed staging layout (one float32 vector, one host->device copy per
# interval): [k, beta_scale, new_mh_row(host_dim), q(nb), m_t(nb*task_dim)].
_N_SCALARS = 2


def _per_task_scores(e_s: torch.Tensor, q: torch.Tensor,
                     mt: torch.Tensor) -> torch.Tensor:
    """``[E_S | scores]`` of shape (nb, 1 + max_tasks): E_S split across
    each job's M_T rows by relative demand (the four requirement
    columns); jobs whose tasks all report zero demand split E_S
    uniformly over their first q slots."""
    nb = mt.shape[0]
    max_tasks = mt.shape[1] // features.TASK_FEATURES
    mt3 = mt.reshape(nb, max_tasks, features.TASK_FEATURES)
    demand = mt3[..., :4].sum(dim=-1)                  # (nb, max_tasks)
    total = demand.sum(dim=-1, keepdim=True)
    real = torch.arange(max_tasks, device=mt.device)[None, :] < q[:, None]
    uniform = real / torch.clamp_min(q, 1.0)[:, None]
    share = torch.where(total > 0.0,
                        demand / torch.where(total > 0.0, total, 1.0),
                        uniform)
    return torch.cat([e_s[:, None], e_s[:, None] * share], dim=1)


def _fused_step(params, ring: torch.Tensor, packed: torch.Tensor, *,
                nb: int, task_dim: int, per_task: bool = False):
    """One whole START decision step on the device (Tier-1).

    Rolls the ring by the staged row (a new ring; the JAX package donates
    the old one), EMA-smooths it, runs the hoisted encoder, the LSTM over
    the horizon and the Pareto tail.  Returns ``(new_ring, e_s)``, or
    ``(new_ring, [E_S | scores])`` of shape (nb, 1 + max_tasks) when
    ``per_task``."""
    host_dim = ring.shape[1]
    k = packed[0]
    beta_scale = packed[1]
    row = packed[_N_SCALARS:_N_SCALARS + host_dim]
    q = packed[_N_SCALARS + host_dim:_N_SCALARS + host_dim + nb]
    mt = packed[_N_SCALARS + host_dim + nb:].reshape(nb, task_dim)
    ring2 = _ring_roll(ring, row)
    lam = net.encoder_hoisted(params, net.ema_smooth(ring2), mt)
    ab = net.decode_sequence(params, lam)
    _, _, _, e_s = _pareto_tail(ab, q, k, beta_scale)
    if per_task:
        return ring2, _per_task_scores(e_s, q, mt)
    return ring2, e_s


def _ring_roll(ring: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Drop the oldest M_H row, append ``row`` (a new ring tensor)."""
    return torch.cat([ring[1:], row[None]], dim=0)


def _fused_in_place(params, ring: torch.Tensor, packed: torch.Tensor, *,
                    nb: int, task_dim: int, per_task: bool, unroll: int):
    """The fused-step program: :func:`_fused_step` with the ring rolled in
    place; returns E_S (or ``[E_S | scores]``).  ``unroll`` keys the
    program as JAX's static ``unroll`` does; a graph holds no loop, so it
    changes no value."""
    ring2, out = _fused_step(params, ring, packed, nb=nb, task_dim=task_dim,
                             per_task=per_task)
    ring.copy_(ring2)
    return out


def _roll_in_place(ring: torch.Tensor, row: torch.Tensor) -> None:
    """The catch-up program: :func:`_ring_roll` in place."""
    ring.copy_(_ring_roll(ring, row))


def _pareto_tail(ab: torch.Tensor, q, k, beta_scale):
    """(alpha, beta) head outputs -> (alpha, beta, K, E_S), with
    E_S = q * (K / beta)^(-alpha) and K = k * alpha * beta / (alpha - 1)."""
    alpha = ab[..., 0]
    beta = ab[..., 1] * beta_scale
    thr = k * (alpha * beta / (alpha - 1.0))
    kk = thr / beta
    e_s = q * kk ** (-alpha)
    return alpha, beta, thr, e_s


def _pareto_tail_per_task(ab: torch.Tensor, q, k, beta_scale,
                          mt: torch.Tensor) -> torch.Tensor:
    """Per-task score tail: (alpha, beta) head + the (nb, task_dim) M_T
    batch -> one packed (nb, 1 + max_tasks) ``[E_S | scores]``.  Scores
    over a job's real tasks sum to its E_S; zero-padded slots score 0."""
    _, _, _, e_s = _pareto_tail(ab, q, k, beta_scale)
    return _per_task_scores(e_s, q, mt)


# the programs the JAX package jits (predictor.py: _fused_step, _ring_roll,
# _pareto_tail, _pareto_tail_per_task): one graph per key on the card
FUSED_STEP = programs.Program("fused_step", _fused_in_place)
RING_ROLL = programs.Program("ring_roll", _roll_in_place)
PARETO_TAIL = programs.Program("pareto_tail", _pareto_tail)
PARETO_TAIL_PER_TASK = programs.Program("pareto_tail_per_task",
                                        _pareto_tail_per_task)


def fused_compile_count() -> int:
    """Captures of the Tier-1 programs in this process, as the JAX
    package's count of their compiles: the fused step, the ring catch-up,
    the serving batch's ``predict_sequence_opt`` and the per-task tail."""
    return (FUSED_STEP.cache_size() + RING_ROLL.cache_size()
            + net.PREDICT_SEQUENCE_OPT.cache_size()
            + PARETO_TAIL_PER_TASK.cache_size())


def _like(tree):
    """Static buffers shaped as ``tree``'s leaves, on their devices."""
    return tree_map(torch.empty_like, tree)


@dataclasses.dataclass
class StragglerPredictor:
    """Owns the Encoder-LSTM params + the (I, T, k) hyper-parameters.

    ``horizon`` is T/I — the number of LSTM iterations per prediction
    (paper: I = 1 s, T = 5 s -> 5 steps).  ``device`` defaults to
    ``"cuda"`` and raises when the card is absent.  Params come from the
    port's seeded init (``seed``) until :meth:`load_params` replaces them.
    """

    n_hosts: int
    max_tasks: int
    k: float = pareto.DEFAULT_K
    horizon: int = 5
    interval: float = 1.0
    seed: int = 0
    # beta (the Pareto scale, in seconds) is regressed in units of
    # beta_scale so the MSE loss is O(1); alpha is O(1) already
    beta_scale: float = 1.0
    #: JAX's ``lax.scan`` unroll factor for the Tier-1 programs.  ``None``
    #: = auto (``min(2, horizon)``); per-bucket autotuned overrides land
    #: in ``_unroll_for_bucket`` via :meth:`autotune_unroll`.  It keys the
    #: fused step's and the serving batch's graphs, so the captures follow
    #: JAX's compiles; a graph holds no loop, so it changes no value.
    unroll: int | None = None
    #: skip power-of-two padding when the padded bucket would waste more
    #: than this fraction of its rows; 1.0 disables exact shapes entirely.
    exact_shape_waste: float = 0.25
    #: at most this many distinct exact shapes are ever used — once
    #: spent, new job counts fall back to their power-of-two bucket.
    exact_shape_budget: int = 8
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        fp32_ieee()
        self.input_dim = features.input_dim(self.n_hosts, self.max_tasks)
        self.host_dim = self.n_hosts * features.HOST_FEATURES
        self.task_dim = self.max_tasks * features.TASK_FEATURES
        self._exact_shapes: set[int] = set()
        self._unroll_for_bucket: dict[int, int] = {}
        self.params = net.init_params(self.seed, self.input_dim,
                                      device=self.device)
        self.opt = net.adam_init(self.params)
        self._losses: list[float] = []
        self.buckets_used: set[int] = set()
        self._init_fused_state()

    def load_params(self, params: dict) -> None:
        """Replace the weights (e.g. ``convert.from_jax`` output), moved
        to this predictor's device, with a fresh Adam state for them (as
        a new JAX predictor holding them would have)."""
        self.params = _tree_to(params, self.device)
        self.opt = net.adam_init(self.params)

    # ----------------------- fused interval hot path -----------------------

    def _init_fused_state(self) -> None:
        #: the device (horizon, host_dim) M_H ring: a ``programs.Held``
        #: whose value is the shared ring buffer while this predictor owns
        #: it, else this predictor's own copy
        self._ring = None
        self._ring_rows = 0        # host rows the ring has absorbed
        self._host_rows = 0        # host rows observed so far
        #: host-side copy of the last ``horizon`` rows — the source of
        #: truth the device ring is rebuilt from (cold start, unpickling)
        self._row_hist = collections.deque(maxlen=self.horizon)
        self._stage_bufs: dict[int, torch.Tensor] = {}  # per-bucket, pinned
        self.h2d_stages = 0        # host->device staging copies performed

    def __getstate__(self):
        # device state is a cache of host state: drop the ring and the
        # staging buffers, and carry params and Adam's state on the
        # CPU so the pickle holds no device memory; unpickling moves them
        # back to `device`.  No graph or static buffer is the predictor's
        # (they live in the process's program cache), so none is pickled.
        d = dict(self.__dict__)
        d["params"] = _tree_to(self.params, "cpu")
        d["opt"] = _opt_to(self.opt, "cpu")
        d["_ring"] = None
        d["_ring_rows"] = 0
        d["_stage_bufs"] = {}
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        fp32_ieee()
        self.params = _tree_to(self.params, self.device)
        self.opt = _opt_to(self.opt, self.device)

    def push_host_row(self, m_h: np.ndarray) -> None:
        """Feed one observed host matrix into the fused ring (called every
        interval; the device ring absorbs rows lazily at predict time)."""
        self._row_hist.append(
            np.ascontiguousarray(m_h, np.float32).reshape(-1))
        self._host_rows += 1

    def _stage(self, dst: torch.Tensor, arr) -> None:
        """The fused path's one counted host->device copy, into ``dst``
        (a program's static input).  A pinned source copies
        asynchronously; the caller keeps it unchanged until a later
        synchronising readback."""
        self.h2d_stages += 1
        src = torch.as_tensor(arr)
        dst.copy_(src, non_blocking=src.is_pinned())

    def _stage_buffer(self, nb: int, size: int) -> torch.Tensor:
        buf = self._stage_bufs.get(nb)
        if buf is None or buf.shape[0] != size:
            buf = torch.zeros(size, dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            self._stage_bufs[nb] = buf
        return buf

    # ------------------------- Tier-1 batch shaping ------------------------

    def _unroll(self, nb: int) -> int:
        """The unroll factor keying a bucket's Tier-1 programs: the
        autotuned choice when :meth:`autotune_unroll` pinned one, else the
        ``unroll`` knob, else ``min(2, horizon)`` (the JAX package's
        rule).  It changes no value in the port."""
        u = self._unroll_for_bucket.get(nb)
        if u:
            return u
        if self.unroll:
            return int(self.unroll)
        return min(2, self.horizon)

    def autotune_unroll(self, buckets=None, candidates=(1, 2, 0),
                        repeats: int = 10) -> dict[int, int]:
        """Pin an unroll per bucket in ``_unroll_for_bucket`` (0 in
        ``candidates`` means "full horizon"), plain host state that
        survives pickling; returns the pins.  The signature is the JAX
        package's, which compiles and times every candidate and pins the
        fastest.  A graph holds no loop, so here every candidate replays
        the same kernels and no candidate can be faster: the first is
        pinned, with nothing captured or timed (``repeats`` is unused)."""
        buckets = sorted(buckets or self.buckets_used or {1, 4, 16})
        first = int(candidates[0]) or self.horizon
        for nb in buckets:
            self._unroll_for_bucket[nb] = first
        return dict(self._unroll_for_bucket)

    def batch_size(self, n: int) -> int:
        """The batch axis the fused step sees for ``n`` real jobs: the
        power-of-two bucket, or the exact count when the bucket would
        waste more than ``exact_shape_waste`` of its rows — up to
        ``exact_shape_budget`` distinct exact shapes.  A pure function of
        the call sequence, identical to the JAX package's."""
        n = int(n)
        nb = bucket_size(n)
        if n and nb > n and (nb - n) / nb > self.exact_shape_waste:
            if n in self._exact_shapes \
                    or len(self._exact_shapes) < self.exact_shape_budget:
                self._exact_shapes.add(n)
                return n
        return nb

    @property
    def fused_ready(self) -> bool:
        """True when a fresh (unconsumed) host row is staged — the fused
        step rolls exactly one new row per call, so a second predict in
        the same interval must take the unfused path instead."""
        return self._host_rows > self._ring_rows

    def _ring_buffer(self) -> programs.Resident:
        """The process's static ring of this predictor's shape, which its
        fused-step and catch-up graphs roll."""
        return programs.resident(
            ("ring", self.device, self.horizon, self.host_dim),
            lambda: torch.zeros(self.horizon, self.host_dim,
                                dtype=torch.float32, device=self.device))

    def _fused_entry(self, nb: int, per_task: bool, unroll: int):
        size = _N_SCALARS + self.host_dim + nb * (1 + self.task_dim)
        key = (self.device, programs.signature(self.params), self.horizon,
               self.host_dim, nb, self.task_dim, per_task, unroll)
        return FUSED_STEP.entry(
            key, lambda: (_like(self.params), self._ring_buffer().buf,
                          torch.empty(size, dtype=torch.float32,
                                      device=self.device)),
            nb=nb, task_dim=self.task_dim, per_task=per_task, unroll=unroll)

    def _sync_ring(self) -> np.ndarray:
        """Take the static ring (this predictor's M_H history in it) and
        absorb unconsumed host rows, leaving exactly one (the newest) for
        the fused step itself to roll in.  Returns that last row.
        Rebuilds from the host history (one upload into the ring) when
        the ring is cold, was dropped by pickling, or fell behind by a
        full horizon.  Call under ``programs.LOCK``."""
        t = self.horizon
        lag = self._host_rows - self._ring_rows
        if lag <= 0 or not self._row_hist:
            raise RuntimeError("no fresh host row to predict from")
        rows = list(self._row_hist)
        ring = self._ring_buffer()
        if self._ring is None or lag > len(rows):
            # cold start / fell behind: rebuild at "all but the newest
            # row", left-padding with the oldest as the host deque does
            hist = rows[:-1] or rows[:1]
            while len(hist) < t:
                hist.insert(0, hist[0])
            self._ring = programs.Held()
            ring.take(self._ring, load=False)
            self._stage(ring.buf, np.stack(hist[-t:]))
        else:
            # idle-interval catch-up: roll in every lagging row but the
            # newest (the common warm interval has exactly one)
            ring.take(self._ring)
            for row in rows[-lag:-1]:
                e = RING_ROLL.entry(
                    (self.device, t, self.host_dim),
                    lambda: (ring.buf, torch.empty(
                        self.host_dim, dtype=torch.float32,
                        device=self.device)))
                self._stage(e.args[1], row)
                e.run()
        self._ring_rows = self._host_rows - 1
        return rows[-1]

    def predict_interval(self, m_t: np.ndarray, q: np.ndarray,
                         per_task: bool = False):
        """Fused per-interval prediction (Tier-1): one staged copy, the
        fused step on the device, one readback.

        Args:
            m_t: (n, max_tasks, TASK_FEATURES) current task matrices.
            q: (n,) true task counts.
            per_task: also return the per-task straggler scores, as
                ``(e_s, scores)`` with ``scores`` of shape (n, max_tasks).
        """
        n = m_t.shape[0]
        nb = self.batch_size(n)
        self.buckets_used.add(nb)
        host_dim = self.host_dim
        task_dim = self.task_dim
        with programs.LOCK:
            row = self._sync_ring()
            staged = self._stage_buffer(
                nb, _N_SCALARS + host_dim + nb * (1 + task_dim))
            buf = staged.numpy()
            buf[0] = np.float32(self.k)
            buf[1] = np.float32(self.beta_scale)
            buf[_N_SCALARS:_N_SCALARS + host_dim] = row
            qs = buf[_N_SCALARS + host_dim:_N_SCALARS + host_dim + nb]
            qs[:n] = np.asarray(q, np.float32)
            qs[n:] = 1.0
            mt = buf[_N_SCALARS + host_dim + nb:]
            mt[:n * task_dim] = np.asarray(m_t, np.float32).reshape(-1)
            mt[n * task_dim:] = 0.0
            e = self._fused_entry(nb, per_task, self._unroll(nb))
            e.refresh(0, self.params)
            self._stage(e.args[2], staged)
            try:
                # synchronises: the staging buffer is free again
                out = e.run().cpu().numpy()
            except Exception:
                self._ring = None             # the next call rebuilds it
                self._ring_rows = 0
                raise
        self._ring_rows += 1
        if per_task:
            return out[:n, 0], out[:n, 1:]
        return out[:n]

    # ------------------------ multi-tenant serving -------------------------

    def predict_tenants(self, host_seqs: list, mt_list: list,
                        q_list: list, per_task: bool = False) -> list:
        """Multi-tenant batched prediction (the serving daemon's batch
        tick): many small clusters share one model and one pass.

        Args:
            host_seqs: per-tenant ``(T, n_hosts, HOST_FEATURES)`` (or
                pre-flattened ``(T, host_dim)``) host history windows,
                ``T == horizon`` for every tenant.
            mt_list: per-tenant ``(n_i, max_tasks, TASK_FEATURES)``
                current task matrices.
            q_list: per-tenant ``(n_i,)`` true task counts.
            per_task: also return per-task scores.

        The tenants' job axes are concatenated, each job row carries its
        own tenant's host block, and the combined batch goes through
        :meth:`batch_size`.  Padded rows replicate the last tenant's host
        block.  A **Tier-1** path: the ``predict_sequence_opt`` program,
        then a Pareto tail program.

        Returns a list with one ``e_s`` array per tenant, or one
        ``(e_s, scores)`` pair per tenant when ``per_task``.
        """
        t = self.horizon
        host_dim = self.host_dim
        ns = [int(m.shape[0]) for m in mt_list]
        total = int(sum(ns))
        nb = self.batch_size(total)
        self.buckets_used.add(nb)
        xs = np.zeros((t, nb, self.input_dim), np.float32)
        qp = np.ones(nb, np.float32)
        lo = 0
        for seq, mt, q, n in zip(host_seqs, mt_list, q_list, ns):
            hi = lo + n
            xs[:, lo:hi, :host_dim] = \
                np.asarray(seq, np.float32).reshape(t, 1, host_dim)
            xs[:, lo:hi, host_dim:] = \
                np.asarray(mt, np.float32).reshape(1, n, -1)
            qp[lo:hi] = np.asarray(q, np.float32)
            lo = hi
        if total < nb and host_seqs:
            xs[:, total:, :host_dim] = np.asarray(
                host_seqs[-1], np.float32).reshape(t, 1, host_dim)
        starts = np.cumsum([0] + ns[:-1])
        with programs.LOCK:
            unroll = self._unroll(nb)
            e = net.PREDICT_SEQUENCE_OPT.entry(
                (self.device, programs.signature(self.params), xs.shape,
                 unroll),
                lambda: (_like(self.params), self._empty(xs.shape)),
                unroll=unroll)
            e.refresh(0, self.params)
            self._stage(e.args[1], xs)
            tail = self._tail(e.run(), nb, per_task)
            self._stage(tail.args[1], qp)
            if per_task:
                self._stage(tail.args[4],
                            np.ascontiguousarray(xs[-1, :, host_dim:]))
                out = tail.run().cpu().numpy()
                return [(out[lo:lo + n, 0], out[lo:lo + n, 1:])
                        for lo, n in zip(starts, ns)]
            e_s = tail.run()[3].cpu().numpy()
        return [e_s[lo:lo + n] for lo, n in zip(starts, ns)]

    def _empty(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    def _tail(self, ab: torch.Tensor, nb: int, per_task: bool):
        """The Pareto tail program's entry for a batch of ``nb`` rows,
        ``ab`` (a network program's output) copied in, k and beta_scale
        set in its static inputs when they changed; q (and M_T) are the
        caller's to load.  Call under ``programs.LOCK``."""
        if per_task:
            e = PARETO_TAIL_PER_TASK.entry(
                (self.device, nb, self.task_dim),
                lambda: (self._empty((nb, 2)), self._empty(nb),
                         self._empty(()), self._empty(()),
                         self._empty((nb, self.task_dim))))
        else:
            e = PARETO_TAIL.entry(
                (self.device, nb),
                lambda: (self._empty((nb, 2)), self._empty(nb),
                         self._empty(()), self._empty(())))
        e.copy_in(0, ab)
        e.refresh(2, float(np.float32(self.k)))
        e.refresh(3, float(np.float32(self.beta_scale)))
        return e

    # ---------------------------- inference -------------------------------

    def predict_features(self, m_h_seq: np.ndarray, m_t: np.ndarray,
                         q: np.ndarray, per_task: bool = False):
        """Predict (alpha, beta, K, E_S) for a batch of jobs from numpy
        feature matrices (the unfused reference of the fused step).

        Args:
            m_h_seq: (T, n_hosts, HOST_FEATURES) shared host history.
            m_t: (jobs, max_tasks, TASK_FEATURES) current task matrices
                (broadcast across T).
            q: (jobs,) true task counts.
            per_task: return ``(e_s, scores)`` from the per-task score
                tail instead of a :class:`Prediction`.
        """
        n = m_t.shape[0]
        return self._predict_bucketed(
            m_h_seq, np.asarray(m_t, np.float32).reshape(1, n, -1), n, q,
            per_task=per_task)

    def predict(self, m_h_seq, m_t_seq, q) -> Prediction:
        """Predict from full (T, jobs, ...) matrix sequences (general API;
        tolerates time-varying task matrices).

        Args:
            m_h_seq: (T, n_hosts, HOST_FEATURES) shared host history.
            m_t_seq: (T, jobs, max_tasks, TASK_FEATURES) per-job history.
            q: (jobs,) true task counts.
        """
        t, jobs = m_t_seq.shape[0], m_t_seq.shape[1]
        return self._predict_bucketed(
            m_h_seq, np.asarray(m_t_seq, np.float32).reshape(t, jobs, -1),
            jobs, q)

    def _predict_bucketed(self, m_h_seq, mt_flat: np.ndarray, n: int, q,
                          per_task: bool = False):
        """Assemble the (T, bucket, input_dim) batch — host features on
        every row, task features zero-padded past ``n``, q padded with
        1.0 — run the network, and mask the padded rows off the outputs.
        ``mt_flat`` is (1|T, n, -1) flattened task features (broadcast
        across T when 1)."""
        t = m_h_seq.shape[0]
        nb = bucket_size(n)
        self.buckets_used.add(nb)
        mh_flat = np.asarray(m_h_seq, np.float32).reshape(t, 1, -1)
        host_dim = mh_flat.shape[-1]
        xs = np.zeros((t, nb, self.input_dim), np.float32)
        xs[:, :, :host_dim] = mh_flat
        xs[:, :n, host_dim:] = mt_flat
        qp = np.ones(nb, np.float32)
        qp[:n] = np.asarray(q, np.float32)
        if not per_task:
            pred = self._predict_xs(xs, qp)
            return Prediction(*(f[:n] for f in pred))
        with programs.LOCK:
            # the padded task block of the last step IS the fused path's
            # staged M_T batch (raw features, zero past n)
            tail = self._tail(self._sequence(xs), nb, True)
            self._to_device(tail.args[1], qp)
            self._to_device(tail.args[4],
                            np.ascontiguousarray(xs[-1, :, host_dim:]))
            out = tail.run().cpu().numpy()
        return out[:n, 0], out[:n, 1:]

    def _predict_xs(self, xs: np.ndarray, q: np.ndarray) -> Prediction:
        """The ``predict_sequence`` program, then the Pareto tail program,
        over an assembled (T, nb, input_dim) batch: (alpha, beta, K, E_S)
        on the host."""
        with programs.LOCK:
            tail = self._tail(self._sequence(xs), xs.shape[1], False)
            self._to_device(tail.args[1], q)
            return Prediction(*(f.cpu().numpy() for f in tail.run()))

    def _sequence(self, xs: np.ndarray) -> torch.Tensor:
        """The ``predict_sequence`` program on ``xs`` (an uncounted upload:
        the unfused reference path stages nothing); its output is the
        entry's.  Call under ``programs.LOCK``."""
        return net.sequence_entry(self.params, xs).run()

    def _to_device(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """The unfused reference path's uncounted upload, into ``dst``."""
        dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))

    @property
    def compile_count(self) -> int:
        """Captures of the prediction programs in this process, as the JAX
        package counts their compiles: the unfused network's
        (``predict_sequence``) plus :func:`fused_compile_count`, across
        every predictor (the cache is process-wide, as JAX's is)."""
        return net.PREDICT_SEQUENCE.cache_size() + fused_compile_count()

    # ---------------------------- training --------------------------------

    def make_targets(self, times, mask=None) -> torch.Tensor:
        """MLE-fit (alpha, beta/beta_scale) targets from response times,
        on this predictor's device."""
        times = torch.as_tensor(times, dtype=torch.float32,
                                device=self.device)
        a, b = pareto.fit_pareto(times, mask)
        return torch.stack([a, b / self.beta_scale], dim=-1)

    def fit(self, xs, targets, epochs: int = 50, lr: float = 1e-5,
            batch: int = 64) -> list[float]:
        """Train on (T, N, input_dim) sequences vs (N, 2) targets.

        Minibatches keep one shape: when N > batch the trailing partial
        batch is dropped (each epoch re-permutes, so all data is seen
        across epochs); when N <= batch the single batch is the whole
        set.  Records the epoch-mean loss, not the last batch's.  The
        ``train_step`` program (``net.Training``) holds the params and
        Adam's state in its buffers for the whole fit, gathers each
        minibatch into its minibatch inputs and runs once a minibatch; the
        predictor gets copies of the params and state at the end.  As in
        JAX, fits share one program per minibatch shape: every fit with
        N > batch, and each N <= batch, its own."""
        n = xs.shape[1]
        rng = np.random.default_rng(self.seed)
        steps = net.Training(self.params, self.opt, xs, targets,
                             batch if n > batch else n, lr)
        for _ in range(epochs):
            order = rng.permutation(n)
            if n > batch:
                order = order[:n - (n % batch)]
            losses = []
            for s in range(0, len(order), batch):
                losses.append(steps.step(order[s:s + batch]))
            self._losses.append(float(np.mean(losses)))
        self.params, self.opt = steps.result()
        return self._losses

    @property
    def losses(self) -> list[float]:
        return self._losses


def _tree_to(tree, device):
    """A params tree's leaves as float32 tensors on ``device``."""
    return tree_map(
        lambda t: torch.as_tensor(t, dtype=torch.float32).to(device), tree)


def _opt_to(opt: net.AdamState, device) -> net.AdamState:
    """Adam's state (step and moments) on ``device``."""
    return net.AdamState(step=opt.step.to(device),
                         mu=_tree_to(opt.mu, device),
                         nu=_tree_to(opt.nu, device))
