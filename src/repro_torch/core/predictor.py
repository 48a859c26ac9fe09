"""Straggler Prediction module (paper Fig. 1 / Fig. 4): Encoder-LSTM -> Pareto,
in PyTorch, with its training (MSE against MLE-fitted (alpha, beta)
targets, paper §4.4).

The per-interval hot path is the **fused step** (``_fused_step``): the M_H
history lives in a device-resident ring that rolls on the device, the
encoder is hoisted out of the recurrence, the LSTM cells run through the
CUDA kernel, and the Pareto tail (with per-task scores when asked) is
computed on the device.  A warm interval uploads one packed vector from
a pinned host buffer (new M_H row + M_T batch + q + scalars, counted by
``h2d_stages``) and reads back one E_S vector.  The readback
synchronises, so the pinned buffer is free to refill on the next
interval.

Batch shapes follow the JAX package exactly (power-of-two buckets plus
the exact-shape budget), so both packages see the same batches.  Eager
PyTorch compiles nothing per shape; the shapes are kept for parity and
for the launch geometry of the kernel.

Determinism follows the JAX package's tiers: the unfused path
(``predict_features`` -> ``predict_sequence`` -> ``_pareto_tail``) is
the reference; the fused step and the serving batch path restructure it
and agree within the Tier-1 bound (rel 1e-5).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.core import encoder_lstm as net
from repro_torch.core import features, pareto


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
    #: kept for parity with the JAX predictor; no effect in eager PyTorch
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
        self._ring = None          # device-resident (horizon, host_dim) M_H
        self._ring_rows = 0        # host rows the ring has absorbed
        self._host_rows = 0        # host rows observed so far
        #: host-side copy of the last ``horizon`` rows — the source of
        #: truth the device ring is rebuilt from (cold start, unpickling)
        self._row_hist = collections.deque(maxlen=self.horizon)
        self._stage_bufs: dict[int, torch.Tensor] = {}  # per-bucket, pinned
        self._scalar_cache = None  # device (k, beta_scale) for serving
        self.h2d_stages = 0        # host->device staging copies performed

    def __getstate__(self):
        # device state is a cache of host state: drop the ring, staging
        # buffers and scalars, and carry params and Adam's state on the
        # CPU so the pickle holds no device memory; unpickling moves them
        # back to `device`
        d = dict(self.__dict__)
        d["params"] = _tree_to(self.params, "cpu")
        d["opt"] = _opt_to(self.opt, "cpu")
        d["_ring"] = None
        d["_ring_rows"] = 0
        d["_stage_bufs"] = {}
        d["_scalar_cache"] = None
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

    def _stage(self, arr, non_blocking: bool = False) -> torch.Tensor:
        """The fused path's one counted host->device copy.  A pinned
        source may copy asynchronously (``non_blocking``); the caller
        keeps it unchanged until a later synchronising readback."""
        self.h2d_stages += 1
        return torch.as_tensor(arr).to(self.device, non_blocking=non_blocking,
                                       copy=True)

    def _stage_buffer(self, nb: int, size: int) -> torch.Tensor:
        buf = self._stage_bufs.get(nb)
        if buf is None or buf.shape[0] != size:
            buf = torch.zeros(size, dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            self._stage_bufs[nb] = buf
        return buf

    # ------------------------- Tier-1 batch shaping ------------------------

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

    def _sync_ring(self) -> np.ndarray:
        """Absorb unconsumed host rows into the device ring, leaving
        exactly one (the newest) for the fused step itself to roll in.
        Returns that last row.  Rebuilds from the host history (one
        upload) when the ring is cold, was dropped by pickling, or fell
        behind by a full horizon."""
        t = self.horizon
        lag = self._host_rows - self._ring_rows
        if lag <= 0 or not self._row_hist:
            raise RuntimeError("no fresh host row to predict from")
        rows = list(self._row_hist)
        if self._ring is None or lag > len(rows):
            # cold start / fell behind: rebuild at "all but the newest
            # row", left-padding with the oldest as the host deque does
            hist = rows[:-1] or rows[:1]
            while len(hist) < t:
                hist.insert(0, hist[0])
            self._ring = self._stage(np.stack(hist[-t:]))
        else:
            # idle-interval catch-up: roll in every lagging row but the
            # newest (the common warm interval has exactly one)
            for row in rows[-lag:-1]:
                self._ring = _ring_roll(self._ring, self._stage(row))
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
        row = self._sync_ring()
        host_dim = self.host_dim
        task_dim = self.task_dim
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
        self._ring, out = _fused_step(
            self.params, self._ring,
            self._stage(staged, non_blocking=staged.is_pinned()),
            nb=nb, task_dim=task_dim, per_task=per_task)
        self._ring_rows += 1
        out = out.cpu().numpy()      # synchronises: the buffer is free again
        if per_task:
            return out[:n, 0], out[:n, 1:]
        return out[:n]

    # ------------------------ multi-tenant serving -------------------------

    def _scalars_dev(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident (k, beta_scale), cached per value, so the
        serving batch path does not re-upload them every tick."""
        key = (float(self.k), float(self.beta_scale))
        cached = self._scalar_cache
        if cached is None or cached[0] != key:
            cached = (key, (self._stage(np.float32(self.k)),
                            self._stage(np.float32(self.beta_scale))))
            self._scalar_cache = cached
        return cached[1]

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
        block.  A **Tier-1** path (``net.predict_sequence_opt``).

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
        kd, bsd = self._scalars_dev()
        ab = net.predict_sequence_opt(self.params, self._stage(xs))
        starts = np.cumsum([0] + ns[:-1])
        if per_task:
            out = _pareto_tail_per_task(
                ab, self._stage(qp), kd, bsd,
                self._stage(np.ascontiguousarray(xs[-1, :, host_dim:])))
            out = out.cpu().numpy()
            return [(out[lo:lo + n, 0], out[lo:lo + n, 1:])
                    for lo, n in zip(starts, ns)]
        _, _, _, e_s = _pareto_tail(ab, self._stage(qp), kd, bsd)
        e_s = e_s.cpu().numpy()
        return [e_s[lo:lo + n] for lo, n in zip(starts, ns)]

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
        ab = net.predict_sequence(self.params, self._to_device(xs))
        k = torch.tensor(self.k, dtype=torch.float32, device=self.device)
        bs = torch.tensor(self.beta_scale, dtype=torch.float32,
                          device=self.device)
        if per_task:
            # the padded task block of the last step IS the fused path's
            # staged M_T batch (raw features, zero past n)
            out = _pareto_tail_per_task(
                ab, self._to_device(qp), k, bs,
                self._to_device(xs[-1, :, host_dim:])).cpu().numpy()
            return out[:n, 0], out[:n, 1:]
        pred = _pareto_tail(ab, self._to_device(qp), k, bs)
        return Prediction(*(f.cpu().numpy()[:n] for f in pred))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Uncounted upload for the unfused reference path."""
        return torch.as_tensor(np.ascontiguousarray(arr)).to(self.device)

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
        data stays on the predictor's device across epochs."""
        n = xs.shape[1]
        rng = np.random.default_rng(self.seed)
        xs = torch.as_tensor(xs, dtype=torch.float32).to(self.device)
        targets = torch.as_tensor(targets, dtype=torch.float32).to(
            self.device)
        for _ in range(epochs):
            order = rng.permutation(n)
            if n > batch:
                order = order[:n - (n % batch)]
            losses = []
            for s in range(0, len(order), batch):
                idx = torch.as_tensor(order[s:s + batch], device=self.device)
                self.params, self.opt, loss = net.train_step(
                    self.params, self.opt, xs[:, idx], targets[idx], lr=lr)
                losses.append(float(loss))
            self._losses.append(float(np.mean(losses)))
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
