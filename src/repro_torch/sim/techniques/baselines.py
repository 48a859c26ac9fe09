"""The paper's six baseline techniques (§4.6), a copy of the JAX
package's ``repro.sim.techniques.baselines``: each policy consumes only
the ``repro_torch.policy`` telemetry view and emits the shared action
vocabulary.

  NearestFit [6]  — online curve-fit progress profiling -> reactive speculation
  Dolly [20]      — budgeted proactive cloning of small jobs (UCB-gated)
  GRASS [8]       — greedy resource-aware reactive speculation
  SGC [9]         — pair-wise balanced upfront redundancy
  Wrangler [17]   — learned linear straggler probability -> delayed start
  IGRU-SD [22]    — GRU resource/latency prediction -> proactive mitigation

The first five are numpy and draw from ``view.rng`` in the JAX package's
order, so a run equals the JAX package's bit for bit.  IGRU-SD's GRU is
PyTorch on ``device`` (default ``"cuda"``): its cell is the JAX
package's, not ``torch.nn.GRU``'s (see :func:`gru_apply`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import leaves, tree_map, unflatten
from repro_torch.core import encoder_lstm as nets
from repro_torch.core.predictor import fp32_ieee, resolve_device
from repro_torch.policy import (Action, DONE, EVENT_INTERVAL, EVENT_SUBMIT,
                                PENDING, Policy, PretrainContext,
                                TelemetryView, register)

MIN_OBS_INTERVALS = 2  # reactive methods need some progress history


def _expected_time(view: TelemetryView, i: int) -> float:
    return float(view.tasks.work[i] / view.host_ips_mean)


def _elapsed(view: TelemetryView, i: int) -> float:
    return view.now_s - float(view.tasks.start_s[i])


def _remaining_estimate(view: TelemetryView, i: int) -> float:
    """Remaining seconds at the task's observed progress rate."""
    tt = view.tasks
    el = max(_elapsed(view, i), 1.0)
    rate = float(tt.progress[i]) / el
    rem = float(tt.work[i] - tt.progress[i])
    return rem / max(rate, 1e-6)


def _pick_fast_host(view: TelemetryView, exclude: int) -> int:
    h = view.hosts
    score = np.where(h.online(), h.util[:, 0] - 0.2 * h.speed, np.inf)
    if 0 <= exclude < len(score):
        score[exclude] = np.inf
    return int(np.argmin(score))


@register("nearestfit",
          description="online curve-fit progress profiling with reactive "
                      "speculation [6]")
class NearestFit(Policy):
    """Fits t = a + b*x^c on completed (work -> time) pairs; running tasks
    whose elapsed time exceeds 1.5x the fit are stragglers -> speculate."""

    name = "nearestfit"

    def __init__(self):
        self.obs_x: list[float] = []
        self.obs_t: list[float] = []
        self.coef = None
        self._flagged: set[int] = set()

    def _fit(self):
        if len(self.obs_x) < 8:
            return
        x = np.array(self.obs_x)
        t = np.maximum(np.array(self.obs_t), 1e-3)
        # log t = log b + c log x (a ~= 0 for compute-bound tasks)
        A = np.stack([np.ones_like(x), np.log(x)], 1)
        sol, *_ = np.linalg.lstsq(A, np.log(t), rcond=None)
        self.coef = sol

    def _predict(self, view: TelemetryView, work: float) -> float:
        if self.coef is None:
            return work / view.host_ips_mean
        return float(np.exp(self.coef[0] + self.coef[1] * np.log(work)))

    def observe(self, view: TelemetryView) -> None:
        tt = view.tasks
        done = np.nonzero((tt.state == DONE) & ~tt.is_copy)[0]
        self.obs_x = [float(tt.work[i]) for i in done][-512:]
        self.obs_t = [float(tt.finish_s[i] - tt.start_s[i])
                      for i in done][-512:]
        self._fit()

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event != EVENT_INTERVAL:
            return []
        tt = view.tasks
        acts = []
        cap = max(1, int(0.02 * tt.active_mask().sum()))
        for i in np.nonzero(tt.active_mask())[0]:
            i = int(i)
            if len(acts) >= cap:
                break
            if i in self._flagged:
                continue
            if _elapsed(view, i) < MIN_OBS_INTERVALS * view.interval_seconds:
                continue
            if _elapsed(view, i) > 1.5 * self._predict(view,
                                                       float(tt.work[i])):
                self._flagged.add(i)
                acts.append(Action(
                    "speculate", i, target=_pick_fast_host(
                        view, int(tt.host[i]))))
        return acts


@register("dolly",
          description="budgeted proactive cloning of small jobs, UCB-gated "
                      "on cluster utilization [20]")
class Dolly(Policy):
    """Proactive cloning of small jobs within a 5% resource budget, gated by
    an upper-confidence-bound on cluster CPU utilization [20]."""

    name = "dolly"

    def __init__(self, budget: float = 0.05, small_job: int = 3):
        self.budget = budget
        self.small_job = small_job
        self.cloned = 0

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event != EVENT_SUBMIT:
            return []
        tt = view.tasks
        total = max(int((~tt.is_copy).sum()), 1)
        util = view.hosts.util[:, 0]
        mean, std = float(util.mean()), float(util.std())
        ucb = mean + 1.0 * std
        acts = []
        jobs: dict[int, list[int]] = {}
        for i in view.new_tasks:
            jobs.setdefault(int(tt.job_id[i]), []).append(int(i))
        for job, tids in jobs.items():
            if len(tids) > self.small_job or ucb > 0.8:
                continue
            if (self.cloned + len(tids)) / total > self.budget:
                break
            for i in tids:
                acts.append(Action("clone", i, n_clones=1))
                self.cloned += 1
        return acts


@register("grass",
          description="greedy resource-aware reactive speculation [8]")
class GRASS(Policy):
    """Greedy speculation: clone the running tasks with the largest
    (current-remaining - fresh-rerun) gain while spare capacity exists [8]."""

    name = "grass"

    def __init__(self, max_spec_frac: float = 0.05):
        self.max_spec_frac = max_spec_frac
        self._flagged: set[int] = set()

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event != EVENT_INTERVAL:
            return []
        tt = view.tasks
        spare = float(np.mean(np.clip(1.0 - view.hosts.util[:, 0], 0, 1)))
        budget = max(1, int(spare * view.config.n_hosts
                            * self.max_spec_frac * 0.5))
        cands = []
        for i in np.nonzero(tt.active_mask())[0]:
            i = int(i)
            if i in self._flagged:
                continue
            if _elapsed(view, i) < MIN_OBS_INTERVALS * view.interval_seconds:
                continue
            gain = _remaining_estimate(view, i) - _expected_time(view, i)
            if gain > 2.0 * view.interval_seconds:
                cands.append((gain, i))
        cands.sort(reverse=True)
        acts = []
        for _, i in cands[:budget]:
            self._flagged.add(i)
            acts.append(Action("speculate", i,
                               target=_pick_fast_host(
                                   view, int(tt.host[i]))))
        return acts


@register("sgc",
          description="pair-wise balanced upfront redundancy (approximate "
                      "gradient coding) [9]")
class SGC(Policy):
    """Pair-wise balanced upfront redundancy: each task is duplicated onto
    its paired host with probability p (approximate gradient coding) [9]."""

    name = "sgc"

    def __init__(self, p: float = 0.15):
        self.p = p

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event != EVENT_SUBMIT:
            return []
        acts = []
        n = view.config.n_hosts
        for i in view.new_tasks:
            if view.rng.random() < self.p:
                pair = (int(i) + n // 2) % n
                acts.append(Action("clone", int(i), target=pair,
                                   n_clones=1))
        return acts


@register("wrangler",
          description="learned linear straggler probability over host "
                      "utilization counters; unsafe placements are "
                      "delayed [17]")
class Wrangler(Policy):
    """Linear straggler-probability model on host utilization counters with
    a confidence threshold; predicted-unsafe placements are delayed [17]."""

    name = "wrangler"

    def __init__(self, threshold: float = 0.7, max_delay: int = 3):
        self.threshold = threshold
        self.max_delay = max_delay
        self.w = None           # ridge weights, set by pretraining
        self._delays: dict[int, int] = {}

    @classmethod
    def pretrain(cls, ctx: PretrainContext) -> "Wrangler":
        tech = cls(**ctx.kwargs)   # per-technique sweep knobs
        pretrain_wrangler(tech, ctx.warmup())
        return tech

    def train(self, feats: np.ndarray, labels: np.ndarray,
              l2: float = 1e-2):
        A = np.concatenate([feats, np.ones((len(feats), 1))], 1)
        self.w = np.linalg.solve(A.T @ A + l2 * np.eye(A.shape[1]),
                                 A.T @ labels)

    def _prob(self, hosts_feats: np.ndarray) -> np.ndarray:
        if self.w is None:
            return np.zeros(len(hosts_feats))
        A = np.concatenate([hosts_feats,
                            np.ones((len(hosts_feats), 1))], 1)
        return np.clip(A @ self.w, 0, 1)

    def _host_feats(self, view: TelemetryView) -> np.ndarray:
        h = view.hosts
        return np.concatenate(
            [h.util, h.speed[:, None] / h.speed.max()], 1)

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event == EVENT_SUBMIT:
            return self._maybe_delay(view, view.new_tasks)
        pend = np.nonzero(view.tasks.state == PENDING)[0]
        return self._maybe_delay(view, pend)

    def _maybe_delay(self, view: TelemetryView, idx) -> list[Action]:
        if self.w is None or len(idx) == 0:
            return []
        probs = self._prob(self._host_feats(view))
        online = view.hosts.online()
        safe_exists = bool((probs[online] < self.threshold).any()) \
            if online.any() else False
        acts = []
        for i in idx:
            i = int(i)
            if safe_exists:
                continue  # scheduler will find a safe host
            d = self._delays.get(i, 0)
            if d < self.max_delay:
                self._delays[i] = d + 1
                acts.append(Action("delay", i, delay=1))
        return acts


# ------------------------------ IGRU-SD -----------------------------------


def gru_init(seed: int, n_in: int, hidden: int,
             device: str | torch.device = "cpu") -> dict:
    """The GRU's params, drawn on the CPU from a ``torch.Generator``
    seeded with ``seed`` (so every device gets the same numbers), then
    moved to ``device``.  They are not the JAX package's numbers: torch
    cannot replay ``jax.random``; ``convert.from_jax`` carries those."""
    g = torch.Generator().manual_seed(seed)
    s = 1.0 / np.sqrt(n_in)
    sh = 1.0 / np.sqrt(hidden)
    params = {
        "wx": torch.randn(n_in, 3 * hidden, generator=g) * s,
        "wh": torch.randn(hidden, 3 * hidden, generator=g) * sh,
        "b": torch.zeros(3 * hidden),
        "head": {"w": torch.randn(hidden, 1, generator=g) * sh,
                 "b": torch.zeros(1)},
    }
    return tree_map(lambda t: t.to(device), params)


def gru_apply(params: dict, xs: torch.Tensor) -> torch.Tensor:
    """xs: (T, B, n_in) -> (B,) predicted normalized completion time.

    The JAX package's cell, which is not ``torch.nn.GRU``'s: the
    candidate is ``tanh(x·Wx_n + r ⊙ (h·Wh_n))``, with no bias and with
    ``r`` on ``h·Wh_n`` alone.  ``x·Wx`` is taken for all T steps in one
    product; each step slices the candidate's columns out of the same
    products its gates use."""
    hidden = params["wh"].shape[0]
    xw = torch.matmul(xs, params["wx"])                  # (T, B, 3H)
    h = torch.zeros(xs.shape[1], hidden, dtype=xs.dtype, device=xs.device)
    for t in range(xs.shape[0]):
        hw = torch.matmul(h, params["wh"])
        z = xw[t] + hw + params["b"]
        ru = torch.sigmoid(z[:, :2 * hidden])
        r, u = ru[:, :hidden], ru[:, hidden:]
        n = torch.tanh(xw[t, :, 2 * hidden:] + r * hw[:, 2 * hidden:])
        h = (1 - u) * n + u * h
    out = torch.matmul(h, params["head"]["w"]) + params["head"]["b"]
    return nets.softplus(out[..., 0])


def _gru_loss(params: dict, xs: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    return torch.mean((gru_apply(params, xs) - y) ** 2)


def _gru_step(params: dict, opt: nets.AdamState, xs: torch.Tensor,
              y: torch.Tensor) -> tuple[dict, nets.AdamState, torch.Tensor]:
    """One Adam step (lr 1e-2) on :func:`_gru_loss`, gradients by
    autograd from detached copies of the params; the params returned do
    not require grad."""
    ps = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = _gru_loss(ps, xs, y)
        grads = torch.autograd.grad(loss, leaves(ps))
    params, opt = nets.adam_update(params, unflatten(ps, grads), opt,
                                   lr=1e-2)
    return params, opt, loss.detach()


@register("igru-sd", substrates=("sim", "pod"),
          epochs_knob="igru_epochs",
          description="GRU resource/latency prediction with proactive "
                      "speculate/rerun mitigation [22]; runs on both the "
                      "cloud simulator and the training-pod runtime")
class IGRUSD(Policy):
    """GRU-based resource/latency prediction + detection threshold, with the
    same speculate/rerun mitigation as START (paper §4.6 fairness note).

    Deliberately ignores host heterogeneity (the paper's criticism): its
    features are task-progress only, no host capability terms — which is
    also why it ports to the training-pod substrate unchanged: the pod
    runtime synthesizes per-host shard "tasks" whose progress/elapsed
    ratios carry the same meaning.

    The GRU's params live on ``device`` (default ``"cuda"``), where
    training and every prediction run.  A pickle carries them on the
    CPU; unpickling moves them back to ``device``.  ``last_preds`` holds
    the last interval's predictions, in the order of its ready tasks.
    """

    name = "igru-sd"

    HIST = 5
    FEATS = 3  # progress fraction, rate, elapsed/expected

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        fp32_ieee()
        self.params = gru_init(seed, self.FEATS, 16, device=self.device)
        self.hist: dict[int, list[np.ndarray]] = {}
        self._flagged: set[int] = set()
        self._last_pred: float | None = None
        self.last_preds = np.zeros(0, np.float32)

    def __getstate__(self):
        d = dict(self.__dict__)
        d["params"] = tree_map(lambda t: t.cpu(), self.params)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.device = resolve_device(self.device)
        fp32_ieee()
        self.params = tree_map(lambda t: t.to(self.device), self.params)

    @classmethod
    def pretrain(cls, ctx: PretrainContext) -> "IGRUSD":
        tech = cls(**ctx.kwargs)   # per-technique sweep knobs
        pretrain_igru(tech, ctx.warmup(),
                      epochs=200 if ctx.epochs is None else ctx.epochs)
        return tech

    def train(self, xs: np.ndarray, y: np.ndarray, epochs: int = 200):
        opt = nets.adam_init(self.params)
        xs_d = torch.as_tensor(xs, device=self.device)
        y_d = torch.as_tensor(y, device=self.device)
        for _ in range(epochs):
            self.params, opt, _ = _gru_step(self.params, opt, xs_d, y_d)

    def _task_feats(self, view: TelemetryView, i: int) -> np.ndarray:
        tt = view.tasks
        el = max(_elapsed(view, i), 1.0)
        exp = max(_expected_time(view, i), 1.0)
        return np.array([
            float(tt.progress[i] / max(tt.work[i], 1e-9)),
            float(tt.progress[i] / el / view.host_ips_mean),
            float(el / exp)], np.float32)

    def observe(self, view: TelemetryView) -> None:
        tt = view.tasks
        for i in np.nonzero(tt.active_mask())[0]:
            i = int(i)
            h = self.hist.setdefault(i, [])
            h.append(self._task_feats(view, i))
            del h[:-self.HIST]     # only the last HIST entries are read

    def forget_tasks(self, task_ids) -> None:
        # the rolling progress-rate history stays useful across a task
        # boundary (it describes the same host); only the once-per-task
        # mitigation flag must expire, or a chronically slow host would
        # be mitigated a single time for the whole run
        for i in task_ids:
            self._flagged.discard(int(i))

    def _predict(self, xs: np.ndarray) -> np.ndarray:
        """The GRU on the (T, n, FEATS) histories, the job axis padded to
        a power of two (as the JAX package pads it for its jit cache;
        the rows are independent), on ``device``."""
        n = xs.shape[1]
        pad = max(1 << (n - 1).bit_length(), 1) - n
        if pad:
            xs = np.concatenate(
                [xs, np.zeros((xs.shape[0], pad, xs.shape[2]),
                              xs.dtype)], axis=1)
        with torch.no_grad():
            out = gru_apply(self.params,
                            torch.as_tensor(xs, device=self.device))
        return out.cpu().numpy()[:n]

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event != EVENT_INTERVAL:
            return []
        tt = view.tasks
        run = [int(i) for i in np.nonzero(tt.active_mask())[0]]
        ready = [i for i in run if len(self.hist.get(i, [])) >= self.HIST
                 and i not in self._flagged]
        self._last_pred = 0.0
        self.last_preds = np.zeros(0, np.float32)
        if not ready:
            return []
        xs = np.stack([np.stack(self.hist[i][-self.HIST:]) for i in ready],
                      axis=1)
        preds = self.last_preds = self._predict(xs)
        acts = []
        n_strag = 0.0
        cap = max(1, int(0.02 * len(run)))
        for i, p in zip(ready, preds):
            exp = _expected_time(view, i)
            n_strag += float(p * exp > 1.5 * exp)
            if p > 1.5 and _elapsed(view, i) > exp and len(acts) < cap:
                self._flagged.add(i)
                kind = "speculate" if tt.is_deadline[i] else "rerun"
                acts.append(Action(kind, i, target=_pick_fast_host(
                    view, int(tt.host[i]))))
        self._last_pred = n_strag
        return acts

    def predicted_straggler_count(self):
        return self._last_pred


def synthetic_progress_history(work: float, total: float, expected: float,
                               ips_mean: float,
                               hist: int = IGRUSD.HIST) -> np.ndarray:
    """Idealized (hist, FEATS) progress history for a task of ``work`` MI
    that took ``total`` seconds against an ``expected`` time — the
    training-pair reconstruction shared by the warmup-sim pretrainer and
    the pod substrate's window pretrainer."""
    frac = np.linspace(0.15, 0.75, hist)
    rate = work / max(total, 1.0) / ips_mean
    el = frac * total
    return np.stack([frac, np.full_like(frac, rate), el / expected], 1)


def igru_training_data(warm: TelemetryView
                       ) -> tuple[np.ndarray, np.ndarray] | None:
    """(progress-history -> completion/expected ratio) pairs from a
    finished warmup run's telemetry view: xs (HIST, n, FEATS) and ys (n,)
    float32, or ``None`` when no original task finished."""
    tt = warm.tasks
    xs, ys = [], []
    done = np.nonzero((tt.state == DONE) & ~tt.is_copy)[0]
    for i in done:
        i = int(i)
        total = float(tt.finish_s[i] - tt.start_s[i])
        exp = float(tt.work[i] / warm.host_ips_mean)
        # reconstruct an idealized progress history at the observed rate
        xs.append(synthetic_progress_history(
            float(tt.work[i]), total, exp, warm.host_ips_mean))
        ys.append(total / exp)
    if not xs:
        return None
    return (np.stack(xs, axis=1).astype(np.float32),
            np.array(ys, np.float32))


def pretrain_igru(tech: IGRUSD, warm: TelemetryView,
                  epochs: int = 200) -> None:
    """Train the GRU on :func:`igru_training_data` of a finished warmup
    run's telemetry view."""
    data = igru_training_data(warm)
    if data is not None:
        tech.train(*data, epochs=epochs)


def pretrain_wrangler(tech: Wrangler, warm: TelemetryView) -> None:
    """Train Wrangler's linear model on (host utilization counters at job
    completion -> was-straggler) pairs from a warmup run's view [17]."""
    feats, labels = [], []
    speed = warm.hosts.speed
    speed_n = speed / speed.max()
    hist = warm.util_history
    for rec in warm.completed_jobs:
        t = min(rec["t"] - 1, len(hist) - 1)
        if t < 0:
            continue
        util = hist[t]
        for h, s in zip(rec["hosts"], rec["straggler"]):
            if h < 0:  # finished via a copy while unplaced
                continue
            feats.append(np.concatenate([util[int(h)],
                                         [speed_n[int(h)]]]))
            labels.append(float(s))
    if feats:
        tech.train(np.array(feats), np.array(labels))
