"""Multi-tenant prediction service over the fused START decision step
(the JAX package's ``repro.service.core`` over the port's predictor).

One service process serves one :class:`~repro_torch.service.protocol.Profile`
to many tenants.  Every tenant gets its own
:class:`~repro_torch.core.predictor.StragglerPredictor` — the per-tenant
state (M_H device ring, host history, trigger streaks) is cheap — but
all of them share ONE params tree by reference, so a promotion swaps the
serving model for every tenant with a single assignment under the
service lock and the device holds one copy of the weights.  No code
writes a served tensor in place: a retrain builds new tensors.

Every predictor lives on ``ServiceConfig.device`` (``"cuda"`` unless the
caller asks for the CPU; asking for CUDA where there is none raises).  On
the card every LSTM cell of a dispatch launches the ``lstm_cell`` kernel.

Dispatch per batch tick:

  * exactly one tenant queued -> that tenant's fused
    ``predict_interval`` path, bitwise-equal to calling the predictor
    in-process;
  * several tenants queued -> one combined
    ``StragglerPredictor.predict_tenants`` dispatch: per-tenant host
    blocks, all jobs coalesced into one power-of-two bucket.

Backpressure is shed-oldest per tenant: each tenant may hold at most
``queue_depth`` unanswered snapshots; the oldest is resolved with an
``overload`` error to make room.  Admission control rejects tenants
past ``max_tenants`` or with an incompatible profile.

Degraded mode (serving model failed to load): answers fall back to
``_pareto_tail`` over an MLE Pareto fit of the tenant's own recently
completed durations — no Encoder-LSTM, but still a live E_S estimate —
and carry ``"degraded": true``.
"""
from __future__ import annotations

import dataclasses
import hmac
import threading
from collections import deque

import numpy as np
import torch

from repro_torch.core.pareto import fit_pareto_np
from repro_torch.core.predictor import (StragglerPredictor, _pareto_tail,
                                        bucket_size)
from repro_torch.core.start import STARTController
from repro_torch.policy.actions import Action, ActionKind
from repro_torch.policy.wire import action_to_wire
from repro_torch.service import retrain as rt
from repro_torch.service.protocol import Profile, error
from repro_torch.service.sanitize import TelemetryError, sanitize_snapshot
from repro_torch.train.checkpoint import VersionStore


@dataclasses.dataclass
class ServiceConfig:
    profile: Profile
    max_tenants: int = 16
    queue_depth: int = 4         # unanswered snapshots per tenant
    max_batch: int = 64          # tenants coalesced per tick
    sanitize: str = "clamp"      # "clamp" | "reject"
    ckpt_dir: str | None = None  # VersionStore root (None = in-memory)
    buffer_cap: int = 4096       # replay-buffer pairs
    eval_holdback: int = 32      # newest pairs held back for shadow eval
    min_train_pairs: int = 64    # don't retrain below this
    promote_tol: float = 1.05    # candidate MSE <= tol * champion MSE
    train_epochs: int = 20
    train_lr: float = 1e-4
    retrain_every: int = 0       # snapshots between auto retrains (0=off)
    #: cron-style wall-clock retrain period in seconds (0 = off): the
    #: daemon's scheduler thread flags a retrain due every
    #: ``retrain_interval_s`` of *monotonic* time even when snapshot
    #: volume alone would never reach ``retrain_every`` — slow tenants
    #: still get periodically refreshed models.  Missed periods (e.g. a
    #: long fit) coalesce into one firing, never a backlog burst.
    retrain_interval_s: float = 0.0
    #: shared-secret admission token (None = open).  When set, a
    #: ``hello`` must carry ``token`` equal to it or admission fails
    #: with ``auth-failed``.  The daemon defaults this from
    #: ``REPRO_SERVICE_TOKEN``.
    auth_token: str | None = None
    seed: int = 0
    #: where every predictor of the service lives
    device: str = "cuda"


class Pending:
    """One queued snapshot awaiting its batch tick."""

    __slots__ = ("tenant", "snap", "event", "result")

    def __init__(self, tenant: str, snap: dict):
        self.tenant = tenant
        self.snap = snap
        self.event = threading.Event()
        self.result: dict | None = None

    def resolve(self, result: dict) -> None:
        self.result = result
        self.event.set()


def _predictor(cfg: ServiceConfig) -> StragglerPredictor:
    p = cfg.profile
    return StragglerPredictor(
        n_hosts=p.n_hosts, max_tasks=p.max_tasks, k=p.k,
        horizon=p.horizon, beta_scale=p.beta_scale, seed=cfg.seed,
        device=cfg.device)


class TenantState:
    def __init__(self, name: str, cfg: ServiceConfig, params) -> None:
        p = cfg.profile
        self.name = name
        self.predictor = _predictor(cfg)
        self.predictor.params = params      # shared serving tree
        self.controller = STARTController(
            p.n_hosts, p.max_tasks, trigger=p.trigger,
            score_on=p.score_on, hysteresis=p.hysteresis,
            cooldown=p.cooldown, predictor=self.predictor)
        self.last_seq = float("-inf")
        #: ``(seq, answer)`` of the last resolved snapshot: a client
        #: that lost the connection mid-reply resends the same seq and
        #: gets this cached answer back instead of a second application
        self.last_answer: tuple[float, dict] | None = None
        self.mt_cache: dict[int, np.ndarray] = {}  # job -> true M_T rows
        self.durations: deque = deque(maxlen=512)  # degraded-mode MLE
        self.snapshots = 0
        self.shed = 0


def _mit_to_wire(act) -> dict:
    """``repro_torch.core.mitigation.Action`` -> policy wire dict."""
    return action_to_wire(Action(
        kind=ActionKind(act.kind.value), task=int(act.task_id),
        target=int(act.target_host), host=int(act.source_host)))


class PredictionService:
    """The in-process serving core; transports live in ``daemon``."""

    def __init__(self, cfg: ServiceConfig):
        self.cfg = cfg
        self.profile = cfg.profile
        self.lock = threading.RLock()
        self.tenants: dict[str, TenantState] = {}
        self.pending: deque[Pending] = deque()
        self.buffer = rt.ReplayBuffer(cfg.buffer_cap, cfg.eval_holdback)
        self.model = _predictor(cfg)
        self.params = self.model.params
        self.model_version = 0
        self.degraded = False
        self._prev: list[tuple[int, object]] = []  # in-memory history
        self._retrain_due = False
        self._since_retrain = 0
        self.stats_counters = {
            "snapshots": 0, "ticks": 0, "batch_rows": 0, "sheds": 0,
            "rejected": 0, "degraded_answers": 0, "retrains": 0,
            "promotions": 0, "rollbacks": 0, "candidates_rejected": 0,
            "retrain_failures": 0, "resends": 0, "auth_failures": 0,
        }
        self.last_retrain_error: str | None = None
        self.store = None
        if cfg.ckpt_dir:
            self.store = VersionStore(cfg.ckpt_dir)
            cur = self.store.current()
            if cur is None:
                self.store.save_version(0, self.params)
                self.store.promote(0)
            else:
                self.load_current()

    # ------------------------------ model lifecycle --------------------

    def _load(self, version: int):
        return self.store.load_version(version, self.params,
                                       device=self.model.device)

    def load_current(self) -> bool:
        """(Re)load the promoted version; on failure enter degraded mode
        (the champion keeps its last good params if it ever had any)."""
        try:
            cur = self.store.current()
            if cur is None:
                raise FileNotFoundError("no promoted version")
            params = self._load(cur)
            with self.lock:
                self._install(params, cur)
                self.degraded = False
            return True
        except (OSError, ValueError, EOFError, KeyError):
            self.degraded = True
            return False

    def _install(self, params, version: int) -> None:
        """Swap the shared serving tree (callers hold the lock)."""
        self.params = params
        self.model.params = params
        for t in self.tenants.values():
            t.predictor.params = params
        self.model_version = version

    def retrain_now(self) -> dict:
        """One retrain -> shadow-eval -> promote/reject cycle.

        The fit runs OUTSIDE the service lock (ticks keep answering on
        the champion); only the final install takes it.
        """
        with self.lock:
            if len(self.buffer) < self.cfg.min_train_pairs:
                return {"ok": True, "promoted": False,
                        "reason": f"only {len(self.buffer)} pairs "
                                  f"(< {self.cfg.min_train_pairs})"}
            (tx, ty), (ex, ey) = self.buffer.split()
            if tx.shape[1] == 0:
                return {"ok": True, "promoted": False,
                        "reason": "all pairs inside the eval holdback"}
            champion = self.params
            version = self.model_version
            self._retrain_due = False
            self._since_retrain = 0
            self.stats_counters["retrains"] += 1
        cand, losses = rt.fit_candidate(
            self.model, tx, ty, epochs=self.cfg.train_epochs,
            lr=self.cfg.train_lr)
        champ_loss = rt.shadow_loss(champion, ex, ey)
        cand_loss = rt.shadow_loss(cand, ex, ey)
        report = {"ok": True, "train_pairs": int(tx.shape[1]),
                  "eval_pairs": int(ex.shape[1]),
                  "champion_loss": champ_loss,
                  "candidate_loss": cand_loss,
                  "final_train_loss": losses[-1] if losses else None}
        if not rt.should_promote(cand_loss, champ_loss,
                                 self.cfg.promote_tol):
            with self.lock:
                self.stats_counters["candidates_rejected"] += 1
            report.update(promoted=False, version=version,
                          reason="shadow eval: candidate worse than "
                                 "champion")
            return report
        new_version = version + 1
        if self.store is not None:
            self.store.save_version(new_version, cand)
            self.store.promote(new_version)
        with self.lock:
            self._prev.append((self.model_version, self.params))
            self._install(cand, new_version)
            self.degraded = False
            self.stats_counters["promotions"] += 1
        report.update(promoted=True, version=new_version)
        return report

    def note_retrain_failure(self, exc: BaseException) -> None:
        """Record a retrain cycle that raised: it shows up in ``stats()``
        as ``retrain_failures`` + ``last_retrain_error`` while the
        retrainer thread keeps running, and the due-flag clears so a
        poisoned buffer cannot spin."""
        with self.lock:
            self.stats_counters["retrain_failures"] += 1
            self.last_retrain_error = f"{type(exc).__name__}: {exc}"
            self._retrain_due = False

    def rollback_now(self) -> dict:
        """Instant rollback to the previous promoted version."""
        with self.lock:
            if self.store is not None:
                prev = self.store.rollback()
                if prev is None:
                    return error("no-history", "nothing to roll back to")
                params = self._load(prev)
                self._install(params, prev)
            else:
                if not self._prev:
                    return error("no-history", "nothing to roll back to")
                prev, params = self._prev.pop()
                self._install(params, prev)
            self.degraded = False
            self.stats_counters["rollbacks"] += 1
            return {"ok": True, "version": prev}

    # ------------------------------ admission --------------------------

    def hello(self, tenant: str, profile_wire: dict,
              token: str | None = None) -> dict:
        if self.cfg.auth_token is not None:
            if not (isinstance(token, str) and hmac.compare_digest(
                    token, self.cfg.auth_token)):
                with self.lock:
                    self.stats_counters["auth_failures"] += 1
                return error("auth-failed",
                             "missing or wrong admission token")
        try:
            prof = Profile.from_wire(profile_wire)
        except (TypeError, ValueError) as e:
            return error("bad-profile", str(e))
        with self.lock:
            if tenant in self.tenants:
                return {"ok": True, "tenant": tenant, "rejoined": True,
                        "version": self.model_version}
            if not self.profile.compatible(prof):
                return error(
                    "incompatible-profile",
                    f"service profile {self.profile.to_wire()} != "
                    f"tenant profile {prof.to_wire()}")
            if len(self.tenants) >= self.cfg.max_tenants:
                return error("at-capacity",
                             f"max_tenants={self.cfg.max_tenants}")
            self.tenants[tenant] = TenantState(tenant, self.cfg,
                                               self.params)
            return {"ok": True, "tenant": tenant, "rejoined": False,
                    "version": self.model_version}

    def bye(self, tenant: str) -> dict:
        with self.lock:
            t = self.tenants.pop(tenant, None)
            for p in [p for p in self.pending if p.tenant == tenant]:
                self.pending.remove(p)
                p.resolve(error("gone", "tenant said bye"))
            return {"ok": True, "dropped": t is not None}

    # ------------------------------ ingest ------------------------------

    def submit(self, tenant: str, snap: dict) -> Pending:
        """Sanitize + enqueue one snapshot; never raises — a malformed
        snapshot resolves immediately with its error and touches no
        shared state."""
        p = Pending(tenant, snap)
        with self.lock:
            t = self.tenants.get(tenant)
            if t is None:
                p.resolve(error("not-admitted",
                                f"unknown tenant {tenant!r}; hello first"))
                return p
            # resend dedupe (checked before the sanitizer, whose
            # out-of-order rule would reject the repeated seq): a client
            # that lost the connection after the server applied its
            # snapshot but before the reply landed resends the same seq
            # — answer from the cache / the in-flight entry so the rows
            # are never ingested twice.
            seq = snap.get("seq")
            if isinstance(seq, (int, float)) and not isinstance(seq, bool):
                if (t.last_answer is not None
                        and float(seq) == t.last_answer[0]):
                    self.stats_counters["resends"] += 1
                    p.resolve({**t.last_answer[1], "resent": True})
                    return p
                for q in self.pending:
                    if (q.tenant == tenant
                            and isinstance(q.snap.get("seq"), (int, float))
                            and float(q.snap["seq"]) == float(seq)):
                        # still queued: ride the in-flight entry
                        self.stats_counters["resends"] += 1
                        return q
            try:
                clean = sanitize_snapshot(snap, self.profile, t.last_seq,
                                          mode=self.cfg.sanitize)
            except TelemetryError as e:
                self.stats_counters["rejected"] += 1
                p.resolve(error(e.code, str(e)))
                return p
            t.last_seq = clean["seq"]
            p.snap = clean
            mine = [q for q in self.pending if q.tenant == tenant]
            if len(mine) >= self.cfg.queue_depth:
                oldest = mine[0]
                self.pending.remove(oldest)
                oldest.resolve(error(
                    "overload", "queue full; oldest snapshot shed"))
                t.shed += 1
                self.stats_counters["sheds"] += 1
            self.pending.append(p)
        return p

    # ------------------------------ batch tick --------------------------

    def tick(self) -> int:
        """Answer queued snapshots: at most one per tenant, all tenants
        coalesced into one dispatch.  Returns entries answered."""
        with self.lock:
            batch: list[Pending] = []
            seen: set[str] = set()
            keep: deque[Pending] = deque()
            while self.pending and len(batch) < self.cfg.max_batch:
                p = self.pending.popleft()
                if p.tenant in seen:    # later interval: next tick
                    keep.append(p)
                else:
                    seen.add(p.tenant)
                    batch.append(p)
            keep.extend(self.pending)
            self.pending = keep
            if not batch:
                return 0
            self.stats_counters["ticks"] += 1
            for p in batch:
                self._ingest(self.tenants[p.tenant], p.snap)
            results = self._answer(batch)
            for p, res in zip(batch, results):
                t = self.tenants.get(p.tenant)
                if t is not None:
                    t.last_answer = (p.snap["seq"], res)
                p.resolve(res)
            self._since_retrain += len(batch)
            if (self.cfg.retrain_every
                    and self._since_retrain >= self.cfg.retrain_every):
                self._retrain_due = True
            return len(batch)

    def _ingest(self, t: TenantState, clean: dict) -> None:
        t.snapshots += 1
        self.stats_counters["snapshots"] += 1
        t.controller.observe_hosts(clean["m_h"])
        for j in clean["jobs"]:
            t.mt_cache[j["id"]] = j["m_t"]
        for d in clean["done"]:
            times = d["times"]
            t.durations.extend(float(x) for x in times)
            m_t = t.mt_cache.pop(d["id"], None)
            t.controller.job_finished(d["id"])
            if m_t is not None and not self.degraded:
                host_seq = t.controller._host_seq().reshape(
                    self.profile.horizon, -1)
                self.buffer.add_job(host_seq, m_t, times,
                                    self.profile.beta_scale)

    def _answer(self, batch: list[Pending]) -> list[dict]:
        per_task = self.profile.trigger == "per_task"
        live = [(p, self.tenants[p.tenant]) for p in batch]
        with_jobs = [(p, t) for p, t in live if p.snap["jobs"]]
        preds: dict[str, tuple] = {}
        if self.degraded:
            for p, t in with_jobs:
                self.stats_counters["degraded_answers"] += 1
                preds[p.tenant] = self._degraded_predict(t, p.snap)
        elif len(with_jobs) == 1:
            # single tenant: the tenant's own fused path — bitwise-equal
            # to an in-process predict_interval call
            p, t = with_jobs[0]
            preds[p.tenant] = self._predict_single(t, p.snap, per_task)
        elif with_jobs:
            self._predict_many(with_jobs, per_task, preds)
        out = []
        for p, t in live:
            jobs_out = []
            if p.snap["jobs"]:
                e_s, scores, actions = preds[p.tenant]
                for i, j in enumerate(p.snap["jobs"]):
                    # float32 -> Python float is exact, and JSON carries
                    # a float64 exactly: TCP answers equal in-process ones
                    entry = {"id": j["id"], "e_s": float(e_s[i])}
                    if scores is not None:
                        entry["scores"] = [
                            float(x)
                            for x in scores[i][:int(j["q"])]]
                    entry["actions"] = [
                        _mit_to_wire(a) for a in actions
                        if a.job_id == j["id"]]
                    jobs_out.append(entry)
            self.stats_counters["batch_rows"] += len(jobs_out)
            out.append({"ok": True, "seq": p.snap["seq"],
                        "version": self.model_version,
                        "degraded": bool(self.degraded),
                        "sanitized": p.snap["issues"],
                        "jobs": jobs_out})
        return out

    @staticmethod
    def _incomplete_fn(snap: dict):
        by_id = {j["id"]: j["tasks"] for j in snap["jobs"]}

        def fn(job_id: int):
            return by_id[job_id]
        return fn

    def _apply(self, t: TenantState, snap: dict, ids, e_s, scores,
               per_task: bool):
        """Run the tenant's trigger over sanitized predictions."""
        ctrl = t.controller
        deadline = np.array([j["deadline"] for j in snap["jobs"]])
        fn = self._incomplete_fn(snap)
        if per_task:
            return ctrl.apply_per_task(ids, e_s, scores, deadline, fn)
        open_counts = np.array([j["open"] for j in snap["jobs"]],
                               np.float64)
        return ctrl.apply_milestone(ids, e_s, open_counts, deadline, fn)

    def _predict_single(self, t: TenantState, snap: dict,
                        per_task: bool):
        jobs = snap["jobs"]
        ids = np.array([j["id"] for j in jobs], np.int64)
        m_t = np.stack([j["m_t"] for j in jobs])
        q = np.array([j["q"] for j in jobs], np.float32)
        ctrl = t.controller
        if per_task:
            e_s, scores = ctrl.predict_scores_batch(ids, m_t, q)
        else:
            e_s = ctrl.predict_es_batch(ids, m_t, q)
            scores = None
        actions = self._apply(t, snap, ids, e_s, scores, per_task)
        return e_s, scores, actions

    def _predict_many(self, with_jobs: list, per_task: bool,
                      preds: dict) -> None:
        """One combined dispatch over every queued tenant's jobs."""
        host_seqs, mt_list, q_list, metas = [], [], [], []
        for p, t in with_jobs:
            jobs = p.snap["jobs"]
            host_seqs.append(t.controller._host_seq().reshape(
                self.profile.horizon, -1))
            mt_list.append(np.stack([j["m_t"] for j in jobs]).reshape(
                len(jobs), -1))
            q_list.append(np.array([j["q"] for j in jobs], np.float32))
            metas.append((p, t, np.array([j["id"] for j in jobs],
                                         np.int64)))
        res = self.model.predict_tenants(host_seqs, mt_list, q_list,
                                         per_task=per_task)
        for (p, t, ids), q, r in zip(metas, q_list, res):
            if per_task:
                e_s, scores = r
                scores = np.where(np.isfinite(scores), scores, 0.0)
            else:
                e_s, scores = r, None
            e_s = STARTController._sanitize_es(e_s, q)
            for j, e in zip(ids, e_s):
                t.controller._es_cache[int(j)] = float(e)
            actions = self._apply(t, p.snap, ids, e_s, scores, per_task)
            preds[p.tenant] = (e_s, scores, actions)

    def _degraded_predict(self, t: TenantState, snap: dict):
        """No model: ``_pareto_tail`` on the service model's device over
        the tenant's own MLE duration fit (uniform per-task split)."""
        jobs = snap["jobs"]
        n = len(jobs)
        q = np.array([j["q"] for j in jobs], np.float32)
        ids = np.array([j["id"] for j in jobs], np.int64)
        per_task = self.profile.trigger == "per_task"
        if len(t.durations) >= 2:
            alpha, beta = fit_pareto_np(
                np.asarray(t.durations, np.float32).reshape(1, -1))
            nb = bucket_size(n)
            ab = np.tile(
                np.array([float(alpha[0]),
                          float(beta[0]) / self.profile.beta_scale],
                         np.float32), (nb, 1))
            qp = np.ones(nb, np.float32)
            qp[:n] = q
            dev = self.model.device
            _, _, _, e_s = _pareto_tail(
                torch.from_numpy(ab).to(dev),
                torch.from_numpy(qp).to(dev),
                torch.tensor(self.profile.k, dtype=torch.float32,
                             device=dev),
                torch.tensor(self.profile.beta_scale, dtype=torch.float32,
                             device=dev))
            e_s = e_s.cpu().numpy()[:n]
        else:
            e_s = np.zeros(n)
        e_s = STARTController._sanitize_es(e_s, q)
        scores = None
        if per_task:
            scores = np.zeros((n, self.profile.max_tasks), np.float32)
            for i in range(n):
                scores[i, :int(q[i])] = e_s[i] / max(q[i], 1.0)
        for j, e in zip(ids, e_s):
            t.controller._es_cache[int(j)] = float(e)
        actions = self._apply(t, snap, ids, e_s, scores, per_task)
        return e_s, scores, actions

    # ------------------------------ dispatch ----------------------------

    def stats(self) -> dict:
        with self.lock:
            preds = [self.model] + [t.predictor
                                    for t in self.tenants.values()]
            return {
                "ok": True, "version": self.model_version,
                "degraded": bool(self.degraded),
                "tenants": len(self.tenants),
                "pending": len(self.pending),
                "buffer_pairs": len(self.buffer),
                "buckets": sorted(set().union(
                    *(p.buckets_used for p in preds))),
                # the process's captures of the prediction programs (the
                # JAX service reports its process's XLA compiles here)
                "compile_count": self.model.compile_count,
                "last_retrain_error": self.last_retrain_error,
                **self.stats_counters,
            }

    def handle(self, msg: dict, auto_tick: bool = True,
               timeout: float = 30.0) -> dict:
        """One request -> one response (transport-agnostic dispatcher).

        ``auto_tick=True`` (in-process / single-threaded use) answers a
        snapshot by ticking immediately; the daemon passes ``False`` and
        lets its batch loop resolve the pending entry.
        """
        op = msg.get("op")
        if op == "hello":
            return self.hello(str(msg.get("tenant", "")),
                              msg.get("profile") or {},
                              token=msg.get("token"))
        if op == "snapshot":
            p = self.submit(str(msg.get("tenant", "")), msg)
            if auto_tick and not p.event.is_set():
                self.tick()
            p.event.wait(timeout)
            return p.result if p.result is not None else error(
                "timeout", "tick did not answer in time")
        if op == "stats":
            return self.stats()
        if op == "retrain":
            return self.retrain_now()
        if op == "rollback":
            return self.rollback_now()
        if op == "bye":
            return self.bye(str(msg.get("tenant", "")))
        return error("bad-op", f"unknown op {op!r}")
