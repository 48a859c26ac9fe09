"""Batched serving engine with continuous batching + START-driven
straggler re-dispatch, in PyTorch.

The engine runs a fixed set of slots.  Requests queue in; a free slot
prefills its request eagerly (one ``flash_attention`` launch per
attention layer on the card, one ``mamba_scan_with_state`` per SSM
layer), copies the caches into the slot's own static caches (allocated
at ``max_len`` with zeros once, the encoder's states and the recurrent
states included), and joins the decode loop, which decodes every active
slot one token per step through the compiled ``decode_step``
(``serve/programs.py``, JAX's ``jax.jit(model.decode_step)``): one copy
of the token and the position into the slot's entry, one replay of the
slot's CUDA graph (captured at the slot's first step; one capture a slot
until ``release``), the logits read by the greedy argmax.  The graph
replays one ``decode_attention`` launch per attention layer, which
reads the position on the device and writes the cache in place; an SSM
layer steps its recurrent state in place.  START integration:
per-slot decode latency telemetry feeds the port's
``STARTController``; slots whose replica is a predicted
straggler are speculatively re-dispatched to the healthiest replica —
the serving analogue of Algorithm 1's SPECULATION branch.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import programs
from repro_torch.models.lm import Model
from repro_torch.serve.kv_cache import SlotManager, load_into, zeros_padded
from repro_torch.serve.programs import DECODE_STEP, decode_step


@dataclasses.dataclass
class Request:
    req_id: int
    tokens: np.ndarray          # prompt
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    submit_t: float = 0.0
    finish_t: float = 0.0


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    max_len: int = 256
    greedy: bool = True
    temperature: float = 1.0


class Engine:
    """Serves ``model`` with ``params``; runs on the params' device."""

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 on_step: Optional[Callable] = None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.slots = SlotManager(cfg.n_slots)
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self._state: dict[int, dict] = {}  # slot -> {caches, pos, req, last}
        self._caches: dict[int, list] = {}   # slot -> its static caches
        self.on_step = on_step

    # ------------------------------ intake --------------------------------

    def submit(self, req: Request) -> None:
        req.submit_t = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        while self.queue and self.slots.free_slots():
            req = self.queue.popleft()
            slot = self.slots.assign(req.req_id)
            toks = torch.as_tensor(np.asarray(req.tokens), dtype=torch.long,
                                   device=self.device)[None]
            logits, caches = self._prefill(toks)
            nxt = self._sample(logits)
            req.out.append(int(nxt[0, 0]))
            self._state[slot] = {
                "caches": self._load(slot, caches), "pos": len(req.tokens),
                "req": req, "last": nxt}

    def _prefill(self, toks):
        return self.model.prefill(self.params, {"tokens": toks})

    def _load(self, slot: int, caches) -> list:
        """The slot's static caches with the prefill's ``caches`` copied
        in; allocated at ``max_len`` on the slot's first use (again only if
        a request's cache shapes differ)."""
        buf = self._caches.get(slot)
        if buf is None or programs.signature(buf) != programs.signature(
                zeros_padded(caches, self.cfg.max_len, "meta")):
            buf = self._caches[slot] = zeros_padded(caches,
                                                    self.cfg.max_len)
        load_into(buf, caches)
        return buf

    def _sample(self, logits):
        if self.cfg.greedy:
            return torch.argmax(logits[:, -1], dim=-1)[:, None]
        raise NotImplementedError

    # ------------------------------ stepping -------------------------------

    def step(self) -> int:
        """One engine iteration: admit, decode every active slot once,
        retire finished requests.  Returns #active slots."""
        self._admit()
        active = list(self._state.items())
        for slot, st in active:
            t0 = time.perf_counter()
            logits = self._decode(slot, st)
            st["pos"] += 1
            nxt = self._sample(logits)
            st["last"] = nxt
            req: Request = st["req"]
            req.out.append(int(nxt[0, 0]))
            if self.on_step:
                self.on_step(slot, time.perf_counter() - t0)
            if len(req.out) >= req.max_new \
                    or st["pos"] >= self.cfg.max_len - 1:
                req.finish_t = time.perf_counter()
                self.done.append(req)
                self.slots.release(slot)
                del self._state[slot]
        return len(self._state)

    def _decode(self, slot: int, st: dict):
        """One token of ``slot`` through its compiled step: the logits."""
        return decode_step(self.model, self.params, st["caches"],
                           st["last"].reshape(1, 1), st["pos"])

    def release(self) -> None:
        """Drop the idle slots' static caches, and with them their
        compiled steps (graphs and memory pools); a slot allocates and
        captures again at its next request."""
        for slot in [s for s in self._caches if s not in self._state]:
            del self._caches[slot]
        with programs.LOCK:
            DECODE_STEP.prune()

    def run(self, max_iters: int = 10_000) -> list[Request]:
        it = 0
        while (self.queue or self._state) and it < max_iters:
            self.step()
            it += 1
        return self.done


# --------------------- START-driven replica re-dispatch ---------------------


class ReplicaDispatcher:
    """Serving-cluster view for START: R replicas, per-replica latency
    telemetry; predicted straggler replicas have their in-flight requests
    speculatively duplicated onto the healthiest replica (first wins).
    The controller is the port's, built on ``device``."""

    def __init__(self, n_replicas: int, controller=None, k: float = 1.5,
                 device: str | torch.device = "cuda"):
        from repro_torch.core.start import STARTController
        self.n = n_replicas
        self.controller = controller or STARTController(
            n_hosts=n_replicas, max_tasks=8, k=k, device=device)
        self.latency: list[list[float]] = [[] for _ in range(n_replicas)]
        self.assignments: dict[int, int] = {}   # req -> replica
        self.duplicated: set[int] = set()

    def assign(self, req_id: int) -> int:
        loads = [sum(1 for r in self.assignments.values() if r == i)
                 for i in range(self.n)]
        rep = int(np.argmin(loads))
        self.assignments[req_id] = rep
        return rep

    def observe(self, replica: int, latency_s: float) -> None:
        self.latency[replica].append(latency_s)

    def decide_redispatch(self) -> list[tuple[int, int]]:
        """Returns [(req_id, target_replica)] speculative duplicates for
        requests on replicas whose latency tail is predicted Pareto-heavy."""
        out = []
        means = np.array([np.mean(lat[-16:]) if lat else 0.0
                          for lat in self.latency])
        if means.max() <= 0:
            return out
        lat_all = np.concatenate(
            [np.asarray(lat[-16:]) for lat in self.latency if lat]) \
            if any(self.latency) else np.zeros(1)
        if len(lat_all) < 4:
            return out
        # K = k x Pareto mean; plug in the empirical mean (the MLE mean
        # alpha*beta/(alpha-1) degenerates as alpha -> 1 on mixed fleets)
        thr = self.controller.predictor.k * float(np.mean(lat_all))
        slow = [i for i in range(self.n)
                if self.latency[i] and np.mean(self.latency[i][-4:]) > thr]
        if not slow:
            return out
        healthy = int(np.argmin(means + (means == 0) * 1e9))
        for req, rep in list(self.assignments.items()):
            if rep in slow and req not in self.duplicated:
                self.duplicated.add(req)
                out.append((req, healthy))
        return out
