"""Batched scenario-sweep subsystem for the port's cloud simulator (a
copy of the JAX package's ``repro.sim.sweep`` without its XLA
compilation cache; ``run(spec, fabric=...)`` serves the grid to the node
agents of ``repro_torch.sim.fabric``).

The paper's headline results (Figs. 6-10, Table 4) are comparative grids —
techniques x seeds x regimes — previously run serially through hand-rolled
loops. This module makes the grid declarative and parallel:

    spec = SweepSpec(techniques=("start", "sgc", "none"),
                     seeds=(0, 1, 2),
                     scenarios=("planetlab", "flash-crowd", "heavy-tail",
                                "fault-storm"),
                     out_dir="artifacts")
    result = run(spec)            # cells in parallel over a process pool
    result.aggregate()            # {(scenario, technique): metric -> mean/CI}

Design notes:
  * a cell = (scenario, technique, seed); each cell builds its Simulation
    from scratch inside ``run_cell`` — a pure function of the spec — so a
    parallel sweep is bitwise-equal to a serial one (modulo the wall-clock
    ``avg_overhead_s``/``wall_s`` timing fields);
  * techniques that declare pretraining (their registry entry carries a
    ``PretrainSpec`` — no technique is special-cased by name here) are
    pretrained once per (technique, base-config) with fixed seeds (7
    train / 9 warmup, matching benchmarks) and cached as pickled bytes;
    every cell deserializes a fresh instance, so no mutable technique
    state leaks between cells.  A parallel run trains in the PARENT and
    broadcasts the bytes to workers with their cells — workers never
    duplicate a warmup/training run;
  * workers are spawned (not forked): CUDA does not survive fork — and
    the pool is *persistent* across ``run()`` calls, so per-worker
    pretrain/warmup caches survive between figure sweeps
    (``shutdown_pool()`` tears it down explicitly).  A worker unpickles
    START and IGRU-SD onto the device their ``device`` keyword names
    (``technique_kwargs``, default ``"cuda"``); a parallel run that puts
    a technique on the card builds the CUDA kernels in the parent before
    the pool starts, so workers only load them;
  * scheduling is dynamic and parent-participating: cells are grouped
    into (technique, scenario) cache-affinity units, the parent runs
    units itself while workers spawn/import, and steals back unstarted
    submissions when the queue drains — so a cold pool can never make a
    sweep slower than running it serially, and a warm W-worker pool
    gives W+1 effective lanes.
"""
from __future__ import annotations

import atexit
import collections
import concurrent.futures as cf
import csv
import dataclasses
import inspect
import multiprocessing
import os
import pickle
import signal
import time
import warnings

import numpy as np

import torch

from repro_torch.core.predictor import resolve_device
from repro_torch.kernels.lstm_cell import lstm_cell
from repro_torch.policy import Policy, PretrainContext
from repro_torch.sim import scenarios as S
from repro_torch.sim.config import SimConfig
from repro_torch.sim.engine import Simulation

QOS_KEYS = ("avg_execution_time_s", "resource_contention", "energy_kwh",
            "sla_violation_rate", "cpu_util_pct", "ram_util_pct",
            "disk_util_pct", "bw_util_pct")

#: summary fields that measure host wall-clock, not simulated behaviour —
#: excluded from determinism comparisons
TIMING_KEYS = ("avg_overhead_s",)


def deterministic_summary(summary: dict) -> dict:
    """Cell summary with host-timing fields stripped — the part that must
    be bitwise-equal between serial and parallel execution."""
    return {k: v for k, v in summary.items() if k not in TIMING_KEYS}


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Declarative grid: techniques x seeds x scenarios (+ base sizing)."""

    techniques: tuple = ("none",)
    seeds: tuple = (0,)
    scenarios: tuple = ("planetlab",)
    n_hosts: int = 32
    n_intervals: int = 72
    arrival_rate: float = 0.6
    overrides: tuple = ()          # ((SimConfig field, value), ...) per cell
    metrics: tuple = QOS_KEYS
    max_workers: int | None = None  # None -> cpu_count; <= 1 -> serial
    out_dir: str | None = None      # write CSV artifacts here when set
    csv_prefix: str = "sweep"
    pretrain_epochs: int = 8        # START encoder-LSTM pretraining epochs
    igru_epochs: int = 40           # IGRU-SD warmup-fit epochs
    # extra ((knob, value), ...) pairs for third-party Pretrainable
    # policies whose registry entry names an ``epochs_knob`` other than
    # the two built-ins above (a dict is accepted, like ``overrides``)
    pretrain_knobs: tuple = ()
    # per-technique constructor keywords, ((name, ((kw, value), ...)), ...)
    # — a dict-of-dicts is accepted: technique_kwargs={"single-fork":
    # {"p": 0.7}} sweeps a policy's own knobs without registering a
    # variant per setting; pretrained policies receive them through
    # ``PretrainContext.kwargs`` (their pretrain classmethod must
    # forward them, ``cls(..., **ctx.kwargs)`` — see the worked example
    # in ``repro_torch.policy``); ``device`` places START, START-eager
    # and IGRU-SD ({"igru-sd": {"device": "cpu"}})
    technique_kwargs: tuple = ()
    # pretrain on the scenario base config with only dimension-changing
    # overrides (n_hosts/max_tasks, see _PRETRAIN_KEYS) kept — so a sweep
    # over regime/QoS knobs (arrival_rate, reserved_utilization, ...)
    # shares one trained controller per scenario.  Set False to train
    # inside every cell's exact regime instead.
    shared_pretrain: bool = True

    def __post_init__(self):
        for f in ("overrides", "pretrain_knobs"):  # accept dict spelling
            if isinstance(getattr(self, f), dict):
                object.__setattr__(self, f,
                                   tuple(getattr(self, f).items()))
        tk = self.technique_kwargs
        if isinstance(tk, dict):
            tk = tuple(tk.items())
        object.__setattr__(self, "technique_kwargs", tuple(
            (name, tuple(sorted(kw.items())) if isinstance(kw, dict)
             else tuple(kw)) for name, kw in tk))
        for f in ("techniques", "seeds", "scenarios", "overrides",
                  "metrics", "pretrain_knobs"):
            object.__setattr__(self, f, tuple(getattr(self, f)))
        # an empty grid axis would surface as a bare IndexError deep in
        # pretrain_payload (spec.seeds[0]) or a silently empty CSV from
        # run() — fail at construction, naming the field
        for f in ("techniques", "seeds", "scenarios"):
            if not getattr(self, f):
                raise ValueError(
                    f"SweepSpec.{f} must be a non-empty tuple — an "
                    f"empty {f} grid axis means zero cells")
        # fail fast, before any worker is spawned: an unknown technique
        # (ValueError listing registered names) or scenario (KeyError)
        # should abort the sweep at spec-construction time
        from repro_torch import policy
        import repro_torch.sim.techniques  # noqa: F401  (registers them)
        policy.validate(self.techniques, substrate="sim")
        policy.validate((n for n, _ in self.technique_kwargs),
                        substrate="sim")
        for sc in self.scenarios:
            S.get(sc)

    def kwargs_for(self, technique: str) -> dict:
        """Constructor keywords declared for ``technique`` (maybe {})."""
        return dict(dict(self.technique_kwargs).get(technique, ()))

    def cells(self) -> list[tuple[str, str, int]]:
        return [(sc, tech, int(seed)) for sc in self.scenarios
                for tech in self.techniques for seed in self.seeds]

    #: overrides that change network dimensions — the only ones kept when
    #: building the shared pretraining config. Regime knobs (arrival_rate,
    #: n_intervals, QoS overrides) are dropped so a sweep over them (fig7)
    #: shares ONE pretrained controller per scenario, like the old _prep.
    _PRETRAIN_KEYS = ("n_hosts", "max_tasks")

    def cell_config(self, scenario: str, seed: int) -> SimConfig:
        # sizing keys in ``overrides`` replace the spec's base sizing
        # (before scenario arrival scaling) instead of colliding with the
        # explicit keyword arguments
        extra = dict(self.overrides)
        sizing = dict(
            n_hosts=extra.pop("n_hosts", self.n_hosts),
            n_intervals=extra.pop("n_intervals", self.n_intervals),
            arrival_rate=extra.pop("arrival_rate", self.arrival_rate))
        return S.make_config(scenario, seed=seed, **sizing, **extra)

    def pretrain_config(self, scenario: str, seed: int) -> SimConfig:
        """Shared-pretrain environment: scenario base + dimension
        overrides only (regime/QoS overrides stripped)."""
        extra = {k: v for k, v in dict(self.overrides).items()
                 if k in self._PRETRAIN_KEYS}
        return S.make_config(scenario, seed=seed,
                             n_hosts=extra.pop("n_hosts", self.n_hosts),
                             n_intervals=self.n_intervals,
                             arrival_rate=self.arrival_rate, **extra)


@dataclasses.dataclass
class CellResult:
    scenario: str
    technique: str
    seed: int
    summary: dict
    wall_s: float
    pid: int = 0                # the process that ran the cell
    device: str | None = None   # the technique's ``device``, if it has one
    lstm_cell_launches: int = 0  # kernel launches the cell made


# --------------------- technique construction (cached) ---------------------

_PRETRAINED: dict = {}   # (name, base-cfg key[, epochs]) -> pickled policy
_WARM_VIEWS: dict = {}   # base-cfg key -> finished warmup TelemetryView


def _base_key(cfg: SimConfig):
    return dataclasses.astuple(dataclasses.replace(cfg, seed=0))


def _warm_view(cfg: SimConfig):
    """Finished warmup run (seed 9) as a policy TelemetryView."""
    key = _base_key(cfg)
    if key not in _WARM_VIEWS:
        # keep at most one warmup resident: pretrained techniques consume
        # the same one back-to-back per base config, and the view pins a
        # full Simulation's buffers — too heavy to accumulate per distinct
        # config in a long-lived process
        _WARM_VIEWS.clear()
        warm = Simulation(dataclasses.replace(cfg, seed=9))
        warm.run()
        _WARM_VIEWS[key] = warm.snapshot()
    return _WARM_VIEWS[key]


def make_technique(name: str, cfg: SimConfig, *, pretrain_cfg=None,
                   pretrain_epochs: int = 8,
                   igru_epochs: int = 40,
                   extra_knobs: dict | None = None,
                   technique_kwargs: dict | None = None,
                   pretrained: bytes | None = None) -> Policy:
    """Fresh technique instance for one cell.

    Dispatch is fully generic: the registry entry says whether (and how)
    a technique pretrains — ``entry.pretrain.fn`` builds the trained
    instance, ``entry.pretrain.epochs_knob`` names which epoch knob
    feeds it (one of this function's two built-in keywords, or a key in
    ``extra_knobs`` — SweepSpec's ``pretrain_knobs``; an undeclared knob
    raises rather than silently training at a default).  Trained
    policies are cached pickled per (name, base config[, epochs],
    kwargs) per process on fixed seeds (7 train / 9 warmup); every call
    returns a NEW object — safe to bind to a Simulation.
    ``pretrain_cfg`` decouples the training environment from the cell
    config (shared-pretrain sweeps).  ``technique_kwargs`` are
    constructor keywords (SweepSpec's per-technique knobs); pretrained
    policies receive them via ``PretrainContext.kwargs``.
    ``pretrained`` (pickled policy bytes, as produced by
    :func:`pretrain_payload` in the sweep parent) seeds this process's
    cache instead of duplicating the whole warmup + training run —
    workers receiving a broadcast payload never train.
    """
    entry, key, pcfg, epochs, tkw = _pretrain_entry(
        name, cfg, pretrain_cfg=pretrain_cfg,
        pretrain_epochs=pretrain_epochs, igru_epochs=igru_epochs,
        extra_knobs=extra_knobs, technique_kwargs=technique_kwargs)
    if entry.pretrain is None:
        return entry.factory(**tkw)
    if key not in _PRETRAINED:
        if pretrained is not None:
            _PRETRAINED[key] = pretrained
        else:
            ctx = PretrainContext(config=pcfg, epochs=epochs,
                                  warmup=lambda: _warm_view(pcfg),
                                  kwargs=dict(tkw))
            _PRETRAINED[key] = pickle.dumps(entry.pretrain.fn(ctx))
    return pickle.loads(_PRETRAINED[key])


def _pretrain_entry(name: str, cfg: SimConfig, *, pretrain_cfg=None,
                    pretrain_epochs: int = 8, igru_epochs: int = 40,
                    extra_knobs: dict | None = None,
                    technique_kwargs: dict | None = None):
    """Resolve a technique's registry entry and its pretrain cache key —
    shared by cell-side construction and the parent's payload broadcast."""
    from repro_torch import policy
    import repro_torch.sim.techniques  # noqa: F401  (registers them)

    entry = policy.registry.get(name)   # ValueError for unknown names
    tkw = technique_kwargs or {}
    if entry.pretrain is None:
        return entry, None, None, None, tkw
    pcfg = pretrain_cfg if pretrain_cfg is not None else cfg
    # key on the epoch knob the technique actually consumes, so an
    # irrelevant knob changing doesn't evict/duplicate a trained entry
    knobs = {"pretrain_epochs": pretrain_epochs,
             "igru_epochs": igru_epochs, **(extra_knobs or {})}
    epochs_knob = entry.pretrain.epochs_knob
    if epochs_knob is not None and epochs_knob not in knobs:
        raise ValueError(
            f"technique {name!r} declares epochs_knob={epochs_knob!r}, "
            f"which is not a built-in sweep knob ({sorted(knobs)}); pass "
            f"it via SweepSpec(pretrain_knobs={{{epochs_knob!r}: ...}}) "
            f"or make_technique(extra_knobs=...)")
    epochs = knobs.get(epochs_knob)
    key = (name, _base_key(pcfg), tuple(sorted(tkw.items()))) \
        + ((epochs,) if epochs_knob else ())
    return entry, key, pcfg, epochs, tkw


def pretrain_payload(spec: SweepSpec, scenario: str,
                     technique: str) -> bytes | None:
    """Parent-side pretraining for one (scenario, technique): returns the
    pickled trained policy (``None`` for techniques that don't pretrain).

    A parallel ``run()`` calls this once per distinct pair and ships the
    bytes to workers with their cells — previously every worker re-ran
    the identical warmup simulation + training per pair, which made cold
    pools *slower than serial* on pretrain-heavy grids.  Cached in the
    parent's ``_PRETRAINED`` (same key the workers use), so repeated
    sweeps in one process pay nothing.
    """
    seed = int(spec.seeds[0])
    entry, key, pcfg, epochs, tkw = _pretrain_entry(
        technique, spec.cell_config(scenario, seed),
        pretrain_cfg=_shared_pretrain_config(spec, scenario, seed),
        pretrain_epochs=spec.pretrain_epochs, igru_epochs=spec.igru_epochs,
        extra_knobs=dict(spec.pretrain_knobs),
        technique_kwargs=spec.kwargs_for(technique))
    if entry.pretrain is None:
        return None
    if key not in _PRETRAINED:
        ctx = PretrainContext(config=pcfg, epochs=epochs,
                              warmup=lambda: _warm_view(pcfg),
                              kwargs=dict(tkw))
        _PRETRAINED[key] = pickle.dumps(entry.pretrain.fn(ctx))
    return _PRETRAINED[key]


def _shared_pretrain_config(spec: SweepSpec, scenario: str,
                            seed: int) -> SimConfig | None:
    """Where a cell's technique pretrains when it is not its own cell
    config: ``spec.pretrain_config`` for a shared-pretrain spec with
    overrides, else ``None`` (the cell config)."""
    if spec.shared_pretrain and spec.overrides:
        return spec.pretrain_config(scenario, seed)
    return None


# ------------------------------ cell runner --------------------------------

def run_cell(spec: SweepSpec, scenario: str, technique: str, seed: int,
             pretrained: bytes | None = None) -> CellResult:
    """Run one (scenario, technique, seed) cell. Pure function of the spec
    (up to wall-clock timing fields) — the parallel/serial equivalence
    guarantee lives here.  ``pretrained`` optionally carries the parent's
    broadcast policy bytes (identical to what local pretraining would
    produce, so purity is preserved)."""
    _maybe_kill_for_test(scenario, technique, seed)
    cfg = spec.cell_config(scenario, seed)
    tech = make_technique(technique, cfg,
                          pretrain_cfg=_shared_pretrain_config(
                              spec, scenario, seed),
                          pretrain_epochs=spec.pretrain_epochs,
                          igru_epochs=spec.igru_epochs,
                          extra_knobs=dict(spec.pretrain_knobs),
                          technique_kwargs=spec.kwargs_for(technique),
                          pretrained=pretrained)
    launches = lstm_cell.launches
    t0 = time.perf_counter()
    sim = Simulation(cfg, technique=tech)
    summary = sim.run()
    return CellResult(scenario=scenario, technique=technique, seed=seed,
                      summary=summary,
                      wall_s=time.perf_counter() - t0, pid=os.getpid(),
                      device=str(tech.device) if hasattr(tech, "device")
                      else None,
                      lstm_cell_launches=lstm_cell.launches - launches)


def _run_unit(spec: SweepSpec, cells: tuple,
              payloads: dict) -> list[CellResult]:
    """Run a scheduling unit (cells sharing (technique, scenario) cache
    affinity) in order."""
    return [run_cell(spec, sc, tech, seed,
                     pretrained=payloads.get((sc, tech)))
            for sc, tech, seed in cells]


def _run_unit_star(args) -> list[CellResult]:
    return _run_unit(*args)


def _worker_init(n_threads: int) -> None:
    """Pool-worker initializer: take the parent's intra-op thread count
    (so a worker's CPU reductions split as the parent's do), then pay the
    import cost (torch + simulator stack + techniques) up front — spawn
    overlaps the parent's pretraining and first locally-run units.  The
    serial == parallel bitwise assertions cover every sweep.  Workers
    are not pinned to a core each (the JAX sweep pins them because XLA
    sizes its pool from the affinity): ``n_threads`` threads on one
    core would oversubscribe it."""
    torch.set_num_threads(n_threads)
    import repro_torch.sim.techniques  # noqa: F401


def _worker_warmup() -> bool:
    """No-op readiness probe: completes once the worker finished
    ``_worker_init`` and is pulling from the call queue.  (The
    ``REPRO_TEST_FAIL_WARMUP`` escape hatch exists so tests can force
    the failed-warmup scheduling path without crashing real workers.)"""
    if os.environ.get("REPRO_TEST_FAIL_WARMUP"):
        raise RuntimeError("forced warmup failure (REPRO_TEST_FAIL_WARMUP)")
    return True


_WARMUP_WARNED = False


def _ready_lanes(warmups) -> int:
    """Count the worker lanes that are actually live: warmup futures
    that completed *successfully*.  A future whose ``_worker_warmup``
    raised (or was cancelled) is ``done()`` too — counting those as
    ready made the parent over-submit 2x deep to lanes that never
    primed.  Failed warmups surface as a one-time RuntimeWarning."""
    global _WARMUP_WARNED
    ready = failed = 0
    for f in warmups:
        if not f.done():
            continue
        if f.cancelled() or f.exception() is not None:
            failed += 1
        else:
            ready += 1
    if failed and not _WARMUP_WARNED:
        _WARMUP_WARNED = True
        warnings.warn(
            f"{failed} sweep worker warmup(s) failed or were cancelled; "
            f"submitting only to the {ready} lane(s) that primed",
            RuntimeWarning, stacklevel=2)
    return ready


def _maybe_kill_for_test(scenario: str, technique: str, seed: int) -> None:
    """Fault-injection hook for the broken-pool tests:
    ``REPRO_TEST_KILL_CELL=scenario:technique:seed:marker_path`` makes
    the FIRST worker process to run that cell SIGKILL itself (the
    marker file arms exactly one kill, so the rerun after recovery
    completes).  Never fires in the parent process, and never in
    production (env var unset)."""
    target = os.environ.get("REPRO_TEST_KILL_CELL")
    if not target:
        return
    sc, tech, sd, marker = target.split(":", 3)
    if (sc, tech, int(sd)) != (scenario, technique, seed):
        return
    if multiprocessing.current_process().name == "MainProcess":
        return
    try:
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return                      # already killed once: run normally
    os.close(fd)
    os.kill(os.getpid(), signal.SIGKILL)


# ------------------------------- results -----------------------------------

@dataclasses.dataclass
class SweepResult:
    spec: SweepSpec
    cells: list
    wall_s: float
    n_workers: int
    #: parent-side pretraining time folded into wall_s (0.0 when every
    #: technique was already cached or nothing pretrains)
    pretrain_s: float = 0.0

    def cell(self, scenario: str, technique: str, seed: int) -> CellResult:
        """O(1) cell lookup (the index is built once, lazily — a Table-4
        grid is thousands of cells and figure code looks each one up)."""
        index = self.__dict__.get("_index")
        if index is None or len(index) != len(self.cells):
            index = {(c.scenario, c.technique, c.seed): c
                     for c in self.cells}
            self.__dict__["_index"] = index
        try:
            return index[(scenario, technique, int(seed))]
        except KeyError:
            raise KeyError((scenario, technique, seed)) from None

    def aggregate(self) -> dict:
        """{(scenario, technique): {metric: {mean, ci95, n}}} over seeds."""
        groups: dict = {}
        for c in self.cells:
            groups.setdefault((c.scenario, c.technique), []).append(
                c.summary)
        out = {}
        for key, sums in groups.items():
            stats = {}
            for m in self.spec.metrics:
                vals = np.array([s[m] for s in sums], float)
                n = len(vals)
                ci = (1.96 * vals.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0
                stats[m] = {"mean": float(vals.mean()), "ci95": float(ci),
                            "n": n}
            out[key] = stats
        return out

    # ------------------------------ artifacts ------------------------------

    def cell_rows(self) -> tuple[list, list]:
        header = ["scenario", "technique", "seed", "wall_s",
                  *self.spec.metrics]
        rows = [[c.scenario, c.technique, c.seed, round(c.wall_s, 4)]
                + [c.summary[m] for m in self.spec.metrics]
                for c in self.cells]
        return header, rows

    def agg_rows(self) -> tuple[list, list]:
        header = ["scenario", "technique", "n"]
        for m in self.spec.metrics:
            header += [f"{m}_mean", f"{m}_ci95"]
        rows = []
        for (sc, tech), stats in self.aggregate().items():
            row = [sc, tech, stats[self.spec.metrics[0]]["n"]]
            for m in self.spec.metrics:
                row += [stats[m]["mean"], stats[m]["ci95"]]
            rows.append(row)
        return header, rows

    def write_csv(self, out_dir: str | None = None) -> list[str]:
        out_dir = out_dir or self.spec.out_dir
        if out_dir is None:
            return []
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for suffix, (header, rows) in (("cells", self.cell_rows()),
                                       ("agg", self.agg_rows())):
            path = os.path.join(out_dir,
                                f"{self.spec.csv_prefix}_{suffix}.csv")
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(header)
                w.writerows(rows)
            paths.append(path)
        return paths


# --------------------------------- runner ----------------------------------

#: persistent spawned worker pool, reused across ``run()`` calls so the
#: per-process pretrain/warmup caches survive between figure sweeps —
#: workers are only respawned when the requested size changes or a
#: worker died
_POOL: cf.ProcessPoolExecutor | None = None
_POOL_WORKERS: int = 0
_POOL_ATEXIT_REGISTERED = False
#: warmup futures submitted at spawn — ``f.done()`` per worker is the
#: scheduler's readiness signal (work submitted before any worker is up
#: cannot be cancelled back out of the executor's call queue, so the
#: parent gates submission on this instead of submitting blind)
_POOL_READY: list = []


def _pool(n_workers: int) -> cf.ProcessPoolExecutor:
    global _POOL, _POOL_WORKERS, _POOL_ATEXIT_REGISTERED, _POOL_READY
    global _WARMUP_WARNED
    if _POOL is not None and _POOL_WORKERS != n_workers:
        _POOL.shutdown(wait=True)
        _POOL = None
    if _POOL is None:
        if not _POOL_ATEXIT_REGISTERED:
            # pool hygiene: the persistent pool outlives every run() call
            # by design, so callers that never reach shutdown_pool() (CI
            # runners, the nightly grid, aborted notebooks) must not leak
            # spawned workers — tear it down at interpreter exit
            atexit.register(shutdown_pool)
            _POOL_ATEXIT_REGISTERED = True
        ctx = multiprocessing.get_context("spawn")
        _POOL = cf.ProcessPoolExecutor(
            max_workers=n_workers, mp_context=ctx,
            initializer=_worker_init,
            initargs=(torch.get_num_threads(),))
        _POOL_WORKERS = n_workers
        _POOL_READY = [_POOL.submit(_worker_warmup)
                       for _ in range(n_workers)]
        _WARMUP_WARNED = False      # fresh pool: fresh failure report
    return _POOL


def shutdown_pool() -> None:
    """Tear down the persistent worker pool (frees worker memory; the next
    parallel ``run()`` respawns cold workers)."""
    global _POOL
    if _POOL is not None:
        _POOL.shutdown(wait=True)
        _POOL = None


def warm_pool(n_workers: int) -> float:
    """Spawn the persistent pool and pay every worker's import cost now;
    returns the wall seconds it took.  Benchmarks call this so one-time
    pool bring-up is *measured separately* from grid throughput instead
    of being silently folded into the first parallel sweep's number."""
    t0 = time.perf_counter()
    _pool(n_workers)
    for f in list(_POOL_READY):
        f.result()
    return time.perf_counter() - t0


def _prebuild_kernels(spec: SweepSpec) -> None:
    """Build the CUDA kernels in this process when a technique of the
    grid runs on the card (its constructor's ``device`` keyword, from
    ``technique_kwargs`` or its default), so spawned workers load the
    built libraries instead of each starting its own ``nvcc``.  Raises
    when the card is asked for and absent, before any worker starts."""
    from repro_torch import policy
    import repro_torch.sim.techniques  # noqa: F401  (registers them)

    on_card = False
    for tech in spec.techniques:
        param = inspect.signature(
            policy.get(tech).factory).parameters.get("device")
        if param is not None:
            dev = spec.kwargs_for(tech).get("device", param.default)
            on_card |= resolve_device(dev).type == "cuda"
    if on_card:
        from repro_torch.kernels import _build
        _build.build_all()


def _build_payloads(spec: SweepSpec) -> dict:
    """Parent-side pretrain bytes for every (scenario, technique) of the
    grid that declares pretraining (cached across calls)."""
    payloads = {}
    for sc in spec.scenarios:
        for tech in spec.techniques:
            b = pretrain_payload(spec, sc, tech)
            if b is not None:
                payloads[(sc, tech)] = b
    return payloads


def warm_pool_caches(spec: SweepSpec, n_workers: int) -> float:
    """Populate every worker's pretrain caches for ``spec`` (each worker
    runs the first-seed cell of every technique, so it unpickles each
    trained policy and loads the kernels it uses); returns the wall
    seconds.  Like :func:`warm_pool` this moves one-time bring-up cost
    out of the first measured grid."""
    t0 = time.perf_counter()
    _prebuild_kernels(spec)
    warm_pool(n_workers)
    payloads = _build_payloads(spec)
    # the first-seed slice of the grid covers every (scenario, technique)
    unit = tuple((sc, tech, int(spec.seeds[0]))
                 for sc in spec.scenarios for tech in spec.techniques)
    pool = _pool(n_workers)
    for f in [pool.submit(_run_unit_star, (spec, unit, payloads))
              for _ in range(n_workers)]:
        f.result()
    return time.perf_counter() - t0


def _schedule_units(spec: SweepSpec, n_workers: int) -> list[tuple]:
    """Partition the grid into ordered scheduling units.

    Cells are grouped by (technique, scenario) — the pretrain cache
    affinity key — so one worker runs a whole group back to back and
    unpickles each technique's payload once, then groups are chunked so
    there are enough units (~4 per lane, parent included) to load-balance
    dynamically."""
    groups: dict = {}
    for c in spec.cells():
        groups.setdefault((c[1], c[0]), []).append(c)
    per_unit = max(1, (len(spec.cells()) + 4 * (n_workers + 1) - 1)
                   // (4 * (n_workers + 1)))
    units = []
    for cells in groups.values():
        for s in range(0, len(cells), per_unit):
            units.append(tuple(cells[s:s + per_unit]))
    return units


def run(spec: SweepSpec, *, fabric=None) -> SweepResult:
    """Execute the sweep grid; parallel over the persistent spawned process
    pool unless ``spec.max_workers <= 1``. Cell order in the result is
    deterministic (scenario-major, as produced by ``spec.cells()``).

    ``fabric`` accepts a started :class:`repro_torch.sim.fabric.
    FabricCoordinator`: the grid is then served to its node agents
    instead of the local pool — same units, same payloads, same bitwise
    guarantee (every cell stays a pure function of the spec, wherever it
    runs).

    Parallel scheduling (all bitwise-neutral — every cell is a pure
    function of the spec, wherever it runs):

      * techniques that pretrain are trained ONCE in the parent and the
        pickled policy bytes broadcast to workers with their cells (cold
        pools used to re-train identical controllers in every worker);
      * cells are grouped by (technique, scenario) so each worker's
        pretrain caches are hit back to back;
      * the parent participates: while workers spawn/import (~seconds on
        a cold pool) it runs units itself, and when the queue drains it
        steals back not-yet-started submissions — a cold-pool sweep is
        never slower than running serially.
    """
    if fabric is not None:
        return fabric.run_grid(spec)
    cells = spec.cells()
    n_workers = spec.max_workers
    if n_workers is None:
        n_workers = min(len(cells), os.cpu_count() or 1)
    t0 = time.perf_counter()
    pretrain_s = 0.0
    if n_workers <= 1 or len(cells) <= 1:
        results = [run_cell(spec, *c) for c in cells]
        res = SweepResult(spec=spec, cells=results,
                          wall_s=time.perf_counter() - t0, n_workers=1)
        res.write_csv()
        return res

    _prebuild_kernels(spec)
    pool = _pool(n_workers)             # spawn starts now, in background
    tp = time.perf_counter()
    payloads = _build_payloads(spec)
    pretrain_s = time.perf_counter() - tp

    units = collections.deque(_schedule_units(spec, n_workers))
    futures: dict = {}
    done_cells: dict = {}

    def record(results: list[CellResult]) -> None:
        for r in results:
            done_cells[(r.scenario, r.technique, r.seed)] = r

    def submit(unit: tuple):
        nonlocal pool
        pay = {k: payloads[k] for k in
               {(sc, tech) for sc, tech, _ in unit} if k in payloads}
        try:
            futures[pool.submit(_run_unit_star, (spec, unit, pay))] = unit
        except cf.process.BrokenProcessPool:
            # the pool broke while the parent was busy elsewhere: run
            # this unit locally, reclaim everything in flight on the
            # dead pool (its futures will never complete; leaving them
            # in `futures` would make harvest() tear down the healthy
            # replacement too), respawn, and resubmit
            record(_run_unit(spec, unit, payloads))
            lost = list(futures.values())
            futures.clear()
            shutdown_pool()
            pool = _pool(n_workers)
            for u in lost:
                submit(u)

    def harvest(wait: bool) -> None:
        nonlocal pool
        pending = list(futures)
        if wait:
            cf.wait(pending, return_when=cf.FIRST_COMPLETED)
        for f in pending:
            if not f.done():
                continue
            unit = futures.pop(f, None)
            if unit is None:
                continue
            try:
                record(f.result())
            except cf.process.BrokenProcessPool:
                # a worker died (OOM/kill): run the lost unit in the
                # parent, respawn the pool, resubmit what it still held
                # (futures was rebuilt — stop iterating the stale list)
                record(_run_unit(spec, unit, payloads))
                lost = list(futures.values())
                futures.clear()
                shutdown_pool()
                pool = _pool(n_workers)
                for u in lost:
                    submit(u)
                break

    # the parent only runs units itself while workers are still coming up,
    # or steady-state when the host has spare cores beyond the workers —
    # on an n_workers >= cpu box a third compute lane just adds contention
    spare_cores = (os.cpu_count() or 1) > n_workers
    while units or futures:
        # readiness-gated submission: work queued before a worker is up
        # enters the executor's call queue and can never be cancelled
        # back, so only feed live workers (2x deep to avoid starvation
        # while the parent is busy with its own unit)
        ready = _ready_lanes(_POOL_READY)
        while units and ready and len(futures) < 2 * ready:
            submit(units.popleft())
        if units and (ready == 0 or spare_cores):
            record(_run_unit(spec, units.popleft(), payloads))
            harvest(wait=False)
        elif units:
            # workers own the queue; wait for one to free up
            harvest(wait=True)
        else:
            # queue drained: steal back a submission no worker started
            # yet (still importing on a cold pool) and run it here
            # rather than waiting on their spawn
            stolen = next((f for f in futures if f.cancel()), None)
            if stolen is not None:
                record(_run_unit(spec, futures.pop(stolen), payloads))
            elif futures:
                harvest(wait=True)

    results = [done_cells[c] for c in cells]
    res = SweepResult(spec=spec, cells=results,
                      wall_s=time.perf_counter() - t0, n_workers=n_workers,
                      pretrain_s=pretrain_s)
    res.write_csv()
    return res
