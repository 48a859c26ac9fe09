"""Remote elastic sweep fabric: cross-machine unit scheduling (the
port's copy of the JAX package's ``repro.sim.fabric``).

The process-pool sweep (``repro_torch.sim.sweep``) tops out at one
host's cores and cards.  This module serves the exact same
``(spec, unit, payload)`` tuples the pool consumes to **node agents on
other machines**:

  * :class:`FabricCoordinator` owns the grid: it builds the CUDA kernels
    a technique of the grid needs (``sweep._prebuild_kernels``),
    pretrains once (``sweep._build_payloads``), partitions cells into
    the same (technique, scenario) cache-affinity units
    (``sweep._schedule_units``), and hands units to whichever node asks
    — pull-based scheduling, so load balance across heterogeneous
    machines is automatic;
  * :class:`FabricWorker` is the per-machine agent: it connects, says
    ``hello``, pulls units, runs each cell through the very same
    ``sweep._run_unit`` the pool workers use (optionally over a local
    process pool when ``lanes > 1``), and streams each finished unit's
    results straight back — a partial grid is usable at any moment
    (:meth:`FabricCoordinator.partial_result`);
  * membership is **elastic**: nodes join (``hello``) and leave
    (``bye``) mid-grid; every message refreshes a node's lease, and a
    node that disconnects or goes silent past ``lease_s`` gets its
    in-flight units requeued — exactly as the broken-pool path reclaims
    lost units;
  * when the queue drains, an idle node **steals** work: the
    coordinator hands it a speculative copy of the longest-outstanding
    unit still running elsewhere (cells are pure functions of the spec,
    so duplicate execution is value-neutral; first result wins and the
    duplicate is dropped) — the fabric's own straggler mitigation;
  * opt-in **kernel shipping**: with ``ship_cache=True`` the grid reply
    carries the coordinator's built kernel libraries (``build/kernels``,
    each named by a hash of its source and the compiler flags), so a
    node with the same sources loads them instead of running ``nvcc``;
    a node whose sources differ finds none under its own names and
    builds its own.

Each node takes the coordinator's torch intra-op thread count with the
grid (inline, and in its local pool's initializer), so CPU reductions
split as they do in the coordinator's serial run.  A node that cannot
run the grid's techniques (one on ``cuda``, no card) reports every unit
it is handed as ``failed``; the coordinator poisons the grid after
``max_unit_failures``.

Transport is a **length-prefixed binary frame** protocol over stdlib
TCP: an 8-byte big-endian length followed by a pickle payload, byte for
byte the JAX fabric's frames.  Pickled specs and payloads name their
package's classes, so a JAX coordinator cannot serve a port node: the
two fabrics share the frame format, not the grid.

Determinism: every cell is a pure function of the spec wherever it
runs, results are assembled in ``spec.cells()`` order, so a fabric grid
is **bitwise-equal to serial** on ``deterministic_summary``.

Security: frames are pickle, and shipped kernel libraries are loaded
into every node, so the port must never accept bytes from an untrusted
peer unauthenticated.  Set ``REPRO_FABRIC_KEY`` (same value on
coordinator and every node) and each frame carries an HMAC-SHA256 tag
over the payload, verified in constant time **before** ``pickle.loads``
— a frame with a missing or invalid MAC is rejected without ever
touching the unpickler.  Without a key the port falls back to
unauthenticated frames: keep the default loopback bind or a trusted
network in that mode.

CLI::

    python -m repro_torch.sim.fabric coordinator --spec grid.json --bind :0
    python -m repro_torch.sim.fabric worker --connect HOST:PORT --lanes 4
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import hmac
import json
import os
import pickle
import random
import socket
import socketserver
import struct
import threading
import time
import uuid
from collections import deque
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.sim import sweep as _sweep
from repro_torch.sim.sweep import SweepResult, SweepSpec

# ------------------------------ wire frames --------------------------------

#: 8-byte big-endian unsigned frame length, then that many pickle bytes
#: (with ``REPRO_FABRIC_KEY`` set: a 32-byte HMAC-SHA256 tag, then the
#: pickle bytes — the tag is length-counted).
_HDR = struct.Struct(">Q")
#: refuse absurd frames before allocating (corrupt header / wrong peer)
MAX_FRAME = 1 << 31
#: HMAC-SHA256 tag length prepended to authenticated frames
MAC_LEN = 32


class ProtocolError(RuntimeError):
    pass


def fabric_key(key: bytes | str | None = None) -> bytes | None:
    """The frame-authentication key: the explicit argument if given,
    else ``REPRO_FABRIC_KEY`` from the environment, else ``None``
    (unauthenticated frames — loopback/trusted networks only)."""
    if key is None:
        key = os.environ.get("REPRO_FABRIC_KEY")
    if not key:
        return None
    return key.encode() if isinstance(key, str) else bytes(key)


def send_frame(f, obj: dict, key: bytes | str | None = None) -> None:
    """Write one length-prefixed pickle frame to a binary file-like,
    HMAC-tagged when a key is configured."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    k = fabric_key(key)
    if k is not None:
        data = hmac.new(k, data, "sha256").digest() + data
    f.write(_HDR.pack(len(data)))
    f.write(data)
    f.flush()


def _read_exact(f, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(f, key: bytes | str | None = None) -> dict | None:
    """Read one frame; ``None`` on clean EOF (peer closed).

    With a key configured the MAC is verified constant-time **before**
    ``pickle.loads`` — a missing, short, or invalid tag raises
    :class:`ProtocolError` and the untrusted bytes never reach the
    unpickler.
    """
    hdr = _read_exact(f, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    if n > MAX_FRAME:
        raise ProtocolError(f"frame length {n} exceeds MAX_FRAME")
    data = _read_exact(f, n)
    if data is None:
        raise ProtocolError("connection dropped mid-frame")
    k = fabric_key(key)
    if k is not None:
        if len(data) < MAC_LEN:
            raise ProtocolError("frame too short to carry a MAC")
        tag, data = data[:MAC_LEN], data[MAC_LEN:]
        if not hmac.compare_digest(
                tag, hmac.new(k, data, "sha256").digest()):
            raise ProtocolError("frame MAC missing or invalid")
    try:
        obj = pickle.loads(data)
    except Exception as e:   # corrupt/garbled frame, not a crash
        raise ProtocolError(
            f"undecodable frame: {type(e).__name__}: {e}") from e
    if not isinstance(obj, dict) or "op" not in obj:
        raise ProtocolError("frame must be a dict with an 'op'")
    return obj


# ------------------------------ cache shipping -----------------------------

#: don't ship libraries past this many bytes in all
MAX_CACHE_SHIP_BYTES = 256 * 1024 * 1024


def collect_cache_files(path: str | None = None) -> dict[str, bytes]:
    """Read the built kernel libraries of the checkout's current sources
    (``_build.target(src)`` for each) from ``path`` (default
    ``_build.BUILD_DIR``) into {file name: bytes} for shipping.  Stale
    libraries of edited sources and other files are left out; reading
    stops before the total passes ``MAX_CACHE_SHIP_BYTES``."""
    root = Path(path) if path else _build.BUILD_DIR
    files, total = {}, 0
    for src in _build.sources().values():
        name = _build.target(src).name
        try:
            data = (root / name).read_bytes()
        except OSError:
            continue
        total += len(data)
        if total > MAX_CACHE_SHIP_BYTES:
            return files
        files[name] = data
    return files


def install_cache_files(files: dict[str, bytes],
                        path: str | None = None) -> str | None:
    """Write shipped kernel libraries into ``path`` (default
    ``_build.BUILD_DIR``), where ``_build`` finds them under their hashed
    names.  Existing files are never overwritten — local builds win
    races — and each lands through ``os.replace``, so a reader never
    sees a partial one.  Returns the directory (``None`` when nothing
    was shipped)."""
    if not files:
        return None
    root = Path(path) if path else _build.BUILD_DIR
    root.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        if Path(name).name != name or not name.endswith(".so"):
            raise ProtocolError(f"shipped file {name!r} is not a library "
                                f"name")
        full = root / name
        if full.exists():
            continue
        tmp = full.with_name(
            f"{name}.{os.getpid()}.{threading.get_ident()}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, full)    # atomic: readers never see partials
    return str(root)


# ------------------------------ coordinator --------------------------------

class _NodeInfo:
    __slots__ = ("name", "lanes", "last_seen", "inflight")

    def __init__(self, name: str, lanes: int, now: float):
        self.name = name
        self.lanes = max(1, int(lanes))
        self.last_seen = now
        self.inflight: set = set()      # unit ids leased to this node


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        coord: FabricCoordinator = self.server.coordinator  # type: ignore
        f = self.request.makefile("rwb")
        node = None
        try:
            while True:
                try:
                    msg = recv_frame(f)
                except ProtocolError as e:
                    send_frame(f, {"op": "error", "detail": str(e)})
                    return
                if msg is None:
                    return
                node = msg.get("node", node)
                resp = coord._dispatch(msg)
                send_frame(f, resp)
                if msg.get("op") == "bye":
                    node = None       # graceful leave already reclaimed
                    return
        except (BrokenPipeError, ConnectionResetError, OSError):
            return
        finally:
            if node is not None:
                # abrupt disconnect: reclaim everything the node held
                coord._disconnect(node)
            try:
                f.close()
            except OSError:
                pass


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FabricCoordinator:
    """Serves sweep scheduling units to remote node agents.

    One coordinator serves one grid at a time but stays up across
    grids (``run_grid`` bumps an epoch; idle workers poll and pick the
    next grid up automatically — the fabric twin of the persistent
    process pool).

    Args:
        host/port: TCP bind (``port=0`` picks a free one, read
            ``.port`` back).  Loopback by default — see the module
            docstring's security note before binding wider.
        lease_s: a node silent for longer than this has its in-flight
            units reclaimed and requeued.  Must comfortably exceed the
            slowest unit's runtime (the worker heartbeats at
            ``lease_s / 3`` while computing).
        lanes_hint: how many total lanes to partition the grid for when
            scheduling units (elastic membership means the true count
            is unknowable up front; more units than lanes just means
            finer-grained balancing).
        ship_cache: include the coordinator's built kernel libraries
            (:func:`collect_cache_files`) with the grid so joining nodes
            load them instead of running ``nvcc`` (opt-in: shipping
            megabytes to nodes that share a filesystem is waste).
        max_speculate: speculative copies of an outstanding unit handed
            to idle nodes when the queue is empty (work stealing);
            0 disables stealing.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 lease_s: float = 60.0, lanes_hint: int = 8,
                 ship_cache: bool = False, max_speculate: int = 1,
                 clock=time.monotonic):
        self.lease_s = float(lease_s)
        self.lanes_hint = int(lanes_hint)
        self.ship_cache = bool(ship_cache)
        self.max_speculate = int(max_speculate)
        self._clock = clock
        self._lock = threading.RLock()
        self._nodes: dict[str, _NodeInfo] = {}
        self._epoch = 0
        self._spec: SweepSpec | None = None
        self._payload_blob: bytes = pickle.dumps({})
        self._threads = torch.get_num_threads()
        self._cache_files: dict[str, bytes] = {}
        self._units: dict[int, tuple] = {}
        self._queue: deque[int] = deque()
        #: uid -> {node: assign time} (may hold >1 assignee: stealing)
        self._assignees: dict[int, dict[str, float]] = {}
        self._done_units: set[int] = set()
        self._done_cells: dict = {}
        self._expected: list = []
        self._grid_nodes: set[str] = set()
        self._failures: dict[int, int] = {}
        self._grid_error: str | None = None
        #: the current grid's speculative copies handed out, and the
        #: results of units already done that were dropped
        self._steals = 0
        self._duplicates = 0
        self.max_unit_failures = 3
        self._grid_done = threading.Event()
        self._grid_done.set()           # no grid yet == nothing pending
        self._server = _Server((host, port), _Handler)
        self._server.coordinator = self           # type: ignore
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05}, daemon=True)

    # ------------------------------ lifecycle ---------------------------

    def start(self) -> "FabricCoordinator":
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "FabricCoordinator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------ grid API ----------------------------

    def run_grid(self, spec: SweepSpec,
                 timeout: float | None = None) -> SweepResult:
        """Serve ``spec``'s grid to the connected (and yet-to-join)
        nodes; blocks until every cell has landed.  Bitwise-equal to
        serial ``run()`` on ``deterministic_summary``.  ``timeout``
        bounds the wait (``TimeoutError``; ``partial_result`` still
        holds whatever landed)."""
        t0 = time.perf_counter()
        pretrain_s = self._load_grid(spec)
        # the reap loop must run even when every node went silent —
        # nobody else would requeue their leases
        deadline = (time.monotonic() + timeout) if timeout else None
        while not self._grid_done.wait(0.2):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"grid incomplete after {timeout}s "
                    f"({len(self._done_cells)}/{len(self._expected)} "
                    f"cells; partial_result() holds what landed)")
            with self._lock:
                self._reap(self._clock())
        with self._lock:
            if self._grid_error is not None:
                raise RuntimeError(self._grid_error)
            cells = [self._done_cells[c] for c in self._expected]
            n_nodes = max(1, len(self._grid_nodes))
        res = SweepResult(spec=spec, cells=cells,
                          wall_s=time.perf_counter() - t0,
                          n_workers=n_nodes, pretrain_s=pretrain_s)
        res.write_csv()
        return res

    def _load_grid(self, spec: SweepSpec) -> float:
        """Build the kernels the grid needs, pretrain + partition
        ``spec`` and arm it as the current epoch's grid; returns the
        parent-side pretrain seconds."""
        _sweep._prebuild_kernels(spec)
        tp = time.perf_counter()
        payloads = _sweep._build_payloads(spec)   # pretrain once, here
        pretrain_s = time.perf_counter() - tp
        with self._lock:
            self._epoch += 1
            self._spec = spec
            # read in the caller's thread: the count a serial run of the
            # grid here would split its reductions by
            self._threads = torch.get_num_threads()
            self._payload_blob = pickle.dumps(payloads,
                                              pickle.HIGHEST_PROTOCOL)
            self._cache_files = (collect_cache_files()
                                 if self.ship_cache else {})
            units = _sweep._schedule_units(spec, self.lanes_hint)
            self._units = dict(enumerate(units))
            self._queue = deque(range(len(units)))
            self._assignees = {}
            self._done_units = set()
            self._done_cells = {}
            self._expected = spec.cells()
            self._grid_nodes = set()
            self._failures = {}
            self._grid_error = None
            self._steals = self._duplicates = 0
            self._grid_done.clear()
        return pretrain_s

    def partial_result(self) -> SweepResult:
        """The grid as far as it has landed (``spec.cells()`` order,
        missing cells skipped) — incremental result streaming means a
        partial grid is usable before (or without) completion."""
        with self._lock:
            spec = self._spec
            if spec is None:
                raise RuntimeError("no grid loaded")
            cells = [self._done_cells[c] for c in self._expected
                     if c in self._done_cells]
            n_nodes = max(1, len(self._grid_nodes))
        return SweepResult(spec=spec, cells=cells, wall_s=0.0,
                           n_workers=n_nodes)

    def stats(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "nodes": {n.name: {"lanes": n.lanes,
                                   "inflight": len(n.inflight)}
                          for n in self._nodes.values()},
                "queued_units": len(self._queue),
                "outstanding_units": len(self._assignees),
                "done_units": len(self._done_units),
                "done_cells": len(self._done_cells),
                "total_cells": len(self._expected),
                "steals": self._steals,
                "duplicates": self._duplicates,
            }

    # ------------------------------ scheduling --------------------------

    def _touch(self, node: str, lanes: int | None = None) -> _NodeInfo:
        """Register/refresh a node's lease (any message counts).  An
        expired-and-reaped node that speaks again simply re-registers —
        membership is elastic in both directions."""
        now = self._clock()
        info = self._nodes.get(node)
        if info is None:
            info = self._nodes[node] = _NodeInfo(node, lanes or 1, now)
        info.last_seen = now
        if lanes is not None:
            info.lanes = max(1, int(lanes))
        return info

    def _reap(self, now: float) -> None:
        """Requeue in-flight units of nodes silent past their lease."""
        for name in [n for n, i in self._nodes.items()
                     if now - i.last_seen > self.lease_s]:
            self._drop_node(name)

    def _drop_node(self, name: str) -> None:
        info = self._nodes.pop(name, None)
        if info is None:
            return
        for uid in info.inflight:
            holders = self._assignees.get(uid)
            if holders is None:
                continue
            holders.pop(name, None)
            if not holders and uid not in self._done_units:
                del self._assignees[uid]
                # reclaimed work goes to the queue front: it has been
                # waiting longest and may gate grid completion
                self._queue.appendleft(uid)

    def _disconnect(self, node: str) -> None:
        with self._lock:
            self._drop_node(node)

    def _assign(self, uid: int, info: _NodeInfo) -> dict:
        self._assignees.setdefault(uid, {})[info.name] = self._clock()
        info.inflight.add(uid)
        self._grid_nodes.add(info.name)
        return {"op": "unit", "epoch": self._epoch, "uid": uid,
                "cells": self._units[uid]}

    def _next_for(self, info: _NodeInfo) -> dict:
        if self._queue:
            return self._assign(self._queue.popleft(), info)
        # queue drained: steal — speculatively duplicate the unit that
        # has been outstanding longest on some other node (pure cells
        # make duplicates value-neutral; first result wins)
        if self.max_speculate:
            candidates = [
                (min(holders.values()), uid)
                for uid, holders in self._assignees.items()
                if holders and uid not in self._done_units
                and info.name not in holders
                and len(holders) <= self.max_speculate]
            if candidates:
                self._steals += 1
                return self._assign(min(candidates)[1], info)
        if self._grid_done.is_set():
            return {"op": "drain", "epoch": self._epoch}
        return {"op": "wait", "for_s": 0.2}

    def _record(self, node: str, uid: int, results: list) -> None:
        info = self._nodes.get(node)
        if info is not None:
            info.inflight.discard(uid)
        holders = self._assignees.pop(uid, None) or {}
        for other in holders:
            other_info = self._nodes.get(other)
            if other_info is not None:
                other_info.inflight.discard(uid)
        if uid in self._done_units:
            self._duplicates += 1        # speculative duplicate: dropped
            return
        self._done_units.add(uid)
        for r in results:
            self._done_cells[(r.scenario, r.technique, r.seed)] = r
        if len(self._done_cells) == len(self._expected):
            self._grid_done.set()

    def _record_failure(self, node: str, uid: int, detail: str) -> None:
        """A node ran a unit and the unit itself raised (as opposed to
        the node dying): requeue for a bounded number of attempts, then
        poison the grid — a deterministic cell error would otherwise
        bounce between nodes forever."""
        info = self._nodes.get(node)
        if info is not None:
            info.inflight.discard(uid)
        holders = self._assignees.get(uid)
        if holders is not None:
            holders.pop(node, None)
        if uid in self._done_units:
            return
        self._failures[uid] = self._failures.get(uid, 0) + 1
        if self._failures[uid] >= self.max_unit_failures:
            self._grid_error = (
                f"unit {uid} ({self._units.get(uid)}) failed "
                f"{self._failures[uid]}x across nodes; last: {detail}")
            self._grid_done.set()
            return
        if not holders and uid not in self._queue:
            self._assignees.pop(uid, None)
            self._queue.appendleft(uid)

    # ------------------------------ dispatch ----------------------------

    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        node = str(msg.get("node", ""))
        with self._lock:
            self._reap(self._clock())
            if op == "hello":
                self._touch(node, msg.get("lanes"))
                return {"op": "welcome", "epoch": self._epoch,
                        "lease_s": self.lease_s}
            info = self._touch(node)
            if op == "heartbeat":
                return {"op": "ack"}
            if op == "bye":
                self._drop_node(node)
                return {"op": "ack"}
            if op == "result":
                self._record(node, int(msg["uid"]),
                             list(msg["results"]))
                return {"op": "ack"}
            if op == "failed":
                self._record_failure(node, int(msg["uid"]),
                                     str(msg.get("detail", "")))
                return {"op": "ack"}
            if op == "request":
                if self._spec is None:
                    return {"op": "wait", "for_s": 0.2}
                if int(msg.get("epoch", -1)) != self._epoch:
                    # new grid: ship spec + payloads (+ libraries) and
                    # the thread count once, then the node re-requests
                    # with the fresh epoch
                    return {"op": "grid", "epoch": self._epoch,
                            "spec": self._spec,
                            "payloads": self._payload_blob,
                            "cache_files": self._cache_files,
                            "threads": self._threads}
                return self._next_for(info)
        return {"op": "error", "detail": f"unknown op {op!r}"}


# ------------------------------ node agent ---------------------------------

class FabricWorker:
    """Per-machine node agent: pulls units, runs them, streams results.

    ``lanes=1`` runs cells in-process (the agent process is the lane);
    ``lanes>1`` drives a local spawned process pool, so one agent per
    machine saturates its cores.  The agent heartbeats at
    ``lease_s / 3`` while computing so long units never look like a
    dead node.

    Each grid reply sets the agent's torch thread count to the
    coordinator's (its local pool's workers take it too), then builds the
    kernels the grid needs before any lane starts, so lanes load the
    libraries instead of racing ``nvcc``.  If that fails (a technique on
    ``cuda`` and no card here), every unit of the grid is reported
    ``failed`` with the error, never run elsewhere.

    ``run()`` returns when the coordinator goes away (after
    ``reconnect_tries`` failed reconnects) or — with
    ``exit_on_drain=True`` — when the current grid drains.  Long-lived
    agents (``exit_on_drain=False``) idle-poll and pick up the next
    grid, surviving coordinator restarts in between.
    """

    def __init__(self, host: str, port: int, node: str | None = None,
                 lanes: int = 1, exit_on_drain: bool = True,
                 reconnect_tries: int = 20, reconnect_delay_s: float = 0.5,
                 backoff_cap_s: float = 5.0, request_tries: int = 4,
                 io_timeout_s: float = 30.0):
        self.host, self.port = host, int(port)
        self.node = node or f"{socket.gethostname()}-{uuid.uuid4().hex[:8]}"
        self.lanes = max(1, int(lanes))
        self.exit_on_drain = exit_on_drain
        self.reconnect_tries = int(reconnect_tries)
        self.reconnect_delay_s = float(reconnect_delay_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.request_tries = max(1, int(request_tries))
        self.io_timeout_s = float(io_timeout_s)
        #: seeded per node name: the jittered backoff sequence replays
        #: under the chaos harness
        self._rng = random.Random(self.node)
        self._file = None
        self._io_lock = threading.Lock()
        self._stop = threading.Event()
        self._lease_s = 60.0
        self._epoch = -1
        self._spec: SweepSpec | None = None
        self._payloads: dict = {}
        self._threads = torch.get_num_threads()
        #: why this node cannot run the current grid's units, if it can't
        self._unit_error: str | None = None
        self._pool: cf.ProcessPoolExecutor | None = None
        self._pool_threads = 0
        self.units_done = 0
        self.cells_done = 0

    # ------------------------------ transport ---------------------------

    def _backoff(self, attempt: int) -> float:
        """Capped exponential backoff with jitter: retry storms from a
        fleet of reconnecting nodes must not synchronize on a healing
        coordinator."""
        base = min(self.reconnect_delay_s * (2.0 ** attempt),
                   self.backoff_cap_s)
        return base * (0.5 + 0.5 * self._rng.random())

    def _drop_conn(self) -> None:
        with self._io_lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def _connect(self) -> None:
        last = None
        for attempt in range(max(1, self.reconnect_tries)):
            try:
                sock = socket.create_connection((self.host, self.port),
                                                timeout=self.io_timeout_s)
                self._file = sock.makefile("rwb")
                resp = self._send_recv({"op": "hello", "node": self.node,
                                        "lanes": self.lanes})
                self._lease_s = float(resp.get("lease_s", 60.0))
                return
            except OSError as e:
                last = e
                self._file = None
                if self._stop.wait(self._backoff(attempt)):
                    break
        raise ConnectionError(
            f"coordinator {self.host}:{self.port} unreachable") from last

    def _send_recv(self, msg: dict) -> dict:
        # one lock around the send+recv pair: the heartbeat thread and
        # the main loop share this socket and frames must not interleave
        with self._io_lock:
            if self._file is None:
                raise ConnectionError("not connected")
            send_frame(self._file, msg)
            resp = recv_frame(self._file)
        if resp is None:
            raise ConnectionError("coordinator closed the connection")
        if resp.get("op") == "error":
            # the coordinator refused the frame (corrupt in flight, MAC
            # reject, ...) and is about to close: the stream past this
            # point is unusable, so treat it like a broken connection
            raise ProtocolError(
                f"coordinator error: {resp.get('detail', '')}")
        return resp

    def _request(self, msg: dict) -> dict:
        """One request with bounded reconnect-and-retry.

        Every fabric op is idempotent on the coordinator — duplicate
        ``result``s are dropped first-wins, re-``request``s just lease
        another unit, lost in-flight units come back via lease reclaim
        — so resending after a corrupt frame, an RST, or a lost
        response is always safe.
        """
        last: Exception | None = None
        for attempt in range(self.request_tries):
            if attempt:
                self._drop_conn()
                if self._stop.wait(self._backoff(attempt - 1)):
                    break
                self._connect()       # ConnectionError when gone for good
            try:
                return self._send_recv(msg)
            except (ConnectionError, ProtocolError, OSError) as e:
                last = e
        raise ConnectionError(
            f"request {msg.get('op')!r} failed after "
            f"{self.request_tries} attempts") from last

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(max(self._lease_s / 3.0, 0.05)):
            try:
                self._send_recv({"op": "heartbeat", "node": self.node})
            except (ConnectionError, ProtocolError, OSError):
                pass                     # main loop owns reconnection

    # ------------------------------ execution ---------------------------

    def _install_grid(self, resp: dict) -> None:
        self._epoch = int(resp["epoch"])
        self._spec = resp["spec"]
        self._payloads = pickle.loads(resp["payloads"])
        install_cache_files(resp.get("cache_files") or {})
        self._threads = int(resp["threads"])
        torch.set_num_threads(self._threads)
        if self._pool is not None and self._pool_threads != self._threads:
            self._pool.shutdown(wait=True)    # respawned at the next unit
            self._pool = None
        try:
            _sweep._prebuild_kernels(self._spec)
            self._unit_error = None
        except Exception as e:      # reported with every unit, not run
            self._unit_error = f"{type(e).__name__}: {e}"

    def _local_pool(self) -> cf.ProcessPoolExecutor:
        if self._pool is None:
            import multiprocessing
            ctx = multiprocessing.get_context("spawn")
            self._pool = cf.ProcessPoolExecutor(
                max_workers=self.lanes, mp_context=ctx,
                initializer=_sweep._worker_init,
                initargs=(self._threads,))
            self._pool_threads = self._threads
        return self._pool

    def _report(self, uid: int, results: list | None,
                err: str | None) -> bool:
        """Stream one unit's outcome back; False when the coordinator
        is unreachable (caller stops serving)."""
        try:
            if err is not None:
                self._request({"op": "failed", "node": self.node,
                               "uid": uid, "detail": err})
            else:
                self.units_done += 1
                self.cells_done += len(results)
                self._request({"op": "result", "node": self.node,
                               "uid": uid, "results": results})
            return True
        except ConnectionError:
            return False

    def _harvest(self, inflight: dict, block: bool) -> bool:
        """Collect finished local-pool futures, streaming each unit's
        results immediately; False on lost coordinator."""
        if block and inflight:
            cf.wait(list(inflight), timeout=0.5,
                    return_when=cf.FIRST_COMPLETED)
        for fut in [f for f in list(inflight) if f.done()]:
            uid, cells = inflight.pop(fut)
            try:
                results, err = fut.result(), None
            except cf.process.BrokenProcessPool:
                # a local lane died: respawn lazily and run the unit in
                # the agent itself — fabric-level reclaim never sees it
                if self._pool is not None:
                    self._pool.shutdown(wait=False)
                    self._pool = None
                try:
                    results, err = _sweep._run_unit(
                        self._spec, cells, self._payloads), None
                except Exception as e:
                    results, err = None, f"{type(e).__name__}: {e}"
            except Exception as e:       # the cell itself raised
                results, err = None, f"{type(e).__name__}: {e}"
            if not self._report(uid, results, err):
                return False
        return True

    def run(self) -> int:
        """Serve until drain/stop; returns the number of cells run.

        ``lanes`` units are kept in flight on the local pool at once
        (one, run inline, when ``lanes == 1``), and every finished
        unit's results stream back immediately — the coordinator's
        partial grid grows while the node keeps computing."""
        self._connect()
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
        hb.start()
        inflight: dict = {}              # future -> (uid, cells)
        draining = False
        try:
            while not self._stop.is_set():
                if not self._harvest(inflight, block=False):
                    break
                if draining:
                    if not inflight:
                        break
                    if not self._harvest(inflight, block=True):
                        break
                    continue
                if len(inflight) >= self.lanes:
                    if not self._harvest(inflight, block=True):
                        break
                    continue
                try:
                    resp = self._request({"op": "request",
                                          "node": self.node,
                                          "epoch": self._epoch})
                except ConnectionError:
                    break                # coordinator is gone for good
                op = resp.get("op")
                if op == "grid":
                    self._install_grid(resp)
                elif op == "unit":
                    if self._unit_error is not None:
                        if not self._report(resp["uid"], None,
                                            self._unit_error):
                            break
                    elif self.lanes == 1:
                        try:
                            results, err = self._run_inline(
                                resp["cells"]), None
                        except Exception as e:
                            results = None
                            err = f"{type(e).__name__}: {e}"
                        if not self._report(resp["uid"], results, err):
                            break
                    else:
                        fut = self._local_pool().submit(
                            _sweep._run_unit_star,
                            (self._spec, resp["cells"], self._payloads))
                        inflight[fut] = (resp["uid"], resp["cells"])
                elif op == "wait":
                    if inflight:
                        self._harvest(inflight, block=True)
                    elif self._stop.wait(float(resp.get("for_s", 0.2))):
                        break
                elif op == "drain":
                    if self.exit_on_drain:
                        draining = True
                    elif self._stop.wait(0.2):
                        break
                else:
                    raise ProtocolError(f"unexpected response {resp!r}")
        finally:
            self._stop.set()
            self._say_bye()
            if self._pool is not None:
                # wait: a lane still starting up when the pool's queues
                # are collected dies rebuilding their semaphores, and the
                # agent's exit then waits on it forever
                self._pool.shutdown(wait=True, cancel_futures=True)
                self._pool = None
        return self.cells_done

    def _run_inline(self, cells: tuple) -> list:
        return _sweep._run_unit(self._spec, cells, self._payloads)

    def _say_bye(self) -> None:
        try:
            if self._file is not None:
                self._send_recv({"op": "bye", "node": self.node})
                self._file.close()
        except (ConnectionError, ProtocolError, OSError):
            pass

    def stop(self) -> None:
        self._stop.set()


def worker_main(host: str, port: int, node: str | None = None,
                lanes: int = 1, exit_on_drain: bool = True) -> int:
    """Top-level node-agent entry point (picklable: benchmarks and tests
    spawn it via ``multiprocessing``)."""
    return FabricWorker(host, port, node=node, lanes=lanes,
                        exit_on_drain=exit_on_drain).run()


# ---------------------------------- CLI ------------------------------------

def _parse_bind(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def _spec_from_json(path: str) -> SweepSpec:
    with open(path) as f:
        fields = json.load(f)
    known = {f.name for f in dataclasses.fields(SweepSpec)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown SweepSpec fields {sorted(unknown)}")
    for key in ("techniques", "seeds", "scenarios", "metrics"):
        if key in fields:
            fields[key] = tuple(fields[key])
    return SweepSpec(**fields)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.fabric",
        description="Distributed sweep fabric: coordinator and node agent")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("coordinator",
                       help="serve a grid to remote node agents")
    c.add_argument("--spec", required=True,
                   help="SweepSpec fields as JSON")
    c.add_argument("--bind", default="127.0.0.1:0",
                   help="HOST:PORT (port 0 = pick free; set "
                        "REPRO_FABRIC_KEY on every machine to "
                        "HMAC-authenticate frames before binding "
                        "beyond loopback — frames are pickle)")
    c.add_argument("--lease", type=float, default=60.0)
    c.add_argument("--lanes-hint", type=int, default=8)
    c.add_argument("--ship-cache", action="store_true")
    w = sub.add_parser("worker", help="node agent: pull and run units")
    w.add_argument("--connect", required=True, help="HOST:PORT")
    w.add_argument("--lanes", type=int, default=os.cpu_count() or 1)
    w.add_argument("--node", default=None)
    w.add_argument("--stay", action="store_true",
                   help="idle after drain and serve later grids")
    args = ap.parse_args(argv)

    if args.cmd == "coordinator":
        spec = _spec_from_json(args.spec)
        host, port = _parse_bind(args.bind)
        coord = FabricCoordinator(host, port, lease_s=args.lease,
                                  lanes_hint=args.lanes_hint,
                                  ship_cache=args.ship_cache).start()
        print(f"fabric coordinator on {coord.host}:{coord.port} "
              f"({len(spec.cells())} cells); waiting for workers",
              flush=True)
        try:
            res = coord.run_grid(spec)
        finally:
            coord.stop()
        print(f"grid complete: {len(res.cells)} cells in "
              f"{res.wall_s:.1f}s over {res.n_workers} node(s)")
        return 0
    host, port = _parse_bind(args.connect)
    n = worker_main(host, port, node=args.node, lanes=args.lanes,
                    exit_on_drain=not args.stay)
    print(f"node agent done: {n} cells")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
