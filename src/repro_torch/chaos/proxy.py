"""In-process TCP chaos proxy: seeded, per-direction fault injection (a
copy of the JAX package's ``repro.chaos.proxy``).

The proxy accepts client connections, dials the real upstream, and
pumps bytes both ways; every forwarded chunk first passes a
:class:`FaultPlan` which may

  * ``drop``      — discard the chunk (the peer stalls until its own
                    read timeout, then recovers by reconnecting);
  * ``delay``     — hold the chunk for a sampled interval;
  * ``duplicate`` — forward it twice (stresses idempotence: retried
                    results, replayed requests);
  * ``truncate``  — forward only the first half (desyncs the stream:
                    the next frame decode fails and forces a reconnect);
  * ``corrupt``   — flip bytes (an authenticated receiver must reject
                    the frame *before* deserializing it);
  * ``reset``     — forward half the chunk, then hard-close both sides
                    with ``SO_LINGER(0)`` so the peer sees an RST
                    mid-frame;
  * ``stall``     — a one-shot long hold (``stall_after``/``stall_s``),
                    claimed by the first stream to reach the trigger
                    chunk — how a drill makes exactly one stream go
                    silent past its peer's timeout.

Determinism: each (connection, direction) stream draws its decisions
from its own ``random.Random`` seeded with ``(seed, conn, direction)``,
so a stream's fault sequence replays exactly for a given seed and
connection order; ``FaultPlan.script`` pins faults to exact per-stream
chunk indexes when a test needs "reset at frame 3" rather than a rate.
Either way the proxy records the *realized* schedule — every injected
fault with its stream, chunk index and detail — and
:meth:`ChaosProxy.dump_artifact` writes it as JSON, which is what a
drill keeps when it reproduces a failure.

Fault budgets: ``max_faults`` bounds total injections across the plan
(streams created after the budget is spent pass bytes through
untouched), so a drill is guaranteed to quiesce and the system-level
invariant — grid bitwise-equal to serial, no snapshot double-applied —
can be asserted after recovery.  ``skip_first`` lets per-stream
handshakes (hello / grid shipping) through before injection starts.
"""
from __future__ import annotations

import dataclasses
import json
import random
import socket
import socketserver
import struct
import threading
import time

_FAULT_KINDS = ("drop", "delay", "duplicate", "truncate", "corrupt",
                "reset")


@dataclasses.dataclass
class FaultPlan:
    """Per-direction fault rates and scripts (shared by every stream in
    that direction; counters live on the plan, RNGs on the stream)."""

    drop: float = 0.0
    delay: float = 0.0
    duplicate: float = 0.0
    truncate: float = 0.0
    corrupt: float = 0.0
    reset: float = 0.0
    #: sampled uniformly for each injected delay
    delay_s: tuple[float, float] = (0.005, 0.05)
    #: one-shot stall: the first stream whose chunk counter reaches
    #: ``stall_after`` holds traffic for ``stall_s`` seconds (make it
    #: longer than a peer's timeout to make a live peer look dead)
    stall_after: int | None = None
    stall_s: float = 0.0
    #: total injections across all streams of this plan; ``None`` =
    #: unbounded.  A bounded budget guarantees the drill quiesces.
    max_faults: int | None = None
    #: per-stream chunks passed through before any injection
    skip_first: int = 0
    #: exact schedule: {chunk_index: (kind, param)} applied before (and
    #: regardless of) the stochastic rates.  Each entry is **one-shot**
    #: and claimed by the first stream whose chunk counter reaches it —
    #: otherwise every post-reset reconnect would replay the script and
    #: a scripted ``reset`` could livelock the drill forever.
    script: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._lock = threading.Lock()
        self._faults = 0
        self._stall_claimed = False

    def faults_injected(self) -> int:
        with self._lock:
            return self._faults

    def _charge(self) -> bool:
        """Reserve one unit of fault budget (caller holds the lock)."""
        if self.max_faults is not None and self._faults >= self.max_faults:
            return False
        self._faults += 1
        return True

    def decide(self, rng: random.Random, chunk_i: int) -> tuple:
        """The fault decision for one forwarded chunk: ``(kind, param)``
        where kind is ``"pass"`` or one of the fault kinds."""
        with self._lock:
            if chunk_i in self.script:
                kind, param = self.script.pop(chunk_i)   # one-shot
                if kind == "stall" and not self._stall_claimed:
                    self._stall_claimed = True
                self._faults += 1
                return (kind, param)
            if (self.stall_after is not None and not self._stall_claimed
                    and chunk_i >= self.stall_after):
                self._stall_claimed = True
                self._faults += 1
                return ("stall", self.stall_s)
            if chunk_i < self.skip_first:
                return ("pass", None)
            u = rng.random()
            for kind in _FAULT_KINDS:
                p = getattr(self, kind)
                if u < p:
                    if not self._charge():
                        return ("pass", None)
                    if kind == "delay":
                        return ("delay", rng.uniform(*self.delay_s))
                    if kind == "corrupt":
                        # corruption positions come from their own
                        # seeded stream so the flipped bytes replay too
                        return ("corrupt", rng.randrange(1 << 30))
                    return (kind, None)
                u -= p
            return ("pass", None)

    def summary(self) -> dict:
        return {k: getattr(self, k) for k in
                (*_FAULT_KINDS, "stall_after", "stall_s", "max_faults",
                 "skip_first")}


def _corrupted(data: bytes, seed: int) -> bytes:
    rng = random.Random(seed)
    b = bytearray(data)
    for _ in range(1 + rng.randrange(3)):
        b[rng.randrange(len(b))] ^= 0xFF
    return bytes(b)


def _hard_reset(sock: socket.socket) -> None:
    """Close with SO_LINGER(0): the peer sees an RST, not a FIN."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        proxy: ChaosProxy = self.server.proxy          # type: ignore
        conn = proxy._next_conn()
        try:
            upstream = socket.create_connection(proxy.upstream,
                                                timeout=30.0)
        except OSError:
            return                   # upstream down: client sees EOF
        pumps = [
            threading.Thread(
                target=proxy._pump, daemon=True,
                args=(self.request, upstream, proxy.c2s,
                      conn, "c2s")),
            threading.Thread(
                target=proxy._pump, daemon=True,
                args=(upstream, self.request, proxy.s2c,
                      conn, "s2c")),
        ]
        for t in pumps:
            t.start()
        for t in pumps:
            t.join()
        for s in (upstream, self.request):
            try:
                s.close()
            except OSError:
                pass


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ChaosProxy:
    """TCP proxy injecting a seeded fault schedule between a client and
    ``upstream``; see the module docstring for semantics.

    Args:
        upstream: ``(host, port)`` of the real server.
        seed: seeds every stream's decision RNG.
        c2s / s2c: per-direction :class:`FaultPlan` (default:
            pass-through).
        host/port: proxy bind (``port=0`` picks a free one; read
            ``.port`` back and point the client at it).
    """

    def __init__(self, upstream: tuple[str, int], seed: int = 0,
                 c2s: FaultPlan | None = None,
                 s2c: FaultPlan | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream = (upstream[0], int(upstream[1]))
        self.seed = int(seed)
        self.c2s = c2s or FaultPlan()
        self.s2c = s2c or FaultPlan()
        self.events: list[dict] = []
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._conns = 0
        self._server = _Server((host, port), _Handler)
        self._server.proxy = self                      # type: ignore
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05}, daemon=True)

    # ------------------------------ lifecycle ---------------------------

    def start(self) -> "ChaosProxy":
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def quiesce(self) -> None:
        """Stop injecting (existing and future streams pass through) —
        drills call this before asserting post-recovery invariants."""
        for plan in (self.c2s, self.s2c):
            with plan._lock:
                plan.max_faults = plan._faults

    # ------------------------------ internals ---------------------------

    def _next_conn(self) -> int:
        with self._lock:
            self._conns += 1
            return self._conns - 1

    def _record(self, conn: int, direction: str, chunk_i: int,
                kind: str, param, n_bytes: int) -> None:
        with self._lock:
            self.events.append({
                "t": round(time.monotonic() - self._t0, 6),
                "conn": conn, "dir": direction, "chunk": chunk_i,
                "fault": kind, "param": param, "bytes": n_bytes})

    def _pump(self, src: socket.socket, dst: socket.socket,
              plan: FaultPlan, conn: int, direction: str) -> None:
        rng = random.Random(f"{self.seed}/{conn}/{direction}")
        chunk_i = 0
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                kind, param = plan.decide(rng, chunk_i)
                if kind != "pass":
                    self._record(conn, direction, chunk_i, kind, param,
                                 len(data))
                if kind == "drop":
                    pass
                elif kind == "delay" or kind == "stall":
                    time.sleep(float(param or 0.0))
                    dst.sendall(data)
                elif kind == "duplicate":
                    dst.sendall(data)
                    dst.sendall(data)
                elif kind == "truncate":
                    dst.sendall(data[:max(1, len(data) // 2)])
                elif kind == "corrupt":
                    dst.sendall(_corrupted(data, int(param)))
                elif kind == "reset":
                    try:
                        dst.sendall(data[:max(1, len(data) // 2)])
                    except OSError:
                        pass
                    _hard_reset(dst)
                    _hard_reset(src)
                    return
                else:
                    dst.sendall(data)
                chunk_i += 1
        except OSError:
            pass
        finally:
            # half-close so the peer's pending read sees EOF
            for s in (dst, src):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    # ------------------------------ artifact ----------------------------

    def artifact(self) -> dict:
        """The realized fault schedule (JSON-serializable)."""
        with self._lock:
            return {
                "seed": self.seed,
                "upstream": list(self.upstream),
                "plans": {"c2s": self.c2s.summary(),
                          "s2c": self.s2c.summary()},
                "connections": self._conns,
                "events": list(self.events),
            }

    def dump_artifact(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.artifact(), f, indent=1)
        return path
