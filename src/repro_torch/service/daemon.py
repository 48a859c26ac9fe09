"""Transports for the prediction service: threads, TCP, clients (a copy of
the JAX package's ``repro.service.daemon`` over the port's service).

``ServiceDaemon`` owns a :class:`PredictionService` plus

  * a **batch worker** thread: waits up to ``batch_window`` seconds for
    snapshots to queue, then runs one ``tick()`` — many tenants arriving
    within a window share one device dispatch;
  * a **stdlib TCP server** (``socketserver.ThreadingTCPServer``)
    speaking JSON-lines — one connection per tenant, requests answered
    in order on that connection;
  * an optional **retrain** thread that runs a
    retrain/shadow-eval/promote cycle whenever the service flags one due
    (``retrain_every`` snapshots) or the cron-style wall-clock scheduler
    (:class:`RetrainScheduler`, ``retrain_interval_s`` seconds of
    monotonic time) fires — slow tenants still get periodically
    refreshed models.

``LocalClient`` drives the same service in-process with zero transport
(the simulator / tests path); ``ServiceClient`` is the TCP twin with an
identical surface, so swapping transports is a one-line change.
"""
from __future__ import annotations

import dataclasses
import os
import random
import socket
import socketserver
import sys
import threading
import time

from repro_torch.service import protocol
from repro_torch.service.core import PredictionService, ServiceConfig


class RetrainScheduler:
    """Cron-style wall-clock retrain trigger.

    Marks a retrain due every ``interval_s`` seconds of **monotonic**
    time (never the wall calendar — NTP steps and suspend/resume must
    not double- or never-fire).  Missed periods coalesce: if a slow fit
    (or a suspended laptop) swallows three periods, the next
    :meth:`due` poll fires once and re-arms ``interval_s`` from *now*,
    so there is never a catch-up burst of back-to-back retrains.

    The clock is injectable so tests drive it deterministically with a
    fake; production uses :func:`time.monotonic`.
    """

    def __init__(self, interval_s: float, clock=time.monotonic):
        self.interval_s = float(interval_s)
        self.clock = clock
        self._next = (self.clock() + self.interval_s
                      if self.interval_s > 0 else None)

    @property
    def enabled(self) -> bool:
        return self._next is not None

    def due(self) -> bool:
        """Poll: True exactly once per elapsed period, then re-arm."""
        if self._next is None:
            return False
        now = self.clock()
        if now < self._next:
            return False
        self._next = now + self.interval_s
        return True


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        svc: PredictionService = self.server.service  # type: ignore
        self.server.track(self.connection)            # type: ignore
        for msg in protocol.recv_lines(self.rfile):
            if msg is protocol.OVERSIZE:
                # a peer that never sends \n: answer once and drop the
                # connection — the stream cannot be resynchronized
                try:
                    self.wfile.write(protocol.encode(protocol.error(
                        "frame-too-long",
                        f"line exceeded {protocol.MAX_LINE} bytes")))
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass
                return
            if msg is None:
                resp = protocol.error("bad-frame", "not a JSON object")
            else:
                # enqueue only; the shared batch worker resolves it —
                # that is what coalesces concurrent tenants into one
                # dispatch
                resp = svc.handle(msg, auto_tick=False,
                                  timeout=self.server.timeout_s)
            try:
                self.wfile.write(protocol.encode(resp))
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                return
            if msg is not None and msg.get("op") == "bye":
                return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def handle_error(self, request, client_address):
        # A peer that vanishes mid-request (crash, injected RST) is an
        # expected event for a long-running daemon, not a bug worth a
        # traceback on stderr; everything else keeps the default dump.
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, BrokenPipeError)):
            return
        super().handle_error(request, client_address)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def track(self, sock) -> None:
        with self._conns_lock:
            self._conns.add(sock)

    def close_all_connections(self) -> None:
        """Sever live client connections so a stopping daemon looks
        dead to its tenants immediately — reconnecting clients fail
        over to the restarted instance instead of hanging on a socket
        whose handler thread will never answer again."""
        with self._conns_lock:
            conns, self._conns = self._conns, set()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class ServiceDaemon:
    """Long-running serving process (in one Python process).

    Args:
        cfg: service configuration (profile, queues, retraining).
        host/port: TCP bind address; ``port=0`` picks a free port
            (read it back from ``.port``).  ``port=None`` disables the
            TCP listener (in-process only).
        batch_window: seconds the batch worker waits for more tenants
            before dispatching a tick.
        retrain_clock: monotonic clock the wall-clock retrain scheduler
            reads (tests inject a fake; ``None`` = ``time.monotonic``).
    """

    def __init__(self, cfg: ServiceConfig, host: str = "127.0.0.1",
                 port: int | None = 0, batch_window: float = 0.002,
                 timeout_s: float = 30.0, retrain_clock=None):
        if cfg.auth_token is None:
            token = os.environ.get("REPRO_SERVICE_TOKEN")
            if token:
                cfg = dataclasses.replace(cfg, auth_token=token)
        self.service = PredictionService(cfg)
        self.retrain_scheduler = RetrainScheduler(
            getattr(cfg, "retrain_interval_s", 0.0),
            clock=retrain_clock or time.monotonic)
        self.batch_window = batch_window
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._worker = threading.Thread(target=self._run_worker,
                                        daemon=True)
        self._retrainer = threading.Thread(target=self._run_retrainer,
                                           daemon=True)
        self._server = None
        self._server_thread = None
        self.host, self.port = host, None
        if port is not None:
            self._server = _Server((host, port), _Handler)
            self._server.service = self.service       # type: ignore
            self._server.timeout_s = timeout_s        # type: ignore
            self.port = self._server.server_address[1]
            self._server_thread = threading.Thread(
                target=self._server.serve_forever,
                kwargs={"poll_interval": 0.05}, daemon=True)
        # submissions kick the worker so an idle service answers within
        # one batch window, not one polling period
        _orig_submit = self.service.submit

        def _submit(tenant, snap):
            p = _orig_submit(tenant, snap)
            self._kick.set()
            return p
        self.service.submit = _submit                 # type: ignore

    # ------------------------------ lifecycle ---------------------------

    def start(self) -> "ServiceDaemon":
        self._worker.start()
        self._retrainer.start()
        if self._server_thread is not None:
            self._server_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.close_all_connections()
            self._server.server_close()
        self._worker.join(timeout=5)
        self._retrainer.join(timeout=5)
        # resolve anything still queued so no client hangs
        with self.service.lock:
            while self.service.pending:
                self.service.pending.popleft().resolve(
                    protocol.error("shutdown", "daemon stopping"))

    def __enter__(self) -> "ServiceDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------ threads -----------------------------

    def _run_worker(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(timeout=0.25)
            self._kick.clear()
            if self._stop.is_set():
                return
            # batch window: let concurrent tenants pile in, then one tick
            if self.batch_window:
                self._stop.wait(self.batch_window)
            while self.service.tick():
                pass

    def _run_retrainer(self) -> None:
        while not self._stop.wait(0.05):
            # the wall-clock scheduler latches the same due-flag the
            # snapshot-count trigger uses, so both routes share one
            # retrain/shadow-eval/promote pipeline (and its guards:
            # min_train_pairs, eval holdback, promotion tolerance)
            if self.retrain_scheduler.due():
                self.service._retrain_due = True
            if self.service._retrain_due:
                try:
                    self.service.retrain_now()
                except Exception as e:
                    # never kill the retrainer thread — but never
                    # swallow the failure either: it lands in stats()
                    # (retrain_failures + last_retrain_error) and the
                    # due-flag clears so a poisoned buffer can't spin
                    self.service.note_retrain_failure(e)

    # ------------------------------ convenience -------------------------

    def local_client(self, tenant: str) -> "LocalClient":
        return LocalClient(self.service, tenant)

    def tcp_client(self, tenant: str) -> "ServiceClient":
        if self.port is None:
            raise RuntimeError("daemon started without a TCP listener")
        return ServiceClient(self.host, self.port, tenant)


class LocalClient:
    """In-process handle: same request surface as the TCP client, no
    transport.  ``auto_tick`` answers synchronously when no daemon
    worker is running (plain ``PredictionService`` use)."""

    def __init__(self, service: PredictionService, tenant: str,
                 auto_tick: bool | None = None,
                 token: str | None = None):
        self.service = service
        self.tenant = tenant
        self.token = (token if token is not None
                      else os.environ.get("REPRO_SERVICE_TOKEN"))
        if auto_tick is None:
            # a daemon replaces service.submit with a kicking wrapper
            # (a plain function, not a bound method); its batch worker
            # then owns the ticking
            auto_tick = getattr(service.submit, "__func__",
                                None) is PredictionService.submit
        self.auto_tick = auto_tick

    def request(self, msg: dict, timeout: float = 30.0) -> dict:
        return self.service.handle(msg, auto_tick=self.auto_tick,
                                   timeout=timeout)

    def hello(self, profile) -> dict:
        msg = {"op": "hello", "tenant": self.tenant,
               "profile": profile.to_wire()}
        if self.token is not None:
            msg["token"] = self.token
        return self.request(msg)

    def snapshot(self, snap: dict) -> dict:
        snap = dict(snap)
        snap["op"] = "snapshot"
        snap["tenant"] = self.tenant
        return self.request(snap)

    def stats(self) -> dict:
        return self.request({"op": "stats"})

    def retrain(self) -> dict:
        return self.request({"op": "retrain"})

    def rollback(self) -> dict:
        return self.request({"op": "rollback"})

    def bye(self) -> dict:
        return self.request({"op": "bye", "tenant": self.tenant})

    def close(self) -> None:
        pass


#: ops the client may safely resend after a transport failure: hello is
#: a rejoin, snapshots are seq-deduped server-side (a retried snapshot
#: is answered from the cached response, never applied twice), stats
#: and bye are read-only/terminal.  retrain and rollback are NOT here —
#: resending either could run the state machine twice.
_RETRY_SAFE = frozenset({"hello", "snapshot", "stats", "bye"})

#: server answers that mean "your request never arrived intact" — safe
#: to resend a retry-safe op on the same connection
_TRANSPORT_ERRORS = frozenset({"bad-frame", "frame-too-long"})


class ServiceClient:
    """Reconnecting JSON-lines TCP client (one socket, ordered replies).

    Transport failures — connection reset, EOF, an undecodable reply, a
    server-side ``bad-frame`` answer — are healed transparently for
    retry-safe ops: the client redials with capped exponential backoff
    plus jitter, replays its ``hello`` (the server treats it as a
    rejoin), and resends the request.  Snapshots are tagged with the
    tenant's ``seq``, and the server caches its last answer per tenant,
    so a resend of an already-applied snapshot returns the cached
    answer instead of being applied twice.  ``retrain``/``rollback``
    are never resent; a failure there surfaces as ``ConnectionError``.

    ``request(timeout=...)`` applies a **per-request socket timeout**;
    on expiry the connection is dropped (a late reply would desync the
    stream) and ``TimeoutError`` is raised.
    """

    def __init__(self, host: str, port: int, tenant: str,
                 timeout: float = 30.0, token: str | None = None,
                 retries: int = 3, backoff_s: float = 0.1,
                 backoff_cap_s: float = 2.0):
        self.host, self.port = host, int(port)
        self.tenant = tenant
        self.token = (token if token is not None
                      else os.environ.get("REPRO_SERVICE_TOKEN"))
        self.timeout = float(timeout)
        self.retries = max(1, int(retries))
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._rng = random.Random(f"{tenant}@{host}:{port}")
        self._profile_wire: dict | None = None
        self._sock = None
        self._file = None
        self._dial()

    # ------------------------------ transport ---------------------------

    def _dial(self) -> None:
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        self._file = self._sock.makefile("rwb")

    def _drop(self) -> None:
        for o in (self._file, self._sock):
            try:
                if o is not None:
                    o.close()
            except OSError:
                pass
        self._file = self._sock = None

    def _backoff(self, attempt: int) -> float:
        base = min(self.backoff_s * (2.0 ** attempt), self.backoff_cap_s)
        return base * (0.5 + 0.5 * self._rng.random())

    def _reconnect(self) -> None:
        last: Exception | None = None
        for attempt in range(self.retries):
            try:
                self._dial()
                if self._profile_wire is not None:
                    # rejoin before resuming traffic: a restarted daemon
                    # has no tenant state until it sees our hello again
                    resp = self._roundtrip(self._hello_msg(), None)
                    if not resp.get("ok"):
                        raise ConnectionError(
                            f"rejoin refused: {resp.get('error')}")
                return
            except (OSError, ValueError) as e:
                last = e
                self._drop()
                time.sleep(self._backoff(attempt))
        raise ConnectionError(
            f"service {self.host}:{self.port} unreachable") from last

    def _roundtrip(self, msg: dict, timeout: float | None) -> dict:
        if self._file is None:
            raise ConnectionError("not connected")
        if timeout is not None:
            self._sock.settimeout(timeout)
        try:
            self._file.write(protocol.encode(msg))
            self._file.flush()
            line = self._file.readline(protocol.MAX_LINE + 1)
        finally:
            if timeout is not None and self._sock is not None:
                try:
                    self._sock.settimeout(self.timeout)
                except OSError:
                    pass
        if not line:
            raise ConnectionError("service closed the connection")
        return protocol.decode(line)     # ValueError on corrupt reply

    # ------------------------------ requests ----------------------------

    def request(self, msg: dict, timeout: float | None = None) -> dict:
        retry_safe = msg.get("op") in _RETRY_SAFE
        tries = self.retries if retry_safe else 1
        last: Exception | None = None
        for attempt in range(tries):
            if self._file is None:
                self._reconnect()
            try:
                resp = self._roundtrip(msg, timeout)
            except TimeoutError:
                # the reply may still arrive later and desync every
                # following request on this stream: drop the connection
                self._drop()
                raise
            except (ConnectionError, ValueError, OSError) as e:
                last = e
                self._drop()
                if attempt == tries - 1:
                    break
                continue
            if (retry_safe and not resp.get("ok", True)
                    and resp.get("error") in _TRANSPORT_ERRORS
                    and attempt < tries - 1):
                # our frame got mangled in flight; the server never
                # applied it — resend (frame-too-long also dropped the
                # connection server-side, the next loop redials)
                if resp.get("error") == "frame-too-long":
                    self._drop()
                continue
            return resp
        raise ConnectionError(
            f"request {msg.get('op')!r} failed after {tries} "
            f"attempts") from last

    def _hello_msg(self) -> dict:
        msg = {"op": "hello", "tenant": self.tenant,
               "profile": self._profile_wire}
        if self.token is not None:
            msg["token"] = self.token
        return msg

    def hello(self, profile) -> dict:
        self._profile_wire = profile.to_wire()
        return self.request(self._hello_msg())

    def snapshot(self, snap: dict) -> dict:
        snap = dict(snap)
        snap["op"] = "snapshot"
        snap["tenant"] = self.tenant
        return self.request(snap)

    def stats(self) -> dict:
        return self.request({"op": "stats"})

    def retrain(self) -> dict:
        return self.request({"op": "retrain"})

    def rollback(self) -> dict:
        return self.request({"op": "rollback"})

    def bye(self) -> dict:
        try:
            return self.request({"op": "bye", "tenant": self.tenant})
        finally:
            self.close()

    def close(self) -> None:
        self._drop()
