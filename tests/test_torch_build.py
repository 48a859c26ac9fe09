"""The kernel loader's lock (``repro_torch.kernels._build``), on the CPU:
threads that touch a kernel for the first time at once (the service's
batch worker and its retrainer) build the libraries once and share one
loaded handle.  The compiler, the card and the loader are stand-ins."""
import ctypes
import threading
import time

import torch

from repro_torch.kernels import _build

THREADS = 8


def test_first_use_from_many_threads_builds_once(monkeypatch):
    builds, loads = [], []

    def build_all():
        builds.append(threading.get_ident())
        time.sleep(0.05)          # a build in progress while others arrive
        return {}

    def cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (9, 0))
    barrier = threading.Barrier(THREADS, timeout=10)
    got = [None] * THREADS

    def first_use(i):
        barrier.wait()
        got[i] = _build.library("lstm_cell")

    threads = [threading.Thread(target=first_use, args=(i,))
               for i in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert got[0] is not None and all(h is got[0] for h in got)


def test_build_all_is_serialised(monkeypatch):
    """Two concurrent ``build_all`` calls never run ``nvcc`` into the same
    temporary file: the second waits for the first and finds the
    libraries built."""
    inside, overlaps = [], []

    def missing():
        if inside:
            overlaps.append(1)
        inside.append(1)
        time.sleep(0.05)
        inside.pop()
        return {}

    monkeypatch.setattr(_build, "_build_missing", missing)
    threads = [threading.Thread(target=_build.build_all) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not overlaps
