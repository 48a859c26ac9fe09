"""Compiled programs: the port's counterpart of ``jax.jit``.

A :class:`Program` wraps one of the port's eager functions.  Each
distinct key (the device, the shapes and dtypes of its inputs, and the
static arguments the JAX package keys its ``jax.jit`` on) gets one
:class:`Entry` that owns the program's static input, weight and output
buffers.  On the card the entry's first call runs the function once
eagerly on a side stream (the warm-up, whose result it returns), then
captures it into a ``torch.cuda.CUDAGraph`` with its own memory pool;
every later call replays the graph.  On the CPU, which the tests ask for
explicitly, the same cache runs the same data flow eagerly: the function
on the entry's static buffers, every call.

A graph reads and writes the addresses it captured, so callers go
through the entry's buffers:

* :meth:`Entry.copy_in` copies a caller's input into a static input on
  every call; :meth:`Entry.refresh` copies weights only when they are not
  the ones loaded (another object, or the same tensors changed in place);
* arguments too large to copy (an LM's weights, a serving slot's caches)
  are *bound*: the entry reads and writes the caller's own tensors in
  place, its key holds their identity (:func:`identity`: address, shape,
  stride, dtype), and the caller passes the same tensors to every
  :meth:`Entry.run`; another tree is another entry, never a copy.  The
  entry keeps only weak references to them, and an entry whose bound
  tensors died is dropped at the program's next lookup of a new key or
  by :meth:`Program.prune`;
* a static buffer that several entries capture and one caller at a time
  owns (the fused step's M_H ring) is a :class:`Resident`;
* a call's outputs are the entry's static outputs: a caller reads or
  copies them before the next call of the entry.

Capture raises when it fails; nothing falls back to eager.  Captures,
their wall time and their memory are counted in :data:`stats`, and a
program's :meth:`Program.cache_size` is its number of entries (JAX's
``_cache_size()``).  One process-wide lock, :data:`LOCK`, covers each
call's loads, replay and readback, since the service's batch worker and
retrainer threads share entries.
"""
from __future__ import annotations

import threading
import time
import weakref

import torch

from repro_torch.convert import leaves, tree_map
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lstm_cell import lstm_cell
from repro_torch.kernels.mamba_scan import (mamba_scan, mamba_scan_bwd,
                                            mamba_scan_with_state)
from repro_torch.kernels.moe_router import moe_router

#: held around every sequence of loads, run and readback of an entry
LOCK = threading.RLock()

#: kernel wrappers whose launches a graph replays: each counts a launch
#: recorded during capture in ``recorded``, and a replay adds the graph's
#: recorded launches to ``launches``
_COUNTED = (lstm_cell, decode_attention, flash_attention, moe_router,
            mamba_scan, mamba_scan_bwd, mamba_scan_with_state)

#: process-wide: captures made, their wall ms, the device memory their
#: pools reserved (bytes), and graph replays
stats = {"captures": 0, "capture_ms": 0.0, "pool_bytes": 0, "replays": 0}

_PROGRAMS: list[Program] = []
_RESIDENTS: dict = {}
_SIDE_STREAMS: dict = {}


def signature(*trees) -> tuple:
    """The shapes and dtypes of every leaf of ``trees`` (a cache key)."""
    return tuple((tuple(t.shape), t.dtype) for tree in trees
                 for t in leaves(tree))


def identity(*trees) -> tuple:
    """Where every leaf of ``trees`` lies and how it is laid out (the key
    of arguments an entry binds): address, shape, stride, dtype, device."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                  t.device) for tree in trees for t in leaves(tree))


def clear() -> None:
    """Drop every entry and resident buffer (JAX's ``clear_caches``): the
    graphs, their pools and the static buffers are freed once no caller
    holds them, and every program captures again on its next call."""
    with LOCK:
        for prog in _PROGRAMS:
            prog._entries.clear()
        _RESIDENTS.clear()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return s


def _token(x):
    """What :meth:`Entry.refresh` remembers of the weights it loaded: the
    number, or weak references to the tensors with their versions, so an
    entry never keeps a caller's weights alive (a dead reference is simply
    not the same weights)."""
    if isinstance(x, (int, float)):
        return ("value", float(x))
    return [(weakref.ref(t), t._version) for t in leaves(x)]


def _same(token, x) -> bool:
    if token is None:
        return False
    if isinstance(x, (int, float)):
        return token == ("value", float(x))
    src = leaves(x)
    return (not isinstance(token, tuple) and len(token) == len(src)
            and all(a() is b and v == b._version
                    for (a, v), b in zip(token, src)))


class Entry:
    """One program at one key: its bound arguments (the caller's trees,
    held by weak reference), its static arguments (``args``, trees of
    tensors, after the bound ones in the function's argument order), its
    graph on the card and its static outputs."""

    def __init__(self, program: Program, key, args: tuple, static: dict,
                 bound: tuple = (), pool=None):
        self.program = program
        self.key = key
        self.args = args
        self.static = static
        self._bound = [weakref.ref(t) for t in leaves(bound)]
        #: the key of a memory pool shared with other entries (None: the
        #: graph's own)
        self.pool = pool
        self._loaded = [None] * len(args)
        self.graph = None
        self.out = None
        #: kernel wrapper -> the launches one replay adds (its record)
        self.launches: dict = {}
        #: the :class:`Resident` over the state a :class:`Steps` updates
        self.state = None
        self.capture_ms = 0.0
        self.pool_bytes = 0

    def copy_in(self, i: int, x) -> None:
        """Copy ``x`` (a tree of the argument's structure, an array the
        argument's shape, or a number for a scalar argument) into static
        argument ``i``.  A pinned host source copies asynchronously."""
        if isinstance(x, (int, float)):
            self.args[i].fill_(x)
        else:
            for dst, src in zip(leaves(self.args[i]), leaves(x)):
                src = torch.as_tensor(src)
                dst.copy_(src, non_blocking=src.is_pinned())
        self._loaded[i] = None

    def refresh(self, i: int, x) -> bool:
        """:meth:`copy_in` unless ``x`` is what argument ``i`` holds: the
        same tensors at the same versions (or the same number).  Returns
        whether it copied."""
        if _same(self._loaded[i], x):
            return False
        self.copy_in(i, x)
        self._loaded[i] = _token(x)
        return True

    def binds(self, bound: tuple) -> bool:
        """Whether ``bound`` is the trees this entry was built on: the same
        tensors, all alive."""
        ts = leaves(bound)
        return len(ts) == len(self._bound) and all(
            r() is t for r, t in zip(self._bound, ts))

    def alive(self) -> bool:
        return all(r() is not None for r in self._bound)

    def run(self, *bound):
        """Run the program once on ``bound`` (the trees the entry binds)
        and the static arguments and return its outputs: eagerly on the
        CPU; on the card, the first call runs it eagerly and captures it,
        later calls replay the graph."""
        if not self.binds(bound):
            raise ValueError(f"{self.program.name}: an entry runs on the "
                             f"tensors it was built on")
        args = bound + self.args
        dev = leaves(args)[0].device
        if dev.type != "cuda":
            return self.program.fn(*args, **self.static)
        if self.graph is None:
            return self._capture(dev, args)
        self.graph.replay()
        stats["replays"] += 1
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        return self.out

    def _capture(self, dev: torch.device, args: tuple):
        # PyTorch's recipe: the warm-up on a side stream (this call's own
        # result), then the capture on that stream into the graph's
        # private pool.  A private pool takes none of the blocks the
        # allocator caches, and nothing can be freed while a capture runs,
        # so the cache is emptied first (the warm-up's blocks, an LM
        # prefill's), as ``torch.cuda.graph`` does; its garbage collection,
        # ~0.1 s a capture in a large process, is left out.  The memory
        # reserved during the capture is the pool's.
        cur = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.program.fn(*args, **self.static)
        cur.wait_stream(side)
        for t in leaves(out):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        before = [w.recorded for w in _COUNTED]
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        # the pool of a live graph of the same pool key (a pool lives as
        # long as one of its graphs), else a new one
        pool = None if self.pool is None else next(
            (e.graph.pool() for e in self.program._entries.values()
             if e.pool == self.pool and e.graph is not None), None)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                static_out = self.program.fn(*args, **self.static)
            finally:
                graph.capture_end()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - mem0
        self.launches = {w: w.recorded - b for w, b in zip(_COUNTED, before)
                         if w.recorded > b}
        self.graph, self.out = graph, static_out
        stats["captures"] += 1
        stats["capture_ms"] += self.capture_ms
        stats["pool_bytes"] += self.pool_bytes
        return out


class Program:
    """An eager function and its entries, one per key.  ``fn`` takes an
    entry's static arguments positionally and its static values (those
    JAX marks ``static_argnames``) as keywords."""

    def __init__(self, name: str, fn):
        self.name = name
        self.fn = fn
        self._entries: dict = {}
        _PROGRAMS.append(self)

    def cache_size(self) -> int:
        """The number of keys captured (``jax.jit``'s ``_cache_size()``)."""
        return len(self._entries)

    def entry(self, key, make, bound: tuple = (), pool=None,
              **static) -> Entry:
        """The entry at ``key``, built from ``make()`` (a tuple of the
        static argument trees), ``bound`` (the caller's trees it reads in
        place; ``key`` then holds their :func:`identity`) and ``static``
        on its first use; ``key`` holds the static values too.  Entries
        built with one ``pool`` key capture into one memory pool: safe
        where they never run at once and each call's outputs are read
        before another of them runs (a graph may reuse the memory of the
        others' intermediates and outputs).  Entries whose bound tensors
        died are dropped here.  Call under :data:`LOCK`."""
        e = self._entries.get(key)
        if e is None or not e.binds(bound):
            self.prune()
            e = self._entries[key] = Entry(self, key, tuple(make()), static,
                                           bound, pool)
        return e

    def prune(self) -> int:
        """Drop the entries whose bound tensors died (their graphs and
        pools are freed once nothing else holds them); returns how many.
        Call under :data:`LOCK`."""
        dead = [k for k, e in self._entries.items() if not e.alive()]
        for k in dead:
            del self._entries[k]
        return len(dead)


def _clone(tree):
    """A copy of ``tree`` on its device, keeping named tuples' types."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(_clone, tree))
    return tree_map(lambda t: t.clone(), tree)


def _copy(dst, src) -> None:
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(torch.as_tensor(s))


@torch.no_grad()
def write_back(dst, new) -> None:
    """Copy the tree ``new`` over the tree ``dst`` leaf by leaf: a
    program's in-place update of its static arguments."""
    _copy(dst, new)


class Held:
    """A caller's handle on a value that may live in a :class:`Resident`:
    ``value`` is the resident's buffer while the caller owns it, else the
    caller's own tensor."""

    __slots__ = ("value", "__weakref__")

    def __init__(self, value=None):
        self.value = value


class Resident:
    """Static buffers (a tree) that graphs write in place and one caller
    at a time owns: the fused step's M_H ring, which every fused-step and
    catch-up graph of its shape rolls, or a training state."""

    def __init__(self, buf):
        self.buf = buf
        self._owner = None

    def take(self, held: Held, load: bool = True):
        """Make ``held``'s value live in the buffer: the previous owner
        keeps a copy of its own, and ``held``'s value is copied in (unless
        ``load`` is false: the caller writes the buffer itself)."""
        owner = self._owner() if self._owner is not None else None
        if owner is held:
            return self.buf
        if owner is not None:
            owner.value = _clone(self.buf)
        if load and held.value is not None:
            _copy(self.buf, held.value)
        held.value = self.buf
        self._owner = weakref.ref(held)
        return self.buf


def resident(key, make) -> Resident:
    """The process-wide :class:`Resident` at ``key``, its buffer built
    from ``make()`` on first use.  Call under :data:`LOCK`."""
    r = _RESIDENTS.get(key)
    if r is None:
        r = _RESIDENTS[key] = Resident(make())
    return r


class Steps:
    """Repeated calls of one program at one key whose leading arguments
    are the caller's: ``state``, which the program updates in place (a
    training state), then ``data``, which it reads.  They are loaded into
    the entry before the first call and again whenever another caller's
    steps used the entry in between, and :meth:`result` hands back copies
    of the state, so no caller aliases the entry's buffers.  The entry is
    looked up (and on its key's first use built) at the first call, as
    ``jax.jit`` compiles at the first call."""

    def __init__(self, program: Program, key, make, state: tuple,
                 data: tuple = (), **static):
        self._find = lambda: program.entry(key, make, **static)
        self._entry = None
        self._n_state = len(state)
        self._held = Held(tuple(state) + tuple(data))

    def load(self) -> Entry:
        """The entry with this caller's state and data loaded (if another
        caller used it since): write the remaining static arguments, then
        ``run()`` it.  Call under :data:`LOCK`."""
        if self._entry is None:
            self._entry = self._find()
        e = self._entry
        if e.state is None:
            e.state = Resident(e.args[:len(self._held.value)])
        e.state.take(self._held)
        return e

    def run(self):
        """Load the state if needed and run once; the outputs are the
        entry's: read them before releasing :data:`LOCK`."""
        with LOCK:
            return self.load().run()

    def result(self) -> list:
        """Copies of the state after the last call (the caller's own state
        when no call ran)."""
        with LOCK:
            if self._entry is None:
                return list(self._held.value[:self._n_state])
            buf = self._entry.state.take(self._held)
            return [_clone(x) for x in buf[:self._n_state]]
