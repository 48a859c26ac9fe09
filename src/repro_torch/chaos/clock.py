"""Injectable monotonic clock with controllable skew (a copy of the JAX
package's ``repro.chaos.clock``).

The service's wall-clock retrain timer takes a ``clock`` callable
(``RetrainScheduler(clock=...)``), so chaos tests can make a retrain
period elapse *instantly* instead of sleeping through it — and,
symmetrically, freeze time so nothing fires while a drill arranges its
next failure.
"""
from __future__ import annotations

import threading
import time


class SkewClock:
    """A monotonic clock whose reading can be skewed forward or frozen.

    ``advance(s)`` adds ``s`` seconds of skew — to every component
    reading this clock it looks exactly like ``s`` seconds of silence
    passed, which is how the drills trigger wall-clock retrains
    deterministically.  ``freeze()`` pins the
    reading (skew still applies) until ``thaw()``; the clock never goes
    backwards.
    """

    def __init__(self, base=time.monotonic, offset: float = 0.0):
        self._base = base
        self._offset = float(offset)
        self._frozen: float | None = None
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            t = self._frozen if self._frozen is not None else self._base()
            return t + self._offset

    def advance(self, seconds: float) -> None:
        """Skew the clock forward; negative skew is refused (monotonic)."""
        if seconds < 0:
            raise ValueError(f"clock must stay monotonic; got {seconds}")
        with self._lock:
            self._offset += float(seconds)

    def freeze(self) -> None:
        with self._lock:
            if self._frozen is None:
                self._frozen = self._base()

    def thaw(self) -> None:
        with self._lock:
            if self._frozen is not None:
                # keep monotonicity across the frozen window: fold the
                # time that really passed while frozen into the offset
                self._offset -= self._base() - self._frozen
                self._frozen = None
