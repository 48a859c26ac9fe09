"""Per-device accounting of an eager PyTorch function: FLOPs, bytes,
transcendentals and collective bytes (the counterpart of the JAX
package's ``launch/hlo_accounting.py``, which walks optimized HLO).

PyTorch runs eagerly, so a loop runs its body once per trip and every
trip is counted: nothing needs a trip count (``unknown_trip_loops`` stays
0).  Run the function on meta tensors to count a full-size cell with no
storage and no device.

Counting rules (after ``hlo_accounting.py``'s):
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, 2 * M * N * K
    per matrix product (mm, bmm, addmm, baddbmm, convolution, SDPA);
    elementwise work is not counted as FLOPs (it is in the bytes);
  * bytes: operand + result sizes of every aten op that reaches the
    dispatcher (``TorchDispatchMode``; views count too, as XLA's
    top-level ops do, since an eager view is an op of its own);
  * transcendentals: one per output element of exp, log, tanh, sigmoid,
    rsqrt, sqrt, pow, sin, cos, erf (and their variants);
  * collectives: result-shape bytes per op occurrence (all-gather,
    all-reduce, reduce-scatter, all-to-all; ``c10d`` and functional
    collectives alike), every loop trip counted;
  * :meth:`Counter.add` takes work that runs outside the dispatcher (a
    kernel stand-in's reckoned counts, a collective the plan reckons
    from placements).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_TRANSCENDENTAL = ("exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "erf",
                   "softplus", "silu", "logsumexp", "softmax",
                   "_softmax", "_log_softmax")

# c10d (in-place: the output is the first argument) and functional ops
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all"}
_FUNCTIONAL = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    unknown_trip_loops: int = 0

    def scaled(self, k: float) -> "Totals":
        return Totals(self.flops * k, self.bytes * k,
                      self.transcendentals * k,
                      {o: v * k for o, v in self.collectives.items()},
                      self.unknown_trip_loops)

    def add(self, o: "Totals") -> None:
        self.flops += o.flops
        self.bytes += o.bytes
        self.transcendentals += o.transcendentals
        for k, v in o.collectives.items():
            self.collectives[k] += v
        self.unknown_trip_loops += o.unknown_trip_loops

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (list, tuple)):
        return sum(_numel(v) for v in x)
    return 0


class _Bytes(TorchDispatchMode):
    """Operand + result bytes, transcendentals and collectives per op."""

    def __init__(self, totals: Totals):
        super().__init__()
        self.t = totals

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns == "c10d" and name in _C10D:
            self.t.collectives[_C10D[name]] += _nbytes(args[0])
            return out
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            self.t.collectives[_FUNCTIONAL[name]] += _nbytes(out)
            return out
        if ns == "_c10d_functional" or ns == "c10d":
            return out           # waits, barriers, broadcasts: no bytes
        self.t.bytes += (_nbytes(list(args)) + _nbytes(kwargs)
                         + _nbytes(out))
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.t.transcendentals += _numel(out)
        return out


class Counter:
    """Counts everything run inside ``with Counter() as c:``; read
    ``c.totals`` after."""

    def __init__(self):
        self.totals = Totals()
        self._flops = FlopCounterMode(display=False)
        self._bytes = _Bytes(self.totals)

    def __enter__(self) -> "Counter":
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self.totals.flops += self._flops.get_total_flops()
        self._flops = FlopCounterMode(display=False)

    def add(self, flops: float = 0.0, nbytes: float = 0.0,
            transcendentals: float = 0.0, **collectives: float) -> None:
        """Work done outside the dispatcher; ``collectives`` keyed by
        op name with ``_`` for ``-`` (``all_gather=...``)."""
        self.totals.flops += flops
        self.totals.bytes += nbytes
        self.totals.transcendentals += transcendentals
        for k, v in collectives.items():
            self.totals.collectives[k.replace("_", "-")] += v


def account(fn, *args, **kwargs) -> Totals:
    """The :class:`Totals` of one call ``fn(*args, **kwargs)``."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.totals
