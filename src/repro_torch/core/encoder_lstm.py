"""Encoder-LSTM straggler-prediction network (paper §3.2, Fig. 4) and its
training (MSE against MLE-fitted targets, the repo's Adam), in PyTorch.

Architecture (as ``repro.core.encoder_lstm``):
  - Encoder: 4 fully-connected layers, softplus after each:
        input(|M_H| + |M_T|) -> 128 -> 128 -> 128 -> 32
  - LSTM: 2 layers, hidden size 32, zero initial state.
  - Head: FC(2); alpha = softplus(o0) + 1, beta = softplus(o1) + BETA_EPS.
  - Inputs are EMA-smoothed with weight EMA_W = 0.8 on the newest matrices.

Params are a plain dict in the JAX layout — ``{"enc": [{w, b}] x 4,
"lstm": [{wx, wh, b}] x 2, "head": {w, b}}``, applied as ``x @ w + b``
with LSTM gates packed [i, f, g, o] — so weights convert from the JAX
package by a plain copy (``repro_torch.convert``).

Every LSTM cell goes through ``repro_torch.kernels.lstm_cell``: the CUDA
kernel for tensors on the card, its plain version for tensors on the CPU;
training differentiates the plain cell (the wrapper's autograd Function
on the card).

The functions here are eager, and are the reference.  The programs the
JAX package jits, ``predict_sequence``, ``predict_sequence_opt`` and
``train_step``, are also programs (``repro_torch.core.programs``:
:data:`PREDICT_SEQUENCE`, :data:`PREDICT_SEQUENCE_OPT`,
:data:`TRAIN_STEP`): one CUDA graph per shape key on the card, keyed on
the static arguments JAX keys on (``unroll``, ``lr``).  A graph holds no
loop, so ``unroll`` is part of a key only (the counts follow JAX's) and
changes no value.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.convert import leaves, tree_map, unflatten
from repro_torch.core import programs
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_ref

EMA_W = 0.8          # weight of the *latest* resource matrix (paper §3.2)
BETA_EPS = 1e-3      # strictly-positive Pareto scale
ENC_HIDDEN = 128
ENC_OUT = 32
LSTM_HIDDEN = 32
LSTM_LAYERS = 2

Params = dict


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``): no linear cut-off above a threshold, unlike
    ``torch.nn.functional.softplus``.  Every softplus of the port is this
    one."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def init_params(seed: int, input_dim: int, enc_hidden: int = ENC_HIDDEN,
                enc_out: int = ENC_OUT, lstm_hidden: int = LSTM_HIDDEN,
                lstm_layers: int = LSTM_LAYERS,
                device: str | torch.device = "cuda") -> Params:
    """Seeded init with the JAX package's distributions (normal weights
    scaled by 1/sqrt(fan_in), zero biases), drawn from numpy's
    ``default_rng(seed)``.  ``jax.random`` gives other numbers from the
    same seed: to hold the port against the JAX package, convert its
    weights with ``repro_torch.convert.from_jax`` instead."""
    rng = np.random.default_rng(seed)

    def normal(n_in, n_out):
        w = rng.standard_normal((n_in, n_out), np.float32)
        return torch.tensor(w * np.float32(1.0 / np.sqrt(n_in)),
                            device=device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    dims = [input_dim, enc_hidden, enc_hidden, enc_hidden, enc_out]
    enc = [{"w": normal(a, b), "b": zeros(b)}
           for a, b in zip(dims[:-1], dims[1:])]
    lstm = []
    n_in = enc_out
    for _ in range(lstm_layers):
        lstm.append({"wx": normal(n_in, 4 * lstm_hidden),
                     "wh": normal(lstm_hidden, 4 * lstm_hidden),
                     "b": zeros(4 * lstm_hidden)})
        n_in = lstm_hidden
    head = {"w": normal(lstm_hidden, 2), "b": zeros(2)}
    return {"enc": enc, "lstm": lstm, "head": head}


def encoder_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """4-layer softplus MLP (paper's Encoder network)."""
    h = x
    for layer in params["enc"]:
        h = softplus(h @ layer["w"] + layer["b"])
    return h


def lstm_cell_apply(layer: Params, h: torch.Tensor, c: torch.Tensor,
                    x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One plain LSTM cell step; gates packed [i, f, g, o]."""
    return lstm_cell_ref(x, h, c, layer["wx"], layer["wh"], layer["b"])


def _cell_apply(layer: Params, h: torch.Tensor, c: torch.Tensor,
                x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One cell step through ``kernels.lstm_cell`` over any leading batch
    shape: the kernel for a CUDA tensor, the plain cell for a CPU one."""
    batch = h.shape[:-1]
    hid = h.shape[-1]
    h2, c2 = lstm_cell(x.reshape(-1, x.shape[-1]), h.reshape(-1, hid),
                       c.reshape(-1, hid), layer["wx"], layer["wh"],
                       layer["b"])
    return h2.reshape(*batch, hid), c2.reshape(*batch, hid)


class LSTMState(NamedTuple):
    h: torch.Tensor  # (layers, ..., hidden)
    c: torch.Tensor


def init_state(params: Params, batch_shape: tuple = ()) -> LSTMState:
    wh = params["lstm"][0]["wh"]
    z = torch.zeros((len(params["lstm"]), *batch_shape, wh.shape[0]),
                    dtype=torch.float32, device=wh.device)
    return LSTMState(h=z, c=z)


def _lstm_layers(params: Params, hs: list, cs: list,
                 inp: torch.Tensor) -> torch.Tensor:
    """Advance the stacked cells one step, updating the per-layer ``hs``
    and ``cs`` lists in place; returns the top layer's output."""
    for li, layer in enumerate(params["lstm"]):
        hs[li], cs[li] = _cell_apply(layer, hs[li], cs[li], inp)
        inp = hs[li]
    return inp


def _head(params: Params, top: torch.Tensor) -> torch.Tensor:
    """(alpha, beta) head.  Softplus, not the paper's ReLU: a ReLU alpha
    head that initialises negative is dead (alpha pinned to 1)."""
    out = top @ params["head"]["w"] + params["head"]["b"]
    alpha = softplus(out[..., 0]) + 1.0
    beta = softplus(out[..., 1]) + BETA_EPS
    return torch.stack([alpha, beta], dim=-1)


def step_decoded(params: Params, state: LSTMState, lam: torch.Tensor
                 ) -> tuple[LSTMState, torch.Tensor]:
    """LSTM + head over an already-encoded input (the recurrent half of
    :func:`step`)."""
    hs, cs = list(state.h), list(state.c)
    top = _lstm_layers(params, hs, cs, lam)
    return LSTMState(h=torch.stack(hs), c=torch.stack(cs)), _head(params, top)


def step(params: Params, state: LSTMState, x: torch.Tensor
         ) -> tuple[LSTMState, torch.Tensor]:
    """One inference step: encoder -> stacked LSTM -> (alpha, beta) head."""
    return step_decoded(params, state, encoder_apply(params, x))


def ema_smooth(seq: torch.Tensor, w: float = EMA_W) -> torch.Tensor:
    """Exponential moving average along axis 0 with weight w on the newest
    element (paper §3.2): s_t = w*x_t + (1-w)*s_{t-1}, s_0 = x_0.

    As in the JAX scan, the recurrence starts from carry x_0 at t = 0
    (so s_1 sees w*x_0 + (1-w)*x_0, within an ulp of x_0) and only the
    emitted s_0 is reset to x_0."""
    s = seq[0]
    out = [seq[0]]
    for t in range(seq.shape[0]):
        s = w * seq[t] + (1.0 - w) * s
        if t:
            out.append(s)
    return torch.stack(out)


def encoder_hoisted(params: Params, mh_ema: torch.Tensor,
                    mt: torch.Tensor) -> torch.Tensor:
    """Encoder over a (T, host_dim) shared host block + (nb, task_dim)
    per-job task block, hoisted out of the recurrence (Tier-1).

    The first layer's product splits at the host/task column boundary:
    the host product once per step, the task product once per job (the
    task block is constant over the horizon, so its EMA is itself and is
    skipped).  Returns the (T, nb, ENC_OUT) encodings."""
    l0 = params["enc"][0]
    host_dim = mh_ema.shape[-1]
    lam_h = mh_ema @ l0["w"][:host_dim]             # (T, E)
    lam_t = mt @ l0["w"][host_dim:] + l0["b"]       # (nb, E)
    h = softplus(lam_h[:, None, :] + lam_t[None, :, :])
    for layer in params["enc"][1:]:
        h = softplus(h @ layer["w"] + layer["b"])
    return h


def decode_sequence(params: Params, lam: torch.Tensor,
                    unroll: int = 1) -> torch.Tensor:
    """Run the LSTM over precomputed (T, ..., ENC_OUT) encodings and
    return the final step's (alpha, beta), shape (..., 2).  The head runs
    on the last step only: earlier steps' outputs are never read.
    ``unroll`` (JAX's ``lax.scan`` unroll) changes nothing here: the
    steps run in order, eagerly or replayed from a graph."""
    state = init_state(params, lam.shape[1:-1])
    hs, cs = list(state.h), list(state.c)
    top = None
    for x in lam:
        top = _lstm_layers(params, hs, cs, x)
    return _head(params, top)


def predict_sequence_opt(params: Params, xs: torch.Tensor,
                         unroll: int = 1) -> torch.Tensor:
    """Tier-1 twin of :func:`predict_sequence` for batches whose host
    blocks vary per row (the multi-tenant serving batch): the encoder
    runs once over the whole (T, nb) grid.  ``unroll`` keys its program
    (:data:`PREDICT_SEQUENCE_OPT`) and changes no value."""
    return decode_sequence(params, encoder_apply(params, ema_smooth(xs)))


def predict_sequence(params: Params, xs: torch.Tensor) -> torch.Tensor:
    """Run the net over a (T, ..., input_dim) feature sequence, EMA-smoothed
    here, encoding step by step.  Returns the final-step (alpha, beta),
    shape (..., 2)."""
    xs = ema_smooth(xs)
    state = init_state(params, xs.shape[1:-1])
    hs, cs = list(state.h), list(state.c)
    top = None
    for x in xs:
        top = _lstm_layers(params, hs, cs, encoder_apply(params, x))
    return _head(params, top)


# ------------------------------- training ---------------------------------


def mse_loss(params: Params, xs: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
    """MSE between predicted (alpha, beta) and MLE-fitted targets (paper
    §4.4)."""
    pred = predict_sequence(params, xs)
    return torch.mean((pred - targets) ** 2)


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the params' device
    mu: Params
    nu: Params


def adam_init(params: Params) -> AdamState:
    dev = leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params))


@torch.no_grad()
def adam_update(params: Params, grads: Params, state: AdamState,
                lr: float = 1e-5, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple[Params, AdamState]:
    """Adam (paper §4.4 uses Adam with lr 1e-5), leaf by leaf.  The bias
    corrections are fp32 on the device, as the JAX package computes
    them (``1 - b1 ** float32(t)``), not Python doubles."""
    t = state.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    tf = t.to(torch.float32)
    bc1 = 1 - b1 ** tf
    bc2 = 1 - b2 ** tf
    params = tree_map(
        lambda p, m, v: p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps),
        params, mu, nu)
    return params, AdamState(step=t, mu=mu, nu=nu)


def loss_and_grads(params: Params, xs: torch.Tensor, targets: torch.Tensor
                   ) -> tuple[torch.Tensor, Params]:
    """:func:`mse_loss` and its gradients in the params' structure, by
    autograd from detached copies of the params."""
    ps = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = mse_loss(ps, xs, targets)
        grads = torch.autograd.grad(loss, leaves(ps))
    return loss.detach(), unflatten(ps, grads)


def train_step(params: Params, opt: AdamState, xs: torch.Tensor,
               targets: torch.Tensor, lr: float = 1e-5
               ) -> tuple[Params, AdamState, torch.Tensor]:
    """One Adam step on :func:`mse_loss`.  The params returned do not
    require grad, so the decisions that read them build no graph."""
    loss, grads = loss_and_grads(params, xs, targets)
    params, opt = adam_update(params, grads, opt, lr=lr)
    return params, opt, loss


def sequence_entry(params: Params, xs) -> programs.Entry:
    """The :data:`PREDICT_SEQUENCE` entry for ``params``' and the
    (T, ..., input_dim) ``xs``'s shapes, with ``params`` refreshed in it
    and ``xs`` copied in: ``run()`` gives (alpha, beta), the entry's own
    output.  Call under ``programs.LOCK``."""
    dev = leaves(params)[0].device
    e = PREDICT_SEQUENCE.entry(
        (dev, programs.signature(params), tuple(xs.shape)),
        lambda: (tree_map(torch.empty_like, params),
                 torch.empty(tuple(xs.shape), dtype=torch.float32,
                             device=dev)))
    e.refresh(0, params)
    e.copy_in(1, xs)
    return e


def _train_in_place(params: Params, opt: AdamState, xs: torch.Tensor,
                    targets: torch.Tensor, *, lr: float) -> torch.Tensor:
    """:func:`train_step` on the minibatch ``xs`` (T, rows, ...) /
    ``targets`` (rows, 2), writing the new params and Adam state over
    ``params`` and ``opt``; returns the loss (the :data:`TRAIN_STEP`
    program)."""
    new_params, new_opt, loss = train_step(params, opt, xs, targets, lr=lr)
    programs.write_back((params, opt), (new_params, new_opt))
    return loss


# the programs the JAX package jits (encoder_lstm.py: predict_sequence,
# predict_sequence_opt, train_step): one graph per key on the card
PREDICT_SEQUENCE = programs.Program("predict_sequence", predict_sequence)
PREDICT_SEQUENCE_OPT = programs.Program("predict_sequence_opt",
                                        predict_sequence_opt)
TRAIN_STEP = programs.Program("train_step", _train_in_place)


class Training:
    """:data:`TRAIN_STEP` over one data set, as ``fit`` runs it:
    :meth:`step` takes one Adam step on the examples ``idx`` and returns
    the loss, :meth:`result` gives copies of ``[params, opt]`` after the
    last step.  The params and Adam state are loaded into the entry once.
    The (T, N, ...) data set stays on the device with this object, and
    each step gathers its ``rows`` examples into the entry's minibatch
    inputs outside the graph, so the entry holds no data set and, as JAX
    keys ``train_step`` on ``xs[:, idx]``, is keyed on the minibatch's
    shapes and ``lr`` only: every fit at that minibatch shape replays one
    capture."""

    def __init__(self, params: Params, opt: AdamState, xs, targets,
                 rows: int, lr: float):
        dev = leaves(params)[0].device
        self.xs = torch.as_tensor(xs, dtype=torch.float32).to(dev)
        self.targets = torch.as_tensor(targets, dtype=torch.float32).to(dev)
        shape_x = (self.xs.shape[0], int(rows), *self.xs.shape[2:])
        shape_y = (int(rows), *self.targets.shape[1:])

        def make():
            return (tree_map(torch.empty_like, params),
                    AdamState(*(tree_map(torch.empty_like, x) for x in opt)),
                    torch.empty(shape_x, dtype=torch.float32, device=dev),
                    torch.empty(shape_y, dtype=torch.float32, device=dev))

        key = (dev, programs.signature(params, opt), shape_x, shape_y,
               float(lr))
        self._steps = programs.Steps(TRAIN_STEP, key, make, (params, opt),
                                     lr=float(lr))

    def step(self, idx) -> float:
        """One Adam step on the examples ``idx`` (``rows`` of them)."""
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(self.xs.device)
        with programs.LOCK:
            e = self._steps.load()
            torch.index_select(self.xs, 1, idx, out=e.args[2])
            torch.index_select(self.targets, 0, idx, out=e.args[3])
            return float(e.run())

    def result(self) -> list:
        """Copies of ``[params, opt]`` after the last step."""
        return self._steps.result()
