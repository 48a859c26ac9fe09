"""Continuous retraining: replay buffer, candidate fit, shadow eval (the
JAX package's ``repro.service.retrain`` over the port's predictor).

The service turns completed-job telemetry into (sequence, target) pairs
shaped exactly like the simulator's pretraining set
(``NoOpRecorder.dataset``): ``xs`` is the trailing ``horizon`` host-row
sequence broadcast against the job's task matrix, ``ys`` is the MLE
Pareto fit of the job's observed durations, ``[alpha, beta/beta_scale]``
(the same normalization ``fit()`` trains against everywhere else).

Promotion is gated by a **shadow evaluation**: the newest pairs are held
back from training and the candidate must score a finite MSE on them no
worse than ``promote_tol`` x the champion's MSE on the same holdback.  A
corrupted or diverged candidate therefore never becomes the serving
version — the champion keeps answering and the failed candidate is
recorded in stats.

On the card every LSTM cell of the shadow evaluation launches the
``lstm_cell`` kernel, and the candidate's fit differentiates through the
kernel's autograd Function.  The fit never writes a champion tensor: the
port's Adam builds new tensors, so the champion can keep serving while
its copy trains.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.convert import leaves
from repro_torch.core import encoder_lstm as net
from repro_torch.core import programs
from repro_torch.core.pareto import fit_pareto_np
from repro_torch.core.predictor import StragglerPredictor


class ReplayBuffer:
    """Bounded FIFO of training pairs with a newest-N eval holdback.

    One pair per completed job, shaped exactly like the simulator's
    offline set: ``x`` is (T, host_dim + task_dim) — the trailing host
    window with the job's full padded M_T repeated across time — and
    ``y`` is ``[alpha, beta / beta_scale]``.
    """

    def __init__(self, cap: int = 4096, holdback: int = 32):
        self.xs: deque = deque(maxlen=cap)
        self.ys: deque = deque(maxlen=cap)
        self.holdback = int(holdback)
        self.added = 0

    def __len__(self) -> int:
        return len(self.xs)

    def add_job(self, host_seq: np.ndarray, m_t: np.ndarray,
                times: np.ndarray, beta_scale: float) -> int:
        """One completed job -> one training pair.

        Args:
            host_seq: (T, host_dim) trailing host-feature rows.
            m_t: (max_tasks, TASK_FEATURES) the job's full task matrix
                (padded rows zero).
            times: (n_obs,) observed positive durations.
        """
        alpha, beta = fit_pareto_np(times.reshape(1, -1))
        y = np.array([float(alpha[0]), float(beta[0]) / beta_scale],
                     np.float32)
        t = host_seq.shape[0]
        flat = np.asarray(m_t, np.float32).reshape(-1)
        x = np.concatenate(
            [host_seq, np.broadcast_to(flat, (t, flat.size))],
            axis=1).astype(np.float32)
        self.xs.append(x)
        self.ys.append(y)
        self.added += 1
        return 1

    def split(self) -> tuple[tuple, tuple]:
        """-> ((train_xs, train_ys), (eval_xs, eval_ys)) as stacked
        arrays; eval is the newest ``holdback`` pairs (empty train if
        everything fits in the holdback)."""
        n = len(self.xs)
        h = min(self.holdback, n)
        xs = np.stack(list(self.xs), axis=1)      # (T, n, input_dim)
        ys = np.stack(list(self.ys), axis=0)      # (n, 2)
        cut = n - h
        return ((xs[:, :cut], ys[:cut]), (xs[:, cut:], ys[cut:]))


def shadow_loss(params, eval_xs: np.ndarray, eval_ys: np.ndarray) -> float:
    """Replay held-back telemetry through a parameter set -> MSE, on the
    parameters' device: ``net.mse_loss`` with the network run as the
    ``predict_sequence`` program, as the JAX package's runs its jitted
    ``predict_sequence``."""
    if eval_xs.shape[1] == 0:
        return float("nan")
    dev = leaves(params)[0].device
    ys = torch.from_numpy(np.ascontiguousarray(eval_ys, np.float32)).to(dev)
    with programs.LOCK:
        pred = net.sequence_entry(params, np.ascontiguousarray(
            eval_xs, np.float32)).run()
        return float(torch.mean((pred - ys) ** 2))


def fit_candidate(champion: StragglerPredictor, train_xs: np.ndarray,
                  train_ys: np.ndarray, epochs: int = 20, lr: float = 1e-4):
    """Fine-tune a scratch predictor seeded from the champion params, on
    the champion's device.

    The scratch instance keeps training state (Adam moments, ring
    buffers) away from the serving predictor entirely; only the
    resulting ``params`` tree crosses back, and only if shadow eval
    promotes it.
    """
    scratch = StragglerPredictor(
        n_hosts=champion.n_hosts, max_tasks=champion.max_tasks,
        horizon=champion.horizon, k=champion.k,
        beta_scale=champion.beta_scale, seed=champion.seed,
        device=champion.device)
    scratch.params = champion.params
    losses = scratch.fit(train_xs, train_ys, epochs=epochs, lr=lr)
    return scratch.params, losses


def should_promote(cand_loss: float, champ_loss: float,
                   tol: float = 1.05) -> bool:
    """Gate: candidate must be finite and no worse than tol x champion.

    A NaN champion loss (e.g. empty holdback) promotes any finite
    candidate — there is nothing to regress against.
    """
    if not np.isfinite(cand_loss):
        return False
    if not np.isfinite(champ_loss):
        return True
    return bool(cand_loss <= champ_loss * tol)
