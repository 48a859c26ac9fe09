"""Pareto distribution model of task execution times (paper §3.1, Eqs. 1-5).

Task execution times X_1..X_q of a job are modelled as Pareto(alpha, beta):
    F_X(x) = 1 - (x/beta)^(-alpha)   for x >= beta,   else 0.

MLE (Eqs. 2-3):  beta = min_i X_i,   alpha = q / (sum_i log X_i - q log beta).

Straggler threshold (paper keeps it a multiple of the Pareto mean):
    K = k * alpha * beta / (alpha - 1),     k = 1.5 by default.

Expected number of stragglers (Eq. 4):  E_S = q * (K / beta)^(-alpha).

The torch functions keep the device of their tensor inputs; batched
variants take padded task arrays with masks (the paper pads jobs with
q < q' tasks with zero rows).  The ``*_np`` functions serve per-job host
loops.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_K = 1.5  # paper §3.1: empirically best F1 (Fig. 2)
_EPS = 1e-8
_ALPHA_MIN = 1.0 + 1e-3  # mean of Pareto only defined for alpha > 1
_ALPHA_MAX = 1e4


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _mask_or_ones(times: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return torch.ones_like(times)
    return torch.as_tensor(mask, device=times.device).to(torch.float32)


def pareto_cdf(x, alpha, beta) -> torch.Tensor:
    """Eq. 1. CDF of Pareto(alpha, beta)."""
    x, alpha, beta = _f32(x), _f32(alpha), _f32(beta)
    safe = torch.maximum(x, beta)
    cdf = 1.0 - (safe / beta) ** (-alpha)
    return torch.where(x >= beta, cdf, 0.0)


def pareto_mean(alpha, beta) -> torch.Tensor:
    """Mean of Pareto(alpha, beta); defined for alpha > 1."""
    alpha, beta = _f32(alpha), _f32(beta)
    return alpha * beta / (alpha - 1.0)


def pareto_quantile(alpha, beta, q) -> torch.Tensor:
    """Inverse CDF: the time by which a fraction ``q`` of tasks complete,
    F^{-1}(q) = beta * (1 - q)^(-1/alpha)."""
    alpha, beta = _f32(alpha), _f32(beta)
    q = torch.clamp(_f32(q), 0.0, 1.0 - _EPS)
    return beta * (1.0 - q) ** (-1.0 / alpha)


def pareto_quantile_np(alpha, beta, q):
    """NumPy :func:`pareto_quantile` for per-interval hot loops."""
    q = np.clip(np.asarray(q, np.float64), 0.0, 1.0 - _EPS)
    return beta * (1.0 - q) ** (-1.0 / alpha)


def sample_pareto(gen: torch.Generator, alpha, beta,
                  shape: tuple) -> torch.Tensor:
    """Inverse-CDF sampling, X = beta * U^(-1/alpha), with U uniform on
    [1e-8, 1) drawn from ``gen`` on the generator's device.  A generator
    gives other numbers than ``jax.random`` from the same seed."""
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(_EPS, 1.0, generator=gen)
    return _f32(beta) * u ** (-1.0 / _f32(alpha))


def fit_pareto(times, mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """MLE fit of (alpha, beta) from task times (Eq. 3).

    Args:
        times: (..., q) positive task execution times. Padded entries allowed
            when ``mask`` marks them 0.
        mask: optional (..., q) in {0,1}; 1 = real task.

    Returns:
        (alpha, beta) with shapes (...,). alpha clipped to
        [1+1e-3, 1e4] so the distribution mean exists (paper adds +1 to the
        network's alpha output for the same reason).
    """
    times = _f32(times)
    mask = _mask_or_ones(times, mask)
    q = torch.clamp_min(mask.sum(-1), 1.0)
    big = torch.where(mask > 0, times, torch.inf)
    beta = torch.clamp_min(big.amin(dim=-1), _EPS)
    logs = torch.where(mask > 0, torch.log(torch.clamp_min(times, _EPS)),
                       0.0)
    denom = logs.sum(-1) - q * torch.log(beta)
    alpha = q / torch.clamp_min(denom, _EPS)
    return torch.clamp(alpha, _ALPHA_MIN, _ALPHA_MAX), beta


def fit_pareto_np(times, mask=None):
    """NumPy :func:`fit_pareto` for per-job hot loops (same float32
    formula, returns numpy scalars/arrays)."""
    t = np.asarray(times, np.float32)
    if mask is None:
        m = np.ones_like(t)
    else:
        m = np.asarray(mask, np.float32)
    q = np.maximum(m.sum(-1), np.float32(1.0))
    big = np.where(m > 0, t, np.float32(np.inf))
    beta = np.clip(big.min(axis=-1), _EPS, None).astype(np.float32)
    logs = np.where(m > 0, np.log(np.maximum(t, np.float32(_EPS))),
                    np.float32(0.0))
    denom = logs.sum(-1) - q * np.log(beta)
    alpha = q / np.maximum(denom, np.float32(_EPS))
    return np.clip(alpha, _ALPHA_MIN, _ALPHA_MAX), beta


def straggler_threshold_np(alpha, beta, k: float = DEFAULT_K):
    """NumPy :func:`straggler_threshold`."""
    return k * alpha * beta / (alpha - 1.0)


def straggler_threshold(alpha, beta, k: float = DEFAULT_K) -> torch.Tensor:
    """K = k * mean = k * alpha*beta/(alpha-1)  (paper §3.1)."""
    return k * pareto_mean(alpha, beta)


def expected_stragglers(q, alpha, beta,
                        k: float = DEFAULT_K) -> torch.Tensor:
    """E_S = q * (K/beta)^(-alpha)  (Eq. 4).

    K/beta = k*alpha/(alpha-1) is beta-free: the *count* of expected
    stragglers depends only on the tail index; beta sets the scale of K.
    """
    alpha, beta = _f32(alpha), _f32(beta)
    kk = straggler_threshold(alpha, beta, k) / beta
    return _f32(q) * kk ** (-alpha)


def straggler_labels(times, alpha, beta,
                     k: float = DEFAULT_K) -> torch.Tensor:
    """Ground-truth straggler flags: completion time > K (paper §3.1)."""
    kthr = straggler_threshold(alpha, beta, k)
    return (_f32(times) > kthr[..., None]).to(torch.float32)


def f1_score_paper(tp, fp) -> torch.Tensor:
    """Eq. 5 as literally printed: tp / (tp + 0.5*(fp + tp)).

    The paper counts correct class labels as tp and incorrect as fp (so fp
    absorbs fn); its Eq. 5 is the standard F1 with that convention.
    """
    tp, fp = _f32(tp), _f32(fp)
    return tp / torch.clamp_min(tp + 0.5 * (fp + tp), _EPS)


def f1_score(pred, truth, mask=None) -> torch.Tensor:
    """Standard binary F1 over (possibly masked) flags, used for Fig. 2."""
    pred = _f32(pred)
    mask = _mask_or_ones(pred, mask)
    pred = pred * mask
    truth = _f32(truth) * mask
    tp = (pred * truth).sum()
    fp = (pred * (1 - truth) * mask).sum()
    fn = ((1 - pred) * mask * truth).sum()
    return tp / torch.clamp_min(tp + 0.5 * (fp + fn), _EPS)


def pareto_nll(times, alpha, beta, mask=None) -> torch.Tensor:
    """Negative log-likelihood (Eq. 2, negated, masked mean)."""
    times, alpha, beta = _f32(times), _f32(alpha), _f32(beta)
    mask = _mask_or_ones(times, mask)
    q = torch.clamp_min(mask.sum(-1), 1.0)
    logs = torch.where(mask > 0, torch.log(torch.clamp_min(times, _EPS)),
                       0.0).sum(-1)
    ll = (q * torch.log(alpha) + q * alpha * torch.log(beta)
          - (alpha + 1.0) * logs)
    return -(ll / q)
