"""The port's features, Pareto model and Encoder-LSTM functions against
the JAX package's, on the CPU, with weights carried over by
``convert.from_jax`` and inputs made by numpy from a seed (Tier-1
bound from tests/tolerance.py; the numpy functions bitwise)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoder_lstm as jnet
from repro.core import features as jfeat
from repro.core import pareto as jpar
from repro_torch import convert
from repro_torch.core import encoder_lstm as tnet
from repro_torch.core import features as tfeat
from repro_torch.core import pareto as tpar
from tolerance import assert_tier1

N_HOSTS, MAX_TASKS, T = 8, 4, 5
# values that come out of cancellation (LSTM states from random states,
# the Pareto NLL) sit near zero, where a relative bound measures noise:
# they are held to tests/test_kernels.py's fp32 cell tolerance instead
CANCEL_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


# --------------------------------- features --------------------------------

def _host_inputs(rng, n=N_HOSTS):
    return dict(util=rng.uniform(0, 1, (n, 4)),
                cap=rng.uniform(1, 10, (n, 4)),
                cost=rng.uniform(3, 5, n),
                power_max=rng.uniform(200, 300, n),
                n_tasks=rng.integers(0, 6, n).astype(np.float64))


def test_feature_constants_match():
    assert tfeat.HOST_FEATURES == jfeat.HOST_FEATURES
    assert tfeat.TASK_FEATURES == jfeat.TASK_FEATURES
    assert tfeat.input_dim(400, 10) == jfeat.input_dim(400, 10) == 4450


def test_host_matrix_matches_jax_and_numpy():
    kw = _host_inputs(np.random.default_rng(0))
    got = _np(tfeat.host_matrix(**{k: _t(v) for k, v in kw.items()}))
    assert_tier1(got, np.asarray(jfeat.host_matrix(**kw)))
    np.testing.assert_array_equal(tfeat.host_matrix_np(**kw),
                                  jfeat.host_matrix_np(**kw))


@pytest.mark.parametrize("q", [1, 3, MAX_TASKS, MAX_TASKS + 2])
def test_task_matrix_matches_jax(q):
    rng = np.random.default_rng(q)
    req = rng.uniform(0, 1, (q, 4)).astype(np.float32)
    prev = rng.integers(-1, N_HOSTS, q)
    got = _np(tfeat.task_matrix(_t(req), torch.from_numpy(prev), N_HOSTS,
                                MAX_TASKS))
    want = np.asarray(jfeat.task_matrix(req, prev, N_HOSTS, MAX_TASKS))
    assert got.shape == (MAX_TASKS, tfeat.TASK_FEATURES)
    assert_tier1(got, want)


def test_task_matrix_batch_np_is_the_jax_package_function():
    rng = np.random.default_rng(1)
    counts = np.array([2, 4, 1])
    rows = np.repeat(np.arange(3), counts)
    cols = np.concatenate([np.arange(c) for c in counts])
    req = rng.uniform(0, 1, (counts.sum(), 4))
    prev = rng.integers(-1, N_HOSTS, counts.sum())
    args = (req, prev, rows, cols, 3, N_HOSTS, MAX_TASKS)
    np.testing.assert_array_equal(tfeat.task_matrix_batch_np(*args),
                                  jfeat.task_matrix_batch_np(*args))


@pytest.mark.parametrize("lead", [(), (T,), (T, 3)])
def test_flatten_inputs_matches_jax(lead):
    rng = np.random.default_rng(2)
    mh = rng.uniform(0, 1, (*lead, N_HOSTS, 11)).astype(np.float32)
    mt = rng.uniform(0, 1, (*lead, MAX_TASKS, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tfeat.flatten_inputs(_t(mh), _t(mt))),
        np.asarray(jfeat.flatten_inputs(mh, mt)))


def test_flatten_inputs_refuses_mismatched_leading_dims():
    with pytest.raises(ValueError):
        tfeat.flatten_inputs(torch.zeros(2, N_HOSTS, 11),
                             torch.zeros(3, MAX_TASKS, 5))


# ---------------------------------- pareto ---------------------------------

def _pareto_inputs(seed, shape=(6, 7)):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(1.2, 4.0, shape[:-1]).astype(np.float32)
    beta = rng.uniform(0.5, 3.0, shape[:-1]).astype(np.float32)
    times = (beta[..., None] * rng.uniform(0.01, 1, shape)
             ** (-1 / alpha[..., None])).astype(np.float32)
    mask = (rng.uniform(0, 1, shape) < 0.7).astype(np.float32)
    mask[..., 0] = 1.0
    return alpha, beta, times, mask


def test_pareto_constants_match():
    assert tpar.DEFAULT_K == jpar.DEFAULT_K
    assert (tpar._EPS, tpar._ALPHA_MIN, tpar._ALPHA_MAX) == \
        (jpar._EPS, jpar._ALPHA_MIN, jpar._ALPHA_MAX)


@pytest.mark.parametrize("shape", [(5,), (6, 7), (2, 3, 10)])
def test_pareto_twins_match_jax(shape):
    alpha, beta, times, mask = _pareto_inputs(len(shape), shape)
    a, b, tm, m = _t(alpha), _t(beta), _t(times), _t(mask)
    x = times[..., 0]
    pairs = [
        (tpar.pareto_cdf(_t(x), a, b), jpar.pareto_cdf(x, alpha, beta)),
        (tpar.pareto_cdf(b * 0.5, a, b), jpar.pareto_cdf(beta * 0.5, alpha,
                                                         beta)),
        (tpar.pareto_mean(a, b), jpar.pareto_mean(alpha, beta)),
        (tpar.pareto_quantile(a, b, 0.9),
         jpar.pareto_quantile(alpha, beta, 0.9)),
        (tpar.straggler_threshold(a, b), jpar.straggler_threshold(alpha,
                                                                  beta)),
        (tpar.expected_stragglers(7.0, a, b, k=1.2),
         jpar.expected_stragglers(7.0, alpha, beta, k=1.2)),
        (tpar.straggler_labels(tm, a, b),
         jpar.straggler_labels(times, alpha, beta)),
    ]
    pairs += list(zip(tpar.fit_pareto(tm), jpar.fit_pareto(times)))
    pairs += list(zip(tpar.fit_pareto(tm, m), jpar.fit_pareto(times, mask)))
    for i, (got, want) in enumerate(pairs):
        assert_tier1(_np(got), np.asarray(want), context=f"pair {i}")
    for mk_t, mk_j in ((None, None), (m, mask)):
        np.testing.assert_allclose(
            _np(tpar.pareto_nll(tm, a, b, mk_t)),
            np.asarray(jpar.pareto_nll(times, alpha, beta, mk_j)),
            **CANCEL_TOL)


def test_f1_scores_match_jax():
    rng = np.random.default_rng(4)
    pred = (rng.uniform(0, 1, 40) < 0.5).astype(np.float32)
    truth = (rng.uniform(0, 1, 40) < 0.4).astype(np.float32)
    mask = (rng.uniform(0, 1, 40) < 0.8).astype(np.float32)
    assert_tier1(_np(tpar.f1_score(_t(pred), _t(truth))),
                 np.asarray(jpar.f1_score(pred, truth)))
    assert_tier1(_np(tpar.f1_score(_t(pred), _t(truth), _t(mask))),
                 np.asarray(jpar.f1_score(pred, truth, mask)))
    assert_tier1(_np(tpar.f1_score_paper(7.0, 3.0)),
                 np.asarray(jpar.f1_score_paper(7.0, 3.0)))


def test_pareto_numpy_copies_are_the_jax_package_functions():
    alpha, beta, times, mask = _pareto_inputs(5)
    for got, want in zip(tpar.fit_pareto_np(times, mask),
                         jpar.fit_pareto_np(times, mask)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpar.straggler_threshold_np(alpha, beta),
                                  jpar.straggler_threshold_np(alpha, beta))
    np.testing.assert_array_equal(tpar.pareto_quantile_np(alpha, beta, 0.7),
                                  jpar.pareto_quantile_np(alpha, beta, 0.7))


def test_sample_pareto_is_seeded_and_pareto_distributed():
    draw = lambda: tpar.sample_pareto(  # noqa: E731
        torch.Generator().manual_seed(3), 3.0, 2.0, (20000,))
    x = draw()
    torch.testing.assert_close(x, draw(), rtol=0, atol=0)
    assert x.shape == (20000,) and float(x.min()) >= 2.0
    # mean alpha*beta/(alpha-1) = 3; P(X > 4) = (4/2)^-3 = 1/8
    assert abs(float(x.mean()) - 3.0) < 0.1
    assert abs(float((x > 4.0).float().mean()) - 0.125) < 0.01


# ------------------------------- encoder-LSTM ------------------------------

def _params(input_dim, seed=0):
    jp = jnet.init_params(jax.random.PRNGKey(seed), input_dim)
    return jp, convert.from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")


def _input_dim():
    return tfeat.input_dim(N_HOSTS, MAX_TASKS)


def test_init_params_shapes_match_jax_and_are_seeded():
    jp, _ = _params(_input_dim())
    tp = tnet.init_params(0, _input_dim(), device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: tuple(a.shape), tree)
    assert shapes(convert.to_numpy(tp)) == shapes(
        jax.tree_util.tree_map(np.asarray, jp))
    again = tnet.init_params(0, _input_dim(), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_numpy(tp)),
                    jax.tree_util.tree_leaves(convert.to_numpy(again))):
        np.testing.assert_array_equal(a, b)


def test_convert_round_trip_is_a_plain_copy():
    jp, tp = _params(_input_dim())
    back = convert.to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                              jp))
    flat_t = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_t) == 4 * 2 + 2 * 3 + 2
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)


def test_softplus_is_jax_softplus():
    x = np.array([-100, -30, -1, 0, 1e-3, 1, 19.9, 20.1, 30, 100],
                 np.float32)
    assert_tier1(_np(tnet.softplus(_t(x))), np.asarray(jax.nn.softplus(x)))


def _xs(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (T, n, _input_dim())).astype(np.float32)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_encoder_and_cell_match_jax(n):
    jp, tp = _params(_input_dim())
    xs = _xs(n)
    assert_tier1(_np(tnet.encoder_apply(tp, _t(xs[0]))),
                 np.asarray(jnet.encoder_apply(jp, xs[0])))
    rng = np.random.default_rng(n)
    h, c, x = (rng.standard_normal((T, n, 32)).astype(np.float32)
               for _ in range(3))
    for li in range(2):
        for fn_t, fn_j in ((tnet.lstm_cell_apply, jnet.lstm_cell_apply),
                           (tnet._cell_apply, jnet._cell_apply)):
            got = fn_t(tp["lstm"][li], _t(h), _t(c), _t(x))
            want = fn_j(jp["lstm"][li], h, c, x)
            for g, w in zip(got, want):
                np.testing.assert_allclose(_np(g), np.asarray(w),
                                           **CANCEL_TOL)


@pytest.mark.parametrize("n", [1, 5])
def test_step_and_step_decoded_match_jax(n):
    jp, tp = _params(_input_dim())
    xs = _xs(n, seed=1)
    js = jnet.init_state(jp, (n,))
    ts = tnet.init_state(tp, (n,))
    assert ts.h.shape == js.h.shape
    for x in xs:
        js, jout = jnet.step(jp, js, x)
        ts, tout = tnet.step(tp, ts, _t(x))
        assert_tier1(_np(tout), np.asarray(jout))
    lam = np.random.default_rng(n).uniform(0, 1, (n, 32)).astype(np.float32)
    js2, jout = jnet.step_decoded(jp, js, lam)
    ts2, tout = tnet.step_decoded(tp, ts, _t(lam))
    assert_tier1(_np(tout), np.asarray(jout))
    np.testing.assert_allclose(_np(ts2.h), np.asarray(js2.h), **CANCEL_TOL)
    np.testing.assert_allclose(_np(ts2.c), np.asarray(js2.c), **CANCEL_TOL)


@pytest.mark.parametrize("t", [1, 2, 5])
def test_ema_smooth_matches_jax(t):
    seq = np.random.default_rng(t).uniform(0, 1, (t, 4, 6)) \
        .astype(np.float32)
    assert_tier1(_np(tnet.ema_smooth(_t(seq))),
                 np.asarray(jnet.ema_smooth(seq)))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13])
def test_sequence_functions_match_jax(n):
    jp, tp = _params(_input_dim(), seed=n)
    xs = _xs(n, seed=n)
    assert_tier1(_np(tnet.predict_sequence(tp, _t(xs))),
                 np.asarray(jnet.predict_sequence(jp, xs)))
    assert_tier1(_np(tnet.predict_sequence_opt(tp, _t(xs))),
                 np.asarray(jnet.predict_sequence_opt(jp, xs, unroll=2)))
    host_dim = N_HOSTS * tfeat.HOST_FEATURES
    mh = xs[:, 0, :host_dim]
    mt = xs[0, :, host_dim:]
    mh_ema = np.asarray(jnet.ema_smooth(mh))
    lam_j = jnet.encoder_hoisted(jp, mh_ema, mt)
    lam_t = tnet.encoder_hoisted(tp, _t(mh_ema), _t(mt))
    assert lam_t.shape == (T, n, tnet.ENC_OUT)
    assert_tier1(_np(lam_t), np.asarray(lam_j))
    assert_tier1(_np(tnet.decode_sequence(tp, lam_t)),
                 np.asarray(jnet.decode_sequence(jp, lam_j)))
