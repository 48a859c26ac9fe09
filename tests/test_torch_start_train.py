"""START's training in the port against the JAX package, on the CPU, from
the same converted weights and the same seeded numpy data: the LSTM
cell's autograd Function against autograd of its plain version, the MSE
loss, one Adam update, three ``train_step``s (losses and params within
1e-5 relative in norm), ``make_targets``, ``fit`` over two epochs (epoch
losses within 1e-5 relative), and a pickled predictor that continues to
fit as one that was never pickled."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoder_lstm as jnet
from repro.core.predictor import StragglerPredictor as JaxPredictor
from repro_torch import convert
from repro_torch.core import encoder_lstm as net
from repro_torch.core.predictor import StragglerPredictor
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_ref
from repro_torch.kernels.lstm_cell import ops as cell_ops

N_HOSTS, MAX_TASKS, HORIZON = 6, 4, 5
REL = 1e-5                    # losses and params, relative (in norm)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    """||got - want|| / ||want|| over every leaf of two params trees (or
    two arrays), in float64."""
    g = [np.asarray(x, np.float64).ravel() for x in convert.leaves(got)]
    w = [np.asarray(x, np.float64).ravel() for x in convert.leaves(want)]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g, w))
    den = sum(float((b ** 2).sum()) for b in w)
    return (num / den) ** 0.5


def _pair(seed=0):
    jp = JaxPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS, seed=seed,
                      beta_scale=300.0)
    tp = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS, seed=seed,
                            beta_scale=300.0, device="cpu")
    tp.load_params(convert.from_jax(_np(jp.params), "cpu"))
    return jp, tp


def _data(n, seed=1):
    """(T, n, input_dim) features in [0, 1) and (n, 2) targets as the
    warmup gives them: alpha >= 1, beta in interval units."""
    rng = np.random.default_rng(seed)
    dim = N_HOSTS * 11 + MAX_TASKS * 5
    xs = rng.uniform(0, 1, (HORIZON, n, dim)).astype(np.float32)
    ys = np.stack([rng.uniform(1.0, 4.0, n), rng.uniform(0.1, 3.0, n)],
                  axis=-1).astype(np.float32)
    return xs, ys


def _cell_inputs(bsz, nin, hid, seed):
    rng = np.random.default_rng(seed)
    shapes = ((bsz, nin), (bsz, hid), (bsz, hid), (nin, 4 * hid),
              (hid, 4 * hid), (4 * hid,))
    return [torch.from_numpy((rng.standard_normal(s) * k).astype(np.float32))
            for s, k in zip(shapes, (1.0, 1.0, 1.0, 0.2, 0.2, 0.1))]


@pytest.mark.parametrize("bsz,nin,hid", [(1, 32, 32), (64, 32, 32),
                                         (7, 5, 9)])
@pytest.mark.parametrize("needs", ["all", "weights", "inputs"])
def test_cell_function_gradients_equal_autograd_of_the_plain_cell(
        bsz, nin, hid, needs):
    """The autograd Function (forward, then the plain cell recomputed
    and differentiated in its backward) on CPU tensors, against autograd
    through ``lstm_cell_ref``: the same gradients for every input that
    requires grad, none for the others."""
    arrs = _cell_inputs(bsz, nin, hid, seed=bsz)
    grad_of = {"all": range(6), "weights": (3, 4, 5),
               "inputs": (0, 1, 2)}[needs]
    gen = torch.Generator().manual_seed(bsz)
    g_h, g_c = (torch.randn(bsz, hid, generator=gen) for _ in range(2))
    outs = {}
    for name, fn in (("function", cell_ops._Cell.apply),
                     ("plain", lstm_cell_ref)):
        xs = [a.clone().requires_grad_(i in grad_of)
              for i, a in enumerate(arrs)]
        h, c = fn(*xs)
        torch.autograd.backward((h, c), (g_h, g_c))
        outs[name] = (h.detach(), c.detach(), [x.grad for x in xs])
    f, p = outs["function"], outs["plain"]
    torch.testing.assert_close(f[0], p[0], rtol=0, atol=0)
    torch.testing.assert_close(f[1], p[1], rtol=0, atol=0)
    for i, (gf, gp) in enumerate(zip(f[2], p[2])):
        if i in grad_of:
            torch.testing.assert_close(gf, gp, rtol=0, atol=0)
        else:
            assert gf is None and gp is None


def test_cpu_cell_is_the_plain_cell_and_differentiable():
    """On CPU tensors the wrapper runs the plain version, which plain
    autograd differentiates; nothing launches."""
    arrs = [a.requires_grad_() for a in _cell_inputs(4, 32, 32, seed=3)]
    before = lstm_cell.launches
    h, c = lstm_cell(*arrs)
    (h.sum() + c.sum()).backward()
    assert lstm_cell.launches == before
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               for a in arrs)


def test_mse_loss_and_gradients_match_jax():
    jp, tp = _pair()
    xs, ys = _data(16)
    want, jgrads = jax.value_and_grad(jnet.mse_loss)(
        jp.params, jnp.asarray(xs), jnp.asarray(ys))
    got = net.mse_loss(tp.params, torch.from_numpy(xs), torch.from_numpy(ys))
    assert abs(float(got) - float(want)) <= REL * abs(float(want))
    loss, grads = net.loss_and_grads(tp.params, torch.from_numpy(xs),
                                     torch.from_numpy(ys))
    assert float(loss) == float(got)
    assert _rel(convert.to_numpy(grads), _np(jgrads)) <= REL


def test_adam_update_matches_jax():
    """One Adam step of the repo's optimizer from a mid-run state (step
    4, nonzero moments): fp32 bias corrections, the JAX order of ops."""
    jp, tp = _pair()
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        _np(jp.params))
    mu = jax.tree_util.tree_map(lambda g: 0.1 * g, grads)
    nu = jax.tree_util.tree_map(lambda g: 0.01 * g * g, grads)
    jstate = jnet.AdamState(step=jnp.asarray(4, jnp.int32), mu=mu, nu=nu)
    tstate = net.AdamState(step=torch.tensor(4, dtype=torch.int32),
                           mu=convert.from_jax(mu, "cpu"),
                           nu=convert.from_jax(nu, "cpu"))
    jparams, jnew = jnet.adam_update(jp.params, grads, jstate, lr=1e-3)
    tparams, tnew = net.adam_update(tp.params, convert.from_jax(grads, "cpu"),
                                    tstate, lr=1e-3)
    assert int(tnew.step) == int(jnew.step) == 5
    assert tnew.step.dtype == torch.int32
    for got, want in ((tparams, jparams), (tnew.mu, jnew.mu),
                      (tnew.nu, jnew.nu)):
        assert _rel(convert.to_numpy(got), _np(want)) <= REL


def test_three_train_steps_match_jax():
    jp, tp = _pair()
    xs, ys = _data(32)
    jparams, jopt = jp.params, jnet.adam_init(jp.params)
    tparams, topt = tp.params, net.adam_init(tp.params)
    for i in range(3):
        sl = slice(8 * i, 8 * i + 16)
        jparams, jopt, jloss = jnet.train_step(
            jparams, jopt, jnp.asarray(xs[:, sl]), jnp.asarray(ys[sl]),
            lr=1e-3)
        tparams, topt, tloss = net.train_step(
            tparams, topt, torch.from_numpy(xs[:, sl]),
            torch.from_numpy(ys[sl]), lr=1e-3)
        assert abs(float(tloss) - float(jloss)) <= REL * abs(float(jloss))
        assert _rel(convert.to_numpy(tparams), _np(jparams)) <= REL
        assert not any(p.requires_grad for p in convert.leaves(tparams))
        assert not tloss.requires_grad
    assert int(topt.step) == 3


def test_make_targets_matches_jax():
    jp, tp = _pair()
    rng = np.random.default_rng(2)
    times = rng.pareto(2.0, (12, 10)).astype(np.float32) * 300.0 + 60.0
    mask = (np.arange(10)[None, :] < rng.integers(2, 11, 12)[:, None])
    for m in (None, mask):
        want = np.asarray(jp.make_targets(
            jnp.asarray(times), None if m is None else jnp.asarray(m)))
        got = tp.make_targets(
            times, None if m is None else torch.from_numpy(m))
        assert got.device.type == "cpu" and got.shape == (12, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=0)


@pytest.mark.parametrize("n", [29, 150])
def test_fit_matches_jax(n):
    """Two epochs: one whole batch (n <= 64), and three batches of 64
    with the partial one dropped (n = 150)."""
    jp, tp = _pair()
    xs, ys = _data(n, seed=n)
    want = jp.fit(xs, ys, epochs=2, lr=1e-3)
    got = tp.fit(xs, ys, epochs=2, lr=1e-3)
    assert len(got) == 2 and tp.losses is got
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert _rel(convert.to_numpy(tp.params), _np(jp.params)) <= REL
    assert int(tp.opt.step) == int(jp.opt.step)


def test_load_params_resets_adam():
    _, tp = _pair()
    tp.fit(*_data(16), epochs=1, lr=1e-3)
    assert int(tp.opt.step) == 1
    tp.load_params(convert.to_numpy(tp.params))
    assert int(tp.opt.step) == 0
    assert all(float(m.abs().sum()) == 0.0 for m in convert.leaves(tp.opt.mu))


def test_a_pickled_predictor_continues_fit_to_the_same_losses():
    """Adam's moments and step travel with the pickle: a predictor fit
    for one epoch, pickled and restored, fits its next epoch to the same
    loss and params as one that was never pickled."""
    xs, ys = _data(40)
    a, b = (StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                               device="cpu") for _ in range(2))
    for p in (a, b):
        p.fit(xs, ys, epochs=1, lr=1e-3)
    b = pickle.loads(pickle.dumps(b))
    assert int(b.opt.step) == 1
    for p in (a, b):
        p.fit(xs, ys, epochs=1, lr=1e-3)
    assert a.losses == b.losses and len(a.losses) == 2
    assert _rel(convert.to_numpy(b.params), convert.to_numpy(a.params)) == 0
