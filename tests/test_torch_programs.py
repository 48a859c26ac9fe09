"""The port's compiled programs (``repro_torch.core.programs``, the
counterpart of ``jax.jit``) on the CPU, where each program's cache runs
its data flow eagerly on the entry's static buffers:

* compile counts: on one scripted call sequence the growth of
  ``fused_compile_count()`` and ``compile_count`` equals the JAX
  package's, call by call, from cleared caches on both sides;
* a warm clone (a freshly unpickled technique) grows the counts by 0 and
  stages at most one copy per interval plus the ring's rebuild;
* at most one capture per bucket, none on repeats;
* through the cache, predictions, ``fit`` and IGRU-SD's training equal
  the eager functions bit for bit;
* weights and rings: predictors sharing entries keep their own weights
  and M_H history; new weights (``fit``, ``load_params``) are picked up;
  a scratch predictor's ``fit`` leaves the live one's params alone;
* ``_unroll`` and ``autotune_unroll`` against the JAX package's API, and
  the pinned choice across pickling.
"""
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.core import predictor as jpred
from repro.service import retrain as jretrain
from repro_torch import convert
from repro_torch.core import encoder_lstm as net
from repro_torch.core import features, programs
from repro_torch.core import predictor as tpred
from repro_torch.core.predictor import StragglerPredictor
from repro_torch.service import retrain
from repro_torch.sim import sweep
from repro_torch.sim.engine import Simulation
from repro_torch.sim.techniques import baselines

N_HOSTS, MAX_TASKS = 5, 3


def _row(rng, n_hosts=N_HOSTS):
    return rng.uniform(0, 1, (n_hosts, features.HOST_FEATURES)) \
        .astype(np.float32)


def _jobs(rng, n, max_tasks=MAX_TASKS):
    mt = rng.uniform(0, 1, (n, max_tasks, features.TASK_FEATURES)) \
        .astype(np.float32)
    q = rng.integers(1, max_tasks + 1, n).astype(np.float32)
    return mt, q


def _pair():
    jp = jpred.StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS)
    tp = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                            device="cpu")
    tp.load_params(convert.from_jax(
        jax.tree_util.tree_map(np.asarray, jp.params), "cpu"))
    return jp, tp


def _counts(p) -> tuple:
    return p.compile_count, tpred.fused_compile_count()


def _jax_counts(p) -> tuple:
    return p.compile_count, jpred.fused_compile_count()


def _script(rng):
    """The call sequence: ``predict_interval`` at counts 1-17 without and
    with ``per_task`` (one idle interval every fifth, so the catch-up
    program runs), ``predict_features`` at three bucket sizes both ways,
    ``predict_tenants`` both ways (a repeat included), ``fit`` at two
    batch shapes, then the service's shadow evaluation twice."""
    seq = np.stack([_row(rng) for _ in range(5)])
    calls = []
    for per_task in (False, True):
        for n in range(1, 18):
            rows = [_row(rng) for _ in range(2 if n % 5 == 0 else 1)]
            calls.append(("interval", rows, *_jobs(rng, n), per_task))
    for per_task in (False, True):
        for n in (1, 3, 5):
            calls.append(("features", seq, *_jobs(rng, n), per_task))
    for per_task in (False, True):
        for ns in ((1, 2), (3, 4, 5), (1, 2)):
            jobs = [_jobs(rng, n) for n in ns]
            calls.append(("tenants", seq, jobs, per_task))
    dim = features.input_dim(N_HOSTS, MAX_TASKS)
    xs = rng.uniform(0, 1, (5, 10, dim)).astype(np.float32)
    ys = rng.uniform(1, 2, (10, 2)).astype(np.float32)
    calls += [("fit", xs, ys, 4), ("fit", xs, ys, 64)]
    calls += [("shadow", xs[:, :3], ys[:3])] * 2
    return calls


def _play(p, call):
    kind = call[0]
    if kind == "interval":
        _, rows, mt, q, per_task = call
        for r in rows:
            p.push_host_row(r)
        p.predict_interval(mt, q, per_task=per_task)
    elif kind == "features":
        _, seq, mt, q, per_task = call
        p.predict_features(seq, mt, q, per_task=per_task)
    elif kind == "tenants":
        _, seq, jobs, per_task = call
        p.predict_tenants([seq] * len(jobs), [mt for mt, _ in jobs],
                          [q for _, q in jobs], per_task=per_task)
    elif kind == "shadow":
        _, xs, ys = call
        if isinstance(p, StragglerPredictor):
            retrain.shadow_loss(p.params, xs, ys)
        else:
            jretrain.shadow_loss(p.params, xs, ys)
    else:
        _, xs, ys, batch = call
        p.fit(xs, ys, epochs=2, batch=batch)


def test_compile_count_growth_matches_jax():
    """From cleared caches, every call grows ``compile_count`` and
    ``fused_compile_count()`` exactly as the JAX package's (XLA compiles
    there, captures here): new batch shapes and exact shapes, the
    per-task variants, the catch-up roll once, the serving batch's own
    program, the per-task tail once per bucket, nothing for ``fit``
    (``train_step`` is counted by neither, in both packages), and the
    shadow evaluation's network once.  No weak
    type splits a JAX cache entry on this sequence, so the rules agree
    call for call."""
    jax.clear_caches()
    programs.clear()
    jp, tp = _pair()
    seen = []
    for call in _script(np.random.default_rng(0)):
        _play(jp, call)
        _play(tp, call)
        seen.append((call[0], _counts(tp), _jax_counts(jp)))
    assert [s[1] for s in seen] == [s[2] for s in seen], seen
    assert seen[-1][1] == (31, 27)
    # a second predictor of the same shapes reuses every entry
    jp2, tp2 = _pair()
    before = _counts(tp2), _jax_counts(jp2)
    for call in _script(np.random.default_rng(1)):
        _play(jp2, call)
        _play(tp2, call)
    assert (_counts(tp2), _jax_counts(jp2)) == before


@pytest.fixture(scope="module")
def start_cell():
    spec = sweep.SweepSpec(
        techniques=("start",), seeds=(0,), scenarios=("planetlab",),
        n_hosts=16, n_intervals=30, arrival_rate=0.8, max_workers=1,
        pretrain_epochs=2, technique_kwargs={"start": {"device": "cpu"}})
    cfg = spec.cell_config("planetlab", 0)
    tech = sweep.make_technique("start", cfg, pretrain_epochs=2,
                                technique_kwargs={"device": "cpu"})
    return pickle.dumps(tech), cfg


def test_warm_clone_captures_nothing_and_stages_once_an_interval(
        start_cell):
    """The counterpart of the JAX package's zero-retrace warm cell: once
    a cell has warmed its buckets, a freshly unpickled technique runs a
    whole cell with no new capture, and stages at most one copy per
    interval plus the ring's rebuild after unpickling."""
    tech_bytes, cfg = start_cell
    Simulation(cfg, technique=pickle.loads(tech_bytes)).run()
    tech = pickle.loads(tech_bytes)
    pred = tech._controller.predictor
    before = pred.compile_count
    captures = programs.stats["captures"]
    Simulation(cfg, technique=tech).run()
    assert pred.compile_count - before == 0
    assert programs.stats["captures"] == captures
    assert 0 < pred.h2d_stages <= cfg.n_intervals + 1


def test_predict_sequence_captures_once_per_bucket():
    """The counterpart of the JAX bucketed-jit test: sweeping the job
    count grows the ``predict_sequence`` cache by at most one entry per
    bucket, and repeats (or new counts in seen buckets) by nothing."""
    pred = StragglerPredictor(n_hosts=3, max_tasks=4, device="cpu")
    rng = np.random.default_rng(0)
    mh = np.stack([_row(rng, 3) for _ in range(5)])

    def run_counts(counts):
        for n in counts:
            mt, _ = _jobs(rng, n, 4)
            out = pred.predict_features(mh, mt, np.full(n, 4.0, np.float32))
            assert out.e_s.shape == (n,)

    before = net.PREDICT_SEQUENCE.cache_size()
    run_counts([1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16])
    assert pred.buckets_used == {1, 2, 4, 8, 16}
    assert net.PREDICT_SEQUENCE.cache_size() - before \
        <= len(pred.buckets_used)
    mid = net.PREDICT_SEQUENCE.cache_size()
    run_counts([1, 3, 5, 7, 9, 11, 13, 15, 16, 2, 10])
    assert net.PREDICT_SEQUENCE.cache_size() == mid


def test_start_cell_captures_at_most_once_per_bucket(start_cell):
    """End to end: a START cell captures the fused step at most once per
    (bucket, per_task) it used, and the catch-up roll at most once."""
    tech_bytes, cfg = start_cell
    programs.clear()
    tech = pickle.loads(tech_bytes)
    Simulation(cfg, technique=tech).run()
    pred = tech._controller.predictor
    assert 0 < tpred.FUSED_STEP.cache_size() <= 2 * len(pred.buckets_used)
    assert tpred.RING_ROLL.cache_size() <= 1


# --------------------------- cache against eager ---------------------------


def _eager_interval(params, hist, mt, q, nb, per_task, k, bs, horizon):
    """The fused step on inputs assembled here from the host rows: the
    ring is the ``horizon`` rows before the newest (left-padded with the
    oldest), the packed vector [k, beta_scale, newest row, q padded with
    1, M_T padded with 0]."""
    prev = list(hist[:-1]) or [hist[0]]
    while len(prev) < horizon:
        prev.insert(0, prev[0])
    ring = torch.from_numpy(np.stack(prev[-horizon:]).reshape(horizon, -1))
    n = mt.shape[0]
    qp = np.ones(nb, np.float32)
    qp[:n] = q
    mtp = np.zeros((nb, mt[0].size), np.float32)
    mtp[:n] = mt.reshape(n, -1)
    packed = np.concatenate([np.float32([k, bs]), hist[-1].reshape(-1), qp,
                             mtp.reshape(-1)])
    _, out = tpred._fused_step(params, ring, torch.from_numpy(packed),
                               nb=nb, task_dim=mtp.shape[1],
                               per_task=per_task)
    return out.numpy()


@pytest.mark.parametrize("per_task", [False, True])
def test_fused_program_equals_the_eager_step(per_task):
    """Every interval's answer through the fused-step program (ring
    rebuilt cold, rolled warm, caught up after idle intervals) equals the
    eager ``_fused_step`` on independently assembled inputs, bit for
    bit."""
    tp = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                            device="cpu", seed=3)
    rng = np.random.default_rng(5)
    hist = []
    for step, n in enumerate([2, 3, 1, 5, 4, 7, 2, 9, 3]):
        for _ in range(3 if step == 5 else 1):
            hist.append(_row(rng))
            tp.push_host_row(hist[-1])
        mt, q = _jobs(rng, n)
        got = tp.predict_interval(mt, q, per_task=per_task)
        want = _eager_interval(tp.params, hist[-6:], mt, q,
                               tp.batch_size(n), per_task, tp.k,
                               tp.beta_scale, tp.horizon)
        if per_task:
            got = np.concatenate([got[0][:, None], got[1]], axis=1)
        np.testing.assert_array_equal(got, want[:n])


def test_unfused_and_tenant_programs_equal_the_eager_functions():
    """``predict_features``, ``predict`` and ``predict_tenants`` through
    their programs equal the eager network and tails bit for bit."""
    tp = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                            device="cpu", seed=4)
    rng = np.random.default_rng(6)
    seq = np.stack([_row(rng) for _ in range(5)])
    k = torch.tensor(tp.k, dtype=torch.float32)
    bs = torch.tensor(tp.beta_scale, dtype=torch.float32)
    for n in (1, 3, 6):
        mt, q = _jobs(rng, n)
        nb = tpred.bucket_size(n)
        xs = np.zeros((5, nb, tp.input_dim), np.float32)
        xs[:, :, :tp.host_dim] = seq.reshape(5, 1, -1)
        xs[:, :n, tp.host_dim:] = mt.reshape(1, n, -1)
        qp = np.ones(nb, np.float32)
        qp[:n] = q
        ab = net.predict_sequence(tp.params, torch.from_numpy(xs))
        want = tpred._pareto_tail(ab, torch.from_numpy(qp), k, bs)
        got = tp.predict_features(seq, mt, q)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy()[:n])
        e_s, scores = tp.predict_features(seq, mt, q, per_task=True)
        want = tpred._pareto_tail_per_task(
            ab, torch.from_numpy(qp), k, bs,
            torch.from_numpy(xs[-1, :, tp.host_dim:])).numpy()
        np.testing.assert_array_equal(e_s, want[:n, 0])
        np.testing.assert_array_equal(scores, want[:n, 1:])
    seqs = [np.stack([_row(rng) for _ in range(5)]) for _ in range(3)]
    jobs = [_jobs(rng, n) for n in (2, 1, 3)]
    nb = tp.batch_size(6)
    xs = np.zeros((5, nb, tp.input_dim), np.float32)
    qp = np.ones(nb, np.float32)
    lo = 0
    for s, (mt, q) in zip(seqs, jobs):
        n = mt.shape[0]
        xs[:, lo:lo + n, :tp.host_dim] = s.reshape(5, 1, -1)
        xs[:, lo:lo + n, tp.host_dim:] = mt.reshape(1, n, -1)
        qp[lo:lo + n] = q
        lo += n
    xs[:, lo:, :tp.host_dim] = seqs[-1].reshape(5, 1, -1)
    ab = net.predict_sequence_opt(tp.params, torch.from_numpy(xs))
    want = tpred._pareto_tail(ab, torch.from_numpy(qp), k, bs)[3].numpy()
    got = tp.predict_tenants(seqs, [mt for mt, _ in jobs],
                             [q for _, q in jobs])
    np.testing.assert_array_equal(np.concatenate(got), want[:6])


def test_fit_equals_eager_train_steps():
    """``fit`` through the ``train_step`` program (params and Adam state
    in its buffers, each minibatch gathered into its inputs) equals the eager
    ``train_step`` loop over the same minibatches: epoch losses, every
    param and the whole Adam state, bit for bit."""
    tp = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                            device="cpu", seed=2)
    rng = np.random.default_rng(8)
    xs = rng.uniform(0, 1, (5, 11, tp.input_dim)).astype(np.float32)
    ys = rng.uniform(1, 2, (11, 2)).astype(np.float32)
    params, opt = tp.params, tp.opt
    order_rng = np.random.default_rng(tp.seed)
    want = []
    xs_t, ys_t = torch.from_numpy(xs), torch.from_numpy(ys)
    for _ in range(3):
        order = order_rng.permutation(11)[:8]
        losses = []
        for s in (0, 4):
            idx = torch.from_numpy(order[s:s + 4])
            params, opt, loss = net.train_step(params, opt, xs_t[:, idx],
                                               ys_t[idx], lr=1e-3)
            losses.append(float(loss))
        want.append(float(np.mean(losses)))
    got = tp.fit(xs, ys, epochs=3, lr=1e-3, batch=4)
    assert got == want
    for g, w in zip(convert.leaves((tp.params, tp.opt)),
                    convert.leaves((params, opt))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert isinstance(tp.opt, net.AdamState)


def test_fit_at_growing_n_reuses_one_train_step_capture():
    """As JAX keys ``train_step`` on the minibatch ``xs[:, idx]``, fits on
    a growing data set share one ``train_step`` entry once N exceeds the
    batch (a data set of N <= batch is one minibatch of its own shape):
    the port's cache grows call by call as JAX's does, and no entry holds
    more than a minibatch of data."""
    from repro.core import encoder_lstm as jnet
    jp, tp = _pair()
    rng = np.random.default_rng(21)
    growth = []
    for n in (10, 70, 100, 150, 10):
        xs = rng.uniform(0, 1, (5, n, tp.input_dim)).astype(np.float32)
        ys = rng.uniform(1, 2, (n, 2)).astype(np.float32)
        before = net.TRAIN_STEP.cache_size(), jnet.train_step._cache_size()
        tp.fit(xs, ys, epochs=1, lr=1e-3)
        jp.fit(xs, ys, epochs=1, lr=1e-3)
        growth.append((net.TRAIN_STEP.cache_size() - before[0],
                       jnet.train_step._cache_size() - before[1]))
    assert [g[0] for g in growth] == [g[1] for g in growth], growth
    assert [g[0] for g in growth][2:] == [0, 0, 0], growth
    assert all(e.args[2].shape[1] <= 64
               for e in net.TRAIN_STEP._entries.values())


def test_igru_training_equals_eager_gru_steps():
    """IGRU-SD's ``train`` through the ``gru_step`` program equals the
    eager ``_gru_step`` loop from the same init, bit for bit."""
    pol = baselines.IGRUSD(seed=3, device="cpu")
    rng = np.random.default_rng(9)
    xs = rng.uniform(0, 1, (5, 12, 3)).astype(np.float32)
    y = rng.uniform(0.5, 2, 12).astype(np.float32)
    params = pol.params
    opt = net.adam_init(params)
    for _ in range(4):
        params, opt, _ = baselines._gru_step(
            params, opt, torch.from_numpy(xs), torch.from_numpy(y))
    pol.train(xs, y, epochs=4)
    for g, w in zip(convert.leaves(pol.params), convert.leaves(params)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------- weights and rings ----------------------------


def _solo(seed, hist_seed, n_intervals=6):
    p = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                           device="cpu", seed=seed)
    rng = np.random.default_rng(hist_seed)
    out = []
    for step in range(n_intervals):
        for _ in range(2 if step == 3 else 1):
            p.push_host_row(_row(rng))
        out.append(p.predict_interval(*_jobs(rng, 1 + step % 3)))
    return out


def test_interleaved_predictors_keep_their_weights_and_rings():
    """Two predictors of one shape (so one set of entries and one static
    ring) with different weights and host histories alternate intervals,
    one of them catching up after an idle interval: each gets what it
    gets alone."""
    alone = [_solo(1, 10), _solo(2, 20)]
    ps = [StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                             device="cpu", seed=s) for s in (1, 2)]
    rngs = [np.random.default_rng(s) for s in (10, 20)]
    for step in range(6):
        for i, (p, rng) in enumerate(zip(ps, rngs)):
            for _ in range(2 if step == 3 else 1):
                p.push_host_row(_row(rng))
            got = p.predict_interval(*_jobs(rng, 1 + step % 3))
            np.testing.assert_array_equal(got, alone[i][step])


def test_new_weights_are_picked_up_and_a_scratch_fit_aliases_nothing():
    """After ``fit`` and after ``load_params`` the next interval uses the
    new weights (it equals a fresh predictor's holding them); a scratch
    predictor fitting from the live one's params leaves those untouched,
    and the two hold no tensor in common."""
    live = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                              device="cpu", seed=5)
    rng = np.random.default_rng(11)
    rows = [_row(rng) for _ in range(3)]

    def fresh_answer(params, mt, q):
        p = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                               device="cpu")
        p.load_params(params)
        for r in rows:
            p.push_host_row(r)
        return p.predict_interval(mt, q)

    def live_answer(mt, q):
        live._ring = None                 # rebuild from the same rows
        live._row_hist.clear()
        for r in rows:
            live.push_host_row(r)
        return live.predict_interval(mt, q)

    mt, q = _jobs(rng, 3)
    live_answer(mt, q)
    xs = rng.uniform(0, 1, (5, 6, live.input_dim)).astype(np.float32)
    ys = rng.uniform(1, 2, (6, 2)).astype(np.float32)
    live.fit(xs, ys, epochs=2, lr=1e-2)
    np.testing.assert_array_equal(live_answer(mt, q),
                                  fresh_answer(live.params, mt, q))
    other = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                               device="cpu", seed=9)
    live.load_params(other.params)
    np.testing.assert_array_equal(live_answer(mt, q),
                                  fresh_answer(other.params, mt, q))
    with torch.no_grad():                 # in place: the version changes
        live.params["head"]["b"].add_(0.5)
    np.testing.assert_array_equal(live_answer(mt, q),
                                  fresh_answer(live.params, mt, q))
    before = [t.clone() for t in convert.leaves(live.params)]
    scratch = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                                 device="cpu", seed=5)
    scratch.params = live.params
    scratch.fit(xs, ys, epochs=2, lr=1e-2)
    for t, b in zip(convert.leaves(live.params), before):
        torch.testing.assert_close(t, b, rtol=0, atol=0)
    ptrs = {t.data_ptr() for t in convert.leaves(live.params)}
    assert not ptrs & {t.data_ptr() for t in convert.leaves(
        (scratch.params, scratch.opt))}


def test_interleaved_training_runs_keep_their_own_state():
    """Two ``train_step`` runs of one key alternating step by step (the
    service's scratch fit beside another fit) each end where they end
    alone: the entry's state is reloaded whenever the other run used
    it."""
    p = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                           device="cpu", seed=7)
    rng = np.random.default_rng(12)
    data = [(rng.uniform(0, 1, (5, 8, p.input_dim)).astype(np.float32),
             rng.uniform(1, 2, (8, 2)).astype(np.float32))
            for _ in range(2)]
    idx = [np.array([0, 2, 4, 6]), np.array([7, 5, 3, 1])]

    def alone(xs, ys):
        s = net.Training(p.params, p.opt, xs, ys, 4, 1e-3)
        losses = [s.step(i) for i in idx * 2]
        return losses, s.result()

    want = [alone(*d) for d in data]
    runs = [net.Training(p.params, p.opt, xs, ys, 4, 1e-3)
            for xs, ys in data]
    losses = [[], []]
    for i in idx * 2:
        for r, run in enumerate(runs):
            losses[r].append(run.step(i))
    for r, run in enumerate(runs):
        assert losses[r] == want[r][0]
        for g, w in zip(convert.leaves(run.result()),
                        convert.leaves(want[r][1])):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


# --------------------------------- unroll ----------------------------------


def test_unroll_precedence_matches_jax():
    for kw in ({}, {"unroll": 3}, {"horizon": 1}):
        jp = jpred.StragglerPredictor(n_hosts=2, max_tasks=2, **kw)
        tp = StragglerPredictor(n_hosts=2, max_tasks=2, device="cpu", **kw)
        for nb in (1, 4):
            assert tp._unroll(nb) == jp._unroll(nb)
        jp._unroll_for_bucket[4] = 5
        tp._unroll_for_bucket[4] = 5
        assert tp._unroll(4) == jp._unroll(4) == 5
        assert tp._unroll(1) == jp._unroll(1)


def test_autotune_unroll_pins_a_candidate_per_bucket_across_pickling():
    """``autotune_unroll`` keys its result by bucket with values among the
    candidates (0 meaning the horizon), as JAX's; every candidate replays
    the same kernels, so the first is pinned and nothing is captured;
    this predictor's ring is kept; the choice survives pickling and keys
    the fused step from then on."""
    jp, tp = _pair()
    rng = np.random.default_rng(13)
    for p in (jp, tp):
        p.push_host_row(_row(np.random.default_rng(1)))
    mt, q = _jobs(rng, 3)
    first = tp.predict_interval(mt, q)
    jp.predict_interval(mt, q)
    before = tpred.FUSED_STEP.cache_size()
    got = tp.autotune_unroll(buckets=[1, 4], candidates=(1, 2, 0),
                             repeats=2)
    want = jp.autotune_unroll(buckets=[1, 4], candidates=(1, 2, 0),
                              repeats=2)
    assert set(got) == set(want) == {1, 4}
    assert all(v in {1, 2, tp.horizon} for v in got.values())
    assert got == {1: 1, 4: 1}
    assert tpred.FUSED_STEP.cache_size() == before
    clone = pickle.loads(pickle.dumps(tp))
    assert clone._unroll_for_bucket == got
    assert all(clone._unroll(nb) == u for nb, u in got.items())
    # the ring survived the tuning: the next interval equals a run that
    # never tuned
    ref = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                             device="cpu")
    ref.load_params(tp.params)
    ref.push_host_row(_row(np.random.default_rng(1)))
    np.testing.assert_array_equal(ref.predict_interval(mt, q), first)
    row = _row(rng)
    for p in (tp, ref):
        p.push_host_row(row)
    np.testing.assert_array_equal(tp.predict_interval(mt, q),
                                  ref.predict_interval(mt, q))
