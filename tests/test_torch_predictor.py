"""The port's StragglerPredictor against the JAX package's, on the CPU,
with the same weights (``convert.from_jax``) and the same numpy
telemetry: the fused interval step, the unfused reference, the tenant
batch and the general ``predict``, under the Tier-1 bound; plus the
port's own fused == unfused, ring catch-up, pickling and staging
counts."""
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.core.predictor import StragglerPredictor as JaxPredictor
from repro_torch import convert
from repro_torch.core.predictor import StragglerPredictor, bucket_size
from tolerance import assert_tier1

N_HOSTS, MAX_TASKS = 8, 4
COUNTS = list(range(1, 21))


def _pair(**kw):
    jp = JaxPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS, **kw)
    tp = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                            device="cpu", **kw)
    tp.load_params(convert.from_jax(
        jax.tree_util.tree_map(np.asarray, jp.params), "cpu"))
    return jp, tp


def _row(rng):
    return rng.uniform(0, 1, (N_HOSTS, 11)).astype(np.float32)


def _jobs(rng, n):
    mt = rng.uniform(0, 1, (n, MAX_TASKS, 5)).astype(np.float32)
    q = rng.integers(1, MAX_TASKS + 1, n).astype(np.float32)
    mt[np.arange(MAX_TASKS)[None, :] >= q[:, None]] = 0.0
    return mt, q


def _packed(out, per_task):
    if per_task:
        e_s, scores = out
        return np.concatenate([e_s[:, None], scores], axis=1)
    return out


@pytest.mark.parametrize("per_task", [False, True])
@pytest.mark.parametrize("n", COUNTS)
def test_predict_interval_matches_jax(n, per_task):
    """Three warm intervals at one job count from a cold ring: the port's
    fused step against the JAX fused step and the JAX unfused
    reference, and the batch shape both packages picked."""
    jp, tp = _pair()
    rng = np.random.default_rng(n)
    rows = [_row(rng) for _ in range(3)]
    for r in rows:
        jp.push_host_row(r)
        tp.push_host_row(r)
    for _ in range(3):
        mt, q = _jobs(rng, n)
        got = _packed(tp.predict_interval(mt, q, per_task=per_task),
                      per_task)
        assert got.shape == ((n, 1 + MAX_TASKS) if per_task else (n,))
        assert_tier1(got, _packed(jp.predict_interval(mt, q,
                                                      per_task=per_task),
                                  per_task), context="vs fused")
        hist = rows[-5:]    # a cold ring left-pads with the oldest row
        window = np.stack([hist[0]] * (5 - len(hist)) + hist)
        ref = jp.predict_features(window, mt, q, per_task=per_task)
        ref = _packed(ref, True) if per_task else np.asarray(ref.e_s)
        assert_tier1(got, ref, context="vs unfused")
        rows.append(_row(rng))
        jp.push_host_row(rows[-1])
        tp.push_host_row(rows[-1])
    assert tp._exact_shapes == jp._exact_shapes


def test_batch_shapes_follow_jax_through_the_exact_shape_budget():
    jp, tp = _pair()
    seq = COUNTS + COUNTS[::-1] + [3, 300, 0, 1]
    assert [tp.batch_size(n) for n in seq] == [jp.batch_size(n) for n in seq]
    assert tp._exact_shapes == jp._exact_shapes
    assert len(tp._exact_shapes) == tp.exact_shape_budget
    assert [bucket_size(n) for n in (0, 1, 2, 3, 9, 256)] == \
        [1, 1, 2, 4, 16, 256]


@pytest.mark.parametrize("per_task", [False, True])
def test_fused_matches_unfused_in_the_port(per_task):
    _, tp = _pair()
    rng = np.random.default_rng(5)
    rows = [_row(rng) for _ in range(5)]
    for r in rows:
        tp.push_host_row(r)
    for n in COUNTS:
        mt, q = _jobs(rng, n)
        got = _packed(tp.predict_interval(mt, q, per_task=per_task),
                      per_task)
        ref = tp.predict_features(np.stack(rows[-5:]), mt, q,
                                  per_task=per_task)
        ref = _packed(ref, True) if per_task else ref.e_s
        assert_tier1(got, ref)
        rows.append(_row(rng))
        tp.push_host_row(rows[-1])


@pytest.mark.parametrize("lag", [2, 4, 7])
def test_idle_interval_catch_up_matches_jax(lag):
    """Intervals that observe hosts but predict nothing: the ring rolls
    the missed rows in (or rebuilds once it fell a horizon behind)."""
    jp, tp = _pair()
    rng = np.random.default_rng(lag)
    for interval in range(3):
        for _ in range(lag if interval else 1):
            r = _row(rng)
            jp.push_host_row(r)
            tp.push_host_row(r)
        mt, q = _jobs(rng, 6)
        assert_tier1(tp.predict_interval(mt, q), jp.predict_interval(mt, q))
    assert not tp.fused_ready
    with pytest.raises(RuntimeError):
        tp.predict_interval(mt, q)


def test_pickled_predictor_continues_the_same_run():
    _, tp = _pair()
    rng = np.random.default_rng(9)
    for _ in range(4):
        tp.push_host_row(_row(rng))
        tp.predict_interval(*_jobs(rng, 5))
    state = tp.__getstate__()
    assert state["_ring"] is None and state["_stage_bufs"] == {}
    assert all(t.device.type == "cpu" for t in
               jax.tree_util.tree_leaves(state["params"]))
    clone = pickle.loads(pickle.dumps(tp))
    for _ in range(3):
        r = _row(rng)
        mt, q = _jobs(rng, 7)
        tp.push_host_row(r)
        clone.push_host_row(r)
        np.testing.assert_array_equal(clone.predict_interval(mt, q),
                                      tp.predict_interval(mt, q))


@pytest.mark.parametrize("per_task", [False, True])
def test_predict_tenants_matches_jax(per_task):
    jp, tp = _pair()
    rng = np.random.default_rng(11)
    seqs, mts, qs = [], [], []
    for n in (3, 1, 4, 2):
        seqs.append(rng.uniform(0, 1, (5, N_HOSTS, 11)).astype(np.float32))
        mt, q = _jobs(rng, n)
        mts.append(mt)
        qs.append(q)
    got = tp.predict_tenants(seqs, mts, qs, per_task=per_task)
    want = jp.predict_tenants(seqs, mts, qs, per_task=per_task)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_tier1(_packed(g, per_task), _packed(w, per_task))


def test_predict_and_predict_features_match_jax():
    jp, tp = _pair()
    rng = np.random.default_rng(13)
    mh = rng.uniform(0, 1, (5, N_HOSTS, 11)).astype(np.float32)
    mt_seq = rng.uniform(0, 1, (5, 6, MAX_TASKS, 5)).astype(np.float32)
    q = rng.integers(1, MAX_TASKS + 1, 6).astype(np.float32)
    for got, want in zip(tp.predict(mh, mt_seq, q),
                         jp.predict(mh, mt_seq, q)):
        assert_tier1(got, np.asarray(want))
    for got, want in zip(tp.predict_features(mh, mt_seq[-1], q),
                         jp.predict_features(mh, mt_seq[-1], q)):
        assert_tier1(got, np.asarray(want))


def test_one_staged_copy_per_warm_interval():
    _, tp = _pair()
    rng = np.random.default_rng(17)
    tp.push_host_row(_row(rng))
    tp.predict_interval(*_jobs(rng, 3))
    assert tp.h2d_stages == 2            # cold: the ring + the batch
    for i in range(5):
        tp.push_host_row(_row(rng))
        tp.predict_interval(*_jobs(rng, 1 + i), per_task=bool(i % 2))
        assert tp.h2d_stages == 3 + i
    tp.push_host_row(_row(rng))
    tp.push_host_row(_row(rng))
    tp.predict_interval(*_jobs(rng, 2))
    assert tp.h2d_stages == 9            # one catch-up row + the batch
    tp.predict_features(np.stack([_row(rng)] * 5), *_jobs(rng, 2))
    assert tp.h2d_stages == 9            # the reference path stages none


def test_tf32_is_off_and_cuda_is_never_a_silent_fallback():
    torch.backends.cuda.matmul.allow_tf32 = True
    StragglerPredictor(n_hosts=2, max_tasks=2, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        StragglerPredictor(n_hosts=2, max_tasks=2)
