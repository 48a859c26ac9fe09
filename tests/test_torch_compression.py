"""The port's gradient compression (``distributed/compression.py``)
against the JAX package's.

- ``int8_compress`` / ``int8_decompress`` and ``topk_compress`` /
  ``topk_decompress``: bit for bit on the same tensors (round half to
  even in both; fp32 divisions and products of the same operands).
- ``ef_int8_reduce`` on 2 and 4 gloo ranks (``tests/torch_ranks.py``),
  three error-feedback rounds, against JAX's under ``jax.vmap(f,
  axis_name="data")`` over the stacked per-rank gradients (``pmax`` and
  ``psum`` reduce the stacked axis): the reduced value and the residual
  bit for bit (the scale is a max, the int8 payload sums exactly in
  int32).
- ``ef_topk_reduce`` the same way: the residual bit for bit, the reduced
  value bit for bit at 2 ranks (a + b is the same either way round) and
  within 1e-6 relative at 4, where the fp32 sum's order differs between
  gloo's all-reduce and XLA's reduction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro_torch.distributed import compression as C
from torch_ranks import spawn

FRAC = 0.05
SHAPES = {"w": (64, 32), "b": (7,), "e": (3, 5, 11)}


def _grads(world, rounds=3, seed=0):
    rng = np.random.default_rng(seed)
    return [[{k: (rng.standard_normal(s) * (1 + 3 * r)).astype(np.float32)
              for k, s in SHAPES.items()} for r in range(world)]
            for _ in range(rounds)]


@pytest.mark.parametrize("shape", [(64, 32), (1000,), (3, 5, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_round_trip_equals_jax(shape, dtype):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JC.int8_compress(jx)
    tq, ts = C.int8_compress(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js) and ts.dtype == torch.float32
    np.testing.assert_array_equal(C.int8_decompress(tq, ts).numpy(),
                                  np.asarray(JC.int8_decompress(jq, js)))


@pytest.mark.parametrize("shape", [(64, 32), (1000,), (3, 5, 7)])
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_round_trip_equals_jax(shape, frac):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jv, ji = JC.topk_compress(jnp.asarray(x), frac)
    tv, ti = C.topk_compress(torch.from_numpy(x), frac)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        C.topk_decompress(tv, ti, shape).numpy(),
        np.asarray(JC.topk_decompress(jv, ji, shape)))


@pytest.mark.parametrize("frac", [0.05, 0.3, 0.6])
def test_topk_breaks_ties_as_jax(frac):
    """Many equal magnitudes (zeros, +-1, +-2): the kept indices and their
    order are JAX's (the lower index first among equal magnitudes)."""
    rng = np.random.default_rng(3)
    x = rng.choice([0.0, 0.0, 0.0, 1.0, -1.0, 2.0, -2.0, 0.5],
                   size=(40, 25)).astype(np.float32)
    jv, ji = JC.topk_compress(jnp.asarray(x), frac)
    tv, ti = C.topk_compress(torch.from_numpy(x), frac)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", ["normal", "zeros", "one", "sparse",
                                  "ramp", "spike", "small"])
def test_the_threshold_is_the_exact_kth_magnitude(case):
    """``_kth_largest`` (a sampled estimate, then exact) against
    ``torch.topk`` of the whole, where the sample judges well and where
    it cannot (all equal, a ramp, one spike)."""
    n = 3_000_017
    x = {"normal": torch.randn(n), "zeros": torch.zeros(n),
         "one": torch.zeros(n).index_fill_(0, torch.tensor([5]), 2.0),
         "sparse": torch.zeros(n).index_fill_(
             0, torch.arange(0, n, 997), 1.5),
         "ramp": torch.arange(n, dtype=torch.float32),
         "spike": torch.ones(n).index_fill_(0, torch.arange(0, 40), 9.0),
         "small": torch.randn(7)}[case]
    for frac in (1e-4, 0.01, 0.3):
        k = max(1, int(x.numel() * frac))
        want = torch.topk(x.abs(), k).values.min()
        assert C._kth_largest(x.abs(), k) == want, (case, frac)
        _, idx = C.topk_compress(x, frac)
        assert idx.numel() == k == idx.unique().numel()
        assert bool(x.abs()[idx].min() == want)


def _jax_rounds(grads, scheme):
    world = len(grads[0])

    def f(g, r):
        if scheme == "int8":
            return JC.ef_int8_reduce(g, r, "data")
        return JC.ef_topk_reduce(g, r, "data", frac=FRAC)

    fn = jax.vmap(f, axis_name="data")
    res = {k: jnp.zeros((world,) + s, jnp.float32)
           for k, s in SHAPES.items()}
    out = []
    for g in grads:
        stacked = {k: jnp.stack([g[r][k] for r in range(world)])
                   for k in SHAPES}
        red, res = fn(stacked, res)
        out.append(({k: np.asarray(v) for k, v in red.items()},
                    {k: np.asarray(v) for k, v in res.items()}))
    return out


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    grads = _grads(world)
    got = spawn("compression", world, tmp_path_factory.mktemp("c"),
                dict(grads=grads, frac=FRAC), timeout=120)
    return world, grads, got


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_ef_reduce_equals_jax_vmap(ranks, scheme):
    world, grads, got = ranks
    want = _jax_rounds(grads, scheme)
    for i, (jred, jres) in enumerate(want):
        for r in range(world):
            red, res = got[r][scheme][i]
            for k in SHAPES:
                np.testing.assert_array_equal(res[k], jres[k][r],
                                              err_msg=f"{i} {r} {k}")
                if scheme == "int8" or world == 2:
                    np.testing.assert_array_equal(red[k], jred[k][r])
                else:
                    np.testing.assert_allclose(red[k], jred[k][r],
                                               rtol=1e-6, atol=1e-6 * float(
                                                   np.abs(jred[k]).max()))


def test_ef_int8_reduced_value_is_close_to_the_mean(ranks):
    """The JAX package's own check (``test_distributed.py``), on the
    port's ranks: the compressed mean within 10% of the true mean's
    scale, and the residual carries the quantization error."""
    world, grads, got = ranks
    red, res = got[0]["int8"][0]
    for k in SHAPES:
        true = np.mean([grads[0][r][k] for r in range(world)], axis=0)
        err = np.abs(red[k] - true).max()
        assert err < 0.1 * np.abs(true).max() + 0.05, (k, err)
        assert np.abs(res[k]).max() > 0
