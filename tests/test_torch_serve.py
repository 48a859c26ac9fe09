"""The port's serving engine on the CPU: continuous batching, slot reuse,
greedy == a hand-rolled decode loop, the slot manager and START replica
re-dispatch (``tests/test_serve.py``'s cases), plus the JAX engine and
the port's giving equal token streams from the same converted fp32
params and seeded requests for every ported arch, and the serving entry
point end to end (dense and MoE)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.lm import Model as JModel
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro_torch import convert
from repro_torch.configs import PORTED, get_reduced
from repro_torch.launch import serve
from repro_torch.models.lm import Model
from repro_torch.serve.engine import Engine, EngineConfig, \
    ReplicaDispatcher, Request
from repro_torch.serve.kv_cache import SlotManager, alloc_like, \
    pad_to_length


@pytest.fixture(scope="module")
def served():
    cfg = dataclasses.replace(get_reduced("demo-100m"),
                              param_dtype="float32")
    model = Model(cfg)
    params = model.init(0, "cpu")
    return cfg, model, params


def test_engine_completes_requests(served):
    cfg, model, params = served
    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=64))
    rng = np.random.default_rng(0)
    for i in range(5):
        eng.submit(Request(req_id=i,
                           tokens=rng.integers(0, cfg.vocab, 6),
                           max_new=8))
    done = eng.run()
    assert len(done) == 5
    for r in done:
        assert len(r.out) >= 8
        assert all(0 <= t < cfg.padded_vocab for t in r.out)


def test_engine_continuous_batching_reuses_slots(served):
    cfg, model, params = served
    eng = Engine(model, params, EngineConfig(n_slots=1, max_len=64))
    rng = np.random.default_rng(1)
    for i in range(3):
        eng.submit(Request(req_id=i,
                           tokens=rng.integers(0, cfg.vocab, 4),
                           max_new=4))
    done = eng.run()
    assert len(done) == 3  # 3 requests through 1 slot


def test_engine_greedy_matches_manual_decode(served):
    """Engine output == hand-rolled prefill+decode loop (greedy)."""
    cfg, model, params = served
    prompt = np.array([5, 9, 2, 7])
    eng = Engine(model, params, EngineConfig(n_slots=1, max_len=32))
    eng.submit(Request(req_id=0, tokens=prompt, max_new=5))
    out = eng.run()[0].out

    logits, caches = model.prefill(params,
                                   {"tokens": torch.as_tensor(prompt)[None]})
    caches = pad_to_length(caches, 32)
    assert caches[0]["k"].shape == (cfg.n_layers, 1, cfg.n_kv_heads, 32,
                                    cfg.hd)
    assert not caches[0]["k"][:, :, :, len(prompt):].any()
    toks = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(4):
        logits, caches = model.decode_step(
            params, caches, torch.tensor([[toks[-1]]]), pos)
        toks.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    assert out[:5] == toks


def test_slot_manager():
    sm = SlotManager(2)
    a = sm.assign(10)
    b = sm.assign(11)
    assert sm.free_slots() == []
    sm.release(a)
    assert sm.free_slots() == [a]
    c = sm.assign(12)
    assert c == a
    assert sm.active() == {b: 11, c: 12}


def test_alloc_like_rebatches_zero_caches():
    spec = [{"k": torch.ones(2, 1, 3, 8, 4), "v": torch.ones(2, 1, 3, 8, 4)}]
    out = alloc_like(spec, batch=5)
    assert out[0]["k"].shape == (2, 5, 3, 8, 4)
    assert not out[0]["v"].any()


def test_replica_dispatcher_redispatches_slow_replica():
    disp = ReplicaDispatcher(n_replicas=3, device="cpu")
    for i in range(6):
        disp.assign(i)
    rng = np.random.default_rng(0)
    for _ in range(16):
        disp.observe(0, 0.01 + 0.001 * rng.random())
        disp.observe(1, 0.01 + 0.001 * rng.random())
        disp.observe(2, 0.30 + 0.05 * rng.random())   # straggler replica
    dup = disp.decide_redispatch()
    assert dup, "straggler replica should trigger re-dispatch"
    reqs = {r for r, _ in dup}
    assert all(disp.assignments[r] == 2 for r in reqs)
    targets = {t for _, t in dup}
    assert 2 not in targets
    # idempotent: second call doesn't re-duplicate
    assert disp.decide_redispatch() == []


def test_jax_and_port_engines_give_equal_token_streams():
    _engines_give_equal_token_streams("yi-6b")


@pytest.mark.parametrize("arch", [a for a in PORTED if a != "yi-6b"])
def test_every_ported_arch_gives_the_jax_engines_token_streams(arch):
    """The other ported archs (yi-6b is the test above)."""
    _engines_give_equal_token_streams(arch)


def _engines_give_equal_token_streams(arch):
    jcfg = dataclasses.replace(jax_reduced(arch), param_dtype="float32")
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (3, 9, 5, 14, 7)]
    streams = []
    for eng, req in ((JEngine(jmodel, jparams, JEngineConfig(2, 48)),
                      JRequest),
                     (Engine(Model(cfg), params, EngineConfig(2, 48)),
                      Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(req_id=i, tokens=p, max_new=10))
        streams.append({r.req_id: r.out for r in eng.run()})
    assert streams[0] == streams[1]
    assert sorted(streams[1]) == list(range(len(prompts)))


def test_serve_entry_point_runs_on_the_cpu():
    out = serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                      "--max-new", "4"])
    assert out["requests_done"] == 3 and out["tokens"] >= 12
    assert set(out) == {"requests_done", "tokens", "tok_per_s",
                        "redispatch_candidates"}


def test_serve_entry_point_serves_the_moe_arch_on_the_cpu():
    out = serve.main(["--arch", "qwen3-moe-30b-a3b", "--reduced",
                      "--device", "cpu", "--requests", "3", "--max-new",
                      "4"])
    assert out["requests_done"] == 3 and out["tokens"] >= 12


def test_entry_points_refuse_a_missing_card(served):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg, model, _ = served
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
