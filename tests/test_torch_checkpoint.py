"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
JAX package's, on the CPU: one directory format, so a checkpoint written
by either package loads in the other bit for bit.

- Leaves go in ``jax.tree_util``'s flatten order: dict keys sorted,
  ``None`` no leaf, a NamedTuple's fields in order; restore rebuilds the
  caller's tree, a NamedTuple as itself.
- bf16 leaves are stored as their uint16 bits, named ``bfloat16`` in the
  manifest, and restored through a torch view (the port needs no
  ``ml_dtypes``).
- The VersionStore's crash recoveries (a torn or garbage ``CURRENT``, a
  torn leaf) and the async writer's isolation from the in-place
  optimizer.
"""
import json
import os
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.predictor import StragglerPredictor as JPredictor
from repro.models.lm import Model as JModel
from repro.train import checkpoint as jckpt
from repro.train import optimizer as JOpt
from repro_torch import configs, convert
from repro_torch.core.predictor import StragglerPredictor
from repro_torch.models.lm import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as Opt
from repro_torch.train.checkpoint import VersionStore

ARCH = "falcon-mamba-7b"


def _bits(x) -> tuple:
    """A leaf's dtype name, shape and bytes (bf16 as its bits)."""
    if isinstance(x, torch.Tensor):
        dt = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return dt, tuple(x.shape), x.contiguous().numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def _same_bits(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _bits(a) == _bits(b), i


class Pair(NamedTuple):
    a: Any
    b: Any
    c: Any


def test_flatten_order_is_jax_tree_util_order():
    tree = {"z": [1, None, (2, 3)], "a": Pair(4, None, {"y": 5, "x": 6}),
            "m": None, "k": {"q": (7,), "b": [8, [9]]}}
    want = jax.tree_util.tree_leaves(tree)
    assert ckpt._flatten(tree) == want
    back = ckpt._unflatten(tree, [v * 10 for v in want])
    assert back == jax.tree_util.tree_map(lambda v: v * 10, tree)
    assert type(back["a"]) is Pair and back["a"].b is None
    assert isinstance(back["z"][2], tuple)


def _predictor_pair():
    jp = JPredictor(n_hosts=3, max_tasks=4)
    tp = StragglerPredictor(n_hosts=3, max_tasks=4, device="cpu")
    return jp, tp


def test_a_jax_version_loads_in_the_port_bit_for_bit(tmp_path):
    jp, tp = _predictor_pair()
    jstore = jckpt.VersionStore(str(tmp_path))
    jstore.save_version(3, jp.params)
    jstore.promote(3)
    store = VersionStore(str(tmp_path))
    assert store.current() == 3
    loaded = store.load_version(3, tp.params)
    assert list(loaded) == list(tp.params)
    _same_bits(convert.leaves(loaded), jax.tree_util.tree_leaves(jp.params))


def test_a_port_version_loads_in_jax_bit_for_bit(tmp_path):
    jp, tp = _predictor_pair()
    store = VersionStore(str(tmp_path))
    store.save_version(0, tp.params)
    store.promote(0)
    jstore = jckpt.VersionStore(str(tmp_path))
    assert jstore.current() == 0
    loaded = jstore.load_version(0, jp.params)
    _same_bits(jax.tree_util.tree_leaves(loaded), convert.leaves(tp.params))


def _lm_state(kind: str, seed: int = 0):
    """The port's (params, OptState) of the reduced SSM (bf16 params),
    its moments made non-zero so a swapped leaf shows."""
    model = Model(configs.get_reduced(ARCH))
    params = model.init(seed, "cpu")
    state = Opt.init(Opt.OptConfig(kind=kind), params)
    g = torch.Generator().manual_seed(seed)
    for t in ckpt._flatten(state)[1:]:
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return params, state._replace(step=torch.tensor(7, dtype=torch.int32))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_lm_params_and_opt_state_round_trip(tmp_path, kind):
    params, state = _lm_state(kind)
    assert any(t.dtype == torch.bfloat16 for t in convert.leaves(params))
    assert (state.v is None) == (kind == "adafactor")
    ckpt.save(str(tmp_path), 7, (params, state))
    manifest = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    assert "bfloat16" in manifest["dtypes"]
    like_params, like_state = _lm_state(kind, seed=1)
    got_params, got_state = ckpt.restore(str(tmp_path), 7,
                                         (like_params, like_state))
    assert isinstance(got_state, Opt.OptState)
    assert [f is None for f in got_state] == [f is None for f in state]
    _same_bits(ckpt._flatten((got_params, got_state)),
               ckpt._flatten((params, state)))


def _jax_lm_state():
    cfg = jconfigs.get_reduced(ARCH)
    params = JModel(cfg).init(jax.random.PRNGKey(0))
    return params, JOpt.init(JOpt.OptConfig(), params)


def test_an_lm_checkpoint_crosses_packages(tmp_path):
    """The JAX trainer's (params, OptState) of the same model loads into
    the port's tree, and the port's into JAX's, bit for bit."""
    jparams, jstate = _jax_lm_state()
    jstate = jstate._replace(step=jnp.int32(3))
    jckpt.save(str(tmp_path / "jax"), 3, (jparams, jstate))
    params, state = _lm_state("adamw")
    got = ckpt.restore(str(tmp_path / "jax"), 3, (params, state))
    assert isinstance(got[1], Opt.OptState)
    _same_bits(ckpt._flatten(got), jax.tree_util.tree_leaves(
        (jparams, jstate)))
    ckpt.save(str(tmp_path / "port"), 5, (params, state))
    back = jckpt.restore(str(tmp_path / "port"), 5, (jparams, jstate))
    _same_bits(jax.tree_util.tree_leaves(back),
               ckpt._flatten((params, state)))


def test_restore_places_leaves_on_the_device_asked(tmp_path):
    params, state = _lm_state("adamw")
    ckpt.save(str(tmp_path), 1, params)
    got = ckpt.restore(str(tmp_path), 1, params, device="cpu")
    assert all(t.device.type == "cpu" for t in convert.leaves(got))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 1, (params, state))


def test_async_checkpointer_is_isolated_from_in_place_updates(tmp_path):
    """The LM optimizer writes params in place: a submitted checkpoint
    holds the values at submit time, and retention keeps the last 3."""
    w = torch.zeros(4, 3)
    tree = {"w": w, "opt": Pair(torch.tensor(0), None, [w * 2])}
    writer = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    for step in range(5):
        w.fill_(float(step))
        writer.submit(step, tree)
        w.fill_(-1.0)                      # the next step's in-place write
    writer.close()
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}"
                                            for s in (2, 3, 4)]
    for s in (2, 3, 4):
        got = ckpt.restore(str(tmp_path), s, tree)
        assert torch.equal(got["w"], torch.full((4, 3), float(s)))


# --------------------------- VersionStore recovery ------------------------

def _tree(v: float):
    return {"w": np.full((3, 3), v, np.float32),
            "b": np.arange(3, dtype=np.float32)}


def test_version_store_recovers_from_torn_pointer(tmp_path):
    path = str(tmp_path / "store")
    vs = VersionStore(path)
    for v in (0, 1, 2):
        vs.save_version(v, _tree(float(v)))
    vs.promote(0)
    vs.promote(1)
    cur = os.path.join(path, "CURRENT")
    with open(cur, "w") as f:
        f.write('{"current": 1, "hist')
    vs2 = VersionStore(path)
    assert vs2.current() == 2             # newest intact version wins
    loaded = vs2.load_version(vs2.current(), _tree(0.0))
    np.testing.assert_array_equal(loaded["w"].numpy(), _tree(2.0)["w"])
    with open(cur, "w") as f:
        f.write("\x00\xff not json")
    with open(os.path.join(path, "step_00000002", "manifest.json"),
              "w") as f:
        f.write("{broken")
    assert VersionStore(path).current() == 1
    vs3 = VersionStore(path)
    vs3.promote(1)
    assert json.load(open(cur))["current"] == 1


def test_version_store_recovery_with_no_intact_versions(tmp_path):
    path = str(tmp_path / "empty")
    vs = VersionStore(path)
    with open(os.path.join(path, "CURRENT"), "w") as f:
        f.write("")
    assert vs.current() is None
    assert vs.history() == []


@pytest.mark.parametrize("torn", [b"\x00\x01\x02", b""])
def test_version_store_recovery_rejects_torn_leaf(tmp_path, torn):
    path = str(tmp_path / "store")
    vs = VersionStore(path)
    vs.save_version(0, _tree(0.0))
    vs.save_version(1, _tree(1.0))
    vs.promote(0)
    with open(os.path.join(path, "step_00000001", "leaf_00000.npy"),
              "wb") as f:
        f.write(torn)
    with open(os.path.join(path, "CURRENT"), "w") as f:
        f.write("garbage")
    assert VersionStore(path).current() == 0
    # and the JAX store, reading the same directory, agrees
    assert jckpt.VersionStore(path).current() == 0


def test_a_bf16_leaf_needs_no_ml_dtypes(tmp_path):
    x = torch.randn(5, 7).to(torch.bfloat16)
    ckpt.save(str(tmp_path), 0, {"x": x})
    raw = np.load(tmp_path / "step_00000000" / "leaf_00000.npy")
    assert raw.dtype == np.uint16
    got = ckpt.restore(str(tmp_path), 0, {"x": torch.zeros(1)})["x"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)
    # JAX reads the same bits through ml_dtypes
    jgot = jckpt.restore(str(tmp_path), 0, {"x": jnp.zeros(1)})["x"]
    assert np.asarray(jgot).view(np.uint16).tobytes() == \
        x.view(torch.int16).numpy().tobytes()


def test_leaf_dtypes_keep_their_manifest_names(tmp_path):
    tree = {"f": torch.zeros(2), "i": torch.zeros(2, dtype=torch.int32),
            "h": torch.zeros(2, dtype=torch.bfloat16),
            "n": np.zeros(2, np.float64)}
    ckpt.save(str(tmp_path), 0, tree)
    manifest = json.load(open(tmp_path / "step_00000000" / "manifest.json"))
    assert manifest["dtypes"] == ["float32", "bfloat16", "int32", "float64"]
