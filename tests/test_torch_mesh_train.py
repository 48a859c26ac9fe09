"""The port's mesh trainer (``train/trainer.py`` with a ``DeviceMesh``)
on gloo ranks (``tests/torch_ranks.py``), against the JAX package's
single-device ``make_train_step``.

GSPMD keeps the single-device semantics, so that is the reference: 4
ranks on a (2, 2) (data, model) mesh, reduced demo-100m (dense) and
reduced qwen3-moe-30b-a3b (MoE, its experts split over the model axis),
fp32, three AdamW steps from the same converted params at ``n_micro`` 1
and 2 (and reduced demo-100m with the batch split over the whole mesh,
``dp_axes=("data", "model")``, as the ``fsdp_all`` layout splits it).
The losses within 1e-5 relative and every param leaf within 1e-4
relative in norm of JAX's jitted step (the repo's training bounds): the
port's step sums the gradient over the data axis and its global norm
over the mesh in other orders.  The MoE layers route each global
microbatch as one device does (the capacity of all its tokens, the
copies kept in the global order), so the same copies are dropped.

Each rank holds only its blocks: its local numel equals the sum of its
``shard_shape``s (the moments too), and less than the whole tree.  A
(1, 1) mesh step is bit for bit the unsharded step (its collectives are
copies).  ``Trainer.lower`` plans the step on the meta device.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models.lm import Model as JModel
from repro.train import optimizer as JOpt
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch import configs
from torch_ranks import spawn

ARCHS = ("demo-100m", "qwen3-moe-30b-a3b")
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50)
STEPS, BATCH, SEQ = 3, 8, 16


def _cfgs(arch):
    return (dataclasses.replace(jconfigs.get_reduced(arch),
                                param_dtype="float32"),
            dataclasses.replace(configs.get_reduced(arch),
                                param_dtype="float32"))


def _jparams(jcfg, seed=0):
    p = JModel(jcfg).init(jax.random.PRNGKey(seed))
    return p, jax.tree_util.tree_map(lambda a: np.array(a, copy=True), p)


def _jax_run(jcfg, params, n_micro):
    ocfg = JOpt.OptConfig(**OPT)
    step = jax.jit(j_make_train_step(JModel(jcfg), ocfg,
                                     JTrainConfig(n_micro=n_micro)))
    data = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                                    global_batch=BATCH))
    state = JOpt.init(ocfg, params)
    losses = []
    for i in range(STEPS):
        params, state, m = step(params, state, data.batch(i))
        losses.append(float(m["loss"]))
    return losses, params


# (arch, n_micro, dp axes): the batch over "data" (the default), and
# over the whole mesh, as the fsdp_all layout splits it
CASES = [(arch, nm, None) for arch in ARCHS for nm in (1, 2)] + [
    ("demo-100m", 1, ("data", "model"))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    built = {arch: (_cfgs(arch), _jparams(_cfgs(arch)[0])) for arch in
             ARCHS}
    cases = [(built[a][0][1], built[a][1][1], nm, OPT, dp)
             for a, nm, dp in CASES]
    got = spawn("mesh_train", 4, tmp_path_factory.mktemp("mesh"),
                dict(shape=(2, 2), cases=cases, steps=STEPS, batch=BATCH,
                     seq=SEQ), timeout=180)
    return built, got


@pytest.mark.parametrize("arch,n_micro,dp", CASES)
def test_mesh_steps_match_jax_single_device(runs, arch, n_micro, dp):
    built, got = runs
    i = CASES.index((arch, n_micro, dp))
    (jcfg, _), (jp, _) = built[arch]
    want_losses, want = _jax_run(jcfg, jp, n_micro)
    for r in range(4):
        losses = got[r][i]["losses"]
        assert np.allclose(losses, want_losses, rtol=1e-5, atol=0), \
            (r, losses, want_losses)
    mine = got[0][i]["params"]
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = mine
        for k in path:
            node = node[k.key]
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(node - w) / np.linalg.norm(w)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch,n_micro,dp", CASES)
def test_each_rank_holds_only_its_shards(runs, arch, n_micro, dp):
    built, got = runs
    i = CASES.index((arch, n_micro, dp))
    whole = sum(a.size for a in
                jax.tree_util.tree_leaves(built[arch][1][1]))
    for r in range(4):
        res = got[r][i]
        assert res["local_numel"] == res["shard_numel"] < whole
        assert res["moment_numel"] == 2 * res["local_numel"]
        assert res["step"] == STEPS
    placements = got[0][i]["placements"]
    if arch == "qwen3-moe-30b-a3b":   # the experts split over "model"
        wg = [v for k, v in placements.items() if k.endswith("moe.wg")]
        assert wg and all("Shard(dim=1)" in v for v in wg), placements
    assert placements["embed"] != "(Replicate(), Replicate())"


@pytest.mark.parametrize("arch,n_micro,dp", CASES)
def test_trainer_lower_plans_the_step(runs, arch, n_micro, dp):
    """``Trainer.lower``: the meta-device plan on the trainer's own
    mesh: this rank's param bytes are its blocks' (fp32), the AdamW
    moments twice that, and forward plus backward FLOPs counted."""
    _, got = runs
    i = CASES.index((arch, n_micro, dp))
    res = got[0][i]
    plan = res["plan"]
    assert plan["param_bytes"] == 4 * res["shard_numel"]
    assert plan["opt_state_bytes"] == 2 * plan["param_bytes"]
    assert plan["flops_per_device"] > plan["remat_flops_per_device"] > 0
    assert plan["batch_bytes"] == BATCH // 2 * SEQ * 8 * 2


def test_one_rank_mesh_step_is_the_unsharded_step(tmp_path):
    cases = []
    for arch in ARCHS:
        (_, tcfg) = _cfgs(arch)
        cases.append((tcfg, _jparams(_cfgs(arch)[0], seed=1)[1], 2, OPT))
    got = spawn("one_rank_mesh", 1, tmp_path, dict(cases=cases),
                timeout=120)[0]
    for (mesh_losses, mesh_p), (losses, p) in got:
        assert mesh_losses == losses
        for a, b in zip(jax.tree_util.tree_leaves(mesh_p),
                        jax.tree_util.tree_leaves(p)):
            np.testing.assert_array_equal(a, b)
