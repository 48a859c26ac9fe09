"""The port's dry run (``launch/dryrun.py``) and accounting
(``launch/accounting.py``).

JAX 0.9 makes ``jax.make_mesh`` meshes of ``Explicit`` axes, on which the
JAX package's ``lower_cell`` raises (``with_sharding_constraint`` may
name only ``Auto`` axes), so the plan is held against a transcription,
here, of JAX ``dryrun.py:108-161``'s decisions fed with the JAX
package's own ``param_count``, ``active_param_count`` and
``auto_n_micro``, for every arch x shape x mesh; the skips against JAX's
``applicable``; each device's param bytes against the sum of the JAX
specs' block sizes (JAX's ``param_specs`` on its ``eval_shape`` params,
a ``SimpleNamespace`` mesh).

The accounting passes torch counterparts of ``tests/test_hlo_accounting.py``'s
six cases (a matmul is 2 * 64 * 256 * 256 FLOPs; a loop of 10 counts
10x; nested 4 x 5 counts 20x; a loop equals its unrolled form; tanh's
transcendentals >= 64 * 256; bytes > 0), counts a gloo all-gather's
bytes once per loop trip, and yi-6b's ``train_4k`` cell counts FLOPs per
device within 10% of 6 N T plus the causal attention term
3 * 4 * L * H * hd * S (S + 1) / 2 (forward and backward of QK^T and
PV over the causal pairs of one 4096-token sequence per device).
"""
import functools
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import applicable as japplicable
from repro.distributed import sharding as JSh
from repro.models import specs as JS
from repro.models.lm import Model as JModel
from repro.train.trainer import auto_n_micro as j_auto_n_micro
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import leaves
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import accounting, dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import Model
from torch_ranks import spawn

ARCHS = list_archs(assigned_only=False)
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jmesh(multi):
    shape, names = MESHES[multi]
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


def jax_plan(arch, shape_name, mesh):
    """JAX ``lower_cell``'s decisions (``dryrun.py:108-161``), as written
    there, with the JAX package's counts and ``auto_n_micro``."""
    cfg = jget(arch)
    shape = JSHAPES[shape_name]
    n_model = mesh.shape.get("model", 1)
    n_dev = math.prod(mesh.shape.values())
    mesh_dp = math.prod(mesh.shape[a] for a in ("pod", "data")
                        if a in mesh.axis_names)
    if shape.kind != "train":
        return dict(fsdp=cfg.param_count() * 2 / n_model > 12e9,
                    spec_kw=dict(fsdp=cfg.param_count() * 2 / n_model
                                 > 12e9))
    n_params = cfg.param_count()
    okind = "adafactor" if n_params > 1.5e10 else "adamw"
    accum = "bfloat16" if n_params > 1e11 else "float32"
    bpp = {"adamw": 14.0, "adafactor": 8.5}[okind]
    if accum == "bfloat16":
        bpp -= 2.0
    tokens_dev = shape.global_batch * shape.seq_len / n_dev
    logits_est = tokens_dev * cfg.padded_vocab * 2
    act_est = ((cfg.n_layers + cfg.encoder_layers) * tokens_dev
               * cfg.d_model * 2 + logits_est)
    fsdp_all = (cfg.n_experts == 0
                and n_params * bpp / n_dev <= 12e9
                and act_est <= 2.7e9 and logits_est <= 1.2e9
                and shape.global_batch % n_dev == 0)
    if fsdp_all:
        fsdp = True
        spec_kw = dict(fsdp=True, tp=False, fsdp_axes=("data", "model"))
        nm = j_auto_n_micro(shape.global_batch, shape.seq_len,
                            cfg.padded_vocab, n_dev, n_model=1,
                            n_layers=cfg.n_layers + cfg.encoder_layers,
                            d_model=cfg.d_model)
    else:
        fsdp = n_params * bpp / n_model > 12e9
        spec_kw = dict(fsdp=fsdp)
        nm = j_auto_n_micro(shape.global_batch, shape.seq_len,
                            cfg.padded_vocab, mesh_dp, n_model=n_model,
                            n_layers=cfg.n_layers + cfg.encoder_layers,
                            d_model=cfg.d_model)
    return dict(optimizer=okind, accum_dtype=accum, bytes_per_param=bpp,
                n_micro=nm, fsdp=fsdp,
                layout="fsdp_all" if fsdp_all else "tp", spec_kw=spec_kw)


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return JS.params_specs(JModel(jget(arch)))


@functools.lru_cache(maxsize=None)
def _params(arch):
    return Model(get_config(arch)).init(0, "meta")


def _jax_param_bytes(arch, mesh, spec_kw):
    """Sum over the JAX specs of each leaf's block size, in bytes."""
    params = _jparams(arch)
    specs = jax.tree_util.tree_leaves(
        JSh.param_specs(params, mesh, **spec_kw),
        is_leaf=lambda x: isinstance(x, P))
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(params), specs):
        n = 1
        for i, dim in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= -(-dim // math.prod(mesh.shape[a] for a in axes))
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("multi", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equals_jax_lower_cell(arch, shape, multi):
    ok, why = japplicable(jget(arch), JSHAPES[shape])
    assert (ok, why) == dryrun.applicable(get_config(arch), SHAPES[shape])
    if not ok:
        rec = dryrun.run_cell(arch, shape, multi)
        assert rec["status"] == "skipped" and rec["reason"] == why
        return
    mesh = make_production_mesh(multi_pod=multi)
    got = dryrun.plan_cell(get_config(arch), SHAPES[shape], mesh)
    want = jax_plan(arch, shape, _jmesh(multi))
    for key, value in want.items():
        assert got[key] == value, (key, got[key], value)
    assert got["params"] == jget(arch).param_count()
    assert got["active_params"] == jget(arch).active_param_count()
    params = _params(arch)
    pspec = Sh.param_specs(params, mesh, **got["spec_kw"])
    assert dryrun.tree_bytes(params, pspec, mesh.shape) == \
        _jax_param_bytes(arch, _jmesh(multi), want["spec_kw"])


W = torch.zeros(256, 256)
X = torch.zeros(64, 256)
MM_FLOPS = 2 * 64 * 256 * 256


def test_single_matmul():
    assert accounting.account(lambda x, w: x @ w, X, W).flops == MM_FLOPS


def test_a_loop_multiplies_its_trips():
    def loop10(x, w):
        for _ in range(10):
            x = x @ w
        return x
    t = accounting.account(loop10, X, W)
    assert t.flops == 10 * MM_FLOPS and t.unknown_trip_loops == 0


def test_nested_loops_multiply():
    def nested(x, w):
        for _ in range(4):
            for _ in range(5):
                x = x @ w
        return x
    assert accounting.account(nested, X, W).flops == 20 * MM_FLOPS


def test_a_loop_matches_its_unrolled_form():
    def loop8(x, w):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    def unroll8(x, w):
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        return torch.tanh(x @ w)

    a, b = accounting.account(loop8, X, W), accounting.account(unroll8, X, W)
    assert (a.flops, a.bytes, a.transcendentals) == \
        (b.flops, b.bytes, b.transcendentals)


def test_bytes_and_transcendentals_positive():
    t = accounting.account(lambda x, w: torch.tanh(x @ w), X, W)
    assert t.bytes > 0
    assert t.transcendentals >= 64 * 256


def test_meta_tensors_count_as_real_ones():
    xm, wm = X.to("meta"), W.to("meta")
    a = accounting.account(lambda x, w: torch.tanh(x @ w), X, W)
    b = accounting.account(lambda x, w: torch.tanh(x @ w), xm, wm)
    assert (a.flops, a.bytes, a.transcendentals) == \
        (b.flops, b.bytes, b.transcendentals)


def test_collectives_counted_with_trips(tmp_path):
    got = spawn("gather_loop", 2, tmp_path, dict(trips=4), timeout=120)
    for res in got:
        assert res["all-gather"] == 4 * 2 * 64 * 32 * 4, res
        assert res["all-reduce"] == 0


def test_yi_6b_train_flops_are_6nt_plus_causal_attention():
    rec = dryrun.run_cell("yi-6b", "train_4k", False)
    assert rec["status"] == "ok" and rec["layout"] == "fsdp_all"
    cfg = get_config("yi-6b")
    n, s = cfg.param_count(), SHAPES["train_4k"].seq_len
    tokens = SHAPES["train_4k"].global_batch * s // rec["n_devices"]
    assert tokens == s                      # one sequence per device
    attn = 3 * 4 * cfg.n_layers * cfg.n_heads * cfg.hd * s * (s + 1) // 2
    want = 6 * n * tokens + attn
    assert abs(rec["flops_per_device"] / want - 1) <= 0.10, \
        rec["flops_per_device"] / want
    assert 0 < rec["remat_flops_per_device"] < rec["flops_per_device"]
    assert rec["per_device"]["param_bytes"] == \
        _jax_param_bytes("yi-6b", _jmesh(False), dict(
            fsdp=True, tp=False, fsdp_axes=("data", "model")))
    assert rec["collective_bytes_per_device"]["all-gather"] > 0


def test_the_cli_writes_a_record_per_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "falcon-mamba-7b", "--shape", "long_500k", "--mesh", "both",
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    names = sorted(os.listdir(tmp_path))
    assert names == ["falcon-mamba-7b_long_500k_multipod.json",
                     "falcon-mamba-7b_long_500k_pod.json"]
    rec = json.loads((tmp_path / names[1]).read_text())
    assert rec["status"] == "ok" and rec["per_device"]["cache_bytes"] > 0
    assert not {"lower_s", "compile_s", "xla_cost_flops"} & set(rec)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_trainer_specs_equal_jax(arch, kind):
    """``Trainer.specs`` on the production mesh: the params' specs, the
    optimizer state's (``opt_specs``: AdamW's moments mirror the params;
    adafactor's factored moments drop a dim) and the batch's equal the
    JAX ``Trainer.specs``' on a ``SimpleNamespace`` mesh."""
    from repro.train import optimizer as JOpt
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.train import optimizer as Opt
    from repro_torch.train.trainer import Trainer
    from repro_torch.models import specs as S
    mesh = make_production_mesh()
    jtr = JTrainer(JModel(jget(arch)), _jmesh(False),
                   opt_cfg=JOpt.OptConfig(kind=kind))
    tr = Trainer(Model(get_config(arch)), mesh,
                 opt_cfg=Opt.OptConfig(kind=kind))
    jbatch = JS.batch_specs(jget(arch), 256, 4096, True)
    _, jp, jo, jb = jtr.specs(jbatch)
    params, p, o, b = tr.specs(S.batch_specs(get_config(arch), 256, 4096,
                                             True))
    assert all(t.device.type == "meta" for t in leaves(params))

    def js(tree):
        return [tuple(x) for x in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, P))]

    assert Sh.spec_leaves(p) == js(jp)
    assert Sh.spec_leaves(b) == js(jb)
    for field in ("m", "v", "v_row", "v_col"):
        want, got = getattr(jo, field), getattr(o, field)
        assert (got is None) == (want is None), field
        if want is not None:
            assert Sh.spec_leaves(got) == js(want), field
