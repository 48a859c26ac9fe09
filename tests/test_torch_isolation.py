"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and
building and running the port's controller, its LM serving engine
(dense and MoE), its SSM trainer, START's pretraining and a START-eager
simulation, and a prediction service's tick and a daemon's TCP round
trip on the CPU loads neither."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_scan_sees_every_port_module():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/core/predictor.py" in names
    assert "src/repro_torch/kernels/lstm_cell/ops.py" in names
    assert {"src/repro_torch/models/lm.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/kernels/flash_attention/ops.py",
            "src/repro_torch/kernels/decode_attention/ops.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/kernels/moe_router/ops.py",
            "src/repro_torch/models/mamba.py",
            "src/repro_torch/kernels/mamba_scan/ops.py",
            "src/repro_torch/train/data.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/trainer.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/policy/__init__.py",
            "src/repro_torch/policy/actions.py",
            "src/repro_torch/policy/base.py",
            "src/repro_torch/policy/registry.py",
            "src/repro_torch/policy/telemetry.py",
            "src/repro_torch/sim/__init__.py",
            "src/repro_torch/sim/config.py",
            "src/repro_torch/sim/cluster.py",
            "src/repro_torch/sim/faults.py",
            "src/repro_torch/sim/workload.py",
            "src/repro_torch/sim/scheduler.py",
            "src/repro_torch/sim/metrics.py",
            "src/repro_torch/sim/scenarios.py",
            "src/repro_torch/sim/engine.py",
            "src/repro_torch/sim/techniques/__init__.py",
            "src/repro_torch/sim/techniques/start_tech.py",
            "src/repro_torch/service/__init__.py",
            "src/repro_torch/service/core.py",
            "src/repro_torch/service/daemon.py",
            "src/repro_torch/service/protocol.py",
            "src/repro_torch/service/retrain.py",
            "src/repro_torch/service/sanitize.py",
            "src/repro_torch/policy/wire.py",
            "src/repro_torch/train/checkpoint.py",
            "src/repro_torch/chaos/__init__.py",
            "src/repro_torch/chaos/clock.py",
            "src/repro_torch/chaos/proxy.py"} <= names
    assert _imported_roots(ROOT / "src" / "repro" / "core" / "start.py") \
        >= {"repro", "numpy"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_running_the_port_loads_no_jax():
    code = (
        "import sys, numpy as np\n"
        "from repro_torch.core.start import STARTController\n"
        "c = STARTController(n_hosts=4, max_tasks=3, device='cpu')\n"
        "c.observe_hosts(np.ones((4, 11), np.float32))\n"
        "e = c.predict_es_batch(np.arange(2), np.ones((2, 3, 5), "
        "np.float32), np.array([2, 3]))\n"
        "assert e.shape == (2,)\n"
        "import dataclasses\n"
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.models.lm import Model\n"
        "from repro_torch.serve.engine import Engine, EngineConfig, "
        "Request\n"
        "for arch in ('yi-6b', 'qwen3-moe-30b-a3b'):\n"
        "    m = Model(get_reduced(arch))\n"
        "    eng = Engine(m, m.init(0, 'cpu'), EngineConfig(n_slots=2, "
        "max_len=24))\n"
        "    for i in range(3):\n"
        "        eng.submit(Request(req_id=i, tokens=np.arange(3 + i), "
        "max_new=4))\n"
        "    assert len(eng.run()) == 3\n"
        "from repro_torch.train.data import DataConfig, SyntheticLM\n"
        "from repro_torch.train.trainer import Trainer\n"
        "cfg = get_reduced('falcon-mamba-7b')\n"
        "tr = Trainer(Model(cfg), mesh=None, device='cpu')\n"
        "p, s = tr.init_state(0)\n"
        "data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=6, "
        "global_batch=2), device='cpu')\n"
        "p, s, m = tr.compile_step()(p, s, data.batch(0))\n"
        "assert int(s.step) == 1 and bool(m['loss'].isfinite())\n"
        "from repro_torch.sim import scenarios\n"
        "from repro_torch.sim.engine import Simulation\n"
        "from repro_torch.sim.techniques import start_tech\n"
        "ctrl = start_tech.pretrain(scenarios.make_config('planetlab', "
        "seed=7, n_hosts=8, n_intervals=24), epochs=1, device='cpu')\n"
        "pol = start_tech.STARTEager(controller=ctrl)\n"
        "out = Simulation(scenarios.make_config('planetlab', seed=1, "
        "n_hosts=8, n_intervals=12), technique=pol).run()\n"
        "assert out['tasks_total'] > 0 and len(ctrl.predictor.losses) == 1\n"
        "from repro_torch.policy import wire\n"
        "from repro_torch.service import (PredictionService, Profile, "
        "ServiceConfig, ServiceDaemon)\n"
        "prof = Profile(n_hosts=4, max_tasks=3)\n"
        "snap = wire.snapshot_to_wire('t', 0, np.ones((4, 11)), jobs=["
        "wire.job_to_wire(1, 2, np.ones((3, 5)), tasks=[(7, 0, 0)])])\n"
        "svc = PredictionService(ServiceConfig(prof, device='cpu'))\n"
        "assert svc.hello('t', prof.to_wire())['ok']\n"
        "p = svc.submit('t', snap)\n"
        "assert svc.tick() == 1 and p.result['ok']\n"
        "with ServiceDaemon(ServiceConfig(prof, device='cpu')) as d:\n"
        "    c = d.tcp_client('t')\n"
        "    assert c.hello(prof)['ok']\n"
        "    r = c.snapshot(snap)\n"
        "    c.bye()\n"
        "assert r['jobs'] == p.result['jobs']\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
