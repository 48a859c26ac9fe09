"""Architecture registry: ``--arch <id>`` -> ModelConfig (exact + reduced).

The same ids as the JAX package's registry.  The port runs the dense
configurations and qwen3's MoE so far; asking for another arch raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = {
    "yi-6b": "yi_6b",
    "minitron-4b": "minitron_4b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "deepseek-67b": "deepseek_67b",
    "internvl2-26b": "internvl2_26b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "demo-100m": "demo_100m",  # extra: e2e example model
}

# archs with a config in the port
PORTED = ("yi-6b", "demo-100m", "qwen3-moe-30b-a3b")
# where each of the others waits (ROADMAP.md, Queue 1)
_WAITS = {
    "falcon-mamba-7b": "Queue 1 item 2 (the SSM training forward, "
                       "mamba_scan kernel)",
}
_REST = "Queue 1 item 4.5 (the rest of the LM stack)"


def _mod(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(ARCHS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: ROADMAP.md "
            f"{_WAITS.get(arch, _REST)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _mod(arch).reduced()


def list_archs(assigned_only: bool = True) -> list[str]:
    out = list(ARCHS)
    return [a for a in out if a != "demo-100m"] if assigned_only else out
