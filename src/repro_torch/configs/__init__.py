"""Architecture registry: ``--arch <id>`` -> ModelConfig (exact + reduced).

The same ids as the JAX package's registry, every one of them ported:
the dense configurations (yi-6b, minitron-4b, phi4-mini-3.8b,
deepseek-67b, demo-100m), internvl2-26b's vlm (patch embeddings as
inputs), the MoE ones (qwen3-moe-30b-a3b; deepseek-v3-671b with MLA, a
shared expert and a dense prefix), falcon-mamba's SSM,
seamless-m4t-large-v2's encoder-decoder (frame embeddings as the
encoder's inputs) and jamba-1.5-large-398b's hybrid (periods of Mamba,
attention and MoE sublayers).
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

# archs with a config in the port: all of them
PORTED = ("yi-6b", "demo-100m", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
          "minitron-4b", "phi4-mini-3.8b", "deepseek-67b", "internvl2-26b",
          "deepseek-v3-671b", "seamless-m4t-large-v2",
          "jamba-1.5-large-398b")


def _mod(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _mod(arch).reduced()


def list_archs(assigned_only: bool = True) -> list[str]:
    out = list(ARCHS)
    return [a for a in out if a != "demo-100m"] if assigned_only else out
