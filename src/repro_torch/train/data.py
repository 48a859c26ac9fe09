"""Deterministic synthetic LM data pipeline (a copy of the JAX package's
``train/data.py``).

Tokens follow a noisy affine recurrence t_{i+1} = (a*t_i + b) mod V with
epsilon-uniform corruption — structured enough that a model visibly
learns (loss drops well below log V), fully deterministic per (seed,
step, shard), and generable on every host independently.  Batches are
drawn with numpy exactly as the JAX package draws them, then become
``torch.long`` tensors on the pipeline's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.predictor import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    a: int = 31
    b: int = 7


class SyntheticLM:
    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 shard_count: int = 1, device: str | torch.device = "cuda"):
        if cfg.global_batch % shard_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {shard_count} shards")
        self.cfg = cfg
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.local_batch = cfg.global_batch // shard_count
        self.device = resolve_device(device)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.shard_index))
        b, s = self.local_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        noise = rng.random((b, s)) < cfg.noise
        rand = rng.integers(0, cfg.vocab, (b, s))
        for i in range(s):
            nxt = (cfg.a * toks[:, i] + cfg.b) % cfg.vocab
            toks[:, i + 1] = np.where(noise[:, i], rand[:, i], nxt)
        toks = torch.from_numpy(toks).to(self.device)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}
