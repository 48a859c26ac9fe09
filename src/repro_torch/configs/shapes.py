"""Assigned input shapes (one set shared by all 10 LM-family archs).

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve_step; requires
               sub-quadratic attention: run for ssm/hybrid archs only,
               structural skip for pure full-attention archs (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and cfg.family not in \
            SUBQUADRATIC_FAMILIES:
        return False, ("structural skip: pure full-attention arch; "
                       "long_500k needs sub-quadratic attention")
    return True, ""
