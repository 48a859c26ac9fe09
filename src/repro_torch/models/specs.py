"""Meta-device input specs for every (arch x shape) cell (the JAX
package's ``models/specs.py``, with meta tensors in place of
``ShapeDtypeStruct``): shapes and dtypes, no storage, no device.

The dry run plans against these.  The decode caches are derived from the
model's layer groups (``cache_specs``), not from a meta prefill: the MoE
dispatch reads its per-expert counts to the host and the plain selective
scan steps through every position, neither of which a meta tensor can
do.  ``tests/test_torch_specs.py`` holds them to JAX's
``eval_shape(model.prefill)`` caches for every arch.
"""
from __future__ import annotations

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Model


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int,
                with_labels: bool) -> dict:
    d: dict = {}
    if cfg.family == "encdec":
        d["frame_embeds"] = meta((batch, cfg.frontend_tokens, cfg.d_model),
                                 torch.bfloat16)
        d["tokens"] = meta((batch, seq), torch.int32)
    elif cfg.family == "vlm":
        d["patch_embeds"] = meta((batch, cfg.frontend_tokens, cfg.d_model),
                                 torch.bfloat16)
        d["tokens"] = meta((batch, seq - cfg.frontend_tokens), torch.int32)
    else:
        d["tokens"] = meta((batch, seq), torch.int32)
    if with_labels:
        d["labels"] = meta(d["tokens"].shape, torch.int32)
    return d


def params_specs(model: Model, seed: int = 0) -> dict:
    """The params tree on the meta device (``Model.init`` on "meta")."""
    return model.init(seed, "meta")


def _attn_cache(cfg: ModelConfig, lead: tuple, b: int, s: int,
                mla: bool) -> dict:
    if mla:
        return {"c_kv": meta(lead + (b, s, cfg.kv_lora_rank), cfg.dtype),
                "k_rope": meta(lead + (b, s, cfg.qk_rope_dim), cfg.dtype)}
    kv = lead + (b, cfg.n_kv_heads, s, cfg.hd)
    return {"k": meta(kv, cfg.dtype), "v": meta(kv, cfg.dtype)}


def _ssm_cache(cfg: ModelConfig, lead: tuple, b: int) -> dict:
    return {"h": meta(lead + (b, cfg.d_inner, cfg.ssm_state),
                      torch.float32),
            "conv": meta(lead + (b, cfg.ssm_conv - 1, cfg.d_inner),
                         cfg.dtype)}


def cache_specs(model: Model, batch: int, seq: int) -> list:
    """The caches ``model.prefill`` returns for a (batch, seq) prompt, on
    the meta device: per group, its layers' caches stacked (an
    encoder-decoder's list begins with ``{"enc"}``)."""
    cfg = model.cfg
    out: list = []
    for g in model.groups:
        if g.kind == "encoder":
            out.append({"enc": meta((batch, cfg.frontend_tokens,
                                     cfg.d_model), cfg.dtype)})
        elif g.kind == "ssm":
            out.append(_ssm_cache(cfg, (g.n,), batch))
        elif g.kind == "hybrid":
            out.append({"attn": _attn_cache(cfg, (g.n,), batch, seq, False),
                        "mamba": _ssm_cache(cfg, (g.n, cfg.attn_period - 1),
                                            batch)})
        else:
            out.append(_attn_cache(cfg, (g.n,), batch, seq, g.use_mla))
    return out


def input_specs(model: Model, shape: ShapeSpec) -> dict:
    """Returns {mode-specific inputs} for planning, keyed per shape.kind:
      train   -> {batch}
      prefill -> {batch}
      decode  -> {caches, tokens, pos} (caches for a seq_len context)
    """
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, b, s, True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, b, s, False)}
    return {"caches": cache_specs(model, b, s),
            "tokens": meta((b, 1), torch.int32),
            "pos": meta((), torch.int32)}
