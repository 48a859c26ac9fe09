"""Model assembly, the dense families (``dense`` and ``vlm``'s dense
backbone) and ``moe`` (attention + routed MoE layers, on one device), in
the JAX package's layout.

Parameters are a dict pytree with each group's layers stacked along a
leading axis (``params["g0"]["attn"]["wq"]`` is (L, d, H*hd)), exactly as
the JAX package stacks them for ``lax.scan``, so params and caches
convert leaf for leaf.  The port runs the layers in a Python loop over
that axis: no scan, no remat.

Two execution modes share the layer code: ``prefill`` (returns the
layer-stacked caches) and ``decode_step`` (one token against them,
written in place).  Training (``loss_fn``) comes with the training
slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.convert import tree_map
from repro_torch.core.predictor import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as Moe
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Group:
    """A run of identical layers, stacked (the JAX package's ``Group``,
    with the fields of the kinds the port runs)."""
    kind: str          # dense | moe
    n: int             # number of layers
    causal: bool = True
    ff: int = 0        # dense ff dim (0 -> no dense mlp)
    moe: bool = False


def _groups(cfg: ModelConfig) -> list[Group]:
    f = cfg.family
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA attention is not ported yet: ROADMAP.md Queue 1 item 4.5 "
            "(the rest of the LM stack)")
    if f in ("dense", "vlm"):
        return [Group("dense", cfg.n_layers, ff=cfg.d_ff)]
    if f == "moe":
        if cfg.first_dense_layers:
            raise NotImplementedError(
                "a dense prefix before the MoE layers is not ported yet: "
                "ROADMAP.md Queue 1 item 4.5 (the rest of the LM stack)")
        return [Group("moe", cfg.n_layers, moe=True)]
    waits = {"ssm": "Queue 1 item 2 (the SSM training forward)"}
    raise NotImplementedError(
        f"family {f!r} is not ported yet: ROADMAP.md "
        f"{waits.get(f, 'Queue 1 item 4.5 (the rest of the LM stack)')}")


def full_precision() -> None:
    """fp32 products in IEEE fp32 on the card (no TF32), and bf16 products
    reduced in fp32 (no bf16 split-K reductions), as the JAX CPU
    reference computes them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s params (views) from a layer-stacked group."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def _copy_into(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.groups = _groups(cfg)
        full_precision()

    # ------------------------------ init ----------------------------------

    def init(self, seed: int = 0, device: str | torch.device = "cuda"
             ) -> dict:
        """Seeded random params on ``device`` (default CUDA; raises
        without a card), with the JAX package's scales, shapes and dtypes
        (matrices in ``cfg.dtype``, norms fp32).  Drawn from a
        ``torch.Generator`` on the device, so the numbers differ from
        ``jax.random`` and between devices; for parity with the JAX
        package convert its params (``convert.from_jax``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        embed = torch.randn(cfg.padded_vocab, cfg.d_model, generator=gen,
                            device=dev, dtype=torch.float32)
        params: dict = {
            "embed": (embed * cfg.d_model ** -0.5).to(cfg.dtype),
            "ln_f": L.norm_init(cfg.d_model, dev),
            "head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                 cfg.dtype),
        }
        del embed
        for gi, g in enumerate(self.groups):
            # drawn one layer at a time into the stacked leaves, so the
            # fp32 draws stay one layer large (a qwen3 expert stack is
            # 0.8 GB in fp32)
            one = self._layer_init(gen, g, dev)
            stack = tree_map(lambda a: a.new_empty((g.n, *a.shape)), one)
            for i in range(g.n):
                if i:
                    one = self._layer_init(gen, g, dev)
                _copy_into(layer(stack, i), one)
                del one
            params[f"g{gi}"] = stack
        return params

    def _layer_init(self, gen, g: Group, dev) -> dict:
        cfg = self.cfg
        p = {"ln1": L.norm_init(cfg.d_model, dev),
             "attn": L.attn_init(gen, cfg),
             "ln2": L.norm_init(cfg.d_model, dev)}
        if g.moe:
            p["moe"] = Moe.moe_init(gen, cfg)
        if g.ff:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, g.ff, cfg.dtype)
        return p

    # --------------------------- layer bodies ------------------------------

    def _attn_sublayer(self, p, x, cos, sin, mode, cache, pos, causal):
        cfg = self.cfg
        h = L.rms_norm(p["ln1"], x, cfg.norm_eps)
        if mode == "prefill":
            o, c = L.attn_prefill(p["attn"], cfg, h, cos, sin,
                                  causal=causal)
            return x + o, c
        o, c = L.attn_decode(p["attn"], cfg, h, cache, pos, cos, sin)
        return x + o, c

    def _ff_sublayer(self, p, x):
        """Routed experts or the dense MLP: JAX adds whichever the layer
        has to zeros (exact), and no config gives a layer both."""
        cfg = self.cfg
        h = L.rms_norm(p["ln2"], x, cfg.norm_eps)
        if "moe" in p:
            return x + Moe.moe_apply(p["moe"], cfg, h)
        return x + L.mlp_apply(p["mlp"], h)

    def _std_layer(self, p, x, cos, sin, mode, cache, pos, causal):
        x, c = self._attn_sublayer(p, x, cos, sin, mode, cache, pos, causal)
        return self._ff_sublayer(p, x), c

    # ----------------------------- group loop ------------------------------

    def _run_group(self, gi: int, g: Group, params, x, cos, sin, mode,
                   caches=None, pos=None):
        """Run group gi's layers in order.  Prefill returns the caches
        stacked over layers, {"k", "v"}: (L, B, Hkv, S, hd); decode writes
        into ``caches`` in place and returns it."""
        p_stack = params[f"g{gi}"]
        if mode == "prefill":
            ks, vs = [], []
            for i in range(g.n):
                x, c = self._std_layer(layer(p_stack, i), x, cos, sin,
                                       mode, None, None, g.causal)
                ks.append(c["k"])
                vs.append(c["v"])
            return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
        for i in range(g.n):
            x, _ = self._std_layer(layer(p_stack, i), x, cos, sin, mode,
                                   layer(caches, i), pos, g.causal)
        return x, caches

    # ------------------------------- embed ---------------------------------

    def _embed(self, params, batch):
        cfg = self.cfg
        x = params["embed"][batch["tokens"]].to(cfg.dtype)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(cfg.dtype), x], dim=1)
        return x

    def _logits(self, params, x):
        return (x @ params["head"]).float()

    # ------------------------------- modes ---------------------------------

    def prefill(self, params, batch):
        """batch["tokens"]: (B, S) int.  Returns (last-token logits
        (B, 1, V) fp32, caches list per group)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        s = x.shape[1]
        cos, sin = L.rope_table(s, self._rope_dim(), cfg.rope_theta,
                                x.device)
        caches: list = []
        for gi, g in enumerate(self.groups):
            x, c = self._run_group(gi, g, params, x, cos, sin, "prefill")
            caches.append(c)
        x = L.rms_norm(params["ln_f"], x, cfg.norm_eps)
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params, caches, tokens, pos: int):
        """tokens: (B, 1) int; pos: host int, the current position.
        Returns (logits (B, 1, V) fp32, caches), the caches updated in
        place."""
        cfg = self.cfg
        x = params["embed"][tokens].to(cfg.dtype)
        cos_t, sin_t = self._rope_at(pos, x.device)
        for gi, g in enumerate(self.groups):
            x, _ = self._run_group(gi, g, params, x, cos_t, sin_t, "decode",
                                   caches=caches[gi], pos=pos)
        x = L.rms_norm(params["ln_f"], x, cfg.norm_eps)
        return self._logits(params, x), caches

    # ------------------------------ helpers --------------------------------

    def _rope_dim(self) -> int:
        return self.cfg.qk_rope_dim if self.cfg.use_mla else self.cfg.hd

    def _rope_at(self, pos: int, device=None):
        dim = self._rope_dim()
        inv = 1.0 / (self.cfg.rope_theta
                     ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                      device=device) / dim))
        f = float(pos) * inv
        return torch.cos(f)[None], torch.sin(f)[None]

