"""Model assembly, the decoder-only families in the JAX package's layout:
``dense``, ``vlm`` (the dense backbone; precomputed patch embeddings
prepended to the tokens), ``moe`` (an optional dense prefix, then
attention + routed MoE layers, on one device; GQA or MLA attention, the
shared experts beside the routed ones) and ``ssm`` (Mamba-1 layers).

Parameters are a dict pytree with each group's layers stacked along a
leading axis (``params["g0"]["attn"]["wq"]`` is (L, d, H*hd)), exactly as
the JAX package stacks them for ``lax.scan``, so params and caches
convert leaf for leaf.  The port runs the layers in a Python loop over
that axis, no scan.

Three execution modes share the layer code: ``loss_fn`` (training: the
causal LM loss, each layer and the head under activation checkpointing
as JAX's ``jax.checkpoint``), ``prefill`` (returns the layer-stacked
caches) and ``decode_step`` (one token against them, written in place).
Every family both trains and serves: attention trains through
``flash_attention``'s autograd Function, the MoE router through
``moe_router``'s, and the SSM scan through the scan's forward and
backward kernels; its serving caches are the recurrent state.  MLA
layers (deepseek-v3) attend through the plain attention functions in
every mode, as the JAX package's do (``layers.py``), and cache only the
compressed latent.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.convert import tree_map
from repro_torch.core.predictor import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as Mb
from repro_torch.models import moe as Moe
from repro_torch.models.config import ModelConfig

@dataclasses.dataclass(frozen=True)
class Group:
    """A run of identical layers, stacked (the JAX package's ``Group``,
    with the fields of the kinds the port runs)."""
    kind: str          # dense | moe | ssm
    n: int             # number of layers
    causal: bool = True
    use_mla: bool = False
    ff: int = 0        # dense ff dim (0 -> no dense mlp)
    moe: bool = False


def _groups(cfg: ModelConfig) -> list[Group]:
    f = cfg.family
    if f in ("dense", "vlm"):
        return [Group("dense", cfg.n_layers, ff=cfg.d_ff)]
    if f == "moe":
        gs = []
        if cfg.first_dense_layers:
            gs.append(Group("dense", cfg.first_dense_layers,
                            use_mla=cfg.use_mla,
                            ff=cfg.dense_d_ff or cfg.d_ff))
        gs.append(Group("moe", cfg.n_layers - cfg.first_dense_layers,
                        use_mla=cfg.use_mla, moe=True))
        return gs
    if f == "ssm":
        return [Group("ssm", cfg.n_layers)]
    raise NotImplementedError(
        f"family {f!r} is not ported yet: ROADMAP.md Queue 1 item 4.5c (the "
        f"encdec and hybrid families)")


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


def _unstacked(stack: dict, n: int) -> list[dict]:
    """The ``n`` layers' params of a layer-stacked group as views, by one
    ``unbind`` per leaf: autograd then gathers a leaf's layer gradients
    into its stacked gradient once (indexing layer by layer would add a
    full-size gradient per layer)."""
    parts = tree_map(lambda t: t.unbind(0), stack)

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    return [pick(parts, i) for i in range(n)]


def _head_loss(head_w, xs, labels):
    """Mean NLL of the labels under fp32 logits (max-subtracted
    log-sum-exp) plus 1e-4 * mean(lse^2).  The label logit is a gather:
    it equals JAX's one-hot sum exactly, every other term being 0."""
    logits = (xs @ head_w).float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    label_logit = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - label_logit
    zloss = 1e-4 * (lse ** 2).mean()   # logit drift regularizer
    return nll.mean() + zloss


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
            # 0.8 GB in fp32); a group of one layer keeps its draw as its
            # stack (a deepseek-v3 MoE layer is 45 GB in fp32)
            one = self._layer_init(gen, g, dev)
            if g.n == 1:
                params[f"g{gi}"] = tree_map(lambda a: a[None], one)
                del one
                continue
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
        if g.kind == "ssm":
            return {"ln1": L.norm_init(cfg.d_model, dev),
                    "mamba": Mb.mamba_init(gen, cfg)}
        p = {"ln1": L.norm_init(cfg.d_model, dev),
             "attn": (L.mla_init(gen, cfg) if g.use_mla
                      else L.attn_init(gen, cfg)),
             "ln2": L.norm_init(cfg.d_model, dev)}
        if g.moe:
            p["moe"] = Moe.moe_init(gen, cfg)
        if g.ff:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, g.ff, cfg.dtype)
        return p

    # --------------------------- layer bodies ------------------------------

    def _attn_sublayer(self, p, x, cos, sin, mode, cache, pos, causal):
        """GQA attention, or MLA where the config and the layer's params
        have it (JAX's test: ``cfg.use_mla and "wq_a" in p["attn"]``)."""
        cfg = self.cfg
        h = L.rms_norm(p["ln1"], x, cfg.norm_eps)
        mla = cfg.use_mla and "wq_a" in p["attn"]
        if mode == "train":
            if mla:
                return x + L.mla_apply(p["attn"], cfg, h, cos, sin), None
            return x + L.attn_apply(p["attn"], cfg, h, cos, sin,
                                    causal=causal), None
        if mode == "prefill":
            if mla:
                o, c = L.mla_prefill(p["attn"], cfg, h, cos, sin)
            else:
                o, c = L.attn_prefill(p["attn"], cfg, h, cos, sin,
                                      causal=causal)
            return x + o, c
        if mla:
            o, c = L.mla_decode(p["attn"], cfg, h, cache, pos, cos, sin)
        else:
            o, c = L.attn_decode(p["attn"], cfg, h, cache, pos, cos, sin)
        return x + o, c

    def _ff_sublayer(self, p, x, mode="train"):
        """Routed experts or the dense MLP: JAX adds whichever the layer
        has to zeros (exact), and no config gives a layer both.  Training
        routes with the capacity factor's drops, serving dropless
        (JAX's ``_routed``)."""
        cfg = self.cfg
        h = L.rms_norm(p["ln2"], x, cfg.norm_eps)
        if "moe" in p:
            return x + Moe.moe_apply(p["moe"], cfg, h,
                                     inference=mode != "train")
        return x + L.mlp_apply(p["mlp"], h)

    def _std_layer(self, p, x, cos, sin, mode, cache, pos, causal):
        x, c = self._attn_sublayer(p, x, cos, sin, mode, cache, pos, causal)
        return self._ff_sublayer(p, x, mode), c

    def _ssm_layer(self, p, x, mode, cache):
        cfg = self.cfg
        h = L.rms_norm(p["ln1"], x, cfg.norm_eps)
        if mode == "train":
            return x + Mb.mamba_apply(p["mamba"], cfg, h), None
        if mode == "prefill":
            o, c = Mb.mamba_prefill(p["mamba"], cfg, h)
            return x + o, c
        o, c = Mb.mamba_decode(p["mamba"], cfg, h, cache)
        return x + o, c

    # ----------------------------- group loop ------------------------------

    def _layer_fn(self, g: Group, cos, sin, mode, pos):
        """Group g's layer body as (params, x, cache) -> (x, cache)."""
        if g.kind == "ssm":
            return lambda p, x, c: self._ssm_layer(p, x, mode, c)
        return lambda p, x, c: self._std_layer(p, x, cos, sin, mode, c, pos,
                                               g.causal)

    def _run_group(self, gi: int, g: Group, params, x, cos, sin, mode,
                   caches=None, pos=None):
        """Run group gi's layers in order.  Prefill returns the caches
        stacked over layers ({"k", "v"}: (L, B, Hkv, S, hd) for attention,
        {"c_kv": (L, B, S, dc), "k_rope": (L, B, S, dr)} for MLA, {"h":
        (L, B, Di, N) fp32, "conv": (L, B, K-1, Di)} for SSM layers);
        decode writes into ``caches`` in place and returns it."""
        p_stack = params[f"g{gi}"]
        body = self._layer_fn(g, cos, sin, mode, pos)
        if mode == "train":
            # remat per layer, as JAX's scan over jax.checkpoint: only the
            # layer inputs live across the backward
            def run(p_layer, x):
                return body(p_layer, x, None)[0]

            for p_layer in _unstacked(p_stack, g.n):
                x = checkpoint(run, p_layer, x, use_reentrant=False)
            return x, None
        if mode == "prefill":
            cs = []
            for i in range(g.n):
                x, c = body(layer(p_stack, i), x, None)
                cs.append(c)
            return x, {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
        for i in range(g.n):
            x, _ = body(layer(p_stack, i), x, layer(caches, i))
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

    def loss_fn(self, params, batch):
        """Causal LM cross-entropy of batch["labels"] given
        batch["tokens"], both (B, S) int: a 0-d fp32 tensor, to
        differentiate with autograd.  A ``vlm`` batch may carry
        ``patch_embeds`` (B, P, d), prepended to the tokens and dropped
        after the final norm, so the labels stay those of the tokens.
        Each layer and the head loss run under ``checkpoint`` (recomputed
        in the backward, as JAX's ``jax.checkpoint``), so the (tokens,
        vocab) fp32 logits do not live across the backward."""
        cfg = self.cfg
        x = self._embed(params, batch)
        cos, sin = L.rope_table(x.shape[1], self._rope_dim(),
                                cfg.rope_theta, x.device)
        for gi, g in enumerate(self.groups):
            x, _ = self._run_group(gi, g, params, x, cos, sin, "train")
        x = L.rms_norm(params["ln_f"], x, cfg.norm_eps)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = x[:, batch["patch_embeds"].shape[1]:]
        return checkpoint(_head_loss, params["head"], x, batch["labels"],
                          use_reentrant=False)

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

