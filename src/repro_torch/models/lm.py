"""Model assembly, every family of the JAX package in its layout:
``dense``, ``vlm`` (the dense backbone; precomputed patch embeddings
prepended to the tokens), ``moe`` (an optional dense prefix, then
attention + routed MoE layers, on one device; GQA or MLA attention, the
shared experts beside the routed ones), ``ssm`` (Mamba-1 layers),
``hybrid`` (Jamba: periods of ``attn_period - 1`` Mamba sublayers and one
attention sublayer, each followed by a routed MoE on every
``moe_every``-th sublayer and a dense SwiGLU otherwise) and ``encdec``
(an encoder of non-causal attention + SwiGLU layers over precomputed
frame embeddings, ``batch["frame_embeds"]`` (B, F, d), then decoder
layers of causal self-attention, cross-attention over the encoder's
states and SwiGLU).

Parameters are a dict pytree with each group's layers stacked along a
leading axis (``params["g0"]["attn"]["wq"]`` is (L, d, H*hd)), exactly as
the JAX package stacks them for ``lax.scan``, so params and caches
convert leaf for leaf.  The port runs the layers in a Python loop over
that axis, no scan.  A hybrid group's "layer" is a period, whose
sublayers are stacked once more inside it (``mamba`` (P, period - 1,
...), ``moe`` (P, period // moe_every, ...), ``mlp`` (P, period -
n_moe, ...), ``attn`` (P, ...), the norms ``ln.w`` (P, 2 period, d)).

Three execution modes share the layer code: ``loss_fn`` (training: the
causal LM loss, each layer and the head under activation checkpointing
as JAX's ``jax.checkpoint``), ``prefill`` (returns the layer-stacked
caches) and ``decode_step`` (one token against them, written in place).
An encoder-decoder's caches begin with ``{"enc": (B, F, d)}``, the
encoder's normed states, which every decode step attends to again (no
cross-attention KV cache, as in the JAX package).
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
    """A run of identical layers, stacked (the JAX package's
    ``Group``)."""
    kind: str          # dense | moe | ssm | hybrid | encoder | decoder_x
    n: int             # number of layers (hybrid: number of periods)
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
    if f == "hybrid":
        if not (cfg.attn_period and cfg.n_layers % cfg.attn_period == 0):
            raise ValueError(f"hybrid: n_layers {cfg.n_layers} is no "
                             f"multiple of attn_period {cfg.attn_period}")
        return [Group("hybrid", cfg.n_layers // cfg.attn_period, moe=True)]
    if f == "encdec":
        return [Group("encoder", cfg.encoder_layers, causal=False,
                      ff=cfg.d_ff),
                Group("decoder_x", cfg.n_layers, ff=cfg.d_ff)]
    raise ValueError(f)


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


def _stacked(n: int, make) -> dict:
    """``n`` results of ``make()`` stacked along a new first axis, drawn
    one at a time into the stack, so the fp32 draws stay one layer large
    (a qwen3 expert stack is 0.8 GB in fp32); a stack of one keeps its
    draw as its view (a deepseek-v3 MoE layer is 45 GB in fp32)."""
    one = make()
    if n == 1:
        return tree_map(lambda a: a[None], one)
    stack = tree_map(lambda a: a.new_empty((n, *a.shape)), one)
    _copy_into(layer(stack, 0), one)
    del one
    for i in range(1, n):
        _copy_into(layer(stack, i), make())
    return stack


def _stack_caches(cs: list):
    """Per-layer caches (nested dicts) stacked along a new first axis."""
    return tree_map(lambda *ts: torch.stack(ts), cs[0], *cs[1:])


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
            params[f"g{gi}"] = _stacked(
                g.n, lambda g=g: self._layer_init(gen, g, dev))
        return params

    def _layer_init(self, gen, g: Group, dev) -> dict:
        cfg = self.cfg
        if g.kind == "ssm":
            return {"ln1": L.norm_init(cfg.d_model, dev),
                    "mamba": Mb.mamba_init(gen, cfg)}
        if g.kind == "hybrid":
            return self._period_init(gen, dev)
        p = {"ln1": L.norm_init(cfg.d_model, dev),
             "attn": (L.mla_init(gen, cfg) if g.use_mla
                      else L.attn_init(gen, cfg)),
             "ln2": L.norm_init(cfg.d_model, dev)}
        if g.kind == "decoder_x":
            p["xattn"] = L.attn_init(gen, cfg)
            p["ln_x"] = L.norm_init(cfg.d_model, dev)
        if g.moe:
            p["moe"] = Moe.moe_init(gen, cfg)
        if g.ff:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, g.ff, cfg.dtype)
        return p

    def _period_init(self, gen, dev) -> dict:
        """One hybrid period: its Mamba sublayers, attention, MoE and
        dense SwiGLU sublayers each stacked, and its 2 x period norms
        (``ln``).  The MoE stack is drawn in place, slab by slab (Jamba's
        4 MoE sublayers of 16 experts are 38.7 B params)."""
        cfg = self.cfg
        period = cfg.attn_period
        n_moe = period // cfg.moe_every
        p = {"mamba": _stacked(period - 1, lambda: Mb.mamba_init(gen, cfg)),
             "attn": L.attn_init(gen, cfg),
             "moe": Moe.moe_init(gen, cfg, n=n_moe)}
        if period - n_moe:
            p["mlp"] = _stacked(period - n_moe, lambda: L.mlp_init(
                gen, cfg.d_model, cfg.d_ff, cfg.dtype))
        p["ln"] = {"w": torch.ones(2 * period, cfg.d_model,
                                   dtype=torch.float32, device=dev)}
        # the JAX package's period also holds an "ln1" that no sublayer
        # reads (its norms are "ln"); kept so the trees match leaf for leaf
        p["ln1"] = L.norm_init(cfg.d_model, dev)
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

    def _std_layer(self, p, x, cos, sin, mode, cache, pos, causal,
                   enc=None):
        x, c = self._attn_sublayer(p, x, cos, sin, mode, cache, pos, causal)
        if enc is not None:  # decoder cross-attention
            hx = L.rms_norm(p["ln_x"], x, self.cfg.norm_eps)
            x = x + L.cross_attn_apply(p["xattn"], self.cfg, hx, enc)
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

    def _hybrid_period(self, p, x, cos, sin, mode, cache, pos):
        """One Jamba period: ``attn_period - 1`` Mamba sublayers, then one
        causal attention sublayer, sublayer j normed by ``ln[2j]``; each
        followed by its FF, normed by ``ln[2j + 1]``: routed MoE where
        ``j % moe_every == moe_every - 1``, the dense SwiGLU otherwise.
        Prefill returns {"attn": {"k", "v"}, "mamba": {"h", "conv"}
        stacked over the Mamba sublayers}; decode writes ``cache`` in
        place.  The sublayers' params are taken by ``unbind``, so in
        training each stacked leaf's gradient is gathered once."""
        cfg = self.cfg
        period = cfg.attn_period
        n_moe = period // cfg.moe_every
        lns = p["ln"]["w"].unbind(0)
        mambas = _unstacked(p["mamba"], period - 1)
        moes = _unstacked(p["moe"], n_moe)
        mlps = _unstacked(p["mlp"], period - n_moe) if "mlp" in p else []
        ssm_caches, attn_cache = [], None
        i_moe = i_ff = 0
        for j in range(period):
            ln1, ln2 = {"w": lns[2 * j]}, {"w": lns[2 * j + 1]}
            if j == period - 1:
                x, attn_cache = self._attn_sublayer(
                    {"ln1": ln1, "attn": p["attn"]}, x, cos, sin, mode,
                    None if cache is None else cache["attn"], pos, True)
            else:
                x, c = self._ssm_layer(
                    {"ln1": ln1, "mamba": mambas[j]}, x, mode,
                    None if cache is None else layer(cache["mamba"], j))
                ssm_caches.append(c)
            h = L.rms_norm(ln2, x, cfg.norm_eps)
            if j % cfg.moe_every == cfg.moe_every - 1:
                x = x + Moe.moe_apply(moes[i_moe], cfg, h,
                                      inference=mode != "train")
                i_moe += 1
            else:
                x = x + L.mlp_apply(mlps[i_ff], h)
                i_ff += 1
        if mode == "prefill":
            return x, {"attn": attn_cache,
                       "mamba": _stack_caches(ssm_caches)}
        return x, cache

    # ----------------------------- group loop ------------------------------

    def _layer_fn(self, g: Group, cos, sin, mode, pos, enc):
        """Group g's layer body as (params, x, cache) -> (x, cache)."""
        if g.kind == "ssm":
            return lambda p, x, c: self._ssm_layer(p, x, mode, c)
        if g.kind == "hybrid":
            return lambda p, x, c: self._hybrid_period(p, x, cos, sin, mode,
                                                       c, pos)
        return lambda p, x, c: self._std_layer(p, x, cos, sin, mode, c, pos,
                                               g.causal, enc=enc)

    def _run_group(self, gi: int, g: Group, params, x, cos, sin, mode,
                   caches=None, pos=None, enc=None):
        """Run group gi's layers in order (a decoder's cross-attending
        to ``enc``).  Prefill returns the caches stacked over layers
        ({"k", "v"}: (L, B, Hkv, S, hd) for attention, {"c_kv": (L, B, S,
        dc), "k_rope": (L, B, S, dr)} for MLA, {"h": (L, B, Di, N) fp32,
        "conv": (L, B, K-1, Di)} for SSM layers, {"attn": {"k", "v"}: (P,
        B, Hkv, S, hd), "mamba": {"h": (P, period - 1, B, Di, N), "conv":
        (P, period - 1, B, K-1, Di)}} for hybrid periods); decode writes
        into ``caches`` in place and returns it.  ``"train"`` without
        autograd (the encoder inside a prefill) runs the layers without
        ``checkpoint``: the same values."""
        p_stack = params[f"g{gi}"]
        body = self._layer_fn(g, cos, sin, mode, pos, enc)
        if mode == "train" and not torch.is_grad_enabled():
            for i in range(g.n):
                x, _ = body(layer(p_stack, i), x, None)
            return x, None
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
            return x, _stack_caches(cs)
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

    def _encode(self, params, batch):
        """The encoder group over ``batch["frame_embeds"]`` in the
        config's dtype, with RoPE at the frame positions, then the final
        norm ``ln_f`` (the decoder's own, as in the JAX package).  A batch
        without frames raises ``KeyError: 'frame_embeds'`` here, as the
        JAX model does."""
        cfg = self.cfg
        enc = batch["frame_embeds"].to(cfg.dtype)
        cos, sin = L.rope_table(enc.shape[1], cfg.hd, cfg.rope_theta,
                                enc.device)
        enc, _ = self._run_group(0, self.groups[0], params, enc, cos, sin,
                                 "train")
        return L.rms_norm(params["ln_f"], enc, cfg.norm_eps)

    # ------------------------------- modes ---------------------------------

    def loss_fn(self, params, batch):
        """Causal LM cross-entropy of batch["labels"] given
        batch["tokens"], both (B, S) int: a 0-d fp32 tensor, to
        differentiate with autograd.  A ``vlm`` batch may carry
        ``patch_embeds`` (B, P, d), prepended to the tokens and dropped
        after the final norm, so the labels stay those of the tokens.
        An ``encdec`` batch carries ``frame_embeds`` (B, F, d), the
        encoder's inputs.  Each layer (a hybrid period) and the head loss
        run under ``checkpoint`` (recomputed in the backward, as JAX's
        ``jax.checkpoint``), so the (tokens, vocab) fp32 logits do not
        live across the backward."""
        cfg = self.cfg
        x = self._embed(params, batch)
        cos, sin = L.rope_table(x.shape[1], self._rope_dim(),
                                cfg.rope_theta, x.device)
        enc, g0 = self._encoder_states(params, batch)
        for gi in range(g0, len(self.groups)):
            x, _ = self._run_group(gi, self.groups[gi], params, x, cos, sin,
                                   "train", enc=enc)
        x = L.rms_norm(params["ln_f"], x, cfg.norm_eps)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = x[:, batch["patch_embeds"].shape[1]:]
        return checkpoint(_head_loss, params["head"], x, batch["labels"],
                          use_reentrant=False)

    def prefill(self, params, batch):
        """batch["tokens"]: (B, S) int (an ``encdec`` batch also
        ``frame_embeds``).  Returns (last-token logits (B, 1, V) fp32,
        caches list per group; an encoder-decoder's first entry is
        {"enc": the encoder's states})."""
        cfg = self.cfg
        x = self._embed(params, batch)
        s = x.shape[1]
        cos, sin = L.rope_table(s, self._rope_dim(), cfg.rope_theta,
                                x.device)
        enc, g0 = self._encoder_states(params, batch)
        caches: list = [] if enc is None else [{"enc": enc}]
        for gi in range(g0, len(self.groups)):
            x, c = self._run_group(gi, self.groups[gi], params, x, cos, sin,
                                   "prefill", enc=enc)
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
        g0 = 1 if cfg.family == "encdec" else 0
        enc = caches[0]["enc"] if g0 else None
        for gi in range(g0, len(self.groups)):
            x, _ = self._run_group(gi, self.groups[gi], params, x, cos_t,
                                   sin_t, "decode", caches=caches[gi],
                                   pos=pos, enc=enc)
        x = L.rms_norm(params["ln_f"], x, cfg.norm_eps)
        return self._logits(params, x), caches

    # ------------------------------ helpers --------------------------------

    def _encoder_states(self, params, batch):
        """(the encoder's states, the first decoder group) for an
        ``encdec`` model, else (None, 0)."""
        if self.cfg.family != "encdec":
            return None, 0
        return self._encode(params, batch), 1

    def _rope_dim(self) -> int:
        return self.cfg.qk_rope_dim if self.cfg.use_mla else self.cfg.hd

    def _rope_at(self, pos: int, device=None):
        dim = self._rope_dim()
        inv = 1.0 / (self.cfg.rope_theta
                     ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                      device=device) / dim))
        f = float(pos) * inv
        return torch.cos(f)[None], torch.sin(f)[None]

