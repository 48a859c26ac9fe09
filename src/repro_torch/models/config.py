"""Model configuration: a copy of the JAX package's ``ModelConfig``.

Same fields, defaults and derived sizes, so a config converts field for
field; ``dtype`` returns a torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 32000
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0            # expert hidden dim (0 -> use d_ff)
    first_dense_layers: int = 0  # deepseek-v3: first k layers are dense
    dense_d_ff: int = 0          # ff dim of those dense layers
    moe_every: int = 1           # jamba: MoE on every `moe_every`-th layer
    capacity_factor: float = 1.25

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0         # 0 -> d_model // 16

    # --- hybrid (jamba) ---
    attn_period: int = 0         # 1 attention layer per `attn_period` layers

    # --- enc-dec (seamless) ---
    encoder_layers: int = 0      # >0 -> encoder-decoder

    # --- modality frontend stubs ---
    frontend: Optional[str] = None  # "vit" | "audio"
    frontend_tokens: int = 0        # precomputed embedding tokens (stub)

    # --- misc ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 2048 (Megatron-style); small
        vocabularies (< 8192) are left as they are."""
        if self.vocab < 8192 or self.vocab % 2048 == 0:
            return self.vocab
        return ((self.vocab + 2047) // 2048) * 2048

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 1)

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def is_attention_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.attn_period:
            return i % self.attn_period == self.attn_period - 1
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        if i < self.first_dense_layers:
            return False
        return (i % self.moe_every) == (self.moe_every - 1) \
            if self.moe_every > 1 else True

    # ------------------------- parameter counting --------------------------

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, hd = self.d_model, self.hd
        n = 0
        n += self.padded_vocab * d               # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d           # lm head
        enc_layers = self.encoder_layers
        for i in range(self.n_layers + enc_layers):
            dec_i = i - enc_layers
            is_enc = i < enc_layers
            li = i if is_enc else dec_i
            if is_enc or self.is_attention_layer(li):
                if self.use_mla:
                    n += d * self.q_lora_rank
                    n += self.q_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.qk_rope_dim)
                    n += d * (self.kv_lora_rank + self.qk_rope_dim)
                    n += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    n += self.n_heads * self.v_head_dim * d
                else:
                    n += d * self.n_heads * hd            # wq
                    n += 2 * d * self.n_kv_heads * hd     # wk, wv
                    n += self.n_heads * hd * d            # wo
                if not is_enc and enc_layers:             # cross attention
                    n += d * self.n_heads * hd
                    n += 2 * d * self.n_kv_heads * hd
                    n += self.n_heads * hd * d
            elif self.family in ("ssm", "hybrid"):
                di, dn = self.d_inner, self.ssm_state
                n += d * 2 * di                 # in_proj
                n += di * self.ssm_conv         # depthwise conv
                n += di * (self.dt_rank + 2 * dn)  # x_proj
                n += self.dt_rank * di          # dt_proj
                n += di * dn + di               # A_log, D
                n += di * d                     # out_proj
            if is_enc or not self.is_moe_layer(li):
                ff = self.dense_d_ff or self.d_ff
                if ff and self.family != "ssm":
                    n += 3 * d * ff             # swiglu
            else:
                n += d * self.n_experts         # router
                n += self.n_experts * 3 * d * self.expert_ff
                n += self.n_shared_experts * 3 * d * self.expert_ff
            n += 2 * d                          # norms
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(self.is_moe_layer(i)
                           for i in range(self.n_layers))
        inactive = n_moe_layers * (self.n_experts - self.top_k) \
            * 3 * self.d_model * self.expert_ff
        return full - inactive
