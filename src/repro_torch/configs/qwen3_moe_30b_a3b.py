"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
(expert) vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

A copy of the JAX package's config, field for field.  Like it, the model
has no per-head q/k RMSNorm (Qwen3 has one) and keeps ``norm_eps`` 1e-5
(Qwen3 uses 1e-6): the port follows the reference it is held against."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, moe_d_ff=768, d_ff=768, rope_theta=1e6)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, vocab=256, head_dim=16,
        n_experts=8, top_k=2, moe_d_ff=32, d_ff=32)
