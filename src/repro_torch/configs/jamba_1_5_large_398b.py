"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

Period of 8 layers: 7 mamba + 1 attention; MoE on every 2nd sublayer
(16 experts, top-2), dense SwiGLU otherwise — matching Jamba's published
1:7 attention ratio and every-other-layer MoE."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72,
    d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
    head_dim=128, n_experts=16, top_k=2, moe_d_ff=24576, moe_every=2,
    attn_period=8, ssm_state=16, ssm_conv=4, ssm_expand=2)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid", n_layers=8, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        n_experts=4, top_k=2, moe_d_ff=128, moe_every=2, attn_period=8,
        ssm_state=8, ssm_conv=4, ssm_expand=2)
