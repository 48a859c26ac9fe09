"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048 (expert)
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed top-8
[arXiv:2412.19437; hf].

MLA dims from the paper: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64,
v_head 128; first 3 layers dense with d_ff 18432. The multi-token-
prediction (MTP) head is out of scope (noted in DESIGN.md deviations);
the sigmoid+bias router is approximated by softmax top-k (same dispatch
shape — DESIGN.md).  The port runs MLA through the plain attention
functions, as the JAX package does (``models/layers.py``)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, vocab=129280,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    first_dense_layers=3, dense_d_ff=18432, d_ff=18432,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, vocab=256,
        n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=32,
        first_dense_layers=1, dense_d_ff=128, d_ff=128,
        use_mla=True, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16)
