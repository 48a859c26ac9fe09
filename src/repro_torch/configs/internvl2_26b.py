"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821; hf].

The InternViT frontend is a stub, as in the JAX package: a batch carries
precomputed patch embeddings under "patch_embeds" (256 tokens per image
at the backbone width), prepended to the token sequence; the loss drops
their positions before the head."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92553, head_dim=128,
    frontend="vit", frontend_tokens=256)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        frontend="vit", frontend_tokens=8)
