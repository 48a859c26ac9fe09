"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — mamba1 arch [arXiv:2410.05355; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    vocab=65024, ssm_state=16, ssm_conv=4, ssm_expand=2)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke", family="ssm", n_layers=2, d_model=64,
        vocab=256, ssm_state=8, ssm_conv=4, ssm_expand=2)
