"""demo-100m: ~126M-param dense LM, the repo's end-to-end example model.
Not one of the 10 assigned archs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="demo-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=3072, vocab=8192, head_dim=64)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="demo-100m-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16)
