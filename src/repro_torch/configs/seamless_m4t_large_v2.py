"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H d_ff=8192
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Encoder-decoder: 24 encoder + 24 decoder layers at the listed width. The
audio frontend is a STUB: input_specs() provides precomputed frame
embeddings for the encoder (per the assignment's [audio] note)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    encoder_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=256206, frontend="audio", frontend_tokens=1024)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="encdec", n_layers=2,
        encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, frontend="audio", frontend_tokens=16)
