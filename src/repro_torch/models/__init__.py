"""The LM stack of the port: dense configurations so far."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Model

__all__ = ["ModelConfig", "Model"]
