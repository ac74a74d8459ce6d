"""Model zoo of the port: the decoder-only families and the
encoder-decoder as plain functions over parameter dicts of torch tensors."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.zoo import build_model

__all__ = ["ModelConfig", "build_model"]
