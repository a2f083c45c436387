"""Model zoo of the port: the dense decoder LM (prefill + decode)."""
from repro_torch.models.config import ModelConfig, ParamSpec
from repro_torch.models.transformer import LanguageModel, build_model

__all__ = ["ModelConfig", "ParamSpec", "LanguageModel", "build_model"]
