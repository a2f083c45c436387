"""Model zoo of the port: the decoder LM of the dense and ssm (Mamba-1)
families (training loss, prefill, decode)."""
from repro_torch.models.config import ModelConfig, ParamSpec
from repro_torch.models.transformer import LanguageModel, build_model

__all__ = ["ModelConfig", "ParamSpec", "LanguageModel", "build_model"]
