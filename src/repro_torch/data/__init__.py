"""Data of the port (mirrors :mod:`repro.data`): the synthetic LM
federation."""
from repro_torch.data.federated import build_lm_client_store
from repro_torch.data.synthetic import make_lm_dataset

__all__ = ["make_lm_dataset", "build_lm_client_store"]
