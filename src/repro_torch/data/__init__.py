"""Data of the port (mirrors :mod:`repro.data`): the synthetic image and
LM datasets, the federated client store and the plan-driven global-batch
iterator."""
from repro_torch.data.federated import (ClientStore, GlobalBatchIterator,
                                        build_lm_client_store)
from repro_torch.data.synthetic import (make_classification_dataset,
                                        make_lm_dataset)

__all__ = ["make_classification_dataset", "make_lm_dataset",
           "build_lm_client_store", "ClientStore", "GlobalBatchIterator"]
