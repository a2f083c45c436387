"""Core of the port (mirrors :mod:`repro.core`): the paper's global
sampling (numpy, bit-identical to ``repro``'s reference backend) and the
PSL protocol as PyTorch step functions (``psl.py``)."""
from repro_torch.core.types import (ClientPopulation, EpochPlan,
                                    SparseEpochPlan, SparsePlanBuilder)
from repro_torch.core.sampling import (fls_plan, fpls_plan, make_plan,
                                       resolve_backend, resolve_plan_format,
                                       ugs_plan)

__all__ = [
    "ClientPopulation", "EpochPlan", "SparseEpochPlan", "SparsePlanBuilder",
    "make_plan", "ugs_plan", "fpls_plan", "fls_plan", "resolve_backend",
    "resolve_plan_format",
]
