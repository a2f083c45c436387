"""Core of the port (mirrors :mod:`repro.core`): the paper's global
sampling — UGS, LDS, the EM-MAP estimator, deviation analytics,
partitioning and the straggler model, numpy and bit-identical to
``repro``'s reference backend — the vectorized planner engine and EM in
torch on the card (``planner.py``, ``em.py``), and the PSL protocol as
PyTorch step functions (``psl.py``)."""
from repro_torch.core.types import (ClientPopulation, EpochPlan,
                                    SparseEpochPlan, SparsePlanBuilder)
from repro_torch.core.sampling import (fls_plan, fpls_plan, lds_plan,
                                       make_plan, resolve_plan_format,
                                       ugs_plan)
from repro_torch.core.em import (EMResult, em_map, em_map_torch,
                                 em_update_torch, log_posterior)
from repro_torch.core.planner import (lds_plan_torch, resolve_backend,
                                      ugs_plan_torch)
from repro_torch.core.deviation import (batch_deviation, lemma1_bound,
                                        lemma2_bound, lemma2_terms,
                                        serfling_bound, serfling_epsilon,
                                        simulate_plan_deviation)
from repro_torch.core.partition import partition_dirichlet, partition_iid
from repro_torch.core.straggler import (adjust_concentration, assign_delays,
                                        delay_zscores, simulate_tpe,
                                        simulate_tpe_segments,
                                        straggler_arrivals)

__all__ = [
    "ClientPopulation", "EpochPlan", "SparseEpochPlan", "SparsePlanBuilder",
    "make_plan", "ugs_plan", "lds_plan",
    "fpls_plan", "fls_plan", "ugs_plan_torch", "lds_plan_torch",
    "resolve_backend", "resolve_plan_format", "EMResult", "em_map",
    "em_map_torch", "em_update_torch",
    "log_posterior", "batch_deviation", "lemma1_bound", "lemma2_bound",
    "lemma2_terms", "serfling_bound", "serfling_epsilon",
    "simulate_plan_deviation", "partition_dirichlet",
    "partition_iid", "adjust_concentration", "assign_delays",
    "delay_zscores", "simulate_tpe", "simulate_tpe_segments",
    "straggler_arrivals",
]
