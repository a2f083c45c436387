"""Training frameworks compared in the paper: CL, SL, FL, SFL, and PSL with
pluggable global sampling (UGS / LDS / FPLS / FLS) (port of
:mod:`repro.frameworks`).

Deprecated shims: the protocols live in :mod:`repro_torch.api.protocols`
and run through ``repro_torch.api.run(spec)``; these entry points remain
for existing callers."""
from repro_torch.api.loop import History
from repro_torch.frameworks.trainers import (evaluate, train_cl, train_fl,
                                             train_psl, train_psl_sharded,
                                             train_sfl, train_sl)

__all__ = ["History", "evaluate", "train_cl", "train_fl", "train_psl",
           "train_psl_sharded", "train_sfl", "train_sl"]
