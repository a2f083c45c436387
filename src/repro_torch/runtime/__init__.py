"""Continuous-batching split-serving runtime of the port (mirrors
:mod:`repro.runtime`).

Engines register with :mod:`repro_torch.api.registry` as an import side
effect of this package: ``"continuous"`` (:class:`ContinuousEngine`),
``"paged"`` (:class:`PagedEngine`), ``"speculative"``
(:class:`SpeculativeEngine`) and ``"static"`` (:class:`BatchedServer`,
the static-batch A/B baseline, which also serves the audio family),
scheduler policies ``"fifo"``/
``"ljf"``, and the ``"budget"``/``"tenant"`` admission controllers.
"""
from repro_torch.runtime.engine import (ContinuousEngine, ServeReport,
                                        reference_generate)
from repro_torch.runtime.kvcache import KVCachePool
from repro_torch.runtime.paging import PagedEngine, PagePool
from repro_torch.runtime.queue import (AdmissionController, RequestQueue,
                                       ServeRequest,
                                       TenantAdmissionController, apportion)
from repro_torch.runtime.sampling import TokenSampler
from repro_torch.runtime.scheduler import (Scheduler, VirtualClock,
                                           WallClock, make_clock)
from repro_torch.runtime.spec_decode import SpeculativeEngine
from repro_torch.runtime.static import BatchedServer, Request
from repro_torch.runtime.workload import (bursty_arrivals, diurnal_arrivals,
                                          generate_arrivals,
                                          heavy_tail_arrivals,
                                          poisson_arrivals,
                                          straggler_arrivals)

__all__ = ["AdmissionController", "BatchedServer", "ContinuousEngine", "KVCachePool",
           "PagePool", "PagedEngine", "Request", "RequestQueue", "Scheduler",
           "ServeReport", "ServeRequest", "SpeculativeEngine",
           "TenantAdmissionController",
           "TokenSampler", "VirtualClock", "WallClock", "apportion",
           "bursty_arrivals", "diurnal_arrivals", "generate_arrivals",
           "heavy_tail_arrivals", "make_clock", "poisson_arrivals",
           "reference_generate", "straggler_arrivals"]
