"""The port's federation, straggler and monitor code against repro's, on
the CPU: numpy on both sides, so everything here must be bit-identical
(datasets, partitions, client stores, global batches for dense and sparse
plans with and without shard grouping, delays, TPE, Serfling radii and
the GPSL monitor's summaries)."""
import dataclasses

import numpy as np
import pytest

from repro.core import deviation as jdev
from repro.core import partition as jpart
from repro.core import sampling as jsampling
from repro.core import straggler as jstrag
from repro.data import federated as jfed
from repro.data import synthetic as jsyn
from repro.obs import monitor as jmon
from repro_torch.core import deviation as tdev
from repro_torch.core import partition as tpart
from repro_torch.core import sampling as tsampling
from repro_torch.core import straggler as tstrag
from repro_torch.data import federated as tfed
from repro_torch.data import synthetic as tsyn
from repro_torch.obs import monitor as tmon
from repro_torch.runtime import workload as tworkload
from torch_one_thread import one_torch_thread  # noqa: F401


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _eq_pop(a, b):
    for f in ("dataset_sizes", "class_counts", "delays"):
        _eq(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("n,size,seed", [(64, 16, 0), (40, 32, 3),
                                         (17, 8, 99)])
def test_classification_dataset_is_bit_identical(n, size, seed):
    for j, t in zip(jsyn.make_classification_dataset(n, 10, size, seed),
                    tsyn.make_classification_dataset(n, 10, size, seed)):
        _eq(j, t)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_partitions_are_bit_identical(seed):
    labels = np.random.default_rng(seed).integers(0, 10, 500)
    jp, jpop = jpart.partition_iid(labels, 8, 10, seed=seed)
    tp, tpop = tpart.partition_iid(labels, 8, 10, seed=seed)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        _eq(a, b)
    _eq_pop(jpop, tpop)
    for c, alpha, k in ((2, 0.3, 8), (3, 1.0, 13), (1, 0.1, 20)):
        jp, jpop = jpart.partition_dirichlet(labels, k, 10, c, alpha, seed)
        tp, tpop = tpart.partition_dirichlet(labels, k, 10, c, alpha, seed)
        for a, b in zip(jp, tp):
            _eq(a, b)
        _eq_pop(jpop, tpop)


def _stores(n=600, k=8, seed=1):
    x, y = jsyn.make_classification_dataset(n, 10, 8, seed=0)
    parts, jpop = jpart.partition_dirichlet(y, k, 10, 2, 0.3, seed=seed)
    _, tpop = tpart.partition_dirichlet(y, k, 10, 2, 0.3, seed=seed)
    return (jfed.ClientStore.from_partition(x, y, parts, jpop),
            tfed.ClientStore.from_partition(x, y, parts, tpop))


def test_client_stores_are_bit_identical():
    js, ts = _stores()
    assert js.num_clients == ts.num_clients
    for a, b in zip(js.flat_arrays(), ts.flat_arrays()):
        _eq(a, b)
    for a, b in zip(js.features + js.labels, ts.features + ts.labels):
        _eq(a, b)
    flat = tfed.ClientStore.from_flat(*ts.flat_arrays(), ts.population)
    assert flat.num_clients == ts.num_clients and flat.features == []
    for a, b in zip(flat.flat_arrays(), ts.flat_arrays()):
        _eq(a, b)
    for sizes in ([3, 0, 2], [0], [1, 1, 5]):
        sizes = np.array(sizes, np.int64)
        _eq(tfed._run_offsets(sizes), jfed._run_offsets(sizes))


@pytest.mark.parametrize("method", ["ugs", "fpls", "fls"])
@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("num_shards", [None, 3])
@pytest.mark.parametrize("aggregation", ["global_mean", "client_weighted"])
def test_global_batches_are_bit_identical(method, fmt, num_shards,
                                          aggregation):
    js, ts = _stores()
    jplan = jsampling.make_plan(method, js.population, 32, seed=4,
                                plan_format=fmt)
    tplan = tsampling.make_plan(method, ts.population, 32, seed=4,
                                plan_format=fmt)
    jb = list(jfed.GlobalBatchIterator(js, jplan, aggregation, seed=11,
                                       num_shards=num_shards))
    tb = list(tfed.GlobalBatchIterator(ts, tplan, aggregation, seed=11,
                                       num_shards=num_shards))
    assert len(jb) == len(tb) == jplan.num_steps
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b)
        for key in a:
            _eq(a[key], b[key])
    with pytest.raises(RuntimeError, match="single-use"):
        it = tfed.GlobalBatchIterator(ts, tplan, aggregation, seed=11)
        list(it)
        list(it)


def test_straggler_delays_and_tpe_are_bit_identical():
    assert tworkload.assign_delays is tstrag.assign_delays
    for args in ((8, 0.2, 100.0, 500.0, 0), (50, 0.5, 10.0, 20.0, 3)):
        _eq(tstrag.assign_delays(*args), jstrag.assign_delays(*args))
    js, ts = _stores(k=12)
    delays = jstrag.assign_delays(12, 0.4, 100.0, 500.0, seed=2)
    for method in ("ugs", "fls"):
        for fmt in ("dense", "sparse"):
            jplan = jsampling.make_plan(method, js.population, 32, seed=1,
                                        plan_format=fmt)
            tplan = tsampling.make_plan(method, ts.population, 32, seed=1,
                                        plan_format=fmt)
            want = jstrag.simulate_tpe_segments(jplan, delays,
                                                base_step_ms=45.0)
            got = tstrag.simulate_tpe_segments(tplan, delays,
                                               base_step_ms=45.0)
            dense = tstrag.simulate_tpe(tplan.local_batch_sizes, delays,
                                        base_step_ms=45.0)
            for res in (got, dense):
                assert res.total_ms == want.total_ms
                _eq(res.per_step_ms, want.per_step_ms)
                _eq(res.contributing, want.contributing)
    plan = tsampling.make_plan("ugs", ts.population, 32, seed=1)
    _eq(tstrag.simulate_tpe(plan.local_batch_sizes, delays, 60.0, 0.5)
        .per_step_ms,
        jstrag.simulate_tpe(plan.local_batch_sizes, delays, 60.0, 0.5)
        .per_step_ms)


@pytest.mark.parametrize("b,d", [(64, 50000), (1, 1), (32, 600),
                                 (600, 600)])
def test_serfling_radius_is_bit_identical(b, d):
    for delta in (0.05, 1e-3, 0.5):
        assert tdev.serfling_epsilon(b, d, delta) == \
            jdev.serfling_epsilon(b, d, delta)
    for eps in (0.01, 0.1, 0.3):
        assert tdev.serfling_bound(b, d, eps) == \
            jdev.serfling_bound(b, d, eps)


class _Tracer:
    enabled = True

    def __init__(self):
        self.rows = []

    def record(self, kind, **payload):
        self.rows.append((kind, payload))


@pytest.mark.parametrize("method", ["ugs", "fls", "fpls"])
@pytest.mark.parametrize("fmt", ["dense", "sparse"])
def test_monitor_summaries_are_identical(method, fmt):
    js, ts = _stores(n=900)
    jplan = jsampling.make_plan(method, js.population, 32, seed=2,
                                plan_format=fmt)
    tplan = tsampling.make_plan(method, ts.population, 32, seed=2,
                                plan_format=fmt)
    out = []
    for mod, pop, plan in ((jmon, js.population, jplan),
                           (tmon, ts.population, tplan)):
        tracer = _Tracer()
        mon = mod.GPSLMonitor(pop, 32, delta=0.05, epoch=1,
                              num_steps=plan.num_steps, tracer=tracer)
        for t in range(plan.num_steps):
            mon.observe_plan_step(plan, t)
        out.append((mon.finish().to_dict(), mon.step_records, tracer.rows))
    assert out[0] == out[1]
    summary = out[1][0]
    assert summary["steps"] == tplan.num_steps
    if method == "ugs":
        assert summary["ok"]
    truncated = tmon.GPSLMonitor(ts.population, 32,
                                 num_steps=tplan.num_steps)
    truncated.observe_plan_step(tplan, 0)
    assert not truncated.finish().complete


def test_monitor_from_spec_follows_the_obs_spec():
    import repro_torch.api as tapi
    _, ts = _stores()
    pop = ts.population
    assert tmon.monitor_from_spec(None, pop, 32) is None
    assert tmon.monitor_from_spec(tapi.ObsSpec(), pop, 32) is None
    assert tmon.monitor_from_spec(tapi.ObsSpec(enabled=True,
                                               monitor=False), pop, 32) \
        is None
    mon = tmon.monitor_from_spec(
        tapi.ObsSpec(enabled=True, monitor_delta=0.1), pop, 32, epoch=2,
        num_steps=5)
    assert (mon.delta, mon.epoch, mon.num_steps) == (0.1, 2, 5)
    assert dataclasses.is_dataclass(tmon.MonitorSummary)
