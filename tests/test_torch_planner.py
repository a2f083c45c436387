"""The port's LDS, MAP-EM, straggler, deviation and vectorized planner
against ``repro``'s, on the CPU.

Numpy side (``repro_torch.core.{sampling,em,straggler,deviation}``): the
same inputs and seeds give bit-identical results (plans, ``em_iterations``,
``pi_history``, EM's π, deviation statistics).

Torch side (``repro_torch.core.{em,planner}`` on ``device="cpu"``):
- ``em_map_torch`` (float32) against ``repro``'s ``em_map_jax`` (float32)
  on the same inputs: π within 1e-5, iterations within ±2 (two float32
  reductions in different orders near the stopping threshold);
- plans are valid epochs (rows sum to B, columns to the dataset sizes),
  dense and sparse plans of a seed are bit-identical, and the first-step
  counts agree in distribution with ``repro``'s numpy and JAX engines
  (torch's generators are not JAX's, so plans differ draw by draw) at the
  tolerances of ``tests/test_planner.py``;
- the engine's default device is the card: without CUDA it raises.
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import get_config as jget
from repro.core import deviation as jdeviation
from repro.core import em as jem
from repro.core import sampling as jsampling
from repro.core import straggler as jstraggler
from repro.core.types import ClientPopulation as JPop
from repro.models.cnn import CNNModel as JCNN
import repro_torch.api as tapi
from repro_torch.api import protocols as tprotocols
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import deviation as tdeviation
from repro_torch.core import em as tem
from repro_torch.core import planner as tplanner
from repro_torch.core import sampling as tsampling
from repro_torch.core import straggler as tstraggler
from repro_torch.core.psl import requires_grad_
from repro_torch.core.types import ClientPopulation as TPop
from repro_torch.optim import TrainState
from torch_one_thread import one_torch_thread  # noqa: F401

EM_PI_ATOL = 1e-5
EM_ITERS = 2


def _arrays(k=10, m=6, seed=0, zero=(), stragglers=2):
    """(sizes, class counts, delays) of a skewed federation; clients in
    ``zero`` hold no data (inactive for the planners)."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((k, m), np.int64)
    for i in range(k):
        cls = rng.choice(m, 2, replace=False)
        counts[i, cls] = rng.integers(5, 120, size=2)
    counts[list(zero)] = 0
    delays = np.zeros(k)
    delays[:stragglers] = rng.uniform(100, 500, stragglers)
    return counts.sum(1), counts, delays


def _pair(**kw):
    a = _arrays(**kw)
    return JPop(*a), TPop(*a)


def _homogeneous(k, per, seed):
    """``ClientPopulation.homogeneous`` in both packages (same draws)."""
    return (JPop.homogeneous(k, per, 10, seed=seed),
            TPop.homogeneous(k, per, 10, seed=seed))


def _plan_arrays(plan):
    if plan.format == "sparse":
        return (plan.step_offsets, plan.client_ids, plan.draw_counts)
    return (plan.local_batch_sizes,)


def _same_plan(a, b):
    assert type(a).__name__ == type(b).__name__
    assert (a.method, a.global_batch_size, a.em_iterations) == \
        (b.method, b.global_batch_size, b.em_iterations)
    for x, y in zip(_plan_arrays(a), _plan_arrays(b)):
        np.testing.assert_array_equal(x, y)
    assert len(a.pi_history) == len(b.pi_history)
    for x, y in zip(a.pi_history, b.pi_history):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# numpy: bit-identical to repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("reinit", [False, True])
@pytest.mark.parametrize("delta", [0.0, 1.5])
@pytest.mark.parametrize("chunk", [None, 4])
def test_numpy_lds_plan_is_repro_bit_for_bit(fmt, reinit, delta, chunk):
    jpop, tpop = _pair(zero=(3,))
    kw = dict(delta=delta, reinit=reinit, seed=7, plan_format=fmt,
              em_client_chunk=chunk)
    _same_plan(jsampling.lds_plan(jpop, 48, **kw),
               tsampling.lds_plan(tpop, 48, **kw))


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_em_map_and_log_posterior_are_repro_bit_for_bit(chunk, masked):
    _, pop = _pair(k=8, seed=4)
    nu = pop.class_counts.sum(0).astype(np.float64)
    beta = pop.class_distributions
    alpha = tsampling.initialize_concentration(pop, 1.0)
    np.testing.assert_array_equal(
        alpha, jsampling.initialize_concentration(JPop(
            pop.dataset_sizes, pop.class_counts, pop.delays), 1.0))
    active = np.arange(8) % 3 != 1 if masked else None
    pi0 = np.random.default_rng(1).dirichlet(np.ones(8))
    got = tem.em_map(nu, pi0, beta, alpha, tau=1e-8, active=active,
                     client_chunk=chunk)
    want = jem.em_map(nu, pi0, beta, alpha, tau=1e-8, active=active,
                      client_chunk=chunk)
    np.testing.assert_array_equal(got.pi, want.pi)
    assert (got.iterations, got.converged) == \
        (want.iterations, want.converged)
    assert tem.log_posterior(got.pi, nu, beta, alpha, active) == \
        jem.log_posterior(want.pi, nu, beta, alpha, active)


@pytest.mark.parametrize("delays", [[0.0, 0.0, 0.0], [3.0],
                                    [0.0, 120.5, 499.0, 0.0, 250.25]])
def test_delay_zscores_and_concentration_are_repro_bit_for_bit(delays):
    d = np.asarray(delays, np.float64)
    alpha = np.linspace(1.0, 9.0, d.size)
    np.testing.assert_array_equal(tstraggler.delay_zscores(d),
                                  jstraggler.delay_zscores(d))
    for delta in (0.0, 0.5, 1.5):
        np.testing.assert_array_equal(
            tstraggler.adjust_concentration(alpha, d, delta),
            jstraggler.adjust_concentration(alpha, d, delta))


@pytest.mark.parametrize("method", ["ugs", "lds"])
@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("with_replacement", [False, True])
def test_deviation_functions_are_repro_bit_for_bit(method, fmt,
                                                   with_replacement):
    jpop, tpop = _pair(seed=9)
    jplan = jsampling.make_plan(method, jpop, 32, seed=3, plan_format=fmt)
    tplan = tsampling.make_plan(method, tpop, 32, seed=3, plan_format=fmt)
    got = tdeviation.simulate_plan_deviation(
        tplan, tpop, seed=5, with_replacement=with_replacement)
    want = jdeviation.simulate_plan_deviation(
        jplan, jpop, seed=5, with_replacement=with_replacement)
    assert (got.mean, got.std) == (want.mean, want.std)
    np.testing.assert_array_equal(got.per_step, want.per_step)
    beta0 = tpop.overall_distribution
    counts = tpop.class_counts[:4]
    np.testing.assert_array_equal(tdeviation.batch_deviation(counts, beta0),
                                  jdeviation.batch_deviation(counts, beta0))
    np.testing.assert_array_equal(tdeviation.lemma1_bound(32, beta0, 0.1),
                                  jdeviation.lemma1_bound(32, beta0, 0.1))
    bk = np.arange(1, tpop.num_clients + 1)
    terms = tdeviation.lemma2_terms(bk, tpop.class_distributions, beta0)
    want_terms = jdeviation.lemma2_terms(bk, tpop.class_distributions, beta0)
    assert terms.keys() == want_terms.keys()
    for key in terms:
        np.testing.assert_array_equal(terms[key], want_terms[key])
    np.testing.assert_array_equal(
        tdeviation.lemma2_bound(bk, tpop.class_distributions, beta0, 0.1),
        jdeviation.lemma2_bound(bk, tpop.class_distributions, beta0, 0.1))


# ---------------------------------------------------------------------------
# torch EM against repro's JAX EM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("delta", [0.0, 1.5])
def test_em_map_torch_matches_em_map_jax(chunk, masked, delta):
    _, pop = _pair(k=9, seed=6, stragglers=3)
    nu = pop.class_counts.sum(0).astype(np.float64)
    alpha = tsampling.initialize_concentration(pop, delta)
    active = np.arange(9) % 4 != 2 if masked else None
    pi0 = np.random.default_rng(2).dirichlet(np.ones(9))
    pi_j, it_j, conv_j = jem.em_map_jax(nu, pi0, pop.class_distributions,
                                        alpha, tau=1e-6, active=active,
                                        client_chunk=chunk)
    pi_t, it_t, conv_t = tem.em_map_torch(nu, pi0, pop.class_distributions,
                                          alpha, tau=1e-6, active=active,
                                          client_chunk=chunk, device="cpu")
    assert pi_t.dtype == torch.float32
    np.testing.assert_allclose(pi_t.numpy(), np.asarray(pi_j),
                               atol=EM_PI_ATOL, rtol=0)
    assert abs(it_t - int(it_j)) <= EM_ITERS
    assert conv_t == bool(conv_j)
    if masked:
        assert np.all(pi_t.numpy()[~active] == 0)
    ref = jem.em_map(nu, pi0, pop.class_distributions, alpha, tau=1e-6,
                     active=active)
    # repro's own bar between its float32 engine and the float64 reference
    assert np.abs(pi_t.numpy() - ref.pi).max() < 1e-3


def test_em_torch_iteration_budget_is_repro_accounting():
    """Two updates a trip while it + 1 < max_iters, then the odd last one:
    an unconverged solve spends exactly ``max_iters`` in both."""
    _, pop = _pair(k=6, seed=8)
    nu = pop.class_counts.sum(0).astype(np.float64)
    alpha = tsampling.initialize_concentration(pop, 0.0)
    pi0 = np.full(6, 1 / 6)
    for max_iters in (1, 4, 7):
        _, it_j, _ = jem.em_map_jax(nu, pi0, pop.class_distributions, alpha,
                                    tau=0.0, max_iters=max_iters)
        counts = tem.PlanCounts()
        _, it_t, delta = tem.em_update_torch(
            torch.as_tensor(nu), torch.as_tensor(pi0),
            torch.as_tensor(pop.class_distributions), torch.as_tensor(alpha),
            torch.ones(6, dtype=torch.bool), 0.0, max_iters, counts=counts)
        assert it_t == int(it_j) == max_iters
        assert counts.em_trips == counts.syncs == (max_iters + 1) // 2


# ---------------------------------------------------------------------------
# the vectorized engine on the CPU
# ---------------------------------------------------------------------------

def _engine(method, pop, b, **kw):
    kw.setdefault("device", "cpu")
    if method == "ugs":
        return tplanner.ugs_plan_torch(pop, b, **kw)
    return tplanner.lds_plan_torch(pop, b, **kw)


@pytest.mark.parametrize("method", ["ugs", "lds"])
@pytest.mark.parametrize("zero", [(), (0, 4, 5)])
@pytest.mark.parametrize("b", [7, 64])
def test_engine_plans_are_valid_epochs(method, zero, b):
    """Rows sum to B (non-final), columns to the dataset sizes; clients
    without data are never drawn and carry π = 0."""
    _, pop = _pair(k=12, seed=3, zero=zero)
    plan = _engine(method, pop, b, seed=1, delta=1.5) if method == "lds" \
        else _engine(method, pop, b, seed=1)
    plan.validate_against(pop)
    sums = plan.local_batch_sizes.sum(1)
    assert np.all(sums[:-1] == b) and 0 < sums[-1] <= b
    np.testing.assert_array_equal(plan.local_batch_sizes.sum(0),
                                  pop.dataset_sizes)
    assert plan.local_batch_sizes.dtype == np.int32
    if method == "lds":
        assert plan.em_iterations >= 1
        assert len(plan.pi_history) == plan.num_steps + 1
        for pi in plan.pi_history[:1]:
            assert np.all(pi[list(zero)] == 0)
            assert abs(pi.sum() - 1) < 1e-5


@pytest.mark.parametrize("method,kw", [
    ("ugs", {}), ("lds", {"delta": 1.5}),
    ("lds", {"delta": 1.5, "reinit": True, "em_client_chunk": 5})])
def test_engine_dense_and_sparse_are_bit_identical(method, kw):
    _, pop = _pair(k=40, seed=2, zero=(7,))
    dense = _engine(method, pop, 24, seed=4, plan_format="dense", **kw)
    sparse = _engine(method, pop, 24, seed=4, plan_format="sparse", **kw)
    assert sparse.format == "sparse"
    sparse.validate_against(pop)
    for t in range(dense.num_steps):
        ids, cnts = sparse.step_segments(t)
        row = dense.local_batch_sizes[t]
        np.testing.assert_array_equal(ids, np.flatnonzero(row))
        np.testing.assert_array_equal(cnts, row[row > 0])
    assert dense.em_iterations == sparse.em_iterations
    for a, b in zip(dense.pi_history or [], sparse.pi_history or []):
        np.testing.assert_array_equal(a, b)


def test_engine_ugs_first_step_matches_sequential_and_jax():
    """First-step counts over many seeds: the port's engine against
    Algorithm 1's literal per-draw loop and repro's JAX engine
    (``tests/test_planner.py``'s harness and tolerances)."""
    jpop, tpop = _homogeneous(4, 40, seed=11)
    pi = tpop.dataset_sizes / tpop.total_size
    n, budget = 600, 30
    rows = {"torch": np.zeros((n, 4)), "seq": np.zeros((n, 4)),
            "jax": np.zeros((n, 4))}
    for t in range(n):
        rows["torch"][t] = _engine("ugs", tpop, budget,
                                   seed=10_000 + t).local_batch_sizes[0]
        rows["seq"][t], _ = jsampling._draw_step_counts_sequential(
            np.random.default_rng(5000 + t), budget, pi.copy(),
            jpop.dataset_sizes)
        rows["jax"][t] = jsampling.ugs_plan(
            jpop, budget, seed=10_000 + t, backend="jax").local_batch_sizes[0]
    for ref in ("seq", "jax"):
        assert np.allclose(rows["torch"].mean(0), rows[ref].mean(0),
                           atol=0.5), ref
        assert np.allclose(rows["torch"].std(0), rows[ref].std(0),
                           atol=0.5), ref


def test_engine_ugs_full_plan_mean_matches_numpy():
    """Whole-epoch expectation (the depletion dynamics, not just step 1):
    the mean plan agrees with the numpy backend's within 1.0 a cell (~6
    standard errors at 300 plans, as in ``tests/test_planner.py``)."""
    _, pop = _homogeneous(4, 30, seed=7)
    acc = {"numpy": 0.0, "torch": 0.0}
    for t in range(300):
        acc["numpy"] = acc["numpy"] + tsampling.ugs_plan(
            pop, 24, seed=3_000 + t).local_batch_sizes
        acc["torch"] = acc["torch"] + _engine(
            "ugs", pop, 24, seed=3_000 + t).local_batch_sizes
    assert np.abs(acc["numpy"] - acc["torch"]).max() / 300 < 1.0


def test_engine_lds_first_step_matches_numpy_and_jax():
    """LDS step-1 counts across seeds (Δ = 0): the port's engine agrees in
    mean and std with repro's numpy and JAX engines (atol 0.9, as
    ``tests/test_planner.py``)."""
    jpop, tpop = _homogeneous(6, 60, seed=13)
    n, b = 250, 32
    rows = {"torch": np.zeros((n, 6)), "numpy": np.zeros((n, 6)),
            "jax": np.zeros((n, 6))}
    for t in range(n):
        rows["torch"][t] = _engine("lds", tpop, b, delta=0.0,
                                   seed=7_000 + t).local_batch_sizes[0]
        rows["numpy"][t] = jsampling.lds_plan(
            jpop, b, delta=0.0, seed=7_000 + t).local_batch_sizes[0]
        rows["jax"][t] = jsampling.lds_plan(
            jpop, b, delta=0.0, seed=7_000 + t,
            backend="jax").local_batch_sizes[0]
    for ref in ("numpy", "jax"):
        assert np.allclose(rows["torch"].mean(0), rows[ref].mean(0),
                           atol=0.9), ref
        assert np.allclose(rows["torch"].std(0), rows[ref].std(0),
                           atol=0.9), ref


def test_engine_lds_delta0_pi_matches_sizes():
    _, pop = _pair(k=8, seed=13, stragglers=0)
    plan = _engine("lds", pop, 64, delta=0.0, seed=3)
    expect = pop.dataset_sizes / pop.total_size
    assert np.abs(plan.pi_history[0] - expect).max() < 0.05


@pytest.mark.parametrize("reinit", [False, True])
def test_engine_lds_straggler_depletion_order(reinit):
    """Higher Δ drains stragglers earlier (``tests/test_sampling.py``'s
    check, on the port's engine)."""
    _, pop = _homogeneous(8, 200, seed=17)
    pop.delays[:] = 0.0
    pop.delays[:2] = 500.0

    def depletion_step(plan, k):
        cum = plan.local_batch_sizes[:, k].cumsum()
        return int(np.argmax(cum >= pop.dataset_sizes[k]))

    p0 = _engine("lds", pop, 64, delta=0.0, seed=5, reinit=reinit)
    p2 = _engine("lds", pop, 64, delta=2.0, seed=5, reinit=reinit)
    d0 = np.mean([depletion_step(p0, k) for k in range(2)])
    d2 = np.mean([depletion_step(p2, k) for k in range(2)])
    assert d2 < d0


@pytest.mark.parametrize("record,length", [(None, "T+1"), (True, "T+1"),
                                           (False, 1)])
def test_engine_lds_pi_history(record, length):
    _, pop = _pair(k=10, seed=5)
    counts = tplanner.PlanCounts()
    plan = _engine("lds", pop, 32, delta=1.0, seed=2,
                   record_pi_history=record, counts=counts)
    want = plan.num_steps + 1 if length == "T+1" else length
    assert len(plan.pi_history) == want
    np.testing.assert_allclose(plan.pi_history[-1].sum(), 1.0, atol=1e-5)
    assert counts.rounds >= plan.num_steps
    assert counts.replans >= 1 and counts.em_trips >= counts.replans
    assert counts.syncs == counts.rounds + counts.em_trips + 1


def test_engine_ugs_counts_its_round_trips():
    _, pop = _pair(k=16, seed=1)
    counts = tplanner.PlanCounts()
    plan = _engine("ugs", pop, 40, seed=0, counts=counts)
    assert counts.rounds >= plan.num_steps and counts.refreshes >= 1
    assert counts.replans == counts.em_trips == 0
    assert counts.syncs == counts.rounds + counts.refreshes + 1


def test_resolve_backend_threshold():
    assert tplanner.AUTO_BACKEND_MIN_CLIENTS == 4096
    assert tplanner.resolve_backend("auto", 4095) == "numpy"
    assert tplanner.resolve_backend("auto", 4096) == "jax"
    assert tplanner.resolve_backend("AUTO", 10 ** 6) == "jax"
    assert tplanner.resolve_backend("numpy", 10 ** 6) == "numpy"
    assert tplanner.resolve_backend("jax", 2) == "jax"
    with pytest.raises(ValueError, match="unknown planner backend"):
        tplanner.resolve_backend("tpu", 8)
    with pytest.raises(ValueError, match="numpy-only"):
        tsampling.ugs_plan(_pair()[1], 8, sequential=True, backend="jax",
                           device="cpu")


def test_engine_runs_on_the_card_unless_asked(monkeypatch):
    """The vectorized engine's default device is the card: without CUDA
    it raises, with no CPU fallback; the numpy backend ignores it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pop = _pair()
    big = TPop(np.full(4096, 2), np.full((4096, 1), 2), np.zeros(4096))
    for call in (lambda: tsampling.make_plan("ugs", pop, 8, backend="jax"),
                 lambda: tsampling.make_plan("lds", pop, 8, backend="jax"),
                 lambda: tsampling.make_plan("ugs", big, 64, backend="auto"),
                 lambda: tem.em_map_torch(np.ones(2), np.ones(2) / 2,
                                          np.eye(2), np.ones(2))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    tsampling.make_plan("lds", pop, 8).validate_against(pop)
    tsampling.make_plan("ugs", big, 64, backend="auto",
                        device="cpu").validate_against(big)


def test_engine_refuses_totals_past_int32():
    pop = TPop(np.array([2 ** 31]), np.array([[2 ** 31]]), np.zeros(1))
    with pytest.raises(ValueError, match="2\\^31"):
        tplanner.ugs_plan_torch(pop, 8, device="cpu")


# ---------------------------------------------------------------------------
# api.run of PSL-LDS
# ---------------------------------------------------------------------------

def _lds_spec(backend):
    return japi.ExperimentSpec(
        data=japi.DataSpec(num_train=256, num_test=64,
                           straggler=japi.StragglerSpec()),
        sampler=japi.SamplerSpec(method="lds", backend=backend,
                                 kwargs={"delta": 1.5}),
        protocol=japi.ProtocolSpec(name="psl", epochs=1,
                                   global_batch_size=32, track_tpe=True),
        obs=japi.ObsSpec(enabled=True, monitor=True))


@pytest.fixture(scope="module")
def repro_init():
    model = JCNN(jget("paper-cnn", reduced=True))
    return jax.device_get(model.init(jax.random.PRNGKey(0)))


def _bridge(monkeypatch, jp):
    def fresh(ctx):
        params = requires_grad_(from_numpy_tree(jp, ctx.device))
        return TrainState(params, ctx.optimizer.init(params), 0)
    monkeypatch.setattr(tprotocols, "_fresh_state", fresh)


def test_run_psl_lds_matches_repro(monkeypatch, repro_init):
    """PSL-LDS on the reduced CNN through ``api.run`` (numpy backend, the
    spec written by repro): per-step losses at rtol 1e-4 as in
    ``tests/test_torch_protocols.py``; plan stats, TPE and the monitor's
    summary exactly repro's."""
    jspec = _lds_spec("numpy")
    jres = japi.run(jspec)
    _bridge(monkeypatch, repro_init)
    tres = tapi.run(tapi.ExperimentSpec.from_json(jspec.to_json()),
                    device="cpu")
    jl = [m["loss"] for m in jres.step_metrics]
    tl = [m["loss"] for m in tres.step_metrics]
    assert len(tl) == len(jl) > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tres.history.extras == jres.history.extras
    assert tres.history.extras["em_iterations"] > 0


def test_run_psl_lds_on_the_engine(monkeypatch, repro_init):
    """The same run with ``backend="jax"``: the port plans on the run's
    device (the CPU here) through the vectorized engine."""
    _bridge(monkeypatch, repro_init)
    spec = tapi.ExperimentSpec.from_json(_lds_spec("jax").to_json())
    res = tapi.run(spec, device="cpu")
    extras = res.history.extras
    assert len(res.step_metrics) == -(-256 // 32)
    assert extras["em_iterations"] > 0
    assert extras["gpsl_monitor"][0]["steps"] == len(res.step_metrics)
    assert np.isfinite([m["loss"] for m in res.step_metrics]).all()
