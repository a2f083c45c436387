"""``repro_torch.api.run`` against ``repro.api.run`` on the CPU, protocol
by protocol, on the reduced paper CNN (the default ExperimentSpec's
model) with 256 training images, one epoch, stragglers and the GPSL
monitor on.

Both runs start from ``repro``'s initial parameters: the port builds
every protocol's initial state in one function,
``repro_torch.api.protocols._fresh_state``, and the tests bridge
``repro``'s ``model.init(PRNGKey(seed))`` through it (the two packages'
init draws differ). Data, partitions, plans, batches, TPE and monitor
records are numpy on both sides and must be equal. Tolerances, float32:
- per-step losses: rtol 1e-4 (SGD trajectories from equal inputs; one
  reduction order against another, compounding over up to 26 steps);
- ``test_acc``: within one test sample;
- FL's and SFL's parameters after the round: atol/rtol 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import get_config as jget
from repro.models.cnn import CNNModel as JCNN
import repro_torch.api as tapi
from repro_torch.api import protocols as tprotocols
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core.psl import requires_grad_
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import TrainState
from torch_one_thread import one_torch_thread  # noqa: F401

NUM_TEST = 64

CASES = {
    "psl-ugs-fused": ("psl", "ugs", "fused"),
    "psl-fpls-fused": ("psl", "fpls", "fused"),
    "psl-fls-fused": ("psl", "fls", "fused"),
    "psl-ugs-sharded": ("psl", "ugs", "sharded"),
    "psl-fpls-sharded": ("psl", "fpls", "sharded"),
    "psl-fls-sharded": ("psl", "fls", "sharded"),
    "cl": ("cl", "ugs", "fused"),
    "sl": ("sl", "ugs", "fused"),
    "fl": ("fl", "ugs", "fused"),
    "sfl": ("sfl", "ugs", "fused"),
}


def _spec(name, method, engine):
    return japi.ExperimentSpec(
        data=japi.DataSpec(num_train=256, num_test=NUM_TEST,
                           straggler=japi.StragglerSpec()),
        sampler=japi.SamplerSpec(method=method),
        protocol=japi.ProtocolSpec(name=name, epochs=1,
                                   global_batch_size=32, batch_size=16,
                                   track_tpe=True),
        execution=japi.ExecutionSpec(engine=engine),
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


def _pair(case, monkeypatch, jp):
    jspec = _spec(*CASES[case])
    jres = japi.run(jspec)
    _bridge(monkeypatch, jp)
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    return jres, tapi.run(tspec, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_run_matches_repro(case, monkeypatch, repro_init):
    jres, tres = _pair(case, monkeypatch, repro_init)
    jl = [m["loss"] for m in jres.step_metrics]
    tl = [m["loss"] for m in tres.step_metrics]
    assert len(tl) == len(jl) > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert sorted(tres.step_metrics[0]) == sorted(jres.step_metrics[0])
    assert [m["tokens"] for m in tres.step_metrics] == \
        [m["tokens"] for m in jres.step_metrics]
    assert len(tres.test_acc) == len(jres.test_acc) == 1
    assert abs(tres.test_acc[0] - jres.test_acc[0]) <= 1 / NUM_TEST + 1e-12
    # plan stats, TPE, shard skew and monitor summaries: exactly repro's
    assert tres.history.extras == jres.history.extras
    if CASES[case][0] == "psl":
        assert "tpe_ms" in tres.history.extras
        assert tres.history.extras["gpsl_monitor"][0]["steps"] == len(tl)
        if CASES[case][2] == "sharded":
            assert len(tres.history.extras["shard_skew_ms"]) == len(tl)
    if CASES[case][0] in ("fl", "sfl"):
        for a, b in zip(tree_leaves(tres.params),
                        jax.tree_util.tree_leaves(jres.params)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-4, rtol=1e-4)


def _strategy_on_cpu(name, monkeypatch, jp):
    _bridge(monkeypatch, jp)
    spec = tapi.ExperimentSpec.from_json(_spec(name, "ugs",
                                               "fused").to_json())
    ctx = tapi.build_context(spec, device="cpu")
    strategy = tapi.get_protocol(name)()
    return ctx, strategy, strategy.setup(ctx)


def _snapshot(tree):
    return [p.detach().clone() for p in tree_leaves(tree)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_fl_trains_clones_of_the_global_params(monkeypatch, repro_init):
    """The port's optimizers update in place: FL's local models must be
    clones, so the round's global parameters stay as they were until
    end_epoch averages the local models."""
    ctx, fl, pstate = _strategy_on_cpu("fl", monkeypatch, repro_init)
    before = _snapshot(pstate["global_params"])
    clients = set()
    for item in fl.epoch_batches(ctx, pstate, None, 0):
        pstate, _ = fl.step(ctx, pstate, item)
        clients.add(item.scope)
        assert _same(before, tree_leaves(pstate["global_params"]))
    assert len(clients) > 1
    assert len(pstate["locals"]) == len(clients) - 1
    pstate = fl.end_epoch(ctx, pstate, 0)
    assert not _same(before, tree_leaves(pstate["global_params"]))
    assert all(p.requires_grad for p in
               tree_leaves(pstate["global_params"]))


def test_sfl_clients_start_from_the_rounds_client_segment(monkeypatch,
                                                          repro_init):
    """Each SFL client trains a clone of the round's client segment, while
    the server segment is carried from client to client."""
    ctx, sfl, pstate = _strategy_on_cpu("sfl", monkeypatch, repro_init)
    before = _snapshot(pstate["params"]["client"])
    last, server = None, None
    for item in sfl.epoch_batches(ctx, pstate, None, 0):
        pstate, _ = sfl.step(ctx, pstate, item)
        assert _same(before, tree_leaves(pstate["params"]["client"]))
        if item.scope != last and server is not None:
            # a new client: the server segment it trains is the last one's
            assert pstate["st"].params["server"] is server
        last, server = item.scope, pstate["st"].params["server"]
    pstate = sfl.end_epoch(ctx, pstate, 0)
    assert pstate["params"]["server"] is server
    assert not _same(before, tree_leaves(pstate["params"]["client"]))


def test_repros_default_spec_runs_on_the_cpu():
    """``ExperimentSpec()`` is the paper's setup at the reduced size
    (paper-cnn, PSL-UGS, extended-Dirichlet split, SGD, 6 epochs)."""
    res = tapi.run(tapi.ExperimentSpec(), device="cpu")
    assert len(res.test_acc) == 6
    assert all(np.isfinite(m["loss"]) for m in res.step_metrics)
    assert res.history.extras["tpe_ms"] == []      # track_tpe off
    assert res.history.extras["em_iterations"] == 0
    assert max(res.test_acc) > 0.3
