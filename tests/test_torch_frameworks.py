"""The port's deprecated entry points against ``repro_torch.api.run``, on
the CPU, as ``tests/test_api.py`` pins ``repro``'s: the six
``repro_torch.frameworks`` shims and ``launch.train.PSLTrainer`` give the
trajectory ``api.run`` gives for the same spec, bit for bit, and each
shim warns that it is deprecated."""
import numpy as np
import pytest
import torch

import repro_torch.api as tapi
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import sampling
from repro_torch.core.partition import partition_dirichlet
from repro_torch.data.federated import ClientStore
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.launch.train import PSLTrainer, default_lm_spec
from repro_torch.models.cnn import CNNModel
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread for this module: its runs are tiny, and
    next to the other test workers more threads only contend (a shim
    took ~50 s under the parallel suite, 0.4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def federation():
    X, y = make_classification_dataset(300, image_size=16, seed=0)
    test = make_classification_dataset(80, image_size=16, seed=99)
    parts, pop = partition_dirichlet(y, 4, 10, seed=1)
    return X, y, test, ClientStore.from_partition(X, y, parts, pop)


def _spec(protocol, engine="fused"):
    return tapi.ExperimentSpec(
        seed=0,
        model=tapi.ModelSpec(arch="paper-cnn", reduced=True),
        optimizer=tapi.OptimizerSpec(name="sgd", lr=5e-2, momentum=0.9,
                                     weight_decay=0.0),
        data=tapi.DataSpec(num_train=300, num_test=80, image_size=16,
                           num_clients=4),
        protocol=tapi.ProtocolSpec(name=protocol, epochs=1, batch_size=16,
                                   global_batch_size=32),
        execution=tapi.ExecutionSpec(engine=engine))


@pytest.mark.parametrize("name", ["cl", "sl", "fl", "sfl", "psl",
                                  "psl_sharded"])
def test_shim_warns_deprecation_and_matches_api_run(federation, name):
    from repro_torch import frameworks as fw
    X, y, test, store = federation
    model = CNNModel(get_config("paper-cnn", reduced=True))
    opt = optim.sgd(5e-2, momentum=0.9)
    calls = {
        "cl": lambda: fw.train_cl(model, opt, X, y, test, epochs=1,
                                  batch_size=16, seed=0, device="cpu"),
        "sl": lambda: fw.train_sl(model, opt, store, test, epochs=1,
                                  batch_size=16, seed=0, device="cpu"),
        "fl": lambda: fw.train_fl(model, opt, store, test, epochs=1,
                                  batch_size=16, seed=0, device="cpu"),
        "sfl": lambda: fw.train_sfl(model, opt, store, test, epochs=1,
                                    batch_size=16, seed=0, device="cpu"),
        "psl": lambda: fw.train_psl(model, opt, store, test, epochs=1,
                                    global_batch_size=32, seed=0,
                                    device="cpu"),
        "psl_sharded": lambda: fw.train_psl_sharded(
            model, opt, store, test, epochs=1, global_batch_size=32,
            seed=0, device="cpu"),
    }
    with pytest.warns(DeprecationWarning, match="deprecated"):
        hist = calls[name]()
    protocol = "psl" if name.startswith("psl") else name
    engine = "sharded" if name == "psl_sharded" else "fused"
    got = tapi.run(_spec(protocol, engine), device="cpu")
    assert len(hist.test_acc) == 1 and np.isfinite(hist.test_acc[0])
    assert hist.test_acc == got.test_acc                   # bitwise
    assert set(hist.extras) == set(got.history.extras)
    if name == "psl_sharded":
        assert hist.extras["sharding_fallbacks"] == []


def test_psl_trainer_matches_api_run():
    """The deprecated epoch trainer, on the one-card engine, steps exactly
    as the psl strategy of ``api.run`` does on the same LM spec."""
    spec = tapi.apply_overrides(default_lm_spec(), [
        "model.reduced=true", "execution.max_steps=3",
        "protocol.global_batch_size=8", "data.seq_len=32",
        "data.sequences=256", "sampler.plan_format=sparse"])
    want = tapi.run(spec, device="cpu").step_metrics
    ctx = tapi.build_context(spec, device="cpu")
    trainer = PSLTrainer(ctx.model.cfg,
                         optimizer=tapi.build_optimizer(spec.optimizer),
                         device="cpu")
    assert trainer.mesh is None and trainer.report.fallbacks == []
    plan = sampling.make_plan(spec.sampler.method, ctx.data.pop,
                              spec.protocol.global_batch_size,
                              seed=spec.seed,
                              plan_format=spec.sampler.plan_format)
    _, got = trainer.train_epoch(trainer.init_state(spec.seed),
                                 ctx.data.lm_data, ctx.data.pop, plan,
                                 spec.data.seq_len, seed=spec.seed,
                                 max_steps=3)
    # grad_norm's last bits vary from run to run on the CPU (as
    # tests/test_torch_train.py notes); the rest is bitwise
    assert [sorted(m) for m in got] == [sorted(m) for m in want]
    for g, w in zip(got, want, strict=True):
        assert {k: v for k, v in g.items() if k != "grad_norm"} == \
            {k: v for k, v in w.items() if k != "grad_norm"}
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-6)
