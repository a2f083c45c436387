"""The port's serving runtime against repro's on the same ServeSpec.

Both packages build the same seeded workload from one spec; the port gets
repro's initial parameters through the weights bridge and serves on the
CPU. Per-request tokens, step counts, token counts and KV-cache byte
accounting must equal repro's exactly (greedy decoding, float32 reduced
granite, VirtualClock).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

import repro.api as japi
from repro_torch import api as tapi
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.launch import serve as serve_cli
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


def _spec(pkg, engine="paged", policy="fifo", cache=None, **wl):
    workload = dict(num_requests=6, prompt_lens=[5, 9, 17],
                    max_new_tokens=[4, 9])
    workload.update(wl)
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch="granite-3-2b", reduced=True),
        engine=pkg.EngineSpec(name=engine, num_slots=4, slot_len=32),
        admission=pkg.AdmissionSpec(token_budget=4),
        scheduler=pkg.SchedulerSpec(policy=policy),
        workload=pkg.WorkloadSpec(**workload),
        clock=pkg.ClockSpec(kind="virtual"),
        cache=pkg.CacheSpec(**(cache or {"page_size": 8})))


@pytest.fixture(scope="module")
def jax_params():
    ctx = japi.build_serve_context(_spec(japi))
    return ctx.params


def _serve_both(jax_params, **kw):
    jspec, tspec = _spec(japi, **kw), _spec(tapi, **kw)
    assert jspec.to_dict() == tspec.to_dict()      # one JSON, both packages
    jctx = japi.build_serve_context(jspec, params=jax_params)
    jrep = japi.run_serve(jspec, ctx=jctx)
    tctx = tapi.build_serve_context(
        tspec, params=from_numpy_tree(jax.device_get(jax_params), "cpu"),
        device="cpu")
    trep = tapi.run_serve(tspec, ctx=tctx)
    return jrep, trep, tctx


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report.per_request}


@pytest.mark.parametrize("engine", ["continuous", "paged"])
@pytest.mark.parametrize("policy", ["fifo", "ljf"])
def test_run_serve_matches_repro(jax_params, engine, policy):
    jrep, trep, tctx = _serve_both(jax_params, engine=engine, policy=policy)
    assert trep.engine == jrep.engine == engine
    assert _tokens(trep) == _tokens(jrep)
    for field in ("steps", "decode_tokens", "prefill_tokens", "max_active",
                  "step_active", "num_requests", "preemptions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.cache_utilization == jrep.cache_utilization
    tctx.engine.pool.check_no_leaks()


def test_eviction_stays_token_identical(jax_params):
    """A page pool too small for the steady state forces engine-level
    evictions; the port resumes victims exactly as repro does."""
    cache = {"page_size": 4, "num_pages": 9}
    jrep, trep, tctx = _serve_both(jax_params, cache=cache,
                                   max_new_tokens=[9, 14])
    assert trep.preemptions == jrep.preemptions > 0
    assert _tokens(trep) == _tokens(jrep)
    assert trep.cache_utilization == jrep.cache_utilization
    tctx.engine.pool.check_no_leaks()
    _, cont, _ = _serve_both(jax_params, engine="continuous",
                             max_new_tokens=[9, 14])
    assert _tokens(cont) == _tokens(trep)


def test_verify_report_inside_the_port():
    spec = _spec(tapi).replace(report=tapi.ReportSpec(verify=-1))
    report = tapi.run_serve(spec, device="cpu")
    assert report.verified == {"checked": 6, "mismatches": []}


def test_importing_the_port_pulls_in_no_jax_and_no_repro():
    """Every module of repro_torch imports with jax and repro absent."""
    code = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
want = {"repro_torch.core.psl", "repro_torch.core.sampling",
        "repro_torch.optim.optimizers", "repro_torch.data.federated",
        "repro_torch.kernels.cross_entropy", "repro_torch.api.loop",
        "repro_torch.api.protocols", "repro_torch.launch.train",
        "repro_torch.launch.distributed", "repro_torch.runtime.spec_decode",
        "repro_torch.kernels.spec_verify", "repro_torch.kernels.ssm_scan",
        "repro_torch.configs.falcon_mamba_7b", "repro_torch.models.cnn",
        "repro_torch.configs.paper_cnn", "repro_torch.core.partition",
        "repro_torch.core.straggler", "repro_torch.core.deviation",
        "repro_torch.obs.monitor", "repro_torch.api.evaluation",
        "repro_torch.sharding", "repro_torch.launch.mesh",
        "repro_torch.frameworks.trainers",
        "repro_torch.launch.tensor_parallel"}
assert want <= set(mods), sorted(want - set(mods))
print(len(mods), bad)
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 40 and bad.strip() == "[]"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    spec = _spec(tapi)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.run_serve(spec)
    from repro_torch.runtime import (ContinuousEngine, PagedEngine,
                                     SpeculativeEngine)
    cfg = tapi.build_model(spec.model).cfg
    for cls in (ContinuousEngine, PagedEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(cfg, num_slots=2, slot_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeculativeEngine(cfg, num_slots=2, slot_len=16,
                          draft=tapi.DraftSpec(num_layers=1))
    ssm = tapi.build_model(tapi.ModelSpec(arch="falcon-mamba-7b")).cfg
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(ssm, num_slots=2, slot_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--requests", "2"])


def test_serve_cli_on_cpu_and_unported_flags(tmp_path, capsys):
    cfg = tmp_path / "serve.json"
    cfg.write_text(_spec(japi).to_json())        # written by repro
    serve_cli.main(["--config", str(cfg), "--device", "cpu", "--verify",
                    "-1"])
    out = capsys.readouterr().out
    assert "[paged] 6 requests" in out
    assert "verified token-identical: 6 requests" in out
    serve_cli.main(["--config", str(cfg), "--device", "cpu", "--static"])
    assert "[static] 6 requests" in capsys.readouterr().out
    # sampled decoding is ported: the flags map onto spec.sampling as in
    # repro, and static and verify still refuse it with repro's messages
    sets = ["--sample", "--temperature", "0.9", "--top-k", "50", "--top-p",
            "0.95"]
    serve_cli.main(sets + ["--print-spec"])
    assert json.loads(capsys.readouterr().out)["sampling"] == {
        "method": "sample", "temperature": 0.9, "top_k": 50, "top_p": 0.95,
        "seed": 0}
    serve_cli.main(["--config", str(cfg), "--device", "cpu"] + sets)
    assert "[paged] 6 requests" in capsys.readouterr().out
    for flags, msg in ((["--static"], "decodes greedily only"),
                       (["--verify", "-1"], "sampling.method must be")):
        with pytest.raises(tapi.SpecError, match=msg):
            serve_cli.main(["--config", str(cfg), "--device", "cpu"]
                           + sets + flags)


def test_unported_spec_values_fail_clearly(tmp_path):
    spec = _spec(tapi)
    spec.replace(model=tapi.ModelSpec(arch="whisper-tiny")).validate()
    spec.replace(engine=tapi.EngineSpec(name="static")).validate()
    with pytest.raises(tapi.SpecError, match="not ported"):
        spec.replace(model=tapi.ModelSpec(arch="no-such-arch")).validate()
    with pytest.raises(tapi.SpecError, match="unknown engine"):
        spec.replace(engine=tapi.EngineSpec(name="no-such-engine")).validate()
    # sampled decoding and the profiler hook are ported: a sampled serve
    # runs, and a profiled one writes one Chrome trace and the same tokens
    sampled = tapi.run_serve(spec.replace(
        sampling=tapi.SamplingSpec(method="sample")), device="cpu")
    plain = tapi.run_serve(spec, device="cpu")
    assert sampled.per_request != plain.per_request
    profiled = tapi.run_serve(spec.replace(obs=tapi.ObsSpec(
        enabled=True, jax_profiler_dir=str(tmp_path / "prof"))),
        device="cpu")
    assert [r["tokens"] for r in profiled.per_request] == \
        [r["tokens"] for r in plain.per_request]
    assert profiled.steps == plain.steps
    traces = list((tmp_path / "prof").glob("*.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    train = tmp_path / "train.json"
    train.write_text(json.dumps({"kind": "experiment"}))
    default = tapi.load_any_spec(str(train))
    default.validate()          # the default arch, the paper's CNN, is ported
    lds = tapi.run(default.replace(
        sampler=tapi.SamplerSpec(method="lds", kwargs={"delta": 1.5}),
        protocol=default.protocol.replace(epochs=1)), device="cpu")
    assert lds.step_metrics and lds.history.extras["em_iterations"] > 0


def test_restore_params_runs_on_the_card_unless_asked(tmp_path, jax_params,
                                                      monkeypatch):
    """An entry point: the default device is the card, so without CUDA it
    raises; an explicit ``device="cpu"`` loads there."""
    from repro.checkpoint import save
    from repro_torch.models.layers import tree_leaves
    path = str(tmp_path / "params.npz")
    save(path, jax_params)
    model = tapi.build_model(_spec(tapi).model, seq_len=32)
    params = tapi.restore_params(model, path, device="cpu")
    assert {p.device.type for p in tree_leaves(params)} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tapi.restore_params(model, path)


def test_restore_params_from_a_repro_checkpoint(tmp_path, jax_params):
    from repro.checkpoint import save
    path = str(tmp_path / "params.npz")
    save(path, jax_params)
    spec = _spec(tapi).replace(checkpoint=path)
    report = tapi.run_serve(spec, device="cpu")
    _, trep, _ = _serve_both(jax_params)
    assert _tokens(report) == _tokens(trep)
    bad = _spec(tapi).replace(
        model=tapi.ModelSpec(arch="granite-3-2b", reduced=True,
                             overrides={"d_ff": 256}), checkpoint=path)
    with pytest.raises(tapi.SpecError, match="leaf shape"):
        tapi.build_serve_context(bad, device="cpu")
