"""The port's static-batch engine (``BatchedServer``, registered
``"static"``) against repro's on the same ServeSpec, on the CPU.

Both packages build the same seeded workload from one spec; the port gets
repro's parameters through the weights bridge. On reduced granite-3-2b
(repro's init) and reduced whisper-tiny (repro's init at fan-in d_in,
``test_torch_audio.audio_params``) with mixed, left-padded prompt lengths,
the served tokens and the report's fields (steps, padded prefill tokens,
decode tokens, the shared TTFT flag, the KV accounting) must equal
repro's exactly. Within the port, ``static`` equals ``continuous`` at
equal prompt lengths (no padding), as repro's own test holds its engines.
"""
import jax
import pytest

import repro.api as japi
from repro_torch import api as tapi
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.launch import serve as serve_cli
from test_torch_audio import audio_params
from torch_one_thread import one_torch_thread  # noqa: F401

REPORT_FIELDS = ("engine", "steps", "prefill_tokens", "decode_tokens",
                 "num_requests", "max_active", "step_active",
                 "token_budget", "ttft_shared", "preemptions")


def _spec(pkg, arch="granite-3-2b", engine="static", **wl):
    workload = dict(num_requests=6, prompt_lens=[5, 9, 17],
                    max_new_tokens=[4, 9])
    workload.update(wl)
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch=arch, reduced=True),
        engine=pkg.EngineSpec(name=engine, num_slots=4, slot_len=32),
        admission=pkg.AdmissionSpec(token_budget=4),
        workload=pkg.WorkloadSpec(**workload),
        clock=pkg.ClockSpec(kind="virtual"))


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report.per_request}


@pytest.fixture(scope="module", params=["granite-3-2b", "whisper-tiny"])
def served(request):
    """(arch, repro's report, the port's report, the port's context) of
    one static serve of the mixed-length workload."""
    arch = request.param
    jspec, tspec = _spec(japi, arch), _spec(tapi, arch)
    assert jspec.to_dict() == tspec.to_dict()      # one JSON, both packages
    params = None
    if arch == "whisper-tiny":
        params = audio_params(japi.build_model(jspec.model, seq_len=32))
    jctx = japi.build_serve_context(jspec, params=params)
    jrep = japi.run_serve(jspec, ctx=jctx)
    tctx = tapi.build_serve_context(
        tspec, params=from_numpy_tree(jax.device_get(jctx.params), "cpu"),
        device="cpu")
    trep = tapi.run_serve(tspec, ctx=tctx)
    return arch, jrep, trep, tctx


def test_static_tokens_match_repro(served):
    arch, jrep, trep, tctx = served
    assert type(tctx.engine).__name__ == "BatchedServer"
    assert tctx.model.cfg.family == ("audio" if arch == "whisper-tiny"
                                     else "dense")
    got = _tokens(trep)
    assert got == _tokens(jrep)
    assert sorted(len(t) for t in got.values()) == sorted(
        r["new_tokens"] for r in jrep.per_request)


def test_static_report_fields_match_repro(served):
    _, jrep, trep, _ = served
    for field in REPORT_FIELDS:
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.ttft_shared is True
    assert trep.prefill_tokens == 6 * 17            # padded: max x batch
    assert trep.decode_tokens == 6 * 8 and trep.steps == 8
    assert trep.cache_utilization == jrep.cache_utilization
    rows = {r["rid"]: r for r in trep.per_request}
    assert [rows[r["rid"]]["prompt_len"] for r in jrep.per_request] == \
        [r["prompt_len"] for r in jrep.per_request]
    assert len({r["ttft_ms"] for r in trep.per_request}) == 1  # shared


def test_static_audio_cache_holds_the_encoder_states(served):
    """The static KV bytes count every cache leaf: for whisper the
    decoder's self-attention rings and the encoder states."""
    arch, _, trep, tctx = served
    cfg = tctx.model.cfg
    util = trep.cache_utilization
    b, c = 6, 17 + 9
    kv = 2 * cfg.num_layers * b * c * tctx.model.blocks.kv_cache_heads() \
        * cfg.head_dim * 4
    enc = b * cfg.encoder_seq * cfg.d_model * 4 if arch == "whisper-tiny" \
        else 0
    assert util["capacity_bytes"] == util["peak_in_use_bytes"] == kv + enc
    assert util["allocated_tokens"] == b * c


def test_static_equals_continuous_on_equal_lengths():
    """Same-length prompts involve no padding, so the two registered
    engines emit identical tokens for the same seeded workload."""
    wl = dict(num_requests=3, prompt_lens=[7], max_new_tokens=[4], seed=9)
    cont_spec = _spec(tapi, engine="continuous", **wl)
    ctx = tapi.build_serve_context(cont_spec, device="cpu")
    cont = tapi.run_serve(cont_spec, ctx=ctx)
    static_spec = _spec(tapi, **wl)
    sctx = tapi.build_serve_context(static_spec, params=ctx.params,
                                    device="cpu")
    static = tapi.run_serve(static_spec, ctx=sctx)
    assert static.engine == "static"
    assert static.steps == 3                       # max_new - 1
    assert static.decode_tokens == 3 * 3           # every row rides along
    assert _tokens(static) == _tokens(cont)


def test_serve_cli_static_on_cpu(capsys):
    for arch in ("granite-3-2b", "whisper-tiny"):
        serve_cli.main(["--device", "cpu", "--static", "--arch", arch,
                        "--requests", "3", "--max-new", "4"])
        out = capsys.readouterr().out
        assert f"arch={arch}-reduced [static] 3 requests" in out, out
    assert serve_cli.BatchedServer is tapi.get_engine("static")
    assert serve_cli.Request.__name__ == "Request"


@pytest.mark.parametrize("change,message", [
    ("report", "verify requires the continuous engine"),
    ("arrivals", "cannot honor arrival traces"),
    ("arrival", "cannot honor arrival traces"),
    ("tenants", "no per-request admission"),
    ("sampling", "the static engine decodes greedily only"),
])
def test_static_spec_refusals(change, message):
    """The static engine's spec checks refuse, with repro's messages, what
    it cannot honor."""
    for pkg, err in ((japi, japi.SpecError), (tapi, tapi.SpecError)):
        spec = _spec(pkg)
        spec.validate()
        if change == "report":
            bad = spec.replace(report=pkg.ReportSpec(verify=-1))
        elif change == "arrivals":
            bad = spec.replace(workload=spec.workload.replace(
                arrivals=pkg.StragglerSpec()))
        elif change == "arrival":
            bad = spec.replace(workload=spec.workload.replace(
                arrival=pkg.ArrivalSpec()))
        elif change == "tenants":
            bad = spec.replace(admission=spec.admission.replace(
                tenants=[pkg.TenantSpec(name="a")]))
        else:
            bad = spec.replace(sampling=pkg.SamplingSpec(method="sample"))
        with pytest.raises(err, match=message):
            bad.validate()


def test_static_default_device_raises_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    from repro_torch.runtime import BatchedServer
    cfg = tapi.build_model(tapi.ModelSpec(arch="whisper-tiny")).cfg
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedServer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.run_serve(_spec(tapi, "whisper-tiny"))
