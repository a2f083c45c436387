"""Speculative serving with an MoE target against repro's, on the CPU.

Reduced granite-moe-3b-a800m on bridged parameters, a draft of the
target's first layer, gamma 4, 8 requests, greedy and repro's sampled
setting (temperature 0.9, top-k 50, seed 7). At capacity factor 8.0
nothing is dropped; at the config's 1.25 a verify step routes every
window lane of every slot together, so capacity couples the slots and
the speculative tokens need not equal the paged engine's (in repro as in
the port). So the port's speculative engine is held to repro's
speculative engine: tokens, steps and the speculation counters.
"""
import jax
import pytest

import repro.api as japi
from repro_torch import api as tapi
from repro_torch.checkpoint import from_numpy_tree
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "granite-moe-3b-a800m"


def _spec(pkg, factor, sampled):
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch=ARCH, reduced=True,
                            overrides={"moe_capacity_factor": factor}),
        engine=pkg.EngineSpec(name="speculative", num_slots=4, slot_len=48),
        admission=pkg.AdmissionSpec(token_budget=4),
        workload=pkg.WorkloadSpec(num_requests=8, prompt_lens=[5, 9, 17],
                                  max_new_tokens=[4, 8]),
        clock=pkg.ClockSpec(kind="virtual"),
        cache=pkg.CacheSpec(page_size=8),
        sampling=(pkg.SamplingSpec(method="sample", temperature=0.9,
                                   top_k=50, seed=7)
                  if sampled else pkg.SamplingSpec()),
        draft=pkg.DraftSpec(num_layers=1, gamma=4))


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report.per_request}


@pytest.fixture(scope="module")
def jax_params():
    return japi.build_serve_context(_spec(japi, 8.0, False)).params


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_moe_speculative_matches_repro(jax_params, factor, sampled):
    jspec, tspec = (_spec(p, factor, sampled) for p in (japi, tapi))
    assert jspec.to_dict() == tspec.to_dict()
    jctx = japi.build_serve_context(jspec, params=jax_params)
    assert jctx.model.cfg.moe_capacity_factor == factor
    jrep = japi.run_serve(jspec, ctx=jctx)
    tctx = tapi.build_serve_context(
        tspec, params=from_numpy_tree(jax.device_get(jax_params), "cpu"),
        device="cpu")
    assert tctx.model.cfg.is_moe
    trep = tapi.run_serve(tspec, ctx=tctx)
    assert _tokens(trep) == _tokens(jrep)
    for field in ("steps", "decode_tokens", "prefill_tokens", "max_active",
                  "step_active", "preemptions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.speculation == jrep.speculation
    assert trep.speculation["windows"] > 0
    assert trep.cache_utilization == jrep.cache_utilization
    tctx.engine.pool.check_no_leaks()
    assert tctx.engine.pool.pages_in_use == 0
