"""Sliding-window serving against repro, on the CPU.

Reduced granite-3-2b and reduced granite-moe-3b-a800m with
``sliding_window`` 8 and 16, served through ``continuous``: prompts of 5,
13 and 21 tokens (shorter than, straddling and longer than the window)
and up to 20 new tokens, so each prefill fills a ring cache of the window's
length through ``_to_ring`` (wrapped when the prompt is longer) and every
decode step writes slot ``pos % window``. The port gets repro's
parameters through the weights bridge; the served tokens, step and token
counts and the KV accounting must equal repro's exactly.
"""
import jax
import pytest

import repro.api as japi
from repro_torch import api as tapi
from repro_torch.checkpoint import from_numpy_tree
from torch_one_thread import one_torch_thread  # noqa: F401


def _spec(pkg, arch, window):
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch=arch, reduced=True,
                            overrides={"sliding_window": window}),
        engine=pkg.EngineSpec(name="continuous", num_slots=4, slot_len=41),
        admission=pkg.AdmissionSpec(token_budget=4),
        workload=pkg.WorkloadSpec(num_requests=6, prompt_lens=[5, 13, 21],
                                  max_new_tokens=[12, 20]),
        clock=pkg.ClockSpec(kind="virtual"))


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report.per_request}


@pytest.mark.parametrize("window", [8, 16])
@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-3b-a800m"])
def test_sliding_window_serving_matches_repro(arch, window):
    jspec, tspec = _spec(japi, arch, window), _spec(tapi, arch, window)
    assert jspec.to_dict() == tspec.to_dict()
    jctx = japi.build_serve_context(jspec)
    jrep = japi.run_serve(jspec, ctx=jctx)
    tctx = tapi.build_serve_context(
        tspec, params=from_numpy_tree(jax.device_get(jctx.params), "cpu"),
        device="cpu")
    assert tctx.model.cfg.sliding_window == window
    ring = tctx.engine.pool.buffers["client"]["k"]
    assert ring.shape[2] == window                 # (L, slots, C, Hc, hd)
    trep = tapi.run_serve(tspec, ctx=tctx)
    got = _tokens(trep)
    assert got == _tokens(jrep)
    assert max(len(t) for t in got.values()) == 20
    for field in ("steps", "decode_tokens", "prefill_tokens", "max_active"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.cache_utilization == jrep.cache_utilization
