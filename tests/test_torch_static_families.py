"""The port's ``static`` engine over the MoE, VLM, SSM and hybrid families
against repro's, on the CPU.

repro's static engine serves every family (``repro.runtime.static``):
one left-padded batch, zero patches for a VLM. On bridged parameters of
reduced granite-moe-3b-a800m (at its config's capacity factor: pad rows
take expert capacity in both packages alike), internvl2-2b,
falcon-mamba-7b (2 layers each) and zamba2-2.7b (5, its reduced depth,
and 2: no superblock), the served tokens and the report's
fields must equal repro's exactly.

A VLM's static cache is sized at prompt + new tokens while its prefill
also runs the patches, so the ring keeps only the last positions: at full
width 240 of internvl2's 256 patches are gone before the first decode
step. Both packages must drop the same positions.
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch import api as tapi
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from test_torch_archs import fan_in_params
from torch_one_thread import one_torch_thread  # noqa: F401

# (arch, depth override): zamba2 at 2 layers is too shallow for a
# superblock, so its shared-attention and superblock caches are empty
# stacks (the port's prefill failed on them; repro serves them)
ARCHS = [("granite-moe-3b-a800m", None), ("internvl2-2b", None),
         ("falcon-mamba-7b", None), ("zamba2-2.7b", None),
         ("zamba2-2.7b", 2)]
REPORT_FIELDS = ("engine", "steps", "prefill_tokens", "decode_tokens",
                 "num_requests", "max_active", "step_active",
                 "token_budget", "ttft_shared", "preemptions")
CACHE_ATOL = 1e-4


def _spec(pkg, arch, layers=None):
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch=arch, reduced=True, overrides=(
            {"num_layers": layers} if layers else {})),
        engine=pkg.EngineSpec(name="static", num_slots=4, slot_len=32),
        admission=pkg.AdmissionSpec(token_budget=4),
        workload=pkg.WorkloadSpec(num_requests=5, prompt_lens=[5, 9, 17],
                                  max_new_tokens=[4, 8]),
        clock=pkg.ClockSpec(kind="virtual"))


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report.per_request}


@pytest.fixture(scope="module", params=ARCHS,
                ids=lambda a: a[0] + (f"-{a[1]}layers" if a[1] else ""))
def served(request):
    """(arch, repro's context and report, the port's context and report)
    of one static serve of the mixed-length workload."""
    arch, layers = request.param
    jspec, tspec = _spec(japi, arch, layers), _spec(tapi, arch, layers)
    assert jspec.to_dict() == tspec.to_dict()
    jctx = japi.build_serve_context(jspec)
    jrep = japi.run_serve(jspec, ctx=jctx)
    tctx = tapi.build_serve_context(
        tspec, params=from_numpy_tree(jax.device_get(jctx.params), "cpu"),
        device="cpu")
    trep = tapi.run_serve(tspec, ctx=tctx)
    return arch, jctx, jrep, tctx, trep


def test_static_family_tokens_and_report_match_repro(served):
    arch, jctx, jrep, tctx, trep = served
    assert type(tctx.engine).__name__ == "BatchedServer"
    assert tctx.model.cfg.family == jctx.model.cfg.family
    assert _tokens(trep) == _tokens(jrep)
    for field in REPORT_FIELDS:
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.cache_utilization == jrep.cache_utilization
    assert trep.prefill_tokens == 5 * 17           # padded: max x batch
    assert trep.steps == 7 and trep.decode_tokens == 5 * 7


def _cache_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _cache_leaves(
            tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree.float() if torch.is_tensor(tree)
                               else tree)}


def test_vlm_static_cache_drops_the_same_prefill_positions():
    """internvl2: the static batch's prefill runs patches + prompt (s
    positions) into a ring of prompt + new tokens (c < s); both packages
    keep exactly positions s - c .. s - 1, each at slot position % c.
    repro's init rescaled to fan-in d_in (``fan_in_params``) keeps the
    K/V near unit scale, where CACHE_ATOL is float32 rounding."""
    jm = jbuild(jget("internvl2-2b", reduced=True))
    tm = tbuild(tget("internvl2-2b", reduced=True))
    jp = fan_in_params(jm)
    tp = from_numpy_tree(jp, "cpu")
    cfg = tm.cfg
    b, plen, max_new = 5, 17, 8
    c, s = plen + max_new, cfg.num_patches + plen
    assert s - c == 8                              # dropped positions
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, plen)).astype(np.int32)
    patches = np.zeros((b, cfg.num_patches, cfg.d_model), np.float32)
    jbatch = {"tokens": tokens, "patches": patches}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "patches": torch.from_numpy(patches)}
    caches = {}
    for length in (c, s):
        _, jcache, jpos = jm.prefill(jp, jbatch, cache_len=length)
        _, tcache, tpos = tm.prefill(tp, tbatch, cache_len=length)
        assert int(jpos) == int(tpos) == s
        caches[length] = (_cache_leaves(jax.device_get(jcache)),
                          _cache_leaves(tcache))
    kept = np.arange(s - c, s)
    for pkg in (0, 1):
        ring, full = caches[c][pkg], caches[s][pkg]
        assert ring.keys() == full.keys() and ring
        for name, leaf in ring.items():
            assert leaf.shape[2] == c, name
            np.testing.assert_array_equal(leaf[:, :, kept % c],
                                          full[name][:, :, kept], name)
    for name, leaf in caches[c][1].items():
        np.testing.assert_allclose(leaf, caches[c][0][name],
                                   atol=CACHE_ATOL, rtol=0, err_msg=name)
