"""The port's mixture-of-experts layer and MoE serving and training against
repro's, on the CPU.

``moe_apply`` is held to ``repro.models.layers.moe_apply`` on the reduced
MoE configs (float32) with weights and inputs drawn from a seed with
numpy at fan-in d_in scale, so outputs are O(1): output and aux loss at
atol 1e-5 (float32 products summed in another order); gradients by
autograd against ``jax.grad``, per leaf, with max |port - repro| <= 3e-4
max |repro| and relative L2 error <= 3e-4 (top-1 routing renormalizes a
gate p / p, whose zero derivative comes out of cancelling terms of size
1 / p, so the router's gradient carries float32 noise of ~1e-4 of its
largest entry; an elementwise atol 1e-5 would hold that noise to a
tighter limit than the leaf's scale). The cases cover
top-1 and top-2 routing, the shared expert, a capacity that drops
assignments and one that drops none, grouped dispatch (``moe_groups``
2) and a router whose duplicated columns tie exactly, where the lower
expert index must win as ``jax.lax.top_k`` picks it.

Serving and training go through the two packages' entry points on one
spec: greedy tokens must be identical, and the training losses follow
``tests/test_torch_train.py``'s tolerances, from one initial state in
both packages: repro's init with every stacked matrix rescaled to fan-in
d_in. (At repro's own init, whose stacked leaves take the layer count
as their fan-in, the reduced MoE's experts have std-1 weights, gradient
norms near 260, and two AdamW steps turn float32 rounding into 25%
differences of the gradient norm in either package against itself.)
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import get_config as jget
from repro.launch.train import default_lm_spec as j_default_lm_spec
from repro.models import build_model as jbuild
from repro.models import layers as JL
import repro_torch.api as tapi
from repro_torch import optim as toptim
from repro_torch.api import protocols as tprotocols
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import get_config as tget
from repro_torch.core import psl as tpsl
from repro_torch.launch.train import default_lm_spec as t_default_lm_spec
from repro_torch.models import layers as TL
from repro_torch.models.layers import tree_leaves
from torch_one_thread import one_torch_thread  # noqa: F401

ATOL = 1e-5
GRAD_REL = 3e-4
MOE_ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e",
             "moonshot-v1-16b-a3b"]


def _cfgs(arch, **over):
    return (dataclasses.replace(jget(arch, reduced=True), **over),
            dataclasses.replace(tget(arch, reduced=True), **over))


def _moe_params(jcfg, seed=0, tie=False):
    """MoE weights from numpy at std 1/sqrt(d_in), as a numpy tree in
    repro's key layout; ``tie`` copies router column 0 into column 1."""
    rng = np.random.default_rng(seed)
    specs = JL.moe_specs(jcfg)

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        shape = tree.shape
        return (rng.standard_normal(shape)
                / math.sqrt(shape[-2])).astype(np.float32)
    params = draw(specs)
    if tie:
        params["router"][:, 1] = params["router"][:, 0]
    return params


def _routing(params, x, cfg):
    """repro's routing in numpy: (expert ids (T, k), kept mask (T, k),
    router logits (T, E)) for a dispatch without groups."""
    xt = x.reshape(-1, x.shape[-1])
    logits = xt @ params["router"]
    e, k = cfg.num_experts, cfg.experts_per_token
    order = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    flat = order.reshape(-1)
    cap = max(int(math.ceil(xt.shape[0] * k / e * cfg.moe_capacity_factor)),
              1)
    counts = np.zeros(e, np.int64)
    keep = np.zeros(flat.shape, bool)
    for i, ex in enumerate(flat):
        keep[i] = counts[ex] < cap
        counts[ex] += 1
    return order, keep.reshape(order.shape), logits


def _both(arch, factor, groups, tie=False, shape=(4, 16), seed=0):
    """Configs, weights and an input whose tokens share a common
    component, so routing is skewed and factor 1.25 drops some."""
    jcfg, tcfg = _cfgs(arch, moe_capacity_factor=factor, moe_groups=groups)
    params = _moe_params(jcfg, seed, tie=tie)
    rng = np.random.default_rng(seed + 1)
    x = (rng.standard_normal(shape + (jcfg.d_model,))
         + rng.standard_normal(jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, params, x


CASES = [(arch, factor, groups) for arch in MOE_ARCHS
         for factor in (1.25, 8.0) for groups in (0, 2)]


@pytest.mark.parametrize("arch,factor,groups", CASES)
def test_moe_apply_matches_repro(arch, factor, groups):
    jcfg, tcfg, params, x = _both(arch, factor, groups)
    jy, jaux = JL.moe_apply(jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(x), jcfg)
    ty, taux = TL.moe_apply(from_numpy_tree(params, "cpu"),
                            torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL, rtol=0)
    _, keep, _ = _routing(params, x, jcfg)
    if factor == 1.25 and groups == 0:
        assert not keep.all(), "the dropping case dropped nothing"
    if factor == 8.0:
        assert keep.all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_router_ties_pick_the_lower_expert(arch):
    """Router columns 0 and 1 equal: both packages send each token whose
    top-k reaches the tie to expert 0 before expert 1, and agree."""
    jcfg, tcfg, params, x = _both(arch, 8.0, 0, tie=True)
    order, _, logits = _routing(params, x, jcfg)
    tlogits = (torch.from_numpy(x).reshape(-1, jcfg.d_model)
               @ torch.from_numpy(params["router"]))
    assert torch.equal(tlogits[:, 0], tlogits[:, 1])     # exact ties
    vals, idx = TL.top_k_stable(torch.softmax(tlogits, -1),
                                jcfg.experts_per_token)
    jvals, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(
        tlogits.numpy()), -1), jcfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), order)
    chose_zero = (idx == 0).any(-1)
    assert chose_zero.any()
    # where expert 0 is picked, 1 comes right after it (k >= 2) or not at
    # all (k = 1): never before
    for row in idx.numpy():
        if 1 in row:
            assert 0 in row and list(row).index(0) < list(row).index(1)
    jy, jaux = JL.moe_apply(jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(x), jcfg)
    ty, taux = TL.moe_apply(from_numpy_tree(params, "cpu"),
                            torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch,factor,groups",
                         [(a, 1.25, g) for a in MOE_ARCHS for g in (0, 2)])
def test_moe_apply_grads_match_jax_grad(arch, factor, groups):
    jcfg, tcfg, params, x = _both(arch, factor, groups, shape=(2, 12))
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        y, aux = JL.moe_apply(p, xx, jcfg)
        return jnp.sum(y * cot) + 10.0 * aux
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = tpsl.requires_grad_(from_numpy_tree(params, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TL.moe_apply(tp, tx, tcfg)
    (torch.sum(y * torch.from_numpy(cot)) + 10.0 * aux).backward()
    pairs = [(tx.grad, jg_x)] + [
        (t.grad, j) for t, j in zip(tree_leaves(tp),
                                    jax.tree_util.tree_leaves(jg_p))]
    for got, want in pairs:
        got = got.double().numpy()
        want = np.asarray(want, np.float64)
        assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max()
        assert np.linalg.norm(got - want) <= GRAD_REL * np.linalg.norm(want)


def test_moe_capacity_follows_repro_float_order():
    _, tcfg = _cfgs("granite-moe-3b-a800m")
    full = tget("granite-moe-3b-a800m")
    assert TL.moe_capacity(8, full) == math.ceil(8 * 8 / 40 * 1.25) == 2
    assert TL.moe_capacity(2048, full) == 512
    assert TL.moe_capacity(1, tcfg) == 1
    assert TL.moe_capacity(24, tcfg, groups=2) == math.ceil(
        24 * 2 / 4 / 2 * 1.25)


# ---------------------------------------------------------------------------
# Serving and training through the entry points
# ---------------------------------------------------------------------------

def _serve_spec(pkg, engine, factor, slots=4):
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch="granite-moe-3b-a800m", reduced=True,
                            overrides={"moe_capacity_factor": factor}),
        engine=pkg.EngineSpec(name=engine, num_slots=slots, slot_len=32),
        admission=pkg.AdmissionSpec(token_budget=4),
        workload=pkg.WorkloadSpec(num_requests=6, prompt_lens=[5, 9, 17],
                                  max_new_tokens=[4, 9]),
        clock=pkg.ClockSpec(kind="virtual"),
        cache=pkg.CacheSpec(page_size=8))


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report.per_request}


@pytest.mark.parametrize("engine,factor", [("continuous", 8.0),
                                           ("paged", 8.0),
                                           ("continuous", 1.25),
                                           ("paged", 1.25)])
def test_moe_run_serve_matches_repro(engine, factor):
    """At factor 8.0 nothing is dropped; at the config's 1.25 each step
    routes 4 slots (inactive ones riding along) under a capacity of 3, so
    a drop couples slots, and both packages must couple them alike."""
    jspec, tspec = (_serve_spec(p, engine, factor) for p in (japi, tapi))
    assert jspec.to_dict() == tspec.to_dict()
    jctx = japi.build_serve_context(jspec)
    assert jctx.model.cfg.moe_capacity_factor == factor
    jrep = japi.run_serve(jspec, ctx=jctx)
    tctx = tapi.build_serve_context(
        tspec, params=from_numpy_tree(jax.device_get(jctx.params), "cpu"),
        device="cpu")
    assert tctx.model.cfg.moe_capacity_factor == factor
    trep = tapi.run_serve(tspec, ctx=tctx)
    assert _tokens(trep) == _tokens(jrep)
    for field in ("steps", "decode_tokens", "prefill_tokens", "max_active"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.cache_utilization == jrep.cache_utilization


TRAIN_SETS = ["model.arch=granite-moe-3b-a800m", "model.reduced=true",
              "execution.max_steps=3", "protocol.global_batch_size=8",
              "data.seq_len=32", "data.sequences=256",
              "sampler.method=ugs"]


def _fan_in_init(jm, seed):
    """repro's init as numpy with every stacked matrix rescaled from std
    1/sqrt(layers) to 1/sqrt(d_in)."""
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(
        lambda a: (a * math.sqrt(a.shape[0] / a.shape[-2])).astype(a.dtype)
        if a.ndim >= 3 else np.asarray(a), params)


def test_moe_psl_run_matches_repro(monkeypatch):
    jspec = japi.apply_overrides(j_default_lm_spec(), TRAIN_SETS)
    tspec = tapi.apply_overrides(t_default_lm_spec(), TRAIN_SETS)
    assert tspec.to_dict() == jspec.to_dict()
    jm = jbuild(jget("granite-moe-3b-a800m", reduced=True))
    jp = _fan_in_init(jm, jspec.seed)
    # repro's engine inits from model.init under jit; hand it jp instead
    monkeypatch.setattr(type(jm), "init", lambda self, key: jax.tree_util
                        .tree_map(jnp.asarray, jp))
    jres = japi.run(jspec)
    init = tprotocols._fresh_state

    def bridged_init(ctx):
        state = init(ctx)
        return toptim.TrainState(
            tpsl.requires_grad_(from_numpy_tree(jp, "cpu")),
            state.opt_state, 0)
    monkeypatch.setattr(tprotocols, "_fresh_state", bridged_init)
    tres = tapi.run(tspec, device="cpu")
    assert len(tres.step_metrics) == len(jres.step_metrics) == 3
    for i, (t, j) in enumerate(zip(tres.step_metrics, jres.step_metrics)):
        rtol = 1e-5 if i == 0 else 1e-3
        assert j["aux_loss"] > 0
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=rtol)
        np.testing.assert_allclose(t["aux_loss"], j["aux_loss"], rtol=rtol)
        np.testing.assert_allclose(t["tokens"], j["tokens"], rtol=0)
