"""The port's VLM family (internvl2-2b, reduced: float32, 2 layers, 16
patch slots) against repro's, with and without patches, on the CPU.

A VLM batch carries ``patches`` (B, P, d): embeddings that go in front
of the text tokens' (repro stubs the vision encoder, and so does the
port). Parameters are repro's init rescaled to fan-in d_in
(``tests/test_torch_archs.py`` says why), patches are drawn with numpy
at scale 0.02. Tolerances as there: losses and metrics at rtol 1e-5,
per-leaf gradients at 3e-4 of the leaf's largest entry and of its L2
norm, prefill logits and caches at atol 1e-4. Serving is text only, as
in repro (its continuous runtime never feeds patches): tokens identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import get_config as jget
from repro.core import psl as jpsl
from repro.models import build_model as jbuild
from repro_torch import api as tapi
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import get_config as tget
from repro_torch.core import psl as tpsl
from repro_torch.models import build_model as tbuild
from test_torch_archs import LOSS_RTOL, assert_grads, fan_in_params
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "internvl2-2b"


@pytest.fixture(scope="module")
def pair():
    jm = jbuild(jget(ARCH, reduced=True))
    tm = tbuild(tget(ARCH, reduced=True))
    return jm, tm, fan_in_params(jm, seed=1)


def _batch(cfg, b=2, s=12, seed=0, patches=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    w = np.ones((b, s), np.float32)
    w[0, -3:] = 0.0
    host = {"tokens": toks[:, :s], "labels": toks[:, 1:], "weights": w}
    if patches:
        host["patches"] = (0.02 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model))).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


@pytest.mark.parametrize("patches", [True, False])
def test_vlm_loss_and_grads_match_repro(pair, patches):
    jm, tm, jp = pair
    jb, tb = _batch(jm.cfg, patches=patches)
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
    (tl, tmet), tg = tpsl.value_and_grad(
        tm.loss_fn, tpsl.requires_grad_(from_numpy_tree(jp, "cpu")), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    # the patch columns carry no weight: the token count is the text's
    assert float(tmet["tokens"]) == float(tb["weights"].sum())
    assert_grads(tg, jg)


def test_vlm_client_forward_and_server_loss_match_repro(pair):
    jm, tm, jp = pair
    jb, tb = _batch(jm.cfg, seed=1)
    tp = tpsl.requires_grad_(from_numpy_tree(jp, "cpu"))
    jcut = jm.client_forward(jp, jb)
    tcut = tm.client_forward(tp, tb)
    p, s = jm.cfg.num_patches, tb["tokens"].shape[1]
    assert tuple(tcut.shape) == jcut.shape == (2, p + s, jm.cfg.d_model)
    assert tpsl.cut_transfer_bytes(tm, tb) == jpsl.cut_transfer_bytes(jm, jb)
    np.testing.assert_allclose(tcut.detach().numpy(), np.asarray(jcut),
                               atol=1e-4, rtol=0)
    jloss = jm.server_loss(jp["server"], jcut, jb)
    tloss = tm.server_loss(tp["server"], tcut, tb)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    # the six-substep decomposition: same loss and grads as repro's
    tl, tdg, _ = tpsl.decomposed_grads(tm, tp, tb)
    jl, jdg, _ = jpsl.decomposed_grads(jm, jp, jb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert_grads(tdg, jdg)


def test_vlm_prefill_with_patches_fills_the_cache_like_repro(pair):
    jm, tm, jp = pair
    jb, tb = _batch(jm.cfg, s=9, seed=2)
    p, s = jm.cfg.num_patches, 9
    cache_len = p + s + 7
    jl, jc, jpos = jax.jit(functools.partial(jm.prefill,
                                             cache_len=cache_len))(
        jp, {"tokens": jb["tokens"], "patches": jb["patches"]})
    tl, tc, tpos = tm.prefill(from_numpy_tree(jp, "cpu"),
                              {"tokens": tb["tokens"],
                               "patches": tb["patches"]},
                              cache_len=cache_len)
    assert tpos == int(jpos) == p + s
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    for side in ("client", "server"):
        for kv in ("k", "v"):
            want = np.asarray(jc[side][kv])
            assert tuple(tc[side][kv].shape) == want.shape
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(tc[side][kv].numpy() / scale,
                                       want / scale, atol=1e-4, rtol=0)
            # positions P+S.. stay empty
            assert not tc[side][kv][:, :, p + s:].any()


def _serve_spec(pkg, engine):
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch=ARCH, reduced=True),
        engine=pkg.EngineSpec(name=engine, num_slots=4, slot_len=32),
        admission=pkg.AdmissionSpec(token_budget=4),
        workload=pkg.WorkloadSpec(num_requests=6, prompt_lens=[5, 9, 17],
                                  max_new_tokens=[4, 9]),
        clock=pkg.ClockSpec(kind="virtual"),
        cache=pkg.CacheSpec(page_size=8))


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_vlm_run_serve_matches_repro(engine):
    jspec, tspec = _serve_spec(japi, engine), _serve_spec(tapi, engine)
    assert jspec.to_dict() == tspec.to_dict()
    jctx = japi.build_serve_context(jspec)
    jrep = japi.run_serve(jspec, ctx=jctx)
    tctx = tapi.build_serve_context(
        tspec, params=from_numpy_tree(jax.device_get(jctx.params), "cpu"),
        device="cpu")
    trep = tapi.run_serve(tspec, ctx=tctx)
    assert ({r["rid"]: r["tokens"] for r in trep.per_request}
            == {r["rid"]: r["tokens"] for r in jrep.per_request})
    for field in ("steps", "decode_tokens", "prefill_tokens", "max_active"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.cache_utilization == jrep.cache_utilization
