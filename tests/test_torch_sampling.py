"""Seeded sampled decoding in the port against repro's, on the CPU.

The port's sampler (``repro_torch.runtime.sampling``) computes JAX's
Threefry-2x32 in torch, so its keys and bits equal ``jax.random``'s bit
for bit, and ``sample_tokens`` equals ``repro.runtime.sampling``'s token
for token. Served through ``continuous``, ``paged`` and ``speculative``
on bridged parameters, reduced granite-3-2b and reduced llama3-8b give
repro's tokens under repro's own test setting (``SAMP``, as
``tests/test_spec_decode.py``), and within the port the keys make the
tokens independent of the engine and of a preempt/resume.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.runtime import sampling as jsampling
from repro_torch import api as tapi
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.runtime import sampling as tsampling
from torch_one_thread import one_torch_thread  # noqa: F401

SEEDS = [0, 7, 2**31 - 1, -1, 2**32 + 5]
DATA = [(0, 0), (3, 11), (96, 4095), (2**31 - 1, 2**31 - 1)]


def _samp(pkg, **over):
    """repro's test setting: temperature 0.9, top-k 50, seed 7."""
    kw = dict(method="sample", temperature=0.9, top_k=50, seed=7)
    kw.update(over)
    return pkg.SamplingSpec(**kw)


# ----------------------------------------------------------- keys, bits

def _jax_key(seed, rid, idx):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 rid), idx)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_equal_jax_random(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert tsampling.prng_key(seed).tolist() == want.astype(np.int64) \
        .tolist()
    rids = torch.tensor([r for r, _ in DATA], dtype=torch.int32)
    idxs = torch.tensor([i for _, i in DATA], dtype=torch.int32)
    keys = tsampling.fold_in(tsampling.fold_in(
        tsampling.prng_key(seed), rids), idxs)
    bits = tsampling.random_bits(keys, 1000)
    for row, (rid, idx) in enumerate(DATA):
        jkey = _jax_key(seed, rid, idx)
        assert keys[row].tolist() == np.asarray(
            jax.random.key_data(jkey)).astype(np.int64).tolist()
        np.testing.assert_array_equal(
            bits[row].numpy(),
            np.asarray(jax.random.bits(jkey, (1000,))).astype(np.int64))


def test_gumbel_noise_within_an_ulp_of_the_log():
    """The uniform is bit for bit ``jax.random.uniform``'s; the noise
    ``-log(-log(u))`` may differ from ``jax.random.gumbel``'s where
    torch's and XLA's ``log`` round apart: by at most 2**-21, one float32
    ulp of an outer log in [2, 4)."""
    keys = tsampling.fold_in(tsampling.fold_in(
        tsampling.prng_key(7), torch.tensor([3])), torch.tensor([11]))
    bits = tsampling.random_bits(keys, 4096)
    tiny = float(np.finfo(np.float32).tiny)
    jkey = _jax_key(7, 3, 11)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = torch.clamp_min((u - 1.0) * (1.0 - tiny) + tiny, tiny)
    np.testing.assert_array_equal(u[0].numpy(), np.asarray(
        jax.random.uniform(jkey, (4096,), minval=tiny, maxval=1.0)))
    got = tsampling.gumbel_from_bits(bits)[0].numpy()
    want = np.asarray(jax.random.gumbel(jkey, (4096,)))
    assert np.abs(got - want).max() <= 2.0**-21


# -------------------------------------------------------- sample_tokens

GRID = [(t, k, p) for t in (0.7, 1.0) for k in (None, 1, 50)
        for p in (None, 0.9)]


@pytest.mark.parametrize("temperature,top_k,top_p", GRID)
def test_sample_tokens_equal_repro(temperature, top_k, top_p):
    rng = np.random.default_rng(0)
    n, v = 2048, 384
    logits = (3.0 * rng.standard_normal((n, v))).astype(np.float32)
    rids = (np.arange(n) % 97).astype(np.int32)
    idxs = np.arange(n, dtype=np.int32)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, seed=7)
    want = np.asarray(jax.jit(
        lambda lg, r, i: jsampling.sample_tokens(lg, r, i, **kw))(
            logits, rids, idxs))
    got = tsampling.sample_tokens(torch.from_numpy(logits),
                                  torch.from_numpy(rids),
                                  torch.from_numpy(idxs), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_keeps_every_tie_at_the_threshold():
    """A threshold tie keeps more than k entries, as repro's sort does
    (``torch.topk``'s index set would keep exactly k)."""
    n, v = 512, 64
    logits = np.zeros((n, v), np.float32)
    logits[:, :8] = 2.0                  # 8 tied for the top, k = 3
    logits[:, 8] = 5.0
    rids = np.arange(n, dtype=np.int32)
    idxs = np.full(n, 5, np.int32)
    kw = dict(temperature=1.0, top_k=3, seed=11)
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(logits), rids,
                                              idxs, **kw))
    got = tsampling.sample_tokens(torch.from_numpy(logits),
                                  torch.from_numpy(rids),
                                  torch.from_numpy(idxs), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) <= set(range(9))
    assert len(set(got.tolist()) - {8}) > 3      # ties beyond k drawn


def test_token_sampler_greedy_and_scores():
    spec = tapi.SamplingSpec()
    sampler = tsampling.TokenSampler(spec)
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0]])
    one = torch.zeros(1, dtype=torch.int32)
    assert sampler.greedy
    assert sampler.sample(logits, one, one).tolist() == [1]
    sampled = tsampling.TokenSampler(_samp(tapi, top_k=None))
    scores = tsampling.perturbed_scores(logits, one, one, temperature=0.9,
                                        seed=7)
    assert sampled.sample(logits, one, one).tolist() == [
        int(torch.argmax(scores))]


# --------------------------------------------------------- served tokens

def _spec(pkg, engine, sampling, cache=None, arch="granite-3-2b",
          workload=None):
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch=arch, reduced=True),
        engine=pkg.EngineSpec(name=engine, num_slots=4, slot_len=48),
        admission=pkg.AdmissionSpec(token_budget=4),
        scheduler=pkg.SchedulerSpec(policy="fifo"),
        workload=pkg.WorkloadSpec(**(workload or dict(
            num_requests=6, prompt_lens=[5, 9, 17], max_new_tokens=[4, 8]))),
        clock=pkg.ClockSpec(kind="virtual"),
        cache=cache or pkg.CacheSpec(page_size=8),
        sampling=sampling,
        draft=(pkg.DraftSpec(num_layers=1, gamma=4)
               if engine == "speculative" else pkg.DraftSpec()))


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report.per_request}


@pytest.fixture(scope="module", params=["granite-3-2b", "llama3-8b"])
def bridged(request):
    """(arch, repro's params, the port's copy of them)."""
    arch = request.param
    jp = japi.build_serve_context(
        _spec(japi, "paged", _samp(japi), arch=arch)).params
    return arch, jp, from_numpy_tree(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("engine", ["continuous", "paged", "speculative"])
def test_sampled_serving_equals_repro(bridged, engine):
    arch, jp, tp = bridged
    jspec, tspec = (_spec(p, engine, _samp(p), arch=arch)
                    for p in (japi, tapi))
    assert jspec.to_dict() == tspec.to_dict()
    jrep = japi.run_serve(jspec, ctx=japi.build_serve_context(jspec,
                                                              params=jp))
    tctx = tapi.build_serve_context(tspec, params=tp, device="cpu")
    trep = tapi.run_serve(tspec, ctx=tctx)
    assert _tokens(trep) == _tokens(jrep)
    for field in ("steps", "decode_tokens", "prefill_tokens",
                  "max_active", "preemptions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.speculation == jrep.speculation
    if engine != "continuous":
        tctx.engine.pool.check_no_leaks()


def test_sampled_tokens_survive_preempt_and_match_across_engines():
    """Keys depend on (seed, rid, token index) only: a pool of 8 pages of
    8 preempts (as ``tests/test_paging.py``), and the resumed requests
    re-emit the draws an uninterrupted run made; every engine of the port
    emits the same tokens; a top-p run and another seed change them."""
    grow = dict(num_requests=6, prompt_lens=[5, 9], max_new_tokens=[16])
    runs = {}
    params = None
    for name, engine, cache in (
            ("paged", "paged", None),
            ("churned", "paged", tapi.CacheSpec(page_size=8, num_pages=8)),
            ("continuous", "continuous", None),
            ("speculative", "speculative", None)):
        spec = _spec(tapi, engine, _samp(tapi), cache=cache, workload=grow)
        ctx = tapi.build_serve_context(spec, params=params, device="cpu")
        params = ctx.params
        runs[name] = tapi.run_serve(spec, ctx=ctx)
    assert runs["churned"].preemptions > 0
    want = _tokens(runs["paged"])
    for name, report in runs.items():
        assert _tokens(report) == want, name
    for over in (dict(top_p=0.9), dict(seed=8)):
        spec = _spec(tapi, "paged", _samp(tapi, **over), workload=grow)
        other = tapi.run_serve(spec, ctx=tapi.build_serve_context(
            spec, params=params, device="cpu"))
        assert _tokens(other) != want


# ------------------------------- chip_smoke.py's sampled near-tie rule

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Five candidates at the top-4 boundary: three kept well above it (0.122
# above the first left out after T 0.9, beyond the harness's 0.0694),
# token 4 the 4th kept (2.5), token 5 the first left out (2.49, 0.0111
# below it), every other token far out.
BOUNDARY = {1: 2.6, 2: 2.6, 3: 2.6, 4: 2.5, 5: 2.49}


def _boundary_case(limit: float):
    """Logits of ``BOUNDARY`` and the first output index (rid 3) at which
    the perturbed scores of token 5, token 4, the best of 1, 2, 3
    (``top``) and the worst of them (``low``) fall in that order, each
    ``limit`` or more below the one before (no near-tie of the scores)."""
    logits = torch.full((16,), -10.0)
    for tok, x in BOUNDARY.items():
        logits[tok] = x
    rid = torch.tensor([3], dtype=torch.int32)
    for idx in range(4096):
        u = tsampling.perturbed_scores(
            logits[None], rid, torch.tensor([idx], dtype=torch.int32),
            temperature=0.9, seed=7)[0].tolist()
        top = max((1, 2, 3), key=lambda t: u[t])
        low = min((1, 2, 3), key=lambda t: u[t])
        if min(u[5] - u[4], u[4] - u[top], u[top] - u[low]) >= limit:
            return logits, idx, top, low
    raise AssertionError("no such output index")


@pytest.mark.parametrize("want,got,passes", [
    (4, 5, True),        # the other run admits 5, which wins
    (5, 4, True),        # paged admitted 5; here it is left out
    (4, "top", True),    # the other run drops 4 and keeps 5 out
    (4, "low", False),   # planted: a kept token below the best firm one
    (4, 9, False),       # planted: a token far outside the top-k set
    ("low", 4, False),   # planted on the paged side
])
def test_chip_smoke_sampled_boundary_rule(want, got, passes):
    """A sampled first difference passes only where each engine's token
    is one that the sampler takes under some rounding of the logits
    within the harness's limit: kept or that near the top-k boundary,
    and scoring within the limit of the best token no such rounding
    drops. Planted wrong tokens fail."""
    cs = _chip_smoke()
    sampler = tsampling.TokenSampler(_samp(tapi, top_k=4))
    limit = cs.NEAR_TIE_GAP / sampler.temperature
    logits, idx, top, low = _boundary_case(limit)
    name = {"top": top, "low": low}
    want, got = name.get(want, want), name.get(got, got)
    if passes:
        near = cs.sampled_difference(torch, sampler, logits, 3, idx, want,
                                     got, limit, "rule")
        assert near["rule"] == "top-k boundary"
    else:
        with pytest.raises(SystemExit, match="beyond a near-tie"):
            cs.sampled_difference(torch, sampler, logits, 3, idx, want,
                                  got, limit, "planted")
