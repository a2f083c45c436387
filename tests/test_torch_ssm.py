"""The port's Mamba-1 (ssm family) serving path against repro's.

Reduced falcon-mamba-7b in float32 on the CPU, parameters bridged from
repro. Tolerances:

- the selective scan's plain version against ``ssm_scan_ref`` and the
  Pallas kernel in interpret mode: float32 atol 1e-5 + rtol 1e-5 (the same
  recurrence, y summed over the states in another order); bf16 inputs are
  upcast once on both sides, so the same tolerance holds;
- ``mamba1_apply`` against repro: atol 2e-5 after division by the
  tensor's largest magnitude (at least 1): repro's prefill runs a chunked
  associative scan, the port a sequential one — the same products
  associated differently, each rounding once in fp32;
- prefill logits, caches and decode of the whole model: atol 1e-4 on the
  same scale, as tests/test_torch_model.py holds the dense model (the
  reassociation above, carried through both layers and the LM head);
- the ``continuous`` engine token-identical to repro's (greedy).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssm_scan as pallas_scan
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch import api as tapi
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import (ssm_scan, ssm_scan_bwd,
                                          ssm_scan_heads, ssm_scan_heads_bwd,
                                          ssm_scan_plain, sum_states)
from repro_torch.kernels.spec_verify import spec_verify
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as TL
from repro_torch.models.layers import tree_leaves
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "falcon-mamba-7b"
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)


MODEL_ATOL = 1e-4


def _close(got, want, atol=2e-5):
    """Agreement relative to the tensor's scale."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float()) if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    jm, tm = jbuild(jget(ARCH, reduced=True)), tbuild(tget(ARCH, reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, tckpt.from_numpy_tree(jax.device_get(jp), "cpu")


# ------------------------------------------------------- B4 plain version

def _scan_inputs(rng, b, l, d, n):
    x = rng.normal(size=(b, l, d))
    dt = np.log1p(np.exp(rng.normal(size=(b, l, d)) - 1.0))   # softplus
    a = -np.exp(np.log(np.arange(1, n + 1))[None].repeat(d, 0)
                + 0.1 * rng.normal(size=(d, n)))
    return x, dt, a, rng.normal(size=(b, l, n)), rng.normal(size=(b, l, n))


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,d,n,block_l", [
    (2, 32, 128, 8, 16),      # reduced falcon-mamba's N, two L blocks
    (1, 64, 256, 16, 64),     # full width's N, two D blocks
    (3, 8, 128, 4, 8),        # short prompt
    (1, 40, 128, 16, 20),     # one row, L past the kernel's 16-step chunks
])
def test_ssm_scan_plain_matches_ref_and_pallas(xdt, b, l, d, n, block_l):
    rng = np.random.default_rng(11)
    x, dt, a, bm, cm = _scan_inputs(rng, b, l, d, n)
    jdt = jnp.bfloat16 if xdt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if xdt == "bfloat16" else torch.float32
    xj, bj, cj = (jnp.asarray(v, jdt) for v in (x, bm, cm))
    dtj, aj = jnp.asarray(dt, jnp.float32), jnp.asarray(a, jnp.float32)
    xt, bt, ct = (torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
                  for v in (xj, bj, cj))
    dtt, at = torch.from_numpy(np.array(dtj)), torch.from_numpy(np.array(aj))
    y, h = ssm_scan_plain(xt, dtt, at, bt, ct)
    assert y.shape == (b, l, d) and h.shape == (b, d, n)
    assert y.dtype == h.dtype == torch.float32
    jy, jh = jref.ssm_scan_ref(xj, dtj, aj, bj, cj)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)
    py, ph = pallas_scan(xj, dtj, aj, bj, cj, block_l=block_l,
                         block_d=128, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ph), **SCAN_TOL)
    ops.reset_launches()
    gy, gh = ops.selective_scan(xt, dtt, at, bt, ct)
    assert torch.equal(gy, y) and torch.equal(gh, h)
    assert ops.launch_counts()["selective_scan"] == 0


@pytest.mark.parametrize("n", [1, 5, 16, 24, 64])
def test_sum_states_follows_the_kernels_order(n):
    """y_t sums the states as the kernel does: padded with zeros to 8, 16,
    32 or 64, 4 states a lane in index order, then the lanes pairwise (the
    xor-shuffle tree). Checked bitwise against that order written out, and
    against an fp64 sum at fp32 rounding."""
    rng = np.random.default_rng(n)
    hc = torch.from_numpy(rng.normal(size=(3, 7, n)).astype(np.float32))
    tier = next(t for t in (8, 16, 32, 64) if n <= t)
    padded = torch.cat([hc, torch.zeros(3, 7, tier - n)], dim=-1)
    lanes = [((padded[..., 4 * i] + padded[..., 4 * i + 1])
              + padded[..., 4 * i + 2]) + padded[..., 4 * i + 3]
             for i in range(tier // 4)]
    while len(lanes) > 1:
        lanes = [lanes[i] + lanes[i + 1] for i in range(0, len(lanes), 2)]
    got = sum_states(hc)
    assert torch.equal(got, lanes[0])
    np.testing.assert_allclose(got.numpy(), hc.double().sum(-1).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_selective_scan_is_differentiable_on_the_cpu():
    """On the CPU the selective scan carries gradients through its
    autograd Function (forward ssm_scan_plain, backward
    ssm_scan_bwd_plain: the CPU training path of a Mamba-1 block),
    agreeing with autograd of repro's oracle."""
    rng = np.random.default_rng(2)
    x, dt, a, bm, cm = _scan_inputs(rng, 2, 6, 16, 4)
    ts = [torch.tensor(v, dtype=torch.float32, requires_grad=True)
          for v in (x, dt, a, bm, cm)]
    y, h = ops.selective_scan(*ts)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    got = torch.autograd.grad(y.sum() + h.sum(), ts)

    def loss(*args):
        yy, hh = jref.ssm_scan_ref(*args)
        return yy.sum() + hh.sum()
    want = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(v, jnp.float32) for v in (x, dt, a, bm, cm)))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)


@pytest.mark.parametrize("which", ["ssm_scan", "ssm_scan_bwd",
                                   "ssm_scan_heads", "ssm_scan_heads_bwd",
                                   "spec_verify"])
def test_kernel_launchers_reject_cpu_tensors(which):
    """The launchers take CUDA tensors only and check before building."""
    with pytest.raises(ValueError, match="CUDA"):
        if which == "ssm_scan":
            x = torch.zeros((1, 4, 8))
            ssm_scan(x, x, torch.zeros((8, 2)), torch.zeros((1, 4, 2)),
                     torch.zeros((1, 4, 2)))
        elif which == "ssm_scan_bwd":
            x = torch.zeros((1, 4, 8))
            ssm_scan_bwd(x, x, torch.zeros((8, 2)), torch.zeros((1, 4, 2)),
                         torch.zeros((1, 4, 2)), x)
        elif which == "ssm_scan_heads":
            ssm_scan_heads(torch.zeros((1, 4, 8)), torch.zeros((1, 4, 2)),
                           torch.zeros((2,)), torch.zeros((1, 4, 2)),
                           torch.zeros((1, 4, 2)))
        elif which == "ssm_scan_heads_bwd":
            x = torch.zeros((1, 4, 8))
            ssm_scan_heads_bwd(x, torch.zeros((1, 4, 2)), torch.zeros((2,)),
                               torch.zeros((1, 4, 2)),
                               torch.zeros((1, 4, 2)), x)
        else:
            q = torch.zeros((1, 2, 4, 16))
            spec_verify(q, q, q, torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros((1, 2), dtype=torch.int32))


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.selective_scan(x, x, x[0], x, x)
    q = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.spec_verify(q, q, q, q, q)


# ------------------------------------------------------------ layers

def test_ssm_a_init_and_specs(pair):
    jm, tm, _, _ = pair
    cfg = tm.cfg
    assert (cfg.d_inner, cfg.dt_rank) == (jm.cfg.d_inner, jm.cfg.dt_rank)
    tp = tm.init(torch.Generator().manual_seed(0))
    a_log = tp["server"]["blocks"]["mixer"]["a_log"]
    assert a_log.dtype == torch.float32
    assert a_log.shape == (cfg.num_layers - cfg.cut_layer, cfg.d_inner,
                           cfg.ssm_state)
    # log(1..N), correctly rounded to fp32 by torch; XLA's fp32 log is
    # one ulp off at one of the N values, so repro's leaf agrees to 1 ulp
    want = np.log(np.arange(1, cfg.ssm_state + 1)).astype(np.float32)
    np.testing.assert_array_equal(a_log.numpy(),
                                  np.broadcast_to(want, a_log.shape))
    jp = jm.init(jax.random.PRNGKey(0))
    np.testing.assert_allclose(
        a_log.numpy(), np.asarray(jp["server"]["blocks"]["mixer"]["a_log"]),
        rtol=1.2e-7, atol=0)
    skip = tp["client"]["blocks"]["mixer"]["d_skip"]
    assert skip.dtype == torch.float32 and bool((skip == 1).all())
    jspecs = jax.tree_util.tree_leaves(jm.param_specs(),
                                       is_leaf=lambda s: hasattr(s, "axes"))
    tspecs = tree_leaves(tm.param_specs())
    assert [(tuple(s.shape), s.axes, s.init) for s in tspecs] \
        == [(tuple(s.shape), s.axes, s.init) for s in jspecs]
    assert [s.dtype is not None for s in tspecs] \
        == [s.dtype is not None for s in jspecs]
    assert TL.ssm_state_shapes(cfg, 3) == JL.ssm_state_shapes(jm.cfg, 3)


def _mixer(p):
    return {k: v[0] for k, v in p["client"]["blocks"]["mixer"].items()}


def test_mamba1_apply_prefill_and_decode(pair):
    jm, tm, jp, tp = pair
    cfg = tm.cfg
    x = np.random.default_rng(4).normal(size=(2, 13, cfg.d_model)) \
        .astype(np.float32)
    jmix = jax.tree_util.tree_map(lambda v: v[0],
                                  jp["client"]["blocks"]["mixer"])
    jy, jst = JL.mamba1_apply(jmix, jnp.asarray(x), jm.cfg,
                              return_state=True)
    ty, tst = TL.mamba1_apply(_mixer(tp), torch.from_numpy(x), cfg,
                              return_state=True)
    _close(ty, jy)
    for k in ("conv", "ssm"):
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k], jst[k])
    assert tst["ssm"].dtype == torch.float32
    # stateless forward equals the prefill's output
    _close(TL.mamba1_apply(_mixer(tp), torch.from_numpy(x), cfg), jy)
    # three streaming decode steps from the prefill state
    jstate = jst
    tstate = {k: v.clone() for k, v in tst.items()}
    for i in range(3):
        xt = np.random.default_rng(10 + i).normal(
            size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = JL.mamba1_apply(jmix, jnp.asarray(xt), jm.cfg,
                                     state=jstate)
        ty, tstate = TL.mamba1_apply(_mixer(tp), torch.from_numpy(xt), cfg,
                                     state=tstate)
        _close(ty, jy)
        for k in ("conv", "ssm"):
            _close(tstate[k], jstate[k])


def test_prefill_and_decode_match_repro(pair):
    jm, tm, jp, tp = pair
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 21)).astype(np.int32)
    jl, jc, jpos = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              cache_len=32)
    tl, tc, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              cache_len=32)
    assert int(jpos) == tpos == 21
    _close(tl, jl, MODEL_ATOL)
    for side in ("client", "server"):
        for k in ("conv", "ssm"):
            assert tuple(tc[side][k].shape) == jc[side][k].shape
            assert tc[side][k].dtype == torch.float32
            _close(tc[side][k], jc[side][k], MODEL_ATOL)
    specs = tm.cache_specs(2, 32)
    assert specs["server"]["ssm"].dtype == torch.float32
    assert specs["server"]["conv"].axes == ("layers", "batch", None,
                                            "inner")
    tok = np.array([[3], [5]], np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(21))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                 torch.tensor(21))
        assert tc2 is tc                      # state written in place
        _close(tl, jl, MODEL_ATOL)
        for side in ("client", "server"):
            for k in ("conv", "ssm"):
                _close(tc[side][k], jc[side][k], MODEL_ATOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_training_loss_matches_repro(pair):
    """The ssm branch of the training forward (``_run_stack``) on the CPU,
    where the selective scan's plain version carries the gradient."""
    jm, tm, jp, tp = pair
    rng = np.random.default_rng(9)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    weights = (rng.random((2, 12)) > 0.2).astype(np.float32)
    jl, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels),
                            "weights": jnp.asarray(weights)})
    tl, metrics = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels),
                                  "weights": torch.from_numpy(weights)})
    _close(tl, jl, MODEL_ATOL)
    assert metrics["tokens"].item() == weights.sum()


def test_paged_decode_rejects_ssm(pair):
    _, tm, _, tp = pair
    with pytest.raises(NotImplementedError, match="attention-cache"):
        tm.decode_step_paged(tp, {}, torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32),
                             torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="attention-cache"):
        tm.decode_window_paged(tp, {}, torch.zeros((1, 2),
                                                   dtype=torch.int32),
                               torch.zeros((1, 2), dtype=torch.int32),
                               torch.zeros((1, 1), dtype=torch.int32))


# ------------------------------------------------------------ engines

def _spec(pkg, engine="continuous", **kw):
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch=ARCH, reduced=True),
        engine=pkg.EngineSpec(name=engine, num_slots=4, slot_len=48),
        admission=pkg.AdmissionSpec(token_budget=4),
        workload=pkg.WorkloadSpec(num_requests=6, prompt_lens=[5, 9, 17],
                                  max_new_tokens=[4, 9]),
        clock=pkg.ClockSpec(kind="virtual"),
        draft=pkg.DraftSpec(num_layers=1) if engine == "speculative"
        else pkg.DraftSpec(), **kw)


def test_continuous_engine_matches_repro(pair):
    _, _, jp, tp = pair
    jspec, tspec = _spec(japi), _spec(tapi)
    assert jspec.to_dict() == tspec.to_dict()
    jrep = japi.run_serve(jspec, ctx=japi.build_serve_context(jspec,
                                                              params=jp))
    tctx = tapi.build_serve_context(tspec, params=tp, device="cpu")
    trep = tapi.run_serve(tspec, ctx=tctx)
    assert {r["rid"]: r["tokens"] for r in trep.per_request} \
        == {r["rid"]: r["tokens"] for r in jrep.per_request}
    for field in ("steps", "decode_tokens", "prefill_tokens", "max_active",
                  "step_active", "preemptions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.cache_utilization == jrep.cache_utilization
    tctx.engine.pool.check_no_leaks()
    again = tapi.run_serve(tspec.replace(report=tapi.ReportSpec(verify=-1)),
                           ctx=tctx)
    assert again.verified == {"checked": 6, "mismatches": []}


@pytest.mark.parametrize("engine", ["paged", "speculative"])
def test_paged_engines_reject_ssm(pair, engine):
    _, _, _, tp = pair
    with pytest.raises(NotImplementedError, match="continuous engine"):
        tapi.build_serve_context(_spec(tapi, engine), params=tp,
                                 device="cpu")


def test_serve_cli_serves_falcon_mamba_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                    "--verify", "-1"])
    out = capsys.readouterr().out
    assert "arch=falcon-mamba-7b-reduced [continuous] 3 requests" in out
    assert "verified token-identical: 3 requests" in out


# ------------------------------------------------------------ weights

def test_ssm_checkpoint_round_trip_keeps_fp32_leaves(tmp_path):
    """A bf16 falcon-mamba saved by repro loads into the port bit for bit:
    the bf16 matrices and the fp32 a_log / d_skip leaves alike; the port's
    save reads back the same; a prefill cache's fp32 ssm state and bf16
    conv state bridge bit-exactly too."""
    cfg = dataclasses.replace(jget(ARCH, reduced=True), dtype="bfloat16")
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(5))
    path = str(tmp_path / "params.npz")
    jckpt.save(path, jp)
    tp = tckpt.restore(path, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    dtypes = {t.dtype for t in tl}
    assert dtypes == {torch.bfloat16, torch.float32}
    mixer = tp["server"]["blocks"]["mixer"]
    assert mixer["a_log"].dtype == mixer["d_skip"].dtype == torch.float32

    def bits(t):
        return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                else t.numpy())
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(bits(b), want)
    path2 = str(tmp_path / "again.npz")
    tckpt.save(path2, tp)
    for a, b in zip(jax.tree_util.tree_leaves(jckpt.restore(path2)), jl):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    _, jc, _ = jm.prefill(jp, {"tokens": jnp.ones((1, 5), jnp.int32)})
    tc = tckpt.from_numpy_tree(jax.device_get(jc), "cpu")
    assert tc["client"]["ssm"].dtype == torch.float32
    assert tc["client"]["conv"].dtype == torch.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(jc), tree_leaves(tc)):
        a = np.asarray(a)
        want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(bits(b), want)
