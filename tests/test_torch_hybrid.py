"""The port's hybrid family (zamba2-2.7b: Mamba-2 blocks and one shared
attention block) against repro's, on the CPU.

Reduced zamba2 in float32 at two depths: the config's 5 layers (cut 1,
attention period 2: two superblocks, no pre-blocks) and 6 layers (one
pre-block before them, so ``pre_blocks`` and ``server_pre`` run), the
same config on both sides. Parameters are repro's init bridged key for
key, each normal-init leaf of a stack rescaled in numpy from std
1/sqrt(shape[0]) to the fan-in of its last-but-one axis (d_in), as
``tests/test_torch_archs.py`` does: at repro's own init a stacked leaf's
fan-in is its layer count (1 or 2 here), which gives std ~1 weights and
states in the thousands. The zero-init conv and dt biases are drawn
(std 0.02 and 0.5) so they take part and each head's dt differs.

Tolerances:

- B4's plain version fed Mamba-2's layout (``expand_heads``)
  against repro's ``_chunked_ssm_scan`` over the (B, S, nh, hd, N) bx:
  fp32 atol 1e-5 + rtol 1e-5, as ``tests/test_torch_ssm.py`` holds B4
  (the same products, associated sequentially against chunked);
- ``mamba2_apply`` prefill and decode: atol 2e-5 after division by the
  tensor's largest magnitude (at least 1), as Mamba-1's;
- prefill logits, caches and decode steps: atol 1e-4 on the same scale;
- ``loss_fn``: rtol 1e-5; per-leaf gradients at ``test_torch_archs``'s
  3e-4 of the leaf's largest entry and of its L2 norm;
- the ``continuous`` engine token-identical to repro's (greedy).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch import api as tapi
from repro_torch import checkpoint as tckpt
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.core import psl as tpsl
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import expand_heads, ssm_scan_plain
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as TL
from repro_torch.models.layers import tree_leaves
from test_torch_archs import LOSS_RTOL, assert_grads
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "zamba2-2.7b"
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
MIXER_ATOL = 2e-5
MODEL_ATOL = 1e-4
DEPTHS = [5, 6]                  # 6 layers: n_pre = 1


def _close(got, want, atol=MODEL_ATOL):
    """Agreement relative to the tensor's scale."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float()) if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def _is_spec(s):
    return hasattr(s, "axes")


def hybrid_fan_in_params(jm, seed=0):
    """repro's init as numpy; every stacked normal-init leaf (ndim >= 3,
    the double-stacked (n_super, attn_period, d_in, d_out) ones too)
    rescaled from std 1/sqrt(shape[0]) to 1/sqrt(shape[-2]); conv_b and
    dt_bias drawn at std 0.02 and 0.5."""
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    specs = jax.tree_util.tree_leaves(jm.param_specs(), is_leaf=_is_spec)
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.default_rng(seed)
    out = []
    for (path, leaf), spec in zip(leaves, specs):
        leaf = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        if spec.init == "normal" and leaf.ndim >= 3:
            leaf = (leaf * math.sqrt(leaf.shape[0] / leaf.shape[-2])).astype(
                leaf.dtype)
        elif name.endswith("['conv_b']"):
            leaf = (0.02 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        elif name.endswith("['dt_bias']"):
            leaf = (0.5 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        out.append(leaf)
    return jax.tree_util.tree_unflatten(tree, out)


def _configs(layers):
    return (dataclasses.replace(jget(ARCH, reduced=True), num_layers=layers),
            dataclasses.replace(tget(ARCH, reduced=True), num_layers=layers))


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda n: f"{n}layers")
def pair(request):
    jc, tc = _configs(request.param)
    jm, tm = jbuild(jc), tbuild(tc)
    jp = hybrid_fan_in_params(jm)
    return jm, tm, jp, tckpt.from_numpy_tree(jp, "cpu")


# ------------------------------------------------------------ config

def test_config_registry_and_counts():
    for reduced in (False, True):
        t, j = tget(ARCH, reduced), jget(ARCH, reduced)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.ssm_num_heads == j.ssm_num_heads
        tbuild(t)
    # the analytic count is repro's for every registered config, each
    # family's branch included
    for name in ARCH_IDS:
        for reduced in (False, True):
            assert tget(name, reduced).param_count() \
                == jget(name, reduced).param_count(), (name, reduced)
    full = tget(ARCH)
    assert full.param_count() == 2_343_741_088
    assert (full.ssm_num_heads, full.d_inner // full.ssm_num_heads) \
        == (80, 64)
    tm = tbuild(full)
    assert (tm.n_pre, tm.n_super) == (4, 8)
    # the specs declare what repro's analytic count holds, plus the conv
    # biases (di + 2N a layer) that the count leaves out, in both packages
    n = sum(math.prod(s.shape) for s in tree_leaves(tm.param_specs()))
    assert n - full.param_count() \
        == full.num_layers * (full.d_inner + 2 * full.ssm_state)


def test_specs_caches_and_bridge_are_key_for_key(pair):
    jm, tm, jp, tp = pair
    assert (tm.n_pre, tm.n_super) == (jm.n_pre, jm.n_super)
    assert tm.n_pre == jm.cfg.num_layers - 5
    for t_tree, j_tree in ((tm.param_specs(), jm.param_specs()),
                           (tm.cache_specs(3, 24), jm.cache_specs(3, 24))):
        tspecs = jax.tree_util.tree_map(
            lambda s: (tuple(s.shape), s.axes, s.init, s.dtype is None),
            t_tree, is_leaf=_is_spec)
        jspecs = jax.tree_util.tree_map(
            lambda s: (tuple(s.shape), s.axes, s.init, s.dtype is None),
            j_tree, is_leaf=_is_spec)
        assert tspecs == jspecs
    sup = tp["server"]["superblocks"]["mixer"]["in_proj"]
    cfg = tm.cfg
    assert tuple(sup.shape) == (tm.n_super, cfg.attn_period, cfg.d_model,
                                2 * cfg.d_inner + 2 * cfg.ssm_state
                                + cfg.ssm_num_heads)
    assert sorted(tp["server"]["shared_attn"]) == ["attn", "norm1"]
    assert ("pre_blocks" in tp["server"]) == bool(tm.n_pre)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert TL.ssm_state_shapes(cfg, 3) == JL.ssm_state_shapes(jm.cfg, 3)
    # the slot axis of every double-stacked cache leaf
    specs = tm.cache_specs(3, 24)
    for leaf in tree_leaves(specs["server_super"]):
        assert leaf.axes.index("batch") == 2 and leaf.shape[2] == 3


# ------------------------------------------------------------ the mixer

def _scan_inputs(rng, b, s, nh, hd, n):
    xh = rng.normal(size=(b, s, nh * hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, nh)) - 1.0)).astype(
        np.float32)
    a_log = (np.log(np.arange(1, nh + 1)) + 0.1 * rng.normal(size=nh)) \
        .astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    return xh, dt, a_log, bm, cm


@pytest.mark.parametrize("b,s,nh,hd,n,chunk", [
    (2, 32, 8, 32, 8, 16),       # reduced zamba2's mixer, two chunks
    (1, 40, 4, 16, 64, 16),      # full width's N = 64, chunk halved to 8
])
def test_mamba2_scan_through_b4_layout_matches_chunked_scan(b, s, nh, hd,
                                                            n, chunk):
    """Mamba-2's recurrence as B4 takes it (dt and A given per channel)
    against repro's chunked associative scan over the (B, S, nh, hd, N)
    bx it builds, y summed over N after the scan as repro does."""
    xh, dt, a_log, bm, cm = _scan_inputs(np.random.default_rng(3), b, s,
                                         nh, hd, n)
    a_bar = jnp.exp(jnp.asarray(dt) * -jnp.exp(jnp.asarray(a_log)))
    bx = (jnp.asarray(dt)[..., None, None]
          * jnp.asarray(xh).reshape(b, s, nh, hd)[..., None]
          * jnp.asarray(bm)[:, :, None, None, :])
    a_full = a_bar[..., None, None] * jnp.ones((1, 1, 1, hd, n))
    hs, jh = JL._chunked_ssm_scan(a_full, bx, chunk)
    jy = (hs * jnp.asarray(cm)[:, :, None, None, :]).sum(-1)
    dt_c, a = expand_heads(torch.from_numpy(dt),
                           -torch.exp(torch.from_numpy(a_log)), hd, n)
    assert dt_c.is_contiguous() and a.is_contiguous()
    assert dt_c.shape == (b, s, nh * hd) and a.shape == (nh * hd, n)
    assert dt_c.dtype == a.dtype == torch.float32
    y, h = ssm_scan_plain(torch.from_numpy(xh), dt_c, a,
                          torch.from_numpy(bm), torch.from_numpy(cm))
    np.testing.assert_allclose(y.reshape(b, s, nh, hd).numpy(),
                               np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.reshape(b, nh, hd, n).numpy(),
                               np.asarray(jh), **SCAN_TOL)


def _mixer(tree, i=0):
    return {k: v[i] for k, v in tree["client"]["blocks"]["mixer"].items()}


def test_mamba2_apply_prefill_and_decode(pair):
    jm, tm, jp, tp = pair
    cfg = tm.cfg
    x = np.random.default_rng(4).normal(size=(2, 13, cfg.d_model)) \
        .astype(np.float32)
    jmix = jax.tree_util.tree_map(lambda v: v[0],
                                  jp["client"]["blocks"]["mixer"])
    jy, jst = JL.mamba2_apply(jmix, jnp.asarray(x), jm.cfg,
                              return_state=True)
    ops.reset_launches()
    ty, tst = TL.mamba2_apply(_mixer(tp), torch.from_numpy(x), cfg,
                              return_state=True)
    assert ops.launch_counts()["selective_scan"] == 0      # CPU: plain
    _close(ty, jy, MIXER_ATOL)
    for k in ("conv", "ssm"):
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k], jst[k], MIXER_ATOL)
    assert tst["ssm"].dtype == torch.float32
    _close(TL.mamba2_apply(_mixer(tp), torch.from_numpy(x), cfg), jy,
           MIXER_ATOL)
    jstate, tstate = jst, {k: v.clone() for k, v in tst.items()}
    for i in range(3):
        xt = np.random.default_rng(10 + i).normal(
            size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = JL.mamba2_apply(jmix, jnp.asarray(xt), jm.cfg,
                                     state=jstate)
        ty, tstate = TL.mamba2_apply(_mixer(tp), torch.from_numpy(xt), cfg,
                                     state=tstate)
        _close(ty, jy, MIXER_ATOL)
        for k in ("conv", "ssm"):
            _close(tstate[k], jstate[k], MIXER_ATOL)


# ------------------------------------------------------------ the model

def test_prefill_caches_and_decode_match_repro(pair):
    jm, tm, jp, tp = pair
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 21)).astype(np.int32)
    jl, jc, jpos = jax.jit(functools.partial(jm.prefill, cache_len=32))(
        jp, {"tokens": jnp.asarray(toks)})
    ops.reset_launches()
    tl, tc, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              cache_len=32)
    assert int(jpos) == tpos == 21
    _close(tl, jl)
    assert sorted(tc) == sorted(jc)
    for side in jc:
        for a, b in zip(jax.tree_util.tree_leaves(jc[side]),
                        tree_leaves(tc[side])):
            assert tuple(b.shape) == a.shape
            assert b.dtype == (torch.float32 if a.dtype == jnp.float32
                               else b.dtype)
            _close(b, a)
    tok = np.array([[3], [5]], np.int32)
    pos = np.array([21, 21], np.int32)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc2 = tm.decode_step(tp, tc, torch.tensor(tok), torch.tensor(pos))
        assert tc2 is tc                      # state written in place
        _close(tl, jl)
        for side in jc:
            for a, b in zip(jax.tree_util.tree_leaves(jc[side]),
                            tree_leaves(tc[side])):
                _close(b, a)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = pos + 1


def _batch(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    w = np.ones((b, s), np.float32)
    w[1, : s // 3] = 0.0
    host = {"tokens": toks[:, :s], "labels": toks[:, 1:], "weights": w}
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


def test_loss_metrics_and_grads_match_repro(pair):
    """The training forward on the CPU, where the Mamba-2 scan runs B4's
    plain version and autograd differentiates it."""
    jm, tm, jp, _ = pair
    jb, tb = _batch(jm.cfg.vocab_size)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, jb)
    (tl, tmet), tg = tpsl.value_and_grad(
        tm.loss_fn, tpsl.requires_grad_(tckpt.from_numpy_tree(jp, "cpu")),
        tb)
    assert sorted(tmet) == sorted(jmet)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert float(tmet["aux_loss"]) == 0.0
    assert_grads(tg, jg)


def test_psl_split_matches_repro(pair):
    """client_forward then server_loss (the server's pre-blocks, shared
    attention and superblocks) against repro's."""
    jm, tm, jp, tp = pair
    jb, tb = _batch(jm.cfg.vocab_size, seed=1)
    jacts = jm.client_forward(jp, jb)
    tacts = tm.client_forward(tp, tb)
    _close(tacts, jacts)
    jl = jm.server_loss(jp["server"], jacts, jb)
    tl = tm.server_loss(tp["server"], torch.tensor(np.asarray(jacts)),
                        tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)


def test_paged_decode_rejects_hybrid(pair):
    _, tm, _, tp = pair
    with pytest.raises(NotImplementedError, match="attention-cache"):
        tm.decode_step_paged(tp, {}, torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32),
                             torch.zeros((1, 1), dtype=torch.int32))


# ------------------------------------------------------------ engines

def _spec(pkg, engine="continuous", layers=5):
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch=ARCH, reduced=True,
                            overrides={"num_layers": layers}),
        engine=pkg.EngineSpec(name=engine, num_slots=4, slot_len=48),
        admission=pkg.AdmissionSpec(token_budget=4),
        workload=pkg.WorkloadSpec(num_requests=6, prompt_lens=[5, 9, 17],
                                  max_new_tokens=[4, 9]),
        clock=pkg.ClockSpec(kind="virtual"),
        draft=pkg.DraftSpec(num_layers=1) if engine == "speculative"
        else pkg.DraftSpec())


def test_continuous_engine_matches_repro(pair):
    jm, tm, jp, tp = pair
    layers = tm.cfg.num_layers
    jspec, tspec = _spec(japi, layers=layers), _spec(tapi, layers=layers)
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
def test_paged_engines_refuse_the_hybrid_as_repro_does(engine):
    with pytest.raises(NotImplementedError) as jerr:
        japi.build_serve_context(_spec(japi, engine))
    with pytest.raises(NotImplementedError) as terr:
        tapi.build_serve_context(_spec(tapi, engine), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "continuous engine" in str(terr.value)


def test_serve_cli_serves_zamba2_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--set", "engine.name=continuous",
                    "--device", "cpu", "--requests", "3", "--verify", "-1"])
    out = capsys.readouterr().out
    assert "arch=zamba2-2.7b-reduced [continuous] 3 requests" in out
    assert "verified token-identical: 3 requests" in out


# ------------------------------------------------------------ weights

def test_checkpoint_carries_repro_params_key_for_key(tmp_path):
    """A bf16 zamba2 (6 layers) saved by repro restores into the port bit
    for bit, under repro's flat keys: the double-stacked superblocks,
    the shared attention, the pre-blocks and the fp32 leaves."""
    jc, tc = _configs(6)
    jm = jbuild(dataclasses.replace(jc, dtype="bfloat16"))
    jp = jm.init(jax.random.PRNGKey(5))
    path = str(tmp_path / "params.npz")
    jckpt.save(path, jp)
    with np.load(path) as z:
        keys = set(z.files)
    assert "server/superblocks/mixer/in_proj" in keys
    assert "server/shared_attn/attn/wq" in keys
    assert "server/pre_blocks/mixer/a_log" in keys
    tp = tckpt.restore(path, device="cpu")
    tm = tbuild(dataclasses.replace(tc, dtype="bfloat16"))
    shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                    tm.param_specs(), is_leaf=_is_spec)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp) == shapes
    mixer = tp["server"]["superblocks"]["mixer"]
    assert mixer["a_log"].dtype == mixer["dt_bias"].dtype \
        == mixer["d_skip"].dtype == torch.float32
    assert mixer["in_proj"].dtype == torch.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
