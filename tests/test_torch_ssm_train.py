"""SSM training in the port against repro's, on the CPU: the selective
scan's backward (B4-bwd's plain version, ``ssm_scan_bwd_plain``), the
``SelectiveScan`` autograd Function, the Mamba-1 and Mamba-2 gradients
and PSL-UGS training of reduced falcon-mamba-7b and zamba2-2.7b.

On the CPU ``ops.selective_scan`` under grad runs ``ssm_scan_plain``
forward and ``ssm_scan_bwd_plain`` backward, the formulas B4-bwd
implements on the card. Inputs and parameters come from numpy seeds
(``fan_in_params``: repro's init rules drawn with numpy, every matrix
at the std of its fan-in d_in and the conv and dt biases drawn, as
``tests/test_torch_hybrid.py`` does and says why; numpy, because
repro's eager init takes seconds a model). Tolerances, float32:

- ``ssm_scan_bwd_plain`` against ``jax.grad`` of ``ssm_scan_ref``: atol
  1e-5 after division by the gradient's largest magnitude (at least 1),
  as ``tests/test_torch_ssm.py`` holds the scan's gradient (the same
  products, summed in another order);
- the Function against autograd through ``ssm_scan_plain``: the same,
  and equal launch counts of 0 (no kernel on the CPU);
- Mamba-2's per-head d(dt_bias) and d(a_log), and every mixer leaf, and
  reduced falcon-mamba's per-leaf loss gradients against ``jax.grad``:
  ``test_torch_archs``' 3e-4 of the leaf's largest entry and L2 norm;
- two PSL-UGS ``api.run`` steps against ``repro.api.run``: per-step
  losses at rtol 1e-4 (AdamW trajectories from equal inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import get_config as jget
from repro.kernels import ref as jref
from repro.launch.train import default_lm_spec as j_default_lm_spec
from repro.models import build_model as jbuild
from repro.models import layers as JL
import repro_torch.api as tapi
from repro_torch import optim as toptim
from repro_torch.api import protocols as tprotocols
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import get_config as tget
from repro_torch.core import psl as tpsl
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import (bwd_exp_count, ssm_scan_bwd_plain,
                                          ssm_scan_plain)
from repro_torch.launch.train import default_lm_spec as t_default_lm_spec
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as TL
from test_torch_archs import assert_grads
from test_torch_hybrid import _configs as hybrid_configs
from torch_one_thread import one_torch_thread  # noqa: F401

GRAD_ATOL = 1e-5
LOSS_RTOL = 1e-4
NAMES = ("dx", "ddt", "da", "dB", "dC")


def _close(got, want, atol=GRAD_ATOL):
    """Agreement relative to the tensor's scale."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float())
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def fan_in_params(jm, seed=0):
    """Parameters for both packages from ``jm.param_specs()`` as numpy:
    zeros, ones, ``ssm_a`` (log(1..N) along the last axis) and the
    embedding (std 0.02) as repro's init makes them; every normal-init
    leaf at std 1/sqrt(d_in) (its last-but-one axis, or its only axis);
    conv_b and dt_bias drawn at std 0.02 and 0.5 so they take part."""
    leaves, tree = jax.tree_util.tree_flatten_with_path(
        jm.param_specs(), is_leaf=lambda s: hasattr(s, "axes"))
    rng = np.random.default_rng(seed)
    out = []
    for path, spec in leaves:
        shape, name = tuple(spec.shape), jax.tree_util.keystr(path)
        if name.endswith("['conv_b']"):
            leaf = 0.02 * rng.standard_normal(shape)
        elif name.endswith("['dt_bias']"):
            leaf = 0.5 * rng.standard_normal(shape)
        elif spec.init in ("zeros", "ones"):
            leaf = np.full(shape, float(spec.init == "ones"))
        elif spec.init == "ssm_a":
            leaf = np.broadcast_to(np.log(np.arange(1, shape[-1] + 1)),
                                   shape)
        elif spec.init == "embed":
            leaf = 0.02 * rng.standard_normal(shape)
        else:
            fan = shape[-2] if len(shape) > 1 else shape[-1]
            leaf = rng.standard_normal(shape) / np.sqrt(fan)
        out.append(np.ascontiguousarray(leaf, np.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def _scan_inputs(rng, b, l, d, n):
    x = rng.normal(size=(b, l, d))
    dt = np.log1p(np.exp(rng.normal(size=(b, l, d)) - 1.0))   # softplus
    a = -np.exp(np.log(np.arange(1, n + 1))[None].repeat(d, 0)
                + 0.1 * rng.normal(size=(d, n)))
    bm, cm = rng.normal(size=(b, l, n)), rng.normal(size=(b, l, n))
    dy = rng.normal(size=(b, l, d))
    dh = rng.normal(size=(b, d, n))
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm, dy, dh)]


# ------------------------------------------------- B4-bwd's plain version

@jax.jit
def _ref_scan_grads(x, dt, a, bm, cm, dy, dh):
    """jax.grad of sum(y dy) + sum(h_last dh) through ssm_scan_ref, in
    (x, dt, a, B, C); one compilation a shape."""
    def loss(*args):
        y, h = jref.ssm_scan_ref(*args)
        return (y * dy).sum() + (h * dh).sum()
    return jax.grad(loss, argnums=tuple(range(5)))(x, dt, a, bm, cm)


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh_last", "no_dh"])
@pytest.mark.parametrize("b,l,d,n", [
    (2, 21, 12, 5),       # ragged L (past one 16-step chunk) and N
    (1, 40, 16, 16),      # falcon-mamba's N
    (3, 8, 8, 64),        # zamba2's N, one short chunk
])
def test_scan_bwd_plain_matches_jax_grad(b, l, d, n, with_dh):
    *ins, dy, dh = _scan_inputs(np.random.default_rng(l + n), b, l, d, n)
    if not with_dh:
        dh = np.zeros_like(dh)
    want = _ref_scan_grads(*(jnp.asarray(v) for v in (*ins, dy, dh)))
    got = ssm_scan_bwd_plain(*(torch.from_numpy(v) for v in ins),
                             torch.from_numpy(dy),
                             torch.from_numpy(dh) if with_dh else None)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        _close(g, w)


@pytest.mark.parametrize("l,per_pair", [
    (1, 1), (4, 4), (5, 9), (8, 12), (37, 73),
    (128, 252),          # falcon-mamba's training L: 1.97 a state-step
])
def test_scan_bwd_exp_count_formula(l, per_pair):
    """B4-bwd's stated count: per (b, d, n) pair one exponential a step of
    the first pass over every 4-step sub-chunk but the last, and one a
    step of the second pass; at falcon-mamba's training shape below the
    first version's 771.8 M."""
    assert bwd_exp_count(2, l, 3, 5) == 2 * 3 * 5 * per_pair
    if l == 128:
        assert bwd_exp_count(16, l, 8192, 16) == 528_482_304 < 771.8e6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_function_matches_plain_autograd(dtype, monkeypatch):
    """ops.selective_scan under grad goes through SelectiveScan, whose CPU
    backward is ssm_scan_bwd_plain, and agrees with autograd through the
    plain forward; h_last's gradient is used too. No kernel launches."""
    *ins, dy, dh = _scan_inputs(np.random.default_rng(5), 2, 19, 24, 16)
    calls = []
    plain_bwd = ops.ssm_scan_bwd_plain

    def counted(*args):
        calls.append(args[6] is not None)
        return plain_bwd(*args)
    monkeypatch.setattr(ops, "ssm_scan_bwd_plain", counted)

    def leaves():
        return [torch.tensor(v).to(dtype if i in (0, 3, 4) else torch.float32)
                .requires_grad_(True) for i, v in enumerate(ins)]
    dyt, dht = torch.from_numpy(dy), torch.from_numpy(dh)
    ops.reset_launches()
    ts = leaves()
    y, h = ops.selective_scan(*ts)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    got = torch.autograd.grad((y * dyt).sum() + (h * dht).sum(), ts)
    ref_ts = leaves()
    ry, rh = ssm_scan_plain(*ref_ts)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    want = torch.autograd.grad((ry * dyt).sum() + (rh * dht).sum(), ref_ts)
    for name, g, w, t in zip(NAMES, got, want, ts):
        assert g.dtype == w.dtype == t.dtype, name
        _close(g, w.float().numpy(), atol=GRAD_ATOL if dtype ==
               torch.float32 else 2 ** -8)
    # y alone (the training path): dh_last reaches the backward as None
    ts = leaves()
    y, _ = ops.selective_scan(*ts)
    got_y = torch.autograd.grad((y * dyt).sum(), ts)
    want_y = ssm_scan_bwd_plain(*(t.detach() for t in ts), dyt)
    for g, w in zip(got_y, want_y):
        assert torch.equal(g, w)
    assert calls == [True, False]
    assert all(v == 0 for v in ops.launch_counts().values())
    with torch.no_grad():
        y, h = ops.selective_scan(*leaves())
    assert y.grad_fn is None and h.grad_fn is None


# ------------------------------------------------- the Mamba-2 layout

def test_mamba2_per_head_gradients_match_repro(monkeypatch):
    """A Mamba-2 mixer's gradients through ops.selective_scan_heads: its
    backward (SelectiveScanHeads, the per-head B4-bwd's plain version on
    the CPU) returns ddt per head and da per head, which autograd carries
    into d(dt_bias) and d(a_log); every leaf against jax.grad through
    repro's mamba2_apply. The per-channel backward does not run."""
    calls = []
    plain_bwd = ops.ssm_scan_heads_bwd_plain

    def counted(*args):
        calls.append(tuple(args[0].shape) + tuple(args[1].shape)
                     + tuple(args[2].shape))
        return plain_bwd(*args)

    def per_channel(*args):
        raise AssertionError("the per-channel backward ran")
    monkeypatch.setattr(ops, "ssm_scan_heads_bwd_plain", counted)
    monkeypatch.setattr(ops, "ssm_scan_bwd_plain", per_channel)
    jc, tc = hybrid_configs(5)
    jm = jbuild(jc)
    jp = fan_in_params(jm)
    jmix = jax.tree_util.tree_map(lambda v: np.asarray(v[0]),
                                  jp["client"]["blocks"]["mixer"])
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 21, jc.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 21, jc.d_model)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: (JL.mamba2_apply(p, jnp.asarray(x),
                                                     jm.cfg) * w).sum()))(
        jax.tree_util.tree_map(jnp.asarray, jmix))
    names = sorted(jmix)
    tmix = {k: torch.tensor(jmix[k]).requires_grad_(True) for k in names}
    out = TL.mamba2_apply(tmix, torch.from_numpy(x), tc)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                             [tmix[k] for k in names])
    nh = tc.ssm_num_heads
    assert calls == [(2, 21, tc.d_inner, 2, 21, nh, nh)]
    assert tmix["dt_bias"].shape == tmix["a_log"].shape \
        == (tc.ssm_num_heads,)
    for k, g in zip(names, tg):
        assert float(np.abs(np.asarray(jg[k])).max()) > 0, k
        assert_grads([g], [jg[k]])


# ------------------------------------------------- Mamba-1 model gradients

def test_falcon_mamba_per_leaf_gradients_match_repro():
    jm = jbuild(jget("falcon-mamba-7b", reduced=True))
    tm = tbuild(tget("falcon-mamba-7b", reduced=True))
    jp = fan_in_params(jm)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jm.cfg.vocab_size, (2, 25)).astype(np.int32)
    weights = np.ones((2, 24), np.float32)
    weights[1, :8] = 0.0
    host = {"tokens": toks[:, :24], "labels": toks[:, 1:],
            "weights": weights}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in host.items()})
    (tl, _), tg = tpsl.value_and_grad(
        tm.loss_fn, tpsl.requires_grad_(from_numpy_tree(jp, "cpu")),
        {k: torch.from_numpy(v) for k, v in host.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads(tg, jg)


# ------------------------------------------------- PSL-UGS training

def _train_sets(arch):
    return [f"model.arch={arch}", "model.reduced=true",
            "execution.max_steps=2", "protocol.global_batch_size=8",
            "data.seq_len=32", "data.sequences=256", "sampler.method=ugs"]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_psl_run_matches_repro(arch, monkeypatch):
    jspec = japi.apply_overrides(j_default_lm_spec(), _train_sets(arch))
    tspec = tapi.apply_overrides(t_default_lm_spec(), _train_sets(arch))
    assert tspec.to_dict() == jspec.to_dict()
    jm = jbuild(jget(arch, reduced=True))
    jp = fan_in_params(jm, jspec.seed)
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
    ops.reset_launches()
    tres = tapi.run(tspec, device="cpu")
    assert all(v == 0 for v in ops.launch_counts().values())
    assert len(tres.step_metrics) == len(jres.step_metrics) == 2
    for t, j in zip(tres.step_metrics, jres.step_metrics):
        assert np.isfinite(t["loss"]) and np.isfinite(t["grad_norm"])
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["tokens"], j["tokens"], rtol=0)
