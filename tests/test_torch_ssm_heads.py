"""The selective scan's backward in Mamba-2's layout (one decay a head),
on the CPU: the per-head backward's plain version
(``ssm_scan_heads_bwd_plain``, the formulas the per-head B4-bwd kernel
implements and its on-card oracle) and the ``SelectiveScanHeads``
autograd Function that ``mamba2_apply`` trains through.

Inputs come from numpy seeds. Tolerances, float32: atol 1e-5 after
division by the gradient's largest magnitude (at least 1), as
``tests/test_torch_ssm_train.py`` holds B4-bwd's plain version (the same
products, summed in another order); bf16 gradients of x, B and C at
2^-8 of that scale (one bf16 rounding of the same fp32 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import (expand_heads, ssm_scan_bwd_plain,
                                          ssm_scan_heads_bwd_plain,
                                          ssm_scan_plain)
from torch_one_thread import one_torch_thread  # noqa: F401

GRAD_ATOL = 1e-5
NAMES = ("dx", "ddt", "da", "dB", "dC")
# (B, L, heads, channels a head, N)
SHAPES = [
    (2, 21, 3, 8, 16),      # ragged L: past two 8-step chunks
    (2, 16, 2, 32, 8),      # the reduced zamba2's hd and N
    (1, 12, 3, 5, 5),       # hd and N not powers of two
]


def _close(got, want, atol=GRAD_ATOL):
    """Agreement relative to the tensor's scale."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float())
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def _inputs(seed, b, l, nh, hd, n):
    """x, dt (softplus), a = -exp(a_log) with a_log = log(1..nh) + noise
    (repro's init, perturbed), B, C, dy, dh_last; float32 numpy."""
    rng = np.random.default_rng(seed)
    d = nh * hd
    x = rng.normal(size=(b, l, d))
    dt = np.log1p(np.exp(rng.normal(size=(b, l, nh)) - 1.0))
    a = -np.exp(np.log(np.arange(1, nh + 1)) + 0.1 * rng.normal(size=nh))
    bm, cm = rng.normal(size=(b, l, n)), rng.normal(size=(b, l, n))
    dy = rng.normal(size=(b, l, d))
    dh = rng.normal(size=(b, d, n))
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm, dy, dh)]


@jax.jit
def _ref_heads_grads(x, dt, a, bm, cm, dy, dh):
    """jax.grad of sum(y dy) + sum(h_last dh) through repro's Mamba-2 scan:
    mamba2_apply's a_bar, bx and a_full into _chunked_ssm_scan, then C's
    contraction; in (x, dt, a, B, C)."""
    def loss(x, dt, a, bm, cm):
        b, l, d = x.shape
        nh, n = a.shape[0], bm.shape[-1]
        hd = d // nh
        a_bar = jnp.exp(dt * a[None, None])
        xh = x.reshape(b, l, nh, hd)
        bx = dt[..., None, None] * xh[..., None] * bm[:, :, None, None, :]
        a_full = a_bar[..., None, None] * jnp.ones((1, 1, 1, hd, n),
                                                    jnp.float32)
        hs, h_last = JL._chunked_ssm_scan(a_full, bx, 8)
        y = (hs * cm[:, :, None, None, :]).sum(-1)
        return ((y.reshape(b, l, d) * dy).sum()
                + (h_last.reshape(b, d, n) * dh).sum())
    return jax.grad(loss, argnums=tuple(range(5)))(x, dt, a, bm, cm)


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh_last", "no_dh"])
@pytest.mark.parametrize("b,l,nh,hd,n", SHAPES)
def test_heads_bwd_plain_matches_jax_grad(b, l, nh, hd, n, with_dh):
    *ins, dy, dh = _inputs(l + hd, b, l, nh, hd, n)
    if not with_dh:
        dh = np.zeros_like(dh)
    want = _ref_heads_grads(*(jnp.asarray(v) for v in (*ins, dy, dh)))
    got = ssm_scan_heads_bwd_plain(*(torch.from_numpy(v) for v in ins),
                                   torch.from_numpy(dy),
                                   torch.from_numpy(dh) if with_dh else None)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        _close(g, w)


@pytest.mark.parametrize("b,l,nh,hd,n", SHAPES[:2])
def test_heads_bwd_plain_is_the_per_channel_plain_summed(b, l, nh, hd, n):
    """The per-head plain version against B4-bwd's (per channel) through
    expand_heads: dx, dB and dC alike, ddt summed over each head's
    channels, da over its channels and states."""
    x, dt, a, bm, cm, dy, dh = (torch.from_numpy(v) for v in
                                _inputs(7, b, l, nh, hd, n))
    got = ssm_scan_heads_bwd_plain(x, dt, a, bm, cm, dy, dh)
    dt_c, a_c = expand_heads(dt, a, hd, n)
    dx, ddt, da, dbm, dcm = ssm_scan_bwd_plain(x, dt_c, a_c, bm, cm, dy, dh)
    want = (dx, ddt.reshape(b, l, nh, hd).sum(-1),
            da.reshape(nh, hd * n).sum(-1), dbm, dcm)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _close(g, w.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_heads_function_matches_plain_autograd(dtype,
                                                              monkeypatch):
    """ops.selective_scan_heads under grad goes through
    SelectiveScanHeads, whose CPU backward is ssm_scan_heads_bwd_plain,
    and agrees with autograd through B4's plain version on the inputs
    expanded per channel (autograd sums d(dt) over each head's channels
    and da over its channels and states); h_last's gradient is used too.
    No kernel launches."""
    b, l, nh, hd, n = 2, 19, 3, 8, 16
    *ins, dy, dh = _inputs(5, b, l, nh, hd, n)
    calls = []
    plain_bwd = ops.ssm_scan_heads_bwd_plain

    def counted(*args):
        calls.append(args[6] is not None)
        return plain_bwd(*args)
    monkeypatch.setattr(ops, "ssm_scan_heads_bwd_plain", counted)

    def leaves():
        return [torch.tensor(v).to(dtype if i in (0, 3, 4) else torch.float32)
                .requires_grad_(True) for i, v in enumerate(ins)]

    def plain(x, dt, a, bm, cm):
        return ssm_scan_plain(x, *expand_heads(dt, a, hd, n), bm, cm)
    dyt, dht = torch.from_numpy(dy), torch.from_numpy(dh)
    ops.reset_launches()
    ts = leaves()
    y, h = ops.selective_scan_heads(*ts)
    assert type(y.grad_fn).__name__ == "SelectiveScanHeadsBackward"
    got = torch.autograd.grad((y * dyt).sum() + (h * dht).sum(), ts)
    ref_ts = leaves()
    ry, rh = plain(*ref_ts)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    want = torch.autograd.grad((ry * dyt).sum() + (rh * dht).sum(), ref_ts)
    for name, g, w, t in zip(NAMES, got, want, ts):
        assert g.shape == t.shape and g.dtype == w.dtype == t.dtype, name
        _close(g, w.float().numpy(), atol=GRAD_ATOL if dtype ==
               torch.float32 else 2 ** -8)
    # y alone (the training path): dh_last reaches the backward as None
    ts = leaves()
    y, _ = ops.selective_scan_heads(*ts)
    got_y = torch.autograd.grad((y * dyt).sum(), ts)
    want_y = ssm_scan_heads_bwd_plain(*(t.detach() for t in ts), dyt)
    for g, w in zip(got_y, want_y):
        assert torch.equal(g, w)
    assert calls == [True, False]
    assert all(v == 0 for v in ops.launch_counts().values())


def test_selective_scan_heads_without_grad_is_b4_on_the_expanded_inputs():
    """Serving: under no_grad the call is B4's forward on expand_heads'
    inputs, bit for bit, saves nothing and carries no grad_fn."""
    b, l, nh, hd, n = 1, 13, 2, 32, 8
    x, dt, a, bm, cm, _, _ = (torch.from_numpy(v) for v in
                              _inputs(3, b, l, nh, hd, n))
    x = x.requires_grad_(True)
    with torch.no_grad():
        y, h = ops.selective_scan_heads(x, dt, a, bm, cm)
        ry, rh = ops.selective_scan(x, *expand_heads(dt, a, hd, n), bm, cm)
    assert y.grad_fn is None and h.grad_fn is None
    assert torch.equal(y, ry) and torch.equal(h, rh)
