"""The selective scan's forward in Mamba-2's layout (one decay a head), on
the CPU: the per-head forward's plain version (``ssm_scan_heads_plain``,
the function the per-head B4 kernel computes and its on-card oracle), and
``ops.selective_scan_heads`` on CPU tensors.

Inputs come from numpy seeds. Against ``repro``'s Mamba-2 scan
(``_chunked_ssm_scan`` on ``mamba2_apply``'s a_full and bx, then C's
contraction) in float32: atol 1e-5 after division by the output's
largest magnitude (at least 1), as ``tests/test_torch_ssm_heads.py``
holds the backward (the same products; repro's chunks associate the
recurrence in another order). Against B4's plain version on
``expand_heads``' inputs: bit for bit, in float32 and bf16 (the same
products in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import (expand_heads, heads_fwd_exp_count,
                                          ssm_scan_heads_plain,
                                          ssm_scan_plain)
from torch_one_thread import one_torch_thread  # noqa: F401

ATOL = 1e-5
# (B, L, heads, channels a head, N), as tests/test_torch_ssm_heads.py's
SHAPES = [
    (2, 21, 3, 8, 16),      # ragged L: past two 8-step chunks
    (2, 16, 2, 32, 8),      # the reduced zamba2's hd and N
    (1, 12, 3, 5, 5),       # hd and N not powers of two
]


def _inputs(seed, b, l, nh, hd, n):
    """x, dt (softplus), a = -exp(a_log) with a_log = log(1..nh) + noise
    (repro's init, perturbed), B, C; float32 numpy."""
    rng = np.random.default_rng(seed)
    d = nh * hd
    x = rng.normal(size=(b, l, d))
    dt = np.log1p(np.exp(rng.normal(size=(b, l, nh)) - 1.0))
    a = -np.exp(np.log(np.arange(1, nh + 1)) + 0.1 * rng.normal(size=nh))
    bm, cm = rng.normal(size=(b, l, n)), rng.normal(size=(b, l, n))
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm)]


@jax.jit
def _ref_heads(x, dt, a, bm, cm):
    """repro's Mamba-2 scan: mamba2_apply's a_bar, bx and a_full into
    _chunked_ssm_scan, y = hs . C, h_last as (B, D, N)."""
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
    return y.reshape(b, l, d), h_last.reshape(b, d, n)


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,l,nh,hd,n", SHAPES)
def test_heads_plain_matches_repro_chunked_scan(b, l, nh, hd, n):
    ins = _inputs(l + 3 * hd, b, l, nh, hd, n)
    want_y, want_h = _ref_heads(*(jnp.asarray(v) for v in ins))
    y, h = ssm_scan_heads_plain(*(torch.from_numpy(v) for v in ins))
    assert y.dtype == h.dtype == torch.float32
    _close(y, want_y)
    _close(h, want_h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,nh,hd,n", SHAPES)
def test_heads_plain_is_b4_plain_on_the_expanded_inputs(b, l, nh, hd, n,
                                                        dtype):
    """Bit for bit: e once a (b, t, head) broadcast is B4's per-channel
    exp(dt a) on expand_heads' inputs, each product and sum the same."""
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in
                        _inputs(2 * l + hd, b, l, nh, hd, n))
    x, bm, cm = x.to(dtype), bm.to(dtype), cm.to(dtype)
    y, h = ssm_scan_heads_plain(x, dt, a, bm, cm)
    ry, rh = ssm_scan_plain(x, *expand_heads(dt, a, hd, n), bm, cm)
    assert torch.equal(y, ry) and torch.equal(h, rh)


def test_selective_scan_heads_on_the_cpu_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version (under no_grad
    and under grad alike) and counts no launch."""
    b, l, nh, hd, n = SHAPES[0]
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in
                        _inputs(1, b, l, nh, hd, n))
    ops.reset_launches()
    with torch.no_grad():
        y, h = ops.selective_scan_heads(x, dt, a, bm, cm)
    py, ph = ssm_scan_heads_plain(x, dt, a, bm, cm)
    assert torch.equal(y, py) and torch.equal(h, ph)
    xg = x.clone().requires_grad_(True)
    y, _ = ops.selective_scan_heads(xg, dt, a, bm, cm)
    torch.autograd.grad(y.sum(), xg)
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.parametrize("b,nh,n,hd,blocks_a_head", [
    (16, 80, 64, 64, 1),   # zamba2's training shape: a 64-channel block a head
    (4, 80, 64, 64, 1),    # four prompts: 320 blocks
    (1, 80, 64, 64, 4),    # one prompt: 16-channel blocks, 320 of them
    (8, 8, 8, 32, 1),      # the reduced zamba2: four heads a block
    (3, 12, 5, 5, 1),      # ragged: whole heads a block
    (16, 40, 64, 80, 2),   # 64-channel tiles: two a head
    (2, 3, 64, 200, 13),   # a small grid: 16-channel tiles
])
def test_heads_fwd_exp_count_formula(b, nh, n, hd, blocks_a_head):
    """The per-head kernel's stated count: one exponential a (b, t, head)
    for each block that owns some of the head's channels, between B L nh
    and B L nh ceil(hd / 8)."""
    l = 7
    got = heads_fwd_exp_count(b, l, nh, hd, n)
    assert got == b * l * nh * blocks_a_head
    assert b * l * nh <= got <= b * l * nh * -(-hd // 8)
