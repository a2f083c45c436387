"""The port's kernel modules against repro's oracles and Pallas kernels.

On the CPU the port's wrappers run each kernel's plain PyTorch version;
these tests hold those plain versions against ``repro.kernels.ref`` and
against the Pallas kernels in interpret mode, on the same numpy inputs
and sweeps as tests/test_kernels.py. Tolerances: float32 atol 2e-5
(rtol 1e-4); bfloat16 atol/rtol 2e-2 — the port keeps probabilities in
fp32 for P.V as the TPU kernel does, while ``blockwise_attention`` and
the oracles round them to bf16 first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.models.layers import blockwise_attention as jax_blockwise
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (combine_partials_plain,
                                                 paged_attention,
                                                 paged_attention_plain,
                                                 split_partials_plain)
from repro_torch.kernels.ssm_scan import (ssm_scan_heads,
                                          ssm_scan_heads_bwd)
from torch_one_thread import one_torch_thread  # noqa: F401

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


def _pair(arr, jdt, tdt):
    """One numpy array as a JAX and a torch tensor of the same values."""
    j = jnp.asarray(arr, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 128, 8, 1, 128),    # MQA
])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_flash_attention_plain_sweep(dt, b, s, hq, hkv, d, causal, window):
    name, jdt, tdt = dt
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.normal(size=(b, hq, s, d)), jdt, tdt)
    kj, kt = _pair(rng.normal(size=(b, hkv, s, d)), jdt, tdt)
    vj, vt = _pair(rng.normal(size=(b, hkv, s, d)), jdt, tdt)
    got = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    want = jref.attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    pallas = pallas_flash(qj, kj, vj, causal=causal, window=window,
                          block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(name))
    # the port's transcribed oracle equals repro's
    np.testing.assert_allclose(
        _np(tref.attention_ref(qt, kt, vt, causal=causal, window=window)),
        _np(want), **_tol(name))


@pytest.mark.parametrize("dt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("s,window", [(50, None), (100, None), (100, 24),
                                      (1, None)])
def test_ragged_attention_matches_blockwise(dt, s, window):
    """Arbitrary prompt lengths through the model-layout wrapper, against
    repro's blockwise_attention (S == T, starts aligned)."""
    name, jdt, tdt = dt
    rng = np.random.default_rng(4)
    b, hq, hkv, d = 2, 8, 2, 16
    qj, qt = _pair(rng.normal(size=(b, s, hq, d)), jdt, tdt)
    kj, kt = _pair(rng.normal(size=(b, s, hkv, d)), jdt, tdt)
    vj, vt = _pair(rng.normal(size=(b, s, hkv, d)), jdt, tdt)
    got = ops.attention(qt, kt, vt, causal=True, window=window)
    want = jax_blockwise(qj, kj, vj, causal=True, window=window,
                         q_chunk=32, kv_chunk=32)
    assert got.shape == (b, s, hq, d) and got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("dt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("b,hq,hkv,d,psize,m", [
    (3, 4, 4, 64, 16, 5),    # MHA
    (2, 8, 2, 64, 8, 4),     # GQA 4:1
    (4, 8, 1, 32, 16, 3),    # MQA
])
def test_paged_attention_plain_sweep(dt, b, hq, hkv, d, psize, m):
    name, jdt, tdt = dt
    rng = np.random.default_rng(6)
    num_pages = b * m + 2
    qj, qt = _pair(rng.normal(size=(b, hq, d)), jdt, tdt)
    kj, kt = _pair(rng.normal(size=(num_pages, psize, hkv, d)), jdt, tdt)
    vj, vt = _pair(rng.normal(size=(num_pages, psize, hkv, d)), jdt, tdt)
    table = rng.permutation(num_pages)[:b * m].reshape(b, m).astype(
        np.int32)
    pos = rng.integers(0, m * psize, b).astype(np.int32)
    pos[0], pos[-1] = psize // 2, 0
    tt, tp = torch.from_numpy(table), torch.from_numpy(pos)
    got = paged_attention_plain(qt, kt, vt, tt, tp)
    want = jref.paged_attention_ref(qj, kj, vj, jnp.asarray(table),
                                    jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    pallas = pallas_paged(qj, kj, vj, jnp.asarray(table), jnp.asarray(pos),
                          interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(name))
    np.testing.assert_allclose(
        _np(tref.paged_attention_ref(qt, kt, vt, tt, tp)), _np(want),
        **_tol(name))
    # the model-layout wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(
        _np(ops.paged_attention(qt, kt, vt, tt, tp)), _np(got))


@pytest.mark.parametrize("dt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("shares", [1, 2, 3, 4, 7])
def test_paged_attention_warp_split_combines_to_plain(dt, shares):
    """The B2 kernel's arithmetic: keys dealt to `shares` warps in tiles,
    each with its own (m, l, acc), combined at the end. Rows end early
    (pos 0 and mid-page), so some shares lie wholly past pos: they must
    add nothing and give no NaN."""
    name, jdt, tdt = dt
    rng = np.random.default_rng(7)
    b, hq, hkv, d, psize, m, tile = 4, 8, 2, 16, 4, 6, 4
    num_pages = b * m + 1
    qj, qt = _pair(rng.normal(size=(b, hq, d)), jdt, tdt)
    kj, kt = _pair(rng.normal(size=(num_pages, psize, hkv, d)), jdt, tdt)
    vj, vt = _pair(rng.normal(size=(num_pages, psize, hkv, d)), jdt, tdt)
    table = rng.permutation(num_pages)[:b * m].reshape(b, m).astype(
        np.int32)
    pos = np.array([0, 5, 13, m * psize - 1], np.int32)
    tt, tp = torch.from_numpy(table), torch.from_numpy(pos)
    pm, pl, pacc = split_partials_plain(qt, kt, vt, tt, tp, shares, tile)
    assert pm.shape == (shares, b, hq) and pacc.shape == (shares, b, hq, d)
    empty = pl == 0
    if shares > 1:
        assert bool(empty.any())           # row 0 has one key: one share
    assert bool((pm[empty] == -1e30).all())
    assert bool((pacc[empty] == 0).all())
    got = combine_partials_plain(pm, pl, pacc, tdt)
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(
        _np(got), _np(paged_attention_plain(qt, kt, vt, tt, tp)),
        **_tol(name))
    np.testing.assert_allclose(
        _np(got), _np(jref.paged_attention_ref(
            qj, kj, vj, jnp.asarray(table), jnp.asarray(pos))),
        **_tol(name))


def test_paged_attention_combine_of_nothing_is_zero():
    """No share holds a visible key (every page id out of range): the
    combine divides 0 by the clamped 1e-20 and returns 0, as the kernel."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    pages = torch.from_numpy(rng.normal(size=(3, 4, 2, 8)).astype(
        np.float32))
    table = torch.tensor([[3, -1], [7, 3]], dtype=torch.int32)
    pos = torch.tensor([5, 0], dtype=torch.int32)
    pm, pl, pacc = split_partials_plain(q, pages, pages, table, pos, 4, 2)
    assert bool((pl == 0).all()) and bool((pm == -1e30).all())
    got = combine_partials_plain(pm, pl, pacc, q.dtype)
    assert torch.equal(got, torch.zeros_like(q))


def test_paged_attention_plain_masks_pages_outside_the_pool():
    """A page id outside [0, NP) masks its keys (it reads nothing): the
    row attends over its other visible keys only."""
    rng = np.random.default_rng(9)
    b, hq, hc, d, psize, m = 2, 4, 2, 8, 4, 3
    num_pages = 7
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(
        size=(num_pages, psize, hc, d)).astype(np.float32)) for _ in "kv")
    table = torch.tensor([[2, num_pages, 5], [4, -3, 1]], dtype=torch.int32)
    pos = torch.tensor([10, 9], dtype=torch.int32)
    got = paged_attention_plain(q, kp, vp, table, pos)
    for r in range(b):
        keys = [(int(table[r, k // psize]), k % psize)
                for k in range(int(pos[r]) + 1)
                if 0 <= int(table[r, k // psize]) < num_pages]
        k = torch.stack([kp[pg, i] for pg, i in keys])        # (K, Hc, D)
        v = torch.stack([vp[pg, i] for pg, i in keys])
        qr = q[r].reshape(hc, hq // hc, d)
        s = torch.einsum("hrd,khd->hrk", qr, k) / np.sqrt(d)
        want = torch.einsum("hrk,khd->hrd", torch.softmax(s, -1), v)
        torch.testing.assert_close(got[r], want.reshape(hq, d),
                                   atol=2e-5, rtol=1e-4)


def test_cpu_wrappers_do_not_count_launches():
    ops.reset_launches()
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(1, 9, 4, 16)).astype(np.float32))
    ops.attention(q, q, q)
    ops.paged_attention(q[:, 0].contiguous(), q.reshape(9, 1, 4, 16),
                        q.reshape(9, 1, 4, 16),
                        torch.zeros((1, 2), dtype=torch.int32),
                        torch.zeros((1,), dtype=torch.int32))
    # the training wrappers too: forward and backward on the CPU
    qg = q.clone().requires_grad_(True)
    h = qg.reshape(9 * 4, 16)
    nll, _, _ = ops.cross_entropy(h, h[:16].T.contiguous(),
                                  torch.zeros(36, dtype=torch.int32))
    torch.autograd.grad(nll.sum() + ops.attention(qg, qg, qg).sum(), qg)
    # and the serving wrappers of B3 and B4
    ops.spec_verify(q[:, :2].contiguous(), q.reshape(9, 1, 4, 16),
                    q.reshape(9, 1, 4, 16),
                    torch.zeros((1, 2), dtype=torch.int32),
                    torch.zeros((1, 2), dtype=torch.int32))
    x = q.reshape(1, 9, 64)
    ops.selective_scan(x, x.abs(), -torch.ones((64, 4)), x[:, :, :4],
                       x[:, :, 4:8])
    # and B4's backward, through the selective scan's Function
    xg = qg.reshape(1, 9, 64)
    y, _ = ops.selective_scan(xg, xg.abs(), -torch.ones((64, 4)),
                              xg[:, :, :4], xg[:, :, 4:8])
    torch.autograd.grad(y.sum(), qg)
    # and the per-head (Mamba-2) backward, through SelectiveScanHeads
    y, _ = ops.selective_scan_heads(xg, xg[:, :, :4].abs(),
                                    -torch.ones((4,)), xg[:, :, :4],
                                    xg[:, :, 4:8])
    torch.autograd.grad(y.sum(), qg)
    # and the vocab-parallel B5 (its backward is B5-bwd's wrapper)
    ops.cross_entropy_partials(h.detach(), h[:16].T.contiguous().detach(),
                               torch.full((36,), -1, dtype=torch.int32), 16)
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "paged_attention": 0,
                                   "spec_verify": 0,
                                   "selective_scan": 0,
                                   "selective_scan_bwd": 0,
                                   "selective_scan_heads": 0,
                                   "selective_scan_heads_bwd": 0,
                                   "cross_entropy": 0,
                                   "cross_entropy_bwd": 0,
                                   "cross_entropy_partials": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    """No silent fallback: a tensor neither on the CPU nor on CUDA raises."""
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_attention(q[:, 0], q, q, torch.empty((1, 1)),
                            torch.empty((1,)))


@pytest.mark.parametrize("which", ["flash", "paged", "ssm_scan_heads",
                                   "ssm_scan_heads_bwd"])
def test_kernel_launchers_reject_cpu_tensors(which):
    """The launchers take CUDA tensors only and check before building."""
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        if which == "flash":
            flash_attention(q, q, q)
        elif which == "ssm_scan_heads":
            ssm_scan_heads(torch.zeros((1, 4, 8)), torch.zeros((1, 4, 2)),
                           torch.zeros((2,)), torch.zeros((1, 4, 3)),
                           torch.zeros((1, 4, 3)))
        elif which == "ssm_scan_heads_bwd":
            x = torch.zeros((1, 4, 8))
            ssm_scan_heads_bwd(x, torch.zeros((1, 4, 2)), torch.zeros((2,)),
                               torch.zeros((1, 4, 3)),
                               torch.zeros((1, 4, 3)), x)
        else:
            paged_attention(q[:, 0], q, q,
                            torch.zeros((1, 1), dtype=torch.int32),
                            torch.zeros((1,), dtype=torch.int32))
