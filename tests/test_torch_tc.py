"""What surrounds the tensor-core kernels, on the CPU.

The wgmma kernels (B1 forward and backward, B5 forward and backward in
bf16/fp16) run only on the card; here the code around them is checked:
the dtype dispatch rule, the W row padding of B5 (made once a step by
``ops.CrossEntropy``), the size of the B5-bwd ds scratch and the B5
forward's vocab splits, and plain-PyTorch emulations of how the kernels
compute: B1 feeds P to P.V as two parts in the input dtype (P rounded and
the remainder); B1-bwd feeds P (to dV) and dS (to dQ and dK) the same
way; B5-bwd rounds the softmax part of ds to the input dtype before the
dh and dW products and keeps its one-hot part exact; the B5 forward folds
128-column logit tiles into per-row partials (columns past V, which TMA
fills with zeros, left out) and combines its splits in order. They are
held in bf16 against ``repro``'s ``blockwise_attention`` (and
``jax.grad`` of it), ``jax.grad`` of ``chunked_xent``, the Pallas
``fused_cross_entropy`` in interpret mode and ``repro.kernels.ref``, and
against the port's plain versions at the card tests' shapes.

Margins (measured on these inputs): the attention emulation is within
7.8e-3 (one bf16 ulp at |x| < 2, where fp32 sums round differently) of
the plain version and within 1.6e-2 of ``blockwise_attention`` (which
rounds P once; the plain version is as far from it), under the card
tests' 2e-2 + 2e-2 |x|; the ds-rounded gradients are within
relative L2 1.4e-3 of ``jax.grad`` and 2.9e-3 of the plain backward (as
far as the plain backward is from ``jax.grad``, whose logits are bf16),
under the 2e-2 gradient limit of ``chip_smoke.py`` ([grads]).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.cross_entropy import fused_cross_entropy
from repro.models.layers import blockwise_attention as jax_blockwise
from repro.models.transformer import chunked_xent as jchunked_xent
from repro_torch.kernels import cross_entropy as xent
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 uses_tensor_cores)
from torch_one_thread import one_torch_thread  # noqa: F401

CARD_TOL = 2e-2           # bf16 atol/rtol of tests/test_torch_gpu.py
GRAD_REL_L2 = 2e-2        # chip_smoke.py's [grads] limit
XENT_FP32_TOL = dict(atol=2e-4, rtol=1e-4)   # chip_smoke.py's B5 nll/lse


def test_dispatch_rule_sends_16_bit_types_to_the_tensor_cores():
    assert uses_tensor_cores(torch.bfloat16)
    assert uses_tensor_cores(torch.float16)
    assert not uses_tensor_cores(torch.float32)   # TF32 would break 2e-5
    assert xent.uses_tensor_cores is uses_tensor_cores


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("v,v_pad", [(509, 512), (8300, 8304),
                                     (49155, 49160), (512, 512),
                                     (4096, 4096)])
def test_vocab_padding_round_trips(dtype, v, v_pad):
    """Odd V gets rows padded to 16 bytes (zeros past V); a V that is a
    multiple of 8 is handed over as it is, without a copy."""
    w = torch.randn((24, v), generator=torch.Generator().manual_seed(v)
                    ).to(dtype)
    assert xent.padded_vocab(v, dtype) == v_pad
    wp = xent.pad_vocab(w)
    assert wp.shape == (24, v_pad)
    assert (wp.stride(0) * wp.element_size()) % 16 == 0
    assert wp.data_ptr() % 16 == 0
    assert torch.equal(wp[:, :v], w)
    if v == v_pad:
        assert wp is w
    else:
        assert not wp[:, v:].any()


def test_vocab_padding_of_a_misaligned_view_copies():
    base = torch.zeros((8, 513), dtype=torch.bfloat16)
    w = base.view(-1)[1:1 + 8 * 512].view(8, 512)   # 2 bytes off
    wp = xent.pad_vocab(w)
    assert wp is not w and wp.data_ptr() % 16 == 0
    assert torch.equal(wp[:, :512], w)


@pytest.mark.parametrize("t,v,chunk", [(2048, 49155, 8192), (7, 100, 128),
                                       (2048, 8300, 8192), (37, 509, 512)])
def test_ds_chunk_for_two_byte_ds(t, v, chunk):
    """The chunk rule counts elements, so 2-byte ds (the tensor-core
    backward's) halves the scratch: 32 MB at the training shape against
    the fp32 backward's 64 MB."""
    assert xent.ds_chunk(t, v) == chunk
    assert chunk % 64 == 0 and t * chunk <= max(16 * 2 ** 20, t * 64)
    if (t, v) == (2048, 49155):
        assert t * chunk * 2 == 32 * 2 ** 20


def test_label_index_lists_the_tokens_of_each_label_in_order():
    labels = torch.tensor([5, 0, 5, 3, 0, 5, 9], dtype=torch.int32)
    order, starts = xent.label_index(labels, 10)
    assert order.dtype == starts.dtype == torch.int32
    assert starts.tolist() == [0, 2, 2, 2, 3, 3, 6, 6, 6, 6, 7]
    assert order.tolist() == [1, 4, 3, 0, 2, 5, 6]
    for c in range(10):
        toks = order[starts[c]:starts[c + 1]].tolist()
        assert toks == [t for t in range(7) if labels[t] == c]


# --- emulation of the new roundings ------------------------------------------

def attention_p_rounded(q, k, v, *, causal=True, window=None):
    """B1 as the tensor-core kernel rounds it: fp32 scores and softmax
    statistics, P fed to P.V as two parts in the input dtype (P rounded,
    then the remainder), fp32 sums. q (B, Hq, S, D), k/v (B, Hkv, T, D)."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    qp = torch.arange(q.shape[2])[:, None]
    kp = torch.arange(k.shape[2])[None, :]
    mask = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.to(q.dtype).float()
    lo = (p - hi).to(q.dtype).float()
    out = (torch.matmul(hi, vf) + torch.matmul(lo, vf)) \
        / p.sum(-1, keepdim=True)
    return out.to(q.dtype)


def cross_entropy_bwd_ds_rounded(h, w, labels, lse, g):
    """B5-bwd as the tensor-core kernel rounds it: fp32 logits; the
    softmax part of ds, exp(s - lse) g, rounded to the input dtype; fp32
    products; the one-hot part (-g at each label) applied in fp32; one
    final rounding."""
    soft = (torch.exp(torch.matmul(h.float(), w.float()) - lse[:, None])
            * g[:, None]).to(h.dtype).float()
    lab = labels.long()
    dh = torch.matmul(soft, w.float().T) - g[:, None] * w.float()[:, lab].T
    dw = torch.matmul(h.float().T, soft)
    dw.index_add_(1, lab, -(g[:, None] * h.float()).T)
    return dh.to(h.dtype), dw.to(w.dtype)


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window", [
    (2, 17, 17, 8, 2, 8, True, None),
    (2, 17, 17, 8, 2, 24, True, None),
    (2, 512, 512, 8, 2, 40, True, None),
    (1, 512, 512, 8, 2, 128, True, None),
    (16, 128, 128, 32, 8, 64, True, None),    # the training shape
    (2, 300, 300, 8, 2, 64, True, 100),
    (1, 70, 70, 8, 1, 32, False, None),
])
def test_two_part_p_matches_plain_and_blockwise_attention(b, s, t, hq, hkv, d, causal,
                                                window):
    """bf16: the kernel's two-part P against the plain version (P in
    fp32) and against repro's blockwise_attention (which rounds P to v's
    dtype per 64-key chunk): both within the card tests' 2e-2."""
    rng = np.random.default_rng(s + d)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in (
        (b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_blockwise(jq, jk, jv, causal=causal,
                                    window=window, q_chunk=64,
                                    kv_chunk=64).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2)
                  for x in (q, k, v))
    got = attention_p_rounded(tq, tk, tv, causal=causal,
                              window=window).transpose(1, 2)
    plain = flash_attention_plain(tq, tk, tv, causal=causal,
                                  window=window).transpose(1, 2)
    np.testing.assert_allclose(got.float().numpy(), want, atol=CARD_TOL,
                               rtol=CARD_TOL)
    torch.testing.assert_close(got.float(), plain.float(), atol=CARD_TOL,
                               rtol=CARD_TOL)
    # two-part P is the plain version's fp32 P to within a bf16 ulp
    assert _max_err(got, plain) <= 2 ** -7


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("t,d,v", [(37, 24, 509), (200, 64, 512),
                                   (300, 128, 4096), (512, 32, 8300)])
def test_ds_rounding_matches_jax_grad_of_chunked_xent(t, d, v):
    """bf16: the kernel's rounding of ds against jax.grad of repro's
    chunked_xent (bf16 logits; its cotangent, the whole ds, is bf16) and
    against the plain backward (ds in fp32): relative L2 of dh and dW
    under the 2e-2 gradient limit, and elementwise within the card
    tests' 2e-2 of the plain backward."""
    rng = np.random.default_rng(t + v)
    h = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    weights = rng.uniform(0, 2, size=t).astype(np.float32)

    def jloss(hh, ww):
        return jchunked_xent(hh[None], ww, jnp.asarray(labels)[None],
                             jnp.asarray(weights)[None])[0]

    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    th, tw = (torch.from_numpy(x).to(torch.bfloat16) for x in (h, w))
    tl = torch.from_numpy(labels)
    _, lse, _ = xent.cross_entropy_fwd_plain(th, tw, tl)
    g = torch.from_numpy(weights) / float(weights.sum())
    dh, dw = cross_entropy_bwd_ds_rounded(th, tw, tl, lse, g)
    pdh, pdw = xent.cross_entropy_bwd_plain(th, tw, tl, lse, g)
    for got, jwant, pwant in ((dh, jdh, pdh), (dw, jdw, pdw)):
        assert got.dtype == torch.bfloat16
        jwant = np.asarray(jwant.astype(jnp.float32))
        assert _rel_l2(got.float().numpy(), jwant) <= GRAD_REL_L2 / 2
        assert _rel_l2(got.float().numpy(), pwant.float().numpy()) \
            <= GRAD_REL_L2 / 4
        torch.testing.assert_close(got.float(), pwant.float(),
                                   atol=CARD_TOL, rtol=CARD_TOL)


# --- B1 backward: P and dS in two parts --------------------------------------

def attention_bwd_two_part(q, k, v, out, dout, lse, *, causal=True,
                           window=None):
    """B1-bwd as the tensor-core kernels round it: fp32 scores, P =
    exp(s - lse) and dS = P (dP - delta) in fp32, P fed to dV and dS to
    dQ and dK as two parts in the input dtype (rounded, then the
    remainder), fp32 sums, one final rounding. Layout as
    flash_attention_bwd_plain's."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    qf, dof = q.float(), dout.float()
    qp = torch.arange(s)[:, None]
    kp = torch.arange(t)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    p = torch.where(mask, torch.exp(torch.matmul(qf, kf.transpose(-1, -2))
                                    * scale - lse[..., None]),
                    torch.zeros(()))
    delta = (dof * out.float()).sum(-1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])

    def two_parts(x):
        hi = x.to(q.dtype).float()
        return hi, (x - hi).to(q.dtype).float()

    p_hi, p_lo = two_parts(p)
    ds_hi, ds_lo = two_parts(ds)
    dv = (torch.matmul(p_hi.transpose(-1, -2), dof)
          + torch.matmul(p_lo.transpose(-1, -2), dof))
    dq = (torch.matmul(ds_hi, kf) + torch.matmul(ds_lo, kf)) * scale
    dk = (torch.matmul(ds_hi.transpose(-1, -2), qf)
          + torch.matmul(ds_lo.transpose(-1, -2), qf)) * scale
    if rep > 1:
        dk = dk.reshape(b, hkv, rep, t, d).sum(2)
        dv = dv.reshape(b, hkv, rep, t, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window", [
    (2, 17, 17, 8, 2, 8, True, None),
    (2, 17, 17, 8, 2, 24, True, None),
    (2, 512, 512, 8, 2, 40, True, None),
    (1, 512, 512, 8, 2, 128, True, None),
    (16, 128, 128, 32, 8, 64, True, None),    # the training shape
    (2, 300, 300, 8, 2, 64, True, 100),
    (1, 70, 70, 8, 1, 32, False, None),
])
def test_two_part_backward_matches_plain_and_jax_grad(b, s, t, hq, hkv, d,
                                                      causal, window):
    """bf16: the kernels' two-part P and dS against the plain backward
    (P and dS in fp32; elementwise within the card tests' 2e-2, and
    relative L2 within GRAD_REL_L2 / 4) and against jax.grad of repro's
    blockwise_attention (its own forward's out and lse; relative L2 of
    each gradient within GRAD_REL_L2)."""
    rng = np.random.default_rng(s + d + 1)
    q, k, v, do = (rng.normal(size=sh).astype(np.float32) for sh in (
        (b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, hq, d)))
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, bb, c: jax_blockwise(
        a, bb, c, causal=causal, window=window, q_chunk=64, kv_chunk=64),
        jq, jk, jv)
    jgrads = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2)
                       for x in (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window, with_lse=True)
    got = attention_bwd_two_part(tq, tk, tv, out, tdo, lse, causal=causal,
                                 window=window)
    plain = flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse,
                                      causal=causal, window=window)
    for g, pw, jw in zip(got, plain, jgrads):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), pw.float(), atol=CARD_TOL,
                                   rtol=CARD_TOL)
        assert _rel_l2(g.float().numpy(), pw.float().numpy()) \
            <= GRAD_REL_L2 / 4
        jw = np.asarray(jw.astype(jnp.float32)).transpose(0, 2, 1, 3)
        assert _rel_l2(g.float().numpy(), jw) <= GRAD_REL_L2


# --- B5 forward: 128-column tiles, splits combined in order ------------------

def cross_entropy_fwd_tiles(h, w, labels, nsplit):
    """The tensor-core B5 forward's algorithm in plain PyTorch: fp32
    logits of 128-column tiles of a W zero-filled past V (as TMA fills the
    last tile); each tile folded into per-row running (max, sum of exp,
    best logit and its first index, label logit) with the columns past V
    left out; ``nsplit`` runs of tiles (the kernel's splits) combined in
    split order. -> (nll, lse, correct) as cross_entropy_fwd."""
    t, v = h.shape[0], w.shape[1]
    tiles = -(-v // 128)
    per = -(-tiles // nsplit)
    wf = torch.zeros((w.shape[0], tiles * 128))
    wf[:, :v] = w.float()
    logits = torch.matmul(h.float(), wf)
    lab = labels.long()
    rows = torch.arange(t)
    parts = []
    for first in range(0, tiles, per):
        m = torch.full((t,), -math.inf)
        l = torch.zeros(t)
        best = torch.full((t,), -math.inf)
        best_i = torch.full((t,), 2 ** 31 - 1, dtype=torch.long)
        tgt = torch.zeros(t)
        for j in range(first, min(tiles, first + per)):
            cols = torch.arange(128 * j, 128 * j + 128)
            s = logits[:, cols].masked_fill(cols[None, :] >= v, -math.inf)
            tmax, targ = s.max(dim=1)       # first index of the max
            m_new = torch.maximum(m, tmax)
            l = l * torch.exp(m - m_new) + torch.exp(
                s - m_new[:, None]).sum(1)
            m = m_new
            better = tmax > best
            best = torch.where(better, tmax, best)
            best_i = torch.where(better, 128 * j + targ, best_i)
            here = (lab >= 128 * j) & (lab < 128 * j + 128)
            tgt = tgt + torch.where(here, logits[rows, lab], 0.0)
        parts.append((m, l, best, best_i, tgt))
    m = torch.stack([pt[0] for pt in parts]).max(0).values
    l = sum(pt[1] * torch.exp(pt[0] - m) for pt in parts)
    tg = sum(pt[4] for pt in parts)
    best = torch.full((t,), -math.inf)
    best_i = torch.zeros(t, dtype=torch.long)
    for pt in parts:                          # split order: first wins ties
        better = pt[2] > best
        best = torch.where(better, pt[2], best)
        best_i = torch.where(better, pt[3], best_i)
    lse = m + torch.log(l.clamp_min(1e-30))
    return lse - tg, lse, (best_i == lab).to(torch.int32)


def _xent_case(t, d, v, seed, ties=False):
    """bf16 h, W (d, V), labels; with ``ties``, exact planted ties as in
    the card test: rows i and i + 4 share a block of 8 dims on which two
    columns hold 4 (logit 32), labels the first of the pair (row i) and
    the second (row i + 4)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    labels[:2] = [v - 1, (v - 1) // 128 * 128]     # in the last tile
    if ties:
        pairs = [(5, 300), (130, 131), (260, 263), (v - 300, v - 1)]
        h[:8] = 0
        for i, (a, bb) in enumerate(pairs):
            dims = slice(8 * i, 8 * i + 8)
            h[i, dims] = h[i + 4, dims] = 1
            w[:, [a, bb]] = 0
            w[dims, a] = w[dims, bb] = 4
            labels[i], labels[i + 4] = a, bb
    return (torch.from_numpy(h).to(torch.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16),
            torch.from_numpy(labels))


@pytest.mark.parametrize("t,d,v,ties", [
    (37, 24, 509, False), (200, 64, 100, False), (129, 16, 1000, False),
    (64, 32, 4099, False), (16, 64, 8300, True), (300, 40, 2000, True),
])
def test_tile_partials_match_plain_and_fused_cross_entropy(t, d, v, ties):
    """bf16 inputs, fp32 logits: the kernel's tile-and-split algorithm
    (splits as the card's 132 SMs give them) against the plain forward
    (nll and lse within XENT_FP32_TOL; argmax verdicts equal, planted
    ties included: the first index wins), the Pallas fused_cross_entropy
    in interpret mode and repro.kernels.ref (nll)."""
    h, w, labels = _xent_case(t, d, v, t + v, ties)
    nsplit = xent.tc_vocab_splits(t, v, 132)
    nll, lse, correct = cross_entropy_fwd_tiles(h, w, labels, nsplit)
    pnll, plse, pcorrect = xent.cross_entropy_fwd_plain(h, w, labels)
    torch.testing.assert_close(nll, pnll, **XENT_FP32_TOL)
    torch.testing.assert_close(lse, plse, **XENT_FP32_TOL)
    assert torch.equal(correct, pcorrect)
    if ties:
        assert correct[:8].tolist() == [1, 1, 1, 1, 0, 0, 0, 0]
    jh, jw = (jnp.asarray(x.float().numpy()) for x in (h, w))
    jl = jnp.asarray(labels.numpy())
    for want in (fused_cross_entropy(jh, jw, jl, block_t=t, block_v=v,
                                     interpret=True),
                 jref.cross_entropy_ref(jh, jw, jl)):
        np.testing.assert_allclose(nll.numpy(), np.asarray(want),
                                   **XENT_FP32_TOL)


def test_columns_past_v_must_be_left_out():
    """Rows whose every logit is negative: the zero-filled columns of the
    last tile would be the max (and the argmax) if they were not masked;
    the emulation, masked as the kernel is, equals the plain forward."""
    t, d, v = 8, 16, 200                     # last tile: 56 columns past V
    h = torch.ones((t, d), dtype=torch.bfloat16)
    w = -torch.rand((d, v), generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16) - 0.5
    labels = torch.arange(t, dtype=torch.int32)
    nll, lse, correct = cross_entropy_fwd_tiles(h, w, labels, 1)
    pnll, plse, pcorrect = xent.cross_entropy_fwd_plain(h, w, labels)
    torch.testing.assert_close(lse, plse, **XENT_FP32_TOL)
    assert torch.equal(correct, pcorrect)
    # unmasked, the padding's zeros would win: lse would grow by log(1 +
    # 56 exp(0 - max)), a large shift here
    wz = torch.zeros((d, 256), dtype=torch.bfloat16)
    wz[:, :v] = w
    unmasked = torch.logsumexp(torch.matmul(h.float(), wz.float()), dim=1)
    assert (unmasked - plse).min().item() > 1.0


@pytest.mark.parametrize("t,v,sms,nsplit", [
    (2048, 49155, 132, 8),      # the training shape: 16 x 8 = 128 blocks
    (37, 509, 132, 4),          # never more splits than vocab tiles
    (200, 100, 132, 1),
    (4096, 49155, 132, 4),
    (100000, 49155, 132, 1),    # more token tiles than SMs
])
def test_tensor_core_forward_splits_fill_one_wave(t, v, sms, nsplit):
    assert xent.tc_vocab_splits(t, v, sms) == nsplit
    assert -(-t // 128) * nsplit <= max(sms, -(-t // 128))


def test_cross_entropy_pads_w_once_a_step(monkeypatch):
    """ops.CrossEntropy on the card path (the launches replaced by the
    plain versions): at an odd V the padded W is made once, in the
    forward, and the backward gets that same tensor, which the kernels'
    own alignment step passes through without a copy."""
    made, seen = [], {}
    pad = xent.pad_vocab

    def counting_pad(w):
        out = pad(w)
        made.append(out)
        return out

    def fwd(hidden, w, labels):
        seen["fwd"] = w
        return xent.cross_entropy_fwd_plain(hidden, w, labels)

    def bwd(hidden, w, labels, lse, g, dh_fp32=False):
        seen["bwd"] = w
        assert xent.aligned_rows(w) is w          # no second copy
        return xent.cross_entropy_bwd_plain(hidden, w, labels, lse, g,
                                            dh_fp32)

    monkeypatch.setattr(ops, "_on_cpu", lambda t, what: False)
    monkeypatch.setattr(xent, "pad_vocab", counting_pad)
    monkeypatch.setattr(xent, "cross_entropy_fwd", fwd)
    monkeypatch.setattr(xent, "cross_entropy_bwd", bwd)
    gen = torch.Generator().manual_seed(4)
    h = torch.randn((12, 16), generator=gen).to(torch.bfloat16)
    w = torch.randn((16, 509), generator=gen).to(torch.bfloat16)
    labels = torch.randint(0, 509, (12,), generator=gen, dtype=torch.int32)
    hr, wr = h.requires_grad_(True), w.requires_grad_(True)
    nll, lse, _ = ops.cross_entropy(hr, wr, labels)
    dh, dw = torch.autograd.grad(nll.sum(), (hr, wr))
    assert len(made) == 1
    assert seen["fwd"] is seen["bwd"]
    assert seen["fwd"].shape == (16, 509) and seen["fwd"].stride(0) == 512
    assert seen["fwd"].data_ptr() == made[0].data_ptr()
    assert torch.equal(seen["fwd"], w.detach())
    assert dw.shape == (16, 509) and dw.is_contiguous()
    pdh, pdw = xent.cross_entropy_bwd_plain(h.detach(), w.detach(), labels,
                                            lse, torch.ones(12))
    torch.testing.assert_close(dw.float(), pdw.float())
    torch.testing.assert_close(dh.float(), pdh.float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("v,copies", [(509, True), (8300, True),
                                      (4096, False), (49160, False)])
def test_aligned_rows_copies_only_misaligned_rows(dtype, v, copies):
    """The (d, V) view the tensor-core kernels read: W itself when its
    rows start 16-byte aligned, else the first V columns of the padded
    copy; applied again, it returns its own result."""
    w = torch.randn((24, v), generator=torch.Generator().manual_seed(v)
                    ).to(dtype)
    rows = xent.aligned_rows(w)
    assert rows.shape == w.shape and torch.equal(rows, w)
    assert (rows is not w) == copies
    assert (rows.stride(0) * rows.element_size()) % 16 == 0
    assert rows.stride(1) == 1 and rows.data_ptr() % 16 == 0
    assert xent.aligned_rows(rows) is rows


def test_tma_ready_takes_model_layout_views_and_refuses_the_rest():
    from repro_torch.kernels.flash_attention import tma_ready
    x = torch.zeros((2, 100, 8, 24), dtype=torch.bfloat16)
    assert tma_ready(x.transpose(1, 2))            # (B, H, S, D) view
    assert tma_ready(x[:, :, 2:4].transpose(1, 2))
    odd = torch.zeros((2, 100, 8, 25), dtype=torch.bfloat16)[..., :24]
    assert not tma_ready(odd.transpose(1, 2))      # rows 50 bytes apart
    assert not tma_ready(x.transpose(2, 3))        # D not contiguous
    assert not tma_ready(torch.zeros((1, 8, 1, 24), dtype=torch.bfloat16
                                     ).expand(2, 8, 5, 24))   # stride 0
    assert tma_ready(torch.zeros((1, 8, 1, 24), dtype=torch.bfloat16))
