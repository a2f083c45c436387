"""The training kernels' formulas against JAX, on the CPU.

The port's CUDA kernels run only on the card; here their plain versions
(what the kernels compute, and what the CPU path runs) are held against
``repro``: the fused cross-entropy forward (B5) against the Pallas kernel
in interpret mode and ``repro.kernels.ref.cross_entropy_ref``, its
backward against ``jax.grad`` of a weighted ``chunked_xent``, and the
flash-attention backward (B1-bwd) against ``jax.vjp`` of
``repro.models.layers.blockwise_attention`` (whose custom VJP is
``_bw_attn_bwd``), with the forward's logsumexp against
``_blockwise_attention_fwd_impl``. Inputs come from numpy seeds.

Tolerances (float32): values atol 1e-5 / rtol 1e-5 — the same fp32
arithmetic summed in another order by XLA and by PyTorch; gradients
atol 1e-5 + rtol 1e-4, as they sum over more terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models.transformer import chunked_xent as jchunked_xent
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cross_entropy import (cross_entropy_bwd_plain,
                                               cross_entropy_fwd_plain,
                                               ds_chunk, num_vocab_splits)
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from torch_one_thread import one_torch_thread  # noqa: F401

VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **tol)


def _xent_inputs(t, d, v, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    return h, w, labels


def _jax_xent_parts(h, w, labels):
    logits = jnp.asarray(h) @ jnp.asarray(w)
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    correct = (jnp.argmax(logits, -1) == labels).astype(jnp.int32)
    return lse, correct


def test_cross_entropy_plain_matches_pallas_and_ref():
    h, w, labels = _xent_inputs(64, 32, 512, seed=0)
    nll, lse, correct = cross_entropy_fwd_plain(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels))
    pallas = jops.cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(labels), interpret=True)
    _close(nll, pallas, VAL)
    _close(nll, jref.cross_entropy_ref(jnp.asarray(h), jnp.asarray(w),
                                       jnp.asarray(labels)), VAL)
    jlse, jcorrect = _jax_xent_parts(h, w, labels)
    _close(lse, jlse, VAL)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))
    assert correct.dtype == torch.int32 and nll.dtype == torch.float32


@pytest.mark.parametrize("t,v", [(37, 509), (100, 49155 // 97)])
def test_cross_entropy_plain_ragged_vocab_matches_ref(t, v):
    """V not a multiple of any tile (509 is prime; 506 = 2 * 11 * 23): the
    Pallas wrapper would shrink its block to 1 or 2; the oracle does not
    care, and neither do the kernels (masked ragged tiles)."""
    h, w, labels = _xent_inputs(t, 24, v, seed=1)
    nll, lse, correct = cross_entropy_fwd_plain(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels))
    _close(nll, jref.cross_entropy_ref(jnp.asarray(h), jnp.asarray(w),
                                       jnp.asarray(labels)), VAL)
    _close(nll, tref.cross_entropy_ref(torch.from_numpy(h),
                                       torch.from_numpy(w),
                                       torch.from_numpy(labels)), VAL)
    jlse, jcorrect = _jax_xent_parts(h, w, labels)
    _close(lse, jlse, VAL)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))


def test_cross_entropy_ties_take_the_first_index():
    """Duplicated vocab columns tie exactly: the first index wins, as in
    jnp.argmax, so a label on the later twin is not counted correct."""
    h, w, _ = _xent_inputs(8, 16, 40, seed=2)
    logits = h @ w
    top = logits.argmax(-1)
    w_tied = np.concatenate([w, w], axis=1)          # column c == c + 40
    labels_first = top.astype(np.int32)
    labels_twin = (top + 40).astype(np.int32)
    for labels, want in ((labels_first, 1), (labels_twin, 0)):
        _, _, correct = cross_entropy_fwd_plain(
            torch.from_numpy(h), torch.from_numpy(w_tied),
            torch.from_numpy(labels))
        _, jcorrect = _jax_xent_parts(h, w_tied, labels)
        np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))
        assert (correct.numpy() == want).all()


@pytest.mark.parametrize("v", [512, 509])
def test_cross_entropy_backward_matches_jax_grad(v):
    """dh, dW of the weighted mean NLL: the plain backward (and the
    autograd Function that runs it on the CPU) against jax.grad of
    repro's chunked_xent on the same inputs."""
    b, s, d = 2, 24, 32
    h, w, labels = _xent_inputs(b * s, d, v, seed=3)
    weights = np.random.default_rng(4).uniform(
        0, 2, size=(b, s)).astype(np.float32)
    weights[1, 5:] = 0.0                              # padded slots

    def jloss(hh, ww):
        return jchunked_xent(hh.reshape(b, s, d), ww,
                             jnp.asarray(labels).reshape(b, s),
                             jnp.asarray(weights))[0]

    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                               jnp.asarray(w))
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    tl = torch.from_numpy(labels)
    _, lse, _ = cross_entropy_fwd_plain(th, tw, tl)
    g = torch.from_numpy(weights).reshape(-1) / max(weights.sum(), 1e-6)
    dh, dw = cross_entropy_bwd_plain(th, tw, tl, lse, g)
    _close(dh, jdh, GRAD)
    _close(dw, jdw, GRAD)

    th.requires_grad_(True)
    tw.requires_grad_(True)
    nll, _, _ = tops.cross_entropy(th, tw, tl)
    loss = (nll * torch.from_numpy(weights).reshape(-1)).sum() \
        / max(weights.sum(), 1e-6)
    adh, adw = torch.autograd.grad(loss, (th, tw))
    _close(adh, jdh, GRAD)
    _close(adw, jdw, GRAD)


def test_cross_entropy_launch_geometry():
    """The wrappers' grid choices at the training shape and at tiny ones:
    splits never exceed vocab tiles; the ds chunk is a tile multiple."""
    assert num_vocab_splits(2048, 49155) == 17
    assert num_vocab_splits(2048, 64) == 1
    assert ds_chunk(2048, 49155) == 8192
    assert ds_chunk(7, 100) == 128
    assert ds_chunk(2048, 49155) % 64 == 0


@pytest.mark.parametrize("t,v,splits,chunks", [
    (64, 512, 8, 1),
    (37, 509, 8, 1),
    (130, 4099, 65, 1),
    (2048, 8300, 17, 2),        # the card test's multi-chunk backward
    (2048, 49155, 17, 7),       # the training shape
])
def test_cross_entropy_card_cases_cover_their_geometry(t, v, splits,
                                                       chunks):
    """The shapes of the card tests and of the training step: how many
    vocab splits the forward runs and how many ds chunks the backward
    accumulates dh over."""
    assert num_vocab_splits(t, v) == splits
    assert -(-v // ds_chunk(t, v)) == chunks


def _attn_inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("s", [32, 50])
@pytest.mark.parametrize("window", [None, 16])
def test_flash_attention_backward_matches_jax_vjp(rep, s, window):
    b, hkv, d = 2, 2, 16
    hq = hkv * rep
    q, k, v, do = _attn_inputs(b, s, hq, hkv, d, seed=s + rep)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jout, vjp = jax.vjp(
        lambda a, bb, c: jlayers.blockwise_attention(
            a, bb, c, causal=True, window=window, q_chunk=16, kv_chunk=16),
        jq, jk, jv)
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    _, jlse = jlayers._blockwise_attention_fwd_impl(
        jq, jk, jv, True, window, 16, 16, True)

    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2)
                       for x in (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal=True, window=window,
                                     with_lse=True)
    _close(out.transpose(1, 2), jout, VAL)
    _close(lse, np.moveaxis(np.asarray(jlse), 1, 2), VAL)
    dq, dk, dv = flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse,
                                           causal=True, window=window)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got.transpose(1, 2), want, GRAD)


def test_attention_function_differentiates_through_plain_passes():
    """Under grad, ops.attention goes through the FlashAttention Function
    (result has a grad_fn; on the CPU both passes are the plain versions)
    and agrees with torch autograd of the plain forward; under no_grad it
    is the plain forward alone."""
    q, k, v, do = (torch.from_numpy(x) for x in _attn_inputs(
        2, 40, 8, 2, 16, seed=7))
    for x in (q, k, v):
        x.requires_grad_(True)
    out = tops.attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), grad_outputs=do)
    ref = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2)).transpose(1, 2)
    want = torch.autograd.grad(ref, (q, k, v), grad_outputs=do)
    _close(out, ref.detach().numpy(), VAL)
    for got, w in zip(grads, want):
        _close(got, w.numpy(), GRAD)
    with torch.no_grad():
        plain = tops.attention(q, k, v, causal=True)
    assert plain.grad_fn is None
    _close(plain, ref.detach().numpy(), VAL)
