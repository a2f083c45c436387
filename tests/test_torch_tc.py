"""What surrounds the tensor-core kernels, on the CPU.

The wgmma kernels (B1 forward and B5 backward in bf16/fp16) run only on
the card; here the code around them is checked: the dtype dispatch rule,
the W row padding of the B5 backward, the size of its ds scratch, and a
plain-PyTorch emulation of how the new kernels round — P fed to P.V as
two parts in the input dtype, P rounded and the remainder (B1), the
softmax part of ds rounded to the input dtype before the dh and dW
products, its one-hot part kept exact (B5-bwd) — held in bf16 against
``repro``'s ``blockwise_attention`` and ``jax.grad`` of ``chunked_xent``
and against the port's plain versions at the card tests' shapes.

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

from repro.models.layers import blockwise_attention as jax_blockwise
from repro.models.transformer import chunked_xent as jchunked_xent
from repro_torch.kernels import cross_entropy as xent
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 uses_tensor_cores)

CARD_TOL = 2e-2           # bf16 atol/rtol of tests/test_torch_gpu.py
GRAD_REL_L2 = 2e-2        # chip_smoke.py's [grads] limit


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
