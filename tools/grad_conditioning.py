#!/usr/bin/env python3
"""How well-defined chip_smoke.py's gradient check is, on the card.

    python3 tools/grad_conditioning.py

Builds the check's model and batch (full-width granite-3-2b cut to 4
layers, one UGS plan batch; ``chip_smoke.grad_check_setup``) twice: at
the model's own init, and rescaled to fan-in d_in as the check runs it.
At each, every leaf's gradient of the plain path (plain attention and
cross-entropy, fp32 scores from one fp32 matrix product) is the
reference, as in the check (autograd through the plain attention), and
these are held against it (worst and median per-leaf relative L2 error):

- ``kernels``: the kernel path, as the check runs it;
- ``fp32 scores``: the plain path's own arithmetic, with the backward
  formula the kernels use (on the bf16 out and the lse): the floor;
- ``exact scores``: the plain path with QK^T in fp64, rounded to fp32;
- ``tf32 scores``: the plain path with QK^T on the tensor cores (TF32:
  bf16 inputs are exact in it, only the sums differ);
- ``P rounded once``: the plain path with P rounded to bf16 before P.V
  (the tensor-core kernel feeds P in two bf16 parts instead);
- ``P in two parts``: the plain path with P as bf16 hi + lo, the
  forward kernel's arithmetic;
- ``bwd P, dS rounded once``: the plain forward, and a backward that
  rounds P (before dV = P^T dO) and dS (before dQ = dS K and dK = dS^T Q)
  to bf16 once;
- ``bwd P, dS in two parts``: the same with P and dS as bf16 hi + lo,
  the backward kernels' arithmetic.

The ``scores`` and ``P`` variants use the plain backward formula on their
own forward's out and lse. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def bwd_rounded(torch, q, k, v, out, dout, lse, causal, window,
                parts: int):
    """The plain backward formula (heads-first layout, fp32 sums) with P
    and dS fed to their products in ``parts`` parts of q's dtype (1: P and
    dS rounded once; 2: rounded, plus the rounded remainder)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    qf, dof = q.float(), dout.float()
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    mask = kp <= qp if causal else torch.ones((s, t), dtype=bool,
                                              device=q.device)
    if window is not None:
        mask = mask & (kp > qp - window)
    p = torch.where(mask, torch.exp(torch.matmul(qf, kf.transpose(-1, -2))
                                    * scale - lse[..., None]),
                    torch.zeros((), device=q.device))
    delta = (dof * out.float()).sum(-1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])

    def rounded(x):
        hi = x.to(q.dtype).float()
        return hi if parts == 1 else hi + (x - hi).to(q.dtype).float()

    p, ds = rounded(p), rounded(ds)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    if rep > 1:
        dk = dk.reshape(b, hkv, rep, t, d).sum(2)
        dv = dv.reshape(b, hkv, rep, t, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_variant(torch, scores: str, p_parts: int, bwd_parts: int = 0):
    """ops.attention's signature; forward in plain PyTorch with the given
    score arithmetic ("fp32", "exact", "tf32") and P fed to P.V in
    ``p_parts`` bf16 parts (0: fp32); backward the plain formula, with P
    and dS in ``bwd_parts`` bf16 parts (0: fp32; ``bwd_rounded``)."""
    from repro_torch.kernels import flash_attention as fa

    def forward(qt, kt, vt, causal, window):
        rep = qt.shape[1] // kt.shape[1]
        kf = kt.float().repeat_interleave(rep, 1)
        vf = vt.float().repeat_interleave(rep, 1)
        scale = 1.0 / math.sqrt(qt.shape[-1])
        if scores == "exact":
            s = (torch.matmul(qt.double(), kf.double().transpose(-1, -2))
                 * scale).float()
        else:
            torch.backends.cuda.matmul.allow_tf32 = scores == "tf32"
            s = torch.matmul(qt.float(), kf.transpose(-1, -2)) * scale
            torch.backends.cuda.matmul.allow_tf32 = False
        qp = torch.arange(s.shape[-2], device=s.device)[:, None]
        kp = torch.arange(s.shape[-1], device=s.device)[None, :]
        mask = kp <= qp if causal else torch.ones_like(s[0, 0], dtype=bool)
        if window is not None:
            mask = mask & (kp > qp - window)
        s = s.masked_fill(~mask, -1e30)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if p_parts == 0:
            pv = torch.matmul(p, vf)
        else:
            hi = p.to(qt.dtype).float()
            pv = torch.matmul(hi, vf)
            if p_parts == 2:
                pv = pv + torch.matmul((p - hi).to(qt.dtype).float(), vf)
        return (pv / l).to(qt.dtype), (m + torch.log(l))[..., 0]

    class Variant(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            out, lse = forward(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal, window)
            out = out.transpose(1, 2).contiguous()
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.window = causal, window
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            heads_first = (x.transpose(1, 2) for x in (
                q, k, v, out, dout.contiguous()))
            if bwd_parts:
                grads = bwd_rounded(torch, *heads_first, lse, ctx.causal,
                                    ctx.window, bwd_parts)
            else:
                grads = fa.flash_attention_bwd_plain(
                    *heads_first, lse, causal=ctx.causal,
                    window=ctx.window)
            return tuple(g.transpose(1, 2) for g in grads) + (None, None)

    return lambda q, k, v, *, causal=True, window=None: Variant.apply(
        q, k, v, causal, window)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("grad_conditioning: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from repro_torch.core.psl import value_and_grad
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cross_entropy as xent
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.layers import tree_leaves

    dev = resolve_device("cuda")
    print(smoke.nvidia_smi_line())
    kernel_attention, kernel_xent = ops.attention, ops.cross_entropy

    def plain_xent(h, w, labels):
        return xent.cross_entropy_fwd_plain(h, w, labels.to(torch.int32))

    def plain_attention(q, k, v, *, causal=True, window=None):
        return flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)

    variants = {
        "kernels": (kernel_attention, kernel_xent),
        "fp32 scores": (attention_variant(torch, "fp32", 0), plain_xent),
        "exact scores": (attention_variant(torch, "exact", 0), plain_xent),
        "tf32 scores": (attention_variant(torch, "tf32", 0), plain_xent),
        "P rounded once": (attention_variant(torch, "fp32", 1), plain_xent),
        "P in two parts": (attention_variant(torch, "fp32", 2), plain_xent),
        "bwd P, dS rounded once": (attention_variant(torch, "fp32", 0, 1),
                                   plain_xent),
        "bwd P, dS in two parts": (attention_variant(torch, "fp32", 0, 2),
                                   plain_xent),
    }
    reference = (plain_attention, plain_xent)
    for rescale in (False, True):
        ctx, state, batch = smoke.grad_check_setup(torch, dev, rescale)

        def grads(pair):
            ops.attention, ops.cross_entropy = pair
            try:
                return value_and_grad(ctx.model.loss_fn, state.params,
                                      batch)[1]
            finally:
                ops.attention, ops.cross_entropy = (kernel_attention,
                                                    kernel_xent)

        ref = tree_leaves(grads(reference))
        where = "fan-in d_in" if rescale else "model init"
        for name, pair in variants.items():
            rels = sorted(((a.float() - b.float()).norm()
                           / b.float().norm().clamp_min(1e-30)).item()
                          for a, b in zip(tree_leaves(grads(pair)), ref))
            print(f"[{where}] {name}: worst per-leaf relative L2 "
                  f"{rels[-1]:.4f}, median {rels[len(rels) // 2]:.4f}",
                  flush=True)
        del ctx, state, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
