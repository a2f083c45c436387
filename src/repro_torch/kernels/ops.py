"""Model-layout wrappers over the port's kernels, each with a launch
count (mirrors :mod:`repro.kernels.ops`).

A tensor on the CPU goes to the kernel's plain version; a CUDA tensor
launches the CUDA kernel or raises — there is no fallback. Each wrapper
carries a plain integer ``launches`` that it raises by one where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels (``reset_launches`` / ``launch_counts``).

``spec_verify`` (B3) is forward only.

Gradients go through ``torch.autograd.Function``s whose backward is a
kernel too: :class:`FlashAttention` (forward B1 with its logsumexp,
backward B1-bwd), :class:`SelectiveScan` (forward B4, backward B4-bwd),
:class:`SelectiveScanHeads` (Mamba-2's layout: forward the per-head B4,
backward the per-head B4-bwd) and :class:`CrossEntropy` (forward B5, backward
B5-bwd). :func:`cross_entropy_partials` is B5 on one rank's vocab slice
(tensor parallelism; ``launch.tensor_parallel`` holds its autograd
Function, whose backward is B5-bwd on the slice). On the CPU each
runs the plain versions of both passes, so the CPU tests check the
backward formulas the kernels implement.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import cross_entropy as xent
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 tma_ready,
                                                 uses_tensor_cores)
from repro_torch.kernels.paged_attention import (paged_attention as
                                                 _paged_attention_kernel,
                                                 paged_attention_plain)
from repro_torch.kernels.spec_verify import (spec_verify as
                                             _spec_verify_kernel,
                                             spec_verify_plain)
from repro_torch.kernels.ssm_scan import (ssm_scan, ssm_scan_bwd,
                                          ssm_scan_bwd_plain, ssm_scan_heads,
                                          ssm_scan_heads_bwd,
                                          ssm_scan_heads_bwd_plain,
                                          ssm_scan_heads_plain,
                                          ssm_scan_plain)


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    # is_cuda / is_cpu: no torch.device object built on the decode path
    if t.is_cuda:
        return False
    if t.is_cpu:
        return True
    raise ValueError(f"{what}: no kernel for device {t.device}")


def _heads_first(*xs):
    """Model layout (B, S, H, D) -> strided (B, H, S, D) views."""
    return tuple(x.transpose(1, 2) for x in xs)


def _attention_fwd(q, k, v, causal, window, with_lse: bool):
    """(out, lse or None) in model layout; lse (B, Hq, S) fp32."""
    qt, kt, vt = _heads_first(q, k, v)
    if _on_cpu(q, "attention"):
        if with_lse:
            out, lse = flash_attention_plain(qt, kt, vt, causal=causal,
                                             window=window, with_lse=True)
            return out.transpose(1, 2), lse
        return flash_attention_plain(qt, kt, vt, causal=causal,
                                     window=window).transpose(1, 2), None
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        b, s, hq, _ = q.shape
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    flash_attention(qt, kt, vt, causal=causal, window=window,
                    out=out.transpose(1, 2), lse=lse)
    attention.launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Differentiable attention in model layout: the B1 forward saves
    (q, k, v, out, lse); the backward runs :func:`attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _attention_fwd(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, dout, lse,
                                   causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Model-layout attention. q: (B, S, Hq, D); k, v: (B, T, Hkv, D)
    -> (B, S, Hq, D). The kernel reads and writes the model layout
    through strided (B, H, S, D) views: no transposed copies. With grad
    enabled the call goes through :class:`FlashAttention`, so the result
    carries a ``grad_fn``; under ``no_grad`` (serving) it is the plain
    forward launch."""
    if torch.is_grad_enabled():
        return FlashAttention.apply(q, k, v, causal, window)
    return _attention_fwd(q, k, v, causal, window, with_lse=False)[0]


def attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                  window: Optional[int] = None):
    """Model-layout attention backward -> (dq, dk, dv), shapes and dtypes
    of (q, k, v). ``lse`` (B, Hq, S) fp32 comes from the forward."""
    if dout.stride(-1) != 1 or (uses_tensor_cores(dout.dtype)
                                and not tma_ready(dout)):
        dout = dout.contiguous()
    qt, kt, vt, ot, dot = _heads_first(q, k, v, out, dout)
    if _on_cpu(q, "attention_bwd"):
        grads = flash_attention_bwd_plain(qt, kt, vt, ot, dot, lse,
                                          causal=causal, window=window)
        return tuple(g.transpose(1, 2) for g in grads)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    flash_attention_bwd(qt, kt, vt, ot, dot, lse, causal=causal,
                        window=window,
                        dq=dq.transpose(1, 2), dk=dk.transpose(1, 2),
                        dv=dv.transpose(1, 2))
    attention_bwd.launches += 1
    return dq, dk, dv


def paged_attention(q, k_pages, v_pages, page_table, pos) -> torch.Tensor:
    """Paged decode attention. q: (B, Hq, D); pages (NP, P, Hc, D);
    page_table (B, M) int32; pos (B,) int32 -> (B, Hq, D)."""
    if _on_cpu(q, "paged_attention"):
        return paged_attention_plain(q, k_pages, v_pages, page_table, pos)
    out = _paged_attention_kernel(q, k_pages, v_pages, page_table, pos)
    paged_attention.launches += 1
    return out


def spec_verify(q, k_pages, v_pages, page_table, q_pos) -> torch.Tensor:
    """Speculative-verify window attention. q: (B, W, Hq, D); pages (NP, P,
    Hc, D); page_table (B, M) int32; q_pos (B, W) int32 -> (B, W, Hq, D)."""
    if _on_cpu(q, "spec_verify"):
        return spec_verify_plain(q, k_pages, v_pages, page_table, q_pos)
    out = _spec_verify_kernel(q, k_pages, v_pages, page_table, q_pos)
    spec_verify.launches += 1
    return out


def _scan_fwd(x, dt, a, bmat, cmat):
    if _on_cpu(x, "selective_scan"):
        return ssm_scan_plain(x, dt, a, bmat, cmat)
    out = ssm_scan(x, dt, a, bmat, cmat)
    selective_scan.launches += 1
    return out


class SelectiveScan(torch.autograd.Function):
    """Differentiable selective scan: the B4 forward saves its (contiguous)
    inputs and no state; the backward runs :func:`selective_scan_bwd`,
    which recomputes the states. A gradient of h_last that autograd does
    not have (training uses y alone) reaches the kernel as None."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        return _scan_fwd(x, dt, a, bmat, cmat)

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, a, bmat, cmat = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return selective_scan_bwd(x, dt, a, bmat, cmat, dy, dh_last)


def selective_scan(x, dt, a, bmat, cmat):
    """Mamba-1 selective scan from a zero state. x (B, L, D) and B, C
    (B, L, N) in the model dtype, dt (B, L, D) and a (D, N) fp32 -> (y
    (B, L, D) fp32, h_last (B, D, N) fp32). With grad enabled and an
    input that requires it, the call goes through :class:`SelectiveScan`
    (B4, then B4-bwd in the backward); otherwise (serving) it is the plain
    forward launch, which saves nothing."""
    args = tuple(t.contiguous() for t in (x, dt, a, bmat, cmat))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SelectiveScan.apply(*args)
    return _scan_fwd(*args)


def selective_scan_bwd(x, dt, a, bmat, cmat, dy, dh_last=None):
    """Gradients of the selective scan -> (dx, ddt, da, dB, dC), shapes
    and dtypes of the inputs; dy (B, L, D), dh_last (B, D, N) or None."""
    dy = dy.float().contiguous()
    if dh_last is not None:
        dh_last = dh_last.float().contiguous()
    if _on_cpu(x, "selective_scan_bwd"):
        return ssm_scan_bwd_plain(x, dt, a, bmat, cmat, dy, dh_last)
    out = ssm_scan_bwd(x, dt, a, bmat, cmat, dy, dh_last)
    selective_scan_bwd.launches += 1
    return out


def _scan_heads_fwd(x, dt, a, bmat, cmat):
    if _on_cpu(x, "selective_scan_heads"):
        return ssm_scan_heads_plain(x, dt, a, bmat, cmat)
    out = ssm_scan_heads(x, dt, a, bmat, cmat)
    selective_scan_heads.launches += 1
    return out


class SelectiveScanHeads(torch.autograd.Function):
    """The selective scan in Mamba-2's layout: the per-head B4 forward
    saves its per-head inputs (x, dt (B, L, nh), a (nh,), B, C) and no
    state; its backward runs :func:`selective_scan_heads_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        return _scan_heads_fwd(x, dt, a, bmat, cmat)

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, a, bmat, cmat = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return selective_scan_heads_bwd(x, dt, a, bmat, cmat, dy, dh_last)


def selective_scan_heads(x, dt, a, bmat, cmat):
    """Mamba-2's selective scan from a zero state, one decay a head. x
    (B, L, D) and B, C (B, L, N) in the model dtype, dt (B, L, nh) and a
    (nh,) fp32 (a = -exp(a_log)), D = nh * hd -> (y (B, L, D) fp32,
    h_last (B, D, N) fp32), bit for bit B4 on ``expand_heads``' inputs.
    With grad enabled and an input that requires it, the call goes
    through :class:`SelectiveScanHeads`; otherwise (serving) it is the
    plain forward launch."""
    args = tuple(t.contiguous() for t in (x, dt, a, bmat, cmat))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SelectiveScanHeads.apply(*args)
    return _scan_heads_fwd(*args)


def selective_scan_heads_bwd(x, dt, a, bmat, cmat, dy, dh_last=None):
    """Gradients of :func:`selective_scan_heads` -> (dx, ddt (B, L, nh),
    da (nh,), dB, dC), shapes and dtypes of the inputs; dy (B, L, D),
    dh_last (B, D, N) or None."""
    dy = dy.float().contiguous()
    if dh_last is not None:
        dh_last = dh_last.float().contiguous()
    if _on_cpu(x, "selective_scan_heads_bwd"):
        return ssm_scan_heads_bwd_plain(x, dt, a, bmat, cmat, dy, dh_last)
    out = ssm_scan_heads_bwd(x, dt, a, bmat, cmat, dy, dh_last)
    selective_scan_heads_bwd.launches += 1
    return out


class CrossEntropy(torch.autograd.Function):
    """Per-token NLL through the B5 forward; the backward runs
    :func:`cross_entropy_bwd`. ``lse`` and ``correct`` carry no
    gradient. On the card a bf16/fp16 W is read through
    ``aligned_rows``: at an odd V that is a row-padded copy, made here
    once and saved for the backward, which then reads it as it is."""

    @staticmethod
    def forward(ctx, hidden, w, labels):
        if _on_cpu(hidden, "cross_entropy"):
            nll, lse, correct = xent.cross_entropy_fwd_plain(hidden, w,
                                                             labels)
        else:
            if uses_tensor_cores(w.dtype):
                w = xent.aligned_rows(w)
            nll, lse, correct = xent.cross_entropy_fwd(hidden, w, labels)
            cross_entropy.launches += 1
        ctx.save_for_backward(hidden, w, labels, lse)
        ctx.mark_non_differentiable(lse, correct)
        return nll, lse, correct

    @staticmethod
    def backward(ctx, g_nll, g_lse, g_correct):
        hidden, w, labels, lse = ctx.saved_tensors
        dh, dw = cross_entropy_bwd(hidden, w, labels, lse, g_nll)
        return dh, dw, None


def cross_entropy(hidden, w, labels):
    """Fused LM-head cross-entropy. hidden (T, d), w (d, V), labels (T,)
    int32 -> (nll (T,) fp32, lse (T,) fp32, correct (T,) int32); ``nll``
    is differentiable in hidden and w."""
    return CrossEntropy.apply(hidden.contiguous(), w.contiguous(),
                              labels.to(torch.int32).contiguous())


def cross_entropy_bwd(hidden, w, labels, lse, g, dh_fp32: bool = False):
    """(dh, dw) of Σ g·nll, in the inputs' dtypes (dh in fp32, unrounded,
    with ``dh_fp32``)."""
    g = g.float().contiguous()
    if _on_cpu(hidden, "cross_entropy_bwd"):
        return xent.cross_entropy_bwd_plain(hidden, w, labels, lse, g,
                                            dh_fp32)
    out = xent.cross_entropy_bwd(hidden, w, labels, lse, g, dh_fp32)
    cross_entropy_bwd.launches += 1
    return out


def cross_entropy_partials(hidden, w, labels, v0: int) -> torch.Tensor:
    """B5 on one rank's vocab slice ``w`` (columns ``v0`` ..): hidden (T,
    d), labels (T,) int32 local (label - v0, or -1 outside the slice) ->
    the (5, T) fp32 partials that ``xent.combine_partials`` combines over
    the ranks. Forward only: the vocab-parallel backward is
    :func:`cross_entropy_bwd` on the slice."""
    if _on_cpu(hidden, "cross_entropy_partials"):
        return xent.cross_entropy_partials_plain(hidden, w, labels, v0)
    out = xent.cross_entropy_partials(hidden, w, labels, v0)
    cross_entropy_partials.launches += 1
    return out


attention.launches = 0
attention_bwd.launches = 0
paged_attention.launches = 0
spec_verify.launches = 0
selective_scan.launches = 0
selective_scan_bwd.launches = 0
selective_scan_heads.launches = 0
selective_scan_heads_bwd.launches = 0
cross_entropy.launches = 0
cross_entropy_bwd.launches = 0
cross_entropy_partials.launches = 0

WRAPPERS = {"flash_attention": attention,
            "flash_attention_bwd": attention_bwd,
            "paged_attention": paged_attention,
            "spec_verify": spec_verify,
            "selective_scan": selective_scan,
            "selective_scan_bwd": selective_scan_bwd,
            "selective_scan_heads": selective_scan_heads,
            "selective_scan_heads_bwd": selective_scan_heads_bwd,
            "cross_entropy": cross_entropy,
            "cross_entropy_bwd": cross_entropy_bwd,
            "cross_entropy_partials": cross_entropy_partials}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
