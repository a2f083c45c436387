"""Flash attention: the hand-written CUDA kernels and their plain versions.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``) and, for training, the plain-JAX custom VJP
``repro.models.layers._bw_attn_bwd``. The kernels live in
``csrc/flash_attention.cu`` (design, bound and masking notes there):
:func:`flash_attention` launches the forward (optionally writing the
per-row logsumexp the backward needs) and :func:`flash_attention_bwd` the
backward on CUDA tensors; :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain` compute the same functions in plain
PyTorch — the CPU path and the on-card oracle.

Layout: q (B, Hq, S, D), k/v (B, Hkv, T, D), any strides with a contiguous
head_dim axis, so model-layout (B, S, H, D) tensors pass as transposed
views. GQA: q head h reads kv head h // (Hq / Hkv). Causal and window
masks align query and key starts, as ``repro.models.layers.
blockwise_attention`` does (equal to ``ref.attention_ref``'s end
alignment when S == T, the prefill case).

Both passes dispatch on the dtype (:func:`uses_tensor_cores`): bf16 and
fp16 run the tensor-core kernels, float32 the CUDA-core ones. The
tensor-core forward feeds the probabilities to P.V as two parts in the
input dtype (P rounded, and the remainder: ~16 mantissa bits); the
tensor-core backward feeds P (to dV) and dS (to dQ and dK) the same way.
Both stay near the TPU kernel and the plain version, which keep P in
fp32 (``blockwise_attention`` rounds it to v's dtype: in bf16 that
differs at bf16 rounding, ~1e-2). The tensor-core kernels read q, k, v
(and the backward dout) through TMA tensor maps: their batch, head and
sequence strides must be multiples of 16 bytes (any model-layout view
with head_dim a multiple of 8 is, :func:`tma_ready`) and their data
16-byte aligned; they write out (and read the backward's out) and the
gradients in pairs: 4-byte aligned, even strides. The kernels refuse
anything else before they launch and the wrappers raise.

The kernels take head_dim in multiples of 8. A head_dim that is not one
(20 in reduced granite-moe) runs as a zero-padded copy, widened to the
next multiple of 8 (:func:`pad_head_dim`), scaled by 1/sqrt of the true
head_dim: zero columns add nothing to q.k, and give zero output, dq, dk
and dv columns, which the wrappers cut off. The copy is per call, a
reduced-config path; the full configs' head_dims (64, 128) need none.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 128
# cudaErrorInvalidPitchValue: what the tensor-core kernels return, before
# launching, for an operand their tensor maps or pair stores cannot take
_BAD_PITCH = 12


def _check(q, k, v, window):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be CUDA tensors on "
                         "one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: unsupported dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hq % k.shape[1]:
        raise ValueError("flash_attention: Hq must be a multiple of Hkv")
    if not 0 < d <= _MAX_D:
        raise ValueError(f"flash_attention: head_dim {d} must be in "
                         f"1..{_MAX_D}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be contiguous")
    if window is not None and window < 1:
        raise ValueError("flash_attention: window must be >= 1 (or None)")


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` with its last axis zero-padded to the
    next multiple of 8."""
    return torch.nn.functional.pad(t, (0, -t.shape[-1] % 8)).contiguous()


def uses_tensor_cores(dtype: torch.dtype) -> bool:
    """The kernels' dispatch rule: bf16 and fp16 run on the tensor cores
    (wgmma); float32 stays on the CUDA cores, since wgmma in fp32 is TF32
    and would break the fp32 tolerances."""
    return dtype in (torch.bfloat16, torch.float16)


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the tensor-core kernels' tensor maps can read ``t``
    (B, H, S, D) as it lies: 16-byte aligned data, a contiguous last
    axis, and every other axis of more than one element at a non-zero
    stride that is a multiple of 16 bytes."""
    elt = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(st > 0 and (st * elt) % 16 == 0
                    for st, n in zip(t.stride()[:-1], t.shape[:-1])
                    if n > 1))


def _strides(t) -> ctypes.Array:
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def _kernel(name: str = "flash_attention_fwd"):
    """The loaded library and one of its launchers, argtypes declared
    once."""
    lib = _build.load("flash_attention")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        if name == "flash_attention_fwd":
            fn.argtypes = [i, p, p, p, p] + [i] * 6 + [strides] * 4 \
                + [p, i, i, ctypes.c_float, p]
        else:
            fn.argtypes = [i] + [p] * 10 + [i] * 6 + [strides] * 8 \
                + [i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _check_like(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype \
            or t.device != like.device or t.stride(3) != 1:
        raise ValueError(f"flash_attention: bad {name} tensor")


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    b, hq, s, _ = q.shape
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("flash_attention: lse must be a contiguous "
                         "(B, Hq, S) float32 tensor on q's device")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    out: Optional[torch.Tensor] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA forward. Shapes as in the module docstring; ``out``
    (B, Hq, S, D), any strides with contiguous head_dim, defaults to a new
    tensor; ``lse``, when given, receives the (B, Hq, S) fp32 logsumexp of
    each query row. Raises on anything the kernel does not take."""
    _check(q, k, v, window)
    d = q.shape[3]
    if out is None:
        out = torch.empty_like(q)
    _check_like("out", out, q)
    if lse is not None:
        _check_lse(lse, q)
    if d % 8:
        qp = pad_head_dim(q)
        out.copy_(_launch_fwd(qp, pad_head_dim(k), pad_head_dim(v),
                              torch.empty_like(qp), lse, causal, window,
                              1.0 / math.sqrt(d))[..., :d])
        return out
    return _launch_fwd(q, k, v, out, lse, causal, window, 1.0 / math.sqrt(d))


def _launch_fwd(q, k, v, out, lse, causal, window, scale: float):
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), b, hq, hkv, s, t, d,
             _strides(q), _strides(k), _strides(v), _strides(out),
             None if lse is None else lse.data_ptr(), int(bool(causal)),
             -1 if window is None else int(window), scale, stream)
    if err == _BAD_PITCH:
        raise ValueError(f"flash_attention: strides or alignment of q "
                         f"{q.stride()}, k {k.stride()}, v {v.stride()}, "
                         f"out {out.stride()} do not suit the tensor-core "
                         f"kernel (16-byte multiples; out 4-byte)")
    _build.check(err, lib, "flash_attention")
    return out


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        dq: Optional[torch.Tensor] = None,
                        dk: Optional[torch.Tensor] = None,
                        dv: Optional[torch.Tensor] = None):
    """Launch the CUDA backward: (dq, dk, dv) of ``out`` = attention(q, k,
    v) for the upstream gradient ``dout``. q, out, dout (B, Hq, S, D) and
    k, v (B, Hkv, T, D) with a contiguous head_dim; lse (B, Hq, S) fp32
    from :func:`flash_attention`. The gradients default to new tensors of
    their input's shape and dtype; given ones may be strided views."""
    _check(q, k, v, window)
    d = q.shape[3]
    _check_like("out", out, q)
    _check_like("dout", dout, q)
    _check_lse(lse, q)
    dq = torch.empty_like(q) if dq is None else dq
    dk = torch.empty_like(k) if dk is None else dk
    dv = torch.empty_like(v) if dv is None else dv
    _check_like("dq", dq, q)
    _check_like("dk", dk, k)
    _check_like("dv", dv, v)
    if d % 8:
        padded = [pad_head_dim(x) for x in (q, k, v, out, dout)]
        grads = _launch_bwd(*padded, lse,
                            *(torch.empty_like(x) for x in padded[:3]),
                            causal, window, 1.0 / math.sqrt(d))
        for dst, src in zip((dq, dk, dv), grads):
            dst.copy_(src[..., :d])
        return dq, dk, dv
    return _launch_bwd(q, k, v, out, dout, lse, dq, dk, dv, causal, window,
                       1.0 / math.sqrt(d))


def _launch_bwd(q, k, v, out, dout, lse, dq, dk, dv, causal, window,
                scale: float):
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib, fn = _kernel("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, hq, hkv, s, t, d,
             *(_strides(x) for x in (q, k, v, out, dout, dq, dk, dv)),
             int(bool(causal)), -1 if window is None else int(window),
             scale, stream)
    if err == _BAD_PITCH:
        raise ValueError(f"flash_attention_bwd: strides or alignment of q, "
                         f"k, v, dout {[x.stride() for x in (q, k, v, dout)]}"
                         f" or out, dq, dk, dv "
                         f"{[x.stride() for x in (out, dq, dk, dv)]} do not "
                         f"suit the tensor-core kernels (16-byte multiples; "
                         f"4-byte)")
    _build.check(err, lib, "flash_attention_bwd")
    return dq, dk, dv


def _mask(s: int, t: int, causal: bool, window: Optional[int], device):
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _repeat_heads(x, rep: int):
    return x.float().repeat_interleave(rep, dim=1) if rep > 1 else x.float()


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          with_lse: bool = False):
    """The kernel's function in plain PyTorch (same layout and masks).
    With ``with_lse`` it returns ``(out, lse)``, lse (B, Hq, S) fp32 as
    the kernel writes it."""
    b, hq, s, d = q.shape
    rep = hq // k.shape[1]
    kf, vf = _repeat_heads(k, rep), _repeat_heads(v, rep)
    scores = torch.matmul(q.float(), kf.transpose(-1, -2)) / math.sqrt(d)
    mask = _mask(s, k.shape[2], causal, window, q.device)
    scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, vf).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *,
                              causal: bool = True,
                              window: Optional[int] = None):
    """The backward kernel's function in plain PyTorch, as
    ``repro.models.layers._bw_attn_bwd`` computes it: P = exp(s - lse)
    recomputed under the mask, delta = rowsum(dO * out), dS = P (dP -
    delta); the rep query heads of each kv head are summed into its dk,
    dv. Everything in fp32; gradients come out in the inputs' dtypes."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), dout.float()
    kf, vf = _repeat_heads(k, rep), _repeat_heads(v, rep)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mask = _mask(s, t, causal, window, q.device)
    p = torch.where(mask, torch.exp(scores - lse[..., None]),
                    torch.zeros((), device=q.device))
    delta = (dof * out.float()).sum(-1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    if rep > 1:
        dk = dk.reshape(b, hkv, rep, t, d).sum(2)
        dv = dv.reshape(b, hkv, rep, t, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
