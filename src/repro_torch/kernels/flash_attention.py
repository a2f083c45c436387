"""Prefill attention: the hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``). The kernel lives in ``csrc/flash_attention.cu``
(design, bound and masking notes there); :func:`flash_attention` launches
it on CUDA tensors, and :func:`flash_attention_plain` computes the same
function in plain PyTorch — the CPU path and the on-card oracle.

Layout: q (B, Hq, S, D), k/v (B, Hkv, T, D), any strides with a contiguous
head_dim axis, so model-layout (B, S, H, D) tensors pass as transposed
views. GQA: q head h reads kv head h // (Hq / Hkv). Causal and window
masks align query and key starts, as ``repro.models.layers.
blockwise_attention`` does (equal to ``ref.attention_ref``'s end
alignment when S == T, the prefill case). Probabilities stay in fp32 for
P.V, as in the TPU kernel (``blockwise_attention`` rounds them to v's
dtype first: in bf16 the two differ at bf16 rounding, ~1e-2).
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
    if d > _MAX_D or d % 8:
        raise ValueError(f"flash_attention: head_dim {d} must be a "
                         f"multiple of 8 and at most {_MAX_D}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be contiguous")
    if window is not None and window < 1:
        raise ValueError("flash_attention: window must be >= 1 (or None)")


def _strides(t) -> ctypes.Array:
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def _kernel():
    """The loaded library and its launcher, argtypes declared once."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p] + [ctypes.c_int] * 6 \
            + [ctypes.POINTER(ctypes.c_longlong)] * 4 \
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib, fn


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel. Shapes as in the module docstring; ``out``
    (B, Hq, S, D), any strides with contiguous head_dim, defaults to a new
    tensor. Raises on anything the kernel does not take."""
    _check(q, k, v, window)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty_like(q)
    if out.shape != q.shape or out.dtype != q.dtype or out.stride(3) != 1:
        raise ValueError("flash_attention: bad out tensor")
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), b, hq, hkv, s, t, d,
             _strides(q), _strides(k), _strides(v), _strides(out),
             int(bool(causal)), -1 if window is None else int(window),
             1.0 / math.sqrt(d), stream)
    _build.check(err, lib, "flash_attention")
    return out


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same layout and masks)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = hq // hkv
    kf = k.float().repeat_interleave(rep, dim=1) if rep > 1 else k.float()
    vf = v.float().repeat_interleave(rep, dim=1) if rep > 1 else v.float()
    scores = torch.matmul(q.float(), kf.transpose(-1, -2)) / math.sqrt(d)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, vf).to(q.dtype)
