"""Paged decode attention: the hand-written CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_attention``). The kernel lives in ``csrc/paged_attention.cu``
(design and bound notes there); :func:`paged_attention` launches it on
CUDA tensors and :func:`paged_attention_plain` computes the same function
in plain PyTorch — the CPU path and the on-card oracle.

Layout: q (B, Hq, D); k_pages/v_pages (NP, P, Hc, D) contiguous (one
layer's slice of the page pool, scratch page included); page_table (B, M)
int32; pos (B,) int32. Key k of row b is visible iff k <= pos[b]; q head
h reads cache head h // (Hq / Hc). Returns (B, Hq, D).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 128
_MAX_REP = 16


def _check(q, k_pages, v_pages, page_table, pos):
    dev = q.device
    if not q.is_cuda or any(t.device != dev for t in
                            (k_pages, v_pages, page_table, pos)):
        raise ValueError("paged_attention: every input must be a CUDA "
                         "tensor on one device")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention: unsupported dtypes "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_attention: page_table and pos must be int32")
    b, hq, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4 \
            or k_pages.shape[3] != d:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} "
                         f"do not match q {tuple(q.shape)}")
    hc = k_pages.shape[2]
    if hq % hc or hq // hc > _MAX_REP:
        raise ValueError(f"paged_attention: Hq {hq} must be a multiple of "
                         f"Hc {hc}, at most {_MAX_REP}x")
    if d > _MAX_D or d % 8:
        raise ValueError(f"paged_attention: head_dim {d} must be a multiple "
                         f"of 8 and at most {_MAX_D}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or pos.shape != (b,):
        raise ValueError("paged_attention: page_table (B, M) / pos (B,) "
                         "shapes disagree with q")
    if not all(t.is_contiguous() for t in
               (q, k_pages, v_pages, page_table, pos)):
        raise ValueError("paged_attention: inputs must be contiguous")


def _kernel():
    """The loaded library and its launcher, argtypes declared once."""
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, p] + [ctypes.c_int] * 7 \
            + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib, fn


def paged_attention(q, k_pages, v_pages, page_table, pos) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    _check(q, k_pages, v_pages, page_table, pos)
    b, hq, d = q.shape
    num_pages, psize, hc = k_pages.shape[:3]
    m = page_table.shape[1]
    out = torch.empty_like(q)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
             out.data_ptr(), b, hq, hc, psize, d, m, num_pages,
             1.0 / math.sqrt(d), stream)
    _build.check(err, lib, "paged_attention")
    return out


def paged_attention_plain(q, k_pages, v_pages, page_table,
                          pos) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the row's pages in
    logical order, mask keys past ``pos``, dense fp32 softmax."""
    b, hq, d = q.shape
    psize, hc = k_pages.shape[1], k_pages.shape[2]
    m = page_table.shape[1]
    rep = hq // hc
    idx = page_table.long()
    k = k_pages[idx].reshape(b, m * psize, hc, d).float()
    v = v_pages[idx].reshape(b, m * psize, hc, d).float()
    qr = q.float().reshape(b, hc, rep, d)
    scores = torch.einsum("bhrd,bkhd->bhrk", qr, k) / math.sqrt(d)
    valid = (torch.arange(m * psize, device=q.device)[None, :]
             <= pos.long()[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", probs, v)
    return out.reshape(b, hq, d).to(q.dtype)
