"""Speculative-verify window attention: the hand-written CUDA kernel and
its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/spec_verify.py``
(``spec_verify``). The kernel lives in ``csrc/spec_verify.cu`` (design
and bound notes there); :func:`spec_verify` launches it on CUDA tensors
and :func:`spec_verify_plain` computes the same function in plain
PyTorch — the CPU path and the on-card oracle.

Layout: q (B, W, Hq, D) contiguous (W = gamma + 1 window lanes per row);
k_pages/v_pages (NP, P, Hc, D) contiguous (one layer's slice of the page
pool, scratch page included); page_table (B, M) int32; q_pos (B, W)
int32, the absolute position of every lane. Key k of row b is visible to
lane i iff k <= q_pos[b, i] and its page id is in [0, NP); q head h reads
cache head h // (Hq / Hc). Returns (B, W, Hq, D). With W == 1 and q_pos = pos[:, None] this is the
paged decode attention of ``paged_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import pad_head_dim
from repro_torch.kernels.paged_attention import gather_pages

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 128
_MAX_REP = 16
MAX_W = 16


def _check(q, k_pages, v_pages, page_table, q_pos):
    """Raise on anything the kernel does not take. Called on every verify
    step of every layer, so it reads each attribute once and compares
    device indices (``get_device``) rather than ``torch.device`` objects."""
    dev = q.get_device()
    if not q.is_cuda or k_pages.get_device() != dev \
            or v_pages.get_device() != dev \
            or page_table.get_device() != dev or q_pos.get_device() != dev:
        raise ValueError("spec_verify: every input must be a CUDA tensor "
                         "on one device")
    dtype = q.dtype
    if dtype not in _DTYPE_CODES or k_pages.dtype != dtype \
            or v_pages.dtype != dtype:
        raise ValueError(f"spec_verify: unsupported dtypes "
                         f"{dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise ValueError("spec_verify: page_table and q_pos must be int32")
    qs, ks, ts = q.shape, k_pages.shape, page_table.shape
    if len(qs) != 4:
        raise ValueError(f"spec_verify: q must be (B, W, Hq, D), got "
                         f"{tuple(qs)}")
    b, w, hq, d = qs
    if not 1 <= w <= MAX_W:
        raise ValueError(f"spec_verify: window {w} must be in 1..{MAX_W}")
    if v_pages.shape != ks or len(ks) != 4 or ks[3] != d:
        raise ValueError(f"spec_verify: pages {tuple(ks)} do not match q "
                         f"{tuple(qs)}")
    hc = ks[2]
    if hq % hc or hq // hc > _MAX_REP:
        raise ValueError(f"spec_verify: Hq {hq} must be a multiple of Hc "
                         f"{hc}, at most {_MAX_REP}x")
    if not 0 < d <= _MAX_D:
        raise ValueError(f"spec_verify: head_dim {d} must be in "
                         f"1..{_MAX_D}")
    if len(ts) != 2 or ts[0] != b or q_pos.shape != (b, w):
        raise ValueError("spec_verify: page_table (B, M) / q_pos (B, W) "
                         "shapes disagree with q")
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous() and page_table.is_contiguous()
            and q_pos.is_contiguous()):
        raise ValueError("spec_verify: inputs must be contiguous")


def _kernel():
    """The loaded library and its launcher, argtypes declared once."""
    lib = _build.load("spec_verify")
    fn = lib.spec_verify_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, p] + [ctypes.c_int] * 8 \
            + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib, fn


def spec_verify(q, k_pages, v_pages, page_table, q_pos) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take. A
    head_dim that is not a multiple of 8 runs on per-call zero-padded
    copies, as in ``paged_attention``."""
    _check(q, k_pages, v_pages, page_table, q_pos)
    d = q.shape[3]
    if d % 8:
        return _launch(pad_head_dim(q), pad_head_dim(k_pages),
                       pad_head_dim(v_pages), page_table, q_pos,
                       1.0 / math.sqrt(d))[..., :d].contiguous()
    return _launch(q, k_pages, v_pages, page_table, q_pos,
                   1.0 / math.sqrt(d))


def _launch(q, k_pages, v_pages, page_table, q_pos, scale: float):
    b, w, hq, d = q.shape
    num_pages, psize, hc, _ = k_pages.shape
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    if (ptrs[1] | ptrs[2]) & 15:     # the kernel copies 16-byte vectors
        raise ValueError("spec_verify: the pages must be 16-byte aligned")
    out = torch.empty_like(q)
    lib, fn = _kernel()
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    err = fn(_DTYPE_CODES[q.dtype], *ptrs, page_table.data_ptr(),
             q_pos.data_ptr(), out.data_ptr(), b, w, hq, hc, psize, d,
             page_table.shape[1], num_pages, scale, stream)
    _build.check(err, lib, "spec_verify")
    return out


def spec_verify_plain(q, k_pages, v_pages, page_table,
                      q_pos) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``repro``'s
    ``spec_verify_ref``): gather the row's pages in logical order, mask
    key k for lane i unless k <= q_pos[b, i] and its page id is in
    [0, NP), dense fp32 softmax, P.V in fp32 as the kernel keeps it."""
    b, w, hq, d = q.shape
    k, v, valid = gather_pages(k_pages, v_pages, page_table, q_pos)
    hc = k.shape[2]
    qr = q.float().reshape(b, w, hc, hq // hc, d)
    scores = torch.einsum("bwhrd,bkhd->bwhrk", qr, k) / math.sqrt(d)
    scores = scores.masked_fill(~valid[:, :, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bwhrk,bkhd->bwhrd", probs, v)
    return out.reshape(b, w, hq, d).to(q.dtype)
