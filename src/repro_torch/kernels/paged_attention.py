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
from repro_torch.kernels.flash_attention import pad_head_dim

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 128
_MAX_REP = 16


def _check(q, k_pages, v_pages, page_table, pos):
    """Raise on anything the kernel does not take. Called on every decode
    step of every layer, so it reads each attribute once and compares
    device indices (``get_device``) rather than ``torch.device`` objects."""
    dev = q.get_device()
    if not q.is_cuda or k_pages.get_device() != dev \
            or v_pages.get_device() != dev \
            or page_table.get_device() != dev or pos.get_device() != dev:
        raise ValueError("paged_attention: every input must be a CUDA "
                         "tensor on one device")
    dtype = q.dtype
    if dtype not in _DTYPE_CODES or k_pages.dtype != dtype \
            or v_pages.dtype != dtype:
        raise ValueError(f"paged_attention: unsupported dtypes "
                         f"{dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_attention: page_table and pos must be int32")
    qs, ks, ts = q.shape, k_pages.shape, page_table.shape
    b, hq, d = qs
    if v_pages.shape != ks or len(ks) != 4 or ks[3] != d:
        raise ValueError(f"paged_attention: pages {tuple(ks)} do not match "
                         f"q {tuple(qs)}")
    hc = ks[2]
    if hq % hc or hq // hc > _MAX_REP:
        raise ValueError(f"paged_attention: Hq {hq} must be a multiple of "
                         f"Hc {hc}, at most {_MAX_REP}x")
    if not 0 < d <= _MAX_D:
        raise ValueError(f"paged_attention: head_dim {d} must be in "
                         f"1..{_MAX_D}")
    if len(ts) != 2 or ts[0] != b or pos.shape != (b,):
        raise ValueError("paged_attention: page_table (B, M) / pos (B,) "
                         "shapes disagree with q")
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous() and page_table.is_contiguous()
            and pos.is_contiguous()):
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
    """Launch the CUDA kernel; raises on anything it does not take. A
    head_dim that is not a multiple of 8 runs on zero-padded copies of q
    and of the whole page pool, made per call (a reduced-config path:
    ``flash_attention``'s module docstring says why the padding is
    exact)."""
    _check(q, k_pages, v_pages, page_table, pos)
    d = q.shape[2]
    if d % 8:
        return _launch(pad_head_dim(q), pad_head_dim(k_pages),
                       pad_head_dim(v_pages), page_table, pos,
                       1.0 / math.sqrt(d))[..., :d].contiguous()
    return _launch(q, k_pages, v_pages, page_table, pos, 1.0 / math.sqrt(d))


def _launch(q, k_pages, v_pages, page_table, pos, scale: float):
    b, hq, d = q.shape
    num_pages, psize, hc, _ = k_pages.shape
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    if (ptrs[1] | ptrs[2]) & 15:     # the kernel copies 16-byte vectors
        raise ValueError("paged_attention: the pages must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    lib, fn = _kernel()
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    err = fn(_DTYPE_CODES[q.dtype], *ptrs, page_table.data_ptr(),
             pos.data_ptr(), out.data_ptr(), b, hq, hc, psize, d,
             page_table.shape[1], num_pages, scale, stream)
    _build.check(err, lib, "paged_attention")
    return out


def split_partials_plain(q, k_pages, v_pages, page_table, pos, shares: int,
                         tile: int):
    """The kernels' per-warp partial states in plain PyTorch: key k of a
    row goes to share (k // tile) % shares (tiles dealt to the warps in
    turn); each share keeps its own online-softmax state over its visible
    keys: m its largest scaled score (-1e30 if it has none), l the sum of
    exp(s - m) and acc the sum of exp(s - m) v, all fp32. B2's q is
    (B, Hq, D) with pos (B,); B3's (B, W, Hq, D) with a position for each
    lane, q_pos (B, W). Returns (m, l, acc), each with a leading
    ``shares`` axis: m and l q's shape without D, acc q's shape."""
    *lead, hq, d = q.shape
    k, v, valid = gather_pages(k_pages, v_pages, page_table, pos)
    hc = k.shape[2]
    scores = torch.einsum("b...hrd,bkhd->b...hrk", q.float().reshape(
        *lead, hc, hq // hc, d), k) / math.sqrt(d)
    share = (torch.arange(k.shape[1], device=q.device) // tile) % shares
    ms, ls, accs = [], [], []
    for w in range(shares):
        mask = (valid & (share == w))[..., None, None, :]
        s = scores.masked_fill(~mask, _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m) * mask
        ms.append(m[..., 0].reshape(*lead, hq))
        ls.append(p.sum(dim=-1).reshape(*lead, hq))
        accs.append(torch.einsum("b...hrk,bkhd->b...hrd", p, v).reshape(
            *lead, hq, d))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials_plain(m, l, acc, dtype) -> torch.Tensor:
    """The kernel's combine of its warps' partial states (leading axis):
    rescale each to the largest m and divide the summed acc by the summed
    l, clamped at 1e-20. A share with no visible key (m = -1e30, l = 0,
    acc = 0) adds nothing; if no share has one, the output is 0."""
    f = torch.exp(m - m.amax(dim=0))
    den = (f * l).sum(dim=0)
    num = (f[..., None] * acc).sum(dim=0)
    return (num / den.clamp_min(1e-20)[..., None]).to(dtype)


def gather_pages(k_pages, v_pages, page_table, pos):
    """Each row's keys and values in logical order (B, M P, Hc, D) fp32,
    and which are visible: position <= pos and on a page id in [0, NP)
    (other ids read page 0 and are masked). ``pos`` is (B,) or (B, W), a
    position for each lane; ``valid`` is (B, M P) or (B, W, M P)."""
    num_pages, psize = k_pages.shape[:2]
    b, m = page_table.shape
    idx = page_table.long()
    in_pool = (idx >= 0) & (idx < num_pages)
    idx = torch.where(in_pool, idx, torch.zeros_like(idx))
    k = k_pages[idx].reshape(b, m * psize, *k_pages.shape[2:]).float()
    v = v_pages[idx].reshape(b, m * psize, *v_pages.shape[2:]).float()
    lanes = (1,) * (pos.dim() - 1)
    valid = ((torch.arange(m * psize, device=pos.device)
              <= pos.long()[..., None])
             & in_pool.repeat_interleave(psize, dim=1).reshape(
                 b, *lanes, m * psize))
    return k, v, valid


def paged_attention_plain(q, k_pages, v_pages, page_table,
                          pos) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the row's pages in
    logical order, mask keys past ``pos`` or on a page id outside
    [0, NP), dense fp32 softmax."""
    b, hq, d = q.shape
    k, v, valid = gather_pages(k_pages, v_pages, page_table, pos)
    hc = k.shape[2]
    qr = q.float().reshape(b, hc, hq // hc, d)
    scores = torch.einsum("bhrd,bkhd->bhrk", qr, k) / math.sqrt(d)
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", probs, v)
    return out.reshape(b, hq, d).to(q.dtype)
