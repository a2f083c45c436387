"""Fused LM-head cross-entropy: the hand-written CUDA kernels and their
plain versions.

Replaces the Pallas TPU kernel ``src/repro/kernels/cross_entropy.py``
(``fused_cross_entropy``), which the port's ``chunked_xent`` runs in
place of ``repro``'s plain-JAX chunked loss. The kernels live in
``csrc/cross_entropy.cu`` (design and bound notes there):
:func:`cross_entropy_fwd` returns, per token, the NLL, the logsumexp and
whether the argmax (first index on ties, as ``jnp.argmax``) is the label;
:func:`cross_entropy_bwd` returns the gradients of ``Σ g · nll`` with
respect to the hidden states and the vocab matrix. Neither materializes
the (T, V) logits. :func:`cross_entropy_fwd_plain` and
:func:`cross_entropy_bwd_plain` compute the same functions in plain
PyTorch — the CPU path and the on-card oracle.

Shapes: hidden (T, d), w (d, V), both float32, bfloat16 or float16 of
one dtype; labels (T,) int32 in [0, V). Products and sums are fp32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TILE = 64                       # the kernels' token and vocab tile
_TARGET_BLOCKS = 528             # forward: ~4 blocks per SM of an H100
_DS_SCRATCH_ELEMS = 16 * 2 ** 20  # backward: fp32 ds chunk of ~64 MB


def _check(hidden, w, labels) -> None:
    if not (hidden.is_cuda and w.device == hidden.device
            and labels.device == hidden.device):
        raise ValueError("cross_entropy: hidden, w, labels must be CUDA "
                         "tensors on one device")
    if hidden.dtype not in _DTYPE_CODES or w.dtype != hidden.dtype:
        raise ValueError(f"cross_entropy: unsupported dtypes "
                         f"{hidden.dtype}/{w.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError("cross_entropy: labels must be int32")
    if hidden.dim() != 2 or w.dim() != 2 or hidden.shape[1] != w.shape[0] \
            or labels.shape != (hidden.shape[0],):
        raise ValueError(f"cross_entropy: shapes hidden "
                         f"{tuple(hidden.shape)}, w {tuple(w.shape)}, "
                         f"labels {tuple(labels.shape)} disagree")
    if not (hidden.is_contiguous() and w.is_contiguous()
            and labels.is_contiguous()):
        raise ValueError("cross_entropy: hidden, w, labels must be "
                         "contiguous")


def _kernel(name: str):
    lib = _build.load("cross_entropy")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "cross_entropy_fwd":
            fn.argtypes = [i, p, p, p, i, i, i, i, p, p, p, p, p]
        else:
            fn.argtypes = [i, p, p, p, p, p, i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib, fn


def num_vocab_splits(num_tokens: int, vocab: int) -> int:
    """Vocab splits of the forward grid: enough blocks to fill the card
    (``_TARGET_BLOCKS``), never more splits than vocab tiles."""
    t_tiles = -(-num_tokens // _TILE)
    v_tiles = -(-vocab // _TILE)
    return max(1, min(v_tiles, -(-_TARGET_BLOCKS // t_tiles)))


def ds_chunk(num_tokens: int, vocab: int) -> int:
    """Vocab columns per backward chunk: a multiple of the tile, with the
    (T, chunk) fp32 ds scratch near ``_DS_SCRATCH_ELEMS``."""
    cols = max(_TILE, _DS_SCRATCH_ELEMS // max(num_tokens, 1))
    cols = (cols // _TILE) * _TILE
    return min(cols, -(-vocab // _TILE) * _TILE)


def cross_entropy_fwd(hidden, w, labels
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA forward -> (nll (T,) fp32, lse (T,) fp32,
    correct (T,) int32). Raises on anything the kernel does not take."""
    _check(hidden, w, labels)
    t, d = hidden.shape
    v = w.shape[1]
    nsplit = num_vocab_splits(t, v)
    dev = hidden.device
    part = torch.empty((5, nsplit, t), dtype=torch.float32, device=dev)
    nll = torch.empty(t, dtype=torch.float32, device=dev)
    lse = torch.empty(t, dtype=torch.float32, device=dev)
    correct = torch.empty(t, dtype=torch.int32, device=dev)
    lib, fn = _kernel("cross_entropy_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPE_CODES[hidden.dtype], hidden.data_ptr(), w.data_ptr(),
             labels.data_ptr(), t, d, v, nsplit, part.data_ptr(),
             nll.data_ptr(), lse.data_ptr(), correct.data_ptr(), stream)
    _build.check(err, lib, "cross_entropy_fwd")
    return nll, lse, correct


def cross_entropy_bwd(hidden, w, labels, lse, g
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA backward -> (dh (T, d), dw (d, V)) in the inputs'
    dtype, for ``g`` = dLoss/dnll (T,) and the forward's ``lse``."""
    _check(hidden, w, labels)
    t, d = hidden.shape
    v = w.shape[1]
    for name, x in (("lse", lse), ("g", g)):
        if x.shape != (t,) or x.dtype != torch.float32 \
                or x.device != hidden.device or not x.is_contiguous():
            raise ValueError(f"cross_entropy_bwd: {name} must be a "
                             f"contiguous (T,) float32 tensor on the card")
    chunk = ds_chunk(t, v)
    dev = hidden.device
    ds = torch.empty((t, chunk), dtype=torch.float32, device=dev)
    dh_acc = torch.empty((t, d), dtype=torch.float32, device=dev)
    dh = torch.empty_like(hidden)
    dw = torch.empty_like(w)
    lib, fn = _kernel("cross_entropy_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPE_CODES[hidden.dtype], hidden.data_ptr(), w.data_ptr(),
             labels.data_ptr(), lse.data_ptr(), g.data_ptr(), t, d, v, chunk,
             ds.data_ptr(), dh_acc.data_ptr(), dh.data_ptr(), dw.data_ptr(),
             stream)
    _build.check(err, lib, "cross_entropy_bwd")
    return dh, dw


def _logits(hidden, w):
    return torch.matmul(hidden.float(), w.float())


def cross_entropy_fwd_plain(hidden, w, labels):
    """The forward kernel's function in plain PyTorch (full logits)."""
    logits = _logits(hidden, w)
    lse = torch.logsumexp(logits, dim=-1)
    lab = labels.long()
    tgt = logits.gather(1, lab[:, None])[:, 0]
    correct = (logits.argmax(dim=-1) == lab).to(torch.int32)
    return lse - tgt, lse, correct


def cross_entropy_bwd_plain(hidden, w, labels, lse, g):
    """The backward kernel's function in plain PyTorch: recompute the
    logits, ds = (exp(s - lse) - onehot(label)) * g, dh = ds W^T,
    dw = h^T ds, all fp32, rounded once to the inputs' dtype."""
    logits = _logits(hidden, w)
    ds = torch.exp(logits - lse[:, None])
    ds[torch.arange(ds.shape[0], device=ds.device), labels.long()] -= 1.0
    ds = ds * g.float()[:, None]
    dh = torch.matmul(ds, w.float().T)
    dw = torch.matmul(hidden.float().T, ds)
    return dh.to(hidden.dtype), dw.to(w.dtype)
