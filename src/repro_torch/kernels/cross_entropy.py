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

The backward dispatches on the dtype (``uses_tensor_cores``): bf16 and
fp16 run the tensor-core products, with the softmax part of ds,
exp(s - lse) g, staged in the input dtype (:func:`ds_chunk` columns at a
time) and its one-hot part, -g at each token's label, applied exactly in
fp32 where dh and dW are written (:func:`label_index` lists the tokens
of each label for dW). W is read through a tensor map, so its rows must
start 16-byte aligned: :func:`pad_vocab` hands over a row-padded copy
when V is not a multiple of 8 (d must be). float32 runs the CUDA-core
products with the whole ds staged in fp32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import uses_tensor_cores

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TILE = 64                       # the kernels' token and vocab tile
_TARGET_BLOCKS = 528             # forward: ~4 blocks per SM of an H100
_DS_SCRATCH_ELEMS = 16 * 2 ** 20  # backward: ds chunk of ~32 MB in bf16/fp16,
                                  # ~64 MB in float32


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
            fn.argtypes = [i, p, p, i] + [p] * 5 + [i] * 4 + [p] * 5
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


def padded_vocab(vocab: int, dtype: torch.dtype) -> int:
    """W's row length as the tensor-core backward reads it: the least
    multiple of 16 bytes that holds ``vocab`` values of ``dtype``."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-vocab // per) * per


def pad_vocab(w: torch.Tensor) -> torch.Tensor:
    """``w`` (d, V) as a (d, V_pad) buffer whose rows start 16-byte
    aligned (V_pad = :func:`padded_vocab`); ``w`` itself when it already
    is. The padding columns are zero; the kernel never reads them."""
    d, v = w.shape
    v_pad = padded_vocab(v, w.dtype)
    if v_pad == v and w.is_contiguous() and w.data_ptr() % 16 == 0:
        return w
    out = torch.empty((d, v_pad), dtype=w.dtype, device=w.device)
    out[:, :v].copy_(w)
    out[:, v:].zero_()
    return out


def label_index(labels: torch.Tensor, vocab: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, starts), both int32: the tokens sorted by label, ties in
    token order, and for each label c the first position of c in that
    order (``starts[vocab]`` = T), so the tokens labelled c are
    ``order[starts[c]:starts[c + 1]]``."""
    sorted_labels, order = torch.sort(labels.long(), stable=True)
    starts = torch.searchsorted(
        sorted_labels, torch.arange(vocab + 1, device=labels.device))
    return order.to(torch.int32), starts.to(torch.int32)


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
    tc = uses_tensor_cores(hidden.dtype)
    if tc and (d % 8 or hidden.data_ptr() % 16):
        raise ValueError(f"cross_entropy_bwd: the tensor-core kernel needs "
                         f"d a multiple of 8 (got {d}) and hidden 16-byte "
                         f"aligned")
    w_rows = pad_vocab(w) if tc else w
    order, starts = label_index(labels, v) if tc else (None, None)
    ds = torch.empty((t, chunk), dtype=hidden.dtype if tc else torch.float32,
                     device=dev)
    dh_acc = torch.empty((t, d), dtype=torch.float32, device=dev)
    dh = torch.empty_like(hidden)
    dw = torch.empty_like(w)
    lib, fn = _kernel("cross_entropy_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPE_CODES[hidden.dtype], hidden.data_ptr(),
             w_rows.data_ptr(), w_rows.stride(0), labels.data_ptr(),
             None if order is None else order.data_ptr(),
             None if starts is None else starts.data_ptr(),
             lse.data_ptr(), g.data_ptr(), t, d, v, chunk, ds.data_ptr(),
             dh_acc.data_ptr(), dh.data_ptr(), dw.data_ptr(), stream)
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
