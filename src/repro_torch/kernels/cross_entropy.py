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
one dtype; labels (T,) int32 in [0, V), or -1 for a label outside W's
columns (no label logit, no one-hot part). Products and sums are fp32.

Vocab-parallel (tensor parallelism over ``model``):
:func:`cross_entropy_partials` runs the forward on one rank's slice of
W's columns and returns five fp32 partials a token (``PART_*``) instead
of (nll, lse, correct); :func:`combine_partials` combines the ranks'
partials in vocab order as the kernel combines its splits, and the
backward takes the slice, the local labels and the global lse.

Both passes dispatch on the dtype (``uses_tensor_cores``): bf16 and fp16
run the tensor-core kernels, float32 the CUDA-core ones. The tensor-core
forward walks 128-column vocab tiles per block, :func:`tc_vocab_splits`
splits a wave of blocks (float32: :func:`num_vocab_splits`). The
tensor-core backward stages the softmax part of ds, exp(s - lse) g, in
the input dtype (:func:`ds_chunk` columns at a time) and applies its
one-hot part, -g at each token's label, exactly in fp32 where dh and dW
are written (:func:`label_index` lists the tokens of each label for dW).
The tensor-core kernels read hidden and W through tensor maps: d must be
a multiple of 8, hidden 16-byte aligned, and W's rows must start 16-byte
aligned: :func:`aligned_rows` hands over the first V columns of a
row-padded copy (:func:`pad_vocab`) when V is not a multiple of 8, and
``ops.CrossEntropy`` makes that copy once in the forward and keeps it for
the backward. float32 runs the CUDA-core products with the whole ds
staged in fp32, on a contiguous W.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import uses_tensor_cores

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TILE = 64                       # the kernels' token and vocab tile
_TARGET_BLOCKS = 528             # float32 forward: ~4 blocks an H100 SM
_TC_TILE = 128                   # tensor-core forward: token and vocab tile
_DS_SCRATCH_ELEMS = 16 * 2 ** 20  # backward: ds chunk of ~32 MB in bf16/fp16,
                                  # ~64 MB in float32


def _check(hidden, w, labels) -> None:
    """What both passes take: CUDA tensors of one supported dtype and
    agreeing shapes; hidden and labels contiguous; W contiguous (float32;
    bf16/fp16 W may have any strides: the wrappers read it through
    :func:`aligned_rows`)."""
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
    w_ok = uses_tensor_cores(w.dtype) or w.is_contiguous()
    if not (hidden.is_contiguous() and labels.is_contiguous() and w_ok):
        raise ValueError("cross_entropy: hidden, labels (and a float32 w) "
                         "must be contiguous")
    if uses_tensor_cores(hidden.dtype) and (hidden.shape[1] % 8
                                            or hidden.data_ptr() % 16):
        raise ValueError(f"cross_entropy: the tensor-core kernels need d a "
                         f"multiple of 8 (got {hidden.shape[1]}) and hidden "
                         f"16-byte aligned")


def _kernel(name: str):
    lib = _build.load("cross_entropy")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "cross_entropy_fwd":
            fn.argtypes = [i, p, p, i, p, i, i, i, i, p, p, p, p, p]
        elif name == "cross_entropy_partials":
            fn.argtypes = [i, p, p, i, p, i, i, i, i, i, p, p, p]
        else:
            fn.argtypes = [i, p, p, i] + [p] * 5 + [i] * 4 + [p] * 5
        fn.restype = ctypes.c_int
    return lib, fn


def num_vocab_splits(num_tokens: int, vocab: int) -> int:
    """Vocab splits of the float32 forward grid: enough blocks to fill the
    card (``_TARGET_BLOCKS``), never more splits than vocab tiles."""
    t_tiles = -(-num_tokens // _TILE)
    v_tiles = -(-vocab // _TILE)
    return max(1, min(v_tiles, -(-_TARGET_BLOCKS // t_tiles)))


def tc_vocab_splits(num_tokens: int, vocab: int, num_sms: int) -> int:
    """Vocab splits of the tensor-core forward: one wave of blocks (a
    block of 128 tokens a split, one a streaming multiprocessor, since
    its ring takes most of an SM's shared memory), never more splits
    than 128-column vocab tiles."""
    t_tiles = -(-num_tokens // _TC_TILE)
    v_tiles = -(-vocab // _TC_TILE)
    return max(1, min(v_tiles, num_sms // t_tiles))


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


def aligned_rows(w: torch.Tensor) -> torch.Tensor:
    """``w`` (d, V) as a (d, V) tensor whose rows start 16-byte aligned,
    what the tensor-core kernels read: ``w`` itself when they already do
    (any row stride), else the first V columns of :func:`pad_vocab`'s
    copy. Applied to its own result it returns it: no second copy."""
    row_bytes = w.stride(0) * w.element_size() if w.shape[0] > 1 else 0
    if w.stride(1) == 1 and row_bytes % 16 == 0 and w.data_ptr() % 16 == 0:
        return w
    return pad_vocab(w)[:, :w.shape[1]]


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
    correct (T,) int32). bf16/fp16 W is read through :func:`aligned_rows`
    (pass its result to skip the copy). Raises on anything the kernel
    does not take."""
    _check(hidden, w, labels)
    t, d = hidden.shape
    v = w.shape[1]
    dev = hidden.device
    if uses_tensor_cores(hidden.dtype):
        w = aligned_rows(w)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nsplit = tc_vocab_splits(t, v, sms)
    else:
        nsplit = num_vocab_splits(t, v)
    part = torch.empty((5, nsplit, t), dtype=torch.float32, device=dev)
    nll = torch.empty(t, dtype=torch.float32, device=dev)
    lse = torch.empty(t, dtype=torch.float32, device=dev)
    correct = torch.empty(t, dtype=torch.int32, device=dev)
    lib, fn = _kernel("cross_entropy_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPE_CODES[hidden.dtype], hidden.data_ptr(), w.data_ptr(),
             w.stride(0), labels.data_ptr(), t, d, v, nsplit,
             part.data_ptr(), nll.data_ptr(), lse.data_ptr(),
             correct.data_ptr(), stream)
    _build.check(err, lib, "cross_entropy_fwd")
    return nll, lse, correct


def cross_entropy_partials(hidden, w, labels, v0: int) -> torch.Tensor:
    """Launch the vocab-parallel forward on the slice ``w`` = columns
    ``v0`` .. ``v0 + V - 1`` of the whole W, with local ``labels`` (label
    - v0, or -1 outside the slice) -> (5, T) fp32 partials, the planes in
    ``PART_*`` order. W as in :func:`cross_entropy_fwd`."""
    _check(hidden, w, labels)
    t, d = hidden.shape
    v = w.shape[1]
    if not (0 <= v0 and v0 + v <= 2 ** 24):
        raise ValueError(f"cross_entropy_partials: vocab columns {v0} + {v} "
                         f"past 2**24 (indices travel as fp32 values)")
    dev = hidden.device
    if uses_tensor_cores(hidden.dtype):
        w = aligned_rows(w)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nsplit = tc_vocab_splits(t, v, sms)
    else:
        nsplit = num_vocab_splits(t, v)
    part = torch.empty((5, nsplit, t), dtype=torch.float32, device=dev)
    out = torch.empty((5, t), dtype=torch.float32, device=dev)
    lib, fn = _kernel("cross_entropy_partials")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPE_CODES[hidden.dtype], hidden.data_ptr(), w.data_ptr(),
             w.stride(0), labels.data_ptr(), t, d, v, nsplit, v0,
             part.data_ptr(), out.data_ptr(), stream)
    _build.check(err, lib, "cross_entropy_partials")
    return out


def cross_entropy_bwd(hidden, w, labels, lse, g, dh_fp32: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA backward -> (dh (T, d), dw (d, V), contiguous) in
    the inputs' dtype, for ``g`` = dLoss/dnll (T,) and the forward's
    ``lse``; with ``dh_fp32``, dh in fp32, unrounded (the vocab-parallel
    backward sums the ranks' dh before it rounds). bf16/fp16 W as in
    :func:`cross_entropy_fwd`."""
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
    if tc:
        w = aligned_rows(w)
    order, starts = label_index(labels, v) if tc else (None, None)
    ds = torch.empty((t, chunk), dtype=hidden.dtype if tc else torch.float32,
                     device=dev)
    dh_acc = torch.empty((t, d), dtype=torch.float32, device=dev)
    dh = None if dh_fp32 else torch.empty_like(hidden)
    dw = torch.empty((d, v), dtype=w.dtype, device=dev)
    lib, fn = _kernel("cross_entropy_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPE_CODES[hidden.dtype], hidden.data_ptr(),
             w.data_ptr(), w.stride(0), labels.data_ptr(),
             None if order is None else order.data_ptr(),
             None if starts is None else starts.data_ptr(),
             lse.data_ptr(), g.data_ptr(), t, d, v, chunk, ds.data_ptr(),
             dh_acc.data_ptr(), None if dh is None else dh.data_ptr(),
             dw.data_ptr(), stream)
    _build.check(err, lib, "cross_entropy_bwd")
    return (dh_acc if dh is None else dh), dw


def _logits(hidden, w):
    return torch.matmul(hidden.float(), w.float())


def _label_logits(logits, labels):
    """logits[t, labels[t]], 0 where the label is -1."""
    lab = labels.long()
    tgt = logits.gather(1, lab.clamp(min=0)[:, None])[:, 0]
    return torch.where(lab >= 0, tgt, torch.zeros_like(tgt))


def cross_entropy_fwd_plain(hidden, w, labels):
    """The forward kernel's function in plain PyTorch (full logits)."""
    logits = _logits(hidden, w)
    lse = torch.logsumexp(logits, dim=-1)
    correct = (logits.argmax(dim=-1) == labels.long()).to(torch.int32)
    return lse - _label_logits(logits, labels), lse, correct


def cross_entropy_bwd_plain(hidden, w, labels, lse, g,
                            dh_fp32: bool = False):
    """The backward kernel's function in plain PyTorch: recompute the
    logits, ds = (exp(s - lse) - onehot(label)) * g (no one-hot part for a
    label of -1), dh = ds W^T, dw = h^T ds, all fp32, rounded once to the
    inputs' dtype (dh left in fp32 with ``dh_fp32``)."""
    logits = _logits(hidden, w)
    ds = torch.exp(logits - lse[:, None])
    rows = (labels >= 0).nonzero()[:, 0]
    ds[rows, labels[rows].long()] -= 1.0
    ds = ds * g.float()[:, None]
    dh = torch.matmul(ds, w.float().T)
    dw = torch.matmul(hidden.float().T, ds)
    return (dh if dh_fp32 else dh.to(hidden.dtype)), dw.to(w.dtype)


# The planes of the vocab-parallel partials, the kernel's kPart* order.
PART_MAX, PART_SUM, PART_BEST, PART_INDEX, PART_LABEL = range(5)


def cross_entropy_partials_plain(hidden, w, labels, v0: int) -> torch.Tensor:
    """:func:`cross_entropy_partials`' function in plain PyTorch."""
    logits = _logits(hidden, w)
    index = logits.argmax(dim=-1)              # the first index on ties
    best = logits.gather(1, index[:, None])[:, 0]
    total = torch.exp(logits - best[:, None]).sum(dim=-1)
    return torch.stack([best, total, best, (index + v0).float(),
                        _label_logits(logits, labels)])


def combine_partials(parts, labels):
    """The vocab slices' partials (R, 5, T), slice r holding the columns
    after those of slice r - 1, with the whole vocab's ``labels`` (T,) ->
    (nll, lse, correct) as :func:`cross_entropy_fwd` over the whole vocab
    returns them. The arithmetic of the kernel's ``xent_combine_kernel``,
    slice by slice in order: the best logit moves only to a strictly larger
    one, so ``correct`` follows argmax's first index over the vocab. Plain
    PyTorch on both devices: a (5, T) step after the ranks' all-gather,
    equal bit for bit on every rank that holds the same ``parts``."""
    m = parts[:, PART_MAX].amax(dim=0)
    total = torch.zeros_like(m)
    label_logit = torch.zeros_like(m)
    best = torch.full_like(m, -float("inf"))
    index = torch.full_like(m, -1.0)
    for p in parts:
        total = total + p[PART_SUM] * torch.exp(p[PART_MAX] - m)
        label_logit = label_logit + p[PART_LABEL]
        up = p[PART_BEST] > best
        best = torch.where(up, p[PART_BEST], best)
        index = torch.where(up, p[PART_INDEX], index)
    lse = m + torch.log(torch.clamp(total, min=1e-30))
    correct = (index == labels.float()).to(torch.int32)
    return lse - label_logit, lse, correct
