"""Flat-key npz checkpoints and the weights bridge from ``repro``.

Reads the format of ``repro.checkpoint.io`` (``save``/``restore``): keys
joined by ``/``, list entries keyed ``#i``, bfloat16 leaves stored as
uint16 and listed in ``__bf16_keys__``. :func:`restore` returns the
port's parameter tree (nested dicts of tensors) on a given device, and
:func:`from_numpy_tree` does the same for an in-memory nested dict of
numpy arrays (e.g. ``jax.device_get`` of a ``repro`` params tree), and
:func:`train_state_from_numpy` carries a whole ``repro`` TrainState
(params, optimizer state, step) across. :func:`save` writes the format
back. All are bit-exact: bf16 leaves move as raw 16-bit patterns. The LM
keeps JAX's ``(d_in, d_out)`` weight layout, so no leaf is transposed.
The three loaders put the tree on the card unless the caller passes
``device="cpu"``; without a card they raise
(:func:`repro_torch.device.resolve_device`).

On a mesh of ranks (``repro_torch.launch.mesh``) a state is stored in
blocks (``repro_torch.sharding`` layouts). ``save(..., mesh=, layouts=)``
is called by every rank: it gathers each leaf and rank 0 writes the
whole tree in the same format; ``restore(..., mesh=, layouts=)`` gives
each rank its blocks, read leaf by leaf from the file.
"""
from __future__ import annotations

from typing import Any, Dict

import os

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "/"


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.startswith("#") for k in keys):
            items = sorted(((int(k[1:]), v) for k, v in node.items()))
            return [rebuild(v) for _, v in items]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """Raw bf16 bit patterns (uint16) -> a bfloat16 tensor, bit-exact."""
    return torch.from_numpy(
        np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _leaf_to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bf16 from jax
        return _bf16_from_bits(arr.view(np.uint16))
    return torch.from_numpy(np.array(arr))


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def from_numpy_tree(tree: Any, device="cuda") -> Any:
    """Nested dict/list of numpy arrays -> the same tree of tensors on
    ``device`` (bf16 arrays keep their exact bits)."""
    return _numpy_tree(tree, resolve_device(device))


def _numpy_tree(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v, device) for v in tree]
    return _leaf_to_tensor(tree).to(device)


def train_state_from_numpy(params: Any, opt_state: Any, step,
                           device="cuda"):
    """A ``repro`` TrainState's parts, as numpy trees (``jax.device_get``
    of ``state.params`` / ``state.opt_state``), -> the port's
    :class:`repro_torch.optim.TrainState` on ``device``: params marked as
    differentiable leaves, optimizer slots (``mu`` or ``m``, ``v``,
    ``count``) bit-exact, ``step`` a Python int."""
    from repro_torch.core.psl import requires_grad_
    from repro_torch.optim import TrainState
    return TrainState(params=requires_grad_(from_numpy_tree(params, device)),
                      opt_state=from_numpy_tree(opt_state, device),
                      step=int(np.asarray(step)))


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix[:-len(_SEP)]] = tree
    return out


def _flat_layouts(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A layout tree flattened like :func:`_flatten` (a layout, itself a
    tuple, is a leaf)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat_layouts(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat_layouts(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix[:-len(_SEP)]] = tree
    return out


def _mesh_comm(mesh, layouts):
    if layouts is None:
        raise ValueError("a sharded checkpoint needs the tree's layouts "
                         "(e.g. engine.param_layouts) beside its mesh")
    from repro_torch.launch.mesh import MeshComm
    return MeshComm(mesh)


def save(path: str, tree: Any, mesh=None, layouts=None) -> None:
    """Write a tree of tensors in ``repro``'s npz format (bf16 leaves as
    uint16 bit patterns listed in ``__bf16_keys__``). With ``mesh`` every
    rank calls it with its blocks and their ``layouts``; each leaf is
    gathered and rank 0 writes."""
    flat = _flatten(tree)
    main = True
    if mesh is not None:
        from repro_torch.launch.mesh import is_main_process
        from repro_torch.sharding import whole_shape
        comm = _mesh_comm(mesh, layouts)
        main = is_main_process()
        lays = _flat_layouts(layouts)
        for k, t in flat.items():
            whole = comm.all_gather_leaf(
                t.detach(), lays[k], whole_shape(t.shape, lays[k],
                                                 comm.sizes))
            flat[k] = whole.cpu() if main else None
    if not main:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays, bf16 = {}, []
    for k, t in flat.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[k] = t.view(torch.int16).numpy().view(np.uint16)
            bf16.append(k)
        else:
            arrays[k] = t.numpy()
    arrays["__bf16_keys__"] = np.array(sorted(bf16), dtype=object)
    np.savez(path, **arrays)


def restore(path: str, device="cuda", mesh=None, layouts=None) -> Any:
    """Load a ``repro``-format npz checkpoint onto ``device``; with
    ``mesh`` and ``layouts``, only this rank's block of each leaf."""
    device = resolve_device(device)
    lays = None
    if mesh is not None:
        from repro_torch.sharding import block_slices
        comm = _mesh_comm(mesh, layouts)
        lays = _flat_layouts(layouts)
    with np.load(path, allow_pickle=True) as data:
        bf16 = set(data["__bf16_keys__"].tolist())
        flat = {}
        for k in data.files:
            if k == "__bf16_keys__":
                continue
            v = data[k]
            if lays is not None:
                v = v[block_slices(v.shape, lays[k], comm.sizes,
                                   comm.coord)]
            flat[k] = (_bf16_from_bits(v) if k in bf16
                       else torch.from_numpy(np.ascontiguousarray(v)))
    return _to_device(_unflatten(flat), device)

