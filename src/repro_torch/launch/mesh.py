"""Meshes of ranks for the port's sharded PSL engine (port of
:mod:`repro.launch.mesh`).

``repro`` runs one controller over many devices. The port runs one
process a rank, all running the same program, which is torch's own
idiom: a rank's entry point is started by ``python -m
torch.distributed.run --nproc-per-node N``. A training mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` over every rank of the initialized process group.

Backend rule (:func:`backend_for`), chosen before the group is made and
never switched after an error:

* ``nccl`` where each rank on a node has a card of its own;
* ``gloo`` where ranks share a card, or on the CPU (``device="cpu"``).

A rank runs on ``cuda:(local_rank % device_count)`` (:func:`rank_device`).

:class:`MeshComm` carries out the engine's collectives over a mesh (all
reduce, all gather and reduce scatter of a leaf along its layout) and
counts their calls, bytes and, when asked, their milliseconds by kind.

``repro``'s TPU v5e constants (``PEAK_FLOPS_BF16``, ``HBM_BW``,
``ICI_BW``) are not carried: nothing in the port reads them.
"""
from __future__ import annotations

import math
import os
import time
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("data", "model")
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter")


def world_size() -> int:
    """Ranks of the initialized group, else of the ``torch.distributed.run``
    environment (``WORLD_SIZE``), else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def is_main_process() -> bool:
    """True on rank 0, and in a process that belongs to no group: the one
    rank that writes files (checkpoints, event logs, traces)."""
    return rank() == 0


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` for
    ``"cuda"`` (raising without a card, as every entry point does), the
    CPU for ``"cpu"``; an indexed device is kept as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def backend_for(device, local_world_size: int) -> str:
    """``nccl`` where each of the node's ``local_world_size`` ranks has a
    card of its own, ``gloo`` where ranks share a card or run on the
    CPU."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return ("nccl" if local_world_size <= torch.cuda.device_count()
            else "gloo")


def init_process_group(device="cuda", *, init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout_s: Optional[float] = None) -> str:
    """Initialize the default process group if none exists, with the
    backend :func:`backend_for` picks for ``device``; returns the group's
    backend.

    Without ``init_method`` the group comes from the
    ``torch.distributed.run`` environment (``env://``); a process started
    without one is a group of one rank. Tests and ``chip_smoke.py`` start
    their ranks with a ``file://`` ``init_method``, its ``rank`` and
    ``world_size``, all ranks on one node."""
    if dist.is_initialized():
        return dist.get_backend()
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = timedelta(seconds=timeout_s)
    if init_method is None and "RANK" not in os.environ:
        dist.init_process_group(backend_for(device, 1),
                                store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
        return dist.get_backend()
    if init_method is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ["WORLD_SIZE"]))
        backend = backend_for(device, local)
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        backend = backend_for(device, world_size)
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size, **kw)
    return backend


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """``"DxM"`` (also ``"D×M"``) → (data, model) axis sizes; ``"auto"``
    → every rank on the data axis. Raises on malformed specs."""
    if spec == "auto":
        return (world_size(), 1)
    parts = spec.replace("×", "x").lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        raise ValueError(
            f"mesh spec {spec!r}: expected 'DATAxMODEL' (e.g. '4x1') or "
            "'auto'")
    return (int(parts[0]), int(parts[1]))


def make_training_mesh(spec: str = "auto", device="cuda"):
    """(data × model) DeviceMesh over every rank, for the sharded PSL
    engine. Initializes the process group (:func:`init_process_group`)
    when none exists. The mesh must hold exactly the running ranks:
    launch ``D*M`` of them with ``python -m torch.distributed.run
    --nproc-per-node D*M``."""
    from torch.distributed.device_mesh import DeviceMesh
    data, model = parse_mesh_spec(spec)
    n = world_size()
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} ranks but "
            f"{n} {'is' if n == 1 else 'are'} running; launch "
            f"{data * model} with python -m torch.distributed.run "
            f"--nproc-per-node {data * model}")
    dev = rank_device(device)
    init_process_group(dev)
    return DeviceMesh(dev.type, torch.arange(n).reshape(data, model),
                      mesh_dim_names=AXES)


def make_host_mesh(model_axis: int = 1, device="cuda"):
    """A mesh over every running rank: ``model_axis`` ranks (at most all)
    on ``model``, the rest on ``data``."""
    n = world_size()
    model_axis = min(model_axis, n)
    return make_training_mesh(f"{n // model_axis}x{model_axis}", device)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name → size of a DeviceMesh, a ``jax`` Mesh or a duck-typed
    mesh with ``.shape`` (a name → size mapping) and ``.axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


class MeshComm:
    """The engine's collectives over a ("data", "model") DeviceMesh that
    holds every rank in order (rank r at (r // M, r % M)), with a count
    of calls and bytes by kind (``stats``). With ``timed`` each collective
    is bracketed by device synchronizations and its milliseconds are
    added up too; that serializes the step, so it is for measurement.

    A group over a set of axes is that axis's sub-group, the whole world
    for both; group rank j is the row-major index over the set's axes in
    mesh order, which is also the shard index of a dim sharded over those
    axes in that order."""

    def __init__(self, mesh, timed: bool = False):
        if tuple(mesh.mesh_dim_names) != AXES:
            raise ValueError(f"a training mesh has dims {AXES}, not "
                             f"{mesh.mesh_dim_names}")
        n = mesh.size()
        if n != dist.get_world_size() or not torch.equal(
                mesh.mesh.cpu(), torch.arange(n).reshape(mesh.shape)):
            raise ValueError("the mesh must hold every rank, in rank "
                             "order (make_training_mesh builds one)")
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        self.coord = dict(zip(AXES, mesh.get_coordinate()))
        self.device_type = mesh.device_type
        self.timed = timed
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {k: {"calls": 0, "bytes": 0, "ms": 0.0}
                      for k in COLLECTIVES}

    def _group(self, axes: Sequence[str]):
        """(group, size) over ``axes``; (None, 1) when they hold one rank."""
        axes = [a for a in AXES if a in axes]
        n = math.prod(self.sizes[a] for a in axes)
        if n == 1:
            return None, 1
        if len(axes) == len(AXES):
            return dist.group.WORLD, n
        return self.mesh.get_group(axes[0]), n

    def _run(self, kind: str, nbytes: int, fn) -> None:
        sync = self.timed and self.device_type == "cuda"
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        st = self.stats[kind]
        st["calls"] += 1
        st["bytes"] += nbytes
        if self.timed:
            st["ms"] += (time.perf_counter() - t0) * 1e3

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Sum ``t`` in place over the ranks that differ along ``axes``."""
        group, n = self._group(axes)
        if n > 1:
            self._run("all_reduce", t.numel() * t.element_size(),
                      lambda: dist.all_reduce(t, group=group))
        return t

    def all_gather(self, t: torch.Tensor, axes: Sequence[str]
                   ) -> torch.Tensor:
        """Every rank's ``t`` over ``axes``, stacked in group-rank order:
        (n, *t.shape)."""
        group, n = self._group(axes)
        if n == 1:
            return t[None]
        flat = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
        self._run("all_gather", flat.numel() * flat.element_size(),
                  lambda: dist.all_gather_into_tensor(
                      flat, t.reshape(-1), group=group))
        return flat.view((n,) + tuple(t.shape))

    def group_coords(self, axes: Sequence[str], j: int) -> Dict[str, int]:
        """Coordinates of group rank ``j`` of the group over ``axes``."""
        out = {}
        for a in reversed([a for a in AXES if a in axes]):
            j, out[a] = divmod(j, self.sizes[a])
        return out

    def all_gather_leaf(self, local: torch.Tensor, layout,
                        full_shape) -> torch.Tensor:
        """The whole leaf from every rank's slice of it (``layout``: each
        dim's tuple of mesh axes); a replicated leaf is returned as it
        is."""
        from repro_torch.sharding import block_slices, layout_axes
        axes = layout_axes(layout)
        n = self._group(axes)[1]
        if n == 1:
            return local
        parts = self.all_gather(local, axes)
        full = torch.empty(tuple(full_shape), dtype=local.dtype,
                           device=local.device)
        for j in range(n):
            coord = {**self.coord, **self.group_coords(axes, j)}
            full[block_slices(full.shape, layout, self.sizes, coord)] = \
                parts[j]
        return full

    def reduce_scatter_leaf(self, full: torch.Tensor, layout,
                            axes: Sequence[str]) -> torch.Tensor:
        """This rank's slice (``layout``) of ``full`` summed over the
        ranks that differ along ``axes``. A leaf whose one sharded dim is
        split over exactly ``axes`` is reduce-scattered along that dim;
        any other is all-reduced and sliced. Axes of one rank split
        nothing and are left out of the comparison."""
        from repro_torch.sharding import layout_axes, local_slice
        group, n = self._group(axes)

        def split(entry):
            return tuple(a for a in entry if self.sizes[a] > 1)
        sharded = [d for d, e in enumerate(layout) if split(e)]
        if n > 1 and len(sharded) == 1 and split(layout[sharded[0]]) == \
                split(a for a in AXES if a in axes):
            d = sharded[0]
            src = full.movedim(d, 0).contiguous()
            out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                              dtype=full.dtype, device=full.device)
            self._run("reduce_scatter", src.numel() * src.element_size(),
                      lambda: dist.reduce_scatter_tensor(out, src,
                                                         group=group))
            return out.movedim(0, d).contiguous()
        self.all_reduce(full, axes)
        if not layout_axes(layout):
            return full
        return local_slice(full, layout, self.sizes, self.coord).clone()

    def all_gather_ints(self, values: Sequence[int]) -> list:
        """Every rank's list of int64 ``values``, in rank order."""
        group, n = self._group(AXES)
        device = (torch.device("cpu") if self.device_type == "cpu"
                  else torch.device("cuda", torch.cuda.current_device()))
        mine = torch.tensor(list(values), dtype=torch.int64, device=device)
        if n == 1:
            return [mine.tolist()]
        out = torch.empty(n * mine.numel(), dtype=torch.int64,
                          device=mine.device)
        self._run("all_gather", out.numel() * 8,
                  lambda: dist.all_gather_into_tensor(out, mine,
                                                      group=group))
        return out.view(n, -1).tolist()
