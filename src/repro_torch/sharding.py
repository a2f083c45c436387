"""Logical-axis sharding rules for the port's (data × model) mesh of
ranks (port of :mod:`repro.sharding`).

Mesh axes: ``("data", "model")``; ``("pod", "data", "model")`` resolves
too (layouts only: the engine's meshes have two axes). PSL semantics
drive two rule sets, ``repro``'s:

  * SERVER rules — the server segment is fully sharded: FSDP over the
    data axes (``embed`` dim) + tensor/expert parallel over ``model``.
  * CLIENT rules — client-segment params are *replicated* across the data
    axes (every client's copy identical at all times), and only
    tensor-sharded over ``model``.

Every ``ParamSpec`` dimension carries a logical axis name; ``spec_for``
resolves it to mesh axes with a divisibility check — a dimension that
does not divide the assigned mesh axes shards over the longest prefix of
them that it divides, or is replicated, and the fallback is recorded in a
:class:`ShardingReport` in ``repro``'s words.

A resolved layout is a plain value: a tuple with, for each dim, the tuple
of mesh axes it is split over (``()`` = not split); a layout shorter than
the leaf's rank replicates the remaining dims, so ``()`` replicates a
whole leaf (``repro``'s ``PartitionSpec()``). Dim d of a leaf split over
axes (a1, ..., ak) is cut into prod(size(ai)) equal blocks, and the rank
at coordinates c holds the block whose index is the row-major index of
(c[a1], ..., c[ak]) — ``PartitionSpec``'s placement.

``repro``'s activation-sharding hints (``set_activation_sharding``,
``constrain_activation``, ``activation_sharding_for``) steer GSPMD; only
``repro``'s dryrun sets them, and they wait with its twin (ROADMAP A.4).
The port's tensor-parallel compute makes its collectives explicit
(:mod:`repro_torch.launch.tensor_parallel`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models.layers import tree_leaves, tree_unflatten

Rules = Dict[str, Tuple[str, ...]]
Layout = Tuple[Tuple[str, ...], ...]


def _data_axes(mesh) -> Tuple[str, ...]:
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def server_rules(mesh, profile: str = "tp") -> Rules:
    """Sharding profiles:

    * "tp"   — Megatron-style tensor parallel over `model` + FSDP over the
               data axes on the embed dim.
    * "fsdp" — no tensor parallelism: every weight fully sharded over ALL
               axes on its embed dim; batch over all axes (pure DP).
    * "ddp"  — batch over ALL axes, layer weights FSDP over the data axes
               only, vocab/embedding and experts over `model`.
    """
    fsdp = _data_axes(mesh)
    if profile == "fsdp":
        allax = fsdp + ("model",)
        return {"embed": allax, "vocab": (), "heads": (), "kv_heads": (),
                "kv_heads_cache": ("model",), "ff": (), "expert_ff": (),
                "experts": (), "inner": (), "layers": (), "batch": allax}
    if profile == "ddp":
        allax = fsdp + ("model",)
        return {"embed": fsdp, "vocab": ("model",), "heads": (),
                "kv_heads": (), "kv_heads_cache": ("model",),
                "cache_seq": ("model",), "ff": (), "expert_ff": (),
                "experts": ("model",), "inner": (), "layers": (),
                "batch": allax}
    return {
        "embed": fsdp,
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "kv_heads_cache": ("model",),
        "cache_seq": ("model",),
        "ff": ("model",),
        "expert_ff": (),
        "experts": ("model",),
        "inner": ("model",),
        "layers": (),
        "batch": fsdp if profile == "tp" else fsdp + ("model",),
    }


def client_rules(mesh, profile: str = "tp") -> Rules:
    r = dict(server_rules(mesh, profile))
    r["embed"] = ()          # replicated across data: identical client copies
    if profile == "fsdp":
        # client stays replicated on data axes but may use model axis
        r["embed"] = ("model",)
    return r


@dataclasses.dataclass
class ShardingReport:
    fallbacks: List[str] = dataclasses.field(default_factory=list)

    def note(self, msg: str):
        if msg not in self.fallbacks:
            self.fallbacks.append(msg)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: Rules, mesh,
             report: Optional[ShardingReport] = None) -> Layout:
    """The layout of one leaf: each dim's logical axis resolved through
    ``rules`` to the mesh axes not yet used by an earlier dim, cut back to
    the longest prefix the dim divides (noted), or to none (noted)."""
    sizes = mesh_sizes(mesh)
    entries: List[Tuple[str, ...]] = []
    used: set = set()
    for dim, name in zip(shape, axes):
        if name is None:
            entries.append(())
            continue
        mesh_axes = tuple(a for a in rules.get(name, ()) if a not in used)
        if not mesh_axes:
            entries.append(())
            continue
        total = math.prod(sizes[a] for a in mesh_axes)
        if dim % total:
            ok: Tuple[str, ...] = ()
            prod = 1
            for a in mesh_axes:
                if dim % (prod * sizes[a]) == 0:
                    prod *= sizes[a]
                    ok = ok + (a,)
                else:
                    break
            if not ok:
                if report:
                    report.note(f"axis {name!r} size {dim} !% {total} -> "
                                "replicated")
                entries.append(())
                continue
            if report:
                report.note(f"axis {name!r} size {dim}: partial shard {ok}")
            mesh_axes = ok
        used.update(mesh_axes)
        entries.append(mesh_axes)
    return tuple(entries)


def shardings_for_specs(spec_tree, mesh, rules: Rules,
                        report: Optional[ShardingReport] = None):
    """ParamSpec tree → layout tree, leaves resolved in flattened
    (sorted-key) order, so the report's notes come in ``repro``'s
    order."""
    return tree_unflatten(spec_tree, [
        spec_for(s.shape, s.axes, rules, mesh, report)
        for s in tree_leaves(spec_tree)])


def model_param_shardings(model, mesh,
                          report: Optional[ShardingReport] = None,
                          profile: str = "tp"):
    """Client subtree replicated over data, server subtree per profile."""
    specs = model.param_specs()
    out = {}
    for part, rules in (("client", client_rules(mesh, profile)),
                        ("server", server_rules(mesh, profile))):
        out[part] = shardings_for_specs(specs[part], mesh, rules, report)
    return out


def replicated(mesh=None) -> Layout:
    return ()


def opt_state_shardings(opt_state_abs, params_sh, mesh):
    """Optimizer-slot layouts: moment slots mirror the param layouts
    (they are param-shaped), scalar bookkeeping (count) is replicated."""
    return {k: (params_sh if k in ("mu", "m", "v") else replicated(mesh))
            for k in opt_state_abs}


def _abstract_params(model):
    """The model's parameter tree as meta tensors (shapes and dtypes, no
    storage)."""
    dtype = model.cfg.torch_dtype
    return tree_unflatten(model.param_specs(), [
        torch.empty(s.shape, dtype=s.dtype or dtype, device="meta")
        for s in tree_leaves(model.param_specs())])


def train_state_shardings(model, optimizer, mesh,
                          report: Optional[ShardingReport] = None,
                          profile: str = "tp"):
    """TrainState-shaped layout tree for the sharded PSL step: client
    subtree replicated over the data axes, server per profile, optimizer
    slots mirroring the params, step counter replicated."""
    from repro_torch.optim import TrainState
    params_sh = model_param_shardings(model, mesh, report, profile=profile)
    opt_abs = optimizer.init(_abstract_params(model))
    return TrainState(params=params_sh,
                      opt_state=opt_state_shardings(opt_abs, params_sh, mesh),
                      step=replicated(mesh))


def batch_axes(mesh, profile: str = "tp") -> Tuple[str, ...]:
    axes = _data_axes(mesh)
    if profile == "fsdp":
        axes = axes + ("model",)
    return axes


def batch_spec(mesh, profile: str = "tp") -> Layout:
    return (batch_axes(mesh, profile),)


def batch_shardings(batch_tree, mesh, global_batch: int,
                    report: Optional[ShardingReport] = None,
                    profile: str = "tp"):
    """Split dim 0 (batch) of every batch leaf over the batch axes,
    falling back to replication when the batch does not divide."""
    sizes = mesh_sizes(mesh)
    axes = batch_axes(mesh, profile)
    total = math.prod(sizes[a] for a in axes)

    def one(x):
        shape = tuple(int(s) for s in getattr(x, "shape", ()))
        if shape and shape[0] % total == 0 and total > 1:
            return batch_spec(mesh, profile)
        if report and total > 1:
            report.note(f"batch dim {shape} !% {total} -> replicated")
        return replicated(mesh)

    return tree_unflatten(batch_tree, [one(x)
                                       for x in tree_leaves(batch_tree)])


def cache_shardings(model, mesh, batch: int, cache_len: int,
                    window=None,
                    report: Optional[ShardingReport] = None,
                    profile: str = "tp"):
    """KV/SSM decode-cache layouts from the cache ParamSpec tree: batch
    dim over the data axes, cache head / inner dims over `model`."""
    specs = model.cache_specs(batch, cache_len, window)
    return shardings_for_specs(specs, mesh, server_rules(mesh, profile),
                               report)


# ---------------------------------------------------------------------------
# A layout on a rank: which block of each dim the rank holds
# ---------------------------------------------------------------------------

def layout_axes(layout: Layout) -> Tuple[str, ...]:
    """The mesh axes a layout splits over, in the order they appear."""
    return tuple(a for entry in layout for a in entry)


def shard_count(layout: Layout, sizes: Dict[str, int]) -> int:
    """Into how many distinct blocks the layout cuts the leaf."""
    return math.prod(sizes[a] for a in layout_axes(layout))


def whole_shape(block_shape, layout: Layout,
                sizes: Dict[str, int]) -> Tuple[int, ...]:
    """A leaf's shape from the shape of one of its blocks."""
    return tuple(n * shard_count(layout[d:d + 1], sizes)
                 for d, n in enumerate(block_shape))


def block_slices(shape, layout: Layout, sizes: Dict[str, int],
                 coord: Dict[str, int]) -> Tuple[slice, ...]:
    """Index of the block that the rank at ``coord`` holds."""
    out = []
    for d, n in enumerate(shape):
        entry = layout[d] if d < len(layout) else ()
        count, index = 1, 0
        for a in entry:
            count *= sizes[a]
            index = index * sizes[a] + coord[a]
        if n % count:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"into {count} blocks ({entry})")
        step = n // count
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def local_slice(full, layout: Layout, sizes: Dict[str, int],
                coord: Dict[str, int]):
    """The rank's block of a whole leaf (a view)."""
    return full[block_slices(full.shape, layout, sizes, coord)]


def is_owner(layout: Layout, coord: Dict[str, int]) -> bool:
    """Whether the rank holds the first copy of its block: its coordinate
    is 0 on every axis the layout does not split over. Counting only
    owners counts a replicated element once."""
    split = set(layout_axes(layout))
    return all(c == 0 for a, c in coord.items() if a not in split)


def stored_elements(shape, layout: Layout, sizes: Dict[str, int]) -> int:
    """Elements of the leaf stored over all ranks of the mesh: each block
    once for every rank that holds it."""
    return math.prod(shape) * math.prod(sizes.values()) \
        // shard_count(layout, sizes)


__all__ = ["Layout", "Rules", "ShardingReport",
           "batch_axes", "batch_shardings", "batch_spec", "block_slices",
           "cache_shardings", "client_rules", "is_owner", "layout_axes",
           "local_slice", "model_param_shardings", "opt_state_shardings",
           "replicated", "server_rules", "shard_count",
           "shardings_for_specs", "spec_for", "stored_elements",
           "train_state_shardings", "whole_shape"]
