"""Pooled, slot-allocated KV cache for continuous batching (port of
:mod:`repro.runtime.kvcache`).

``num_slots`` fixed-capacity slots: a request is prefilled at its exact
prompt length, its cache rows are copied into a free slot, and the slot
returns to the free list the moment the request completes. Per-slot
positions live host-side; the engine feeds them to decode as a (B,)
vector. Slot placement uses the logical ``"batch"`` axis recorded in the
model's cache ParamSpec tree. ``repro`` scatters with a donated jitted
update; the port copies into the pool's tensors in place.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from repro_torch.models.layers import tree_leaves


def _batch_axes(spec_tree) -> List[int]:
    """Per-leaf index of the logical slot ("batch") axis."""
    axes = []
    for spec in tree_leaves(spec_tree):
        if "batch" not in spec.axes:
            raise ValueError(f"cache spec without a batch axis: {spec}")
        axes.append(spec.axes.index("batch"))
    return axes


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


class KVCachePool:
    """Fixed pool of decode-cache slots with free-list reuse.

    ``buffers`` is the model's cache tree with the batch dimension equal
    to ``num_slots``, on ``device``. ``insert`` copies one row of a
    prefilled cache into a slot in place; ``alloc``/``release`` manage the
    free list. ``pos[slot]`` is the next absolute decode position of the
    slot's request (prompt length right after insert).
    """

    def __init__(self, model, num_slots: int, slot_len: int,
                 window: Optional[int] = None, *, device):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = int(num_slots)
        self.slot_len = int(slot_len)
        specs = model.cache_specs(self.num_slots, self.slot_len, window)
        self._axes = _batch_axes(specs)
        self.buffers = model.init_cache(self.num_slots, self.slot_len,
                                        window, device=device)
        self.pos = np.zeros(self.num_slots, np.int32)
        # LIFO free list: reuse the hottest slot first.
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._live: set = set()
        self.alloc_count = 0
        self.release_count = 0
        self.peak_live = 0
        self.bytes_per_token = tree_nbytes(self.buffers) / (
            self.num_slots * self.slot_len)

    # ----- slot lifecycle -----
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._live)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._live.add(slot)
        self.alloc_count += 1
        self.peak_live = max(self.peak_live, self.num_live)
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._live:
            raise ValueError(f"releasing slot {slot} that is not live")
        self._live.remove(slot)
        self._free.append(slot)
        self.release_count += 1
        self.pos[slot] = 0

    def check_no_leaks(self) -> None:
        """Every slot is exactly one of free/live, and counts balance."""
        if self.num_free + self.num_live != self.num_slots:
            raise RuntimeError(
                f"slot leak: {self.num_free} free + {self.num_live} live "
                f"!= {self.num_slots} slots")
        if set(self._free) & self._live:
            raise RuntimeError("slot both free and live")
        if self.alloc_count - self.release_count != self.num_live:
            raise RuntimeError("alloc/release counters out of balance")

    # ----- device-side placement -----
    def insert(self, src_cache: Any, slot: int, length: int,
               row: int = 0) -> None:
        """Copy row ``row`` of a prefilled cache into ``slot`` in place."""
        if slot not in self._live:
            raise ValueError(f"insert into slot {slot} that is not live")
        if length > self.slot_len:
            raise ValueError(f"prefill length {length} exceeds slot "
                             f"capacity {self.slot_len}")
        for leaf, src, axis in zip(tree_leaves(self.buffers),
                                   tree_leaves(src_cache), self._axes):
            leaf.narrow(axis, slot, 1).copy_(src.narrow(axis, row, 1))
        self.pos[slot] = length

    # ----- memory accounting -----
    def cache_stats(self) -> dict:
        """KV-memory accounting in a pool-kind-neutral schema (same as
        ``repro``'s): a live slot reserves ``slot_len`` tokens but uses
        ``pos[slot]`` of them; ``fragmentation`` is the idle fraction."""
        used = int(sum(int(self.pos[s]) for s in self._live))
        allocated = self.num_live * self.slot_len
        peak_alloc = self.peak_live * self.slot_len
        return {
            "kind": "slot",
            "capacity_bytes": int(self.bytes_per_token * self.num_slots
                                  * self.slot_len),
            "in_use_bytes": int(self.bytes_per_token * allocated),
            "peak_in_use_bytes": int(self.bytes_per_token * peak_alloc),
            "used_tokens": used,
            "allocated_tokens": allocated,
            "fragmentation": (1.0 - used / allocated) if allocated else 0.0,
            "slots_in_use": self.num_live,
            "peak_slots_in_use": self.peak_live,
        }

    def reset(self) -> None:
        """Zero the bookkeeping (buffers are overwritten on insert)."""
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._live = set()
        self.pos[:] = 0
        self.peak_live = 0
