"""Paged KV cache: fixed-size pages, free-list pool, per-request tables
(port of :mod:`repro.runtime.paging`, with its speculative-window fork
API).

KV storage is one physical buffer of ``num_pages`` fixed-size pages
(``page_size`` tokens each, every layer's K and V for those positions); a
request holds a **page table** (ordered list of physical page ids), and
pages are allocated one at a time exactly when decode advances into them.
Peak memory then tracks the sum of live context lengths, rounded up to a
page.

Admission keeps the GPSL fixed-work invariant restated in pages: admit
while the free list covers the candidate's prompt plus one growth page per
request that will be active (:class:`_PageBudgeter`). When a decode step
still lands on an empty free list, the engine preempts the cheapest active
request and hands it back to the scheduler as a resume request
(``drain_evicted``), token-identically.

Attention over the scattered pages runs in the paged-attention CUDA
kernel on the card (``repro_torch/csrc/paged_attention.cu``) and in its
plain PyTorch version on the CPU. The page tables live host-side
(``tables_np``) and are uploaded each step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.registry import register_engine
from repro_torch.models.layers import tree_leaves
from repro_torch.runtime.engine import ContinuousEngine, _resolve_now
from repro_torch.runtime.kvcache import tree_nbytes
from repro_torch.runtime.queue import ServeRequest


class PagePool:
    """Free-list page allocator exposing the KVCachePool surface.

    ``buffers`` is the model cache tree built with the *page* axis in the
    batch position: each leaf is ``(layers, num_pages + 1, page_size,
    heads, head_dim)`` on ``device``. One extra physical page — index
    ``num_pages``, the **scratch page** — is never allocated: inactive
    rows' page tables point at it, so the decode step's masked lanes write
    their garbage KV there, and padded table entries gather from it into
    positions the attention mask already excludes.

    Rows (``num_slots`` of them, ``slot_len`` logical capacity) keep the
    slot pool's alloc/release/pos surface, so the engine, the scheduler
    and ``verify_report`` drive both pools through one interface.
    """

    def __init__(self, model, num_slots: int, slot_len: int,
                 page_size: int = 16, num_pages: Optional[int] = None, *,
                 device):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_slots = int(num_slots)
        self.slot_len = int(slot_len)
        self.page_size = int(page_size)
        self.max_pages_per_slot = -(-self.slot_len // self.page_size)
        if num_pages is None:
            num_pages = self.num_slots * self.max_pages_per_slot
        if num_pages < 1:
            raise ValueError("num_pages must be >= 1")
        self.num_pages = int(num_pages)
        self.scratch_page = self.num_pages          # last physical page
        self.device = device
        specs = model.cache_specs(self.num_pages + 1, self.page_size, None)
        for spec in tree_leaves(specs):
            if len(spec.shape) != 5 or "batch" not in spec.axes \
                    or spec.axes.index("batch") != 1:
                raise NotImplementedError(
                    "the paged pool needs layer-stacked attention caches "
                    "(layers, batch, length, heads, head_dim)")
        self.buffers = model.init_cache(self.num_pages + 1, self.page_size,
                                        None, device=device)
        self.bytes_per_token = tree_nbytes(self.buffers) / (
            (self.num_pages + 1) * self.page_size)
        self.pos = np.zeros(self.num_slots, np.int32)
        # Row free list (LIFO, like the slot pool).
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._live: set = set()
        self.alloc_count = 0
        self.release_count = 0
        self.peak_live = 0
        # Page free list + per-row tables. tables_np mirrors the tables
        # into the fixed-width array the decode step uploads; unassigned
        # entries hold the scratch page id.
        self._free_pages = list(range(self.num_pages - 1, -1, -1))
        self._tables: List[List[int]] = [[] for _ in range(self.num_slots)]
        self.tables_np = np.full(
            (self.num_slots, self.max_pages_per_slot),
            self.scratch_page, np.int32)
        self.page_alloc_count = 0
        self.page_release_count = 0
        self.peak_pages = 0
        # Speculative-window forks: slot -> {"pages": [...], "shared": n}.
        # A fork copies the row's table (the first ``shared`` entries are
        # the refcounted pages the main table also holds) and grows with
        # fork-private pages the draft window writes into; commit moves
        # the accepted prefix into the main table, rollback frees only
        # the private tail. At most one fork per row.
        self._forks: Dict[int, Dict[str, Any]] = {}

    # ----- row lifecycle (KVCachePool surface) -----
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._live)

    @property
    def num_free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free_pages)

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
            raise ValueError(f"releasing row {slot} that is not live")
        if slot in self._forks:
            # mid-window preemption/eviction: roll the draft fork back
            # first so only the row's committed pages are returned below
            self.release_fork(slot)
        self._live.remove(slot)
        self._free.append(slot)
        self.release_count += 1
        pages = self._tables[slot]
        self._free_pages.extend(reversed(pages))   # hottest pages last out
        self.page_release_count += len(pages)
        self._tables[slot] = []
        self.tables_np[slot, :] = self.scratch_page
        self.pos[slot] = 0

    def check_no_leaks(self) -> None:
        """Rows and physical pages each partition exactly into free + held.

        A page may appear in two tables only under the refcounting the
        speculative fork introduces: a live fork's shared prefix aliases
        its own row's main table (and nothing else). Everything past a
        fork's shared prefix is fork-private and must not appear in any
        main table; alloc/release counters balance against *physical*
        pages (forking a page is not an allocation)."""
        if self.num_free + self.num_live != self.num_slots:
            raise RuntimeError(
                f"row leak: {self.num_free} free + {self.num_live} live "
                f"!= {self.num_slots} rows")
        if set(self._free) & self._live:
            raise RuntimeError("row both free and live")
        held = [p for t in self._tables for p in t]
        if len(set(held)) != len(held):
            raise RuntimeError("page held by two rows")
        main_set = set(held)
        private: List[int] = []
        for slot, f in self._forks.items():
            if slot not in self._live:
                raise RuntimeError(f"fork on non-live row {slot}")
            pages, shared = f["pages"], f["shared"]
            if pages[:shared] != self._tables[slot][:shared]:
                raise RuntimeError(
                    f"fork of row {slot} shares pages its main table "
                    f"does not hold (refcount mismatch)")
            # while a fork is live its private tail must stay out of
            # every main table (commit_fork transfers ownership and
            # drops the fork in the same move)
            if set(pages[shared:]) & main_set:
                raise RuntimeError(
                    f"fork-private page of row {slot} also held by a "
                    f"main table (missing refcount)")
            private.extend(pages[shared:])
        held_all = held + private
        if len(self._free_pages) + len(held_all) != self.num_pages:
            raise RuntimeError(
                f"page leak: {len(self._free_pages)} free + "
                f"{len(held_all)} held != {self.num_pages} pages")
        if set(self._free_pages) & set(held_all):
            raise RuntimeError("page both free and held")
        if len(set(private)) != len(private):
            raise RuntimeError("page private to two forks")
        if self.scratch_page in set(self._free_pages) | set(held_all):
            raise RuntimeError("scratch page entered circulation")
        if self.page_alloc_count - self.page_release_count != len(held_all):
            raise RuntimeError("page alloc/release counters out of balance")

    # ----- page growth -----
    def ensure_capacity(self, slot: int) -> bool:
        """Grow ``slot``'s table until it covers ``pos[slot]`` (the page
        the next decode step writes). Returns False when the free list
        runs dry; the engine must then evict someone and retry."""
        need = int(self.pos[slot]) // self.page_size
        if need >= self.max_pages_per_slot:
            raise RuntimeError(
                f"row {slot} position {int(self.pos[slot])} exceeds "
                f"logical capacity {self.slot_len}")
        table = self._tables[slot]
        while len(table) <= need:
            if not self._free_pages:
                return False
            pid = self._free_pages.pop()
            self.tables_np[slot, len(table)] = pid
            table.append(pid)
            self.page_alloc_count += 1
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return True

    # ----- speculative-window table forks -----
    def fork_table(self, slot: int) -> None:
        """Fork ``slot``'s page table for a draft window.

        The fork is a copy of the table, not of any KV: its leading
        entries alias (refcount) the pages the main table holds, and
        :meth:`fork_extend` grows it with fork-private pages for the
        window's speculative positions. Exactly one fork per row; it ends
        in :meth:`commit_fork` (accept a prefix) or :meth:`release_fork`
        (full rollback — also taken when a forked row is released)."""
        if slot not in self._live:
            raise ValueError(f"forking row {slot} that is not live")
        if slot in self._forks:
            raise RuntimeError(f"row {slot} already has a live fork")
        table = self._tables[slot]
        self._forks[slot] = {"pages": list(table), "shared": len(table)}

    def fork_extend(self, slot: int, last_pos: int) -> int:
        """Grow ``slot``'s fork to cover writes up to ``last_pos``.

        Allocates fork-private pages until logical page ``last_pos //
        page_size`` is covered, stopping early (no eviction from here —
        the engine shrinks the draft window instead) when the free list
        runs dry or the row's logical capacity is reached. Returns the
        highest position the fork can hold, which may be below
        ``last_pos``."""
        f = self._forks[slot]
        pages = f["pages"]
        need = min(int(last_pos) // self.page_size,
                   self.max_pages_per_slot - 1)
        while len(pages) <= need and self._free_pages:
            pages.append(self._free_pages.pop())
            self.page_alloc_count += 1
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return len(pages) * self.page_size - 1

    def fork_row(self, slot: int) -> np.ndarray:
        """The fork's fixed-width table row for the verify step's upload:
        ``max_pages_per_slot + 1`` entries, scratch-padded, with the last
        column always scratch so out-of-window lanes (q_pos ==
        max_pages_per_slot * page_size) write and read there."""
        row = np.full(self.max_pages_per_slot + 1, self.scratch_page,
                      np.int32)
        pages = self._forks[slot]["pages"]
        row[:len(pages)] = pages
        return row

    def commit_fork(self, slot: int, new_pos: int) -> None:
        """Accept a verified prefix: the fork's pages covering positions
        ``< new_pos`` transfer into the main table (ownership moves — no
        allocation, no copy), the rejected tail's fork-private pages go
        back to the free list, and the shared prefix drops its extra
        reference. Advances ``pos[slot]``."""
        f = self._forks.pop(slot)
        pages = f["pages"]
        table = self._tables[slot]
        need = (-(-int(new_pos) // self.page_size)
                if new_pos > 0 else 0)
        need = max(min(need, len(pages)), len(table))
        for i in range(len(table), need):
            self.tables_np[slot, i] = pages[i]
            table.append(pages[i])
        for pid in pages[need:]:
            self._free_pages.append(pid)
            self.page_release_count += 1
        self.pos[slot] = int(new_pos)

    def release_fork(self, slot: int) -> None:
        """Roll a draft window back entirely: free only the fork-private
        pages; the shared prefix stays with the main table untouched."""
        f = self._forks.pop(slot)
        for pid in f["pages"][f["shared"]:]:
            self._free_pages.append(pid)
            self.page_release_count += 1

    @property
    def forked_rows(self) -> int:
        return len(self._forks)

    @property
    def shared_pages(self) -> int:
        """Pages currently referenced by both a main table and a fork."""
        return sum(f["shared"] for f in self._forks.values())

    # ----- device-side placement -----
    def insert(self, src_cache, slot: int, length: int,
               row: int = 0) -> None:
        """Copy a prefilled row into freshly allocated pages, in place.

        The admission budgeter reserves these pages before the prefill
        runs, so an empty free list here is a scheduler bug."""
        if slot not in self._live:
            raise ValueError(f"insert into row {slot} that is not live")
        if length > self.slot_len:
            raise ValueError(f"prefill length {length} exceeds logical "
                             f"capacity {self.slot_len}")
        n_pages = -(-length // self.page_size)
        if len(self._free_pages) < n_pages:
            raise RuntimeError(
                f"insert needs {n_pages} pages but only "
                f"{len(self._free_pages)} are free — admission must "
                f"reserve prompt pages before prefill")
        table = self._tables[slot]
        if table:
            raise RuntimeError(f"insert into row {slot} with a non-empty "
                               f"page table")
        ids = [self._free_pages.pop() for _ in range(n_pages)]
        self.page_alloc_count += n_pages
        table.extend(ids)
        self.tables_np[slot, :n_pages] = ids
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        self._scatter(self.buffers, src_cache, ids, row)
        self.pos[slot] = length

    def _scatter(self, buffers, src_cache, ids: List[int], row: int) -> None:
        """Copy row ``row`` of a prefilled cache into pages ``ids`` of
        ``buffers`` (this pool's, or a separate-arch draft's over the same
        page-id space), in place."""
        page_ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        n_pages, p = len(ids), self.page_size
        for leaf, src in zip(tree_leaves(buffers), tree_leaves(src_cache)):
            # src: (layers, batch, cache_len, heads, head_dim) with
            # cache_len == n_pages * page_size (prefill rounds up).
            chunk = src[:, row, :n_pages * p]
            layers, _, heads, hd = chunk.shape
            leaf[:, page_ids] = chunk.reshape(layers, n_pages, p, heads, hd)

    # ----- memory accounting -----
    def cache_stats(self) -> dict:
        """Same schema as ``repro``'s ``PagePool.cache_stats``, ``kind ==
        "page"``; ``capacity_bytes`` excludes the scratch page.
        ``pages_in_use`` counts physical pages, so a page shared between a
        main table and a live speculative fork is charged once; the
        sharing itself is reported as ``shared_pages``/``forked_rows``."""
        used = int(sum(int(self.pos[s]) for s in self._live))
        allocated = self.pages_in_use * self.page_size
        peak_alloc = self.peak_pages * self.page_size
        return {
            "kind": "page",
            "capacity_bytes": int(self.bytes_per_token * self.num_pages
                                  * self.page_size),
            "in_use_bytes": int(self.bytes_per_token * allocated),
            "peak_in_use_bytes": int(self.bytes_per_token * peak_alloc),
            "used_tokens": used,
            "allocated_tokens": allocated,
            "fragmentation": (1.0 - used / allocated) if allocated else 0.0,
            "pages_in_use": self.pages_in_use,
            "peak_pages_in_use": self.peak_pages,
            "forked_rows": self.forked_rows,
            "shared_pages": self.shared_pages,
        }

    def reset(self) -> None:
        """Zero the bookkeeping (buffers are overwritten on insert)."""
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._live = set()
        self.pos[:] = 0
        self.peak_live = 0
        self._free_pages = list(range(self.num_pages - 1, -1, -1))
        self._tables = [[] for _ in range(self.num_slots)]
        self.tables_np[:, :] = self.scratch_page
        self.peak_pages = 0
        self._forks = {}


class _PageBudgeter:
    """Admission budget in pages (the GPSL invariant, page-denominated).

    A candidate is admissible while a row is free AND, after charging its
    prompt pages, the free list still holds ``growth_per_active`` pages
    for every request that will be active — the worst case of the next
    decode step (each active row crossing a page boundary at once; the
    speculative engine passes the window's worst case instead, since one
    of its steps writes gamma+1 positions per row). The budgeter tracks its
    own reservations so several admissions in one scheduler iteration
    stay jointly covered.
    """

    def __init__(self, pool: PagePool, active_now: int,
                 growth_per_active: int = 1):
        self._rows = pool.num_free
        self._pages = pool.num_free_pages
        self._active = active_now
        self._page_size = pool.page_size
        self._growth = int(growth_per_active)

    def can_take(self, req: ServeRequest) -> bool:
        need = -(-int(req.prompt.shape[0]) // self._page_size)
        if self._rows <= 0 or self._pages < need:
            return False
        if self._active == 0:
            # progress guarantee: an idle engine admits any fitting
            # prompt even when the growth reserve cannot be met (tiny
            # pools otherwise livelock — nobody active, nobody ever
            # admissible); the eviction valve and the speculative
            # window shrink cover later pressure
            return True
        return self._pages - need >= (self._active + 1) * self._growth

    def take(self, req: ServeRequest) -> None:
        self._rows -= 1
        self._pages -= -(-int(req.prompt.shape[0]) // self._page_size)
        self._active += 1


@register_engine("paged")
class PagedEngine(ContinuousEngine):
    """Continuous-batching engine over a :class:`PagePool`.

    Inherits the admit/step/preempt lifecycle from
    :class:`ContinuousEngine`; the overrides swap contiguous slots for
    page tables — prefill at the page-rounded length, decode through
    ``decode_step_paged`` (the paged-attention kernel on the card), page
    growth before each step, and eviction when growth outruns the pool.
    """

    def __init__(self, cfg, params=None, *, num_slots: int, slot_len: int,
                 seed: int = 0, model=None, sampling=None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 device="cuda"):
        self.page_size = int(page_size)
        self.num_pages = num_pages
        self._evicted: List[ServeRequest] = []
        super().__init__(cfg, params=params, num_slots=num_slots,
                         slot_len=slot_len, seed=seed, model=model,
                         sampling=sampling, device=device)

    @staticmethod
    def _check_family(cfg) -> None:
        ContinuousEngine._check_family(cfg)
        if cfg.family in ("ssm", "hybrid"):
            raise NotImplementedError(
                "ssm/hybrid families carry recurrent state, not a KV "
                "ring — there is nothing to page; serve them with the "
                "continuous engine")
        if cfg.sliding_window:
            raise NotImplementedError(
                "sliding-window caches are fixed-size rings; the paged "
                "pool only pays off for caches that grow with context")

    def _make_pool(self, num_slots: int, slot_len: int) -> PagePool:
        return PagePool(self.model, num_slots, slot_len,
                        page_size=self.page_size, num_pages=self.num_pages,
                        device=self.device)

    def _page_rounded(self, plen: int) -> int:
        return -(-plen // self.pool.page_size) * self.pool.page_size

    def _run_prefill(self, tokens, plen: int):
        # Prefill at the page-rounded length: the resulting cache rows
        # slice exactly into ceil(plen / page_size) pages.
        return self.model.prefill(self.params, {"tokens": tokens},
                                  cache_len=self._page_rounded(plen))

    def _device_step(self, tokens, pos, rids, idxs):
        tables = torch.from_numpy(self.pool.tables_np).to(self.device)
        logits, _ = self.model.decode_step_paged(
            self.params, self.pool.buffers, tokens, pos, tables)
        return self.sampler.sample(logits[:, -1], rids, idxs)

    def admission_budgeter(self) -> _PageBudgeter:
        return _PageBudgeter(self.pool, self.num_active())

    # ----- page growth + the eviction valve -----
    def step(self, now) -> List[int]:
        self._ensure_pages(now)
        return super().step(now)

    def _ensure_pages(self, now) -> None:
        """Every active row gets the page its next token writes into.

        When the free list cannot cover a row, evict the cheapest *other*
        active request until it can — the admission budgeter makes this
        rare, completion-timing skew makes it possible."""
        for slot in np.flatnonzero(self._rid >= 0):
            slot = int(slot)
            while self._rid[slot] >= 0 \
                    and not self.pool.ensure_capacity(slot):
                self._evict_one(slot, now)

    def _evict_one(self, protected_slot: int, now) -> None:
        protected = int(self._rid[protected_slot])
        victims = [a for a in self.active_requests()
                   if a["rid"] != protected]
        if not victims:
            raise RuntimeError(
                "page pool exhausted by a single request — "
                "ServeSpec.validate guarantees capacity for the largest "
                "request, so this engine was built without a spec check")
        victim = min(victims, key=lambda a: (a["emitted"], -a["rid"]))
        rec = self.preempt(victim["rid"])
        emitted = rec["tokens"]
        # Same resume construction as the scheduler's tenant preemption:
        # prompt + emitted prefix re-prefills to the next uninterrupted
        # token, remaining allowance shrinks by what was emitted.
        self._evicted.append(ServeRequest(
            rid=victim["rid"],
            prompt=np.concatenate([np.asarray(rec["prompt"], np.int32),
                                   np.asarray(emitted, np.int32)]),
            max_new_tokens=rec["max_new_tokens"] - len(emitted),
            arrival_s=_resolve_now(now),
            tenant=rec.get("tenant", "default")))

    def drain_evicted(self) -> List[ServeRequest]:
        out, self._evicted = self._evicted, []
        return out

    def reset(self) -> None:
        super().reset()
        self._evicted = []

    @classmethod
    def from_spec(cls, cfg, spec, params=None, model=None,
                  device="cuda") -> "PagedEngine":
        return cls(cfg, params=params,
                   num_slots=spec.resolved_num_slots(),
                   slot_len=spec.resolved_slot_len(),
                   seed=spec.engine.seed, model=model,
                   sampling=getattr(spec, "sampling", None),
                   page_size=spec.cache.page_size,
                   num_pages=spec.resolved_num_pages(), device=device)
