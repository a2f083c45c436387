"""Draft-model speculative decoding on the paged engine (port of
:mod:`repro.runtime.spec_decode`).

One speculative *window* replaces gamma+1 single-token decode steps: a
small draft model proposes ``gamma`` lookahead tokens per active request,
then one batched target step (``LanguageModel.decode_window_paged``, whose
attention is the spec-verify kernel on the card) scores all gamma+1
positions against the paged KV at once, and the longest draft prefix that
matches the target's own selections is accepted.

**Acceptance is keyed coupling, not classic rejection sampling.** The
serving sampler (:mod:`repro_torch.runtime.sampling`) derives every draw
from ``(seed, rid, token_index)``. The draft proposes with the keys the
target would use, the verify step computes the target's keyed selection
at every window position, and a draft token is accepted iff it equals
that selection. Emitted tokens are always the target's selections, so
the output equals non-speculative decoding by construction, greedy and
sampled alike; the draft only decides how many tokens a window yields.

**Draft KV lives in forked page tables** over the shared
:class:`~repro_torch.runtime.paging.PagePool`: a fork copies the row's
table (refcounting the shared prefix) and grows with fork-private pages
for the window's speculative positions. ``commit_fork`` transfers the
pages covering the accepted prefix into the main table; rollback
(including a mid-window preemption or eviction of the row) frees only the
fork-private tail. ``PagePool.check_no_leaks`` audits the refcounts.

Two draft sources (``DraftSpec``): ``num_layers`` truncates the target —
the draft is the target's first N layers plus its embeddings, norm and
head, its cache a layer-slice view of the target's pages, so it needs no
prefill and its decode steps (the paged-attention kernel on the card)
write straight into the shared pages; ``arch`` serves an independent
configs model with its own page buffers addressed by the same page ids
(prefilled at admission).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.api.registry import register_engine
from repro_torch.models.layers import tree_map
from repro_torch.runtime.engine import ServeReport, _resolve_now
from repro_torch.runtime.paging import PagedEngine, _PageBudgeter
from repro_torch.runtime.queue import ServeRequest


@register_engine("speculative")
class SpeculativeEngine(PagedEngine):
    """Paged engine whose decode step verifies a whole draft window.

    Inherits admission (page-rounded prefill into fresh pages), the
    page-growth eviction valve and preempt/resume from
    :class:`PagedEngine`; only ``step`` changes shape: gamma masked draft
    steps, one (gamma+1)-wide verify, host-side prefix acceptance, then a
    fork commit per row. Per-step page demand grows from 1 to the window's
    worst case, so the admission budgeter reserves ``gamma // page_size +
    2`` growth pages per active request.
    """

    def __init__(self, cfg, params=None, *, num_slots: int, slot_len: int,
                 seed: int = 0, model=None, sampling=None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 draft=None, device="cuda"):
        if draft is None or not getattr(draft, "configured", False):
            raise ValueError(
                "the speculative engine needs a configured DraftSpec "
                "(draft.num_layers or draft.arch)")
        self.draft_spec = draft
        self.gamma = int(draft.gamma)
        super().__init__(cfg, params=params, num_slots=num_slots,
                         slot_len=slot_len, seed=seed, model=model,
                         sampling=sampling, page_size=page_size,
                         num_pages=num_pages, device=device)
        self.spec_windows = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.draft_steps = 0           # draft decode calls (batched)
        self._build_draft(draft)

    # ----- draft construction ---------------------------------------
    def _build_draft(self, draft) -> None:
        from repro_torch.models import build_model as build_lm
        cfg = self.cfg
        if draft.num_layers is not None:
            d = int(draft.num_layers)
            if d > cfg.num_layers:
                raise ValueError(
                    f"draft.num_layers {d} exceeds the target's "
                    f"{cfg.num_layers} layers")
            dc = min(cfg.cut_layer, d)
            self._draft_shared = True
            self._draft_client_layers = dc
            self._draft_server_layers = d - dc
            dcfg = dataclasses.replace(cfg, num_layers=d, cut_layer=dc)
            self._draft_model = build_lm(dcfg)
            tgt = self.params
            # views of the target's stacked leaves: no copy
            dparams = {
                "client": {
                    "embed": tgt["client"]["embed"],
                    "blocks": tree_map(lambda x: x[:dc],
                                       tgt["client"]["blocks"])},
                "server": {
                    "final_norm": tgt["server"]["final_norm"],
                    "blocks": tree_map(lambda x: x[:d - dc],
                                       tgt["server"]["blocks"])}}
            if not cfg.tie_embeddings:
                dparams["server"]["lm_head"] = tgt["server"]["lm_head"]
            self._draft_params = dparams
            self._draft_buffers = None     # shared: slices of pool.buffers
        else:
            from repro_torch.configs import get_config
            dcfg = get_config(draft.arch, reduced=draft.reduced)
            dcfg = dataclasses.replace(dcfg, max_seq_len=cfg.max_seq_len)
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft arch {draft.arch!r} vocab "
                    f"{dcfg.vocab_size} != target vocab {cfg.vocab_size}")
            if dcfg.family in ("ssm", "hybrid", "audio") \
                    or dcfg.sliding_window:
                raise NotImplementedError(
                    "draft archs must be attention-cache models without "
                    "sliding windows (same constraint as the paged "
                    "engine)")
            self._draft_shared = False
            self._draft_model = build_lm(dcfg)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(draft.seed))
            self._draft_params = self._draft_model.init(gen)
            # Own page buffers over the *same page-id space*: a physical
            # page id addresses the target's KV in pool.buffers and the
            # draft's KV here, so forked tables serve both models.
            self._draft_buffers = self._draft_model.init_cache(
                self.pool.num_pages + 1, self.pool.page_size, None,
                device=self.device)

    # ----- device steps ---------------------------------------------
    def _verify(self, tokens, q_pos, tables, rids, idxs) -> torch.Tensor:
        """One batched target step over the whole window: logits[:, i]
        conditions on tokens[:, :i+1]; every position's K/V lands where a
        chain of single-token steps would have put it."""
        logits, _ = self.model.decode_window_paged(
            self.params, self.pool.buffers, tokens, q_pos, tables)
        b, w, v = logits.shape
        sel = self.sampler.sample(logits.reshape(b * w, v),
                                  rids.reshape(-1), idxs.reshape(-1))
        return sel.reshape(b, w)

    def _draft(self, tokens, pos, tables, rids, idxs) -> torch.Tensor:
        if self._draft_shared:
            # The draft cache is a layer-slice view of the target pool:
            # shared layers produce identical KV for identical context,
            # so the target's prefill pages double as the draft's, and the
            # draft's writes land in the pool in place.
            dc, ds = self._draft_client_layers, self._draft_server_layers
            bufs = self.pool.buffers
            cache = {"client": tree_map(lambda x: x[:dc], bufs["client"]),
                     "server": tree_map(lambda x: x[:ds], bufs["server"])}
        else:
            cache = self._draft_buffers
        logits, _ = self._draft_model.decode_step_paged(
            self._draft_params, cache, tokens, pos, tables)
        self.draft_steps += 1
        return self.sampler.sample(logits[:, -1], rids, idxs)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ----- admission ------------------------------------------------
    def _admit_chunk(self, chunk: List[ServeRequest], plen: int,
                     now) -> None:
        super()._admit_chunk(chunk, plen, now)
        if self._draft_shared:
            return     # shared layers: the target's prefill KV is valid
        # Separate-arch draft: prefill the same prompts through the draft
        # and copy its KV into the draft buffers at the page ids the rows
        # just received — resumes included (their prompt is prompt +
        # emitted prefix, so the draft context matches).
        tokens = self._put(np.stack([r.prompt for r in chunk]))
        _, dcache, _ = self._draft_model.prefill(
            self._draft_params, {"tokens": tokens},
            cache_len=self._page_rounded(plen))
        for row, req in enumerate(chunk):
            slots = np.flatnonzero(self._rid == req.rid)
            if slots.size == 0:
                continue               # completed at admission: no decode
            ids = self.pool._tables[int(slots[0])]
            self.pool._scatter(self._draft_buffers, dcache, ids, row)

    def admission_budgeter(self) -> _PageBudgeter:
        # Worst case per window per row: the gamma+1 verify positions
        # cross into up to gamma // page_size + 2 fresh pages.
        growth = self.gamma // self.pool.page_size + 2
        return _PageBudgeter(self.pool, self.num_active(),
                             growth_per_active=growth)

    # ----- the speculative decode step ------------------------------
    def step(self, now) -> List[int]:
        if not np.any(self._rid >= 0):
            return []
        self._ensure_pages(now)        # may evict; forks start after
        active = self._rid >= 0
        slots = np.flatnonzero(active)
        pool = self.pool
        n = pool.num_slots
        g = self.gamma
        w = g + 1
        scratch_pos = pool.max_pages_per_slot * pool.page_size

        # Fork every active row and size its window: wlen <= gamma, <=
        # remaining-1 (the window emits wlen+1 tokens), <= what the slot
        # and the free list can cover (fork_extend shrinks instead of
        # evicting — page pressure costs lookahead, never correctness).
        wlens = np.zeros(n, np.int64)
        pos0 = np.zeros(n, np.int64)
        tables = np.full((n, pool.max_pages_per_slot + 1),
                         pool.scratch_page, np.int32)
        for slot in slots:
            slot = int(slot)
            p0 = int(pool.pos[slot])
            pos0[slot] = p0
            want = min(g, int(self._remaining[slot]) - 1,
                       pool.slot_len - 1 - p0)
            want = max(want, 0)
            pool.fork_table(slot)
            covered = pool.fork_extend(slot, p0 + want)
            wlens[slot] = min(want, covered - p0)
            tables[slot] = pool.fork_row(slot)

        # Draft phase: gamma masked single-token steps over the forked
        # tables. Step j proposes the token for output index idx+j with
        # the key non-speculative decode would use; rows past their
        # window ride along pointed at the scratch page.
        props = np.zeros((n, g), np.int32)
        cur = np.where(active, self._tok, 0).astype(np.int32)
        scratch_row = np.full_like(tables[0], pool.scratch_page)
        jmax = int(wlens.max()) if slots.size else 0
        for j in range(jmax):
            mask = active & (wlens > j)
            nxt = self._draft(
                self._put(np.where(mask, cur, 0)[:, None]),
                self._put(np.where(mask, pos0 + j, 0).astype(np.int32)),
                self._put(np.where(mask[:, None], tables, scratch_row[None])),
                self._put(np.where(mask, self._rid, 0).astype(np.int32)),
                self._put(np.where(mask, self._idx + j, 0)
                          .astype(np.int32))).cpu().numpy()
            props[mask, j] = nxt[mask]
            cur = np.where(mask, nxt, cur)
        if not self._draft_shared and jmax > 0:
            # Fill the draft's KV for the window's last input (it was the
            # draft's final output, never consumed) so a fully accepted
            # window leaves no hole in the draft context. The shared-layer
            # draft gets this from the verify.
            mask = active & (wlens > 0)
            last = np.maximum(wlens - 1, 0)
            zeros = self._put(np.zeros(n, np.int32))
            self._draft(
                self._put(np.where(mask, props[np.arange(n), last],
                                   0)[:, None]),
                self._put(np.where(mask, pos0 + wlens, 0).astype(np.int32)),
                self._put(np.where(mask[:, None], tables, scratch_row[None])),
                zeros, zeros)

        # Verify phase: one (gamma+1)-wide target step. Lane i of a row
        # holds the last accepted token (i == 0) or draft proposal i, at
        # absolute position pos+i; lanes past the window (and idle rows)
        # carry the scratch position, which resolves to the always-
        # scratch last table column for both the K/V write and the read.
        v_tok = np.zeros((n, w), np.int32)
        q_pos = np.full((n, w), scratch_pos, np.int32)
        rids = np.zeros((n, w), np.int32)
        idxs = np.zeros((n, w), np.int32)
        for slot in slots:
            slot = int(slot)
            wl = int(wlens[slot])
            v_tok[slot, 0] = self._tok[slot]
            v_tok[slot, 1:wl + 1] = props[slot, :wl]
            q_pos[slot, :wl + 1] = pos0[slot] + np.arange(wl + 1)
            rids[slot, :wl + 1] = self._rid[slot]
            idxs[slot, :wl + 1] = self._idx[slot] + np.arange(wl + 1)
        sel = self._verify(self._put(v_tok), self._put(q_pos),
                           self._put(tables), self._put(rids),
                           self._put(idxs)).cpu().numpy()      # syncs
        t = _resolve_now(now)    # after the sync: latency covers the window

        # Accept the longest draft prefix matching the target's
        # selections; emit the selections themselves (never proposals),
        # so output equals non-speculative decoding.
        finished: List[int] = []
        emitted_total = 0
        for slot in slots:
            slot = int(slot)
            if self._rid[slot] < 0:
                continue
            rid = int(self._rid[slot])
            wl = int(wlens[slot])
            k = 0
            while k < wl and int(props[slot, k]) == int(sel[slot, k]):
                k += 1
            for i in range(k + 1):
                self._emit_token(rid, int(sel[slot, i]), t)
            pool.commit_fork(slot, int(pos0[slot]) + k + 1)
            self._tok[slot] = sel[slot, k]
            self._idx[slot] += k + 1
            self._remaining[slot] -= k + 1
            emitted_total += k + 1
            self.spec_windows += 1
            self.spec_proposed += wl
            self.spec_accepted += k
            self._tracer.record("spec_window", rid=rid, proposed=wl,
                                accepted=k)
            if self._remaining[slot] == 0:
                self.records[rid]["done_s"] = t
                self._rid[slot] = -1
                pool.release(slot)
                finished.append(rid)
        self.steps += 1
        self.decode_tokens += emitted_total
        self._observe_cache()
        return finished

    # ----- bookkeeping ----------------------------------------------
    def reset(self) -> None:
        super().reset()
        self.spec_windows = self.spec_proposed = self.spec_accepted = 0
        self.draft_steps = 0

    def build_report(self, engine_name: str, wall_s: float,
                     token_budget, step_active,
                     tenant_shares=None) -> ServeReport:
        report = super().build_report(engine_name, wall_s, token_budget,
                                      step_active,
                                      tenant_shares=tenant_shares)
        d = self.draft_spec
        report.speculation = {
            "gamma": self.gamma,
            "draft": (f"arch:{d.arch}" if d.arch is not None
                      else f"layers:{d.num_layers}"),
            "windows": self.spec_windows,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
            "tokens_per_step": (self.decode_tokens / self.steps
                                if self.steps else 0.0),
        }
        return report

    @classmethod
    def from_spec(cls, cfg, spec, params=None, model=None,
                  device="cuda") -> "SpeculativeEngine":
        return cls(cfg, params=params,
                   num_slots=spec.resolved_num_slots(),
                   slot_len=spec.resolved_slot_len(),
                   seed=spec.engine.seed, model=model,
                   sampling=getattr(spec, "sampling", None),
                   page_size=spec.cache.page_size,
                   num_pages=spec.resolved_num_pages(),
                   draft=spec.draft, device=device)
