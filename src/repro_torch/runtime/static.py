"""Static-batch generation engine — the A/B baseline for the runtime (port
of :mod:`repro.runtime.static`).

One batch, assembled up front: every request pays the maximum prompt
length (left-padded) and rides every decode step to the maximum output
length, and nothing is admitted mid-flight — the batch inflation the
continuous runtime removes, kept behind the ``"static"`` entry of the
engine registry so spec sweeps can A/B the engines by flipping
``engine.name``.

It serves every model family, the encoder-decoder audio family included
(the continuous engine refuses it: whisper decodes at one scalar position
shared by the batch); VLM and audio configs get zero-filled patches or
frames occupying real positions, as in ``repro``. It runs on the card
unless the caller passes ``device="cpu"``; ``repro`` jit-compiles the
prefill per cache length and donates the decode cache, the port runs
eagerly and the model writes the cache in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch.api.registry import register_engine
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.engine import ServeReport, request_rows
from repro_torch.runtime.kvcache import tree_nbytes
from repro_torch.runtime.queue import ServeRequest


@dataclasses.dataclass
class Request:
    """Legacy request record for ``BatchedServer.generate`` callers."""
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)


@register_engine("static")
class BatchedServer:
    """Static-batch generation engine with greedy decoding.

    Kept as the A/B baseline for the continuous runtime. Without
    ``params`` it initializes random weights from a ``torch.Generator``
    seeded with ``seed`` on ``device`` ("cuda" by default; raises without
    a card unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg, params=None, seed: int = 0, *, model=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model if model is not None else build_model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            params = self.model.init(gen)
        self.params = params

    @classmethod
    def from_spec(cls, cfg, spec, params=None, model=None,
                  device="cuda") -> "BatchedServer":
        return cls(cfg, params=params, seed=spec.engine.seed, model=model,
                   device=device)

    def generate(self, requests: List[Request]) -> List[Request]:
        cfg = self.cfg
        b = len(requests)
        plen = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        cache_len = plen + max_new
        prompts = np.zeros((b, plen), np.int32)
        for i, r in enumerate(requests):
            # Left-padded: prompts are right-aligned so every row decodes
            # at one shared scalar position. Pad-token KV stays visible to
            # real tokens, so mixed-length static batches are not
            # token-identical to unpadded decoding.
            prompts[i, plen - len(r.prompt):] = r.prompt
        batch = {"tokens": torch.from_numpy(prompts).to(self.device)}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (b, cfg.num_patches, cfg.d_model), dtype=cfg.torch_dtype,
                device=self.device)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (b, cfg.encoder_seq, cfg.d_model), dtype=cfg.torch_dtype,
                device=self.device)
        logits, cache, pos = self.model.prefill(self.params, batch,
                                                cache_len=cache_len)
        # The whole-batch cache is allocated up front and held to the last
        # step — its size is the static engine's peak KV memory.
        self._cache_bytes = tree_nbytes(cache)
        tok = torch.argmax(logits, dim=-1)[:, None]
        firsts = tok[:, 0].tolist()                   # syncs
        for r, t in zip(requests, firsts):
            r.generated.append(int(t))
        self._t_first = time.perf_counter()      # post-prefill sync: TTFT
        for step in range(1, max_new):
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   pos)
            pos = pos + 1
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            picks = tok[:, 0].tolist()                # syncs
            for r, t in zip(requests, picks):
                if step < r.max_new_tokens:
                    r.generated.append(int(t))
        return requests

    def serve(self, requests: List[ServeRequest], spec=None,
              clock=None, tracer=None) -> ServeReport:
        """Spec-driven entry: one static batch over ``requests``.

        The static engine cannot honor staggered arrivals (the batch is
        assembled up front), so ``arrival_s`` is ignored; TTFT is stamped
        at the end of the padded batch prefill once for the whole batch
        (``ServeReport.ttft_shared``) and latency at batch completion.
        ``clock`` is unused (wall timing only); the parameter keeps the
        engine-registry ``serve`` signature uniform. A ``tracer``
        receives retroactive prefill/decode phase spans and per-request
        lifecycle spans with run-relative timestamps.
        """
        legacy = [Request(rid=r.rid, prompt=r.prompt,
                          max_new_tokens=r.max_new_tokens)
                  for r in requests]
        b = len(legacy)
        plen = max(len(r.prompt) for r in legacy)
        max_new = max(r.max_new_tokens for r in legacy)
        t0 = time.perf_counter()
        out = self.generate(legacy)
        wall = time.perf_counter() - t0
        t_first = self._t_first - t0            # run-relative stamps
        # engine-style lifecycle records: one shared admit/TTFT stamp for
        # the whole cohort (there is no per-request admission here)
        records = {r.rid: {"rid": r.rid, "prompt_len": int(len(r.prompt)),
                           "max_new_tokens": r.max_new_tokens,
                           "arrival_s": 0.0, "admit_start_s": 0.0,
                           "admit_s": t_first, "first_token_s": t_first,
                           "done_s": wall, "tokens": list(r.generated)}
                   for r in out}
        if tracer is not None and tracer.enabled:
            tracer.complete("admit", 0.0, t_first, cat="prefill", n=b)
            tracer.complete("decode", t_first, wall, cat="decode",
                            steps=max_new - 1, active=b)
            for rid in sorted(records):
                r = records[rid]
                tracer.request_lifecycle(
                    rid, r["arrival_s"], r["admit_start_s"], r["admit_s"],
                    r["done_s"], prompt_len=r["prompt_len"],
                    new_tokens=len(r["tokens"]))
        # KV accounting in the pooled engines' cache_stats schema: the
        # static batch reserves b x (plen + max_new) token rows for the
        # whole run, so allocated == capacity == peak and fragmentation is
        # everything the actual prompts + outputs didn't fill.
        cap_tokens = b * (plen + max_new)
        used = sum(len(r.prompt) + len(r.generated) for r in out)
        util = {"kind": "static", "capacity_bytes": self._cache_bytes,
                "in_use_bytes": self._cache_bytes,
                "peak_in_use_bytes": self._cache_bytes,
                "used_tokens": used, "allocated_tokens": cap_tokens,
                "fragmentation": (1.0 - used / cap_tokens) if cap_tokens
                else 0.0,
                "utilization": 1.0}
        return ServeReport(
            engine="static", arch=self.cfg.name, wall_s=wall,
            num_requests=b,
            prefill_tokens=b * plen,            # padded: max x batch
            # every row rides all max_new - 1 decode steps, finished or not
            decode_tokens=b * (max_new - 1),
            steps=max_new - 1, token_budget=None,
            max_active=b, step_active=[b] * max(max_new - 1, 0),
            per_request=request_rows(records), ttft_shared=True,
            cache_utilization=util)
