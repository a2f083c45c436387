"""Materialize a ServeSpec and run it (port of :mod:`repro.api.serving`).

Build the model the spec describes (optionally restoring a params artifact
in ``repro``'s checkpoint format from ``spec.checkpoint``), construct the
registered engine sized by the spec on the requested device, synthesize
the seeded request workload — the same trace ``repro`` builds from the
same spec — and serve it, returning the engine's
:class:`repro_torch.runtime.ServeReport`::

    run_serve(ServeSpec.from_json(text))                 # on the card
    run_serve(ServeSpec.from_json(text), device="cpu")   # tests
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, List, Optional

import numpy as np

from repro_torch.api.registry import get_engine
from repro_torch.api.specs import ModelSpec, ServeSpec, SpecError
from repro_torch.device import resolve_device
from repro_torch.obs import maybe_profiler, tracer_from_spec, write_outputs


@dataclasses.dataclass
class ServeContext:
    """Built serving objects; pass back to ``run_serve`` to reuse the
    engine across runs of related specs (the pool geometry is fixed at
    build time)."""
    model: Any
    params: Any
    engine: Any
    spec: ServeSpec


def build_model(spec: ModelSpec, *, seq_len: Optional[int] = None):
    """Model instance for a ModelSpec (the paper's CNN or an LM), with
    overrides (``repro.api.runner.build_model``)."""
    from repro_torch.configs import get_config
    cfg = get_config(spec.arch, reduced=spec.reduced)
    over = dict(spec.overrides)
    if spec.arch != "paper-cnn" and seq_len is not None \
            and "max_seq_len" not in over:
        over["max_seq_len"] = max(seq_len, 256)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    if spec.arch == "paper-cnn":
        from repro_torch.models.cnn import CNNModel
        return CNNModel(cfg)
    from repro_torch.models import build_model as build_lm
    return build_lm(cfg)


def build_workload(spec: ServeSpec, vocab_size: int):
    """The seeded request trace a WorkloadSpec describes.

    Per request: a prompt length and output length drawn from the spec's
    menus, then uniform random token ids — one rng stream, so the trace is
    a pure function of the spec. Straggler arrivals (when configured) reuse
    the training-side delay model; ``workload.arrival`` instead draws
    absolute arrival times from a named process
    (repro_torch.runtime.workload — poisson/bursty/diurnal/heavy_tail).
    ``workload.tenant_mix`` assigns each request a tenant by weight. Both
    extensions use their own seeded rng streams, so traces built without
    them are byte-identical to what this function always produced.
    """
    from repro_torch.runtime.queue import ServeRequest
    w = spec.workload
    rng = np.random.default_rng(w.seed)
    reqs: List = []
    for i in range(w.num_requests):
        plen = int(rng.choice(w.prompt_lens))
        reqs.append(ServeRequest(
            rid=i, prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.choice(w.max_new_tokens))))
    if w.arrivals is not None:
        from repro_torch.runtime.workload import straggler_arrivals
        a = w.arrivals
        delays = straggler_arrivals(w.num_requests, a.p_straggler, a.w_min,
                                    a.w_max, seed=a.seed,
                                    time_scale=w.time_scale)
        for r, t in zip(reqs, delays):
            r.arrival_s = float(t)
    elif w.arrival is not None:
        from repro_torch.runtime.workload import generate_arrivals
        times = generate_arrivals(w.arrival, w.num_requests)
        for r, t in zip(reqs, times):
            r.arrival_s = float(t)
    if w.tenant_mix is not None:
        names = sorted(w.tenant_mix)
        weights = np.asarray([w.tenant_mix[t] for t in names], np.float64)
        trng = np.random.default_rng([int(w.seed), 0x7e7a])
        picks = trng.choice(len(names), size=w.num_requests,
                            p=weights / weights.sum())
        for r, k in zip(reqs, picks):
            r.tenant = names[int(k)]
    return reqs


def restore_params(model, path: str, device="cuda"):
    """Load a checkpoint artifact (``repro``'s npz format) onto ``device``
    (the card unless the caller passes ``device="cpu"``) and check it fits
    ``model``: same tree, same leaf shapes."""
    from repro_torch.checkpoint import restore
    from repro_torch.models.layers import tree_leaves, tree_map
    params = restore(path, device=resolve_device(device))
    want = model.param_specs()
    try:
        pairs = tree_leaves(tree_map(lambda s, p: (s, p), want, params))
    except (KeyError, TypeError):
        pairs = None
    if pairs is None or len(tree_leaves(params)) != len(pairs):
        raise SpecError(
            f"checkpoint {path!r} does not match the spec's model tree "
            f"(arch/reduced/overrides must equal the training spec's)")
    for s, p in pairs:
        if tuple(p.shape) != tuple(s.shape):
            raise SpecError(
                f"checkpoint {path!r} leaf shape {tuple(p.shape)} != "
                f"model shape {tuple(s.shape)}; arch/reduced/overrides "
                f"must equal the training spec's")
    return params


def build_serve_context(spec: ServeSpec, params=None,
                        device="cuda") -> ServeContext:
    """Spec -> built engine on ``device``, without serving anything."""
    spec.validate()
    dev = resolve_device(device)
    model = build_model(spec.model, seq_len=spec.resolved_slot_len())
    if params is None and spec.checkpoint:
        params = restore_params(model, spec.checkpoint, device=dev)
    engine = get_engine(spec.engine.name).from_spec(
        model.cfg, spec, params=params, model=model, device=dev)
    return ServeContext(model=engine.model, params=engine.params,
                        engine=engine, spec=spec)


def verify_report(report, ctx: ServeContext, requests=None,
                  n: int = -1, stream_events=None) -> dict:
    """Check served outputs token-identical to single-request decoding.

    ``n`` limits how many requests are replayed through
    ``reference_generate`` (-1 = all). When the run streamed
    (``stream_events`` from the engine's ``on_token`` hook), the stream
    order is additionally audited against the final token order. Raises
    RuntimeError listing the diverging rids; returns the audit dict
    recorded on the report.
    """
    from repro_torch.runtime.engine import reference_generate
    if requests is None:
        requests = build_workload(ctx.spec, ctx.engine.cfg.vocab_size)
    k = len(requests) if n < 0 else min(n, len(requests))
    slot_len = ctx.engine.pool.slot_len
    by_rid = {r["rid"]: r["tokens"] for r in report.per_request}
    mismatches = []
    for req in requests[:k]:
        want = reference_generate(ctx.model, ctx.params, req.prompt,
                                  req.max_new_tokens, slot_len)
        if by_rid[req.rid] != want:
            mismatches.append(req.rid)
    if mismatches:
        raise RuntimeError(
            f"{report.engine} outputs diverge from single-request "
            f"decoding: rids {mismatches}")
    out = {"checked": k, "mismatches": []}
    if stream_events is not None:
        out["stream"] = audit_stream(report, stream_events)
    return out


def audit_stream(report, events) -> dict:
    """Stream order == final token order, per request.

    ``events`` are ``on_token`` emissions ``{"rid", "idx", "tok",
    "t_s"}`` in emission order. Every request's streamed token sequence
    must equal its report ``tokens`` list exactly (same tokens, same
    order, contiguous indices) — speculative bursts and plain decode
    emit through the same path, so this pins that path. Raises
    RuntimeError on divergence; returns the audit dict.
    """
    streamed: dict = {}
    for ev in events:
        seq = streamed.setdefault(ev["rid"], [])
        if ev["idx"] != len(seq):
            raise RuntimeError(
                f"stream emitted rid {ev['rid']} token index "
                f"{ev['idx']} out of order (expected {len(seq)})")
        seq.append(ev["tok"])
    bad = [r["rid"] for r in report.per_request
           if streamed.get(r["rid"], []) != r["tokens"]]
    if bad:
        raise RuntimeError(
            f"streamed token order diverges from the report for rids "
            f"{bad}")
    return {"events": len(events), "requests": len(streamed),
            "mismatches": []}


def run_serve(spec: ServeSpec, ctx: Optional[ServeContext] = None,
              device="cuda"):
    """Run one serving workload: build from the spec, serve, report.

    Runs on the card unless ``device="cpu"``. Pass a prebuilt ``ctx`` to
    reuse an engine (its device wins); the spec argument then rebinds the
    workload and scheduling axes. Telemetry (``spec.obs``) and streaming
    (``spec.stream``) behave as in ``repro``; ``obs.jax_profiler_dir``
    traces the serve with ``torch.profiler``.
    """
    if ctx is None:
        ctx = build_serve_context(spec, device=device)
    else:
        spec.validate()
        ctx = dataclasses.replace(ctx, spec=spec)
    obs = getattr(spec, "obs", None)
    clock = tracer = None
    if obs is not None and obs.enabled:
        from repro_torch.runtime.scheduler import make_clock
        clock = make_clock(spec.clock.kind, spec.clock.tick_s)
        tracer = tracer_from_spec(
            obs, clock=clock.now,
            meta={"kind": "serve", "engine": spec.engine.name,
                  "clock": spec.clock.kind})
    requests = build_workload(spec, ctx.engine.cfg.vocab_size)
    stream = getattr(spec, "stream", None)
    events: Optional[List[dict]] = None
    if stream is not None and stream.enabled:
        events = []
        ctx.engine.on_token = lambda rid, idx, tok, t_s: events.append(
            {"rid": rid, "idx": idx, "tok": tok, "t_s": round(t_s, 6)})
    try:
        with maybe_profiler(obs, ctx.engine.device):
            report = ctx.engine.serve(requests, spec, clock=clock,
                                      tracer=tracer)
    finally:
        ctx.engine.on_token = None
    if events is not None:
        if stream.path:
            pathlib.Path(stream.path).write_text(
                "".join(json.dumps(ev) + "\n" for ev in events))
        report.stream = audit_stream(report, events)
    if spec.report.verify:
        report.verified = verify_report(report, ctx, requests=requests,
                                        n=spec.report.verify,
                                        stream_events=events)
    if tracer is not None:
        tracer.record("serve_report", **{
            k: v for k, v in report.to_json().items()
            if k != "per_request"})
        write_outputs(tracer, obs)
    if spec.report.out:
        j = report.to_json()
        if not spec.report.per_request:
            j.pop("per_request", None)
        pathlib.Path(spec.report.out).write_text(
            json.dumps(j, indent=2) + "\n")
    return report

