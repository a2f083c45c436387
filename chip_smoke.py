#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

Runs from the repository root, on one CUDA card, and imports nothing of
JAX or of the JAX package. Phases (any failure exits non-zero):

1. Build. Every CUDA source of the serving path (``src/repro_torch/csrc``)
   is compiled for sm_90a, one ``nvcc`` per source, all at once.
2. Kernels. Each kernel is held against its plain PyTorch version on the
   card at the serving shapes of full-width granite-3-2b in bf16, and
   timed beside that plain version, the least time the card could take
   (``bound_ms``) and, where one PyTorch call computes the same function,
   that call (``library_ms``; the port never calls it).
3. Serve. ``repro_torch.api.run_serve`` at full width (40 layers, d_model
   2048, random weights from a seeded generator), once with the ``paged``
   engine and once with ``continuous``. The kernel launch counts are set to
   0 just before each run and read just after; the paged run must have
   launched both kernels.
4. Agreement. Every served request is replayed through
   ``reference_generate`` on the card. A token mismatch passes only as a
   near-tie: at the first diverging step the reference's top-2 logit gap
   must be below ``NEAR_TIE_GAP``.

The line before the last lists the kernels as JSON; the last line is the
device record ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent

# bf16 tolerance of a kernel against its plain version: both compute in
# fp32 and round the output to bf16 once; they differ in summation order
# and, for B1, in when probabilities are normalized (one bf16 ulp of
# outputs of magnitude ~1 is 2^-7 ~ 8e-3).
BF16_ATOL = 2e-2
BF16_RTOL = 2e-2
# A greedy token may differ from the single-request reference only where
# the reference's top-2 logits nearly tie. The logits come out of a bf16
# product (x @ lm_head) whose rounding depends on the batch and on the
# attention path: at |logit| in [2, 4), where the top logits of the
# random-init model sit, one bf16 ulp is 2^-6 = 0.0156. Four ulps:
NEAR_TIE_GAP = 0.0625

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak

SERVE = dict(num_requests=8, prompt_lens=[32, 100], max_new_tokens=[16],
             token_budget=8, page_size=16)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls
    after ``warmup`` (inputs stay L2-warm between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(torch, got, want) -> float:
    err = (got.float() - want.float()).abs()
    if not bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()):
        fail(f"kernel disagrees with its plain version: max_abs_err "
             f"{err.max().item()}")
    return err.max().item()


def kernel_phase(torch, dev):
    """Hold each kernel against its plain version; time all three."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.paged_attention import paged_attention_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    b1_cases = []
    hq, hkv, d = 32, 8, 64
    for b in (1, 16):
        for s in (100, 512):
            q, k, v = rn(b, s, hq, d), rn(b, s, hkv, d), rn(b, s, hkv, d)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)
            got = ops.attention(q, k, v, causal=True)
            want = flash_attention_plain(qt, kt, vt,
                                         causal=True).transpose(1, 2)
            torch.cuda.synchronize()
            err = within(torch, got, want)
            elt = 2
            nbytes = elt * (2 * b * s * hq * d + 2 * b * s * hkv * d)
            flops = 4.0 * b * hq * d * (s * (s + 1) / 2)
            bnd, by = bound_ms(nbytes, flops)
            case = {
                "shape": f"B={b} S=T={s} Hq={hq} Hkv={hkv} D={d} causal",
                "max_abs_err": err,
                "ms": time_ms(torch, lambda: ops.attention(q, k, v)),
                "plain_ms": time_ms(torch, lambda: flash_attention_plain(
                    qt, kt, vt, causal=True)),
                "bound_ms": bnd, "bound_by": by,
                "library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)),
            }
            print(f"kernel flash_attention {case['shape']}: err "
                  f"{err:.3g} (atol {BF16_ATOL}, rtol {BF16_RTOL}); "
                  f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
                  f"bound {bnd:.5f} ms ({by}), sdpa "
                  f"{case['library_ms']:.4f} ms", flush=True)
            b1_cases.append(case)

    # B2 at the paged run's geometry: 8 rows, 8 logical pages of 16, a
    # 64-page pool plus the scratch page; permuted tables, one row
    # mid-page and one at position 0.
    b, hq, hc, d, psize, m = 8, 32, 16, 64, 16, 8
    num_pages = b * m + 1
    q = rn(b, hq, d)
    kp, vp = rn(num_pages, psize, hc, d), rn(num_pages, psize, hc, d)
    table = torch.randperm(num_pages - 1, generator=gen, device=dev)[
        :b * m].reshape(b, m).to(torch.int32)
    pos = torch.randint(0, m * psize, (b,), generator=gen,
                        device=dev).to(torch.int32)
    pos[0] = psize // 2
    pos[-1] = 0
    got = ops.paged_attention(q, kp, vp, table, pos)
    want = paged_attention_plain(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    err = within(torch, got, want)
    keys = (pos.long() + 1).cpu()
    elt = 2
    nbytes = (elt * (2 * b * hq * d + int(keys.sum()) * hc * d * 2)
              + 4 * int((-(-keys // psize)).sum()) + 4 * b)
    flops = 4.0 * hq * d * int(keys.sum())
    bnd, by = bound_ms(nbytes, flops)
    b2 = {
        "shape": f"B={b} Hq={hq} Hc={hc} D={d} P={psize} M={m} "
                 f"pos={pos.tolist()}",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.paged_attention(
            q, kp, vp, table, pos)),
        "plain_ms": time_ms(torch, lambda: paged_attention_plain(
            q, kp, vp, table, pos)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }
    print(f"kernel paged_attention {b2['shape']}: err {err:.3g} (atol "
          f"{BF16_ATOL}, rtol {BF16_RTOL}); {b2['ms']:.4f} ms, plain "
          f"{b2['plain_ms']:.4f} ms, bound {bnd:.5f} ms ({by})",
          flush=True)
    return b1_cases, b2


def serve_spec(engine: str, events_dir: pathlib.Path):
    from repro_torch.api import (AdmissionSpec, CacheSpec, EngineSpec,
                                 ModelSpec, ObsSpec, ServeSpec, WorkloadSpec)
    return ServeSpec(
        model=ModelSpec(arch="granite-3-2b", reduced=False),
        engine=EngineSpec(name=engine, seed=0),
        admission=AdmissionSpec(token_budget=SERVE["token_budget"]),
        workload=WorkloadSpec(num_requests=SERVE["num_requests"],
                              prompt_lens=SERVE["prompt_lens"],
                              max_new_tokens=SERVE["max_new_tokens"]),
        cache=CacheSpec(page_size=SERVE["page_size"]),
        obs=ObsSpec(enabled=True,
                    events_path=str(events_dir / f"{engine}.jsonl")))


def phase_times(events_path: str):
    """Mean host-clock span (device work included: each phase ends in a
    sync) of the scheduler's admit (prefill) and decode_step phases."""
    spans = {"admit": [], "decode_step": []}
    for line in pathlib.Path(events_path).read_text().splitlines():
        row = json.loads(line)
        if row.get("kind") == "span" and row.get("name") in spans:
            spans[row["name"]].append(row["dur_s"] * 1e3)
    return {k: (sum(v) / len(v) if v else 0.0, len(v))
            for k, v in spans.items()}


def serve_phase(torch, dev, events_dir: pathlib.Path):
    from repro_torch.api import build_serve_context, build_workload, \
        run_serve
    from repro_torch.kernels import ops

    reports, ctx = {}, None
    params = None
    launches = {}
    for engine in ("paged", "continuous"):
        spec = serve_spec(engine, events_dir)
        t0 = time.perf_counter()
        ctx = build_serve_context(spec, params=params, device=dev)
        params = ctx.params
        torch.cuda.synchronize()
        print(f"[{engine}] built in {time.perf_counter() - t0:.2f}s "
              f"({sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
              f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated)", flush=True)
        ops.reset_launches()
        report = run_serve(spec, ctx=ctx)
        torch.cuda.synchronize()
        launches[engine] = ops.launch_counts()
        reports[engine] = report
        times = phase_times(spec.obs.events_path)
        print(report.summary(), flush=True)
        print(f"[{engine}] launches {launches[engine]}; steps "
              f"{report.steps}, prefill_tokens {report.prefill_tokens}, "
              f"decode_tokens {report.decode_tokens}; mean admit "
              f"(prefill) {times['admit'][0]:.2f} ms over "
              f"{times['admit'][1]}, mean decode step "
              f"{times['decode_step'][0]:.2f} ms over "
              f"{times['decode_step'][1]}; peak KV bytes "
              f"{report.cache_utilization['peak_in_use_bytes']}",
              flush=True)
    if min(launches["paged"].values()) < 1:
        fail(f"the paged run did not launch every kernel: "
             f"{launches['paged']}")
    if launches["continuous"]["flash_attention"] < 1:
        fail("the continuous run did not launch flash_attention")
    requests = build_workload(spec, ctx.engine.cfg.vocab_size)
    return reports, launches, ctx, requests


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def agreement_phase(reports, ctx, requests):
    from repro_torch.runtime import reference_generate
    vocab = ctx.engine.cfg.vocab_size
    exact = near = 0
    for req in requests:
        gaps = []
        want = reference_generate(ctx.model, ctx.params, req.prompt,
                                  req.max_new_tokens,
                                  ctx.engine.pool.slot_len, gaps=gaps)
        for engine, report in reports.items():
            got = next(r["tokens"] for r in report.per_request
                       if r["rid"] == req.rid)
            if len(got) != req.max_new_tokens or \
                    not all(0 <= t < vocab for t in got):
                fail(f"[{engine}] request {req.rid}: malformed tokens "
                     f"{got}")
            if got == want:
                exact += 1
                continue
            i = next(j for j in range(len(want)) if got[j] != want[j])
            if gaps[i] >= NEAR_TIE_GAP:
                fail(f"[{engine}] request {req.rid} diverges at token {i} "
                     f"where the reference's top-2 gap is {gaps[i]:.4f} "
                     f">= {NEAR_TIE_GAP}")
            near += 1
            print(f"[{engine}] request {req.rid}: near-tie at token {i} "
                  f"(reference top-2 gap {gaps[i]:.4f} < {NEAR_TIE_GAP})",
                  flush=True)
    print(f"agreement with reference_generate: {exact} exact, {near} "
          f"near-tie, of {len(requests) * len(reports)} served requests",
          flush=True)


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops

    dev = resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    for log in _build.build(["flash_attention", "paged_attention"],
                            verbose=True):
        for line in log.splitlines():
            if line.startswith("[nvcc") or "registers" in line \
                    or "spill" in line:
                print(line.strip())
    print(f"built kernels in {time.perf_counter() - t0:.1f}s", flush=True)

    b1_cases, b2 = kernel_phase(torch, dev)
    with tempfile.TemporaryDirectory() as events_dir:
        reports, launches, ctx, requests = serve_phase(
            torch, dev, pathlib.Path(events_dir))
    agreement_phase(reports, ctx, requests)

    b1 = max(b1_cases, key=lambda c: c["bound_ms"])
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:78",
         "launches": launches["paged"]["flash_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in b1_cases),
         **{k: b1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "shape")},
         "cases": b1_cases},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:81",
         "launches": launches["paged"]["paged_attention"],
         **{k: b2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "shape")}},
    ]
    if set(ops.WRAPPERS) != {k["name"] for k in kernels}:
        fail(f"kernel list {sorted(ops.WRAPPERS)} not all reported")
    print(smi)                  # nvidia-smi's "name, power.limit", as given
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
