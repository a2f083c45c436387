"""Split-inference serving CLI of the port — a thin shell over
``repro_torch.api.run_serve`` (mirrors ``repro.launch.serve``).

The workload is one ServeSpec, loaded from ``--config serve.json`` (the
same JSON ``repro`` reads) with dotted ``--set key=value`` overrides; the
convenience flags map onto spec overrides as in ``repro``. It runs on the
CUDA card unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \
      --speculative --draft-layers 4 --gamma 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --no-reduced --static
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --no-reduced --paged --sample --temperature 0.9 --top-k 50
  PYTHONPATH=src python -m repro_torch.launch.serve --config serve.json \\
      --set scheduler.policy=ljf --set workload.num_requests=64
  ... --device cpu          # reduced configs on the CPU
"""
from __future__ import annotations

import argparse
from typing import List

from repro_torch import api
# legacy re-exports, as in repro: the static engine lives in the runtime
from repro_torch.runtime.static import BatchedServer, Request  # noqa: F401


def default_serve_spec() -> api.ServeSpec:
    """The CLI's baseline spec: reduced granite, 8 requests, budget 8."""
    return api.ServeSpec(
        model=api.ModelSpec(arch="granite-3-2b", reduced=True))


def _legacy_overrides(args) -> List[str]:
    """Map the convenience flags onto dotted spec overrides."""
    sets: List[str] = []

    def add(key, value):
        if value is not None:
            sets.append(f"{key}={value}")

    add("model.arch", args.arch)
    if args.reduced is not None:        # tri-state: --reduced/--no-reduced
        add("model.reduced", "true" if args.reduced else "false")
    if args.static:
        add("engine.name", "static")
    if args.paged:
        add("engine.name", "paged")
    if args.speculative:
        add("engine.name", "speculative")
    add("cache.page_size", args.page_size)
    add("cache.num_pages", args.num_pages)
    add("draft.num_layers", args.draft_layers)
    add("draft.arch", args.draft_arch)
    add("draft.gamma", args.gamma)
    if args.stream is not None:
        add("stream.enabled", "true")
        if args.stream:
            add("stream.path", args.stream)
    add("sampling.method", "sample" if args.sample else None)
    add("sampling.temperature", args.temperature)
    add("sampling.top_k", args.top_k)
    add("sampling.top_p", args.top_p)
    add("workload.num_requests", args.requests)
    if args.prompt_len is not None:
        add("workload.prompt_lens", f"[{args.prompt_len}]")
    if args.max_new is not None:
        add("workload.max_new_tokens", f"[{args.max_new}]")
    add("admission.token_budget", args.budget)
    add("scheduler.policy", args.policy)
    add("report.verify", args.verify)
    add("checkpoint", args.checkpoint)
    if args.seed is not None:
        add("engine.seed", args.seed)
        add("workload.seed", args.seed)
    return sets


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, metavar="SERVE_JSON",
                    help="ServeSpec JSON file (repro's schema)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    dest="sets",
                    help="dotted spec override, e.g. scheduler.policy=ljf "
                         "(repeatable)")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved spec JSON and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu for "
                         "reduced configs)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="smoke-size architecture (--no-reduced for full)")
    ap.add_argument("--static", action="store_true",
                    help="use the static-batch engine (engine.name=static) "
                         "instead of the continuous runtime")
    ap.add_argument("--paged", action="store_true",
                    help="use the paged-KV engine (engine.name=paged)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged engine: tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged engine: physical page count")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-model speculative decoding "
                         "(engine.name=speculative)")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="speculative: draft = the target's first N layers")
    ap.add_argument("--draft-arch", default=None,
                    help="speculative: draft = an independent configs arch")
    ap.add_argument("--gamma", type=int, default=None,
                    help="speculative: draft tokens proposed per window")
    ap.add_argument("--stream", nargs="?", const="", default=None,
                    metavar="JSONL",
                    help="stream every emitted token (stream.enabled); with "
                         "a path, also write the JSONL sink")
    ap.add_argument("--sample", action="store_true",
                    help="seeded stochastic sampling instead of greedy "
                         "(sampling.method=sample; keyed by request id + "
                         "token index, reproducible)")
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=None)
    ap.add_argument("--max-new", type=int, default=None)
    ap.add_argument("--budget", type=int, default=None,
                    help="per-step decode token budget")
    ap.add_argument("--policy", default=None, choices=["fifo", "ljf"],
                    help="admission order (registered scheduler policy)")
    ap.add_argument("--verify", type=int, default=None,
                    help="check N outputs against single-request decoding "
                         "(-1 = all)")
    ap.add_argument("--checkpoint", default=None, metavar="PARAMS_NPZ",
                    help="serve params from a repro-format npz artifact")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    spec = (api.load_any_spec(args.config) if args.config
            else default_serve_spec())
    if not isinstance(spec, api.ServeSpec):
        raise SystemExit(f"{args.config} is a {spec.kind!r} spec; the serve "
                         f"CLI needs kind 'serve' (use repro_torch.launch."
                         f"train for training)")
    spec = api.apply_overrides(spec, _legacy_overrides(args) + args.sets)
    if args.print_spec:
        print(spec.to_json())
        return

    report = api.run_serve(spec, device=args.device)
    print(f"arch={report.arch} " + report.summary())
    for r in report.per_request[:3]:
        print(f"  req {r['rid']}: {r['tokens'][:12]}...")
    if report.speculation is not None:
        s = report.speculation
        print(f"speculation: draft {s['draft']} gamma {s['gamma']}, "
              f"{s['windows']} windows, acceptance "
              f"{s['acceptance_rate']:.3f}, {s['tokens_per_step']:.2f} "
              f"tokens per step")
    if report.verified is not None:
        print(f"verified token-identical: {report.verified['checked']} "
              f"requests")


if __name__ == "__main__":
    main()
