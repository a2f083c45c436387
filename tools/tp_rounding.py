#!/usr/bin/env python3
"""How tensor parallelism's sums over ranks round against one card's
products, and how far that moves the bf16 gradient, on the card.

    python3 tools/tp_rounding.py

One process, no ranks. Part 1, at granite-3-2b's and llama3-8b's widths
(2048 tokens; random bf16 inputs): the share of elements where a product
summed from two halves of its inner dim differs from one card's product:
the row-parallel ``wo`` and ``w_down`` (``RowParallelProduct``'s
forward) and the column products' input gradient dy w^T
(``ColumnParallelProduct``'s backward), with bf16 partials summed in
bf16 (Megatron's all-reduce) and with fp32 partials summed in fp32 and
rounded once (the port's); and B1 on half the heads against all heads.

Part 2, in ``chip_smoke.py``'s ``[mesh]`` setting (full width, fan-in
d_in init, the first plan batch): the one-card step-0 gradient of
granite at 8 and 4 layers and llama3-8b at 4 (worst and median per-leaf
relative L2 against the one card's own), with only its row products
(``tensor_parallel.row_parallel``) computed another way: as two halves
in bf16, as two halves in fp32, and whole through an fp32 GEMM; and the
one card against itself. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def halves(torch, a, w, fp32: bool):
    """``a @ w`` as the sum of its two inner halves: fp32 partials summed
    in fp32 and rounded once, or bf16 partials summed in bf16."""
    n = a.shape[-1] // 2
    if fp32:
        return (a[..., :n].float() @ w[:n].float()
                + a[..., n:].float() @ w[n:].float()).to(a.dtype)
    return a[..., :n] @ w[:n] + a[..., n:] @ w[n:]


def mismatches(torch, dev) -> None:
    from repro_torch.kernels import ops
    torch.manual_seed(0)
    bf = torch.bfloat16
    for name, t, d, hq, hkv, hd, ff in (
            ("granite-3-2b", 2048, 2048, 32, 8, 64, 8192),
            ("llama3-8b", 2048, 4096, 32, 8, 128, 14336)):
        def rn(*shape, scale=1.0):
            return (torch.randn(shape, device=dev) * scale).to(bf)
        out = {}
        for what, a, w in (
                ("wo", rn(t, hq * hd), rn(hq * hd, d, scale=d ** -0.5)),
                ("w_down", rn(t, ff), rn(ff, d, scale=ff ** -0.5)),
                ("dx of q", rn(t, hq * hd),
                 rn(d, hq * hd, scale=d ** -0.5).T)):
            one = a @ w
            out[what] = {
                f"{kind} halves": (one != halves(torch, a, w, kind == "fp32"))
                .float().mean().item() for kind in ("bf16", "fp32")}
        q = rn(16, 128, hq, hd)
        k, v = rn(16, 128, hkv, hd), rn(16, 128, hkv, hd)
        whole = ops.attention(q, k, v, causal=True)
        half = ops.attention(q[:, :, :hq // 2].contiguous(),
                             k[:, :, :hkv // 2].contiguous(),
                             v[:, :, :hkv // 2].contiguous(), causal=True)
        out["B1 half heads"] = (whole[:, :, :hq // 2] != half).float() \
            .mean().item()
        print(f"{name}: share of elements that differ from one card's "
              f"{json.dumps(out)}", flush=True)


def floors(torch, dev) -> None:
    import chip_smoke as C
    from repro_torch import api
    from repro_torch.launch import tensor_parallel as tpl
    from repro_torch.launch.distributed import ShardedPSLEngine
    row_parallel = tpl.row_parallel
    for arch, layers, cut in (("granite-3-2b", 8, 2),
                              ("granite-3-2b", 4, 2), ("llama3-8b", 4, 1)):
        ctx, hosts = C.mesh_setup(api, dev, layers, cut, arch)
        eng = ShardedPSLEngine(ctx.model, ctx.optimizer, mesh="1x1",
                               device=dev)
        st = eng.init_state(ctx.seed)
        C.rescale_to_fan_in(torch, st.params, ctx.model.param_specs())
        batch = eng.put_batch(hosts[0])
        ref = eng.grads(st, batch)
        out = {}
        for what, product in (
                ("again", None),
                ("bf16 halves", lambda a, w: halves(torch, a, w, False)),
                ("fp32 halves", lambda a, w: halves(torch, a, w, True)),
                ("fp32 whole", lambda a, w: (a.float() @ w.float())
                 .to(a.dtype))):
            if product is not None:
                tpl.row_parallel = lambda part, f=product: f
            try:
                got = eng.grads(st, batch)
            finally:
                tpl.row_parallel = row_parallel
            out[what] = C._worst(C.leaf_rel_l2(got, ref))
            del got
        print(f"{arch} {layers} layers (cut {cut}): step-0 gradient against "
              f"one card's, row products computed as {json.dumps(out)}",
              flush=True)
        del ctx, hosts, eng, st, batch, ref
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_rounding: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    dev = torch.device("cuda")
    print(C.nvidia_smi_line(), flush=True)
    mismatches(torch, dev)
    floors(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
