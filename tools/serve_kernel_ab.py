#!/usr/bin/env python3
"""Time the serving and scan kernels of several source trees in turns, on
one card.

    python3 tools/serve_kernel_ab.py OLD_TREE . . OLD_TREE

Each argument is the root of a checkout of this repository (e.g. the
parent commit unpacked with ``git archive`` into a git-ignored directory).
For each, in the order given, a fresh process puts that tree's ``src`` on
the path, builds its kernels there and times, on the same seeded inputs:
B3 (``ops.spec_verify``) at the speculative run's geometry, B2
(``ops.paged_attention``, a control) at the paged run's, and B4
(``ops.selective_scan``, a control) at the (B, L, D, N) the falcon-mamba
serving run launches and at (8, 100, 8192, 16), each by CUDA events
(``ms``) and by device time from torch.profiler (``device_ms``), B3 and
B2 also as host microseconds a wrapper call (``host_us``). Then the
Mamba-2 forward, ``ops.selective_scan_heads`` under no_grad in bf16, at
zamba2's prefill shapes and its training shape (B 16, L 128, D 5120, N
64, 64 channels a head): ``ms`` is the whole wrapper call (a tree that
expands dt and a per channel for B4 pays for that copy there),
``device_ms`` the scan kernel alone (the per-head kernel, or B4 where a
tree has none). And B4-bwd (``ops.selective_scan_bwd``, bf16) at
falcon-mamba's training shape (16, 128, 8192, 16), by events and device
time (both of its kernels). The timing helpers and input builders are
``chip_smoke.py``'s, from the tree this script lives in. Prints one JSON
line per tree and run.
"""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCAN_SHAPES = ((1, 100, 8192, 16), (4, 32, 8192, 16), (1, 32, 8192, 16),
               (8, 100, 8192, 16))
# (B, L, D, N, channels a head): zamba2's prefills and training shape
HEADS_SHAPES = ((1, 100, 5120, 64, 64), (4, 32, 5120, 64, 64),
                (1, 32, 5120, 64, 64), (16, 128, 5120, 64, 64))
SCAN_BWD_SHAPE = (16, 128, 8192, 16)      # falcon-mamba's training shape

CHILD = r"""
import json, sys
tree, root = sys.argv[1], sys.argv[2]
shapes, heads_shapes, bwd_shape = json.loads(sys.argv[3])
sys.path[:0] = [tree + "/src", root]
import torch
import chip_smoke as cs
from repro_torch.kernels import ops
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
out = {"tree": tree}
gen.manual_seed(0)
w = cs.SPEC_GAMMA + 1
case = cs.verify_case(torch, dev, gen, torch.bfloat16, w, [w - 1] * 8,
                      [14, 40, 50, 60, 70, 80, 90, 100])
fn = lambda: ops.spec_verify(*case)
out["verify"] = {"ms": cs.time_ms(torch, fn),
                 "device_ms": cs.device_ms(torch, fn,
                                           cs.DEVICE_MATCH["spec_verify"]),
                 "host_us": cs.host_us(torch, fn)}
gen.manual_seed(0)
case = cs.paged_case(torch, dev, gen)
fn = lambda: ops.paged_attention(*case)
out["paged"] = {"ms": cs.time_ms(torch, fn),
                "device_ms": cs.device_ms(torch, fn,
                                          cs.DEVICE_MATCH["paged_attention"]),
                "host_us": cs.host_us(torch, fn)}
out["scan"] = {}
for shape in shapes:
    gen.manual_seed(0)
    args = cs.scan_case(torch, dev, gen, torch.bfloat16, *shape)
    fn = lambda: ops.selective_scan(*args)
    out["scan"]["B={} L={}".format(*shape)] = {
        "ms": cs.time_ms(torch, fn),
        "device_ms": cs.device_ms(torch, fn, cs.DEVICE_MATCH["selective_scan"])}
out["heads"] = {}
per_head = hasattr(ops, "ssm_scan_heads")       # else B4 on expanded inputs
for b, l, d, n, hd in heads_shapes:
    gen.manual_seed(0)
    args = cs.heads_case(torch, dev, gen, b, l, d, n, hd, torch.bfloat16)
    fn = lambda: ops.selective_scan_heads(*args)
    with torch.no_grad():
        out["heads"]["B={} L={}".format(b, l)] = {
            "ms": cs.time_ms(torch, fn),
            "device_ms": cs.device_ms(
                torch, fn, "mamba2_fwd" if per_head else "ssm_scan_kernel"),
            "kernel": "per head" if per_head else "B4, expanded"}
    del args
gen.manual_seed(0)
args = cs.scan_case(torch, dev, gen, torch.bfloat16, *bwd_shape)
dy = torch.randn(args[0].shape, generator=gen, device=dev)
fn = lambda: ops.selective_scan_bwd(*args, dy)
out["scan_bwd"] = {"ms": cs.time_ms(torch, fn, iters=10),
                   "device_ms": cs.device_ms(torch, fn, "ssm_bwd", iters=10)}
print(json.dumps(out))
"""


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    print(chip_smoke.nvidia_smi_line(), flush=True)   # name, power limit
    for tree in sys.argv[1:]:
        tree = str(pathlib.Path(tree).resolve())
        run = subprocess.run(
            [sys.executable, "-c", CHILD, tree, str(ROOT),
             json.dumps([SCAN_SHAPES, HEADS_SHAPES, SCAN_BWD_SHAPE])],
            capture_output=True, text=True,
            timeout=900)
        if run.returncode:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
