#!/usr/bin/env python3
"""Check and time the SSM scan kernels alone, on one card.

    python3 tools/scan_probe.py [fwd|bwd|all] [VARIANT.cu ...]

Builds ``csrc/ssm_scan.cu``, ``mamba2_fwd.cu`` and ``mamba2_bwd.cu``
(``-Xptxas -v``) and prints each scan kernel's registers and spills by
instantiation and its SASS instruction counts (MUFU.EX2, LDS, SHFL, FP32,
local-memory spills). ``fwd``: the per-head B4 (``ssm_scan_heads``) at
zamba2's shapes and small ragged ones, bf16 and fp32, against B4 on the
inputs expanded per channel (bitwise), a second launch (bitwise), its
plain version and its exponential count; at zamba2's shapes timed by
device time beside that B4 call. ``bwd``: B4-bwd (``ssm_scan_bwd``) at
falcon-mamba's training shape and ragged ones, with and without dh_last,
against ``ssm_scan_bwd_plain`` (``chip_smoke.scan_bwd_errors``' limits),
a second launch and its exponential count; timed at falcon-mamba's
shape. Each VARIANT.cu (a copy of ``ssm_scan.cu`` or ``mamba2_fwd.cu``
with a change to try, by its file name) is built beside them and timed
on the same inputs in the same process. Prints one JSON line per case
and "PROBE OK" when every check held.
"""
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.ssm_scan import (bwd_exp_count,  # noqa: E402
                                          expand_heads, heads_fwd_exp_count,
                                          ssm_scan_bwd, ssm_scan_bwd_plain,
                                          ssm_scan_heads,
                                          ssm_scan_heads_plain)

FWD_SHAPES = ((1, 100, 5120, 64, 64), (1, 32, 5120, 64, 64),
              (4, 32, 5120, 64, 64), (16, 128, 5120, 64, 64),
              (8, 32, 256, 8, 32), (3, 37, 60, 5, 5), (2, 21, 160, 16, 80))
BWD_SHAPES = ((16, 128, 8192, 16), (3, 37, 200, 5), (2, 40, 128, 64),
              (2, 33, 256, 8))


def build_variants(paths):
    """Each variant source built into its own library, all at once."""
    libs = {"ssm_scan": {}, "mamba2_fwd": {}}
    procs = []
    for path in paths:
        out = _build.BUILD_DIR / f"variant_{pathlib.Path(path).stem}.so"
        procs.append((path, out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-o", str(out), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for path, out, proc in procs:
        text, _ = proc.communicate()
        kind = "ssm_scan" if "ssm_scan" in pathlib.Path(path).name \
            else "mamba2_fwd"
        kern = "ssm_bwd_kernel" if kind == "ssm_scan" else "mamba2_fwd_kernel"
        print(path, "rc", proc.returncode,
              json.dumps(cs.ptxas_usage([text], kern)), flush=True)
        if proc.returncode:
            print(text[-3000:], flush=True)
        else:
            libs[kind][path] = ctypes.CDLL(str(out))
    return libs


def sass_counts():
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kern in (("mamba2_fwd", "mamba2_fwd_kernel"),
                      ("ssm_scan", "ssm_bwd_kernel"),
                      ("ssm_scan", "ssm_scan_kernel")):
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                              capture_output=True, text=True).stdout
        per, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                per[fn] = {}
            elif fn is not None:
                for op in ("MUFU.EX2", "LDS", "SHFL", "FFMA", "FMUL", "FADD",
                           "STL", "LDL", "BAR"):
                    if op in line:
                        per[fn][op] = per[fn].get(op, 0) + 1
        print(kern, json.dumps({k: v for k, v in per.items() if kern in k}),
              flush=True)


def timed_with(lib_name, libs, fn, match, **kw):
    """Device ms of ``fn`` with each variant library in turn."""
    out, main = {}, _build._LIBS[lib_name]
    for path, lib in libs.items():
        _build._LIBS[lib_name] = lib
        out[path] = {"dev_ms": cs.device_ms(torch, fn, match, **kw),
                     "result": fn()}
        _build._LIBS[lib_name] = main
    return out


def fwd_cases(dev, gen, variants):
    ok = True
    for b, l, d, n, hd in FWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = cs.heads_case(torch, dev, gen, b, l, d, n, hd, dtype)
            cnt = torch.zeros(1, dtype=torch.int64, device=dev)
            y, h = ssm_scan_heads(*args, exp_count=cnt)
            y2, h2 = ssm_scan_heads(*args)
            exp = (args[0], *expand_heads(args[1], args[2], hd, n), args[3],
                   args[4])
            ry, rh = ops.selective_scan(*exp)
            py, ph = ssm_scan_heads_plain(*args)
            torch.cuda.synchronize()
            bit = torch.equal(y, ry) and torch.equal(h, rh)
            rep = torch.equal(y, y2) and torch.equal(h, h2)
            err = max((y - py).abs().max().item(),
                      (h - ph).abs().max().item())
            want = heads_fwd_exp_count(b, l, d // hd, hd, n)
            line = {"shape": (b, l, d, n, hd), "dtype": str(dtype),
                    "bitwise_b4": bit, "repeat": rep, "err_plain": err,
                    "count": int(cnt.item()), "want": want}
            if d == 5120:
                fn = lambda: ssm_scan_heads(*args)  # noqa: E731
                line["dev_ms"] = cs.device_ms(torch, fn, "mamba2_fwd")
                line["b4_dev_ms"] = cs.device_ms(
                    torch, lambda: ops.selective_scan(*exp),
                    "ssm_scan_kernel")
                for path, r in timed_with("mamba2_fwd", variants, fn,
                                          "mamba2_fwd").items():
                    line["variant " + path] = {
                        "dev_ms": r["dev_ms"],
                        "bitwise": torch.equal(r["result"][0], ry)}
            ok = ok and bit and rep and err <= 1e-5 and cnt.item() == want
            print(json.dumps(line), flush=True)
    return ok


def bwd_cases(dev, gen, variants):
    ok = True
    for b, l, d, n in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = cs.scan_case(torch, dev, gen, dtype, b, l, d, n)
            dy = torch.randn((b, l, d), generator=gen, device=dev)
            dh = torch.randn((b, d, n), generator=gen, device=dev)
            line = {"shape": (b, l, d, n), "dtype": str(dtype)}
            for dhl in (None, dh):
                cnt = torch.zeros(1, dtype=torch.int64, device=dev)
                got = ssm_scan_bwd(*args, dy, dhl, exp_count=cnt)
                again = ssm_scan_bwd(*args, dy, dhl)
                want = ssm_scan_bwd_plain(*args, dy, dhl)
                if dhl is None:
                    want0 = want
                torch.cuda.synchronize()
                errs, good = cs.scan_bwd_errors(torch, got, want)
                rep = all(torch.equal(x, y) for x, y in zip(got, again))
                line["dh_last" if dhl is not None else "no_dh_last"] = {
                    "errs": {k: v[1] for k, v in errs.items()}, "ok": good,
                    "repeat": rep, "count": int(cnt.item()),
                    "want": bwd_exp_count(b, l, d, n)}
                ok = ok and good and rep and \
                    cnt.item() == bwd_exp_count(b, l, d, n)
            if b * l * d >= 1 << 20:
                fn = lambda: ssm_scan_bwd(*args, dy)  # noqa: E731
                line["dev_ms"] = cs.device_ms(torch, fn, "ssm_bwd", iters=10)
                for path, r in timed_with("ssm_scan", variants, fn,
                                          "ssm_bwd", iters=10).items():
                    line["variant " + path] = {
                        "dev_ms": r["dev_ms"],
                        "ok": cs.scan_bwd_errors(torch, r["result"],
                                                 want0)[1]}
            print(json.dumps(line), flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 2
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.time()
    logs = _build.build(["ssm_scan", "mamba2_fwd", "mamba2_bwd"],
                        verbose=True)
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    for k in ("mamba2_fwd_kernel", "ssm_bwd_kernel"):
        print(k, json.dumps(cs.ptxas_usage(logs, k)), flush=True)
    for name in ("ssm_scan", "mamba2_fwd"):
        _build.load(name)
    variants = build_variants(sys.argv[2:])
    sass_counts()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ok = True
    if which in ("all", "fwd"):
        ok = fwd_cases(dev, gen, variants["mamba2_fwd"]) and ok
    if which in ("all", "bwd"):
        ok = bwd_cases(dev, gen, variants["ssm_scan"]) and ok
    print("PROBE OK" if ok else "PROBE FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
