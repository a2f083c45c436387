"""Drive ``chip_smoke.py``'s ``[mesh]`` phase for chosen tensor-parallel
runs alone, each in bf16 and in float32 (card, two ranks sharing it).

    python3 tools/mesh_probe.py ARCH [ARCH ...]

Each named entry of ``chip_smoke.MESH_TP_RUNS`` runs twice, in bf16 and
in float32 (``MESH_RUNS`` left out), with ``[mesh]``'s gates, prints and
kernel cases; a failed gate is printed and the probe goes on, so one
call shows both dtypes' readings beside each run's bf16 floor
(``mesh_reference(floor=True)``). An MoE run also plants the unsummed
combine. This is how a tp run's dtype is chosen: bf16 where its floor
sits under ``GRAD_REL_L2``. Works on a copy of ``chip_smoke.py`` in a
temporary directory, pointed at this checkout; writes the phase's
summary and kernel cases to ``build/mesh_probe.json``.
"""
import importlib.util
import json
import pathlib
import re
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def probe_source(archs, path: pathlib.Path) -> str:
    src = (ROOT / "chip_smoke.py").read_text()
    edits = [
        ("ROOT = pathlib.Path(__file__).resolve().parent",
         f"ROOT = pathlib.Path({str(ROOT)!r})"),
        ('str(ROOT / "chip_smoke.py"), "--mesh-rank"',
         f'{str(path)!r}, "--mesh-rank"'),
        ("# Per-leaf relative L2 limits",
         f"MESH_TP_RUNS = tuple(r[:3] + (d,) + r[4:] for d in (None, "
         f"'float32') for r in MESH_TP_RUNS if r[0] in {tuple(archs)!r})\n"
         f"# Per-leaf relative L2 limits"),
        ("planted_skip=i == MESH_SKIP_RUN", "planted_skip=False"),
        ("planted_norm=i == MESH_NORM_SKIP_RUN", "planted_norm=False"),
        ("planted_combine=i == MESH_COMBINE_SKIP_RUN",
         "planted_combine=arch == MOE_ARCH"),
        ('    raise SystemExit(f"chip_smoke: FAIL: {msg}")',
         '    print(f"chip_smoke: FAIL: {msg}", flush=True)'),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"mesh_probe: chip_smoke.py has no single "
                             f"{old!r}")
        src = src.replace(old, new)
    return re.sub(r'MESH_RUNS = \(\("2x1".*?\)\)\n', "MESH_RUNS = ()\n", src,
                  count=1, flags=re.S)


def main() -> int:
    archs = sys.argv[1:]
    if not archs:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mesh_probe: no CUDA device")
    from repro_torch.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "chip_smoke_probe.py"
        path.write_text(probe_source(archs, path))
        spec = importlib.util.spec_from_file_location("chip_smoke_probe",
                                                      path)
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)
        if not cs.MESH_TP_RUNS:
            raise SystemExit(f"mesh_probe: no MESH_TP_RUNS entry for "
                             f"{archs}")
        t0 = time.perf_counter()
        _build.build(_build.SOURCES)
        print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
        print(cs.nvidia_smi_line(), flush=True)
        summary, cases = cs.mesh_phase(torch, torch.device("cuda"))
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "mesh_probe.json").write_text(json.dumps(
        {"summary": summary, "cases": cases}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
