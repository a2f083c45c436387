"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface (no PyTorch headers),
so ``nvcc`` takes seconds per file. The command is::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and a stale library is
never loaded. Output goes to
``build/kernels/`` at the repository root (listed in ``.gitignore``).
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, List

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# every CUDA source of the port, csrc/<name>.cu
SOURCES = ("flash_attention", "paged_attention", "spec_verify", "ssm_scan",
           "mamba2_fwd", "mamba2_bwd", "cross_entropy")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    digest = hashlib.sha1(CSRC.joinpath(f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared headers, e.g.
        digest.update(header.read_bytes())       # hopper.cuh
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str], verbose: bool = False) -> List[str]:
    """Compile every named source that has no current library, one
    ``nvcc`` per source, all started together. Returns the compiler
    output of each build (``-Xptxas -v`` register and spill counts when
    ``verbose``); raises with the compiler's errors if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"[nvcc {name}] rc={proc.returncode}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)      # atomic: readers never see a partial
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaGetLastError()``: a
    refused launch never runs, and a later synchronize does not report
    it."""
    if err != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
