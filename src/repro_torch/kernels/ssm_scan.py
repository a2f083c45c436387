"""Mamba-1 selective scan: the hand-written CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssm_scan.py``
(``ssm_scan``). The kernel lives in ``csrc/ssm_scan.cu`` (design and
bound notes there); :func:`ssm_scan` launches it on CUDA tensors and
:func:`ssm_scan_plain` computes the same function in plain PyTorch — the
CPU path and the on-card oracle.

    h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) (outer) B_t ;  y_t = h_t . C_t

from h_0 = 0. Layout: x (B, L, D) and B, C (B, L, N) in the model dtype;
dt (B, L, D) and a (D, N) fp32. Returns (y (B, L, D) fp32, h_last
(B, D, N) fp32). Forward only: the TPU kernel has no backward, and the
port's kernel has none yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_N = 64
PER_LANE = 4      # states a lane of the kernel owns


def _check(x, dt, a, bmat, cmat):
    dev = x.get_device()           # an index: no torch.device object built
    if not x.is_cuda or dt.get_device() != dev or a.get_device() != dev \
            or bmat.get_device() != dev or cmat.get_device() != dev:
        raise ValueError("ssm_scan: every input must be a CUDA tensor on "
                         "one device")
    if x.dtype not in _DTYPE_CODES or bmat.dtype != x.dtype \
            or cmat.dtype != x.dtype:
        raise ValueError(f"ssm_scan: x, B and C must share one of "
                         f"{list(_DTYPE_CODES)}, got {x.dtype}/{bmat.dtype}/"
                         f"{cmat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError("ssm_scan: dt and a must be float32")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"ssm_scan: x and dt must be (B, L, D), got "
                         f"{tuple(x.shape)} / {tuple(dt.shape)}")
    b, l, d = x.shape
    if a.dim() != 2 or a.shape[0] != d:
        raise ValueError(f"ssm_scan: a must be (D, N), got {tuple(a.shape)}")
    n = a.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"ssm_scan: state size {n} must be in 1..{MAX_N}")
    if bmat.shape != (b, l, n) or cmat.shape != (b, l, n):
        raise ValueError(f"ssm_scan: B and C must be {(b, l, n)}, got "
                         f"{tuple(bmat.shape)} / {tuple(cmat.shape)}")
    if not all(t.is_contiguous() for t in (x, dt, a, bmat, cmat)):
        raise ValueError("ssm_scan: inputs must be contiguous")


def _kernel():
    """The loaded library and its launcher, argtypes declared once."""
    lib = _build.load("ssm_scan")
    fn = lib.ssm_scan_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 7 + [ctypes.c_int] * 4 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def ssm_scan(x, dt, a, bmat, cmat):
    """Launch the CUDA kernel; raises on anything it does not take."""
    _check(x, dt, a, bmat, cmat)
    b, l, d = x.shape
    n = a.shape[1]
    y = torch.empty((b, l, d), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    lib, fn = _kernel()
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(),
             h_last.data_ptr(), b, l, d, n, stream)
    _build.check(err, lib, "ssm_scan")
    return y, h_last


def _state_tiers(n: int) -> int:
    """The kernel's state count: N rounded up to 8, 16, 32 or 64."""
    return next(t for t in (8, 16, 32, 64) if n <= t)


def sum_states(hc: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (N states) in the kernel's order: zero-padded to
    the kernel's state count, each lane's 4 states in index order, then
    the lanes' partial sums pairwise (the xor-shuffle tree)."""
    n = hc.shape[-1]
    pad = _state_tiers(n) - n
    if pad:
        hc = torch.nn.functional.pad(hc, (0, pad))
    g = hc.unflatten(-1, (-1, PER_LANE))
    p = g[..., 0]
    for j in range(1, PER_LANE):
        p = p + g[..., j]
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def ssm_scan_plain(x, dt, a, bmat, cmat):
    """The kernel's function in plain PyTorch: the sequential recurrence of
    ``repro``'s ``ssm_scan_ref``, one time step at a time, with y_t summed
    over the states in the kernel's order (:func:`sum_states`).
    Differentiable (the CPU training path of a Mamba-1 block runs through
    it)."""
    b, l, d = x.shape
    n = a.shape[1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = bmat.float(), cmat.float()
    h = torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        dtt = dtf[:, t]                                        # (B, D)
        a_bar = torch.exp(dtt[..., None] * af[None])           # (B, D, N)
        h = a_bar * h + (dtt * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(sum_states(h * cf[:, t, None, :]))
    return torch.stack(ys, dim=1), h
