"""The selective scan: the hand-written CUDA kernels (forward B4 and
backward B4-bwd, in Mamba-1's layout and in Mamba-2's) and their plain
versions.

The forward replaces the Pallas TPU kernel ``src/repro/kernels/
ssm_scan.py`` (``ssm_scan``). The TPU kernel has no backward: ``repro``
differentiates its plain-JAX chunked scan (``_chunked_ssm_scan``), and
B4-bwd takes that place. Both kernels live in ``csrc/ssm_scan.cu``
(design and bound notes there). :func:`ssm_scan` and :func:`ssm_scan_bwd`
launch them on CUDA tensors; :func:`ssm_scan_plain` and
:func:`ssm_scan_bwd_plain` compute the same functions in plain PyTorch —
the CPU path and the on-card oracles.

    h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) (outer) B_t ;  y_t = h_t . C_t

from h_0 = 0. Layout: x (B, L, D) and B, C (B, L, N) in the model dtype;
dt (B, L, D) and a (D, N) fp32. Returns (y (B, L, D) fp32, h_last
(B, D, N) fp32). The backward takes the same inputs with dy (B, L, D)
fp32 and an optional dh_last (B, D, N) fp32 and returns (dx, ddt, da,
dB, dC): dx, dB and dC in the model dtype, ddt and da in fp32.

Mamba-2's layout (one decay a head): dt (B, L, nh) and a (nh,) per head.
:func:`ssm_scan_heads` launches the per-head forward
(``csrc/mamba2_fwd.cu``), the function B4 computes on those inputs
expanded per channel (:func:`expand_heads`), bit for bit;
:func:`ssm_scan_heads_bwd` launches the per-head backward
(``csrc/mamba2_bwd.cu``), returning ddt (B, L, nh) and da (nh,).
:func:`ssm_scan_heads_plain` and :func:`ssm_scan_heads_bwd_plain` are
their plain versions. Given an ``exp_count`` (a (1,) int64 tensor on the
card), each kernel but B4 adds to it the exponentials it evaluates:
:func:`heads_fwd_exp_count` and :func:`bwd_exp_count` state how many.
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


def _check_bwd(x, dt, a, bmat, cmat, dy, dh_last):
    _check(x, dt, a, bmat, cmat)
    b, l, d = x.shape
    n = a.shape[1]
    if dy.get_device() != x.get_device() or dy.dtype != torch.float32 \
            or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f"ssm_scan_bwd: dy must be a contiguous float32 "
                         f"{(b, l, d)} CUDA tensor, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    if dh_last is not None and (
            dh_last.get_device() != x.get_device()
            or dh_last.dtype != torch.float32 or dh_last.shape != (b, d, n)
            or not dh_last.is_contiguous()):
        raise ValueError(f"ssm_scan_bwd: dh_last must be a contiguous "
                         f"float32 {(b, d, n)} CUDA tensor or None")


# each launcher's (library, pointer arguments, int arguments)
_LAUNCHERS = {"ssm_scan_fwd": ("ssm_scan", 7, 4),
              "ssm_scan_bwd": ("ssm_scan", 17, 5),
              "ssm_scan_heads_fwd": ("mamba2_fwd", 8, 5),
              "ssm_scan_heads_bwd": ("mamba2_bwd", 18, 6)}


def _kernel(name: str):
    """The loaded library and launcher ``name``, argtypes declared once:
    the dtype code, the pointers, the ints, the stream."""
    lib_name, ptrs, ints = _LAUNCHERS[name]
    lib = _build.load(lib_name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * ptrs + [i] * ints + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def _check_counter(what: str, exp_count, x) -> None:
    if exp_count is not None and (
            exp_count.dtype != torch.int64 or exp_count.numel() != 1
            or exp_count.get_device() != x.get_device()):
        raise ValueError(f"{what}: exp_count must be one int64 on x's "
                         f"device")


def _ptr(t):
    return None if t is None else t.data_ptr()


def ssm_scan(x, dt, a, bmat, cmat):
    """Launch the CUDA kernel; raises on anything it does not take."""
    _check(x, dt, a, bmat, cmat)
    b, l, d = x.shape
    n = a.shape[1]
    y = torch.empty((b, l, d), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    lib, fn = _kernel("ssm_scan_fwd")
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(),
             h_last.data_ptr(), b, l, d, n, stream)
    _build.check(err, lib, "ssm_scan")
    return y, h_last


# B4-bwd's blocks each walk tiles_per_block channel tiles and keep their
# dB / dC partial sums, (groups, B, L, N) fp32 twice, in device memory:
# enough groups for ~BWD_BLOCKS blocks, capped so that those partials stay
# within BWD_PARTIAL_BYTES.
BWD_BLOCKS = 1024
BWD_PARTIAL_BYTES = 64 << 20
CHUNK = 8         # both backward kernels' steps a stage
SUB = 4           # B4-bwd's steps between checkpoints
BWD_TILE = 32     # the per-channel backward's channels a tile


def _bwd_groups(units: int, b: int, l: int, n: int):
    """(units_per_block, groups): ``units`` (channel tiles or heads) dealt
    to groups of blocks, ~BWD_BLOCKS blocks in all, with the dB / dC
    partials, (groups, B, L, N) fp32 twice, within BWD_PARTIAL_BYTES."""
    groups = max(1, min(units, -(-BWD_BLOCKS // b),
                        BWD_PARTIAL_BYTES // (8 * b * l * n)))
    per = -(-units // groups)
    return per, -(-units // per)


def bwd_grid(b: int, l: int, d: int, n: int):
    """(tiles_per_block, groups): the channel tiles (BWD_TILE channels
    each) that each B4-bwd block walks, and the launch's groups of them
    (its grid is (groups, B))."""
    return _bwd_groups(-(-d // BWD_TILE), b, l, n)


def bwd_exp_count(b: int, l: int, d: int, n: int) -> int:
    """The exponentials B4-bwd evaluates (``csrc/ssm_scan.cu``): each
    (b, d, n) pair one a step of the first pass over every 4-step
    sub-chunk but the last, and one a step of the second pass."""
    return b * d * n * (SUB * (-(-l // SUB) - 1) + l)


def ssm_scan_bwd(x, dt, a, bmat, cmat, dy, dh_last=None, exp_count=None):
    """Launch B4-bwd; raises on anything it does not take. ``exp_count``,
    a (1,) int64 tensor on x's device or None, gains the exponentials the
    kernel evaluates (:func:`bwd_exp_count`). Returns (dx, ddt, da, dB,
    dC)."""
    _check_bwd(x, dt, a, bmat, cmat, dy, dh_last)
    _check_counter("ssm_scan_bwd", exp_count, x)
    b, l, d = x.shape
    n = a.shape[1]
    dev = x.device
    per, groups = bwd_grid(b, l, d, n)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, l, d), **f32)
    da = torch.empty((d, n), **f32)
    dbm = torch.empty_like(bmat)
    dcm = torch.empty_like(cmat)
    db_part = torch.empty((groups, b, l, n), **f32)
    dc_part = torch.empty((groups, b, l, n), **f32)
    da_part = torch.empty((b, d, n), **f32)
    ckpt = torch.empty((max(1, groups * b * (-(-l // SUB) - 1) * 32
                            * _state_tiers(n)),), **f32)
    lib, fn = _kernel("ssm_scan_bwd")
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dy.data_ptr(),
             _ptr(dh_last), dx.data_ptr(), ddt.data_ptr(), dbm.data_ptr(),
             dcm.data_ptr(), da.data_ptr(), db_part.data_ptr(),
             dc_part.data_ptr(), da_part.data_ptr(), ckpt.data_ptr(),
             _ptr(exp_count), b, l, d, n, per, stream)
    _build.check(err, lib, "ssm_scan_bwd")
    return dx, ddt, da, dbm, dcm


# ------------------------------------------------- Mamba-2's layout

def expand_heads(dt, a, hd: int, n: int):
    """Mamba-2's per-head decay in the selective scan's per-channel
    layout: dt (B, L, nh) -> (B, L, nh*hd), each head's value on its hd
    channels, and a (nh,) -> (nh*hd, N), row c the value of head c // hd
    in every state. Both contiguous fp32, as B4 takes them. The model
    never builds them: the tests and chip_smoke.py hold the per-head
    kernels to B4 on them."""
    dt_c = dt.repeat_interleave(hd, dim=-1).contiguous()
    a_c = a.repeat_interleave(hd)
    return dt_c, a_c[:, None].expand(a_c.shape[0], n).contiguous()


def _check_heads(what, x, dt, a, bmat, cmat):
    dev = x.get_device()
    if not x.is_cuda or any(t.get_device() != dev
                            for t in (dt, a, bmat, cmat)):
        raise ValueError(f"{what}: every input must be a CUDA tensor on "
                         f"one device")
    if x.dtype not in _DTYPE_CODES or bmat.dtype != x.dtype \
            or cmat.dtype != x.dtype:
        raise ValueError(f"{what}: x, B and C must share one of "
                         f"{list(_DTYPE_CODES)}, got {x.dtype}/"
                         f"{bmat.dtype}/{cmat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{what}: dt and a must be float32")
    if x.dim() != 3 or a.dim() != 1 or dt.shape != (*x.shape[:2],
                                                     a.shape[0]):
        raise ValueError(f"{what}: x must be (B, L, D), a (nh,) and dt "
                         f"(B, L, nh), got {tuple(x.shape)} / "
                         f"{tuple(a.shape)} / {tuple(dt.shape)}")
    b, l, d = x.shape
    nh = a.shape[0]
    if d % nh:
        raise ValueError(f"{what}: D = {d} is not a multiple of the {nh} "
                         f"heads")
    if bmat.dim() != 3 or not 1 <= bmat.shape[-1] <= MAX_N:
        raise ValueError(f"{what}: state size of B {tuple(bmat.shape)} "
                         f"must be in 1..{MAX_N}")
    n = bmat.shape[-1]
    if bmat.shape != (b, l, n) or cmat.shape != (b, l, n):
        raise ValueError(f"{what}: B and C must be {(b, l, n)}, got "
                         f"{tuple(bmat.shape)} / {tuple(cmat.shape)}")
    if b > 65535:
        raise ValueError(f"{what}: batch {b} > 65535")
    if not all(t.is_contiguous() for t in (x, dt, a, bmat, cmat)):
        raise ValueError(f"{what}: inputs must be contiguous")


# mamba2_fwd.cu's kWideBlocks: two blocks an SM of the H100
HEADS_WIDE_BLOCKS = 2 * 132


def heads_fwd_exp_count(b: int, l: int, nh: int, hd: int, n: int) -> int:
    """The exponentials the per-head forward evaluates
    (``csrc/mamba2_fwd.cu``): one per (b, t, head) for each block that
    owns some of the head's channels. A block owns CW channels, whole
    heads when hd <= CW, else a tile of one head: ceil(hd / CW) blocks a
    head. CW is 128 at N <= 32; at N > 32 it is 64, or 16 where 64 would
    give the card fewer than HEADS_WIDE_BLOCKS blocks."""
    def row_blocks(cw):
        if hd <= cw:
            return -(-nh // min(cw // hd, 32))
        return nh * -(-hd // cw)
    cw = 128
    if n > 32:
        cw = 64 if b * row_blocks(64) >= HEADS_WIDE_BLOCKS else 16
    return b * l * nh * (-(-hd // cw) if hd > cw else 1)


def ssm_scan_heads(x, dt, a, bmat, cmat, exp_count=None):
    """Launch the per-head (Mamba-2) forward; raises on anything it does
    not take. x (B, L, D), dt (B, L, nh) fp32, a (nh,) fp32, B and C
    (B, L, N); ``exp_count``, a (1,) int64 tensor on x's device or None,
    gains the exponentials the kernel evaluates
    (:func:`heads_fwd_exp_count`). Returns (y (B, L, D) fp32, h_last
    (B, D, N) fp32)."""
    _check_heads("ssm_scan_heads", x, dt, a, bmat, cmat)
    _check_counter("ssm_scan_heads", exp_count, x)
    b, l, d = x.shape
    nh, n = a.shape[0], bmat.shape[-1]
    y = torch.empty((b, l, d), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    lib, fn = _kernel("ssm_scan_heads_fwd")
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(),
             h_last.data_ptr(), _ptr(exp_count), b, l, d, n, nh, stream)
    _build.check(err, lib, "ssm_scan_heads")
    return y, h_last


def _check_heads_bwd(x, dt, a, bmat, cmat, dy, dh_last):
    _check_heads("ssm_scan_heads_bwd", x, dt, a, bmat, cmat)
    b, l, d = x.shape
    n = bmat.shape[-1]
    dev = x.get_device()
    if dy.get_device() != dev or dy.dtype != torch.float32 \
            or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f"ssm_scan_heads_bwd: dy must be a contiguous "
                         f"float32 {(b, l, d)} CUDA tensor, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    if dh_last is not None and (
            dh_last.get_device() != dev or dh_last.dtype != torch.float32
            or dh_last.shape != (b, d, n) or not dh_last.is_contiguous()):
        raise ValueError(f"ssm_scan_heads_bwd: dh_last must be a "
                         f"contiguous float32 {(b, d, n)} CUDA tensor or "
                         f"None")


def heads_bwd_grid(b: int, l: int, nh: int, n: int):
    """(heads_per_block, groups): the heads each block of the per-head
    backward walks in turn, and the launch's groups of them (its grid is
    (groups, B))."""
    return _bwd_groups(nh, b, l, n)


def ssm_scan_heads_bwd(x, dt, a, bmat, cmat, dy, dh_last=None,
                       exp_count=None):
    """Launch the per-head (Mamba-2) backward; raises on anything it does
    not take. x (B, L, D), dt (B, L, nh) fp32, a (nh,) fp32, B and C
    (B, L, N), dy (B, L, D) fp32, dh_last (B, D, N) fp32 or None;
    ``exp_count``, a (1,) int64 tensor on x's device or None, gains one
    for each exp(dt a) the kernel evaluates. Returns (dx, ddt (B, L, nh),
    da (nh,), dB, dC)."""
    _check_heads_bwd(x, dt, a, bmat, cmat, dy, dh_last)
    _check_counter("ssm_scan_heads_bwd", exp_count, x)
    b, l, d = x.shape
    nh, n = a.shape[0], bmat.shape[-1]
    cpl = 2 if d // nh > 32 else 1           # channels a lane
    per, groups = heads_bwd_grid(b, l, nh, n)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, l, nh), **f32)
    da = torch.empty((nh,), **f32)
    dbm = torch.empty_like(bmat)
    dcm = torch.empty_like(cmat)
    db_part = torch.empty((groups, b, l, n), **f32)
    dc_part = torch.empty((groups, b, l, n), **f32)
    da_part = torch.empty((b, nh), **f32)
    escr = torch.empty((b, nh, l), **f32)
    ckpt = torch.empty((max(1, groups * b * (-(-l // CHUNK) - 1)
                            * 32 * _state_tiers(n) * cpl),), **f32)
    lib, fn = _kernel("ssm_scan_heads_bwd")
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dy.data_ptr(),
             _ptr(dh_last), dx.data_ptr(), ddt.data_ptr(), dbm.data_ptr(),
             dcm.data_ptr(), da.data_ptr(), db_part.data_ptr(),
             dc_part.data_ptr(), da_part.data_ptr(), escr.data_ptr(),
             ckpt.data_ptr(), _ptr(exp_count), b, l, d, n, nh, per, stream)
    _build.check(err, lib, "ssm_scan_heads_bwd")
    return dx, ddt, da, dbm, dcm


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


def ssm_scan_heads_plain(x, dt, a, bmat, cmat):
    """The per-head forward's function in plain PyTorch: e_t = exp(dt_t
    a) once per (b, t, head), broadcast over the head's channels and the
    states, then :func:`ssm_scan_plain`'s steps. Bit for bit
    :func:`ssm_scan_plain` on :func:`expand_heads`' inputs (the same
    products, in the same order). x (B, L, D), dt (B, L, nh) fp32, a
    (nh,) fp32, B and C (B, L, N) -> (y (B, L, D) fp32, h_last (B, D, N)
    fp32). Differentiable (the CPU training path of a Mamba-2 block runs
    through it)."""
    b, l, d = x.shape
    nh, n = a.shape[0], bmat.shape[-1]
    hd = d // nh
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = bmat.float(), cmat.float()
    e = torch.exp(dtf * af)                                    # (B, L, nh)
    h = torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        a_bar = e[:, t].repeat_interleave(hd, dim=-1)[..., None]  # (B, D, 1)
        dtt = dtf[:, t].repeat_interleave(hd, dim=-1)             # (B, D)
        h = a_bar * h + (dtt * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(sum_states(h * cf[:, t, None, :]))
    return torch.stack(ys, dim=1), h


def ssm_scan_bwd_plain(x, dt, a, bmat, cmat, dy, dh_last=None):
    """B4-bwd's function in plain PyTorch (no autograd): the states
    recomputed forward, then the reverse recurrence of their adjoint g_t,

        g_t = dy_t C_t + exp(dt_{t+1} a) g_{t+1},   g_{L-1} = dh_last + dy C,

    with every product in the kernel's order and the sums over the N
    states in its order (:func:`sum_states`); the sums over D, t and b
    are torch's. Returns (dx, ddt, da, dB, dC): dx, dB and dC in x's
    dtype, ddt and da fp32."""
    b, l, d = x.shape
    n = a.shape[1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf, dyf = bmat.float(), cmat.float(), dy.float()
    h = torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(l):
        dtt = dtf[:, t]
        a_bar = torch.exp(dtt[..., None] * af[None])
        h = a_bar * h + (dtt * xf[:, t])[..., None] * bf[:, t, None, :]
        hs.append(h)
    g = (torch.zeros_like(h) if dh_last is None
         else dh_last.float().clone())
    dx, ddt, dbm, dcm = [], [], [], []
    da = torch.zeros((d, n), dtype=torch.float32, device=x.device)
    for t in reversed(range(l)):
        dtt, xt = dtf[:, t], xf[:, t]
        a_bar = torch.exp(dtt[..., None] * af[None])
        hp = hs[t - 1] if t else torch.zeros_like(h)
        g = g + dyf[:, t, :, None] * cf[:, t, None, :]
        bt = bf[:, t, None, :]
        dx.append(dtt * sum_states(g * bt))
        ddt.append(sum_states(g * (xt[..., None] * bt
                                   + (af[None] * a_bar) * hp)))
        dbm.append((g * (dtt * xt)[..., None]).sum(1))
        dcm.append((dyf[:, t, :, None] * hs[t]).sum(1))
        da = da + ((g * dtt[..., None]) * (a_bar * hp)).sum(0)
        g = a_bar * g
    flip = lambda seq: torch.stack(seq[::-1], dim=1)    # noqa: E731
    return (flip(dx).to(x.dtype), flip(ddt), da, flip(dbm).to(bmat.dtype),
            flip(dcm).to(cmat.dtype))


def ssm_scan_heads_bwd_plain(x, dt, a, bmat, cmat, dy, dh_last=None):
    """The per-head backward's function in plain PyTorch (no autograd):
    the states (B, nh, hd, N) recomputed forward with one decay e_t =
    exp(dt_t a) a (b, t, head), then the reverse recurrence of their
    adjoint,

        g_t = dy_t C_t + e_{t+1} g_{t+1},   g_{L-1} = dh_last + dy C,

    with ddt_t = x_t . gb_t + a e_t S_t and da = sum_{b,t} dt_t e_t S_t
    per head, where gb_t[c] = g_t[c] . B_t and S_t = g_t . h_{t-1} over
    the head's channels and states. x (B, L, D), dt (B, L, nh) fp32, a
    (nh,) fp32, B and C (B, L, N), dy (B, L, D), dh_last (B, D, N) or
    None. Returns (dx, ddt (B, L, nh), da (nh,), dB, dC): dx, dB and dC
    in the inputs' dtype, ddt and da fp32."""
    b, l, d = x.shape
    nh, n = a.shape[0], bmat.shape[-1]
    hd = d // nh
    xf = x.float().reshape(b, l, nh, hd)
    dyf = dy.float().reshape(b, l, nh, hd)
    dtf, af = dt.float(), a.float()
    bf, cf = bmat.float(), cmat.float()
    e = torch.exp(dtf * af)                       # (B, L, nh)
    h = torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(l):
        u = dtf[:, t, :, None] * xf[:, t]         # (B, nh, hd)
        h = e[:, t, :, None, None] * h + u[..., None] * bf[:, t, None,
                                                           None, :]
        hs.append(h)
    g = (torch.zeros_like(h) if dh_last is None
         else dh_last.float().reshape(b, nh, hd, n).clone())
    dx, ddt, dbm, dcm = [], [], [], []
    da = torch.zeros((nh,), dtype=torch.float32, device=x.device)
    for t in reversed(range(l)):
        dtt, et, xt = dtf[:, t], e[:, t], xf[:, t]
        hp = hs[t - 1] if t else torch.zeros_like(h)
        g = g + dyf[:, t, ..., None] * cf[:, t, None, None, :]
        gb = (g * bf[:, t, None, None, :]).sum(-1)          # (B, nh, hd)
        s = (g * hp).sum((-2, -1))                          # (B, nh)
        dx.append((dtt[..., None] * gb).reshape(b, d))
        ddt.append((xt * gb).sum(-1) + af * et * s)
        da = da + (dtt * et * s).sum(0)
        dbm.append((g * (dtt[..., None] * xt)[..., None]).sum((1, 2)))
        dcm.append((dyf[:, t, ..., None] * hs[t]).sum((1, 2)))
        g = et[..., None, None] * g
    flip = lambda seq: torch.stack(seq[::-1], dim=1)    # noqa: E731
    return (flip(dx).to(x.dtype), flip(ddt), da, flip(dbm).to(bmat.dtype),
            flip(dcm).to(cmat.dtype))
