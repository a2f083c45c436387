"""The port's speculative serving path against repro's.

Reduced granite in float32 on the CPU, parameters bridged from repro:

- the PagePool fork API driven through the same call sequences as
  tests/test_spec_decode.py, on repro's pool and the port's side by side
  (tables, free lists, counters and cache_stats equal after every call);
- the spec-verify kernel's plain version against repro's ``spec_verify_ref``
  and the Pallas kernel in interpret mode (float32 atol 2e-5, rtol 1e-4:
  sums in another order; bfloat16 atol/rtol 2e-2: the port keeps
  probabilities in fp32 for P.V as the TPU kernel does, the oracle rounds
  them to bf16 first), its window causality, and W == 1 against the
  paged-attention plain version (bitwise: the same arithmetic);
- ``decode_window_paged`` logits against repro's (atol 1e-4 after the
  same float32 products summed in another order);
- the ``speculative`` engine token-identical to repro's and to the port's
  ``paged`` engine for both draft sources, with equal report counters,
  through eviction in the middle of a window and tenant preemption, with
  no page leaks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.kernels import ref as jref
from repro.kernels.spec_verify import spec_verify as pallas_verify
from repro.runtime.paging import PagePool as JPagePool
from repro_torch import api as tapi
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (combine_partials_plain,
                                                 paged_attention_plain,
                                                 split_partials_plain)
from repro_torch.kernels.spec_verify import spec_verify_plain
from repro_torch.launch import serve as serve_cli
from repro_torch.runtime.paging import PagePool as TPagePool
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "granite-3-2b"
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


def _pair(arr, jdt, tdt):
    j = jnp.asarray(arr, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------- B3 plain version

def _verify_inputs(rng, b, w, hq, hc, d, psize, m):
    """Pages, permuted tables and per-lane positions: row 0 a window that
    crosses a page boundary, the last row a one-token window whose other
    lanes are scratch lanes (q_pos at the last, scratch table column)."""
    num_pages = b * m + 1
    q = rng.normal(size=(b, w, hq, d))
    kp = rng.normal(size=(num_pages, psize, hc, d))
    vp = rng.normal(size=(num_pages, psize, hc, d))
    table = np.full((b, m), num_pages - 1, np.int32)
    table[:, :m - 1] = rng.permutation(num_pages - 1)[:b * (m - 1)] \
        .reshape(b, m - 1)
    start = rng.integers(0, (m - 1) * psize - w, b)
    start[0] = psize - 2                        # lanes cross a page
    q_pos = (start[:, None] + np.arange(w)[None]).astype(np.int32)
    q_pos[-1, 1:] = (m - 1) * psize             # scratch lanes
    return q, kp, vp, table, q_pos


@pytest.mark.parametrize("dt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("b,w,hq,hc,d,psize,m", [
    (3, 5, 4, 2, 64, 16, 5),     # gamma 4, rep 2 (full width's rep)
    (2, 3, 8, 2, 32, 8, 4),      # rep 4, small pages
    (2, 1, 4, 4, 64, 16, 3),     # W = 1, MHA
    (4, 8, 8, 1, 16, 4, 9),      # MQA, widest window, tiny pages
])
def test_spec_verify_plain_sweep(dt, b, w, hq, hc, d, psize, m):
    name, jdt, tdt = dt
    q, kp, vp, table, q_pos = _verify_inputs(np.random.default_rng(7), b, w,
                                             hq, hc, d, psize, m)
    qj, qt = _pair(q, jdt, tdt)
    kj, kt = _pair(kp, jdt, tdt)
    vj, vt = _pair(vp, jdt, tdt)
    tt, tq = torch.from_numpy(table), torch.from_numpy(q_pos)
    got = spec_verify_plain(qt, kt, vt, tt, tq)
    assert got.shape == (b, w, hq, d) and got.dtype == tdt
    want = jref.spec_verify_ref(qj, kj, vj, jnp.asarray(table),
                                jnp.asarray(q_pos))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    pallas = pallas_verify(qj, kj, vj, jnp.asarray(table),
                           jnp.asarray(q_pos), interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(name))
    # the model-layout wrapper takes the plain version on the CPU
    ops.reset_launches()
    np.testing.assert_array_equal(
        _np(ops.spec_verify(qt, kt, vt, tt, tq)), _np(got))
    assert ops.launch_counts()["spec_verify"] == 0


def test_window_causality_and_lane_equivalence():
    """Lane i sees keys 0..q_pos[b, i] only: it equals one-token paged
    attention at pos = q_pos[:, i], and keys past its position (the later
    drafts' K/V) do not move it."""
    rng = np.random.default_rng(3)
    b, w, hq, hc, d, psize, m = 2, 5, 8, 2, 32, 8, 4
    q, kp, vp, table, q_pos = (
        torch.from_numpy(np.asarray(x)) for x in
        _verify_inputs(rng, b, w, hq, hc, d, psize, m))
    q, kp, vp = q.float(), kp.float(), vp.float()
    out = spec_verify_plain(q, kp, vp, table, q_pos)
    for i in range(w):
        lane = paged_attention_plain(q[:, i].contiguous(), kp, vp, table,
                                     q_pos[:, i].contiguous())
        torch.testing.assert_close(out[:, i], lane, atol=2e-6, rtol=1e-5)
    # overwrite row 0's keys after its lane 1: lanes 0 and 1 do not move
    kp2, vp2 = kp.clone(), vp.clone()
    for k in range(int(q_pos[0, 1]) + 1, m * psize):
        page = int(table[0, k // psize])
        kp2[page, k % psize] = 9.0
        vp2[page, k % psize] = -9.0
    out2 = spec_verify_plain(q, kp2, vp2, table, q_pos)
    torch.testing.assert_close(out2[0, :2], out[0, :2], atol=0, rtol=0)
    assert not torch.allclose(out2[0, 2:], out[0, 2:])


def test_one_token_window_is_paged_attention():
    rng = np.random.default_rng(5)
    b, hq, hc, d, psize, m = 3, 8, 2, 64, 16, 5
    q, kp, vp, table, q_pos = (
        torch.from_numpy(np.asarray(x)) for x in
        _verify_inputs(rng, b, 1, hq, hc, d, psize, m))
    q, kp, vp = q.float(), kp.float(), vp.float()
    got = spec_verify_plain(q, kp, vp, table, q_pos)
    want = paged_attention_plain(q[:, 0].contiguous(), kp, vp, table,
                                 q_pos[:, 0].contiguous())
    assert torch.equal(got[:, 0], want)


def test_spec_verify_plain_masks_pages_outside_the_pool():
    """A page id outside [0, NP) masks its keys, as in the kernel and in
    ``paged_attention_plain``: every lane equals the one-token paged
    attention at its position on a table holding -1 and NP."""
    rng = np.random.default_rng(11)
    b, w, hq, hc, d, psize, m = 2, 4, 4, 2, 8, 4, 5
    num_pages = 9
    q = torch.from_numpy(rng.normal(size=(b, w, hq, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(
        size=(num_pages, psize, hc, d)).astype(np.float32)) for _ in "kv")
    table = torch.tensor([[2, num_pages, 5, 1, 8], [4, -1, 0, 3, 8]],
                         dtype=torch.int32)
    q_pos = torch.tensor([[3, 5, 9, 16], [2, 6, 13, 16]], dtype=torch.int32)
    got = spec_verify_plain(q, kp, vp, table, q_pos)
    assert bool(torch.isfinite(got).all())
    for i in range(w):
        lane = paged_attention_plain(q[:, i].contiguous(), kp, vp, table,
                                     q_pos[:, i].contiguous())
        torch.testing.assert_close(got[:, i], lane, atol=2e-6, rtol=1e-5)


def _reference_table(table, q_pos, num_pages, psize):
    """The same visible keys in the form repro's oracles take (they read
    every table entry): each row's in-pool pages moved to the front in
    order, padded with its last in-pool page, and each lane's position
    moved down past the pages dropped before it (a lane on a dropped page
    keeps the keys before that page). Attention is a function of the set
    of visible keys, so the output is the same."""
    b, m = table.shape
    ref_table = np.empty_like(table)
    ref_pos = np.empty_like(q_pos)
    for r in range(b):
        kept = [j for j in range(m) if 0 <= table[r, j] < num_pages]
        ids = [table[r, j] for j in kept]
        ref_table[r] = ids + [ids[-1]] * (m - len(ids))
        for i, p in enumerate(q_pos[r]):
            page = p // psize
            before = sum(j < page for j in kept)
            ref_pos[r, i] = (before * psize + p % psize if page in kept
                             else before * psize - 1)
    return ref_table, ref_pos


@pytest.mark.parametrize("dt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("shares", [1, 2, 3, 4, 5, 6, 7])
def test_spec_verify_warp_split_combines_to_plain(dt, shares):
    """The B3 kernel's arithmetic (B2's key walk with a position for each
    row): keys dealt to `shares` warps in tiles, each warp with its own
    (m, l, acc) per (lane, q head), combined at the end. Row 0's window
    crosses a page; row 1 is ragged (scratch lanes past its window); row
    2 a one-token window; rows 1 and 3 hold page ids outside the pool
    (-1, NP, -7) before their windows. Some shares lie wholly past a
    lane's position: they must add nothing and give no NaN."""
    name, jdt, tdt = dt
    rng = np.random.default_rng(12)
    b, w, hq, hc, d, psize, m, tile = 4, 5, 4, 2, 16, 4, 9, 4
    num_pages = b * (m - 1) + 1
    scratch = (m - 1) * psize
    table = np.full((b, m), num_pages - 1, np.int32)
    table[:, :m - 1] = rng.permutation(num_pages - 1).reshape(b, m - 1)
    table[1, 1] = -1
    table[3, 0] = num_pages
    table[3, 4] = -7
    q_pos = np.full((b, w), scratch, np.int32)
    for r, (start, live) in enumerate([(psize - 2, w), (13, 3), (6, 1),
                                       (21, w)]):
        q_pos[r, :live] = start + np.arange(live)
    qj, qt = _pair(rng.normal(size=(b, w, hq, d)), jdt, tdt)
    kj, kt = _pair(rng.normal(size=(num_pages, psize, hc, d)), jdt, tdt)
    vj, vt = _pair(rng.normal(size=(num_pages, psize, hc, d)), jdt, tdt)
    tt, tq = torch.from_numpy(table), torch.from_numpy(q_pos)
    pm, pl, pacc = split_partials_plain(qt, kt, vt, tt, tq, shares, tile)
    assert pm.shape == (shares, b, w, hq)
    assert pacc.shape == (shares, b, w, hq, d)
    empty = pl == 0
    if shares > 1:
        assert bool(empty.any())
    assert bool((pm[empty] == -1e30).all())
    assert bool((pacc[empty] == 0).all())
    got = combine_partials_plain(pm, pl, pacc, tdt)
    assert got.shape == (b, w, hq, d) and got.dtype == tdt
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(
        _np(got), _np(spec_verify_plain(qt, kt, vt, tt, tq)), **_tol(name))
    ref_table, ref_pos = (jnp.asarray(x) for x in _reference_table(
        table, q_pos, num_pages, psize))
    np.testing.assert_allclose(
        _np(got), _np(jref.spec_verify_ref(qj, kj, vj, ref_table, ref_pos)),
        **_tol(name))
    np.testing.assert_allclose(
        _np(got), _np(pallas_verify(qj, kj, vj, ref_table, ref_pos,
                                    interpret=True)), **_tol(name))


# ------------------------------------------------------------ fork API

def _pools(num_pages=12):
    jmodel = japi.build_model(japi.ModelSpec(arch=ARCH, reduced=True),
                              seq_len=64)
    tmodel = tapi.build_model(tapi.ModelSpec(arch=ARCH, reduced=True),
                              seq_len=64)
    kw = dict(num_slots=2, slot_len=64, page_size=8, num_pages=num_pages)
    return JPagePool(jmodel, **kw), TPagePool(tmodel, device="cpu", **kw)


def _state(pool):
    return {"tables": [list(t) for t in pool._tables],
            "tables_np": pool.tables_np.tolist(),
            "free_pages": list(pool._free_pages),
            "forks": {s: (list(f["pages"]), f["shared"])
                      for s, f in pool._forks.items()},
            "pos": pool.pos.tolist(),
            "counts": (pool.page_alloc_count, pool.page_release_count,
                       pool.peak_pages, pool.forked_rows,
                       pool.shared_pages),
            "stats": pool.cache_stats()}


def _grow(pool, slot, pos):
    pool.pos[slot] = pos
    assert pool.ensure_capacity(slot)


def _scenario(name, pool):
    """One of tests/test_spec_decode.py's fork sequences; returns the
    values its calls produced, in order."""
    out = []
    slot = pool.alloc()
    if name == "commit":
        _grow(pool, slot, 20)                  # 3 committed pages
        pool.fork_table(slot)
        out.append((pool.forked_rows, pool.shared_pages))
        out.append(pool.fork_extend(slot, 30))  # +1 fork-private page
        out.append(pool.fork_row(slot).tolist())
        pool.check_no_leaks()
        pool.commit_fork(slot, 23)             # accept into page 2 only
        out.append(int(pool.pos[slot]))
        pool.check_no_leaks()
        pool.release(slot)
    elif name == "rollback":
        _grow(pool, slot, 10)                  # 2 committed pages
        pool.fork_table(slot)
        out.append(pool.fork_extend(slot, 30))  # 2 private pages
        pool.release_fork(slot)
        pool.check_no_leaks()
        pool.release(slot)
    elif name == "release_live_fork":
        _grow(pool, slot, 10)
        pool.fork_table(slot)
        pool.fork_extend(slot, 30)
        pool.release(slot)                     # rolls the fork back first
        out.append(pool.forked_rows)
    elif name == "shrink":
        _grow(pool, slot, 20)                  # 3 of 4 pages committed
        pool.fork_table(slot)
        out.append(pool.fork_extend(slot, 60))  # covers only 4 * 8 - 1
        pool.release_fork(slot)
        pool.release(slot)
    elif name == "commit_across_pages":
        _grow(pool, slot, 15)                  # last slot of page 1
        pool.fork_table(slot)
        out.append(pool.fork_extend(slot, 19))
        pool.commit_fork(slot, 20)             # accepts into a new page
        out.append(len(pool._tables[slot]))
        pool.release(slot)
    pool.check_no_leaks()
    out.append(pool.pages_in_use)
    return out


@pytest.mark.parametrize("name,num_pages", [
    ("commit", 12), ("rollback", 12), ("release_live_fork", 12),
    ("shrink", 4), ("commit_across_pages", 12)])
def test_fork_api_matches_repro(name, num_pages):
    jpool, tpool = _pools(num_pages)
    assert _scenario(name, tpool) == _scenario(name, jpool)
    assert _state(tpool) == _state(jpool)
    assert tpool.pages_in_use == 0


def test_fork_api_rejects_and_catches_what_repro_does():
    for pool in _pools():
        slot = pool.alloc()
        _grow(pool, slot, 5)
        pool.fork_table(slot)
        with pytest.raises(RuntimeError, match="already has a live fork"):
            pool.fork_table(slot)
        pool.release_fork(slot)
        with pytest.raises(ValueError, match="not live"):
            pool.fork_table(1 - slot)
        pool.release(slot)
    for pool in _pools():                     # rigged refcount mismatch
        slot = pool.alloc()
        _grow(pool, slot, 20)
        pool.fork_table(slot)
        pool._free_pages.append(pool._tables[slot].pop())
        pool.page_release_count += 1
        with pytest.raises(RuntimeError, match="refcount"):
            pool.check_no_leaks()
    for pool in _pools():                     # rigged counter imbalance
        slot = pool.alloc()
        _grow(pool, slot, 5)
        pool.page_alloc_count += 1
        with pytest.raises(RuntimeError, match="counters out of balance"):
            pool.check_no_leaks()
    for pool in _pools():             # a private page in a main table
        slot = pool.alloc()
        _grow(pool, slot, 5)
        pool.fork_table(slot)
        pool.fork_extend(slot, 12)
        pool._tables[1 - slot].append(pool._forks[slot]["pages"][-1])
        with pytest.raises(RuntimeError):
            pool.check_no_leaks()


# ----------------------------------------------------- the verify step

def test_decode_window_paged_matches_repro():
    """Prefill two rows into permuted pages, then verify windows of 4
    tokens (one row's window crossing a page, the other with two scratch
    lanes), as repro's decode_window_paged does."""
    jm = japi.build_model(japi.ModelSpec(arch=ARCH, reduced=True))
    tm = tapi.build_model(tapi.ModelSpec(arch=ARCH, reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.device_get(jp), "cpu")
    psize, m, num_pages = 8, 6, 14
    toks = np.random.default_rng(1).integers(0, 512, (2, 14)).astype(
        np.int32)
    _, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=16)
    ids = np.random.default_rng(2).permutation(num_pages)
    table = np.full((2, m + 1), num_pages, np.int32)
    table[0, :3], table[1, :2] = ids[:3], ids[3:5]
    jbuf = jm.init_cache(num_pages + 1, psize)
    tbuf = tm.init_cache(num_pages + 1, psize, device="cpu")
    for side in ("client", "server"):
        for kv in ("k", "v"):
            for row in range(2):
                src = np.asarray(jc[side][kv])[:, row]
                pages = src.reshape(src.shape[0], 2, psize, *src.shape[2:])
                jbuf[side][kv] = jbuf[side][kv].at[:, table[row, :2]].set(
                    pages)
                tbuf[side][kv][:, torch.from_numpy(table[row, :2]).long()] \
                    = torch.tensor(pages)
    win = np.array([[7, 8, 9, 10], [11, 12, 0, 0]], np.int32)
    q_pos = np.array([[14, 15, 16, 17], [14, 15, m * psize, m * psize]],
                     np.int32)
    jl, _ = jax.jit(jm.decode_window_paged)(
        jp, jbuf, jnp.asarray(win), jnp.asarray(q_pos), jnp.asarray(table))
    tl, tbuf2 = tm.decode_window_paged(tp, tbuf, torch.from_numpy(win),
                                       torch.from_numpy(q_pos),
                                       torch.from_numpy(table))
    assert tbuf2 is tbuf                      # written in place
    np.testing.assert_allclose(_np(tl[0]), np.asarray(jl[0]), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(_np(tl[1, :2]), np.asarray(jl[1, :2]),
                               atol=1e-4, rtol=0)


# ----------------------------------------------------- the engine

def _spec(pkg, engine="speculative", workload=None, cache=None, draft=None,
          num_slots=4, slot_len=64, budget=4, **adm):
    return pkg.ServeSpec(
        model=pkg.ModelSpec(arch=ARCH, reduced=True),
        engine=pkg.EngineSpec(name=engine, num_slots=num_slots,
                              slot_len=slot_len),
        admission=pkg.AdmissionSpec(token_budget=budget, **adm),
        scheduler=pkg.SchedulerSpec(policy="fifo"),
        workload=workload or pkg.WorkloadSpec(
            num_requests=10, prompt_lens=[5, 9, 17, 33],
            max_new_tokens=[4, 12, 20]),
        clock=pkg.ClockSpec(kind="virtual"),
        cache=cache or pkg.CacheSpec(page_size=16),
        draft=draft or pkg.DraftSpec(num_layers=1, gamma=4))


@pytest.fixture(scope="module")
def jax_params():
    return japi.build_serve_context(_spec(japi, engine="paged")).params


def _tokens(report):
    return {r["rid"]: r["tokens"] for r in report.per_request}


def _serve_both(jax_params, draft_params=False, **kw):
    """Serve one spec through repro and through the port (bridged params;
    with ``draft_params`` the separate-arch draft's params are bridged
    too, so acceptance is comparable). Each keyword is a function of the
    package (``repro.api`` or ``repro_torch.api``) giving a spec argument.
    """
    jspec, tspec = (_spec(pkg, **{k: f(pkg) for k, f in kw.items()})
                    for pkg in (japi, tapi))
    assert jspec.to_dict() == tspec.to_dict()
    jctx = japi.build_serve_context(jspec, params=jax_params)
    tctx = tapi.build_serve_context(
        tspec, params=from_numpy_tree(jax.device_get(jax_params), "cpu"),
        device="cpu")
    if draft_params:
        tctx.engine._draft_params = from_numpy_tree(
            jax.device_get(jctx.engine._draft_params), "cpu")
    jrep = japi.run_serve(jspec, ctx=jctx)
    trep = tapi.run_serve(tspec, ctx=tctx)
    return jrep, trep, tctx


def _port_run(tctx, **kw):
    """The port alone, on the bridged params of ``tctx``."""
    spec = _spec(tapi, **{k: f(tapi) for k, f in kw.items()})
    ctx = tapi.build_serve_context(spec, params=tctx.params, device="cpu")
    return tapi.run_serve(spec, ctx=ctx), ctx


COUNTED = ("steps", "decode_tokens", "prefill_tokens", "max_active",
           "step_active", "num_requests", "preemptions")
GROW = dict(workload=lambda p: p.WorkloadSpec(
    num_requests=8, prompt_lens=[5], max_new_tokens=[40]))


def _assert_same(jrep, trep, tctx):
    assert trep.engine == jrep.engine
    assert _tokens(trep) == _tokens(jrep)
    for field in COUNTED:
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.speculation == jrep.speculation
    assert trep.cache_utilization == jrep.cache_utilization
    tctx.engine.pool.check_no_leaks()
    assert tctx.engine.pool.pages_in_use == 0


@pytest.mark.parametrize("draft", ["layers", "arch"])
def test_speculative_engine_matches_repro(jax_params, draft):
    """Both draft sources: tokens, counts, speculation counters and KV
    accounting equal repro's; tokens equal the port's paged engine."""
    mk = ((lambda p: p.DraftSpec(num_layers=1, gamma=4))
          if draft == "layers" else
          (lambda p: p.DraftSpec(arch=ARCH, gamma=2, seed=3)))
    jrep, trep, tctx = _serve_both(jax_params, draft_params=True, draft=mk)
    _assert_same(jrep, trep, tctx)
    assert trep.speculation["draft"] == (
        "layers:1" if draft == "layers" else f"arch:{ARCH}")
    assert trep.speculation["windows"] > 0
    paged, _ = _port_run(tctx, engine=lambda p: "paged")
    assert _tokens(paged) == _tokens(trep)


def test_eviction_mid_window_matches_repro(jax_params):
    """A pool too small for the steady state forces evictions while draft
    windows are in flight: the fork rolls back with the victim and the
    resumed request replays the same tokens."""
    cache = dict(cache=lambda p: p.CacheSpec(page_size=8, num_pages=12))
    jrep, trep, tctx = _serve_both(jax_params, **GROW, **cache)
    assert trep.preemptions == jrep.preemptions > 0
    _assert_same(jrep, trep, tctx)
    paged, _ = _port_run(tctx, engine=lambda p: "paged", **GROW)
    assert _tokens(paged) == _tokens(trep)


def test_tenant_preemption_leaks_no_pages(jax_params):
    """Scheduler-driven tenant preemption on the speculative engine: a
    preempted row's live fork rolls back and every page comes home."""
    kw = dict(
        workload=lambda p: p.WorkloadSpec(
            num_requests=12, prompt_lens=[5, 9, 17], max_new_tokens=[6, 18],
            tenant_mix={"gold": 1.0, "bronze": 1.0}),
        policy=lambda p: "tenant", preempt=lambda p: True,
        tenants=lambda p: [p.TenantSpec(name="gold", share=3.0, priority=1),
                           p.TenantSpec(name="bronze", share=1.0)])
    jrep, trep, tctx = _serve_both(jax_params, **kw)
    _assert_same(jrep, trep, tctx)
    cont, _ = _port_run(tctx, engine=lambda p: "continuous", **kw)
    assert _tokens(cont) == _tokens(trep)


def test_self_draft_accepts_every_window(jax_params):
    """A draft with every target layer is the target: every proposal is
    accepted, and each window emits more than one token."""
    tp = from_numpy_tree(jax.device_get(jax_params), "cpu")
    depth = tapi.build_model(tapi.ModelSpec(arch=ARCH,
                                            reduced=True)).cfg.num_layers
    spec = _spec(tapi, draft=tapi.DraftSpec(num_layers=depth, gamma=3))
    ctx = tapi.build_serve_context(spec, params=tp, device="cpu")
    rep = tapi.run_serve(spec, ctx=ctx)
    s = rep.speculation
    assert s["draft"] == f"layers:{depth}"
    assert s["acceptance_rate"] == 1.0 and s["proposed"] == s["accepted"] > 0
    assert s["tokens_per_step"] > 1.0
    ctx.engine.pool.check_no_leaks()


def test_stream_and_verify_through_speculative_bursts():
    spec = _spec(tapi).replace(stream=tapi.StreamSpec(enabled=True),
                               report=tapi.ReportSpec(verify=-1))
    report = tapi.run_serve(spec, device="cpu")
    assert report.verified["checked"] == 10
    assert report.stream["mismatches"] == []
    assert report.to_json()["speculation"]["windows"] > 0


def test_speculative_rejects_what_repro_rejects(jax_params):
    tp = from_numpy_tree(jax.device_get(jax_params), "cpu")
    with pytest.raises(tapi.SpecError, match="draft source"):
        _spec(tapi, draft=tapi.DraftSpec()).validate()
    bad = _spec(tapi, draft=tapi.DraftSpec(arch="falcon-mamba-7b", gamma=2))
    with pytest.raises((ValueError, NotImplementedError)):
        tapi.build_serve_context(bad, params=tp, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        tapi.build_serve_context(
            _spec(tapi, draft=tapi.DraftSpec(num_layers=9)), params=tp,
            device="cpu")


def test_serve_cli_maps_the_speculative_flags(capsys):
    serve_cli.main(["--speculative", "--draft-layers", "4", "--gamma", "3",
                    "--no-reduced", "--print-spec"])
    spec = tapi.ServeSpec.from_json(capsys.readouterr().out)
    assert spec.engine.name == "speculative"
    assert spec.draft.num_layers == 4 and spec.draft.gamma == 3
    assert spec.model.reduced is False
    serve_cli.main(["--speculative", "--draft-arch", ARCH, "--print-spec"])
    spec = tapi.ServeSpec.from_json(capsys.readouterr().out)
    assert spec.draft.arch == ARCH and spec.draft.num_layers is None
    serve_cli.main(["--device", "cpu", "--speculative", "--draft-layers",
                    "1", "--gamma", "3", "--verify", "-1"])
    out = capsys.readouterr().out
    assert "[speculative] 8 requests" in out
    assert "speculation: draft layers:1 gamma 3" in out
    assert "verified token-identical: 8 requests" in out
