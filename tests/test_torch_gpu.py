"""The port's CUDA kernels and engines on the card (marker ``gpu``).

These tests need a CUDA card and skip without one; they import only torch
and repro_torch, so they run on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain version on the same inputs: float32
at atol 2e-5 (sums in another order; 2e-4 for the cross-entropy values,
sums over the whole vocab), bfloat16 at atol/rtol 2e-2 (one rounding of
the output; sums in another order; fp16 alike). The selective scan (fp32 outputs in
every case) is held at SCAN_TOL: both compute the same unfused fp32
products in the same order, y summed over the states in the kernel's
order (``sum_states``).
"""
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.spec_verify import spec_verify_plain
from repro_torch.kernels.ssm_scan import ssm_scan_plain

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
       torch.float16: dict(atol=2e-2, rtol=2e-2)}
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", [
    (1, 100, 32, 8, 64, True, None),    # serving prefill, ragged S
    (2, 37, 8, 2, 16, True, None),      # reduced head_dim
    (2, 130, 4, 4, 128, True, 48),      # sliding window, widest head
    (1, 70, 8, 1, 32, False, None),     # MQA, non-causal
    (1, 100, 32, 32, 80, True, None),   # zamba2's shared attention, MHA
])
def test_flash_attention_kernel_matches_plain(dev, dtype, b, s, hq, hkv, d,
                                              causal, window):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (b, s, hq, d), dtype, dev)
    k = _randn(gen, (b, s, hkv, d), dtype, dev)
    v = _randn(gen, (b, s, hkv, d), dtype, dev)
    before = ops.attention.launches
    got = ops.attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window).transpose(1, 2)
    torch.cuda.synchronize()
    assert ops.attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hc,d,psize,m", [
    (8, 32, 16, 64, 16, 8),     # full-width granite decode, kv_repeat 2
    (2, 16, 4, 16, 7, 6),       # odd page size, reduced head_dim
    (4, 8, 1, 32, 16, 3),       # MQA
])
def test_paged_attention_kernel_matches_plain(dev, dtype, b, hq, hc, d,
                                              psize, m):
    gen = torch.Generator(device=dev).manual_seed(1)
    num_pages = b * m + 1
    q = _randn(gen, (b, hq, d), dtype, dev)
    kp = _randn(gen, (num_pages, psize, hc, d), dtype, dev)
    vp = _randn(gen, (num_pages, psize, hc, d), dtype, dev)
    table = torch.randperm(num_pages, generator=gen, device=dev)[
        :b * m].reshape(b, m).to(torch.int32)
    pos = torch.randint(0, m * psize, (b,), generator=gen,
                        device=dev).to(torch.int32)
    pos[0], pos[-1] = psize // 2, 0
    got = ops.paged_attention(q, kp, vp, table, pos)
    want = paged_attention_plain(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _paged_walk_case(gen, dev, dtype, hq, hc, d, psize, m, pos):
    """Rows of the given positions over a pool of one page a table entry
    (plus the scratch page), tables permuted."""
    b = len(pos)
    num_pages = b * m + 1
    q = _randn(gen, (b, hq, d), dtype, dev)
    kp = _randn(gen, (num_pages, psize, hc, d), dtype, dev)
    vp = _randn(gen, (num_pages, psize, hc, d), dtype, dev)
    table = torch.randperm(num_pages, generator=gen, device=dev)[
        :b * m].reshape(b, m).to(torch.int32)
    return q, kp, vp, table, torch.tensor(pos, dtype=torch.int32,
                                          device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rep", [1, 2, 4, 8, 16])
def test_paged_attention_kernel_walks_and_groups(dev, dtype, rep):
    """Walks of 1, 31, 32 and 33 keys (one tile, its edge, two tiles), pos
    on the last slot of the last page of a 64-page table (a walk of 1024
    keys: every warp several tiles), and a row whose table holds page ids
    outside the pool (masked keys), at every group size."""
    gen = torch.Generator(device=dev).manual_seed(11)
    psize, m = 16, 64
    q, kp, vp, table, pos = _paged_walk_case(
        gen, dev, dtype, 2 * rep, 2, 64, psize, m,
        [0, 30, 31, 32, m * psize - 1, 500])
    table[5, 3] = kp.shape[0]            # past the pool
    table[5, 10] = -5
    before = ops.paged_attention.launches
    got = ops.paged_attention(q, kp, vp, table, pos)
    want = paged_attention_plain(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [8, 40, 128])
def test_paged_attention_kernel_head_dims(dev, dtype, d):
    """The narrowest, an odd number of 16-byte vectors, and the widest
    head_dim; a page size that does not divide the 32-key tile."""
    gen = torch.Generator(device=dev).manual_seed(12)
    q, kp, vp, table, pos = _paged_walk_case(
        gen, dev, dtype, 6, 2, d, 7, 20, [0, 6, 7, 70, 139])
    got = ops.paged_attention(q, kp, vp, table, pos)
    want = paged_attention_plain(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_paged_attention_refuses_misaligned_pages(dev):
    """The kernel copies 16-byte vectors: pages that do not start on a
    16-byte boundary are refused, not read."""
    pages = torch.zeros((3 * 4 * 2 * 8 + 1,), device=dev)[1:].reshape(
        3, 4, 2, 8)
    q = torch.zeros((1, 4, 8), device=dev)
    with pytest.raises(ValueError, match="aligned"):
        ops.paged_attention(q, pages, pages,
                            torch.zeros((1, 2), dtype=torch.int32, device=dev),
                            torch.zeros((1,), dtype=torch.int32, device=dev))


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((1, 8, 2, 24), device=dev)          # head_dim 24 ok
    ops.attention(q, q, q)
    bad = torch.zeros((1, 8, 2, 136), device=dev)       # wider than 128
    with pytest.raises(ValueError, match="head_dim"):
        ops.attention(bad, bad, bad)
    # B2 and B3 take raw pointers without strides and trust B and M: a
    # strided q, a pos or q_pos of the wrong shape and a short page table
    # are refused, at a head_dim the kernel takes and at a padded one
    for d in (24, 20):
        gen = torch.Generator(device=dev).manual_seed(13)
        q, kp, vp, table, pos = _paged_walk_case(
            gen, dev, torch.float32, 4, 2, d, 8, 3, [5, 17])
        qw = q[:, None].expand(2, 2, 4, d).contiguous()
        q_pos = torch.stack([pos - 1, pos], dim=1)
        ops.paged_attention(q, kp, vp, table, pos)
        ops.spec_verify(qw, kp, vp, table, q_pos)
        for op, qq, rows in ((ops.paged_attention, q, pos),
                             (ops.spec_verify, qw, q_pos)):
            strided = qq.transpose(0, 1).contiguous().transpose(0, 1)
            for match, args in (("contiguous", (strided, table, rows)),
                                ("shapes", (qq, table, rows[:, :1]
                                            if rows.dim() == 2
                                            else rows[:, None])),
                                ("shapes", (qq, table[:1], rows))):
                with pytest.raises(ValueError, match=match):
                    op(args[0], kp, vp, args[1], args[2])


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_reduced_serve_on_the_card_matches_reference(dev, engine):
    """Float32 reduced granite served on the card: every request equals
    single-request decoding on the card, and the kernels ran."""
    spec = api.ServeSpec(
        model=api.ModelSpec(arch="granite-3-2b", reduced=True),
        engine=api.EngineSpec(name=engine),
        workload=api.WorkloadSpec(num_requests=6, prompt_lens=[5, 17, 33],
                                  max_new_tokens=[4, 9]),
        clock=api.ClockSpec(kind="virtual"),
        cache=api.CacheSpec(page_size=8),
        report=api.ReportSpec(verify=-1))
    ops.reset_launches()
    report = api.run_serve(spec)
    assert report.verified["checked"] == 6
    counts = ops.launch_counts()
    assert counts["flash_attention"] > 0
    assert (counts["paged_attention"] > 0) == (engine == "paged")


# --- training kernels (B5 forward/backward, B1 backward) -------------------

def _xent_inputs(gen, t, d, v, dtype, dev):
    h = _randn(gen, (t, d), dtype, dev)
    w = (torch.randn((d, v), generator=gen, device=dev) / d ** 0.5).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, device=dev,
                           dtype=torch.int32)
    return h, w, labels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,v", [
    (64, 32, 512),          # tile multiples
    (37, 24, 509),          # ragged tokens and vocab (509 is prime)
    (130, 64, 4099),        # several vocab splits, one backward chunk
    (2048, 32, 8300),       # two backward chunks, the second ragged
    (1024, 384, 51865),     # whisper-tiny's loss (8 x 128 tokens)
])
def test_cross_entropy_kernels_match_plain(dev, dtype, t, d, v):
    from repro_torch.kernels.cross_entropy import (cross_entropy_bwd_plain,
                                                   cross_entropy_fwd_plain)
    gen = torch.Generator(device=dev).manual_seed(2)
    h, w, labels = _xent_inputs(gen, t, d, v, dtype, dev)
    before = dict(ops.launch_counts())
    nll, lse, correct = ops.cross_entropy(h, w, labels)
    pnll, plse, pcorrect = cross_entropy_fwd_plain(h, w, labels)
    g = torch.rand((t,), generator=gen, device=dev)
    dh, dw = ops.cross_entropy_bwd(h, w, labels, lse, g)
    pdh, pdw = cross_entropy_bwd_plain(h, w, labels, plse, g)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["cross_entropy"] == before["cross_entropy"] + 1
    assert counts["cross_entropy_bwd"] == before["cross_entropy_bwd"] + 1
    tol = dict(atol=2e-4, rtol=1e-4)     # fp32 sums in another order
    torch.testing.assert_close(nll, pnll, **tol)
    torch.testing.assert_close(lse, plse, **tol)
    # the kernel's argmax may differ from the plain one only where two
    # logits tie within the products' rounding
    assert (correct == pcorrect).float().mean() >= 0.97
    assert dh.dtype == dtype and dw.dtype == dtype
    torch.testing.assert_close(dh.float(), pdh.float(), **TOL[dtype])
    torch.testing.assert_close(dw.float(), pdw.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,v,slices", [
    (64, 32, 512, 2),       # tile multiples
    (37, 24, 4098, 2),      # ragged tokens, odd slices (W's padded copy)
    (130, 64, 4100, 4),     # several vocab splits a slice
    (2048, 128, 16384, 2),  # two backward chunks a slice
])
def test_vocab_parallel_partials_and_sliced_bwd_match_plain(dev, dtype, t, d,
                                                            v, slices):
    """The vocab-parallel B5 (``ops.cross_entropy_partials``) on each slice
    of W against its plain version, the slices combined against the
    whole-vocab plain forward, and B5-bwd on each slice with -1 labels
    against its plain version, at the tolerances above."""
    from repro_torch.kernels.cross_entropy import (
        PART_INDEX, combine_partials, cross_entropy_bwd_plain,
        cross_entropy_fwd_plain, cross_entropy_partials_plain)
    gen = torch.Generator(device=dev).manual_seed(3)
    h, w, labels = _xent_inputs(gen, t, d, v, dtype, dev)
    g = torch.rand((t,), generator=gen, device=dev)
    pnll, plse, pcorrect = cross_entropy_fwd_plain(h, w, labels)
    n = v // slices
    tol = dict(atol=2e-4, rtol=1e-4)     # fp32 sums in another order
    before = dict(ops.launch_counts())
    parts = []
    for r in range(slices):
        wr = w[:, r * n:(r + 1) * n].contiguous()
        local = torch.where((labels >= r * n) & (labels < (r + 1) * n),
                            labels - r * n, torch.full_like(labels, -1))
        got = ops.cross_entropy_partials(h, wr, local, r * n)
        want = cross_entropy_partials_plain(h, wr, local, r * n)
        keep = [p for p in range(5) if p != PART_INDEX]
        torch.testing.assert_close(got[keep], want[keep], **tol)
        assert (got[PART_INDEX] == want[PART_INDEX]).float().mean() >= 0.97
        parts.append(got)
        dh, dw = ops.cross_entropy_bwd(h, wr, local, plse, g)
        pdh, pdw = cross_entropy_bwd_plain(h, wr, local, plse, g)
        assert dh.dtype == dtype and dw.dtype == dtype
        torch.testing.assert_close(dh.float(), pdh.float(), **TOL[dtype])
        torch.testing.assert_close(dw.float(), pdw.float(), **TOL[dtype])
        # the unrounded dh the vocab-parallel backward sums over ranks
        dh32, _ = ops.cross_entropy_bwd(h, wr, local, plse, g, dh_fp32=True)
        pdh32, _ = cross_entropy_bwd_plain(h, wr, local, plse, g,
                                           dh_fp32=True)
        assert dh32.dtype == torch.float32
        torch.testing.assert_close(dh32, pdh32, **TOL[dtype])
        torch.testing.assert_close(dh32.to(dtype), dh)
    nll, lse, correct = combine_partials(torch.stack(parts), labels)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["cross_entropy_partials"] == \
        before["cross_entropy_partials"] + slices
    assert counts["cross_entropy_bwd"] == \
        before["cross_entropy_bwd"] + 2 * slices
    torch.testing.assert_close(nll, pnll, **tol)
    torch.testing.assert_close(lse, plse, **tol)
    assert (correct == pcorrect).float().mean() >= 0.97


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,window", [
    (2, 32, 4, 4, 16, None),     # rep 1
    (2, 50, 8, 2, 16, None),     # rep 4, ragged S
    (1, 100, 8, 2, 64, 24),      # sliding window
    (1, 40, 4, 1, 128, None),    # widest head, MQA
])
def test_flash_attention_backward_kernel_matches_plain(dev, dtype, b, s, hq,
                                                       hkv, d, window):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain)
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _randn(gen, (b, s, hq, d), dtype, dev).requires_grad_(True)
    k = _randn(gen, (b, s, hkv, d), dtype, dev).requires_grad_(True)
    v = _randn(gen, (b, s, hkv, d), dtype, dev).requires_grad_(True)
    do = _randn(gen, (b, s, hq, d), dtype, dev)
    before = ops.attention_bwd.launches
    out = ops.attention(q, k, v, causal=True, window=window)
    assert out.grad_fn is not None        # the silent-gradient hazard
    grads = torch.autograd.grad(out, (q, k, v), grad_outputs=do)
    torch.cuda.synchronize()
    assert ops.attention_bwd.launches == before + 1
    qt, kt, vt, ot, dot = (x.detach().transpose(1, 2)
                           for x in (q, k, v, out, do))
    _, lse = flash_attention_plain(qt, kt, vt, causal=True, window=window,
                                   with_lse=True)
    want = flash_attention_bwd_plain(qt, kt, vt, ot, dot, lse,
                                     causal=True, window=window)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.float(), w.transpose(1, 2).float(),
                                   **TOL[dtype])


def test_reduced_train_step_on_the_card(dev):
    """One fused step of float32 reduced granite on the card: finite
    metrics, every training kernel launched."""
    import numpy as np
    from repro_torch.api.protocols import lm_plan_batches
    from repro_torch.configs import get_config
    from repro_torch.core.sampling import make_plan
    from repro_torch.data.federated import build_lm_client_store
    from repro_torch.launch.distributed import ShardedPSLEngine
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    model = build_model(get_config("granite-3-2b", reduced=True))
    data, pop = build_lm_client_store(512, 8, 128, 32, seed=0)
    plan = make_plan("ugs", pop, 8, seed=0)
    host = next(iter(lm_plan_batches(data, pop, plan, 32, "global_mean",
                                     np.zeros(8, np.int64))))
    engine = ShardedPSLEngine(model, adamw(1e-3), device=dev)
    state = engine.init_state(0)
    ops.reset_launches()
    state, metrics = engine.step(state, engine.put_batch(host))
    counts = ops.launch_counts()
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert metrics["tokens"] == 8 * 32 and state.step == 1
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 2
    assert counts["cross_entropy"] == counts["cross_entropy_bwd"] == 1


# --- serving kernels of slice 3 (B3 spec-verify, B4 selective scan) --------

def _verify_case(gen, dev, dtype, b, w, hq, hc, d, psize, m, wlens,
                 starts=None):
    """Pages, permuted tables with an always-scratch last column, and
    per-lane positions: row r's window has wlens[r] + 1 live lanes from
    starts[r] (by default random, row 0 two keys before a page boundary);
    the other lanes point at the scratch column, as the engine builds
    them."""
    num_pages = b * (m - 1) + 1
    q = _randn(gen, (b, w, hq, d), dtype, dev)
    kp = _randn(gen, (num_pages, psize, hc, d), dtype, dev)
    vp = _randn(gen, (num_pages, psize, hc, d), dtype, dev)
    table = torch.full((b, m), num_pages - 1, dtype=torch.int32, device=dev)
    table[:, :m - 1] = torch.randperm(num_pages - 1, generator=gen,
                                      device=dev).reshape(b, m - 1)
    scratch = (m - 1) * psize
    q_pos = torch.full((b, w), scratch, dtype=torch.int32, device=dev)
    if starts is None:
        starts = torch.randint(0, scratch - w, (b,), generator=gen,
                               device=dev)
        starts[0] = psize - 2
    for r in range(b):
        n = wlens[r] + 1
        q_pos[r, :n] = int(starts[r]) + torch.arange(n, device=dev)
    return q, kp, vp, table, q_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,w,hq,hc,d,psize,m,wlens,starts,bad_ids", [
    (8, 5, 32, 16, 64, 16, 9, [4] * 8, None, False),  # full-width verify
    (4, 5, 32, 16, 64, 16, 9, [4, 2, 0, 3], None, False),  # ragged windows
    (3, 8, 8, 2, 32, 4, 12, [7, 1, 5], None, False),  # 2 row groups, tiny pages
    (2, 16, 16, 1, 128, 7, 8, [15, 9], None, False),  # widest: 16 groups
    (2, 3, 8, 8, 16, 16, 4, [2, 2], None, False),     # rep 1, small head_dim
    (2, 8, 4, 2, 64, 16, 9, [7, 3], None, False),     # exactly 16 rows a group
    (2, 10, 4, 2, 64, 16, 9, [9, 4], None, False),    # 20 rows: two groups
    (2, 5, 32, 16, 64, 16, 17, [4, 4], [200, 130], False),  # 7 tiles of 32
    (3, 5, 32, 16, 64, 16, 9, [4, 4, 2], [30, 60, 90], True),  # ids off pool
    (2, 4, 8, 2, 40, 16, 9, [3, 1], None, False),     # D an odd number of 8s
    (8, 5, 32, 8, 128, 16, 9, [4] * 8, None, False),  # llama3-8b, group 4
    (8, 5, 32, 16, 128, 16, 9, [4] * 8, None, False),  # its cache heads
])
def test_spec_verify_kernel_matches_plain(dev, dtype, b, w, hq, hc, d, psize,
                                          m, wlens, starts, bad_ids):
    gen = torch.Generator(device=dev).manual_seed(4)
    q, kp, vp, table, q_pos = _verify_case(gen, dev, dtype, b, w, hq, hc, d,
                                           psize, m, wlens, starts)
    if bad_ids:                          # past the pool, and negative
        table[0, 1] = kp.shape[0]
        table[1, 0] = -1
        table[2, 3] = -7
    before = ops.spec_verify.launches
    got = ops.spec_verify(q, kp, vp, table, q_pos)
    want = spec_verify_plain(q, kp, vp, table, q_pos)
    torch.cuda.synchronize()
    assert ops.spec_verify.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("top_p", [None, 0.9])
def test_sampler_on_the_card_matches_the_cpu(dev, top_p):
    """The seeded sampler (temperature 0.9, top-k 50, seed 7) on the card
    against itself on the CPU on the copied logits at llama3-8b's V: the
    same keys and bits; a token may differ only where the two picks'
    perturbed scores tie within 4 float32 ulps (the card's and the CPU's
    ``log`` round apart)."""
    import numpy as np
    from repro_torch.runtime.sampling import TokenSampler, perturbed_scores
    sampler = TokenSampler(api.SamplingSpec(method="sample", temperature=0.9,
                                            top_k=50, top_p=top_p, seed=7))
    gen = torch.Generator().manual_seed(8)
    logits = 3.0 * torch.randn((64, 128256), generator=gen)
    rids = torch.arange(64, dtype=torch.int32) % 7
    idxs = torch.arange(64, dtype=torch.int32)
    card = sampler.sample(logits.to(dev), rids.to(dev), idxs.to(dev)).cpu()
    scores = perturbed_scores(logits, rids, idxs, temperature=0.9, top_k=50,
                              top_p=top_p, seed=7)
    host = torch.argmax(scores, dim=-1).to(torch.int32)
    for r in torch.nonzero(card != host).flatten().tolist():
        a, b = float(scores[r, card[r]]), float(scores[r, host[r]])
        assert b - a <= 4 * np.spacing(np.float32(max(abs(a), abs(b))))
    assert (card == host).float().mean() > 0.9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_token_verify_equals_the_paged_kernel(dev, dtype):
    """W = 1 computes B2's function by B2's arithmetic (the same key walk,
    tiles, dot order, online softmax and combine): B3 equals B2 bitwise,
    and each agrees with the plain paged attention."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q, kp, vp, table, q_pos = _verify_case(gen, dev, dtype, 8, 1, 32, 16,
                                           64, 16, 9, [0] * 8)
    got = ops.spec_verify(q, kp, vp, table, q_pos)[:, 0]
    args = (q[:, 0].contiguous(), kp, vp, table, q_pos[:, 0].contiguous())
    b2 = ops.paged_attention(*args)
    plain = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, b2)
    torch.testing.assert_close(got.float(), plain.float(), **TOL[dtype])
    torch.testing.assert_close(b2.float(), plain.float(), **TOL[dtype])


def test_spec_verify_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 17, 4, 16), device=dev)            # W > 16
    pages = torch.zeros((3, 4, 2, 16), device=dev)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="window"):
        ops.spec_verify(q, pages, pages, table,
                        torch.zeros((1, 17), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="int32"):
        ops.spec_verify(q[:, :2].contiguous(), pages, pages, table,
                        torch.zeros((1, 2), dtype=torch.int64, device=dev))
    odd = torch.zeros((3 * 4 * 2 * 16 + 1,), device=dev)[1:].reshape(
        3, 4, 2, 16)                    # pages off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        ops.spec_verify(q[:, :2].contiguous(), odd, odd, table,
                        torch.zeros((1, 2), dtype=torch.int32, device=dev))


def _scan_case(gen, dev, dtype, b, l, d, n):
    x = _randn(gen, (b, l, d), dtype, dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, d), generator=gen, device=dev) - 1.0)
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev,
                                          dtype=torch.float32))
                   .expand(d, n) + 0.1 * torch.randn(
                       (d, n), generator=gen, device=dev))
    bm = _randn(gen, (b, l, n), dtype, dev)
    cm = _randn(gen, (b, l, n), dtype, dev)
    return x, dt, a.contiguous(), bm, cm


@pytest.mark.parametrize("dtype,b,l,d,n", [
    (torch.bfloat16, 8, 100, 8192, 16),     # full-width falcon-mamba prefill
    (torch.float32, 3, 37, 200, 16),        # ragged L and D tile
    (torch.float32, 2, 33, 256, 8),         # reduced N, L past one chunk
    (torch.float32, 1, 5, 130, 5),          # N not a power of two
    (torch.bfloat16, 2, 40, 128, 64),       # widest state
    (torch.bfloat16, 1, 100, 8192, 16),     # the ssm run's prefills: B = 1
    (torch.bfloat16, 4, 32, 8192, 16),      # ... and B = 4
    (torch.float16, 2, 45, 100, 16),        # D % 8 != 0: 4-byte copies
    (torch.bfloat16, 1, 17, 72, 5),         # N < its tier, 16-bit B and C
    (torch.float32, 2, 33, 36, 64),         # 8-channel tiles, ragged D
    (torch.bfloat16, 16, 128, 4096, 16),    # a rank's channels, tp 1x2
    (torch.float32, 16, 128, 4096, 16),     # ... in fp32
])
def test_ssm_scan_kernel_matches_plain(dev, dtype, b, l, d, n):
    gen = torch.Generator(device=dev).manual_seed(6)
    x, dt, a, bm, cm = _scan_case(gen, dev, dtype, b, l, d, n)
    before = ops.selective_scan.launches
    y, h = ops.selective_scan(x, dt, a, bm, cm)
    py, ph = ssm_scan_plain(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches == before + 1
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, py, **SCAN_TOL)
    torch.testing.assert_close(h, ph, **SCAN_TOL)


def test_selective_scan_raises_under_grad_on_the_card(dev):
    """Under grad on the card the scan goes through SelectiveScan: B4
    forward, then B4-bwd in the backward, whose gradients equal autograd
    through the plain version (fp32, SCAN_BWD limits); under no_grad it
    launches B4 alone and carries no grad_fn; what the kernels do not
    take still raises."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x, dt, a, bm, cm = _scan_case(gen, dev, torch.float32, 1, 8, 128, 8)
    dy = torch.randn(x.shape, generator=gen, device=dev)
    ins = [t.requires_grad_(True) for t in (x, dt, a, bm, cm)]
    ops.reset_launches()
    y, _ = ops.selective_scan(*ins)
    got = torch.autograd.grad((y * dy).sum(), ins)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["selective_scan"] == counts["selective_scan_bwd"] == 1
    ref = [t.detach().clone().requires_grad_(True) for t in ins]
    py, _ = ssm_scan_plain(*ref)
    want = torch.autograd.grad((py * dy).sum(), ref)
    _check_scan_bwd(got, want)
    with torch.no_grad():
        y, _ = ops.selective_scan(*ins)
    assert y.grad_fn is None
    assert ops.launch_counts()["selective_scan_bwd"] == 1
    with pytest.raises(ValueError, match="state size"):
        ops.selective_scan(x.detach(), dt, torch.zeros((128, 65), device=dev),
                           torch.zeros((1, 8, 65), device=dev),
                           torch.zeros((1, 8, 65), device=dev))


# B4-bwd against its plain version, by output dtype: fp32 dx and ddt
# (ddt in every case) elementwise at SCAN_TOL of the tensor's scale (the
# kernel's products and sums over the states are the plain version's, in
# its order), fp32 dB, dC and da (sums over D, or over b and t, in
# another order) by relative L2 <= 1e-5; bf16 dx, dB and dC (the fp32
# sums rounded once; upcast) by relative L2 <= 1e-3, some 20 times the
# largest error the card has shown (5.4e-5, dC).
SCAN_BWD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def _check_scan_bwd(got, want):
    for name, g, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        if g.dtype == torch.float32 and name in ("dx", "ddt"):
            scale = w.abs().max().clamp_min(1.0)
            torch.testing.assert_close(g / scale, w / scale, **SCAN_TOL)
        else:
            assert _rel_l2(g, w) <= SCAN_BWD_REL_L2[g.dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,n,hd", [
    (16, 128, 8192, 16, None),      # falcon-mamba's training shape
    (16, 128, 4096, 16, None),      # ... a rank's channels on tp 1x2
    (16, 128, 5120, 64, 64),        # zamba2's, in the Mamba-2 layout
    (3, 37, 200, 5, None),          # ragged L, D tile and N
])
def test_ssm_scan_backward_kernel_matches_plain(dev, dtype, b, l, d, n, hd):
    """B4-bwd against ssm_scan_bwd_plain, with and without dh_last, and
    its launch count; the kernel counts the exponentials it evaluates at
    its formula (bwd_exp_count), and counting changes no bit; a gradient
    off by 1% in ddt, or in dB, fails the limits."""
    from repro_torch.kernels.ssm_scan import (bwd_exp_count, expand_heads,
                                              ssm_scan_bwd,
                                              ssm_scan_bwd_plain)
    gen = torch.Generator(device=dev).manual_seed(17)
    if hd is None:
        args = _scan_case(gen, dev, dtype, b, l, d, n)
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, l, d // hd), generator=gen, device=dev) - 1.0)
        a_log = torch.log(torch.arange(1, d // hd + 1, device=dev,
                                       dtype=torch.float32))
        dt_c, a = expand_heads(dt, -torch.exp(a_log), hd, n)
        args = (_randn(gen, (b, l, d), dtype, dev), dt_c, a,
                _randn(gen, (b, l, n), dtype, dev),
                _randn(gen, (b, l, n), dtype, dev))
    dy = torch.randn((b, l, d), generator=gen, device=dev)
    dh = torch.randn((b, d, n), generator=gen, device=dev)
    for dh_last in (None, dh):
        before = ops.selective_scan_bwd.launches
        got = ops.selective_scan_bwd(*args, dy, dh_last)
        torch.cuda.synchronize()
        assert ops.selective_scan_bwd.launches == before + 1
        want = ssm_scan_bwd_plain(*args, dy, dh_last)
        _check_scan_bwd(got, want)
        assert all(torch.equal(g, h) for g, h in zip(
            got, ops.selective_scan_bwd(*args, dy, dh_last)))  # fixed order
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        counted = ssm_scan_bwd(*args, dy, dh_last, exp_count=counter)
        assert counter.item() == bwd_exp_count(b, l, d, n)
        assert all(torch.equal(g, h) for g, h in zip(got, counted))
    for i in (1, 3):                # ddt, dB
        planted = list(got)
        planted[i] = (got[i].float() * 1.01).to(got[i].dtype)
        with pytest.raises(AssertionError):
            _check_scan_bwd(planted, want)


def test_ssm_scan_backward_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd
    gen = torch.Generator(device=dev).manual_seed(3)
    x, dt, a, bm, cm = _scan_case(gen, dev, torch.float32, 1, 8, 64, 8)
    dy = torch.randn(x.shape, generator=gen, device=dev)
    ssm_scan_bwd(x, dt, a, bm, cm, dy)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_bwd(x.cpu(), dt, a, bm, cm, dy)
    with pytest.raises(ValueError, match="dy"):
        ssm_scan_bwd(x, dt, a, bm, cm, dy.cpu())
    with pytest.raises(ValueError, match="share"):
        ssm_scan_bwd(x.double(), dt, a, bm, cm, dy)
    with pytest.raises(ValueError, match="dy"):
        ssm_scan_bwd(x, dt, a, bm, cm, dy.half())
    with pytest.raises(ValueError, match="float32"):
        ssm_scan_bwd(x, dt.half(), a, bm, cm, dy)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan_bwd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a,
                     bm, cm, dy)
    with pytest.raises(ValueError, match="dy"):
        ssm_scan_bwd(x, dt, a, bm, cm, dy.transpose(1, 2).contiguous()
                     .transpose(1, 2))
    with pytest.raises(ValueError, match="dh_last"):
        ssm_scan_bwd(x, dt, a, bm, cm, dy, torch.zeros((1, 64, 7),
                                                        device=dev))
    with pytest.raises(ValueError, match="state size"):
        ssm_scan_bwd(x, dt, torch.zeros((64, 65), device=dev),
                     torch.zeros((1, 8, 65), device=dev),
                     torch.zeros((1, 8, 65), device=dev), dy)


def _heads_case(gen, dev, dtype, b, l, d, n, hd):
    """Mamba-2's per-head inputs: x, B, C in ``dtype``, dt (B, L, nh)
    softplus-drawn, a = -exp(a_log) at a_log = log(1..nh) (the init: a
    down to -nh)."""
    nh = d // hd
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, nh), generator=gen, device=dev) - 1.0)
    a = -torch.arange(1, nh + 1, device=dev, dtype=torch.float32)
    return (_randn(gen, (b, l, d), dtype, dev), dt, a,
            _randn(gen, (b, l, n), dtype, dev),
            _randn(gen, (b, l, n), dtype, dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,n,hd", [
    (16, 128, 5120, 64, 64),        # zamba2's training shape
    (16, 128, 2560, 64, 64),        # ... a rank's 40 heads on tp 1x2
    (8, 32, 256, 8, 32),            # the reduced zamba2's
    (3, 37, 60, 5, 12),             # ragged L, N, hd: 20 idle lanes
    (2, 21, 160, 16, 80),           # hd 80: a head in two tiles
])
def test_ssm_scan_heads_backward_kernel_matches_plain(dev, dtype, b, l, d,
                                                      n, hd):
    """The per-head B4-bwd against ssm_scan_heads_bwd_plain at B4-bwd's
    limits (``_check_scan_bwd``), with and without dh_last, and its
    launch count; two launches give the same bits; the kernel counts one
    exponential per (b, t, head), and counting changes no bit; a gradient
    off by 1% in ddt, or in dB, fails the limits."""
    from repro_torch.kernels.ssm_scan import (ssm_scan_heads_bwd,
                                              ssm_scan_heads_bwd_plain)
    gen = torch.Generator(device=dev).manual_seed(19)
    args = _heads_case(gen, dev, dtype, b, l, d, n, hd)
    dy = torch.randn((b, l, d), generator=gen, device=dev)
    dh = torch.randn((b, d, n), generator=gen, device=dev)
    for dh_last in (None, dh):
        before = ops.selective_scan_heads_bwd.launches
        got = ops.selective_scan_heads_bwd(*args, dy, dh_last)
        torch.cuda.synchronize()
        assert ops.selective_scan_heads_bwd.launches == before + 1
        assert got[1].shape == (b, l, d // hd) and got[2].shape == (d // hd,)
        want = ssm_scan_heads_bwd_plain(*args, dy, dh_last)
        _check_scan_bwd(got, want)
        assert all(torch.equal(g, h) for g, h in zip(
            got, ops.selective_scan_heads_bwd(*args, dy, dh_last)))
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        counted = ssm_scan_heads_bwd(*args, dy, dh_last, exp_count=counter)
        assert counter.item() == b * l * (d // hd)
        assert all(torch.equal(g, h) for g, h in zip(got, counted))
    for i in (1, 3):                # ddt, dB
        planted = list(got)
        planted[i] = (got[i].float() * 1.01).to(got[i].dtype)
        with pytest.raises(AssertionError):
            _check_scan_bwd(planted, want)


def test_ssm_scan_heads_backward_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels.ssm_scan import ssm_scan_heads_bwd
    gen = torch.Generator(device=dev).manual_seed(3)
    x, dt, a, bm, cm = _heads_case(gen, dev, torch.float32, 1, 8, 64, 8, 16)
    dy = torch.randn(x.shape, generator=gen, device=dev)
    ssm_scan_heads_bwd(x, dt, a, bm, cm, dy)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_heads_bwd(x.cpu(), dt, a, bm, cm, dy)
    with pytest.raises(ValueError, match="dy"):
        ssm_scan_heads_bwd(x, dt, a, bm, cm, dy.cpu())
    with pytest.raises(ValueError, match="share"):
        ssm_scan_heads_bwd(x.double(), dt, a, bm, cm, dy)
    with pytest.raises(ValueError, match="dy"):
        ssm_scan_heads_bwd(x, dt, a, bm, cm, dy.half())
    with pytest.raises(ValueError, match="float32"):
        ssm_scan_heads_bwd(x, dt.half(), a, bm, cm, dy)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan_heads_bwd(x.transpose(1, 2).contiguous().transpose(1, 2),
                           dt, a, bm, cm, dy)
    with pytest.raises(ValueError, match="dh_last"):
        ssm_scan_heads_bwd(x, dt, a, bm, cm, dy,
                           torch.zeros((1, 64, 7), device=dev))
    with pytest.raises(ValueError, match="state size"):
        ssm_scan_heads_bwd(x, dt, a, torch.zeros((1, 8, 65), device=dev),
                           torch.zeros((1, 8, 65), device=dev), dy)
    with pytest.raises(ValueError, match="multiple"):     # D % nh
        ssm_scan_heads_bwd(x, dt[..., :3].contiguous(), a[:3].contiguous(),
                           bm, cm, dy)
    with pytest.raises(ValueError, match=r"\(nh,\)"):     # a per channel
        ssm_scan_heads_bwd(x, dt, torch.zeros((4, 8), device=dev), bm, cm,
                           dy)
    with pytest.raises(ValueError, match="exp_count"):
        ssm_scan_heads_bwd(x, dt, a, bm, cm, dy, exp_count=torch.zeros(
            1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,n,hd", [
    (1, 100, 5120, 64, 64),     # zamba2's prefills: B = 1, L 100
    (1, 32, 5120, 64, 64),      # ... L 32
    (4, 32, 5120, 64, 64),      # ... four 32-token prompts
    (16, 128, 5120, 64, 64),    # zamba2's training shape
    (16, 128, 2560, 64, 64),    # ... a rank's 40 heads on tp 1x2
    (8, 32, 256, 8, 32),        # the reduced zamba2's hd and N
    (3, 37, 60, 5, 5),          # ragged L, N and hd: 12 heads of 5
])
def test_ssm_scan_heads_kernel_matches_plain(dev, dtype, b, l, d, n, hd):
    """The per-head B4 against ssm_scan_heads_plain at SCAN_TOL, bit for
    bit B4 on expand_heads' inputs and a second launch, its launch count,
    and the exponentials it evaluates at its formula
    (heads_fwd_exp_count): none per (channel, state)."""
    from repro_torch.kernels.ssm_scan import (expand_heads,
                                              heads_fwd_exp_count,
                                              ssm_scan_heads,
                                              ssm_scan_heads_plain)
    gen = torch.Generator(device=dev).manual_seed(23)
    args = _heads_case(gen, dev, dtype, b, l, d, n, hd)
    before = ops.selective_scan_heads.launches
    y, h = ops.selective_scan_heads(*args)
    torch.cuda.synchronize()
    assert ops.selective_scan_heads.launches == before + 1
    assert y.dtype == h.dtype == torch.float32
    py, ph = ssm_scan_heads_plain(*args)
    torch.testing.assert_close(y, py, **SCAN_TOL)
    torch.testing.assert_close(h, ph, **SCAN_TOL)
    ry, rh = ops.selective_scan(args[0], *expand_heads(args[1], args[2], hd,
                                                       n), args[3], args[4])
    assert torch.equal(y, ry) and torch.equal(h, rh)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    y2, h2 = ssm_scan_heads(*args, exp_count=counter)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert counter.item() == heads_fwd_exp_count(b, l, d // hd, hd, n)
    assert counter.item() <= b * l * (d // hd) * -(-hd // 8)


def test_ssm_scan_heads_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels.ssm_scan import ssm_scan_heads
    gen = torch.Generator(device=dev).manual_seed(3)
    x, dt, a, bm, cm = _heads_case(gen, dev, torch.float32, 1, 8, 64, 8, 16)
    ssm_scan_heads(x, dt, a, bm, cm)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_heads(x.cpu(), dt, a, bm, cm)
    with pytest.raises(ValueError, match="share"):
        ssm_scan_heads(x.double(), dt, a, bm, cm)
    with pytest.raises(ValueError, match="float32"):
        ssm_scan_heads(x, dt.half(), a, bm, cm)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan_heads(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                       a, bm, cm)
    with pytest.raises(ValueError, match="state size"):
        ssm_scan_heads(x, dt, a, torch.zeros((1, 8, 65), device=dev),
                       torch.zeros((1, 8, 65), device=dev))
    with pytest.raises(ValueError, match="multiple"):     # D % nh
        ssm_scan_heads(x, dt[..., :3].contiguous(), a[:3].contiguous(), bm,
                       cm)
    with pytest.raises(ValueError, match=r"\(nh,\)"):     # a per channel
        ssm_scan_heads(x, dt, torch.zeros((4, 8), device=dev), bm, cm)
    with pytest.raises(ValueError, match="exp_count"):
        ssm_scan_heads(x, dt, a, bm, cm, exp_count=torch.zeros(
            1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("b,l,nh,hd,n", [
    (1, 100, 80, 64, 64),       # full-width zamba2's Mamba-2 prefill
    (1, 32, 80, 64, 64),        # ... at the short prompt
])
def test_ssm_scan_kernel_in_the_mamba2_layout(dev, b, l, nh, hd, n):
    """B4 fed Mamba-2's layout (``expand_heads``: dt constant over
    each head's hd channels, A's rows constant over the N states), bf16
    x, B and C, against its plain version."""
    from repro_torch.kernels.ssm_scan import expand_heads
    gen = torch.Generator(device=dev).manual_seed(11)
    x = _randn(gen, (b, l, nh * hd), torch.bfloat16, dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, nh), generator=gen, device=dev) - 1.0)
    a_log = torch.log(torch.arange(1, nh + 1, device=dev,
                                   dtype=torch.float32))
    dt_c, a = expand_heads(dt, -torch.exp(a_log), hd, n)
    bm = _randn(gen, (b, l, n), torch.bfloat16, dev)
    cm = _randn(gen, (b, l, n), torch.bfloat16, dev)
    before = ops.selective_scan.launches
    y, h = ops.selective_scan(x, dt_c, a, bm, cm)
    py, ph = ssm_scan_plain(x, dt_c, a, bm, cm)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches == before + 1
    torch.testing.assert_close(y, py, **SCAN_TOL)
    torch.testing.assert_close(h, ph, **SCAN_TOL)


def _hybrid_spec(layers, **kw):
    return api.ServeSpec(
        model=api.ModelSpec(arch="zamba2-2.7b", reduced=True,
                            overrides={"num_layers": layers}),
        engine=api.EngineSpec(name="continuous"),
        workload=api.WorkloadSpec(num_requests=6, prompt_lens=[5, 17, 33],
                                  max_new_tokens=[4, 9]),
        clock=api.ClockSpec(kind="virtual"), **kw)


@pytest.mark.parametrize("layers", [5, 6])       # 6: one pre-block
def test_reduced_zamba2_on_the_card(dev, layers):
    """Float32 reduced zamba2 on the card: one prefill launches B1 once
    per shared-attention application and the per-head B4 once per Mamba-2
    layer (B4 itself never), and the continuous engine's every request
    equals single-request decoding (which also runs prefill and decode
    on the card)."""
    spec = _hybrid_spec(layers, report=api.ReportSpec(verify=-1))
    ctx = api.build_serve_context(spec)
    model = ctx.model
    toks = torch.arange(13, device=dev)[None] % model.cfg.vocab_size
    ops.reset_launches()
    logits, cache, _ = model.prefill(ctx.params, {"tokens": toks},
                                     cache_len=32)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert model.n_super == 2 and model.n_pre == layers - 5
    assert counts["flash_attention"] == model.n_super
    assert counts["selective_scan_heads"] == layers
    assert counts["selective_scan"] == 0
    assert sum(counts.values()) == model.n_super + layers
    assert bool(torch.isfinite(logits).all())
    assert cache["server_super"]["ssm"].is_cuda
    report = api.run_serve(spec, ctx=ctx)
    assert report.verified["checked"] == 6


def test_hybrid_loss_under_grad_raises_on_the_card(dev):
    """The hybrid's loss under grad on the card (float32 reduced zamba2):
    the per-head B4 and B4-bwd once per Mamba-2 layer (the per-channel
    ones never), B1 and B1-bwd once per
    shared-attention application, B5 and B5-bwd once; the loss and every
    leaf's gradient against the same parameters on the CPU, where the
    plain versions run (relative 1e-4: fp32 sums in another order)."""
    from repro_torch.configs import get_config
    from repro_torch.core import psl
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves, tree_map
    model = build_model(get_config("zamba2-2.7b", reduced=True))
    gen = torch.Generator().manual_seed(0)
    cpu_params = psl.requires_grad_(model.init(gen))
    params = psl.requires_grad_(tree_map(lambda p: p.detach().to(dev),
                                         cpu_params))
    toks = torch.arange(17)[None].repeat(2, 1) % model.cfg.vocab_size
    batch = {"tokens": toks[:, :16], "labels": toks[:, 1:].int(),
             "weights": torch.ones((2, 16))}
    ops.reset_launches()
    (loss, _), grads = psl.value_and_grad(
        model.loss_fn, params, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    layers, n_super = model.cfg.num_layers, model.n_super
    assert counts["selective_scan_heads"] \
        == counts["selective_scan_heads_bwd"] == layers
    assert counts["selective_scan"] == counts["selective_scan_bwd"] == 0
    assert counts["flash_attention"] == counts["flash_attention_bwd"] \
        == n_super
    assert counts["cross_entropy"] == counts["cross_entropy_bwd"] == 1
    (ref_loss, _), ref = psl.value_and_grad(model.loss_fn, cpu_params,
                                            batch)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-4)
    for g, w in zip(tree_leaves(grads), tree_leaves(ref)):
        assert _rel_l2(g.cpu(), w) <= 1e-4


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_reduced_ssm_psl_steps_on_the_card_match_the_cpu(dev, monkeypatch,
                                                         arch):
    """Reduced falcon-mamba and zamba2 (float32), PSL-UGS through api.run,
    2 AdamW steps from one CPU-drawn init (stacked matrices at fan-in
    d_in): losses on the card against the CPU at rtol 1e-4, and B4 and
    B4-bwd (the hybrid's the per-head ones, with B1 and B1-bwd) launched
    every step."""
    import math
    from repro_torch.api import protocols
    from repro_torch.core.psl import requires_grad_
    from repro_torch.launch.train import default_lm_spec
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import TrainState

    def fresh(ctx):
        gen = torch.Generator().manual_seed(ctx.seed)
        params = ctx.model.init(gen)
        for p, sp in zip(tree_leaves(params),
                         tree_leaves(ctx.model.param_specs())):
            if sp.init == "normal" and p.dim() >= 3:    # not a_log, D, norms
                p.mul_(math.sqrt(p.shape[0] / p.shape[-2]))
        params = requires_grad_(tree_map(lambda p: p.to(ctx.device), params))
        return TrainState(params, ctx.optimizer.init(params), 0)
    monkeypatch.setattr(protocols, "_fresh_state", fresh)
    spec = api.apply_overrides(default_lm_spec(), [
        f"model.arch={arch}", "model.reduced=true",
        "execution.max_steps=2", "protocol.global_batch_size=8",
        "data.seq_len=32", "data.sequences=256"])
    ops.reset_launches()
    card = api.run(spec, device="cuda")
    counts = ops.launch_counts()
    cpu = api.run(spec, device="cpu")
    assert len(card.step_metrics) == len(cpu.step_metrics) == 2
    for a, b in zip(card.step_metrics, cpu.step_metrics):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    layers = {"falcon-mamba-7b": 2, "zamba2-2.7b": 5}[arch]
    attn = {"falcon-mamba-7b": 0, "zamba2-2.7b": 2}[arch]
    fwd, bwd = {"falcon-mamba-7b": ("selective_scan", "selective_scan_bwd"),
                "zamba2-2.7b": ("selective_scan_heads",
                                "selective_scan_heads_bwd")}[arch]
    assert counts[fwd] == counts[bwd] == 2 * layers
    assert counts["selective_scan"] + counts["selective_scan_heads"] \
        == 2 * layers
    assert counts["selective_scan_bwd"] + counts[
        "selective_scan_heads_bwd"] == 2 * layers
    assert counts["flash_attention"] == counts["flash_attention_bwd"] \
        == 2 * attn
    assert counts["cross_entropy"] == counts["cross_entropy_bwd"] == 2


def test_reduced_speculative_serve_on_the_card(dev):
    """Float32 reduced granite through the speculative engine on the card:
    every request equals single-request decoding, no page leaks, and the
    verify step ran B3 once per layer per window step."""
    spec = api.ServeSpec(
        model=api.ModelSpec(arch="granite-3-2b", reduced=True),
        engine=api.EngineSpec(name="speculative"),
        workload=api.WorkloadSpec(num_requests=6, prompt_lens=[5, 17, 33],
                                  max_new_tokens=[4, 9]),
        clock=api.ClockSpec(kind="virtual"),
        cache=api.CacheSpec(page_size=8),
        draft=api.DraftSpec(num_layers=1, gamma=3),
        report=api.ReportSpec(verify=-1))
    ctx = api.build_serve_context(spec)
    ops.reset_launches()
    report = api.run_serve(spec, ctx=ctx)
    counts = ops.launch_counts()
    assert report.verified["checked"] == 6
    ctx.engine.pool.check_no_leaks()
    layers = ctx.model.cfg.num_layers
    assert counts["spec_verify"] == layers * report.steps > 0
    assert counts["paged_attention"] == ctx.engine.draft_steps > 0


def test_reduced_falcon_mamba_serve_on_the_card(dev):
    """Float32 reduced falcon-mamba through the continuous engine on the
    card: every request equals single-request decoding and each prefill
    ran B4 once per layer."""
    spec = api.ServeSpec(
        model=api.ModelSpec(arch="falcon-mamba-7b", reduced=True),
        engine=api.EngineSpec(name="continuous"),
        workload=api.WorkloadSpec(num_requests=6, prompt_lens=[5, 17, 33],
                                  max_new_tokens=[4, 9]),
        clock=api.ClockSpec(kind="virtual"),
        report=api.ReportSpec(verify=-1))
    ops.reset_launches()
    report = api.run_serve(spec)
    counts = ops.launch_counts()
    assert report.verified["checked"] == 6
    assert counts["selective_scan"] > 0
    assert counts["selective_scan"] % 2 == 0          # 2 layers a prefill
    assert counts["flash_attention"] == counts["paged_attention"] == 0


# --- tensor-core kernels: B1 forward and B5 backward in bf16 / fp16 --------
# Both round where their plain versions do not (B1: P to two 16-bit parts
# before P.V; B5-bwd: the softmax part of ds to the input dtype before its
# two products); the bf16 tolerance of 2e-2 holds them (one bf16 ulp of
# O(1) values is 2^-7).

LSE_TOL = dict(atol=1e-3, rtol=1e-4)     # fp32 sums, exp2 vs exp


def _attn_case(gen, dev, dtype, b, s, t, hq, hkv, d):
    return (_randn(gen, (b, s, hq, d), dtype, dev),
            _randn(gen, (b, t, hkv, d), dtype, dev),
            _randn(gen, (b, t, hkv, d), dtype, dev))


def _check_attention_with_lse(dev, dtype, q, k, v, causal, window):
    from repro_torch.kernels.flash_attention import flash_attention
    b, s, hq, _ = q.shape
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window,
                          lse=lse)
    want, want_lse = flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, with_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [8, 24, 40, 80, 128])
@pytest.mark.parametrize("s", [1, 17, 512])
def test_tensor_core_attention_head_dims_and_lengths(dev, dtype, d, s):
    """Every padded head_dim (8..56 run as 64, 72..128 as 128), one row,
    a ragged tile and several tiles; rep 4; out and lse."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = _attn_case(gen, dev, dtype, 2, s, s, 8, 2, d)
    _check_attention_with_lse(dev, dtype, q, k, v, True, None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window", [
    (16, 128, 128, 32, 8, 64, True, None),   # the training shape, rep 4
    (16, 100, 100, 32, 8, 64, True, None),   # serving prefill, ragged
    (2, 300, 300, 8, 2, 64, True, 100),      # window straddling tiles
    (2, 200, 200, 4, 4, 128, True, 70),      # window, widest head
    (2, 50, 130, 8, 2, 64, False, None),     # S != T, non-causal
    (2, 130, 50, 8, 2, 40, True, None),      # S > T, causal
    (1, 70, 70, 8, 1, 32, False, None),      # MQA
    (1, 100, 100, 32, 32, 80, True, None),   # zamba2's shared attention
    (1, 32, 32, 32, 32, 80, True, None),     # ... at the short prompt
])
def test_tensor_core_attention_shapes(dev, dtype, b, s, t, hq, hkv, d,
                                      causal, window):
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = _attn_case(gen, dev, dtype, b, s, t, hq, hkv, d)
    _check_attention_with_lse(dev, dtype, q, k, v, causal, window)


def test_tensor_core_attention_reads_strided_views(dev):
    """A (B, H, S, D)-contiguous q and a k/v sliced out of a wider buffer
    (strides that are not the model layout's)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    q = _randn(gen, (2, 8, 77, 64), torch.bfloat16, dev).transpose(1, 2)
    kv = _randn(gen, (2, 77, 2, 3, 64), torch.bfloat16, dev)
    _check_attention_with_lse(dev, torch.bfloat16, q, kv[:, :, :, 0],
                              kv[:, :, :, 2], True, None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_lse_feeds_the_backward(dev, dtype):
    """The tensor-core forward's lse, fed to B1-bwd, gives the plain
    backward's gradients (computed from the plain forward's lse)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (x.transpose(1, 2) for x in _attn_case(
        gen, dev, dtype, 4, 128, 128, 8, 2, 64))
    do = _randn(gen, (4, 8, 128, 64), dtype, dev)
    lse = torch.empty((4, 8, 128), dtype=torch.float32, device=dev)
    out = flash_attention(q, k, v, lse=lse)
    got = flash_attention_bwd(q, k, v, out, do, lse)
    pout, plse = flash_attention_plain(q, k, v, with_lse=True)
    want = flash_attention_bwd_plain(q, k, v, pout, do, plse)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **TOL[dtype])


def test_tensor_core_kernels_refuse_what_they_do_not_take(dev):
    base = torch.zeros((1, 8, 2, 25), dtype=torch.bfloat16, device=dev)
    q = base[..., :24]                        # rows 50 bytes apart
    with pytest.raises(ValueError, match="strides"):
        ops.attention(q, q, q)
    h = torch.zeros((4, 20), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((20, 64), dtype=torch.bfloat16, device=dev)
    labels = torch.zeros((4,), dtype=torch.int32, device=dev)
    g = torch.ones((4,), device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.cross_entropy_bwd(h, w, labels, torch.zeros((4,), device=dev), g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t,d,v", [
    (37, 24, 509),          # odd V (padded W), d not a multiple of 16
    (2048, 32, 8300),       # two chunks, the second ragged; V % 8 = 4
    (200, 64, 512),         # V a multiple of 8: W read unpadded
    (300, 128, 4096),       # unpadded, one chunk of 4096
    (2048, 2048, 49155),    # the training shape: 7 chunks, odd V
])
def test_tensor_core_cross_entropy_backward(dev, dtype, t, d, v):
    from repro_torch.kernels.cross_entropy import (cross_entropy_bwd_plain,
                                                   cross_entropy_fwd_plain)
    gen = torch.Generator(device=dev).manual_seed(12)
    h, w, labels = _xent_inputs(gen, t, d, v, dtype, dev)
    _, lse, _ = cross_entropy_fwd_plain(h, w, labels)
    g = torch.rand((t,), generator=gen, device=dev)
    before = ops.cross_entropy_bwd.launches
    dh, dw = ops.cross_entropy_bwd(h, w, labels, lse, g)
    pdh, pdw = cross_entropy_bwd_plain(h, w, labels, lse, g)
    torch.cuda.synchronize()
    assert ops.cross_entropy_bwd.launches == before + 1
    assert dh.dtype == dw.dtype == dtype and dw.shape == (d, v)
    torch.testing.assert_close(dh.float(), pdh.float(), **TOL[dtype])
    torch.testing.assert_close(dw.float(), pdw.float(), **TOL[dtype])


# --- tensor-core kernels: B5 forward and B1 backward in bf16 / fp16 --------
# The B5 forward's nll and lse are fp32 sums of the same bf16 products as
# the plain version's, in another order (fp32 tolerance); an argmax-is-
# label verdict may differ only at a near-tie (label logit within
# XENT_TIE of the row's largest). B1-bwd rounds P and dS to two 16-bit
# parts before its tensor-core products; held at the bf16 tolerance.

XENT_FWD_TOL = dict(atol=2e-4, rtol=1e-4)
XENT_TIE = 1e-4


def _check_xent_forward(h, w, labels):
    from repro_torch.kernels.cross_entropy import cross_entropy_fwd_plain
    before = ops.cross_entropy.launches
    nll, lse, correct = ops.cross_entropy(h, w, labels)
    pnll, plse, pcorrect = cross_entropy_fwd_plain(h, w, labels)
    torch.cuda.synchronize()
    assert ops.cross_entropy.launches == before + 1
    torch.testing.assert_close(nll, pnll, **XENT_FWD_TOL)
    torch.testing.assert_close(lse, plse, **XENT_FWD_TOL)
    idx = (correct != pcorrect).nonzero()[:, 0]
    if idx.numel():
        s = torch.matmul(h[idx].float(), w.float())
        gap = s.max(dim=1).values - s.gather(
            1, labels[idx].long()[:, None])[:, 0]
        assert gap.max().item() <= XENT_TIE
    return correct


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t,d,v", [
    (37, 24, 509),          # odd V (padded W), T below one tile
    (200, 64, 100),         # V below one 128-column tile
    (129, 8, 127),          # T one past a tile, narrowest d
    (130, 32, 4099),        # many splits, the last tile 3 columns
    (300, 128, 8300),       # V % 8 = 4
    (2048, 2048, 49155),    # the training shape: 8 splits, odd V
])
def test_tensor_core_cross_entropy_forward(dev, dtype, t, d, v):
    gen = torch.Generator(device=dev).manual_seed(13)
    h, w, labels = _xent_inputs(gen, t, d, v, dtype, dev)
    last_tile = (v - 1) // 128 * 128
    labels[:3] = torch.tensor([v - 1, last_tile, v - 2 if v > 1 else 0],
                              dtype=torch.int32, device=dev)
    _check_xent_forward(h, w, labels)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_cross_entropy_forward_first_index_wins_ties(dev, dtype):
    """Planted exact ties (every product and sum exact): across splits
    (5, 300), in one lane (130, 131), across lanes (260, 263) and into
    the last partial tile (6000, 8299). The first index is the argmax."""
    t, d, v = 8, 64, 8300
    gen = torch.Generator(device=dev).manual_seed(14)
    h, w, labels = _xent_inputs(gen, t, d, v, dtype, dev)
    pairs = [(5, 300), (130, 131), (260, 263), (6000, 8299)]
    h[:t] = 0
    for i, (a, b) in enumerate(pairs):
        dims = slice(8 * i, 8 * i + 8)
        h[i, dims] = 1
        h[i + 4, dims] = 1
        for col in (a, b):
            w[:, col] = 0
            w[dims, col] = 4                   # logit 32, the row's largest
        labels[i], labels[i + 4] = a, b
    correct = _check_xent_forward(h, w, labels)
    assert correct.tolist() == [1, 1, 1, 1, 0, 0, 0, 0]


def test_tensor_core_cross_entropy_forward_refuses_what_it_does_not_take(dev):
    labels = torch.zeros((4,), dtype=torch.int32, device=dev)
    w = torch.zeros((20, 64), dtype=torch.bfloat16, device=dev)
    h = torch.zeros((4, 20), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.cross_entropy(h, w, labels)
    base = torch.zeros((4 * 64 + 1,), dtype=torch.bfloat16, device=dev)
    h = base[1:].view(4, 64)                     # 2 bytes off
    w = torch.zeros((64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.cross_entropy(h, w, labels)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_cross_entropy_autograd_matches_plain(dev, dtype):
    """Forward and backward through ops.cross_entropy at an odd V: the
    backward reads the forward's padded W and gives the plain gradients."""
    from repro_torch.kernels.cross_entropy import cross_entropy_bwd_plain
    t, d, v = 300, 64, 4099
    gen = torch.Generator(device=dev).manual_seed(15)
    h, w, labels = _xent_inputs(gen, t, d, v, dtype, dev)
    g = torch.rand((t,), generator=gen, device=dev)
    hr, wr = h.requires_grad_(True), w.requires_grad_(True)
    nll, lse, _ = ops.cross_entropy(hr, wr, labels)
    dh, dw = torch.autograd.grad((nll * g).sum(), (hr, wr))
    pdh, pdw = cross_entropy_bwd_plain(h.detach(), w.detach(), labels,
                                       lse, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(dh.float(), pdh.float(), **TOL[dtype])
    torch.testing.assert_close(dw.float(), pdw.float(), **TOL[dtype])


def _check_attention_backward(dtype, q, k, v, do, causal, window,
                              grads=None):
    """B1-bwd against the plain backward, both fed the plain forward's out
    and lse. q, do (B, S, Hq, D) and k, v (B, T, Hkv, D) model layout;
    ``grads`` optional (dq, dk, dv) views of the heads-first shape."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse = flash_attention_plain(qt, kt, vt, causal=causal,
                                     window=window, with_lse=True)
    dq, dk, dv = grads if grads is not None else (None, None, None)
    got = flash_attention_bwd(qt, kt, vt, out, dot, lse, causal=causal,
                              window=window, dq=dq, dk=dk, dv=dv)
    want = flash_attention_bwd_plain(qt, kt, vt, out, dot, lse,
                                     causal=causal, window=window)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w.float(), **TOL[dtype])
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [8, 24, 40, 64, 80, 128])
@pytest.mark.parametrize("s", [1, 17, 100, 128, 512])
def test_tensor_core_attention_backward_head_dims_and_lengths(dev, dtype, d,
                                                              s):
    """Every padded head_dim (8..56 run as 64, 72..128 as 128), one row,
    ragged tiles and several tiles; causal, rep 4."""
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = _attn_case(gen, dev, dtype, 2, s, s, 8, 2, d)
    do = _randn(gen, (2, s, 8, d), dtype, dev)
    _check_attention_backward(dtype, q, k, v, do, True, None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window", [
    (16, 128, 128, 32, 8, 64, True, None),   # the training shape, rep 4
    (16, 100, 100, 32, 8, 64, True, None),   # ragged training length
    (2, 100, 100, 8, 2, 64, False, None),    # non-causal
    (2, 300, 300, 8, 2, 64, True, 100),      # window straddling tiles
    (2, 300, 300, 8, 2, 64, False, 100),     # window alone
    (2, 200, 200, 4, 4, 128, True, 70),      # rep 1, widest head, window
    (2, 130, 130, 4, 4, 40, True, None),     # rep 1
    (2, 50, 130, 8, 2, 64, False, None),     # S < T, non-causal
    (2, 130, 50, 8, 2, 40, True, None),      # S > T, causal
    (1, 70, 70, 8, 1, 32, False, None),      # MQA
])
def test_tensor_core_attention_backward_shapes(dev, dtype, b, s, t, hq, hkv,
                                               d, causal, window):
    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v = _attn_case(gen, dev, dtype, b, s, t, hq, hkv, d)
    do = _randn(gen, (b, s, hq, d), dtype, dev)
    _check_attention_backward(dtype, q, k, v, do, causal, window)


def test_tensor_core_attention_backward_writes_strided_views(dev):
    """dq, dk, dv as views into wider buffers (not the model layout);
    the buffers' other columns stay untouched."""
    gen = torch.Generator(device=dev).manual_seed(18)
    b, s, hq, hkv, d = 2, 77, 8, 2, 40
    q, k, v = _attn_case(gen, dev, torch.bfloat16, b, s, s, hq, hkv, d)
    do = _randn(gen, (b, s, hq, d), torch.bfloat16, dev)
    bufs = [torch.full((b, h, s, d + 8), 7.0, dtype=torch.bfloat16,
                       device=dev) for h in (hq, hkv, hkv)]
    views = tuple(x[..., 4:4 + d] for x in bufs)
    got = _check_attention_backward(torch.bfloat16, q, k, v, do, True, None,
                                    grads=views)
    assert all(g.data_ptr() == x.data_ptr() for g, x in zip(got, views))
    for x in bufs:
        assert bool((x[..., :4] == 7).all() and (x[..., 4 + d:] == 7).all())


def test_tensor_core_attention_backward_refuses_odd_strides(dev):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q = torch.zeros((1, 2, 8, 24), dtype=torch.bfloat16, device=dev)
    lse = torch.zeros((1, 2, 8), device=dev)
    dq = torch.zeros((1, 2, 8, 25), dtype=torch.bfloat16, device=dev)[
        ..., :24]                            # rows 50 bytes apart
    with pytest.raises(ValueError, match="strides"):
        flash_attention_bwd(q, q, q, q, q, lse, dq=dq)


# --- the paper's CNN (slice 8: no kernel; cuDNN convolutions) --------------

def _cnn_spec(**protocol):
    return api.ExperimentSpec(
        data=api.DataSpec(num_train=256, num_test=64),
        protocol=api.ProtocolSpec(epochs=1, global_batch_size=32,
                                  batch_size=16, **protocol),
        execution=api.ExecutionSpec(max_steps=3))


def _cpu_init(monkeypatch):
    """Every protocol's initial state from the port's seeded init made on
    the CPU and copied to the run's device (CUDA generators draw other
    numbers)."""
    from repro_torch.api import protocols
    from repro_torch.core.psl import requires_grad_
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import TrainState

    def fresh(ctx):
        gen = torch.Generator().manual_seed(ctx.seed)
        params = requires_grad_(tree_map(lambda p: p.to(ctx.device),
                                         ctx.model.init(gen)))
        return TrainState(params, ctx.optimizer.init(params), 0)
    monkeypatch.setattr(protocols, "_fresh_state", fresh)


@pytest.mark.parametrize("engine", ["fused", "sharded"])
def test_cnn_psl_steps_on_the_card_match_the_cpu(dev, monkeypatch, engine):
    """Reduced CNN, PSL-UGS, 3 SGD steps from the same init: losses at
    rtol 1e-4 (fp32 cuDNN convolutions, TF32 off, against the CPU's)."""
    _cpu_init(monkeypatch)
    spec = _cnn_spec()
    spec = spec.replace(execution=spec.execution.replace(engine=engine))
    card = api.run(spec, device="cuda")
    cpu = api.run(spec, device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert len(card.step_metrics) == len(cpu.step_metrics) == 3
    for a, b in zip(card.step_metrics, cpu.step_metrics):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["tokens"] == b["tokens"]
    from repro_torch.models.layers import tree_leaves
    assert all(p.is_cuda for p in tree_leaves(card.params))
    assert len(card.test_acc) == 1


def test_fl_does_not_alias_the_global_params_on_the_card(dev, monkeypatch):
    """FL trains clones: the round's global parameters stay as they were
    until end_epoch averages the local models."""
    from repro_torch.api.protocols import FLStrategy
    from repro_torch.models.layers import tree_leaves
    _cpu_init(monkeypatch)
    ctx = api.build_context(_cnn_spec(name="fl"), device=dev)
    strategy = FLStrategy()
    pstate = strategy.setup(ctx)
    before = [p.detach().clone() for p in tree_leaves(
        pstate["global_params"])]
    items = strategy.epoch_batches(ctx, pstate, None, 0)
    for _, item in zip(range(4), items):
        pstate, _ = strategy.step(ctx, pstate, item)
    assert all(torch.equal(a, b) for a, b in zip(
        before, tree_leaves(pstate["global_params"])))
    pstate = strategy.end_epoch(ctx, pstate, 0)
    after = tree_leaves(pstate["global_params"])
    assert all(p.is_cuda for p in after)
    assert not all(torch.equal(a, b) for a, b in zip(before, after))


def test_cnn_spec_runs_on_the_card_by_default(dev, monkeypatch):
    """No device argument: the CNN spec runs on the card, and without
    CUDA it raises instead of falling back to the CPU."""
    spec = _cnn_spec()
    ctx = api.build_context(spec)
    assert ctx.device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        api.run(spec)


# ---------------------------------------------------------------------------
# The vectorized planner engine on the card
# ---------------------------------------------------------------------------

def _planner_pop(k=6, seed=13):
    from repro_torch.core.types import ClientPopulation
    pop = ClientPopulation.homogeneous(k, 60, 10, seed=seed)
    pop.delays[:2] = 400.0
    return pop


def _agree(a, b, n):
    """Per-client means and standard deviations of two samples of ``n``
    first-step count rows agree within 4 standard errors of their
    difference (a sample std's error taken as σ/√(2n))."""
    import numpy as np
    var = a.var(0) + b.var(0)
    assert np.all(np.abs(a.mean(0) - b.mean(0)) <= 4 * np.sqrt(var / n)), \
        (a.mean(0), b.mean(0))
    assert np.all(np.abs(a.std(0) - b.std(0))
                  <= 4 * np.sqrt(var / (2 * n))), (a.std(0), b.std(0))


@pytest.mark.parametrize("method,n", [("ugs", 2000), ("lds", 400)])
def test_planner_on_the_card_matches_its_cpu_run_in_distribution(dev,
                                                                 method, n):
    """First-step counts over ``n`` seeds: the card's engine against the
    same engine on the CPU (other generators, one distribution), held by
    ``_agree``; UGS's means also within 4 standard errors of B·D_k/D."""
    import numpy as np
    from repro_torch.core import planner
    pop = _planner_pop()
    b = 96
    fn = planner.ugs_plan_torch if method == "ugs" \
        else planner.lds_plan_torch
    kw = {} if method == "ugs" else {"delta": 1.0}
    rows = {}
    for where in ("cuda", "cpu"):
        plans = [fn(pop, b, seed=s, device=where, **kw) for s in range(n)]
        for p in plans[:3]:
            p.validate_against(pop)
        rows[where] = np.stack([p.local_batch_sizes[0]
                                for p in plans]).astype(np.float64)
    _agree(rows["cuda"], rows["cpu"], n)
    if method == "ugs":
        want = b * pop.dataset_sizes / pop.total_size
        for got in rows.values():
            assert np.all(np.abs(got.mean(0) - want)
                          <= 4 * np.sqrt(got.var(0) / n)), got.mean(0)


@pytest.mark.parametrize("method,kw", [
    ("ugs", {}), ("lds", {"delta": 1.5}),
    ("lds", {"delta": 1.5, "reinit": True, "em_client_chunk": 32})])
def test_planner_dense_and_sparse_are_bit_identical_on_the_card(dev, method,
                                                                kw):
    import numpy as np
    from repro_torch.core import planner
    from repro_torch.core.types import ClientPopulation
    rng = np.random.default_rng(3)
    k = 120
    counts = np.zeros((k, 5), np.int64)
    counts[np.arange(k), rng.integers(0, 5, k)] = rng.integers(0, 9, k)
    pop = ClientPopulation(counts.sum(1), counts, rng.uniform(0, 300, k))
    fn = planner.ugs_plan_torch if method == "ugs" \
        else planner.lds_plan_torch
    dense = fn(pop, 48, seed=4, device=dev, plan_format="dense", **kw)
    sparse = fn(pop, 48, seed=4, device=dev, plan_format="sparse", **kw)
    dense.validate_against(pop)
    sparse.validate_against(pop)
    for t in range(dense.num_steps):
        ids, cnts = sparse.step_segments(t)
        row = dense.local_batch_sizes[t]
        np.testing.assert_array_equal(ids, np.flatnonzero(row))
        np.testing.assert_array_equal(cnts, row[row > 0])
    assert dense.em_iterations == sparse.em_iterations


# --- slice 10: head_dim 20 (reduced granite-moe), the MoE layer ----------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_20_kernels_match_plain(dev, dtype):
    """B1 forward and backward, B2 and B3 at head_dim 20 run on
    zero-padded copies (head_dim 24) scaled by 1/sqrt(20): each against
    its plain version at head_dim 20, one launch each."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain)
    gen = torch.Generator(device=dev).manual_seed(9)
    b, s, hq, hkv, d = 2, 37, 6, 2, 20
    q = _randn(gen, (b, s, hq, d), dtype, dev).requires_grad_(True)
    k = _randn(gen, (b, s, hkv, d), dtype, dev).requires_grad_(True)
    v = _randn(gen, (b, s, hkv, d), dtype, dev).requires_grad_(True)
    do = _randn(gen, (b, s, hq, d), dtype, dev)
    ops.reset_launches()
    out = ops.attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), grad_outputs=do)
    qt, kt, vt, ot, dot = (x.detach().transpose(1, 2)
                           for x in (q, k, v, out, do))
    want, lse = flash_attention_plain(qt, kt, vt, causal=True,
                                      with_lse=True)
    torch.testing.assert_close(out.detach().float(),
                               want.transpose(1, 2).float(), **TOL[dtype])
    for got, w in zip(grads, flash_attention_bwd_plain(qt, kt, vt, ot, dot,
                                                       lse, causal=True)):
        assert got.shape[-1] == d
        torch.testing.assert_close(got.float(), w.transpose(1, 2).float(),
                                   **TOL[dtype])
    qp, kp, vp, table, pos = _paged_walk_case(gen, dev, dtype, 6, 2, d, 16,
                                              4, [5, 40])
    got = ops.paged_attention(qp, kp, vp, table, pos)
    torch.testing.assert_close(
        got.float(), paged_attention_plain(qp, kp, vp, table, pos).float(),
        **TOL[dtype])
    qv, kv, vv, tv, q_pos = _verify_case(gen, dev, dtype, 2, 4, 6, 2, d, 16,
                                         5, [3, 1])
    got = ops.spec_verify(qv, kv, vv, tv, q_pos)
    torch.testing.assert_close(
        got.float(), spec_verify_plain(qv, kv, vv, tv, q_pos).float(),
        **TOL[dtype])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert [counts[n] for n in ("flash_attention", "flash_attention_bwd",
                                "paged_attention", "spec_verify")] \
        == [1, 1, 1, 1]


def _moe_case(dtype, dev, tie):
    """Reduced granite-moe's MoE weights at std 1/sqrt(d_in) and a skewed
    input (tokens share a component), drawn on the CPU, in ``dtype`` on
    ``dev``; ``tie`` makes router columns 0 and 1 equal."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.layers import moe_specs, tree_map
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m",
                                         reduced=True), dtype="float32")
    gen = torch.Generator().manual_seed(2)
    params = tree_map(lambda sp: torch.randn(sp.shape, generator=gen)
                      / sp.shape[-2] ** 0.5, moe_specs(cfg))
    if tie:
        params["router"][:, 1] = params["router"][:, 0]
    x = torch.randn((4, 16, cfg.d_model), generator=gen) \
        + torch.randn((cfg.d_model,), generator=gen)
    return cfg, tree_map(lambda t: t.to(dev, dtype), params), \
        x.to(dev, dtype)


@pytest.mark.parametrize("dtype,tie", [(torch.float32, False),
                                       (torch.float32, True),
                                       (torch.bfloat16, True)])
def test_moe_apply_on_the_card_matches_the_cpu(dev, dtype, tie):
    """moe_apply on the card against the same call on the CPU: float32 at
    atol 1e-5, bf16 at TOL; with tied router columns both pick the same
    experts, lower index first (a stable sort, as jax.lax.top_k)."""
    from repro_torch.models.layers import moe_apply, top_k_stable, tree_map
    cfg, params, x = _moe_case(dtype, dev, tie)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    y, aux = moe_apply(params, x, cfg)
    want_y, want_aux = moe_apply(cpu_params, x.cpu(), cfg)
    torch.cuda.synchronize()
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(y.cpu().float(), want_y.float(), **tol)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-5, rtol=0)
    xt = x.reshape(-1, cfg.d_model)
    logits = (xt @ params["router"]).float()
    cpu_logits = (xt.cpu() @ cpu_params["router"]).float()
    if tie:
        assert torch.equal(logits[:, 0], logits[:, 1])
    idx = top_k_stable(torch.softmax(logits, -1), 2)[1]
    cpu_idx = top_k_stable(torch.softmax(cpu_logits, -1), 2)[1]
    assert torch.equal(idx.cpu(), cpu_idx)
    if tie:
        rows = idx.cpu().tolist()
        assert any(r[:2] == [0, 1] for r in rows)
        assert not any(r[:2] == [1, 0] for r in rows)


def test_granite_moe_psl_steps_on_the_card_match_the_cpu(dev, monkeypatch):
    """Reduced granite-moe (float32), PSL-UGS through api.run, 2 AdamW
    steps from one CPU-drawn init (stacked matrices at fan-in d_in):
    loss and aux_loss on the card against the CPU at rtol 1e-4, and every
    training kernel launched on the card."""
    import math
    from repro_torch.api import protocols
    from repro_torch.core.psl import requires_grad_
    from repro_torch.launch.train import default_lm_spec
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import TrainState

    def fresh(ctx):
        gen = torch.Generator().manual_seed(ctx.seed)
        params = tree_map(
            lambda p: (p * math.sqrt(p.shape[0] / p.shape[-2])
                       if p.dim() >= 3 else p).to(ctx.device),
            ctx.model.init(gen))
        params = requires_grad_(params)
        return TrainState(params, ctx.optimizer.init(params), 0)
    monkeypatch.setattr(protocols, "_fresh_state", fresh)
    spec = api.apply_overrides(default_lm_spec(), [
        "model.arch=granite-moe-3b-a800m", "model.reduced=true",
        "execution.max_steps=2", "protocol.global_batch_size=8",
        "data.seq_len=32", "data.sequences=256"])
    ops.reset_launches()
    card = api.run(spec, device="cuda")
    counts = ops.launch_counts()
    cpu = api.run(spec, device="cpu")
    assert len(card.step_metrics) == len(cpu.step_metrics) == 2
    for a, b in zip(card.step_metrics, cpu.step_metrics):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["aux_loss"] == pytest.approx(b["aux_loss"], rel=1e-4)
        assert a["aux_loss"] > 0
    layers = 2
    assert counts["flash_attention"] == counts["flash_attention_bwd"] \
        == 2 * layers
    assert counts["cross_entropy"] == counts["cross_entropy_bwd"] == 2


# --- the audio family: B1 and B1-bwd without a causal mask ----------------
# whisper-tiny (6 heads of 64): the encoder's self-attention over 1500
# frames, the decoder prompt's cross-attention over them (S != T) and a
# decode step's (S = 1). T = 1500 ends in a partial 64-key tile (28 keys)
# that TMA zero-fills: those keys must be masked, not scored 0.

WHISPER_ATTN = [(2, 1500, 1500, 6, 6, 64), (2, 100, 1500, 6, 6, 64),
                (8, 1, 1500, 6, 6, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,hq,hkv,d", WHISPER_ATTN)
def test_whisper_attention_non_causal(dev, dtype, b, s, t, hq, hkv, d):
    """The forward as serving calls it (``ops.attention`` under no_grad,
    one counted launch), with its lse, and the backward, each against its
    plain version; the keys of the partial last tile, made large, must
    change the output (they are attended, not dropped)."""
    gen = torch.Generator(device=dev).manual_seed(19)
    q, k, v = _attn_case(gen, dev, dtype, b, s, t, hq, hkv, d)
    before = ops.attention.launches
    with torch.no_grad():
        out = ops.attention(q, k, v, causal=False)
    assert ops.attention.launches == before + 1
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=False)
    torch.testing.assert_close(out.float(), want.transpose(1, 2).float(),
                               **TOL[dtype])
    _check_attention_with_lse(dev, dtype, q, k, v, False, None)
    do = _randn(gen, (b, s, hq, d), dtype, dev)
    _check_attention_backward(dtype, q, k, v, do, False, None)
    k2, v2 = k.clone(), v.clone()
    k2[:, t - 1] = 4.0 * q[:, 0].mean(1, keepdim=True)
    v2[:, t - 1] = 100.0
    with torch.no_grad():
        moved = ops.attention(q, k2, v2, causal=False)
    assert bool((moved.float() - out.float()).abs().amax() > 1.0)


# --- tensor parallelism on 1x2: B1 and B1-bwd at a rank's heads ----------
# whisper-tiny's 3 of 6 heads on [audio-grads]' batch of 8 (the encoder
# over 1500 frames, the cross-attention of 128 tokens over them, the
# decoder causal over 128) and granite-moe-3b-a800m's 12 q of 24 and 4 kv
# of 8 heads on [train]'s 16 x 128, in both dtypes the [mesh] runs take.

TP_RANK_ATTN = [(8, 1500, 1500, 3, 3, 64, False),
                (8, 128, 1500, 3, 3, 64, False),
                (8, 128, 128, 3, 3, 64, True),
                (16, 128, 128, 12, 4, 64, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal", TP_RANK_ATTN)
def test_tp_rank_attention_shapes(dev, dtype, b, s, t, hq, hkv, d, causal):
    """The forward with its lse and the backward at a tensor-parallel
    rank's shapes, each against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = _attn_case(gen, dev, dtype, b, s, t, hq, hkv, d)
    _check_attention_with_lse(dev, dtype, q, k, v, causal, None)
    do = _randn(gen, (b, s, hq, d), dtype, dev)
    _check_attention_backward(dtype, q, k, v, do, causal, None)


def test_reduced_whisper_static_serve_on_the_card(dev):
    """Float32 reduced whisper served through ``static`` on the card: one
    prefill runs B1 non-causal once an encoder layer and once a decoder
    layer (cross-attention), causal once a decoder layer; each decode step
    B1 at S = 1 once a decoder layer; no other kernel. The tokens equal
    the same serve on the CPU from the same weights."""
    from repro_torch.models.layers import tree_map
    spec = api.ServeSpec(
        model=api.ModelSpec(arch="whisper-tiny", reduced=True),
        engine=api.EngineSpec(name="static"),
        workload=api.WorkloadSpec(num_requests=4, prompt_lens=[5, 9],
                                  max_new_tokens=[6]))
    cpu_ctx = api.build_serve_context(spec, device="cpu")
    ctx = api.build_serve_context(
        spec, params=tree_map(lambda p: p.to(dev), cpu_ctx.params))
    cfg = ctx.model.cfg
    ops.reset_launches()
    report = api.run_serve(spec, ctx=ctx)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    per_prefill = cfg.encoder_layers + 2 * cfg.num_layers
    assert counts["flash_attention"] == per_prefill \
        + cfg.num_layers * report.steps
    assert sum(counts.values()) == counts["flash_attention"]
    cpu = api.run_serve(spec, ctx=cpu_ctx)
    assert {r["rid"]: r["tokens"] for r in report.per_request} == \
        {r["rid"]: r["tokens"] for r in cpu.per_request}



_FIRST_BACKWARD = r"""
import sys, torch
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
dev = resolve_device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
q, k, v = (torch.randn((4, 128, h, 64), generator=gen, device=dev)
           .to(torch.bfloat16).requires_grad_(True) for h in (32, 8, 8))
h = torch.randn((256, 64), generator=gen, device=dev).to(torch.bfloat16)
w = torch.randn((64, 512), generator=gen, device=dev).to(torch.bfloat16)
labels = torch.randint(0, 512, (256,), generator=gen, device=dev)
out = ops.attention(q, k, v, causal=True)
torch.autograd.grad(out, (q, k, v), grad_outputs=torch.ones_like(out))
torch.cuda.synchronize()
h.requires_grad_(True)
loss = ops.cross_entropy(h, w.requires_grad_(True), labels)[0].sum()
torch.autograd.grad(loss, (h, w))
torch.cuda.synchronize()
print("FIRST_BACKWARD_OK", ops.launch_counts()["flash_attention_bwd"],
      ops.launch_counts()["cross_entropy_bwd"])
"""


def test_kernel_backward_is_the_first_work_of_autograds_thread(dev):
    """B1-bwd as the first CUDA work of autograd's device thread, in a
    fresh process: that thread has no current context until a runtime
    call makes one, and the tensor-map encoder (a driver call) needs it
    (``hopper_host::bind_context``). The process starts after this
    one's kernels are built."""
    import os
    import subprocess
    import sys
    ops.attention(*(torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16,
                                device=dev) for _ in range(3)))
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", _FIRST_BACKWARD],
                          env=dict(os.environ, PYTHONPATH=src),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FIRST_BACKWARD_OK 1 1" in proc.stdout
