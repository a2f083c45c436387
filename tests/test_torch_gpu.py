"""The port's CUDA kernels and engines on the card (marker ``gpu``).

These tests need a CUDA card and skip without one; they import only torch
and repro_torch, so they run on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain version on the same inputs: float32
at atol 2e-5 (sums in another order; 2e-4 for the cross-entropy values,
sums over the whole vocab), bfloat16 at atol/rtol 2e-2 (one rounding of
the output; sums in another order).
"""
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_plain

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


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


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((1, 8, 2, 24), device=dev)          # head_dim 24 ok
    ops.attention(q, q, q)
    bad = torch.zeros((1, 8, 2, 20), device=dev)        # not a multiple of 8
    with pytest.raises(ValueError, match="head_dim"):
        ops.attention(bad, bad, bad)


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
