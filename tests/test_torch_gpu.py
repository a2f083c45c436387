"""The port's CUDA kernels and engines on the card (marker ``gpu``).

These tests need a CUDA card and skip without one; they import only torch
and repro_torch, so they run on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain version on the same inputs: float32
at atol 2e-5 (sums in another order), bfloat16 at atol/rtol 2e-2 (one
rounding of the output; sums in another order).
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
