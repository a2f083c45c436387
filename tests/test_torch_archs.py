"""The six decoder configs of the MoE, VLM and dense families against
repro, on the CPU: granite-moe-3b-a800m, llama4-scout-17b-a16e,
moonshot-v1-16b-a3b, internvl2-2b, llama3-8b and qwen2-72b, reduced
(float32, 2 layers).

Parameters are repro's init, bridged key for key, with every stacked
matrix rescaled in numpy to the std of fan-in d_in (repro's init takes a
stacked leaf's layer count as its fan-in, which at 1 layer a stack gives
std-1 weights, activations in the thousands and routing that float
rounding decides). On those weights:

- ``loss_fn``: total, loss, aux_loss and accuracy at rtol 1e-5; per-leaf
  gradients with max |port - repro| <= 3e-4 max |repro| and relative L2
  error <= 3e-4, as ``tests/test_torch_train.py`` holds the dense LM;
- prefill and decode logits (contiguous and paged) at
  ``tests/test_torch_model.py``'s atol 1e-4.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.core import psl as tpsl
from repro_torch.models import build_model as tbuild
from repro_torch.models.layers import tree_leaves
from torch_one_thread import one_torch_thread  # noqa: F401

ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e",
         "moonshot-v1-16b-a3b", "internvl2-2b", "llama3-8b", "qwen2-72b"]
LOSS_RTOL = 1e-5
GRAD_REL = 3e-4
LOGIT_ATOL = 1e-4


def fan_in_params(jm, seed=0):
    """repro's init as numpy, every stacked matrix (ndim >= 3) rescaled
    from std 1/sqrt(layers) to 1/sqrt(d_in), and zero-init biases drawn
    at std 0.02 so they take part."""
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        leaf = np.asarray(leaf)
        if leaf.ndim >= 3:
            return (leaf * math.sqrt(leaf.shape[0] / leaf.shape[-2])).astype(
                leaf.dtype)
        if jax.tree_util.keystr(path).endswith(("['bq']", "['bk']",
                                                "['bv']")):
            return (0.02 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    arch = request.param
    jm = jbuild(jget(arch, reduced=True))
    tm = tbuild(tget(arch, reduced=True))
    jp = fan_in_params(jm)
    return arch, jm, tm, jp, from_numpy_tree(jp, "cpu")


def test_registry_takes_every_ported_arch():
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCHS:
        for reduced in (False, True):
            t, j = tget(arch, reduced), jget(arch, reduced)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            tbuild(t)


def test_bridged_params_are_key_for_key(arch_pair):
    _, jm, tm, jp, tp = arch_pair
    spec_shapes = jax.tree_util.tree_map(
        lambda s: tuple(s.shape), tm.param_specs(),
        is_leaf=lambda s: hasattr(s, "axes"))
    jshapes = jax.tree_util.tree_map(
        lambda s: tuple(s.shape), jm.param_specs(),
        is_leaf=lambda s: hasattr(s, "axes"))
    assert spec_shapes == jshapes
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _batch(vocab, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    w = np.ones((b, s), np.float32)
    w[1, : s // 3] = 0.0
    host = {"tokens": toks[:, :s], "labels": toks[:, 1:], "weights": w}
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = {k: torch.from_numpy(v) for k, v in host.items()}
    return jb, tb


def assert_grads(tg, jg):
    for got, want in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        got = got.detach().double().numpy()
        want = np.asarray(want, np.float64)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= GRAD_REL * scale, want.shape
        assert np.linalg.norm(got - want) <= GRAD_REL * np.linalg.norm(want)


def test_loss_metrics_and_grads_match_repro(arch_pair):
    arch, jm, tm, jp, _ = arch_pair
    jb, tb = _batch(jm.cfg.vocab_size)
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
    (tl, tmet), tg = tpsl.value_and_grad(
        tm.loss_fn, tpsl.requires_grad_(from_numpy_tree(jp, "cpu")), tb)
    assert sorted(tmet) == sorted(jmet)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert (float(jmet["aux_loss"]) > 0) == jm.cfg.is_moe
    assert_grads(tg, jg)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=LOGIT_ATOL, rtol=0)


def test_prefill_and_decode_logits_match_repro(arch_pair):
    _, jm, tm, jp, tp = arch_pair
    plen, cache_len = 13, 24
    toks = np.random.default_rng(3).integers(
        0, jm.cfg.vocab_size, (2, plen)).astype(np.int32)
    jl, jc, _ = jax.jit(functools.partial(jm.prefill, cache_len=cache_len))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tc, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              cache_len=cache_len)
    assert tpos == plen
    _close(tl, jl)
    tok = np.array([[3], [5]], np.int32)
    pos = np.array([plen, plen], np.int32)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(tok), torch.tensor(pos))
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = pos + 1


def test_decode_step_paged_logits_match_repro(arch_pair):
    """Both rows' prompts laid into pages through a permuted table, then
    three paged decode steps with an inactive row on the scratch page."""
    _, jm, tm, jp, tp = arch_pair
    psize, plen = 8, 16
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, plen)).astype(np.int32)
    _, jc, _ = jax.jit(functools.partial(jm.prefill, cache_len=plen))(
        jp, {"tokens": jnp.asarray(toks)})
    num_pages = 8
    table = np.full((3, 4), num_pages, np.int32)          # row 2 inactive
    table[0, :3], table[1, :3] = [5, 1, 6], [2, 7, 0]
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
                    = torch.from_numpy(np.array(pages))
    tok = np.array([[3], [5], [0]], np.int32)
    pos = np.array([plen, plen, 0], np.int32)
    decode = jax.jit(jm.decode_step_paged)
    for _ in range(3):
        jl, jbuf = decode(jp, jbuf, jnp.asarray(tok), jnp.asarray(pos),
                          jnp.asarray(table))
        tl, tbuf = tm.decode_step_paged(tp, tbuf, torch.tensor(tok),
                                        torch.tensor(pos),
                                        torch.from_numpy(table))
        _close(tl[:2], jl[:2])
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = pos + np.array([1, 1, 0], np.int32)
