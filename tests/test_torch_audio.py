"""The audio family (whisper-tiny's encoder-decoder) against repro, on the
CPU, at the reduced config (d_model 128, 2 encoder + 2 decoder layers,
64 frames, float32).

Parameters are repro's init, bridged key for key, with every stacked
matrix rescaled in numpy to the std of fan-in d_in and the zero-init GELU
MLP biases drawn at std 0.02 so they take part (``audio_params``). Inputs
are numpy draws from a seed. Tolerances: the layers (cross-attention, the
GELU MLP) at ``LAYER_ATOL`` 1e-5; through the model (encoder states,
prefill and decode logits, loss) at ``MODEL_ATOL`` 1e-4, the loss and its
metrics at rtol ``LOSS_RTOL`` 1e-5 as ``tests/test_torch_archs.py``
holds the decoder LMs; per-leaf PSL gradients (``decomposed_grads``,
through the encoder/decoder cut; ``tests/test_torch_audio_train.py``)
with max |port - repro| <= ``GRAD_REL`` 1e-4 of max |repro| and the same
relative L2 error.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch import checkpoint as tckpt
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as TL
from repro_torch.models.layers import tree_leaves
from repro_torch.models.transformer import EncDecModel
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "whisper-tiny"
LAYER_ATOL = 1e-5
MODEL_ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
B, S, CACHE_EXTRA = 2, 12, 6


def audio_params(jm, seed=0):
    """repro's init as numpy, stacked matrices at fan-in d_in, the GELU
    MLP and attention biases drawn at std 0.02."""
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        leaf = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        if leaf.ndim >= 3:
            return (leaf * math.sqrt(leaf.shape[0] / leaf.shape[-2])).astype(
                leaf.dtype)
        if name.endswith(("['b_in']", "['b_out']", "['bq']", "['bk']",
                          "['bv']")):
            return (0.02 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module")
def pair():
    jm = jbuild(jget(ARCH, reduced=True))
    tm = tbuild(tget(ARCH, reduced=True))
    jp = audio_params(jm)
    return jm, tm, jp, from_numpy_tree(jp, "cpu")


def _batch(cfg, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    weights = (rng.random((b, s)) < 0.8).astype(np.float32)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :s]),
          "labels": jnp.asarray(toks[:, 1:]), "weights": jnp.asarray(weights)}
    tb = {"frames": torch.from_numpy(frames),
          "tokens": torch.from_numpy(toks[:, :s]).long(),
          "labels": torch.from_numpy(toks[:, 1:]),
          "weights": torch.from_numpy(weights)}
    return jb, tb


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               atol=atol, rtol=0)


def test_config_and_param_count_equal_repros():
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro_torch.configs import ARCH_IDS
    assert ARCH in ARCH_IDS and ARCH_IDS.index(ARCH) == \
        J_ARCH_IDS.index(ARCH)
    for reduced in (False, True):
        t, j = tget(ARCH, reduced), jget(ARCH, reduced)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert isinstance(tbuild(t), EncDecModel)
    assert tget(ARCH).param_count() == 61_073_664
    tm, jm = tbuild(tget(ARCH, True)), jbuild(jget(ARCH, True))
    specs = jax.tree_util.tree_leaves(
        jm.param_specs(), is_leaf=lambda x: hasattr(x, "axes"))
    assert [(s.shape, s.axes, s.init) for s in tree_leaves(
        tm.param_specs())] == [(s.shape, s.axes, s.init) for s in specs]


@pytest.mark.parametrize("bias", [False, True])
def test_cross_attention_matches_repro(bias):
    cfg_j = dataclasses.replace(jget(ARCH, reduced=True), qkv_bias=bias)
    cfg_t = dataclasses.replace(tget(ARCH, reduced=True), qkv_bias=bias)
    rng = np.random.default_rng(3)
    d = cfg_j.d_model
    p = {k: (rng.standard_normal(s.shape) / math.sqrt(s.shape[0])).astype(
        np.float32) for k, s in JL.cross_attention_specs(cfg_j).items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    enc = rng.standard_normal((2, cfg_j.encoder_seq, d)).astype(np.float32)
    want = JL.cross_attention(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), jnp.asarray(enc), cfg_j)
    got = TL.cross_attention({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), torch.from_numpy(enc),
                             cfg_t)
    assert got.shape == (2, 5, d)
    _close(got, want, LAYER_ATOL)


def test_gelu_mlp_matches_repro():
    cfg = jget(ARCH, reduced=True)
    rng = np.random.default_rng(4)
    specs = JL.mlp_specs(cfg, gelu=True)
    assert sorted(specs) == sorted(TL.mlp_specs(tget(ARCH, True), gelu=True))
    p = {k: (rng.standard_normal(s.shape) / math.sqrt(s.shape[0])).astype(
        np.float32) for k, s in specs.items()}
    x = (2.0 * rng.standard_normal((3, 7, cfg.d_model))).astype(np.float32)
    want = JL.mlp_apply(jax.tree_util.tree_map(jnp.asarray, p),
                        jnp.asarray(x), gelu=True)
    got = TL.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), gelu=True)
    _close(got, want, LAYER_ATOL)


def test_encode_matches_repro(pair):
    jm, tm, jp, tp = pair
    jb, tb = _batch(jm.cfg)
    want = jm.encode(jp, jb["frames"])
    got = tm.encode(tp, tb["frames"])
    assert got.shape == (B, jm.cfg.encoder_seq, jm.cfg.d_model)
    _close(got, want, MODEL_ATOL)


def test_prefill_then_decode_match_repro(pair):
    """Prefill logits and cache, then 4 greedy decode steps at the scalar
    position, against repro's."""
    jm, tm, jp, tp = pair
    jb, tb = _batch(jm.cfg)
    c = S + CACHE_EXTRA
    jlog, jcache, jpos = jm.prefill(jp, jb, cache_len=c)
    tlog, tcache, tpos = tm.prefill(tp, tb, cache_len=c)
    assert tpos == int(jpos) == S
    _close(tlog, jlog, MODEL_ATOL)
    assert tcache["self"]["k"].shape == jcache["self"]["k"].shape
    _close(tcache["self"]["k"], jcache["self"]["k"], MODEL_ATOL)
    _close(tcache["enc"], jcache["enc"], MODEL_ATOL)
    specs = tm.cache_specs(B, c)
    assert [s.shape for s in tree_leaves(specs)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jcache)]
    tok = np.array(jnp.argmax(jlog, axis=-1), np.int32)[:, None]
    pos = S
    for _ in range(4):
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                      jnp.int32(pos))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                      pos)
        assert tlog.shape == (B, 1, jm.cfg.vocab_size)
        _close(tlog, jlog, MODEL_ATOL)
        tok = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
        pos += 1
    _close(tcache["self"]["v"], jcache["self"]["v"], MODEL_ATOL)


def test_decode_step_takes_a_tensor_position(pair):
    """``decode_step`` at a position given as a tensor (as a (1,) vector
    or a 0-d one) equals the int form."""
    jm, tm, _, tp = pair
    _, tb = _batch(jm.cfg, seed=2)
    outs = []
    for pos in (S, torch.tensor(S), torch.tensor([S])):
        _, cache, _ = tm.prefill(tp, tb, cache_len=S + 2)
        outs.append(tm.decode_step(tp, cache, tb["tokens"][:, -1:], pos)[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_checkpoint_carries_repro_params_key_for_key(tmp_path):
    """A bf16 reduced whisper saved by repro restores into the port bit for
    bit, under repro's flat keys, and the restored tree is the model's."""
    jm = jbuild(dataclasses.replace(jget(ARCH, True), dtype="bfloat16"))
    jp = jm.init(jax.random.PRNGKey(5))
    path = str(tmp_path / "params.npz")
    jckpt.save(path, jp)
    with np.load(path) as z:
        keys = set(z.files)
    assert {"client/enc_blocks/mlp/w_in", "client/enc_pos",
            "server/dec_blocks/xattn/wq", "server/dec_pos"} <= keys
    tp = tckpt.restore(path, device="cpu")
    tm = tbuild(dataclasses.replace(tget(ARCH, True), dtype="bfloat16"))
    assert [tuple(t.shape) for t in tree_leaves(tp)] == [
        s.shape for s in tree_leaves(tm.param_specs())]
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        a = np.asarray(a)
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      a.view(np.int16))


def test_init_follows_repros_rules():
    """The port's own init: ones for norms, zeros for biases, embeddings
    at std 0.02, matrices at 1/sqrt(shape[0]) — repro's rules."""
    tm = tbuild(tget(ARCH, reduced=True))
    gen = torch.Generator().manual_seed(0)
    p = tm.init(gen)
    assert torch.equal(p["client"]["enc_norm"], torch.ones(128))
    assert not p["server"]["dec_blocks"]["mlp"]["b_in"].any()
    assert abs(float(p["server"]["dec_pos"].std()) - 0.02) < 2e-3
    w_in = p["client"]["enc_blocks"]["mlp"]["w_in"]
    assert abs(float(w_in.std()) - 1 / math.sqrt(2)) < 0.02


def test_audio_family_not_served():
    """As in repro: the continuous engine refuses the audio family and
    names the static server."""
    from repro_torch.runtime import ContinuousEngine
    cfg = tget(ARCH, reduced=True)
    with pytest.raises(NotImplementedError, match="static server"):
        ContinuousEngine(cfg, num_slots=1, slot_len=8, device="cpu")
