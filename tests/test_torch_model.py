"""The port's dense LM against repro's on bridged parameters.

Parameters initialized by ``repro`` move into the port through the
weights bridge; prefill logits and caches, contiguous decode and paged
decode then agree with ``repro`` on reduced granite (float32) and on an
override whose cache replicates kv heads (kv_repeat 4). Tolerance atol
1e-4: float32 products summed in another order by XLA and by PyTorch.
Cache entries reach ~25 (the client's stacked projections have fan-in 1
under repro's init rule), so caches compare at atol 1e-4 after division
by their largest magnitude.
"""
import functools
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.models.layers import tree_leaves
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "granite-3-2b"
OVERRIDES = {"reduced": {}, "kv_repeat4": {"num_heads": 16,
                                          "num_kv_heads": 4}}


def _models(over):
    jcfg = dataclasses.replace(jget(ARCH, reduced=True), **over)
    tcfg = dataclasses.replace(tget(ARCH, reduced=True), **over)
    return jbuild(jcfg), tbuild(tcfg)


@pytest.fixture(scope="module", params=sorted(OVERRIDES))
def pair(request):
    jm, tm = _models(OVERRIDES[request.param])
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tckpt.from_numpy_tree(jax.device_get(jp), "cpu")
    return jm, tm, jp, tp


def _close(got, want, scale=1.0):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.float()) / scale,
                               want / scale, atol=1e-4, rtol=0)


def test_bridged_params_are_key_for_key(pair):
    jm, tm, jp, tp = pair
    want = jax.tree_util.tree_map(lambda x: x.shape, jm.param_specs(),
                                  is_leaf=lambda s: hasattr(s, "axes"))
    got = {}
    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t.shape))
    got = shapes(tp)
    spec_shapes = jax.tree_util.tree_map(
        lambda s: tuple(s.shape), tm.param_specs(),
        is_leaf=lambda s: hasattr(s, "axes"))
    assert got == spec_shapes
    assert jax.tree_util.tree_structure(want) \
        == jax.tree_util.tree_structure(spec_shapes)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_kv_repeat_matches(pair):
    jm, tm, _, _ = pair
    assert tm.blocks.kv_repeat() == jm.blocks.kv_repeat()
    assert tm.cache_specs(3, 40) == tm.cache_specs(3, 40)
    jspec = jm.cache_specs(3, 40)["server"]["k"]
    tspec = tm.cache_specs(3, 40)["server"]["k"]
    assert (tspec.shape, tspec.axes) == (jspec.shape, jspec.axes)


def _prefill(pair, plen=37, cache_len=48, batch=2, seed=0):
    jm, tm, jp, tp = pair
    toks = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab_size, (batch, plen)).astype(np.int32)
    jout = jax.jit(functools.partial(jm.prefill, cache_len=cache_len))(
        jp, {"tokens": jnp.asarray(toks)})
    tout = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                      cache_len=cache_len)
    return jout, tout


@pytest.fixture(scope="module")
def prefilled(pair):
    return _prefill(pair)


def test_prefill_logits_and_cache(prefilled):
    (jl, jc, jpos), (tl, tc, tpos) = prefilled
    assert int(jpos) == tpos
    _close(tl, jl)
    for side in ("client", "server"):
        for kv in ("k", "v"):
            assert tuple(tc[side][kv].shape) == jc[side][kv].shape
            scale = max(1.0, float(np.abs(np.asarray(jc[side][kv])).max()))
            _close(tc[side][kv], jc[side][kv], scale=scale)


def test_decode_step_logits(pair, prefilled):
    jm, tm, jp, tp = pair
    (_, jc, _), (_, tc, _) = prefilled
    tc = {side: {kv: t.clone() for kv, t in c.items()}
          for side, c in tc.items()}       # decode writes in place
    tok = np.array([[3], [5]], np.int32)
    pos = np.array([37, 37], np.int32)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(tok),
                                torch.tensor(pos))
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = pos + 1


def test_decode_step_paged_logits(pair):
    """Prefill into pages through permuted tables, then paged decode with
    one row mid-page and an inactive row on the scratch page."""
    jm, tm, jp, tp = pair
    psize, m = 8, 6
    (_, jc, _), (_, tc, _) = _prefill(pair, plen=21, cache_len=24)
    num_pages = 12
    rng = np.random.default_rng(2)
    ids = rng.permutation(num_pages)[:8]      # 3 + 3 prompt, 2 growth
    table = np.full((3, m), num_pages, np.int32)       # row 2: inactive
    table[0, :3], table[1, :3] = ids[:3], ids[3:6]
    jbuf = jm.init_cache(num_pages + 1, psize)
    tbuf = tm.init_cache(num_pages + 1, psize, device="cpu")
    for side in ("client", "server"):
        for kv in ("k", "v"):
            for row in range(2):
                src = np.asarray(jc[side][kv])[:, row]   # (L, 24, H, hd)
                pages = src.reshape(src.shape[0], 3, psize, *src.shape[2:])
                jbuf[side][kv] = jbuf[side][kv].at[:, table[row, :3]].set(
                    pages)
                tbuf[side][kv][:, torch.from_numpy(table[row, :3]).long()] \
                    = torch.tensor(pages)
    tok = np.array([[3], [5], [0]], np.int32)
    pos = np.array([21, 21, 0], np.int32)
    decode = jax.jit(jm.decode_step_paged)
    for _ in range(4):        # crosses into logical page 3 at position 24
        table[0, 3], table[1, 3] = ids[6], ids[7]
        jl, jbuf = decode(
            jp, jbuf, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(table))
        tl, tbuf = tm.decode_step_paged(tp, tbuf, torch.tensor(tok),
                                        torch.tensor(pos),
                                        torch.from_numpy(table))
        _close(tl[:2], jl[:2])
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = pos + np.array([1, 1, 0], np.int32)


def test_init_follows_repro_rules():
    """Same leaves, dtypes and scale rules as repro's materialize —
    including a stacked leaf's fan-in being its layer count — and a pure
    function of the generator seed."""
    _, tm = _models({})
    g = torch.Generator().manual_seed(0)
    p1 = tm.init(g)
    p2 = tm.init(torch.Generator().manual_seed(0))
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)
    cfg = tm.cfg
    srv = p1["server"]["blocks"]
    n_srv = cfg.num_layers - cfg.cut_layer
    assert srv["mlp"]["w_up"].shape == (n_srv, cfg.d_model, cfg.d_ff)
    torch.testing.assert_close(srv["norm1"], torch.ones_like(srv["norm1"]))
    big = p1["server"]["lm_head"]
    assert abs(big.std().item() * np.sqrt(cfg.d_model) - 1) < 0.05
    emb = p1["client"]["embed"]
    assert abs(emb.std().item() / 0.02 - 1) < 0.05
    assert abs(srv["mlp"]["w_up"].std().item() * np.sqrt(n_srv) - 1) < 0.05


def test_bridge_round_trip_is_bitwise(tmp_path):
    """repro.checkpoint.save of an init'd reduced model (bf16 override,
    so every matrix leaf is bf16) -> the port's loader: bitwise-equal
    tensors."""
    cfg = dataclasses.replace(jget(ARCH, reduced=True), dtype="bfloat16")
    jp = jbuild(cfg).init(jax.random.PRNGKey(3))
    path = str(tmp_path / "params.npz")
    jckpt.save(path, jp)
    tp = tckpt.restore(path, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    assert any(t.dtype == torch.bfloat16 for t in tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        if b.dtype == torch.bfloat16:
            assert a.dtype.name == "bfloat16"
            np.testing.assert_array_equal(
                a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(a, b.numpy())


def test_weight_bridge_defaults_to_the_card(tmp_path):
    """restore, from_numpy_tree and train_state_from_numpy put the tree
    on the card unless given device="cpu"; without a card they raise."""
    tree = {"w": np.ones((2, 3), np.float32)}
    path = str(tmp_path / "params.npz")
    jckpt.save(path, tree)
    calls = [lambda: tckpt.restore(path),
             lambda: tckpt.from_numpy_tree(tree),
             lambda: tckpt.train_state_from_numpy(tree, {"count": 0}, 0)]
    for call in calls:
        if torch.cuda.is_available():
            got = call()
            leaf = got.params["w"] if hasattr(got, "params") else got["w"]
            assert leaf.is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert tckpt.restore(path, device="cpu")["w"].device.type == "cpu"


@pytest.mark.parametrize("family_arch", ["whisper-tiny"])
def test_other_families_raise_not_implemented(family_arch):
    """The last family (audio) is ported: repro's config, copied field for
    field, builds the encoder-decoder with repro's parameter tree, and the
    registry returns it; only an arch no package registers still raises."""
    cfg = jget(family_arch, reduced=True)
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import EncDecModel
    model = tbuild(ModelConfig(**fields))
    assert isinstance(model, EncDecModel)
    jspecs = jax.tree_util.tree_leaves(
        jbuild(cfg).param_specs(), is_leaf=lambda x: hasattr(x, "axes"))
    assert [s.shape for s in tree_leaves(model.param_specs())] == \
        [s.shape for s in jspecs]
    assert dataclasses.asdict(tget(family_arch, reduced=True)) == fields
    with pytest.raises(NotImplementedError, match="not ported"):
        tget("no-such-arch")
