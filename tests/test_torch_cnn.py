"""The port's paper CNN (GroupNorm ResNet) against repro's, on the CPU.

Parameters come from ``repro``'s init through the weights bridge
(``from_numpy_tree``; the two packages' init draws differ). Inputs are
made from a seed with numpy. Tolerances, float32:
- logits and loss: rtol/atol 1e-5 (one reduction order against another);
- gradients, per leaf: max |port − repro| <= 3e-4 · max |repro|, as in
  ``test_torch_train.py``;
- the convolution alone against ``jax.lax.conv_general_dilated``: atol
  1e-4 on values of magnitude ~10 (sums of up to 72 products);
- checkpoints and configs: bitwise.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs import get_config as jget
from repro.core import psl as jpsl
from repro.models import cnn as jcnn
from repro_torch.checkpoint import from_numpy_tree, restore, save
from repro_torch.configs import get_config as tget
from repro_torch.core import psl as tpsl
from repro_torch.models import cnn as tcnn
from repro_torch.models.layers import tree_leaves
from torch_one_thread import one_torch_thread  # noqa: F401

GRAD_REL = 3e-4
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(reduced=True, **over):
    jc, tc = jget("paper-cnn", reduced), tget("paper-cnn", reduced)
    if over:
        jc, tc = dataclasses.replace(jc, **over), \
            dataclasses.replace(tc, **over)
    return jcnn.CNNModel(jc), tcnn.CNNModel(tc)


def _batch(size, n=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, n)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    weights[-2:] = 0.0                               # padding slots
    jb = {"images": jnp.asarray(images),
          "labels": jnp.asarray(labels, jnp.int32),
          "weights": jnp.asarray(weights)}
    tb = {"images": torch.tensor(images), "labels": torch.tensor(labels),
          "weights": torch.tensor(weights)}
    return jb, tb


@pytest.fixture(scope="module")
def bridged():
    jm, tm = _models()
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tpsl.requires_grad_(from_numpy_tree(jax.device_get(jp), "cpu"))
    return jm, tm, jp, tp


def _assert_grads_close(tg, jg):
    jl = jax.tree_util.tree_leaves(jg)
    tl = tree_leaves(tg)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        assert a.shape == b.shape
        err = np.abs(a.detach().numpy() - b).max()
        assert err <= GRAD_REL * np.abs(b).max(), (err, np.abs(b).max())


# ---------------------------------------------------------------------------
# Configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False])
def test_configs_and_param_specs_equal_repro(reduced):
    jm, tm = _models(reduced)
    j, t = dataclasses.asdict(jm.cfg), dataclasses.asdict(tm.cfg)
    assert j == t
    jspecs = jax.tree_util.tree_flatten_with_path(
        jm.param_specs(), is_leaf=lambda x: hasattr(x, "axes"))[0]
    tspecs = tree_leaves(tm.param_specs())
    assert len(jspecs) == len(tspecs)
    for (path, js), ts in zip(jspecs, tspecs):
        assert (js.shape, js.init, js.axes) == (ts.shape, ts.init,
                                                ts.axes), path
    # the bridged tree has repro's structure: keys, block lists, HWIO
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda s: 0, jm.param_specs(),
            is_leaf=lambda x: hasattr(x, "axes")))


def test_init_statistics_follow_repros_rule():
    """A fan-in scaled leaf takes shape[0] of its HWIO shape: std 1/√3
    for a 3×3 conv, 1 for the 1×1 projection, 1/√512 for the head."""
    _, tm = _models(reduced=False)
    gen = torch.Generator().manual_seed(0)
    p = tm.init(gen)
    stage = p["server"]["stages"][0][0]
    cases = [(p["client"]["stem"], 1 / math.sqrt(3)),
             (stage["conv1"], 1 / math.sqrt(3)),
             (stage["conv2"], 1 / math.sqrt(3)),
             (stage["proj"], 1.0),
             (p["server"]["head"], 1 / math.sqrt(512))]
    for leaf, std in cases:
        assert leaf.dtype == torch.float32
        assert abs(leaf.std().item() / std - 1) < 0.03, (leaf.shape, std)
        assert abs(leaf.mean().item()) < 0.03 * std
    assert torch.equal(stage["gn1"]["scale"], torch.ones(128))
    assert torch.equal(stage["gn1"]["bias"], torch.zeros(128))
    assert torch.equal(p["server"]["head_b"], torch.zeros(10))
    again = tm.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_is_bitwise(tmp_path, dtype):
    """repro save -> port restore -> port save -> repro restore."""
    jm, _ = _models(dtype=dtype)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    jsave(str(tmp_path / "a.npz"), jp)
    tp = restore(str(tmp_path / "a.npz"), device="cpu")
    assert isinstance(tp["client"]["stages"], list)
    assert tp["client"]["stem"].dtype == getattr(torch, dtype)
    save(str(tmp_path / "b.npz"), tp)
    back = jrestore(str(tmp_path / "b.npz"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# The traps: XLA's SAME padding, group counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [16, 15, 8, 7])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2), (1, 1)])
def test_conv_pads_like_xla_same(size, k, stride):
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.normal(size=(2, size, size, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 8, 6)).astype(np.float32)
    want = np.asarray(jcnn.conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tcnn.conv(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w),
                    stride).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_symmetric_padding_is_not_xla_same_at_stride_2():
    """The trap the port's padding avoids: ``padding=1`` at stride 2 on an
    even size pads (1, 1) where XLA pads (0, 1)."""
    assert tcnn.same_padding(16, 3, 2) == (0, 1)
    assert tcnn.same_padding(15, 3, 2) == (1, 1)
    assert tcnn.same_padding(16, 1, 2) == (0, 0)
    assert tcnn.same_padding(16, 3, 1) == (1, 1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8, 8)).astype(np.float32)
    want = np.asarray(jcnn.conv(jnp.asarray(x), jnp.asarray(w), 2))
    sym = torch.nn.functional.conv2d(
        torch.tensor(x).permute(0, 3, 1, 2),
        torch.tensor(w).permute(3, 2, 0, 1), stride=2, padding=1)
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1.0


@pytest.mark.parametrize("c,groups", [(12, 8), (10, 4), (6, 32), (64, 32)])
def test_group_norm_group_count_matches_repro(c, groups):
    """``group_size`` is a group count, lowered until it divides c."""
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(3, 5, 5, c)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=c).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32)}
    want = np.asarray(jcnn.group_norm(jnp.asarray(x),
                                      {k: jnp.asarray(v)
                                       for k, v in p.items()}, groups))
    got = tcnn.group_norm(torch.tensor(x).permute(0, 3, 1, 2),
                          {k: torch.tensor(v) for k, v in p.items()},
                          groups).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    g = tcnn.num_groups(c, groups)
    assert c % g == 0 and g <= min(groups, c)


# ---------------------------------------------------------------------------
# Forward, loss, metrics and gradients against repro
# ---------------------------------------------------------------------------

def test_logits_loss_metrics_and_grads_match_repro(bridged):
    jm, tm, jp, tp = bridged
    jb, tb = _batch(jm.cfg.image_size)
    np.testing.assert_allclose(
        tm.predict(tp, tb["images"]).detach().numpy(),
        np.asarray(jm.predict(jp, jb["images"])), **TOL)
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
    (tl, tmet), tg = tpsl.value_and_grad(tm.loss_fn, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    assert float(tmet["tokens"]) == float(np.asarray(jb["weights"]).sum())
    _assert_grads_close(tg, jg)


def test_decomposed_protocol_matches_repro_and_the_fused_step(bridged):
    jm, tm, jp, tp = bridged
    jb, tb = _batch(jm.cfg.image_size, seed=1)
    jloss, jgrads, jcut = jpsl.decomposed_grads(jm, jp, jb)
    tloss, tgrads, tcut = tpsl.decomposed_grads(tm, tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    # the port's cut activations are NCHW; repro's NHWC
    np.testing.assert_allclose(tcut.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jcut), **TOL)
    _assert_grads_close(tgrads, jgrads)
    _, fused = tpsl.value_and_grad(tm.loss_fn, tp, tb)
    for a, b in zip(tree_leaves(tgrads), tree_leaves(fused)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_sgd_step_on_the_cnn_matches_repro(bridged):
    """One fused SGD step from bridged parameters: loss and updated
    parameters within fp32 tolerance of repro's jitted step."""
    from repro import optim as joptim
    from repro_torch import optim as toptim
    from repro_torch.models.layers import tree_map
    jm, tm, jp, tp = bridged
    jb, tb = _batch(jm.cfg.image_size, seed=2)
    jopt = joptim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    jstate = joptim.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jstate, jmet = jax.jit(jpsl.make_train_step(jm, jopt))(jstate, jb)
    params = tpsl.requires_grad_(tree_map(lambda p: p.detach().clone(),
                                          tp))
    topt = toptim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    tstate = toptim.TrainState(params, topt.init(params), 0)
    tstate, tmet = tpsl.make_train_step(tm, topt)(tstate, tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               **TOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    for a, b in zip(tree_leaves(tstate.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)
