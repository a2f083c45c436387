"""The audio family's training path against repro, on the CPU: the loss
of reduced whisper-tiny and the literal PSL protocol (``decomposed_grads``)
with the cut at the encoder output. Split from ``test_torch_audio.py``
(whose parameters, batches and tolerances it shares) to keep each file
short under ``--dist loadfile``.
"""
import jax
import numpy as np

from repro.core import psl as jpsl
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import psl as tpsl
from repro_torch.models.layers import tree_leaves
from test_torch_audio import (GRAD_REL, LOSS_RTOL, MODEL_ATOL, _batch,
                              _close, pair)  # noqa: F401  (fixture)
from torch_one_thread import one_torch_thread  # noqa: F401


def test_loss_fn_matches_repro(pair):
    jm, tm, jp, tp = pair
    jb, tb = _batch(jm.cfg)
    jl, jmet = jm.loss_fn(jp, jb)
    tl, tmet = tm.loss_fn(tp, tb)
    assert sorted(tmet) == sorted(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert float(tmet["aux_loss"]) == 0.0


def test_decomposed_grads_match_repro(pair):
    """The literal PSL protocol with the cut at the encoder output: loss,
    cut activations (the encoder states) and every leaf's gradient, the
    client's encoder blocks' through the cut, against repro's."""
    jm, tm, jp, tp = pair
    jb, tb = _batch(jm.cfg)
    jl, jg, jcut = jpsl.decomposed_grads(jm, jp, jb)
    tl, tg, tcut = tpsl.decomposed_grads(
        tm, tpsl.requires_grad_(from_numpy_tree(jp, "cpu")), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _close(tcut, jcut, MODEL_ATOL)
    assert sorted(tg["client"]) == ["enc_blocks", "enc_norm", "enc_pos"]
    tleaves, jleaves = tree_leaves(tg), jax.tree_util.tree_leaves(jg)
    assert len(tleaves) == len(jleaves)
    for got, want in zip(tleaves, jleaves):
        got = got.detach().double().numpy()
        want = np.asarray(want, np.float64)
        assert got.shape == want.shape
        scale = np.abs(want).max()
        assert scale > 0, want.shape
        assert np.abs(got - want).max() <= GRAD_REL * scale, want.shape
        assert np.linalg.norm(got - want) <= GRAD_REL * np.linalg.norm(want)
    assert tpsl.cut_transfer_bytes(tm, tb) == jpsl.cut_transfer_bytes(jm, jb)
