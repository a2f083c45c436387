"""Tensor-parallel pieces of the port (``launch.tensor_parallel`` and the
vocab-parallel B5), on the CPU.

The 4-rank runs of the engine live in ``tests/test_torch_mesh.py``
(``lm-tp-*``, ``cnn-tp-2x2``); here, in one process:

* B5's partials over 1, 2 and 4 vocab slices (``cross_entropy_partials``'
  plain version, the kernel's function), combined in slice order by
  ``combine_partials``, against the whole-vocab plain forward (nll and lse
  within 1e-6 relative: the same fp32 logits, summed in another order;
  ``correct`` exactly, also with a tie planted across a slice boundary)
  and against ``repro.kernels.ref.cross_entropy_ref`` (1e-5, as
  ``tests/test_torch_kernels_train.py`` holds B5);
* B5-bwd's plain version on a slice with -1 labels against the slice of
  the whole backward (dW exactly the slice's columns, the slices' dh
  summing to the whole dh; 1e-5 + 1e-4 relative, fp32 sums);
* the vocab-parallel autograd Function rank by rank, its collectives
  played by a fake ``model`` group;
* the hooks are the identity while no context is set;
* that ``tp`` over ``model`` accepts every family, and what the context
  computes in parallel for each layout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
import repro_torch.api as tapi
from repro_torch.configs import _MODULES as TORCH_CONFIGS
from repro_torch.configs import get_config
from repro_torch.kernels import cross_entropy as xent
from repro_torch.kernels import ops
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.distributed import ShardedPSLEngine
from repro_torch.models import build_model
from repro_torch.models.cnn import CNNConfig, CNNModel
from repro_torch.optim import sgd
from repro_torch.sharding import model_param_shardings
from torch_one_thread import one_torch_thread  # noqa: F401

REL = 1e-6
GRAD = dict(atol=1e-5, rtol=1e-4)


def _inputs(t=48, d=32, v=256, seed=0, tie_at=None):
    """h, w, labels from a numpy seed. With ``tie_at`` = c, columns c - 1
    and c hold the logit 2 exactly in every row (h[:, 0] = 2, their one
    weight 1 in that row) and the other columns' logits are N(0, 1/4)
    (none reaches 2 at these seeds: checked), so argmax takes c - 1
    everywhere; half the rows are labelled c - 1 and half c."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    if tie_at is not None:
        h[:, 0] = 2.0
        w *= np.float32(0.5)
        w[0] = 0.0
        w[:, tie_at - 1:tie_at + 1] = 0.0
        w[0, tie_at - 1:tie_at + 1] = 1.0
        labels[: t // 2] = tie_at - 1
        labels[t // 2:] = tie_at
    return torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels)


def _local(labels, v0, n):
    return torch.where((labels >= v0) & (labels < v0 + n), labels - v0,
                       torch.full_like(labels, -1))


def _combined(h, w, labels, slices):
    n = w.shape[1] // slices
    parts = torch.stack([
        xent.cross_entropy_partials_plain(
            h, w[:, r * n:(r + 1) * n], _local(labels, r * n, n), r * n)
        for r in range(slices)])
    return xent.combine_partials(parts, labels)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("slices", [1, 2, 4])
def test_partials_combined_equal_whole_vocab(slices, tie):
    h, w, labels = _inputs(tie_at=128 if tie else None)  # a slice boundary
    nll, lse, correct = _combined(h, w, labels, slices)
    pnll, plse, pcorrect = xent.cross_entropy_fwd_plain(h, w, labels)
    np.testing.assert_allclose(nll.numpy(), pnll.numpy(), rtol=REL)
    np.testing.assert_allclose(lse.numpy(), plse.numpy(), rtol=REL)
    assert torch.equal(correct, pcorrect)
    if tie:            # argmax's first index: column 127, not 128
        s = h @ w
        assert torch.equal(s[:, 127], torch.full((48,), 2.0))
        assert torch.equal(s[:, 128], s[:, 127])
        assert bool((torch.cat([s[:, :127], s[:, 129:]], 1) < 2).all())
        assert correct[:24].all() and not correct[24:].any()
    jnll = np.asarray(jref.cross_entropy_ref(
        jnp.asarray(h.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(labels.numpy())))
    np.testing.assert_allclose(nll.numpy(), jnll, atol=1e-5, rtol=1e-5)


def test_partials_planes_and_the_ops_wrapper():
    """The planes of one slice: row max, sum of exp(s - max), best logit,
    its index in the whole vocab, the label logit (0 outside); the
    ``ops`` wrapper runs the plain version on the CPU and counts no
    launch."""
    h, w, labels = _inputs()
    v0, n = 64, 64
    local = _local(labels, v0, n)
    ops.reset_launches()
    parts = ops.cross_entropy_partials(h, w[:, v0:v0 + n], local, v0)
    assert ops.launch_counts()["cross_entropy_partials"] == 0
    s = h @ w[:, v0:v0 + n]
    assert parts.shape == (5, h.shape[0]) and parts.dtype == torch.float32
    assert torch.equal(parts[xent.PART_MAX], s.amax(1))
    assert torch.equal(parts[xent.PART_BEST], s.amax(1))
    assert torch.equal(parts[xent.PART_INDEX], (s.argmax(1) + v0).float())
    np.testing.assert_allclose(
        parts[xent.PART_SUM].numpy(),
        torch.exp(s - s.amax(1, keepdim=True)).sum(1).numpy(), rtol=REL)
    inside = local >= 0
    assert inside.any() and not inside.all()
    assert torch.equal(parts[xent.PART_LABEL][~inside],
                       torch.zeros(int((~inside).sum())))
    assert torch.equal(parts[xent.PART_LABEL][inside],
                       s[inside.nonzero()[:, 0], local[inside].long()])


@pytest.mark.parametrize("slices", [2, 4])
def test_bwd_plain_with_minus_one_labels_is_the_slice_of_whole(slices):
    h, w, labels = _inputs(seed=1)
    g = torch.from_numpy(np.random.default_rng(2).uniform(
        0.1, 1.0, h.shape[0]).astype(np.float32))
    _, lse, _ = xent.cross_entropy_fwd_plain(h, w, labels)
    dh, dw = xent.cross_entropy_bwd_plain(h, w, labels, lse, g)
    n = w.shape[1] // slices
    dh_sum = torch.zeros_like(dh)
    for r in range(slices):
        local = _local(labels, r * n, n)
        assert (local < 0).any()
        dh_r, dw_r = xent.cross_entropy_bwd_plain(
            h, w[:, r * n:(r + 1) * n], local, lse, g)
        np.testing.assert_allclose(dw_r.numpy(),
                                   dw[:, r * n:(r + 1) * n].numpy(), **GRAD)
        dh_sum += dh_r
    np.testing.assert_allclose(dh_sum.numpy(), dh.numpy(), **GRAD)


class _FakeModelGroup:
    """The ``model`` group of ``size`` ranks as seen by rank ``rank``: the
    all-gather returns the partials every rank would send (their
    slices' plain partials), the all-reduce returns its input (the test
    sums the ranks' partial gradients itself, which the Function returns
    rounded from fp32: float32 here, so unrounded)."""

    def __init__(self, rank, size, h, w, labels):
        self.rank, self.size = rank, size
        self.h, self.w, self.labels = h, w, labels

    def all_gather(self, t):
        n = self.w.shape[1] // self.size
        out = torch.stack([xent.cross_entropy_partials_plain(
            self.h, self.w[:, r * n:(r + 1) * n],
            _local(self.labels, r * n, n), r * n)
            for r in range(self.size)])
        assert torch.equal(out[self.rank], t)      # this rank's own
        return out

    def all_reduce(self, t):
        return t


def test_vocab_parallel_function_rank_by_rank():
    """Each rank's forward gives the whole vocab's (nll, lse, correct);
    its backward gives its slice of dW and a part of dh, the parts
    summing to the whole dh."""
    size = 4
    h, w, labels = _inputs(seed=3)
    g = torch.from_numpy(np.random.default_rng(4).uniform(
        0.1, 1.0, h.shape[0]).astype(np.float32))
    hw = h.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    nll, lse, correct = ops.cross_entropy(hw, ww, labels)
    dh, dw = torch.autograd.grad((nll * g).sum(), (hw, ww))
    n = w.shape[1] // size
    dh_sum = torch.zeros_like(dh)
    for r in range(size):
        group = _FakeModelGroup(r, size, h, w, labels)
        hr = h.clone().requires_grad_(True)
        wr = w[:, r * n:(r + 1) * n].clone().requires_grad_(True)
        out = tp.VocabParallelCrossEntropy.apply(hr, wr, labels, group)
        np.testing.assert_allclose(out[0].detach().numpy(),
                                   nll.detach().numpy(), rtol=REL)
        np.testing.assert_allclose(out[1].numpy(), lse.numpy(), rtol=REL)
        assert torch.equal(out[2], correct)
        dh_r, dw_r = torch.autograd.grad((out[0] * g).sum(), (hr, wr))
        np.testing.assert_allclose(dw_r.numpy(),
                                   dw[:, r * n:(r + 1) * n].numpy(), **GRAD)
        dh_sum += dh_r
    np.testing.assert_allclose(dh_sum.numpy(), dh.numpy(), **GRAD)


def test_hooks_are_identity_without_context():
    assert tp.active() is None
    x = torch.randn(2, 3, 8)
    for part in ("attn", "mlp"):
        assert tp.column_parallel(part) is torch.matmul
        assert tp.row_parallel(part) is torch.matmul
    p = {"wq": torch.randn(8, 8), "wk": torch.randn(8, 4)}
    assert tp.attention_params(p) is p
    table = torch.randn(16, 8)
    tokens = torch.tensor([[0, 5, 15]])
    assert torch.equal(tp.embed(table, tokens), table[tokens])
    h, w, labels = _inputs()
    for a, b in zip(tp.cross_entropy(h, w, labels),
                    ops.cross_entropy(h, w, labels)):
        assert torch.equal(a, b)


def _model(arch):
    if arch in ("cnn", "paper-cnn"):
        return CNNModel(CNNConfig(channels=(8, 16), image_size=16))
    return build_model(get_config(arch, reduced=True))


@pytest.mark.parametrize("arch", sorted(TORCH_CONFIGS))
def test_tp_over_model_accepts_or_refuses_each_family(arch):
    """Every family (dense, moe, vlm, ssm, hybrid, audio and the cnn)
    reaches the mesh, which needs 4 ranks (one is running), on either
    lowering: none is refused any more. ``ExecutionSpec`` knows no
    family and accepts tp on 2x2."""
    model = _model(arch)
    tapi.ExecutionSpec(mesh="2x2").validate()
    for lowering in ("gspmd", "shard_map"):
        with pytest.raises(ValueError, match="needs 4 ranks"):
            ShardedPSLEngine(model, sgd(1e-3), mesh="2x2", profile="tp",
                             lowering=lowering, device="cpu")


class _FakeMesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")


class _FakeComm:
    def __init__(self, data, model, rank):
        self.sizes = {"data": data, "model": model}
        self.coord = {"data": 0, "model": rank}


def _context(arch, data, model, rank=0, reduced=True):
    m = build_model(get_config(arch, reduced=reduced))
    layouts = model_param_shardings(m, _FakeMesh(data, model), profile="tp")
    return tp.TensorParallel(m, layouts, _FakeComm(data, model, rank)), \
        layouts


@pytest.mark.parametrize("case", [
    # (arch, reduced, data, model, heads, kv heads of rank 1, ff,
    #  embed vocab, head vocab)
    ("granite-3-2b", True, 2, 2, True, None, True, True, True),
    ("granite-3-2b", True, 1, 4, True, (0, 1), True, True, True),
    ("granite-3-2b", False, 1, 2, True, None, True, False, False),
    ("llama3-8b", False, 1, 2, True, None, True, True, True),
    ("qwen2-72b", True, 2, 2, True, None, True, True, True),
    ("internvl2-2b", False, 1, 4, True, None, True, False, False),
])
def test_context_splits_what_the_layouts_split(case):
    """What the context computes in parallel, and each leaf's mode: the
    q heads' leaves and the MLP's local, kv local where its heads divide
    (else "partial", sliced to the rank's q heads), a split vocab local,
    a replicated one (granite's 49,155, internvl2's 92,553) whole, norms
    whole."""
    arch, reduced, data, model, heads, kv1, ff, emb, head = case
    ctx, layouts = _context(arch, data, model, rank=1, reduced=reduced)
    assert (ctx.heads, ctx.kv_heads, ctx.ff, ctx.embed_vocab,
            ctx.head_vocab) == (heads, kv1, ff, emb, head)
    modes = dict(zip([".".join(p) for p in tp._paths(layouts)], ctx.modes))
    for stack in ("client", "server"):
        pre = f"{stack}.blocks."
        for name in ("wq", "wo") + (("bq",) if f"{pre}attn.bq" in modes
                                    else ()):
            assert modes[f"{pre}attn.{name}"] == "local"
        for name in ("wk", "wv"):
            assert modes[f"{pre}attn.{name}"] == (
                "partial" if kv1 else "local")
        for name in ("w_gate", "w_up", "w_down"):
            assert modes[f"{pre}mlp.{name}"] == "local"
        assert modes[f"{pre}norm1"] == modes[f"{pre}norm2"] == "whole"
    assert modes["client.embed"] == ("local" if emb else "whole")
    assert modes["server.lm_head"] == ("local" if head else "whole")
    assert modes["server.final_norm"] == "whole"
    # the kv heads of each rank's q heads (granite reduced: 8 q over 2 kv)
    if kv1:
        assert [_context(arch, data, model, r)[0].kv_heads
                for r in range(model)] == [(0, 1), (0, 1), (1, 2), (1, 2)]
