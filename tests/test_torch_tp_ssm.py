"""Tensor-parallel Mamba mixers (``launch.tensor_parallel``'s
``mixer_params``, ``mixer_hooks`` and ``SumOverModel``) on the CPU, in
one process.

Reduced falcon-mamba-7b (Mamba-1) and zamba2-2.7b (Mamba-2) in float32.
A layer's mixer leaves and its input are drawn from a numpy seed. M in
{2, 4} ranks of a ``1xM`` mesh are played by M threads that share a
``model`` group (``_ThreadGroup``: an all-reduce sums every rank's tensor
in rank order), so every sum over ranks is taken where the engine's comm
takes it. Each rank holds what the engine gives it: its stored block of
a "local" leaf, the whole leaf of a "partial" one. Limits:

- each rank's output and input gradient, the local leaves' gradients
  put together and the partial leaves' gradients summed over the ranks
  against the whole ``mamba1_apply`` / ``mamba2_apply`` (no context):
  within 1e-6 of each tensor's largest entry (the same fp32 products,
  summed over ranks in another order);
- the whole mixer against ``repro``'s: the output at
  ``tests/test_torch_hybrid.py``'s 2e-5 of its largest entry, every
  gradient within ``tests/test_torch_archs.py``'s 3e-4 of the leaf's
  largest entry and of its L2 norm;
- the bytes each rank all-reduces: ``chip_smoke.py``'s prediction for a
  Mamba layer (``tp_mixer_all_reduce_bytes``), exactly.

It also holds the leaf modes of both configs on 2x2 and 1x4, catches the
two layout traps (a norm over the rank's channels alone; Mamba-1's
in_proj cut by its stored block, x's columns on rank 0 and z's on rank 1
at M = 2) at the same limit, and refuses a config whose heads do not
split into whole heads a rank.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro_torch.configs import get_config as tget
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.sharding import block_slices, model_param_shardings
from torch_one_thread import one_torch_thread  # noqa: F401

ARCHS = {"mamba1": "falcon-mamba-7b", "mamba2": "zamba2-2.7b"}
REL = 1e-6
MIXER_ATOL = 2e-5                # tests/test_torch_hybrid.py's
GRAD_REL = 3e-4                  # tests/test_torch_archs.py's
SHAPE = (2, 13)                  # batch, sequence


class _FakeMesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")


class _FakeComm:
    def __init__(self, data, model, rank):
        self.sizes = {"data": data, "model": model}
        self.coord = {"data": 0, "model": rank}


class _ThreadGroup:
    """The ``model`` group of ``size`` ranks played by threads: an
    all-reduce waits for every rank's tensor and gives each the same sum,
    taken in rank order."""

    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=60)
        self.slots = [None] * size

    def all_reduce(self, rank, t):
        self.slots[rank] = t.clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for part in self.slots[1:]:
            total += part
        self.barrier.wait()
        return t.copy_(total)


class _RankComm(_FakeComm):
    """A rank's ``MeshComm`` on a 1xM mesh: the all-reduce over ``model``
    through the thread group, its bytes counted."""

    def __init__(self, group, rank):
        super().__init__(1, group.size, rank)
        self.group, self.bytes = group, 0

    def all_reduce(self, t, axes):
        assert tuple(axes) == ("model",)
        self.bytes += t.numel() * t.element_size()
        return self.group.all_reduce(self.coord["model"], t)


def _cfg(variant, **changes):
    cfg = tget(ARCHS[variant], reduced=True)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def _draw(cfg, seed=0):
    """One layer's mixer leaves (numpy, float32) at the scales of a
    trained layer: products at fan-in d_in, the conv and dt biases
    drawn, A's log(1..N) jittered, D and the norm's weight near 1."""
    rng = np.random.default_rng(seed)
    specs = (TL.mamba2_specs if cfg.ssm_variant == "mamba2"
             else TL.mamba1_specs)(cfg)
    out = {}
    for name in sorted(specs):
        shape = specs[name].shape
        if name == "a_log":
            base = np.log(np.arange(1, shape[-1] + 1)) if len(shape) > 1 \
                else np.log(np.arange(1, shape[0] + 1))
            v = base + 0.1 * rng.standard_normal(shape)
        elif name in ("d_skip", "norm_w"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("conv_b", "dt_bias"):
            v = (0.02 if name == "conv_b" else 0.5) * \
                rng.standard_normal(shape)
        elif name == "conv_w":
            v = 0.5 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        out[name] = v.astype(np.float32)
    return out


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE + (cfg.d_model,)).astype(np.float32)
    dy = rng.standard_normal(SHAPE + (cfg.d_model,)).astype(np.float32)
    return x, dy


def _mixer(cfg):
    return TL.mamba2_apply if cfg.ssm_variant == "mamba2" else \
        TL.mamba1_apply


def _whole(cfg, params, x, dy):
    """The mixer with no context: (y, dx, {leaf: gradient})."""
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = _mixer(cfg)(leaves, xt, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                                [xt] + [leaves[k] for k in sorted(leaves)])
    return y.detach(), grads[0], dict(zip(sorted(leaves), grads[1:]))


def _layouts(cfg, data, model):
    m = build_model(cfg)
    layouts = model_param_shardings(m, _FakeMesh(data, model), profile="tp")
    return m, layouts


def _ranks(cfg, params, x, dy, size, planted=None):
    """Play ``size`` ranks of a 1x``size`` mesh on the mixer: per rank
    (y, dx, {leaf: gradient of what the rank holds}, modes by leaf, its
    all-reduce bytes). ``planted`` (rank, leaves, hooks) -> (leaves,
    hooks) changes what a rank computes with."""
    model, layouts = _layouts(cfg, 1, size)
    mixer_lay = layouts["client"]["blocks"]["mixer"]
    group = _ThreadGroup(size)
    sizes = {"data": 1, "model": size}
    jobs, out, errors = [], [None] * size, []
    for r in range(size):
        comm = _RankComm(group, r)
        ctx = tp.TensorParallel(model, layouts, comm)
        modes = dict(zip([".".join(p) for p in tp._paths(layouts)],
                         ctx.modes))
        mode = {k: modes[f"client.blocks.mixer.{k}"] for k in params}
        held = {}
        for k, v in params.items():
            whole = torch.from_numpy(v)
            if mode[k] == "local":
                whole = whole[block_slices(whole.shape, mixer_lay[k][1:],
                                           sizes, comm.coord)]
            held[k] = whole.clone().requires_grad_(True)
        prev = tp.set_tensor_parallel(ctx)
        try:
            leaves, hooks = tp.mixer_params(held, cfg), tp.mixer_hooks(cfg)
        finally:
            tp.set_tensor_parallel(prev)
        if planted is not None:
            leaves, hooks = planted(r, held, leaves, hooks)
        jobs.append((r, comm, held, leaves, hooks, mode))

    def run(r, comm, held, leaves, hooks, mode):
        try:
            xt = torch.from_numpy(x).requires_grad_(True)
            y = _mixer(cfg)(leaves, xt, cfg, **hooks)
            grads = torch.autograd.grad(
                (y * torch.from_numpy(dy)).sum(),
                [xt] + [held[k] for k in sorted(held)])
            out[r] = (y.detach(), grads[0],
                      dict(zip(sorted(held), grads[1:])), mode, comm.bytes)
        except BaseException as e:       # noqa: BLE001 - re-raised below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, mixer_lay


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def _worst(cfg, ranks, mixer_lay, whole) -> float:
    """The largest error, relative to each tensor's largest entry, of the
    ranks' outputs, input gradients and put-together leaf gradients
    against the whole mixer's."""
    y, dx, grads = whole
    size = len(ranks)
    worst = max(max(_rel(r[0], y), _rel(r[1], dx)) for r in ranks)
    for k, g in grads.items():
        mode = ranks[0][3][k]
        got = torch.zeros_like(g)
        for rank, (_, _, gr, _, _) in enumerate(ranks):
            if mode == "local":
                got[block_slices(g.shape, mixer_lay[k][1:],
                                 {"data": 1, "model": size},
                                 {"data": 0, "model": rank})] = gr[k]
            else:
                got += gr[k]
        worst = max(worst, _rel(got, g))
    return worst


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def predicted_bytes(cfg, tokens: int) -> int:
    """A Mamba layer's all-reduce bytes a rank, as ``chip_smoke.py``
    predicts them (``tp_mixer_all_reduce_bytes`` for one layer, no
    attention, the vocab whole)."""
    return _chip_smoke().tp_mixer_all_reduce_bytes(cfg, tokens, 1, 0, False,
                                                   4)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_ranks_sum_to_the_whole_mixer(variant, size):
    cfg = _cfg(variant)
    params = _draw(cfg)
    x, dy = _inputs(cfg)
    whole = _whole(cfg, params, x, dy)
    ranks, mixer_lay = _ranks(cfg, params, x, dy, size)
    assert _worst(cfg, ranks, mixer_lay, whole) <= REL
    # every rank reads the same output, and all-reduced the predicted bytes
    for r in ranks[1:]:
        assert torch.equal(r[0], ranks[0][0])
    want_bytes = predicted_bytes(cfg, SHAPE[0] * SHAPE[1])
    assert [r[4] for r in ranks] == [want_bytes] * size


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_whole_mixer_matches_repro(variant):
    """The reference the ranks are held to, against repro's mixer: the
    output and the gradients of x and of every leaf."""
    cfg = _cfg(variant)
    params = _draw(cfg)
    x, dy = _inputs(cfg)
    y, dx, grads = _whole(cfg, params, x, dy)
    jcfg = jget(ARCHS[variant], reduced=True)
    japply = JL.mamba2_apply if variant == "mamba2" else JL.mamba1_apply
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def loss(p, xx):
        out = japply(p, xx, jcfg)
        return jnp.sum(out * jnp.asarray(dy)), out
    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
    np.testing.assert_allclose(y.numpy() / scale, np.asarray(jy) / scale,
                               atol=MIXER_ATOL, rtol=0)
    for got, want in [(dx, jgx)] + [(grads[k], jgp[k]) for k in sorted(jgp)]:
        got = got.double().numpy()
        want = np.asarray(want, np.float64)
        assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max()
        assert np.linalg.norm(got - want) <= GRAD_REL * np.linalg.norm(want)


def test_norm_over_local_channels_alone_is_caught():
    """Trap 5: Mamba-2's RMSNorm over the rank's channels alone (the
    one-card norm on a rank's slice) runs, and fails the 1e-6 limit."""
    cfg = _cfg("mamba2")
    params = _draw(cfg)
    x, dy = _inputs(cfg)
    whole = _whole(cfg, params, x, dy)

    def local_norm(r, held, leaves, hooks):
        return leaves, dict(hooks, norm=TL.rms_norm)
    ranks, mixer_lay = _ranks(cfg, params, x, dy, 2, planted=local_norm)
    assert _worst(cfg, ranks, mixer_lay, whole) > 1e3 * REL


def test_in_proj_cut_by_its_stored_block_is_caught():
    """Trap 1: Mamba-1's in_proj stores x then z, so on two ranks rank 0's
    stored block is all of x and rank 1's all of z; a rank that computes
    with its stored block runs, and fails the 1e-6 limit."""
    cfg = _cfg("mamba1")
    params = _draw(cfg)
    x, dy = _inputs(cfg)
    whole = _whole(cfg, params, x, dy)
    di = cfg.d_inner

    def stored_block(r, held, leaves, hooks):
        cols = slice(r * di, (r + 1) * di)
        return dict(leaves, in_proj=held["in_proj"][:, cols]), hooks
    ranks, mixer_lay = _ranks(cfg, params, x, dy, 2, planted=stored_block)
    assert _worst(cfg, ranks, mixer_lay, whole) > 1e3 * REL


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_mixer_leaf_modes(variant, mesh):
    """Mamba-1: in_proj partial, every other mixer leaf local; Mamba-2:
    in_proj, the conv and the per-head leaves partial, norm_w and
    out_proj local; the block norms, final norm whole; the split vocab
    local; the hybrid's shared attention heads local. Each rank's
    channels (and Mamba-2 heads) are its contiguous share."""
    cfg = _cfg(variant)
    data, size = mesh
    model, layouts = _layouts(cfg, data, size)
    partial = (tp.MAMBA2_PARTIAL if variant == "mamba2" else ("in_proj",))
    for rank in range(size):
        ctx = tp.TensorParallel(model, layouts, _FakeComm(data, size, rank))
        width = cfg.d_inner // size
        assert ctx.channels == (rank * width, (rank + 1) * width)
        nh = cfg.ssm_num_heads // size
        assert ctx.ssm_heads == ((rank * nh, (rank + 1) * nh)
                                 if variant == "mamba2" else None)
        modes = dict(zip([".".join(p) for p in tp._paths(layouts)],
                         ctx.modes))
        mixers = [k for k in modes if ".mixer." in k]
        assert mixers
        for k in mixers:
            assert modes[k] == ("partial" if k.split(".")[-1] in partial
                                else "local"), k
        for k, mode in modes.items():
            if k.endswith("norm") or k.endswith("norm1") \
                    or k == "server.final_norm":
                assert mode == "whole", k
            if ".attn." in k:
                assert ctx.heads and mode == "local", k
        assert modes["client.embed"] == modes["server.lm_head"] == "local"
    assert tp.active() is None


def test_mixer_hooks_are_identity_without_context():
    cfg = _cfg("mamba2")
    p = {k: torch.from_numpy(v) for k, v in _draw(cfg).items()}
    assert tp.active() is None
    assert tp.mixer_params(p, cfg) is p
    assert tp.mixer_hooks(cfg) == {}


@pytest.mark.parametrize("variant,change,size,match", [
    ("mamba2", dict(ssm_head_dim=128), 4,
     "2 Mamba-2 heads do not split into 4"),
    ("mamba1", {}, 3, "d_inner 256 does not split into 3"),
])
def test_mixer_that_does_not_split_raises(variant, change, size, match):
    """Whole heads a rank (Mamba-2: 2 heads of 128 over 4 ranks) and whole
    stored blocks (d_inner 256 over 3 ranks, which the layout leaves
    whole) or NotImplementedError, naming the config and the mesh."""
    cfg = _cfg(variant, **change)
    model, layouts = _layouts(cfg, 1, size)
    with pytest.raises(NotImplementedError,
                       match=f"{cfg.name} on a mesh with model={size}.*"
                             f"{match}"):
        tp.TensorParallel(model, layouts, _FakeComm(1, size, 0))
