"""Tensor-parallel MoE and audio (``launch.tensor_parallel``'s
``ExpertParallel``, ``moe_hooks`` and the whisper hooks) and the MoE
dispatch over batch shards (``layers.BatchShards``) on the CPU, in one
process.

Reduced granite-moe-3b-a800m (4 experts top-2, capacity factor 1.25),
llama4-scout-17b-a16e (4 experts top-1 and a shared expert) and
whisper-tiny (4 heads, vocab 512), in float32, their leaves and inputs
drawn from a numpy seed at fan-in d_in scale. M in {2, 4} ranks of a
``1xM`` mesh are played by M threads that share a ``model`` group
(``test_torch_tp_ssm``'s ``_ThreadGroup``: an all-reduce sums every
rank's tensor in rank order); the context is per thread, so each thread
sets its own rank's. Each rank holds what the engine gives it: its
stored block of a "local" leaf, the whole leaf of a "whole" one.
Limits:

- each rank's output, aux loss and input gradient, the local leaves'
  gradients put together and the whole leaves' gradients on every rank
  against the whole ``moe_apply`` (no context), and whisper's loss and
  every leaf's gradient against the whole model's: within 1e-6 of each
  tensor's largest entry (the same fp32 products, summed over ranks in
  another order);
- the bytes each rank all-reduces: ``chip_smoke.py``'s predictions
  (``tp_moe_all_reduce_bytes``, ``tp_audio_all_reduce_bytes``), exactly.

The three MoE traps each fail that limit: a foreign assignment clamped
into a local slot, the aux loss's share of the router gradient counted
on every rank (the gate gradient left partial, the router summed over
the ranks), rank 0 skipping the combine's sum. The dispatch over batch
shards (S threads, each a contiguous block of the tokens, the counts
all-gathered in rank order) equals one dispatch over every token at
factor 1.25, where dispatching each shard alone drops other assignments;
and the engine's microbatch grouping (each rank's m-th slice) is pinned
against ``repro``'s contiguous blocks, which it differs from
(``ROADMAP.md`` C).
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding import block_slices, model_param_shardings
from test_torch_tp_ssm import _chip_smoke, _FakeComm, _FakeMesh, _ThreadGroup
from torch_one_thread import one_torch_thread  # noqa: F401

MOE = {"granite": "granite-moe-3b-a800m", "llama4": "llama4-scout-17b-a16e"}
AUDIO = "whisper-tiny"
REL = 1e-6
SHAPE = (4, 12)                  # batch, sequence (48 tokens)
AUDIO_SHAPE = (2, 8)             # batch, decoder tokens (64 frames a row)


class _Comm(_FakeComm):
    """A rank's ``MeshComm`` on a 1xM mesh: the all-reduce over ``model``
    through the thread group, its bytes counted."""

    def __init__(self, group, rank):
        super().__init__(1, group.size, rank)
        self.group, self.bytes = group, 0

    def all_reduce(self, t, axes):
        assert tuple(axes) == ("model",)
        self.bytes += t.numel() * t.element_size()
        return self.group.all_reduce(self.coord["model"], t)

    def all_gather(self, t, axes):
        assert tuple(axes) == ("model",)
        return _gather(self.group, self.coord["model"], t)


def _gather(group, rank, t):
    """All-gather over the thread group: (size, *t.shape) in rank order."""
    group.slots[rank] = t.clone()
    group.barrier.wait()
    out = torch.stack(list(group.slots))
    group.barrier.wait()
    return out


def _threads(size, run):
    """Run ``run(rank)`` on ``size`` threads; re-raise the first error."""
    out, errors = [None] * size, []
    group = _ThreadGroup(size)

    def body(r):
        try:
            out[r] = run(r, group)
        except BaseException as e:       # noqa: BLE001 - re-raised below
            errors.append(e)
            group.barrier.abort()
    threads = [threading.Thread(target=body, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def _draw(specs, seed):
    """A numpy tree of ``specs``' shapes: matrices at std 1/sqrt(d_in),
    vectors (norms near 1, biases) at std 0.02 around their init."""
    rng = np.random.default_rng(seed)

    def one(spec):
        shape = spec.shape
        if spec.init == "ones":
            v = 1.0 + 0.02 * rng.standard_normal(shape)
        elif len(shape) == 1 or spec.init in ("zeros", "embed"):
            v = 0.02 * rng.standard_normal(shape)
            if spec.init == "embed":
                v = v * 50
        else:
            v = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return v.astype(np.float32)
    return tree_map(one, specs)


# ---------------------------------------------------------------------------
# The MoE layer, experts over model
# ---------------------------------------------------------------------------

def _moe_cfg(name, **changes):
    cfg = get_config(MOE[name], reduced=True)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def _moe_inputs(cfg, seed=1, shape=SHAPE):
    """x with a common component (routing skewed: factor 1.25 drops
    assignments) and the output's cotangent."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape + (cfg.d_model,))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    return x, dy


def _moe_whole(cfg, params, x, dy):
    """``moe_apply`` with no context: (y, aux, dx, {leaf: gradient}) of
    sum(y * dy) + aux."""
    leaves = tree_map(lambda v: torch.from_numpy(v).requires_grad_(True),
                      params)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TL.moe_apply(leaves, xt, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux,
                                [xt] + tree_leaves(leaves))
    return y.detach(), aux.detach(), grads[0], grads[1:]


def _moe_layouts(cfg, data, model):
    m = build_model(cfg)
    layouts = model_param_shardings(m, _FakeMesh(data, model), profile="tp")
    return m, layouts


def _moe_ranks(cfg, params, x, dy, size, planted=None):
    """Play ``size`` ranks on the MoE layer: per rank (y, aux, dx, leaf
    gradients of what the rank holds, modes, all-reduce bytes).
    ``planted(rank, hooks)`` changes a rank's hooks."""
    model, layouts = _moe_layouts(cfg, 1, size)
    moe_lay = tree_map(lambda lay: lay[1:],
                       layouts["client"]["blocks"]["moe"])
    paths = [".".join(p) for p in tp._paths(layouts)]
    sizes = {"data": 1, "model": size}

    def run(r, group):
        comm = _Comm(group, r)
        ctx = tp.TensorParallel(model, layouts, comm)
        modes = dict(zip(paths, ctx.modes))
        names = [".".join(p) for p in tp._paths(moe_lay)]
        mode = [modes[f"client.blocks.moe.{n}"] for n in names]
        held = []
        for v, lay, md in zip(tree_leaves(params), tree_leaves(moe_lay),
                              mode):
            whole = torch.from_numpy(v)
            if md == "local":
                whole = whole[block_slices(whole.shape, lay, sizes,
                                           comm.coord)]
            held.append(whole.clone().requires_grad_(True))
        leaves = tree_unflatten(params, held)
        prev = tp.set_tensor_parallel(ctx)
        try:
            hooks = tp.moe_hooks()
            if planted is not None:
                hooks = planted(r, hooks)
            xt = torch.from_numpy(x).requires_grad_(True)
            y, aux = TL.moe_apply(leaves, xt, cfg, **hooks)
        finally:
            tp.set_tensor_parallel(prev)
        grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux,
                                    [xt] + held)
        return (y.detach(), aux.detach(), grads[0], grads[1:], mode,
                comm.bytes)
    return _threads(size, run), moe_lay


def _moe_worst(ranks, moe_lay, whole, summed=()) -> float:
    """The largest error of the ranks' outputs, aux, input gradients and
    put-together leaf gradients against the whole layer's; a leaf whose
    index is in ``summed`` is put together as a sum over the ranks."""
    y, aux, dx, grads = whole
    size = len(ranks)
    worst = max(max(_rel(r[0], y), _rel(r[1], aux), _rel(r[2], dx))
                for r in ranks)
    for i, (g, lay) in enumerate(zip(grads, tree_leaves(moe_lay))):
        mode = ranks[0][4][i]
        if i in summed:
            got = sum(r[3][i] for r in ranks)
        elif mode == "local":
            got = torch.zeros_like(g)
            for rank, r in enumerate(ranks):
                got[block_slices(g.shape, lay, {"data": 1, "model": size},
                                 {"data": 0, "model": rank})] = r[3][i]
        else:
            worst = max(worst, max(_rel(r[3][i], g) for r in ranks))
            continue
        worst = max(worst, _rel(got, g))
    return worst


def _router_index(params):
    return sorted(params).index("router")


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", sorted(MOE))
def test_ranks_sum_to_the_whole_moe_layer(name, size):
    cfg = _moe_cfg(name)
    params = _draw(TL.moe_specs(cfg), 0)
    x, dy = _moe_inputs(cfg)
    whole = _moe_whole(cfg, params, x, dy)
    ranks, moe_lay = _moe_ranks(cfg, params, x, dy, size)
    assert _moe_worst(ranks, moe_lay, whole) <= REL
    # the factor drops assignments, so the capacity takes part
    keep = TL.moe_route(tree_map(torch.from_numpy, params),
                        torch.from_numpy(x).reshape(-1, cfg.d_model), cfg)[3]
    assert not bool(keep.all())
    for r in ranks[1:]:
        assert torch.equal(r[0], ranks[0][0])
    tokens = SHAPE[0] * SHAPE[1]
    want = _chip_smoke().tp_moe_all_reduce_bytes(cfg, tokens, 1, False,
                                                 False, 4)
    assert [r[5] for r in ranks] == [want] * size


def test_foreign_assignment_in_a_local_slot_is_caught():
    """Trap: an assignment to another rank's expert clamped into a local
    slot (the buffer's last) instead of contributing nothing."""
    cfg = _moe_cfg("granite")
    params = _draw(TL.moe_specs(cfg), 0)
    x, dy = _moe_inputs(cfg)
    whole = _moe_whole(cfg, params, x, dy)
    slots = TL.expert_slots

    def clamped(slot, keep, capacity, num_experts, first, count):
        local, mine = slots(slot, keep, capacity, num_experts, first, count)
        foreign = keep & ~mine
        last = torch.full_like(local, count * capacity - 1)
        return torch.where(foreign, last, local), keep
    TL.expert_slots = clamped
    try:
        ranks, moe_lay = _moe_ranks(cfg, params, x, dy, 2)
    finally:
        TL.expert_slots = slots
    assert _moe_worst(ranks, moe_lay, whole) > 1e3 * REL


def test_aux_counted_on_every_rank_is_caught():
    """Trap: the gate values' gradient left partial and the router's
    gradient summed over the ranks ("partial") gets the routed part of
    the router's gradient right, but counts the aux loss's part (whole
    on every rank) M times."""
    cfg = _moe_cfg("granite")
    params = _draw(TL.moe_specs(cfg), 0)
    x, dy = _moe_inputs(cfg)
    router = _router_index(params)

    def partial_gates(r, hooks):
        hooks["experts"].gates = lambda g: g
        return hooks

    def router_error(c):
        want = _moe_whole(c, params, x, dy)[3][router]
        ranks, _ = _moe_ranks(c, params, x, dy, 2, planted=partial_gates)
        return _rel(sum(r[3][router] for r in ranks), want)
    # the aux loss's part is ~1e-4 of the router's gradient here (its
    # coefficient is 0.01): counted twice it moves the leaf 77x past REL
    assert router_error(cfg) > 10 * REL
    # without the aux loss the same planted router is right: the trap is
    # the aux term, not the partial sum
    assert router_error(dataclasses.replace(cfg, router_aux_loss=0.0)) \
        <= REL


def test_unsummed_combine_is_caught():
    """Trap: rank 0 takes part in the combine's all-reduce but goes on
    with its own experts' partial output."""
    cfg = _moe_cfg("granite")
    params = _draw(TL.moe_specs(cfg), 0)
    x, dy = _moe_inputs(cfg)
    whole = _moe_whole(cfg, params, x, dy)

    def own_part(r, hooks):
        if r == 0:
            combine = hooks["experts"].combine

            def planted(part):
                combine(part.detach())
                return part
            hooks["experts"].combine = planted
        return hooks
    ranks, moe_lay = _moe_ranks(cfg, params, x, dy, 2, planted=own_part)
    assert _moe_worst(ranks, moe_lay, whole) > 1e3 * REL


@pytest.mark.parametrize("case", [
    # (name, reduced, data, model, heads, experts of rank 1, shared ff)
    ("granite", True, 2, 2, True, (2, 4), False),
    ("granite", True, 1, 4, False, (1, 2), False),
    ("llama4", True, 2, 2, True, (2, 4), True),
    ("granite", False, 1, 2, True, (20, 40), False),
])
def test_moe_leaf_modes(case):
    """The experts' leaves local (their block of ``experts``), the router
    whole, a shared expert's leaves local; the attention local where the
    heads split (reduced granite-moe's 6 heads do not over 4 ranks:
    whole), norms whole."""
    name, reduced, data, model, heads, experts, shared = case
    cfg = get_config(MOE[name], reduced=reduced)
    m = build_model(cfg)
    layouts = model_param_shardings(m, _FakeMesh(data, model), profile="tp")
    ctx = tp.TensorParallel(m, layouts, _FakeComm(data, model, 1))
    assert (ctx.heads, ctx.experts, ctx.shared_ff) == (heads, experts,
                                                       shared)
    modes = dict(zip([".".join(p) for p in tp._paths(layouts)], ctx.modes))
    for stack in ("client", "server"):
        pre = f"{stack}.blocks."
        assert modes[pre + "moe.router"] == "whole"
        for leaf in ("w_gate", "w_up", "w_down"):
            assert modes[pre + "moe." + leaf] == "local"
            if shared:
                assert modes[pre + "moe.shared." + leaf] == "local"
        for leaf in ("wq", "wo"):
            assert modes[pre + "attn." + leaf] == ("local" if heads
                                                   else "whole")
        assert modes[pre + "norm1"] == modes[pre + "norm2"] == "whole"
    assert tp.active() is None and tp.moe_hooks() == {}


# ---------------------------------------------------------------------------
# Whisper, tensor-parallel
# ---------------------------------------------------------------------------

def _audio():
    model = build_model(get_config(AUDIO, reduced=True))
    params = _draw(model.param_specs(), 2)
    rng = np.random.default_rng(3)
    b, s = AUDIO_SHAPE
    cfg = model.cfg
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"frames": rng.standard_normal(
                 (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
             "tokens": toks[:, :s].astype(np.int64),
             "labels": toks[:, 1:].astype(np.int32),
             "weights": (rng.random((b, s)) < 0.8).astype(np.float32)}
    return model, params, {k: torch.from_numpy(v) for k, v in batch.items()}


def _audio_loss(model, held, batch):
    loss, _ = model.loss_fn(held, batch)
    return loss, torch.autograd.grad(loss, tree_leaves(held))


@pytest.mark.parametrize("size", [2, 4])
def test_ranks_sum_to_the_whole_whisper(size):
    """Whisper's loss (encoder, decoder, cross-attention, the vocab-parallel
    embedding and head) on M ranks against one process: the loss on
    every rank and each leaf's gradient put together; the bytes."""
    model, params, batch = _audio()
    whole = tree_map(lambda v: torch.from_numpy(v).requires_grad_(True),
                     params)
    loss, grads = _audio_loss(model, whole, batch)
    layouts = model_param_shardings(model, _FakeMesh(1, size), profile="tp")
    sizes = {"data": 1, "model": size}

    def run(r, group):
        comm = _Comm(group, r)
        ctx = tp.TensorParallel(model, layouts, comm)
        held = [torch.from_numpy(v)[block_slices(v.shape, lay, sizes,
                                                 comm.coord)]
                if md == "local" else torch.from_numpy(v)
                for v, lay, md in zip(tree_leaves(params),
                                      tree_leaves(layouts), ctx.modes)]
        held = tree_unflatten(params, [h.clone().requires_grad_(True)
                                       for h in held])
        prev = tp.set_tensor_parallel(ctx)
        try:
            out = _audio_loss(model, held, batch)
        finally:
            tp.set_tensor_parallel(prev)
        return out + (ctx.modes, comm.bytes, ctx)
    ranks = _threads(size, run)
    ctx = ranks[0][4]
    assert ctx.heads and ctx.ff and ctx.embed_vocab and ctx.head_vocab
    worst = max(_rel(r[0], loss) for r in ranks)
    for i, (g, lay) in enumerate(zip(grads, tree_leaves(layouts))):
        if ranks[0][2][i] == "local":
            got = torch.zeros_like(g)
            for rank, r in enumerate(ranks):
                got[block_slices(g.shape, lay, sizes,
                                 {"data": 0, "model": rank})] = r[1][i]
            worst = max(worst, _rel(got, g))
        else:
            worst = max(worst, max(_rel(r[1][i], g) for r in ranks))
    assert worst <= REL
    b, s = AUDIO_SHAPE
    want = _chip_smoke().tp_audio_all_reduce_bytes(
        model.cfg, b * model.cfg.encoder_seq, b * s, True, True, 4)
    assert [r[3] for r in ranks] == [want] * size


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (1, 2)])
def test_whisper_leaf_modes(mesh):
    """Reduced whisper (4 heads) splits its heads on 2x2 and 1x4: q, k, v,
    wo of the encoder's, the decoder's and the cross-attention local,
    w_in, b_in, w_out local, b_out whole, the learned positions and
    norms whole, the split vocab local. Full whisper-tiny's 6 heads do
    not split over 4 ranks: its attention is whole there, its MLP
    columns still local."""
    data, size = mesh
    for reduced in (True, False):
        model = build_model(get_config(AUDIO, reduced=reduced))
        layouts = model_param_shardings(model, _FakeMesh(data, size),
                                        profile="tp")
        ctx = tp.TensorParallel(model, layouts, _FakeComm(data, size, 0))
        heads = reduced or size == 2
        assert ctx.heads == heads and ctx.ff
        modes = dict(zip([".".join(p) for p in tp._paths(layouts)],
                         ctx.modes))
        for stack, attns in (("client.enc_blocks", ("attn",)),
                             ("server.dec_blocks", ("attn", "xattn"))):
            for attn in attns:
                for leaf in ("wq", "wk", "wv", "wo"):
                    assert modes[f"{stack}.{attn}.{leaf}"] == (
                        "local" if heads else "whole")
            for leaf in ("w_in", "b_in", "w_out"):
                assert modes[f"{stack}.mlp.{leaf}"] == "local"
            assert modes[f"{stack}.mlp.b_out"] == "whole"
        for leaf in ("client.enc_pos", "server.dec_pos", "client.enc_norm",
                     "server.final_norm"):
            assert modes[leaf] == "whole"
        vocab = "local" if reduced else "whole"     # 512, or 51,865
        assert modes["server.embed"] == modes["server.lm_head"] == vocab


# ---------------------------------------------------------------------------
# The dispatch over batch shards (gspmd with the batch split)
# ---------------------------------------------------------------------------

def _groups(cfg, tokens: int) -> int:
    g = cfg.moe_groups
    return g if g and tokens % g == 0 else 1


def _shard_ranks(cfg, params, x, shards):
    """``moe_apply`` on ``shards`` threads, each its contiguous block of
    x's rows under ``BatchShards``: per shard (y, aux, leaf gradients of
    sum(y) + aux, kept count)."""
    rows = x.shape[0] // shards

    def run(r, group):
        ctx = TL.BatchShards(shards, r, lambda t: _gather(group, r, t))
        leaves = tree_map(lambda v: torch.from_numpy(v).requires_grad_(True),
                          params)
        xs = torch.from_numpy(x[r * rows:(r + 1) * rows])
        prev = TL.set_batch_shards(ctx)
        try:
            y, aux = TL.moe_apply(leaves, xs, cfg)
            keep = TL.moe_route(leaves, xs.reshape(-1, cfg.d_model), cfg,
                                _groups(cfg, x.shape[0] * x.shape[1]))[3]
        finally:
            TL.set_batch_shards(prev)
        grads = torch.autograd.grad(y.sum() + aux, tree_leaves(leaves))
        return y.detach(), aux.detach(), grads, int(keep.sum())
    return _threads(shards, run)


def _one(cfg, params, x):
    leaves = tree_map(lambda v: torch.from_numpy(v).requires_grad_(True),
                      params)
    y, aux = TL.moe_apply(leaves, torch.from_numpy(x), cfg)
    grads = torch.autograd.grad(y.sum() + aux, tree_leaves(leaves))
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    keep = TL.moe_route(tree_map(torch.from_numpy, params), xt, cfg,
                        _groups(cfg, xt.shape[0]))[3]
    return y.detach(), aux.detach(), grads, int(keep.sum())


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("groups", [0, 2])
def test_dispatch_over_shards_is_one_dispatch(groups, shards):
    """S shards of the rows, each dispatching under ``BatchShards``,
    compute one ``moe_apply`` over every row: the outputs put together,
    the aux shares summed and the leaf gradients summed against the
    whole call, within 1e-6; the kept count equal. Dispatching each shard
    alone (capacity from its own rows) keeps another count."""
    cfg = _moe_cfg("granite", moe_groups=groups)
    params = _draw(TL.moe_specs(cfg), 0)
    x, _ = _moe_inputs(cfg, shape=(8, 12))
    y, aux, grads, kept = _one(cfg, params, x)
    ranks = _shard_ranks(cfg, params, x, shards)
    assert _rel(torch.cat([r[0] for r in ranks]), y) <= REL
    assert _rel(sum(r[1] for r in ranks), aux) <= REL
    for i, g in enumerate(grads):
        assert _rel(sum(r[2][i] for r in ranks), g) <= REL
    assert sum(r[3] for r in ranks) == kept
    rows = x.shape[0] // shards
    alone = sum(_one(cfg, params, x[r * rows:(r + 1) * rows])[3]
                for r in range(shards))
    assert alone != kept


def test_gspmd_microbatches_group_each_ranks_slice():
    """The engine's microbatch m on a mesh is each rank's m-th slice of
    its rows (``core.psl``'s ``_split`` of the rank's block), so with 2
    shards and M = 2 the global microbatch 0 holds rows {0, 2} of 4, where
    ``repro``'s gspmd program takes its contiguous block {0, 1}. The MoE
    dispatch then sees other tokens: the aux loss of the two microbatches
    differs from ``repro``'s grouping (``ROADMAP.md`` C)."""
    from repro_torch.core.psl import _split
    cfg = _moe_cfg("granite")
    params = _draw(TL.moe_specs(cfg), 0)
    x, _ = _moe_inputs(cfg, shape=(4, 12))
    rows = np.arange(4)
    per_rank = [rows[:2], rows[2:]]           # put_batch's blocks
    port = [np.concatenate([_split({"r": torch.from_numpy(b)}, 2)[m]["r"]
                            .numpy() for b in per_rank]) for m in range(2)]
    assert [p.tolist() for p in port] == [[0, 2], [1, 3]]
    repro_groups = [rows[:2], rows[2:]]
    port_aux = sum(float(_one(cfg, params, x[g])[1]) for g in port)
    repro_aux = sum(float(_one(cfg, params, x[g])[1]) for g in repro_groups)
    assert port_aux != repro_aux
