"""The port's mesh engine (``launch.mesh``, ``sharding``,
``launch.distributed`` on a mesh) against ``repro``, on the CPU.

Layouts: the port's ``model_param_shardings`` resolves every leaf of
every ported config (reduced) to ``repro.sharding.spec_for``'s
PartitionSpec, dim for dim, with the same fallback notes in the same
order, for the tp / fsdp / ddp profiles on the duck-typed mesh of
``tests/test_sharding_rules.py`` at 4x1, 2x2, 1x4 and 2x16x16 with
``pod``.

The engine: a 4-rank gloo group on the CPU (``tests/torch_mesh_worker.py``,
``file://`` store under the module's tmp dir; process-group timeout 60 s,
each rank killed after ``CHILD_TIMEOUT_S``) trains every case of the
worker's ``CASES`` for 3 steps from parameters ``repro`` initialized
(bridged through its npz format; the tensor-parallel LM cases from that
init rescaled to fan-in d_in, as the worker's docstring says why),
through the dp, fsdp, ddp and tp (Megatron over ``model``) layouts and
both lowerings. No rank imports JAX; the references
below are computed here, in the pytest process. Limits, float32:
- the step-0 gradient against the port's one-process engine (one CPU
  thread, ``_one_thread`` says why) on the same parameters and batch:
  1e-5 of each leaf's largest entry; parameters after 3 steps: max abs
  difference < 1e-4, as
  ``tests/test_distributed.py`` holds ``repro``'s lowerings (only the
  order of the sums differs); the optimizer's moments after the first
  step within 1e-4 of each leaf's largest;
- the step-0 gradient against ``repro``'s fused gradient and its
  ``decomposed_grads``: max |port − repro| <= 3e-4 · max |repro| per leaf
  (and relative L2 <= 3e-4 for the LM), the limits of
  ``test_torch_cnn.py`` and ``test_torch_train.py`` (the LM's step-0
  batch is the one ``test_torch_train.py`` holds the one-card port on);
  the step-0 loss at rtol 1e-5;
- stored blocks, restored blocks and metrics across ranks: bitwise.
"""
import contextlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import repro.api as japi
from repro import sharding as jsh
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.core import psl as jpsl
from repro.models import layers as jL
from repro.models.cnn import CNNConfig as JCNNConfig
from repro.models.cnn import CNNModel as JCNNModel
import repro_torch.api as tapi
from repro_torch import sharding as tsh
from repro_torch.checkpoint import from_numpy_tree, restore
from repro_torch.configs import _MODULES as TORCH_CONFIGS
from repro_torch.core.psl import requires_grad_
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.distributed import ShardedPSLEngine
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import TrainState

import torch_mesh_worker as W
from torch_one_thread import one_torch_thread  # noqa: F401

WORLD = 4
CHILD_TIMEOUT_S = 300
GRAD_REL = 3e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


class FakeMesh:
    """Duck-typed mesh: only .shape and .axis_names are consulted."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


MESHES = {"4x1": FakeMesh({"data": 4, "model": 1}),
          "2x2": FakeMesh({"data": 2, "model": 2}),
          "1x4": FakeMesh({"data": 1, "model": 4}),
          "pod2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}
_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        spec = dict(arch=arch, reduced=True)
        _MODELS[arch] = (japi.build_model(japi.ModelSpec(**spec)),
                         tapi.build_model(tapi.ModelSpec(**spec)))
    return _MODELS[arch]


def _as_layout(spec):
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _repro_layouts(jmodel, mesh, profile):
    """repro's per-leaf PartitionSpecs (``model_param_shardings`` without
    the NamedSharding wrap, which needs real devices) and its notes."""
    rep = jsh.ShardingReport()
    specs = jmodel.param_specs()
    leaves = []
    for part, rules in (("client", jsh.client_rules(mesh, profile)),
                        ("server", jsh.server_rules(mesh, profile))):
        tree = jL.tree_map_specs(
            lambda s: jsh.spec_for(s.shape, s.axes, rules, mesh, rep),
            specs[part])
        leaves += jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [_as_layout(s) for s in leaves], rep.fallbacks


# ---------------------------------------------------------------------------
# Layouts and fallbacks, case for case
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("profile", ["tp", "fsdp", "ddp"])
@pytest.mark.parametrize("arch", sorted(TORCH_CONFIGS))
def test_layouts_and_fallbacks_equal_repro(arch, profile, mesh):
    jmodel, tmodel = _models(arch)
    fake = MESHES[mesh]
    want, want_notes = _repro_layouts(jmodel, fake, profile)
    rep = tsh.ShardingReport()
    got = tree_leaves(tsh.model_param_shardings(tmodel, fake, rep,
                                                profile=profile))
    assert got == want
    assert rep.fallbacks == want_notes
    assert tsh.batch_spec(fake, profile) == \
        _as_layout(jsh.batch_spec(fake, profile))


def test_spec_for_rules_match_repro_unit_cases():
    """``tests/test_sharding_rules.py``'s cases, through the port."""
    mesh, mesh3 = FakeMesh({"data": 16, "model": 16}), \
        FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert tsh.spec_for((2048, 8192), ("embed", "ff"),
                        tsh.server_rules(mesh), mesh) == (("data",),
                                                          ("model",))
    rep = tsh.ShardingReport()
    assert tsh.spec_for((49155,), ("vocab",), tsh.server_rules(mesh),
                        mesh, rep) == ((),)
    assert rep.fallbacks == ["axis 'vocab' size 49155 !% 16 -> replicated"]
    rep = tsh.ShardingReport()
    assert tsh.spec_for((128,), ("batch",), {"batch": ("data", "model")},
                        mesh, rep) == (("data",),)
    assert rep.fallbacks == ["axis 'batch' size 128: partial shard "
                             "('data',)"]
    assert tsh.spec_for((64, 64), ("a", "b"), {"a": ("model",),
                                               "b": ("model",)},
                        mesh) == (("model",), ())
    for m in (mesh, mesh3):
        for profile in ("tp", "fsdp", "ddp"):
            assert tsh.server_rules(m, profile) == \
                jsh.server_rules(m, profile)
            assert tsh.client_rules(m, profile) == \
                jsh.client_rules(m, profile)
            assert tsh.batch_axes(m, profile) == jsh.batch_axes(m, profile)


def test_block_placement_is_partition_specs():
    """A rank's block: row-major over the dim's axes, as PartitionSpec
    places it; the blocks of all ranks rebuild the leaf."""
    sizes = {"data": 2, "model": 2}
    full = torch.arange(8 * 6).reshape(8, 6)
    layout = (("data", "model"), ())
    seen = []
    for d in range(2):
        for m in range(2):
            block = tsh.local_slice(full, layout, sizes, {"data": d,
                                                          "model": m})
            assert torch.equal(block, full[(2 * d + m) * 2:
                                           (2 * d + m + 1) * 2])
            seen.append(block)
    assert torch.equal(torch.cat(seen), full)
    assert tsh.whole_shape((2, 6), layout, sizes) == (8, 6)
    assert tsh.stored_elements((8, 6), layout, sizes) == 48
    assert tsh.stored_elements((8, 6), (("model",),), sizes) == 96
    assert tsh.is_owner((("model",),), {"data": 0, "model": 1})
    assert not tsh.is_owner((("model",),), {"data": 1, "model": 1})


# ---------------------------------------------------------------------------
# Meshes, backends and the refusals that need no group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["4x1", "2×2", "2X2", "16x16", "4",
                                  "2x2x2", "axb", "x1", ""])
def test_parse_mesh_spec_matches_repro(spec):
    from repro.launch.mesh import parse_mesh_spec as jparse
    try:
        want = jparse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.parse_mesh_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert tmesh.parse_mesh_spec(spec) == want


def test_backend_rule_and_refusals(monkeypatch):
    assert tmesh.backend_for("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.backend_for("cuda", 4) == "nccl"     # a card a rank
    assert tmesh.backend_for("cuda", 8) == "gloo"     # ranks share cards
    monkeypatch.undo()
    assert tmesh.parse_mesh_spec("auto") == (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks but 1 is running"
                       ".*--nproc-per-node 2"):
        tmesh.make_training_mesh("2x1", device="cpu")
    model, opt = W.build("lm", "sgd")
    # tp over a model axis computes the MoE family too (experts over
    # model): an MoE model reaches the mesh, which needs 4 ranks
    moe = tapi.build_model(tapi.ModelSpec(arch="granite-moe-3b-a800m",
                                          reduced=True))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        ShardedPSLEngine(moe, opt, mesh="2x2", profile="tp", device="cpu")
    tapi.ExecutionSpec(mesh="2x2").validate()
    with pytest.raises(tapi.SpecError, match="DATAxMODEL"):
        tapi.ExecutionSpec(mesh="2x").validate()
    tapi.ExecutionSpec(mesh="2x2", sharding="fsdp").validate()
    tapi.ExecutionSpec(mesh="auto", lowering="shard_map").validate()
    # one rank: the one-card engine, no process group
    one = ShardedPSLEngine(model, opt, mesh="1x1", lowering="shard_map",
                           device="cpu")
    assert one.mesh is None and one.num_shards == 1
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# The 4-rank group
# ---------------------------------------------------------------------------

def _fan_in(jmodel, params):
    """``params`` with every stacked matrix (L, d_in, d_out) of normal
    init scaled by sqrt(L / d_in) (``chip_smoke.py``'s
    ``rescale_to_fan_in``): the worker's "lm_fanin" kind."""
    specs = jax.tree_util.tree_leaves(jmodel.param_specs(),
                                      is_leaf=jL.is_spec)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out = [x if s.init != "normal" or len(s.shape) < 3
           else (np.asarray(x) * np.float32(np.sqrt(s.shape[0]
                                                    / s.shape[-2])))
           .astype(np.asarray(x).dtype)
           for x, s in zip(leaves, specs, strict=True)]
    return jax.tree_util.tree_unflatten(treedef, out)


def _repro_params(kind):
    if kind == "cnn":
        jmodel = JCNNModel(JCNNConfig(channels=(8, 16), image_size=16))
    else:
        jmodel = _models(W.ARCHS[kind])[0]
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, (_fan_in(jmodel, params) if kind.endswith("_fanin")
                    else params)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Start the 4 ranks once, wait for them, return (results by rank,
    rank 0's tensors, the workdir, repro's (model, params) by kind)."""
    work = tmp_path_factory.mktemp("mesh")
    bridged = {kind: _repro_params(kind)
               for kind in ("cnn",) + tuple(W.ARCHS)}
    for kind, (_, jp) in bridged.items():
        jsave(str(work / f"{kind}.npz"), jp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    worker = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")
    procs, logs = [], []
    for rank in range(WORLD):
        log = open(work / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(rank), str(WORLD), str(work)],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    try:
        for p in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * WORLD:
        tails = "\n".join((work / f"rank{r}.log").read_text()[-3000:]
                          for r in range(WORLD))
        pytest.fail(f"ranks exited {codes}:\n{tails}")
    results = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    tensors = torch.load(work / "rank0.pt")
    return results, tensors, work, bridged


def _batch_tensors(kind, layout, step):
    host = W.host_batch(kind, layout, step)
    return {k: torch.as_tensor(v) for k, v in host.items()}


@contextlib.contextmanager
def _one_thread():
    """torch on one CPU thread, as the ranks run: this torch's CPU
    convolution backward races on several threads at some batch sizes
    (the 1x1 stride-2 projection's weight gradient at 18 rows moves by
    ~1e-2 of its largest entry from call to call), which would make the
    one-process reference, not the mesh, disagree with repro."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _one_process(name, bridged):
    """The port's one-process engine on the case's parameters and
    batches: (its step-0 gradient, its state after the steps)."""
    kind, _, _, _, mb, layout, optname = W.CASES[name]
    model, opt = W.build(kind, optname)
    engine = ShardedPSLEngine(model, opt, microbatches=mb, device="cpu")
    params = requires_grad_(from_numpy_tree(bridged[kind][1], "cpu"))
    state = TrainState(params, opt.init(params), 0)
    with _one_thread():
        grads = engine.grads(state, engine.put_batch(
            W.host_batch(kind, layout, 0)))
        for t in range(W.STEPS):
            state, _ = engine.step(state, engine.put_batch(
                W.host_batch(kind, layout, t)))
            if t == 0:
                first = {k: [x.clone() for x in tree_leaves(v)]
                         for k, v in state.opt_state.items()
                         if k in ("mu", "m", "v")}
    return grads, first, state


def _maxdiff(a, b):
    return max(float((x.detach().double() - y.detach().double()).abs()
                     .max()) for x, y in zip(tree_leaves(a),
                                             tree_leaves(b)))


@pytest.mark.parametrize("name", list(W.CASES))
def test_mesh_trajectory_matches_one_process_engine(mesh_run, name):
    results, tensors, _, bridged = mesh_run
    grads, first, want = _one_process(name, bridged)
    got = tensors[name]
    # the step-0 gradient: only the order of the sums differs
    for a, b in zip(tree_leaves(got["grads"]), tree_leaves(grads),
                    strict=True):
        assert float((a - b).abs().max()) <= \
            1e-5 * float(b.abs().max()) + 1e-12
    assert _maxdiff(got["params"], want.params) < PARAM_ATOL
    # the moments after the first step (later ones inherit the steps'
    # rounding: one engine against itself, microbatches 1 against 2,
    # reads 1.7e-3 of the largest AdamW moment after 3 steps, 6e-6 after 1)
    assert sorted(got["moments"]) == sorted(first)
    for slot, leaves in first.items():
        for a, b in zip(tree_leaves(got["moments"][slot]), leaves,
                        strict=True):
            assert float((a - b).abs().max()) <= \
                1e-4 * float(b.abs().max()) + 1e-12
    # every rank reads the same metrics, bit for bit
    per_rank = [r["cases"][name]["metrics"] for r in results]
    assert all(m == per_rank[0] for m in per_rank)


_REPRO_GRADS = {}


def _repro_grads(bridged, kind, layout, mb):
    """repro's fused gradient and loss, and its decomposed gradient, on the
    step-0 batch (computed once for the cases that share them)."""
    key = (kind, layout, mb)
    if key not in _REPRO_GRADS:
        jmodel, jp = bridged[kind]
        jb = {k: jax.numpy.asarray(v)
              for k, v in W.host_batch(kind, layout, 0).items()}
        jg, jmet = jax.jit(lambda p, b: jpsl.fused_grads(jmodel, p, b, mb))(
            jp, jb)
        _, jdec, _ = jax.jit(lambda p, b: jpsl.decomposed_grads(
            jmodel, p, b))(jp, jb)
        _REPRO_GRADS[key] = (jg, jdec, float(jmet["loss"]))
    return _REPRO_GRADS[key]


@pytest.mark.parametrize("name", list(W.CASES))
def test_mesh_grads_match_repro_fused_and_decomposed(mesh_run, name):
    """The step-0 gradient against repro's fused gradient, leaf by leaf,
    and against its ``decomposed_grads``. repro's decomposed protocol
    drops the client blocks' aux losses (its ``client_forward`` returns
    the cut activations alone), so for an MoE model it differs from the
    fused gradient on the client leaves by their aux term (4e-3 of the
    router's largest entry for "moe_fanin"): the decomposed gradient
    holds an MoE case's server leaves, the fused one every leaf."""
    results, tensors, _, bridged = mesh_run
    kind, _, _, _, mb, layout, _ = W.CASES[name]
    jg, jdec, jloss = _repro_grads(bridged, kind, layout, mb)
    got = tree_leaves(tensors[name]["grads"])
    client = len(tree_leaves(tensors[name]["grads"]["client"]))
    for ref in (jg, jdec):
        for i, (a, b) in enumerate(zip(got, jax.tree_util.tree_leaves(ref),
                                       strict=True)):
            if ref is jdec and kind == "moe_fanin" and i < client:
                continue
            a, b = a.double().numpy(), np.asarray(b, np.float64)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= GRAD_REL * np.abs(b).max()
            if kind != "cnn":
                assert np.linalg.norm(a - b) <= \
                    GRAD_REL * np.linalg.norm(b)
    loss0 = results[0]["cases"][name]["metrics"][0]["loss"]
    np.testing.assert_allclose(loss0, jloss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(W.CASES))
def test_ranks_store_their_blocks(mesh_run, name):
    """Each rank stores the blocks of the whole tree (init, restore and
    after the steps), and the ranks together store what the layout
    implies, from repro's layouts: each block once for each rank that
    holds it."""
    results, _, _, bridged = mesh_run
    kind, mesh, profile, lowering, _, _, optname = W.CASES[name]
    for r in results:
        case = r["cases"][name]
        assert case["init_is_slice"] and case["restore_is_slice"] \
            and case["stored_is_slice"]
    fake = MESHES[mesh]
    jmodel = bridged[kind][0]
    shapes = [s.shape for s in jax.tree_util.tree_leaves(
        jmodel.param_specs(), is_leaf=jL.is_spec)]
    if lowering == "gspmd":
        layouts, notes = _repro_layouts(jmodel, fake, profile)
    else:
        layouts, notes = [()] * len(shapes), []
    sizes = tmesh.mesh_sizes(fake)
    want = sum(tsh.stored_elements(s, lay, sizes)
               for s, lay in zip(shapes, layouts))
    assert sum(r["cases"][name]["stored_params"] for r in results) == want
    for slot in ("mu", "m", "v"):
        stored = [r["cases"][name]["stored_moments"].get(slot)
                  for r in results]
        if stored[0] is not None:
            assert sum(stored) == want
    # the engine's notes: repro's parameter notes, then its batch notes
    total = tsh.shard_count((jsh.batch_axes(fake, profile),), sizes)
    batch = W.host_batch(kind, W.CASES[name][5], 0)
    for key in sorted(batch):
        shape = batch[key].shape
        if shape[0] % total:
            notes = notes + [f"batch dim {shape} !% {total} -> replicated"]
    assert results[0]["cases"][name]["fallbacks"] == list(
        dict.fromkeys(notes))


def _one_process_drops(bridged, kind, rows):
    """The assignments each MoE layer of the one-process port drops on
    ``rows`` of the step-0 batch (a dispatch over those rows alone)."""
    model, _ = W.build(kind, "sgd")
    params = from_numpy_tree(bridged[kind][1], "cpu")
    batch = {k: torch.as_tensor(v[rows])
             for k, v in W.host_batch(kind, "even", 0).items()}
    with W.dropped_count() as dropped, torch.no_grad(), _one_thread():
        model.loss_fn(params, batch)
    return dropped


@pytest.mark.parametrize("name", [n for n in W.CASES
                                  if W.CASES[n][0] == "moe_fanin"])
def test_moe_dispatch_over_the_global_batch(mesh_run, name):
    """On gspmd a rank's MoE layers dispatch its rows as one dispatch over
    the global batch does: the assignments the batch shards drop, summed
    layer by layer, are the one-process count on the whole batch. For
    ``moe-fsdp-2x2`` (4 shards of one row) dispatching each shard alone
    drops others, so it is the global dispatch that makes its step-0
    gradient match repro's fused one."""
    results, _, _, bridged = mesh_run
    _, mesh, profile, _, _, _, _ = W.CASES[name]
    data, model = tmesh.parse_mesh_spec(mesh)
    shards = data * (model if profile != "tp" else 1)
    batch_ranks = [r for r in range(WORLD)
                   if profile != "tp" or r % model == 0]
    assert len(batch_ranks) == WORLD // (model if profile == "tp" else 1)
    whole = _one_process_drops(bridged, "moe_fanin", slice(None))
    per_layer = [r["cases"][name]["moe_dropped"] for r in results]
    if shards == 1:                 # every rank holds the whole batch
        assert all(d == whole for d in per_layer)
        return
    got = [sum(per_layer[r][i] for r in batch_ranks)
           for i in range(len(whole))]
    assert got == whole
    rows = 4 // shards
    alone = [_one_process_drops(bridged, "moe_fanin",
                                slice(i * rows, (i + 1) * rows))
             for i in range(shards)]
    alone = [sum(a[i] for a in alone) for i in range(len(whole))]
    if profile == "fsdp":
        assert alone != whole, (alone, whole)


def test_sharded_checkpoint_round_trip(mesh_run):
    """A state saved on the 4 ranks restores on one process bit for bit
    (the gathered parameters), loads in repro.checkpoint.io to the same
    arrays, and restores on each rank to its blocks."""
    results, tensors, work, _ = mesh_run
    assert all(r["cases"][W.CHECKPOINT_CASE]["checkpoint_restores_blocks"]
               for r in results)
    path = str(work / "sharded_ckpt.npz")
    whole = tensors[W.CHECKPOINT_CASE]["params"]
    one = restore(path, "cpu")
    assert all(torch.equal(a, b.detach()) for a, b in
               zip(tree_leaves(one), tree_leaves(whole), strict=True))
    jtree = jrestore(path)
    for a, b in zip(jax.tree_util.tree_leaves(jtree), tree_leaves(one),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_ranks_raise_together_and_import_no_jax(mesh_run):
    results = mesh_run[0]
    for r in results:
        assert r["backend"] == "gloo"
        assert r["imports"] == []
        assert "needs 8 ranks but 4 are running" in \
            r["raises"]["mesh_larger_than_world"]
        assert "--nproc-per-node 8" in r["raises"]["mesh_larger_than_world"]
        assert "different host batches" in r["raises"]["digest_mismatch"]
