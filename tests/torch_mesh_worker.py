"""One rank of the 4-rank gloo group that ``test_torch_mesh.py`` starts.

    python tests/torch_mesh_worker.py RANK WORLD WORKDIR

Imports torch, numpy and ``repro_torch`` only (never JAX or ``repro``).
The group comes up through a ``file://`` store under WORKDIR; the bridged
initial parameters are read from ``WORKDIR/<model>.npz`` (``repro``'s
checkpoint format, written by the test). Every case of ``CASES`` trains 3
steps of the sharded engine on the batches of ``host_batch``; each rank
writes ``rank<r>.json`` (metrics, stored elements, bitwise checks,
fallbacks, the raising paths' messages), and rank 0 also ``rank0.pt``
(the step-0 gradient, the moments after the first step and the
parameters after the last, gathered).
The test imports ``CASES``, ``host_batch`` and ``build`` from here, so
both sides build the same models and batches.

Model kinds: "cnn", "lm" (reduced granite-3-2b from ``repro``'s init)
and "lm_fanin", the same LM from ``repro``'s init with every stacked
matrix rescaled to fan-in d_in (``chip_smoke.py``'s ``rescale_to_fan_in``,
written by the test); "qwen_fanin" (reduced qwen2-72b: qkv biases) and
"vlm_fanin" (reduced internvl2-2b, its batches with patches),
"ssm_fanin" (reduced falcon-mamba-7b), "hybrid_fanin" (reduced
zamba2-2.7b), "moe_fanin" (reduced granite-moe-3b-a800m, capacity factor
1.25) and "audio_fanin" (reduced whisper-tiny, its batches with frames)
alike (``ARCHS``). An MoE case also records how many assignments each
rank's dispatch dropped in its step-0 gradient (``moe_dropped``): the
test holds them to one dispatch over the global batch. The tensor-parallel cases take the
fan-in kinds: their forward sums in another order than one process does
(row-parallel products summed over ranks), and at ``repro``'s init
(stacked leaves of fan-in 1, near-argmax attention) one process's own
step-0 gradient moves by 7e-5 of a leaf's largest entry when one leaf is
scaled by 1 + 2**-23, past the 1e-5 limit of any reassociation; from the
fan-in init it moves by 1.1e-6. The Mamba models alike: at ``repro``'s
init the worst leaf of reduced falcon-mamba moves by 7.6e-4 and of
reduced zamba2 by 7.8e-4 (states of std-1 products over 1- and 2-layer
stacks), from the fan-in init by 1.6e-6 and 7.2e-6.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

STEPS = 3
PG_TIMEOUT_S = 60

# name: (model, mesh, profile, lowering, microbatches, batch, optimizer)
CASES = {
    "cnn-gspmd-mb1": ("cnn", "4x1", "tp", "gspmd", 1, "even", "sgd"),
    "cnn-gspmd-mb2": ("cnn", "4x1", "tp", "gspmd", 2, "even", "sgd"),
    "cnn-shard_map-mb1": ("cnn", "4x1", "tp", "shard_map", 1, "even",
                          "sgd"),
    "cnn-shard_map-mb2": ("cnn", "4x1", "tp", "shard_map", 2, "even",
                          "sgd"),
    "cnn-ragged": ("cnn", "4x1", "tp", "gspmd", 1, "ragged", "sgd"),
    "cnn-indivisible": ("cnn", "4x1", "tp", "gspmd", 1, "indivisible",
                        "sgd"),
    "lm-tp-4x1": ("lm", "4x1", "tp", "gspmd", 1, "even", "sgd"),
    "lm-fsdp-2x2": ("lm", "2x2", "fsdp", "gspmd", 1, "even", "adamw"),
    "lm-ddp-2x2": ("lm", "2x2", "ddp", "gspmd", 1, "even", "sgd"),
    "lm-tp-2x2": ("lm_fanin", "2x2", "tp", "gspmd", 1, "even", "adamw"),
    "lm-tp-2x2-mb2": ("lm_fanin", "2x2", "tp", "gspmd", 2, "even", "sgd"),
    "lm-tp-1x4": ("lm_fanin", "1x4", "tp", "gspmd", 1, "even", "sgd"),
    "lm-tp-2x2-shard_map": ("lm", "2x2", "tp", "shard_map", 1, "even",
                            "sgd"),
    "cnn-tp-2x2": ("cnn", "2x2", "tp", "gspmd", 1, "even", "sgd"),
    "qwen-tp-2x2": ("qwen_fanin", "2x2", "tp", "gspmd", 1, "even", "sgd"),
    "vlm-tp-1x4": ("vlm_fanin", "1x4", "tp", "gspmd", 1, "even", "sgd"),
    # falcon-mamba: on 2x2 rank 0 stores in_proj's x columns, rank 1 z's
    "ssm-tp-2x2": ("ssm_fanin", "2x2", "tp", "gspmd", 1, "even", "sgd"),
    "ssm-tp-1x4-mb2": ("ssm_fanin", "1x4", "tp", "gspmd", 2, "even", "sgd"),
    # zamba2: in_proj's 536 columns split across z | x | B | C | dt
    "hybrid-tp-2x2": ("hybrid_fanin", "2x2", "tp", "gspmd", 1, "even",
                      "adamw"),
    "hybrid-tp-1x4": ("hybrid_fanin", "1x4", "tp", "gspmd", 1, "even",
                      "sgd"),
    # granite-moe: 4 experts, 2 a rank on 2x2 (and 3 q heads, 1 kv head),
    # 1 a rank on 1x4 (the 6 heads whole); fsdp splits the batch over all
    # 4 ranks, whose own dispatches would drop other assignments
    "moe-tp-2x2": ("moe_fanin", "2x2", "tp", "gspmd", 1, "even", "adamw"),
    "moe-tp-1x4": ("moe_fanin", "1x4", "tp", "gspmd", 1, "even", "sgd"),
    "moe-fsdp-2x2": ("moe_fanin", "2x2", "fsdp", "gspmd", 1, "even", "sgd"),
    # whisper: 4 heads, 2 a rank on 2x2, 1 on 1x4; vocab 512 split
    "audio-tp-2x2": ("audio_fanin", "2x2", "tp", "gspmd", 1, "even", "sgd"),
    "audio-tp-1x4": ("audio_fanin", "1x4", "tp", "gspmd", 1, "even", "sgd"),
    "audio-fsdp-2x2": ("audio_fanin", "2x2", "fsdp", "gspmd", 1, "even",
                       "sgd"),
}
# the LM kinds' reduced configs
ARCHS = {"lm": "granite-3-2b", "lm_fanin": "granite-3-2b",
         "qwen_fanin": "qwen2-72b", "vlm_fanin": "internvl2-2b",
         "ssm_fanin": "falcon-mamba-7b", "hybrid_fanin": "zamba2-2.7b",
         "moe_fanin": "granite-moe-3b-a800m",
         "audio_fanin": "whisper-tiny"}
CHECKPOINT_CASE = "lm-fsdp-2x2"
LM_SEQ, LM_VOCAB = 24, 512
VLM_PATCHES = 16                 # reduced internvl2: 16 patches of d 128
AUDIO_FRAMES = (64, 128)         # reduced whisper: 64 frames of d 128


def build(kind: str, optimizer: str):
    """(model, optimizer) of a case: the CNN of tests/test_distributed.py
    with SGD(0.05, momentum 0.9), or a reduced LM (granite-3-2b, or the
    kind's ``ARCHS`` config) with SGD(1e-3,
    momentum 0.9) or AdamW at lr 1e-5. The LM's steps are small on
    purpose: at repro's init (stacked leaves of fan-in 1, sharp attention)
    lr 0.05 turns the fp32 reassociation of one engine against itself
    (microbatches 1 against 2) into parameters 0.0226 apart after 3
    steps, 1.1e-5 at lr 1e-3. An AdamW update moves a parameter by at
    most ~lr a step, so a sign that rounding flips stays inside the 1e-4
    parameter limit; its moments are held on their own."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.cnn import CNNConfig, CNNModel
    model = (CNNModel(CNNConfig(channels=(8, 16), image_size=16))
             if kind == "cnn" else
             build_model(get_config(ARCHS[kind], reduced=True)))
    if optimizer == "adamw":
        return model, optim.adamw(1e-5)
    opt = optim.sgd(0.05 if kind == "cnn" else 1e-3, momentum=0.9)
    return model, opt


def host_batch(kind: str, layout: str, step: int, rank: int = 0):
    """Step ``step``'s host batch (numpy, from a seed). The LM's is
    ``tests/test_torch_train.py``'s ``_batch(seed=step)``: 4 rows of 24
    tokens, one of them padding (the VLM's with 16 patches a row, the
    audio family's with 64 frames a row). The CNN's has 16 rows; "ragged"
    ends in
    5 zero-weight padding slots (the last rank's rows are all padding);
    "indivisible" has 18 rows, which do not split over 4 ranks; "digest"
    differs from rank to rank."""
    if kind != "cnn":                # tests/test_torch_train.py's _batch
        rng = np.random.default_rng(step)
        toks = rng.integers(0, LM_VOCAB, (4, LM_SEQ + 1)).astype(np.int32)
        w = np.ones((4, LM_SEQ), np.float32)
        w[-1] = 0.0                                  # a padding slot
        w[1] *= 0.5                                  # client-weighted slot
        out = {"tokens": toks[:, :LM_SEQ], "labels": toks[:, 1:],
               "weights": w}
        if kind == "vlm_fanin":      # tests/test_torch_vlm.py's patches
            out["patches"] = (0.02 * rng.standard_normal(
                (4, VLM_PATCHES, 128))).astype(np.float32)
        if kind == "audio_fanin":
            out["frames"] = rng.standard_normal(
                (4,) + AUDIO_FRAMES).astype(np.float32)
        return out
    rng = np.random.default_rng(100 * step + (rank if layout == "digest"
                                              else 0))
    n = 18 if layout == "indivisible" else 16
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    if layout == "ragged":
        w[-5:] = 0.0
    return {"images": rng.normal(size=(n, 16, 16, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, n).astype(np.int32),
            "weights": w}


def _equal(a, b) -> bool:
    from repro_torch.models.layers import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x.detach(), y.detach())
        for x, y in zip(la, lb))


def _numel(tree) -> int:
    from repro_torch.models.layers import tree_leaves
    return sum(x.numel() for x in tree_leaves(tree))


class dropped_count:
    """Inside: the assignments each ``moe_route`` call drops, a list by
    call (empty for a model without experts)."""

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.route, self.counts = layers, layers.moe_route, []

        def counted(*args):
            out = self.route(*args)
            self.counts.append(int((~out[3]).sum()))
            return out
        layers.moe_route = counted
        return self.counts

    def __exit__(self, *exc):
        self.layers.moe_route = self.route


def run_case(name, workdir, rank):
    from repro_torch.checkpoint import restore, save
    from repro_torch.launch.distributed import ShardedPSLEngine
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import TrainState
    kind, mesh_spec, profile, lowering, mb, layout, optname = CASES[name]
    model, opt = build(kind, optname)
    mesh = make_training_mesh(mesh_spec, device="cpu")
    engine = ShardedPSLEngine(model, opt, mesh=mesh, profile=profile,
                              lowering=lowering, microbatches=mb,
                              device="cpu")
    out = {}
    # init: every rank's blocks are the blocks of the one-card draw
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    out["init_is_slice"] = _equal(engine.init_state(0).params,
                                  engine.shard_tree(model.init(gen)))
    # the bridged parameters: each rank reads only its blocks
    path = os.path.join(workdir, f"{kind}.npz")
    params = restore(path, "cpu", mesh=mesh, layouts=engine.param_layouts)
    out["restore_is_slice"] = _equal(
        params, engine.shard_tree(restore(path, "cpu")))
    state = TrainState(params, opt.init(params), 0)
    with dropped_count() as dropped:
        grads = engine.grads(state, engine.put_batch(host_batch(kind, layout,
                                                                0)))
    if dropped:
        out["moe_dropped"] = dropped
    metrics, first = [], {}
    for t in range(STEPS):
        state, m = engine.step(state, engine.put_batch(
            host_batch(kind, layout, t)))
        metrics.append(m)
        if t == 0:                   # the moments after the first step
            first = {k: [x.clone() for x in
                         tree_leaves(engine.gather_params(v))]
                     for k, v in state.opt_state.items()
                     if k in ("mu", "m", "v")}
    whole = engine.gather_params(state.params)
    out["stored_is_slice"] = _equal(state.params, engine.shard_tree(whole))
    out["metrics"] = metrics
    out["stored_params"] = _numel(state.params)
    out["stored_moments"] = {k: _numel(v)
                             for k, v in state.opt_state.items()
                             if k in ("mu", "m", "v")}
    out["fallbacks"] = engine.report.fallbacks
    tensors = {"grads": grads, "params": whole, "moments": first}
    if name == CHECKPOINT_CASE:
        ckpt = os.path.join(workdir, "sharded_ckpt.npz")
        save(ckpt, state.params, mesh=mesh, layouts=engine.param_layouts)
        torch.distributed.barrier()
        out["checkpoint_restores_blocks"] = _equal(
            restore(ckpt, "cpu", mesh=mesh, layouts=engine.param_layouts),
            state.params)
    return out, tensors


def raising_paths(rank):
    """The messages of the paths that must raise on every rank."""
    from repro_torch.launch.distributed import ShardedPSLEngine
    from repro_torch.launch.mesh import make_training_mesh
    out = {}
    try:
        make_training_mesh("8x1", device="cpu")
    except ValueError as e:
        out["mesh_larger_than_world"] = str(e)
    model, opt = build("cnn", "sgd")
    engine = ShardedPSLEngine(model, opt, mesh=make_training_mesh(
        "4x1", device="cpu"), device="cpu")
    try:
        engine.put_batch(host_batch("cnn", "digest", 0, rank))
    except ValueError as e:
        out["digest_mismatch"] = str(e)
    return out


def main(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group
    torch.set_num_threads(1)
    backend = init_process_group(
        "cpu", init_method=f"file://{os.path.join(workdir, 'pg')}",
        rank=rank, world_size=world, timeout_s=PG_TIMEOUT_S)
    results = {"backend": backend, "cases": {}}
    saved = {}
    for name in CASES:
        results["cases"][name], saved[name] = run_case(name, workdir, rank)
    results["raises"] = raising_paths(rank)
    results["imports"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    if rank == 0:
        torch.save(saved, os.path.join(workdir, "rank0.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
