#!/usr/bin/env python3
"""How well-defined chip_smoke.py's CNN agreement check is, on the CPU.

    python3 tools/cnn_conditioning.py

Builds ``[cnn-agree]``'s model and batches (full-width paper-cnn, fp32,
32x32; 2048 images, K = 8 extended-Dirichlet clients, one UGS plan at
global batch 64) from the port's seeded init, at the model's own init
rule (a conv's fan-in taken from its kernel height) and rescaled to
fan-in (``chip_smoke.cnn_rescale_to_fan_in``), and prints, at each:

- the worst per-leaf relative L2 error of step 0's fp32 gradients
  against the same gradients computed in fp64: the floor any two fp32
  implementations can be held to;
- the losses of 3 SGD steps (momentum 0.9, weight decay 5e-4) in fp32
  and fp64 at lr 0.05 (the paper's) and 1e-4, and their relative
  differences;
- the losses of ``TRAIN_STEPS`` SGD steps at lr 0.05 over other
  batches of 64, and the last step's batch accuracy: whether the init
  trains.

Runs on the CPU in a few minutes (8 threads); imports no JAX.
"""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

TRAIN_STEPS = 40


def main() -> int:
    import torch
    import chip_smoke
    from repro_torch.api.evaluation import batch_from
    from repro_torch.configs import get_config
    from repro_torch.core.partition import partition_dirichlet
    from repro_torch.core.psl import (make_train_step, requires_grad_,
                                      value_and_grad)
    from repro_torch.core.sampling import make_plan
    from repro_torch.data.federated import ClientStore, GlobalBatchIterator
    from repro_torch.data.synthetic import make_classification_dataset
    from repro_torch.models import cnn as cnn_mod
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import TrainState, sgd

    cfg = get_config("paper-cnn")
    feats, labels = make_classification_dataset(
        2048, num_classes=cfg.num_classes, image_size=cfg.image_size,
        seed=0)
    parts, pop = partition_dirichlet(labels, 8, cfg.num_classes,
                                     classes_per_client=2, seed=1)
    store = ClientStore.from_partition(feats, labels, parts, pop)
    train_x, train_y = make_classification_dataset(
        64 * TRAIN_STEPS, num_classes=cfg.num_classes,
        image_size=cfg.image_size, seed=1)
    plan = make_plan("ugs", pop, 64, seed=0)
    host = [gb for gb, _ in zip(GlobalBatchIterator(store, plan, seed=0),
                                range(3))]

    class Float64Config(cnn_mod.CNNConfig):
        @property
        def torch_dtype(self):
            return torch.float64

    def model_in(dtype):
        if dtype == torch.float64:
            return cnn_mod.CNNModel(Float64Config(**cfg.__dict__))
        return cnn_mod.CNNModel(cfg)

    def batches(dtype, gbs):
        out = []
        for b in gbs:
            t = batch_from(b["features"], b["labels"], b["weights"])
            out.append({"images": t["images"].to(dtype),
                        "labels": t["labels"],
                        "weights": t["weights"].to(dtype)})
        return out

    def params(rescale, dtype):
        p = cnn_mod.CNNModel(cfg).init(torch.Generator().manual_seed(0))
        if rescale:
            chip_smoke.cnn_rescale_to_fan_in(torch, p)
        return requires_grad_(tree_map(lambda x: x.detach().to(dtype), p))

    def losses(rescale, dtype, lr, gbs):
        p = params(rescale, dtype)
        opt = sgd(lr, momentum=0.9, weight_decay=5e-4)
        step = make_train_step(model_in(dtype), opt)
        st = TrainState(p, opt.init(p), 0)
        out = []
        for b in batches(dtype, gbs):
            st, m = step(st, b)
            out.append((float(m["loss"]), float(m["accuracy"])))
        return out

    for rescale in (False, True):
        name = "fan-in init" if rescale else "the model's own init"
        g = {}
        for dtype in (torch.float32, torch.float64):
            _, g[dtype] = value_and_grad(model_in(dtype).loss_fn,
                                         params(rescale, dtype),
                                         batches(dtype, host[:1])[0])
        names = chip_smoke._leaf_names(g[torch.float32])
        rels = {n: ((a.double() - b).norm() / b.norm()).item()
                for n, a, b in zip(names, tree_leaves(g[torch.float32]),
                                   tree_leaves(g[torch.float64]))}
        worst = max(rels, key=rels.get)
        print(f"{name}: step-0 gradients, fp32 against fp64: worst "
              f"per-leaf relative L2 {rels[worst]:.3g} ({worst}); median "
              f"{sorted(rels.values())[len(rels) // 2]:.3g}", flush=True)
        for lr in (0.05, 1e-4):
            l32 = [x for x, _ in losses(rescale, torch.float32, lr, host)]
            l64 = [x for x, _ in losses(rescale, torch.float64, lr, host)]
            rel = [abs(a - b) / abs(b) for a, b in zip(l32, l64)]
            print(f"{name}: 3 SGD steps at lr {lr}: fp32 {l32}, fp64 "
                  f"{l64}, relative {[float(f'{r:.3g}') for r in rel]}",
                  flush=True)
        fresh = [{"features": train_x[64 * i:64 * (i + 1)],
                  "labels": train_y[64 * i:64 * (i + 1)],
                  "weights": None} for i in range(TRAIN_STEPS)]
        run = losses(rescale, torch.float32, 0.05, fresh)
        print(f"{name}: {TRAIN_STEPS} SGD steps at lr 0.05 (fp32): losses "
              f"{[float(f'{x:.4g}') for x, _ in run]}; last batch "
              f"accuracy {run[-1][1]:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
