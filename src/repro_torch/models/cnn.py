"""Small GroupNorm ResNet for the paper-faithful PSL experiments (port of
:mod:`repro.models.cnn`).

The paper trains ResNet18 with BatchNorm replaced by GroupNorm (App. A:
PSL's variable local batch sizes break batch statistics) and the cut
after an early stage. This is that network, with ``repro``'s client/server
parameter split, functional over a parameter tree so the PSL step
(:mod:`repro_torch.core.psl`), the optimizers and the checkpoint format
work on it unchanged.

Layouts. The parameter tree is ``repro``'s: the same keys, lists of
blocks, and HWIO conv weights, so checkpoints and ``from_numpy_tree``
bridge it leaf for leaf and the init rule sees the same shapes. Images
arrive in ``repro``'s NHWC batch layout and are permuted to NCHW once, at
the top of :meth:`CNNModel.client_forward` and :meth:`CNNModel.predict`;
weights are permuted to OIHW at each call. The cut activations are NCHW.

Convolutions are ``F.conv2d`` with XLA's ``"SAME"`` padding worked out per
dimension (:func:`same_padding`): at stride 2 on an even size it pads
(0 before, 1 after), which ``padding=1`` would not reproduce.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import DTYPES, ParamSpec


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "gn-resnet"
    num_classes: int = 10
    image_size: int = 32
    channels: Tuple[int, ...] = (32, 64, 128)
    blocks_per_stage: int = 1
    group_size: int = 8         # a group count, as in repro
    cut_stage: int = 1          # client: stem + first `cut_stage` stages
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def _conv_spec(cin, cout, k=3):
    return ParamSpec((k, k, cin, cout), (None, None, None, None))


def _gn_specs(c):
    return {"scale": ParamSpec((c,), (None,), init="ones"),
            "bias": ParamSpec((c,), (None,), init="zeros")}


def num_groups(channels: int, groups: int) -> int:
    """``repro``'s group count: ``min(groups, c)``, lowered until it
    divides ``c``."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def group_norm(x, p, groups: int, eps: float = 1e-5):
    """GroupNorm of an NCHW tensor in fp32 (biased variance), scale and
    bias applied in fp32, cast back to ``x``'s dtype."""
    g = num_groups(x.shape[1], groups)
    y = F.group_norm(x.float(), g, p["scale"].float(), p["bias"].float(),
                     eps)
    return y.to(x.dtype)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dimension: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1):
    """``jax.lax.conv_general_dilated(x, w, (s, s), "SAME")`` on an NCHW
    ``x`` and an HWIO ``w``."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = same_padding(x.shape[2], kh, stride)
    left, right = same_padding(x.shape[3], kw, stride)
    w = w.permute(3, 2, 0, 1)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


class CNNModel:
    """GroupNorm ResNet with a PSL client/server split."""

    def __init__(self, cfg: CNNConfig):
        self.cfg = cfg

    def _block_specs(self, cin, cout) -> Dict[str, Any]:
        specs = {"conv1": _conv_spec(cin, cout), "gn1": _gn_specs(cout),
                 "conv2": _conv_spec(cout, cout), "gn2": _gn_specs(cout)}
        if cin != cout:
            specs["proj"] = _conv_spec(cin, cout, k=1)
        return specs

    def param_specs(self):
        cfg = self.cfg
        stages = []
        cin = cfg.channels[0]
        for cout in cfg.channels:
            blocks = []
            for bi in range(cfg.blocks_per_stage):
                blocks.append(self._block_specs(cin if bi == 0 else cout,
                                                cout))
                cin = cout
            stages.append(blocks)
        client = {"stem": _conv_spec(3, cfg.channels[0]),
                  "stem_gn": _gn_specs(cfg.channels[0]),
                  "stages": stages[:cfg.cut_stage]}
        server = {"stages": stages[cfg.cut_stage:],
                  "head": ParamSpec((cfg.channels[-1], cfg.num_classes),
                                    (None, None)),
                  "head_b": ParamSpec((cfg.num_classes,), (None,),
                                      init="zeros")}
        return {"client": client, "server": server}

    def init(self, generator: torch.Generator):
        """Random parameters on the generator's device (``repro``'s init
        rules on the HWIO shapes: a conv's fan-in is its kernel height;
        the draws differ from ``jax.random``'s)."""
        return L.materialize(self.param_specs(), generator,
                             self.cfg.torch_dtype, generator.device)

    def _block(self, p, x, stride):
        cfg = self.cfg
        y = conv(x, p["conv1"], stride)
        y = F.relu(group_norm(y, p["gn1"], cfg.group_size))
        y = conv(y, p["conv2"])
        y = group_norm(y, p["gn2"], cfg.group_size)
        sc = x
        if "proj" in p:
            sc = conv(x, p["proj"], stride)
        elif stride != 1:
            sc = x[:, :, ::stride, ::stride]
        return F.relu(y + sc)

    def client_forward(self, params, batch):
        """Client-side FP: NHWC images -> NCHW cut activations."""
        cfg = self.cfg
        x = batch["images"].to(cfg.torch_dtype).permute(0, 3, 1, 2)
        x = conv(x, params["client"]["stem"])
        x = F.relu(group_norm(x, params["client"]["stem_gn"],
                              cfg.group_size))
        for blocks in params["client"]["stages"]:
            for bp in blocks:
                x = self._block(bp, x, 1)
        return x

    def server_forward(self, server_params, cut_acts):
        x = cut_acts
        for blocks in server_params["stages"]:
            for bi, bp in enumerate(blocks):
                x = self._block(bp, x, 2 if bi == 0 else 1)
        x = x.mean(dim=(2, 3))
        return x @ server_params["head"] + server_params["head_b"]

    def server_loss(self, server_params, cut_acts, batch):
        logits = self.server_forward(server_params, cut_acts)
        return self._xent(logits, batch)

    @staticmethod
    def _xent(logits, batch):
        labels, weights = batch["labels"].long(), batch["weights"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        return (nll * weights).sum() / torch.clamp(weights.sum(), min=1e-6)

    def loss_fn(self, params, batch):
        cut = self.client_forward(params, batch)
        logits = self.server_forward(params["server"], cut)
        loss = self._xent(logits, batch)
        weights = batch["weights"]
        hit = (logits.argmax(-1) == batch["labels"]).to(weights.dtype)
        acc = (hit * weights).sum() / torch.clamp(weights.sum(), min=1e-6)
        return loss, {"loss": loss, "accuracy": acc,
                      "aux_loss": torch.zeros((), dtype=torch.float32,
                                              device=loss.device),
                      "tokens": weights.sum()}

    def predict(self, params, images):
        cut = self.client_forward(params, {"images": images})
        return self.server_forward(params["server"], cut)
