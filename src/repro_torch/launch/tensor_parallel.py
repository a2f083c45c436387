"""Tensor-parallel compute over the mesh's ``model`` axis (Megatron), for
the ``tp`` profile of :class:`repro_torch.launch.distributed.
ShardedPSLEngine`.

``repro.sharding.server_rules(profile="tp")`` splits ``heads``,
``kv_heads``, ``ff`` and ``vocab`` over ``model``, and GSPMD derives the
compute from those layouts: column-parallel q/k/v and MLP-in products,
row-parallel ``wo`` and ``w_down`` products followed by an all-reduce, a
vocab-parallel embedding and loss. ``repro`` has no such file; this
module holds the explicit pieces:

* :class:`TensorParallel`, the context: the ``MeshComm`` whose ``model``
  group it reduces over, this rank's ``model`` coordinate, and what the
  leaf layouts split (q heads, kv heads, MLP columns, the embedding's and
  the head's vocab). ``modes`` says, leaf by leaf, how the engine gathers
  the leaf and reduces its gradient.
* :func:`set_tensor_parallel`, module-level in the style of
  ``repro.sharding.set_activation_sharding``; the model code calls the
  hooks below, which are the identity while no context is set, so the
  one-card path runs as it always has.
* :class:`ColumnParallelProduct` (the products that start the attention
  and the MLP: one card's forward, the input's gradient all-reduced
  backward), :class:`RowParallelProduct` (the products that end them:
  the partial products all-reduced forward) and :class:`ReduceFromModel`
  (all-reduce forward, identity backward: the embedding's rows). Every
  sum of partial products over ranks is taken in fp32 and rounded once,
  as one card rounds each product once, so the ranks compute one card's
  roundings up to fp32 reassociation: bf16 partials summed in bf16 differ
  from one card's product in 37.5% of the elements, fp32 ones in 0.1 to
  0.8% (``tools/tp_rounding.py`` on an H100), and at granite's full width
  (4 layers) the bf16 sums move the step-0 gradient 2.4% from one card's,
  the fp32 ones 1.7%, which is where any change of the rounding of the
  row products lands. It costs bytes: 28 per (token, d_model) a layer
  against Megatron's 8 in bf16.
* :func:`embed`, the vocab-parallel lookup: a rank looks up the tokens of
  its rows ``[v0, v1)``, zeroes the rest and all-reduces, so the
  gradient lands on its own rows only.
* :func:`vocab_parallel_cross_entropy`: B5's partials on the rank's vocab
  slice (``ops.cross_entropy_partials``), all-gathered over ``model`` and
  combined in rank order (``xent.combine_partials``); the backward is
  B5-bwd on the slice with local labels (-1 outside it) and the global
  lse, its partial dh all-reduced in fp32.

A kv layout that cannot follow the q heads (reduced granite on 1x4: 2 kv
heads of 16 over 4 ranks, split mid-head) is computed whole: each rank
gathers the leaf and slices out the kv heads its q heads use, and the
leaf's gradient, partial on each rank, is summed over ``model``
(mode ``"partial"``). A vocab that does not divide is replicated by
``spec_for`` (granite's 49,155): the lookup and B5 then run whole on
every rank, as on one card.

The Mamba mixers (the ssm and hybrid families) split their channels
over ``model``: a rank computes the contiguous channels ``[c0, c1)`` of
``d_inner`` (Mamba-2: whole heads ``[h0, h1)``), which are its stored
blocks of every leaf whose only split is ``inner`` (conv, x_proj,
dt_proj, dt_bias, a_log and d_skip of Mamba-1, Mamba-2's norm_w, both
out_proj). The mixer's input goes through a column-parallel product (dx
all-reduced), B4 or the per-head B4 and their backwards run on the
rank's channels, and out_proj is row-parallel. The stored blocks of the
other leaves are not the rank's channels, so :func:`mixer_params` takes
their columns from the whole leaf (mode ``"partial"``):

* ``in_proj`` stores x then z (Mamba-1), or z | x | B | C | dt
  (Mamba-2), in contiguous blocks: on two ranks rank 0 stores x and rank
  1 stores z. A rank needs the x and z columns of its channels, and
  Mamba-2 its dt columns and B's and C's whole (one group: every head
  reads them); conv_w and conv_b (Mamba-2: x's rows, then B's and C's)
  alike;
* Mamba-2's a_log, dt_bias and d_skip are replicated (no logical axis)
  and a rank reads its heads' entries.

Two sums over ranks go both ways, in fp32 (:class:`SumOverModel`):
Mamba-2's RMSNorm over the whole ``d_inner`` (each rank's sum of
squares; the norm divides by ``d_inner``, not the rank's width) and
Mamba-1's row-parallel ``x_proj``, whose output (dt, B, C) feeds only
the rank's channels, so its gradient is partial too.

The MoE family splits its experts over ``model`` (``repro``'s tp rules:
``experts`` over ``model``, ``expert_ff`` whole): rank r computes experts
``[r E / M, (r + 1) E / M)``, its stored blocks of ``w_gate``, ``w_up``
and ``w_down``. Every rank of a ``model`` group holds the same tokens
(the batch splits over the data axes only), so each computes the same
router (whole, mode ``"whole"``), top-k and capacity, and scatters only
its own experts' assignments (:class:`ExpertParallel`). Its gate-weighted
outputs, summed over k in fp32, are all-reduced over ``model`` in fp32
and rounded once, as one card rounds the sum over k once. Backward, the
dispatch input's gradient and the gate values' are partial on each rank
and are all-reduced in fp32, so the router's gradient is whole and the
same on every rank, its aux term counted once. A shared expert (llama4)
is an MLP whose ``ff`` splits: column- and row-parallel, mode
``"local"``.

The audio family (whisper) takes the dense block's hooks in the encoder,
the decoder and the cross-attention: q, k, v column-parallel, ``wo``
row-parallel, the GELU MLP's ``w_in`` column-parallel with its ``b_in``
the rank's columns and ``w_out`` row-parallel with ``b_out`` added after
the sum (mode ``"whole"``). Cross-attention's k and v are products of
the encoder states, the PSL cut activations: their input gradient,
summed over ``model``, is what the client receives. The learned
positions are whole; the embedding sits under ``server``.

Heads that do not split into whole heads a rank (whisper-tiny's 6 on 1x4)
leave the attention whole (mode ``"whole"``), whatever the family, while
the MLP columns still split.

Families: every family computes in parallel but the CNN, which names no
logical axis, so ``tp`` replicates it over ``model`` (mode ``"whole"``
for every leaf) and its model ranks repeat their data rank's work, as in
``repro``. The context is per thread (the tests play ranks as threads).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import cross_entropy as xent
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import uses_tensor_cores
from repro_torch.models.layers import tree_leaves

Layout = Tuple[Tuple[str, ...], ...]      # repro_torch.sharding's

# Mamba-2's leaves a rank slices from the whole leaf (the module's
# docstring says why); Mamba-1 slices in_proj only
MAMBA2_PARTIAL = ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias",
                  "d_skip")

_STATE = threading.local()


def _paths(tree, path=()) -> List[Tuple[str, ...]]:
    """Key paths of a layout tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    return [path]


def _split(layout: Layout) -> bool:
    return any("model" in entry for entry in layout)


def drop_model(layout: Layout) -> Layout:
    """The layout less its ``model`` axis: what a rank gathers over the
    data axes to hold its ``model`` block whole."""
    return tuple(tuple(a for a in e if a != "model") for e in layout)


def model_only(layout: Layout) -> Layout:
    """The layout's ``model`` axis alone: how the ``model`` blocks of a
    leaf tile it."""
    return tuple(tuple(a for a in e if a == "model") for e in layout)


class TensorParallel:
    """What the ``tp`` layouts split over ``model``, for one rank of a
    mesh with ``model > 1``.

    ``modes``: one of "local" (the rank computes with its ``model`` block),
    "partial" (gathered whole; its gradient is partial and is summed over
    ``model``) or "whole" (gathered whole; its gradient is whole on every
    rank) for each leaf of ``layouts``, in ``tree_leaves`` order.
    ``channels`` is the rank's ``[c0, c1)`` of the Mamba mixer's
    ``d_inner`` and ``ssm_heads`` its ``[h0, h1)`` of Mamba-2's heads
    (None without a mixer, or for Mamba-1); ``experts`` its ``[e0, e1)``
    of the MoE experts (None without them, or when they are whole) and
    ``shared_ff`` whether the shared expert's columns split."""

    def __init__(self, model, layouts, comm):
        cfg = model.cfg
        self.comm = comm
        self.size, self.rank = comm.sizes["model"], comm.coord["model"]
        m = self.size
        server, client = layouts["server"], layouts["client"]
        blocks = (server.get("blocks") or server.get("superblocks")
                  or server.get("dec_blocks") or client["blocks"])
        attn = blocks.get("attn") or server.get("shared_attn", {}).get(
            "attn")
        self.heads = attn is not None and _split(attn["wq"]) \
            and cfg.num_heads % m == 0
        kv_local = self.heads and _split(attn["wk"]) \
            and cfg.num_kv_heads % m == 0
        mlp = blocks.get("mlp", {})
        self.ff = _split(mlp.get("w_gate") or mlp.get("w_in") or ())
        embed = client["embed"] if "embed" in client else server["embed"]
        self.embed_vocab = _split(embed)
        self.head_vocab = _split(embed if cfg.tie_embeddings
                                 else server["lm_head"])
        moe = blocks.get("moe", {})
        self.experts: Optional[Tuple[int, int]] = None
        if _split(moe.get("w_gate", ())):
            per = cfg.num_experts // m
            self.experts = (self.rank * per, (self.rank + 1) * per)
        self.shared_ff = _split(moe.get("shared", {}).get("w_gate", ()))
        # the kv heads this rank's q heads use, when kv is computed whole
        self.kv_heads: Optional[Tuple[int, int]] = None
        if self.heads and not kv_local:
            hq_loc = cfg.num_heads // m
            group = cfg.num_heads // cfg.num_kv_heads
            if hq_loc % group and group % hq_loc:
                raise NotImplementedError(
                    f"tensor-parallel attention: {hq_loc} q heads a rank do "
                    f"not align with kv groups of {group}")
            q0 = self.rank * hq_loc
            self.kv_heads = (q0 // group, (q0 + hq_loc - 1) // group + 1)
        self.head_dim = cfg.head_dim
        self.channels: Optional[Tuple[int, int]] = None
        self.ssm_heads: Optional[Tuple[int, int]] = None
        if "mixer" in blocks:
            self._split_mixer(cfg, blocks["mixer"])
        self.modes = [self._mode(p, lay) for p, lay in zip(
            _paths(layouts), tree_leaves(layouts))]

    def _split_mixer(self, cfg, mixer) -> None:
        """The rank's channels (and Mamba-2 heads): whole heads and whole
        stored blocks of the leaves it computes with locally, or raise."""
        m, di = self.size, cfg.d_inner
        where = f"tensor-parallel {cfg.name} on a mesh with model={m}"
        if di % m or not _split(mixer["out_proj"]):
            raise NotImplementedError(
                f"{where}: d_inner {di} does not split into {m} blocks")
        width = di // m
        self.channels = (self.rank * width, (self.rank + 1) * width)
        if cfg.ssm_variant == "mamba2":
            nh = cfg.ssm_num_heads
            if nh % m:
                raise NotImplementedError(
                    f"{where}: {nh} Mamba-2 heads do not split into {m} "
                    f"ranks of whole heads")
            self.ssm_heads = (self.rank * nh // m, (self.rank + 1) * nh // m)

    def _mode(self, path: Sequence[str], layout: Layout) -> str:
        name, parent = path[-1], (path[-2] if len(path) > 1 else None)
        if parent in ("attn", "xattn"):
            if not self.heads:
                return "whole"
            if name in ("wq", "wo", "bq"):
                return "local"
            return "partial" if self.kv_heads else "local"
        if parent in ("mlp", "shared"):
            # whisper's b_out is added after the sum: whole
            split = self.ff if parent == "mlp" else self.shared_ff
            return "local" if split and _split(layout) else "whole"
        if parent == "moe":
            return "local" if self.experts and name != "router" else "whole"
        if len(path) > 1 and path[-2] == "mixer":
            if name in (MAMBA2_PARTIAL if self.ssm_heads else ("in_proj",)):
                return "partial"
            if not _split(layout):
                raise NotImplementedError(
                    f"tensor-parallel mixer leaf {'.'.join(path)}: layout "
                    f"{layout} does not split over model")
            return "local"
        if path[-1] in ("embed", "lm_head"):
            return "local" if _split(layout) else "whole"
        if _split(layout):
            raise NotImplementedError(
                f"tensor-parallel leaf {'.'.join(path)}: layout {layout} "
                f"splits over model, and nothing computes it in parallel")
        return "whole"

    # -------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(t, ("model",))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_gather(t, ("model",))


def set_tensor_parallel(ctx: Optional[TensorParallel]
                        ) -> Optional[TensorParallel]:
    """Make ``ctx`` the context the model's hooks consult in this thread
    (None: every hook is the identity); returns the one it replaces."""
    prev = active()
    _STATE.ctx = ctx
    return prev


def active() -> Optional[TensorParallel]:
    return getattr(_STATE, "ctx", None)


def fp32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in fp32, unrounded, for (..., K) ``a`` and (K, N) ``w``:
    on the card a 16-bit product with an fp32 output (``torch.mm``'s
    ``out_dtype``), else the product of the fp32 values."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(a2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(a2.float(), w.float())
    return y.reshape(*a.shape[:-1], w.shape[-1])


class ColumnParallelProduct(torch.autograd.Function):
    """``x @ w`` with ``w`` (K, N / M) the rank's columns and ``x`` whole on
    every rank: the forward is one card's product (bit for bit: its sums
    run over the whole K). Backward: dw = x^T dy as one card; dx is summed
    over ``model``: the rank's partial dy w^T in fp32, all-reduced in fp32
    and rounded once, as one card rounds its dx once (the module's
    docstring gives the measured difference)."""

    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        ctx.tp = tp
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = ctx.tp.all_reduce(fp32_product(dy, w.T)).to(x.dtype)
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).T,
                          dy.reshape(-1, dy.shape[-1]))
        return dx, dw, None


class ReduceFromModel(torch.autograd.Function):
    """All-reduce over ``model`` forward (a partial sum on each rank);
    identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class RowParallelProduct(torch.autograd.Function):
    """``a @ w`` summed over ``model``: ``a`` (..., K / M) holds the rank's
    columns of the activations, ``w`` (K / M, N) its rows. The rank's
    partial product is kept in fp32, all-reduced in fp32 and rounded to
    ``a``'s dtype once, as one card rounds the whole product once. The
    backward is the product's own, in ``a``'s dtype: da = dy w^T and dw =
    a^T dy sum over dims that are whole on the rank."""

    @staticmethod
    def forward(ctx, a, w, tp):
        ctx.save_for_backward(a, w)
        return tp.all_reduce(fp32_product(a, w)).to(a.dtype)

    @staticmethod
    def backward(ctx, dy):
        a, w = ctx.saved_tensors
        da = torch.matmul(dy, w.T)
        dw = torch.matmul(a.reshape(-1, a.shape[-1]).T,
                          dy.reshape(-1, dy.shape[-1]))
        return da, dw, None


class SumOverModel(torch.autograd.Function):
    """An fp32 partial sum all-reduced over ``model`` forward, and its
    gradient all-reduced over ``model`` backward: for a sum each rank
    takes over its own channels whose result then feeds only those
    channels, so each rank's gradient of it is partial too (Mamba-2's
    sum of squares, Mamba-1's ``x_proj`` product)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.all_reduce(x.float().clone(
            memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.float().clone(
            memory_format=torch.contiguous_format)), None


def summed_product(a: torch.Tensor, w: torch.Tensor,
                   tp: TensorParallel) -> torch.Tensor:
    """``a @ w`` summed over ``model``, ``a`` (..., K / M) the rank's
    channels and ``w`` (K / M, N) its rows (Mamba-1's ``x_proj``): the
    partial product in fp32 (the 16-bit inputs multiply exactly there),
    summed both ways by :class:`SumOverModel` and rounded to ``a``'s
    dtype once."""
    part = torch.matmul(a.float(), w.float())
    return SumOverModel.apply(part, tp).to(a.dtype)


def rms_norm_over_model(x: torch.Tensor, weight: torch.Tensor, eps: float,
                        width: int, tp: TensorParallel) -> torch.Tensor:
    """``layers.rms_norm`` over channels split across ``model``: ``x``
    (..., width / M) the rank's channels; the sum of squares is taken on
    each rank in fp32, summed both ways (:class:`SumOverModel`) and
    divided by the whole ``width``."""
    xf = x.float()
    ss = SumOverModel.apply((xf * xf).sum(dim=-1, keepdim=True), tp)
    y = xf * torch.rsqrt(ss / width + eps)
    return (y * weight.float()).to(x.dtype)


def mixer_params(p, cfg):
    """One layer's Mamba mixer leaves as the rank computes with them: with
    a context that splits the channels, ``in_proj`` (and Mamba-2's conv,
    a_log, dt_bias, d_skip), whole on every rank, cut to the rank's
    columns, rows and heads (the module's docstring); else ``p``."""
    tp = active()
    if tp is None or tp.channels is None:
        return p
    c0, c1 = tp.channels
    di = cfg.d_inner
    w = p["in_proj"]
    out = dict(p)
    if tp.ssm_heads is None:
        out["in_proj"] = torch.cat([w[..., c0:c1], w[..., di + c0:di + c1]],
                                   dim=-1)
        return out
    h0, h1 = tp.ssm_heads
    dt0 = 2 * di + 2 * cfg.ssm_state
    out["in_proj"] = torch.cat([w[..., c0:c1], w[..., di + c0:di + c1],
                                w[..., 2 * di:dt0], w[..., dt0 + h0:dt0 + h1]],
                               dim=-1)
    for name in ("conv_w", "conv_b"):
        out[name] = torch.cat([p[name][c0:c1], p[name][di:]], dim=0)
    for name in ("a_log", "dt_bias", "d_skip"):
        out[name] = p[name][h0:h1]
    return out


def mixer_hooks(cfg) -> dict:
    """The Mamba mixer's hooks under a context that splits its channels
    (``mamba1_apply`` / ``mamba2_apply``'s keywords): the input's
    column-parallel product, the row-parallel ``out_proj`` and Mamba-1's
    summed ``x_proj`` or Mamba-2's norm over the whole ``d_inner``; none
    without one (the mixers' defaults, the one-card path)."""
    tp = active()
    if tp is None or tp.channels is None:
        return {}
    hooks = {"column": lambda x, w: ColumnParallelProduct.apply(x, w, tp),
             "row": lambda a, w: RowParallelProduct.apply(a, w, tp)}
    if tp.ssm_heads is None:
        hooks["inner"] = lambda a, w: summed_product(a, w, tp)
    else:
        hooks["norm"] = lambda y, w, eps: rms_norm_over_model(
            y, w, eps, cfg.d_inner, tp)
    return hooks


class DispatchToExperts(torch.autograd.Function):
    """Each token's row repeated k times, one a top-k assignment (the MoE
    dispatch's input on every rank). Backward: the rows' gradients,
    nonzero for the rank's own assignments only, summed over k in fp32,
    all-reduced over ``model`` in fp32 and rounded once, as one card sums
    the k rows' gradients in fp32 and rounds once."""

    @staticmethod
    def forward(ctx, xt, k, tp):
        ctx.k, ctx.tp, ctx.dtype = k, tp, xt.dtype
        return xt.repeat_interleave(k, dim=0)

    @staticmethod
    def backward(ctx, g):
        dx = g.float().reshape(-1, ctx.k, g.shape[-1]).sum(dim=1)
        return ctx.tp.all_reduce(dx).to(ctx.dtype), None, None


class SumGradOverModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``model`` in fp32
    backward: the MoE gate values, whose gradient on a rank covers its
    own experts' assignments only. The sum makes the router's gradient
    whole on every rank, while the aux loss's share of it, whole already,
    is not summed."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.float().clone(
            memory_format=torch.contiguous_format)).to(g.dtype), None


class ExpertParallel:
    """``layers.moe_apply``'s ``experts`` hook under a context that splits
    the experts over ``model``: the rank's ``count`` experts from
    ``first``, the dispatch input (:class:`DispatchToExperts`), the gate
    values (:class:`SumGradOverModel`) and the combine, an fp32 partial
    sum all-reduced forward (:class:`ReduceFromModel`)."""

    def __init__(self, tp: TensorParallel):
        self.tp = tp
        self.first = tp.experts[0]
        self.count = tp.experts[1] - tp.experts[0]

    def dispatch(self, xt: torch.Tensor, k: int) -> torch.Tensor:
        return DispatchToExperts.apply(xt, k, self.tp)

    def gates(self, g: torch.Tensor) -> torch.Tensor:
        return SumGradOverModel.apply(g, self.tp)

    def combine(self, part: torch.Tensor) -> torch.Tensor:
        return ReduceFromModel.apply(part, self.tp)


def moe_hooks() -> dict:
    """``layers.moe_apply``'s keywords under the active context: the
    rank's experts (:class:`ExpertParallel`) when they split, the shared
    expert's column- and row-parallel products when its columns split;
    none without a context (the one-card path)."""
    tp = active()
    hooks = {}
    if tp is not None and tp.experts is not None:
        hooks["experts"] = ExpertParallel(tp)
    if tp is not None and tp.shared_ff:
        hooks["column"] = lambda x, w: ColumnParallelProduct.apply(x, w, tp)
        hooks["row"] = lambda a, w: RowParallelProduct.apply(a, w, tp)
    return hooks


def _parallel(part: str) -> Optional[TensorParallel]:
    tp = active()
    if tp is None:
        return None
    split = {"attn": tp.heads, "mlp": tp.ff, "head": tp.head_vocab}[part]
    return tp if split else None


def column_parallel(part: str):
    """The products that start ``part`` ("attn": q, k, v; "mlp": gate,
    up): :class:`ColumnParallelProduct` when the active context splits
    it, else ``torch.matmul``."""
    tp = _parallel(part)
    if tp is None:
        return torch.matmul
    return lambda x, w: ColumnParallelProduct.apply(x, w, tp)


def row_parallel(part: str):
    """The product that ends ``part`` ("attn": ``wo``, "mlp": ``w_down``):
    :class:`RowParallelProduct` when the active context splits it, else
    ``torch.matmul``."""
    tp = _parallel(part)
    if tp is None:
        return torch.matmul
    return lambda a, w: RowParallelProduct.apply(a, w, tp)


def attention_params(p):
    """The attention leaves a rank computes with: when kv is computed
    whole, wk / wv (and bk / bv) cut to the kv heads of the rank's q
    heads; else ``p``."""
    tp = active()
    if tp is None or tp.kv_heads is None:
        return p
    k0, k1 = (h * tp.head_dim for h in tp.kv_heads)
    out = dict(p)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            out[name] = p[name][..., k0:k1]
    return out


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; vocab-parallel when the active context splits the
    embedding's vocab: ``table`` is the rank's rows ``[v0, v0 + n)``."""
    tp = active()
    if tp is None or not tp.embed_vocab:
        return table[tokens.long()]
    n = table.shape[0]
    idx = tokens.long() - tp.rank * n
    outside = (idx < 0) | (idx >= n)
    x = table[idx.masked_fill(outside, 0)].masked_fill(outside[..., None], 0)
    return ReduceFromModel.apply(x, tp)


class VocabParallelCrossEntropy(torch.autograd.Function):
    """Per-token NLL over the whole vocab from each rank's slice of the
    head: B5's partials on the slice, all-gathered over ``model`` and
    combined in rank order, so every rank holds the same (nll, lse,
    correct). The backward is B5-bwd on the slice (local labels, the
    global lse): dW is the rank's slice; dh, partial, comes out in fp32
    and is all-reduced over ``model`` before it is rounded once."""

    @staticmethod
    def forward(ctx, hidden, w, labels, tp):
        v = w.shape[1]
        v0 = tp.rank * v
        local = torch.where((labels >= v0) & (labels < v0 + v), labels - v0,
                            torch.full_like(labels, -1))
        if hidden.is_cuda and uses_tensor_cores(w.dtype):
            w = xent.aligned_rows(w)
        parts = tp.all_gather(ops.cross_entropy_partials(hidden, w, local,
                                                         v0))
        nll, lse, correct = xent.combine_partials(parts, labels)
        ctx.save_for_backward(hidden, w, local, lse)
        ctx.tp = tp
        ctx.mark_non_differentiable(lse, correct)
        return nll, lse, correct

    @staticmethod
    def backward(ctx, g_nll, g_lse, g_correct):
        hidden, w, local, lse = ctx.saved_tensors
        dh, dw = ops.cross_entropy_bwd(hidden, w, local, lse, g_nll,
                                       dh_fp32=True)
        return ctx.tp.all_reduce(dh).to(hidden.dtype), dw, None, None


def vocab_parallel_cross_entropy(hidden, w, labels, tp: TensorParallel):
    """hidden (T, d) whole on every rank, w (d, V / M) the rank's slice,
    labels (T,) of the whole vocab -> (nll, lse, correct) as
    ``ops.cross_entropy`` over the whole vocab returns them; the gradient
    of hidden is summed over ``model``."""
    return VocabParallelCrossEntropy.apply(
        hidden.contiguous(), w.contiguous(),
        labels.to(torch.int32).contiguous(), tp)


def cross_entropy(hidden, w, labels):
    """``ops.cross_entropy``, or :func:`vocab_parallel_cross_entropy` when
    the active context splits the head's vocab."""
    tp = _parallel("head")
    if tp is None:
        return ops.cross_entropy(hidden, w, labels)
    return vocab_parallel_cross_entropy(hidden, w, labels, tp)


__all__ = ["ColumnParallelProduct", "DispatchToExperts", "ExpertParallel",
           "MAMBA2_PARTIAL", "ReduceFromModel", "RowParallelProduct",
           "SumGradOverModel", "SumOverModel", "TensorParallel",
           "VocabParallelCrossEntropy", "active", "attention_params",
           "column_parallel", "cross_entropy", "drop_model", "embed",
           "fp32_product", "mixer_hooks", "mixer_params", "model_only",
           "moe_hooks", "rms_norm_over_model", "row_parallel",
           "set_tensor_parallel", "summed_product",
           "vocab_parallel_cross_entropy"]
