"""Neural-net building blocks of the dense and MoE LMs, the Mamba-1 and
Mamba-2 SSMs and the encoder-decoder (cross-attention, GELU MLP), in
plain PyTorch (port of :mod:`repro.models.layers`).

Parameters are nested dicts of tensors with ``repro``'s key names and its
``(d_in, d_out)`` weight layout (``y = x @ W``), so the weights bridge is
key-for-key with no transposes. Attention in prefill and in paged decode
goes through :mod:`repro_torch.kernels.ops` (the CUDA kernels on the card,
their plain versions on the CPU), differentiably in training; contiguous
decode attention stays plain torch, as it is plain JAX in ``repro``. The
speculative window's attention goes through the spec-verify kernel and a
Mamba-1 or Mamba-2 prefill's scan through the selective-scan kernel; the
one-token SSM decode update stays plain torch, as ``repro`` computes it
outside any kernel.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig, ParamSpec

_NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Nested dict/list tree utilities (dict keys visited in sorted order and
# list items in order, as jax.tree_util flattens them)
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_unflatten(tree, leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in ``tree_leaves``
    order, by the items of ``leaves``."""
    return _rebuild(tree, iter(leaves))


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, item, *(r[i] for r in rest))
                for i, item in enumerate(tree)]
    return fn(tree, *rest)


def materialize(spec_tree, generator: torch.Generator, dtype: torch.dtype,
                device) -> Any:
    """Randomly initialize parameters from a spec tree, with ``repro``'s
    rules (``repro.models.layers.materialize``): one draw per leaf, in
    flattened order, from ``generator`` (which lives on ``device``).

    As in ``repro``, a fan-in scaled leaf takes ``shape[0]`` as its fan-in,
    which for a layer-stacked leaf is the layer count — kept as it is so a
    random-init model has the same weight scales as ``repro``'s."""
    def one(spec: ParamSpec):
        dt = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        if spec.init == "ssm_a":
            # mamba: A = -exp(A_log); A_log = log(1..N) broadcast, in fp32
            n = spec.shape[-1]
            base = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                          device=device))
            return base.expand(spec.shape).to(torch.float32).contiguous()
        noise = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=device)
        if spec.init == "embed":
            return (noise * (0.02 * spec.scale)).to(dt)
        if spec.init != "normal":
            raise NotImplementedError(f"init rule {spec.init!r} is not "
                                      f"ported yet")
        fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        return (noise * std).to(dt)

    # draw in flattened (sorted-key) order so init is a pure function of
    # the generator's seed, independent of dict insertion order
    values = iter([one(spec) for spec in tree_leaves(spec_tree)])
    return _rebuild(spec_tree, values)


def _rebuild(tree, values):
    """``tree``'s structure with its leaves replaced, in flattened order,
    by successive items of ``values``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(item, values) for item in tree]
    return next(values)


# ---------------------------------------------------------------------------
# Norms & positional encodings
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rotary_angles(positions, head_dim: int, theta: float):
    """positions (...,) -> (cos, sin) of shape (..., head_dim//2), fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, cos, sin):
    """x (..., S, H, hd); cos/sin broadcastable to (..., S, 1, hd//2)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention for prefill and training. q: (B, S, Hq,
    hd); k, v: (B, T, Hkv, hd). Runs the flash-attention kernels on the
    card (their plain versions on the CPU); with grad enabled the result
    is differentiable through the backward kernel, the counterpart of
    ``repro``'s custom VJP ``_bw_attn_bwd``. ``repro``'s q/kv chunk sizes
    are TPU schedule knobs that the kernels' own tiling replaces."""
    return ops.attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, pos, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffered) KV cache,
    plain torch exactly as ``repro.models.layers.decode_attention``.

    q: (B, 1, Hq, hd); caches: (B, C, Hc, hd) with Hc dividing Hq; pos a
    (B,) tensor of absolute positions of the new tokens."""
    b, _, hq, hd = q.shape
    c, hc = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hc
    qr = q.reshape(b, 1, hc, rep, hd)
    s = torch.einsum("bqhrd,bkhd->bqhrk", qr.float(),
                     k_cache.float()) / math.sqrt(hd)
    pos = pos.long().expand(b)
    n_valid = torch.clamp(pos + 1, max=c)
    idx = torch.arange(c, device=q.device)
    valid = idx[None, :] < n_valid[:, None]
    if window is not None and c > window:
        valid &= idx[None, :] > pos[:, None] - window
    s = s.masked_fill(~valid[:, None, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhrk,bkhd->bqhrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype).reshape(b, 1, hq, hd)


def paged_decode_attention(q, k_pages, v_pages, page_table,
                           pos) -> torch.Tensor:
    """Single-token attention over a paged KV cache. q: (B, 1, Hq, hd);
    pages: (NP, P, Hc, hd); page_table (B, M) int32; pos (B,) int32.
    Runs the paged-attention kernel on the card (its plain version on the
    CPU)."""
    b, _, hq, hd = q.shape
    out = ops.paged_attention(q.reshape(b, hq, hd).contiguous(), k_pages,
                              v_pages, page_table, pos)
    return out.reshape(b, 1, hq, hd)


def paged_window_attention(q, k_pages, v_pages, page_table,
                           q_pos) -> torch.Tensor:
    """W-query speculative-window attention over a paged KV cache. q: (B,
    W, Hq, hd); pages (NP, P, Hc, hd); page_table (B, M) int32; q_pos (B,
    W) int32, the absolute position of each window lane (lanes past a
    row's window point at a scratch position whose output is discarded).
    Key k is visible to lane i iff k <= q_pos[b, i], so a one-token window
    is plain paged decode. Runs the spec-verify kernel on the card (its
    plain version on the CPU)."""
    return ops.spec_verify(q.contiguous(), k_pages, v_pages, page_table,
                           q_pos)


def attention_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    specs = {
        "wq": ParamSpec((d, hq * hd), ("embed", "heads")),
        "wk": ParamSpec((d, hkv * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, hkv * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((hq * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((hq * hd,), ("heads",), init="zeros")
        specs["bk"] = ParamSpec((hkv * hd,), ("kv_heads",), init="zeros")
        specs["bv"] = ParamSpec((hkv * hd,), ("kv_heads",), init="zeros")
    return specs


def attention_qkv(p, x, cfg: ModelConfig, positions, *, rope: bool = True,
                  matmul=torch.matmul):
    """Project to q, k, v (+bias, +rotary unless ``rope`` is false or the
    config has learned positions). x: (B, S, d). ``matmul`` computes the
    three products (tensor parallelism passes a column-parallel one)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = matmul(x, p["wq"])
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if rope and not cfg.learned_pos_embed:
        cos, sin = rotary_angles(positions, hd, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    return q, k, v


def cross_attention_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return attention_specs(cfg)


def cross_attention(p, x, enc, cfg: ModelConfig, matmul=torch.matmul,
                    row=torch.matmul):
    """x: (B, S, d) queries; enc: (B, T, d) encoder states (no rotary).
    Non-causal attention of the S queries over the T encoder rows through
    :func:`blockwise_attention` (the flash-attention kernel). ``matmul``
    computes the q, k and v products and ``row`` the ``wo`` product
    (tensor parallelism passes column- and row-parallel ones: k's and
    v's input gradient is then summed over the ranks onto ``enc``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = matmul(x, p["wq"]).reshape(b, s, -1, hd)
    k = matmul(enc, p["wk"]).reshape(b, enc.shape[1], -1, hd)
    v = matmul(enc, p["wv"]).reshape(b, enc.shape[1], -1, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(1, 1, -1, hd)
        k = k + p["bk"].reshape(1, 1, -1, hd)
        v = v + p["bv"].reshape(1, 1, -1, hd)
    out = blockwise_attention(q, k, v, causal=False)
    return row(out.reshape(b, s, -1), p["wo"])


# ---------------------------------------------------------------------------
# MLPs (SwiGLU; whisper's two-matrix GELU MLP)
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None,
              gelu: bool = False) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if gelu:
        return {"w_in": ParamSpec((d, ff), ("embed", "ff")),
                "b_in": ParamSpec((ff,), ("ff",), init="zeros"),
                "w_out": ParamSpec((ff, d), ("ff", "embed")),
                "b_out": ParamSpec((d,), ("embed",), init="zeros")}
    return {"w_gate": ParamSpec((d, ff), ("embed", "ff")),
            "w_up": ParamSpec((d, ff), ("embed", "ff")),
            "w_down": ParamSpec((ff, d), ("ff", "embed"))}


def mlp_apply(p, x, gelu: bool = False, column=torch.matmul,
              row=torch.matmul):
    """The MLP; ``column`` computes its first products and ``row`` its
    last (tensor parallelism passes column- and row-parallel ones; the
    output bias is added after the last)."""
    if gelu:
        # jax.nn.gelu's default is the tanh approximation, in fp32
        h = F.gelu((column(x, p["w_in"]) + p["b_in"]).float(),
                   approximate="tanh")
        return row(h.to(x.dtype), p["w_out"]) + p["b_out"]
    g = F.silu(column(x, p["w_gate"]).float()).to(x.dtype)
    return row(g * column(x, p["w_up"]), p["w_down"])


# ---------------------------------------------------------------------------
# Mixture of experts (top-k, capacity-dropped, scatter-based dispatch)
# ---------------------------------------------------------------------------

def moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, e = cfg.d_model, cfg.num_experts
    ffe = cfg.d_ff_expert or cfg.d_ff
    specs: Dict[str, Any] = {
        "router": ParamSpec((d, e), ("embed", None)),
        "w_gate": ParamSpec((e, d, ffe), ("experts", "embed", "expert_ff")),
        "w_up": ParamSpec((e, d, ffe), ("experts", "embed", "expert_ff")),
        "w_down": ParamSpec((e, ffe, d), ("experts", "expert_ff", "embed")),
    }
    if cfg.moe_shared_expert:
        specs["shared"] = mlp_specs(cfg, d_ff=cfg.d_ff)
    return specs


def top_k_stable(x, k: int):
    """The k largest entries of the last axis, largest first, with equal
    values in ascending index order as ``jax.lax.top_k`` returns them
    (``torch.topk`` leaves the order of ties unspecified). Returns
    (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(tokens: int, cfg: ModelConfig, groups: int = 1) -> int:
    """Slots per expert (and per group), in ``repro``'s float order."""
    e, k = cfg.num_experts, cfg.experts_per_token
    return max(int(math.ceil(tokens * k / e / groups
                             * cfg.moe_capacity_factor)), 1)


class BatchShards:
    """A step's rows split over the ranks of the batch axes: ``shards``
    contiguous blocks in rank order (the rows' order), this rank holding
    block ``index``; ``gather(t)`` all-gathers ``t`` over those ranks,
    (shards, *t.shape) in rank order. While one is set
    (:func:`set_batch_shards`), :func:`moe_route` places the rank's
    assignments as one dispatch over every shard's tokens would: capacity
    from the global token count, each assignment's position offset by the
    counts of the ranks before it (E int64s a rank a layer, gathered), and
    :func:`moe_apply`'s aux loss is the rank's share of the global one
    (``repro``'s gspmd program runs ``moe_apply`` once over the global
    batch)."""

    def __init__(self, shards: int, index: int, gather: Callable):
        self.shards, self.index, self.gather = shards, index, gather


_SHARDS = threading.local()


def set_batch_shards(ctx: Optional[BatchShards]) -> Optional[BatchShards]:
    """Make ``ctx`` the batch split the MoE dispatch consults in this
    thread (None: each call dispatches over its own tokens, the one-card
    path); returns the one it replaces."""
    prev = batch_shards()
    _SHARDS.ctx = ctx
    return prev


def batch_shards() -> Optional[BatchShards]:
    return getattr(_SHARDS, "ctx", None)


def _global_positions(expert_idx, cfg: ModelConfig, groups: int,
                      shards: BatchShards):
    """:func:`moe_route`'s plan for a rank's tokens under ``shards``:
    (slot, keep, per-expert counts over every shard, rows C' of a (group,
    expert) cell in the rank's buffer). A rank's assignment j is global
    assignment ``index · n + j``, in group ``(index · n + j) // (n · S /
    G)``; its position is its running count among the rank's assignments
    of its (group, expert) cell plus that cell's counts on the ranks
    before. Its slot is the running count alone: the rank's buffer holds
    its own rows, at most C' = min(C, T) a cell (top-k experts are
    distinct, so a token adds at most one to a cell)."""
    e = cfg.num_experts
    tokens, k = expert_idx.shape
    n = tokens * k
    capacity = moe_capacity(tokens * shards.shards, cfg, groups)
    per_group = n * shards.shards // groups
    first = shards.index * n
    glob = torch.arange(first, first + n, device=expert_idx.device)
    cell = torch.div(glob, per_group, rounding_mode="floor") * e \
        + expert_idx.reshape(-1)
    onehot = F.one_hot(cell, groups * e).T.contiguous()      # (G E, n)
    running = onehot.cumsum(-1)
    every = shards.gather(running[:, -1].contiguous())       # (S, G E)
    before = every[:shards.index].sum(dim=0)
    pos = running.gather(0, cell[None])[0] - 1
    keep = pos + before[cell] < capacity
    rows = min(capacity, tokens)
    slot = cell * rows + torch.where(keep, pos, torch.zeros_like(pos))
    counts = every.sum(dim=0).reshape(groups, e).sum(dim=0)
    return slot, keep, counts, rows


def moe_route(p, xt, cfg: ModelConfig, groups: int = 1):
    """The router and dispatch plan of :func:`moe_apply` for tokens xt
    (T, d), in ``groups`` groups (dividing T).

    Router softmax in fp32; the top k by a stable sort (lower expert
    first among equal probabilities); gates renormalized over the k
    chosen (floor 1e-9); assignments flattened token-major, k-minor, each
    placed at its running count within its expert (and group) and kept
    below ``capacity``. Returns (probs (T, E) fp32, gates (T, k) fp32,
    slot (G Tl,) int64 index of each assignment's row in the flattened
    (G, E, C) buffer (row C·(g E + e) for a dropped one), keep (G Tl,)
    bool, per-expert assignment counts (E,) int64, capacity C).

    Under :class:`BatchShards` (``groups`` then divides the global token
    count) the plan is ``_global_positions``': the buffer's C rows a cell
    are the rank's, and the counts are every shard's."""
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = xt.shape[0]
    logits = (xt @ p["router"]).float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_stable(probs, k)            # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    shards = batch_shards()
    if shards is not None:
        return (probs, gate_vals) + _global_positions(expert_idx, cfg,
                                                      groups, shards)
    capacity = moe_capacity(tokens, cfg, groups)
    flat_expert = expert_idx.reshape(groups, tokens * k // groups)
    # running count of each expert along the assignments, scanned along
    # the last (contiguous) axis: (G, E, Tl). A scan along the middle
    # axis of (G, Tl, E), as repro writes it, runs on the card as E
    # serial chains of Tl steps (~4 ms a layer at Tl = 16384).
    onehot = F.one_hot(flat_expert, e).transpose(1, 2).contiguous()
    running = onehot.cumsum(-1)
    pos = running.gather(1, flat_expert[:, None, :])[:, 0] - 1
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, torch.zeros_like(pos))
    group = torch.arange(groups, device=xt.device)[:, None]
    slot = (group * e + flat_expert) * capacity + safe_pos
    counts = running[..., -1].sum(dim=0)
    return (probs, gate_vals, slot.reshape(-1), keep.reshape(-1), counts,
            capacity)


def expert_ffn(p, buf, dtype):
    """SwiGLU experts over the dispatch buffer (G, E, C, d): the gate and
    up products in fp32 (bf16 inputs multiply exactly in fp32 and sum
    there, as ``preferred_element_type`` does in ``repro``), SiLU and
    gating in fp32, ``h`` in ``dtype`` for the ``w_down`` product."""
    g = F.silu(torch.einsum("gecd,edf->gecf", buf.float(),
                            p["w_gate"].float()))
    u = torch.einsum("gecd,edf->gecf", buf.float(), p["w_up"].float())
    return torch.einsum("gecf,efd->gecd", (g * u).to(dtype), p["w_down"])


def expert_slots(slot, keep, capacity: int, num_experts: int, first: int,
                 count: int):
    """The assignments of experts ``[first, first + count)`` in a buffer
    of those experts alone: (slot (n,) in the (G, count, C) buffer,
    mine (n,) bool: kept and routed to one of them). ``slot`` indexes the
    (G, E, C) buffer; an assignment to another expert is not the rank's,
    and its slot (0) carries nothing."""
    cell = torch.div(slot, capacity, rounding_mode="floor")
    expert = cell % num_experts
    mine = keep & (expert >= first) & (expert < first + count)
    local = ((torch.div(cell, num_experts, rounding_mode="floor") * count
              + expert - first) * capacity + slot % capacity)
    return torch.where(mine, local, torch.zeros_like(local)), mine


def _parallel_experts(p, xt, gate_vals, slot, keep, capacity: int,
                      groups: int, cfg: ModelConfig, experts):
    """The routed experts' output (T, d) with ``p``'s expert leaves the
    rank's experts ``[experts.first, experts.first + experts.count)``:
    the rank scatters only its assignments (``expert_slots``) into its
    (G, E/M, C, d) buffer, runs them, gathers them back and sums its
    gate-weighted outputs over k in fp32; ``experts.combine`` sums that
    over the ranks and it is rounded once. Backward, ``experts.dispatch``
    and ``experts.gates`` sum the input's and the gate values' gradients
    (each rank's covers its own assignments) over the ranks."""
    tokens, d = xt.shape
    k = cfg.experts_per_token
    local, mine = expert_slots(slot, keep, capacity, cfg.num_experts,
                               experts.first, experts.count)
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    mine_col = mine[:, None]
    upd = torch.where(mine_col, experts.dispatch(xt, k), zero)
    buf = xt.new_zeros((groups * experts.count * capacity, d)).index_add(
        0, local, upd)
    out_buf = expert_ffn(p, buf.reshape(groups, experts.count, capacity, d),
                         xt.dtype)
    gathered = torch.where(mine_col, out_buf.reshape(-1, d)[local], zero)
    gates = experts.gates(gate_vals).reshape(-1, 1).to(xt.dtype)
    part = (gathered * gates).reshape(tokens, k, d).float().sum(dim=1)
    return experts.combine(part).to(xt.dtype)


def moe_apply(p, x, cfg: ModelConfig, experts=None, column=torch.matmul,
              row=torch.matmul):
    """Top-k routed experts with static capacity, as
    ``repro.models.layers.moe_apply``. x: (B, S, d) -> (y, aux_loss).

    :func:`moe_route` plans the dispatch; kept assignments are scattered
    (``index_add``, no host sync) into a zeroed (G, E, C, d) buffer,
    :func:`expert_ffn` runs the experts, and each assignment's output is
    gathered back (dropped ones contribute zero), weighted by its gate in
    x's dtype and summed over k in x's dtype. With ``cfg.moe_groups = G``
    (dividing the token count) dispatch runs within G independent token
    groups, each with its own capacity. The expert products are plain
    batched matmuls, as ``repro`` leaves them to XLA outside any Pallas
    kernel. Returns the output (plus the shared expert's, if any) and the
    Switch load-balance loss E * sum_e f_e p_e * ``router_aux_loss``.

    Tensor parallelism passes ``experts`` (``launch.tensor_parallel.
    ExpertParallel``; ``p``'s expert leaves are then the rank's experts,
    ``_parallel_experts``) and the shared expert's ``column`` and ``row``
    products. Under :class:`BatchShards` the token count of the capacity
    and of the groups is the global one, and the aux loss is the rank's
    share of the global loss: E * sum_e f_e^global * (the sum of the
    rank's probs_e) / T_global * ``router_aux_loss``; the shares sum to
    it over the ranks."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = b * s
    shards = batch_shards()
    total = tokens * (shards.shards if shards is not None else 1)
    grp = cfg.moe_groups if cfg.moe_groups and total % cfg.moe_groups == 0 \
        else 1
    xt = x.reshape(tokens, d)
    probs, gate_vals, slot, keep, counts, capacity = moe_route(p, xt, cfg,
                                                               grp)
    if experts is not None:
        y = _parallel_experts(p, xt, gate_vals, slot, keep, capacity, grp,
                              cfg, experts)
    else:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        keep_col = keep[:, None]
        upd = torch.where(keep_col, xt.repeat_interleave(k, dim=0), zero)
        buf = x.new_zeros((grp * e * capacity, d)).index_add(0, slot, upd)
        out_buf = expert_ffn(p, buf.reshape(grp, e, capacity, d), x.dtype)
        gathered = torch.where(keep_col, out_buf.reshape(-1, d)[slot], zero)
        weighted = gathered * gate_vals.reshape(-1, 1).to(x.dtype)
        y = weighted.reshape(tokens, k, d).sum(dim=1)
    if cfg.moe_shared_expert:
        y = y + mlp_apply(p["shared"], xt, column=column, row=row)
    if shards is None:
        fe = counts.float() / tokens / k
        aux = e * torch.sum(fe * probs.mean(dim=0)) * cfg.router_aux_loss
    else:
        fe = counts.float() / total / k
        aux = (e * torch.sum(fe * (probs.sum(dim=0) / total))
               * cfg.router_aux_loss)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# State-space blocks (Mamba-1, Mamba-2)
# ---------------------------------------------------------------------------

def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, S, C); w: (C, K); b: (C,).

    If ``state`` (B, K-1, C) is given, performs streaming conv (decode) and
    returns (y, new_state)."""
    k = w.shape[1]
    if state is not None:
        xin = torch.cat([state, x], dim=1)                   # (B, K-1+S, C)
        new_state = xin[:, -(k - 1):, :]
    else:
        xin = F.pad(x, (0, 0, k - 1, 0))
        new_state = None
    y = sum(xin[:, i:i + x.shape[1], :] * w[:, i][None, None, :]
            for i in range(k))
    y = y + b[None, None, :]
    y = F.silu(y.float()).to(x.dtype)
    return (y, new_state) if state is not None else y


def mamba1_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "inner")),
        "conv_w": ParamSpec((di, cfg.ssm_conv), ("inner", None)),
        "conv_b": ParamSpec((di,), ("inner",), init="zeros"),
        "x_proj": ParamSpec((di, r + 2 * n), ("inner", None)),
        "dt_proj": ParamSpec((r, di), (None, "inner")),
        "dt_bias": ParamSpec((di,), ("inner",), init="zeros"),
        "a_log": ParamSpec((di, n), ("inner", None), init="ssm_a",
                           dtype=torch.float32),
        "d_skip": ParamSpec((di,), ("inner",), init="ones",
                            dtype=torch.float32),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def mamba1_apply(p, x, cfg: ModelConfig, state=None,
                 return_state: bool = False, column=torch.matmul,
                 row=torch.matmul, inner=torch.matmul):
    """Mamba-1 selective SSM. x: (B, S, d).

    state: None (training/prefill from zero) or dict(conv (B, K-1, di),
    ssm (B, di, N)) for streaming decode. Returns y or (y, new_state);
    ``return_state=True`` makes the stateless (prefill) path also return
    the final streaming state. The prefill scan runs the selective-scan
    kernel (``ops.selective_scan``) on the card; ``repro`` computes the
    same recurrence with its chunked associative scan in plain JAX.

    The channels are ``p``'s (``in_proj`` holds x's columns, then z's):
    tensor parallelism passes a rank's channels with ``column`` for the
    in_proj product, ``inner`` for the x_proj product (summed over the
    ranks) and ``row`` for out_proj."""
    s = x.shape[1]
    n, r = cfg.ssm_state, cfg.dt_rank
    di = p["in_proj"].shape[-1] // 2
    xz = column(x, p["in_proj"])
    xs, z = xz.split(di, dim=-1)                              # (B,S,di) each
    if state is not None:
        xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"],
                                      state["conv"])
    else:
        kq = cfg.ssm_conv - 1
        conv_in_tail = F.pad(xs, (0, 0, max(kq - s, 0), 0))[:, -kq:, :]
        xs = _causal_conv(xs, p["conv_w"], p["conv_b"])
        conv_state = conv_in_tail if return_state else None

    proj = inner(xs, p["x_proj"])                             # (B,S,r+2N)
    dt_in, bmat, cmat = proj.split([r, n, n], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"] + p["dt_bias"]).float())
    a = -torch.exp(p["a_log"])                                # (di,N) f32

    if state is not None:
        # one-token update, plain torch as in repro: a_bar = exp(dt*A),
        # b_bar*x = dt * B * x
        a_bar = torch.exp(dt[:, 0, :, None] * a[None])        # (B,di,N)
        bx = (dt[:, 0] * xs[:, 0].float())[..., None] \
            * bmat[:, 0].float()[:, None, :]
        h = a_bar * state["ssm"] + bx
        y = (h * cmat[:, 0].float()[:, None, :]).sum(-1)[:, None]
        new_ssm = h
    else:
        y, new_ssm = ops.selective_scan(xs, dt, a, bmat, cmat)
    y = y + p["d_skip"][None, None] * xs.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = row(y, p["out_proj"])
    if state is not None or return_state:
        return out, {"conv": conv_state, "ssm": new_ssm}
    return out


def mamba2_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_num_heads
    conv_dim = di + 2 * n
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * n + nh), ("embed", "inner")),
        "conv_w": ParamSpec((conv_dim, cfg.ssm_conv), ("inner", None)),
        "conv_b": ParamSpec((conv_dim,), ("inner",), init="zeros"),
        "a_log": ParamSpec((nh,), (None,), init="ssm_a",
                           dtype=torch.float32),
        "dt_bias": ParamSpec((nh,), (None,), init="zeros",
                             dtype=torch.float32),
        "d_skip": ParamSpec((nh,), (None,), init="ones",
                            dtype=torch.float32),
        "norm_w": ParamSpec((di,), ("inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def mamba2_apply(p, x, cfg: ModelConfig, state=None,
                 return_state: bool = False, column=torch.matmul,
                 row=torch.matmul, norm=rms_norm):
    """Mamba-2 (SSD, scalar decay per head, ngroups=1). x: (B, S, d).

    state: None (training/prefill from zero) or dict(conv (B, K-1, di+2N),
    ssm (B, nh, hd, N)) for streaming decode; returns as
    :func:`mamba1_apply` does. With one group the recurrence is the
    selective scan's, one decay a head (``ops.selective_scan_heads``): x
    the (B, S, di) channels, dt (B, S, nh) and A = -exp(a_log) per head,
    B and C the shared (B, S, N) rows. Its forward is the per-head B4
    (one exp(dt A) a (b, t, head)); under grad its backward is the
    per-head B4-bwd, which returns d(dt) and dA per head.
    y is ``repro``'s hs . C and h_last (B, di, N) the (B, nh, hd, N)
    state, so ``repro``'s (B, S, nh, hd, N) ``bx`` is never built. The
    one-token decode update stays plain torch, as in ``repro``.

    The heads are ``p``'s (``a_log``'s): tensor parallelism passes a
    rank's heads, ``in_proj`` and the conv cut to their z, x and dt and
    the whole B and C, with ``column`` for the in_proj product, ``row``
    for out_proj and ``norm`` for the RMSNorm over the whole
    ``d_inner``."""
    b, s, _ = x.shape
    n, nh = cfg.ssm_state, p["a_log"].shape[-1]
    hd = cfg.d_inner // cfg.ssm_num_heads
    di = nh * hd
    zxbcdt = column(x, p["in_proj"])
    z, xbc, dt_in = zxbcdt.split([di, di + 2 * n, nh], dim=-1)
    if state is not None:
        xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                       state["conv"])
    else:
        kq = cfg.ssm_conv - 1
        conv_in_tail = F.pad(xbc, (0, 0, max(kq - s, 0), 0))[:, -kq:, :]
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
        conv_state = conv_in_tail if return_state else None
    xs, bmat, cmat = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt_in.float() + p["dt_bias"][None, None])  # (B,S,nh)
    xh = xs.reshape(b, s, nh, hd).float()

    if state is not None:
        # one-token update, plain torch as in repro; h (B, nh, hd, N)
        a_bar = torch.exp(dt[:, 0] * -torch.exp(p["a_log"]))  # (B,nh)
        bx = (dt[:, 0, :, None, None] * xh[:, 0, :, :, None]) \
            * bmat[:, 0].float()[:, None, None, :]
        h = a_bar[..., None, None] * state["ssm"] + bx
        y = (h * cmat[:, 0].float()[:, None, None, :]).sum(-1)[:, None]
        new_ssm = h
    else:
        y, h_last = ops.selective_scan_heads(xs, dt, -torch.exp(p["a_log"]),
                                             bmat, cmat)
        y = y.reshape(b, s, nh, hd)
        new_ssm = h_last.reshape(b, nh, hd, n)
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(b, s, di) * F.silu(z.float())
    y = norm(y.to(x.dtype), p["norm_w"], cfg.norm_eps)
    out = row(y, p["out_proj"])
    if state is not None or return_state:
        return out, {"conv": conv_state, "ssm": new_ssm}
    return out


def ssm_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, tuple]:
    """Decode-state shapes for one SSM block."""
    k = cfg.ssm_conv - 1
    if cfg.ssm_variant == "mamba1":
        return {"conv": (batch, k, cfg.d_inner),
                "ssm": (batch, cfg.d_inner, cfg.ssm_state)}
    return {"conv": (batch, k, cfg.d_inner + 2 * cfg.ssm_state),
            "ssm": (batch, cfg.ssm_num_heads,
                    cfg.d_inner // cfg.ssm_num_heads, cfg.ssm_state)}
