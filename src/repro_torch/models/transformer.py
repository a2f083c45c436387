"""Decoder-only LM of the dense, moe, vlm, ssm (Mamba-1) and hybrid
(Mamba-2 with a shared attention block, zamba2) families, and the
encoder-decoder of the audio family (whisper, :class:`EncDecModel`): the
training loss, its PSL split, prefill and decode (port of
:mod:`repro.models.transformer`).

An MoE block routes its MLP through :func:`repro_torch.models.layers.
moe_apply` in training, prefill and every decode step; the training loss
adds the blocks' load-balance losses (``aux_loss``), as ``repro``'s scan
carry sums them. A VLM batch may carry ``patches`` (B, P, d), embeddings
prepended to the text tokens' (the vision encoder is not part of the
model, as in ``repro``); the loss pads labels and weights with P zero
columns, and a prefill with patches fills the cache at positions 0..P+S-1.

Parameters are split into ``client`` and ``server`` subtrees at the
paper's cut layer, with every block's leaves stacked on a leading layer
axis, key-for-key as in ``repro``. Layers run as a Python loop over that
axis (``repro`` scans them). KV caches keep ``repro``'s layout and its
``kv_repeat`` head replication, so cache bytes and page budgets equal
``repro``'s.

Where ``repro``'s decode steps return a new cache (JAX donates the old
buffers), the port writes the new token's K/V (or an SSM block's new conv
and ssm state) into the cache tensors in place and returns the same cache
object. The speculative verify step (:meth:`LanguageModel.
decode_window_paged`) writes every window position's K/V in place the same
way.

Training runs the same blocks with autograd: attention through the
flash-attention kernels' ``autograd.Function`` and the loss through the
fused cross-entropy kernels (:func:`chunked_xent`). ``cfg.remat`` is a
memory policy in ``repro`` (``jax.checkpoint`` per block); it does not
change results, and the port keeps every activation instead — the
full-width granite step fits the card without recomputation.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, ParamSpec
from repro_torch.launch import tensor_parallel as tp


def stack_specs(specs, n: int):
    """Prepend a stacked `layers` dim of size n to every spec in a tree."""
    return L.tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                            init=s.init, dtype=s.dtype, scale=s.scale),
        specs)


def _layer(stacked, i: int):
    return L.tree_map(lambda x: x[i], stacked)


def _num_layers(stacked) -> int:
    return L.tree_leaves(stacked)[0].shape[0]


def _stack_trees(trees):
    """Per-layer trees (dicts of tensors) -> one tree stacked on a new
    leading axis."""
    return {k: (_stack_trees([t[k] for t in trees])
                if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees]))
            for k in trees[0]}


def _zeros(specs, dtype, device):
    """Zero tensors of a spec tree (a spec's own dtype, else ``dtype``)."""
    return L.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype or dtype,
                                            device=device), specs)


def _unstack(stacked):
    """Per-layer parameter trees of a stacked tree, through one ``unbind``
    per leaf: autograd then stacks the layers' gradients once, where
    indexing layer by layer would add a zero-filled stacked-size gradient
    for every layer."""
    parts = L.tree_map(lambda x: x.unbind(0), stacked)

    def pick(tree, i: int):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    return [pick(parts, i) for i in range(_num_layers(stacked))]


def chunked_xent(hidden, w_vocab, labels, weights):
    """Weighted mean cross-entropy through the fused cross-entropy kernels
    (``repro``'s ``chunked_xent``, whose chunking is a TPU memory schedule
    the kernels' own vocab tiling replaces: the (B, S, V) logits are
    never materialized).

    hidden: (B, S, d); w_vocab: (d, V); labels, weights: (B, S).
    Returns (loss, (weighted_token_count, correct_count)). Under tensor
    parallelism with the head's vocab split, ``w_vocab`` is the rank's
    slice and the loss is vocab-parallel (``launch.tensor_parallel``).
    """
    d = hidden.shape[-1]
    nll, _, correct = tp.cross_entropy(hidden.reshape(-1, d), w_vocab,
                                       labels.reshape(-1))
    w = weights.reshape(-1).float()
    tot = (nll * w).sum()
    cnt = w.sum()
    cor = (correct.float() * w).sum()
    loss = tot / torch.clamp(cnt, min=1e-6)
    return loss, (cnt, cor)


class _Blocks:
    """Attention (dense-MLP or MoE) and SSM (Mamba-1 or Mamba-2) block
    definitions used by LanguageModel."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.is_ssm = cfg.family in ("ssm", "hybrid")
        mamba2 = cfg.ssm_variant == "mamba2"
        self._mixer_specs = L.mamba2_specs if mamba2 else L.mamba1_specs
        self._mixer = L.mamba2_apply if mamba2 else L.mamba1_apply

    def block_specs(self) -> Dict[str, Any]:
        if self.is_ssm:
            return self.ssm_block_specs()
        return self.attn_block_specs()

    def ssm_block_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {"norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
                "mixer": self._mixer_specs(cfg)}

    def attn_block_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        specs: Dict[str, Any] = {
            "norm1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            "attn": L.attention_specs(cfg),
            "norm2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        }
        if cfg.is_moe:
            specs["moe"] = L.moe_specs(cfg)
        else:
            specs["mlp"] = L.mlp_specs(cfg)
        return specs

    def ffn(self, p, hn):
        """The block's MLP or routed experts: (y, aux_loss or None). Under
        tensor parallelism the MLP is column- then row-parallel, and the
        rank computes its experts (``tensor_parallel.moe_hooks``)."""
        if self.cfg.is_moe:
            return L.moe_apply(p["moe"], hn, self.cfg, **tp.moe_hooks())
        return L.mlp_apply(p["mlp"], hn, column=tp.column_parallel("mlp"),
                           row=tp.row_parallel("mlp")), None

    # ----- train / prefill -----
    def block(self, p, x, positions, *, window):
        """Full-sequence block (training and prefill); returns (x, k, v,
        aux_loss or None). Under tensor parallelism (``launch.
        tensor_parallel``) the rank computes its q and kv heads, and the
        ``wo`` product's partial sums are all-reduced over ``model``."""
        cfg = self.cfg
        b, s, _ = x.shape
        hn = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(tp.attention_params(p["attn"]), hn, cfg,
                                  positions,
                                  matmul=tp.column_parallel("attn"))
        attn_out = L.blockwise_attention(q, k, v, causal=True,
                                         window=window)
        x = x + tp.row_parallel("attn")(attn_out.reshape(b, s, -1),
                                        p["attn"]["wo"])
        hn = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        y, aux = self.ffn(p, hn)
        return x + y, k, v, aux

    def attn_block(self, p, x, positions, *, window):
        """Prefill block; returns (x, (k_rep, v_rep)) for the cache."""
        x, k, v, _ = self.block(p, x, positions, window=window)
        return x, (self._repeat_kv(k), self._repeat_kv(v))

    def ssm_block(self, p, x):
        """Full-sequence SSM block (training). Under tensor parallelism
        the rank computes its channels of the mixer (``launch.
        tensor_parallel.mixer_params`` and ``mixer_hooks``)."""
        cfg = self.cfg
        hn = L.rms_norm(x, p["norm"], cfg.norm_eps)
        return x + self._mixer(tp.mixer_params(p["mixer"], cfg), hn, cfg,
                               **tp.mixer_hooks(cfg))

    def ssm_block_prefill(self, p, x):
        """Prefill block; returns (x, {"conv", "ssm"}) decode state."""
        hn = L.rms_norm(x, p["norm"], self.cfg.norm_eps)
        y, st = self._mixer(p["mixer"], hn, self.cfg, return_state=True)
        return x + y, st

    # ----- decode -----
    def _mlp_tail(self, p, x, attn_out):
        b, w = x.shape[0], x.shape[1]
        x = x + attn_out.reshape(b, w, -1) @ p["attn"]["wo"]
        hn2 = L.rms_norm(x, p["norm2"], self.cfg.norm_eps)
        return x + self.ffn(p, hn2)[0]

    def attn_decode(self, p, x, kc, vc, pos, *, window):
        """One token's attention (``p``: norm1 and attn) over a contiguous
        cache (B, C, Hc, hd): writes the token's K/V at slot ``pos % C``
        in place and returns the attention output (B, 1, Hq, hd)."""
        cfg = self.cfg
        b = x.shape[0]
        hn = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], hn, cfg, pos[:, None])
        slot = pos % kc.shape[1]
        bidx = torch.arange(b, device=x.device)
        kc[bidx, slot] = self._repeat_kv(k)[:, 0]
        vc[bidx, slot] = self._repeat_kv(v)[:, 0]
        # Ring cache (cache_len == window): slot-validity masking suffices.
        # Full cache with a window: pass the window so old keys are masked.
        eff_window = (None if (window is not None and kc.shape[1] <= window)
                      else window)
        return L.decode_attention(q, kc, vc, pos, window=eff_window)

    def attn_block_decode(self, p, x, kc, vc, pos, *, window):
        """One-token block over a contiguous cache (B, C, Hc, hd); writes
        the token's K/V at slot ``pos % C`` in place."""
        return self._mlp_tail(p, x, self.attn_decode(p, x, kc, vc, pos,
                                                     window=window))

    def attn_block_decode_paged(self, p, x, kc, vc, pos, page, off,
                                page_table):
        """One-token block over page buffers (NP, P, Hc, hd) shared by
        all rows; the token's K/V goes to physical page ``page`` (=
        ``table[b, pos // P]``) at offset ``off`` (= ``pos % P``), in
        place. Inactive rows point their table at the scratch page, so
        their writes land there (several rows may write it in one step;
        harmless)."""
        cfg = self.cfg
        hn = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], hn, cfg, pos[:, None])
        kc[page, off] = self._repeat_kv(k)[:, 0]
        vc[page, off] = self._repeat_kv(v)[:, 0]
        attn_out = L.paged_decode_attention(q, kc, vc, page_table, pos)
        return self._mlp_tail(p, x, attn_out)

    def attn_block_decode_window_paged(self, p, x, kc, vc, q_pos, pages,
                                       offs, page_table):
        """Speculative-window block over page buffers: W tokens per row at
        absolute positions ``q_pos`` (B, W). Each position's K/V goes to
        physical page ``pages`` (= ``table[b, q_pos // P]``) at offset
        ``offs`` (= ``q_pos % P``) in place — lanes past a row's window
        carry a q_pos that resolves to the always-scratch last table
        column — then every lane attends causally over the row's pages
        (key k visible to lane i iff k <= q_pos[b, i])."""
        cfg = self.cfg
        hn = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], hn, cfg, q_pos)
        kc[pages, offs] = self._repeat_kv(k)
        vc[pages, offs] = self._repeat_kv(v)
        attn_out = L.paged_window_attention(q, kc, vc, page_table, q_pos)
        return self._mlp_tail(p, x, attn_out)

    def ssm_block_decode(self, p, x, conv, ssm):
        """One-token SSM block; writes the new conv and ssm state into
        ``conv`` (B, K-1, C) and ``ssm`` (Mamba-1 (B, di, N), Mamba-2 (B,
        nh, hd, N)) in place."""
        hn = L.rms_norm(x, p["norm"], self.cfg.norm_eps)
        y, st = self._mixer(p["mixer"], hn, self.cfg,
                            state={"conv": conv, "ssm": ssm})
        conv.copy_(st["conv"])
        ssm.copy_(st["ssm"])
        return x + y

    def ssm_cache_specs(self, batch: int):
        shapes = L.ssm_state_shapes(self.cfg, batch)
        ssm_axes = ("batch", "inner") + (None,) * (len(shapes["ssm"]) - 2)
        return {"conv": ParamSpec(shapes["conv"], ("batch", None, "inner"),
                                  init="zeros"),
                "ssm": ParamSpec(shapes["ssm"], ssm_axes, init="zeros",
                                 dtype=torch.float32)}

    # ----- cache helpers -----
    def kv_cache_heads(self) -> int:
        return self.cfg.num_kv_heads * self.kv_repeat()

    def kv_repeat(self) -> int:
        # Replicate kv heads as repro does for the TPU's 16-way model
        # axis (repro.models.transformer._Blocks.kv_repeat): the port keeps
        # the same cache layout so bytes per token and page budgets match.
        cfg = self.cfg
        if cfg.num_kv_heads % 16 == 0 or cfg.num_heads == cfg.num_kv_heads:
            return 1
        group = cfg.num_heads // max(cfg.num_kv_heads, 1)
        if cfg.num_kv_heads < cfg.num_heads and 16 % cfg.num_kv_heads == 0:
            r = 16 // cfg.num_kv_heads
            if r <= group and group % r == 0:
                return r
        return 1

    def _repeat_kv(self, k):
        r = self.kv_repeat()
        return k.repeat_interleave(r, dim=2) if r > 1 else k

    def attn_cache_specs(self, batch: int, cache_len: int):
        cfg = self.cfg
        heads = self.kv_cache_heads()
        shape = (batch, cache_len, heads, cfg.head_dim)
        if heads % 16 == 0:
            axes = ("batch", None, "kv_heads_cache", None)
        elif cache_len % 16 == 0:
            axes = ("batch", "cache_seq", None, None)
        else:
            axes = ("batch", None, None, None)
        return {"k": ParamSpec(shape, axes, init="zeros"),
                "v": ParamSpec(shape, axes, init="zeros")}


class LanguageModel:
    """Decoder-only LM with a PSL cut. Families: dense, moe, ssm, hybrid,
    vlm.

    The hybrid (zamba2) runs Mamba-2 blocks with one shared attention
    block (``server.shared_attn``: norm1 and attn, no MLP) applied before
    each of ``n_super`` superblocks of ``attn_period`` blocks; the
    ``n_pre`` blocks left over after the cut run first (``server.
    pre_blocks``). Superblocks are stacked twice, (n_super, attn_period,
    ...), in the parameters (``server.superblocks``) and in the decode
    state (``server_super``); the shared attention's KV cache holds one
    ring a superblock (``server_attn``)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.blocks = _Blocks(cfg)
        if cfg.family == "hybrid":
            rem = cfg.num_layers - cfg.cut_layer
            self.n_super = rem // cfg.attn_period
            self.n_pre = rem - self.n_super * cfg.attn_period
        else:
            self.n_super = self.n_pre = 0

    # ----- parameters -----
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        bs = self.blocks.block_specs()
        client = {
            "embed": ParamSpec((v, d), ("vocab", "embed"), init="embed"),
            "blocks": stack_specs(bs, cfg.cut_layer),
        }
        server: Dict[str, Any] = {
            "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        }
        if cfg.family == "hybrid":
            if self.n_pre:
                server["pre_blocks"] = stack_specs(bs, self.n_pre)
            server["shared_attn"] = {
                "norm1": ParamSpec((d,), ("embed",), init="ones"),
                "attn": L.attention_specs(cfg)}
            server["superblocks"] = stack_specs(
                stack_specs(bs, cfg.attn_period), self.n_super)
        else:
            server["blocks"] = stack_specs(bs,
                                           cfg.num_layers - cfg.cut_layer)
        if not cfg.tie_embeddings:
            server["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
        return {"client": client, "server": server}

    def init(self, generator: torch.Generator):
        """Random parameters on the generator's device (``repro``'s init
        rules; the draws differ from ``jax.random``'s)."""
        return L.materialize(self.param_specs(), generator,
                             self.cfg.torch_dtype, generator.device)

    def _lm_head(self, params):
        if self.cfg.tie_embeddings:
            return params["client"]["embed"].T
        return params["server"]["lm_head"]

    def _stacks(self, params):
        return (("client", params["client"]["blocks"]),
                ("server", params["server"]["blocks"]))

    def _shared_attn(self, p, x, positions, window):
        """The hybrid's shared attention block on a full sequence (B1):
        (x + attention, k, v). Under tensor parallelism the rank computes
        its heads, as in ``_Blocks.block``."""
        cfg = self.cfg
        b, s, _ = x.shape
        hn = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(tp.attention_params(p["attn"]), hn, cfg,
                                  positions,
                                  matmul=tp.column_parallel("attn"))
        a = L.blockwise_attention(q, k, v, causal=True, window=window)
        return x + tp.row_parallel("attn")(a.reshape(b, s, -1),
                                           p["attn"]["wo"]), k, v

    # ----- training forward pieces -----
    def _embed(self, params, batch):
        x = tp.embed(params["client"]["embed"], batch["tokens"])
        if self.cfg.family == "vlm" and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    def _pad_targets(self, batch):
        """Labels and weights, with one zero column per VLM patch in
        front."""
        labels, weights = batch["labels"], batch["weights"]
        if self.cfg.family == "vlm" and "patches" in batch:
            b, n = labels.shape[0], batch["patches"].shape[1]
            labels = torch.cat([labels.new_zeros((b, n)), labels], dim=1)
            weights = torch.cat([weights.new_zeros((b, n)), weights], dim=1)
        return labels, weights

    @staticmethod
    def _positions(x):
        b, s, _ = x.shape
        return torch.arange(s, device=x.device)[None, :].expand(b, s)

    def _run_stack(self, stacked, x, positions, window, aux=None):
        """One stack's blocks; returns (x, ``aux`` (fp32, default 0) plus
        their aux losses in block order, as ``repro``'s scan carry)."""
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in _unstack(stacked):
            if self.blocks.is_ssm:
                x = self.blocks.ssm_block(lp, x)
                continue
            x, _, _, a = self.blocks.block(lp, x, positions, window=window)
            if a is not None:
                aux = aux + a
        return x, aux

    def _run_server(self, srv, x, positions, window, aux=None):
        """The server's blocks up to (not including) the final norm:
        (x, aux). The hybrid runs its pre-blocks, then each superblock
        after the shared attention."""
        if self.cfg.family != "hybrid":
            return self._run_stack(srv["blocks"], x, positions, window, aux)
        if self.n_pre:
            x, aux = self._run_stack(srv["pre_blocks"], x, positions,
                                     window, aux)
        for lp in _unstack(srv["superblocks"]):
            x = self._shared_attn(srv["shared_attn"], x, positions,
                                  window)[0]
            x, aux = self._run_stack(lp, x, positions, window, aux)
        return x, aux

    def _backbone(self, params, x, positions, window):
        """Client + server stacks; returns (hidden, aux_loss)."""
        x, aux = self._run_stack(params["client"]["blocks"], x, positions,
                                 window)
        srv = params["server"]
        x, aux = self._run_server(srv, x, positions, window, aux)
        x = L.rms_norm(x, srv["final_norm"], self.cfg.norm_eps)
        return x, aux

    def loss_fn(self, params, batch, window: Optional[int] = None):
        """Masked-mean LM loss over the PSL global batch.

        batch: tokens (B, S) int, labels (B, S) int32, weights (B, S) f32
        (slot mask x token mask from the epoch plan), optional patches
        (B, P, d) for a VLM. Returns (total, metrics) with ``repro``'s
        metric keys; total = loss + aux_loss."""
        cfg = self.cfg
        window = window if window is not None else cfg.sliding_window
        x = self._embed(params, batch)
        h, aux = self._backbone(params, x, self._positions(x), window)
        labels, weights = self._pad_targets(batch)
        loss, (cnt, cor) = chunked_xent(h, self._lm_head(params), labels,
                                        weights)
        total = loss + aux
        return total, {"loss": loss, "aux_loss": aux, "tokens": cnt,
                       "accuracy": cor / torch.clamp(cnt, min=1.0)}

    # ----- PSL decomposition -----
    def client_forward(self, params, batch, window: Optional[int] = None):
        """Client-side FP: embedding + first ``cut_layer`` blocks -> cut
        activations (the client blocks' aux losses are dropped, as in
        ``repro``)."""
        window = window if window is not None else self.cfg.sliding_window
        x = self._embed(params, batch)
        return self._run_stack(params["client"]["blocks"], x,
                               self._positions(x), window)[0]

    def server_loss(self, server_params, cut_acts, batch,
                    window: Optional[int] = None):
        """Server-side FP from the cut activations to the loss plus the
        server blocks' aux losses."""
        cfg = self.cfg
        window = window if window is not None else cfg.sliding_window
        x, aux = self._run_server(server_params, cut_acts,
                                  self._positions(cut_acts), window)
        x = L.rms_norm(x, server_params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            raise ValueError("PSL decomposed loss needs untied lm_head")
        labels, weights = self._pad_targets(batch)
        loss, _ = chunked_xent(x, server_params["lm_head"], labels, weights)
        return loss + aux

    # ----- caches -----
    def cache_specs(self, batch: int, cache_len: int,
                    window: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        window = window if window is not None else cfg.sliding_window
        eff_len = min(cache_len, window) if window else cache_len
        layer_c = (self.blocks.ssm_cache_specs(batch) if self.blocks.is_ssm
                   else self.blocks.attn_cache_specs(batch, eff_len))
        tree = {"client": stack_specs(layer_c, cfg.cut_layer)}
        if cfg.family == "hybrid":
            if self.n_pre:
                tree["server_pre"] = stack_specs(layer_c, self.n_pre)
            tree["server_attn"] = stack_specs(
                self.blocks.attn_cache_specs(batch, eff_len), self.n_super)
            tree["server_super"] = stack_specs(
                stack_specs(layer_c, cfg.attn_period), self.n_super)
        else:
            tree["server"] = stack_specs(layer_c,
                                         cfg.num_layers - cfg.cut_layer)
        return tree

    def init_cache(self, batch: int, cache_len: int,
                   window: Optional[int] = None, *, device):
        return _zeros(self.cache_specs(batch, cache_len, window),
                      self.cfg.torch_dtype, device)

    @staticmethod
    def _to_ring(k_full, cache_len: int):
        """Full-sequence kv (B, S, Hc, hd) -> a ring cache of length
        ``cache_len``; positions keep their rotary phase, so ring order
        is irrelevant to attention."""
        b, s, hc, hd = k_full.shape
        c = cache_len
        buf = k_full.new_zeros((b, c, hc, hd))
        if c >= s:
            buf[:, :s] = k_full
        else:
            slots = torch.arange(s - c, s, device=k_full.device) % c
            buf[:, slots] = k_full[:, -c:]
        return buf

    # ----- prefill -----
    @torch.no_grad()
    def prefill(self, params, batch, cache_len: Optional[int] = None,
                window: Optional[int] = None):
        """Full-sequence forward that fills the decode cache.

        Returns (last_logits (B, V) fp32, cache, next_pos)."""
        cfg = self.cfg
        window = window if window is not None else cfg.sliding_window
        x = self._embed(params, batch)
        b, s, _ = x.shape
        c = cache_len or s
        if window:
            c = min(c, window)
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        cache: Dict[str, Any] = {}
        srv = params["server"]
        x, cache["client"] = self._prefill_stack(
            params["client"]["blocks"], x, positions, window, c)
        if cfg.family == "hybrid":
            if self.n_pre:
                x, cache["server_pre"] = self._prefill_stack(
                    srv["pre_blocks"], x, positions, window, c)
            attn, states = [], []
            for i in range(self.n_super):
                x, k, v = self._shared_attn(srv["shared_attn"], x,
                                            positions, window)
                attn.append({"k": self._to_ring(self.blocks._repeat_kv(k),
                                                c),
                             "v": self._to_ring(self.blocks._repeat_kv(v),
                                                c)})
                x, st = self._prefill_stack(_layer(srv["superblocks"], i),
                                            x, positions, window, c)
                states.append(st)
            if self.n_super:
                cache["server_attn"] = _stack_trees(attn)
                cache["server_super"] = _stack_trees(states)
            else:       # too shallow for a superblock: empty stacks
                specs = self.cache_specs(b, c, window)
                for name in ("server_attn", "server_super"):
                    cache[name] = _zeros(specs[name], cfg.torch_dtype,
                                         x.device)
        else:
            x, cache["server"] = self._prefill_stack(srv["blocks"], x,
                                                     positions, window, c)
        x = L.rms_norm(x[:, -1:], srv["final_norm"], cfg.norm_eps)
        logits = (x[:, 0] @ self._lm_head(params)).float()
        return logits, cache, s

    def _prefill_stack(self, stacked, x, positions, window, cache_len):
        """Prefill of one stack: (x, its decode state stacked over its
        layers: {"conv", "ssm"} for SSM blocks, {"k", "v"} rings of
        ``cache_len`` for attention blocks)."""
        states = []
        for i in range(_num_layers(stacked)):
            lp = _layer(stacked, i)
            if self.blocks.is_ssm:
                x, st = self.blocks.ssm_block_prefill(lp, x)
            else:
                x, (k, v) = self.blocks.attn_block(lp, x, positions,
                                                   window=window)
                st = {"k": self._to_ring(k, cache_len),
                      "v": self._to_ring(v, cache_len)}
            states.append(st)
        return x, _stack_trees(states)

    # ----- decode -----
    def _pos_vector(self, pos, b: int, device) -> torch.Tensor:
        pos = torch.as_tensor(pos, device=device).long()
        return pos.expand(b) if pos.dim() == 0 else pos

    def _decode_stack(self, stacked, side_cache, x, pos, window):
        for i in range(_num_layers(stacked)):
            lp = _layer(stacked, i)
            if self.blocks.is_ssm:
                x = self.blocks.ssm_block_decode(
                    lp, x, side_cache["conv"][i], side_cache["ssm"][i])
            else:
                x = self.blocks.attn_block_decode(
                    lp, x, side_cache["k"][i], side_cache["v"][i], pos,
                    window=window)
        return x

    def _check_paged(self):
        if self.blocks.is_ssm:
            raise NotImplementedError(
                "paged decode supports attention-cache families only")

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos,
                    window: Optional[int] = None):
        """One-token decode. tokens: (B, 1) int; pos: an int, or a (B,)
        tensor of per-slot positions (continuous batching). Writes the
        cache in place. Returns (logits (B, 1, V) fp32, cache)."""
        cfg = self.cfg
        window = window if window is not None else cfg.sliding_window
        x = params["client"]["embed"][tokens.long()]
        pos = self._pos_vector(pos, x.shape[0], x.device)
        srv = params["server"]
        x = self._decode_stack(params["client"]["blocks"], cache["client"],
                               x, pos, window)
        if cfg.family == "hybrid":
            if self.n_pre:
                x = self._decode_stack(srv["pre_blocks"], cache["server_pre"],
                                       x, pos, window)
            attn, sup = cache["server_attn"], cache["server_super"]
            b = x.shape[0]
            for i in range(self.n_super):
                # repro's shared-attention decode passes window=None
                a = self.blocks.attn_decode(srv["shared_attn"], x,
                                            attn["k"][i], attn["v"][i], pos,
                                            window=None)
                x = x + a.reshape(b, 1, -1) @ srv["shared_attn"]["attn"]["wo"]
                x = self._decode_stack(_layer(srv["superblocks"], i),
                                       _layer(sup, i), x, pos, window)
        else:
            x = self._decode_stack(srv["blocks"], cache["server"], x, pos,
                                   window)
        x = L.rms_norm(x, srv["final_norm"], cfg.norm_eps)
        return (x @ self._lm_head(params)).float(), cache

    @torch.no_grad()
    def decode_step_paged(self, params, cache, tokens, pos, page_table):
        """One-token decode over a paged KV cache. tokens: (B, 1) int;
        pos: (B,) per-row positions; page_table: (B, M) int32 from
        :class:`repro_torch.runtime.paging.PagePool` (one table for every
        layer: cache leaves carry a leading layer axis). Writes the pages
        in place. Returns (logits (B, 1, V) fp32, cache)."""
        cfg = self.cfg
        self._check_paged()
        x = params["client"]["embed"][tokens.long()]
        pos = self._pos_vector(pos, x.shape[0],
                               x.device).to(torch.int32).contiguous()
        psize = cache["client"]["k"].shape[2]
        page = page_table.gather(1, (pos // psize)[:, None].long())[:, 0]
        page, off = page.long(), (pos % psize).long()
        for side, stacked in self._stacks(params):
            kcs, vcs = cache[side]["k"], cache[side]["v"]
            for i in range(_num_layers(stacked)):
                x = self.blocks.attn_block_decode_paged(
                    _layer(stacked, i), x, kcs[i], vcs[i], pos, page, off,
                    page_table)
        x = L.rms_norm(x, params["server"]["final_norm"], cfg.norm_eps)
        return (x @ self._lm_head(params)).float(), cache

    def _decode_window_stack_paged(self, stacked, side_cache, x, q_pos,
                                   pages, offs, page_table):
        kcs, vcs = side_cache["k"], side_cache["v"]
        for i in range(_num_layers(stacked)):
            x = self.blocks.attn_block_decode_window_paged(
                _layer(stacked, i), x, kcs[i], vcs[i], q_pos, pages, offs,
                page_table)
        return x

    @torch.no_grad()
    def decode_window_paged(self, params, cache, tokens, q_pos, page_table):
        """W-token speculative-verify decode over a paged KV cache.

        tokens: (B, W) int — per row, the last emitted token followed by
        the draft's W-1 proposals; q_pos: (B, W) int32 absolute positions
        (``pos + i`` inside a row's window; lanes beyond it point at a
        scratch column of ``page_table``); page_table: (B, M) int32. One
        batched target step scores the whole window: logits[:, i] is the
        next-token distribution after ``tokens[:, :i+1]``, and every
        window position's K/V lands in the pages, in place, where W
        single-token :meth:`decode_step_paged` calls would have put it.
        Attention-cache families only. Returns (logits (B, W, V) fp32,
        cache)."""
        cfg = self.cfg
        self._check_paged()
        x = params["client"]["embed"][tokens.long()]
        q_pos = q_pos.to(torch.int32).contiguous()
        psize = cache["client"]["k"].shape[2]
        pages = page_table.gather(1, (q_pos // psize).long()).long()
        offs = (q_pos % psize).long()
        for side, stacked in self._stacks(params):
            x = self._decode_window_stack_paged(stacked, cache[side], x,
                                                q_pos, pages, offs,
                                                page_table)
        x = L.rms_norm(x, params["server"]["final_norm"], cfg.norm_eps)
        return (x @ self._lm_head(params)).float(), cache


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper); the conv/mel frontend is stubbed as in repro:
# the encoder consumes precomputed frame embeddings (B, T_enc, d).
# ---------------------------------------------------------------------------

class EncDecModel:
    """Whisper-style encoder-decoder with the PSL cut at the encoder output
    (port of ``repro``'s ``EncDecModel``): the client holds the encoder
    (learned positions ``enc_pos``, pre-norm blocks of non-causal
    self-attention and a GELU MLP, RMS norms as in ``repro``), the server
    the decoder (learned positions ``dec_pos``; each block causal
    self-attention, cross-attention over the encoder states, GELU MLP).

    Self- and cross-attention over full sequences run the flash-attention
    kernel (causal in the decoder, non-causal in the encoder and for
    cross-attention, whose keys are the T_enc encoder rows). Decode is at
    one scalar position shared by the batch (learned absolute positions):
    the token's self-attention is plain ``decode_attention`` over a ring
    cache, written in place, and its cross-attention runs the kernel at
    S = 1 over ``cache["enc"]``, whose K/V are recomputed every step, as
    ``repro`` does."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.blocks = _Blocks(cfg)

    # ----- parameters -----
    def _enc_block_specs(self):
        cfg = self.cfg
        return {"norm1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
                "attn": L.attention_specs(cfg),
                "norm2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
                "mlp": L.mlp_specs(cfg, gelu=True)}

    def _dec_block_specs(self):
        cfg = self.cfg
        return {"norm1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
                "attn": L.attention_specs(cfg),
                "norm_x": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
                "xattn": L.cross_attention_specs(cfg),
                "norm2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
                "mlp": L.mlp_specs(cfg, gelu=True)}

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        client = {  # the encoder lives on the client (the edge holds audio)
            "enc_pos": ParamSpec((cfg.encoder_seq, d), (None, "embed"),
                                 init="embed"),
            "enc_blocks": stack_specs(self._enc_block_specs(),
                                      cfg.encoder_layers),
            "enc_norm": ParamSpec((d,), ("embed",), init="ones"),
        }
        server = {
            "embed": ParamSpec((v, d), ("vocab", "embed"), init="embed"),
            "dec_pos": ParamSpec((cfg.max_seq_len, d), (None, "embed"),
                                 init="embed"),
            "dec_blocks": stack_specs(self._dec_block_specs(),
                                      cfg.num_layers),
            "final_norm": ParamSpec((d,), ("embed",), init="ones"),
            "lm_head": ParamSpec((d, v), ("embed", "vocab")),
        }
        return {"client": client, "server": server}

    def init(self, generator: torch.Generator):
        """Random parameters on the generator's device (``repro``'s init
        rules; the draws differ from ``jax.random``'s)."""
        return L.materialize(self.param_specs(), generator,
                             self.cfg.torch_dtype, generator.device)

    # ----- encoder -----
    def encode(self, params, frames):
        """frames: (B, T_enc, d) precomputed frontend embeddings -> the
        encoder states (B, T_enc, d). Under tensor parallelism
        (``launch.tensor_parallel``) the rank computes its heads and MLP
        columns, as ``_Blocks.block`` does."""
        cfg = self.cfg
        c = params["client"]
        x = frames.to(cfg.torch_dtype) + c["enc_pos"][None]
        b, s, _ = x.shape
        for lp in _unstack(c["enc_blocks"]):
            hn = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
            q, k, v = L.attention_qkv(tp.attention_params(lp["attn"]), hn,
                                      cfg, None, rope=False,
                                      matmul=tp.column_parallel("attn"))
            a = L.blockwise_attention(q, k, v, causal=False)
            x = x + tp.row_parallel("attn")(a.reshape(b, s, -1),
                                            lp["attn"]["wo"])
            hn2 = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + self._mlp(lp, hn2)
        return L.rms_norm(x, c["enc_norm"], cfg.norm_eps)

    @staticmethod
    def _mlp(lp, x):
        return L.mlp_apply(lp["mlp"], x, gelu=True,
                           column=tp.column_parallel("mlp"),
                           row=tp.row_parallel("mlp"))

    # ----- decoder -----
    def _cross_and_mlp(self, lp, x, enc):
        cfg = self.cfg
        hx = L.rms_norm(x, lp["norm_x"], cfg.norm_eps)
        x = x + L.cross_attention(tp.attention_params(lp["xattn"]), hx, enc,
                                  cfg, matmul=tp.column_parallel("attn"),
                                  row=tp.row_parallel("attn"))
        hn2 = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + self._mlp(lp, hn2)

    def _decoder(self, srv, enc, tokens, cache=None, pos=None,
                 fill_len: Optional[int] = None):
        """The decoder up to its final norm: (hidden, self cache or None).

        Full sequence (``cache`` None): causal self-attention from
        position 0; with ``fill_len`` it also returns the stacked ring
        caches {"k", "v"} of that length. Cached decode: one token a row
        at the scalar position ``pos`` (a (1,) long tensor), its K/V
        written into ``cache`` in place at slot ``pos % C``. Under tensor
        parallelism the embedding is vocab-parallel where its vocab
        splits, and the self- and cross-attention and the MLP compute
        the rank's heads and columns."""
        cfg = self.cfg
        b, slen = tokens.shape
        x = tp.embed(srv["embed"], tokens)
        if cache is None:
            x = x + srv["dec_pos"][None, :slen]
        else:
            x = x + srv["dec_pos"].index_select(0, pos)[None]
            slot = pos % cache["k"].shape[2]
            posv = pos.expand(b)
        rings = []
        for i, lp in enumerate(_unstack(srv["dec_blocks"])):
            hn = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
            q, k, v = L.attention_qkv(tp.attention_params(lp["attn"]), hn,
                                      cfg, None, rope=False,
                                      matmul=tp.column_parallel("attn"))
            if cache is None:
                a = L.blockwise_attention(q, k, v, causal=True)
                if fill_len is not None:
                    rings.append({
                        "k": LanguageModel._to_ring(
                            self.blocks._repeat_kv(k), fill_len),
                        "v": LanguageModel._to_ring(
                            self.blocks._repeat_kv(v), fill_len)})
            else:
                kc, vc = cache["k"][i], cache["v"][i]
                kc.index_copy_(1, slot, self.blocks._repeat_kv(k))
                vc.index_copy_(1, slot, self.blocks._repeat_kv(v))
                a = L.decode_attention(q, kc, vc, posv)
            x = x + tp.row_parallel("attn")(a.reshape(b, slen, -1),
                                            lp["attn"]["wo"])
            x = self._cross_and_mlp(lp, x, enc)
        x = L.rms_norm(x, srv["final_norm"], cfg.norm_eps)
        return x, (_stack_trees(rings) if rings else None)

    # ----- training and the PSL decomposition -----
    def loss_fn(self, params, batch, window: Optional[int] = None):
        """batch: frames (B, T_enc, d), tokens (B, S), labels (B, S),
        weights (B, S). Returns (loss, metrics) with ``repro``'s keys
        (aux_loss 0)."""
        enc = self.encode(params, batch["frames"])
        h, _ = self._decoder(params["server"], enc, batch["tokens"])
        loss, (cnt, cor) = chunked_xent(h, params["server"]["lm_head"],
                                        batch["labels"], batch["weights"])
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"loss": loss, "aux_loss": aux, "tokens": cnt,
                      "accuracy": cor / torch.clamp(cnt, min=1.0)}

    def client_forward(self, params, batch, window: Optional[int] = None):
        """Client-side FP: the encoder; the cut activations are its
        states (B, T_enc, d)."""
        return self.encode(params, batch["frames"])

    def server_loss(self, server_params, cut_acts, batch,
                    window: Optional[int] = None):
        """Server-side FP from the encoder states to the loss."""
        h, _ = self._decoder(server_params, cut_acts, batch["tokens"])
        loss, _ = chunked_xent(h, server_params["lm_head"], batch["labels"],
                               batch["weights"])
        return loss

    # ----- caches -----
    def cache_specs(self, batch: int, cache_len: int,
                    window: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        attn_c = self.blocks.attn_cache_specs(batch, cache_len)
        return {"self": stack_specs(attn_c, cfg.num_layers),
                "enc": ParamSpec((batch, cfg.encoder_seq, cfg.d_model),
                                 ("batch", None, "embed"), init="zeros")}

    def init_cache(self, batch: int, cache_len: int,
                   window: Optional[int] = None, *, device):
        return _zeros(self.cache_specs(batch, cache_len, window),
                      self.cfg.torch_dtype, device)

    # ----- serving -----
    @torch.no_grad()
    def prefill(self, params, batch, cache_len: Optional[int] = None,
                window: Optional[int] = None):
        """Encode the frames and run the decoder prompt, filling the self
        cache. Returns (last_logits (B, V) fp32, {"self", "enc"},
        next_pos)."""
        enc = self.encode(params, batch["frames"])
        s = batch["tokens"].shape[1]
        h, self_cache = self._decoder(params["server"], enc,
                                      batch["tokens"], fill_len=cache_len or s)
        logits = (h[:, -1] @ params["server"]["lm_head"]).float()
        return logits, {"self": self_cache, "enc": enc}, s

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos,
                    window: Optional[int] = None):
        """One-token decode at the scalar position ``pos`` shared by the
        batch (an int or a tensor holding it). tokens: (B, 1). Writes the
        self cache in place. Returns (logits (B, 1, V) fp32, cache)."""
        dev = cache["enc"].device
        posv = torch.as_tensor(pos, device=dev).long().reshape(-1)[:1]
        h, _ = self._decoder(params["server"], cache["enc"], tokens,
                             cache=cache["self"], pos=posv)
        logits = (h @ params["server"]["lm_head"]).float()
        return logits, cache


def build_model(cfg: ModelConfig):
    if cfg.family == "audio":
        return EncDecModel(cfg)
    return LanguageModel(cfg)
