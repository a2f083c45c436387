#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

Runs from the repository root, on one CUDA card, and imports nothing of
JAX or of the JAX package. Phases (any failure exits non-zero):

1. Build. Every CUDA source of the port (``src/repro_torch/csrc``) is
   compiled for sm_90a, one ``nvcc`` per source, all at once (B2 and B3
   with the shared key walk ``csrc/paged_walk.cuh``); HGMMA (wgmma), HMMA
   (mma.sync) and async-copy (LDGSTS for cp.async, UTMALDG for TMA)
   instructions are counted with ``cuobjdump -sass`` per kernel function
   (``SASS_CHECKS``): every instantiation of each wgmma kernel (B1
   forward, both B1-bwd passes, B5 forward, B5-bwd) must hold HGMMA, of
   B3's 16-bit window kernel HMMA, and of B2, B3, B4 (both layouts) and
   both B4-bwd main kernels (per channel, per head) an async copy; the
   scan kernels' exponentials (MUFU.EX2) are counted the same way, and
   every instantiation of the per-head B4 must hold fewer than the 8
   states a lane owns at least (``EXP_SASS_MAX``: no expf in a
   per-state loop).
2. Kernels. Each kernel is held against its plain PyTorch version on the
   card at the serving shapes of full-width granite-3-2b in bf16, and
   timed beside that plain version, the least time the card could take
   (``bound_ms``) and, where one PyTorch call computes the same function,
   that call (``library_ms``; the port never calls it). B1 is also held
   and timed at the training shape (B = 16, S = 128) with its lse; B1 and
   the B5 backward print their achieved TFLOP/s and share of the bound
   (``bound_ms / ms``); B1 also its device time from torch.profiler
   (``device_ms``), since small calls are bound by the host; B2 and B3
   too, and their wrappers their host time a call (``host_us``).
   The speculative-verify kernel (B3) is held against its plain version at
   the speculative run's geometry (bf16) and on a ragged batch (bf16 and
   fp32), and with a one-token window, in bf16 and fp32, bitwise against
   the B2 kernel, each of the two held to the plain paged attention.
3. Serve. ``repro_torch.api.run_serve`` at full width (40 layers, d_model
   2048, random weights from a seeded generator), with the ``paged``, the
   ``continuous`` and the ``speculative`` engine (draft: the target's
   first ``SPEC_DRAFT_LAYERS`` layers, gamma ``SPEC_GAMMA``). The kernel
   launch counts are set to 0 just before each run and read just after:
   the paged run must have launched B1 and B2; the speculative run B3 40
   times a verify step, B2 4 times a draft step and B1 40 times a prefill,
   and leave no page leaked.
4. Agreement. Every served request is replayed through
   ``reference_generate`` on the card. A token mismatch passes only as a
   near-tie: at the first diverging step the reference's top-2 logit gap
   must be below ``NEAR_TIE_GAP``. The speculative run's tokens are also
   held against the paged run's: at a first difference the top-2 gap along
   the paged run's own tokens must be below ``NEAR_TIE_GAP``.
4a. Static serve (``[static]``). granite's weights served through the
   static engine (``repro_torch.runtime.static.BatchedServer``): the 8
   requests in batches of equal prompt length, 40 B1 launches a
   prefill and nothing else, each request's tokens held to the
   ``continuous`` run's under the near-tie rule (the gap read along the
   continuous tokens); then the 8 as one left-padded batch through
   ``run_serve``: its ServeReport (shared TTFT, padded prefill tokens),
   the KV bytes against their reckoning.
4a'. llama3-8b (``[llama]``). granite's weights are freed; full-width
   llama3-8b (32 layers, d_model 4096, 32 q / 8 kv heads, head_dim 128,
   V 128,256; bf16, 8.03 B random weights from seed 0; parameters and
   init peak printed) serves the 8 requests greedily through ``paged``,
   ``continuous`` and ``speculative`` under the granite gates (B1 32
   times a prefill call, B2 32 times a paged decode step, B3 32 times a
   verify step, B2 ``SPEC_DRAFT_LAYERS`` times a draft step, no page
   leaked, agreement with ``reference_generate`` and of the speculative
   tokens with the paged run's under ``NEAR_TIE_GAP``). One paged serve
   again with ``obs.jax_profiler_dir`` set: the port's profiler hook must
   write a trace naming B2's kernel, and the same tokens. Then sampled
   (``SAMPLED``, seeded keys as ``repro``'s) through the three engines,
   ``paged`` twice (identical tokens) and once more at top-p
   ``SAMPLED_TOP_P``: ``continuous`` and ``speculative`` must equal the
   paged run up to each request's first difference, and that difference
   must be a near-tie on the paged run's context, within ``NEAR_TIE_GAP``
   / temperature: each of the two tokens one that the sampler takes
   when rounding within that limit moves the logits (kept or that near
   the top-k boundary, and its perturbed score within the limit of the
   best of the tokens no such rounding drops; ``sampled_tie``); the
   sampler on the card against itself on the CPU on one decode step's
   logits (a differing token a tie within ``SAMPLER_ULPS`` float32
   ulps); its own device time a step beside greedy's argmax; TTFT,
   tok/s, mean decode step greedy and sampled, acceptance, peak KV
   bytes. Then B2 and B3 held to their plain versions and timed at head
   dim 128, Hq 32, Hc 16 (the kv heads repeated as the cache holds them)
   and Hc 8, and B1 (bf16 tolerance) at every (B, S, Hq, Hkv, D) the
   phase's greedy and sampled serves launched it, counted by
   ``record_launch_shapes``, and at B = 1 and each prompt length (the
   kernels line's ``llama_cases``).
4b. SSM serve. llama's weights are freed; ``run_serve`` then serves
   full-width falcon-mamba-7b (64 layers, d_model 4096, d_inner 8192,
   N = 16, random weights from a seeded generator) through ``continuous``
   with the same requests: B4 must run 64 times a prefill call, and every
   request must equal ``reference_generate`` or diverge at a near-tie of
   ``NEAR_TIE_ULPS`` bf16 ulps of the top logit's magnitude. The B4
   launches are counted by (B, L, D, N) (``record_launch_shapes``); then
   the selective scan is held against its plain version at fp32
   tolerance (``SCAN_TOL``) in a ragged fp32 shape and, in bf16, at every
   shape the run launched and at ``SCAN_CONTINUITY_SHAPE``, each timed by
   events and device time beside its bound (exponentials at the SFUs'
   rate, ``scan_bound``).
5. Training kernels. The fused cross-entropy forward and backward (B5) at
   T = 2048, d = 2048, V = 49155 and the flash-attention backward (B1-bwd)
   at B = 16, S = 128 (and a ragged S = 100), Hq = 32, Hkv = 8, D = 64,
   all bf16, held against their plain versions (and the plain versions'
   autograd), timed beside them, their bounds and the PyTorch yardsticks
   (``F.cross_entropy`` after ``torch.matmul``, and the
   ``scaled_dot_product_attention`` backward; the port never calls them),
   with their achieved TFLOP/s and share of the bound; B1-bwd and the
   SDPA backward also by device time (``device_ms``).
   B5 is checked again in fp32 at elementwise fp32 tolerance; its bf16
   gradients' softmax part is held on its own, and a planted error (the
   backward fed lse + 0.1) must fail the checks.
6. Train. ``repro_torch.api.run(default_lm_spec())`` at full width (40
   layers not cut, global batch 16 x 128 tokens, UGS, AdamW) for
   ``TRAIN_STEPS`` steps. The launch counts are set to 0 just before and
   read just after: B1 and B1-bwd must have run 40 times a step, B5 and
   B5-bwd once. Every loss and grad norm must be finite.
7. Gradient agreement. Full width at 4 layers (cut 2) on one plan batch,
   the stacked weights rescaled to fan-in d_in (``rescale_to_fan_in``
   says why): every leaf's gradient through the kernels against the same
   loss with ``ops.attention`` and ``ops.cross_entropy`` swapped, for
   that one reference run, for their plain versions (relative L2 error
   <= ``GRAD_REL_L2``); the attention backward fed lse +
   ``PLANTED_ATTN_LSE_SHIFT`` must fail that limit; then the loss on one
   fixed batch must fall at each of 5 AdamW steps.
7b. MoE serve (``[moe]``). Full-width granite-moe-3b-a800m (32 layers,
   d_model 1536, 24 q / 8 kv heads, 40 experts top-8, bf16, random
   weights from seed 0) served with the same requests through ``paged``,
   ``continuous`` and ``speculative`` at capacity factor
   ``MOE_SERVE_FACTOR`` (nothing dropped): B1 32 times a prefill call, B2
   32 times a paged decode step, B3 32 times a verify step (the granite
   speculative gates, no page leaked), nothing else; the speculative
   engine again sampled (``SAMPLED``) under the same launch and page
   gates; TTFT, tok/s, phase means, peak memory; one paged decode
   step profiled by group (``MOE_DECODE_GROUPS``); agreement with
   ``reference_generate``, where a divergence must be a top-2 near-tie
   (``NEAR_TIE_GAP``), each printed with its rule, and the greedy
   speculative tokens held to the paged run's under the same rule;
   then one batched decode step at the config's factor 1.25, its dropped
   assignments printed (not gated: ``repro``'s documented coupling).
7c. MoE training (``[moe-train]``). Full-width granite-moe cut to
   ``MOE_TRAIN_LAYERS`` layers (cut 2), PSL-UGS through ``api.run`` at
   factor 1.25 for ``MOE_TRAIN_STEPS`` steps: finite losses, aux_loss >
   0, 8 B1 + 8 B1-bwd + 1 B5 + 1 B5-bwd a step; peak memory; one step
   profiled by group (``MOE_TRAIN_GROUPS``: expert matmuls, router and
   dispatch, AdamW apart); the loss on one fixed batch must fall at each
   of 3 AdamW steps (fan-in d_in init).
7d. VLM (``[vlm]``). Full-width internvl2-2b (24 layers, d_model 2048,
   16 q / 8 kv heads, head_dim 128, V 92,553) served through ``paged``
   (B1 and B2 at head_dim 128) and held to ``reference_generate``; then
   one loss and backward with 256 patches before 128 tokens at
   ``VLM_GRAD_SHAPE`` through the kernels against the plain path
   (``plain_kernels``): loss within ``VLM_LOSS_RTOL``, per-leaf relative
   L2 within ``GRAD_REL_L2``.
7e. Hybrid (``[hybrid]``). Full-width zamba2-2.7b (54 Mamba-2 layers,
   d_model 2560, d_inner 5120, N = 64, 80 heads of 64 channels; one
   shared attention block, 32 q = kv heads, head_dim 80, before each of
   8 superblocks of 6 layers, after 4 pre-blocks; bf16, random weights
   from seed 0) served with the same requests through ``continuous``:
   B1 8 times and the per-head B4 (``csrc/mamba2_fwd.cu``) 54 times a
   prefill call, nothing else (B4 itself never), each launch's shape
   recorded; state and KV bytes a slot against their
   reckoning; TTFT, tok/s, phase means, init and serving peaks. Its
   tokens' first differences from a serve of the same batches through
   the plain versions are printed with that run's top-2 gaps, at the
   own init and again with the weights rescaled to fan-in d_in, not
   gated (``hybrid_phase`` says why); the same requests are then served
   in float32 (the same draws before their rounding to bf16) with the
   same launch gates, and held to ``reference_generate`` under the top-2
   rule (``NEAR_TIE_GAP``).
   Each of 7b–7e frees its model before the next. Then B1, B2, B1-bwd,
   B5 and B5-bwd are held to their plain versions and timed at the
   shapes 7b–7d launch them, and B1 and the per-head B4 at every shape
   and dtype 7e launched them (``family_kernel_phase``; the kernels
   line's ``family_cases``): the per-head B4 against its plain version
   at ``SCAN_TOL``, bitwise against B4 on the inputs expanded per
   channel and timed beside that B4 call (bound ``mamba2_scan_bound``),
   its exponentials counted by the kernel (``heads_fwd_exp_count``).
7e'. Audio (``[audio]``, ``[audio-grads]``, ``[audio-kernels]``).
   Full-width whisper-tiny (4 encoder + 4 decoder layers, d_model 384,
   6 heads of 64, 1500 frames, V 51,865; bf16, random weights from seed
   0) served through the static engine with the 8 requests (one
   left-padded batch, zero frames): B1 launched exactly as the path
   implies, counted by (dtype, B, S, T, Hq, Hkv, D, causal)
   (``record_kernel_shapes``, ``audio_serve_want``): per prefill 4
   non-causal over the 1500 frames, 4 causal over the prompt, 4
   non-causal cross-attention (S = prompt, T = 1500); per decode step 4
   cross-attention at S = 1; nothing else. TTFT, tok/s, decode step, KV
   bytes (rings and encoder states, reckoned), a profiled decode step.
   Its tokens against a serve of the same batch through the plain
   versions, printed at the own init and gated under the near-tie rule
   at fan-in d_in, with zero frames and with frames drawn from the
   seed; in float32 each equal-length batch against each request served
   alone, gated. ``[audio-grads]``: ``decomposed_grads`` with the cut
   at the encoder output on 8 x (1500 frames + 128 tokens), kernels
   against plain per leaf (bf16 ``GRAD_REL_L2``, float32
   ``AUDIO_GRAD_FP32_REL_L2``), exact B1, B1-bwd, B5 and B5-bwd launches
   by shape, a planted B1-bwd fault caught, a falling fixed-batch loss
   over 3 AdamW steps. ``[audio-kernels]``: every B1, B1-bwd, B5 and
   B5-bwd shape those runs launched held to its plain version and timed
   beside its bound (no causal halving without the mask) and SDPA or
   matmul + ``F.cross_entropy`` (the kernels line's ``audio_cases``).
7f. Scan backward (``[scan-bwd]``). B4-bwd at ``SCAN_BWD_SHAPES``
   (falcon-mamba's training shape, its tensor-parallel rank shape, a
   ragged one) in bf16 and fp32
   against ``ssm_scan_bwd_plain`` and autograd through
   ``ssm_scan_plain`` (``scan_bwd_errors``), ddt scaled by
   ``PLANTED_DDT_SCALE`` and dB by ``PLANTED_DB_SCALE`` caught, two
   launches bitwise equal; timed by events and device time beside its
   plain version and ``scan_bwd_bound``; the exponentials it evaluates
   counted by the kernel (its ``exp_count`` argument; ``bwd_exp_count``
   or the phase fails) and its registers and spills printed, at most
   128 registers and no spill in every instantiation. Then the per-head
   (Mamba-2) B4-bwd (``csrc/mamba2_bwd.cu``) at ``SCAN_HEADS_BWD_SHAPES``
   (zamba2's training shape and its tensor-parallel rank shape, the
   reduced zamba2's, a ragged one) in bf16 and fp32, with and without a
   dh_last, against
   ``ssm_scan_heads_bwd_plain``, against the per-channel B4-bwd on the
   inputs expanded per channel (ddt and da summed per head) and against
   autograd through ``ssm_scan_plain``, at the same limits, the same
   planted faults caught and two launches bitwise equal; timed at
   zamba2's shapes by events and device time beside its plain version,
   the per-channel B4-bwd on the same inputs and ``scan_bwd_bound``; the
   exponentials it evaluates counted by the kernel itself (its
   ``exp_count`` argument; one per (b, t, head) or the phase fails) and
   its registers and spills (``ptxas_usage``) printed.
7g. SSM training (``[ssm-train]``, ``[hybrid-train]``). Full-width
   falcon-mamba-7b cut to 8 of 64 layers and zamba2-2.7b at its 54
   layers, PSL-UGS through ``api.run`` in the granite setting for 3
   and 8 steps (each cell's ``steps``): finite losses and grad norms; exactly one
   B4 and one B4-bwd a Mamba layer (falcon-mamba the per-channel
   kernels, zamba2 the per-head ones and never the per-channel ones,
   ``scan_fwd_name``, ``scan_bwd_name``), one B1 and one B1-bwd a shared
   attention, one B5 and one B5-bwd a step; step ms, tokens/s, peak
   memory, a profiled step by group (``SSM_TRAIN_GROUPS``); the loss on
   one fixed batch falling at each of 3 AdamW steps (fan-in d_in,
   ``SSM_FIXED_BATCH_LR``); kernel-vs-plain gradients at 4 (falcon-
   mamba) or 8 (zamba2) layers on the 16-row training batch, every case
   gated, with a planted B4-bwd fault caught (``ssm_grad_check``; zamba2
   also prints ``attention_readings``). Every kernel launch of the two
   training runs is counted by shape (``record_train_shapes``); then
   ``[train-kernels]`` holds B1, B1-bwd, B5, B5-bwd and B4 (zamba2's the
   per-head one, as ``family_kernel_phase`` holds it) to their plain
   versions at each of those shapes, and fails if B4-bwd ran at a shape
   outside ``SCAN_BWD_SHAPES`` or the per-head B4-bwd outside
   ``SCAN_HEADS_BWD_SHAPES`` (``ssm_train_kernel_phase``; the kernels
   line's ``family_cases`` and ``train_cases``).
8. CNN agreement (``[cnn-agree]``). The paper's full-width GroupNorm
   ResNet (paper-cnn CONFIG, fp32, 32x32; no kernel of this repo, cuDNN
   convolutions) with TF32 off: step-0 per-leaf gradients and the losses
   of 3 SGD steps on the card against the same code on the CPU, from one
   seeded init; a planted symmetric stride-2 padding must fail the same
   limits (``cnn_agree_phase`` says where each check runs and why).
9. CNN training (``[cnn]``). ``repro_torch.api.run`` trains one epoch of
   PSL-UGS and one of PSL-FLS at the paper's setting at CIFAR-10 size
   (``cnn_spec``), from the seeded init rescaled to fan-in
   (``cnn_rescale_to_fan_in`` says why): step times, images/s, a
   profiled step by kernel group, peak memory, test accuracy, TPE and the
   GPSL monitor's verdict. UGS must have a finite loss, test accuracy >=
   ``CNN_MIN_TEST_ACC`` and no monitor violation; FLS is not gated.
10. CNN protocols (``[cnn-protocols]``). CL, SL, FL, SFL and PSL on the
   one-card sharded engine, ``CNN_PROTOCOL_STEPS`` steps each at full
   width, each with a finite loss and an evaluation. Over phases 8–10
   every kernel wrapper must read 0 launches (``train_cnn`` in the
   kernels line's ``launches_by_path``).
11. Planning (``[plan]``). The vectorized planner engine
   (``repro_torch.core.planner``, torch on the card; no kernel of this
   repo) at full size, each plan timed best of 2 after an untimed
   warm-up, with its rounds, CDF refreshes, replans, EM trips, host
   syncs, EM iterations, plan bytes and peak device memory (the engine's
   timed runs of one seed must give one plan): the K-sweep
   of benchmarks/fig3_sampling_time.py (UGS at B = 128 and LDS, delta
   1.0, at B = 256 for K in ``PLAN_SWEEP_KS``; the numpy backend beside
   it at ``PLAN_NUMPY_KS``), sparse UGS at BENCH_plan.json's two largest
   cells (``PLAN_SPARSE``), and Table IV's TPE reduction from numpy and
   engine LDS plans. Checks: every plan passes ``validate_against``;
   dense and sparse plans of a seed are bit-identical on the card at
   K = 4096 for UGS and LDS; ``em_map_torch`` on the card is within
   ``EM_PI_ATOL`` of the numpy ``em_map``; the card's UGS first-step
   mean counts over ``PLAN_DIST_SEEDS`` seeds are within
   ``PLAN_DIST_SE`` standard errors of B·D_k/D, and a planner fed
   proportions skewed by ``PLAN_DIST_SKEW`` must fail that; under
   delta 2 stragglers deplete earlier than under delta 0.
12. PSL-LDS (``[cnn-lds]``). One epoch of the [cnn] setting over
   ``CNN_LDS_CLIENTS`` clients with ``sampler.method=lds`` (delta 1.5),
   ``backend="auto"`` (which must resolve to the engine) and
   ``plan_format="auto"``: plan seconds, step times, images/s, test
   accuracy, tpe_ms, EM iterations and the monitor's verdict; gated on a
   finite loss, EM iterations, test accuracy >= ``CNN_MIN_TEST_ACC`` and
   the monitor's batch-size, over-draw and depletion invariants (its
   class-deviation verdict is printed: LDS front-loads stragglers by
   design). Over phases 11–12 every kernel wrapper must read 0
   launches (``plan_and_cnn_lds``).
13. Mesh (``[mesh]``). ``MESH_RANKS`` ranks of this script (``--mesh-rank``)
   share the one card through gloo (the backend rule of
   ``repro_torch.launch.mesh``), so this checks the collective structure
   of ``repro_torch.launch.distributed.ShardedPSLEngine``, not scaling.
   They train full-width granite-3-2b cut to ``MESH_LAYERS`` of 40 layers
   in the ``[train]`` setting (fan-in d_in init) on each of ``MESH_RUNS``
   (2x1 shard_map, 2x1 gspmd tp with 2 microbatches, 1x2 gspmd fsdp),
   then ``MESH_TP_RUNS``, tensor-parallel on 1x2 (the constant says at
   which depth and why): granite (heads and MLP split, the vocab of
   49,155 replicated), llama3-8b (cut 1: 16 q and 4 kv heads a rank in
   B1 and B1-bwd, the vocab-parallel B5 and B5-bwd on 64,128 columns a
   rank), falcon-mamba-7b (B4 and B4-bwd on 4,096 of the 8,192 channels
   a rank, B5 on 32,512 columns) and zamba2-2.7b (the per-head B4 and
   B4-bwd on 40 of the 80 heads, the shared attention's B1 and B1-bwd on
   16 of 32 heads, B5 on 16,000 columns), granite-moe-3b-a800m (8 layers:
   20 of 40 experts and 12 q / 4 kv heads a rank, B5 whole) and
   whisper-tiny (4 + 4 layers on 8 x (1500 frames + 128 tokens): 3 heads
   a rank in the encoder, the decoder and the cross-attention, B5
   whole), the last four in float32 (the constant says why; each prints
   its bf16 floor, which must sit over ``GRAD_REL_L2``; ``MESH_REL_L2``
   gives their limits), ``MESH_STEPS`` steps each, held to the one-card
   engine on the same batches and depth (``mesh_phase`` lists the gates;
   a planted unreduced gradient, in the granite tp run a row-parallel
   product whose all-reduce rank 0 skips, in the zamba2 run a Mamba-2
   norm whose sum of squares rank 0 does not add up over the ranks, in
   the granite-moe run an MoE combine rank 0 does not sum, and in the
   float32 runs every sum over ``model`` rounded to bf16, must fail
   them; the granite-moe run prints its routing flips against one
   card's); each rank launches exactly one B1 and one B1-bwd an
   attention layer, cross-attention or shared-attention application,
   one B4 and one B4-bwd a Mamba layer (falcon-mamba the per-channel
   kernels, zamba2 the per-head ones) and one B5 (the vocab-parallel one
   where the head's vocab is split) and one B5-bwd a microbatch; the 2x1
   gspmd run's checkpoint restores on one card bit for bit. Printed:
   backend, stored bytes and peak a rank, step ms against one card's,
   collective ms and bytes by kind (the tp runs' activation all-reduce
   bytes beside the prediction, ``tp_all_reduce_bytes``,
   ``tp_mixer_all_reduce_bytes``, ``tp_moe_all_reduce_bytes`` or
   ``tp_audio_all_reduce_bytes``, and the gradient sums of the leaves
   computed whole beside theirs, ``tp_partial_grad_bytes``). Then B1,
   B1-bwd, B5, B5-bwd, B4 and the per-head B4 are held to their plain
   versions and timed at the rank shapes (B1 and B1-bwd by keys and
   causality too), each in the dtype it ran in (the kernels line's
   ``mesh_cases``; B4 in bf16 and fp32), the vocab-parallel B5 and the
   -1-label B5-bwd by ``xent_tp_case``; both B4-bwd kernels' rank shapes
   are [scan-bwd]'s.

The line before the last lists the kernels as JSON; the last line is the
device record ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent

# bf16 tolerance of a kernel against its plain version: both compute in
# fp32 and round the output to bf16 once; they differ in summation order
# and, for B1, in when probabilities are normalized (one bf16 ulp of
# outputs of magnitude ~1 is 2^-7 ~ 8e-3).
BF16_ATOL = 2e-2
BF16_RTOL = 2e-2
# A greedy token may differ from the single-request reference only where
# the reference's top-2 logits nearly tie. The logits come out of a bf16
# product (x @ lm_head) whose rounding depends on the batch and on the
# attention path: at |logit| in [2, 4), where the top logits of the
# random-init model sit, one bf16 ulp is 2^-6 = 0.0156. Four ulps:
NEAR_TIE_GAP = 0.0625

# Per-leaf gradient agreement in bf16 (kernel path against plain path):
# the two differ in fp32 summation order inside the kernels, and every
# bf16 gradient is rounded once (one ulp is 2^-8 relative); 2e-2 of a
# leaf's L2 norm leaves room for that rounding and nothing else.
GRAD_REL_L2 = 2e-2
# The check's 4-layer model is rescaled to fan-in d_in (see
# rescale_to_fan_in), and a planted fault, the attention backward fed
# lse + PLANTED_ATTN_LSE_SHIFT (its gradients ~5% small), must fail it.
PLANTED_ATTN_LSE_SHIFT = 0.05
TRAIN_STEPS = 4
# B5 at the training shape. The forward's nll and lse are fp32 sums of the
# same products in kernel and plain version, in another order: fp32
# tolerance. A token whose argmax-is-label verdicts disagree must be a
# near-tie: its label's logit within XENT_TIE of the row's largest.
XENT_FP32_TOL = dict(atol=2e-4, rtol=1e-4)
# B1's lse against the plain version's: fp32 sums of the same products in
# another order, exp2 in the kernel against exp in the plain version.
LSE_TOL = dict(atol=1e-3, rtol=1e-4)
XENT_TIE = 1e-4
# B5 gradients in fp32 are held elementwise at GRAD_FP32_TOL. In bf16 the
# one-hot part (g h, g W_y) is orders of magnitude above the softmax part
# exp(s - lse) g that fills every other column, so the softmax part is held
# on its own: relative L2 error against the plain version's <=
# XENT_SOFT_REL_L2 (both round the same fp32 sums to bf16 once). A planted
# error, the backward fed lse + PLANTED_LSE_SHIFT (softmax part off by
# 1 - exp(-0.1) ~ 10%), must fail the same checks.
GRAD_FP32_TOL = dict(atol=2e-5, rtol=1e-4)
XENT_SOFT_REL_L2 = 2e-2
PLANTED_LSE_SHIFT = 0.1
# Training-kernel shapes: full-width granite-3-2b at global batch 16 x 128
XENT_SHAPE = (2048, 2048, 49155)                  # T, d, V
ATTN_SHAPE = dict(b=16, hq=32, hkv=8, d=64, seqs=(128, 100))

# The selective scan's kernel and plain version compute the same unfused
# fp32 products in the same order (y summed over the states in index
# order); they can differ only where the device's exp does: a few ulps.
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
# B1 in float32 (the CUDA-core kernel) against its plain version, as B3's
# float32 case is held
FP32_ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
# falcon-mamba's fan-in init (a stacked leaf's fan-in is its layer count)
# gives logits of another magnitude than granite's: its near-tie limit is
# counted in bf16 ulps of the top logit (one ulp at |x| in [2^e, 2^(e+1))
# is 2^(e-7)).
NEAR_TIE_ULPS = 4
SPEC_DRAFT_LAYERS = 4
SPEC_GAMMA = 4
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "zamba2-2.7b"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
SMS = 132                        # H100 SXM streaming multiprocessors
SFU_EXP_PER_CLOCK = 16           # MUFU.EX2 results a clock an SM
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores

SERVE = dict(num_requests=8, prompt_lens=[32, 100], max_new_tokens=[16],
             token_budget=8, page_size=16)
# [llama]: llama3-8b at full width through the three engines, greedy and
# sampled. SAMPLED is repro's own test setting (tests/test_spec_decode.py's
# SAMP); one paged run adds nucleus filtering at SAMPLED_TOP_P.
LLAMA_ARCH = "llama3-8b"
SAMPLED = dict(temperature=0.9, top_k=50, seed=7)
SAMPLED_TOP_P = 0.9
# The sampler on the card against itself on the CPU, on one decode step's
# logits, each row under SAMPLER_CHECK_IDXS output indices: a token that
# differs must be a tie of the perturbed scores within SAMPLER_ULPS
# float32 ulps (the card's and the CPU's log round apart).
SAMPLER_CHECK_IDXS = 16
SAMPLER_ULPS = 4

# The MoE and VLM phases (full-width granite-moe-3b-a800m and internvl2-2b)
MOE_ARCH = "granite-moe-3b-a800m"
VLM_ARCH = "internvl2-2b"
# [moe] serves at capacity factor 8.0: any factor of at least E/k = 5
# leaves every expert room for every token of a step, so nothing is
# dropped and batching does not couple slots (tests/test_decode.py uses
# 8.0 too). One batched decode step then runs at the config's own 1.25.
MOE_SERVE_FACTOR = 8.0
MOE_TRAIN_LAYERS = 8             # [moe-train]: depth cut from 32, cut 2
MOE_TRAIN_STEPS = 3
# [vlm]'s patched loss and gradient: 4 layers (cut 2) at full width, 256
# random patches (scale 0.02) before 128 tokens, batch 4; the loss must
# agree with the plain path's to VLM_LOSS_RTOL, gradients at GRAD_REL_L2
VLM_GRAD_SHAPE = dict(layers=4, batch=4, seq=128, patch_scale=0.02)
VLM_LOSS_RTOL = 1e-2

# B4-bwd against its plain version (``scan_bwd_errors``). An fp32 output
# (every output in fp32; ddt and da in bf16 too) whose kernel and plain
# version compute the same products and sums over the states in the same
# order (dx, ddt) is held elementwise at SCAN_TOL of its largest
# magnitude; one summed over D or over (b, t) in another order (dB, dC,
# da) by relative L2 <= SCAN_BWD_FP32_REL_L2. A bf16 output (dx, dB, dC
# in bf16) is the fp32 sum rounded once: upcast, by relative L2 <=
# SCAN_BWD_BF16_REL_L2 (the worst reading was 5.4e-5, dC, on one H100
# 80GB HBM3 at 700 W; PERF.md, Findings). ddt scaled by
# PLANTED_DDT_SCALE, and dB by PLANTED_DB_SCALE, must each fail these
# limits in both dtypes.
SCAN_BWD_FP32_REL_L2 = 1e-5
SCAN_BWD_BF16_REL_L2 = 1e-3
PLANTED_DDT_SCALE = 1.01
PLANTED_DB_SCALE = 1.01
# (B, L, D, N): falcon-mamba's training shape (global batch 16 x 128),
# its shape on one rank of a tensor-parallel 1x2 mesh ([mesh]: 4096 of
# the 8192 channels) and a ragged one (L not a multiple of 16, N not of
# 8, a ragged D tile). zamba2 trains through the per-head B4-bwd, whose
# phase runs this kernel at zamba2's shape as its comparison.
SCAN_BWD_SHAPES = ((16, 128, 8192, 16), (16, 128, 4096, 16),
                   (3, 37, 200, 5))
# The per-head (Mamba-2) B4-bwd at (B, L, D, N, channels a head):
# zamba2's training shape, its shape on one rank of a tensor-parallel 1x2
# mesh ([mesh]: 40 of the 80 heads), the reduced zamba2's (hd 32, N 8)
# and a ragged one (L not a multiple of 8, N not of 8, hd 12: 20 idle
# lanes), held to
# the same limits against its plain version, against the per-channel
# B4-bwd on the inputs expanded per channel (ddt and da then summed per
# head) and against autograd through ``ssm_scan_plain`` on those inputs.
SCAN_HEADS_BWD_SHAPES = ((16, 128, 5120, 64, 64), (16, 128, 2560, 64, 64),
                         (8, 32, 256, 8, 32), (3, 37, 60, 5, 12))
# [ssm-train] and [hybrid-train]: the granite training setting
# (default_lm_spec) for ``steps`` steps. falcon-mamba-7b cut to 8 of
# its 64 layers (cut 2): at full depth AdamW alone needs 14.5 GB of bf16
# weights, 14.5 of gradients and 58 of fp32 moments. zamba2-2.7b at its
# full 54 layers. The kernel-vs-plain gradient check runs falcon-mamba at
# 4 layers and zamba2 at 8 (one superblock: B1 and B1-bwd run), on the 16
# sequences of a plan batch, the training batch, so every kernel runs at
# its training shape. ``grad_cases`` (``ssm_grad_check``): (dtype, kernel
# families kept as kernels), each gated at GRAD_REL_L2 in bf16 or
# SCAN_GRAD_FP32_REL_L2 in float32 (fp32 sums in another order through 8
# layers) with a planted B4-bwd fault caught. zamba2's check also reads
# B1 alone against the plain path and against the plain path whose
# attention backward is B1-bwd's own formulas in plain PyTorch
# (``attention_readings``: printed, they say where the bf16 all-kernel
# reading comes from).
ALL_KERNELS = ("attention", "cross_entropy", "selective_scan")
SCAN_GRAD_FP32_REL_L2 = 1e-4
# zamba2's steps are timed on the host around each step (``device_step``
# spans): 2 steps after the first read 720.3 and 505.1 ms on one H100
# 80GB HBM3 at 700 W, so it runs 8 and takes the median of 7.
SSM_TRAIN = dict(arch=SSM_ARCH, layers=8, steps=3, grad_layers=4,
                 grad_rows=16, grad_cases=((None, ALL_KERNELS),))
HYBRID_TRAIN = dict(arch=HYBRID_ARCH, layers=54, steps=8, grad_layers=8,
                    grad_rows=16,
                    grad_cases=((None, ALL_KERNELS),
                                ("float32", ALL_KERNELS)))
# the gradient check's planted B4-bwd fault: ddt 5% large (the dt biases'
# and dt projections' gradients come through ddt alone)
PLANTED_SCAN_GRAD_DDT_SCALE = 1.05
# The SSM phases' fixed-batch descent runs AdamW at this learning rate:
# at the setting's 1e-3 the first step (+-lr on each of falcon-mamba's
# 1.37 B weights at fan-in d_in) took the fixed batch's loss from 11.58
# to 2.6e-5, and the next two read 4.6e-7 and 1.3e-6, the bf16 floor
# (on one H100 80GB HBM3 at 700 W; PERF.md, Findings).
SSM_FIXED_BATCH_LR = 1e-5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls
    after ``warmup`` (inputs stay L2-warm between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, match: str, iters: int = 20) -> float:
    """Mean device time a call of the kernels whose names contain
    ``match``, from torch.profiler: what ``time_ms`` reads when the host
    issues the calls faster than the card runs them, and less when the
    host is the slower (small calls). Each such kernel counts its mean
    time a recorded launch times its launches a call, ceil(recorded /
    ``iters``): a profiler window now and then records fewer launches
    than were made, and then a sum over the window divided by ``iters``
    would read low. A window whose counts are not whole multiples of
    ``iters`` is tried again, twice; after three empty windows CUDA
    events' time is taken."""
    import math
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    ms = 0.0
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms, short = 0.0, []
        for evt in prof.key_averages():
            if match in evt.key and evt.count:
                us = getattr(evt, "self_device_time_total", None)
                us = us if us is not None else evt.self_cuda_time_total
                ms += us / evt.count * math.ceil(evt.count / iters) / 1e3
                if evt.count % iters:
                    short.append(f"{evt.key[:40]} {evt.count}")
        if ms > 0 and not short:
            return ms
        if ms > 0 and attempt == 2:
            print(f"device_ms: {match!r}: launches recorded of {iters} "
                  f"calls: {short}; each kernel's mean a launch used",
                  flush=True)
            return ms
    ms = time_ms(torch, fn, iters=iters)
    print(f"device_ms: the profiler recorded no device time for {match!r} "
          f"in 3 windows; CUDA events time used ({ms:.4f} ms)", flush=True)
    return ms


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host time of one call in microseconds: ``time.perf_counter`` over
    ``calls`` calls with no synchronize inside (the card runs behind the
    host as long as each call's device work is shorter than its host
    work)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(torch, got, want) -> float:
    err = (got.float() - want.float()).abs()
    if not bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()):
        fail(f"kernel disagrees with its plain version: max_abs_err "
             f"{err.max().item()}")
    return err.max().item()


def kernel_phase(torch, dev):
    """Hold each kernel against its plain version; time all three."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    b1_cases = [serve_attention_case(torch, rn, b, s, 32, 8, 64)
                for b in (1, 16) for s in (100, 512)]
    b2 = paged_kernel_case(torch, paged_case(torch, dev, gen))
    b3 = verify_kernel_phase(torch, dev, gen)
    # last: B2 and B3 draw their inputs from gen without depending on it
    b1_cases.append(attention_train_case(torch, dev, gen, rn))
    return b1_cases, b2, b3


def attn_pairs(s: int, t: int, causal: bool) -> int:
    """(query, key) pairs a B1 call scores: all S x T without the causal
    mask; with it, row i sees keys 0..i (starts aligned)."""
    if not causal:
        return s * t
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def attn_shape(b, s, t, hq, hkv, d, causal) -> str:
    seq = f"S=T={s}" if s == t else f"S={s} T={t}"
    return (f"B={b} {seq} Hq={hq} Hkv={hkv} D={d} "
            f"{'causal' if causal else 'non-causal'}")


def serve_attention_case(torch, rn, b, s, hq, hkv, d, tol=None, t=None,
                         causal=True):
    """B1 forward as serving calls it (no grad, no lse) at one shape (T
    keys, S by default; causal by default), in ``rn``'s dtype: held to
    the plain version (``tol``, bf16's by default), timed (events and
    device) beside it, its bound (every pair scored counted once: no
    causal halving without the mask) and the SDPA forward."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    serve_attention = torch.no_grad()(ops.attention)
    t = s if t is None else t
    q, k, v = rn(b, s, hq, d), rn(b, t, hkv, d), rn(b, t, hkv, d)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = serve_attention(q, k, v, causal=causal)
    want = flash_attention_plain(qt, kt, vt, causal=causal).transpose(1, 2)
    torch.cuda.synchronize()
    tol = tol or dict(atol=BF16_ATOL, rtol=BF16_RTOL)
    name = str(q.dtype).replace("torch.", "")
    err = within_tol(torch, got, want, f"flash_attention {name} "
                     f"{(b, s, t, hq, hkv, d, causal)}", **tol)
    fp32 = q.dtype == torch.float32       # the CUDA-core kernel, no wgmma
    nbytes = q.element_size() * (2 * b * s * hq * d + 2 * b * t * hkv * d)
    flops = 4.0 * b * hq * d * attn_pairs(s, t, causal)
    bnd, by = bound_ms(nbytes, flops, FP32_FLOPS if fp32 else BF16_FLOPS)
    case = {
        "shape": f"{attn_shape(b, s, t, hq, hkv, d, causal)} {name}",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: serve_attention(q, k, v,
                                                     causal=causal)),
        "plain_ms": time_ms(torch, lambda: flash_attention_plain(
            qt, kt, vt, causal=causal)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
    }
    case["device_ms"] = device_ms(
        torch, lambda: serve_attention(q, k, v, causal=causal),
        "flash_fwd_kernel" if fp32 else "flash_fwd_tc")
    add_rates(case, flops)
    print(f"kernel flash_attention {case['shape']}: err "
          f"{err:.3g} (atol {tol['atol']}, rtol {tol['rtol']}); "
          f"{case['ms']:.4f} ms (device {case['device_ms']:.4f}), "
          f"plain {case['plain_ms']:.4f} ms, bound {bnd:.5f} ms "
          f"({by}), sdpa {case['library_ms']:.4f} ms; "
          f"{case['tflops']:.1f} TFLOP/s, "
          f"{case['bound_share']:.3f} of the bound", flush=True)
    return case


def paged_kernel_case(torch, inputs):
    """B2 on ``inputs`` (q, pages, table, pos), bf16: held to the plain
    version, timed (events, device, host a wrapper call) beside it and
    its bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_plain
    q, kp, vp, table, pos = inputs
    b, hq, d = q.shape
    psize, hc = kp.shape[1], kp.shape[2]
    m = table.shape[1]
    got = ops.paged_attention(q, kp, vp, table, pos)
    want = paged_attention_plain(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    err = within(torch, got, want)
    keys = (pos.long() + 1).cpu()
    elt = 2
    nbytes = (elt * (2 * b * hq * d + int(keys.sum()) * hc * d * 2)
              + 4 * int((-(-keys // psize)).sum()) + 4 * b)
    flops = 4.0 * hq * d * int(keys.sum())
    bnd, by = bound_ms(nbytes, flops)
    b2 = {
        "shape": f"B={b} Hq={hq} Hc={hc} D={d} P={psize} M={m} "
                 f"pos={pos.tolist()}",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.paged_attention(
            q, kp, vp, table, pos)),
        "plain_ms": time_ms(torch, lambda: paged_attention_plain(
            q, kp, vp, table, pos)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "device_ms": device_ms(torch, lambda: ops.paged_attention(
            q, kp, vp, table, pos), DEVICE_MATCH["paged_attention"]),
        "host_us": host_us(torch, lambda: ops.paged_attention(
            q, kp, vp, table, pos)),
    }
    print(f"kernel paged_attention {b2['shape']}: err {err:.3g} (atol "
          f"{BF16_ATOL}, rtol {BF16_RTOL}); {b2['ms']:.4f} ms (device "
          f"{b2['device_ms']:.4f}; wrapper {b2['host_us']:.1f} us of host "
          f"a call), plain {b2['plain_ms']:.4f} ms, bound {bnd:.5f} ms "
          f"({by})", flush=True)
    return b2


def paged_case(torch, dev, gen, hq=32, hc=16, d=64):
    """B2's inputs at the paged run's geometry, bf16: 8 rows, 8 logical
    pages of 16, a 64-page pool plus the scratch page; permuted tables,
    one row mid-page and one at position 0. Heads and head_dim default
    to full-width granite's (kv_repeat 2)."""
    b, psize, m = 8, 16, 8
    num_pages = b * m + 1

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q = rn(b, hq, d)
    kp, vp = rn(num_pages, psize, hc, d), rn(num_pages, psize, hc, d)
    table = torch.randperm(num_pages - 1, generator=gen, device=dev)[
        :b * m].reshape(b, m).to(torch.int32)
    pos = torch.randint(0, m * psize, (b,), generator=gen,
                        device=dev).to(torch.int32)
    pos[0] = psize // 2
    pos[-1] = 0
    return q, kp, vp, table, pos


def attention_train_case(torch, dev, gen, rn, b=ATTN_SHAPE["b"],
                         s=ATTN_SHAPE["seqs"][0], hq=ATTN_SHAPE["hq"],
                         hkv=ATTN_SHAPE["hkv"], d=ATTN_SHAPE["d"], t=None,
                         causal=True):
    """B1 at a training shape (by default granite's: B = 16, S = 128,
    Hq = 32, Hkv = 8, D = 64, causal; T keys, S unless given) with the
    lse the backward reads, on inputs drawn by ``rn`` (bf16; in float32
    the CUDA-core kernel, held at ``FP32_ATTN_TOL``), against the plain
    version's output and lse, timed beside it and the SDPA forward."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    t = s if t is None else t
    qt = rn(b, s, hq, d).transpose(1, 2)
    kt, vt = (rn(b, t, hkv, d).transpose(1, 2) for _ in range(2))
    fp32 = qt.dtype == torch.float32
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    got = flash_attention(qt, kt, vt, causal=causal, lse=lse)  # uncounted
    want, want_lse = flash_attention_plain(qt, kt, vt, causal=causal,
                                           with_lse=True)
    torch.cuda.synchronize()
    err = (within_tol(torch, got, want, "flash_attention float32",
                      **FP32_ATTN_TOL) if fp32 else within(torch, got, want))
    lse_err = within_tol(torch, lse, want_lse, "flash_attention lse",
                         **LSE_TOL)
    flops = 4.0 * b * hq * d * attn_pairs(s, t, causal)
    bnd, by = bound_ms(qt.element_size() * (2 * b * s * hq * d
                                            + 2 * b * t * hkv * d)
                       + 4 * b * hq * s, flops,
                       FP32_FLOPS if fp32 else BF16_FLOPS)
    case = {
        "shape": f"{attn_shape(b, s, t, hq, hkv, d, causal)}, with lse "
                 f"(training)"
                 + (" float32" if fp32 else ""),
        "max_abs_err": err, "lse_max_abs_err": lse_err,
        "ms": time_ms(torch, lambda: flash_attention(
            qt, kt, vt, causal=causal, lse=lse)),
        "plain_ms": time_ms(torch, lambda: flash_attention_plain(
            qt, kt, vt, causal=causal, with_lse=True)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
        "device_ms": device_ms(
            torch, lambda: flash_attention(qt, kt, vt, causal=causal,
                                           lse=lse),
            "flash_fwd_kernel" if fp32 else "flash_fwd_tc"),
    }
    add_rates(case, flops)
    print(f"kernel flash_attention {case['shape']}: err {err:.3g}, lse err "
          f"{lse_err:.3g} (atol {LSE_TOL['atol']}, rtol {LSE_TOL['rtol']}); "
          f"{case['ms']:.4f} ms (device {case['device_ms']:.4f}), plain "
          f"{case['plain_ms']:.4f} ms, bound "
          f"{bnd:.5f} ms ({by}), sdpa {case['library_ms']:.4f} ms; "
          f"{case['tflops']:.1f} TFLOP/s, {case['bound_share']:.3f} of the "
          f"bound", flush=True)
    return case


def add_rates(case, flops: float) -> None:
    """Achieved TFLOP/s and the share of the bound (bound_ms / ms)."""
    case["tflops"] = flops / (case["ms"] * 1e-3) / 1e12
    case["bound_share"] = case["bound_ms"] / case["ms"]


# Kernels whose every instantiation must hold some instruction of a kind in
# its SASS, by library: the wgmma kernels HGMMA, B3's 16-bit window
# kernel HMMA (mma.sync), the redesigned B2, B3, B4 (both layouts) and
# both B4-bwd main kernels (per channel and per head) an async copy into
# shared memory (LDGSTS for cp.async, UTMALDG for a TMA load). The scan
# kernels' exponentials (MUFU.EX2) are counted too; EXP_SASS_MAX bounds
# them where a kernel evaluates none per state.
SASS_CHECKS = {
    "HGMMA": (("HGMMA",), {
        "flash_attention": ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                            "flash_bwd_dkdv_tc_kernel"),
        "cross_entropy": ("xent_fwd_tc_kernel", "xent_tc_gemm")}),
    "HMMA": (("HMMA",), {
        "spec_verify": ("spec_verify_mma_kernel",)}),
    "async copy": (("LDGSTS", "UTMALDG"), {
        "ssm_scan": ("ssm_scan_kernel", "ssm_bwd_kernel"),
        "mamba2_fwd": ("mamba2_fwd_kernel",),
        "mamba2_bwd": ("mamba2_bwd_kernel",),
        "paged_attention": ("paged_fwd",),
        "spec_verify": ("spec_verify",)}),
    "MUFU.EX2": (("MUFU.EX2",), {
        "ssm_scan": ("ssm_scan_kernel", "ssm_bwd_kernel"),
        "mamba2_fwd": ("mamba2_fwd_kernel",),
        "mamba2_bwd": ("mamba2_bwd_kernel",)}),
}
# The per-head B4 evaluates exp(dt a) once per (step, head) in a chunk's
# conversion, outside the step loop: each instantiation's SASS must hold
# fewer MUFU.EX2 than the 8 states a lane owns at least (one per state of
# one step, unrolled, would be 8 or more).
EXP_SASS_MAX = {"mamba2_fwd_kernel": 7}
# Substring of each serving kernel's name in a profiler trace.
DEVICE_MATCH = {"paged_attention": "paged_fwd", "spec_verify": "spec_verify",
                "selective_scan": "ssm_scan",
                "selective_scan_bwd": "ssm_bwd",
                "selective_scan_heads": "mamba2_fwd",
                "selective_scan_heads_bwd": "mamba2_bwd"}


def sass_counts():
    """For each kind of ``SASS_CHECKS``, its instructions in the SASS of
    each named library and of each named kernel (``cuobjdump -sass``
    prints a ``Function :`` block per kernel instantiation; a kernel's
    count is summed over its instantiations, each of which must hold
    some)."""
    import re
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for kind, (opcodes, by_lib) in SASS_CHECKS.items():
        libs, kernels = {}, {}
        for name, names in by_lib.items():
            sass = subprocess.run(
                [tool, "-sass", str(_build._lib_path(name))],
                capture_output=True, text=True, check=True,
                timeout=300).stdout
            per_fn, fn = {}, None
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    fn = m.group(1)
                    per_fn[fn] = 0
                elif fn is not None and any(op in line for op in opcodes):
                    per_fn[fn] += 1
            libs[name] = sum(per_fn.values())
            for kname in names:
                insts = [c for f, c in per_fn.items() if kname in f]
                if not insts or min(insts) < 1:
                    fail(f"kernel {kname} holds no {kind} instruction "
                         f"({'/'.join(opcodes)}) in some instantiation: "
                         f"{insts}")
                if kind == "MUFU.EX2" and max(insts) > EXP_SASS_MAX.get(
                        kname, max(insts)):
                    fail(f"kernel {kname} holds {max(insts)} MUFU.EX2 in "
                         f"an instantiation, more than "
                         f"{EXP_SASS_MAX[kname]}: {insts}")
                kernels[kname] = {"count": sum(insts),
                                  "instantiations": len(insts),
                                  "most": max(insts)}
        print(f"{kind} instructions ({'/'.join(opcodes)}) in the SASS: "
              f"{libs}; per kernel {json.dumps(kernels)}", flush=True)
        out[kind] = {"libraries": libs, "kernels": kernels}
    return out


def ptxas_usage(logs, kernel: str):
    """Registers and spill bytes of each instantiation of ``kernel`` from
    ``nvcc -Xptxas -v`` output (``_build.build(..., verbose=True)``'s
    logs), by its template arguments as mangled (e.g. ``13__nv_bfloat16
    Li64ELi2E``)."""
    import re
    out, fn = {}, None
    for log in logs:
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                continue
            if fn is None or kernel not in fn:
                continue
            key = fn.split(kernel, 1)[1].split("EEv", 1)[0].lstrip("I")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out.setdefault(key, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def verify_case(torch, dev, gen, dtype, w, wlens, starts, hq=32, hc=16,
                d=64):
    """B3 inputs at the speculative run's geometry: 8 rows, a table of 8
    logical pages of 16 plus the always-scratch last column, a 64-page
    pool plus the scratch page; row r's window holds wlens[r] + 1 live
    lanes from position starts[r], its other lanes at the scratch
    position, as the engine builds them. Heads and head_dim default to
    full-width granite's."""
    b, psize, m = 8, 16, 9
    num_pages = b * (m - 1) + 1
    q = torch.randn((b, w, hq, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((num_pages, psize, hc, d), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((num_pages, psize, hc, d), generator=gen,
                     device=dev).to(dtype)
    table = torch.full((b, m), num_pages - 1, dtype=torch.int32, device=dev)
    table[:, :m - 1] = torch.randperm(num_pages - 1, generator=gen,
                                      device=dev).reshape(b, m - 1)
    q_pos = torch.full((b, w), (m - 1) * psize, dtype=torch.int32,
                       device=dev)
    for r in range(b):
        q_pos[r, :wlens[r] + 1] = starts[r] + torch.arange(wlens[r] + 1,
                                                           device=dev)
    return q, kp, vp, table, q_pos


def verify_bound(q, kp, table, q_pos):
    """Least time for B3's work on these inputs: q and out once, the K/V
    of the positions each row's walk covers (0..max q_pos) once, the table
    and q_pos; 4 D flops per (query head, visible key) of each lane."""
    b, w, hq, d = q.shape
    psize, hc = kp.shape[1], kp.shape[2]
    walk = (q_pos.max(dim=1).values.long() + 1).clamp(
        max=table.shape[1] * psize).cpu()
    elt = q.element_size()
    nbytes = (elt * (2 * q.numel() + 2 * int(walk.sum()) * hc * d)
              + 4 * int((-(-walk // psize)).sum()) + 4 * q_pos.numel())
    keys = int((q_pos.long() + 1).clamp(
        max=table.shape[1] * psize).sum())
    return bound_ms(nbytes, 4.0 * hq * d * keys)


def verify_kernel_phase(torch, dev, gen):
    """B3 against its plain version: the serving window (W = 5, every row
    a full window, row 0 crossing a page) in bf16, timed; a ragged batch
    (mixed window lengths, scratch lanes) in bf16 and fp32; a one-token
    window, in bf16 and fp32, bitwise against the B2 kernel (the same key
    walk and arithmetic) and each against the plain paged attention."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_plain
    from repro_torch.kernels.spec_verify import spec_verify_plain
    w = SPEC_GAMMA + 1
    timed, starts = verify_window_case(torch, dev, gen)
    ragged_wl = [4, 2, 0, 3, 4, 1, 0, 4]
    ragged_start = [13, 30, 47, 95, 111, 0, 64, 15]
    tols = {torch.bfloat16: dict(atol=BF16_ATOL, rtol=BF16_RTOL),
            torch.float32: FP32_ATTN_TOL}
    errs, w1_err = {}, {}
    for dtype, tol in tols.items():
        case = verify_case(torch, dev, gen, dtype, w, ragged_wl,
                           ragged_start)
        name = str(dtype).replace("torch.", "")
        errs[name] = within_tol(torch, ops.spec_verify(*case),
                                spec_verify_plain(*case),
                                f"spec_verify ragged {name}", **tol)
        q, kp, vp, table, q_pos = verify_case(torch, dev, gen, dtype, 1,
                                              [0] * 8, starts)
        one = ops.spec_verify(q, kp, vp, table, q_pos)[:, 0]
        args = (q[:, 0].contiguous(), kp, vp, table,
                q_pos[:, 0].contiguous())
        b2 = ops.paged_attention(*args)
        plain = paged_attention_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(one, b2):
            fail(f"W=1 spec_verify is not bitwise the paged kernel in "
                 f"{name}: max diff "
                 f"{(one.float() - b2.float()).abs().max().item()}")
        w1_err[name] = {
            "spec_verify": within_tol(torch, one, plain,
                                      f"W=1 spec_verify {name}", **tol),
            "paged_attention": within_tol(torch, b2, plain,
                                          f"W=1 paged_attention {name}",
                                          **tol),
            "bitwise_equal": True}
    print(f"kernel spec_verify: ragged err {errs}; W=1 bitwise the paged "
          f"kernel, err {w1_err}", flush=True)
    return {**timed, "max_abs_err": max(timed["max_abs_err"],
                                        errs["bfloat16"]),
            "ragged_max_abs_err": errs, "w1_max_abs_err": w1_err}


def verify_window_case(torch, dev, gen, hq=32, hc=16, d=64):
    """B3 at the speculative run's window (W = gamma + 1, every row a full
    window from a drawn start, row 0 crossing a page) with these heads,
    bf16: held to its plain version, timed (events, device, host a
    wrapper call) beside it and its bound. Returns the case and the
    rows' starts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.spec_verify import spec_verify_plain
    w = SPEC_GAMMA + 1
    starts = [14] + [int(x) for x in torch.randint(
        32, 111, (7,), generator=gen, device=dev).tolist()]
    full = verify_case(torch, dev, gen, torch.bfloat16, w, [w - 1] * 8,
                       starts, hq, hc, d)
    err = within(torch, ops.spec_verify(*full), spec_verify_plain(*full))
    bnd, by = verify_bound(full[0], full[1], full[3], full[4])
    case = {
        "shape": f"B=8 W={w} Hq={hq} Hc={hc} D={d} P=16 M=9 (8 pages + "
                 f"scratch column) starts={starts}",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.spec_verify(*full)),
        "plain_ms": time_ms(torch, lambda: spec_verify_plain(*full)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "device_ms": device_ms(torch, lambda: ops.spec_verify(*full),
                               DEVICE_MATCH["spec_verify"]),
        "host_us": host_us(torch, lambda: ops.spec_verify(*full)),
    }
    print(f"kernel spec_verify {case['shape']}: err {err:.3g} (atol "
          f"{BF16_ATOL}, rtol {BF16_RTOL}); {case['ms']:.4f} ms (device "
          f"{case['device_ms']:.4f}; wrapper {case['host_us']:.1f} us of "
          f"host a call), plain {case['plain_ms']:.4f} ms, bound "
          f"{bnd:.5f} ms ({by})", flush=True)
    return case, starts


def scan_case(torch, dev, gen, dtype, b, l, d, n):
    x = torch.randn((b, l, d), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, d), generator=gen, device=dev) - 1.0)
    base = torch.log(torch.arange(1, n + 1, device=dev,
                                  dtype=torch.float32))
    a = -torch.exp(base.expand(d, n) + 0.1 * torch.randn(
        (d, n), generator=gen, device=dev))
    bm = torch.randn((b, l, n), generator=gen, device=dev).to(dtype)
    cm = torch.randn((b, l, n), generator=gen, device=dev).to(dtype)
    return x, dt, a.contiguous(), bm, cm


# B4 at the (B, L, D, N) that chip_smoke.py timed before it recorded the
# shapes the ssm run launches (never one of them), kept for continuity.
SCAN_CONTINUITY_SHAPE = (8, 100, 8192, 16)


def scan_bound(b, l, d, n, elt):
    """Least time for B4's work: x (elt bytes), dt and y (fp32) once per
    (b, t, d), B and C once per (b, t, n), a and h_last once; against
    its operations, the larger of B L D N exponentials at the SFUs' rate
    (one MUFU.EX2 each, ``SFU_EXP_PER_CLOCK`` a clock on each of ``SMS``
    SMs at the card's maximum SM clock) and 6 fp32 flops for each at the
    fp32 peak (dt a, the state's multiply and add, C's product and sum).
    Returns (ms, "bytes" or "operations", bytes, exps)."""
    nbytes = (b * l * d * (elt + 4 + 4) + 2 * b * l * n * elt + d * n * 4
              + b * d * n * 4)
    exps = b * l * d * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(exps / (SMS * SFU_EXP_PER_CLOCK * sm_clock_hz()),
                6.0 * exps / FP32_FLOPS) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (nbytes, exps)


def mamba2_scan_bound(b, l, d, n, hd, elt):
    """Least time for the per-head B4's function (Mamba-2's layout, ``hd``
    channels a head): x (elt bytes) and y
    (fp32) once per (b, t, d), dt (fp32) once per (b, t, head), B and C
    once per (b, t, n), a_log and h_last once; against its operations,
    the larger of one exponential per (b, t, head), exp(dt a), at the
    SFUs' rate and 5 fp32 flops per (b, t, d, n) at the fp32 peak (the
    state's multiply by exp(dt a), the (dt x) B product, their sum, C's
    product and its sum). Returns (ms, "bytes" or "operations", bytes,
    exps)."""
    nh = d // hd
    nbytes = (b * l * d * (elt + 4) + b * l * nh * 4 + 2 * b * l * n * elt
              + nh * 4 + b * d * n * 4)
    exps = b * l * nh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(exps / (SMS * SFU_EXP_PER_CLOCK * sm_clock_hz()),
                5.0 * b * l * d * n / FP32_FLOPS) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (nbytes, exps)


def timed_scan_case(torch, args, shape, err, launches, run: str):
    """B4 on ``args`` (x, B, C in one dtype at ``shape`` (B, L, D, N)),
    already held to its plain version (``err``), timed by CUDA events and
    by its device time (``device_ms``) beside its plain version and
    ``scan_bound``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import ssm_scan_plain
    elt = args[0].element_size()
    bnd, by, nbytes, exps = scan_bound(*shape, elt=elt)
    name = str(args[0].dtype).replace("torch.", "")
    case = {"shape": "B={} L={} D={} N={} x/B/C {}".format(*shape, name),
            "launches": launches, "max_abs_err": err, "exp_count": exps,
            "ms": time_ms(torch, lambda: ops.selective_scan(*args)),
            "device_ms": device_ms(
                torch, lambda: ops.selective_scan(*args),
                DEVICE_MATCH["selective_scan"]),
            "plain_ms": time_ms(torch, lambda: ssm_scan_plain(*args),
                                iters=3, warmup=1),
            "bound_ms": bnd, "bound_by": by, "library_ms": None}
    print(f"kernel ssm_scan {case['shape']} ({launches} launches in {run}): "
          f"err {err:.3g} (atol {SCAN_TOL['atol']}, rtol "
          f"{SCAN_TOL['rtol']}); {case['ms']:.4f} ms (device "
          f"{case['device_ms']:.4f}), plain {case['plain_ms']:.4f} ms, "
          f"bound {bnd:.5f} ms ({by}: {nbytes / 1e6:.2f} MB; "
          f"{exps / 1e6:.3g} M exp at {SFU_EXP_PER_CLOCK} a clock an SM)",
          flush=True)
    return case


def heads_case(torch, dev, gen, b, l, d, n, hd, dtype):
    """The per-head kernels' inputs in Mamba-2's layout: x, B and C in
    ``dtype``, dt (B, L, nh) drawn per head, a = -exp(a_log) at a_log =
    log(1..nh) (the init: a down to -nh)."""
    nh = d // hd
    x = torch.randn((b, l, d), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, nh), generator=gen, device=dev) - 1.0)
    a = -torch.exp(torch.log(torch.arange(1, nh + 1, device=dev,
                                          dtype=torch.float32)))
    bm = torch.randn((b, l, n), generator=gen, device=dev).to(dtype)
    cm = torch.randn((b, l, n), generator=gen, device=dev).to(dtype)
    return x, dt, a, bm, cm


def timed_heads_case(torch, args, shape, hd, launches, run: str):
    """The per-head B4 (``ops.selective_scan_heads``) on ``args``
    (``heads_case``'s, at ``shape`` (B, L, D, N), ``hd`` channels a
    head): held to ``ssm_scan_heads_plain`` at ``SCAN_TOL``, bitwise to
    B4 on the inputs expanded per channel (``expand_heads``) and to a
    second launch that counts the exponentials the kernel evaluates,
    which must be ``heads_fwd_exp_count``'s. Timed by CUDA events and
    device time beside that B4 call, its plain version and
    ``mamba2_scan_bound`` (B4's generic ``scan_bound`` beside it)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import (expand_heads,
                                              heads_fwd_exp_count, ssm_scan,
                                              ssm_scan_heads,
                                              ssm_scan_heads_plain)
    b, l, d, n = shape
    name = str(args[0].dtype).replace("torch.", "")
    what = f"ssm_scan_heads {shape} hd={hd} {name}"
    y, h = ops.selective_scan_heads(*args)
    py, ph = ssm_scan_heads_plain(*args)
    err = max(within_tol(torch, y, py, f"{what} y", **SCAN_TOL),
              within_tol(torch, h, ph, f"{what} h_last", **SCAN_TOL))
    del py, ph
    expanded = (args[0], *expand_heads(args[1], args[2], hd, n), args[3],
                args[4])
    ry, rh = ssm_scan(*expanded)
    counter = torch.zeros(1, dtype=torch.int64, device=args[0].device)
    y2, h2 = ssm_scan_heads(*args, exp_count=counter)
    torch.cuda.synchronize()
    if not (torch.equal(y, ry) and torch.equal(h, rh)):
        diff = max((y - ry).abs().max().item(), (h - rh).abs().max().item())
        fail(f"{what} is not bitwise B4 on the expanded inputs: max diff "
             f"{diff}")
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        fail(f"{what}: a second (counted) launch gave other bits")
    counted = int(counter.item())
    want = heads_fwd_exp_count(b, l, d // hd, hd, n)
    if counted != want:
        fail(f"{what}: the kernel evaluated {counted} exponentials, its "
             f"formula says {want}")
    del y, h, ry, rh, y2, h2
    elt = args[0].element_size()
    gbnd, gby, _, gexps = scan_bound(*shape, elt=elt)
    bnd, by, nbytes, exps = mamba2_scan_bound(*shape, hd=hd, elt=elt)
    fn = lambda: ops.selective_scan_heads(*args)  # noqa: E731
    fn_b4 = lambda: ssm_scan(*expanded)  # noqa: E731
    case = {"shape": "B={} L={} D={} N={} hd={} x/B/C {}".format(
                *shape, hd, name),
            "launches": launches, "max_abs_err": err, "bitwise_b4": True,
            "kernel_exp_count": counted, "exp_count": exps,
            "ms": time_ms(torch, fn),
            "device_ms": device_ms(torch, fn,
                                   DEVICE_MATCH["selective_scan_heads"]),
            "b4_ms": time_ms(torch, fn_b4),
            "b4_device_ms": device_ms(torch, fn_b4,
                                      DEVICE_MATCH["selective_scan"]),
            "plain_ms": time_ms(torch, lambda: ssm_scan_heads_plain(*args),
                                iters=3, warmup=1),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "generic_bound_ms": gbnd, "generic_bound_by": gby,
            "generic_exp_count": gexps}
    case["bound_share"] = bnd / case["device_ms"]
    print(f"kernel ssm_scan_heads {case['shape']} ({launches} launches in "
          f"{run}): err {err:.3g} (atol {SCAN_TOL['atol']}, rtol "
          f"{SCAN_TOL['rtol']}), bitwise B4 on the expanded inputs; "
          f"{case['ms']:.4f} ms (device {case['device_ms']:.4f}, "
          f"{case['bound_share']:.3f} of the bound), B4 on the expanded "
          f"inputs {case['b4_ms']:.4f} ms (device "
          f"{case['b4_device_ms']:.4f}), plain {case['plain_ms']:.4f} ms, "
          f"bound {bnd:.5f} ms ({by}: {nbytes / 1e6:.2f} MB; "
          f"{exps / 1e6:.4g} M exp needed, the kernel counted {counted}); "
          f"B4's generic bound {gbnd:.5f} ms ({gby}, {gexps / 1e6:.1f} M "
          f"exp)", flush=True)
    return case


def scan_kernel_phase(torch, dev, shapes):
    """B4 against its plain version at SCAN_TOL: a ragged fp32 shape
    (3, 37, 200, 16), then in bf16 every (B, L, D, N) the ssm run
    launched (``shapes``: a count of launches by shape) and
    ``SCAN_CONTINUITY_SHAPE``, each timed by CUDA events and by its
    device time (``device_ms``) beside its plain version and its bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import ssm_scan_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def check(dtype, shape):
        args = scan_case(torch, dev, gen, dtype, *shape)
        y, h = ops.selective_scan(*args)
        py, ph = ssm_scan_plain(*args)
        name = str(dtype).replace("torch.", "")
        err = max(within_tol(torch, y, py, f"ssm_scan y {name} {shape}",
                             **SCAN_TOL),
                  within_tol(torch, h, ph, f"ssm_scan h_last {name} {shape}",
                             **SCAN_TOL))
        return args, err

    _, fp32_err = check(torch.float32, (3, 37, 200, 16))
    cases = []
    for shape in sorted(set(shapes) | {SCAN_CONTINUITY_SHAPE}):
        args, err = check(torch.bfloat16, shape)
        cases.append(timed_scan_case(torch, args, shape, err,
                                     shapes.get(shape, 0), "the ssm run"))
    print(f"kernel ssm_scan fp32 B=3 L=37 D=200 N=16: err {fp32_err:.3g}; "
          f"bounds at a max SM clock of {sm_clock_hz() / 1e6:.0f} MHz",
          flush=True)
    # the kernels line reports the shape the ssm run launched most
    top = max(cases, key=lambda c: c["launches"])
    return {**top, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "fp32_max_abs_err": fp32_err, "cases": cases}


def scan_bwd_bound(b, l, d, n, elt, hd=None):
    """Least time for B4-bwd's work. Bytes: x (elt), dt and dy (fp32) read
    and dx (elt) and ddt (fp32) written once per (b, t, d); B and C read
    and dB and dC written once per (b, t, n) (elt each); a read and da
    written once. Operations: the larger of B L D N exponentials exp(dt
    a) at the SFUs' rate (``scan_bound``'s) and 22 fp32 flops per (b, t,
    d, n) at the fp32 peak (the state again, 3; g_t, 2; dx's product and
    sum, 2; ddt's x B, a exp(dt a), times h_{t-1}, sum, times g, sum, 6;
    dB's and dC's products and sums, 4; da's three products and sum, 4;
    the carry, 1). With ``hd`` (Mamba-2's layout, ``hd`` channels a head)
    the function's dt, ddt, a and da are per head and its exponentials
    one per (b, t, head), and it needs 14 flops per (b, t, d, n): the
    state again, 3; g_t, 2; the carry, 1; gb = g . B's product and sum,
    2; S = g . h_{t-1}'s, 2; dB's and dC's, 4. ddt's x . gb and a e_t S
    and da's dt e_t S are per (b, t, d) or per (b, t, head): not
    counted. Returns (ms, "bytes" or "operations", bytes, exps)."""
    per_d = 4 if hd is None else 0
    heads = 0 if hd is None else d // hd
    nbytes = (b * l * d * (2 * elt + 4 + 2 * per_d) + b * l * heads * 8
              + 4 * b * l * n * elt
              + (2 * d * n * 4 if hd is None else 2 * heads * 4))
    exps = b * l * (d * n if hd is None else heads)
    flops = 22.0 if hd is None else 14.0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(exps / (SMS * SFU_EXP_PER_CLOCK * sm_clock_hz()),
                flops * b * l * d * n / FP32_FLOPS) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (nbytes, exps)


def scan_bwd_errors(torch, got, want):
    """B4-bwd's outputs (dx, ddt, da, dB, dC) against ``want``: each
    output's error under its limit (see SCAN_BWD_FP32_REL_L2) and whether
    every one holds. Returns ({name: (kind, error, limit)}, ok)."""
    out, ok = {}, True
    for name, g, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype \
                or not bool(torch.isfinite(g).all()):
            out[name] = ("shape/dtype/finite", float("inf"), 0.0)
            ok = False
            continue
        if g.dtype != torch.float32:
            kind, lim = "rel_l2", SCAN_BWD_BF16_REL_L2
            err = rel_l2(torch, g, w)
        elif name in ("dx", "ddt"):
            scale = max(1.0, w.abs().max().item())
            diff = (g - w).abs()
            kind, lim = "abs_of_scale", SCAN_TOL["atol"]
            err = diff.max().item() / scale
            ok = ok and bool((diff <= SCAN_TOL["atol"] * scale
                              + SCAN_TOL["rtol"] * w.abs()).all())
            out[name] = (kind, err, lim)
            continue
        else:
            kind, lim = "rel_l2", SCAN_BWD_FP32_REL_L2
            err = rel_l2(torch, g, w)
        out[name] = (kind, err, lim)
        ok = ok and err <= lim
    return out, ok


def scan_bwd_phase(torch, dev, ptxas):
    """[scan-bwd]: B4-bwd at ``SCAN_BWD_SHAPES`` in bf16 and fp32 against
    ``ssm_scan_bwd_plain`` and against autograd through ``ssm_scan_plain``
    (``scan_bwd_errors``' limits; the ragged shape also with a dh_last);
    the kernel's ddt scaled by ``PLANTED_DDT_SCALE``, and its dB by
    ``PLANTED_DB_SCALE``, must each fail the same limits; two launches on
    the same inputs give the same bits (every sum has a fixed order).
    Timed by CUDA events and by its device time (both of its kernels,
    ``device_ms``) beside its plain version and ``scan_bwd_bound``. At
    every shape the kernel counts the exponentials it evaluates
    (``exp_count``), which must be ``bwd_exp_count``'s without changing
    a bit. Its registers and spills (``ptxas``: ``ptxas_usage``'s) are
    printed: every instantiation must use at most 128 registers and
    spill nothing."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import (CHUNK, bwd_exp_count,
                                              ssm_scan_bwd,
                                              ssm_scan_bwd_plain,
                                              ssm_scan_plain)
    over = {k: v for k, v in ptxas.items()
            if v.get("registers", 0) > 128 or v.get("spill_stores", 0)
            or v.get("spill_loads", 0)}
    if not ptxas or over:
        fail(f"[scan-bwd] ssm_bwd_kernel over 128 registers or spilling: "
             f"{json.dumps(over or ptxas)}")
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases = []
    for b, l, d, n in SCAN_BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            tag = f"B={b} L={l} D={d} N={n} {name}"
            args = scan_case(torch, dev, gen, dtype, b, l, d, n)
            dy = torch.randn((b, l, d), generator=gen, device=dev)
            dhs = [None]
            if l % CHUNK:
                dhs.append(torch.randn((b, d, n), generator=gen,
                                       device=dev))
            errs, max_abs = {}, None
            for dh in dhs:
                got = ops.selective_scan_bwd(*args, dy, dh)
                again = ops.selective_scan_bwd(*args, dy, dh)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    fail(f"[scan-bwd] {tag}: two launches differ")
                want = ssm_scan_bwd_plain(*args, dy, dh)
                key = "plain" if dh is None else "plain, dh_last"
                errs[key], ok = scan_bwd_errors(torch, got, want)
                if not ok:
                    fail(f"[scan-bwd] {tag} against {key}: {errs[key]}")
                for i, what, scale in ((1, "ddt", PLANTED_DDT_SCALE),
                                       (3, "dB", PLANTED_DB_SCALE)):
                    planted = list(got)
                    planted[i] = (got[i].float() * scale).to(got[i].dtype)
                    _, passed = scan_bwd_errors(torch, planted, want)
                    if passed:
                        fail(f"[scan-bwd] {tag}: {what} x {scale} passed "
                             f"the limits")
                if max_abs is None:
                    max_abs = max((g.float() - w.float()).abs().max().item()
                                  for g, w in zip(got, want))
                del want
            ts = [t.detach().clone().requires_grad_(True) for t in args]
            y, _ = ssm_scan_plain(*ts)
            auto = torch.autograd.grad((y * dy).sum(), ts)
            del y
            got = ops.selective_scan_bwd(*args, dy)
            errs["autograd"], ok = scan_bwd_errors(torch, got, auto)
            if not ok:
                fail(f"[scan-bwd] {tag} against autograd: "
                     f"{errs['autograd']}")
            del auto, ts
            bnd, by, nbytes, exps = scan_bwd_bound(
                b, l, d, n, args[0].element_size())
            counter = torch.zeros(1, dtype=torch.int64, device=dev)
            counted = ssm_scan_bwd(*args, dy, exp_count=counter)
            evaluated = int(counter.item())
            if evaluated != bwd_exp_count(b, l, d, n) or not all(
                    torch.equal(x, y) for x, y in zip(got, counted)):
                fail(f"[scan-bwd] {tag}: the kernel evaluated {evaluated} "
                     f"exponentials, its formula says "
                     f"{bwd_exp_count(b, l, d, n)} (or the counted launch's "
                     f"outputs differ)")
            del counted
            case = {"shape": tag, "dtype": name, "errors": errs,
                    "max_abs_err": max_abs, "exp_count": exps,
                    "kernel_exp_count": evaluated,
                    "bound_ms": bnd, "bound_by": by, "bound_bytes": nbytes,
                    "library_ms": None}
            if b * l * d >= 1 << 20:      # the training shape: timed
                fn = lambda: ops.selective_scan_bwd(*args, dy)  # noqa: E731
                case["ms"] = time_ms(torch, fn, iters=10)
                case["device_ms"] = device_ms(
                    torch, fn, DEVICE_MATCH["selective_scan_bwd"], iters=10)
                case["plain_ms"] = time_ms(
                    torch, lambda: ssm_scan_bwd_plain(*args, dy), iters=2,
                    warmup=1)
            cases.append(case)
            timing = (f"; {case['ms']:.4f} ms (device "
                      f"{case['device_ms']:.4f}), plain "
                      f"{case['plain_ms']:.2f} ms"
                      if "ms" in case else "")
            print(f"kernel ssm_scan_bwd {tag}: "
                  + "; ".join(f"{k}: " + ", ".join(
                      f"{o} {e[1]:.3g}" for o, e in v.items())
                      for k, v in errs.items())
                  + f"{timing}; bound {bnd:.5f} ms ({by}: "
                  f"{nbytes / 1e6:.1f} MB, {exps / 1e6:.4g} M exp needed); "
                  f"the kernel counted {evaluated} exp it evaluated",
                  flush=True)
            del args, dy, got
            gc.collect()
            torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[scan-bwd] planted ddt x {PLANTED_DDT_SCALE} and dB x "
          f"{PLANTED_DB_SCALE} caught at every shape and dtype; "
          f"ssm_bwd_kernel registers and spill bytes by instantiation "
          f"{json.dumps(ptxas)}; phase {seconds:.1f} s", flush=True)
    # the kernels line reports falcon-mamba's training shape in bf16 (the
    # [ssm-train] run's)
    top = next(c for c in cases if "ms" in c and c["dtype"] == "bfloat16")
    return {**top, "cases": cases, "ptxas": ptxas, "seconds": seconds}


def per_head(got, b, l, nh):
    """B4-bwd's (per-channel) gradients with ddt summed over each head's
    channels and da over its channels and states."""
    dx, ddt, da, dbm, dcm = got
    return (dx, ddt.reshape(b, l, nh, -1).sum(-1),
            da.reshape(nh, -1).sum(-1), dbm, dcm)


def scan_heads_bwd_phase(torch, dev, ptxas):
    """[scan-bwd], per head: the per-head (Mamba-2) B4-bwd at
    ``SCAN_HEADS_BWD_SHAPES`` in bf16 and fp32 against
    ``ssm_scan_heads_bwd_plain`` (with and without a dh_last), against
    the per-channel B4-bwd on the inputs expanded per channel
    (``expand_heads``; ddt and da summed per head) and against autograd
    through ``ssm_scan_plain`` on those inputs, each at
    ``scan_bwd_errors``' limits; ddt x ``PLANTED_DDT_SCALE`` and dB x
    ``PLANTED_DB_SCALE`` must each fail them; two launches give the same
    bits. At zamba2's training shape it is timed by CUDA events and by
    device time (``device_ms``: both of its kernels) beside its plain
    version, the per-channel B4-bwd on the same inputs and
    ``scan_bwd_bound`` (hd = 64). At every shape the kernel counts the
    exponentials it evaluates (``exp_count``): the function needs one
    per (b, t, head), and another count, or outputs that differ from the
    uncounted launch's, fail. Its registers and spills are printed
    (``ptxas``: ``ptxas_usage``'s)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import (expand_heads,
                                              ssm_scan_heads_bwd,
                                              ssm_scan_heads_bwd_plain,
                                              ssm_scan_plain)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    cases = []
    for b, l, d, n, hd in SCAN_HEADS_BWD_SHAPES:
        nh = d // hd
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            tag = f"B={b} L={l} D={d} N={n} hd={hd} {name}"
            args = heads_case(torch, dev, gen, b, l, d, n, hd, dtype)
            dy = torch.randn((b, l, d), generator=gen, device=dev)
            dh = torch.randn((b, d, n), generator=gen, device=dev)
            expanded = (args[0], *expand_heads(args[1], args[2], hd, n),
                        args[3], args[4])
            errs, max_abs = {}, None
            for dhl in (None, dh):
                key = "" if dhl is None else ", dh_last"
                got = ops.selective_scan_heads_bwd(*args, dy, dhl)
                again = ops.selective_scan_heads_bwd(*args, dy, dhl)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    fail(f"[scan-bwd] per head {tag}: two launches differ")
                want = ssm_scan_heads_bwd_plain(*args, dy, dhl)
                errs["plain" + key], ok = scan_bwd_errors(torch, got, want)
                if not ok:
                    fail(f"[scan-bwd] per head {tag} against plain{key}: "
                         f"{errs['plain' + key]}")
                for i, what, scale in ((1, "ddt", PLANTED_DDT_SCALE),
                                       (3, "dB", PLANTED_DB_SCALE)):
                    planted = list(got)
                    planted[i] = (got[i].float() * scale).to(got[i].dtype)
                    _, passed = scan_bwd_errors(torch, planted, want)
                    if passed:
                        fail(f"[scan-bwd] per head {tag}: {what} x {scale} "
                             f"passed the limits")
                if max_abs is None:
                    max_abs = max((g.float() - w.float()).abs().max().item()
                                  for g, w in zip(got, want))
                del want
                old = per_head(ops.selective_scan_bwd(*expanded, dy, dhl),
                               b, l, nh)
                errs["per_channel" + key], ok = scan_bwd_errors(torch, got,
                                                                 old)
                if not ok:
                    fail(f"[scan-bwd] per head {tag} against the "
                         f"per-channel B4-bwd{key}: "
                         f"{errs['per_channel' + key]}")
                del old
            ts = [t.detach().clone().requires_grad_(True) for t in args]
            y, _ = ssm_scan_plain(ts[0], *expand_heads(ts[1], ts[2], hd, n),
                                  ts[3], ts[4])
            auto = torch.autograd.grad((y * dy).sum(), ts)
            del y
            got = ops.selective_scan_heads_bwd(*args, dy)
            errs["autograd"], ok = scan_bwd_errors(torch, got, auto)
            if not ok:
                fail(f"[scan-bwd] per head {tag} against autograd: "
                     f"{errs['autograd']}")
            del auto, ts
            bnd, by, nbytes, exps = scan_bwd_bound(
                b, l, d, n, args[0].element_size(), hd=hd)
            counter = torch.zeros(1, dtype=torch.int64, device=dev)
            counted = ssm_scan_heads_bwd(*args, dy, exp_count=counter)
            evaluated = int(counter.item())
            if evaluated != exps or not all(
                    torch.equal(x, y) for x, y in zip(got, counted)):
                fail(f"[scan-bwd] per head {tag}: the kernel evaluated "
                     f"{evaluated} exponentials, the function needs {exps}"
                     f" (or the counted launch's outputs differ)")
            del counted
            case = {"shape": tag, "dtype": name, "errors": errs,
                    "max_abs_err": max_abs,
                    "kernel_exp_count": evaluated, "exp_count": exps,
                    "bound_ms": bnd, "bound_by": by, "bound_bytes": nbytes,
                    "library_ms": None}
            if b * l * d >= 1 << 20:      # the training shape: timed
                fn = lambda: ops.selective_scan_heads_bwd(  # noqa: E731
                    *args, dy)
                case["ms"] = time_ms(torch, fn, iters=20)
                case["device_ms"] = device_ms(
                    torch, fn, DEVICE_MATCH["selective_scan_heads_bwd"],
                    iters=20)
                fn_old = lambda: ops.selective_scan_bwd(  # noqa: E731
                    *expanded, dy)
                case["per_channel_ms"] = time_ms(torch, fn_old, iters=5)
                case["per_channel_device_ms"] = device_ms(
                    torch, fn_old, DEVICE_MATCH["selective_scan_bwd"],
                    iters=5)
                case["plain_ms"] = time_ms(
                    torch, lambda: ssm_scan_heads_bwd_plain(*args, dy),
                    iters=2, warmup=1)
                case["bound_share"] = bnd / case["device_ms"]
            cases.append(case)
            timing = (f"; {case['ms']:.4f} ms (device "
                      f"{case['device_ms']:.4f}, {case['bound_share']:.3f} "
                      f"of the bound), per-channel B4-bwd "
                      f"{case['per_channel_ms']:.4f}"
                      f" ms (device {case['per_channel_device_ms']:.4f}), "
                      f"plain "
                      f"{case['plain_ms']:.2f} ms" if "ms" in case else "")
            print(f"kernel ssm_scan_heads_bwd {tag}: "
                  + "; ".join(f"{k}: " + ", ".join(
                      f"{o} {e[1]:.3g}" for o, e in v.items())
                      for k, v in errs.items())
                  + f"{timing}; bound {bnd:.5f} ms ({by}: "
                  f"{nbytes / 1e6:.1f} MB, {exps / 1e6:.4g} M exp); the "
                  f"kernel counted {evaluated} exp it evaluated",
                  flush=True)
            del args, dy, dh, expanded, got
            gc.collect()
            torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[scan-bwd] per head: planted ddt x {PLANTED_DDT_SCALE} and dB x "
          f"{PLANTED_DB_SCALE} caught at every shape and dtype; "
          f"mamba2_bwd_kernel registers and spill bytes by instantiation "
          f"{json.dumps(ptxas)}; phase {seconds:.1f} s", flush=True)
    top = next(c for c in cases if "ms" in c and c["dtype"] == "bfloat16")
    return {**top, "fp32": next(c for c in cases if "ms" in c
                                and c["dtype"] == "float32"),
            "cases": cases, "ptxas": ptxas, "seconds": seconds}


def serve_spec(engine: str, events_dir: pathlib.Path,
               arch: str = "granite-3-2b", overrides=None, sampling=None,
               profiler_dir=None):
    """The ``SERVE`` workload through ``engine`` at full width; greedy, or
    sampled with the ``SamplingSpec`` fields in ``sampling``; with
    ``profiler_dir``, traced by the port's profiler hook."""
    from repro_torch.api import (AdmissionSpec, CacheSpec, DraftSpec,
                                 EngineSpec, ModelSpec, ObsSpec,
                                 SamplingSpec, ServeSpec, WorkloadSpec)
    draft = (DraftSpec(num_layers=SPEC_DRAFT_LAYERS, gamma=SPEC_GAMMA)
             if engine == "speculative" else DraftSpec())
    return ServeSpec(
        model=ModelSpec(arch=arch, reduced=False,
                        overrides=dict(overrides or {})),
        engine=EngineSpec(name=engine, seed=0),
        admission=AdmissionSpec(token_budget=SERVE["token_budget"]),
        workload=WorkloadSpec(num_requests=SERVE["num_requests"],
                              prompt_lens=SERVE["prompt_lens"],
                              max_new_tokens=SERVE["max_new_tokens"]),
        cache=CacheSpec(page_size=SERVE["page_size"]),
        draft=draft,
        sampling=(SamplingSpec(method="sample", **sampling) if sampling
                  else SamplingSpec()),
        obs=ObsSpec(enabled=True,
                    events_path=str(events_dir / f"{arch}-{engine}.jsonl"),
                    jax_profiler_dir=profiler_dir))


def phase_times(events_path: str):
    """Mean host-clock span (device work included: each phase ends in a
    sync) of the scheduler's admit (prefill) and decode_step phases."""
    spans = {"admit": [], "decode_step": []}
    for line in pathlib.Path(events_path).read_text().splitlines():
        row = json.loads(line)
        if row.get("kind") == "span" and row.get("name") in spans:
            spans[row["name"]].append(row["dur_s"] * 1e3)
    return {k: (sum(v) / len(v) if v else 0.0, len(v))
            for k, v in spans.items()}


def count_prefills(engine):
    """Count the engine's prefill calls (each one batched forward over a
    group of same-length prompts) by wrapping its prefill hook."""
    calls = [0]
    run = engine._run_prefill

    def counted(tokens, plen):
        calls[0] += 1
        return run(tokens, plen)
    engine._run_prefill = counted
    return calls


def serve_run(torch, ctx, spec, engine: str):
    """One ``run_serve`` with the launch counts set to 0 just before and
    read just after; prints the report, launches and phase times."""
    from repro_torch.api import run_serve
    from repro_torch.kernels import ops
    prefills = count_prefills(ctx.engine)
    ops.reset_launches()
    report = run_serve(spec, ctx=ctx)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    times = phase_times(spec.obs.events_path)
    print(report.summary(), flush=True)
    print(f"[{engine}] launches {launches}; prefill calls {prefills[0]}, "
          f"steps {report.steps}, prefill_tokens {report.prefill_tokens}, "
          f"decode_tokens {report.decode_tokens}; mean admit (prefill) "
          f"{times['admit'][0]:.2f} ms over {times['admit'][1]}, mean "
          f"decode step {times['decode_step'][0]:.2f} ms over "
          f"{times['decode_step'][1]}; peak KV bytes "
          f"{report.cache_utilization['peak_in_use_bytes']}", flush=True)
    return report, launches, prefills[0]


def serve_phase(torch, dev, events_dir: pathlib.Path):
    from repro_torch.api import build_serve_context, build_workload

    reports, ctx = {}, None
    params = None
    launches = {}
    for engine in ("paged", "continuous", "speculative"):
        spec = serve_spec(engine, events_dir)
        t0 = time.perf_counter()
        ctx = build_serve_context(spec, params=params, device=dev)
        params = ctx.params
        torch.cuda.synchronize()
        print(f"[{engine}] built in {time.perf_counter() - t0:.2f}s "
              f"({sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
              f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated)", flush=True)
        report, launches[engine], prefills = serve_run(torch, ctx, spec,
                                                       engine)
        reports[engine] = report
        if engine == "speculative":
            spec_checks(ctx, report, launches[engine], prefills)
    if min(launches["paged"][k] for k in ("flash_attention",
                                          "paged_attention")) < 1:
        fail(f"the paged run did not launch both serving kernels: "
             f"{launches['paged']}")
    if launches["continuous"]["flash_attention"] < 1:
        fail("the continuous run did not launch flash_attention")
    requests = build_workload(spec, ctx.engine.cfg.vocab_size)
    return reports, launches, ctx, requests


def spec_checks(ctx, report, launches, prefills: int,
                tag: str = "speculative") -> None:
    """The speculative run's launches follow its steps (one B3 a layer a
    verify step, one B2 a draft layer a draft step, one B1 a layer a
    prefill call, nothing else), its pages all came home, and its
    acceptance is printed."""
    engine = ctx.engine
    layers = ctx.model.cfg.num_layers
    want = {name: 0 for name in launches}
    want.update({"spec_verify": layers * report.steps,
                 "paged_attention": SPEC_DRAFT_LAYERS * engine.draft_steps,
                 "flash_attention": layers * prefills})
    if launches != want or report.steps < 1:
        fail(f"[{tag}] launches {launches}, wanted {want} ({layers} B3 a "
             f"verify step, {SPEC_DRAFT_LAYERS} B2 a draft step, {layers} "
             f"B1 a prefill)")
    engine.pool.check_no_leaks()
    if engine.pool.pages_in_use:
        fail(f"[{tag}] {engine.pool.pages_in_use} pages still held")
    s = report.speculation
    ttft = report.to_json()["ttft_ms"]
    print(f"[{tag}] draft {s['draft']} gamma {s['gamma']}: "
          f"{report.steps} verify steps, {engine.draft_steps} draft steps, "
          f"{s['windows']} row windows, proposed {s['proposed']}, accepted "
          f"{s['accepted']} (acceptance {s['acceptance_rate']:.4f}), "
          f"{s['tokens_per_step']:.3f} tokens a step; TTFT p50/p95 "
          f"{ttft['p50']:.1f}/{ttft['p95']:.1f} ms; decode "
          f"{report.decode_tok_per_s:.1f} tok/s; no page leaked",
          flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _tokens_of(report, rid):
    return next(r["tokens"] for r in report.per_request if r["rid"] == rid)


def forced_gaps(torch, ctx, prompt, tokens):
    """Top-2 logit gaps along ``tokens`` (teacher-forced batch-1 greedy
    decoding on the card): how near a tie each of those picks was."""
    model, params = ctx.model, ctx.params
    toks = torch.as_tensor(prompt[None], device=params["client"][
        "embed"].device)
    logits, cache, pos = model.prefill(params, {"tokens": toks},
                                       cache_len=ctx.engine.pool.slot_len)
    posv = torch.tensor([pos], device=toks.device)
    gaps = []
    for tok in tokens:
        top2 = torch.topk(logits.reshape(-1), 2).values
        gaps.append(float(top2[0] - top2[1]))
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[tok]], device=toks.device), posv)
        posv = posv + 1
    return gaps


def agreement_phase(torch, reports, ctx, requests, limit=None,
                    reference=None, gate: bool = True):
    """Every report's requests against a reference: equal, or a first
    divergence where the reference's top-2 gap is below the limit
    (``NEAR_TIE_GAP``, or ``limit(top_logit)``). The reference is
    ``reference_generate`` (batch-1 greedy decoding), or ``reference``:
    request -> (tokens, top-2 gaps, top logits) of each step. Prints the
    largest |top logit| seen and each divergence with the rule it passed
    under (with ``gate`` False: with its gap, and nothing fails);
    returns the exact count and each divergence's (token, gap)."""
    from repro_torch.runtime import reference_generate

    def batch1(req):
        gaps, tops = [], []
        toks = reference_generate(ctx.model, ctx.params, req.prompt,
                                  req.max_new_tokens,
                                  ctx.engine.pool.slot_len, gaps=gaps,
                                  tops=tops)
        return toks, gaps, tops
    reference = reference or batch1
    vocab = ctx.engine.cfg.vocab_size
    exact, near = 0, {}
    biggest = 0.0
    for req in requests:
        want, gaps, tops = reference(req)
        biggest = max(biggest, max(abs(t) for t in tops))
        for engine, report in reports.items():
            got = _tokens_of(report, req.rid)
            if len(got) != req.max_new_tokens or \
                    not all(0 <= t < vocab for t in got):
                fail(f"[{engine}] request {req.rid}: malformed tokens "
                     f"{got}")
            if got == want:
                exact += 1
                continue
            i = next(j for j in range(len(want)) if got[j] != want[j])
            near[f"{engine}/{req.rid}"] = (i, gaps[i])
            if not gate:
                print(f"[{engine}] request {req.rid}: first differs at "
                      f"token {i} (reference top-2 gap {gaps[i]:.4f}, "
                      f"top logit {tops[i]:.4f}; not gated)", flush=True)
                continue
            lim = NEAR_TIE_GAP if limit is None else limit(tops[i])
            if gaps[i] >= lim:
                fail(f"[{engine}] request {req.rid} diverges at token {i} "
                     f"where the reference's top-2 gap is {gaps[i]:.4f} "
                     f">= {lim}")
            print(f"[{engine}] request {req.rid}: near-tie at token {i} "
                  f"(reference top-2 gap {gaps[i]:.4f} < {lim:.4g})",
                  flush=True)
    print(f"agreement with the reference: {exact} exact, {len(near)} "
          f"{'near-tie' if gate else 'differing (not gated)'}, of "
          f"{len(requests) * len(reports)} served requests; largest |top "
          f"logit| {biggest:.4f}", flush=True)
    if "speculative" in reports and "paged" in reports:
        same = 0
        for req in requests:
            a = _tokens_of(reports["paged"], req.rid)
            b = _tokens_of(reports["speculative"], req.rid)
            if a == b:
                same += 1
                continue
            i = next(j for j in range(len(a)) if a[j] != b[j])
            gap = forced_gaps(torch, ctx, req.prompt, a)[i]
            if gap >= NEAR_TIE_GAP:
                fail(f"speculative request {req.rid} differs from paged at "
                     f"token {i} where the top-2 gap is {gap:.4f}")
            print(f"[speculative] request {req.rid}: differs from paged at "
                  f"token {i}, a near-tie (gap {gap:.4f})", flush=True)
        print(f"speculative vs paged: {same} of {len(requests)} requests "
              f"token-identical, the rest near-ties", flush=True)
    return {"exact": exact, "near_ties": near}


def forced_logits(torch, ctx, prompt, tokens):
    """Batch-1 fp32 logits (V,) after ``prompt`` and the forced
    ``tokens``: the context of output index ``len(tokens)``."""
    model, params = ctx.model, ctx.params
    dev = params["client"]["embed"].device
    logits, cache, pos = model.prefill(
        params, {"tokens": torch.as_tensor(prompt[None], device=dev)},
        cache_len=ctx.engine.pool.slot_len)
    posv = torch.tensor([pos], device=dev)
    for tok in tokens:
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[tok]], device=dev), posv)
        posv = posv + 1
    return logits.reshape(-1).float()


def sampled_tie(torch, sampler, logits, rid: int, idx: int, a: int,
                b: int, limit: float):
    """How near a tie the sampled picks ``a`` and ``b`` were on
    ``logits`` under the key (rid, idx), where rounding moves each
    logit / T by less than ``limit``: the gap of their perturbed scores
    (logit / T + Gumbel noise, before the filter), each token's margin
    to the top-k boundary with whether it is kept (a kept token's
    distance, in logit / T, to the first one left out; a left-out
    token's to the k-th kept), and whether each is a pick such rounding
    allows: kept or within ``limit`` of the boundary, and its perturbed
    score within ``limit`` of the best of the tokens kept by ``limit``
    or more (those no such rounding drops). The logits are a third
    rounding of the context, so either token may sit on either side of
    the boundary here."""
    from repro_torch.runtime.sampling import filtered_logits, perturbed_scores
    if sampler.top_p is not None:
        raise ValueError("sampled_tie reads the top-k boundary only")
    dev = logits.device
    key = lambda v: torch.tensor([v], dtype=torch.int32,    # noqa: E731
                                 device=dev)
    t = sampler.temperature
    u = perturbed_scores(logits[None], key(rid), key(idx), temperature=t,
                         seed=sampler.seed)[0]
    lg = filtered_logits(logits[None], temperature=t)[0]
    kth = out = float("-inf")
    if sampler.top_k is not None:
        vals = torch.topk(lg, sampler.top_k + 1).values
        kth, out = float(vals[-2]), float(vals[-1])
    firm = lg >= out + limit
    margins, possible = {}, {}
    for tok in (a, b):
        x = float(lg[tok])
        margins[tok] = (x - out, True) if x >= kth else (kth - x, False)
        rivals = u.masked_fill(~firm, float("-inf"))
        rivals[tok] = float("-inf")
        possible[tok] = (x > kth - limit
                         and float(u[tok]) > float(rivals.max()) - limit)
    return abs(float(u[a] - u[b])), margins, possible


def sampled_agreement(torch, reports, ctx, requests, tag: str):
    """Each sampled report against the ``paged`` one, token for token up
    to each request's first difference; a difference must be a near-tie
    of the sampled pick on the paged run's context (``sampled_tie``,
    ``sampled_difference``), within ``NEAR_TIE_GAP / temperature`` (the
    logits' rounding scaled as the filter scales it): each engine's
    token one that the sampler takes under some such rounding. Returns
    identical counts and the near-ties."""
    sampler = ctx.engine.sampler
    limit = NEAR_TIE_GAP / sampler.temperature
    vocab = ctx.engine.cfg.vocab_size
    out = {}
    for engine, report in reports.items():
        if engine == "paged":
            continue
        same, near = 0, []
        for req in requests:
            want = _tokens_of(reports["paged"], req.rid)
            got = _tokens_of(report, req.rid)
            if len(got) != req.max_new_tokens or \
                    not all(0 <= t < vocab for t in got):
                fail(f"[{tag}] {engine} request {req.rid}: malformed "
                     f"tokens {got}")
            if got == want:
                same += 1
                continue
            i = next(j for j in range(len(want)) if got[j] != want[j])
            near.append(sampled_difference(
                torch, sampler, forced_logits(torch, ctx, req.prompt,
                                              want[:i]),
                req.rid, i, want[i], got[i], limit,
                f"[{tag}] sampled {engine} request {req.rid}"))
        out[engine] = {"identical": same, "near_ties": near}
        print(f"[{tag}] sampled {engine} vs paged: {same} of "
              f"{len(requests)} requests token-identical, {len(near)} "
              f"first differences, each a near-tie", flush=True)
    return out


def sampled_difference(torch, sampler, logits, rid: int, i: int, want: int,
                       got: int, limit: float, what: str):
    """One first difference of a sampled run from ``paged`` at output
    index ``i`` (``want`` paged's token, ``got`` the other's) on the
    paged context's ``logits``: passes only if both tokens are picks
    that rounding within ``limit`` allows (``sampled_tie``): a near-tie
    of the scores (their gap under ``limit``) or else of the top-k
    boundary; else fails."""
    gap, margins, possible = sampled_tie(torch, sampler, logits, rid, i,
                                         want, got, limit)
    rule = "scores" if gap < limit else "top-k boundary"
    shown = {tok: round(m, 4) for tok, (m, _) in margins.items()}
    desc = (f"tokens {want} / {got}, perturbed gap {gap:.4f}, top-k margins "
            f"{shown}, kept {[margins[t][1] for t in (want, got)]}, "
            f"possible picks {[possible[t] for t in (want, got)]}; limit "
            f"{limit:.4f}")
    if not (possible[want] and possible[got]):
        fail(f"{what} differs from paged at token {i} beyond a near-tie "
             f"({desc})")
    print(f"{what}: differs from paged at token {i}, a near-tie of the "
          f"{rule} ({desc})", flush=True)
    return {"rid": rid, "token": i, "gap": gap, "rule": rule,
            "margins": shown}


def decode_logits(torch, ctx, requests):
    """One batched paged decode step's logits (B, V) fp32 for the first 8
    requests' last prompt tokens at their prompt lengths."""
    rows = ([int(r.prompt[-1]) for r in requests[:8]],
            [len(r.prompt) for r in requests[:8]])
    tok, pos, table = paged_rows(torch, ctx.engine.pool, *rows)
    logits, _ = ctx.model.decode_step_paged(
        ctx.params, ctx.engine.pool.buffers, tok, pos, table)
    return logits[:, -1].float().contiguous()


def sampler_card_vs_cpu(torch, sampler, logits, rids):
    """The sampler on the card against the same sampler on the CPU on the
    copied logits, each row under ``SAMPLER_CHECK_IDXS`` output indices.
    A differing token must be a tie of the CPU's perturbed scores within
    ``SAMPLER_ULPS`` float32 ulps of their magnitude."""
    import numpy as np
    from repro_torch.runtime.sampling import perturbed_scores
    n = SAMPLER_CHECK_IDXS
    lg = logits.repeat_interleave(n, dim=0)
    rid = torch.as_tensor(rids, dtype=torch.int32).repeat_interleave(n)
    idx = torch.arange(n, dtype=torch.int32).repeat(logits.shape[0])
    def perturbed(lg, rid, idx):
        return perturbed_scores(lg, rid, idx, temperature=sampler.temperature,
                                top_k=sampler.top_k, top_p=sampler.top_p,
                                seed=sampler.seed)
    card = sampler.sample(lg, rid.to(lg.device), idx.to(lg.device)).cpu()
    card_scores = perturbed(lg, rid.to(lg.device), idx.to(lg.device)).cpu()
    scores = perturbed(lg.cpu(), rid, idx)
    host = torch.argmax(scores, dim=-1).to(torch.int32)
    differ = torch.nonzero(card != host).flatten().tolist()
    worst = 0.0
    for r in differ:
        a, b = scores[r, int(card[r])], scores[r, int(host[r])]
        ulp = float(np.spacing(np.float32(max(abs(float(a)),
                                              abs(float(b))))))
        ulps = float(b - a) / ulp
        worst = max(worst, ulps)
        if ulps > SAMPLER_ULPS:
            fail(f"[llama] sampler: row {r} takes {int(card[r])} on the "
                 f"card and {int(host[r])} on the CPU, {ulps:.1f} ulps "
                 f"apart (> {SAMPLER_ULPS})")
    err = float((card_scores - scores).abs().max())
    print(f"[llama] sampler on the card against the CPU: {len(differ)} of "
          f"{len(host)} rows (V {logits.shape[1]}) differ, each a tie "
          f"within {worst:.1f} <= {SAMPLER_ULPS} ulps; perturbed scores "
          f"max abs diff {err:.3g}", flush=True)
    return {"rows": len(host), "differ": len(differ), "worst_ulps": worst,
            "scores_max_abs_diff": err}


def sampler_device_ms(torch, sampler, logits, rids, iters: int = 10):
    """The sampler's own device time and kernel launches a call, from
    torch.profiler (every kernel and copy of the window)."""
    from torch.profiler import ProfilerActivity, profile
    b = logits.shape[0]
    rid = torch.as_tensor(rids, dtype=torch.int32, device=logits.device)
    idx = torch.zeros(b, dtype=torch.int32, device=logits.device)
    sampler.sample(logits, rid, idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            sampler.sample(logits, rid, idx)
        torch.cuda.synchronize()
    us, launches = 0.0, 0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        t = t if t is not None else evt.self_cuda_time_total
        if t > 0:
            us += t
            launches += evt.count
    return us / iters / 1e3, launches / iters


def profiler_trace_check(prof_dir: str, report, paged_report):
    """The profiler hook's output: one Chrome trace in ``prof_dir`` whose
    events name B2's kernel, and the profiled serve's tokens equal to the
    unprofiled one's."""
    traces = list(pathlib.Path(prof_dir).glob("*.trace.json"))
    if len(traces) != 1:
        fail(f"[llama] the profiler hook wrote {len(traces)} traces")
    events = json.loads(traces[0].read_text())["traceEvents"]
    match = DEVICE_MATCH["paged_attention"]
    named = sum(1 for e in events if match in str(e.get("name", "")))
    if not named:
        fail(f"[llama] the profiler trace ({len(events)} events) names no "
             f"{match!r} kernel")
    same = all(_tokens_of(report, r["rid"]) == r["tokens"]
               for r in paged_report.per_request)
    if not same:
        fail("[llama] the profiled paged serve's tokens differ from the "
             "unprofiled one's")
    size = traces[0].stat().st_size
    print(f"[llama] profiler hook: {traces[0].name} ({size} bytes, "
          f"{len(events)} events, {named} named {match!r}); tokens equal "
          f"to the unprofiled paged run's", flush=True)
    return {"events": len(events), "b2_events": named, "bytes": size}


def llama_phase(torch, dev, events_dir: pathlib.Path):
    """[llama]: full-width llama3-8b (32 layers, d_model 4096, 32 q / 8 kv
    heads, head_dim 128, V 128,256; bf16, random weights from seed 0)
    with the ``SERVE`` workload. Greedy through ``paged``, ``continuous``
    and ``speculative`` under the granite gates (launches by layer count,
    no page leaked, agreement with ``reference_generate`` and of the
    speculative tokens with the paged run's under ``NEAR_TIE_GAP``); one
    paged serve again with ``obs.jax_profiler_dir`` set, whose trace must
    name B2's kernel; then sampled (``SAMPLED``) through the three
    engines and once more on ``paged``, plus a paged run at top-p
    ``SAMPLED_TOP_P``: the two paged runs identical, the other engines
    equal to paged up to near-ties of the perturbed scores
    (``sampled_agreement``), the sampler on the card against the CPU
    (``sampler_card_vs_cpu``) and its own device time a step. Then B2 and
    B3 held and timed at the phase's shapes (Hq 32, Hc 16 after the kv
    repeat, D 128) and at Hc 8, and B1 at every (B, S, Hq, Hkv, D) the
    phase's serves launched it (``record_launch_shapes``) and at B = 1
    and each prompt length."""
    from repro_torch.api import build_workload, run_serve
    from repro_torch.runtime.sampling import TokenSampler
    t_phase = time.perf_counter()
    reports, out, params, ctx = {}, {}, None, None
    b1_shapes = {}

    def recorded_run(ctx, spec, tag):
        """``family_serve_run`` with B1's launches counted by shape into
        ``b1_shapes`` (they must add up to the run's B1 launches)."""
        rec = record_launch_shapes()
        try:
            report, numbers = family_serve_run(torch, ctx, spec, tag)
        finally:
            counts = rec.stop()["flash_attention"]
        if sum(counts.values()) != numbers["launches"]["flash_attention"]:
            fail(f"[{tag}] recorded B1 shapes {counts} do not add up to "
                 f"{numbers['launches']['flash_attention']} launches")
        for shape, n in counts.items():
            b1_shapes[shape] = b1_shapes.get(shape, 0) + n
        return report, numbers

    for engine in ("paged", "continuous", "speculative"):
        spec = serve_spec(engine, events_dir, arch=LLAMA_ARCH)
        ctx, n_params = build_family_ctx(torch, dev, spec, "llama", params)
        if params is None:
            out["params"] = n_params
            out["init_peak_bytes"] = torch.cuda.max_memory_allocated()
        params = ctx.params
        reports[engine], out[engine] = recorded_run(
            ctx, spec, f"llama-{engine}")
        if engine == "paged":
            with tempfile.TemporaryDirectory() as prof_dir:
                pspec = serve_spec(engine, events_dir, arch=LLAMA_ARCH,
                                   profiler_dir=prof_dir)
                t0 = time.perf_counter()
                profiled = run_serve(pspec, ctx=ctx)
                torch.cuda.synchronize()
                out["profiled"] = profiler_trace_check(
                    prof_dir, profiled, reports[engine])
                out["profiled"]["wall_s"] = time.perf_counter() - t0
    requests = build_workload(spec, ctx.model.cfg.vocab_size)
    out["agreement"] = agreement_phase(torch, reports, ctx, requests)

    sampled = {}
    runs = (("paged", "paged", SAMPLED), ("paged-again", "paged", SAMPLED),
            ("continuous", "continuous", SAMPLED),
            ("speculative", "speculative", SAMPLED),
            ("paged-top-p", "paged", {**SAMPLED, "top_p": SAMPLED_TOP_P}))
    for name, engine, sampling in runs:
        spec = serve_spec(engine, events_dir, arch=LLAMA_ARCH,
                          sampling=sampling)
        ctx, _ = build_family_ctx(torch, dev, spec, "llama", params)
        sampled[name], out[f"sampled_{name}"] = recorded_run(
            ctx, spec, f"llama-sampled-{name}")
        if name == "paged":
            paged_ctx = ctx
    if any(_tokens_of(sampled["paged-again"], r.rid)
           != _tokens_of(sampled["paged"], r.rid) for r in requests):
        fail("[llama] two sampled paged runs of one spec differ")
    print("[llama] sampled paged twice: identical tokens", flush=True)
    out["sampled_agreement"] = sampled_agreement(
        torch, {k: sampled[k] for k in ("paged", "continuous",
                                        "speculative")},
        paged_ctx, requests, "llama")
    differ = sum(_tokens_of(sampled["paged-top-p"], r.rid)
                 != _tokens_of(sampled["paged"], r.rid) for r in requests)
    print(f"[llama] top-p {SAMPLED_TOP_P}: {differ} of {len(requests)} "
          f"requests differ from the top-k-only run (printed)", flush=True)
    logits = decode_logits(torch, paged_ctx, requests)
    rids = [r.rid for r in requests[:8]]
    sampler = paged_ctx.engine.sampler
    out["sampler_check"] = sampler_card_vs_cpu(torch, sampler, logits, rids)
    ms, calls = sampler_device_ms(torch, sampler, logits, rids)
    greedy_ms, greedy_calls = sampler_device_ms(torch, TokenSampler(),
                                                logits, rids)
    out["sampler_device_ms"] = ms
    out["sampler_launches"] = calls
    out["argmax_device_ms"] = greedy_ms
    step_g = out["paged"]["decode_step_ms_mean"]
    step_s = out["sampled_paged"]["decode_step_ms_mean"]
    print(f"[llama] paged mean decode step greedy {step_g:.2f} ms, sampled "
          f"{step_s:.2f} ms; the sampler's own device time {ms:.4f} ms a "
          f"step ({calls:.0f} kernels and copies, B={logits.shape[0]}, V "
          f"{logits.shape[1]}; greedy argmax {greedy_ms:.4f} ms, "
          f"{greedy_calls:.0f}); acceptance greedy "
          f"{out['speculative']['acceptance']:.4f}, sampled "
          f"{out['sampled_speculative']['acceptance']:.4f}", flush=True)
    del ctx, paged_ctx, params
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = {"flash_attention": [], "paged_attention": [],
             "spec_verify": []}
    print(f"[llama] B1 launches by (B, S, Hq, Hkv, D): "
          f"{dict(sorted(b1_shapes.items()))}", flush=True)
    b1 = dict(b1_shapes)
    for (_, _, hq, hkv, d) in b1_shapes:     # one prompt alone
        for plen in SERVE["prompt_lens"]:
            b1.setdefault((1, plen, hq, hkv, d), 0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    for shape, n in sorted(b1.items()):
        cases["flash_attention"].append({
            "launches": n, **serve_attention_case(torch, rn, *shape)})
    for hc in (16, 8):
        cases["paged_attention"].append(paged_kernel_case(
            torch, paged_case(torch, dev, gen, hq=32, hc=hc, d=128)))
        cases["spec_verify"].append(verify_window_case(
            torch, dev, gen, hq=32, hc=hc, d=128)[0])
    out["kernel_cases"] = cases
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[llama] phase {out['seconds']:.1f} s", flush=True)
    return out


def ssm_phase(torch, dev, events_dir: pathlib.Path):
    """Full-width falcon-mamba-7b through ``continuous``: launches, state
    bytes, agreement at a near-tie limit in bf16 ulps of the top logit.
    Returns the run's launch counts."""
    import math
    from repro_torch.api import build_serve_context, build_workload
    from repro_torch.runtime.kvcache import tree_nbytes

    spec = serve_spec("continuous", events_dir, arch=SSM_ARCH)
    gc.collect()                 # granite's engine holds a reference cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = build_serve_context(spec, device=dev)
    torch.cuda.synchronize()
    cfg = ctx.model.cfg
    n_params = sum(t.numel() for t in _leaves(ctx.params))
    pool = ctx.engine.pool
    per_slot = tree_nbytes(pool.buffers) / pool.num_slots
    elt = torch.finfo(cfg.torch_dtype).bits // 8     # conv state's dtype
    reckoned = cfg.num_layers * ((cfg.ssm_conv - 1) * cfg.d_inner * elt
                                 + cfg.d_inner * cfg.ssm_state * 4)
    print(f"[ssm] built {cfg.name} in {time.perf_counter() - t0:.2f}s: "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, N {cfg.ssm_state}, dt_rank {cfg.dt_rank}, V "
          f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params; init peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; state "
          f"{per_slot / 1e6:.2f} MB a slot (reckoned {reckoned / 1e6:.2f}) "
          f"x {pool.num_slots} slots", flush=True)
    if per_slot != reckoned:
        fail(f"[ssm] state bytes a slot {per_slot}, reckoned {reckoned}")
    torch.cuda.reset_peak_memory_stats()
    shapes = record_launch_shapes()
    try:
        report, launches, prefills = serve_run(torch, ctx, spec, "ssm")
    finally:
        shapes = shapes.stop()["selective_scan"]
    peak = torch.cuda.max_memory_allocated()
    print(f"[ssm] B4 launches by (B, L, D, N): {shapes}", flush=True)
    if sum(shapes.values()) != launches["selective_scan"]:
        fail(f"[ssm] recorded B4 shapes {shapes} do not add up to "
             f"{launches['selective_scan']} launches")
    want = {"selective_scan": cfg.num_layers * prefills,
            "selective_scan_bwd": 0, "selective_scan_heads": 0,
            "flash_attention": 0, "paged_attention": 0, "spec_verify": 0}
    got = {k: launches[k] for k in want}
    if got != want or prefills < 1:
        fail(f"[ssm] launches {got}, wanted {want} (64 B4 a prefill)")
    ttft = report.to_json()["ttft_ms"]
    print(f"[ssm] TTFT p50/p95 {ttft['p50']:.1f}/{ttft['p95']:.1f} "
          f"ms; decode {report.decode_tok_per_s:.1f} tok/s; serving peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)

    def limit(top):
        e = math.floor(math.log2(max(abs(top), 2.0 ** -126)))
        return NEAR_TIE_ULPS * 2.0 ** (e - 7)
    requests = build_workload(spec, cfg.vocab_size)
    agreement_phase(torch, {"ssm": report}, ctx, requests, limit=limit)
    return launches, shapes


def hybrid_build(torch, dev, spec, tag: str):
    """Build full-width zamba2 from ``spec`` (random weights, seed 0) and
    check its state and shared-attention KV bytes a slot against their
    reckoning. Returns (ctx, numbers)."""
    from repro_torch.runtime.kvcache import tree_nbytes
    ctx, n_params = build_family_ctx(torch, dev, spec, tag)
    init_peak = torch.cuda.max_memory_allocated()
    model, cfg, pool = ctx.model, ctx.model.cfg, ctx.engine.pool
    per_slot = tree_nbytes(pool.buffers) / pool.num_slots
    elt = torch.finfo(cfg.torch_dtype).bits // 8
    nh = cfg.ssm_num_heads
    reckoned = (cfg.num_layers * ((cfg.ssm_conv - 1)
                                  * (cfg.d_inner + 2 * cfg.ssm_state) * elt
                                  + cfg.d_inner * cfg.ssm_state * 4)
                + model.n_super * 2 * pool.slot_len
                * model.blocks.kv_cache_heads() * cfg.head_dim * elt)
    print(f"[{tag}] {cfg.num_layers} Mamba-2 layers (cut {cfg.cut_layer}, "
          f"{model.n_pre} pre-blocks, {model.n_super} superblocks of "
          f"{cfg.attn_period}), d_inner {cfg.d_inner}, N {cfg.ssm_state}, "
          f"{nh} heads of {cfg.d_inner // nh}; param_count "
          f"{cfg.param_count()}; state and shared-attention KV "
          f"{per_slot / 1e6:.2f} MB a slot (reckoned {reckoned / 1e6:.2f}) "
          f"x {pool.num_slots} slots of {pool.slot_len}", flush=True)
    if per_slot != reckoned:
        fail(f"[{tag}] state bytes a slot {per_slot}, reckoned {reckoned}")
    return ctx, {"dtype": cfg.dtype, "params": n_params,
                 "init_peak_bytes": init_peak,
                 "state_bytes_per_slot": per_slot}


def hybrid_serve(torch, ctx, spec, tag: str):
    """Serve ``ctx``'s zamba2 through ``continuous`` (events to
    ``<tag>.jsonl`` beside ``spec``'s) with the launch counts set to 0
    just before and read just after: B1 once a shared attention
    application (``n_super`` a prefill call), the per-head B4 once a
    Mamba-2 layer (``num_layers`` a prefill call), nothing else (B4
    itself never). Returns (report, numbers, each kernel's launches by
    shape, ``record_launch_shapes``)."""
    spec = spec.replace(obs=spec.obs.replace(events_path=str(
        pathlib.Path(spec.obs.events_path).with_name(f"{tag}.jsonl"))))
    model, cfg = ctx.model, ctx.model.cfg
    torch.cuda.reset_peak_memory_stats()
    shapes = record_launch_shapes()
    try:
        report, launches, prefills = serve_run(torch, ctx, spec, tag)
    finally:
        shapes = shapes.stop()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want["flash_attention"] = model.n_super * prefills
    want["selective_scan_heads"] = cfg.num_layers * prefills
    if launches != want or prefills < 1 or report.steps < 1:
        fail(f"[{tag}] launches {launches}, wanted {want} "
             f"({model.n_super} B1 and {cfg.num_layers} B4 per head a "
             f"prefill call)")
    for name, counts in shapes.items():
        if sum(counts.values()) != launches[name]:
            fail(f"[{tag}] recorded {name} shapes {counts} do not add up "
                 f"to {launches[name]} launches")
    times = phase_times(spec.obs.events_path)
    ttft = report.to_json()["ttft_ms"]
    out = {"ttft_ms_p50": ttft["p50"], "ttft_ms_p95": ttft["p95"],
           "decode_tok_per_s": report.decode_tok_per_s,
           "admit_ms_mean": times["admit"][0],
           "decode_step_ms_mean": times["decode_step"][0],
           "steps": report.steps, "prefill_calls": prefills,
           "peak_memory_bytes": peak, "launches": launches,
           "launch_shapes": {name: {"x".join(map(str, k)): v
                                    for k, v in sorted(counts.items())}
                             for name, counts in shapes.items()}}
    print(f"[{tag}] B4 per head launches by (B, L, D, N): "
          f"{shapes['selective_scan_heads']}; B1 by (B, S, Hq, Hkv, D): "
          f"{shapes['flash_attention']}; TTFT p50/p95 "
          f"{ttft['p50']:.1f}/{ttft['p95']:.1f} ms; decode "
          f"{report.decode_tok_per_s:.1f} tok/s; mean admit "
          f"{times['admit'][0]:.2f} ms, mean decode step "
          f"{times['decode_step'][0]:.2f} ms; serving peak "
          f"{peak / 2**30:.2f} GiB; launches as wanted ({model.n_super} B1 "
          f"and {cfg.num_layers} B4 per head a prefill call)", flush=True)
    return report, out, shapes


def plain_agreement(torch, ctx, spec, report, requests, tag: str):
    """Serve ``requests`` again through ``ctx`` with every kernel replaced
    by its plain version (``plain_kernels``; the same batches, so every
    product but the kernels' sums in the same order), recording that
    run's top-2 gaps (``record_gaps``), and print ``report``'s first
    differences from it with those gaps (``agreement_phase``, not
    gated)."""
    spec = spec.replace(obs=spec.obs.replace(events_path=str(
        pathlib.Path(spec.obs.events_path).with_name(f"{tag}-plain.jsonl"))))
    gaps = record_gaps(ctx.engine)
    try:
        with plain_kernels(torch):
            plain, launches, _ = serve_run(torch, ctx, spec, f"{tag}-plain")
    finally:
        steps = gaps.stop()
    if any(launches.values()):
        fail(f"[{tag}-plain] launched a kernel: {launches}")

    def plain_run(req):
        toks = _tokens_of(plain, req.rid)
        rows = [steps[(req.rid, i)] for i in range(len(toks))]
        return toks, [g for g, _ in rows], [t for _, t in rows]
    return agreement_phase(torch, {tag: report}, ctx, requests,
                           reference=plain_run, gate=False)


def hybrid_decode_profile(torch, ctx, requests):
    """One batched decode step of the pool's 8 slots (each request's last
    prompt token at its prompt length) under torch.profiler, with every
    Mamba-2 mixer call and every shared-attention decode in a named
    range: device ms by ``HYBRID_DECODE_GROUPS``, wall, idle share."""
    from torch.profiler import record_function
    blocks = ctx.model.blocks
    mixer, attn = blocks._mixer, blocks.attn_decode

    def ranged_mixer(*args, **kw):
        with record_function("mamba2_apply"):
            return mixer(*args, **kw)

    def ranged_attn(*args, **kw):
        with record_function("shared_attention"):
            return attn(*args, **kw)
    dev = ctx.params["client"]["embed"].device
    rows = requests[:ctx.engine.pool.num_slots]
    tok = torch.tensor([[int(r.prompt[-1])] for r in rows], device=dev)
    pos = torch.tensor([len(r.prompt) for r in rows], device=dev)
    blocks._mixer, blocks.attn_decode = ranged_mixer, ranged_attn
    try:
        return profile_groups(
            torch, lambda: ctx.model.decode_step(
                ctx.params, ctx.engine.pool.buffers, tok, pos),
            HYBRID_DECODE_GROUPS,
            f"[hybrid] one decode step (B={len(rows)})")
    finally:
        blocks._mixer = mixer
        del blocks.attn_decode


def batch_variance(torch, ctx, requests, tag: str):
    """Batch 4 against batch 1: four of the requests' 32-token prompts
    prefilled together and the first alone. Returns and prints the
    relative difference of its residual row after the first and the last
    Mamba-2 block, its last logits' largest difference, and how many of
    32 rows of one out_proj product (a superblock layer's weight, random
    rows) differ between a 128-row and a 32-row product."""
    import numpy as np
    model, params = ctx.model, ctx.params
    dev = params["client"]["embed"].device
    prompts = [r.prompt for r in requests if len(r.prompt) == 32][:4]
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    rows = []
    prefill_block = model.blocks.ssm_block_prefill

    def recording(p, x):
        x, st = prefill_block(p, x)
        rows.append(x[0].float())
        return x, st
    model.blocks.ssm_block_prefill = recording
    try:
        with torch.no_grad():
            batched = model.prefill(params, {"tokens": toks})[0][0]
            n = len(rows)
            alone = model.prefill(params, {"tokens": toks[:1]})[0][0]
    finally:
        del model.blocks.ssm_block_prefill
    rel = [float((rows[i] - rows[n + i]).abs().max()
                 / rows[n + i].abs().max()) for i in (0, n - 1)]
    w = params["server"]["superblocks"]["mixer"]["out_proj"][0, 0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    a = torch.randn((128, w.shape[0]), generator=gen, device=dev).to(w.dtype)
    with torch.no_grad():
        gemm_rows = int((a @ w)[:32].ne(a[:32] @ w).any(dim=-1).sum())
    out = {"first_block_rel": rel[0], "last_block_rel": rel[1],
           "logits_max_abs": float((batched - alone).abs().max()),
           "out_proj_rows_differ": gemm_rows}
    print(f"[{tag}] batch 4 against batch 1 (four 32-token prompts): "
          f"residual row differs by {rel[0]:.3g} (relative) after block 1,"
          f" {rel[1]:.3g} after block {n}; last logits by "
          f"{out['logits_max_abs']:.4g}; out_proj product "
          f"{tuple(w.shape)}: {gemm_rows} of 32 rows differ at 128 rows "
          f"against 32", flush=True)
    return out


class record_gaps:
    """The top-2 logit gap and the top logit of each token ``engine``
    samples until ``stop``, by request and token index, by wrapping its
    sampler (greedy: the argmax of the logits it is given)."""

    def __init__(self, engine):
        self.sampler, self.sample = engine.sampler, engine.sampler.sample
        self.steps = {}

        def recording(logits, rids, idxs):
            top2 = logits.float().topk(2, dim=-1).values
            for rid, idx, gap, top in zip(
                    rids.tolist(), idxs.tolist(),
                    (top2[:, 0] - top2[:, 1]).tolist(), top2[:, 0].tolist()):
                self.steps[(rid, idx)] = (gap, top)
            return self.sample(logits, rids, idxs)
        self.sampler.sample = recording

    def stop(self):
        del self.sampler.sample
        return self.steps


def hybrid_phase(torch, dev, events_dir: pathlib.Path):
    """[hybrid]: full-width zamba2-2.7b served through ``continuous`` with
    the 8 requests, each serve gated on its launches and shapes
    (``hybrid_serve``). In bf16 at the model's own init (the serving
    numbers), then with its weights rescaled to fan-in d_in
    (``rescale_to_fan_in`` with the specs): each serve's tokens against
    a serve of the same batches with every kernel replaced by its plain
    version (``plain_agreement``), each first difference printed with
    the plain run's top-2 gap, not gated. Then in float32, the same
    draws of seed 0 before their rounding to bf16: every request must
    equal ``reference_generate`` (batch-1 greedy decoding) or diverge at
    a near-tie (``NEAR_TIE_GAP``), gated. ``batch_variance`` is printed
    for each.

    Why the bf16 tokens are not gated: cuBLAS sums the Mamba-2 out_proj
    product (K 5120, N 2560) in another order at 32 rows (one 32-token
    prompt) than at 128 (four), so prefill rows of one prompt differ by
    a bf16 ulp between batch 1 and batch 4 from the first block on, and
    54 blocks amplify that; the kernels' own ulps against the plain
    versions (B1's bf16 P, held to them at every launched shape by
    ``family_kernel_phase``) are amplified alike, at the own init
    (a stacked leaf's fan-in is its layer count: std 0.35 where
    1/sqrt(d_in) is 0.02) and at fan-in d_in, to first differences
    at bf16 logit gaps of 0.0625 and more (``PERF.md``, Findings). In
    float32 the same differences start ~1e3 times smaller."""
    from repro_torch.api import build_workload
    t_phase = time.perf_counter()
    spec = serve_spec("continuous", events_dir, arch=HYBRID_ARCH)
    ctx, out = hybrid_build(torch, dev, spec, "hybrid")
    requests = build_workload(spec, ctx.model.cfg.vocab_size)
    report, served, shapes = hybrid_serve(torch, ctx, spec, "hybrid")
    out.update(served)
    out["agreement_with_plain"] = plain_agreement(
        torch, ctx, spec, report, requests, "hybrid")
    out["decode_profile"] = hybrid_decode_profile(torch, ctx, requests)
    out["batch_variance"] = batch_variance(torch, ctx, requests, "hybrid")
    rescale_to_fan_in(torch, ctx.params, ctx.model.param_specs())
    report, _, _ = hybrid_serve(torch, ctx, spec, "hybrid-fan-in")
    out["fan_in"] = {
        "agreement_with_plain": plain_agreement(
            torch, ctx, spec, report, requests, "hybrid-fan-in"),
        "batch_variance": batch_variance(torch, ctx, requests,
                                         "hybrid-fan-in")}
    del ctx, report
    gc.collect()
    torch.cuda.empty_cache()
    spec32 = serve_spec("continuous", events_dir, arch=HYBRID_ARCH,
                        overrides={"dtype": "float32"})
    ctx, out["fp32"] = hybrid_build(torch, dev, spec32, "hybrid-fp32")
    report, served, shapes32 = hybrid_serve(torch, ctx, spec32,
                                            "hybrid-fp32")
    out["fp32"].update(served)
    out["fp32"]["agreement"] = agreement_phase(
        torch, {"hybrid-fp32": report}, ctx, requests)
    out["fp32"]["batch_variance"] = batch_variance(torch, ctx, requests,
                                                   "hybrid-fp32")
    del ctx, report
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[hybrid] phase {out['seconds']:.1f} s", flush=True)
    return out, {"bfloat16": shapes, "float32": shapes32}


class record_launch_shapes:
    """Count the B4, per-head B4 and B1 kernels' launches by shape until
    ``stop``, by wrapping the kernel launchers that
    ``ops.selective_scan``, ``ops.selective_scan_heads`` and
    ``ops.attention`` call on a CUDA tensor (``ops.ssm_scan`` and
    ``ops.ssm_scan_heads`` by (B, L, D, N), ``ops.flash_attention`` by
    (B, S, Hq, Hkv, D)), as ``count_prefills`` wraps the prefill. B1
    launches are serving prefills: causal, unwindowed, T = S
    (``serve_attention_case``'s case); any other fails."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.scan, self.attn = ops, ops.ssm_scan, ops.flash_attention
        self.heads = ops.ssm_scan_heads
        self.counts = {"selective_scan": {}, "selective_scan_heads": {},
                       "flash_attention": {}}

        def count(name, shape):
            self.counts[name][shape] = self.counts[name].get(shape, 0) + 1

        def scan(x, dt, a, bmat, cmat):
            count("selective_scan", (*x.shape, a.shape[1]))
            return self.scan(x, dt, a, bmat, cmat)

        def heads(x, dt, a, bmat, cmat):
            count("selective_scan_heads", (*x.shape, bmat.shape[-1]))
            return self.heads(x, dt, a, bmat, cmat)

        def attn(q, k, v, *, causal=True, window=None, **kw):
            b, hq, s, d = q.shape
            if not causal or window is not None or k.shape[2] != s:
                fail(f"B1 launched at T {k.shape[2]}, S {s}, causal "
                     f"{causal}, window {window}: not a serving prefill")
            count("flash_attention", (b, s, hq, k.shape[1], d))
            return self.attn(q, k, v, causal=causal, window=window, **kw)
        ops.ssm_scan, ops.flash_attention = scan, attn
        ops.ssm_scan_heads = heads

    def stop(self):
        self.ops.ssm_scan, self.ops.flash_attention = self.scan, self.attn
        self.ops.ssm_scan_heads = self.heads
        return self.counts


def within_tol(torch, got, want, what: str, atol: float = BF16_ATOL,
               rtol: float = BF16_RTOL) -> float:
    err = (got.float() - want.float()).abs()
    ok = err <= atol + rtol * want.float().abs()
    if not bool(ok.all()):
        fail(f"{what} disagrees with its plain version: max_abs_err "
             f"{err.max().item()} (atol {atol}, rtol {rtol})")
    return err.max().item()


def rel_l2(torch, got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def xent_softmax_part(torch, dh, dw, h, w, labels, g):
    """The B5 gradients less their one-hot part, in fp32: dh + g W[:, y]^T,
    and dW with each token's g h added back into its label column (a
    label of -1, outside a vocab slice, has no one-hot part)."""
    lab = labels.long().clamp(min=0)
    g = torch.where(labels >= 0, g, torch.zeros_like(g))
    soft_dh = dh.float() + g[:, None] * w[:, lab].T.float()
    soft_dw = dw.to(torch.float32, copy=True)
    soft_dw.index_add_(1, lab, (g[:, None] * h.float()).T)
    return soft_dh, soft_dw


def xent_bwd_errors(torch, got, want, h, w, labels, g):
    """How far the B5 gradients ``got`` = (dh, dW) are from ``want``, and
    whether that is within the limits: ``whole`` is the largest abs error
    (fp32: held elementwise at GRAD_FP32_TOL; bf16: within BF16_RTOL of
    the tensor's largest entry), ``softmax_rel_l2`` the softmax part's
    relative L2 error (held at XENT_SOFT_REL_L2)."""
    whole, ok = 0.0, True
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs()
        whole = max(whole, err.max().item())
        if a.dtype == torch.float32:
            ok &= bool((err <= GRAD_FP32_TOL["atol"] + GRAD_FP32_TOL["rtol"]
                        * b.float().abs()).all())
        else:
            ok &= err.max().item() <= BF16_RTOL * b.float().abs().max().item()
    soft = max(rel_l2(torch, a, b) for a, b in zip(
        xent_softmax_part(torch, *got, h, w, labels, g),
        xent_softmax_part(torch, *want, h, w, labels, g)))
    return {"whole": whole, "softmax_rel_l2": soft,
            "ok": ok and soft <= XENT_SOFT_REL_L2}


def xent_argmax_ties(torch, correct, pcorrect, h, w, labels) -> int:
    """Tokens where the kernel's and the plain argmax-is-label verdicts
    disagree; each must be a near-tie: the label's logit within XENT_TIE
    of the row's largest."""
    idx = (correct != pcorrect).nonzero()[:, 0]
    if idx.numel():
        s = torch.matmul(h[idx].float(), w.float())
        gap = s.max(dim=1).values - s.gather(
            1, labels[idx].long()[:, None])[:, 0]
        if gap.max().item() > XENT_TIE:
            fail(f"cross_entropy argmax disagrees on {idx.numel()} tokens, "
                 f"label logit {gap.max().item()} below the row max "
                 f"(near-tie limit {XENT_TIE})")
    return int(idx.numel())


def xent_case(torch, dev, gen, dtype, timed: bool, shape=XENT_SHAPE):
    """B5 forward and backward at ``shape`` (T, d, V) in ``dtype`` against
    the plain versions and the plain forward's autograd; a backward fed a
    planted error (lse + PLANTED_LSE_SHIFT) must fail the same checks."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.cross_entropy import (cross_entropy_bwd,
                                                   cross_entropy_bwd_plain,
                                                   cross_entropy_fwd_plain)
    t, d, v = shape
    name = str(dtype).replace("torch.", "")
    h = torch.randn((t, d), generator=gen, device=dev).to(dtype)
    w = (torch.randn((d, v), generator=gen, device=dev) / d ** 0.5).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, device=dev,
                           dtype=torch.int32)
    g = torch.rand((t,), generator=gen, device=dev)

    nll, lse, correct = ops.cross_entropy(h, w, labels)
    pnll, plse, pcorrect = cross_entropy_fwd_plain(h, w, labels)
    err_f = max(within_tol(torch, nll, pnll, f"cross_entropy nll {name}",
                           **XENT_FP32_TOL),
                within_tol(torch, lse, plse, f"cross_entropy lse {name}",
                           **XENT_FP32_TOL))
    ties = xent_argmax_ties(torch, correct, pcorrect, h, w, labels)

    dh, dw = ops.cross_entropy_bwd(h, w, labels, lse, g)
    pdh, pdw = cross_entropy_bwd_plain(h, w, labels, plse, g)
    bwd = xent_bwd_errors(torch, (dh, dw), (pdh, pdw), h, w, labels, g)
    if not bwd["ok"]:
        fail(f"cross_entropy_bwd {name} disagrees with its plain version: "
             f"{bwd}")
    del dh, dw
    planted = xent_bwd_errors(
        torch, cross_entropy_bwd(h, w, labels, lse + PLANTED_LSE_SHIFT, g),
        (pdh, pdw), h, w, labels, g)
    if planted["ok"]:
        fail(f"cross_entropy_bwd {name}: a planted lse + "
             f"{PLANTED_LSE_SHIFT} passed the checks: {planted}")
    # the plain backward against autograd of the plain forward
    hr = h.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)
    auto = torch.autograd.grad(
        (cross_entropy_fwd_plain(hr, wr, labels)[0] * g).sum(), (hr, wr))
    plain_auto = xent_bwd_errors(torch, (pdh, pdw), auto, h, w, labels, g)
    if not plain_auto["ok"]:
        fail(f"cross_entropy_bwd_plain {name} disagrees with autograd: "
             f"{plain_auto}")
    del auto, hr, wr, pdh, pdw
    print(f"kernel cross_entropy {name}: nll/lse err {err_f:.3g} (atol "
          f"{XENT_FP32_TOL['atol']}, rtol {XENT_FP32_TOL['rtol']}), argmax "
          f"near-ties {ties}; bwd err {bwd['whole']:.3g}, softmax-part rel "
          f"L2 {bwd['softmax_rel_l2']:.3g} (limit {XENT_SOFT_REL_L2}); "
          f"planted lse+{PLANTED_LSE_SHIFT} caught: err "
          f"{planted['whole']:.3g}, softmax-part rel L2 "
          f"{planted['softmax_rel_l2']:.3g}", flush=True)
    fwd = {"shape": f"T={t} d={d} V={v} {name}", "max_abs_err": err_f,
           "argmax_near_ties": ties}
    bwd_case = {"shape": fwd["shape"], "max_abs_err": bwd["whole"],
                "softmax_rel_l2": bwd["softmax_rel_l2"],
                "planted_softmax_rel_l2": planted["softmax_rel_l2"]}
    if not timed:
        return fwd, bwd_case

    elt = h.element_size()
    flops = 2.0 * t * d * v
    peak = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    bnd, by = bound_ms(elt * (t * d + d * v) + 4 * t + 3 * 4 * t, flops,
                       peak)

    def library_fwd():
        return F.cross_entropy(torch.matmul(h, w).float(), labels.long(),
                               reduction="none")

    fwd.update({
        "ms": time_ms(torch, lambda: ops.cross_entropy(h, w, labels),
                      iters=5, warmup=1),
        "plain_ms": time_ms(torch, lambda: cross_entropy_fwd_plain(
            h, w, labels), iters=5, warmup=1),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(torch, library_fwd, iters=5, warmup=1)})
    add_rates(fwd, flops)
    bnd_b, by_b = bound_ms(2 * elt * (t * d + d * v) + 3 * 4 * t,
                           3 * flops, peak)
    hl = h.detach().requires_grad_(True)
    wl = w.detach().requires_grad_(True)
    lib_loss = (F.cross_entropy(torch.matmul(hl, wl).float(),
                                labels.long(), reduction="none") * g).sum()
    bwd_case.update({
        "ms": time_ms(torch, lambda: ops.cross_entropy_bwd(
            h, w, labels, lse, g), iters=5, warmup=1),
        "plain_ms": time_ms(torch, lambda: cross_entropy_bwd_plain(
            h, w, labels, plse, g), iters=5, warmup=1),
        "bound_ms": bnd_b, "bound_by": by_b,
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_loss, (hl, wl), retain_graph=True), iters=5, warmup=1)})
    add_rates(bwd_case, 3 * flops)
    for kname, c in (("cross_entropy", fwd),
                     ("cross_entropy_bwd", bwd_case)):
        print(f"kernel {kname} {c['shape']}: err {c['max_abs_err']:.3g}; "
              f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']}), library "
              f"{c['library_ms']:.4f} ms ({c['ms'] / c['library_ms']:.3f}x); "
              f"{c['tflops']:.1f} TFLOP/s, {c['bound_share']:.3f} of the "
              f"bound", flush=True)
    return fwd, bwd_case


def train_kernel_phase(torch, dev):
    """B5 fwd/bwd and B1-bwd at the training shapes, against their plain
    versions; timed beside the plain versions, bounds and yardsticks.
    B5 runs in bf16 (timed) and again in fp32, where its gradients are
    held elementwise at fp32 sums' tolerance."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b5, b5_bwd = xent_case(torch, dev, gen, torch.bfloat16, timed=True)
    b5["fp32"], b5_bwd["fp32"] = xent_case(torch, dev, gen, torch.float32,
                                           timed=False)

    b1_bwd = [attention_bwd_case(torch, dev, gen, ATTN_SHAPE["b"], s,
                                 ATTN_SHAPE["hq"], ATTN_SHAPE["hkv"],
                                 ATTN_SHAPE["d"])
              for s in ATTN_SHAPE["seqs"]]
    return b5, b5_bwd, b1_bwd


def attention_bwd_case(torch, dev, gen, b, s, hq, hkv, dd, t=None,
                       causal=True, dtype=None):
    """B1-bwd at one training shape (T keys, S by default; causal by
    default), bf16 unless ``dtype``, through ``ops.attention``'s autograd
    against the plain forward's autograd (bf16's tolerance, or
    ``FP32_ATTN_TOL`` in float32); timed (events, device by pass) beside
    the plain backward, its bound and the SDPA backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as \
        fa_kernel
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain)
    t = s if t is None else t
    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    tol = FP32_ATTN_TOL if fp32 else dict(atol=BF16_ATOL, rtol=BF16_RTOL)
    q = torch.randn((b, s, hq, dd), generator=gen, device=dev).to(
        dtype).requires_grad_(True)
    k = torch.randn((b, t, hkv, dd), generator=gen, device=dev).to(
        dtype).requires_grad_(True)
    vv = torch.randn((b, t, hkv, dd), generator=gen, device=dev).to(
        dtype).requires_grad_(True)
    do = torch.randn((b, s, hq, dd), generator=gen, device=dev).to(dtype)
    out = ops.attention(q, k, vv, causal=causal)
    if out.grad_fn is None:
        fail("ops.attention under grad returned no grad_fn")
    got = torch.autograd.grad(out, (q, k, vv), grad_outputs=do)
    ref_out = flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2),
        vv.transpose(1, 2), causal=causal).transpose(1, 2)
    want = torch.autograd.grad(ref_out, (q, k, vv), grad_outputs=do)
    torch.cuda.synchronize()
    name = str(dtype).replace("torch.", "")
    shape = attn_shape(b, s, t, hq, hkv, dd, causal)
    err = max(within_tol(torch, a, bb, f"flash_attention_bwd {shape} "
                         f"{name}", **tol)
              for a, bb in zip(got, want))
    qd, kd, vd, od = (x.detach() for x in (q, k, vv, out))
    lse_b1 = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    fa_kernel(qd.transpose(1, 2), kd.transpose(1, 2),
              vd.transpose(1, 2), causal=causal, lse=lse_b1)  # uncounted
    elt = q.element_size()
    nbytes = (elt * (4 * b * s * hq * dd + 4 * b * t * hkv * dd)
              + 4 * b * hq * s)
    flops = 10.0 * b * hq * dd * attn_pairs(s, t, causal)
    bnd, by = bound_ms(nbytes, flops, FP32_FLOPS if fp32 else BF16_FLOPS)
    qt, kt, vt, ot, dot = (x.transpose(1, 2) for x in (qd, kd, vd, od,
                                                       do))
    sd_q, sd_k, sd_v = (x.detach().transpose(1, 2).requires_grad_(True)
                        for x in (q, k, vv))
    sd_out = F.scaled_dot_product_attention(sd_q, sd_k, sd_v,
                                            is_causal=causal,
                                            enable_gqa=True)
    def kernel_bwd():
        return ops.attention_bwd(qd, kd, vd, od, do, lse_b1, causal=causal)

    def sdpa_bwd():
        return torch.autograd.grad(sd_out, (sd_q, sd_k, sd_v),
                                   grad_outputs=dot, retain_graph=True)
    case = {
        "shape": shape if dtype == torch.bfloat16 else f"{shape} {name}",
        "max_abs_err": err,
        "ms": time_ms(torch, kernel_bwd),
        "plain_ms": time_ms(torch, lambda: flash_attention_bwd_plain(
            qt, kt, vt, ot, dot, lse_b1, causal=causal)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(torch, sdpa_bwd),
        # device time: the port's two passes, and every kernel of
        # the SDPA backward call
        "device_ms": device_ms(torch, kernel_bwd, "flash_bwd"),
        "device_ms_by_pass": {
            name: device_ms(torch, kernel_bwd, f"flash_bwd_{name}")
            for name in ("dq", "dkdv")},
        "library_device_ms": device_ms(torch, sdpa_bwd, ""),
    }
    add_rates(case, flops)
    case["device_bound_share"] = bnd / case["device_ms"]
    print(f"kernel flash_attention_bwd {case['shape']}: err "
          f"{err:.3g} (atol {tol['atol']}, rtol {tol['rtol']}); "
          f"{case['ms']:.4f} ms (device {case['device_ms']:.4f}: "
          f"{json.dumps(case['device_ms_by_pass'])}), plain "
          f"{case['plain_ms']:.4f} ms, bound {bnd:.5f} ms ({by}), sdpa "
          f"bwd {case['library_ms']:.4f} ms (device "
          f"{case['library_device_ms']:.4f}; kernel/sdpa device "
          f"{case['device_ms'] / case['library_device_ms']:.3f}x); "
          f"{case['tflops']:.1f} TFLOP/s, {case['bound_share']:.3f} of "
          f"the bound ({case['device_bound_share']:.3f} by device "
          f"time)", flush=True)
    return case


def train_spec(events_path: str):
    from repro_torch import api
    from repro_torch.launch.train import default_lm_spec
    spec = default_lm_spec()
    return api.apply_overrides(spec, [
        f"execution.max_steps={TRAIN_STEPS}", "obs.enabled=true",
        "obs.monitor=false", f"obs.events_path={events_path}"])


def span_means(events_path: str):
    spans = {}
    for line in pathlib.Path(events_path).read_text().splitlines():
        row = json.loads(line)
        if row.get("kind") == "span":
            spans.setdefault(row["name"], []).append(row["dur_s"] * 1e3)
    return spans


def train_phase(torch, dev, events_dir: pathlib.Path):
    """Full-width PSL training through repro_torch.api.run."""
    import math
    import statistics
    from repro_torch import api
    from repro_torch.kernels import ops

    events = str(events_dir / "train.jsonl")
    spec = train_spec(events)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = api.build_context(spec, device=dev)
    print(f"[train] built in {time.perf_counter() - t0:.2f}s: "
          f"{ctx.model.cfg.name} {ctx.model.cfg.num_layers} layers "
          f"d_model {ctx.model.cfg.d_model}, {ctx.data.pop.num_clients} "
          f"clients, D0 {ctx.data.pop.total_size}, global batch "
          f"{spec.protocol.global_batch_size} x {spec.data.seq_len}",
          flush=True)
    ops.reset_launches()
    result = api.run(spec, ctx=ctx)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    steps = len(result.step_metrics)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in _leaves(result.params))
    spans = span_means(events)
    step_ms = spans["device_step"]
    for i, m in enumerate(result.step_metrics):
        print(f"[train] step {i}: loss {m['loss']:.4f} accuracy "
              f"{m['accuracy']:.4f} tokens {m['tokens']:.0f} grad_norm "
              f"{m['grad_norm']:.4f} step {step_ms[i]:.1f} ms", flush=True)
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"train step {i} is not finite: {m}")
    if steps != TRAIN_STEPS:
        fail(f"train ran {steps} steps, wanted {TRAIN_STEPS}")
    layers = ctx.model.cfg.num_layers
    want = {"flash_attention": layers * steps,
            "flash_attention_bwd": layers * steps,
            "cross_entropy": steps, "cross_entropy_bwd": steps,
            "paged_attention": 0, "spec_verify": 0, "selective_scan": 0,
            "selective_scan_bwd": 0, "selective_scan_heads": 0,
            "selective_scan_heads_bwd": 0, "cross_entropy_partials": 0}
    if launches != want:
        fail(f"train launches {launches}, wanted {want}")
    median = statistics.median(step_ms[1:])
    tokens = result.step_metrics[-1]["tokens"]
    summary = {
        "params": n_params, "steps": steps,
        "first_step_ms": step_ms[0], "median_step_ms_after_first": median,
        "tokens_per_step": tokens, "tokens_per_s": tokens / median * 1e3,
        "peak_memory_bytes": peak,
        "span_means_ms": {k: sum(v) / len(v) for k, v in spans.items()},
        "losses": [m["loss"] for m in result.step_metrics],
        "launches": launches}
    print(f"[train] {n_params / 1e9:.3f} B params; first step "
          f"{step_ms[0]:.1f} ms, median after it {median:.1f} ms, "
          f"{summary['tokens_per_s']:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; span means (ms) "
          f"{json.dumps(summary['span_means_ms'])}; launches {launches}",
          flush=True)
    summary["profile"] = profile_step(torch, ctx, result.state)
    return summary


# kernel-name groups of the profiled step, first match wins
_GROUPS = (("B5 cross_entropy fwd", ("xent_fwd", "xent_combine")),
           ("B5 cross_entropy_bwd", ("xent_", "gemm_kernel")),
           ("B1-bwd flash_attention_bwd", ("flash_bwd",)),
           ("B1 flash_attention", ("flash_fwd",)),
           ("cuBLAS matmul", ("gemm", "sm90", "cutlass", "xmma", "nvjet")),
           ("other (elementwise, norms, AdamW, copies)", ("",)))


def _device_kernels(prof):
    """Device ms by kernel name from a finished torch.profiler run."""
    kernels = {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
    return kernels


def profile_step(torch, ctx, pstate):
    """One more training step under torch.profiler: device time by kernel
    group, the busiest kernels, and the device's idle share of the step's
    wall time (profiler overhead included in that wall time)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api.protocols import lm_plan_batches
    from repro_torch.core.sampling import make_plan
    spec = ctx.spec
    engine, state = pstate["engine"], pstate["state"]
    plan = make_plan("ugs", ctx.data.pop, spec.protocol.global_batch_size,
                     seed=spec.seed)
    host = next(iter(lm_plan_batches(
        ctx.data.lm_data, ctx.data.pop, plan, spec.data.seq_len,
        spec.protocol.aggregation,
        np.zeros(len(ctx.data.lm_data), np.int64))))
    batch = engine.put_batch(host)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step(state, batch)            # ends by reading the metrics
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    groups = {name: 0.0 for name, _ in _GROUPS}
    for key, ms in kernels.items():
        name = next(n for n, pats in _GROUPS
                    if any(p in key for p in pats))
        groups[name] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
           "groups_ms": groups, "top_kernels_ms": top}
    print(f"[profile] one step: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms (idle share {out['idle_share']:.3f}); by group "
          f"{json.dumps({k: round(v, 2) for k, v in groups.items()})}",
          flush=True)
    for key, ms in top:
        print(f"[profile]   {ms:9.3f} ms  {key[:110]}", flush=True)
    if busy <= 0:
        print("[profile] the profiler recorded no device time", flush=True)
    return out


def rescale_to_fan_in(torch, params, specs=None) -> None:
    """Multiply every stacked per-layer matrix (L, d_in, d_out), and every
    stack of expert matrices (L, E, d_in, d_out), by sqrt(L / d_in), in
    place: the std of fan-in d_in instead of the
    stack's layer count L, which is what the model's init takes as the
    fan-in of a stacked leaf (as repro's does). At 4 layers that init
    gives weights of std 0.5, attention scores near 5,000 and softmaxes
    that are near-argmaxes, where the gradient is not defined to better
    than ~80%: the plain path's own gradients move by a median per-leaf
    relative L2 of 0.70 when its fp32 scores are computed exactly (fp64,
    then rounded) and of 0.80 in TF32 (tools/grad_conditioning.py), so
    there only score sums bitwise equal to the plain version's fp32
    product could agree. Rescaled, the scores are O(1). With ``specs``
    (the model's ``param_specs()``) only the normal-init leaves are
    rescaled: the hybrid's double-stacked (n_super, attn_period, ...)
    a_log, D and norm weights have 3 axes and are not matrices; the
    factors come from the specs' shapes, so a rank's blocks of a sharded
    state are rescaled as the whole leaves are."""
    import math
    from repro_torch.models.layers import tree_leaves
    leaves = tree_leaves(params)
    kinds = ([("normal", x.shape) for x in leaves] if specs is None
             else [(sp.init, sp.shape) for sp in tree_leaves(specs)])
    with torch.no_grad():
        for leaf, (init, shape) in zip(leaves, kinds, strict=True):
            if init == "normal" and len(shape) >= 3:
                leaf.mul_(math.sqrt(shape[0] / shape[-2]))


def grad_check_setup(torch, dev, rescale: bool = True, arch=None,
                     layers: int = 4, dtype=None):
    """The gradient check's model, state and batch: full width at
    ``layers`` layers (cut 2) of granite-3-2b or ``arch`` (in ``dtype``
    if given), one UGS plan batch, the normal-init weights rescaled to
    fan-in d_in unless ``rescale`` is false. Returns (ctx, state,
    batch)."""
    import numpy as np
    from repro_torch import api
    from repro_torch.api.protocols import lm_plan_batches
    from repro_torch.core.sampling import make_plan
    from repro_torch.launch.distributed import ShardedPSLEngine
    from repro_torch.launch.train import default_lm_spec

    spec = api.apply_overrides(default_lm_spec(), [
        f"model.overrides.num_layers={layers}",
        "model.overrides.cut_layer=2"]
        + ([f"model.arch={arch}"] if arch else [])
        + ([f"model.overrides.dtype={dtype}"] if dtype else []))
    ctx = api.build_context(spec, device=dev)
    plan = make_plan("ugs", ctx.data.pop, spec.protocol.global_batch_size,
                     seed=spec.seed)
    host = next(iter(lm_plan_batches(
        ctx.data.lm_data, ctx.data.pop, plan, spec.data.seq_len,
        spec.protocol.aggregation, np.zeros(len(ctx.data.lm_data),
                                            np.int64))))
    engine = ShardedPSLEngine(ctx.model, ctx.optimizer, device=dev)
    state = engine.init_state(spec.seed)
    if rescale:
        rescale_to_fan_in(torch, state.params, ctx.model.param_specs())
    return ctx, state, engine.put_batch(host)


@contextlib.contextmanager
def plain_kernels(torch, which=("attention", "cross_entropy",
                                "selective_scan"),
                  attention_formulas: bool = False):
    """Inside: ``ops.attention``, ``ops.cross_entropy`` and
    ``ops.selective_scan`` with ``ops.selective_scan_heads`` (or those of
    them named in ``which``; "selective_scan" names both scans) are
    their plain versions (autograd through plain PyTorch: ``ssm_scan_plain``
    and ``ssm_scan_heads_plain``, whose one exp(dt a) a head gives dt and
    a their gradients per head), for a reference run. Under grad each
    plain scan is checkpointed: its states
    are recomputed in the backward, one call at a time, so autograd
    holds one layer's (B, L, D, N) states at a time. With
    ``attention_formulas`` the plain attention's backward is B1-bwd's
    formulas in plain PyTorch (``flash_attention_bwd_plain``: P from the
    forward's lse, delta = rowsum(dO * out) of the rounded out) instead
    of autograd's."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import cross_entropy as xent
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain)
    from repro_torch.kernels.ssm_scan import (ssm_scan_heads_plain,
                                              ssm_scan_plain)

    def plain_attention(q, k, v, *, causal=True, window=None):
        return flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)

    class FormulaAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out, lse = flash_attention_plain(qt, kt, vt, causal=causal,
                                             window=window, with_lse=True)
            ctx.save_for_backward(qt, kt, vt, out, lse)
            ctx.causal, ctx.window = causal, window
            return out.transpose(1, 2)

        @staticmethod
        def backward(ctx, dout):
            qt, kt, vt, out, lse = ctx.saved_tensors
            grads = flash_attention_bwd_plain(
                qt, kt, vt, out, dout.transpose(1, 2), lse,
                causal=ctx.causal, window=ctx.window)
            return (*(g.transpose(1, 2) for g in grads), None, None)

    def checkpointed(fn):
        def run(*args):
            if torch.is_grad_enabled():
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)
        return run
    plain_scan = checkpointed(ssm_scan_plain)
    plain_scan_heads = checkpointed(ssm_scan_heads_plain)

    plain = {"attention": plain_attention,
             "cross_entropy": lambda h, w, labels:
                 xent.cross_entropy_fwd_plain(h, w, labels.to(torch.int32)),
             "selective_scan": plain_scan,
             "selective_scan_heads": plain_scan_heads}
    if attention_formulas:
        plain["attention"] = (lambda q, k, v, *, causal=True, window=None:
                              FormulaAttention.apply(q, k, v, causal,
                                                     window))
    which = tuple(which) + (("selective_scan_heads",)
                            if "selective_scan" in which else ())
    kernels = {name: getattr(ops, name) for name in which}
    for name in which:
        setattr(ops, name, plain[name])
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(ops, name, fn)


def leaf_rel_l2(got, want):
    """Relative L2 error of each leaf of ``got`` against ``want``, by
    dotted leaf name."""
    from repro_torch.models.layers import tree_leaves
    return {name: ((a.float() - b.float()).norm()
                   / b.float().norm().clamp_min(1e-30)).item()
            for name, a, b in zip(_leaf_names(got), tree_leaves(got),
                                  tree_leaves(want))}


def grad_agreement_phase(torch, dev):
    """Kernel-path gradients against the plain path's, full width at 4
    layers rescaled to fan-in d_in (``rescale_to_fan_in``), and a planted
    fault in the attention backward that must fail the same limit; then
    the loss on one fixed batch falls over 5 AdamW steps."""
    from repro_torch.core.psl import make_train_step, value_and_grad
    from repro_torch.kernels import ops
    from repro_torch.optim import TrainState

    ctx, state, batch = grad_check_setup(torch, dev)
    ops.reset_launches()
    (loss, _), grads = value_and_grad(ctx.model.loss_fn, state.params,
                                      batch)
    if min(ops.launch_counts()[k] for k in (
            "flash_attention", "flash_attention_bwd", "cross_entropy",
            "cross_entropy_bwd")) < 1:
        fail(f"kernel-path gradients skipped a kernel: "
             f"{ops.launch_counts()}")

    with plain_kernels(torch):
        (ref_loss, _), ref_grads = value_and_grad(ctx.model.loss_fn,
                                                  state.params, batch)

    def leaf_errors(got):
        return leaf_rel_l2(got, ref_grads)

    rels = leaf_errors(grads)
    worst_leaf = max(rels, key=rels.get)
    worst = rels[worst_leaf]
    print(f"[grads] 4-layer full width (fan-in d_in): loss kernel "
          f"{float(loss):.5f} vs plain {float(ref_loss):.5f}; worst "
          f"per-leaf relative L2 error {worst:.3g} ({worst_leaf}) over "
          f"{len(rels)} leaves (limit {GRAD_REL_L2}); median "
          f"{sorted(rels.values())[len(rels) // 2]:.3g}", flush=True)
    if not worst <= GRAD_REL_L2:
        fail(f"kernel-path gradients disagree: relative L2 {worst}")
    kernel_bwd = ops.flash_attention_bwd

    def planted_bwd(q, k, v, out, dout, lse, **kw):
        return kernel_bwd(q, k, v, out, dout, lse + PLANTED_ATTN_LSE_SHIFT,
                          **kw)
    ops.flash_attention_bwd = planted_bwd
    try:
        _, planted = value_and_grad(ctx.model.loss_fn, state.params, batch)
    finally:
        ops.flash_attention_bwd = kernel_bwd
    planted_worst = max(leaf_errors(planted).values())
    print(f"[grads] planted attention-backward lse + "
          f"{PLANTED_ATTN_LSE_SHIFT} caught: worst per-leaf relative L2 "
          f"{planted_worst:.3g}", flush=True)
    if planted_worst <= GRAD_REL_L2:
        fail(f"a planted lse + {PLANTED_ATTN_LSE_SHIFT} in the attention "
             f"backward passed the gradient check: {planted_worst}")
    del grads, ref_grads, planted

    step = make_train_step(ctx.model, ctx.optimizer)
    losses = []
    st = TrainState(state.params, state.opt_state, 0)
    for _ in range(5):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    (final, _), _ = value_and_grad(ctx.model.loss_fn, st.params, batch)
    losses.append(float(final))
    print(f"[grads] fixed-batch losses over 5 AdamW steps: {losses}",
          flush=True)
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"the fixed-batch loss did not fall at every step: {losses}")
    return {"worst_rel_l2": worst, "worst_leaf": worst_leaf,
            "rel_l2_by_leaf": rels, "planted_worst_rel_l2": planted_worst,
            "fixed_batch_losses": losses}


# ---------------------------------------------------------------------------
# The MoE and VLM families: granite-moe-3b-a800m and internvl2-2b
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def moe_hooks(torch):
    """Inside: every ``moe_apply`` call runs in a profiler range named
    ``moe_apply`` (its router, dispatch and experts), its experts
    (``expert_ffn``: the fp32 copies of the gate and up weights and the
    three products) in one named ``expert_ffn``, and each ``moe_route``
    call's keep mask (one bool an assignment; no device work, no sync)
    is appended to the yielded list."""
    from torch.profiler import record_function
    from repro_torch.models import layers as L
    saved = L.moe_apply, L.expert_ffn, L.moe_route
    apply, experts, route = saved
    keeps = []

    def ranged(p, x, cfg, **hooks):
        with record_function("moe_apply"):
            return apply(p, x, cfg, **hooks)

    def ranged_experts(p, buf, dtype):
        with record_function("expert_ffn"):
            return experts(p, buf, dtype)

    def counted(p, xt, cfg, groups=1):
        out = route(p, xt, cfg, groups)
        keeps.append(out[3])
        return out
    L.moe_apply, L.expert_ffn, L.moe_route = ranged, ranged_experts, counted
    try:
        yield keeps
    finally:
        L.moe_apply, L.expert_ffn, L.moe_route = saved


def grouped_device_ms(prof, groups):
    """Device ms by group from a finished torch.profiler run: each kernel
    goes to the first group whose test accepts (kernel name, names of the
    op it is attached to and of that op's ancestors). A kernel attached
    to no op (this repo's, launched through ctypes outside an autograd
    Function) is tested by its name alone; the ranges' own device-side
    annotations (named like their CPU ranges) are not kernels and are
    left out. Expert products are the model's only batched matmuls
    (``aten::bmm``, in their backward too); the attention and
    cross-entropy kernels are named."""
    out = {label: 0.0 for label, _ in groups}
    attributed, cpu_names = {}, set()

    def add(name, names, ms):
        label = next(lb for lb, test in groups if test(name, names))
        out[label] += ms
    for evt in prof.events():
        if str(evt.device_type).endswith("CUDA"):
            continue
        cpu_names.add(evt.name)
        if not evt.kernels:
            continue
        names, e = [], evt
        while e is not None:
            names.append(e.name)
            e = e.cpu_parent
        for kern in evt.kernels:
            add(kern.name, names, kern.duration / 1e3)
            attributed[kern.name] = attributed.get(kern.name, 0.0) \
                + kern.duration / 1e3
    for name, ms in _device_kernels(prof).items():
        rest = ms - attributed.get(name, 0.0)
        if name not in cpu_names and rest > 1e-6:
            add(name, [], rest)
    return out


def _launched_in(*ops):
    return lambda kern, names: any(n in ops for n in names)


def _kernel_named(*pats):
    return lambda kern, names: any(p in kern for p in pats)


HYBRID_DECODE_GROUPS = (
    ("Mamba-2 projections (in_proj, out_proj)",
     lambda kern, names: "mamba2_apply" in names
     and any(n in ("aten::mm", "aten::addmm", "aten::bmm") for n in names)),
    ("Mamba-2 conv, state update, gate and norm",
     _launched_in("mamba2_apply")),
    ("shared attention (q/k/v, cache write, decode attention)",
     _launched_in("shared_attention")),
    ("other (block norms, residuals, wo, LM head, embedding)",
     lambda kern, names: True))


MOE_DECODE_GROUPS = (
    ("attention (B2 paged_attention)", _kernel_named("paged_fwd")),
    ("experts (fp32 weight copies and matmuls)",
     _launched_in("expert_ffn", "aten::bmm")),
    ("router and dispatch", _launched_in("moe_apply")),
    ("other (projections, norms, LM head, embedding)",
     lambda kern, names: True))

MOE_TRAIN_GROUPS = (
    ("B5 cross_entropy fwd", _kernel_named("xent_fwd", "xent_combine")),
    ("B5 cross_entropy_bwd", _kernel_named("xent_", "gemm_kernel")),
    ("B1-bwd flash_attention_bwd", _kernel_named("flash_bwd")),
    ("B1 flash_attention", _kernel_named("flash_fwd")),
    ("experts (fwd: fp32 weight copies and matmuls; bwd: matmuls)",
     _launched_in("expert_ffn", "aten::bmm")),
    ("AdamW", _launched_in("adamw")),
    ("router and dispatch fwd (softmax, sort, cumsum, index_add, gather)",
     _launched_in("moe_apply")),
    ("dispatch scatter/gather bwd (index_add, index; embedding's too)",
     _launched_in("IndexAddBackward0", "IndexBackward0")),
    ("cuBLAS matmul (projections)",
     _kernel_named("gemm", "sm90", "cutlass", "xmma", "nvjet")),
    ("other (elementwise, norms, copies)", lambda kern, names: True))


def profile_groups(torch, fn, groups, tag: str):
    """One call of ``fn`` under torch.profiler inside ``moe_hooks``:
    device ms by group, wall ms and the device's idle share; printed."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with moe_hooks(torch), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups_ms = grouped_device_ms(prof, groups)
    busy = sum(groups_ms.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
           "groups_ms": groups_ms}
    print(f"{tag} profile: wall {wall_ms:.2f} ms, device busy {busy:.2f} "
          f"ms (idle share {out['idle_share']:.3f}); by group "
          f"{json.dumps({k: round(v, 3) for k, v in groups_ms.items()})}",
          flush=True)
    if busy <= 0:
        print(f"{tag} the profiler recorded no device time", flush=True)
    return out


def paged_rows(torch, pool, tokens, positions):
    """A (B, M) page table over ``pool``'s pages (rows dealt distinct
    pages while they last) and the decode inputs for B rows at the given
    positions: (tokens (B, 1), pos (B,) int32, table (B, M) int32)."""
    dev = pool.buffers["client"]["k"].device
    b, m = len(tokens), pool.max_pages_per_slot
    table = (torch.arange(b * m, device=dev) % pool.num_pages).reshape(
        b, m).to(torch.int32)
    return (torch.tensor(tokens, device=dev)[:, None],
            torch.tensor(positions, dtype=torch.int32, device=dev), table)


def moe_drops_at(torch, ctx, factor: float, tokens, positions):
    """One batched paged decode step of ``ctx``'s model rebuilt at
    capacity factor ``factor`` (same weights): (assignments, dropped)
    over every layer, counted by ``moe_hooks``."""
    import dataclasses
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(ctx.model.cfg,
                                            moe_capacity_factor=factor))
    tok, pos, table = paged_rows(torch, ctx.engine.pool, tokens, positions)
    with moe_hooks(torch) as keeps:
        model.decode_step_paged(ctx.params, ctx.engine.pool.buffers, tok,
                                pos, table)
    return (sum(k.numel() for k in keeps),
            sum(int((~k).sum()) for k in keeps))


def family_serve_run(torch, ctx, spec, tag: str):
    """``serve_run`` of a full-width family phase, with its peak memory,
    TTFT, tok/s, phase means, peak KV bytes and the launch counts it must
    show: B1 num_layers times a prefill call, B2 num_layers times a
    decode step on the paged engine (none on the continuous one), nothing
    else; on the speculative engine ``spec_checks``' counts and no page
    leaked."""
    torch.cuda.reset_peak_memory_stats()
    report, launches, prefills = serve_run(torch, ctx, spec, tag)
    peak = torch.cuda.max_memory_allocated()
    layers = ctx.model.cfg.num_layers
    engine = spec.engine.name
    if engine == "speculative":
        spec_checks(ctx, report, launches, prefills, tag)
        wanted = (f"{layers} B3 a verify step, {SPEC_DRAFT_LAYERS} B2 a "
                  f"draft step, {layers} B1 a prefill call")
    else:
        want = {name: 0 for name in launches}
        want["flash_attention"] = layers * prefills
        if engine == "paged":
            want["paged_attention"] = layers * report.steps
        wanted = f"{layers} B1 a prefill call" + (
            f", {layers} B2 a decode step" if engine == "paged" else "")
        if launches != want or prefills < 1 or report.steps < 1:
            fail(f"[{tag}] launches {launches}, wanted {want} ({wanted})")
    times = phase_times(spec.obs.events_path)
    ttft = report.to_json()["ttft_ms"]
    out = {"ttft_ms_p50": ttft["p50"], "ttft_ms_p95": ttft["p95"],
           "decode_tok_per_s": report.decode_tok_per_s,
           "admit_ms_mean": times["admit"][0],
           "decode_step_ms_mean": times["decode_step"][0],
           "steps": report.steps, "prefill_calls": prefills,
           "peak_memory_bytes": peak,
           "peak_kv_bytes": report.cache_utilization["peak_in_use_bytes"],
           "launches": launches}
    if report.speculation is not None:
        out["acceptance"] = report.speculation["acceptance_rate"]
    print(f"[{tag}] TTFT p50/p95 {ttft['p50']:.1f}/{ttft['p95']:.1f} ms; "
          f"decode {report.decode_tok_per_s:.1f} tok/s; mean admit "
          f"{times['admit'][0]:.2f} ms, mean decode step "
          f"{times['decode_step'][0]:.2f} ms; serving peak memory "
          f"{peak / 2**30:.2f} GiB; peak KV bytes {out['peak_kv_bytes']}; "
          f"launches as wanted ({wanted})", flush=True)
    return report, out


def build_family_ctx(torch, dev, spec, tag: str, params=None):
    from repro_torch.api import build_serve_context
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ctx = build_serve_context(spec, params=params, device=dev)
    torch.cuda.synchronize()
    cfg = ctx.model.cfg
    n = sum(t.numel() for t in _leaves(ctx.params))
    print(f"[{tag}] built {cfg.name} in {time.perf_counter() - t0:.2f}s: "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads}"
          f" q / {cfg.num_kv_heads} kv heads, head_dim {cfg.head_dim}, V "
          f"{cfg.vocab_size}, kv cache heads "
          f"{ctx.model.blocks.kv_cache_heads()}"
          + (f", {cfg.num_experts} experts top-{cfg.experts_per_token}, "
             f"d_ff_expert {cfg.d_ff_expert}, capacity factor "
             f"{cfg.moe_capacity_factor}" if cfg.is_moe else "")
          + f", {cfg.dtype}; {n / 1e9:.3f} B params; init peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return ctx, n


def moe_phase(torch, dev, events_dir: pathlib.Path):
    """[moe]: full-width granite-moe-3b-a800m (random weights, seed 0)
    served through ``paged`` (B1, B2), ``continuous`` (B1) and
    ``speculative`` (B3 under the MoE target, B2 in the draft, B1) at
    capacity factor ``MOE_SERVE_FACTOR``; one decode step profiled by
    group; agreement with ``reference_generate`` and of the speculative
    tokens with the paged run's under the granite near-tie rule; the
    speculative engine again sampled (``SAMPLED``: its launches and
    pages gated); one batched decode step at the config's own factor
    1.25, its dropped assignments printed (not gated)."""
    import dataclasses
    from repro_torch.api import build_workload
    from repro_torch.configs import get_config
    from repro_torch.models.layers import moe_capacity
    t_phase = time.perf_counter()
    over = {"moe_capacity_factor": MOE_SERVE_FACTOR}
    reports, out, params, ctx = {}, {}, None, None
    for engine in ("paged", "continuous", "speculative"):
        spec = serve_spec(engine, events_dir, arch=MOE_ARCH, overrides=over)
        ctx, n_params = build_family_ctx(torch, dev, spec, "moe", params)
        params = ctx.params
        reports[engine], out[engine] = family_serve_run(
            torch, ctx, spec, f"moe-{engine}")
        if engine == "paged":
            requests = build_workload(spec, ctx.model.cfg.vocab_size)
            rows = ([int(r.prompt[-1]) for r in requests[:8]],
                    [len(r.prompt) for r in requests[:8]])
            tok, pos, table = paged_rows(torch, ctx.engine.pool, *rows)
            step = lambda: ctx.model.decode_step_paged(    # noqa: E731
                ctx.params, ctx.engine.pool.buffers, tok, pos, table)
            out["decode_profile"] = profile_groups(
                torch, step, MOE_DECODE_GROUPS, "[moe] one paged decode step "
                f"(B={len(tok)})")
            cfg = ctx.model.cfg
            factor = get_config(MOE_ARCH).moe_capacity_factor
            total, dropped = moe_drops_at(torch, ctx, factor, *rows)
            cap = moe_capacity(len(tok), dataclasses.replace(
                cfg, moe_capacity_factor=factor))
            out["dropped_at_config_factor"] = {
                "factor": factor, "assignments": total, "dropped": dropped,
                "capacity": cap}
            print(f"[moe] one batched decode step at the config's capacity "
                  f"factor {factor} ({len(tok)} rows x "
                  f"{cfg.experts_per_token} experts x {cfg.num_layers} "
                  f"layers = {total} assignments, capacity {cap} an expert "
                  f"a layer): {dropped} dropped (printed, not gated: "
                  f"repro's documented batch coupling)", flush=True)
    agreement_phase(torch, reports, ctx, requests)
    spec = serve_spec("speculative", events_dir, arch=MOE_ARCH,
                      overrides=over, sampling=SAMPLED)
    ctx, _ = build_family_ctx(torch, dev, spec, "moe", params)
    _, out["speculative_sampled"] = family_serve_run(
        torch, ctx, spec, "moe-speculative-sampled")
    out["params"] = n_params
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[moe] phase {out['seconds']:.1f} s", flush=True)
    return out


def moe_train_phase(torch, dev, events_dir: pathlib.Path):
    """[moe-train]: full-width granite-moe-3b-a800m, depth cut to
    ``MOE_TRAIN_LAYERS`` (cut 2), PSL-UGS through ``api.run`` at the
    config's capacity factor 1.25: per-step loss, aux_loss, accuracy and
    step ms; launches; peak memory; a profiled step by group; then the
    loss on one fixed batch must fall at each of 3 AdamW steps (weights
    rescaled to fan-in d_in, as in [grads])."""
    import math
    from repro_torch import api
    from repro_torch.api.protocols import lm_plan_batches
    from repro_torch.core.psl import make_train_step, value_and_grad
    from repro_torch.core.sampling import make_plan
    from repro_torch.kernels import ops
    from repro_torch.launch.distributed import ShardedPSLEngine
    from repro_torch.launch.train import default_lm_spec
    from repro_torch.optim import Optimizer
    import numpy as np
    from torch.profiler import record_function

    t_phase = time.perf_counter()
    events = str(events_dir / "moe-train.jsonl")
    spec = api.apply_overrides(default_lm_spec(), [
        f"model.arch={MOE_ARCH}",
        f"model.overrides.num_layers={MOE_TRAIN_LAYERS}",
        "model.overrides.cut_layer=2",
        f"execution.max_steps={MOE_TRAIN_STEPS}", "obs.enabled=true",
        "obs.monitor=false", f"obs.events_path={events}"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ctx = api.build_context(spec, device=dev)
    cfg = ctx.model.cfg
    print(f"[moe-train] {cfg.name} reduced to {cfg.num_layers} of 32 "
          f"layers (cut {cfg.cut_layer}), full width d_model "
          f"{cfg.d_model}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, capacity factor "
          f"{cfg.moe_capacity_factor}; {ctx.data.pop.num_clients} clients, "
          f"{len(ctx.data.lm_data)} client shards, global batch "
          f"{spec.protocol.global_batch_size} x {spec.data.seq_len}, "
          f"{spec.sampler.method}, {spec.optimizer.name}", flush=True)
    ops.reset_launches()
    result = api.run(spec, ctx=ctx)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = span_means(events)["device_step"]
    steps = len(result.step_metrics)
    for i, m in enumerate(result.step_metrics):
        print(f"[moe-train] step {i}: loss {m['loss']:.4f} aux_loss "
              f"{m['aux_loss']:.6f} accuracy {m['accuracy']:.4f} tokens "
              f"{m['tokens']:.0f} grad_norm {m['grad_norm']:.3f} step "
              f"{step_ms[i]:.1f} ms", flush=True)
        if not all(math.isfinite(m[k]) for k in ("loss", "aux_loss",
                                                  "grad_norm")):
            fail(f"[moe-train] step {i} is not finite: {m}")
        if not m["aux_loss"] > 0:
            fail(f"[moe-train] step {i}: aux_loss {m['aux_loss']} <= 0")
    layers = cfg.num_layers
    want = {name: 0 for name in launches}
    want.update({"flash_attention": layers * steps,
                 "flash_attention_bwd": layers * steps,
                 "cross_entropy": steps, "cross_entropy_bwd": steps})
    if steps != MOE_TRAIN_STEPS or launches != want:
        fail(f"[moe-train] {steps} steps, launches {launches}, wanted "
             f"{want} ({layers} B1 + {layers} B1-bwd + 1 B5 + 1 B5-bwd a "
             f"step)")
    n_params = sum(p.numel() for p in _leaves(result.params))
    run_metrics = [{k: m[k] for k in ("loss", "aux_loss", "accuracy",
                                      "grad_norm")}
                   for m in result.step_metrics]
    print(f"[moe-train] {n_params / 1e9:.3f} B params; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)

    # one more step, profiled by group, with AdamW in its own range
    pstate = result.state
    engine = pstate["engine"]
    opt = ctx.optimizer

    def ranged_updates(params, grads, state):
        with record_function("adamw"):
            return opt.apply_updates(params, grads, state)
    engine._step = make_train_step(ctx.model, Optimizer(
        init=opt.init, apply_updates=ranged_updates))
    plan = make_plan("ugs", ctx.data.pop, spec.protocol.global_batch_size,
                     seed=spec.seed)
    host = next(iter(lm_plan_batches(
        ctx.data.lm_data, ctx.data.pop, plan, spec.data.seq_len,
        spec.protocol.aggregation, np.zeros(len(ctx.data.lm_data),
                                            np.int64))))
    batch = engine.put_batch(host)
    state = pstate["state"]
    profile = profile_groups(torch, lambda: engine.step(state, batch),
                             MOE_TRAIN_GROUPS, "[moe-train] one step")
    del result, pstate, engine, state

    # fixed-batch descent from a fan-in-rescaled init
    gc.collect()
    torch.cuda.empty_cache()
    eng = ShardedPSLEngine(ctx.model, ctx.optimizer, device=dev)
    st = eng.init_state(spec.seed)
    rescale_to_fan_in(torch, st.params)
    losses = []
    for _ in range(3):
        st, m = eng.step(st, batch)
        losses.append(m["loss"])
    (final, _), _ = value_and_grad(ctx.model.loss_fn, st.params, batch)
    losses.append(float(final))
    print(f"[moe-train] fixed-batch losses over 3 AdamW steps (fan-in "
          f"d_in init): {losses}", flush=True)
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"[moe-train] the fixed-batch loss did not fall at every "
             f"step: {losses}")
    seconds = time.perf_counter() - t_phase
    print(f"[moe-train] phase {seconds:.1f} s", flush=True)
    return {"params": n_params, "steps": steps, "step_ms": step_ms,
            "metrics": run_metrics, "peak_memory_bytes": peak,
            "launches": launches, "profile": profile,
            "fixed_batch_losses": losses, "seconds": seconds}


def vlm_phase(torch, dev, events_dir: pathlib.Path):
    """[vlm]: full-width internvl2-2b (random weights, seed 0) served
    through ``paged`` (B1 and B2 at head_dim 128) and held to
    ``reference_generate`` under the granite near-tie rule; then one loss
    and backward with patches at ``VLM_GRAD_SHAPE`` through the kernels
    (B1 at S = 384, B1-bwd, B5 and B5-bwd at d 2048, V 92,553) against
    the plain path: per-leaf relative L2 <= ``GRAD_REL_L2`` (weights
    rescaled to fan-in d_in), loss within ``VLM_LOSS_RTOL``."""
    import dataclasses
    from repro_torch.api import build_workload
    from repro_torch.configs import get_config
    from repro_torch.core.psl import requires_grad_, value_and_grad
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    spec = serve_spec("paged", events_dir, arch=VLM_ARCH)
    ctx, n_params = build_family_ctx(torch, dev, spec, "vlm")
    report, out = family_serve_run(torch, ctx, spec, "vlm-paged")
    requests = build_workload(spec, ctx.model.cfg.vocab_size)
    agreement_phase(torch, {"vlm-paged": report}, ctx, requests)
    out["params"] = n_params
    del ctx, report
    gc.collect()
    torch.cuda.empty_cache()

    g = VLM_GRAD_SHAPE
    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=g["layers"],
                              cut_layer=2)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = requires_grad_(model.init(gen))
    rescale_to_fan_in(torch, params)
    b, s, p = g["batch"], g["seq"], cfg.num_patches
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :s], "labels": toks[:, 1:].to(torch.int32),
             "weights": torch.ones((b, s), device=dev),
             "patches": (g["patch_scale"] * torch.randn(
                 (b, p, cfg.d_model), generator=gen, device=dev)).to(
                     cfg.torch_dtype)}
    ops.reset_launches()
    (loss, metrics), grads = value_and_grad(model.loss_fn, params, batch)
    launches = ops.launch_counts()
    want = {name: 0 for name in launches}
    want.update({"flash_attention": cfg.num_layers,
                 "flash_attention_bwd": cfg.num_layers,
                 "cross_entropy": 1, "cross_entropy_bwd": 1})
    if launches != want:
        fail(f"[vlm] patched loss launches {launches}, wanted {want}")
    with plain_kernels(torch):
        (ref_loss, _), ref_grads = value_and_grad(model.loss_fn, params,
                                                  batch)
    rels = leaf_rel_l2(grads, ref_grads)
    worst_leaf = max(rels, key=rels.get)
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    print(f"[vlm] patched loss ({b} x ({p} patches + {s} tokens), "
          f"{cfg.num_layers} layers full width, fan-in d_in): kernel "
          f"{float(loss):.5f} vs plain {float(ref_loss):.5f} (rel "
          f"{loss_rel:.3g}, limit {VLM_LOSS_RTOL}); tokens "
          f"{float(metrics['tokens']):.0f}; worst per-leaf relative L2 "
          f"{rels[worst_leaf]:.3g} ({worst_leaf}) over {len(rels)} leaves "
          f"(limit {GRAD_REL_L2}); launches {launches}", flush=True)
    if not loss_rel <= VLM_LOSS_RTOL:
        fail(f"[vlm] patched loss disagrees: {loss_rel}")
    if not rels[worst_leaf] <= GRAD_REL_L2:
        fail(f"[vlm] patched gradients disagree: {rels[worst_leaf]}")
    if float(metrics["tokens"]) != b * s:
        fail(f"[vlm] the patch columns carried weight: {metrics}")
    out.update({"patched_loss": float(loss),
                "patched_plain_loss": float(ref_loss),
                "patched_worst_rel_l2": rels[worst_leaf],
                "patched_worst_leaf": worst_leaf,
                "patched_launches": launches})
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[vlm] phase {out['seconds']:.1f} s", flush=True)
    return out


def family_kernel_phase(torch, dev, hybrid_shapes):
    """B1, B2, B1-bwd, B5 and B5-bwd held to their plain versions and
    timed at the shapes the [moe] and [vlm] phases launch them: serving
    prefill (B = 1, S = 100) and paged decode (the paged run's geometry)
    of granite-moe (Hq 24, Hkv = Hc 8, D 64) and internvl2-2b (Hq 16,
    Hkv 8, Hc 16, D 128); training attention forward and backward of
    [moe-train] (B 16, S 128) and of [vlm]'s patched loss (B 4, S 384);
    the cross-entropy of [moe-train] (T 2048, d 1536, V 49,155) and of
    [vlm] (T 1536, d 2048, V 92,553). Then [hybrid]'s: B1 and the
    per-head B4 (64 channels a head) at every shape each [hybrid] run
    launched them, in its dtype (``hybrid_shapes``: by dtype name, each
    kernel's launches by shape), and in bf16 also at B = 1 and each
    prompt length. B1 is held at bf16's tolerance or ``FP32_ATTN_TOL``,
    the per-head B4 as ``timed_heads_case`` holds it. Returns the cases
    by kernel."""
    from repro_torch.configs import get_config
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    moe, vlm = dict(hq=24, hkv=8, d=64), dict(hq=16, hkv=8, d=128)
    cases = {"flash_attention": [], "flash_attention_bwd": [],
             "paged_attention": [], "cross_entropy": [],
             "cross_entropy_bwd": []}
    for tag, geo, hc, train in (("moe", moe, 8, (16, 128)),
                                ("vlm", vlm, 16, (4, 384))):
        b1 = serve_attention_case(torch, rn, 1, 100, **geo)
        b2 = paged_kernel_case(torch, paged_case(
            torch, dev, gen, hq=geo["hq"], hc=hc, d=geo["d"]))
        b1t = attention_train_case(torch, dev, gen, rn, b=train[0],
                                   s=train[1], **geo)
        b1b = attention_bwd_case(torch, dev, gen, *train, geo["hq"],
                                 geo["hkv"], geo["d"])
        for name, case in (("flash_attention", b1), ("flash_attention",
                                                     b1t),
                           ("paged_attention", b2),
                           ("flash_attention_bwd", b1b)):
            cases[name].append({"phase": tag, **case})
    for tag, shape in (("moe-train", (2048, 1536, 49155)),
                       ("vlm", (1536, 2048, 92553))):
        fwd, bwd = xent_case(torch, dev, gen, torch.bfloat16, timed=True,
                             shape=shape)
        cases["cross_entropy"].append({"phase": tag, **fwd})
        cases["cross_entropy_bwd"].append({"phase": tag, **bwd})
    hcfg = get_config(HYBRID_ARCH)
    cases["selective_scan_heads"] = []
    for name, shapes in hybrid_shapes.items():
        dtype = getattr(torch, name)
        tol = (dict(atol=BF16_ATOL, rtol=BF16_RTOL) if name == "bfloat16"
               else FP32_ATTN_TOL)
        b1 = dict(shapes["flash_attention"])
        b4 = dict(shapes["selective_scan_heads"])
        if name == "bfloat16":    # the prefill shapes of one prompt alone
            for plen in SERVE["prompt_lens"]:
                b1.setdefault((1, plen, hcfg.num_heads, hcfg.num_kv_heads,
                               hcfg.head_dim), 0)
                b4.setdefault((1, plen, hcfg.d_inner, hcfg.ssm_state), 0)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        for shape, n in sorted(b1.items()):
            cases["flash_attention"].append({
                "phase": "hybrid", "launches": n,
                **serve_attention_case(torch, rnd, *shape, tol=tol)})
        for shape, n in sorted(b4.items()):
            args = heads_case(torch, dev, gen, *shape, hd=hcfg.ssm_head_dim,
                              dtype=dtype)
            cases["selective_scan_heads"].append({
                "phase": "hybrid", **timed_heads_case(
                    torch, args, shape, hcfg.ssm_head_dim, n,
                    f"the [hybrid] {name} run")})
            del args
    return cases


# ---------------------------------------------------------------------------
# The static engine (granite-3-2b) and the audio family (whisper-tiny)
# ---------------------------------------------------------------------------

AUDIO_ARCH = "whisper-tiny"
# [audio-grads]: whisper-tiny CONFIG (bf16, and again in float32), 8 rows
# of 1500 random frames before 128 tokens, the weights rescaled to fan-in
# d_in (``rescale_to_fan_in``), then AUDIO_STEPS AdamW steps at
# ``SSM_FIXED_BATCH_LR`` on that batch. float32 gradients are held at
# AUDIO_GRAD_FP32_REL_L2 (fp32 sums in another order through 8 layers).
AUDIO_GRADS = dict(batch=8, seq=128, steps=3)
AUDIO_GRAD_FP32_REL_L2 = 1e-4
AUDIO_DECODE_GROUPS = (
    ("B1 flash_attention (cross-attention at S = 1)",
     _kernel_named("flash_fwd")),
    ("cuBLAS matmul (projections, LM head)",
     _kernel_named("gemm", "sm90", "cutlass", "xmma", "nvjet")),
    ("other (self-attention decode, norms, GELU, cache writes)",
     lambda kern, names: True))


class record_kernel_shapes:
    """Count B1 and B1-bwd launches by (dtype, B, S, T, Hq, Hkv, D,
    causal) and B5 and B5-bwd launches by (dtype, T, d, V) until
    ``stop``, by wrapping the launchers that ``ops``' wrappers call on a
    CUDA tensor (as ``record_train_shapes`` does). A windowed B1 or
    B1-bwd launch fails: the static and audio paths run none."""

    NAMES = {"flash_attention": "flash_attention",
             "flash_attention_bwd": "flash_attention_bwd"}

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.xent = ops, ops.xent
        self.saved = {n: getattr(ops, a) for n, a in self.NAMES.items()}
        self.saved_xent = (ops.xent.cross_entropy_fwd,
                           ops.xent.cross_entropy_bwd)
        self.counts = {n: {} for n in ("flash_attention",
                                       "flash_attention_bwd",
                                       "cross_entropy", "cross_entropy_bwd")}

        def dtype_name(t):
            return str(t.dtype).replace("torch.", "")

        def counted(name, shape_of, fn):
            def launch(*args, **kw):
                shape = shape_of(*args, **kw)
                self.counts[name][shape] = self.counts[name].get(shape,
                                                                 0) + 1
                return fn(*args, **kw)
            return launch

        def attn_key(q, k, *args, causal=True, window=None, **kw):
            if window is not None:
                fail(f"a windowed B1 launch (window {window}) on the "
                     f"static or audio path")
            b, hq, s, d = q.shape
            return (dtype_name(q), b, s, k.shape[2], hq, k.shape[1], d,
                    bool(causal))

        def xent_key(hidden, w, *args, **kw):
            return (dtype_name(hidden), *hidden.shape, w.shape[1])

        for name, attr in self.NAMES.items():
            setattr(ops, attr, counted(name, attn_key, self.saved[name]))
        ops.xent.cross_entropy_fwd = counted(
            "cross_entropy", xent_key, self.saved_xent[0])
        ops.xent.cross_entropy_bwd = counted(
            "cross_entropy_bwd", xent_key, self.saved_xent[1])

    def stop(self):
        for name, attr in self.NAMES.items():
            setattr(self.ops, attr, self.saved[name])
        (self.xent.cross_entropy_fwd,
         self.xent.cross_entropy_bwd) = self.saved_xent
        return self.counts


def merge_shapes(into, counts):
    for name, by_shape in counts.items():
        for shape, n in by_shape.items():
            into.setdefault(name, {})
            into[name][shape] = into[name].get(shape, 0) + n
    return into


@contextlib.contextmanager
def static_hooks(torch, model, frames=None):
    """Inside: ``model``'s prefill and decode steps record each row's
    top-2 logit gap and top logit (the yielded list: one (gaps, tops) a
    call, rows in the static batch's order), and with ``frames`` (audio)
    the prefill reads them in place of the zero frames the static engine
    feeds."""
    calls = []
    prefill, decode = model.prefill, model.decode_step

    def note(logits):
        top2 = logits.reshape(logits.shape[0], -1).float().topk(
            2, dim=-1).values
        calls.append(((top2[:, 0] - top2[:, 1]).tolist(),
                      top2[:, 0].tolist()))

    def recording_prefill(params, batch, **kw):
        if frames is not None:
            batch = dict(batch, frames=frames[:batch["tokens"].shape[0]])
        out = prefill(params, batch, **kw)
        note(out[0])
        return out

    def recording_decode(*args, **kw):
        out = decode(*args, **kw)
        note(out[0])
        return out
    model.prefill, model.decode_step = recording_prefill, recording_decode
    try:
        yield calls
    finally:
        del model.prefill, model.decode_step


def static_serve(torch, ctx, spec, tag: str, requests, frames=None,
                 want=None, entry: bool = False):
    """One static serve of ``requests`` through ``ctx``'s engine (with
    ``entry``, through ``run_serve(spec)``, whose workload ``requests``
    must be, in its order) with the
    launch counts set to 0 just before and read just after, every B1 and
    B5 launch counted by shape (``record_kernel_shapes``) and each row's
    top-2 gaps recorded (``static_hooks``). ``want``: the exact launches
    by shape the run must show (B1's, or none), nothing else launched.
    Prints the report, the shared TTFT, decode tok/s, the mean decode
    step and the static KV bytes. Returns (report, numbers, shapes,
    reference): ``reference(req)`` is (tokens, gaps, tops) of that row,
    for ``agreement_phase``."""
    from repro_torch.api import run_serve
    from repro_torch.kernels import ops
    spec = spec.replace(obs=spec.obs.replace(events_path=str(
        pathlib.Path(spec.obs.events_path).with_name(f"{tag}.jsonl"))))
    torch.cuda.reset_peak_memory_stats()
    shapes = record_kernel_shapes()
    try:
        with static_hooks(torch, ctx.model, frames) as calls:
            ops.reset_launches()
            report = (run_serve(spec, ctx=ctx) if entry
                      else ctx.engine.serve(requests, spec))
            torch.cuda.synchronize()
            launches = ops.launch_counts()
    finally:
        shapes = shapes.stop()
    peak = torch.cuda.max_memory_allocated()
    b1 = shapes["flash_attention"]
    if want is not None:
        others = {k: v for k, v in launches.items()
                  if k != "flash_attention" and v}
        if b1 != want or others \
                or launches["flash_attention"] != sum(want.values()):
            fail(f"[{tag}] B1 launches by (dtype, B, S, T, Hq, Hkv, D, "
                 f"causal) {b1}, wanted {want}; other launches {others}")
    j = report.to_json()
    ttft = j["ttft_ms"]["p50"]
    step_ms = ((report.wall_s * 1e3 - ttft) / report.steps
               if report.steps else 0.0)
    util = report.cache_utilization
    out = {"ttft_ms": ttft, "decode_tok_per_s": report.decode_tok_per_s,
           "decode_step_ms_mean": step_ms, "wall_s": report.wall_s,
           "steps": report.steps, "prefill_tokens": report.prefill_tokens,
           "decode_tokens": report.decode_tokens,
           "kv_bytes": util["capacity_bytes"],
           "used_tokens": util["used_tokens"],
           "allocated_tokens": util["allocated_tokens"],
           "peak_memory_bytes": peak, "launches": launches,
           "b1_launch_shapes": {"x".join(map(str, k)): v
                                for k, v in sorted(b1.items())}}
    print(f"[{tag}] {report.summary()}; shared TTFT {ttft:.2f} ms, decode "
          f"{report.decode_tok_per_s:.1f} tok/s, mean decode step "
          f"{step_ms:.2f} ms over {report.steps}, prefill_tokens "
          f"{report.prefill_tokens} (padded), decode_tokens "
          f"{report.decode_tokens}; static KV bytes {util['capacity_bytes']}"
          f" ({util['used_tokens']} of {util['allocated_tokens']} token "
          f"rows used); peak {peak / 2**30:.2f} GiB; launches {launches}; "
          f"B1 by (dtype, B, S, T, Hq, Hkv, D, causal) {b1}", flush=True)
    rows = {r.rid: i for i, r in enumerate(requests)}

    def reference(req):
        i = rows[req.rid]
        return (_tokens_of(report, req.rid), [g[i] for g, _ in calls],
                [t[i] for _, t in calls])
    return report, out, shapes, reference


def static_phase(torch, dev, ctx, continuous, requests,
                 events_dir: pathlib.Path):
    """[static]: full-width granite-3-2b (``ctx``'s weights) through the
    static engine. The 8 [serve] requests in batches of equal prompt
    length (no padding, where repro holds static token-identical to
    continuous): 40 B1 a prefill and nothing else, each request's tokens
    against the ``continuous`` run's (``continuous``) under the near-tie
    rule, the gap read along the continuous tokens (``forced_gaps``).
    Then the 8 requests as one mixed-length batch through ``run_serve``:
    its ServeReport, padded prefill tokens and KV bytes against their
    reckoning."""
    from repro_torch.api import build_serve_context
    t_phase = time.perf_counter()
    spec = serve_spec("static", events_dir)
    sctx = build_serve_context(spec, params=ctx.params, device=dev)
    cfg = sctx.model.cfg
    by_len = {}
    for req in requests:
        by_len.setdefault(len(req.prompt), []).append(req)
    out, exact = {"groups": {}}, 0
    for plen, group in sorted(by_len.items()):
        want = {("bfloat16", len(group), plen, plen, cfg.num_heads,
                 cfg.num_kv_heads, cfg.head_dim, True): cfg.num_layers}
        report, nums, _, _ = static_serve(torch, sctx, spec,
                                          f"static-{plen}", group, want=want)
        out["groups"][plen] = nums
        for req in group:
            got, ref = _tokens_of(report, req.rid), \
                _tokens_of(continuous, req.rid)
            if got == ref:
                exact += 1
                continue
            i = next(j for j in range(len(ref)) if got[j] != ref[j])
            gap = forced_gaps(torch, ctx, req.prompt, ref)[i]
            if gap >= NEAR_TIE_GAP:
                fail(f"[static] request {req.rid} differs from continuous "
                     f"at token {i} where the top-2 gap is {gap:.4f}")
            print(f"[static] request {req.rid}: differs from continuous at "
                  f"token {i}, a near-tie (gap {gap:.4f})", flush=True)
    print(f"[static] against continuous at equal prompt lengths: {exact} of "
          f"{len(requests)} token-identical, the rest near-ties", flush=True)
    plen = max(len(r.prompt) for r in requests)
    want = {("bfloat16", len(requests), plen, plen, cfg.num_heads,
             cfg.num_kv_heads, cfg.head_dim, True): cfg.num_layers}
    report, nums, _, _ = static_serve(torch, sctx, spec, "static-mixed",
                                      requests, want=want, entry=True)
    max_new = max(r.max_new_tokens for r in requests)
    kv = (2 * cfg.num_layers * len(requests) * (plen + max_new)
          * sctx.model.blocks.kv_cache_heads() * cfg.head_dim * 2)
    if nums["kv_bytes"] != kv or report.prefill_tokens != \
            len(requests) * plen or not report.ttft_shared:
        fail(f"[static] mixed batch: KV bytes {nums['kv_bytes']} "
             f"(reckoned {kv}), prefill_tokens {report.prefill_tokens}, "
             f"ttft_shared {report.ttft_shared}")
    out.update({"exact_vs_continuous": exact, "mixed": nums,
                "seconds": time.perf_counter() - t_phase})
    keys = ("engine", "wall_s", "num_requests", "prefill_tokens",
            "decode_tokens", "steps", "ttft_ms", "ttft_shared",
            "decode_tok_per_s", "cache_utilization")
    j = report.to_json()
    print(f"[static] mixed batch ServeReport "
          f"{json.dumps({k: j[k] for k in keys})}", flush=True)
    print(f"[static] phase {out['seconds']:.1f} s", flush=True)
    return out


def audio_serve_want(cfg, b, plen, steps, dtype):
    """The B1 launches a static whisper serve implies: per prefill the
    encoder's ``encoder_layers`` non-causal at (B, 1500, 1500), the
    decoder's ``num_layers`` causal at (B, plen, plen) and ``num_layers``
    non-causal cross-attention at (B, plen, 1500); per decode step
    ``num_layers`` cross-attention at (B, 1, 1500)."""
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    t = cfg.encoder_seq
    want = {(dtype, b, t, t, *heads, False): cfg.encoder_layers,
            (dtype, b, plen, plen, *heads, True): cfg.num_layers,
            (dtype, b, plen, t, *heads, False): cfg.num_layers}
    if steps:
        want[(dtype, b, 1, t, *heads, False)] = cfg.num_layers * steps
    return want


def audio_phase(torch, dev, events_dir: pathlib.Path):
    """[audio]: full-width whisper-tiny (bf16, random weights from seed
    0) through the static engine with the 8 [serve] requests (one
    left-padded batch, zero frames as repro feeds them): the exact B1
    launches of ``audio_serve_want``, TTFT, tok/s, decode step, KV bytes
    (the self-attention rings and the encoder states), a profiled decode
    step by group. Its tokens against a serve of the same batch with
    every kernel replaced by its plain version (``plain_kernels``),
    printed at the model's own init (a stacked leaf's fan-in is its layer
    count, 4: std 0.5, attention scores in the hundreds, where the top-2
    rule cannot hold a bf16 path: ``hybrid_phase`` says why) and gated
    under the near-tie rule at fan-in d_in (``rescale_to_fan_in``), with
    zero frames and with frames drawn from the seed. Then float32 (the
    same draws, fan-in d_in): each equal-length group served as a batch
    against each request served alone (batch 1, single-request greedy
    decoding), gated under the near-tie rule. Returns (numbers, every B1
    launch by shape)."""
    from repro_torch.api import build_workload
    from repro_torch.runtime.kvcache import tree_nbytes
    t_phase = time.perf_counter()
    spec = serve_spec("static", events_dir, arch=AUDIO_ARCH)
    ctx, n_params = build_family_ctx(torch, dev, spec, "audio")
    cfg = ctx.model.cfg
    requests = build_workload(spec, cfg.vocab_size)
    b = len(requests)
    plen = max(len(r.prompt) for r in requests)
    max_new = max(r.max_new_tokens for r in requests)
    want = audio_serve_want(cfg, b, plen, max_new - 1, "bfloat16")
    shapes = {}
    report, out, sh, _ = static_serve(torch, ctx, spec, "audio", requests,
                                      want=want, entry=True)
    merge_shapes(shapes, sh)
    kv = (2 * cfg.num_layers * b * (plen + max_new)
          * ctx.model.blocks.kv_cache_heads() * cfg.head_dim * 2
          + b * cfg.encoder_seq * cfg.d_model * 2)
    if out["kv_bytes"] != kv:
        fail(f"[audio] KV bytes {out['kv_bytes']}, reckoned {kv}")
    out.update({"params": n_params, "param_count": cfg.param_count(),
                "encoder_layers": cfg.encoder_layers,
                "decoder_layers": cfg.num_layers})
    # one decode step of the served batch's shape, profiled by group
    import numpy as np
    prompts = np.zeros((b, plen), np.int32)
    for i, r in enumerate(requests):
        prompts[i, plen - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(prompts).to(dev),
             "frames": torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                   dtype=cfg.torch_dtype, device=dev)}
    _, cache, pos = ctx.model.prefill(ctx.params, batch,
                                      cache_len=plen + max_new)
    tok = batch["tokens"][:, -1:]
    out["decode_profile"] = profile_groups(
        torch, lambda: ctx.model.decode_step(ctx.params, cache, tok, pos),
        AUDIO_DECODE_GROUPS, f"[audio] one static decode step (B={b})")
    if tree_nbytes(cache) != kv:
        fail(f"[audio] a prefill's cache holds {tree_nbytes(cache)} bytes")
    del cache, batch

    def against_plain(tag, frames=None, gate=True):
        rep, _, sh, _ = static_serve(torch, ctx, spec, tag, requests,
                                     frames=frames, want=want)
        merge_shapes(shapes, sh)
        with plain_kernels(torch):
            _, _, _, plain_ref = static_serve(torch, ctx, spec,
                                              f"{tag}-plain", requests,
                                              frames=frames, want={})
        return agreement_phase(torch, {tag: rep}, ctx, requests,
                               reference=plain_ref, gate=gate)
    out["own_init_vs_plain"] = against_plain("audio-own-init", gate=False)
    rescale_to_fan_in(torch, ctx.params, ctx.model.param_specs())
    out["fan_in_vs_plain"] = against_plain("audio-fan-in")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=dev).to(cfg.torch_dtype)
    out["frames_vs_plain"] = against_plain("audio-frames", frames=frames)
    del ctx, frames
    gc.collect()
    torch.cuda.empty_cache()

    spec32 = serve_spec("static", events_dir, arch=AUDIO_ARCH,
                        overrides={"dtype": "float32"})
    ctx, _ = build_family_ctx(torch, dev, spec32, "audio-fp32")
    rescale_to_fan_in(torch, ctx.params, ctx.model.param_specs())
    by_len = {}
    for req in requests:
        by_len.setdefault(len(req.prompt), []).append(req)
    fp32 = {}
    for p, group in sorted(by_len.items()):
        tag = f"audio-fp32-{p}"
        rep, fp32[p], sh, _ = static_serve(
            torch, ctx, spec32, tag, group,
            want=audio_serve_want(cfg, len(group), p, max_new - 1,
                                  "float32"))
        merge_shapes(shapes, sh)
        alone = {}
        for req in group:
            _, _, sh, ref = static_serve(
                torch, ctx, spec32, f"{tag}-alone-{req.rid}", [req],
                want=audio_serve_want(cfg, 1, p, max_new - 1, "float32"))
            merge_shapes(shapes, sh)
            alone[req.rid] = ref(req)
        fp32[p]["agreement"] = agreement_phase(
            torch, {tag: rep}, ctx, group, reference=lambda r: alone[r.rid])
    out["fp32"] = fp32
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[audio] phase {out['seconds']:.1f} s", flush=True)
    return out, shapes


def audio_grad_setup(torch, dev, dtype: str):
    """Full-width whisper-tiny in ``dtype`` (random weights from seed 0,
    the normal-init stacked matrices rescaled to fan-in d_in) and one
    batch of ``AUDIO_GRADS``: frames drawn from the seed, random tokens,
    every weight 1. Returns (model, params, batch)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.psl import requires_grad_
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(get_config(AUDIO_ARCH),
                                            dtype=dtype))
    cfg = model.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    rescale_to_fan_in(torch, params, model.param_specs())
    b, s = AUDIO_GRADS["batch"], AUDIO_GRADS["seq"]
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device=dev)
    batch = {"frames": torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                   generator=gen, device=dev).to(
                                       cfg.torch_dtype),
             "tokens": toks[:, :s], "labels": toks[:, 1:].to(torch.int32),
             "weights": torch.ones((b, s), device=dev)}
    return model, requires_grad_(params), batch


def audio_grads_phase(torch, dev):
    """[audio-grads]: ``decomposed_grads`` (the literal PSL protocol, cut
    at the encoder output) of full-width whisper-tiny on
    ``audio_grad_setup``'s batch, through the kernels and through their
    plain versions (``plain_kernels``): per-leaf relative L2 <=
    ``GRAD_REL_L2`` in bf16 and <= ``AUDIO_GRAD_FP32_REL_L2`` in
    float32, the client's encoder gradients (which arrive through the
    cut) included; exact launches (B1 and B1-bwd: the encoder's layers
    non-causal at (8, 1500, 1500), the decoder's causal at (8, 128, 128)
    and non-causal cross-attention at (8, 128, 1500); one B5 and one
    B5-bwd at (1024, 384, 51865)); the attention backward fed lse +
    ``PLANTED_ATTN_LSE_SHIFT`` caught; then the loss on the batch falling
    at each of ``AUDIO_GRADS['steps']`` AdamW steps at
    ``SSM_FIXED_BATCH_LR``. Returns (numbers, launches by shape)."""
    from repro_torch.core.psl import (decomposed_grads, make_train_step,
                                      value_and_grad)
    from repro_torch.kernels import ops
    from repro_torch.optim import TrainState, adamw
    t_phase = time.perf_counter()
    out, shapes = {}, {}
    for dtype, limit in (("bfloat16", GRAD_REL_L2),
                         ("float32", AUDIO_GRAD_FP32_REL_L2)):
        model, params, batch = audio_grad_setup(torch, dev, dtype)
        cfg = model.cfg
        b, s = batch["tokens"].shape
        heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        t = cfg.encoder_seq
        want_b1 = {(dtype, b, t, t, *heads, False): cfg.encoder_layers,
                   (dtype, b, s, s, *heads, True): cfg.num_layers,
                   (dtype, b, s, t, *heads, False): cfg.num_layers}
        want_b5 = {(dtype, b * s, cfg.d_model, cfg.vocab_size): 1}
        want = {"flash_attention": want_b1, "flash_attention_bwd": want_b1,
                "cross_entropy": want_b5, "cross_entropy_bwd": want_b5}
        rec = record_kernel_shapes()
        try:
            ops.reset_launches()
            loss, grads, cut = decomposed_grads(model, params, batch)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        finally:
            counts = rec.stop()
        if counts != want or sum(launches.values()) != sum(
                sum(v.values()) for v in want.values()):
            fail(f"[audio-grads] {dtype} launches {launches}, by shape "
                 f"{counts}, wanted {want}")
        merge_shapes(shapes, counts)
        with plain_kernels(torch):
            ref_loss, ref_grads, ref_cut = decomposed_grads(model, params,
                                                            batch)
        rels = leaf_rel_l2(grads, ref_grads)
        worst_leaf, worst, median = grad_spread(rels)
        enc = max(v for k, v in rels.items() if k.startswith("client."))
        cut_rel = rel_l2(torch, cut, ref_cut)
        print(f"[audio-grads] {dtype}: {b} x ({t} frames + {s} tokens), "
              f"fan-in d_in; loss kernel {float(loss):.5f} vs plain "
              f"{float(ref_loss):.5f}; cut activations rel L2 "
              f"{cut_rel:.3g}; worst per-leaf relative L2 {worst:.3g} "
              f"({worst_leaf}), encoder (client) worst {enc:.3g}, median "
              f"{median:.3g} over {len(rels)} leaves (limit {limit}); "
              f"launches {launches}", flush=True)
        if not worst <= limit:
            fail(f"[audio-grads] {dtype} gradients disagree: {worst} "
                 f"({worst_leaf})")
        res = {"loss": float(loss), "plain_loss": float(ref_loss),
               "worst_rel_l2": worst, "worst_leaf": worst_leaf,
               "encoder_worst_rel_l2": enc, "median_rel_l2": median,
               "cut_rel_l2": cut_rel, "launches": launches}
        del grads
        if dtype == "bfloat16":
            kernel_bwd = ops.flash_attention_bwd

            def planted_bwd(q, k, v, o, dout, lse, **kw):
                return kernel_bwd(q, k, v, o, dout,
                                  lse + PLANTED_ATTN_LSE_SHIFT, **kw)
            ops.flash_attention_bwd = planted_bwd
            try:
                _, planted, _ = decomposed_grads(model, params, batch)
            finally:
                ops.flash_attention_bwd = kernel_bwd
            res["planted_worst_rel_l2"] = max(
                leaf_rel_l2(planted, ref_grads).values())
            print(f"[audio-grads] planted attention-backward lse + "
                  f"{PLANTED_ATTN_LSE_SHIFT} caught: worst per-leaf "
                  f"relative L2 {res['planted_worst_rel_l2']:.3g}",
                  flush=True)
            if res["planted_worst_rel_l2"] <= GRAD_REL_L2:
                fail("[audio-grads] a planted lse shift in the attention "
                     "backward passed the gradient check")
            del planted
            opt = adamw(SSM_FIXED_BATCH_LR, weight_decay=0.1)
            step = make_train_step(model, opt)
            st = TrainState(params, opt.init(params), 0)
            losses, step_ms = [], []
            for _ in range(AUDIO_GRADS["steps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, m = step(st, batch)
                losses.append(float(m["loss"]))
                step_ms.append((time.perf_counter() - t0) * 1e3)
            (final, _), _ = value_and_grad(model.loss_fn, st.params, batch)
            losses.append(float(final))
            print(f"[audio-grads] fixed-batch losses over "
                  f"{AUDIO_GRADS['steps']} AdamW steps at lr "
                  f"{SSM_FIXED_BATCH_LR}: {losses}; step ms {step_ms}",
                  flush=True)
            if not all(y < x for x, y in zip(losses, losses[1:])):
                fail(f"[audio-grads] the fixed-batch loss did not fall at "
                     f"every step: {losses}")
            res.update({"fixed_batch_losses": losses, "step_ms": step_ms})
        out[dtype] = res
        del model, params, batch, ref_grads
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[audio-grads] phase {out['seconds']:.1f} s", flush=True)
    return out, shapes


def audio_kernel_phase(torch, dev, shapes):
    """Every B1, B1-bwd, B5 and B5-bwd shape the [audio] and
    [audio-grads] runs launched (``shapes``, by dtype), held to its plain
    version at bf16's tolerance or ``FP32_ATTN_TOL`` (B5 at
    ``xent_case``'s) and timed: B1 as serving calls it
    (``serve_attention_case``: events, device ms, bound with no causal
    halving, SDPA with ``is_causal=False``), B1-bwd
    (``attention_bwd_case``: by pass, the SDPA backward), B5 and B5-bwd
    in bf16 beside matmul + ``F.cross_entropy`` (float32's held, not
    timed). Returns the cases by kernel."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    cases = {name: [] for name in ("flash_attention", "flash_attention_bwd",
                                   "cross_entropy", "cross_entropy_bwd")}
    for (dt, b, s, t, hq, hkv, d, causal), n in sorted(
            shapes["flash_attention"].items()):
        dtype = getattr(torch, dt)
        tol = (dict(atol=BF16_ATOL, rtol=BF16_RTOL)
               if dtype == torch.bfloat16 else FP32_ATTN_TOL)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        cases["flash_attention"].append({
            "phase": "audio", "launches": n, **serve_attention_case(
                torch, rnd, b, s, hq, hkv, d, tol=tol, t=t,
                causal=causal)})
    for (dt, b, s, t, hq, hkv, d, causal), n in sorted(
            shapes["flash_attention_bwd"].items()):
        cases["flash_attention_bwd"].append({
            "phase": "audio-grads", "launches": n, **attention_bwd_case(
                torch, dev, gen, b, s, hq, hkv, d, t=t, causal=causal,
                dtype=getattr(torch, dt))})
    for key in sorted(set(shapes["cross_entropy"])
                      | set(shapes["cross_entropy_bwd"])):
        dt, shape = key[0], key[1:]
        fwd, bwd = xent_case(torch, dev, gen, getattr(torch, dt),
                             timed=dt == "bfloat16", shape=shape)
        for name, case in (("cross_entropy", fwd),
                           ("cross_entropy_bwd", bwd)):
            cases[name].append({"phase": "audio-grads", "launches":
                                shapes[name].get(key, 0), **case})
    seconds = time.perf_counter() - t_phase
    print(f"[audio-kernels] {sum(len(c) for c in cases.values())} B1, "
          f"B1-bwd, B5 and B5-bwd cases held to their plain versions; "
          f"phase {seconds:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {**cases, "seconds": seconds}


# ---------------------------------------------------------------------------
# SSM training: falcon-mamba-7b (Mamba-1) and zamba2-2.7b (Mamba-2 hybrid)
# ---------------------------------------------------------------------------

SSM_TRAIN_GROUPS = (
    ("B4-bwd selective_scan_bwd", _kernel_named("ssm_bwd")),
    ("B4-bwd per head selective_scan_heads_bwd",
     _kernel_named("mamba2_bwd")),
    ("B4 per head selective_scan_heads", _kernel_named("mamba2_fwd")),
    ("B4 selective_scan", _kernel_named("ssm_scan_kernel")),
    ("B5 cross_entropy fwd", _kernel_named("xent_fwd", "xent_combine")),
    ("B5 cross_entropy_bwd", _kernel_named("xent_", "gemm_kernel")),
    ("B1-bwd flash_attention_bwd", _kernel_named("flash_bwd")),
    ("B1 flash_attention", _kernel_named("flash_fwd")),
    ("AdamW", _launched_in("adamw")),
    ("cuBLAS matmul (projections)",
     _kernel_named("gemm", "sm90", "cutlass", "xmma", "nvjet")),
    ("conv, gates, norms, dt and other elementwise",
     lambda kern, names: True))


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> "bfloat16"."""
    return str(dtype).replace("torch.", "")


class record_train_shapes:
    """Count every training kernel's launches by shape and dtype until
    ``stop``, by wrapping the launchers that ``ops``' wrappers call on a
    CUDA tensor: B1 and B1-bwd by (B, S, Hq, Hkv, D, dtype), B5 and B5-bwd
    by (T, d, V, dtype), B4 and B4-bwd by (B, L, D, N, None, dtype), the
    per-head B4 and B4-bwd by (B, L, D, N, hd, dtype), hd the channels a
    head, the vocab-parallel B5 by (T, d, V of the slice, dtype); dtype is
    the inputs' (``dtype_name``: a 16-bit and a float32 launch run
    different kernels). A B1 or B1-bwd launch that is not
    causal and unwindowed over T = S, or a B1 launch without the lse,
    fails: training runs none. With ``keys`` B1 and B1-bwd go by (B, S,
    T, Hq, Hkv, D, causal, dtype) and may be non-causal over T keys
    (whisper's encoder and cross-attention)."""

    NAMES = {"flash_attention": "flash_attention",
             "flash_attention_bwd": "flash_attention_bwd",
             "selective_scan": "ssm_scan",
             "selective_scan_bwd": "ssm_scan_bwd",
             "selective_scan_heads": "ssm_scan_heads",
             "selective_scan_heads_bwd": "ssm_scan_heads_bwd"}

    def __init__(self, keys: bool = False):
        from repro_torch.kernels import ops
        self.ops, self.xent = ops, ops.xent
        self.saved = {n: getattr(ops, a) for n, a in self.NAMES.items()}
        self.saved_xent = (ops.xent.cross_entropy_fwd,
                           ops.xent.cross_entropy_bwd,
                           ops.xent.cross_entropy_partials)
        self.counts = {n: {} for n in ops.WRAPPERS
                       if n not in ("paged_attention", "spec_verify")}

        def counted(name, shape_of, fn):
            def launch(*args, **kw):
                shape = shape_of(*args, **kw)
                self.counts[name][shape] = self.counts[name].get(shape,
                                                                 0) + 1
                return fn(*args, **kw)
            return launch

        def attn_shape(fwd):
            def shape_of(q, k, v, *args, causal=True, window=None,
                         lse=None, **kw):
                b, hq, s, d = q.shape
                t = k.shape[2]
                if window is not None or (fwd and lse is None) or (
                        not keys and (not causal or t != s)):
                    fail(f"a training B1 launch at T {t}, S {s}, "
                         f"causal {causal}, window {window}, lse "
                         f"{lse is not None}")
                if keys:
                    return (b, s, t, hq, k.shape[1], d, causal,
                            dtype_name(q.dtype))
                return (b, s, hq, k.shape[1], d, dtype_name(q.dtype))
            return shape_of

        def scan_shape(x, dt, a, *args, **kw):
            return (*x.shape, a.shape[1], None, dtype_name(x.dtype))

        def heads_shape(x, dt, a, bm, *args, **kw):
            return (*x.shape, bm.shape[-1], x.shape[-1] // a.shape[0],
                    dtype_name(x.dtype))

        def xent_shape(hidden, w, *args, **kw):
            return (*hidden.shape, w.shape[1], dtype_name(hidden.dtype))

        shapes = {"flash_attention": attn_shape(True),
                  "flash_attention_bwd": attn_shape(False),
                  "selective_scan": scan_shape,
                  "selective_scan_bwd": scan_shape,
                  "selective_scan_heads": heads_shape,
                  "selective_scan_heads_bwd": heads_shape}
        for name, attr in self.NAMES.items():
            setattr(ops, attr, counted(name, shapes[name], self.saved[name]))
        ops.xent.cross_entropy_fwd = counted(
            "cross_entropy", xent_shape, self.saved_xent[0])
        ops.xent.cross_entropy_bwd = counted(
            "cross_entropy_bwd", xent_shape, self.saved_xent[1])
        ops.xent.cross_entropy_partials = counted(
            "cross_entropy_partials", xent_shape, self.saved_xent[2])

    def stop(self):
        for name, attr in self.NAMES.items():
            setattr(self.ops, attr, self.saved[name])
        (self.xent.cross_entropy_fwd, self.xent.cross_entropy_bwd,
         self.xent.cross_entropy_partials) = self.saved_xent
        return self.counts


def scan_bwd_held(shapes, where: str) -> dict:
    """B4-bwd's and the per-head B4-bwd's launches by (shape, dtype) in
    ``shapes`` (``record_train_shapes``' counts), as the kernels line lists
    them: [scan-bwd] holds both kernels to their plain versions at
    ``SCAN_BWD_SHAPES`` and ``SCAN_HEADS_BWD_SHAPES`` in bf16 and fp32, so
    a launch at any other shape or dtype fails."""
    dtypes = ("bfloat16", "float32")
    out = {}
    for name, held in (
            ("selective_scan_bwd", {(*s, None, dt) for s in SCAN_BWD_SHAPES
                                    for dt in dtypes}),
            ("selective_scan_heads_bwd", {(*s, dt) for s in
                                          SCAN_HEADS_BWD_SHAPES
                                          for dt in dtypes})):
        for shape in shapes.get(name, {}):
            if shape not in held:
                fail(f"{name} launched at {shape} in {where}, a shape "
                     f"[scan-bwd] does not hold")
        out[name] = [
            {"shape": "B={} L={} D={} N={} hd={} {}".format(*k),
             "launches": v, "held_by": "[scan-bwd]"}
            for k, v in shapes.get(name, {}).items()]
    return out


def ssm_train_kernel_phase(torch, dev, shapes):
    """Every kernel of [ssm-train] and [hybrid-train] held to its plain
    version and timed at each shape those runs launched it
    (``record_train_shapes``' counts, summed over both): B1 with its lse
    (``attention_train_case``) and B1-bwd (``attention_bwd_case``) at
    bf16's tolerance, B5 and B5-bwd (``xent_case``) at theirs, B4 at
    ``SCAN_TOL`` (``timed_scan_case``) and the per-head B4 as
    ``timed_heads_case`` holds it. B4-bwd is held
    by [scan-bwd] at ``SCAN_BWD_SHAPES``, the per-head B4-bwd at
    ``SCAN_HEADS_BWD_SHAPES``: a shape launched outside them fails.
    Returns the cases by kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import ssm_scan_plain
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def draw(dtype):
        def rn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        return rn
    cases = {name: [] for name in shapes}
    for shape, n in sorted(shapes["flash_attention"].items()):
        b, s, hq, hkv, d, dt = shape
        cases["flash_attention"].append({
            "phase": "train", "launches": n, **attention_train_case(
                torch, dev, gen, draw(getattr(torch, dt)), b=b, s=s, hq=hq,
                hkv=hkv, d=d)})
    for shape, n in sorted(shapes["flash_attention_bwd"].items()):
        cases["flash_attention_bwd"].append({
            "phase": "train", "launches": n, **attention_bwd_case(
                torch, dev, gen, *shape[:5], dtype=getattr(torch, shape[5]))})
    for shape in sorted(set(shapes["cross_entropy"])
                        | set(shapes["cross_entropy_bwd"])):
        fwd, bwd = xent_case(torch, dev, gen, getattr(torch, shape[3]),
                             timed=True, shape=shape[:3])
        for name, case in (("cross_entropy", fwd),
                           ("cross_entropy_bwd", bwd)):
            cases[name].append({"phase": "train", "launches":
                                shapes[name].get(shape, 0), **case})
    for (b, l, d, n, _, dt), count in sorted(
            shapes["selective_scan"].items(), key=str):
        args = scan_case(torch, dev, gen, getattr(torch, dt), b, l, d, n)
        y, h = ops.selective_scan(*args)
        py, ph = ssm_scan_plain(*args)
        what = f"ssm_scan training {(b, l, d, n)} {dt}"
        err = max(within_tol(torch, y, py, f"{what} y", **SCAN_TOL),
                  within_tol(torch, h, ph, f"{what} h_last", **SCAN_TOL))
        cases["selective_scan"].append({
            "phase": "train", **timed_scan_case(
                torch, args, (b, l, d, n), err, count, "the training runs")})
        del args, y, h, py, ph
    for (b, l, d, n, hd, dt), count in sorted(
            shapes["selective_scan_heads"].items()):
        args = heads_case(torch, dev, gen, b, l, d, n, hd, getattr(torch, dt))
        cases["selective_scan_heads"].append({
            "phase": "train", **timed_heads_case(
                torch, args, (b, l, d, n), hd, count, "the training runs")})
        del args
    cases.update(scan_bwd_held(shapes, "training"))
    seconds = time.perf_counter() - t_phase
    print(f"[train-kernels] B1, B1-bwd, B5, B5-bwd, B4 and B4 per head at "
          f"every training shape held to their plain versions (both B4-bwd "
          f"kernels' shapes held by [scan-bwd]: "
          f"{json.dumps(cases['selective_scan_bwd'])} "
          f"{json.dumps(cases['selective_scan_heads_bwd'])}); phase "
          f"{seconds:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {**cases, "seconds": seconds}


def grad_spread(rels):
    """(worst leaf, its relative L2, the median) of ``leaf_rel_l2``'s."""
    worst = max(rels, key=rels.get)
    return worst, rels[worst], sorted(rels.values())[len(rels) // 2]


def ssm_grad_case(torch, ctx, state, batch, ref, kernels, limit):
    """One kernel-vs-plain gradient comparison of ``ssm_grad_check``: the
    loss's gradients with the kernel families in ``kernels`` as kernels
    (the others plain) against ``ref`` (every family plain), per-leaf
    relative L2 (``leaf_rel_l2``); then the same with the B4-bwd
    launchers' ddt (per channel and per head) scaled by
    ``PLANTED_SCAN_GRAD_DDT_SCALE``. Returns (result, launches of the
    unplanted run)."""
    from repro_torch.core.psl import value_and_grad
    from repro_torch.kernels import ops
    others = tuple(n for n in ALL_KERNELS if n not in kernels)
    ops.reset_launches()
    with plain_kernels(torch, others):
        (loss, _), grads = value_and_grad(ctx.model.loss_fn, state.params,
                                          batch)
    launches = ops.launch_counts()
    rels = leaf_rel_l2(grads, ref)
    del grads
    worst, err, median = grad_spread(rels)
    out = {"kernels": list(kernels), "loss": float(loss),
           "worst_rel_l2": err, "worst_leaf": worst, "median_rel_l2": median,
           "rel_l2_by_leaf": rels, "limit": limit}
    launchers = {name: getattr(ops, name)
                 for name in ("ssm_scan_bwd", "ssm_scan_heads_bwd")}

    def planted(launcher):
        def run(*args, **kw):
            dx, ddt, da, dbm, dcm = launcher(*args, **kw)
            return dx, ddt * PLANTED_SCAN_GRAD_DDT_SCALE, da, dbm, dcm
        return run
    for name, fn in launchers.items():
        setattr(ops, name, planted(fn))
    try:
        with plain_kernels(torch, others):
            _, planted = value_and_grad(ctx.model.loss_fn, state.params,
                                        batch)
    finally:
        for name, fn in launchers.items():
            setattr(ops, name, fn)
    pworst, perr, _ = grad_spread(leaf_rel_l2(planted, ref))
    out.update(planted_worst_rel_l2=perr, planted_leaf=pworst)
    return out, launches


def attention_readings(torch, tag, ctx, state, batch, ref):
    """Where a bf16 kernel-vs-plain gradient reading through the shared
    attention comes from: B1 alone as a kernel (the rest plain) against
    ``ref`` (autograd through the plain path), and against the plain path
    whose attention backward is B1-bwd's formulas in plain PyTorch
    (``plain_kernels``' ``attention_formulas``); and that path against
    ``ref``. Printed, not gated: the gate is ``ssm_grad_check``'s."""
    from repro_torch.core.psl import value_and_grad
    from repro_torch.kernels import ops
    ops.reset_launches()
    with plain_kernels(torch, ("cross_entropy", "selective_scan")):
        _, b1 = value_and_grad(ctx.model.loss_fn, state.params, batch)
    launches = ops.launch_counts()
    with plain_kernels(torch, attention_formulas=True):
        _, formulas = value_and_grad(ctx.model.loss_fn, state.params, batch)
    out = {}
    for name, got, want in (("b1_vs_plain", b1, ref),
                            ("b1_vs_plain_formulas", b1, formulas),
                            ("plain_formulas_vs_plain", formulas, ref)):
        leaf, err, median = grad_spread(leaf_rel_l2(got, want))
        out[name] = {"worst_rel_l2": err, "worst_leaf": leaf,
                     "median_rel_l2": median}
    out["b1_launches"] = launches
    print(f"[{tag}] B1 alone a kernel: against the plain path worst "
          f"{out['b1_vs_plain']['worst_rel_l2']:.3g} "
          f"({out['b1_vs_plain']['worst_leaf']}), median "
          f"{out['b1_vs_plain']['median_rel_l2']:.3g}; against the plain "
          f"path with B1-bwd's formulas worst "
          f"{out['b1_vs_plain_formulas']['worst_rel_l2']:.3g} "
          f"({out['b1_vs_plain_formulas']['worst_leaf']}), median "
          f"{out['b1_vs_plain_formulas']['median_rel_l2']:.3g}; that path "
          f"against the plain path worst "
          f"{out['plain_formulas_vs_plain']['worst_rel_l2']:.3g}, median "
          f"{out['plain_formulas_vs_plain']['median_rel_l2']:.3g}; "
          f"launches {launches} (printed, not gated)", flush=True)
    return out


def ssm_grad_check(torch, dev, tag: str, arch: str, layers: int,
                   rows: int, cases):
    """Kernel-path gradients against the plain path's (``plain_kernels``:
    autograd through ``ssm_scan_plain``, ``flash_attention_plain`` and the
    plain cross-entropy) at ``layers`` layers, full width, fan-in d_in, on
    the first ``rows`` sequences of a plan batch, once for each (dtype,
    kernel families kept as kernels) of ``cases`` (dtype None: the
    model's). Every case must hold every leaf within ``GRAD_REL_L2`` in
    bf16 or ``SCAN_GRAD_FP32_REL_L2`` in float32, and the B4-bwd
    launcher's ddt scaled by ``PLANTED_SCAN_GRAD_DDT_SCALE`` must fail
    that limit. Every run launches each kept kernel once a layer (B4 and
    B4-bwd), a shared-attention application (B1 and B1-bwd) or a loss (B5
    and B5-bwd), and nothing else. A hybrid's reference in its own dtype
    also gets ``attention_readings``."""
    from repro_torch.core.psl import value_and_grad
    out, refs, extra = [], {}, {}
    for dtype, kernels in cases:
        if dtype not in refs:
            refs.clear()
            gc.collect()
            torch.cuda.empty_cache()
            ctx, state, batch = grad_check_setup(torch, dev, arch=arch,
                                                 layers=layers, dtype=dtype)
            batch = {k: v[:rows] for k, v in batch.items()}
            with plain_kernels(torch):
                (ref_loss, _), ref = value_and_grad(ctx.model.loss_fn,
                                                    state.params, batch)
            refs[dtype] = ref
            if dtype is None and ctx.model.cfg.family == "hybrid":
                extra["attention_readings"] = attention_readings(
                    torch, tag, ctx, state, batch, ref)
        name = dtype or ctx.model.cfg.dtype
        limit = SCAN_GRAD_FP32_REL_L2 if name == "float32" else GRAD_REL_L2
        res, launches = ssm_grad_case(torch, ctx, state, batch, refs[dtype],
                                      kernels, limit)
        n_attn = ctx.model.n_super
        want = {k: 0 for k in launches}
        if "selective_scan" in kernels:
            want.update({scan_fwd_name(ctx.model.cfg): layers,
                         scan_bwd_name(ctx.model.cfg): layers})
        if "attention" in kernels:
            want.update(flash_attention=n_attn, flash_attention_bwd=n_attn)
        if "cross_entropy" in kernels:
            want.update(cross_entropy=1, cross_entropy_bwd=1)
        if launches != want:
            fail(f"[{tag}] gradient check ({name}, kernels {kernels}) "
                 f"launches {launches}, wanted {want}")
        res.update(dtype=name, plain_loss=float(ref_loss), launches=launches)
        print(f"[{tag}] gradients at {layers} layers full width, {name} "
              f"(fan-in d_in, {rows} x {batch['tokens'].shape[1]} tokens), "
              f"kernels {'/'.join(kernels)} (the rest plain) against the "
              f"plain path: loss {res['loss']:.6f} vs {float(ref_loss):.6f};"
              f" worst per-leaf relative L2 {res['worst_rel_l2']:.3g} "
              f"({res['worst_leaf']}) over {len(res['rel_l2_by_leaf'])} "
              f"leaves, median {res['median_rel_l2']:.3g}; limit {limit}; "
              f"planted B4-bwd ddt x {PLANTED_SCAN_GRAD_DDT_SCALE}: worst "
              f"{res['planted_worst_rel_l2']:.3g} ({res['planted_leaf']})",
              flush=True)
        if not res["worst_rel_l2"] <= limit:
            fail(f"[{tag}] kernel-path gradients disagree: "
                 f"{res['worst_leaf']} {res['worst_rel_l2']}")
        if res["planted_worst_rel_l2"] <= limit:
            fail(f"[{tag}] a planted B4-bwd ddt x "
                 f"{PLANTED_SCAN_GRAD_DDT_SCALE} passed the gradient check:"
                 f" {res['planted_worst_rel_l2']}")
        out.append(res)
    del ctx, state, batch
    refs.clear()
    return {"cases": out, **extra}


def scan_fwd_name(cfg) -> str:
    """The B4 wrapper a Mamba layer of ``cfg`` runs: the per-head one in
    Mamba-2's layout, the per-channel one in Mamba-1's."""
    return ("selective_scan_heads" if cfg.ssm_variant == "mamba2"
            else "selective_scan")


def scan_bwd_name(cfg) -> str:
    """The B4-bwd wrapper a Mamba layer of ``cfg`` trains through, as
    ``scan_fwd_name`` picks B4's."""
    return ("selective_scan_heads_bwd" if cfg.ssm_variant == "mamba2"
            else "selective_scan_bwd")


def ssm_train_phase(torch, dev, events_dir: pathlib.Path, tag: str, arch,
                    layers: int, steps: int, grad_layers: int,
                    grad_rows: int, grad_cases):
    """[ssm-train] / [hybrid-train]: full-width ``arch`` at ``layers``
    layers (cut 2), PSL-UGS through ``api.run`` in the granite training
    setting for ``steps`` steps: per-step loss, accuracy, grad
    norm and step ms; launches exactly one B4 and one B4-bwd (per head
    in Mamba-2's layout, ``scan_fwd_name``, ``scan_bwd_name``) a Mamba
    layer, one B1 and one B1-bwd a shared-attention application, one B5
    and one B5-bwd a step, nothing else; finite losses and grad norms;
    init and training peak memory; one more step profiled by group
    (``SSM_TRAIN_GROUPS``, AdamW in its own range); then, from a fresh
    init rescaled to fan-in d_in, the loss on one fixed batch must fall
    at each of 3 AdamW steps at ``SSM_FIXED_BATCH_LR``; then
    ``ssm_grad_check``. Returns (result, the training run's launches by
    shape, ``record_train_shapes``')."""
    import math
    import statistics
    import numpy as np
    from torch.profiler import record_function
    from repro_torch import api
    from repro_torch.api.protocols import lm_plan_batches
    from repro_torch.configs import get_config
    from repro_torch.core.psl import make_train_step
    from repro_torch.core.sampling import make_plan
    from repro_torch.kernels import ops
    from repro_torch.launch.distributed import ShardedPSLEngine
    from repro_torch.launch.train import default_lm_spec
    from repro_torch.optim import Optimizer, adamw

    t_phase = time.perf_counter()
    events = str(events_dir / f"{tag}.jsonl")
    spec = api.apply_overrides(default_lm_spec(), [
        f"model.arch={arch}", f"model.overrides.num_layers={layers}",
        "model.overrides.cut_layer=2",
        f"execution.max_steps={steps}", "obs.enabled=true",
        "obs.monitor=false", f"obs.events_path={events}"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = api.build_context(spec, device=dev)
    model, cfg = ctx.model, ctx.model.cfg
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} of "
          f"{get_config(arch).num_layers} layers (cut {cfg.cut_layer}), "
          f"full width d_model {cfg.d_model}, d_inner {cfg.d_inner}, N "
          f"{cfg.ssm_state}, {cfg.ssm_variant}"
          + (f", {model.n_super} superblocks of {cfg.attn_period} after "
             f"{model.n_pre} pre-blocks" if cfg.family == "hybrid" else "")
          + f", {cfg.dtype}; {ctx.data.pop.num_clients} clients, global "
          f"batch {spec.protocol.global_batch_size} x {spec.data.seq_len}, "
          f"{spec.sampler.method}, {spec.optimizer.name}; built in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    ops.reset_launches()
    recorder = record_train_shapes()
    try:
        result = api.run(spec, ctx=ctx)
        torch.cuda.synchronize()
    finally:
        shapes = recorder.stop()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = span_means(events)["device_step"]
    ran = len(result.step_metrics)
    for i, m in enumerate(result.step_metrics):
        print(f"[{tag}] step {i}: loss {m['loss']:.4f} accuracy "
              f"{m['accuracy']:.4f} tokens {m['tokens']:.0f} grad_norm "
              f"{m['grad_norm']:.4f} step {step_ms[i]:.1f} ms", flush=True)
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"[{tag}] step {i} is not finite: {m}")
    attn = model.n_super
    want = {name: 0 for name in launches}
    want.update({scan_fwd_name(cfg): layers * ran,
                 scan_bwd_name(cfg): layers * ran,
                 "flash_attention": attn * ran,
                 "flash_attention_bwd": attn * ran,
                 "cross_entropy": ran, "cross_entropy_bwd": ran})
    if ran != steps or launches != want:
        fail(f"[{tag}] {ran} steps of {steps}, launches {launches}, wanted {want} "
             f"({layers} {scan_fwd_name(cfg)} + {layers} "
             f"{scan_bwd_name(cfg)} + {attn} B1 + "
             f"{attn} B1-bwd "
             f"+ 1 B5 + 1 B5-bwd a step)")
    n_params = sum(p.numel() for p in _leaves(result.params))
    median = statistics.median(step_ms[1:])
    tokens = result.step_metrics[-1]["tokens"]
    print(f"[{tag}] {n_params / 1e9:.3f} B params; first step "
          f"{step_ms[0]:.1f} ms, median after it {median:.1f} ms, "
          f"{tokens / median * 1e3:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)

    # one more step, profiled by group, with AdamW in its own range
    pstate = result.state
    engine, state = pstate["engine"], pstate["state"]
    opt = ctx.optimizer

    def ranged_updates(params, grads, st):
        with record_function("adamw"):
            return opt.apply_updates(params, grads, st)
    engine._step = make_train_step(model, Optimizer(
        init=opt.init, apply_updates=ranged_updates))
    plan = make_plan("ugs", ctx.data.pop, spec.protocol.global_batch_size,
                     seed=spec.seed)
    host = next(iter(lm_plan_batches(
        ctx.data.lm_data, ctx.data.pop, plan, spec.data.seq_len,
        spec.protocol.aggregation, np.zeros(len(ctx.data.lm_data),
                                            np.int64))))
    batch = engine.put_batch(host)
    profile = profile_groups(torch, lambda: engine.step(state, batch),
                             SSM_TRAIN_GROUPS, f"[{tag}] one step")
    metrics = [{k: m[k] for k in ("loss", "accuracy", "grad_norm")}
               for m in result.step_metrics]
    del result, pstate, engine, state

    # fixed-batch descent from a fan-in-rescaled init
    gc.collect()
    torch.cuda.empty_cache()
    eng = ShardedPSLEngine(model, adamw(
        SSM_FIXED_BATCH_LR, weight_decay=spec.optimizer.weight_decay),
        device=dev)
    st = eng.init_state(spec.seed)
    rescale_to_fan_in(torch, st.params, model.param_specs())
    losses = []
    for _ in range(3):
        st, m = eng.step(st, batch)
        losses.append(m["loss"])
    with torch.no_grad():
        losses.append(float(model.loss_fn(st.params, batch)[1]["loss"]))
    print(f"[{tag}] fixed-batch losses over 3 AdamW steps at lr "
          f"{SSM_FIXED_BATCH_LR} (fan-in d_in init): {losses}", flush=True)
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"[{tag}] the fixed-batch loss did not fall at every step: "
             f"{losses}")
    del eng, st, ctx, batch
    gc.collect()
    torch.cuda.empty_cache()
    grads = ssm_grad_check(torch, dev, tag, arch, grad_layers, grad_rows,
                           grad_cases)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[{tag}] phase {seconds:.1f} s", flush=True)
    return {"layers": layers, "params": n_params, "steps": steps,
            "step_ms": step_ms, "median_step_ms_after_first": median,
            "tokens_per_step": tokens, "tokens_per_s": tokens / median * 1e3,
            "metrics": metrics, "peak_memory_bytes": peak,
            "launches": launches, "profile": profile,
            "fixed_batch_losses": losses, "grads": grads,
            "seconds": seconds}, shapes


# ---------------------------------------------------------------------------
# The paper's CNN: PSL training of the full-width GroupNorm ResNet
# ---------------------------------------------------------------------------

CNN_AGREE_STEPS = 3
CNN_AGREE_LR = 1e-4             # [cnn-agree]'s steps (the docstring says why)
CNN_LOSS_RTOL = 1e-4            # per-step loss, card against the CPU
CNN_GRAD_REL_L2 = 1e-4          # per-leaf gradient at step 0
CNN_MIN_TEST_ACC = 0.3          # three times chance, 10 classes
CNN_PROTOCOL_STEPS = 50
CNN_SGD = dict(lr=0.05, momentum=0.9, weight_decay=5e-4)


def tf32_flags(torch):
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def cnn_rescale_to_fan_in(torch, params) -> None:
    """Rescale every conv leaf (HWIO) of a CNN params tree to std
    1/sqrt(kh * kw * cin), in place.

    ``repro``'s init rule (mirrored by the port) takes a leaf's fan-in
    from ``shape[0]``, the kernel height of an HWIO conv: std 1/sqrt(3)
    for every 3x3 conv whatever its input width, and 1 for the 1x1
    projections. At full width the features then grow about sqrt(cin)
    at each projection, the loss starts near 600, and SGD at the paper's
    lr 0.05 reaches NaN by step 4 (``tools/cnn_conditioning.py``;
    ``[cnn-agree]`` prints the first 3 steps on the card).
    This is the same rule with the conv's whole fan-in."""
    import math
    from repro_torch.models.layers import tree_leaves
    with torch.no_grad():
        for leaf in tree_leaves(params):
            if leaf.dim() == 4:
                kh, kw, cin, _ = leaf.shape
                leaf.mul_(math.sqrt(kh / (kh * kw * cin)))


@contextlib.contextmanager
def cnn_fan_in_init(torch):
    """Within the block, every protocol's initial state
    (``repro_torch.api.protocols._fresh_state``) is rescaled by
    ``cnn_rescale_to_fan_in``."""
    from repro_torch.api import protocols
    kept = protocols._fresh_state

    def fresh(ctx):
        state = kept(ctx)
        cnn_rescale_to_fan_in(torch, state.params)
        return state
    protocols._fresh_state = fresh
    try:
        yield
    finally:
        protocols._fresh_state = kept


def cnn_agree_phase(torch, dev):
    """Full-width CNN (paper-cnn CONFIG, fp32, 32x32) on the card against
    the same code on the CPU, from the port's seeded init (``repro``'s
    rule) made on the CPU and copied to the card, with TF32 off: K = 8
    extended-Dirichlet clients (C = 2), one UGS plan at global batch 64.

    - Step 0's per-leaf gradients within ``CNN_GRAD_REL_L2`` (relative L2).
    - The module's ``conv`` patched to symmetric padding (the stride-2
      trap) must fail those limits.
    - 3 SGD steps over the same batches at ``CNN_AGREE_LR``: the loss at
      each step within ``CNN_LOSS_RTOL``. At the paper's lr 0.05 this
      init diverges (``cnn_rescale_to_fan_in``), and fp32 rounding grows
      with it: on the CPU, fp32 against fp64 reads 2.6e-4 at step 2 even
      from the fan-in init, against 1.2e-8 here
      (``tools/cnn_conditioning.py``).
    - 3 SGD steps at the paper's lr on the card show the divergence
      (printed, not gated).
    """
    import torch.nn.functional as F
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

    saved = tf32_flags(torch)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config("paper-cnn")
        model = cnn_mod.CNNModel(cfg)
        feats, labels = make_classification_dataset(
            2048, num_classes=cfg.num_classes, image_size=cfg.image_size,
            seed=0)
        parts, pop = partition_dirichlet(labels, 8, cfg.num_classes,
                                         classes_per_client=2, seed=1)
        store = ClientStore.from_partition(feats, labels, parts, pop)
        plan = make_plan("ugs", pop, 64, seed=0)
        host = [gb for gb, _ in zip(GlobalBatchIterator(store, plan, seed=0),
                                    range(CNN_AGREE_STEPS))]
        gen = torch.Generator()
        gen.manual_seed(0)
        cpu_params = requires_grad_(model.init(gen))

        def to_card():
            return requires_grad_(tree_map(
                lambda p: p.detach().to(dev, copy=True), cpu_params))
        card_params = to_card()
        cpu_batches = [batch_from(b["features"], b["labels"], b["weights"])
                       for b in host]
        card_batches = [batch_from(b["features"], b["labels"],
                                   b["weights"], device=dev) for b in host]
        on_card = [t.is_cuda for t in tree_leaves(card_params)] + \
            [t.is_cuda for b in card_batches for t in b.values()]
        if not all(on_card):
            fail(f"{on_card.count(False)} CNN tensors are not on the card")

        def grads_of(params, batch):
            (loss, _), g = value_and_grad(model.loss_fn, params, batch)
            return float(loss), g

        def leaf_errors(got, want):
            return {name: ((a.detach().cpu() - b).norm()
                           / b.norm().clamp_min(1e-30)).item()
                    for name, a, b in zip(_leaf_names(want),
                                          tree_leaves(got),
                                          tree_leaves(want))}

        def sgd_losses(params, batches, lr):
            opt = sgd(lr, momentum=CNN_SGD["momentum"],
                      weight_decay=CNN_SGD["weight_decay"])
            step = make_train_step(model, opt)
            st = TrainState(params, opt.init(params), 0)
            out = []
            for b in batches:
                st, m = step(st, b)
                out.append(float(m["loss"]))
            return out

        cpu_loss, cpu_grads = grads_of(cpu_params, cpu_batches[0])
        card_loss, card_grads = grads_of(card_params, card_batches[0])
        rels = leaf_errors(card_grads, cpu_grads)
        worst_leaf = max(rels, key=rels.get)
        print(f"[cnn-agree] {cfg.name} channels {cfg.channels}, "
              f"{cfg.image_size}x{cfg.image_size}, batch 64, TF32 "
              f"{tf32_flags(torch)}: step-0 loss card {card_loss:.6f} CPU "
              f"{cpu_loss:.6f}; worst per-leaf relative L2 "
              f"{rels[worst_leaf]:.3g} ({worst_leaf}) over {len(rels)} "
              f"leaves (limit {CNN_GRAD_REL_L2})", flush=True)
        if not rels[worst_leaf] <= CNN_GRAD_REL_L2:
            fail(f"CNN gradients on the card disagree with the CPU: "
                 f"{worst_leaf} relative L2 {rels[worst_leaf]}")

        kept = cnn_mod.conv

        def symmetric_conv(x, w, stride=1):
            return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                            padding=w.shape[0] // 2)
        cnn_mod.conv = symmetric_conv
        try:
            planted_loss, planted_grads = grads_of(card_params,
                                                   card_batches[0])
        finally:
            cnn_mod.conv = kept
        planted_loss_rel = abs(planted_loss - cpu_loss) / abs(cpu_loss)
        planted_worst = max(leaf_errors(planted_grads, cpu_grads).values())
        print(f"[cnn-agree] planted symmetric padding: loss relative "
              f"error {planted_loss_rel:.3g}, worst per-leaf gradient "
              f"relative L2 {planted_worst:.3g}", flush=True)
        if planted_loss_rel <= CNN_LOSS_RTOL \
                and planted_worst <= CNN_GRAD_REL_L2:
            fail("a planted symmetric stride-2 padding passed the CNN "
                 "agreement checks")
        del cpu_grads, card_grads, planted_grads

        diverging = sgd_losses(to_card(), card_batches, CNN_SGD["lr"])
        print(f"[cnn-agree] at the paper's lr {CNN_SGD['lr']} from this "
              f"init (3x3 conv std 1/sqrt(3), 1x1 std 1): losses on the "
              f"card {diverging} (not gated)", flush=True)
        losses = {"cpu": sgd_losses(cpu_params, cpu_batches, CNN_AGREE_LR),
                  "card": sgd_losses(card_params, card_batches,
                                     CNN_AGREE_LR)}
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"])]
        print(f"[cnn-agree] {CNN_AGREE_STEPS} SGD steps at lr "
              f"{CNN_AGREE_LR}: losses card {losses['card']} CPU "
              f"{losses['cpu']}; relative errors "
              f"{[float(f'{r:.3g}') for r in rel]} (limit {CNN_LOSS_RTOL})",
              flush=True)
        if not max(rel) <= CNN_LOSS_RTOL:
            fail(f"CNN losses on the card disagree with the CPU: {rel}")
    finally:
        torch.backends.cudnn.allow_tf32 = saved["cudnn.allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = \
            saved["cuda.matmul.allow_tf32"]
    return {"worst_grad_rel_l2": rels[worst_leaf], "worst_leaf": worst_leaf,
            "loss_rel_errors": rel, "planted_loss_rel": planted_loss_rel,
            "planted_worst_grad_rel_l2": planted_worst, "losses": losses,
            "diverging_losses_at_paper_lr": diverging}


def cnn_spec():
    """The paper's setting at CIFAR-10 size: 50,000 train and 10,000 test
    images of 32x32, 10 classes, K = 8 extended-Dirichlet clients (C = 2),
    stragglers at StragglerSpec()'s defaults, PSL-UGS at global batch 64,
    SGD lr 0.05, momentum 0.9, weight decay 5e-4, one epoch, the full-width
    paper-cnn, the GPSL monitor on. The runs start from the port's seeded
    init rescaled to fan-in (``cnn_fan_in_init``)."""
    from repro_torch import api
    return api.ExperimentSpec(
        model=api.ModelSpec(arch="paper-cnn", reduced=False),
        optimizer=api.OptimizerSpec(name="sgd", **CNN_SGD),
        data=api.DataSpec(kind="synthetic_classification", num_train=50000,
                          num_test=10000, image_size=32, num_classes=10,
                          num_clients=8, classes_per_client=2,
                          partition="dirichlet",
                          straggler=api.StragglerSpec()),
        sampler=api.SamplerSpec(method="ugs"),
        protocol=api.ProtocolSpec(name="psl", epochs=1,
                                  global_batch_size=64, batch_size=64,
                                  track_tpe=True),
        execution=api.ExecutionSpec(engine="fused"),
        eval=api.EvalSpec(enabled=True, batch_size=500),
        obs=api.ObsSpec(enabled=True, monitor=True))


def step_clock(torch):
    """A callback timing each step of the loop, batch assembly included:
    the card is synchronized at each step's end (so the host cannot run
    ahead of it by more than one step)."""
    from repro_torch.api.events import Callback

    class StepClock(Callback):
        def __init__(self):
            self.ms = []
            self._t = 0.0

        def on_event(self, event, ctx, record):
            if event.name == "epoch_begin":
                torch.cuda.synchronize()
                self._t = time.perf_counter()
            elif event.name == "step_end":
                torch.cuda.synchronize()
                t = time.perf_counter()
                self.ms.append((t - self._t) * 1e3)
                self._t = t
    return StepClock()


# kernel-name groups of the profiled CNN step's gradient pass, first match
# wins; "conv" holds cuDNN's implicit-GEMM, FFT and layout kernels and
# the head's cuBLAS GEMM
_CNN_GROUPS = (("norm", ("Moments", "FusedParams", "GroupNorm", "group_norm",
                         "GammaBeta", "InternalGradients", "Norm")),
               ("conv", ("conv", "xmma", "implicit", "winograd", "gemm",
                         "cudnn", "dgrad", "wgrad", "fft", "complex",
                         "flip_filter", "im2col", "cutlass", "Nhwc", "Nchw",
                         "nchw", "nhwc", "scalePacked")),
               ("elementwise", ("",)))


def cnn_profile_step(torch, ctx, pstate, plan):
    """One more fused step under torch.profiler, in two profiled parts:
    the gradient pass (kernels grouped as conv / norm / elementwise by
    name) and the SGD update (all of it "optimizer"); device busy time
    against the two parts' wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api.evaluation import batch_from
    from repro_torch.core.psl import grad_norm, value_and_grad
    from repro_torch.data.federated import GlobalBatchIterator

    state = pstate["state"]
    gb = next(iter(GlobalBatchIterator(ctx.data.store, plan, seed=1)))
    batch = batch_from(gb["features"], gb["labels"], gb["weights"],
                       device=ctx.device)
    groups = {"conv": 0.0, "norm": 0.0, "elementwise": 0.0,
              "optimizer": 0.0}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, grads = value_and_grad(ctx.model.loss_fn, state.params, batch)
        float(grad_norm(grads))
        grad_wall = (time.perf_counter() - t0) * 1e3
    grad_kernels = _device_kernels(prof)
    group_of = {}
    for key, ms in grad_kernels.items():
        name = next(n for n, pats in _CNN_GROUPS
                    if any(p in key for p in pats))
        group_of[key] = name
        groups[name] += ms
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.optimizer.apply_updates(state.params, grads, state.opt_state)
        torch.cuda.synchronize()
        update_wall = (time.perf_counter() - t0) * 1e3
    opt_kernels = _device_kernels(prof)
    groups["optimizer"] = sum(opt_kernels.values())
    busy = sum(groups.values())
    wall = grad_wall + update_wall
    top = [(group_of.get(k, "optimizer"), k, ms) for k, ms in sorted(
        list(grad_kernels.items()) + list(opt_kernels.items()),
        key=lambda kv: -kv[1])[:12]]
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "busy_share": busy / wall if wall else None,
           "groups_ms": groups, "top_kernels_ms": top}
    print(f"[cnn] profiled step: wall {wall:.2f} ms (gradient pass "
          f"{grad_wall:.2f}, update {update_wall:.2f}), device busy "
          f"{busy:.2f} ms (busy share {out['busy_share']:.3f}); by group "
          f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}",
          flush=True)
    for group, key, ms in top:
        print(f"[cnn]   {ms:8.3f} ms  {group:11s} {key[:100]}", flush=True)
    if busy <= 0:
        print("[cnn] the profiler recorded no device time", flush=True)
    return out


def cnn_run(torch, ctx, spec, label: str, callbacks=(), tag="[cnn]"):
    """One epoch of ``spec`` through repro_torch.api.run on ``ctx`` (with
    ``callbacks`` beside the step clock): step times, images/s, peak
    memory, test accuracy, TPE, monitor verdict; printed under ``tag``."""
    import math
    import statistics
    from repro_torch import api
    clock = step_clock(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cnn_fan_in_init(torch):
        result = api.run(spec, ctx=ctx, callbacks=[clock, *callbacks])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [m["loss"] for m in result.step_metrics]
    ms = clock.ms
    median = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    gb = spec.protocol.global_batch_size
    extras = result.history.extras
    monitor = extras.get("gpsl_monitor", [{}])[0]
    out = {"steps": len(losses), "first_step_ms": ms[0],
           "median_step_ms_after_first": median,
           "images_per_s": gb / median * 1e3,
           "epoch_wall_s": wall, "peak_memory_bytes":
               torch.cuda.max_memory_allocated(),
           "first_loss": losses[0], "last_loss": losses[-1],
           "finite": all(math.isfinite(x) for x in losses),
           "test_acc": result.test_acc[-1] if result.test_acc else None,
           "tpe_ms": extras.get("tpe_ms"), "monitor": monitor,
           "tf32": tf32_flags(torch)}
    print(f"{tag} {label}: {out['steps']} steps, first step "
          f"{ms[0]:.2f} ms, median after it {median:.3f} ms, "
          f"{out['images_per_s']:.0f} images/s; epoch (eval included) "
          f"{wall:.2f} s; peak memory "
          f"{out['peak_memory_bytes'] / 2**30:.3f} GiB; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; test accuracy "
          f"{out['test_acc']}; tpe_ms {out['tpe_ms']}; monitor ok "
          f"{monitor.get('ok')} (deviation violations "
          f"{monitor.get('deviation_violations')}, max class deviation "
          f"{monitor.get('max_class_deviation')}, epsilon "
          f"{monitor.get('epsilon')}); TF32 {out['tf32']}", flush=True)
    return out, result


def cnn_phase(torch, dev):
    """One epoch of PSL-UGS and one of PSL-FLS at the paper's setting
    (``cnn_spec``), gated on UGS: finite loss, test accuracy >=
    ``CNN_MIN_TEST_ACC`` and no GPSL monitor violation."""
    import math
    from repro_torch import api
    from repro_torch.core.sampling import make_plan
    from repro_torch.models.layers import tree_leaves
    spec = cnn_spec()
    t0 = time.perf_counter()
    ctx = api.build_context(spec, device=dev)
    n_params = sum(math.prod(s.shape)
                   for s in tree_leaves(ctx.model.param_specs()))
    print(f"[cnn] built in {time.perf_counter() - t0:.2f}s (data made on "
          f"the host): {ctx.model.cfg.name} channels "
          f"{ctx.model.cfg.channels}, {n_params / 1e6:.3f} M params, "
          f"{ctx.data.pop.num_clients} clients, D0 "
          f"{ctx.data.pop.total_size}, sizes "
          f"{ctx.data.pop.dataset_sizes.tolist()}, delays (ms) "
          f"{[round(float(d), 1) for d in ctx.data.pop.delays]}",
          flush=True)
    ugs, result = cnn_run(torch, ctx, spec, "PSL-UGS")
    plan = make_plan(spec.sampler.method, ctx.data.pop,
                     spec.protocol.global_batch_size, seed=spec.seed)
    ugs["profile"] = cnn_profile_step(torch, ctx, result.state, plan)
    del result
    fls_spec = spec.replace(sampler=spec.sampler.replace(method="fls"))
    fls, _ = cnn_run(torch, ctx, fls_spec, "PSL-FLS (not gated)")
    if not ugs["finite"]:
        fail("the PSL-UGS epoch's loss is not finite")
    if not ugs["test_acc"] >= CNN_MIN_TEST_ACC:
        fail(f"PSL-UGS test accuracy {ugs['test_acc']} < "
             f"{CNN_MIN_TEST_ACC}")
    if not ugs["monitor"].get("ok"):
        fail(f"the GPSL monitor flagged the PSL-UGS epoch: "
             f"{ugs['monitor']}")
    return {"ugs": ugs, "fls": fls, "params": n_params}, ctx


def cnn_protocols_phase(torch, ctx):
    """CL, SL, FL, SFL and PSL on the one-card sharded engine, each at full
    width for ``CNN_PROTOCOL_STEPS`` steps on the [cnn] data, each with a
    finite loss, that step count and an evaluation."""
    import math
    from repro_torch import api
    base = cnn_spec()
    out = {}
    for name in ("cl", "sl", "fl", "sfl", "psl"):
        spec = base.replace(
            protocol=base.protocol.replace(name=name),
            execution=api.ExecutionSpec(
                engine="sharded" if name == "psl" else "fused",
                max_steps=CNN_PROTOCOL_STEPS),
            obs=api.ObsSpec())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cnn_fan_in_init(torch):
            result = api.run(spec, ctx=ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [m["loss"] for m in result.step_metrics]
        row = {"steps": len(losses), "first_loss": losses[0],
               "last_loss": losses[-1], "test_acc": result.test_acc,
               "wall_s": wall, "extras": {
                   k: v for k, v in result.history.extras.items()
                   if k != "shard_skew_ms"}}
        label = f"{name}{' (sharded engine)' if name == 'psl' else ''}"
        print(f"[cnn-protocols] {label}: {row['steps']} steps in "
              f"{wall:.2f} s (eval included), loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, test accuracy {result.test_acc}",
              flush=True)
        if len(losses) != CNN_PROTOCOL_STEPS:
            fail(f"{name} ran {len(losses)} steps, wanted "
                 f"{CNN_PROTOCOL_STEPS}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"{name}'s loss is not finite: {losses}")
        if len(result.test_acc) != 1:
            fail(f"{name} was not evaluated: {result.test_acc}")
        out[name] = row
    return out


# ---------------------------------------------------------------------------
# Global sampling: LDS, MAP-EM and the vectorized planner engine on the card
# ---------------------------------------------------------------------------

# benchmarks/fig3_sampling_time.py's planner K-sweep (its ``_sweep_pop``):
# UGS at B = 128 over ~16-24 samples a client, LDS at B = 256 over ~20-30
PLAN_SWEEP_KS = (4096, 16384, 65536)
PLAN_SWEEP = {"ugs": dict(per=16, b=128, seed_of=lambda k: k),
              "lds": dict(per=20, b=256, seed_of=lambda k: k + 1,
                          delta=1.0)}
# the numpy backend beside it on the same host (large-K numpy LDS takes
# minutes)
PLAN_NUMPY_KS = {"ugs": (4096, 16384), "lds": (4096,)}
# fig3's ``_SPARSE_SWEEP``, BENCH_plan.json's two largest cells:
# K -> (lo, hi, B) of ``_edge_pop``
PLAN_SPARSE = {262_144: (1, 4, 2048), 1_000_000: (1, 4, 8192)}
# benchmarks/table4_tpe.py's populations, quick grid
TABLE4_KS = (16, 128)
TABLE4_PS = (0.1, 0.3)
TABLE4_DELTAS = (0.0, 1.5)
TABLE4_B = 128
TABLE4_BASE_MS = 60.0
# first-step proportionality: mean counts over PLAN_DIST_SEEDS plans of a
# small population within PLAN_DIST_SE standard errors of B·D_k/D; a
# planner fed proportions skewed by PLAN_DIST_SKEW must fail it
PLAN_DIST_SEEDS = 64
PLAN_DIST_SE = 4.0
PLAN_DIST_SKEW = 0.1
EM_PI_ATOL = 1e-3               # float32 EM on the card against float64
CNN_LDS_CLIENTS = 4096


def sweep_pop(k: int, per: int, seed: int = 0, m: int = 10):
    """fig3's ``_sweep_pop``: D_k ~ per + U(0, per/2), mildly non-IID."""
    import numpy as np
    from repro_torch.core.types import ClientPopulation
    rng = np.random.default_rng(seed)
    sizes = np.full(k, per, np.int64) + rng.integers(0, max(per // 2, 1), k)
    major = rng.integers(0, m, k)
    counts = np.zeros((k, m), np.int64)
    probs = np.full((m, m), 0.05) + np.eye(m) * 0.50
    probs /= probs.sum(axis=1, keepdims=True)
    for i in range(k):
        counts[i] = rng.multinomial(sizes[i], probs[major[i]])
    return ClientPopulation(sizes, counts, np.zeros(k))


def edge_pop(k: int, lo: int, hi: int, seed: int = 0, m: int = 4):
    """fig3's ``_edge_pop``: lo..hi-1 samples a client, one class each."""
    import numpy as np
    from repro_torch.core.types import ClientPopulation
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, size=k).astype(np.int64)
    counts = np.zeros((k, m), np.int64)
    counts[np.arange(k), rng.integers(0, m, k)] = sizes
    return ClientPopulation(sizes, counts, np.zeros(k))


def table4_pop(k: int, seed: int):
    """table4_tpe.py's ``_pop``: 100-499 samples a client, 10 classes."""
    import numpy as np
    from repro_torch.core.types import ClientPopulation
    rng = np.random.default_rng(seed)
    sizes = rng.integers(100, 500, size=k)
    counts = np.stack([rng.multinomial(s, np.ones(10) / 10) for s in sizes])
    return ClientPopulation(counts.sum(1), counts, np.zeros(k))


def plan_cell(torch, label: str, make, pop, engine: bool, warmup: bool,
              repeat: int = 2):
    """Time ``make(counts)`` (best of ``repeat``, after an untimed warm-up
    call where ``warmup``: the first cell of each planner warms its code
    path for the larger cells after it; host clock, the card synchronized:
    the plan is on the host when it returns), hold every plan to
    ``validate_against`` and the engine's runs of one seed to one plan,
    and print seconds, round trips, EM iterations, plan bytes and the
    card's peak memory."""
    import numpy as np
    from repro_torch.core.planner import PlanCounts

    def once():
        counts = PlanCounts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plan = make(counts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        plan.validate_against(pop)
        return secs, plan, counts, torch.cuda.max_memory_allocated()

    if warmup:
        once()
    runs = [once() for _ in range(repeat)]
    secs, plan, counts, peak = min(runs, key=lambda r: r[0])
    if engine:
        for other in runs:
            if not all(np.array_equal(a, b) for a, b in zip(
                    plan_arrays(plan), plan_arrays(other[1]))):
                fail(f"{label}: two runs of one seed gave different plans")
    row = {"seconds": secs, "all_seconds": [r[0] for r in runs],
           "steps": plan.num_steps, "format": plan.format,
           "em_iterations": plan.em_iterations,
           "all_em_iterations": [r[1].em_iterations for r in runs],
           "plan_bytes": plan.plan_nbytes}
    if engine:
        row.update(rounds=counts.rounds, refreshes=counts.refreshes,
                   replans=counts.replans, em_trips=counts.em_trips,
                   syncs=counts.syncs, peak_device_bytes=peak)
        how = (f"rounds {counts.rounds}, refreshes {counts.refreshes}, "
               f"replans {counts.replans}, EM trips {counts.em_trips}, "
               f"syncs {counts.syncs}; peak device memory "
               f"{peak / 2**20:.1f} MiB")
    else:
        how = "numpy on the host"
    after = "after a warm-up" if warmup else "warmed by the first cell"
    print(f"[plan] {label}: {secs:.4f} s (best of {repeat} {after}; "
          f"{', '.join(f'{r[0]:.4f}' for r in runs)}), T "
          f"{plan.num_steps} {plan.format}, em_iterations "
          f"{plan.em_iterations} (runs: {row['all_em_iterations']}), plan "
          f"{plan.plan_nbytes} bytes; {how}",
          flush=True)
    return row, plan


def proportionality_check(torch, dev):
    """The card's UGS: first-step mean counts over PLAN_DIST_SEEDS seeds
    within PLAN_DIST_SE standard errors of B·D_k/D for every client; the
    same plans drawn from proportions skewed by PLAN_DIST_SKEW (even
    clients up, odd down) must fail it."""
    import numpy as np
    from repro_torch.core.planner import ugs_plan_torch
    from repro_torch.core.types import ClientPopulation
    b, k = 512, 8
    sizes = 100 * np.arange(1, k + 1)
    pop = ClientPopulation(sizes, sizes[:, None], np.zeros(k))
    skew = np.where(np.arange(k) % 2 == 0, 1 + PLAN_DIST_SKEW,
                    1 - PLAN_DIST_SKEW)
    planted = ClientPopulation(np.round(sizes * skew).astype(np.int64),
                               np.round(sizes * skew)[:, None].astype(
                                   np.int64), np.zeros(k))
    p = sizes / sizes.sum()
    se = np.sqrt(b * p * (1 - p) / PLAN_DIST_SEEDS)

    def worst(pop_):
        plans = [ugs_plan_torch(pop_, b, seed=s, device=dev)
                 for s in range(PLAN_DIST_SEEDS)]
        for plan in plans:
            plan.validate_against(pop_)
        got = np.mean([plan.local_batch_sizes[0] for plan in plans], axis=0)
        return float(np.max(np.abs(got - b * p) / se))

    ok, bad = worst(pop), worst(planted)
    print(f"[plan] UGS first-step proportionality over {PLAN_DIST_SEEDS} "
          f"seeds (K {k}, B {b}): worst |mean - B D_k/D| {ok:.2f} "
          f"standard errors (limit {PLAN_DIST_SE}); planted "
          f"{PLAN_DIST_SKEW:.0%} skew: {bad:.2f}", flush=True)
    if not ok <= PLAN_DIST_SE:
        fail(f"the card's UGS first-step counts are {ok:.2f} standard "
             f"errors from B D_k/D")
    if not bad > PLAN_DIST_SE:
        fail(f"the proportionality check missed a {PLAN_DIST_SKEW:.0%} "
             f"skew ({bad:.2f} standard errors)")
    return {"worst_se": ok, "planted_worst_se": bad}


def straggler_check(dev):
    """Δ = 2 drains two stragglers earlier than Δ = 0 on the card's LDS
    (``tests/test_sampling.py``'s check)."""
    import numpy as np
    from repro_torch.core.planner import lds_plan_torch
    from repro_torch.core.types import ClientPopulation
    pop = ClientPopulation.homogeneous(8, 200, 10, seed=17)
    pop.delays[:] = 0.0
    pop.delays[:2] = 500.0

    def depletion(delta):
        plan = lds_plan_torch(pop, 64, delta=delta, seed=5, device=dev)
        plan.validate_against(pop)
        cum = plan.local_batch_sizes[:, :2].cumsum(0)
        return float(np.mean([np.argmax(cum[:, j] >= pop.dataset_sizes[j])
                              for j in range(2)]))

    d0, d2 = depletion(0.0), depletion(2.0)
    print(f"[plan] LDS stragglers deplete at step {d2} under delta 2, "
          f"{d0} under delta 0", flush=True)
    if not d2 < d0:
        fail(f"stragglers did not deplete earlier under delta 2 ({d2} "
             f"against {d0})")
    return {"delta0_step": d0, "delta2_step": d2}


def em_check(torch, dev, pop):
    """``em_map_torch`` on the card against the numpy ``em_map`` on π."""
    import numpy as np
    from repro_torch.core.em import em_map, em_map_torch
    from repro_torch.core.sampling import initialize_concentration
    nu = pop.class_counts.sum(0).astype(np.float64)
    alpha = initialize_concentration(pop, 1.0)
    pi0 = np.full(pop.num_clients, 1 / pop.num_clients)
    want = em_map(nu, pi0, pop.class_distributions, alpha)
    pi, iters, conv = em_map_torch(nu, pi0, pop.class_distributions, alpha,
                                   device=dev)
    err = float(np.abs(pi.cpu().numpy() - want.pi).max())
    print(f"[plan] em_map_torch on the card (K {pop.num_clients}): "
          f"{iters} iterations (numpy {want.iterations}), converged "
          f"{conv}, max |pi - numpy pi| {err:.3e} (limit {EM_PI_ATOL})",
          flush=True)
    if not err <= EM_PI_ATOL:
        fail(f"em_map_torch is {err} from the numpy em_map")
    return {"max_abs_err": err, "iterations": iters,
            "numpy_iterations": want.iterations}


def plan_arrays(plan):
    if plan.format == "sparse":
        return (plan.step_offsets, plan.client_ids, plan.draw_counts)
    return (plan.local_batch_sizes,)


def inactive_check(dev, pop):
    """Clients that hold no data are inactive for the planners: with every
    8th client of ``pop`` emptied, the card's UGS and LDS plans stay
    valid epochs (so they never draw an empty client) and LDS gives the
    empty clients π = 0."""
    import numpy as np
    from repro_torch.core.planner import lds_plan_torch, ugs_plan_torch
    from repro_torch.core.types import ClientPopulation
    empty = np.arange(pop.num_clients) % 8 == 0
    counts = np.where(empty[:, None], 0, pop.class_counts)
    holed = ClientPopulation(counts.sum(1), counts, pop.delays)
    ugs_plan_torch(holed, 256, seed=2, device=dev).validate_against(holed)
    lds = lds_plan_torch(holed, 256, delta=1.0, seed=2, device=dev)
    lds.validate_against(holed)
    pi0 = lds.pi_history[0]
    print(f"[plan] {int(empty.sum())} of {pop.num_clients} clients hold no "
          f"data: UGS and LDS plans valid, LDS pi on them "
          f"{float(pi0[empty].max())}, pi sums to {pi0.sum():.6f}",
          flush=True)
    if pi0[empty].any():
        fail("LDS gave clients without data a share of pi")
    return {"empty_clients": int(empty.sum())}


def same_plans(dense, sparse, what: str) -> None:
    import numpy as np
    for t in range(dense.num_steps):
        ids, cnts = sparse.step_segments(t)
        row = dense.local_batch_sizes[t]
        if not (np.array_equal(ids, np.flatnonzero(row))
                and np.array_equal(cnts, row[row > 0])):
            fail(f"{what}: dense and sparse plans differ at step {t}")
    if dense.em_iterations != sparse.em_iterations:
        fail(f"{what}: em_iterations {dense.em_iterations} (dense) and "
             f"{sparse.em_iterations} (sparse)")


def plan_phase(torch, dev):
    """``[plan]``: the vectorized planner on the card at full size (module
    docstring, phase 11)."""
    from repro_torch.core.planner import lds_plan_torch, ugs_plan_torch
    from repro_torch.core.sampling import lds_plan, ugs_plan
    from repro_torch.core.straggler import assign_delays, simulate_tpe
    t_phase = time.perf_counter()
    x = torch.tensor([0, 3, 0, 5], device=dev)
    try:
        torch.nonzero_static(x, size=4, fill_value=-1)
        nz = "runs"
    except (AttributeError, NotImplementedError, RuntimeError) as e:
        nz = f"fails ({type(e).__name__})"
    print(f"[plan] torch.nonzero_static on CUDA {nz}; sparse steps compact "
          f"by cumsum + scatter", flush=True)
    out = {"sweep": {}, "sparse": {}, "table4": {}}
    for method, cfg in PLAN_SWEEP.items():
        for k in PLAN_SWEEP_KS:
            pop = sweep_pop(k, cfg["per"], seed=cfg["seed_of"](k))
            b = cfg["b"]
            extra = {"delta": cfg["delta"]} if method == "lds" else {}
            engine = ugs_plan_torch if method == "ugs" else lds_plan_torch
            label = f"{method} K={k} B={b}"
            row, plan = plan_cell(
                torch, f"{label} engine",
                lambda c: engine(pop, b, seed=1, device=dev, counts=c,
                                 **extra), pop, engine=True,
                warmup=k == PLAN_SWEEP_KS[0])
            cell = {"engine": row}
            if k == PLAN_SWEEP_KS[0]:
                sparse = engine(pop, b, seed=1, device=dev,
                                plan_format="sparse", **extra)
                sparse.validate_against(pop)
                same_plans(plan, sparse, f"{label} on the card")
                print(f"[plan] {label}: dense and sparse plans of seed 1 "
                      f"bit-identical on the card", flush=True)
                if method == "lds":
                    out["em"] = em_check(torch, dev, pop)
                    out["inactive"] = inactive_check(dev, pop)
            del plan
            if k in PLAN_NUMPY_KS[method]:
                host = ugs_plan if method == "ugs" else lds_plan
                cell["numpy"], _ = plan_cell(
                    torch, f"{label} numpy",
                    lambda c: host(pop, b, seed=1, **extra), pop,
                    engine=False, warmup=k == PLAN_NUMPY_KS[method][0])
                print(f"[plan] {label}: engine seconds / numpy seconds "
                      f"{row['seconds'] / cell['numpy']['seconds']:.3f}",
                      flush=True)
            out["sweep"][label] = cell
            gc.collect()
            torch.cuda.empty_cache()
    for i, (k, (lo, hi, b)) in enumerate(PLAN_SPARSE.items()):
        pop = edge_pop(k, lo, hi, seed=k % 7919)
        row, _ = plan_cell(
            torch, f"ugs K={k} B={b} engine",
            lambda c: ugs_plan_torch(pop, b, seed=1, device=dev,
                                     plan_format="sparse", counts=c),
            pop, engine=True, warmup=i == 0)
        row["dense_plan_bytes"] = row["steps"] * k * 8
        out["sparse"][f"ugs K={k} B={b}"] = row
    for k in TABLE4_KS:
        pop = table4_pop(k, seed=k)
        for ps in TABLE4_PS:
            pop.delays[:] = assign_delays(k, ps, 100, 500,
                                          seed=k * 7 + int(ps * 10))
            for name, planner in (("numpy", lds_plan),
                                  ("engine", lds_plan_torch)):
                kw = {"device": dev} if name == "engine" else {}
                tpe = {}
                for delta in TABLE4_DELTAS:
                    plan = planner(pop, TABLE4_B, delta=delta, seed=0, **kw)
                    plan.validate_against(pop)
                    tpe[delta] = simulate_tpe(plan.local_batch_sizes,
                                              pop.delays,
                                              TABLE4_BASE_MS).total_ms
                red = 100 * (1 - tpe[TABLE4_DELTAS[-1]] / tpe[0.0])
                print(f"[plan] table4 K={k} ps={ps} {name}: TPE "
                      f"{', '.join(f'delta {d} {v / 1e3:.2f} s' for d, v in tpe.items())}; "
                      f"reduction {red:.1f}%", flush=True)
                out["table4"][f"K={k},ps={ps},{name}"] = {
                    "tpe_ms": {str(d): v for d, v in tpe.items()},
                    "reduction_pct": red}
    out["proportionality"] = proportionality_check(torch, dev)
    out["stragglers"] = straggler_check(dev)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[plan] phase {out['seconds']:.1f} s", flush=True)
    return out


def plan_clock():
    """A callback reading each epoch's planning: host seconds from
    ``epoch_begin`` to the ``plan`` event (the engine's plan is on the
    host by then), the plan's steps, format and EM iterations; the plan
    is held to ``validate_against``."""
    from repro_torch.api.events import Callback

    class PlanClock(Callback):
        def __init__(self):
            self.rows = []
            self._t = 0.0

        def on_event(self, event, ctx, record):
            if event.name == "epoch_begin":
                self._t = time.perf_counter()
            elif event.name == "plan" and event.plan is not None:
                p = event.plan
                p.validate_against(ctx.data.pop)
                self.rows.append({"seconds": time.perf_counter() - self._t,
                                  "steps": p.num_steps, "format": p.format,
                                  "method": p.method,
                                  "em_iterations": p.em_iterations})
    return PlanClock()


def cnn_lds_phase(torch, dev):
    """``[cnn-lds]``: one epoch of PSL-LDS (Δ 1.5) at CIFAR-10 size over
    ``CNN_LDS_CLIENTS`` clients, planned by ``backend="auto"`` — the
    vectorized engine on the card (module docstring, phase 12)."""
    from repro_torch import api
    from repro_torch.core.planner import resolve_backend
    base = cnn_spec()
    spec = base.replace(
        data=base.data.replace(num_clients=CNN_LDS_CLIENTS),
        sampler=api.SamplerSpec(method="lds", backend="auto",
                                plan_format="auto", kwargs={"delta": 1.5}))
    t0 = time.perf_counter()
    ctx = api.build_context(spec, device=dev)
    pop = ctx.data.pop
    empty = int((pop.dataset_sizes == 0).sum())
    backend = resolve_backend(spec.sampler.backend, pop.num_clients)
    print(f"[cnn-lds] built in {time.perf_counter() - t0:.2f}s: "
          f"{pop.num_clients} clients, D0 {pop.total_size}, sizes "
          f"{int(pop.dataset_sizes.min())}..{int(pop.dataset_sizes.max())}, "
          f"{empty} with no image, {int((pop.delays > 0).sum())} "
          f"stragglers; backend {spec.sampler.backend!r} -> {backend!r}",
          flush=True)
    if backend != "jax":
        fail(f"backend 'auto' at K = {pop.num_clients} resolved to "
             f"{backend!r}, not the vectorized engine")
    clock = plan_clock()
    row, result = cnn_run(torch, ctx, spec, "PSL-LDS", callbacks=[clock],
                          tag="[cnn-lds]")
    row["plan"] = clock.rows[0]
    row["em_iterations"] = result.history.extras.get("em_iterations")
    row["clients"] = pop.num_clients
    row["clients_without_data"] = empty
    print(f"[cnn-lds] plan {row['plan']['seconds']:.3f} s ("
          f"{row['plan']['method']}, {row['plan']['steps']} steps, "
          f"{row['plan']['format']}), em_iterations "
          f"{row['em_iterations']}", flush=True)
    if not row["finite"]:
        fail("the PSL-LDS epoch's loss is not finite")
    if not row["em_iterations"]:
        fail("the PSL-LDS epoch ran no EM iteration")
    if not row["test_acc"] >= CNN_MIN_TEST_ACC:
        fail(f"PSL-LDS test accuracy {row['test_acc']} < "
             f"{CNN_MIN_TEST_ACC}")
    # LDS with delta > 0 front-loads stragglers on purpose, so a batch's
    # class mix may leave the Serfling radius of uniform sampling (the
    # verdict is printed, not gated); the plan must still be a GPSL
    # epoch: fixed batch size, no over-draw, every dataset consumed
    mon = row["monitor"]
    if (mon.get("batch_size_violations") or mon.get("overdraw_violations")
            or mon.get("residual_mass") or not mon.get("complete")):
        fail(f"the GPSL monitor flagged the PSL-LDS plan: {mon}")
    return row


# ---------------------------------------------------------------------------
# [mesh]: the sharded engine on a mesh of two ranks sharing the card
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_LAYERS = 8                 # [mesh]: depth cut from 40 (cut 2)
MESH_STEPS = 3
# (mesh, profile, lowering, microbatches), on granite-3-2b
MESH_RUNS = (("2x1", "tp", "shard_map", 1), ("2x1", "tp", "gspmd", 2),
             ("1x2", "fsdp", "gspmd", 1))
MESH_CHECKPOINT_RUN = 1         # the 2x1 gspmd run writes a checkpoint
# Tensor-parallel runs, full width: (arch, layers, cut, run). Their
# row-parallel products sum partial products over the ranks, which
# changes the rounding of the products by construction, as swapping a
# kernel does; so they run at the 4 layers the gradient gate was set
# for (``grad_check_setup``). At 8 layers granite's step-0 gradient
# moves by 0.0212 (worst leaf) in one process when only its row products
# go through another exact GEMM (fp32; ``tools/tp_rounding.py`` on an
# H100), past GRAD_REL_L2: ``mesh_reference`` reads that floor for each
# run.
# falcon-mamba-7b at 4 of 64 layers and zamba2-2.7b at 8 of 54 (one
# superblock after the cut: the shared attention runs once), as
# [ssm-train]'s and [hybrid-train]'s gradient checks cut them, in float32
# (the model dtype, None: the config's bf16). In bf16 their one-process
# floors (``mesh_reference(floor=True)`` on an H100) sit at or over
# GRAD_REL_L2: the parameters after 3 AdamW steps move by 0.048
# (falcon-mamba) and 0.146 (zamba2) when only the row products' rounding
# changes (zero-init conv_b and dt_bias: AdamW's first updates are the
# signs of near-zero gradient entries), and zamba2's step-0 gradient by
# 0.0198 (the per-head a_log, dt_bias and d_skip, each a sum over every
# token, channel and state of its head); at 2 and 7 layers still 0.027
# and 0.099. In float32 they are held to MESH_REL_L2's own limits.
# granite-moe-3b-a800m at [moe-train]'s 8 of 32 layers (cut 2): 20 of
# 40 experts, 12 q and 4 kv heads a rank; whisper-tiny whole (4 encoder
# and 4 decoder layers, cut at the encoder) on [audio-grads]' batch of 8
# x (1500 frames + 128 tokens): 3 heads a rank, 768 MLP columns. Both in
# float32: their bf16 floors sit over GRAD_REL_L2 too. granite-moe's
# step-0 gradient moves by 0.087 (the router; a changed rounding flips
# 6% of the bf16 top-k assignments, each flip moving an expert's rows),
# whisper's parameters after 3 AdamW steps by 0.060 (zero-init b_in,
# whose first updates are signs); on an H100. A float32 run's bf16 floor
# is read and printed at every run (``mesh_rank_main``), and must still
# sit over the gate: a float32 run is the choice only while bf16 cannot
# pass.
MESH_TP_RUNS = (("granite-3-2b", 4, 2, None, ("1x2", "tp", "gspmd", 1)),
                ("llama3-8b", 4, 1, None, ("1x2", "tp", "gspmd", 1)),
                ("falcon-mamba-7b", 4, 2, "float32",
                 ("1x2", "tp", "gspmd", 1)),
                ("zamba2-2.7b", 8, 2, "float32",
                 ("1x2", "tp", "gspmd", 1)),
                (MOE_ARCH, MOE_TRAIN_LAYERS, 2, "float32",
                 ("1x2", "tp", "gspmd", 1)),
                (AUDIO_ARCH, 4, 0, "float32", ("1x2", "tp", "gspmd", 1)))
# Per-leaf relative L2 limits (step-0 gradient, parameters after the
# steps) against the one-card engine, by the run's dtype. bf16: GRAD_REL_L2
# for both. float32, from the float32 tp runs' own readings on an H100:
# sound, at most 6.8e-6 (gradient) and 5.7e-4 (parameters; zamba2); with
# every sum over model rounded to bf16 (``bf16_sums``, which each run
# must fail), at least 5.7e-3 and 3.2e-2 (falcon-mamba). Each limit is
# the geometric mean of the two, to one digit: about 29x over the sound
# gradient and 28x under the control, 7x and 8x for the parameters.
MESH_REL_L2 = {"bfloat16": (GRAD_REL_L2, GRAD_REL_L2),
               "float32": (2e-4, 4e-3)}
MESH_SKIP_RUN = 0               # granite tp 1x2: rank 0 skips a reduce
MESH_NORM_SKIP_RUN = 3          # zamba2 tp 1x2: rank 0's norm, unsummed
MESH_COMBINE_SKIP_RUN = 4       # granite-moe tp 1x2: rank 0's combine
GRAD_NORM_BYTES = 4             # the gradient norm's all-reduce a step
MESH_LOSS_RTOL = 1e-2           # per-step loss against the one-card run
MESH_PG_TIMEOUT_S = 180         # a collective that waits longer fails
MESH_CHILD_TIMEOUT_S = 600      # a rank that runs longer is killed


def _tree_bytes(tree) -> int:
    from repro_torch.models.layers import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _worst(rels):
    worst, value, median = grad_spread(rels)
    return {"worst_leaf": worst, "worst": value, "median": median}


def tp_all_reduce_bytes(elements: int, itemsize: int, layers: int,
                        vocab_parallel: bool) -> int:
    """The activation all-reduce bytes a step of tensor parallelism over
    ``model``, in (tokens, d_model) activations of ``elements``, all in
    fp32 but the embedding's: a dense layer's two row-parallel outputs
    (``wo``, ``w_down``) forward and its five column-parallel products'
    input gradients (q, k, v, gate, up) backward; with the vocab split,
    the embedding's rows (in the model's ``itemsize``) and the head's dh."""
    return (elements * layers * 7 * 4
            + (elements * (itemsize + 4) if vocab_parallel else 0))


def tp_mixer_all_reduce_bytes(cfg, tokens: int, layers: int, attention: int,
                              vocab_parallel: bool, itemsize: int) -> int:
    """``tp_all_reduce_bytes`` for ``layers`` Mamba layers of an SSM or
    hybrid config and ``attention`` shared-attention applications, all in
    fp32 but the embedding's: a Mamba layer's out_proj sum forward and its
    input's dx backward (``tokens`` x d_model each) and its other sum both
    ways (Mamba-1's x_proj, r + 2N wide; Mamba-2's sum of squares, 1
    wide); a shared-attention application its q, k, v dx and ``wo``; with
    the vocab split, the embedding's rows and the head's dh."""
    elements = tokens * cfg.d_model
    width = (cfg.dt_rank + 2 * cfg.ssm_state
             if cfg.ssm_variant == "mamba1" else 1)
    return (layers * (elements * 2 * 4 + tokens * width * 2 * 4)
            + attention * elements * 4 * 4
            + (elements * (itemsize + 4) if vocab_parallel else 0))


def tp_moe_all_reduce_bytes(cfg, tokens: int, layers: int, attention: bool,
                            vocab_parallel: bool, itemsize: int) -> int:
    """``tp_all_reduce_bytes`` for ``layers`` MoE layers with the experts
    split over ``model``, all in fp32 but the embedding's: with
    ``attention`` (its heads split) a layer's q, k, v input gradients and
    its ``wo`` sum; the experts' combine forward and the dispatch input's
    gradient backward (``tokens`` x d_model each) and the gate values'
    gradient (``tokens`` x k); a shared expert's gate and up input
    gradients and its ``w_down`` sum; with the vocab split, the
    embedding's rows and the head's dh."""
    elements = tokens * cfg.d_model
    per_layer = (elements * (2 + 4 * attention
                             + 3 * cfg.moe_shared_expert) * 4
                 + tokens * cfg.experts_per_token * 4)
    return (layers * per_layer
            + (elements * (itemsize + 4) if vocab_parallel else 0))


def tp_audio_all_reduce_bytes(cfg, frames: int, tokens: int,
                              attention: bool, vocab_parallel: bool,
                              itemsize: int) -> int:
    """``tp_all_reduce_bytes`` for whisper's encoder (``frames`` rows a
    step) and decoder (``tokens`` rows), all in fp32 but the embedding's:
    an encoder layer's MLP input gradient and ``w_out`` sum, and with
    ``attention`` (its heads split) its q, k, v input gradients and
    ``wo`` sum, over ``frames`` x d_model; a decoder layer's MLP pair,
    and with ``attention`` its self-attention's four and the
    cross-attention's q input gradient and ``wo`` sum over ``tokens`` x
    d_model, and the cross-attention's k and v input gradients over
    ``frames`` x d_model (onto the encoder states, the PSL cut); with the
    vocab split, the embedding's rows and the head's dh."""
    enc, dec = frames * cfg.d_model, tokens * cfg.d_model
    return (cfg.encoder_layers * enc * (2 + 4 * attention) * 4
            + cfg.num_layers * (dec * (2 + 6 * attention)
                                + enc * 2 * attention) * 4
            + (dec * (itemsize + 4) if vocab_parallel else 0))


def tp_partial_grad_bytes(cfg, layers: int) -> int:
    """The fp32 gradient sums over ``model`` a step of the Mamba leaves a
    rank computes whole and slices (``tensor_parallel``'s "partial"
    mode): Mamba-1's in_proj; Mamba-2's in_proj, conv_w, conv_b, a_log,
    dt_bias and d_skip. 4 bytes an element, once a step."""
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if cfg.ssm_variant == "mamba1":
        per_layer = d * 2 * di
    else:
        nh = cfg.ssm_num_heads
        per_layer = (d * (2 * di + 2 * n + nh) + (di + 2 * n) * (k + 1)
                     + 3 * nh)
    return layers * per_layer * 4


def mesh_setup(api, dev, layers: int, cut: int, arch=None, dtype=None):
    """The ``[train]`` setting's context at ``layers`` layers (cut
    ``cut``; granite-3-2b unless ``arch``; the config's dtype unless
    ``dtype``) and its first ``MESH_STEPS`` plan batches; for the audio
    family, ``audio_mesh_batches``."""
    import itertools
    from repro_torch.api.protocols import lm_plan_batches
    from repro_torch.core.sampling import make_plan
    from repro_torch.launch.distributed import assign_clients_to_shards
    from repro_torch.launch.train import default_lm_spec
    sets = [f"model.overrides.num_layers={layers}",
            f"model.overrides.cut_layer={cut}"]
    if arch:
        sets.append(f"model.arch={arch}")
    if dtype:
        sets.append(f"model.overrides.dtype={dtype}")
    spec = api.apply_overrides(default_lm_spec(), sets)
    ctx = api.build_context(spec, device=dev)
    if ctx.model.cfg.family == "audio":
        return ctx, audio_mesh_batches(ctx.model.cfg, spec.seed)
    plan = make_plan(spec.sampler.method, ctx.data.pop,
                     spec.protocol.global_batch_size, seed=spec.seed)
    hosts = list(itertools.islice(lm_plan_batches(
        ctx.data.lm_data, ctx.data.pop, plan, spec.data.seq_len,
        spec.protocol.aggregation,
        assign_clients_to_shards(len(ctx.data.lm_data), MESH_RANKS),
        seed=spec.seed), MESH_STEPS))
    return ctx, hosts


def audio_mesh_batches(cfg, seed: int):
    """``MESH_STEPS`` host batches (numpy, from ``seed``) of
    ``AUDIO_GRADS``' shape: frames (B, T_enc, d) at std 1, random tokens
    and labels, every weight 1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b, s = AUDIO_GRADS["batch"], AUDIO_GRADS["seq"]
    out = []
    for _ in range(MESH_STEPS):
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
        out.append({"frames": rng.standard_normal(
                        (b, cfg.encoder_seq, cfg.d_model), np.float32),
                    "tokens": toks[:, :s].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32),
                    "weights": np.ones((b, s), np.float32)})
    return out


@contextlib.contextmanager
def routed_experts():
    """Inside: the experts every MoE layer routes each token to (the top
    k of ``layers.top_k_stable``, (T, k) a call), appended to the yielded
    list in call order."""
    from repro_torch.models import layers as L
    top_k, picked = L.top_k_stable, []

    def recorded(x, k):
        vals, idx = top_k(x, k)
        picked.append(idx.detach())
        return vals, idx
    L.top_k_stable = recorded
    try:
        yield picked
    finally:
        L.top_k_stable = top_k


def routing_flips(got, want) -> dict:
    """Assignments (token, k-th pick) whose expert differs between two
    runs' ``routed_experts`` lists, and tokens whose set of experts
    differs, over every layer."""
    import torch
    picks = tokens = 0
    for a, b in zip(got, want, strict=True):
        picks += int((a != b).sum())
        tokens += int((torch.sort(a, dim=-1).values
                       != torch.sort(b, dim=-1).values).any(-1).sum())
    return {"assignments": picks, "tokens": tokens,
            "of": sum(a.numel() for a in want)}


@contextlib.contextmanager
def fp32_row_products():
    """The row-parallel products (``wo``, ``w_down``; the Mamba mixers'
    ``out_proj`` and Mamba-1's ``x_proj``) of one process through an fp32
    GEMM of their 16-bit inputs, rounded once: exact as the 16-bit GEMM's
    fp32 sums are, in another order."""
    import torch
    from repro_torch.launch import tensor_parallel as tpl
    row_parallel, mixer_hooks = tpl.row_parallel, tpl.mixer_hooks

    def fp32(a, w):
        return torch.matmul(a.float(), w.float()).to(a.dtype)
    tpl.row_parallel = lambda part: fp32
    tpl.mixer_hooks = lambda cfg: (
        {"row": fp32} if cfg.ssm_variant == "mamba2"
        else {"row": fp32, "inner": fp32})
    try:
        yield
    finally:
        tpl.row_parallel, tpl.mixer_hooks = row_parallel, mixer_hooks


def mesh_reference(torch, ctx, hosts, floor=False):
    """The one-card engine on ``hosts`` from the fan-in d_in init: (the
    reference: step-0 gradient and the parameters after the steps; the
    losses and stored bytes). With ``floor``, also how far its step-0
    gradient and its parameters after the steps move when only the
    rounding of its row products changes (``fp32_row_products``): no
    tensor-parallel run can be held closer. An MoE model's routed
    experts of the step-0 gradient are kept (``routed_experts``) for the
    runs' routing flips."""
    from repro_torch.launch.distributed import ShardedPSLEngine
    eng = ShardedPSLEngine(ctx.model, ctx.optimizer, mesh="1x1",
                           device=ctx.device)

    def init():
        st = eng.init_state(ctx.seed)
        rescale_to_fan_in(torch, st.params, ctx.model.param_specs())
        return st
    st = init()
    torch.cuda.reset_peak_memory_stats()
    with routed_experts() as picked:
        ref = {"grads": eng.grads(st, eng.put_batch(hosts[0]))}
    ref["experts"] = picked
    floor_rel = None
    if floor:
        with fp32_row_products():
            moved = eng.grads(st, eng.put_batch(hosts[0]))
        floor_rel = {"grads": _worst(leaf_rel_l2(moved, ref["grads"]))}
        del moved
    losses, step_ms = [], []
    for h in hosts:
        b = eng.put_batch(h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = eng.step(st, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    one = {"losses": losses, "step_ms": step_ms,
           "param_bytes": _tree_bytes(st.params),
           "moment_bytes": _tree_bytes({k: v for k, v in
                                        st.opt_state.items()
                                        if k in ("mu", "m", "v")}),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    ref["params"] = st.params
    del st
    if floor:
        moved = init()
        with fp32_row_products():
            for h in hosts:
                moved, _ = eng.step(moved, eng.put_batch(h))
        floor_rel["params"] = _worst(leaf_rel_l2(moved.params,
                                                 ref["params"]))
        del moved
    one["fp32_row_products"] = floor_rel
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return ref, one


@contextlib.contextmanager
def skipped_reduce(rank: int):
    """A planted fault: on rank ``rank``, the first row-parallel product
    (``tensor_parallel.row_parallel`` of the attention or the MLP) runs
    its all-reduce but the rank goes on with its own partial product.
    Every rank still takes part in every collective, so the ranks stay in
    step. Yields the list of skipped parts."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import tensor_parallel as tpl
    row_parallel, skipped = tpl.row_parallel, []

    def planted(part):
        product = row_parallel(part)
        if product is torch.matmul:
            return product

        def once(a, w):
            y = product(a, w)
            if dist.get_rank() == rank and not skipped:
                skipped.append(part)
                return torch.matmul(a, w)
            return y
        return once
    tpl.row_parallel = planted
    try:
        yield skipped
    finally:
        tpl.row_parallel = row_parallel


@contextlib.contextmanager
def skipped_norm_reduce(rank: int):
    """A planted fault: on rank ``rank``, the first Mamba-2 norm over the
    whole ``d_inner`` (``tensor_parallel.rms_norm_over_model``) runs its
    all-reduce both ways but normalizes by the rank's own sum of
    squares. Every rank still takes part in every collective, so the
    ranks stay in step. Yields the list of skipped norms."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import tensor_parallel as tpl
    norm, skipped = tpl.rms_norm_over_model, []

    def planted(x, weight, eps, width, tp):
        if dist.get_rank() != rank or skipped:
            return norm(x, weight, eps, width, tp)
        skipped.append("norm")
        xf = x.float()
        local = (xf * xf).sum(dim=-1, keepdim=True)
        ss = local + 0 * tpl.SumOverModel.apply(local, tp)
        y = xf * torch.rsqrt(ss / width + eps)
        return (y * weight.float()).to(x.dtype)
    tpl.rms_norm_over_model = planted
    try:
        yield skipped
    finally:
        tpl.rms_norm_over_model = norm


@contextlib.contextmanager
def skipped_combine(rank: int):
    """A planted fault: on rank ``rank``, the first MoE combine
    (``tensor_parallel.ExpertParallel.combine``) runs its all-reduce but
    the rank goes on with its own experts' partial output. Every rank
    still takes part in every collective, so the ranks stay in step.
    Yields the list of skipped combines."""
    import torch.distributed as dist
    from repro_torch.launch.tensor_parallel import ExpertParallel
    combine, skipped = ExpertParallel.combine, []

    def planted(self, part):
        out = combine(self, part)
        if dist.get_rank() == rank and not skipped:
            skipped.append("combine")
            return part
        return out
    ExpertParallel.combine = planted
    try:
        yield skipped
    finally:
        ExpertParallel.combine = combine


@contextlib.contextmanager
def bf16_sums():
    """A planted fault: every sum over ``model`` of the tensor-parallel
    compute (``TensorParallel.all_reduce``: the activations' sums both
    ways, not the leaves' gradient sums) is rounded to bf16, as a tp path
    whose fp32 sums were taken in bf16 would be."""
    import torch
    from repro_torch.launch.tensor_parallel import TensorParallel
    all_reduce = TensorParallel.all_reduce

    def rounded(self, t):
        return all_reduce(self, t).to(torch.bfloat16).to(t.dtype)
    TensorParallel.all_reduce = rounded
    try:
        yield
    finally:
        TensorParallel.all_reduce = all_reduce


def mesh_rank_run(torch, ctx, hosts, ref, run_spec, work: pathlib.Path, *,
                  planted_unreduced=False, planted_skip=False,
                  planted_norm=False, planted_combine=False,
                  planted_bf16=False, checkpoint=False):
    """One run (``run_spec``: mesh, profile, lowering, microbatches) on this
    rank (the ``[mesh]`` phase's child): the sharded engine from the
    seeded init rescaled to fan-in d_in, its step-0 gradient (with
    ``planted_unreduced``, rank 0 also computes its own unreduced
    gradient; with ``planted_skip``, every rank computes the step-0
    gradient again while rank 0 skips one row-parallel all-reduce; with
    ``planted_norm``, while rank 0 normalizes one Mamba-2 norm by its own
    sum of squares; with ``planted_combine``, while rank 0 skips one MoE
    combine's sum; an MoE run's routing flips against the one-card run,
    ``routing_flips``), ``MESH_STEPS`` steps with the launches counted by
    shape, keys and causality and dtype, collectives timed (the bytes of the gradient sums
    over ``model`` apart), peak memory, the parameters gathered after; a
    ``checkpoint`` run saves and restores. With ``planted_bf16``, the run
    is made again from the same init with every sum over ``model``
    rounded to bf16 (``bf16_sums``): its step-0 gradient and parameters
    after."""
    import torch.distributed as dist
    from repro_torch.checkpoint import restore, save
    from repro_torch.core.psl import fused_grads, requires_grad_
    from repro_torch.kernels import ops
    from repro_torch.launch.distributed import ShardedPSLEngine
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.models.layers import tree_leaves
    mesh_spec, profile, lowering, mb = run_spec
    model, specs, dev = ctx.model, ctx.model.param_specs(), ctx.device
    mesh = make_training_mesh(mesh_spec, dev)
    eng = ShardedPSLEngine(model, ctx.optimizer, mesh=mesh, profile=profile,
                           lowering=lowering, microbatches=mb, device=dev,
                           time_collectives=True)
    tp = eng.tp
    st = eng.init_state(ctx.seed)
    rescale_to_fan_in(torch, st.params, specs)
    batches = [eng.put_batch(h) for h in hosts]
    cfg = model.cfg
    ssm = cfg.family in ("ssm", "hybrid")
    # B1 a step: a decoder layer's self- and cross-attention, an encoder
    # layer's; the hybrid's shared-attention applications
    attention = {"ssm": 0, "hybrid": getattr(model, "n_super", 0),
                 "audio": cfg.encoder_layers + 2 * cfg.num_layers}
    run = {"arch": cfg.name, "mesh": mesh_spec, "profile": profile,
           "lowering": lowering, "microbatches": mb,
           "dtype": dtype_name(cfg.torch_dtype),
           "family": cfg.family, "ssm_variant": cfg.ssm_variant,
           "mamba_layers": cfg.num_layers if ssm else 0,
           "attention_layers": attention.get(cfg.family, cfg.num_layers),
           "rows": int(batches[0]["tokens"].shape[0]),
           "activation": [int(batches[0]["tokens"].numel())
                          * model.cfg.d_model, torch.empty(
                              (), dtype=model.cfg.torch_dtype).element_size()],
           "frames": (int(batches[0]["frames"].shape[0]
                          * batches[0]["frames"].shape[1])
                      if "frames" in batches[0] else 0),
           "shards": batches[0].shards, "fallbacks": eng.report.fallbacks,
           "tensor_parallel": None if tp is None else {
               "heads": tp.heads, "kv_heads": tp.kv_heads, "ff": tp.ff,
               "channels": tp.channels, "ssm_heads": tp.ssm_heads,
               "experts": tp.experts, "shared_ff": tp.shared_ff,
               "embed_vocab": tp.embed_vocab, "head_vocab": tp.head_vocab,
               "partial_leaves": sum(
                   m == "partial" for m in tp.modes)}}
    with routed_experts() as picked:
        grads = eng.grads(st, batches[0])
    if ref is not None:
        run["grads"] = _worst(leaf_rel_l2(grads, ref["grads"]))
        if picked:
            run["routing_flips"] = routing_flips(picked, ref["experts"])
    del grads, picked
    if ref is not None and planted_unreduced:
        whole = requires_grad_(eng.gather_params(st.params))
        local = fused_grads(model, whole, batches[0], mb)[0]
        run["planted_unreduced"] = _worst(leaf_rel_l2(local, ref["grads"]))
        del whole, local
    if planted_skip:
        with skipped_reduce(0) as skipped:
            faulty = eng.grads(st, batches[0])
        if ref is not None:
            run["planted_skipped_reduce"] = {
                "skipped": skipped,
                **_worst(leaf_rel_l2(faulty, ref["grads"]))}
        del faulty
    if planted_norm:
        with skipped_norm_reduce(0) as skipped:
            faulty = eng.grads(st, batches[0])
        if ref is not None:
            run["planted_skipped_norm"] = {
                "skipped": skipped,
                **_worst(leaf_rel_l2(faulty, ref["grads"]))}
        del faulty
    if planted_combine:
        with skipped_combine(0) as skipped:
            faulty = eng.grads(st, batches[0])
        if ref is not None:
            run["planted_skipped_combine"] = {
                "skipped": skipped,
                **_worst(leaf_rel_l2(faulty, ref["grads"]))}
        del faulty
    gc.collect()
    torch.cuda.empty_cache()
    # the gradient sums over model (the leaves computed whole) by kind
    grad_bytes = {"all_reduce": 0, "reduce_scatter": 0}
    reduce_scatter = eng.comm.reduce_scatter_leaf

    def counted(full, layout, axes):
        before = {k: eng.comm.stats[k]["bytes"] for k in grad_bytes}
        out = reduce_scatter(full, layout, axes)
        if "model" in axes:
            for k in grad_bytes:
                grad_bytes[k] += eng.comm.stats[k]["bytes"] - before[k]
        return out
    eng.comm.reduce_scatter_leaf = counted
    eng.comm.reset_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recorder = record_train_shapes(keys=True)
    step_ms, metrics = [], []
    try:
        for b in batches:
            t0 = time.perf_counter()
            st, m = eng.step(st, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
    finally:
        shapes = recorder.stop()
        eng.comm.reduce_scatter_leaf = reduce_scatter
    run.update({
        "step_ms": step_ms, "metrics": metrics,
        "launches": ops.launch_counts(),
        "shapes": {k: [[list(s), n] for s, n in v.items()]
                   for k, v in shapes.items() if v},
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "collectives": {k: dict(v) for k, v in eng.comm.stats.items()},
        "partial_grad_bytes": dict(grad_bytes),
        "param_bytes": _tree_bytes(st.params),
        "moment_bytes": _tree_bytes({k: v for k, v in st.opt_state.items()
                                     if k in ("mu", "m", "v")})})
    whole = eng.gather_params(st.params)
    if ref is not None:
        run["params"] = _worst(leaf_rel_l2(whole, ref["params"]))
    if checkpoint:
        path = work / "mesh_ckpt.npz"
        save(str(path), st.params, mesh=mesh, layouts=eng.param_layouts)
        dist.barrier()
        if eng.comm.coord == {"data": 0, "model": 0}:
            back = restore(str(path), dev)
            run["checkpoint_bitwise"] = all(
                torch.equal(a, b.detach()) for a, b in zip(
                    tree_leaves(back), tree_leaves(whole), strict=True))
            del back
            path.unlink()
        dist.barrier()
    del st, whole
    if planted_bf16:
        gc.collect()
        torch.cuda.empty_cache()
        st = eng.init_state(ctx.seed)
        rescale_to_fan_in(torch, st.params, specs)
        with bf16_sums():
            faulty = eng.grads(st, batches[0])
            for b in batches:
                st, _ = eng.step(st, b)
        whole = eng.gather_params(st.params)
        if ref is not None:
            run["planted_bf16_sums"] = {
                "grads": _worst(leaf_rel_l2(faulty, ref["grads"])),
                "params": _worst(leaf_rel_l2(whole, ref["params"]))}
        del st, faulty, whole
    del eng, batches
    gc.collect()
    torch.cuda.empty_cache()
    return run


def mesh_rank_main(rank: int, workdir: str) -> int:
    """A rank of the ``[mesh]`` phase (``chip_smoke.py --mesh-rank R
    WORKDIR``): joins the ``MESH_RANKS``-rank group through a ``file://``
    store in WORKDIR (the backend the rule picks: gloo, as the ranks share
    the card), builds full-width granite-3-2b at ``MESH_LAYERS`` layers and
    the ``[train]`` setting's first ``MESH_STEPS`` plan batches; rank 0
    first runs the one-card engine on them (``mesh_reference``); then
    every ``MESH_RUNS`` entry (``mesh_rank_run``). Then each of
    ``MESH_TP_RUNS`` alike, at its own arch, depth and dtype; for a
    float32 run rank 0 also reads the bf16 floor (the config's own
    dtype, which that floor ruled out). Writes ``rank<R>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.launch.mesh import init_process_group, rank_device
    work = pathlib.Path(workdir)
    dev = rank_device("cuda")
    backend = init_process_group(
        dev, init_method=f"file://{work / 'pg'}", rank=rank,
        world_size=MESH_RANKS, timeout_s=MESH_PG_TIMEOUT_S)
    out = {"rank": rank, "backend": backend, "device": str(dev),
           "runs": [], "tp_runs": []}
    ctx, hosts = mesh_setup(api, dev, MESH_LAYERS, 2)
    ref = None
    if rank == 0:
        ref, out["one_card"] = mesh_reference(torch, ctx, hosts)
    for i, run_spec in enumerate(MESH_RUNS):
        out["runs"].append(mesh_rank_run(
            torch, ctx, hosts, ref, run_spec, work,
            planted_unreduced=i == 0, checkpoint=i == MESH_CHECKPOINT_RUN))
    for i, (arch, layers, cut, dtype, run_spec) in enumerate(MESH_TP_RUNS):
        del ctx, hosts, ref
        gc.collect()
        torch.cuda.empty_cache()
        ctx, hosts = mesh_setup(api, dev, layers, cut, arch, dtype)
        ref, one = None, None
        if rank == 0:
            ref, one = mesh_reference(torch, ctx, hosts, floor=not dtype)
            if dtype:           # the bf16 floor that chose this dtype
                bf16, bf16_hosts = mesh_setup(api, dev, layers, cut, arch,
                                              "bfloat16")
                one["fp32_row_products"] = mesh_reference(
                    torch, bf16, bf16_hosts, floor=True)[1][
                        "fp32_row_products"]
                del bf16, bf16_hosts
        run = mesh_rank_run(torch, ctx, hosts, ref, run_spec, work,
                            planted_skip=i == MESH_SKIP_RUN,
                            planted_norm=i == MESH_NORM_SKIP_RUN,
                            planted_combine=i == MESH_COMBINE_SKIP_RUN,
                            planted_bf16=dtype == "float32")
        run["one_card"] = one
        out["tp_runs"].append(run)
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_gates(tag, runs, one) -> None:
    """Print one run of every rank and hold it to the one-card engine
    (``one``): the step-0 gradient and the parameters after per leaf
    within ``MESH_REL_L2``'s limits for the run's dtype (a planted fault
    outside them; the float32 runs' sums over ``model`` rounded to bf16
    outside both), the losses within ``MESH_LOSS_RTOL``, equal
    metrics on every rank, exactly one B1 and one B1-bwd an attention
    layer or shared-attention application, one B4 and one B4-bwd a Mamba
    layer (the per-head ones for Mamba-2, ``scan_fwd_name``) and one B5
    (vocab-parallel where the head's vocab is split) and one B5-bwd a
    microbatch on each rank."""
    r0 = runs[0]
    mb = r0["microbatches"]
    coll = {k: [round(r["collectives"][k]["ms"] / MESH_STEPS, 3)
                for r in runs] for k in r0["collectives"]}
    coll_bytes = {k: [r["collectives"][k]["bytes"] // MESH_STEPS
                      for r in runs] for k in r0["collectives"]}
    print(f"{tag}: rows a rank {r0['rows']} ({r0['shards']} shards); "
          f"tensor parallel {r0['tensor_parallel']}; losses "
          f"{[m['loss'] for m in r0['metrics']]}; step ms by "
          f"rank {[r['step_ms'] for r in runs]}; collective ms a step "
          f"by rank {json.dumps(coll)}, bytes a step by rank "
          f"{json.dumps(coll_bytes)}; one card's step ms "
          f"{one.get('step_ms')}; stored params B by rank "
          f"{[r['param_bytes'] for r in runs]} (one card "
          f"{one['param_bytes']}), moments B {[r['moment_bytes'] for r in runs]} "
          f"(one card {one['moment_bytes']}); peak GiB by rank "
          f"{[round(r['peak_bytes'] / 2**30, 2) for r in runs]}; "
          f"step-0 grads {json.dumps(r0['grads'])}; params after "
          f"{json.dumps(r0['params'])}; fallbacks {r0['fallbacks']}; "
          f"launches {r0['launches']}", flush=True)
    b5 = ("cross_entropy_partials"
          if (r0["tensor_parallel"] or {}).get("head_vocab")
          else "cross_entropy")
    want = {name: 0 for name in r0["launches"]}
    attention = r0["attention_layers"] * mb * MESH_STEPS
    want.update({"flash_attention": attention,
                 "flash_attention_bwd": attention,
                 b5: mb * MESH_STEPS,
                 "cross_entropy_bwd": mb * MESH_STEPS})
    if r0["mamba_layers"]:
        scan = ("selective_scan_heads" if r0["ssm_variant"] == "mamba2"
                else "selective_scan")
        want[scan] = want[scan + "_bwd"] = (r0["mamba_layers"] * mb
                                            * MESH_STEPS)
    for r, run in enumerate(runs):
        if run["launches"] != want:
            fail(f"{tag} rank {r} launches {run['launches']}, wanted "
                 f"{want}")
        if run["metrics"] != r0["metrics"]:
            fail(f"{tag}: the ranks read different metrics")
    grad_limit, param_limit = MESH_REL_L2[r0["dtype"]]
    if "routing_flips" in r0:
        print(f"{tag}: routing flips of the step-0 gradient against the "
              f"one-card run (rank 0; gradient gate {grad_limit}): "
              f"{json.dumps(r0['routing_flips'])}", flush=True)
    if r0["grads"]["worst"] > grad_limit \
            or r0["params"]["worst"] > param_limit:
        fail(f"{tag} disagrees with the one-card engine: grads "
             f"{r0['grads']}, params {r0['params']} (limits {grad_limit}, "
             f"{param_limit})")
    for got, ref in zip([m["loss"] for m in r0["metrics"]],
                        one["losses"], strict=True):
        if abs(got - ref) > MESH_LOSS_RTOL * abs(ref):
            fail(f"{tag} losses {[m['loss'] for m in r0['metrics']]}"
                 f" against one card's {one['losses']}")
    for key, what in (("planted_unreduced", "rank 0's own unreduced "
                       "gradient"),
                      ("planted_skipped_reduce", "rank 0 skipping one "
                       "row-parallel all-reduce"),
                      ("planted_skipped_norm", "rank 0 normalizing one "
                       "Mamba-2 norm by its own sum of squares"),
                      ("planted_skipped_combine", "rank 0 skipping one MoE "
                       "combine's sum over model")):
        if key in r0:
            print(f"{tag}: planted fault, {what}, against the one-card "
                  f"gradient: {json.dumps(r0[key])}", flush=True)
            if r0[key]["worst"] <= grad_limit:
                fail(f"{tag}: the gradient gate ({grad_limit}) missed "
                     f"the planted fault ({what}): {r0[key]}")
    if "planted_bf16_sums" in r0:
        fault = r0["planted_bf16_sums"]
        print(f"{tag}: planted fault, every sum over model rounded to bf16,"
              f" against the one-card run: {json.dumps(fault)}", flush=True)
        if fault["grads"]["worst"] <= grad_limit \
                or fault["params"]["worst"] <= param_limit:
            fail(f"{tag}: the gates ({grad_limit}, {param_limit}) missed "
                 f"the sums over model rounded to bf16: {fault}")
    if "checkpoint_bitwise" in r0:
        print(f"{tag}: checkpoint restored on one card bit for bit "
              f"{r0['checkpoint_bitwise']}", flush=True)
        if not r0["checkpoint_bitwise"]:
            fail(f"{tag}: the checkpoint did not restore bit for bit")


def mesh_tp_prediction(tag, runs, layers: int, cfg) -> dict:
    """The tensor-parallel run's bytes a step on every rank beside their
    predictions: the activation all-reduces (all-reduce bytes less those
    of the gradient sums over ``model``) against ``tp_all_reduce_bytes``
    plus ``GRAD_NORM_BYTES``, and the gradient sums over ``model`` of
    the leaves computed whole (whatever collective carries them) against
    ``tp_partial_grad_bytes``; both to the byte, or the run fails. What
    else moved is printed with them. Microbatches split the tokens, not
    the bytes."""
    r0 = runs[0]
    vocab = r0["tensor_parallel"]["head_vocab"]
    heads = r0["tensor_parallel"]["heads"]
    elements, itemsize = r0["activation"]
    if r0["mamba_layers"]:
        formula = "tp_mixer_all_reduce_bytes"
        predicted = tp_mixer_all_reduce_bytes(
            cfg, elements // cfg.d_model, layers, r0["attention_layers"],
            vocab, itemsize)
    elif r0["family"] == "moe":
        formula = "tp_moe_all_reduce_bytes"
        predicted = tp_moe_all_reduce_bytes(
            cfg, elements // cfg.d_model, layers, heads, vocab, itemsize)
    elif r0["family"] == "audio":
        formula = "tp_audio_all_reduce_bytes"
        predicted = tp_audio_all_reduce_bytes(
            cfg, r0["frames"], elements // cfg.d_model, heads, vocab,
            itemsize)
    else:
        formula = "tp_all_reduce_bytes"
        predicted = tp_all_reduce_bytes(elements, itemsize, layers, vocab)
    predicted_partial = (tp_partial_grad_bytes(cfg, layers)
                         if r0["mamba_layers"] else 0)
    partial = [{k: v // MESH_STEPS for k, v in r["partial_grad_bytes"]
                .items()} for r in runs]
    got = [r["collectives"]["all_reduce"]["bytes"] // MESH_STEPS
           - p["all_reduce"] for r, p in zip(runs, partial)]
    other = {k: [r["collectives"][k]["bytes"] // MESH_STEPS for r in runs]
             for k in ("all_gather", "reduce_scatter")}
    print(f"{tag}: activation all-reduce bytes a step by rank {got}, "
          f"predicted {predicted} + {GRAD_NORM_BYTES} (the gradient norm) "
          f"({'with' if vocab else 'without'} the vocab's two, "
          f"{formula}); gradient sums over model of the "
          f"{r0['tensor_parallel']['partial_leaves']} leaves computed "
          f"whole a step by rank {json.dumps(partial)}, predicted "
          f"{predicted_partial} (tp_partial_grad_bytes); all-gather and "
          f"reduce-scatter bytes a step (the gradient sums included) "
          f"{json.dumps(other)}", flush=True)
    for b, p in zip(got, partial):
        if b != predicted + GRAD_NORM_BYTES:
            fail(f"{tag}: activation all-reduce {got} bytes a step, "
                 f"predicted {predicted} + {GRAD_NORM_BYTES}")
        if sum(p.values()) != predicted_partial:
            fail(f"{tag}: gradient sums over model {partial} bytes a step,"
                 f" predicted {predicted_partial}")
    return {"all_reduce_bytes": got, "predicted": predicted,
            "partial_grad_bytes": partial,
            "predicted_partial": predicted_partial, **other}


def xent_tp_case(torch, dev, gen, shape, dtype):
    """The vocab-parallel B5 and B5-bwd at a rank's shape (T, d, V of the
    slice) in ``dtype``: rank 0's slice of a whole W of ``MESH_RANKS`` slices,
    labels drawn over the whole vocab (a label outside the slice is -1 to
    the kernel). The partials launch is held to its plain version (the
    values at ``XENT_FP32_TOL``, the best index equal but at near-ties)
    and, combined with the other slices' plain partials, to the whole
    vocab's plain forward; B5-bwd with -1 labels to its plain version as
    ``xent_case`` holds B5-bwd (elementwise in float32), a planted lse
    shift caught. Both timed beside their plain versions, bounds (float32:
    the CUDA-core kernels, at the fp32 peak) and the matmul +
    ``F.cross_entropy`` pair (``ignore_index=-1``) and its autograd."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.cross_entropy import (
        PART_BEST, PART_INDEX, combine_partials, cross_entropy_bwd,
        cross_entropy_bwd_plain, cross_entropy_fwd_plain,
        cross_entropy_partials_plain)
    t, d, v = shape
    h = torch.randn((t, d), generator=gen, device=dev).to(dtype)
    whole = (torch.randn((d, v * MESH_RANKS), generator=gen, device=dev)
             / d ** 0.5).to(dtype)
    labels = torch.randint(0, v * MESH_RANKS, (t,), generator=gen,
                           device=dev, dtype=torch.int32)
    g = torch.rand((t,), generator=gen, device=dev)

    def local(r):
        return torch.where((labels >= r * v) & (labels < (r + 1) * v),
                           labels - r * v, torch.full_like(labels, -1))
    w, lab = whole[:, :v].contiguous(), local(0)
    got = ops.cross_entropy_partials(h, w, lab, 0)
    want = cross_entropy_partials_plain(h, w, lab, 0)
    keep = [p for p in range(5) if p != PART_INDEX]
    err_f = within_tol(torch, got[keep], want[keep],
                       "cross_entropy_partials", **XENT_FP32_TOL)
    idx = (got[PART_INDEX] != want[PART_INDEX]).nonzero()[:, 0]
    if idx.numel():
        s = torch.matmul(h[idx].float(), w.float())
        gap = (want[PART_BEST][idx]
               - s.gather(1, got[PART_INDEX][idx].long()[:, None])[:, 0])
        if gap.abs().max().item() > XENT_TIE:
            fail(f"cross_entropy_partials: best index differs on "
                 f"{idx.numel()} tokens beyond a near-tie ({gap.max()})")
    parts = torch.stack([got] + [cross_entropy_partials_plain(
        h, whole[:, r * v:(r + 1) * v], local(r), r * v)
        for r in range(1, MESH_RANKS)])
    nll, lse, correct = combine_partials(parts, labels)
    pnll, plse, pcorrect = cross_entropy_fwd_plain(h, whole, labels)
    err_c = max(within_tol(torch, nll, pnll, "vocab-parallel nll",
                           **XENT_FP32_TOL),
                within_tol(torch, lse, plse, "vocab-parallel lse",
                           **XENT_FP32_TOL))
    ties = xent_argmax_ties(torch, correct, pcorrect, h, whole, labels)
    del parts, pnll, pcorrect, whole
    outside = int((lab < 0).sum())
    dh, dw = ops.cross_entropy_bwd(h, w, lab, plse, g)
    pdh, pdw = cross_entropy_bwd_plain(h, w, lab, plse, g)
    bwd = xent_bwd_errors(torch, (dh, dw), (pdh, pdw), h, w, lab, g)
    if not bwd["ok"]:
        fail(f"cross_entropy_bwd with -1 labels disagrees with its plain "
             f"version: {bwd}")
    del dh, dw
    planted = xent_bwd_errors(
        torch, cross_entropy_bwd(h, w, lab, plse + PLANTED_LSE_SHIFT, g),
        (pdh, pdw), h, w, lab, g)
    if planted["ok"]:
        fail(f"cross_entropy_bwd with -1 labels: a planted lse + "
             f"{PLANTED_LSE_SHIFT} passed the checks: {planted}")
    del pdh, pdw
    name = (f"T={t} d={d} V={v} {dtype_name(dtype)}, vocab slice 1 of "
            f"{MESH_RANKS}")
    elt, flops = h.element_size(), 2.0 * t * d * v
    peak = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    bnd, by = bound_ms(elt * (t * d + d * v) + 4 * t + 5 * 4 * t, flops,
                       peak)
    lib_labels = lab.long()

    def library_fwd():
        return F.cross_entropy(torch.matmul(h, w).float(), lib_labels,
                               ignore_index=-1, reduction="none")
    fwd = {"shape": name, "max_abs_err": err_f, "combined_max_abs_err":
           err_c, "argmax_near_ties": ties,
           "ms": time_ms(torch, lambda: ops.cross_entropy_partials(
               h, w, lab, 0), iters=5, warmup=1),
           "plain_ms": time_ms(torch, lambda: cross_entropy_partials_plain(
               h, w, lab, 0), iters=5, warmup=1),
           "bound_ms": bnd, "bound_by": by,
           "library_ms": time_ms(torch, library_fwd, iters=5, warmup=1)}
    add_rates(fwd, flops)
    bnd_b, by_b = bound_ms(2 * elt * (t * d + d * v) + 3 * 4 * t, 3 * flops,
                           peak)
    hl = h.detach().requires_grad_(True)
    wl = w.detach().requires_grad_(True)
    lib_loss = (F.cross_entropy(torch.matmul(hl, wl).float(), lib_labels,
                                ignore_index=-1, reduction="none") * g).sum()
    bwd_case = {"shape": name + f", {outside} of {t} labels -1",
                "max_abs_err": bwd["whole"],
                "softmax_rel_l2": bwd["softmax_rel_l2"],
                "planted_softmax_rel_l2": planted["softmax_rel_l2"],
                "ms": time_ms(torch, lambda: ops.cross_entropy_bwd(
                    h, w, lab, plse, g), iters=5, warmup=1),
                "plain_ms": time_ms(torch, lambda: cross_entropy_bwd_plain(
                    h, w, lab, plse, g), iters=5, warmup=1),
                "bound_ms": bnd_b, "bound_by": by_b,
                "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    lib_loss, (hl, wl), retain_graph=True), iters=5,
                    warmup=1)}
    add_rates(bwd_case, 3 * flops)
    for kname, c in (("cross_entropy_partials", fwd),
                     ("cross_entropy_bwd", bwd_case)):
        print(f"kernel {kname} {c['shape']}: err {c['max_abs_err']:.3g}; "
              f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']}), library "
              f"{c['library_ms']:.4f} ms ({c['ms'] / c['library_ms']:.3f}x); "
              f"{c['tflops']:.1f} TFLOP/s, {c['bound_share']:.3f} of the "
              f"bound", flush=True)
    print(f"kernel cross_entropy_partials combined over {MESH_RANKS} slices"
          f" against the whole vocab: nll/lse err {err_c:.3g}, argmax "
          f"near-ties {ties}; bwd softmax-part rel L2 "
          f"{bwd['softmax_rel_l2']:.3g}, planted lse+{PLANTED_LSE_SHIFT} "
          f"caught at {planted['softmax_rel_l2']:.3g}", flush=True)
    return fwd, bwd_case


def mesh_scan_cases(torch, dev, gen, shapes):
    """B4 and the per-head B4 at every rank shape the ``[mesh]`` runs
    launched them (``shapes``: ``record_train_shapes``' counts), in bf16
    and fp32 whichever dtype the runs launched (each case's launches are
    those of its dtype): B4 held to its plain version at ``SCAN_TOL`` and
    timed (``timed_scan_case``), the per-head B4 as ``timed_heads_case``
    holds and times it. B4-bwd and the per-head B4-bwd are held and timed
    by [scan-bwd] (``scan_bwd_held``). Returns the cases by kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import ssm_scan_plain
    cases = {"selective_scan": [], "selective_scan_heads": []}
    launched = {name: {} for name in cases}
    for name in cases:
        for (*shape, dt), count in shapes.get(name, {}).items():
            launched[name].setdefault(tuple(shape), {})[dt] = count
    for (b, l, d, n, _), counts in sorted(
            launched["selective_scan"].items(), key=str):
        for dtype in (torch.bfloat16, torch.float32):
            count = counts.get(dtype_name(dtype), 0)
            args = scan_case(torch, dev, gen, dtype, b, l, d, n)
            y, h = ops.selective_scan(*args)
            py, ph = ssm_scan_plain(*args)
            what = f"ssm_scan tp rank {(b, l, d, n)} {dtype}"
            err = max(within_tol(torch, y, py, f"{what} y", **SCAN_TOL),
                      within_tol(torch, h, ph, f"{what} h_last",
                                 **SCAN_TOL))
            del y, h, py, ph
            cases["selective_scan"].append({"phase": "mesh-tp", **(
                timed_scan_case(torch, args, (b, l, d, n), err, count,
                                "[mesh]"))})
            del args
    for (b, l, d, n, hd), counts in sorted(
            launched["selective_scan_heads"].items()):
        for dtype in (torch.bfloat16, torch.float32):
            count = counts.get(dtype_name(dtype), 0)
            args = heads_case(torch, dev, gen, b, l, d, n, hd, dtype)
            cases["selective_scan_heads"].append({"phase": "mesh-tp", **(
                timed_heads_case(torch, args, (b, l, d, n), hd, count,
                                 "[mesh]"))})
            del args
    for name, rows in scan_bwd_held(shapes, "[mesh]").items():
        cases[name] = [{"phase": "mesh-tp", **row} for row in rows]
    gc.collect()
    torch.cuda.empty_cache()
    return cases


def mesh_phase(torch, dev):
    """``[mesh]``: ``MESH_RANKS`` ranks of this script on the one card
    (gloo: they share it, so this checks the collective structure, not
    scaling) train full-width granite-3-2b cut to ``MESH_LAYERS`` layers
    in the ``[train]`` setting (PSL-UGS, global batch 16 x 128, AdamW,
    seed 0, the init rescaled to fan-in d_in as ``[grads]`` does) for
    ``MESH_STEPS`` steps on each of ``MESH_RUNS``, then each of
    ``MESH_TP_RUNS`` (granite and llama3-8b at 4 layers, falcon-mamba-7b
    at 4, zamba2-2.7b at 8, granite-moe-3b-a800m at 8 and whisper-tiny
    whole in float32, tensor-parallel on 1x2). Gates
    (``mesh_gates``), against the one-card engine on the same batches and
    depth: the step-0 gradient and the parameters after the steps per
    leaf within ``MESH_REL_L2``'s limits for the run's dtype, the planted
    faults (a rank's own unreduced gradient; rank 0 skipping one
    row-parallel all-reduce; rank 0 normalizing one Mamba-2 norm by its
    own sum of squares; rank 0 skipping one MoE combine's sum; in the
    float32 runs every sum over ``model`` rounded to bf16) outside them,
    a float32 run's bf16 floor over GRAD_REL_L2, the losses within
    ``MESH_LOSS_RTOL``, equal metrics on both ranks, exactly one B1 and
    one B1-bwd an attention layer or shared-attention application, one
    B4 and one B4-bwd a Mamba layer and one B5 and one B5-bwd a
    microbatch on each rank, the checkpoint of the 2x1 gspmd run
    restored on one card bit for bit; the tp runs' activation all-reduce
    bytes and gradient sums over ``model`` a step as predicted
    (``mesh_tp_prediction``). Prints the backend, stored bytes and peak
    a rank, step ms beside one card's, collective ms by kind, each tp
    run's one-process bf16 floor (``mesh_reference(floor=True)``) and
    the MoE run's routing flips. Then B1,
    B1-bwd, B5, B5-bwd, B4 and the per-head B4 are held to their plain
    versions and timed at every rank shape and dtype they ran at (the
    kernels line's ``mesh_cases``: in float32 B1, B5 and their
    backwards are the CUDA-core kernels; B4 and the per-head B4 in bf16
    and fp32 whichever ran), the vocab-parallel B5 and the -1-label
    B5-bwd by ``xent_tp_case``; a B4-bwd or per-head B4-bwd launch
    outside [scan-bwd]'s shapes fails (``scan_bwd_held``)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        procs, logs = [], []
        for r in range(MESH_RANKS):
            logs.append(open(work / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                 str(r), str(work)], stdout=logs[-1],
                stderr=subprocess.STDOUT, cwd=str(ROOT)))
        deadline = time.perf_counter() + MESH_CHILD_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.perf_counter(), 1))
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
        if codes != [0] * MESH_RANKS:
            for r in range(MESH_RANKS):
                print(f"[mesh] rank {r} log tail:\n"
                      + (work / f"rank{r}.log").read_text()[-4000:],
                      flush=True)
            fail(f"[mesh] ranks exited {codes} (a rank killed after "
                 f"{MESH_CHILD_TIMEOUT_S} s reads -9)")
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
    children_s = time.perf_counter() - t_phase

    def card(one):
        return (f"losses {one['losses']}, stored params {one['param_bytes']}"
                f" B, moments {one['moment_bytes']} B, peak "
                f"{round(one['peak_bytes'] / 2**30, 2)} GiB")
    one = ranks[0]["one_card"]
    print(f"[mesh] {MESH_RANKS} ranks on one {torch.cuda.get_device_name(0)}"
          f", backend {[r['backend'] for r in ranks]} (ranks sharing a "
          f"card: this checks the collective structure, not scaling); "
          f"granite-3-2b {MESH_LAYERS} of 40 layers (cut 2), full width, "
          f"bf16, global batch 16 x 128, AdamW, seed 0, fan-in d_in init; "
          f"one card: {card(one)}", flush=True)
    if any(r["backend"] != "gloo" for r in ranks):
        fail("[mesh] ranks sharing the card must take gloo")
    shapes, predictions = {}, {}
    from repro_torch.configs import get_config
    runs_by_tag = [(f"[mesh] {m} {p} {lw} mb {mb}",
                    [r["runs"][i] for r in ranks], one, MESH_LAYERS, None)
                   for i, (m, p, lw, mb) in enumerate(MESH_RUNS)]
    for i, (arch, layers, cut, dtype, (m, p, lw, mb)) in enumerate(
            MESH_TP_RUNS):
        tag = (f"[mesh] {arch} {layers} layers {dtype or 'bfloat16'} {m} "
               f"{p} {lw} mb {mb}")
        tp_one = ranks[0]["tp_runs"][i]["one_card"]
        floor = tp_one["fp32_row_products"]
        print(f"{tag}: one card at {layers} layers (cut {cut}): "
              f"{card(tp_one)}; in bf16, its step-0 gradient and parameters "
              f"after the steps with the row products through an fp32 GEMM "
              f"(the floor of a tensor-parallel comparison, which sets the "
              f"run's dtype): {json.dumps(floor)}", flush=True)
        if dtype == "float32" and max(floor["grads"]["worst"],
                                      floor["params"]["worst"]) < GRAD_REL_L2:
            fail(f"{tag}: its bf16 floor {floor} sits under GRAD_REL_L2 "
                 f"({GRAD_REL_L2}): the run belongs in bf16")
        runs_by_tag.append((tag, [r["tp_runs"][i] for r in ranks], tp_one,
                            layers, get_config(arch)))
    for tag, runs, ref, layers, cfg in runs_by_tag:
        mesh_gates(tag, runs, ref)
        if runs[0]["tensor_parallel"]:
            predictions[tag] = mesh_tp_prediction(tag, runs, layers, cfg)
        for name, rows in runs[0]["shapes"].items():
            for shape, n in rows:
                shapes.setdefault(name, {})
                shapes[name][tuple(shape)] = (
                    shapes[name].get(tuple(shape), 0) + n)
    print(f"[mesh] ranks done in {children_s:.1f} s; B1, B1-bwd, B4, "
          f"B4-bwd, B5, B5-bwd launches by shape a rank: "
          f"{json.dumps({k: [[list(s), n] for s, n in v.items()] for k, v in shapes.items()})}",
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def draw(dtype):
        def rn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        return rn
    cases = {name: [] for name in ("flash_attention", "flash_attention_bwd",
                                   "cross_entropy", "cross_entropy_bwd",
                                   "cross_entropy_partials",
                                   "selective_scan", "selective_scan_heads")}
    # every (shape, dtype) a run launched, in that dtype: a float32 run's
    # B1, B5 and their backwards are the CUDA-core kernels
    for shape in sorted(shapes.get("cross_entropy", {})):
        fwd, bwd = xent_case(torch, dev, gen, getattr(torch, shape[3]),
                             timed=True, shape=shape[:3])
        for name, case in (("cross_entropy", fwd),
                           ("cross_entropy_bwd", bwd)):
            cases[name].append({"phase": "mesh", "launches":
                                shapes[name].get(shape, 0), **case})
    for shape in sorted(shapes.get("cross_entropy_partials", {})):
        fwd, bwd = xent_tp_case(torch, dev, gen, shape[:3],
                                getattr(torch, shape[3]))
        for name, case in (("cross_entropy_partials", fwd),
                           ("cross_entropy_bwd", bwd)):
            cases[name].append({"phase": "mesh-tp", "launches":
                                shapes[name].get(shape, 0), **case})
    for shape, n in sorted(shapes["flash_attention"].items()):
        b, s, t, hq, hkv, d, causal, dt = shape
        cases["flash_attention"].append({
            "phase": "mesh", "launches": n, **attention_train_case(
                torch, dev, gen, draw(getattr(torch, dt)), b=b, s=s, hq=hq,
                hkv=hkv, d=d, t=t, causal=causal)})
    for shape, n in sorted(shapes["flash_attention_bwd"].items()):
        b, s, t, hq, hkv, d, causal, dt = shape
        cases["flash_attention_bwd"].append({
            "phase": "mesh", "launches": n, **attention_bwd_case(
                torch, dev, gen, b, s, hq, hkv, d, t=t, causal=causal,
                dtype=getattr(torch, dt))})
    cases.update(mesh_scan_cases(torch, dev, gen, shapes))
    if not cases["cross_entropy_partials"]:
        fail("[mesh] no run launched the vocab-parallel B5")
    seconds = time.perf_counter() - t_phase
    all_runs = ranks[0]["runs"] + ranks[0]["tp_runs"]
    launches = {name: sum(r["launches"][name] for r in all_runs)
                for name in all_runs[0]["launches"]}
    tp_runs = ranks[0]["tp_runs"]
    summary = {"ranks": ranks, "seconds": seconds, "launches": launches,
               "tp_launches": {name: sum(r["launches"][name]
                                         for r in tp_runs)
                               for name in tp_runs[0]["launches"]},
               "tp_all_reduce": predictions}
    print(f"[mesh] phase {seconds:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return summary, cases


def _leaf_names(tree, prefix=""):
    """Dotted key paths in ``tree_leaves`` order (sorted keys, list items
    in order)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, item in enumerate(tree)
                for n in _leaf_names(item, f"{prefix}{i}.")]
    return [prefix[:-1]]

def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    logs = _build.build(_build.SOURCES, verbose=True)
    for log in logs:
        for line in log.splitlines():
            if line.startswith("[nvcc") or "registers" in line \
                    or "spill" in line:
                print(line.strip())
    print(f"built kernels in {time.perf_counter() - t0:.1f}s", flush=True)
    sass = sass_counts()
    hgmma = sass["HGMMA"]["kernels"]
    asyncs = sass["async copy"]["kernels"]

    b1_cases, b2, b3 = kernel_phase(torch, dev)
    with tempfile.TemporaryDirectory() as events_dir:
        reports, launches, ctx, requests = serve_phase(
            torch, dev, pathlib.Path(events_dir))
    agreement_phase(torch, reports, ctx, requests)
    with tempfile.TemporaryDirectory() as events_dir:
        static = static_phase(torch, dev, ctx, reports["continuous"],
                              requests, pathlib.Path(events_dir))
    del ctx, reports
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as events_dir:
        llama = llama_phase(torch, dev, pathlib.Path(events_dir))
    print(f"[llama] summary {json.dumps(llama)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as events_dir:
        launches["ssm"], scan_shapes = ssm_phase(torch, dev,
                                                 pathlib.Path(events_dir))
    gc.collect()
    torch.cuda.empty_cache()
    b4 = scan_kernel_phase(torch, dev, scan_shapes)
    b5, b5_bwd, b1_bwd = train_kernel_phase(torch, dev)
    with tempfile.TemporaryDirectory() as events_dir:
        train = train_phase(torch, dev, pathlib.Path(events_dir))
    grad_agreement_phase(torch, dev)
    families = {}
    for tag, phase in (("moe", moe_phase), ("moe_train", moe_train_phase),
                       ("vlm", vlm_phase)):
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as events_dir:
            families[tag] = phase(torch, dev, pathlib.Path(events_dir))
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as events_dir:
        families["hybrid"], hybrid_shapes = hybrid_phase(
            torch, dev, pathlib.Path(events_dir))
    together = sum(f["seconds"] for f in families.values())
    print(f"[moe]/[moe-train]/[vlm]/[hybrid] {together:.1f} s together",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    family_cases = family_kernel_phase(torch, dev, hybrid_shapes)
    heads_ptxas = ptxas_usage(logs, "mamba2_fwd_kernel")
    print(f"[hybrid] mamba2_fwd_kernel registers and spill bytes by "
          f"instantiation {json.dumps(heads_ptxas)}", flush=True)
    print(f"[families] summary {json.dumps(families)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as events_dir:
        audio, audio_shapes = audio_phase(torch, dev,
                                          pathlib.Path(events_dir))
    audio_grads, grad_shapes = audio_grads_phase(torch, dev)
    audio_cases = audio_kernel_phase(
        torch, dev, merge_shapes(audio_shapes, grad_shapes))
    together = (static["seconds"] + audio["seconds"]
                + audio_grads["seconds"] + audio_cases["seconds"])
    print(f"[static]/[audio]/[audio-grads]/[audio-kernels] {together:.1f} s "
          f"together", flush=True)
    print(f"[audio] summary {json.dumps({'static': static, 'audio': audio, 'grads': audio_grads}, default=str)}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    b4_bwd = scan_bwd_phase(torch, dev, ptxas_usage(logs, "ssm_bwd_kernel"))
    gc.collect()
    torch.cuda.empty_cache()
    b4_heads = scan_heads_bwd_phase(
        torch, dev, ptxas_usage(logs, "mamba2_bwd_kernel"))
    ssm_train, train_shapes = {}, {}
    for tag, cell in (("ssm-train", SSM_TRAIN),
                      ("hybrid-train", HYBRID_TRAIN)):
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as events_dir:
            ssm_train[tag], shapes = ssm_train_phase(
                torch, dev, pathlib.Path(events_dir), tag, **cell)
        for name, counts in shapes.items():
            for shape, n in counts.items():
                train_shapes.setdefault(name, {})
                train_shapes[name][shape] = (
                    train_shapes[name].get(shape, 0) + n)
    train_cases = ssm_train_kernel_phase(torch, dev, train_shapes)
    for name in ("flash_attention", "flash_attention_bwd", "cross_entropy",
                 "cross_entropy_bwd", "selective_scan",
                 "selective_scan_heads"):
        family_cases.setdefault(name, []).extend(train_cases[name])
    together = (b4_bwd["seconds"] + b4_heads["seconds"]
                + train_cases["seconds"]
                + sum(t["seconds"] for t in ssm_train.values()))
    print(f"[scan-bwd]/[ssm-train]/[hybrid-train]/[train-kernels] "
          f"{together:.1f} s together", flush=True)
    print(f"[ssm-train] summary {json.dumps(ssm_train)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    cnn_agree = cnn_agree_phase(torch, dev)
    cnn, cnn_ctx = cnn_phase(torch, dev)
    cnn["protocols"] = cnn_protocols_phase(torch, cnn_ctx)
    cnn_launches = ops.launch_counts()
    print(f"[cnn] kernel launches over the CNN phases: {cnn_launches}",
          flush=True)
    if any(cnn_launches.values()):
        fail(f"the CNN path launched a kernel wrapper: {cnn_launches}")
    del cnn_ctx
    print(f"[cnn] summary {json.dumps({'agree': cnn_agree, **cnn})}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    plans = plan_phase(torch, dev)
    plans["cnn_lds"] = cnn_lds_phase(torch, dev)
    plan_launches = ops.launch_counts()
    print(f"[plan] kernel launches over [plan] and [cnn-lds]: "
          f"{plan_launches}", flush=True)
    if any(plan_launches.values()):
        fail(f"the planner path launched a kernel wrapper: {plan_launches}")
    print(f"[plan] summary {json.dumps(plans)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    mesh, mesh_cases = mesh_phase(torch, dev)
    print(f"[mesh] summary {json.dumps(mesh)}", flush=True)
    print(f"command time {time.perf_counter() - t_start:.1f} s (kernel "
          f"build included)", flush=True)

    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "shape")
    rates = ("tflops", "bound_share")      # from ms, as measured
    b1 = max(b1_cases, key=lambda c: c["bound_ms"])      # B=16 S=512
    b1b = b1_bwd[0]                      # the training shape, S = 128
    # the per-head B4 at zamba2's training shape ([hybrid-train]'s)
    b4h = max(family_cases["selective_scan_heads"],
              key=lambda c: c["bound_ms"])
    # llama's rank shape, the largest bf16 vocab slice
    b5_tp = max((c for c in mesh_cases["cross_entropy_partials"]
                 if "bfloat16" in c["shape"]), key=lambda c: c["bound_ms"])
    by_path = {name: {"serve_paged": launches["paged"][name],
                      "serve_continuous": launches["continuous"][name],
                      "serve_speculative": launches["speculative"][name],
                      "serve_ssm": launches["ssm"][name],
                      "train": train["launches"][name],
                      "serve_moe_paged":
                          families["moe"]["paged"]["launches"][name],
                      "serve_moe_continuous":
                          families["moe"]["continuous"]["launches"][name],
                      "serve_moe_speculative":
                          families["moe"]["speculative"]["launches"][name],
                      "serve_moe_speculative_sampled": families["moe"][
                          "speculative_sampled"]["launches"][name],
                      "serve_llama_paged": llama["paged"]["launches"][name],
                      "serve_llama_continuous":
                          llama["continuous"]["launches"][name],
                      "serve_llama_speculative":
                          llama["speculative"]["launches"][name],
                      "serve_llama_sampled": sum(
                          llama[f"sampled_{run}"]["launches"][name]
                          for run in ("paged", "paged-again", "continuous",
                                      "speculative", "paged-top-p")),
                      "train_moe": families["moe_train"]["launches"][name],
                      "serve_vlm_paged": families["vlm"]["launches"][name],
                      "vlm_patched_loss":
                          families["vlm"]["patched_launches"][name],
                      "serve_hybrid": families["hybrid"]["launches"][name],
                      "serve_hybrid_fp32":
                          families["hybrid"]["fp32"]["launches"][name],
                      "train_ssm": ssm_train["ssm-train"]["launches"][name],
                      "train_hybrid":
                          ssm_train["hybrid-train"]["launches"][name],
                      "serve_static": static["mixed"]["launches"][name],
                      "serve_audio": audio["launches"][name],
                      "audio_grads":
                          audio_grads["bfloat16"]["launches"][name],
                      "train_cnn": cnn_launches[name],
                      "plan_and_cnn_lds": plan_launches[name],
                      "train_mesh_rank0": mesh["launches"][name]}
               for name in ops.WRAPPERS}
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:78",
         "launches": train["launches"]["flash_attention"],
         "launches_by_path": by_path["flash_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in b1_cases),
         **{k: b1[k] for k in timing + rates + ("device_ms",)},
         "cases": b1_cases,
         "family_cases": family_cases["flash_attention"],
         "audio_cases": audio_cases["flash_attention"],
         "mesh_cases": mesh_cases["flash_attention"],
         "llama_cases": llama["kernel_cases"]["flash_attention"],
         "hgmma_count": hgmma["flash_fwd_tc_kernel"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/models/layers.py:248",
         "launches": train["launches"]["flash_attention_bwd"],
         "launches_by_path": by_path["flash_attention_bwd"],
         "max_abs_err": max(c["max_abs_err"] for c in b1_bwd),
         **{k: b1b[k] for k in timing + rates + (
             "device_ms", "device_ms_by_pass", "library_device_ms",
             "device_bound_share")},
         "cases": b1_bwd,
         "family_cases": family_cases["flash_attention_bwd"],
         "mesh_cases": mesh_cases["flash_attention_bwd"],
         "audio_cases": audio_cases["flash_attention_bwd"],
         "hgmma_count": {k: hgmma[k] for k in (
             "flash_bwd_dq_tc_kernel", "flash_bwd_dkdv_tc_kernel")}},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:81",
         "launches": launches["paged"]["paged_attention"],
         "launches_by_path": by_path["paged_attention"],
         **{k: b2[k] for k in ("max_abs_err", "device_ms", "host_us")
            + timing},
         "family_cases": family_cases["paged_attention"],
         "llama_cases": llama["kernel_cases"]["paged_attention"],
         "async_copy_count": asyncs["paged_fwd"]},
        {"name": "spec_verify", "route": "cuda",
         "source": "src/repro_torch/csrc/spec_verify.cu",
         "replaces": "src/repro/kernels/spec_verify.py:91",
         "launches": launches["speculative"]["spec_verify"],
         "launches_by_path": by_path["spec_verify"],
         **{k: b3[k] for k in ("max_abs_err", "ragged_max_abs_err",
                               "w1_max_abs_err", "device_ms", "host_us")
            + timing},
         "llama_cases": llama["kernel_cases"]["spec_verify"],
         "async_copy_count": asyncs["spec_verify"],
         "hmma_count": sass["HMMA"]["kernels"]["spec_verify_mma_kernel"]},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:58",
         "launches": launches["ssm"]["selective_scan"],
         "launches_by_path": by_path["selective_scan"],
         **{k: b4[k] for k in ("max_abs_err", "fp32_max_abs_err",
                               "exp_count", "device_ms", "cases")
            + timing},
         "family_cases": family_cases["selective_scan"],
         "mesh_cases": mesh_cases["selective_scan"],
         "async_copy_count": asyncs["ssm_scan_kernel"]},
        {"name": "selective_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/models/layers.py:655",
         "launches": ssm_train["ssm-train"]["launches"][
             "selective_scan_bwd"],
         "launches_by_path": by_path["selective_scan_bwd"],
         **{k: b4_bwd[k] for k in ("max_abs_err", "device_ms", "exp_count",
                                   "kernel_exp_count", "cases", "ptxas")
           + timing},
         "train_cases": train_cases["selective_scan_bwd"],
         "mesh_cases": mesh_cases["selective_scan_bwd"],
         "async_copy_count": asyncs["ssm_bwd_kernel"]},
        {"name": "selective_scan_heads", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba2_fwd.cu",
         "replaces": "src/repro/models/layers.py:655",
         "launches": ssm_train["hybrid-train"]["launches"][
             "selective_scan_heads"],
         "launches_by_path": by_path["selective_scan_heads"],
         "max_abs_err": max(c["max_abs_err"]
                            for c in family_cases["selective_scan_heads"]),
         **{k: b4h[k] for k in ("device_ms", "exp_count", "kernel_exp_count",
                                "b4_ms", "b4_device_ms", "bound_share")
            + timing},
         "family_cases": family_cases["selective_scan_heads"],
         "mesh_cases": mesh_cases["selective_scan_heads"],
         "ptxas": heads_ptxas,
         "async_copy_count": asyncs["mamba2_fwd_kernel"],
         "exp_sass": sass["MUFU.EX2"]["kernels"]["mamba2_fwd_kernel"]},
        {"name": "selective_scan_heads_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba2_bwd.cu",
         "replaces": "src/repro/models/layers.py:655",
         "launches": ssm_train["hybrid-train"]["launches"][
             "selective_scan_heads_bwd"],
         "launches_by_path": by_path["selective_scan_heads_bwd"],
         **{k: b4_heads[k] for k in ("max_abs_err", "device_ms", "exp_count",
                                     "kernel_exp_count", "per_channel_ms",
                                     "per_channel_device_ms", "bound_share",
                                     "fp32", "cases", "ptxas") + timing},
         "train_cases": train_cases["selective_scan_heads_bwd"],
         "mesh_cases": mesh_cases["selective_scan_heads_bwd"],
         "async_copy_count": asyncs["mamba2_bwd_kernel"]},
        {"name": "cross_entropy", "route": "cuda",
         "source": "src/repro_torch/csrc/cross_entropy.cu",
         "replaces": "src/repro/kernels/cross_entropy.py:68",
         "launches": train["launches"]["cross_entropy"],
         "launches_by_path": by_path["cross_entropy"],
         **{k: b5[k] for k in ("max_abs_err", "argmax_near_ties", "fp32")
            + timing + rates},
         "family_cases": family_cases["cross_entropy"],
         "mesh_cases": mesh_cases["cross_entropy"],
         "audio_cases": audio_cases["cross_entropy"],
         "hgmma_count": hgmma["xent_fwd_tc_kernel"]},
        {"name": "cross_entropy_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/cross_entropy.cu",
         "replaces": "src/repro/kernels/cross_entropy.py:68",
         "launches": train["launches"]["cross_entropy_bwd"],
         "launches_by_path": by_path["cross_entropy_bwd"],
         **{k: b5_bwd[k] for k in ("max_abs_err", "softmax_rel_l2",
                                     "planted_softmax_rel_l2", "fp32")
            + timing + rates},
         "family_cases": family_cases["cross_entropy_bwd"],
         "mesh_cases": mesh_cases["cross_entropy_bwd"],
         "audio_cases": audio_cases["cross_entropy_bwd"],
         "hgmma_count": hgmma["xent_tc_gemm"]},
        {"name": "cross_entropy_partials", "route": "cuda",
         "source": "src/repro_torch/csrc/cross_entropy.cu",
         "replaces": "src/repro/kernels/cross_entropy.py:68",
         "launches": mesh["tp_launches"]["cross_entropy_partials"],
         "launches_by_path": by_path["cross_entropy_partials"],
         **{k: b5_tp[k] for k in ("max_abs_err", "combined_max_abs_err",
                                  "argmax_near_ties") + timing + rates},
         "mesh_cases": mesh_cases["cross_entropy_partials"],
         "hgmma_count": hgmma["xent_fwd_tc_kernel"]},
    ]
    if set(ops.WRAPPERS) != {k["name"] for k in kernels}:
        fail(f"kernel list {sorted(ops.WRAPPERS)} not all reported")
    print(smi)                  # nvidia-smi's "name, power.limit", as given
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
