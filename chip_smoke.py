#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's kernels from ``src/repro_torch/kernels/csrc/`` with nvcc
(one process a source, all at once), holds each kernel against its plain
PyTorch version, drives the port's main paths on the card, times the
kernels, and prints one JSON line per result.  Phases, in order:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernel build, timed;
3. kernel vs plain on synthetic inputs (P in {8, 16, 20, 56, 128}, K in
   {256, 4096, 65536}; forced rows, equal-jitter ties, count == 0 lanes),
   bit-equal;
4. the campaign path: ``sweep_portfolio("mandelbrot", "epyc")`` at T = 500,
   reps = 3 and ``sweep_portfolio("tc", "epyc")`` through the kernels, then
   the same sweeps with the plain event core on the card, bit-equal, and
   both sweeps at T = 2 held against the plain CPU path (loop times
   bit-equal: the draws and the event core round alike on both);
5. the what-if path: ``what_if_wave`` (256 requests, 8 replicas) and
   ``what_if_routes`` (4 groups x 8 replicas, > 100 candidate rows), kernel
   vs plain on the card and vs the CPU; then each call's wall time on the
   host clock (after one warm call) with the kernel's share of it;
6. each event-loop kernel timed with CUDA events at the main path's largest
   call, beside its plain version, with the call's longest lane alone (the
   chain) and the call with no chunks (the launch floor); and the fused
   call cut to its first 132 ... 4096 lanes (issue- or chain-bound);
7. the model kernels (rmsnorm, flash_attention, ssd_scan) against their
   plain versions on synthetic inputs, within the tests' tolerances: the
   SSD scan at states of 16, 64, 96 and 128, flash attention also at
   whisper-small's calls (1,500 frames, S = 32 and S = 1 against them);
8. Zamba2-7B at full width in bf16 with random weights from a seeded
   ``torch.Generator``: ``prefill`` of 8 prompts of 2048 tokens (exactly
   181 rmsnorm, 9 flash_attention and 81 ssd_scan launches; an ssd_scan
   launch is one call, three kernels in bf16), then up to 64
   decode steps on 8 slots through the ``ContinuousBatcher`` (``live``);
9. the same prefill on the plain versions, on the card: logits finite;
   every block's output, from the same input, within ``BLOCK_REL_L2`` of
   the kernels'; and on two prompts in float32, the kernels' logits at
   every position within ``F32_LOGIT_REL_L2`` of the plain versions' with
   the same top-1 token wherever the top two are further apart than that,
   and the bf16
   logits of both no further from that float32 reference than
   ``BF16_PARITY`` apart;
10. the small Zamba2 in float32: the card against the CPU, within 1e-4;
11. each model kernel timed at the main path's largest call, beside its
    bound, its plain version and the library call computing the same
    function (``rms_norm``, ``scaled_dot_product_attention``; none for
    the SSD scan), with the rate it reaches (``tflops``: the function's
    operations over the kernel's time) and, for the SSD scan, each of its
    three bf16 kernels' share of the call (``parts_ms``, from
    ``torch.profiler``); rmsnorm also at decode's calls (8 rows of 3584
    and of 7168), each with its kernel's card time alone (``device_ms``,
    the profiler's) beside the CUDA-event time that holds the wrapper, and
    a rerun bit-equal; every rmsnorm row (these, the prefill's and [17a]'s
    training call) is timed in turns with ``rms_norm``;
12. the selection-policy layer: ``run_campaign([("mandelbrot", "epyc")],
    T=60, reps=3, selectors=SIM_SELECTOR_GRID)`` over both chunk modes (22
    lanes, 3,960 decisions; the cell's T = 500 cut to its first 60 steps
    to keep the script inside its limit beside [18]-[25]) on the kernels, the
    sweep, the lockstep replay and the SimPolicy pricing each on a backend
    of its own: the walls, the
    replay's ``PathTimes`` split, the host's decide and learn remainder, the
    pricing calls and the Fig. 5 degradation of every lane; the fused kernel
    timed at the replay's largest call; replay steps under
    ``torch.profiler`` (the card's busy time and launches a step, its idle
    share); the same grid with two learned lanes
    at T = 5 on the kernels and on the plain event core, and at T = 4 on
    the card and on the CPU, histories, totals and policy states bit-equal;
    and SimPolicy's decision equal to the exhaustive Oracle's on the
    noise-free ``tc``/``epyc`` loop;
13. perturbed and heterogeneous machines: (a) the ``mandelbrot`` portfolio
    at T = 5 on ``epyc`` and ``epyc_het`` under each kind of perturbation
    (a PE slowdown, four failed PEs, a noise burst, a ``cov`` workload
    drift) on the kernels, on the plain event core on the card and on the
    CPU, loop times, ``lib`` and chunk counts bit-equal, with the fused
    calls' largest B and K and the lanes forced whole; (b) the Fig. 5 cell
    ``mandelbrot``/``epyc`` cut to T = 60 with 20 % of the PEs 8x slower
    from step 35: ``SIM_SELECTOR_GRID`` plus ReactiveSim and AwareSim over
    both chunk modes (26 lanes, 4,680 decisions), its walls,
    ``PathTimes``, pricing and launches, and every lane's total beside its
    clean twin's over the same steps of [12]; steps 8-15 of that grid perturbed from step 0 under
    ``torch.profiler``; both event-loop kernels timed at the perturbed
    replay's largest call; (c) that grid at T = 4 with the onset at step 2 on the card and on the
    CPU, bit-equal; (d) ``simulate_loop`` on the ``event_finish`` kernel for
    algorithms 1, 2, 3, 4 and 6, the card equal to the CPU;
14. the serving dispatcher and the fleet: (a) ``launch.serve.dispatch`` at
    2,048 requests over 16 replicas with the per-token cost of [8]'s
    decode, QLearn and SimPolicy (every wave priced on ``event_finish``);
    (b) the fleet benchmark's tier-1 regime (4 x 8 replicas of SimPolicy
    groups, the bursty trace of 120,000 requests) under round-robin and
    what-if routing, each summary equal to ``results/bench_fleet.json``
    (read as data) and the benchmark's gates, with walls, what-if calls,
    ``PathTimes`` and host walls by layer, then about 20 waves under
    ``torch.profiler``; (c) the fault benchmark's tier-1 regime (60,000
    requests, group 1 down for [0.65, 0.95] of the trace), recovery on and
    off, equal to ``results/bench_faults.json`` with its gates; (d) a
    journaled 6,000-request faulty fleet resumed from an early, a middle
    and the last snapshot, bit-equal; (e) a 6,000-request fleet under every
    kind of fleet perturbation with hedged recovery, the kernels equal to
    the plain event core on the card and to the CPU; (f) ``event_finish``
    timed at the largest route call of (b);
15. async dispatch and the lane split: the ``mandelbrot``/``epyc`` T = 500
    sweep synchronous and double-buffered in turns (sync, async, async,
    sync), bit-equal with equal launches, with each mode's walls,
    ``PathTimes`` (``pack_s`` beside ``launch_s`` and the drain's wait
    ``device_s``) and the card's idle share (its busy time from one more
    sweep under ``torch.profiler``); the Fig. 5 grid's lockstep replay at
    T = 30 and the what-if calls of [5], async against sync, bit-equal;
    the split path at ``data_parallel=1`` against an explicit one-device
    list (the one card holds no split above one device);
16. learned-selection training, ``benchmarks/bench_learned.py::smoke``'s
    size on the card: the transition log of its 6 training cells and
    their PE-slowdown twins at T = 12, 250 AdamW steps of the policy net
    (hidden 24), the held-out ``tc``/``epyc`` regret gates (Learned beats
    mid-exploration QLearn and RandomSel, LearnedHybrid no worse than
    Hybrid) and the distilled ladder within 1 + ``DISTILL_BOUND`` of the
    net; training resumed from its step-125 checkpoint and an
    injected-failure run, each bit-equal to the run; the card against
    the CPU from one start within ``TRAIN_REL_TOL``; and the train step's
    ms, launches and idle share under ``torch.profiler``;
17. dense-family training, llama3.2-3b: (a) the backward kernels
    (``rmsnorm_bwd``, ``flash_attention_bwd``) against their plain
    versions' autograd at small GQA / non-causal / hd 32 / float32 shapes
    and at the training shapes (bf16: rmsnorm over 4 x 2048 rows of 3072,
    causal attention of 24 query and 8 kv heads of 128 over 2048), float32
    within ``BWD_F32_REL`` and bf16 within ``BWD_BF16_REL_L2``, each timed
    after an L2 flush beside its bound, its plain version and the
    library's backward (SDPA's, ``F.rms_norm``'s), the backward taking
    the lse the forward keeps; the forward's lse within ``LSE_REL`` of
    the plain lse, its output bit-equal with and without it, and its time
    with and without it at the training and the prefill shape; (b) one
    backward of the smoke llama on the
    card, float32 and bf16: no leaf without a gradient; (c) the smoke
    llama in float32, 8 steps from one start on the card and on the CPU,
    losses within ``TRAIN_CARD_CPU_REL``; (d) restart equivalence on the
    card with the reference test's settings, and whether it is bit-equal;
    (e) ``repro_torch.launch.train.main`` at full width (28 layers,
    d_model 3072, bf16, 4 x 2048 tokens a step) for 9 steps under
    ExhaustiveSel over the five ``DEFAULT_PLANS``: per plan its step
    times, tokens/s, peak allocated memory and kernel launches a step, the
    settled plan, the loss trace (finite and falling), and the final
    checkpoint's save wall (the disk checked first, the checkpoint deleted
    after); then one more step of the settled plan by layer (forward with
    the loss, backward, AdamW) and one under ``torch.profiler`` (the
    card's busy time by kernel bucket, its launches, its idle share).
18. the dense, VL and MoE families' serving, bf16, random weights from a
    seeded ``torch.Generator``, every prefill of 8 prompts of 2048 tokens
    on the kernels into a cache of its serving length (``prefill(...,
    max_len=...)``) with exact launch counts (rmsnorm: 2 a layer, 4 with
    QK-norm, + 1; flash_attention: 1 a layer), then decode through
    ``live``, with walls and peaks: (a) qwen3-32b at full width and depth
    (257 / 64 launches), 64 decode steps, the decode step's wall against
    the card's busy ms, blocks 0, 32 and 63 against the plain versions
    from the same input (one prompt) within ``BLOCK_REL_L2``, and its
    2-layer cut in float32 as in [9]; (b) granite-8b and mistral-nemo-12b
    at full width and depth, 16 decode steps; (c) qwen2-vl-72b cut to 16
    of its 80 layers (145 GB in bf16 does not fit the card), 16 decode
    steps, its M-RoPE logits of text bit-equal to RoPE's; (d) olmoe-1b-7b
    at full width and depth, 64 decode steps, ``forward``'s
    ``expert_load`` (16, 64), each row 8 x 2048 x 8, equal to the
    prefill's, ``dropped_frac`` of prefill and decode, a rerun of the
    prefill bit-equal; (e) grok-1-314b cut to 2 of its 64 layers (633
    GB), 4 decode steps, its loads as in (d); (f) the six archs'
    ``smoke_reduce`` in float32, the card against the CPU within 1e-4;
    (g) rmsnorm at qwen3-32b's QK-norm calls (1,048,576 and 131,072 rows
    of 128) in turns with ``rms_norm``, and flash attention at its
    prefill call (64 / 8 heads) beside SDPA, added to the kernels' records
    (``at_qk_norm_call``, ``at_dense_prefill_call``);
19. the SSM and enc-dec families' serving, bf16, full width and depth,
    random weights from a seeded ``torch.Generator``, with exact launch
    counts: (a) mamba2-2.7b (64 Mamba2 layers, d_model 2,560, 80 heads of
    64, state 128, chunk 256) prefills 8 prompts of 2048 tokens (64
    ``ssd_scan`` and 129 ``rmsnorm`` launches, no flash attention), then
    64 decode steps through ``live``; blocks 0, 32 and 63 against the
    plain versions from the same input within ``BLOCK_REL_L2``, and its
    2-layer cut in float32 as in [9]; (b) whisper-small (12 + 12 layers,
    d_model 768, 12 heads of 64): 8 clips of 1,500 stub frame embeddings
    from a seed, a decoder prompt of 32 tokens into a cache of 448
    positions (its decoder context), 36 flash-attention launches a
    prefill (encoder, decoder self, cross) and 12 a decode step (cross),
    64 decode steps; encoder and decoder blocks 0, 6 and 11 against the
    plain versions, and its 2 + 2-layer cut in float32; (c) both archs'
    ``smoke_reduce`` in float32, the card against the CPU within 1e-4;
    (d) the SSD scan at mamba2's prefill call (state 128), flash attention
    at whisper's encoder call (8 x 1,500 frames, non-causal) beside SDPA,
    and rmsnorm at mamba2's rows (16,384 of 2,560 and of 5,120) in turns
    with ``rms_norm``, added to the kernels' records
    (``at_mamba_prefill_call``, ``at_whisper_encoder_call``,
    ``at_mamba_call``);
20. the SSM and hybrid families' training: (a) ``ssd_scan_bwd`` against
    its plain version (autograd through ``ssd_scan_ref``) at states 16,
    64, 96 and 128 and a call whose S is its chunk (and in bf16 alone a
    chunk of 1024 at state 128 and 7 heads), float32 within
    ``MODEL_TOL["ssd_scan"]`` and bf16 within ``BWD_BF16_REL_L2``, with
    no and with a random gradient of the final state, every gradient
    finite and a rerun bit-equal; (b) the SSD backward at mamba2-2.7b's
    and Zamba2's training calls (4 x 2048; 80 heads, state 128; 112
    heads, state 64) and the flash backward at Zamba2's shared block (32 /
    32 heads of 112, causal), each against its plain version and timed
    after an L2 flush beside its bound, its plain version and (flash)
    SDPA's backward, the SSD backward's five bf16 kernels' shares
    (``parts_ms``), and at the steps' own calls (4 x 1024); (c) both
    archs' ``smoke_reduce`` on the card: one backward in float32 and bf16
    with no leaf without a gradient, and 8 float32 steps from one start
    on the card and the CPU within ``TRAIN_CARD_CPU_REL``; (d)
    ``launch.train.main`` for mamba2-2.7b at full width and depth (64
    layers, d_model 2,560, bf16) and (e) zamba2-7b at full width cut to
    18 of its 81 layers (2 segments; the launcher's wiring, it has no
    depth flag), 4 x 1024 tokens a step, 5 steps under ExhaustiveSel over
    the five ``DEFAULT_PLANS``: per plan its step seconds, tokens/s, peak
    allocated memory and kernel launches a step (held exactly: the SSD
    scan once a layer and microbatch, twice under remat; its backward
    once), the settled plan, the loss (finite, and lower on the first
    step's batch after training than at that step), and the final save's
    wall (the disk checked first, the checkpoint deleted after); then one
    more mb1_noremat step of mamba2-2.7b by layer on the host clock
    (forward + loss, backward, AdamW) and the card's busy ms by kernel
    bucket (the SSD backward's among them) under ``torch.profiler``;
21. the MoE family's training: (a) olmoe-1b-7b's ``smoke_reduce`` on the
    card: one backward in float32 and bf16 with no leaf without a
    gradient, and 8 float32 steps from one start on the card and the CPU
    within ``TRAIN_CARD_CPU_REL``; (b) one MoE layer at full width in
    bf16 (4 x 1024 tokens, D 2,048, 64 experts, top-8, F 1,024, tokens
    that share a component so that the capacity drops some): forward and
    backward twice and once checkpointed, outputs and gradients
    bit-equal, ``dropped_frac``, and autograd's own backward of the
    dispatch's gather beside the fixed-order one; the rmsnorm backward
    at olmoe's QK-norm (65,536 rows of 128) and layer norms (4,096 rows
    of 2,048) and the flash backward at its call (16 / 16 heads of 128,
    causal), each against its plain version, rerun bit-equal and timed
    beside its bound, its plain version and the library's backward; (c)
    olmoe-1b-7b at full width cut to ``MOE_TRAIN_LAYERS`` of its 16
    layers (83 GB of state at full depth) through the launcher's wiring,
    4 x 1024 tokens a step, 5 steps under ExhaustiveSel over the five
    plans: per plan its step seconds, tokens/s, peak and launches a step
    (held exactly), the loss gate, the final save's wall, and
    ``expert_load`` and ``dropped_frac`` of every layer on the first
    batch after training;
22. the enc-dec family's training: (a) whisper-small's ``smoke_reduce``
    on the card (its batches carry stub frames): one backward in float32
    and bf16 with no leaf, nor layer of its encoder and decoder stacks,
    without a gradient, and 8 float32 steps from one start on the card
    and the CPU within ``TRAIN_CARD_CPU_REL``; (b) the flash backward at
    whisper's three training calls (16 clips, 12 / 12 heads of 64, bf16):
    the encoder's 1,500 frames non-causal, the decoder's 448 queries over
    them non-causal, its 448 causal, each against its plain version
    (whose peak memory is logged), rerun bit-equal and timed beside its
    bound, its plain version, SDPA's backward and the forward with its
    lse, that forward also in turns with SDPA's forward beside its plain
    version and its bound; (c) ``launch.train.main`` for whisper-small
    at full width and depth (12 + 12 layers, d_model 768, bf16), 16
    clips of 1,500 frames and 448 decoder tokens a step, 5 steps under
    ExhaustiveSel over the five plans: per plan its step seconds,
    tokens/s and frames/s, peak and launches a step (held exactly: 36
    flash attentions and 36 backwards a microbatch, none doubled under
    remat, no rmsnorm), the loss gate on the first batch with its frames,
    the final save's wall, and the host's time to draw and copy a step's
    frames;
23. the dry run held against the card: each step measured above (the
    mb1_noremat, mb1_remat and mb2_remat steps of [17e], [20d], [20e],
    [21c] and [22c], the prefills of [8], [18] and [19]) counted on the
    meta device by ``repro_torch.launch.dryrun.run_cell`` at its arch, depth cut, batch,
    plan and cache length, no model run on the card: each hand-written
    kernel's launches equal to the card's, the measured wall at least
    0.95 of the counted op-sum bound, the counted peak at most 1.02 of
    the card's; logged: the compute and op-sum shares, the peaks' gap
    beside what the card held before the step, the peak's temporaries by
    the op that made them, and the bytes by category;
24. the model stack's sharding specs on the reference's 16x16 and
    2x16x16 layouts (``repro_torch.distributed.sharding``), held against
    the card's allocator and tensors, no kernel computed and nothing
    timed: (a) device (0, ...)'s share of grok-1-314b's ``train_4k``
    arguments (parameters, bf16 moments, the batch's shard) allocated with
    ``torch.empty`` at each leaf's ``shard_shape``, on each layout: the
    allocator asked for exactly the dry run's per-device argument bytes
    (``launch.dryrun.mesh_cell``), and ``memory_allocated`` grown by that
    plus the allocator's rounding (each block up to 512 bytes, and at
    most 1 MiB unsplit a block above 1 MiB); (b) llama3.2-3b's parameters
    at full width and depth on the card, every leaf cut into all 256
    devices' shards of 16x16 with ``shard_slices``: each shard its
    ``shard_shape``, the distinct shards a grid that tiles the leaf once
    and concatenates back bit-equal, devices equal on the spec's axes
    holding the same elements and the others distinct ranges, device (0,
    0)'s bytes the count's; (c) every applicable cell's per-device
    argument and output GB on both layouts;
25. the dense stack partitioned over a device mesh (DTensor): (a)
    llama3.2-3b at full width and depth, two mb1_noremat steps of 4 x
    2048 tokens from seed 0, plain and with every parameter, moment and
    batch leaf a DTensor on a one-rank (1, 1) ``data, model`` NCCL mesh
    (``distributed.sharding``'s specs): losses and final parameters
    bit-equal, the flash and rmsnorm launches equal by the wrappers'
    counts and by the profiler, the path's launches added to the kernels'
    records; (b) rank 0's share of llama3.2-3b's ``train_4k`` on 16x16,
    real tensors on the card in a fake process group of 256 ranks (its
    collectives move nothing; values not checked), two steps timed: its
    peak allocated bytes held against the dry run's count of the same
    cell (``launch.dryrun.counted_mesh_cell``) as [23] holds its counts;
    the MoE family and the VL backbone on the same meshes: (c)
    olmoe-1b-7b at full width cut to [21c]'s 4 of 16 layers, two
    mb1_noremat steps of 4 x 1024 tokens at [21c]'s one dispatch group,
    plain and on the (1, 1) mesh: losses, final parameters and every
    step's expert_load bit-equal, launches equal and added to the
    records; (d) qwen2-vl-72b at full width cut to 2 of 80 layers (M-RoPE),
    an 8 x 2048 prefill and forward plain and on the (1, 1) mesh: logits,
    k cache and hidden states bit-equal, launches equal; (e) rank 0's
    share of olmoe-1b-7b's ``train_4k`` on 16x16 at its plan's 16 groups,
    as (b): the card's peak at most 1.02 of the count's (the count fills
    every slot of the dispatch, its upper bound), its steps' walls
    logged.

The kernels' bound columns (bytes and operations) are the kernel
modules' cost functions, the work the dry run counts.  The line before
the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero, and with no
card (or no checkout around this file) the script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU_SOURCE = "src/repro_torch/kernels/csrc/event_loop.cu"
REPLACES = {
    "event_finish": "src/repro/kernels/event_loop.py:138",
    "event_finish_fused": "src/repro/kernels/event_loop.py:174",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:27",
    "flash_attention": "src/repro/kernels/flash_attention.py:85",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:77",
    # the reference has no backward kernel: it trains through XLA's
    # autodiff of these twins of the TPU kernels, whose gradients the
    # backward kernels compute
    "rmsnorm_bwd": "src/repro/models/layers.py:20",
    "flash_attention_bwd": "src/repro/models/layers.py:91",
    "ssd_scan_bwd": "src/repro/models/ssm.py:36",
}
#: NVIDIA H100 SXM data sheet: HBM bandwidth, non-tensor float32 peak and
#: dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: kernel vs plain, float32, relative to the largest |plain| (sums in
#: another order); bfloat16 gets one bfloat16 ulp on top
MODEL_TOL = {"rmsnorm": 1e-6, "flash_attention": 1e-5, "ssd_scan": 1e-4}
#: Zamba2-7B, kernels against plain versions from the same weights.  In
#: bf16 the whole prefill is no test: the random-weight stack of 90 blocks
#: amplifies rounding differences along its depth, so two bf16 runs that
#: differ only in the order of float32 sums end up far apart (phase [9]
#: prints it: about 0.6 in relative L2, and each run about 0.7 from a
#: float32 run).  So bf16 is held block by block: each block's output,
#: from the same input, within one bf16 step of its value (2^-8, twice the
#: unit roundoff; the two compute the same function in float32 and round
#: the same few values to bf16).  The whole prefill is held in float32 on
#: two of the prompts, at every position, where the same amplification
#: acts on rounding of 2^-24: bound 1e-2; and the kernels' bf16 logits may
#: be no further from that float32 reference than the plain versions'
#: bf16 logits, with 25 % to spare.
BLOCK_REL_L2 = 2.0 ** -8
F32_LOGIT_REL_L2 = 1e-2
BF16_PARITY = 1.25
ZAMBA_BATCH, ZAMBA_PROMPT, ZAMBA_DECODE = 8, 2048, 64


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions on synthetic inputs
# ---------------------------------------------------------------------------

def synthetic_lanes(rng, B: int, K: int, P: int):
    """Lane arrays with every case the recurrence has: ragged counts with
    count == 0 and count == K lanes, fully forced rows, partly forced rows,
    equal-jitter lanes and equal-cost lanes (exact ties every step)."""
    count = rng.integers(0, K + 1, B).astype(np.int32)
    count[::17] = 0
    count[1::13] = K
    forced = np.full((B, K), -1, np.int32)
    forced[2::7] = rng.integers(0, P, (len(range(2, B, 7)), K))
    part = rng.random((B, K)) < 0.1
    part[3::5] = False
    forced[part] = rng.integers(0, P, int(part.sum()))
    jitter = (rng.random((B, P)) * 45e-6).astype(np.float32)
    jitter[4::6] = 0.0
    speed = np.clip(1.0 + 0.01 * rng.standard_normal((B, P)), 0.8,
                    1.25).astype(np.float32)
    speed[5::6] = 1.0
    h_eff = np.full(B, 0.2e-6, np.float32)
    h_eff[::3] = 1.6e-6
    bcost = np.where(np.arange(B) % 4 == 0, 2e-6, 0.0).astype(np.float32)
    return count, forced, jitter, speed, h_eff, bcost


def phase_synthetic(device, grids_np: np.ndarray, N: int, seed: int = 0,
                    shapes=None):
    """Both kernels vs their plain versions; returns the mismatch counts."""
    from repro_torch.kernels import event_loop as ev

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rng = np.random.default_rng(seed)
    grids = dev(grids_np)
    S, G1 = grids_np.shape
    G = G1 - 1
    shapes = shapes or [(P, K, 4096 if K <= 4096 else 512)
                        for P in (8, 16, 20, 56, 128)
                        for K in (256, 4096, 65536)]
    results = []
    for P, K, B in shapes:
        count, forced, jitter, speed, h_eff, bcost = synthetic_lanes(
            rng, B, K, P)
        eff = (rng.random((B, K)) * 1e-4).astype(np.float32)
        eff[6::6] = 3e-5                    # equal costs: ties every step
        args = [dev(a) for a in (eff, speed, jitter, h_eff, bcost, forced,
                                 count)]
        got = ev.event_finish(*args)
        want = ev.event_finish_ref(*args)
        bad_plain = int((got != want).sum())

        sizes = rng.integers(1, max(2, 2 * N // K), (B, K)).astype(np.int32)
        starts = (rng.random((B, K)) * (N - sizes)).astype(np.int32)
        loc = (1.0 + 0.5 * rng.random((B, K))).astype(np.float32)
        noise = np.exp(0.025 * rng.standard_normal((B, K))).astype(np.float32)
        loc[6::6] = 1.0
        noise[6::6] = 1.0
        gid = rng.integers(0, S, B).astype(np.int32)
        gscale = np.full(B, np.float32(G) * np.float32(1.0 / N), np.float32)
        fargs = [grids] + [dev(a) for a in (gid, gscale, starts, sizes, loc,
                                            noise, speed, jitter, h_eff,
                                            bcost, forced, count)]
        got = ev.event_finish_fused(*fargs)
        want = ev.event_finish_fused_ref(*fargs)
        bad_fused = int((got != want).sum())
        log(f"  P={P:3d} K={K:6d} B={B:5d}: event_finish mismatches "
            f"{bad_plain}, event_finish_fused mismatches {bad_fused}")
        results.append((P, K, B, bad_plain, bad_fused))
    return results


# ---------------------------------------------------------------------------
# phase 4: the campaign path
# ---------------------------------------------------------------------------

def sweep(app: str, backend, T=None, reps: int = 3):
    from repro_torch import sweep_portfolio
    t0 = time.perf_counter()
    sw = sweep_portfolio(app, "epyc", T=T, reps=reps, backend=backend)
    if backend.device.type == "cuda":
        torch.cuda.synchronize(backend.device)
    return sw, time.perf_counter() - t0


def check_sweep(sw, T: int, n_loops: int) -> None:
    require(len(sw.runs) == 24, f"{sw.app}: {len(sw.runs)} runs, want 24")
    for key, run in sw.runs.items():
        require(run.times.shape == (T, n_loops), f"{sw.app} {key} shape")
        require(bool(np.all(np.isfinite(run.times))) and
                bool(np.all(run.times > 0)), f"{sw.app} {key} times")
        require(bool(np.all(np.isfinite(run.libs))), f"{sw.app} {key} libs")
    require(np.isfinite(sw.oracle_total()) and sw.oracle_total() > 0,
            f"{sw.app}: oracle_total")
    require(np.isfinite(sw.cov()) and sw.cov() > 0, f"{sw.app}: cov")


def small_sweeps(backend):
    """Both cells at full width, T = 2, one rep: small enough for the plain
    CPU path, so the card's results can be held against the CPU's."""
    from repro_torch import sweep_portfolio
    return [sweep_portfolio(app, "epyc", T=2, reps=1, backend=backend)
            for app in ("mandelbrot", "tc")]


def same_sweeps(a, b, lib_atol: float = 0.0) -> bool:
    """Loop times bit-equal; ``lib`` within ``lib_atol`` percentage points
    (0: equal; the CPU and the card sum its float32 row mean in different
    orders)."""
    return all(
        np.array_equal(x.runs[k].times, y.runs[k].times)
        and np.allclose(x.runs[k].libs, y.runs[k].libs, rtol=0,
                        atol=lib_atol)
        for x, y in zip(a, b) for k in x.runs)


# ---------------------------------------------------------------------------
# phase 5: the what-if path
# ---------------------------------------------------------------------------

def wave_inputs(seed: int, n_requests: int = 256, R: int = 8):
    rng = np.random.default_rng(seed)
    tokens = rng.lognormal(5.0, 1.0, n_requests)
    cost = 2e-5 + 1e-6 * tokens
    prefix = np.concatenate([[0.0], np.cumsum(cost)])
    avail = rng.random(R) * 1e-3
    return prefix, avail


def what_if_thunks(backend, seed: int = 0):
    """(name, call) of each what-if call: a 256-request wave over 8
    replicas for all 12 algorithms at the default chunk and at expChunk,
    and a 4-group x 8-replica fleet routing decision over 6 request shards
    (144 candidate rows)."""
    from repro_torch.core import N_ALGORITHMS, exp_chunk
    R = 8
    prefix, avail = wave_inputs(seed)
    N = len(prefix) - 1
    algs = list(range(N_ALGORITHMS))
    calls = [(f"what_if_wave(chunk_param={cp})",
              lambda cp=cp: backend.what_if_wave(prefix, R, avail, 0.2e-6,
                                                 5e-6, algs, chunk_param=cp))
             for cp in (0, exp_chunk(N, R))]
    rng = np.random.default_rng(seed + 1)
    group_avail = [rng.random(R) * 2e-3 for _ in range(4)]
    prefixes, avails = [], []
    for s in range(6):
        p, _ = wave_inputs(seed + 10 + s, n_requests=int(rng.integers(
            64, 400)))
        prefixes.append(p)
        avails.append(group_avail[s % 4])
    cands = [(s, a, cp) for s in range(6) for a in algs
             for cp in (0, exp_chunk(len(prefixes[s]) - 1, R))]
    calls.append(("what_if_routes", lambda: backend.what_if_routes(
        prefixes, R, avails, 0.2e-6, 5e-6, cands)))
    return calls


def what_if_calls(backend, seed: int = 0):
    return [call() for _, call in what_if_thunks(backend, seed)]


def what_if_latency(backend, device, reps: int = 5):
    """Each what-if call's wall time on the host clock, synchronized, after
    one warm call: mean, least and largest over ``reps`` calls (ms), and
    the event core's card time in it (``core_ms``, the backend's CUDA
    events)."""
    rows = []
    for name, call in what_if_thunks(backend):
        call()
        walls, cores = [], []
        for _ in range(reps):
            backend.times.reset()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize(device)
            walls.append((time.perf_counter() - t0) * 1e3)
            cores.append(backend.times.core_ms)
        mean, core = sum(walls) / reps, sum(cores) / reps
        rows.append({"call": name, "wall_ms": mean, "wall_min_ms":
                     min(walls), "wall_max_ms": max(walls), "core_ms": core,
                     "core_share": core / mean})
    return rows


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

def time_call(fn, args, reps: int, device, flush) -> float:
    """Mean ms of ``fn(*args)`` over ``reps`` launches, each after an L2
    flush (the path's inputs are fresh copies, cold in L2)."""
    fn(*args)
    torch.cuda.synchronize(device)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def _live(forced, count):
    cnt = count.long()
    K = forced.shape[1]
    live = torch.arange(K, device=forced.device)[None, :] < cnt[:, None]
    return int(cnt.sum()), int(((forced < 0) & live).sum())


def grid_reads(grids, gid, gscale, starts, sizes, count):
    """Distinct grid elements the live chunks read — ``row[i]`` and
    ``row[i + 1]`` at both ends of each chunk, indexed as ``prefix_costs``
    indexes them — and the distinct 32-byte sectors that hold them."""
    G = grids.shape[1] - 1
    live = (torch.arange(starts.shape[1], device=starts.device)[None, :]
            < count.long()[:, None])
    gs = gscale[:, None].expand_as(starts)[live]
    base = (gid.long() * (G + 1))[:, None].expand_as(starts)[live]
    idx = []
    for x in (starts[live], (starts + sizes)[live]):
        i = (x.to(torch.float32) * gs).to(torch.int32).clamp(0, G - 1).long()
        idx += [base + i, base + i + 1]
    elems = torch.cat(idx).unique()
    return int(elems.numel()), int((elems // 8).unique().numel())


def fused_bound(args):
    """Bytes and operations of one event_finish_fused call on these inputs:
    each input read once for the live chunks (start, size, loc, noise,
    forced: 20 B a chunk), the distinct grid elements those chunks read, the
    per-lane rows (speed, jitter and five scalars) and the output; an argmin
    over P (P - 1 compares) per chunk not forced, and 16 float32 operations
    a chunk for the interpolation, scaling and update."""
    grids, gid, gscale, starts, sizes = args[:5]
    speed, forced, count = args[7], args[11], args[12]
    B, P = speed.shape
    n_live, n_argmin = _live(forced, count)
    n_grid, _ = grid_reads(grids, gid, gscale, starts, sizes, count)
    nbytes = 20 * n_live + 4 * n_grid + 4 * B * (2 * P + 5) + 4 * B * P
    return nbytes, n_argmin * (P - 1) + 16 * n_live


def plain_bound(args):
    """As :func:`fused_bound` for event_finish: eff and forced (8 B a
    chunk), the per-lane rows (speed, jitter and three scalars), the output;
    4 operations a chunk for the update."""
    eff, speed, _, _, _, forced, count = args
    B, P = speed.shape
    n_live, n_argmin = _live(forced, count)
    nbytes = 8 * n_live + 4 * B * (2 * P + 3) + 4 * B * P
    return nbytes, n_argmin * (P - 1) + 4 * n_live


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 7: the model kernels vs their plain versions, synthetic inputs
# ---------------------------------------------------------------------------

def bf16_ulp(x):
    mag = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def tol_ratio(got, want, name: str) -> float:
    """Largest error over its bound: MODEL_TOL[name] times max |want|, one
    bfloat16 ulp more for bfloat16 outputs.  <= 1 passes."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        err = err - torch.maximum(bf16_ulp(g), bf16_ulp(w))
    bound = MODEL_TOL[name] * max(float(w.abs().max()), 1e-30)
    return max(float(err.max()), 0.0) / bound


def randn(shape, dtype, device, seed, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def ssd_inputs(b, S, nh, hp, st, dtype, device, seed):
    """SSD inputs as the model makes them: dt a softplus, A = -exp(A_log)
    with the model's A_log, B and C in float32."""
    dt = torch.nn.functional.softplus(
        randn((b, S, nh), torch.float32, device, seed))
    A = -torch.linspace(1.0, 16.0, nh, device=device)
    return (randn((b, S, nh, hp), dtype, device, seed + 1, 0.5), dt, A,
            randn((b, S, st), torch.float32, device, seed + 2, 0.5),
            randn((b, S, st), torch.float32, device, seed + 3, 0.5))


def phase_model_kernels(device):
    """Each model kernel against its plain version at the tests' shapes and
    the paths' widths (D = 3584 and 7168; hd = 112; hp = st = 64, chunk
    256; whisper-small's 12 heads of 64 over 1,500 frames; mamba2-2.7b's
    state of 128, and 96 below it); returns (name, case, ratio) rows."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RMS
    from repro_torch.kernels import ssd_scan as SSD
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # the last five: QK-norm rows (D = 128, sub-warp row groups), D no
    # multiple of a 16-byte chunk, odd D (misaligned rows), a block a row
    # at more rows than SMs, and rows wider than the registers
    for shape in ((8, 128), (3, 17, 64), (16, 3584), (8, 7168),
                  (8, 2048, 128), (3, 17, 100), (300, 4097), (256, 3584),
                  (3, 20000)):
        for xd, wd in ((f32, f32), (bf16, bf16), (f32, bf16)):
            x = randn(shape, xd, device, 1)
            w = randn(shape[-1:], wd, device, 2)
            rows.append(("rmsnorm", (shape, str(xd), str(wd)), tol_ratio(
                RMS.rmsnorm(x, w), RMS.rmsnorm_ref(x, w), "rmsnorm")))
    # the last three: whisper-small's encoder (1,500 frames, no multiple
    # of the 64-key tile), its decoder prompt and its decode step (one
    # query) against the 1,500 frames
    for B, S, T, H, K, hd in ((1, 128, 128, 4, 4, 64),
                              (2, 96, 160, 8, 2, 32),
                              (1, 257, 129, 6, 3, 64),
                              (2, 512, 512, 8, 8, 112),
                              (2, 100, 72, 4, 2, 112),
                              (8, 1500, 1500, 12, 12, 64),
                              (8, 32, 1500, 12, 12, 64),
                              (8, 1, 1500, 12, 12, 64)):
        for dt in (f32, bf16):
            q = randn((B, S, H, hd), dt, device, 3)
            k = randn((B, T, K, hd), dt, device, 4)
            v = randn((B, T, K, hd), dt, device, 5)
            for causal in (True, False):
                rows.append(("flash_attention",
                             ((B, S, T, H, K, hd), str(dt), causal),
                             tol_ratio(FA.flash_attention(q, k, v,
                                                          causal=causal),
                                       FA.flash_attention_ref(
                                           q, k, v, causal=causal),
                                       "flash_attention")))
    # the last two run the kernels' tiles of 128 state columns: 96
    # (zero-filled) and mamba2-2.7b's 128
    for b, S, nh, hp, st, chunk in ((1, 64, 4, 32, 16, 16),
                                    (2, 128, 8, 32, 16, 32),
                                    (1, 96, 6, 16, 8, 32),
                                    (2, 1024, 16, 64, 64, 256),
                                    (2, 1024, 16, 64, 96, 256),
                                    (2, 1024, 16, 64, 128, 256)):
        for dt in (f32, bf16):
            args = ssd_inputs(b, S, nh, hp, st, dt, device, 6)
            y, h = SSD.ssd_scan(*args, chunk=chunk)
            y_ref, h_ref = SSD.ssd_scan_ref(*args, chunk=chunk)
            case = ((b, S, nh, hp, st, chunk), str(dt))
            rows.append(("ssd_scan", case + ("y",),
                         tol_ratio(y, y_ref, "ssd_scan")))
            rows.append(("ssd_scan", case + ("state",),
                         tol_ratio(h, h_ref, "ssd_scan")))
    torch.cuda.synchronize(device)
    return rows


# ---------------------------------------------------------------------------
# phases 8-10: Zamba2-7B on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Run the model on the kernels' plain versions: the model modules'
    names for the three kernels point at the plain versions while the
    context is open."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RMS
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import layers, ssm
    swaps = [(layers, "rmsnorm", RMS.rmsnorm_ref),
             (layers, "flash_attention", FA.flash_attention_ref),
             (ssm, "rmsnorm", RMS.rmsnorm_ref),
             (ssm, "ssd_scan", SSD.ssd_scan_ref)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def model_counts():
    from repro_torch import kernels
    c = kernels.launch_counts()
    return {k: c[k] for k in ("rmsnorm", "flash_attention", "ssd_scan")}


def phase_zamba(device):
    """Zamba2-7B at full width, bf16: prefill, then decode through the
    continuous batcher; then the same prefill on the plain versions."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_requests
    from repro_torch.launch.serve import live
    from repro_torch.models import (decode_step, init_decode_cache,
                                    init_params, prefill)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[8] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    cfg = get_config("zamba2-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    torch.cuda.synchronize(device)
    n_par = sum(t.numel() for g in params.values()
                for t in (g.values() if isinstance(g, dict) else [g]))
    log(f"[8] init_params: {n_par} parameters ({cfg.n_params()} by the "
        f"config), {torch.cuda.memory_allocated(device) / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s")
    B, S = ZAMBA_BATCH, ZAMBA_PROMPT
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(device)

    prefill(cfg, params, tokens[:, :cfg.ssm_chunk])     # warm-up, not kept
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, tokens, max_len=S + ZAMBA_DECODE)
    torch.cuda.synchronize(device)
    prefill_s = time.perf_counter() - t0
    prefill_counts = model_counts()
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[8] prefill {B} x {S}: {prefill_s:.3f} s, launches "
        f"{json.dumps(prefill_counts)}, peak {peak / 1e9:.2f} GB")
    note_cell("[8]", cfg, "prefill", B, S, prefill_s, peak, prefill_counts,
              max_len=S + ZAMBA_DECODE, allocated=before)
    require(prefill_counts == {"rmsnorm": 181, "flash_attention": 9,
                               "ssd_scan": 81},
            f"prefill launches {prefill_counts}, want 181 / 9 / 81")
    require(tuple(logits.shape) == (B, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "prefill logits")

    first = logits.argmax(-1).to(torch.int32)
    warm = init_decode_cache(cfg, B, 16, device=device)   # warm-up, not kept
    decode_step(cfg, params, warm, first)
    torch.cuda.synchronize(device)
    del warm
    reqs = synthetic_requests(16, seed=0, mean_gen=32)
    kernels.reset_launch_counts()
    stats, per_tok = live(cfg, params, slots=B, device=device,
                          requests=reqs, cache=cache, tokens=first,
                          max_steps=ZAMBA_DECODE)
    decode_counts = model_counts()
    del cache
    log(f"[8] decode: {json.dumps(stats)}, per-token "
        f"{per_tok * 1e6:.1f} us, launches {json.dumps(decode_counts)}")
    prof = profile_decode(cfg, params, device, B, S + ZAMBA_DECODE)
    log(f"[8] decode step profile: {json.dumps(prof)}")
    require(0 < stats["steps"] <= ZAMBA_DECODE, "decode steps")
    require(decode_counts == {"rmsnorm": 181 * stats["steps"],
                              "flash_attention": 0, "ssd_scan": 0},
            f"decode launches {decode_counts}")

    kernels.reset_launch_counts()
    with plain_kernels():
        t0 = time.perf_counter()
        logits_p, cache_p = prefill(cfg, params, tokens)
        torch.cuda.synchronize(device)
        plain_s = time.perf_counter() - t0
    require(all(v == 0 for v in model_counts().values()),
            "the plain prefill launched a kernel")
    del cache_p
    require(bool(torch.isfinite(logits_p).all()), "plain prefill logits")
    bf16_rel = rel_l2(logits, logits_p)
    log(f"[9] plain prefill on the card: {plain_s:.3f} s; bf16 logits rel "
        f"L2 kernels vs plain {bf16_rel}; top-1 equal on "
        f"{int((logits.argmax(-1) == logits_p.argmax(-1)).sum())} of {B}")

    blocks = block_check(cfg, params, tokens)
    worst = max(blocks, key=lambda r: r[1])
    median = sorted(r[1] for r in blocks)[len(blocks) // 2]
    log(f"[9] {len(blocks)} blocks, bf16, kernels vs plain from the same "
        f"input: worst rel L2 {worst[1]} at {worst[0]} (bound "
        f"{BLOCK_REL_L2}); median {median}")
    require(worst[1] <= BLOCK_REL_L2, f"block {worst[0]}: {worst[1]}")

    f32 = f32_check(cfg, params, tokens[:2], logits[:2], logits_p[:2])
    log(f"[9] float32, 2 x {S}: {json.dumps(f32)}")
    require(f32["rel_l2"] <= F32_LOGIT_REL_L2,
            f"float32 kernels vs plain logits rel L2 {f32['rel_l2']}")
    require(f32["top1_agree"], "float32 top-1 differs on a clear row")
    require(f32["bf16_kernels_vs_f32"]
            <= BF16_PARITY * f32["bf16_plain_vs_f32"],
            "the kernels' bf16 logits stray further from float32 than the "
            "plain versions'")
    del params
    torch.cuda.empty_cache()
    return {"prefill_s": prefill_s, "plain_prefill_s": plain_s,
            "prefill_tokens": B * S, "decode": stats,
            "per_token_s": per_tok, "decode_profile": prof,
            "bf16_logits_rel_l2": bf16_rel,
            "block_worst_rel_l2": worst[1], "float32": f32,
            "launches": {k: prefill_counts[k] + decode_counts[k]
                         for k in prefill_counts},
            "prefill_launches": prefill_counts,
            "decode_launches": decode_counts}


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def block_check(cfg, params, tokens):
    """Each of the model's blocks (81 Mamba2 layers, 9 applications of the
    shared attention block) on the kernels and on the plain versions from
    the same input, the kernels' output carried on; returns (block, rel L2)
    rows."""
    from repro_torch.models import model as M
    from repro_torch.models.ssm import ssm_layer_apply
    B, S = tokens.shape
    x = params["embed"][tokens]
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    rows = []
    for seg in range(cfg.n_layers // cfg.attn_every):
        for j in range(cfg.attn_every):
            i = seg * cfg.attn_every + j
            p = M.layer_params(params, i)
            out, _ = ssm_layer_apply(p, x, cfg)
            with plain_kernels():
                ref, _ = ssm_layer_apply(p, x, cfg)
            rows.append((f"mamba{i}", rel_l2(out, ref)))
            x = out
        out, _ = M._dense_block(params["shared_attn"], cfg, x, pos)
        with plain_kernels():
            ref, _ = M._dense_block(params["shared_attn"], cfg, x, pos)
        rows.append((f"attn{seg}", rel_l2(out, ref)))
        x = out
    return rows


def f32_check(cfg, params, tokens, logits_k, logits_p, embeds=None):
    """The trunk of the prefill of ``tokens`` (and the enc-dec family's
    ``embeds``) in float32 (the bf16 weights widened) on the kernels and
    on the plain versions, with the logits at every position; and the
    bf16 last-position logits of both runs against the plain float32
    ones."""
    from repro_torch.models import forward, logits_fn
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    p32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
               else v.float()) for k, v in params.items()}
    e32 = None if embeds is None else embeds.float()
    lk = logits_fn(cfg32, p32, forward(cfg32, p32, tokens, embeds=e32)[0])
    with plain_kernels():
        lp = logits_fn(cfg32, p32,
                       forward(cfg32, p32, tokens, embeds=e32)[0])
    del p32
    top2 = lp.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > (F32_LOGIT_REL_L2
                                              * lp.abs().amax(-1))
    same = lk.argmax(-1) == lp.argmax(-1)
    return {"rel_l2": rel_l2(lk, lp), "rows": int(same.numel()),
            "clear_rows": int(clear.sum()),
            "top1_agree": bool(same[clear].all()),
            "top1_equal": int(same.sum()),
            "bf16_kernels_vs_f32": rel_l2(logits_k, lp[:, -1]),
            "bf16_plain_vs_f32": rel_l2(logits_p, lp[:, -1])}


def check_f32(tag, f32):
    """The float32 gates of ``f32_check``'s record (see [9])."""
    require(f32["rel_l2"] <= F32_LOGIT_REL_L2,
            f"{tag} float32 kernels vs plain logits rel L2 {f32['rel_l2']}")
    require(f32["top1_agree"], f"{tag} float32 top-1 differs on a clear row")
    require(f32["bf16_kernels_vs_f32"]
            <= BF16_PARITY * f32["bf16_plain_vs_f32"],
            f"{tag}: the kernels' bf16 logits stray further from float32 "
            "than the plain versions'")


def device_us(e):
    """The card's own time of one ``key_averages()`` entry, in us."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v:
            return float(v)
    return 0.0


def traced_busy(prof, units: int, top: int = 5):
    """The card's busy ms (its kernels' and copies' device time) and
    launches per unit of a ``torch.profiler`` window over ``units``
    units of work, with the ``top`` entries that take the most."""
    rows = sorted(((device_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if device_us(e) > 0 and not e.key.startswith("aten")),
                  reverse=True)
    return (sum(us for us, _, _ in rows) / units / 1e3,
            sum(n for _, _, n in rows) / units,
            [(k[:60], us / units / 1e3, n / units)
             for us, k, n in rows[:top]])


#: the least share of the calls' own time (CUDA events, no profiler) that
#: the card time of a profiler window's kernels must make up for
#: ``kernel_parts_ms`` to keep the window
PARTS_MIN_SHARE = 0.9


def kernel_parts_ms(fn, args, names, device, reps=3):
    """Each named kernel's mean card time (ms) within one call of ``fn``,
    from ``torch.profiler`` over ``reps`` calls after one to warm up.  A
    window is kept only if each named kernel shows a whole number of
    launches a call and all its kernels' card time is at least
    PARTS_MIN_SHARE of the same calls' time by CUDA events just before it
    (a window that lost records reads short: ~0.48 of the SSD backward's
    kernels in one run); else it is logged and taken again, four times at
    most, and None means not measured."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(5):
        fn(*args)
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        stop.record()
        stop.synchronize()
        call_ms = start.elapsed_time(stop) / reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize(device)
        entries = prof.key_averages()
        counts = [sum(e.count for e in entries if n in e.key) for n in names]
        busy_ms = sum(device_us(e) for e in entries) / reps / 1e3
        if (all(c and c % reps == 0 for c in counts)
                and busy_ms >= PARTS_MIN_SHARE * call_ms):
            return {n: sum(device_us(e) for e in entries
                           if n in e.key) / reps / 1e3 for n in names}
        log(f"kernel_parts_ms: window {attempt} refused: launches "
            f"{dict(zip(names, counts))} over {reps} calls, card "
            f"{busy_ms:.4f} ms a call against {call_ms:.4f} by events")
    return None


def profile_decode(cfg, params, device, slots, max_len):
    """One decode step at a full cache (``max_len`` slots, ``max_len - 64``
    filled) under ``torch.profiler``: the step's wall time (host clock, over
    5 steps after 2 to warm up), the card's busy time in it, and the kernels
    that take the most."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, init_decode_cache
    cache = init_decode_cache(cfg, slots, max_len, device=device)
    tok = torch.zeros((slots,), dtype=torch.int32, device=device)
    cache["len"].fill_(max_len - 64)
    for _ in range(2):
        decode_step(cfg, params, cache, tok)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(5):
        decode_step(cfg, params, cache, tok)
    torch.cuda.synchronize(device)
    step_s = (time.perf_counter() - t0) / 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_step(cfg, params, cache, tok)
        torch.cuda.synchronize(device)
    busy_ms, launches, top = traced_busy(prof, 1, top=8)
    return {"step_s": step_s, "busy_ms": busy_ms, "launches": launches,
            "top": top}


def phase_small_card_vs_cpu(device, arch="zamba2-7b"):
    """The small ``arch`` (``smoke_reduce``) in float32, one set of weights
    on the CPU and on the card: prefill logits and caches, and two decode
    steps, within 1e-4 of the largest magnitude."""
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.models import decode_step, init_params, prefill
    cfg = smoke_reduce(get_config(arch))
    cpu = torch.device("cpu")
    p_cpu = init_params(cfg, 0, device=cpu)
    p_dev = {k: ({n: t.to(device) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(device))
             for k, v in p_cpu.items()}
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 66)))
    emb = (torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        if cfg.family == "encdec" else None)
    worst = 0.0

    def ratio(x, y):
        x, y = x.float().cpu(), y.float()
        return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)

    outs = []
    for dev, params in ((device, p_dev), (cpu, p_cpu)):
        t = toks.to(dev)
        logits, cache = prefill(cfg, params, t[:, :64], max_len=72,
                                embeds=None if emb is None else emb.to(dev))
        steps = [logits]
        for i in range(2):
            lg, cache = decode_step(cfg, params, cache, t[:, 64 + i])
            steps.append(lg)
        outs.append((steps, cache))
    (s_dev, c_dev), (s_cpu, c_cpu) = outs
    for x, y in zip(s_dev, s_cpu):
        worst = max(worst, ratio(x, y))
    for name in c_cpu:
        if name != "len":
            worst = max(worst, ratio(c_dev[name], c_cpu[name]))
    return worst


# ---------------------------------------------------------------------------
# phase 11: the model kernels timed at the main path's largest calls
# ---------------------------------------------------------------------------

def model_kernel_records(device, flush, launches):
    """Each model kernel at the prefill's largest call (bf16): rmsnorm on
    the gated norm (8 x 2048 rows of 7168), flash attention on the shared
    block (8 x 2048, 32 heads of 112, causal), the SSD scan on one Mamba2
    layer (8 x 2048, 112 heads of 64, state 64, chunk 256)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RMS
    from repro_torch.kernels import ssd_scan as SSD
    F = torch.nn.functional
    bf16 = torch.bfloat16
    B, S = ZAMBA_BATCH, ZAMBA_PROMPT
    out = []

    def record(name, args, fn, ref, lib, nbytes, ops, ops_rate, shape,
               reps=20, plain_reps=3, turns=False):
        got, want = fn(*args), ref(*args)
        if isinstance(got, tuple):
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            ratio = max(tol_ratio(g, w, name) for g, w in zip(got, want))
        else:
            err = float((got.float() - want.float()).abs().max())
            ratio = tol_ratio(got, want, name)
        del got, want
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ops_rate * 1e3
        if turns:       # in turns with the library call
            t = turns_ms({"ms": lambda: fn(*args),
                          "library_ms": lambda: lib(*args)}, reps, device,
                         flush)
        else:
            t = {"ms": time_call(fn, args, reps, device, flush),
                 "library_ms": (None if lib is None else
                                time_call(lib, args, reps, device, flush))}
        ms = t["ms"]
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "tol_ratio": ratio,
            "ms": ms, "tflops": ops / ms * 1e-9,
            "plain_ms": time_call(ref, args, plain_reps, device, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"],
            "shape": shape, "bytes": nbytes, "ops": ops})

    D = 7168
    x, w = randn((B, S, D), bf16, device, 7), randn((D,), bf16, device, 8)
    rows = B * S
    ops, nbytes = RMS.rmsnorm_cost(rows, D, 2, 2)
    record("rmsnorm", (x, w), RMS.rmsnorm, RMS.rmsnorm_ref,
           lambda x, w: F.rms_norm(x, (D,), w, 1e-5),
           nbytes=nbytes, ops=ops, ops_rate=F32_OPS_PER_S,
           shape={"rows": rows, "D": D}, reps=50, turns=True)
    out[-1]["rerun_bit_equal"] = torch.equal(RMS.rmsnorm(x, w),
                                             RMS.rmsnorm(x, w))
    out[-1]["device_ms"] = device_ms(lambda: RMS.rmsnorm(x, w), device)
    out[-1]["library_device_ms"] = device_ms(
        lambda: F.rms_norm(x, (D,), w, 1e-5), device)
    del x, w
    # decode's calls: 8 slots of d_model (3584) and of the gated norm (7168)
    out[-1]["at_decode_call"] = [
        rmsnorm_record(randn((B, d), bf16, device, 70 + 2 * i),
                       randn((d,), bf16, device, 71 + 2 * i), device, flush)
        for i, d in enumerate((3584, 7168))]

    H, hd = 32, 112
    q, k, v = (randn((B, S, H, hd), bf16, device, 9 + i) for i in range(3))
    ops, nbytes = FA.flash_attention_cost(B, S, S, H, H, hd, True, 2)
    record("flash_attention", (q, k, v), FA.flash_attention,
           FA.flash_attention_ref,
           lambda q, k, v: F.scaled_dot_product_attention(
               q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               is_causal=True),
           nbytes=nbytes, ops=ops, ops_rate=BF16_OPS_PER_S,
           shape={"B": B, "S": S, "T": S, "H": H, "K": H, "hd": hd,
                  "causal": True}, plain_reps=2)
    del q, k, v

    nh, hp, st, Q = 112, 64, 64, 256
    args = ssd_inputs(B, S, nh, hp, st, bf16, device, 12)
    ops, nbytes = SSD.ssd_scan_cost(B, S, nh, hp, st, Q, 2)
    record("ssd_scan", args, lambda *a: SSD.ssd_scan(*a, chunk=Q),
           lambda *a: SSD.ssd_scan_ref(*a, chunk=Q), None,
           nbytes=nbytes, ops=ops, ops_rate=BF16_OPS_PER_S,
           shape={"b": B, "S": S, "nh": nh, "hp": hp, "st": st,
                  "chunk": Q}, reps=10, plain_reps=2)
    # the bf16 scan is three kernels: their shares of the call
    out[-1]["parts_ms"] = kernel_parts_ms(
        lambda *a: SSD.ssd_scan(*a, chunk=Q), args,
        ("ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel"), device)
    return out


def device_ms(fn, device, reps=20):
    """The card time (ms) of every kernel in one call of ``fn()``, from
    ``torch.profiler`` over ``reps`` calls after one to warm up (at a few
    rows the CUDA events around a call time the wrapper's host work); a
    window that reports no device time is taken again, twice at most, and
    None means not measured."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        us = sum(device_us(e) for e in prof.key_averages()
                 if not e.key.startswith("aten"))
        if us > 0:
            return us / reps / 1e3
    return None


def rmsnorm_record(x, w, device, flush, plain_reps=10):
    """The rmsnorm forward at one bf16 call: held against its plain version
    (``tol_ratio``), a rerun's bits, its time with the wrapper (CUDA events
    after an L2 flush, in turns with ``F.rms_norm``'s), the card time of
    its kernel and of ``F.rms_norm``'s kernels alone (the profiler), its
    plain version's time and the byte bound."""
    from repro_torch.kernels import rmsnorm as RMS
    D = x.shape[-1]
    rows = x.numel() // D
    y, y_ref = RMS.rmsnorm(x, w), RMS.rmsnorm_ref(x, w)

    def kernel():
        return RMS.rmsnorm(x, w)

    def lib():
        return torch.nn.functional.rms_norm(x, (D,), w, 1e-5)
    return with_bound({
        "shape": {"rows": rows, "D": D, "dtype": "bfloat16"},
        "max_abs_err": float((y.float() - y_ref.float()).abs().max()),
        "tol_ratio": tol_ratio(y, y_ref, "rmsnorm"),
        "rerun_bit_equal": torch.equal(y, kernel()),
        **turns_ms({"ms": kernel, "library_ms": lib}, 50, device, flush),
        "device_ms": device_ms(kernel, device),
        "library_device_ms": device_ms(lib, device),
        "plain_ms": time_call(RMS.rmsnorm_ref, (x, w), plain_reps, device,
                              flush),
        **work(RMS.rmsnorm_cost(rows, D, x.element_size(),
                                w.element_size()))},
        F32_OPS_PER_S)


# ---------------------------------------------------------------------------
# phase 12: the selection-policy layer (selector replays, the Fig. 5 cell)
# ---------------------------------------------------------------------------

REPLAY_CELL = ("mandelbrot", "epyc")
#: the Fig. 5 replay runs the cell's first 60 of its 500 steps (300 when
#: phase [18] took the script past 1,050 s, 275 when [19] did, 125 when
#: [20] did, 110 when [22] did, 60 when [25] took a slow host's run to
#: 1,213.8 s; [13b]'s clean twins need its first PERTURB_T steps); the
#: plain event core's check runs at T = 5: its per-chunk torch loop
#: makes each pricing miss a fraction of a second (T = 50, then 30, 20,
#: 10, each cut as the script's wall neared its limit)
REPLAY_T, REPLAY_CHECK_T, REPLAY_CPU_T = 60, 5, 4
LEARNED_HIDDEN = 32


def learned_state(seed: int = 0):
    """A learned policy state over random weights from a seeded numpy
    generator (the trainer's layout: two GELU layers, one output a
    portfolio algorithm)."""
    from repro_torch.core import N_ALGORITHMS, N_FEATURES, make_learned_state
    rng = np.random.default_rng(seed)
    H = LEARNED_HIDDEN
    shapes = {"w0": (N_FEATURES, H), "b0": (H,), "w1": (H, H), "b1": (H,),
              "w2": (H, N_ALGORITHMS), "b2": (N_ALGORITHMS,)}
    return make_learned_state({k: (0.3 * rng.standard_normal(sh)).astype(
        np.float32) for k, sh in shapes.items()})


def policy_states(run):
    """Each loop's policy state (``state_dict``, or the expert ladder's
    position where there is none), as JSON text."""
    out = {}
    for nm in run.history:
        policy = run.service.policy(nm)
        state = policy.state_dict()
        if state is None:
            expert = getattr(policy, "_expert", policy)
            state = {"current": getattr(expert, "current", None)}
        out[nm] = json.dumps(state, sort_keys=True)
    return out


def same_campaign(a, b) -> bool:
    """Two campaign results of one cell: oracle, degradation, and every
    lane's history, total and policy states, bit for bit."""
    return (a.oracle_total == b.oracle_total
            and a.degradation() == b.degradation()
            and a.selector_runs.keys() == b.selector_runs.keys()
            and all(r.history == b.selector_runs[k].history
                    and r.total == b.selector_runs[k].total
                    and policy_states(r) == policy_states(b.selector_runs[k])
                    for k, r in a.selector_runs.items()))


def whatifs(runs):
    """The distinct ``LoopWhatIf`` pricers of the SIM lanes of ``runs``."""
    seen = {}
    for run in runs:
        for nm in run.history:
            sim = getattr(run.service.policy(nm), "simulator", None)
            if sim is not None:
                seen[id(sim)] = sim
    return list(seen.values())


def fused_of(bk):
    return [a for n, a in bk.core_calls if n == "event_finish_fused"]


def replay_campaign(device):
    """The Fig. 5 campaign at T = ``REPLAY_T`` on the kernels: sweep,
    replay and pricing each on its own backend, so each path's launches
    and times read apart."""
    from repro_torch import TorchBatchedBackend, kernels
    from repro_torch.sim import SIM_SELECTOR_GRID, run_campaign
    sweep_bk, replay_bk, price_bk = (TorchBatchedBackend() for _ in range(3))
    for b in (sweep_bk, replay_bk, price_bk):
        b.core_calls = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_campaign([REPLAY_CELL], T=REPLAY_T, reps=3,
                       selectors=SIM_SELECTOR_GRID, backend=sweep_bk,
                       selector_backend=replay_bk, sim_backend=price_bk)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()["event_finish_fused"]
    cr = res[REPLAY_CELL]
    calls = {"sweep": fused_of(sweep_bk), "replay": fused_of(replay_bk),
             "pricing": fused_of(price_bk)}
    for b in (sweep_bk, replay_bk, price_bk):
        b.core_calls = None
    require(launches == sum(len(c) for c in calls.values()),
            f"event_finish_fused launches {launches} != the core calls "
            f"{ {k: len(c) for k, c in calls.items()} }")
    require(len(calls["replay"]) > 0 and len(calls["pricing"]) > 0,
            "the replay or the pricing never launched event_finish_fused")
    require(len(cr.selector_runs) == 22, f"{len(cr.selector_runs)} lanes")
    n_loops = len(cr.sweep.runs[(0, "default")].times[0])
    for key, run in cr.selector_runs.items():
        require(np.isfinite(run.total) and run.total > 0, f"{key} total")
        require(sum(len(h) for h in run.history.values())
                == REPLAY_T * n_loops, f"{key}: trace length")
    deg = cr.degradation()
    require(all(np.isfinite(v) for v in deg.values()), "degradation nan")
    pricers = whatifs(cr.selector_runs.values())
    pricing = {"pricers": len(pricers),
               "calls": sum(w.calls for w in pricers),
               "misses": sum(w.misses for w in pricers),
               "wall_s": sum(w.wall_s for w in pricers)}
    rt = replay_bk.times
    record = {
        "phase": "replay", "cell": "/".join(REPLAY_CELL), "T": REPLAY_T,
        "reps": 3, "lanes": len(cr.selector_runs),
        "decisions": sum(len(h) for r in cr.selector_runs.values()
                         for h in r.history.values()),
        "wall_s": wall, "sweep_s": cr.walls["sweep_s"],
        "replay_s": cr.walls["replay_s"],
        "lockstep_calls": rt.lockstep_calls,
        "fused_launches": {k: len(c) for k, c in calls.items()},
        "fused_largest_B": {k: max((int(a[-1].shape[0]) for a in c),
                                   default=0) for k, c in calls.items()},
        "replay_path_times": dict(vars(rt)),
        "pricing": pricing,
        "pricing_path_times": dict(vars(price_bk.times)),
        "decide_learn_s": cr.walls["replay_s"] - rt.lockstep_s
        - pricing["wall_s"],
        "oracle_total": cr.oracle_total,
        "degradation": {"/".join(str(x) for x in k): v
                        for k, v in deg.items()}}
    # each lane's clean total over [13b]'s steps, its perturbed twin's scale
    totals = {k: sum(h[1] for hist in r.history.values()
                     for h in hist[:PERTURB_T])
              for k, r in cr.selector_runs.items()}
    return record, calls, totals


def profile_replay(device, warm: int = 8, steps: int = 4, lanes=None):
    """Steps ``warm`` to ``warm + steps - 1`` of the Fig. 5 replay of
    ``lanes`` (default: the SIM grid, both chunk modes; pricing on the
    replay's backend) on the host clock, then the next ``steps`` under
    ``torch.profiler``: the card's busy time (its kernels' device time) a
    step, its kernel launches and the kernels that take the most.  The idle
    share holds the busy time against the untraced step (tracing stretches
    the host, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import TorchBatchedBackend
    from repro_torch.sim import (CHUNK_MODES, SIM_SELECTOR_GRID, CellSpec,
                                 ReplayBatch)
    if lanes is None:
        lanes = [CellSpec(*REPLAY_CELL, sel, mode, reward)
                 for mode in CHUNK_MODES for sel, reward in SIM_SELECTOR_GRID]
    rb = ReplayBatch(lanes, T=REPLAY_T, backend=TorchBatchedBackend())
    for t in range(warm):
        rb.step(t)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for t in range(warm, warm + steps):
        rb.step(t)
    torch.cuda.synchronize(device)
    step_s = (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(warm + steps, warm + 2 * steps):
            rb.step(t)
        torch.cuda.synchronize(device)
    traced_s = (time.perf_counter() - t0) / steps
    busy_ms, launches, top = traced_busy(prof, steps, top=8)
    return {"step_s": step_s, "traced_step_s": traced_s,
            "busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / 1e3 / step_s,
            "launches_per_step": launches, "top": top}


def replay_checks(device):
    """The grid with two learned lanes: kernels against the plain event core
    on the card at T = REPLAY_CHECK_T, the card against the CPU at T = 4,
    bit-equal;
    returns what was compared."""
    from repro_torch import TorchBatchedBackend
    from repro_torch.core import set_default_state
    from repro_torch.sim import SIM_SELECTOR_GRID, run_campaign
    grid = SIM_SELECTOR_GRID + [("Learned", "LT"), ("LearnedHybrid", "LT")]
    set_default_state(learned_state())
    try:
        out = {}
        for label, T, a, b in (
                ("kernels == plain", REPLAY_CHECK_T, TorchBatchedBackend(),
                 TorchBatchedBackend(event_core="plain")),
                ("card == CPU", REPLAY_CPU_T, TorchBatchedBackend(),
                 TorchBatchedBackend(device="cpu"))):
            t0 = time.perf_counter()
            ra, rb = (run_campaign([REPLAY_CELL], T=T, reps=3,
                                   selectors=grid, backend=bk)[REPLAY_CELL]
                      for bk in (a, b))
            require(same_campaign(ra, rb), f"replay {label} at T = {T}: "
                    f"histories, totals or policy states differ")
            learned = ra.selector_runs[("Learned", "default", "LT")]
            require(learned.service.policy("L0").trained,
                    "the learned lane ran without its weights")
            out[label] = {"T": T, "lanes": len(ra.selector_runs),
                          "decisions": sum(
                              len(h) for r in ra.selector_runs.values()
                              for h in r.history.values()),
                          "wall_s": time.perf_counter() - t0}
    finally:
        set_default_state(None)
    return out


def simpolicy_oracle(backend):
    """SimPolicy's decision on the noise-free ``tc``/``epyc`` loop against
    the exhaustive Oracle (every candidate on the noise-free machine, seeds
    of its own)."""
    from repro_torch.core import OraclePolicy, SimPolicy
    from repro_torch.sim import (InstanceSpec, LoopWhatIf, get_application,
                                 get_system, noise_free)
    profile = get_application("tc").loops(0)[0]
    system = get_system("epyc")
    whatif = LoopWhatIf(system, backend=backend)
    whatif.set_context(profile, 0)
    cands = whatif.candidates()
    specs = [InstanceSpec(profile_id=0, alg=c.alg,
                          chunk_param=c.chunk_param or 0, seed=(7, i))
             for i, c in enumerate(cands)]
    times = backend.run_batch([profile], noise_free(system), specs).loop_time
    best = int(np.argmin(times))
    oracle = OraclePolicy(lambda t: cands[best].alg).decide()
    d = SimPolicy(whatif, reward="LT").decide()
    gap = np.partition(times, 1)
    return {"sim": [d.action, d.chunk_param, d.phase],
            "oracle": [oracle.action, cands[best].chunk_param],
            "runner_up_gap": float((gap[1] - gap[0]) / gap[0])}


# ---------------------------------------------------------------------------
# phase 13: perturbed and heterogeneous machines on the kernels
# ---------------------------------------------------------------------------

PERTURB_APP, PERTURB_SYSTEMS, PERTURB_SWEEP_T = "mandelbrot", ("epyc",
                                                              "epyc_het"), 5
PERTURB_ONSET, PERTURB_CPU_ONSET = 35, 2
#: [13b]'s depth: the T = 500 cell cut to keep the script inside its time
#: limit beside phases [17]-[22] (300 until [19] came, 275 until [20]
#: did, its onset at step 250); since [20] the cut keeps the cell's 25
#: steps after the onset and cuts those before it (to 100, onset at 100,
#: T = 125, until [22]; to 85, T = 110, until [25]; to 35 since, T = 60),
#: and each lane's total is held beside its clean twin's over the same
#: steps.  [13a]'s lane
#: sets run T = 5 (20 until [20], 10 until [22]): each kind of
#: perturbation is in force from step 0
PERTURB_T = 60
REACTIVE_LANES = [("ReactiveSim", "LT"), ("AwareSim", "LT")]
SIMULATE_ALGS = (1, 2, 3, 4, 6)


def perturb_kinds(P: int):
    """One ``PerturbationSpec`` of each kind, active from step 0."""
    from repro_torch.sim.perturb import (PEFailure, PerturbationSpec,
                                         drift_spec, noise_burst_spec,
                                         pe_slowdown_spec)
    return {"pe_slowdown": pe_slowdown_spec(P, 0.2, 8.0),
            "pe_failure": PerturbationSpec(failures=(
                PEFailure(pes=(3, P // 3, 2 * P // 3, P - 1)),)),
            "noise_burst": noise_burst_spec(6.0),
            "drift_cov": drift_spec("cov", factor=1.8)}


def perturbed_sweep(spec, system, backend, T: int):
    """The portfolio (12 algorithms x both chunk modes) on every loop of
    ``PERTURB_APP`` at steps 0 .. T-1 under ``spec`` (its drifted loops,
    its per-step ``InstancePerturb``), in one ``run_batch``."""
    from repro_torch.core import N_ALGORITHMS
    from repro_torch.sim import (CHUNK_MODES, InstanceSpec, chunk_param_for,
                                 get_application)
    app = get_application(PERTURB_APP)
    profiles, specs = [], []
    for t in range(T):
        ip = spec.instance_perturb(t, system.P)
        for li, p in enumerate(spec.loops(app, t)):
            pid = len(profiles)
            profiles.append(p)
            specs += [InstanceSpec(pid, alg, chunk_param_for(mode, p.N,
                                                             system.P),
                                   seed=(13, t, li, alg, m), perturb=ip)
                      for alg in range(N_ALGORITHMS)
                      for m, mode in enumerate(CHUNK_MODES)]
    res = backend.run_batch(profiles, system, specs)
    return res, sum(s.perturb is not None for s in specs)


def forced_whole(args) -> int:
    """Lanes of an event_finish_fused call whose every chunk is forced."""
    forced, count = args[11], args[12]
    K = forced.shape[1]
    live = (torch.arange(K, device=forced.device)[None, :]
            < count.long()[:, None])
    return int(((count > 0) & ~((forced < 0) & live).any(dim=1)).sum())


def perturbed_sweeps(device):
    """[13a]: every lane set on the kernels, the plain event core on the
    card and the CPU, bit-equal; what the kernels were given."""
    from repro_torch import TorchBatchedBackend, kernels
    from repro_torch.sim import get_system
    bk, pk, ck = (TorchBatchedBackend(), TorchBatchedBackend(
        event_core="plain"), TorchBatchedBackend(device="cpu"))
    bk.core_calls = []
    rows = []
    kernels.reset_launch_counts()
    for sysname in PERTURB_SYSTEMS:
        system = get_system(sysname)
        for kind, spec in perturb_kinds(system.P).items():
            t0 = time.perf_counter()
            n0 = len(bk.core_calls)
            got, n_pert = perturbed_sweep(spec, system, bk, PERTURB_SWEEP_T)
            calls = bk.core_calls[n0:]
            t1 = time.perf_counter()
            for label, other in (("the plain event core", pk),
                                 ("the CPU", ck)):
                want, _ = perturbed_sweep(spec, system, other,
                                          PERTURB_SWEEP_T)
                for f in ("loop_time", "lib", "n_chunks"):
                    require(np.array_equal(getattr(got, f),
                                           getattr(want, f)),
                            f"[13a] {sysname}/{kind}: {f} differs between "
                            f"the kernels and {label}")
            require(np.all(np.isfinite(got.loop_time))
                    and np.all(got.loop_time > 0), f"[13a] {kind} times")
            fused = [a for n, a in calls if n == "event_finish_fused"]
            rows.append({
                "system": sysname, "perturb": kind,
                "instances": len(got.loop_time),
                "perturbed_instances": n_pert,
                "fused_calls": len(fused),
                "largest_B": max(int(a[-1].shape[0]) for a in fused),
                "largest_K": max(int(a[3].shape[1]) for a in fused),
                "lanes_forced_whole": sum(forced_whole(a) for a in fused),
                "largest_speed": max(float(a[7].max()) for a in fused),
                "kernels_s": t1 - t0,
                "checks_s": time.perf_counter() - t1})
    launches = kernels.launch_counts()["event_finish_fused"]
    n_fused = sum(r["fused_calls"] for r in rows)
    bk.core_calls = None
    require(launches == n_fused > 0, f"[13a] {launches} fused launches, "
            f"{n_fused} core calls")
    return rows, launches


def replay_lanes(onset: int):
    from repro_torch.sim import CHUNK_MODES, SIM_SELECTOR_GRID, CellSpec
    from repro_torch.sim.perturb import pe_slowdown_spec
    spec = pe_slowdown_spec(128, frac=0.2, factor=8.0, t0=onset)
    return [CellSpec(*REPLAY_CELL, sel, mode, reward, perturb=spec)
            for mode in CHUNK_MODES
            for sel, reward in SIM_SELECTOR_GRID + REACTIVE_LANES]


def perturbed_replay(device, clean_totals):
    """[13b]: the perturbed Fig. 5 cell at T = ``PERTURB_T`` on the
    kernels, replay and pricing each on a backend of its own; returns the
    record and the perturbed steps' fused calls."""
    from repro_torch import TorchBatchedBackend, kernels
    from repro_torch.sim import ReplayBatch
    lanes = replay_lanes(PERTURB_ONSET)
    replay_bk, price_bk = TorchBatchedBackend(), TorchBatchedBackend()
    for b in (replay_bk, price_bk):
        b.core_calls = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rb = ReplayBatch(lanes, T=PERTURB_T, backend=replay_bk,
                     sim_backend=price_bk)
    marks = {}
    for t in range(PERTURB_T):
        if t == PERTURB_ONSET:
            torch.cuda.synchronize(device)
            marks = {"wall_s": time.perf_counter() - t0,
                     "replay": len(replay_bk.core_calls),
                     "pricing": len(price_bk.core_calls)}
        rb.step(t)
    runs = [lane.result() for lane in rb.lanes]
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()["event_finish_fused"]
    calls = {"replay": fused_of(replay_bk), "pricing": fused_of(price_bk)}
    after = (replay_bk.core_calls[marks["replay"]:]
             + price_bk.core_calls[marks["pricing"]:])
    perturbed = [a for n, a in after if n == "event_finish_fused"]
    for b in (replay_bk, price_bk):
        b.core_calls = None
    require(launches == sum(len(c) for c in calls.values()),
            f"[13b] {launches} fused launches != the core calls")
    require(len(runs) == 26, f"[13b] {len(runs)} lanes")
    n_loops = len(runs[0].history)
    lanes_out = {}
    for spec, run in zip(lanes, runs):
        require(np.isfinite(run.total) and run.total > 0,
                f"[13b] {spec.key} total")
        require(sum(len(h) for h in run.history.values())
                == PERTURB_T * n_loops, f"[13b] {spec.key}: trace length")
        after_onset = sum(h[1] for hist in run.history.values()
                          for h in hist[PERTURB_ONSET:])
        clean = clean_totals.get(spec.key)
        lanes_out["/".join(str(x) for x in spec.key)] = {
            "total": run.total, "clean_total": clean,
            "ratio": None if clean is None else run.total / clean,
            "after_onset": after_onset}
    pricers = whatifs(runs)
    pricing = {"pricers": len(pricers),
               "calls": sum(w.calls for w in pricers),
               "misses": sum(w.misses for w in pricers),
               "wall_s": sum(w.wall_s for w in pricers)}
    rt = replay_bk.times
    record = {
        "phase": "perturbed replay", "cell": "/".join(REPLAY_CELL),
        "T": PERTURB_T, "perturb": f"pe_slowdown_spec(128, 0.2, 8.0, "
        f"t0={PERTURB_ONSET})", "lanes": len(runs),
        "decisions": sum(len(h) for r in runs for h in r.history.values()),
        "wall_s": wall, "wall_before_onset_s": marks["wall_s"],
        "lockstep_calls": rt.lockstep_calls,
        "fused_launches": {k: len(c) for k, c in calls.items()},
        "fused_largest_B": {k: max((int(a[-1].shape[0]) for a in c),
                                   default=0) for k, c in calls.items()},
        "perturbed_calls": len(perturbed),
        "perturbed_lanes_forced_whole": sum(forced_whole(a)
                                            for a in perturbed),
        "replay_path_times": dict(vars(rt)),
        "pricing": pricing,
        "pricing_path_times": dict(vars(price_bk.times)),
        "decide_learn_s": wall - rt.lockstep_s - pricing["wall_s"],
        "lanes_by_key": lanes_out}
    return record, calls, perturbed


def perturbed_card_vs_cpu():
    """[13c]: the perturbed grid at T = 4, onset at step 2, card == CPU."""
    from repro_torch import TorchBatchedBackend
    from repro_torch.sim import ReplayBatch
    t0 = time.perf_counter()
    lanes = replay_lanes(PERTURB_CPU_ONSET)
    card, cpu = (ReplayBatch(lanes, T=REPLAY_CPU_T, backend=bk).run()
                 for bk in (TorchBatchedBackend(),
                            TorchBatchedBackend(device="cpu")))
    for spec, a, b in zip(lanes, card, cpu):
        require(a.history == b.history and a.total == b.total
                and policy_states(a) == policy_states(b),
                f"[13c] {spec.key}: card and CPU differ")
    return {"T": REPLAY_CPU_T, "onset": PERTURB_CPU_ONSET,
            "lanes": len(lanes), "wall_s": time.perf_counter() - t0}


def simulate_loops(device):
    """[13d]: ``simulate_loop`` on the card against the CPU for the
    non-adaptive algorithms on the first ``mandelbrot`` loop on ``epyc``;
    returns the rows and the kernel's calls."""
    from repro_torch import kernels
    from repro_torch.sim import get_application, get_system
    from repro_torch.sim.engine_torch import simulate_loop
    profile = get_application(PERTURB_APP).loops(0)[0]
    system = get_system("epyc")
    grid = np.asarray(profile.prefix_grid, np.float32)
    jitter = (np.random.default_rng(13).random(system.P)
              * system.jitter).astype(np.float32)
    rows = []
    kernels.reset_launch_counts()
    for alg in SIMULATE_ALGS:
        t0 = time.perf_counter()
        mk, fin, n = simulate_loop(alg, grid, profile.N, system.P, 64,
                                   h=system.h, jitter=jitter)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        _, fin_cpu, n_cpu = simulate_loop(alg, grid, profile.N, system.P,
                                          64, h=system.h, jitter=jitter,
                                          device="cpu")
        require(n == n_cpu and torch.equal(fin.cpu(), fin_cpu),
                f"[13d] simulate_loop alg {alg}: card and CPU differ")
        rows.append({"alg": alg, "chunks": n, "makespan": float(mk),
                     "wall_ms": wall * 1e3})
    launches = kernels.launch_counts()["event_finish"]
    require(launches == len(SIMULATE_ALGS),
            f"[13d] {launches} event_finish launches")
    return rows, launches


def phase_perturbed(device, flush, records, clean_totals):
    """Phase [13]; adds the perturbed paths' launches and the kernels'
    times at the perturbed replay's largest call to ``records``."""
    from repro_torch.kernels import event_loop as ev
    t0 = time.perf_counter()
    rows, sweep_launches = perturbed_sweeps(device)
    for r in rows:
        log(f"[13a] {json.dumps(r)}")
    log(f"[13a] kernels == plain on the card == CPU on {len(rows)} lane "
        f"sets, {sweep_launches} fused launches, "
        f"{time.perf_counter() - t0:.1f} s")
    replay, calls, perturbed = perturbed_replay(device, clean_totals)
    log(json.dumps(replay))
    log(f"[13b] perturbed replay from step 0, steps 8-15 (4 timed, 4 "
        f"traced): {json.dumps(profile_replay(device, lanes=replay_lanes(0)))}")
    card_cpu = perturbed_card_vs_cpu()
    log(f"[13c] card == CPU: {json.dumps(card_cpu)}")
    sim_rows, sim_launches = simulate_loops(device)
    log(f"[13d] simulate_loop card == CPU: {json.dumps(sim_rows)}")

    big = max(perturbed, key=lambda a: int(a[-1].long().sum()))
    at_fused = kernel_record(
        "event_finish_fused", len(perturbed), big, 1, ev.event_finish_fused,
        ev.event_finish_fused_ref, fused_bound, device, flush, reps=50,
        plain_reps=3)
    eff_args = [ev.prefix_costs(*big[:7])] + list(big[7:])
    at_plain = kernel_record(
        "event_finish", len(perturbed), eff_args, 0, ev.event_finish,
        ev.event_finish_ref, plain_bound, device, flush, reps=50,
        plain_reps=3)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "shape",
            "chain_steps", "chain_ms", "floor_ms", "max_abs_err")
    for rec, at in ((records[1], at_fused), (records[0], at_plain)):
        require(at["max_abs_err"] == 0.0, f"{rec['name']} disagrees at the "
                f"perturbed replay's largest call")
        rec["at_perturbed_call"] = {k: at[k] for k in keys}
        rec["at_perturbed_call"]["lanes_forced_whole"] = forced_whole(big)
        log(f"[13] {rec['name']} at the perturbed replay's largest call "
            f"{json.dumps(rec['at_perturbed_call'])}")
    fused = records[1]
    fused["launches_by_path"].update({
        "perturbed sweeps [13a]": sweep_launches,
        **{f"perturbed {k} [13b]": len(c) for k, c in calls.items()}})
    fused["launches"] = sum(fused["launches_by_path"].values())
    plain = records[0]
    plain["launches_by_path"] = {"what-if [5]": plain["launches"],
                                 "simulate_loop [13d]": sim_launches}
    plain["launches"] = sum(plain["launches_by_path"].values())


# ---------------------------------------------------------------------------
# phase 14: the serving dispatcher and the fleet
# ---------------------------------------------------------------------------

#: the fleet benchmark's tier-1 regime (``results/bench_fleet.json``): 4
#: groups x 8 replicas of SimPolicy dispatchers, 1024 requests a group a
#: wave, the bursty trace of 120,000 requests from seed 0
FLEET = dict(n_groups=4, replicas_per_group=8, selector="SimPolicy")
FLEET_QUOTA = 1024
FLEET_BURSTY = dict(base_rate=2000.0, burst_factor=6.0, p_enter=0.015,
                    p_exit=0.05)
FLEET_N = 120_000
#: the fault benchmark's tier-1 regime (``results/bench_faults.json``):
#: the same fleet on 60,000 requests, group 1 down for [0.65, 0.95] of the
#: trace's duration, recovery with 6 retries against recovery off
FAULTS_N = 60_000
FAIL_GROUP, FAIL_WINDOW = 1, (0.65, 0.95)
#: (d) and (e): journaled resume and card == plain card core == CPU
FLEET_SMALL_N = 6_000
#: requests of the profiled fleet window (about 20 waves)
PROFILE_N = 2_500


@contextlib.contextmanager
def counting_what_ifs(bk):
    """Count ``bk``'s what-if calls by kind and their host wall while the
    context is open, and keep the ``event_finish`` arguments and host wall
    of its largest ``what_if_routes`` call (by live chunks)."""
    stats = {"what_if_wave": 0, "what_if_routes": 0, "wave_s": 0.0,
             "routes_s": 0.0, "largest_routes": None}
    wave, routes = bk.what_if_wave, bk.what_if_routes

    def count_wave(*a, **k):
        t0 = time.perf_counter()
        out = wave(*a, **k)
        stats["wave_s"] += time.perf_counter() - t0
        stats["what_if_wave"] += 1
        return out

    def count_routes(*a, **k):
        bk.core_calls = []
        t0 = time.perf_counter()
        out = routes(*a, **k)
        wall = time.perf_counter() - t0
        calls, bk.core_calls = bk.core_calls, None
        stats["routes_s"] += wall
        stats["what_if_routes"] += 1
        for _, args in calls:
            live = int(args[-1].long().sum())
            best = stats["largest_routes"]
            if best is None or live > best[0]:
                stats["largest_routes"] = (live, args, wall, len(a[-1]))
        return out

    bk.what_if_wave, bk.what_if_routes = count_wave, count_routes
    try:
        yield stats
    finally:
        del bk.what_if_wave, bk.what_if_routes


def call_counts(stats):
    return {k: stats[k] for k in ("what_if_wave", "what_if_routes",
                                  "wave_s", "routes_s")}


def phase_dispatch(per_tok):
    """[14a]: ``launch.serve.dispatch`` at the reference's 2,048 requests
    over 16 replicas, QLearn and SimPolicy; SimPolicy prices every wave on
    the default backend, the kernel."""
    from repro_torch import kernels
    from repro_torch.core import ALGORITHM_NAMES
    from repro_torch.launch.serve import dispatch
    from repro_torch.sim import get_backend
    rows = []
    for selector in ("QLearn", "SimPolicy"):
        with counting_what_ifs(get_backend(None)) as stats:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            summary, shares = dispatch(per_tok, selector=selector)
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()["event_finish"]
        top = max(shares, key=shares.get)
        rows.append({"selector": selector, "per_token_s": per_tok,
                     **summary, "mostly": ALGORITHM_NAMES[top],
                     "shares": {ALGORITHM_NAMES[a]: n
                                for a, n in sorted(shares.items())},
                     **call_counts(stats), "event_finish": launches,
                     "wall_s": wall})
        require(summary["waves"] == 8 and np.isfinite(
            summary["total_makespan"]) and summary["total_makespan"] > 0,
            f"[14a] dispatch {selector}: {summary}")
    q, s = rows
    require(q["what_if_wave"] == 0 and q["event_finish"] == 0,
            "[14a] QLearn priced a wave")
    require(s["what_if_wave"] == 2 * s["waves"] and s["event_finish"] > 0,
            f"[14a] SimPolicy: {s['what_if_wave']} what_if_wave calls, "
            f"{s['event_finish']} event_finish launches over "
            f"{s['waves']} waves")
    return rows, s["event_finish"]


def summary_diff(got, want):
    return {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
            if got.get(k) != want.get(k)}


def timing(obj, name, acc):
    """Add the host wall of every outermost ``obj.name(...)`` call to
    ``acc[name]`` (an instance attribute over the method; a call that
    recurses, as ``WhatIfRouter.route`` on a sub-fleet, counts once)."""
    fn = getattr(obj, name)
    acc.setdefault(name, 0.0)
    depth = [0]

    def timed(*a, **k):
        t0 = time.perf_counter()
        depth[0] += 1
        try:
            return fn(*a, **k)
        finally:
            depth[0] -= 1
            if not depth[0]:
                acc[name] += time.perf_counter() - t0

    setattr(obj, name, timed)


def fleet_run(trace, router, **kw):
    """One fleet run on a fresh backend on the card: the report, the
    router and a record of the run's wall, launches, what-if calls,
    ``PathTimes`` and host walls by layer (``route``: the router, its
    pricing call included; ``run_wave``: the groups' dispatch waves, their
    policies and wave pricing included); the what-if stats keep the
    largest route call."""
    from repro_torch import TorchBatchedBackend, kernels
    from repro_torch.serving import AdmissionControl, FleetSimulator
    bk = TorchBatchedBackend()
    fleet = FleetSimulator(router=router, backend=bk,
                           admission=AdmissionControl(wave_quota=FLEET_QUOTA),
                           **FLEET, **kw)
    layers = {}
    timing(fleet.router, "route", layers)
    for sim in fleet.groups:
        timing(sim, "run_wave", layers)
    with counting_what_ifs(bk) as stats:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rep = fleet.run(trace, keep_latencies=True)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()["event_finish"]
    require(launches > 0, f"[14] fleet {router} never launched event_finish")
    return rep, fleet.router, stats, {
        "router": router, "n": len(trace), "wall_s": wall,
        "wall_ms_per_wave": wall * 1e3 / rep.waves,
        "event_finish": launches, **call_counts(stats),
        "layers_s": {**layers,
                     "fleet_loop": wall - sum(layers.values())},
        "path_times": dict(vars(bk.times))}


def golden(path, *keys):
    rec = json.loads((ROOT / "results" / path).read_text())
    for k in keys:
        rec = rec[k]
    return rec


def check_golden(name, got, want):
    want = {k: v for k, v in want.items() if k != "wall_s"}
    require(got == want, f"[14] {name} differs from the committed record: "
            f"{summary_diff(got, want)}")


def phase_fleet():
    """[14b]: the fleet benchmark's tier-1 bursty regime, round-robin and
    what-if routing, against ``results/bench_fleet.json``."""
    from repro_torch.serving import make_trace
    bench = golden("bench_fleet.json", "traces", "bursty")
    require(bench["n"] == FLEET_N and bench["params"] == FLEET_BURSTY,
            f"bench_fleet.json holds another regime: {bench['params']}")
    trace = make_trace("bursty", FLEET_N, seed=0, **FLEET_BURSTY)
    out, largest, launches = {}, None, {}
    for router in ("round_robin", "whatif"):
        rep, _, stats, rec = fleet_run(trace, router)
        s = rep.summary()
        check_golden(f"fleet {router}", s, bench["routers"][router])
        require(s["throughput"] >= 0.9 * trace.mean_rate,
                f"[14b] {router} throughput {s['throughput']} below 0.9 x "
                f"{trace.mean_rate}")
        out[router] = {**rec, "summary": s}
        launches[f"fleet {router} [14b]"] = rec["event_finish"]
        if router == "whatif":
            largest = stats["largest_routes"]
    rr, wi = out["round_robin"]["summary"], out["whatif"]["summary"]
    require(wi["makespan"] < rr["makespan"] and wi["p95"] < rr["p95"],
            f"[14b] whatif does not beat round-robin: {wi} vs {rr}")
    return out, largest, launches, trace


def profile_fleet(device, trace):
    """About 20 waves of the what-if-routed fleet (the first
    ``PROFILE_N`` requests of the bursty trace): the run on the host
    clock, then a fresh fleet on the same backend (warm schedule caches)
    under ``torch.profiler``: launches a wave, the card's busy ms a wave
    and its idle share against the untraced wave."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import TorchBatchedBackend
    from repro_torch.serving import AdmissionControl, FleetSimulator
    reqs = trace.requests[:PROFILE_N]
    bk = TorchBatchedBackend()

    def fleet():
        return FleetSimulator(router="whatif", backend=bk, **FLEET,
                              admission=AdmissionControl(
                                  wave_quota=FLEET_QUOTA))

    fleet().run(reqs)                               # warm-up, not kept
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    rep = fleet().run(reqs)
    wave_s = (time.perf_counter() - t0) / rep.waves
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = fleet().run(reqs)
        torch.cuda.synchronize(device)
    busy_ms, launches, top = traced_busy(prof, traced.waves, top=6)
    return {"requests": PROFILE_N, "waves": rep.waves,
            "wave_ms": wave_s * 1e3, "busy_ms_per_wave": busy_ms,
            "idle_share": 1.0 - busy_ms / 1e3 / wave_s,
            "launches_per_wave": launches, "top": top}


def outage(duration, window=FAIL_WINDOW):
    from repro_torch.sim import FleetPerturb, ReplicaFailure
    return FleetPerturb(failures=(ReplicaFailure(
        group=FAIL_GROUP, t0=duration * window[0],
        t1=duration * window[1]),))


def phase_faults():
    """[14c]: the fault benchmark's tier-1 regime, recovery on and off,
    against ``results/bench_faults.json``."""
    from repro_torch.serving import RecoveryPolicy, make_trace
    cfg = golden("bench_faults.json", "config")
    require(cfg["n"] == FAULTS_N and cfg["fail_group"] == FAIL_GROUP
            and tuple(cfg["fail_window"]) == FAIL_WINDOW,
            f"bench_faults.json holds another regime: {cfg}")
    bench = golden("bench_faults.json", "recovery")
    trace = make_trace("bursty", FAULTS_N, seed=0, **FLEET_BURSTY)
    out, launches = {}, {}
    for name, rec in (("on", RecoveryPolicy(max_retries=6)), ("off", None)):
        rep, _, _, row = fleet_run(trace, "whatif",
                                   perturb=outage(trace.duration),
                                   recovery=rec)
        s = rep.summary()
        check_golden(f"faults {name}", s, bench[name])
        r = s["recovery"]
        require(r["completed"] + r["dead_lettered"] == FAULTS_N,
                f"[14c] {name}: accounting {r}")
        out[name] = {**row, "summary": s}
        launches[f"faults {name} [14c]"] = row["event_finish"]
    on, off = out["on"]["summary"], out["off"]["summary"]
    require(on["makespan"] < off["makespan"] and on["p95"] < off["p95"]
            and on["recovery"]["dead_lettered"] == 0,
            f"[14c] recovery does not beat the blind baseline: {on} vs {off}")
    return out, launches


def phase_resume():
    """[14d]: a journaled 6,000-request fleet with the outage and recovery
    on, resumed on a fresh fleet from an early, a middle and the last
    snapshot: bit-equal to the uninterrupted run."""
    import shutil
    import tempfile
    from repro_torch import TorchBatchedBackend
    from repro_torch.serving import (AdmissionControl, FleetSimulator,
                                     RecoveryPolicy, RunJournal, make_trace)
    trace = make_trace("bursty", FLEET_SMALL_N, seed=0, **FLEET_BURSTY)
    bk = TorchBatchedBackend()

    def build():
        return FleetSimulator(router="whatif", backend=bk, **FLEET,
                              admission=AdmissionControl(
                                  wave_quota=FLEET_QUOTA),
                              perturb=outage(trace.duration),
                              recovery=RecoveryPolicy(max_retries=6))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        full = str(Path(tmp) / "full")
        ref = build().run(trace, keep_latencies=True,
                          journal=RunJournal(full, every=10, keep=0))
        waves = RunJournal(full, every=10, keep=0).waves()
        require(len(waves) >= 3, f"[14d] {len(waves)} snapshots")
        picks = (waves[0], waves[len(waves) // 2], waves[-1])
        for wave in picks:
            d = Path(tmp) / f"resume_{wave}"
            d.mkdir()
            shutil.copy(Path(full) / f"wave_{wave:09d}.npz", d)
            res = build().run(trace, keep_latencies=True,
                              journal=RunJournal(str(d), every=10, keep=0),
                              resume=True)
            require(res.summary() == ref.summary()
                    and np.array_equal(res.latencies, ref.latencies),
                    f"[14d] resume from wave {wave} diverged: "
                    f"{summary_diff(res.summary(), ref.summary())}")
    return {"n": FLEET_SMALL_N, "waves": ref.waves, "snapshots": len(waves),
            "resumed_from": list(picks),
            "retries": ref.recovery["retries"],
            "wall_s": time.perf_counter() - t0}


def phase_fleet_devices():
    """[14e]: a 6,000-request fleet under a group slowdown, a partial
    replica failure, a straggler and a whole-group outage, recovery with
    hedges: the kernels, the plain event core on the card and the CPU give
    equal summaries, latencies and router choices."""
    from repro_torch import TorchBatchedBackend
    from repro_torch.serving import (AdmissionControl, FleetSimulator,
                                     RecoveryPolicy, make_trace)
    from repro_torch.sim import (FleetPerturb, GroupSlowdown, ReplicaFailure,
                                 ReplicaStraggler)
    trace = make_trace("bursty", FLEET_SMALL_N, seed=0, **FLEET_BURSTY)
    d = trace.duration
    pert = FleetPerturb(
        events=(GroupSlowdown(group=2, factor=3.0, t0=0.1 * d, t1=0.5 * d),),
        failures=(ReplicaFailure(group=0, t0=0.2 * d, t1=0.7 * d,
                                 replicas=(1, 5)),
                  ReplicaFailure(group=FAIL_GROUP, t0=0.4 * d, t1=0.8 * d)),
        stragglers=(ReplicaStraggler(group=3, factor=4.0, t0=0.3 * d,
                                     t1=0.9 * d, replicas=(0, 2, 7)),))
    out = {}
    for name, bk in (("kernels", TorchBatchedBackend()),
                     ("plain", TorchBatchedBackend(event_core="plain")),
                     ("cpu", TorchBatchedBackend(device="cpu"))):
        fleet = FleetSimulator(router="whatif", backend=bk, **FLEET,
                               admission=AdmissionControl(
                                   wave_quota=FLEET_QUOTA),
                               perturb=pert,
                               recovery=RecoveryPolicy(max_retries=6,
                                                       hedge=True))
        t0 = time.perf_counter()
        rep = fleet.run(trace, keep_latencies=True)
        out[name] = (rep, fleet.router.choices, time.perf_counter() - t0)
    k, _, _ = out["kernels"]
    for name in ("plain", "cpu"):
        rep, choices, _ = out[name]
        require(rep.summary() == k.summary()
                and np.array_equal(rep.latencies, k.latencies)
                and choices == out["kernels"][1],
                f"[14e] the kernels and {name} differ: "
                f"{summary_diff(rep.summary(), k.summary())}")
    require(k.recovery["hedges"] > 0 and k.recovery["interrupted"] > 0,
            f"[14e] no hedge or interruption: {k.recovery}")
    return {"n": FLEET_SMALL_N, "waves": k.waves,
            "recovery": k.recovery,
            "walls_s": {n: v[2] for n, v in out.items()}}


def phase_serving(device, flush, records, per_tok):
    """Phase [14]; adds the serving paths' launches and ``event_finish``
    timed at the fleet's largest route call to ``records``."""
    from repro_torch.kernels import event_loop as ev
    t_phase = time.perf_counter()
    rows, dispatch_launches = phase_dispatch(per_tok)
    for r in rows:
        log(f"[14a] {json.dumps(r)}")
    out, largest, launches, trace = phase_fleet()
    for router, rec in out.items():
        log(f"[14b] {json.dumps(rec)}")
    log(f"[14b] both summaries == results/bench_fleet.json; whatif beats "
        f"round-robin on makespan and p95; throughput >= 0.9 x "
        f"{trace.mean_rate:.1f}")
    log(f"[14b] whatif fleet, {PROFILE_N} requests: "
        f"{json.dumps(profile_fleet(device, trace))}")
    faults, fault_launches = phase_faults()
    for name, rec in faults.items():
        log(f"[14c] recovery {name}: {json.dumps(rec)}")
    log("[14c] both summaries == results/bench_faults.json; recovery on "
        "beats off on makespan and p95, none dead-lettered")
    log(f"[14d] resume bit-equal: {json.dumps(phase_resume())}")
    log(f"[14e] kernels == plain card core == CPU: "
        f"{json.dumps(phase_fleet_devices())}")

    live, args, wall, n_cands = largest
    at = kernel_record("event_finish", launches["fleet whatif [14b]"],
                       list(args), 0, ev.event_finish, ev.event_finish_ref,
                       plain_bound, device, flush, reps=50, plain_reps=5)
    require(at["max_abs_err"] == 0.0,
            "event_finish disagrees at the fleet's largest route call")
    plain = records[0]
    plain["at_fleet_call"] = {
        **{k: at[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "shape", "chain_steps", "chain_ms",
                              "floor_ms", "max_abs_err")},
        "candidate_rows": n_cands, "host_wall_ms": wall * 1e3}
    log(f"[14f] event_finish at the fleet's largest what_if_routes call "
        f"{json.dumps(plain['at_fleet_call'])}")
    plain["launches_by_path"].update({
        "dispatch SimPolicy [14a]": dispatch_launches, **launches,
        **fault_launches})
    plain["launches"] = sum(plain["launches_by_path"].values())
    log(f"[14] {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: async dispatch and the lane split
# ---------------------------------------------------------------------------

#: the sweep's depth (the main path's) and the lockstep replay's (the
#: Fig. 5 grid) held async == sync; the replay cut from T = 50 to keep the
#: script inside its limit
ASYNC_SWEEP_T, ASYNC_REPLAY_T = 500, 30


def sweep_busy():
    """The T = ASYNC_SWEEP_T ``mandelbrot`` sweep once more, async, under
    ``torch.profiler``: the card's busy seconds in it and its launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import TorchBatchedBackend
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sweep("mandelbrot", TorchBatchedBackend(), T=ASYNC_SWEEP_T, reps=3)
    busy_ms, launches, top = traced_busy(prof, 1)
    return busy_ms / 1e3, launches, top


def phase_async(device, records):
    """Phase [15]: the T = ASYNC_SWEEP_T ``mandelbrot`` sweep sync and async
    in turns (sync, async, async, sync), bit-equal, with walls,
    ``PathTimes`` and the card's idle share; the Fig. 5 grid's lockstep
    replay at T = ASYNC_REPLAY_T
    and the what-if calls async against sync; the split path at
    ``data_parallel=1`` against an explicit one-device list.  Adds the
    phase's launches to ``records``."""
    from repro_torch import TorchBatchedBackend, kernels
    from repro_torch.sim import SIM_SELECTOR_GRID, run_campaign
    t_phase = time.perf_counter()
    runs = {"sync": [], "async": []}
    fused = {}
    for label in ("sync", "async", "async", "sync"):
        bk = TorchBatchedBackend(async_dispatch=label == "async")
        kernels.reset_launch_counts()
        sw, wall = sweep("mandelbrot", bk, T=ASYNC_SWEEP_T, reps=3)
        n = kernels.launch_counts()["event_finish_fused"]
        require(fused.setdefault(label, n) == n, "launch counts vary")
        check_sweep(sw, ASYNC_SWEEP_T, 3)
        runs[label].append((sw, wall, dict(vars(bk.times))))
    require(fused["sync"] == fused["async"] > 0,
            f"sync and async sweeps launched {fused}")
    first = runs["sync"][0][0]
    require(all(same_sweeps([first], [sw]) for r in runs.values()
                for sw, _, _ in r), "async sweeps differ from sync ones")
    busy_s, traced_launches, top = sweep_busy()
    out = {"phase": "async dispatch", "sweep": "mandelbrot/epyc",
           "T": ASYNC_SWEEP_T, "reps": 3, "fused_launches": fused["async"],
           "busy_s": busy_s, "traced_launches": traced_launches, "top": top}
    for label, rs in runs.items():
        walls = [w for _, w, _ in rs]
        out[label] = {
            "walls_s": walls, "wall_s": sum(walls) / len(walls),
            "idle_share": 1.0 - busy_s / (sum(walls) / len(walls)),
            **{k: sum(t[k] for _, _, t in rs) / len(rs) for k in (
                "rows_s", "pack_s", "closed_s", "launch_s", "device_s",
                "h2d_ms", "draws_ms", "core_ms")},
            "dispatches": rs[0][2]["dispatches"]}
    log(json.dumps(out))

    replays, whatifs, times = {}, {}, {}
    for label in ("sync", "async"):
        bk = TorchBatchedBackend(async_dispatch=label == "async")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        replays[label] = run_campaign(
            [REPLAY_CELL], T=ASYNC_REPLAY_T, reps=3,
            selectors=SIM_SELECTOR_GRID, backend=bk)[REPLAY_CELL]
        torch.cuda.synchronize(device)
        times[label] = time.perf_counter() - t0
        fused[f"replay {label}"] = kernels.launch_counts()[
            "event_finish_fused"]
        kernels.reset_launch_counts()
        whatifs[label] = what_if_calls(bk)
        fused[f"what-if {label}"] = kernels.launch_counts()["event_finish"]
    require(same_campaign(replays["sync"], replays["async"]),
            "the async lockstep replay differs from the sync one")
    require(fused["replay async"] > 0 and fused["what-if async"] > 0,
            "the async replay or what-if calls launched no kernel")
    require(all(np.array_equal(a, b) for a, b in zip(whatifs["sync"],
                                                     whatifs["async"])),
            "async what-if prices differ from sync ones")
    log(f"[15] Fig. 5 grid, T = {ASYNC_REPLAY_T}: async == sync "
        f"({len(replays['async'].selector_runs)} lanes; walls "
        f"{json.dumps(times)}); what_if_wave / what_if_routes async == "
        f"sync")

    split = {}
    for label, bk in (("data_parallel=1", TorchBatchedBackend(
            data_parallel=1)), ("devices=[cuda:0]", TorchBatchedBackend(
            devices=[torch.device("cuda", 0)]))):
        require(len(bk.mesh) == 1, f"{label}: mesh {bk.mesh}")
        split[label] = (sweep("tc", bk, reps=3)[0], what_if_calls(bk))
    (sa, wa), (sb, wb) = split.values()
    require(same_sweeps([sa], [sb]) and all(
        np.array_equal(a, b) for a, b in zip(wa, wb)),
        "data_parallel=1 and an explicit one-device list differ")
    log(f"[15] split path, one device: data_parallel=1 == devices=[cuda:0] "
        f"(tc sweep, what-if calls); {torch.cuda.device_count()} card(s), "
        f"so no split above one device runs here")
    fz, plain = records[1], records[0]
    fz["launches_by_path"].update({
        "async sweep [15]": fused["async"],
        "async replay [15]": fused["replay async"]})
    fz["launches"] = sum(fz["launches_by_path"].values())
    plain["launches_by_path"]["async what-if [15]"] = fused["what-if async"]
    plain["launches"] = sum(plain["launches_by_path"].values())
    log(f"[15] {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: learned-selection training
# ---------------------------------------------------------------------------

#: ``benchmarks/bench_learned.py::smoke``'s size: its training cells, its
#: held-out cell, the selectors it gates, its distillation bound
TRAIN_CELLS = (("tc", "broadwell"), ("tc", "cascadelake"),
               ("tc", "epyc_het"), ("mandelbrot", "epyc"),
               ("hacc", "epyc_het"), ("hacc", "cascadelake"))
HELDOUT_CELLS = (("tc", "epyc"),)
EVAL_SELECTORS = [("RandomSel", None), ("QLearn", "LT"), ("Hybrid", "LT"),
                  ("SimPolicy", "LT"), ("Learned", "LT"),
                  ("LearnedHybrid", "LT")]
DISTILL_BOUND = 0.15
TRAIN_T, TRAIN_STEPS, TRAIN_HIDDEN, HELDOUT_T = 12, 250, 24, 16
#: the injected-failure run: its failure rate and seed
FAIL_RATE, FAIL_SEED = 0.02, 7
#: training on the card against the CPU from one start, 250 steps: every
#: logged loss within TRAIN_REL_TOL of the CPU's, relative, and every
#: final weight within TRAIN_REL_TOL of its tensor's largest magnitude.
#: The two run the same float32 arithmetic with sums in other orders
#: (cuBLAS's products, the card's reductions), and Adam carries the
#: differences forward from step to step; XLA's CPU code against torch's
#: drifts by about 1e-6 over these steps on the CPU, so 1e-3 leaves a
#: wide margin while a wrong gradient or update misses it at once.
TRAIN_REL_TOL = 1e-3


def _tag(sel, reward):
    return f"{sel}+{reward}" if reward else sel


def collect(cells, backend, T: int = TRAIN_T, seed: int = 0,
            perturbed: bool = True):
    """The counterfactual transition log of ExpertSel replays over
    ``cells`` (and a PE-slowdown twin of each), priced on ``backend``."""
    from repro_torch.sim import (CellSpec, ReplayBatch, TransitionLogger,
                                 get_system, pe_slowdown_spec)
    tl = TransitionLogger(sim_backend=backend)
    specs = [CellSpec(app=a, system=s, selector="ExpertSel")
             for a, s in cells]
    if perturbed:
        for a, s in cells:
            specs.append(CellSpec(
                app=a, system=s, selector="ExpertSel",
                perturb=pe_slowdown_spec(get_system(s).P, frac=0.25,
                                         factor=6.0, t0=T // 4,
                                         t1=(3 * T) // 4)))
    ReplayBatch(specs, T=T, seed=seed, translog=tl, backend=backend).run()
    return tl.arrays()


def heldout_regret(state, backend, T: int = HELDOUT_T, seed: int = 0):
    """Fig. 5 degradation of each of ``EVAL_SELECTORS`` on the held-out
    cells, the trained state installed as the process default."""
    from repro_torch.core import set_default_state
    from repro_torch.sim import run_campaign
    set_default_state(state)
    try:
        res = run_campaign(list(HELDOUT_CELLS), T=T, reps=1,
                           selectors=EVAL_SELECTORS,
                           chunk_modes=("default",), seed=seed,
                           backend=backend)
    finally:
        set_default_state(None)
    out = {}
    for (app, system), cell in res.items():
        deg = cell.degradation()
        out[f"{app}/{system}"] = {_tag(sel, reward): deg[(sel, "default",
                                                          reward)]
                                  for sel, reward in EVAL_SELECTORS}
    return out


def distill_check(state, train_arrays, backend):
    """The ladder fit on the training transitions, its chosen-cost total on
    the held-out transitions against the net's."""
    from repro_torch.core import distill_ladder
    from repro_torch.core.learned import mlp_forward, params_from_state
    ladder = distill_ladder(state, train_arrays["features"],
                            regret_bound=DISTILL_BOUND)
    held = collect(HELDOUT_CELLS, backend, perturbed=False)
    X, costs = held["features"], np.asarray(held["costs"], np.float64)
    net = np.argmin(mlp_forward(params_from_state(state["params"]),
                                X.astype(np.float32)), axis=1)
    rows = np.arange(len(costs))
    return {"teacher_agreement": ladder.teacher_agreement,
            "n_leaves": ladder.n_leaves, "heldout_rows": len(rows),
            "heldout_cost_ratio": float(costs[rows, ladder.predict(X)].sum()
                                        / costs[rows, net].sum()),
            "rules": ladder.describe()}


def trainer(ds, ckpt_dir, device, **kw):
    from repro_torch.runtime import PolicyTrainer, PolicyTrainerConfig
    cfg = PolicyTrainerConfig(ckpt_dir=ckpt_dir, n_steps=TRAIN_STEPS,
                              hidden=TRAIN_HIDDEN, seed=0, **kw)
    return PolicyTrainer(ds, cfg, device=device)


def same_params(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def train_checks(ds, main, tmp, device):
    """Resume from the step-125 checkpoint and an injected-failure run,
    each bit-equal to the main run; the card against the CPU from one
    start (the seed's weights as numpy, converted onto each device and
    saved as each run's step-0 checkpoint)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import policy_trainer_state_from_jax
    from repro_torch.optim import AdamWState
    from repro_torch.runtime.policy_trainer import forward
    cut = trainer(ds, f"{tmp}/cut", device)
    cut.train(TRAIN_STEPS // 2)
    resumed = trainer(ds, f"{tmp}/cut", device).train()
    require(resumed["final_step"] == TRAIN_STEPS
            and same_params(resumed["params"], main["params"])
            and same_params(resumed["opt"].m, main["opt"].m),
            "training resumed from step 125 differs from the run")
    faulty = trainer(ds, f"{tmp}/faulty", device, failure_rate=FAIL_RATE,
                     failure_seed=FAIL_SEED).train()
    require(faulty["restarts"] > 0, "failure injection never fired")
    require(same_params(faulty["params"], main["params"]),
            "the injected-failure run differs from the clean run")
    params, opt = trainer(ds, f"{tmp}/init", "cpu")._init_state()
    numpy = {k: v.numpy() for k, v in params.items()}
    opt = AdamWState(step=opt.step.numpy(),
                     m={k: v.numpy() for k, v in opt.m.items()},
                     v={k: v.numpy() for k, v in opt.v.items()})
    runs = []
    for label, dev in (("card", device), ("cpu", "cpu")):
        p, o = policy_trainer_state_from_jax(numpy, opt, device=dev)
        CheckpointManager(f"{tmp}/{label}").save(0, {"params": p, "opt": o})
        runs.append(trainer(ds, f"{tmp}/{label}", dev).train())
    card, cpu = runs
    loss_rel = float(np.max(np.abs(np.subtract(card["losses"],
                                               cpu["losses"]))
                            / np.abs(cpu["losses"])))
    param_rel = max(float((card["params"][k].cpu() - v).abs().max()
                          / v.abs().max()) for k, v in cpu["params"].items())
    x, _, _ = ds.split("train")
    with torch.no_grad():
        picks = [forward(r["params"], torch.from_numpy(x).to(d)).argmin(1)
                 .cpu() for r, d in ((card, device), (cpu, "cpu"))]
    out = {"resumed_from": TRAIN_STEPS // 2, "faulty_restarts":
           faulty["restarts"], "card_vs_cpu_loss_rel": loss_rel,
           "card_vs_cpu_param_rel": param_rel,
           "card_vs_cpu_pick_agreement": float(
               (picks[0] == picks[1]).float().mean()),
           "tolerance": TRAIN_REL_TOL}
    require(loss_rel <= TRAIN_REL_TOL and param_rel <= TRAIN_REL_TOL,
            f"card vs CPU training outside {TRAIN_REL_TOL}: {out}")
    return out


def train_step_profile(ds, tmp, device, steps: int = 60):
    """``steps`` training steps on the host clock, then as many again (a
    fresh run) under ``torch.profiler``: ms a step, the card's busy ms and
    launches a step, its idle share against the untraced step."""
    from torch.profiler import ProfilerActivity, profile
    kw = dict(ckpt_every=10 ** 6)
    tr = trainer(ds, f"{tmp}/warm", device, **kw)
    tr.train(8)                                      # warm-up, not kept
    t0 = time.perf_counter()
    trainer(ds, f"{tmp}/timed", device, **kw).train(steps)
    step_s = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer(ds, f"{tmp}/traced", device, **kw).train(steps)
        torch.cuda.synchronize(device)
    busy_ms, launches, top = traced_busy(prof, steps)
    return {"steps": steps, "step_ms": step_s * 1e3,
            "busy_ms_per_step": busy_ms, "launches_per_step": launches,
            "idle_share": 1.0 - busy_ms / 1e3 / step_s, "top": top}


def phase_training(device, records):
    """Phase [16]: ``benchmarks/bench_learned.py::smoke`` on the card —
    the translog of its 6 training cells and their perturbed twins at T =
    12, 250 steps of training (hidden 24), the held-out ``tc``/``epyc``
    regret gates and the distilled ladder's bound; then resume, an
    injected-failure run, the card against the CPU and the train step's
    profile.  Adds the phase's launches to ``records``."""
    import signal
    import tempfile
    from repro_torch import TorchBatchedBackend, kernels
    from repro_torch.runtime import (PolicyTrainerConfig, TransitionDataset,
                                     train_policy_state)
    t_phase = time.perf_counter()
    bk = TorchBatchedBackend()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    arrays = collect(TRAIN_CELLS, bk)
    collect_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sigterm = signal.getsignal(signal.SIGTERM)
        try:        # the trainer's preemption handler, for this run only
            state, main = train_policy_state(
                arrays, f"{tmp}/main", cfg=PolicyTrainerConfig(
                    ckpt_dir=f"{tmp}/main", n_steps=TRAIN_STEPS,
                    hidden=TRAIN_HIDDEN, seed=0), device=device)
        finally:
            signal.signal(signal.SIGTERM, sigterm)
        train_s = time.perf_counter() - t0
        losses = main["losses"]
        require(len(losses) == TRAIN_STEPS and np.all(np.isfinite(losses))
                and losses[-1] < losses[0], f"training loss {losses[::50]}")
        t0 = time.perf_counter()
        reg = heldout_regret(state, bk)["tc/epyc"]
        heldout_s = time.perf_counter() - t0
        distilled = distill_check(state, arrays, bk)
        launches = kernels.launch_counts()
        require(launches["event_finish_fused"] > 0,
                "the training path never launched event_finish_fused")
        log(json.dumps({
            "phase": "learned training", "cells": len(TRAIN_CELLS),
            "T": TRAIN_T, "transitions": len(arrays["features"]),
            "collect_s": collect_s, "steps": TRAIN_STEPS,
            "hidden": TRAIN_HIDDEN, "train_s": train_s,
            "first_loss": losses[0], "final_loss": losses[-1],
            "train_regret": main["train_regret"],
            "heldout_T": HELDOUT_T, "heldout_s": heldout_s,
            "heldout_regret_pct": reg, "distilled": distilled,
            "launches": launches}))
        require(reg["Learned+LT"] < reg["QLearn+LT"],
                f"Learned {reg['Learned+LT']} % did not beat "
                f"mid-exploration QLearn {reg['QLearn+LT']} %")
        require(reg["Learned+LT"] < reg["RandomSel"],
                f"Learned {reg['Learned+LT']} % did not beat RandomSel "
                f"{reg['RandomSel']} %")
        require(reg["LearnedHybrid+LT"] <= reg["Hybrid+LT"] + 1e-9,
                f"LearnedHybrid {reg['LearnedHybrid+LT']} % worse than "
                f"Hybrid {reg['Hybrid+LT']} %")
        require(distilled["heldout_cost_ratio"] <= 1.0 + DISTILL_BOUND,
                f"the distilled ladder's held-out cost ratio "
                f"{distilled['heldout_cost_ratio']} exceeds "
                f"{1.0 + DISTILL_BOUND}")
        ds = TransitionDataset(arrays)
        log(f"[16] {json.dumps(train_checks(ds, main, tmp, device))}")
        log(f"[16] train step: "
            f"{json.dumps(train_step_profile(ds, tmp, device))}")
    fz = records[1]
    fz["launches_by_path"]["learned training [16]"] = launches[
        "event_finish_fused"]
    fz["launches"] = sum(fz["launches_by_path"].values())
    log(f"[16] {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: dense-family training (llama3.2-3b) through the autotuner
# ---------------------------------------------------------------------------

#: the training shapes: llama3.2-3b at 4 x 2048 tokens
TRAIN_B, TRAIN_S = 4, 2048
#: backward kernels against the plain versions' autograd: float32 within
#: 1e-5 of the largest magnitude (sums in another order); bfloat16 within
#: 2**-8 in relative L2 (the flash backward takes delta = rowsum(dO * o)
#: from the bfloat16 output where autograd has its float32 value: ~1.4e-3
#: emulated on the CPU).  Fixed before the kernels' first card run.
BWD_F32_REL = 1e-5
BWD_BF16_REL_L2 = 2.0 ** -8
#: the forward kernel's row lse (float32) against the plain lse, relative
#: to the largest magnitude (sums in another order)
LSE_REL = 1e-5
#: the card against the CPU, smoke llama3.2-3b in float32, 8 steps
TRAIN_CARD_CPU_REL = 1e-4
#: the reference test's restart-equivalence settings
RESTART = dict(failure_rate=0.15, failure_seed=6, ckpt_every=4, steps=12)
RESTART_ATOL = 1e-5
FULL_STEPS = 9


def grad_errors(got, want):
    """(max |got - want| / max |want|, relative L2) over each gradient, in
    float32 (in float64 on ``want``'s device for a float64 ``want``)."""
    out = []
    for g, w in zip(got, want):
        work = torch.promote_types(w.dtype, torch.float32)
        g, w = g.to(w.device, work), w.to(work)
        require(bool(torch.isfinite(g).all()), "non-finite gradient")
        out.append((float((g - w).abs().max() / w.abs().max().clamp_min(
            1e-30)), float((g - w).norm() / w.norm().clamp_min(1e-30))))
    return out


def work(cost):
    """A kernel module's (operations, bytes) cost as a record's ``ops`` and
    ``bytes``: the work its dry-run count reports, the bound's."""
    return {"ops": cost[0], "bytes": cost[1]}


def with_bound(rec, ops_rate):
    """``rec`` with its bound (the larger of bytes over the card's memory
    rate and operations over ``ops_rate``) and achieved rate."""
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = rec["ops"] / ops_rate * 1e3
    rec["bound_ms"] = max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    rec["tflops"] = rec["ops"] / rec["ms"] * 1e-9
    return rec


def bwd_within(errs, dtype) -> bool:
    if dtype == torch.float32:
        return all(e[0] <= BWD_F32_REL for e in errs)
    return all(e[1] <= BWD_BF16_REL_L2 for e in errs)


def time_grad(fn, args, reps, device, flush) -> float:
    """Mean ms of a backward: ``fn(*args)`` returns (outputs, inputs,
    output gradients) built once; each timed call is one
    ``torch.autograd.grad`` over the kept graph, after an L2 flush."""
    out, inputs, dout = fn(*args)
    return time_call(lambda: torch.autograd.grad(out, inputs, dout,
                                                 retain_graph=True), (),
                     reps, device, flush)


def sdpa_graph(q, k, v, do, causal=True):
    """SDPA (the library's flash attention) over q, k, v in its (B, H, S,
    hd) layout, GQA expanded by the library, with its graph kept."""
    F = torch.nn.functional
    qs, ks, vs = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                         enable_gqa=True)
    return out, (qs, ks, vs), do.transpose(1, 2).contiguous()


def rms_graph(x, w, dy):
    F = torch.nn.functional
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    return F.rms_norm(xs, (x.shape[-1],), ws, 1e-5), (xs, ws), dy


def backward_records(device, flush):
    """[17a]: each backward kernel against its plain version's autograd at
    the training shapes (bf16, the main path's calls: rmsnorm over 4 x
    2048 rows of 3072, causal GQA attention 24 / 8 heads of 128) and at
    small GQA / non-causal / hd 32 / float32 shapes; times after an L2
    flush beside the bound and the library call computing the same
    gradient; and both forward kernels at the training shape, held against
    their plain versions (``tol_ratio``) and timed."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RMS
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    for shape, dt in (((8, 128), f32), ((3, 17, 64), bf16),
                      ((300, 3072), f32), ((5, 7168), bf16),
                      ((37, 1001), bf16), ((3, 20000), f32)):
        x, w, dy = (randn(s, dt, device, 20 + i)
                    for i, s in enumerate((shape, shape[-1:], shape)))
        errs = grad_errors(RMS.rmsnorm_bwd(x, w, dy),
                           RMS.rmsnorm_bwd_ref(x, w, dy))
        rows.append(("rmsnorm_bwd", (shape, str(dt)), errs,
                     bwd_within(errs, dt)))
    for (B, S, T, H, K, hd), causal, dt in (
            ((2, 96, 160, 8, 2, 32), False, f32),
            ((2, 96, 160, 8, 2, 32), True, bf16),
            ((1, 257, 129, 6, 3, 64), False, bf16),
            ((1, 300, 300, 6, 2, 128), True, f32),
            ((2, 100, 72, 4, 2, 112), True, bf16)):
        q, do = (randn((B, S, H, hd), dt, device, 30 + i) for i in range(2))
        k, v = (randn((B, T, K, hd), dt, device, 32 + i) for i in range(2))
        o, lse = FA.flash_attention_lse(q, k, v, causal=causal)
        errs = grad_errors(FA.flash_attention_bwd(q, k, v, o, do, lse,
                                                  causal=causal),
                           FA.flash_attention_bwd_ref(q, k, v, o, do,
                                                      causal=causal))
        rows.append(("flash_attention_bwd", ((B, S, T, H, K, hd), causal,
                                             str(dt)), errs,
                     bwd_within(errs, dt)))
    for r in rows:
        log(f"[17a] {r[0]} {r[1]}: (max rel, rel L2) {r[2]} "
            f"{'ok' if r[3] else 'OUTSIDE'}")
    require(all(r[3] for r in rows), "a backward kernel is outside its "
            "tolerance at the small shapes")

    recs = []
    D = 3072
    x, dy = (randn((TRAIN_B, TRAIN_S, D), bf16, device, 40 + i)
             for i in range(2))
    w = randn((D,), bf16, device, 42)
    rms_fwd = rmsnorm_record(x, w, device, flush, plain_reps=5)
    require(rms_fwd["tol_ratio"] <= 1.0 and rms_fwd["rerun_bit_equal"],
            f"rmsnorm at the training shape {rms_fwd['tol_ratio']}, rerun "
            f"bit-equal {rms_fwd['rerun_bit_equal']}")
    rec = rmsnorm_bwd_record(x, w, dy, device, flush)
    require(rec["within"] and rec["rerun_bit_equal"], f"rmsnorm_bwd at the "
            f"training shape {rec['rel_l2']}, rerun bit-equal "
            f"{rec['rerun_bit_equal']}")
    recs.append(rec)
    del x, dy, w

    B, S, H, K, hd = TRAIN_B, TRAIN_S, 24, 8, 128
    q, do = (randn((B, S, H, hd), bf16, device, 50 + i) for i in range(2))
    k, v = (randn((B, S, K, hd), bf16, device, 52 + i) for i in range(2))
    o, lse = FA.flash_attention_lse(q, k, v, causal=True)
    o_ref = FA.flash_attention_ref(q, k, v, causal=True)
    lse_ref = FA.flash_attention_lse_ref(q, k, v, causal=True)
    fwd_err = {"max_abs_err": float((o.float() - o_ref.float()).abs().max()),
               "tol_ratio": tol_ratio(o, o_ref, "flash_attention"),
               "lse_max_rel": float((lse - lse_ref).abs().max()
                                    / lse_ref.abs().max()),
               "o_bit_equal_without_lse": torch.equal(
                   o, FA.flash_attention(q, k, v, causal=True))}
    del o_ref, lse_ref
    require(fwd_err["tol_ratio"] <= 1.0 and fwd_err["lse_max_rel"] <= LSE_REL
            and fwd_err["o_bit_equal_without_lse"], f"flash_attention at "
            f"the training shape {fwd_err}")
    got = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    want = FA.flash_attention_bwd_ref(q, k, v, o, do, causal=True)
    errs = grad_errors(got, want)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    again = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, want, again
    require(bwd_within(errs, bf16), f"flash_attention_bwd at the training "
            f"shape {errs}")
    require(same_bits, "flash_attention_bwd differs between two runs")
    shape = {"B": B, "S": S, "T": S, "H": H, "K": K, "hd": hd,
             "causal": True}
    recs.append(with_bound({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": REPLACES["flash_attention_bwd"],
        "max_abs_err": err, "rel_l2": [e[1] for e in errs],
        "tolerance": {"bf16_rel_l2": BWD_BF16_REL_L2},
        "rerun_bit_equal": same_bits,
        "ms": time_call(lambda: FA.flash_attention_bwd(
            q, k, v, o, do, lse, causal=True), (), 5, device, flush),
        "plain_ms": time_call(lambda: FA.flash_attention_bwd_ref(
            q, k, v, o, do, causal=True), (), 2, device, flush),
        "library_ms": time_grad(sdpa_graph, (q, k, v, do), 10, device,
                                flush),
        "shape": shape,
        **work(FA.flash_attention_bwd_cost(B, S, S, H, K, hd, True, 2))},
        BF16_OPS_PER_S))
    fwd = with_bound({
        **fwd_err,
        **forward_lse_ms(q, k, v, device, flush),
        "plain_ms": time_call(lambda: FA.flash_attention_ref(
            q, k, v, causal=True), (), 2, device, flush),
        "library_ms": time_call(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), (), 20, device, flush),
        "shape": shape,
        **work(FA.flash_attention_cost(B, S, S, H, K, hd, True, 2))},
        BF16_OPS_PER_S)
    del q, k, v, o, do, lse
    # the serving prefill's call (phase [11]'s shape), with and without lse
    B, H, hd = ZAMBA_BATCH, 32, 112
    q, k, v = (randn((B, S, H, hd), bf16, device, 60 + i) for i in range(3))
    fwd["at_prefill_shape"] = forward_lse_ms(q, k, v, device, flush)
    del q, k, v
    for r in recs:
        log(f"[17a] {r['name']} at the training shape: {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms, {r['bound_by']}; plain "
            f"{r['plain_ms']:.3f} ms; library {r['library_ms']:.4f} ms), "
            f"rel L2 {r['rel_l2']}")
    log(f"[17a] flash_attention forward at the training shape (ms without "
        f"lse, lse_ms with it, in turns): {json.dumps(fwd)}")
    log(f"[17a] rmsnorm forward at the training shape: "
        f"{json.dumps(rms_fwd)}")
    torch.cuda.empty_cache()
    return recs, {"flash_attention": fwd, "rmsnorm": rms_fwd}


def rmsnorm_bwd_record(x, w, dy, device, flush):
    """[17a] / [21b]: the rmsnorm backward at one training call (bf16)
    against its plain version, a rerun's bits, and its time after an L2
    flush beside its bound, the plain version and ``F.rms_norm``'s
    backward."""
    from repro_torch.kernels import rmsnorm as RMS
    got, want = RMS.rmsnorm_bwd(x, w, dy), RMS.rmsnorm_bwd_ref(x, w, dy)
    errs = grad_errors(got, want)
    again = RMS.rmsnorm_bwd(x, w, dy)
    D = x.shape[-1]
    n = x.numel() // D
    rec = with_bound({
        "name": "rmsnorm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": REPLACES["rmsnorm_bwd"],
        "max_abs_err": max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(got, want)),
        "rel_l2": [e[1] for e in errs],
        "tolerance": {"bf16_rel_l2": BWD_BF16_REL_L2},
        "within": bwd_within(errs, x.dtype),
        "rerun_bit_equal": all(torch.equal(a, b) for a, b in zip(got, again)),
        "ms": time_call(RMS.rmsnorm_bwd, (x, w, dy), 20, device, flush),
        "plain_ms": time_call(RMS.rmsnorm_bwd_ref, (x, w, dy), 5, device,
                              flush),
        "library_ms": time_grad(rms_graph, (x, w, dy), 20, device, flush),
        "shape": {"rows": n, "D": D},
        **work(RMS.rmsnorm_bwd_cost(n, D, x.element_size(),
                                    w.element_size()))}, F32_OPS_PER_S)
    del got, want, again
    return rec


def turns_ms(calls, reps, device, flush):
    """Each of two named calls' mean ms after an L2 flush, timed in turns
    (first, second, second, first) so that drift on the card falls on
    both alike."""
    (a, fa), (b, fb) = calls.items()
    ms = {a: [], b: []}
    for key, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        ms[key].append(time_call(fn, (), reps, device, flush))
    return {key: sum(v) / len(v) for key, v in ms.items()}


def forward_lse_ms(q, k, v, device, flush):
    """The causal forward kernel's mean ms without the lse (the serving
    call) and with it (the training call), timed in turns (without, with,
    with, without) after an L2 flush, and their ratio."""
    from repro_torch.kernels import flash_attention as FA
    out = turns_ms({"ms": lambda: FA.flash_attention(q, k, v, causal=True),
                    "lse_ms": lambda: FA.flash_attention_lse(
                        q, k, v, causal=True)}, 10, device, flush)
    out["lse_ratio"] = out["lse_ms"] / out["ms"]
    return out


def smoke_llama(dtype="float32", arch="llama3.2-3b", **kw):
    """``arch``'s ``smoke_reduce`` in ``dtype`` (default the smoke llama)."""
    from repro_torch.configs import get_config, smoke_reduce
    return dataclasses.replace(smoke_reduce(get_config(arch)),
                               param_dtype=dtype, **kw)


def leaves_get_gradients(device, arch="llama3.2-3b", tag="[17b]"):
    """[17b] / [20c] / [21a] / [22a]: one backward of ``arch``'s smoke cut
    (default the smoke llama) on the card, float32 and bf16: every leaf,
    and every layer of a stacked leaf (the enc-dec family's encoder and
    decoder stacks among them), has a gradient that is finite and not all
    zero (every embedding row too where the head is tied: the logits then
    reach all of them).  The enc-dec family's batch carries stub frames
    from a numpy seed of their own."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import tree_items
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = smoke_llama(dt, arch)
        rows = ("layers", "enc_layers", "dec_layers") + (
            ("embed",) if cfg.tie_embeddings else ())
        params = init_params(cfg, 0, device=device)
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (4, 129)).astype(np.int32)).to(device)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            batch["embeds"] = torch.from_numpy(np.random.default_rng(
                2).standard_normal((4, cfg.encoder_seq, cfg.d_model)
                                   ).astype(np.float32)).to(device)
        (loss, _), grads = value_and_grad(
            lambda p, b: loss_fn(cfg, p, b), params, batch)
        require(bool(torch.isfinite(loss)), f"{tag} {dt} loss {loss}")
        empty = []
        for path, g in tree_items(grads):
            g = g.float()
            per = (g.reshape(g.shape[0], -1).abs().sum(1)
                   if path[0] in rows else g.abs().sum().reshape(1))
            if not bool(torch.isfinite(g).all()) or bool((per == 0).any()):
                empty.append("/".join(path))
        out[dt] = {"loss": float(loss), "leaves": len(list(tree_items(
            grads))), "without_gradient": empty}
        require(not empty, f"{tag} {arch} {dt}: leaves without a gradient "
                f"{empty}")
    return out


def same_trees(a, b, atol=0.0):
    from repro_torch.optim import tree_items
    worst, bits = 0.0, True
    for (_, x), (_, y) in zip(tree_items(a), tree_items(b)):
        x, y = x.float().cpu(), y.float().cpu()
        worst = max(worst, float((x - y).abs().max()))
        bits = bits and torch.equal(x, y)
    return worst, bits


def card_vs_cpu(device, tmp, arch="llama3.2-3b", tag="[17c]"):
    """[17c] / [20c] / [21a] / [22a]: ``arch``'s smoke cut (default the
    smoke llama) in float32, 8 steps from one start (the CPU's init saved
    as each run's step-0 checkpoint) on the card and on the CPU, the
    losses within TRAIN_CARD_CPU_REL (the enc-dec family's batches carry
    the trainer's frames, the same on both)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = smoke_llama(arch=arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                      global_batch=4, seed=3)
    params = init_params(cfg, 0, device="cpu")
    start = {"params": params, "opt": adamw_init(params, opt)}
    runs = {}
    for label, dev in (("card", device), ("cpu", "cpu")):
        CheckpointManager(f"{tmp}/{arch}-{label}").save(0, start)
        runs[label] = Trainer(
            cfg, opt, data, TrainerConfig(ckpt_dir=f"{tmp}/{arch}-{label}",
                                          ckpt_every=100, async_ckpt=False),
            step_fn=make_train_step(cfg, opt), device=dev).train(8)
    card, cpu = runs["card"]["losses"], runs["cpu"]["losses"]
    rel = float(np.max(np.abs(np.subtract(card, cpu)) / np.abs(cpu)))
    out = {"steps": 8, "losses_card": card, "losses_cpu": cpu,
           "loss_rel": rel, "tolerance": TRAIN_CARD_CPU_REL}
    require(rel <= TRAIN_CARD_CPU_REL, f"{tag} {arch} card vs CPU {out}")
    return out


def train_runs(device, tmp):
    """[17c] and [17d]: the smoke llama's card against the CPU; and the
    reference test's restart equivalence on the card."""
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    c_vs_c = card_vs_cpu(device, tmp)

    rcfg = dataclasses.replace(smoke_llama(), vocab_size=128)
    ropt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    rdata = DataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=3)

    def run(label, failure_rate):
        return Trainer(rcfg, ropt, rdata, TrainerConfig(
            ckpt_dir=f"{tmp}/{label}", ckpt_every=RESTART["ckpt_every"],
            async_ckpt=False, failure_rate=failure_rate,
            failure_seed=RESTART["failure_seed"]),
            step_fn=make_train_step(rcfg, ropt), seed=0,
            device=device).train(RESTART["steps"])

    clean = run("clean", 0.0)
    faulty = run("faulty", RESTART["failure_rate"])
    worst, bits = same_trees(clean["params"], faulty["params"])
    restart = {"restarts": faulty["restarts"],
               "final_step": faulty["final_step"], "params_max_abs": worst,
               "bit_equal": bits, "atol": RESTART_ATOL}
    if not bits:
        restart["why_not_bit_equal"] = (
            "the CUDA backward of the embedding lookup (index_put_ with "
            "accumulate) sums a row's gradients in a run-dependent order")
    require(faulty["restarts"] > 0 and faulty["final_step"] == 12
            and worst <= RESTART_ATOL, f"[17d] restart {restart}")
    return c_vs_c, restart


#: a train step's kernels by name, in buckets of device time (the rest is
#: PyTorch's elementwise, reduction and copy kernels)
STEP_BUCKETS = (("ssd_scan_bwd", ("ssd_bwd_",)),
                ("ssd_scan", ("ssd_state_kernel", "ssd_pass_kernel",
                              "ssd_out_kernel", "ssd_kernel")),
                ("flash_attention_bwd", ("flash_bwd",)),
                ("flash_attention", ("flash_wgmma", "flash_kernel")),
                ("rmsnorm, rmsnorm_bwd", ("rmsnorm",)),
                ("products (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")))


def train_batch(cfg, pipe, step, device):
    """Step ``step``'s batch of ``pipe`` on ``device``, as the trainer
    draws it: the enc-dec family's with the step's frames."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in pipe.train_batch_at(step, cfg).items()}


def remat_turns(cfg, params, opt, device, batch, seq, steps):
    """Steps of ``cfg`` with and without remat on the trained state, in
    turns (remat, none, none, remat), each timed on the host clock to its
    synchronize: the seconds of each."""
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=steps // 5,
                          total_steps=steps, moment_dtype=cfg.moment_dtype)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq, global_batch=batch))
    fns = {r: make_train_step(dataclasses.replace(cfg, remat=r), opt_cfg)
           for r in (True, False)}
    out = {"remat_s": [], "noremat_s": []}
    for i, r in enumerate((True, False, False, True)):
        b = train_batch(cfg, pipe, steps + 2 + i, device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fns[r](params, opt, b)
        torch.cuda.synchronize(device)
        out["remat_s" if r else "noremat_s"].append(
            time.perf_counter() - t0)
    return out


def step_breakdown(cfg, params, opt, device, batch=TRAIN_B, seq=TRAIN_S,
                   steps=FULL_STEPS):
    """One more step of mb1_noremat on the state trained for ``steps``
    steps of ``batch`` x ``seq`` tokens at full width, by layer on the host
    clock, each part ending in a synchronize: forward with the CE loss,
    backward, AdamW in place; then one more under ``torch.profiler``: the
    card's busy time by kernel bucket and its launches.  The enc-dec
    family's batches carry their steps' frames."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig, adamw_update_, tree_map
    cfg = dataclasses.replace(cfg, remat=False)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=steps // 5,
                          total_steps=steps, moment_dtype=cfg.moment_dtype)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq, global_batch=batch))
    batches = [train_batch(cfg, pipe, steps + i, device) for i in range(2)]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = loss_fn(cfg, leaves, batches[0])
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    grads = tree_map(lambda t: t.grad, leaves)
    del leaves
    adamw_update_(grads, opt, params, opt_cfg)
    torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    del grads
    step = make_train_step(cfg, opt_cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, batches[1])
        torch.cuda.synchronize(device)
    buckets = {name: 0.0 for name, _ in STEP_BUCKETS}
    buckets["other"] = 0.0
    launches = 0
    for e in prof.key_averages():
        us = device_us(e)
        if us <= 0 or e.key.startswith("aten"):
            continue
        launches += e.count
        name = next((n for n, keys in STEP_BUCKETS
                     if any(k in e.key for k in keys)), "other")
        buckets[name] += us / 1e3
    busy = sum(buckets.values())
    return {"plan": "mb1_noremat", "forward_loss_s": t1 - t0,
            "backward_s": t2 - t1, "adamw_s": t3 - t2,
            "step_s": t3 - t0, "loss": float(loss.detach()),
            "busy_ms": busy, "launches": launches,
            "busy_ms_by_bucket": buckets,
            "idle_share": 1.0 - busy / 1e3 / (t3 - t0)}


def resume_probe(params, opt):
    """Copies on the host of a few leaves of the final state (bf16 params,
    float32 moments), to hold a resume against."""
    return {"final_norm": params["final_norm"].cpu(),
            "layers/wq[-1]": params["layers"]["wq"][-1].cpu(),
            "opt/.m/layers/w_down[0]": opt.m["layers"]["w_down"][0].cpu(),
            "opt/.v/embed": opt.v["embed"][:256].cpu(),
            "opt/.step": opt.step.cpu()}


def full_width_resume(cfg, ckpt, probe, device):
    """[17e]: the trainer's resume from the full-width run's final
    checkpoint, through ``Trainer._restore_or_init`` (the path a relaunch
    and a restart after a failure take), with nothing else of the run left
    on the card: the step, the probed leaves bit for bit, and the peak
    allocated over the restore against the restored state's own bytes (a
    template or a second copy of the state would add 32.1 GB)."""
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, tree_leaves
    from repro_torch.runtime import Trainer, TrainerConfig
    opt_cfg = AdamWConfig(moment_dtype=cfg.moment_dtype)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    tr = Trainer(cfg, opt_cfg, DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=TRAIN_S,
                                          global_batch=TRAIN_B),
                 TrainerConfig(ckpt_dir=str(ckpt), async_ckpt=False),
                 step_fn=make_train_step(cfg, opt_cfg), device=device)
    t0 = time.perf_counter()
    step, params, opt = tr._restore_or_init()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - base
    state = sum(t.numel() * t.element_size()
                for t in (tree_leaves(params) + tree_leaves(opt.m)
                          + tree_leaves(opt.v) + [opt.step]))
    got = resume_probe(params, opt)
    same = {k: torch.equal(got[k], v) for k, v in probe.items()}
    del params, opt, tr
    torch.cuda.empty_cache()
    out = {"step": step, "wall_s": wall, "state_gb": state / 1e9,
           "peak_gb": peak / 1e9, "probe_bit_equal": same}
    log(f"[17e] resume from the final checkpoint: {json.dumps(out)}")
    require(step == FULL_STEPS and all(same.values())
            and peak <= 1.02 * state, f"[17e] resume {out}")
    return out


def checkpoint_dir(cfg, name, tag):
    """An empty checkpoint directory under the checkout's ``build/``, with
    the disk checked for the final save (bf16 weights, float32 moments)."""
    import shutil
    ckpt = ROOT / "build" / f"chip_smoke_{name}_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    need = cfg.n_params() * (2 + 4 + 4)
    free = shutil.disk_usage(ckpt.parent).free
    log(f"{tag} {cfg.name}: the checkpoint needs ~{need / 1e9:.1f} GB, the "
        f"disk has {free / 1e9:.1f} GB free")
    require(free > 1.1 * need, f"{tag} the disk cannot hold {cfg.name}'s "
            f"final checkpoint: {free} bytes free, {need} needed")
    return ckpt


def full_width_run(device):
    """[17e]: ``repro_torch.launch.train.main`` at full width: llama3.2-3b,
    28 layers, d_model 3072, bf16, 4 x 2048 tokens a step, 9 steps under
    ExhaustiveSel over DEFAULT_PLANS; the final save (9 < ckpt_every) timed
    and deleted.  Returns the run's summary and its kernel launches."""
    import shutil
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config("llama3.2-3b")
    ckpt = checkpoint_dir(cfg, "train", "[17e]")
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(device)
    log(f"[17e] allocated before the run: {resident / 1e9:.2f} GB")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        out = train.main(["--arch", "llama3.2-3b", "--full", "--seq-len",
                          str(TRAIN_S), "--batch", str(TRAIN_B), "--steps",
                          str(FULL_STEPS), "--ckpt", str(ckpt)])
    finally:
        signal.signal(signal.SIGTERM, sigterm)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
    losses = out["losses"]
    n_par = sum(t.numel() for g in out["params"].values()
                for t in (g.values() if isinstance(g, dict) else [g]))
    layers = out["params"]["layers"]["wq"].shape[0]
    probe = resume_probe(out["params"], out["opt"])
    breakdown = step_breakdown(cfg, out["params"], out["opt"], device)
    summary = {
        "arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
        "dtype": cfg.param_dtype, "params": n_par,
        "tokens_per_step": TRAIN_B * TRAIN_S, "steps": out["final_step"],
        "wall_s": wall, "losses": losses,
        "plans": [{**r, "peak_gb": (r["peak_bytes"] or 0) / 1e9,
                   "build_s": out["compile_s"].get(r["plan"])}
                  for r in out["plans"]],
        "history": [h[0] for h in out["history"]],
        "settled": out["settled"], "final_save_s": out["final_save_s"],
        "checkpoint_gb": ckpt_bytes / 1e9,
        "launches": launches, "step_breakdown": breakdown}
    note_train_cell("[17e]", cfg, TRAIN_B, TRAIN_S, summary["plans"],
                    resident)
    del out
    summary["resume"] = full_width_resume(cfg, ckpt, probe, device)
    t1 = time.perf_counter()
    shutil.rmtree(ckpt)
    summary["checkpoint_rm_s"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    require(layers == 28 and n_par == cfg.n_params(),
            f"[17e] {layers} layers, {n_par} parameters")
    require(summary["steps"] == FULL_STEPS and len(losses) == FULL_STEPS
            and bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0],
            f"[17e] loss trace {losses}")
    require(summary["history"][:5] == [p["plan"] for p in summary["plans"]]
            and len(summary["plans"]) == 5, "[17e] not every plan explored")
    for name in ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd"):
        require(launches[name] > 0, f"[17e] {name} was never launched")
    return summary


def phase_dense_training(device, flush, model_records):
    """Phase [17]: (a) the backward kernels, (b) gradients reach every
    leaf, (c) card vs CPU, (d) restart equivalence, (e) the entry point at
    full width.  Returns the backward kernels' records, with the training
    path's launches added to the forward kernels' records."""
    import tempfile
    t_phase = time.perf_counter()
    recs, fwd = backward_records(device, flush)
    log(f"[17b] gradients on the card: "
        f"{json.dumps(leaves_get_gradients(device))}")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        c_vs_c, restart = train_runs(device, tmp)
    log(f"[17c] card vs CPU, smoke llama3.2-3b float32: {json.dumps(c_vs_c)}")
    log(f"[17d] restart equivalence on the card: {json.dumps(restart)}")
    t0 = time.perf_counter()
    full = full_width_run(device)
    log(f"[17e] {json.dumps(full)}")
    for r in full["plans"]:
        log(f"[17e] {r['plan']}: steps {r['step_s']} s, tokens/s "
            f"{[round(t) for t in r['tokens_per_s']]}, peak "
            f"{r['peak_gb']:.2f} GB, launches a step "
            f"{json.dumps(r['launches_per_step'])}")
    log(f"[17e] settled on {full['settled']}; loss {full['losses']}; "
        f"final save {full['final_save_s']:.1f} s "
        f"({full['checkpoint_gb']:.1f} GB); {time.perf_counter() - t0:.1f} s")
    log(f"[17e] one more step by layer, then profiled: "
        f"{json.dumps(full['step_breakdown'])}")
    for r in recs:
        r["launches"] = full["launches"][r["name"]]
        r["launches_by_path"] = {"train [17]": r["launches"]}
    for r in model_records:
        if r["name"] in ("rmsnorm", "flash_attention"):
            r["launches_by_path"] = {"prefill/decode [8]": r["launches"],
                                     "train [17]":
                                     full["launches"][r["name"]]}
            r["launches"] = sum(r["launches_by_path"].values())
            r["at_training_shape"] = fwd[r["name"]]
    log(f"[17] {time.perf_counter() - t_phase:.1f} s")
    return recs


# ---------------------------------------------------------------------------
# phase 18: the dense, VL and MoE families' serving
# ---------------------------------------------------------------------------

FAMILY_BATCH, FAMILY_PROMPT = 8, 2048
#: each served arch of [18b]-[18e]: the layers it keeps (None: all) and
#: its decode steps.  qwen2-vl-72b (145 GB in bf16) and grok-1-314b (633
#: GB) do not fit on one 80 GB card: they keep 16 of 80 and 2 of 64 layers
#: at full width
FAMILY_RUNS = (("granite-8b", None, 16), ("mistral-nemo-12b", None, 16),
               ("qwen2-vl-72b", 16, 16), ("olmoe-1b-7b", None, 64),
               ("grok-1-314b", 2, 4))
QWEN3_DECODE = 64
#: [18a]'s blocks held against the plain versions, from the same input
QWEN3_BLOCKS = (0, 32, 63)
#: the smoke archs of [18f], the card against the CPU
FAMILY_ARCHS = ("granite-8b", "mistral-nemo-12b", "qwen3-32b",
                "qwen2-vl-72b", "olmoe-1b-7b", "grok-1-314b")


@contextlib.contextmanager
def moe_stats():
    """The MoE dispatch's aux of every ``moe_block`` call the model makes
    while the context is open (a list, appended in call order)."""
    from repro_torch.models import model as M
    seen, orig = [], M.moe_block

    def recorded(*args, **kw):
        out, aux = orig(*args, **kw)
        seen.append(aux)
        return out, aux
    M.moe_block = recorded
    try:
        yield seen
    finally:
        M.moe_block = orig


def family_params(arch, device, n_layers=None, seed=0, **cut):
    """``arch`` at full width (its first ``n_layers`` layers, if given, and
    the other depths in ``cut``) in bf16 with random weights from a seeded
    ``torch.Generator``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch)
    if n_layers is not None:
        cut["n_layers"] = n_layers
    cfg = dataclasses.replace(cfg, **cut)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device)
    torch.cuda.synchronize(device)
    n = sum(t.numel() for g in params.values()
            for t in (g.values() if isinstance(g, dict) else [g]))
    return cfg, params, {"layers": cfg.n_layers, "params": n,
                         "init_s": time.perf_counter() - t0,
                         "gb": torch.cuda.memory_allocated(device) / 1e9}


def prompt_tokens(cfg, device, B=FAMILY_BATCH, S=FAMILY_PROMPT, seed=0):
    """Prompts drawn below ``vocab_size`` (the embedding is padded past
    it)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S))).to(device)


def expected_launches(cfg):
    """The model kernels' launches of one prefill and of one decode step.
    Dense and MoE: rmsnorm 2 a layer (4 with QK-norm) + the final norm,
    flash attention 1 a layer in prefill; SSM: rmsnorm 2 a layer + 1,
    ssd_scan 1 a layer in prefill; enc-dec (LayerNorm, no rmsnorm): flash
    attention 1 an encoder layer and 2 a decoder layer (self, cross) in
    prefill, 1 a decoder layer (cross) in decode."""
    L = cfg.n_layers
    if cfg.family == "encdec":
        return ({"rmsnorm": 0, "flash_attention": cfg.encoder_layers + 2 * L,
                 "ssd_scan": 0},
                {"rmsnorm": 0, "flash_attention": L, "ssd_scan": 0})
    norms = L * (4 if cfg.qk_norm else 2) + 1
    ssm = cfg.family == "ssm"
    return ({"rmsnorm": norms, "flash_attention": 0 if ssm else L,
             "ssd_scan": L if ssm else 0},
            {"rmsnorm": norms, "flash_attention": 0, "ssd_scan": 0})


def serve_family(cfg, params, device, steps, tokens, embeds=None,
                 max_len=None):
    """The serving path of one arch: ``prefill`` of ``tokens`` (and the
    enc-dec family's ``embeds``) on the kernels into a cache of
    ``max_len`` (default ``S + steps``) positions (launch counts, wall,
    peak), then up to ``steps`` decode steps on the prompts' slots through
    ``live`` (the ``ContinuousBatcher``).  Returns the run's record and
    the prefill's logits."""
    from repro_torch import kernels
    from repro_torch.data import synthetic_requests
    from repro_torch.launch.serve import live
    from repro_torch.models import (decode_step, init_decode_cache,
                                    padded_vocab, prefill)
    B, S = tokens.shape
    max_len = S + steps if max_len is None else max_len
    want, want_step = expected_launches(cfg)
    prefill(cfg, params, tokens[:, :128], embeds=embeds)  # warm-up
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, tokens, embeds=embeds,
                            max_len=max_len)
    torch.cuda.synchronize(device)
    prefill_s = time.perf_counter() - t0
    counts = model_counts()
    peak = torch.cuda.max_memory_allocated(device)
    note_cell("[19]" if cfg.family in ("ssm", "encdec") else "[18]", cfg,
              "prefill", B, S, prefill_s, peak, counts, max_len=max_len,
              allocated=before)
    require(counts == want,
            f"{cfg.name} prefill launches {counts}, want {want}")
    require(tuple(logits.shape) == (B, padded_vocab(cfg))
            and bool(torch.isfinite(logits).all()),
            f"{cfg.name} prefill logits {tuple(logits.shape)}")
    first = logits.argmax(-1).to(torch.int32)
    warm = init_decode_cache(cfg, B, 16, device=device)   # warm-up
    decode_step(cfg, params, warm, first)
    torch.cuda.synchronize(device)
    del warm
    kernels.reset_launch_counts()
    stats, per_tok = live(cfg, params, slots=B, device=device,
                          requests=synthetic_requests(16, seed=0,
                                                      mean_gen=32),
                          cache=cache, tokens=first, max_steps=steps)
    decode_counts = model_counts()
    del cache
    require(0 < stats["steps"] <= steps, f"{cfg.name} decode steps")
    require(decode_counts == {k: n * stats["steps"]
                              for k, n in want_step.items()},
            f"{cfg.name} decode launches {decode_counts}, want "
            f"{want_step} a step")
    return {"prefill_s": prefill_s, "prefill_tokens": B * S,
            "prefill_tokens_per_s": B * S / prefill_s,
            "peak_gb": peak / 1e9, "prefill_launches": counts,
            "decode": stats, "per_token_s": per_tok,
            "decode_launches": decode_counts}, logits


def stack_block_check(apply, layers, x, blocks, name="block"):
    """A stack of layers on the kernels from ``x``, ``apply(p, x)`` a
    layer, up to the last of ``blocks``; each of ``blocks`` also on the
    plain versions from the same input.  Returns ((block, rel L2) rows,
    the kernels' output of the last layer run)."""
    rows = []
    for i, p in enumerate(layers[:max(blocks) + 1]):
        out = apply(p, x)
        if i in blocks:
            with plain_kernels():
                ref = apply(p, x)
            rows.append((f"{name}{i}", rel_l2(out, ref)))
            del ref
        x = out
    return rows, x


def dense_block_check(cfg, params, tokens, blocks):
    """The dense stack on the kernels over ``tokens``, up to the last of
    ``blocks``; each of ``blocks`` also on the plain versions from the
    same input: (block, rel L2) rows."""
    from repro_torch.models import model as M
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    return stack_block_check(
        lambda p, x: M._dense_block(p, cfg, x, pos)[0],
        M.unstack_layers(params), params["embed"][tokens], blocks)[0]


def launches_of(runs, names=("rmsnorm", "flash_attention")):
    """The model kernels' launches over the runs' prefills and decodes."""
    out = {k: 0 for k in names}
    for r in runs:
        for k in out:
            out[k] += r["prefill_launches"][k] + r["decode_launches"][k]
    return out


def qwen3_serving(device):
    """[18a]: qwen3-32b at full width and depth: serving, the decode
    step's profile, three blocks against the plain versions; then its
    2-layer cut in float32 against the plain versions."""
    from repro_torch.models import prefill
    cfg, params, info = family_params("qwen3-32b", device)
    log(f"[18a] qwen3-32b init: {json.dumps(info)} ({cfg.n_params()} by "
        f"the config)")
    tokens = prompt_tokens(cfg, device)
    run, _ = serve_family(cfg, params, device, QWEN3_DECODE, tokens)
    run.update(info)
    log(f"[18a] qwen3-32b prefill {FAMILY_BATCH} x {FAMILY_PROMPT}: "
        f"{run['prefill_s']:.3f} s, peak {run['peak_gb']:.2f} GB, launches "
        f"{json.dumps(run['prefill_launches'])}; decode "
        f"{json.dumps(run['decode'])}")
    run["decode_profile"] = profile_decode(cfg, params, device,
                                           FAMILY_BATCH,
                                           FAMILY_PROMPT + QWEN3_DECODE)
    log(f"[18a] decode step profile: {json.dumps(run['decode_profile'])}")
    blocks = dense_block_check(cfg, params, tokens[:1], QWEN3_BLOCKS)
    worst = max(blocks, key=lambda r: r[1])
    log(f"[18a] blocks {QWEN3_BLOCKS}, bf16, one prompt, kernels vs plain "
        f"from the same input: {blocks} (bound {BLOCK_REL_L2})")
    require(worst[1] <= BLOCK_REL_L2, f"qwen3 {worst[0]}: {worst[1]}")
    run["blocks_rel_l2"] = dict(blocks)
    del params
    torch.cuda.empty_cache()

    cfg2, params2, _ = family_params("qwen3-32b", device, n_layers=2)
    t2 = tokens[:2]
    logits_k, _ = prefill(cfg2, params2, t2)
    with plain_kernels():
        logits_p, _ = prefill(cfg2, params2, t2)
    f32 = f32_check(cfg2, params2, t2, logits_k, logits_p)
    log(f"[18a] 2 layers, float32, 2 x {FAMILY_PROMPT}: {json.dumps(f32)}")
    check_f32("qwen3", f32)
    run["float32_2_layers"] = f32
    del params2, logits_k, logits_p
    torch.cuda.empty_cache()
    return run


def family_serving(arch, n_layers, steps, device):
    """[18b]-[18e]: one arch served at full width; M-RoPE's logits against
    RoPE's (qwen2-vl); the MoE's loads from ``forward`` against the
    prefill's, its drops, and a rerun of the prefill bit-equal."""
    from repro_torch.models import forward, prefill
    cfg, params, info = family_params(arch, device, n_layers)
    tokens = prompt_tokens(cfg, device)
    with moe_stats() as seen:
        run, logits = serve_family(cfg, params, device, steps, tokens)
    run.update(info)
    if cfg.mrope:
        off, _ = prefill(dataclasses.replace(cfg, mrope=False), params,
                         tokens)
        run["mrope_off_bit_equal"] = torch.equal(logits, off)
        require(run["mrope_off_bit_equal"], f"{arch}: M-RoPE's logits of "
                "text differ from RoPE's")
        del off
    if cfg.family == "moe":
        L = cfg.n_layers
        _, _, aux = forward(cfg, params, tokens)
        load = aux["expert_load"]
        want = FAMILY_BATCH * FAMILY_PROMPT * cfg.experts_per_token
        require(tuple(load.shape) == (L, cfg.n_experts)
                and bool((load.sum(-1) == want).all()),
                f"{arch} expert_load {tuple(load.shape)}, row sums "
                f"{load.sum(-1).tolist()}, want {want}")
        # seen: the warm-up prefill's L calls, the prefill's L, the warm-up
        # decode step's L, then live's decode steps
        prefill_loads = torch.stack([a["expert_load"]
                                     for a in seen[L:2 * L]])
        require(torch.equal(prefill_loads, load),
                f"{arch}: forward's expert_load differs from the prefill's")
        drop = lambda s: float(torch.stack(  # noqa: E731
            [a["dropped_frac"] for a in s]).mean())
        run["expert_load_max_over_mean"] = float(
            load.max() / load.float().mean())
        run["dropped_frac"] = {"prefill": drop(seen[L:2 * L]),
                               "decode": drop(seen[3 * L:])}
        again, _ = prefill(cfg, params, tokens)
        run["rerun_bit_equal"] = torch.equal(again, logits)
        require(run["rerun_bit_equal"], f"{arch}: a rerun of the prefill "
                "differs")
        del again, aux, load
    del params, logits
    torch.cuda.empty_cache()
    return run


def flash_record(B, S, T, H, K, hd, causal, seed, device, flush):
    """Flash attention at one bf16 call (q (B, S, H, hd), k and v (B, T,
    K, hd) from ``seed``; causal calls have S = T): held against its plain
    version, a rerun's bits, its time in turns with SDPA's, its plain
    version's, and the bound (the score and value products' operations; q,
    k, v read and o written once)."""
    from repro_torch.kernels import flash_attention as FA
    bf16 = torch.bfloat16
    q = randn((B, S, H, hd), bf16, device, seed)
    k, v = (randn((B, T, K, hd), bf16, device, seed + 1 + i)
            for i in range(2))

    def kernel():
        return FA.flash_attention(q, k, v, causal=causal)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)
    o = kernel()
    o_ref = FA.flash_attention_ref(q, k, v, causal=causal)
    rec = with_bound({
        "max_abs_err": float((o.float() - o_ref.float()).abs().max()),
        "tol_ratio": tol_ratio(o, o_ref, "flash_attention"),
        "rerun_bit_equal": torch.equal(o, kernel()),
        **turns_ms({"ms": kernel, "library_ms": lib}, 10, device, flush),
        "plain_ms": time_call(
            lambda: FA.flash_attention_ref(q, k, v, causal=causal), (), 1,
            device, flush),
        "shape": {"B": B, "S": S, "T": T, "H": H, "K": K, "hd": hd,
                  "causal": causal},
        **work(FA.flash_attention_cost(B, S, T, H, K, hd, causal, 2))},
        BF16_OPS_PER_S)
    del q, k, v, o, o_ref
    torch.cuda.empty_cache()
    return rec


def family_kernel_records(device, flush):
    """[18g]: rmsnorm at qwen3-32b's QK-norm calls (rows of 128: 64 query
    and 8 kv heads of 8 x 2048 tokens) and flash attention at its prefill
    call (64 / 8 heads of 128, causal), each against its plain version and
    the library call."""
    bf16 = torch.bfloat16
    B, S, H, K, hd = FAMILY_BATCH, FAMILY_PROMPT, 64, 8, 128
    rms = [rmsnorm_record(randn((B, S, h, hd), bf16, device, 80 + h),
                          randn((hd,), bf16, device, 81), device, flush,
                          plain_reps=5) for h in (H, K)]
    return rms, flash_record(B, S, S, H, K, hd, True, 90, device, flush)


def phase_families(device, flush, model_records):
    """Phase [18]: (a) qwen3-32b, (b)-(e) granite-8b, mistral-nemo-12b,
    qwen2-vl-72b (16 layers), olmoe-1b-7b, grok-1-314b (2 layers), served
    at full width; (f) their smoke cuts, card against CPU; (g) the kernels
    at qwen3's calls, added to the rmsnorm and flash records."""
    import gc
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[18] allocated before the phase: "
        f"{torch.cuda.memory_allocated(device) / 1e9:.2f} GB")
    runs = {"qwen3-32b": qwen3_serving(device)}
    log(f"[18a] {time.perf_counter() - t_phase:.1f} s")
    for (arch, n_layers, steps), tag in zip(FAMILY_RUNS, "bbcde"):
        runs[arch] = r = family_serving(arch, n_layers, steps, device)
        log(f"[18{tag}] {arch} ({r['layers']} layers, {r['params']} "
            f"parameters, {r['gb']:.2f} GB): prefill {r['prefill_s']:.3f} "
            f"s, peak {r['peak_gb']:.2f} GB, launches "
            f"{json.dumps(r['prefill_launches'])}; decode "
            f"{json.dumps(r['decode'])}"
            + "".join(f"; {k} {json.dumps(r[k])}" for k in (
                "mrope_off_bit_equal", "dropped_frac",
                "expert_load_max_over_mean", "rerun_bit_equal") if k in r))
    card_cpu = {a: phase_small_card_vs_cpu(device, a) for a in FAMILY_ARCHS}
    log(f"[18f] smoke archs, float32, card vs CPU (largest difference / "
        f"largest magnitude): {json.dumps(card_cpu)}")
    require(max(card_cpu.values()) <= 1e-4, f"[18f] card vs CPU {card_cpu}")
    rms, flash = family_kernel_records(device, flush)
    for r in rms:
        require(r["tol_ratio"] <= 1.0 and r["rerun_bit_equal"],
                f"rmsnorm at QK-norm's {r['shape']}: tol_ratio "
                f"{r['tol_ratio']}, rerun {r['rerun_bit_equal']}")
        log(f"[18g] rmsnorm at qwen3's QK-norm call {json.dumps(r)}")
    require(flash["tol_ratio"] <= 1.0 and flash["rerun_bit_equal"],
            f"flash_attention at qwen3's prefill call {flash['tol_ratio']}")
    log(f"[18g] flash_attention at qwen3's prefill call {json.dumps(flash)}")
    launches = launches_of(runs.values())
    for r in model_records:
        if r["name"] in launches:
            r["launches_by_path"]["serve families [18]"] = launches[r["name"]]
            r["launches"] = sum(r["launches_by_path"].values())
            if r["name"] == "rmsnorm":
                r["at_qk_norm_call"] = rms
            else:
                r["at_dense_prefill_call"] = flash
    wall = time.perf_counter() - t_phase
    log(json.dumps({"families": runs, "launches": launches, "wall_s": wall}))
    log(f"[18] {wall:.1f} s")


# ---------------------------------------------------------------------------
# phase 19: the SSM and enc-dec families' serving
# ---------------------------------------------------------------------------

#: [19a] mamba2-2.7b: prompts of FAMILY_BATCH x FAMILY_PROMPT, its decode
#: steps, and the blocks held against the plain versions
MAMBA_DECODE = 64
MAMBA_BLOCKS = (0, 32, 63)
#: [19b] whisper-small: clips of its encoder's 1,500 stub frames, a
#: decoder prompt into a cache of its decoder context (448 positions),
#: its decode steps, and the encoder and decoder blocks held (the last the
#: last layer: the decoder reads the whole encoder's output)
WHISPER_PROMPT, WHISPER_CONTEXT, WHISPER_DECODE = 32, 448, 64
WHISPER_BLOCKS = (0, 6, 11)
SSM_ENCDEC_ARCHS = ("mamba2-2.7b", "whisper-small")


def stub_frames(cfg, device, B=FAMILY_BATCH, seed=0):
    """Whisper's stub frame embeddings (B, encoder_seq, d_model) in bf16,
    from a seeded ``torch.Generator``: what the reference's stubbed audio
    front end hands the encoder."""
    return randn((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16, device,
                 seed)


def mamba_serving(device):
    """[19a]: mamba2-2.7b at full width and depth: serving, the decode
    step's profile, blocks 0 / 32 / 63 against the plain versions; then
    its 2-layer cut in float32 against the plain versions."""
    from repro_torch.models import model as M
    from repro_torch.models import prefill
    from repro_torch.models.ssm import ssm_layer_apply
    cfg, params, info = family_params("mamba2-2.7b", device)
    log(f"[19a] mamba2-2.7b init: {json.dumps(info)} ({cfg.n_params()} by "
        f"the config)")
    tokens = prompt_tokens(cfg, device)
    run, _ = serve_family(cfg, params, device, MAMBA_DECODE, tokens)
    run.update(info)
    log(f"[19a] mamba2-2.7b prefill {FAMILY_BATCH} x {FAMILY_PROMPT}: "
        f"{run['prefill_s']:.3f} s, peak {run['peak_gb']:.2f} GB, launches "
        f"{json.dumps(run['prefill_launches'])}; decode "
        f"{json.dumps(run['decode'])}, launches "
        f"{json.dumps(run['decode_launches'])}")
    run["decode_profile"] = profile_decode(cfg, params, device,
                                           FAMILY_BATCH,
                                           FAMILY_PROMPT + MAMBA_DECODE)
    log(f"[19a] decode step profile: {json.dumps(run['decode_profile'])}")
    blocks, _ = stack_block_check(
        lambda p, x: ssm_layer_apply(p, x, cfg)[0], M.unstack_layers(params),
        params["embed"][tokens], MAMBA_BLOCKS, "mamba")
    worst = max(blocks, key=lambda r: r[1])
    log(f"[19a] blocks {MAMBA_BLOCKS}, bf16, kernels vs plain from the "
        f"same input: {blocks} (bound {BLOCK_REL_L2})")
    require(worst[1] <= BLOCK_REL_L2, f"mamba2 {worst[0]}: {worst[1]}")
    run["blocks_rel_l2"] = dict(blocks)
    del params
    torch.cuda.empty_cache()

    cfg2, params2, _ = family_params("mamba2-2.7b", device, n_layers=2)
    t2 = tokens[:2]
    logits_k, _ = prefill(cfg2, params2, t2)
    with plain_kernels():
        logits_p, _ = prefill(cfg2, params2, t2)
    f32 = f32_check(cfg2, params2, t2, logits_k, logits_p)
    log(f"[19a] 2 layers, float32, 2 x {FAMILY_PROMPT}: {json.dumps(f32)}")
    check_f32("mamba2", f32)
    run["float32_2_layers"] = f32
    del params2, logits_k, logits_p
    torch.cuda.empty_cache()
    return run


def whisper_blocks(cfg, params, tokens, embeds):
    """whisper-small's encoder and decoder blocks of ``WHISPER_BLOCKS`` on
    the kernels and on the plain versions from the same input, the
    kernels' output carried on; the decoder's cross attention over the
    kernels' encoder output.  Returns (block, rel L2) rows."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import layer_norm
    rows, h = stack_block_check(lambda p, x: M._encoder_layer(cfg, p, x),
                                M.unstack_layers(params, "enc_layers"),
                                M._encoder_input(cfg, embeds),
                                WHISPER_BLOCKS, "enc")
    enc_out = layer_norm(h, params["enc_final_norm"],
                         params["enc_final_norm_b"], cfg.norm_eps)
    S, D = tokens.shape[1], cfg.d_model
    x = (params["embed"][tokens]
         + M._sinusoid(S, D, tokens.device).to(params["embed"].dtype))
    dec, _ = stack_block_check(
        lambda p, x: M._decoder_layer(cfg, p, x,
                                      M._cross_kv(cfg, p, enc_out))[0],
        M.unstack_layers(params, "dec_layers"), x, WHISPER_BLOCKS, "dec")
    return rows + dec


def whisper_serving(device):
    """[19b]: whisper-small at full width and depth: serving 8 clips of
    stub frames with a 32-token prompt into a 448-position cache, the
    decode step's profile, encoder and decoder blocks against the plain
    versions; then its 2 + 2-layer cut in float32."""
    from repro_torch.models import prefill
    cfg, params, info = family_params("whisper-small", device)
    log(f"[19b] whisper-small init: {json.dumps(info)} ({cfg.n_params()} "
        f"by the config)")
    tokens = prompt_tokens(cfg, device, S=WHISPER_PROMPT)
    embeds = stub_frames(cfg, device)
    run, _ = serve_family(cfg, params, device, WHISPER_DECODE, tokens,
                          embeds=embeds, max_len=WHISPER_CONTEXT)
    run.update(info)
    log(f"[19b] whisper-small prefill {FAMILY_BATCH} x {cfg.encoder_seq} "
        f"frames + {WHISPER_PROMPT} tokens: {run['prefill_s']:.3f} s, peak "
        f"{run['peak_gb']:.2f} GB, launches "
        f"{json.dumps(run['prefill_launches'])}; decode "
        f"{json.dumps(run['decode'])}, launches "
        f"{json.dumps(run['decode_launches'])}")
    run["decode_profile"] = profile_decode(cfg, params, device,
                                           FAMILY_BATCH, WHISPER_CONTEXT)
    log(f"[19b] decode step profile: {json.dumps(run['decode_profile'])}")
    blocks = whisper_blocks(cfg, params, tokens, embeds)
    worst = max(blocks, key=lambda r: r[1])
    log(f"[19b] blocks {WHISPER_BLOCKS} of the encoder and the decoder, "
        f"bf16, kernels vs plain from the same input: {blocks} (bound "
        f"{BLOCK_REL_L2})")
    require(worst[1] <= BLOCK_REL_L2, f"whisper {worst[0]}: {worst[1]}")
    run["blocks_rel_l2"] = dict(blocks)
    del params
    torch.cuda.empty_cache()

    cfg2, params2, _ = family_params("whisper-small", device, n_layers=2,
                                     encoder_layers=2)
    t2, e2 = tokens[:2], embeds[:2]
    logits_k, _ = prefill(cfg2, params2, t2, embeds=e2)
    with plain_kernels():
        logits_p, _ = prefill(cfg2, params2, t2, embeds=e2)
    f32 = f32_check(cfg2, params2, t2, logits_k, logits_p, embeds=e2)
    log(f"[19b] 2 + 2 layers, float32, 2 clips: {json.dumps(f32)}")
    check_f32("whisper", f32)
    run["float32_2_layers"] = f32
    del params2, logits_k, logits_p, embeds
    torch.cuda.empty_cache()
    return run


def ssm_encdec_kernel_records(device, flush):
    """[19d]: the SSD scan at mamba2-2.7b's prefill call (8 x 2048, 80
    heads of 64, state 128, chunk 256) with its three kernels' shares,
    flash attention at whisper-small's encoder call (8 x 1,500 frames, 12
    heads of 64, non-causal) beside SDPA, and rmsnorm at mamba2's rows
    (8 x 2048 of d_model 2,560 and of the gated norm's 5,120) in turns
    with ``rms_norm``."""
    from repro_torch.kernels import ssd_scan as SSD
    bf16 = torch.bfloat16
    B, S = FAMILY_BATCH, FAMILY_PROMPT
    nh, hp, st, Q = 80, 64, 128, 256
    args = ssd_inputs(B, S, nh, hp, st, bf16, device, 100)
    y, h = SSD.ssd_scan(*args, chunk=Q)
    y_ref, h_ref = SSD.ssd_scan_ref(*args, chunk=Q)

    def kernel():
        return SSD.ssd_scan(*args, chunk=Q)
    ssd = with_bound({
        "max_abs_err": max(float((g.float() - w.float()).abs().max())
                           for g, w in ((y, y_ref), (h, h_ref))),
        "tol_ratio": max(tol_ratio(y, y_ref, "ssd_scan"),
                         tol_ratio(h, h_ref, "ssd_scan")),
        "rerun_bit_equal": all(torch.equal(a, b)
                               for a, b in zip((y, h), kernel())),
        "ms": time_call(kernel, (), 10, device, flush),
        "plain_ms": time_call(lambda: SSD.ssd_scan_ref(*args, chunk=Q), (),
                              2, device, flush),
        "library_ms": None,
        "parts_ms": kernel_parts_ms(
            lambda: SSD.ssd_scan(*args, chunk=Q), (),
            ("ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel"),
            device),
        "shape": {"b": B, "S": S, "nh": nh, "hp": hp, "st": st, "chunk": Q},
        **work(SSD.ssd_scan_cost(B, S, nh, hp, st, Q, 2))}, BF16_OPS_PER_S)
    del args, y, h, y_ref, h_ref
    torch.cuda.empty_cache()
    flash = flash_record(B, 1500, 1500, 12, 12, 64, False, 110, device,
                         flush)
    rms = [rmsnorm_record(randn((B, S, d), bf16, device, 120 + i),
                          randn((d,), bf16, device, 121 + i), device, flush,
                          plain_reps=5) for i, d in enumerate((2560, 5120))]
    return ssd, flash, rms


def phase_ssm_encdec(device, flush, model_records):
    """Phase [19]: (a) mamba2-2.7b and (b) whisper-small served at full
    width and depth; (c) their smoke cuts, card against CPU; (d) the
    kernels at their calls, added to the kernels' records."""
    import gc
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    runs = {"mamba2-2.7b": mamba_serving(device)}
    log(f"[19a] {time.perf_counter() - t_phase:.1f} s")
    runs["whisper-small"] = whisper_serving(device)
    log(f"[19b] {time.perf_counter() - t_phase:.1f} s")
    card_cpu = {a: phase_small_card_vs_cpu(device, a)
                for a in SSM_ENCDEC_ARCHS}
    log(f"[19c] smoke archs, float32, card vs CPU (largest difference / "
        f"largest magnitude): {json.dumps(card_cpu)}")
    require(max(card_cpu.values()) <= 1e-4, f"[19c] card vs CPU {card_cpu}")
    ssd, flash, rms = ssm_encdec_kernel_records(device, flush)
    for tag, r in [("ssd_scan at mamba2's prefill call", ssd),
                   ("flash_attention at whisper's encoder call", flash)] + [
            (f"rmsnorm at mamba2's rows of {r['shape']['D']}", r)
            for r in rms]:
        require(r["tol_ratio"] <= 1.0 and r["rerun_bit_equal"],
                f"{tag}: tol_ratio {r['tol_ratio']}, rerun "
                f"{r['rerun_bit_equal']}")
        log(f"[19d] {tag} {json.dumps(r)}")
    launches = launches_of(runs.values(),
                           ("rmsnorm", "flash_attention", "ssd_scan"))
    at = {"rmsnorm": ("at_mamba_call", rms),
          "flash_attention": ("at_whisper_encoder_call", flash),
          "ssd_scan": ("at_mamba_prefill_call", ssd)}
    for r in model_records:
        if r["name"] in launches:
            r.setdefault("launches_by_path",
                         {"prefill/decode [8]": r["launches"]})
            r["launches_by_path"]["serve ssm/encdec [19]"] = \
                launches[r["name"]]
            r["launches"] = sum(r["launches_by_path"].values())
            key, rec = at[r["name"]]
            r[key] = rec
    wall = time.perf_counter() - t_phase
    log(json.dumps({"ssm_encdec": runs, "launches": launches,
                    "wall_s": wall}))
    log(f"[19] {wall:.1f} s")


# ---------------------------------------------------------------------------
# phase 20: the SSM and hybrid families' training
# ---------------------------------------------------------------------------

#: (b, S, nh, hp, st, chunk) of [20a]: states 16, 64, 96 and 128, a call
#: whose S is its chunk, the longest chunk (1024, sixteen 64-row tiles) at
#: state 128, and 7 heads (no whole number of the bf16 kernels' head pairs
#: and column groups of 4, nor of the float32 kernel's groups of 4)
SSD_BWD_SHAPES = ((1, 64, 2, 32, 16, 32), (2, 256, 4, 64, 64, 64),
                  (1, 512, 3, 64, 96, 128), (2, 512, 8, 64, 128, 256),
                  (1, 256, 4, 64, 128, 256), (1, 2048, 4, 64, 128, 1024),
                  (1, 512, 7, 64, 128, 256))
#: tokens a step of [20d] and [20e]: 4 sequences (mb4_remat needs a batch
#: that splits into 4), each cut from 2048 to 1024 tokens: at 4 x 2048
#: mb1_noremat keeps ~0.96 GB a Mamba2 layer (61 GB over 64) beside the
#: 32.4 GB of state, past 80 GB (PERF.md section 4)
SSM_TRAIN_B, SSM_TRAIN_S = 4, 1024
#: 5 steps: the fewest at which the tuner explores each of the five plans
#: (7 until the script passed 1,050 s with [20], PERF.md section 4)
SSM_FULL_STEPS = 5
#: zamba2-7b trains cut to 18 of its 81 layers (2 segments): at full depth
#: its 6.75e9 parameters take 81 GB in bf16 weights and gradients and
#: float32 moments (27 layers, 3 segments, until the script passed 1,050 s)
ZAMBA_TRAIN_LAYERS, ZAMBA_STEPS = 18, 5


def ssd_bwd_args(b, S, nh, hp, st, dtype, device, seed, with_dstate=False):
    args = ssd_inputs(b, S, nh, hp, st, dtype, device, seed)
    dy = randn((b, S, nh, hp), dtype, device, seed + 4, 0.5)
    dstate = (randn((b, nh, hp, st), torch.float32, device, seed + 5, 0.5)
              if with_dstate else None)
    return args, dy, dstate


def ssd_bwd_within(errs, dtype) -> bool:
    """float32: each gradient within the forward's float32 tolerance of
    its largest magnitude (of the exact gradient, see ``ssd_bwd_small``);
    bf16: relative L2 within BWD_BF16_REL_L2."""
    if dtype == torch.float32:
        return all(e[0] <= MODEL_TOL["ssd_scan"] for e in errs)
    return all(e[1] <= BWD_BF16_REL_L2 for e in errs)


def ssd_bwd_small(device):
    """[20a]: ``ssd_scan_bwd`` at SSD_BWD_SHAPES, float32 and bf16, with no
    and with a random gradient of the final state: every gradient finite
    and within its tolerance, and a rerun bit-equal.  bf16 is held against
    the plain version on the card.  float32 is held against the plain
    version run in float64 on the CPU (the exact gradient): the float32
    plain version rounds cum (the in-chunk sum of dt A, ~-2,600 at its
    end here) to float32's spacing of 2.4e-4 before exp(cum_i - cum_j), and
    its dA is up to ~5e-4 of its largest magnitude from the exact one at
    these inputs, more than the tolerance; both distances are logged."""
    from repro_torch.kernels import ssd_scan as SSD
    rows = []
    cpu = torch.device("cpu")
    for i, (b, S, nh, hp, st, Q) in enumerate(SSD_BWD_SHAPES):
        for dt in (torch.float32, torch.bfloat16):
            for with_dstate in (False, True):
                args, dy, ds = ssd_bwd_args(b, S, nh, hp, st, dt, device,
                                            200 + 10 * i, with_dstate)
                got = SSD.ssd_scan_bwd(*args, dy, ds, chunk=Q)
                plain = SSD.ssd_scan_bwd_ref(*args, dy, ds, chunk=Q)
                row = {"shape": [b, S, nh, hp, st, Q], "dtype": str(dt),
                       "dstate": with_dstate}
                if dt == torch.float32:
                    exact = SSD.ssd_scan_bwd_ref(
                        *(t.to(cpu, torch.float64) for t in args),
                        dy.to(cpu, torch.float64),
                        None if ds is None else ds.to(cpu, torch.float64),
                        chunk=Q)
                    errs = grad_errors(got, exact)
                    row["vs_float32_plain_max_rel"] = [
                        e[0] for e in grad_errors(got, plain)]
                    row["float32_plain_vs_exact_max_rel"] = [
                        e[0] for e in grad_errors(plain, exact)]
                else:
                    errs = grad_errors(got, plain)
                again = SSD.ssd_scan_bwd(*args, dy, ds, chunk=Q)
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                rows.append({**row, "max_rel": [e[0] for e in errs],
                             "rel_l2": [e[1] for e in errs],
                             "ok": ssd_bwd_within(errs, dt),
                             "rerun_bit_equal": same})
    for r in rows:
        log(f"[20a] ssd_scan_bwd {json.dumps(r)}")
    require(all(r["ok"] and r["rerun_bit_equal"] for r in rows),
            "ssd_scan_bwd outside its tolerance or not bit-equal on rerun "
            "at the small shapes")
    return rows


def ssd_bwd_record(shape, seed, device, flush, train_S):
    """[20b]: the SSD backward at one training call (bf16) against its
    plain version, a rerun's bits, its time after an L2 flush with its
    three kernels' shares beside the bound and the plain version's time
    (no library call computes it), and its time at the training step's
    own call (``train_S`` tokens a sequence)."""
    from repro_torch.kernels import ssd_scan as SSD
    b, S, nh, hp, st, Q = shape
    args, dy, _ = ssd_bwd_args(b, S, nh, hp, st, torch.bfloat16, device,
                               seed)
    got = SSD.ssd_scan_bwd(*args, dy, chunk=Q)
    want = SSD.ssd_scan_bwd_ref(*args, dy, chunk=Q)
    errs = grad_errors(got, want)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    del want
    again = SSD.ssd_scan_bwd(*args, dy, chunk=Q)
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    del got, again
    rec = with_bound({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": REPLACES["ssd_scan_bwd"],
        "max_abs_err": err, "rel_l2": [e[1] for e in errs],
        "tolerance": {"bf16_rel_l2": BWD_BF16_REL_L2},
        "within": ssd_bwd_within(errs, torch.bfloat16),
        "rerun_bit_equal": same,
        "ms": time_call(lambda: SSD.ssd_scan_bwd(*args, dy, chunk=Q), (),
                        5, device, flush),
        "plain_ms": time_call(lambda: SSD.ssd_scan_bwd_ref(
            *args, dy, chunk=Q), (), 2, device, flush),
        "library_ms": None,
        "parts_ms": kernel_parts_ms(
            lambda: SSD.ssd_scan_bwd(*args, dy, chunk=Q), (),
            ("ssd_bwd_state_kernel", "ssd_bwd_pass_kernel",
             "ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel",
             "ssd_bwd_finish_kernel"), device),
        "shape": {"b": b, "S": S, "nh": nh, "hp": hp, "st": st,
                  "chunk": Q},
        **work(SSD.ssd_scan_bwd_cost(b, S, nh, hp, st, Q, 2))},
        BF16_OPS_PER_S)
    del args, dy
    args, dy, _ = ssd_bwd_args(b, train_S, nh, hp, st, torch.bfloat16,
                               device, seed)
    rec["at_training_call"] = {
        "S": train_S, "ms": time_call(
            lambda: SSD.ssd_scan_bwd(*args, dy, chunk=Q), (), 5, device,
            flush)}
    del args, dy
    torch.cuda.empty_cache()
    return rec


def flash_bwd_record(B, S, H, K, hd, seed, device, flush, train_S=None,
                     T=None, causal=True, forward=False):
    """[20b] / [21b] / [22b]: the flash backward at one call (bf16; q of S
    queries over T keys, default S, causal unless asked; Zamba2's shared
    block, olmoe's training call, whisper's three) against its plain
    version, a rerun's bits, timed after an L2 flush beside the bound, the
    plain version and SDPA's backward, the forward with its lse timed
    too; with ``forward``, that forward also in turns with SDPA's forward,
    beside its plain version's time and its bound (``forward``); and,
    given ``train_S``, at the training step's own call (S = T).
    The plain version's float32 scores are B x H x S x T x 4 bytes, and
    its autograd keeps a few of them: 1.73 GB each at whisper's encoder
    call (16 x 12 x 1,500^2)."""
    from repro_torch.kernels import flash_attention as FA
    bf16 = torch.bfloat16
    T = S if T is None else T
    q, do = (randn((B, S, H, hd), bf16, device, seed + i) for i in range(2))
    k, v = (randn((B, T, K, hd), bf16, device, seed + 2 + i)
            for i in range(2))
    o, lse = FA.flash_attention_lse(q, k, v, causal=causal)
    got = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    want = FA.flash_attention_bwd_ref(q, k, v, o, do, causal=causal)
    plain_gb = (torch.cuda.max_memory_allocated(device) - before) / 1e9
    errs = grad_errors(got, want)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    again = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, want, again
    torch.cuda.empty_cache()
    rec = with_bound({
        "max_abs_err": err, "rel_l2": [e[1] for e in errs],
        "within": bwd_within(errs, bf16), "rerun_bit_equal": same,
        "plain_peak_gb": plain_gb,
        "ms": time_call(lambda: FA.flash_attention_bwd(
            q, k, v, o, do, lse, causal=causal), (), 5, device, flush),
        "plain_ms": time_call(lambda: FA.flash_attention_bwd_ref(
            q, k, v, o, do, causal=causal), (), 2, device, flush),
        "library_ms": time_grad(sdpa_graph, (q, k, v, do, causal), 10,
                                device, flush),
        "fwd_lse_ms": time_call(lambda: FA.flash_attention_lse(
            q, k, v, causal=causal), (), 5, device, flush),
        "shape": {"B": B, "S": S, "T": T, "H": H, "K": K, "hd": hd,
                  "causal": causal},
        **work(FA.flash_attention_bwd_cost(B, S, T, H, K, hd, causal, 2))},
        BF16_OPS_PER_S)
    if forward:
        rec["forward"] = flash_fwd_lse_record(q, k, v, causal, device, flush)
    del q, k, v, o, do, lse
    if train_S is None:
        torch.cuda.empty_cache()
        return rec
    q, do = (randn((B, train_S, H, hd), bf16, device, seed + i)
             for i in range(2))
    k, v = (randn((B, train_S, K, hd), bf16, device, seed + 2 + i)
            for i in range(2))
    o, lse = FA.flash_attention_lse(q, k, v, causal=True)
    rec["at_training_call"] = {"S": train_S, "ms": time_call(
        lambda: FA.flash_attention_bwd(q, k, v, o, do, lse, causal=True),
        (), 5, device, flush)}
    del q, k, v, o, do, lse
    torch.cuda.empty_cache()
    return rec


def flash_fwd_lse_record(q, k, v, causal, device, flush):
    """The forward kernel with its lse (the training call) at one bf16
    call, timed in turns with SDPA's forward after an L2 flush, beside the
    plain version's time and the bound."""
    from repro_torch.kernels import flash_attention as FA
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    return with_bound({
        **turns_ms({"ms": lambda: FA.flash_attention_lse(q, k, v,
                                                         causal=causal),
                    "library_ms": lambda:
                    torch.nn.functional.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=causal,
                        enable_gqa=True)}, 10, device, flush),
        "plain_ms": time_call(lambda: FA.flash_attention_ref(
            q, k, v, causal=causal), (), 2, device, flush),
        **work(FA.flash_attention_cost(B, S, T, H, K, hd, causal, 2,
                                       with_lse=True))}, BF16_OPS_PER_S)


def expected_step_launches(cfg, microbatches, remat):
    """The kernel launches of one train step: per microbatch, each Mamba2
    layer's SSD scan (twice under remat: the checkpoint recomputes it) and
    backward, its two rmsnorms, each attention block's flash attention
    and its two rmsnorms, four with QK-norm (a MoE layer; the hybrid's
    shared block after each segment), each recomputed under remat, and
    the final norm (once).  The enc-dec family: a flash attention and its
    backward for each encoder layer and two for each decoder layer (self
    and cross), none recomputed (no checkpoint in that stack, remat or
    not), and no rmsnorm (its norms are LayerNorms)."""
    if cfg.family == "encdec":
        attn = (cfg.encoder_layers + 2 * cfg.n_layers) * microbatches
        return {"flash_attention": attn, "flash_attention_bwd": attn}
    L = cfg.n_layers
    attn = {"moe": L, "hybrid": L // max(cfg.attn_every, 1)}.get(
        cfg.family, 0)
    ssd = 0 if cfg.family == "moe" else L
    norms = 2 * ssd + (2 + 2 * cfg.qk_norm) * attn
    fwd = 2 if remat else 1
    out = {"rmsnorm": fwd * norms + 1, "rmsnorm_bwd": norms + 1}
    if ssd:
        out.update(ssd_scan=fwd * ssd, ssd_scan_bwd=ssd)
    if attn:
        out.update(flash_attention=fwd * attn, flash_attention_bwd=attn)
    return {k: v * microbatches for k, v in out.items()}


def tuned_training(cfg, steps, ckpt, device):
    """``launch.train.main``'s wiring (``Trainer`` + ``StepAutoTuner`` over
    ``DEFAULT_PLANS`` under ExhaustiveSel + ``make_plan_builder``, its
    per-plan records) for a config the launcher has no flag for (a
    depth cut), SSM_TRAIN_B x SSM_TRAIN_S tokens a step."""
    from repro_torch.data import DataConfig
    from repro_torch.distributed import (DEFAULT_PLANS, StepAutoTuner,
                                         make_plan_builder)
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=min(20, steps // 5),
                          total_steps=steps, moment_dtype=cfg.moment_dtype)
    records = []
    tuner = StepAutoTuner(list(DEFAULT_PLANS), train.measured(
        make_plan_builder(cfg, opt_cfg, device), device, records),
        method="ExhaustiveSel")
    trainer = Trainer(cfg, opt_cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SSM_TRAIN_S,
        global_batch=SSM_TRAIN_B), TrainerConfig(
            ckpt_dir=str(ckpt), ckpt_every=max(10, steps // 5)),
        autotuner=tuner, device=device)
    trainer.install_preemption_handler()
    out = trainer.train(steps)
    out["plans"] = train.plan_summary(tuner.history, records,
                                      SSM_TRAIN_B * SSM_TRAIN_S)
    out["history"] = list(tuner.history)
    out["compile_s"] = {tuner.plans[i].name: t
                        for i, t in tuner.compile_times.items()}
    out["settled"] = tuner.selected_plan
    return out


def family_full_run(arch, device):
    """[20d] / [20e] / [21c] / [22c]: ``arch`` at full width in bf16
    through the training entry points under ExhaustiveSel over
    DEFAULT_PLANS: mamba2-2.7b at full depth through ``launch.train.main``
    and zamba2-7b cut to ZAMBA_TRAIN_LAYERS and olmoe-1b-7b cut to
    MOE_TRAIN_LAYERS through the same wiring, SSM_TRAIN_B x SSM_TRAIN_S
    tokens a step; whisper-small at full depth through
    ``launch.train.main``, WHISPER_TRAIN_B clips of its encoder's frames
    and WHISPER_CONTEXT decoder tokens a step.  Per plan its steps'
    seconds, tokens/s (whisper's frames/s beside them), peak allocated
    memory and launches a step (held exactly against
    ``expected_step_launches``), the settled plan, the loss (finite, and
    lower after training on the first step's batch, frames and all, than
    that step's; olmoe's ``expert_load`` and ``dropped_frac`` there), the
    final save's wall (the checkpoint deleted after) and, for mamba2
    and whisper, ``step_breakdown`` of one more mb1_noremat step; for
    whisper, what drawing a step's frames and copying them to the card
    take on the host, and steps with and without remat in turns
    (``remat_turns``)."""
    import gc
    import shutil
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import DEFAULT_PLANS
    from repro_torch.launch import train
    from repro_torch.models import loss_fn
    cfg = get_config(arch)
    cut, steps, tag = {"ssm": (None, SSM_FULL_STEPS, "20d"),
                       "hybrid": (ZAMBA_TRAIN_LAYERS, ZAMBA_STEPS, "20e"),
                       "moe": (MOE_TRAIN_LAYERS, MOE_STEPS, "21c"),
                       "encdec": (None, WHISPER_STEPS, "22c")}[cfg.family]
    encdec = cfg.family == "encdec"
    B, S = ((WHISPER_TRAIN_B, WHISPER_CONTEXT) if encdec
            else (SSM_TRAIN_B, SSM_TRAIN_S))
    if cut is not None:
        cfg = dataclasses.replace(cfg, n_layers=cut)
    ckpt = checkpoint_dir(cfg, arch, f"[{tag}]")
    gc.collect()
    torch.cuda.empty_cache()
    resident = (torch.cuda.memory_allocated(device)
                if device.type == "cuda" else 0)
    log(f"[{tag}] allocated before the run: {resident / 1e9:.2f} GB")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        if cut is None:
            out = train.main(["--arch", arch, "--full", "--seq-len",
                              str(S), "--batch", str(B),
                              "--steps", str(steps), "--ckpt", str(ckpt),
                              "--device", str(device)])
        else:
            out = tuned_training(cfg, steps, ckpt, device)
    finally:
        signal.signal(signal.SIGTERM, sigterm)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
    losses = out["losses"]
    n_par = sum(t.numel() for g in out["params"].values()
                for t in (g.values() if isinstance(g, dict) else [g]))
    stacks = ("enc_layers", "dec_layers") if encdec else ("layers",)
    layers = [next(iter(out["params"][g].values())).shape[0]
              for g in stacks]
    frames = B * cfg.encoder_seq if encdec else None
    plans = {p.name: p for p in DEFAULT_PLANS}
    rows = []
    for r in out["plans"]:
        p = plans[r["plan"]]
        want = expected_step_launches(cfg, p.microbatches, p.remat)
        rows.append({**r, "peak_gb": (r["peak_bytes"] or 0) / 1e9,
                     "build_s": out["compile_s"].get(r["plan"]),
                     "expected_launches": want,
                     "launches_exact": r["launches_per_step"] == want})
        if encdec:
            rows[-1]["frames_per_s"] = [frames / t for t in r["step_s"]]
    note_train_cell(f"[{tag}]", cfg, B, S, rows, resident)
    # the loss falls where the batch is the same: the trained state's
    # loss on the first step's batch against that step's (a step's loss
    # moves with its batch by as much as a few steps move it); the
    # enc-dec family's batch is drawn as the trainer draws it, with the
    # step's frames, and the frames' host cost is timed here
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B))
    host = None
    if encdec:
        t1 = time.perf_counter()
        drawn = pipe.frames_at(0, cfg.encoder_seq, cfg.d_model)
        t2 = time.perf_counter()
        emb = torch.from_numpy(drawn).to(device)
        torch.cuda.synchronize(device)
        host = {"frames_draw_s": t2 - t1,
                "frames_copy_s": time.perf_counter() - t2,
                "frames_mb": drawn.nbytes / 1e6}
        del emb, drawn
    first = train_batch(cfg, pipe, 0, device)
    with torch.no_grad(), moe_stats() as dispatch:
        first_after = float(loss_fn(dataclasses.replace(cfg, remat=False),
                                    out["params"], first)[0])
    del first
    moe = None
    if dispatch:
        load = torch.stack([a["expert_load"] for a in dispatch])
        moe = {"expert_load": load.cpu().tolist(),
               "dropped_frac": [float(a["dropped_frac"]) for a in dispatch],
               "routed_per_layer": int(load[0].sum())}
    # mamba2's and whisper's breakdown of one more mb1_noremat step
    # (after the loss above: it trains the state two steps further), and
    # whisper's steps with and without remat in turns (four more)
    breakdown = (step_breakdown(cfg, out["params"], out["opt"], device,
                                B, S, steps)
                 if cfg.family in ("ssm", "encdec") else None)
    turns = (remat_turns(cfg, out["params"], out["opt"], device, B, S,
                         steps) if encdec else None)
    summary = {
        "arch": arch, "layers": layers if encdec else layers[0],
        "d_model": cfg.d_model,
        "dtype": cfg.param_dtype, "params": n_par,
        # ModelConfig.n_params, the reference's count (it leaves out each
        # Mamba2 layer's dt_bias and gate_norm)
        "n_params": cfg.n_params(),
        "tokens_per_step": B * S, "frames_per_step": frames,
        "host_frames": host,
        "steps": out["final_step"], "wall_s": wall, "losses": losses,
        "first_batch_loss_after": first_after, "plans": rows,
        "history": [h[0] for h in out["history"]],
        "settled": out["settled"], "final_save_s": out["final_save_s"],
        "checkpoint_gb": ckpt_bytes / 1e9, "launches": launches,
        "step_breakdown": breakdown, "remat_turns": turns,
        "first_batch_dispatch": moe}
    del out
    gc.collect()
    t1 = time.perf_counter()
    shutil.rmtree(ckpt)
    summary["checkpoint_rm_s"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    require(layers == ([cfg.encoder_layers, cfg.n_layers] if encdec
                       else [cfg.n_layers]), f"[{tag}] {layers} layers")
    require(summary["steps"] == steps and len(losses) == steps
            and bool(np.all(np.isfinite(losses)))
            and first_after < losses[0], f"[{tag}] loss trace {losses}, "
            f"the first batch's after training {first_after}")
    require(summary["history"][:5] == [r["plan"] for r in rows]
            and len(rows) == 5, f"[{tag}] not every plan explored")
    bad = [(r["plan"], r["launches_per_step"], r["expected_launches"])
           for r in rows if not r["launches_exact"]]
    require(not bad, f"[{tag}] launches a step {bad}")
    names = [] if encdec else ["rmsnorm", "rmsnorm_bwd"]
    if cfg.family in ("ssm", "hybrid"):
        names += ["ssd_scan", "ssd_scan_bwd"]
    if cfg.family != "ssm":
        names += ["flash_attention", "flash_attention_bwd"]
    for name in names:
        require(launches[name] > 0, f"[{tag}] {name} was never launched")
    if moe is not None:
        tokens = SSM_TRAIN_B * SSM_TRAIN_S * cfg.experts_per_token
        require(len(dispatch) == cfg.n_layers and all(
            int(r.sum()) == tokens for r in load), f"[{tag}] expert_load "
            f"{moe['expert_load']}")
    return summary


def phase_ssm_training(device, flush, model_records, bwd_records):
    """Phase [20]: (a) the SSD backward at small shapes, (b) the SSD and
    flash backwards at the training calls, (c) the smoke cuts on the card,
    (d) mamba2-2.7b and (e) zamba2-7b (18 layers) trained at full width.
    Returns the SSD backward's kernel record; the training paths' launches
    are added to the other kernels' records."""
    import gc
    import tempfile
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ssd_bwd_small(device)
    log(f"[20a] {time.perf_counter() - t_phase:.1f} s")
    rec = ssd_bwd_record((TRAIN_B, TRAIN_S, 80, 64, 128, 256), 300, device,
                         flush, SSM_TRAIN_S)
    rec["at_zamba_call"] = ssd_bwd_record(
        (TRAIN_B, TRAIN_S, 112, 64, 64, 256), 310, device, flush,
        SSM_TRAIN_S)
    flash = flash_bwd_record(TRAIN_B, TRAIN_S, 32, 32, 112, 320, device,
                             flush, SSM_TRAIN_S)
    for tag, r in (("ssd_scan_bwd at mamba2's call", rec),
                   ("ssd_scan_bwd at zamba2's call", rec["at_zamba_call"]),
                   ("flash_attention_bwd at zamba2's shared block", flash)):
        log(f"[20b] {tag}: {json.dumps(r)}")
        require(r["within"] and r["rerun_bit_equal"], f"[20b] {tag}: "
                f"rel L2 {r['rel_l2']}, rerun {r['rerun_bit_equal']}")
    log(f"[20b] {time.perf_counter() - t_phase:.1f} s")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for arch in ("mamba2-2.7b", "zamba2-7b"):
            log(f"[20c] {arch} smoke, gradients on the card: "
                f"{json.dumps(leaves_get_gradients(device, arch, '[20c]'))}")
            log(f"[20c] {arch} smoke, card vs CPU, float32: "
                f"{json.dumps(card_vs_cpu(device, tmp, arch, '[20c]'))}")
    log(f"[20c] {time.perf_counter() - t_phase:.1f} s")
    runs = {arch: logged_full_run(tag, arch, device)
            for tag, arch in (("20d", "mamba2-2.7b"), ("20e", "zamba2-7b"))}
    by_path = {f"train {a} [20]": r["launches"] for a, r in runs.items()}
    rec["launches_by_path"] = {k: v["ssd_scan_bwd"]
                               for k, v in by_path.items()}
    rec["launches"] = sum(rec["launches_by_path"].values())
    add_launches(model_records + bwd_records, by_path,
                 ("rmsnorm", "flash_attention", "ssd_scan", "rmsnorm_bwd",
                  "flash_attention_bwd"))
    for r in bwd_records:
        if r["name"] == "flash_attention_bwd":
            r["at_zamba_call"] = flash
    log(f"[20] {time.perf_counter() - t_phase:.1f} s")
    return rec


def logged_full_run(tag, arch, device):
    """``family_full_run`` of ``arch``, its summary and each plan logged."""
    t0 = time.perf_counter()
    full = family_full_run(arch, device)
    log(f"[{tag}] {json.dumps(full)}")
    for r in full["plans"]:
        frames = (f", frames/s {[round(t) for t in r['frames_per_s']]}"
                  if "frames_per_s" in r else "")
        log(f"[{tag}] {r['plan']}: steps {r['step_s']} s, tokens/s "
            f"{[round(t) for t in r['tokens_per_s']]}{frames}, peak "
            f"{r['peak_gb']:.2f} GB, launches a step "
            f"{json.dumps(r['launches_per_step'])}")
    log(f"[{tag}] settled on {full['settled']}; loss {full['losses']}; "
        f"final save {full['final_save_s']:.1f} s "
        f"({full['checkpoint_gb']:.1f} GB); "
        f"{time.perf_counter() - t0:.1f} s")
    if full["step_breakdown"]:
        log(f"[{tag}] one more mb1_noremat step, by layer: "
            f"{json.dumps(full['step_breakdown'])}")
    if full["remat_turns"]:
        log(f"[{tag}] steps with and without remat, in turns: "
            f"{json.dumps(full['remat_turns'])}")
    return full


def add_launches(records, by_path, names):
    """Each path's launches of each kernel in ``names`` added to that
    kernel's record (``launches_by_path``, ``launches`` their sum)."""
    for r in records:
        if r["name"] in names:
            r.setdefault("launches_by_path", {})
            for k, v in by_path.items():
                r["launches_by_path"][k] = v[r["name"]]
            r["launches"] = sum(r["launches_by_path"].values())


# ---------------------------------------------------------------------------
# phase 21: the MoE family's training
# ---------------------------------------------------------------------------

#: olmoe-1b-7b trains cut to 4 of its 16 layers: at full depth its 6.92e9
#: parameters take ~83 GB in bf16 weights and gradients and float32
#: moments before any activation; 6 layers (2.72e9) held 39-49 GB, until
#: [22] took the script past 1,080 s on a slow host and the cut went to 4
#: (PERF.md section 4)
MOE_TRAIN_LAYERS, MOE_STEPS = 4, 5


@contextlib.contextmanager
def dispatch_gathers():
    """The arguments after x (t_sorted, keep, by_token, k) of every
    dispatch gather ``moe_block`` makes while the context is open."""
    from repro_torch.models import layers as L
    seen, orig = [], L._DispatchGather.apply

    def recorded(x, *args):
        seen.append(args)
        return orig(x, *args)
    L._DispatchGather.apply = recorded
    try:
        yield seen
    finally:
        del L._DispatchGather.apply


def moe_layer_grads(args, k, remat):
    """One ``moe_block`` forward and backward (a fixed output gradient),
    the block checkpointed under ``remat``: its output, aux and the
    gradients of x, the router and the three expert weights."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models.layers import moe_block
    leaves = [a.detach().requires_grad_() for a in args]
    if remat:
        out, aux = checkpoint(lambda *a: moe_block(*a, k=k), *leaves,
                              use_reentrant=False)
    else:
        out, aux = moe_block(*leaves, k=k)
    dy = randn(out.shape, out.dtype, out.device, 9, 0.1)
    grads = torch.autograd.grad(out, leaves, dy)
    return out.detach(), aux, grads


def moe_layer_check(device):
    """[21b]: one olmoe MoE layer at full width in bf16 over a training
    step's 4 x 1024 tokens (D 2,048, 64 experts, top-8, F 1,024): forward
    and backward twice and once checkpointed, the outputs and the five
    gradients bit-equal across the three; ``dropped_frac``, above 0 (the
    tokens share a component, as a residual stream's do, so the router
    favours some experts: ~0.24 of the assignments overflow); and, for
    the record, whether autograd's own backward of the dispatch's gather
    (an indexed accumulate, which ``_DispatchGather`` replaces) reruns
    bit-equal here and how far it is from the fixed-order sum."""
    T, D, E, F, k = SSM_TRAIN_B * SSM_TRAIN_S, 2048, 64, 1024, 8
    bf16 = torch.bfloat16
    shared = 0.5 * randn((1, D), torch.float32, device, 406)
    args = [(randn((T, D), torch.float32, device, 400) + shared).to(bf16),
            randn((D, E), bf16, device, 401, D ** -0.5),
            randn((E, D, F), bf16, device, 402, D ** -0.5),
            randn((E, D, F), bf16, device, 403, D ** -0.5),
            randn((E, F, D), bf16, device, 404, F ** -0.5)]
    t0 = time.perf_counter()
    with dispatch_gathers() as gathers:
        runs = [moe_layer_grads(args, k, remat) for remat in
                (False, False, True)]
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    (out, aux, grads), rerun, remat = runs
    same = {name: all(torch.equal(a, b) for a, b in
                      zip((out,) + grads, (o,) + g))
            for name, (o, _, g) in (("rerun", rerun), ("remat", remat))}
    t_sorted, keep, by_token, _ = gathers[0]
    rows = t_sorted[keep]
    g = randn((rows.shape[0], D), bf16, device, 405)
    plain = []
    for _ in range(2):
        x = args[0].detach().requires_grad_()
        plain.append(torch.autograd.grad(x[rows], x, g)[0])
    x = args[0].detach().requires_grad_()
    from repro_torch.models.layers import _DispatchGather
    fixed = torch.autograd.grad(_DispatchGather.apply(
        x, t_sorted, keep, by_token, k), x, g)[0]
    out_rec = {
        "tokens": T, "d_model": D, "experts": E, "top_k": k, "d_ff": F,
        "capacity": max(1, int(1.25 * k * T / E)),
        "dropped_frac": float(aux["dropped_frac"]),
        "bit_equal": same, "wall_s_three_runs": wall,
        "grads_finite": all(bool(torch.isfinite(t.float()).all())
                            for t in grads),
        "autograd_gather_backward": {
            "rerun_bit_equal": torch.equal(plain[0], plain[1]),
            "max_abs_vs_fixed_order": float(
                (plain[0].float() - fixed.float()).abs().max()),
            "fixed_order_max_abs": float(fixed.float().abs().max())}}
    del args, runs, out, aux, grads, rerun, remat, gathers, plain, fixed
    torch.cuda.empty_cache()
    require(all(same.values()) and out_rec["grads_finite"]
            and out_rec["dropped_frac"] > 0,
            f"[21b] the MoE layer's backward {out_rec}")
    return out_rec


def phase_moe_training(device, flush, model_records, bwd_records):
    """Phase [21]: (a) olmoe's smoke cut on the card, (b) one MoE layer's
    backward at full width and the rmsnorm and flash backwards at olmoe's
    training calls, (c) olmoe-1b-7b trained at full width cut to
    MOE_TRAIN_LAYERS of its 16 layers.  The training path's launches are
    added to the kernels' records."""
    import gc
    import tempfile
    arch = "olmoe-1b-7b"
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        log(f"[21a] {arch} smoke, gradients on the card: "
            f"{json.dumps(leaves_get_gradients(device, arch, '[21a]'))}")
        log(f"[21a] {arch} smoke, card vs CPU, float32: "
            f"{json.dumps(card_vs_cpu(device, tmp, arch, '[21a]'))}")
    log(f"[21a] {time.perf_counter() - t_phase:.1f} s")
    log(f"[21b] one MoE layer at full width, bf16: "
        f"{json.dumps(moe_layer_check(device))}")
    B, S, bf16 = SSM_TRAIN_B, SSM_TRAIN_S, torch.bfloat16
    rms = {}
    for name, shape in (("qk_norm", (B, S, 16, 128)),
                        ("layer_norm", (B, S, 2048))):
        x, dy = (randn(shape, bf16, device, 410 + i) for i in range(2))
        w = randn(shape[-1:], bf16, device, 412)
        rms[name] = rmsnorm_bwd_record(x, w, dy, device, flush)
        del x, dy, w
    flash = flash_bwd_record(B, S, 16, 16, 128, 420, device, flush)
    for tag, r in (("rmsnorm_bwd at the QK-norm", rms["qk_norm"]),
                   ("rmsnorm_bwd at the layer norms", rms["layer_norm"]),
                   ("flash_attention_bwd", flash)):
        log(f"[21b] {tag}, olmoe's training call: {json.dumps(r)}")
        require(r["within"] and r["rerun_bit_equal"], f"[21b] {tag}: "
                f"rel L2 {r['rel_l2']}, rerun {r['rerun_bit_equal']}")
    torch.cuda.empty_cache()
    log(f"[21b] {time.perf_counter() - t_phase:.1f} s")
    full = logged_full_run("21c", arch, device)
    log(f"[21c] {arch}, first batch after training: "
        f"dropped_frac {full['first_batch_dispatch']['dropped_frac']}")
    add_launches(model_records + bwd_records,
                 {f"train {arch} [21]": full["launches"]},
                 ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                  "flash_attention_bwd"))
    for r in bwd_records:
        if r["name"] == "rmsnorm_bwd":
            r["at_olmoe_training_calls"] = rms
        if r["name"] == "flash_attention_bwd":
            r["at_olmoe_training_call"] = flash
    log(f"[21] {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 22: the enc-dec family's training
# ---------------------------------------------------------------------------

#: [22c] whisper-small at full width and depth: 16 clips of its encoder's
#: 1,500 stub frames and WHISPER_CONTEXT (448) decoder tokens a step, 5
#: steps (one a plan); its 278.2e6 parameters (ModelConfig.n_params
#: counts 334.5e6: three MLP matrices a layer, whisper has two) hold 2.8
#: GB of bf16 weights and float32 moments, activations ~20 GB at mb1
#: (PERF.md section 4): nothing is cut
WHISPER_TRAIN_B, WHISPER_STEPS = 16, 5
#: [22b] whisper-small's three training calls of the flash backward (B,
#: S, T, causal; 12 / 12 heads of 64): the encoder's self-attention, the
#: decoder's cross attention over the frames, its causal self-attention
WHISPER_ATTN_CALLS = (("encoder", 1500, 1500, False),
                      ("cross", WHISPER_CONTEXT, 1500, False),
                      ("decoder", WHISPER_CONTEXT, WHISPER_CONTEXT, True))


def phase_encdec_training(device, flush, model_records, bwd_records):
    """Phase [22]: (a) whisper-small's smoke cut on the card, (b) the flash
    backward at its three training calls, (c) whisper-small trained at
    full width and depth through ``launch.train.main``.  The training
    path's launches are added to the flash kernels' records."""
    import gc
    import tempfile
    arch = "whisper-small"
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        log(f"[22a] {arch} smoke, gradients on the card: "
            f"{json.dumps(leaves_get_gradients(device, arch, '[22a]'))}")
        log(f"[22a] {arch} smoke, card vs CPU, float32: "
            f"{json.dumps(card_vs_cpu(device, tmp, arch, '[22a]'))}")
    log(f"[22a] {time.perf_counter() - t_phase:.1f} s")
    calls = {}
    for i, (name, S, T, causal) in enumerate(WHISPER_ATTN_CALLS):
        r = flash_bwd_record(WHISPER_TRAIN_B, S, 12, 12, 64, 430 + 10 * i,
                             device, flush, T=T, causal=causal,
                             forward=True)
        log(f"[22b] flash_attention_bwd at whisper's {name} call: "
            f"{json.dumps(r)}")
        require(r["within"] and r["rerun_bit_equal"], f"[22b] {name}: "
                f"rel L2 {r['rel_l2']}, rerun {r['rerun_bit_equal']}")
        calls[name] = r
    torch.cuda.empty_cache()
    log(f"[22b] {time.perf_counter() - t_phase:.1f} s")
    full = logged_full_run("22c", arch, device)
    log(f"[22c] {arch}, the host's frames a step: "
        f"{json.dumps(full['host_frames'])}")
    add_launches(model_records + bwd_records,
                 {f"train {arch} [22]": full["launches"]},
                 ("flash_attention", "flash_attention_bwd"))
    for r in model_records + bwd_records:
        if r["name"] == "flash_attention":
            r["at_whisper_training_calls"] = {
                k: {"ms_with_lse": c["fwd_lse_ms"], "shape": c["shape"],
                    **c["forward"]}
                for k, c in calls.items()}
        if r["name"] == "flash_attention_bwd":
            r["at_whisper_training_calls"] = calls
    log(f"[22] {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 23: the dry run's count held against the card
# ---------------------------------------------------------------------------

#: the steps measured on the card, as [8], [17e], [18], [19], [20d],
#: [20e], [21c] and [22c] ran them, for [23]
MEASURED = []
#: [23]'s gates: no measured step below this share of its counted op-sum
#: bound (the count's per-op bytes are a lower bound only for ops larger
#: than the 50 MB L2), and no counted peak above this share of the card's
DRY_RUN_TIME_SHARE = 0.95
DRY_RUN_PEAK_SHARE = 1.02


def note_cell(tag, cfg, kind, B, S, seconds, peak_bytes, launches,
              max_len=None, allocated=None, resident=None, plan=None):
    """One measured step for [23]: ``cfg`` (its depth cut, its plan's
    remat), the kind, the batch, its wall, the card's peak allocated
    bytes and the model kernels' launches; what the card held that is
    not the step's: ``resident`` bytes, or ``allocated`` before the step
    with its arguments; and a train step's plan."""
    MEASURED.append({"tag": tag, "cfg": cfg, "kind": kind, "B": B, "S": S,
                     "max_len": max_len, "seconds": seconds,
                     "peak_bytes": peak_bytes, "launches": launches,
                     "allocated": allocated, "resident": resident,
                     "plan": plan})


#: the plans of each training run that [23] counts: the mb1_noremat step,
#: and the remat plans whose peaks a hand count once missed by 6-9 GB
DRY_RUN_PLANS = (("mb1_noremat", 1, False), ("mb1_remat", 1, True),
                 ("mb2_remat", 2, True))


def note_train_cell(tag, cfg, B, S, plans, resident):
    """A training run's plans of DRY_RUN_PLANS for [23]: each one's
    fastest step, its peak and its first step's launches; ``resident``:
    the card's allocated bytes before the run."""
    rows = {r["plan"]: r for r in plans}
    for name, microbatches, remat in DRY_RUN_PLANS:
        row = rows[name]
        note_cell(tag, dataclasses.replace(cfg, remat=remat), "train", B, S,
                  min(row["step_s"]), row["peak_bytes"],
                  row["launches_per_step"], resident=resident,
                  plan=(name, microbatches))


def phase_dry_run():
    """Phase [23]: every step of ``MEASURED`` (the prefills, and each
    training run's plans of DRY_RUN_PLANS) counted on the meta device by
    ``repro_torch.launch.dryrun.run_cell`` at its arch, depth cut, batch,
    plan (and, for a prefill, cache length), and held against the card:
    the hand-written kernels' launches equal the card's, the measured
    step takes at least DRY_RUN_TIME_SHARE of the counted op-sum bound,
    and the counted peak is at most DRY_RUN_PEAK_SHARE of the card's;
    logged without a gate: the bound's compute share of the step (its
    FLOPs at the H100's peaks over the measured wall), the op-sum share,
    the gap between the card's peak and the count's beside what the card
    held before the step, the peak's temporaries by the op that made
    them, and the bytes by category.  No model runs on the card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    rows = []
    for c in MEASURED:
        cfg = c["cfg"]
        shape = ShapeConfig(f"{c['kind']} {c['B']} x {c['S']}", c["kind"],
                            c["S"], c["B"])
        plan, microbatches = c["plan"] or (None, 1)
        rec = run_cell(cfg.name, shape.name, microbatches, cfg=cfg,
                       shape=shape, max_len=c["max_len"])
        bound, mem = rec["bound_s"], rec["memory"]
        card = {k: v for k, v in c["launches"].items() if v}
        meta = {k: v["launches"] for k, v in rec["kernels"].items()}
        resident = (c["resident"] if c["resident"] is not None
                    else c["allocated"] - mem["argument_bytes"])
        rows.append({
            "tag": c["tag"], "arch": cfg.name, "layers": cfg.n_layers,
            "kind": c["kind"], "plan": plan, "B": c["B"], "S": c["S"],
            "measured_s": c["seconds"], "op_sum_s": bound["op_sum_s"],
            "compute_s": bound["compute_s"], "memory_s": bound["memory_s"],
            "dominant": bound["dominant"],
            "op_sum_share": bound["op_sum_s"] / c["seconds"],
            "compute_share": bound["compute_s"] / c["seconds"],
            "flops": rec["flops_per_device"],
            "counted_peak_gb": mem["peak_bytes"] / 1e9,
            "measured_peak_gb": c["peak_bytes"] / 1e9,
            "peak_gap_gb": (c["peak_bytes"] - mem["peak_bytes"]) / 1e9,
            "resident_gb": resident / 1e9,
            "peak_by_op_gb": {k: v / 1e9 for k, v in
                              list(mem["peak_by_op"].items())[:6]},
            "argument_gb": mem["argument_bytes"] / 1e9,
            "launches_card": card, "launches_meta": meta,
            "launches_equal": card == meta,
            "op_launches": sum(rec["launches"].values()),
            "bytes_by_category_gb": {k: v / 1e9 for k, v in
                                     rec["bytes_by_category"].items() if v},
            "count_s": rec["count_s"]})
        log(f"[23] {json.dumps(rows[-1])}")
    log(f"[23] {len(rows)} steps counted on the meta device in "
        f"{time.perf_counter() - t0:.1f} s")
    require(len(rows) == 9 + 5 * len(DRY_RUN_PLANS)
            and {r["kind"] for r in rows} == {"train", "prefill"},
            f"[23] {len(rows)} measured steps")
    bad = [(r["arch"], r["plan"], r["launches_card"], r["launches_meta"])
           for r in rows if not r["launches_equal"]]
    require(not bad, f"[23] the count's launches differ from the card's: "
            f"{bad}")
    bad = [(r["arch"], r["plan"], r["measured_s"], r["op_sum_s"])
           for r in rows
           if r["measured_s"] < DRY_RUN_TIME_SHARE * r["op_sum_s"]]
    require(not bad, f"[23] steps faster than their counted bound: {bad}")
    bad = [(r["arch"], r["plan"], r["counted_peak_gb"],
            r["measured_peak_gb"]) for r in rows
           if r["counted_peak_gb"] > DRY_RUN_PEAK_SHARE
           * r["measured_peak_gb"]]
    require(not bad, f"[23] counted peaks above the card's: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phase 24: the sharding specs held against the card
# ---------------------------------------------------------------------------

#: the caching allocator's rounding of a block: every request goes up to a
#: multiple of ALLOC_GRANULE bytes (c10's kMinBlockSize), and a block
#: above ALLOC_SPLIT keeps a remainder of at most ALLOC_SPLIT unsplit
#: (kSmallSize: a large block splits only when more than that is left)
ALLOC_GRANULE = 512
ALLOC_SPLIT = 1 << 20
#: the cell whose per-device arguments [24a] allocates, and the arch
#: whose parameters [24b] cuts into every device's shards
SHARD_ALLOC_CELL = ("grok-1-314b", "train_4k")
SHARD_TILE_ARCH = "llama3.2-3b"


def allocate_shards(multi_pod, device, params):
    """[24a]: device (0, ...)'s share of SHARD_ALLOC_CELL's arguments
    (``launch.dryrun.mesh_layout``'s: the parameters, the AdamW state in
    the config's moment dtype, the batch) allocated on the card,
    ``torch.empty`` at each leaf's ``shard_shape``;
    the growth of the allocator's counts against the dry run's
    per-device argument bytes, and the allocator's rounding of the
    blocks (at least each block up to ALLOC_GRANULE, at most ALLOC_SPLIT
    more for a block above ALLOC_SPLIT).  ``params``: the arch's parameter
    stand-ins.  Frees what it allocated."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import shard_shape, spec_leaves
    from repro_torch.launch.dryrun import mesh_cell, mesh_layout
    from repro_torch.launch.mesh import production_mesh
    arch, shape = SHARD_ALLOC_CELL
    rec = mesh_cell(arch, shape, multi_pod, params=params)
    mesh = production_mesh(multi_pod=multi_pod)
    parts = mesh_layout(get_config(arch), SHAPES[shape], mesh, params)[0]
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    stats0 = torch.cuda.memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    held, asked = {}, {}
    for part, (tree, specs) in parts.items():
        held[part] = [torch.empty(shard_shape(s, tuple(leaf.shape), mesh),
                                  dtype=leaf.dtype, device=device)
                      for _, leaf, s in spec_leaves(tree, specs)]
        asked[part] = sum(t.numel() * t.element_size() for t in held[part])
    torch.cuda.synchronize(device)
    grown = torch.cuda.memory_allocated(device) - before
    stats1 = torch.cuda.memory_stats(device)
    requested = (stats1["requested_bytes.all.current"]
                 - stats0["requested_bytes.all.current"])
    sizes = [t.numel() * t.element_size() for ts in held.values()
             for t in ts]
    granule = sum(-n % ALLOC_GRANULE for n in sizes)
    unsplit = ALLOC_SPLIT * sum(n > ALLOC_SPLIT for n in sizes)
    count = rec["memory"]["argument_bytes"]
    row = {"cell": f"{arch} {shape}", "mesh": rec["mesh"],
           "blocks": len(sizes), "count_bytes": count,
           "count_gb": count / 1e9,
           "count_by_gb": {k: v / 1e9 for k, v in
                           rec["memory"]["argument_bytes_by"].items()},
           "asked_bytes": sum(asked.values()),
           "requested_bytes": requested, "allocated_growth_bytes": grown,
           "rounding_bytes": grown - count, "granule_rounding_bytes": granule,
           "unsplit_bound_bytes": unsplit}
    del held
    torch.cuda.empty_cache()
    require(asked == rec["memory"]["argument_bytes_by"],
            f"[24a] {rec['mesh']}: the leaves' shard bytes {asked} are not "
            f"the count's {rec['memory']['argument_bytes_by']}")
    require(requested == count, f"[24a] {rec['mesh']}: the allocator was "
            f"asked for {requested} bytes, the count is {count}")
    require(count + granule <= grown <= count + granule + unsplit,
            f"[24a] {rec['mesh']}: allocated grew by {grown} bytes, the "
            f"count {count} + rounding {granule} (+ at most {unsplit})")
    return row


def cat_grid(shards, counts, at=()):
    """The shards of a grid (``shards[index]``, one index a tensor dim,
    ``counts[d]`` of them along dim ``d``) concatenated back into one
    tensor, in index order."""
    if len(at) == len(counts):
        return shards[at]
    return torch.cat([cat_grid(shards, counts, at + (i,))
                      for i in range(counts[len(at)])], dim=len(at))


def tile_leaf(name, leaf, spec, mesh):
    """[24b] for one leaf: every device's shard (a copy, as the device
    would hold it) has its ``shard_shape``; the distinct shards form a
    grid of ranges that partition each dim, and concatenated back they
    are bit-equal to the leaf; devices that differ only on axes the spec
    does not name hold the same elements, and the others distinct
    ranges.  Returns (distinct shards, device 0's bytes)."""
    from repro_torch.distributed.sharding import shard_shape, shard_slices
    shape = tuple(leaf.shape)
    want = shard_shape(spec, shape, mesh)
    named_axes = {a for e in spec if e is not None
                  for a in ((e,) if isinstance(e, str) else e)}
    used = [i for i, a in enumerate(mesh.axis_names) if a in named_axes]
    shards, owner = {}, {}
    first = None
    for c in mesh.coords():
        sl = shard_slices(spec, shape, mesh, c)
        held = leaf[sl].clone()
        require(tuple(held.shape) == want, f"[24b] {name} at {c}: shard "
                f"{tuple(held.shape)}, shard_shape {want}")
        key = tuple(c[i] for i in used)
        if sl in shards:
            require(owner[sl] == key and torch.equal(shards[sl], held),
                    f"[24b] {name}: devices {owner[sl]} and {key} on the "
                    f"named axes share a shard")
        else:
            require(key not in owner.values(), f"[24b] {name}: devices "
                    f"equal on the named axes {key} hold different ranges")
            shards[sl], owner[sl] = held, key
        if first is None:
            first = held.numel() * held.element_size()
    ranges = [sorted({(s[d].start, s[d].stop) for s in shards})
              for d in range(len(shape))]
    for d, rs in enumerate(ranges):
        require(rs[0][0] == 0 and rs[-1][1] == shape[d] and all(
            a[1] == b[0] for a, b in zip(rs, rs[1:])), f"[24b] {name}: dim "
            f"{d}'s ranges {rs[:4]}... do not partition {shape[d]}")
    counts = [len(rs) for rs in ranges]
    require(len(shards) == int(np.prod(counts)), f"[24b] {name}: "
            f"{len(shards)} distinct shards, a grid of {counts}")
    grid = {tuple(ranges[d].index((sl[d].start, sl[d].stop))
                  for d in range(len(shape))): t for sl, t in shards.items()}
    whole = cat_grid(grid, counts)
    require(torch.equal(whole, leaf), f"[24b] {name}: the shards "
            "concatenated back differ from the leaf")
    return len(shards), first


def tile_parameters(device):
    """[24b]: SHARD_TILE_ARCH's parameters at full width and depth on the
    card, every leaf cut into all 256 devices' shards of 16x16
    (``tile_leaf``); device (0, 0)'s bytes against the dry run's
    per-device parameter bytes.  Frees the parameters."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import param_specs, spec_leaves
    from repro_torch.launch.dryrun import mesh_cell
    from repro_torch.launch.mesh import production_mesh
    from repro_torch.models import init_params
    cfg = get_config(SHARD_TILE_ARCH)
    mesh = production_mesh()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=device)
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    whole = sum(t.numel() * t.element_size()
                for _, t, _ in spec_leaves(params, param_specs(
                    cfg, mesh, params)))
    leaves, device0 = {}, 0
    for path, leaf, spec in spec_leaves(params, param_specs(cfg, mesh,
                                                            params)):
        n, b = tile_leaf("/".join(path), leaf, spec, mesh)
        leaves["/".join(path)] = {"spec": repr(spec), "shards": n}
        device0 += b
    count = mesh_cell(SHARD_TILE_ARCH, "train_4k", False)["memory"][
        "argument_bytes_by"]["params"]
    del params
    torch.cuda.empty_cache()
    require(device0 == count, f"[24b] device (0, 0) holds {device0} bytes "
            f"of the parameters, the count is {count}")
    return {"arch": SHARD_TILE_ARCH, "mesh": "16x16", "whole_gb": whole / 1e9,
            "init_s": init_s, "leaves": leaves, "device0_bytes": device0,
            "count_bytes": count, "bit_equal": True,
            "seconds": time.perf_counter() - t0}


def phase_sharding(device):
    """Phase [24]: the model stack's sharding specs held against the
    card's allocator and the card's own tensors, no kernel computed and
    nothing timed: (a) ``allocate_shards`` on 16x16 and 2x16x16, (b)
    ``tile_parameters``, (c) every applicable cell's per-device argument
    and output GB on both meshes (``launch.dryrun.mesh_cell``)."""
    from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
    from repro_torch.launch.dryrun import mesh_cell
    from repro_torch.launch.steps import params_shape
    t0 = time.perf_counter()
    stand_ins = {a: params_shape(get_config(a)) for a in ARCH_NAMES}
    log(f"[24] parameter stand-ins of {len(stand_ins)} archs in "
        f"{time.perf_counter() - t0:.1f} s")
    for mp in (False, True):
        row = allocate_shards(mp, device, stand_ins[SHARD_ALLOC_CELL[0]])
        log(f"[24a] {json.dumps(row)}")
    tiles = tile_parameters(device)
    log(f"[24b] {json.dumps(tiles)}")
    t1 = time.perf_counter()
    cells = {}
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            for mp in (False, True):
                r = mesh_cell(arch, shape, mp, params=stand_ins[arch])
                if "skipped" in r:
                    continue
                cells.setdefault(f"{arch} {shape}", {})[r["mesh"]] = {
                    "argument_gb": r["memory"]["argument_bytes"] / 1e9,
                    "output_gb": r["memory"]["output_bytes"] / 1e9,
                    "fits_80gb": r["arguments_fit_80gb"]}
    log(f"[24c] {json.dumps(cells)}")
    require(sum(len(v) for v in cells.values()) == 64,
            f"[24c] {sum(len(v) for v in cells.values())} counted records")
    log(f"[24c] {time.perf_counter() - t1:.1f} s; [24] "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 25: the dense stack partitioned over a device mesh (DTensor)
# ---------------------------------------------------------------------------

#: [25a]: llama3.2-3b at full width and depth, SHARDED_STEPS mb1_noremat
#: steps of TRAIN_B x TRAIN_S tokens, plain and on a one-rank (1, 1)
#: ``data, model`` NCCL mesh; [25b]: rank 0's share of its train_4k cell
#: on 16x16, in a fake process group of 256 ranks
SHARDED_ARCH, SHARDED_STEPS = "llama3.2-3b", 2
SHARDED_CELL = ("llama3.2-3b", "train_4k")
#: the kernels of the partitioned path, and their device functions' name
#: prefixes in a profiler window
SHARDED_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                   "flash_attention_bwd")
SHARDED_PROFILED = (("flash", ("flash_",)), ("rmsnorm", ("rmsnorm_",)))
#: profiler windows of one step each (after a warm-up step) that [25a]
#: takes a run
SHARDED_WINDOWS = 3


def place_leafwise(tree, specs, mesh):
    """``sharding.distribute`` of a tree of dicts, a leaf at a time, each
    plain leaf dropped once placed (a shard of a one-rank mesh is a copy:
    the whole tree twice would not fit beside the step)."""
    from repro_torch.distributed.sharding import distribute
    for k in list(specs):
        if isinstance(specs[k], dict):
            place_leafwise(tree[k], specs[k], mesh)
        else:
            tree[k] = distribute({k: tree.pop(k)}, {k: specs[k]}, mesh)[k]
    return tree


def profiled_kernels(prof):
    """Launches of the partitioned path's kernels in a profiler window,
    by SHARDED_PROFILED's groups of device function names; ``None`` for a
    window that reports no device time (PERF.md section 7)."""
    out = {name: 0 for name, _ in SHARDED_PROFILED}
    busy = 0.0
    for e in prof.key_averages():
        us = device_us(e)
        busy += us
        if us <= 0:
            continue
        for name, keys in SHARDED_PROFILED:
            if any(k in e.key for k in keys):
                out[name] += e.count
    return out if busy > 0 else None


def sharded_steps(cfg, device, mesh=None, B=TRAIN_B, S=TRAIN_S,
                  windows=SHARDED_WINDOWS, moe_groups=1):
    """SHARDED_STEPS steps of ``cfg`` (mb1, its remat) from seed 0 on
    seeded B x S token batches, plain, or with every parameter, moment
    and batch leaf a DTensor on ``mesh`` placed by the reference's specs,
    the MoE dispatched in ``moe_groups`` groups; then ``windows`` profiler
    windows of a step each, each after a warm-up step.  Returns
    the losses, the MoE's expert_load of each step, the final parameters
    (gathered), the wrappers' launches over the steps, the profiled
    kernels (each group's largest count over the windows, and each
    window's; ``None`` without windows) and the steps' walls."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch import kernels
    from repro_torch.distributed.ctx import activation_sharding
    from repro_torch.distributed.sharding import (batch_specs, gather,
                                                  mesh_axes, opt_specs,
                                                  param_specs)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init, tree_map
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10,
                          moment_dtype=cfg.moment_dtype)
    params = init_params(cfg, 0, device=device)
    opt = adamw_init(params, opt_cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    batches = [{k: torch.randint(0, cfg.vocab_size, (B, S),
                                 generator=gen, device=device,
                                 dtype=torch.int32)
                for k in ("tokens", "labels")}
               for _ in range(SHARDED_STEPS)]
    extra = {k: v.clone() for k, v in batches[-1].items()}
    if mesh is not None:
        am = mesh_axes(mesh)
        pspec = param_specs(cfg, am, params)
        place_leafwise(opt.m, opt_specs(pspec).m, mesh)
        place_leafwise(opt.v, opt_specs(pspec).v, mesh)
        opt = opt._replace(step=place_leafwise(
            {"step": opt.step}, {"step": opt_specs(pspec).step}, mesh)["step"])
        place_leafwise(params, pspec, mesh)
        bspec = batch_specs(cfg, am)
        batches = [place_leafwise(b, dict(bspec), mesh)
                   for b in batches + [extra]]
        extra = batches.pop()
    step = make_train_step(cfg, opt_cfg)
    losses, loads, walls = [], [], []
    kernels.reset_launch_counts()
    with activation_sharding(mesh, moe_groups=moe_groups):
        for b in batches:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, b)
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
            losses.append(float(gather(met["loss"])))
            if "expert_load" in met:
                loads.append(gather(met["expert_load"]).tolist())
        launches = {k: v for k, v in kernels.launch_counts().items()
                    if k in SHARDED_KERNELS}
        final = tree_map(torch.clone, gather(params))
        # SHARDED_WINDOWS windows on the last batch under the profiler, each
        # one step recorded after a warm-up step that runs traced and is
        # dropped (the profiler's own schedule): late in the script a
        # window opened on the step itself lost its first kernels (PERF.md
        # section 7); each group keeps its largest count over the windows
        seen = []
        if windows:
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=windows),
                         on_trace_ready=lambda p: seen.append(
                             profiled_kernels(p))) as prof:
                for _ in range(2 * windows):
                    step(params, opt, extra)
                    torch.cuda.synchronize(device)
                    prof.step()
    kept = [w for w in seen if w is not None]
    profiled = ({k: max(w[k] for w in kept) for k in kept[0]} if kept
                else None)
    del opt, batches, params
    return {"losses": losses, "expert_load": loads, "params": final,
            "launches": launches, "profiled": profiled, "windows": seen,
            "step_s": walls}


def same_leaves(a, b):
    """Every leaf of two parameter trees bit-equal: (equal, the largest
    absolute difference)."""
    from repro_torch.optim import tree_items
    worst = 0.0
    for path, x in tree_items(a):
        y = b
        for k in path:
            y = y[k]
        worst = max(worst, float((x.float() - y.float()).abs().max()))
    return worst == 0.0, worst


def mesh_train_equal(device, records, mesh):
    """[25a]: SHARDED_STEPS steps of SHARDED_ARCH at full width and depth
    (mb1_noremat), plain, then with DTensor leaves on ``mesh``, a
    one-rank (1, 1) ``data, model`` NCCL mesh: the losses and the final
    parameters bit-equal, the wrappers' and the profiler's kernel
    launches equal, and the partitioned path's launches added to the
    kernels' records."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(SHARDED_ARCH), remat=False)
    torch.cuda.empty_cache()
    plain = sharded_steps(cfg, device)
    torch.cuda.empty_cache()
    sharded = sharded_steps(cfg, device, mesh)
    equal, worst = same_leaves(sharded.pop("params"), plain.pop("params"))
    torch.cuda.empty_cache()
    row = {"arch": SHARDED_ARCH, "layers": cfg.n_layers,
           "tokens": [TRAIN_B, TRAIN_S], "plain": plain, "mesh": sharded,
           "losses_equal": plain["losses"] == sharded["losses"],
           "params_bit_equal": equal, "params_max_abs_diff": worst}
    log(f"[25a] {json.dumps(row)}")
    require(row["losses_equal"] and equal,
            f"[25a] the (1, 1) mesh's steps differ from the plain ones: "
            f"losses {plain['losses']} / {sharded['losses']}, parameters "
            f"{worst}")
    require(plain["launches"] == sharded["launches"]
            and all(sharded["launches"].values()),
            f"[25a] launches {plain['launches']} / {sharded['launches']}")
    require(plain["profiled"] is not None
            and plain["profiled"] == sharded["profiled"]
            and all(sharded["profiled"].values()),
            f"[25a] profiled kernels {plain['profiled']} / "
            f"{sharded['profiled']}")
    add_launches(records, {"train sharded (1, 1) [25a]":
                           sharded["launches"]}, SHARDED_KERNELS)
    return row


#: [25c]: olmoe-1b-7b at full width cut to [21c]'s MOE_TRAIN_LAYERS,
#: SHARDED_STEPS mb1_noremat steps of SSM_TRAIN_B x SSM_TRAIN_S tokens at
#: [21c]'s dispatch groups (one), plain and on the (1, 1) mesh
MESH_MOE_ARCH, MESH_MOE_GROUPS = "olmoe-1b-7b", 1


def mesh_moe_equal(device, records, mesh):
    """[25c]: the MoE family's steps plain and on ``mesh`` (one rank):
    losses, the final parameters and every step's expert_load bit-equal,
    the wrappers' launches equal and added to the kernels' records."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(MESH_MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS, remat=False)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        torch.cuda.empty_cache()
        runs[name] = sharded_steps(cfg, device, m, B=SSM_TRAIN_B,
                                   S=SSM_TRAIN_S, windows=0,
                                   moe_groups=MESH_MOE_GROUPS)
    plain, sharded = runs["plain"], runs["mesh"]
    equal, worst = same_leaves(sharded.pop("params"), plain.pop("params"))
    torch.cuda.empty_cache()
    row = {"arch": MESH_MOE_ARCH, "layers": cfg.n_layers,
           "tokens": [SSM_TRAIN_B, SSM_TRAIN_S],
           "moe_groups": MESH_MOE_GROUPS, "plain": plain, "mesh": sharded,
           "losses_equal": plain["losses"] == sharded["losses"],
           "expert_load_equal": plain["expert_load"] == sharded[
               "expert_load"],
           "params_bit_equal": equal, "params_max_abs_diff": worst}
    log(f"[25c] {json.dumps(row)}")
    require(row["losses_equal"] and equal and row["expert_load_equal"]
            and plain["expert_load"],
            f"[25c] the (1, 1) mesh's MoE steps differ from the plain ones: "
            f"losses {plain['losses']} / {sharded['losses']}, parameters "
            f"{worst}, expert_load equal {row['expert_load_equal']}")
    require(plain["launches"] == sharded["launches"]
            and all(sharded["launches"].values()),
            f"[25c] launches {plain['launches']} / {sharded['launches']}")
    add_launches(records, {"MoE train sharded (1, 1) [25c]":
                           sharded["launches"]}, SHARDED_KERNELS)
    return row


#: [25d]: qwen2-vl-72b at full width cut to 2 of its 80 layers (the
#: embedding and head alone are 5 GB), a FAMILY_BATCH x FAMILY_PROMPT
#: prefill, plain and on the (1, 1) mesh
MESH_VL_ARCH, MESH_VL_LAYERS = "qwen2-vl-72b", 2


def vl_prefill(cfg, device, mesh=None):
    """The prefill (logits, k cache) and the forward's hidden states of
    ``cfg`` from seed 0 on seeded prompts, plain or with every leaf a
    DTensor on ``mesh``; the wrappers' launches of the prefill and its
    wall."""
    from repro_torch import kernels
    from repro_torch.distributed.ctx import activation_sharding
    from repro_torch.distributed.sharding import (batch_specs, gather,
                                                  mesh_axes, param_specs)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.models.model import forward
    params = init_params(cfg, 0, device=device)
    batch = {"tokens": prompt_tokens(cfg, device)}
    if mesh is not None:
        am = mesh_axes(mesh)
        place_leafwise(params, param_specs(cfg, am, params), mesh)
        place_leafwise(batch, {"tokens": batch_specs(cfg, am)["tokens"]},
                       mesh)
    kernels.reset_launch_counts()
    with activation_sharding(mesh), torch.no_grad():
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(cfg)(params, batch)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launch_counts().items()
                    if k in SHARDED_KERNELS and v}
        hidden = forward(cfg, params, batch["tokens"])[0]
        out = {"logits": gather(logits), "k": gather(cache["k"]),
               "hidden": gather(hidden)}
    del params, batch, logits, cache, hidden
    return out, {"launches": launches, "prefill_s": wall}


def mesh_vl_prefill(device, records, mesh):
    """[25d]: the VL backbone's prefill (M-RoPE) plain and on ``mesh``
    (one rank): logits, k cache and hidden states bit-equal, launches
    equal and added to the kernels' records."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(MESH_VL_ARCH),
                              n_layers=MESH_VL_LAYERS)
    torch.cuda.empty_cache()
    plain, p_row = vl_prefill(cfg, device)
    torch.cuda.empty_cache()
    sharded, m_row = vl_prefill(cfg, device, mesh)
    same = {k: torch.equal(plain[k], sharded[k]) for k in plain}
    del plain, sharded
    torch.cuda.empty_cache()
    row = {"arch": MESH_VL_ARCH, "layers": MESH_VL_LAYERS,
           "of_layers": get_config(MESH_VL_ARCH).n_layers,
           "tokens": [FAMILY_BATCH, FAMILY_PROMPT], "plain": p_row,
           "mesh": m_row, "bit_equal": same}
    log(f"[25d] {json.dumps(row)}")
    require(all(same.values()), f"[25d] the (1, 1) mesh's VL prefill "
            f"differs from the plain one: {same}")
    require(p_row["launches"] == m_row["launches"]
            and len(m_row["launches"]) == 2,
            f"[25d] launches {p_row['launches']} / {m_row['launches']}")
    add_launches(records, {"VL prefill sharded (1, 1) [25d]":
                           {k: m_row["launches"].get(k, 0)
                            for k in SHARDED_KERNELS}}, SHARDED_KERNELS)
    return row


@contextlib.contextmanager
def one_rank_mesh(device):
    """A one-rank NCCL process group and its (1, 1) ``data, model``
    mesh, destroyed when the context closes."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import AbstractMesh, device_mesh
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=device)
    try:
        yield device_mesh(AbstractMesh(("data", "model"), (1, 1)))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_maker(cfg, device):
    """``sharding.from_shards``' ``make`` for rank 0's share on the card:
    token ids below the vocabulary, small normals in each float leaf's
    dtype, zeros for the step count; one generator, seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)

    def make(leaf, shape):
        if leaf.dtype in (torch.int32, torch.int64):
            if not shape:
                return torch.zeros((), dtype=leaf.dtype, device=device)
            return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 dtype=leaf.dtype, device=device)
        x = torch.randn(shape, generator=gen, device=device) * 0.02
        return x.abs().to(leaf.dtype)

    return make


def share_steps(cfg, shape, device, moe_groups=1):
    """Rank 0's share of ``cfg``'s partitioned step at ``shape`` on 16x16
    on the card: a fake process group of 256 ranks (its collectives move
    nothing), a mesh of the card's device type, each parameter, moment
    and batch leaf a DTensor whose local shard is made on the card
    (``sharding.from_shards``, ``shard_maker``), laid out by the
    reference's specs; SHARDED_STEPS steps, each timed, the MoE
    dispatched in ``moe_groups`` groups.  Returns their walls."""
    from repro_torch.distributed.ctx import activation_sharding
    from repro_torch.distributed.sharding import (batch_specs, from_shards,
                                                  opt_specs, param_specs)
    from repro_torch.launch.mesh import (device_mesh, fake_world,
                                         production_mesh)
    from repro_torch.launch.steps import (input_specs, make_train_step,
                                          params_shape)
    from repro_torch.optim import AdamWConfig, adamw_init
    am = production_mesh()
    make = shard_maker(cfg, device)
    walls = []
    with fake_world(am.size):
        dm = device_mesh(am)
        params = params_shape(cfg)
        pspec = param_specs(cfg, am, params)
        opt_cfg = AdamWConfig(moment_dtype=cfg.moment_dtype)
        opt = from_shards(adamw_init(params, opt_cfg), opt_specs(pspec), dm,
                          make)
        params = from_shards(params, pspec, dm, make)
        inputs = input_specs(cfg, shape)
        bspec = batch_specs(cfg, am)
        batch = from_shards(inputs, {k: bspec[k] for k in inputs}, dm, make)
        step = make_train_step(cfg, opt_cfg)
        with activation_sharding(dm, moe_groups=moe_groups):
            for _ in range(SHARDED_STEPS):
                t0 = time.perf_counter()
                params, opt, _ = step(params, opt, batch)
                torch.cuda.synchronize(device)
                walls.append(time.perf_counter() - t0)
        del params, opt, batch
    return walls


#: [25e]: rank 0's share of olmoe-1b-7b's train_4k cell on 16x16 at its
#: plan's 16 groups (one a data rank)
MOE_SHARE_CELL = ("olmoe-1b-7b", "train_4k")


def mesh_share(device, cell=SHARDED_CELL, tag="[25b]"):
    """[25b] / [25e]: rank 0's share of ``cell`` on 16x16 on the card,
    real tensors in a fake process group of 256 ranks (its collectives
    move nothing: the values are not checked), two steps
    (``share_steps``) at the cell's plan's MoE groups; its peak
    allocated bytes held against the count of the same cell
    (``launch.dryrun.counted_mesh_cell``) as [23] holds its counts: the
    count within DRY_RUN_PEAK_SHARE of the card's, or for a MoE cell,
    whose count fills every slot of the dispatch (its upper bound), the
    card's within DRY_RUN_PEAK_SHARE of the count's."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import counted_mesh_cell
    arch, shape = cell
    t0 = time.perf_counter()
    rec = counted_mesh_cell(arch, shape, False)
    count_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    cfg = get_config(arch)
    walls = share_steps(cfg, SHAPES[shape], device, rec["moe_groups"])
    peak = torch.cuda.max_memory_allocated(device) - resident
    torch.cuda.empty_cache()
    mem = rec["memory"]
    row = {"cell": f"{arch} {shape}", "mesh": rec["mesh"],
           "moe_groups": rec["moe_groups"],
           "step_s": walls, "card": nvidia_smi_line(),
           "card_peak_gb": peak / 1e9,
           "counted_peak_gb": mem["peak_bytes"] / 1e9,
           "counted_argument_gb": mem["argument_bytes"] / 1e9,
           "counted_temp_gb": mem["temp_bytes"] / 1e9,
           "peak_gap_gb": (peak - mem["peak_bytes"]) / 1e9,
           "flops_per_device": rec["flops_per_device"],
           "collective_wire_gb": {k: v / 1e9 for k, v in
                                  rec["collective_wire_bytes_per_device"]
                                  .items() if v},
           "kernels_counted": {k: v["launches"]
                               for k, v in rec["kernels"].items()},
           "count_s": count_s}
    log(f"{tag} {json.dumps(row)}")
    if cfg.family == "moe":
        require(peak <= DRY_RUN_PEAK_SHARE * mem["peak_bytes"],
                f"{tag} the card's peak {peak} above the count's "
                f"{mem['peak_bytes']}")
    else:
        require(mem["peak_bytes"] <= DRY_RUN_PEAK_SHARE * peak,
                f"{tag} counted peak {mem['peak_bytes']} above the card's "
                f"{peak}")
    return row


def phase_mesh(device, records):
    """Phase [25]: the dense stack, the MoE family and the VL backbone
    run partitioned on DTensor: (a) ``mesh_train_equal``, (b)
    ``mesh_share`` of SHARDED_CELL, (c) ``mesh_moe_equal``, (d)
    ``mesh_vl_prefill``, (e) ``mesh_share`` of MOE_SHARE_CELL."""
    t0 = time.perf_counter()
    with one_rank_mesh(device) as mesh:
        mesh_train_equal(device, records, mesh)
    log(f"[25a] {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    mesh_share(device)
    log(f"[25b] {time.perf_counter() - t1:.1f} s")
    with one_rank_mesh(device) as mesh:
        t1 = time.perf_counter()
        mesh_moe_equal(device, records, mesh)
        log(f"[25c] {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        mesh_vl_prefill(device, records, mesh)
        log(f"[25d] {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    mesh_share(device, MOE_SHARE_CELL, "[25e]")
    log(f"[25e] {time.perf_counter() - t1:.1f} s")
    log(f"[25] {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def longest_lane(args, shared: int):
    """The call's arguments cut to its longest lane alone; the first
    ``shared`` arguments are not per lane."""
    j = int(args[-1].argmax())
    return list(args[:shared]) + [a[j:j + 1].contiguous()
                                   for a in args[shared:]]


def kernel_record(name, launches, args, shared, fn, ref, bound_fn, device,
                  flush, reps, plain_reps):
    """Time one kernel and its plain version on one call's arguments; the
    kernel on the call's longest lane alone: one warp walking that lane's
    chain of dependent steps, which no call can finish sooner; and the
    kernel on the call with every count 0 (the wrapper, the launch and the
    write-back of jitter): the floor under any design of the steps."""
    err = float((fn(*args) - ref(*args)).abs().max())
    ms = time_call(fn, args, reps, device, flush)
    plain_ms = time_call(ref, args, plain_reps, device, flush)
    lane = longest_lane(args, shared)
    chain_ms = time_call(fn, lane, reps, device, flush)
    chain_steps = int(lane[-1].sum())
    floor_ms = time_call(fn, list(args[:-1]) + [torch.zeros_like(args[-1])],
                         reps, device, flush)
    nbytes, ops = bound_fn(args)
    b_ms, b_by = bound_ms(nbytes, ops)
    P = int(args[-6].shape[1])
    return {"name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "layout": f"warp/{-(-P // 32)}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"B": int(args[-1].shape[0]),
                      "K": int(args[-2].shape[1]),
                      "P": P,
                      "live_chunks": int(args[-1].long().sum())},
            "bytes": nbytes, "ops": ops, "chain_steps": chain_steps,
            "chain_ms": chain_ms,
            "chain_step_us": chain_ms * 1e3 / max(chain_steps, 1),
            "floor_ms": floor_ms}


SCAN_LANES = (132, 528, 1056, 2112, 4096)


def lane_scan(fn, args, shared: int, device, flush, reps: int = 20):
    """The call cut to its first n lanes, for n in ``SCAN_LANES`` (132 =
    one a SM): ms of each cut.  Flat in n: the longest lane's chain holds
    the call; growing with n: the card's issue slots do."""
    B = int(args[-1].shape[0])
    out = []
    for n in SCAN_LANES:
        if n > B:
            break
        cut = list(args[:shared]) + [a[:n].contiguous() for a in
                                      args[shared:]]
        out.append({"lanes": n, "ms": time_call(fn, cut, reps, device, flush),
                     "chain_steps": int(cut[-1].max()),
                     "live_chunks": int(cut[-1].long().sum())})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc" / "event_loop.cu"
            ).is_file():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        return run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


def run() -> int:
    from repro_torch import TorchBatchedBackend, kernels
    from repro_torch.kernels import build
    from repro_torch.kernels import event_loop as ev
    from repro_torch.sim import get_application

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[1] {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {kind} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[2] built {json.dumps(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc a source, in parallel)")

    log("[3] kernels vs plain versions, synthetic inputs")
    grids_np = get_application("mandelbrot").profile_stack(500).grids()
    res = phase_synthetic(device, grids_np, N=262_144)
    bad = sum(r[3] + r[4] for r in res)
    log(f"[3] mismatches: {bad}")
    require(bad == 0, f"kernels disagree with their plain versions: {res}")

    log("[4] campaign path: sweep_portfolio on the kernels")
    bk = TorchBatchedBackend()
    bk.core_calls = []
    kernels.reset_launch_counts()
    sw_m, wall_m = sweep("mandelbrot", bk, T=500, reps=3)
    times_m = dict(vars(bk.times))
    bk.times.reset()
    sw_t, wall_t = sweep("tc", bk, reps=3)
    campaign_launches = kernels.launch_counts()
    fused_calls = [a for n, a in bk.core_calls if n == "event_finish_fused"]
    bk.core_calls = None
    log(f"[4] launches {json.dumps(campaign_launches)}")
    require(campaign_launches["event_finish_fused"] > 0,
            "the campaign path never launched event_finish_fused")
    check_sweep(sw_m, 500, 3)
    check_sweep(sw_t, 500, 1)
    log(json.dumps({"sweep": "mandelbrot/epyc", "T": 500, "reps": 3,
                    "wall_s": wall_m, "oracle_total": sw_m.oracle_total(),
                    "cov": sw_m.cov(), "path_times": times_m}))
    log(json.dumps({"sweep": "tc/epyc", "T": 500, "reps": 3,
                    "wall_s": wall_t, "oracle_total": sw_t.oracle_total(),
                    "cov": sw_t.cov(), "path_times": dict(vars(bk.times))}))

    pk = TorchBatchedBackend(event_core="plain")
    sw_mp, wall_mp = sweep("mandelbrot", pk, T=500, reps=3)
    sw_tp, wall_tp = sweep("tc", pk, reps=3)
    log(f"[4] plain event core on the card: mandelbrot {wall_mp:.1f} s, "
        f"tc {wall_tp:.1f} s")
    require(same_sweeps([sw_m, sw_t], [sw_mp, sw_tp]),
            "campaign results differ between the kernels and the plain "
            "versions on the card")
    require(sw_m.oracle_total() == sw_mp.oracle_total()
            and sw_t.oracle_total() == sw_tp.oracle_total(), "oracle totals")
    small_card = small_sweeps(bk)
    small_cpu = small_sweeps(TorchBatchedBackend(device="cpu"))
    require(same_sweeps(small_card, small_cpu, lib_atol=1e-4),
            "the T = 2 sweeps differ between the card and the CPU")
    lib_diff = max(float(np.abs(x.runs[k].libs - y.runs[k].libs).max())
                   for x, y in zip(small_card, small_cpu) for k in x.runs)
    log(f"[4] kernels == plain on the card; card == CPU on the T = 2 "
        f"sweeps (lib largest difference {lib_diff})")

    log("[5] what-if path")
    kernels.reset_launch_counts()
    bk.core_calls = []
    w_card = what_if_calls(bk)
    whatif_launches = kernels.launch_counts()
    wave_calls = [a for n, a in bk.core_calls if n == "event_finish"]
    bk.core_calls = None
    log(f"[5] launches {json.dumps(whatif_launches)}, rows per call "
        f"{[int(a[0].shape[0]) for a in wave_calls]}")
    require(whatif_launches["event_finish"] > 0,
            "the what-if path never launched event_finish")
    w_plain = what_if_calls(TorchBatchedBackend(event_core="plain"))
    w_cpu = what_if_calls(TorchBatchedBackend(device="cpu"))
    for name, other in (("plain on the card", w_plain), ("the CPU", w_cpu)):
        require(all(np.array_equal(a, b) for a, b in zip(w_card, other)),
                f"what-if prices differ between the kernels and {name}")
        require(all(np.all(np.isfinite(a)) for a in w_card), "what-if nan")
    log("[5] kernels == plain on the card == CPU")
    for row in what_if_latency(bk, device):
        log(f"[5] latency {json.dumps(row)}")

    log("[6] timing at the main path's shapes")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    big_f = max(fused_calls, key=lambda a: int(a[-1].long().sum()))
    big_w = max(wave_calls, key=lambda a: int(a[-1].long().sum()))
    records = [
        kernel_record("event_finish", whatif_launches["event_finish"],
                      big_w, 0, ev.event_finish, ev.event_finish_ref,
                      plain_bound, device, flush, reps=50, plain_reps=5),
        kernel_record("event_finish_fused",
                      campaign_launches["event_finish_fused"], big_f, 1,
                      ev.event_finish_fused, ev.event_finish_fused_ref,
                      fused_bound, device, flush, reps=20, plain_reps=2),
    ]
    for k in records:
        require(k["max_abs_err"] == 0.0, f"{k['name']} disagrees at the "
                f"main path's shapes: {k['max_abs_err']}")
        log(f"[6] {k['name']} ({k['layout']}): {k['ms']:.4f} ms, chain "
            f"{k['chain_ms']:.4f} ms over {k['chain_steps']} steps "
            f"({k['chain_step_us']:.4f} us a step), no chunks "
            f"{k['floor_ms']:.4f} ms, bound "
            f"{k['bound_ms']:.3g} ms, plain {k['plain_ms']:.2f} ms")
    scan = lane_scan(ev.event_finish_fused, big_f, 1, device, flush)
    records[1]["lane_scan"] = scan
    log(f"[6] event_finish_fused lane scan {json.dumps(scan)}")
    log(f"[6] {time.perf_counter() - t_start:.1f} s so far")

    log("[7] model kernels vs plain versions, synthetic inputs")
    rows = phase_model_kernels(device)
    for name in MODEL_TOL:
        worst = max((r for r in rows if r[0] == name), key=lambda r: r[2])
        log(f"[7] {name}: {sum(r[0] == name for r in rows)} cases, worst "
            f"error / tolerance {worst[2]} at {worst[1]}")
    bad = [r for r in rows if not r[2] <= 1.0]
    require(not bad, f"model kernels outside tolerance: {bad}")

    log("[8] Zamba2-7B, full width, bf16, on the kernels")
    zamba = phase_zamba(device)
    log(json.dumps({"zamba2-7b": zamba}))

    log("[10] small Zamba2, float32: the card against the CPU")
    worst = phase_small_card_vs_cpu(device)
    log(f"[10] largest difference / largest magnitude: {worst}")
    require(worst <= 1e-4, f"card vs CPU {worst} > 1e-4")

    log("[11] model kernels timed at the main path's largest calls")
    model_records = model_kernel_records(device, flush, zamba["launches"])
    rms = model_records[0]
    for r in [rms] + rms["at_decode_call"]:
        require(r["tol_ratio"] <= 1.0 and r["rerun_bit_equal"],
                f"rmsnorm at {r['shape']}: tol_ratio {r['tol_ratio']}, "
                f"rerun bit-equal {r['rerun_bit_equal']}")
    for r in rms["at_decode_call"]:
        log(f"[11] rmsnorm at decode's call {json.dumps(r)}")
    for k in model_records:
        require(k["tol_ratio"] <= 1.0, f"{k['name']} outside tolerance "
                f"at the main path's shapes: {k['tol_ratio']}")
        log(f"[11] {k['name']}: {k['ms']:.4f} ms, {k['tflops']:.1f} "
            f"TFLOP/s (bound {k['bound_ms']:.4f} ms, {k['bound_by']}; "
            f"plain {k['plain_ms']:.4f} ms; library {k['library_ms']})"
            + (f"; kernels {json.dumps(k['parts_ms'])}"
               if "parts_ms" in k else ""))
    log(f"[11] {time.perf_counter() - t_start:.1f} s so far")

    log(f"[12] selection-policy layer: run_campaign mandelbrot/epyc, "
        f"T = {REPLAY_T}, "
        "SIM_SELECTOR_GRID, both chunk modes, on the kernels")
    replay, replay_calls, clean_totals = replay_campaign(device)
    log(json.dumps(replay))
    fused = records[1]
    fused["launches_by_path"] = {"sweep [4]": fused["launches"],
                                 **{f"{k} [12]": len(c)
                                    for k, c in replay_calls.items()}}
    fused["launches"] = sum(fused["launches_by_path"].values())
    fused["largest_B_by_path"] = {
        "sweep [4]": fused["shape"]["B"],
        **{f"{k} [12]": b for k, b in replay["fused_largest_B"].items()}}
    big_r = max(replay_calls["replay"],
                key=lambda a: int(a[-1].long().sum()))
    at_replay = kernel_record(
        "event_finish_fused", len(replay_calls["replay"]), big_r, 1,
        ev.event_finish_fused, ev.event_finish_fused_ref, fused_bound,
        device, flush, reps=50, plain_reps=5)
    require(at_replay["max_abs_err"] == 0.0, "event_finish_fused disagrees "
            "at the replay's largest call")
    fused["at_replay_call"] = {k: at_replay[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "shape", "chain_steps",
        "chain_ms", "floor_ms")}
    log(f"[12] event_finish_fused at the replay's largest call "
        f"{json.dumps(fused['at_replay_call'])}")
    log(f"[12] replay steps 8-15 (4 timed, 4 traced): "
        f"{json.dumps(profile_replay(device))}")
    checks = replay_checks(device)
    log(f"[12] bit-equal, with Learned and LearnedHybrid lanes: "
        f"{json.dumps(checks)}")
    so = simpolicy_oracle(TorchBatchedBackend())
    log(f"[12] SimPolicy vs Oracle, tc/epyc noise-free: {json.dumps(so)}")
    require(so["sim"] == so["oracle"] + ["exploit"],
            f"SimPolicy's decision is not the Oracle's: {so}")
    log(f"[12] {time.perf_counter() - t_start:.1f} s so far")

    log("[13] perturbed and heterogeneous machines on the kernels")
    phase_perturbed(device, flush, records, clean_totals)
    log(f"[13] {time.perf_counter() - t_start:.1f} s so far")

    log("[14] the serving dispatcher and the fleet on the kernels")
    phase_serving(device, flush, records, zamba["per_token_s"])
    log(f"[14] {time.perf_counter() - t_start:.1f} s so far")

    log("[15] async dispatch and the lane split on the kernels")
    phase_async(device, records)
    log(f"[15] {time.perf_counter() - t_start:.1f} s so far")

    log("[16] learned-selection training on the card")
    phase_training(device, records)
    log(f"[16] {time.perf_counter() - t_start:.1f} s so far")

    # the earlier paths' recorded calls hold card memory that [17e]'s
    # peaks would count
    del fused_calls, wave_calls, big_f, big_w, replay_calls, big_r, bk, pk
    torch.cuda.empty_cache()
    log("[17] dense-family training: llama3.2-3b through the autotuner")
    bwd_records = phase_dense_training(device, flush, model_records)
    log(f"[17] {time.perf_counter() - t_start:.1f} s so far")
    log("[18] the dense, VL and MoE families' serving at full width")
    phase_families(device, flush, model_records)
    log(f"[18] {time.perf_counter() - t_start:.1f} s so far")
    log("[19] the SSM and enc-dec families' serving at full width")
    phase_ssm_encdec(device, flush, model_records)
    log(f"[19] {time.perf_counter() - t_start:.1f} s so far")
    log("[20] the SSM and hybrid families' training at full width")
    bwd_records.append(phase_ssm_training(device, flush, model_records,
                                          bwd_records))
    log(f"[20] {time.perf_counter() - t_start:.1f} s so far")
    log(f"[21] the MoE family's training: olmoe-1b-7b at full width, "
        f"{MOE_TRAIN_LAYERS} of 16 layers")
    phase_moe_training(device, flush, model_records, bwd_records)
    log(f"[21] {time.perf_counter() - t_start:.1f} s so far")
    log("[22] the enc-dec family's training: whisper-small at full width "
        "and depth")
    phase_encdec_training(device, flush, model_records, bwd_records)
    log(f"[22] {time.perf_counter() - t_start:.1f} s so far")
    log("[23] the dry run's count of each measured step, on the meta "
        "device, against the card")
    phase_dry_run()
    log(f"[23] {time.perf_counter() - t_start:.1f} s so far")
    log("[24] the sharding specs of the 16x16 and 2x16x16 layouts against "
        "the card's allocator and tensors")
    phase_sharding(device)
    log(f"[24] {time.perf_counter() - t_start:.1f} s so far")
    log("[25] the dense stack, the MoE family and the VL backbone "
        "partitioned over a device mesh: a (1, 1) mesh against the plain "
        "steps and prefill, rank 0's shares of 16x16")
    phase_mesh(device, model_records + bwd_records)
    log(f"[25] total {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi_line())
    print(json.dumps({"kernels": records + model_records + bwd_records}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
