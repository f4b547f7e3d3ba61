#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout with one card: ``python3 chip_smoke.py``.

1. Setup: build the CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, in parallel), print versions and the card.
2. Every kernel against its plain PyTorch version on the card, on the same
   inputs.  The TAP kernels: digits and every per-block counter row equal
   (tolerance: none, integer results must match exactly, max_abs_err 0),
   over the program matrix below and the programs of a small K-tiled MAC;
   the schedule kernel's unrolled and general slot bodies at 2^20 rows.
   The packed-ternary matmul, both kernels (M >= 16 on the tensor cores,
   fp32 as three bf16 passes, fewer rows on the CUDA cores; each call must
   launch the one ``kernel_for`` names and not the other): fp32 within
   1e-4 and bf16 within 5e-2 (allclose, atol = rtol), on the reference's
   test shapes and odd ones, exact on integer activations, and
   bit-identical to the plain version on integer activations in both
   dtypes on the tensor cores, integers up to 2^19 among them; and both
   kernels, routed or not, at qwen2-72b's w1 (K = 8192, N = 29568, M = 1
   and 16), in both dtypes within the same tolerances and bit-identical on
   integer activations.  The decode-attention kernel against its plain
   version (fp32, valid slots only, no repeated kv heads) in bf16 at
   qwen2-72b's heads (64 on 8, head 128), at the shapes phases 3d and 3h
   give it (qwen3-0.6b's 16 heads on 8, head 128, at their batches and
   cache length), and odd shapes (a single
   sequence, so the slots split; head 96 and 256; every head its own kv
   head), at the cache's first, middle and last positions: within one bf16
   ulp, taken at no less than 1/256 of each head's largest output.
3. The main paths at full size, each with every kernel's launch count set
   to 0 just before it and read just after; each fails if a kernel of the
   path was not launched.
   a. AP arithmetic: ``compile_named("add", 3, 20)`` + ``run`` at 2^20 rows
      against numpy, ``multiply`` and ``ripple_sub`` through
      ``engine="apc"`` against numpy, ``APStats`` of ``engine="apc"`` equal
      to ``engine="replay"``, ``tap_apply_lut`` / ``tap_ripple_add``, and
      Table XI (all six width pairs, each against ``engine="replay"`` on
      the same digits, digits and ``APStats`` equal) priced by the energy
      model.
   b. The packed-ternary matmul at qwen3-0.6b's MLP width (d_model 1024,
      d_ff 3072): seeded weights packed by ``models.quant``, the SwiGLU MLP
      through ``ternary_matmul(impl="pallas")`` at 1 to 2048 tokens in fp32
      and bf16 against the same composition through
      ``quant.unpack_matmul``; then ``impl="ap"`` with ``k_tile=64`` on
      integer activations at 4 tokens, bit-identical to ``impl="ref"``,
      its cycles equal to ``ap_matmul_cycle_counts``, with its wall time
      and Table XI energy.
   c. The array pool and the graph runtime: ``compile_named("add", 3,
      20)`` at 2^20 rows through ``apc.run(pool=ArrayPool(4, 4096, 256))``
      (256 blocks, 64 waves) in one program-kernel launch, digits and
      ``APStats`` equal to ``apc.run`` without a pool, its 256 counter rows
      equal to ``execute``'s, timed beside it, its ``pool_power`` timeline
      equal to the Table XI energy of its ``APStats``; ``DevicePool`` over
      ``[cuda:0]`` and ``[cuda:0, cuda:0]`` (the counter sum across shards)
      on the same input; the AP matmul at qwen3-0.6b's ``w1`` through
      ``pool=ArrayPool(4, 4096, 650)`` and ``runtime=Runtime(...)``,
      bit-identical to ``impl="ref"``, its cycles ``ap_matmul_cycle_counts
      (k_tile=64)``'s and its ``APStats`` the ``k_tile=64`` route's, with
      the runtime's makespan report and the three routes' wall times; two
      MAC graphs of 5000 and 3000 rows coalesced into ``block_valid``
      launches, each slice's digits and counter rows equal to its graph
      run alone; and add 3x20 at 65536 rows on a faulty bank (flips and a
      dead array), recovered to the fault-free digits, with ``APStats``,
      fault snapshot and ``faults.*`` counters equal on the card and on
      the CPU.  The program kernel's ``block_valid`` launches are also
      held against its plain version in step 2, on random schedules and
      the add, valid counts from 1 to the block's rows.
   d. qwen3-0.6b at its published width through ``repro_torch.models``
      (28 layers, d_model 1024, 16 heads / 8 KV of 128, d_ff 3072, vocab
      151936, tied embeddings, qk-norm): seeded weights (``init_params``),
      MLPs packed by ``quantize_model_params``, ``cast_params`` for fp32
      and bf16 compute.  Prefill: ``forward`` on 2 x 1024 seeded tokens
      (M = 2048, blockwise attention), exactly 84 ``ternary_matmul_tc``
      launches and no ``ternary_matmul``, logits against the plain route
      (``models.mlp.plain_packed_mlp()``) within MODEL_TOL, and a zeroed
      ``w2_scale`` must fail that check (layer 0; layer 14 too in fp32).
      Serving (``launch/serve.py``'s recipe): batch 4, 16-token prompts
      one token a step through ``decode_step``, 32 greedy tokens, a
      128-token cache (fp32 under fp32 compute, else bf16);
      exactly 84 ``ternary_matmul`` launches and no ``ternary_matmul_tc``
      a step; the plain route teacher-forced with the kernel route's
      tokens, logits within MODEL_TOL at every step; in fp32, ``forward``
      on the 4 x 48 sequence against every step's logits within
      DECODE_FWD_TOL.  Prefill tokens/s (CUDA events) and decode ms per
      step (host clock, median; and the device's time alone, a CUDA graph
      of one step) of the kernel route, the plain route and the dense
      model (the same weights unpacked, ``torch.matmul`` in the MLPs);
      after phase 4, the share of a decode step that its 84 matmul
      kernels take.
   e. AP-backed serving (``repro_torch.serve``): the same qwen3-0.6b in
      fp32 at all 28 layers, every MLP projection on the AP through
      ``APServeContext(Runtime(ArrayPool(4, 4096, 650)), x_levels=7)``
      (one program-kernel launch per graph node).  ``Engine.generate`` of
      two requests (2-token prompts, 2 new tokens): every step's logits
      bit-identical to the same engine under ``plain_ap_projections()``,
      56 graphs a model step, one launch per graph node, no packed-matmul
      launch; the ``BatchServer`` on the same requests, tokens and
      ``APStats`` equal to the sequential run; waves of 1 and 4 one-token
      requests; a plain replay of a solo reduction launch and a merged
      (``block_valid``) tile launch; qwen3-moe's smoke config at the CPU
      tests' widths through ``ap_moe_dispatch`` on the card against the
      CPU; the engine's float route at ``launch/serve.py``'s defaults
      against a ``decode_step`` loop (84 ``ternary_matmul`` a step).  Host
      ms, program-kernel ms (CUDA events around each launch), ``APLinear``
      build ms, launches, cycles, Table XI energy and makespan per step.
   f. Training (``repro_torch.train``), qwen3-0.6b at its published width,
      fp32 master weights; no kernel lies on this path (launches 0).
      ``launch.train.main`` at its defaults (batch 8 x 128, lr 3e-4, bf16
      compute, remat "dots") for 10 steps at all 28 layers: every loss
      finite, ms per step (host clock, median of steps 3-10), tokens/s,
      peak memory and the model-FLOPs share of the bf16 peak; 10 steps on
      one batch, whose loss must fall; one step at each remat policy (ms,
      peak memory, a profile of "none" and "dots").  At 2 layers: one step
      on the card against the CPU (fp32, TF32 off; loss and grad_norm
      within 1e-5 relative, every grad leaf within 1e-4 of its max|g|,
      AdamW on identical grads within 1e-6; with QAT too), and resume
      (4 straight steps against 2, a checkpoint, a fresh ``train_loop``
      and 2 more) bit for bit under deterministic algorithms.  At 28
      layers, fp32: the TernGrad step on ``[cuda:0]`` and ``[cuda:0,
      cuda:0]``, its loss against the uncompressed loss within 1e-5 and
      the replicas bit-identical.
   g. The named mesh (``repro_torch.launch.mesh``, ``models.sharded``):
      a 1-rank NCCL group (a ``FileStore`` in a temporary directory) and a
      (data=1, model=1) ``DeviceMesh`` on the card.  qwen3-0.6b at full
      width and depth (phase 3f's batch 8 x 128, seed and remat "dots"):
      3 sharded (DTensor) steps against 3 plain ones, losses within 1e-6
      and grad_norm within 1e-5 relative, host ms of both and the device
      time of one step of each under ``torch.profiler``;
      ``FlopCounterMode``'s FLOPs of a step against 6·N·D and the
      model-FLOPs share of 989 TFLOP/s; the dry-run's prediction for the
      same cell at 1 rank (``launch.dryrun.run_cell``, a subprocess on the
      fake backend): its FLOPs equal to the count on the card's tensors
      (a consistency check: both sides apply ``torch.utils.flop_counter``'s
      formulas to the same program, so it shows that the meta-tensor run
      is that program; the per-rank counts rest on the hand count and the
      multi-rank cases of ``tests/test_torch_partition.py``), and its peak
      bytes against ``max_memory_allocated``; one MoE layer of
      qwen3-moe-30b-a3b at full width (fp32, 2 x 512 tokens) through
      ``moe_ffn(mesh=...)`` bit-identical to no mesh (EP is not taken at
      model = 1).  No kernel lies on this path.  The group is torn down at
      the end.
   h. Serving on the named mesh (``Engine(mesh=)``, ``BatchServer``) and
      the port's examples.  qwen3-0.6b at full width and depth, packed
      MLPs, bf16 compute, on a (data=1, model=1) mesh of a 1-rank NCCL
      group as in 3g: ``Engine(mesh=)`` at ``launch/serve.py``'s defaults
      (batch 4, 16-token prompts, 32 greedy tokens, a 128-token cache:
      the CUDA-core kernel at M = 4) and at batch 16 (the tensor-core
      kernel at M = 16), tokens bit-identical to the meshless engine's and
      the same launches of the same kernel, in turns (plain, mesh, mesh,
      plain), host ms per decode step and tokens/s of both; a
      ``BatchServer`` wave of two requests on the mesh, tokens equal to
      sequential serving on it, one wave a step.  Then
      ``examples/torch_{quickstart,ap_arithmetic,ternary_inference}.py``
      on the card and on the CPU: every printed line equal (the packed
      matmul's error line is held to its tolerance instead: the CPU
      compares the plain version with itself), the program kernel and the
      CUDA-core kernel launched; ``torch_serve_lm`` (8 new tokens of 24)
      and ``torch_train_lm`` (60 steps of 200, "LEARNED") on the card.
4. Times: CUDA-event medians of each kernel, its plain version and, for the
   matmul, the library product on a dense weight, beside each kernel's
   bound, at the main paths' shapes (and qwen2-72b's MLP width for the
   matmul).  Both matmul kernels are timed on the same inputs at every
   shape (qwen3-0.6b's w1 at M = 1, 4, 8, 16, 2048 and w2 at M = 16,
   2048; the routed one and the other, through its own launcher), and the
   tensor-core kernel at each of its tiles and K splits on the MLP's
   products in both dtypes (``kernel.tc_shape``'s choice marked).  The
   schedule kernel is timed through its wrapper and through
   ``tap_ripple_add`` (which builds the schedule at each call, as callers
   do) beside the program kernel, counters off, on the same schedule.  The
   matmul and schedule-kernel rows also give the device's time alone: a
   CUDA graph of 20 calls, replayed.  The decode-attention kernel at
   qwen2-72b's batch decode (128 sequences, 64 heads on 8, head 128, a
   512-slot bf16 cache) at positions 255 and 511, beside its byte bound
   (the valid K and V slots, q and the output, once), its plain version,
   the einsum path it replaces, and, timed only,
   ``scaled_dot_product_attention(enable_gqa=True)`` on the same bf16
   inputs: a yardstick, never on the path.

Prints the kernels line (one JSON object) and the card's ``nvidia-smi``
name and power limit before the last line, which is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line.  ``--json PATH`` also writes every measurement to ``PATH``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FULL_ROWS = 1 << 20                  # the main path's row count
STATS_ROWS = 65536                   # APStats parity and Table XI rows
CHECK_ROWS = (333, 65536, FULL_ROWS)
TIMING_ROWS = (4096, 65536, FULL_ROWS)
TIMING_PROGRAMS = (("add", 3, 20), ("mul", 3, 5), ("max", 3, 8))
VARIANTS = ("gather", "onehot", "onehot_packed")
PAPER_TABLE_XI = {"energy": 12.25, "setreset": 12.6, "area": 6.2}

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper, dense, at
# 700 W): device memory 3.35 TB/s; INT32 issue 64 lanes per SM x 132 SMs x
# 1.98 GHz boost clock (the clock behind the 67 TFLOP/s fp32 figure); the
# matmul's operations on the tensor cores at the bf16 rate, 989 TFLOP/s:
# bf16 x once, fp32 x as three exact bf16 passes (TF32 would lose the 1e-4
# tolerance; the bound at the fp32-FMA rate, 67 TFLOP/s, is kept beside
# it, though the three-pass kernel beats it)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_FP32_FMA_FLOP_PER_S = 67e12
MATMUL_PASSES = {"float32": 3, "bfloat16": 1}
# the program kernel's least time: a 32-bit operation handles at most 32
# rows (one bit each) of a cell compare or write; and a step cannot finish
# before one dependent shared-memory compare-and-write of the step before
# it, about 30 SM cycles (a shared-memory load's latency on Hopper, plus
# the compare and the store) at the boost clock
ROWS_PER_OP = 32
STEP_CHAIN_S = 30 / 1.98e9

# qwen3-0.6b (src/repro/configs/qwen3_0_6b.py) and qwen2-72b
# (src/repro/configs/qwen2_72b.py) MLP widths: (d_model, d_ff)
QWEN3_06B = (1024, 3072)
QWEN2_72B = (8192, 29568)
# packed-ternary matmul: the reference's kernel test shapes
# (tests/test_kernels.py), odd ones (M = 1, 3; K = 17, 1000; N = 1, 130)
# and the main path's two products at 2048 tokens (w1/w3 and w2); the
# tensor-core kernel's ragged edges (M = 16, 17, 129; K = 17, 513, 1000;
# N = 1, 129, 130, 257)
MATMUL_CHECK_SHAPES = ((8, 16, 8), (32, 256, 128), (100, 300, 96),
                       (256, 512, 256), (1, 17, 1), (3, 17, 130),
                       (1, 1000, 130), (3, 1000, 1), (16, 17, 1),
                       (17, 64, 129), (128, 1000, 130), (129, 513, 257),
                       (2048, QWEN3_06B[0], QWEN3_06B[1]),
                       (2048, QWEN3_06B[1], QWEN3_06B[0]))
MATMUL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the packed MLP against unpack_matmul, relative to the output's size:
# |y - want| <= tol * max|want| + tol * |want|.  bf16 rounds each of the
# three stages and the plain side rounds x @ w before the scale as well;
# the seeded qwen3-0.6b MLP reads at most 0.0065 of (max|want| + |want|)
# (M = 1..2048, outputs about 0.07 with max|want| 0.22-0.38), so 2e-2 is
# three times that; losing the first 512-wide K chunk of w2 moves the
# median output by 0.019 against a median limit of 0.007 and fails 79 %
# of the outputs at M = 128
MLP_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MLP_TOKENS = (1, 16, 128, 2048)
AP_TOKENS, AP_K_TILE, AP_MAX_ABS = 4, 64, 7
# the array pool: n_arrays, rows and columns of the add's bank and of the
# AP matmul's (650 columns: default_k_tile(650, 9) = AP_K_TILE); the
# coalesced MAC graphs' row counts (not multiples of the pool's rows) and K
POOL_ADD = (4, 4096, 256)
POOL_MAC = (4, 4096, 650)
COALESCE_ROWS, COALESCE_K = (5000, 3000), 128
# the faulty bank: flips only (2 in a million cells per write) and one dead
# array, enough retries to recover; retire_after high so that sustained
# flips do not retire the bank
FAULT_ROWS = 65536
FAULT_CFG = dict(flip_rate=2e-6, seed=0, dead_arrays=(1,), max_retries=8,
                 retire_after=10_000)
# block_valid checks of the program kernel: (K, C, W, pack) of random
# schedules, and (block_rows, blocks) of the launches
BLOCK_VALID_SCHEDULES = ((1, 3, 3, 1), (1, 4, 3, 1), (3, 12, 4, 1),
                         (2, 3, 2, 4))
BLOCK_VALID_SHAPES = ((4096, 6), (1000, 3), (13, 5))
# phase 3d: qwen3-0.6b at its published width (src/repro/configs/
# qwen3_0_6b.py); prefill B x S (M = 2048, the blockwise attention path);
# serving as src/repro/launch/serve.py's defaults: batch, prompt tokens,
# new tokens, cache length
MODEL_ARCH = "qwen3-0.6b"
PREFILL_SHAPE = (2, 1024)
SERVE_SHAPE = (4, 16, 32, 128)
# the kernel route's logits against the plain route's, |y - want| <= tol ·
# max|want| + tol · |want| (as MLP_TOL), and decode steps against forward.
# On an H100 the seeded model read at most 2.4e-6 (fp32 prefill; decode
# 6.6e-7) and 0.0148 (bf16 decode; prefill 0.013) of (max|want| +
# |want|), decode against forward 1.7e-6 (fp32): the tolerances are 4.1x,
# 3.4x and 5.9x those
MODEL_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DECODE_FWD_TOL = 1e-5
# the deliberate fault: one layer's w2_scale zeroed, and the layers it must
# move past the tolerance.  Layer 0 moved the logits 40243x (fp32) and
# 10.0x (bf16, at 4e-2) past it; layer 14 4246x in fp32 but 0.92 of the
# bf16 tolerance, where kernel against plain reads 0.3 of it
FAULT_LAYERS = (0, 14)
FAULT_GATES = {"float32": (0, 14), "bfloat16": (0,)}
# phase 3e: qwen3-0.6b fp32 at its published width and depth, every MLP
# projection on the AP: the pool of phase 3c and the reference's x_levels;
# requests cut short (a model step is thousands of program launches):
# AP_SERVE_N_SEQ requests of (prompt tokens, new tokens), a cache of
# AP_SERVE_MAX_LEN; the MoE check's pool is the CPU tests' tiny one
AP_SERVE_POOL = POOL_MAC
AP_SERVE_X_LEVELS = 7
AP_SERVE_REQUEST = (2, 2)
AP_SERVE_N_SEQ = 2
AP_SERVE_MAX_LEN = 8
AP_SERVE_MOE_POOL = (4, 64, 64)
# fewer slots than a MAC tile program at 650 columns has (24329 at K = 64):
# a fold (reduction) program, 2850 slots for w1's 16 partials
MAC_TILE_MIN_SLOTS = 5000
# phase 3f: training qwen3-0.6b at its published width, the launcher's
# defaults (src/repro/launch/train.py: batch 8, sequence 128, lr 3e-4);
# step times are the median of steps 3 to TRAIN_STEPS; the card-against-CPU
# and resume checks run TRAIN_SHORT_LAYERS layers (the CPU's step at batch
# TRAIN_CPU_SHAPE), compressed DP all 28 for TRAIN_DP_STEPS steps.
# Tolerances: loss and grad_norm relative, a grad leaf against its own
# max|g|, AdamW allclose (atol = rtol)
TRAIN_STEPS = 10
TRAIN_TIMED = slice(2, TRAIN_STEPS)
TRAIN_FIXED_STEPS = 10
TRAIN_SHAPE = (8, 128)
TRAIN_SHORT_LAYERS = 2
TRAIN_CPU_SHAPE = (2, 128)
TRAIN_DP_STEPS = 3
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "adamw": 1e-6}
# the remat policies whose step is profiled: the config's, and none
TRAIN_PROFILED = ("none", "dots")
# phase 3g: the named mesh, a 1-rank NCCL group, (data=1, model=1) on the
# card: qwen3-0.6b at full width and depth, phase 3f's batch and seed,
# MESH_STEPS sharded (DTensor) steps against as many plain ones; one MoE
# layer of qwen3-moe-30b-a3b at full width, fp32, MESH_MOE_TOKENS tokens.
# Tolerances: loss and grad_norm relative, per step
MESH_STEPS = 3
MESH_TOL = {"loss": 1e-6, "grad_norm": 1e-5}
MESH_MOE_ARCH = "qwen3-moe-30b-a3b"
MESH_MOE_TOKENS = (2, 512)
# phase 3h: the engine on the mesh at batch 4 (CUDA cores) and 16 (tensor
# cores), launch/serve.py's prompt, new tokens and cache otherwise; a
# BatchServer wave of two requests (batch, new tokens each)
MESH_SERVE_BATCHES = (4, 16)
MESH_WAVE = (2, 8)
# and a merged AP wave of this many one-token requests (one new token: one
# wave) on the mesh, its threads taking turns between graph calls (the
# order a mesh needs) and not, in turns ordered, unordered, unordered,
# ordered; at full width and a quarter of the depth (the layers repeat,
# and so do the turns), which keeps phase 3h near 90 s
MESH_AP_WAVE = 2
MESH_AP_WAVE_LAYERS = 7
# the examples whose every printed number must equal the CPU run's, and
# the cut counts of the other two (their full counts: 24 tokens, 200 steps)
EXAMPLES_SAME = ("quickstart", "ap_arithmetic", "ternary_inference")
EXAMPLES_CUT = {"serve_lm": ("--new-tokens", "8"),
                "train_lm": ("--steps", "60")}
# ternary-matmul timings: (model, product, K, N, M), K x N the product's
# (w1: d_model x d_ff; w2: d_ff x d_model)
MATMUL_TIMES = tuple(("qwen3-0.6b", "w1", *QWEN3_06B, m)
                    for m in (1, 4, 8, 16, 2048)) + \
    tuple(("qwen3-0.6b", "w2", *QWEN3_06B[::-1], m) for m in (16, 2048)) + \
    tuple(("qwen2-72b", "w1", *QWEN2_72B, m) for m in (1, 16))
# the kernels line's rows: (model, product, M, dtype)
MATMUL_LINE = {"ternary_matmul": ("qwen3-0.6b", "w1", 1, "float32"),
               "ternary_matmul_tc": ("qwen3-0.6b", "w1", 2048, "bfloat16")}

# decode attention: qwen2-72b's batch decode (B, H, Hk, hd, cache slots)
# at two positions; the check's shapes beside it: that one, the shapes
# phases 3d and 3h give the kernel (qwen3-0.6b's 16 heads on 8 at batch 4,
# 16 and the wave's 2, SERVE_SHAPE's cache), and odd ones; each at the
# first slot, half and all of the cache, and the written slots of those
# phases' first and last decode steps
ATTN_SHAPE = (128, 64, 8, 128, 512)
ATTN_POSITIONS = (255, 511)
ATTN_CHECK_SHAPES = ((128, 64, 8, 128, 512),
                     *((b, 16, 8, 128, SERVE_SHAPE[3])
                       for b in dict.fromkeys((SERVE_SHAPE[0],
                                               *MESH_SERVE_BATCHES,
                                               MESH_WAVE[0]))),
                     (1, 64, 8, 128, 512), (8, 16, 8, 96, 300),
                     (4, 32, 32, 256, 70))
ATTN_CHECK_SLOTS = (SERVE_SHAPE[1] + 1, SERVE_SHAPE[1] + SERVE_SHAPE[2] - 1)

KERNELS = {
    "tap_run_program": {
        "source": "src/repro_torch/kernels/tap_pass/csrc/tap_program.cu",
        "replaces": "src/repro/kernels/tap_pass/kernel.py:373"},
    "tap_apply_schedule": {
        "source": "src/repro_torch/kernels/tap_pass/csrc/tap_schedule.cu",
        "replaces": "src/repro/kernels/tap_pass/kernel.py:396"},
    "ternary_matmul": {
        "source": "src/repro_torch/kernels/ternary_matmul/csrc/"
                  "ternary_matmul.cu",
        "replaces": "src/repro/kernels/ternary_matmul/kernel.py:75"},
    "ternary_matmul_tc": {
        "source": "src/repro_torch/kernels/ternary_matmul/csrc/"
                  "ternary_matmul_tc.cu",
        "replaces": "src/repro/kernels/ternary_matmul/kernel.py:75"},
    "decode_attention": {
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "none: the JAX package's attend_decode "
                    "(src/repro/models/attention.py) is plain jnp"},
}


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def named_operands(fn: str, radix: int, width: int, rows: int, rng):
    """Random operands and their digit rows in ``compile_named``'s layout."""
    a = rng.integers(0, radix ** width, rows)
    b = rng.integers(0, radix ** width, rows)
    if fn == "mul":
        arr = np.zeros((rows, 5 * width + 1), np.int8)
        for i in range(width):
            arr[:, i] = arr[:, width + i] = (a // radix ** i) % radix
            arr[:, 2 * width + i] = (b // radix ** i) % radix
        return a, b, arr
    from repro_torch.core import ap
    extra = 0 if fn in ("min", "max", "modsum", "nor", "nand") else 1
    return a, b, ap.encode_operands(a, b, radix, width, extra_cols=extra)


def raw_digits(rows: int, cols: int, radix: int, rng) -> np.ndarray:
    """Any digit a cell can hold: don't-care (-1), 0..radix-1, and radix
    (the fault model's stuck-between-levels value)."""
    return rng.integers(-1, radix + 1, (rows, cols)).astype(np.int8)


def check_programs():
    from repro_torch import apc
    dup = apc.compile_program((
        apc.CompareWrite(compare_cols=(0,), key=(1,), write_cols=(2, 2),
                         write_vals=(1, 2)),
        apc.CompareWrite(compare_cols=(1, 1), key=(0, 0), write_cols=(3,),
                         write_vals=(2,))))
    return [("add3x20", 3, apc.compile_named("add", 3, 20)),
            ("add3x20_blocked", 3,
             apc.compile_named("add", 3, 20, blocked=True)),
            ("mul3x5", 3, apc.compile_named("mul", 3, 5)),
            ("max3x8", 3, apc.compile_named("max", 3, 8)),
            ("sub5x8_blocked", 5,
             apc.compile_named("sub", 5, 8, blocked=True)),
            ("dup_write_cols", 3, dup),
            # the widest Table XI adds: 257 and 161 columns, so the row
            # tile takes more than 48 KB of shared memory
            ("add2x128", 2, apc.compile_named("add", 2, 128)),
            ("add3x80", 3, apc.compile_named("add", 3, 80))]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_schedule(rng, S: int, K: int, C: int, W: int, cols: int):
    """Dense schedule tensors with any int8 keys and values, columns past
    ``cols`` and -1 padding, slots with no valid key, histogram flags on
    and off, distinct write columns."""
    cmp_cols = rng.integers(-1, cols + 3, (S, C))
    keys = np.where(rng.random((S, K, C)) < 0.7,
                    rng.integers(-1, 3, (S, K, C)),
                    rng.integers(-128, 128, (S, K, C)))
    key_valid = rng.random((S, K)) < 0.7
    hist_flag = rng.random(S) < 0.8
    wr_cols = np.stack([rng.choice(cols + 3, W, replace=False) - 1
                        for _ in range(S)])
    wr_vals = np.where(rng.random((S, W)) < 0.7, rng.integers(-1, 3, (S, W)),
                       rng.integers(-128, 128, (S, W)))
    return (cmp_cols.astype(np.int32), keys.astype(np.int8), key_valid,
            hist_flag, wr_cols.astype(np.int32), wr_vals.astype(np.int8))


def phase_kernels_vs_plain(dev, log) -> dict[str, int]:
    import torch
    from repro_torch.apc import compile_named as apc_compile
    from repro_torch.apc.exec import BLOCK_ROWS, device_schedule
    from repro_torch.core import build_lut_blocked, build_lut_nonblocked
    from repro_torch.core import truth_tables as tt
    from repro_torch.kernels.tap_pass import kernel, ref
    from repro_torch.kernels.tap_pass.ops import _pad_rows

    rng = np.random.default_rng(SEED)
    err = {"tap_run_program": 0, "tap_apply_schedule": 0}
    for name, radix, compiled in check_programs():
        for rows in CHECK_ROWS:
            arr = torch.from_numpy(
                raw_digits(rows, compiled.min_cols + 1, radix, rng)).to(dev)
            block_rows = min(BLOCK_ROWS, max(8, rows))
            padded, _ = _pad_rows(arr, block_rows)
            plain = {}
            for kv in VARIANTS:
                sched, variant, pack = device_schedule(compiled, kv, dev)
                for stats in (True, False):
                    out, counts = kernel.tap_run_program(
                        padded, *sched, rows, block_rows=block_rows,
                        collect_stats=stats, pack=pack)
                    key = (pack, stats)
                    if key not in plain:       # flat variants share one
                        plain[key] = ref.run_program_plain(
                            padded, *sched, rows, block_rows=block_rows,
                            collect_stats=stats, pack=pack)
                    want, want_counts = plain[key]
                    e = int((out.int() - want.int()).abs().max())
                    if stats:
                        e = max(e, int((counts.long() -
                                        want_counts.long()).abs().max()))
                    err["tap_run_program"] = max(err["tap_run_program"], e)
                    log(f"  tap_run_program {name} rows={rows} "
                        f"variant={kv}->{variant}/pack{pack} stats={stats} "
                        f"max_abs_err={e}")
                    check(e == 0, f"tap_run_program {name} rows={rows} "
                                  f"{kv} stats={stats} disagrees")
    # per-block valid rows: random schedules (any int8 keys, values and
    # digits, columns outside the tile, no-key slots, groups) and the
    # add 3x20 program, valid counts from 1 to block_rows
    bv_cases = [(f"random K{K} C{C} W{W} pack{pack}",
                 random_schedule(rng, 64, K, C, W, 40), pack, 40, 3)
                for K, C, W, pack in BLOCK_VALID_SCHEDULES]
    add = apc_compile("add", 3, 20)
    bv_cases.append(("add3x20", add.schedule_tensors, 1, add.min_cols, 3))
    for name, sched, pack, cols, radix in bv_cases:
        # the plain version reads a column outside the tile as -1 padding
        plain_sched = list(sched)
        for i in (0, 4):
            plain_sched[i] = np.where(sched[i] < cols, sched[i], -1).astype(
                np.int32)
        on_dev = kernel.program_tensors_on(sched, dev)
        plain_dev = kernel.program_tensors_on(plain_sched, dev)
        for block_rows, n_blocks in BLOCK_VALID_SHAPES:
            rows = block_rows * n_blocks
            arr = torch.from_numpy(raw_digits(rows, cols, radix, rng)).to(dev)
            bv = rng.integers(1, block_rows + 1, n_blocks)
            bv[0], bv[-1] = 1, block_rows
            bv = torch.from_numpy(bv.astype(np.int32)).to(dev)
            for stats in (True, False):
                out, counts = kernel.tap_run_program(
                    arr, *on_dev, 0, block_rows=block_rows,
                    collect_stats=stats, pack=pack, block_valid=bv)
                want, want_counts = ref.run_program_plain(
                    arr, *plain_dev, 0, block_rows=block_rows,
                    collect_stats=stats, pack=pack, block_valid=bv)
                e = int((out.int() - want.int()).abs().max())
                if stats:
                    e = max(e, int((counts.long() -
                                    want_counts.long()).abs().max()))
                err["tap_run_program"] = max(err["tap_run_program"], e)
                log(f"  tap_run_program block_valid {name} block_rows="
                    f"{block_rows} blocks={n_blocks} valid={bv.tolist()} "
                    f"stats={stats} max_abs_err={e}")
                check(e == 0, f"tap_run_program block_valid {name} "
                              f"block_rows={block_rows} disagrees")
    # the schedule kernel's two slot bodies: unrolled (the non-blocked
    # ripple add) and general (the blocked schedules, four keys a step)
    lut_b = build_lut_blocked(tt.full_adder(3))
    lut_n = build_lut_nonblocked(tt.full_adder(3))
    cases = [("blocked_full_adder", ref.schedule_from_lut(lut_b, (0, 1, 2)),
              3),
             ("ripple_add_w3", ref.ripple_add_schedule(lut_n, 3, 6), 7),
             ("ripple_add_w3_blocked", ref.ripple_add_schedule(lut_b, 3, 6),
              7)]
    bodies = set()
    for name, sched, cols in cases:
        arr = torch.from_numpy(raw_digits(FULL_ROWS, cols, 3, rng)).to(dev)
        out = kernel.tap_apply_schedule(arr, sched)
        want = ref.apply_schedule(arr, sched)
        e = int((out.int() - want.int()).abs().max())
        err["tap_apply_schedule"] = max(err["tap_apply_schedule"], e)
        body = ("general" if kernel.schedule_plan(sched, cols, dev).kind == 0
                else "unrolled")
        bodies.add(body)
        log(f"  tap_apply_schedule {name} rows={FULL_ROWS} steps="
            f"{len(sched)} slot body {body} max_abs_err={e}")
        check(e == 0, f"tap_apply_schedule {name} disagrees")
    check(bodies == {"general", "unrolled"},
          f"tap_apply_schedule ran the slot bodies {bodies}, not both")
    torch.cuda.synchronize()
    return err


def allclose_err(y, want, tol: float, atol: float | None = None
                 ) -> tuple[float, bool]:
    """max |y - want| and whether |y - want| <= atol + tol * |want| holds
    everywhere (allclose with rtol = tol and atol = tol unless given; NaN
    fails)."""
    d = (y.float() - want.float()).abs()
    atol = tol if atol is None else atol
    ok = bool((d <= atol + tol * want.float().abs()).all())
    return (float(d.max()) if d.numel() else 0.0), ok


def packed_weights(k: int, n: int, rng, dev):
    """Seeded fp32 weights (std 0.05), quantized and packed on the card."""
    import torch
    from repro_torch.kernels.ternary_matmul import quantize_and_pack
    w = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32))
    return quantize_and_pack(w.to(dev))


def seeded_packed(k: int, n: int, gen, dev, chunk: int = 1024):
    """Uniform trits packed on the card, ``chunk`` rows of K at a time, and
    scales in [0.01, 0.05), from the torch generator ``gen``."""
    import torch
    from repro_torch.kernels.ternary_matmul.ref import PACK, pack_ternary
    packed = torch.empty((k // PACK, n), dtype=torch.int32, device=dev)
    for lo in range(0, k, chunk):
        trits = torch.randint(-1, 2, (min(chunk, k - lo), n), generator=gen,
                              device=dev, dtype=torch.int8)
        packed[lo // PACK:(lo + len(trits)) // PACK] = pack_ternary(trits)
    scale = torch.rand(n, generator=gen, device=dev) * 0.04 + 0.01
    return packed, scale


def routed_matmul(tk, x, packed, scale):
    """``tk.ternary_matmul`` on the card; checks that it launched the
    kernel ``kernel_for`` names, once, and no other.  Returns (y, name)."""
    before = dict(tk.launch_counts)
    y = tk.ternary_matmul(x, packed, scale)
    name = tk.kernel_for(x.dtype, x.shape[0])
    moved = {k: n - before[k] for k, n in tk.launch_counts.items()}
    check(moved == {k: int(k == name) for k in moved},
          f"ternary_matmul M={x.shape[0]} {x.dtype}: launches {moved}, "
          f"expected one of {name}")
    return y, name


def phase_matmul_vs_plain(dev, log) -> dict[str, dict[str, float]]:
    """Both ternary-matmul kernels against ``ternary_matmul_ref`` on the
    card: fp32 / bf16 within MATMUL_TOL, integer activations exact (fp32)
    or bit-identical to the plain version (bf16).  Max errors per kernel."""
    import torch
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import (pack_ternary,
                                                        ternary_matmul_ref)
    rng = np.random.default_rng(SEED + 3)
    err = {"ternary_matmul": {"float32": 0.0, "bfloat16": 0.0,
                              "integer": 0.0},
           "ternary_matmul_tc": {"float32": 0.0, "bfloat16": 0.0,
                                 "integer": 0.0}}
    for m, k, n in MATMUL_CHECK_SHAPES:
        packed, scale = packed_weights(k, n, rng, dev)
        x32 = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            x = x32.to(dev, dtype)
            y, kname = routed_matmul(tk, x, packed, scale)
            want = ternary_matmul_ref(x, packed, scale)
            check(y.dtype == dtype and tuple(y.shape) == (m, n),
                  f"{kname} {m}x{k}x{n} {name}: got {y.dtype} "
                  f"{tuple(y.shape)}")
            e, ok = allclose_err(y, want, MATMUL_TOL[name])
            err[kname][name] = max(err[kname][name], e)
            log(f"  {kname} M={m} K={k} N={n} {name} max_abs_err="
                f"{e:.3e} (tolerance {MATMUL_TOL[name]})")
            check(ok, f"{kname} {m}x{k}x{n} {name} disagrees")
    # integer activations: the sums are exact in fp32, so is the product
    for m, k, n in ((16, 64, 32), (AP_TOKENS, QWEN3_06B[0], QWEN3_06B[1])):
        w_t = torch.from_numpy(
            rng.integers(-1, 2, (k, n)).astype(np.int8)).to(dev)
        x = torch.from_numpy(rng.integers(
            -AP_MAX_ABS, AP_MAX_ABS + 1, (m, k)).astype(np.float32)).to(dev)
        packed, ones = pack_ternary(w_t), torch.ones(n, device=dev)
        y, kname = routed_matmul(tk, x, packed, ones)
        e = float((y.double() - x.double() @ w_t.double()).abs().max())
        err[kname]["integer"] = max(err[kname]["integer"], e)
        log(f"  {kname} integers M={m} K={k} N={n} max_abs_err={e}")
        check(e == 0 and torch.equal(y, ternary_matmul_ref(x, packed, ones)),
              f"{kname} integers {m}x{k}x{n} not exact")
    # integer activations on the tensor cores, bf16 and fp32 (three bf16
    # passes): every fp32 sum is exact and both sides round acc * scale[n]
    # once, so y is bit for bit the plain version's; |x| < 2^19 at K = 16
    # keeps the sums below 2^24 and fills all three fp32 parts; qwen3-0.6b's
    # w1 and w2 at M = 16 split K over clusters of 4 and 8 CTAs
    d, f = QWEN3_06B
    for m, k, n, big in ((16, d, f, AP_MAX_ABS), (16, f, d, AP_MAX_ABS),
                         (2048, d, f, AP_MAX_ABS),
                         (16, 16, 257, (1 << 19) - 1)):
        w_t = torch.from_numpy(
            rng.integers(-1, 2, (k, n)).astype(np.int8)).to(dev)
        packed = pack_ternary(w_t)
        scale = torch.from_numpy(
            rng.uniform(0.01, 0.05, n).astype(np.float32)).to(dev)
        xi = rng.integers(-big, big + 1, (m, k)).astype(np.float32)
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.bfloat16 and big > AP_MAX_ABS:
                continue                 # not integers once in bf16
            name = str(dtype).split(".")[1]
            x = torch.from_numpy(xi).to(dev, dtype)
            y, kname = routed_matmul(tk, x, packed, scale)
            want = ternary_matmul_ref(x, packed, scale)
            e = float((y.float() - want.float()).abs().max())
            err[kname]["integer"] = max(err[kname]["integer"], e)
            log(f"  {kname} {name} integers |x| <= {big} M={m} K={k} N={n} "
                f"max_abs_err={e}, bit-identical {torch.equal(y, want)}")
            check(kname == "ternary_matmul_tc" and torch.equal(y, want),
                  f"{kname} {name} integers {m}x{k}x{n} not bit-identical")
    # qwen2-72b's w1 (K = 8192), the widest K: both kernels at every shape
    # phase 4 times, routed or not, within tolerance on normal x and bit
    # for bit on integers |x| <= 7 (sums below 2^24: exact)
    k, n = QWEN2_72B
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    packed, scale = seeded_packed(k, n, gen, dev)
    launchers = {"ternary_matmul": tk._launch_cuda_cores,
                 "ternary_matmul_tc": tk._launch_tensor_cores}
    for m in (1, 16):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            tol = MATMUL_TOL[name]
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            xi = torch.randint(-AP_MAX_ABS, AP_MAX_ABS + 1, (m, k),
                               generator=gen, device=dev).to(dtype)
            want = ternary_matmul_ref(x, packed, scale)
            want_i = ternary_matmul_ref(xi, packed, scale)
            for kname, launch in launchers.items():
                y = launch(x, packed, scale)
                e, ok = allclose_err(y, want, tol)
                worst = float(((y.float() - want.float()).abs() / (
                    tol + tol * want.float().abs())).max())
                yi = launch(xi, packed, scale)
                ei = float((yi.float() - want_i.float()).abs().max())
                err[kname][name] = max(err[kname][name], e)
                err[kname]["integer"] = max(err[kname]["integer"], ei)
                log(f"  {kname} qwen2-72b w1 M={m} K={k} N={n} {name} "
                    f"max_abs_err={e:.3e}, largest |y - want| / ({tol} + "
                    f"{tol}·|want|) = {worst:.3f} (limit 1); integers "
                    f"|x| <= {AP_MAX_ABS} max_abs_err={ei}, bit-identical "
                    f"{torch.equal(yi, want_i)}")
                check(ok, f"{kname} qwen2-72b M={m} {name} disagrees")
                check(torch.equal(yi, want_i),
                      f"{kname} qwen2-72b M={m} {name} integers not "
                      f"bit-identical")
    torch.cuda.synchronize()
    return err


def phase_mac_programs_vs_plain(dev, log) -> int:
    """The program kernel on the programs of a small K-tiled MAC (K = 8,
    k_tile = 3, radix 3, counters on) against its plain version, at the AP
    path's row count: encoded MAC rows and raw digits."""
    import torch
    from repro_torch import apc
    from repro_torch.apc.exec import BLOCK_ROWS, device_schedule
    from repro_torch.kernels.tap_pass import kernel, ref
    from repro_torch.kernels.tap_pass.ops import _pad_rows

    rng = np.random.default_rng(SEED + 6)
    radix, K, k_tile = 3, 8, 3
    width = apc.mac_acc_width(radix, K, AP_MAX_ABS)
    tiled = apc.compile_mac_tiled(radix, K, width, k_tile)
    rows = AP_TOKENS * QWEN3_06B[1]
    cases = []
    for (lo, hi), prog in zip(tiled.tiles, tiled.programs):
        x = rng.integers(-AP_MAX_ABS, AP_MAX_ABS + 1, (rows, hi - lo))
        w = rng.integers(-1, 2, (rows, hi - lo))
        cases.append((f"tile[{lo}:{hi}] encoded", prog,
                      apc.encode_mac_rows(x, w, radix, width)))
    for j, prog in enumerate(tiled.reduce_programs):
        cases.append((f"reduce{j}", prog, rng.integers(
            0, radix, (rows, prog.min_cols)).astype(np.int8)))
    for j, prog in enumerate(tiled.programs + tiled.reduce_programs):
        cases.append((f"program{j} raw", prog,
                      raw_digits(rows, prog.min_cols, radix, rng)))
    err = 0
    for name, prog, arr in cases:
        arr = torch.from_numpy(arr).to(dev)
        padded, _ = _pad_rows(arr, BLOCK_ROWS)
        sched, _, pack = device_schedule(prog, None, dev)
        out, counts = kernel.tap_run_program(
            padded, *sched, rows, block_rows=BLOCK_ROWS, collect_stats=True,
            pack=pack)
        want, want_counts = ref.run_program_plain(
            padded, *sched, rows, block_rows=BLOCK_ROWS, collect_stats=True,
            pack=pack)
        e = max(int((out.int() - want.int()).abs().max()),
                int((counts.long() - want_counts.long()).abs().max()))
        err = max(err, e)
        log(f"  tap_run_program mac K={K} k_tile={k_tile} {name} rows={rows}"
            f" steps={prog.n_steps} max_abs_err={e}")
        check(e == 0, f"tap_run_program mac {name} disagrees")
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def ripple_oracle(a_d: np.ndarray, b_d: np.ndarray, radix: int):
    """numpy ripple-carry add of little-endian digit matrices."""
    carry = np.zeros(a_d.shape[0], np.int32)
    out = np.zeros_like(a_d)
    for i in range(a_d.shape[1]):
        s = a_d[:, i].astype(np.int32) + b_d[:, i] + carry
        out[:, i] = (s % radix).astype(np.int8)
        carry = s // radix
    return out, carry


class ProgramLaunches:
    """Within the block, record every program-kernel launch the executor
    (``apc.exec``) makes: its input digits, arguments, output digits and
    counter rows, so that a main path's own launches can be replayed by
    the plain version.  The launches themselves are unchanged."""

    def __enter__(self):
        from repro_torch.apc import exec as apc_exec
        self.module, self.launch = apc_exec, apc_exec.tap_run_program
        self.calls: list[tuple] = []

        def recorded(padded, *args, **kw):
            before = padded.clone()
            out, counts = self.launch(padded, *args, **kw)
            self.calls.append((before, args, kw, out, counts))
            return out, counts
        apc_exec.tap_run_program = recorded
        return self

    def __exit__(self, *exc) -> None:
        self.module.tap_run_program = self.launch


def stats_fields(s) -> tuple:
    return (s.radix, s.n_rows, s.n_compare_cycles, s.n_write_cycles,
            s.sets, s.resets, tuple(int(h) for h in s.mismatch_hist))


def phase_main_path(dev, log) -> dict:
    import torch
    from repro_torch import apc
    from repro_torch.core import ap, build_lut_blocked, build_lut_nonblocked
    from repro_torch.core import truth_tables as tt
    from repro_torch.core.circuit import CellParams
    from repro_torch.core.energy import (EQUIV_WIDTHS, energy_from_stats,
                                         row_area_units)
    from repro_torch.kernels.tap_pass import tap_apply_lut, tap_ripple_add

    rng = np.random.default_rng(SEED + 1)
    res = {}

    # the paper's headline: 20-trit in-place add at 2^20 rows
    r, w = 3, 20
    a, b, arr = named_operands("add", r, w, FULL_ROWS, rng)
    compiled = apc.compile_named("add", r, w)
    stats = ap.APStats(radix=r)
    t0 = time.perf_counter()
    out = apc.run(arr, compiled, stats=stats)
    torch.cuda.synchronize()
    res["add3x20_run_ms"] = (time.perf_counter() - t0) * 1e3
    out = out.cpu().numpy()
    got = ap.decode_digits(out, list(range(w, 2 * w)), r)
    check(np.array_equal(got, (a + b) % r ** w), "add 3x20 digits wrong")
    check(np.array_equal(out[:, 2 * w], (a + b) // r ** w),
          "add 3x20 carry wrong")
    log(f"  add 3x20 rows={FULL_ROWS} bit-exact vs numpy, "
        f"run {res['add3x20_run_ms']:.3f} ms (host clock, first call), "
        f"sets={stats.sets}")

    # multiply and subtract through engine="apc"
    lut_add = build_lut_nonblocked(tt.full_adder(r))
    lut_half = build_lut_nonblocked(tt.half_adder(r))
    mw = 5
    a, b, arr = named_operands("mul", r, mw, FULL_ROWS, rng)
    out = ap.multiply(arr, lut_add, lut_half, mw, r, 0, mw, 2 * mw, 3 * mw,
                      5 * mw, engine="apc")
    got = ap.decode_digits(out, list(range(3 * mw, 5 * mw)), r)
    check(np.array_equal(got, a * b), "multiply 3x5 wrong")
    log(f"  multiply 3x5 rows={FULL_ROWS} engine=apc bit-exact vs numpy")
    lut_sub = build_lut_nonblocked(tt.full_subtractor(r))
    a, b, arr = named_operands("sub", r, w, FULL_ROWS, rng)
    out = ap.ripple_sub(arr, lut_sub, w, 2 * w, engine="apc")
    got = ap.decode_digits(out, list(range(w, 2 * w)), r)
    check(np.array_equal(got, (a - b) % r ** w), "ripple_sub 3x20 wrong")
    log(f"  ripple_sub 3x20 rows={FULL_ROWS} engine=apc bit-exact vs numpy")

    # APStats: engine="apc" equal to engine="replay" on the card
    for name, run_both in (
            ("add3x20", lambda arr, s, e: ap.ripple_add(
                arr, lut_add, w, 2 * w, stats=s, engine=e)),
            ("mul3x5", lambda arr, s, e: ap.multiply(
                arr, lut_add, lut_half, mw, r, 0, mw, 2 * mw, 3 * mw,
                5 * mw, stats=s, engine=e))):
        fn, width = ("mul", mw) if name == "mul3x5" else ("add", w)
        _, _, arr = named_operands(fn, r, width, STATS_ROWS, rng)
        s_rep, s_apc = ap.APStats(radix=r), ap.APStats(radix=r)
        o_rep = run_both(arr, s_rep, "replay")
        o_apc = run_both(arr, s_apc, "apc")
        check(torch.equal(o_rep, o_apc), f"{name} apc digits != replay")
        check(stats_fields(s_rep) == stats_fields(s_apc),
              f"{name} APStats apc {s_apc} != replay {s_rep}")
        log(f"  {name} rows={STATS_ROWS} APStats apc == replay: "
            f"{stats_fields(s_apc)}")

    # the short-schedule entry points
    lut_b = build_lut_blocked(tt.full_adder(r))
    digits = rng.integers(0, r, (FULL_ROWS, 3)).astype(np.int8)
    out = tap_apply_lut(digits, lut_b, (0, 1, 2))
    want = ap.apply_lut_pure(torch.from_numpy(digits).to(dev), lut_b,
                             (0, 1, 2))
    check(torch.equal(out, want), "tap_apply_lut != apply_lut_pure")
    a, b, arr = named_operands("add", r, 3, FULL_ROWS, rng)
    out = tap_ripple_add(arr, lut_add, 3, 6).cpu().numpy()
    got = ap.decode_digits(out, [3, 4, 5], r)
    check(np.array_equal(got, (a + b) % r ** 3), "tap_ripple_add wrong")
    log(f"  tap_apply_lut / tap_ripple_add w3 rows={FULL_ROWS} bit-exact")

    # Table XI: ternary vs binary AP adders, engine="apc"
    rows = []
    for p_t, q_b in EQUIV_WIDTHS.items():
        row = {"pair": f"{q_b}b/{p_t}t"}
        for radix, width, tag in ((3, p_t, "t"), (2, q_b, "b")):
            lut = build_lut_nonblocked(tt.full_adder(radix))
            a_d = rng.integers(0, radix, (STATS_ROWS, width)).astype(np.int8)
            b_d = rng.integers(0, radix, (STATS_ROWS, width)).astype(np.int8)
            arr = np.concatenate(
                [a_d, b_d, np.zeros((STATS_ROWS, 1), np.int8)], axis=1)
            st, st_rep = ap.APStats(radix=radix), ap.APStats(radix=radix)
            out = ap.ripple_add(arr, lut, width, 2 * width, stats=st,
                                engine="apc")
            out_rep = ap.ripple_add(arr, lut, width, 2 * width,
                                    stats=st_rep, engine="replay")
            check(torch.equal(out, out_rep),
                  f"Table XI r{radix} w{width} apc digits != replay")
            check(stats_fields(st) == stats_fields(st_rep),
                  f"Table XI r{radix} w{width} APStats apc {st} != "
                  f"replay {st_rep}")
            out = out.cpu().numpy()
            want, carry = ripple_oracle(a_d, b_d, radix)
            check(np.array_equal(out[:, width:2 * width], want)
                  and np.array_equal(out[:, 2 * width], carry),
                  f"Table XI r{radix} w{width} add wrong")
            rep = energy_from_stats(st, n_masked=3,
                                    params=CellParams(radix=radix))
            row[f"sets_{tag}"] = st.sets / STATS_ROWS
            row[f"total_nJ_{tag}"] = rep.total_j / STATS_ROWS * 1e9
            row[f"area_{tag}"] = row_area_units(width, radix)
        rows.append(row)
        log(f"  table_xi {row['pair']}: digits and APStats apc == replay; "
            f"sets/row b={row['sets_b']:.4f} "
            f"t={row['sets_t']:.4f}, nJ/row b={row['total_nJ_b']:.4f} "
            f"t={row['total_nJ_t']:.4f}, area b={row['area_b']:.2f} "
            f"t={row['area_t']:.2f}")

    def mean_red(key):
        return float(np.mean([(x[f"{key}_b"] - x[f"{key}_t"]) / x[f"{key}_b"]
                              for x in rows]) * 100)
    derived = {"energy": mean_red("total_nJ"), "setreset": mean_red("sets"),
               "area": mean_red("area")}
    log(f"  table_xi reductions (ternary vs binary, %): energy "
        f"{derived['energy']:.4f} set/reset {derived['setreset']:.4f} area "
        f"{derived['area']:.4f}; paper {PAPER_TABLE_XI['energy']} / "
        f"{PAPER_TABLE_XI['setreset']} / {PAPER_TABLE_XI['area']}")
    res["table_xi"] = {"rows": rows, "reductions_pct": derived,
                       "paper_pct": PAPER_TABLE_XI}
    return res


def phase_matmul_path(dev, log) -> dict:
    """The packed-ternary matmul path at qwen3-0.6b's MLP width."""
    import torch
    from repro_torch import apc
    from repro_torch.core.ap import APStats
    from repro_torch.core.circuit import CellParams
    from repro_torch.core.energy import energy_from_stats
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.kernels.ternary_matmul.ap import ap_matmul_cycle_counts
    from repro_torch.kernels.ternary_matmul.ref import unpack_ternary
    from repro_torch.models import quant

    rng = np.random.default_rng(SEED + 4)
    d, f = QWEN3_06B
    mlp = {key: torch.from_numpy(
        rng.normal(0, 0.02, shape).astype(np.float32)).to(dev)
        for key, shape in (("w1", (d, f)), ("w3", (d, f)), ("w2", (f, d)))}
    p = quant.pack_mlp_params(mlp)
    del mlp
    res: dict = {"mlp": []}

    def swiglu(x, mm):
        h = (torch.nn.functional.silu(mm(x, p["w1_packed"], p["w1_scale"]))
             * mm(x, p["w3_packed"], p["w3_scale"]))
        return mm(h, p["w2_packed"], p["w2_scale"])

    def packed_mm(x, packed, scale):
        return ternary_matmul(x, packed, scale, impl="pallas")

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = MLP_TOL[name]
        for m in MLP_TOKENS:
            x = torch.from_numpy(
                rng.normal(0, 1, (m, d)).astype(np.float32)).to(dev, dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = swiglu(x, packed_mm)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            want = swiglu(x, quant.unpack_matmul)
            check(y.dtype == dtype and tuple(y.shape) == (m, d)
                  and bool(torch.isfinite(y).all()),
                  f"packed MLP M={m} {name}: bad output")
            scale = float(want.float().abs().max())
            e, ok = allclose_err(y, want, tol, atol=tol * scale)
            res["mlp"].append({"tokens": m, "dtype": name,
                               "max_abs_err": e, "max_abs_want": scale,
                               "rtol": tol, "atol": tol * scale,
                               "wall_ms": wall_ms})
            log(f"  packed MLP qwen3-0.6b M={m} {name}: max_abs_err {e:.3e}"
                f" vs unpack_matmul (atol {tol} x max|want| {scale:.4f} = "
                f"{tol * scale:.3e}, rtol {tol}), {wall_ms:.3f} ms (host "
                f"clock)")
            check(ok, f"packed MLP M={m} {name} disagrees with "
                      f"unpack_matmul")

    # the AP matmul on integer activations, at full width, K-tiled
    xi = rng.integers(-AP_MAX_ABS, AP_MAX_ABS + 1, (AP_TOKENS, d))
    xi[0, 0] = AP_MAX_ABS
    x = torch.from_numpy(xi.astype(np.float32)).to(dev)
    radix = 3
    width = apc.mac_acc_width(radix, d, AP_MAX_ABS)
    t0 = time.perf_counter()
    cyc = ap_matmul_cycle_counts(radix, d, width, k_tile=AP_K_TILE)
    compile_s = time.perf_counter() - t0
    st = APStats(radix=radix)
    torch.cuda.synchronize()
    with ProgramLaunches() as launches:
        t0 = time.perf_counter()
        y = ternary_matmul(x, p["w1_packed"], p["w1_scale"], impl="ap",
                           k_tile=AP_K_TILE, stats=st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(y, ternary_matmul(x, p["w1_packed"], p["w1_scale"],
                                        impl="ref")),
          "AP matmul not bit-identical to impl='ref'")
    # |acc| <= 7 * 1024 < 2^23, so acc -> fp32(acc * scale) is one-to-one:
    # y equal to the exact product times scale means acc equals it
    exact = x.double() @ unpack_ternary(p["w1_packed"], torch.float64)
    check(torch.equal(y, exact.float() * p["w1_scale"][None, :]),
          "AP matmul accumulator != exact integer product")
    check((st.n_write_cycles, st.n_compare_cycles)
          == (cyc["write_cycles"], cyc["compare_cycles"]),
          f"AP matmul cycles {st.n_write_cycles}/{st.n_compare_cycles} != "
          f"ap_matmul_cycle_counts {cyc}")
    res["ap_plain_replay"] = check_ap_launches(launches.calls, st, log)
    rep = energy_from_stats(st, n_masked=4, params=CellParams(radix=radix))
    res["ap"] = {"tokens": AP_TOKENS, "k": d, "n": f, "rows": AP_TOKENS * f,
                 "width": width, "k_tile": AP_K_TILE,
                 "n_tiles": cyc["n_tiles"], "steps": cyc["steps"],
                 "write_cycles": st.n_write_cycles,
                 "compare_cycles": st.n_compare_cycles, "sets": st.sets,
                 "resets": st.resets, "energy_j": rep.total_j,
                 "compile_s": compile_s, "wall_ms": wall_ms}
    log(f"  AP matmul qwen3-0.6b w1 M={AP_TOKENS} (rows {AP_TOKENS * f}, "
        f"width {width}, {cyc['n_tiles']} tiles of {AP_K_TILE} + reduction,"
        f" {cyc['steps']} steps): bit-identical to impl='ref' and to the "
        f"exact integer product; write/compare cycles {st.n_write_cycles}/"
        f"{st.n_compare_cycles} == ap_matmul_cycle_counts; sets "
        f"{st.sets} resets {st.resets}; Table XI energy "
        f"{rep.total_j * 1e9:.3f} nJ; host compile {compile_s:.3f} s, run "
        f"{wall_ms:.3f} ms (host clock, counters on, launches recorded)")
    return res


def check_ap_launches(calls: list[tuple], st, log) -> dict:
    """The AP matmul's own program-kernel launches: their counter rows sum
    to its ``APStats``, and the first tile program and the last reduction
    program, replayed on every row of their recorded inputs by the plain
    version, give the same digits and the same counter rows."""
    import torch
    from repro_torch.kernels.tap_pass import ref

    counts = torch.cat([c for *_, c in calls]).long().sum(dim=0).cpu()
    hist = tuple(int(h) for h in counts[2:])
    check((int(counts[0]), int(counts[1]), hist) ==
          (st.sets, st.resets, tuple(int(h) for h in st.mismatch_hist)),
          f"AP matmul: the launches' counter rows {counts.tolist()} do not "
          f"sum to APStats {st}")
    res = {}
    for label, (before, args, kw, out, counts) in (("tile0", calls[0]),
                                                     ("reduce", calls[-1])):
        t0 = time.perf_counter()
        want, want_counts = ref.run_program_plain(before, *args, **kw)
        plain_s = time.perf_counter() - t0
        e = max(int((out.int() - want.int()).abs().max()),
                int((counts.long() - want_counts.long()).abs().max()))
        res[label] = {"rows": args[-1], "cols": before.shape[1],
                      "slots": args[0].shape[0], "counter_rows":
                      counts.shape[0], "max_abs_err": e, "plain_s": plain_s}
        log(f"  AP matmul {label} launch ({args[-1]} rows, "
            f"{before.shape[1]} columns, {args[0].shape[0]} slots) replayed "
            f"by the plain version in {plain_s:.3f} s: digits and "
            f"{counts.shape[0]} counter rows max_abs_err={e}")
        check(e == 0, f"AP matmul {label} launch disagrees with the plain "
                      f"version")
    log(f"  AP matmul: {len(calls)} launches, counter rows sum to APStats "
        f"(sets {st.sets}, resets {st.resets}, hist {hist})")
    return res


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def registry_counts(names) -> dict[str, int]:
    from repro_torch.apc.metrics import get_registry
    return {k: get_registry().counter(k).value for k in names}


def phase_pool_path(dev, card: str, log) -> dict:
    """The array pool, the fault model, the graph runtime and power, on the
    card at the main paths' sizes."""
    import torch
    from repro_torch import apc
    from repro_torch.core import ap
    from repro_torch.core.energy import energy_from_stats
    from repro_torch.kernels.tap_pass import kernel
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.kernels.ternary_matmul.ap import ap_matmul_cycle_counts

    rng = np.random.default_rng(SEED + 8)
    res: dict = {"card": card}

    def launches() -> int:
        return kernel.launch_counts["tap_run_program"]

    # add 3x20 at 2^20 rows through ArrayPool(4, 4096, 256): 256 blocks
    r, w = 3, 20
    a, b, arr = named_operands("add", r, w, FULL_ROWS, rng)
    arr = torch.from_numpy(arr).to(dev)
    compiled = apc.compile_named("add", r, w)
    pool = apc.ArrayPool(*POOL_ADD, device=dev)
    st_pool, st_plain = ap.APStats(radix=r), ap.APStats(radix=r)
    n0 = launches()
    out_pool = apc.run(arr, compiled, stats=st_pool, pool=pool)
    torch.cuda.synchronize()
    n_launch = launches() - n0
    out_plain = apc.run(arr, compiled, stats=st_plain, device=dev)
    got = ap.decode_digits(out_pool.cpu().numpy(), list(range(w, 2 * w)), r)
    check(np.array_equal(got, (a + b) % r ** w), "pooled add 3x20 wrong")
    check(torch.equal(out_pool, out_plain),
          "pooled add 3x20 digits != apc.run without a pool")
    check(stats_fields(st_pool) == stats_fields(st_plain),
          f"pooled add 3x20 APStats {st_pool} != without a pool {st_plain}")
    check(n_launch == 1, f"pool.run launched the program kernel {n_launch} "
                         f"times, not once")
    _, traced = pool.run(arr, compiled, collect_stats=True)
    _, want = apc.execute(arr, compiled, collect_stats=True,
                          block_rows=POOL_ADD[1], device=dev)
    # 2^20 rows: 256 blocks of 4096 over 4 arrays, 64 waves
    n_blocks = FULL_ROWS // POOL_ADD[1]
    check(tuple(traced.block_counts.shape) == (n_blocks, 10),
          f"pool counter tensor {tuple(traced.block_counts.shape)}")
    check(torch.equal(traced.block_counts, want.block_counts),
          "pool counter rows != execute's at block_rows 4096")
    wall = pool.wall_cycles(FULL_ROWS, compiled.n_compare_cycles,
                            compiled.n_write_cycles)
    check(wall["waves"] == n_blocks // POOL_ADD[0],
          f"pool waves {wall['waves']} != {n_blocks // POOL_ADD[0]}")
    pool_ms = event_ms(lambda: pool.run(arr, compiled, collect_stats=True),
                       reps=5, inner=10)
    exec_ms = event_ms(lambda: apc.execute(arr, compiled, collect_stats=True,
                                           device=dev), reps=5, inner=10)
    run_pool_ms = host_ms(lambda: apc.run(arr, compiled,
                                          stats=ap.APStats(radix=r),
                                          pool=pool))
    run_plain_ms = host_ms(lambda: apc.run(arr, compiled,
                                           stats=ap.APStats(radix=r),
                                           device=dev))
    res["add3x20"] = {"rows": FULL_ROWS, "pool": POOL_ADD,
                      "blocks": n_blocks, "waves": wall["waves"],
                      "launches": n_launch, "reference_launches": n_blocks,
                      "pool_run_ms": pool_ms, "execute_ms": exec_ms,
                      "run_pool_ms": run_pool_ms,
                      "run_plain_ms": run_plain_ms}
    log(f"  add 3x20 rows={FULL_ROWS} through ArrayPool{POOL_ADD}: digits "
        f"and APStats == apc.run without a pool, {n_blocks} counter rows "
        f"== execute's, {wall['waves']} waves; program-kernel launches "
        f"{n_launch} (the reference: {n_blocks} pallas_calls); pool.run "
        f"{pool_ms:.6f} ms, execute {exec_ms:.6f} ms (CUDA events, "
        f"counters on); apc.run(pool=) {run_pool_ms:.3f} ms, apc.run "
        f"{run_plain_ms:.3f} ms (host clock, APStats); card {card}")

    # power: the pooled add's timeline against Table XI
    tl = apc.pool_power(pool, compiled, traced, radix=r, n_masked=3)
    st = ap.APStats(radix=r)
    apc.accumulate(st, traced, compiled, n_rows=FULL_ROWS)
    e_table = energy_from_stats(st, 3).total_j
    check(tl.total_energy_j() == e_table,
          f"pool_power {tl.total_energy_j()} J != Table XI {e_table} J")
    check(len(tl.intervals) == n_blocks, "pool_power intervals != blocks")
    res["power"] = {"energy_j": e_table, "intervals": len(tl.intervals),
                    "summary_peak_w": tl.summary()["peak_w"]}
    log(f"  pool_power on the pooled add: {len(tl.intervals)} intervals, "
        f"{tl.total_energy_j():.6e} J == Table XI energy of its APStats")

    # DevicePool over [cuda:0] and [cuda:0, cuda:0]: the shard sum
    for mesh in ([dev], [dev, dev]):
        dpool = apc.DevicePool(mesh, n_arrays=POOL_ADD[0], rows=POOL_ADD[1],
                               cols=POOL_ADD[2])
        st_d = ap.APStats(radix=r)
        out_d = apc.run(arr, compiled, stats=st_d, pool=dpool)
        check(torch.equal(out_d, out_plain),
              f"DevicePool x{len(mesh)} digits != apc.run")
        check(stats_fields(st_d) == stats_fields(st_plain),
              f"DevicePool x{len(mesh)} APStats {st_d} != {st_plain}")
        log(f"  DevicePool(mesh=[{dev}] x {len(mesh)}) add 3x20 rows="
            f"{FULL_ROWS}: digits and APStats == apc.run")
    del arr, out_pool, out_plain, out_d
    torch.cuda.empty_cache()

    # the AP matmul at qwen3-0.6b w1's width: pool=, runtime= and k_tile=
    d, f = QWEN3_06B
    packed, scale = packed_weights(d, f, rng, dev)
    xi = rng.integers(-AP_MAX_ABS, AP_MAX_ABS + 1, (AP_TOKENS, d))
    xi[0, 0] = AP_MAX_ABS
    x = torch.from_numpy(xi.astype(np.float32)).to(dev)
    width = apc.mac_acc_width(3, d, AP_MAX_ABS)
    cyc = ap_matmul_cycle_counts(3, d, width, k_tile=AP_K_TILE)
    y_ref = ternary_matmul(x, packed, scale, impl="ref")
    mac_pool = apc.ArrayPool(*POOL_MAC, device=dev)
    runtime = apc.Runtime(apc.ArrayPool(*POOL_MAC, device=dev))
    routes = {"k_tile": {"k_tile": AP_K_TILE}, "pool": {"pool": mac_pool},
              "runtime": {"runtime": runtime}}
    stats = {}
    res["ap_matmul"] = {"tokens": AP_TOKENS, "k": d, "n": f,
                        "rows": AP_TOKENS * f, "width": width,
                        "pool": POOL_MAC}
    for name, kw in routes.items():
        st = ap.APStats(radix=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = ternary_matmul(x, packed, scale, impl="ap", stats=st, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(y, y_ref),
              f"AP matmul {name}= not bit-identical to impl='ref'")
        check((st.n_write_cycles, st.n_compare_cycles)
              == (cyc["write_cycles"], cyc["compare_cycles"]),
              f"AP matmul {name}= cycles != ap_matmul_cycle_counts {cyc}")
        stats[name] = stats_fields(st)
        res["ap_matmul"][f"{name}_wall_ms"] = wall_ms
        log(f"  AP matmul qwen3-0.6b w1 M={AP_TOKENS} {name}=: "
            f"bit-identical to impl='ref', write/compare cycles "
            f"{st.n_write_cycles}/{st.n_compare_cycles} == "
            f"ap_matmul_cycle_counts(k_tile={AP_K_TILE}); wall {wall_ms:.3f}"
            f" ms (host clock, first call); card {card}")
    check(stats["pool"] == stats["k_tile"] == stats["runtime"],
          f"AP matmul APStats differ between routes: {stats}")
    rep = runtime.last_report
    res["ap_matmul"]["runtime_report"] = rep
    for name, kw in routes.items():
        res["ap_matmul"][f"{name}_ms"] = host_ms(
            lambda: ternary_matmul(x, packed, scale, impl="ap",
                                   stats=ap.APStats(radix=3), **kw))
    log(f"  AP matmul APStats equal on the k_tile=, pool= and runtime= "
        f"routes; runtime makespan {rep['makespan_cycles']} cycles "
        f"({rep['makespan_ns']:.1f} ns) against {rep['sequential_cycles']} "
        f"sequential ({rep['sequential_ns']:.1f} ns), {rep['n_nodes']} "
        f"nodes on {rep['n_arrays_total']} arrays; wall (host clock, "
        f"median of 3 after a warm-up): k_tile= "
        f"{res['ap_matmul']['k_tile_ms']:.3f} ms, pool= "
        f"{res['ap_matmul']['pool_ms']:.3f} ms, runtime= "
        f"{res['ap_matmul']['runtime_ms']:.3f} ms; card {card}")
    del packed, scale, y, y_ref
    torch.cuda.empty_cache()

    # block_valid: two MAC graphs whose rows are not multiples of 4096,
    # coalesced into row-concatenated launches, against each run alone
    K = COALESCE_K
    width = apc.mac_acc_width(3, K, AP_MAX_ABS)
    tiled = apc.compile_mac_tiled(3, K, width, AP_K_TILE,
                                  max_cols=POOL_MAC[2])
    graphs, finals, macs = [], [], []
    for n in COALESCE_ROWS:
        xm = rng.integers(-AP_MAX_ABS, AP_MAX_ABS + 1, (n, K))
        wm = rng.integers(-1, 2, (n, K))
        g = apc.ProgramGraph()
        finals.append(g.add_mac_tiled(torch.from_numpy(xm).to(dev),
                                      torch.from_numpy(wm).to(dev), tiled))
        graphs.append(g)
        macs.append((xm, wm))
    merged, maps = apc.coalesce_graphs(graphs, block_rows=POOL_MAC[1])
    bvs = [n.block_valid for n in merged.nodes if n.block_valid]
    check(bool(bvs), "coalesce_graphs built no block_valid launch")
    grt = apc.Runtime(apc.ArrayPool(*POOL_MAC, device=dev))
    n0 = launches()
    mres = grt.run_graph(merged, collect_stats=True)
    torch.cuda.synchronize()
    merged_launches = launches() - n0
    for g, mp, fin, (xm, wm) in zip(graphs, maps, finals, macs):
        alone = grt.run_graph(g, collect_stats=True)
        for nid in range(len(g)):
            sl = mp[nid]
            check(torch.equal(mres[sl.node][sl.res_lo:sl.res_hi],
                              alone[nid]),
                  f"coalesced slice of node {nid} digits != alone")
            check(torch.equal(mres.traced[sl.node].block_counts[
                sl.block_lo:sl.block_hi], alone.traced[nid].block_counts),
                f"coalesced slice of node {nid} counter rows != alone")
        acc = apc.decode_signed_digits_jnp(alone[fin], 3).cpu().numpy()
        check(np.array_equal(acc, (xm * wm).sum(axis=1)),
              "coalesced MAC graph: wrong dot products")
    res["coalesce"] = {"rows": COALESCE_ROWS, "k": K, "block_valid": bvs,
                       "merged_nodes": len(merged),
                       "merged_launches": merged_launches}
    log(f"  coalesce_graphs of MAC graphs with {COALESCE_ROWS} rows (K={K},"
        f" k_tile {AP_K_TILE}): {len(merged)} merged nodes, block_valid "
        f"{bvs}; each slice's digits and counter rows == its graph run "
        f"alone; {merged_launches} program-kernel launches")

    # faults: add 3x20 at 65536 rows on a faulty bank, card against CPU
    a, b, arr = named_operands("add", r, w, FAULT_ROWS, rng)
    counters = ("faults.detected", "faults.retries", "faults.retired",
                "faults.checksum_runs", "pool.launches")
    runs = []
    for where in (dev, torch.device("cpu")):
        fpool = apc.ArrayPool(4, POOL_ADD[1], 2 * w + 2, device=where,
                              faults=apc.FaultConfig(**FAULT_CFG))
        st = ap.APStats(radix=r)
        before = registry_counts(counters)
        t0 = time.perf_counter()
        out = apc.run(arr, compiled, stats=st, pool=fpool)
        secs = time.perf_counter() - t0
        after = registry_counts(counters)
        runs.append((out.cpu(), stats_fields(st),
                     fpool.fault_model.snapshot(),
                     {k: after[k] - before[k] for k in counters}, secs))
    clean = apc.run(arr, compiled, device=dev).cpu()
    (o_card, s_card, snap_card, c_card, t_card), \
        (o_cpu, s_cpu, snap_cpu, c_cpu, t_cpu) = runs
    check(torch.equal(o_card, clean) and torch.equal(o_cpu, clean),
          "faulty bank: digits != the fault-free run")
    check(s_card == s_cpu, f"faulty bank APStats card {s_card} != CPU "
                           f"{s_cpu}")
    check(snap_card == snap_cpu, f"fault snapshot card {snap_card} != CPU "
                                 f"{snap_cpu}")
    check(c_card == c_cpu, f"faults.* counters card {c_card} != CPU "
                           f"{c_cpu}")
    check(c_card["faults.detected"] >= 1 and c_card["faults.retries"] >= 1,
          f"faulty bank showed no detection and retry: {c_card}")
    res["faults"] = {"rows": FAULT_ROWS, "config": FAULT_CFG,
                     "snapshot": snap_card, "counters": c_card,
                     "card_s": t_card, "cpu_s": t_cpu}
    log(f"  faulty bank {FAULT_CFG} add 3x20 rows={FAULT_ROWS}: digits == "
        f"fault-free; APStats, snapshot {snap_card} and counters {c_card} "
        f"equal on the card and the CPU (host clock: card {t_card:.3f} s, "
        f"CPU {t_cpu:.3f} s)")
    return res


# ---------------------------------------------------------------------------
# Phase 3d: qwen3-0.6b at full width through the model stack
# ---------------------------------------------------------------------------

def dense_mlp_params(params: dict) -> dict:
    """The tree with every packed MLP unpacked to its float weights
    (``unpack(words) * scale``, fp32), so ``mlp()`` takes its dense branch:
    ``torch.matmul`` on the same function, the library baseline."""
    import torch
    from repro_torch.kernels.ternary_matmul.ref import unpack_ternary

    def unpack(packed, scale):
        if packed.dim() == 3:                        # stacked layers
            return torch.stack([unpack(p, s) for p, s in zip(packed, scale)])
        return unpack_ternary(packed) * scale[None, :]

    def walk(node):
        if not isinstance(node, dict):
            return node
        if "w1_packed" in node:
            return {k: unpack(node[f"{k}_packed"], node[f"{k}_scale"])
                    for k in ("w1", "w3", "w2")}
        return {k: walk(v) for k, v in node.items()}
    return walk(params)


def with_zeroed_w2_scale(params: dict, layer: int) -> dict:
    """A copy of the tree sharing every leaf but one layer's ``w2_scale``,
    which is zeroed (that layer's MLP adds nothing): a deliberate fault."""
    stack = params["stack"]["pos_0"]
    scale = stack["mlp"]["w2_scale"].clone()
    scale[layer] = 0
    return {**params, "stack": {"pos_0": {
        **stack, "mlp": {**stack["mlp"], "w2_scale": scale}}}}


def rel_err(y, want, tol: float) -> tuple[float, float]:
    """max |y - want| and the largest |y - want| / (tol·max|want| +
    tol·|want|): the check holds where the second is at most 1 (NaN fails,
    as inf)."""
    d = (y.float() - want.float()).abs()
    w = want.float().abs()
    ratio = d / (tol * float(w.max()) + tol * w)
    worst = float(ratio.max())
    return float(d.max()), (worst if worst == worst else float("inf"))


def matmul_launches() -> dict[str, int]:
    from repro_torch.kernels.ternary_matmul import kernel as tk
    return dict(tk.launch_counts)


def matmul_launches_since(before: dict[str, int]) -> dict[str, int]:
    return {k: n - before[k] for k, n in matmul_launches().items()}


def phase_model_path(dev, card: str, log) -> dict:
    """qwen3-0.6b at its published width through ``repro_torch.models``:
    a seeded, packed model; prefill and greedy serving on the kernel route,
    held against the plain route (``plain_packed_mlp()``) and decode against
    forward; times of the kernel, plain and dense routes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model, quant

    base = get_config(MODEL_ARCH)
    n_mlp = 3 * base.n_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    t0 = time.perf_counter()
    with torch.inference_mode():
        packed = quant.quantize_model_params(
            model.init_params(base, seed=SEED, device=dev))
        dense = dense_mlp_params(packed)
        torch.cuda.synchronize()
        res: dict = {"arch": MODEL_ARCH, "card": card,
                     "setup_s": time.perf_counter() - t0,
                     "n_params": base.n_params}
        log(f"  {MODEL_ARCH}: {base.n_layers} layers, d_model {base.d_model},"
            f" {base.n_heads} heads / {base.n_kv_heads} KV of "
            f"{base.head_dim_}, d_ff {base.d_ff}, vocab {base.vocab}, "
            f"{base.n_params} parameters; seeded, packed and unpacked to "
            f"dense in {res['setup_s']:.3f} s")
        b, s = PREFILL_SHAPE
        tokens = torch.randint(0, base.vocab, (b, s), generator=gen,
                               device=dev)
        sb, s_prompt, n_new, max_len = SERVE_SHAPE
        prompts = torch.randint(1, base.vocab, (sb, s_prompt), generator=gen,
                                device=dev)
        for name in ("float32", "bfloat16"):
            cfg = base.with_(compute_dtype=name)
            routes = {"kernel": model.cast_params(cfg, packed),
                      "dense": model.cast_params(cfg, dense)}
            res[name] = model_prefill(cfg, routes, tokens, n_mlp, card, log)
            res[name].update(model_serve(cfg, routes, prompts, n_new,
                                         max_len, n_mlp, card, log))
            del routes
            torch.cuda.empty_cache()
    return res


def model_prefill(cfg, routes, tokens, n_mlp, card, log) -> dict:
    """``forward`` at PREFILL_SHAPE on the kernel route (exactly ``n_mlp``
    tensor-core launches), against the plain route within MODEL_TOL; a
    zeroed ``w2_scale`` must fail that check; tokens/s of the kernel,
    plain and dense routes."""
    import torch
    from repro_torch.models import mlp, model
    name = cfg.compute_dtype
    tol = MODEL_TOL[name]
    batch = {"tokens": tokens}
    params = routes["kernel"]

    def fwd(p, plain=False):
        if plain:
            with mlp.plain_packed_mlp():
                return model.forward(cfg, p, batch)
        return model.forward(cfg, p, batch)

    before = matmul_launches()
    got = fwd(params)
    moved = matmul_launches_since(before)
    check(moved == {"ternary_matmul": 0, "ternary_matmul_tc": n_mlp},
          f"prefill {name}: launches {moved}, expected {n_mlp} "
          f"ternary_matmul_tc and no ternary_matmul")
    want = fwd(params, plain=True)
    check(tuple(got.shape) == (*tokens.shape, cfg.vocab)
          and bool(torch.isfinite(got).all()), f"prefill {name}: bad "
                                                f"logits")
    err, worst = rel_err(got, want, tol)
    faults = {layer: rel_err(fwd(with_zeroed_w2_scale(params, layer)),
                             want, tol) for layer in FAULT_LAYERS}
    d_err, d_worst = rel_err(fwd(routes["dense"]), want, tol)
    n_tok = tokens.numel()
    ms = {"kernel": event_ms(lambda: fwd(params), reps=3, inner=1),
          "plain": event_ms(lambda: fwd(params, plain=True), reps=3,
                            inner=1),
          "dense": event_ms(lambda: fwd(routes["dense"]), reps=3, inner=1)}
    res = {"prefill": {
        "tokens": list(tokens.shape), "launches": moved, "tol": tol,
        "max_abs_err": err, "worst_ratio": worst,
        "faults": {layer: {"max_abs_err": e, "worst_ratio": r}
                   for layer, (e, r) in faults.items()},
        "dense": {"max_abs_err": d_err, "worst_ratio": d_worst},
        "ms": ms, "tokens_per_s": {k: n_tok / (v / 1e3)
                                   for k, v in ms.items()}}}
    log(f"  prefill {name} B x S = {tokens.shape[0]} x {tokens.shape[1]} "
        f"(M = {n_tok}): {moved['ternary_matmul_tc']} ternary_matmul_tc "
        f"launches, logits vs plain route max_abs_err {err:.4e}, largest "
        f"|y - want| / ({tol}·max|want| + {tol}·|want|) = {worst:.4f} "
        f"(limit 1); zeroed w2_scale of layer "
        + ", ".join(f"{layer}: {r:.3f}" for layer, (_, r) in faults.items())
        + f" (layers {FAULT_GATES[name]} must exceed 1); dense route "
        f"{d_worst:.4f}")
    check(worst <= 1, f"prefill {name}: kernel route disagrees with the "
                      f"plain route")
    for layer in FAULT_GATES[name]:
        check(faults[layer][1] > 1, f"prefill {name}: a zeroed w2_scale in "
                                    f"layer {layer} passes the tolerance")
    for route, v in ms.items():
        log(f"  time prefill {name} {route} route {v:.3f} ms, "
            f"{n_tok / (v / 1e3):.0f} tokens/s (CUDA events, median of 3), "
            f"card {card}")
    return res


def model_serve(cfg, routes, prompts, n_new, max_len, n_mlp, card,
                log) -> dict:
    """The reference's serving recipe (``launch/serve.py`` defaults,
    ``Engine.prefill_step`` / ``decode_step``): the prompt one token a step
    through ``decode_step``, then greedy tokens, on the kernel route
    (exactly ``n_mlp`` CUDA-core launches a step); the plain route teacher-
    forced with its tokens, logits step for step within MODEL_TOL; the
    dense route likewise, timed; in fp32, ``forward`` on the whole sequence
    against every step's logits within DECODE_FWD_TOL."""
    import torch
    from repro_torch.models import mlp, model
    name = cfg.compute_dtype
    tol = MODEL_TOL[name]
    b, s_prompt = prompts.shape
    # the cache in the compute dtype: fp32 as in the reference's
    # decode-against-forward test, bf16 as in its Engine
    cache_dtype = torch.float32 if name == "float32" else torch.bfloat16
    n_steps = s_prompt + n_new - 1

    def serve(params, forced=None, plain=False):
        cache = model.init_cache(cfg, b, max_len, dtype=cache_dtype,
                                 device=prompts.device)
        logits, out, step_ms, launches = [], [], [], []
        tok = None
        for pos in range(n_steps):
            if pos < s_prompt:
                inp = prompts[:, pos]
            else:
                inp = tok if forced is None else forced[:, pos - s_prompt]
            torch.cuda.synchronize()
            before = matmul_launches()
            t0 = time.perf_counter()
            if plain:
                with mlp.plain_packed_mlp():
                    lg, cache = model.decode_step(cfg, params, cache, inp,
                                                  pos)
            else:
                lg, cache = model.decode_step(cfg, params, cache, inp, pos)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(matmul_launches_since(before))
            logits.append(lg)
            if pos >= s_prompt - 1:
                tok = lg.argmax(dim=-1)
                out.append(tok)
        return (torch.stack(logits, 1), torch.stack(out, 1),
                step_ms[s_prompt - 1:], launches)

    logits, gen, kernel_ms, launches = serve(routes["kernel"])
    want_moves = {"ternary_matmul": n_mlp, "ternary_matmul_tc": 0}
    bad = [i for i, m in enumerate(launches) if m != want_moves]
    check(not bad, f"serve {name}: steps {bad[:4]} launched "
                   f"{launches[bad[0]] if bad else None}, expected "
                   f"{want_moves} each")
    check(tuple(gen.shape) == (b, n_new)
          and bool(torch.isfinite(logits).all()),
          f"serve {name}: bad output")
    plain_logits, _, plain_ms, plain_moves = serve(routes["kernel"],
                                                    forced=gen, plain=True)
    check(all(m == {"ternary_matmul": 0, "ternary_matmul_tc": 0}
              for m in plain_moves), f"serve {name}: plain route launched")
    worst_steps = [rel_err(logits[:, i], plain_logits[:, i], tol)[1]
                   for i in range(n_steps)]
    err = float((logits.float() - plain_logits.float()).abs().max())
    dense_logits, _, dense_ms, _ = serve(routes["dense"], forced=gen)
    d_worst = max(rel_err(dense_logits[:, i], plain_logits[:, i], tol)[1]
                  for i in range(n_steps))
    agree = float((plain_logits[:, s_prompt - 1:].argmax(-1) == gen)
                  .float().mean())
    res = {"serve": {
        "batch": b, "prompt": s_prompt, "new": n_new, "max_len": max_len,
        "cache_dtype": str(cache_dtype).split(".")[1], "steps": n_steps,
        "launches_per_step": want_moves, "tol": tol, "max_abs_err": err,
        "worst_ratio": max(worst_steps), "dense_worst_ratio": d_worst,
        "plain_greedy_agreement": agree,
        "step_ms": {"kernel": kernel_ms, "plain": plain_ms,
                    "dense": dense_ms},
        "median_step_ms": {"kernel": statistics.median(kernel_ms),
                           "plain": statistics.median(plain_ms),
                           "dense": statistics.median(dense_ms)}}}
    log(f"  serve {name}: batch {b}, {s_prompt}-token prompts one token a "
        f"step, {n_new} greedy tokens, cache {max_len} x "
        f"{res['serve']['cache_dtype']}: {n_steps} steps of {n_mlp} "
        f"ternary_matmul launches; logits vs the plain route teacher-"
        f"forced max_abs_err {err:.4e}, largest ratio {max(worst_steps):.4f}"
        f" (limit 1); dense route {d_worst:.4f}; plain greedy picks the "
        f"kernel route's token at {agree:.3f} of the steps")
    check(max(worst_steps) <= 1, f"serve {name}: kernel route disagrees "
                                 f"with the plain route")
    # the device's time of one step alone: a CUDA graph of it, on a cache
    # of its own (the step writes its slot in place)
    tok = gen[:, -1]
    device_ms = {}
    for route in ("kernel", "dense"):
        scratch = model.init_cache(cfg, b, max_len, dtype=cache_dtype,
                                   device=prompts.device)
        device_ms[route] = graph_ms(lambda: model.decode_step(
            cfg, routes[route], scratch, tok, n_steps), reps=5, inner=2)
    res["serve"]["step_device_ms"] = device_ms
    scratch = model.init_cache(cfg, b, max_len, dtype=cache_dtype,
                               device=prompts.device)
    res["serve"]["step_profile"] = profile_step(lambda: model.decode_step(
        cfg, routes["kernel"], scratch, tok, n_steps),
        f"decode {name} kernel route", card, log)
    for route, v in res["serve"]["median_step_ms"].items():
        dev_part = (f"; the device alone {device_ms[route]:.3f} ms (a CUDA "
                    f"graph of the step), {100 * device_ms[route] / v:.1f} %"
                    if route in device_ms else "")
        log(f"  time decode {name} {route} route {v:.3f} ms per step "
            f"(host clock around a synchronised step, median of "
            f"{len(kernel_ms)}){dev_part}, batch {b}, card {card}")
    if name == "float32":
        seq = torch.cat([prompts, gen], dim=1)
        before = matmul_launches()
        fwd = model.forward(cfg, routes["kernel"], {"tokens": seq})
        moved = matmul_launches_since(before)
        d_err, d_worst = rel_err(logits, fwd[:, :n_steps], DECODE_FWD_TOL)
        res["serve"]["decode_vs_forward"] = {
            "tokens": list(seq.shape), "launches": moved,
            "tol": DECODE_FWD_TOL, "max_abs_err": d_err,
            "worst_ratio": d_worst}
        log(f"  decode vs forward {name}: forward on {tuple(seq.shape)} "
            f"({moved}) against the {n_steps} decode steps' logits, "
            f"max_abs_err {d_err:.4e}, largest |y - want| / "
            f"({DECODE_FWD_TOL}·max|want| + {DECODE_FWD_TOL}·|want|) = "
            f"{d_worst:.4f} (limit 1)")
        check(d_worst <= 1, "decode steps disagree with forward")
    return res

# ---------------------------------------------------------------------------
# Phase 3e: AP-backed serving of qwen3-0.6b through the program kernel
# ---------------------------------------------------------------------------

class APProbe:
    """Instruments phase 3e without touching the port: CUDA events around
    every program-kernel launch of the array pool (the kernel's device
    time: the queue stays full while the host enqueues, so an event pair
    brackets one launch's own work), and the host time of every
    ``APServeContext.linear`` call (an ``APLinear`` built again: unpack,
    host copy, support, digest, pin), each taken after a synchronize so
    that it holds host work only."""

    def __init__(self, dev):
        import threading
        import torch
        from repro_torch.apc import layers, pool as pool_mod
        self.dev = dev
        self.lock = threading.Lock()
        self.events: list = []
        self.builds: list = []
        # the first launch of each kind, for a replay by the plain version:
        # "solo reduction" (one request's first fold node, the cheaper
        # replay) and "merged" (a wave's, block_valid: a tile program)
        self.kept: dict[str, tuple] = {}
        self._pool_mod, self._layers = pool_mod, layers
        self._launch = pool_mod.tap_run_program
        self._linear = layers.APServeContext.linear
        probe = self

        def launch(padded, *a, **kw):
            if kw.get("block_valid") is not None:
                kind = "merged"
            elif a[0].shape[0] < MAC_TILE_MIN_SLOTS:
                kind = "solo reduction"
            else:
                kind = None
            keep = kind is not None and kind not in probe.kept
            before = padded.clone() if keep else None
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = probe._launch(padded, *a, **kw)
            end.record()
            with probe.lock:
                probe.events.append((start, end))
                if keep:
                    probe.kept[kind] = (before, a, kw, *out)
            return out

        def linear(ctx, *a, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = probe._linear(ctx, *a, **kw)
            t1 = time.perf_counter()
            with probe.lock:
                probe.builds.append((t0, t1))
            return out

        pool_mod.tap_run_program = launch
        layers.APServeContext.linear = linear

    def take(self) -> dict:
        """Since the last take: program-kernel launches and their device
        ms (synchronizes), ``APLinear`` builds, the host ms they took
        summed over threads, and the wall ms of their union (threads of a
        wave build at once)."""
        import torch
        torch.cuda.synchronize(self.dev)
        with self.lock:
            events, self.events = self.events, []
            builds, self.builds = sorted(self.builds), []
        wall, end = 0.0, None
        for t0, t1 in builds:
            if end is None or t0 > end:
                wall += t1 - t0
                end = t1
            elif t1 > end:
                wall += t1 - end
                end = t1
        return {"launches": len(events),
                "kernel_ms": sum(s.elapsed_time(e) for s, e in events),
                "rebuilds": len(builds),
                "rebuild_ms": 1e3 * sum(t1 - t0 for t0, t1 in builds),
                "rebuild_wall_ms": 1e3 * wall}

    def close(self) -> None:
        self._pool_mod.tap_run_program = self._launch
        self._layers.APServeContext.linear = self._linear

    def replay_kept(self, card: str, log) -> dict:
        """The kept launches replayed by the plain version on the card:
        digits and counter rows equal (tolerance: none)."""
        import torch
        from repro_torch.kernels.tap_pass import ref
        res = {}
        for kind, (before, args, kw, out, counts) in self.kept.items():
            t0 = time.perf_counter()
            want, want_counts = ref.run_program_plain(before, *args, **kw)
            torch.cuda.synchronize(self.dev)
            e = max(int((out.int() - want.int()).abs().max()),
                    int((counts.long() - want_counts.long()).abs().max()))
            bv = kw.get("block_valid")
            res[kind] = {"rows": before.shape[0], "cols": before.shape[1],
                         "slots": args[0].shape[0],
                         "block_valid": (None if bv is None
                                         else bv.tolist()),
                         "max_abs_err": e,
                         "plain_s": time.perf_counter() - t0}
            log(f"  the first {kind} program launch of AP serving "
                f"({before.shape[0]} rows, {before.shape[1]} columns, "
                f"{args[0].shape[0]} slots, block_valid "
                f"{res[kind]['block_valid']}) replayed by the plain version"
                f" in {res[kind]['plain_s']:.3f} s (card {card}): digits and "
                f"{counts.shape[0]} counter rows max_abs_err={e}")
            check(e == 0, f"AP serving: the {kind} program launch "
                          f"disagrees with the plain version")
        check(set(res) == {"solo reduction", "merged"},
              f"AP serving kept launches {sorted(res)}")
        return res


def ap_engine(cfg, params, dev, pool=None, max_len=None):
    """An AP-backed Engine on ``dev``: ArrayPool ``pool`` (default
    AP_SERVE_POOL), x_levels AP_SERVE_X_LEVELS."""
    from repro_torch import apc
    from repro_torch.serve import Engine, ServeCfg
    pool = AP_SERVE_POOL if pool is None else pool
    ctx = apc.APServeContext(apc.Runtime(apc.ArrayPool(*pool, device=dev)),
                             x_levels=AP_SERVE_X_LEVELS)
    return Engine(cfg, params, ServeCfg(
        max_len=AP_SERVE_MAX_LEN if max_len is None else max_len),
        ap_ctx=ctx, device=dev)


def record_steps(eng, rec: list, probe: APProbe | None = None):
    """Wrap ``eng._step``: each model step synchronized, its host ms, the
    probe's reading, the packed-matmul launches it made and its logits
    appended to ``rec``.  Returns the original step."""
    import torch
    orig = eng._step

    def step(*a):
        if probe is not None:
            probe.take()
        before = matmul_launches()
        torch.cuda.synchronize(eng.device)
        t0 = time.perf_counter()
        logits, cache = orig(*a)
        torch.cuda.synchronize(eng.device)
        host = 1e3 * (time.perf_counter() - t0)
        rec.append(dict(probe.take() if probe is not None else {},
                        host_ms=host, logits=logits.clone(),
                        matmul=matmul_launches_since(before)))
        return logits, cache

    eng._step = step
    return orig


def record_waves(srv, probe, rec: list) -> None:
    """Wrap a BatchServer's ``_run_wave`` (before any submit): each wave's
    width, host ms and the probe's reading appended to ``rec``."""
    orig = srv._run_wave

    def run_wave(reg):
        width = sum(not a.request.done for a in srv._active)
        probe.take()
        t0 = time.perf_counter()
        orig(reg)
        rec.append(dict(probe.take(), width=width,
                        host_ms=1e3 * (time.perf_counter() - t0)))

    srv._run_wave = run_wave


def phase_ap_serve_path(dev, card: str, log) -> dict:
    """qwen3-0.6b at its published width and depth with every MLP
    projection on the AP: the program kernel over the pool of phase 3c,
    sequential and batched, held against ``plain_ap_projections()`` bit for
    bit; the batched route against the sequential; a wave of four; MoE
    dispatch on the card against the CPU; the same engine's float route."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model, quant

    cfg = get_config(MODEL_ARCH).with_(compute_dtype="float32")
    n_graphs_step = 2 * cfg.n_layers
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED + 11)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.cast_params(cfg, quant.quantize_model_params(
            model.init_params(cfg, seed=SEED, device=dev)))
    torch.cuda.synchronize()
    res: dict = {"arch": MODEL_ARCH, "card": card, "pool": AP_SERVE_POOL,
                 "x_levels": AP_SERVE_X_LEVELS,
                 "setup_s": time.perf_counter() - t0}
    s_prompt, n_new = AP_SERVE_REQUEST
    n_steps = s_prompt + n_new - 1
    prompts = [torch.randint(1, cfg.vocab, (1, s_prompt), generator=gen)
               .numpy().astype(np.int32) for _ in range(AP_SERVE_N_SEQ)]
    log(f"  {MODEL_ARCH} fp32, {cfg.n_layers} layers, d_model {cfg.d_model},"
        f" d_ff {cfg.d_ff}, packed MLPs from seed {SEED}; every MLP "
        f"projection on the AP: ArrayPool{AP_SERVE_POOL}, x_levels "
        f"{AP_SERVE_X_LEVELS}; {AP_SERVE_N_SEQ} requests of a {s_prompt}-"
        f"token prompt and {n_new} new tokens ({n_steps} model steps each)")
    probe = APProbe(dev)
    try:
        eng = ap_engine(cfg, params, dev)
        res["sequential"] = ap_sequential(eng, probe, prompts, n_new,
                                          n_graphs_step, card, log)
        res["batched"] = ap_batched(eng, probe, prompts, n_new,
                                    res["sequential"], card, log)
        res["wave1"] = ap_wave(eng, probe, gen, 1, n_graphs_step, card,
                               log)
        res["wave4"] = ap_wave(eng, probe, gen, 4, n_graphs_step, card,
                               log)
    finally:
        probe.close()
    res["plain_replay"] = probe.replay_kept(card, log)
    res["wave_width"] = ap_wave_table(res, card, log)
    res["moe"] = ap_moe_card_vs_cpu(dev, card, log)
    res["float_route"] = float_route(cfg, params, dev, card, log)
    return res


def ap_sequential(eng, probe, prompts, n_new, n_graphs_step, card,
                  log) -> dict:
    """Engine.generate per request on the AP route, then again under
    plain_ap_projections(): every step's logits bit-identical, 2 graphs a
    layer a step, one program-kernel launch per graph node, no
    packed-matmul launch."""
    import torch
    from repro_torch.apc.layers import plain_ap_projections
    from repro_torch.kernels.tap_pass import kernel
    out = {"requests": []}
    for i, prompt in enumerate(prompts):
        steps: list = []
        orig = record_steps(eng, steps, probe)
        launches0 = kernel.launch_counts["tap_run_program"]
        t0 = time.perf_counter()
        toks = eng.generate(prompt, n_new)
        wall = time.perf_counter() - t0
        launched = kernel.launch_counts["tap_run_program"] - launches0
        rep = eng.ap_report()
        plain: list = []
        eng._step = orig
        record_steps(eng, plain, probe)
        with plain_ap_projections():
            plain_toks = eng.generate(prompt, n_new)
        eng._step = orig
        n_steps = len(steps)
        same = [bool(torch.equal(a["logits"], b["logits"]))
                for a, b in zip(steps, plain)]
        diff = max(float((a["logits"] - b["logits"]).abs().max())
                   for a, b in zip(steps, plain))
        mm = [s["matmul"] for s in steps]
        r = {"prompt": prompt.tolist(), "tokens": toks.tolist(),
             "wall_s": wall, "n_graphs": rep["n_graphs"],
             "n_programs": rep["n_programs"], "launches": launched,
             "write_cycles": rep["write_cycles"],
             "compare_cycles": rep["compare_cycles"],
             "sets": rep["sets"], "resets": rep["resets"],
             "energy_total_j": rep["energy_total_j"],
             "energy_per_token_j": rep["energy_total_j"] / n_new,
             "power_energy_j": rep["power"]["energy_j"],
             "makespan_cycles": rep["makespan_cycles"],
             "sequential_cycles": rep["sequential_cycles"],
             "makespan_ns": rep["makespan_ns"],
             "sequential_ns": rep["sequential_ns"],
             "makespan_share": (rep["makespan_cycles"]
                                / max(1, rep["sequential_cycles"])),
             "resident": rep["cache"].get("resident"),
             "linears": rep["cache"]["linears"],
             "plain_equal": same, "plain_max_abs_diff": diff,
             "plain_tokens": plain_toks.tolist(),
             "steps": [{k: v for k, v in s.items() if k != "logits"}
                       for s in steps],
             "plain_step_ms": [s["host_ms"] for s in plain],
             "report": {k: v for k, v in rep.items()
                        if k not in ("cache", "latency", "power")}}
        out["requests"].append(r)
        for j, s in enumerate(steps):
            log(f"  request {i} step {j}: {s['host_ms']:.1f} ms host clock, "
                f"{s['launches']} program-kernel launches taking "
                f"{s['kernel_ms']:.1f} ms on the device (CUDA events), "
                f"host share {100 * (1 - s['kernel_ms'] / s['host_ms']):.1f}"
                f" %, of it {s['rebuilds']} APLinear builds "
                f"{s['rebuild_ms']:.1f} ms (host clock, after a "
                f"synchronize); packed-matmul launches "
                f"{s['matmul']}; card {card}")
        log(f"  request {i}: tokens {toks.tolist()}, {rep['n_graphs']} "
            f"graphs, {rep['n_programs']} programs, {launched} program-"
            f"kernel launches; write cycles {rep['write_cycles']}, compare "
            f"cycles {rep['compare_cycles']}, sets {rep['sets']}, resets "
            f"{rep['resets']}; Table XI {rep['energy_total_j']:.6e} J "
            f"({rep['energy_total_j'] / n_new:.6e} J per generated token); "
            f"makespan {rep['makespan_cycles']} of {rep['sequential_cycles']}"
            f" sequential cycles ({r['makespan_share']:.4f}); "
            f"logits vs plain_ap_projections() bit-identical at "
            f"{sum(same)} of {n_steps} steps (max |diff| {diff}); "
            f"plain route {statistics.median(r['plain_step_ms']):.1f} ms a "
            f"step (card {card}); resident store {r['resident']}")
        check(all(same) and np.array_equal(toks, plain_toks),
              f"AP serving request {i}: logits differ from "
              f"plain_ap_projections() (max |diff| {diff})")
        check(rep["n_graphs"] == n_graphs_step * n_steps,
              f"AP serving request {i}: n_graphs {rep['n_graphs']}, "
              f"expected {n_graphs_step * n_steps}")
        check(launched == rep["n_programs"] == sum(s["launches"]
                                                   for s in steps),
              f"AP serving request {i}: {launched} program-kernel launches "
              f"for {rep['n_programs']} graph nodes")
        check(all(m == {"ternary_matmul": 0, "ternary_matmul_tc": 0}
                  for m in mm), f"AP serving request {i}: a step launched "
                                f"a packed-matmul kernel: {mm}")
        check(toks.shape == (1, n_new), f"AP serving request {i}: tokens "
                                        f"{toks.shape}")
        check(rep["power"]["energy_j"] == rep["energy_total_j"],
              f"AP serving request {i}: power rollup "
              f"{rep['power']['energy_j']} J against Table XI "
              f"{rep['energy_total_j']} J")
    return out


AP_PARITY = ("sets", "resets", "compare_cycles", "write_cycles",
             "energy_total_j", "n_graphs", "n_programs", "makespan_cycles",
             "sequential_cycles", "makespan_ns", "sequential_ns")


def ap_batched(eng, probe, prompts, n_new, seq, card, log) -> dict:
    """The same requests through BatchServer(max_inflight=4): one wave per
    model step, tokens and every compared report field (and the power
    rollup's energy) equal to the sequential run."""
    from repro_torch.serve import AdmissionCfg, BatchServer
    waves: list = []
    t0 = time.perf_counter()
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=4)) as srv:
        record_waves(srv, probe, waves)
        handles = [srv.submit(p, n_new) for p in prompts]
        results = [(h.result(timeout=900), h.ap_report()) for h in handles]
    wall = time.perf_counter() - t0
    out = {"wall_s": wall, "waves": waves, "requests": []}
    for i, ((toks, rep), want) in enumerate(zip(results, seq["requests"])):
        fields = {k: rep[k] for k in AP_PARITY}
        diff = [k for k in AP_PARITY if rep[k] != want["report"][k]]
        out["requests"].append({"tokens": toks.tolist(), "report": fields,
                                "power_energy_j": rep["power"]["energy_j"],
                                "differs": diff})
        log(f"  batched request {i}: tokens {toks.tolist()} (sequential "
            f"{want['tokens']}); report fields that differ from the "
            f"sequential run: {diff or 'none'}; power rollup "
            f"{rep['power']['energy_j']:.6e} J")
        check(toks.tolist() == want["tokens"] and not diff
              and rep["power"]["energy_j"] == want["power_energy_j"],
              f"batched request {i} differs from sequential serving: {diff}")
    for w in waves:
        log(f"  {wave_line(w, card)}")
    return out


def wave_line(w: dict, card: str) -> str:
    return (f"wave of width {w['width']}: {w['host_ms']:.1f} ms host clock, "
            f"{w['launches']} program-kernel launches taking "
            f"{w['kernel_ms']:.1f} ms on the device (CUDA events), "
            f"{w['rebuilds']} APLinear builds taking {w['rebuild_ms']:.1f} "
            f"ms over the threads, {w['rebuild_wall_ms']:.1f} ms of wall; "
            f"card {card}")


def ap_wave(eng, probe, gen, width: int, n_graphs_step, card, log) -> dict:
    """``width`` requests of one token and one new token through the
    BatchServer: one wave, every graph call merged across them (and, as in
    every merged graph, like tile nodes merged within each)."""
    import torch
    from repro_torch.serve import AdmissionCfg, BatchServer
    prompts = [torch.randint(1, eng.cfg.vocab, (1, 1), generator=gen)
               .numpy().astype(np.int32) for _ in range(width)]
    waves: list = []
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=4)) as srv:
        record_waves(srv, probe, waves)
        handles = [srv.submit(p, 1) for p in prompts]
        results = [(h.result(timeout=900), h.ap_report()) for h in handles]
    check(len(waves) == 1 and waves[0]["width"] == width,
          f"wave of {width}: waves {[w['width'] for w in waves]}")
    for toks, rep in results:
        check(toks.shape == (1, 1) and rep["n_graphs"] == n_graphs_step,
              f"wave of {width}: tokens {toks.shape}, n_graphs "
              f"{rep['n_graphs']}")
    w = waves[0]
    log(f"  {wave_line(w, card)}; tokens "
        f"{[t.tolist() for t, _ in results]}; programs per request "
        f"{results[0][1]['n_programs']}")
    return {"wave": w, "tokens": [t.tolist() for t, _ in results],
            "n_programs": [rep["n_programs"] for _, rep in results]}


def ap_wave_table(res: dict, card: str, log) -> dict:
    """Median host and program-kernel ms per model step: sequential steps
    (Engine.generate, no merging), and waves of widths 1, 2 and 4 through
    the BatchServer (graphs merged)."""
    rows = {"sequential": [s for r in res["sequential"]["requests"]
                           for s in r["steps"]],
            "wave 1": [res["wave1"]["wave"]],
            "wave 2": [w for w in res["batched"]["waves"]
                       if w["width"] == 2],
            "wave 4": [res["wave4"]["wave"]]}
    table = {}
    for name, xs in rows.items():
        if not xs:
            continue
        table[name] = {k: statistics.median(x[k] for x in xs) for k in
                       ("host_ms", "kernel_ms", "launches", "rebuild_ms",
                        "rebuild_wall_ms")}
        t = table[name]
        log(f"  {name}: {t['host_ms']:.1f} ms host clock a step (median of "
            f"{len(xs)}), program kernel {t['kernel_ms']:.1f} ms on the "
            f"device over {t['launches']:.0f} launches, host share "
            f"{100 * (1 - t['kernel_ms'] / t['host_ms']):.1f} %, APLinear "
            f"builds {t['rebuild_wall_ms']:.1f} ms of wall "
            f"({t['rebuild_ms']:.1f} ms over the threads); card {card}")
    return table


def ap_moe_card_vs_cpu(dev, card: str, log) -> dict:
    """qwen3-moe-30b-a3b's smoke config at 2 layers and the CPU tests'
    tiny widths (tests/test_torch_serve.py), fp32 compute, every expert
    projection through ap_moe_dispatch: the same seeded weights (drawn on
    the CPU) on the card and on the CPU, equal tokens and APStats."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import MoECfg
    from repro_torch.models import model
    base = get_smoke_config("qwen3-moe-30b-a3b")
    cfg = base.with_(n_layers=2, d_model=16, n_heads=2, n_kv_heads=2,
                     head_dim=8, vocab=32, compute_dtype="float32",
                     moe=MoECfg(n_experts=4, top_k=2, d_ff=24))
    prompt, n_new = np.array([[3, 5]], np.int32), 2
    n_graphs = 2 * cfg.n_layers * (prompt.shape[1] + n_new - 1)
    cpu = torch.device("cpu")
    weights = model.cast_params(cfg, model.init_params(cfg, seed=SEED,
                                                       device=cpu))
    out = {}
    for name, where in (("card", dev), ("cpu", cpu)):
        params = model._tree_map(lambda t, _: t.to(where), weights)
        eng = ap_engine(cfg, params, where, pool=AP_SERVE_MOE_POOL,
                        max_len=8)
        t0 = time.perf_counter()
        toks = eng.generate(prompt, n_new)
        st = eng.ap_ctx.stats
        out[name] = {"tokens": toks.tolist(),
                           "stats": stats_fields(st),
                           "n_graphs": eng.ap_ctx.n_graphs,
                           "s": time.perf_counter() - t0}
    card_run, cpu_run = out["card"], out["cpu"]
    log(f"  MoE ({cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, 2 "
        f"layers, ArrayPool{AP_SERVE_MOE_POOL}): card tokens "
        f"{card_run['tokens']} in {card_run['s']:.2f} s, CPU "
        f"{cpu_run['tokens']} in {cpu_run['s']:.2f} s; APStats equal: "
        f"{card_run['stats'] == cpu_run['stats']}; {card_run['n_graphs']} "
        f"graphs; card {card}")
    check(card_run["tokens"] == cpu_run["tokens"]
          and card_run["stats"] == cpu_run["stats"]
          and card_run["n_graphs"] == cpu_run["n_graphs"] == n_graphs,
          "MoE AP serving: the card and the CPU disagree")
    return out


def float_route(cfg, params, dev, card, log) -> dict:
    """The engine without an AP context at launch/serve.py's defaults: the
    packed-matmul kernels, 84 CUDA-core launches a step, tokens equal to a
    direct decode_step loop on the same params."""
    import torch
    from repro_torch.models import model
    from repro_torch.serve import Engine, ServeCfg
    b, s_prompt, n_new, max_len = SERVE_SHAPE
    n_mlp = 3 * cfg.n_layers
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED + 12)
    prompts = torch.randint(1, cfg.vocab, (b, s_prompt), generator=gen) \
        .numpy().astype(np.int32)
    eng = Engine(cfg, params, ServeCfg(max_len=max_len), device=dev)
    steps: list = []
    record_steps(eng, steps)
    t0 = time.perf_counter()
    toks = eng.generate(prompts, n_new)
    wall = time.perf_counter() - t0
    cache = model.init_cache(cfg, b, max_len, device=dev)
    want, tok = [], None
    with torch.no_grad():
        for pos in range(s_prompt + n_new - 1):
            inp = torch.from_numpy(prompts[:, pos]).to(dev).long() \
                if pos < s_prompt else tok
            logits, cache = model.decode_step(cfg, params, cache, inp, pos)
            if pos >= s_prompt - 1:
                tok = logits.argmax(-1)
                want.append(tok)
    want = torch.stack(want, 1).cpu().numpy()
    moves = [s["matmul"] for s in steps]
    ms = statistics.median(s["host_ms"] for s in steps)
    res = {"batch": b, "prompt": s_prompt, "new": n_new, "max_len": max_len,
           "wall_s": wall, "median_step_ms": ms,
           "tokens_per_s": b * n_new / wall,
           "launches_per_step": moves[0], "equal_to_loop":
           bool(np.array_equal(toks, want))}
    log(f"  float route (no ap_ctx), batch {b}, {s_prompt}-token prompts, "
        f"{n_new} new tokens, cache {max_len}: {ms:.2f} ms a step (host "
        f"clock, synchronized, median of {len(steps)}), {b * n_new / wall:.1f}"
        f" tokens/s over generate(); launches a step {moves[0]}; tokens "
        f"equal to a decode_step loop: {res['equal_to_loop']}; card {card}")
    want_moves = {"ternary_matmul": n_mlp, "ternary_matmul_tc": 0}
    check(all(m == want_moves for m in moves),
          f"float route: launches {moves[:3]}, expected {want_moves} a step")
    check(res["equal_to_loop"], "float route: tokens differ from a direct "
                                "decode_step loop")
    return res


# ---------------------------------------------------------------------------
# Phase 3f: training, qwen3-0.6b
# ---------------------------------------------------------------------------

def train_tmpdir() -> str:
    """A fresh directory for checkpoints under the checkout's build/."""
    import tempfile
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="chip_smoke_train_", dir=base)


def train_batch(cfg, batch: int, seq: int, step: int, seed: int, dev):
    import torch
    from repro_torch.data import DataCfg, TokenSource
    arrays = TokenSource(DataCfg(vocab=cfg.vocab, global_batch=batch,
                                 seq_len=seq, seed=seed)).batch_at(step)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def timed_step(step, state, batch) -> tuple:
    """(state, metrics, host ms, loss) of one step: host clock from a
    synchronised start to the loss on the host."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    return state, metrics, (time.perf_counter() - t0) * 1e3, loss


def phase_train_path(dev, card: str, log) -> dict:
    """qwen3-0.6b training at its published width: (a) the launcher at
    full depth, a fixed batch, the three remat policies; (b) a step on the
    card against the CPU; (c) resume exactness; (d) compressed DP."""
    import torch
    from repro_torch.configs import get_config
    torch.cuda.init()                # the allocator, for its peak counters
    base = get_config(MODEL_ARCH)
    res: dict = {"arch": MODEL_ARCH, "card": card}
    res["launcher"] = train_launcher(base, dev, card, log)
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = train_card_vs_cpu(base, dev, card, log)
    torch.cuda.empty_cache()
    res["resume"] = train_resume(base, dev, card, log)
    torch.cuda.empty_cache()
    res["compressed_dp"] = train_compressed_dp(base, dev, card, log)
    torch.cuda.empty_cache()
    return res


def train_launcher(base, dev, card: str, log) -> dict:
    """(a) ``launch.train.main`` at its defaults for TRAIN_STEPS steps at
    full width and depth (bf16 compute, remat "dots"), then
    TRAIN_FIXED_STEPS on one batch, then one step at each remat policy."""
    import shutil
    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    b, s = TRAIN_SHAPE
    ckpt = train_tmpdir()
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        summary = launch_train.main(["--arch", MODEL_ARCH, "--steps",
                                     str(TRAIN_STEPS), "--ckpt-dir", ckpt])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        check(not os.listdir(ckpt), "the launcher saved a checkpoint")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = summary["losses"]
    check(len(losses) == TRAIN_STEPS and all(
        np.isfinite(x) for x in losses), f"launcher losses {losses}")
    state = ts.init_train_state(base, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in opt.tree_leaves(state["params"]))
    ms = statistics.median(summary["step_seconds"][TRAIN_TIMED]) * 1e3
    tokens = b * s
    flops = 6 * n_params * tokens
    bound_ms = flops / PEAK_BF16_FLOP_PER_S * 1e3
    res = {"steps": TRAIN_STEPS, "batch": b, "seq": s,
           "n_params": n_params, "losses": losses, "wall_s": wall,
           "step_ms": [x * 1e3 for x in summary["step_seconds"]],
           "ms": ms, "tokens_per_s": tokens / (ms / 1e3),
           "peak_bytes": peak, "model_flops": flops, "bound_ms": bound_ms,
           "flops_share": bound_ms / ms,
           "stragglers": summary["stragglers"]}
    log(f"  launcher: {MODEL_ARCH} {base.n_layers} layers, d_model "
        f"{base.d_model}, vocab {base.vocab}, {n_params} parameters "
        f"(fp32 master, {base.compute_dtype} compute, remat "
        f"{base.remat}), batch {b} x {s}, {TRAIN_STEPS} steps in "
        f"{wall:.3f} s: first loss {losses[0]:.4f} (ln {base.vocab} = "
        f"{np.log(base.vocab):.4f}), last {losses[-1]:.4f}, stragglers "
        f"{summary['stragglers']}")
    log(f"  time train step {ms:.3f} ms (host clock, synchronised, median "
        f"of steps 3-{TRAIN_STEPS}), {res['tokens_per_s']:.0f} tokens/s, "
        f"peak memory {peak / 2**30:.3f} GiB, model FLOPs 6·N·tokens = "
        f"{flops:.4e}: bound {bound_ms:.3f} ms at "
        f"{PEAK_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16, FLOPs share "
        f"{100 * res['flops_share']:.2f} %, card {card}")

    opt_cfg = opt.AdamWCfg(lr=3e-4, total_steps=TRAIN_FIXED_STEPS,
                           warmup_steps=1)
    step = ts.make_train_step(base, opt_cfg)
    batch = train_batch(base, b, s, 0, SEED, dev)
    fixed = []
    st = state
    for _ in range(TRAIN_FIXED_STEPS):
        st, _, _, loss = timed_step(step, st, batch)
        fixed.append(loss)
    del st
    res["fixed_batch_losses"] = fixed
    log(f"  fixed batch, {TRAIN_FIXED_STEPS} steps: loss "
        + " ".join(f"{x:.4f}" for x in fixed) + f", card {card}")
    check(all(np.isfinite(x) for x in fixed) and fixed[-1] < fixed[0],
          f"the fixed-batch loss did not fall: {fixed}")

    res["remat"] = {}
    for remat in ("none", "dots", "full"):
        step = ts.make_train_step(base.with_(remat=remat), opt_cfg)
        torch.cuda.reset_peak_memory_stats(dev)
        _, _, ms_r, loss = timed_step(step, state, batch)
        peak_r = torch.cuda.max_memory_allocated(dev)
        res["remat"][remat] = {"ms": ms_r, "peak_bytes": peak_r,
                               "loss": loss}
        log(f"  remat {remat}: one step {ms_r:.3f} ms (host clock, "
            f"synchronised), peak memory {peak_r / 2**30:.3f} GiB (the "
            f"state's {4 * 3 * n_params / 2**30:.3f} GiB included), loss "
            f"{loss:.6f}, card {card}")
        if remat in TRAIN_PROFILED:
            res["remat"][remat]["profile"] = profile_step(
                lambda: float(step(state, batch)[1]["loss"]),
                f"train step remat {remat}", card, log)
    grads = ts.value_and_grad(ts.make_loss_fn(base), state["params"],
                              batch)[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.adamw_update(opt_cfg, grads, state["opt"], state["params"])
    torch.cuda.synchronize()
    res["adamw_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  time adamw_update alone {res['adamw_ms']:.3f} ms (host clock, "
        f"synchronised; {len(opt.tree_leaves(grads))} leaves, "
        f"{n_params} parameters), card {card}")
    del grads
    losses_r = [v["loss"] for v in res["remat"].values()]
    check(max(losses_r) - min(losses_r) <= TRAIN_TOL["loss"] * losses_r[0],
          f"the remat policies' losses differ: {losses_r}")
    return res


def train_card_vs_cpu(base, dev, card: str, log) -> dict:
    """(b) One step of the same state and batch on the card and on the CPU
    at full width, TRAIN_SHORT_LAYERS layers, fp32 compute (TF32 off):
    loss, grad_norm, every grad leaf and AdamW on identical grads."""
    import torch
    from repro_torch.configs.base import TernaryCfg
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cpu = torch.device("cpu")
    cfg = base.with_(n_layers=TRAIN_SHORT_LAYERS, compute_dtype="float32")
    cpu_state = ts.init_train_state(cfg, seed=SEED + 1, device=cpu)
    card_state = opt.tree_map(lambda t: t.to(dev), cpu_state)
    b, s = TRAIN_CPU_SHAPE
    cpu_batch = train_batch(cfg, b, s, 0, SEED + 1, cpu)
    card_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    opt_cfg = opt.AdamWCfg(lr=3e-4, total_steps=10, warmup_steps=1)
    res = {}
    for qat in (False, True):
        c = cfg.with_(ternary=TernaryCfg(qat=qat))
        fn = ts.make_loss_fn(c)
        t0 = time.perf_counter()
        loss_c, g_c = ts.value_and_grad(fn, cpu_state["params"], cpu_batch)
        cpu_s = time.perf_counter() - t0
        loss_d, g_d = ts.value_and_grad(fn, card_state["params"],
                                        card_batch)
        gn_c, gn_d = opt.global_norm(g_c), opt.global_norm(g_d)
        loss_err = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
        gn_err = abs(float(gn_d) - float(gn_c)) / float(gn_c)
        worst = max(float((a.cpu() - w).abs().max()) / float(w.abs().max())
                    for a, w in zip(opt.tree_leaves(g_d),
                                    opt.tree_leaves(g_c)))
        # AdamW on identical grads: the CPU's, on both devices
        new_c, opt_c, _ = opt.adamw_update(opt_cfg, g_c, cpu_state["opt"],
                                           cpu_state["params"])
        new_d, opt_d, _ = opt.adamw_update(
            opt_cfg, opt.tree_map(lambda t: t.to(dev), g_c),
            card_state["opt"], card_state["params"])
        adamw_err, adamw_ok = 0.0, True
        for got, want in ((new_d, new_c), (opt_d["m"], opt_c["m"]),
                          (opt_d["v"], opt_c["v"])):
            for a, w in zip(opt.tree_leaves(got), opt.tree_leaves(want)):
                e, ok = allclose_err(a.cpu(), w, TRAIN_TOL["adamw"])
                adamw_err, adamw_ok = max(adamw_err, e), adamw_ok and ok
        key = "qat" if qat else "fp32"
        res[key] = {"loss": float(loss_d), "loss_rel_err": loss_err,
                    "grad_norm": float(gn_d), "grad_norm_rel_err": gn_err,
                    "grad_worst_of_max": worst, "adamw_max_abs_err":
                    adamw_err, "cpu_s": cpu_s}
        log(f"  card vs CPU{' (qat)' if qat else ''}: {TRAIN_SHORT_LAYERS} "
            f"layers at full width, fp32, batch {b} x {s}: loss "
            f"{float(loss_d):.6f} rel err {loss_err:.3e} (limit "
            f"{TRAIN_TOL['loss']}), grad_norm {float(gn_d):.6f} rel err "
            f"{gn_err:.3e} (limit {TRAIN_TOL['loss']}), worst grad leaf "
            f"max|d| / max|g| {worst:.3e} (limit {TRAIN_TOL['grad']}), "
            f"adamw on identical grads max_abs_err {adamw_err:.3e} "
            f"(allclose {TRAIN_TOL['adamw']}); CPU step {cpu_s:.3f} s, "
            f"card {card}")
        check(loss_err <= TRAIN_TOL["loss"], f"card vs CPU {key}: loss")
        check(gn_err <= TRAIN_TOL["loss"], f"card vs CPU {key}: grad_norm")
        check(worst <= TRAIN_TOL["grad"], f"card vs CPU {key}: grads")
        check(adamw_ok, f"card vs CPU {key}: adamw_update")
    return res


def train_resume(base, dev, card: str, log) -> dict:
    """(c) 4 straight steps against 2, a checkpoint, a fresh
    ``train_loop`` that resumes, and 2 more, at full width and
    TRAIN_SHORT_LAYERS layers, under deterministic algorithms: the state
    bit-identical (or, if an op had no deterministic path, within 1e-6,
    and the op named)."""
    import shutil
    import warnings
    import torch
    from repro_torch.data import DataCfg, TokenSource
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.runtime import RunCfg, train_loop

    cfg = base.with_(n_layers=TRAIN_SHORT_LAYERS)
    b, s = TRAIN_SHAPE
    src = TokenSource(DataCfg(vocab=cfg.vocab, global_batch=b, seq_len=s,
                              seed=SEED))
    step = ts.make_train_step(cfg, opt.AdamWCfg(lr=3e-4, total_steps=4,
                                                warmup_steps=1))

    def run(n: int, ckpt_dir: str) -> RunCfg:
        return RunCfg(total_steps=n, ckpt_dir=ckpt_dir, ckpt_every=100,
                      log_every=100)

    dirs = [train_tmpdir() for _ in range(2)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight, _ = train_loop(run(4, dirs[0]), ts.init_train_state(
                cfg, seed=SEED, device=dev), step, src)
            half, _ = train_loop(run(2, dirs[1]), ts.init_train_state(
                cfg, seed=SEED, device=dev), step, src)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ckpt.save(dirs[1], 2, half)
            save_s = time.perf_counter() - t0
            n_bytes = sum(os.path.getsize(os.path.join(r, f))
                          for r, _, fs in os.walk(path) for f in fs)
            t0 = time.perf_counter()
            back = ckpt.restore(dirs[1], 2, device=dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(all(torch.equal(a, w) for a, w in zip(
                opt.tree_leaves(back), opt.tree_leaves(half))),
                "the restored checkpoint differs from the saved state")
            del back, half
            resumed, summary = train_loop(run(4, dirs[1]), None, step, src,
                                          device=dev)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    pairs = list(zip(opt.tree_leaves(resumed), opt.tree_leaves(straight)))
    identical = all(torch.equal(a, w) for a, w in pairs)
    max_err = max(float((a.float() - w.float()).abs().max())
                  for a, w in pairs)
    res = {"bit_identical": identical, "max_abs_err": max_err,
           "nondeterministic_ops": nondet, "ckpt_bytes": n_bytes,
           "save_s": save_s, "restore_s": restore_s,
           "resumed_losses": summary["losses"]}
    log(f"  resume: {TRAIN_SHORT_LAYERS} layers at full width, 4 straight "
        f"steps against 2 + checkpoint + resume + 2: params and AdamW "
        f"state {'bit-identical' if identical else 'not bit-identical'} "
        f"(max_abs_err {max_err:.3e}); ops without a deterministic CUDA "
        f"path: {nondet or 'none'}; checkpoint {n_bytes} bytes, save "
        f"{save_s:.3f} s, restore {restore_s:.3f} s, card {card}")
    if nondet:
        check(max_err <= 1e-6, "resume: state further than 1e-6")
    else:
        check(identical, "resume: state not bit-identical")
    return res


def train_compressed_dp(base, dev, card: str, log) -> dict:
    """(d) The TernGrad step at full width and depth (fp32 compute, so
    that halves of the batch give the full batch's loss to 1e-5) on
    meshes [dev] and [dev, dev], TRAIN_DP_STEPS steps each: the loss
    against the uncompressed loss on the same state and batch, and the
    replicas bit-identical."""
    import torch
    from repro_torch.train import compression as comp
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = base.with_(compute_dtype="float32")
    b, s = TRAIN_SHAPE
    opt_cfg = opt.AdamWCfg(lr=3e-4, total_steps=TRAIN_DP_STEPS,
                           warmup_steps=1)
    loss_fn = ts.make_loss_fn(cfg)
    res = {}
    for mesh in ([dev], [dev, dev]):
        step = comp.make_compressed_dp_step(cfg, mesh, opt_cfg)
        replicas = comp.replicate(ts.init_train_state(cfg, seed=SEED,
                                                      device=dev), mesh)
        errs, ms = [], []
        for i in range(TRAIN_DP_STEPS):
            batch = train_batch(cfg, b, s, i, SEED, dev)
            with torch.no_grad():
                want = float(loss_fn(replicas[0]["params"], batch))
            replicas, _, ms_i, loss = timed_step(step, replicas, batch)
            errs.append(abs(loss - want) / abs(want))
            ms.append(ms_i)
        same = all(torch.equal(a, w) for r in replicas[1:] for a, w in zip(
            opt.tree_leaves(r["params"]), opt.tree_leaves(
                replicas[0]["params"])))
        wire = comp.wire_bytes(replicas[0]["params"])
        key = f"x{len(mesh)}"
        res[key] = {"loss_rel_err": errs, "replicas_identical": same,
                    "wire_bytes": wire, "ms": ms}
        log(f"  compressed DP on {len(mesh)} replica(s) of {dev}: "
            f"{TRAIN_DP_STEPS} steps at full width and depth, fp32, loss "
            f"against the uncompressed loss on the same state and batch, "
            f"rel err {max(errs):.3e} (limit {TRAIN_TOL['loss']}); "
            f"replicas {'bit-identical' if same else 'differ'}; wire "
            f"{wire:.0f} bytes a step (int8 codes; fp32 grads "
            f"{4 * wire:.0f}); steps "
            + " ".join(f"{x:.1f}" for x in ms) + f" ms, card {card}")
        check(max(errs) <= TRAIN_TOL["loss"], f"compressed DP {key}: loss")
        check(same, f"compressed DP {key}: replicas differ")
        del replicas
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 3g: the named mesh
# ---------------------------------------------------------------------------

def phase_mesh_path(dev, card: str, log) -> dict:
    """A 1-rank NCCL group (a FileStore in a temporary directory), the
    (data=1, model=1) DeviceMesh on the card: qwen3-0.6b sharded against
    plain steps, the roofline of the real step, the dry-run's prediction
    against the card, one full-width MoE layer on the mesh against none.
    The group is torn down at the end, whatever happens."""
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_",
                                 dir=os.path.join(ROOT, "build"))
    dist.init_process_group(
        "nccl", rank=0, world_size=1, device_id=dev,
        store=dist.FileStore(os.path.join(store_dir, "store"), 1))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        res = {"mesh": str(mesh), "card": card}
        res["train"] = mesh_train(mesh, dev, card, log)
        torch.cuda.empty_cache()
        res["dryrun"] = mesh_dryrun(res["train"], card, log)
        res["moe"] = mesh_moe(mesh, dev, card, log)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return res


def mesh_train(mesh, dev, card: str, log) -> dict:
    """MESH_STEPS steps of qwen3-0.6b (bf16 compute, remat "dots", batch
    8 x 128, seed 0) through ``make_train_step(..., mesh=mesh)`` against
    the same steps without a mesh; then one sharded step under
    ``FlopCounterMode`` and one whose peak memory is read."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    cfg = get_config(MODEL_ARCH)
    b, s = TRAIN_SHAPE
    opt_cfg = opt.AdamWCfg(lr=3e-4, total_steps=MESH_STEPS, warmup_steps=1)
    state0 = ts.init_train_state(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in opt.tree_leaves(state0["params"]))
    batches = [train_batch(cfg, b, s, i, SEED, dev)
               for i in range(MESH_STEPS)]
    routes = {"plain": ts.make_train_step(cfg, opt_cfg),
              "sharded": ts.make_train_step(cfg, opt_cfg, mesh=mesh)}
    res = {"n_params": n_params, "batch": b, "seq": s}
    for name, step in routes.items():
        st = state0 if name == "plain" else ts.shard_train_state(state0,
                                                                 mesh)
        losses, gnorms, host, device = [], [], [], []
        for batch in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            st, m = step(st, batch)
            end.record()
            loss = m["loss"]
            loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                         else loss)
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            device.append(start.elapsed_time(end))
            g = m["grad_norm"]
            gnorms.append(float(g.full_tensor() if hasattr(g, "full_tensor")
                                else g))
            losses.append(loss)
        res[name] = {"losses": losses, "grad_norms": gnorms,
                     "host_ms": host, "stream_ms": device,
                     "profile": profile_step(
                         lambda: step(st, batches[0]),
                         f"mesh: {name} train step", card, log)}
        log(f"  {name}: {MESH_STEPS} steps, losses "
            + " ".join(f"{x:.6f}" for x in losses) + ", grad_norm "
            + " ".join(f"{x:.6f}" for x in gnorms) + "; host ms "
            + " ".join(f"{x:.1f}" for x in host) + ", stream ms (CUDA "
            "events from the step's start to its end, idle included) "
            + " ".join(f"{x:.1f}" for x in device)
            + f", card {card}")
        del st
    loss_err = max(abs(a - w) / abs(w) for a, w in zip(
        res["sharded"]["losses"], res["plain"]["losses"]))
    gn_err = max(abs(a - w) / abs(w) for a, w in zip(
        res["sharded"]["grad_norms"], res["plain"]["grad_norms"]))
    res["loss_rel_err"], res["grad_norm_rel_err"] = loss_err, gn_err
    log(f"  sharded vs plain: loss rel err {loss_err:.3e} (limit "
        f"{MESH_TOL['loss']}), grad_norm rel err {gn_err:.3e} (limit "
        f"{MESH_TOL['grad_norm']}); median host ms sharded "
        f"{statistics.median(res['sharded']['host_ms']):.1f} vs plain "
        f"{statistics.median(res['plain']['host_ms']):.1f}; device ms "
        f"(torch.profiler, one step) sharded "
        f"{res['sharded']['profile']['device_ms']:.3f} vs plain "
        f"{res['plain']['profile']['device_ms']:.3f}, card {card}")
    check(loss_err <= MESH_TOL["loss"], "mesh: sharded loss")
    check(gn_err <= MESH_TOL["grad_norm"], "mesh: sharded grad_norm")

    # the roofline of the real step: its counted FLOPs against 6·N·D, and
    # the model-FLOPs share of the bf16 peak at the sharded median
    step = routes["sharded"]
    st = ts.shard_train_state(state0, mesh)
    del state0
    with FlopCounterMode(display=False) as fc:
        st2, _ = step(st, batches[0])
    del st2
    flops = fc.get_total_flops()
    model_flops = 6 * n_params * b * s
    ms = statistics.median(res["sharded"]["host_ms"])
    res.update(flops=flops, model_flops=model_flops,
               flops_share=model_flops / (ms / 1e3 * PEAK_BF16_FLOP_PER_S))
    log(f"  roofline: FlopCounterMode {flops:.6e} FLOPs a step, 6·N·D "
        f"{model_flops:.6e} (ratio {flops / model_flops:.4f}: attention "
        f"and the recomputed products of remat dots beyond 6·N·D); "
        f"model-FLOPs share of {PEAK_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s "
        f"bf16 at the median {ms:.1f} ms: "
        f"{100 * res['flops_share']:.3f} %, card {card}")
    import gc
    gc.collect()                     # DTensor garbage held in cycles
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    st2, _ = step(st, batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    res["state_bytes"] = sum(
        t.to_local().nbytes for t in opt.tree_leaves(st["params"])
        + opt.tree_leaves(st["opt"]["m"]) + opt.tree_leaves(st["opt"]["v"]))
    res.update(max_memory_allocated=peak, base_bytes=base,
               step_peak_bytes=peak - base + res["state_bytes"])
    del st, st2
    return res


def mesh_dryrun(train: dict, card: str, log) -> dict:
    """The dry-run's per-card prediction for ShapeCell("phase3g", "train",
    128, 8) on a 1-rank (1, 1) mesh (fake backend, meta tensors, in a
    subprocess: a process has one default group): its FLOPs must equal
    the count on the card's tensors, a consistency check (the same
    formulas on the same program: it shows that the meta run is the
    card's program, not that the formulas are right); its peak bytes
    beside ``max_memory_allocated``."""
    code = ("import json, sys\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.configs.shapes import ShapeCell\n"
            "from repro_torch.launch import dryrun\n"
            f"cfg = get_config({MODEL_ARCH!r})\n"
            f"cell = ShapeCell('phase3g', 'train', {TRAIN_SHAPE[1]}, "
            f"{TRAIN_SHAPE[0]})\n"
            "rec = dryrun.run_cell(cfg, cell, dryrun.build_mesh((1, 1), "
            "('data', 'model')))\n"
            "print(json.dumps(rec))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    check(out.returncode == 0, f"dry-run subprocess: {out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec["wall_s"] = time.perf_counter() - t0
    peak = rec["memory"]["peak_bytes"]
    log(f"  dry-run prediction (1 rank, meta, {rec['wall_s']:.1f} s): "
        f"{rec['flops']:.6e} FLOPs, counted on the card "
        f"{train['flops']:.6e} ({'equal' if rec['flops'] == train['flops'] else 'DIFFER'}"
        f": a consistency check, the same formulas on the same program); "
        f"peak {peak / 2**30:.3f} GiB (state "
        f"{rec['memory']['argument_bytes'] / 2**30:.3f} GiB) against the "
        f"card's step peak {train['step_peak_bytes'] / 2**30:.3f} GiB "
        f"(ratio {peak / train['step_peak_bytes']:.3f}) and "
        f"max_memory_allocated {train['max_memory_allocated'] / 2**30:.3f}"
        f" GiB (ratio {peak / train['max_memory_allocated']:.3f}), card "
        f"{card}")
    check(rec["flops"] == train["flops"],
          "the dry-run's FLOPs differ from the card's count")
    return rec


def mesh_moe(mesh, dev, card: str, log) -> dict:
    """One MoE layer of qwen3-moe-30b-a3b at full width (d_model 2048, 128
    experts, top 8, d_ff 768), fp32, on MESH_MOE_TOKENS tokens: ``moe_ffn``
    on the mesh against no mesh, bit for bit, as "tp" and as "ep" (which
    falls to the TP body at model = 1, as in the reference)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    cfg = get_config(MESH_MOE_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    p = moe_mod.init_moe(gen, cfg.d_model, cfg.moe, torch.float32)
    x = torch.randn((*MESH_MOE_TOKENS, cfg.d_model), generator=gen,
                    device=dev)
    res = {}
    with torch.no_grad():
        want = moe_mod.moe_ffn(p, x, cfg.moe, cfg.act)
        for mode in ("tp", "ep"):
            mcfg = cfg.moe.__class__(**{**cfg.moe.__dict__,
                                        "parallelism": mode})
            ep = moe_mod.use_ep(mcfg, mesh, x.shape[0] * x.shape[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = moe_mod.moe_ffn(p, x, mcfg, cfg.act, mesh=mesh)
            got = got.full_tensor()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            same = torch.equal(got, want)
            res[mode] = {"bit_identical": same, "ep_taken": ep, "ms": ms}
            log(f"  MoE {MESH_MOE_ARCH} layer, d_model {cfg.d_model}, "
                f"{cfg.moe.n_experts} experts top {cfg.moe.top_k}, d_ff "
                f"{cfg.moe.d_ff}, fp32, {MESH_MOE_TOKENS[0]} x "
                f"{MESH_MOE_TOKENS[1]} tokens, parallelism {mode!r}: "
                f"{'EP body' if ep else 'TP body (EP is not taken at model = 1, as in the reference)'}"
                f", {'bit-identical' if same else 'DIFFERS'} to no mesh, "
                f"{ms:.1f} ms (host clock), card {card}")
            check(same, f"mesh MoE {mode}: not bit-identical")
    return res


# ---------------------------------------------------------------------------
# Phase 3h: serving on the named mesh, and the examples
# ---------------------------------------------------------------------------

def phase_mesh_serve_path(dev, card: str, log) -> dict:
    """A 1-rank NCCL group, the (data=1, model=1) DeviceMesh on the card:
    qwen3-0.6b's engine on the mesh against none at batch 4 and 16, a
    BatchServer wave on the mesh against sequential serving; then the
    examples.  The group is torn down after the serving part, whatever
    happens."""
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_",
                                 dir=os.path.join(ROOT, "build"))
    dist.init_process_group(
        "nccl", rank=0, world_size=1, device_id=dev,
        store=dist.FileStore(os.path.join(store_dir, "store"), 1))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        res = {"mesh": str(mesh), "card": card}
        res["engine"], res["wave"], res["ap_wave"] = mesh_serving(
            mesh, dev, card, log)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    res["examples"] = run_examples(dev, card, log)
    return res


def mesh_serving(mesh, dev, card: str, log) -> tuple[dict, dict, dict]:
    """qwen3-0.6b (packed MLPs, bf16, seed 0): ``Engine(mesh=)`` against
    the meshless engine at each of MESH_SERVE_BATCHES, in turns (plain,
    mesh, mesh, plain); then a BatchServer wave on the mesh, and a merged
    AP wave on it (:func:`mesh_ap_wave_order`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.models import model
    from repro_torch.models.quant import quantize_model_params
    from repro_torch.serve import BatchServer, Engine, ServeCfg
    cfg = get_config(MODEL_ARCH)
    params = model.cast_params(cfg, quantize_model_params(
        model.init_params(cfg, seed=SEED, device=dev)))
    _, s_prompt, n_new, max_len = SERVE_SHAPE
    serve = ServeCfg(max_len=max_len)
    engines = {"plain": Engine(cfg, params, serve, device=dev),
               "mesh": Engine(cfg, params, serve, mesh=mesh)}
    n_steps = s_prompt + n_new - 1
    out = {}
    for b in MESH_SERVE_BATCHES:
        prompts = np.random.default_rng(SEED).integers(
            1, cfg.vocab, (b, s_prompt), dtype=np.int32)
        kernel = tk.kernel_for(torch.bfloat16, b)
        runs = {"plain": [], "mesh": []}
        for route in ("plain", "mesh", "mesh", "plain"):
            eng = engines[route]
            before = matmul_launches()
            toks = eng.generate(prompts, n_new)
            moved = matmul_launches_since(before)
            lat = eng.last_latency
            runs[route].append({
                "tokens": toks, "launches": moved,
                "decode_ms_per_step": lat["decode_ms"]
                / lat["n_decode_steps"],
                "tokens_per_s": b * n_new / lat["request_ms"] * 1e3,
                "request_ms": lat["request_ms"]})
        want = {k: (3 * cfg.n_layers * n_steps if k == kernel else 0)
                for k in tk.launch_counts}
        same = all(np.array_equal(r["tokens"], runs["plain"][0]["tokens"])
                   for rs in runs.values() for r in rs)
        rec = {route: [{k: v for k, v in r.items() if k != "tokens"}
                       for r in rs] for route, rs in runs.items()}
        rec.update(batch=b, kernel=kernel, bit_identical=same,
                   launches_expected=want)
        out[f"batch {b}"] = rec
        for route in ("plain", "mesh"):
            step_ms = ", ".join("%.2f" % r["decode_ms_per_step"]
                                for r in rec[route])
            tok_s = ", ".join("%.1f" % r["tokens_per_s"] for r in rec[route])
            log(f"  engine {route:5s} batch {b}, {s_prompt}-token prompts, "
                f"{n_new} new tokens, cache {max_len} ({kernel} at M = {b}):"
                f" {step_ms} ms a decode step (host clock), {tok_s} "
                f"tokens/s; launches {rec[route][0]['launches']}; card "
                f"{card}")
        log(f"  engine batch {b}: mesh tokens "
            f"{'bit-identical to' if same else 'DIFFER from'} the meshless "
            f"engine's")
        check(same, f"Engine(mesh=) batch {b}: tokens differ from no mesh")
        for route, rs in rec.items():
            if route in ("plain", "mesh"):
                check(all(r["launches"] == want for r in rs),
                      f"engine {route} batch {b}: launches "
                      f"{[r['launches'] for r in rs]}, expected {want}")
    del engines
    # a BatchServer wave of two requests on the mesh
    b, n_wave = MESH_WAVE
    rng = np.random.default_rng(SEED + 1)
    reqs = [rng.integers(1, cfg.vocab, (b, s_prompt), dtype=np.int32)
            for _ in range(2)]
    eng = Engine(cfg, params, serve, mesh=mesh)
    want = [eng.generate(p, n_wave) for p in reqs]
    t0 = time.perf_counter()
    with BatchServer(eng) as srv:
        handles = [srv.submit(p, n_wave) for p in reqs]
        got = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    wave = {"requests": 2, "batch": b, "new": n_wave, "n_waves": srv.n_waves,
            "equal_to_sequential": same, "wall_s": wall}
    log(f"  BatchServer on the mesh: 2 requests of batch {b}, {n_wave} new "
        f"tokens, {srv.n_waves} waves in {wall:.2f} s; tokens "
        f"{'equal to' if same else 'DIFFER from'} sequential serving")
    check(same, "BatchServer on the mesh: tokens differ from sequential")
    check(srv.n_waves == s_prompt + n_wave - 1,
          f"BatchServer on the mesh: {srv.n_waves} waves, expected one a "
          f"step")
    del eng
    del params
    return out, wave, mesh_ap_wave_order(mesh, cfg, dev, card, log)


def mesh_ap_wave_order(mesh, cfg, dev, card: str, log) -> dict:
    """MESH_AP_WAVE one-token requests, one new token each, through a
    BatchServer on the mesh with every MLP projection on the AP (phase
    3e's pool and x_levels; ``cfg`` at MESH_AP_WAVE_LAYERS layers, packed
    weights from SEED): one merged wave.  Its worker threads take
    turns between graph calls, as a mesh needs
    (``WaveMerger(ordered=True)``), or run freely (``ordered=False``, safe
    on one rank only), in turns ordered, unordered, unordered, ordered.
    The wave's host ms for each; tokens and APStats equal across the
    four."""
    import torch
    from repro_torch import apc
    from repro_torch.serve import BatchServer, Engine, ServeCfg, batcher

    from repro_torch.models import model
    from repro_torch.models.quant import quantize_model_params

    class Unordered(batcher.WaveMerger):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, ordered=False))

    cfg = cfg.with_(n_layers=MESH_AP_WAVE_LAYERS)
    params = model.cast_params(cfg, quantize_model_params(
        model.init_params(cfg, seed=SEED, device=dev)))
    ctx = apc.APServeContext(apc.Runtime(apc.ArrayPool(
        *AP_SERVE_POOL, device=dev)), x_levels=AP_SERVE_X_LEVELS)
    eng = Engine(cfg, params, ServeCfg(max_len=AP_SERVE_MAX_LEN),
                 ap_ctx=ctx, mesh=mesh)
    prompts = [np.array([[t]], np.int32) for t in
               np.random.default_rng(SEED + 2).integers(
                   1, cfg.vocab, MESH_AP_WAVE)]
    runs = {"ordered": [], "unordered": []}
    first = None
    for mode in ("ordered", "unordered", "unordered", "ordered"):
        merger = batcher.WaveMerger
        if mode == "unordered":
            batcher.WaveMerger = Unordered
        waves: list = []
        try:
            with BatchServer(eng) as srv:
                orig = srv._run_wave

                def run_wave(reg, orig=orig, srv=srv, waves=waves):
                    width = sum(not a.request.done for a in srv._active)
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    orig(reg)
                    torch.cuda.synchronize(dev)
                    waves.append((width, 1e3 * (time.perf_counter() - t0)))

                srv._run_wave = run_wave
                handles = [srv.submit(p, 1) for p in prompts]
                got = [(h.result(timeout=600).tolist(),
                        {k: h.ap_report()[k] for k in AP_PARITY})
                       for h in handles]
        finally:
            batcher.WaveMerger = merger
        check([w for w, _ in waves] == [MESH_AP_WAVE],
              f"AP wave on the mesh ({mode}): wave widths "
              f"{[w for w, _ in waves]}, expected [{MESH_AP_WAVE}]")
        first = got if first is None else first
        check(got == first, f"AP wave on the mesh ({mode}): tokens or "
                            f"APStats differ from the first run's")
        runs[mode].append(waves[0][1])
    out = {"requests": MESH_AP_WAVE, "wave_host_ms": runs,
           "tokens": [t for t, _ in first],
           "n_programs": [r["n_programs"] for _, r in first]}
    for mode, ms in runs.items():
        log(f"  merged AP wave on the mesh, {MESH_AP_WAVE} requests, "
            f"{cfg.n_layers} layers, {mode}: {', '.join('%.1f' % x for x in ms)} ms host clock "
            f"(card {card})")
    log(f"  merged AP wave: tokens {out['tokens']} and APStats equal in "
        f"all four runs; ordered / unordered means "
        f"{statistics.mean(runs['ordered']) / statistics.mean(runs['unordered']):.3f}")
    return out


def run_example(name: str, device: str, *argv: str) -> tuple[float, str]:
    """``examples/torch_<name>.py``'s ``main`` on ``device``: (seconds,
    what it printed).  Its failed self-check is a failed check here."""
    import contextlib
    import importlib.util
    import io
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(["--device", device, *argv])
    except SystemExit as e:
        check(False, f"example torch_{name} on {device}: {e}")
    return time.perf_counter() - t0, buf.getvalue()


def run_examples(dev, card: str, log) -> dict:
    """EXAMPLES_SAME on the card and on the CPU, every printed line equal
    (the packed kernel's error line held to its check instead); the two
    others on the card at EXAMPLES_CUT."""
    res = {}
    for name in EXAMPLES_SAME:
        before = {**kernel_launches(), **matmul_launches()}
        s_card, on_card = run_example(name, str(dev))
        moved = {k: n - before[k]
                 for k, n in {**kernel_launches(),
                              **matmul_launches()}.items()}
        s_cpu, on_cpu = run_example(name, "cpu")
        a, b = on_card.splitlines(), on_cpu.splitlines()
        differ = [(x, y) for x, y in zip(a, b) if x != y and not (
            x.startswith("packed kernel max err")
            and y.startswith("packed kernel max err"))]
        res[name] = {"card_s": s_card, "cpu_s": s_cpu, "lines": len(a),
                     "launches": moved, "differ": differ,
                     "printed": on_card}
        n_differ = len(differ) + abs(len(a) - len(b))
        log(f"  example torch_{name}: {len(a)} lines, card {s_card:.2f} s, "
            f"CPU {s_cpu:.2f} s; lines that differ: {n_differ}; launches on "
            f"the card {moved}")
        for line in a:
            log(f"    {line}")
        check(len(a) == len(b) and not differ,
              f"example torch_{name}: the card printed {differ[:2]} where "
              f"the CPU printed otherwise")
    check(res["ap_arithmetic"]["launches"]["tap_run_program"] > 0,
          "torch_ap_arithmetic launched no program kernel on the card")
    tern = res["ternary_inference"]["launches"]
    check(tern["tap_run_program"] > 0 and tern["ternary_matmul"] > 0,
          f"torch_ternary_inference on the card: launches {tern}")
    for name, argv in EXAMPLES_CUT.items():
        secs, printed = run_example(name, str(dev), *argv)
        res[name] = {"card_s": secs, "argv": list(argv), "printed": printed}
        log(f"  example torch_{name} {' '.join(argv)} on the card, "
            f"{secs:.2f} s:")
        for line in printed.splitlines():
            log(f"    {line}")
    check("LEARNED" in res["train_lm"]["printed"],
          "torch_train_lm did not learn")
    return res


def kernel_launches() -> dict[str, int]:
    from repro_torch.kernels.tap_pass import kernel
    return dict(kernel.launch_counts)


# ---------------------------------------------------------------------------
# Phase 4: times and bounds
# ---------------------------------------------------------------------------

def event_ms(fn, reps: int, inner: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call, after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the CUDA-event time of one replay of a CUDA
    graph that holds ``inner`` calls, per call: the device's time, without
    the host's work per call that ``event_ms`` can include."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return event_ms(graph.replay, reps, 1) / inner


def program_bound(sched, rows: int, cols: int, sets: int, pack: int
                  ) -> dict:
    """Least time of one program launch with counters on, for any
    implementation: each digit read and written once (plus the schedule
    and counters); every cell compare of every valid key (all feed the
    histogram) plus every cell the data changed (``sets``), at most
    ROWS_PER_OP rows per INT32 operation; and the groups of the schedule
    one after another, each at least one dependent shared-memory
    compare-and-write (STEP_CHAIN_S; bound_by reads "operations" where this
    serial term is the largest).  ``per_row_ops_bound_ms`` is kept beside
    it: one operation per row per cell, which a kernel that handles several
    rows per operation can beat."""
    cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals = sched
    n_bytes = 2 * rows * cols + sum(int(t.numel() * t.element_size())
                                    for t in sched)
    n_bytes += 4 * 10 * max(1, rows // 4096)
    per_row = int(((cmp_cols >= 0).sum(dim=1) *
                   key_valid.to(bool).sum(dim=1)).sum())
    ops = rows * per_row + sets
    b = bound(n_bytes, -(-ops // ROWS_PER_OP),
              serial_ms=cmp_cols.shape[0] // pack * STEP_CHAIN_S * 1e3)
    b["per_row_ops_bound_ms"] = max(b["bytes_ms"],
                                    ops / PEAK_INT32_OPS_PER_S * 1e3)
    return b


def bound(n_bytes: int, ops: int,
          peak_ops_per_s: float = PEAK_INT32_OPS_PER_S,
          serial_ms: float = 0.0) -> dict:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops_per_s * 1e3
    return {"bytes": n_bytes, "ops": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "serial_ms": serial_ms,
            "bound_ms": max(t_bytes, t_ops, serial_ms),
            "bound_by": ("bytes" if t_bytes >= max(t_ops, serial_ms)
                         else "operations")}


def phase_times(dev, card: str, log) -> list[dict]:
    import torch
    from repro_torch import apc
    from repro_torch.apc.exec import BLOCK_ROWS, device_schedule
    from repro_torch.core import build_lut_nonblocked
    from repro_torch.core import truth_tables as tt
    from repro_torch.kernels.tap_pass import kernel, ref, tap_ripple_add
    from repro_torch.kernels.tap_pass.ops import _pad_rows

    rng = np.random.default_rng(SEED + 2)
    rows_out = []
    for fn, radix, width in TIMING_PROGRAMS:
        compiled = apc.compile_named(fn, radix, width)
        sched, variant, pack = device_schedule(compiled, None, dev)
        for rows in TIMING_ROWS:
            _, _, arr = named_operands(fn, radix, width, rows, rng)
            arr = torch.from_numpy(arr).to(dev)
            block_rows = min(BLOCK_ROWS, max(8, rows))
            padded, _ = _pad_rows(arr, block_rows)

            def run_kernel():
                return kernel.tap_run_program(
                    padded, *sched, rows, block_rows=block_rows,
                    collect_stats=True, pack=pack)

            def run_plain():
                return ref.run_program_plain(
                    padded, *sched, rows, block_rows=block_rows,
                    collect_stats=True, pack=pack)
            _, counts = run_kernel()
            sets = int(counts[:, 0].long().sum())
            ms = event_ms(run_kernel, reps=5, inner=20)
            plain_ms = event_ms(run_plain, reps=3 if rows < FULL_ROWS else 1,
                                inner=1)
            b = program_bound(sched, rows, padded.shape[1], sets, pack)
            row = {"kernel": "tap_run_program", "program": f"{fn}{radix}x"
                   f"{width}", "steps": compiled.n_steps, "rows": rows,
                   "cols": padded.shape[1], "variant": variant, "pack": pack,
                   "collect_stats": True, "ms": ms, "plain_ms": plain_ms,
                   **b, "card": card}
            rows_out.append(row)
            log(f"  time tap_run_program {row['program']} rows={rows} "
                f"kernel {ms:.6f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b['bound_ms']:.6f} ms ({b['bound_by']}: bytes "
                f"{b['bytes_ms']:.6f} ms, int ops / 32 rows "
                f"{b['ops_ms']:.6f} ms, serial steps {b['serial_ms']:.6f} "
                f"ms; one op per row {b['per_row_ops_bound_ms']:.6f} ms), "
                f"card {card}")
    # the schedule kernel on the width-3 ripple add, through its wrapper;
    # beside it the program kernel, counters off, on the same schedule
    # lowered to a program (the yardstick of a dedicated kernel)
    lut = build_lut_nonblocked(tt.full_adder(3))
    sched = ref.ripple_add_schedule(lut, 3, 6)
    compiled = apc.lower._compile_steps(tuple(
        apc.Step(keys=k, compare_cols=c, write_cols=wc, write_vals=wv)
        for k, c, wc, wv in sched))
    p_sched, _, _ = device_schedule(compiled, "gather", dev)
    for rows in TIMING_ROWS:
        _, _, arr = named_operands("add", 3, 3, rows, rng)
        arr = torch.from_numpy(arr).to(dev)
        block_rows = min(BLOCK_ROWS, rows)

        def run_kernel():
            return kernel.tap_apply_schedule(arr, sched)

        def run_program():
            return kernel.tap_run_program(arr, *p_sched, rows,
                                          block_rows=block_rows)[0]

        def run_entry():                 # builds the schedule as callers do
            return tap_ripple_add(arr, lut, 3, 6)
        check(torch.equal(run_kernel(), run_program()),
              f"tap_apply_schedule rows={rows}: not the program kernel's "
              f"digits")
        check(torch.equal(run_entry(), run_program()),
              f"tap_ripple_add rows={rows}: not the program kernel's digits")
        ms = event_ms(run_kernel, reps=5, inner=20)
        entry_ms = event_ms(run_entry, reps=5, inner=20)
        device_ms = graph_ms(run_kernel)
        program_ms = event_ms(run_program, reps=5, inner=20)
        program_device_ms = graph_ms(run_program)
        plain_ms = event_ms(lambda: ref.apply_schedule(arr, sched), reps=3,
                            inner=1)
        _, counts = ref.run_program_plain(arr, *p_sched, rows,
                                          block_rows=rows,
                                          collect_stats=True)
        sets = int(counts[:, 0].long().sum())
        s_bytes = sum(t.nbytes for t in kernel.schedule_tensors(sched))
        per_row = sum(len(k) * len(c) for k, c, _, _ in sched)
        ops = rows * per_row + sets
        b = bound(2 * rows * 7 + s_bytes, -(-ops // ROWS_PER_OP),
                  serial_ms=len(sched) * STEP_CHAIN_S * 1e3)
        b["per_row_ops_bound_ms"] = max(b["bytes_ms"],
                                        ops / PEAK_INT32_OPS_PER_S * 1e3)
        row = {"kernel": "tap_apply_schedule", "program": "ripple_add3x3",
               "steps": len(sched), "rows": rows, "cols": 7, "ms": ms,
               "device_ms": device_ms, "entry_ms": entry_ms,
               "plain_ms": plain_ms,
               "program_kernel_ms": program_ms,
               "program_kernel_device_ms": program_device_ms, **b,
               "card": card}
        rows_out.append(row)
        log(f"  time tap_apply_schedule ripple_add3x3 rows={rows} kernel "
            f"{ms:.6f} ms (graph {device_ms:.6f}; through tap_ripple_add "
            f"{entry_ms:.6f}), program kernel counters "
            f"off {program_ms:.6f} ms (graph {program_device_ms:.6f}), "
            f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']}: bytes {b['bytes_ms']:.6f} ms, int ops / 32 "
            f"rows {b['ops_ms']:.6f} ms, serial steps {b['serial_ms']:.6f} "
            f"ms; one op per row {b['per_row_ops_bound_ms']:.6f} ms), card "
            f"{card}")
    return rows_out


def phase_matmul_times(dev, card: str, log) -> list[dict]:
    """Ternary-matmul kernels, plain version and library product (a dense
    weight in x's dtype, no TF32) at the MLP shapes, and the program
    kernel on the AP matmul's tile and reduction programs.  Both matmul
    kernels are timed on the same inputs at every shape: the routed one
    through the wrapper, the other through its own launcher."""
    import torch
    from repro_torch import apc
    from repro_torch.apc.exec import BLOCK_ROWS, device_schedule
    from repro_torch.kernels.tap_pass import kernel
    from repro_torch.kernels.tap_pass.ops import _pad_rows
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import (
        PACK, pack_ternary, ternary_matmul_ref, unpack_ternary)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    chunk = 1024                         # rows per pack/unpack step
    rows_out = []
    weights: dict = {}
    for model, product, k, n, m in MATMUL_TIMES:
        if (k, n) not in weights:
            weights.clear()              # free the previous model's
            torch.cuda.empty_cache()
            weights[(k, n)] = (*seeded_packed(k, n, gen, dev, chunk), {})
        packed, scale, dense = weights[(k, n)]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            if dtype not in dense:
                w = torch.empty((k, n), dtype=dtype, device=dev)
                for lo in range(0, k, chunk):
                    w[lo:lo + chunk] = unpack_ternary(
                        packed[lo // PACK:(lo + chunk) // PACK], dtype)
                dense[dtype] = (w, scale.to(dtype))
            w, sc = dense[dtype]
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            routed = tk.kernel_for(dtype, m)
            runs = {"ternary_matmul": lambda: tk._launch_cuda_cores(
                        x, packed, scale),
                    "ternary_matmul_tc": lambda: tk._launch_tensor_cores(
                        x, packed, scale)}
            runs[routed] = lambda: tk.ternary_matmul(x, packed, scale)
            kernel_ms = {kname: (event_ms(fn, reps=5, inner=20),
                                 graph_ms(fn)) for kname, fn in runs.items()}
            plain_ms = event_ms(
                lambda: ternary_matmul_ref(x, packed, scale), reps=3,
                inner=1)
            library_ms = event_ms(lambda: torch.matmul(x, w) * sc, reps=5,
                                  inner=20)
            library_device_ms = graph_ms(lambda: torch.matmul(x, w) * sc)
            size = x.element_size()
            n_bytes = m * k * size + k * n // 4 + m * n * size
            b = bound(n_bytes, 2 * m * k * n * MATMUL_PASSES[name],
                      PEAK_BF16_FLOP_PER_S)
            # beside it: fp32 x at the fp32-FMA rate
            b["fp32_fma_bound_ms"] = max(b["bytes_ms"], 2 * m * k * n / (
                PEAK_FP32_FMA_FLOP_PER_S if name == "float32"
                else PEAK_BF16_FLOP_PER_S) * 1e3)
            for kname, (ms, device_ms) in kernel_ms.items():
                row = {"kernel": kname, "routed": kname == routed,
                       "model": model, "product": product, "m": m, "k": k,
                       "n": n, "dtype": name,
                       "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms,
                       "library_device_ms": library_device_ms, **b,
                       "card": card}
                rows_out.append(row)
                log(f"  time {kname} {model} {product} M={m} K={k} N={n} "
                    f"{name}"
                    f" kernel {ms:.6f} ms (graph {device_ms:.6f}), plain "
                    f"{plain_ms:.3f} ms, library {library_ms:.6f} ms (graph "
                    f"{library_device_ms:.6f}), bound {b['bound_ms']:.6f} ms "
                    f"({b['bound_by']}: bytes {b['bytes_ms']:.6f} ms, "
                    f"{MATMUL_PASSES[name]} bf16 pass(es) {b['ops_ms']:.6f} "
                    f"ms; at the fp32-FMA rate {b['fp32_fma_bound_ms']:.6f} "
                    f"ms), card {card}")
    weights.clear()
    torch.cuda.empty_cache()

    # the tensor-core kernel at the shape rule's choices on the MLP's
    # products: every tile of tokens bt (bt <= M <= 32 bt) by outputs, at
    # each K split that a grid of a quarter of the card or less could take
    d, f = QWEN3_06B
    n_sm = tk._sm_count(dev.index)
    for product, k, n in (("w1", d, f), ("w2", f, d)):
        packed = pack_ternary(torch.randint(-1, 2, (k, n), generator=gen,
                                            device=dev, dtype=torch.int8))
        scale = torch.rand(n, generator=gen, device=dev) * 0.04 + 0.01
        for m in MLP_TOKENS[1:]:
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).split(".")[1]
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                auto = tk.tc_shape(m, n, k // PACK, n_sm, dtype)
                for (bt, bw), words in tk.TC_TILES[dtype].items():
                    if not bt <= max(m, 16) <= 32 * bt:
                        continue
                    ctas = -(-m // bt) * -(-n // bw)
                    steps = -(-(k // PACK) // words)
                    for split in tk.TC_SPLITS:
                        if split > steps or (split > 1 and
                                             ctas * split > 4 * n_sm):
                            continue
                        shape = (bt, bw, split)
                        ms = graph_ms(lambda: tk._launch_tensor_cores(
                            x, packed, scale, shape=shape))
                        rows_out.append({
                            "kernel": "ternary_matmul_tc", "tile": [bt, bw],
                            "split": split, "chosen": shape == auto,
                            "model": "qwen3-0.6b", "product": product,
                            "m": m, "k": k, "n": n, "dtype": name,
                            "device_ms": ms, "card": card})
                        log(f"  time ternary_matmul_tc {product} tile "
                            f"{bt}x{bw} split {split}"
                            f"{' (chosen)' if shape == auto else ''} M={m} "
                            f"K={k} N={n} {name} {ms:.6f} ms (graph), card "
                            f"{card}")

    # the program kernel at the AP matmul's shape
    rng = np.random.default_rng(SEED + 7)
    d, f = QWEN3_06B
    radix, rows = 3, AP_TOKENS * f
    width = apc.mac_acc_width(radix, d, AP_MAX_ABS)
    tiled = apc.compile_mac_tiled(radix, d, width, AP_K_TILE)
    x = rng.integers(-AP_MAX_ABS, AP_MAX_ABS + 1, (rows, AP_K_TILE))
    w = rng.integers(-1, 2, (rows, AP_K_TILE))
    n_parts = tiled.reduce_groups[0]
    cases = [(f"mac{radix} tile K{AP_K_TILE} w{width}", tiled.programs[0],
              apc.encode_mac_rows(x, w, radix, width)),
             (f"mac{radix} reduce {n_parts}x w{width}",
              tiled.reduce_programs[0],
              rng.integers(0, radix, (rows, tiled.reduce_programs[0]
                                      .min_cols)).astype(np.int8))]
    for label, prog, arr in cases:
        arr = torch.from_numpy(arr).to(dev)
        padded, _ = _pad_rows(arr, BLOCK_ROWS)
        sched, variant, pack = device_schedule(prog, None, dev)

        def run_kernel():
            return kernel.tap_run_program(
                padded, *sched, rows, block_rows=BLOCK_ROWS,
                collect_stats=True, pack=pack)
        _, counts = run_kernel()
        sets = int(counts[:, 0].long().sum())
        ms = event_ms(run_kernel, reps=3, inner=1)
        b = program_bound(sched, rows, padded.shape[1], sets, pack)
        row = {"kernel": "tap_run_program", "program": label,
               "steps": prog.n_steps, "rows": rows, "cols": padded.shape[1],
               "variant": variant, "pack": pack, "collect_stats": True,
               "ms": ms, "plain_ms": None, **b, "card": card}
        rows_out.append(row)
        log(f"  time tap_run_program {label} rows={rows} cols="
            f"{padded.shape[1]} steps={prog.n_steps} kernel {ms:.6f} ms per "
            f"launch, bound {b['bound_ms']:.6f} ms ({b['bound_by']}; serial "
            f"steps {b['serial_ms']:.6f} ms; one op per row "
            f"{b['per_row_ops_bound_ms']:.6f} ms), card {card}")
    return rows_out


def profile_step(step, name: str, card: str, log) -> dict:
    """One step (a decode step, a train step) under ``torch.profiler``:
    the CUDA kernels it ran, their device time and the five that took the
    most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]
    top = sorted(rows, key=lambda r: -r.self_device_time_total)[:5]
    out = {"kernels": sum(r.count for r in rows),
           "device_ms": sum(r.self_device_time_total for r in rows) / 1e3,
           "top": [{"name": r.key[:80], "count": r.count,
                    "device_ms": r.self_device_time_total / 1e3}
                   for r in top]}
    log(f"  profile {name}: {out['kernels']} CUDA "
        f"kernels, {out['device_ms']:.3f} ms of device time (torch.profiler"
        f", one step), card {card}")
    for r in out["top"]:
        log(f"    {r['count']:5d} x {r['name']}: {r['device_ms']:.3f} ms")
    return out


def mlp_share(model_res: dict, times: list[dict], card: str, log) -> dict:
    """The share of a kernel-route decode step that its packed-matmul
    launches take: phase 4's CUDA-graph time of the routed kernel at
    qwen3-0.6b's w1 and the serving batch (w3 has the same shape, w2 as
    many words) times the launches per step, over the step's median."""
    out = {}
    m = SERVE_SHAPE[0]
    for name in ("float32", "bfloat16"):
        row = next(x for x in times if x["kernel"] == "ternary_matmul"
                   and x.get("routed") and x["model"] == MODEL_ARCH
                   and x.get("product") == "w1" and x["m"] == m
                   and x["dtype"] == name)
        serve = model_res[name]["serve"]
        n = serve["launches_per_step"]["ternary_matmul"]
        step = serve["median_step_ms"]["kernel"]
        out[name] = {"kernel_device_ms": row["device_ms"], "launches": n,
                     "step_ms": step, "share": n * row["device_ms"] / step}
        log(f"  decode {name}: {n} x {row['device_ms']:.6f} ms of "
            f"ternary_matmul (graph, M = {m}) = "
            f"{n * row['device_ms']:.4f} ms of a {step:.3f} ms step "
            f"({100 * out[name]['share']:.2f} %), card {card}")
    return out


# ---------------------------------------------------------------------------
# Decode attention: against the plain version, and its times
# ---------------------------------------------------------------------------

def attention_case(b: int, h: int, hk: int, hd: int, length: int, seed: int,
                   dev):
    """q [b, 1, h, hd] and a bf16 cache of ``length`` slots, drawn on the
    card from ``seed``."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev)
    k = torch.randn((b, length, hk, hd), generator=gen, device=dev)
    v = torch.randn((b, length, hk, hd), generator=gen, device=dev)
    return (q.to(torch.bfloat16), k.to(torch.bfloat16),
            v.to(torch.bfloat16))


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in bf16 ulps of each element, the ulp taken
    at no less than 1/256 of its head's largest |want| (two fp32 sums in
    another order differ by about 1e-6 of the row there)."""
    import torch
    want = want.float()
    mag = torch.maximum(want.abs(),
                        want.abs().amax(dim=-1, keepdim=True) * 2.0 ** -8)
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    return float(((got.float() - want).abs() / ulp).max())


def phase_attention_vs_plain(dev, log) -> float:
    """The decode-attention kernel against its plain version, in bf16 at
    ATTN_CHECK_SHAPES with 1, half and all of the slots written, and
    ATTN_CHECK_SLOTS; returns the largest absolute difference.  Each must
    lie within one bf16 ulp (``bf16_ulps``)."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    worst = 0.0
    for i, (b, h, hk, hd, length) in enumerate(ATTN_CHECK_SHAPES):
        q, k, v = attention_case(b, h, hk, hd, length, SEED + 40 + i, dev)
        for n_valid in sorted({1, length // 2, length,
                               *(n for n in ATTN_CHECK_SLOTS
                                 if n <= length)}):
            got = dk.decode_attention(q, k, v, n_valid)
            want = decode_attention_ref(q, k, v, n_valid)
            ulps = bf16_ulps(got, want)
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            log(f"  decode_attention B={b} H={h} Hk={hk} hd={hd} "
                f"slots {n_valid}/{length}: max |diff| {err:.3g}, "
                f"{ulps:.3f} bf16 ulps")
            check(ulps <= 1.0, f"decode_attention B={b} H={h} Hk={hk} "
                               f"hd={hd} n_valid={n_valid}: {ulps} ulps")
    return worst


def phase_attention_times(dev, card: str, log) -> list[dict]:
    """The decode-attention kernel at ATTN_SHAPE and ATTN_POSITIONS: through
    its wrapper and as device time (a CUDA graph), beside its byte bound,
    its plain version, the einsum path it replaces and the library's
    ``scaled_dot_product_attention(enable_gqa=True)`` on the same bf16
    inputs (timed only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.attention import _attend_decode_einsum

    b, h, hk, hd, length = ATTN_SHAPE
    q, k, v = attention_case(b, h, hk, hd, length, SEED + 50, dev)
    rows = []
    for pos in ATTN_POSITIONS:
        n = pos + 1

        def run_kernel():
            return dk.decode_attention(q, k, v, n)
        qt, kt, vt = (q.transpose(1, 2), k[:, :n].transpose(1, 2),
                      v[:, :n].transpose(1, 2))

        def run_library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True)
        ms = event_ms(run_kernel, reps=5, inner=20)
        device_ms = graph_ms(run_kernel)
        plain_ms = event_ms(lambda: decode_attention_ref(q, k, v, n),
                            reps=3, inner=1)
        einsum_ms = event_ms(lambda: _attend_decode_einsum(
            q, k, v, pos, False), reps=3, inner=1)
        library_ms = event_ms(run_library, reps=5, inner=20)
        library_device_ms = graph_ms(run_library)
        n_bytes = 2 * b * n * hk * hd * 2 + 2 * b * h * hd * 2
        bnd = bound(n_bytes, 4 * b * h * n * hd, PEAK_FP32_FMA_FLOP_PER_S)
        row = {"kernel": "decode_attention", "b": b, "h": h, "hk": hk,
               "hd": hd, "slots": length, "pos": pos, "ms": ms,
               "device_ms": device_ms, "plain_ms": plain_ms,
               "einsum_ms": einsum_ms, "library_ms": library_ms,
               "library_device_ms": library_device_ms,
               "splits": dk.split_shape(b * hk, -(-n // dk.TILE),
                                        torch.cuda.get_device_properties(
                                            dev).multi_processor_count),
               **bnd, "card": card}
        rows.append(row)
        log(f"  time decode_attention B={b} H={h} Hk={hk} hd={hd} "
            f"pos={pos}: kernel {ms:.4f} ms (device {device_ms:.4f}), "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; "
            f"{100 * bnd['bound_ms'] / device_ms:.1f} % of it), plain "
            f"{plain_ms:.3f} ms, einsum path {einsum_ms:.3f} ms, library "
            f"{library_ms:.4f} ms (device {library_device_ms:.4f}), card "
            f"{card}")
    return rows


# ---------------------------------------------------------------------------

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement here")
    args = parser.parse_args()
    # phase 3f's resume check runs cuBLAS deterministically, which needs
    # this before the first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import cuda_lib
        from repro_torch.kernels.tap_pass import kernel
        from repro_torch.kernels.decode_attention import kernel as dk
        from repro_torch.kernels.ternary_matmul import kernel as tk
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}",
              file=sys.stderr)
        return 2
    # every float32 product on the card in full fp32: the library times and
    # the plain versions alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    report: dict = {"card": card}
    counters = (kernel.launch_counts, tk.launch_counts, dk.launch_counts)

    def log(msg: str) -> None:
        print(msg, flush=True)

    def main_path(label: str, phase, kernels: tuple[str, ...]):
        """Run one main path with every launch count set to 0 just before
        it and read just after; each of ``kernels`` must have launched."""
        for counts in counters:
            for k in counts:
                counts[k] = 0
        t0 = time.perf_counter()
        res = phase(dev, log)
        torch.cuda.synchronize()
        launched = {k: n for counts in counters for k, n in counts.items()}
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = launched
        log(f"  launches on the {label} path: {launched}")
        for k in kernels:
            check(launched[k] > 0, f"{k} was not launched on the {label} "
                                   f"path")
        return res

    t_start = time.perf_counter()
    try:
        log(f"[setup] python {sys.version.split()[0]} torch "
            f"{torch.__version__} cuda {torch.version.cuda} device "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"[setup] nvidia-smi: {card}")
        t0 = time.perf_counter()
        cuda_lib.build()
        report["build_s"] = time.perf_counter() - t0
        log(f"[setup] kernels built in {report['build_s']:.3f} s")
        report["ptxas"] = {}
        for name, text in cuda_lib.build_logs.items():
            report["ptxas"][name] = [
                line.strip() for line in text.splitlines()
                if "registers" in line or "spill" in line]
            for line in report["ptxas"][name]:
                log(f"[setup] {name}: {line}")

        log("[kernels vs plain]")
        max_err = phase_kernels_vs_plain(dev, log)
        max_err["tap_run_program"] = max(max_err["tap_run_program"],
                                         phase_mac_programs_vs_plain(dev,
                                                                     log))
        report["matmul_vs_plain"] = phase_matmul_vs_plain(dev, log)
        for name, errs in report["matmul_vs_plain"].items():
            max_err[name] = max(errs.values())
        max_err["decode_attention"] = phase_attention_vs_plain(dev, log)

        log("[main path: AP arithmetic]")
        report["main_path"] = main_path(
            "AP arithmetic", phase_main_path,
            ("tap_run_program", "tap_apply_schedule"))
        log("[main path: packed-ternary matmul, qwen3-0.6b MLP width]")
        report["matmul_path"] = main_path(
            "packed-ternary matmul", phase_matmul_path,
            ("ternary_matmul", "ternary_matmul_tc", "tap_run_program"))
        log("[main path: array pool and graph runtime]")
        report["pool_path"] = main_path(
            "array pool and graph runtime",
            lambda dev, log: phase_pool_path(dev, card, log),
            ("tap_run_program",))
        log("[main path: qwen3-0.6b at full width, model stack]")
        report["model_path"] = main_path(
            "qwen3-0.6b model",
            lambda dev, log: phase_model_path(dev, card, log),
            ("ternary_matmul", "ternary_matmul_tc", "decode_attention"))
        log(f"  phase 3d took {report['model_path']['seconds']:.3f} s")
        log("[main path: qwen3-0.6b at full width and depth, AP serving]")
        report["ap_serve_path"] = main_path(
            "qwen3-0.6b AP serving",
            lambda dev, log: phase_ap_serve_path(dev, card, log),
            ("tap_run_program", "ternary_matmul"))
        log(f"  phase 3e took {report['ap_serve_path']['seconds']:.3f} s")
        log("[main path: qwen3-0.6b at full width and depth, training]")
        report["train_path"] = main_path(
            "qwen3-0.6b training",
            lambda dev, log: phase_train_path(dev, card, log), ())
        log(f"  phase 3f took {report['train_path']['seconds']:.3f} s")
        log("[main path: qwen3-0.6b and a MoE layer on a named mesh]")
        report["mesh_path"] = main_path(
            "named mesh",
            lambda dev, log: phase_mesh_path(dev, card, log), ())
        log(f"  phase 3g took {report['mesh_path']['seconds']:.3f} s")
        log("[main path: qwen3-0.6b served on a named mesh, the examples]")
        report["mesh_serve_path"] = main_path(
            "mesh serving and examples",
            lambda dev, log: phase_mesh_serve_path(dev, card, log),
            ("ternary_matmul", "ternary_matmul_tc", "tap_run_program",
             "decode_attention"))
        log(f"  phase 3h took {report['mesh_serve_path']['seconds']:.3f} s")
        launches = {k: sum(report[p]["launches"][k] for p in (
            "main_path", "matmul_path", "pool_path", "model_path",
            "ap_serve_path", "train_path", "mesh_path", "mesh_serve_path"))
            for k in KERNELS}

        log("[times]")
        report["times"] = phase_times(dev, card, log)
        report["times"] += phase_matmul_times(dev, card, log)
        report["times"] += phase_attention_times(dev, card, log)
        report["model_path"]["mlp_share"] = mlp_share(
            report["model_path"], report["times"], card, log)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    def line_row(name):
        if name == "decode_attention":
            return next(x for x in report["times"] if x["kernel"] == name
                        and x["pos"] == ATTN_POSITIONS[-1])
        if name in MATMUL_LINE:
            model, product, m, dtype = MATMUL_LINE[name]
            return next(x for x in report["times"] if x["kernel"] == name
                        and x.get("routed") and x["model"] == model
                        and x.get("product") == product and x["m"] == m
                        and x["dtype"] == dtype)
        return next(x for x in report["times"] if x["kernel"] == name
                    and x.get("rows") == FULL_ROWS)

    kernels_line = []
    for name, meta in KERNELS.items():
        t = line_row(name)
        kernels_line.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")})
    report["kernels"] = kernels_line
    report["seconds"] = time.perf_counter() - t_start
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
