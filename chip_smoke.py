#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/``, then, each phase failing the run:

1. prints the card's name and power limit (``nvidia-smi``) and each
   kernel's registers, stack frame, spills and static shared memory from
   the ``-Xptxas -v`` build log, and holds the float32 attention kernel's
   and the bf16 backward's dynamic shared memory to their CPU copies;
2. holds every kernel against its plain PyTorch version on the card, word
   for word and bit for bit, at the paths' shapes, at a ragged shape of
   several tiles and at 2**24 values: the quantizers on inputs with exact
   half-level boundaries, out-of-range values and -0.0, pack_bits and
   unpack_bits at b in {1, 4, 7, 8, 13, 17, 24, 32} (7, 17 and 24: the
   sparse codec's index widths at 100, 70,001 and 2**24 values), the erasure mask
   over p, seeds and segment lengths; quantize_ef against the unpack of
   quant_pipeline, and (redesigned) at every pair of float32, bf16 and fp16
   msg and cache, with no cache, on views one element off at odd tails,
   and on 2**31 + 4097 bf16 values; pack_bits (redesigned) from uint8,
   uint16, int32 and bool values where they lie, at widths up to and past
   theirs, one element off, and on that leaf's uint8 wire; quant_pipeline
   on that leaf (its words pack_bits', its cache quantize_ef's) and
   unpack_bits of its words (the uint8 wire widened), one launch each, n
   past 2**31; sign_pipeline
   at 100, 70,001, 2**24, 1 and 32,769
   values with exact zeros and -0.0, and on msg and cache views off 16
   bytes (its 4-byte load path) (words equal, scale rtol 1e-6, new cache
   atol 1e-6; the scale bit for bit a numpy model of the kernel's
   fixed-order float64 sum and the new cache bit for bit msg + cache ∓
   that scale; a second call bit for bit the first), and on bf16 msg and
   cache at 100, 70,001 and 2**24 values and on views 2 bytes off 8 (its
   value-by-value path) (the same, with the bf16 new cache within one
   rounding of the plain version's and bit for bit bf16(msg + cache ∓
   the kernel's scale)); unpack_bits also
   from a word buffer one word off 16 bytes (its 4-byte load path); and flash_attention over S in {128, 257, 4353}, D
   in {64, 80, 120, 128} (80: zamba2's shared attention), (H, Hkv) in
   {(4, 4), (32, 8)}, window in {None, 64,
   4096}, softcap in {None, 30} and aligned or offset positions, in
   float32 (2e-5, on the float32 route's kernel, flash_attention.cu) and
   bf16 (one bf16 rounding of the output: 2**-7 |plain| + 1e-4, on the
   sm90 kernel, flash_attention_sm90.cu), each call's route read from the
   launch counts; the bf16 forward's saved statistics (each row's
   log-sum-exp, +inf where it sees no key, and O in float32) against the
   plain version's (1e-4); the backward against its plain version over S
   in {128, 257, 2048}, the same D and heads, window in {None, 64},
   softcap and offsets, in float32 (1e-4, on flash_attention_bwd.cu) and
   bf16 (one rounding of the gradient: 2**-7 |plain| + 1e-3, on
   flash_attention_bwd_sm90.cu, after one flash_attention_sm90 launch for
   the statistics), each call's route read from the launch counts, two
   calls equal bit for bit, rows that see no key, and FlashAttention's
   backward on it; quant_pipeline also on bf16 msg and cache; plus cases
   off the grid on both routes: a ring cache's
   positions (rotated, empty slots at 2**30), a q view with a sliced start
   and one whose base is off 16 bytes (bf16: copied first for TMA;
   float32: read with 4-byte copies), head dims 100, 32 and 16 (and 33
   and 17 in float32), 70 keys, a one-token prompt, two without the causal
   mask, and in float32 140,000 keys (past the key tiles the kernel plans
   at a time); the float32 kernel's shared memory for D = 1..128 against
   its CPU copy;
3. runs paper Table 1's "quant L=10 ±1 / Algorithm 2 (EF)" arm of Fed-LT at
   paper size (N=100 agents, m=500, d=100, ε=50; N_e=10, γ=0.005, ρ=20;
   fused uplink) for 300 rounds, printing e_K every 50 rounds, and checks
   that e_K is finite and falls, that the kernels ran once per round, and
   that one round's uplink through the kernel equals its plain version;
4. encodes one agent's uplink with the wire codec and decodes it back;
5. runs Fed-LTSat (paper Algorithm 3) through ``Experiment`` on the port's
   simulator at the constellation example's size (walker-kiruna, N=100,
   m=200, d=100, the same quantizer, fused uplink, cohort bytes) for 120
   rounds, then the example's async dual-station and lossy-uplink runs,
   checking e_K, the launches per round, and the first 10 sync rounds
   against the same run on the CPU;
6. runs the four canonical convergence scenarios on the card and holds
   their final bytes_up against ``CONV_reference.json``; e_K must fall,
   except in sync-mega-chaos, whose curve is held against the same
   scenario run on the CPU from the same draw;
7. drives the mega-1000 cohort uplink transport (``bench.sim_scale``):
   the lossy chains on mega-1000-lossy, then the lossless ones on
   mega-1000, each against the same chain through the plain versions;
8. runs sign_pipeline through its entry point, ops.sign_pipeline, on the
   Fed-LT run's last uplink (no path of the JAX package calls it): one
   launch, its scale reduced inside it, so the profile shows one device op
   per call;
9. serves h2o-danube-3-4b at full width in bf16 (random weights from a
   seeded generator): prefill of 4 prompts x 8192 tokens, then 32 greedy
   decode steps, checking finite logits and 24 flash_attention_sm90
   launches per prefill (the bf16 route), no other, and none in decode;
   then the same model at depth 2 in float32, prefill of 1 x 5000 tokens
   and 4 decode steps through the kernel (backend "chunked", 2
   flash_attention launches per prefill: the float32 route) and the plain
   attention (backend "xla", none), whose logits must agree within
   relative L2 error 1e-4;
10. profiles a few rounds of phases 3 and 5 (and of the example's
    FedAvg(space) arm, phase 13, and of the lossy table, phase 15) and the
    serving steps with
    ``torch.profiler``, and times each kernel with CUDA events beside its
    bound, its plain version and, for the two attention kernels, PyTorch's
    scaled_dot_product_attention, at the path's shape and, for the uplink
    kernels, at 2**24 values, each beside its share of the bound
    (sign_pipeline's is the function's 12.125 B per value, and its
    two-pass design's 20.125 B and 12.125 B + what the L2 cannot hold of
    the second read are printed beside it; flash_attention_sm90 at the
    serving prefill's shape, with and without the backward's statistics;
    flash_attention at the depth-2 float32 prefill's, and alone at the
    serving prefill's shape in float32; the backward on each route at the
    training shape, with its device time by grid); flash_attention_sm90's output at the
    path's shape is held against its plain version, one batch row at a
    time, and decode's device time is attributed to the ops that launch
    it and their input shapes;
11. holds the sign and sparse wire codecs on the card at 100, 70,001 and
    2**24 values, on ScaledSign, TopK(0.1) and RandD(0.2) outputs and on
    all-zero leaves (k = 0: no launch): words equal the plain version's and
    the CPU encode's word for word, and the decode gives C(x) back bit for
    bit;
12. runs paper Table 2 at the paper's size (``repro_torch.bench.
    table2_space_comparison``: N=100, m=500, d=100, ε=50 on Walker(100, 10)
    with k_direct=4, n_relay=2): all five algorithms under all four
    compressors through ``Experiment``, one Monte-Carlo run of
    TABLE2_ROUNDS rounds each (cut from the paper's 400 for time), checking
    that e_K is finite in every cell, falls in every cell but LED's, and
    in LED's rises by no more than TABLE2_LED_RISE, that the quant_coarse cells'
    first 10 rounds equal the CPU's (x and the received wires, rtol 1e-5,
    atol 1e-6), that the rand_0.2 cells' bytes_up equal the CPU's, and that
    a rand_0.2 FedAvg cell with ``measure="cohort"`` launches pack_bits once
    per landed update; prints the e_K table;
13. runs the constellation example's FedAvg(space) arm through
    ``repro_torch.examples.satellite_constellation`` and prints its
    ``obs.render_rounds`` table;
14. checkpoints and resumes the main path on the card: Fed-LTSat on
    walker-kiruna (the example's sizes, fused uplink, cohort bytes) and
    RandD(0.2) on the batched chain, each for 2R rounds (R =
    RESUME_ROUNDS) with a checkpoint every round and without, then R
    rounds and a fresh ``Experiment`` resumed to 2R, then a copy of that
    directory with its newest npz torn, resumed from round R-1: each held
    bit for bit to the uninterrupted run (every state leaf, every
    RoundLog), the resumed rounds' launches counted (quant_pipeline and
    unpack_bits once per round, pack_bits once for the byte probe), and
    one ``save_round`` timed;
15. runs the lossy-EF, fault-tolerance and plane-aggregation tables
    (``repro_torch.bench.table_*``) at the cut sizes of LOSSY_CUT,
    FAULT_CUT and PLANE_CUT_ROUNDS, each table's rows read back from its
    ledger under build/ and held against the same cut run on the CPU from
    the card's data (bytes, losses, updates and simulated time equal, e_K
    within rtol 1e-4; a fault arm whose e_K parts is run again on the card,
    on the contact plan's horizon that arm started on in the table's
    sweep, with a checkpoint every round, and the CPU's run held to it in
    lockstep, every round within rtol 1e-4, each round whose wires part a
    rounding tie, after which the CPU resumes from the card's checkpoint),
    plus the plane table's fast-vs-oracle ``smoke``; and ``python -m
    repro_torch.obs`` ``report --frontier`` on the lossy ledger and
    ``check`` and ``chrome`` on phase 14's trace, as subprocesses that
    must exit 0;
16. runs ``python -m repro_torch.obs convgate`` on phase 6's four traces
    (written to build/) and prints each scenario's verdict; it must reach
    one (exit 0 or 1).  Phase 6 runs on the port's own draws, and the
    1.25x e_K gate holds with JAX's (``tests/test_torch_canonical.py``),
    so a failing verdict is recorded, not failed on.  The obs CLI's four
    subprocesses run beside phases 14 and 15.
17. trains stablelm-1.6b at full width and depth in bf16 (random weights
    from the launcher's seed) through ``python -m repro_torch.launch.train``'s
    ``main``: 2 agents x batch 2 x 2048 tokens, 2 local epochs, 3 rounds and
    a checkpoint on the last (17a): every loss finite and the last below
    the first, each round's launches 96 flash_attention_bwd_sm90 and 192
    flash_attention_sm90 (24 layers x 2 agents x 2 epochs, the forward
    twice under remat, the second time with the backward's statistics)
    and two quantize_ef a leaf (uplink, and downlink with no cache), and
    nothing else, the checkpoint restoring bit for bit, ms per round and
    peak memory, and one more round whose c_up, ŷ and c_down equal the old
    route's (the plain quantizer, ``ref.quantize_ef_ref``, called
    directly) bit for bit on the largest leaf of each dtype; then one round
    with pack_wire=True (17b): one quant_pipeline launch per leaf of at
    least 32768 values and one unpack_bits per run of 2**25 values of it
    (``deploy.PIECE``), quantize_ef for the rest
    and the downlink, the state against the old route as in 17a, and the
    fused uplink equal bit for bit to the unfused one (quantize_ef and
    pack_bits) leaf by leaf (words, gathered values, means, caches); a
    profiled round; and the model at depth 2 in float32 (17c), one round
    with compression off through the kernels against plain attention
    (autograd), every state leaf within rtol 1e-4 / atol 1e-5.
18. runs the benchmark harness (``repro_torch.bench``) at its tiny size on
    the card and emits it with the mega-1000 trace into build/bench_out/:
    every registered benchmark ran, the emitted files name the card, every
    gated metric of the committed baseline (``src/repro_torch/bench/
    baseline``) is present and finite, pack_bits, unpack_bits,
    quantize_ef, quant_pipeline and erasure_mask each launched (counts
    printed on a [bench] line, not added to the main paths' counts), the
    port's ``obs check`` passes on the trace (a subprocess) and
    ``profile_round --check-equivalence`` on mega-1000 exits 0; then it
    prints ``compare``'s table against the baseline, which gates nothing
    here (the host's speed moves between calls).
19. runs the MoE, Mamba2 and RWKV6 families (``models/moe.py``,
    ``mamba2.py``, ``rwkv6.py``) at full width in bf16 with seeded random
    weights (FAMILY_SERVE): mixtral-8x7b at 8 of 32 layers, zamba2-2.7b
    and rwkv6-3b at full depth, each a prefill of 4 x 8192 and 32 greedy
    decode steps through launch/serve.py, and grok-1-314b at 1 of 64
    layers, 1 x 4096 and 4 steps: logits finite, each prefill one
    flash_attention_sm90 launch per attention layer at the model's head dim
    (80 for zamba2's shared block), window (4096) and softcap (30),
    rwkv6's none, decode none; prefill tokens/s, decode ms per step and
    peak memory; flash_attention_sm90 at each attention family's prefill
    shape (mixtral 32/8 heads D 128 W 4096, zamba2 32/32 D 80, grok 48/8
    D 128 softcap 30) against its plain version, one batch row at a time;
    mixtral, zamba2 (2 units), rwkv6 at depth 2 and grok at depth 1 in
    float32 (FAMILY_CHECK), a prefill of 1 x 5000 into a cache of 5004
    and 4 decode steps on the same sequence, kernel against plain
    attention within rel L2 1e-4 in every logit row (a route that flips
    at a rounding tie, ROUTE_TIE, is counted and its rows left out), and
    for zamba2 and rwkv6 each decode step (the recurrence) against a full
    forward over the 5004 tokens (the chunked scan) within 1e-4; then
    DeployFedLT training as in 17a (FAMILY_TRAIN: mixtral at 1 layer,
    zamba2 at full depth, rwkv6 at 16 of 32 layers at γ 0.01; 3 rounds
    each): losses
    finite and falling, each round's launches the attention layers' and
    the wire's quantize_ef and nothing else, round 0's quantized state the
    old route's on the largest leaf per dtype, ms per round and peak
    memory; one mixtral round with
    pack_wire=True checked as 17b; and zamba2's lm_loss gradient at 2 units
    in float32 through the kernels against plain attention, with its
    controls, as 17c;
20. runs the launch slice (``launch/mesh.py``, ``sharding.py``,
    ``dryrun.py``) on a 1-rank NCCL process group: paper Table 1's fused
    Fed-LT arm for 10 rounds through ``FedLT.round_sharded`` on a
    ``("fleet",)`` mesh against ``FedLT.round`` (e_K and every leaf
    within rtol 1e-5, the same quant_pipeline and unpack_bits launches a
    round); one packed ``DeployFedLT`` round of stablelm-1.6b at full
    width, 4 layers, bf16, as DTensors on a ``("data",)`` mesh with
    ``agent_replicate_spec`` and as plain tensors without it (states equal
    bit for bit, launches as 17b derives them); the sharded states saved
    with their specs and restored onto their meshes bit for bit; and,
    beside those, ``python -m repro_torch.launch.dryrun`` on the host for
    stablelm-1.6b's decode_32k (single and multi pod) and train_4k
    (unrolled, one repeat), each record's keys, chips, agents, positive
    counts and bottleneck checked.
21. runs gemma3-27b, granite-20b, qwen2-vl-7b and musicgen-large: served
    at full width and depth in bf16, held at a cut depth in float32
    against plain attention, trained through DeployFedLT at a cut depth
    (CATALOG_TRAIN), granite-20b and gemma3-27b then with one packed round
    each, checked as 17b (gemma3's tied table with two agents is one leaf
    of 2.82e9 values, past 2**31; its ms, peak memory and launches beside
    the unpacked rounds' peak), gemma3's float32 gradient through the
    kernels at one unit, the attention kernels at the new head groups and
    window, and the quickstart and serve_lm examples.
22. runs the JAX package's configurations that no other phase runs:
    (22a) h2o-danube-3-4b served with the int8 KV cache at 4 x 8192 + 32
    steps beside the bf16 cache (prefill logits equal bit for bit, the
    ring's codes and scales equal ``_kv_quant`` on the CPU bit for bit,
    decode logits within a derived limit, kv_int8_rel_l2), and at depth 2
    in float32 against the CPU; (22b) stablelm-1.6b and h2o-danube-3-4b
    at 1 x 32768 + 32 steps, and flash_attention_sm90 at that length
    against its plain version on three blocks of 1024 query rows; (22d)
    a stablelm-1.6b round at remat_group 4 against remat_group 1, equal
    bit for bit; (22c) quorum rounds (agent 1 dropped) on the packed
    fused, packed unfused and unpacked routes, equal bit for bit, the
    dropped agent's cache its corrected message, ŷ the survivor's wire,
    and at depth 2 in float32 against the CPU; (22e) the
    train_federated_lm example's 100m preset for 5 rounds and its smoke
    preset on the card against the CPU; (22f) the launcher with
    ``--no-compress --trace --ledger``.

Phases 11–16 run after phase 8, phase 17 after phase 9, phase 18 after
phase 22.  The launch
counts are zeroed just before each main-path run (phases 3–4, each run of
phase 5, each chain run of phase 7, phase 8, each cell of phase 12 and
phase 13, each resumed run of phase 14, each card run of phase 15, the
timed prefill, the decode steps and the depth-2 float32 prefills of phase
9, the launcher's run and each later round of phase 17, and each timed
prefill, decode run, float32 check and training round of phase 19, each
round of phase 20, each prefill, decode run and round of phase 22) and
read just after.  Then it prints each phase's seconds ([time]), the card's name and
power limit again, one JSON line with a record per kernel and, last,
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits with an
error and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEV = "cuda"
PAPER = dict(n_agents=100, m=500, dim=100)   # benchmarks/common.py PAPER, ε=50
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 dense tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM TF32 dense tensor cores; a float32 product
TF32_TERMS = 3                # as three TF32 products keeps float32 accuracy
MAIN_N = 100 * 100            # the fused uplink: (N, d) = (100, 100)
AGENT_N = 100                 # one agent's uplink, d = 100
BIG_N = 2**24
SIZES = (MAIN_N, 70_001, BIG_N)
BITS = (1, 4, 7, 8, 13, 17, 24, 32)   # 7, 17, 24: the sparse codec's index widths
QUANT_CONFIGS = ((10, -1.0, 1.0), (10, -10.0, 10.0), (255, -1.0, 1.0),
                 (255, -10.0, 10.0), (1023, -1.0, 1.0), (1023, -10.0, 10.0))
ROUND_CHUNKS = (1, 49, 50, 50, 50, 50, 49, 1)     # 300 rounds, e_K at 1, 50, …
TOL = "exact: words equal word for word, new caches equal bit for bit"
# the constellation example's rounds (its sizes: examples.satellite_constellation)
SAT_ROUNDS = 120
# bench.sim_scale's path shapes: one satellite's update, and the words of
# one cohort or satellite at 8 bits (one tile)
UPDATE_N = 2048
WORDS_N = 8 * 1024
EF_CONFIGS = ((10, -1.0, 1.0), (10, -0.25, 0.25), (255, -1.0, 1.0),
              (255, -0.25, 0.25), (1023, -1.0, 1.0), (1023, -0.25, 0.25))
ERASE_PS = (0.0, 0.1, 0.25, 1.0)
ERASE_SEEDS = (0, 7, 2**32 + 5)
ERASE_SEGMENTS = (1, 32, 100)
# flash_attention checks: (rtol, atol) for |kernel - plain| <= atol + rtol
# |plain|.  Both sides sum in float32 and round to the output's type once,
# so in bf16 they differ by at most one rounding: one ulp, <= 2**-7 |plain|
FLASH_S = (128, 257, 4353)
FLASH_D = (64, 80, 120, 128)      # 80: zamba2-2.7b's shared attention
FLASH_HEADS = ((4, 4), (32, 8))
FLASH_WINDOWS = (None, 64, 4096)
FLASH_CAPS = (None, 30.0)
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2**-7, 1e-4)}
RING_SLOTS = 4096             # a ring cache of the serving window's size
SIGN_SIZES = (100, 70_001, BIG_N, 1, 32_769)
SIGN_OFFSET_N = 70_001        # sign_pipeline on views 4 bytes off 16-byte alignment
SIGN_BF16_SIZES = (100, 70_001, BIG_N)   # and on bf16 msg and cache
# serving h2o-danube-3-4b (configs/catalog.py) at full width
SERVE_ARCH = "h2o-danube-3-4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 8192, 32
CHECK_PROMPT, CHECK_STEPS, CHECK_REL_L2 = 5000, 4, 1e-4
# the sign and sparse wire codecs (phase 11)
CODEC_SIZES = (100, 70_001, BIG_N)
# paper Table 2 at the paper's size (phase 12): rounds cut from its 400 to
# keep the phase near a minute; N, m and d are the paper's
TABLE2_ROUNDS = 60
TABLE2_CHECK_ROUNDS = 10
# LED's e_K stays near its start (γ=0.01 in benchmarks/common.py): in the
# JAX package it ends its 400 rounds at 23.85–23.99 from 24.006 at x = 0.
# Its cells are held to a last e_K at most 1% above the first, not a falling one
TABLE2_LED_RISE = 1.01
# phases 14-16: checkpoint/resume, the ledger tables at a cut size, convgate
BUILD = ROOT / "build"
RESUME_ROUNDS = 20            # R: a run checkpointed at round R resumes to 2R
CKPT_SAVES = 20               # save_round calls timed for the per-round cost
# the three ledger tables, cut for time (their full sizes: PERF.md §6): the
# lossy table at 2 of its 5 loss rates x 3 arms x 100 of 1500 rounds, the
# fault table at 2 of its 3 crash rates x 2 arms x 60 of 300 rounds, and the
# plane-agg table's walker sweep at 10 of 60 rounds (not its mega sweep),
# with its --smoke; N, m and d are each table's own
# phase 17: federated training of stablelm-1.6b at full width and depth in
# bf16 through python -m repro_torch.launch.train, with the launcher's
# traffic at --seq 2048 (16 key tiles of 128), then one packed-wire round
# and the depth-2 float32 kernel-vs-plain round
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_AGENTS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_EPOCHS, TRAIN_ROUNDS = 2, 2, 2048, 2, 3
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--agents", str(TRAIN_AGENTS), "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--n-epochs", str(TRAIN_EPOCHS),
              "--gamma", "0.02", "--rho", "10", "--rounds", str(TRAIN_ROUNDS)]
# the depth-2 float32 round, kernels (backend chunked) against plain
# attention (backend xla): (rtol, atol) on every state leaf
TRAIN_F32_TOL = (1e-4, 1e-5)
# and lm_loss's gradient at depth 2, float32, leaf by leaf: max |kernels -
# plain| <= TRAIN_GRAD_RTOL max |plain| (3.8e-6 measured on an H100 80GB
# HBM3 at 700 W); a backward that zeroes dq, dk or dv parts by 1.0 there
TRAIN_GRAD_RTOL = 1e-4
# phase 19: the MoE, Mamba2 and RWKV6 families at full width in bf16, with
# seeded random weights: (arch, depth changes, prompts, prompt, decode steps);
# mixtral at 8 of 32 layers (11.9 B parameters; all 32 would need 93 GB),
# grok at 1 of 64 (5.7 B)
FAMILY_SERVE = (
    ("mixtral-8x7b", dict(n_layers=8, scan_repeats=8), 4, 8192, 32),
    ("zamba2-2.7b", {}, 4, 8192, 32),
    ("rwkv6-3b", {}, 4, 8192, 32),
    ("grok-1-314b", dict(n_layers=1, scan_repeats=1), 1, 4096, 4),
)
# their float32 checks at full width and a cut depth (zamba2: 2 units of 6;
# grok: 1 layer, 23 GB), a prefill of 1 x 5000 then 4 decode steps, each
# logit row within CHECK_REL_L2
FAMILY_CHECK = {"mixtral-8x7b": dict(n_layers=2, scan_repeats=2),
                "zamba2-2.7b": dict(n_layers=12, scan_repeats=2),
                "rwkv6-3b": dict(n_layers=2, scan_repeats=2),
                "grok-1-314b": dict(n_layers=1, scan_repeats=1)}
FAMILY_CHECK_PROMPT, FAMILY_CHECK_STEPS = 5000, 4
# a route that flips between kernel and plain attention is a rounding tie
# when the plain run's probabilities of the swapped experts lie this close
ROUTE_TIE = 1e-4
# training through DeployFedLT as phase 17a (bf16): (arch, depth changes,
# γ): mixtral at 1 of 32 layers (1.71 B parameters), zamba2 at full depth,
# rwkv6 at 16 of 32 (its state alone would take ~50 GB at 32), at γ = 0.01:
# at the launcher's 0.02 and its 2048-token sequences, 16 RWKV6 layers end
# their 3 rounds above the first loss at every width, in float32 as in bf16,
# and fall at 256 tokens (``--rwkv6-gamma``); the JAX package's loss rises
# too, round for round with the port's, at width 512 and 2048 tokens on the
# CPU (``python tests/test_torch_deploy.py rwkv6-3b 512 16 0.02 3 float32 2048``)
FAMILY_TRAIN = (("mixtral-8x7b", dict(n_layers=1, scan_repeats=1), 0.02),
                ("zamba2-2.7b", {}, 0.02),
                ("rwkv6-3b", dict(n_layers=16, scan_repeats=16), 0.01))
FAMILY_TRAIN_ROUNDS = 3
LOSSY_CUT = dict(loss_rates=[0.0, 0.2], rounds=100)
FAULT_CUT = dict(crash_rates=[0.0, 0.1], rounds=60)
PLANE_CUT_ROUNDS = 10


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns (uint32 words, or floats including signed zeros;
    bf16 read through int16)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.contiguous().view(as_int), b.contiguous().view(as_int))


def same_wire(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal uint8/uint16 level indices (uint16 read through int16)."""
    from repro_torch.kernels.ref import as_int64
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        as_int64(a), as_int64(b))


def launched(fn):
    """``fn()`` and the kernel launches it made: (result, {name: n})."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def int_err(a: torch.Tensor, b: torch.Tensor) -> float:
    from repro_torch.kernels.ref import as_int64
    return float((as_int64(a) - as_int64(b)).abs().max())


# -- phase 1 ---------------------------------------------------------------

#: ptxas's report per kernel entry function, from phase 1's build log
PTXAS: dict = {}


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled ``..._kernel`` entry function (the
    integer and bool template arguments), else the mangled name."""
    for m in re.finditer(r"(?=(\d+))", mangled):     # every digit run's suffixes
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if name.endswith("_kernel") and re.fullmatch(r"[a-z]\w*", name):
            rest = mangled[end + len(name):]
            args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EE") + 2]) \
                if rest.startswith("I") else []
            return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_entries(log: str) -> list:
    """One record per entry function of an ``-Xptxas -v`` log: its kernel
    name with its template arguments, registers, stack frame, spill stores
    and loads, and static shared memory (bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": kernel_name(m.group(1)), "registers": None, "stack": 0,
                   "spill_stores": 0, "spill_loads": 0, "smem_static": 0}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                cur["smem_static"] = int(m[1])
    return out


def phase_build() -> str:
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"[build] {len(paths)} libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()))
    for src, log in _build.build_log.items():
        PTXAS[src] = ptxas_entries(log)
        for e in PTXAS[src]:
            print(f"[build] {src} {e['entry']}: {e['registers']} registers, "
                  f"{e['stack']} B stack frame, {e['spill_stores']} B spill stores, "
                  f"{e['spill_loads']} B spill loads, {e['smem_static']} B static "
                  "shared memory (ptxas -v)")
    check_f32_smem()
    check_bwd_sm90_smem()
    check_f32_bwd_smem()
    check_f32_bwd_sass(paths["flash_attention_bwd.cu"])
    return smi


def check_f32_smem() -> None:
    """The float32 attention kernel's dynamic shared memory, as its library
    reports it for every head dim, against its CPU copy
    (flash_attention.f32_smem_bytes) and the card's 227 KB per block."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    fn = _build._library("flash_attention.cu").repro_flash_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    card = {d: fn(d) for d in range(1, fa.MAX_HEAD_DIM + 1)}
    off = {d: (n, fa.f32_smem_bytes(d)) for d, n in card.items()
           if n != fa.f32_smem_bytes(d) or n > fa.SMEM_LIMIT}
    check(not off, f"float32 attention shared memory (kernel, CPU copy) by D: {off}")
    print(f"[build] flash_attention.cu dynamic shared memory equals f32_smem_bytes "
          f"for D = 1..{fa.MAX_HEAD_DIM}, at most {max(card.values())} B "
          f"(<= {fa.SMEM_LIMIT}); {card[120]} B at D = 120")


def check_f32_bwd_smem() -> None:
    """The float32 backward's dynamic shared memory per block of each grid,
    as its library reports it for every head dim, against its CPU copy
    (flash_attention.f32_bwd_smem_bytes) and the card's 227 KB a block."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    fn = _build._library("flash_attention_bwd.cu").repro_flash_attention_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    off = {}
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        card = (fn(d, 0), fn(d, 1))
        if card != fa.f32_bwd_smem_bytes(d) or max(card) > fa.SMEM_LIMIT:
            off[d] = (card, fa.f32_bwd_smem_bytes(d))
    check(not off, f"float32 backward shared memory (kernel, CPU copy) by D: {off}")
    print(f"[build] flash_attention_bwd.cu dynamic shared memory (dK/dV grid, dQ grid) "
          f"equals f32_bwd_smem_bytes for D = 1..{fa.MAX_HEAD_DIM}: {fn(64, 0)} and "
          f"{fn(64, 1)} B at D <= 64, {fn(128, 0)} and {fn(128, 1)} B above")

def check_f32_bwd_sass(lib) -> None:
    """The float32 backward runs on the tensor cores: ``cuobjdump -sass`` of
    its library shows TF32 HMMA instructions in its dK/dV and dQ grids, and
    the library needs no other library than the C runtime's (no cuBLAS or
    cuDNN: ``ldd``)."""
    cuobjdump = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    hmma, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : \S*(flash_attention_bwd_(?:prep|dkdv|dq)_kernel)", line)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"\bHMMA\S*TF32", line):
            hmma[fn] = hmma.get(fn, 0) + 1
    needed = subprocess.run(["ldd", str(lib)], capture_output=True, text=True).stdout
    libs = sorted({m.group(1) for m in re.finditer(r"^\s*(\S+)", needed, re.M)})
    check(all(hmma.get(f"flash_attention_bwd_{g}_kernel", 0) > 0 for g in ("dkdv", "dq"))
          and not any(x in needed for x in ("cublas", "cudnn", "torch")),
          f"float32 backward: TF32 HMMA instructions by kernel {hmma}; needs {libs}")
    print(f"[build] flash_attention_bwd.cu SASS: TF32 HMMA instructions by kernel {hmma} "
          f"(HMMA.1688.F32.TF32: mma.sync m16n8k8, three per float32 product); the "
          f"library needs {libs}: no cuBLAS, cuDNN or torch")


def check_bwd_sm90_smem() -> None:
    """The bf16 backward's dynamic shared memory per block of each grid, as
    its library reports it for every head dim at the training shape's and
    a long sequence's plans, against its CPU copy
    (flash_attention.sm90_bwd_smem_bytes) and the card's 227 KB a block."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    fn = _build._library("flash_attention_bwd_sm90.cu").repro_flash_attention_bwd_sm90_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    off = {}
    for s in (TRAIN_ATTN["s"], 70_001):
        for d in range(1, fa.MAX_HEAD_DIM + 1):
            card = (fn(d, s, s, 0), fn(d, s, s, 1))
            if card != fa.sm90_bwd_smem_bytes(d, s, s) or max(card) > fa.SMEM_LIMIT:
                off[(s, d)] = (card, fa.sm90_bwd_smem_bytes(d, s, s))
    check(not off, f"bf16 backward shared memory (kernel, CPU copy) by (S, D): {off}")
    print(f"[build] flash_attention_bwd_sm90.cu dynamic shared memory (dK/dV grid, dQ "
          f"grid) equals sm90_bwd_smem_bytes for D = 1..{fa.MAX_HEAD_DIM} at S = "
          f"{TRAIN_ATTN['s']} and 70,001; at the training shape "
          f"{fn(TRAIN_ATTN['d'], TRAIN_ATTN['s'], TRAIN_ATTN['s'], 0)} and "
          f"{fn(TRAIN_ATTN['d'], TRAIN_ATTN['s'], TRAIN_ATTN['s'], 1)} B")


# -- phase 2 ---------------------------------------------------------------

def quant_inputs(n: int, levels: int, vmin: float, vmax: float, rng):
    """msg and cache with exact half-level boundaries, their neighbours,
    out-of-range values and signed zeros at the front (cache 0 there, so
    msg + cache keeps them exact)."""
    delta = (vmax - vmin) / levels
    half = (vmin + (np.arange(levels) + 0.5) * delta).astype(np.float32)
    special = np.concatenate([
        half, np.nextafter(half, np.float32(np.inf)),
        np.nextafter(half, np.float32(-np.inf)),
        np.array([vmin, vmax, -0.0, 0.0, 3 * vmin, 3 * vmax, vmin - delta,
                  vmax + delta, np.nextafter(np.float32(vmax), np.float32(0))],
                 np.float32)])
    msg = rng.uniform(1.25 * vmin, 1.25 * vmax, n).astype(np.float32)
    cache = rng.uniform(-delta, delta, n).astype(np.float32)
    k = min(n, special.size)
    msg[:k] = special[:k]
    cache[:k] = np.where(np.arange(k) % 2 == 0, np.float32(0.0), np.float32(-0.0))
    return torch.from_numpy(msg).to(DEV), torch.from_numpy(cache).to(DEV)


def phase_kernels(rng) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    from repro_torch.kernels.pack_bits import pack_bits, unpack_bits
    err = {name: 0.0 for name in SOURCES}
    for n in (AGENT_N,) + SIZES:
        for bits in BITS:
            hi = 2**bits
            vals = torch.from_numpy(rng.integers(0, hi, n, dtype=np.uint64)
                                    .astype(np.uint32)).to(DEV)
            words = pack_bits(vals, bits)
            words_p = ref.pack_bits_ref(vals, bits)
            check(same_bits(words, words_p), f"pack_bits n={n} b={bits} differs "
                  "from its plain version")
            err["pack_bits"] = max(err["pack_bits"], int_err(words, words_p))
            back = unpack_bits(words, bits, n)
            back_p = ref.unpack_bits_ref(words, bits, n)
            shifted = torch.empty(words.numel() + 1, dtype=torch.uint32, device=DEV)
            shifted[1:] = words             # a base 4 bytes off 16: scalar loads
            back_odd = unpack_bits(shifted[1:], bits, n)
            check(same_bits(back, back_p) and same_bits(back, vals)
                  and same_bits(back_odd, back_p),
                  f"unpack_bits n={n} b={bits} differs from its plain version, "
                  "does not invert pack_bits, or differs when its words are one "
                  "word off 16 bytes")
            err["unpack_bits"] = max(err["unpack_bits"], int_err(back, back_p))
        print(f"[kernels] pack_bits/unpack_bits n={n} b={BITS} (unpack also from "
              f"words one word off 16 bytes): {TOL}")
    check_pack_widths(rng, err)
    for n in SIZES:
        for levels, vmin, vmax in QUANT_CONFIGS:
            msg, cache = quant_inputs(n, levels, vmin, vmax, rng)
            words, newc = quant_pipeline(msg, cache, levels=levels, vmin=vmin,
                                         vmax=vmax)
            words_p, newc_p = ref.quant_pipeline_ref(msg, cache, levels=levels,
                                                     vmin=vmin, vmax=vmax)
            check(same_bits(words, words_p) and same_bits(newc, newc_p),
                  f"quant_pipeline n={n} L={levels} ±{vmax} differs from its "
                  "plain version")
            err["quant_pipeline"] = max(err["quant_pipeline"],
                                        int_err(words, words_p),
                                        float((newc - newc_p).abs().max()))
        print(f"[kernels] quant_pipeline n={n} (L, vmin, vmax) in "
              f"{QUANT_CONFIGS}: {TOL}")
    check_quant_bf16(rng)
    check_quantize_ef(rng, err)
    check_erasure_mask(rng, err)
    check_sign_pipeline(rng, err)
    check_flash_attention(err)
    check_flash_bwd(err)
    torch.cuda.synchronize()
    return err


def card_ints(a: np.ndarray, dtype) -> torch.Tensor:
    """numpy integers as a card tensor of ``dtype`` (uint16 through an
    int16 view: no uint16 cast kernel is needed)."""
    if dtype == torch.uint16:
        return torch.from_numpy(a.astype(np.uint16).view(np.int16)).to(DEV).view(dtype)
    np_dtype = {torch.uint8: np.uint8, torch.int32: np.int32, torch.bool: np.bool_}[dtype]
    return torch.from_numpy(a.astype(np_dtype)).to(DEV)


def check_pack_widths(rng, err: dict) -> None:
    """pack_bits (redesigned: a block per tile, four columns a thread, the
    values read at their own width) from uint8, uint16, int32 and bool
    values against its plain version, word for word: at the paths' sizes
    and odd tails, at bit widths up to and past the values' width (planes
    above it are zero), from a base one element off its vector (value by
    value), and from int32 values that are negative at b = 32 (two's
    complement words)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pack_bits import pack_bits
    widths = {torch.uint8: (1, 4, 8, 11), torch.uint16: (4, 8, 13, 16),
              torch.int32: (1, 2, 4, 8, 13, 17, 32), torch.bool: (1, 3)}
    for n in (AGENT_N, UPDATE_N, 70_001, BIG_N + 3):
        for dtype, bit_list in widths.items():
            for bits in bit_list:
                hi = 2 if dtype == torch.bool else 2 ** min(bits, 8 * dtype.itemsize)
                vals = card_ints(rng.integers(0, hi, n + 1), dtype)
                for what, x in (("aligned", vals[:n]), ("one element off", vals[1:])):
                    (words, made) = launched(lambda: pack_bits(x, bits))
                    want = ref.pack_bits_ref(x, bits)
                    check(made == {"pack_bits": 1} and same_bits(words, want),
                          f"pack_bits from {dtype} n={n} b={bits} ({what}): launches "
                          f"{made}, or words differ from its plain version")
                    err["pack_bits"] = max(err["pack_bits"], int_err(words, want))
        print(f"[kernels] pack_bits redesigned, n={n}, from {[str(d)[6:] for d in widths]} "
              f"values read where they lie, b up to and past their width, aligned and "
              f"one element off: one launch each, {TOL}")
    neg = card_ints(rng.integers(-2**31, 2**31, 70_001), torch.int32)
    check(same_bits(pack_bits(neg, 32), ref.pack_bits_ref(neg, 32)),
          "pack_bits of negative int32 at b=32 differs from its plain version")


def check_quant_bf16(rng) -> None:
    """quant_pipeline on bf16 msg and cache (a bf16 model's uplink) against
    its plain version: one launch each, words word for word, the bf16 new
    cache bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    for n in SIZES:
        for levels, vmin, vmax in QUANT_CONFIGS:
            msg, cache = (t.to(torch.bfloat16) for t in quant_inputs(n, levels, vmin,
                                                                     vmax, rng))
            (words, newc), made = launched(lambda: quant_pipeline(
                msg, cache, levels=levels, vmin=vmin, vmax=vmax))
            words_p, newc_p = ref.quant_pipeline_ref(msg, cache, levels=levels,
                                                     vmin=vmin, vmax=vmax)
            check(made == {"quant_pipeline": 1} and newc.dtype == torch.bfloat16
                  and same_bits(words, words_p) and same_bits(newc, newc_p),
                  f"quant_pipeline bf16 n={n} L={levels} ±{vmax}: launches {made}, "
                  "or words or bf16 new cache differ from its plain version")
        print(f"[kernels] quant_pipeline bf16 msg and cache, n={n}, the same "
              f"(L, vmin, vmax): one launch each, {TOL} (new cache in bf16)")


def check_quantize_ef(rng, err: dict) -> None:
    """quantize_ef against its plain version, and against the unpack of
    quant_pipeline's words on the same inputs; then (check_quantize_ef_widths)
    at every dtype pair, with no cache, on views and past 2**31 values."""
    from repro_torch.core.compression import wire_index_bits
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    from repro_torch.kernels.pack_bits import unpack_bits
    from repro_torch.kernels.quantize_ef import quantize_ef
    for n in (UPDATE_N, 70_001, BIG_N):
        for levels, vmin, vmax in EF_CONFIGS:
            msg, cache = quant_inputs(n, levels, vmin, vmax, rng)
            kw = dict(levels=levels, vmin=vmin, vmax=vmax)
            wire, newc = quantize_ef(msg, cache, **kw)
            wire_p, newc_p = ref.quantize_ef_ref(msg, cache, **kw)
            check(same_wire(wire, wire_p) and same_bits(newc, newc_p),
                  f"quantize_ef n={n} L={levels} ±{vmax} differs from its "
                  "plain version")
            err["quantize_ef"] = max(err["quantize_ef"], int_err(wire, wire_p),
                                     float((newc - newc_p).abs().max()))
            words, newc_q = quant_pipeline(msg, cache, **kw)
            idx = unpack_bits(words, wire_index_bits(levels), n)
            check(torch.equal(ref.as_int64(idx), ref.as_int64(wire))
                  and same_bits(newc_q, newc),
                  f"quantize_ef n={n} L={levels} ±{vmax} is not the unpack "
                  "of quant_pipeline")
        print(f"[kernels] quantize_ef n={n} (L, vmin, vmax) in {EF_CONFIGS}: "
              f"{TOL}; wire == unpack_bits(quant_pipeline) and caches equal")
    check_quantize_ef_widths(rng, err)


#: quantize_ef's element types (msg and cache each)
EF_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: a bf16 leaf past the C int range: gemma3-27b's tied table with two
#: agents is 2.82e9 values; check_huge_leaf holds ~22 GB at its peak (msg,
#: cache, wire, two new caches and quant_pipeline's words)
EF_HUGE_N = 2**31 + 4097


def ef_pair_inputs(n: int, levels: int, m_dtype, c_dtype, rng):
    """quant_inputs' values (half-level boundaries, their neighbours, out
    of range, signed zeros) as a msg of ``m_dtype`` and the rest in a cache
    of ``c_dtype``: exact where the cache holds it, so msg + cache is the
    boundary itself in float32."""
    msg, cache = quant_inputs(n, levels, -1.0, 1.0, rng)
    m = msg.to(m_dtype)
    return m, (msg - m.to(torch.float32) + cache).to(c_dtype)


def same_bits_big(a: torch.Tensor, b: torch.Tensor, piece: int = 2**28) -> bool:
    """same_bits a piece at a time (a temporary of ``piece`` bools, not of
    the whole leaf)."""
    a, b = a.reshape(-1), b.reshape(-1)
    return a.numel() == b.numel() and all(same_bits(a[s:s + piece], b[s:s + piece])
                                          for s in range(0, a.numel(), piece))


def check_quantize_ef_widths(rng, err: dict) -> None:
    """quantize_ef (redesigned: 16-byte vectors of msg, any float type of
    msg and cache, a no-cache form, 64-bit n) against its plain version on
    the card, bit for bit, one launch each: every (msg, cache) dtype pair
    at L 255 and 1023 (ties exact where the cache holds the rest), the
    no-cache form of each msg dtype (also against quantize_encode of msg
    in float32), msg and cache views one element off their vectors (the
    value-by-value loop) at odd tails, and a bf16 leaf of EF_HUGE_N values
    with and without a cache; and pack_bits of that leaf's uint8 wire
    against its plain version a piece of tiles at a time."""
    from repro_torch.core.compression import quantize_encode
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize_ef import quantize_ef

    def held(what, msg, cache, **kw):
        (wire, newc), made = launched(lambda: quantize_ef(msg, cache, **kw))
        wire_p, newc_p = ref.quantize_ef_ref(msg, cache, **kw)
        check(made == {"quantize_ef": 1} and same_wire(wire, wire_p)
              and (newc is None if cache is None else
                   newc.dtype == msg.dtype and same_bits(newc, newc_p)),
              f"quantize_ef {what}: launches {made}, or the wire or new cache differs "
              "from its plain version")
        err["quantize_ef"] = max(err["quantize_ef"], int_err(wire, wire_p))
        return wire

    for n in (70_001, BIG_N + 5):
        for levels in (255, 1023):
            kw = dict(levels=levels, vmin=-1.0, vmax=1.0)
            for m_dtype in EF_DTYPES:
                for c_dtype in EF_DTYPES:
                    msg, cache = ef_pair_inputs(n, levels, m_dtype, c_dtype, rng)
                    what = f"{m_dtype} msg, {c_dtype} cache, n={n} L={levels}"
                    held(what, msg, cache, **kw)
                    # views one element off their vectors, n - 3 values
                    buf_m, buf_c = torch.cat([msg[:1], msg]), torch.cat([cache[:1], cache])
                    held(what + ", one element off", buf_m[1:n - 2], buf_c[1:n - 2], **kw)
                    del cache, buf_m, buf_c
                wire = held(f"{m_dtype} msg, no cache, n={n} L={levels}", msg, None, **kw)
                check(same_wire(wire, quantize_encode(msg.to(torch.float32), **kw)),
                      f"quantize_ef {m_dtype} msg, no cache: not quantize_encode")
                del msg, wire
        print(f"[kernels] quantize_ef redesigned, n={n}, L in (255, 1023): every (msg, "
              f"cache) pair of {[str(d)[6:] for d in EF_DTYPES]}, the no-cache form "
              f"(== quantize_encode of msg in float32), views one element off at odd "
              f"tails: one launch each, {TOL}")
    check_huge_leaf(err)


def check_huge_leaf(err: dict) -> None:
    """The wire kernels that take 64-bit n on a bf16 leaf of EF_HUGE_N
    values (past the C int range), one launch each, a piece at a time:
    quantize_ef with a bf16 cache and with none against its plain version,
    bit for bit; quant_pipeline on the same msg and cache, its new cache
    bit for bit quantize_ef's; pack_bits of quantize_ef's uint8 wire
    against its plain version and quant_pipeline's words, word for word;
    and unpack_bits of those words, equal to the uint8 wire widened."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    from repro_torch.kernels.pack_bits import _TILE_VALS, n_tiles, pack_bits, unpack_bits
    from repro_torch.kernels.quantize_ef import quantize_ef
    free_card()
    gen = torch.Generator(device=DEV).manual_seed(29)
    msg = torch.empty(EF_HUGE_N, dtype=torch.bfloat16, device=DEV)
    cache = torch.empty_like(msg)
    piece = 2**28
    for s in range(0, EF_HUGE_N, piece):   # drawn in pieces: no 8 GB float32 draw
        part = torch.randn(min(piece, EF_HUGE_N - s), generator=gen, device=DEV)
        msg[s:s + part.numel()] = 0.6 * part
        cache[s:s + part.numel()] = 0.004 * part.flip(0)
        del part
    kw = dict(levels=255, vmin=-1.0, vmax=1.0)
    (wire, newc), made = launched(lambda: quantize_ef(msg, cache, **kw))
    (wire0, none), made0 = launched(lambda: quantize_ef(msg, None, **kw))
    check(made == made0 == {"quantize_ef": 1} and none is None,
          f"quantize_ef on {EF_HUGE_N} values launched {made} and {made0}")
    for s in range(0, EF_HUGE_N, piece):
        w_p, nc_p = ref.quantize_ef_ref(msg[s:s + piece], cache[s:s + piece], **kw)
        w0_p, _ = ref.quantize_ef_ref(msg[s:s + piece], None, **kw)
        check(same_wire(wire[s:s + piece], w_p) and same_bits(newc[s:s + piece], nc_p)
              and same_wire(wire0[s:s + piece], w0_p),
              f"quantize_ef on {EF_HUGE_N} bf16 values, from value {s}: the wire, the "
              "new cache or the no-cache wire differs from its plain version")
        del w_p, nc_p, w0_p
    del wire0
    (words_q, newc_q), made = launched(lambda: quant_pipeline(msg, cache, **kw))
    check(made == {"quant_pipeline": 1} and words_q.numel() == n_tiles(EF_HUGE_N) * 8 * 1024,
          f"quant_pipeline on {EF_HUGE_N} values launched {made}")
    check(same_bits_big(newc_q, newc), f"quant_pipeline on {EF_HUGE_N} bf16 values: its "
          "new cache differs from quantize_ef's")
    del msg, cache, newc, newc_q
    words, made = launched(lambda: pack_bits(wire, 8))
    check(made == {"pack_bits": 1}, f"pack_bits on {EF_HUGE_N} values launched {made}")
    piece = 2048 * _TILE_VALS
    for s in range(0, EF_HUGE_N, piece):
        w_ref = ref.pack_bits_ref(wire[s:s + piece], 8)
        check(same_bits(words[s // 4:s // 4 + w_ref.numel()], w_ref),
              f"pack_bits on {EF_HUGE_N} uint8 values, from value {s}: differs from its "
              "plain version")
        del w_ref
    check(same_bits_big(words_q, words), f"quant_pipeline on {EF_HUGE_N} bf16 values: its "
          "words differ from pack_bits of quantize_ef's wire")
    del words_q
    vals, made = launched(lambda: unpack_bits(words, 8, EF_HUGE_N))
    check(made == {"unpack_bits": 1}, f"unpack_bits of {EF_HUGE_N} values launched {made}")
    check(vals.numel() == EF_HUGE_N and same_ints(vals, wire),
          f"unpack_bits of {EF_HUGE_N} values differs from the uint8 wire they packed")
    print(f"[kernels] quantize_ef on {EF_HUGE_N} bf16 values (past 2**31), with a bf16 "
          f"cache and with none, L=255: one launch each, {TOL}; pack_bits of its uint8 "
          f"wire at b=8: one launch, words equal the plain version's word for word; "
          f"quant_pipeline on the same msg and cache: one launch, words equal pack_bits' "
          f"word for word, new cache quantize_ef's bit for bit; unpack_bits of the "
          f"words at n={EF_HUGE_N}: one launch, values equal the uint8 wire")
    del wire, words, vals
    free_card()


def check_erasure_mask(rng, err: dict) -> None:
    """erasure_mask against its plain version over p, seeds and segments."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.erasure_mask import erasure_mask
    for n in (WORDS_N, 70_001, BIG_N):
        words = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64)
                                 .astype(np.uint32)).to(DEV)
        for p in ERASE_PS:
            for seed in ERASE_SEEDS:
                for seg in ERASE_SEGMENTS:
                    kw = dict(p=p, seed=seed, segment_words=seg)
                    masked, keep = erasure_mask(words, **kw)
                    masked_p, keep_p = ref.erasure_mask_ref(words, **kw)
                    check(same_bits(masked, masked_p) and same_bits(keep, keep_p),
                          f"erasure_mask n={n} {kw} differs from its plain "
                          "version")
                    err["erasure_mask"] = max(err["erasure_mask"],
                                              int_err(masked, masked_p),
                                              int_err(keep, keep_p))
        print(f"[kernels] erasure_mask n={n} p in {ERASE_PS}, seeds "
              f"{ERASE_SEEDS}, segment_words in {ERASE_SEGMENTS}: exact, "
              "masked words and keep masks word for word")
    two_d = torch.from_numpy(rng.integers(0, 2**32, (7, WORDS_N), dtype=np.uint64)
                             .astype(np.uint32)).to(DEV)
    masked, keep = erasure_mask(two_d, p=0.25, seed=7)
    check(masked.shape == keep.shape == two_d.shape
          and same_bits(masked, ref.erasure_mask_ref(two_d, p=0.25, seed=7)[0]),
          "erasure_mask does not keep a 2-D shape")


def sign_inputs(n: int, rng):
    """msg/cache with exact zeros, -0.0 and values that cancel to 0 at the
    front (cache +-0 there, so msg + cache keeps them)."""
    msg = rng.standard_normal(n).astype(np.float32)
    cache = (0.1 * rng.standard_normal(n)).astype(np.float32)
    special_m = np.array([0.0, -0.0, 0.0, -0.0, 1.5, -1.5], np.float32)
    special_c = np.array([0.0, 0.0, -0.0, -0.0, -1.5, 1.5], np.float32)
    k = min(n, special_m.size)
    msg[:k], cache[:k] = special_m[:k], special_c[:k]
    return torch.from_numpy(msg).to(DEV), torch.from_numpy(cache).to(DEV)


def sign_model_scale(msg, cache) -> np.float32:
    """The scale csrc/sign_pipeline.cu computes, in numpy and in its order:
    |msg + cache| summed in float64 per chunk of 32 quads (a lane: its rows
    then its four columns; a warp: an xor butterfly), then every chunk's
    partial (thread t: partials t, t + 256, ...; the butterfly; warps 0..7
    in turn), and float32(total / n)."""
    from repro_torch.kernels.compress_pipeline import (
        SIGN_CHUNK_QUADS, SIGN_CHUNKS_PER_TILE, SIGN_COLS, SIGN_THREADS)
    from repro_torch.kernels.pack_bits import GROUP, LANES, R, n_tiles
    m, c = (t.detach().float().reshape(-1).cpu().numpy() for t in (msg, cache))
    n = m.size
    a = np.zeros(n_tiles(n) * GROUP * R * LANES)
    a[:n] = np.abs(np.add(m, c, dtype=np.float32))
    # (tile, row, chunk of the tile, lane, column of the quad) -> (chunk, lane, row·column)
    v = a.reshape(-1, GROUP, SIGN_CHUNKS_PER_TILE, SIGN_CHUNK_QUADS, SIGN_COLS)
    v = v.transpose(0, 2, 3, 1, 4).reshape(-1, SIGN_CHUNK_QUADS, GROUP * SIGN_COLS)
    acc = np.zeros(v.shape[:2])
    for j in range(v.shape[2]):
        acc = acc + v[:, :, j]

    def butterfly(x):                   # over 32 lanes: lane 0's sum
        lane = np.arange(32)
        for off in (16, 8, 4, 2, 1):
            x = x + x[..., lane ^ off]
        return x[..., 0]

    partials = butterfly(acc)
    t = np.zeros(SIGN_THREADS)
    for k in range(0, partials.size, SIGN_THREADS):
        part = partials[k:k + SIGN_THREADS]
        t[:part.size] = t[:part.size] + part
    total = 0.0
    for w in butterfly(t.reshape(-1, 32)):
        total = total + w
    return np.float32(total / np.float64(n))


def check_sign_pair(msg, cache, what: str) -> float:
    """sign_pipeline against its plain version: words equal, scale within
    rtol 1e-6, new cache within atol 1e-6 (bf16: within one rounding,
    2**-7 |plain| + 1e-6, since the two scales may round a value to
    neighbouring bf16s); the scale bit for bit the kernel's fixed-order sum
    (sign_model_scale) and the new cache bit for bit msg + cache ∓ that
    scale in msg's dtype; returns the largest difference from the plain
    version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import sign_pipeline
    words, scale, newc = sign_pipeline(msg, cache)
    words2, scale2, newc2 = sign_pipeline(msg, cache)
    words_p, scale_p, newc_p = ref.sign_pipeline_ref(msg, cache)
    check(same_bits(words2, words) and same_bits(scale2, scale) and same_bits(newc2, newc),
          f"sign_pipeline {what}: a second call differs from the first")
    s, s_p = float(scale), float(scale_p)
    diff = (newc.float() - newc_p.float()).abs()
    cache_err = float(diff.max())
    check(same_bits(words, words_p), f"sign_pipeline {what}: words differ from "
          "its plain version")
    check(abs(s - s_p) <= 1e-6 * abs(s_p), f"sign_pipeline {what}: scale {s} vs "
          f"{s_p}")
    rtol = 0.0 if msg.dtype == torch.float32 else 2**-7
    check(bool((diff <= 1e-6 + rtol * newc_p.float().abs()).all()),
          f"sign_pipeline {what}: new cache off by {cache_err}")
    s_model = sign_model_scale(msg, cache)
    check(np.float32(s).tobytes() == s_model.tobytes(), f"sign_pipeline {what}: "
          f"scale {s!r} is not the fixed-order sum's {float(s_model)!r} bit for bit")
    cor = msg.float() + cache.float()
    check(same_bits(newc, (cor - torch.where(cor >= 0, 1.0, -1.0) * scale).to(msg.dtype)),
          f"sign_pipeline {what}: new cache is not msg + cache ∓ scale bit for bit")
    return max(int_err(words, words_p), abs(s - s_p), cache_err)


def check_sign_pipeline(rng, err: dict) -> None:
    for n in SIGN_SIZES:
        msg, cache = sign_inputs(n, rng)
        err["sign_pipeline"] = max(err["sign_pipeline"],
                                   check_sign_pair(msg, cache, f"n={n}"))
        print(f"[kernels] sign_pipeline n={n} (with 0, -0.0 and cancelling "
              "values): words == plain version word for word, scale within "
              "rtol 1e-6, new cache within atol 1e-6; scale == the fixed-order "
              "sum's bits, new cache == msg + cache ∓ scale bit for bit; two calls "
              "bit for bit equal")
    msg, cache = sign_inputs(SIGN_OFFSET_N, rng)
    views = []
    for t in (msg, cache):
        buf = torch.empty(t.numel() + 1, device=DEV)
        buf[1:] = t
        views.append(buf[1:])
    check(views[0].data_ptr() % 16 == 4, "sign_pipeline: the offset view is aligned")
    err["sign_pipeline"] = max(err["sign_pipeline"], check_sign_pair(
        *views, f"n={SIGN_OFFSET_N} on views 4 bytes off 16"))
    print(f"[kernels] sign_pipeline n={SIGN_OFFSET_N} on msg and cache views 4 bytes "
          "off 16-byte alignment (4-byte loads): == plain version, as above")
    for n in SIGN_BF16_SIZES + (SIGN_OFFSET_N,):
        msg, cache = (t.to(torch.bfloat16) for t in sign_inputs(n, rng))
        what = f"bf16 n={n}"
        if n == SIGN_OFFSET_N:               # views 2 bytes off 8: value by value
            views = []
            for t in (msg, cache):
                buf = torch.empty(t.numel() + 1, dtype=torch.bfloat16, device=DEV)
                buf[1:] = t
                views.append(buf[1:])
            check(views[0].data_ptr() % 8 == 2, "sign_pipeline: the bf16 view is aligned")
            msg, cache = views
            what += " on views 2 bytes off 8"
        err["sign_pipeline"] = max(err["sign_pipeline"], check_sign_pair(msg, cache, what))
        print(f"[kernels] sign_pipeline {what}: words == plain version word for word, "
              "scale within rtol 1e-6 and the fixed-order sum's bits, the bf16 new "
              "cache within one rounding of the plain version's and bit for bit "
              "bf16(msg + cache ∓ scale); two calls bit for bit equal")


def flash_case(s: int, d: int, h: int, hkv: int, offset: bool, dtype, gen):
    """q, k, v and positions: aligned (q_pos = k_pos = arange(S)), or the
    last third of the keys as queries with both ranges shifted by 100."""
    b = 1 if s > 1000 else 2
    sq = (s + 2) // 3 if offset else s
    q = torch.randn((b, sq, h, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(dtype)
    k_pos = torch.arange(s, dtype=torch.int32, device=DEV) + (100 if offset else 0)
    return q, k, v, k_pos[s - sq:], k_pos


def flash_check(out, plain, what: str) -> float:
    """Fail unless ``out`` is within FLASH_TOL of ``plain``; max_abs_err."""
    rtol, atol = FLASH_TOL[plain.dtype]
    out, plain = out.float(), plain.float()
    e = float((out - plain).abs().max())
    check(torch.allclose(out, plain, rtol=rtol, atol=atol),
          f"flash_attention {what}: max_abs_err {e}, over atol {atol} + rtol "
          f"{rtol} |plain|")
    return e


def flash_route_call(fa, q, k, v, qp, kp, **kw):
    """flash_attention(...) with the launch it made: (out, kernel name)."""
    out, made = launched(lambda: fa.flash_attention(q, k, v, qp, kp, **kw))
    check(len(made) == 1 and list(made.values()) == [1],
          f"flash_attention {q.dtype} made launches {made}, expected one")
    return out, next(iter(made), None)


def check_flash_attention(err: dict) -> None:
    """flash_attention against its plain version over every case, each on
    the route its dtype takes (float32: flash_attention.cu; bf16:
    flash_attention_sm90.cu), read from the launch counts; one line per
    (dtype, S, D, H/Hkv) with the max_abs_err of each of its cases."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=DEV).manual_seed(1)
    worst = {}
    for dtype, tol in FLASH_TOL.items():
        want = fa.route(dtype, DEV)
        for s in FLASH_S:
            for d in FLASH_D:
                for h, hkv in FLASH_HEADS:
                    errs = []
                    for window in FLASH_WINDOWS:
                        for cap in FLASH_CAPS:
                            for offset in (False, True):
                                q, k, v, qp, kp = flash_case(s, d, h, hkv, offset,
                                                             dtype, gen)
                                kw = dict(causal=True, window=window, softcap=cap)
                                out, took = flash_route_call(fa, q, k, v, qp, kp, **kw)
                                what = (f"{dtype} S={s} D={d} H={h}/{hkv} window={window} "
                                        f"softcap={cap} offset={offset}")
                                check(took == want, f"flash_attention {what} ran {took}, "
                                      f"expected {want}")
                                plain = ref.flash_attention_ref(q, k, v, qp, kp,
                                                                **kw)
                                errs.append(flash_check(out, plain, what))
                    worst[want] = max(worst.get(want, 0.0), *errs)
                    print(f"[kernels] {want} ({str(dtype)[6:]}) S={s} D={d} "
                          f"H={h}/{hkv}: max_abs_err per (window, softcap, "
                          f"offset) in {FLASH_WINDOWS}x{FLASH_CAPS}x(no, yes): "
                          + " ".join(f"{e:.1e}" for e in errs)
                          + f" (within {tol[1]} + {tol[0]:.4g} |plain|)")
    for dtype in FLASH_TOL:
        name = fa.route(dtype, DEV)
        worst[name] = max(worst[name], *check_flash_layouts(fa, ref, gen, dtype))
    for name, e in check_flash_no_key(fa, ref, gen).items():
        worst[name] = max(worst[name], e)
    for name, e in check_flash_train_shape(fa, ref).items():
        worst[name] = max(worst[name], e)
    err.update(worst)
    print(f"[kernels] flash_attention: within tolerance of its plain version in "
          f"all cases; max_abs_err float32 (flash_attention) "
          f"{worst['flash_attention']:.3e}, bf16 (flash_attention_sm90) "
          f"{worst['flash_attention_sm90']:.3e}")


def check_flash_train_shape(fa, ref) -> dict:
    """Both routes at the training path's shape (TRAIN_ATTN: B=2, S=2048,
    H=Hkv=32, D=64, causal; bf16 in 17a-17b, float32 in 17c) against the
    plain version.  {route: max_abs_err}."""
    t, errs = TRAIN_ATTN, {}
    for dtype in FLASH_TOL:
        q, k, v, pos = attention_inputs(t["b"], t["s"], t["h"], t["hkv"], t["d"], dtype, 8)
        out, took = flash_route_call(fa, q, k, v, pos, pos, causal=True)
        check(took == fa.route(dtype, DEV), f"training shape {dtype} ran {took}")
        errs[took] = flash_check(out, ref.flash_attention_ref(q, k, v, pos, pos, causal=True),
                                 f"{dtype} at the training shape {t}")
        print(f"[kernels] {took} ({str(dtype)[6:]}) at the training shape B={t['b']} "
              f"S={t['s']} H={t['h']}/{t['hkv']} D={t['d']} causal: max_abs_err "
              f"{errs[took]:.1e} (within {FLASH_TOL[dtype][1]} + "
              f"{FLASH_TOL[dtype][0]:.4g} |plain|)")
    return errs


def check_flash_no_key(fa, ref, gen) -> dict:
    """Keys at positions 192.., queries at 0..384, on both routes: rows
    0..191 see no key, so query tile 0 visits no key tile and the next
    one masks some of its rows whole.  Such rows take the sentinel's
    answer, the mean of V.  {route: max_abs_err}."""
    errs = {}
    ahead = torch.arange(192, 192 + 385, dtype=torch.int32, device=DEV)
    for dtype in FLASH_TOL:
        q, k, v, qp, _ = flash_case(385, 120, 32, 8, False, dtype, gen)
        for window in (None, 64):
            kw = dict(causal=True, window=window, softcap=None)
            out, took = flash_route_call(fa, q, k, v, qp, ahead, **kw)
            check(took == fa.route(dtype, DEV), f"keys-ahead case {dtype} ran {took}")
            e = flash_check(out, ref.flash_attention_ref(q, k, v, qp, ahead, **kw),
                            f"{dtype} keys ahead of the queries window={window}")
            errs[took] = max(errs.get(took, 0.0), e)
    print(f"[kernels] flash_attention, keys ahead of the queries (S=385, rows "
          f"0..191 see no key; window None/64), on both routes: max_abs_err "
          + " ".join(f"{n} {e:.1e}" for n, e in errs.items()))
    return errs


def check_flash_layouts(fa, ref, gen, dtype) -> list:
    """Cases beyond the grid on ``dtype``'s route: a ring cache's positions
    (k_pos a rotated arange with empty slots at 2**30, as cache.pos holds
    them), a q view with a sliced start, a q view whose base is off 16
    bytes (bf16: TMA cannot read it, so the wrapper copies it first;
    float32: the kernel reads it with 4-byte copies), odd head dims and
    lengths; in float32 also 140,000 keys, past the 2048 key tiles the
    kernel plans at a time.  Returns the max_abs_err of each case."""
    want, errs = fa.route(dtype, DEV), []
    h, hkv, d, s_max = 32, 8, 120, RING_SLOTS
    end = s_max + 904
    pos = torch.arange(end - s_max, end, device=DEV)
    ring = torch.empty(s_max, dtype=torch.int64, device=DEV)
    ring[pos % s_max] = pos
    ring[torch.randperm(s_max, generator=gen, device=DEV)[:7]] = 2**30
    ring = ring.int()
    q = torch.randn((2, 257, h, d), generator=gen, device=DEV).to(dtype)
    k, v = (torch.randn((2, s_max, hkv, d), generator=gen, device=DEV).to(dtype)
            for _ in range(2))
    qp = torch.arange(end - 257, end, dtype=torch.int32, device=DEV)
    for window in (None, 4096):
        kw = dict(causal=True, window=window, softcap=None)
        out, took = flash_route_call(fa, q, k, v, qp, ring, **kw)
        check(took == want, f"ring case ran {took}")
        errs.append(flash_check(out, ref.flash_attention_ref(q, k, v, qp, ring, **kw),
                                f"{dtype} ring positions window={window}"))
    s = FLASH_S[-1]
    q = torch.randn((1, s, h, d), generator=gen, device=DEV).to(dtype)
    k, v = (torch.randn((1, s, hkv, d), generator=gen, device=DEV).to(dtype)
            for _ in range(2))
    flat = torch.empty(1 + q.numel(), dtype=dtype, device=DEV)
    odd = flat[1:].view(q.shape)
    odd.copy_(q)
    kp = torch.arange(s, dtype=torch.int32, device=DEV)
    in_place = []
    for what, qv in (("sliced start q[:, s//3:]", q[:, s // 3:]),
                     ("base off 16 bytes", odd[:, s // 3:])):
        in_place.append(fa.tma_layout(qv)[0].data_ptr() == qv.data_ptr()
                        if dtype == torch.bfloat16 else fa.vec_ready(qv))
        kw = dict(causal=True, window=4096, softcap=None)
        out, took = flash_route_call(fa, qv, k, v, kp[s // 3:], kp, **kw)
        check(took == want, f"{what} ran {took}")
        errs.append(flash_check(out, ref.flash_attention_ref(qv, k, v, kp[s // 3:], kp,
                                                              **kw), f"{dtype} {what}"))
    check(in_place == [True, False], f"{dtype}: sliced and misaligned q read in place "
          f"(bf16: by TMA; float32: in 16-byte copies): {in_place}, expected the "
          "sliced view only")
    # head dims off the grid (bf16: D = 100 is zero-padded to 104 by a copy;
    # D < 64 takes one 64-column TMA box past D; float32: D = 33 and 17 take
    # 4-byte copies), one key tile short of full, a one-token prompt, and
    # no causal mask (with and without a window)
    cases = [(300, 100, 4, 2, 50, None, True), (300, 32, 4, 2, 50, None, True),
             (200, 16, 4, 4, None, 30.0, True), (70, 64, 2, 1, None, None, True),
             (1, 64, 2, 1, None, None, True), (300, 64, 4, 2, None, None, False),
             (300, 120, 4, 2, 100, None, False)]
    if dtype == torch.float32:
        cases += [(300, 33, 4, 2, 50, None, True), (200, 17, 4, 4, None, 30.0, True)]
    for n, d, h, hkv, window, cap, causal in cases:
        q, k, v, qp, kp = flash_case(n, d, h, hkv, False, dtype, gen)
        kw = dict(causal=causal, window=window, softcap=cap)
        out, took = flash_route_call(fa, q, k, v, qp, kp, **kw)
        check(took == want, f"S={n} D={d} ran {took}")
        errs.append(flash_check(out, ref.flash_attention_ref(q, k, v, qp, kp, **kw),
                                f"{dtype} S={n} D={d} H={h}/{hkv} window={window} "
                                f"softcap={cap} causal={causal}"))
    long_k = []
    if dtype == torch.float32:
        n = 140_000                     # 2188 key tiles of 64: two plan windows
        k, v = (torch.randn((1, n, 1, 64), generator=gen, device=DEV) for _ in range(2))
        q = torch.randn((1, 256, 2, 64), generator=gen, device=DEV)
        kp = torch.arange(n, dtype=torch.int32, device=DEV)
        for window in (None, 4096):
            kw = dict(causal=True, window=window, softcap=None)
            out, took = flash_route_call(fa, q, k, v, kp[-256:], kp, **kw)
            check(took == want, f"{n} keys ran {took}")
            long_k.append(flash_check(out, ref.flash_attention_ref(q, k, v, kp[-256:], kp,
                                                                   **kw),
                                      f"{n} keys window={window}"))
        errs += long_k
    print(f"[kernels] {want} {str(dtype)[6:]}: ring positions ({s_max} slots, 7 "
          f"empty at 2**30, window None/4096), S={s}: q[:, s//3:] read in place, a q "
          "view one element off 16 bytes " + ("copied first" if dtype == torch.bfloat16 else
                                    "read in 4-byte copies")
          + "; (S, D) in " + ", ".join(f"({c[0]}, {c[1]})" for c in cases)
          + " (the last two of the first seven not causal)"
          + ("; 140,000 keys, window None/4096" if long_k else "") + ": max_abs_err "
          + " ".join(f"{e:.1e}" for e in errs))
    return errs


FLASH_BWD_S = (128, 257, 2048)
FLASH_BWD_WINDOWS = (None, 64)
# flash_attention_bwd against its plain version: (rtol, atol) for |kernel -
# plain| <= atol + rtol |plain|, on unit-scale q, k, v and dout.  float32:
# both sum in float32 in other orders; bf16: both sum in float32 and round
# the gradient to bf16 once, so they differ by one rounding
FLASH_BWD_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2**-7, 1e-3)}
# the training path's attention: stablelm-1.6b at --batch 2 --seq 2048
TRAIN_ATTN = dict(b=2, s=2048, h=32, hkv=32, d=64)


def flash_bwd_check(got, plain, what: str) -> float:
    """Fail unless each of (dq, dk, dv) is within FLASH_BWD_TOL of the
    plain version's; the largest max_abs_err of the three."""
    rtol, atol = FLASH_BWD_TOL[plain[0].dtype]
    errs = []
    for name, g, p in zip(("dq", "dk", "dv"), got, plain):
        g, p = g.float(), p.float()
        e = float((g - p).abs().max())
        check(bool(torch.isfinite(g).all()) and torch.allclose(g, p, rtol=rtol, atol=atol),
              f"flash_attention_bwd {what}: {name} max_abs_err {e}, over atol {atol} "
              f"+ rtol {rtol} |plain|")
        errs.append(e)
    return max(errs)


def check_flash_stats(fa, ref, gen, dtype) -> float:
    """The saved statistics of ``dtype``'s forward route against the plain
    version's: the log-sum-exp (log2 units) within 1e-4 where a row sees a
    key and +inf exactly where it sees none (and past Sq), O in float32
    within 1e-4 (on the float32 route O is the output itself), and the
    output bit for bit the forward's without them."""
    name = fa.route(dtype, DEV)
    worst = 0.0
    for s, d, h, hkv, k_off in ((128, 64, 4, 4, 0), (257, 120, 32, 8, 0),
                                (385, 128, 4, 2, 192)):
        q, k, v, qp, kp = flash_case(s, d, h, hkv, False, dtype, gen)
        kp = kp + k_off
        for window, cap in ((None, None), (64, 30.0)):
            (out, lse_pad, o32), made = launched(lambda: fa._forward(
                q, k, v, qp, kp, True, window, cap, stats=True))
            check(made == {name: 1}, f"{name}: forward with statistics launched {made}")
            check(dtype != torch.float32 or o32 is out, f"{name}: O is not the output")
            _, lse_p, o_p = ref.flash_attention_ref(q, k, v, qp, kp, window=window,
                                                    softcap=cap, stats=True)
            lse, past = lse_pad[..., :s], lse_pad[..., s:]
            inf = torch.isinf(lse_p)
            e = max(float((lse - lse_p)[~inf].abs().max()) if bool((~inf).any()) else 0.0,
                    float((o32 - o_p).abs().max()))
            check(lse_pad.shape[-1] == -(-s // fa.BLOCK_Q) * fa.BLOCK_Q
                  and bool(torch.isposinf(past).all())
                  and torch.equal(torch.isinf(lse), inf) and bool((lse[inf] > 0).all())
                  and e <= 1e-4 and same_bits(out, fa._forward(q, k, v, qp, kp, True,
                                                                window, cap)),
                  f"{name} forward statistics S={s} D={d} window={window} softcap={cap}: "
                  f"max_abs_err {e}, or +inf rows (also the padding past Sq) or the "
                  "output differ")
            worst = max(worst, e)
    print(f"[kernels] {name}'s statistics for the backward (LSE in log2 units, +inf "
          f"for rows that see no key and the padding past Sq; O in float32"
          + (", the output itself" if dtype == torch.float32 else "") + ") against "
          f"the plain version's: max_abs_err {worst:.2e} (within 1e-4); output bit for "
          "bit the forward's without them")
    return worst


def check_f32_bwd_split(fa, ref, gen) -> float:
    """The float32 backward where a group's dK/dV chain is split over
    several blocks and their partials summed (f32_bwd_head_slices): 48
    query heads on one KV head at S = 2048, D = 64 (the DP = 64 build;
    phase 21 holds granite-20b's D = 128), causal, with aligned keys and
    with keys 192 ahead of the queries (rows 0..191 see no key: each
    slice adds its own such rows to dV, once); and a ragged case, 16/2
    heads (8 over 2 slices), Sq = 2100 queries on the last of Sk = 2300
    keys, D = 33 (4-byte loads), window 64 and softcap 30.  Each call one
    forward and one backward launch, within FLASH_BWD_TOL, two calls bit
    for bit; the largest max_abs_err."""
    dtype, s, d, h, hkv = torch.float32, 2048, 64, 48, 1
    name = fa.bwd_route(dtype, DEV)
    q, k, v, qp, kp = flash_case(s, d, h, hkv, False, dtype, gen)
    do = torch.randn(q.shape, generator=gen, device=DEV)
    cases = [(f"S={s} D={d} H={h}/{hkv} causal, aligned", (q, k, v, do, qp, kp), {}),
             (f"S={s} D={d} H={h}/{hkv} causal, keys 192 ahead",
              (q, k, v, do, qp, kp + 192), {})]
    sq, sk, d, h, hkv = 2100, 2300, 33, 16, 2
    q, do = (torch.randn((1, sq, h, d), generator=gen, device=DEV) for _ in range(2))
    k, v = (torch.randn((1, sk, hkv, d), generator=gen, device=DEV) for _ in range(2))
    kp = torch.arange(sk, dtype=torch.int32, device=DEV)
    cases.append((f"Sq={sq} Sk={sk} D={d} H={h}/{hkv} causal, window 64, softcap 30",
                  (q, k, v, do, kp[sk - sq:], kp), dict(window=64, softcap=30.0)))
    errs = []
    for what, args, kw in cases:
        q, k = args[0], args[1]
        slices = fa.f32_bwd_head_slices(q.shape[2] // k.shape[2], q.shape[1])
        what = f"float32 {what}, {len(slices)} slices {slices}"
        check(len(slices) > 1, f"{name} {what}: not split")
        got, made = launched(lambda: fa.flash_attention_bwd(*args, causal=True, **kw))
        check(made == {name: 1, fa.route(dtype, DEV): 1}, f"{name} {what} launched {made}")
        again = fa.flash_attention_bwd(*args, causal=True, **kw)
        check(all(same_bits(a, b) for a, b in zip(got, again)),
              f"{name} {what}: two calls differ")
        errs.append(flash_bwd_check(got, ref.flash_attention_bwd_ref(*args, causal=True,
                                                                     **kw), what))
        if "ahead" in what:
            check(float(got[0][:, :192].abs().max()) == 0.0,
                  f"{name} {what}: rows that see no key have a nonzero dq")
        print(f"[kernels] {name} {what}: the dK/dV chain summed by the fourth grid; "
              f"max_abs_err of dq, dk, dv {errs[-1]:.3e} (within "
              f"{FLASH_BWD_TOL[dtype][1]}); two calls equal bit for bit")
        del got, again
    return max(errs)


def check_flash_bwd(err: dict) -> None:
    """The backward against its plain version over the forward grid's
    cases at S in FLASH_BWD_S, window in FLASH_BWD_WINDOWS, offset
    positions and keys ahead of the queries (rows that see no key), in
    float32 (flash_attention_bwd.cu, after one flash_attention launch for
    the statistics) and bf16 (flash_attention_bwd_sm90.cu, after one
    flash_attention_sm90 launch): each call's launches read from the
    counts, and a second call equal bit for bit.  Then through
    FlashAttention: a forward on its route and a backward on the dtype's
    kernel, from the launch counts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=DEV).manual_seed(5)
    for dtype in FLASH_BWD_TOL:
        name = fa.route(dtype, DEV)
        err[name] = max(err[name], check_flash_stats(fa, ref, gen, dtype))
    worst = {dtype: 0.0 for dtype in FLASH_BWD_TOL}
    for dtype, tol in FLASH_BWD_TOL.items():
        name = fa.bwd_route(dtype, DEV)
        want = {name: 1, fa.route(dtype, DEV): 1}
        for s in FLASH_BWD_S:
            for d in FLASH_D:
                for h, hkv in FLASH_HEADS:
                    errs = []
                    for window in FLASH_BWD_WINDOWS:
                        for cap in FLASH_CAPS:
                            for offset in (False, True):
                                q, k, v, qp, kp = flash_case(s, d, h, hkv, offset, dtype,
                                                             gen)
                                do = torch.randn(q.shape, generator=gen,
                                                 device=DEV).to(dtype)
                                kw = dict(causal=True, window=window, softcap=cap)
                                what = (f"{dtype} S={s} D={d} H={h}/{hkv} window={window} "
                                        f"softcap={cap} offset={offset}")
                                got, made = launched(lambda: fa.flash_attention_bwd(
                                    q, k, v, do, qp, kp, **kw))
                                check(made == want, f"{name} {what} launched {made}")
                                again = fa.flash_attention_bwd(q, k, v, do, qp, kp, **kw)
                                check(all(same_bits(a, b) for a, b in zip(got, again)),
                                      f"{name} {what}: two calls differ")
                                errs.append(flash_bwd_check(
                                    got, ref.flash_attention_bwd_ref(q, k, v, do, qp, kp,
                                                                     **kw), what))
                    worst[dtype] = max(worst[dtype], *errs)
                    print(f"[kernels] {name} ({str(dtype)[6:]}) S={s} D={d} "
                          f"H={h}/{hkv}: max_abs_err of dq, dk, dv per (window, softcap, "
                          f"offset) in {FLASH_BWD_WINDOWS}x{FLASH_CAPS}x(no, yes): "
                          + " ".join(f"{e:.1e}" for e in errs)
                          + f" (within {tol[1]} + {tol[0]:.4g} |plain|); two calls equal "
                          "bit for bit")
    worst[torch.float32] = max(worst[torch.float32], check_f32_bwd_split(fa, ref, gen))
    ahead = torch.arange(192, 192 + 385, dtype=torch.int32, device=DEV)
    for dtype in FLASH_BWD_TOL:
        q, k, v, qp, _ = flash_case(385, 120, 32, 8, False, dtype, gen)
        do = torch.randn(q.shape, generator=gen, device=DEV).to(dtype)
        for window in (None, 64):
            kw = dict(causal=True, window=window, softcap=30.0 if window else None)
            got = fa.flash_attention_bwd(q, k, v, do, qp, ahead, **kw)
            e = flash_bwd_check(got, ref.flash_attention_bwd_ref(q, k, v, do, qp, ahead,
                                                                 **kw),
                                f"{dtype} keys ahead of the queries window={window}")
            check(float(got[0][:, :192].float().abs().max()) == 0.0,
                  f"{dtype}: rows that see no key have a nonzero dq")
            worst[dtype] = max(worst[dtype], e)
        # through the autograd Function: forward on the dtype's route, backward here
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        (grads, made) = launched(lambda: torch.autograd.grad(
            fa.flash_attention(qg, kg, vg, qp, ahead, window=64), (qg, kg, vg), do))
        check(made == {fa.route(dtype, DEV): 1, fa.bwd_route(dtype, DEV): 1},
              f"FlashAttention {dtype}: forward and backward launched {made}")
        worst[dtype] = max(worst[dtype], flash_bwd_check(grads, ref.flash_attention_bwd_ref(
            q, k, v, do, qp, ahead, causal=True, window=64), f"{dtype} FlashAttention"))
    err["flash_attention_bwd"] = worst[torch.float32]
    err["flash_attention_bwd_sm90"] = worst[torch.bfloat16]
    print(f"[kernels] flash_attention_bwd (float32) and flash_attention_bwd_sm90 (bf16): "
          f"keys ahead of the queries (S=385, rows 0..191 see no key: dq 0 there, dv "
          f"gains their dO / Sk) and FlashAttention's backward (one forward launch on "
          f"the dtype's route, saving the statistics, and one backward launch) "
          f"within tolerance; max_abs_err over the grid {worst[torch.float32]:.3e} "
          f"(float32), {worst[torch.bfloat16]:.3e} (bf16)")


# -- phases 3 and 4: the main path -----------------------------------------

def phase_fedlt():
    from repro_torch.core.compression import UniformQuantizer
    from repro_torch.core.error_feedback import EFChannel
    from repro_torch.core.fedlt import FedLT, optimality_error
    from repro_torch.data.logistic import generate, make_local_loss, solve_global
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    n_agents, dim = PAPER["n_agents"], PAPER["dim"]
    data, _ = generate(0, **PAPER, device=DEV)
    loss = make_local_loss(eps=50.0, n_agents=n_agents)
    xbar = solve_global(data, eps=50.0)
    quant = UniformQuantizer(levels=10, vmin=-1.0, vmax=1.0, clip=True)
    alg = FedLT(loss=loss, n_epochs=10, gamma=0.005, rho=20.0,
                uplink=EFChannel(quant), downlink=EFChannel(quant),
                fused_uplink=True)
    state = alg.init(torch.zeros(dim, device=DEV), n_agents)
    torch.cuda.synchronize()
    print(f"[fedlt] set-up (data, x̄ by Newton) {time.perf_counter() - t0:.2f} s")

    e_k, chunk_ms = {}, {}
    wall = 0.0
    for chunk in ROUND_CHUNKS:
        before = state
        t0 = time.perf_counter()
        state, info = alg.run(state, data, chunk)
        e_k[state.k] = float(optimality_error(state.x, xbar))   # synchronizes
        dt = time.perf_counter() - t0
        wall += dt
        chunk_ms[state.k] = 1e3 * dt / chunk
        check(int(info["n_active"].min()) == n_agents, "participation 1.0 "
              "left an agent out")
    rounds = state.k
    for k, e in e_k.items():
        if k == 1 or k % 50 == 0:
            print(f"[fedlt] round {k:3d}  e_K = {e:.6e}   "
                  f"({chunk_ms[k]:.2f} ms per round in the rounds up to here)")
    print(f"[fedlt] {rounds} rounds in {wall:.2f} s ({1e3 * wall / rounds:.2f} ms "
          "per round; host clock around work ending in a synchronize)")
    check(all(math.isfinite(e) for e in e_k.values()), "e_K is not finite")
    check(e_k[rounds] < e_k[1], f"e_K did not fall: {e_k[1]} -> {e_k[rounds]}")
    counts = ops.launch_counts()
    check(counts["quant_pipeline"] == rounds and counts["unpack_bits"] == rounds
          and counts["pack_bits"] == 0,
          f"expected one quant_pipeline and one unpack_bits launch per round "
          f"({rounds}), got {counts}")
    print(f"[fedlt] launches over {rounds} rounds: {counts}")
    return alg, data, state, before


def phase_wire(state):
    from repro_torch.core.compression import UniformQuantizer
    from repro_torch.kernels.pack_bits import logical_words
    from repro_torch.wire.message import MESSAGE_HEADER_NBYTES

    codec = UniformQuantizer(levels=10, vmin=-1.0, vmax=1.0, clip=True).wire_codec()
    uplink = state.z_hat[0]                  # agent 0's last uplink wire
    msg = codec.encode(uplink)
    d = uplink.numel()
    expect = (MESSAGE_HEADER_NBYTES + codec.leaf_header_nbytes(1)
              + 4 * logical_words(d, 4))
    check(msg.nbytes == expect, f"wire nbytes {msg.nbytes} != {expect}")
    check(same_bits(codec.decode(msg), uplink), "wire decode is not bit-exact")
    print(f"[wire] agent 0's uplink: {msg.nbytes} bytes on the wire "
          f"(= 8 + {codec.leaf_header_nbytes(1)} + 4·{logical_words(d, 4)}), "
          "decoded bit-exact")


def check_captured_round(state, before):
    """The last round's uplink inputs, through kernel and plain version."""
    from repro_torch.core.compression import quantize_decode
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    from repro_torch.kernels.pack_bits import unpack_bits
    z_next, c_up = state.z, before.c_up      # every agent active
    words, newc = quant_pipeline(z_next, c_up, levels=10, vmin=-1.0, vmax=1.0)
    words_p, newc_p = ref.quant_pipeline_ref(z_next, c_up, levels=10,
                                             vmin=-1.0, vmax=1.0)
    check(same_bits(words, words_p) and same_bits(newc, newc_p),
          "captured round: kernel and plain version differ")
    check(same_bits(newc, state.c_up), "captured round: the kernel does not "
          "reproduce the run's new uplink cache")
    wire = quantize_decode(unpack_bits(words, 4, z_next.numel()), 10, -1.0,
                           1.0).reshape(z_next.shape)
    check(same_bits(wire, state.z_hat), "captured round: the decoded wire is "
          "not the run's z_hat")
    print(f"[fedlt] round {state.k} uplink (z_next, c_up) {tuple(z_next.shape)}: "
          f"kernel == plain version bit for bit, and == the run's c_up, z_hat")


def check_small_against_cpu():
    """The same small problem on the CPU (plain versions) and on the card."""
    from repro_torch.core.compression import UniformQuantizer
    from repro_torch.core.error_feedback import EFChannel
    from repro_torch.core.fedlt import FedLT, optimality_error
    from repro_torch.data.logistic import generate, make_local_loss, solve_global
    from repro_torch.core.pytree import tree_map

    data, _ = generate(1, n_agents=8, m=16, dim=8, device="cpu")
    quant = UniformQuantizer(levels=10, vmin=-1.0, vmax=1.0, clip=True)
    alg = FedLT(loss=make_local_loss(50.0, 8), n_epochs=10, gamma=0.005, rho=20.0,
                uplink=EFChannel(quant), downlink=EFChannel(quant),
                fused_uplink=True)
    active = np.random.default_rng(3).random((20, 8)) < 0.7
    active[:, 0] = True
    e = {}
    for dev in ("cpu", DEV):
        d = tree_map(lambda t: t.to(dev), data)
        xbar = solve_global(d, eps=50.0)
        st, _ = alg.run(alg.init(torch.zeros(8, device=dev), 8), d, 20,
                        active=active)
        e[dev] = float(optimality_error(st.x, xbar))
    rel = abs(e[DEV] - e["cpu"]) / e["cpu"]
    # matmul summation order differs between CPU and card
    check(rel < 1e-4, f"small run: e_K on the card {e[DEV]} vs CPU {e['cpu']}")
    print(f"[fedlt] small run (N=8, 20 rounds, partial participation): e_K card "
          f"{e[DEV]:.6e} vs CPU {e['cpu']:.6e} (rel {rel:.1e} < 1e-4)")


def phase_sign_entry(state, before) -> dict:
    """sign_pipeline through its entry point, ``ops.sign_pipeline``, on the
    Fed-LT run's last uplink message and cache (no path of the JAX package
    calls it; ``EFChannel.fusable()`` admits only the uniform quantizer).
    Returns the launch counts of that call."""
    from repro_torch.kernels import ops
    z_next, c_up = state.z, before.c_up
    ops.reset_launch_counts()
    words, scale, newc = ops.sign_pipeline(z_next, c_up)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts["sign_pipeline"] == 1 and sum(counts.values()) == 1,
          f"ops.sign_pipeline launched {counts}")
    e = check_sign_pair(z_next, c_up, f"on the Fed-LT uplink {tuple(z_next.shape)}")
    check(math.isfinite(float(scale)) and newc.shape == z_next.shape,
          "sign_pipeline: scale not finite or cache misshapen")
    print(f"[sign] ops.sign_pipeline on round {state.k}'s uplink "
          f"{tuple(z_next.shape)}: {words.numel()} words, scale {float(scale):.6e}; "
          f"== plain version (max diff {e:.1e}); launches {counts}")
    for _ in range(2):                  # the profiler has once come back empty
        per_call = phase_profile(
            lambda: [ops.sign_pipeline(z_next, c_up) for _ in range(10)], 10,
            "ops.sign_pipeline on the Fed-LT uplink", unit="call")
        if per_call:
            break
    check(per_call == 1, f"ops.sign_pipeline runs {per_call} device ops per call "
          "(0: the profiler recorded none in two tries)")
    print(f"[sign] device ops per ops.sign_pipeline call: {per_call:.0f}")
    return counts


# -- phase 11: the sign and sparse wire codecs ---------------------------------

def check_codec_leaf(codec, x, plain_words, what: str) -> None:
    """``codec`` on ``x`` on the card: one pack_bits launch (none for an
    empty sparse payload), words equal ``plain_words`` and the CPU's
    encode of the same values word for word, the byte counts equal the
    CPU's, and the decode (one unpack_bits launch, none for k = 0) gives
    ``x`` back bit for bit."""
    leaf, made = launched(lambda: codec.encode_leaf(x))
    k = leaf.meta.get("k", x.numel())
    check(made == ({"pack_bits": 1} if k else {}), f"{what}: encode launched {made}")
    check(same_bits(leaf.payload["words"], plain_words), f"{what}: words differ "
          "from the plain version")
    cpu = codec.encode_leaf(x.cpu())
    check(same_bits(leaf.payload["words"].cpu(), cpu.payload["words"])
          and (leaf.meta, leaf.header_nbytes, leaf.payload_nbytes)
          == (cpu.meta, cpu.header_nbytes, cpu.payload_nbytes),
          f"{what}: the card's encode differs from the CPU's")
    back, made = launched(lambda: codec.decode_leaf(leaf))
    check(made == ({"unpack_bits": 1} if k else {}), f"{what}: decode launched {made}")
    want = -x if (codec.kind == "sign" and not bool(x.any())) else x
    check(same_bits(back, want), f"{what}: decode does not give C(x) back bit for bit")


def phase_codecs(rng) -> None:
    """SignCodec and SparseCodec on the card at 100, 70,001 and 2**24 values,
    on ScaledSign, TopK(0.1) and RandD(0.2) outputs and on all-zero leaves."""
    from repro_torch.core.compression import RandD, ScaledSign, TopK
    from repro_torch.kernels import ref
    from repro_torch.wire.codecs import SignCodec, SparseCodec, index_bits
    gen = torch.Generator(device=DEV).manual_seed(5)
    for n in CODEC_SIZES:
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(DEV)
        zeros = torch.zeros(n, device=DEV)
        for comp, codec in ((ScaledSign(), SignCodec()), (TopK(0.1), SparseCodec(0.1)),
                            (RandD(0.2), SparseCodec(0.2))):
            for what, cx in ((type(comp).__name__, comp(gen, x)), ("zero leaf", zeros)):
                if codec.kind == "sign":
                    plain = ref.pack_bits_ref((cx > 0).to(torch.int32), 1)
                else:
                    plain = ref.pack_bits_ref(torch.nonzero(cx).reshape(-1), index_bits(n))
                check_codec_leaf(codec, cx, plain, f"{codec.kind} codec n={n} {what}")
        k = SparseCodec(0.2).encode_leaf(RandD(0.2)(gen, x)).meta["k"]
        check(k == round(0.2 * n), f"RandD(0.2) kept {k} of {n} values")
        print(f"[codecs] n={n}: SignCodec on ScaledSign, SparseCodec on TopK(0.1) and "
              f"RandD(0.2) outputs (indices at {index_bits(n)} bits, RandD keeps "
              f"{k}) and on all-zero leaves (k = 0: one tile of zero words, no "
              "launch): words == plain version and == the CPU's encode, word for "
              "word; decode == C(x) bit for bit (the zero leaf's sign decode -0.0)")


# -- phase 12: paper Table 2 at the paper's size -------------------------------

def phase_table2(launches: dict) -> dict:
    """All five algorithms under all four compressors through Experiment on
    Walker(100, 10) with k_direct=4, n_relay=2, at N=100, m=500, d=100, one
    Monte-Carlo run of TABLE2_ROUNDS rounds each."""
    from repro_torch.bench import table2_space_comparison as t2
    from repro_torch.bench.common import COMPRESSORS, problem
    from repro_torch.core.pytree import tree_map
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    engine = t2.make_engine(1.0)
    prob = problem(seed=0, scale=1.0, device=DEV)
    cpu_prob = (tree_map(lambda t: t.cpu(), prob[0]),) + prob[1:2] + (prob[2].cpu(), prob[3])
    torch.cuda.synchronize()
    print(f"[table2] set-up (data, x̄ by Newton) {time.perf_counter() - t0:.2f} s; "
          f"{TABLE2_ROUNDS} of the paper's 400 rounds per cell (cut for time; N, m, "
          "d are the paper's)")
    cells = {}
    for comp_name, C in COMPRESSORS.items():
        for algo in t2.ALGOS:
            what = f"{comp_name} {t2.LABEL[algo]}"
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            res = t2.run_cell(engine, C, algo, prob, TABLE2_ROUNDS, 200, device=DEV)
            e_first, e_last = res.logs[0].error, res.logs[-1].error
            wall = time.perf_counter() - t1
            counts = ops.launch_counts()
            for key, v in counts.items():
                launches[key] += v
            # one probe encode for the message size; the baselines and Table
            # 2's Fed-LT run the batched uplink chain, as in the JAX package
            expect = dict.fromkeys(SOURCES, 0)
            expect["pack_bits"] = 1
            check(counts == expect, f"{what}: launches {counts}, expected {expect}")
            check(math.isfinite(e_first) and math.isfinite(e_last),
                  f"{what}: e_K not finite")
            if algo == "led":
                check(e_last <= TABLE2_LED_RISE * e_first, f"{what}: e_K rose more "
                      f"than {TABLE2_LED_RISE - 1:.0%}: {e_first} -> {e_last}")
            else:
                check(e_last < e_first, f"{what}: e_K did not fall: {e_first} -> "
                      f"{e_last}")
            cells[(comp_name, algo)] = dict(e_first=e_first, e_last=e_last,
                                            ms_per_round=1e3 * wall / TABLE2_ROUNDS,
                                            bytes_up=res.logs[-1].bytes_up, res=res)
            print(f"[table2] {what}: e_K {e_first:.4e} -> {e_last:.4e}, "
                  f"{1e3 * wall / TABLE2_ROUNDS:.3f} ms per round (host clock, ending "
                  f"in the e_K read), bytes_up {res.logs[-1].bytes_up:.0f}")
    check_table2_against_cpu(engine, prob, cpu_prob, cells)
    check_table2_cohort(engine, prob, cpu_prob, launches)
    print("[table2] e_K after " + f"{TABLE2_ROUNDS} rounds (rows: algorithm; "
          "columns: " + ", ".join(COMPRESSORS) + ")")
    for algo in t2.ALGOS:
        print(f"[table2]   {t2.LABEL[algo]:24s} " + " ".join(
            f"{cells[(c, algo)]['e_last']:12.4e}" for c in COMPRESSORS))
    table = {k: (v["e_last"], 0.0) for k, v in cells.items()}
    print(f"[table2] fedltsat_wins={t2.wins(table)}/{len(COMPRESSORS)} at "
          f"{TABLE2_ROUNDS} rounds")
    return {f"{c}|{a}": {k: v for k, v in rec.items() if k != "res"}
            for (c, a), rec in cells.items()}


def check_table2_against_cpu(engine, prob, cpu_prob, cells) -> None:
    """quant_coarse: the first TABLE2_CHECK_ROUNDS rounds of every algorithm
    on the card and on the CPU from the same data, x and the received wires
    within rtol 1e-5, atol 1e-6.  rand_0.2: bytes_up after as many rounds
    equal to the CPU run's (RandD keeps exactly round(0.2·n) values, so the
    bytes do not depend on its draws, which differ between the devices)."""
    from repro_torch.bench import table2_space_comparison as t2
    from repro_torch.bench.common import COMPRESSORS
    r = TABLE2_CHECK_ROUNDS
    for algo in t2.ALGOS:
        card = t2.run_cell(engine, COMPRESSORS["quant_coarse"], algo, prob, r, 200,
                           device=DEV).state
        cpu = t2.run_cell(engine, COMPRESSORS["quant_coarse"], algo, cpu_prob, r, 200,
                          device="cpu").state
        wire = "z_hat" if hasattr(card, "z_hat") else "m_hat"
        for f in ("x", wire):
            a, b = getattr(card, f).cpu(), getattr(cpu, f)
            # matmul summation order differs between CPU and card
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                  f"quant_coarse {algo}: {f} after {r} rounds on the card vs the CPU: "
                  f"max diff {float((a - b).abs().max())}")
        cpu_rand = t2.run_cell(engine, COMPRESSORS["rand_0.2"], algo, cpu_prob, r, 200,
                               device="cpu")
        got = cells[("rand_0.2", algo)]["res"].logs[r - 1].bytes_up
        check(got == cpu_rand.logs[-1].bytes_up, f"rand_0.2 {algo}: bytes_up after {r} "
              f"rounds {got} on the card vs {cpu_rand.logs[-1].bytes_up} on the CPU")
    print(f"[table2] quant_coarse, every algorithm, first {r} rounds: x and the "
          "received wires on the card == the CPU run's within rtol 1e-5, atol 1e-6; "
          f"rand_0.2: bytes_up after {r} rounds == the CPU run's")


def check_table2_cohort(engine, prob, cpu_prob, launches) -> None:
    """FedAvg under rand_0.2 with measure="cohort": every landed update is
    encoded by SparseCodec, one pack_bits launch each (and one for the
    probe); bytes_up equals the CPU run's over the first
    TABLE2_CHECK_ROUNDS rounds."""
    from repro_torch.bench import table2_space_comparison as t2
    from repro_torch.bench.common import COMPRESSORS
    from repro_torch.kernels import ops
    C = COMPRESSORS["rand_0.2"]
    ops.reset_launch_counts()
    res = t2.run_cell(engine, C, "fedavg", prob, TABLE2_ROUNDS, 200, device=DEV,
                      measure="cohort")
    counts = ops.launch_counts()
    for key, v in counts.items():
        launches[key] += v
    landed = sum(lg.n_active for lg in res.logs)      # a lossless channel
    expect = dict.fromkeys(SOURCES, 0)
    expect["pack_bits"] = 1 + landed
    check(counts == expect, f"rand_0.2 FedAvg cohort: launches {counts}, expected "
          f"{expect} (one per landed update and the probe)")
    r = TABLE2_CHECK_ROUNDS
    cpu = t2.run_cell(engine, C, "fedavg", cpu_prob, r, 200, device="cpu",
                      measure="cohort")
    check(res.logs[r - 1].bytes_up == cpu.logs[-1].bytes_up,
          f"rand_0.2 FedAvg cohort: bytes_up after {r} rounds {res.logs[r - 1].bytes_up}"
          f" on the card vs {cpu.logs[-1].bytes_up} on the CPU")
    check(res.logs[-1].error < res.logs[0].error, "rand_0.2 FedAvg cohort: e_K did "
          "not fall")
    print(f"[table2] rand_0.2 FedAvg, measure=\"cohort\": {TABLE2_ROUNDS} rounds, "
          f"{landed} landed updates each encoded by SparseCodec ({counts['pack_bits']} "
          f"pack_bits launches with the probe's), bytes_up {res.logs[-1].bytes_up:.0f}; "
          f"after {r} rounds == the CPU run's; e_K {res.logs[0].error:.4e} -> "
          f"{res.logs[-1].error:.4e}")


# -- phase 13: the constellation example's FedAvg(space) arm ---------------------

def phase_example_fedavg(launches: dict) -> None:
    """``repro_torch.examples.satellite_constellation``'s FedAvg(space) run:
    walker-kiruna, cohort bytes, the coarse quantizer with EF, 120 rounds,
    traced; prints its obs.render_rounds table."""
    from repro_torch.examples import satellite_constellation as ex
    from repro_torch.kernels import ops
    data, x_star, quant, algs = ex.setup(DEV)
    name, alg_name, scenario, seed, kw = next(r for r in ex.RUNS if r[0] == "FedAvg(space)")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, path, table = ex.traced_run(name, algs[alg_name], scenario, seed, kw, data,
                                     x_star, quant, SAT_ROUNDS, DEV)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for key, v in counts.items():
        launches[key] += v
    expect = dict.fromkeys(SOURCES, 0)
    expect["pack_bits"] = 1                 # the probe; quant bytes are analytic
    check(counts == expect, f"example {name}: launches {counts}, expected {expect}")
    errs = [lg.error for lg in res.logs if lg.error is not None]
    check(len(res.logs) == SAT_ROUNDS and all(math.isfinite(e) for e in errs)
          and errs[-1] < errs[0], f"example {name}: e_K {errs}")
    print(f"[example] {name} on {scenario}: {SAT_ROUNDS} rounds in {wall:.2f} s "
          f"({1e3 * wall / SAT_ROUNDS:.3f} ms per round wall), trace {path}; "
          f"launches {counts}")
    print(table)


# -- phase 14: checkpoint and resume on the card ---------------------------------

def same_run(a, b, what: str) -> None:
    """Bit for bit: every leaf of the final state and every RoundLog."""
    from repro_torch.core.pytree import tree_flatten_with_names
    names, leaves_a = tree_flatten_with_names(a.state)
    check(names == tree_flatten_with_names(b.state)[0], f"{what}: state trees differ")
    for name, x, y in zip(names, leaves_a, tree_flatten_with_names(b.state)[1]):
        check(x == y if isinstance(x, int) else torch.equal(x, y),
              f"{what}: {name} differs from the uninterrupted run")
    check([dataclasses.asdict(lg) for lg in a.logs]
          == [dataclasses.asdict(lg) for lg in b.logs],
          f"{what}: RoundLogs (time, bytes_up, e_K, ...) differ from the "
          "uninterrupted run's")


def phase_resume(launches: dict) -> dict:
    """The main path's Fed-LTSat (walker-kiruna, fused uplink, cohort bytes,
    the coarse quantizer; the constellation example's N=100, m=200, d=100)
    and RandD(0.2) on the batched chain: 2R rounds with a checkpoint every
    round and without; R rounds, then a fresh Experiment resumed to 2R; and
    a copy of the R-round directory with its newest npz torn, resumed from
    round R-1.  Each held bit for bit to the uninterrupted run."""
    from repro_torch.api import Experiment
    from repro_torch.checkpoint.run import RunCheckpoint
    from repro_torch.core.compression import RandD
    from repro_torch.core.error_feedback import EFChannel
    from repro_torch.core.fedlt import optimality_error
    from repro_torch.examples import satellite_constellation as ex
    from repro_torch.kernels import ops
    data, xbar, quant, algs = ex.setup(DEV)
    rand = RandD(fraction=0.2)
    configs = {  # kind: (Experiment options, launches per round besides the probe)
        "quant": (dict(algorithm=algs["Fed-LTSat"], compressor=quant, measure="cohort"),
                  dict(quant_pipeline=1, unpack_bits=1)),
        "randd": (dict(algorithm=dataclasses.replace(
                      algs["Fed-LTSat"], uplink=EFChannel(rand),
                      downlink=EFChannel(rand), fused_uplink=False),
                       compressor=rand), {}),
    }
    R = RESUME_ROUNDS
    out = {}
    for kind, (kw, per_round) in configs.items():
        root = BUILD / f"resume_{kind}"
        shutil.rmtree(root, ignore_errors=True)

        def run(rounds, ck, walls=None, **run_kw):
            exp = Experiment.from_scenario("walker-kiruna", device=DEV, **kw)
            st = exp.init(torch.zeros(ex.DIM), ex.N_AGENTS)
            t0 = time.perf_counter()
            res = exp.run(st, data, rounds, 2, log_every=1,
                          checkpoint=None if ck is None else str(ck),
                          error_fn=lambda s: float(optimality_error(s.x, xbar)),
                          **run_kw)
            torch.cuda.synchronize()
            if walls is not None:
                walls["ckpt" if ck else "plain"] = time.perf_counter() - t0
            return res

        run(2, None)                    # the first launches
        walls = {}
        full = run(2 * R, None, walls)
        res = run(2 * R, root / "full", walls)
        same_run(res, full, f"{kind}: 2R rounds with a checkpoint every round")
        run(R, root / "half")
        shutil.copytree(root / "half", root / "torn")
        ops.reset_launch_counts()
        resumed = run(2 * R, root / "half", resume=True)
        counts = ops.launch_counts()
        for k, v in counts.items():
            launches[k] += v
        expect = dict.fromkeys(SOURCES, 0)
        expect["pack_bits"] = 1                     # the byte probe
        expect.update({k: R * v for k, v in per_round.items()})
        check(counts == expect, f"{kind}: launches over the {R} resumed rounds "
              f"{counts}, expected {expect}")
        same_run(resumed, full, f"{kind}: resumed at round {R}")
        with open(root / "torn" / f"round_{R:06d}.npz", "r+b") as f:
            f.truncate(64)                          # a writer killed mid-save
        trace = BUILD / f"resume_{kind}.jsonl"
        torn = run(2 * R, root / "torn", resume=True, trace=str(trace))
        marks = [r for r in torn.records if r.get("kind") == "resume"]
        check(len(marks) == 1 and marks[0]["k_next"] == R - 1,
              f"{kind}: the torn round {R} was not skipped: {marks}")
        same_run(torn, full, f"{kind}: resumed at round {R - 1} past a torn npz")
        ck = RunCheckpoint(str(root / "cost"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(1, CKPT_SAVES + 1):
            ck.save_round(full.state, step=step, t=full.logs[-1].time,
                          up_bytes=full.logs[-1].bytes_up, isl_bytes=0.0,
                          logs=full.logs)
        save_ms = 1e3 * (time.perf_counter() - t0) / CKPT_SAVES
        added_ms = 1e3 * (walls["ckpt"] - walls["plain"]) / (2 * R)
        lost = sum(lg.n_lost for lg in full.logs)
        print(f"[resume] {kind}: {2 * R} rounds, e_K {full.logs[0].error:.6e} -> "
              f"{full.logs[-1].error:.6e}, bytes_up {full.logs[-1].bytes_up:.0f}, "
              f"lost {lost}; checkpointed every round, resumed at round {R} "
              f"(launches {counts}) and at {R - 1} past a torn npz: state, "
              f"RoundLogs, bytes_up and t bit for bit the uninterrupted run's")
        print(f"[resume] {kind}: {1e3 * walls['plain'] / (2 * R):.3f} ms per round "
              f"without checkpoints, {1e3 * walls['ckpt'] / (2 * R):.3f} with one "
              f"every round (host clock; {added_ms:+.3f} ms per round); one "
              f"save_round (npz write, fsync, meta, prune) {save_ms:.3f} ms")
        out[kind] = dict(ms_plain=1e3 * walls["plain"] / (2 * R),
                         ms_ckpt=1e3 * walls["ckpt"] / (2 * R),
                         save_ms=save_ms, trace=str(trace))
    return out


# -- phase 15: the run ledger and the three ledger tables at a cut size ---------

#: the obs CLI's subprocesses, each with its argv and output files; they
#: run beside the phases and are collected by obs_cli_wait (stop_children
#: ends any still running when the script exits)
CLI_RUNS: list = []


def obs_cli_start(*args) -> dict:
    """Start ``python -m repro_torch.obs ARGS`` from the repository root,
    its output into files under build/."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = BUILD / f"obs_cli_{len(CLI_RUNS)}_{args[0]}"
    out, err = open(f"{base}.out", "w+"), open(f"{base}.err", "w+")
    run = dict(args=args, out=out, err=err, proc=subprocess.Popen(
        [sys.executable, "-m", "repro_torch.obs", *args], cwd=ROOT, env=env,
        stdout=out, stderr=err, text=True))
    CLI_RUNS.append(run)
    return run


def obs_cli_wait(run: dict) -> tuple:
    """(exit code, stdout, stderr) of a started CLI run."""
    rc = run["proc"].wait(timeout=300)
    texts = []
    for f in (run["out"], run["err"]):
        f.seek(0)
        texts.append(f.read())
        f.close()
    return (rc, *texts)


def stop_children() -> None:
    for run in CLI_RUNS:
        if run["proc"].poll() is None:
            run["proc"].kill()
            run["proc"].wait()


def table_cuts():
    """(name, module, sizes, runner(device, ledger), arms, exact row fields)"""
    from repro_torch.bench import table_fault_tolerance as tft
    from repro_torch.bench import table_lossy_ef as tle
    from repro_torch.bench import table_plane_agg as tpa
    from repro_torch.obs.report import plane_agg_rows
    big = dict(n_agents=100, m=100, dim=100)
    return (
        ("lossy", tle, big,
         lambda dev, led: tle.run(LOSSY_CUT["loss_rates"], rounds=LOSSY_CUT["rounds"],
                                  verbose=False, ledger_path=led, device=dev),
         3 * len(LOSSY_CUT["loss_rates"]),
         ("loss_rate", "arm", "lost", "received", "bytes_up")),
        ("fault", tft, big,
         lambda dev, led: tft.run(FAULT_CUT["crash_rates"], rounds=FAULT_CUT["rounds"],
                                  verbose=False, ledger_path=led, device=dev),
         2 * len(FAULT_CUT["crash_rates"]),
         ("crash_rate", "arm", "quorum", "bytes_up", "lost", "t_sim", "quorum_frac")),
        ("plane", tpa, dict(n_agents=100, m=40, dim=32),
         lambda dev, led: plane_agg_rows(tpa.run_sweep(
             tpa.WALKER_ARMS, rounds=PLANE_CUT_ROUNDS, n_agents=100, dim=32, m=40,
             group="walker", ledger_path=led, device=dev)),
         len(tpa.WALKER_ARMS),
         ("arm", "topology", "scenario", "bytes_gs", "bytes_isl", "updates", "lost")),
    )


class Split(Exception):
    """Raised by the CPU run of a fault arm at a round whose wires part
    from the card's: (round, z_hat, c_down, z) of the CPU."""


def fault_engine(horizon: float):
    """An engine of the fault table's scenario whose contact plan reaches
    ``horizon``.  Rounds depend on the plan's horizon, and the table's
    sweep shares one engine, so an arm starts on the horizon that the arms
    before it grew (ROADMAP Queue 3); a run that repeats an arm, or
    resumes it, starts from the horizon that arm had."""
    from repro_torch.bench import table_fault_tolerance as tft
    from repro_torch.sim import Engine
    engine = Engine(tft._scenario())
    engine.ensure(engine.plan.t_start + horizon)
    check(engine.plan.horizon == horizon, f"a contact plan of horizon "
          f"{engine.plan.horizon} s, not {horizon}")
    return engine


def fault_arm_card(prob, crash_rate, arm, rounds, horizon, ckpt_dir):
    """One arm of the fault table on the card, built by
    ``table_fault_tolerance.make_arm`` as the table builds it, on an engine
    whose plan starts at the sweep's ``horizon`` for it, with a checkpoint
    after every round kept in ``ckpt_dir``; every round's (e_K, z_hat,
    c_down, c_up, the plan's horizon) on the host."""
    from repro_torch.bench import table_fault_tolerance as tft
    from repro_torch.checkpoint.run import RunCheckpoint
    from repro_torch.core.fedlt import optimality_error
    data, loss, x_star = prob
    exp = tft.make_arm(loss, crash_rate, arm, fault_engine(horizon), device=DEV)
    seen = []

    def err(st):
        seen.append((float(optimality_error(st.x, x_star)),
                     *(t.cpu().clone() for t in (st.z_hat, st.c_down, st.c_up)),
                     exp.engine.plan.horizon))
        return seen[-1][0]

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    exp.runner.run(exp.algorithm, exp.init(torch.zeros(x_star.shape[0]),
                                           data["a"].shape[0]),
                   data, rounds, tft.RUN_SEED, error_fn=err, log_every=1,
                   ckpt=RunCheckpoint(str(ckpt_dir), keep_last=0))
    return seen


def check_fault_lockstep(card, horizon, ckpt_dir, cpu_prob, crash_rate, arm,
                         what: str):
    """The CPU's run of a fault arm held to the card's round by round: e_K
    within rtol 1e-4 at every round.  A round whose wires part (z_hat
    differs, or the downlink's EF cache c_down by half a level or more)
    must be a rounding tie: the downlink's input (the mean of the wires
    plus its EF cache) where its output differs, or else each uplink's
    input (z plus its EF cache) where its wire differs, lies within 1e-4
    of a level of a point half-way between two levels of the quantizer's
    grid, which float32 sums in another order round either way (ROADMAP
    Queue 3).  The downlink runs first in a round, so where it differs the
    uplinks follow it.  The CPU run then resumes from the card's
    checkpoint after that round, on a plan of the card's horizon there, and
    is held on to the last round.  The CPU's run starts on ``horizon``, as
    the card's did.  Returns the rounds where it split."""
    from repro_torch.bench import table_fault_tolerance as tft
    from repro_torch.bench.common import COMPRESSORS
    from repro_torch.checkpoint.run import RunCheckpoint
    from repro_torch.core.fedlt import optimality_error
    C = COMPRESSORS["quant_coarse"]
    delta = (C.vmax - C.vmin) / C.levels
    data, loss, x_star = cpu_prob
    rounds = len(card)
    # (z_hat, c_down, c_up) of the state the CPU's round k+1 starts from
    prev = {-1: tuple(torch.zeros_like(t) for t in card[0][1:4])}
    splits, start = [], 0
    while True:
        exp = tft.make_arm(loss, crash_rate, arm, fault_engine(
            card[start - 1][4] if start else horizon), device="cpu")
        k = [start]

        def err(st):
            r, k[0] = k[0], k[0] + 1
            if (not torch.equal(st.z_hat, card[r][1])
                    or float((st.c_down - card[r][2]).abs().max()) >= delta / 2):
                raise Split(r, st.z_hat.clone(), st.c_down.clone(), st.z.clone())
            e = float(optimality_error(st.x, x_star))
            check(abs(card[r][0] - e) < 1e-4 * abs(e), f"{what}: round {r} e_K "
                  f"{card[r][0]} on the card vs {e} on the CPU, with the same wires")
            prev[r] = (st.z_hat.clone(), st.c_down.clone(), st.c_up.clone())
            return e

        ckpt = None
        if start:
            # the card's state after round start-1, as the run saved it
            ckpt = ckpt_dir / f"cpu_from_{start}"
            shutil.rmtree(ckpt, ignore_errors=True)
            ckpt.mkdir(parents=True)
            for ext in (".npz", ".meta.json"):
                shutil.copy(ckpt_dir / f"round_{start:06d}{ext}", ckpt)
            ckpt = RunCheckpoint(str(ckpt), keep_last=0)
        try:
            exp.runner.run(exp.algorithm, exp.init(torch.zeros(x_star.shape[0]),
                                                   data["a"].shape[0]),
                           data, rounds, tft.RUN_SEED, error_fn=err, log_every=1,
                           ckpt=ckpt, ckpt_every=rounds + 1, resume=ckpt is not None)
            return splits
        except Split as split:
            f, z_hat, c_down, z = split.args
        z_prev, c_prev, cu_prev = prev[f - 1]
        down = (c_down - card[f][2]).abs() >= delta / 2
        if bool(down.any()):
            link, where = "downlink", down
            u = z_prev.double().mean(0) + c_prev.double()
        else:
            link, where = "uplink", z_hat != card[f][1]
            u = z.double() + cu_prev.double()
        off = (torch.frac((u.clamp(C.vmin, C.vmax) - C.vmin) / delta) - 0.5).abs()
        check(float(off[where].max()) < 1e-4,
              f"{what}: the wires part at round {f}; the {link} differs at "
              f"{where.nonzero().tolist()}, whose inputs are {off[where].tolist()} "
              "of a level from a tie")
        splits.append((f, link))
        prev[f] = card[f][1:4]                  # the card's state after round f
        start = f + 1


def phase_ledger_tables(launches: dict, trace: str) -> dict:
    """The three tables at their cut sizes on the card, rows from a ledger
    under build/ only, each held against the same cut run on the CPU from
    the card's data; the plane table's --smoke; and the obs CLI's report
    (on the lossy ledger), check and chrome (on ``trace``) as subprocesses
    beside them."""
    from repro_torch.bench import common
    from repro_torch.bench import table_plane_agg as tpa
    from repro_torch.core.pytree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.obs import report
    from repro_torch.obs.ledger import load_ledger
    rows_of = {"lossy": report.lossy_ef_rows, "fault": report.fault_tolerance_rows,
               "plane": report.plane_agg_rows}
    cli = [obs_cli_start("check", trace),
           obs_cli_start("chrome", trace, "-o", str(BUILD / "resume.perfetto.json"))]
    out = {}
    for name, mod, sizes, run, arms, exact in table_cuts():
        prob = common.logistic_problem(0, device=DEV, **sizes)
        cpu_prob = (tree_map(lambda t: t.cpu(), prob[0]), prob[1], prob[2].cpu())
        real, real_arm = mod.logistic_problem, getattr(mod, "make_arm", None)
        rows, walls, starts = {}, {}, {}
        try:
            for dev, p in ((DEV, prob), ("cpu", cpu_prob)):
                mod.logistic_problem = lambda *a, p=p, **k: p
                if real_arm is not None:
                    # the plan horizon each arm starts on, on the sweep's engine
                    def make_arm(loss, crash_rate, arm, engine, dev=dev, **kw):
                        starts[dev, crash_rate, arm[0]] = engine.plan.horizon
                        return real_arm(loss, crash_rate, arm, engine, **kw)
                    mod.make_arm = make_arm
                ledger = BUILD / f"ledger_{name}_{dev}.jsonl"
                ledger.unlink(missing_ok=True)
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                rows[dev] = run(dev, str(ledger))
                walls[dev] = time.perf_counter() - t0
                if name == "lossy" and dev == DEV:
                    cli.append(obs_cli_start("report", "--ledger", str(ledger),
                                             "--frontier"))
                counts = ops.launch_counts()
                if dev == DEV:
                    for k, v in counts.items():
                        launches[k] += v
                    # the reference's path: the byte probe, then the batched
                    # EFChannel chain, no fused uplink
                    expect = dict.fromkeys(SOURCES, 0)
                    expect["pack_bits"] = arms
                    check(counts == expect, f"{name} table: launches {counts}, "
                          f"expected {expect} (one probe per arm)")
                check(rows[dev] == rows_of[name](load_ledger(str(ledger))),
                      f"{name} table on {dev}: rows are not the ledger's")
        finally:
            mod.logistic_problem = real
            if real_arm is not None:
                mod.make_arm = real_arm
        card, cpu = rows[DEV], rows["cpu"]
        check(all(starts[DEV, cr, arm] == h for (d, cr, arm), h in starts.items()),
              f"{name} table: the arms' plan horizons differ between the card and "
              f"the CPU: {starts}")
        check(len(card) == len(cpu) == arms, f"{name} table: {len(card)} rows on "
              f"the card, {len(cpu)} on the CPU, {arms} arms")
        worst, ties = 0.0, []
        for a, b in zip(card, cpu):
            for f in exact:
                check(a[f] == b[f], f"{name} table, {a['arm']}: {f} {a[f]} on the "
                      f"card vs {b[f]} on the CPU")
            check(math.isfinite(a["error"]), f"{name} table, {a['arm']}: e_K "
                  f"{a['error']}")
            rel = abs(a["error"] - b["error"]) / abs(b["error"])
            worst = max(worst, rel)
            # matmul summation order differs between CPU and card
            if rel < 1e-4 or name != "fault":
                check(rel < 1e-4, f"{name} table, {a['arm']}: e_K {a['error']} on "
                      f"the card vs {b['error']} on the CPU")
                continue
            # the fault table's arms put ~70 satellites' wires into each
            # downlink mean: the two devices may round a tie apart, and the
            # runs then go separate ways.  Such an arm is run again on the
            # card, checkpointed every round, and held round by round
            arm = next(x for x in mod.ARMS if x[0] == a["arm"])
            what = f"fault table, crash {a['crash_rate']}, {a['arm']}"
            ckpt_dir = BUILD / f"lockstep_{a['crash_rate']}_{arm[1]}"
            horizon = starts[DEV, a["crash_rate"], a["arm"]]
            card_rounds = fault_arm_card(prob, a["crash_rate"], arm,
                                         FAULT_CUT["rounds"], horizon, ckpt_dir)
            check(card_rounds[-1][0] == a["error"], f"{what}: the run again on the "
                  f"card ends at e_K {card_rounds[-1][0]}, its row at {a['error']}")
            splits = check_fault_lockstep(card_rounds, horizon, ckpt_dir, cpu_prob,
                                          a["crash_rate"], arm, what)
            check(splits, f"{what}: e_K {a['error']} on the card vs {b['error']} "
                  "on the CPU, and no round's wires differ")
            at = ", ".join(f"{f} ({link})" for f, link in splits)
            ties.append(f"{what}: rel {rel:.1e} at the end; ties rounded apart at "
                        f"rounds {at}, the CPU resumed from the card's checkpoint "
                        f"after each, e_K within 1e-4 at every other round")
        rounds = {"lossy": LOSSY_CUT["rounds"], "fault": FAULT_CUT["rounds"],
                  "plane": PLANE_CUT_ROUNDS}[name]
        for row in card:
            print(f"[ledger] {mod.render_row(row)}")
        print(f"[ledger] {name} table, {arms} arms x {rounds} rounds: "
              f"{1e3 * walls[DEV] / (arms * rounds):.3f} ms per round on the card "
              f"(host clock), {1e3 * walls['cpu'] / (arms * rounds):.3f} on the CPU; "
              + (f"exact fields equal, e_K within rel {worst:.1e} < 1e-4" if not ties
                 else f"exact fields equal; e_K: {'; '.join(ties)}"))
        out[name] = dict(ms_per_round=1e3 * walls[DEV] / (arms * rounds),
                         rows=card, e_rel=worst, ties=ties)
    check(tpa.smoke(), "plane-agg --smoke: the fast path and the heapq oracle differ")
    for proc in cli:
        rc, stdout, stderr = obs_cli_wait(proc)
        args = proc["args"]
        check(rc == 0, f"python -m repro_torch.obs {' '.join(args)}: exit "
              f"{rc}\n{stdout}{stderr}")
        print(f"[ledger] python -m repro_torch.obs {args[0]} {args[1]}: exit 0")
        print("\n".join(f"[ledger]   {ln}" for ln in stdout.splitlines()))
    return out


# -- phase 16: the convergence gate over phase 6's traces ------------------------

def start_convgate(canonical: dict) -> dict:
    """Start ``python -m repro_torch.obs convgate`` on phase 6's four
    traces; it runs beside phases 14 and 15."""
    from repro_torch.obs.report import CANONICAL
    return obs_cli_start("convgate", *(canonical[n]["trace"] for n in CANONICAL),
                         "--reference", str(ROOT / "CONV_reference.json"))


def phase_convgate(run: dict) -> dict:
    """The convgate run's verdict per scenario (exit 0 or 1).  Phase 6 ran
    on the port's own draws, and the 1.25x e_K gate holds with JAX's
    (tests/test_torch_canonical.py), so a failing verdict is recorded, not
    failed on."""
    from repro_torch.obs.report import CANONICAL
    rc, stdout, stderr = obs_cli_wait(run)
    check(rc in (0, 1), f"convgate: exit {rc}\n{stdout}{stderr}")
    verdicts = dict((n, v) for v, n in re.findall(r"^CONVGATE (OK|FAIL) (\S+):",
                                                   stdout, re.M))
    check(sorted(verdicts) == sorted(CANONICAL), f"convgate: verdicts {verdicts}")
    print(f"[convgate] exit {rc} on the card's draws")
    shown = {}                    # each verdict and its first violations
    for ln in stdout.splitlines():
        name = ln.split(":")[0].split()[-1]
        shown[name] = shown.get(name, 0) + 1
        if shown[name] <= 4:
            print(f"[convgate]   {ln}")
    return dict(rc=rc, verdicts=verdicts)


# -- phase 17: federated training of stablelm-1.6b -----------------------------

def train_config(**changes):
    from repro_torch.configs import get
    return dataclasses.replace(get(TRAIN_ARCH), **changes)


def train_batch(cfg, round_idx: int, seq: int = TRAIN_SEQ) -> dict:
    """The launcher's batch of round ``round_idx``: agent i draws from
    seeded(11 + i, round_idx)."""
    from repro_torch.data.synthetic import make_batch, seeded, stack_batches
    return stack_batches([make_batch(cfg, seeded(11 + i, round_idx), TRAIN_BATCH,
                                     seq, device=DEV) for i in range(TRAIN_AGENTS)])


def n_attention_layers(cfg) -> int:
    """Attention layers of ``cfg`` (shared ones once per occurrence)."""
    from repro_torch.models.transformer import ATTN_KINDS
    return (sum(k in ATTN_KINDS for k in cfg.scan_unit) * cfg.scan_repeats
            + sum(k in ATTN_KINDS for k in cfg.tail))


def attention_launches(cfg, dtype, agents: int, epochs: int) -> dict:
    """Attention launches of one round of ``agents`` x ``epochs`` local
    epochs: each attention layer's forward twice per epoch and agent (the
    forward, and remat's recompute in the backward, on the dtype's route,
    both writing the backward's statistics) and its backward once, reading
    the recompute's (no further forward launch); none without attention
    layers."""
    from repro_torch.kernels import flash_attention as fa
    n = n_attention_layers(cfg) * agents * epochs
    return {fa.route(dtype, DEV): 2 * n, fa.bwd_route(dtype, DEV): n} if n else {}


def train_attention_launches(cfg, dtype) -> dict:
    """attention_launches of one round at phase 17's agents and epochs."""
    return attention_launches(cfg, dtype, TRAIN_AGENTS, TRAIN_EPOCHS)


def quant_launches(alg, agents: int) -> dict:
    """The uplink's and downlink's kernel launches of one unsharded round of
    ``alg`` with ``agents`` agents, derived from its model's leaves (the
    parameter tree on the meta device): with compression, the downlink one
    quantize_ef (no cache) per leaf; the uplink one quantize_ef per leaf,
    but a leaf of at least one tile of values with its agent axis, with
    ``pack_wire``, takes one quant_pipeline (fused) or quantize_ef and one
    pack_bits (unfused), and one unpack_bits per run of ``deploy.PIECE``
    values (the decode's pieces)."""
    from repro_torch.core import deploy
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels.pack_bits import _TILE_VALS
    from repro_torch.models.transformer import init_params
    if not alg.compress:
        return {}
    sizes = [agents * t.numel() for t in tree_leaves(init_params(alg.cfg, device="meta"))]
    packed = [n for n in sizes if n >= _TILE_VALS] if alg.pack_wire else []
    fused = len(packed) if alg.fuse_pipeline else 0
    out = {"quantize_ef": 2 * len(sizes) - fused}
    if packed:
        out.update({"quant_pipeline" if fused else "pack_bits": len(packed),
                    "unpack_bits": sum(-(-n // deploy.PIECE) for n in packed)})
    return out


def hold_quant_leaves(state) -> dict:
    """What check_quant_plain needs of a round's input ``state``, for one
    leaf per dtype (the largest): {leaf index: (its c_up, its c_down)}.
    Holding them keeps those two tensors alive past the round."""
    from repro_torch.core.pytree import tree_leaves
    xs, largest = tree_leaves(state.x), {}
    for i, x in enumerate(xs):
        if x.dtype not in largest or x.numel() > xs[largest[x.dtype]].numel():
            largest[x.dtype] = i
    cu, cd = tree_leaves(state.c_up), tree_leaves(state.c_down)
    return {i: (cu[i], cd[i]) for i in largest.values()}


def check_quant_plain(alg, held: dict, new, what: str) -> dict:
    """The round's quantized state against the old route on the leaves of
    ``held`` (hold_quant_leaves of its input): the pieced plain quantizer
    (ref.quantize_ef_ref, PyTorch ops) called directly on the round's z_new
    and the old c_up, the decode, the agent mean and the downlink (the
    plain quantizer with no cache) as round_step computes them; the new
    c_up, ŷ and c_down bit for bit (every agent in the quorum).  Returns
    {dtype: the leaf's shape}."""
    from repro_torch.core.compression import quantize_decode
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ref
    z, cu, yh, cd = (tree_leaves(getattr(new, f)) for f in ("z", "c_up", "y_hat", "c_down"))
    q, out = alg.quant, {}
    for i, (c_old, cd_old) in held.items():
        w, nc = ref.quantize_ef_ref(z[i], c_old, **q)
        check(same_bits_big(nc, cu[i]), f"{what}: the new c_up of a {tuple(z[i].shape)} "
              f"{z[i].dtype} leaf differs from the plain quantizer's")
        del nc
        y = cd_old + quantize_decode(w, dtype=z[i].dtype, **q).mean(dim=0).to(cd_old.dtype)
        del w
        y_hat = quantize_decode(ref.quantize_ef_ref(y, None, **q)[0], dtype=y.dtype, **q)
        check(same_bits_big(y_hat, yh[i]) and same_bits_big(y - y_hat, cd[i]),
              f"{what}: ŷ or c_down of a {tuple(z[i].shape)} {z[i].dtype} leaf differs "
              "from the plain downlink of the plain uplink's mean")
        out[str(z[i].dtype)[6:]] = list(z[i].shape)
        del y, y_hat
    return out


def phase_train(launches: dict) -> dict:
    """17a: ``repro_torch.launch.train.main`` on stablelm-1.6b at full width
    and depth in bf16 (random weights from the launcher's seed), TRAIN_ROUNDS
    rounds with a checkpoint on the last: every round's loss finite and the
    last below the first, each round's attention launches as derived, and
    the checkpoint restoring bit for bit."""
    from repro_torch.checkpoint import store
    from repro_torch.core.deploy import DeployFedLT
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    cfg = train_config()
    alg = DeployFedLT(cfg=cfg, n_epochs=TRAIN_EPOCHS, gamma=0.02, rho=10.0)   # the launcher's
    ckpt = BUILD / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()            # the main path: the launcher's rounds
    t0 = time.perf_counter()
    run = train.main(TRAIN_ARGV + ["--checkpoint-dir", str(ckpt)], device=DEV)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts.items():
        launches[k] += v
    want = dict(train_attention_launches(cfg, torch.bfloat16),
                **quant_launches(alg, TRAIN_AGENTS))
    check(all(r == want for r in run.launches), f"training rounds launched "
          f"{run.launches}, expected {want} each (attention, and quantize_ef once per "
          "leaf on the uplink and once on the downlink: the wire is not packed)")
    check(all(math.isfinite(x) for x in run.losses) and run.losses[-1] < run.losses[0],
          f"training losses {run.losses}: not finite, or the last not below the first")
    restored = store.restore(run.checkpoints[-1], run.state.y_hat)
    check(all(same_bits(a, b) for a, b in zip(tree_leaves(restored),
                                              tree_leaves(run.state.y_hat))),
          "the last round's checkpoint of y_hat does not restore bit for bit")
    del restored
    # one more of the launcher's rounds from its last state, against the old
    # route (the plain quantizer) on one leaf per dtype
    held = hold_quant_leaves(run.state)
    ops.reset_launch_counts()            # the main path: one more round
    new, _ = alg.round_step(run.state, train_batch(cfg, TRAIN_ROUNDS))
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    for k, v in counts.items():
        launches[k] += v
    check(counts == want, f"a launcher round from the last state launched {counts}, "
          f"expected {want}")
    plain = check_quant_plain(alg, held, new, "17a, a launcher round")
    del new, held
    n_params = sum(t.numel() for t in tree_leaves(run.state.y_hat))
    out = {"arch": TRAIN_ARCH, "params": n_params, "losses": run.losses,
           "ms_per_round": [1e3 * x for x in run.seconds], "launches_per_round": want,
           "peak_bytes": peak, "total_s": total_s, "checkpoint": run.checkpoints[-1],
           "plain_route_leaves": plain}
    print(f"[train] {TRAIN_ARCH} at full width and depth, bf16, {n_params} parameters, "
          f"{TRAIN_AGENTS} agents x batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"{TRAIN_EPOCHS} epochs a round: losses "
          + ", ".join(f"{x:.4f}" for x in run.losses) + "; ms per round "
          + ", ".join(f"{x:.1f}" for x in out["ms_per_round"])
          + f" (host clock to the loss read back); launches per round {want} "
          f"(flash_attention_bwd_sm90 from the card's kernel, never the plain version); "
          f"a further round's c_up, ŷ and c_down equal to the old route's (the plain "
          f"quantizer) bit for bit on its largest leaf per dtype {plain}; "
          f"peak memory {peak / 2**30:.2f} GiB (max_memory_allocated); checkpoint "
          f"round {TRAIN_ROUNDS} restores bit for bit; {total_s:.1f} s with set-up")
    return out, run.state


def same_ints(a: torch.Tensor, b: torch.Tensor, piece: int = 2**26) -> bool:
    """Equal integer values (any widths), compared a piece at a time."""
    from repro_torch.kernels.ref import as_int64
    a, b = a.reshape(-1), b.reshape(-1)
    return a.numel() == b.numel() and all(
        torch.equal(as_int64(a[s:s + piece]), as_int64(b[s:s + piece]))
        for s in range(0, a.numel(), piece))


def same_unpacked(words, ints, bits: int, tiles: int = 2048) -> bool:
    """unpack_bits of ``words`` equal to the integer values ``ints``, a run
    of ``tiles`` tiles (2**26 values, one launch) at a time, so no uint32
    copy of a whole leaf is made: the words are tile-major, so a run's
    words are one slice."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.pack_bits import LANES, R, _TILE_VALS
    flat, n = ints.reshape(-1), ints.numel()
    step, piece = tiles * bits * R * LANES, tiles * _TILE_VALS
    return all(same_ints(ops.unpack_bits(words[w:w + step], bits, min(piece, n - s)),
                         flat[s:s + piece])
               for w, s in zip(range(0, words.numel(), step), range(0, n, piece)))


def check_leaf_plain(z, c, ints, words_q, nc_q, words_p, q: dict, bits: int) -> None:
    """quant_pipeline's words and new cache and pack_bits' words for one
    leaf against their plain versions (ref.quant_pipeline_ref,
    ref.pack_bits_ref), a piece of 2**26 values (2048 tiles) at a time:
    words word for word, cache bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pack_bits import _TILE_VALS
    piece = 2048 * _TILE_VALS
    zf, cf, nf, intsf = z.reshape(-1), c.reshape(-1), nc_q.reshape(-1), ints.reshape(-1)
    for s in range(0, zf.numel(), piece):
        e = min(zf.numel(), s + piece)
        w_ref, nc_ref = ref.quant_pipeline_ref(zf[s:e], cf[s:e], **q)
        ws = s // 32 * bits
        check(same_bits(words_q[ws:ws + w_ref.numel()], w_ref)
              and same_bits(nf[s:e], nc_ref)
              and same_bits(words_p[ws:ws + w_ref.numel()],
                            ref.pack_bits_ref(intsf[s:e], bits)),
              f"a {tuple(z.shape)} {z.dtype} leaf, values {s}..{e}: quant_pipeline or "
              "pack_bits differs from its plain version")
        del w_ref, nc_ref


def phase_train_packed(state, launches: dict) -> dict:
    """17b: one packed round of stablelm-1.6b from the launcher's last
    state (packed_round), checked (check_packed_round)."""
    alg, new, res = packed_round(state, launches, train_config())
    return check_packed_round(alg, new, state.c_up, res)


def packed_round(state, launches: dict, cfg) -> tuple:
    """One round of ``cfg`` with ``pack_wire=True`` from ``state``: one
    quant_pipeline launch per leaf of at least one tile (bf16 weights and
    float32 norms alike) and one unpack_bits per run of ``deploy.PIECE``
    values of it, one quantize_ef per smaller leaf and one per leaf on the
    downlink (quant_launches), beside
    the attention layers', and a finite loss.  Returns (the packed
    DeployFedLT, the new state, the round's summary, whose "held" is
    hold_quant_leaves of ``state`` for check_packed_round)."""
    from repro_torch.core.deploy import DeployFedLT
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.kernels.pack_bits import _TILE_VALS
    alg = DeployFedLT(cfg=cfg, n_epochs=TRAIN_EPOCHS, gamma=0.02, rho=10.0, pack_wire=True)
    batch = train_batch(cfg, TRAIN_ROUNDS)
    tiles = [x.numel() for x in tree_leaves(state.x) if x.numel() >= _TILE_VALS]
    held = hold_quant_leaves(state)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()            # the main path: one packed round
    (new, metrics), ms = sync_ms(lambda: alg.round_step(state, batch))
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts.items():
        launches[k] += v
    want = dict(train_attention_launches(cfg, torch.bfloat16),
                **quant_launches(alg, TRAIN_AGENTS))
    check(counts == want, f"{cfg.name} packed round launched {counts}, expected {want}")
    check(math.isfinite(float(metrics["loss"])), f"{cfg.name} packed round's loss not finite")
    return alg, new, {"ms": ms, "launches": counts, "tile_leaves": len(tiles),
                      "largest_leaf": max(tiles), "peak_bytes": peak,
                      "loss": float(metrics["loss"]), "held": held}


def check_packed_round(alg, new, c_up, res: dict) -> dict:
    """17b's checks of a packed round (``packed_round``: its DeployFedLT,
    new state and summary) from a state whose EF caches were ``c_up``:
    the round's c_up, ŷ and c_down against the old route on its largest
    leaf per dtype (check_quant_plain); leaf by leaf: unpack_bits of
    quant_pipeline's words and of pack_bits' words equal to the plain
    quantizer's level ints (``ref.quantize_ef_ref``, PyTorch ops a piece at
    a time) and quant_pipeline's new cache to its cache, bit for bit; the
    fused uplink against the unfused one (quantize_ef and pack_bits): words,
    gathered values, their agent mean and the new EF cache equal bit for
    bit, and the round's cache the fused one's; and on the largest leaf,
    quant_pipeline and pack_bits against their plain versions word for
    word.  Whole leaves are compared a piece at a time and each tensor is
    dropped once compared, so a leaf past 2**31 values (gemma3-27b's
    table) fits beside the two states.  Returns the summary, completed."""
    from repro_torch.core import deploy
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pack_bits import _TILE_VALS
    res = dict(res)
    plain = check_quant_plain(alg, res.pop("held"), new, f"{alg.cfg.name} packed round")
    unfused = dataclasses.replace(alg, fuse_pipeline=False)
    q = alg.quant
    bits, n_vals, dtypes = alg.wire_word_bits, 0, {}
    largest = res["largest_leaf"]
    for z, c, c_new in zip(tree_leaves(new.z), tree_leaves(c_up),
                           tree_leaves(new.c_up)):
        if z.numel() < _TILE_VALS:
            continue
        what = f"packed uplink of a {tuple(z.shape)} {z.dtype} leaf"
        ints, nc_plain = ref.quantize_ef_ref(z, c, **q)
        words_f, nc_q = ops.quant_pipeline(z, c, **q)
        check(same_bits_big(nc_q, nc_plain), f"{what}: quant_pipeline's new cache "
              "differs from the plain quantizer's")
        del nc_plain
        words_u = ops.pack_bits(ints, bits)
        check(same_unpacked(words_f, ints, bits) and same_unpacked(words_u, ints, bits),
              f"{what}: unpack_bits of quant_pipeline's or pack_bits' words differs "
              "from the plain level ints")
        if z.numel() == largest:
            check_leaf_plain(z, c, ints, words_f, nc_q, words_u, q, bits)
        check(same_bits_big(words_f, words_u), f"{what}: fused and unfused words differ")
        del ints, nc_q, words_f, words_u
        g_f, nc_f = alg.uplink_leaf(z, c)
        check(same_bits_big(nc_f, c_new), f"{what}: the round's new cache differs from "
              "the fused uplink's")
        g_u, nc_u = unfused.uplink_leaf(z, c)
        check(same_bits_big(nc_f, nc_u), f"{what}: fused and unfused caches differ")
        del nc_f, nc_u
        check(same_bits_big(g_f, g_u) and same_bits_big(g_f.mean(dim=0), g_u.mean(dim=0)),
              f"{what}: fused and unfused gathered values or means differ")
        n_vals += z.numel()
        dtypes[str(z.dtype)[6:]] = dtypes.get(str(z.dtype)[6:], 0) + 1
        del g_f, g_u
    # the fused uplink kernel alone on the largest leaf (bf16, with the agent
    # axis): 4 B read and 2 B written per value and b/8 B of words
    z, c = max(((z, c) for z, c in zip(tree_leaves(new.z), tree_leaves(c_up))),
               key=lambda zc: zc[0].numel())
    leaf_ms = time_ms(lambda: ops.quant_pipeline(z, c, **q), iters=3, warmup=1)
    leaf_bound, _ = bound(z.numel() * (3 * z.element_size() + bits / 8), 44 * z.numel())
    print(f"[times] quant_pipeline on the largest leaf, {tuple(z.shape)} {z.dtype}, "
          f"L={alg.levels}: {leaf_ms:.3f} ms, bound {leaf_bound:.3f} ms by bytes "
          f"({100 * leaf_bound / leaf_ms:.1f}% of it)")
    del z, c
    out = dict(res, values=n_vals, largest_leaf_kernel_ms=leaf_ms,
               largest_leaf_bound_ms=leaf_bound, leaf_dtypes=dtypes,
               plain_route_leaves=plain)
    print(f"[train] {alg.cfg.name} packed wire (levels {alg.levels}, {bits}-bit words), "
          f"one round: {out['ms']:.1f} ms, launches {out['launches']}: one quant_pipeline "
          f"per leaf of >= {_TILE_VALS} values and one unpack_bits per run of "
          f"{deploy.PIECE} values of it ({out['tile_leaves']} "
          f"leaves, {dtypes} by dtype, {n_vals} values, the largest {largest}); leaf by leaf, "
          f"unpack_bits of both routes' words equal to the plain level ints and "
          f"quant_pipeline's cache to the plain one, bit for bit; fused and unfused "
          f"uplinks equal bit for bit (words, gathered values, agent means, new "
          f"caches); on the largest leaf quant_pipeline and pack_bits equal to their "
          f"plain versions word for word; c_up, ŷ and c_down equal to the old route's "
          f"(the plain quantizer) bit for bit on the largest leaf per dtype {plain}; "
          f"peak memory {out['peak_bytes'] / 2**30:.2f} GiB")
    return out


def lm_grads(cfg, params, batch, backend: str) -> list:
    """lm_loss's gradient, one tensor per parameter leaf."""
    from repro_torch.core.pytree import tree_leaves, tree_unflatten
    from repro_torch.models.transformer import lm_loss
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = lm_loss(tree_unflatten(params, leaves), cfg, batch, backend=backend)
    return list(torch.autograd.grad(loss, leaves))


def grad_gaps(got, plain) -> list:
    """Per leaf: max |got - plain| / max |plain|."""
    return [float((g - p).abs().max()) / max(float(p.abs().max()), 1e-30)
            for g, p in zip(got, plain)]


def grads_with_zeroed(cfg, params, batch, which: int) -> list:
    """A control: lm_loss's gradient through the kernels with the
    backward's output ``which`` (0 dq, 1 dk, 2 dv) replaced by zeros."""
    from repro_torch.kernels import flash_attention as fa
    orig = fa.FlashAttention.backward

    def zeroed(ctx, dout):
        out = list(orig(ctx, dout))
        out[which] = torch.zeros_like(out[which])
        return tuple(out)

    fa.FlashAttention.backward = staticmethod(zeroed)
    try:
        return lm_grads(cfg, params, batch, "chunked")
    finally:
        fa.FlashAttention.backward = staticmethod(orig)


def phase_train_f32(launches: dict) -> dict:
    """17c: stablelm-1.6b at full width, depth 2, float32, from one state:
    lm_loss's gradient with the kernels (backend chunked: flash_attention
    forward writing the statistics, flash_attention_bwd backward reading
    them, three TF32 products per float32 product) against plain attention
    differentiated by autograd (backend xla), every leaf within
    TRAIN_GRAD_RTOL of its largest plain value, while a backward that
    zeroes dq, dk or dv fails that check (the control); then one round with
    compression off each way, every state leaf within TRAIN_F32_TOL."""
    from repro_torch.core.deploy import DeployFedLT
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ops
    cfg = train_config(n_layers=2, scan_repeats=2, dtype="float32")
    gen = torch.Generator(device=DEV).manual_seed(2)
    algs = {b: DeployFedLT(cfg=cfg, n_epochs=TRAIN_EPOCHS, gamma=0.02, rho=10.0,
                           compress=False, backend=b) for b in ("chunked", "xla")}
    state = algs["chunked"].init(TRAIN_AGENTS, generator=gen, device=DEV)
    batch = train_batch(cfg, 0)
    made = {}
    grad = check_train_grads(cfg, state.y_hat, {k: t[0] for k, t in batch.items()})
    new = {}
    for b, alg in algs.items():
        ops.reset_launch_counts()
        new[b], _ = alg.round_step(state, batch)
        made[b] = {k: v for k, v in ops.launch_counts().items() if v}
    for k, v in made["chunked"].items():
        launches[k] += v
    want = train_attention_launches(cfg, torch.float32)
    check(made == {"chunked": want, "xla": {}}, f"depth-2 float32 rounds launched {made}, "
          f"expected {want} with the kernels and none with plain attention")
    rtol, atol = TRAIN_F32_TOL
    worst_abs = worst_rel = 0.0
    for a, b in zip(tree_leaves(tuple(new["chunked"])[:5]), tree_leaves(tuple(new["xla"])[:5])):
        d = (a - b).abs()
        worst_abs = max(worst_abs, float(d.max()))
        worst_rel = max(worst_rel, float((d / b.abs().clamp(min=atol)).max()))
        check(torch.allclose(a, b, rtol=rtol, atol=atol), f"depth-2 float32 round: a "
              f"{tuple(a.shape)} leaf parts from plain attention's by {float(d.max())}")
    print(f"[train] {TRAIN_ARCH} at full width, depth 2, float32: one round with "
          f"compression off each way ({want}): every state leaf within rtol {rtol} / "
          f"atol {atol}; max abs diff {worst_abs:.3e}, max rel diff (over |plain| >= "
          f"{atol}) {worst_rel:.3e}")
    return dict(grad, max_abs_diff=worst_abs, max_rel_diff=worst_rel, launches=want)


def check_train_grads(cfg, params, one: dict) -> dict:
    """lm_loss's gradient at one agent's batch ``one`` with the kernels
    (backend chunked; float32: flash_attention forward writing the
    statistics, flash_attention_bwd backward reading them) against plain
    attention differentiated by autograd (backend xla), every leaf within
    TRAIN_GRAD_RTOL of its largest plain value, while a backward that
    zeroes dq, dk or dv fails that check (the control)."""
    from repro_torch.core.pytree import tree_flatten_with_names
    from repro_torch.kernels import ops
    names = tree_flatten_with_names(params)[0]
    grads, made = {}, {}
    for b in ("chunked", "xla"):
        ops.reset_launch_counts()
        grads[b] = lm_grads(cfg, params, one, b)
        made[b] = {k: v for k, v in ops.launch_counts().items() if v}
    fa_want = {k: v // (TRAIN_AGENTS * TRAIN_EPOCHS)
               for k, v in train_attention_launches(cfg, torch.float32).items()}
    check(made == {"chunked": fa_want, "xla": {}}, f"{cfg.name} float32 gradients launched "
          f"{made}, expected {fa_want} with the kernels and none with plain attention")
    gaps = grad_gaps(grads["chunked"], grads["xla"])
    del grads["chunked"]               # room for a control's gradients
    at = max(range(len(gaps)), key=gaps.__getitem__)
    check(max(gaps) <= TRAIN_GRAD_RTOL, f"{cfg.name} float32 gradient of {names[at]} "
          f"parts from plain attention's by {gaps[at]:.3e} of its largest value, over "
          f"{TRAIN_GRAD_RTOL}")
    controls = {}
    for which, label in enumerate(("dq", "dk", "dv")):
        g = grad_gaps(grads_with_zeroed(cfg, params, one, which), grads["xla"])
        i = max(range(len(g)), key=g.__getitem__)
        controls[label] = {"leaf": names[i], "gap": g[i]}
        check(g[i] > TRAIN_GRAD_RTOL, f"control with {label} zeroed passes the gradient "
              f"check (largest gap {g[i]:.3e} at {names[i]}): it cannot see a wrong "
              "backward")
        del g
    print(f"[train] {cfg.name}, {cfg.n_layers} layers, float32: lm_loss's gradient "
          f"with the kernels ({fa_want}) against plain attention (autograd, no launch): "
          f"largest gap per leaf {gaps[at]:.3e} of the leaf's largest value at "
          f"{names[at]} (limit {TRAIN_GRAD_RTOL}); controls with the backward's output "
          f"zeroed: " + ", ".join(f"{k} {v['gap']:.3e} at {v['leaf']}"
                                  for k, v in controls.items())
          + " (each over the limit: the check fails them)")
    return {"grad_gap": gaps[at], "grad_gap_leaf": names[at], "controls": controls,
            "grad_launches": fa_want}


def profile_train(state) -> None:
    """Where a training round's time goes: one more round from 17a's last
    state under torch.profiler (device busy share, time by kernel)."""
    cfg = train_config()
    from repro_torch.core.deploy import DeployFedLT
    alg = DeployFedLT(cfg=cfg, n_epochs=TRAIN_EPOCHS, gamma=0.02, rho=10.0)
    batch = train_batch(cfg, TRAIN_ROUNDS + 1)
    phase_profile(lambda: alg.round_step(state, batch), 1,
                  f"train {TRAIN_ARCH} bf16 round (2 agents x 2 x {TRAIN_SEQ})")


# -- phase 19: the MoE, Mamba2 and RWKV6 families -------------------------------

def family_config(arch: str, **changes):
    from repro_torch.configs import get
    return dataclasses.replace(get(arch), **changes)


def free_card() -> None:
    """Drop what the last model left on the card before the next one."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


class recording:
    """Within the block, record the arguments of ``module.name``'s calls
    with ``keep(*args, **kwargs)`` into ``calls`` (then restore it)."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep, self.calls = module, name, keep, []

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.calls.append(self.keep(out, *args, **kwargs))
            return out

        setattr(self.module, self.name, wrapper)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def attention_calls():
    """ops.attention's calls: (head dim, window, softcap) each."""
    from repro_torch.kernels import ops
    return recording(ops, "attention", lambda out, q, k, v, **kw: (
        q.shape[-1], kw.get("window"), kw.get("softcap")))


def route_calls():
    """models/moe.py's router calls: (probabilities, top-k indices) each."""
    from repro_torch.models import moe
    return recording(moe, "_route", lambda out, *a, **kw: (out[1].detach(), out[2]))


def layer_windows(cfg) -> list:
    """The windows of ``cfg``'s attention layers, each once (None: full)."""
    from repro_torch.models.transformer import ATTN_KINDS
    return sorted({cfg.sliding_window if k == "attn_local" else None
                   for k in cfg.scan_unit + cfg.tail if k in ATTN_KINDS},
                  key=lambda w: w or 0)


def serve_family(arch: str, changes: dict, batch: int, prompt: int, steps: int,
                 launches: dict) -> dict:
    """One family at full width in bf16 (random weights from a seeded
    generator on the card): a prefill of ``batch`` x ``prompt`` tokens
    through launch/serve.py's make_prefill_step (timed after a first one),
    then ``steps`` greedy decode steps: logits finite, the prefill's
    launches one flash_attention_sm90 per attention layer at the model's
    head dim (each layer's window, and the softcap, as configured) and
    nothing else, decode launching nothing.  A VLM's prompts are
    make_batch's layout: an extra_embeds prefix (vision_frac 0.25) before
    the text tokens, at the M-RoPE grid positions the batch carries.  Then
    flash_attention_sm90 at the prefill's shape against its plain version,
    row by row, at each window the layers use."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import ATTN_KINDS, init_params
    cfg = family_config(arch, **changes)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params, init_ms = sync_ms(lambda: init_params(cfg, generator=gen, device=DEV))
    n_params = sum(t.numel() for t in tree_leaves(params))
    if cfg.arch_type == "vlm":
        from repro_torch.data.synthetic import make_batch, seeded
        prompts = make_batch(cfg, seeded(0), batch, prompt, device=DEV)
        del prompts["labels"]
    else:
        prompts = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                           generator=gen, device=DEV)}
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    warm_ms = sync_ms(lambda: prefill(params, prompts)[0])[1]
    ops.reset_launch_counts()
    with attention_calls() as calls:
        (logits, cache), prefill_ms = sync_ms(lambda: prefill(params, prompts))
    counts_p = {k: v for k, v in ops.launch_counts().items() if v}
    n_attn = n_attention_layers(cfg)
    want = {"flash_attention_sm90": n_attn} if n_attn else {}
    check(counts_p == want, f"{arch} prefill launched {counts_p}, expected {want}")
    want_calls = [(cfg.head_dim, cfg.sliding_window if kind == "attn_local" else None,
                   cfg.attn_logit_softcap) for kind in
                  list(cfg.scan_unit) * cfg.scan_repeats + list(cfg.tail)
                  if kind in ATTN_KINDS]
    windows = layer_windows(cfg)
    window = windows[0] if len(windows) == 1 else windows
    check(calls == want_calls, f"{arch} prefill's attention calls {set(calls)}, expected "
          f"{n_attn} at head dim {cfg.head_dim}, windows {window} layer by layer, "
          f"softcap {cfg.attn_logit_softcap}")
    check(bool(torch.isfinite(logits).all()), f"{arch} prefill logits not finite")
    check(logits.shape == (batch, cfg.vocab_size) and cache["length"] == prompt,
          f"{arch} prefill: logits {tuple(logits.shape)}, cache length {cache['length']}")

    def run_decode():
        nonlocal logits, cache
        out = []
        for _ in range(steps):
            tok = logits.argmax(-1, keepdim=True)
            out.append(tok)
            logits, cache = decode(params, cache, tok)
        return torch.cat(out, dim=1)

    ops.reset_launch_counts()
    generated, decode_ms = sync_ms(run_decode)
    counts_d = {k: v for k, v in ops.launch_counts().items() if v}
    check(not counts_d, f"{arch} decode launched {counts_d}; it runs no kernel")
    check(bool(torch.isfinite(logits).all()), f"{arch} decode logits not finite")
    check(cache["length"] == prompt + steps, f"{arch} decode cache length")
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts_p.items():
        launches[k] += v
    out = dict(arch=arch, layers=cfg.n_layers, params=n_params, batch=batch, prompt=prompt,
               init_ms=init_ms, warm_prefill_ms=warm_ms, prefill_ms=prefill_ms,
               prefill_tok_s=batch * prompt / prefill_ms * 1e3,
               decode_ms_per_step=decode_ms / steps,
               decode_tok_s=batch * steps / decode_ms * 1e3, peak_bytes=peak,
               launches=counts_p, head_dim=cfg.head_dim)
    print(f"[families] serve {arch}, {cfg.n_layers} of {family_config(arch).n_layers} "
          f"layers, bf16: {n_params} parameters drawn on the card in {init_ms:.1f} ms; "
          f"prefill {batch} x {prompt}: {prefill_ms:.1f} ms ({out['prefill_tok_s']:.0f} "
          f"tokens/s; first {warm_ms:.1f} ms), launches {counts_p or 'none'} (head dim "
          f"{cfg.head_dim}, window {window}, softcap {cfg.attn_logit_softcap}); {steps} "
          f"greedy decode steps: {out['decode_ms_per_step']:.3f} ms per step "
          f"({out['decode_tok_s']:.1f} tokens/s), no launch; peak memory "
          f"{peak / 2**30:.2f} GiB; sample {generated[0, :8].tolist()}")
    del params, cache, logits, prompts
    free_card()
    if n_attn:
        out["max_abs_err_path"] = max(check_family_flash(cfg, batch, prompt, w)
                                      for w in windows)
    return out


def check_family_flash(cfg, batch: int, prompt: int, window) -> float:
    """flash_attention_sm90 at one family's prefill shape (``batch`` x
    ``prompt`` tokens, its heads, head dim, window and softcap; seeded
    bf16 inputs, q scaled so that the scores reach past the softcap)
    against its plain version one batch row at a time, as time_flash_sm90
    holds danube3's: one launch, each row within FLASH_TOL; max_abs_err."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    h, hkv, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.attn_logit_softcap
    q, k, v, pos = attention_inputs(batch, prompt, h, hkv, d, torch.bfloat16, 3)
    if cap:
        q = q * cap / 4            # scores of s.d. cap / 4: the cap bends the tail
    kw = dict(causal=True, window=window, softcap=cap)
    out, took = flash_route_call(fa, q, k, v, pos, pos, **kw)
    check(took == "flash_attention_sm90", f"{cfg.name}'s prefill shape ran {took}")
    what = (f"at {cfg.name}'s prefill shape B={batch} S={prompt} H={h}/{hkv} D={d} "
            f"W={window} softcap={cap} bf16")
    errs = [flash_check(out[i:i + 1], ref.flash_attention_ref(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], pos, pos, **kw), f"{what}, row {i}")
        for i in range(batch)]
    print(f"[families] flash_attention_sm90 {what}: each batch row within "
          f"{FLASH_TOL[torch.bfloat16][1]} + {FLASH_TOL[torch.bfloat16][0]:.4g} |plain| of "
          "the plain version, max_abs_err per row " + " ".join(f"{e:.3e}" for e in errs))
    del q, k, v, out
    free_card()
    return max(errs)


def route_flips(kernel, plain, group: int) -> tuple:
    """Rows whose top-k routes differ between two runs' router calls, each
    call's (probabilities, top-k) in order: every flip must be a tie, the
    swapped experts' probabilities in the plain run within ROUTE_TIE (the
    kernel's float32 rounding moved the hidden state, not a fault); returns
    (rows to leave out of the comparison, per call: the flipped rows and,
    under capacity dispatch, the rest of their group of ``group`` tokens,
    whose capacity slots a flipped route can move; the flips' count;
    the largest tie gap)."""
    check(len(kernel) == len(plain), f"router calls {len(kernel)} vs {len(plain)}")
    out, flips, worst = [], 0, 0.0
    for (_, ti_k), (p_pl, ti_pl) in zip(kernel, plain):
        k = ti_k.shape[-1]
        rows = (ti_k != ti_pl).any(dim=-1).nonzero().flatten()
        if rows.numel():
            srt = p_pl[rows].sort(dim=-1, descending=True).values
            gap = float((srt[:, :k] - srt[:, 1:k + 1]).min(dim=-1).values.max())
            check(gap <= ROUTE_TIE, f"a route flips between the kernel and plain "
                  f"attention at a probability gap of {gap:.3e} > {ROUTE_TIE}: not a "
                  "rounding tie")
            worst = max(worst, gap)
        flips += rows.numel()
        out.append(sorted({int(r) // group * group + i for r in rows.tolist()
                           for i in range(group)}))
    return out, flips, worst


def check_family_f32(arch: str, launches: dict, changes=None) -> dict:
    """One family at full width and a cut depth in float32 (``changes``,
    FAMILY_CHECK's by default):
    with the kernel (backend chunked: flash_attention, the float32 route)
    and with plain attention (backend xla), a prefill of 1 x
    FAMILY_CHECK_PROMPT tokens into a cache of prompt + FAMILY_CHECK_STEPS
    slots, then that many decode steps fed the next tokens of the same
    sequence: every logit row of both within relative L2 CHECK_REL_L2,
    row by row (rows left out where a route flips at a rounding tie,
    counted); for the recurrent families (Mamba2, RWKV6), each decode
    step's logits (the SSD or WKV recurrence) against a full forward over
    the whole sequence (their chunked scan), within CHECK_REL_L2.  A VLM's
    prompt is make_batch's layout (an extra_embeds prefix at M-RoPE grid
    positions, then text tokens), and its decode steps feed random tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models.moe import MOE_GROUP
    from repro_torch.models.transformer import forward, init_cache, init_params
    cfg = family_config(arch, **(FAMILY_CHECK[arch] if changes is None else changes),
                        dtype="float32")
    s, k = FAMILY_CHECK_PROMPT, FAMILY_CHECK_STEPS
    gen = torch.Generator(device=DEV).manual_seed(1)
    params = init_params(cfg, generator=gen, device=DEV)
    toks = torch.randint(0, cfg.vocab_size, (1, s + k), generator=gen, device=DEV)
    prompt = {"tokens": toks[:, :s]}
    if cfg.arch_type == "vlm":
        from repro_torch.data.synthetic import make_batch, seeded
        prompt = make_batch(cfg, seeded(1), 1, s, device=DEV)
        del prompt["labels"]
    n_attn = n_attention_layers(cfg)
    backends = ("chunked", "xla") if n_attn else ("chunked",)
    recurrent = bool({"mamba2", "rwkv6"} & set(cfg.scan_unit))
    runs, routes, made = {}, {}, {}
    for backend in backends:
        ops.reset_launch_counts()
        with route_calls() as rc, torch.no_grad():
            out = forward(params, cfg, prompt,
                          cache=init_cache(cfg, 1, s + k, device=DEV), backend=backend)
            rows, cache = [out.logits[0]], out.cache
            del out
            decode = make_decode_step(cfg, backend)
            for j in range(k):
                logits, cache = decode(params, cache, toks[:, s + j:s + j + 1])
                rows.append(logits)
            if recurrent:
                full = forward(params, cfg, {"tokens": toks}, backend=backend).logits[0]
        made[backend] = {n: v for n, v in ops.launch_counts().items() if v}
        runs[backend], routes[backend] = torch.cat(rows), rc
        del rows, cache
        if recurrent:
            step_err = max(rel_l2(runs[backend][s + j], full[s + j]) for j in range(k))
            check(step_err <= CHECK_REL_L2, f"{arch} float32, backend {backend}: decode "
                  f"steps vs the full forward's rows, rel L2 {step_err:.3e} > "
                  f"{CHECK_REL_L2}")
            runs[backend + "_step_err"] = step_err
            del full
    want = 2 if recurrent else 1
    expect = {"chunked": {"flash_attention": want * n_attn} if n_attn else {}, "xla": {}}
    check(made == {b: expect[b] for b in backends}, f"{arch} float32 launched {made}, "
          f"expected {expect}")
    for n, v in made["chunked"].items():
        launches[n] += v
    out = {"arch": arch, "layers": cfg.n_layers, "launches": made["chunked"]}
    check(all(bool(torch.isfinite(r).all()) for r in (runs[b] for b in backends)),
          f"{arch} float32 logits not finite")
    if n_attn:
        keep = torch.ones(s + k, dtype=torch.bool, device=DEV)
        flips = worst = 0
        if cfg.n_experts:
            group = min(MOE_GROUP, s) if cfg.moe_dispatch == "capacity" else 1
            left_out, flips, worst = route_flips(routes["chunked"], routes["xla"], group)
            n_calls = len(left_out) // (k + 1)       # router calls per forward
            for c, rws in enumerate(left_out):
                pos = torch.tensor(rws, dtype=torch.long, device=DEV)
                if c < n_calls:                      # the prefill: row = position
                    keep[pos[pos < s]] = False
                elif rws:                            # a decode step's one row
                    keep[s + (c - n_calls) // n_calls] = False
        err = max_row_rel_l2(runs["chunked"][keep], runs["xla"][keep])
        check(err <= CHECK_REL_L2, f"{arch} float32: kernel vs plain attention logits "
              f"rel L2 {err:.3e} > {CHECK_REL_L2}")
        out.update(rel_l2=err, route_flips=flips, rows_left_out=int((~keep).sum()),
                   worst_tie_gap=worst)
    if recurrent:
        out["decode_vs_full_rel_l2"] = max(runs[b + "_step_err"] for b in backends)
    print(f"[families] {arch}, {cfg.n_layers} layers at full width, float32, prefill 1 x "
          f"{s} + {k} decode steps: "
          + (f"kernel ({made['chunked']}) vs plain attention (none): every logit row "
             f"within rel L2 {out['rel_l2']:.3e} <= {CHECK_REL_L2}"
             + (f", {out['route_flips']} route flips at rounding ties (largest gap "
                f"{out['worst_tie_gap']:.2e} <= {ROUTE_TIE}), {out['rows_left_out']} rows "
                "left out" if cfg.n_experts else "") + "; " if n_attn else "no launch; ")
          + (f"decode steps (the recurrence) vs a full forward over {s + k} tokens (the "
             f"chunked scan): rel L2 {out['decode_vs_full_rel_l2']:.3e} <= "
             f"{CHECK_REL_L2}" if recurrent else "no recurrence to hold against the scan"))
    del params, runs, routes
    free_card()
    return out


def train_family(arch: str, changes: dict, gamma: float, launches: dict,
                 packed: bool = False) -> dict:
    """DeployFedLT on one family at full width in bf16 (the launcher's
    settings and batches but γ: TRAIN_AGENTS agents x TRAIN_BATCH x
    TRAIN_SEQ, TRAIN_EPOCHS epochs, ρ 10, L=255, FAMILY_TRAIN_ROUNDS
    rounds): every loss finite and the last below the first, each round's
    launches the attention layers' (train_attention_launches) and the
    wire's (quant_launches) and nothing else, round 0's quantized state the
    old route's on one leaf per dtype (check_quant_plain); with ``packed``,
    then one packed round from the last state, checked as 17b.  Returns the
    summary."""
    from repro_torch.core.deploy import DeployFedLT
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ops
    cfg = family_config(arch, **changes)
    alg = DeployFedLT(cfg=cfg, n_epochs=TRAIN_EPOCHS, gamma=gamma, rho=10.0)
    torch.cuda.reset_peak_memory_stats()
    state = alg.init(TRAIN_AGENTS, generator=torch.Generator(device=DEV).manual_seed(0),
                     device=DEV)
    n_params = sum(x.numel() for x in tree_leaves(state.y_hat))
    want = dict(train_attention_launches(cfg, torch.bfloat16),
                **quant_launches(alg, TRAIN_AGENTS))
    losses, ms = [], []
    for r in range(FAMILY_TRAIN_ROUNDS):
        batch = train_batch(cfg, r)
        held = hold_quant_leaves(state) if r == 0 else None
        ops.reset_launch_counts()                # the main path: one round
        (state, metrics), t = sync_ms(lambda: alg.round_step(state, batch))
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        check(counts == want, f"{arch} training round {r} launched {counts}, "
              f"expected {want}")
        if held is not None:
            plain = check_quant_plain(alg, held, state, f"{arch} training round 0")
            del held
        for k, v in counts.items():
            launches[k] += v
        losses.append(float(metrics["loss"]))
        ms.append(t)
        del batch, metrics
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{arch} training losses {losses}: not finite, or the last not below the first")
    out = dict(arch=arch, layers=cfg.n_layers, params=n_params, gamma=gamma,
               losses=losses, ms_per_round=ms, launches_per_round=want, peak_bytes=peak,
               plain_route_leaves=plain)
    print(f"[families] train {arch}, {cfg.n_layers} of {family_config(arch).n_layers} "
          f"layers, bf16, {n_params} parameters, {TRAIN_AGENTS} agents x batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_EPOCHS} epochs a round, γ {gamma}: "
          "losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; ms per round "
          + ", ".join(f"{x:.1f}" for x in ms) + f"; launches per round {want or 'none'}; "
          f"round 0's c_up, ŷ and c_down equal to the old route's (the plain quantizer) "
          f"bit for bit on the largest leaf per dtype {plain}; "
          f"peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    if packed:       # the old state goes with the round but its EF caches
        c_up = state.c_up
        alg, state, res = packed_round(state, launches, cfg)
        out["packed"] = check_packed_round(alg, state, c_up, res)
    return out


#: rwkv6-3b at 16 layers at the launcher's γ: (width, dtype, sequence);
#: 1792 is the widest whose float32 state and round fit the card (two
#: states of 8 model copies)
RWKV_GAMMA_RUNS = ((512, "float32", 256), (512, "float32", 2048),
                   (1024, "float32", 256), (1024, "bfloat16", 2048),
                   (1024, "float32", 2048), (1792, "bfloat16", 2048),
                   (1792, "float32", 2048), (2560, "bfloat16", 2048))


def rwkv6_gamma_curves(gamma: float = 0.02) -> dict:
    """``python3 chip_smoke.py --rwkv6-gamma``: rwkv6-3b at 16 of 32 layers
    through DeployFedLT at ``gamma`` as phase 19e runs it (2 agents x
    batch 2, TRAIN_EPOCHS epochs, ρ 10, FAMILY_TRAIN_ROUNDS rounds) at each
    (width, dtype, sequence) of RWKV_GAMMA_RUNS, d_ff scaled with the
    width: each run's losses, printed and returned, not gated."""
    from repro_torch.core.deploy import DeployFedLT
    out = {}
    for width, dtype, seq in RWKV_GAMMA_RUNS:
        base = family_config("rwkv6-3b")
        cfg = dataclasses.replace(base, n_layers=16, scan_repeats=16, d_model=width,
                                  d_ff=base.d_ff * width // base.d_model, dtype=dtype)
        alg = DeployFedLT(cfg=cfg, n_epochs=TRAIN_EPOCHS, gamma=gamma, rho=10.0)
        state = alg.init(TRAIN_AGENTS, generator=torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
        losses = []
        for r in range(FAMILY_TRAIN_ROUNDS):
            state, metrics = alg.round_step(state, train_batch(cfg, r, seq))
            losses.append(float(metrics["loss"]))
        out[f"{width} {dtype} {seq}"] = losses
        print(f"[rwkv6-gamma] rwkv6-3b, 16 layers, width {width}, {dtype}, seq {seq}, "
              f"γ {gamma}: "
              "losses " + ", ".join(f"{x:.6f}" for x in losses), flush=True)
        del state, metrics
        free_card()
    return out


def family_grad(arch: str, changes: dict) -> dict:
    """check_train_grads for ``arch`` at full width, the depth ``changes``
    give and float32 (weights from seed 2), at agent 0's batch of the
    first round."""
    from repro_torch.models.transformer import init_params
    cfg = family_config(arch, **changes, dtype="float32")
    params = init_params(cfg, generator=torch.Generator(device=DEV).manual_seed(2),
                         device=DEV)
    batch = train_batch(cfg, 0)
    out = check_train_grads(cfg, params, {k: t[0] for k, t in batch.items()})
    del params, batch
    free_card()
    return out


def phase_families(launches: dict) -> dict:
    """19: serve mixtral-8x7b (depth 8), zamba2-2.7b, rwkv6-3b and grok-1-314b
    (depth 1) at full width in bf16, hold mixtral, zamba2 and rwkv6 at a cut
    depth in float32 (kernel vs plain attention, decode's recurrence vs the
    chunked scan), then train mixtral (depth 1), zamba2 and rwkv6 (depth 16)
    through DeployFedLT, one packed mixtral round, and zamba2's float32
    gradient through the kernels.  Counts are zeroed before each run."""
    out = {"serve": {}, "f32": {}, "train": {}}
    for arch, changes, batch, prompt, steps in FAMILY_SERVE:
        out["serve"][arch] = serve_family(arch, changes, batch, prompt, steps, launches)
        if arch in FAMILY_CHECK:
            out["f32"][arch] = check_family_f32(arch, launches)
        lap(f"19 {arch}")
    for arch, changes, gamma in FAMILY_TRAIN:
        out["train"][arch] = train_family(arch, changes, gamma, launches,
                                          packed=arch == "mixtral-8x7b")
        free_card()
        lap(f"19e train {arch}")
    out["train"]["zamba2-2.7b"]["f32_grad"] = family_grad("zamba2-2.7b",
                                                          FAMILY_CHECK["zamba2-2.7b"])
    lap("19e train zamba2-2.7b")
    return out


# -- phase 21: the last four catalog architectures ------------------------------

#: serving at full width in bf16 (serve_family): (arch, depth changes,
#: prompts, prompt, decode steps), every layer; gemma3-27b at 1 x 8192 (27.0 B
#: parameters, 54 GB: 4 x 8192 would add 17.2 GB of (B, S, vocab) logits);
#: qwen2-vl-7b's prompts are make_batch's VLM layout (2048 of the 8192
#: positions an extra_embeds prefix at M-RoPE grid positions)
CATALOG_SERVE = (
    ("gemma3-27b", {}, 1, 8192, 4),
    ("granite-20b", {}, 4, 8192, 32),
    ("qwen2-vl-7b", {}, 4, 8192, 32),
    ("musicgen-large", {}, 4, 8192, 32),
)
#: their float32 checks at full width (check_family_f32): gemma3 at one
#: unit of its stack (five local layers, then the global one), the others at 2
CATALOG_CHECK = {"gemma3-27b": dict(n_layers=6, scan_repeats=1, tail=()),
                 "granite-20b": dict(n_layers=2, scan_repeats=2),
                 "qwen2-vl-7b": dict(n_layers=2, scan_repeats=2),
                 "musicgen-large": dict(n_layers=2, scan_repeats=2)}
#: training through DeployFedLT as phase 19e (train_family), each cut from
#: the top of the catalog's stack to about 1.6-1.8 B parameters (a round
#: holds ~34 B a parameter: stablelm's 45.66 GiB for 1.439 B): (arch, depth
#: changes, γ); granite-20b at 3 of 52 layers, then a packed round (as 17b),
#: qwen2-vl-7b at 3 of 28 on the VLM batch, musicgen-large at 32 of 48,
#: gemma3-27b at its first layer (local; its 262,144-token table is 1.41 B,
#: with two agents one leaf of 2.82e9 values), then a packed round (as 17b)
CATALOG_TRAIN = (("granite-20b", dict(n_layers=3, scan_repeats=3), 0.02),
                 ("qwen2-vl-7b", dict(n_layers=3, scan_repeats=3), 0.02),
                 ("musicgen-large", dict(n_layers=32, scan_repeats=32), 0.02),
                 ("gemma3-27b", dict(n_layers=1, scan_unit=("attn_local",),
                                     scan_repeats=1, tail=()), 0.02))
#: the archs of CATALOG_TRAIN that end with a packed round
CATALOG_PACKED = ("granite-20b", "gemma3-27b")
#: the attention kernels at the training path's shape of the archs whose
#: heads or window no other phase runs (GQA groups 2, 48 and 7; gemma3's
#: window 1024 and its global layers): TRAIN_BATCH x TRAIN_SEQ
CATALOG_BWD = ("gemma3-27b", "granite-20b", "qwen2-vl-7b")
# the float32 backward's worst dK error at granite-20b's MQA training shape,
# half of FLASH_BWD_TOL's 1e-4 (unless the float32 plain version is itself
# further than this from a float64 one: then the kernel is held to the plain
# version's own error against float64 plus 1e-5)
F32_MQA_DK_TOL = 5e-5


def check_catalog_bwd(arch: str, errors: dict) -> dict:
    """The forward with the backward's statistics and the backward at
    ``arch``'s training shape (TRAIN_BATCH x TRAIN_SEQ, its heads and head
    dim, causal, at each of its windows) on both routes (bf16:
    flash_attention_sm90 then flash_attention_bwd_sm90; float32:
    flash_attention then flash_attention_bwd), each one launch, held
    against the plain versions one batch row at a time (FLASH_TOL,
    FLASH_BWD_TOL), a second backward call equal bit for bit; the worst
    errors are folded into ``errors``.  In float32 also each row's dK
    against a float64 plain version (bench/attention_bwd.py dk_f64), the
    kernel's and the float32 plain version's; an MQA group is held to
    F32_MQA_DK_TOL."""
    from repro_torch.bench.attention_bwd import dk_f64
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    cfg = family_config(arch)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {}
    for w in layer_windows(cfg):
        for dtype in FLASH_BWD_TOL:
            q, k, v, pos = attention_inputs(TRAIN_BATCH, TRAIN_SEQ, h, hkv, d, dtype, 7)
            do = torch.randn(q.shape, generator=torch.Generator(device=DEV).manual_seed(8),
                             device=DEV).to(dtype)
            kw = dict(causal=True, window=w)
            what = (f"at {arch}'s training shape B={TRAIN_BATCH} S={TRAIN_SEQ} H={h}/{hkv} "
                    f"D={d} W={w} {str(dtype)[6:]}")
            fwd, bwd = fa.route(dtype, DEV), fa.bwd_route(dtype, DEV)
            (o, lse, o32), made = launched(lambda: fa._forward(q, k, v, pos, pos, True, w,
                                                               None, stats=True))
            check(made == {fwd: 1}, f"{fwd} {what} launched {made}")
            grads, made = launched(lambda: fa.flash_attention_bwd(
                q, k, v, do, pos, pos, stats=(lse, o32), **kw))
            check(made == {bwd: 1}, f"{bwd} {what} launched {made}")
            again = fa.flash_attention_bwd(q, k, v, do, pos, pos, stats=(lse, o32), **kw)
            check(all(same_bits(a, b) for a, b in zip(grads, again)),
                  f"{bwd} {what}: two calls differ")
            del again
            e_f = e_b = 0.0
            dk = {"plain": 0.0, "kernel_f64": 0.0, "plain_f64": 0.0}
            for i in range(TRAIN_BATCH):
                row = lambda t: t[i:i + 1]
                e_f = max(e_f, flash_check(row(o), ref.flash_attention_ref(
                    row(q), row(k), row(v), pos, pos, **kw), f"{fwd} {what}, row {i}"))
                plain = ref.flash_attention_bwd_ref(row(q), row(k), row(v), row(do), pos,
                                                    pos, **kw)
                e_b = max(e_b, flash_bwd_check(tuple(row(g) for g in grads), plain,
                                               f"{what}, row {i}"))
                if dtype == torch.float32:
                    dk64 = dk_f64(row(q), row(k), row(v), row(do), pos, w)
                    for key, a, b in (("plain", row(grads[1]), plain[1]),
                                      ("kernel_f64", row(grads[1]).double(), dk64),
                                      ("plain_f64", plain[1].double(), dk64)):
                        dk[key] = max(dk[key], float((a - b).abs().max()))
                    del dk64
                del plain
            errors[fwd], errors[bwd] = max(errors[fwd], e_f), max(errors[bwd], e_b)
            out[f"{w} {str(dtype)[6:]}"] = {"forward": e_f, "backward": e_b}
            print(f"[catalog] {fwd} (with the statistics) and {bwd} {what}: each batch "
                  f"row within tolerance of the plain versions, max_abs_err {e_f:.3e} "
                  f"(forward), {e_b:.3e} (dq, dk, dv); two backward calls equal bit for bit")
            if dtype == torch.float32:
                out[f"{w} {str(dtype)[6:]}"]["dk"] = dk
                n_split = len(fa.f32_bwd_head_slices(h // hkv, TRAIN_SEQ))
                mqa_ok = dk["plain"] <= F32_MQA_DK_TOL or (
                    dk["plain_f64"] > F32_MQA_DK_TOL
                    and dk["kernel_f64"] <= dk["plain_f64"] + 1e-5)
                check(hkv > 1 or mqa_ok,
                      f"{bwd} {what}: worst dK error {dk['plain']:.3e} over "
                      f"{F32_MQA_DK_TOL} (against float64: kernel {dk['kernel_f64']:.3e}, "
                      f"float32 plain {dk['plain_f64']:.3e})")
                print(f"[catalog] {bwd} {what}: group {h // hkv} in {n_split} dK/dV "
                      f"slice(s); worst dK error {dk['plain']:.3e} against the float32 "
                      f"plain version ({FLASH_BWD_TOL[dtype][1] / max(dk['plain'], 1e-30):.2f}"
                      f" times within the check's {FLASH_BWD_TOL[dtype][1]}"
                      + (f", MQA held to {F32_MQA_DK_TOL}" if hkv == 1 else "")
                      + f"); against a float64 plain version: kernel {dk['kernel_f64']:.3e},"
                      f" float32 plain {dk['plain_f64']:.3e}")
            del q, k, v, do, o, lse, o32, grads
    free_card()
    return out


def time_catalog_attention() -> dict:
    """CUDA-event times (least of two runs of time_ms) of the attention
    kernels at the new shapes beside their bounds (attention_work's for the
    forward; the backward's as time_flash_bwd counts it: five S^2 D
    products from the saved statistics at the dtype's peak): the bf16
    forward at each arch's prefill shape and window, the bf16 and float32
    backward at the training shape (float32: with its dK/dV grid's block
    count), and, at granite-20b's MQA training shape in both dtypes, the
    backward of torch.nn.functional.scaled_dot_product_attention
    (enable_gqa, is_causal; timed only, the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for arch, _, b, s, _ in CATALOG_SERVE:
        cfg = family_config(arch)
        h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v, pos = attention_inputs(b, s, h, hkv, d, torch.bfloat16, 2)
        for w in layer_windows(cfg):
            pairs, flops, nbytes, b_ms, b_by = attention_work(q, k, v, pos, w,
                                                              BF16_OPS_PER_S)
            runs = [time_ms(lambda: fa.flash_attention(q, k, v, window=w), 5, 2)
                    for _ in range(2)]
            ms = min(runs)
            out[f"{arch} forward W={w}"] = rec = dict(
                kernel="flash_attention_sm90", shape=[b, s, h, hkv, d], window=w, ms=ms,
                ms_runs=runs, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                tflops=flops / ms / 1e9)
            print(f"[catalog] flash_attention_sm90 at {arch}'s prefill shape B={b} S={s} "
                  f"H={h}/{hkv} D={d} W={w} bf16: {ms:.3f} ms (runs "
                  + ", ".join(f"{x:.3f}" for x in runs) + f"), {rec['tflops']:.1f} "
                  f"TFLOP/s, {100 * rec['bound_share']:.1f}% of the bound {b_ms:.4f} ms "
                  f"by {b_by}")
        del q, k, v
        free_card()
    for arch in CATALOG_BWD:
        cfg = family_config(arch)
        h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for dtype in FLASH_BWD_TOL:
            q, k, v, pos = attention_inputs(TRAIN_BATCH, TRAIN_SEQ, h, hkv, d, dtype, 6)
            do = torch.randn(q.shape, device=DEV).to(dtype)
            for w in layer_windows(cfg):
                stats = fa._forward(q, k, v, pos, pos, True, w, None, stats=True)[1:]
                fns = {"kern": lambda: fa.flash_attention_bwd(q, k, v, do, pos, pos,
                                                              window=w, stats=stats)}
                iters = {"kern": 5}
                mqa = hkv == 1 and w is None
                if mqa:
                    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                                  for x in (q, k, v))
                    out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                           enable_gqa=True)
                    do_t = do.transpose(1, 2)
                    fns["sdpa"] = lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                                              retain_graph=True)
                    iters["sdpa"] = 5
                runs = time_turns(fns, iters)
                ms = min(runs["kern"])
                pairs, fwd_flops, _, _, _ = attention_work(q, k, v, pos, w, BF16_OPS_PER_S)
                flops = 5 * fwd_flops // 2          # five S^2 D products, 2 D flops each
                nbytes = (q.element_size() * (3 * q.numel() + 2 * k.numel() + 2 * v.numel())
                          + sum(x.numel() * x.element_size() for x in stats))
                peak = (BF16_OPS_PER_S if dtype == torch.bfloat16
                        else TF32_OPS_PER_S / TF32_TERMS)
                b_ms, b_by = bound(nbytes, flops, peak)
                rec = dict(kernel=fa.bwd_route(dtype, DEV),
                           shape=[TRAIN_BATCH, TRAIN_SEQ, h, hkv, d], window=w,
                           dtype=str(dtype)[6:], ms=ms, ms_runs=runs["kern"],
                           bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                           tflops=flops / ms / 1e9)
                if dtype == torch.float32:
                    rec["dkdv_blocks"] = (TRAIN_BATCH * hkv * -(-TRAIN_SEQ // fa.BWD_BLOCK_K)
                                          * len(fa.f32_bwd_head_slices(h // hkv, TRAIN_SEQ)))
                if mqa:
                    rec.update(library_ms=min(runs["sdpa"]), library_ms_runs=runs["sdpa"],
                               library="scaled_dot_product_attention backward "
                                       "(enable_gqa)",
                               library_kernel=library_kernel_name(fns["sdpa"]))
                    del qt, kt, vt, out_t, do_t
                out[f"{arch} backward W={w} {rec['dtype']}"] = rec
                print(f"[catalog] {rec['kernel']} at {arch}'s training shape "
                      f"B={TRAIN_BATCH} S={TRAIN_SEQ} H={h}/{hkv} D={d} W={w} "
                      f"{rec['dtype']}: {ms:.3f} ms (runs "
                      + ", ".join(f"{x:.3f}" for x in runs["kern"]) + f"), "
                      f"{rec['tflops']:.1f} TFLOP/s, {100 * rec['bound_share']:.1f}% of "
                      f"the bound {b_ms:.4f} ms by {b_by}"
                      + (f"; {rec['dkdv_blocks']} blocks in the dK/dV grid"
                         if "dkdv_blocks" in rec else "")
                      + (f"; scaled_dot_product_attention's backward (enable_gqa) "
                         f"{rec['library_ms']:.3f} ms (runs "
                         + ", ".join(f"{x:.3f}" for x in runs["sdpa"])
                         + f"; longest device kernel: {rec['library_kernel']})"
                         if mqa else ""))
                del stats
            del q, k, v, do
            free_card()
    return out


def run_examples() -> dict:
    """The two examples ported in this slice, on the card: serve_lm's main
    for each arch of CATALOG_SERVE (its smoke variant, plain attention as
    the reference's ``backend="xla"``: no kernel launch) and quickstart's
    main whole (400 rounds each way), its traces under build/quickstart:
    every traced bytes_up the quantizer's (1250 B a round), and the run with
    error feedback ending below the run without it."""
    from repro_torch.configs import smoke_variant
    from repro_torch.examples import quickstart, serve_lm
    out = {}
    for arch, *_ in CATALOG_SERVE:
        (gen, made), ms = sync_ms(lambda: launched(lambda: serve_lm.main(
            ["--arch", arch], device=DEV)))
        vocab = smoke_variant(family_config(arch)).vocab_size
        check(tuple(gen.shape) == (4, 16) and 0 <= int(gen.min()) <= int(gen.max()) < vocab
              and not made, f"serve_lm --arch {arch}: tokens {tuple(gen.shape)} in "
              f"[{int(gen.min())}, {int(gen.max())}], launches {made}")
        out[f"serve_lm {arch}"] = {"ms": ms, "sample": gen[0].tolist()}
    runs, ms = sync_ms(lambda: quickstart.main(device=DEV,
                                               out_dir=str(BUILD / "quickstart")))
    end = {}
    for name, records in runs.items():
        rounds = [r for r in records if r.get("kind") == "fl_round"]
        check([r["bytes_up"] for r in rounds] == [1250 * (r["round"] + 1) for r in rounds]
              and rounds[-1]["round"] == 399 and all(math.isfinite(r["error"])
                                                    for r in rounds),
              f"quickstart {name}: traced rounds {rounds}")
        end[name] = rounds[-1]["error"]
    check(end["alg2_ef"] < end["alg1_no_ef"], f"quickstart: the EF run ends at "
          f"{end['alg2_ef']}, not below the no-EF run's {end['alg1_no_ef']}")
    out["quickstart"] = {"s": ms / 1e3, "end_error": end}
    print(f"[catalog] examples: serve_lm on the four archs' smoke variants ("
          + ", ".join(f"{a.split()[1]} {r['ms']:.0f} ms" for a, r in out.items()
                      if a.startswith("serve_lm"))
          + f"); quickstart {ms / 1e3:.1f} s, final error with EF {end['alg2_ef']:.6f} "
          f"below without {end['alg1_no_ef']:.6f}, bytes_up 1250 B a round")
    return out


def phase_catalog(launches: dict, errors: dict) -> dict:
    """21: serve gemma3-27b, granite-20b, qwen2-vl-7b and musicgen-large at
    full width and depth in bf16 and hold them at a cut depth in float32
    (kernel vs plain attention), train each through DeployFedLT at a cut
    depth (one packed round each of granite and gemma3, whose tied table
    passes 2**31 values), gemma3's float32 gradient through
    the kernels at one unit, the attention kernels at the new head groups
    and window, and the quickstart and serve_lm examples.  Counts are
    zeroed before each run."""
    out = {"serve": {}, "f32": {}, "train": {}}
    for arch, changes, batch, prompt, steps in CATALOG_SERVE:
        out["serve"][arch] = rec = serve_family(arch, changes, batch, prompt, steps,
                                                launches)
        errors["flash_attention_sm90"] = max(errors["flash_attention_sm90"],
                                             rec["max_abs_err_path"])
        out["f32"][arch] = check_family_f32(arch, launches, CATALOG_CHECK[arch])
        lap(f"21 {arch}")
    for arch, changes, gamma in CATALOG_TRAIN:
        out["train"][arch] = rec = train_family(arch, changes, gamma, launches,
                                                packed=arch in CATALOG_PACKED)
        if arch in CATALOG_PACKED:
            p = rec["packed"]
            print(f"[catalog] {arch} packed round: {p['ms']:.1f} ms, peak "
                  f"{p['peak_bytes'] / 2**30:.2f} GiB (max_memory_allocated) beside its "
                  f"unpacked rounds' {rec['peak_bytes'] / 2**30:.2f} GiB, largest leaf "
                  f"{p['largest_leaf']} values, launches {p['launches']}")
        free_card()
        lap(f"21 train {arch}")
    # the global layer and its RoPE table train only here: one unit of the
    # stack (five local layers, then the global one)
    out["train"]["gemma3-27b"]["f32_grad"] = family_grad("gemma3-27b",
                                                         CATALOG_CHECK["gemma3-27b"])
    lap("21 train gemma3-27b")
    out["kernels"] = {arch: check_catalog_bwd(arch, errors) for arch in CATALOG_BWD}
    out["times"] = time_catalog_attention()
    lap("21 kernels")
    out["examples"] = run_examples()
    lap("21 examples")
    return out


# -- phase 22: the JAX package's configurations that run nowhere else ----------

def kv_int8_rel_l2(head_dim: int) -> float:
    """22a's limit on a decode logit row's relative L2 against the bf16
    cache's, derived before the first run (PERF.md §2): a cached element is
    off by at most half its code step, max|row|/254, so a cached vector of
    ``head_dim`` values by at most sqrt(head_dim)/254 of its norm; a row is
    held to that twice over (once through the keys, once through the
    values)."""
    return 2 * math.sqrt(head_dim) / 254


# 22b: the dry-run's prefill_32k / decode_32k length at batch 1, and the
# rows of each block held against the plain version
LONG_ARCHS = ("stablelm-1.6b", "h2o-danube-3-4b")
LONG_PROMPT, LONG_STEPS, LONG_BLOCK = 32768, 32, 1024
# 22c: agent 1 misses the round's deadline; the float32 card-vs-CPU round
# at depth 2 takes 1 x 128 tokens an agent (the CPU trains it too)
QUORUM = [True, False]
QUORUM_F32_BATCH, QUORUM_F32_SEQ = 1, 128
# a quantized leaf may part from the CPU's by one level, where the level's
# input lies within QUORUM_TIE·Δ of a half-level boundary
QUORUM_TIE = 1e-4
# 22d: checkpoint groups of 4 of stablelm-1.6b's 24 scan units
REMAT_GROUP = 4
# 22e: the federated-LM example's presets and rounds
FEDLM_ROUNDS = {"100m": 5, "smoke": 3}
FEDLM_RTOL = 1e-4


def cache_bytes(cache) -> int:
    """Bytes of a serving cache's buffers (codes, scales and positions)."""
    from repro_torch.core.pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache)
               if isinstance(t, torch.Tensor))


def nonzero_counts() -> dict:
    from repro_torch.kernels import ops
    return {k: v for k, v in ops.launch_counts().items() if v}


def within(a, b, rtol: float, atol: float) -> tuple:
    """(|a - b| <= atol + rtol |b| everywhere, max |a - b|), on b's device,
    in float32 or b's wider dtype."""
    dt = torch.promote_types(b.dtype, torch.float32)
    a, b = a.to(b.device, dt), b.to(dt)
    d = (a - b).abs()
    return bool((d <= atol + rtol * b.abs()).all()), float(d.max()) if d.numel() else 0.0


def row_rel_l2(a, b) -> torch.Tensor:
    a, b = a.double(), b.double()
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


def serve_greedy(params, cfg, cache, logits, steps: int, tokens=None):
    """``steps`` decode steps from a prefill's (logits, cache): greedy, or
    fed ``tokens`` (B, steps).  (each step's logits, the tokens fed, the
    cache, ms per step)."""
    from repro_torch.launch.serve import make_decode_step
    decode = make_decode_step(cfg)
    fed, outs = [], []

    def run():
        nonlocal logits, cache
        for i in range(steps):
            tok = logits.argmax(-1, keepdim=True) if tokens is None else tokens[:, i:i + 1]
            fed.append(tok)
            logits, cache = decode(params, cache, tok)
            outs.append(logits)

    _, ms = sync_ms(run)
    return outs, torch.cat(fed, dim=1), cache, ms / steps


def phase_kv_int8(launches: dict) -> dict:
    """22a: danube3 at full width and depth in bf16, 4 x 8192 prompt tokens
    and 32 decode steps, with the bf16 cache and with the int8 one
    (``kv_cache_int8``).  The prompt is longer than the 4096-slot ring, so
    prefill attends the fresh keys: its logits must equal the bf16 route's
    bit for bit, each route one flash_attention_sm90 launch per layer.  The
    ring's int8 codes and float32 scales of the first and last layers must
    equal ``_kv_quant`` run on the CPU on the bf16 route's cached K and V,
    bit for bit.  Decode, fed the bf16 route's greedy tokens, launches
    nothing; every logit row within kv_int8_rel_l2(D) of the bf16 route's.
    Each route's prefill and decode run with only its own ring on the card,
    so each peak is that route's.
    Then the depth-2 float32 model, card against CPU (check_kv_int8_f32)."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.attention import _kv_quant
    from repro_torch.models.transformer import init_params
    cfgs = {"bf16": serve_config(), "int8": serve_config(kv_cache_int8=True)}
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(cfgs["bf16"], generator=gen, device=DEV)
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompts = {"tokens": torch.randint(0, cfgs["bf16"].vocab_size,
                                       (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                                       device=DEV)}
    n_layers, last = cfgs["bf16"].n_layers, cfgs["bf16"].scan_repeats - 1
    runs, codes = {}, []
    for name, cfg in cfgs.items():   # one route's ring on the card at a time
        prefill = make_prefill_step(cfg)
        free_card()
        torch.cuda.reset_peak_memory_stats()
        sync_ms(lambda: prefill(params, prompts))       # the first, untimed
        ops.reset_launch_counts()            # the main path: the timed prefill
        (logits, cache), prefill_ms = sync_ms(lambda: prefill(params, prompts))
        counts = nonzero_counts()
        check(counts == {"flash_attention_sm90": n_layers}, f"{name}-cache prefill "
              f"launched {counts}, expected {n_layers} flash_attention_sm90")
        if name == "int8":
            for k, v in counts.items():
                launches[k] += v
        check(bool(torch.isfinite(logits).all()), f"{name}-cache prefill logits not finite")
        slot = cache["scan"][0]
        if name == "bf16":           # the cached K/V that the int8 ring quantizes,
            kv = {(r, n): getattr(slot, n)[r].to("cpu", copy=True)   # before decode
                  for r in (0, last) for n in ("k", "v")}
            pos = slot.pos.clone()
        else:
            check(same_bits(logits, runs["bf16"]["logits"]), "int8-cache prefill logits "
                  "differ from the bf16-cache route's: prefill past the ring attends the "
                  "fresh K/V in both")
            check(same_bits(slot.pos, pos), "the rings' slot positions differ")
            for (r, n), x in kv.items():
                want_q, want_s = _kv_quant(x)
                got_q, got_s = getattr(slot, n)[r].cpu(), getattr(slot, f"{n}_scale")[r].cpu()
                check(same_bits(got_q, want_q) and same_bits(got_s, want_s),
                      f"layer {r} {n}: the card's int8 codes or scales differ from "
                      f"_kv_quant on the CPU ({int((got_q != want_q).sum())} codes, "
                      f"{int((got_s != want_s).sum())} scales)")
                codes.append(got_q.numel())
        ring_bytes = cache_bytes(cache)
        del slot
        ops.reset_launch_counts()        # the main path: decode
        tokens = None if name == "bf16" else runs["bf16"]["fed"]
        outs, fed, cache, ms = serve_greedy(params, cfg, cache, logits, SERVE_STEPS, tokens)
        check(not nonzero_counts(), f"{name}-cache decode launched {nonzero_counts()}")
        check(all(bool(torch.isfinite(x).all()) for x in outs),
              f"{name}-cache decode logits not finite")
        runs[name] = dict(logits=logits, prefill_ms=prefill_ms, ring_bytes=ring_bytes,
                          outs=outs, fed=fed, decode_ms_per_step=ms,
                          peak_bytes=torch.cuda.max_memory_allocated())
        del cache
    bf, q8 = runs["bf16"], runs["int8"]
    rel = torch.stack([row_rel_l2(a, b) for a, b in zip(q8["outs"], bf["outs"])])
    argmax_q = torch.stack([x.argmax(-1) for x in q8["outs"]], dim=1)
    argmax_b = torch.stack([x.argmax(-1) for x in bf["outs"]], dim=1)
    worst, head_dim = float(rel.max()), cfgs["bf16"].head_dim
    limit = kv_int8_rel_l2(head_dim)
    check(worst <= limit, f"int8-cache decode: a logit row's rel L2 {worst:.4e} "
          f"against the bf16 cache's, over the derived limit {limit:.4e}")
    tokens = SERVE_BATCH * SERVE_PROMPT
    out = {"params": n_params, "rel_l2_limit": limit,
           "rel_l2_max": worst, "rel_l2_by_step": rel.max(dim=1).values.tolist(),
           "greedy_agree": float((argmax_q == argmax_b).double().mean()),
           "codes_checked": sum(codes),
           "ring_ratio": q8["ring_bytes"] / bf["ring_bytes"]}
    for name, r in runs.items():
        out[name] = {k: r[k] for k in ("prefill_ms", "ring_bytes", "decode_ms_per_step",
                                       "peak_bytes")}
        out[name]["prefill_tok_s"] = tokens / r["prefill_ms"] * 1e3
    print(f"[config] 22a {SERVE_ARCH} with the int8 KV cache, full width and depth, "
          f"bf16: prefill {SERVE_BATCH} x {SERVE_PROMPT} {out['int8']['prefill_ms']:.1f} ms "
          f"({out['int8']['prefill_tok_s']:.0f} tokens/s; bf16 cache "
          f"{out['bf16']['prefill_ms']:.1f} ms), {n_layers} flash_attention_sm90 each, "
          f"logits equal bit for bit; ring {q8['ring_bytes']} B against "
          f"{bf['ring_bytes']} B ({out['ring_ratio']:.4f}; ({head_dim} + 4)/"
          f"{2 * head_dim} = {(head_dim + 4) / (2 * head_dim):.4f}); "
          f"codes and scales of layers 0 and {cfgs['bf16'].scan_repeats - 1} "
          f"({sum(codes)} codes) equal _kv_quant on the CPU bit for bit; "
          f"{SERVE_STEPS} decode steps fed the bf16 route's greedy tokens: "
          f"{out['int8']['decode_ms_per_step']:.3f} ms per step (bf16 cache "
          f"{out['bf16']['decode_ms_per_step']:.3f}), no launch, logit rows' rel L2 "
          f"at most {worst:.4e} <= {limit:.4e} (per step "
          + " ".join(f"{x:.2e}" for x in out["rel_l2_by_step"])
          + f"), greedy tokens agree in {100 * out['greedy_agree']:.1f}% of "
          f"{argmax_q.numel()}; peak memory int8 {out['int8']['peak_bytes'] / 2**30:.2f} "
          f"GiB, bf16 {out['bf16']['peak_bytes'] / 2**30:.2f} GiB")
    del params, runs, bf, q8, prompts
    free_card()
    out["f32"] = check_kv_int8_f32(launches)
    return out


def check_kv_int8_f32(launches: dict) -> dict:
    """22a at depth 2 in float32 with the int8 cache: a prefill of 1 x
    CHECK_PROMPT tokens (past the ring; two flash_attention launches) on the
    card and on the CPU from the same weights, then CHECK_STEPS greedy
    decode steps on the card (no launch), each also run on the CPU from a
    copy of the card's ring before it.  Every logit row within relative L2
    CHECK_REL_L2 of the CPU's, §2's limit for float32 at full width
    (|card - CPU| is printed beside it: the two sum products of 3840 and
    10240 terms in other orders).  The prefill rings' codes may part by one
    level where the two K/V sums straddle a rounding tie: counted, each
    one level; each decode step then reads the card's ring on both sides,
    since every such flip moves a decode step's logits."""
    from repro_torch.core.pytree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_params
    cfg = serve_config(n_layers=2, scan_repeats=2, dtype="float32", kv_cache_int8=True)
    gen = torch.Generator(device=DEV).manual_seed(1)
    params = init_params(cfg, generator=gen, device=DEV)
    prompt = torch.randint(0, cfg.vocab_size, (1, CHECK_PROMPT), generator=gen, device=DEV)
    on_cpu = lambda tree: tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                                   tree)
    cpu = on_cpu(params)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    ops.reset_launch_counts()            # the main path: the float32 prefill
    logits, cache = prefill(params, {"tokens": prompt})
    counts = nonzero_counts()
    check(counts == {"flash_attention": cfg.n_layers}, f"depth-2 float32 int8-cache "
          f"prefill launched {counts}, expected {cfg.n_layers} flash_attention")
    for k, v in counts.items():
        launches[k] += v
    logits_c, cache_c = prefill(cpu, {"tokens": prompt.cpu()})
    diffs = [(getattr(a, n).cpu().int() - getattr(b, n).int()).abs()
             for a, b in zip(cache["scan"], cache_c["scan"]) for n in ("k", "v")]
    flips = sum(int(d.gt(0).sum()) for d in diffs)
    check(all(int(d.max()) <= 1 for d in diffs), "depth-2 float32: the card's and the "
          "CPU's prefill rings part by more than one code level")
    worst, abs_err = [], []
    for step in range(CHECK_STEPS + 1):
        err = max_row_rel_l2(logits.cpu(), logits_c)
        check(err <= CHECK_REL_L2, f"depth-2 float32 int8 cache, step {step}: a logit "
              f"row of the card's parts from the CPU's by rel L2 {err} > {CHECK_REL_L2}")
        worst.append(err)
        abs_err.append(within(logits, logits_c, 0.0, 0.0)[1])
        if step == CHECK_STEPS:
            break
        tok = logits.argmax(-1, keepdim=True)
        start = on_cpu(cache)
        ops.reset_launch_counts()
        logits, cache = decode(params, cache, tok)
        check(not nonzero_counts(), f"depth-2 float32 decode launched {nonzero_counts()}")
        logits_c, _ = decode(cpu, start, tok.cpu())
    out = {"rel_l2_by_step": worst, "max_abs_err_by_step": abs_err, "code_flips": flips,
           "codes": sum(d.numel() for d in diffs)}
    print(f"[config] 22a {SERVE_ARCH} at depth 2, float32, int8 cache: prefill 1 x "
          f"{CHECK_PROMPT} on the card ({cfg.n_layers} flash_attention launches) and on "
          f"the CPU, {flips} of {out['codes']} ring codes one level apart (the two K/V "
          f"sums at a rounding tie); {CHECK_STEPS} decode steps, each on both from the "
          f"card's ring: every logit row within rel L2 {CHECK_REL_L2} (prefill, then each "
          "step: " + " ".join(f"{x:.2e}" for x in worst) + "; max |card - CPU| "
          + " ".join(f"{x:.2e}" for x in abs_err) + ")")
    del params, cpu, cache, cache_c, start
    free_card()
    return out


def serve_long(arch: str, launches: dict, errors: dict) -> dict:
    """22b: ``arch`` at full width and depth in bf16, a prefill of 1 x
    LONG_PROMPT tokens (timed after a first one; one flash_attention_sm90
    launch per attention layer and nothing else) and LONG_STEPS greedy
    decode steps over the cache (plain one-token attention: no launch),
    logits finite; then flash_attention_sm90 at that shape against its
    plain version (check_long_flash)."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.transformer import init_params
    cfg = family_config(arch)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(cfg, generator=gen, device=DEV)
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                                      generator=gen, device=DEV)}
    prefill = make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    warm_ms = sync_ms(lambda: prefill(params, prompt)[0])[1]
    ops.reset_launch_counts()            # the main path: the timed prefill
    (logits, cache), prefill_ms = sync_ms(lambda: prefill(params, prompt))
    counts = nonzero_counts()
    n_attn = n_attention_layers(cfg)
    check(counts == {"flash_attention_sm90": n_attn}, f"{arch} 1 x {LONG_PROMPT} prefill "
          f"launched {counts}, expected {n_attn} flash_attention_sm90")
    for k, v in counts.items():
        launches[k] += v
    check(bool(torch.isfinite(logits).all()) and logits.shape == (1, cfg.vocab_size)
          and cache["length"] == LONG_PROMPT, f"{arch} 1 x {LONG_PROMPT} prefill: logits "
          f"{tuple(logits.shape)} finite {bool(torch.isfinite(logits).all())}, cache "
          f"length {cache['length']}")
    kv_bytes = cache_bytes(cache)
    ops.reset_launch_counts()            # the main path: decode
    outs, fed, cache, step_ms = serve_greedy(params, cfg, cache, logits, LONG_STEPS)
    check(not nonzero_counts(), f"{arch} decode over {LONG_PROMPT} slots launched "
          f"{nonzero_counts()}")
    check(all(bool(torch.isfinite(x).all()) for x in outs) and
          cache["length"] == LONG_PROMPT + LONG_STEPS, f"{arch} decode after "
          f"{LONG_PROMPT} tokens: logits not finite or cache length {cache['length']}")
    peak = torch.cuda.max_memory_allocated()
    out = dict(params=n_params, warm_prefill_ms=warm_ms, prefill_ms=prefill_ms,
               prefill_tok_s=LONG_PROMPT / prefill_ms * 1e3, decode_ms_per_step=step_ms,
               peak_bytes=peak, cache_bytes=kv_bytes,
               logits_bytes=LONG_PROMPT * cfg.vocab_size * 2, launches=counts)
    print(f"[config] 22b {arch}, full width and depth, bf16, {n_params} parameters: "
          f"prefill 1 x {LONG_PROMPT} {prefill_ms:.1f} ms ({out['prefill_tok_s']:.0f} "
          f"tokens/s; first {warm_ms:.1f} ms), {n_attn} flash_attention_sm90 launches; "
          f"{LONG_STEPS} greedy decode steps {step_ms:.3f} ms per step, no launch, "
          f"logits finite; cache {kv_bytes} B, the forward's bf16 logits "
          f"{out['logits_bytes']} B; peak memory {peak / 2**30:.2f} GiB; sample "
          f"{fed[0, :8].tolist()}")
    del params, cache, logits, outs, prompt
    free_card()
    out["flash_max_abs_err"] = err = check_long_flash(cfg)
    errors["flash_attention_sm90"] = max(errors["flash_attention_sm90"], err)
    return out


def check_long_flash(cfg) -> float:
    """flash_attention_sm90 over 1 x LONG_PROMPT tokens at ``cfg``'s heads,
    head dim and window (seeded bf16 inputs, one launch) against
    ``ref.flash_attention_ref`` on blocks of LONG_BLOCK query rows, every
    head: the first block, one in the middle and the last, each within
    FLASH_TOL (the plain version holds a block's scores against every key
    in float32: 4.3 GB at 32 heads).  max_abs_err."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    (window,) = layer_windows(cfg)
    h, hkv, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.attn_logit_softcap
    q, k, v, pos = attention_inputs(1, LONG_PROMPT, h, hkv, d, torch.bfloat16, 5)
    kw = dict(causal=True, window=window, softcap=cap)
    out, took = flash_route_call(fa, q, k, v, pos, pos, **kw)
    check(took == "flash_attention_sm90", f"{cfg.name} at S {LONG_PROMPT} ran {took}")
    what = f"at {cfg.name}'s 1 x {LONG_PROMPT}, H={h}/{hkv} D={d} W={window} bf16"
    errs = {}
    for r0 in (0, LONG_PROMPT // 2 - LONG_BLOCK, LONG_PROMPT - LONG_BLOCK):
        rows = slice(r0, r0 + LONG_BLOCK)
        plain = ref.flash_attention_ref(q[:, rows], k, v, pos[rows], pos, **kw)
        errs[r0] = flash_check(out[:, rows], plain, f"{what}, rows {r0}..{r0 + LONG_BLOCK}")
        del plain
        free_card()
    print(f"[config] 22b flash_attention_sm90 {what}: query rows "
          + ", ".join(f"{r}..{r + LONG_BLOCK} {e:.3e}" for r, e in errs.items())
          + f" (max_abs_err), each within {FLASH_TOL[torch.bfloat16][1]} + "
          f"{FLASH_TOL[torch.bfloat16][0]:.4g} |plain| of the plain version")
    del q, k, v, out
    free_card()
    return max(errs.values())


def deploy_alg(cfg, **changes):
    """DeployFedLT with the launcher's round (2 epochs, γ 0.02, ρ 10, L 255)."""
    from repro_torch.core.deploy import DeployFedLT
    return DeployFedLT(cfg=cfg, **{"n_epochs": TRAIN_EPOCHS, "gamma": 0.02, "rho": 10.0,
                                   **changes})


def state_leaves(state) -> list:
    """(name, tensor) of every leaf of a DeployState's five trees."""
    from repro_torch.core.pytree import tree_flatten_with_names
    return [(f"{field}.{n}", t) for field in ("x", "z", "c_up", "y_hat", "c_down")
            for n, t in zip(*tree_flatten_with_names(getattr(state, field)))]


def counted_round(alg, state, batch, want: dict, launches: dict, what: str, **kw):
    """One ``round_step`` as a main-path run (counts zeroed before, read
    after, added to ``launches``): its launches must be ``want`` and its
    loss finite.  (new state, metrics, summary: ms, the peak memory, and
    the peak above what was held before the round)."""
    from repro_torch.kernels import ops
    free_card()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (new, metrics), ms = sync_ms(lambda: alg.round_step(state, batch, **kw))
    counts = nonzero_counts()
    for k, v in counts.items():
        launches[k] += v
    check(counts == want, f"{what} launched {counts}, expected {want}")
    loss = float(metrics["loss"])
    check(math.isfinite(loss), f"{what}: loss {loss}")
    peak = torch.cuda.max_memory_allocated()
    return new, metrics, dict(ms=ms, peak_bytes=peak, round_peak_bytes=peak - held,
                              loss=loss)


def phase_remat_group(launches: dict) -> tuple:
    """22d: one round of stablelm-1.6b at phase 17's shape from 17a's first
    state (the launcher's seed) and batch, at remat_group 1 and at
    REMAT_GROUP: the same launches, and the loss and every state leaf equal
    bit for bit.  Returns (the summary, the remat_group-1 round's state,
    which 22c starts from)."""
    cfg = train_config()
    check(cfg.scan_repeats % REMAT_GROUP == 0, f"remat_group {REMAT_GROUP} does not "
          f"divide {cfg.name}'s {cfg.scan_repeats} scan units")
    alg = deploy_alg(cfg)
    s0 = alg.init(TRAIN_AGENTS, generator=torch.Generator(device=DEV).manual_seed(0),
                  device=DEV)
    batch = train_batch(cfg, 0)
    want = dict(train_attention_launches(cfg, torch.bfloat16),
                **quant_launches(alg, TRAIN_AGENTS))
    held = hold_quant_leaves(s0)
    new, res = {}, {}
    for g in (1, REMAT_GROUP):
        a = dataclasses.replace(alg, cfg=dataclasses.replace(cfg, remat_group=g))
        new[g], metrics, res[g] = counted_round(a, s0, batch, want, launches,
                                                f"remat_group {g} round")
    del s0
    parted = [(n, float((a.double() - b.double()).abs().max() / b.double().abs().max()))
              for (n, a), (_, b) in zip(state_leaves(new[REMAT_GROUP]), state_leaves(new[1]))
              if not same_bits(a, b)]
    same_loss = res[1]["loss"] == res[REMAT_GROUP]["loss"]
    if parted or not same_loss:
        print(f"[config] 22d remat_group {REMAT_GROUP} parts from remat_group 1: loss "
              f"{res[REMAT_GROUP]['loss']!r} against {res[1]['loss']!r}; leaves (name, "
              f"max |diff| / max |leaf|) {parted}")
    check(all(r <= 1e-5 for _, r in parted) and math.isclose(
        res[1]["loss"], res[REMAT_GROUP]["loss"], rel_tol=1e-5),
        f"remat_group {REMAT_GROUP}: leaves past rtol 1e-5 {parted}")
    out = {"loss": res[1]["loss"], "bit_for_bit": not parted and same_loss,
           "parted": parted, "launches": want,
           **{f"remat_{g}": {k: r[k] for k in ("ms", "peak_bytes", "round_peak_bytes")}
              for g, r in res.items()}}
    print(f"[config] 22d {TRAIN_ARCH} at full width, bf16, {TRAIN_AGENTS} agents x "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_EPOCHS} epochs, from the launcher's first "
          f"state and batch: remat_group {REMAT_GROUP} against 1, loss {res[1]['loss']:.6f} "
          f"and {len(state_leaves(new[1]))} state leaves "
          + ("equal bit for bit" if out["bit_for_bit"] else "within rtol 1e-5")
          + f"; launches {want} each; ms per round {res[1]['ms']:.1f} (group 1) and "
          f"{res[REMAT_GROUP]['ms']:.1f} (group {REMAT_GROUP}); peak memory above what "
          f"was held before the round {res[1]['round_peak_bytes'] / 2**30:.2f} and "
          f"{res[REMAT_GROUP]['round_peak_bytes'] / 2**30:.2f} GiB (peaks "
          f"{res[1]['peak_bytes'] / 2**30:.2f} and "
          f"{res[REMAT_GROUP]['peak_bytes'] / 2**30:.2f} GiB, the second beside the "
          "first round's state)")
    del new[REMAT_GROUP]
    free_card()
    out["plain_route_leaves"] = check_quant_plain(alg, held, new[1], "remat_group 1 round")
    del held
    free_card()
    return out, new[1]


def check_dropped(state, new, agent: int, what: str) -> None:
    """The dropped ``agent``'s new uplink EF cache is its corrected message
    z_new + c_up (in the leaf's dtype), bit for bit, a piece at a time."""
    from repro_torch.core.compression import PIECE
    from repro_torch.core.pytree import tree_leaves
    for z, c, nc in zip(tree_leaves(new.z), tree_leaves(state.c_up), tree_leaves(new.c_up)):
        zf, cf, nf = z[agent].reshape(-1), c[agent].reshape(-1), nc[agent].reshape(-1)
        check(all(same_bits(nf[s:s + PIECE], zf[s:s + PIECE] + cf[s:s + PIECE])
                  for s in range(0, nf.numel(), PIECE)),
              f"{what}: agent {agent}'s new c_up of a {tuple(z.shape)} leaf is not its "
              "z_new + c_up")


def check_coordinator(alg, state, new, agent: int, what: str) -> None:
    """With only ``agent`` in the quorum, the coordinator's mean z̄ is that
    agent's decoded wire: on the old route, the pieced plain quantizer
    (``ref.quantize_ef_ref``) on z_new and the old c_up, that agent's new
    c_up is the round's, and the round's ŷ and c_down equal the plain
    downlink of c_down + its decoded wire, bit for bit, leaf by leaf."""
    from repro_torch.core.compression import quantize_decode
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ref
    q = alg.quant
    for z, c, cn, cd, yh, cdn in zip(tree_leaves(new.z), tree_leaves(state.c_up),
                                     tree_leaves(new.c_up), tree_leaves(state.c_down),
                                     tree_leaves(new.y_hat), tree_leaves(new.c_down)):
        w, nc = ref.quantize_ef_ref(z[agent], c[agent], **q)
        check(same_bits(nc, cn[agent]), f"{what}: agent {agent}'s new c_up of a "
              f"{tuple(z.shape)} leaf differs from the plain quantizer's")
        y = cd + quantize_decode(w, dtype=z.dtype, **q).to(cd.dtype)
        del w, nc
        yh_want = quantize_decode(ref.quantize_ef_ref(y, None, **q)[0], dtype=y.dtype, **q)
        check(same_bits(yh_want, yh) and same_bits(y - yh_want, cdn),
              f"{what}: ŷ or c_down of a {tuple(cd.shape)} leaf is not the plain downlink "
              f"of agent {agent}'s decoded wire")


def phase_quorum(state, launches: dict) -> dict:
    """22c: quorum rounds of stablelm-1.6b at phase 17's shape, agent 1
    dropped (QUORUM), from ``state`` (22d's round) and round 1's batch, on
    three routes: packed fused (one quant_pipeline and one unpack_bits launch
    per leaf of a tile), packed unfused (quantize_ef and pack_bits instead)
    and unpacked, each with quantize_ef for the rest (quant_launches).
    All three equal bit for bit on every state leaf; the dropped agent's
    cache its corrected message; the survivor's cache, ŷ and c_down those of
    the plain quantizer on the survivor's wire (check_coordinator);
    quorum_frac 0.5; and the survivor's cache what an all-participate round
    gives it.  Then float32 at depth 2, card against
    the CPU (check_quorum_f32)."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels.pack_bits import _TILE_VALS
    cfg = train_config()
    batch = train_batch(cfg, 1)
    tiles = sum(x.numel() >= _TILE_VALS for x in tree_leaves(state.x))
    attn = train_attention_launches(cfg, torch.bfloat16)
    fused = deploy_alg(cfg, pack_wire=True)
    routes = {name: (alg, dict(attn, **quant_launches(alg, TRAIN_AGENTS))) for name, alg in (
        ("packed fused", fused),
        ("packed unfused", dataclasses.replace(fused, fuse_pipeline=False)),
        ("unpacked", deploy_alg(cfg)))}
    out, first = {}, None
    for name, (alg, want) in routes.items():
        new, metrics, res = counted_round(alg, state, batch, want, launches,
                                          f"quorum round, {name}", survivors=QUORUM)
        check(float(metrics["quorum_frac"]) == 0.5,
              f"{name}: quorum_frac {float(metrics['quorum_frac'])}")
        check_dropped(state, new, 1, f"quorum round, {name}")
        check_coordinator(alg, state, new, 0, f"quorum round, {name}")
        if first is None:
            first = new
        else:
            parted = [n for (n, a), (_, b) in zip(state_leaves(new), state_leaves(first))
                      if not same_bits(a, b)]
            check(not parted, f"quorum round, {name}: leaves differ from the packed fused "
                  f"route's: {parted}")
        del new
        out[name] = res
        free_card()
    every, _, res = counted_round(fused, state, batch, routes["packed fused"][1], launches,
                                  "all-participate packed round")
    check(all(same_bits(a[0], b[0]) for a, b in zip(tree_leaves(every.c_up),
                                                    tree_leaves(first.c_up))),
          "the survivor's new c_up differs from an all-participate round's")
    out["all participate"] = res
    del every, first
    free_card()
    print(f"[config] 22c {TRAIN_ARCH} quorum rounds at full width, bf16, {TRAIN_AGENTS} "
          f"agents x {TRAIN_BATCH} x {TRAIN_SEQ}, L 255, survivors {QUORUM}: "
          + "; ".join(f"{n} {r['ms']:.1f} ms, peak {r['peak_bytes'] / 2**30:.2f} GiB "
                      f"({r['round_peak_bytes'] / 2**30:.2f} above the states held)"
                      for n, r in out.items())
          + f"; loss {out['packed fused']['loss']:.6f}; the three routes equal bit for "
          f"bit on every leaf; agent 1's caches its z_new + c_up; agent 0's caches, ŷ "
          f"and c_down those of the plain quantizer on agent 0's wire (the old route); "
          f"quorum_frac 0.5; agent 0's caches those of the all-participate round; "
          f"quant_pipeline / pack_bits and unpack_bits once per leaf of >= {_TILE_VALS} "
          f"values ({tiles} leaves), quantize_ef for the rest and the downlink: "
          + "; ".join(f"{n} {w}" for n, (_, w) in routes.items()))
    out["f32"] = check_quorum_f32(launches)
    return out


def tie_flips(card, cpu, inputs, q: dict, also=None) -> tuple:
    """Where a quantized leaf's card and CPU values part (beyond rtol 1e-4 /
    atol 1e-5): they must be one level Δ apart, and the level's input on
    the CPU (``inputs``) within QUORUM_TIE·Δ of a half-level boundary, or
    ``also`` true there.  (flips, the mask of parted elements)."""
    delta = (q["vmax"] - q["vmin"]) / q["levels"]
    bad = (card - cpu).abs() > 1e-5 + 1e-4 * cpu.abs()
    if not bool(bad.any()):
        return 0, bad
    one = ((card[bad].double() - cpu[bad].double()).abs() - delta).abs() <= 1e-5
    u = (inputs.double()[bad].clamp(q["vmin"], q["vmax"]) - q["vmin"]) / delta
    tie = (u - u.floor() - 0.5).abs() <= QUORUM_TIE
    if also is not None:
        tie |= also[bad]
    return int(bad.sum()), bad if bool((one & tie).all()) else None


def check_quorum_f32(launches: dict) -> dict:
    """22c at depth 2 in float32, one local epoch: from a state after one
    all-participate packed round on the card, a packed fused quorum round
    (agent 1 dropped) on the card, and the same round on the CPU from the
    same state and batch (QUORUM_F32_BATCH x QUORUM_F32_SEQ tokens an
    agent) on the unpacked route: its level ints are the packed wire's, bit
    for bit (the three routes' equality above; on the CPU,
    tests/test_torch_deploy.py), and the CPU's plain pack and unpack of
    10**9 values would take minutes.  The CPU's state is then held against
    the card's on the card: the loss within rtol 1e-4; x and z within rtol
    1e-4 / atol 1e-5; c_up, ŷ and c_down the same, save one level at a
    rounding tie of the two devices' float32 sums (counted), as
    tests/test_torch_deploy.py holds the port against JAX."""
    from repro_torch.core.deploy import DeployState
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.data.synthetic import make_batch, seeded, stack_batches
    cfg = train_config(n_layers=2, scan_repeats=2, dtype="float32")
    alg = deploy_alg(cfg, pack_wire=True, n_epochs=1)

    def batch(k, dev):
        return stack_batches([make_batch(cfg, seeded(11 + i, k), QUORUM_F32_BATCH,
                                         QUORUM_F32_SEQ, device=dev)
                              for i in range(TRAIN_AGENTS)])

    def moved(state, dev):
        return DeployState(*(tree_map(lambda t: t.to(dev), f) for f in tuple(state)[:5]),
                           k=state.k)

    s0 = alg.init(TRAIN_AGENTS, generator=torch.Generator(device=DEV).manual_seed(2),
                  device=DEV)
    state, _ = alg.round_step(s0, batch(0, DEV))
    del s0
    want = dict(attention_launches(cfg, torch.float32, TRAIN_AGENTS, 1),
                **quant_launches(alg, TRAIN_AGENTS))
    card, m_card, res = counted_round(alg, state, batch(1, DEV), want, launches,
                                      "float32 quorum round", survivors=QUORUM)
    t0 = time.perf_counter()
    cpu, m_cpu = dataclasses.replace(alg, pack_wire=False).round_step(
        moved(state, "cpu"), batch(1, "cpu"), survivors=QUORUM)
    cpu_s = time.perf_counter() - t0
    cpu = moved(cpu, DEV)
    ok, err = within(m_card["loss"].reshape(1), m_cpu["loss"].reshape(1), 1e-4, 0.0)
    check(ok, f"float32 quorum round: loss {float(m_card['loss'])} on the card, "
          f"{float(m_cpu['loss'])} on the CPU")
    worst = 0.0
    for field in ("x", "z"):
        for a, b in zip(tree_leaves(getattr(card, field)), tree_leaves(getattr(cpu, field))):
            ok, err = within(a, b, 1e-4, 1e-5)
            check(ok, f"float32 quorum round: a {tuple(b.shape)} leaf of {field} parts "
                  f"from the CPU's by {err}")
            worst = max(worst, err)
    q, flips = alg.quant, 0
    delta = (q["vmax"] - q["vmin"]) / q["levels"]
    for i, (c_t, c_j, z_j, c0, yh_t, yh_j, cd_t, cd_j) in enumerate(zip(
            *(tree_leaves(t) for t in (card.c_up, cpu.c_up, cpu.z, state.c_up, card.y_hat,
                                       cpu.y_hat, card.c_down, cpu.c_down)))):
        f_up, bad = tie_flips(c_t, c_j, z_j + c0, q)
        check(bad is not None, f"float32 quorum round, c_up leaf {i}: card and CPU part "
              "by other than one level at a tie")
        up_flip = bad.any(dim=0)
        f_y, bad_y = tie_flips(yh_t, yh_j, cd_j + yh_j, q, also=up_flip)
        check(bad_y is not None, f"float32 quorum round, ŷ leaf {i}: card and CPU part "
              "by other than one level at a tie or after an uplink flip")
        gap = (cd_t - cd_j).abs()
        bad_cd = gap > 1e-5 + 1e-4 * cd_j.abs()
        check(bool(((bad_y | up_flip)[bad_cd]).all())
              and bool((gap[bad_cd] <= delta + 1e-5).all()),
              f"float32 quorum round, c_down leaf {i}: parts where no level flipped")
        flips += f_up + f_y
    n_vals = sum(t.numel() for t in tree_leaves(cpu.c_up)) + sum(
        t.numel() for t in tree_leaves(cpu.y_hat))
    out = dict(res, cpu_s=cpu_s, xz_max_abs_err=worst, flips=flips, values=n_vals)
    print(f"[config] 22c {TRAIN_ARCH} at depth 2, float32, one epoch, quorum round packed "
          f"on the card ({res['ms']:.1f} ms, launches {want}) and unpacked on the CPU "
          f"({cpu_s:.1f} s), {TRAIN_AGENTS} agents x {QUORUM_F32_BATCH} x "
          f"{QUORUM_F32_SEQ}: loss, x and z within rtol 1e-4 / atol 1e-5 (max |card - "
          f"CPU| {worst:.3e}); {flips} of {n_vals} quantized values one level apart, each "
          "at a rounding tie")
    del card, cpu, state
    free_card()
    return out


class round_times:
    """Within the block, the card time of each ``DeployFedLT.round_step``
    call (host clock between synchronizes), in ms, into the list it gives."""

    def __enter__(self):
        from repro_torch.core.deploy import DeployFedLT
        self.orig = orig = DeployFedLT.round_step
        self.ms = ms = []

        def timed(alg, *args, **kwargs):
            out, t = sync_ms(lambda: orig(alg, *args, **kwargs))
            ms.append(t)
            return out

        DeployFedLT.round_step = timed
        return ms

    def __exit__(self, *exc):
        from repro_torch.core.deploy import DeployFedLT
        DeployFedLT.round_step = self.orig


def phase_fed_lm(launches: dict) -> dict:
    """22e: the port's examples/train_federated_lm.py on the card.  Its
    100m preset (bf16, 4 agents x 4 x 256, 2 epochs, L 1023 over ±0.5) for
    FEDLM_ROUNDS["100m"] rounds: losses finite, the last below the first,
    the attention launches as attention_launches derives them, quantize_ef's
    as quant_launches does, and nothing else, ms per round and peak memory.
    Its smoke preset (float32) for FEDLM_ROUNDS["smoke"] rounds on the card
    (the float32 routes) and on the CPU (the plain versions), from the same
    weights, drawn on the CPU: losses finite, and every round's within
    FEDLM_RTOL."""
    from repro_torch.core.deploy import DeployFedLT
    from repro_torch.examples import train_federated_lm as ex
    from repro_torch.kernels import ops
    out = {}
    for preset, rounds in FEDLM_ROUNDS.items():
        cfg = ex.PRESETS[preset]
        # the example's round: 4 agents, 2 epochs, L 1023, the wire not packed
        per_round = dict(attention_launches(cfg, getattr(torch, cfg.dtype), 4, 2),
                         **quant_launches(DeployFedLT(cfg=cfg, levels=1023), 4))
        argv = ["--preset", preset, "--rounds", str(rounds)]
        free_card()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()        # the main path: the example's rounds
        with round_times() as ms:
            losses = ex.main(argv, device=DEV)
        counts = nonzero_counts()
        for k, v in counts.items():
            launches[k] += v
        want = {k: rounds * v for k, v in per_round.items()}
        check(counts == want, f"train_federated_lm --preset {preset}: launched {counts}, "
              f"expected {want} ({per_round} a round)")
        check(len(losses) == rounds and all(math.isfinite(x) for x in losses)
              and (preset != "100m" or losses[-1] < losses[0]),
              f"train_federated_lm --preset {preset}: losses {losses}")
        out[preset] = dict(losses=losses, ms_per_round=ms,
                           peak_bytes=torch.cuda.max_memory_allocated(),
                           launches_per_round=per_round)
    cpu = ex.main(["--preset", "smoke", "--rounds", str(FEDLM_ROUNDS["smoke"])],
                  device="cpu")
    card = out["smoke"]["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    check(max(gaps) <= FEDLM_RTOL, f"train_federated_lm --preset smoke: card losses "
          f"{card}, CPU {cpu}: rel gaps {gaps} over {FEDLM_RTOL}")
    out["smoke"]["cpu_losses"] = cpu
    print("[config] 22e examples/train_federated_lm.py: "
          + "; ".join(f"--preset {p} losses " + ", ".join(f"{x:.4f}" for x in r["losses"])
                      + ", ms per round " + ", ".join(f"{x:.1f}" for x in r["ms_per_round"])
                      + f", launches per round {r['launches_per_round']}, peak "
                      f"{r['peak_bytes'] / 2**30:.2f} GiB" for p, r in out.items())
          + f"; the smoke preset's losses on the CPU " + ", ".join(f"{x:.4f}" for x in cpu)
          + f" (rel gaps at most {max(gaps):.2e} <= {FEDLM_RTOL})")
    return out


def phase_launcher_flags(launches: dict) -> dict:
    """22f: ``repro_torch.launch.train.main`` on stablelm-1.6b at full width
    (phase 17's traffic) for one round with ``--no-compress --trace
    --ledger``: the loss finite, the streamed trace's ``loss`` series equal
    to the loss the launcher returned, the ledger holding one entry, which
    ``python -m repro_torch.obs report --ledger`` reads."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.obs.ledger import load_ledger
    from repro_torch.obs.trace import load
    trace, ledger = BUILD / "launcher_trace.jsonl", BUILD / "launcher_ledger.jsonl"
    for p in (trace, ledger):
        p.unlink(missing_ok=True)
    cfg = train_config()
    want = train_attention_launches(cfg, torch.bfloat16)
    free_card()
    ops.reset_launch_counts()            # the main path: the launcher's round
    run, ms = sync_ms(lambda: train.main(TRAIN_ARGV + [
        "--rounds", "1", "--no-compress", "--trace", str(trace), "--ledger", str(ledger)],
        device=DEV))
    for k, v in nonzero_counts().items():
        launches[k] += v
    check(run.launches == [want], f"the launcher's --no-compress round launched "
          f"{run.launches}, expected [{want}]")
    check(len(run.losses) == 1 and math.isfinite(run.losses[0]),
          f"the launcher's --no-compress round: losses {run.losses}")
    series = [r for r in load(str(trace)) if r.get("kind") == "series"
              and r.get("name") == "loss"]
    check([(r["step"], r["value"]) for r in series] == [(0, run.losses[0])],
          f"the trace's loss series {series}, the launcher's losses {run.losses}")
    entries = load_ledger(str(ledger))
    check(len(entries) == 1, f"the ledger holds {len(entries)} entries")
    import contextlib
    import io
    from repro_torch.obs.__main__ import main as obs_main
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = obs_main(["report", "--ledger", str(ledger)])
    check(rc == 0 and entries[0]["run_id"] in text.getvalue(), f"python -m "
          f"repro_torch.obs report --ledger (its main, in this process): exit {rc}, "
          f"output {text.getvalue()[-500:]!r}")
    out = {"loss": run.losses[0], "ms": ms, "run_id": entries[0]["run_id"],
           "records": sum(1 for _ in load(str(trace)))}
    print(f"[config] 22f python -m repro_torch.launch.train {TRAIN_ARCH} at full width, "
          f"--no-compress --trace --ledger, one round: loss {run.losses[0]:.6f} "
          f"(the trace's loss series the same), launches {want}, {out['records']} trace "
          f"records, ledger entry {out['run_id']} read by obs report; {ms:.1f} ms with "
          "set-up")
    del run
    free_card()
    return out


def phase_configs(launches: dict, errors: dict) -> dict:
    """22: the JAX package's configurations that no other phase runs, each a
    main-path run with counts zeroed before it, with laps of its own."""
    out = {"kv_int8": phase_kv_int8(launches)}
    lap("22a int8 KV cache")
    out["long_prompt"] = {arch: serve_long(arch, launches, errors) for arch in LONG_ARCHS}
    lap("22b 32768-token prompts")
    out["remat_group"], state = phase_remat_group(launches)
    lap("22d remat_group")
    out["quorum"] = phase_quorum(state, launches)
    del state
    free_card()
    lap("22c quorum rounds")
    out["fed_lm"] = phase_fed_lm(launches)
    lap("22e train_federated_lm")
    out["launcher"] = phase_launcher_flags(launches)
    lap("22f launcher flags")
    return out


# -- phase 18: the benchmark harness -------------------------------------------

BENCH_OUT = BUILD / "bench_out"
#: the kernels the harness's tiny run must launch
BENCH_KERNELS = ("pack_bits", "unpack_bits", "quantize_ef", "quant_pipeline",
                 "erasure_mask")


# -- phase 20: the launch slice (torch.distributed meshes, the dry-run) --------

LAUNCH_ROUNDS = 10                       # 20a: sharded Fed-LT rounds
LAUNCH_LAYERS = 4                        # 20b: stablelm-1.6b's depth, cut
LAUNCH_DRYRUNS = {                       # 20d: python -m repro_torch.launch.dryrun
    "decode_32k single": ["--arch", "stablelm-1.6b", "--shape", "decode_32k"],
    "decode_32k multi": ["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                         "--mesh", "multi"],
    "train_4k single, unrolled, 1 repeat": ["--arch", "stablelm-1.6b", "--shape",
                                            "train_4k", "--unroll", "--scan-repeats",
                                            "1"]}
DRYRUN_KEYS = {"arch", "shape", "mesh", "agent_axis", "n_agents", "n_chips",
               "hlo_flops_per_chip", "hlo_bytes_per_chip", "collective_bytes",
               "collective_counts", "collective_bytes_total", "memory_analysis",
               "model_flops", "useful_flops_ratio", "t_compute", "t_memory",
               "t_collective", "lower_s", "compile_s", "bottleneck"}


def dryrun_start(name: str, argv: list) -> dict:
    """Start ``python -m repro_torch.launch.dryrun ARGV --out F`` on the host
    (a fake process group of 256 or 512 ranks, meta tensors; the card is
    not touched), its output into files under build/."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = BUILD / f"dryrun_{len(CLI_RUNS)}"
    out, err = open(f"{base}.out", "w+"), open(f"{base}.err", "w+")
    run = dict(args=(name,), out=out, err=err, json=f"{base}.json", proc=subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out",
         f"{base}.json"], cwd=ROOT, env=env, stdout=out, stderr=err, text=True))
    CLI_RUNS.append(run)
    return run


def launch_fedlt(mesh, launches: dict) -> tuple:
    """20a: paper Table 1's fused arm (N=100, m=500, d=100, L=10 ±1, EF on)
    for LAUNCH_ROUNDS rounds through ``FedLT.round_sharded`` on the 1-rank
    fleet mesh (state laid out by ``shard_fleet``) and through
    ``FedLT.round``: e_K and every state leaf within rtol 1e-5 (one rank:
    the aggregate is ``tree_mean_axis0`` bit for bit), and each round's
    quant_pipeline and unpack_bits launches the unsharded round's."""
    from repro_torch.core.compression import UniformQuantizer
    from repro_torch.core.error_feedback import EFChannel
    from repro_torch.core.fedlt import FedLT, optimality_error
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.data.logistic import generate, make_local_loss, solve_global
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import shard_fleet

    n = PAPER["n_agents"]
    data, _ = generate(0, **PAPER, device=DEV)
    xbar = solve_global(data, eps=50.0)
    quant = UniformQuantizer(levels=10, vmin=-1.0, vmax=1.0, clip=True)
    alg = FedLT(loss=make_local_loss(eps=50.0, n_agents=n), n_epochs=10, gamma=0.005,
                rho=20.0, uplink=EFChannel(quant), downlink=EFChannel(quant),
                fused_uplink=True)
    plain = alg.init(torch.zeros(PAPER["dim"], device=DEV), n)
    sharded = shard_fleet(plain, mesh, n_agents=n)
    s_data = shard_fleet(data, mesh, n_agents=n)
    round_sharded = alg.round_sharded(mesh, n)
    active = torch.ones(n, dtype=torch.bool, device=DEV)
    counts = {"plain": [], "sharded": []}
    ms = {"plain": 0.0, "sharded": 0.0}
    for _ in range(LAUNCH_ROUNDS):
        for tag in ("plain", "sharded"):
            ops.reset_launch_counts()    # the main path: one round each way
            if tag == "plain":
                (plain, _), dt = sync_ms(lambda: alg.round(plain, data, active))
            else:
                (sharded, info), dt = sync_ms(lambda: round_sharded(sharded, s_data, active))
                check(int(info["n_active"]) == n, f"sharded round: n_active {info}")
            ms[tag] += dt
            counts[tag].append({k: v for k, v in ops.launch_counts().items() if v})
            for k, v in counts[tag][-1].items():
                launches[k] += v
    check(counts["plain"] == counts["sharded"]
          and all(c == {"quant_pipeline": 1, "unpack_bits": 1} for c in counts["plain"]),
          f"sharded Fed-LT rounds launched {counts['sharded']}, unsharded "
          f"{counts['plain']}: expected one quant_pipeline and one unpack_bits each")
    worst = 0.0
    for a, b in zip(tree_leaves(tuple(plain)[:5]), tree_leaves(tuple(sharded)[:5])):
        b = b.full_tensor()
        check(torch.allclose(b, a, rtol=1e-5, atol=0.0), "a sharded Fed-LT state leaf "
              f"parts from the unsharded round's by {(b - a).abs().max().item():.3e}")
        worst = max(worst, (b - a).abs().max().item())
    e_plain = float(optimality_error(plain.x, xbar))
    e_sharded = float(optimality_error(sharded.x.full_tensor(), xbar))
    check(math.isclose(e_sharded, e_plain, rel_tol=1e-5),
          f"e_K sharded {e_sharded} vs unsharded {e_plain}")
    print(f"[launch] 20a Fed-LT, Table 1's fused arm, {LAUNCH_ROUNDS} rounds on a 1-rank "
          f"NCCL fleet mesh: e_K {e_sharded:.9e} sharded, {e_plain:.9e} unsharded; "
          f"largest leaf difference {worst:.3e}; launches per round "
          f"{counts['sharded'][0]} both ways; ms per round {ms['sharded'] / LAUNCH_ROUNDS:.2f} "
          f"sharded, {ms['plain'] / LAUNCH_ROUNDS:.2f} unsharded")
    return {"e_K": e_sharded, "e_K_plain": e_plain, "max_abs_diff": worst,
            "launches_per_round": counts["sharded"][0],
            "ms_per_round": ms["sharded"] / LAUNCH_ROUNDS,
            "ms_per_round_plain": ms["plain"] / LAUNCH_ROUNDS}, sharded


def launch_deploy(mesh, launches: dict) -> tuple:
    """20b: one packed ``DeployFedLT`` round of stablelm-1.6b at full width
    in bf16, depth cut to LAUNCH_LAYERS, TRAIN_AGENTS agents, from one
    state as DTensors on the 1-rank ``("data",)`` mesh with
    ``agent_replicate_spec`` (the dry-run's gather target) and as plain
    tensors without it: the states equal bit for bit (a 1-rank gather
    moves no value), each round's launches phase 17's derivation.  Returns
    (summary, the sharded new state, its specs)."""
    from repro_torch.core.deploy import DeployFedLT, DeployState
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import P, distribute, param_specs

    cfg = train_config(scan_repeats=LAUNCH_LAYERS, n_layers=LAUNCH_LAYERS)
    alg = DeployFedLT(cfg=cfg, n_epochs=TRAIN_EPOCHS, gamma=0.02, rho=10.0, pack_wire=True)
    state = alg.init(TRAIN_AGENTS, generator=torch.Generator(DEV).manual_seed(7),
                     device=DEV)
    batch = train_batch(cfg, 0)
    ps = param_specs(state.x, mesh, agent_axes=("data",), stacked=True, fsdp=None, tp=None)
    pc = param_specs(state.y_hat, mesh, agent_axes=(), tp=None)
    rep = tree_map(lambda _, sp: P(None, *tuple(sp)[1:]), state.x, ps)
    put = lambda tree, specs: tree_map(lambda x, sp: distribute(x, mesh, sp), tree, specs)
    sharded = DeployState(x=put(state.x, ps), z=put(state.z, ps), c_up=put(state.c_up, ps),
                          y_hat=put(state.y_hat, pc), c_down=put(state.c_down, pc), k=0)
    want = dict(train_attention_launches(cfg, torch.bfloat16),
                **quant_launches(alg, TRAIN_AGENTS))
    res = {}
    for tag, st, kw in (("plain", state, {}),
                        ("sharded", sharded, dict(agent_replicate_spec=rep))):
        ops.reset_launch_counts()        # the main path: one packed round
        (new, metrics), dt = sync_ms(lambda: alg.round_step(st, batch, **kw))
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        for k, v in counts.items():
            launches[k] += v
        check(counts == want, f"{tag} deploy round launched {counts}, expected {want}")
        check(math.isfinite(float(metrics["loss"])), f"{tag} deploy round's loss")
        res[tag] = dict(new=new, ms=dt, loss=float(metrics["loss"]))
    del state, sharded
    new_s, new_p = res["sharded"]["new"], res["plain"]["new"]
    for a, b in zip(tree_leaves(tuple(new_p)[:5]), tree_leaves(tuple(new_s)[:5])):
        check(same_bits(a, b.to_local()), "the sharded deploy round's state differs "
              f"from the unsharded round's: a {tuple(a.shape)} leaf")
    del new_p, res["plain"]["new"]
    n_params = sum(t.numel() for t in tree_leaves(new_s.y_hat))
    print(f"[launch] 20b DeployFedLT, stablelm-1.6b at full width, {LAUNCH_LAYERS} layers "
          f"({n_params} parameters), bf16, {TRAIN_AGENTS} agents x {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, pack_wire: the round with agent_replicate_spec on the 1-rank mesh "
          f"equals the plain round bit for bit (loss {res['sharded']['loss']:.6f}); "
          f"launches per round {want}; ms {res['sharded']['ms']:.1f} sharded, "
          f"{res['plain']['ms']:.1f} plain")
    specs = DeployState(x=ps, z=ps, c_up=ps, y_hat=pc, c_down=pc, k=P())
    return ({"params": n_params, "launches_per_round": want, "loss": res["sharded"]["loss"],
             "ms": res["sharded"]["ms"], "ms_plain": res["plain"]["ms"]}, new_s, specs)


def launch_checkpoints(mesh, fleet_mesh_, fleet_state, deploy_state, deploy_specs) -> dict:
    """20c: ``store.save(specs=)`` of the sharded states, then
    ``restore(mesh=, specs=)`` into DTensors on the mesh: bit for bit, in
    the saved layout.  The Fed-LT state whole; of the deploy state its
    coordinator half (ŷ and the downlink cache, 3.0 GB as float32 on disk)."""
    from repro_torch.checkpoint import store
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.launch.sharding import P, spec_of

    out = {}
    whole = lambda t: t.full_tensor() if isinstance(t, torch.Tensor) else t
    # the round's own layout (fleet_specs would shard c_down too: its
    # feature dim, d = 100, equals N)
    fleet = {"path": BUILD / "launch_ckpt" / "fedlt", "mesh": fleet_mesh_,
             "tree": fleet_state,
             "specs": tree_map(lambda t: spec_of(t.placements, fleet_mesh_)
                               if isinstance(t, torch.Tensor) else P(), fleet_state)}
    coord = {"path": BUILD / "launch_ckpt" / "deploy", "mesh": mesh,
             "tree": {"y_hat": deploy_state.y_hat, "c_down": deploy_state.c_down},
             "specs": {"y_hat": deploy_specs.y_hat, "c_down": deploy_specs.c_down}}
    for name, ck in (("fedlt", fleet), ("deploy", coord)):
        shutil.rmtree(ck["path"].parent / name, ignore_errors=True)
        t0 = time.perf_counter()
        store.save(str(ck["path"]), ck["tree"], specs=ck["specs"], step=1)
        like = tree_map(whole, ck["tree"])
        back = store.restore(str(ck["path"]), like, mesh=ck["mesh"], specs=ck["specs"])
        del like
        for a, b in zip(tree_leaves(ck["tree"]), tree_leaves(back)):
            if not isinstance(a, torch.Tensor):
                check(a == b, f"{name} checkpoint: {a} restored as {b}")
                continue
            check(tuple(a.placements) == tuple(b.placements)
                  and same_bits(a.to_local(), b.to_local()),
                  f"{name} checkpoint: a {tuple(a.shape)} leaf does not restore bit for "
                  "bit in its layout")
        meta = store.load_meta(str(ck["path"]))
        check(meta["specs"] == store.spec_strings(ck["specs"]), f"{name} meta specs")
        out[name] = {"s": time.perf_counter() - t0,
                     "bytes": os.path.getsize(str(ck["path"]) + ".npz")}
        del back
    shutil.rmtree(BUILD / "launch_ckpt", ignore_errors=True)
    print(f"[launch] 20c sharded checkpoints restore bit for bit onto their meshes: "
          + ", ".join(f"{k} {v['bytes']} B in {v['s']:.1f} s" for k, v in out.items()))
    return out


def launch_dryruns(runs: dict) -> dict:
    """20d: each dry-run subprocess's record: the JAX package's keys,
    n_chips, n_agents (16 agents for train_4k), positive FLOPs and
    collectives, a bottleneck of the three terms."""
    out = {}
    for name, run in runs.items():
        rc, stdout, stderr = obs_cli_wait(run)
        check(rc == 0, f"dry-run {name} exited {rc}: {stderr[-2000:]}")
        with open(run["json"]) as f:
            rec = json.load(f)
        multi = "multi" in name
        check(set(rec) == DRYRUN_KEYS, f"dry-run {name}: keys {sorted(rec)}")
        check(rec["n_chips"] == (512 if multi else 256), f"dry-run {name}: n_chips")
        check(rec["n_agents"] == (32 if multi else 16), f"dry-run {name}: n_agents "
              f"{rec['n_agents']}")
        check(rec["hlo_flops_per_chip"] > 0 and rec["collective_bytes_total"] > 0
              and rec["hlo_bytes_per_chip"] > 0, f"dry-run {name}: counts {rec}")
        check(rec["bottleneck"] in ("t_compute", "t_memory", "t_collective"),
              f"dry-run {name}: bottleneck {rec['bottleneck']}")
        out[name] = {k: rec[k] for k in (
            "n_agents", "hlo_flops_per_chip", "hlo_bytes_per_chip", "collective_bytes",
            "collective_counts", "collective_bytes_total", "memory_analysis",
            "t_compute", "t_memory", "t_collective", "bottleneck", "lower_s",
            "compile_s")}
        print(f"[launch] 20d dry-run {name}: {json.dumps(out[name])}")
    return out


def phase_launch(launches: dict) -> dict:
    """20: the launch slice.  The dry-runs start first, on the host, and run
    beside the rest.  A 1-rank NCCL process group (a ``file://`` rendezvous
    under build/) carries the meshes of 20a-20c; it is destroyed before the
    phase returns."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import process_group

    t0 = time.perf_counter()
    runs = {name: dryrun_start(name, argv) for name, argv in LAUNCH_DRYRUNS.items()}
    rendezvous = BUILD / "launch_rendezvous"
    rendezvous.unlink(missing_ok=True)
    card = DEV == "cuda"                 # a CPU rehearsal runs gloo instead
    if card:
        torch.cuda.set_device(0)
    out = {}
    with process_group(str(rendezvous), backend="nccl" if card else "gloo"):
        fleet = init_device_mesh(DEV, (1,), mesh_dim_names=("fleet",))
        mesh = init_device_mesh(DEV, (1,), mesh_dim_names=("data",))
        # the communicator is made at the first collective: make it here,
        # outside the timed rounds
        torch.distributed.all_reduce(torch.zeros(1, device=DEV))
        out["fedlt"], fleet_state = launch_fedlt(fleet, launches)
        out["deploy"], deploy_state, deploy_specs = launch_deploy(mesh, launches)
        out["checkpoints"] = launch_checkpoints(mesh, fleet, fleet_state, deploy_state,
                                                deploy_specs)
        del deploy_state, fleet_state
        torch.cuda.empty_cache()
    out["dryrun"] = launch_dryruns(runs)
    out["s"] = time.perf_counter() - t0
    return out


def phase_bench() -> dict:
    """``run_benchmarks(tiny=True)`` on the card, emitted with the trace
    into BENCH_OUT and checked; ``compare``'s table printed, not gated."""
    from repro_torch.bench import compare, profile_round
    from repro_torch.bench.__main__ import emit, emit_trace
    from repro_torch.bench.registry import BENCHMARKS, run_benchmarks
    from repro_torch.device import device_label
    from repro_torch.kernels import ops
    shutil.rmtree(BENCH_OUT, ignore_errors=True)
    ops.reset_launch_counts()
    results = run_benchmarks(tiny=True, device=DEV)
    counts = ops.launch_counts()
    print(f"[bench] launches in the tiny run: {counts}")
    check(all(counts[k] > 0 for k in BENCH_KERNELS),
          f"a kernel of the harness never launched: {counts}")
    ran = sorted(b for group in results.values() for b in group)
    check(ran == sorted(BENCHMARKS), f"benchmarks ran {ran}, registered "
          f"{sorted(BENCHMARKS)}")
    label = device_label(torch.device(DEV))
    check("NVIDIA" in label, f"the run's device label {label!r} names no card")
    emit(results, str(BENCH_OUT), True, label)
    emit_trace(str(BENCH_OUT))
    cli = obs_cli_start("check", str(BENCH_OUT / "TRACE_mega-1000.jsonl"))
    gated = 0
    for group in compare.GROUPS:
        base = compare.load(compare.BASELINE_DIR, group)
        new = compare.load(str(BENCH_OUT), group)
        check(json.loads(Path(compare.bench_path(str(BENCH_OUT), group))
                         .read_text())["device"] == label,
              f"BENCH_{group}.json does not name the card")
        for bench, metrics in base.items():
            for m, d in metrics.items():
                if d["gate"]:
                    v = new.get(bench, {}).get(m, {}).get("value")
                    check(v is not None and math.isfinite(v), f"gated metric "
                          f"{bench}/{m} missing or not finite in the tiny run: {v}")
                    gated += 1
    check(gated > 0, f"the committed baseline under {compare.BASELINE_DIR} "
          "has no gated metric")
    rc = profile_round.main(["--scenario", "mega-1000", "--rounds", "3",
                             "--check-equivalence"])
    check(rc == 0, f"profile_round --check-equivalence exited {rc}")
    rc, stdout, stderr = obs_cli_wait(cli)
    check(rc == 0, f"obs check on the bench trace exited {rc}: "
          f"{stdout[-2000:]}{stderr[-2000:]}")
    passed, verdicts = compare.compare_dirs(str(BENCH_OUT), compare.BASELINE_DIR)
    print(compare.format_report(verdicts, 0.2))
    print(f"[bench] compare against {compare.BASELINE_DIR}: "
          f"{'passed' if passed else 'REGRESSED'} (not gated here); "
          f"{gated} gated metrics present and finite; obs check ok; "
          "fast == oracle on mega-1000")
    return {"launches": {k: counts[k] for k in BENCH_KERNELS},
            "compare_passed": passed, "gated": gated,
            "metrics": {b: {m: d["value"] for m, d in ms.items()}
                        for group in results.values() for b, ms in group.items()}}


# -- phase 9: serving h2o-danube-3-4b -----------------------------------------

def serve_config(**changes):
    import dataclasses
    from repro_torch.configs import get
    return dataclasses.replace(get(SERVE_ARCH), **changes)


def sync_ms(fn):
    """Host clock around ``fn()`` ending in a synchronize: (result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def phase_serve(launches: dict) -> dict:
    """Prefill of 4 x 8192 tokens and 32 greedy decode steps of
    h2o-danube-3-4b at full width in bf16, on random weights."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_params
    cfg = serve_config()
    gen = torch.Generator(device=DEV).manual_seed(0)
    params, init_ms = sync_ms(lambda: init_params(cfg, generator=gen, device=DEV))
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=DEV)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    warm = sync_ms(lambda: prefill(params, {"tokens": prompts}))
    warm_ms = warm[1]
    del warm                             # its cache is not held through the timed run
    ops.reset_launch_counts()
    (logits, cache), prefill_ms = sync_ms(lambda: prefill(params, {"tokens": prompts}))
    counts_p = ops.launch_counts()
    n_attn = cfg.n_layers
    check(counts_p["flash_attention_sm90"] == n_attn and sum(counts_p.values()) == n_attn,
          f"prefill launched {counts_p}, expected {n_attn} flash_attention_sm90 "
          "(the bf16 route) and no other kernel")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    check(logits.shape == (SERVE_BATCH, cfg.vocab_size), f"logits {logits.shape}")
    check(cache["length"] == SERVE_PROMPT, "prefill cache length")

    def run_decode():
        nonlocal logits, cache
        out = []
        for _ in range(SERVE_STEPS):
            tok = logits.argmax(-1, keepdim=True)
            out.append(tok)
            logits, cache = decode(params, cache, tok)
        return torch.cat(out, dim=1)

    ops.reset_launch_counts()
    generated, decode_ms = sync_ms(run_decode)
    counts_d = ops.launch_counts()
    check(sum(counts_d.values()) == 0, f"decode launched {counts_d}; it runs the "
          "plain one-token attention")
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    check(cache["length"] == SERVE_PROMPT + SERVE_STEPS, "decode cache length")
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts_p.items():
        launches[k] += v
    tokens = SERVE_BATCH * SERVE_PROMPT
    out = dict(params=n_params, init_ms=init_ms, warm_prefill_ms=warm_ms,
               prefill_ms=prefill_ms, prefill_tok_s=tokens / prefill_ms * 1e3,
               decode_ms_per_step=decode_ms / SERVE_STEPS,
               decode_tok_s=SERVE_BATCH * SERVE_STEPS / decode_ms * 1e3,
               peak_bytes=peak, flash_launches=counts_p["flash_attention_sm90"])
    print(f"[serve] {SERVE_ARCH}: {n_params} parameters (bf16) drawn on the card "
          f"in {init_ms:.1f} ms; prefill {SERVE_BATCH} x {SERVE_PROMPT} tokens: "
          f"{prefill_ms:.1f} ms ({out['prefill_tok_s']:.0f} tokens/s; first "
          f"prefill {warm_ms:.1f} ms), {counts_p['flash_attention_sm90']} "
          f"flash_attention_sm90 launches; {SERVE_STEPS} greedy decode steps: {out['decode_ms_per_step']:.3f}"
          f" ms per step ({out['decode_tok_s']:.1f} tokens/s), no kernel launch; "
          f"peak memory {peak / 2**30:.2f} GiB (max_memory_allocated); logits "
          f"finite; sample {generated[0, :8].tolist()} (host clock around work "
          "ending in a synchronize)")
    return out, (params, cfg, prompts)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def max_row_rel_l2(a, b) -> float:
    """The largest relative L2 error of a row of ``a`` against ``b``'s."""
    a, b = a.double(), b.double()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def check_serve_f32(launches: dict) -> float:
    """The same model, full width, depth 2, float32: prefill of 1 x 5000
    tokens (past the 4096 window, not a multiple of the kernel's tile) and
    4 decode steps, through the kernel (the float32 route,
    flash_attention.cu) and through the plain attention; the kernel
    prefill's launches are added to ``launches``."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_params
    cfg = serve_config(n_layers=2, scan_repeats=2, dtype="float32")
    expect = {"chunked": cfg.n_layers, "xla": 0}       # flash launches per prefill
    gen = torch.Generator(device=DEV).manual_seed(1)
    params = init_params(cfg, generator=gen, device=DEV)
    prompt = torch.randint(0, cfg.vocab_size, (1, CHECK_PROMPT), generator=gen,
                           device=DEV)
    runs = {}
    for backend in ("chunked", "xla"):
        ops.reset_launch_counts()
        logits, cache = make_prefill_step(cfg, backend)(params, {"tokens": prompt})
        counts = ops.launch_counts()
        if backend == "chunked":
            for k, v in counts.items():
                launches[k] += v
        check(counts["flash_attention"] == expect[backend]
              and sum(counts.values()) == expect[backend],
              f"depth-2 prefill, backend {backend}: launched {counts}, expected "
              f"{expect[backend]} flash_attention")
        runs[backend] = [logits]
        runs[backend + "_cache"] = cache
    worst = rel_l2(runs["chunked"][0], runs["xla"][0])
    ops.reset_launch_counts()
    for _ in range(CHECK_STEPS):
        tok = runs["chunked"][-1].argmax(-1, keepdim=True)
        for backend in ("chunked", "xla"):
            logits, runs[backend + "_cache"] = make_decode_step(cfg, backend)(
                params, runs[backend + "_cache"], tok)
            runs[backend].append(logits)
        worst = max(worst, rel_l2(runs["chunked"][-1], runs["xla"][-1]))
    check(sum(ops.launch_counts().values()) == 0, "depth-2 decode launched "
          f"{ops.launch_counts()}; it runs the plain one-token attention")
    check(all(bool(torch.isfinite(x).all()) for x in runs["chunked"]),
          "depth-2 float32 logits not finite")
    check(worst <= CHECK_REL_L2, f"depth-2 float32: kernel vs plain attention "
          f"logits rel L2 {worst} > {CHECK_REL_L2}")
    print(f"[serve] {SERVE_ARCH} at full width, depth 2, float32: prefill 1 x "
          f"{CHECK_PROMPT} + {CHECK_STEPS} decode steps, backend chunked (kernel, "
          f"{expect['chunked']} launches per prefill) vs xla (plain, none): "
          f"logits rel L2 error {worst:.3e} <= {CHECK_REL_L2}")
    return worst


# -- phase 5: Fed-LTSat through Experiment on the port's simulator -----------

def constellation_setup(device):
    """The constellation example's problem and Fed-LTSat algorithm."""
    from repro_torch.examples import satellite_constellation as ex
    data, xbar, quant, algs = ex.setup(device)
    return data, xbar, quant, algs["Fed-LTSat"]


def run_experiment(scenario, alg, quant, data, xbar, rounds, seed, *,
                   device=None, log_every=20, trace=False, exp=None, **kw):
    """``rounds`` rounds of ``exp`` (built here from ``scenario`` and
    ``kw`` when not given) from the algorithm's initial state."""
    from repro_torch.api import Experiment
    from repro_torch.core.fedlt import optimality_error
    from repro_torch.examples import satellite_constellation as ex
    if exp is None:
        exp = Experiment.from_scenario(scenario, algorithm=alg, compressor=quant,
                                       device=device or DEV, **kw)
    st = exp.init(torch.zeros(ex.DIM), ex.N_AGENTS)
    return exp.run(st, data, rounds, seed, log_every=log_every, trace=trace,
                   error_fn=lambda s: optimality_error(s.x, xbar))


RUNS = (  # the example's three Fed-LTSat runs: (label, scenario, seed, options)
    ("sync", "walker-kiruna", 2, dict(measure="cohort")),
    ("async", "dual-station", 3, dict(mode="async", buffer_size=10,
                                      staleness_alpha=0.5)),
    ("lossy", "lossy-uplink", 4, dict(measure="cohort")),
)


def phase_constellation(launches: dict) -> dict:
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    data, xbar, quant, alg = constellation_setup(DEV)
    torch.cuda.synchronize()
    print(f"[constellation] set-up (data, x̄ by Newton) "
          f"{time.perf_counter() - t0:.2f} s")
    out = {}
    for label, scenario, seed, kw in RUNS:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_experiment(scenario, alg, quant, data, xbar, SAT_ROUNDS, seed,
                             log_every=1 if label == "sync" else 20,
                             trace=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, v in counts.items():
            launches[k] += v
        rounds = len(res.logs)
        check(rounds == SAT_ROUNDS, f"{label}: {rounds} of {SAT_ROUNDS} rounds ran")
        # one probe encode (pack_bits) per run for the message size, then one
        # fused uplink (quant_pipeline + unpack_bits) per round
        expect = dict.fromkeys(SOURCES, 0)
        expect.update(quant_pipeline=rounds, unpack_bits=rounds, pack_bits=1)
        check(counts == expect, f"{label}: launches {counts}, expected {expect}")
        errs = [(lg.round, lg.error) for lg in res.logs if lg.error is not None]
        check(all(math.isfinite(e) for _, e in errs), f"{label}: e_K not finite")
        check(errs[-1][1] < errs[0][1], f"{label}: e_K did not fall: "
              f"{errs[0]} -> {errs[-1]}")
        stage = {}
        for r in res.records:
            if r.get("kind") == "stage":
                stage[r["name"]] = stage.get(r["name"], 0.0) + r["dur_host"]
        engine_s = stage.get("engine.run_round", stage.get("engine.run_async", 0.0))
        last = res.logs[-1]
        for k, e in errs:
            if k % 20 == 0 or k == rounds - 1:
                print(f"[constellation] {label} {scenario} round {k:3d}  "
                      f"e_K = {e:.6e}")
        print(f"[constellation] {label} {scenario}: {rounds} rounds in "
              f"{wall:.3f} s ({1e3 * wall / rounds:.3f} ms per round wall; "
              f"engine host {1e3 * engine_s / rounds:.3f} ms, alg.round "
              f"{1e3 * stage.get('alg.round', 0.0) / rounds:.3f} ms per round); "
              f"sim time {last.time:.1f} s, bytes_up {last.bytes_up:.0f}, "
              f"lost {sum(lg.n_lost for lg in res.logs)}; launches {counts}")
        out[label] = dict(res=res, wall_s=wall, engine_s=engine_s,
                          alg_s=stage.get("alg.round", 0.0), counts=counts)
    check_constellation_against_cpu(out["sync"]["res"], data, xbar, quant, alg)
    return out


def check_constellation_against_cpu(res_card, data, xbar, quant, alg,
                                    rounds: int = 10) -> None:
    """The sync run's first rounds again on the CPU, from the same data."""
    from repro_torch.core.pytree import tree_map
    res_cpu = run_experiment("walker-kiruna", alg, quant,
                             tree_map(lambda t: t.cpu(), data), xbar.cpu(),
                             rounds, 2, device="cpu", log_every=1,
                             measure="cohort")
    worst = 0.0
    for a, b in zip(res_card.logs[:rounds], res_cpu.logs):
        for f in ("round", "time", "bytes_up", "n_active", "n_lost"):
            check(getattr(a, f) == getattr(b, f), f"round {a.round}: {f} on the "
                  f"card {getattr(a, f)} vs CPU {getattr(b, f)}")
        rel = abs(a.error - b.error) / abs(b.error)
        worst = max(worst, rel)
        # matmul summation order differs between CPU and card
        check(rel < 1e-4, f"round {a.round}: e_K on the card {a.error} vs CPU "
              f"{b.error}")
    print(f"[constellation] first {rounds} sync rounds on the CPU: time, "
          f"bytes_up, n_active, n_lost equal; e_K within rel {worst:.1e} < 1e-4")


# -- phase 6: the canonical convergence scenarios ----------------------------

def write_trace(records, path: Path) -> str:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


def phase_canonical() -> dict:
    """Returns each scenario's numbers and the path of its trace, written
    to build/ for phase 16."""
    from repro_torch.obs.report import CANONICAL, run_canonical
    from repro_torch.obs.summary import extract_series
    reference = json.loads((ROOT / "CONV_reference.json").read_text())
    out = {}
    for name in CANONICAL:
        t0 = time.perf_counter()
        records = run_canonical(name, device=DEV)
        wall = time.perf_counter() - t0
        series = extract_series(records)
        e_k = series["e_K"]["values"]
        got = series["bytes_up"]["values"][-1]
        want = reference["scenarios"][name]["bytes_up"]
        check(abs(got - want) <= 0.01 * want, f"{name}: bytes_up {got} vs "
              f"reference {want} (±1%)")
        check(all(math.isfinite(e) for e in e_k), f"{name}: e_K not finite")
        if name == "sync-mega-chaos":
            # 8 quorum-closed rounds barely move e_K, and on some draws it
            # ends above its start, the JAX package's too
            # (tests/test_torch_canonical.py): hold it against the CPU
            check_canonical_against_cpu(name, e_k)
        else:
            check(e_k[-1] < e_k[0], f"{name}: e_K did not fall: {e_k[0]} -> "
                  f"{e_k[-1]}")
        print(f"[canonical] {name}: {len(e_k)} rounds in {wall:.2f} s, e_K "
              f"{e_k[0]:.6e} -> {e_k[-1]:.6e} (min {min(e_k):.6e}; port's own "
              f"draws), bytes_up "
              f"{got:.0f} == reference {want:.0f} within ±1%")
        out[name] = dict(bytes_up=got, e_first=e_k[0], e_last=e_k[-1],
                         trace=write_trace(records, BUILD / f"canonical_{name}.jsonl"))
    return out


def check_canonical_against_cpu(name: str, e_card) -> None:
    """The card's e_K curve against the port on the CPU, on the card's draw
    (the same problem ``run_canonical`` draws on the card, copied over)."""
    from repro_torch.data.logistic import generate, solve_global
    from repro_torch.obs.report import CANONICAL, CANONICAL_SEED, run_canonical
    from repro_torch.obs.summary import extract_series
    cfg = CANONICAL[name]
    data, _ = generate(CANONICAL_SEED, n_agents=cfg["n_agents"], m=cfg["m"],
                       dim=cfg["dim"], device=DEV)
    x_star = solve_global(data, eps=50.0).cpu()
    data = {k: v.cpu() for k, v in data.items()}
    e_cpu = extract_series(run_canonical(name, problem=(data, x_star),
                                         device="cpu"))["e_K"]["values"]
    check(len(e_cpu) == len(e_card), f"{name}: {len(e_card)} e_K samples on "
          f"the card, {len(e_cpu)} on the CPU")
    # matmul summation order differs between CPU and card
    rel = max(abs(a - b) / abs(b) for a, b in zip(e_card, e_cpu))
    check(rel < 1e-4, f"{name}: e_K on the card {e_card} vs CPU {e_cpu}")
    print(f"[canonical] {name}: e_K on the card equals the CPU run of the same "
          f"draw within rel {rel:.1e} < 1e-4 (CPU {e_cpu[0]:.6e} -> "
          f"{e_cpu[-1]:.6e})")


# -- phase 7: the mega-1000 cohort uplink transport --------------------------

def phase_transport(launches: dict):
    """Returns the runs' numbers and a callable that drives both lossy
    chains once more over the lossy trajectory (for the profile)."""
    from repro_torch.bench import sim_scale
    from repro_torch.kernels import ops
    out = {}
    for fn in (sim_scale.lossy_round, sim_scale.round_pipeline):
        lossy = fn is sim_scale.lossy_round
        ops.reset_launch_counts()
        r = fn(1000, rounds=3, seed=0, device=DEV)
        counts = ops.launch_counts()
        for k, v in counts.items():
            launches[k] += v
        p, c, d = r["passes"], r["cohorts"], r["deliveries"]
        expect = dict.fromkeys(SOURCES, 0)
        expect.update(quant_pipeline=p * c, quantize_ef=p * d, pack_bits=p * d,
                      erasure_mask=p * (c + d) if lossy else 0)
        check(counts == expect, f"{r['scenario']}: launches {counts}, expected "
              f"{expect} ({p} passes of {c} cohorts, {d} deliveries)")
        if lossy:
            check(r["lost"] > 0, "mega-1000-lossy lost no update")
            chains = (("fused", lambda k, r=r: sim_scale.lossy_fused(
                          r["vals"], r["results"], r["p_loss"], r["seed"], kern=k)),
                      ("unfused", lambda k, r=r: sim_scale.lossy_unfused(
                          r["vals"], r["results"], r["p_loss"], r["seed"], kern=k)))
        else:
            chains = (("fused", lambda k: sim_scale.uplink_fused(
                          r["vals"], r["results"], kern=k)),
                      ("unfused", lambda k: sim_scale.uplink_unfused(
                          r["vals"], r["results"], kern=k)))
        for label, chain in chains:
            check(same_bits(r[f"words_{label}"], chain(sim_scale.PLAIN)),
                  f"{r['scenario']}: the {label} chain's last words differ "
                  "from the same chain through the plain versions")
        checked, bad = sim_scale.decoded_agree(r["vals"], r["results"])
        check(checked == d and bad == 0, f"{r['scenario']}: fused and unfused "
              f"indices differ for {bad} of {checked} satellites")
        ratio = r["uplink_ms_unfused"] / r["uplink_ms_fused"]
        print(f"[transport] {r['scenario']}: {r['rounds']} rounds, {d} "
              f"deliveries in {c} cohorts, {r.get('lost', 0)} lost; engine "
              f"{r['engine_ms_per_round']:.4f} ms per round (host); uplink "
              f"chain per round (CUDA events, {p} passes, least of the timed): "
              f"unfused {r['uplink_ms_unfused']:.4f} ms, fused "
              f"{r['uplink_ms_fused']:.4f} ms, ratio {ratio:.3f}; launches "
              f"{counts}; both chains == plain versions; {checked} satellites' "
              "fused indices == unfused wire")
        if lossy:
            print(f"[transport] {r['scenario']}: engine lossless "
                  f"{r['engine_ms_per_round_lossless']:.4f} ms per round, "
                  f"channel overhead {r['channel_overhead']:.3f}x, "
                  f"retransmissions {r['retransmissions']}")
            replay = [chain for _, chain in chains]
        out[r["scenario"]] = {k: v for k, v in r.items()
                              if k not in ("results", "vals", "words_fused",
                                           "words_unfused")}
    return out, lambda: [chain(ops) for chain in replay]


def phase_profile(run, rounds: int, tag: str, unit: str = "round") -> float:
    """Where a round's time goes: torch.profiler over ``run()``, which drives
    ``rounds`` rounds (or steps: ``unit``); device time summed by kernel,
    beside the wall time of the same rounds.  Returns the device ops per
    round."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_session = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / rounds
    # device kernels only: the record_function ranges (the dispatchers'
    # "repro.kernels.<name>", the training round's "fedlt.<stage>") also
    # carry device time, which would count their kernels twice
    device = [e for e in prof.key_averages() if e.self_device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(("repro.kernels.", "fedlt."))]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / rounds
    launches = sum(e.count for e in device) / rounds
    print(f"[profile] {tag}: {rounds} {unit}s under torch.profiler: wall "
          f"{wall_ms:.3f} ms per {unit}, device busy {busy_ms:.3f} ms per {unit} "
          f"({100 * busy_ms / wall_ms:.1f}%), {launches:.0f} device ops per {unit}; "
          f"the session with its averages {time.perf_counter() - t_session:.1f} s")
    stages = {e.key: e.self_device_time_total / 1e3 / rounds for e in prof.key_averages()
              if e.key.startswith("fedlt.") and e.self_device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA}
    if stages:
        print(f"[profile] {tag}: device ms per {unit} by stage (record_function spans): "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items())))
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / rounds:8.4f} ms/{unit} "
              f"{e.count / rounds:6.0f}x/{unit} "
              f"{e.self_device_time_total / e.count:8.2f} us each  {e.key[:70]}")
    for e in device:                     # a backward's three grids each by name
        found = next(((n, m) for n in SOURCES for m in
                      [re.search(rf"\b{n}(32)?(_prep|_dq|_dkdv)?_kernel\b", e.key)] if m),
                     None)
        if found:
            name, m = found
            grid = f" ({m.group(2)[1:]} grid)" if m.group(2) else ""
            args = re.match(r"<[^>]*>", e.key[m.end():])    # the instantiation
            grid += f" {args.group(0)}" if args else ""
            print(f"[profile] {tag}: {name}{grid}: {e.self_device_time_total / e.count:.2f}"
                  f" us of device time per launch, {e.count / rounds:.0f}x/{unit}, "
                  f"{e.self_device_time_total / 1e3 / rounds:.3f} ms/{unit}")
    return launches


def profile_serve(params, cfg, prompts) -> None:
    """Where a serving step's time goes: one prefill, then 8 decode steps."""
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, {"tokens": prompts})

    def run_decode():
        for _ in range(8):
            tok = state["logits"].argmax(-1, keepdim=True)
            state["logits"], state["cache"] = decode(params, state["cache"], tok)

    phase_profile(run_prefill, 1, f"serve {SERVE_ARCH} prefill "
                  f"{SERVE_BATCH}x{SERVE_PROMPT}", unit="prefill")
    phase_profile(run_decode, 8, f"serve {SERVE_ARCH} decode B={SERVE_BATCH}",
                  unit="step")
    attribute_device_time(run_decode, 8, f"serve {SERVE_ARCH} decode "
                          f"B={SERVE_BATCH}", unit="step")


def attribute_device_time(run, steps: int, tag: str, unit: str) -> None:
    """Device time of ``run()`` by the PyTorch op that launched each kernel
    and that op's input shapes, which name the tensors it moved
    (torch.profiler with ``record_shapes``; a run of its own)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0
            and not e.key.startswith("repro.kernels.")]
    total = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    print(f"[profile] {tag}: device time by launching op and its input shapes "
          f"({total:.3f} ms/{unit} attributed):")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.4f} ms/{unit} "
              f"{e.count / steps:6.0f}x/{unit}  {e.key[:20]:20s} "
              f"{str(e.input_shapes)[:110]}")


# -- phase 10: kernel times -----------------------------------------------------

def time_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean time per call from CUDA events around ``iters`` back-to-back
    calls (host launch cost included when it exceeds the kernel's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(rng) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    from repro_torch.kernels.pack_bits import n_tiles, pack_bits, unpack_bits
    out = {"pack_bits": time_pack_bits(rng), "quantize_ef": time_quantize_ef(rng)}
    bits = 4
    shapes = {"unpack_bits": MAIN_N, "quant_pipeline": MAIN_N}
    for name, main_n in shapes.items():
        for n in (main_n, BIG_N):
            iters = 200 if n < BIG_N else 20
            word_bytes = 4 * n_tiles(n) * bits * 1024
            bit_ops = 4 * bits * n           # shift, and, shift, or per bit
            if name == "unpack_bits":
                words = pack_bits(torch.from_numpy(
                    rng.integers(0, 2**bits, n).astype(np.uint32)).to(DEV), bits)
                kern = lambda: unpack_bits(words, bits, n)
                plain = lambda: ref.unpack_bits_ref(words, bits, n)
                nbytes, ops = word_bytes + 4 * n, bit_ops
            else:
                msg, cache = quant_inputs(n, 10, -1.0, 1.0, rng)
                kern = lambda: quant_pipeline(msg, cache, levels=10, vmin=-1.0, vmax=1.0)
                plain = lambda: ref.quant_pipeline_ref(msg, cache, levels=10,
                                                       vmin=-1.0, vmax=1.0)
                nbytes, ops = 12 * n + word_bytes, 12 * n + bit_ops
            out.setdefault(name, []).append(
                time_record(name, n, bits, kern, plain, iters, nbytes, ops))
    # quant_pipeline on bf16 msg and cache (a bf16 model's uplink), L=255
    msg, cache = (t.to(torch.bfloat16) for t in quant_inputs(BIG_N, 255, -1.0, 1.0, rng))
    out["quant_pipeline_bf16"] = time_record(
        "quant_pipeline", BIG_N, 8,
        lambda: quant_pipeline(msg, cache, levels=255, vmin=-1.0, vmax=1.0),
        lambda: ref.quant_pipeline_ref(msg, cache, levels=255, vmin=-1.0, vmax=1.0),
        20, 7 * BIG_N, 12 * BIG_N + 32 * BIG_N)
    del msg, cache
    # the transport's erasure mask at its shape: one tile of 8-bit words
    # (8,192 words)
    from repro_torch.kernels.erasure_mask import erasure_mask
    for n in (WORDS_N, BIG_N):
        words = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64)
                                 .astype(np.uint32)).to(DEV)
        out.setdefault("erasure_mask", []).append(time_record(
            "erasure_mask", n, 32,
            lambda: erasure_mask(words, p=0.1, seed=0),
            lambda: ref.erasure_mask_ref(words, p=0.1, seed=0),
            200 if n < BIG_N else 20, 12 * n, 20 * n))
    # sign_pipeline at the Fed-LT uplink's shape (100 x 100) and at 2**24:
    # the function reads 8 B and writes 4 B per value and one word per 32
    # values; the kernel's two passes read msg and cache again once the
    # scale is known, which is printed beside the bound
    from repro_torch.kernels.compress_pipeline import sign_pipeline
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    for n in (MAIN_N, BIG_N):
        msg, cache = sign_inputs(n, rng)
        rec = time_record(
            "sign_pipeline", n, 1, lambda: sign_pipeline(msg, cache),
            lambda: ref.sign_pipeline_ref(msg, cache),
            200 if n < BIG_N else 20, 12.125 * n, 8 * n)
        two_pass, two_pass_l2 = (bound(b, 8 * n)[0]
                                 for b in (20.125 * n, sign_two_pass_bytes(n, l2)))
        rec.update(bound_ms_two_pass=two_pass, bound_ms_two_pass_l2=two_pass_l2)
        print(f"[times] sign_pipeline   n={n:9d}: the bound is the function's 12.125 B "
              f"per value; this design's two passes read msg and cache twice, "
              f"20.125 B per value: {two_pass:.6f} ms ({100 * two_pass / rec['ms']:.1f}% "
              f"of the kernel's time); with the L2 ({l2} B) serving what it holds of "
              f"the second read, {sign_two_pass_bytes(n, l2) / n:.3f} B per value: "
              f"{two_pass_l2:.6f} ms ({100 * two_pass_l2 / rec['ms']:.1f}%)")
        out.setdefault("sign_pipeline", []).append(rec)
    # and on bf16 msg and cache at 2**24: the function reads 4 B and writes
    # 2 B per value and one word per 32 values; the two passes read msg and
    # cache twice (10.125 B per value)
    msg, cache = (t.to(torch.bfloat16) for t in sign_inputs(BIG_N, rng))
    rec = time_record("sign_pipeline", BIG_N, 1, lambda: sign_pipeline(msg, cache),
                      lambda: ref.sign_pipeline_ref(msg, cache), 20, 6.125 * BIG_N, 8 * BIG_N)
    rec["bound_ms_two_pass"] = bound(10.125 * BIG_N, 8 * BIG_N)[0]
    print(f"[times] sign_pipeline   n={BIG_N:9d} bf16: the bound is the function's 6.125 "
          f"B per value; the two passes' 10.125 B per value take "
          f"{rec['bound_ms_two_pass']:.6f} ms "
          f"({100 * rec['bound_ms_two_pass'] / rec['ms']:.1f}% of the kernel's time)")
    out["sign_pipeline_bf16"] = rec
    del msg, cache
    out["flash_attention_sm90"] = [time_flash_sm90()]
    out["flash_attention"] = [time_flash_f32()]
    out["flash_attention_bwd_sm90"] = [time_flash_bwd(torch.bfloat16)]
    out["flash_attention_bwd"] = [time_flash_bwd(torch.float32)]
    return out


def largest_train_leaf() -> tuple:
    """The shape of phase 17's largest leaf with its agent axis (stablelm-
    1.6b's MLP weights, 2 x 24 x 2048 x 5632 = 5.54e8 values), from the
    parameter tree on the meta device."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.models.transformer import init_params
    leaf = max(tree_leaves(init_params(train_config(), device="meta")), key=lambda t: t.numel())
    return (TRAIN_AGENTS,) + tuple(leaf.shape)


def time_quantize_ef(rng) -> list:
    """quantize_ef (redesigned) at the training round's path shape, the
    largest leaf as a bf16 msg and cache at L=255 (7 B a value: 4 read, a
    uint8 wire and a bf16 new cache written), then at 2**24 float32 values
    (13 B; the shape of the earlier design's row), at 2**24 bf16, and with
    no cache at the leaf (the downlink: 3 B a value); the host's cost per
    call at the cohort transport's shape (one satellite's 2,048 float32
    values)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize_ef import quantize_ef
    kw = dict(levels=255, vmin=-1.0, vmax=1.0)
    shape = largest_train_leaf()
    n = math.prod(shape)
    gen = torch.Generator(device=DEV).manual_seed(5)
    msg = (0.6 * torch.randn(shape, generator=gen, device=DEV)).to(torch.bfloat16)
    cache = (0.004 * torch.randn(shape, generator=gen, device=DEV)).to(torch.bfloat16)
    recs = [time_record("quantize_ef", n, 8, lambda: quantize_ef(msg, cache, **kw),
                        lambda: ref.quantize_ef_ref(msg, cache, **kw), 5, 7 * n, 12 * n,
                        warmup=1)]
    recs[0]["shape"], recs[0]["dtype"] = list(shape), "bfloat16"
    no_cache = time_record("quantize_ef", n, 8, lambda: quantize_ef(msg, None, **kw),
                           lambda: ref.quantize_ef_ref(msg, None, **kw), 5, 3 * n, 8 * n,
                           warmup=1)
    del msg, cache
    pairs = []
    for dtype in (torch.float32, torch.bfloat16):
        msg, cache = (t.to(dtype) for t in quant_inputs(BIG_N, 255, -1.0, 1.0, rng))
        pairs.append((msg, cache))
        recs.append(time_record(
            "quantize_ef", BIG_N, 8, lambda: quantize_ef(msg, cache, **kw),
            lambda: ref.quantize_ef_ref(msg, cache, **kw), 20,
            (13 if dtype == torch.float32 else 7) * BIG_N, 12 * BIG_N))
    recs[2]["dtype"] = "bfloat16"
    recs.append(no_cache)
    for rec, (m, c) in zip(recs[1:3], pairs):   # the host's ~25-50 µs a call can hide it
        rec["device_us"] = graph_us(lambda: quantize_ef(m, c, **kw))
    no_cache["dtype"], no_cache["no_cache"] = "bfloat16", True
    msg, zeros = quant_inputs(UPDATE_N, 255, -1.0, 1.0, rng)[0], torch.zeros(
        UPDATE_N, device=DEV)
    host = host_ms_per_call(lambda: quantize_ef(msg, zeros, **kw), 2000)
    recs[0]["host_us_cohort"] = 1e3 * host
    recs[0]["device_us_cohort"] = graph_us(lambda: quantize_ef(msg, zeros, **kw))
    print(f"[times] quantize_ef at the path shape {shape} bf16 msg and cache (the "
          f"training round's largest leaf): {recs[0]['ms']:.4f} ms, bound "
          f"{recs[0]['bound_ms']:.4f} ({100 * recs[0]['bound_share']:.1f}%); no cache "
          f"{no_cache['ms']:.4f} ms, bound {no_cache['bound_ms']:.4f} "
          f"({100 * no_cache['bound_share']:.1f}%); host {1e3 * host:.2f} µs per call at the "
          f"cohort shape ({UPDATE_N} float32 values, calls enqueued back to back), device "
          f"{recs[0]['device_us_cohort']:.3f} µs there (a CUDA graph of 20 calls); device "
          f"µs at 2**24 (graph; inputs in the L2 when they fit): float32 "
          f"{recs[1]['device_us']:.3f}, bf16 {recs[2]['device_us']:.3f}")
    return recs


def time_pack_bits(rng) -> list:
    """pack_bits (redesigned) at the training round's path shape, the
    largest leaf's uint8 level ints at b=8 (the unfused packed uplink: 1 B
    read, 1 B of words written a value), then at 2**24 values from uint32
    at b=4 (4.5 B; the shape of the earlier design's row) and from uint8 at
    b=4 (1.5 B); the host's cost per call at the cohort transport's shape
    (one satellite's 2,048 uint8 ints at b=8)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pack_bits import n_tiles, pack_bits
    shape = largest_train_leaf()
    n = math.prod(shape)
    vals = torch.randint(0, 256, shape, dtype=torch.uint8, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(6))
    word_bytes = lambda n, b: 4 * n_tiles(n) * b * 1024
    recs = [time_record("pack_bits", n, 8, lambda: pack_bits(vals, 8),
                        lambda: ref.pack_bits_ref(vals, 8), 5, n + word_bytes(n, 8),
                        32 * n, warmup=1)]
    recs[0]["shape"], recs[0]["dtype"] = list(shape), "uint8"
    del vals
    for dtype in (np.uint32, np.uint8):
        vals = torch.from_numpy(rng.integers(0, 16, BIG_N).astype(dtype)).to(DEV)
        recs.append(time_record("pack_bits", BIG_N, 4, lambda: pack_bits(vals, 4),
                                lambda: ref.pack_bits_ref(vals, 4), 20,
                                vals.element_size() * BIG_N + word_bytes(BIG_N, 4),
                                16 * BIG_N))
        recs[-1]["dtype"] = np.dtype(dtype).name
        # device time: at 2**24 the host's ~25-50 µs a call can hide the kernel's
        recs[-1]["device_us"] = graph_us(lambda: pack_bits(vals, 4))
    wire = torch.from_numpy(rng.integers(0, 256, UPDATE_N).astype(np.uint8)).to(DEV)
    host = host_ms_per_call(lambda: pack_bits(wire, 8), 2000)
    # the earlier wrapper's route: an int32 copy of the uint8 ints, then the launch
    host_copy = host_ms_per_call(lambda: pack_bits(wire.to(torch.int32), 8), 2000)
    recs[0]["host_us_cohort"] = 1e3 * host
    recs[0]["host_us_cohort_int32_copy"] = 1e3 * host_copy
    recs[0]["device_us_cohort"] = graph_us(lambda: pack_bits(wire, 8))
    print(f"[times] pack_bits at the path shape {shape} uint8 ints, b=8 (the training "
          f"round's largest leaf, unfused): {recs[0]['ms']:.4f} ms, bound "
          f"{recs[0]['bound_ms']:.4f} ({100 * recs[0]['bound_share']:.1f}%); host "
          f"{1e3 * host:.2f} µs per call at the cohort shape ({UPDATE_N} uint8 ints, "
          f"calls enqueued back to back; {1e3 * host_copy:.2f} with the int32 copy the "
          f"earlier wrapper made), device {recs[0]['device_us_cohort']:.3f} µs there (a "
          f"CUDA graph of 20 calls); device µs at 2**24, b=4 (graph; inputs in the L2): "
          f"from uint32 {recs[1]['device_us']:.3f}, from uint8 {recs[2]['device_us']:.3f}")
    return recs


def sign_two_pass_bytes(n: int, l2_bytes: int) -> float:
    """The least bytes sign_pipeline's two-pass design moves to and from
    device memory: the function's 12.125 n (msg and cache read, new cache
    written, one word per 32 values) and the second read of msg and cache,
    after the scale, less what the L2 can hold of them."""
    return 12.125 * n + max(0, 8 * n - l2_bytes)


def graph_us(fn, calls: int = 20) -> float:
    """Device µs per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, the replay timed with CUDA events (least of three), so the
    host's dispatch, which can take longer than a small kernel, is not in
    the time.  Outputs are allocated in the graph's own pool."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(1e3 * start.elapsed_time(end) / calls)
    del graph
    return min(runs)


def host_ms_per_call(fn, calls: int) -> float:
    """Host clock per call of ``calls`` calls enqueued back to back, with
    no synchronize between them: what the wrapper costs the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return host


def kernel_device_us(fn, name: str):
    """Device µs of one ``fn()`` spent in kernel ``name`` (torch.profiler);
    None, said so, when three profiles in a row record no device kernel
    of that name (the profiler on that machine has once come back empty)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if e.device_type ==
                torch.autograd.DeviceType.CUDA and re.search(rf"\b{name}_kernel\b", e.key)]
        if hits:
            check(len(hits) == 1, f"profile of {name}: kernels {[e.key[:60] for e in hits]}")
            return hits[0].self_device_time_total / hits[0].count
    print(f"[times] {name}: the profiler recorded no device kernel of that name in "
          "three tries; device time not measured")
    return None


def library_kernel_name(fn) -> str:
    """The longest device kernel of one ``fn()``: which kernel a library
    call runs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0
                 and e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: -e.self_device_time_total)
    return ks[0].key[:90] if ks else "not seen"


def attention_inputs(b, s, h, hkv, d, dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(dtype)
    return q, k, v, torch.arange(s, dtype=torch.int32, device=DEV)


def time_turns(fns: dict, iters: dict) -> dict:
    """Each of ``fns`` timed twice with CUDA events over ``iters[name]``
    calls, in turns forward then backward: {name: [ms, ms]}."""
    runs = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            runs[name].append(time_ms(fns[name], iters=iters[name], warmup=1))
    return runs


def time_flash_sm90() -> dict:
    """flash_attention's bf16 route (flash_attention_sm90) at the serving
    path's shape (danube3 prefill: B=4, S=8192, H=32, Hkv=8, D=120, W=4096),
    beside its bound, the plain version (at B=1: at B=4 its float32 scores
    alone would take 34 GB), PyTorch's scaled_dot_product_attention on the
    same inputs (boolean window mask, enable_gqa; timed only, the port never
    calls it).  Each is the least of two runs timed in turns with CUDA
    events."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    cfg = serve_config()
    b, s, h, hkv, d, w = (SERVE_BATCH, SERVE_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.sliding_window)
    q, k, v, pos = attention_inputs(b, s, h, hkv, d, torch.bfloat16, 2)
    mask = ref.attention_mask(pos, pos, causal=True, window=w)
    pairs, flops, nbytes, b_ms, b_by = attention_work(q, k, v, pos, w, BF16_OPS_PER_S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"plain": lambda: ref.flash_attention_ref(q[:1], k[:1], v[:1], pos, pos,
                                                    causal=True, window=w),
           "kern1": lambda: fa.flash_attention(q[:1], k[:1], v[:1], window=w),
           "kern": lambda: fa.flash_attention(q, k, v, window=w),
           "kern_stats": lambda: fa._forward(q, k, v, pos, pos, True, w, None, stats=True),
           "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                          enable_gqa=True)}
    runs = time_turns(fns, dict(plain=2, kern1=10, kern=10, kern_stats=10, sdpa=10))
    ms = min(runs["kern"])
    host_ms = host_ms_per_call(fns["kern"], 10)
    out = fns["kern"]()                  # the path's shape, held row by row
    path_errs = [flash_check(out[i:i + 1], ref.flash_attention_ref(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], pos, pos, causal=True, window=w),
        f"at the path's shape B={b} S={s} H={h}/{hkv} D={d} W={w} bf16, row {i}")
        for i in range(b)]
    del out
    rec = {"shape": [b, s, h, hkv, d], "window": w, "dtype": "bfloat16",
           "ms": ms, "ms_runs": runs["kern"], "ms_b1": min(runs["kern1"]),
           "ms_with_stats": min(runs["kern_stats"]), "ms_with_stats_runs": runs["kern_stats"],
           "plain_ms": min(runs["plain"]), "plain_ms_runs": runs["plain"],
           "plain_at": "B=1", "library_ms": min(runs["sdpa"]),
           "library_ms_runs": runs["sdpa"],
           "library": "torch.nn.functional.scaled_dot_product_attention",
           "library_kernel": library_kernel_name(fns["sdpa"]),
           "device_us": kernel_device_us(fns["kern"], "flash_attention_sm90"),
           "host_ms": host_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
           "tflops": flops / ms / 1e9, "bound_share": b_ms / ms,
           "pairs_per_head": pairs, "max_abs_err_path": max(path_errs)}
    print(f"[times] flash_attention_sm90 B={b} S={s} H={h}/{hkv} D={d} W={w} bf16: "
          f"kernel {ms:.3f} ms (runs {runs['kern'][0]:.3f}, {runs['kern'][1]:.3f}; "
          f"device {rec['device_us']} us; at B=1 {rec['ms_b1']:.3f}; host time per "
          f"call {host_ms:.3f} ms; with the backward's statistics "
          f"{rec['ms_with_stats']:.3f} ms, runs "
          + ", ".join(f"{x:.3f}" for x in runs["kern_stats"]) + "), "
          f"{rec['tflops']:.1f} TFLOP/s, {100 * rec['bound_share']:.1f}% of the bound "
          f"{b_ms:.4f} ms by {b_by} ({flops:.4e} flops over {pairs} visible pairs per "
          f"(b, h) at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s; {nbytes} B); plain at B=1 "
          f"{rec['plain_ms']:.3f} ms; scaled_dot_product_attention "
          f"{rec['library_ms']:.3f} ms (runs {runs['sdpa'][0]:.3f}, "
          f"{runs['sdpa'][1]:.3f}; longest device kernel: {rec['library_kernel']}); "
          f"output within {FLASH_TOL[torch.bfloat16][1]} + "
          f"{FLASH_TOL[torch.bfloat16][0]:.4g} |plain| of the plain version in every "
          f"batch row, max_abs_err per row " + " ".join(f"{e:.3e}" for e in path_errs))
    return rec


def attention_work(q, k, v, pos, w, ops_per_s):
    """(visible pairs per (b, h), flops, bytes, bound ms, bound by) of causal
    attention of q over k, v with window ``w`` at positions ``pos``: 4 D
    flops per visible pair (q.k and p.v), q, k, v read once and out
    written once."""
    from repro_torch.kernels import ref
    b, _, h, d = q.shape
    pairs = int(ref.attention_mask(pos, pos, causal=True, window=w).sum())
    flops = 4 * d * pairs * b * h
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return (pairs, flops, nbytes) + bound(nbytes, flops, ops_per_s)


def time_flash_f32() -> dict:
    """flash_attention's float32 route (flash_attention.cu) at the depth-2
    float32 prefill's shape (B=1, S=5000, H=32, Hkv=8, D=120, W=4096),
    also with the backward's statistics, beside its bound (its float32
    products as three TF32 products each at 495 TFLOP/s, the least the
    card could take for them at float32 accuracy; at the FMA rate, 67
    TFLOP/s, beside it), the plain version and scaled_dot_product_attention
    in float32 on the same inputs; then the kernel alone at the serving
    prefill's shape in float32 (B=4, S=8192): there the plain version and
    SDPA's float32 path would hold 4 x 32 x 8192**2 float32 scores, 34 GB."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    cfg = serve_config()
    b, s, h, hkv, d, w = (1, CHECK_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.sliding_window)
    q, k, v, pos = attention_inputs(b, s, h, hkv, d, torch.float32, 3)
    pairs, flops, nbytes, b_ms, b_by = attention_work(q, k, v, pos, w,
                                                      TF32_OPS_PER_S / TF32_TERMS)
    fma_ms = bound(nbytes, flops, FP32_OPS_PER_S)[0]
    mask = ref.attention_mask(pos, pos, causal=True, window=w)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"plain": lambda: ref.flash_attention_ref(q, k, v, pos, pos, causal=True,
                                                    window=w),
           "kern": lambda: fa.flash_attention(q, k, v, window=w),
           "kern_stats": lambda: fa._forward(q, k, v, pos, pos, True, w, None, stats=True),
           "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                          enable_gqa=True)}
    runs = time_turns(fns, dict(plain=3, kern=10, kern_stats=10, sdpa=3))
    ms = min(runs["kern"])
    rec = {"shape": [b, s, h, hkv, d], "window": w, "dtype": "float32", "ms": ms,
           "ms_runs": runs["kern"], "ms_with_stats": min(runs["kern_stats"]),
           "ms_with_stats_runs": runs["kern_stats"], "plain_ms": min(runs["plain"]),
           "plain_ms_runs": runs["plain"], "plain_at": f"B={b}",
           "library_ms": min(runs["sdpa"]), "library_ms_runs": runs["sdpa"],
           "library": "torch.nn.functional.scaled_dot_product_attention",
           "library_kernel": library_kernel_name(fns["sdpa"]),
           "device_us": kernel_device_us(fns["kern"], "flash_attention"),
           "host_ms": host_ms_per_call(fns["kern"], 10),
           "bound_ms": b_ms, "bound_by": b_by, "bound_ms_fma": fma_ms, "bytes": nbytes,
           "flops": flops, "tflops": flops / ms / 1e9, "bound_share": b_ms / ms,
           "bound_share_fma": fma_ms / ms, "pairs_per_head": pairs,
           "smem_bytes": fa.f32_smem_bytes(d)}
    print(f"[times] flash_attention B={b} S={s} H={h}/{hkv} D={d} W={w} float32: "
          f"kernel {ms:.3f} ms (runs {runs['kern'][0]:.3f}, {runs['kern'][1]:.3f}; "
          f"device {rec['device_us']} us; host time per call {rec['host_ms']:.3f} ms; "
          f"with the backward's statistics {rec['ms_with_stats']:.3f} ms, runs "
          + ", ".join(f"{x:.3f}" for x in runs["kern_stats"]) + f"), "
          f"{rec['tflops']:.2f} TFLOP/s, "
          f"{100 * rec['bound_share']:.1f}% of the bound {b_ms:.4f} ms by {b_by} "
          f"({flops:.4e} flops as {TF32_TERMS} TF32 products each at "
          f"{TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; {nbytes} B), "
          f"{100 * rec['bound_share_fma']:.1f}% of {fma_ms:.4f} ms at the FMA rate "
          f"({FP32_OPS_PER_S / 1e12:.0f} TFLOP/s); plain {rec['plain_ms']:.3f} ms; "
          f"scaled_dot_product_attention "
          f"float32 {rec['library_ms']:.3f} ms (longest device kernel: "
          f"{rec['library_kernel']}); {rec['smem_bytes']} B of shared memory per block")
    del q, k, v, qt, kt, vt, mask, fns
    torch.cuda.empty_cache()
    b, s = SERVE_BATCH, SERVE_PROMPT
    q, k, v, pos = attention_inputs(b, s, h, hkv, d, torch.float32, 4)
    pairs, flops, nbytes, s_ms, s_by = attention_work(q, k, v, pos, w,
                                                      TF32_OPS_PER_S / TF32_TERMS)
    serve_runs = [time_ms(lambda: fa.flash_attention(q, k, v, window=w), iters=3,
                          warmup=1) for _ in range(2)]
    out = fa.flash_attention(q[:1, -256:], k[:1], v[:1], pos[-256:], pos, window=w)
    e = flash_check(out, ref.flash_attention_ref(q[:1, -256:], k[:1], v[:1], pos[-256:],
                                                  pos, window=w),
                    f"float32 at the serving shape, the last 256 queries of row 0")
    rec["serving"] = {"shape": [b, s, h, hkv, d], "ms": min(serve_runs),
                      "ms_runs": serve_runs, "bound_ms": s_ms, "bound_by": s_by,
                      "flops": flops, "tflops": flops / min(serve_runs) / 1e9,
                      "bound_share": s_ms / min(serve_runs), "pairs_per_head": pairs,
                      "max_abs_err_last_rows": e}
    print(f"[times] flash_attention B={b} S={s} H={h}/{hkv} D={d} W={w} float32 (the "
          f"serving prefill's shape, kernel only): {min(serve_runs):.3f} ms (runs "
          f"{serve_runs[0]:.3f}, {serve_runs[1]:.3f}), "
          f"{rec['serving']['tflops']:.2f} TFLOP/s, "
          f"{100 * rec['serving']['bound_share']:.1f}% of the bound {s_ms:.4f} ms by "
          f"{s_by} ({flops:.4e} flops); the last 256 queries of row 0 against the plain "
          f"version: max_abs_err {e:.2e}")
    return rec


def time_flash_bwd(dtype) -> dict:
    """The backward on ``dtype``'s route at the training path's shape
    (stablelm-1.6b, B=2, S=2048, H=Hkv=32, D=64, causal), from the
    statistics the forward saved (as FlashAttention hands them over):
    bf16 on flash_attention_bwd_sm90, float32 on flash_attention_bwd.  Its
    bound: the five S^2 D products the call needs from the saved LSE and O
    (Q K^T, dO V^T, P^T dO, dS^T Q, dS K; SDPA's backward, too, reads its
    forward's saved O and LSE), 2 D flops per visible pair each, at the
    dtype's peak (989 TFLOP/s bf16 on the tensor cores; float32 as three
    TF32 products each at 495 TFLOP/s, with the FMA rate, 67 TFLOP/s,
    beside it), against its inputs read and dq, dk, dv written once.
    Beside it the plain version and the backward of
    torch.nn.functional.scaled_dot_product_attention (is_causal; timed
    only, the port never calls it).  Least of two runs in turns.  For
    bf16 also the forward at this shape with and without the statistics,
    and what writing them costs a training round in every forward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    t = TRAIN_ATTN
    name = fa.bwd_route(dtype, DEV)
    q, k, v, pos = attention_inputs(t["b"], t["s"], t["h"], t["hkv"], t["d"], dtype, 6)
    do = torch.randn(q.shape, device=DEV).to(dtype)
    stats = fa._forward(q, k, v, pos, pos, True, None, None, stats=True)[1:]
    nbytes = (q.element_size() * (3 * q.numel() + 2 * k.numel() + 2 * v.numel())
              + sum(x.numel() * x.element_size() for x in stats))
    products = 5
    pairs = int(ref.attention_mask(pos, pos, causal=True).sum())
    flops = products * 2 * t["d"] * pairs * t["b"] * t["h"]
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32_OPS_PER_S / TF32_TERMS
    b_ms, b_by = bound(nbytes, flops, peak)
    fma_ms = bound(nbytes, flops, FP32_OPS_PER_S)[0] if dtype == torch.float32 else None
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_t = do.transpose(1, 2)
    fns = {"plain": lambda: ref.flash_attention_bwd_ref(q, k, v, do, pos, pos),
           "kern": lambda: fa.flash_attention_bwd(q, k, v, do, pos, pos, stats=stats),
           "sdpa": lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                               retain_graph=True)}
    runs = time_turns(fns, dict(plain=2, kern=5, sdpa=10))
    ms = min(runs["kern"])
    got, made = launched(fns["kern"])
    check(made == {name: 1}, f"{name} at the training shape launched {made}")
    e = flash_bwd_check(got, fns["plain"](), f"{name} at the training shape")
    rec = {"shape": [t["b"], t["s"], t["h"], t["hkv"], t["d"]], "dtype": str(dtype)[6:],
           "ms": ms, "ms_runs": runs["kern"], "plain_ms": min(runs["plain"]),
           "plain_ms_runs": runs["plain"], "library_ms": min(runs["sdpa"]),
           "library_ms_runs": runs["sdpa"],
           "library": "scaled_dot_product_attention backward (torch.autograd.grad)",
           "library_kernel": library_kernel_name(fns["sdpa"]),
           "host_ms": host_ms_per_call(fns["kern"], 5),
           "device_us": bwd_device_us(fns["kern"]),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
           "tflops": flops / ms / 1e9, "bound_share": b_ms / ms, "pairs_per_head": pairs,
           "max_abs_err_path": e, "products": products}
    if fma_ms is not None:
        rec.update(bound_ms_fma=fma_ms, bound_share_fma=fma_ms / ms)
    if dtype == torch.bfloat16:
        fwd = time_turns({"fwd": lambda: fa._forward(q, k, v, pos, pos, True, None, None),
                          "fwd_stats": lambda: fa._forward(q, k, v, pos, pos, True, None,
                                                           None, stats=True)},
                         dict(fwd=10, fwd_stats=10))
        n = 2 * train_config().n_layers * TRAIN_AGENTS * TRAIN_EPOCHS
        rec["forward"] = {"ms": min(fwd["fwd"]), "ms_runs": fwd["fwd"],
                          "ms_with_stats": min(fwd["fwd_stats"]),
                          "ms_with_stats_runs": fwd["fwd_stats"],
                          "stats_ms_per_round": n * (min(fwd["fwd_stats"])
                                                     - min(fwd["fwd"]))}
        print(f"[times] flash_attention_sm90 at the training shape: "
              f"{rec['forward']['ms']:.4f} ms without the statistics (runs "
              + ", ".join(f"{x:.4f}" for x in fwd["fwd"]) + f"), "
              f"{rec['forward']['ms_with_stats']:.4f} ms with them (runs "
              + ", ".join(f"{x:.4f}" for x in fwd["fwd_stats"]) + f"); every training "
              f"forward writes them ({n} a round, remat's first pass too): "
              f"{rec['forward']['stats_ms_per_round']:.2f} ms a round, half of it for "
              "the first pass's copy, which checkpoint drops")
    print(f"[times] {name} B={t['b']} S={t['s']} H={t['h']}/{t['hkv']} D={t['d']} causal "
          f"{rec['dtype']}: kernel {ms:.3f} ms (runs "
          + ", ".join(f"{x:.3f}" for x in runs["kern"]) + f"; host time per call "
          f"{rec['host_ms']:.3f} ms), {rec['tflops']:.1f} TFLOP/s of the bound's flops, "
          f"{100 * rec['bound_share']:.2f}% of the bound {b_ms:.4f} ms by {b_by} "
          f"({flops:.4e} flops: {products} products x 2 D x {pairs} visible pairs per "
          f"(b, h) at {peak / 1e12:.0f} TFLOP/s"
          + (f" ({TF32_TERMS} TF32 products each at {TF32_OPS_PER_S / 1e12:.0f}); at the "
             f"FMA rate ({FP32_OPS_PER_S / 1e12:.0f} TFLOP/s) {fma_ms:.4f} ms, "
             f"{100 * fma_ms / ms:.2f}%" if fma_ms is not None else "")
          + f"; {nbytes} B); plain {rec['plain_ms']:.3f} "
          f"ms; scaled_dot_product_attention backward {rec['library_ms']:.3f} ms (runs "
          + ", ".join(f"{x:.3f}" for x in runs["sdpa"]) + f"; longest device kernel: "
          f"{rec['library_kernel']}); device time by grid {rec['device_us']} us; "
          f"max_abs_err against the plain version {e:.2e}")
    return rec


def bwd_device_us(fn):
    """Device us of one ``fn()`` in each of the backward's three grids
    (flash_attention_bwd's or flash_attention_bwd_sm90's; torch.profiler),
    or None when the profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"flash_attention_bwd(?:_sm90)?_(prep|dq|dkdv)_kernel", e.key)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            out[m.group(1)] = e.self_device_time_total / e.count
    return out or None


def time_record(name, n, bits, kern, plain, iters, nbytes, ops, warmup: int = 10) -> dict:
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain), least of each, beside the bound for ``nbytes`` and ``ops``."""
    plain_ms = time_ms(plain, iters, warmup)
    ms = time_ms(kern, iters, warmup)
    ms2 = time_ms(kern, iters, warmup)
    plain_ms2 = time_ms(plain, iters, warmup)
    b_ms, b_by = bound(nbytes, ops)
    rec = {"n": n, "bits": bits, "ms": min(ms, ms2), "library_ms": None,
           "plain_ms": min(plain_ms, plain_ms2), "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes, "ops": ops,
           "bound_share": b_ms / min(ms, ms2),
           "ms_runs": [ms, ms2], "plain_ms_runs": [plain_ms, plain_ms2]}
    print(f"[times] {name:15s} n={n:9d} b={bits}: kernel {rec['ms']:.5f} ms "
          f"(runs {ms:.5f}, {ms2:.5f}), plain {rec['plain_ms']:.5f} ms, "
          f"bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {ops} ops; "
          f"{100 * rec['bound_share']:.1f}% of it); "
          "library: none, no single PyTorch call computes it")
    return rec


SOURCES = {
    "pack_bits": ("src/repro_torch/kernels/csrc/pack_bits.cu",
                  "src/repro/kernels/pack_bits.py:80"),
    "unpack_bits": ("src/repro_torch/kernels/csrc/pack_bits.cu",
                    "src/repro/kernels/pack_bits.py:107"),
    "quant_pipeline": ("src/repro_torch/kernels/csrc/quant_pipeline.cu",
                       "src/repro/kernels/compress_pipeline.py:112"),
    "quantize_ef": ("src/repro_torch/kernels/csrc/quantize_ef.cu",
                    "src/repro/kernels/quantize_ef.py:39"),
    "erasure_mask": ("src/repro_torch/kernels/csrc/erasure_mask.cu",
                     "src/repro/kernels/erasure_mask.py:77"),
    "sign_pipeline": ("src/repro_torch/kernels/csrc/sign_pipeline.cu",
                      "src/repro/kernels/compress_pipeline.py:152"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:87"),
    "flash_attention_sm90": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                             "src/repro/kernels/flash_attention.py:87"),
    # the gradient of that kernel's function: the JAX package has no Pallas
    # backward (it differentiates src/repro/models/attention.py:136 in XLA);
    # float32 on flash_attention_bwd.cu, bf16 on flash_attention_bwd_sm90.cu
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:87"),
    "flash_attention_bwd_sm90": ("src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
                                 "src/repro/kernels/flash_attention.py:87"),
}


#: seconds per phase of this run, printed as [time] before the result
PHASE_S: dict = {}


def lap(name: str) -> None:
    """Charge the time since the last lap to ``name``."""
    now = time.perf_counter()
    PHASE_S[name] = PHASE_S.get(name, 0.0) + now - PHASE_S.pop("_t", now)
    PHASE_S["_t"] = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    import atexit
    import repro_torch
    from repro_torch.kernels import ops

    atexit.register(stop_children)
    repro_torch.set_float32_precision()
    if sys.argv[1:] == ["--rwkv6-gamma"]:
        print(json.dumps(rwkv6_gamma_curves()))
        return 0
    rng = np.random.default_rng(0)
    t_start = PHASE_S["_t"] = time.perf_counter()
    smi = phase_build()
    lap("1 build")
    errors = phase_kernels(rng)
    lap("2 kernels")

    ops.reset_launch_counts()            # the first main path: phases 3 and 4
    alg, data, state, before = phase_fedlt()
    phase_wire(state)
    launches = ops.launch_counts()
    print(f"[main path] Fed-LT launches: {launches}")
    check(all(launches[k] > 0 for k in ("pack_bits", "unpack_bits",
                                        "quant_pipeline")),
          f"a kernel of the Fed-LT path never launched: {launches}")

    check_captured_round(state, before)
    check_small_against_cpu()
    lap("3-4 Fed-LT")
    phase_constellation(launches)        # counts zeroed before each run
    lap("5 constellation")
    canonical = phase_canonical()
    lap("6 canonical")
    _, lossy_chains = phase_transport(launches)   # counts zeroed per chain run
    lap("7 transport")
    for k, v in phase_sign_entry(state, before).items():   # zeroed before
        launches[k] += v
    lap("8 sign entry")
    phase_codecs(rng)                    # kernel checks, not a main path
    lap("11 codecs")
    table2 = phase_table2(launches)      # counts zeroed before each cell
    lap("12 table 2")
    phase_example_fedavg(launches)       # zeroed before the run
    lap("13 example")
    gate = start_convgate(canonical)     # runs beside phases 14 and 15
    resume = phase_resume(launches)      # zeroed before each resumed run
    lap("14 resume")
    ledger = phase_ledger_tables(launches, resume["quant"]["trace"])  # per table
    lap("15 ledger tables")
    convgate = phase_convgate(gate)
    lap("16 convgate")
    serve, (params, cfg, prompts) = phase_serve(launches)  # zeroed per step
    lap("9 serve")

    phase_profile(lambda: alg.run(state, data, 5), 5, "Fed-LT")
    from repro_torch.api import Experiment
    from repro_torch.examples import satellite_constellation as ex
    c_data, c_xbar, c_quant, c_algs = ex.setup(DEV)
    for name in ("Fed-LTSat", "FedAvg(space)"):     # the example's two arms
        c_alg = c_algs[name]
        c_exp = Experiment.from_scenario("walker-kiruna", algorithm=c_alg,
                                         compressor=c_quant, measure="cohort",
                                         device=DEV)
        run_experiment(None, c_alg, c_quant, c_data, c_xbar, 5, 2, exp=c_exp)  # plan
        phase_profile(lambda: run_experiment(None, c_alg, c_quant, c_data, c_xbar,
                                             5, 2, exp=c_exp),
                      5, f"{name} walker-kiruna")
    phase_profile(lossy_chains, 3, "mega-1000-lossy chains, fused + unfused")
    from repro_torch.bench import table_lossy_ef
    phase_profile(lambda: table_lossy_ef.run(
        [0.2], rounds=20, verbose=False, device=DEV,
        ledger_path=str(BUILD / "ledger_profile.jsonl")), 60,
        "lossy table at p=0.2, 3 arms x 20 rounds (with its set-up)")
    profile_serve(params, cfg, prompts)
    del params, prompts
    torch.cuda.empty_cache()
    lap("10 profiles")
    serve["f32_rel_l2"] = check_serve_f32(launches)      # zeroed per prefill
    torch.cuda.empty_cache()
    lap("9 serve")
    train, train_state = phase_train(launches)        # zeroed before the launcher
    lap("17a train")
    train["packed"] = phase_train_packed(train_state, launches)   # zeroed before
    lap("17b packed round")
    profile_train(train_state)
    del train_state
    torch.cuda.empty_cache()
    lap("10 profiles")
    train["f32"] = phase_train_f32(launches)          # zeroed per round
    torch.cuda.empty_cache()
    lap("17c train float32")
    families = phase_families(launches)   # zeroed per run; laps of its own
    catalog = phase_catalog(launches, errors)   # zeroed per run; laps of its own
    launch = phase_launch(launches)      # zeroed per run
    lap("20 launch")
    configs = phase_configs(launches, errors)   # zeroed per run; laps of its own
    print(f"[main path] launches over every main-path run: {launches}")
    check(all(launches[k] > 0 for k in SOURCES), f"a kernel of the paths never "
          f"launched: {launches}")
    bench = phase_bench()                # counts zeroed; not a main path
    lap("18 bench")
    times = phase_times(rng)
    lap("10 times")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        main_rec = times[name][0]
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errors[name], "ms": main_rec["ms"],
               "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
               "bound_by": main_rec["bound_by"],
               "library_ms": main_rec["library_ms"],
               "ptxas": [e for e in PTXAS.get(Path(source).name, [])
                         if re.fullmatch(rf"{name}(32|_prep|_dq|_dkdv)?_kernel",
                                         e["entry"].split("<")[0])]}
        if name.startswith("flash_attention"):
            rec.update({k: v for k, v in main_rec.items() if k not in rec and not
                        k.endswith("_runs")})
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     main_rec.get("max_abs_err_path", 0.0))
        else:
            big_rec = times[name][1]
            rec.update(n=main_rec["n"], bits=main_rec["bits"],
                       at_2p24={k: v for k, v in big_rec.items() if k in (
                           "ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
                           "device_us") or k.startswith("bound_ms_two_pass")})
            if name in ("quant_pipeline", "sign_pipeline"):
                rec["at_2p24_bf16"] = {k: v for k, v in times[f"{name}_bf16"].items()
                                       if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "bound_share", "bound_ms_two_pass")}
            if name in ("pack_bits", "quantize_ef"):     # redesigned: the leaf's shape
                keep = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share", "dtype")
                keep += ("device_us",)
                rec.update(shape=main_rec["shape"], dtype=main_rec["dtype"],
                           host_us_cohort=main_rec["host_us_cohort"],
                           device_us_cohort=main_rec["device_us_cohort"],
                           at_2p24_narrow={k: v for k, v in times[name][2].items()
                                           if k in keep})
                if name == "quantize_ef":
                    rec["no_cache"] = {k: v for k, v in times[name][3].items() if k in keep}
        kernels.append(rec)
    print(f"[serve] summary: {json.dumps(serve)}")
    print(f"[train] summary: {json.dumps(train)}")
    print(f"[families] summary: {json.dumps(families)}")
    print(f"[catalog] summary: {json.dumps(catalog)}")
    print(f"[launch] summary: {json.dumps(launch)}")
    print(f"[config] summary: {json.dumps(configs)}")
    print(f"[table2] summary: {json.dumps(table2)}")
    print(f"[resume] summary: {json.dumps(resume)}")
    print(f"[ledger] summary: {json.dumps({k: {f: v for f, v in rec.items() if f != 'rows'} for k, rec in ledger.items()})}")
    print(f"[convgate] summary: {json.dumps(convgate)}")
    print(f"[bench] summary: {json.dumps(bench)}")
    PHASE_S.pop("_t")
    print(f"[time] seconds by phase: "
          f"{', '.join(f'{k} {v:.1f}' for k, v in PHASE_S.items())}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)                          # again, beside the numbers it qualifies
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
