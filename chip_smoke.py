#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, holds each
against its plain PyTorch version at its paths' shapes (``qdist_windows``
also past its one-pass width, at D 4,096, 7,168 and 18,432), runs the kernel
microbenchmark (phase ``kernel_bench``: ``repro_torch.benchmarks.
kernel_bench``, the path of the dense Hamming and dense ADC kernels),
checks that a build, a Task-2 graph and a streamed LSM index on the card
equal those on the CPU, then drives the paths at full width on
3,000,000 x 384 points:

* Task 1: ``HilbertIndex.build`` with the README quickstart configuration
  and ``.search`` of 8192 queries; recall@30 against exact ground truth,
  the kernel route against the plain route, save -> load -> search.
  Between the build and the search, phase ``stage1_step`` holds
  ``hamming_rows_indexed`` on master positions of one tree's real
  candidates (k1 of the search and of Table 1's mean rows) and on one
  Task-2 merge chunk, and times stage 1's Hamming step both ways: gather
  the candidates' sketches, then the pre-gathered launch, against the
  launch that reads them from the resident table; then phase
  ``stage2_step`` holds
  ``qdist_windows_rows`` on starts from real stage-1 results of the index
  (the engine's pool and Table 1's 120-tree mean pool) and times stage 2's
  distance step both ways: gather the windows, then the pre-gathered
  launch, against the launch that reads the windows from the codes.
* The paper's Table 1 (phase ``table1``: ``repro_torch.benchmarks.
  task1_table1``): its 16 rows (160 and 120 trees of the PUBMED23 forest,
  k1 up to 4000) on the first 125,000 points and the first 2048
  queries, one timed search a row after a warm-up search a forest, scored
  against their exact neighbours among those points.
* LSM (phase ``lsm``): ``MutableHilbertIndex`` with the same forest and
  stored points bulk-loads 2,500,000 rows as one segment, then streams the
  other 500,000 rows in inserts of 4096 with 0.5 % deletes and a
  2048-query search every 65,536 rows (seals and tier merges); recall@30
  beside a fresh build's, ``compact()`` bit-equal to a fresh build over
  the live points; then on the first 262,144 rows a bulk load, save, WAL,
  a stream with deletes, save -> load and WAL replay bit-equal.
* Serving engine (phase ``engine``): ``RetrievalEngine`` over a
  ``MutableHilbertIndex`` with the LSM forest (buffer 65,536, up to 16
  segments, no WAL) bulk-loaded with 2,500,000 rows, two serve threads,
  background maintenance (compaction on a thread) and a ``MetricsServer``,
  as ``benchmarks/serving.py``'s ``run_phase`` drives it: three windows of
  4 client threads sending 256-query requests — ``baseline`` (20
  requests, no writes), ``churn_maintained`` (a writer inserts 4096 rows
  every 0.25 s and deletes the batch it inserted two batches before; at
  least 40 requests and 2 swaps, at most 80 s) and ``probe`` (tracing
  on, a 25 % recall probe held to an offline exact evaluation, 30
  requests).  Then a last forced maintenance: every acknowledged,
  undeleted id is live and no other, and a 2048-query search equals a
  fresh build over the live points bit for bit; ``/metrics``,
  ``/metrics.json`` and ``/trace`` are scraped over HTTP.  Device memory
  allocated after the phase's cleanup must be within 1 GiB of its value
  before (phase ``engine_memory``).
* Task 2: ``HilbertIndex.build`` with the GOOAQ forest and
  ``.knn_graph(gooaq.TABLE2[0])`` (80 orders, k1 96, k2 60, k 15);
  recall@15 of 10,000 sampled rows against exact neighbours.
* The sharded layout on 4 logical shards of the card: after Table 1,
  phase ``sharded`` builds ``ShardedHilbertIndex`` with the Task-1
  configuration and searches the 8192 queries with the tree merge and
  the gather merge, the first 2048 with the pruned tree and unmerged
  (recall@30 beside the
  single index's; tree and gather with bit-equal sorted distances, the
  prune bit-equal to the tree), then phase ``sharded_bundles`` saves,
  reloads and reshards to one shard a 262,144-row sharded index
  (bit-equal; the reshard bit-equal to a ``HilbertIndex`` build).  After
  Task 2, phase ``sharded_task2_parity`` holds
  ``distributed_knn_graph`` on 4 shards bit-equal to 1 shard on 262,144
  rows over 4 orders, phase ``sharded_halo_kernel`` holds the halo
  windows' ``hamming_rows_indexed`` launches at the full graph's shape
  (4 x 1.5M rows, k1 96) equal to the plain version on the same tables,
  and phase ``sharded_task2`` runs the graph on all rows with
  ``gooaq.TABLE2[0]``: overflow 0, recall@15 of Task 2's sampled rows
  beside the single-device graph's; phase ``sharded_task2_profile`` times
  one order's stages and profiles it.

* The sharded streaming layout on 4 logical shards, after phase
  ``engine``: phase ``sharded_lsm`` runs ``ShardedMutableHilbertIndex``
  with the LSM forest (a write buffer of 16,384 rows a shard, at most 4
  generations): bulk load 2,500,000 rows, stream 500,000 in inserts of
  4096 with a 0.5 % delete every 65,536 rows and a 2048-query search
  every 262,144 and at the end (one ``sharded_lsm_round`` line each),
  recall@30 over the
  live set, ``compact()`` bit-equal to a fresh ``ShardedHilbertIndex``
  build over the live rows; phase ``sharded_lsm_bundles`` saves a
  262,144-row one (format 4), streams more under its WAL, reloads it
  with WAL replay (bit-equal), reshards it to 2 shards on load (equal to
  a fresh 2-shard build) and degrades it to a ``MutableHilbertIndex``
  (equal to a ``HilbertIndex`` build); phase ``sharded_engine`` serves
  phase ``sharded_lsm``'s compacted index through ``RetrievalEngine``
  under a writer, background maintenance and a 25 % recall probe (at
  least one swap, from a maintenance cycle forced at the window's start;
  online recall within 0.02 of an offline evaluation; a last forced
  maintenance equal to a fresh sharded build; device memory checked as
  in ``engine_memory``).

* The kNN-LM serving path, last (``repro_torch.launch.serve``'s
  functions, gemma3_1b at its published widths, random weights from
  ``--seed``): phase ``lm_device_parity`` holds the smoke config's
  forward, prefill and decode (fp32) and the scheduler's tokens on the
  card to the CPU; phase ``lm_full_width`` checks ``param_count()`` and a
  prefill of 1,016 tokens plus 8 decode steps against the forward pass
  (fp32, 2 x 1,024 tokens); phase ``knn_lm`` builds a datastore of the
  hidden states of 512 sequences of 2,049 tokens (1,048,576 keys x 1152)
  and decodes 16 prompts of 1,024 tokens for 32 steps with a lookup a
  step and churn every 4 (the kernel route equal to the plain route on
  every step's hidden states, mixed rows summing to 1, recall@8 against
  exact top-8 on every 4th step), then 16
  steps through ``serving_engine`` and a forced ``compact()``; phase
  ``knn_lm_sharded`` builds the same keys on 4 logical shards, decodes 4
  steps, saves and loads a store of the first 131,072 keys on 4 shards
  and on 1, and serves a static 4-shard index through
  ``RetrievalEngine`` (bit-equal to a direct search); phase
  ``scheduler`` runs ``ContinuousBatchingEngine`` (8 slots, 16 requests
  of 64-1,024 prompt tokens, 32 new each) sampling through
  ``knn_lm_mix``.

* Training and MoE (``repro_torch.train``, ``repro_torch.launch.train``;
  no kernel of the port is on this path): phase ``train_device_parity``
  holds 3 train steps of 2 microbatches of the gemma3_1b and
  granite_moe_1b smoke configs (fp32) on the card to the CPU (losses and
  grad norms within 1e-5 relative, parameters and moments within 1e-5 /
  1e-6); phase ``train_full_width`` trains gemma3_1b at its published
  widths in bf16 with remat "minimal" for 8 steps of 8 x 1,024 tokens (ms
  a step, tokens/s, the model FLOPs over the dense bf16 peak, peak memory;
  the loss must fall); phase ``moe_full_width`` runs granite_moe_1b at its
  published widths: a fp32 forward of 2 x 1,024 tokens with prefill and
  decode against it at a drop-free capacity, 8 bf16 train steps at the
  published capacity 1.25, and the scheduler serving the trained weights.
  Beside these three, phase ``train_resume`` trains gemma3_1b's widths at
  2 layers in a child process under deterministic algorithms, saves its
  state with ``AsyncCheckpointer`` (4.3 GB), restores it and requires the
  resumed losses bit-equal, and phase ``train_resume_cli`` runs ``python
  -m repro_torch.launch.train --smoke`` and resumes it.
  ``chip_train_profile.py`` profiles a train step of both full-width cells.

* The rest of the model zoo, last (Mamba-2, the hybrid, the
  encoder-decoder and the VLM; random weights from ``--seed``, random
  frames and patches): phase ``family_device_parity`` holds the four smoke
  configs' forward, prefill and 4 decode steps (fp32) on the card to the
  CPU, and 3 train steps of mamba2_780m and whisper_small as
  ``train_device_parity`` does; phase ``ssm_full_width`` runs
  mamba2_780m at its published widths (a fp32 forward of 2 x 1,024 with
  prefill and decode against it, 8 bf16 train steps of 8 x 1,024 tokens
  with the SSD's FLOPs in the MFU, the scheduler serving the trained
  weights); phase ``hybrid_full_width`` runs jamba_v01_52b's widths cut to
  one pattern block of 8 layers (a fp32 forward at drop-free capacity
  with prefill and decode against it, then a kNN-LM store of 65,536 keys x
  4,096 and 4 prompts decoded for 8 steps with a lookup each: kernels 1-3
  at D 4,096, the kernel route equal to the plain route); phase
  ``encdec_full_width`` runs whisper_small at its published widths with
  1,500 frames (forward, prefill and decode; 8 bf16 train steps); phase
  ``vlm_full_width`` runs llava_next_34b's widths cut to 8 of 60 layers on
  4,096 tokens whose first 2,880 are patches (forward, prefill, decode).

* The distribution layer, after the zoo (``repro_torch.sharding``,
  ``launch/shardings.py``, ``launch/dryrun.py``; no kernel is on it): phase
  ``moe_ep`` spawns 4 ranks on the one card, which form their gloo group
  through ``launch/multihost.py``'s ``bootstrap`` as the processes of one
  host (the world of 4 is checked), and runs the expert-parallel MoE
  (``moe_forward_ep``) with the dense layers replicated, each check held within 1e-4 / 1e-5 of a single-process run
  on the card in fp32: mixtral_8x22b's MoE layer at its published widths
  (2 of 8 experts a rank, 2.4 GB) on a (1, 4) mesh, then granite_moe_1b at
  full depth and width (8 of 32 experts a rank) on (1, 4) and (2, 2): its
  logits, train_loss and every gradient; the (2, 2) case with
  ``fsdp="data"`` runs where a probe's functional all-gather over gloo on
  CUDA tensors returns right.  Phase ``dryrun_on_card`` holds the dry
  run's peak bytes and FLOPs of granite_moe_1b's train step at the smoke's
  shape on a (1, 1) fake mesh (computed in a child process beside the
  training phases) to ``torch.cuda.max_memory_allocated`` (within 20 %)
  and ``FlopCounterMode`` (within 10 %) of the real step.

Before them, phase ``device_parity_engine`` runs the same engine
operations on the CPU and on the card at 6,000 rows (step-mode searches,
writes, a forced maintenance in a thread and in a compactor child on the
same device): state bit-equal between devices and modes; and phase
``sharded_device_parity`` builds a 4-shard index on both devices at
6,000 rows: state bit-equal, each merge and the unmerged search within
the distance contract, save -> load bit-equal, the 4 -> 1 reshard's state
bit-equal across devices; and phase ``sharded_lsm_device_parity`` streams
a 4-shard ``ShardedMutableHilbertIndex`` on both devices (seals, tier
merges, deletes reaching buffered rows, a read-triggered rewrite,
``compact()``) with its state bit-equal across devices after each stage.

Each phase prints one JSON line; the line before the last is the kernel
table, the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises and the script exits non-zero.  Without a GPU, or run from a
directory without ``src/repro_torch``, it prints no result and exits 2.

    python3 chip_smoke.py [--n 3000000] [--queries 8192] [--seed 0]
                          [--recall-floor 0.50] [--task2-orders 80]
                          [--task2-recall-floor F]

The LSM phase bulk-loads the first 5/6 of ``--n`` and streams the rest;
``--queries`` must be at least 6144 (2048 searched, 4096 inserted as the
WAL tail).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Distance contract of tests/test_kernels_integration.py.
DIST_RTOL = 1e-5
DIST_ATOL = 1e-6
TIE_ATOL = 1e-4

# recall@30 floor of the full-width run at --seed 0: the first full run on
# an H100 measured 0.5327 (PERF.md); the margin covers another torch
# release drawing other random numbers from the same seed.
RECALL_FLOOR = 0.50

# recall@15 floor of the full-width Task-2 graph at --seed 0, 80 orders:
# the first full run on an H100 measured 0.887 (PERF.md); the margin
# covers another torch release drawing other random numbers.
TASK2_RECALL_FLOOR = 0.85
TASK2_RECALL_ROWS = 10_000  # sampled rows of the exact recall@15 check

# The LSM phase: the README quickstart forest with stored points (which
# compaction re-sorts) and pow2 seals, a write buffer of 65,536 rows and
# at most 4 segments, so the 500,000 streamed rows seal 7 times and force
# tier merges; rounds of 65,536 inserted rows, each followed by deleting
# 0.5 % of the live ids and a search of 2048 queries, as a serving engine
# that expires entries runs it (benchmarks/churn.py's insert/expire/search).
LSM_BUFFER = 1 << 16
LSM_MAX_SEGMENTS = 4
LSM_BATCH = 4096  # rows per insert call
LSM_DELETE = 0.005  # share of the live ids deleted per round
LSM_QUERIES = 2048
LSM_TAIL = 4096  # rows inserted after the last save (the WAL tail)
LSM_TAIL_DELETES = 1000
# Its save -> load and WAL replay checks run on the first rows (a cut of
# depth, as the sharded phases' bundles: at 3,000,000 rows the bundle I/O
# took ~80 s of the phase).
LSM_PERSIST_ROWS = 262_144

# The serving engine (phase ``engine``): benchmarks/serving.py's run_phase
# on the LSM configuration at this card's size — one bulk segment, a write
# buffer of 65,536 rows and up to 16 segments, no WAL; maintenance when
# more than 4 segments, half the ids dead, or a segment tombstoned past
# its stage-2 pool; two serve threads and 4 clients sending 256-query
# requests; a writer inserting 4096 rows every 0.25 s and deleting the
# batch it inserted two batches before (a seal about every 4 s).
ENGINE_BUFFER = 1 << 16
ENGINE_MAX_SEGMENTS = 16
ENGINE_CLIENTS = 4
ENGINE_REQUEST = 256  # queries per request
ENGINE_WRITE_BATCH = 4096
ENGINE_WRITE_PAUSE_S = 0.25
# Window depths, cut to pay for the sharded streaming phases: baseline
# 100 -> 20 requests, churn 400 -> 40 requests (it still ends only at 2
# swaps, or at the cap), probe 50 -> 30.
ENGINE_BASELINE_REQUESTS = 20
ENGINE_CHURN_REQUESTS = 40
ENGINE_CHURN_SWAPS = 2
ENGINE_CHURN_CAP_S = 80.0
ENGINE_PROBE_REQUESTS = 30
ENGINE_PROBE = dict(fraction=0.25, seed=0)
ENGINE_RECALL_TOL = 0.02  # online vs offline recall (repro's own criterion)
ENGINE_CHECK_QUERIES = 2048
# Series the scrape must find (scripts/metrics_smoke.py's CORE_SERIES).
ENGINE_SERIES = [
    "engine_admitted_total", "engine_completed_total", "engine_batches_total",
    "engine_swaps_total", "engine_maintenance_runs_total", "engine_recall_at_k",
    "engine_recall_samples_total", "engine_segments", "engine_queue_depth",
    "engine_request_ms", "engine_queue_wait_ms", "index_dispatches_total",
    "index_recompiles_total",
]

# Phase table1: the paper's 16 Table-1 rows (repro_torch.benchmarks.
# task1_table1) over the corpus, on this many of the queries: one query
# chunk, so fewer queries would save no time on a launch-bound search.
TABLE1_QUERIES = 2048
# Its rows (a cut of depth from the corpus's 3,000,000: 1,000,000 to pay
# for the kNN-LM phases, 500,000 for the rest of the model zoo, 125,000 for
# the distribution phases): the first TABLE1_ROWS, with their own exact
# neighbours.
TABLE1_ROWS = 125_000
TABLE1_TIMED_SEARCHES = 1  # a row; the module's default of 3 took ~100 s more
CHUNK_QUERIES = 2048  # one query chunk: the bundle checks' queries

# Device memory the engine phase may leave allocated after its cleanup.
ENGINE_RETAINED_GIB = 1.0

KERNEL_REPS = 20  # timed runs per kernel (after warm-up)
# The windows kernel past its one-pass width (D > 3,200): the zoo's wider
# d_model (granite_3_8b and jamba, yi and llava, nemotron), checked on a
# few queries (the plain version builds (Q, C, D) at once) and timed at the
# engine's pool over a kNN-LM store's worth of rows.
WIDE_DIMS = (4096, 7168, 18432)
WIDE_CHECK_QUERIES = 8
WIDE_ROWS = 1 << 16
# Rows of the cuda-vs-cpu checks (cut from 20,000 to pay for the kNN-LM
# phases, from 10,000 for the distribution phases), and the write buffers
# that keep every stage they check firing at that size: seals, tier
# merges, a read-triggered rewrite.
PARITY_ROWS = 6_000
PARITY_BUFFER = 512  # device_parity_lsm, device_parity_engine (1024 at 10,000)
PARITY_SHARD_BUFFER = 128  # sharded_lsm_device_parity, a shard (256 at 10,000)
MERGE_CHUNK = 1 << 16  # rows of one Task-2 merge pass (knn_graph's default)

# Table 1's kernel shapes (pubmed23.TABLE1, 2048 queries a search): stage 1
# at the mean k1 of the 160-tree rows (1255) and of the 120-tree rows
# (2425); stage 2 at the mean pool (2h + 1) k2 (5 x 335 and 5 x 975).
TABLE1_HAMMING_SHAPES = ((2048, 1255, 12), (2048, 2425, 12))
TABLE1_QDIST_SHAPES = ((2048, 1675, 384), (2048, 4875, 384))
# Stage 2's distance step (phase stage2_step) on stage-1 positions of the
# Task-1 index: (k1, k2) of the engine's pool (the README's 48, 384) and of
# Table 1's 120-tree mean pool (2425, 975), h 2, one query chunk of 2048.
STAGE2_STEPS = ((48, 384), (2425, 975))
STAGE2_H = 2
# Stage 1's Hamming step (phase stage1_step) on candidates of the Task-1
# index: one tree's master positions for one query chunk at the search's
# k1 and Table 1's mean k1 of its 160- and 120-tree rows; and one Task-2
# merge chunk at gooaq.TABLE2[0]'s k1.
STAGE1_K1 = (48, 1255, 2425)
TASK2_K1 = 96

# The sharded layout (phases sharded_device_parity, sharded, sharded_task2):
# S logical shards of the card.  Its save -> load and reshard checks, and
# the S-shards-against-one check of the sharded graph, run on the first
# SHARDED_CHECK_ROWS rows (a cut of depth), the latter over
# SHARDED_TASK2_PARITY_ORDERS orders.
SHARDS = 4
SHARDED_CHECK_ROWS = 262_144
# Queries of phase sharded's timed pruned and unmerged searches (cut from
# all 8192; the tree and gather merges keep every query).
SHARDED_CUT_QUERIES = 2048
SHARDED_TASK2_PARITY_ORDERS = 4
# recall@15 of the sharded graph: scripts/distributed_check.py's criteria,
# above 0.5 and within 0.05 of the single-device graph.
SHARDED_TASK2_RECALL_FLOOR = 0.5
SHARDED_TASK2_RECALL_TOL = 0.05
HALO_CHECK_ROWS = 1 << 18  # rows a pass of the halo kernel's plain check

# The sharded streaming layout (phases sharded_lsm_device_parity,
# sharded_lsm, sharded_lsm_bundles, sharded_engine): the LSM cell on SHARDS
# logical shards, its 65,536 rows of write buffer split over the shards;
# one 2048-query search every SHARDED_LSM_SEARCH_EVERY rows and at the end
# (a cut of depth against the LSM phase's one every LSM_BUFFER rows).  The engine window runs until at
# least SHARDED_ENGINE_REQUESTS requests, one swap and SHARDED_ENGINE_KEPT
# probed batches, at most SHARDED_ENGINE_CAP_S; a maintenance cycle forced
# at its start makes the swap fall inside it.
SHARDED_LSM_BUFFER = LSM_BUFFER // SHARDS
SHARDED_LSM_SEARCH_EVERY = 1 << 18
SHARDED_ENGINE_REQUESTS = 10
SHARDED_ENGINE_CAP_S = 90.0
SHARDED_ENGINE_KEPT = 1  # batches the probe keeps before the window may end

# The kNN-LM serving path (phases lm_device_parity, lm_full_width, knn_lm,
# knn_lm_sharded, scheduler): gemma3_1b at its published widths with
# random weights from --seed (the published weights are not in the repo),
# repro.launch.serve's retrieval settings (serve.SEARCH, lambda 0.25).
LM_ARCH = "gemma3_1b"
LM_PARITY_RTOL, LM_PARITY_ATOL = 1e-4, 1e-5  # CPU vs card, fp32, TF32 off
LM_PARITY_LENS = (9, 5, 12, 7, 10)  # the scheduler check's ragged prompts
LM_DECISIVE_GAP = 2e-2  # argmax compared where top-1 leads by more
LM_FULL_SEQS, LM_FULL_LEN, LM_FULL_PREFILL = 2, 1024, 1016  # crosses window 512
LM_FULL_TOL = 2e-2  # test_models_smoke.py's prefill-then-decode tolerance
KNN_CORPUS = (512, 2049)  # sequences x tokens: 512 x 2048 = 1,048,576 keys
KNN_FORWARD_BATCH = 16  # sequences a forward pass of the datastore build
KNN_PROMPTS = (16, 1024)
KNN_STEPS = 32  # decode steps with lookups and churn every 4 (a cut of depth from 64)
KNN_ENGINE_STEPS = 16  # decode steps through serving_engine
KNN_SHARDED_STEPS = 4  # a cut of depth from 16, then 8 (1.2-1.8 s a step)
KNN_RECALL_EVERY = 4  # decode steps between recall checks (a cut of depth from 1)
KNN_BUNDLE_ROWS = 1 << 17  # the sharded store's save/load checks (a cut of depth)
KNN_MIX_TOL = 1e-3  # each row of the mixed distribution sums to 1
LM_LAM = 0.25
SCHED_SLOTS, SCHED_MAX_SEQ = 8, 2048
SCHED_REQUESTS, SCHED_PROMPT, SCHED_NEW = 16, (64, 1024), 32  # 24 before (depth)

# Training and MoE (phases train_device_parity, train_full_width,
# moe_full_width, train_resume): gemma3_1b and granite_moe_1b at their
# published widths with random weights from --seed, repro.launch.train's
# optimizer settings with 8 steps (12 for gemma3_1b before the zoo's
# phases), the token pipeline's Zipf + motif stream.
TRAIN_PARITY_ARCHS = ("gemma3_1b", "granite_moe_1b")  # smoke configs, fp32
TRAIN_PARITY_STEPS, TRAIN_PARITY_BATCH = 3, (4, 32)
TRAIN_PARITY_RTOL = 1e-5  # losses and grad_norm, CPU vs card, TF32 off
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 1e-5, 1e-6  # params, m and v after the steps
# AdamW divides m by sqrt(v): an entry whose gradient sums to about zero
# (rounding noise, different on each device) moves by up to lr times an O(1)
# factor (an H100 against the CPU at lr 1e-3: 2.1e-5 on 2 of gemma3's
# 32,768 embedding entries), so the parity run's lr keeps that under
# TRAIN_PARAM_ATOL.
TRAIN_PARITY_LR = 1e-5
TRAIN_BATCH = (8, 1024)  # sequences x tokens a step (past gemma3's 512 window)
TRAIN_MICRO = 2
TRAIN_LR = 1e-3
TRAIN_FULL_STEPS = 8
MOE_ARCH = "granite_moe_1b"
MOE_FULL_TOL = (1e-4, 1e-5)  # prefill / decode vs forward, fp32, drop-free capacity
MOE_TRAIN_STEPS = 8
MOE_SCHED_SLOTS, MOE_SCHED_MAX_SEQ = 4, 512
MOE_SCHED_REQUESTS, MOE_SCHED_PROMPT, MOE_SCHED_NEW = 8, (32, 256), 8
RESUME_LAYERS = 2  # gemma3_1b's widths, 2 of its 26 layers: a 4.3 GB state file
# The rest of the zoo (phases family_device_parity, ssm_full_width,
# hybrid_full_width, encdec_full_width, vlm_full_width): published widths,
# random weights from --seed, depth cut where one card cannot hold the
# model (jamba's 32 layers are 103 GB in bf16; llava's 60 are 69 GB).
ZOO_ARCHS = ("mamba2_780m", "jamba_v01_52b", "whisper_small", "llava_next_34b")
ZOO_TRAIN_PARITY_ARCHS = ("mamba2_780m", "whisper_small")
ZOO_TRAIN_STEPS = 8
SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH, VLM_ARCH = ZOO_ARCHS
HYBRID_LAYERS = 8  # one pattern block: 13,267,597,952 parameters, 53 GB in fp32
HYBRID_KNN_CORPUS = (32, 2049)  # 65,536 keys x 4,096
HYBRID_KNN_FORWARD_BATCH = 2
HYBRID_KNN_PROMPTS = (4, 1024)
HYBRID_KNN_STEPS = 8
VLM_LAYERS = 8  # of 60: 5,387,705,344 parameters, 21.6 GB in fp32
VLM_LEN = 4096  # its first 2,880 positions are the patches
# Prefill + decode against the forward at full width, fp32: rtol 1e-4 and an
# atol of 5e-4 of the logits' largest magnitude.  Two fp32 evaluation orders
# of a deep or wide random model drift apart past 1e-5: on an H100, over 8
# decode steps, mamba2_780m's 48 layers by 4.6e-4 (logits up to 4.2),
# jamba's block by 4.8e-4 (7.6), llava's 8 layers at d 7,168 by 8.5e-5
# (10.8); whisper_small's by 3.6e-6.  chip_ssd_drift.py shows no path off:
# at 4 layers the forward, prefill + decode and the recurrence from
# position 0 agree within 1.7e-5 of one another.
ZOO_FULL_RTOL, ZOO_FULL_ATOL_OF_SCALE = 1e-4, 5e-4
RESUME_AT, RESUME_STEPS = 2, 4
H100_BF16_DENSE_FLOPS = 989e12  # NVIDIA H100 SXM data sheet, dense bf16, 700 W
# The distribution layer (phases moe_ep and dryrun_on_card).  moe_ep: four
# ranks on the one card over gloo (NCCL takes one card a rank) run the
# expert-parallel MoE with the dense layers replicated (EP alone: the
# experts' all-reduces are then its only collectives), each held to a
# single-process run on the same card in fp32.
MOE_EP_RANKS = 4
MOE_EP_LAYER_ARCH = "mixtral_8x22b"  # its MoE layer at published widths, mesh (1, 4)
MOE_EP_LAYER_TOKENS = (2, 512)
MOE_EP_TOKENS = (2, 256)  # granite_moe_1b's batch, two rows a data rank at (2, 2)
MOE_EP_MESHES = ((1, 4, None), (2, 2, None), (2, 2, "data"))  # (data, model, fsdp)
MOE_EP_TOL = (1e-4, 1e-5)
# dryrun_on_card: the dry run of granite_moe_1b's train step at the smoke's
# shape on a (1, 1) fake mesh against the real step on the card.
DRYRUN_PEAK_TOL, DRYRUN_FLOPS_TOL = 0.20, 0.10


def kernel_fns():
    """The kernel wrappers of the port, by name (each counts its launches)."""
    from repro_torch.kernels.bitpack import pack_bits
    from repro_torch.kernels.hamming import hamming_matrix, hamming_rows
    from repro_torch.kernels.qdist import qdist, qdist_from_packed, qdist_windows

    return {"hamming_rows": hamming_rows, "qdist_windows": qdist_windows,
            "pack_bits": pack_bits, "hamming_matrix": hamming_matrix,
            "qdist": qdist, "qdist_from_packed": qdist_from_packed}


def reset_launches() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def read_launches(torch) -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in kernel_fns().items()}


def require_launched(path: str, launches: dict, names) -> None:
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels {missing} of the path were not "
                             f"launched: {launches}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def assert_ids_equal_up_to_ties(ids_ref, ids_got, d_ref) -> int:
    """Mismatched ids must sit inside a run of reference distances tied
    within TIE_ATOL.  Returns the number of mismatched positions."""
    import numpy as np

    ids_ref, ids_got, d_ref = (np.asarray(a) for a in (ids_ref, ids_got, d_ref))
    rows, cols = np.nonzero(ids_ref != ids_got)
    for r, c in zip(rows, cols):
        tied = np.isclose(d_ref[r], d_ref[r, c], atol=TIE_ATOL)
        if ids_got[r, c] not in set(ids_ref[r, tied].tolist()):
            raise AssertionError(
                f"row {r} col {c}: id {ids_got[r, c]} not among ids tied at "
                f"{d_ref[r, c]} (reference id {ids_ref[r, c]})")
    return len(rows)


def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(out, flush=True)


def phase_build(build_mod):
    t0 = time.perf_counter()
    per_source = build_mod.build()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in build_mod.build_log(name).splitlines()
               if "registers" in ln or "spill" in ln]
        for name in build_mod.SOURCES
    }
    emit({"phase": "build", "seconds": seconds, "per_source": per_source,
          "ptxas": ptxas})


def phase_kernel_parity(torch, reps: int):
    """Every kernel against its plain version at its paths' shapes and a
    ragged one; returns the table rows of kernels 1-3 (times included)
    and the largest errors of kernels 4-6."""
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.benchmarks.kernel_bench import bound, median_ms, sketch_bits
    from repro_torch.core.quantize import pack_codes
    from repro_torch.kernels.bitpack import pack_bits, pack_bits_ref
    from repro_torch.kernels.hamming import (hamming_matrix, hamming_matrix_ref,
                                             hamming_rows, hamming_rows_indexed,
                                             hamming_rows_indexed_ref, hamming_rows_ref)
    from repro_torch.kernels.qdist import (qdist, qdist_from_packed,
                                           qdist_packed_ref, qdist_u8_ref,
                                           qdist_windows, qdist_windows_ref,
                                           qdist_windows_rows,
                                           qdist_windows_rows_ref, window_rows)

    g = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, generator=g, device=dev,
                             dtype=torch.int32)

    rows = []
    # --- hamming_rows: exact --------------------------------------------
    # Shapes: Task-1 search (Q, k1, W); Task-2 merge (chunk, k1, W); odd.
    ham, ham_times = {}, {}
    for qn, k, w in ((2048, 48, 12), (MERGE_CHUNK, 96, 12), (37, 33, 14)):
        a, c = words(qn, w), words(qn, k, w)
        got, ref = hamming_rows(a, c), hamming_rows_ref(a, c)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"hamming_rows != plain version at {(qn, k, w)}")
        ham[(qn, k, w)] = float((got - ref).abs().max())
        if qn != 37:
            b_ms, b_by = bound((qn * w + qn * k * w + qn * k) * 4, 3 * qn * k * w)
            ham_times[(qn, k, w)] = {
                "ms": median_ms(lambda: hamming_rows(a, c), reps),
                "plain_ms": median_ms(lambda: hamming_rows_ref(a, c), reps),
                "bound_ms": b_ms, "bound_by": b_by}
        del a, c, got, ref
    # Table 1's stage 1 at the mean k1 of its 160- and 120-tree rows
    # (pubmed23.TABLE1): exact, timed without the plain version.
    for qn, k, w in TABLE1_HAMMING_SHAPES:
        a, c = words(qn, w), words(qn, k, w)
        if not torch.equal(hamming_rows(a, c), hamming_rows_ref(a, c)):
            raise AssertionError(f"hamming_rows != plain version at {(qn, k, w)}")
        b_ms, b_by = bound((qn * w + qn * k * w + qn * k) * 4, 3 * qn * k * w)
        ham_times[(qn, k, w)] = {"ms": median_ms(lambda: hamming_rows(a, c), reps),
                                 "bound_ms": b_ms, "bound_by": b_by}
        del a, c
    # hamming_rows_indexed (the same kernel reading rows by index): rows 0
    # and n - 1, repeated rows and indices outside [0, n) (clamped) in
    # every query; int32 and int64 indices; a table 4 bytes off 16 (the
    # 4-byte loads); bit-equal to the plain version and to the
    # pre-gathered launch on the same rows.
    indexed = []
    for qn, k, w, n, dtype, offset in ((2048, 48, 12, 300_000, torch.int32, 0),
                                       (37, 33, 12, 5000, torch.int64, 1),
                                       (129, 7, 14, 300, torch.int32, 0)):
        a = words(qn, w)
        buf = words(n * w + offset)
        table = buf[offset:].view(n, w)
        idx = torch.randint(0, n, (qn, k), generator=g, device=dev, dtype=dtype)
        idx[:, 0], idx[:, -1] = 0, n - 1
        idx[:, 1] = idx[:, 2]
        idx[0, 1], idx[-1, 2] = -5, n + 7
        got = hamming_rows_indexed(a, table, idx)
        ref = hamming_rows_indexed_ref(a, table, idx)
        pre = hamming_rows(a, table[idx.clamp(0, n - 1)])
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(got, pre)):
            raise AssertionError(f"hamming_rows_indexed != plain version or pre-gathered "
                                 f"launch at {(qn, k, w)}, offset {offset}")
        indexed.append([qn, k, w, n, str(dtype), offset])
        del a, buf, table, idx, got, ref, pre
    # Library: torch.cdist(p=0) on the unpacked bits, batched (Q, 1, 32 W)
    # against (Q, K, 32 W), leaving out the unpacking; held equal.
    qn, k, w = 2048, 48, 12
    a, c = words(qn, w), words(qn, k, w)
    a_bits, c_bits = sketch_bits(a)[:, None, :], sketch_bits(c)
    if not torch.equal(torch.cdist(a_bits, c_bits, p=0)[:, 0].to(torch.int32),
                       hamming_rows(a, c)):
        raise AssertionError("torch.cdist(p=0) computes another function than hamming_rows")
    ham_times[(qn, k, w)]["library_ms"] = median_ms(
        lambda: torch.cdist(a_bits, c_bits, p=0), reps)
    del a, c, a_bits, c_bits
    search_t, merge_t = ham_times[(2048, 48, 12)], ham_times[(MERGE_CHUNK, 96, 12)]
    rows.append({
        "name": "hamming_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/hamming_rows.cu",
        "replaces": "src/repro/kernels/hamming/kernel.py:83",
        "max_abs_err": max(ham.values()), **search_t, "shape": [2048, 48, 12],
        "ms_route": "pre-gathered", "task2_shape": [MERGE_CHUNK, 96, 12],
        **{"task2_" + x: merge_t[x] for x in ("ms", "plain_ms", "bound_ms")},
    })
    emit({"phase": "kernel_parity", "kernel": "hamming_rows", "exact": True,
          "shapes": [list(s) for s in ham], "indexed_cases": indexed,
          "indexed_bit_equal_to_pre_gathered": True,
          "times": {str(list(s)): t for s, t in ham_times.items()}})

    # --- qdist_windows: rtol 1e-5, atol 1e-6 ------------------------------
    # Both wrappers of the one kernel: pre-gathered windows (qdist_windows)
    # and windows read from the rows (qdist_windows_rows: 384 windows of 5
    # and 111 of 3 over random codes, a window at 0 and one at n - L in
    # every query); the two bit-equal on the same rows.
    errs, rows_errs = {}, {}
    keep = None
    for (qn, c, d), (n_rows, window) in zip(((2048, 1920, 384), (37, 333, 61)),
                                            ((500_000, 5), (2000, 3))):
        w = -(-d // 8)
        q = torch.randn(qn, d, generator=g, device=dev)
        win = words(qn, c, w)
        cent = torch.sort(torch.randn(d, 16, generator=g, device=dev), dim=1).values
        got, ref = qdist_windows(q, win, cent), qdist_windows_ref(q, win, cent)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=DIST_RTOL, atol=DIST_ATOL)
        errs[(qn, c, d)] = float((got - ref).abs().max())
        if keep is None:
            keep = (q, win, cent, errs[(qn, c, d)])
        del got, ref
        codes = words(n_rows, w)
        starts = torch.randint(0, n_rows - window + 1, (qn, c // window), generator=g,
                               device=dev, dtype=torch.int32)
        starts[:, 0], starts[:, -1] = 0, n_rows - window
        got = qdist_windows_rows(q, codes, starts, window, cent)
        ref = qdist_windows_rows_ref(q, codes, starts, window, cent)
        pre = qdist_windows(q, window_rows(codes, starts, window).reshape(qn, c, w), cent)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=DIST_RTOL, atol=DIST_ATOL)
        if not torch.equal(got, pre):
            raise AssertionError(f"qdist_windows_rows != qdist_windows on the same rows "
                                 f"at {(qn, c, d)}")
        rows_errs[(qn, c, d)] = float((got - ref).abs().max())
        del got, ref, pre, codes, starts
    q, win, cent, err = keep
    qn, c, d = 2048, 1920, 384
    w = -(-d // 8)
    ms = median_ms(lambda: qdist_windows(q, win, cent), reps)
    plain_ms = median_ms(lambda: qdist_windows_ref(q, win, cent), max(5, reps // 4))
    b_ms, b_by = bound((qn * d + qn * c * w + d * 16 + qn * c) * 4, 3 * qn * c * d)
    rows.append({
        "name": "qdist_windows", "route": "cuda",
        "source": "src/repro_torch/csrc/qdist_windows.cu",
        "replaces": "src/repro/kernels/qdist/kernel.py:179",
        "max_abs_err": max(err, *rows_errs.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": [qn, c, d], "ms_route": "pre-gathered",
    })
    # Table 1's stage 2 at the mean pool (2h + 1) k2 of its 160- and 120-tree
    # rows: timed only (the plain version would hold 15 GB at once).
    t1_times = {}
    for qn, c, d in TABLE1_QDIST_SHAPES:
        w = -(-d // 8)
        pool = words(qn, c, w)
        b_ms, b_by = bound((qn * d + qn * c * w + d * 16 + qn * c) * 4, 3 * qn * c * d)
        t1_times[str([qn, c, d])] = {
            "ms": median_ms(lambda: qdist_windows(q, pool, cent), reps),
            "bound_ms": b_ms, "bound_by": b_by}
        del pool
    del q, win, cent, keep
    torch.cuda.empty_cache()
    # Past D 3,200 the kernel walks the dims in tiles (the zoo's widths):
    # both wrappers against their plain versions on WIDE_CHECK_QUERIES
    # queries of 384 windows of 5 rows (a window at 0 and one at n - 5 in
    # every query), bit-equal to each other; the rows wrapper timed at the
    # engine's pool, 2048 queries, over WIDE_ROWS rows of codes.
    wide = {}
    for d in WIDE_DIMS:
        w = -(-d // 8)
        qn, n_s, window = 2048, 384, 5
        c = n_s * window
        q = torch.randn(qn, d, generator=g, device=dev)
        cent = torch.sort(torch.randn(d, 16, generator=g, device=dev), dim=1).values
        codes = words(WIDE_ROWS, w)
        starts = torch.randint(0, WIDE_ROWS - window + 1, (qn, n_s), generator=g,
                               device=dev, dtype=torch.int32)
        starts[:, 0], starts[:, -1] = 0, WIDE_ROWS - window
        qc, sc = q[:WIDE_CHECK_QUERIES], starts[:WIDE_CHECK_QUERIES].contiguous()
        win = window_rows(codes, sc, window).reshape(WIDE_CHECK_QUERIES, c, w)
        got = qdist_windows_rows(qc, codes, sc, window, cent)
        pre = qdist_windows(qc, win, cent)
        ref = qdist_windows_rows_ref(qc, codes, sc, window, cent)
        pre_ref = qdist_windows_ref(qc, win, cent)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=DIST_RTOL, atol=DIST_ATOL)
        torch.testing.assert_close(pre, pre_ref, rtol=DIST_RTOL, atol=DIST_ATOL)
        if not torch.equal(got, pre):
            raise AssertionError(f"qdist_windows_rows != qdist_windows at D {d}")
        err = max(float((got - ref).abs().max()), float((pre - pre_ref).abs().max()))
        del got, pre, ref, pre_ref, win
        rows_read = torch.unique(
            starts[:, :, None] + torch.arange(window, device=dev)).numel()
        b_ms, b_by = bound((qn * d + rows_read * w + qn * n_s + d * 16 + qn * c) * 4,
                           3 * qn * c * d)
        cq = WIDE_CHECK_QUERIES
        cb_ms, cb_by = bound((cq * d + cq * c * w + cq * n_s + d * 16 + cq * c) * 4,
                             3 * cq * c * d)
        wide[d] = {
            "max_abs_err": err, "shape": [qn, c, d], "rows": WIDE_ROWS,
            "ms": median_ms(lambda: qdist_windows_rows(q, codes, starts, window, cent),
                            reps),
            "bound_ms": b_ms, "bound_by": b_by, "rows_read": rows_read,
            "check_shape": [cq, c, d],
            "check_ms": median_ms(lambda: qdist_windows_rows(qc, codes, sc, window, cent),
                                  reps),
            "check_plain_ms": median_ms(
                lambda: qdist_windows_rows_ref(qc, codes, sc, window, cent), 5),
            "check_bound_ms": cb_ms, "check_bound_by": cb_by}
        del q, cent, codes, starts, qc, sc
        torch.cuda.empty_cache()
    rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"],
                                  *(x["max_abs_err"] for x in wide.values()))
    rows[-1]["wide_d"] = {str(d): x for d, x in wide.items()}
    emit({"phase": "kernel_parity", "kernel": "qdist_windows",
          "rtol": DIST_RTOL, "atol": DIST_ATOL,
          "max_abs_err": {str(list(s)): e for s, e in errs.items()},
          "rows_max_abs_err": {str(list(s)): e for s, e in rows_errs.items()},
          "rows_bit_equal_to_pre_gathered": True,
          **{x: rows[-1][x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")},
          "table1_times": t1_times, "wide_d": rows[-1]["wide_d"]})

    # --- pack_bits: exact ---------------------------------------------------
    # Shapes: the sketches of the corpus, one key chunk of the curve, the
    # keys and sketches of one LSM seal, one query chunk's keys (a tree of
    # a search), odd.
    pack_times = {}
    for n, k in ((3_000_000, 384), (262_144, 448), (LSM_BUFFER, 448),
                 (LSM_BUFFER, 384), (2048, 448), (37, 61)):
        bits = torch.randint(0, 2, (n, k), generator=g, device=dev,
                             dtype=torch.uint8)
        got, ref = pack_bits(bits), pack_bits_ref(bits)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"pack_bits != plain version at {(n, k)}")
        if n != 37:
            w = -(-k // 32)
            b_ms, b_by = bound(n * k + n * w * 4, n * k)
            pack_times[(n, k)] = {
                "ms": median_ms(lambda: pack_bits(bits), reps),
                "plain_ms": median_ms(lambda: pack_bits_ref(bits),
                                      max(5, reps // 4)),
                "bound_ms": b_ms, "bound_by": b_by}
        del bits, got, ref
    # A base one byte past 16 (the byte path), as a view into a larger
    # buffer gives: exact, timed.
    n, k = LSM_BUFFER, 448
    buf = torch.randint(0, 2, (n * k + 1,), generator=g, device=dev, dtype=torch.uint8)
    bits = buf[1:].view(n, k)
    if not torch.equal(pack_bits(bits), pack_bits_ref(bits)):
        raise AssertionError(f"pack_bits != plain version at {(n, k)} one byte off")
    b_ms, b_by = bound(n * k + n * (k // 32) * 4, n * k)
    unaligned = {"ms": median_ms(lambda: pack_bits(bits), reps), "bound_ms": b_ms,
                 "bound_by": b_by}
    del buf, bits
    torch.cuda.empty_cache()
    rows.append({
        "name": "pack_bits", "route": "cuda",
        "source": "src/repro_torch/csrc/pack_bits.cu",
        "replaces": "src/repro/kernels/bitpack/kernel.py:34",
        "max_abs_err": 0.0, **pack_times[(262_144, 448)],
        "library_ms": None, "shape": [262_144, 448],
        "sketch_shape": [3_000_000, 384],
        **{"sketch_" + x: pack_times[(3_000_000, 384)][x]
           for x in ("ms", "plain_ms", "bound_ms")},
        "lsm_seal_shape": [LSM_BUFFER, 448],
        **{"lsm_seal_" + x: pack_times[(LSM_BUFFER, 448)][x]
           for x in ("ms", "plain_ms", "bound_ms")},
    })
    emit({"phase": "kernel_parity", "kernel": "pack_bits", "exact": True,
          "shapes": [[3_000_000, 384], [262_144, 448], [LSM_BUFFER, 448], [2048, 448],
                     [LSM_BUFFER, 384], [37, 61]],
          "times": {str(list(s)): t for s, t in pack_times.items()},
          "unaligned_shape": [LSM_BUFFER, 448], "unaligned_offset_bytes": 1,
          "unaligned": unaligned})

    # --- hamming_matrix: exact; qdist, qdist_from_packed: rtol 1e-5, atol 1e-6
    # At the kernel bench's shapes and one ragged shape each, hamming_matrix
    # also past a 128 x 128 tile edge at W = 17 (4-byte copies, scalar
    # stores) and on views 1 and 3 words off 16 bytes; the ADC kernels also
    # at a ragged shape of many 128 x 128 tiles whose rows are not 16-byte
    # aligned; their times are phase kernel_bench's.
    ham_shapes = (kernel_bench.HAMMING_SHAPE, (37, 333, 14), (129, 1027, 17), (257, 4096, 12))
    for qn, c, w in ham_shapes:
        a, b = words(qn, w), words(c, w)
        if qn == 257:
            a, b = words(qn * w + 1)[1:].view(qn, w), words(c * w + 3)[3:].view(c, w)
        got, ref = hamming_matrix(a, b), hamming_matrix_ref(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"hamming_matrix != plain version at {(qn, c, w)}")
        del a, b, got, ref
    emit({"phase": "kernel_parity", "kernel": "hamming_matrix", "exact": True,
          "shapes": [list(x) for x in ham_shapes], "unaligned_view_shape": [257, 4096, 12]})
    dense_errs = {"hamming_matrix": 0.0, "qdist": {}, "qdist_from_packed": {}}
    for qn, c, d in (kernel_bench.QDIST_SHAPE, (37, 333, 61), (300, 20000, 385)):
        q = torch.randn(qn, d, generator=g, device=dev)
        codes = torch.randint(0, 16, (c, d), generator=g, device=dev, dtype=torch.uint8)
        cent = torch.sort(torch.randn(d, 16, generator=g, device=dev), dim=1).values
        for name, fn, ref_fn, arg in (
                ("qdist", qdist, qdist_u8_ref, codes),
                ("qdist_from_packed", qdist_from_packed, qdist_packed_ref,
                 pack_codes(codes))):
            got, ref = fn(q, arg, cent), ref_fn(q, arg, cent)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=DIST_RTOL, atol=DIST_ATOL)
            dense_errs[name][str([qn, c, d])] = float((got - ref).abs().max())
            del got, ref
    for name in ("qdist", "qdist_from_packed"):
        emit({"phase": "kernel_parity", "kernel": name, "rtol": DIST_RTOL,
              "atol": DIST_ATOL, "max_abs_err": dense_errs[name]})
        dense_errs[name] = max(dense_errs[name].values())
    torch.cuda.empty_cache()
    return rows, dense_errs


# Kernels 4-6: where each lives and which TPU kernel it replaces; their
# times are phase kernel_bench's rows, in this order.
DENSE_KERNELS = (
    ("hamming_matrix", "src/repro_torch/csrc/hamming_matrix.cu",
     "src/repro/kernels/hamming/kernel.py:47"),
    ("qdist", "src/repro_torch/csrc/qdist_dense.cu",
     "src/repro/kernels/qdist/kernel.py:120"),
    ("qdist_from_packed", "src/repro_torch/csrc/qdist_dense.cu",
     "src/repro/kernels/qdist/kernel.py:149"),
)


def phase_kernel_bench(torch, dense_errs):
    """``repro_torch.benchmarks.kernel_bench`` on the card, the path of
    kernels 4-6; returns its launches and the kernels' table rows."""
    from repro_torch.benchmarks import kernel_bench

    reset_launches()
    t0 = time.perf_counter()
    bench = kernel_bench.main("cuda")
    launches = read_launches(torch)
    emit({"phase": "kernel_bench", "rows": bench, "launches": launches,
          "seconds": time.perf_counter() - t0})
    require_launched("kernel_bench", launches,
                     ["hamming_matrix", "qdist", "qdist_from_packed"])
    rows = []
    for (name, source, replaces), b in zip(DENSE_KERNELS, bench):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": dense_errs[name],
                     "ms": b["device_ms"], "plain_ms": b["plain_ms"],
                     "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                     "library_ms": b["library_ms"], "shape": b["name"]})
    return {"kernel_bench": launches}, rows


def lsm_state(mut) -> dict:
    """Every array of a MutableHilbertIndex's state, on the host."""
    import numpy as np

    n = mut._buf_count
    state = {"next_id": np.asarray(mut._next_id), "gen": np.asarray(mut._gen),
             "alive": mut._alive.copy(), "buf_ids": mut._buf_ids[:n].copy(),
             "buf_points": mut._buf_points[:n].copy()}
    for i, seg in enumerate(mut.segments):
        state[f"seg{i}.gen_n_valid"] = np.asarray([seg.gen, seg.n_valid])
        state[f"seg{i}.ids"] = seg.ids
        for k, v in seg.index.array_bundle().items():
            state[f"seg{i}.{k}"] = v
    return state


def lsm_differ(a: dict, b: dict) -> list:
    """Keys of two :func:`lsm_state` dicts whose arrays are not bit-equal."""
    import numpy as np

    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not np.array_equal(a[k], b[k]))


def phase_device_parity(torch, cfg, lsm_cfg, n: int, seed: int):
    import numpy as np

    from repro_torch.data import ann_datasets
    from repro_torch.index import HilbertIndex, IndexConfig

    pts = ann_datasets.lowrank_embeddings(n, 384, seed=seed)
    t0 = time.perf_counter()
    gpu = HilbertIndex.build(pts, cfg, device="cuda").array_bundle()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = HilbertIndex.build(pts, cfg, device="cpu").array_bundle()
    t_cpu = time.perf_counter() - t0
    differ = sorted(k for k in cpu if not (
        cpu[k].dtype == gpu[k].dtype and np.array_equal(cpu[k], gpu[k])))
    emit({"phase": "device_parity", "n": n, "arrays": sorted(cpu),
          "differ": differ, "gpu_build_s": t_gpu, "cpu_build_s": t_cpu})
    if differ:
        raise AssertionError(f"cuda build differs from cpu build in {differ}")

    # Task 2 on both devices: survivors bit-equal, graph within the contract.
    from repro_torch.configs import gooaq
    from repro_torch.core import knn_graph as knn_graph_lib
    from repro_torch.index import GraphParams

    tcfg = IndexConfig(forest=dataclasses.replace(gooaq.FOREST, n_trees=1),
                       store_points=True)
    gp = GraphParams(n_orders=8, k1=96, k2=60, k=15)
    out = {}
    for dev in ("cuda", "cpu"):
        idx = HilbertIndex.build(pts, tcfg, device=dev)
        fcfg = idx.config.forest
        t0 = time.perf_counter()
        surv = knn_graph_lib.graph_survivors(
            idx.points, idx.sketches_master[idx.master_rank.long()], gp,
            bits=fcfg.bits, key_bits=fcfg.key_bits, lo=idx.forest.lo,
            hi=idx.forest.hi)
        graph = idx.knn_graph(gp)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = ([t.cpu() for t in surv], [t.cpu() for t in graph],
                    time.perf_counter() - t0)
    (gs, gg, t_gpu), (cs, cg, t_cpu) = out["cuda"], out["cpu"]
    surv_equal = torch.equal(gs[0], cs[0]) and torch.equal(gs[1], cs[1])
    emit({"phase": "device_parity_task2", "n": n, "params": dataclasses.asdict(gp),
          "survivors_bit_equal": surv_equal,
          "max_abs_dist_diff": float((gg[1] - cg[1]).abs().max()),
          "gpu_s": t_gpu, "cpu_s": t_cpu})
    if not surv_equal:
        raise AssertionError("cuda Task-2 survivors differ from cpu survivors")
    torch.testing.assert_close(gg[1], cg[1], rtol=DIST_RTOL, atol=DIST_ATOL)
    assert_ids_equal_up_to_ties(cg[0], gg[0], cg[1])
    phase_device_parity_lsm(torch, lsm_cfg, pts, seed)
    phase_device_parity_engine(torch, lsm_cfg, pts, seed)
    phase_sharded_device_parity(torch, dataclasses.replace(cfg, store_points=True), pts,
                                seed)
    phase_sharded_lsm_device_parity(torch, lsm_cfg, pts, seed)


def phase_device_parity_lsm(torch, cfg, pts, seed: int):
    """A streamed LSM index on both devices: half the rows bulk-loaded, the
    rest in inserts of 1000 with 100 deletes after every other one (seals of
    2048 and tier merges), then ``compact()``.  State bit-equal, search
    within the contract; queries lie off the point set (the buffer's
    Gram-form distances cancel on it)."""
    import numpy as np

    from repro_torch.data import ann_datasets
    from repro_torch.index import MutableHilbertIndex, SearchParams

    n = pts.shape[0]
    queries = ann_datasets.lowrank_embeddings(256, 384, seed=seed + 1)
    params = SearchParams(k1=48, k2=384, h=2, k=30)
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        mut = MutableHilbertIndex(cfg, buffer_capacity=PARITY_BUFFER, max_segments=3,
                                  device=dev)
        spent = count_seals_and_merges(torch, mut) if dev == "cuda" else None
        mut.bulk_load(pts[: n // 2])
        for i, s in enumerate(range(n // 2, n, 1000)):
            mut.insert(pts[s : s + 1000])
            if i % 2:
                mut.delete(rng.choice(mut.n_live + mut.n_deleted, 100, replace=False))
        res = {"segments": mut.n_segments, "spent": spent}
        for stage in ("streamed", "compacted"):
            if stage == "compacted":
                mut.compact()
            ids, d2 = (t.cpu() for t in mut.search(queries, params))
            res[stage] = (lsm_state(mut), ids, d2)
        res["s"] = time.perf_counter() - t0
        out[dev] = res
    gpu, cpu = out["cuda"], out["cpu"]
    report = {"phase": "device_parity_lsm", "n": n, "gpu_s": gpu["s"],
              "cpu_s": cpu["s"], "segments_streamed": gpu["segments"],
              "seals_merges": gpu["spent"]}
    for stage in ("streamed", "compacted"):
        report[stage] = {
            "differ": lsm_differ(cpu[stage][0], gpu[stage][0]),
            "max_abs_dist_diff": float((gpu[stage][2] - cpu[stage][2]).abs().max())}
    emit(report)
    for stage in ("streamed", "compacted"):
        if report[stage]["differ"]:
            raise AssertionError(f"cuda LSM state ({stage}) differs from cpu in "
                                 f"{report[stage]['differ']}")
        (_, gids, gd), (_, cids, cd) = gpu[stage], cpu[stage]
        torch.testing.assert_close(gd, cd, rtol=DIST_RTOL, atol=DIST_ATOL)
        assert_ids_equal_up_to_ties(cids, gids, cd)
    if gpu["spent"]["seal"][1] < 3 or gpu["spent"]["merge"][1] < 1:
        raise AssertionError(f"the parity stream ran {gpu['spent']}, not >= 3 seals "
                             "and >= 1 tier merge")


def exact_topk(torch, points, queries, k: int, self_ids=None):
    """Exact squared-L2 top-k ids by matmul over the corpus (a check only).

    ``self_ids`` (one corpus row per query) are left out of each answer.
    """
    chunk = max(1, min(512, 2**30 // points.shape[0]))  # <= 4 GiB of d2
    xsq = (points * points).sum(1)
    out = []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s : s + chunk]
        d2 = xsq[None, :] - 2.0 * (q @ points.T) + (q * q).sum(1)[:, None]
        if self_ids is not None:
            d2.scatter_(1, self_ids[s : s + chunk, None], torch.inf)
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
        del d2
    return torch.cat(out)


def device_time(prof, top: int):
    """(device ms, top kernels, top ops, copy ms by kind) of a
    ``torch.profiler`` run.

    The total sums the device-side events (kernels, copies, sets) only: a
    CPU op's device time repeats the time of the kernels it launched.  The
    ops are ranked by that attributed time, which names the launching op.
    """
    from torch.autograd import DeviceType

    kernels, ops = [], []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us > 0:
            (ops if e.device_type == DeviceType.CPU else kernels).append(
                (us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)

    def fmt(rows):
        return [{"ms": ms, "count": n, "name": k[:80]} for ms, n, k in rows[:top]]

    copies = {k: {"ms": ms, "count": n} for ms, n, k in kernels if k.startswith("Memcpy")}
    return sum(r[0] for r in kernels), fmt(kernels), fmt(ops), copies


def phase_profile(torch, search, phase: str, *, cpu_ops: bool, top: int = 12, **fields):
    """Device time by kernel over one warm ``search()`` (or any call), its
    host<->device copies, and the device's busy share; ``fields`` (the
    queries, the tokens) go into the phase's line.

    The profiler's host overhead lengthens the wall time, so the busy share
    read here is a lower bound, and it is lower with ``cpu_ops``: that also
    records the launching ops (``top_ops``), at the cost of many more
    events to collect.  Without it only CUDA activity is recorded.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu_ops:
        activities.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, kernels, ops, copies = device_time(prof, top)
    emit({"phase": phase, **fields, "wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms if device_ms else None,
          "copies": copies, "top_kernels": kernels, "top_ops": ops,
          "profile_s": time.perf_counter() - t0})



def phase_data(torch, n: int, nq: int, seed: int):
    """The corpus and the held-out queries, drawn on the card from ``seed``."""
    from repro_torch.data import ann_datasets

    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    allpts = ann_datasets.lowrank_embeddings_torch(n + nq, 384, generator=g)
    torch.cuda.synchronize()
    emit({"phase": "data", "n": n, "queries": nq, "d": 384,
          "seconds": time.perf_counter() - t0})
    return allpts[:n], allpts[n:]


def phase_main_path(torch, cfg, params, points, queries, recall_floor: float,
                    after_build=None):
    """Task 1 at full width; returns the kernel launches of its build and
    search.  ``after_build(index)`` runs between the two counted runs."""
    from repro_torch.index import HilbertIndex, build_with_timings

    n, nq = points.shape[0], queries.shape[0]
    # Each counted run of a path: counts at 0 just before, read just after.
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    index, timings = build_with_timings(points, cfg, device="cuda")
    build_s = time.perf_counter() - t0
    build_launches = read_launches(torch)
    emit({"phase": "build_index", "n": n, "timings_s": timings,
          "total_s": build_s, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "memory": index.memory_report(), "launches": build_launches})
    require_launched("task-1 build", build_launches, ["pack_bits"])
    if after_build is not None:
        after_build(index)

    reset_launches()
    t0 = time.perf_counter()
    ids, dists = index.search(queries, params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches(torch)
    require_launched("task-1 search", launches,
                     ["hamming_rows", "qdist_windows", "pack_bits"])
    t0 = time.perf_counter()
    ids2, dists2 = index.search(queries, params)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not (torch.equal(ids, ids2) and torch.equal(dists, dists2)):
        raise AssertionError("two searches of the same queries differ")
    if ids.shape != (nq, params.k) or not torch.isfinite(dists).all():
        raise AssertionError(f"bad result: shape {tuple(ids.shape)}")
    emit({"phase": "search", "queries": nq, "launches": launches,
          "first_ms_per_query": first_s * 1e3 / nq,
          "warm_ms_per_query": warm_s * 1e3 / nq, "warm_s": warm_s})

    t0 = time.perf_counter()
    truth = exact_topk(torch, points, queries, params.k)
    hits = (ids.long()[:, :, None] == truth[:, None, :]).any(-1).sum().item()
    recall = hits / (nq * params.k)
    emit({"phase": "recall", "recall_at_30": recall, "floor": recall_floor,
          "ground_truth_s": time.perf_counter() - t0})
    if recall < recall_floor:
        raise AssertionError(f"recall@30 {recall} below floor {recall_floor}")

    t0 = time.perf_counter()
    ids_r, dists_r = index.search(queries, params, backend="ref")
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    torch.testing.assert_close(dists, dists_r, rtol=DIST_RTOL, atol=DIST_ATOL)
    mism = assert_ids_equal_up_to_ties(ids_r.cpu(), ids.cpu(), dists_r.cpu())
    emit({"phase": "kernel_vs_plain_route", "id_mismatches_within_ties": mism,
          "max_abs_dist_diff": float((dists - dists_r).abs().max()),
          "plain_route_ms_per_query": ref_s * 1e3 / nq})

    path = os.path.join(ROOT, "build", "smoke_index")
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = HilbertIndex.load(path)
        load_s = time.perf_counter() - t0
        ids_l, dists_l = loaded.search(queries, params)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    same = torch.equal(ids, ids_l) and torch.equal(dists, dists_l)
    emit({"phase": "save_load", "bit_equal": same, "save_s": save_s,
          "load_s": load_s})
    if not same:
        raise AssertionError("search after save -> load differs")
    return {"build": build_launches, "search": launches}, truth, recall


def phase_stage2_step(torch, index, queries, reps: int) -> dict:
    """Stage 2's distance step on starts from real stage-1 results of the
    Task-1 index (STAGE2_STEPS; neighbouring windows overlap as in a
    search; one query's first window moved to row 0 and another's to
    n - L): qdist_windows_rows bit-equal to the pre-gathered launch on the
    same rows (which phase kernel_parity holds to the plain version at the
    engine's shape); then the step timed both ways: the parent's route
    (gather the (Q, k2, L, W) block, then the pre-gathered launch) and the
    fused launch.  Its launches are not a path's: the counts are reset
    after it."""
    from repro_torch.benchmarks.kernel_bench import bound, median_ms
    from repro_torch.core import search as search_lib
    from repro_torch.core import sketch
    from repro_torch.kernels.qdist import qdist_windows, qdist_windows_rows, window_rows

    q = queries[:TABLE1_QUERIES].contiguous()
    qn, d = q.shape
    f, fcfg = index.forest, index.config.forest
    n, codes, cent = index.n_points, index.codes_master, index.quant.centroids
    w = codes.shape[1]
    qsk = sketch.make_sketches(index.quant, q)
    steps = {}
    for k1, k2 in STAGE2_STEPS:
        best_pos = search_lib.stage1_forest(
            q, qsk, f.orders, f.directories, f.lo, f.hi, f.perms, f.flips,
            index.master_rank, index.sketches_master, bits=fcfg.bits,
            key_bits=fcfg.key_bits, leaf_size=fcfg.leaf_size, k1=k1, k2=k2,
            use_kernels=True)
        starts, _, window = search_lib._expand_windows(best_pos, n, STAGE2_H)
        starts = starts.contiguous()
        starts[0, 0], starts[1, 0] = 0, n - window
        c = k2 * window
        got = qdist_windows_rows(q, codes, starts, window, cent)
        pre = qdist_windows(q, window_rows(codes, starts, window).reshape(qn, c, w), cent)
        torch.cuda.synchronize()
        if not torch.equal(got, pre):
            raise AssertionError(f"stage2_step: fused != pre-gathered at k2 {k2}")
        rows_read = torch.unique(
            starts[:, :, None] + torch.arange(window, device=starts.device)).numel()
        b_ms, b_by = bound((rows_read * w + starts.numel() + qn * d + d * 16 + qn * c) * 4,
                           3 * qn * c * d)
        steps[str([qn, c, d])] = {
            "k1": k1, "k2": k2, "window": window,
            "rows_read": rows_read, "candidate_rows": qn * c,
            "gather_then_launch_ms": median_ms(
                lambda: qdist_windows(q, window_rows(codes, starts, window)
                                      .reshape(qn, c, w), cent), reps),
            "fused_ms": median_ms(
                lambda: qdist_windows_rows(q, codes, starts, window, cent), reps),
            "fused_bound_ms": b_ms, "fused_bound_by": b_by}
        del best_pos, starts, got, pre
    torch.cuda.empty_cache()
    emit({"phase": "stage2_step", "queries": qn, "h": STAGE2_H,
          "fused_bit_equal_to_pre_gathered": True, "steps": steps})
    return steps


def phase_stage1_step(torch, index, queries, reps: int) -> dict:
    """Stage 1's Hamming step on candidates of the Task-1 index: tree 0's
    master positions for TABLE1_QUERIES queries at each of STAGE1_K1, and
    the first MERGE_CHUNK rows of a Task-2 merge over tree 0's Hilbert
    order (ids at rank offsets of +-TASK2_K1/2, as ``merge_order`` makes
    them).  hamming_rows_indexed bit-equal to gathering the rows and the
    pre-gathered launch; the step timed both ways, with the fused bound by
    the distinct rows the indices name (two 32-byte sectors a 48-byte row).
    Its launches are not a path's: the counts are reset after it."""
    from repro_torch.benchmarks.kernel_bench import bound, median_ms
    from repro_torch.core import forest as forest_lib
    from repro_torch.core import sketch
    from repro_torch.kernels.hamming import hamming_rows, hamming_rows_indexed

    q = queries[:TABLE1_QUERIES].contiguous()
    f, fcfg = index.forest, index.config.forest
    n, table = index.n_points, index.sketches_master
    w = table.shape[1]
    cases = []
    qsk = sketch.make_sketches(index.quant, q)
    for k1 in STAGE1_K1:
        cand = forest_lib.tree_candidates(
            q, f.orders[0], f.directories[0], f.lo, f.hi, f.perms[0], f.flips[0],
            bits=fcfg.bits, key_bits=fcfg.key_bits, leaf_size=fcfg.leaf_size, k1=k1)
        cases.append((f"task1 k1 {k1}", qsk, table, index.master_rank[cand]))
    by_id = table[index.master_rank.long()]  # point id -> sketch
    order = f.orders[0]
    rank = torch.empty_like(order)
    rank.scatter_(0, order.long(), torch.arange(n, dtype=order.dtype, device=order.device))
    half = TASK2_K1 // 2
    deltas = torch.cat([torch.arange(-half, 0), torch.arange(1, TASK2_K1 - half + 1)]
                       ).to(dtype=torch.int32, device=order.device)
    pos = (rank[:MERGE_CHUNK, None] + deltas).clamp_(0, n - 1)
    cases.append((f"task2 merge chunk k1 {TASK2_K1}", by_id[:MERGE_CHUNK].contiguous(),
                  by_id, order[pos.long()]))
    steps = {}
    for name, qs, tab, idx in cases:
        qn, k = idx.shape
        got, pre = hamming_rows_indexed(qs, tab, idx), hamming_rows(qs, tab[idx])
        torch.cuda.synchronize()
        if not torch.equal(got, pre):
            raise AssertionError(f"stage1_step: fused != pre-gathered at {name}")
        rows_read = torch.unique(idx).numel()
        sectors = -(-(w * 4) // 32)
        b_ms, b_by = bound(rows_read * sectors * 32 + idx.numel() * idx.element_size()
                           + qs.numel() * 4 + qn * k * 4, 3 * qn * k * w)
        steps[name] = {
            "shape": [qn, k, w], "rows_read": rows_read, "candidate_rows": qn * k,
            "gather_then_launch_ms": median_ms(lambda: hamming_rows(qs, tab[idx]), reps),
            "fused_ms": median_ms(lambda: hamming_rows_indexed(qs, tab, idx), reps),
            "fused_bound_ms": b_ms, "fused_bound_by": b_by}
        del got, pre
    del cases, by_id, rank, pos
    torch.cuda.empty_cache()
    emit({"phase": "stage1_step", "table_rows": n,
          "fused_bit_equal_to_pre_gathered": True, "steps": steps})
    return steps


def phase_table1(torch, points, queries):
    """The paper's Table 1 (``repro_torch.benchmarks.task1_table1``): its 16
    rows on the first TABLE1_ROWS rows of the corpus and the first
    TABLE1_QUERIES queries, scored against their exact neighbours among
    those rows; returns the launches of its builds and searches."""
    from repro_torch.benchmarks import task1_table1

    nq = min(TABLE1_QUERIES, queries.shape[0])
    points = points[:TABLE1_ROWS]
    t0 = time.perf_counter()
    truth = exact_topk(torch, points, queries[:nq], task1_table1.K)
    truth_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    rows = task1_table1.main(points=points, queries=queries[:nq], truth=truth,
                             timed_searches=TABLE1_TIMED_SEARCHES)
    launches = read_launches(torch)
    builds = {r["n_trees"]: r["build_s"] for r in rows}
    emit({"phase": "table1", "n": points.shape[0], "queries": nq,
          "ground_truth_s": truth_s, "rows": rows,
          "build_s": builds, "best_recall_at_30": max(r["recall_at_30"] for r in rows),
          "floor": task1_table1.RECALL_FLOOR, "launches": launches,
          "seconds": time.perf_counter() - t0})
    require_launched("table1", launches, ["hamming_rows", "qdist_windows", "pack_bits"])
    return {"table1": launches}


def phase_engine_memory(torch, run_engine, name: str = "engine_memory"):
    """Run an engine phase; device memory allocated once it has returned
    may be at most ENGINE_RETAINED_GIB above what it was before.  No
    collection runs in between: what only the cyclic collector would free
    counts as kept."""
    from repro_torch.index import (HilbertIndex, MutableHilbertIndex, ShardedHilbertIndex,
                                   ShardedMutableHilbertIndex)
    from repro_torch.obs import RecallProbe

    gc.collect()
    before = torch.cuda.memory_allocated()
    launches = run_engine()
    after = torch.cuda.memory_allocated()
    kinds = (RecallProbe, HilbertIndex, MutableHilbertIndex, ShardedHilbertIndex,
             ShardedMutableHilbertIndex)
    alive = [o for o in gc.get_objects() if type(o) in kinds]
    report = {"phase": name, "allocated_before_gib": before / 2**30,
              "allocated_after_gib": after / 2**30,
              "retained_gib": (after - before) / 2**30,
              "limit_gib": ENGINE_RETAINED_GIB,
              "alive": sorted(type(o).__name__ for o in alive)}
    del alive
    emit(report)
    if after - before > ENGINE_RETAINED_GIB * 2**30:
        raise AssertionError(f"the engine phase left {report['retained_gib']} GiB "
                             f"allocated after its cleanup (alive: {report['alive']})")
    return launches


def count_seals_and_merges(torch, idx) -> dict:
    """Wrap the flush and the segment merge of an LSM index (either
    layout) to time and count its seals and tier merges, on the index."""
    spent = {"seal": [0.0, 0], "merge": [0.0, 0]}

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            seg = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key][0] += time.perf_counter() - t
            spent[key][1] += seg is not None
            return seg
        return run

    idx.flush = timed(idx.flush, "seal")
    idx._merge_segments = timed(idx._merge_segments, "merge")
    return spent


def phase_lsm(torch, cfg, params, points, queries, seed: int, recall_floor: float):
    """The streaming LSM index at full width; returns the kernel launches of
    its path (bulk load, stream, searches, compaction).

    Bulk-load the first 5/6 of the points as one segment, stream the rest
    in inserts of ``LSM_BATCH`` rows with a delete and search round every
    ``LSM_BUFFER`` rows, then hold recall and compaction to their
    references.  Persistence runs the same steps on the first
    LSM_PERSIST_ROWS rows (a cut of depth): bulk load, save, WAL on, stream
    the rest with deletes; save -> load and WAL replay bit-equal.
    """
    import gc

    import numpy as np

    from repro_torch.index import HilbertIndex, MutableHilbertIndex, WalConfig

    n = points.shape[0]
    bulk = n * 5 // 6
    q = queries[:LSM_QUERIES]
    tail = queries[LSM_QUERIES : LSM_QUERIES + LSM_TAIL]
    if tail.shape[0] < LSM_TAIL:
        raise ValueError(f"--queries must be >= {LSM_QUERIES + LSM_TAIL}")
    rng = np.random.default_rng(seed)
    live = np.zeros(n, np.bool_)  # the smoke's own record of the live ids
    path = os.path.join(ROOT, "build", "smoke_lsm")
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    try:
        reset_launches()
        mut = MutableHilbertIndex(cfg, buffer_capacity=LSM_BUFFER,
                                  max_segments=LSM_MAX_SEGMENTS)
        t0 = time.perf_counter()
        live[mut.bulk_load(points[:bulk])] = True
        torch.cuda.synchronize()
        bulk_s = time.perf_counter() - t0
        emit({"phase": "lsm_bulk", "rows": bulk, "bulk_load_s": bulk_s,
              "memory": mut.memory_report()["per_segment"]})

        spent = count_seals_and_merges(torch, mut)
        pos, rnd = bulk, 0
        while pos < n:
            end = min(pos + LSM_BUFFER, n)
            before = {k: list(v) for k, v in spent.items()}
            t0 = time.perf_counter()
            for s in range(pos, end, LSM_BATCH):
                got = mut.insert(points[s : min(s + LSM_BATCH, end)])
                if not np.array_equal(got, np.arange(s, s + got.size)):
                    raise AssertionError(f"insert at row {s} returned ids {got[:4]}...")
                live[got] = True
            torch.cuda.synchronize()
            insert_s = time.perf_counter() - t0
            pos = end
            live_ids = np.flatnonzero(live)
            dead = rng.choice(live_ids, int(LSM_DELETE * live_ids.size), replace=False)
            if mut.delete(dead) != dead.size:
                raise AssertionError("delete of live ids did not tombstone them all")
            live[dead] = False
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, d2 = mut.search(q, params, allow_rewrite=False)
            torch.cuda.synchronize()
            search_s = time.perf_counter() - t0
            emit({"phase": "lsm_round", "round": rnd, "rows_inserted": pos - bulk,
                  "deleted": int(dead.size), "insert_s": insert_s,
                  "ms_per_query": search_s * 1e3 / q.shape[0],
                  "n_segments": mut.n_segments, "n_buffered": mut.n_buffered,
                  "segment_rows": [seg.n_points for seg in mut.segments],
                  "seal_s": spent["seal"][0] - before["seal"][0],
                  "seals": spent["seal"][1] - before["seal"][1],
                  "merge_s": spent["merge"][0] - before["merge"][0],
                  "merges": spent["merge"][1] - before["merge"][1],
                  "rewrite_pressure": mut.rewrite_pressure(params)})
            rnd += 1
        live_ids = np.flatnonzero(live)
        found = ids[ids >= 0].cpu().numpy()
        if (mut.n_live != live_ids.size or ids.shape != (q.shape[0], params.k)
                or not torch.isfinite(d2).all() or not live[found].all()):
            raise AssertionError("streamed search returned dead ids or bad shapes")
        # A stream of max_segments + 1 buffers or more must merge twice.
        if ((n - bulk) // LSM_BUFFER > LSM_MAX_SEGMENTS and spent["merge"][1] < 2):
            raise AssertionError(f"the stream ran {spent['merge'][1]} tier merges, "
                                 "not the 2 or more it is sized for")
        stream_ids = ids

        t0 = time.perf_counter()
        mut.compact()
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        cids, cd = mut.search(q, params)
        launches = read_launches(torch)
        require_launched("lsm", launches, ["hamming_rows", "qdist_windows", "pack_bits"])

        # recall@30 of the streamed state, and of a fresh build over the live
        # points in insertion order, which compaction must equal bit for bit.
        live_t = torch.from_numpy(live_ids).to(points.device)
        live_pts = points[live_t]
        truth = live_t[exact_topk(torch, live_pts, q, params.k)]

        def recall(got):
            hits = (got.long()[:, :, None] == truth[:, None, :]).any(-1).sum().item()
            return hits / (q.shape[0] * params.k)

        t0 = time.perf_counter()
        fresh = HilbertIndex.build(live_pts, cfg)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        del live_pts
        fids, fd = fresh.search(q, params)
        fids = live_t[fids.long()].to(torch.int32)
        del fresh
        same = torch.equal(cd, fd) and torch.equal(cids, fids)
        emit({"phase": "lsm_recall", "recall_at_30": recall(stream_ids),
              "fresh_build_recall_at_30": recall(fids), "floor": recall_floor,
              "live": int(live_ids.size), "compact_s": compact_s,
              "fresh_build_s": fresh_s, "compacted_equals_fresh_build": same,
              "launches": launches})
        if recall(stream_ids) < recall_floor:
            raise AssertionError(f"LSM recall@30 {recall(stream_ids)} below "
                                 f"floor {recall_floor}")
        if not same:
            raise AssertionError("search after compact() differs from a fresh "
                                 "build over the live points")

        del mut
        gc.collect()
        torch.cuda.empty_cache()

        # Persistence on the first LSM_PERSIST_ROWS rows: bulk load 5/6,
        # save, WAL on, stream the rest with deletes (logged); save -> load
        # bit-equal; then an unsaved WAL tail of inserts and deletes.
        sub = points[:LSM_PERSIST_ROWS]
        sub_bulk = LSM_PERSIST_ROWS * 5 // 6
        mut = MutableHilbertIndex(cfg, buffer_capacity=LSM_BUFFER,
                                  max_segments=LSM_MAX_SEGMENTS)
        sub_live = mut.bulk_load(sub[:sub_bulk])
        t0 = time.perf_counter()
        mut.save(path)
        save0_s = time.perf_counter() - t0
        mut.enable_wal(path, WalConfig())
        for s in range(sub_bulk, LSM_PERSIST_ROWS, LSM_BATCH):
            sub_live = np.concatenate([sub_live, mut.insert(
                sub[s : min(s + LSM_BATCH, LSM_PERSIST_ROWS)])])
        dead = rng.choice(sub_live, int(LSM_DELETE * sub_live.size), replace=False)
        mut.delete(dead)
        sub_live = np.setdiff1d(sub_live, dead)
        cids, cd = mut.search(q, params)
        t0 = time.perf_counter()
        mut.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = MutableHilbertIndex.load(path)
        load_s = time.perf_counter() - t0
        lids, ld = loaded.search(q, params)
        loaded.detach_wal().close()
        del loaded
        load_equal = torch.equal(lids, cids) and torch.equal(ld, cd)
        tail_ids = mut.insert(tail)
        mut.delete(rng.choice(np.concatenate([sub_live, tail_ids]), LSM_TAIL_DELETES,
                              replace=False))
        mut.wal.sync()
        wids, wd = mut.search(q, params)
        want_state = (mut.n_live, mut.n_deleted, mut.n_buffered)
        mut.detach_wal().close()
        del mut
        t0 = time.perf_counter()
        rec = MutableHilbertIndex.load(path)
        replay_s = time.perf_counter() - t0
        rids, rd = rec.search(q, params)
        replay_equal = (torch.equal(rids, wids) and torch.equal(rd, wd)
                        and (rec.n_live, rec.n_deleted, rec.n_buffered) == want_state)
        rec.detach_wal().close()
        del rec
        emit({"phase": "lsm_persistence", "rows": LSM_PERSIST_ROWS,
              "first_save_s": save0_s, "save_s": save_s, "load_s": load_s,
              "load_bit_equal": load_equal, "wal_replay_load_s": replay_s,
              "wal_replay_bit_equal": replay_equal,
              "wal_tail": {"rows": LSM_TAIL, "deletes": LSM_TAIL_DELETES}})
        if not (load_equal and replay_equal):
            raise AssertionError("LSM search after save -> load or WAL replay differs")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    emit({"phase": "lsm", "seconds": time.perf_counter() - t_phase,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "seal": spent["seal"], "merge": spent["merge"], "launches": launches})
    gc.collect()
    torch.cuda.empty_cache()
    return {"lsm": launches}


def phase_device_parity_engine(torch, cfg, pts, seed: int):
    """The same engine operations on the CPU and on the card: ragged
    step-mode searches, inserts and deletes through the engine, then a
    forced maintenance in a thread and, on the card, from the same state
    in a compactor child on the card.  State bit-equal between devices
    and between modes, searches within the contract; ``pipelined_search``
    bit-identical to ``search`` on the card."""
    import numpy as np

    from repro_torch.data import ann_datasets
    from repro_torch.index import MutableHilbertIndex, SearchParams
    from repro_torch.serve import RetrievalEngine, pipelined_search

    n = pts.shape[0]
    queries = ann_datasets.lowrank_embeddings(256, 384, seed=seed + 2)
    params = SearchParams(k1=48, k2=384, h=2, k=30)
    cuts = [0, 3, 40, 41, 128, 200, 256]
    out = {}
    for key, dev in (("gpu", "cuda"), ("cpu", "cpu")):
        rng = np.random.default_rng(seed)
        if key == "gpu":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mut = MutableHilbertIndex(cfg, buffer_capacity=PARITY_BUFFER, max_segments=3,
                                  device=dev)
        mut.bulk_load(pts[: n // 2])
        eng = RetrievalEngine(mut, params, max_batch=128, maintenance=None)
        searches = []

        def served():
            ts = [eng.submit(queries[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
            while eng.step():
                pass
            searches.append(tuple(np.concatenate([t.result(0)[i] for t in ts])
                                  for i in (0, 1)))

        served()
        for i, s in enumerate(range(n // 2, n, 1000)):
            eng.insert(pts[s : s + 1000])
            if i % 2:
                eng.delete(rng.choice(mut.n_live + mut.n_deleted, 100, replace=False))
        served()
        engines = [eng]
        if key == "gpu":
            engines.append(RetrievalEngine(mut.snapshot(), params, maintenance=None,
                                           compaction="subprocess"))
        if not all(e.maintain_once(force=True) for e in engines):
            raise AssertionError(f"{dev}: a forced maintenance did not swap")
        served()
        res = {"thread": lsm_state(eng.index), "searches": searches,
               "s": time.perf_counter() - t0}
        if key == "gpu":
            res["subprocess"] = lsm_state(engines[1].index)
            res["child"] = engines[1].last_swap_timeline["compactor_phases"]
            torch.cuda.synchronize()
            res["parent_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            want = eng.index.search(queries, params, query_chunk=64)
            got = pipelined_search(eng.index, queries, params, query_chunk=64)
            res["pipelined_bit_identical"] = (torch.equal(want[0], got[0])
                                              and torch.equal(want[1], got[1]))
        out[key] = res
    gpu, cpu = out["gpu"], out["cpu"]
    report = {
        "phase": "device_parity_engine", "n": n, "gpu_s": gpu["s"], "cpu_s": cpu["s"],
        "differ_devices": lsm_differ(cpu["thread"], gpu["thread"]),
        "differ_modes": lsm_differ(gpu["thread"], gpu["subprocess"]),
        "max_abs_dist_diff": [float(np.abs(g[1] - c[1]).max())
                              for g, c in zip(gpu["searches"], cpu["searches"])],
        "pipelined_bit_identical": gpu["pipelined_bit_identical"],
        "child_gpu": {k: gpu["child"].get(k) for k in
                      ("child_ms", "child_phases_s", "child_peak_device_bytes")},
        "child_peak_gib": gpu["child"]["child_peak_device_bytes"] / 2**30,
        "parent_peak_gib": gpu["parent_peak_gib"],
    }
    emit(report)
    for key in ("differ_devices", "differ_modes"):
        if report[key]:
            raise AssertionError(f"engine parity: {key} {report[key]}")
    if not report["pipelined_bit_identical"]:
        raise AssertionError("pipelined_search differs from search on the card")
    if report["child_peak_gib"] <= 0:
        raise AssertionError("the compactor child of a CUDA index did not run on "
                             "the card")
    for (gi, gd), (ci, cd) in zip(gpu["searches"], cpu["searches"]):
        torch.testing.assert_close(torch.from_numpy(gd), torch.from_numpy(cd),
                                   rtol=DIST_RTOL, atol=DIST_ATOL)
        assert_ids_equal_up_to_ties(ci, gi, cd)


def parse_prometheus(text: str) -> dict:
    """{bare metric name: samples} of a Prometheus text exposition; every
    non-comment line must read ``name{labels} value``."""
    import re

    line_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (NaN|[-+0-9.eE]+)$")
    names = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        if not line_re.match(line):
            raise AssertionError(f"unparseable exposition line: {line!r}")
        bare = line.split("{", 1)[0].split(" ", 1)[0]
        names[bare] = names.get(bare, 0) + 1
    return names


class EngineLoad:
    """The engine phases' traffic, ``benchmarks/serving.py``'s: closed-loop
    clients of ENGINE_REQUEST-query requests cycling through ``q_host``,
    and a writer that inserts ENGINE_WRITE_BATCH rows of ``stream`` every
    ENGINE_WRITE_PAUSE_S and deletes the batch it inserted two batches
    before (rolling expiry).  The writer records each id's corpus row in
    ``src_row`` (stream row i is corpus row ``bulk + i``) and whether it
    is live in ``live``."""

    def __init__(self, eng, q_host, stream, bulk: int, src_row, live):
        import threading

        self.eng, self.q_host, self.stream, self.bulk = eng, q_host, stream, bulk
        self.src_row, self.live = src_row, live
        self.writes = {"inserted": 0, "deleted": 0, "batches": 0}
        self.stop = threading.Event()
        self._next_q, self._q_lock = 0, threading.Lock()
        self._w_errors = []
        self._w_thread = threading.Thread(target=self._writer)

    def _request(self):
        with self._q_lock:
            s = self._next_q
            self._next_q = (s + ENGINE_REQUEST) % (self.q_host.shape[0] - ENGINE_REQUEST)
        return self.q_host[s : s + ENGINE_REQUEST]

    def run_clients(self, until) -> list:
        """ENGINE_CLIENTS clients until ``until(requests completed)``; returns
        the completed tickets."""
        import threading

        tickets, lock, errors = [], threading.Lock(), []

        def client():
            try:
                while not until(len(tickets)):
                    t = self.eng.submit(self._request())
                    t.result(timeout=600)
                    with lock:
                        tickets.append(t)
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(ENGINE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"engine clients failed: {errors[:1]}")
        return tickets

    def _writer(self):
        from collections import deque

        import numpy as np

        pos, recent, eng = 0, deque(), self.eng
        try:
            while not self.stop.is_set():
                if pos + ENGINE_WRITE_BATCH > self.stream.shape[0]:
                    pos = 0
                got = eng.insert(self.stream[pos : pos + ENGINE_WRITE_BATCH])
                self.src_row[got] = self.bulk + pos + np.arange(got.size)
                self.live[got] = True
                recent.append(got)
                self.writes["inserted"] += got.size
                self.writes["batches"] += 1
                if len(recent) > 2:
                    old = recent.popleft()
                    if eng.delete(old) != old.size:
                        raise AssertionError("expiry did not tombstone its batch")
                    self.live[old] = False
                    self.writes["deleted"] += old.size
                pos += ENGINE_WRITE_BATCH
                self.stop.wait(ENGINE_WRITE_PAUSE_S)
        except BaseException as e:  # surfaced by stop_writer
            self._w_errors.append(e)

    def start_writer(self) -> None:
        self._w_thread.start()

    def stop_writer(self) -> None:
        """Stop the writer; raise if it failed or does not stop."""
        self.stop.set()
        if self._w_thread.ident is not None:
            self._w_thread.join(120)
        if self._w_errors or self._w_thread.is_alive():
            raise AssertionError(f"engine writer failed: {self._w_errors[:1]}")


def exact_by_id(torch, points, src_row):
    """Exact top-k by external id, in float64 on the card, for the engine
    phases' offline checks: id i is row ``src_row[i]`` of ``points`` for
    every id recorded so far (call once the writer has stopped).  The rows
    are gathered in float64 once; each call masks the ids whose ``alive``
    entry is not set (and every id past it)."""
    import numpy as np

    n_ids = int((src_row >= 0).sum())  # ids are dense: 0 .. n_ids - 1
    pts = points[torch.from_numpy(src_row[:n_ids]).to(points.device)].double()
    psq = (pts * pts).sum(1)[None, :]

    def exact(q, alive, k):
        keep = torch.zeros(n_ids, dtype=torch.bool, device=points.device)
        m = min(alive.shape[0], n_ids)
        keep[:m] = torch.from_numpy(np.ascontiguousarray(alive[:m])).to(points.device)
        top = []
        for s in range(0, q.shape[0], 256):  # (256, n_ids) float64 at a time
            qd = torch.from_numpy(q[s : s + 256]).to(points.device).double()
            d2 = (qd * qd).sum(1, keepdim=True) - 2.0 * (qd @ pts.T) + psq
            d2 = d2.masked_fill(~keep[None, :], torch.inf)
            top.append(torch.topk(d2, k, dim=1, largest=False).indices.cpu().numpy())
            del d2
        return np.concatenate(top)

    return exact


def _window_stats(tickets, batch_rec, compactions, t_start, t_end):
    """Latency percentiles, throughput and the batches that overlapped a
    shadow compaction, from one window's tickets."""
    import numpy as np

    from repro_torch.obs import percentiles

    lat = [t.latency_ms for t in tickets]
    batches = {}
    for t in tickets:  # one batch: the tickets sharing its batched_at
        batches.setdefault(t.batched_at, max(batches.get(t.batched_at, 0.0),
                                             t.completed_at))
    spans = [(c0, t_end if c1 is None else c1) for c0, c1 in compactions]
    overlap = [(end - start) * 1e3 for start, end in batches.items()
               if any(start < c1 and end > c0 for c0, c1 in spans)]
    overlap_req = [t.latency_ms for t in tickets
                   if any(t.submitted_at < c1 and t.completed_at > c0
                          for c0, c1 in spans)]
    seconds = t_end - t_start
    rows = sum(int(t.queries.shape[0]) for t in tickets)
    return {
        "requests": len(tickets), "queries": rows, "seconds": seconds,
        "qps": rows / seconds, "requests_per_s": len(tickets) / seconds,
        "request_ms": percentiles(lat), "search_ms": percentiles(batch_rec.samples()),
        "batches": len(batches), "search_batches": batch_rec.count,
        "overlap_batches": len(overlap),
        "overlap_batch_ms": percentiles(overlap) if overlap else None,
        "overlap_request_ms": percentiles(overlap_req) if overlap_req else None,
        "max_request_ms": float(np.max(lat)),
    }


def phase_engine(torch, cfg, params, points, queries, seed: int,
                 launch_lock: bool = True):
    """The serving engine at full width under concurrent writes; returns the
    kernel launches of its path (bulk load, three windows, the last forced
    maintenance).

    ``launch_lock=False`` lets both serve threads launch their searches at
    once (the engine's one-at-a-time launch lock replaced by a no-op), for
    the comparison in ``chip_engine_ab.py``.
    """
    import contextlib
    import threading
    import urllib.request

    import numpy as np

    from repro_torch import obs
    from repro_torch.index import HilbertIndex, MutableHilbertIndex
    from repro_torch.obs import (LatencyRecorder, MetricsServer, RecallProbe,
                                 RecallProbeConfig, accounting_delta,
                                 accounting_snapshot, recall_at_k)
    from repro_torch.serve import MaintenancePolicy, RetrievalEngine

    n = points.shape[0]
    bulk = n * 5 // 6
    q_host = queries.cpu().numpy()
    stream = points[bulk:].cpu().numpy()  # the writer's rows, wrapped
    cap = n + 4_000_000
    src_row = np.full(cap, -1, np.int64)  # external id -> row of `points`
    live = np.zeros(cap, np.bool_)  # acknowledged and not deleted
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    reset_launches()
    index = MutableHilbertIndex(cfg, buffer_capacity=ENGINE_BUFFER,
                                max_segments=ENGINE_MAX_SEGMENTS)
    t0 = time.perf_counter()
    ids = index.bulk_load(points[:bulk])
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    src_row[ids] = ids
    live[ids] = True
    eng = RetrievalEngine(index, params, maintenance=MaintenancePolicy(
        max_segments=4, max_tombstone_ratio=0.5, poll_interval_s=0.05),
        serve_threads=2, compaction="thread", start=True)
    if not launch_lock:
        eng._launch_lock = contextlib.nullcontext()
    server = MetricsServer(port=0)
    compactions = []  # [start, end or None] of every shadow compaction
    inner_compact = eng._compact_shadow

    def timed_compact(*args, **kwargs):
        span_ = [time.perf_counter(), None]
        compactions.append(span_)
        try:
            return inner_compact(*args, **kwargs)
        finally:
            span_[1] = time.perf_counter()

    eng._compact_shadow = timed_compact
    emit({"phase": "engine_setup", "rows": bulk, "bulk_load_s": bulk_s,
          "metrics_port": server.port, "launch_lock": launch_lock})

    load = EngineLoad(eng, q_host, stream, bulk, src_row, live)

    # Segment count, sampled while the windows run.
    seen = {"max": 0}
    m_stop = threading.Event()

    def monitor():
        while not m_stop.wait(0.1):
            seen["max"] = max(seen["max"], eng.maintenance_stats()["n_segments"])

    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()

    # Warm-up: every pow2 batch shape the windows can form, unmeasured.
    warm = load.run_clients(lambda k: k >= 2 * ENGINE_CLIENTS)
    acct0 = accounting_snapshot()
    results, windows_launches = {}, {}
    kept = []  # (queries, served ids, k, snapshot) of every batch the probe kept

    def window(name, until, before=None):
        swaps0 = eng.metrics.counter("swaps")
        seen["max"] = eng.maintenance_stats()["n_segments"]
        eng.metrics.batch_latency = LatencyRecorder()
        launches0 = read_launches(torch)
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        if before is not None:
            before()
        tickets = load.run_clients(until)
        t_end = time.perf_counter()
        comp = [tuple(c) for c in list(compactions)
                if c[0] < t_end and (c[1] is None or c[1] > t_start)]
        stats = _window_stats(tickets, eng.metrics.batch_latency, comp,
                              t_start, t_end)
        launches = {k: v - launches0[k] for k, v in read_launches(torch).items()}
        delta = accounting_delta(acct0, accounting_snapshot())
        stats.update({
            "phase": "engine_window", "window": name, "launch_lock": launch_lock,
            "swaps": eng.metrics.counter("swaps") - swaps0,
            "max_segments_seen": seen["max"],
            "compaction_s": [c1 - c0 for c0, c1 in comp if c1 is not None],
            "compactions_overlapping": len(comp),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "accounting_delta": delta,
            "writes": dict(load.writes),
            "maintenance": {k: eng.metrics.counter(k) for k in (
                "maintenance_runs", "maintenance_failures", "maintenance_timeouts")},
            "last_maintenance_error": repr(eng.last_maintenance_error),
            "last_swap_timeline": {k: v for k, v in (eng.last_swap_timeline or {}).items()
                                   if k.endswith("_ms") or k in ("log_depth",
                                                                 "replay_rounds")},
        })
        emit(stats)
        require_launched(f"engine {name}", launches,
                         ["hamming_rows", "qdist_windows", "pack_bits"])
        if delta["backend_compiles_total"] != 0:
            raise AssertionError(f"engine {name}: kernel builds after warm-up: {delta}")
        results[name] = stats
        windows_launches[name] = launches
        return tickets

    try:
        window("baseline", lambda k: k >= ENGINE_BASELINE_REQUESTS)
        t_churn = [0.0]

        def churn_until(k):
            swaps = eng.metrics.counter("swaps") - churn_swaps0
            over = time.perf_counter() - t_churn[0] > ENGINE_CHURN_CAP_S
            return over or (k >= ENGINE_CHURN_REQUESTS and swaps >= ENGINE_CHURN_SWAPS)

        churn_swaps0 = eng.metrics.counter("swaps")

        def start_writer():
            t_churn[0] = time.perf_counter()
            load.start_writer()

        window("churn_maintained", churn_until, before=start_writer)

        # Probe window: tracing on, a 25 % recall probe; every kept batch is
        # also recorded with a snapshot for the offline evaluation.
        k_lock = threading.Lock()
        probe = RecallProbe(RecallProbeConfig(window=1 << 20, **ENGINE_PROBE))
        inner_offer = probe.offer

        def offer(q, got_ids, k, idx):
            # called under the engine's read lock: idx is the served state
            with k_lock:
                ok = inner_offer(q, got_ids, k, idx)
                if ok:
                    kept.append((q.copy(), got_ids.copy(), k, idx.snapshot()))
            return ok

        probe.offer = offer
        obs.default_tracer().clear()
        obs.enable()

        def attach_probe():
            eng.recall_probe = probe

        window("probe", lambda k: k >= ENGINE_PROBE_REQUESTS, before=attach_probe)
        load.stop_writer()
        if results["churn_maintained"]["swaps"] < ENGINE_CHURN_SWAPS:
            raise AssertionError(f"only {results['churn_maintained']['swaps']} "
                                 "swaps in the churn window")
        eng.recall_probe = None
        want_samples = sum(q.shape[0] for q, _, _, _ in kept)
        deadline = time.perf_counter() + 300
        while len(probe._window) < want_samples:  # the maintainer's pass too
            probe.score_pending()
            if time.perf_counter() > deadline:
                raise AssertionError("the recall probe left sampled batches unscored")
            time.sleep(0.05)
        online = probe.recall()
        # Offline: exact neighbours over the live set this script recorded
        # itself (each snapshot's tombstones, `src_row` for the rows), not
        # over the index's own `live_parts`; and each kept batch searched
        # again on its snapshot, which the served ids must equal.
        t0 = time.perf_counter()
        exact = exact_by_id(torch, points, src_row)
        per_query, served_equal, layouts = [], 0, []
        for q, got_ids, k, snap in kept:
            snap_ids = snap.search(q, params, backend=eng.backend,
                                   query_chunk=eng.query_chunk, allow_rewrite=False)[0]
            served_equal += int(np.array_equal(snap_ids.cpu().numpy(), got_ids))
            per_query.append(recall_at_k(got_ids, exact(q, snap._alive[: snap._next_id],
                                                        k)))
            # what each batch was served from: (rows, real rows, dead) per
            # segment, then the buffer's rows; beside the batch's recall
            layouts.append({"recall": float(per_query[-1].mean()),
                            "segments": [(s.n_points, s.n_real, snap._segment_dead(s))
                                         for s in snap.segments],
                            "buffered": snap.n_buffered})
        offline = float(np.concatenate(per_query).mean()) if per_query else float("nan")
        probe_check = {"phase": "engine_probe_check", "batches_kept": len(kept),
                       "online_recall_at_30": online, "offline_recall_at_30": offline,
                       "served_equals_snapshot_search": served_equal,
                       "by_batch": layouts,
                       "diff": abs(online - offline), "tolerance": ENGINE_RECALL_TOL,
                       "offline_s": time.perf_counter() - t0,
                       "batches_dropped": obs.default_registry().snapshot().get(
                           "engine_recall_batches_dropped_total")}
        emit(probe_check)
        kept.clear()
        if not (probe_check["batches_kept"] and probe_check["diff"] <= ENGINE_RECALL_TOL):
            raise AssertionError(f"probe recall {online} disagrees with the offline "
                                 f"evaluation {offline}")
        if served_equal != probe_check["batches_kept"]:
            raise AssertionError(f"{probe_check['batches_kept'] - served_equal} served "
                                 "batches differ from their snapshot's own search")

        # Last forced maintenance, then the checks.
        t0 = time.perf_counter()
        if not eng.maintain_once(force=True):
            raise AssertionError("the last forced maintenance did not swap")
        final_s = time.perf_counter() - t0
        m_stop.set()
        launches = read_launches(torch)
        require_launched("engine", launches,
                         ["hamming_rows", "qdist_windows", "pack_bits"])
        final = eng.index
        n_ids = final._next_id
        live_ids = np.flatnonzero(live[:n_ids])
        alive_equal = (np.array_equal(final._alive, live[:n_ids])
                       and not live[n_ids:].any())
        q = queries[:ENGINE_CHECK_QUERIES]
        cids, cd = eng.search(q)
        live_t = torch.from_numpy(live_ids).to(points.device)
        rows = torch.from_numpy(src_row[live_ids]).to(points.device)
        t0 = time.perf_counter()
        fresh = HilbertIndex.build(points[rows], cfg)
        fresh_s = time.perf_counter() - t0
        fids, fd = fresh.search(q, params)
        fids = live_t[fids.long()].to(torch.int32).cpu().numpy()
        fd = fd.cpu().numpy()
        del fresh, rows
        same = np.array_equal(np.sort(cd, 1), np.sort(fd, 1)) and np.array_equal(
            cids, fids) and np.array_equal(cd, fd)
        final_recall = float(recall_at_k(
            cids, exact(q.cpu().numpy(), live[:n_ids], params.k)).mean())
        del exact
        # Scrape the three views over HTTP.
        scraped = {}
        for path in ("/metrics", "/metrics.json", "/trace"):
            with urllib.request.urlopen(server.url + path, timeout=30) as r:
                scraped[path] = r.read().decode()
        prom = parse_prometheus(scraped["/metrics"])
        snap = json.loads(scraped["/metrics.json"])
        trace = json.loads(scraped["/trace"])
        missing = [s for s in ENGINE_SERIES if s not in prom]
        span_names = sorted({e["name"] for e in trace["traceEvents"]})
        emit({"phase": "engine_final", "final_maintenance_s": final_s,
              "segments": final.n_segments, "live": int(live_ids.size),
              "acknowledged_live_equal": alive_equal,
              "fresh_build_s": fresh_s, "search_equals_fresh_build": same,
              "recall_at_30": final_recall,
              "series_missing": missing, "series": len(prom),
              "swaps_total": snap.get("engine_swaps_total"),
              "recall_gauge": snap.get("engine_recall_at_k"),
              "trace_events": len(trace["traceEvents"]), "span_names": span_names,
              "warmup_requests": len(warm), "launches": launches,
              "accounting_delta": accounting_delta(acct0, accounting_snapshot())})
        if not alive_equal:
            raise AssertionError("acknowledged writes and the engine's live set differ")
        if not same:
            raise AssertionError("engine search after the last maintenance differs "
                                 "from a fresh build over the live points")
        if missing or not {"engine.batch", "engine.search", "maint.cycle"} <= set(
                span_names):
            raise AssertionError(f"scrape: missing series {missing} or spans "
                                 f"{span_names}")
    finally:
        # The kept snapshots share the served segments: let them go even
        # when a check failed.
        kept.clear()
        load.stop.set()
        m_stop.set()
        obs.disable()
        eng.stop(drain=False)
        # The timing wrapper closes a cycle through the engine (and so its
        # index), which only the cyclic collector would free, and then
        # perhaps only after the next phase has started.
        del eng._compact_shadow
        server.close()
    emit({"phase": "engine", "seconds": time.perf_counter() - t_phase,
          "launch_lock": launch_lock,
          "windows": {k: {x: v[x] for x in ("request_ms", "search_ms", "qps", "swaps")}
                      for k, v in results.items()},
          "launches": launches})
    del eng, index, final, inner_compact
    torch.cuda.empty_cache()
    return {"engine": launches}


def phase_task2(torch, points, params, seed: int, recall_floor: float):
    """Task 2 at full width: GOOAQ forest build, then ``knn_graph(params)``.

    Returns the kernel launches of the build and of the graph.
    """
    from repro_torch.configs import gooaq
    from repro_torch.index import IndexConfig, build_with_timings

    n = points.shape[0]
    cfg = IndexConfig(forest=dataclasses.replace(gooaq.FOREST, n_trees=1),
                      store_points=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    index, timings = build_with_timings(points, cfg, device="cuda")
    build_s = time.perf_counter() - t0
    build_launches = read_launches(torch)
    emit({"phase": "task2_build", "n": n, "forest": dataclasses.asdict(cfg.forest),
          "timings_s": timings, "total_s": build_s,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "launches": build_launches})
    require_launched("task-2 build", build_launches, ["pack_bits"])

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ids, d2 = index.knn_graph(params)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    launches = read_launches(torch)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require_launched("task-2 graph", launches, ["pack_bits", "hamming_rows"])
    rows = torch.arange(n, device=ids.device, dtype=ids.dtype)[:, None]
    if (ids.shape != (n, params.k) or not torch.isfinite(d2).all()
            or (ids < 0).any() or (ids == rows).any()
            or (d2[:, 1:] < d2[:, :-1]).any()):
        raise AssertionError(f"bad graph: shape {tuple(ids.shape)}, finite "
                             f"{bool(torch.isfinite(d2).all())}")
    emit({"phase": "task2", "n": n, "params": dataclasses.asdict(params),
          "graph_s": graph_s, "peak_gib": peak, "launches": launches})

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed)
    sample = torch.randperm(n, generator=g, device="cuda")[:TASK2_RECALL_ROWS]
    truth = exact_topk(torch, points, points[sample], params.k, self_ids=sample)
    got = ids[sample].long()
    hits = (got[:, :, None] == truth[:, None, :]).any(-1).sum().item()
    recall = hits / (sample.numel() * params.k)
    emit({"phase": "task2_recall", "recall_at_15": recall, "rows": sample.numel(),
          "floor": recall_floor, "ground_truth_s": time.perf_counter() - t0})
    if recall < recall_floor:
        raise AssertionError(f"task-2 recall@15 {recall} below floor {recall_floor}")

    phase_task2_profile(torch, index, params)
    return {"task2_build": build_launches, "task2": launches}, (sample, truth, recall)


def phase_task2_profile(torch, index, params, top: int = 12):
    """Where one order of the graph goes: its stages timed one by one with a
    synchronize between, then the device time by kernel of one order and
    the exact re-rank under the profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import knn_graph as knn_graph_lib

    fcfg = index.config.forest
    points = index.points
    n, d = points.shape
    curve = dict(bits=fcfg.bits, key_bits=fcfg.key_bits)
    rng = np.random.default_rng(params.seed)
    perm = torch.as_tensor(rng.permutation(d).astype(np.int32), device="cuda")
    flip = torch.as_tensor(rng.integers(0, 2, d).astype(bool), device="cuda")

    def one_order():
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk = index.sketches_master[index.master_rank.long()]
        best_id = torch.full((n, params.k2), -1, dtype=torch.int32, device="cuda")
        best_d = torch.full((n, params.k2), 2**30, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        stages["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        order, rank = knn_graph_lib.order_and_rank(points, index.forest.lo,
                                                   index.forest.hi, perm, flip, **curve)
        torch.cuda.synchronize()
        stages["order_and_rank_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        best_id, _ = knn_graph_lib.merge_order(best_id, best_d, order, rank, sk,
                                               k1=params.k1, k2=params.k2)
        torch.cuda.synchronize()
        stages["merge_order_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for s in range(0, n, MERGE_CHUNK):
            knn_graph_lib.final_select_chunk(points, best_id[s : s + MERGE_CHUNK], s,
                                             k=params.k)
        torch.cuda.synchronize()
        stages["final_select_s"] = time.perf_counter() - t0
        return stages

    one_order()  # warm
    stages = one_order()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_order()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, kernels, ops, _ = device_time(prof, top)
    emit({"phase": "task2_profile", "stages_s": stages,
          "graph_estimate_s": (params.n_orders * (stages["order_and_rank_s"]
                                                   + stages["merge_order_s"])
                               + stages["final_select_s"]),
          "profiled_wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms if device_ms else None,
          "top_kernels": kernels, "top_ops": ops})


def sharded_searches(idx, queries, params) -> dict:
    """The merges the smoke holds a sharded index to, results on the host:
    tree (the "auto" of 4 shards), gather, tree with the prune, and the
    unmerged per-shard results."""
    out = {name: [t.cpu() for t in idx.search(queries, params, **kw)]
           for name, kw in (("tree", {}), ("gather", dict(merge="gather")),
                            ("tree_prune", dict(merge="tree", prune=True)))}
    out["local"] = [t.cpu() for t in idx.search_local(queries, params)]
    return out


def check_merges_agree(torch, res: dict, where: str) -> None:
    """Tree and gather: sorted distances bit-equal; the prune: bit-equal to
    the tree, ids included."""
    (ti, td), (_, gd), (pi, pd) = res["tree"], res["gather"], res["tree_prune"]
    if not torch.equal(td.sort(1).values, gd.sort(1).values):
        raise AssertionError(f"{where}: tree and gather merges differ in distance")
    m = pi.shape[0]  # the prune may search the first queries only
    if not (torch.equal(pi, ti[:m]) and torch.equal(pd, td[:m])):
        raise AssertionError(f"{where}: the pruned tree differs from the tree")


def sharded_state(idx) -> dict:
    """A sharded index's state on the host, by name."""
    import torch

    out = {f"stack.{k}": v.cpu() for k, v in idx.stack._asdict().items()}
    if idx.points is not None:
        out["points"] = idx.points.cpu()
    out["n_valid"] = torch.as_tensor(idx.n_valid)
    out["pad_max"] = torch.tensor(idx.pad_max)
    return out


def states_differ(torch, a: dict, b: dict) -> list:
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


def sharded_round_trip(torch, idx, tag: str):
    """Save ``idx``, load it at its own shard count (state bit-equal to
    ``idx``'s) and at one shard.  Returns the timings and the 1-shard
    index."""
    from repro_torch.index import ShardedHilbertIndex

    dev = idx.device
    path = os.path.join(ROOT, "build", f"smoke_sharded_{tag}")
    shutil.rmtree(path, ignore_errors=True)
    out = {}
    try:
        t0 = time.perf_counter()
        idx.save(path)
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        same = ShardedHilbertIndex.load(path, device=dev)
        out["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = ShardedHilbertIndex.load(path, n_shards=1, device=dev)
        out["reshard_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    out["reload_differs_in"] = states_differ(torch, sharded_state(same), sharded_state(idx))
    if out["reload_differs_in"] or one.n_shards != 1:
        raise AssertionError(f"sharded save -> load ({tag}): {out}")
    return out, one


def phase_sharded_device_parity(torch, cfg, pts, seed: int):
    """A 4-shard index on both devices at PARITY_ROWS: state bit-equal, every
    merge and the unmerged search within the contract; on each device the
    merges agree and save -> same-count load restores the state bit for
    bit; the 4 -> 1 reshard's state bit-equal across devices, its search
    within the contract."""
    from repro_torch.data import ann_datasets
    from repro_torch.index import SearchParams, ShardedHilbertIndex

    queries = ann_datasets.lowrank_embeddings(64, 384, seed=seed + 1)
    params = SearchParams(k1=48, k2=384, h=2, k=30)
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        idx = ShardedHilbertIndex.build(pts, cfg, n_shards=SHARDS, device=dev)
        res = sharded_searches(idx, queries, params)
        check_merges_agree(torch, res, f"sharded_device_parity ({dev})")
        trip, one = sharded_round_trip(torch, idx, dev)
        res["resharded"] = [t.cpu() for t in one.search(queries, params)]
        out[dev] = (sharded_state(idx), one.single.array_bundle(), res, trip,
                    time.perf_counter() - t0)
    (gs, g1, gres, gtrip, t_gpu), (cs, c1, cres, ctrip, t_cpu) = out["cuda"], out["cpu"]
    report = {"phase": "sharded_device_parity", "n": pts.shape[0], "shards": SHARDS,
              "differ": states_differ(torch, cs, gs), "resharded_differ": lsm_differ(c1, g1),
              "gpu_s": t_gpu, "cpu_s": t_cpu, "round_trip": {"cuda": gtrip, "cpu": ctrip},
              "max_abs_dist_diff": {k: float((gres[k][1] - cres[k][1]).abs().max())
                                    for k in gres}}
    emit(report)
    if report["differ"] or report["resharded_differ"]:
        raise AssertionError(f"cuda sharded index differs from cpu in {report['differ']}"
                             f" (resharded: {report['resharded_differ']})")
    for k in ("tree", "gather", "tree_prune", "resharded"):
        (gi, gd), (ci, cd) = gres[k], cres[k]
        torch.testing.assert_close(gd, cd, rtol=DIST_RTOL, atol=DIST_ATOL)
        assert_ids_equal_up_to_ties(ci, gi, cd)
    (gi, gd), (ci, cd) = gres["local"], cres["local"]
    for r in range(SHARDS):
        torch.testing.assert_close(gd[r], cd[r], rtol=DIST_RTOL, atol=DIST_ATOL)
        assert_ids_equal_up_to_ties(ci[r], gi[r], cd[r])


def phase_sharded(torch, cfg, params, points, queries, truth, single_recall: float,
                  recall_floor: float):
    """Task 1 on SHARDS logical shards of the card, at full width: the build,
    8192 queries with the tree and gather merges, SHARDED_CUT_QUERIES with
    the pruned tree and unmerged, recall@30 against phase ``recall``'s
    exact neighbours; then
    save -> load and a reshard on the first SHARDED_CHECK_ROWS rows.
    Returns the launches of the build and of the tree search."""
    from repro_torch.index import HilbertIndex, ShardedHilbertIndex

    n, nq = points.shape[0], queries.shape[0]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    idx = ShardedHilbertIndex.build(points, cfg, n_shards=SHARDS, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = read_launches(torch)
    emit({"phase": "sharded_build", "n": n, "shards": SHARDS,
          "n_valid": idx.n_valid.tolist(), "pad_max": idx.pad_max, "total_s": build_s,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "memory": idx.memory_report(), "launches": build_launches})
    require_launched("sharded build", build_launches, ["pack_bits"])

    res, runs, launches = {}, {}, None
    for name, kw in (("tree", {}), ("gather", dict(merge="gather")),
                     ("tree_prune", dict(merge="tree", prune=True)), ("local", None)):
        qq = queries if name in ("tree", "gather") else queries[:SHARDED_CUT_QUERIES]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        if kw is None:
            out = idx.search_local(qq, params)
        else:
            out = idx.search(qq, params, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_launches(torch)
        chunks = idx.last_dispatch_count
        if name == "tree":
            launches = counts
            require_launched("sharded", counts, ["hamming_rows", "qdist_windows",
                                                 "pack_bits"])
        res[name] = out
        runs[name] = {"ms_per_query": sec * 1e3 / qq.shape[0], "queries": qq.shape[0],
                      "seconds": sec, "chunks": chunks,
                      "launches_per_chunk": {k: v / chunks for k, v in counts.items() if v},
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    check_merges_agree(torch, res, "sharded")
    ids, dists = res["tree"]
    if ids.shape != (nq, params.k) or not torch.isfinite(dists).all():
        raise AssertionError(f"bad sharded result: shape {tuple(ids.shape)}")
    hits = (ids.long()[:, :, None] == truth[:, None, :]).any(-1).sum().item()
    recall = hits / (nq * params.k)
    emit({"phase": "sharded", "queries": nq, "shards": SHARDS, "runs": runs,
          "recall_at_30": recall, "single_device_recall_at_30": single_recall,
          "floor": recall_floor, "launches": launches})
    if recall < recall_floor:
        raise AssertionError(f"sharded recall@30 {recall} below floor {recall_floor}")
    del idx, res, ids, dists
    torch.cuda.empty_cache()

    rows = min(SHARDED_CHECK_ROWS, n)
    small_cfg = dataclasses.replace(cfg, store_points=True)
    small = ShardedHilbertIndex.build(points[:rows], small_cfg, n_shards=SHARDS,
                                      device="cuda")
    trip, one = sharded_round_trip(torch, small, "full")
    q = queries[:CHUNK_QUERIES]
    single = HilbertIndex.build(points[:rows], small_cfg, device="cuda")
    trip["reshard_bit_equal_to_single"] = all(
        torch.equal(a, b) for a, b in zip(one.search(q, params), single.search(q, params)))
    emit({"phase": "sharded_bundles", "n": rows, "shards": SHARDS, **trip})
    if not trip["reshard_bit_equal_to_single"]:
        raise AssertionError("the 1-shard reshard differs from a HilbertIndex build")
    del small, one, single
    torch.cuda.empty_cache()
    return {"sharded_build": build_launches, "sharded": launches}


def phase_sharded_task2(torch, points, params, sample, truth, single_recall: float):
    """Task 2 on SHARDS logical shards (``distributed_knn_graph``): first S
    shards against one on SHARDED_CHECK_ROWS rows over
    SHARDED_TASK2_PARITY_ORDERS orders (bit-equal), and the halo windows'
    kernel against its plain version at the full graph's shape; then the
    full graph, overflow 0, recall@15 on phase ``task2``'s sampled rows
    beside its single-device recall.  Returns the launches of the full
    graph and the halo check's report."""
    from repro_torch.configs import gooaq
    from repro_torch.core import distributed

    rows = min(SHARDED_CHECK_ROWS, points.shape[0])
    pp = dataclasses.replace(params, n_orders=SHARDED_TASK2_PARITY_ORDERS)
    t0 = time.perf_counter()
    many = distributed.distributed_knn_graph(points[:rows], pp, gooaq.FOREST, SHARDS)
    one = distributed.distributed_knn_graph(points[:rows], pp, gooaq.FOREST, 1)
    equal = torch.equal(many[0], one[0]) and torch.equal(many[1], one[1])
    emit({"phase": "sharded_task2_parity", "n": rows, "n_orders": pp.n_orders,
          "bit_equal_to_one_shard": equal, "overflow": [many[2], one[2]],
          "seconds": time.perf_counter() - t0})
    if not equal or many[2] or one[2]:
        raise AssertionError("the sharded graph differs from one shard's, or overflowed")
    del many, one
    torch.cuda.empty_cache()
    halo = phase_sharded_halo_kernel(torch, points, params)

    n = points.shape[0]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ids, d2, overflow = distributed.distributed_knn_graph(points, params, gooaq.FOREST,
                                                          SHARDS)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    launches = read_launches(torch)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require_launched("sharded task-2", launches, ["hamming_rows", "pack_bits"])
    rows_ = torch.arange(n, device=ids.device, dtype=ids.dtype)[:, None]
    if (ids.shape != (n, params.k) or not torch.isfinite(d2).all() or (ids < 0).any()
            or (ids == rows_).any() or (d2[:, 1:] < d2[:, :-1]).any()):
        raise AssertionError(f"bad sharded graph: shape {tuple(ids.shape)}")
    got = ids[sample].long()
    recall = (got[:, :, None] == truth[:, None, :]).any(-1).sum().item() / (
        sample.numel() * params.k)
    emit({"phase": "sharded_task2", "n": n, "shards": SHARDS,
          "params": dataclasses.asdict(params), "graph_s": graph_s, "peak_gib": peak,
          "overflow": overflow, "recall_at_15": recall,
          "single_device_recall_at_15": single_recall, "rows": sample.numel(),
          "floor": SHARDED_TASK2_RECALL_FLOOR, "tol": SHARDED_TASK2_RECALL_TOL,
          "launches": launches})
    if overflow:
        raise AssertionError(f"sharded graph overflowed: {overflow} rows dropped")
    if (recall < SHARDED_TASK2_RECALL_FLOOR
            or recall < single_recall - SHARDED_TASK2_RECALL_TOL):
        raise AssertionError(f"sharded recall@15 {recall} against {single_recall} "
                             "single-device")
    del ids, d2
    torch.cuda.empty_cache()
    phase_sharded_task2_profile(torch, points, params)
    return {"sharded_task2": launches}, halo


def sharded_graph_setup(torch, points, params):
    """What ``distributed_knn_graph`` derives from the points before its
    orders, and the first order's curve: ``(group, quant, codes, sketches,
    lo, hi, perm, flip)``."""
    import numpy as np

    from repro_torch.core import quantize, sketch
    from repro_torch.core.shard_group import ShardGroup

    d = points.shape[1]
    quant = quantize.fit(points, bits=4)
    codes = quantize.encode(quant, points)
    sks = sketch.sketches_from_codes(codes, bits=4)
    rng = np.random.default_rng(params.seed)
    perm = torch.as_tensor(rng.permutation(d).astype(np.int32), device=points.device)
    flip = torch.as_tensor(rng.integers(0, 2, d).astype(bool), device=points.device)
    return (ShardGroup(SHARDS, points.device), quant, codes, sks, points.amin(0),
            points.amax(0), perm, flip)


def phase_sharded_halo_kernel(torch, points, params) -> dict:
    """Kernel 1 where the sharded graph launches it: one order's halo
    windows over SHARDS shards of ``points`` (the graph's first order, k1
    as ``params``).  Every distance ``halo_window_candidates`` gives a real
    candidate must equal ``hamming_rows_indexed_ref`` on the same extended
    table and positions, and every other must be 2**30."""
    from repro_torch.configs import gooaq
    from repro_torch.core import distributed
    from repro_torch.kernels.hamming import hamming_rows_indexed_ref

    group, _, _, sks, lo, hi, perm, flip = sharded_graph_setup(torch, points, params)
    _, pay, n_valid, ovf = distributed.distributed_hilbert_order(
        group, points, gooaq.FOREST, lo, hi, perm, flip, payload={"sk": sks})
    gid, sk = pay["gid"], pay["sk"]
    cand, dist = distributed.halo_window_candidates(group, gid, sk, n_valid, params.k1)
    _, ext_s, pos = distributed.halo_tables(group, gid, sk, n_valid, params.k1)
    max_err, compared = 0, 0
    for r in range(SHARDS):
        for a in range(0, pos.shape[0], HALO_CHECK_ROWS):
            b = a + HALO_CHECK_ROWS
            ref = hamming_rows_indexed_ref(sk[r, a:b].contiguous(), ext_s[r], pos[a:b])
            c = cand[r, a:b]
            real = (c >= 0) & (c != gid[r, a:b, None])
            want = torch.where(real, ref, 2**30)
            max_err = max(max_err, int((dist[r, a:b] - want).abs().max()))
            compared += int(real.sum())
    report = {"phase": "sharded_halo_kernel", "n": points.shape[0], "shards": SHARDS,
              "rows_a_shard": pos.shape[0], "k1": params.k1,
              "table_rows": ext_s.shape[1], "sketch_words": ext_s.shape[2],
              "distances_compared": compared, "max_abs_err": max_err,
              "overflow": int(ovf.sum())}
    emit(report)
    if max_err or not compared or report["overflow"]:
        raise AssertionError(f"halo windows' hamming_rows_indexed: {report}")
    del cand, dist, ext_s, pos, pay, sk, gid
    torch.cuda.empty_cache()
    return report


def phase_sharded_task2_profile(torch, points, params, top: int = 12):
    """Where one order of the sharded graph goes: ``graph_order``'s stages
    (keys, sample sort, halo windows, routing home, merge) timed one by one
    with a synchronize between, the final ADC ranking once, then the device
    time by kernel of one order under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import gooaq
    from repro_torch.core import distributed

    n = points.shape[0]
    group, quant, codes, sks, lo, hi, perm, flip = sharded_graph_setup(
        torch, points, params)
    best_id = torch.full((n, params.k2), -1, dtype=torch.int32, device=points.device)
    best_d = torch.full((n, params.k2), 2**30, dtype=torch.int32, device=points.device)

    def one_order():
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()

        def mark(name):
            nonlocal t0
            torch.cuda.synchronize()
            stages[f"{name}_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()

        distributed.graph_order(group, points, sks, gooaq.FOREST, lo, hi, perm, flip,
                                best_id, best_d, params.k1, stage=mark)
        return stages

    one_order()  # warm
    stages = one_order()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    distributed.final_ranking(points, best_id, quant, codes, params.k)
    torch.cuda.synchronize()
    final_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_order()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, kernels, ops, _ = device_time(prof, top)
    emit({"phase": "sharded_task2_profile", "shards": SHARDS, "stages_s": stages,
          "final_adc_s": final_s,
          "graph_estimate_s": params.n_orders * sum(stages.values()) + final_s,
          "profiled_wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms if device_ms else None,
          "top_kernels": kernels, "top_ops": ops})


# -- the sharded streaming layout (ShardedMutableHilbertIndex) ------------------------


def sharded_lsm_state(idx) -> dict:
    """Every array of a ShardedMutableHilbertIndex's state, on the host
    (buffer slots past each shard's count left out: a flush leaves stale
    rows there)."""
    import numpy as np

    state = {"next_id": np.asarray(idx._lsm.next_id), "gen": np.asarray(idx._gen),
             "rr": np.asarray(idx._rr), "alive": idx._lsm.alive.copy(),
             "buf_count": idx._buf_count.copy()}
    for s, c in enumerate(idx._buf_count.tolist()):
        state[f"buf{s}.ids"] = idx._buf_ids[s, :c].copy()
        state[f"buf{s}.pts"] = idx._buf_pts[s, :c].copy()
    if idx._bounds is not None:
        for k in ("_bounds", "_route_lo", "_route_hi"):
            state[k] = getattr(idx, k).cpu().numpy()
    for i, seg in enumerate(idx.segments):
        state[f"seg{i}.meta"] = np.asarray([seg.gen, seg.pad_max, *seg.n_valid])
        state[f"seg{i}.ids_host"] = seg.ids_host
        for k, v in seg.stack._asdict().items():
            state[f"seg{i}.{k}"] = v.cpu().numpy()
        if seg.points is not None:
            state[f"seg{i}.points"] = seg.points.cpu().numpy()
        state[f"seg{i}.quant"] = np.concatenate(
            [seg.quant.boundaries.cpu().numpy(), seg.quant.centroids.cpu().numpy()], 1)
    return state


def phase_sharded_lsm_device_parity(torch, cfg, pts, seed: int):
    """A streamed 4-shard ShardedMutableHilbertIndex on both devices: 3/5
    of the rows bulk-loaded, the rest in inserts of 1000 with 100 deletes
    after every other one (seals and tier merges), deletes of half the buffered
    rows and of most of shard 0's base rows, a search that rewrites that
    generation, then ``compact()``.  After each stage the state is
    bit-equal across devices and the searches within the contract."""
    import numpy as np

    from repro_torch.data import ann_datasets
    from repro_torch.index import SearchParams, ShardedMutableHilbertIndex

    n = pts.shape[0]
    queries = ann_datasets.lowrank_embeddings(16, 384, seed=seed + 3)
    # A stage-2 pool of 128 x 5 = 640 rows: deleting all but 100 of one
    # shard's base rows (~800 at 6,000 rows) must pass it to rewrite.
    params = SearchParams(k1=48, k2=128, h=2, k=30)
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        idx = ShardedMutableHilbertIndex(cfg, n_shards=SHARDS,
                                         buffer_capacity=PARITY_SHARD_BUFFER,
                                         max_segments=3, device=dev)
        spent = count_seals_and_merges(torch, idx) if dev == "cuda" else None
        idx.bulk_load(pts[: n * 3 // 5])
        stages = {}

        def stage(name, **kw):
            ids, d2 = (t.cpu() for t in idx.search(queries, params, **kw))
            stages[name] = (sharded_lsm_state(idx), ids, d2)

        for i, s in enumerate(range(n * 3 // 5, n, 1000)):
            idx.insert(pts[s : s + 1000])
            if i % 2:
                idx.delete(rng.choice(idx._lsm.next_id, 100, replace=False))
        stage("streamed", allow_rewrite=False)
        buffered = np.concatenate([idx._buf_ids[s, :c]
                                   for s, c in enumerate(idx._buf_count.tolist())])
        base = idx.segments[0]
        idx.delete(np.concatenate([buffered[::2],
                                   base.ids_host[0, : int(base.n_valid[0]) - 100]]))
        pressure = idx.rewrite_pressure(params)
        stage("deleted", allow_rewrite=False)
        stage("rewritten", merge="gather")
        idx.compact()
        stage("compacted")
        out[dev] = {"stages": stages, "s": time.perf_counter() - t0, "spent": spent,
                    "pressure": pressure, "buffered_deleted": int(buffered[::2].size)}
    gpu, cpu = out["cuda"], out["cpu"]
    report = {"phase": "sharded_lsm_device_parity", "n": n, "shards": SHARDS,
              "gpu_s": gpu["s"], "cpu_s": cpu["s"], "seals_merges": gpu["spent"],
              "rewrite_pressure": gpu["pressure"],
              "buffered_deleted": gpu["buffered_deleted"], "stages": {}}
    for name in gpu["stages"]:
        (gs, gi, gd), (cs, ci, cd) = gpu["stages"][name], cpu["stages"][name]
        report["stages"][name] = {"differ": lsm_differ(cs, gs),
                                  "segments": int(sum(k.endswith(".meta") for k in gs)),
                                  "max_abs_dist_diff": float((gd - cd).abs().max())}
    emit(report)
    for name, r in report["stages"].items():
        if r["differ"]:
            raise AssertionError(f"cuda sharded LSM state ({name}) differs from cpu "
                                 f"in {r['differ']}")
        (_, gi, gd), (_, ci, cd) = gpu["stages"][name], cpu["stages"][name]
        torch.testing.assert_close(gd, cd, rtol=DIST_RTOL, atol=DIST_ATOL)
        assert_ids_equal_up_to_ties(ci, gi, cd)
    if gpu["spent"]["seal"][1] < 3 or gpu["spent"]["merge"][1] < 1:
        raise AssertionError(f"the parity stream ran {gpu['spent']}, not >= 3 seals "
                             "and >= 1 tier merge")
    if not (gpu["pressure"] >= 1 and gpu["buffered_deleted"] > 0):
        raise AssertionError("the parity deletes reached no buffered row or left no "
                             "generation to rewrite")
    if report["stages"]["rewritten"]["segments"] < 1 or np.array_equal(
            gpu["stages"]["deleted"][0]["gen"], gpu["stages"]["rewritten"][0]["gen"]):
        raise AssertionError("the read-triggered rewrite did not run")


def phase_sharded_lsm(torch, cfg, params, points, queries, seed: int,
                      recall_floor: float, held: list):
    """ShardedMutableHilbertIndex on SHARDS logical shards at full width;
    returns the kernel launches of its path (bulk load, stream, searches,
    compaction) and appends the compacted index to ``held`` for phase
    ``sharded_engine``.

    Bulk-load the first 5/6 of the points, stream the rest in inserts of
    ``LSM_BATCH`` rows with a 0.5 % delete every ``LSM_BUFFER`` rows and a
    search every ``SHARDED_LSM_SEARCH_EVERY`` rows; recall@30 over the
    live set, then ``compact()`` bit-equal to a fresh sharded build over
    the live rows.
    """
    import numpy as np

    from repro_torch.index import ShardedHilbertIndex, ShardedMutableHilbertIndex

    n = points.shape[0]
    bulk = n * 5 // 6
    q = queries[:LSM_QUERIES]
    rng = np.random.default_rng(seed)
    live = np.zeros(n, np.bool_)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    reset_launches()
    idx = ShardedMutableHilbertIndex(cfg, n_shards=SHARDS,
                                     buffer_capacity=SHARDED_LSM_BUFFER,
                                     max_segments=LSM_MAX_SEGMENTS)
    t0 = time.perf_counter()
    live[idx.bulk_load(points[:bulk])] = True
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    emit({"phase": "sharded_lsm_bulk", "rows": bulk, "shards": SHARDS,
          "bulk_load_s": bulk_s, "n_valid": idx.segments[0].n_valid.tolist(),
          "memory": idx.memory_report()["per_segment"]})
    spent = count_seals_and_merges(torch, idx)

    def search():
        before = read_launches(torch)
        t0 = time.perf_counter()
        ids, d2 = idx.search(q, params, allow_rewrite=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        chunks = idx.last_dispatch_count
        per_chunk = {k: (v - before[k]) / chunks for k, v in read_launches(torch).items()
                     if v > before[k]}
        return ids, d2, sec, per_chunk

    pos, rnd, insert_s = bulk, 0, 0.0
    while pos < n:
        end = min(pos + LSM_BUFFER, n)
        t0 = time.perf_counter()
        for s in range(pos, end, LSM_BATCH):
            got = idx.insert(points[s : min(s + LSM_BATCH, end)])
            if not np.array_equal(got, np.arange(s, s + got.size)):
                raise AssertionError(f"insert at row {s} returned ids {got[:4]}...")
            live[got] = True
        torch.cuda.synchronize()
        insert_s += time.perf_counter() - t0
        pos = end
        live_ids = np.flatnonzero(live)
        dead = rng.choice(live_ids, int(LSM_DELETE * live_ids.size), replace=False)
        if idx.delete(dead) != dead.size:
            raise AssertionError("delete of live ids did not tombstone them all")
        live[dead] = False
        rnd += 1
        if (pos - bulk) % SHARDED_LSM_SEARCH_EVERY == 0 or pos == n:
            ids, d2, sec, per_chunk = search()
            emit({"phase": "sharded_lsm_round", "round": rnd,
                  "rows_inserted": pos - bulk, "insert_s": insert_s,
                  "ms_per_query": sec * 1e3 / q.shape[0], "n_segments": idx.n_segments,
                  "n_buffered": idx.n_buffered,
                  "segment_rows": [seg.n_owned for seg in idx.segments],
                  "seal": list(spent["seal"]), "merge": list(spent["merge"]),
                  "launches_per_chunk": per_chunk,
                  "rewrite_pressure": idx.rewrite_pressure(params)})
            insert_s = 0.0
    live_ids = np.flatnonzero(live)
    found = ids[ids >= 0].cpu().numpy()
    if (idx.n_live != live_ids.size or not np.array_equal(idx._lsm.alive, live)
            or ids.shape != (q.shape[0], params.k) or not torch.isfinite(d2).all()
            or not live[found].all()):
        raise AssertionError("streamed sharded search returned dead ids or bad shapes")
    if spent["seal"][1] < 3 or spent["merge"][1] < 1:
        raise AssertionError(f"the stream ran {spent}, not >= 3 seals and >= 1 merge")
    live_t = torch.from_numpy(live_ids).to(points.device)
    truth = live_t[exact_topk(torch, points[live_t], q, params.k)]
    hits = (ids.long()[:, :, None] == truth[:, None, :]).any(-1).sum().item()
    recall = hits / (q.shape[0] * params.k)
    del truth

    del idx.flush, idx._merge_segments  # the timing wrappers
    t0 = time.perf_counter()
    idx.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    cids, cd = idx.search(q, params)
    launches = read_launches(torch)
    require_launched("sharded_lsm", launches, ["hamming_rows", "qdist_windows",
                                               "pack_bits"])
    t0 = time.perf_counter()
    fresh = ShardedHilbertIndex.build(points[live_t], cfg, n_shards=SHARDS)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    fids, fd = fresh.search(q, params)
    fids = torch.where(fids >= 0, live_t.to(torch.int32)[fids.clamp_min(0).long()], -1)
    seg = idx.segments[0]
    stack_differ = [k for k, v in fresh.stack._asdict().items() if k != "id_map"
                    and not torch.equal(v, getattr(seg.stack, k))]
    if not torch.equal(live_t.to(torch.int32)[fresh.stack.id_map.long()], seg.stack.id_map):
        stack_differ.append("id_map")
    same = not stack_differ and torch.equal(cids, fids) and torch.equal(cd, fd)
    del fresh, seg
    emit({"phase": "sharded_lsm", "seconds": time.perf_counter() - t_phase,
          "queries": q.shape[0], "recall_at_30": recall, "floor": recall_floor,
          "live": int(live_ids.size), "seal": spent["seal"], "merge": spent["merge"],
          "compact_s": compact_s, "fresh_build_s": fresh_s,
          "compacted_stack_differs_in": stack_differ,
          "compacted_equals_fresh_build": same,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches})
    if recall < recall_floor:
        raise AssertionError(f"sharded LSM recall@30 {recall} below floor {recall_floor}")
    if not same:
        raise AssertionError(f"sharded compact() differs from a fresh sharded build "
                             f"(stack: {stack_differ})")
    held.append(idx)
    return {"sharded_lsm": launches}


def close_wal(index) -> None:
    wal = index.detach_wal()
    if wal is not None:
        wal.close()


def phase_sharded_lsm_bundles(torch, cfg, params, points, queries, seed: int):
    """Format-4 bundles on the first SHARDED_CHECK_ROWS rows: save, then WAL
    on, inserts and deletes, the index dropped and loaded with WAL replay
    (state and search bit-equal to the live index); saved again, a reshard
    on load to 2 shards (search bit-equal to a fresh 2-shard build over the
    live rows) and ``load_sharded_mutable_as_mutable`` (search bit-equal to
    a HilbertIndex build over the live rows)."""
    import numpy as np

    from repro_torch.index import (HilbertIndex, ShardedHilbertIndex,
                                   ShardedMutableHilbertIndex, WalConfig,
                                   load_sharded_mutable_as_mutable)

    rows = min(SHARDED_CHECK_ROWS, points.shape[0])
    q = queries[:CHUNK_QUERIES]
    rng = np.random.default_rng(seed)
    path = os.path.join(ROOT, "build", "smoke_sharded_lsm")
    shutil.rmtree(path, ignore_errors=True)
    out = {"phase": "sharded_lsm_bundles", "n": rows, "shards": SHARDS}
    try:
        idx = ShardedMutableHilbertIndex(cfg, n_shards=SHARDS, buffer_capacity=4096,
                                         max_segments=LSM_MAX_SEGMENTS)
        first = rows * 3 // 4
        idx.bulk_load(points[:first])
        for s in range(first, first + 5 * 4096, 4096):
            idx.insert(points[s : s + 4096])
        idx.delete(rng.choice(idx._lsm.next_id, 1000, replace=False))
        t0 = time.perf_counter()
        idx.save(path)
        out["save_s"] = time.perf_counter() - t0
        idx.enable_wal(path, WalConfig())
        for s in range(first + 5 * 4096, rows, 4096):
            idx.insert(points[s : min(s + 4096, rows)])
        idx.delete(rng.choice(np.flatnonzero(idx._lsm.alive), 1000, replace=False))
        idx.wal.sync()
        want_state, want = sharded_lsm_state(idx), idx.search(q, params)
        idx.detach_wal().close()
        del idx
        t0 = time.perf_counter()
        rec = ShardedMutableHilbertIndex.load(path)
        out["wal_replay_load_s"] = time.perf_counter() - t0
        got = rec.search(q, params)
        out["replay_differs_in"] = lsm_differ(want_state, sharded_lsm_state(rec))
        out["replay_search_bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
        rec.save(path)  # the WAL's records are now in the checkpoint
        close_wal(rec)
        live_ids = np.flatnonzero(rec._lsm.alive)
        del rec
        live_t = torch.from_numpy(live_ids).to(points.device)

        def mapped(ids):
            return torch.where(ids >= 0, live_t.to(torch.int32)[ids.clamp_min(0).long()], -1)

        t0 = time.perf_counter()
        two = ShardedMutableHilbertIndex.load(path, n_shards=2)
        out["reshard_load_s"] = time.perf_counter() - t0
        close_wal(two)
        fi, fd = ShardedHilbertIndex.build(points[live_t], cfg, n_shards=2).search(q, params)
        ti, td = two.search(q, params)
        out["reshard_equals_fresh_build"] = (two.n_shards == 2 and torch.equal(ti, mapped(fi))
                                             and torch.equal(td, fd))
        del two
        t0 = time.perf_counter()
        one = load_sharded_mutable_as_mutable(path)
        out["as_mutable_load_s"] = time.perf_counter() - t0
        close_wal(one)
        fi, fd = HilbertIndex.build(points[live_t], cfg).search(q, params)
        mi, md = one.search(q, params)
        out["as_mutable_equals_build"] = torch.equal(mi, mapped(fi)) and torch.equal(md, fd)
        del one
    finally:
        shutil.rmtree(path, ignore_errors=True)
    emit(out)
    if not (not out["replay_differs_in"] and out["replay_search_bit_equal"]
            and out["reshard_equals_fresh_build"] and out["as_mutable_equals_build"]):
        raise AssertionError(f"sharded LSM bundles: {out}")
    torch.cuda.empty_cache()


def phase_sharded_engine(torch, params, points, queries, held: list):
    """RetrievalEngine over phase ``sharded_lsm``'s index (taken from
    ``held``): the engine phase's serve threads and 256-query clients, a
    writer of ENGINE_WRITE_BATCH rows every ENGINE_WRITE_PAUSE_S with
    rolling expiry, background maintenance and a 25 % recall probe (on from
    the warm-up), in one
    window of at least SHARDED_ENGINE_REQUESTS requests and one swap (a
    maintenance cycle is forced at its start, under that load); the
    probe held to an offline exact evaluation; then a last forced
    maintenance equal to a fresh sharded build over the live rows.
    Returns the kernel launches of its path."""
    import threading

    import numpy as np

    from repro_torch.index import ShardedHilbertIndex
    from repro_torch.obs import (LatencyRecorder, RecallProbe, RecallProbeConfig,
                                 recall_at_k)
    from repro_torch.serve import MaintenancePolicy, RetrievalEngine

    index = held.pop()
    n = points.shape[0]
    bulk = n * 5 // 6
    q_host = queries.cpu().numpy()
    stream = points[bulk:].cpu().numpy()
    cap = n + 4_000_000
    src_row = np.full(cap, -1, np.int64)  # external id -> row of `points`
    live = np.zeros(cap, np.bool_)
    src_row[:n] = np.arange(n)  # the LSM phase inserted row i as id i
    live[: index._lsm.next_id] = index._lsm.alive
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    reset_launches()
    probe = RecallProbe(RecallProbeConfig(window=1 << 20, **ENGINE_PROBE))
    kept, k_lock = [], threading.Lock()
    inner_offer = probe.offer

    def offer(q, got_ids, k, idx):  # under the engine's read lock
        with k_lock:
            ok = inner_offer(q, got_ids, k, idx)
            if ok:
                kept.append((q.copy(), got_ids.copy(), k, idx.snapshot()))
        return ok

    probe.offer = offer
    eng = RetrievalEngine(index, params, maintenance=MaintenancePolicy(
        max_segments=4, max_tombstone_ratio=0.5, poll_interval_s=0.05),
        serve_threads=2, compaction="thread", start=True)
    del index
    load = EngineLoad(eng, q_host, stream, bulk, src_row, live)
    forced_errors = []

    def forced_cycle():
        try:
            eng.maintain_once(force=True)
        except BaseException as e:  # surfaced below
            forced_errors.append(e)

    forced = threading.Thread(target=forced_cycle)
    try:
        eng.recall_probe = probe  # on from the warm-up, so it keeps batches early
        warm = load.run_clients(lambda k: k >= 2 * ENGINE_CLIENTS)
        eng.metrics.batch_latency = LatencyRecorder()
        swaps0 = eng.metrics.counter("swaps")
        t_start = time.perf_counter()
        load.start_writer()
        forced.start()

        def until(k):
            swaps = eng.metrics.counter("swaps") - swaps0
            over = time.perf_counter() - t_start > SHARDED_ENGINE_CAP_S
            return over or (k >= SHARDED_ENGINE_REQUESTS and swaps >= 1
                            and len(kept) >= SHARDED_ENGINE_KEPT)

        tickets = load.run_clients(until)
        t_end = time.perf_counter()
        load.stop_writer()
        forced.join(300)
        eng.recall_probe = None
        if forced_errors or forced.is_alive():
            raise AssertionError(f"the window's forced maintenance failed: "
                                 f"{forced_errors[:1]}")
        stats = _window_stats(tickets, eng.metrics.batch_latency, [], t_start, t_end)
        stats.update({"phase": "sharded_engine_window", "window": "churn_probe",
                      "swaps": eng.metrics.counter("swaps") - swaps0,
                      "writes": dict(load.writes), "warmup_requests": len(warm),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "maintenance": {k: eng.metrics.counter(k) for k in (
                          "maintenance_runs", "maintenance_failures",
                          "maintenance_timeouts")},
                      "last_maintenance_error": repr(eng.last_maintenance_error),
                      "last_swap_timeline": {
                          k: v for k, v in (eng.last_swap_timeline or {}).items()
                          if k.endswith("_ms") or k in ("log_depth", "replay_rounds")}})
        emit(stats)
        if stats["swaps"] < 1:
            raise AssertionError("no swap in the sharded engine window")
        want_samples = sum(q.shape[0] for q, _, _, _ in kept)
        deadline = time.perf_counter() + 300
        while len(probe._window) < want_samples:
            probe.score_pending()
            if time.perf_counter() > deadline:
                raise AssertionError("the recall probe left sampled batches unscored")
            time.sleep(0.05)
        online = probe.recall()
        t0 = time.perf_counter()
        exact = exact_by_id(torch, points, src_row)
        per_query, served_equal = [], 0
        for q, got_ids, k, snap in kept:
            snap_ids = snap.search(q, params, backend=eng.backend,
                                   query_chunk=eng.query_chunk, allow_rewrite=False)[0]
            served_equal += int(np.array_equal(snap_ids.cpu().numpy(), got_ids))
            per_query.append(recall_at_k(got_ids, exact(q, snap._lsm.alive, k)))
        del exact
        offline = float(np.concatenate(per_query).mean()) if per_query else float("nan")
        check = {"phase": "sharded_engine_probe_check", "batches_kept": len(kept),
                 "online_recall_at_30": online, "offline_recall_at_30": offline,
                 "served_equals_snapshot_search": served_equal,
                 "diff": abs(online - offline), "tolerance": ENGINE_RECALL_TOL,
                 "offline_s": time.perf_counter() - t0}
        emit(check)
        kept.clear()
        if not (check["batches_kept"] and check["diff"] <= ENGINE_RECALL_TOL):
            raise AssertionError(f"sharded probe recall {online} disagrees with the "
                                 f"offline evaluation {offline}")
        if served_equal != check["batches_kept"]:
            raise AssertionError("served sharded batches differ from their snapshot's "
                                 "own search")

        t0 = time.perf_counter()
        if not eng.maintain_once(force=True):
            raise AssertionError("the last forced maintenance did not swap")
        final_s = time.perf_counter() - t0
        launches = read_launches(torch)
        require_launched("sharded_engine", launches,
                         ["hamming_rows", "qdist_windows", "pack_bits"])
        final = eng.index
        n_ids = final._lsm.next_id
        live_ids = np.flatnonzero(live[:n_ids])
        alive_equal = (np.array_equal(final._lsm.alive, live[:n_ids])
                       and not live[n_ids:].any())
        q = queries[:ENGINE_CHECK_QUERIES]
        cids, cd = eng.search(q)
        live_t = torch.from_numpy(live_ids).to(points.device)
        rows = torch.from_numpy(src_row[live_ids]).to(points.device)
        fresh = ShardedHilbertIndex.build(points[rows], final.config, n_shards=SHARDS)
        fids, fd = fresh.search(q, params)
        fids = torch.where(fids >= 0, live_t.to(torch.int32)[fids.clamp_min(0).long()],
                           -1).cpu().numpy()
        del fresh, rows
        same = np.array_equal(cids, fids) and np.array_equal(cd, fd.cpu().numpy())
        emit({"phase": "sharded_engine_final", "final_maintenance_s": final_s,
              "segments": final.n_segments, "live": int(live_ids.size),
              "acknowledged_live_equal": alive_equal,
              "search_equals_fresh_build": same, "launches": launches})
        if not alive_equal:
            raise AssertionError("acknowledged writes and the sharded engine's live "
                                 "set differ")
        if not same:
            raise AssertionError("sharded engine search after the last maintenance "
                                 "differs from a fresh sharded build")
    finally:
        kept.clear()
        load.stop.set()
        if forced.ident is not None:
            forced.join(300)
        eng.stop(drain=False)
    emit({"phase": "sharded_engine", "seconds": time.perf_counter() - t_phase,
          "request_ms": stats["request_ms"], "search_ms": stats["search_ms"],
          "qps": stats["qps"], "swaps": stats["swaps"], "launches": launches})
    del eng, final, probe
    torch.cuda.empty_cache()
    return {"sharded_engine": launches}


def uncounted(torch, check):
    """Run ``check`` and restore every kernel's launch count: launches made
    to compare a path with its plain version are not the path's."""
    fns = kernel_fns()
    saved = {name: fn.launches for name, fn in fns.items()}
    try:
        return check()
    finally:
        torch.cuda.synchronize()
        for name, fn in fns.items():
            fn.launches = saved[name]


def decisive_mismatches(got, want, gap: float = LM_DECISIVE_GAP) -> int:
    """Rows whose argmax differs although ``want``'s top-1 leads by > gap."""
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > gap
    return int(((got.argmax(-1) != want.argmax(-1)) & decisive).sum())


def greedy_logits(model, prompt, steps: int, max_seq: int) -> list:
    """The logits of each pick of a greedy decode of one prompt alone."""
    logits, caches = model.prefill(prompt[None, :])
    caches = model.pad_caches(caches, max_seq)
    seen = [logits[0]]
    for t in range(len(prompt), len(prompt) + steps):
        logits, caches = model.decode_step(seen[-1].argmax()[None, None], t, caches)
        seen.append(logits[0])
    return seen


def phase_lm_device_parity(torch, seed: int):
    """gemma3_1b's smoke config in fp32, the same weights on the CPU and on
    the card: forward logits and hidden states, prefill logits and hidden
    state, and 4 decode steps past the local window, within rtol 1e-4 /
    atol 1e-5; the scheduler on 5 ragged requests with 2 slots gives the
    same tokens wherever the CPU's top-1 leads by more than 2e-2."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import Transformer, init_params
    from repro_torch.serve.scheduler import ContinuousBatchingEngine, Request

    cfg = dataclasses.replace(configs.get_config(LM_ARCH, smoke=True),
                              compute_dtype="float32")
    models = {"cpu": init_params(cfg, seed, device="cpu")}
    models["gpu"] = Transformer(cfg, device="cuda")
    models["gpu"].load_state_dict(models["cpu"].state_dict())
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 32))
    s_pre = 28  # the 4 decode steps sit past the smoke window of 8
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in LM_PARITY_LENS]
    out, tokens, secs = {}, {}, {}
    for key, m in models.items():
        t0 = time.perf_counter()
        res = {"logits": m(toks), "hidden": m(toks, return_hidden=True)}
        res["prefill"], caches, res["prefill_hidden"] = m.prefill(toks[:, :s_pre],
                                                                   with_hidden=True)
        caches = m.pad_caches(caches, toks.shape[1])
        for t in range(s_pre, toks.shape[1]):
            res[f"decode_{t}"], caches = m.decode_step(toks[:, t : t + 1], t, caches)
        out[key] = {k: v.float().cpu() for k, v in res.items()}
        eng = ContinuousBatchingEngine(m, n_slots=2, max_seq=32)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        tokens[key] = {u: r.output for u, r in eng.run().items()}
        secs[key] = time.perf_counter() - t0
    errs = {k: float((out["gpu"][k] - out["cpu"][k]).abs().max()) for k in out["cpu"]}
    mismatches = []
    for uid, p in enumerate(prompts):
        a, b = tokens["cpu"][uid], tokens["gpu"][uid]
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if first is not None:
            top2 = greedy_logits(models["cpu"], p, first, 32)[first].topk(2).values
            mismatches.append({"uid": uid, "step": first,
                               "top1_lead": float(top2[0] - top2[1])})
    emit({"phase": "lm_device_parity", "arch": cfg.name, "max_abs_err": errs,
          "rtol": LM_PARITY_RTOL, "atol": LM_PARITY_ATOL,
          "scheduler_tokens_equal": tokens["cpu"] == tokens["gpu"],
          "scheduler_mismatches": mismatches, "cpu_s": secs["cpu"],
          "gpu_s": secs["gpu"]})
    for k in out["cpu"]:
        torch.testing.assert_close(out["gpu"][k], out["cpu"][k], rtol=LM_PARITY_RTOL,
                                   atol=LM_PARITY_ATOL, msg=lambda m, k=k: f"{k}: {m}")
    if any(m["top1_lead"] > LM_DECISIVE_GAP for m in mismatches):
        raise AssertionError(f"scheduler tokens differ across devices: {mismatches}")
    if not all(len(o) == 7 for o in tokens["gpu"].values()):
        raise AssertionError(f"scheduler outputs {tokens['gpu']}")


def phase_lm_full_width(torch, seed: int):
    """gemma3_1b at its published widths in fp32: ``param_count()`` equals
    the module's parameters; on 2 sequences of 1,024 tokens, a prefill of
    1,016 (past the 512 window, so the ring compress runs) and 8 decode
    steps equal the forward pass within 2e-2, argmax equal where decisive."""
    from repro_torch import configs
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(configs.get_config(LM_ARCH), compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    model = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (LM_FULL_SEQS, LM_FULL_LEN), generator=g,
                         device="cuda")
    t0 = time.perf_counter()
    full = model(toks)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre, caches = model.prefill(toks[:, :LM_FULL_PREFILL])
    caches = model.pad_caches(caches, LM_FULL_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    ring = caches[0]  # a local layer: the last 512 positions at pos % 512
    ring_ok = (ring.k.shape[1] == cfg.pattern[0].window
               and int(ring.pos.max()) == LM_FULL_PREFILL - 1
               and int(ring.pos.min()) == LM_FULL_PREFILL - cfg.pattern[0].window)
    steps, errs, wrong = [], [float((pre - full[:, LM_FULL_PREFILL - 1]).abs().max())], 0
    wrong += decisive_mismatches(pre, full[:, LM_FULL_PREFILL - 1])
    for t in range(LM_FULL_PREFILL, LM_FULL_LEN):
        t0 = time.perf_counter()
        logits, caches = model.decode_step(toks[:, t : t + 1], t, caches)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        errs.append(float((logits - full[:, t]).abs().max()))
        torch.testing.assert_close(logits, full[:, t], rtol=LM_FULL_TOL, atol=LM_FULL_TOL)
        wrong += decisive_mismatches(logits, full[:, t])
    report = {"phase": "lm_full_width", "arch": cfg.name, "dtype": "float32",
              "param_count": cfg.param_count(), "module_params": n_params,
              "init_s": init_s, "forward_s": forward_s,
              "forward_shape": list(full.shape), "prefill_s": prefill_s,
              "decode_ms_per_step": [s * 1e3 for s in steps],
              "max_abs_err": errs, "tol": LM_FULL_TOL, "ring_compressed": ring_ok,
              "decisive_argmax_mismatches": wrong,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "seconds": time.perf_counter() - t_phase}
    emit(report)
    if n_params != cfg.param_count():
        raise AssertionError(f"module parameters {n_params} != param_count() "
                             f"{cfg.param_count()}")
    if not ring_ok or wrong:
        raise AssertionError(f"lm_full_width: ring {ring_ok}, {wrong} decisive argmax "
                             "mismatches")
    if not torch.isfinite(full).all():
        raise AssertionError("non-finite logits")


def recall_against_exact(torch, ids, hid, parts, k: int, spread=None) -> int:
    """Hits of ``ids`` (Q, k) among the exact top-k by matmul over the live
    keys: ``parts`` is [(keys, their ids, alive mask)].  ``spread``, a
    list, gets each query's exact k-th over 1st squared distance."""
    d2s, gids = [], []
    for keys, kid, alive in parts:
        d2 = (keys * keys).sum(1)[None, :] - 2.0 * (hid @ keys.T) \
            + (hid * hid).sum(1)[:, None]
        d2s.append(d2.masked_fill(~alive[None, :], torch.inf))
        gids.append(kid)
    d2, gids = torch.cat(d2s, 1), torch.cat(gids)
    top = d2.topk(k, dim=1, largest=False)
    if spread is not None:
        spread.extend((top.values[:, -1] / top.values[:, 0]).tolist())
    truth = gids[top.indices]
    return int((ids.long()[:, :, None] == truth[:, None, :]).any(-1).sum())


def phase_knn_lm(torch, seed: int) -> tuple:
    """The kNN-LM decode path at full width, through the serve driver's
    functions: gemma3_1b (bf16) builds a datastore of the hidden states of
    512 sequences of 2,049 tokens (1,048,576 keys x 1152, stored points),
    then decodes 16 prompts of 1,024 tokens for 32 steps with a lookup a
    step and churn every 4, and 16 more through ``serving_engine`` with a
    ``MaintenancePolicy`` and a forced ``compact()``.  On every step the
    kernel route equals the plain route, the mixed rows sum to 1, and
    recall@8 is read against exact top-8 over the live keys.  Returns the
    launches by path and what the later phases reuse."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.serve import MaintenancePolicy

    cfg = configs.get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    model = init_params(cfg, seed, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    corpus = torch.randint(0, cfg.vocab_size, KNN_CORPUS, generator=g, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, KNN_PROMPTS, generator=g, device="cuda")
    launches = {}
    reset_launches()
    t0 = time.perf_counter()
    keys, vals = serve.datastore_keys(model, corpus, batch=KNN_FORWARD_BATCH)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    del corpus
    t0 = time.perf_counter()
    store = serve.store_from_keys(keys, vals, store_points=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches["knn_lm_build"] = read_launches(torch)
    require_launched("knn_lm build", launches["knn_lm_build"], ["pack_bits"])
    n = keys.shape[0]
    base_ids = torch.arange(n, device="cuda")
    appended, hids, spread = [], [], []
    st = {"hits": 0, "queries": 0, "mix_err": 0.0, "check_s": 0.0}

    def on_step(t, hid, logp):
        def check():
            t0 = time.perf_counter()
            mut = store._impl
            if (t - KNN_PROMPTS[1]) % KNN_RECALL_EVERY == 0:
                ids, _ = store.lookup(hid, serve.SEARCH)
                alive = torch.from_numpy(mut._alive.copy()).to(keys.device)
                parts = [(keys, base_ids, alive[:n])]
                if appended:
                    app_ids = torch.cat([a[1] for a in appended])
                    parts.append((torch.cat([a[0] for a in appended]), app_ids,
                                  alive[app_ids]))
                st["hits"] += recall_against_exact(torch, ids, hid, parts,
                                                   serve.SEARCH.k, spread)
                st["queries"] += hid.shape[0]
            st["mix_err"] = max(st["mix_err"],
                                float((logp.exp().sum(-1) - 1.0).abs().max()))
            hids.append(hid.clone())
            if (t - KNN_PROMPTS[1]) % serve.CHURN_EVERY == 0:  # appended next
                start = mut._next_id
                appended.append((hid.clone(), torch.arange(
                    start, start + hid.shape[0], device="cuda")))
            torch.cuda.synchronize()
            st["check_s"] += time.perf_counter() - t0

        uncounted(torch, check)

    reset_launches()
    run = serve.decode(model, prompts, KNN_STEPS, store=store, lam=LM_LAM, churn=True,
                       on_step=on_step)
    launches["knn_lm"] = read_launches(torch)
    require_launched("knn_lm decode", launches["knn_lm"],
                     ["hamming_rows", "qdist_windows", "pack_bits"])
    recall = st["hits"] / (st["queries"] * serve.SEARCH.k)

    def route_check():
        """Every step's hidden states through the kernel route and the plain
        route of the store as the loop left it."""
        q = torch.cat(hids)
        ids, d2 = store.lookup(q, serve.SEARCH)
        ids_r, d2_r = store._impl.search(q, serve.SEARCH, backend="ref")
        torch.testing.assert_close(d2, d2_r, rtol=DIST_RTOL, atol=DIST_ATOL)
        return {"queries": q.shape[0], "max_abs_dist_diff": float((d2 - d2_r).abs().max()),
                "id_mismatches_within_ties": assert_ids_equal_up_to_ties(
                    ids_r.cpu(), ids.cpu(), d2_r.cpu())}

    route = uncounted(torch, route_check)

    def lookup_times():
        out = []
        for h in hids:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            store.lookup(h, serve.SEARCH)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    lookup_s = uncounted(torch, lookup_times)
    plain = serve.decode(model, prompts, KNN_ENGINE_STEPS)  # no retrieval
    rep = store.memory_report()

    eng = store.serving_engine(serve.SEARCH, maintenance=MaintenancePolicy(), start=True)
    reset_launches()
    run_e = serve.decode(model, prompts, KNN_ENGINE_STEPS, store=store, lam=LM_LAM,
                         churn=True)
    t0 = time.perf_counter()
    store.compact()
    compact_s = time.perf_counter() - t0
    eng.stop(drain=True)
    launches["knn_lm_engine"] = read_launches(torch)
    require_launched("knn_lm engine", launches["knn_lm_engine"],
                     ["hamming_rows", "qdist_windows", "pack_bits"])
    snap = eng.metrics.snapshot()
    steps_ms = (run["decode_s"] - st["check_s"]) * 1e3 / KNN_STEPS
    emit({"phase": "knn_lm", "arch": cfg.name, "dtype": cfg.compute_dtype,
          "datastore_keys": n, "dim": keys.shape[1], "forest":
          dataclasses.asdict(serve.retrieval_forest(cfg.d_model)),
          "search": dataclasses.asdict(serve.SEARCH), "lam": LM_LAM,
          "forward_s": forward_s, "build_s": build_s,
          "prefill_ms": run["prefill_s"] * 1e3, "batch": KNN_PROMPTS[0],
          "ms_per_step_with_retrieval": steps_ms,
          "ms_per_step_without_retrieval": plain["decode_s"] * 1e3 / KNN_ENGINE_STEPS,
          "lookup_ms_per_step": float(np.median(lookup_s)) * 1e3,
          "lookup_ms_per_step_max": max(lookup_s) * 1e3,
          "checks_s": st["check_s"], "recall_at_8": recall,
          "exact_d2_8th_over_1st_median": float(np.median(spread)), "route": route,
          "mix_row_sum_max_err": st["mix_err"], "memory": rep,
          "engine": {"ms_per_step": run_e["decode_s"] * 1e3 / KNN_ENGINE_STEPS,
                     "compact_s": compact_s, "epoch": eng.epoch,
                     "counters": {k: snap["counters"][k] for k in
                                  ("batches", "rows_searched", "swaps",
                                   "maintenance_runs")},
                     "latency_ms": snap["latency_ms"]},
          "launches": {k: launches[k] for k in ("knn_lm", "knn_lm_engine")},
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "seconds": time.perf_counter() - t_phase})
    if st["mix_err"] > KNN_MIX_TOL:
        raise AssertionError(f"mixed rows sum to 1 within {st['mix_err']}")
    if eng.epoch < 1 or store._impl.n_segments != 1:
        raise AssertionError("the forced compact() through the engine did not swap")
    tokens = torch.cat([run["tokens"], run_e["tokens"]], 1)
    if tokens.shape != (KNN_PROMPTS[0], KNN_STEPS + KNN_ENGINE_STEPS + 2):
        raise AssertionError(f"decoded tokens {tuple(tokens.shape)}")
    from repro_torch.serve.retrieval import RetrievalStore

    served = RetrievalStore(index=store._impl)  # the compacted index, no engine
    del store, eng
    ctx = {"model": model, "keys": keys, "vals": vals, "prompts": prompts,
           "store": served, "hids": hids, "recall": recall, "route": route}
    return launches, ctx


def phase_knn_lm_sharded(torch, ctx: dict) -> dict:
    """The same keys in ``RetrievalStore(shards=4)``: 16 decode steps of
    lookups (recall@8 beside the single store's); a store of the first
    KNN_BUNDLE_ROWS keys with writes saves and loads on 4 shards bit for
    bit, and one without writes loads on 1 shard equal to the single
    mutable layout; ``RetrievalEngine`` over a static 4-shard
    ``ShardedHilbertIndex`` of all the keys answers in batches bit-equal
    to a direct search."""
    import numpy as np

    from repro_torch.index import IndexConfig, ShardedHilbertIndex
    from repro_torch.launch import serve
    from repro_torch.serve import RetrievalEngine
    from repro_torch.serve.retrieval import RetrievalStore

    model, keys, vals, prompts = (ctx[k] for k in ("model", "keys", "vals", "prompts"))
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    launches = {}
    reset_launches()
    t0 = time.perf_counter()
    store = serve.store_from_keys(keys, vals, shards=SHARDS, store_points=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches["knn_lm_sharded_build"] = read_launches(torch)
    require_launched("knn_lm sharded build", launches["knn_lm_sharded_build"],
                     ["pack_bits"])
    n = keys.shape[0]
    parts = [(keys, torch.arange(n, device="cuda"),
              torch.ones(n, dtype=torch.bool, device="cuda"))]
    # phase knn_lm's compacted store: one segment of its live rows
    single = ctx["store"]
    seg = single.index.segments[0]
    single_parts = [(seg.index.points, torch.from_numpy(seg.ids).to(keys.device).long(),
                     torch.from_numpy(single.index._alive[seg.ids]).to(keys.device))]
    st = {"hits": 0, "single_hits": 0, "queries": 0}
    spread = []

    def on_step(t, hid, logp):
        def check():
            ids, _ = store.lookup(hid, serve.SEARCH)
            st["hits"] += recall_against_exact(torch, ids, hid, parts, serve.SEARCH.k,
                                               spread)
            ids, _ = single.lookup(hid, serve.SEARCH)
            st["single_hits"] += recall_against_exact(torch, ids, hid, single_parts,
                                                      serve.SEARCH.k)
            st["queries"] += hid.shape[0]
        uncounted(torch, check)

    reset_launches()
    run = serve.decode(model, prompts, KNN_SHARDED_STEPS, store=store, lam=LM_LAM,
                       on_step=on_step)
    launches["knn_lm_sharded"] = read_launches(torch)
    require_launched("knn_lm sharded decode", launches["knn_lm_sharded"],
                     ["hamming_rows", "qdist_windows", "pack_bits"])
    recall = st["hits"] / (st["queries"] * serve.SEARCH.k)
    report = {"phase": "knn_lm_sharded", "shards": SHARDS, "datastore_keys": n,
              "build_s": build_s, "recall_at_8": recall,
              "single_store_recall_at_8_same_queries":
                  st["single_hits"] / (st["queries"] * serve.SEARCH.k),
              "single_store_recall_at_8_knn_lm": ctx["recall"],
              "exact_d2_8th_over_1st_median": float(np.median(spread)),
              "ms_per_step_with_retrieval": run["decode_s"] * 1e3 / KNN_SHARDED_STEPS,
              "memory": store.memory_report()}
    del store

    # Bundles, on the first KNN_BUNDLE_ROWS keys.
    r = KNN_BUNDLE_ROWS
    q = torch.cat(ctx["hids"])
    path = os.path.join(ROOT, "build", "smoke_knn_store")
    shutil.rmtree(path, ignore_errors=True)
    try:
        small = serve.store_from_keys(keys[:r], vals[:r], shards=SHARDS,
                                      store_points=True)
        t0 = time.perf_counter()
        small.save(path)
        save_s = time.perf_counter() - t0
        one = RetrievalStore.load(path, n_shards=1)
        single = serve.store_from_keys(keys[:r], vals[:r], store_points=True)
        degrade_equal = (
            all(torch.equal(a, b) for a, b in zip(one.lookup(q, serve.SEARCH),
                                                   single.lookup(q, serve.SEARCH)))
            and not lsm_differ(
                {k: v for k, v in lsm_state(one.index).items() if "n_valid" not in k},
                {k: v for k, v in lsm_state(single.index).items() if "n_valid" not in k}))
        del one, single
        small.append(ctx["hids"][0], torch.zeros(ctx["hids"][0].shape[0],
                                                 dtype=torch.int32, device="cuda"))
        small.delete(np.arange(0, r, 97))
        small.save(path)
        t0 = time.perf_counter()
        back = RetrievalStore.load(path)
        load_s = time.perf_counter() - t0
        round_trip_equal = (
            not lsm_differ(sharded_lsm_state(back.sharded),
                           sharded_lsm_state(small.sharded))
            and all(torch.equal(a, b) for a, b in zip(back.lookup(q, serve.SEARCH),
                                                       small.lookup(q, serve.SEARCH))))
        del back, small
    finally:
        shutil.rmtree(path, ignore_errors=True)
    report.update({"bundle_rows": r, "save_s": save_s, "load_s": load_s,
                   "round_trip_bit_equal": round_trip_equal,
                   "load_on_one_shard_equal_to_single": degrade_equal})

    # The engine over a static sharded index of all the keys.
    t0 = time.perf_counter()
    static = ShardedHilbertIndex.build(
        keys, IndexConfig(forest=serve.retrieval_forest(keys.shape[1]),
                          store_points=False),
        n_shards=SHARDS, device="cuda")
    static_build_s = time.perf_counter() - t0
    want = uncounted(torch, lambda: static.search(q, serve.SEARCH))
    eng = RetrievalEngine(static, serve.SEARCH, max_batch=64)
    cuts = [0, 3, 40, 41, 128, 200, q.shape[0]]
    reset_launches()
    tickets = [eng.submit(q[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    while eng.step():
        pass
    launches["knn_lm_static_engine"] = read_launches(torch)
    got = [np.concatenate([t.result(0)[i] for t in tickets]) for i in (0, 1)]
    engine_equal = (np.array_equal(got[0], want[0].cpu().numpy())
                    and np.array_equal(got[1], want[1].cpu().numpy()))
    report.update({"static_engine": {"build_s": static_build_s, "queries": q.shape[0],
                                     "batches": eng.metrics.counter("batches"),
                                     "bit_equal_to_direct_search": engine_equal},
                   "launches": launches,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "seconds": time.perf_counter() - t_phase})
    emit(report)
    del eng, static
    if not (round_trip_equal and degrade_equal and engine_equal):
        raise AssertionError(f"knn_lm_sharded: round trip {round_trip_equal}, one shard "
                             f"{degrade_equal}, static engine {engine_equal}")
    require_launched("knn_lm static engine", launches["knn_lm_static_engine"],
                     ["hamming_rows", "qdist_windows", "pack_bits"])
    return launches


def phase_scheduler(torch, ctx: dict, seed: int) -> dict:
    """``ContinuousBatchingEngine`` at full width (bf16): 8 slots, max_seq
    2,048, 24 seeded requests with prompts of 64-1,024 tokens and 32 new
    tokens each, sampled through ``knn_lm_mix`` over phase knn_lm's
    (compacted) store; every request ends with 33 tokens."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.serve.scheduler import (ContinuousBatchingEngine, Request,
                                             knn_lm_sampler)

    model = ctx["model"]
    rng = np.random.default_rng(seed + 2)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab_size,
                                               int(rng.integers(SCHED_PROMPT[0],
                                                                SCHED_PROMPT[1] + 1))),
                    max_new_tokens=SCHED_NEW) for i in range(SCHED_REQUESTS)]
    eng = ContinuousBatchingEngine(
        model, n_slots=SCHED_SLOTS, max_seq=SCHED_MAX_SEQ,
        sample=knn_lm_sampler(ctx["store"], serve.SEARCH, lam=LM_LAM))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run(max_steps=10 * SCHED_REQUESTS * SCHED_NEW)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(torch)
    lens = sorted(len(r.output) for r in done.values())
    tokens = sum(lens)
    emit({"phase": "scheduler", "slots": SCHED_SLOTS, "max_seq": SCHED_MAX_SEQ,
          "requests": SCHED_REQUESTS, "prompt_tokens": sum(len(r.prompt) for r in reqs),
          "new_tokens_each": SCHED_NEW, "output_lens": sorted(set(lens)),
          "tokens": tokens, "seconds": secs, "tokens_per_s": tokens / secs,
          "steps": eng.steps, "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    if len(done) != SCHED_REQUESTS or lens != [SCHED_NEW + 1] * SCHED_REQUESTS:
        raise AssertionError(f"scheduler finished {len(done)} requests, lengths {lens}")
    require_launched("scheduler", launches, ["hamming_rows", "qdist_windows",
                                             "pack_bits"])
    return {"scheduler": launches}


def train_states_equal(torch, a: dict, b: dict, rtol: float, atol: float) -> dict:
    """Max abs difference of two train states' parameters and moments (on
    the CPU), each held within rtol / atol."""
    trees = {"params": (dict(a["params"].named_parameters()),
                        dict(b["params"].named_parameters())),
             "m": (a["opt"]["m"], b["opt"]["m"]), "v": (a["opt"]["v"], b["opt"]["v"])}
    worst = {}
    for key, (ta, tb) in trees.items():
        worst[key] = 0.0
        for name, x in ta.items():
            x, y = x.detach().float().cpu(), tb[name].detach().float().cpu()
            worst[key] = max(worst[key], float((x - y).abs().max()))
            torch.testing.assert_close(x, y, rtol=rtol, atol=atol,
                                       msg=lambda m, k=f"{key} {name}": f"{k}: {m}")
    return worst


def train_device_parity(torch, arch: str, seed: int) -> dict:
    """``arch``'s smoke config in fp32 (TF32 off): the same train state on
    the CPU and on the card (carried across by ``convert``), 3 steps of 2
    microbatches each (an encoder-decoder's batch with the same random
    frames on both devices).  Returns the report; raises when losses or
    grad norms differ by more than 1e-5 relative, or parameters and
    moments after the steps by more than 1e-5 / 1e-6 (at TRAIN_PARITY_LR)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import serve
    from repro_torch.models.convert import train_state_from_jax, train_state_to_jax
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), compute_dtype="float32")
    tcfg = TrainConfig(n_microbatches=TRAIN_MICRO, optimizer=OptimizerConfig(
        lr=TRAIN_PARITY_LR, warmup_steps=1, total_steps=TRAIN_PARITY_STEPS))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, *TRAIN_PARITY_BATCH, seed=seed))
    rng = np.random.default_rng(seed)
    extra = [serve.stub_inputs(cfg, rng, TRAIN_PARITY_BATCH[0])
             for _ in range(TRAIN_PARITY_STEPS)]
    states = {"cpu": init_train_state(cfg, tcfg, seed, device="cpu")}
    states["gpu"] = train_state_from_jax(cfg, tcfg, train_state_to_jax(cfg, states["cpu"]),
                                         device="cuda")
    step = make_train_step(cfg, tcfg)
    metrics = {"cpu": [], "gpu": []}
    for dev, torch_dev in (("cpu", "cpu"), ("gpu", "cuda")):
        for s in range(TRAIN_PARITY_STEPS):
            batch = pipe.torch_batch(s, torch_dev)
            batch.update({k: torch.from_numpy(v).to(torch_dev) for k, v in extra[s].items()})
            states[dev], m = step(states[dev], batch)
            metrics[dev].append({k: float(v) for k, v in m.items()})
    rel = {k: max(abs(g[k] - c[k]) / abs(c[k]) for c, g in zip(metrics["cpu"],
                                                               metrics["gpu"]))
           for k in ("loss", "grad_norm")}
    report = {"arch": cfg.name, "steps": TRAIN_PARITY_STEPS, "microbatches": TRAIN_MICRO,
              "losses": {d: [m["loss"] for m in ms] for d, ms in metrics.items()},
              "lr": TRAIN_PARITY_LR, "max_rel_err": rel, "rtol": TRAIN_PARITY_RTOL}
    try:
        report["max_abs_err"] = train_states_equal(
            torch, states["gpu"], states["cpu"], TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL)
    except AssertionError as e:
        report["error"] = str(e)[:2000]
    if "error" not in report and max(rel.values()) > TRAIN_PARITY_RTOL:
        report["error"] = f"losses or grad norms beyond {TRAIN_PARITY_RTOL}: {rel}"
    return report


def phase_train_device_parity(torch, seed: int):
    """``train_device_parity`` of the gemma3_1b and granite_moe_1b smoke
    configs, one line each."""
    for arch in TRAIN_PARITY_ARCHS:
        report = train_device_parity(torch, arch, seed)
        emit({"phase": "train_device_parity", **report})
        if "error" in report:
            raise AssertionError(f"train_device_parity {arch}: {report['error']}")


def attention_flops(cfg, seq: int) -> int:
    """Score and value products of one sequence's causal attention, forward
    (2 x 2 x pairs x heads x head_dim); a local layer's query sees at most
    ``window`` keys."""
    from repro_torch.models.model import layer_specs

    pairs = 0
    for spec in layer_specs(cfg):
        w = spec.window if spec.window > 0 else seq
        pairs += sum(min(q + 1, w) for q in range(seq))
    return 4 * pairs * cfg.n_heads * cfg.head_dim


def train_steps(torch, cfg, tcfg, seed: int, steps: int, state=None, start: int = 0,
                extra=None) -> dict:
    """Train steps ``start`` .. ``steps - 1`` on the card from
    ``init_train_state`` (or ``state``): losses, grad norms and host ms a
    synchronized step.  ``extra(step)`` adds entries to a step's batch (an
    encoder-decoder's frames)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.train import init_train_state, make_train_step

    pipe = TokenPipeline(DataConfig(cfg.vocab_size, *TRAIN_BATCH, seed=seed))
    if state is None:
        state = init_train_state(cfg, tcfg, seed, device="cuda")
    step = make_train_step(cfg, tcfg)
    out = {"losses": [], "grad_norms": [], "ms": []}
    for s in range(start, steps):
        batch = pipe.torch_batch(s, "cuda")
        if extra is not None:
            batch.update(extra(s))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["state"], out["step"], out["pipe"] = state, step, pipe
    return out


def check_losses(name: str, losses: list) -> None:
    import math

    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")


def phase_train_full_width(torch, seed: int):
    """gemma3_1b at its published widths, bf16, remat "minimal": 8 steps of
    8 x 1,024 tokens in 2 microbatches; ms a step, tokens/s, peak memory,
    the model FLOPs of a step over the card's dense bf16 peak; no NaN, and
    the last loss below the first."""
    from repro_torch import configs
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import TrainConfig

    cfg = configs.get_config(LM_ARCH)
    assert cfg.compute_dtype == "bfloat16" and cfg.remat_policy == "minimal"
    tcfg = TrainConfig(n_microbatches=TRAIN_MICRO, optimizer=OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=max(TRAIN_FULL_STEPS // 10, 1),
        total_steps=TRAIN_FULL_STEPS))
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    run = train_steps(torch, cfg, tcfg, seed, TRAIN_FULL_STEPS)
    del run["state"]
    b, s = TRAIN_BATCH
    steady = sorted(run["ms"][2:])[len(run["ms"][2:]) // 2]
    flops = 6 * cfg.param_count() * b * s + 3 * b * attention_flops(cfg, s)
    emit({"phase": "train_full_width", "arch": cfg.name, "params": cfg.param_count(),
          "dtype": cfg.compute_dtype, "remat": cfg.remat_policy, "batch": b, "seq": s,
          "microbatches": TRAIN_MICRO, "steps": TRAIN_FULL_STEPS,
          "ms_per_step": run["ms"], "median_ms_after_2": steady,
          "tokens_per_s": b * s / (steady / 1e3),
          "first_loss": run["losses"][0], "last_loss": run["losses"][-1],
          "losses": run["losses"], "grad_norms": run["grad_norms"],
          "model_flops_per_step": flops,
          "peak": "989 TFLOP/s dense bf16 (NVIDIA H100 SXM data sheet, 700 W)",
          "model_flops_utilization": flops / (steady / 1e3) / H100_BF16_DENSE_FLOPS,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "seconds": time.perf_counter() - t_phase})
    check_losses("train_full_width", run["losses"])


def phase_moe_full_width(torch, seed: int):
    """granite_moe_1b at its published widths: a fp32 forward of 2 x 1,024
    tokens, and a prefill of 1,016 plus 8 decode steps within 1e-4 / 1e-5
    of it at a drop-free capacity (E / k: the published 1.25 drops tokens
    in a prefill by design); 8 bf16 train steps at the published capacity;
    then the scheduler serving the trained weights."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import init_params
    from repro_torch.optim import OptimizerConfig
    from repro_torch.serve.scheduler import ContinuousBatchingEngine, Request
    from repro_torch.train import TrainConfig

    published = configs.get_config(MOE_ARCH)
    cfg = dataclasses.replace(published, compute_dtype="float32",
                              capacity_factor=published.n_experts / published.topk_experts)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    model = init_params(cfg, seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (LM_FULL_SEQS, LM_FULL_LEN), generator=g,
                         device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = model(toks)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    pre, caches = model.prefill(toks[:, :LM_FULL_PREFILL])
    caches = model.pad_caches(caches, LM_FULL_LEN)
    pairs = [(pre, full[:, LM_FULL_PREFILL - 1])]
    decode_ms = []
    for t in range(LM_FULL_PREFILL, LM_FULL_LEN):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(toks[:, t : t + 1], t, caches)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        pairs.append((logits, full[:, t]))
    errs = [float((a - b).abs().max()) for a, b in pairs]
    close = all(torch.allclose(a, b, rtol=MOE_FULL_TOL[0], atol=MOE_FULL_TOL[1])
                for a, b in pairs)
    finite = bool(torch.isfinite(full).all())
    del model, full, caches, pairs
    torch.cuda.empty_cache()
    forward_gib = torch.cuda.max_memory_allocated() / 2**30

    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(n_microbatches=TRAIN_MICRO, optimizer=OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=max(MOE_TRAIN_STEPS // 10, 1),
        total_steps=MOE_TRAIN_STEPS))
    run = train_steps(torch, published, tcfg, seed, MOE_TRAIN_STEPS)
    train_gib = torch.cuda.max_memory_allocated() / 2**30
    trained = run.pop("state")["params"]
    rng = np.random.default_rng(seed + 3)
    reqs = [Request(uid=i, prompt=rng.integers(0, published.vocab_size, int(
        rng.integers(MOE_SCHED_PROMPT[0], MOE_SCHED_PROMPT[1] + 1))),
        max_new_tokens=MOE_SCHED_NEW) for i in range(MOE_SCHED_REQUESTS)]
    eng = ContinuousBatchingEngine(trained, n_slots=MOE_SCHED_SLOTS,
                                   max_seq=MOE_SCHED_MAX_SEQ)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run(max_steps=10 * MOE_SCHED_REQUESTS * MOE_SCHED_NEW)
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    lens = sorted(len(r.output) for r in done.values())
    steady = sorted(run["ms"][2:])[len(run["ms"][2:]) // 2]
    emit({"phase": "moe_full_width", "arch": cfg.name, "param_count": cfg.param_count(),
          "module_params": n_params, "active_params": cfg.active_param_count(),
          "forward": {"dtype": "float32", "capacity_factor": cfg.capacity_factor,
                      "shape": [LM_FULL_SEQS, LM_FULL_LEN], "seconds": forward_s,
                      "prefill": LM_FULL_PREFILL, "decode_ms": decode_ms,
                      "max_abs_err": errs, "rtol_atol": MOE_FULL_TOL, "within": close,
                      "peak_gib": forward_gib},
          "train": {"dtype": published.compute_dtype,
                    "capacity_factor": published.capacity_factor,
                    "batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO,
                    "ms_per_step": run["ms"], "median_ms_after_2": steady,
                    "tokens_per_s": TRAIN_BATCH[0] * TRAIN_BATCH[1] / (steady / 1e3),
                    "losses": run["losses"], "peak_gib": train_gib},
          "scheduler": {"slots": MOE_SCHED_SLOTS, "requests": MOE_SCHED_REQUESTS,
                        "steps": eng.steps, "tokens": sum(lens), "seconds": sched_s},
          "seconds": time.perf_counter() - t_phase})
    if n_params != cfg.param_count():
        raise AssertionError(f"module parameters {n_params} != param_count() "
                             f"{cfg.param_count()}")
    if not finite:
        raise AssertionError("moe_full_width: non-finite logits")
    if not close:
        raise AssertionError(f"moe_full_width: prefill / decode vs forward {errs} beyond "
                             f"rtol / atol {MOE_FULL_TOL}")
    check_losses("moe_full_width train", run["losses"])
    if len(done) != MOE_SCHED_REQUESTS or lens != [MOE_SCHED_NEW + 1] * MOE_SCHED_REQUESTS:
        raise AssertionError(f"moe scheduler finished {len(done)} requests, lengths {lens}")


def leaves_param_count_omits(cfg) -> int:
    """Parameters of the module that ``repro``'s analytic ``param_count()``
    leaves out: each SSM layer's ``conv_b`` (di + 2N) and ``dt_bias`` (H),
    the encoder's final norm's scale (d), and each layernorm's bias (d)."""
    from repro_torch.models.model import layer_specs

    specs = layer_specs(cfg)
    n = sum(cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
            for s in specs if s.mixer == "mamba")
    if cfg.is_encdec:
        n += cfg.d_model
    if cfg.norm == "layernorm":
        norms = sum(2 + s.cross_attn for s in specs) + 1  # norm1, norm2, norm_cross; final
        norms += 2 * cfg.n_enc_layers + 1 if cfg.is_encdec else 0
        n += norms * cfg.d_model
    return n


def check_params(cfg, model) -> dict:
    """``param_count()`` beside the module's parameters; they must differ by
    exactly the leaves the analytic count omits."""
    n_params = sum(p.numel() for p in model.parameters())
    omitted = leaves_param_count_omits(cfg)
    if n_params != cfg.param_count() + omitted:
        raise AssertionError(f"{cfg.name}: module parameters {n_params} != param_count() "
                             f"{cfg.param_count()} + {omitted} omitted leaves")
    return {"param_count": cfg.param_count(), "module_params": n_params,
            "omitted_by_param_count": omitted}


def prefill_decode_against_forward(torch, model, toks, s_pre: int, **extra) -> dict:
    """The forward's logits of ``toks``, then a prefill of ``s_pre`` tokens
    and a decode step a token after it: each step's logits against the
    forward's within ZOO_FULL_RTOL and an atol of ZOO_FULL_ATOL_OF_SCALE
    times the forward logits' largest magnitude (``within``); also whether
    they meet rtol 1e-4 / atol 1e-5 (``within_1e-4_1e-5``).  Returns times,
    errors and the verdicts."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = model(toks, **extra)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre, caches = model.prefill(toks[:, :s_pre], **extra)
    caches = model.pad_caches(caches, toks.shape[1])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pairs, decode_ms = [(pre, full[:, s_pre - 1])], []
    for t in range(s_pre, toks.shape[1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(toks[:, t : t + 1], t, caches)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        pairs.append((logits, full[:, t]))
    scale = float(full.abs().max())
    tol = (ZOO_FULL_RTOL, ZOO_FULL_ATOL_OF_SCALE * scale)
    out = {"shape": list(toks.shape), "prefill": s_pre, "forward_s": forward_s,
           "prefill_s": prefill_s, "decode_ms": decode_ms,
           "max_abs_err": [float((a - b).abs().max()) for a, b in pairs],
           "logits_max_abs": scale, "rtol_atol": list(tol),
           "finite": bool(torch.isfinite(full).all()),
           "within": all(torch.allclose(a, b, rtol=tol[0], atol=tol[1]) for a, b in pairs),
           "within_1e-4_1e-5": all(torch.allclose(a, b, rtol=MOE_FULL_TOL[0],
                                                  atol=MOE_FULL_TOL[1]) for a, b in pairs)}
    del full, caches, pairs
    return out


def require_within(phase: str, res: dict) -> None:
    if not (res["finite"] and res["within"]):
        raise AssertionError(f"{phase}: prefill / decode vs forward {res['max_abs_err']} "
                             f"beyond rtol / atol {res['rtol_atol']} (finite {res['finite']})")


def phase_family_device_parity(torch, seed: int):
    """The smoke configs of Mamba-2, the hybrid, the encoder-decoder and the
    VLM in fp32, the same weights on the CPU and on the card (TF32 off):
    forward logits, prefill logits and 4 decode steps within rtol 1e-4 /
    atol 1e-5, and the hidden states of the forward and the prefill within
    rtol 1e-4 / atol 1e-5 times their largest magnitude (jamba's O(1)
    hidden states differ by 1.8e-5 across devices where its logits differ
    by 3.4e-6), with the same random frames or patches; then
    ``train_device_parity`` of mamba2_780m and whisper_small."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import Transformer, init_params

    t_phase = time.perf_counter()
    report = {"phase": "family_device_parity", "rtol": LM_PARITY_RTOL,
              "atol": LM_PARITY_ATOL, "max_abs_err": {}, "train": {}}
    failures = []
    for arch in ZOO_ARCHS:
        cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                                  compute_dtype="float32")
        models = {"cpu": init_params(cfg, seed, device="cpu")}
        models["gpu"] = Transformer(cfg, device="cuda")
        models["gpu"].load_state_dict(models["cpu"].state_dict())
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab_size, (2, 32))
        extra = serve.stub_inputs(cfg, rng, 2)
        s_pre = 28
        out = {}
        for key, m in models.items():
            res = {"logits": m(toks, **extra), "hidden": m(toks, return_hidden=True, **extra)}
            res["prefill"], caches, res["prefill_hidden"] = m.prefill(
                toks[:, :s_pre], with_hidden=True, **extra)
            caches = m.pad_caches(caches, toks.shape[1])
            for t in range(s_pre, toks.shape[1]):
                res[f"decode_{t}"], caches = m.decode_step(toks[:, t : t + 1], t, caches)
            out[key] = {k: v.float().cpu() for k, v in res.items()}
        report["max_abs_err"][arch] = {k: float((out["gpu"][k] - out["cpu"][k]).abs().max())
                                       for k in out["cpu"]}
        for k, want in out["cpu"].items():
            # Logits at rtol / atol; hidden states (unscaled, O(1)) at atol
            # times their largest magnitude.
            scale = max(1.0, float(want.abs().max())) if "hidden" in k else 1.0
            if not torch.allclose(out["gpu"][k], want, rtol=LM_PARITY_RTOL,
                                  atol=LM_PARITY_ATOL * scale):
                failures.append(f"{arch} {k}")
    for arch in ZOO_TRAIN_PARITY_ARCHS:
        report["train"][arch] = train_device_parity(torch, arch, seed)
        if "error" in report["train"][arch]:
            failures.append(f"{arch} train: {report['train'][arch]['error']}")
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    if failures:
        raise AssertionError(f"family_device_parity: {failures}")


def ssd_flops(cfg, seq: int) -> int:
    """The SSD's products of one sequence's forward pass, beyond the
    projections that 6 N tokens counts: per layer and chunk of Q tokens,
    C B^T (2 Q^2 N), its decay-weighted product with the inputs
    (2 Q^2 H P), the chunk states and the state's contribution to the
    outputs (2 x 2 Q H N P)."""
    from repro_torch.models.model import layer_specs

    q, n, h, p = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    nc = -(-seq // q)
    per_layer = nc * (2 * q * q * n + 2 * q * q * h * p + 4 * q * h * n * p)
    return per_layer * sum(s.mixer == "mamba" for s in layer_specs(cfg))


def zoo_train(torch, published, seed: int, steps: int, flops_per_step: float,
              extra=None) -> tuple:
    """``steps`` bf16 train steps of ``published`` (remat as published) on
    TRAIN_BATCH in TRAIN_MICRO microbatches: the report, the trained model."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import TrainConfig

    tcfg = TrainConfig(n_microbatches=TRAIN_MICRO, optimizer=OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=max(steps // 10, 1), total_steps=steps))
    torch.cuda.reset_peak_memory_stats()
    run = train_steps(torch, published, tcfg, seed, steps, extra=extra)
    steady = sorted(run["ms"][2:])[len(run["ms"][2:]) // 2]
    b, s = TRAIN_BATCH
    rep = {"dtype": published.compute_dtype, "remat": published.remat_policy,
           "batch": b, "seq": s, "microbatches": TRAIN_MICRO, "steps": steps,
           "ms_per_step": run["ms"], "median_ms_after_2": steady,
           "tokens_per_s": b * s / (steady / 1e3), "losses": run["losses"],
           "grad_norms": run["grad_norms"], "model_flops_per_step": flops_per_step,
           "peak": "989 TFLOP/s dense bf16 (NVIDIA H100 SXM data sheet, 700 W)",
           "model_flops_utilization": flops_per_step / (steady / 1e3) / H100_BF16_DENSE_FLOPS,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return rep, run.pop("state")["params"]


def zoo_scheduler(torch, model, seed: int) -> dict:
    """``ContinuousBatchingEngine`` serving ``model``: MOE_SCHED_SLOTS slots,
    MOE_SCHED_REQUESTS requests of MOE_SCHED_PROMPT tokens, MOE_SCHED_NEW
    new each; every request must end with MOE_SCHED_NEW + 1 tokens."""
    import numpy as np

    from repro_torch.serve.scheduler import ContinuousBatchingEngine, Request

    rng = np.random.default_rng(seed + 3)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab_size, int(
        rng.integers(MOE_SCHED_PROMPT[0], MOE_SCHED_PROMPT[1] + 1))),
        max_new_tokens=MOE_SCHED_NEW) for i in range(MOE_SCHED_REQUESTS)]
    eng = ContinuousBatchingEngine(model, n_slots=MOE_SCHED_SLOTS, max_seq=MOE_SCHED_MAX_SEQ)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run(max_steps=10 * MOE_SCHED_REQUESTS * MOE_SCHED_NEW)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lens = sorted(len(r.output) for r in done.values())
    if len(done) != MOE_SCHED_REQUESTS or lens != [MOE_SCHED_NEW + 1] * MOE_SCHED_REQUESTS:
        raise AssertionError(f"scheduler finished {len(done)} requests, lengths {lens}")
    return {"slots": MOE_SCHED_SLOTS, "requests": MOE_SCHED_REQUESTS, "steps": eng.steps,
            "tokens": sum(lens), "seconds": secs, "tokens_per_s": sum(lens) / secs}


def phase_ssm_full_width(torch, seed: int):
    """mamba2_780m at its published widths (48 layers, d 1,536, N 128,
    chunk 256): a fp32 forward of 2 x 1,024 tokens and a prefill of 1,016
    plus 8 decode steps against it (``prefill_decode_against_forward``); 8
    bf16 train steps of 8 x 1,024 tokens in 2 microbatches (ms a step, tokens/s, MFU with the SSD's
    products, peak memory, the loss falling); the scheduler serving the
    trained weights."""
    from repro_torch import configs
    from repro_torch.models.model import init_params

    published = configs.get_config(SSM_ARCH)
    cfg = dataclasses.replace(published, compute_dtype="float32")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed, device="cuda")
    params = check_params(cfg, model)
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (LM_FULL_SEQS, LM_FULL_LEN), generator=g,
                         device="cuda")
    fwd = prefill_decode_against_forward(torch, model, toks, LM_FULL_PREFILL)
    fwd["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model
    torch.cuda.empty_cache()
    b, s = TRAIN_BATCH
    flops = 6 * published.param_count() * b * s + 3 * b * ssd_flops(published, s)
    train, trained = zoo_train(torch, published, seed, ZOO_TRAIN_STEPS, flops)
    sched = zoo_scheduler(torch, trained, seed)
    del trained
    emit({"phase": "ssm_full_width", "arch": cfg.name, **params,
          "forward": {"dtype": "float32", **fwd}, "train": train,
          "ssd_flops_per_sequence": ssd_flops(published, s), "scheduler": sched,
          "seconds": time.perf_counter() - t_phase})
    require_within("ssm_full_width", fwd)
    check_losses("ssm_full_width train", train["losses"])


def phase_hybrid_full_width(torch, seed: int) -> dict:
    """jamba_v01_52b at its published widths cut to one pattern block (8
    layers: attention, 7 Mamba-2, 4 dense FFNs and 4 MoE FFNs): a fp32
    forward of 2 x 1,024 tokens at drop-free capacity (E / k) and a prefill
    of 1,016 plus 8 decode steps against it; then, on the
    same weights at the published capacity, a kNN-LM store of the hidden
    states of 32 sequences of 2,049 tokens (65,536 keys x 4,096) and 4
    prompts of 1,024 tokens decoded for 8 steps with a lookup each step,
    the kernel route equal to the plain route on every step's hidden
    states.  Returns the lookups' launches by path."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params

    published = configs.get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(published, n_layers=HYBRID_LAYERS, compute_dtype="float32",
                              capacity_factor=published.n_experts / published.topk_experts)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = check_params(cfg, model)
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (LM_FULL_SEQS, LM_FULL_LEN), generator=g,
                         device="cuda")
    fwd = prefill_decode_against_forward(torch, model, toks, LM_FULL_PREFILL)
    fwd["capacity_factor"] = cfg.capacity_factor
    fwd["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()

    # The kNN-LM path at the published capacity (a serving run's; the
    # drop-free one costs 4x the expert products on the datastore's tokens).
    model.cfg = dataclasses.replace(cfg, capacity_factor=published.capacity_factor)
    corpus = torch.randint(0, cfg.vocab_size, HYBRID_KNN_CORPUS, generator=g, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, HYBRID_KNN_PROMPTS, generator=g,
                            device="cuda")
    launches = {}
    reset_launches()
    t0 = time.perf_counter()
    keys, vals = serve.datastore_keys(model, corpus, batch=HYBRID_KNN_FORWARD_BATCH)
    torch.cuda.synchronize()
    keys_s = time.perf_counter() - t0
    del corpus
    t0 = time.perf_counter()
    store = serve.store_from_keys(keys, vals)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches["hybrid_knn_lm_build"] = read_launches(torch)
    require_launched("hybrid kNN-LM build", launches["hybrid_knn_lm_build"], ["pack_bits"])
    hids = []
    reset_launches()
    run = serve.decode(model, prompts, HYBRID_KNN_STEPS, store=store, lam=LM_LAM,
                       on_step=lambda t, hid, logp: hids.append(hid.clone()))
    launches["hybrid_knn_lm"] = read_launches(torch)
    require_launched("hybrid kNN-LM decode", launches["hybrid_knn_lm"],
                     ["hamming_rows", "qdist_windows", "pack_bits"])

    def route_check():
        q = torch.cat(hids)
        ids, d2 = store.lookup(q, serve.SEARCH)
        ids_r, d2_r = store._impl.search(q, serve.SEARCH, backend="ref")
        torch.testing.assert_close(d2, d2_r, rtol=DIST_RTOL, atol=DIST_ATOL)
        return {"queries": q.shape[0], "max_abs_dist_diff": float((d2 - d2_r).abs().max()),
                "id_mismatches_within_ties": assert_ids_equal_up_to_ties(
                    ids_r.cpu(), ids.cpu(), d2_r.cpu())}

    route = uncounted(torch, route_check)
    tokens = run["tokens"]
    emit({"phase": "hybrid_full_width", "arch": cfg.name, "n_layers": cfg.n_layers,
          "published_layers": published.n_layers, **params,
          "published_param_count": published.param_count(), "init_s": init_s,
          "forward": {"dtype": "float32", **fwd},
          "knn_lm": {"capacity_factor": published.capacity_factor,
                     "datastore_keys": keys.shape[0], "dim": keys.shape[1],
                     "forest": dataclasses.asdict(serve.retrieval_forest(cfg.d_model)),
                     "search": dataclasses.asdict(serve.SEARCH), "keys_s": keys_s,
                     "build_s": build_s, "batch": HYBRID_KNN_PROMPTS[0],
                     "prefill_ms": run["prefill_s"] * 1e3,
                     "ms_per_step_with_retrieval": run["decode_s"] * 1e3 / HYBRID_KNN_STEPS,
                     "route": route, "launches": {k: launches[k] for k in launches}},
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "seconds": time.perf_counter() - t_phase})
    require_within("hybrid_full_width", fwd)
    if tokens.shape != (HYBRID_KNN_PROMPTS[0], HYBRID_KNN_STEPS + 1):
        raise AssertionError(f"hybrid kNN-LM decoded tokens {tuple(tokens.shape)}")
    return launches


def encdec_attention_flops(cfg, seq: int) -> int:
    """Score and value products of one sequence's forward pass: the
    encoder's full self-attention over its frames, the decoder's causal
    self-attention and its cross-attention to every frame."""
    f = cfg.enc_frames
    pairs = cfg.n_enc_layers * f * f
    pairs += cfg.n_layers * (seq * (seq + 1) // 2 + seq * f)
    return 4 * pairs * cfg.n_heads * cfg.head_dim


def phase_encdec_full_width(torch, seed: int):
    """whisper_small at its published widths (12 + 12 layers, d 768, 1,500
    frames): a fp32 forward of 2 x 1,024 tokens with random frames and a
    prefill of 1,016 plus 8 decode steps against it; 8 bf16
    train steps of 8 x 1,024 tokens with frames, timed as the other train
    cells (model FLOPs: 6 x the decoder's parameters x tokens, 6 x the
    encoder's x frames, 3 x the attention products)."""
    from repro_torch import configs
    from repro_torch.models.model import init_params

    published = configs.get_config(ENCDEC_ARCH)
    cfg = dataclasses.replace(published, compute_dtype="float32")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed, device="cuda")
    params = check_params(cfg, model)
    enc_params = sum(p.numel() for p in model.enc.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (LM_FULL_SEQS, LM_FULL_LEN), generator=g,
                         device="cuda")
    frames = torch.randn((LM_FULL_SEQS, cfg.enc_frames, cfg.d_model), generator=g,
                         device="cuda")
    fwd = prefill_decode_against_forward(torch, model, toks, LM_FULL_PREFILL,
                                         frames=frames)
    fwd["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, frames
    torch.cuda.empty_cache()
    b, s = TRAIN_BATCH
    dec_params = params["module_params"] - enc_params
    flops = (6 * dec_params * b * s + 6 * enc_params * b * cfg.enc_frames
             + 3 * b * encdec_attention_flops(cfg, s))

    def frames_of(step):
        fg = torch.Generator(device="cuda").manual_seed(seed + 1000 + step)
        return {"frames": torch.randn((b, cfg.enc_frames, cfg.d_model), generator=fg,
                                      device="cuda")}

    train, trained = zoo_train(torch, published, seed, ZOO_TRAIN_STEPS, flops,
                               extra=frames_of)
    del trained
    emit({"phase": "encdec_full_width", "arch": cfg.name, **params,
          "encoder_params": enc_params, "frames": cfg.enc_frames,
          "forward": {"dtype": "float32", **fwd}, "train": train,
          "seconds": time.perf_counter() - t_phase})
    require_within("encdec_full_width", fwd)
    check_losses("encdec_full_width train", train["losses"])


def phase_vlm_full_width(torch, seed: int):
    """llava_next_34b at its published widths cut to 8 of its 60 layers: a
    fp32 forward of 1 x 4,096 tokens whose first 2,880 positions are
    random patch embeddings, and a prefill of 4,088 plus 8 decode steps
    against it."""
    from repro_torch import configs
    from repro_torch.models.model import init_params

    published = configs.get_config(VLM_ARCH)
    cfg = dataclasses.replace(published, n_layers=VLM_LAYERS, compute_dtype="float32")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed, device="cuda")
    params = check_params(cfg, model)
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, VLM_LEN), generator=g, device="cuda")
    patches = torch.randn((1, cfg.n_patches, cfg.patch_dim), generator=g, device="cuda")
    fwd = prefill_decode_against_forward(torch, model, toks, VLM_LEN - 8,
                                         patches=patches)
    fwd["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": "vlm_full_width", "arch": cfg.name, "n_layers": cfg.n_layers,
          "published_layers": published.n_layers, **params,
          "published_param_count": published.param_count(), "patches": cfg.n_patches,
          "forward": {"dtype": "float32", **fwd},
          "seconds": time.perf_counter() - t_phase})
    require_within("vlm_full_width", fwd)


def phase_zoo(torch, seed: int) -> dict:
    """Phases family_device_parity, ssm_full_width, hybrid_full_width,
    encdec_full_width and vlm_full_width; returns the launches by path."""
    launches = {}
    for phase in (phase_family_device_parity, phase_ssm_full_width,
                  phase_hybrid_full_width, phase_encdec_full_width, phase_vlm_full_width):
        launches.update(phase(torch, seed) or {})
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def ep_rules(mesh, fsdp):
    """Expert parallelism alone on ``mesh``: the experts over the model axis,
    rows over the data axis, the dense layers replicated."""
    from repro_torch.sharding import make_rules

    return make_rules(mesh, heads=None, kv_heads=None, mlp=None, vocab=None, fsdp=fsdp)


def moe_ep_layer(torch, cfg, experts, seed: int, device="cuda"):
    """The MoE layer check's router, the weights of ``experts`` (each
    expert from its own generator, so a rank draws its own alone) and its
    input x."""
    d, f = cfg.d_model, cfg.d_ff

    def draw(shape, s, scale):
        g = torch.Generator(device=device).manual_seed(s)
        return torch.randn(shape, generator=g, device=device) * scale

    w = {"router": draw((d, cfg.n_experts), seed, d ** -0.5)}
    for i, (name, shape, scale) in enumerate((("w1", (d, f), d ** -0.5),
                                              ("w2", (f, d), f ** -0.5),
                                              ("w3", (d, f), d ** -0.5))):
        w[name] = torch.stack([draw(shape, seed * 1000 + 10 * e + i, scale) for e in experts])
    return w, draw((*MOE_EP_LAYER_TOKENS, d), seed + 1, 1.0)


def moe_module(cfg, weights: dict):
    """A ``MoE`` holding ``weights`` (plain tensors or DTensors) without
    allocating its own."""
    from torch import nn

    from repro_torch.models.moe import MoE

    p = MoE(cfg, "meta")
    for name, t in weights.items():
        p.register_parameter(name, nn.Parameter(t, requires_grad=True))
    return p


def moe_ep_batch(torch, cfg, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    toks = torch.randint(0, cfg.vocab_size, MOE_EP_TOKENS, generator=g, device="cuda")
    return {"tokens": toks, "labels": toks.roll(-1, dims=1),
            "mask": torch.ones(MOE_EP_TOKENS, device="cuda")}


def moe_ep_reference(torch, seed: int, path: str) -> dict:
    """The single-process runs on the card that the ranks are held to,
    saved to ``path``: the MoE layer's output, aux and gradients of x and
    the router; granite_moe_1b's logits, train_loss and every gradient."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.model import init_params, train_loss

    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(MOE_EP_LAYER_ARCH), compute_dtype="float32")
    w, x = moe_ep_layer(torch, cfg, range(cfg.n_experts), seed)
    p = moe_module(cfg, w)
    x.requires_grad_(True)
    out, aux = moe.moe_forward(cfg, p, x)
    gx, gr = torch.autograd.grad(1e-3 * (out ** 2).sum() + aux, [x, p.router])
    layer = {"out": out.detach().cpu(), "aux": aux.detach().cpu(), "g_x": gx.cpu(),
             "g_router": gr.cpu()}
    layer_gb = sum(t.nbytes for t in w.values()) / 1e9
    del w, p, x, out, gx, gr
    cfg = dataclasses.replace(configs.get_config(MOE_ARCH), compute_dtype="float32")
    m = init_params(cfg, seed, device="cuda").requires_grad_(True)
    batch = moe_ep_batch(torch, cfg, seed)
    logits = m(batch["tokens"])
    loss = train_loss(m, batch)
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(loss, params)
    m.release_step()
    torch.save({"layer": layer, "logits": logits.cpu(), "loss": loss.detach().cpu(),
                "grads": {n: g.cpu() for n, g in zip(names, grads)}}, path)
    torch.cuda.synchronize()
    return {"layer_weights_gb": layer_gb, "seconds": time.perf_counter() - t0}


def _local_ref(full, dt):
    """The slice of ``full`` that DTensor ``dt``'s rank holds."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(full.shape, dt.device_mesh,
                                                          dt.placements)
    return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def _errors(torch, pairs) -> dict:
    """(max abs error, within MOE_EP_TOL) over (DTensor, reference) pairs,
    each on this rank's shard (partial sums added up first)."""
    from torch.distributed.tensor import Replicate

    worst, within = 0.0, True
    for dt, full in pairs:
        dt = dt.redistribute(dt.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in dt.placements])
        got = dt.to_local().detach()
        want = _local_ref(full, dt).to(got.device)
        worst = max(worst, float((got - want).abs().max()))
        within &= bool(torch.allclose(got, want, rtol=MOE_EP_TOL[0], atol=MOE_EP_TOL[1]))
    return {"max_abs_err": worst, "within": within}


def moe_ep_rank(rank: int, port: int, ref_path: str, seed: int, cases, out_path: str):
    """One of the MOE_EP_RANKS ranks of phase moe_ep (a spawned process)."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.launch import shardings
    from repro_torch.launch.multihost import bootstrap
    from repro_torch.models import moe
    from repro_torch.models.model import init_params, train_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    # the ranks are one host's processes: the port's bootstrap forms their group
    bootstrap(coordinator=f"localhost:{port}", host_id=0, n_hosts=1, local_rank=rank,
              gpus_per_host=MOE_EP_RANKS, backend="gloo")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != MOE_EP_RANKS:
        raise AssertionError(f"bootstrap formed a world of {world}, not {MOE_EP_RANKS}")
    ref = torch.load(ref_path, mmap=True, map_location="cpu", weights_only=True)
    rows = []

    # mixtral_8x22b's MoE layer at (1, 4): each rank draws its own experts
    cfg = dataclasses.replace(configs.get_config(MOE_EP_LAYER_ARCH), compute_dtype="float32")
    mesh = init_device_mesh("cuda", (1, MOE_EP_RANKS), mesh_dim_names=("data", "model"))
    e_loc = cfg.n_experts // MOE_EP_RANKS
    first = mesh.get_local_rank("model") * e_loc
    w, x = moe_ep_layer(torch, cfg, range(first, first + e_loc), seed)
    rep, exp = [Replicate(), Replicate()], [Replicate(), Shard(0)]
    p = moe_module(cfg, {k: DTensor.from_local(v, mesh, rep if k == "router" else exp,
                                               run_check=False) for k, v in w.items()})
    xd = DTensor.from_local(x, mesh, rep, run_check=False).requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, aux = moe.moe_forward(cfg, p, xd, ep_rules(mesh, None))
    gx, gr = torch.autograd.grad(1e-3 * (out ** 2).sum() + aux, [xd, p.router])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    r = ref["layer"]
    rows.append({"check": "layer", "arch": cfg.name, "mesh": [1, MOE_EP_RANKS],
                 "bootstrap_world": world, "experts_a_rank": e_loc, "rank_weights_gb": sum(
                     t.nbytes for t in w.values()) / 1e9,
                 "seconds": seconds, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 **_errors(torch, [(out, r["out"]), (aux, r["aux"]), (gx, r["g_x"]),
                                   (gr, r["g_router"])])})
    del w, x, p, xd, out, gx, gr
    torch.cuda.empty_cache()

    # granite_moe_1b at full depth and width, every case
    cfg = dataclasses.replace(configs.get_config(MOE_ARCH), compute_dtype="float32")
    for data, model_axis, fsdp in cases:
        mesh = init_device_mesh("cuda", (data, model_axis), mesh_dim_names=("data", "model"))
        rules = ep_rules(mesh, fsdp)
        m = init_params(cfg, seed, device="cuda").requires_grad_(True)
        shardings.distribute(m, rules)
        batch = shardings.distribute_batch(moe_ep_batch(torch, cfg, seed), rules)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with implicit_replication():
            logits = m(batch["tokens"], rules=rules)
            loss = train_loss(m, batch, rules)
            names, params = zip(*m.named_parameters())
            grads = torch.autograd.grad(loss, params)
            m.release_step()
            # partial sums over the data axis, summed into the weights' layout
            grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, params)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        pairs = [(logits, ref["logits"]), (loss, ref["loss"])]
        pairs += [(g, ref["grads"][n]) for n, g in zip(names, grads)]
        rows.append({"check": "decoder", "arch": cfg.name, "mesh": [data, model_axis],
                     "fsdp": fsdp, "layers": cfg.n_layers, "experts": cfg.n_experts,
                     "experts_a_rank": cfg.n_experts // model_axis,
                     "rank_param_gb": sum(p.to_local().nbytes for p in params) / 1e9,
                     "seconds": seconds, **_errors(torch, pairs)})
        del m, batch, logits, loss, grads, params
        torch.cuda.empty_cache()

    # every rank's worst error and verdict, on rank 0
    worst = torch.tensor([[row["max_abs_err"], 0.0 if row["within"] else 1.0] for row in rows],
                         device="cuda")
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    if rank == 0:
        for row, (err, bad) in zip(rows, worst.tolist()):
            row.update(max_abs_err=err, within=not bad)
        with open(out_path, "w") as f:
            json.dump(rows, f)
    dist.destroy_process_group()


def gloo_gather_probe_child() -> int:
    """Two ranks on the one card all-gather a CUDA tensor over gloo with a
    functional collective (what DTensor's gathers, and so ZeRO-3 weights,
    use).  Exits 0 when the result is right."""
    import torch.multiprocessing as mp

    mp.spawn(_gloo_gather_rank, args=(_free_port(),), nprocs=2)
    return 0


def _gloo_gather_rank(rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    t = torch.full((4,), float(rank), device="cuda")
    out = funcol.wait_tensor(funcol.all_gather_tensor(t, 0, [0, 1]))
    if out.tolist() != [0.0] * 4 + [1.0] * 4:
        raise AssertionError(f"gathered {out.tolist()}")
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_gather_probe():
    """Start ``gloo_gather_probe_child`` (it spawns two ranks on the card)
    to run beside the card's phases."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-gather-probe"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_moe_ep(torch, seed: int, probe) -> None:
    """Expert parallelism on MOE_EP_RANKS gloo ranks of the one card (EP
    alone, ``ep_rules``), against single-process runs on the same card in
    fp32 (MOE_EP_TOL): mixtral_8x22b's MoE layer at its published widths
    (8 experts of d 6,144 x f 16,384, top-2; two experts a rank, each rank
    drawing only its own) on a (1, 4) mesh, its output, aux and the
    gradients of x and the router; granite_moe_1b at full depth and width
    (24 layers, 32 experts, 8 a rank) on (1, 4), then on (2, 2) (rows over
    data), then on (2, 2) with ``fsdp="data"``: the logits, train_loss and
    every gradient.  The fsdp case needs DTensor's all-gathers, which on
    gloo are functional collectives: ``probe`` (``start_gather_probe``,
    started before the training phases) runs one, and the case runs only
    where it returned right (it killed its process with SIGSEGV under torch
    2.11 on an H100)."""
    out_dir = os.path.join(ROOT, "build", "moe_ep")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t_phase = time.perf_counter()
    try:
        ref_path = os.path.join(out_dir, "reference.pt")
        reference = moe_ep_reference(torch, seed, ref_path)
        gc.collect()
        torch.cuda.empty_cache()
        _, probe_err = probe.communicate(timeout=300)
        cases = [c for c in MOE_EP_MESHES if probe.returncode == 0 or c[2] is None]
        import torch.multiprocessing as mp

        rows_path = os.path.join(out_dir, "rows.json")
        t0 = time.perf_counter()
        mp.spawn(moe_ep_rank, args=(_free_port(), ref_path, seed, cases, rows_path),
                 nprocs=MOE_EP_RANKS)
        ranks_s = time.perf_counter() - t0
        with open(rows_path) as f:
            rows = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    skipped = [list(c) for c in MOE_EP_MESHES if c not in cases]
    emit({"phase": "moe_ep", "ranks": MOE_EP_RANKS, "backend": "gloo", "device": "cuda",
          "rules": "expert parallelism alone (dense layers replicated)", "dtype": "float32",
          "rtol_atol": MOE_EP_TOL, "gloo_functional_all_gather": {
              "returncode": probe.returncode, "stderr_tail": probe_err[-300:]},
          "skipped_cases": skipped, "reference": reference, "checks": rows,
          "ranks_seconds": ranks_s, "seconds": time.perf_counter() - t_phase})
    bad = [r for r in rows if not r["within"]]
    if bad:
        raise AssertionError(f"moe_ep: beyond {MOE_EP_TOL}: {bad}")


def dryrun_child(out_path: str) -> int:
    """The dry run's side of phase dryrun_on_card, in its own process (it
    joins a fake process group): granite_moe_1b's published config, one
    train step of TRAIN_BATCH in TRAIN_MICRO microbatches on a (1, 1) fake
    mesh.  Writes the cell's record."""
    sys.path.insert(0, SRC)
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.optim import OptimizerConfig
    from repro_torch.sharding import make_rules
    from repro_torch.train import TrainConfig

    cfg = configs.get_config(MOE_ARCH)
    rules = make_rules(dryrun.fake_mesh((1, 1), ("data", "model")))
    tcfg = TrainConfig(n_microbatches=TRAIN_MICRO, optimizer=OptimizerConfig(lr=TRAIN_LR))
    t0 = time.perf_counter()
    rec = dryrun.cell_record(cfg, "train", TRAIN_BATCH[1], TRAIN_BATCH[0], rules, tcfg,
                             6.0 * cfg.active_param_count() * TRAIN_BATCH[0] * TRAIN_BATCH[1])
    rec["wall_s"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def start_dryrun_child():
    """Start ``dryrun_child`` (CPU work) to run beside the card's phases."""
    path = os.path.join(ROOT, "build", "smoke_dryrun.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dryrun-child", path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    return proc, path


def phase_dryrun_on_card(torch, seed: int, child) -> None:
    """The dry run's peak bytes a rank and FLOPs for granite_moe_1b's train
    step at the smoke's shape on a (1, 1) fake mesh (``dryrun_child``),
    against the same step on the card: ``torch.cuda.max_memory_allocated``
    of a step after a warm-up one (within DRYRUN_PEAK_TOL) and the step's
    FLOPs by ``FlopCounterMode`` (within DRYRUN_FLOPS_TOL).  The model
    FLOPs of ``train_full_width`` (6 N_active tokens plus causal attention)
    stand beside them."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    proc, path = child
    t_phase = time.perf_counter()
    cfg = configs.get_config(MOE_ARCH)
    tcfg = TrainConfig(n_microbatches=TRAIN_MICRO, optimizer=OptimizerConfig(lr=TRAIN_LR))
    state = init_train_state(cfg, tcfg, seed, device="cuda")
    step = make_train_step(cfg, tcfg)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, *TRAIN_BATCH, seed=seed))
    state, _ = step(state, pipe.torch_batch(0, "cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    with counter:
        state, _ = step(state, pipe.torch_batch(1, "cuda"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flops = counter.get_total_flops()
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"dryrun_on_card: the dry run exited {proc.returncode}: "
                             f"{err[-3000:]}")
    with open(path) as f:
        rec = json.load(f)
    os.remove(path)
    if rec["status"] != "ok":
        raise AssertionError(f"dryrun_on_card: the dry run's cell: {rec.get('reason')}")
    tokens = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    model = 6 * cfg.active_param_count() * tokens + 3 * TRAIN_BATCH[0] * attention_flops(
        cfg, TRAIN_BATCH[1])
    peak_ratio = rec["memory"]["peak_bytes"] / peak
    flops_ratio = rec["flops_per_device"] / flops
    emit({"phase": "dryrun_on_card", "arch": cfg.name, "mesh": rec["mesh_shape"],
          "batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO,
          "peak_bytes": {"dry_run": rec["memory"]["peak_bytes"], "card": peak,
                         "ratio": peak_ratio, "tol": DRYRUN_PEAK_TOL},
          "flops": {"dry_run": rec["flops_per_device"], "card": flops, "ratio": flops_ratio,
                    "tol": DRYRUN_FLOPS_TOL, "model_6n_plus_attention": model},
          "dry_run": {k: rec[k] for k in ("bytes_per_device", "collective_bytes_per_device",
                                          "compute_term_s", "memory_term_s",
                                          "collective_term_s", "dominant_term", "wall_s")},
          "seconds": time.perf_counter() - t_phase})
    if abs(peak_ratio - 1) > DRYRUN_PEAK_TOL or abs(flops_ratio - 1) > DRYRUN_FLOPS_TOL:
        raise AssertionError(f"dryrun_on_card: peak ratio {peak_ratio}, FLOPs ratio "
                             f"{flops_ratio} beyond {DRYRUN_PEAK_TOL} / {DRYRUN_FLOPS_TOL}")


def train_resume_child(ckpt_dir: str) -> int:
    """The body of phase train_resume, in its own process (cuBLAS reads
    CUBLAS_WORKSPACE_CONFIG when it initialises): gemma3_1b's widths cut to
    2 layers, bf16 moments, deterministic algorithms; run RESUME_STEPS steps
    saving the state after RESUME_AT with ``AsyncCheckpointer`` (the steps
    after it update the state in place while the file is written), restore
    it into a fresh state and run the steps after RESUME_AT again.  Prints
    one JSON line."""
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import AsyncCheckpointer, restore_tree
    from repro_torch.models.convert import train_state_from_jax, train_state_to_jax
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import TrainConfig

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(LM_ARCH), n_layers=RESUME_LAYERS)
    tcfg = TrainConfig(n_microbatches=TRAIN_MICRO, optimizer=OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=RESUME_STEPS, moment_dtype="bfloat16"))
    first = train_steps(torch, cfg, tcfg, 0, RESUME_AT)
    ckpt = AsyncCheckpointer(ckpt_dir)
    t0 = time.perf_counter()
    ckpt.save(RESUME_AT, train_state_to_jax(cfg, first["state"]))
    snapshot_s = time.perf_counter() - t0
    rest = train_steps(torch, cfg, tcfg, 0, RESUME_STEPS, state=first.pop("state"),
                       start=RESUME_AT)
    ckpt.wait()
    write_s = time.perf_counter() - t0
    del rest["state"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tree, manifest = restore_tree(ckpt_dir, RESUME_AT)
    state = train_state_from_jax(cfg, tcfg, tree, device="cuda")
    restore_s = time.perf_counter() - t0
    del tree
    again = train_steps(torch, cfg, tcfg, 0, RESUME_STEPS, state=state, start=RESUME_AT)
    file_bytes = os.path.getsize(os.path.join(ckpt.last_path, "host0.npz"))
    emit({"params": cfg.param_count(), "n_layers": cfg.n_layers,
          "step": int(again["state"]["step"]), "file_bytes": file_bytes,
          "leaves": len(manifest["leaves"]), "snapshot_s": snapshot_s,
          "write_s": write_s, "restore_s": restore_s,
          "losses": first["losses"] + rest["losses"],
          "resumed_losses": again["losses"], "ms_per_step": first["ms"] + rest["ms"]})
    return 0


def run_logged(cmd, env, timeout: float) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"{cmd} exited {out.returncode}: {out.stderr[-3000:]}")
    return out.stdout


def phase_train_resume(torch, in_process_phases) -> None:
    """``train_resume_child`` in a subprocess under
    CUBLAS_WORKSPACE_CONFIG=:4096:8: the resumed losses must be bit-equal
    to the uninterrupted run's.  Meanwhile (phase train_resume_cli) ``python
    -m repro_torch.launch.train --arch gemma3_1b --smoke --steps 6`` with
    checkpoints every 3 steps, its last step removed (a run stopped after
    step 3), and the same command again: it resumes from step 3 and reaches
    step 5's loss.  Both run beside ``in_process_phases()``: the child's
    work is mostly host I/O, and the card holds both processes' memory."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    path = os.path.join(ROOT, "build", "smoke_train_resume")
    cli_path = os.path.join(ROOT, "build", "smoke_train_cli")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
           "--smoke", "--steps", "6", "--ckpt-every", "3", "--ckpt", cli_path]

    def child():
        out = run_logged([sys.executable, os.path.abspath(__file__),
                          "--train-resume-child", path], env, 600)
        return out, time.perf_counter() - t0

    def cli_twice():
        first = run_logged(cmd, env, 300)
        shutil.rmtree(os.path.join(cli_path, "step_00000006"))
        return first, run_logged(cmd, env, 300), time.perf_counter() - t0

    for p in (path, cli_path):
        shutil.rmtree(p, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            resume, cli = pool.submit(child), pool.submit(cli_twice)
            in_process_phases()
            out, child_s = resume.result()
            first, second, cli_s = cli.result()
    finally:
        for p in (path, cli_path):
            shutil.rmtree(p, ignore_errors=True)
    res = json.loads(out.strip().splitlines()[-1])
    equal = res["losses"][RESUME_AT:] == res["resumed_losses"]
    emit({"phase": "train_resume", **res, "losses_bit_equal": equal, "seconds": child_s})
    if not equal:
        raise AssertionError(f"train_resume: {res['losses']} resumed as "
                             f"{res['resumed_losses']}")

    def last_loss(out):
        line = next(ln for ln in out.splitlines() if ln.startswith("step     5"))
        return float(line.split()[3])

    resumed = f"[resume] restored step 3 from {cli_path}" in second
    emit({"phase": "train_resume_cli", "first": first.strip().splitlines(),
          "second": second.strip().splitlines(), "resumed_from_3": resumed,
          "seconds": cli_s})
    if not resumed or abs(last_loss(first) - last_loss(second)) > 1e-3:
        raise AssertionError("train_resume_cli: the second run did not resume from "
                             "step 3 to step 5's loss")


def phase_train(torch, seed: int) -> None:
    """Phases train_device_parity, train_full_width and moe_full_width, with
    train_resume (+ train_resume_cli) in child processes beside them.  No
    kernel of the port is on the training path."""
    def in_process():
        for phase in (phase_train_device_parity, phase_train_full_width,
                      phase_moe_full_width):
            phase(torch, seed)
            gc.collect()
            torch.cuda.empty_cache()

    phase_train_resume(torch, in_process)


def phase_lm(torch, seed: int, kernels: list) -> dict:
    """Phases lm_device_parity, lm_full_width, knn_lm, knn_lm_sharded and
    scheduler; returns their launches by path."""
    phase_lm_device_parity(torch, seed)
    torch.cuda.empty_cache()
    phase_lm_full_width(torch, seed)
    torch.cuda.empty_cache()
    launches, ctx = phase_knn_lm(torch, seed)
    for row in kernels:
        if row["name"] in ("hamming_rows", "qdist_windows", "pack_bits"):
            row["knn_lm_route"] = ctx["route"]
    torch.cuda.empty_cache()
    launches.update(phase_knn_lm_sharded(torch, ctx))
    torch.cuda.empty_cache()
    launches.update(phase_scheduler(torch, ctx, seed))
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=3_000_000, help="corpus rows")
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recall-floor", type=float, default=RECALL_FLOOR,
                    help="recall@30 the full-width search must reach (the "
                         "default was set at --n 3000000 --seed 0)")
    ap.add_argument("--task2-orders", type=int, default=None,
                    help="Hilbert orders of the Task-2 graph (default: "
                         "gooaq.TABLE2[0], 80)")
    ap.add_argument("--task2-recall-floor", type=float, default=TASK2_RECALL_FLOOR,
                    help="recall@15 the full-width graph must reach (the "
                         "default was set at --n 3000000 --seed 0, 80 orders)")
    ap.add_argument("--train-resume-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-child", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--gloo-gather-probe", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch missing; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    if args.train_resume_child:
        return train_resume_child(args.train_resume_child)
    if args.dryrun_child:
        return dryrun_child(args.dryrun_child)
    if args.gloo_gather_probe:
        return gloo_gather_probe_child()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import gooaq
    from repro_torch.index import ForestConfig, IndexConfig, SearchParams
    from repro_torch.kernels import _build

    cfg = IndexConfig(
        forest=ForestConfig(n_trees=16, bits=4, key_bits=448, leaf_size=32),
        store_points=False,
    )
    lsm_cfg = dataclasses.replace(cfg, store_points=True, seal_pow2=True)
    params = SearchParams(k1=48, k2=384, h=2, k=30)
    graph_params = gooaq.TABLE2[0]
    if args.task2_orders is not None:
        graph_params = dataclasses.replace(graph_params, n_orders=args.task2_orders)

    phase_device()
    phase_build(_build)
    kernels, dense_errs = phase_kernel_parity(torch, KERNEL_REPS)
    launches, dense_rows = phase_kernel_bench(torch, dense_errs)
    kernels += dense_rows
    torch.cuda.empty_cache()
    phase_device_parity(torch, cfg, lsm_cfg, PARITY_ROWS, args.seed)
    points, queries = phase_data(torch, args.n, args.queries, args.seed)
    steps = {}

    def after_build(index):
        steps["stage1_step"] = phase_stage1_step(torch, index, queries, KERNEL_REPS)
        steps["stage2_step"] = phase_stage2_step(torch, index, queries, KERNEL_REPS)

    main_launches, truth, recall = phase_main_path(
        torch, cfg, params, points, queries, args.recall_floor, after_build=after_build)
    # Beside each row's pre-gathered time, the fused launch the paths make,
    # at the search's shape (the first step of each phase).
    for name, step in (("hamming_rows", "stage1_step"), ("qdist_windows", "stage2_step")):
        row = next(r for r in kernels if r["name"] == name)
        first = next(iter(steps[step].values()))
        row.update({step: steps[step], "fused_ms": first["fused_ms"],
                    "fused_bound_ms": first["fused_bound_ms"],
                    "fused_bound_by": first["fused_bound_by"]})
    launches.update(main_launches)
    torch.cuda.empty_cache()
    launches.update(phase_table1(torch, points, queries))
    torch.cuda.empty_cache()
    launches.update(phase_sharded(torch, cfg, params, points, queries, truth, recall,
                                  args.recall_floor))
    del truth
    torch.cuda.empty_cache()
    launches.update(phase_lsm(torch, lsm_cfg, params, points, queries, args.seed,
                              args.recall_floor))
    torch.cuda.empty_cache()
    launches.update(phase_engine_memory(torch, lambda: phase_engine(
        torch, lsm_cfg, params, points, queries, args.seed)))
    torch.cuda.empty_cache()
    held = []  # phase sharded_lsm's index, which phase sharded_engine serves
    launches.update(phase_sharded_lsm(torch, lsm_cfg, params, points, queries, args.seed,
                                      args.recall_floor, held))
    torch.cuda.empty_cache()
    phase_sharded_lsm_bundles(torch, lsm_cfg, params, points, queries, args.seed)
    launches.update(phase_engine_memory(torch, lambda: phase_sharded_engine(
        torch, params, points, queries, held), name="sharded_engine_memory"))
    del queries
    torch.cuda.empty_cache()
    task2_launches, task2_recall = phase_task2(torch, points, graph_params, args.seed,
                                               args.task2_recall_floor)
    launches.update(task2_launches)
    torch.cuda.empty_cache()
    sharded_task2_launches, halo = phase_sharded_task2(torch, points, graph_params,
                                                       *task2_recall)
    launches.update(sharded_task2_launches)
    del points
    torch.cuda.empty_cache()
    launches.update(phase_lm(torch, args.seed, kernels))
    torch.cuda.empty_cache()
    dry, probe = start_dryrun_child(), start_gather_probe()
    try:
        phase_train(torch, args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        launches.update(phase_zoo(torch, args.seed))
        phase_moe_ep(torch, args.seed, probe)
        gc.collect()
        torch.cuda.empty_cache()
        phase_dryrun_on_card(torch, args.seed, dry)
    finally:
        dry[0].kill()
        probe.kill()
    next(r for r in kernels if r["name"] == "hamming_rows")["sharded_halo"] = {
        k: halo[k] for k in ("rows_a_shard", "k1", "distances_compared", "max_abs_err")}
    for row in kernels:
        by_path = {path: counts[row["name"]] for path, counts in launches.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
