#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero and prints no result line:

1. Card check: require CUDA, print the card's name and power limit
   (``nvidia-smi``), build and load the kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all started
   together) and print the build seconds.
2. Each walk kernel against its plain PyTorch version, on the card, in set
   mode (int32) and map mode (int64, ``payload_bits=12``), over a tree of
   the Fig. 12 size after a few update batches and 2**16 queries (present
   and absent keys, walk sentinels, keys above every live key): integer
   outputs must be equal exactly; the same on small churned trees of
   heights 3, 4, 5, 8 and 12 (1, 2 and 4 vEB pieces a path), with per-lane
   roots and batches that leave a block part-full.  ``veb_walk_rows`` is
   checked in every round of the per-round walk, on the rows that walk
   gathers (each lane's current ΔNode, internal ones included).  nvcc's
   register, shared-memory and spill report of the walk instantiations.
   Times (CUDA events) of the kernel beside the design it replaced
   (``SIMPLE_WALK_MS``), the plain version and ``torch.searchsorted`` (a
   yardstick only: it answers membership over the sorted live keys, not
   the walk's outputs, and the port never calls it), the kernel's bound:
   the bytes the walk needs (every distinct router slot and child id it
   reads, queries, roots, outputs) over the card's 3.35 TB/s, and the
   dependent loads from device memory a lane makes, router by router as
   before and piece by piece now.  The walks do a few integer compares
   per loaded router, so bytes bound them.
   ``veb_scan_fused`` against its plain version on the same trees, over
   2**12 lanes that mix sparse, dense, empty (hi <= start) and
   past-the-last-key bands, bands that start just below tombstoned keys,
   sentinel lanes and per-lane roots at non-root ΔNodes, at ``max_out`` 16
   and 128 and with two round caps of both parities that truncate lanes
   (inside VERIFY and inside FIND passes): all four outputs must be equal
   exactly; the same on a height-3 tree whose paths run deeper than the
   kernel's 32-entry path stack (``tests/_torch_parity.deep_tree``'s
   tree).  nvcc's register, shared-memory and spill report of both scan
   instantiations.  Then timed at K = 512 (``benchmarks/scan_sweep.py
   --full``'s batch) for sparse / dense bands x ``max_out`` 16 / 128,
   beside the design it replaced (``SIMPLE_SCAN_MS``), the plain version,
   the bytes bound (distinct router, child-id and mark bytes the scan
   reads, inputs and outputs, over 3.35 TB/s) and a yardstick
   (``torch.searchsorted`` over the sorted live keys plus a
   ``max_out``-wide gather: the same rows on a tree without tombstones;
   the port never calls it).
   Block sizes: on both Fig. 12 trees, kernels 1 and 2 at every size they
   are built for (32, 64, 128, 256 threads a block, their ``q_tile``)
   equal to the plain versions over 2**16 queries with 1 lane in 5
   rooted at a non-root ΔNode, an unbuilt size refused by the wrapper and
   the library, then each size timed at K = 1024 and 2**20 in turns.
   The tall path (ΔNodes above 12 levels: the position table in global
   memory, no root staged): kernels 1-3 on churned trees of heights 14
   and 16 (20,000 draws) and 22 (1,500,000 draws, Table 1's UB=N
   height; each tree splits into several ΔNodes), set and map mode,
   against their plain
   versions (the walk at K = 1, 33, 4096 with per-lane roots, the rows
   walk in every round over 64 lanes, the scan over the comparison's
   bands at ``max_out`` 16 and 128 and a cap that cuts lanes); at height
   22 in set mode each timed beside its plain version and bytes bound.
   Then ``kernels.autotune.sweep_height`` at heights 5, 7 and 9 in both
   bit modes into ``build/chip_autotune.json``, read back through
   ``ops.default_q_tile``; each size's time printed.  The seconds of each
   of these legs are printed.
3. The main path at the size of the paper's Fig. 12 big tree
   (``benchmarks/fig12_big_tree.py`` with ``benchmarks/common.py``
   ``backend_kwargs``): ``make_index("deltatree", engine="lockstep")`` over
   ~1.97 M keys (height 7, buf_cap 32, ~186 k ΔNodes, ~190 MB of arena),
   then 20 steps of 1024 ops at 10 % updates — ``ix.search`` on the batch, then
   ``ix.insert_delete`` on the whole batch — each checked against the set
   oracle, one 1024-key ``ix.successor`` batch, and the final live set and
   ``alloc_fail``.  Then 3 steps with ``walk_fused=False``, so the
   per-round walk runs ``veb_walk_rows``.  Range scans on the eager fused
   index after its steps: one K = 512 ``scan`` batch per (density,
   ``max_out``) cell above, one 1024-key ``ix.successor_k(keys, 16)`` batch
   and three ``ix.range_scan`` paginations followed by cursor to the end,
   each checked against the sorted oracle keys.
4. Deferred maintenance at the same size: ``make_index(...,
   maintenance="deferred")`` on the same keys, one batch of 1024 inserts in
   runs of consecutive keys (which fills overflow buffers; the uniform
   Fig. 12 mix alone almost never does), then 10 steps of 1024 ops at 10 %
   updates, each step's search, update results, one K = 512 scan batch and
   one successor batch checked against the oracle; every step must carry
   buffered items (``stats.pending > 0``), so the scans merged them.  Then
   ``flush()`` and the live set.  The same for 3 steps under
   ``budgeted:8``.  4.3, the card replay: the committed traces in which
   an Expand keeps an item (``eager`` and ``budgeted:2``) and the seeded
   op sequences of each policy's lockstep configuration
   (``tests/_torch_traces.py``, which ``tests/test_torch_property.py``
   holds to the JAX package) run on the CPU port (the plain versions),
   then on the card (kernels 2 and 3): after every step the results,
   stats and whole arena, and before every update the batch's search,
   successor and a scan, must be equal; its seconds are printed.
5. The serve path at Granite-8B width (``repro_torch.configs.granite_8b``):
   ``paged_decode_attention`` (a split-K kernel over chunks of pages, then
   a merge) against its plain version in float32 and bf16 at Granite
   shapes, with lengths on the split plan's chunk boundaries (0, 1, one
   page, one chunk, one chunk + 1 token, a partial last page in the last
   chunk, the full MAXP), on a batch the plan does not split, and at the
   smoke config's narrow heads (-1 tails, scrambled unreferenced pages;
   within 2e-5, plus one bf16 rounding step in bf16); nvcc's register,
   shared-memory and spill report of its kernels; timed in bf16 at the
   served batch (B = 8, ~1 k tokens), at decode_32k's batch at 4096
   tokens and at one 32 k context beside its plain version, SDPA with
   the gather of each sequence's pages (a yardstick the port never
   calls) and the bytes bound; then a float32 Granite cut to 4
   layers whose ``ServeEngine`` tokens must equal the dense decode's; the
   36-layer bf16 model (weights drawn on the card from the seed) serving
   16 requests with 8 live lanes, the index held to the pager's mapping
   after every applied batch and every request's logits to the
   teacher-forced dense decode within 5 % of the largest |logit|, with
   at least 90 % of the argmaxes equal; three more steps timed, then
   three traced with ``torch.profiler`` (device time by kind and the idle
   share of those steps' wall time); and the churn trace under deferred maintenance with a
   mid-trace ``scan`` checked against the block tables.
6. The DeltaForest at ``benchmarks/forest_scale.py --full`` size
   (``backend_kwargs("forest", ...)``): 500,000 draws in [1, 2,000,000)
   (~442 k keys), height 7, buf_cap 32, per-shard ``max_dnodes``
   8 (n + 50,000) / S / 64.  6.1: for S = 1, 4, 8 (set mode) and S = 4
   (map mode, ``payload_bits=12``) the same read batches (1021 keys:
   shard boundaries, keys above the last live key, below the domain;
   scans of 509 sparse and dense bands at ``max_out`` 128;
   ``successor_k(16)``) through ``make_index("forest",
   engine="lockstep")`` (the fused frontier), the same with
   ``fused=False`` (the dense per-shard dispatch) and the oracle, equal
   bit for bit; after each of 3 update batches (both dispatches' arenas
   equal); under ``deferred`` after clustered inserts that leave items
   buffered in several shards; then ``flush``, every shard's
   ``alloc_fail`` and the live set.  6.2: forest_scale's grid, S in 1, 2,
   4, 8 x batch 256, 1024, 4096, 100,000 ops at 5 % updates (two warm-up
   steps off the clock), under both dispatches beside the ``deltatree``
   baseline (lockstep engine), every step checked against the oracle;
   ops/s, ``speedup``, ``speedup_vs_vmap``, search / update medians, walk
   launches a search batch (1 fused, S dense), view-cache builds / hits.
   6.3: kernels 2 and 3 on the fused views of S = 1 and 8 (K = 1024 keys
   in batch order; 512 dense bands tiled over the shards), exact against
   the plain versions, timed beside the byte bound and the share of lanes
   whose root is the one their block staged.  6.4: phase 5.2's float32
   leg over ``ShardedPagerConfig(num_shards=4)``: tokens equal the dense
   decode's, block tables the single-tree pager's at every step, and the
   fused view reused (``view_hits`` > 0).
7. The paper's comparison structures and the read-path accounting.
   7.1: ``benchmarks/table1_transfers.py --full`` (1,048,576 draws in
   [1, 5,000,000), 500 queries): ``deltatree`` (height 7, ``max_dnodes``
   1 << 17, buf_cap 16), ``static_veb``, ``pointer_bst``,
   ``sorted_array`` and the ΔTree UB=N (height ceil(log2 n) + 2, 4
   ΔNodes), whose lockstep ``search`` of the 500 queries (kernel 2's tall
   path) must equal the oracle, its hops the plain walk's and, on the
   first 32, the scalar engine's: mean elements touched and distinct
   16- / 128-element
   blocks a search (the host touch model), the ordering static_veb <
   sorted_array < pointer_bst at both; on the deltatree row
   ``obs.transfers.compare_model`` replays on the card (ratio 1.0 exactly
   at B = 8, 16, 32, 64), and a ``collect_stats`` + ``collect_transfers``
   search through kernel 2 must equal a plain read and ``measure``;
   ``fit_log_b`` on the card, r2 >= 0.98.  7.2: ``fig12_big_tree.py``'s
   backends on the phase-3 keys at batch 1024, 0 % and 10 % updates,
   30,000 ops (run_index's stream: two warm-up steps, the baselines' 64
   update rows a step), static_veb at 0 % only, every step against the
   oracle: ops/s, search and update medians beside ``deltatree``
   (lockstep), which runs with ``collect_stats`` as run_index turns it on
   and without, as phase 3 runs it.  Cut: rates 1 / 20 / 100 and batch 256 are not run.  7.3:
   three Fig. 12 steps of the ΔTree (search, eager update) traced with
   ``repro_torch.obs.trace.capture``: device busy and wall time a step and
   the idle share.  7.4: an S = 4 forest at phase 6's size collecting
   stats, fused and dense ``ReadStats`` equal, router lanes summing to the
   batch; phase 5.2's float32 leg over ``ShardedPagerConfig(num_shards=4)``
   whose index collects stats (tokens equal to a stats-free run),
   ``ServeScheduler.metrics()`` in dict, Prometheus and JSON form with the
   search, router and transfers groups.
8. The zoo's other families the serve path admits (``repro_torch.configs``).
   8.1: ``paged_decode_attention`` at every group size the served configs
   have (Granite / Phi / Nemo 32 / 8, StarCoder2 48 / 4 = 12 heads a KV
   head, in two sub-groups of 6, Qwen 64 / 8, InternVL2 16 / 8) and
   synthetic G = 1 and 16, D = 128, float32 and bf16, at the served batch
   and at B = 64 x 4096: against its plain version, then timed beside the
   bytes bound.  8.2: Phi-3.5-MoE at full width (16 experts top-2 of
   width 6400): a float32 leg cut to 2 layers whose served tokens must
   equal the dense decode's, then the bf16 model cut from 32 to 24 layers
   (``PHI_LAYERS``; weights drawn on the card from the seed) as phase 5.3
   (16 requests, 8 live lanes, logits held to the dense decode, three
   steps traced), then phase 5.4's churn trace under deferred; the
   parameter count, the weights a decode step reads over 3.35 TB/s and the
   peak memory allocated.  8.3: StarCoder2-15B at full width and depth (G
   = 12), its float32 2-layer exact-token leg, then 8 requests of 16 new
   tokens.  8.4: InternVL2-2B at full width and depth: a prefill of 256
   vision embeddings + 512 tokens for 4 sequences, 8 decode steps held to
   prefills of the longer prefix (the bf16 rule), and a VLM admission
   into ``ServeScheduler`` that must raise as the JAX one does.
9. The model-only families (``repro_torch.models.registry``: DeepSeek-V2's
   MLA, Mamba2's SSD, Jamba's hybrid, Whisper's encoder-decoder; the
   serve path refuses them, as JAX's does).  9.1: each at its smoke size
   in float32, drawn on the CPU and copied to the card: ``forward_train``,
   a prefill and 8 decode steps on both, logits and every cache within
   1e-5 (the SSD families 1e-4).  9.2-9.5 in bf16 at full width, weights
   drawn on the card from the seed, each prefill timed after an untimed
   one: DeepSeek-V2 cut to its dense prologue + 4 MoE layers (prefills of
   4 x 1024 and 1 x 4096, 32 absorbed decode steps), Jamba-1.5-Large one
   period of 8 layers holding 8 of its 16 experts (2 x 4096, 32 steps),
   Mamba2-370m whole (4 x 8192, 64 steps; layer 0's ``ssd_chunked``
   against ``ssd_ref`` over 1024 tokens), Whisper-base whole (8 lanes,
   1500 frames, a 64-token prompt, 64 steps).  Each leg holds a prefill
   and its decode steps to ``forward_train`` over the same tokens by the
   bf16 rule (DeepSeek-V2 on 1 x 3040 and 4 x 512 prompts, Jamba on 2 x
   500, each with 32 steps, at capacity factor E / K, no token dropped,
   the routing forced to forward_train's); Mamba2's bf16 decode drifts
   from it through 48 layers and the state, so its bf16 prefill is held
   by that rule and its decode, on the same weights and tokens, in
   float32 within 1e-3 of the largest |logit|.  Printed: prefill and
   decode-step times, tokens/s, the peak memory allocated and the
   weight-read bound of a decode step.  No kernel runs in phase 9: its
   launch counters stay 0.
10. The trainer (``repro_torch.train`` / ``optim`` / ``data`` /
   ``checkpoint`` / ``launch.train``).  10.1: every smoke config in
   float32 (TF32 off), drawn on the CPU: 3 steps of ``make_train_step``
   at accum_steps 1 and 2 on ``batch_at_step`` batches of 4 x 32, each
   taken on the card from a copy of the CPU's model and optimizer state
   before it; the first step's gradients per leaf within 1e-4 of the
   leaf's largest |g| (the SSD families 1e-3), each step's loss within
   1e-5 and its grad norm within the gradients' tolerance, relative.
   10.2: Granite-8B whole at full width (36 layers, bf16 parameters,
   ``remat`` on, ``AdamWConfig(state_dtype="bfloat16")``), one
   ``batch_at_step`` row of train_4k's 4096 tokens a step, 6 steps, the
   first untimed: the median step time, tokens/s, the peak memory
   allocated, the step's bound (6 N T plus causal attention over 989
   TFLOP/s against the update's 14 bytes a parameter over 3.35 TB/s) and
   its share; checked: every loss and grad norm finite, step
   1's loss equal to ``loss_fn`` under no_grad within 1e-6 relative, no
   element moved by more than lr_1 (1 + wd |p|) plus one bf16 step at
   step 1, the step counter 1.  10.3: ``python -m
   repro_torch.launch.train`` on Mamba2-370m whole in processes of their
   own: 8 steps run through against 4 steps with a checkpoint (bf16
   ``<V2`` leaves, float32 moments) and ``--resume`` to 8, every final
   parameter equal bit for bit.  No kernel runs in phase 10: its launch
   counters stay 0.  Every number printed goes with the card's name and
   power limit.
11. The dry-run (``repro_torch.launch.dryrun``: the port's step counted on
   the meta device, ``analysis.count``).  11.1: ``run_cell`` over
   ``DRYRUN_CELLS`` on the host (every decode_32k cell, both long_500k
   cells, Whisper-base's train_4k and prefill_32k: every family and step
   kind), each record's
   peak, FLOPs, bytes and bottleneck printed; then at every smoke config
   (``remat`` on, train at accum_steps 2) and step kind, the card's count
   of the step equals the meta device's (FLOPs, bytes, ops).  11.2 runs
   inside phase 10: the dry-run's count of 10.2's train step (train_4k
   at one row, accum_steps 1), printed before 10.2's model is built;
   after 10.2's timed steps one more step of its model under the same
   counters, the peak statistics reset just before it: the card's FLOPs
   and bytes equal the count's, ``max_memory_allocated`` within 5 % of
   its peak; the roofline's compute and memory terms beside 10.2's
   median step.  11.3: the same for one dense decode_32k step of that
   model at 8 rows (zero caches, 38.7 GB in bf16, every row at the last
   position; its logits finite), after 10.2's optimizer state is freed.
   11.4: a search batch of 1024 keys on phase 3's tree under the
   ``lockstep`` and ``scalar`` engines, and on a forest of 8 shards of
   the same keys (the median of 3 after an untimed one, the engines'
   results equal): the faster must be ``core.engine.AUTO_TABLE``'s
   ``cuda`` row, and ``make_index(..., engine="auto")`` on the card must
   resolve to it.  No kernel runs in 11.1-11.3 (their counters stay 0).
12. The DeltaForest over ``torch.distributed`` ranks sharing the card:
   phase 6's S = 8 forest spread over R = 2, then R = 4 processes
   (``torch.multiprocessing`` spawn, each told ``backend="gloo"``; gloo
   moves CUDA tensors through the host), each building only its S / R
   shards and launching kernels 2 and 3 on them.  Every process, and
   this one alone first as the reference, runs 6.1's read batch (1021
   keys, 509 sparse and dense scan bands at ``max_out`` 128,
   ``successor_k(16)``), 3 update batches, ``deferred`` then ``flush``,
   in set mode and map mode (``payload_bits=12``), each result against
   the oracle; at R = 4 also a ``ShardedPagerConfig(num_shards=4)``
   script whose block tables must list the pages ``allocate`` returned.
   Every rank's results equal this process's bit for bit.  Each rank
   then times 6.2's batch-1024 stream at 5 % updates (25,000 ops, every
   step against the oracle).  Every rank launched kernels 2 and 3 and no
   plain version.  Printed: each rank's search / update medians beside
   phase 6.2's at S = 8 (labelled one card shared by R processes: not a
   multi-card number), launches and seconds.
13. The sharded trainer (``repro_torch.parallel``) over R = 4 gloo
   processes sharing the card (``tp_phase``).  This process first runs
   the oracle: Granite-8B at full width cut to 2 of 36 layers, float32
   parameters, moments and activations (``remat`` on), 3 steps of
   ``AdamWConfig(lr=1e-3, state_dtype="float32")`` on 2 x 4096 tokens
   of ``batch_at_step``; its parameters and first moments after step 1
   go to ``build/chip_tp``.  13.1: the ranks draw the same weights, keep the
   blocks ``param_specs`` gives on a (data, model) = (2, 2) mesh and take
   the same 3 steps (one row a data rank, under ``logical_rules``):
   every loss within 1e-4 of the oracle's, every leaf after step 1
   within 5e-3 of its block of the oracle's (tests/test_parallel.py's
   bounds), every gradient norm within 1e-4 of the oracle's relative to
   it, each rank's block of every first moment after step 1 (the
   clipped gradient times 1 - b1) within 1e-3 of that leaf's largest
   in the oracle (step 1's update is lr / 100 a parameter, too small
   for the leaf bound to tell a wrong gradient), each rank's parameter
   and moment bytes under 0.3 of the oracle's, no collective of
   DTensor's own (only ``parallel.comm``'s, counted by kind a step).  13.2: ``split_k_decode_attention`` over
   "model" on a 1 x 4 mesh at decode_32k's heads (B 8, H 32, KVH 8, D
   128, S 32,768, float32, random lengths) within 1e-5 of
   ``decode_attention`` here.  13.3: ``compressed_pmean`` over the 4
   ranks of each rank's block of the step-1 gradient of
   ``layers.0.mixer.wq`` (its first moment over 1 - b1): bit for bit
   the per-rank quantize-then-mean computed here, within the int8
   grid's bound of the exact mean.  13.4: the state after 13.1 saved
   on (2, 2) (rank 0 writes), restored onto (2, 1) by ranks 0-1 and
   whole here: every block of every parameter and moment on both
   meshes bit for bit (position-weighted digests of the bits).  Printed
   beside the card: losses, grad norms, step medians (host clock,
   synchronized) of the oracle and each rank, bytes, collectives,
   split-K and save / restore seconds.  13.1 also counts each rank's
   third step (`analysis.count` on the card; left out of the step
   times): its FLOPs, bytes and collectives (kind, bytes, group size, in
   order) must equal the dry-run's count of the same step on a fake
   (2, 2) group over the meta device, run here first
   (`launch.dryrun.mesh_count`).  13.5: 13.1's model prefills 2 × 512
   tokens into caches of 1,024 placed by ``cache_specs`` (their length
   on "model": 512 positions a rank) and takes 8 decode steps: each
   rank's block of every logits within 1e-4 of the largest |logit| of
   this process's same run, and of every cache leaf within 1e-4 of the
   leaf's largest; prefill and decode times beside one process's.
   13.6: the train step of DeepSeek-V2 (full width, cut to its dense
   first layer: MLA + dense FFN), Mamba2-370m (full width, 4 of 48
   layers) and Whisper-base (whole), float32, one step on (2, 2), held as
   13.1 is (losses 1e-4, grad norms 1e-4 relative, first moments 1e-3
   of each leaf's largest); each config's cut printed first.  Every
   sharded step runs under `parallel.comm.no_functional_collectives`.
   No kernel runs (every process's counters stay 0).
Each run of a path (fused steps, per-round steps, scans, deferred,
budgeted, each serve run, each forest run, 6.1's fused reads and dense
reads apart, each phase 7 run, each phase 12 leg in each rank) sets the
launch counters to 0 just before
it and reads them just after: its kernels must have launched (the paged
kernel once per layer per decode step), and no plain version may have
run.

The second-to-last line is ``{"kernels": [...]}`` (rows 2-4 also carry
``forest_launches``: kernel 2's in phase 6.2's fused runs, kernel 3's in
6.1's fused reads, kernel 4's in 6.4's sharded serve run; rows 2 and 4
``phase7_launches``; row 4 ``phase8_launches``, its launches in 8.2's and
8.3's serve runs; rows 2 and 3 ``ranks_launches``, each rank's launches
in phase 12 by R); the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KEY_MAX = 5_000_000        # benchmarks/fig12_big_tree.py
INITIAL = 2_500_000
TOTAL_OPS = 30_000         # fig12 run() default; sizes the arena
BATCH = 1024               # Fig. 12 concurrency
CHECK_K = 2 ** 16          # queries for the kernel-vs-plain comparison
TIMED_K = (BATCH, 2 ** 20)  # batches the kernels are timed at
UPDATE_PCT = 10
STEPS = 20                 # fused main-path steps
PER_ROUND_STEPS = 3        # main-path steps with walk_fused=False
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SCAN_K = 512               # benchmarks/scan_sweep.py --full batch
SCAN_CHECK_K = 2 ** 12     # lanes for the scan kernel-vs-plain comparison
SCAN_MAX_OUT = (16, 128)   # scan_sweep.py --full k_list
DENSITY_FILL = {"sparse": 0.25, "dense": 4.0}   # scan_sweep.py
TRUNCATING_ROUNDS = 300    # scan round caps below a dense lane's need: this
                           # and TRUNCATING_ROUNDS + 1, so cuts land in both
                           # pass kinds
DEEP_KEYS = 600            # ascending inserts of the deep-path scan check
# timed runs of the plain version in phase 2's scan cells and tall tables
# (after the untimed one): a dense scan cell's takes up to 3.6 s, so one
# run keeps the script inside its time limit
PLAIN_TIMED_REPS = 1
# The scan kernel's times in the timed cells before its redesign (one
# thread a lane, every pass walked from the root; NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside each cell's time now
SIMPLE_SCAN_MS = {
    ("set int32", "sparse", 16): 0.1322, ("set int32", "sparse", 128): 0.6650,
    ("set int32", "dense", 16): 0.3028, ("set int32", "dense", 128): 2.1023,
    ("map int64", "sparse", 16): 0.1604, ("map int64", "sparse", 128): 0.8184,
    ("map int64", "dense", 16): 0.3461, ("map int64", "dense", 128): 2.6014,
}
# The walk kernels' times before their redesign (one thread a query reading
# router by router, 256 threads a block; set mode, NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside each timed cell now
SIMPLE_WALK_MS = {
    ("fused", "set int32", BATCH): 0.021296,
    ("rows", "set int32", BATCH): 0.009696,
    ("fused", "set int32", 2 ** 20): 0.1136,
}
WALK_CHECK_HEIGHTS = (3, 4, 5, 8, 12)   # besides Fig. 12's 7
WALK_CHECK_K = (1, 31, 33, 1000, 4096)  # part-full blocks at every block size
# the tall path (ΔNodes above 12 levels): (keys drawn in [1, KEY_MAX),
# max_dnodes) a height; past half a ΔNode's leaves the bulk build splits,
# so both trees hold child ΔNodes (22: Table 1's UB=N height)
TALL_TREES = {14: (20_000, 64), 16: (20_000, 64), 22: (1_500_000, 8)}
TALL_CHECK_K = (1, 33, 4096)
TALL_ROWS_K = 64          # gathered rows of 2**22 slots each: 64 a round
AUTOTUNE_HEIGHTS = (5, 7, 9)   # kernels/autotune.py's sweep, both bit modes
AUTOTUNE_SWEEPS = 3           # sweeps a key: each size's repeated reads
UBN_SCALAR_Q = 32         # 7.1: UB=N queries also read by the scalar engine
DEFERRED_STEPS = 10
BUDGETED_STEPS = 3
CSRC = "src/repro_torch/kernels/csrc"
SOURCE = f"{CSRC}/veb_walk.cu"
SCAN_SOURCE = f"{CSRC}/veb_scan.cu"
PA_SOURCE = f"{CSRC}/paged_attention.cu"
# phase 5: the serve path at Granite-8B width (src/repro/configs/granite_8b.py)
PA_TOL = 2e-5    # kernel vs plain in float32, max abs (`paged_err`)
PA_CHECK_B, PA_CHECK_MAX = 8, 2048   # check batch, lengths drawn in 1..2048
PA_SERVED = (8, 1024)                # timed: the served batch, ~1 k tokens
PA_LONG = (64, 4096)                 # timed: decode_32k's batch, shorter
PA_ONE_LONG = (1, 32768)             # timed: one 32 k context
PA_NARROW = (4, 2, 16, 4)            # (QH, KVH, D, PS) of the smoke config
EXACT_LAYERS = 4                     # the float32 exact-token leg's depth
EXACT_REQUESTS, EXACT_PROMPT, EXACT_NEW = 4, (16, 256), 8
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_LIVE = 16, (128, 1024), 32, 8
TRACED_STEPS = 3     # full-width scheduler steps traced with torch.profiler
CHURN_STEPS, CHURN_SPLIT, CHURN_HIGH_WATER = 24, 12, 16
# bf16 logits of the paged path vs the dense decode at the same weights,
# as a share of the request's largest |logit|: activations round to 8 bits
# after every product, and the two attention paths round their outputs at
# different points, so 36 residual layers drift (read on the H100: at most
# 0.111 against 6.06 in the served run, 0.102 in the churn run)
LOGIT_REL_TOL_BF16 = 0.05
# share of teacher-forced decode steps whose argmax equals the dense
# decode's (read on the H100: 0.974 served, 0.957 churn)
TOKEN_MATCH_MIN_BF16 = 0.9


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def mixed_kinds(rng, k: int, update_pct: float):
    """benchmarks/common.py::mixed_kinds: half inserts, half deletes."""
    import numpy as np

    u = rng.random(k) < (update_pct / 100.0)
    ins = rng.random(k) < 0.5
    return np.where(u, np.where(ins, 1, 2), 0).astype(np.int32)


def fig12_config(n_keys: int, total_ops: int = TOTAL_OPS) -> dict:
    """benchmarks/common.py::backend_kwargs("deltatree", ...)."""
    n_eff = n_keys + total_ops // 2
    height = 7
    return dict(height=height, buf_cap=32, max_rounds=256,
                max_dnodes=max(256, int(6 * n_eff / 2 ** (height - 1))))


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events).  A
    sleep kernel ahead of the start event keeps the host's launch work out
    of the window; ``flush`` (a large tensor) is overwritten before each run
    so the walk finds the 50 MB L2 cold, as the main path does."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def piece_count(height: int) -> int:
    """The vEB pieces a path crosses in a height-``height`` ΔNode
    (``veb::piece_plan``): 1 for H <= 4, 2 for 5..8, 3 for 9, 4 for
    10..16, up to 8 above."""
    if height <= 4:
        return 1
    return piece_count(height // 2) + piece_count(height - height // 2)


def pos_bytes(height: int, nodes) -> int:
    """Position-table bytes a kernel reads: up to ``SMEM_HEIGHT`` the
    whole table (staged a block), above it the entries of the distinct
    BFS nodes ``nodes`` (a list of index tensors) the lanes visit."""
    import torch

    from repro_torch.kernels.veb_search import SMEM_HEIGHT

    if height <= SMEM_HEIGHT:
        return 4 * 2 ** height
    return 4 * torch.unique(torch.cat(nodes)).numel() if nodes else 0


def fused_needs(t, height: int, q, roots, max_rounds: int, block=None):
    """Bytes the fused walk needs on these inputs: every
    distinct (ΔNode, slot) router and child id its lanes read, each once,
    plus queries, roots, outputs and the position table (`pos_bytes`).  A
    replay of the blind descent that records addresses.  Also counts the
    dependent loads from device memory each lane's rounds make: the
    earlier design read router by router (H a round, one more for the
    child id); this one reads a piece at a time (`piece_count` a round,
    the child ids with the last piece) and nothing from the root its
    block of ``block`` lanes (the default block size) staged; on the tall
    path one more a piece (its root's position first), and no root is
    staged.
    Returns (bytes, {"old": per-lane loads, "new": per-lane loads})."""
    import torch

    from repro_torch.kernels.ref import pos_table, walk_big
    from repro_torch.kernels.veb_search import DEFAULT_BLOCK, SMEM_HEIGHT

    pos = pos_table(height, q.device).long()
    m, ub = t.value.shape
    lc = t.child.shape[1]
    bottom0 = 2 ** (height - 1)
    vflat = t.value.reshape(-1)
    act = q != walk_big(t.value.dtype)
    dn = roots.long().clone()
    k = q.numel()
    block = block or DEFAULT_BLOCK
    tall = height > SMEM_HEIGHT
    staged = roots.long()[torch.arange(k, device=q.device) // block * block]
    staged = torch.full_like(staged, -1) if tall else staged.clamp(0, m - 1)
    old = torch.zeros(k, dtype=torch.long, device=q.device)
    new = torch.zeros_like(old)
    vidx, cidx, nodes = [], [], []
    for _ in range(max_rounds):
        if not bool(act.any()):
            break
        lanes = act.nonzero()[:, 0]
        d = dn[lanes].clamp(0, m - 1)
        v = q[lanes]
        b = torch.ones_like(d)
        lb = torch.ones_like(d)
        for _ in range(height):
            addr = d * ub + pos[b]
            vidx.append(addr)
            nodes.append(b)
            router = vflat[addr]
            lb = torch.where(router != 0, b, lb)
            b = torch.where(b < bottom0, 2 * b + (v >= router).long(), b)
        bottom = lb >= bottom0
        old[lanes] += height + bottom.long()
        per_piece = (1 if tall else 0) + torch.where(d == staged[lanes], 0, 1)
        new[lanes] += per_piece * piece_count(height)
        caddr = d * lc + (lb - bottom0).clamp(min=0)
        cidx.append(caddr[bottom])
        nxt = torch.where(bottom, t.child.reshape(-1)[caddr].long(), -1)
        dn[lanes] = torch.where(nxt >= 0, nxt, dn[lanes])
        act[lanes] = nxt >= 0
    isz = t.value.element_size()
    distinct_v = torch.unique(torch.cat(vidx)).numel() if vidx else 0
    distinct_c = torch.unique(torch.cat(cidx)).numel() if cidx else 0
    nbytes = (distinct_v * isz + distinct_c * 4 + k * (isz + 4)
              + k * (2 * isz + 3 * 4) + pos_bytes(height, nodes))
    return nbytes, {"old": old, "new": new}


def rows_needs(rows, height: int, q) -> int:
    """Bytes one in-ΔNode descent per lane needs over
    pre-gathered rows: the distinct slots each lane reads (routers, left
    children, leaf), its child id, query and outputs."""
    import torch

    from repro_torch.kernels.ref import pos_table

    pos = pos_table(height, q.device).long()
    k, ubp = rows.shape
    bottom0 = 2 ** (height - 1)
    lane = torch.arange(k, device=q.device)
    b = torch.ones(k, dtype=torch.long, device=q.device)
    idx, nodes = [], []
    for _ in range(height - 1):
        pr, pl = pos[b], pos[(2 * b).clamp(max=2 * bottom0 - 1)]
        idx += [lane * ubp + pr, lane * ubp + pl]
        nodes += [b, (2 * b).clamp(max=2 * bottom0 - 1)]
        router = rows[lane, pr]
        internal = (b < bottom0) & (rows[lane, pl] != 0)
        b = torch.where(internal, 2 * b + (q >= router).long(), b)
    idx.append(lane * ubp + pos[b])
    isz = rows.element_size()
    distinct = torch.unique(torch.cat(idx)).numel()
    return (distinct * isz + int((b >= bottom0).sum()) * 4 + k * isz
            + k * (2 * isz + 2 * 4) + pos_bytes(height, nodes + [b]))


def scan_needs(t, height: int, roots, starts, his, max_out: int,
               pmask: int, max_rounds: int):
    """Bytes the scan kernel needs on these inputs: every distinct router
    slot, child id and mark its lanes read, each once, plus roots, bounds,
    outputs and the position table.  A replay of the FIND / VERIFY passes
    of `ref_delta_scan_fused` that records addresses; returns (bytes, the
    replay's per-lane emitted counts), the counts for a consistency check."""
    import torch

    from repro_torch.kernels.ref import pos_table, walk_big

    pos = pos_table(height, starts.device).long()
    m, ub = t.value.shape
    lc = t.child.shape[1]
    bottom0 = 2 ** (height - 1)
    big = walk_big(t.value.dtype)
    vflat, mflat, cflat = (t.value.reshape(-1), t.mark.reshape(-1),
                           t.child.reshape(-1))
    dn0 = roots.long()
    dn = dn0.clone()
    verify = torch.zeros_like(starts, dtype=torch.bool)
    q, cursor = starts.clone(), starts.clone()
    cand = torch.full_like(starts, big)
    n = torch.zeros_like(starts, dtype=torch.int32)
    done = starts == big
    vidx, cidx, midx, nodes = [], [], [], []
    for _ in range(max_rounds):
        if bool(done.all()):
            break
        ln = (~done).nonzero()[:, 0]
        d = dn[ln].clamp(0, m - 1)
        v, ver, cur, c = q[ln], verify[ln], cursor[ln], cand[ln]
        b = torch.ones_like(d)
        lb = torch.ones_like(d)
        lv = torch.zeros_like(v)
        routers, bs = [], []
        for _ in range(height):
            addr = d * ub + pos[b]
            vidx.append(addr)
            nodes.append(b)
            router = vflat[addr]
            routers.append(router)
            bs.append(b)
            lb = torch.where(router != 0, b, lb)
            lv = torch.where(router != 0, router, lv)
            b = torch.where(b < bottom0, 2 * b + (v >= router).long(), b)
        rcand = torch.full_like(v, big)
        for router, bi in zip(routers, bs):
            fold = (router != 0) & (bi != lb) & (v < router) & (router < rcand)
            rcand = torch.where(fold, router, rcand)
        bottom = lb >= bottom0
        caddr = d * lc + (lb - bottom0).clamp(min=0)
        cidx.append(caddr[bottom])
        nxt = torch.where(bottom, cflat[caddr].long(), -1)
        c = torch.where(~ver & (rcand < c), rcand, c)
        res = nxt < 0
        maddr = d * ub + pos[lb]
        midx.append(maddr[res])
        live = (lv != 0) & ~mflat[maddr]
        f_res = res & ~ver
        c = torch.where(f_res & live & (lv > cur) & (lv < c), lv, c)
        f_none = f_res & ((c == big) | (c > his[ln]))
        to_v = f_res & ~f_none
        v_res = res & ver
        hit = v_res & live & ((lv | pmask) == v)
        emit = hit & (n[ln] < max_out)
        full = hit & ~emit
        back = emit | (v_res & ~hit)
        restart = to_v | back
        dn[ln] = torch.where(nxt >= 0, nxt, torch.where(restart, dn0[ln],
                                                         dn[ln]))
        cursor[ln] = torch.where(back, v, cur)
        q[ln] = torch.where(to_v, c | pmask, v)
        verify[ln] = (ver | to_v) & ~back
        cand[ln] = torch.where(restart, big, c)
        n[ln] += emit.to(torch.int32)
        done[ln] = f_none | full
    isz = t.value.element_size()
    k = starts.numel()

    def distinct(idx):
        return torch.unique(torch.cat(idx)).numel() if idx else 0

    nbytes = (distinct(vidx) * isz + distinct(cidx) * 4 + distinct(midx)
              + k * (4 + 2 * isz) + k * max_out * isz + k * (4 + 4 + 1)
              + pos_bytes(height, nodes))
    return nbytes, n


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def scan_bands(rng, n_keys: int, k: int, density: str, max_out: int,
               key_max: int = KEY_MAX):
    """benchmarks/scan_sweep.py::_scan_row's windows over [1, key_max]:
    ``k`` lanes whose band holds ~``DENSITY_FILL[density] * max_out`` live
    keys; returns (exclusive starts, inclusive his) as int32 numpy
    arrays."""
    import numpy as np

    width = max(1, int(key_max / n_keys * DENSITY_FILL[density] * max_out))
    lo = rng.integers(1, max(2, key_max - width), k)
    return ((lo - 1).astype(np.int32),
            np.minimum(lo + width, key_max).astype(np.int32))


def pack_bands(cfg, starts, his, device):
    """Packed kernel bounds; the reserved ROUTE_LEFT start becomes the
    sentinel (`engine._walk_queries`)."""
    import torch

    from repro_torch.core.layout import ROUTE_LEFT
    from repro_torch.kernels.veb_search import walk_big

    st = torch.as_tensor(starts, device=device)
    sp = cfg.qpack(st)
    sp[st == int(ROUTE_LEFT)] = walk_big(cfg.vdtype)
    return sp.contiguous(), cfg.qpack(torch.as_tensor(his, device=device))


def check_lanes(cfg, t, n_keys: int, rng, device):
    """``SCAN_CHECK_K`` lanes for the scan comparison: sparse and dense
    bands, empty bands (hi <= start), bands past the last key, bands that
    start just below a tombstoned key, sentinel lanes, and per-lane roots
    at live non-root ΔNodes for 1 lane in 8.  Returns (starts, his, roots,
    number of tombstones seen)."""
    import numpy as np
    import torch

    from repro_torch.core.layout import ROUTE_LEFT

    k = SCAN_CHECK_K
    kind = rng.choice(6, k, p=[0.3, 0.3, 0.08, 0.08, 0.2, 0.04])
    st, hi = scan_bands(rng, n_keys, k, "sparse", 16)
    dst, dhi = scan_bands(rng, n_keys, k, "dense", 128)
    st = np.where(kind == 1, dst, st)
    hi = np.where(kind == 1, dhi, hi)
    hi = np.where(kind == 2, st - rng.integers(0, 100, k), hi)
    past = KEY_MAX + rng.integers(0, 1000, k)
    st = np.where(kind == 3, past, st)
    hi = np.where(kind == 3, past + 10_000, hi)
    tomb = cfg.key_of(t.value[t.mark & t.alive[:, None]]).cpu().numpy()
    if tomb.size:
        at = rng.choice(tomb, k)
        st = np.where(kind == 4, at - rng.integers(1, 4, k), st)
        hi = np.where(kind == 4, at + rng.integers(1, 400, k), hi)
    st = np.where(kind == 5, int(ROUTE_LEFT), st).astype(np.int32)
    hi = hi.astype(np.int32)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(k).clone()
    pick = torch.as_tensor(rng.random(k) < 1 / 8, device=device)
    idx = torch.as_tensor(rng.integers(0, alive.numel(), k), device=device)
    roots = torch.where(pick, alive[idx], roots).contiguous()
    return st, hi, roots, int(tomb.size)


def oracle_scan(live, starts, his, max_out: int):
    """The sorted-oracle answer to a scan batch: (keys (K, max_out) int32
    zero-padded past n, n, more) for bands (start, hi]."""
    import numpy as np

    lo = np.searchsorted(live, starts, side="right")
    cnt = np.maximum(np.searchsorted(live, his, side="right") - lo, 0)
    n = np.minimum(cnt, max_out)
    j = np.arange(max_out)[None, :]
    idx = np.minimum(lo[:, None] + j, max(live.size - 1, 0))
    keys = np.where(j < n[:, None], live[idx] if live.size else 0, 0)
    return keys.astype(np.int32), n.astype(np.int32), cnt > max_out


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def card_check() -> tuple[str, str]:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = card_name()
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import library, resource_usage

    sources = [Path(SOURCE).name, Path(SCAN_SOURCE).name,
               Path(PA_SOURCE).name]
    t0 = time.perf_counter()
    # the ptxas reports (phases 2 and 5.1) compile once more: beside the
    # builds, not after them
    with ThreadPoolExecutor(2 * len(sources)) as pool:
        reports = pool.map(resource_usage, sources)
        list(pool.map(library, sources))
        _PTXAS.update(zip(sources, reports))
    log(f"kernels of {', '.join(sources)} built and loaded, with their "
        f"ptxas reports, in {time.perf_counter() - t0:.2f} s")
    return card, torch.cuda.get_device_name(0)


_PTXAS: dict = {}   # source -> nvcc -Xptxas -v report (card_check)


def ptxas_report(source: str) -> str:
    """``build.resource_usage(source)``, taken once a run."""
    if source not in _PTXAS:
        from repro_torch.kernels.build import resource_usage

        _PTXAS[source] = resource_usage(source)
    return _PTXAS[source]


def churned_tree(keys, payload_bits: int, rng, device):
    """The Fig. 12 tree after three update batches (marks, grown leaves,
    expanded children; eager maintenance leaves every buffer drained)."""
    import numpy as np

    from repro_torch.core import deltatree as DT

    cfg = DT.TreeConfig(engine="lockstep", payload_bits=payload_bits,
                        **fig12_config(keys.size))
    pays = (keys % 4096).astype(np.int32) if payload_bits else None
    t = DT.bulk_build(cfg, keys, pays, device=device)
    for _ in range(3):
        kinds = mixed_kinds(rng, BATCH, 50)
        qk = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
        t, _, _ = DT.update_batch(cfg, t, kinds, qk, qk % 4096)
    return cfg, t


def kernel_queries(cfg, t, keys, k: int, rng, device):
    """k packed queries: half present keys, the rest absent or above every
    live key, 1/64 walk sentinels."""
    import numpy as np
    import torch

    from repro_torch.kernels.veb_search import walk_big

    q = rng.integers(1, KEY_MAX + 100_000, k).astype(np.int32)
    half = rng.random(k) < 0.5
    q[half] = rng.choice(keys, int(half.sum()))
    qp = cfg.qpack(torch.as_tensor(q, device=device))
    qp[torch.as_tensor(rng.random(k) < 1 / 64, device=device)] = \
        walk_big(cfg.vdtype)
    return qp


def check_rows_rounds(t, roots, q, height: int, max_rounds: int, where: str):
    """Replays the per-round walk (`repro_torch.kernels.ops._delta_walk`)
    and holds `veb_walk_rows` against its plain version in every round, on
    the rows that walk gathers: each lane's current ΔNode row and child
    row.  Returns the rounds run, the largest difference seen and the
    first round's inputs."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    m = t.value.shape[0]
    dn = roots.clone()
    resolved = q == VS.walk_big(t.value.dtype)
    first = None
    rounds = err = 0
    while rounds < max_rounds and not bool(resolved.all()):
        dnc = dn.clamp(0, m - 1).long()
        rws, crw = t.value[dnc], t.child[dnc]
        got = VS.veb_walk_rows(rws, crw, q, height=height)
        want = ref.ref_veb_walk_rows(rws, crw, q, height=height)
        err = max(err, *(int((a.long() - b.long()).abs().max())
                         for a, b in zip(got, want)))
        check(err == 0, f"veb_walk_rows != plain ({where}, round {rounds})")
        if first is None:
            first = (rws, crw)
        nxt = got[2]
        act = ~resolved
        dn = torch.where(act & (nxt >= 0), nxt, dn)
        resolved = resolved | (act & (nxt < 0))
        rounds += 1
    return rounds, err, first


def compare_scan(cfg, t, n_keys: int, sorted_keys, rng, device, flush,
                 mode: str) -> dict:
    """Phase 2 for `veb_scan_fused` on one churned tree: the comparison
    over `check_lanes`, then the timed K = 512 cells.  Returns the largest
    difference and the timed rows."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS
    from repro_torch.kernels.ops import scan_round_cap

    h = cfg.height
    st, hi, roots, n_tomb = check_lanes(cfg, t, n_keys, rng, device)
    sp, hp = pack_bands(cfg, st, hi, device)
    err = 0
    for max_out, cap in ((16, None), (128, None), (128, TRUNCATING_ROUNDS),
                         (128, TRUNCATING_ROUNDS + 1)):
        cap = cap or scan_round_cap(h, cfg.max_dnodes, max_out)
        args = (t.value, t.mark, t.child, roots, sp, hp)
        kw = dict(height=h, max_out=max_out, pmask=cfg.pmask, max_rounds=cap)
        got = VS.veb_scan_fused(*args, **kw)
        want = ref.ref_delta_scan_fused(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, *(int((a.long() - b.long()).abs().max())
                         for a, b in zip(got, want)))
        check(err == 0, f"veb_scan_fused != plain ({mode}, max_out "
                        f"{max_out}, cap {cap})")
        log(f"{mode}: veb_scan_fused equals its plain version on "
            f"{SCAN_CHECK_K} lanes, max_out {max_out}, cap {cap}: emitted "
            f"{int(got[1].sum())}, rows full {int(got[3].sum())}, lanes at "
            f"the cap {int((got[2] == cap).sum())}, max hops "
            f"{int(got[2].max())}, {n_tomb} tombstones in the tree")
    rows = []
    for density in DENSITY_FILL:
        for max_out in SCAN_MAX_OUT:
            st, hi = scan_bands(rng, n_keys, SCAN_K, density, max_out)
            sp, hp = pack_bands(cfg, st, hi, device)
            roots = t.root.expand(SCAN_K).contiguous()
            cap = scan_round_cap(h, cfg.max_dnodes, max_out)
            args = (t.value, t.mark, t.child, roots, sp, hp)
            kw = dict(height=h, max_out=max_out, pmask=cfg.pmask,
                      max_rounds=cap)

            def kern():
                return VS.veb_scan_fused(*args, **kw)

            def plain():
                return ref.ref_delta_scan_fused(*args, **kw)

            stk = torch.as_tensor(st, device=device)
            hik = torch.as_tensor(hi, device=device)
            span = torch.arange(max_out, device=device)

            def yardstick():
                i = torch.searchsorted(sorted_keys, stk, right=True)
                w = (i[:, None] + span).clamp(max=sorted_keys.numel() - 1)
                r = sorted_keys[w]
                return torch.where(r <= hik[:, None], r, 0)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            e = max(int((a.long() - b.long()).abs().max())
                    for a, b in zip(got, want))
            err = max(err, e)
            check(e == 0, f"veb_scan_fused != plain ({mode}, {density}, "
                          f"max_out {max_out}, K={SCAN_K})")
            nbytes, n_replay = scan_needs(t, h, roots, sp, hp, max_out,
                                          cfg.pmask, cap)
            check(torch.equal(n_replay, got[1]), "scan byte replay diverged")
            r = dict(mode=mode, density=density, max_out=max_out, K=SCAN_K,
                     ms=cuda_ms(kern, 10, flush),
                     simple_ms=SIMPLE_SCAN_MS[(mode, density, max_out)],
                     plain_ms=cuda_ms(plain, PLAIN_TIMED_REPS, flush),
                     bytes=nbytes,
                     bound_ms=bound_ms(nbytes), err=e,
                     searchsorted_ms=cuda_ms(yardstick, 10, flush),
                     emitted=int(got[1].sum()), rows_full=int(got[3].sum()),
                     mean_hops=float(got[2].float().mean()))
            log(json.dumps({"table": "veb_scan_fused", **r}))
            rows.append(r)
    return dict(err=err, rows=rows)


def deep_scan_check(payload_bits: int, device) -> int:
    """Phase 2, the scan kernel on paths deeper than its path stack (32
    ΔNodes): a height-3 tree after ``DEEP_KEYS`` ascending inserts in
    batches of 50 (each batch hangs below a longer chain of ΔNodes; built
    on the CPU, then moved to the card), 256 lanes with bands among the
    deepest keys, equal to the plain version at the full cap and at caps
    that cut lanes below the stack.  The tree is
    ``tests/_torch_parity.deep_tree``'s, which the CPU model of the
    kernel's loop and the card tests scan too.  Returns the deepest
    path."""
    import numpy as np
    import torch

    from repro_torch.core import deltatree as DT
    from repro_torch.core.layout import KEY_MAX as DOMAIN_MAX
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    cfg = DT.TreeConfig(height=3, max_dnodes=4096, buf_cap=8,
                        payload_bits=payload_bits, engine="lockstep")
    t = DT.bulk_build(cfg, np.arange(1, 5, dtype=np.int32),
                      np.arange(1, 5) if payload_bits else None, device="cpu")
    for s in range(0, DEEP_KEYS, 50):
        keys = np.arange(10 + s, 60 + s, dtype=np.int32)
        t, _, _ = DT.update_batch(cfg, t, np.ones(50, np.int32), keys,
                                  keys % 97)
    dels = np.arange(DEEP_KEYS - 30, DEEP_KEYS + 10, 3, dtype=np.int32)
    t, _, _ = DT.update_batch(cfg, t, np.full(dels.size, 2, np.int32), dels)
    t = DT.from_numpy(cfg, DT.to_numpy(t), device)
    rng = np.random.default_rng(payload_bits)
    k = 256
    st = rng.integers(DEEP_KEYS - 40, DEEP_KEYS, k).astype(np.int32)
    hi = (st + rng.integers(5, 80, k)).astype(np.int32)
    st[0], hi[0] = 0, DOMAIN_MAX
    sp = cfg.qpack(torch.as_tensor(st, device=device)).contiguous()
    hp = cfg.qpack(torch.as_tensor(hi, device=device)).contiguous()
    roots = t.root.expand(k).contiguous()
    depth = ref.ref_delta_walk_fused(t.value, t.child, roots, sp, height=3,
                                     max_rounds=10_000)[3]
    check(int(depth[1:].min()) > 32, "the deep-path check's paths fit the "
                                     "path stack")
    for cap in (10_000, 37, 501, 1000):
        args = (t.value, t.mark, t.child, roots, sp, hp)
        kw = dict(height=3, max_out=16, pmask=cfg.pmask, max_rounds=cap)
        got = VS.veb_scan_fused(*args, **kw)
        want = ref.ref_delta_scan_fused(*args, **kw)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        check(err == 0, f"veb_scan_fused != plain on deep paths (payload "
                        f"bits {payload_bits}, cap {cap})")
        log(f"deep paths (height 3, payload bits {payload_bits}): "
            f"veb_scan_fused equals its plain version on {k} lanes, cap "
            f"{cap}: paths {int(depth.min())}-{int(depth.max())} ΔNodes, "
            f"emitted {int(got[1].sum())}, lanes at the cap "
            f"{int((got[2] == cap).sum())}")
    return int(depth.max())


def walk_height_check(height: int, payload_bits: int, device) -> None:
    """Phase 2, both walk kernels on a small churned tree of another
    height than Fig. 12's (``tests/test_torch_cuda.py``'s tree: 20 k keys,
    two update batches): 4096 queries (present, absent, above every key,
    sentinels), 1 lane in 5 rooted at a live non-root ΔNode; the fused
    kernel equal to its plain version at K = 4096 and at batches that
    leave a block part-full, ``veb_walk_rows`` in every round of the
    per-round walk."""
    import numpy as np
    import torch

    from repro_torch.core import deltatree as DT
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    rng = np.random.default_rng(100 * height + payload_bits)
    vals = np.unique(rng.integers(1, 200_000, 20_000))
    n_eff = vals.size + 1024
    cfg = DT.TreeConfig(height=height, buf_cap=16, engine="lockstep",
                        payload_bits=payload_bits,
                        max_dnodes=max(256, 6 * n_eff // 2 ** (height - 1)))
    t = DT.bulk_build(cfg, vals, vals % 4096 if payload_bits else None,
                      device=device)
    for _ in range(2):
        kinds = rng.choice([1, 2], 512).astype(np.int32)
        keys = rng.integers(1, 200_000, 512).astype(np.int32)
        t, _, _ = DT.update_batch(cfg, t, kinds, keys, keys % 4096)
    check(not bool(t.alloc_fail), f"arena exhausted at height {height}")
    q = kernel_queries(cfg, t, vals, 4096, rng, device)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(q.numel()).clone()
    pick = rng.integers(0, alive.numel(), roots[::5].numel())
    roots[::5] = alive[torch.as_tensor(pick, device=device)]
    cap = cfg.walk_round_cap
    where = f"height {height}, payload bits {payload_bits}"
    for k in WALK_CHECK_K:
        rk, qk = roots[:k].contiguous(), q[:k].contiguous()
        got = VS.veb_walk_fused(t.value, t.child, rk, qk, height=height,
                                max_rounds=cap)
        want = ref.ref_delta_walk_fused(t.value, t.child, rk, qk,
                                        height=height, max_rounds=cap)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        check(err == 0, f"veb_walk_fused != plain ({where}, K={k})")
        rounds, _, _ = check_rows_rounds(t, rk, qk, height, cap,
                                         f"{where}, K={k}")
    log(f"height {height}, payload bits {payload_bits}: both walk kernels "
        f"equal their plain versions (K = {', '.join(map(str, WALK_CHECK_K))}"
        f"; max hops {int(got[3].max())}, veb_walk_rows in all {rounds} "
        f"rounds)")


def block_sizes_leg(cfg, t, keys, rng, device, flush, mode: str) -> dict:
    """Phase 2, kernels 1-2 at every built block size on a Fig. 12 churned
    tree: ``CHECK_K`` queries, 1 lane in 5 rooted at a live non-root ΔNode
    (so a block's lanes need not share the root it stages), each size's
    fused walk and rows walk (over the first round's rows) equal to the
    plain versions exactly; an unbuilt size refused by the wrapper and by
    the library.  Then each size timed at ``TIMED_K`` from the root, in
    turns (sizes in order, then reversed; the mean of the two readings).
    Returns {kernel: {K: {size: ms}}}."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    h, cap = cfg.height, cfg.walk_round_cap
    q = kernel_queries(cfg, t, keys, CHECK_K, rng, device)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(CHECK_K).clone()
    pick = torch.as_tensor(rng.integers(0, alive.numel(), roots[::5].numel()),
                           device=device)
    roots[::5] = alive[pick]
    rws, crw = t.value[roots.long()], t.child[roots.long()]
    want_f = ref.ref_delta_walk_fused(t.value, t.child, roots, q, height=h,
                                      max_rounds=cap)
    want_r = ref.ref_veb_walk_rows(rws, crw, q, height=h)
    for size in VS.BLOCK_SIZES:
        got_f = VS.veb_walk_fused(t.value, t.child, roots, q, height=h,
                                  max_rounds=cap, q_tile=size)
        got_r = VS.veb_walk_rows(rws, crw, q, height=h, q_tile=size)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got_f, want_f)),
              f"veb_walk_fused != plain at {size} threads a block ({mode})")
        check(all(torch.equal(a, b) for a, b in zip(got_r, want_r)),
              f"veb_walk_rows != plain at {size} threads a block ({mode})")
    try:
        VS.veb_walk_fused(t.value, t.child, roots, q, height=h,
                          max_rounds=cap, q_tile=48)
        check(False, "veb_walk_fused took an unbuilt block size")
    except ValueError as e:
        check("block size" in str(e), f"unbuilt block size: {e}")
    out = [torch.empty_like(x) for x in want_r]
    fn = VS._kernel_fn(f"veb_walk_rows_{VS._suffix(t.value.dtype)}",
                       VS._ROWS_ARGS)
    err = fn(rws.data_ptr(), crw.data_ptr(), q.data_ptr(),
             VS.pos_table(h, device).data_ptr(), CHECK_K, rws.shape[1],
             crw.shape[1], h, *(x.data_ptr() for x in out), 48,
             torch.cuda.current_stream().cuda_stream)
    check(err != 0, "the library launched an unbuilt block size")
    log(f"{mode}: kernels 1-2 equal their plain versions at "
        f"{', '.join(map(str, VS.BLOCK_SIZES))} threads a block (K = "
        f"{CHECK_K}, 1 lane in 5 at a non-root ΔNode); 48 refused "
        f"(wrapper, library error {err})")
    times = {"fused": {}, "rows": {}}
    order = list(VS.BLOCK_SIZES) + list(VS.BLOCK_SIZES)[::-1]
    for k in TIMED_K:
        qk = kernel_queries(cfg, t, keys, k, rng, device)
        rk = t.root.expand(k).contiguous()
        rws_k, crw_k = t.value[rk.long()], t.child[rk.long()]
        calls = {
            "fused": lambda size: VS.veb_walk_fused(
                t.value, t.child, rk, qk, height=h, max_rounds=cap,
                q_tile=size),
            "rows": lambda size: VS.veb_walk_rows(rws_k, crw_k, qk, height=h,
                                                  q_tile=size)}
        reps = 20 if k == BATCH else 5
        for name, call in calls.items():
            got = {size: [] for size in VS.BLOCK_SIZES}
            for size in order:
                got[size].append(cuda_ms(lambda: call(size), reps, flush))
            times[name][k] = {size: statistics.fmean(v)
                              for size, v in got.items()}
            log(json.dumps({"table": f"veb_walk_{name} block sizes",
                            "mode": mode, "K": k, "ms": times[name][k],
                            "readings": got}))
    return times


def tall_tree(height: int, payload_bits: int, rng, device, size=None):
    """A tall tree (``size``: draws and ΔNodes, else ``TALL_TREES``) on
    the card after one eager update batch of 1024 inserts and deletes
    (tombstones, grown leaves)."""
    import numpy as np

    from repro_torch.core import deltatree as DT

    n, max_dnodes = size or TALL_TREES[height]
    cfg = DT.TreeConfig(height=height, max_dnodes=max_dnodes, buf_cap=16,
                        payload_bits=payload_bits, engine="lockstep")
    vals = np.unique(rng.integers(1, KEY_MAX, n).astype(np.int32))
    t = DT.bulk_build(cfg, vals, vals % 4096 if payload_bits else None,
                      device=device)
    kinds = mixed_kinds(rng, BATCH, 100)
    qk = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
    qk[kinds == 2] = rng.choice(vals, int((kinds == 2).sum()))
    t, _, _ = DT.update_batch(cfg, t, kinds, qk, qk % 4096)
    check(not bool(t.alloc_fail), f"arena exhausted at height {height}")
    check(int(t.alive.sum()) > 1, f"one ΔNode at height {height}")
    return cfg, t, vals


def tall_check(height: int, payload_bits: int, rng, device, flush) -> dict:
    """Phase 2, kernels 1-3 on the tall path (the position table in
    global memory, no root staged) on a `tall_tree`:
    the fused walk at ``TALL_CHECK_K`` queries (1 lane in 5 at a live
    non-root ΔNode),
    ``veb_walk_rows`` in every round of the per-round walk over
    ``TALL_ROWS_K`` lanes, the scan over ``check_lanes``' bands at
    ``max_out`` 16 and 128 and a cap that cuts lanes, each equal to its
    plain version exactly.  At height 22 in set mode each kernel is then
    timed beside its plain version and its bytes bound: the fused walk at
    K = 1024 from the root, the rows walk over those lanes' root rows at
    ``TALL_ROWS_K``, the scan at K = 512 over dense bands at ``max_out``
    128.  Returns the largest difference and the timed rows."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS
    from repro_torch.kernels.ops import scan_round_cap

    t0 = time.perf_counter()
    cfg, t, vals = tall_tree(height, payload_bits, rng, device)
    build_s = time.perf_counter() - t0
    h, cap = height, cfg.walk_round_cap
    where = f"height {h}, payload bits {payload_bits}"
    q = kernel_queries(cfg, t, vals, max(TALL_CHECK_K), rng, device)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(q.numel()).clone()
    pick = torch.as_tensor(rng.integers(0, alive.numel(), roots[::5].numel()),
                           device=device)
    roots[::5] = alive[pick]
    err = 0
    for k in TALL_CHECK_K:
        rk, qk = roots[:k].contiguous(), q[:k].contiguous()
        got = VS.veb_walk_fused(t.value, t.child, rk, qk, height=h,
                                max_rounds=cap)
        want = ref.ref_delta_walk_fused(t.value, t.child, rk, qk, height=h,
                                        max_rounds=cap)
        torch.cuda.synchronize()
        err = max(err, *(int((a.long() - b.long()).abs().max())
                         for a, b in zip(got, want)))
        check(err == 0, f"veb_walk_fused != plain ({where}, K={k})")
    hops = int(got[3].max())
    rounds, _, _ = check_rows_rounds(t, roots[:TALL_ROWS_K].contiguous(),
                                     q[:TALL_ROWS_K].contiguous(), h, cap,
                                     where)
    st, hi, sroots, n_tomb = check_lanes(cfg, t, vals.size, rng, device)
    sp, hp = pack_bands(cfg, st, hi, device)
    cut = 0
    for max_out, scap in ((16, None), (128, None), (128, TRUNCATING_ROUNDS)):
        scap = scap or scan_round_cap(h, cfg.max_dnodes, max_out)
        args = (t.value, t.mark, t.child, sroots, sp, hp)
        kw = dict(height=h, max_out=max_out, pmask=cfg.pmask,
                  max_rounds=scap)
        got = VS.veb_scan_fused(*args, **kw)
        want = ref.ref_delta_scan_fused(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, *(int((a.long() - b.long()).abs().max())
                         for a, b in zip(got, want)))
        check(err == 0, f"veb_scan_fused != plain ({where}, max_out "
                        f"{max_out}, cap {scap})")
        cut += int((got[2] == scap).sum())
    log(f"{where}: kernels 1-3 equal their plain versions on the tall path "
        f"({int(t.alive.sum())} ΔNodes, {n_tomb} tombstones, built and "
        f"churned in {build_s:.1f} s; walk K = "
        f"{', '.join(map(str, TALL_CHECK_K))}, max hops {hops}; rows in all "
        f"{rounds} rounds of {TALL_ROWS_K} lanes; scan {SCAN_CHECK_K} lanes, "
        f"{cut} cut by the cap)")
    rows = {}
    if h == max(TALL_TREES) and not payload_bits:
        qk = kernel_queries(cfg, t, vals, BATCH, rng, device)
        rk = t.root.expand(BATCH).contiguous()
        rws = t.value[rk[:TALL_ROWS_K].long()]
        crw = t.child[rk[:TALL_ROWS_K].long()]
        qr = qk[:TALL_ROWS_K].contiguous()
        st, hi = scan_bands(rng, vals.size, SCAN_K, "dense", 128)
        sp, hp = pack_bands(cfg, st, hi, device)
        sr = t.root.expand(SCAN_K).contiguous()
        scap = scan_round_cap(h, cfg.max_dnodes, 128)
        skw = dict(height=h, max_out=128, pmask=cfg.pmask, max_rounds=scap)
        calls = {
            "fused": (lambda: VS.veb_walk_fused(t.value, t.child, rk, qk,
                                                height=h, max_rounds=cap),
                      lambda: ref.ref_delta_walk_fused(
                          t.value, t.child, rk, qk, height=h, max_rounds=cap),
                      fused_needs(t, h, qk, rk, cap)[0], BATCH),
            "rows": (lambda: VS.veb_walk_rows(rws, crw, qr, height=h),
                     lambda: ref.ref_veb_walk_rows(rws, crw, qr, height=h),
                     rows_needs(rws, h, qr), TALL_ROWS_K),
            "scan": (lambda: VS.veb_scan_fused(t.value, t.mark, t.child, sr,
                                               sp, hp, **skw),
                     lambda: ref.ref_delta_scan_fused(t.value, t.mark,
                                                      t.child, sr, sp, hp,
                                                      **skw),
                     scan_needs(t, h, sr, sp, hp, 128, cfg.pmask, scap)[0],
                     SCAN_K),
        }
        for name, (kern, plain, nbytes, k) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            e = max(int((a.long() - b.long()).abs().max())
                    for a, b in zip(got, want))
            check(e == 0, f"{name} != plain on the timed tall lanes")
            rows[name] = dict(height=h, K=k, ms=cuda_ms(kern, 10, flush),
                              plain_ms=cuda_ms(plain, PLAIN_TIMED_REPS, flush),
                              bytes=nbytes,
                              bound_ms=bound_ms(nbytes), err=e)
            log(json.dumps({"table": f"tall {name}", "mode": "set int32",
                            **rows[name]}))
    del t
    torch.cuda.empty_cache()
    return dict(err=err, rows=rows)


def autotune_leg(device) -> dict:
    """Phase 2, `kernels.autotune.sweep_height` on the card at
    ``AUTOTUNE_HEIGHTS`` in set and map mode (its defaults: 50,000 draws,
    batch 1024, best of 3 runs of 10 launches), ``AUTOTUNE_SWEEPS`` times
    each, so that each size has repeated reads; the size with the least
    mean is merged into a cache file under build/ (`save_cache`), which
    must read back through `ops.default_q_tile`.  Returns
    {"h/mode/bits": {size: [ms a sweep]}} and the seconds."""
    import os

    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels.ops import default_q_tile

    t0 = time.perf_counter()
    path = ROOT / "build" / "chip_autotune.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    out = {}
    for bits in (0, 12):
        for h in AUTOTUNE_HEIGHTS:
            key = AT._key(h, True, 64 if bits else 32)
            reads = {}
            for _ in range(AUTOTUNE_SWEEPS):
                _, timings = AT.sweep_height(h, payload_bits=bits,
                                             device=device)
                for size, sec in timings.items():
                    reads.setdefault(size, []).append(sec * 1e3)
            best = min(reads, key=lambda size: statistics.fmean(reads[size]))
            check(AT.save_cache({key: best}, str(path)) == str(path),
                  "autotune cache not written")
            out[key] = reads
            log(json.dumps({"autotune": key, "best": best, "ms": reads}))
    old = os.environ.get(AT.ENV_CACHE)
    os.environ[AT.ENV_CACHE] = str(path)
    try:
        table = AT.load_cache()
        check(len(table) == 2 * len(AUTOTUNE_HEIGHTS), f"cache: {table}")
        for key, best in table.items():
            h, _, bits = key.split("/")
            check(default_q_tile(int(h), 12 if bits == "64" else 0) == best,
                  f"default_q_tile does not read the cache at {key}")
    finally:
        if old is None:
            os.environ.pop(AT.ENV_CACHE, None)
        else:
            os.environ[AT.ENV_CACHE] = old
    seconds = time.perf_counter() - t0
    log(f"autotune leg: {len(out)} keys x {AUTOTUNE_SWEEPS} sweeps in "
        f"{seconds:.1f} s, cache {path}")
    return dict(ms=out, seconds=seconds)


def compare_kernels(keys, rng, device, flush) -> dict:
    """Phase 2.  Returns per-kernel rows for the result line (walks timed
    at the main path's batch of 1024, the scan at K = 512) and prints the
    wider timing tables."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS
    rows = {}
    scan = []
    sorted_keys = None
    walk_usage = ptxas_lines(ptxas_report(Path(SOURCE).name),
                             ("walk_fused_kernel", "walk_rows_kernel"))
    usage = ptxas_lines(ptxas_report(Path(SCAN_SOURCE).name),
                        ("scan_fused_kernel",))
    for line in walk_usage + usage:
        log(f"ptxas: {line}")
    for height in WALK_CHECK_HEIGHTS:
        for bits in (0, 12):
            walk_height_check(height, bits, device)
    deep = [deep_scan_check(bits, device) for bits in (0, 12)]
    blocks, leg_s = {}, {}
    for bits in (0, 12):
        mode = "map int64" if bits else "set int32"
        cfg, t = churned_tree(keys, bits, rng, device)
        h, cap = cfg.height, cfg.walk_round_cap
        if sorted_keys is None:
            from repro_torch.core import deltatree as DT

            sorted_keys = torch.as_tensor(DT.live_keys(cfg, t), device=device)
        for k in (CHECK_K, *TIMED_K):
            q = kernel_queries(cfg, t, keys, k, rng, device)
            roots = t.root.expand(k).contiguous()

            def fused():
                return VS.veb_walk_fused(t.value, t.child, roots, q,
                                         height=h, max_rounds=cap)

            def plain():
                return ref.ref_delta_walk_fused(t.value, t.child, roots, q,
                                                height=h, max_rounds=cap)

            got, want = fused(), plain()
            torch.cuda.synchronize()
            err = max(int((a.long() - b.long()).abs().max()) for a, b in
                      zip(got, want))
            check(err == 0, f"veb_walk_fused != plain ({mode}, K={k})")
            rounds, rerr, (rws, crw) = check_rows_rounds(
                t, roots, q, h, cap, f"{mode}, K={k}")

            def rows_k():
                return VS.veb_walk_rows(rws, crw, q, height=h)

            def rows_p():
                return ref.ref_veb_walk_rows(rws, crw, q, height=h)

            if k == CHECK_K:
                log(f"{mode}: both kernels equal their plain versions "
                    f"on 2**16 queries (max hops {int(got[3].max())}, "
                    f"veb_walk_rows checked in all {rounds} rounds)")
                continue
            keys_q = cfg.key_of(q).to(torch.int32).contiguous()
            reps = 20 if k == BATCH else 5
            fb, trips = fused_needs(t, h, q, roots, cap)
            rb = rows_needs(rws, h, q)
            res = {
                "fused": dict(ms=cuda_ms(fused, reps, flush),
                              plain_ms=cuda_ms(plain, 3, flush),
                              bytes=fb, err=err, bound_ms=bound_ms(fb),
                              trips_old=float(trips["old"].float().mean()),
                              trips_new=float(trips["new"].float().mean())),
                "rows": dict(ms=cuda_ms(rows_k, reps, flush),
                             plain_ms=cuda_ms(rows_p, 3, flush),
                             bytes=rb, err=rerr, bound_ms=bound_ms(rb),
                             rounds=rounds),
            }
            ss = cuda_ms(lambda: torch.searchsorted(sorted_keys, keys_q),
                         reps, flush)
            for name, r in res.items():
                r["searchsorted_ms"] = ss
                r["simple_ms"] = SIMPLE_WALK_MS.get((name, mode, k))
                log(json.dumps({"table": f"veb_walk_{name}", "mode": mode,
                                "K": k, **r}))
                if k == BATCH and bits == 0:
                    rows[name] = r
        scan.append(compare_scan(cfg, t, keys.size, sorted_keys, rng, device,
                                 flush, mode))
        t0 = time.perf_counter()
        blocks[mode] = block_sizes_leg(cfg, t, keys, rng, device, flush, mode)
        leg_s[f"block sizes, {mode}"] = time.perf_counter() - t0
        del t
        torch.cuda.empty_cache()
    tall = {}
    for height in TALL_TREES:
        for bits in (0, 12):
            t0 = time.perf_counter()
            r = tall_check(height, bits, rng, device, flush)
            tall.update(r["rows"])
            tall["err"] = max(tall.get("err", 0), r["err"])
            leg_s[f"tall {height}, payload bits {bits}"] = \
                time.perf_counter() - t0
    tune = autotune_leg(device)
    leg_s["autotune"] = tune["seconds"]
    log(json.dumps({"phase 2 new legs (s)": leg_s}))
    # the result line carries the set-mode dense max_out=128 cell (the
    # default page of Index.range_scan); every cell is in the log
    cell = next(r for r in scan[0]["rows"]
                if r["density"] == "dense" and r["max_out"] == 128)
    rows["fused"]["ptxas"] = rows["rows"]["ptxas"] = walk_usage
    rows["scan"] = dict(cell, err=max(x["err"] for x in scan),
                        cells=[r for x in scan for r in x["rows"]],
                        ptxas=usage, deep_paths=deep)
    for name in ("fused", "rows"):
        rows[name]["block_ms"] = blocks["set int32"][name][BATCH]
        rows[name]["err"] = max(rows[name]["err"], tall["err"])
    rows["scan"]["err"] = max(rows["scan"]["err"], tall["err"])
    for name in ("fused", "rows", "scan"):
        rows[name]["tall"] = tall[name]
    rows["fused"]["autotune_ms"] = tune["ms"]
    return rows


def reset_counts() -> None:
    from repro_torch.kernels import delta_paged_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    VS.veb_walk_fused.launches = 0
    VS.veb_walk_rows.launches = 0
    VS.veb_scan_fused.launches = 0
    PA.paged_decode_attention.launches = 0
    ref.ref_delta_walk_fused.calls = 0
    ref.ref_veb_walk_rows.calls = 0
    ref.ref_delta_scan_fused.calls = 0
    ref.ref_paged_decode_attention.calls = 0


def read_counts() -> dict:
    from repro_torch.kernels import delta_paged_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    return dict(fused=VS.veb_walk_fused.launches,
                rows=VS.veb_walk_rows.launches,
                scan=VS.veb_scan_fused.launches,
                paged=PA.paged_decode_attention.launches,
                plain=ref.ref_delta_walk_fused.calls
                + ref.ref_veb_walk_rows.calls
                + ref.ref_delta_scan_fused.calls
                + ref.ref_paged_decode_attention.calls)


def main_path(keys, rng, device, steps: int, walk_fused: bool):
    """Phase 3: Fig. 12's concurrency-1024 mix through the Index API.
    Returns (result row, index, oracle)."""
    import numpy as np
    import torch

    from repro_torch.api import OpBatch, make_index
    from repro_torch.core.oracle import SetOracle

    t0 = time.perf_counter()
    ix = make_index("deltatree", initial=keys, engine="lockstep",
                    device=device, walk_fused=walk_fused,
                    **fig12_config(keys.size))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    arena = sum(x.numel() * x.element_size() for x in ix.state)
    oracle = SetOracle(keys)
    reset_counts()
    search_s, update_s, hops = [], [], []
    for step in range(steps):
        kinds = mixed_kinds(rng, BATCH, UPDATE_PCT)
        qk = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
        t1 = time.perf_counter()
        found, h = ix.search(qk)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ix, res = ix.insert_delete(OpBatch.mixed(kinds, qk))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        search_s.append(t2 - t1)
        update_s.append(t3 - t2)
        hops.append(float(h.float().mean()))
        check((found.cpu().numpy() == oracle.snapshot_search(qk)).all(),
              f"search results differ from the oracle at step {step}")
        check((res.cpu().numpy() == oracle.apply_updates(kinds, qk)).all(),
              f"update results differ from the oracle at step {step}")
    q = rng.integers(0, KEY_MAX + 1000, BATCH).astype(np.int32)
    q[:8] = np.iinfo(np.int32).max - 1
    sf, sk = ix.successor(q)
    live = oracle.keys()
    idx = np.searchsorted(live, q, side="right")
    want_f = idx < live.size
    want_k = np.where(want_f, live[np.minimum(idx, live.size - 1)], 0)
    check((sf.cpu().numpy() == want_f).all()
          and (sk.cpu().numpy() == want_k).all(),
          "successor results differ from the oracle")
    torch.cuda.synchronize()
    counts = read_counts()
    from repro_torch.core import deltatree as DT

    check((DT.live_keys(ix.cfg, ix.state) == live).all(),
          "live keys differ from the oracle")
    check(not ix.alloc_failed(), "arena allocation failed")
    row = dict(walk_fused=walk_fused, keys=int(keys.size),
               max_dnodes=ix.cfg.max_dnodes, arena_mb=arena / 1e6,
               build_s=build_s, steps=steps, counts=counts,
               search_ms=statistics.median(search_s[1:] or search_s) * 1e3,
               update_ms=statistics.median(update_s[1:] or update_s) * 1e3,
               mean_hops=statistics.fmean(hops), size=ix.size())
    return row, ix, oracle


def timed(fn):
    """(fn's result, host seconds to its end on the card)."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_scan(res, live, starts, his, max_out: int, where: str) -> None:
    """A scan batch's (keys, payloads, n, hops, more) equals the sorted
    oracle on bands (start, hi]."""
    keys, n, more = oracle_scan(live, starts, his, max_out)
    check((res[0].cpu().numpy() == keys).all()
          and (res[2].cpu().numpy() == n).all()
          and (res[4].cpu().numpy() == more).all(),
          f"scan results differ from the oracle ({where})")


def scan_path(ix, oracle, rng) -> dict:
    """Phase 3, range scans on the main path's index: one K = 512 batch
    per (density, max_out) cell, one successor_k batch, three paginated
    range_scans.  Counters set to 0 before, read after."""
    import numpy as np

    from repro_torch.core.layout import KEY_MAX as DOMAIN_MAX

    live = oracle.keys()
    reset_counts()
    batch_ms = {}
    for density in DENSITY_FILL:
        for max_out in SCAN_MAX_OUT:
            st, hi = scan_bands(rng, live.size, SCAN_K, density, max_out)
            res, sec = timed(lambda: ix.spec.backend.scan(
                ix.cfg, ix.state, st, hi, max_out))
            check_scan(res, live, st, hi, max_out, f"{density} {max_out}")
            batch_ms[f"{density}/{max_out}"] = sec * 1e3
    q = rng.integers(0, KEY_MAX + 1000, BATCH).astype(np.int32)
    res, sec = timed(lambda: ix.successor_k(q, 16))
    check_scan(res, live, q, np.full_like(q, DOMAIN_MAX), 16, "successor_k")
    batch_ms["successor_k/16"] = sec * 1e3
    pages, page_ms = 0, []
    for _ in range(3):
        width = int(KEY_MAX / live.size * 1000)
        lo = int(rng.integers(1, KEY_MAX - width))
        hi = lo + width
        got, cursor = [], None
        while True:
            res, sec = timed(lambda: ix.range_scan(lo, hi, cursor=cursor))
            page_ms.append(sec * 1e3)
            got.extend(res.keys.tolist())
            pages += 1
            if res.cursor is None:
                break
            cursor = res.cursor
        want = live[(live >= lo) & (live <= hi)]
        check(got == want.tolist(), "range_scan pages differ from the oracle")
    counts = read_counts()
    check(counts["scan"] > 0, "the scan path did not launch veb_scan_fused")
    check(counts["plain"] == 0, "the scan path ran a plain version")
    return dict(batch_ms=batch_ms, pages=pages,
                page_ms=statistics.median(page_ms), counts=counts)


def relaxed_path(keys, rng, device, policy: str, steps: int) -> dict:
    """Phase 4: the Fig. 12 mix under a relaxed maintenance policy, scans
    and successors checked against the oracle every step, then flush.

    Uniform inserts into ~1.97 M keys almost never meet in one leaf
    position (a few hundred inserts over ~2 M gaps), so the Fig. 12 mix
    alone leaves the overflow buffers empty.  A first batch therefore
    inserts runs of consecutive keys after 128 live keys (time-ordered ids
    do this): the third key of a run and later ones reach an occupied
    bottom leaf and are buffered, and the relaxed policy carries them
    through the steps that follow, where every scan must merge them.
    Counters set to 0 before the batches, read after."""
    import numpy as np
    import torch

    from repro_torch.api import OpBatch, make_index
    from repro_torch.core import deltatree as DT
    from repro_torch.core.oracle import SetOracle

    ix = make_index("deltatree", initial=keys, engine="lockstep",
                    maintenance=policy, device=device,
                    **fig12_config(keys.size))
    torch.cuda.synchronize()
    oracle = SetOracle(keys)
    reset_counts()
    runs = (rng.choice(keys, BATCH // 8)[:, None]
            + np.arange(1, 9)).reshape(-1).astype(np.int32)
    ones = np.ones(runs.size, np.int32)
    (ix, res, stats), clustered_s = timed(lambda: ix.update(
        OpBatch.mixed(ones, runs)))
    check((res.cpu().numpy() == oracle.apply_updates(ones, runs)).all(),
          f"{policy}: clustered insert results differ from the oracle")
    update_s, scan_s, pending, merged = [], [], [stats.pending], []
    for step in range(steps):
        kinds = mixed_kinds(rng, BATCH, UPDATE_PCT)
        qk = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
        found, _ = ix.search(qk)
        check((found.cpu().numpy() == oracle.snapshot_search(qk)).all(),
              f"{policy}: search differs from the oracle at step {step}")
        (ix, res, stats), sec = timed(lambda: ix.update(
            OpBatch.mixed(kinds, qk)))
        update_s.append(sec)
        pending.append(stats.pending)
        check((res.cpu().numpy() == oracle.apply_updates(kinds, qk)).all(),
              f"{policy}: update results differ at step {step}")
        live = oracle.keys()
        st, hi = scan_bands(rng, live.size, SCAN_K, "dense", 128)
        sres, sec = timed(lambda: ix.spec.backend.scan(
            ix.cfg, ix.state, st, hi, 128))
        scan_s.append(sec)
        check_scan(sres, live, st, hi, 128, f"{policy} step {step}")
        buf = ix.state.buf
        buffered = ix.cfg.key_of(buf[buf != 0]).cpu().numpy()
        merged.append(int(np.isin(sres[0].cpu().numpy(), buffered).sum()))
        q = rng.integers(0, KEY_MAX + 1000, BATCH).astype(np.int32)
        sf, sk = ix.successor(q)
        idx = np.searchsorted(live, q, side="right")
        want_f = idx < live.size
        want_k = np.where(want_f, live[np.minimum(idx, live.size - 1)], 0)
        check((sf.cpu().numpy() == want_f).all()
              and (sk.cpu().numpy() == want_k).all(),
              f"{policy}: successor differs from the oracle at step {step}")
    counts = read_counts()
    check(min(pending) > 0, f"{policy}: a step carried no buffered items")
    check(sum(merged) > 0, f"{policy}: no scan emitted a buffered item")
    check(counts["scan"] >= steps, f"{policy}: veb_scan_fused not launched")
    check(counts["plain"] == 0, f"{policy}: a plain version ran")
    (ix, fstats), flush_s = timed(ix.flush)
    check(fstats.pending == 0, f"{policy}: flush left buffered items")
    check((DT.live_keys(ix.cfg, ix.state) == oracle.keys()).all(),
          f"{policy}: live keys differ from the oracle after flush")
    check(not ix.alloc_failed(), f"{policy}: arena allocation failed")
    return dict(policy=policy, steps=steps, pending=pending, counts=counts,
                merged_items=merged, clustered_ms=clustered_s * 1e3,
                update_ms=statistics.median(update_s) * 1e3,
                scan_ms=statistics.median(scan_s) * 1e3,
                flush_s=flush_s, flush_rounds=fstats.rounds)


def replay_runs():
    """The card replay's runs (``tests/_torch_traces.py``): (label, cfg,
    initial keys or None, steps).  The committed Expand-keep traces, then
    the seeded op sequences of each policy's lockstep configuration (every
    batch padded as the tests pad it); a step is a (kinds, keys) batch or
    "flush" (a one-repair flush)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_traces as T
    from repro_torch.core import deltatree as DT

    for policy in sorted(T.KEEP_TRACES):
        yield (f"keep {policy}", DT.TreeConfig(maintenance=policy,
                                               **T.KEEP_CFG),
               T.KEEP_INIT, list(T.keep_steps(policy)))
    for policy, engine, height in T.SEQ_CONFIGS:
        if engine != "lockstep":
            continue
        cfg = DT.TreeConfig(height=height, maintenance=policy,
                            engine=engine, **T.SEQ_CFG)
        seqs = T.seeded_sequences(T.seq_seed(policy, engine, height))
        for s, seq in enumerate(seqs):
            yield (f"seq {policy} h{height} #{s}", cfg, None,
                   [T.pad(kinds, keys) for kinds, keys in seq])


def replay_play(cfg, init, steps, device) -> list:
    """One run on ``device``: after each step its results, stats, whole
    arena and, before each update, the batch's search, successor and a
    scan (start key - 5 < key <= key + 15, ``max_out`` 8) as numpy."""
    import numpy as np

    from repro_torch.core import deltatree as DT

    def host(cols):
        return [c.cpu().numpy() for c in cols]

    t = (DT.empty(cfg, device=device) if init is None
         else DT.bulk_build(cfg, init, device=device))
    out = []
    for step in steps:
        rec = {}
        if step == "flush":
            t, st = DT.flush(cfg, t, 1)
        else:
            kinds, keys = step
            rec["search"] = host(DT.search_batch(cfg, t, keys))
            rec["succ"] = host(DT.successor_batch(cfg, t, keys))
            rec["scan"] = host(DT.scan_batch(
                cfg, t, np.maximum(keys - 5, 0).astype(np.int32),
                (keys + 15).astype(np.int32), 8))
            t, res, st = DT.update_batch(cfg, t, kinds, keys)
            rec["res"] = res.cpu().numpy()
        rec["stats"] = np.asarray(tuple(st))
        rec.update(DT.to_numpy(t))
        out.append(rec)
    return out


def replay_leg(device) -> dict:
    """Phase 4's card replay: every run of `replay_runs` on the CPU port
    (the kernels' plain versions), then on the card (kernels 2 and 3),
    each step's every array equal.  Counters set to 0 before the card's
    runs, read after: the fused walk and the scan must launch, no plain
    version may run."""
    import numpy as np

    def same(a, b) -> bool:      # arrays, or lists of a read's columns
        a, b = (a, b) if isinstance(b, list) else ([a], [b])
        return len(a) == len(b) and all(
            x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))

    runs = list(replay_runs())
    t0 = time.perf_counter()
    want = [replay_play(cfg, init, steps, "cpu")
            for _, cfg, init, steps in runs]
    cpu_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    n_steps = 0
    for (label, cfg, init, steps), ref in zip(runs, want):
        got = replay_play(cfg, init, steps, device)
        for i, (g, w) in enumerate(zip(got, ref)):
            check(g.keys() == w.keys(), f"replay {label} step {i}: fields")
            for name in w:
                check(same(g[name], w[name]), f"replay {label} step {i}: "
                      f"{name} differs between the card and the CPU")
        n_steps += len(steps)
    card_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["fused"] > 0, "replay: veb_walk_fused not launched")
    check(counts["scan"] > 0, "replay: veb_scan_fused not launched")
    check(counts["plain"] == 0, "replay: a plain version ran on the card")
    return dict(runs=len(runs), steps=n_steps, counts=counts,
                cpu_s=cpu_s, card_s=card_s)


# --------------------------------------------------------------------------
# phase 5: the serve path at Granite-8B width
# --------------------------------------------------------------------------


def paged_case(gen, rng, device, dtype, lens, scramble: bool = True,
               spare: int = 64, shape=None):
    """Paged decode inputs at Granite width (QH 32, KVH 8, D 128, PS 16)
    or at ``shape`` = (QH, KVH, D, PS): block tables from a random
    permutation of the pages with -1 tails, ``spare`` unreferenced pages
    (scrambled to +-1e3 when asked), K/V and q drawn on the card.  Returns
    (q, k_pages, v_pages, tables, lens)."""
    import numpy as np
    import torch

    from repro_torch.configs.granite_8b import CONFIG

    qh, kvh, d, ps = shape or (CONFIG.num_heads, CONFIG.num_kv_heads,
                               CONFIG.head_dim, 16)
    b = lens.size
    need = -(-lens // ps)
    maxp = max(int(need.max()), 1)
    offs = np.concatenate([[0], np.cumsum(need)])
    n_pages = int(offs[-1]) + spare
    perm = rng.permutation(n_pages).astype(np.int32)
    bt = np.full((b, maxp), -1, np.int32)
    for i in range(b):
        bt[i, :need[i]] = perm[offs[i]:offs[i + 1]]

    def draw(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    kp = draw((n_pages, ps, kvh, d))
    vp = draw((n_pages, ps, kvh, d))
    if scramble:
        unused = torch.as_tensor(perm[offs[-1]:].astype(np.int64),
                                 device=device)
        kp[unused] = 1e3
        vp[unused] = -1e3
    q = draw((b, qh, d))
    return (q, kp, vp, torch.as_tensor(bt, device=device),
            torch.as_tensor(lens.astype(np.int32), device=device))


def paged_err(got, want) -> tuple[float, bool]:
    """Max abs error of the paged kernel against its plain version, and
    whether every element is in tolerance: within ``PA_TOL`` (the float32
    sums' other order); in bfloat16 within ``PA_TOL`` plus one bf16
    rounding step at the element's magnitude (2^(e-7) for |want| in
    [2^e, 2^(e+1))), since both round an f32 result and may land on either
    side of a rounding boundary."""
    import torch

    err = (got.float() - want.float()).abs()
    tol = torch.full_like(err, PA_TOL)
    if got.dtype == torch.bfloat16:
        mag = want.float().abs().clamp(min=2.0 ** -126)
        tol = tol + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(err.max()), bool((err <= tol).all())


def paged_bytes(q, kp, bt, lens) -> int:
    """Bytes paged decode attention must move: every K and V page below
    ceil(seq_len / PS) once, q and the output, tables and lengths."""
    ps, kvh, d = kp.shape[1], kp.shape[2], kp.shape[3]
    pages = int(((lens.long() + ps - 1) // ps).clamp(max=bt.shape[1]).sum())
    elt = kp.element_size()
    return (2 * pages * ps * kvh * d * elt + 2 * q.numel() * elt
            + bt.numel() * 4 + lens.numel() * 4)


def sdpa_paged(q, kp, vp, bt, lens):
    """The library yardstick (never called by the port): gather each
    sequence's pages into a contiguous cache, then one
    ``scaled_dot_product_attention`` with the length mask."""
    import torch
    import torch.nn.functional as F

    b, qh, d = q.shape
    ps, kvh = kp.shape[1], kp.shape[2]
    maxp = bt.shape[1]
    idx = bt.clamp(min=0).long()
    k = kp[idx].reshape(b, maxp * ps, kvh, d).transpose(1, 2)
    v = vp[idx].reshape(b, maxp * ps, kvh, d).transpose(1, 2)
    mask = (torch.arange(maxp * ps, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    out = F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                         attn_mask=mask, enable_gqa=True)
    return out[:, :, 0]


def paged_check_cases(rng, sms: int) -> list:
    """(name, shape or None for Granite, lengths) of the kernel-vs-plain
    check: lengths on the split plan's boundaries at Granite width (0, 1,
    one page, exactly one chunk, one chunk + 1 token, a partial last page
    inside the last chunk, the longest at full MAXP, one drawn), a batch
    short enough that the plan does not split, and the smoke config's
    narrow heads with their own chunk boundaries."""
    import numpy as np

    from repro_torch.kernels.delta_paged_attention import split_plan

    ps = 16
    splits, pps = split_plan(PA_CHECK_B, 8, PA_CHECK_MAX // ps, sms)
    check(splits > 1, f"the check batch does not split ({splits})")
    chunk = pps * ps
    split = np.array([0, 1, ps, chunk, chunk + 1, PA_CHECK_MAX - 7,
                      PA_CHECK_MAX, rng.integers(1, PA_CHECK_MAX + 1)])
    unsplit = np.array([0, 1, ps, ps + 1, 100, 128,
                        *rng.integers(1, 129, 2)])
    check(split_plan(PA_CHECK_B, 8, 128 // ps, sms)[0] == 1,
          "the short batch splits")
    nps = PA_NARROW[3]
    nplan = split_plan(PA_CHECK_B, PA_NARROW[1], 64 // nps, sms)
    nchunk = nplan[1] * nps
    narrow = np.array([0, 1, nps, nchunk, nchunk + 1, 61, 64,
                       rng.integers(1, 65)])
    return [("split", None, split), ("unsplit", None, unsplit),
            ("narrow", PA_NARROW, narrow)]


def compare_paged(rng, device, seed: int) -> dict:
    """Phase 5.1: the paged kernel against its plain version in float32
    and bfloat16 on the split-boundary, unsplit and narrow cases
    (`paged_check_cases`; -1 tails, scrambled unreferenced pages), then
    timed in bfloat16 at the served batch, decode_32k's batch and one
    32 k context beside the plain version, the SDPA yardstick and the
    bytes bound.  Also keeps nvcc's register / shared-memory / spill
    report of the kernel's source."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.delta_paged_attention import (
        paged_decode_attention,
        split_plan,
    )

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    usage = ptxas_report(Path(PA_SOURCE).name)
    for line in ptxas_lines(usage):
        log(f"ptxas: {line}")
    gen = torch.Generator(device=device).manual_seed(seed)
    errs = {}
    for case, shape, lens in paged_check_cases(rng, sms):
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            args = paged_case(gen, rng, device, dtype, lens, shape=shape)
            got = paged_decode_attention(*args)
            want = ref.ref_paged_decode_attention(*args)
            torch.cuda.synchronize()
            err, ok = paged_err(got, want)
            where = f"{case}, {name}"
            check(bool(torch.isfinite(got).all()), f"paged kernel: non-finite "
                                                   f"output ({where})")
            check(bool((got[0] == 0).all()), f"paged kernel: length 0 is not "
                                             f"0 ({where})")
            check(ok, f"paged kernel != plain ({where}): max abs err {err}")
            plan = split_plan(lens.size, args[1].shape[2], args[3].shape[1],
                              sms)
            log(f"paged_decode_attention equals its plain version ({where}, "
                f"plan {plan}): max abs err {err} (tolerance {PA_TOL}"
                f"{' + one bf16 rounding step' if name == 'bfloat16' else ''}"
                f"), largest |out| {float(want.float().abs().max())}, "
                f"lengths {lens.tolist()}")
            errs[f"{case}/{name}"] = err
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    rows = []
    for b, tokens in (PA_SERVED, PA_LONG, PA_ONE_LONG):
        lens = np.full(b, tokens)
        if b == PA_SERVED[0]:    # the served batch: lengths around 1 k
            lens = rng.integers(tokens // 2, 3 * tokens // 2 + 1, b)
        args = paged_case(gen, rng, device, torch.bfloat16, lens,
                          scramble=False)
        got = paged_decode_attention(*args)
        lib = sdpa_paged(*args)
        want = ref.ref_paged_decode_attention(*args)
        torch.cuda.synchronize()
        nbytes = paged_bytes(args[0], args[1], args[3], args[4])
        r = dict(B=b, tokens=int(lens.sum()), max_len=int(lens.max()),
                 dtype="bfloat16",
                 plan=split_plan(b, args[1].shape[2], args[3].shape[1], sms),
                 ms=cuda_ms(lambda: paged_decode_attention(*args), 20, flush),
                 plain_ms=cuda_ms(lambda: ref.ref_paged_decode_attention(
                     *args), 3, flush),
                 library_ms=cuda_ms(lambda: sdpa_paged(*args), 10, flush),
                 bytes=nbytes, bound_ms=bound_ms(nbytes),
                 err=paged_err(got, want)[0],
                 library_err=float((lib.float() - want.float()).abs().max()))
        check(paged_err(got, want)[1], f"paged kernel != plain at B={b}: "
                                       f"{r['err']}")
        log(json.dumps({"table": "paged_decode_attention", **r}))
        rows.append(r)
        del args, got, lib, want
        torch.cuda.empty_cache()
    return dict(rows[0], max_abs_err=max(errs.values()), errs=errs,
                cells=rows, ptxas=usage)


# the instantiations of csrc/paged_attention.cu the Granite serve path runs
# (bf16 and float32 at D = 128, G = 4: 16 and 32 lanes a row), those of
# sub-groups of 5-8 heads (G = 8, 12, 16), and the merge
PAGED_PTXAS = ("13__nv_bfloat16Li16ELi4E", "fLi32ELi4E",
               "13__nv_bfloat16Li16ELi8E", "fLi32ELi8E",
               "paged_decode_merge_kernel")


def ptxas_lines(usage: str, keep=PAGED_PTXAS) -> list:
    """The lines of nvcc's ``-Xptxas -v`` report for the entries whose
    mangled names hold one of ``keep``: each entry's name, then its
    registers, shared memory and spill lines."""
    out, on = [], False
    for line in usage.splitlines():
        if "Compiling entry function" in line:
            on = any(k in line for k in keep)
        if on and ("Compiling entry" in line or "Used" in line
                   or "spill" in line):
            out.append(line.strip())
    return out


# the paged decode attention's two kernels (csrc/paged_attention.cu)
PAGED_KERNELS = ("paged_decode_split_kernel", "paged_decode_merge_kernel")


def device_split(prof, steps: int) -> dict:
    """Device time (ms) a step of a trace over ``steps`` scheduler steps,
    by kind: the paged kernels (the split-K pass and the merge), the matrix
    products, everything else, and their sum (one stream, so the sum is
    the device's busy time)."""
    import torch

    out = {"paged": 0.0, "matmul": 0.0, "other": 0.0}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name
        kind = ("paged" if any(k in name for k in PAGED_KERNELS) else
                "matmul" if any(k in name for k in ("nvjet", "gemm", "splitK",
                                                     "cutlass", "xmma"))
                else "other")
        out[kind] += evt.time_range.elapsed_us() / 1e3 / steps
    out["busy"] = out["paged"] + out["matmul"] + out["other"]
    return out


def trace_steps(model, rng) -> dict:
    """A separate short serve run at full width, so the trace costs the
    measured runs nothing: 8 requests admitted and prefilled, one step to
    warm up, ``TRACED_STEPS`` scheduler steps of 8 live lanes timed without
    the profiler, then ``TRACED_STEPS`` more under ``torch.profiler``.
    Returns the traced steps' device time a step by kind, their host wall
    time a step (``step_ms``, a whole scheduler step: growth, lookups,
    decode, tokens, staged updates), the idle share over that same span,
    and the untraced steps' wall time a step (what the profiler costs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import PagerConfig, ServeEngine

    cfg = model.cfg
    eng = ServeEngine(cfg, model, PagerConfig(engine="lockstep"),
                      max_batch=SERVE_LIVE)
    for n in rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_LIVE):
        eng.submit(rng.integers(1, cfg.vocab_size, int(n)).astype("int32"),
                   max_new=SERVE_NEW)
    eng.step()      # admits and prefills every request, decodes once
    eng.step()

    def steps() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            check(len(eng.step()) == SERVE_LIVE, "trace: a lane finished")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / TRACED_STEPS

    untraced_ms = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_ms = steps()
    del eng
    torch.cuda.empty_cache()
    out = device_split(prof, TRACED_STEPS)
    # not measured when the trace holds no device event
    idle = 1 - out["busy"] / step_ms if out["busy"] > 0 else None
    return dict(out, step_ms=step_ms, untraced_step_ms=untraced_ms,
                idle_share=idle)


def forced_gates(moe, xf, want):
    """Gates of tokens ``xf`` (T, D) for the forced experts ``want`` (T,
    K): their router probabilities, renormalised over the K."""
    import torch

    probs = torch.softmax(xf.float() @ moe.router, dim=-1)
    g = probs.gather(-1, want)
    return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)


class RouteTap:
    """Teacher-forced MoE routing for the bf16 dense comparison.  Served
    decode steps record each layer's chosen experts per lane (`record`);
    the dense decode of a request's step then takes the experts its served
    step took (`force`), with gates from its own router probabilities, and
    counts a flip where its own choice differs.  Routing is discontinuous:
    bf16 rounding that differs between the paged and the dense attention
    moves a near-tied router to another expert, which moves the logits far
    more than the rounding itself; forcing the choice, as the tokens are
    forced, leaves the bf16 rule to judge the rest.  Prefills are not
    touched (both sides prefill each request alone, the same way).  It
    records no-grad serve steps only, so ``remat``'s recompute (autograd
    on) never calls it twice."""

    def __init__(self):
        from repro_torch.models.layers import moe as TM

        self.TM, self.orig = TM, TM.route
        self.served: dict[int, list] = {}   # sid -> steps -> layers -> row
        self.forced = self.flips = 0
        self._rec = self._force = None
        TM.route = self._route

    def _route(self, moe, cfg, xf):
        import torch

        gates, idx = self.orig(moe, cfg, xf)
        if self._rec is not None:
            self._rec.append(idx)
        elif self._force is not None:
            want = self._force.pop(0)[None]
            self.forced += 1
            self.flips += not torch.equal(idx.sort(-1).values,
                                          want.sort(-1).values)
            gates, idx = forced_gates(moe, xf, want), want
        return gates, idx

    def record(self, sids=None) -> None:
        """Start recording a served step (``sids`` None), or file the
        recorded layers under the step's lanes ``sids``."""
        if sids is None:
            self._rec = []
            return
        for lane, sid in enumerate(sids):
            self.served.setdefault(sid, []).append(
                [idx[lane] for idx in self._rec])
        self._rec = None

    def force(self, sid, step) -> None:
        self._force = None if step is None else list(self.served[sid][step])

    def close(self) -> None:
        self.TM.route = self.orig


class Probe:
    """Instruments one serve run from the outside: wraps the scheduler's
    decode (host time to the step's tokens, lanes), the pager's
    block-table lookup (host time, synchronized), the paged kernel (CUDA
    events per launch), the prefill (host time) and the decode step's
    logits (kept per request on the card, for the dense comparison).
    ``check_index`` holds the index's live items against the pager's
    mapping after every applied batch; ``tap`` (a `RouteTap`) records each
    decode step's MoE routing."""

    def __init__(self, eng, check_index: bool, tap=None):
        import torch

        from repro_torch.serve import decode as D

        self.eng, self.D = eng, D
        self.decode_s, self.lookup_s, self.prefill_s = [], [], []
        self.kernel_ms, self.lanes, self.index_checks = [], [], 0
        self.logits: dict[int, list] = {}
        self._events = []
        self._orig = (D.paged_decode_attention, D.paged_decode_step,
                      D.prefill_to_pages)
        kern, step, prefill = self._orig

        def timed_kernel(*a):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = kern(*a)
            e.record()
            self._events.append((s, e))
            return out

        def capture_step(*a, **k):
            out = step(*a, **k)
            self._last_logits = out[0][:, 0]
            return out

        def timed_prefill(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = prefill(*a, **k)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t0)
            return out

        D.paged_decode_attention = timed_kernel
        D.paged_decode_step = capture_step
        D.prefill_to_pages = timed_prefill
        decode = eng._decode

        def timed_decode(sids):
            if tap is not None:
                tap.record()
            t0 = time.perf_counter()
            toks = decode(sids)                 # ends in the tokens' sync
            self.decode_s.append(time.perf_counter() - t0)
            if tap is not None:
                tap.record(sids)
            self.lanes.append(len(sids))
            self.kernel_ms.append(sum(s.elapsed_time(e)
                                      for s, e in self._events))
            self._events.clear()
            for bi, sid in enumerate(sids):
                self.logits.setdefault(sid, []).append(
                    self._last_logits[bi].clone())
            return toks

        eng._decode = timed_decode
        pg = eng.pager
        lookup = pg.block_tables

        def timed_lookup(sids, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lookup(sids, n)
            torch.cuda.synchronize()
            self.lookup_s.append(time.perf_counter() - t0)
            return out

        pg.block_tables = timed_lookup
        if check_index:
            apply = pg.apply_staged

            def checked_apply(*a, **k):
                out = apply(*a, **k)
                self.check_mapping()
                return out

            pg.apply_staged = checked_apply

    def check_mapping(self) -> None:
        """The index's live (key, page) items equal the pager's mapping:
        every allocated block of every sequence, once all staged ops are
        applied."""
        pg = self.eng.pager
        want = sorted(
            (int(k), int(p)) for sid, n in pg.seq_blocks.items()
            for k, p in zip(pg._key(sid, range(n)), pg._staged_pages[sid]))
        check(pg.index.live_items() == want,
              "the pager's index differs from its mapping")
        self.index_checks += 1

    def close(self) -> None:
        D = self.D
        (D.paged_decode_attention, D.paged_decode_step,
         D.prefill_to_pages) = self._orig

    def summary(self) -> dict:
        from repro_torch.api.index import cfg_attr

        return dict(
            decode_steps=len(self.lanes),
            decode_step_ms=statistics.median(self.decode_s) * 1e3,
            lookup_ms=statistics.median(self.lookup_s) * 1e3,
            kernel_ms_per_step=statistics.median(self.kernel_ms),
            prefill_ms=statistics.median(self.prefill_s) * 1e3,
            prefills=len(self.prefill_s),
            mean_lanes=statistics.fmean(self.lanes),
            decode_tokens=sum(self.lanes),
            decode_tok_s=sum(self.lanes) / sum(self.decode_s),
            mean_hops=self.eng.pager.stats["hops"]
            / max(self.eng.pager.stats["searches"], 1),
            walk_rounds=cfg_attr(self.eng.pager.index.cfg,
                                 "walk_round_cap"),
            index_checks=self.index_checks)


def dense_check(model, req, logits, rel_tol: float | None, tap=None):
    """Teacher-forced dense decode of one request (`Transformer.prefill` +
    `decode_step` on a dense cache, fed the request's own tokens, and with
    a ``tap`` each step's served MoE routing): the prefill token must be
    equal; each decode step's logits must be equal in argmax (``rel_tol``
    None: the exact leg) or within ``rel_tol`` of the largest |logit|.
    Returns (steps, argmax matches, max |diff|, max |logit|)."""
    import torch

    out = req.out
    n = len(out)
    dev = model.device
    caches = model.init_caches(1, len(req.prompt) + n)
    lg, caches = model.prefill(torch.as_tensor(req.prompt, device=dev)[None],
                               caches)
    check(int(lg[0, -1].argmax()) == out[0],
          f"request {req.seq_id}: prefill token differs from the dense one")
    check(len(logits) == n - 1, f"request {req.seq_id}: {len(logits)} "
                                f"decode logits for {n - 1} tokens")
    match, diff, mag = 0, 0.0, 0.0
    ln = len(req.prompt)
    for j in range(1, n):
        if tap is not None:
            tap.force(req.seq_id, j - 1)
        lg, caches = model.decode_step(
            torch.tensor([[out[j - 1]]], dtype=torch.int32, device=dev),
            caches, torch.tensor([ln], dtype=torch.int32, device=dev))
        if tap is not None:
            check(not tap._force, f"request {req.seq_id}: forced routing "
                                  f"left unused")
            tap.force(None, None)
        dense = lg[0, 0]
        tok = int(dense.argmax())
        match += tok == out[j]
        diff = max(diff, float((dense - logits[j - 1]).abs().max()))
        mag = max(mag, float(dense.abs().max()))
        if rel_tol is None:
            check(tok == out[j], f"request {req.seq_id}: token {j} is "
                                 f"{out[j]}, the dense decode's {tok}")
        ln += 1
    if rel_tol is not None:
        check(diff <= rel_tol * mag, f"request {req.seq_id}: logits differ "
                                     f"from the dense decode by {diff} "
                                     f"(> {rel_tol} x {mag})")
    return n - 1, match, diff, mag


def release() -> None:
    """Free what a serve leg left on the card: a `Probe`'s hooks on the
    pager close a reference cycle through the engine to its model, which
    only the cyclic collector frees (phase 8's models do not fit the card
    two at a time)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def check_serve_counts(counts: dict, layers: int, steps: int, where: str):
    check(counts["paged"] == layers * steps,
          f"{where}: {counts['paged']} paged launches for {steps} decode "
          f"steps of {layers} layers")
    check(counts["fused"] > 0, f"{where}: the lookups did not launch "
                               f"veb_walk_fused")
    check(counts["plain"] == 0, f"{where}: a plain version ran")


def run_engine(eng, prompts, max_new: int) -> float:
    """Submit ``prompts`` and step until every request is done; returns the
    wall seconds."""
    import torch

    t0 = time.perf_counter()
    sids = [eng.submit(p, max_new=max_new) for p in prompts]
    for _ in range(10_000):
        if all(eng.active[s].done for s in sids):
            break
        eng.step()
    torch.cuda.synchronize()
    check(all(eng.active[s].done for s in sids), "a request never finished")
    return time.perf_counter() - t0


def exact_token_leg(rng, device, seed: int, base=None,
                    layers: int = EXACT_LAYERS) -> dict:
    """Phase 5.2: Granite (or ``base``) at full width in float32, cut to
    ``layers`` layers; ServeEngine (lockstep lookups) on 4 requests must
    give the dense decode's tokens exactly."""
    import dataclasses

    import torch

    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import PagerConfig, ServeEngine

    cfg = dataclasses.replace(base or CONFIG, num_layers=layers,
                              dtype="float32", param_dtype="float32")
    model = Transformer(cfg, device=device, seed=seed)
    eng = ServeEngine(cfg, model, PagerConfig(engine="lockstep"),
                      max_batch=EXACT_REQUESTS)
    probe = Probe(eng, check_index=True)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype("int32")
               for n in rng.integers(*EXACT_PROMPT, EXACT_REQUESTS)]
    reset_counts()
    wall = run_engine(eng, prompts, EXACT_NEW)
    counts = read_counts()
    probe.close()
    check_serve_counts(counts, cfg.num_layers, len(probe.lanes),
                       "float32 leg")
    check(len(eng.pager.free_pages) == eng.pager.cfg.num_pages,
          "float32 leg: pages not reclaimed")
    steps = 0
    for sid, req in eng.active.items():
        n, match, _, _ = dense_check(model, req, probe.logits[sid], None)
        steps += n
    row = dict(config=cfg.name, layers=cfg.num_layers, dtype="float32",
               requests=len(prompts),
               prompt_lens=[len(p) for p in prompts], wall_s=wall,
               dense_steps_equal=steps, counts=counts, **probe.summary())
    del eng, model, probe
    release()
    return row


def weight_read_bytes(model, lanes: int) -> int:
    """Bytes of weights one decode step of ``lanes`` lanes reads: every
    parameter once (every expert's too: the capacity dispatch runs every
    expert's slots), but of the token table only the lanes' rows."""
    tok = model.embed.tok
    every = sum(p.numel() * p.element_size() for p in model.parameters())
    return every - tok.numel() * tok.element_size() \
        + lanes * tok.shape[1] * tok.element_size()


def full_width_serve(rng, device, seed: int, cfg=None,
                     requests: int = SERVE_REQUESTS, new: int = SERVE_NEW,
                     trace: bool = True, churn: bool = True) -> dict:
    """Phase 5.3: the 36-layer bf16 model (or ``cfg``); 16 requests
    (prompts in 128..1024, 32 new tokens each) through ServeEngine with 8
    live lanes, so slots recycle; the index checked against the pager
    after every applied batch; every request's logits held against the
    dense decode.  Then three steps traced and phase 5.4, the churn trace
    on the same weights (``trace`` / ``churn``).  Prints the parameter
    count, the weights a decode step reads over 3.35 TB/s and the peak
    memory allocated."""
    import torch

    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import PagerConfig, ServeEngine

    cfg = cfg or CONFIG
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = Transformer(cfg, device=device, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"{cfg.name} at full width, {cfg.num_layers} layers: "
        f"{model.param_count()} parameters in {cfg.param_dtype}, made on "
        f"the card in {init_s:.2f} s")
    eng = ServeEngine(cfg, model, PagerConfig(engine="lockstep"),
                      max_batch=SERVE_LIVE)
    tap = RouteTap() if cfg.moe_experts else None
    probe = Probe(eng, check_index=True, tap=tap)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype("int32")
               for n in rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                                     requests)]
    reset_counts()
    wall = run_engine(eng, prompts, new)
    counts = read_counts()
    probe.close()
    check_serve_counts(counts, cfg.num_layers, len(probe.lanes),
                       f"{cfg.name} serve")
    pg = eng.pager
    check(len(pg.free_pages) == pg.cfg.num_pages and not pg.seq_blocks,
          "full-width serve: pages not reclaimed")
    steps = match = 0
    diff = mag = rel = 0.0
    for sid, req in eng.active.items():
        n, m, d, g = dense_check(model, req, probe.logits[sid],
                                 LOGIT_REL_TOL_BF16, tap)
        steps, match = steps + n, match + m
        diff, mag, rel = max(diff, d), max(mag, g), max(rel, d / g)
    check(match >= TOKEN_MATCH_MIN_BF16 * steps, f"full-width serve: {match} "
          f"of {steps} decode steps match the dense decode's argmax")
    summary = probe.summary()
    if tap is not None:
        tap.close()
        summary["routing"] = dict(forced=tap.forced, flips=tap.flips)
    wbytes = weight_read_bytes(model, SERVE_LIVE)
    serve = dict(config=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
                 params=model.param_count(), init_s=init_s,
                 requests=requests, max_new=new,
                 live=SERVE_LIVE, wall_s=wall,
                 tok_s=(summary["decode_tokens"] + requests) / wall,
                 weight_read_bytes=wbytes,
                 weight_read_bound_ms=bound_ms(wbytes),
                 hbm_bytes_per_s=HBM_BYTES_PER_S,
                 token_match=match / steps, dense_steps=steps,
                 max_logit_diff=diff, max_logit=mag, max_logit_rel=rel,
                 counts=counts,
                 pager=dict(pg.stats), obs=eng.obs.asdict(), **summary)
    del eng, probe
    torch.cuda.empty_cache()
    if trace:
        serve["device_ms"] = trace_steps(model, rng)
    out = dict(serve=serve)
    if churn:
        out["churn"] = churn_trace(model, rng, seed)
    serve["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    log(json.dumps({"serve_full_width": serve}))
    del model
    release()
    return out


def churn_trace(model, rng, seed: int) -> dict:
    """Phase 5.4: the synthesized churn trace (arrivals in bursts, cancels,
    zipf probes) at full width under deferred maintenance with the worker's
    high-water mark; one scan of the live sequences mid-trace, checked
    against their block tables; every finished request's logits held
    against the dense decode."""
    import numpy as np
    import torch

    from repro_torch.serve import SchedulerConfig, ServeScheduler, synth_trace
    from repro_torch.serving import PagerConfig

    cfg = model.cfg
    pc = PagerConfig(engine="lockstep", maintenance="deferred",
                     maint_high_water=CHURN_HIGH_WATER)
    sch = ServeScheduler(cfg, model, pc, SchedulerConfig())
    tap = RouteTap() if cfg.moe_experts else None
    probe = Probe(sch, check_index=False, tap=tap)
    plans = synth_trace(CHURN_STEPS, seed, arrive_p=0.6, burst=2,
                        prompt_lens=(16, 512), max_new=(8, 32),
                        cancel_p=0.25, probes_per_step=32,
                        vocab=cfg.vocab_size)
    reset_counts()
    t0 = time.perf_counter()
    sch.run_trace(plans[:CHURN_SPLIT], drain=False)
    live = [r.seq_id for _, r in sch.queue.live()]
    check(live, "churn: no live sequence to scan")
    pages = sch.scan(live)
    maxb = max(int(pg.size) for pg in pages.values()) + 1
    table = sch.pager.block_tables(live, maxb).cpu().numpy()
    for i, sid in enumerate(live):
        row = table[i]
        want = row[: int((row >= 0).sum())]
        check(np.array_equal(pages[sid], want) and (row[want.size:] < 0).all(),
              f"churn: scan of sequence {sid} differs from its block table")
    summary = sch.run_trace(plans[CHURN_SPLIT:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    probe.close()
    check_serve_counts(counts, cfg.num_layers, len(probe.lanes), "churn")
    ws = sch.worker.stats()
    check(ws["drains"] > 0, "churn: the worker never drained")
    check(sch.pager.stats["inline_maint"] == 0,
          "churn: the decode path ran structural maintenance")
    check(len(sch.pager.free_pages) == pc.num_pages,
          "churn: pages not reclaimed")
    check(sch.pager.pending == 0, "churn: maintenance left pending")
    steps = match = finished = 0
    diff = rel = 0.0
    for sid, req in sch.active.items():
        if not req.done:
            continue
        finished += 1
        n, m, d, g = dense_check(model, req, probe.logits.get(sid, []),
                                 LOGIT_REL_TOL_BF16, tap)
        steps, match, diff = steps + n, match + m, max(diff, d)
        rel = max(rel, d / g) if g else rel
    if tap is not None:
        tap.close()
    check(finished > 0, "churn: no request finished")
    check(match >= TOKEN_MATCH_MIN_BF16 * steps, f"churn: {match} of "
          f"{steps} decode steps match the dense decode's argmax")
    row = dict(summary, wall_s=wall, finished_checked=finished,
               token_match=match / max(steps, 1), max_logit_diff=diff,
               max_logit_rel=rel,
               scanned=len(live), worker=ws, counts=counts,
               pager=dict(sch.pager.stats), obs=sch.obs.asdict(),
               scan_obs=sch.scan_obs.asdict(), **probe.summary())
    if tap is not None:
        row["routing"] = dict(forced=tap.forced, flips=tap.flips)
    log(json.dumps({"churn": row}))
    del sch, probe
    torch.cuda.empty_cache()
    return row


def serve_phase(seed: int, device) -> dict:
    """Phase 5, in order: kernel vs plain and timings, the float32
    exact-token leg, the full-width serve and the churn trace."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 5)
    t0 = time.perf_counter()
    kern = compare_paged(rng, device, seed)
    log(f"phase 5.1 done at {time.perf_counter() - t0:.1f} s")
    exact = exact_token_leg(rng, device, seed)
    log(json.dumps({"serve_float32_exact": exact}))
    log(f"phase 5.2 done at {time.perf_counter() - t0:.1f} s")
    full = full_width_serve(rng, device, seed)
    log(f"phase 5.3-5.4 done at {time.perf_counter() - t0:.1f} s")
    return dict(kernel=kern, exact=exact, **full)


# --------------------------------------------------------------------------
# phase 6: the DeltaForest at benchmarks/forest_scale.py --full size
# --------------------------------------------------------------------------

FOREST_KEY_MAX = 2_000_000      # benchmarks/forest_scale.py KEY_MAX
FOREST_INITIAL = 500_000        # --full initial_size (draws; ~442 k unique)
FOREST_TOTAL_OPS = 100_000      # --full total_ops; sizes the arenas
FOREST_UPDATE_PCT = 5.0
FOREST_SHARDS = (1, 2, 4, 8)
FOREST_BATCHES = (256, 1024, 4096)
FOREST_WARMUP = 2               # run_index's warm-up steps, off the clock
FOREST_EXACT = ((1, 0), (4, 0), (8, 0), (4, 12))   # 6.1: (S, payload bits)
FOREST_CHECK_K = 1021           # 6.1 read batch: no multiple of 4 or 64
FOREST_SCAN_K = 509             # 6.1 scan bands, likewise
FOREST_CHECK_STEPS = 3          # 6.1 update batches (50 % updates)
FOREST_WALK_K = 1024            # 6.3: kernel 2's batch
FOREST_SCAN_LANES = 512         # 6.3: kernel 3's bands (x S tiled lanes)
SHARDED_SHARDS = 4              # 6.4: ShardedPagerConfig(num_shards=4)


def forest_config(n_keys: int, shards: int) -> dict:
    """benchmarks/common.py::backend_kwargs("forest", ...)."""
    n_eff = n_keys + FOREST_TOTAL_OPS // 2
    height = 7
    return dict(num_shards=shards, key_max=FOREST_KEY_MAX, height=height,
                buf_cap=32, max_rounds=256,
                max_dnodes=max(64, int(8 * n_eff / shards
                                       / 2 ** (height - 1))))


def forest_traffic(seed: int, batch: int, initial,
                   ops: int = FOREST_TOTAL_OPS) -> dict:
    """benchmarks/common.py::run_index's stream for one batch size (its rng
    seeded with ``seed``; 2 warm-up steps, then ops // batch), with the set
    oracle's answers: each step's search on the pre-step set, then its
    update rows in batch order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    live = set(initial.tolist())
    steps = []
    for _ in range(FOREST_WARMUP + max(ops // batch, 1)):
        kinds = mixed_kinds(rng, batch, FOREST_UPDATE_PCT)
        keys = rng.integers(1, FOREST_KEY_MAX, size=batch).astype(np.int32)
        found = np.fromiter((k in live for k in keys.tolist()), bool, batch)
        res = np.zeros(batch, bool)
        for i in np.flatnonzero(kinds):
            k = int(keys[i])
            if kinds[i] == 1:
                res[i] = k not in live
                live.add(k)
            else:
                res[i] = k in live
                live.discard(k)
        steps.append((kinds, keys, found, res))
    return dict(steps=steps, live=np.asarray(sorted(live), np.int64))


def copy_index(ix, **cfg_kw):
    """A second Index over a copy of ``ix``'s state on the card (one
    device copy instead of another host build); ``cfg_kw`` replaces
    ForestConfig fields, ``maintenance=`` the per-shard policy."""
    import dataclasses

    from repro_torch.api import Index, IndexSpec

    st = ix.state
    cfg = ix.cfg
    policy = cfg_kw.pop("maintenance", None)
    if policy is not None:
        cfg = dataclasses.replace(cfg, tree=dataclasses.replace(
            cfg.tree, maintenance=policy))
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    if hasattr(st, "trees"):
        st = st._replace(trees=type(st.trees)(*(x.clone() for x in st.trees)),
                         reads=st.reads.clone(), updates=st.updates.clone(),
                         epoch=0)
    else:
        st = type(st)(*(x.clone() for x in st))
    return Index(IndexSpec(backend=ix.spec.backend, cfg=cfg), st)


def boundary_keys(ix, live):
    """Keys at every shard boundary (split - 1, split, split + 1), the
    live extremes, keys above the last live key (the cross-shard
    successor falls through to nothing) and below the domain."""
    import numpy as np

    sp = ix.state.splits.cpu().numpy().astype(np.int64)
    top = int(live[-1])
    ks = np.concatenate([sp - 1, sp, sp + 1,
                         [0, 1, int(live[0]), top, top + 1, top + 500,
                          FOREST_KEY_MAX + 5]])
    return ks.astype(np.int32)


def same_cols(a, b, where: str) -> None:
    """Two read results equal bit for bit, dtypes included."""
    import torch

    for i, (x, y) in enumerate(zip(a, b)):
        check(x.dtype == y.dtype and torch.equal(x, y),
              f"{where}: column {i} differs between the dispatches")


def forest_reads_agree(ixf, ixd, live, pays, q, rng, where: str) -> dict:
    """6.1: one read batch three ways — the fused frontier, the dense
    per-shard dispatch and the oracle: lookup / search (found, payload,
    hops), successor, scans (sparse and dense bands, max_out 128) and
    successor_k.  The fused reads run alone between a counter reset and a
    read, then the dense reads the same way; returns the fused reads'
    counts (walk and scan launched, no plain version)."""
    bands = forest_bands(rng, live)
    reset_counts()
    got = forest_read_batch(ixf, q, bands)
    counts = read_counts()
    check(counts["fused"] > 0 and counts["scan"] > 0
          and counts["plain"] == 0, f"{where}: fused reads' launches {counts}")
    reset_counts()
    dense = forest_read_batch(ixd, q, bands)
    dcounts = read_counts()
    check(dcounts["plain"] == 0, f"{where}: dense reads ran a plain version")
    for name, a, b in zip(FOREST_READS, got, dense):
        same_cols(a, b, f"{where}: {name}")
    oracle_reads(got, live, pays, q, bands, ixf.cfg.tree.payload_bits, where)
    return counts


FOREST_READS = ("search", "successor", *(f"{d} scan" for d in DENSITY_FILL),
                "successor_k")


def forest_bands(rng, live) -> list:
    """6.1's scan bands: ``FOREST_SCAN_K`` sparse, then dense, bands."""
    return [scan_bands(rng, live.size, FOREST_SCAN_K, density, 128,
                       FOREST_KEY_MAX) for density in DENSITY_FILL]


def forest_read_batch(ix, q, bands) -> list:
    """6.1's reads of one batch, in ``FOREST_READS`` order: lookup (map
    mode) or search, successor, the bands' scans at ``max_out`` 128 and
    ``successor_k(16)`` of the first ``FOREST_SCAN_K`` keys."""
    return [ix.lookup(q) if ix.cfg.tree.payload_bits else ix.search(q),
            ix.successor(q),
            *(ix.spec.backend.scan(ix.cfg, ix.state, st, hi, 128)
              for st, hi in bands),
            ix.successor_k(q[:FOREST_SCAN_K], 16)]


def forest_query_batch(rng, ix, live):
    """6.1's read keys: ``FOREST_CHECK_K`` of them, the shard boundaries
    (`boundary_keys`) first, then half drawn from the live keys, the rest
    uniform over the domain and above it."""
    import numpy as np

    q = rng.integers(0, FOREST_KEY_MAX + 1000,
                     FOREST_CHECK_K).astype(np.int32)
    b = boundary_keys(ix, live)
    q[:b.size] = b
    q[b.size: b.size + FOREST_CHECK_K // 2] = rng.choice(
        live, FOREST_CHECK_K // 2)
    return q


def oracle_update(oracle: dict, kinds, keys, pays, bits: int):
    """Apply an update batch to the dict oracle in batch order; returns
    the expected per-row results."""
    import numpy as np

    want = np.zeros(keys.size, bool)
    for i in np.flatnonzero(kinds):
        k = int(keys[i])
        want[i] = (k not in oracle) if kinds[i] == 1 else (k in oracle)
        if kinds[i] == 1 and want[i]:
            oracle[k] = int(pays[i]) if bits else 0
        elif kinds[i] == 2:
            oracle.pop(k, None)
    return want


def oracle_reads(got, live, pays, q, bands, bits: int, where: str) -> None:
    """6.1's read results (`forest_reads_agree`'s order) against the
    sorted live keys and their payloads."""
    import numpy as np

    from repro_torch.core.layout import KEY_MAX as DOMAIN_MAX

    found = got[0]
    idx = np.searchsorted(live, q)
    hit = (idx < live.size) & (live[np.minimum(idx, live.size - 1)] == q)
    check((found[0].cpu().numpy() == hit).all(),
          f"{where}: search differs from the oracle")
    if bits:
        check((found[1].cpu().numpy()[hit] == pays[idx[hit]]).all(),
              f"{where}: payloads differ from the oracle")
    sf, sk = got[1]
    idx = np.searchsorted(live, q, side="right")
    want_f = idx < live.size
    want_k = np.where(want_f, live[np.minimum(idx, live.size - 1)], 0)
    check((sf.cpu().numpy() == want_f).all()
          and (sk.cpu().numpy() == want_k).all(),
          f"{where}: successor differs from the oracle")
    for density, (st, hi), res in zip(DENSITY_FILL, bands, got[2:-1]):
        check_scan(res, live, st, hi, 128, f"{where}, {density} scan")
    check_scan(got[-1], live, q[:FOREST_SCAN_K],
               np.full(FOREST_SCAN_K, DOMAIN_MAX), 16, f"{where}, succ_k")


def forest_exact(ix0, rng, where: str) -> dict:
    """6.1 on one forest: reads three ways on the built forest, after each
    of ``FOREST_CHECK_STEPS`` update batches (both dispatches' arenas
    equal after each), and under ``deferred`` after a batch of clustered
    inserts that leaves items buffered in several shards (then flush);
    every shard's alloc_fail and the final live set.  The fused reads'
    launches are counted in windows of their own (forest_reads_agree);
    the updates and the flush in theirs, where no plain version may run."""
    import collections

    import numpy as np
    import torch

    from repro_torch.api import OpBatch

    ixf, ixd = copy_index(ix0), copy_index(ix0, fused=False)
    bits = ix0.cfg.tree.payload_bits
    items = ix0.live_items()
    live = np.asarray([k for k, _ in items], np.int64)
    pays = np.asarray([p for _, p in items], np.int64)
    oracle = dict(items)

    def batch():
        return forest_query_batch(rng, ixf, live)

    def no_plain(what: str) -> None:
        c = read_counts()
        check(c["plain"] == 0, f"{where}: {what} ran a plain version {c}")

    fused = collections.Counter(forest_reads_agree(
        ixf, ixd, live, pays, batch(), rng, f"{where}, built"))
    for step in range(FOREST_CHECK_STEPS):
        kinds = mixed_kinds(rng, FOREST_CHECK_K, 50)
        keys = rng.integers(1, FOREST_KEY_MAX, FOREST_CHECK_K).astype(np.int32)
        keys[:64] = rng.choice(live, 64)
        pp = (keys % 4096).astype(np.int32)
        want = oracle_update(oracle, kinds, keys, pp, bits)
        reset_counts()
        ixf, res, st = ixf.update(OpBatch.mixed(kinds, keys, pp))
        ixd, resd, std = ixd.update(OpBatch.mixed(kinds, keys, pp))
        no_plain(f"update {step}")
        check((res.cpu().numpy() == want).all() and torch.equal(res, resd)
              and st == std, f"{where}: update results differ at {step}")
        check(all(torch.equal(a, b) for a, b in zip(ixf.state.trees,
                                                    ixd.state.trees)),
              f"{where}: the dispatches' arenas differ after step {step}")
        live = np.asarray(sorted(oracle), np.int64)
        pays = np.asarray([oracle[k] for k in live.tolist()], np.int64)
        fused.update(forest_reads_agree(ixf, ixd, live, pays, batch(), rng,
                                        f"{where}, step {step}"))
    check(not bool(ixf.state.trees.alloc_fail.any()),
          f"{where}: a shard's arena allocation failed")
    check(ixf.live_items() == sorted(oracle.items()),
          f"{where}: live items differ from the oracle")
    # deferred: clustered inserts fill overflow buffers in several shards
    qf = copy_index(ixf, maintenance="deferred")
    qd = copy_index(ixf, maintenance="deferred", fused=False)
    runs = (rng.choice(live, FOREST_CHECK_K // 8)[:, None]
            + np.arange(1, 9)).reshape(-1).astype(np.int32)
    ones = np.ones(runs.size, np.int32)
    pr = (runs % 4096).astype(np.int32)
    reset_counts()
    qf, res, st = qf.update(OpBatch.mixed(ones, runs, pr))
    qd, resd, _ = qd.update(OpBatch.mixed(ones, runs, pr))
    no_plain("the deferred update")
    for k, p, ok in zip(runs.tolist(), pr.tolist(), res.cpu().tolist()):
        check(ok == (k not in oracle), f"{where}: deferred insert result")
        oracle.setdefault(k, p if bits else 0)
    buffered = int((qf.state.trees.bcount.sum(1) > 0).sum())
    check(st.pending > 0 and buffered >= min(2, ix0.cfg.num_shards),
          f"{where}: the deferred batch left {st.pending} items buffered "
          f"in {buffered} shards")
    live = np.asarray(sorted(oracle), np.int64)
    pays = np.asarray([oracle[k] for k in live.tolist()], np.int64)
    fused.update(forest_reads_agree(qf, qd, live, pays, batch(), rng,
                                    f"{where}, deferred"))
    reset_counts()
    qf, fst = qf.flush()
    no_plain("the flush")
    check(fst.pending == 0 and qf.live_items() == sorted(oracle.items())
          and not bool(qf.state.trees.alloc_fail.any()),
          f"{where}: deferred flush")
    return dict(where=where, shards=ix0.cfg.num_shards, payload_bits=bits,
                pending=st.pending, buffered_shards=buffered,
                size=qf.size(), fused_read_counts=dict(fused))


def forest_run(ix, traffic, label: str) -> dict:
    """6.2: one point of the grid — run_index's loop through the Index
    API (search the whole batch, then insert_delete the whole batch with
    its search rows as no-ops), each step checked against the oracle.
    Host-clocked, each call ending in a synchronize; the checks are off
    the clock.  Counters set to 0 before the run and read after; walk
    launches are also counted in the search calls alone."""
    import numpy as np
    import torch

    from repro_torch.api import OpBatch
    from repro_torch.core import deltatree as DT
    from repro_torch.distributed import forest as TF
    from repro_torch.kernels import veb_search as VS

    v0 = TF.fused_view_cache_stats()
    reset_counts()
    search_s, update_s, walks = [], [], []
    for i, (kinds, keys, want_found, want_res) in enumerate(traffic["steps"]):
        n0 = VS.veb_walk_fused.launches
        t0 = time.perf_counter()
        found, _ = ix.search(keys)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n1 = VS.veb_walk_fused.launches
        ix, res = ix.insert_delete(OpBatch.mixed(kinds, keys))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check((found.cpu().numpy() == want_found).all(),
              f"{label}: search differs from the oracle at step {i}")
        check((res.cpu().numpy() == want_res).all(),
              f"{label}: update results differ from the oracle at step {i}")
        if i >= FOREST_WARMUP:
            search_s.append(t1 - t0)
            update_s.append(t2 - t1)
            walks.append(n1 - n0)
    counts = read_counts()
    v1 = TF.fused_view_cache_stats()
    check(counts["fused"] > 0 and counts["plain"] == 0,
          f"{label}: {counts} (the walk kernel must run, no plain version)")
    ops = len(search_s) * len(traffic["steps"][0][0])
    check(not ix.alloc_failed(), f"{label}: arena allocation failed")
    live = (TF.live_keys(ix.cfg, ix.state) if ix.backend == "forest" else
            DT.live_keys(ix.cfg, ix.state))
    check(np.array_equal(live, traffic["live"]),
          f"{label}: live keys differ from the oracle")
    return dict(ops_per_s=ops / (sum(search_s) + sum(update_s)),
                search_ms=statistics.median(search_s) * 1e3,
                update_ms=statistics.median(update_s) * 1e3,
                walk_launches_per_search=statistics.fmean(walks),
                view_builds=v1["builds"] - v0["builds"],
                view_hits=v1["hits"] - v0["hits"], steps=len(search_s),
                counts=counts)


def forest_kernels(ix, rng, flush) -> dict:
    """6.3: kernels 2 and 3 on one forest's fused view, as the fused path
    launches them: kernel 2 on a batch of ``FOREST_WALK_K`` keys in batch
    order (each lane seeded at its shard's root), kernel 3 on
    ``FOREST_SCAN_LANES`` dense bands tiled shard-major (lane s*k + i).
    Each against its plain version (exact), timed (CUDA events, L2
    flushed), beside its byte bound and the share of lanes whose root is
    the one their block staged."""
    import torch

    from repro_torch.core import engine as E
    from repro_torch.distributed import router as R
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS
    from repro_torch.kernels.ops import scan_round_cap

    cfg = ix.cfg.tree
    s = ix.cfg.num_shards
    dev = ix.state.splits.device
    view, roots = E._fused_trees_view(cfg, ix.state.trees)
    h, cap = cfg.height, cfg.walk_round_cap
    keys = torch.as_tensor(rng.integers(1, FOREST_KEY_MAX, FOREST_WALK_K),
                           dtype=torch.int32, device=dev)
    q = E._walk_queries(cfg, keys).contiguous()
    r = roots[R.shard_ids(ix.state.splits, keys).long()].contiguous()

    def walk():
        return VS.veb_walk_fused(view.value, view.child, r, q, height=h,
                                 max_rounds=cap)

    def walk_plain():
        return ref.ref_delta_walk_fused(view.value, view.child, r, q,
                                        height=h, max_rounds=cap)

    got, want = walk(), walk_plain()
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in zip(got, want))
    check(err == 0, f"veb_walk_fused != plain on the fused view, S={s}")
    wb, _ = fused_needs(view, h, q, r, cap)
    lane = torch.arange(FOREST_WALK_K, device=dev)
    block = VS.DEFAULT_BLOCK
    walk_row = dict(ms=cuda_ms(walk, 20, flush),
                    plain_ms=cuda_ms(walk_plain, 3, flush), bytes=wb,
                    bound_ms=bound_ms(wb), err=err,
                    staged_root_share=float(
                        (r == r[lane // block * block]).float().mean()),
                    mean_hops=float(got[3].float().mean()))
    n_keys = int(ix.size())
    st, hi = scan_bands(rng, n_keys, FOREST_SCAN_LANES, "dense", 128,
                        FOREST_KEY_MAX)
    sp, hp = pack_bands(cfg, st, hi, dev)
    sp, hp = sp.repeat(s).contiguous(), hp.repeat(s).contiguous()
    lid = torch.arange(s, device=dev).repeat_interleave(FOREST_SCAN_LANES)
    sr = roots[lid].contiguous()
    scap = scan_round_cap(h, view.value.shape[0], 128)
    args = (view.value, view.mark, view.child, sr, sp, hp)
    kw = dict(height=h, max_out=128, pmask=cfg.pmask, max_rounds=scap)
    got = VS.veb_scan_fused(*args, **kw)
    want = ref.ref_delta_scan_fused(*args, **kw)
    serr = max(int((a.long() - b.long()).abs().max())
               for a, b in zip(got, want))
    check(serr == 0, f"veb_scan_fused != plain on the fused view, S={s}")
    sb, n_replay = scan_needs(view, h, sr, sp, hp, 128, cfg.pmask, scap)
    check(torch.equal(n_replay, got[1]), "scan byte replay diverged")
    tl = torch.arange(sr.numel(), device=dev)
    scan_row = dict(ms=cuda_ms(lambda: VS.veb_scan_fused(*args, **kw), 10,
                               flush),
                    plain_ms=None, bytes=sb, bound_ms=bound_ms(sb), err=serr,
                    lanes=int(sr.numel()),
                    staged_root_share=float(
                        (sr == sr[tl // 4 * 4]).float().mean()),
                    emitted=int(got[1].sum()))
    return dict(shards=s, walk=walk_row, scan=scan_row)


def sharded_serve_leg(rng, device, seed: int) -> dict:
    """6.4: phase 5.2's float32 exact-token leg (Granite at full width, 4
    layers) served twice from the same weights and prompts, over the
    single-tree pager and over ``ShardedPagerConfig(num_shards=4)``: the
    sharded run's tokens must equal the dense decode's, its block tables
    the single-tree pager's at every step, and the fused view must be
    reused (view_hits > 0).  Counters set to 0 before the sharded run."""
    import dataclasses

    import torch

    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import (
        PagerConfig, ServeEngine, ShardedDeltaPager, ShardedPagerConfig,
    )

    cfg = dataclasses.replace(CONFIG, num_layers=EXACT_LAYERS,
                              dtype="float32", param_dtype="float32")
    model = Transformer(cfg, device=device, seed=seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype("int32")
               for n in rng.integers(*EXACT_PROMPT, EXACT_REQUESTS)]
    runs = {}
    for name, pc in (("tree", PagerConfig(engine="lockstep")),
                     ("forest", ShardedPagerConfig(num_shards=SHARDED_SHARDS,
                                                   engine="lockstep"))):
        eng = ServeEngine(cfg, model, pc, max_batch=EXACT_REQUESTS)
        probe = Probe(eng, check_index=True)
        tables = []
        lookup = eng.pager.block_tables

        def recorded(sids, n, lookup=lookup, tables=tables):
            out = lookup(sids, n)
            tables.append(out.cpu())
            return out

        eng.pager.block_tables = recorded
        reset_counts()
        wall = run_engine(eng, prompts, EXACT_NEW)
        counts = read_counts()
        probe.close()
        check_serve_counts(counts, cfg.num_layers, len(probe.lanes),
                           f"{name} pager")
        runs[name] = dict(eng=eng, probe=probe, tables=tables, wall=wall,
                          counts=counts)
    tree, forest = runs["tree"], runs["forest"]
    eng = forest["eng"]
    check(isinstance(eng.pager, ShardedDeltaPager)
          and eng.pager.index.capability.fused_forest,
          "sharded leg: the pager is not a fused forest")
    check(len(tree["tables"]) == len(forest["tables"])
          and all(torch.equal(a, b) for a, b in zip(tree["tables"],
                                                    forest["tables"])),
          "sharded leg: block tables differ from the single-tree pager's")
    steps = 0
    for sid, req in eng.active.items():
        check(req.out == tree["eng"].active[sid].out,
              f"sharded leg: request {sid}'s tokens differ")
        n, _, _, _ = dense_check(model, req, forest["probe"].logits[sid],
                                 None)
        steps += n
    obs = eng.obs.asdict()
    check(obs["view_hits"] > 0, "sharded leg: the fused view was never reused")
    check(len(eng.pager.free_pages) == eng.pager.cfg.num_pages,
          "sharded leg: pages not reclaimed")
    row = dict(layers=cfg.num_layers, shards=SHARDED_SHARDS,
               requests=len(prompts), steps_compared=len(forest["tables"]),
               dense_steps_equal=steps, wall_s=forest["wall"],
               tree_wall_s=tree["wall"], counts=forest["counts"],
               view_hits=obs["view_hits"], view_builds=obs["view_builds"],
               forest_lookup_ms=forest["probe"].summary()["lookup_ms"],
               tree_lookup_ms=tree["probe"].summary()["lookup_ms"],
               mean_hops=forest["probe"].summary()["mean_hops"])
    del runs, tree, forest, eng, model
    torch.cuda.empty_cache()
    return row


def forest_phase(seed: int, device) -> dict:
    """Phase 6, in order: 6.1 exactness at S = 1, 4, 8 (set) and S = 4
    (map); 6.2 the timed grid S x batch under both dispatches, beside the
    deltatree baseline; 6.3 kernels 2 and 3 on the fused views of S = 1
    and S = 8; 6.4 the sharded pager serve leg."""
    import numpy as np
    import torch

    from repro_torch.api import make_index
    from repro_torch.distributed import forest as TF

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 6)
    keys = np.unique(rng.integers(1, FOREST_KEY_MAX, FOREST_INITIAL)
                     .astype(np.int32))
    n = int(keys.size)
    log(f"forest: {n} keys, per shard {forest_config(n, 1)} at S = 1")
    TF.reset_fused_view_cache()
    traffic = {b: forest_traffic(seed, b, keys) for b in FOREST_BATCHES}
    exact, grid, built, kern = [], [], {}, []
    launches = dict(fused=0, scan=0)
    base = make_index("deltatree", initial=keys, engine="lockstep",
                      device=device, **fig12_config(n, FOREST_TOTAL_OPS))
    base_rows = {}
    for b in FOREST_BATCHES:
        base_rows[b] = forest_run(copy_index(base), traffic[b],
                                  f"deltatree, batch {b}")
        log(json.dumps({"forest_grid": dict(backend="deltatree", batch=b,
                                            **base_rows[b])}))
    del base
    for s in FOREST_SHARDS:
        tb = time.perf_counter()
        ix0 = make_index("forest", initial=keys, engine="lockstep",
                         device=device, **forest_config(n, s))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - tb
        arena = sum(x.numel() * x.element_size() for x in ix0.state.trees)
        log(f"forest S={s}: built in {build_s:.2f} s, {arena / 1e6:.1f} MB "
            f"of arena, splits {ix0.state.splits.tolist()}")
        if (s, 0) in FOREST_EXACT:
            exact.append(forest_exact(ix0, rng, f"S={s} set"))
            log(json.dumps({"forest_exact": exact[-1]}))
            launches["scan"] += exact[-1]["fused_read_counts"]["scan"]
        for b in FOREST_BATCHES:
            rows = {}
            for dispatch in ("fused", "dense"):
                ix = copy_index(ix0, fused=dispatch == "fused")
                rows[dispatch] = forest_run(ix, traffic[b],
                                            f"S={s} {dispatch}, batch {b}")
                del ix
            launches["fused"] += rows["fused"]["counts"]["fused"]
            f, d = rows["fused"], rows["dense"]
            check(f["walk_launches_per_search"] == 1
                  and d["walk_launches_per_search"] == s,
                  f"S={s}, batch {b}: walk launches a search batch "
                  f"{f['walk_launches_per_search']} fused, "
                  f"{d['walk_launches_per_search']} dense")
            point = dict(shards=s, batch=b, arena_mb=arena / 1e6,
                         build_s=build_s,
                         baseline_ops_per_s=base_rows[b]["ops_per_s"],
                         speedup=f["ops_per_s"] / base_rows[b]["ops_per_s"],
                         speedup_vs_vmap=f["ops_per_s"] / d["ops_per_s"],
                         fused=f, dense=d)
            grid.append(point)
            log(json.dumps({"forest_grid": point}))
        if s in (1, 8):
            built[s] = ix0
        else:
            del ix0
        torch.cuda.empty_cache()
    log(f"phase 6.1-6.2 done at {time.perf_counter() - t0:.1f} s")
    ixm = make_index("forest", initial=keys, payloads=keys % 4096,
                     engine="lockstep", device=device, payload_bits=12,
                     **forest_config(n, 4))
    exact.append(forest_exact(ixm, rng, "S=4 map"))
    launches["scan"] += exact[-1]["fused_read_counts"]["scan"]
    log(json.dumps({"forest_exact": exact[-1]}))
    del ixm
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    for s in (1, 8):
        kern.append(forest_kernels(built[s], rng, flush))
        log(json.dumps({"forest_kernels": kern[-1]}))
    del flush, built
    torch.cuda.empty_cache()
    log(f"phase 6.3 done at {time.perf_counter() - t0:.1f} s")
    serve = sharded_serve_leg(rng, device, seed)
    log(json.dumps({"sharded_serve": serve}))
    elapsed = time.perf_counter() - t0
    log(f"phase 6 done in {elapsed:.1f} s")
    return dict(exact=exact, grid=grid, kernels=kern, serve=serve,
                launches=dict(launches, paged=serve["counts"]["paged"]),
                elapsed_s=elapsed)


# --------------------------------------------------------------------------
# phase 7: the paper's comparison structures and the read-path accounting
# --------------------------------------------------------------------------

TABLE1_INITIAL = 1 << 20        # benchmarks/table1_transfers.py INITIAL
TABLE1_QUERIES = 500            # table1_transfers.py --full n_queries
TABLE1_DT = dict(height=7, max_dnodes=1 << 17, buf_cap=16)  # its deltatree
TABLE1_ROWS = ("deltatree", "static_veb", "pointer_bst", "sorted_array")
FIG12_RATES = (0, 10)           # fig12_big_tree.py --quick update rates
FIG12_WARMUP = 2                # run_index's warm-up steps, off the clock
UPDATE_CHUNK = 64               # benchmarks/common.py: baselines' update
#                                 rows a step (a fixed-width OpBatch)
IDLE_STEPS = 3                  # Fig. 12 steps traced for the idle share
STATS_K = 1021                  # 7.4 forest read batch: no multiple of 4


def table1_row(label: str, ix, q) -> dict:
    """benchmarks/table1_transfers.py's row: the mean elements a search
    touches (``loads``) and distinct 16- / 128-element blocks, from the
    backend's host touch trace."""
    import numpy as np

    from repro_torch.core.baselines import count_block_transfers

    t0 = time.perf_counter()
    tf = ix.touch_fn()
    check(tf is not None, f"table 1: {label} has no touch trace")
    row = dict(backend=label,
               loads=float(np.mean([len(tf(int(k))) for k in q])),
               blocks_b16=count_block_transfers(tf, q, 16),
               blocks_b128=count_block_transfers(tf, q, 128))
    row["model_s"] = time.perf_counter() - t0
    return row


def same_stats(a, b, where: str) -> None:
    """Two stats tuples (nested ReadStats included) equal field for field."""
    import torch

    check(type(a) is type(b), f"{where}: {type(a)} vs {type(b)}")
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            check(x is None and y is None, f"{where}.{name}: one is None")
        elif hasattr(x, "_fields"):
            same_stats(x, y, f"{where}.{name}")
        else:
            check(x.dtype == y.dtype and torch.equal(x, y),
                  f"{where}.{name}: {x.tolist()} vs {y.tolist()}")


def deltatree_transfers(ix, q) -> dict:
    """7.1 on the ``deltatree`` row: ``compare_model`` replays on the card
    (ratio 1.0 exactly at every B), and a ``collect_stats`` +
    ``collect_transfers`` search through kernel 2 gives the found / hops
    of a plain read of the same batch and the TransferStats of
    ``measure``.  Returns the ratios and the stats read's counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import deltatree as DT
    from repro_torch.obs import transfers as OTR

    cm = OTR.compare_model(ix.cfg, ix.state, q)
    check(all(v["ratio"] == 1.0 for v in cm.values()),
          f"table 1: measured / model transfers {cm}")
    cfg = dataclasses.replace(ix.cfg, collect_stats=True,
                              collect_transfers=True)
    reset_counts()
    found, hops, rs = DT.search_batch(cfg, ix.state, q)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["fused"] == 1 and counts["plain"] == 0,
          f"table 1: the stats search ran {counts}")
    found0, hops0 = ix.search(q)
    check(torch.equal(found, found0) and torch.equal(hops, hops0),
          "table 1: the stats search differs from a plain read")
    same_stats(rs.transfers, OTR.measure(ix.cfg, ix.state, q),
               "table 1 transfers")
    check(int(rs.search.queries) == q.size, "table 1: search stats")
    return dict(ratios={b: v["ratio"] for b, v in cm.items()},
                measured_b16=cm[16]["measured"], counts=counts,
                read_stats=dict(search=rs.search.asdict(),
                                transfers=rs.transfers.asdict()),
                hops_mean=float(np.mean(hops.cpu().numpy())))


def ubn_read(big, vals, q, device) -> dict:
    """7.1, the UB=N ΔTree's lockstep ``search`` of Table 1's queries
    (one ΔNode of height ceil(log2 n) + 2: the walk kernels' tall path):
    found equal to the oracle, hops equal to the plain walk's for every
    query and to the scalar engine's for the first ``UBN_SCALAR_Q`` (it
    copies the 2**22-slot row to the host a query), through kernel 2 only.
    Returns the read's host-clocked time, hops and launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.api import Index, IndexSpec
    from repro_torch.core import engine as E
    from repro_torch.kernels import ref
    from repro_torch.kernels.veb_search import SMEM_HEIGHT

    cfg, st = big.cfg, big.state
    check(cfg.height > SMEM_HEIGHT, f"UB=N height {cfg.height}")
    big.search(q[:8])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    found, hops = big.search(q)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    check(counts["fused"] == 1 and counts["plain"] == 0
          and counts["rows"] == 0, f"UB=N read launches: {counts}")
    check(np.array_equal(found.cpu().numpy(), np.isin(q, vals)),
          "UB=N search != the oracle")
    qp = E._walk_queries(cfg, torch.as_tensor(q, device=device))
    want = ref.ref_delta_walk_fused(st.value, st.child,
                                    st.root.expand(q.size).contiguous(), qp,
                                    height=cfg.height,
                                    max_rounds=cfg.walk_round_cap)
    check(torch.equal(want[3], hops), "UB=N hops != the plain walk's")
    scalar = Index(IndexSpec(backend=big.spec.backend,
                             cfg=dataclasses.replace(cfg, engine="scalar")),
                   st)
    sf, sh = scalar.search(q[:UBN_SCALAR_Q])
    check(torch.equal(sf, found[:UBN_SCALAR_Q])
          and torch.equal(sh, hops[:UBN_SCALAR_Q]),
          "UB=N lockstep read != the scalar engine's")
    log(f"UB=N (height {cfg.height}): lockstep search of {q.size} queries "
        f"equals the oracle, hops equal the plain walk's (and the scalar "
        f"engine's on {UBN_SCALAR_Q}); {read_ms:.3f} ms, one kernel 2 launch")
    return dict(search_ms=read_ms, mean_hops=float(hops.float().mean()),
                found=int(found.sum()), counts=counts)


def table1_phase(seed: int, device) -> dict:
    """7.1: benchmarks/table1_transfers.py --full on the card: 1,048,576
    draws in [1, 5,000,000), 500 queries, its four backends and the ΔTree
    UB=N row; the deltatree row's transfers checked three ways; the
    ordering static_veb < sorted_array < pointer_bst; ``fit_log_b``."""
    import numpy as np

    from repro_torch.api import make_index
    from repro_torch.obs import transfers as OTR

    rng = np.random.default_rng(seed)
    vals = np.unique(rng.integers(1, KEY_MAX, size=TABLE1_INITIAL)
                     .astype(np.int32))
    q = rng.integers(1, KEY_MAX, size=TABLE1_QUERIES).astype(np.int32)
    rows, dt = [], None
    for name in TABLE1_ROWS:
        kw = dict(TABLE1_DT, engine="lockstep") if name == "deltatree" else {}
        t0 = time.perf_counter()
        ix = make_index(name, initial=vals, device=device, **kw)
        build_s = time.perf_counter() - t0
        rows.append(dict(table1_row(name, ix, q), build_s=build_s))
        if name == "deltatree":
            dt = deltatree_transfers(ix, q)
        log(json.dumps({"table1": rows[-1]}))
        del ix
    h_big = int(np.ceil(np.log2(vals.size))) + 2
    t0 = time.perf_counter()
    big = make_index("deltatree", initial=vals, height=h_big, max_dnodes=4,
                     buf_cap=16, engine="lockstep", device=device)
    build_s = time.perf_counter() - t0
    rows.append(dict(table1_row(f"deltatree_ubN(h={h_big})", big, q),
                     build_s=build_s, **ubn_read(big, vals, q, device)))
    log(json.dumps({"table1": rows[-1]}))
    ubn = rows[-1]["counts"]["fused"]
    del big
    by = {r["backend"]: r for r in rows}
    for b in ("blocks_b16", "blocks_b128"):
        check(by["static_veb"][b] < by["sorted_array"][b]
              < by["pointer_bst"][b], f"table 1 ordering at {b}: {rows}")
    t0 = time.perf_counter()
    fit = OTR.fit_log_b(device=device)
    fit_s = time.perf_counter() - t0
    check(fit["r2"] >= 0.98 and len(fit["points"]) == 11,
          f"fit_log_b: {fit}")
    return dict(keys=int(vals.size), queries=int(q.size), rows=rows,
                deltatree=dt, fit=dict(fit, seconds=fit_s), ubn_launches=ubn)


def fig12_traffic(seed: int, rate: int, initial, chunked: bool) -> dict:
    """run_index's stream at one update rate (batch 1024, its rng seeded
    with ``seed``, 2 warm-up steps then TOTAL_OPS // 1024): per step the
    search keys and the update batch the backend applies (the baselines
    take the first ``UPDATE_CHUNK`` update rows of the step, padded with
    search rows; the ΔTree the whole batch), with the oracle's answers."""
    import numpy as np

    rng = np.random.default_rng(seed)
    live = set(initial.tolist())
    steps = []
    for _ in range(FIG12_WARMUP + TOTAL_OPS // BATCH):
        kinds = mixed_kinds(rng, BATCH, rate)
        keys = rng.integers(1, KEY_MAX, size=BATCH).astype(np.int32)
        found = np.fromiter((k in live for k in keys.tolist()), bool, BATCH)
        uidx = np.flatnonzero(kinds)
        if chunked:
            uidx = uidx[:UPDATE_CHUNK]
            ukinds = np.zeros(UPDATE_CHUNK, np.int32)
            ukeys = np.zeros(UPDATE_CHUNK, np.int32)
            ukinds[: uidx.size] = kinds[uidx]
            ukeys[: uidx.size] = keys[uidx]
        else:
            ukinds, ukeys = kinds, keys
        res = np.zeros(ukinds.size, bool)
        for i in np.flatnonzero(ukinds):
            k = int(ukeys[i])
            if ukinds[i] == 1:
                res[i] = k not in live
                live.add(k)
            else:
                res[i] = k in live
                live.discard(k)
        steps.append(dict(keys=keys, found=found, ukinds=ukinds, ukeys=ukeys,
                          res=res, ops=int((kinds == 0).sum() + uidx.size)))
    return dict(steps=steps, size=len(live))


def fig12_run(ix, traffic, rate: int, label: str) -> dict:
    """7.2: one backend at one update rate through the Index API, each
    step's search and update results checked against the oracle (off the
    clock).  Host-clocked, each call ending in a synchronize; ops/s counts
    run_index's ops (search rows plus applied update rows) over the timed
    steps' search and update time.  Under ``collect_stats`` the timed
    steps' SearchStats merge on the card, as run_index's do."""
    import torch

    from repro_torch.api import OpBatch

    reset_counts()
    search_s, update_s, ops, acc = [], [], 0, None
    for i, st in enumerate(traffic["steps"]):
        t0 = time.perf_counter()
        res = ix.search(st["keys"])
        found = res[0]
        if ix.collect_stats and i >= FIG12_WARMUP:
            acc = res[-1].search if acc is None else acc.merge(res[-1].search)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if rate:
            ix, res = ix.insert_delete(OpBatch.mixed(st["ukinds"],
                                                     st["ukeys"]))
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        check((found.cpu().numpy() == st["found"]).all(),
              f"{label}: search differs from the oracle at step {i}")
        if rate:
            check((res.cpu().numpy() == st["res"]).all(),
                  f"{label}: update results differ from the oracle at "
                  f"step {i}")
        if i >= FIG12_WARMUP:
            search_s.append(t1 - t0)
            update_s.append(t2 - t1)
            ops += st["ops"]
    counts = read_counts()
    check(counts["plain"] == 0, f"{label}: a plain version ran ({counts})")
    check(ix.backend != "deltatree" or counts["fused"] > 0,
          f"{label}: the walk kernel did not run ({counts})")
    check(ix.size() == traffic["size"], f"{label}: size differs")
    return ix, dict(backend=ix.backend, collect_stats=ix.collect_stats,
                    hops_mean=acc.asdict()["hops_mean"] if acc else None,
                    update_pct=rate, batch=BATCH,
                    ops_per_s=ops / (sum(search_s) + sum(update_s)),
                    search_ms=statistics.median(search_s) * 1e3,
                    update_ms=(statistics.median(update_s) * 1e3
                               if rate else None),
                    steps=len(search_s), counts=counts)


def index_idle_share(ix, rng) -> dict:
    """7.3: ``IDLE_STEPS`` Fig. 12 steps (a 1024-key search, then the
    eager update of the batch at 10 % updates) timed without the
    profiler, then as many under `repro_torch.obs.trace.capture`: device
    busy time a step (one stream, so the sum of kernel times), wall time
    a step and the idle share, 1 - busy / wall, over the same span."""
    import numpy as np
    import torch

    from repro_torch.api import OpBatch
    from repro_torch.obs import trace as OT

    def steps(ix) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IDLE_STEPS):
            kinds = mixed_kinds(rng, BATCH, UPDATE_PCT)
            keys = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
            ix.search(keys)
            ix.insert_delete(OpBatch.mixed(kinds, keys))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / IDLE_STEPS

    untraced_ms = steps(ix)
    reset_counts()
    with OT.capture(str(ROOT / "build" / "phase7_trace")) as prof:
        step_ms = steps(ix)
    counts = read_counts()
    check(counts["fused"] > 0 and counts["plain"] == 0,
          f"idle share: {counts}")
    busy = device_split(prof, IDLE_STEPS)["busy"]
    return dict(steps=IDLE_STEPS, step_ms=step_ms,
                untraced_step_ms=untraced_ms, busy_ms=busy,
                idle_share=1 - busy / step_ms if busy > 0 else None,
                counts=counts)


def fig12_phase(keys, seed: int, device) -> dict:
    """7.2-7.3: fig12_big_tree.py's backends on the phase-3 key set at
    batch 1024, 0 % and 10 % updates (static_veb at 0 % only), then the
    ΔTree step's idle share.  The ΔTree runs twice: with ``collect_stats``
    as run_index turns it on (``deltatree+stats``), and without, as phase
    3 runs it (its idle share is taken there).  Each index is built once
    and serves both rates (the 0 % run changes nothing)."""
    import numpy as np
    import torch

    from repro_torch.api import make_index

    tree = dict(engine="lockstep", **fig12_config(keys.size))
    kws = {"deltatree": tree,
           "deltatree+stats": dict(tree, collect_stats=True),
           "pointer_bst": dict(cap=2 * keys.size + TOTAL_OPS + 16),
           "sorted_array": dict(cap=2 * keys.size + TOTAL_OPS + 16),
           "static_veb": {}}
    traffic = {(0, False): fig12_traffic(seed, 0, keys, False)}
    traffic[(0, True)] = traffic[(0, False)]
    for chunked in (False, True):
        traffic[(10, chunked)] = fig12_traffic(seed, 10, keys, chunked)
    runs, builds, launches, idle = [], {}, 0, None
    for name in kws:
        backend = name.split("+")[0]
        t0 = time.perf_counter()
        ix = make_index(backend, initial=keys, device=device, **kws[name])
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t0
        for rate in FIG12_RATES if name != "static_veb" else (0,):
            ix, row = fig12_run(ix, traffic[(rate, backend != "deltatree")],
                                rate, f"fig12 {name} {rate} %")
            launches += row["counts"]["fused"]
            runs.append(dict(row, name=name, build_s=builds[name]))
            log(json.dumps({"fig12": runs[-1]}))
        if name == "deltatree":
            idle = index_idle_share(ix, np.random.default_rng(seed + 7))
            launches += idle["counts"]["fused"]
            log(json.dumps({"index_idle": idle}))
        del ix
        torch.cuda.empty_cache()
    log(json.dumps({"fig12_search_ms": {
        f"{r['name']} {r['update_pct']} %": r["search_ms"] for r in runs}}))
    return dict(runs=runs, idle=idle, launches=launches)


def forest_stats_leg(seed: int, device) -> dict:
    """7.4: an S = 4 forest at phase 6's size with ``collect_stats`` and
    ``collect_transfers``: one read batch (shard boundaries, keys above
    the last and below the domain, random keys) through the fused and
    the dense dispatch; found / hops and every ReadStats field equal, the
    router's lanes sum to the batch, found equals the oracle."""
    import numpy as np
    import torch

    from repro_torch.api import make_index

    rng = np.random.default_rng(seed + 6)
    keys = np.unique(rng.integers(1, FOREST_KEY_MAX, FOREST_INITIAL)
                     .astype(np.int32))
    ix = make_index("forest", initial=keys, engine="lockstep", device=device,
                    collect_stats=True, collect_transfers=True,
                    **forest_config(keys.size, 4))
    q = rng.integers(0, FOREST_KEY_MAX + 50, STATS_K).astype(np.int32)
    edge = boundary_keys(ix, keys)
    q[: edge.size] = edge
    out = {}
    for name, view in (("fused", ix), ("dense", copy_index(ix, fused=False))):
        reset_counts()
        out[name] = view.search(q)
        torch.cuda.synchronize()
        out[name + "_counts"] = read_counts()
    f, d = out["fused"], out["dense"]
    check(out["fused_counts"]["fused"] == 1
          and out["dense_counts"]["fused"] == 4
          and out["fused_counts"]["plain"] + out["dense_counts"]["plain"]
          == 0, f"forest stats: {out['fused_counts']} {out['dense_counts']}")
    check(torch.equal(f[0], d[0]) and torch.equal(f[1], d[1]),
          "forest stats: fused and dense reads differ")
    check((f[0].cpu().numpy() == np.isin(q, keys)).all(),
          "forest stats: found differs from the oracle")
    same_stats(f[2], d[2], "forest ReadStats fused vs dense")
    rs = f[2]
    check(int(rs.router.lanes.sum()) == STATS_K
          and int(rs.search.queries) == STATS_K,
          f"forest stats: router lanes {rs.router.lanes.tolist()}")
    row = dict(shards=4, keys=int(keys.size), queries=STATS_K,
               search=rs.search.asdict(), router=rs.router.asdict(),
               transfers=rs.transfers.asdict(),
               counts=dict(fused=out["fused_counts"],
                           dense=out["dense_counts"]))
    del ix, out
    torch.cuda.empty_cache()
    return row


def metrics_serve_leg(rng, device, seed: int) -> dict:
    """7.4: phase 5.2's float32 leg (Granite at full width, 4 layers)
    over ``ShardedPagerConfig(num_shards=4)`` whose forest index collects
    stats and transfers, beside the same run over the stats-free index:
    tokens equal, and ``metrics()`` in dict, Prometheus and JSON form
    with the search, router and transfers groups."""
    import dataclasses

    import torch

    from repro_torch.api import make_index
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import ServeEngine, ShardedPagerConfig

    cfg = dataclasses.replace(CONFIG, num_layers=EXACT_LAYERS,
                              dtype="float32", param_dtype="float32")
    model = Transformer(cfg, device=device, seed=seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype("int32")
               for n in rng.integers(*EXACT_PROMPT, EXACT_REQUESTS)]
    pc = ShardedPagerConfig(num_shards=SHARDED_SHARDS, engine="lockstep")
    fc = pc.forest_config
    runs = {}
    for name, collect in (("plain", False), ("stats", True)):
        ix = make_index("forest", device=device, cfg=dataclasses.replace(
            fc, tree=dataclasses.replace(fc.tree, collect_stats=collect,
                                         collect_transfers=collect)))
        eng = ServeEngine(cfg, model, pc, max_batch=EXACT_REQUESTS, index=ix)
        reset_counts()
        wall = run_engine(eng, prompts, EXACT_NEW)
        runs[name] = dict(eng=eng, wall=wall, counts=read_counts())
    eng = runs["stats"]["eng"]
    counts = runs["stats"]["counts"]
    check(counts["fused"] > 0 and counts["paged"] > 0
          and counts["plain"] == 0, f"metrics leg: {counts}")
    for sid, req in eng.active.items():
        check(req.out == runs["plain"]["eng"].active[sid].out,
              f"metrics leg: request {sid}'s tokens differ with stats on")
    snap = eng.metrics()
    check({"serve", "pager", "maintenance", "search", "router",
           "transfers"} <= set(snap), f"metrics groups {sorted(snap)}")
    check(json.loads(eng.metrics("json")) == snap, "metrics json")
    prom = eng.metrics("prometheus")
    check("repro_router_lanes{index=\"3\"}" in prom
          and "repro_transfers_blocks_b16 " in prom
          and "repro_search_hops_hist{index=\"0\"}" in prom,
          "metrics prometheus")
    check(sum(snap["router"]["lanes"]) == snap["search"]["queries"],
          "metrics: router lanes differ from the batch")
    row = dict(layers=cfg.num_layers, shards=SHARDED_SHARDS,
               requests=len(prompts), wall_s=runs["stats"]["wall"],
               plain_wall_s=runs["plain"]["wall"], counts=counts,
               prometheus_lines=len(prom.splitlines()),
               metrics={k: snap[k] for k in ("search", "router",
                                             "transfers")})
    del runs, eng, model
    torch.cuda.empty_cache()
    return row


def comparison_phase(keys, seed: int, device) -> dict:
    """Phase 7, in order: 7.1 Table 1, 7.2 the Fig. 12 comparison, 7.3 the
    index step's idle share, 7.4 read stats on the forest and the sharded
    serve path.  Returns every row and kernel 2's launches."""
    import numpy as np

    t0 = time.perf_counter()
    table1 = table1_phase(seed, device)
    log(json.dumps({"table1_fit": table1["fit"],
                    "table1_deltatree": table1["deltatree"]}))
    log(f"phase 7.1 done at {time.perf_counter() - t0:.1f} s")
    fig12 = fig12_phase(keys, seed, device)
    log(f"phase 7.2-7.3 done at {time.perf_counter() - t0:.1f} s")
    forest = forest_stats_leg(seed, device)
    log(json.dumps({"forest_stats": forest}))
    serve = metrics_serve_leg(np.random.default_rng(seed + 8), device, seed)
    log(json.dumps({"metrics_serve": serve}))
    elapsed = time.perf_counter() - t0
    log(f"phase 7 done in {elapsed:.1f} s")
    launches = (table1["deltatree"]["counts"]["fused"]
                + table1["ubn_launches"] + fig12["launches"]
                + forest["counts"]["fused"]["fused"]
                + forest["counts"]["dense"]["fused"]
                + serve["counts"]["fused"])
    return dict(table1=table1, fig12=fig12, forest=forest, serve=serve,
                launches=launches, paged_launches=serve["counts"]["paged"],
                elapsed_s=elapsed)



# --------------------------------------------------------------------------
# phase 8: the zoo's other families the serve path admits
# --------------------------------------------------------------------------

# (configs, QH, KVH) of 8.1: every group size the zoo's served configs
# have, at D = 128, PS = 16, and synthetic G = 1 and 16
ZOO_GROUPS = (("granite_8b, phi3_5_moe_42b, mistral_nemo_12b", 32, 8),
              ("starcoder2_15b", 48, 4), ("qwen1_5_110b", 64, 8),
              ("internvl2_2b", 16, 8), ("G = 1", 8, 8), ("G = 16", 128, 8))
# Phi-3.5-MoE cut from 32 to 24 layers: at 32 its ~41.9 B bf16 parameters
# (~83.7 GB) do not fit the 80 GB card beside the pager's 8.6 GB of pages
PHI_LAYERS = 24
ZOO_EXACT_LAYERS = 2                 # the float32 exact-token legs' depth
SC2_REQUESTS, SC2_NEW = 8, 16        # 8.3's traffic (prompts as phase 5.3)
VLM_TEXT, VLM_STEPS, VLM_BATCH = 512, 8, 4   # 8.4: text tokens, decode steps


def group_sizes(rng, device, seed: int) -> list:
    """8.1: the paged kernel at every group size in ``ZOO_GROUPS``, float32
    and bf16, at the served batch (B = 8, ~1 k tokens) and at B = 64 x
    4096: held against its plain version (-1 tails, scrambled unreferenced
    pages; `paged_err`'s tolerance), then timed beside the bytes bound (and
    the plain version at the served batch)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.delta_paged_attention import (
        paged_decode_attention,
        subgroups,
    )

    gen = torch.Generator(device=device).manual_seed(seed + 8)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    rows = []
    for label, qh, kvh in ZOO_GROUPS:
        for dtype in (torch.float32, torch.bfloat16):
            for b, tokens in (PA_SERVED, PA_LONG):
                served = b == PA_SERVED[0]
                lens = (rng.integers(tokens // 2, 3 * tokens // 2 + 1, b)
                        if served else np.full(b, tokens))
                args = paged_case(gen, rng, device, dtype, lens,
                                  shape=(qh, kvh, 128, 16))
                got = paged_decode_attention(*args)
                want = ref.ref_paged_decode_attention(*args)
                torch.cuda.synchronize()
                err, ok = paged_err(got, want)
                where = f"{label}, G = {qh // kvh}, B = {b}, {dtype}"
                check(bool(torch.isfinite(got).all()),
                      f"paged kernel: non-finite output ({where})")
                check(ok, f"paged kernel != plain ({where}): {err}")
                nbytes = paged_bytes(args[0], args[1], args[3], args[4])
                ms = cuda_ms(lambda: paged_decode_attention(*args), 20, flush)
                r = dict(configs=label, G=qh // kvh, QH=qh, KVH=kvh,
                         subgroups=subgroups(qh // kvh)[0], B=b,
                         tokens=int(lens.sum()), dtype=str(dtype)[6:],
                         ms=ms, bytes=nbytes, bound_ms=bound_ms(nbytes),
                         pct_of_bound=100 * bound_ms(nbytes) / ms, err=err,
                         plain_ms=cuda_ms(lambda: ref.ref_paged_decode_attention(
                             *args), 3, flush) if served else None)
                log(json.dumps({"table": "paged_groups", **r}))
                rows.append(r)
                del args, got, want
                torch.cuda.empty_cache()
    return rows


def vlm_leg(rng, device, seed: int) -> dict:
    """8.4: InternVL2-2B at full width and depth (bf16): a prefill of 256
    seeded vision embeddings + 512 tokens for 4 sequences, then 8
    ``decode_step``s, each held to a prefill of the longer prefix within
    5 % of the largest |logit| with >= 90 % of the argmaxes equal; then a
    VLM admission into ``ServeScheduler`` must raise as the JAX one does
    (no vision embeddings reach its prefill)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import SchedulerConfig, ServeScheduler
    from repro_torch.serving import PagerConfig

    cfg = get_config("internvl2_2b")
    model = Transformer(cfg, device=device, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 84)
    # drawn as the token table is: standard normal over sqrt(d_model)
    ve = (torch.randn((VLM_BATCH, cfg.vision_tokens, cfg.d_model),
                      generator=gen, device=device)
          / cfg.d_model ** 0.5).to(model.act_dtype)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                        (VLM_BATCH, VLM_TEXT + VLM_STEPS)),
                           dtype=torch.int32, device=device)
    prefix = cfg.vision_tokens + VLM_TEXT
    caches = model.init_caches(VLM_BATCH, prefix + VLM_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = model.prefill(toks[:, :VLM_TEXT], caches, ve)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(lg.shape == (VLM_BATCH, 1, cfg.vocab_size)
          and bool(torch.isfinite(lg).all()), "vlm: prefill logits")
    match, diff, mag, dec_s = 0, 0.0, 0.0, []
    for j in range(VLM_STEPS):
        length = torch.full((VLM_BATCH,), prefix + j, dtype=torch.int32,
                            device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec, caches = model.decode_step(toks[:, VLM_TEXT + j:][:, :1],
                                        caches, length)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        want, _ = model.prefill(toks[:, :VLM_TEXT + j + 1],
                                model.init_caches(VLM_BATCH, prefix + j + 1),
                                ve)
        d, w = dec[:, 0], want[:, 0]
        match += int((d.argmax(-1) == w.argmax(-1)).sum())
        diff = max(diff, float((d - w).abs().max()))
        mag = max(mag, float(w.abs().max()))
    n = VLM_BATCH * VLM_STEPS
    check(diff <= LOGIT_REL_TOL_BF16 * mag, f"vlm: decode logits differ from "
          f"the longer prefill's by {diff} (> {LOGIT_REL_TOL_BF16} x {mag})")
    check(match >= TOKEN_MATCH_MIN_BF16 * n,
          f"vlm: {match} of {n} decode argmaxes equal the prefill's")
    sch = ServeScheduler(cfg, model, PagerConfig(engine="lockstep"),
                         SchedulerConfig(max_live=2))
    sch.submit(np.arange(1, 9, dtype=np.int32), max_new=2)
    refused = ""
    try:
        sch.step()
    except ValueError as e:   # the admission must fail, as JAX's asserts
        refused = str(e)
    check("vision_embeds" in refused, "vlm: a VLM admission did not raise")
    row = dict(config=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
               params=model.param_count(), batch=VLM_BATCH,
               vision_tokens=cfg.vision_tokens, text_tokens=VLM_TEXT,
               prefill_ms=prefill_ms,
               decode_step_ms=statistics.median(dec_s) * 1e3,
               decode_steps=VLM_STEPS, token_match=match / n,
               max_logit_diff=diff, max_logit=mag, admission_error=refused)
    log(json.dumps({"vlm": row}))
    del sch, model, caches
    release()
    return row


def zoo_phase(seed: int, device) -> dict:
    """Phase 8, in order: 8.1 the paged kernel at every group size; 8.2
    Phi-3.5-MoE, its float32 2-layer exact-token leg then the 24-layer
    bf16 serve (served logits held to the dense decode, 3 traced steps,
    the churn trace under deferred); 8.3 StarCoder2-15B (G = 12) the same,
    at full depth, without trace or churn; 8.4 InternVL2-2B.  Each model
    is freed before the next is built."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 8)
    t0 = time.perf_counter()
    groups = group_sizes(rng, device, seed)
    log(f"phase 8.1 done at {time.perf_counter() - t0:.1f} s")
    phi = get_config("phi3_5_moe_42b")
    phi_exact = exact_token_leg(rng, device, seed, phi, ZOO_EXACT_LAYERS)
    log(json.dumps({"phi_float32_exact": phi_exact}))
    phi_run = full_width_serve(rng, device, seed,
                               dataclasses.replace(phi, num_layers=PHI_LAYERS))
    log(f"phase 8.2 done at {time.perf_counter() - t0:.1f} s")
    sc2 = get_config("starcoder2_15b")
    sc2_exact = exact_token_leg(rng, device, seed, sc2, ZOO_EXACT_LAYERS)
    log(json.dumps({"starcoder2_float32_exact": sc2_exact}))
    sc2_run = full_width_serve(rng, device, seed, sc2, SC2_REQUESTS, SC2_NEW,
                               trace=False, churn=False)
    log(f"phase 8.3 done at {time.perf_counter() - t0:.1f} s")
    vlm = vlm_leg(rng, device, seed)
    elapsed = time.perf_counter() - t0
    log(f"phase 8 done in {elapsed:.1f} s")
    paged = (phi_exact["counts"]["paged"]
             + phi_run["serve"]["counts"]["paged"]
             + phi_run["churn"]["counts"]["paged"]
             + sc2_exact["counts"]["paged"]
             + sc2_run["serve"]["counts"]["paged"])
    return dict(groups=groups, phi_exact=phi_exact, phi=phi_run,
                sc2_exact=sc2_exact, sc2=sc2_run, vlm=vlm,
                paged_launches=paged, elapsed_s=elapsed)


# --------------------------------------------------------------------------
# phase 9: the model-only families (MLA, SSD, hybrid, encoder-decoder)
# --------------------------------------------------------------------------

MODEL_ONLY = ("deepseek_v2_236b", "mamba2_370m", "jamba_1_5_large_398b",
              "whisper_base")
# 9.1: the smoke configs in float32, the card against the port's CPU run
# (their SSD sums a chunk's decays and states in other orders: 1e-4)
SMOKE_B, SMOKE_S, SMOKE_STEPS = 2, 20, 8
SMOKE_TOL, SMOKE_TOL_SSD = 1e-5, 1e-4
# 9.2: DeepSeek-V2's dense prologue layer + 4 of its 59 MoE layers
DS_LAYERS = 5
DS_PREFILL = ((4, 1024), (1, 4096))   # (B, S): the naive, the flash branch
DS_STEPS = 32
# the check runs: forward_train over 1 x 3072 tokens takes the flash
# branch; 4 x 544 widens the argmax sample
DS_CHECKS = ((1, 3040), (4, 512))
# 9.3: one period of Jamba-1.5-Large (8 layers) holding 8 of its 16
# experts: a period with 16 is 45.1 B parameters (90.3 GB of bf16)
JAMBA_EXPERTS = 8
JAMBA_PREFILL, JAMBA_STEPS = (2, 4096), 32   # 4096 tokens: 16 SSD chunks
JAMBA_CHECK = (2, 500)   # a prompt that is no chunk multiple
# 9.4: Mamba2-370m whole; ssd_chunked against ssd_ref on layer 0's inputs
MAMBA_PREFILL, MAMBA_STEPS, SSD_REF_LEN = (4, 8192), 64, 1024
# chunked against sequential float32 sums over 1024 tokens, as a share of
# the largest |y|
SSD_REF_TOL = 1e-4
# Mamba2's float32 check: decode against forward_train as a share of the
# largest |logit| (read on the H100: 4.7e-4 against 5.36 after 64 steps;
# the bf16 run drifts to 0.09 at the first step)
FLOAT_REL_TOL = 1e-3
# 9.5: Whisper-base whole: 8 lanes, 1500 frames, a 64-token prompt
WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS = 8, 64, 64


class RouteReplay:
    """Teacher-forces a leg's MoE routing to its ``forward_train``'s, as
    `RouteTap` forces a dense decode to a served step's: ``record`` keeps
    each MoE layer's expert choice (B, S, K) over the whole sequence; then
    ``force(positions)`` makes the next pass (the prefill, or one decode
    step) take the recorded choices of those positions, with gates from
    its own router probabilities, and counts the (token, layer) rows whose
    own choice differs (``flips``).  A near-tied router flips under bf16
    rounding that differs between the train, prefill and absorbed decode
    paths.  Its ``forward_train`` runs under no_grad (`train_ref`), so
    ``remat`` (on only with autograd) never recomputes it: nothing is
    recorded twice and no replay index shifts."""

    def __init__(self):
        from repro_torch.models.layers import moe as TM

        self.TM, self.orig = TM, TM.route
        self.rec: list | None = None
        self.want: list | None = None
        self.recorded: list = []
        self.forced = self.flips = 0
        TM.route = self._route

    def _route(self, moe, cfg, xf):
        gates, idx = self.orig(moe, cfg, xf)
        if self.want is not None:
            want = self.want.pop(0)
            self.forced += want.shape[0]
            self.flips += int((idx.sort(-1).values
                               != want.sort(-1).values).any(-1).sum())
            return forced_gates(moe, xf, want), want
        if self.rec is not None:
            self.rec.append(idx)
        return gates, idx

    def record(self) -> None:
        self.rec = []

    def stop(self, b: int, s: int) -> None:
        self.recorded = [i.reshape(b, s, -1) for i in self.rec]
        self.rec = None

    def force(self, positions: slice) -> None:
        self.want = [r[:, positions].reshape(-1, r.shape[-1])
                     for r in self.recorded]

    def done(self) -> None:
        check(not self.want, "forced routing left unused")
        self.want = None

    def close(self) -> None:
        self.TM.route = self.orig


def decode_read_bytes(model, lanes: int) -> int:
    """`weight_read_bytes` of a decode step, less an encoder-decoder's
    encoder (its decode steps read only the decoder and the cross caches,
    not counted here)."""
    enc = sum(p.numel() * p.element_size()
              for n, p in model.named_parameters()
              if n.startswith(("encoder.", "enc_norm.")))
    return weight_read_bytes(model, lanes) - enc


def family_model(cfg, device, seed: int):
    """The family's model (`registry.api`) on ``device``, drawn from
    ``seed``."""
    from repro_torch.models.registry import api

    return api(cfg).init_params(device=device, seed=seed)


def run_leg(model, toks, s0: int, steps: int, frames=(), replay=None,
            timed: bool = True):
    """Prefill ``toks[:, :s0]`` (and ``frames``), then ``steps`` decode
    steps fed ``toks``' next tokens; with ``replay`` each pass takes
    ``forward_train``'s routing.  ``timed``: one untimed prefill first
    (the allocator's and cuBLAS's first calls at these shapes), then the
    prefill and every step host-clocked, each ended by a synchronize.
    Returns (row: prefill ms, decode step median ms, tokens/s; the logits
    (B, 1 + steps, V) of the prefill's last position and each step)."""
    import torch

    b = toks.shape[0]
    dev = model.device
    if timed:
        model.prefill(toks[:, :s0], *frames, model.init_caches(b, s0))
    caches = model.init_caches(b, s0 + steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if replay is not None:
        replay.force(slice(0, s0))
    lg, caches = model.prefill(toks[:, :s0], *frames, caches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if replay is not None:
        replay.done()
    out, dec_s = [lg[:, 0]], []
    for j in range(steps):
        length = torch.full((b,), s0 + j, dtype=torch.int32, device=dev)
        if replay is not None:
            replay.force(slice(s0 + j, s0 + j + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = model.decode_step(toks[:, s0 + j:s0 + j + 1], caches,
                                       length)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        if replay is not None:
            replay.done()
        out.append(lg[:, 0])
    got = torch.stack(out, 1)                       # (B, 1 + steps, V)
    check(got.shape == (b, 1 + steps, model.cfg.vocab_size)
          and bool(torch.isfinite(got).all()), "non-finite or misshapen "
                                               "prefill / decode logits")
    row = dict(batch=b, prompt=s0, steps=steps)
    if timed:
        row["prefill_ms"] = prefill_ms
    if timed and steps:
        med = statistics.median(dec_s)
        row.update(decode_step_ms=med * 1e3, decode_tok_s=b / med)
    return row, got


def hold(got, ref, s0: int, rel_tol: float, where: str) -> dict:
    """Logits ``got`` (B, n, V) of a prefill's last position and n - 1
    decode steps against ``forward_train``'s ``ref`` (B, S, V) at the same
    positions: the largest |difference| must be within ``rel_tol`` of the
    largest |logit|.  Returns the numbers and the argmax matches (the
    caller holds those, pooled over its runs, to `TOKEN_MATCH_MIN_BF16`)."""
    want = ref[:, s0 - 1:s0 - 1 + got.shape[1]]
    diff = float((got - want).abs().max())
    mag = float(want.abs().max())
    check(diff <= rel_tol * mag,
          f"{where}: prefill / decode logits differ from forward_train's by "
          f"{diff} (> {rel_tol} x {mag})")
    match = int((got.argmax(-1) == want.argmax(-1)).sum())
    return dict(max_logit_diff=diff, max_logit=mag, matches=match,
                positions=got.shape[0] * got.shape[1])


def hold_matches(rows: list, where: str) -> float:
    """The share of argmaxes equal over ``rows`` (`hold`'s), which must
    reach `TOKEN_MATCH_MIN_BF16`."""
    match = sum(r["matches"] for r in rows)
    n = sum(r["positions"] for r in rows)
    check(match >= TOKEN_MATCH_MIN_BF16 * n,
          f"{where}: {match} of {n} argmaxes equal forward_train's")
    return match / n


def train_ref(model, toks, frames=(), replay=None):
    """(``forward_train`` logits over ``toks``, its host-clocked ms); with
    ``replay`` its routing is recorded."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if replay is not None:
        replay.record()
    with torch.no_grad():
        ref = model.forward_train(toks, *frames)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if replay is not None:
        replay.stop(*toks.shape)
    return ref, ms


def smoke_legs(device, seed: int) -> list:
    """9.1: each model-only family at its smoke size in float32, drawn on
    the CPU from ``seed`` and copied to the card: ``forward_train``, the
    prefill and 8 decode steps on both, logits and every cache within
    `SMOKE_TOL` (the SSD families `SMOKE_TOL_SSD`)."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config

    rows = []
    for name in MODEL_ONLY:
        cfg = get_smoke_config(name)
        tol = SMOKE_TOL_SSD if cfg.family in ("ssm", "hybrid") else SMOKE_TOL
        cpu = family_model(cfg, "cpu", seed)
        gpu = copy.deepcopy(cpu).to(device)
        rng = np.random.default_rng(seed + 91)
        toks = rng.integers(0, cfg.vocab_size,
                            (SMOKE_B, SMOKE_S + SMOKE_STEPS)).astype(np.int32)
        frames = ()
        if cfg.family == "audio":
            frames = (rng.standard_normal(
                (SMOKE_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32),)
        res = []
        for model in (cpu, gpu):
            dev = model.device
            t = torch.as_tensor(toks, device=dev)
            f = tuple(torch.as_tensor(a, device=dev) for a in frames)
            with torch.no_grad():
                train = model.forward_train(t, *f)
            caches = model.init_caches(SMOKE_B, SMOKE_S + SMOKE_STEPS)
            lg, caches = model.prefill(t[:, :SMOKE_S], *f, caches)
            out = [lg]
            for j in range(SMOKE_STEPS):
                ln = torch.full((SMOKE_B,), SMOKE_S + j, dtype=torch.int32,
                                device=dev)
                lg, caches = model.decode_step(
                    t[:, SMOKE_S + j:SMOKE_S + j + 1], caches, ln)
                out.append(lg)
            flat = {"train": train, "logits": torch.cat(out, 1)}
            if isinstance(caches, dict):
                caches = [caches]
            for i, c in enumerate(caches):
                flat.update({f"cache {i} {k}": v for k, v in c.items()})
            res.append({k: v.float().cpu() for k, v in flat.items()})
        err = {k: float((res[0][k] - res[1][k]).abs().max()) for k in res[0]}
        worst = max(err, key=err.get)
        check(set(res[0]) == set(res[1]) and err[worst] <= tol,
              f"9.1 {name}: the card's {worst} differs from the CPU's by "
              f"{err[worst]} (> {tol})")
        row = dict(config=cfg.name, family=cfg.family, dtype=cfg.dtype,
                   compared=len(err), max_abs_err=err[worst], worst=worst,
                   tol=tol)
        log(json.dumps({"model_only_smoke": row}))
        rows.append(row)
    return rows


def _tokens(rng, cfg, b: int, s: int, device):
    import torch

    return torch.as_tensor(rng.integers(1, cfg.vocab_size, (b, s)),
                           dtype=torch.int32, device=device)


def check_leg(model, rng, runs, steps: int, where: str) -> dict:
    """For each (B, S) of ``runs``: ``forward_train`` over B x (S + steps)
    tokens, then `run_leg`'s prefill of S and its decode steps held to it
    (`hold`, the bf16 rule; the argmaxes pooled over the runs).  A MoE
    model runs at capacity factor E / K (an expert's slots then hold every
    token: none dropped) with its routing replayed (`RouteReplay`).
    Returns the numbers under ``check_`` names."""
    import dataclasses

    cfg = model.cfg
    replay = None
    if cfg.moe_experts:
        replay = RouteReplay()
        model.cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    rows = []
    try:
        for b, s0 in runs:
            toks = _tokens(rng, cfg, b, s0 + steps, model.device)
            ref, ms = train_ref(model, toks, (), replay)
            row, got = run_leg(model, toks, s0, steps, replay=replay,
                               timed=False)
            row.update(hold(got, ref, s0, LOGIT_REL_TOL_BF16, where),
                       train_ms=ms)
            rows.append(row)
            del ref, got
    finally:
        model.cfg = cfg
        if replay is not None:
            replay.close()
    out = dict(check_runs=rows, check_token_match=hold_matches(rows, where))
    if replay is not None:
        out.update(check_capacity_factor=cfg.moe_experts / cfg.moe_top_k,
                   check_forced_rows=replay.forced,
                   check_flips=replay.flips)
    return out


def _finish(row: dict, model, lanes: int) -> dict:
    """The leg's row with the parameter count, the bytes a decode step of
    ``lanes`` lanes reads of the weights and their bound, and the peak
    memory allocated since the leg began."""
    import torch

    nbytes = decode_read_bytes(model, lanes)
    row.update(params=model.param_count(), weight_read_bytes=nbytes,
               weight_read_bound_ms=bound_ms(nbytes),
               peak_bytes=torch.cuda.max_memory_allocated())
    return row


def deepseek_leg(rng, device, seed: int) -> dict:
    """9.2: DeepSeek-V2 at full width (128 heads, kv_lora_rank 512 + 64
    RoPE, 160 experts top-6 with 2 shared, vocabulary 102,400), its dense
    prologue layer + 4 MoE layers, bf16: prefills of 4 x 1024 (the
    materialised softmax) and 1 x 4096 (the flash branch), 32 absorbed
    decode steps after the first; then `check_leg` on 1 x 3040 + 32
    tokens (``forward_train`` over 3072 takes the flash branch) and 4 x
    512 + 32."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    full = get_config("deepseek_v2_236b")
    cfg = dataclasses.replace(full, num_layers=DS_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = family_model(cfg, device, seed)
    (b, s), (b2, s2) = DS_PREFILL
    timed, _ = run_leg(model, _tokens(rng, cfg, b, s + DS_STEPS, device), s,
                       DS_STEPS)
    flash, _ = run_leg(model, _tokens(rng, cfg, b2, s2, device), s2, 0)
    row = dict(config=cfg.name, leg="9.2",
               layers=f"{DS_LAYERS} of {full.num_layers}",
               reduced="depth: the dense prologue + 4 of 59 MoE layers",
               **timed, flash_batch=b2, flash_prompt=s2,
               flash_prefill_ms=flash["prefill_ms"])
    torch.cuda.empty_cache()
    row.update(check_leg(model, rng, DS_CHECKS, DS_STEPS, "9.2"))
    row = _finish(row, model, b)
    del model
    release()
    return row


def jamba_leg(rng, device, seed: int) -> dict:
    """9.3: one period of Jamba-1.5-Large at full widths (d_model 8192,
    d_inner 16,384: 256 SSD heads of 64 with a 128-wide state; 64 / 8
    attention heads; MoE of width 24,576 top-2 on the odd layers), bf16,
    holding 8 of its 16 experts (the router narrows with them): a prefill
    of 2 x 4096 (16 SSD chunks; the attention layer's flash branch) and
    32 decode steps; then `check_leg` on 2 x 500 + 32 tokens."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    full = get_config("jamba_1_5_large_398b")
    cfg = dataclasses.replace(full, num_layers=full.pattern_period,
                              moe_experts=JAMBA_EXPERTS)
    torch.cuda.reset_peak_memory_stats()
    model = family_model(cfg, device, seed)
    b, s = JAMBA_PREFILL
    timed, _ = run_leg(model, _tokens(rng, cfg, b, s + JAMBA_STEPS, device),
                       s, JAMBA_STEPS)
    row = dict(config=cfg.name, leg="9.3",
               layers=f"{cfg.num_layers} of {full.num_layers}",
               reduced=(f"depth: one period of {cfg.num_layers} layers; "
                        f"{JAMBA_EXPERTS} of {full.moe_experts} experts a "
                        f"MoE layer (router {cfg.d_model} x {JAMBA_EXPERTS})"),
               **timed)
    torch.cuda.empty_cache()
    row.update(check_leg(model, rng, (JAMBA_CHECK,), JAMBA_STEPS, "9.3"))
    row = _finish(row, model, b)
    del model
    release()
    return row


def mamba_leg(rng, device, seed: int) -> dict:
    """9.4: Mamba2-370m whole (48 SSD layers).  In bf16: ``forward_train``
    over 4 x 8256 tokens, then a prefill of 4 x 8192 (held to it by the
    bf16 rule) and 64 decode steps, timed, each step's drift from it
    printed: a one-ulp difference between the stepwise and the chunked
    SSD grows through the layers and the state (PERF.md §6), so the
    decode is held to ``forward_train`` in float32, on the same weights
    and tokens, within `FLOAT_REL_TOL`.  Then layer 0's ``ssd_chunked``
    against ``ssd_ref`` on its real inputs over the first 1024 tokens,
    within `SSD_REF_TOL` of the largest |y|."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import mamba2 as m2

    cfg = get_config("mamba2_370m")
    torch.cuda.reset_peak_memory_stats()
    model = family_model(cfg, device, seed)
    b, s = MAMBA_PREFILL
    toks = _tokens(rng, cfg, b, s + MAMBA_STEPS, device)
    ref, train_ms = train_ref(model, toks)
    timed, got = run_leg(model, toks, s, MAMBA_STEPS)
    prefill = hold(got[:, :1], ref, s, LOGIT_REL_TOL_BF16, "9.4 prefill")
    drift = (got - ref[:, s - 1:]).abs().amax(dim=(0, 2)).tolist()
    row = dict(config=cfg.name, leg="9.4", layers=cfg.num_layers,
               train_ms=train_ms, **timed,
               prefill_max_logit_diff=prefill["max_logit_diff"],
               bf16_decode_drift=drift, max_logit=prefill["max_logit"])
    del ref, got
    layer = model.layers[0]
    with torch.no_grad():
        h = layer.norm1(model._embed(toks[:, :SSD_REF_LEN]))
        _, xin, b_, c_, dt, _ = m2._pre_ssd(layer.mixer, cfg, h)
        args = (xin, b_, c_, dt, layer.mixer.a_log, layer.mixer.d_skip)
        y, _ = m2.ssd_chunked(cfg, *args)
        y_ref = m2.ssd_ref(cfg, *args)
    err, mag = float((y - y_ref).abs().max()), float(y_ref.abs().max())
    check(bool(torch.isfinite(y).all()) and err <= SSD_REF_TOL * mag,
          f"9.4: ssd_chunked differs from ssd_ref by {err} "
          f"(> {SSD_REF_TOL} x {mag})")
    row.update(ssd_ref_tokens=SSD_REF_LEN, ssd_ref_err=err, ssd_ref_max=mag)
    row = _finish(row, model, b)
    # the check in float32: the same weights, widened, and the same tokens
    model.float()
    model.cfg = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
    ref, ms = train_ref(model, toks)
    _, got = run_leg(model, toks, s, MAMBA_STEPS, timed=False)
    held = hold(got, ref, s, FLOAT_REL_TOL, "9.4 float32")
    row.update(check_dtype="float32", check_train_ms=ms,
               check_token_match=hold_matches([held], "9.4 float32"),
               **{f"check_{k}": v for k, v in held.items()})
    del model, toks, ref, got
    release()
    return row


def whisper_leg(rng, device, seed: int) -> dict:
    """9.5: Whisper-base whole (6 + 6 layers), bf16: 8 lanes of 1500
    seeded frame embeddings, ``forward_train`` over 128 tokens, the encode
    alone, then the encode and a 64-token prefill and 64 decode steps,
    timed and held to forward_train."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("whisper_base")
    torch.cuda.reset_peak_memory_stats()
    model = family_model(cfg, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 95)
    frames = (torch.randn((WHISPER_B, cfg.encoder_seq, cfg.d_model),
                          generator=gen, device=device
                          ).to(model.act_dtype),)
    toks = _tokens(rng, cfg, WHISPER_B, WHISPER_PROMPT + WHISPER_STEPS,
                   device)
    ref, train_ms = train_ref(model, toks, frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        model.encode(frames[0])
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    timed, got = run_leg(model, toks, WHISPER_PROMPT, WHISPER_STEPS, frames)
    held = hold(got, ref, WHISPER_PROMPT, LOGIT_REL_TOL_BF16, "9.5")
    row = dict(config=cfg.name, leg="9.5",
               layers=f"{cfg.encoder_layers} + {cfg.num_layers}",
               frames=cfg.encoder_seq, train_ms=train_ms,
               encode_ms=encode_ms, **timed,
               check_token_match=hold_matches([held], "9.5"),
               **{f"check_{k}": v for k, v in held.items()})
    row = _finish(row, model, WHISPER_B)
    del model, ref, got
    release()
    return row


def model_only_phase(seed: int, device) -> dict:
    """Phase 9, in order: 9.1 the four model-only families at smoke size
    (float32, the card against the CPU), 9.2 DeepSeek-V2, 9.3 Jamba, 9.4
    Mamba2, 9.5 Whisper (bf16, full width).  The launch counters are 0
    before and after: none of these paths runs a kernel or a plain
    version of one."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 9)
    t0 = time.perf_counter()
    reset_counts()
    smoke = smoke_legs(device, seed)
    log(f"phase 9.1 done at {time.perf_counter() - t0:.1f} s")
    legs = []
    for leg in (deepseek_leg, jamba_leg, mamba_leg, whisper_leg):
        legs.append(leg(rng, device, seed))
        log(json.dumps({"model_only": legs[-1]}))
        log(f"phase {legs[-1]['leg']} done at "
            f"{time.perf_counter() - t0:.1f} s")
    counts = read_counts()
    check(not any(counts.values()),
          f"phase 9 launched a kernel or a plain version: {counts}")
    elapsed = time.perf_counter() - t0
    log(f"phase 9 done in {elapsed:.1f} s")
    return dict(smoke=smoke, legs=legs, counts=counts, elapsed_s=elapsed)


# --------------------------------------------------------------------------
# Phase 10: the trainer on the card
# --------------------------------------------------------------------------

# 10.1: every smoke config in float32, the card against the CPU, each step
# from the CPU's state before it; batch_at_step batches of 4 rows x 32
TRAIN_SMOKE_B, TRAIN_SMOKE_S, TRAIN_SMOKE_STEPS = 4, 32, 3
TRAIN_SMOKE_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
# the first step's gradients, each leaf as a share of its largest |g|
# (the SSD families sum a chunk's decays and states in other orders)
TRAIN_GRAD_TOL, TRAIN_GRAD_TOL_SSD = 1e-4, 1e-3
TRAIN_LOSS_TOL = 1e-5          # each step's loss, relative (the grad norm:
                               # the gradients' tolerance)
# 10.2: Granite-8B at full width and depth, bf16 parameters and moments,
# one row of train_4k's 4096 tokens a step, the first step untimed
GRANITE_TRAIN_STEPS = 6
GRANITE_STEP1_LOSS_TOL = 1e-6  # relative, against loss_fn under no_grad
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16, NVIDIA data sheet
# 10.3: the CLI on mamba2_370m whole (bf16 parameters, float32 moments),
# killed after 4 steps and resumed to 8 against 8 run through
RESUME_ARCH, RESUME_B, RESUME_S = "mamba2_370m", 2, 512
RESUME_KILL, RESUME_STEPS = 4, 8


def _opt_to(opt: dict, device) -> dict:
    return {"m": {k: t.to(device, copy=True) for k, t in opt["m"].items()},
            "v": {k: t.to(device, copy=True) for k, t in opt["v"].items()},
            "step": opt["step"].to(device, copy=True)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_smoke_legs(device, seed: int, card: str) -> list:
    """10.1: each smoke config in float32, drawn on the CPU from ``seed``:
    TRAIN_SMOKE_STEPS steps of ``make_train_step`` (accum_steps 1, then
    2) on `batch_at_step` batches, each step taken on the card from a copy
    of the CPU's model and state before it; the first step's gradients
    per leaf within `TRAIN_GRAD_TOL` of the leaf's largest |g| (SSD
    families `TRAIN_GRAD_TOL_SSD`), each step's loss within
    `TRAIN_LOSS_TOL` and grad norm within the gradients' tolerance, both
    relative."""
    import copy

    import torch

    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.data import DataConfig, batch_at_step, to_device
    from repro_torch.models.registry import api
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    ocfg = AdamWConfig(**TRAIN_SMOKE_OPT)
    rows = []
    for name in ARCH_IDS:
        cfg = get_smoke_config(name)
        tol = (TRAIN_GRAD_TOL_SSD if cfg.family in ("ssm", "hybrid")
               else TRAIN_GRAD_TOL)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SMOKE_S,
                          global_batch=TRAIN_SMOKE_B, seed=seed,
                          family=cfg.family, d_model=cfg.d_model,
                          vision_tokens=cfg.vision_tokens,
                          encoder_seq=cfg.encoder_seq)
        row = dict(config=cfg.name, family=cfg.family, grad_tol=tol)
        for accum in (1, 2):
            cpu = family_model(cfg, "cpu", seed)
            opt = adamw_init(ocfg, dict(cpu.named_parameters()))
            step = make_train_step(cfg, ocfg, accum_steps=accum)
            loss_err = norm_err = 0.0
            for k in range(TRAIN_SMOKE_STEPS):
                batch = batch_at_step(dcfg, k)
                gpu = copy.deepcopy(cpu).to(device)
                gopt = _opt_to(opt, device)
                if k == 0 and accum == 1:
                    grads = []
                    for model in (cpu, gpu):
                        named = dict(model.named_parameters())
                        for p in named.values():
                            p.requires_grad_(True)
                        loss = api(cfg).loss_fn(model, to_device(
                            batch, model.device))
                        g = torch.autograd.grad(loss, list(named.values()))
                        grads.append({n: t.detach().float().cpu()
                                      for n, t in zip(named, g)})
                    errs = {n: float((grads[1][n] - w).abs().max()
                                     / max(float(w.abs().max()), 1e-30))
                            for n, w in grads[0].items()}
                    worst = max(errs, key=errs.get)
                    check(errs[worst] <= tol,
                          f"10.1 {name}: the card's gradient of {worst} "
                          f"differs from the CPU's by {errs[worst]} of its "
                          f"largest |g| (> {tol})")
                    row.update(grad_rel_err=errs[worst], grad_worst=worst,
                               leaves=len(errs))
                _, _, mg = step(gpu, gopt, to_device(batch, device))
                _, opt, mc = step(cpu, opt, to_device(batch, "cpu"))
                le = _rel(float(mg["loss"]), float(mc["loss"]))
                ne = _rel(float(mg["grad_norm"]), float(mc["grad_norm"]))
                check(le <= TRAIN_LOSS_TOL and ne <= tol,
                      f"10.1 {name} accum {accum} step {k}: the card's loss "
                      f"/ grad norm differ from the CPU's by {le} / {ne} "
                      f"(> {TRAIN_LOSS_TOL} / {tol})")
                check(int(gopt["step"]) == k + 1, f"10.1 {name}: step count")
                loss_err, norm_err = max(loss_err, le), max(norm_err, ne)
            row[f"accum{accum}_loss_rel_err"] = loss_err
            row[f"accum{accum}_grad_norm_rel_err"] = norm_err
            row[f"accum{accum}_last_loss"] = float(mc["loss"])
            del gpu, gopt
        log(json.dumps({"train_smoke": row, "card": card}))
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def train_step_bound(cfg, n_params: int, seq: int) -> dict:
    """The least time of one bf16 train step over one row of ``seq``
    tokens: the operations (6 N T for the products; 6 L H hd S^2 for
    causal attention's two products, forward and back, half of the 12 L H
    hd S^2 a full square takes) over the card's dense bf16 rate, and the
    update's bytes (read p, g, m, v once, write p, m, v once: 14 bytes a
    parameter) over its memory rate; the larger of the two."""
    flops = (6 * n_params * seq + 6 * cfg.num_layers * cfg.num_heads
             * cfg.head_dim * seq * seq)
    nbytes = 14 * n_params
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, update_bytes=nbytes, ops_ms=ops_ms,
                bytes_ms=bytes_ms, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def granite_train_leg(device, seed: int):
    """10.2: Granite-8B at full width (``remat`` on, the config's
    default), bf16 parameters and moments (``AdamWConfig(state_dtype=
    "bfloat16")``), one `batch_at_step` row of 4096 tokens a step,
    GRANITE_TRAIN_STEPS steps, the first untimed.  Checks: every loss and
    grad norm finite; step 1's loss equals ``loss_fn`` under no_grad on
    the same batch and weights within GRANITE_STEP1_LOSS_TOL; after step
    1 every parameter moved by at most ``lr_1 (1 + wd |p|)`` plus one
    bf16 step (Adam's first step is +-1 a lane); the step counter 1.
    Returns (the row, the model, its optimizer state, step 1's batch) for
    phase 11.2-11.3."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at_step, to_device
    from repro_torch.models.registry import SHAPES, api
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_lr
    from repro_torch.train import make_train_step

    cfg = get_config("granite_8b")
    seq = SHAPES["train_4k"][0]
    ocfg = AdamWConfig(state_dtype="bfloat16")
    model = family_model(cfg, device, seed)
    params = dict(model.named_parameters())
    opt = adamw_init(ocfg, params)
    step = make_train_step(cfg, ocfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=1,
                      seed=seed)
    batches = [to_device(batch_at_step(dcfg, k), device)
               for k in range(GRANITE_TRAIN_STEPS)]
    with torch.no_grad():
        ref_loss = float(api(cfg).loss_fn(model, batches[0]))
    before = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, mets = [], []
    for k in range(GRANITE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, met = step(model, opt, batches[k])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        mets.append({key: float(v) for key, v in met.items()})
        check(all(map(math.isfinite, mets[-1].values())),
              f"10.2 step {k + 1}: {mets[-1]}")
        if k == 0:
            moved = step1_moves(params, before, ocfg, cosine_lr(ocfg, 1))
            before = None
            check(int(opt["step"]) == 1, "10.2: the step counter is not 1")
            check(_rel(mets[0]["loss"], ref_loss) <= GRANITE_STEP1_LOSS_TOL,
                  f"10.2: step 1's loss {mets[0]['loss']} != loss_fn's "
                  f"{ref_loss}")
    peak = torch.cuda.max_memory_allocated()
    n = model.param_count()
    step_ms = statistics.median(ms[1:])
    bound = train_step_bound(cfg, n, seq)
    row = dict(config=cfg.name, layers=cfg.num_layers, params=n, tokens=seq,
               remat=cfg.remat, state_dtype=ocfg.state_dtype,
               step_ms=step_ms, first_step_ms=ms[0], steps_ms=ms,
               tokens_per_s=seq / step_ms * 1e3, peak_bytes=peak,
               loss=[m["loss"] for m in mets],
               grad_norm=[m["grad_norm"] for m in mets],
               lr=[m["lr"] for m in mets], step1_ref_loss=ref_loss,
               **moved, **bound, share_of_bound=bound["bound_ms"] / step_ms)
    return row, model, opt, batches[0]


def step1_moves(params: dict, before: dict, ocfg, lr1) -> dict:
    """Every parameter after AdamW's first step against its value before
    (``before``, on the host): |p1 - p0| <= lr_1 (1 + wd |p0|) + one bf16
    step of max(|p0|, |p1|) (the first moment over the root of the second
    is +-1 up to float32 rounding: 1e-5 of slack on the first term).
    Returns the largest move and the share of elements that moved."""
    import torch

    lr1 = float(lr1)
    worst, moved, total = 0.0, 0, 0
    for k, p in params.items():
        p0 = before[k].to(p.device).float()
        p1 = p.detach().float()
        d = (p1 - p0).abs()
        mag = torch.maximum(p0.abs(), p1.abs())
        ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(
            mag, min=torch.finfo(torch.float32).tiny))) - 7)
        limit = lr1 * (1 + ocfg.weight_decay * p0.abs()) * (1 + 1e-5) + ulp
        bad = int((d > limit).sum())
        check(bad == 0, f"10.2: {bad} elements of {k} moved more than "
                        f"lr_1 (1 + wd |p|) + one bf16 step at step 1")
        worst = max(worst, float(d.max()))
        moved += int((d > 0).sum())
        total += d.numel()
    return dict(step1_lr=lr1, step1_max_move=worst,
                step1_moved_share=moved / total)


def _param_digests(code_out: str) -> dict:
    """The per-leaf digests a `resume_run` printed on its last line."""
    return json.loads(code_out.strip().splitlines()[-1])["digests"]


RESUME_CODE = r'''
import hashlib, json, sys
import torch
from repro_torch.launch import train as TR
model = TR.main(sys.argv[1:])
out = {}
for k, p in model.named_parameters():
    t = p.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    out[k] = hashlib.sha256(t.numpy().tobytes()).hexdigest()
print(json.dumps({"digests": out}))
'''


def resume_run(args: list, env: dict):
    """Start the CLI (`launch.train.main` with ``args``) in a process of its
    own, which prints a digest of each final parameter's bits."""
    return subprocess.Popen(
        [sys.executable, "-c", RESUME_CODE, *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, where: str, timeout: int = 600) -> str:
    """Wait for ``proc`` (killed past ``timeout``); its standard output,
    or a `SmokeError` with the end of its errors if it failed."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeError(f"{where}: the run did not end in {timeout} s")
    check(proc.returncode == 0, f"{where} failed:\n{err[-4000:]}")
    return out


def resume_leg() -> dict:
    """10.3: the CLI on `RESUME_ARCH` whole: RESUME_STEPS steps run
    through (in parallel with the next run), against RESUME_KILL steps
    with a checkpoint, then ``--resume`` to RESUME_STEPS, each in a process
    of its own; every final parameter equal bit for bit (sha256 of its
    bits).  The checkpoints (bf16 parameters as ``<V2`` leaves, float32
    moments) live in a temporary directory under ``build/``, removed
    afterwards; the first step's (step 1) is removed before the resume."""
    import os
    import shutil
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = ["--arch", RESUME_ARCH, "--batch", str(RESUME_B), "--seq",
            str(RESUME_S), "--log-every", "1"]
    (ROOT / "build").mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="resume_", dir=ROOT / "build"))
    ck = ["--ckpt-dir", str(d), "--ckpt-every", "100"]
    t0 = time.perf_counter()
    procs = []
    try:
        procs.append(resume_run(base + ["--steps", str(RESUME_STEPS)], env))
        procs.append(resume_run(base + ["--steps", str(RESUME_KILL)] + ck,
                                env))
        finish(procs[1], "10.3 the killed run")
        saved = sorted(p.name for p in d.glob("step_*"))
        check(saved[-1] == f"step_{RESUME_KILL:08d}",
              f"10.3: checkpoints {saved}")
        size = sum(f.stat().st_size for f in (d / saved[-1]).iterdir())
        shutil.rmtree(d / saved[0])
        procs.append(resume_run(base + ["--steps", str(RESUME_STEPS),
                                        "--resume"] + ck, env))
        out_rest = finish(procs[2], "10.3 the resumed run")
        out_whole = finish(procs[0], "10.3 the run through")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(d, ignore_errors=True)
    check(f"resumed from step {RESUME_KILL}" in out_rest,
          "10.3: the second run did not resume")
    a, b = _param_digests(out_whole), _param_digests(out_rest)
    differ = sorted(k for k in a if a[k] != b.get(k))
    check(set(a) == set(b) and not differ,
          f"10.3: killed + resumed differs from the run through in "
          f"{len(differ)} of {len(a)} parameters: {differ[:8]}")
    return dict(config=RESUME_ARCH, batch=RESUME_B, seq=RESUME_S,
                steps=RESUME_STEPS, killed_at=RESUME_KILL,
                params_equal=len(a), checkpoint_bytes=size,
                log=[line for line in out_whole.splitlines()
                     if line.startswith("[train] step")],
                elapsed_s=time.perf_counter() - t0)


def train_phase(seed: int, device) -> dict:
    """Phase 10, in order: 10.1 the smoke configs card against CPU, 10.2
    Granite-8B at full width (with phase 11.2-11.3 on its model: the
    dry-run's predictions before it is built, the counted train and
    decode steps after its timed steps), 10.3 kill and resume through the
    CLI.  The launch counters are 0 before and after: the trainer runs no
    kernel of the repo (JAX's trainer has no Pallas call)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    t0 = time.perf_counter()
    reset_counts()
    smoke = train_smoke_legs(device, seed, card)
    log(f"phase 10.1 done at {time.perf_counter() - t0:.1f} s")
    predicted = granite_predictions(card)
    granite, model, opt, batch = granite_train_leg(device, seed)
    log(json.dumps({"train_granite": granite, "card": card}))
    log(f"phase 10.2 done at {time.perf_counter() - t0:.1f} s")
    dry = {"train": counted_train_step(model, opt, batch, predicted["train"],
                                       granite, card)}
    del opt, batch
    release()
    dry["decode"] = counted_decode_step(model, predicted["decode"], card)
    del model
    release()
    log(f"phase 11.2-11.3 done at {time.perf_counter() - t0:.1f} s")
    resume = resume_leg()
    log(json.dumps({"train_resume": resume, "card": card}))
    counts = read_counts()
    check(not any(counts.values()),
          f"phase 10 launched a kernel or a plain version: {counts}")
    elapsed = time.perf_counter() - t0
    log(f"phase 10 done in {elapsed:.1f} s ({card})")
    return dict(card=card, smoke=smoke, granite=granite, resume=resume,
                dryrun=dry, counts=counts, elapsed_s=elapsed)

# --------------------------------------------------------------------------
# phase 11: the dry-run (launch.dryrun) against the card
# --------------------------------------------------------------------------

# 11.1: the cells counted on the host (the whole sweep, 32 cells, takes
# most of an hour of host time; these cover every family and every step
# kind in under a minute)
DRYRUN_CELLS = tuple((a, "decode_32k") for a in (
    "jamba_1_5_large_398b", "mamba2_370m", "qwen1_5_110b", "starcoder2_15b",
    "mistral_nemo_12b", "granite_8b", "internvl2_2b", "whisper_base",
    "phi3_5_moe_42b", "deepseek_v2_236b")) + (
    ("mamba2_370m", "long_500k"), ("jamba_1_5_large_398b", "long_500k"),
    ("whisper_base", "train_4k"), ("whisper_base", "prefill_32k"))
DRYRUN_SMOKE = (2, 24, 32)     # 11.1's smoke steps: rows, tokens, cache
DRYRUN_PEAK_TOL = 0.05         # 11.2-11.3: card peak against the predicted
DECODE_ROWS = 8                # 11.3: decode_32k's 128 rows cut to 8
AUTO_SHARDS = 8                # 11.4: the forest's shards (phase 6's most)
AUTO_REPS = 3                  # 11.4: timed search batches an engine


def dryrun_summary(rec: dict) -> dict:
    """What 11.1-11.3 print of a dry-run record."""
    rf = rec["roofline"]
    return dict(arch=rec["arch"], shape=rec["shape"], kind=rec["step_kind"],
                batch=rec["batch"], accum_steps=rec["accum_steps"],
                peak_gb=rec["memory"]["peak_bytes"] / 1e9,
                argument_gb=rec["memory"]["argument_size_bytes"] / 1e9,
                flops=rec["cost_analysis"]["flops"],
                bytes=rec["cost_analysis"]["bytes accessed"],
                compute_ms=rf["compute_s"] * 1e3,
                memory_ms=rf["memory_s"] * 1e3, bottleneck=rf["bottleneck"],
                useful_flops_ratio=rf["useful_flops_ratio"],
                ops=rec["ops"], count_s=rec["compile_s"])


def granite_predictions(card: str) -> dict:
    """11.2-11.3's predictions, counted on the meta device before 10.2's
    model exists: phase 10.2's train step (train_4k at one row,
    accum_steps 1, the config's ``remat``, bf16 parameters and moments)
    and a dense decode_32k step at DECODE_ROWS rows.  Returns (record,
    `Count`) by kind."""
    from repro_torch.launch.dryrun import lower_cell

    out = {}
    for kind, shape, rows in (("train", "train_4k", 1),
                              ("decode", "decode_32k", DECODE_ROWS)):
        out[kind] = lower_cell("granite_8b", shape, "card1",
                               accum_steps=1,
                               batch_override=rows)
        log(json.dumps({"dryrun_prediction": dryrun_summary(out[kind][0]),
                        "card": card}))
    return out


def card_count(fn, device, where: str) -> tuple:
    """``fn()`` on the card under the dry-run's counters (FLOPs and bytes;
    the peak from the allocator, its statistics reset just before).
    Returns (fn's result, the `Count`, the peak bytes, the bytes
    allocated at the start, the host ms)."""
    import torch

    from repro_torch.analysis.count import count

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out, c = count(fn, live=False, device=device.type)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"{where}: {c.ops} ops counted on the card in {ms:.1f} ms")
    return out, c, peak, start, ms


def op_diff(a: dict, b: dict) -> dict:
    """The ops two counts dispatched a different number of times."""
    return {k: (a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


def held_to_prediction(rec: dict, meta, c, peak: int, start: int,
                       where: str) -> dict:
    """The card's count against the record (and ``meta``, its `Count`):
    FLOPs and bytes equal, the peak within DRYRUN_PEAK_TOL of the
    predicted."""
    pred = rec["memory"]["peak_bytes"]
    row = dict(predicted_flops=rec["cost_analysis"]["flops"],
               card_flops=float(c.flops),
               predicted_bytes=rec["cost_analysis"]["bytes accessed"],
               card_bytes=float(c.bytes), predicted_peak=pred,
               card_peak=peak, peak_rel_err=(peak - pred) / pred,
               predicted_arguments=rec["memory"]["argument_size_bytes"],
               card_allocated_at_start=start,
               compute_ms=rec["roofline"]["compute_s"] * 1e3,
               memory_ms=rec["roofline"]["memory_s"] * 1e3,
               bottleneck=rec["roofline"]["bottleneck"])
    log(json.dumps({where: row}))
    if c.by_op != meta.by_op:
        log(f"{where}: ops apart (meta, card): "
            f"{op_diff(meta.by_op, c.by_op)}")
    check(row["card_flops"] == row["predicted_flops"],
          f"{where}: the card's FLOPs {c.flops} != the dry-run's "
          f"{row['predicted_flops']}")
    check(row["card_bytes"] == row["predicted_bytes"],
          f"{where}: the card's bytes {c.bytes} != the dry-run's "
          f"{row['predicted_bytes']}")
    check(abs(row["peak_rel_err"]) <= DRYRUN_PEAK_TOL,
          f"{where}: the card's peak {peak} is {row['peak_rel_err']:+.4f} "
          f"of the predicted {pred} (> {DRYRUN_PEAK_TOL})")
    return row


def counted_train_step(model, opt, batch, pred: tuple, granite: dict,
                       card: str) -> dict:
    """11.2: one more step of 10.2 (its model, optimizer state and step
    1's batch) under the dry-run's counters, held to the prediction; the
    roofline's terms beside 10.2's median step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import step_call

    fn, _ = step_call(get_config("granite_8b"), "train", model, batch, opt)
    (_, _, met), c, peak, start, ms = card_count(fn, model.device, "11.2")
    check(math.isfinite(float(met["loss"])), f"11.2: loss {met['loss']}")
    row = held_to_prediction(*pred, c, peak, start, "11.2")
    row.update(card=card, step_ms=granite["step_ms"], counted_step_ms=ms,
               loss=float(met["loss"]),
               roofline_ms=max(row["compute_ms"], row["memory_ms"]),
               step_share_of_roofline=max(row["compute_ms"],
                                          row["memory_ms"])
               / granite["step_ms"],
               measured_peak_10_2=granite["peak_bytes"])
    log(json.dumps({"dryrun_train": row}))
    del met
    torch.cuda.empty_cache()
    return row


def materialize(specs, device):
    """`input_specs`'s meta tensors as zeros of the same shapes on
    ``device``."""
    import torch

    if isinstance(specs, dict):
        return {k: materialize(v, device) for k, v in specs.items()}
    if isinstance(specs, list):
        return [materialize(v, device) for v in specs]
    return torch.zeros(specs.shape, dtype=specs.dtype, device=device)


def counted_decode_step(model, pred: tuple, card: str) -> dict:
    """11.3: one dense decode step of 10.2's model at decode_32k's shapes
    cut to DECODE_ROWS rows (zero caches, every row at the cache's last
    position), under the dry-run's counters, held to the prediction; its
    logits finite."""
    import torch

    from repro_torch.launch.dryrun import step_call
    from repro_torch.models.registry import SHAPES, input_specs

    cfg = model.cfg
    seq = SHAPES["decode_32k"][0]
    _, specs = input_specs(cfg, "decode_32k", DECODE_ROWS)
    inputs = materialize(specs, model.device)
    inputs["length"].fill_(seq - 1)
    fn, _ = step_call(cfg, "decode", model, inputs)
    (logits, _), c, peak, start, ms = card_count(fn, model.device, "11.3")
    check(tuple(logits.shape) == (DECODE_ROWS, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"11.3: logits {tuple(logits.shape)} not finite")
    row = held_to_prediction(*pred, c, peak, start, "11.3")
    row.update(card=card, rows=DECODE_ROWS, cache_tokens=seq,
               counted_step_ms=ms,
               cache_gb=sum(t.numel() * t.element_size()
                            for layer in inputs["caches"]
                            for t in layer.values()) / 1e9)
    log(json.dumps({"dryrun_decode": row}))
    del logits, inputs, fn
    return row


def smoke_step(cfg, kind: str, device):
    """(the step's closure, its arguments) of a DRYRUN_SMOKE-size step of
    ``kind`` on ``device`` (`launch.dryrun.smoke_inputs`)."""
    from repro_torch.launch.dryrun import smoke_inputs, step_call

    model, inputs, opt = smoke_inputs(cfg, kind, device, *DRYRUN_SMOKE)
    return step_call(cfg, kind, model, inputs, opt, accum_steps=2)


def smoke_counts(device, card: str) -> list:
    """11.1: at every smoke config (``remat`` on, as the full configs
    have it; train at accum_steps 2) and step kind, the meta count equals
    the count of the same step on the card: FLOPs, bytes and ops."""
    import torch

    from repro_torch.analysis.count import count
    from repro_torch.configs import ARCH_IDS, get_smoke_config

    rows = []
    for name in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(name), remat=True)
        for kind in ("train", "prefill", "decode"):
            meta = count(*smoke_step(cfg, kind, "meta"), device="meta")[1]
            fn, _ = smoke_step(cfg, kind, device)
            got = count(fn, live=False, device=torch.device(device).type)[1]
            torch.cuda.synchronize()
            row = dict(config=cfg.name, kind=kind, flops=meta.flops,
                       bytes=meta.bytes, ops=meta.ops,
                       card=(got.flops, got.bytes, got.ops))
            check((got.flops, got.bytes, got.ops)
                  == (meta.flops, meta.bytes, meta.ops),
                  f"11.1 {name} {kind}: the card counts {row['card']}, the "
                  f"meta device {(meta.flops, meta.bytes, meta.ops)}; ops "
                  f"apart: {op_diff(meta.by_op, got.by_op)}")
            rows.append(row)
    log(json.dumps({"dryrun_smoke": len(rows), "card": card}))
    return rows


def auto_engine_leg(keys, rng, device, card: str) -> list:
    """11.4: a search batch of BATCH keys on phase 3's tree under each
    engine (``deltatree``, and the ``forest`` at AUTO_SHARDS shards on the
    same keys): the median of AUTO_REPS timed batches after an untimed
    one, the engines' found columns equal; the faster engine must be
    ``core.engine.AUTO_TABLE``'s row, and ``make_index(...,
    engine="auto")`` on the card must resolve to it."""
    import numpy as np
    import torch

    from repro_torch.api import make_index
    from repro_torch.core.engine import AUTO_TABLE

    q = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
    small = keys[:4096]
    rows = []
    for backend, kw in (
            ("deltatree", fig12_config(keys.size)),
            ("forest", dict(forest_config(keys.size, AUTO_SHARDS),
                            key_max=KEY_MAX))):
        ms, found = {}, {}
        for engine in ("lockstep", "scalar"):
            ix = make_index(backend, initial=keys, engine=engine,
                            device=device, **kw)
            found[engine] = ix.search(q)[0].cpu().numpy()
            times = [timed(lambda: ix.search(q))[1]
                     for _ in range(AUTO_REPS)]
            ms[engine] = statistics.median(times) * 1e3
            del ix
            torch.cuda.empty_cache()
        check((found["lockstep"] == found["scalar"]).all(),
              f"11.4 {backend}: the engines' searches differ")
        winner = min(ms, key=ms.get)
        auto = make_index(backend, initial=small, engine="auto",
                          device=device, **kw).engine
        row = dict(backend=backend, batch=BATCH, keys=int(keys.size),
                   lockstep_ms=ms["lockstep"], scalar_ms=ms["scalar"],
                   winner=winner, table=AUTO_TABLE.get((backend, "cuda")),
                   auto=auto, card=card)
        log(json.dumps({"auto_engine": row}))
        check(winner == row["table"] == auto,
              f"11.4 {backend}: {winner} reads faster, the table names "
              f"{row['table']}, auto resolved to {auto}")
        rows.append(row)
    return rows


def dryrun_phase(keys, seed: int, device) -> dict:
    """Phase 11.1 and 11.4 (11.2-11.3 run inside phase 10, on its
    Granite-8B): the dry-run over DRYRUN_CELLS on the host, each record's
    peak, FLOPs, bytes and bottleneck printed; the smoke steps' meta
    counts against the card's; the engine="auto" timings.  No kernel of
    the repo runs in 11.1-11.3 (their counters stay 0); 11.4's lockstep
    reads launch the fused walk."""
    import numpy as np

    from repro_torch.launch.dryrun import run_cell

    card = card_name()
    t0 = time.perf_counter()
    reset_counts()
    sweep = []
    for arch, shape in DRYRUN_CELLS:
        rec = run_cell(arch, shape, "card1")
        check(rec["status"] == "ok", f"11.1 {arch} {shape}: {rec}")
        sweep.append(dryrun_summary(rec))
        log(json.dumps({"dryrun": sweep[-1], "card": card}))
    sweep_s = time.perf_counter() - t0
    log(f"phase 11.1 sweep of {len(sweep)} cells in {sweep_s:.1f} s")
    smoke = smoke_counts(device, card)
    counts = read_counts()
    check(not any(counts.values()),
          f"phase 11.1 launched a kernel or a plain version: {counts}")
    auto = auto_engine_leg(keys, np.random.default_rng(seed + 11), device,
                           card)
    elapsed = time.perf_counter() - t0
    log(f"phase 11 done in {elapsed:.1f} s ({card})")
    return dict(card=card, sweep=sweep, sweep_s=sweep_s, smoke=smoke,
                auto=auto, elapsed_s=elapsed)


# --------------------------------------------------------------------------
# phase 12: the DeltaForest over torch.distributed ranks sharing the card
# --------------------------------------------------------------------------

RANKS = (2, 4)                  # gloo ranks sharing the one card
RANKS_SHARDS = 8                # phase 6's S = 8 forest
RANKS_PAGER = 4                 # the ranks the pager leg runs on
RANKS_PAGER_STEPS = 24          # pager script steps
RANKS_TIMEOUT = 600             # seconds one spawn may take
RANKS_TIMED_OPS = 25_000        # a rank's timed batch-1024 stream (6.2: 100,000)
RANKS_LABEL = ("one card shared by {r} processes, gloo: not a multi-card "
               "number")


def ranks_exact(ix0, rng, pre: str, rec: dict) -> dict:
    """Phase 12 on one forest, as every rank and the single process run
    it: 6.1's read batch (`forest_read_batch`) on the built forest, after
    each of ``FOREST_CHECK_STEPS`` update batches (50 % updates) and under
    ``deferred`` after clustered inserts, then ``flush``; each result
    against the oracle and recorded under ``pre``.  Returns the legs'
    launch counts (walk and scan launched, no plain version)."""
    import numpy as np

    from repro_torch.api import OpBatch
    from repro_torch.distributed import router as R

    bits = ix0.cfg.tree.payload_bits
    ix = copy_index(ix0)
    oracle = dict(ix0.live_items())

    def live_pays():
        live = np.asarray(sorted(oracle), np.int64)
        return live, np.asarray([oracle[k] for k in live.tolist()], np.int64)

    def reads(ix, tag):
        live, pays = live_pays()
        q = forest_query_batch(rng, ix, live)
        bands = forest_bands(rng, live)
        got = forest_read_batch(ix, q, bands)
        oracle_reads(got, live, pays, q, bands, bits, f"{pre}, {tag}")
        for name, cols in zip(FOREST_READS, got):
            for i, col in enumerate(cols):
                rec[f"{pre}/{tag}/{name}/{i}"] = col.cpu().numpy()

    reset_counts()
    reads(ix, "built")
    for step in range(FOREST_CHECK_STEPS):
        live, _ = live_pays()
        kinds = mixed_kinds(rng, FOREST_CHECK_K, 50)
        keys = rng.integers(1, FOREST_KEY_MAX, FOREST_CHECK_K).astype(np.int32)
        keys[:64] = rng.choice(live, 64)
        pp = (keys % 4096).astype(np.int32)
        want = oracle_update(oracle, kinds, keys, pp, bits)
        ix, res, st = ix.update(OpBatch.mixed(kinds, keys, pp))
        check((res.cpu().numpy() == want).all(),
              f"{pre}: update results differ from the oracle at {step}")
        rec[f"{pre}/{step}/res"] = res.cpu().numpy()
        rec[f"{pre}/{step}/stats"] = np.asarray(list(st))
        reads(ix, f"step {step}")
    live, _ = live_pays()
    qf = copy_index(ix, maintenance="deferred")
    runs = (rng.choice(live, FOREST_CHECK_K // 8)[:, None]
            + np.arange(1, 9)).reshape(-1).astype(np.int32)
    ones = np.ones(runs.size, np.int32)
    pr = (runs % 4096).astype(np.int32)
    want = oracle_update(oracle, ones, runs, pr, bits)
    qf, res, st = qf.update(OpBatch.mixed(ones, runs, pr))
    check((res.cpu().numpy() == want).all(), f"{pre}: deferred inserts")
    buffered = int((R.gather_shards(ix0.cfg.num_shards,
                                    qf.state.trees.bcount.sum(1)) > 0).sum())
    check(st.pending > 0 and buffered >= 2,
          f"{pre}: the deferred batch left {st.pending} items buffered in "
          f"{buffered} shards")
    rec[f"{pre}/deferred/stats"] = np.asarray(list(st))
    reads(qf, "deferred")
    qf, fst = qf.flush()
    check(fst.pending == 0 and qf.live_items() == sorted(oracle.items())
          and not qf.alloc_failed(), f"{pre}: deferred flush")
    rec[f"{pre}/flush/stats"] = np.asarray(list(fst))
    rec[f"{pre}/size"] = np.asarray(qf.size())
    counts = read_counts()
    check(counts["fused"] > 0 and counts["scan"] > 0 and counts["plain"] == 0,
          f"{pre}: launches {counts}")
    return counts


def ranks_pager(seed: int, device, rec: dict) -> dict:
    """A ``ShardedPagerConfig(num_shards=4)`` pager (lockstep) through a
    seeded script: each step allocates blocks for 8 sequences, every third
    frees two, then reads every live sequence's block table, which must
    list the pages ``allocate`` returned (-1 past them); the tables are
    recorded.  Returns the script's launch counts."""
    import numpy as np

    from repro_torch.serving import ShardedDeltaPager, ShardedPagerConfig

    pg = ShardedDeltaPager(ShardedPagerConfig(num_shards=SHARDED_SHARDS,
                                              engine="lockstep"),
                           device=device)
    rng = np.random.default_rng(seed + 120)
    pages: dict = {}
    reset_counts()
    for step in range(RANKS_PAGER_STEPS):
        for sid in rng.choice(64, 8, replace=False).tolist():
            pages.setdefault(sid, []).extend(
                pg.allocate(sid, int(rng.integers(1, 9))))
        if step % 3 == 2:
            for sid in rng.choice(sorted(pages), 2, replace=False).tolist():
                pg.free_seq(sid)
                del pages[sid]
        sids = sorted(pages)
        width = max(len(v) for v in pages.values())
        bt = pg.block_tables(sids, width).cpu().numpy()
        want = np.full((len(sids), width), -1, bt.dtype)
        for row, sid in enumerate(sids):
            want[row, :len(pages[sid])] = pages[sid]
        check((bt == want).all(), f"pager step {step}: block tables")
        rec[f"pager/{step}"] = bt
    counts = read_counts()
    check(counts["fused"] > 0 and counts["plain"] == 0,
          f"pager: launches {counts}")
    return counts


def ranks_legs(seed: int, device, pager: bool) -> dict:
    """Everything phase 12 runs, by every rank and, as the reference, by
    the single process: phase 6's keys (``forest_config(n, 8)``) in set
    and map mode (``payload_bits=12``) through `ranks_exact`, with
    ``pager`` `ranks_pager`, and in a rank (a process group is up) 6.2's
    batch-1024 stream over ``RANKS_TIMED_OPS`` through `forest_run`,
    timed.  Returns the record (numpy arrays; the ``timed/`` keys,
    ``launches`` and ``seconds`` are this process's own)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.api import make_index

    t0 = time.perf_counter()
    keys = np.unique(np.random.default_rng(seed + 6).integers(
        1, FOREST_KEY_MAX, FOREST_INITIAL).astype(np.int32))
    rng = np.random.default_rng(seed + 12)
    rec: dict = {}
    fused = scan = 0
    for bits in (0, 12):
        ix = make_index("forest", initial=keys,
                        payloads=keys % 4096 if bits else None,
                        engine="lockstep", device=device, payload_bits=bits,
                        **forest_config(keys.size, RANKS_SHARDS))
        c = ranks_exact(ix, rng, "map" if bits else "set", rec)
        fused, scan = fused + c["fused"], scan + c["scan"]
        if not bits and dist.is_initialized():
            row = forest_run(copy_index(ix), forest_traffic(
                seed, BATCH, keys, RANKS_TIMED_OPS), "phase 12 timed")
            check(row["walk_launches_per_search"] == 1,
                  f"phase 12: {row['walk_launches_per_search']} walk "
                  "launches a search batch")
            fused += row["counts"]["fused"]
            for k in ("search_ms", "update_ms", "ops_per_s"):
                rec[f"timed/{k}"] = np.asarray(row[k])
        del ix
    if pager:
        fused += ranks_pager(seed, device, rec)["fused"]
    rec["launches"] = np.asarray([fused, scan])
    rec["seconds"] = np.asarray(time.perf_counter() - t0)
    return rec


def ranks_child(rank: int, world: int, out_dir: str, seed: int,
                device: str) -> None:
    """One rank of phase 12: joins a gloo group of ``world`` processes
    sharing ``device``, runs `ranks_legs` and saves its record."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import start_process_group

    torch.set_num_threads(1)
    start_process_group("gloo", rank=rank, world_size=world,
                        init_method=f"file://{out_dir}/store")
    try:
        rec = ranks_legs(seed, torch.device(device), world == RANKS_PAGER)
        np.savez(f"{out_dir}/rank{rank}.npz", **rec)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, seed: int, device) -> list:
    """`ranks_child` on ``world`` processes (spawned: each starts its own
    CUDA context on the card); returns each rank's record.  A rank that
    raises, or a run past ``RANKS_TIMEOUT``, fails the phase (every rank
    is stopped)."""
    import shutil

    import numpy as np
    import torch.multiprocessing as mp

    out = ROOT / "build" / f"chip_ranks_{world}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ctx = mp.start_processes(ranks_child,
                             args=(world, str(out), seed, str(device)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT
    try:
        while not ctx.join(timeout=1):
            check(time.monotonic() < deadline,
                  f"phase 12: {world} ranks ran past {RANKS_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(5)
    recs = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            recs.append({k: z[k] for k in z.files})
    shutil.rmtree(out, ignore_errors=True)
    return recs


def ranks_phase(seed: int, device, forest: dict) -> dict:
    """Phase 12: the S = 8 forest at phase 6's size spread over R = 2 and
    R = 4 gloo processes sharing the card (each building its own S / R
    shards and launching kernels 2 and 3 on them), against the same legs
    in this process: every rank's reads, update results and stats,
    flushes and sizes equal the single process's bit for bit (and the
    oracle, in every process); the sharded pager's block tables at R = 4
    likewise.  Each rank's launch counts (kernels 2 and 3 above 0, no
    plain version) and batch-1024 search / update medians, beside phase
    6.2's at S = 8."""
    import torch

    card = card_name()
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    single = ranks_legs(seed, device, pager=True)
    grid = next(p for p in forest["grid"]
                if p["shards"] == RANKS_SHARDS and p["batch"] == BATCH)
    log(f"phase 12 single process done at {time.perf_counter() - t0:.1f} s")
    own = ("timed/", "launches", "seconds")
    rows = []
    for world in RANKS:
        ts = time.perf_counter()
        recs = spawn_ranks(world, seed, device)
        spawn_s = time.perf_counter() - ts
        for r, rec in enumerate(recs):
            want = {k for k in single if not k.startswith(own)
                    and (world == RANKS_PAGER or not k.startswith("pager/"))}
            got = {k for k in rec if not k.startswith(own)}
            check(got == want, f"phase 12, R={world}, rank {r}: recorded "
                               f"{sorted(got ^ want)[:5]} apart")
            for k in want:
                a, b = rec[k], single[k]
                check(a.dtype == b.dtype and a.shape == b.shape
                      and (a == b).all(),
                      f"phase 12, R={world}, rank {r}: {k} differs from "
                      "the single process")
            check(rec["launches"][0] > 0 and rec["launches"][1] > 0,
                  f"phase 12, R={world}, rank {r}: launches "
                  f"{rec['launches'].tolist()}")
        row = dict(card=card, ranks=world, shards=RANKS_SHARDS,
                   backend="gloo", label=RANKS_LABEL.format(r=world),
                   batch=BATCH,
                   search_ms=[float(x["timed/search_ms"]) for x in recs],
                   update_ms=[float(x["timed/update_ms"]) for x in recs],
                   ops_per_s=[float(x["timed/ops_per_s"]) for x in recs],
                   phase6_search_ms=grid["fused"]["search_ms"],
                   phase6_update_ms=grid["fused"]["update_ms"],
                   walk_launches=[int(x["launches"][0]) for x in recs],
                   scan_launches=[int(x["launches"][1]) for x in recs],
                   rank_seconds=[float(x["seconds"]) for x in recs],
                   spawn_s=spawn_s, pager=world == RANKS_PAGER)
        log(json.dumps({"forest_ranks": row}))
        rows.append(row)
    elapsed = time.perf_counter() - t0
    log(f"phase 12 done in {elapsed:.1f} s ({card})")
    return dict(card=card, rows=rows, single_seconds=float(single["seconds"]),
                launches={str(r["ranks"]): dict(fused=r["walk_launches"],
                                                scan=r["scan_launches"])
                          for r in rows},
                elapsed_s=elapsed)


# --------------------------------------------------------------------------
# phase 13: the sharded trainer over torch.distributed ranks sharing the card
# --------------------------------------------------------------------------

TP_MESH = (2, 2)                # ("data", "model") of 13.1
TP_RANKS = TP_MESH[0] * TP_MESH[1]
TP_LAYERS = 2                   # Granite-8B's 36 layers cut to 2
TP_ROWS, TP_SEQ = 2, 4096       # one row of 4096 tokens a data rank
TP_STEPS = 3
TP_OPT = dict(lr=1e-3, state_dtype="float32")   # tests/test_parallel.py's
TP_LOSS_TOL, TP_LEAF_TOL = 1e-4, 5e-3           # and its bounds
TP_GNORM_RTOL = 1e-4            # of the oracle's gradient norm
TP_GRAD_RTOL = 1e-3             # of a leaf's largest first moment
SPLITK_MESH = (1, TP_RANKS)     # 13.2-13.3: "model" over the 4 ranks
SPLITK_SHAPE = dict(B=8, H=32, KVH=8, D=128, S=32768)  # decode_32k's heads
SPLITK_TOL = 1e-5
SPLITK_REPS = 5
TP_PMEAN_LEAF = "layers.0.mixer.wq"
TP_RESTORE_MESH = (2, 1)        # 13.4: onto ranks 0-1
TP_TIMEOUT = 600
TP_COUNT_STEP = TP_STEPS - 1    # 13.1's counted step (not in its times)
TP_BUDGET_S = 200               # phase 13, spawn included
TP_SERVE_ROWS, TP_SERVE_PROMPT = 2, 512    # 13.5: a prefill of 2 x 512,
TP_SERVE_DECODE, TP_SERVE_CACHE = 8, 1024  # 8 decode steps, caches of 1024
TP_SERVE_TOL = 1e-4            # of the largest |logit| / |cache value|
# 13.6: (arch, config override, the cut as printed, rows, tokens)
MIXER_CELLS = (
    ("deepseek_v2_236b", dict(num_layers=1),
     "cut to its dense prologue layer (MLA + dense FFN), 1 of 60", 2, 1024),
    ("mamba2_370m", dict(num_layers=4), "cut to 4 of 48 layers", 2, 1024),
    ("whisper_base", {}, "whole (6 + 6 layers, 1500 frames)", 2, 448))
MIXER_STEPS = 1   # 13.1 takes 3; one here keeps the script in its time limit


def collective_mode():
    """A dispatch mode that counts the collective ops run under it by name
    (``c10d.*`` are `parallel.comm`'s, ``_c10d_functional.*`` would be
    DTensor's own).  CommDebugMode does the same but its module tracker
    fails under activation checkpointing's recompute."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ns = func.namespace
            if ns in ("c10d", "_c10d_functional", "c10d_functional"):
                self.counts[f"{ns}.{func.__name__}"] += 1
            return func(*args, **(kwargs or {}))

    return Count()


def tp_config():
    """Granite-8B at full width, 2 of its 36 layers, float32 parameters
    and activations (so the sharded step's equality means something)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("granite_8b"), num_layers=TP_LAYERS,
                               dtype="float32", param_dtype="float32")


def mixer_config(arch: str, over: dict):
    """13.6's config of ``arch``: float32 parameters and activations,
    ``over`` (its cut) applied."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), dtype="float32",
                               param_dtype="float32", **over)


def mixer_batches(cfg, rows: int, seq: int, seed: int) -> list:
    from repro_torch.data import DataConfig, batch_at_step, to_device

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=rows, seed=seed, family=cfg.family,
                      d_model=cfg.d_model, vision_tokens=cfg.vision_tokens,
                      encoder_seq=cfg.encoder_seq)
    return [to_device(batch_at_step(dcfg, k), "cpu")
            for k in range(MIXER_STEPS)]


def serve_tokens(cfg, seed: int):
    """13.5's prompt (TP_SERVE_ROWS, TP_SERVE_PROMPT) and TP_SERVE_DECODE
    teacher-forced tokens, int32, drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed + 135)
    return (rng.integers(0, cfg.vocab_size, (TP_SERVE_ROWS, TP_SERVE_PROMPT)
                         ).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (TP_SERVE_ROWS, TP_SERVE_DECODE)
                         ).astype(np.int32))


def tp_batches(cfg, seed: int) -> list:
    from repro_torch.data import DataConfig, batch_at_step, to_device

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TP_SEQ,
                      global_batch=TP_ROWS, seed=seed)
    return [to_device(batch_at_step(dcfg, k), "cpu") for k in range(TP_STEPS)]


def digest(t) -> list:
    """Two position-weighted sums of a tensor's bit patterns, in int64
    (wrapping, so exact in any order): equal tensors give equal pairs,
    and a changed or moved element changes them."""
    import torch

    t = t.detach().contiguous().view(-1)
    bits = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.int8}[t.element_size()])
    out = [0, 0]
    step = 1 << 25
    for lo in range(0, bits.numel(), step):
        b = bits[lo:lo + step].to(torch.int64)
        i = torch.arange(lo, lo + b.numel(), device=b.device,
                         dtype=torch.int64)
        out[0] += int((b * (i * 2654435761 + 1)).sum())
        out[1] += int((b * ((i ^ (i >> 3)) * 2246822519 + 7)).sum())
    return [x % (1 << 64) for x in out]


def tp_state_digests(named: dict, opt: dict) -> dict:
    """Digests of this rank's blocks of the parameters and moments."""
    from repro_torch.parallel.shardings import local

    out = {}
    for k in named:
        out[f"p/{k}"] = digest(local(named[k]))
        out[f"m/{k}"] = digest(local(opt["m"][k]))
        out[f"v/{k}"] = digest(local(opt["v"][k]))
    return out


def tp_child(rank: int, world: int, out_dir: str, seed: int,
             device: str) -> None:
    """One rank of phase 13: joins a gloo group of ``world`` processes
    sharing ``device``, runs `tp_legs` and saves its record."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import start_process_group

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    start_process_group("gloo", rank=rank, world_size=world,
                        init_method=f"file://{out_dir}/store")
    try:
        rec = tp_legs(seed, torch.device(device), Path(out_dir))
        np.savez(f"{out_dir}/rank{rank}.npz", **rec)
    finally:
        dist.destroy_process_group()


def tp_legs(seed: int, device, out_dir: Path) -> dict:
    """Everything a rank of phase 13 runs (see `tp_phase`)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.count import count
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamWConfig, adamw_init, compressed_pmean
    from repro_torch.parallel import comm as C
    from repro_torch.parallel import shardings as SH
    from repro_torch.parallel.ax import block_index, logical_rules
    from repro_torch.parallel.decode_attn import split_k_decode_attention
    from repro_torch.train import make_train_step

    t_start = time.perf_counter()
    rank = dist.get_rank()
    reset_counts()
    rec: dict = {}
    cfg, ocfg = tp_config(), AdamWConfig(**TP_OPT)
    mesh = make_host_mesh(*TP_MESH, device=device)
    coord = mesh.get_coordinate()
    model = Transformer(cfg, device=device, seed=seed)
    pspecs = SH.param_specs(model)
    psh = SH.to_named(pspecs, mesh)
    osh = SH.to_named(SH.opt_specs(pspecs), mesh)
    SH.shard_params(model, psh)
    torch.cuda.empty_cache()
    named = dict(model.named_parameters())
    opt = adamw_init(ocfg, named)
    rec["bytes_local"] = np.asarray(SH.local_bytes(named)
                                    + SH.local_bytes(opt["m"])
                                    + SH.local_bytes(opt["v"]))
    step = make_train_step(cfg, ocfg)
    ms, comm = [], {}
    for k, batch in enumerate(tp_batches(cfg, seed)):
        batch = SH.shard_batch(batch, mesh, device)
        torch.cuda.synchronize()
        dist.barrier()
        C.COUNTS.clear()
        t0 = time.perf_counter()
        cm = collective_mode()
        if k == TP_COUNT_STEP:     # 13.1's count (it forbids DTensor's own)
            with logical_rules(mesh):
                (model, opt, met), cnt = count(
                    lambda: step(model, opt, batch), live=False,
                    device=device.type)
            count_record(rec, "count", cnt)
        else:
            with logical_rules(mesh), C.no_functional_collectives(), cm:
                model, opt, met = step(model, opt, batch)
        torch.cuda.synchronize()
        if k != TP_COUNT_STEP:
            ms.append((time.perf_counter() - t0) * 1e3)
        if k == 1:
            comm = dict(ops=dict(cm.counts), kinds=dict(C.COUNTS))
        for key in ("loss", "grad_norm", "lr"):
            rec[f"{key}/{k}"] = np.asarray(float(met[key]))
        if k == 0:
            ref = out_dir / "ref_step1"
            m_max = json.loads((ref / "m_max.json").read_text())
            errs, grad = [], []
            for name, p in named.items():
                for kind, t in (("p", p), ("m", opt["m"][name])):
                    full = np.load(ref / f"{kind}.{name}.npy", mmap_mode="r")
                    want = full[block_index(full.shape, TP_MESH,
                                            psh[name].placements, coord)]
                    want = torch.from_numpy(np.array(want)).to(device)
                    err = float((SH.local(t).detach() - want).abs().max())
                    if kind == "p":
                        errs.append(err)
                    else:
                        grad.append(err / m_max[name])
            rec["leaf_err"] = np.asarray(errs)
            rec["grad_rel_err"] = np.asarray(grad)
            # 13.3's input: the step-1 gradient (after clipping) this
            # rank's first moment holds: m_1 = (1 - b1) g
            g_in = (SH.local(opt["m"][TP_PMEAN_LEAF]) / (1 - ocfg.b1)).clone()
    rec["step_ms"] = np.asarray(ms)
    rec["comm"] = np.asarray(json.dumps(comm))
    rec["t_train"] = np.asarray(time.perf_counter() - t_start)

    # 13.2 split-K decode attention over "model" = the 4 ranks
    mesh_b = make_host_mesh(*SPLITK_MESH, device=device)
    q, kc, vc, lens = splitk_inputs(seed, device)
    split_k_decode_attention(mesh_b, q, kc, vc, lens)        # untimed
    sk_ms = []
    for _ in range(SPLITK_REPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = split_k_decode_attention(mesh_b, q, kc, vc, lens)
        torch.cuda.synchronize()
        sk_ms.append((time.perf_counter() - t0) * 1e3)
    rec["splitk_out"] = out.cpu().numpy()
    rec["splitk_ms"] = np.asarray(sk_ms)
    del q, kc, vc, lens
    # 13.3 compressed_pmean over the same 4 ranks
    got = compressed_pmean({"g": g_in}, mesh_b, "model")["g"]
    rec["pmean_in"] = g_in.cpu().numpy()
    rec["pmean_out"] = got.cpu().numpy()
    del g_in, got

    # 13.4 the state after 13.1's steps, saved on (2, 2), restored on (2, 1)
    rec["t_before_save"] = np.asarray(time.perf_counter() - t_start)
    dig = tp_state_digests(named, opt)
    for key, d in dig.items():
        rec[f"dig22/{key}"] = np.asarray(d, dtype=np.uint64)
    ck = CheckpointManager(out_dir / "ckpt", async_save=False)
    t0 = time.perf_counter()
    ck.save(TP_STEPS, (named, opt))
    rec["save_s"] = np.asarray(time.perf_counter() - t0)
    rec["save_gather_s"] = np.asarray(ck.last_save["gather_s"])
    rec["save_write_s"] = np.asarray(ck.last_save["write_s"])
    mesh_c = make_host_mesh(*TP_RESTORE_MESH, device=device)
    if mesh_c.get_coordinate() is not None:
        t0 = time.perf_counter()
        skel = (named, opt)
        _, (rp, ro), _ = ck.restore(None, skel, shardings=(
            SH.to_named(pspecs, mesh_c),
            SH.to_named(SH.opt_specs(pspecs), mesh_c)))
        rec["restore_s"] = np.asarray(time.perf_counter() - t0)
        for key, d in tp_state_digests(rp, ro).items():
            rec[f"dig21/{key}"] = np.asarray(d, dtype=np.uint64)
        rec["restored_step"] = np.asarray(int(ro["step"]))
        del rp, ro
    dist.barrier()
    del named, opt, model
    release()
    rec["t_before_serve"] = np.asarray(time.perf_counter() - t_start)
    serve_rank_leg(rec, seed, device, out_dir, mesh)
    rec["t_before_mixers"] = np.asarray(time.perf_counter() - t_start)
    for cell in MIXER_CELLS:
        mixer_rank_leg(rec, cell, seed, device, out_dir, mesh)
    counts = read_counts()
    rec["counts"] = np.asarray([counts[k] for k in sorted(counts)])
    rec["seconds"] = np.asarray(time.perf_counter() - t_start)
    return rec


def count_record(rec: dict, pre: str, c) -> None:
    """A `Count`'s FLOPs, bytes and collectives (kind, bytes, group size
    each) into ``rec`` under ``pre``."""
    import numpy as np

    rec[f"{pre}/flops"] = np.asarray(c.flops)
    rec[f"{pre}/bytes"] = np.asarray(c.bytes)
    rec[f"{pre}/kinds"] = np.asarray([r.kind for r in c.collectives])
    rec[f"{pre}/nbytes"] = np.asarray([r.nbytes for r in c.collectives],
                                      dtype=np.int64)
    rec[f"{pre}/groups"] = np.asarray([r.group_size for r in c.collectives],
                                      dtype=np.int64)


def tp_prediction(cfg, ocfg) -> dict:
    """13.1's step counted by the dry-run on a fake group of TP_RANKS at
    TP_MESH over the meta device (`launch.dryrun.mesh_count`): rank 0's
    FLOPs, bytes and collectives."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import mesh_count
    from repro_torch.models.transformer import Transformer

    t0 = time.perf_counter()
    with M.fake_process_group(TP_RANKS):
        mesh = M.make_host_mesh(*TP_MESH, device="cpu")
        model = Transformer(cfg, device="meta", init=False)
        inputs = {k: torch.empty((TP_ROWS, TP_SEQ), dtype=torch.int32,
                                 device="meta")
                  for k in ("tokens", "labels")}
        c = mesh_count(cfg, "train", model, inputs, mesh, ocfg=ocfg,
                       live=False)
    rec: dict = {}
    count_record(rec, "pred", c)
    rec["pred/seconds"] = time.perf_counter() - t0
    return rec


def blocks_err(t, ref, mesh, scale: float) -> float:
    """The largest |this rank's block of ``t`` - the slice of ``ref`` (a
    whole array, mapped) its placements name|, over ``scale``."""
    import numpy as np
    import torch

    from repro_torch.parallel.ax import block_index, mesh_shape
    from repro_torch.parallel.shardings import local

    want = np.array(ref[block_index(t.shape, mesh_shape(mesh), t.placements,
                                    mesh.get_coordinate())])
    got = local(t).detach()
    return float((got - torch.from_numpy(want).to(got.device)).abs().max()
                 ) / scale


def serve_reference(seed: int, device, out_dir: Path) -> dict:
    """13.5's oracle in this one process: 13.1's model, a prefill of
    `serve_tokens`'s prompt into TP_SERVE_CACHE-long caches, then
    TP_SERVE_DECODE steps; each logits and every cache leaf after the last
    step go to ``out_dir/serve_ref``."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import Transformer

    cfg = tp_config()
    model = Transformer(cfg, device=device, seed=seed)
    prompt, steps = serve_tokens(cfg, seed)
    caches = model.init_caches(TP_SERVE_ROWS, TP_SERVE_CACHE)
    ref = out_dir / "serve_ref"
    ref.mkdir(parents=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = model.prefill(torch.as_tensor(prompt, device=device), caches)
    torch.cuda.synchronize()
    out = dict(prefill_ms=(time.perf_counter() - t0) * 1e3, decode_ms=[])
    logits = [lg]
    for k in range(TP_SERVE_DECODE):
        t0 = time.perf_counter()
        lg, caches = model.decode_step(
            torch.as_tensor(steps[:, k:k + 1], device=device), caches,
            torch.full((TP_SERVE_ROWS,), TP_SERVE_PROMPT + k,
                       dtype=torch.int32, device=device))
        torch.cuda.synchronize()
        out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
    check(all(bool(torch.isfinite(x).all()) for x in logits),
          "13.5: the single process's logits are not finite")
    for j, x in enumerate(logits):
        np.save(ref / f"logits{j}.npy", x.cpu().numpy())
    maxes = {}
    for i, c in enumerate(caches):
        for k, v in c.items():
            np.save(ref / f"cache.{i}.{k}.npy", v.cpu().numpy())
            maxes[f"{i}.{k}"] = float(v.abs().max())
    out["logit_max"] = max(float(x.abs().max()) for x in logits)
    (ref / "max.json").write_text(json.dumps(dict(maxes, logits=out[
        "logit_max"])))
    del model, caches, logits
    release()
    return out


def serve_rank_leg(rec: dict, seed: int, device, out_dir: Path,
                   mesh) -> None:
    """13.5 on this rank: 13.5's model placed by ``param_specs``, its
    caches by ``cache_specs`` (length on "model"), the prompt and tokens
    by ``batch_spec``; the same prefill and decode steps under
    ``logical_rules`` with DTensor's collectives forbidden; each logits'
    and cache leaf's block held to the oracle's slice."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel import comm as C
    from repro_torch.parallel import shardings as SH
    from repro_torch.parallel.ax import logical_rules

    cfg = tp_config()
    model = Transformer(cfg, device=device, seed=seed)
    SH.shard_params(model, SH.to_named(SH.param_specs(model), mesh))
    release()
    caches = model.init_caches(TP_SERVE_ROWS, TP_SERVE_CACHE)
    caches = SH.shard_state(caches, SH.to_named(SH.cache_specs(caches, mesh),
                                                mesh), device)
    prompt, steps = serve_tokens(cfg, seed)
    ref = out_dir / "serve_ref"
    mx = json.loads((ref / "max.json").read_text())
    errs, ms = [], []
    with logical_rules(mesh), C.no_functional_collectives():
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        lg, caches = model.prefill(SH.shard_batch(
            {"tokens": torch.as_tensor(prompt)}, mesh, device)["tokens"],
            caches)
        torch.cuda.synchronize()
        rec["serve/prefill_ms"] = np.asarray((time.perf_counter() - t0) * 1e3)
        errs.append(blocks_err(lg, np.load(ref / "logits0.npy"), mesh,
                               mx["logits"]))
        for k in range(TP_SERVE_DECODE):
            tok = SH.shard_batch({"token": torch.as_tensor(
                steps[:, k:k + 1])}, mesh, device)["token"]
            t0 = time.perf_counter()
            lg, caches = model.decode_step(
                tok, caches, torch.full((TP_SERVE_ROWS,), TP_SERVE_PROMPT + k,
                                        dtype=torch.int32, device=device))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            errs.append(blocks_err(lg, np.load(ref / f"logits{k + 1}.npy"),
                                   mesh, mx["logits"]))
    cache_err = {}
    for i, c in enumerate(caches):
        for k, v in c.items():
            ref_v = np.load(ref / f"cache.{i}.{k}.npy", mmap_mode="r")
            cache_err[f"{i}.{k}"] = blocks_err(v, ref_v, mesh,
                                               max(mx[f"{i}.{k}"], 1e-30))
    rec["serve/logit_err"] = np.asarray(errs)
    rec["serve/cache_err"] = np.asarray(json.dumps(cache_err))
    rec["serve/decode_ms"] = np.asarray(ms)
    rec["serve/cache_block"] = np.asarray(
        list(SH.local(caches[0]["k"]).shape))
    del model, caches
    release()


def mixer_reference(cell, seed: int, device, out_dir: Path) -> dict:
    """13.6's oracle for one of MIXER_CELLS in this one process:
    MIXER_STEPS steps of TP_OPT on `mixer_batches`; the first moments
    after step 1 (and each's largest |value|) go to
    ``out_dir/mixer_ref/arch``."""
    import numpy as np
    import torch

    from repro_torch.data import to_device
    from repro_torch.models.registry import model_class
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    arch, over, _, rows, seq = cell
    cfg = mixer_config(arch, over)
    ocfg = AdamWConfig(**TP_OPT)
    model = model_class(cfg)(cfg, device=device, seed=seed)
    named = dict(model.named_parameters())
    opt = adamw_init(ocfg, named)
    step = make_train_step(cfg, ocfg)
    out = dict(loss=[], grad_norm=[], step_ms=[], params=model.param_count())
    ref = out_dir / "mixer_ref" / arch
    for k, batch in enumerate(mixer_batches(cfg, rows, seq, seed)):
        batch = to_device(batch, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, met = step(model, opt, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(met["loss"]))
        out["grad_norm"].append(float(met["grad_norm"]))
        if k == 0:
            ref.mkdir(parents=True)
            m_max = {}
            for name in named:
                np.save(ref / f"m.{name}.npy", opt["m"][name].cpu().numpy())
                m_max[name] = float(opt["m"][name].abs().max())
            (ref / "m_max.json").write_text(json.dumps(m_max))
    check(all(math.isfinite(x) for x in out["loss"] + out["grad_norm"]),
          f"13.6 {arch}: the single process's loss is not finite")
    del model, opt, named
    release()
    return out


def mixer_rank_leg(rec: dict, cell, seed: int, device, out_dir: Path,
                   mesh) -> None:
    """13.6 on this rank: the config's sharded train step (parameters by
    ``param_specs``, the batch by ``batch_spec``, DTensor's collectives
    forbidden), MIXER_STEPS steps; losses, gradient norms, and after
    step 1 each first moment's block against the oracle's slice."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.models.registry import model_class
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import comm as C
    from repro_torch.parallel import shardings as SH
    from repro_torch.parallel.ax import logical_rules
    from repro_torch.train import make_train_step

    arch, over, _, rows, seq = cell
    cfg = mixer_config(arch, over)
    ocfg = AdamWConfig(**TP_OPT)
    model = model_class(cfg)(cfg, device=device, seed=seed)
    SH.shard_params(model, SH.to_named(SH.param_specs(model), mesh))
    release()
    named = dict(model.named_parameters())
    opt = adamw_init(ocfg, named)
    step = make_train_step(cfg, ocfg)
    ref = out_dir / "mixer_ref" / arch
    ms = []
    for k, batch in enumerate(mixer_batches(cfg, rows, seq, seed)):
        batch = SH.shard_batch(batch, mesh, device)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        with logical_rules(mesh), C.no_functional_collectives():
            model, opt, met = step(model, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rec[f"mixer/{arch}/loss/{k}"] = np.asarray(float(met["loss"]))
        rec[f"mixer/{arch}/grad_norm/{k}"] = np.asarray(
            float(met["grad_norm"]))
        if k == 0:
            m_max = json.loads((ref / "m_max.json").read_text())
            rec[f"mixer/{arch}/grad_rel_err"] = np.asarray([
                blocks_err(opt["m"][n],
                           np.load(ref / f"m.{n}.npy", mmap_mode="r"), mesh,
                           max(m_max[n], 1e-30)) for n in named])
    rec[f"mixer/{arch}/step_ms"] = np.asarray(ms)
    del model, opt, named
    release()


def splitk_inputs(seed: int, device):
    """13.2's q (B,1,H,D), caches (B,S,KVH,D) and lengths, float32, drawn
    on the card from ``seed`` (every process draws the same)."""
    import torch

    sh = SPLITK_SHAPE
    g = torch.Generator(device=device).manual_seed(seed + 13)
    b, h, kvh, d, s = sh["B"], sh["H"], sh["KVH"], sh["D"], sh["S"]
    q = torch.randn(b, 1, h, d, generator=g, device=device)
    kc = torch.randn(b, s, kvh, d, generator=g, device=device)
    vc = torch.randn(b, s, kvh, d, generator=g, device=device)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=device)
    return q, kc, vc, lens


def tp_spawn(seed: int, device, out_dir: Path) -> list:
    """`tp_child` on TP_RANKS processes; each rank's record."""
    import numpy as np
    import torch.multiprocessing as mp

    ctx = mp.start_processes(tp_child,
                             args=(TP_RANKS, str(out_dir), seed, str(device)),
                             nprocs=TP_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT
    try:
        while not ctx.join(timeout=1):
            check(time.monotonic() < deadline,
                  f"phase 13: {TP_RANKS} ranks ran past {TP_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(5)
    recs = []
    for r in range(TP_RANKS):
        with np.load(out_dir / f"rank{r}.npz") as z:
            recs.append({k: z[k] for k in z.files})
    return recs


def tp_reference(cfg, ocfg, seed: int, device, out_dir: Path) -> dict:
    """13.1's oracle: the same model, optimizer and batches in this one
    process on the card; its parameters and first moments after step 1
    go to ``out_dir/ref_step1`` (and each moment's largest |value|) for
    the ranks to compare their blocks with."""
    import numpy as np
    import torch

    from repro_torch.data import to_device
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.shardings import local_bytes
    from repro_torch.train import make_train_step

    model = Transformer(cfg, device=device, seed=seed)
    named = dict(model.named_parameters())
    opt = adamw_init(ocfg, named)
    nbytes = (local_bytes(named) + local_bytes(opt["m"])
              + local_bytes(opt["v"]))
    step = make_train_step(cfg, ocfg)
    out = dict(loss=[], grad_norm=[], step_ms=[], bytes=nbytes,
               params=model.param_count())
    for k, batch in enumerate(tp_batches(cfg, seed)):
        batch = to_device(batch, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, met = step(model, opt, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(met["loss"]))
        out["grad_norm"].append(float(met["grad_norm"]))
        if k == 0:
            ref = out_dir / "ref_step1"
            ref.mkdir(parents=True)
            m_max = {}
            for name, p in named.items():
                np.save(ref / f"p.{name}.npy", p.detach().cpu().numpy())
                np.save(ref / f"m.{name}.npy", opt["m"][name].cpu().numpy())
                m_max[name] = float(opt["m"][name].abs().max())
            (ref / "m_max.json").write_text(json.dumps(m_max))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del model, opt, named
    release()
    return out


def tp_phase(seed: int, device) -> dict:
    """Phase 13 (see the module's docstring); returns its row."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.layers.attention import decode_attention
    from repro_torch.models.registry import model_class
    from repro_torch.optim import AdamWConfig, quantize_int8
    from repro_torch.parallel import shardings as SH
    from repro_torch.parallel.ax import block_index, placements_for

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    t0 = time.perf_counter()
    reset_counts()
    out_dir = ROOT / "build" / "chip_tp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cfg, ocfg = tp_config(), AdamWConfig(**TP_OPT)
    torch.cuda.reset_peak_memory_stats()
    ref = tp_reference(cfg, ocfg, seed, device, out_dir)
    pred = tp_prediction(cfg, ocfg)
    log(f"13.1 dry-run of the step at {TP_MESH} on a fake group of "
        f"{TP_RANKS} over the meta device: {pred['pred/seconds']:.1f} s")
    serve_ref = serve_reference(seed, device, out_dir)
    mixer_refs = {}
    for cell in MIXER_CELLS:
        log(f"13.6 {cell[0]}: full width, {cell[2]}, float32, "
            f"{cell[3]} x {cell[4]} tokens, {MIXER_STEPS} steps on "
            f"{TP_MESH}")
        mixer_refs[cell[0]] = mixer_reference(cell, seed, device, out_dir)
    t_ref = time.perf_counter() - t0
    log(f"phase 13 single process done at {t_ref:.1f} s")
    ts = time.perf_counter()
    recs = tp_spawn(seed, device, out_dir)
    spawn_s = time.perf_counter() - ts
    log(f"phase 13 ranks done at {time.perf_counter() - t0:.1f} s")

    # 13.1
    loss_err = max(abs(float(r[f"loss/{k}"]) - ref["loss"][k])
                   for r in recs for k in range(TP_STEPS))
    leaf_err = max(float(r["leaf_err"].max()) for r in recs)
    gnorm_err = max(abs(float(r[f"grad_norm/{k}"]) - ref["grad_norm"][k])
                    / ref["grad_norm"][k]
                    for r in recs for k in range(TP_STEPS))
    grad_err = max(float(r["grad_rel_err"].max()) for r in recs)
    check(loss_err < TP_LOSS_TOL, f"13.1: the sharded loss is {loss_err} "
          f"from the single process's (>= {TP_LOSS_TOL})")
    check(leaf_err < TP_LEAF_TOL, f"13.1: a leaf after step 1 is {leaf_err} "
          f"from the single process's (>= {TP_LEAF_TOL})")
    check(gnorm_err < TP_GNORM_RTOL, f"13.1: a sharded gradient norm is "
          f"{gnorm_err} of the single process's from it "
          f"(>= {TP_GNORM_RTOL})")
    check(grad_err < TP_GRAD_RTOL, f"13.1: a first moment after step 1 is "
          f"{grad_err} of its largest from the single process's "
          f"(>= {TP_GRAD_RTOL})")
    comm = [json.loads(str(r["comm"])) for r in recs]
    check(not any("functional" in k for c in comm for k in c["ops"]),
          f"13.1: DTensor ran a collective of its own: {comm[0]}")
    check(all(sum(c["ops"].values()) == sum(c["kinds"].values())
              for c in comm), f"13.1: collectives counted apart: {comm[0]}")
    for r, rec in enumerate(recs):
        check(not rec["counts"].any(),
              f"phase 13, rank {r}: a kernel or plain version launched")
    # 13.1's count against the dry-run's
    for r, rec in enumerate(recs):
        for k in ("flops", "bytes", "kinds", "nbytes", "groups"):
            check(np.array_equal(rec[f"count/{k}"], pred[f"pred/{k}"]),
                  f"13.1: rank {r}'s count ({k}) is not the dry-run's: "
                  f"{rec[f'count/{k}'].ravel().tolist()[:8]} against "
                  f"{pred[f'pred/{k}'].ravel().tolist()[:8]}")
    kinds = [str(x) for x in pred["pred/kinds"]]
    counted = dict(
        flops=int(pred["pred/flops"]), bytes=int(pred["pred/bytes"]),
        collectives={k: kinds.count(k) for k in sorted(set(kinds))},
        collective_bytes=int(pred["pred/nbytes"].sum()),
        equal_on_ranks=TP_RANKS, dryrun_s=pred["pred/seconds"],
        step=TP_COUNT_STEP + 1)
    log(json.dumps({"sharded_count": counted, "card": card}))
    share = [int(r["bytes_local"]) / ref["bytes"] for r in recs]
    check(max(share) < 0.3, f"13.1: a rank stores {max(share)} of the "
          "single process's parameter and moment bytes")
    train = dict(
        config=cfg.name, layers=TP_LAYERS, params=ref["params"],
        mesh=list(TP_MESH), rows=TP_ROWS, tokens=TP_SEQ, steps=TP_STEPS,
        remat=cfg.remat, dtype="float32", loss_tol=TP_LOSS_TOL,
        leaf_tol=TP_LEAF_TOL, loss_err=loss_err, leaf_err=leaf_err,
        grad_norm_rtol=TP_GNORM_RTOL, grad_norm_rel_err=gnorm_err,
        grad_rtol=TP_GRAD_RTOL, grad_rel_err=grad_err,
        loss=ref["loss"], grad_norm=ref["grad_norm"],
        sharded_loss=[float(recs[0][f"loss/{k}"]) for k in range(TP_STEPS)],
        sharded_grad_norm=[float(recs[0][f"grad_norm/{k}"])
                           for k in range(TP_STEPS)],
        single_bytes=ref["bytes"],
        rank_bytes=[int(r["bytes_local"]) for r in recs],
        rank_bytes_share=share,
        single_step_ms=ref["step_ms"],
        single_step_median_ms=statistics.median(ref["step_ms"]),
        rank_step_ms=[r["step_ms"].tolist() for r in recs],
        rank_step_median_ms=[statistics.median(r["step_ms"].tolist())
                             for r in recs],
        single_peak_bytes=ref["peak_bytes"],
        collectives_step2=comm[0], label=RANKS_LABEL.format(r=TP_RANKS))
    log(json.dumps({"sharded_train": train, "card": card}))

    # 13.2
    q, kc, vc, lens = splitk_inputs(seed, device)
    want = decode_attention(q, kc, vc, lens)
    plain_ms = []
    for _ in range(SPLITK_REPS + 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t1) * 1e3)
    want = want.cpu().numpy()
    del q, kc, vc, lens
    release()
    sk_err = max(float(np.abs(r["splitk_out"] - want).max()) for r in recs)
    check(sk_err < SPLITK_TOL, f"13.2: split-K is {sk_err} from "
          f"decode_attention (>= {SPLITK_TOL})")
    splitk = dict(mesh=list(SPLITK_MESH), **SPLITK_SHAPE, dtype="float32",
                  max_abs_err=sk_err, tol=SPLITK_TOL,
                  rank_ms=[statistics.median(r["splitk_ms"].tolist())
                           for r in recs],
                  single_ms=statistics.median(plain_ms[1:]))
    log(json.dumps({"split_k": splitk, "card": card}))

    # 13.3
    ins = [torch.from_numpy(r["pmean_in"]).to(device) for r in recs]
    qs = [quantize_int8(x) for x in ins]
    acc = qs[0][0].float() * qs[0][1]
    for qq, sc in qs[1:]:
        acc = acc + qq.float() * sc
    parent = (acc / len(qs)).cpu().numpy()
    exact = (sum(x.double() for x in ins) / len(ins)).float().cpu().numpy()
    bound = float(sum(sc for _, sc in qs)) / (2 * len(qs))
    pm_err = max(float(np.abs(r["pmean_out"] - exact).max()) for r in recs)
    same = all(np.array_equal(r["pmean_out"], parent) for r in recs)
    check(same, "13.3: compressed_pmean differs from the per-rank "
                "quantization computed in the parent")
    check(pm_err <= bound * (1 + 1e-5) + 1e-7,
          f"13.3: compressed_pmean is {pm_err} from the exact mean "
          f"(> the int8 grid's {bound})")
    pmean = dict(leaf=TP_PMEAN_LEAF, shape=list(ins[0].shape),
                 max_abs_err=pm_err, grid_bound=bound, equal_to_parent=same)
    del ins, qs, acc
    log(json.dumps({"compressed_pmean": pmean, "card": card}))

    # 13.4
    t1 = time.perf_counter()
    names = [n for n, _ in model_class(cfg)(
        cfg, device="meta", init=False).named_parameters()]
    skel = ({n: None for n in names},
            {"m": {n: None for n in names}, "v": {n: None for n in names},
             "step": None})
    step, (named, opt), _ = CheckpointManager(out_dir / "ckpt").restore(
        None, skel, device=device)
    parent_restore_s = time.perf_counter() - t1
    check(step == TP_STEPS and int(opt["step"]) == TP_STEPS
          and all(int(r["restored_step"]) == TP_STEPS for r in recs[:2]),
          "13.4: the restored step counter")
    pspecs = SH.param_specs(named)
    mismatch = []
    for mesh_shape, tag, ranks in ((TP_MESH, "dig22", range(TP_RANKS)),
                                   (TP_RESTORE_MESH, "dig21", range(2))):
        names_of = types.SimpleNamespace(mesh_dim_names=("data", "model"))
        for name in names:
            pl = placements_for(pspecs[name], names_of)
            for kind, t in (("p", named[name]), ("m", opt["m"][name]),
                            ("v", opt["v"][name])):
                for r in ranks:
                    coord = divmod(r, mesh_shape[1])
                    d = digest(t[block_index(t.shape, mesh_shape, pl,
                                             coord)])
                    if recs[r][f"{tag}/{kind}/{name}"].tolist() != d:
                        mismatch.append((tag, r, kind, name))
    check(not mismatch, f"13.4: blocks differ from the saved state: "
          f"{mismatch[:4]}")
    del named, opt
    release()
    restore = dict(saved_on=list(TP_MESH), restored_on=list(TP_RESTORE_MESH),
                   leaves=3 * len(recs[0]["leaf_err"]),
                   save_s=float(recs[0]["save_s"]),
                   save_gather_s=float(recs[0]["save_gather_s"]),
                   save_write_s=float(recs[0]["save_write_s"]),
                   rank_restore_s=[float(r["restore_s"]) for r in recs[:2]],
                   parent_restore_s=parent_restore_s, bit_equal=True)
    log(json.dumps({"resharding_restore": restore, "card": card}))
    # 13.5
    logit_err = max(float(r["serve/logit_err"].max()) for r in recs)
    cache_err = max(max(json.loads(str(r["serve/cache_err"])).values())
                    for r in recs)
    check(logit_err < TP_SERVE_TOL, f"13.5: sharded logits are {logit_err} of "
          f"the largest from the single process's (>= {TP_SERVE_TOL})")
    check(cache_err < TP_SERVE_TOL, f"13.5: a cache block is {cache_err} of "
          f"its leaf's largest from its slice (>= {TP_SERVE_TOL})")
    serve = dict(
        config=cfg.name, layers=TP_LAYERS, mesh=list(TP_MESH),
        rows=TP_SERVE_ROWS, prompt=TP_SERVE_PROMPT,
        decode_steps=TP_SERVE_DECODE,
        cache=TP_SERVE_CACHE, dtype="float32", tol=TP_SERVE_TOL,
        logit_rel_err=logit_err, cache_rel_err=cache_err,
        rank_cache_block=recs[0]["serve/cache_block"].tolist(),
        single_prefill_ms=serve_ref["prefill_ms"],
        single_decode_median_ms=statistics.median(serve_ref["decode_ms"]),
        rank_prefill_ms=[float(r["serve/prefill_ms"]) for r in recs],
        rank_decode_median_ms=[statistics.median(
            r["serve/decode_ms"].tolist()) for r in recs],
        label=RANKS_LABEL.format(r=TP_RANKS))
    log(json.dumps({"sharded_decode": serve, "card": card}))
    # 13.6
    mixers = {}
    for arch, _, cut, rows, seq in MIXER_CELLS:
        mr = mixer_refs[arch]
        l_err = max(abs(float(r[f"mixer/{arch}/loss/{k}"]) - mr["loss"][k])
                    for r in recs for k in range(MIXER_STEPS))
        g_err = max(abs(float(r[f"mixer/{arch}/grad_norm/{k}"])
                        - mr["grad_norm"][k]) / mr["grad_norm"][k]
                    for r in recs for k in range(MIXER_STEPS))
        m_err = max(float(r[f"mixer/{arch}/grad_rel_err"].max())
                    for r in recs)
        check(l_err < TP_LOSS_TOL, f"13.6 {arch}: the sharded loss is "
              f"{l_err} from the single process's (>= {TP_LOSS_TOL})")
        check(g_err < TP_GNORM_RTOL, f"13.6 {arch}: a sharded gradient "
              f"norm is {g_err} of the single process's from it "
              f"(>= {TP_GNORM_RTOL})")
        check(m_err < TP_GRAD_RTOL, f"13.6 {arch}: a first moment after "
              f"step 1 is {m_err} of its largest from the single "
              f"process's (>= {TP_GRAD_RTOL})")
        mixers[arch] = dict(
            cut=cut, params=mr["params"], rows=rows, tokens=seq,
            steps=MIXER_STEPS, loss_err=l_err, grad_norm_rel_err=g_err,
            grad_rel_err=m_err, loss=mr["loss"], grad_norm=mr["grad_norm"],
            single_step_ms=mr["step_ms"],
            rank_step_ms=[r[f"mixer/{arch}/step_ms"].tolist()
                          for r in recs])
        log(json.dumps({"sharded_mixer": {arch: mixers[arch]},
                        "card": card}))
    counts = read_counts()
    check(not any(counts.values()),
          f"phase 13 launched a kernel or a plain version: {counts}")
    shutil.rmtree(out_dir, ignore_errors=True)
    elapsed = time.perf_counter() - t0
    log(f"phase 13 done in {elapsed:.1f} s ({card}; single process "
        f"{t_ref:.1f} s, spawn of {TP_RANKS} ranks {spawn_s:.1f} s, their "
        f"legs {[round(float(r['seconds']), 1) for r in recs]} s)")
    if elapsed > TP_BUDGET_S:
        log(f"phase 13 took {elapsed:.1f} s, past its budget of "
            f"{TP_BUDGET_S} s")
    return dict(card=card, train=train, split_k=splitk, pmean=pmean,
                restore=restore, count=counted, serve=serve, mixers=mixers,
                spawn_s=spawn_s, single_s=t_ref,
                rank_seconds=[float(r["seconds"]) for r in recs],
                elapsed_s=elapsed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the kernels rows and the serve phase's "
                         "results to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    card, kind = card_check()
    out, serve = run_phases(args.seed, torch.device("cuda"))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "kernels": out,
                                        "serve": serve}, indent=1))
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(seed: int, device):
    """Phases 2-13 on ``device``; returns (the rows of the kernels line,
    the serve phase's results, the forest phase's under ``"forest"``,
    phase 7's under ``"comparison"``, phase 8's under ``"zoo"``, phase 9's
    under ``"model_only"``, phase 10's under ``"train"``, phase 11's under
    ``"dryrun"``, phase 12's under ``"ranks"`` and phase 13's under
    ``"sharded"``)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, KEY_MAX, INITIAL).astype(np.int32))
    log(f"Fig. 12 tree: {keys.size} keys, {fig12_config(keys.size)}")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)

    t_start = time.perf_counter()
    kern = compare_kernels(keys, rng, device, flush)
    del flush
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")

    fused_run, ix, oracle = main_path(keys, rng, device, STEPS,
                                      walk_fused=True)
    log(json.dumps({"main_path": fused_run}))
    c = fused_run["counts"]
    check(c["fused"] > 0, "the main path did not launch veb_walk_fused")
    check(c["plain"] == 0 and c["scan"] == 0,
          "the main path ran a plain version or a scan")
    scan_run = scan_path(ix, oracle, rng)
    log(json.dumps({"scan_path": scan_run}))
    del ix, oracle
    round_run, ix, _ = main_path(keys, rng, device, PER_ROUND_STEPS,
                                 walk_fused=False)
    del ix
    log(json.dumps({"main_path": round_run}))
    c = round_run["counts"]
    check(c["rows"] > 0, "the per-round path did not launch veb_walk_rows")
    check(c["fused"] == 0 and c["plain"] == 0 and c["scan"] == 0,
          "the per-round path ran another walk")
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    for policy, steps in (("deferred", DEFERRED_STEPS),
                          ("budgeted:8", BUDGETED_STEPS)):
        log(json.dumps({"relaxed_path": relaxed_path(keys, rng, device,
                                                     policy, steps)}))
        torch.cuda.empty_cache()
    t_replay = time.perf_counter()
    replay = replay_leg(device)
    log(json.dumps({"replay": replay}))
    log(f"4.3 card replay passed in {time.perf_counter() - t_replay:.1f} s "
        f"({replay['runs']} runs, {replay['steps']} steps)")
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    serve = serve_phase(seed, device)
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    serve["forest"] = forest = forest_phase(seed, device)
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")
    serve["comparison"] = comp = comparison_phase(keys, seed, device)
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")
    serve["zoo"] = zoo = zoo_phase(seed, device)
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")
    serve["model_only"] = model_only_phase(seed, device)
    log(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")
    serve["train"] = train_phase(seed, device)
    log(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")
    serve["dryrun"] = dryrun_phase(keys, seed, device)
    log(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")
    serve["ranks"] = ranks = ranks_phase(seed, device, forest)
    log(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
    serve["sharded"] = tp_phase(seed, device)
    log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")

    replaces = {"fused": "src/repro/kernels/veb_search.py:228",
                "rows": "src/repro/kernels/veb_search.py:93",
                "scan": "src/repro/kernels/veb_search.py:397"}
    names = {"fused": "veb_walk_fused", "rows": "veb_walk_rows",
             "scan": "veb_scan_fused"}
    sources = {"fused": SOURCE, "rows": SOURCE, "scan": SCAN_SOURCE}
    launches = {"fused": fused_run["counts"]["fused"],
                "rows": round_run["counts"]["rows"],
                "scan": scan_run["counts"]["scan"]}
    forest_launches = forest["launches"]
    out = []
    for name in ("fused", "rows", "scan"):
        r = kern[name]
        extra = ({} if name == "rows" else
                 {"forest_launches": forest_launches[name],
                  "ranks_launches": {r: c[name] for r, c in
                                     ranks["launches"].items()}})
        if name == "fused":
            extra["phase7_launches"] = comp["launches"]
        if name != "rows":
            extra["replay_launches"] = replay["counts"][name]
        out.append({"name": names[name], "route": "cuda",
                    "source": sources[name], "replaces": replaces[name],
                    "launches": launches[name], **extra,
                    "max_abs_err": r["err"],
                    "exact": r["err"] == 0, "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": "bytes", "library_ms": None,
                    "searchsorted_ms": r["searchsorted_ms"],
                    "K": SCAN_K if name == "scan" else BATCH,
                    "tall": r["tall"],
                    **({} if name == "scan" else
                       {"block_ms": r["block_ms"]})})
    pa = serve["kernel"]
    out.append({"name": "paged_decode_attention", "route": "cuda",
                "source": PA_SOURCE,
                "replaces": "src/repro/kernels/delta_paged_attention.py:74",
                "launches": serve["serve"]["counts"]["paged"],
                "forest_launches": forest_launches["paged"],
                "phase7_launches": comp["paged_launches"],
                "phase8_launches": zoo["paged_launches"],
                "max_abs_err": max(pa["max_abs_err"],
                                   *(r["err"] for r in zoo["groups"])),
                "exact": False,
                "ms": pa["ms"], "plain_ms": pa["plain_ms"],
                "bound_ms": pa["bound_ms"], "bound_by": "bytes",
                "library_ms": pa["library_ms"], "B": pa["B"],
                "tokens": pa["tokens"], "dtype": pa["dtype"]})
    return out, serve


if __name__ == "__main__":
    sys.exit(main())
