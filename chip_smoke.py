#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failed check raises, so the script
exits nonzero; nothing is caught and passed over):

1. device  -- ``nvidia-smi`` name and power limit, and the time to build
   every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc`` (one
   process per source, all at once); registers, stack and spills of the
   hop kernel, kernel A and each tick-kernel instantiation;
2. main    -- ``make_dataset("d2", 6000)`` -> ``window_features`` (kernel A,
   one launch a call over every window, one shared slot row)
   -> ``train_partitioned_dt([3, 3, 3], k=4)`` -> ``window_packets`` of the
   test split tiled to 2^20 flows -> ``Engine.from_model(pdt).run`` on the
   card (the hop kernel, one launch per partition; no launch of kernel A
   or B).  Verdicts must equal ``np.tile`` of the numpy oracle
   ``pdt.predict`` on the untiled test windows, and the counts (zeroed
   just before, read just after) must show the launches;
3. check   -- each kernel against its plain PyTorch version on the card at
   the main path's shapes (the hop kernel against ``engine_hop_ref`` on
   every hop of a walk from random SIDs, -1 among them, with done flows,
   and in survivor mode on the survivors of that carry against the plain
   compacted hop and ``engine_hop_ref``, done flows' register rows kept,
   and with rows and a count out of range; kernel A at the hop's shape
   and at the one launch of ``window_features`` on the training split;
   kernel A over every registry feature and the hop kernel on a tile of
   subnormal packet fields, so no flush-to-zero can slip in; kernel B in
   both forms, the per-flow one from random SIDs with -1 among them, and
   ``dispatch_dt_traverse`` as called, one launch of it), and the
   engine's ``cuda`` walk against its ``fused`` walk, all with
   ``torch.equal`` (zero tolerance);
4. times   -- CUDA-event medians of each kernel and its plain version beside
   the least time the card could take (bytes over 3.35 TB/s), the hop
   kernel's graph-replay time also under the warp match it does not run
   at L = 8 (``WARP_MATCH_MIN_LEAVES``), and
   ``Engine.run`` flows/s from numpy, from a device-resident tensor and
   from one without the trace, beside the two-kernel walk it replaced
   (kernel A and kernel B a hop) and the fetch alone; kernel B's two
   forms and ``dispatch_dt_traverse`` by graph replay, the call one
   kernel node;
   then ``profile``, one traced ``Engine.run`` of each walk with its
   device-kernel count;
4b. compact -- early-exit compaction on each exit profile (front, uniform,
   back): ``make_profile_dataset(profile, 6000, seed=0xD2)``, trained at
   (3, 3, 3) and k = 4, its test windows tiled to 2^20 flows.
   ``Engine.run(compact=True)`` (P hop launches, the P - 1 of hops 1..
   counted in survivor mode) equals the tiled ``pdt.predict`` and the dense walk; its trace
   equals the plain compacted walk's and the dense trace where a flow is
   live; ``run_looped`` with and without compaction gives the same
   verdicts and trace with one launch of kernels A and B a hop that has
   survivors; the compacted walk replayed from a CUDA graph gives the same
   fetch buffer.  Survivors entering each hop; CUDA-event medians of the
   dense and compacted walks with and without the trace, of ``Engine.run``
   from the device tensor, of each hop's kernel and of ``run_looped``,
   beside their bounds;
4c. stream -- the main path's 2^20 numpy windows streamed on CUDA streams
   (``run_streaming``, ``impl="cuda"``): at micro-batches of 4,096, 65,536
   and 262,144 and ``inflight`` 1, 2 and 3 the verdicts equal
   ``Engine.run`` and the tiled ``pdt.predict``, P hop launches and one
   ``stream_chunks_total{backend="cuda"}`` a chunk, peak device memory
   below ``Engine.run``'s on the whole batch; a ragged B, ``stream_batches``
   over 8 uneven batches, ``make_flow_mesh()``, ``donate=False`` and
   compacted front and back profiles (P - 1 survivor launches a chunk);
   flows/s beside ``Engine.run`` from numpy, each chunk's staging, host,
   upload, walk and fetch times against the streamed time (the overlap
   gated wherever the upload outlasts the host's cost), a pinned 1 GB
   upload, and ``Engine.run`` from the device held within 10 % of the walk
   and fetch it wraps;
4d. tune   -- ``calibrate`` on the card (the fitted coefficients: the
   ``cuda`` row of ``tuning.costmodel.DEFAULT_COEFFS``), ``impl="auto"``
   and ``"tuned"`` plans at the engine shape and at each streaming chunk
   shape on the dense and the three exit-profile models, each plan's
   verdicts equal to ``pdt.predict``, a second tuned call a cache hit;
   at 256 and 4,096 flows ``impl="auto"``'s pick within 10 % of the time
   of ``"tuned"``'s winner;
   the tick engine ``tick_engine="auto"`` picks at phase ``serve``'s table;
4e. fit    -- the trainer and the DSE's batched evaluator, the third
   path, on ``make_dataset("d2", 2^17, seed=1)`` split 70/30 (91,750 /
   39,322 flows): ``window_features(train, 3)`` on kernel A (one launch
   a call, counted; held against its plain version, and timed); for
   (3, 3, 3) at k = 4 and
   (10, 10, 10) at k = 6, ``train_partitioned_dt(trainer="torch")`` on
   the card equals the numpy trainer subtree for subtree, node for node,
   with each trainer's wall time, host syncs and seconds per partition,
   a traced run's device busy time and peak memory.  ``Engine.run`` of
   the (10, 10, 10) / k = 6 model (deep tables: the hop kernel's warp
   match) at the test split and tiled to 2^20 equals ``pdt.predict``;
   the hop kernel on its tables equals the plain hop (dense with and
   without the trace, survivor mode); its walk timed, at 2^20 also under
   the serial match it does not run.
   Then 4
   configurations drawn from ``SearchSpace()`` (seed 0) on 6 windows:
   ``evaluate_batch`` trains them on the card and equals the serial
   evaluator; on its models ``fleet_predict`` of the test windows equals
   each ``pdt.predict``, ``Engine.run`` and the CPU plain hop, with one
   hop-kernel launch a model's partition and none of kernels A and B;
   kernel B's two forms on each model's deep tables (random SIDs, -1
   among them, registers on the thresholds) against their plain
   versions; times of ``fleet_predict``, its hop launches (events, graph
   replay) and the plain hops beside their bound
   (from the flows still live at each hop), each model's walk alone
   beside its (S, k, T, L) and live flows a hop, M x ``Engine.run`` and
   M x ``pdt.predict``, at the test split and tiled to 2^20 flows.  Last, on ``make_dataset("d2",
   1200)``, a seeded ``bayes_search`` with the torch trainer and
   ``evaluate_batch`` gives the serial numpy history;
4f. system -- the paper's evaluation path (``tests/test_system.py``) at
   full width: ``make_dataset("d1", 2^17)`` split 70/30 (91,750 / 39,322
   flows, 19 classes); ``window_features`` at P = 2 and 3 and
   ``full_flow_features`` of both splits (kernel A, one launch a call;
   the full-flow launch at W = 192, the longest flow, k = 41 under one
   shared slot row); ``train_partitioned_dt(trainer="torch")`` at (6, 6)
   / k = 6, (5, 5, 5) / k = 6, (3, 3, 3) / k = 4 and (5, 5) / k = 4 on
   32-bit and on ``quantize_features(., 8)`` features;
   ``Engine.from_model(pdt).run`` of the (3, 3, 3) model (one hop launch
   a partition) == ``pdt.predict``, and an ``impl="ref"`` engine on the
   card == that ``cuda`` walk with no hop launch; the NetBeacon-style
   top-k baseline (k 6, depth 13) on the full-flow features,
   ``estimate`` and ``recirc_bandwidth`` for WS and HD; kernel A's
   full-flow registers == its plain version on both splits, timed
   beside its bound; last ``examples/quickstart_torch.py`` on the card
   (its labels == its ``pdt.predict``).  The claims' numbers are
   printed, not gated;
5. serve   -- live serving, the second path: the dataset of phase
   ``fit`` streamed by ``make_packet_stream(profile="steady",
   concurrency=65536)`` in ticks of 32,768 packets through
   ``FlowTableServer(eng, n_buckets=32768, bucket_size=8,
   tick_engine="fused")`` (the fused tick engine, passed explicitly;
   ``impl=None``: one launch of the tick kernel per tick), then
   ``flush()``.  The tick kernel launched once per tick and no other
   serving kernel (no flow spills in this stream, so no batch walk); one
   verdict per flow, each equal to ``Engine.run`` on the rebuilt windows
   and to ``pdt.predict``; packets/s, verdicts/s, per-tick host latency
   and each host span's share of serving time.  Then the server's registry
   through ``MetricsReporter(path, http_port=0)``: one ``dump_once()``
   line parses back to the snapshot, and an HTTP scrape of ``/metrics``
   on 127.0.0.1 equals ``to_prometheus()``;
6. serve_check -- both fold kernels against their plain versions at the
   serving rank width and at a width that is no multiple of a block, in
   the row form and in the table form (a copy of the resident state
   folded in place, dummy-row duplicates holding -0.0 and NaN; the real
   rows bit for bit against the row form); the
   tick kernel against its plain version (the rank loop, on a clone of
   the same state) on every tick of a 1,024-flow prefix with a 512-slot
   table (spill) and a timeout, on the 8 main-stream ticks up to the
   traced one, and on every tick of small streams served by k = 9 and
   k = 41 models (the tick kernel's capacity instantiations): every
   ``TickState`` field and verdict array; on that prefix the ``cuda``
   server against the ``fused`` server for both tick engines: every
   verdict in order and every stats field;
7. serve_times -- the tick kernel's device time at the steady-state
   tick's (R, C) (graph replay of restore-and-call less the restore),
   its call time, the rank loop's time; kernel B's two forms and
   ``dispatch_dt_traverse`` (one kernel node) at the serving width
   (graph replay); CUDA-event medians of both fold kernels and their
   plain versions, their device time from CUDA-graph replay; the table
   form as the legacy engine calls it (one kernel node) and at 2^20
   rows beside the floor of one PyTorch op; each beside its bound; one
   traced steady-state tick;
8. lm -- the LM slice at full width: ``rwkv6-1.6b`` (24 layers, D = 2048,
   32 heads of 64, vocab 65536, chunk 128, 1.6 B random f32 parameters
   made on the card from a seeded generator) served by
   ``ContinuousBatcher(slots=8, max_len=2048)``: 16 requests, prompts of
   300-1100 tokens drawn from the seed, 16 greedy tokens each,
   ``run_until_drained()``.  All complete, occupancy never exceeds 8, the
   ``chunk_scan`` kernel called 24 x (prefills + decode steps) times as
   24 x (3 x prefills + decode steps) device kernels (the library counts
   each launch),
   each request's tokens equal an isolated batch-1 prefill and decode
   (``==``); one prompt's prefill on the plain route with the kernel run
   beside every layer on that layer's inputs, each within the kernel
   tolerance below, and the logits of the full-width model cut to two
   layers within 0.05 * max |logit| of the plain route (at 24 layers the
   ratio is printed beside its floor, the plain route against itself
   with o nudged by 1e-7); prefill and decode tokens/s, tick p50/p99,
   peak device memory;
9. lm_check -- the ``chunk_scan`` kernel against its plain version in both
   forms at B*H = 32, T = 1024, C = 128; T = 1; T = 300 (padded); dk = dv =
   16 at C = 16; T = 4096 (32 chunks); T = 128 (one chunk); the kernel's
   padded and tiled paths (C = 37 and 100; dk = 40 and 44 with dv = 36 and
   30; dv = 96; dk = dv = 128); decays U[0.5, 0.999] and the model's own
   (layer 0 of a prefill): o within 2e-4 * max(|o|, 1), the state within
   3e-4; and the naive recurrence at decays >= 0.5 (at the model's decays
   its distance is printed, not gated: the reference's +-45 clip);
10. lm_times -- one traced decode tick and one traced prefill; CUDA-event
   medians of the kernel and its plain version at the prefill, decode and
   B*H = 256, T = 4096 shapes, and the kernel's device time from CUDA-graph
   replay, beside both bounds (the route's and the f32 one); its device
   kernels per call, counted twice (by the library at each launch and as
   kernel nodes of a captured graph); its registers, spills and shared
   memory (nvcc's ``-Xptxas -v`` log, the launch's shared memory and CTAs
   per SM);
10b. lm_dense -- the dense transformer family at full width:
   ``tinyllama-1.1b`` (22 layers, D = 2048, 32 query heads and 4 KV heads
   of 64, d_ff 5632, vocab 32000, 1.1 B random f32 parameters made on the
   card from a seeded generator) behind ``ContinuousBatcher(slots=8,
   max_len=2048)`` with phase ``lm``'s traffic (16 requests of 300-1100
   prompt tokens from the same seed, 16 greedy tokens each).  All
   complete, occupancy never exceeds 8, each request's tokens equal an
   isolated batch-1 prefill and decode (``==``); a teacher-forced
   prefill + decode equals the full forward within 0.05 x max |logit| at
   two layers (printed at 22 and with the blockwise prefill); the
   full-width ``tinyllama-1.1b``, ``granite-3-2b`` (tied, 8 KV heads) and
   ``paligemma-3b`` (one KV head of 256, gelu, 256 image tokens of prefix)
   cut to two layers give prefill logits into a 2,048-position cache (the
   blockwise path) on the card within 0.05 x max |logit| of the same
   parameters on the CPU with the products in f32 (with bf16 products the
   ratio is printed beside the CPU's own bf16-against-f32 ratio: at these
   widths the random-init attention is near one-hot, and one bf16 ulp in
   q or k moves whole positions); ``_attend_blockwise`` equals
   ``attend``'s naive path at the prefill shape (Tq = 1024, Tk = 2048, 32/4
   heads of 64, causal, kv_len 1024): f32 inputs within 2e-5, bf16 inputs
   within 2 bf16 ulps of the largest output, both timed; prefill and decode
   tokens/s, tick p50/p99, peak memory, one traced decode tick and one
   traced prefill.  No hand-written kernel: JAX runs this family on XLA
   products alone;
10c. lm_hybrid -- ``zamba2-2.7b`` at full width (D = 2560, 80 heads of
   64, N = 64, chunk 128, one shared attention block of 32 heads of 80
   every 6 layers) cut in depth to 18 of its 54 Mamba2 layers (3 of 9
   groups, random f32 parameters made on the card; the uncut config's
   2,396,455,840 counted from the defs; cut for the whole script's time)
   behind the same batcher and traffic: all complete,
   occupancy <= 8, ``chunk_scan`` (GLA form) launched 18 x (prefills +
   decode steps) times as 18 x (3 x prefills + decode steps) device
   kernels, tokens == isolated decode; every layer's own ``chunk_scan``
   call of one prefill and one decode step held against the plain chunked
   version (finite, within the kernel tolerance); one group (6 layers and
   the shared block) on the card within 0.05 x max |logit| of the CPU at
   f32 products, beside the floor (o x (1 + 2^-23)); the teacher-forced
   decode printed at one group and 18 layers; one 9,000-token request
   into a 16,384-position cache (the window slice at decode), the kernel
   at T = 9,000 against the plain version at the first and last layer,
   ``attend`` on the slice == the masked cache within 1e-5, cache bytes
   and a decode step with the slice on and off; the GLA kernel's times at
   B*H = 80 (T = 1,024, 1, 9,088) beside its bound; two traces;
10d. lm_moe -- ``qwen2-moe-a2.7b`` at full width (D = 2048, 60 routed
   experts padded to 64, top-4, 4 shared) cut in depth to 12 of its 24
   layers (random f32 parameters, the experts cast per call; the uncut
   config's 15,146,256,384 counted from the defs) behind the same
   batcher and traffic: all complete, tokens == isolated decode, the
   scatter dispatch (prompts over 1,024 tokens) and the einsum dispatch
   (the rest, every decode step) counted; two layers on the card within
   0.05 x max |logit| of the CPU at f32 products, with the share of
   routing choices that differ; tokens/s, tick p50/p99, peak memory and
   a traced decode tick.  No hand-written kernel;
10e. lm_mla -- ``deepseek-v2-236b`` at its published widths (D = 5,120,
   128 heads; MLA q_lora 1,536, kv_lora 512, qk_nope 128, qk_rope 64,
   v_head 128; 160 routed experts top-6 of d_ff 1,536, 2 shared, the
   dense lead layer of d_ff 12,288; vocab 102,400) cut in layers to the
   lead layer and 3 of the 59 MoE layers (13,302,912,000 random f32
   parameters, 53.2 GB; the uncut config's 235,741,434,880 counted from
   the defs) behind the same batcher and traffic: all complete, every
   layer of a prefill in MLA's cached direct form and of a decode step in
   its absorbed form (counted), tokens == isolated decode; one
   full-width MLA layer's absorbed form within 0.01 x max |o| of its
   cached direct form; that layer in each of its three forms and the
   model cut to 2 layers (lead + one MoE layer) on the card within 0.05
   x max |·| of the CPU at f32 products on 16 tokens; the teacher-forced
   decode at 4 layers printed; tokens/s, tick p50/p99, peak memory, the
   latent cache's bytes a slot beside plain MHA's, a traced decode tick.
   No hand-written kernel: JAX runs MLA on XLA products;
10f. lm_audio -- ``whisper-medium`` uncut (24 encoder and 24 decoder
   layers, D = 1,024, 16 heads of 64, d_ff 4,096, vocab 51,865;
   824,986,624 random f32 parameters) on JAX's encoder-decoder path,
   ``serve_step``'s prefill with frames then greedy decode steps (the
   batcher has no audio path in either package): 8 clips of 1,500 frame
   embeddings from the seed (the conv frontend is a stub), a 4-token
   prompt and 64 greedy tokens each, ``max_len`` 448, at batch 8 and at
   batch 1 a clip; encoder ms, time to first token, decode step p50 and
   tokens/s, peak memory, a traced batch-8 decode step, the share of
   batch-8 tokens equal to batch-1 tokens (reported: a batched GEMM
   rounds differently, so the first logits of both batches are printed
   with bf16 and with f32 products, beside how far a one-ulp nudge of
   the frames moves the f32 logits at 24 + 24 and at 2 + 2 layers);
   2 encoder + 2 decoder layers on the
   card within 0.05 x max |logit| of the CPU at f32 products (train,
   prefill, two decode steps); ``make_cache`` then decode within the
   same bound of a prefill with frames then decode.  No hand-written
   kernel;
10g. train -- the single-device trainer: ``launch.train`` on
   ``tinyllama-1.1b`` uncut (1.1 B f32 parameters from a seeded generator
   on the card), 30 steps of 8 x 512 Markov tokens in 2 microbatches at
   lr 2e-2, checkpointing every 25 steps into a directory of the
   checkout (free space printed and gated first): every loss finite, the
   mean of the last 5 below the first, tokens/s, step p50/p99, AdamW's ms
   and device kernels, peak memory, a traced step's idle share, each
   save's and the restore's seconds and GB/s, steps with a write in
   flight, every layer rematerialised in the backward as in JAX (then a
   few steps timed with remat on and off in turns); the restored
   ``step_30`` equals the run's state on every leaf
   (``torch.equal``), and a second run over a directory holding only
   ``step_25`` resumes there with step 26's loss ``==`` the first run's
   (later steps' drift printed); one ``make_train_step`` step of the
   model cut to 2 layers with f32 products on the card and on the CPU
   (plain, 2 microbatches, compressed; the CPU against itself on one
   thread is the floor): the loss within 1e-5, ``grad_norm`` 1e-4,
   mu 1e-3, nu 2e-3 (compressed: scales and mu where the int8 levels
   agree, 1e-3), each gradient bound raised to twice the floor where the
   floor is above it; reduced RWKV6 and Zamba2 losses under autograd on
   the card raise ``NoBackwardError`` and their no-grad forwards launch
   ``chunk_scan``.  No hand-written kernel: JAX trains on XLA products;
10h. train_long -- ``train_4k``'s 4,096-token rows: (a) ``launch.train``
   on ``tinyllama-1.1b`` uncut, 4 steps of 2 rows in 2 microbatches with
   remat, no checkpoint: finite losses, step p50/p99, tokens/s, peak
   memory and the state held, beside the dry run's one-chip budget
   (``analysis.memory``) for the shape; (b) the model cut to 4 layers,
   one row: ``loss_and_grads`` without remat (no checkpoint region at
   all), with, and without again: the loss with remat ``==`` without,
   every gradient within ``REMAT_REPEAT_FACTOR`` x the two remat-off
   runs' largest difference (so bit for bit where those agree), and the
   activation peak with remat at most ``REMAT_PEAK_RATIO`` of the one
   without.  No hand-written kernel;
10i. dist -- the multi-device half with one rank: a one-rank NCCL group
   (``distributed.group.init``, a ``file://`` store) and a (1, 1) ("data",
   "model") ``DeviceMesh`` on the card; ``compressed_psum`` over every
   leaf of ``tinyllama-1.1b``'s uncut parameter shapes (1.1 B f32 values
   from a seeded generator) without and with the error feedback ==
   ``compress_grads`` bit for bit, the tree's collective ms; the model cut
   to 2 layers placed by ``train_state_shardings``: sharded ``save`` ==
   plain ``save`` (arrays and template), ``restore`` with the shardings ==
   plain ``restore`` (DTensors on ``cuda``), ``remesh`` onto a one-rank
   ("data",) mesh keeps every value; ``pipeline_forward`` with one stage
   and M = 6 == the stage on each microbatch; the dry run's ``run_cell``
   of ``tinyllama-1.1b`` x ``train_4k`` (base, opt) and
   ``deepseek-v2-236b`` x ``decode_32k`` on 16x16 (traced on ``meta``,
   once whole and once sharded over a fake group of 256 ranks): each
   cell's collectives (counts and bytes by kind), ``t_collective_s`` and
   three-term bottleneck printed, its collective bytes > 0 and no group
   left behind; phase ``train``'s step counted at one chip: its p50 at
   least the counted ``t_compute`` (p50 over the op-bytes bound printed,
   not gated), and sharded over a (1, 1) mesh it emits no collective.
   No hand-written kernel: JAX's multi-device half has none;
11. the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.  Exits nonzero when there is
no CUDA card or when run outside a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

B_MAIN = 1 << 20          # engine batch: flows per Engine.run
SERVE_FLOWS = 1 << 17     # flows streamed through the live flow table
SERVE_CONCURRENCY = 65536  # mean concurrent flows of the steady stream
SERVE_TICK = 32768        # packets per ingest tick
SERVE_TABLE = (32768, 8)  # n_buckets, bucket_size: 2^18 slots
CHECK_FLOWS = 1024        # prefix served by both routes in serve_check
#                           (the plain rank loop over its ticks is most
#                           of that phase's time; 208 of its flows spill
#                           and 14 are evicted)
CHECK_TABLE = (64, 8)     # 512 slots: the prefix overflows into the spill
CHECK_CONCURRENCY = 2048.0
CHECK_TIMEOUT = 0.05      # stream seconds; evicts some idle flows (a
#                           shorter one evicts so many that none spill)
CHECK_TICK = 4096
FOLD_PAD = 37             # dummy-row duplicates padding a checked fold rank
FOLD_ROWS = 1 << 20       # rows of the fold's table form timed at scale
MAIN_TICKS_CHECKED = 8    # main-stream ticks held against the rank loop
WIDE_K = (9, 41)          # models past the tick kernel's register templates
WIDE_FLOWS = 1024         # flows of each such stream
WIDE_TABLE = (16, 8)      # 128 slots: the stream spills
WIDE_CONCURRENCY = 512.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 494.7e12  # H100 SXM TF32 tensor cores, dense
FIT_CONFIGS = (((3, 3, 3), 4),     # the engine's model
               ((10, 10, 10), 6))  # SearchSpace's deepest, k_max, 41 features
FLEET_BATCH = 4           # bayes_search's default proposal batch
FLEET_SEED = 0
FLEET_FLOWS = 100_000     # the evaluator's flow target (tests/test_fit.py)
DSE_SMALL = 1200          # make_dataset("d2", 1200): tests/test_fit.py's data
SYSTEM_FLOWS = 1 << 17    # phase system: make_dataset("d1", SYSTEM_FLOWS)
SYSTEM_MODELS = {         # tests/test_system.py's models: sizes, k
    "splidt": ((6, 6), 6), "scaling": ((5, 5, 5), 6),
    "engine": ((3, 3, 3), 4), "f32": ((5, 5), 4), "f8": ((5, 5), 4)}
# micro-batches of phase stream (4096 is the JAX package's default, 65536
# the card's, core.inference.MICRO_BATCH) and the probe sizes of phase
# tune's calibrate
STREAM_MB = (4096, 65536, 262144)
CALIBRATE_SIZES = (256, 4096, 65536, 262144)
HOST_CHUNKS, HOST_CHUNK_FLOWS = 256, 64   # phase stream's host-cost probe
ROUTE_SIZES = (256, 4096)  # batches at which impl="auto" is held to "tuned"
ROUTE_MARGIN = 1.10        # auto's pick may take this much of tuned's time
RUN_MARGIN = 1.10          # Engine.run from the device over its walk+fetch
LM_ARCH = "rwkv6-1.6b"
LM_SLOTS, LM_MAX_LEN = 8, 2048
LM_REQUESTS, LM_MAX_NEW = 16, 16
LM_PROMPT = (300, 1100)    # prompt lengths, drawn from the seed
LM_SEED = 13
LOGIT_TOL = 0.05           # x max |logit|: the bound of tests/test_models.py
LOGIT_DEPTH = 2            # layers of the logits gate (the reduced depth)
SCAN_O_TOL, SCAN_S_TOL = 2e-4, 3e-4   # tests/test_kernels.py
LM_DENSE_ARCH = "tinyllama-1.1b"     # phase lm_dense: the dense family
LM_DENSE_CUTS = ("tinyllama-1.1b", "granite-3-2b", "paligemma-3b")
LM_CPU_PROMPT = 128        # text tokens of the card-against-CPU logits gate
LM_FORCED = (48, 40)       # teacher-forced tokens, of which prefilled
ATTN_PREFILL = (1024, 2048, 32, 4, 64)   # Tq, Tk, query heads, KV heads, d
ATTN_F32_ATOL = 2e-5       # tests/test_perf_layouts.py, f32 inputs
ATTN_BF16_ULPS = 2         # bf16 inputs: 2 bf16 ulps of max |naive|
LM_HYBRID_ARCH = "zamba2-2.7b"      # phase lm_hybrid: the hybrid family
LM_HYBRID_LAYERS = 18      # 3 of its 9 groups (6 Mamba2 layers and the
#                           shared block each): the whole script went past
#                           1,100 s on a slow machine with phase dist added
LONG_PROMPT, LONG_MAX_LEN = 9000, 16384  # its long context: > 2 x window
WINDOW_ATOL = 1e-5         # tests/test_perf_layouts.py, the window slice
LM_MOE_ARCH = "qwen2-moe-a2.7b"     # phase lm_moe: the MoE family
LM_MOE_LAYERS = 12         # 12 of its 24 layers, for the same reason
LM_MLA_ARCH = "deepseek-v2-236b"    # phase lm_mla: MLA (and MoE)
LM_MLA_LAYERS = 4          # the dense lead layer and 3 of the 59 MoE
#                           layers: 53.2 GB of f32 parameters (5: 69.1)
LM_MLA_TOKENS = 16         # tokens of the MLA card-against-CPU gates
MLA_FORMS_TOL = 0.01       # x max |o|: tests/test_models.py, absorbed
#                           against direct
LM_AUDIO_ARCH = "whisper-medium"    # phase lm_audio: the encoder-decoder
AUDIO_CLIPS, AUDIO_FRAMES = 8, 1500  # 30 s clips after the (stub) frontend
AUDIO_PROMPT, AUDIO_NEW = 4, 64     # decoder prompt, greedy tokens a clip
AUDIO_MAX_LEN = 448        # Whisper's decoder limit
TRAIN_ARCH = "tinyllama-1.1b"       # phase train: the single-device trainer
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 30, 8, 512
TRAIN_MICRO = 2            # microbatches a step
TRAIN_LR = 2e-2            # from a sweep of 1e-4..2e-2 (PERF.md §6)
TRAIN_RESUME_AT = 25       # N: run A (the 30-step run) saves step_N
TRAIN_HELDOUT = 10_000     # batch_at index of gate (a)'s held-out batch
TRAIN_MIN_DROP = 1e-3      # its loss drop over the run, nats (frozen: 0)
TRAIN_CUT = 2              # layers of the card-against-CPU step
TRAIN_CPU_BATCH = (4, 32)  # its batch: sequences x tokens
# its limits, card against CPU (relative).  At full width the random-init
# attention is near one-hot, so the f32 summation order alone moves the
# gradients: the CPU on one thread against the CPU on all of its threads
# read grad_norm 4.1e-4, mu 1.6e-3, nu 2.6e-3, and the card 1.6-1.9e-4,
# 1.1-1.5e-3, 1.6-2.8e-3, scales 1.6e-3 (PERF.md §6).  The loss is
# held at 1e-5; each other limit sits above the card's reading.
TRAIN_VS_CPU_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 3e-4,
                    "mu_rel": 1.6e-3, "nu_rel": 3e-3, "scale_rel_max": 2e-3,
                    "mu_rel_where_levels_agree": 2e-3}
TRAIN_SCAN_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")  # chunk_scan families
# phase train: steps timed with remat (True) and without, in turns
TRAIN_REMAT_AB = (True, False, False, True, True, False)
TRAIN_LONG_SHAPE = "train_4k"       # phase train_long: its rows' length
TRAIN_LONG_STEPS, TRAIN_LONG_BATCH, TRAIN_LONG_MICRO = 4, 2, 2
TRAIN_LONG_CUT = 4         # layers of the remat-against-none comparison
REMAT_PEAK_RATIO = 0.25    # its activation peak with remat over without
REMAT_REPEAT_FACTOR = 4    # its gradient gap over the card's own repeat
DIST_TREE_VALUES = 1_100_048_384   # phase dist: TRAIN_ARCH's parameters
SCAN_KERNELS = {"chunked": 3, "step": 1}  # chunk_scan's device kernels a
#                           call by design: C >= 2 (prep, state pass,
#                           output) and C == 1 (one step)
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def same_bits(a, b) -> bool:
    """Equal bit for bit, the sign of a zero included; a NaN equals a NaN
    of any payload."""
    import torch
    if not a.is_floating_point():
        return torch.equal(a, b)
    return a.shape == b.shape and bool(
        ((a.view(torch.int32) == b.view(torch.int32))
         | (a.isnan() & b.isnan())).all())


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def cuda_ms_after(prep, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` alone, ``prep`` run before each
    call outside the events."""
    import torch
    for _ in range(warmup):
        prep()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        prep()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def graph_ms(fn, n: int, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph and replayed (CUDA-event median over ``reps`` replays), so no
    host launch cost is in it and no profiler is needed."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    torch.cuda.synchronize()
    return cuda_ms(g.replay, reps=reps, warmup=1) / n


def graph_kernel_nodes(fn) -> int:
    """Kernel nodes in a CUDA graph that captured one call of ``fn``, read
    through the CUDA runtime: the device kernels the call launched."""
    import ctypes

    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    rt = ctypes.CDLL("libcudart.so.12")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    check(rt.cudaGraphGetNodes(graph, None, ctypes.byref(n)) == 0,
          "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0,
          "cudaGraphGetNodes")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0,
              "cudaGraphNodeGetType")
        kernels += kind.value == 0        # cudaGraphNodeTypeKernel
    del g
    return kernels


def host_s(fn, reps: int) -> float:
    """Median host-clock seconds of ``fn`` (which ends in a host fetch)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_run(fn, top: int = 12, warmup: bool = True,
                ranges: str | None = None, card_only: bool = False) -> dict:
    """One traced call of ``fn`` (after an untraced one if ``warmup``):
    wall time, device busy time (the sum of kernel and copy time on the
    card) and the top device consumers; with ``ranges``, also the host
    and device time the trace attributes to each ``record_function``
    range whose name starts with it (the ``obs.span`` markers).
    ``card_only`` traces the card's activity alone and reads the raw
    device events: for a call of ~10^5 launches, building the profiler's
    event tree takes most of a minute."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if not card_only:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets), as (name, calls,
    # ms): the host ops that launched them carry the same time again, and
    # so do the device-side spans of the ``ranges`` markers
    if card_only:
        agg = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA \
                    and not e.is_user_annotation():
                n, ns = agg.get(e.name(), (0, 0))
                agg[e.name()] = (n + 1, ns + e.duration_ns())
        events = [(k, n, ns / 1e6) for k, (n, ns) in agg.items() if ns > 0]
    else:
        events = [(e.key, e.count, e.self_device_time_total / 1e3)
                  for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")
                  and e.self_device_time_total > 0
                  and not (ranges and e.key.startswith(ranges))]
    busy_ms = sum(ms for _, _, ms in events)
    events.sort(key=lambda e: e[2], reverse=True)
    copies = ("Memcpy", "Memset")
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_event_kinds": len(events),
           # device kernels launched, copies and fills left out
           "device_kernels": sum(n for k, n, _ in events
                                 if not k.startswith(copies)),
           "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
           "top": [{"name": k[:80], "calls": n, "device_ms": ms}
                   for k, n, ms in events[:top]]}
    if ranges is not None:
        # each marker shows up twice: on the host (its wall time and the
        # device time of the kernels it launched) and on the device (the
        # span from its first kernel's start to its last one's end)
        rows = out["ranges"] = {}
        for e in prof.key_averages():
            if not e.key.startswith(ranges):
                continue
            r = rows.setdefault(e.key, {})
            if str(e.device_type).endswith("CUDA"):
                r["device_span_ms"] = e.device_time_total / 1e3
            else:
                r.update(calls=e.count, host_ms=e.cpu_time_total / 1e3,
                         device_ms_launched=e.device_time_total / 1e3)
    return out


def tick_vs_plain(tk, log: dict):
    """A stand-in for ``kernels.tick_step.tick_step`` on the card route:
    the tick kernel runs on the server's state, the plain rank loop on a
    clone of the state as it was, and every ``TickState`` field (rows
    ``[:N]``) and the five verdict arrays must be equal (``torch.equal``).
    ``log`` gathers the ticks, cells and verdicts compared and keeps the
    last tick's inputs and plain result (``"last"``)."""
    import torch
    orig = tk.tick_step

    def both(state, slots_rc, pkt_rc, dev, *, n_subtrees, cuda):
        check(cuda, "the serving route under check runs the kernels")
        before = tk.TickState(*(t.clone() for t in state))
        plain = tk.TickState(*(t.clone() for t in state))
        _, want = orig(plain, slots_rc, pkt_rc, dev, n_subtrees=n_subtrees,
                       cuda=False)
        got = orig(state, slots_rc, pkt_rc, dev, n_subtrees=n_subtrees,
                   cuda=True)
        torch.cuda.synchronize()
        N = state.sid.shape[0] - 1
        for name in tk.TickState._fields:
            check(torch.equal(getattr(state, name)[:N],
                              getattr(plain, name)[:N]),
                  f"tick kernel == rank loop: {name}, tick {log['ticks']}")
        for i, (a, b) in enumerate(zip(got[1], want)):
            check(torch.equal(a, b),
                  f"tick kernel == rank loop: verdict {i}, tick "
                  f"{log['ticks']}")
        log["ticks"] += 1
        log["cells"] += int((slots_rc != N).sum())
        log["verdicts"] += int(want[0].sum())
        log["shapes"].add(f"{slots_rc.shape[0]}x{slots_rc.shape[1]}")
        log["last"] = (before, slots_rc, pkt_rc, plain)
        return got

    return both


def new_tick_log() -> dict:
    return {"ticks": 0, "cells": 0, "verdicts": 0, "shapes": set()}


def tick_log_summary(log: dict) -> dict:
    return {"ticks": log["ticks"], "cells": log["cells"],
            "verdicts": log["verdicts"], "shapes": sorted(log["shapes"]),
            "equal": True, "max_abs_err": 0.0}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def feature_window_bound(n: int, w: int, kk: int,
                         shared_rows: bool = False) -> tuple[float, str]:
    """Kernel A's least time: the (n, w, 6) window and four (n, kk) slot
    rows (one (1, kk) row each with ``shared_rows``) read once, the
    (n, kk) registers written once; 3 f32 multiplies and 3 adds a packet
    and slot."""
    n_rows = 1 if shared_rows else n
    n_bytes = n * w * 6 * 4 + n_rows * kk * 4 * 4 + n * kk * 4
    return bound_ms(n_bytes, n * kk * w * 6)


def under_match(match: str, fn):
    """``fn()`` with the hop kernel's match forced to ``match``
    (``"serial"``: one thread a flow; ``"warp"``: a warp a flow) through
    ``engine_hop.WARP_MATCH_MIN_LEAVES``, restored after."""
    from repro_torch.kernels import engine_hop as eh
    keep = eh.WARP_MATCH_MIN_LEAVES
    eh.WARP_MATCH_MIN_LEAVES = 1 if match == "warp" else 1 << 30
    try:
        return fn()
    finally:
        eh.WARP_MATCH_MIN_LEAVES = keep


def walk_bound(eng, B: int, W: int, exit_p=None,
               with_trace: bool = True) -> tuple[float, str]:
    """The least time of one walk of ``eng``'s tables over B flows: each
    hop ``p`` reads the (W, 6) windows and the carry (17 bytes a flow,
    read and written) of the flows it must walk (all of them with the
    trace, else those live entering it: ``exit_p`` < 0 or >= p) and
    writes their k registers with the trace; the tables are read once;
    3 f32 multiplies and 3 adds a packet and slot walked."""
    n_bytes = n_ops = 0
    k = eng.tables.dev.slot_op.shape[1]
    for p in range(eng.tables.n_partitions):
        n = B if with_trace else int(((exit_p < 0) | (exit_p >= p)).sum())
        n_bytes += n * (W * 6 * 4 + 17 * 2) + (B * k * 4 if with_trace
                                                 else 0)
        n_ops += n * k * W * 6
    n_bytes += sum(t.numel() * t.element_size() for t in eng.tables.dev)
    return bound_ms(n_bytes, n_ops)


def same_models(a, b) -> bool:
    """Two ``PartitionedDT``s equal subtree for subtree: SIDs in the same
    order, the same partitions and routing, node for node the same trees
    (feature, threshold, left, right, value)."""
    if len(a.subtrees) != len(b.subtrees):
        return False
    return all(
        (x.sid, x.partition, x.leaf_next_sid, x.leaf_label)
        == (y.sid, y.partition, y.leaf_next_sid, y.leaf_label)
        and all(np.array_equal(getattr(x.tree, f), getattr(y.tree, f))
                for f in ("feature", "threshold", "left", "right", "value"))
        for x, y in zip(a.subtrees, b.subtrees))


def chunk_scan_bound(bh: int, t: int, dk: int, dv: int, c: int,
                     use_bonus: bool) -> dict:
    """The least time of ``chunk_scan`` (the kernel that replaces
    ``chunk_scan_pallas``, src/repro/kernels/chunk_scan.py:92) at one
    shape.  Bytes: q, k, decay (B*H, T, dk), v and o (B*H, T, dv), the
    bonus and the state in and out, each once.  Operations, 2 flops a
    multiply-add, per chunk of C = min(c, T): the two intra-chunk products
    over the causal triangle only, C (C + 1) / 2 entries of dk + dv
    multiply-adds (the GLA form's inclusive triangle; the bonus form's
    strictly causal one plus its diagonal term (q u k) v, with C dk more
    multiplies for u), and the two state products (C x dk x dv each).  The
    decay's logs, prefix sums and exponents are left out.

    ``bound_ms`` follows the kernel's route: for C >= 2 the products run
    on the tensor cores in split TF32, three TF32 products per f32
    product, so operations count 3x over 494.7 TFLOP/s; the one-step
    kernel (C == 1) runs f32 on the CUDA cores at 67 TFLOP/s.
    ``bound_f32_ms`` is the f32 CUDA-core figure for every C (the bound
    of the f32 kernel measured before the tensor-core route)."""
    c = min(c, t)
    n_bytes = 4 * (bh * t * (3 * dk + 2 * dv) + bh * dk + 2 * bh * dk * dv)
    intra = c * (c + 1) * (dk + dv) + (c * dk if use_bonus else 0)
    n_ops = bh * (t // c) * (intra + 2 * 2 * c * dk * dv)
    f32_ms, f32_by = bound_ms(n_bytes, n_ops)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / F32_OPS_PER_S if c == 1
             else 3 * n_ops / TF32_OPS_PER_S) * 1e3
    return {"shape": f"B*H={bh},T={t},dk={dk},dv={dv},C={c},"
                     f"bonus={use_bonus}",
            "bytes": n_bytes, "ops": n_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_route": "f32 CUDA cores" if c == 1 else "split TF32",
            "bound_f32_ms": f32_ms, "bound_f32_by": f32_by}


def chunk_scan_resources(out_dir: pathlib.Path) -> dict:
    """Registers, spills and static shared memory of each ``chunk_scan``
    kernel, from nvcc's ``-Xptxas -v`` log beside its library."""
    import re
    res, name = {}, None
    for ln in (out_dir / "chunk_scan.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            name = next(k for k in ("chunk_prep_kernel", "state_pass_kernel",
                                    "chunk_out_kernel", "step_kernel")
                        if k in mangled)
            if "ILb1E" in mangled:
                name += "<bonus>"
            elif "ILb0E" in mangled:
                name += "<gla>"
            res[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            res[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            res[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", ln)
            res[name]["static_smem_bytes"] = int(s.group(1)) if s else 0
    return res


def kernel_resources(out_dir: pathlib.Path, stem: str) -> dict:
    """Registers, stack and spills of each kernel of one source, from
    nvcc's ``-Xptxas -v`` log beside its library; a tick-kernel
    instantiation is named by its capacity and whether k equals it."""
    import re
    res, name = {}, None
    for ln in (out_dir / f"{stem}.log").read_text().splitlines():
        # the name follows its length in the mangled symbol
        m = re.search(r"Compiling entry function '\S*?\d([a-z_]+_kernel)"
                      r"(?:ILi(\d+)ELb([01])E)?", ln)
        if m:
            name = m.group(1)
            if m.group(2):
                name += (f"<{m.group(2)}, "
                         f"{'exact' if m.group(3) == '1' else 'capacity'}>")
            res[name] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            res[name].update(stack_bytes=int(m.group(1)),
                             spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            res[name]["registers"] = int(m.group(1))
    return res


def reporter_check(registry) -> dict:
    """``MetricsReporter(path, http_port=0)`` over ``registry``: one
    ``dump_once()`` line must parse back to the registry's snapshot and an
    HTTP scrape of ``/metrics`` on 127.0.0.1 must equal
    ``to_prometheus()``, byte for byte."""
    import urllib.request
    from repro_torch.obs import MetricsReporter
    path = ROOT / "build" / "metrics_smoke.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    rep = MetricsReporter(str(path), registry=registry, http_port=0)
    try:
        rep.dump_once()
        port = rep.http_port
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode()
        scrape_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rep.close()
    check(rep.http_port is None, "the reporter's endpoint is closed")
    lines = path.read_text().splitlines()
    first = json.loads(lines[0])
    check(first.pop("seq") == 0 and len(lines) == 2,
          "one dumped line, then close()'s final line")
    check(json.dumps(first, sort_keys=True) == registry.to_json(),
          "the JSONL line parses back to the registry's snapshot")
    check(body == registry.to_prometheus(),
          "the HTTP scrape equals to_prometheus()")
    snap = registry.snapshot()
    return {"jsonl_bytes": len(lines[0]), "scrape_bytes": len(body),
            "scrape_ms": scrape_ms,
            "metrics": {kind: len(v) for kind, v in snap.items()},
            "jsonl_equals_snapshot": True,
            "scrape_equals_to_prometheus": True}


def lm_phases(card, smi: str, out_dir: pathlib.Path) -> dict:
    """Phases 8-10, the LM slice; returns its row of the kernels line."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import pspec
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model_zoo
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.serve.serve_step import make_prefill_step

    # f32 products in full f32 on the plain route, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 8. rwkv6-1.6b at full width behind the continuous batcher -----------
    cfg = get_arch(LM_ARCH)
    H, hd = cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
    check((cfg.n_layers, cfg.d_model, H, hd, cfg.d_ff, cfg.vocab,
           cfg.ssm.chunk) == (24, 2048, 32, 64, 7168, 65536, 128),
          f"{LM_ARCH} at its published widths")
    zoo = model_zoo.get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=card).manual_seed(0)
    model = zoo.build(cfg, pspec.init_params(zoo.param_defs(cfg), gen, card))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), "every declared parameter is made")
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    prefill = make_prefill_step(cfg)
    # warm-up outside the counted run: cuBLAS handles, the bf16 weight copy
    with torch.no_grad():
        warm = torch.from_numpy(np.asarray([prompts[-1][:256]], np.int32))
        prefill(model, {"tokens": warm.to(card)},
                zoo.init_cache(cfg, 1, LM_MAX_LEN, card))
    torch.cuda.synchronize()

    cs.launches = cs.kernel_launches = 0
    reqs, served = serve_requests(cfg, model, prompts, card)
    launches, kernel_launches = cs.launches, cs.kernel_launches
    n_pre, n_dec = served["prefills"], served["decode_steps"]
    check(launches == cfg.n_layers * (n_pre + n_dec),
          f"chunk_scan launched {launches} times, want "
          f"{cfg.n_layers} x ({n_pre} + {n_dec})")
    # the library counts each device kernel it launched: every prompt is
    # longer than one step (the chunk-parallel kernels), every decode step
    # one step (the one-step kernel)
    want_k = cfg.n_layers * (SCAN_KERNELS["chunked"] * n_pre
                             + SCAN_KERNELS["step"] * n_dec)
    check(kernel_launches == want_k,
          f"chunk_scan device kernels {kernel_launches}, want {want_k}")
    check_isolated(cfg, model, reqs, card)

    # one prompt's prefill, kernel route against plain route.  (a) Every
    # layer: the plain route's forward, with the kernel run beside it on
    # that layer's very inputs, within the kernel tolerance.  (b) Logits:
    # the full-width model cut to its first LOGIT_DEPTH layers, within
    # 0.05 x max |logit|.  (c) At all 24 layers the logits are printed
    # beside the floor: the plain route against itself with every
    # layer's o scaled by (1 + 1e-7), about one f32 ulp.  Random
    # weights amplify any such difference layer after layer, so a bound
    # on 24-layer logits would not test the kernel.
    toks = torch.tensor([prompts[0]], dtype=torch.int32, device=card)
    shadow, captured = [], []
    real_scan = rwkv_mod.ops.chunk_scan

    def beside(*a, **kw):
        o, s = real_scan(*a, **kw)                   # the plain route
        if not captured:
            captured.append((a, kw))
        ko, ks = real_scan(*a, **dict(kw, impl=None))   # the kernel
        shadow.append((float((ko - o).abs().max()),
                       max(float(o.abs().max()), 1.0),
                       float((ks - s).abs().max())))
        return o, s

    def nudged(*a, **kw):
        o, s = real_scan(*a, **kw)
        return o * (1.0 + 1e-7), s

    def prefill_logits(m, c, impl, scan=None):
        rwkv_mod.ops.chunk_scan = scan or real_scan
        try:
            with torch.no_grad():
                lg, _, _ = m({"tokens": toks}, mode="prefill", impl=impl,
                             cache=zoo.init_cache(c, 1, LM_MAX_LEN, card))
        finally:
            rwkv_mod.ops.chunk_scan = real_scan
        return lg.float()

    ratio = lambda a, b: float((a - b).abs().max() / b.abs().max())
    prefill_logits(model, cfg, "ref", scan=beside)
    check(len(shadow) == cfg.n_layers and all(
        eo <= SCAN_O_TOL * sc and es <= SCAN_S_TOL for eo, sc, es in shadow),
        f"kernel within tolerance of the plain route at every layer: "
        f"{shadow}")
    lk = prefill_logits(model, cfg, None)
    lp = prefill_logits(model, cfg, "ref")
    ln = prefill_logits(model, cfg, "ref", scan=nudged)
    check(bool(torch.isfinite(lk).all()) and lk.shape == (
        1, len(prompts[0]), cfg.vocab), "finite logits of the right shape")
    cut_cfg, cut = cut_layers(model, LOGIT_DEPTH)
    logit_ratio = ratio(prefill_logits(cut, cut_cfg, None),
                        prefill_logits(cut, cut_cfg, "ref"))
    del cut
    check(logit_ratio <= LOGIT_TOL,
          f"kernel-route logits at depth {LOGIT_DEPTH} within {LOGIT_TOL} x "
          f"max |logit| of the plain route, got {logit_ratio}")
    argmax_agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    emit("lm", card=smi, arch=LM_ARCH, n_params=n_params, init_s=init_s,
         **served, chunk_scan_launches=launches,
         chunk_scan_kernel_launches=kernel_launches,
         tokens_equal_isolated_decode=True,
         prompt0_len=len(prompts[0]),
         layers_kernel_vs_plain=[{"o_max_abs_err": eo, "o_scale": sc,
                                  "state_max_abs_err": es}
                                 for eo, sc, es in shadow],
         logits_depth=LOGIT_DEPTH, logits_kernel_vs_plain_ratio=logit_ratio,
         logits24_kernel_vs_plain_ratio=ratio(lk, lp),
         logits24_floor_ratio=ratio(ln, lp),
         logits24_argmax_agreement=argmax_agree,
         logits24_floor_argmax_agreement=float(
             (ln.argmax(-1) == lp.argmax(-1)).float().mean()))

    # -- 9. the kernel against its plain version ----------------------------
    inputs = lambda bh, t, dk, dv, seed: scan_inputs(card, bh, t, dk, dv,
                                                     seed)

    # the model's own inputs: layer 0's call in the prefill above
    (mq, mk, mv, mw), mkw = captured[0][0][:4], captured[0][1]
    cases = []
    for bonus in (False, True):
        cases += [
            (f"B*H=32,T=1024,C=128,uniform,bonus={bonus}",
             inputs(32, 1024, 64, 64, 1), 128, bonus, True),
            (f"B*H=32,T=1,C=1,uniform,bonus={bonus}",
             inputs(32, 1, 64, 64, 2), 128, bonus, True),
            (f"B*H=32,T=300(padded),C=128,uniform,bonus={bonus}",
             inputs(32, 300, 64, 64, 3), 128, bonus, True),
            (f"B*H=8,T=64,dk=dv=16,C=16,uniform,bonus={bonus}",
             inputs(8, 64, 16, 16, 4), 16, bonus, True),
            (f"B*H=32,T=4096,C=128,uniform,bonus={bonus}",
             inputs(32, 4096, 64, 64, 6), 128, bonus, True),
            (f"B*H=32,T=128,C=128,uniform,bonus={bonus}",
             inputs(32, 128, 64, 64, 7), 128, bonus, True),
            # the kernel's padded and tiled paths: C = 37 (rows padded to
            # 48), C = 100 (a second row tile of 36), dk = 40 and 44 (padded
            # to 48) with dv = 36 and 30 (a partial column tile; 30 rows of
            # v are not 16-byte aligned), dv = 96 (a half-width second dv
            # tile), dk = dv = 128 (the largest dk, two dv tiles)
            (f"B*H=32,T=37,C=37,uniform,bonus={bonus}",
             inputs(32, 37, 64, 64, 8), 128, bonus, True),
            (f"B*H=32,T=100,C=100,uniform,bonus={bonus}",
             inputs(32, 100, 64, 64, 9), 128, bonus, True),
            (f"B*H=8,T=256,dk=40,dv=36,C=128,uniform,bonus={bonus}",
             inputs(8, 256, 40, 36, 10), 128, bonus, True),
            (f"B*H=8,T=200(padded),dk=44,dv=30,C=64,uniform,bonus={bonus}",
             inputs(8, 200, 44, 30, 11), 64, bonus, True),
            (f"B*H=8,T=256,dv=96,C=128,uniform,bonus={bonus}",
             inputs(8, 256, 64, 96, 12), 128, bonus, True),
            (f"B*H=8,T=256,dk=dv=128,C=128,uniform,bonus={bonus}",
             inputs(8, 256, 128, 128, 13), 128, bonus, True),
            (f"model layer 0,B*H=32,T={mq.shape[1]},C=128,bonus={bonus}",
             (mq, mk, mv, mw, mkw["bonus"], mkw["state"] if mkw["state"]
              is not None else torch.zeros(32, 64, 64, device=card)),
             128, bonus, False)]
    comparisons, err_o, err_s = {}, 0.0, 0.0
    for name, (q, k, v, w, u, s0), chunk, bonus, gate_naive in cases:
        u = u if bonus else None
        with torch.no_grad():
            got = ops.chunk_scan(q, k, v, w, u, s0, chunk=chunk)
            want = ops.chunk_scan(q, k, v, w, u, s0, chunk=chunk,
                                  impl="ref")
            naive = ref.chunk_scan_ref(q, k, v, w, u, s0)
        torch.cuda.synchronize()
        scale = max(float(want[0].abs().max()), 1.0)
        eo = float((got[0] - want[0]).abs().max())
        es = float((got[1] - want[1]).abs().max())
        no = float((got[0] - naive[0]).abs().max())
        ns = float((got[1] - naive[1]).abs().max())
        nscale = max(float(naive[0].abs().max()), 1.0)
        comparisons[name] = {
            "o_max_abs_err": eo, "o_scale": scale, "state_max_abs_err": es,
            "naive_o_max_abs": no, "naive_o_scale": nscale,
            "naive_state_max_abs": ns,
            "decay_min": float(w.min()), "decay_max": float(w.max())}
        check(eo <= SCAN_O_TOL * scale and es <= SCAN_S_TOL,
              f"chunk_scan kernel vs plain, {name}: o {eo} (scale {scale}),"
              f" state {es}")
        if gate_naive:
            check(no <= SCAN_O_TOL * nscale and ns <= SCAN_S_TOL,
                  f"chunk_scan kernel vs naive recurrence, {name}: o {no}, "
                  f"state {ns}")
        err_o, err_s = max(err_o, eo), max(err_s, es)
    emit("lm_check", tolerance=f"o <= {SCAN_O_TOL} * max(|o|, 1), state <= "
         f"{SCAN_S_TOL}; naive gated at decays >= 0.5 only",
         comparisons=comparisons)

    # -- 10. times -------------------------------------------------------------
    # a decode tick of 8 live slots, and one prefill of 1,024 tokens, traced
    traced = traces(cfg, model, prompts, rng, card)
    # the kernel and its plain version: CUDA events around one call (what
    # a caller waits), and the kernel's device time from graph replay
    rows = {}
    for label, (bh, t, n) in (("prefill", (32, 1024, 10)),
                              ("decode", (32, 1, 200)),
                              ("large", (256, 4096, 2))):
        q, k, v, w, u, s0 = inputs(bh, t, 64, 64, 5)
        kern = lambda: cs.chunk_scan_kernel(q, k, v, w, u, s0, chunk=128,
                                            use_bonus=True)
        plain = lambda: ref.chunk_scan_chunked_ref(q, k, v, w, u, s0,
                                                   chunk=min(128, t))
        reps = 50 if t == 1 else 10
        before = cs.kernel_launches
        kern()
        counted = cs.kernel_launches - before
        nodes = graph_kernel_nodes(kern)
        want = SCAN_KERNELS["step" if t == 1 else "chunked"]
        check(counted == nodes == want,
              f"chunk_scan kernels a call at {label}: library count "
              f"{counted}, graph kernel nodes {nodes}, want {want}")
        rows[label] = {**chunk_scan_bound(bh, t, 64, 64, 128, True),
                       "kernels_per_call": counted,
                       "graph_kernel_nodes_per_call": nodes,
                       "ms": cuda_ms(kern, reps=reps, warmup=3),
                       "device_ms": graph_ms(kern, n),
                       "plain_ms": cuda_ms(plain, reps=reps, warmup=2)}
    resources = {"ptxas": chunk_scan_resources(out_dir),
                 **cs.resources(128, 64, 64, True)}
    emit("lm_times", card=smi, chunk_scan=rows, resources=resources,
         **traced)

    p, d, big = rows["prefill"], rows["decode"], rows["large"]
    return {"name": "chunk_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/chunk_scan.cu",
            "replaces": "src/repro/kernels/chunk_scan.py:92",
            "launches": launches,
            "launches_path": "lm: 24 per prefill and per decode step",
            "kernel_launches": kernel_launches,
            "kernels_per_call": {"prefill": p["kernels_per_call"],
                                 "decode": d["kernels_per_call"]},
            "graph_kernel_nodes_per_call": {
                "prefill": p["graph_kernel_nodes_per_call"],
                "decode": d["graph_kernel_nodes_per_call"]},
            "max_abs_err": max(err_o, err_s), "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"], "bound_f32_ms": p["bound_f32_ms"],
            "library_ms": None,
            "shape": p["shape"],
            "device_ms": p["device_ms"],
            "decode_ms": d["ms"], "decode_device_ms": d["device_ms"],
            "decode_bound_ms": d["bound_ms"],
            "large_device_ms": big["device_ms"],
            "large_plain_ms": big["plain_ms"],
            "large_bound_ms": big["bound_ms"],
            "large_bound_f32_ms": big["bound_f32_ms"],
            "resources": resources,
            "tolerance": f"o {SCAN_O_TOL} x max(|o|,1), state {SCAN_S_TOL}"}


def scan_inputs(card, bh, t, dk, dv, seed, decays=(0.5, 0.999),
                per_head=False):
    """Seeded ``chunk_scan`` inputs on the card: q, k (bh, t, dk), v
    (bh, t, dv), decays uniform in ``decays`` (one a row and step
    broadcast over dk if ``per_head``, as Mamba2's), a bonus (bh, dk) and
    an initial state (bh, dk, dv)."""
    import torch
    g = torch.Generator(device=card).manual_seed(seed)
    n = lambda *sh: torch.randn(*sh, generator=g, device=card)
    lo, hi = decays
    w = lo + (hi - lo) * torch.rand(bh, t, 1 if per_head else dk,
                                    generator=g, device=card)
    w = w.expand(bh, t, dk).contiguous()
    return n(bh, t, dk), n(bh, t, dk), n(bh, t, dv), w, n(bh, dk), n(
        bh, dk, dv)


def serve_requests(cfg, model, prompts, card):
    """Phase ``lm``'s traffic through ``ContinuousBatcher(slots=8,
    max_len=2048)`` on the card: every prompt a request of 16 greedy
    tokens, ``run_until_drained()`` tick by tick with each step and tick
    timed.  Gates completion, occupancy, the vocabulary and one prefill a
    request; returns the requests and the serving numbers."""
    import torch
    from repro_torch.serve import ContinuousBatcher, Request
    eng = ContinuousBatcher(cfg, model, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                            device=card)
    step_s = {"prefill": [], "decode": []}

    def timed(name, fn):
        def run(*a):
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            step_s[name].append(time.perf_counter() - t)
            return out
        return run

    eng.prefill = timed("prefill", eng.prefill)
    eng.decode = timed("decode", eng.decode)
    reqs = [Request(rid=i, prompt=p, max_new=LM_MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tick_s = []
    t0 = time.perf_counter()
    while eng.queue or any(eng.live):
        t = time.perf_counter()
        eng.tick()
        tick_s.append(time.perf_counter() - t)
    wall_s = time.perf_counter() - t0
    st = eng.stats
    check(st.completed == len(reqs) and all(
        r.done and len(r.out) == LM_MAX_NEW for r in reqs),
        f"all {len(reqs)} requests complete with {LM_MAX_NEW} tokens")
    check(max(st.slot_occupancy) <= LM_SLOTS, "occupancy never exceeds 8")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          "tokens in the vocabulary")
    n_pre, n_dec = len(step_s["prefill"]), len(step_s["decode"])
    check(n_pre == st.admitted == len(reqs) and n_dec == st.decode_tokens,
          "one prefill per request, one decode step per decoded token")
    pre_tok = sum(len(p) for p in prompts)
    return reqs, dict(
        slots=LM_SLOTS, max_len=LM_MAX_LEN, requests=len(reqs),
        max_new=LM_MAX_NEW, prompt_tokens=pre_tok,
        prompt_len_min=min(map(len, prompts)),
        prompt_len_max=max(map(len, prompts)), ticks=st.ticks,
        prefills=n_pre, decode_steps=n_dec, wall_s=wall_s,
        prefill_s=sum(step_s["prefill"]), decode_s=sum(step_s["decode"]),
        prefill_tokens_per_s=pre_tok / sum(step_s["prefill"]),
        decode_tokens_per_s=n_dec / sum(step_s["decode"]),
        prefill_ms_p50=float(np.percentile(step_s["prefill"], 50)) * 1e3,
        decode_step_ms_p50=float(np.percentile(step_s["decode"], 50)) * 1e3,
        tick_ms_p50=float(np.percentile(tick_s, 50)) * 1e3,
        tick_ms_p99=float(np.percentile(tick_s, 99)) * 1e3,
        tick_ms_max=max(tick_s) * 1e3,
        peak_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        max_occupancy=max(st.slot_occupancy))


def check_isolated(cfg, model, reqs, card) -> None:
    """Slot isolation: each request alone, batch 1, gives the batcher's
    tokens (``==``)."""
    import torch
    from repro_torch.models import model_zoo
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    zoo = model_zoo.get_model(cfg)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    for r in reqs:
        cache = zoo.init_cache(cfg, 1, LM_MAX_LEN, card)
        toks = torch.tensor([r.prompt], dtype=torch.int32, device=card)
        lg, cache = prefill(model, {"tokens": toks}, cache)
        out = [int(torch.argmax(lg[0, -1]))]
        while len(out) < LM_MAX_NEW:
            nxt, cache = decode(model, torch.tensor(
                [[out[-1]]], dtype=torch.int32, device=card), cache)
            out.append(int(nxt[0, 0]))
        check(out == r.out, f"request {r.rid}: batcher tokens == isolated")


def traces(cfg, model, prompts, rng, card, prefill: bool = True) -> dict:
    """One traced decode tick of 8 live slots and (if ``prefill``) one
    traced prefill of 1,024 tokens."""
    import torch
    from repro_torch.models import model_zoo
    from repro_torch.serve import ContinuousBatcher, Request
    from repro_torch.serve.serve_step import make_prefill_step
    eng = ContinuousBatcher(cfg, model, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                            device=card)
    for i in range(LM_SLOTS):
        eng.submit(Request(rid=i, prompt=prompts[i][:64], max_new=64))
    eng.tick()                                    # admits all 8
    out = {"decode_tick": dict(live_slots=LM_SLOTS,
                               **profile_run(eng.tick))}  # warm, traced
    if prefill:
        ptoks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 1024))
                                 .astype(np.int32)).to(card)
        zoo, step = model_zoo.get_model(cfg), make_prefill_step(cfg)
        out["prefill_1024"] = profile_run(lambda: step(
            model, {"tokens": ptoks},
            zoo.init_cache(cfg, 1, LM_MAX_LEN, card)))
    return out


def retree(model, leaf) -> dict:
    """An LM module's parameter tree, nested by name, with ``leaf(name,
    tensor)`` at each parameter."""
    tree: dict = {}
    for name, p in model.named_parameters():
        node = tree
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf(name, p.data)
    return tree


def cut_layers(model, n: int):
    """The config and model of an LM module's first ``n`` layers, full
    width, sharing its parameters: the stacks ``layers.*`` (after the
    dense lead layers of an MoE config, which stay), ``mamba_layers.*``,
    and Whisper's ``enc_layers.*`` and ``dec_layers.*``."""
    import dataclasses
    cfg = dataclasses.replace(model.cfg, n_layers=n,
                              enc_layers=min(model.cfg.enc_layers, n))
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    keep = {"layers": n - lead, "mamba_layers": n, "enc_layers": n,
            "dec_layers": n}
    return cfg, type(model)(cfg, retree(
        model, lambda name, t: t[:keep[name.split(".")[0]]]
        if name.split(".")[0] in keep else t))


class products_in:
    """Run the LM layers' products in ``dtype`` (the compute dtype,
    ``models.layers.COMPUTE_DTYPE``, bf16 by default) inside the block."""

    def __init__(self, dtype):
        self.dtype = dtype

    @staticmethod
    def _modules():
        from repro_torch.models import (
            layers, mamba2, mla, moe, transformer, whisper,
        )
        return (layers, mamba2, mla, moe, transformer, whisper)

    def __enter__(self):
        self.prev = self._modules()[0].COMPUTE_DTYPE
        for mod in self._modules():
            mod.COMPUTE_DTYPE = self.dtype
        return self

    def __exit__(self, *exc):
        for mod in self._modules():
            mod.COMPUTE_DTYPE = self.prev
        return False


def on_cpu(model):
    """A copy of an LM module's parameters on the CPU, same config."""
    return type(model)(model.cfg, retree(model, lambda name, t: t.cpu()))


def lm_dense_phase(card, smi: str) -> None:
    """Phase ``lm_dense``: the dense transformer family at full width behind
    the continuous batcher, the card against the CPU at two layers, and
    the blockwise attention against the naive one."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import pspec
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo, transformer
    from repro_torch.serve.serve_step import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = get_arch(LM_DENSE_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab) == (22, 2048, 32, 4, 64, 5632,
                                                  32000),
          f"{LM_DENSE_ARCH} at its published widths")
    zoo = model_zoo.get_model(cfg)
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9   # earlier phases' data
    t0 = time.perf_counter()
    gen = torch.Generator(device=card).manual_seed(0)
    model = zoo.build(cfg, pspec.init_params(zoo.param_defs(cfg), gen, card))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), "every declared parameter is made")
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    prefill = make_prefill_step(cfg)
    with torch.no_grad():          # cuBLAS handles, the bf16 weight copies
        warm = torch.from_numpy(np.asarray([prompts[-1][:256]], np.int32))
        prefill(model, {"tokens": warm.to(card)},
                zoo.init_cache(cfg, 1, LM_MAX_LEN, card))
    torch.cuda.synchronize()

    # -- the batcher: 16 requests, 8 slots ----------------------------------
    reqs, served = serve_requests(cfg, model, prompts, card)
    check_isolated(cfg, model, reqs, card)

    # -- teacher-forced prefill + decode against the full forward -----------
    # tests/test_models.py's case at full width: prefill 40 of 48 tokens
    # into a cache of 48 + 4 positions (the naive path throughout, as in
    # the test), then decode the rest one token at a time, against the
    # full forward over all 48.  Gated on the 2-layer cut (ROADMAP C: at
    # full depth one ulp per layer can move random-weight logits past any
    # bound); printed at 22 layers, and with the batcher's 2,048-position
    # cache, where the prefill takes the blockwise path.
    ratio = lambda a, b: float((a.float() - b.float()).abs().max()
                               / b.float().abs().max())
    T, k = LM_FORCED
    forced = torch.tensor([prompts[0][:T]], dtype=torch.int32, device=card)

    def forced_ratios(m, c, max_len):
        with torch.no_grad():
            full, _, _ = m({"tokens": forced}, mode="prefill")
            cache = zoo.init_cache(c, 1, max_len, card)
            lg, cache, _ = m({"tokens": forced[:, :k]}, mode="prefill",
                             cache=cache)
            outs = [lg[:, -1]]
            for t in range(k, T - 1):
                lg, cache, _ = m({"tokens": forced[:, t:t + 1]},
                                 mode="decode", cache=cache)
                outs.append(lg[:, -1])
        return [ratio(o, full[:, k - 1 + i]) for i, o in enumerate(outs)]

    cut_cfg, cut = cut_layers(model, LOGIT_DEPTH)
    forced_cut = forced_ratios(cut, cut_cfg, T + 4)
    check(max(forced_cut) <= LOGIT_TOL,
          f"cached prefill + decode at {LOGIT_DEPTH} layers within "
          f"{LOGIT_TOL} x max |logit| of the full forward, got {forced_cut}")
    forced_out = {"gated_depth": LOGIT_DEPTH, "gated_max_ratio":
                  max(forced_cut),
                  "full_depth_max_ratio": max(forced_ratios(
                      model, cfg, T + 4)),
                  "blockwise_prefill_max_ratio": max(forced_ratios(
                      cut, cut_cfg, LM_MAX_LEN)),
                  "full_depth_blockwise_prefill_max_ratio": max(
                      forced_ratios(model, cfg, LM_MAX_LEN))}
    del cut

    # -- the card against the CPU, each family cut to 2 layers --------------
    cuts = {}
    for arch in LM_DENSE_CUTS:
        t0 = time.perf_counter()
        if arch == LM_DENSE_ARCH:
            ccfg, cmodel = cut_layers(model, LOGIT_DEPTH)
        else:
            ccfg = dataclasses.replace(get_arch(arch), n_layers=LOGIT_DEPTH)
            czoo = model_zoo.get_model(ccfg)
            g = torch.Generator(device=card).manual_seed(0)
            cmodel = czoo.build(ccfg, pspec.init_params(
                czoo.param_defs(ccfg), g, card))
        full_w = get_arch(arch)
        check((ccfg.d_model, ccfg.n_heads, ccfg.n_kv_heads, ccfg.head_dim,
               ccfg.d_ff, ccfg.vocab) == (full_w.d_model, full_w.n_heads,
                                          full_w.n_kv_heads,
                                          full_w.head_dim, full_w.d_ff,
                                          full_w.vocab),
              f"{arch} cut to {LOGIT_DEPTH} layers at full width")
        cpu_model = on_cpu(cmodel)
        crng = np.random.default_rng(LM_SEED)
        batch = {"tokens": torch.from_numpy(crng.integers(
            0, ccfg.vocab, (1, LM_CPU_PROMPT)).astype(np.int32))}
        if ccfg.n_image_tokens:
            batch["img_embeds"] = torch.from_numpy(crng.normal(size=(
                1, ccfg.n_image_tokens, ccfg.d_model)).astype(np.float32))

        def prefill_logits(m, dev, dtype):
            with products_in(dtype), torch.no_grad():
                lg, _, _ = m({n: t.to(dev) for n, t in batch.items()},
                             mode="prefill", cache=transformer.init_cache(
                                 ccfg, 1, LM_MAX_LEN, dev))
            return lg.cpu().float()

        got = prefill_logits(cmodel, card, torch.float32)
        want = prefill_logits(cpu_model, "cpu", torch.float32)
        check(bool(torch.isfinite(got).all()) and got.shape == (
            1, LM_CPU_PROMPT + ccfg.n_image_tokens, ccfg.vocab),
            f"{arch}: finite logits of the right shape")
        r = ratio(got, want)
        check(r <= LOGIT_TOL, f"{arch} at {LOGIT_DEPTH} layers, f32 products: "
              f"card logits within {LOGIT_TOL} x max |logit| of the CPU's, "
              f"got {r}")
        got16 = prefill_logits(cmodel, card, torch.bfloat16)
        want16 = prefill_logits(cpu_model, "cpu", torch.bfloat16)
        agree = lambda a, b: float((a.argmax(-1) == b.argmax(-1)).float()
                                   .mean())
        cuts[arch] = {"ratio_f32": r, "argmax_agreement_f32": agree(got,
                                                                    want),
                      "ratio_bf16": ratio(got16, want16),
                      "argmax_agreement_bf16": agree(got16, want16),
                      # what bf16 rounding alone moves: the CPU's bf16
                      # logits against its own f32-product logits
                      "bf16_rounding_floor": ratio(want16, want),
                      "positions": got.shape[1],
                      "n_kv_heads": ccfg.n_kv_heads,
                      "d_head": ccfg.head_dim, "act": ccfg.act,
                      "tied": ccfg.tie_embeddings,
                      "image_tokens": ccfg.n_image_tokens,
                      "s": time.perf_counter() - t0}
        del cmodel, cpu_model

    # -- blockwise against naive at the prefill shape -----------------------
    Tq, Tk, Hq, Hkv, Dh = ATTN_PREFILL
    g = torch.Generator(device=card).manual_seed(3)
    qkv = [torch.randn(1, t, h, Dh, generator=g, device=card)
           for t, h in ((Tq, Hq), (Tk, Hkv), (Tk, Hkv))]
    mask = dict(causal=True, q_offset=0, kv_len=Tq, prefix_len=0, window=0)
    prev_min = L._BLOCKWISE_MIN

    def naive(q, kk, v):
        L.set_blockwise_min(1 << 62)
        try:
            return L.attend(q, kk, v, **mask)
        finally:
            L.set_blockwise_min(prev_min)

    def blockwise(q, kk, v):
        return L._attend_blockwise(q, kk, v, scale=Dh ** -0.5, **mask)

    attn = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            q, kk, v = (t.to(dt) for t in qkv)
            a, b = blockwise(q, kk, v).float(), naive(q, kk, v).float()
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            tol = (ATTN_F32_ATOL if dt == torch.float32
                   else ATTN_BF16_ULPS * 2.0 ** -8 * scale)
            check(err <= tol, f"blockwise == naive attention ({dt}): "
                  f"{err} > {tol}")
            attn[str(dt).removeprefix("torch.")] = {
                "max_abs_err": err, "tolerance": tol, "out_scale": scale,
                "blockwise_ms": cuda_ms(lambda: blockwise(q, kk, v)),
                "naive_ms": cuda_ms(lambda: naive(q, kk, v))}

    # -- traces: one decode tick of 8 live slots, one prefill of 1,024 ------
    traced = traces(cfg, model, prompts, rng, card)
    kv = zoo.init_cache(cfg, 1, LM_MAX_LEN, card)["layers"]
    emit("lm_dense", card=smi, arch=LM_DENSE_ARCH, n_params=n_params,
         init_s=init_s, **served,
         kv_cache_bytes_per_slot=2 * kv["k"].numel() * kv["k"].element_size(),
         held_before_phase_gb=held_gb,
         peak_above_held_gb=served["peak_memory_allocated_gb"] - held_gb,
         tokens_equal_isolated_decode=True,
         forced=dict(tokens=T, prefilled=k, **forced_out),
         logits_depth=LOGIT_DEPTH, card_vs_cpu=cuts,
         attention=dict(shape=f"Tq={Tq},Tk={Tk},Hq={Hq},Hkv={Hkv},d={Dh},"
                              f"causal,kv_len={Tq}", **attn),
         **traced,
         phase_s=time.perf_counter() - t_phase)


def lm_hybrid_phase(card, smi: str, out_dir: pathlib.Path) -> dict:
    """Phase ``lm_hybrid``: ``zamba2-2.7b`` at full width, cut to
    ``LM_HYBRID_LAYERS`` of its 54 Mamba2 layers (whole groups), behind
    the continuous batcher, every Mamba2 layer on the ``chunk_scan`` kernel
    in the GLA form; each layer's call held against the plain chunked
    version; the card against the CPU at one group; a 9,000-token context
    through the sliding-window slice.  Returns the GLA form's part of the
    ``chunk_scan`` row."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import pspec
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2, model_zoo
    from repro_torch.serve import ContinuousBatcher, Request
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    full = get_arch(LM_HYBRID_ARCH)
    s = full.ssm
    _, H, _ = mamba2._dims(full)
    check((full.n_layers, full.d_model, H, s.head_dim, s.state_dim,
           s.conv_dim, s.chunk, full.shared_attn_every, full.n_heads,
           full.head_dim, full.d_ff, full.vocab, full.sliding_window)
          == (54, 2560, 80, 64, 64, 4, 128, 6, 32, 80, 10240, 32000, 4096),
          f"{LM_HYBRID_ARCH} at its published widths (the shared block's "
          f"32 heads are 2560 / 32 = 80 wide)")
    check(full.param_count() == 2_396_455_840, f"{full.param_count()}")
    cfg = dataclasses.replace(full, n_layers=LM_HYBRID_LAYERS)
    zoo = model_zoo.get_model(cfg)
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9   # earlier phases' data
    t0 = time.perf_counter()
    gen = torch.Generator(device=card).manual_seed(0)
    model = zoo.build(cfg, pspec.init_params(zoo.param_defs(cfg), gen, card))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(),
          f"every declared parameter is made: {n_params}")
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    with torch.no_grad():          # cuBLAS handles, the bf16 weight copies
        warm = torch.from_numpy(np.asarray([prompts[-1][:256]], np.int32))
        prefill(model, {"tokens": warm.to(card)},
                zoo.init_cache(cfg, 1, LM_MAX_LEN, card))
    torch.cuda.synchronize()

    # -- the batcher: 16 requests, 8 slots; the kernel's launches ----------
    cs.launches = cs.kernel_launches = 0
    reqs, served = serve_requests(cfg, model, prompts, card)
    launches, kernel_launches = cs.launches, cs.kernel_launches
    n_pre, n_dec = served["prefills"], served["decode_steps"]
    check(launches == cfg.n_layers * (n_pre + n_dec),
          f"chunk_scan launched {launches} times, want {cfg.n_layers} x "
          f"({n_pre} + {n_dec})")
    want_k = cfg.n_layers * (SCAN_KERNELS["chunked"] * n_pre
                             + SCAN_KERNELS["step"] * n_dec)
    check(kernel_launches == want_k,
          f"chunk_scan device kernels {kernel_launches}, want {want_k}")
    check_isolated(cfg, model, reqs, card)

    # -- every layer's own chunk_scan call, kernel against plain -----------
    # the served route (the kernel) with the plain chunked version
    # (ref.chunk_scan_chunked_ref, through ops.chunk_scan's padding) run
    # beside it on the very same inputs, at one prefill and one decode step
    real_scan = ops.chunk_scan
    calls = []

    def beside(*a, **kw):
        got = real_scan(*a, **kw)
        want = real_scan(*a, **dict(kw, impl="ref"))
        w = a[3]
        calls.append({
            "T": a[0].shape[1],
            "o_max_abs_err": float((got[0] - want[0]).abs().max()),
            "o_scale": max(float(want[0].abs().max()), 1.0),
            "state_max_abs_err": float((got[1] - want[1]).abs().max()),
            "finite": bool(torch.isfinite(got[0]).all()
                           and torch.isfinite(got[1]).all()),
            "decay_min": float(w.min()), "decay_max": float(w.max())})
        return got

    ops.chunk_scan = beside
    try:
        with torch.no_grad():
            toks0 = torch.tensor([prompts[0]], dtype=torch.int32,
                                 device=card)
            lg, cache = prefill(model, {"tokens": toks0},
                                zoo.init_cache(cfg, 1, LM_MAX_LEN, card))
            decode(model, torch.argmax(lg[:, -1], -1, keepdim=True).to(
                torch.int32), cache)
    finally:
        ops.chunk_scan = real_scan
    torch.cuda.synchronize()
    check(len(calls) == 2 * cfg.n_layers, "one call a layer a step")
    worst = max(max(c["o_max_abs_err"] / (SCAN_O_TOL * c["o_scale"]),
                    c["state_max_abs_err"] / SCAN_S_TOL) for c in calls)
    check(all(c["finite"] for c in calls), "the kernel's o and state finite")
    check(worst <= 1.0, f"kernel within tolerance of the plain chunked "
          f"version at every layer: worst error / tolerance {worst}")
    per_layer = {"prefill_T": calls[0]["T"], "decode_T": calls[-1]["T"],
                 "worst_error_over_tolerance": worst,
                 "worst_o_max_abs_err": max(c["o_max_abs_err"]
                                            for c in calls),
                 "worst_state_max_abs_err": max(c["state_max_abs_err"]
                                                for c in calls),
                 "decay_min": min(c["decay_min"] for c in calls),
                 "decay_max": max(c["decay_max"] for c in calls),
                 "layers": [[round(c["o_max_abs_err"] / c["o_scale"], 9),
                             round(c["state_max_abs_err"], 9)]
                            for c in calls]}

    # -- the card against the CPU at one group (6 layers + the block) ------
    ratio = lambda a, b: float((a.float() - b.float()).abs().max()
                               / b.float().abs().max())
    ccfg, cut = cut_layers(model, cfg.shared_attn_every)
    cpu_cut = on_cpu(cut)
    ctoks = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (1, LM_CPU_PROMPT)).astype(np.int32))

    def group_logits(m, dev, impl=None, nudge=False):
        def nudged(*a, **kw):
            o, st = real_scan(*a, **kw)
            return o * (1.0 + 2.0 ** -23), st
        ops.chunk_scan = nudged if nudge else real_scan
        try:
            with products_in(torch.float32), torch.no_grad():
                lg, _, _ = m({"tokens": ctoks.to(dev)}, mode="prefill",
                             impl=impl, cache=mamba2.init_cache(
                                 ccfg, 1, LM_MAX_LEN, dev))
        finally:
            ops.chunk_scan = real_scan
        return lg.cpu().float()

    card_lg = group_logits(cut, card)
    cpu_lg = group_logits(cpu_cut, "cpu")
    check(bool(torch.isfinite(card_lg).all()) and card_lg.shape == (
        1, LM_CPU_PROMPT, cfg.vocab), "finite logits of the right shape")
    card_vs_cpu = ratio(card_lg, cpu_lg)
    check(card_vs_cpu <= LOGIT_TOL,
          f"one group, f32 products: card logits within {LOGIT_TOL} x max "
          f"|logit| of the CPU's, got {card_vs_cpu}")
    plain_lg = group_logits(cut, card, impl="ref")
    one_group = {
        "layers": ccfg.n_layers, "tokens": LM_CPU_PROMPT,
        "card_vs_cpu_f32": card_vs_cpu,
        "card_kernel_vs_card_plain_f32": ratio(card_lg, plain_lg),
        "floor_plain_vs_nudged_f32": ratio(group_logits(
            cut, card, impl="ref", nudge=True), plain_lg),
        "argmax_agreement": float((card_lg.argmax(-1) == cpu_lg.argmax(-1))
                                  .float().mean())}
    del cpu_cut

    # -- teacher-forced prefill + decode against the full forward ----------
    T, k = LM_FORCED
    forced = torch.tensor([prompts[0][:T]], dtype=torch.int32, device=card)

    def forced_ratios(m, c):
        with torch.no_grad():
            full, _, _ = m({"tokens": forced}, mode="prefill")
            cache = mamba2.init_cache(c, 1, T + 4, card)
            lg, cache, _ = m({"tokens": forced[:, :k]}, mode="prefill",
                             cache=cache)
            outs = [lg[:, -1]]
            for t in range(k, T - 1):
                lg, cache, _ = m({"tokens": forced[:, t:t + 1]},
                                 mode="decode", cache=cache)
                outs.append(lg[:, -1])
        return max(ratio(o, full[:, k - 1 + i]) for i, o in enumerate(outs))

    forced_out = {"tokens": T, "prefilled": k,
                  "one_group_max_ratio": forced_ratios(cut, ccfg),
                  "full_depth_max_ratio": forced_ratios(model, cfg)}
    del cut

    # -- the long context: 9,000 tokens into 16,384 positions --------------
    W = cfg.sliding_window
    check(LONG_MAX_LEN > 2 * W and LONG_PROMPT > W,
          "the long context takes the window slice at decode")
    long_prompt = np.random.default_rng(LM_SEED + 1).integers(
        0, cfg.vocab, LONG_PROMPT).tolist()
    long_calls = []

    def long_beside(*a, **kw):
        got = real_scan(*a, **kw)
        if a[0].shape[1] > 1:
            layer = len(long_calls)
            row = {"layer": layer, "T": a[0].shape[1]}
            if layer in (0, cfg.n_layers - 1):
                want = real_scan(*a, **dict(kw, impl="ref"))
                row.update(
                    o_max_abs_err=float((got[0] - want[0]).abs().max()),
                    o_scale=max(float(want[0].abs().max()), 1.0),
                    state_max_abs_err=float((got[1] - want[1]).abs().max()),
                    finite=bool(torch.isfinite(got[0]).all()),
                    decay_min=float(a[3].min()))
            long_calls.append(row)
        return got

    leng = ContinuousBatcher(cfg, model, slots=1, max_len=LONG_MAX_LEN,
                             device=card)
    lreq = Request(rid=0, prompt=long_prompt, max_new=LM_MAX_NEW)
    leng.submit(lreq)
    ops.chunk_scan = long_beside
    try:
        t0 = time.perf_counter()
        leng.tick()                                # prefill + one decode
        torch.cuda.synchronize()
        long_first_tick_s = time.perf_counter() - t0
    finally:
        ops.chunk_scan = real_scan
    t0 = time.perf_counter()
    leng.run_until_drained()
    torch.cuda.synchronize()
    long_rest_s = time.perf_counter() - t0
    check(lreq.done and len(lreq.out) == LM_MAX_NEW
          and leng.stats.completed == 1, "the long request completes")
    checked = [c for c in long_calls if "o_max_abs_err" in c]
    check(len(long_calls) == cfg.n_layers and len(checked) == 2,
          "the long prefill: one call a layer, the first and last checked")
    for c in checked:
        check(c["finite"] and c["o_max_abs_err"] <= SCAN_O_TOL * c["o_scale"]
              and c["state_max_abs_err"] <= SCAN_S_TOL,
              f"kernel within tolerance at T = {c['T']}, layer "
              f"{c['layer']}: {c}")
    lcache = leng.caches[0]
    kv = lcache["attn"]
    S, cur = kv["k"].shape[2], kv["len"] - 1
    check(S == LONG_MAX_LEN and kv["len"] == LONG_PROMPT + LM_MAX_NEW - 1,
          "the long cache's length")
    # attend on the sliced window against the masked whole cache at the
    # attention shape and the long request's length, on unit-normal f32
    # q, k, v as tests/test_perf_layouts.py draws them (gated at its
    # atol), and on the request's own cache (printed: its keys are ~10x
    # larger at random init, and the two reductions' f32 orders differ)
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(1, 1, cfg.n_heads, cfg.head_dim, generator=g,
                    device=card)
    start = min(max(cur + 1 - W, 0), S - W)

    def slice_vs_masked(ck, cv):
        full_att = L.attend(q, ck, cv, causal=True, q_offset=cur,
                            kv_len=cur + 1, window=W)
        slice_att = L.attend(q, ck[:, start:start + W],
                             cv[:, start:start + W], causal=True,
                             q_offset=cur - start, kv_len=cur + 1 - start,
                             window=W)
        return float((full_att - slice_att).abs().max())

    ck, cv = (torch.randn(kv["k"].shape[1:], generator=g, device=card)
              for _ in range(2))
    slice_err = slice_vs_masked(ck, cv)
    check(slice_err <= WINDOW_ATOL, f"window slice == masked cache: "
          f"{slice_err}")
    slice_err_own = slice_vs_masked(kv["k"][0].float(), kv["v"][0].float())
    tok = torch.tensor([[lreq.out[-1]]], dtype=torch.int32, device=card)
    step = lambda: decode(model, tok, lcache)    # rewrites position len
    slice_on_s = host_s(step, 5)
    L.set_window_slice(False)
    try:
        slice_off_s = host_s(step, 5)
    finally:
        L.set_window_slice(True)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    long_out = {
        "prompt": LONG_PROMPT, "max_len": LONG_MAX_LEN, "window": W,
        "padded_T": -(-LONG_PROMPT // s.chunk) * s.chunk,
        "chunks": -(-LONG_PROMPT // s.chunk),
        "first_tick_s": long_first_tick_s, "rest_s": long_rest_s,
        "kernel_vs_plain": checked, "window_slice_max_abs_err": slice_err,
        "window_slice_max_abs_err_own_cache": slice_err_own,
        "decode_step_ms_slice_on": slice_on_s * 1e3,
        "decode_step_ms_slice_off": slice_off_s * 1e3,
        "mamba_state_bytes_per_slot": nbytes(lcache["mamba"].values()),
        "mamba_S_bytes_per_slot": nbytes([lcache["mamba"]["S"]]),
        "attention_cache_bytes": nbytes((kv["k"], kv["v"])),
        "attention_cache_bytes_at_2048": nbytes((kv["k"], kv["v"]))
        * LM_MAX_LEN // LONG_MAX_LEN}
    del leng, lcache, kv, ck, cv

    # -- traces and the kernel's times at the served shapes ----------------
    traced = traces(cfg, model, prompts, rng, card)
    rows = {}
    for label, (t, n) in (("prefill", (1024, 10)), ("decode", (1, 200)),
                          ("long", (-(-LONG_PROMPT // 128) * 128, 2))):
        q, kk, v, w, _, s0 = scan_inputs(card, 80, t, 64, 64, 20 + t,
                                         decays=(0.02, 0.9), per_head=True)
        u = torch.zeros(80, 64, device=card)
        kern = lambda: cs.chunk_scan_kernel(q, kk, v, w, u, s0, chunk=128,
                                            use_bonus=False)
        plain = lambda: ref.chunk_scan_chunked_ref(q, kk, v, w, None, s0,
                                                   chunk=min(128, t))
        before = cs.kernel_launches
        got = kern()
        counted = cs.kernel_launches - before
        want = plain()
        scale = max(float(want[0].abs().max()), 1.0)
        check(float((got[0] - want[0]).abs().max()) <= SCAN_O_TOL * scale
              and float((got[1] - want[1]).abs().max()) <= SCAN_S_TOL,
              f"GLA kernel vs plain at B*H=80, T={t}")
        nodes = graph_kernel_nodes(kern)
        want_n = SCAN_KERNELS["step" if t == 1 else "chunked"]
        check(counted == nodes == want_n,
              f"chunk_scan kernels a call at {label}: library count "
              f"{counted}, graph kernel nodes {nodes}, want {want_n}")
        reps = 50 if t == 1 else 10
        rows[label] = {**chunk_scan_bound(80, t, 64, 64, 128, False),
                       "kernels_per_call": counted,
                       "graph_kernel_nodes_per_call": nodes,
                       "ms": cuda_ms(kern, reps=reps, warmup=3),
                       "device_ms": graph_ms(kern, n),
                       "plain_ms": cuda_ms(plain, reps=reps, warmup=2)}
    resources = {"ptxas": {k: v for k, v in chunk_scan_resources(
        out_dir).items() if "<gla>" in k or k.startswith("step_kernel")},
                 **cs.resources(128, 64, 64, False)}
    emit("lm_hybrid", card=smi, arch=LM_HYBRID_ARCH, n_params=n_params,
         init_s=init_s, **served, held_before_phase_gb=held_gb,
         peak_above_held_gb=served["peak_memory_allocated_gb"] - held_gb,
         chunk_scan_launches=launches,
         chunk_scan_kernel_launches=kernel_launches,
         tokens_equal_isolated_decode=True,
         kernel_vs_plain_per_layer=per_layer,
         tolerance=f"o {SCAN_O_TOL} x max(|o|,1), state {SCAN_S_TOL}",
         one_group_card_vs_cpu=one_group, forced=forced_out,
         long_context=long_out, chunk_scan_gla=rows, resources=resources,
         **traced, phase_s=time.perf_counter() - t_phase)
    p, d, big = rows["prefill"], rows["decode"], rows["long"]
    return {"launches": launches, "kernel_launches": kernel_launches,
            "launches_path": f"lm_hybrid: {cfg.n_layers} per prefill "
                             "and per decode step",
            "max_abs_err": max(per_layer["worst_o_max_abs_err"],
                               per_layer["worst_state_max_abs_err"]),
            "worst_error_over_tolerance": worst,
            "shape": p["shape"], "ms": p["ms"], "device_ms": p["device_ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"], "bound_f32_ms": p["bound_f32_ms"],
            "decode_ms": d["ms"], "decode_device_ms": d["device_ms"],
            "decode_plain_ms": d["plain_ms"],
            "decode_bound_ms": d["bound_ms"],
            "long_shape": big["shape"], "long_device_ms": big["device_ms"],
            "long_plain_ms": big["plain_ms"],
            "long_bound_ms": big["bound_ms"], "resources": resources}


def lm_moe_phase(card, smi: str) -> None:
    """Phase ``lm_moe``: ``qwen2-moe-a2.7b`` at full width, cut to
    ``LM_MOE_LAYERS`` of its 24 layers, behind the continuous batcher (no hand-written kernel: JAX runs MoE on XLA
    products and scatters), the card against the CPU at two layers."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import pspec
    from repro_torch.models import model_zoo, moe, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    full = get_arch(LM_MOE_ARCH)
    m = full.moe
    check((full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
           full.head_dim, full.vocab, m.n_experts, moe.padded_experts(m),
           m.top_k, m.d_ff_expert, m.n_shared, m.d_ff_shared)
          == (24, 2048, 16, 16, 128, 151936, 60, 64, 4, 1408, 4, 5632),
          f"{LM_MOE_ARCH} at its published widths")
    check(full.param_count() == 15_146_256_384, f"{full.param_count()}")
    cfg = dataclasses.replace(full, n_layers=LM_MOE_LAYERS)
    zoo = model_zoo.get_model(cfg)
    torch.cuda.empty_cache()          # earlier phases' cached blocks
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    gen = torch.Generator(device=card).manual_seed(0)
    model = zoo.build(cfg, pspec.init_params(zoo.param_defs(cfg), gen, card))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(),
          f"every declared parameter is made: {n_params}")
    params_gb = torch.cuda.memory_allocated() / 1e9 - held_gb
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]

    # the two dispatch paths, counted where moe_ffn takes them
    paths = {"scatter": 0, "einsum": 0}
    real_ffn, real_einsum = moe.moe_ffn, moe._moe_decode_einsum

    def einsum_path(*a, **kw):
        paths["einsum"] += 1
        return real_einsum(*a, **kw)

    def counted_ffn(*a, **kw):
        before = paths["einsum"]
        out = real_ffn(*a, **kw)
        paths["scatter"] += paths["einsum"] == before
        return out

    moe.moe_ffn, moe._moe_decode_einsum = counted_ffn, einsum_path
    try:
        with torch.no_grad():      # cuBLAS handles, the bf16 weight copies
            warm = torch.from_numpy(np.asarray([prompts[-1][:256]],
                                               np.int32)).to(card)
            model({"tokens": warm}, mode="prefill", cache=zoo.init_cache(
                cfg, 1, LM_MAX_LEN, card))
        torch.cuda.synchronize()
        paths.update(scatter=0, einsum=0)
        reqs, served = serve_requests(cfg, model, prompts, card)
        served_paths = dict(paths)
    finally:
        moe.moe_ffn, moe._moe_decode_einsum = real_ffn, real_einsum
    long_prompts = int((lens > moe._DECODE_EINSUM_MAX_TOKENS).sum())
    check(served_paths["scatter"] == cfg.n_layers * long_prompts
          and served_paths["einsum"] == cfg.n_layers * (
              served["prefills"] - long_prompts + served["decode_steps"])
          and min(served_paths.values()) > 0,
          f"the scatter path (prompts over "
          f"{moe._DECODE_EINSUM_MAX_TOKENS} tokens) and the einsum path "
          f"(the rest, and every decode step) each ran: {served_paths}")
    check_isolated(cfg, model, reqs, card)

    # -- the card against the CPU at two layers, f32 products --------------
    ratio = lambda a, b: float((a.float() - b.float()).abs().max()
                               / b.float().abs().max())
    ccfg, cut = cut_layers(model, LOGIT_DEPTH)
    cpu_cut = on_cpu(cut)
    ctoks = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (1, LM_CPU_PROMPT)).astype(np.int32))
    real_route = moe._route

    def prefill_logits(mdl, dev, dtype):
        choices = []

        def route(*a, **kw):
            out = real_route(*a, **kw)
            choices.append(out[2].cpu())
            return out

        moe._route = route
        try:
            with products_in(dtype), torch.no_grad():
                lg, _, _ = mdl({"tokens": ctoks.to(dev)}, mode="prefill",
                               cache=transformer.init_cache(
                                   ccfg, 1, LM_MAX_LEN, dev))
        finally:
            moe._route = real_route
        return lg.cpu().float(), torch.stack(choices)

    got, got_r = prefill_logits(cut, card, torch.float32)
    want, want_r = prefill_logits(cpu_cut, "cpu", torch.float32)
    check(bool(torch.isfinite(got).all()) and got.shape == (
        1, LM_CPU_PROMPT, cfg.vocab), "finite logits of the right shape")
    r32 = ratio(got, want)
    check(r32 <= LOGIT_TOL, f"{LOGIT_DEPTH} layers, f32 products: card "
          f"logits within {LOGIT_TOL} x max |logit| of the CPU's, got {r32}")
    got16, got16_r = prefill_logits(cut, card, torch.bfloat16)
    want16, want16_r = prefill_logits(cpu_cut, "cpu", torch.bfloat16)
    card_vs_cpu = {
        "layers": LOGIT_DEPTH, "tokens": LM_CPU_PROMPT,
        "ratio_f32": r32,
        "routing_choices_differ_f32": float((got_r != want_r).float()
                                            .mean()),
        "ratio_bf16": ratio(got16, want16),
        "routing_choices_differ_bf16": float((got16_r != want16_r).float()
                                             .mean()),
        "bf16_rounding_floor": ratio(want16, want)}
    del cut, cpu_cut

    traced = traces(cfg, model, prompts, rng, card, prefill=False)
    kv = zoo.init_cache(cfg, 1, LM_MAX_LEN, card)["layers"]
    cache_bytes = 2 * kv["k"].numel() * kv["k"].element_size()
    emit("lm_moe", card=smi, arch=LM_MOE_ARCH, n_params=n_params,
         active_params=cfg.active_param_count(), init_s=init_s,
         params_gb=params_gb, **served, held_before_phase_gb=held_gb,
         peak_above_held_gb=served["peak_memory_allocated_gb"] - held_gb,
         kv_cache_bytes_per_slot=cache_bytes,
         dispatch_paths=served_paths, prompts_over_einsum_max=long_prompts,
         tokens_equal_isolated_decode=True, card_vs_cpu=card_vs_cpu,
         decode_tick=traced["decode_tick"],
         phase_s=time.perf_counter() - t_phase)


def lm_mla_phase(card, smi: str) -> None:
    """Phase ``lm_mla``: ``deepseek-v2-236b`` at its published widths, cut
    in layers to the dense lead layer and the first MoE layers, behind
    the continuous batcher (MLA's cached direct form at prefill, its
    absorbed form at decode; no hand-written kernel: JAX runs MLA on XLA
    products); one full-width MLA layer's forms against each other and
    the card against the CPU."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import pspec
    from repro_torch.models import mla, model_zoo, moe, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    full = get_arch(LM_MLA_ARCH)
    m, e = full.mla, full.moe
    check((full.d_model, full.n_heads, m.q_lora_rank, m.kv_lora_rank,
           m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, full.vocab,
           e.n_experts, moe.padded_experts(e), e.top_k, e.d_ff_expert,
           e.n_shared, e.d_ff_shared, e.first_dense_layers, e.d_ff_dense)
          == (5120, 128, 1536, 512, 128, 64, 128, 102400, 160, 160, 6, 1536,
              2, 3072, 1, 12288),
          f"{LM_MLA_ARCH} at its published widths")
    # gate (i), from the defs alone: nothing is allocated
    check(full.param_count() == 235_741_434_880,
          f"uncut {LM_MLA_ARCH}: 235,741,434,880 parameters, got "
          f"{full.param_count()}")
    cfg = dataclasses.replace(full, n_layers=LM_MLA_LAYERS)
    zoo = model_zoo.get_model(cfg)
    gc.collect()                      # the MoE phase's model, then
    torch.cuda.empty_cache()          # earlier phases' cached blocks
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    gen = torch.Generator(device=card).manual_seed(0)
    model = zoo.build(cfg, pspec.init_params(zoo.param_defs(cfg), gen, card))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count() == 13_302_912_000,
          f"{LM_MLA_LAYERS} layers: 13,302,912,000 parameters made, got "
          f"{n_params}")
    params_gb = torch.cuda.memory_allocated() / 1e9 - held_gb
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]

    # the two MLA forms the batcher takes, counted where they run
    forms = {"cached_direct": 0, "absorbed": 0}
    real_attn = mla.mla_attention

    def counted_attn(*a, **kw):
        if kw.get("cache") is not None:
            forms["absorbed" if kw.get("absorbed", True)
                  else "cached_direct"] += 1
        return real_attn(*a, **kw)

    mla.mla_attention = counted_attn
    try:
        with torch.no_grad():      # cuBLAS handles, the bf16 weight copies
            warm = torch.from_numpy(np.asarray([prompts[-1][:256]],
                                               np.int32)).to(card)
            model({"tokens": warm}, mode="prefill", cache=zoo.init_cache(
                cfg, 1, LM_MAX_LEN, card))
        torch.cuda.synchronize()
        forms.update(cached_direct=0, absorbed=0)
        reqs, served = serve_requests(cfg, model, prompts, card)
        served_forms = dict(forms)
    finally:
        mla.mla_attention = real_attn
    check(served_forms == {
        "cached_direct": cfg.n_layers * served["prefills"],
        "absorbed": cfg.n_layers * served["decode_steps"]},
        f"every layer of each prefill took the cached direct form and of "
        f"each decode step the absorbed form: {served_forms}")
    # gate (iv)
    check_isolated(cfg, model, reqs, card)

    ratio = lambda a, b: float((a.float() - b.float()).abs().max()
                               / b.float().abs().max())
    # -- gate (ii): one full-width MLA layer, absorbed == cached direct -----
    p = {n: t[0] for n, t in model.layers.attn.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(LM_SEED).normal(size=(
        1, LM_MLA_TOKENS, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        o_abs, _ = mla.mla_attention(p, x.to(card), cfg, absorbed=True,
                                     cache=mla.init_mla_cache(
                                         cfg, 1, 2 * LM_MLA_TOKENS,
                                         device=card))
        o_dir, _ = mla.mla_attention(p, x.to(card), cfg, absorbed=False,
                                     cache=mla.init_mla_cache(
                                         cfg, 1, 2 * LM_MLA_TOKENS,
                                         device=card))
    r_forms = float((o_abs - o_dir).abs().max() / o_dir.abs().max())
    check(r_forms <= MLA_FORMS_TOL, f"full-width MLA layer: absorbed within "
          f"{MLA_FORMS_TOL} x max |o| of the cached direct form, got "
          f"{r_forms}")

    # -- gate (iii): the card against the CPU at f32 products ---------------
    def layer_forms(pp, dev, dtype):
        """o of the three forms on 16 tokens: direct, no cache; and after
        a cached direct prefill of 12, the last 4 cached direct and
        absorbed (with the cache's latents)."""
        xx, k = x.to(dev), LM_MLA_TOKENS - 4
        out = {}
        with products_in(dtype), torch.no_grad():
            out["direct"], _ = mla.mla_attention(pp, xx, cfg)
            for form in ("cached_direct", "absorbed"):
                c = mla.init_mla_cache(cfg, 1, 2 * LM_MLA_TOKENS, device=dev)
                _, c = mla.mla_attention(pp, xx[:, :k], cfg, cache=c,
                                         absorbed=False)
                out[form], c = mla.mla_attention(
                    pp, xx[:, k:], cfg, cache=c,
                    absorbed=form == "absorbed")
                out[form + "_c_kv"] = c["c_kv"][:, :LM_MLA_TOKENS]
        return {n: t.cpu().float() for n, t in out.items()}

    p_cpu = {n: t.cpu() for n, t in p.items()}
    got, want = layer_forms(p, card, torch.float32), layer_forms(
        p_cpu, "cpu", torch.float32)
    layer_f32 = {n: ratio(got[n], want[n]) for n in got}
    check(max(layer_f32.values()) <= LOGIT_TOL,
          f"full-width MLA layer, f32 products: card within {LOGIT_TOL} x "
          f"max |o| of the CPU in each form: {layer_f32}")
    got16, want16 = layer_forms(p, card, torch.bfloat16), layer_forms(
        p_cpu, "cpu", torch.bfloat16)
    layer_bf16 = {n: ratio(got16[n], want16[n]) for n in got16}

    ccfg, cut = cut_layers(model, LOGIT_DEPTH)
    cpu_cut = on_cpu(cut)
    ctoks = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (1, LM_MLA_TOKENS)).astype(np.int32))

    def cut_logits(mdl, dev, dtype):
        """Prefill of 12 (cached direct) then the last 4 decoded one at a
        time (absorbed), and the train forward, concatenated."""
        k = LM_MLA_TOKENS - 4
        t = ctoks.to(dev)
        with products_in(dtype), torch.no_grad():
            lg_train, _, _ = mdl({"tokens": t}, mode="train")
            c = transformer.init_cache(ccfg, 1, 2 * LM_MLA_TOKENS, dev)
            lg, c, _ = mdl({"tokens": t[:, :k]}, mode="prefill", cache=c)
            outs = [lg_train, lg]
            for i in range(k, LM_MLA_TOKENS):
                lg, c, _ = mdl({"tokens": t[:, i:i + 1]}, mode="decode",
                               cache=c)
                outs.append(lg)
        return torch.cat(outs, dim=1).cpu().float()

    got = cut_logits(cut, card, torch.float32)
    want = cut_logits(cpu_cut, "cpu", torch.float32)
    check(bool(torch.isfinite(got).all()) and got.shape == (
        1, 2 * LM_MLA_TOKENS, cfg.vocab), "finite logits of the right shape")
    r32 = ratio(got, want)
    check(r32 <= LOGIT_TOL, f"{LOGIT_DEPTH} layers (lead + 1 MoE), f32 "
          f"products: card logits within {LOGIT_TOL} x max |logit| of the "
          f"CPU's, got {r32}")
    got16 = cut_logits(cut, card, torch.bfloat16)
    want16 = cut_logits(cpu_cut, "cpu", torch.bfloat16)
    card_vs_cpu = {"tokens": LM_MLA_TOKENS, "layer_f32": layer_f32,
                   "layer_bf16": layer_bf16, "layers": LOGIT_DEPTH,
                   "ratio_f32": r32, "ratio_bf16": ratio(got16, want16),
                   "bf16_rounding_floor": ratio(want16, want)}
    del cut, cpu_cut, p_cpu

    # -- teacher-forced prefill + decode against the full forward, at the
    # cut's 4 layers (reported, not gated: ROADMAP C, random-init logits)
    T, k = LM_FORCED
    forced = torch.tensor([prompts[0][:T]], dtype=torch.int32, device=card)
    with torch.no_grad():
        full_lg, _, _ = model({"tokens": forced}, mode="prefill")
        c = zoo.init_cache(cfg, 1, T + 4, card)
        lg, c, _ = model({"tokens": forced[:, :k]}, mode="prefill", cache=c)
        outs = [lg[:, -1]]
        for t in range(k, T - 1):
            lg, c, _ = model({"tokens": forced[:, t:t + 1]}, mode="decode",
                             cache=c)
            outs.append(lg[:, -1])
    forced_r = [ratio(o, full_lg[:, k - 1 + i]) for i, o in enumerate(outs)]

    traced = traces(cfg, model, prompts, rng, card, prefill=False)
    c1 = zoo.init_cache(cfg, 1, LM_MAX_LEN, card)["layers"]
    per_token_layer = c1["c_kv"].shape[-1] + c1["k_rope"].shape[-1]
    cache_bytes = cfg.n_layers * LM_MAX_LEN * per_token_layer * 2
    mha_bytes = cfg.n_layers * LM_MAX_LEN * 2 * cfg.n_heads * (
        m.qk_nope_dim + m.qk_rope_dim) * 2
    emit("lm_mla", card=smi, arch=LM_MLA_ARCH, cut_layers=LM_MLA_LAYERS,
         cut=f"the dense lead layer and {LM_MLA_LAYERS - 1} of "
             f"{full.n_layers - 1} MoE layers, published widths",
         uncut_params=full.param_count(), n_params=n_params,
         active_params=cfg.active_param_count(), init_s=init_s,
         params_gb=params_gb, **served, held_before_phase_gb=held_gb,
         peak_above_held_gb=served["peak_memory_allocated_gb"] - held_gb,
         mla_forms=served_forms, tokens_equal_isolated_decode=True,
         mla_cache_values_per_token_layer=per_token_layer,
         mla_cache_bytes_per_slot=cache_bytes,
         mha_cache_bytes_per_slot_same_widths=mha_bytes,
         absorbed_vs_cached_direct=r_forms, card_vs_cpu=card_vs_cpu,
         forced=dict(tokens=T, prefilled=k, layers=cfg.n_layers,
                     max_ratio=max(forced_r)),
         decode_tick=traced["decode_tick"],
         phase_s=time.perf_counter() - t_phase)


def lm_audio_phase(card, smi: str) -> None:
    """Phase ``lm_audio``: ``whisper-medium`` uncut, through JAX's path
    for an encoder-decoder (``serve_step``'s prefill with frames, then
    greedy decode steps; the batcher has no audio path in either
    package), at batch 8 and at batch 1 a clip; the card against the CPU
    at two layers; ``make_cache`` against a prefill with frames."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import pspec
    from repro_torch.models import model_zoo, whisper
    from repro_torch.serve.serve_step import (
        make_decode_step, make_prefill_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = get_arch(LM_AUDIO_ARCH)
    check((cfg.enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab) == (24, 24, 1024, 16, 64,
                                                  4096, 51865),
          f"{LM_AUDIO_ARCH} at its published widths")
    zoo = model_zoo.get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    gen = torch.Generator(device=card).manual_seed(0)
    model = zoo.build(cfg, pspec.init_params(zoo.param_defs(cfg), gen, card))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    # gate (i)
    check(n_params == cfg.param_count() == 824_986_624,
          f"{LM_AUDIO_ARCH}: 824,986,624 parameters made, got {n_params}")
    rng = np.random.default_rng(LM_SEED)
    frames = torch.from_numpy(rng.normal(size=(
        AUDIO_CLIPS, AUDIO_FRAMES, cfg.d_model)).astype(np.float32)).to(card)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (
        AUDIO_CLIPS, AUDIO_PROMPT)).astype(np.int32)).to(card)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    def transcribe(rows: slice) -> tuple[np.ndarray, dict]:
        """Greedy tokens of the clips ``rows``: the prefill with frames
        gives the first, then decode steps, each token read back as a
        server streaming tokens does; host-clock times."""
        n = rows.stop - rows.start
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = prefill(model, {"tokens": prompts[rows],
                                    "frames": frames[rows]},
                            zoo.init_cache(cfg, n, AUDIO_MAX_LEN, card))
        nxt = torch.argmax(lg[:, -1].float(), dim=-1)[:, None].to(
            torch.int32)
        out = [nxt.cpu()]
        ttft = time.perf_counter() - t
        steps = []
        while len(out) < AUDIO_NEW:
            t = time.perf_counter()
            nxt, cache = decode(model, nxt, cache)
            out.append(nxt.cpu())
            steps.append(time.perf_counter() - t)
        check(cache["len"] == AUDIO_PROMPT + AUDIO_NEW - 1,
              "the cache holds the prompt and every decoded token")
        return torch.cat(out, dim=1).numpy(), {
            "ttft_ms": ttft * 1e3,
            "decode_step_ms_p50": float(np.percentile(steps, 50)) * 1e3,
            "decode_tokens_per_s": n * len(steps) / sum(steps)}

    with torch.no_grad():
        transcribe(slice(0, 1))                         # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        enc_ms = {f"batch{b}": host_s(lambda: model.encode(frames[:b]), 3)
                  * 1e3 for b in (1, AUDIO_CLIPS)}
        toks8, run8 = transcribe(slice(0, AUDIO_CLIPS))
        toks1, runs1 = zip(*(transcribe(slice(i, i + 1))
                             for i in range(AUDIO_CLIPS)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks1 = np.concatenate(toks1)
    check(toks8.shape == (AUDIO_CLIPS, AUDIO_NEW) and bool(
        ((toks8 >= 0) & (toks8 < cfg.vocab)).all()),
        f"{AUDIO_NEW} tokens a clip, in the vocabulary")
    batch1 = {k: float(np.median([r[k] for r in runs1]))
              for k in runs1[0]}
    ratio = lambda a, b: float((a.float() - b.float()).abs().max()
                               / b.float().abs().max())

    def first_logits(dtype):
        """The prefill's next-token logits of every clip at batch 8 and
        at batch 1 a clip, with the products in ``dtype``."""
        out = []
        with products_in(dtype):
            for rows in [slice(0, AUDIO_CLIPS)] + [
                    slice(i, i + 1) for i in range(AUDIO_CLIPS)]:
                lg, _ = prefill(model, {"tokens": prompts[rows],
                                        "frames": frames[rows]},
                                zoo.init_cache(cfg, rows.stop - rows.start,
                                               AUDIO_MAX_LEN, card))
                out.append(lg[:, -1].float())
        return ratio(out[0], torch.cat(out[1:]))

    batch_ratio = {"bf16": first_logits(torch.bfloat16),
                   "f32": first_logits(torch.float32)}

    def nudged(mdl, c) -> float:
        """How far one clip's next-token logits move, f32 products, when
        every frame value is nudged one ulp up: the random-init model's
        own sensitivity, beside which the batch-8 tokens are read."""
        f = frames[:1]
        up = torch.nextafter(f, torch.full_like(f, float("inf")))
        step, out = make_prefill_step(c), []
        with products_in(torch.float32):
            for x in (f, up):
                lg, _ = step(mdl, {"tokens": prompts[:1], "frames": x},
                             zoo.init_cache(c, 1, AUDIO_MAX_LEN, card))
                out.append(lg.float())
        return ratio(out[1], out[0])

    nudge = {f"{cfg.enc_layers}+{cfg.n_layers}": nudged(model, cfg)}

    # traced batch-8 decode step
    with torch.no_grad():
        _, tcache = prefill(model, {"tokens": prompts, "frames": frames},
                            zoo.init_cache(cfg, AUDIO_CLIPS, AUDIO_MAX_LEN,
                                           card))
        step_toks = prompts[:, -1:]

        def one_step():
            nonlocal tcache
            nxt, tcache = decode(model, step_toks, tcache)
            nxt.cpu()

        traced = profile_run(one_step)

    # -- gate (ii): the card against the CPU at two layers, f32 products ---
    ccfg, cut = cut_layers(model, LOGIT_DEPTH)
    cpu_cut = on_cpu(cut)
    cframes, ctoks = frames[:1].cpu(), prompts[:1].cpu()

    def cut_logits(mdl, dev, dtype):
        """The train forward, then a prefill with frames and two decode
        steps, logits concatenated."""
        f, t = cframes.to(dev), ctoks.to(dev)
        with products_in(dtype), torch.no_grad():
            lg_train, _, _ = mdl({"tokens": t, "frames": f}, mode="train")
            c = whisper.init_cache(ccfg, 1, AUDIO_MAX_LEN, dev)
            lg, c, _ = mdl({"tokens": t, "frames": f}, mode="prefill",
                           cache=c)
            outs = [lg_train, lg]
            for _ in range(2):
                nxt = torch.argmax(outs[-1][:, -1:].float(), dim=-1).to(
                    torch.int32)
                lg, c, _ = mdl({"tokens": nxt}, mode="decode", cache=c)
                outs.append(lg)
        return torch.cat(outs, dim=1).cpu().float()

    got = cut_logits(cut, card, torch.float32)
    want = cut_logits(cpu_cut, "cpu", torch.float32)
    check(bool(torch.isfinite(got).all()) and got.shape == (
        1, 2 * AUDIO_PROMPT + 2, cfg.vocab), "finite logits, right shape")
    r32 = ratio(got, want)
    check(r32 <= LOGIT_TOL, f"{LOGIT_DEPTH} + {LOGIT_DEPTH} layers, f32 "
          f"products: card logits within {LOGIT_TOL} x max |logit| of the "
          f"CPU's (train, prefill, 2 decode steps), got {r32}")
    got16 = cut_logits(cut, card, torch.bfloat16)
    want16 = cut_logits(cpu_cut, "cpu", torch.bfloat16)
    card_vs_cpu = {"layers": LOGIT_DEPTH, "frames": AUDIO_FRAMES,
                   "ratio_f32": r32, "ratio_bf16": ratio(got16, want16),
                   "bf16_rounding_floor": ratio(want16, want)}
    nudge[f"{LOGIT_DEPTH}+{LOGIT_DEPTH}"] = nudged(cut, ccfg)
    del cut, cpu_cut

    # -- gate (iii): make_cache then decode == prefill with frames ----------
    with torch.no_grad():
        made = whisper.make_cache(cfg, model, frames[:2], AUDIO_MAX_LEN)
        a, ca, _ = model({"tokens": prompts[:2]}, mode="prefill", cache=made)
        b, cb, _ = model({"tokens": prompts[:2], "frames": frames[:2]},
                         mode="prefill", cache=whisper.init_cache(
                             cfg, 2, AUDIO_MAX_LEN, card))
        pairs = [(a, b)]
        for _ in range(2):
            nxt = torch.argmax(b[:, -1:].float(), dim=-1).to(torch.int32)
            a, ca, _ = model({"tokens": nxt}, mode="decode", cache=ca)
            b, cb, _ = model({"tokens": nxt}, mode="decode", cache=cb)
            pairs.append((a, b))
    r_cache = max(ratio(x, y) for x, y in pairs)
    check(r_cache <= LOGIT_TOL, f"make_cache then prefill and decode within "
          f"{LOGIT_TOL} x max |logit| of a prefill with frames, got "
          f"{r_cache}")

    emit("lm_audio", card=smi, arch=LM_AUDIO_ARCH, n_params=n_params,
         init_s=init_s, clips=AUDIO_CLIPS, frames=AUDIO_FRAMES,
         prompt_tokens=AUDIO_PROMPT, new_tokens=AUDIO_NEW,
         max_len=AUDIO_MAX_LEN, encoder_ms=enc_ms,
         batch8=run8, batch1_median=batch1,
         batch8_tokens_equal_batch1_share=float((toks8 == toks1).mean()),
         batch8_clips_equal_batch1=int((toks8 == toks1).all(1).sum()),
         batch8_vs_batch1_first_logits=batch_ratio,
         one_ulp_frames_nudge_f32=nudge,
         peak_memory_allocated_gb=peak_gb, held_before_phase_gb=held_gb,
         peak_above_held_gb=peak_gb - held_gb,
         decode_step_batch8=traced, card_vs_cpu=card_vs_cpu,
         make_cache_vs_prefill_max_ratio=r_cache,
         phase_s=time.perf_counter() - t_phase)


def train_leaves(state) -> dict:
    """A ``TrainState``'s tensors by dotted name (``step``, ``params.*``,
    ``mu.*``, ``nu.*``)."""
    from repro_torch.distributed.pspec import tree_items
    from repro_torch.train.optimizer import param_tree
    return {n: t.detach() for n, t in
            [("step", state.step)]
            + [(f"params.{n}", t)
               for n, t in tree_items(param_tree(state.params))]
            + [(f"mu.{n}", t) for n, t in tree_items(state.mu)]
            + [(f"nu.{n}", t) for n, t in tree_items(state.nu)]}


def train_card_vs_cpu(card, smi: str, cfg) -> dict:
    """Phase ``train`` (c): one ``make_train_step`` step of ``cfg`` cut to
    ``TRAIN_CUT`` layers with f32 products, from the same parameters on
    the card and on the CPU (plain, 2 microbatches, compressed).  Every
    row is printed before any gate; each quantity is gated at its
    ``TRAIN_VS_CPU_TOL`` limit (compressed: each leaf's int8 scale, and
    mu where the two devices' int8 levels agree)."""
    import dataclasses

    import torch
    from repro_torch.data.tokens import TokenPipeline, on_device
    from repro_torch.distributed import compression, pspec
    from repro_torch.models import model_zoo
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.train_step import (
        TrainLoopCfg, loss_and_grads, make_train_step,
    )

    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT)
    zoo = model_zoo.get_model(cut)
    g = torch.Generator(device=card).manual_seed(0)
    base = pspec.init_params(zoo.param_defs(cut), g, card)
    base_cpu = pspec.tree_map(lambda t: t.cpu(), base)
    cbatch = TokenPipeline(cut.vocab, *TRAIN_CPU_BATCH, seed=0).batch_at(0)
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b)
                             / torch.linalg.vector_norm(b))
    build = lambda tree: zoo.build(cut, pspec.tree_map(
        lambda t: t.clone(), tree))

    def one_step(dev, tree, loop):
        opt = AdamW(lr=warmup_cosine(TRAIN_LR, 20, TRAIN_STEPS))
        st = opt.init(build(tree))
        with products_in(torch.float32):
            st, m, _ = make_train_step(cut, opt, loop)(
                st, on_device(dev)(cbatch))
        return m, {k: v.cpu() for k, v in train_leaves(st).items()}

    def sent(dev, tree) -> dict:
        """What the compressed step sends: its gradients, int8-quantised
        with zero residual."""
        with products_in(torch.float32):
            _, grads = loss_and_grads(cut, build(tree),
                                      on_device(dev)(cbatch))
        return {n: t.cpu() for n, t in
                pspec.tree_items(compression.compress_grads(grads)[0])}

    def compare(a, b) -> dict:
        (ma, sa), (mb, sb) = a, b
        la, lb = float(ma["loss"]), float(mb["loss"])
        gaps = {p: {n[len(p) + 1:]: rel(sa[n], sb[n]) for n in sb
                    if n.startswith(p + ".")} for p in ("mu", "nu", "params")}
        worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]
        return {"loss_a": la, "loss_b": lb, "loss_rel": abs(la - lb) / abs(lb),
                "grad_norm_rel": abs(float(ma["grad_norm"])
                                     - float(mb["grad_norm"]))
                / float(mb["grad_norm"]),
                **{f"{p}_rel": max(d.values()) for p, d in gaps.items()},
                "mu_worst_leaves": worst(gaps["mu"]),
                "nu_worst_leaves": worst(gaps["nu"])}

    rows = {}
    for name, loop in (("plain", TrainLoopCfg()),
                       ("microbatches_2", TrainLoopCfg(microbatches=2)),
                       ("compressed", TrainLoopCfg(compress_grads=True))):
        t0 = time.perf_counter()
        got, want = one_step(card, base, loop), one_step(
            torch.device("cpu"), base_cpu, loop)
        row = rows[name] = compare(got, want)
        if loop.compress_grads:
            # int8 levels round gradients that differ in their last bits,
            # so an element on a rounding boundary may land a level apart:
            # scales compared, mu where levels agree
            # (tests/test_torch_train_step.py holds the same)
            gsent, csent = sent(card, base), sent(torch.device("cpu"),
                                                  base_cpu)
            scale = lambda t: float(t.abs().max()) / 127
            apart = {n: torch.round(gsent[n] / scale(gsent[n]))
                     != torch.round(csent[n] / scale(csent[n]))
                     for n in csent}
            row.update(
                scale_rel_max=max(abs(scale(gsent[n]) - scale(csent[n]))
                                  / scale(csent[n]) for n in csent),
                mu_rel_where_levels_agree=max(
                    rel(got[1]["mu." + n][~apart[n]],
                        want[1]["mu." + n][~apart[n]]) for n in csent),
                levels_apart=int(sum(int(a.sum()) for a in apart.values())),
                elements=sum(a.numel() for a in apart.values()))
        row["s"] = time.perf_counter() - t0
    emit("train_card_vs_cpu", card=smi, layers=TRAIN_CUT,
         batch=TRAIN_CPU_BATCH, products="f32", limits=TRAIN_VS_CPU_TOL,
         **rows)
    for name, row in rows.items():
        keys = (("scale_rel_max", "mu_rel_where_levels_agree")
                if name == "compressed" else ("mu_rel", "nu_rel"))
        for key in ("loss_rel", "grad_norm_rel") + keys:
            check(row[key] <= TRAIN_VS_CPU_TOL[key], f"{name}: {key} card "
                  f"vs CPU {row[key]} > {TRAIN_VS_CPU_TOL[key]}")
    return rows


def train_scan_refusal(card) -> dict:
    """Phase ``train`` (d): on the card a loss of a reduced RWKV6 and
    Zamba2 under autograd raises ``NoBackwardError`` before ``chunk_scan``
    launches; the same forward under ``torch.no_grad()`` launches it."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline, on_device
    from repro_torch.distributed import pspec
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.kernels.ops import NoBackwardError
    from repro_torch.models import model_zoo

    refusal = {}
    for arch in TRAIN_SCAN_ARCHS:
        rcfg = get_arch(arch).reduced()
        rzoo = model_zoo.get_model(rcfg)
        g = torch.Generator(device=card).manual_seed(0)
        model = rzoo.build(rcfg, pspec.init_params(rzoo.param_defs(rcfg), g,
                                                   card))
        rb = on_device(card)(TokenPipeline(rcfg.vocab, 2, 64, seed=0)
                             .batch_at(0))
        before = cs.launches
        try:
            rzoo.loss_fn(rcfg, model, rb)
            raised = None
        except NoBackwardError as e:
            raised = str(e)
        check(raised is not None and cs.launches == before,
              f"{arch}: a loss under autograd on the card raises "
              f"NoBackwardError before launching chunk_scan")
        with torch.no_grad():
            loss = float(rzoo.loss_fn(rcfg, model, rb))
        refusal[arch] = {"raised": raised[:80], "no_grad_loss": loss,
                         "no_grad_launches": cs.launches - before}
        check(cs.launches > before and np.isfinite(loss),
              f"{arch}: the no-grad forward launches chunk_scan")
    return refusal


def train_phase(card, smi: str) -> float:
    """Phase ``train``: the single-device training half.  (a) the launcher
    on ``tinyllama-1.1b`` uncut, 30 steps of 8 x 512 Markov tokens in 2
    microbatches, checkpointing into a directory of the checkout, which is
    also run A of (b): it saves ``step_25`` (async, in flight over steps
    26-30) and ``step_30``; its gates: finite losses, the last 5 below
    the first, and a held-out batch's loss down by ``TRAIN_MIN_DROP``
    from the seed-0 init's; (b) the restored ``step_30`` equals run A's
    state leaf for leaf, and run B, over a directory holding only
    ``step_25``, resumes there with step 26's loss ``==`` run A's; (c)
    one step of the model cut to 2 layers with f32 products on the card
    and on the CPU from the same parameters (plain, 2 microbatches,
    compressed); (d) RWKV6 and Zamba2 losses under autograd on the card
    raise ``NoBackwardError`` (``chunk_scan``'s kernel has no backward)
    and their no-grad forwards still launch the kernel.  Returns the
    step p50 (seconds) of (a), without a write in flight."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline, on_device
    from repro_torch.distributed import pspec
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo, transformer
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamW, param_tree, warmup_cosine
    from repro_torch.train.train_step import TrainLoopCfg, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab) == (22, 2048, 32, 4, 64, 5632,
                                                  32000),
          f"{TRAIN_ARCH} at its published widths")
    n_params = cfg.param_count()
    ckpt_gb = 3 * 4 * n_params / 1e9          # params + mu + nu, f32
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(root).free / 1e9
    emit("train_disk", card=smi, dir=str(root), free_gb=free_gb,
         checkpoint_gb=ckpt_gb, most_at_once=2)
    check(free_gb > 2 * ckpt_gb + 5, f"room for two {ckpt_gb:.1f} GB "
          f"checkpoints in {root}: {free_gb:.1f} GB free")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    floor = float(np.log(cfg.vocab))
    # gate (a) reads one held-out batch, which no step trains on, under
    # no_grad before step 1 (the launcher's seed-0 init, rebuilt here) and
    # after step 30: a trainer that never updated reads a drop of 0
    zoo = model_zoo.get_model(cfg)
    pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    held = on_device(card)(pipe.batch_at(TRAIN_HELDOUT))

    def held_loss(model) -> float:
        with torch.no_grad():
            return float(zoo.loss_fn(cfg, model, held))

    gen = torch.Generator(device=card).manual_seed(0)
    held_before = held_loss(zoo.build(cfg, pspec.init_params(
        zoo.param_defs(cfg), gen, card)))
    gc.collect()
    torch.cuda.empty_cache()
    work = pathlib.Path(tempfile.mkdtemp(prefix="train_smoke_", dir=root))
    try:
        x_dir, y_dir = work / "x", work / "y"

        def launch(ckpt_dir):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                out = launch_train.run([
                    "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                    "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                    "--microbatches", str(TRAIN_MICRO), "--lr",
                    str(TRAIN_LR), "--ckpt-dir", str(ckpt_dir),
                    "--ckpt-every", str(TRAIN_RESUME_AT), "--log-every", "5",
                    "--seed", "0"])
            return out, log.getvalue().splitlines()

        # -- (a) the launcher at full width; run A of (b) -------------------
        torch.cuda.synchronize()
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_a, log_a = launch(x_dir)
        run_a_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = run_a.losses
        check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
              f"{TRAIN_STEPS} finite losses, got {losses}")
        last5 = float(np.mean(losses[-5:]))
        check(last5 < losses[0], f"the mean of the last 5 losses ({last5}) "
              f"below the first ({losses[0]}); losses {losses}")
        held_after = held_loss(run_a.state.params)
        check(held_after <= held_before - TRAIN_MIN_DROP,
              f"the held-out batch's loss drops by {TRAIN_MIN_DROP} or more "
              f"over the run: {held_before} -> {held_after}")
        first_step_s = run_a.step_s[0]             # cuBLAS and allocator
        quiet = run_a.step_s[1:TRAIN_RESUME_AT]    # no write in flight
        busy = run_a.step_s[TRAIN_RESUME_AT:]      # step_25 being written
        pct = lambda a, q: float(np.percentile(a, q))
        saves = [dict(e, gb_per_s=e["bytes"] / 1e9 / e["write_s"])
                 for e in run_a.ckpt_log]
        check([e["step"] for e in saves] == [TRAIN_RESUME_AT, TRAIN_STEPS],
              f"saves at steps {TRAIN_RESUME_AT} and {TRAIN_STEPS}")

        # -- (b) restore and resume at full width --------------------------
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, _ = ckpt.restore(str(x_dir / f"step_{TRAIN_STEPS}"),
                                   device=card)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want, got = train_leaves(run_a.state), train_leaves(restored)
        check(set(want) == set(got) and all(
            torch.equal(want[n], got[n]) for n in want),
            "the restored step_30 equals run A's state on every leaf")
        del restored, got, want
        y_dir.mkdir()
        shutil.move(str(x_dir / f"step_{TRAIN_RESUME_AT}"),
                    str(y_dir / f"step_{TRAIN_RESUME_AT}"))
        shutil.rmtree(x_dir)
        t0 = time.perf_counter()
        run_b, log_b = launch(y_dir)
        run_b_s = time.perf_counter() - t0
        shutil.rmtree(y_dir)
        check(run_b.start_step == TRAIN_RESUME_AT and any(
            ln.startswith("resumed from") and ln.endswith(
                f"at step {TRAIN_RESUME_AT}") for ln in log_b),
            f"run B resumed at step {TRAIN_RESUME_AT}: {log_b[:2]}")
        check(run_b.losses[0] == losses[TRAIN_RESUME_AT],
              f"run B's step {TRAIN_RESUME_AT + 1} loss "
              f"{run_b.losses[0]} == run A's {losses[TRAIN_RESUME_AT]}")
        pa, pb = (train_leaves(r.state) for r in (run_a, run_b))
        drift = {"loss_abs": [abs(b - a) for a, b in zip(
                     losses[TRAIN_RESUME_AT:], run_b.losses)],
                 "params_max_rel_norm": max(float(
                     (pb[n] - pa[n]).norm() / pa[n].norm())
                     for n in pa if n.startswith("params."))}
        del pa, pb, run_a

        # -- a traced step, the optimizer alone ----------------------------
        state = run_b.state
        opt = AdamW(lr=warmup_cosine(TRAIN_LR, 20, TRAIN_STEPS))
        step_fn = make_train_step(cfg, opt, TrainLoopCfg(
            microbatches=TRAIN_MICRO))
        batch = on_device(card)(pipe.batch_at(TRAIN_STEPS))
        traced = profile_run(lambda: float(step_fn(state, batch)[1]["loss"]))

        def timed_step(remat: bool) -> float:
            transformer.set_remat(remat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step_fn(state, batch)[1]["loss"])
            return time.perf_counter() - t0

        remat_ab = {"on_s": [], "off_s": []}
        try:
            for on in TRAIN_REMAT_AB:
                remat_ab["on_s" if on else "off_s"].append(timed_step(on))
        finally:
            transformer.set_remat(True)
        remat_ab["p50_on_over_off"] = (statistics.median(remat_ab["on_s"])
                                       / statistics.median(remat_ab["off_s"]))
        grads = pspec.tree_map(torch.zeros_like, param_tree(state.params))
        opt_ms = cuda_ms(lambda: opt.update(state, grads), reps=5, warmup=1)
        opt_trace = profile_run(lambda: opt.update(state, grads))
        del state, run_b, grads, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    emit("train", card=smi, arch=TRAIN_ARCH, n_params=n_params,
         steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         microbatches=TRAIN_MICRO, lr=TRAIN_LR, warmup=20,
         losses=losses, first_loss=losses[0], last5_mean=last5,
         uniform_floor=floor, heldout_batch=TRAIN_HELDOUT,
         heldout_loss_before=held_before, heldout_loss_after=held_after,
         heldout_drop=held_before - held_after,
         heldout_min_drop=TRAIN_MIN_DROP, launcher_log=log_a, run_s=run_a_s,
         run_tokens_per_s=tokens * TRAIN_STEPS / run_a_s,
         step_tokens_per_s=tokens / pct(quiet, 50),
         step_p50_s=pct(quiet, 50), step_p99_s=pct(quiet, 99),
         first_step_s=first_step_s,
         steps_with_write_in_flight_s=busy,
         optimizer_ms=opt_ms, optimizer_device_kernels=opt_trace[
             "device_kernels"], optimizer_trace=opt_trace,
         held_before_phase_gb=held_gb, peak_gb=peak_gb,
         peak_above_held_gb=peak_gb - held_gb,
         reckoned_state_gb={"params": 4 * n_params / 1e9,
                            "grads": 4 * n_params / 1e9,
                            "mu_nu": 8 * n_params / 1e9},
         remat=True, remat_ab=remat_ab,
         traced_step=traced, saves=saves, restore_s=restore_s,
         restore_gb_per_s=saves[-1]["bytes"] / 1e9 / restore_s,
         restored_equals_saved=True, run_b_s=run_b_s, run_b_log=log_b,
         resumed_loss_equal=True, drift=drift,
         phase_s=time.perf_counter() - t_phase)
    train_card_vs_cpu(card, smi, cfg)
    emit("train_refusal", card=smi, **train_scan_refusal(card),
         phase_s=time.perf_counter() - t_phase)
    return pct(quiet, 50)


def train_long_phase(card, smi: str) -> None:
    """Phase ``train_long``: training at ``train_4k``'s 4,096-token rows,
    which only remat makes fit: without it each layer of the blockwise
    attention keeps two f32 (1, 32, 4096, 512) tensors a KV block for the
    backward, ~4.3 GB a layer a row.  (a) ``launch.train`` on
    ``tinyllama-1.1b`` uncut, ``TRAIN_LONG_STEPS`` steps of
    ``TRAIN_LONG_BATCH`` rows in ``TRAIN_LONG_MICRO`` microbatches (one
    row each), no checkpoint; (b) the model cut to ``TRAIN_LONG_CUT``
    layers, one row, ``loss_and_grads`` without remat, with, and without
    again.  Gates in the module docstring."""
    import contextlib
    import dataclasses
    import io

    import torch
    from repro_torch.analysis import memory as memory_lib
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES, ShapeCfg
    from repro_torch.data.tokens import TokenPipeline, on_device
    from repro_torch.distributed import pspec
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo, transformer
    from repro_torch.train.train_step import loss_and_grads

    t_phase = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab) == (22, 2048, 32, 4, 64, 5632,
                                                  32000),
          f"{TRAIN_ARCH} at its published widths")
    seq = SHAPES[TRAIN_LONG_SHAPE].seq_len
    check(seq >= L._BLOCKWISE_MIN and transformer._USE_REMAT,
          f"{seq}-token rows take the blockwise path, remat on")
    gc.collect()
    torch.cuda.empty_cache()

    # -- (a) the launcher at full width -----------------------------------
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        run = launch_train.run([
            "--arch", TRAIN_ARCH, "--steps", str(TRAIN_LONG_STEPS),
            "--batch", str(TRAIN_LONG_BATCH), "--seq", str(seq),
            "--microbatches", str(TRAIN_LONG_MICRO), "--lr", str(TRAIN_LR),
            "--log-every", "1", "--seed", "0"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held0
    state = torch.cuda.memory_allocated() - held0    # params, mu, nu, step
    losses, step_s = run.losses, run.step_s
    check(len(losses) == TRAIN_LONG_STEPS and all(np.isfinite(losses)),
          f"{TRAIN_LONG_STEPS} finite losses at {seq}-token rows: {losses}")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    plan = memory_lib.budget(
        cfg, ShapeCfg(TRAIN_LONG_SHAPE, seq, TRAIN_LONG_BATCH, "train"), {},
        model_zoo.get_model(cfg).param_defs(cfg))
    pct = lambda a, q: float(np.percentile(a, q))
    warm = step_s[1:]                           # the first sets up cuBLAS
    emit("train_long", card=smi, arch=TRAIN_ARCH, steps=TRAIN_LONG_STEPS,
         batch=TRAIN_LONG_BATCH, seq=seq, microbatches=TRAIN_LONG_MICRO,
         remat=True, losses=losses, launcher_log=log.getvalue().splitlines(),
         step_s=step_s, step_p50_s=pct(warm, 50), step_p99_s=pct(warm, 99),
         step_tokens_per_s=TRAIN_LONG_BATCH * seq / pct(warm, 50),
         run_s=run_s, held_before_gb=held0 / 1e9, peak_gb=peak / 1e9,
         state_gb=state / 1e9, peak_above_state_gb=(peak - state) / 1e9,
         dry_run_one_chip_gb={
             "state": (plan.params_bytes + plan.optimizer_bytes
                       + plan.grads_bytes) / 1e9,
             "activation_bytes": plan.activation_bytes / 1e9,
             "total": plan.total_bytes / 1e9, "fits": plan.fits},
         phase_s=time.perf_counter() - t_phase)

    # -- (b) remat against none, TRAIN_LONG_CUT layers, one row -----------
    cut = dataclasses.replace(cfg, n_layers=TRAIN_LONG_CUT)
    zoo = model_zoo.get_model(cut)
    gen = torch.Generator(device=card).manual_seed(0)
    model = zoo.build(cut, pspec.init_params(zoo.param_defs(cut), gen, card))
    batch = on_device(card)(TokenPipeline(cut.vocab, 1, seq, seed=0)
                            .batch_at(0))

    # without remat: layer remat off, and every region (the blockwise
    # steps' too, which have no switch, as in JAX) run as a plain call
    checkpointed = L.remat

    def one(remat: bool) -> dict:
        transformer.set_remat(remat)
        L.remat = checkpointed if remat else (lambda fn: fn)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(cut, model, batch)
        torch.cuda.synchronize()
        return {"s": time.perf_counter() - t0, "loss": loss,
                "grads": dict(pspec.tree_items(grads)),
                "activation_peak": torch.cuda.max_memory_allocated() - held}

    try:
        off, on, rep = one(False), one(True), one(False)
    finally:
        transformer.set_remat(True)
        L.remat = checkpointed
    gap = lambda a, b: 0.0 if torch.equal(a, b) else float(
        (a - b).abs().max())
    repeat = max(gap(rep["grads"][n], off["grads"][n]) for n in off["grads"])
    remat_gap = {n: gap(on["grads"][n], off["grads"][n])
                 for n in off["grads"]}
    ratio = on["activation_peak"] / off["activation_peak"]
    emit("train_long_remat", card=smi, arch=f"{TRAIN_ARCH} cut to "
         f"{TRAIN_LONG_CUT} layers", rows=1, seq=seq,
         loss={"off": float(off["loss"]), "on": float(on["loss"]),
               "off_again": float(rep["loss"])},
         step_s={"off": off["s"], "on": on["s"], "off_again": rep["s"]},
         activation_peak_gb={k: r["activation_peak"] / 1e9 for k, r in
                             (("off", off), ("on", on), ("off_again", rep))},
         peak_ratio=ratio, peak_ratio_limit=REMAT_PEAK_RATIO,
         grad_repeat_max_abs=repeat,
         grad_remat_max_abs=max(remat_gap.values()),
         grad_leaves_unequal=sum(g > 0 for g in remat_gap.values()),
         grad_leaves=len(remat_gap), phase_s=time.perf_counter() - t_phase)
    check(bool(torch.isfinite(on["loss"]))
          and torch.equal(on["loss"], off["loss"]),
          f"the loss with remat == without: {float(on['loss'])} vs "
          f"{float(off['loss'])}")
    check(max(remat_gap.values()) <= REMAT_REPEAT_FACTOR * repeat,
          f"every gradient with remat within {REMAT_REPEAT_FACTOR} x the "
          f"card's own repeat ({repeat}) of the one without: "
          f"{sorted(remat_gap.items(), key=lambda kv: -kv[1])[:3]}")
    check(ratio <= REMAT_PEAK_RATIO, f"the activation peak with remat "
          f"{ratio:.3f} of the one without, at most {REMAT_PEAK_RATIO}")
    del model, off, on, rep
    gc.collect()
    torch.cuda.empty_cache()


def dist_phase(card, smi: str, train_p50_s: float) -> None:
    """Phase ``dist``: the multi-device half on the card, with one rank.
    (1) a one-rank NCCL group through ``distributed.group.init`` (a
    ``file://`` store in a temporary directory) and a (1, 1) ("data",
    "model") ``DeviceMesh`` on ``cuda``; the backend and NCCL's version
    printed; (2) ``compressed_psum`` over every leaf of ``tinyllama-1.1b``'s
    uncut parameter shapes (1,100,048,384 f32 values from a seeded
    generator on the card) over the mesh's "data" group, without and then
    with the error feedback: ``mean`` and ``new_err`` equal
    ``compress_grads``' output and residual (``torch.equal``), the whole
    tree's collective time (host clock around synchronised calls); (3) ``tinyllama-1.1b`` cut to 2 layers, its
    state placed by ``train_state_shardings`` on the mesh: ``save`` of it
    writes the arrays and template that ``save`` of the plain state writes
    (its ``host_tree``),
    ``restore`` with the shardings gives DTensors on ``cuda`` equal to
    the plain ``restore``, ``remesh`` onto a one-rank ("data",) mesh keeps
    every value; (4) ``pipeline_forward`` with one stage and M = 6 equals
    the stage run on each microbatch; (5) the dry run: ``run_cell`` of
    ``tinyllama-1.1b`` x ``train_4k`` (base and opt) and
    ``deepseek-v2-236b`` x ``decode_32k`` on 16x16, each with its sharded
    trace over a fake group of 256 ranks: every cell moves collective
    bytes (its three-term bottleneck printed), and no process group is
    left behind; and the count of phase ``train``'s step
    (``tinyllama-1.1b`` uncut, 8 x 512 tokens, 2 microbatches) at one
    chip: its p50 must be at least ``t_compute``, and the same model and
    tokens sharded over a (1, 1) mesh emit no collective."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.analysis import roofline as roof
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.distributed import group, pspec
    from repro_torch.distributed.compression import (
        compress_grads, compressed_psum,
    )
    from repro_torch.distributed.pipeline import make_stage_mesh, pipeline_forward
    from repro_torch.distributed.sharding import (
        NamedSharding, train_state_shardings,
    )
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (
        Mesh, make_device_mesh, make_host_mesh,
    )
    from repro_torch.models import model_zoo
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import remesh
    from repro_torch.train.optimizer import AdamW, TrainState, warmup_cosine
    from repro_torch.train.train_step import TrainLoopCfg, make_train_step

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if card.type == "cuda" else (lambda: None)
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="dist_smoke_",
                                         dir=ROOT / "build"))
    try:
        # -- (1) the group ------------------------------------------------
        backend = group.init(0, 1, str(work / "store"), device=card.type)
        check(backend == group.BACKENDS[card.type],
              f"{group.BACKENDS[card.type]} on {card.type}, got {backend}")
        mesh = make_host_mesh(1, 1, device=card.type)
        nccl = (".".join(map(str, torch.cuda.nccl.version()))
                if card.type == "cuda" else None)
        emit("dist_group", card=smi, backend=backend, nccl=nccl,
             world=dist.get_world_size(), mesh=str(mesh))

        # -- (2) compressed_psum over tinyllama's uncut tree --------------
        cfg = get_arch(TRAIN_ARCH)
        defs = model_zoo.get_model(cfg).param_defs(cfg)
        shapes = [(n, d.shape) for n, d in pspec.tree_items(defs)]
        n_values = sum(math.prod(s) for _, s in shapes)
        check(n_values == DIST_TREE_VALUES,
              f"{TRAIN_ARCH}'s {n_values} values")
        gen = torch.Generator(device=card).manual_seed(0)
        warm = torch.ones(1024, device=card)
        compressed_psum(warm, (mesh, "data"))
        psum_ms, host_scalar_div = {}, 0
        errs: dict = {}
        for fb in ("no_err", "err"):
            total = 0.0
            for name, shape in shapes:
                g = torch.randn(shape, generator=gen, device=card)
                e = errs.get(name) if fb == "err" else None
                sync()
                t0 = time.perf_counter()
                mean, new_err = compressed_psum(g, (mesh, "data"), e)
                sync()
                total += (time.perf_counter() - t0) * 1e3
                want, want_err = compress_grads(
                    {"x": g}, None if e is None else {"x": e})
                check(torch.equal(mean, want["x"])
                      and torch.equal(new_err, want_err["x"]),
                      f"compressed_psum == compress_grads on {name} ({fb})")
                if fb == "no_err":
                    amax = torch.max(torch.abs(g))
                    host_scalar_div += int(not torch.equal(
                        amax / 127, torch.div(amax, torch.tensor(
                            127.0, device=card))))
                errs[name] = new_err
                del g, e, mean, new_err, want, want_err
            psum_ms[fb] = total
        del errs
        emit("dist_psum", card=smi, arch=TRAIN_ARCH, leaves=len(shapes),
             values=n_values, equal_compress_grads=True, tree_ms=psum_ms,
             gb_per_s={k: 4 * n_values / 1e6 / v for k, v in psum_ms.items()},
             leaves_where_amax_over_127_is_not_a_division=host_scalar_div)
        gc.collect()
        torch.cuda.empty_cache()

        # -- (3) sharded save, restore and remesh --------------------------
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        defs2 = model_zoo.get_model(cfg2).param_defs(cfg2)
        params = pspec.init_params(defs2, gen, card)
        rnd = lambda t: torch.randn(t.shape, generator=gen, device=card)
        plain = TrainState(step=torch.tensor(7, dtype=torch.int32,
                                             device=card),
                           params=params,
                           mu=pspec.tree_map(lambda t: rnd(t) * 1e-3, params),
                           nu=pspec.tree_map(lambda t: rnd(t).abs_() * 1e-6,
                                             params))
        shardings = train_state_shardings(cfg2, mesh, defs2)
        placed = remesh(plain, shardings)
        leaves = train_leaves(placed)
        check(all(isinstance(t, DTensor) for t in leaves.values()),
              "every placed leaf is a DTensor")
        ckpt.save(str(work / "sharded"), placed)
        # what ``save`` of the plain state writes: its host tree's arrays
        # under the same names, and its template
        want_host = ckpt.host_tree(plain)
        want_flat = ckpt._flatten(want_host)
        with np.load(work / "sharded" / "arrays.npz") as z:
            check(set(z.files) == set(want_flat) and all(
                np.array_equal(z[k], want_flat[k]) for k in z.files),
                "save of the sharded state writes the plain state's arrays")
        with open(work / "sharded" / "manifest.json") as f:
            check(json.load(f)["template"] == ckpt._tree_template(
                want_host), "and its template")
        del want_host, want_flat
        restored, _ = ckpt.restore(str(work / "sharded"), shardings)
        want, _ = ckpt.restore(str(work / "sharded"), device=card)
        got, ref = train_leaves(restored), train_leaves(want)
        check(got.keys() == ref.keys() and all(
            isinstance(t, DTensor) and t.device.type == card.type
            and torch.equal(t.full_tensor(), ref[n]) for n, t in got.items()),
            "restore with shardings: DTensors on the card == plain restore")
        check(all(torch.equal(ref[n], t) for n, t in
                  train_leaves(plain).items()), "plain restore == the state")
        one = make_device_mesh((1,), ("data",), device=card.type)
        to_one = lambda tree: pspec.tree_map(
            lambda s: NamedSharding(one, ("data",) if s.spec else ()), tree)
        moved = remesh(restored, TrainState(
            step=NamedSharding(one, ()), params=to_one(shardings.params),
            mu=to_one(shardings.mu), nu=to_one(shardings.nu)))
        check(all(torch.equal(t.full_tensor(), ref[n]) and t.device_mesh
                  is one for n, t in train_leaves(moved).items()),
              "remesh onto a one-rank ('data',) mesh keeps every value")
        ckpt_bytes = sum(t.numel() * t.element_size() for t in ref.values())
        del plain, placed, restored, want, moved, got, ref, leaves, params
        gc.collect()
        torch.cuda.empty_cache()
        emit("dist_ckpt", card=smi, arch=f"{TRAIN_ARCH} cut to 2 layers",
             leaves=len(pspec.tree_items(defs2)),
             bytes=ckpt_bytes, save_equal=True, restore_equal=True,
             remesh_equal=True)

        # -- (4) the pipeline with one stage --------------------------------
        stage = make_stage_mesh(1, device=card.type)
        Ws = torch.randn((1, 1024, 1024), generator=gen, device=card) / 32
        mbs = torch.randn((6, 8, 1024), generator=gen, device=card)
        fn = lambda W, x: torch.tanh(x @ W)
        out = pipeline_forward(fn, stage)(Ws, mbs)
        ref = torch.stack([fn(Ws[0], mbs[i]) for i in range(6)])
        check(torch.equal(out, ref), "pipeline (1 stage, M = 6) == the "
              "stage on each microbatch")
        emit("dist_pipeline", card=smi, stages=1, microbatches=6,
             equal=True)
        del Ws, mbs, out, ref
    finally:
        group.destroy()
        shutil.rmtree(work, ignore_errors=True)

    # -- (5) the dry run ------------------------------------------------------
    cells = {}
    for arch, shape, layout in ((TRAIN_ARCH, "train_4k", "base"),
                                (TRAIN_ARCH, "train_4k", "opt"),
                                (LM_MLA_ARCH, "decode_32k", "base")):
        rec = dryrun.run_cell(arch, shape, False, layout=layout)
        name = f"{arch} x {shape} x {rec['mesh']}"
        check(not dist.is_initialized(), f"{name}: the sharded trace left "
              "no process group behind")
        r, coll = rec["roofline"], rec["collectives"]
        check(rec["status"] == "ok" and "bytes_by_kind" in coll
              and sum(coll["bytes_by_kind"].values()) > 0
              and r["t_collective_s"] is not None,
              f"{name}: the 256-card cell moves collective bytes "
              f"({coll})")
        cells[name] = {
            "status": rec["status"], "t_trace_s": rec["t_trace_s"],
            "t_sharded_trace_s": rec["t_sharded_trace_s"],
            "counts": rec["counts"], "fits": rec["analytic_memory"]["fits"],
            "total_gb": rec["analytic_memory"]["total_gb"],
            "collectives": coll,
            "collective_bytes_per_chip": r["collective_bytes_per_chip"],
            "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
            "t_memory_op_bytes_s": r["t_memory_hlo_s"],
            "t_collective_s": r["t_collective_s"],
            "bottleneck": r["bottleneck"],
            "roofline_fraction": r["roofline_fraction"],
            "affine_rel_err": r["affine_rel_err"],
            "affine_exact": r["affine_exact"],
            "t_cell_s": rec["t_total_s"]}
    # phase train's model and tokens a step, sharded over a mesh of one
    # card: no collective dispatched (the counter counts every one)
    one, t_one = dryrun.trace_sharded(
        cfg, ShapeCfg("t", TRAIN_SEQ, TRAIN_BATCH, "train"),
        Mesh(("data", "model"), (1, 1)))
    check(one.total_bytes == 0 and not any(one.counts.values())
          and not dist.is_initialized(),
          f"the one-chip train step launches no collective ({one})")
    zoo = model_zoo.get_model(cfg)
    model = zoo.build(cfg, pspec.abstract_params(defs))
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, 20, TRAIN_STEPS))
    state = opt.init(model)
    step_fn = make_train_step(cfg, opt, TrainLoopCfg(microbatches=TRAIN_MICRO))
    batch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    with roof.OpCounter() as counter:
        step_fn(state, batch, None)
    t_count = time.perf_counter() - t0
    terms = roof.RooflineTerms(
        flops_per_chip=counter.flops, hbm_bytes_per_chip=counter.bytes,
        collective_bytes_per_chip=one.total_bytes, chips=1,
        model_flops=6.0 * cfg.param_count() * TRAIN_BATCH * TRAIN_SEQ)
    check(train_p50_s >= terms.t_compute,
          f"phase train's step p50 {train_p50_s} s is at least the counted "
          f"compute bound {terms.t_compute} s")
    emit("dist_dryrun", card=smi, cells=cells,
         train_step={"arch": TRAIN_ARCH, "batch": TRAIN_BATCH,
                     "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
                     "t_trace_s": t_count, "counts": counter.as_dict(),
                     "t_sharded_trace_s": t_one,
                     "collectives": {"counts": one.counts,
                                     "bytes_by_kind": one.bytes_by_kind},
                     "bottleneck": terms.bottleneck,
                     "t_compute_s": terms.t_compute,
                     "t_memory_op_bytes_s": terms.t_memory,
                     "p50_s": train_p50_s,
                     "p50_over_t_compute": train_p50_s / terms.t_compute,
                     "p50_over_t_memory": train_p50_s / terms.t_memory,
                     "useful_flops_fraction": terms.useful_flops_fraction},
         phase_s=time.perf_counter() - t_phase)


def compact_phase(card) -> tuple[dict, dict]:
    """Phase ``compact``: for each exit profile, a model trained on
    ``make_profile_dataset(profile, 6000, seed=0xD2)`` walks its test
    windows tiled to B_MAIN flows, dense and compacted (the hop kernel's
    survivor mode), on the card.  Gates, each a raise: compacted verdicts
    equal the tiled ``pdt.predict`` and the dense walk, P hop launches of
    which P - 1 in survivor mode;
    the compacted trace equals the plain compacted walk's and the dense
    trace on every live (hop, flow); ``run_looped`` with and without
    ``compact`` gives the same verdicts and trace with one launch each of
    kernels A and B a hop that has survivors; the compacted walk captured
    in a CUDA graph and replayed gives the same fetch buffer (a host sync
    inside would have failed the capture).  Times: CUDA-event medians of
    the dense and compacted walks on the device with and without the
    trace, ``Engine.run`` from a device tensor dense and compacted, each
    compacted hop's kernel and ``run_looped``, each beside its bound (the
    live flows' windows and carry over 3.35 TB/s).  Returns the phase's
    line and, for phases ``stream`` and ``tune``, each profile's model,
    its untiled test windows and the oracle's verdicts on them."""
    import torch

    from repro_torch.core.inference import (
        Engine, EngineOptions, partition_walk,
    )
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.flows.synthetic import (
        EXIT_PROFILES, make_profile_dataset,
    )
    from repro_torch.flows.windows import window_features, window_packets
    from repro_torch.kernels import dt_traverse
    from repro_torch.kernels import engine_hop as eh
    from repro_torch.kernels import feature_window as fw
    from repro_torch.kernels.compaction import compact_perm
    t_phase = time.perf_counter()
    out, models = {}, {}
    for profile in EXIT_PROFILES:
        t0 = time.perf_counter()
        ds = make_profile_dataset(profile, n_flows=6000, seed=0xD2)
        tr, te = ds.split()
        pdt = train_partitioned_dt(window_features(tr, 3), tr.labels,
                                   partition_sizes=[3, 3, 3], k=4)
        wp_te = window_packets(te, 3)
        reps = -(-B_MAIN // wp_te.shape[0])
        tile = lambda a: np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:B_MAIN]
        x = torch.from_numpy(tile(wp_te)).to(card)      # (B, P, W, 6)
        verdicts = pdt.predict(window_features(te, 3, device="cpu"),
                               return_trace=True)
        models[profile] = (pdt, wp_te, verdicts)
        oracle = [tile(a) for a in verdicts]
        eng = Engine.from_model(pdt)
        dev = eng.tables.dev
        B, P, W = x.shape[0], eng.tables.n_partitions, x.shape[2]
        k = dev.slot_op.shape[1]
        S = dev.slot_op.shape[0]
        setup_s = time.perf_counter() - t0
        comp_opt = EngineOptions(compact=True)

        dense = eng.run(x)
        eh.launches = eh.survivor_launches = 0
        comp = eng.run(x, options=comp_opt)
        hop_launches, survivor_launches = eh.launches, eh.survivor_launches
        check(hop_launches == P and survivor_launches == P - 1,
              f"{profile}: P hop launches in a compacted run, P - 1 of "
              f"them in survivor mode, got {hop_launches} and "
              f"{survivor_launches}")
        for name, want in zip(("labels", "recircs", "exit_partition"),
                              oracle):
            got = getattr(comp, name)
            check(np.array_equal(got, want),
                  f"{profile}: compact {name} == pdt.predict")
            check(np.array_equal(got, getattr(dense, name)),
                  f"{profile}: compact {name} == dense")
        exits = comp.exit_partition
        live = [((exits < 0) | (exits >= p)) for p in range(P)]
        survivors = [int(m.sum()) for m in live]
        plain = eng.run(x, options=EngineOptions(impl="fused", compact=True))
        for p in range(P):
            c, d = comp.regs_trace[p], dense.regs_trace[p]
            check(np.array_equal(c.view(np.int32),
                                 plain.regs_trace[p].view(np.int32)),
                  f"{profile}: compact trace == plain compacted, hop {p}")
            check(np.array_equal(c[live[p]].view(np.int32),
                                 d[live[p]].view(np.int32))
                  and not c[~live[p]].any(),
                  f"{profile}: compact trace == dense where live, hop {p}")

        looped = {}
        for compact in (False, True):
            a0, b0 = fw.launches, dt_traverse.launches
            res = eng.run_looped(x, options=EngineOptions(compact=compact))
            la, lb = fw.launches - a0, dt_traverse.launches - b0
            want_hops = (sum(n > 0 for n in survivors) if compact else P)
            check(la == lb == want_hops,
                  f"{profile}: run_looped(compact={compact}) launches one "
                  f"kernel A and one kernel B a hop with survivors, got "
                  f"{la}, {lb} for {want_hops}")
            ref_res = comp if compact else dense
            for name in ("labels", "recircs", "exit_partition"):
                check(np.array_equal(getattr(res, name),
                                     getattr(ref_res, name)),
                      f"{profile}: run_looped(compact={compact}) {name}")
            for a, b in zip(res.regs_trace, ref_res.regs_trace):
                check(np.array_equal(a.view(np.int32), b.view(np.int32)),
                      f"{profile}: run_looped(compact={compact}) trace")
            looped[f"compact={compact}"] = {"feature_window": la,
                                            "dt_traverse": lb}

        walk_kw = dict(n_subtrees=eng.tables.n_subtrees, n_partitions=P,
                       hop=eh.engine_hop_kernel)
        walk = lambda compact, trace: partition_walk(
            x, dev, with_trace=trace, compact=compact, **walk_kw)
        want_buf = walk(True, True)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            graph_buf = walk(True, True)
        g.replay()
        torch.cuda.synchronize()
        check(torch.equal(graph_buf, want_buf),
              f"{profile}: the compacted walk replayed from a CUDA graph "
              f"== the launched walk")
        del g, graph_buf, want_buf

        # least traffic of a hop over its live flows: their windows, the
        # carry read and written (17 bytes a flow each way), the registers
        # written, the tables; the compacted hops also read the survivor
        # rows of the permutation
        table_bytes = sum(t.numel() * t.element_size() for t in dev)

        def hop_bytes(n, compacted):
            return (n * W * 6 * 4 + n * 17 * 2 + n * k * 4 + table_bytes
                    + (n * 4 if compacted else 0))

        T, L = dev.thresholds.shape[2], dev.leaf_lo.shape[1]

        def hop_ops(n):
            return n * k * W * 6 + n * (k * T + 2 * L * k)

        bound = lambda ns, c: sum(bound_ms(hop_bytes(n, c and p > 0),
                                           hop_ops(n))[0]
                                  for p, n in enumerate(ns))
        # "_ms" of a launched call: CUDA events around it, so the host's
        # launch work is in it where the device waits on the host;
        # "_graph_ms": the same work replayed from a CUDA graph, device
        # time alone
        times = {
            "walk_dense_trace_graph_ms": graph_ms(lambda: walk(False, True),
                                                  10),
            "walk_compact_trace_graph_ms": graph_ms(lambda: walk(True, True),
                                                    10),
            "walk_dense_no_trace_graph_ms": graph_ms(
                lambda: walk(False, False), 10),
            "walk_compact_no_trace_graph_ms": graph_ms(
                lambda: walk(True, False), 10),
            "walk_dense_trace_ms": cuda_ms(lambda: walk(False, True)),
            "walk_dense_no_trace_ms": cuda_ms(lambda: walk(False, False)),
            "walk_compact_trace_ms": cuda_ms(lambda: walk(True, True)),
            "walk_compact_no_trace_ms": cuda_ms(lambda: walk(True, False)),
            "walk_dense_bound_ms": bound([B] * P, False),
            "walk_compact_bound_ms": bound(survivors, True),
            "engine_run_dense_s": host_s(lambda: eng.run(x), reps=10),
            "engine_run_compact_s": host_s(
                lambda: eng.run(x, options=comp_opt), reps=10),
            "engine_run_dense_no_trace_s": host_s(
                lambda: eng.run(x, with_trace=False), reps=10),
            "engine_run_compact_no_trace_s": host_s(
                lambda: eng.run(x, with_trace=False, options=comp_opt),
                reps=10),
            "run_looped_compact_s": host_s(
                lambda: eng.run_looped(x, options=comp_opt), reps=3),
            "run_looped_dense_s": host_s(lambda: eng.run_looped(x), reps=3),
        }

        # each hop's kernel alone, from the carry the walk hands it: the
        # carry is restored before each call, outside the events
        carry = (torch.zeros(B, dtype=torch.int32, device=card),
                 torch.zeros(B, dtype=torch.bool, device=card),
                 torch.full((B,), -1, dtype=torch.int32, device=card),
                 torch.zeros(B, dtype=torch.int32, device=card),
                 torch.full((B,), -1, dtype=torch.int32, device=card))
        regs = torch.zeros(B, k, device=card)
        hops = []
        for p in range(P):
            kw = {}
            if p:
                rows, n_active = compact_perm(carry[1])
                kw = dict(rows=rows, n_active=n_active)
            saved = tuple(t.clone() for t in carry)
            work = tuple(t.clone() for t in carry)

            def restore():
                for dst, src in zip(work, saved):
                    dst.copy_(src)

            def call():
                eh.engine_hop_kernel(x[:, p], work, dev, p,
                                     n_subtrees=eng.tables.n_subtrees,
                                     regs_out=regs, **kw)

            call_ms = cuda_ms_after(restore, call)
            restore_ms = graph_ms(restore, 20)
            ms = graph_ms(lambda: (restore(), call()), 20) - restore_ms
            hb, ho = hop_bytes(survivors[p], bool(p)), hop_ops(survivors[p])
            b_ms, b_by = bound_ms(hb, ho)
            hops.append({"hop": p, "mode": "survivors" if p else "dense",
                         "survivors": survivors[p], "ms": ms,
                         "call_ms": call_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": hb})
            eh.engine_hop_kernel(x[:, p], carry, dev, p,
                                 n_subtrees=eng.tables.n_subtrees, **kw)
        check(int((~carry[1]).sum()) == survivors[P - 1] - int(
            (exits == P - 1).sum()), f"{profile}: the timed hops' carry")
        out[profile] = {
            "B": B, "P": P, "W": W, "S": S, "k": k,
            "tensor_bytes": x.numel() * 4, "setup_s": setup_s,
            "survivors_entering_hop": survivors,
            "live_fraction": [n / B for n in survivors],
            "exits_at_hop": [int((exits == p).sum()) for p in range(P)],
            "n_unterminated": comp.n_unterminated,
            "hop_launches_compact": hop_launches,
            "survivor_launches_compact": survivor_launches,
            "run_looped_launches": looped,
            "verdicts_equal_predict_and_dense": True,
            "trace_equal_plain_compacted": True, "graph_replay_equal": True,
            "hops": hops, **times}
        del x, dense, comp, plain, eng, carry, regs, work, saved
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, models


def tiled(a: np.ndarray) -> np.ndarray:
    """``a`` tiled along its first axis to B_MAIN rows."""
    reps = -(-B_MAIN // a.shape[0])
    return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:B_MAIN]


def same_verdicts(res, want, what: str) -> None:
    """``res``'s labels, recircs and exit partitions equal ``want``'s
    (an ``EngineResult`` or a (labels, recircs, exit) tuple), int32."""
    if not isinstance(want, (tuple, list)):
        want = (want.labels, want.recircs, want.exit_partition)
    for name, w in zip(("labels", "recircs", "exit_partition"), want):
        got = getattr(res, name)
        check(got.dtype == np.int32 and np.array_equal(got, w),
              f"{what}: {name}")


def stream_phase(card, eng, wp: np.ndarray, x, oracle: tuple,
                 profiles: dict) -> dict:
    """Phase ``stream``: ``run_streaming`` of the main path's 2^20 numpy
    windows on CUDA streams.  Gates, each a raise: at micro-batches of
    4,096, 65,536 and 262,144 flows and ``inflight`` 1, 2 and 3 the
    verdicts equal ``Engine.run`` and the tiled ``pdt.predict``, the hop
    kernel launched P times a chunk and ``stream_chunks_total{backend=
    "cuda"}`` counted every chunk, and the call's peak device memory above
    what the script holds stays below ``Engine.run``'s on the whole
    batch; the same verdicts for a ragged B of 2^20 - 1,000, for
    ``stream_batches`` over 8 uneven batches, on ``make_flow_mesh()``, with
    ``donate=False`` (accepted, not read), and compacted on the front and
    back exit profiles (P - 1 survivor-mode launches a chunk).  Times:
    each call on the host clock after one untimed call of the shape
    (which pins the staging ring; its time is kept as ``first_call_s``),
    flows/s from numpy beside ``Engine.run`` from numpy; per chunk the
    host staging copy, the host's fixed cost of a chunk (a stream of
    ``HOST_CHUNKS`` chunks of ``HOST_CHUNK_FLOWS`` flows, whose device
    work is negligible, over its chunks), the upload (CUDA events), the
    walk and the fetch, their sum over the chunks against the streamed
    time at ``inflight`` 2 (the median of six calls, three in the sweep
    and three beside the parts; the overlap, gated below 1 at every
    micro-batch whose upload outlasts the host's cost of a chunk, the
    card's default among them); a single pinned
    1 GB upload as the link's bound; and ``Engine.run`` from the device
    tensor ``x`` without the trace beside its walk and fetch alone, in
    turns, gated within ``RUN_MARGIN`` (the run adds the survivor counts
    on the device and their record on the host), the walk on the device
    with and without those counts, and ``_record_walk`` alone."""
    import torch

    from repro_torch import obs
    from repro_torch.core.inference import (
        MICRO_BATCH, EngineOptions, _record_walk, fetch, fetch_async,
        partition_walk,
    )
    from repro_torch.kernels import engine_hop as eh
    from repro_torch.launch.mesh import make_flow_mesh
    from repro_torch.obs import MetricRegistry
    from repro_torch.serve import run_streaming, stream_batches

    t_phase = time.perf_counter()
    P, W = eng.tables.n_partitions, wp.shape[2]
    B = wp.shape[0]
    chunk_bytes = lambda mb: mb * P * W * 6 * 4

    def peak_of(fn):
        """(result, seconds, peak device GB above what was held)."""
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return res, dt, (torch.cuda.max_memory_allocated() - held) / 1e9

    ref, run_s, run_peak = peak_of(lambda: eng.run(wp, with_trace=False))
    run_s = statistics.median([run_s] + [peak_of(lambda: eng.run(
        wp, with_trace=False))[1] for _ in range(2)])
    same_verdicts(ref, oracle, "Engine.run == tiled pdt.predict")

    runs, stream2 = [], {}
    for mb in STREAM_MB:
        for inflight in (1, 2, 3):
            opt = EngineOptions(impl="cuda", micro_batch=mb,
                                inflight=inflight)
            # the first call of a shape pins its staging ring (PyTorch's
            # caching host allocator keeps it for the calls after)
            first_s = peak_of(lambda: run_streaming(eng, wp, options=opt))[1]
            reg = MetricRegistry()
            prev = obs.set_registry(reg)
            eh.launches = eh.survivor_launches = 0
            res, dt, peak = peak_of(lambda: run_streaming(eng, wp,
                                                          options=opt))
            launches = eh.launches
            obs.set_registry(prev)
            chunks = -(-B // mb)
            what = f"run_streaming(mb={mb}, inflight={inflight})"
            same_verdicts(res, ref, f"{what} == Engine.run")
            same_verdicts(res, oracle, f"{what} == pdt.predict")
            counted = reg.counter("stream_chunks_total",
                                  labels={"backend": "cuda"}).value
            check(launches == P * chunks and counted == chunks,
                  f"{what}: {P} hop launches and one counted chunk a "
                  f"chunk, got {launches} launches, {counted} chunks for "
                  f"{chunks}")
            check(peak < run_peak, f"{what}: peak {peak} GB below "
                  f"Engine.run's {run_peak} GB")
            if inflight == 2:
                # the overlap gate below reads inflight 2 at every
                # micro-batch: three calls here and three beside the
                # chunk's parts, so neither one slow host staging call nor
                # the host's drift between the two measurements decides it
                stream2[mb] = [dt] + [peak_of(
                    lambda: run_streaming(eng, wp, options=opt))[1]
                    for _ in range(2)]
                dt = statistics.median(stream2[mb])
            runs.append({"micro_batch": mb, "inflight": inflight,
                         "chunks": chunks, "s": dt, "first_call_s": first_s,
                         "flows_per_s": B / dt, "hop_launches": launches,
                         "stream_chunks_total": counted,
                         "peak_above_held_gb": peak,
                         "ring_gb": inflight * chunk_bytes(mb) / 1e9})

    # each chunk's parts alone: the host staging copy into pinned memory,
    # the host's fixed cost of a chunk, the upload on a side stream, the
    # walk and the fetch (CUDA events), against the streamed time at
    # inflight 2
    side = torch.cuda.Stream()
    parts = {}
    tiny = wp[:HOST_CHUNKS * HOST_CHUNK_FLOWS]
    tiny_opt = EngineOptions(impl="cuda", micro_batch=HOST_CHUNK_FLOWS)
    run_streaming(eng, tiny, options=tiny_opt)
    host_ms = statistics.median(
        peak_of(lambda: run_streaming(eng, tiny, options=tiny_opt))[1]
        for _ in range(3)) * 1e3 / HOST_CHUNKS

    for mb in STREAM_MB:
        host = torch.from_numpy(wp[:mb])
        stage = torch.empty(host.shape, pin_memory=True)
        dev_x = torch.empty(host.shape, device=card)
        stage_ms = statistics.median(
            host_s(lambda: stage.copy_(host), reps=1) * 1e3
            for _ in range(7))
        with torch.cuda.stream(side):
            h2d_ms = cuda_ms(lambda: dev_x.copy_(stage, non_blocking=True))
        walk = lambda: partition_walk(
            dev_x, eng.tables.dev, n_subtrees=eng.tables.n_subtrees,
            n_partitions=P, hop=eh.engine_hop_kernel, count_survivors=True)
        walk_ms = cuda_ms(walk)
        buf = walk()
        fetch_ms = cuda_ms(lambda: fetch_async(buf)[0].synchronize())
        chunks = -(-B // mb)
        opt2 = EngineOptions(impl="cuda", micro_batch=mb, inflight=2)
        stream2[mb] += [peak_of(lambda: run_streaming(eng, wp,
                                                      options=opt2))[1]
                        for _ in range(3)]
        streamed = statistics.median(stream2[mb])
        serial_s = chunks * (stage_ms + host_ms + h2d_ms + walk_ms
                             + fetch_ms) / 1e3
        parts[str(mb)] = {"stage_ms": stage_ms, "host_chunk_ms": host_ms,
                          "h2d_ms": h2d_ms, "walk_ms": walk_ms,
                          "fetch_ms": fetch_ms,
                          "chunk_bytes": chunk_bytes(mb),
                          "upload_outlasts_host": h2d_ms > host_ms,
                          "sum_over_chunks_s": serial_s,
                          "streamed_inflight2_s": streamed,
                          "streamed_inflight2_samples_s": stream2[mb],
                          "streamed_over_sum": streamed / serial_s}
        del stage, dev_x, buf
    gated = [mb for mb in STREAM_MB if parts[str(mb)]["upload_outlasts_host"]]
    check(MICRO_BATCH["cuda"] in gated,
          f"the card's default micro-batch uploads for longer than the "
          f"host's fixed cost of a chunk: {parts}")
    for mb in gated:
        check(parts[str(mb)]["streamed_over_sum"] < 1,
              f"micro-batch {mb}: the stream overlaps staging, host work, "
              f"upload, walk and fetch: {parts[str(mb)]}")
    one_gb = torch.empty(1 << 28, pin_memory=True)
    one_gb_dev = torch.empty(1 << 28, device=card)
    link_ms = cuda_ms(lambda: one_gb_dev.copy_(one_gb, non_blocking=True),
                      reps=5)
    link = {"bytes": 1 << 30, "ms": link_ms,
            "gb_per_s": (1 << 30) / link_ms / 1e6,
            "whole_batch_bound_s": wp.nbytes / ((1 << 30) / link_ms * 1e3)}
    del one_gb, one_gb_dev

    # Engine.run from the device, with the survivor counts and their
    # record, against the walk and fetch it wraps, in turns
    walk_kw = dict(n_subtrees=eng.tables.n_subtrees, n_partitions=P,
                   hop=eh.engine_hop_kernel)
    bare = lambda: fetch(partition_walk(x, eng.tables.dev, **walk_kw))
    full_run = lambda: eng.run(x, with_trace=False)
    turns = {"walk_and_fetch_s": [], "engine_run_s": []}
    for fn, key in ((bare, "walk_and_fetch_s"), (full_run, "engine_run_s"),
                    (full_run, "engine_run_s"), (bare, "walk_and_fetch_s")):
        turns[key].append(host_s(fn, reps=10))
    counted = fetch(partition_walk(x, eng.tables.dev, count_survivors=True,
                                   **walk_kw))
    survivors = counted[-P:]
    check(survivors.tolist() == [int(np.count_nonzero(
        (ref.exit_partition < 0) | (ref.exit_partition >= p)))
        for p in range(P)], "the walk's survivor counts")
    record_ms = statistics.median(
        host_s(lambda: _record_walk(survivors, B, compact=False,
                                    compact_floor=128), reps=1) * 1e3
        for _ in range(20))
    from_device = {k: statistics.median(v) for k, v in turns.items()}
    from_device.update(
        turns=turns, record_walk_ms=record_ms,
        walk_ms=cuda_ms(lambda: partition_walk(x, eng.tables.dev,
                                               **walk_kw)),
        walk_counted_ms=cuda_ms(lambda: partition_walk(
            x, eng.tables.dev, count_survivors=True, **walk_kw)),
        margin=RUN_MARGIN)
    check(from_device["engine_run_s"]
          <= RUN_MARGIN * from_device["walk_and_fetch_s"],
          f"Engine.run from the device within {RUN_MARGIN} of its walk and "
          f"fetch: {from_device}")

    checks = {}
    default = EngineOptions(impl="cuda")
    ragged = B - 1000
    res = run_streaming(eng, wp[:ragged], options=default)
    same_verdicts(res, [a[:ragged] for a in oracle], "ragged B")
    checks["ragged_B"] = ragged
    rng = np.random.default_rng(7)
    cuts = np.sort(rng.choice(np.arange(1, B), 7, replace=False))
    cuts = [0, *cuts.tolist(), B]
    outs = list(stream_batches(eng, (wp[a:b] for a, b in zip(cuts, cuts[1:])),
                               options=default))
    for name, want in zip(("labels", "recircs", "exit_partition"), oracle):
        check(np.array_equal(np.concatenate([getattr(o, name)
                                             for o in outs]), want),
              f"stream_batches over 8 batches: {name}")
    checks["stream_batches_sizes"] = np.diff(cuts).tolist()
    mesh = make_flow_mesh()
    check(len(mesh.devices) == torch.cuda.device_count(),
          "make_flow_mesh() takes every visible card")
    res = run_streaming(eng, wp, options=EngineOptions(
        impl="cuda", micro_batch=65536, mesh=mesh))
    same_verdicts(res, oracle, "run_streaming on make_flow_mesh()")
    checks["mesh_devices"] = [str(d) for d in mesh.devices]
    res, dt, peak = peak_of(lambda: run_streaming(
        eng, wp, options=EngineOptions(impl="cuda", donate=False)))
    same_verdicts(res, oracle, "run_streaming(donate=False)")
    checks["donate_false"] = {"s": dt, "peak_above_held_gb": peak}

    compacted = {}
    for profile in ("front", "back"):
        eng_p, wp_p, want = profiles[profile]
        mb = 65536
        dense_opt = EngineOptions(impl="cuda", micro_batch=mb)
        run_streaming(eng_p, wp_p, options=dense_opt)   # pins the ring
        eh.launches = eh.survivor_launches = 0
        res, dt, peak = peak_of(lambda: run_streaming(
            eng_p, wp_p, options=dense_opt.replace(compact=True)))
        launches, survivor_launches = eh.launches, eh.survivor_launches
        chunks = -(-B // mb)
        P_p = eng_p.tables.n_partitions
        same_verdicts(res, want, f"{profile}: compacted stream")
        check(launches == P_p * chunks
              and survivor_launches == (P_p - 1) * chunks,
              f"{profile}: P launches a chunk, P - 1 in survivor mode, got "
              f"{launches}, {survivor_launches} for {chunks} chunks")
        dense_s = peak_of(lambda: run_streaming(eng_p, wp_p,
                                                options=dense_opt))[1]
        compacted[profile] = {"micro_batch": mb, "chunks": chunks,
                              "hop_launches": launches,
                              "survivor_launches": survivor_launches,
                              "s": dt, "dense_s": dense_s,
                              "peak_above_held_gb": peak}
    return {"B": B, "P": P, "W": W, "tensor_bytes": wp.nbytes,
            "engine_run_from_numpy_s": run_s,
            "engine_run_flows_per_s_from_numpy": B / run_s,
            "engine_run_peak_above_held_gb": run_peak,
            "runs": runs, "chunk_parts": parts, "pinned_link": link,
            "engine_run_from_device_no_trace": from_device,
            "checks": checks, "compacted": compacted,
            "verdicts_equal_engine_run_and_predict": True,
            "phase_s": time.perf_counter() - t_phase}


def tune_phase(card, eng, wp: np.ndarray, oracle: tuple, profiles: dict,
               serve_table: tuple) -> dict:
    """Phase ``tune``: ``calibrate`` on the card (its fitted coefficients
    and time), then ``impl="auto"`` and ``"tuned"`` plans at the engine
    shape (``Engine.run`` from numpy) and at each streaming chunk shape
    (``run_streaming``) on the dense model and the three exit-profile
    models, each plan's verdicts equal to the tiled ``pdt.predict``; a
    second ``tuned`` call is a cache hit (``tune_cache_hits_total`` + 1);
    at each of ``ROUTE_SIZES`` flows from numpy, ``impl="auto"``'s pick
    (the committed ``cuda`` row) takes at most ``ROUTE_MARGIN`` of the
    time of ``"tuned"``'s timed winner, both timed in turns, beside the
    pick of the coefficients this run fitted; the tick engine ``FlowTableServer(tick_engine="auto")`` resolves at
    phase ``serve``'s table shape.  The autotune cache is a file under
    ``build/``, removed first."""
    import os

    import torch

    from repro_torch import obs
    from repro_torch.core.inference import EngineOptions
    from repro_torch.serve import FlowTableServer, run_streaming
    from repro_torch.tuning import ShapeInfo, calibrate, choose_plan
    from repro_torch.tuning.autotune import CACHE_ENV, time_plan
    from repro_torch.tuning.costmodel import TERMS

    t_phase = time.perf_counter()
    cache = ROOT / "build" / "autotune_smoke.json"
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.unlink(missing_ok=True)
    os.environ[CACHE_ENV] = str(cache)
    t0 = time.perf_counter()
    coeffs = calibrate(eng, wp, probe_sizes=CALIBRATE_SIZES,
                       repeat=3)
    calibrate_s = time.perf_counter() - t0
    fitted = {b: {t: getattr(c, t) for t in TERMS}
              for b, c in coeffs.items()}
    # printed before any gate of the phase: the fit is the row that
    # tuning.costmodel.DEFAULT_COEFFS["cuda"] commits
    emit("calibrate", s=calibrate_s, probe_sizes=CALIBRATE_SIZES,
         coefficients=fitted)

    def hits():
        return obs.get_registry().counter("tune_cache_hits_total").value

    cases = {"dense": (eng, wp, oracle), **profiles}
    plans = {}
    for name, (e, w, want) in cases.items():
        rows = plans[name] = {}
        for impl in ("auto", "tuned"):
            res = e.run(w, with_trace=False, options=EngineOptions(impl=impl))
            same_verdicts(res, want, f"{name}: Engine.run(impl={impl})")
            rows[f"engine/{impl}"] = res.plan.describe()
            if impl == "tuned":
                before = hits()
                again = e.run(w, with_trace=False,
                              options=EngineOptions(impl=impl))
                same_verdicts(again, want, f"{name}: tuned, again")
                check(hits() == before + 1 and again.plan.source == "cache",
                      f"{name}: the second tuned call is a cache hit")
            for mb in STREAM_MB:
                res = run_streaming(e, w, options=EngineOptions(
                    impl=impl, micro_batch=mb))
                same_verdicts(res, want,
                              f"{name}: run_streaming(impl={impl}, mb={mb})")
                rows[f"stream{mb}/{impl}"] = res.plan.describe()
    del cases

    def same_route(a, b):
        return ((a.backend, a.compact, a.compact_floor)
                == (b.backend, b.compact, b.compact_floor))

    routes = {}
    for n in ROUTE_SIZES:
        w = wp[:n]
        auto = eng.run(w, with_trace=False,
                       options=EngineOptions(impl="auto")).plan
        tuned = eng.run(w, with_trace=False,
                        options=EngineOptions(impl="tuned")).plan
        fitted_pick = choose_plan(ShapeInfo.from_engine(eng, w),
                                  platform="cuda", coeffs=coeffs)
        us = {"auto": [], "tuned": []}
        for _ in range(3):
            for name, plan in (("auto", auto), ("tuned", tuned)):
                us[name].append(time_plan(eng, w, plan, repeat=10))
        auto_us, tuned_us = (statistics.median(us[k])
                             for k in ("auto", "tuned"))
        routes[str(n)] = {"auto": auto.describe(),
                          "tuned": tuned.describe(),
                          "fitted_pick": fitted_pick.describe(),
                          "auto_us": auto_us, "tuned_us": tuned_us,
                          "turns_us": us, "margin": ROUTE_MARGIN}
        check(same_route(auto, tuned) or auto_us <= ROUTE_MARGIN * tuned_us,
              f"{n} flows: impl='auto' picks no slower than 'tuned': "
              f"{routes[str(n)]}")
    srv = FlowTableServer(eng, n_buckets=serve_table[0],
                          bucket_size=serve_table[1])
    tick = {"table_slots": srv.table.capacity, "tick_engine": srv.tick_engine,
            "impl": "cuda" if srv._cuda else "fused"}
    del srv
    torch.cuda.empty_cache()
    return {"calibrate_s": calibrate_s, "probe_sizes": CALIBRATE_SIZES,
            "coefficients": fitted, "plans": plans, "routes": routes,
            "tick_auto": tick,
            "cache_file_entries": len(json.loads(cache.read_text())[
                "entries"]),
            "verdicts_equal_predict": True,
            "phase_s": time.perf_counter() - t_phase}


def window_feature_call(wp, rows) -> tuple:
    """The kernel-A call ``window_features`` makes for the packets ``wp``
    (n, p, W, 6) on the card: one over the n * p windows, under one slot
    row shared by every flow (``rows(1, device)``).  Returns its
    arguments."""
    n, p = wp.shape[:2]
    return (wp.view(n * p, *wp.shape[2:]), *rows(1, wp.device))


def in_slices(fn, args, n: int = 32768):
    """``fn`` (kernel A's plain version) on slices of ``n`` flows of the
    window view ``args[0]`` under the slot rows ``args[1:]`` (shared, or
    sliced with it), concatenated: bounds the plain version's memory."""
    import torch
    B = args[0].shape[0]
    return torch.cat([fn(args[0][lo:lo + n],
                         *(r if r.shape[0] == 1 else r[lo:lo + n]
                           for r in args[1:]))
                      for lo in range(0, B, n)])


def fleet_bound(exit_p: np.ndarray, W: int, engs) -> dict:
    """The least time of one ``fleet_predict`` walk, from this run's
    verdicts: each model's hop ``p`` must read the (W, 6) window and the
    carry (17 bytes a flow, read and written) of the flows still live
    entering it (``exit_partition >= p``, or none taken), and the model's
    own tables once; 3 f32 multiplies and 3 adds a packet and slot of a
    live flow.  The match's compares are left out (they depend on each
    flow's subtree), so the operations are a floor too.  Also the bound
    with each window read once for the whole fleet (a flow live in any
    model at that hop): what a walk with a model axis could reach."""
    M, n = exit_p.shape
    n_bytes = n_ops = carry_tables = 0
    live_any = np.zeros((n,), bool)
    windows_once = 0
    P = max(e.tables.n_partitions for e in engs)
    for p in range(P):
        live_any[:] = False
        for m, e in enumerate(engs):
            if p >= e.tables.n_partitions:
                continue
            live = (exit_p[m] < 0) | (exit_p[m] >= p)
            nl = int(live.sum())
            k = e.tables.dev.slot_op.shape[1]
            n_bytes += nl * W * 6 * 4
            carry_tables += nl * 17 * 2
            n_ops += nl * k * W * 6
            live_any |= live
        windows_once += int(live_any.sum()) * W * 6 * 4
    carry_tables += sum(t.numel() * t.element_size()
                        for e in engs for t in e.tables.dev)
    bound, by = bound_ms(n_bytes + carry_tables, n_ops)
    return {"bound_ms": bound, "bound_by": by,
            "bound_bytes": n_bytes + carry_tables, "bound_ops": n_ops,
            "bound_windows_read_once_ms":
                bound_ms(windows_once + carry_tables, n_ops)[0]}


def fold_table_times(card, tab_args, stream, dev, k: int) -> dict:
    """The fold's table forms timed: at the serving width as the legacy
    tick engine calls them (``feature_update_at`` on pre-gathered rows,
    ``_fold_rank`` on the SID-keyed tables), each one kernel node (gate),
    by graph replay beside the plain version (CUDA events); at
    ``FOLD_ROWS`` rows of a ``FOLD_ROWS + 1``-row table, k of ``dev``,
    from random SIDs, at random and at sorted slots, both forms beside
    their bound; and the floor: one PyTorch op on a one-element tensor,
    graph-replayed (a yardstick, no port).  Every timed call folds its
    own copy of the state in place, over and over: the values drift and
    the times do not depend on them."""
    import torch

    from repro_torch.kernels import feature_window as fw
    from repro_torch.serve.flowtable import _fold_rank

    acc, seen, slots, sid, pkt = (t.clone() for t in tab_args[:5])
    C = slots.shape[0]
    rows = tuple(t[sid.long()] for t in dev[:3])
    at_call = lambda: fw.feature_update_at(acc, seen, slots, pkt, *rows)
    rank_call = lambda: _fold_rank(acc, seen, pkt, sid, slots, dev,
                                   cuda=True)
    nodes = {"feature_update_at": graph_kernel_nodes(at_call),
             "_fold_rank": graph_kernel_nodes(rank_call)}
    check(nodes == {"feature_update_at": 1, "_fold_rank": 1},
          f"the fold as called on a CUDA table: one kernel node, got "
          f"{nodes}")
    serving = {
        "C": C, "kernel_nodes": nodes,
        "feature_update_at_graph_ms": graph_ms(at_call, 200),
        "fold_rank_graph_ms": graph_ms(rank_call, 200),
        "fold_rank_call_ms": cuda_ms(rank_call, reps=50, warmup=5),
        "plain_ms": cuda_ms(lambda: fw.feature_update_table_ref(
            acc, seen, slots, sid, pkt, *dev[:3]), reps=50, warmup=5)}
    # a row reads its packet, slot and SID and its state, and writes its
    # state; the finalize form also writes k registers
    row_bytes = 6 * 4 + 4 + 4 + 2 * k * 8
    serving["bound_ms"], serving["bound_by"] = bound_ms(C * row_bytes,
                                                        5 * C * k)
    n = FOLD_ROWS
    gen = torch.Generator(device=card).manual_seed(0xF01D)
    S = dev.slot_op.shape[0]
    big_sid = torch.randint(0, S, (n,), generator=gen, device=card,
                            dtype=torch.int32)
    big_acc, big_seen = (torch.zeros(n + 1, k, device=card),
                         torch.zeros(n + 1, k, dtype=torch.int32,
                                     device=card))
    big_pkt = torch.from_numpy(stream.pkts[:n]).to(card)
    perm = torch.randperm(n, generator=gen, device=card).to(torch.int32)
    ordered = torch.arange(n, dtype=torch.int32, device=card)
    big = {"rows": n, "k": k}
    for tag, sl in (("random_slots", perm), ("sorted_slots", ordered)):
        fold = lambda: fw.feature_update_table_kernel(
            big_acc, big_seen, sl, big_sid, big_pkt, *dev[:3])
        fin = lambda: fw.feature_update_finalize_table_kernel(
            big_acc, big_seen, sl, big_sid, big_pkt, *dev[:4])
        big[tag] = {"fold_graph_ms": graph_ms(fold, 20),
                    "finalize_graph_ms": graph_ms(fin, 20)}
    big["plain_ms"] = cuda_ms(lambda: fw.feature_update_table_ref(
        big_acc, big_seen, perm, big_sid, big_pkt, *dev[:3]), reps=3,
        warmup=1)
    big["fold_bytes"] = n * row_bytes
    big["fold_bound_ms"], big["fold_bound_by"] = bound_ms(n * row_bytes,
                                                          5 * n * k)
    big["finalize_bytes"] = n * (row_bytes + k * 4)
    big["finalize_bound_ms"], big["finalize_bound_by"] = bound_ms(
        n * (row_bytes + k * 4), 6 * n * k)
    one = torch.zeros(1, device=card)
    return {"serving": serving, "rows_2^20": big,
            "floor_one_op_graph_ms": graph_ms(lambda: one.add_(1.0), 200)}


def kernel_b_deep(card, engs, B: int) -> list:
    """Kernel B's two forms on each engine's own tables (the DSE fleet's
    deep subtrees: the warp match from ``engine_hop.WARP_MATCH_MIN_LEAVES``
    leaves) against their plain versions, ``torch.equal``: ``B`` flows
    with random SIDs over [-1, S) and registers drawn from their
    subtree's thresholds (half of them nudged one ulp up), so marks land
    on every boundary; the block form on blocks of 128 with random
    SIDs.  Returns a row per engine with its shape, its match and the
    share of flows that hit a leaf (gated above 0)."""
    import torch

    from repro_torch.kernels import dt_traverse
    from repro_torch.kernels import engine_hop as eh

    rows = []
    g = torch.Generator(device=card).manual_seed(0xDEE)
    for e in engs:
        dev = e.tables.dev
        S, k, T = dev.thresholds.shape
        L = dev.leaf_lo.shape[1]
        sid = torch.randint(-1, S, (B,), generator=g, device=card,
                            dtype=torch.int32)
        r = torch.where(sid < 0, sid + S, sid).long()
        t = torch.randint(0, T, (B, k), generator=g, device=card)
        j = torch.arange(k, device=card)
        regs = dev.thresholds[r[:, None], j[None, :], t]
        regs = torch.where(torch.isinf(regs), 1e30, regs)
        up = torch.rand(B, k, generator=g, device=card) < 0.5
        regs = torch.where(up, torch.nextafter(regs, torch.full_like(
            regs, float("inf"))), regs).contiguous()
        args = (regs, sid, *dev[4:])
        want = dt_traverse.dt_traverse_flows_ref(*args)
        got = dt_traverse.dt_traverse_flows_kernel(*args)
        bb = 128
        nb = B // bb
        block_sid = torch.randint(0, S, (nb,), generator=g, device=card,
                                  dtype=torch.int32)
        b_args = (block_sid, regs[:nb * bb].contiguous(), *dev[4:])
        got_b = dt_traverse.dt_traverse_kernel(*b_args, block_b=bb)
        want_b = dt_traverse.dt_traverse_blocks_ref(*b_args, block_b=bb)
        torch.cuda.synchronize()
        hit = float((want >= 0).float().mean())
        check(torch.equal(got, want) and torch.equal(got_b, want_b)
              and hit > 0,
              f"kernel B on deep tables (S={S}, k={k}, T={T}, L={L}): "
              f"both forms == plain, hits {hit}")
        rows.append({"S": S, "k": k, "T": T, "L": L, "B": B,
                     "match": ("warp" if L >= eh.WARP_MATCH_MIN_LEAVES
                               else "serial"),
                     "sid_minus_one": int((sid == -1).sum()),
                     "hit_share": hit, "equal": True})
    return rows


def fit_phase(card, ds) -> dict:
    """Phase ``fit``: the trainer and the DSE's batched evaluator on the
    card, on ``ds`` (``make_dataset("d2", SERVE_FLOWS, seed=1)``, which
    ``serve`` streams next) split 70/30.  The counts are zeroed before
    each step and read after it; ``steps_s`` gives each step's seconds.

    Training features: ``window_features(train, 3)`` (kernel A, one
    launch a call; no hop or kernel B launch); that launch against its
    plain version (in slices of windows, which bounds its memory), and
    timed.  For each of ``FIT_CONFIGS``:
    ``train_partitioned_dt(trainer="torch")`` equals ``trainer="numpy"``
    subtree for subtree (gate); the wall time of each trainer (the torch
    one after a traced run of the card's activity alone, which gives its
    device busy time), its host syncs and host seconds per partition, and
    its peak device memory above what was held.

    The deep model ((10, 10, 10) / k = 6): ``Engine.run`` at the test
    split and tiled to B_MAIN equals ``pdt.predict``, one hop launch a
    partition; the hop kernel on its tables against the plain hop on hop
    1 from random SIDs with done flows (dense with and without the
    trace, survivor mode), every carry field, the registers and the
    survivors word; its walk (with the trace, as ``Engine.run`` walks)
    by events and graph replay beside its bound, and at B_MAIN also under
    the serial match, which it does not run.

    The DSE fleet: ``FLEET_BATCH`` configurations drawn from
    ``SearchSpace()`` with ``FLEET_SEED``, on windows of
    ``SearchSpace().max_partitions``.  ``evaluate_batch`` trains them with
    ``trainer="torch"`` and equals the serial evaluator on every config
    (gate); the models it scored are the fleet; kernel B's two forms on
    their tables against the plain versions (``kernel_b_deep``).  Gates:
    ``fleet_predict``
    on the test windows equals each model's ``pdt.predict`` and
    ``Engine.run``, and the same call on CPU tensors (the plain hop); one
    hop-kernel launch a model's partition and none of kernels A and B.
    Times: ``fleet_predict`` (host clock, from numpy and from a device
    tensor), its hop launches (CUDA events; device time by graph replay),
    each model's walk alone by graph replay beside its tables'
    (S, k, T, L), its bound and the flows live
    entering each hop, and the same walks on the plain hop, beside their
    bound, M x
    ``Engine.run`` and M x ``pdt.predict``, at the test split and tiled
    to B_MAIN flows.

    Last, on ``make_dataset("d2", DSE_SMALL)`` (``tests/test_fit.py``'s
    fixture): a seeded ``bayes_search`` with ``trainer="torch"`` and the
    batched evaluator gives the serial numpy history (configs, F1,
    feasibility, best, iterations to best)."""
    import torch

    from repro_torch import fit
    from repro_torch.core import dse
    from repro_torch.core.inference import Engine, partition_walk
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.flows.synthetic import make_dataset
    from repro_torch.flows.windows import (
        _all_feature_rows, window_features, window_packets,
    )
    from repro_torch.kernels import dt_traverse, ref
    from repro_torch.kernels import engine_hop as eh
    from repro_torch.kernels import feature_window as fw
    from repro_torch.kernels.compaction import compact_perm

    def zero_counts():
        fw.launches = dt_traverse.launches = eh.launches = 0

    def counts():
        return {"feature_window": fw.launches,
                "dt_traverse": dt_traverse.launches,
                "engine_hop": eh.launches}

    t_phase = time.perf_counter()
    steps = {}

    def step(name, t0):
        steps[name] = time.perf_counter() - t0

    tr, te = ds.split()
    C = ds.n_classes
    out = {"n_train": tr.n_flows, "n_test": te.n_flows, "steps_s": steps}

    # -- training features on kernel A, checked and timed as launched ----
    t_step = time.perf_counter()
    zero_counts()
    t0 = time.perf_counter()
    Xw_tr = window_features(tr, 3)
    features_s = time.perf_counter() - t0
    feat_launches = counts()
    xtr = torch.from_numpy(window_packets(tr, 3)).to(card)
    a_args = window_feature_call(xtr, _all_feature_rows)
    check(feat_launches == {"feature_window": 1, "dt_traverse": 0,
                            "engine_hop": 0},
          f"window_features: one kernel A launch a call, got "
          f"{feat_launches}")
    a_out = fw.feature_window_kernel(*a_args)
    check(torch.equal(a_out, in_slices(ref.feature_window_ref, a_args)),
          f"kernel A == plain at B={a_args[0].shape[0]}, k=41, one shared "
          f"slot row")
    a_ms = cuda_ms(lambda: fw.feature_window_kernel(*a_args), reps=5)
    a_graph_ms = graph_ms(lambda: fw.feature_window_kernel(*a_args), 1,
                          reps=3)
    a_plain_ms = cuda_ms(lambda: in_slices(ref.feature_window_ref, a_args),
                         reps=2, warmup=1)
    a_bound, a_by = feature_window_bound(3 * tr.n_flows, xtr.shape[2], 41,
                                         shared_rows=True)
    out["kernel_a"] = {
        "shape": f"1 launch of B={a_args[0].shape[0]}, W={xtr.shape[2]}, "
                 f"k=41 ({tr.n_flows} flows x 3 windows), one shared row",
        "window_features_launches": feat_launches["feature_window"],
        "window_features_s": features_s, "ms": a_ms, "graph_ms": a_graph_ms,
        "plain_ms": a_plain_ms, "plain_ms_in": "slices of 32,768 windows",
        "bound_ms": a_bound, "bound_by": a_by, "equal": True}
    del xtr, a_args, a_out
    step("features", t_step)

    # -- the trainers ----------------------------------------------------
    real_forest, real_binning = fit.train_forest, fit.hist.bin_for_growth
    trainers = out["trainers"] = {}
    for sizes, k in FIT_CONFIGS:
        t_step = time.perf_counter()
        kw = dict(partition_sizes=list(sizes), k=k, n_classes=C)
        t0 = time.perf_counter()
        p_np = train_partitioned_dt(Xw_tr, tr.labels, **kw)
        numpy_s = time.perf_counter() - t0
        # the traced run is the torch trainer's warm-up
        prof = profile_run(lambda: train_partitioned_dt(
            Xw_tr, tr.labels, trainer="torch", **kw), warmup=False,
            top=6, card_only=True)
        check(prof["device_busy_ms"] > 0, "the traced trainer ran on the card")
        parts, binning_s = [], [0.0]

        def binning(*args, **kwargs):
            t0 = time.perf_counter()
            edges_binned = real_binning(*args, **kwargs)
            binning_s[0] += time.perf_counter() - t0
            return edges_binned

        def forest(*args, **kwargs):
            syncs, t0 = fit.hist.host_syncs, time.perf_counter()
            trees = real_forest(*args, **kwargs)
            parts.append({"subtrees": len(trees),
                          "host_syncs": fit.hist.host_syncs - syncs,
                          "host_s": time.perf_counter() - t0})
            return trees

        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        fit.train_forest, fit.hist.bin_for_growth = forest, binning
        try:
            t0 = time.perf_counter()
            p_t = train_partitioned_dt(Xw_tr, tr.labels, trainer="torch",
                                       **kw)
            torch_s = time.perf_counter() - t0
        finally:
            fit.train_forest = real_forest
            fit.hist.bin_for_growth = real_binning
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        check(not any(counts().values()), "the grower launches no kernel "
              "of the port's own")
        check(same_models(p_np, p_t), f"{sizes}, k = {k}: torch trainer == "
              f"numpy trainer, subtree for subtree")
        trainers[f"{sizes}/k={k}"] = {
            "subtrees": len(p_t.subtrees),
            "subtrees_per_partition": [len(p_t.sids_in_partition(p))
                                       for p in range(len(sizes))],
            "numpy_s": numpy_s, "torch_s": torch_s,
            "torch_host_binning_s": binning_s[0], "partitions": parts,
            "peak_above_held_gb": peak_gb,
            "profile": prof, "equal_numpy": True}
        step(f"trainers {sizes}/k={k}", t_step)
    names = ("labels", "recircs", "exit_partition")

    # -- Engine.run on the deep model: the hop kernel on deep tables -----
    t_step = time.perf_counter()
    e_deep = Engine.from_model(p_t)              # (10, 10, 10) / k = 6
    x3 = torch.from_numpy(window_packets(te, 3)).to(card)
    reps3 = -(-B_MAIN // x3.shape[0])
    x3_big = x3.repeat(reps3, 1, 1, 1)[:B_MAIN]
    want = p_t.predict(window_features(te, 3), return_trace=True)
    zero_counts()
    run = e_deep.run(x3)
    deep_launches = counts()
    check(deep_launches == {"engine_hop": 3, "feature_window": 0,
                            "dt_traverse": 0},
          f"deep Engine.run: one hop launch a partition, got "
          f"{deep_launches}")
    run_big = e_deep.run(x3_big)
    for name, w in zip(names, want):
        check(np.array_equal(getattr(run, name), w),
              f"deep Engine.run {name} == pdt.predict")
        check(np.array_equal(getattr(run_big, name),
                             np.tile(w, reps3)[:B_MAIN]),
              f"deep Engine.run {name} at B_MAIN == the tiled predict")
    del run, run_big
    # the hop kernel on these tables against its plain versions, on hop 1
    # from random SIDs (-1 among them) with a third of the flows done:
    # dense with the trace, dense without it (done flows not walked, the
    # survivors word counted) and in survivor mode
    dev_d = e_deep.tables.dev
    S_d, k_d, T_d = dev_d.thresholds.shape
    L_d = dev_d.leaf_lo.shape[1]
    n_sub = e_deep.tables.n_subtrees
    gd = torch.Generator(device=card).manual_seed(25)
    Bt = x3.shape[0]
    done0 = torch.rand(Bt, generator=gd, device=card) < 0.3
    carry0 = (torch.randint(-1, S_d, (Bt,), generator=gd, device=card,
                            dtype=torch.int32), done0,
              torch.where(done0, 0, -1).to(torch.int32),
              torch.zeros(Bt, dtype=torch.int32, device=card),
              torch.where(done0, 0, -1).to(torch.int32))
    rows_s, n_s = compact_perm(done0)
    deep_checks = []
    for mode, with_regs in (("dense", True), ("dense", False),
                            ("survivors", True), ("survivors", False)):
        got_c, want_c = (tuple(t.clone() for t in carry0) for _ in range(2))
        regs_k, regs_p = ((torch.full((Bt, k_d), 3.5, device=card)
                           if with_regs else None) for _ in range(2))
        kw = (dict(rows=rows_s, n_active=n_s) if mode == "survivors" else
              {})
        left_k, left_p = ((torch.full((1,), Bt, dtype=torch.int32,
                                      device=card)
                           if mode == "dense" else None) for _ in range(2))
        eh.engine_hop_kernel(x3[:, 1], got_c, dev_d, 1, n_subtrees=n_sub,
                             regs_out=regs_k, survivors_out=left_k, **kw)
        eh.engine_hop_plain(x3[:, 1], want_c, dev_d, 1, n_subtrees=n_sub,
                            regs_out=regs_p, survivors_out=left_p, **kw)
        torch.cuda.synchronize()
        what = f"hop kernel [{mode}, regs {with_regs}, L={L_d}]"
        for name, a, b in zip(("sid", "done", "labels", "recircs",
                               "exit_p"), got_c, want_c):
            check(torch.equal(a, b), f"{what}.{name} == plain")
        check(not with_regs or torch.equal(regs_k, regs_p),
              f"{what}.regs == plain")
        check(left_k is None or torch.equal(left_k, left_p),
              f"{what}.survivors == plain")
        deep_checks.append(what)
    check(bool((carry0[0][~done0] == -1).any()),
          "the deep check reads row S - 1")

    def deep_walk(xx, hop=eh.engine_hop_kernel):
        return partition_walk(xx, dev_d, n_subtrees=n_sub, n_partitions=3,
                              with_trace=True, hop=hop)

    deep = {"S": S_d, "k": k_d, "T": T_d, "L": L_d,
            "match": "warp" if L_d >= eh.WARP_MATCH_MIN_LEAVES else "serial",
            "launches": deep_launches, "checked": deep_checks,
            "equal_predict": True}
    for tag, xx in (("test_split", x3), ("tiled_2^20", x3_big)):
        bound, by = walk_bound(e_deep, xx.shape[0], xx.shape[2])
        deep[tag] = {
            "B": xx.shape[0], "W": xx.shape[2],
            "ms": cuda_ms(lambda: deep_walk(xx), reps=5),
            "graph_ms": graph_ms(lambda: deep_walk(xx), 2, reps=3),
            "bound_ms": bound, "bound_by": by}
    deep["test_split"]["plain_ms"] = cuda_ms(
        lambda: deep_walk(x3, eh.engine_hop_plain), reps=2, warmup=1)
    # the match not run here, the evidence for WARP_MATCH_MIN_LEAVES
    deep["tiled_2^20"]["serial_match_graph_ms"] = under_match(
        "serial", lambda: graph_ms(lambda: deep_walk(x3_big), 2, reps=3))
    out["deep_engine_run"] = deep
    del x3, x3_big, carry0
    step("deep Engine.run", t_step)

    # -- the DSE fleet: evaluate_batch == serial, its models scored ------
    t_step = time.perf_counter()
    space = dse.SearchSpace()
    P = space.max_partitions
    rng = np.random.default_rng(FLEET_SEED)
    cfgs = []
    while len(cfgs) < FLEET_BATCH:
        c = space.sample(rng)
        if c not in cfgs:
            cfgs.append(c)
    zero_counts()
    Xd_tr = window_features(tr, P)
    Xd_te = window_features(te, P)
    check(counts()["feature_window"] == 2,
          "kernel A computes the DSE windows, one launch a call")
    wp = window_packets(te, P)
    step("fleet windows", t_step)

    t_step = time.perf_counter()
    ev = dse.make_splidt_evaluator(Xd_tr, tr.labels, Xd_te, te.labels,
                                   n_classes=C, flows=FLEET_FLOWS,
                                   trainer="torch", win_pkts_te=wp)
    scored, real_fleet = [], fit.batched.fleet_predict

    def fleet_seen(pdts_, *args, **kwargs):
        scored.append(list(pdts_))
        return real_fleet(pdts_, *args, **kwargs)

    zero_counts()
    fit.batched.fleet_predict = fleet_seen
    try:
        t0 = time.perf_counter()
        batch = ev.evaluate_batch(cfgs)
        batch_s = time.perf_counter() - t0
    finally:
        fit.batched.fleet_predict = real_fleet
    batch_launches = counts()
    step("evaluate_batch", t_step)
    t_step = time.perf_counter()
    serial = [ev(c) for c in cfgs]
    serial_s = time.perf_counter() - t_step
    check(batch == serial, "evaluate_batch == the serial evaluator")
    step("serial evaluator", t_step)
    pdts = scored[0]                     # the batch as first trained
    M, B, W = len(pdts), wp.shape[0], wp.shape[2]
    hops = sum(p.n_partitions for p in pdts)
    check(batch_launches["engine_hop"] >= hops
          and batch_launches["feature_window"] == 0,
          f"evaluate_batch walks on the hop kernel, got {batch_launches}")

    t_step = time.perf_counter()
    zero_counts()
    got = fit.fleet_predict(pdts, wp)
    fleet_launches = counts()
    check(fleet_launches == {"engine_hop": hops, "feature_window": 0,
                             "dt_traverse": 0},
          f"fleet_predict: one hop-kernel launch a model's partition "
          f"({hops}) and no kernel A or B, got {fleet_launches}")
    engs = [Engine.from_model(p) for p in pdts]
    for i, (p, eng) in enumerate(zip(pdts, engs)):
        want = p.predict(Xd_te[:, :p.n_partitions], return_trace=True)
        run = eng.run(wp, with_trace=False)
        for name, g, w in zip(names, got, want):
            check(g.dtype == np.int32 and np.array_equal(g[i], w),
                  f"fleet model {i}: {name} == pdt.predict")
            check(np.array_equal(g[i], getattr(run, name)),
                  f"fleet model {i}: {name} == Engine.run")
    t0 = time.perf_counter()
    cpu = fit.fleet_predict(pdts, wp, device="cpu")
    cpu_s = time.perf_counter() - t0
    for name, g, c in zip(names, got, cpu):
        check(np.array_equal(g, c), f"fleet {name}: card == CPU plain hop")
    x = torch.from_numpy(wp).to(card)
    reps = -(-B_MAIN // B)
    x_big = x.repeat(reps, 1, 1, 1)[:B_MAIN]
    Xd_big = np.tile(Xd_te, (reps, 1, 1))[:B_MAIN]
    got_big = fit.fleet_predict(pdts, x_big)
    for name, g, g_big in zip(names, got, got_big):
        check(np.array_equal(g_big, np.tile(g, (1, reps))[:, :B_MAIN]),
              f"fleet {name} at B_MAIN == the tiled test split")
    step("fleet gates", t_step)

    # -- kernel B on the fleet's deep tables ------------------------------
    t_step = time.perf_counter()
    out["kernel_b_deep"] = kernel_b_deep(card, engs, B)
    step("kernel B on deep tables", t_step)

    def walks(xx, hop, engines=None):
        """fleet_predict's hop launches alone: no pack, no fetch."""
        return [partition_walk(xx, e.tables.dev,
                               n_subtrees=e.tables.n_subtrees,
                               n_partitions=e.tables.n_partitions,
                               with_trace=False, hop=hop)
                for e in engines or engs]

    def model_times(xx, exit_p):
        """Each model's walk alone by graph replay beside its tables'
        shape and the flows live entering each of its hops (the flows
        the hop walks)."""
        rows = []
        for m, e in enumerate(engs):
            S_m, k_m, T_m = e.tables.dev.thresholds.shape
            one = lambda: walks(xx, eh.engine_hop_kernel, [e])
            bound, by = walk_bound(e, xx.shape[0], W, exit_p[m],
                                   with_trace=False)
            rows.append({
                "S": S_m, "k": k_m, "T": T_m,
                "L": e.tables.dev.leaf_lo.shape[1],
                "P": e.tables.n_partitions,
                "live": [int(((exit_p[m] < 0) | (exit_p[m] >= p)).sum())
                         for p in range(e.tables.n_partitions)],
                "graph_ms": graph_ms(one, 2, reps=3),
                "bound_ms": bound, "bound_by": by})
        return rows

    def times(xx, Xd, exit_p, reps_, plain_reps):
        return {
            "B": xx.shape[0], "M": M, "hops": hops, "W": W,
            "P": [p.n_partitions for p in pdts],
            "S": [e.tables.n_subtrees for e in engs],
            "k": [e.tables.dev.slot_op.shape[1] for e in engs],
            "T": [e.tables.dev.thresholds.shape[2] for e in engs],
            "L": [e.tables.dev.leaf_lo.shape[1] for e in engs],
            "fleet_predict_from_device_s": host_s(
                lambda: fit.fleet_predict(pdts, xx), reps=reps_),
            "hop_launches_ms": cuda_ms(
                lambda: walks(xx, eh.engine_hop_kernel), reps=reps_),
            "hop_launches_graph_ms": graph_ms(
                lambda: walks(xx, eh.engine_hop_kernel), 2, reps=reps_),
            "models": model_times(xx, exit_p),
            "plain_hops_ms": cuda_ms(
                lambda: walks(xx, eh.engine_hop_plain), reps=plain_reps,
                warmup=plain_reps - 1),
            **fleet_bound(exit_p, W, engs),
            "engine_run_x_M_from_device_s": host_s(
                lambda: [e.run(xx, with_trace=False) for e in engs],
                reps=reps_),
            "predict_x_M_s": host_s(
                lambda: [p.predict(Xd[:, :p.n_partitions],
                                   return_trace=True) for p in pdts],
                reps=1)}

    t_step = time.perf_counter()
    scales = {"test_split": times(x, Xd_te, got[2], 3, 2)}
    ts = scales["test_split"]
    ts["fleet_predict_from_numpy_s"] = host_s(
        lambda: fit.fleet_predict(pdts, wp), reps=3)
    ts["engine_run_x_M_from_numpy_s"] = host_s(
        lambda: [e.run(wp, with_trace=False) for e in engs], reps=3)
    ts["engine_from_model_and_run_x_M_from_device_s"] = host_s(
        lambda: [Engine.from_model(p).run(x, with_trace=False)
                 for p in pdts], reps=3)
    ts["pack_model_fleet_s"] = host_s(lambda: fit.pack_model_fleet(pdts),
                                      reps=1)
    step("fleet times, test split", t_step)
    t_step = time.perf_counter()
    scales["tiled_2^20"] = times(x_big, Xd_big, got_big[2], 2, 1)
    del x_big, Xd_big
    step("fleet times, 2^20", t_step)
    out["fleet"] = {
        "configs": [[c.k, list(c.partition_sizes)] for c in cfgs],
        "subtrees": [len(p.subtrees) for p in pdts],
        "launches": fleet_launches, "cpu_plain_s": cpu_s, "times": scales,
        "equal_predict": True, "equal_engine_run": True, "equal_cpu": True,
        "evaluate_batch": {
            "s": batch_s, "serial_s": serial_s, "launches": batch_launches,
            "feasible": [e.feasible for e in batch],
            "f1": [e.f1 for e in batch], "equal_serial": True}}

    # -- a seeded search: torch and the batched evaluator == numpy ------
    t_step = time.perf_counter()
    small = make_dataset("d2", DSE_SMALL)
    s_tr, s_te = small.split()
    common = (window_features(s_tr, 3), s_tr.labels,
              window_features(s_te, 3), s_te.labels)
    space_s = dse.SearchSpace(max_partitions=3, k_max=4, depth_max=4)
    search = dict(n_iterations=2, batch=3, n_init=4, seed=0)
    kw = dict(n_classes=small.n_classes, flows=FLEET_FLOWS)
    zero_counts()
    t0 = time.perf_counter()
    r_t = dse.bayes_search(dse.make_splidt_evaluator(
        *common, trainer="torch", win_pkts_te=window_packets(s_te, 3),
        **kw), space_s, **search)
    bo_torch_s = time.perf_counter() - t0
    bo_launches = counts()
    t0 = time.perf_counter()
    r_np = dse.bayes_search(dse.make_splidt_evaluator(*common, **kw),
                            space_s, **search)
    bo_numpy_s = time.perf_counter() - t0
    for field in ("config", "f1", "feasible"):
        check([getattr(e, field) for e in r_t.history]
              == [getattr(e, field) for e in r_np.history],
              f"bayes_search torch history == numpy: {field}")
    check(r_t.best.config == r_np.best.config
          and r_t.iterations_to_best == r_np.iterations_to_best,
          "bayes_search torch best == numpy")
    check(bo_launches["engine_hop"] > 0, "the search walks on the hop kernel")
    out["bayes_search"] = {
        "evaluations": len(r_t.history), "torch_batched_s": bo_torch_s,
        "numpy_serial_s": bo_numpy_s, "launches": bo_launches,
        "best": [r_t.best.config.k, list(r_t.best.config.partition_sizes)],
        "best_f1": r_t.best.f1, "iterations_to_best": r_t.iterations_to_best,
        "equal_numpy": True}
    step("bayes_search", t_step)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def system_phase(card) -> dict:
    """Phase ``system``: ``tests/test_system.py``'s path on the card at
    full width, ``make_dataset("d1", SYSTEM_FLOWS)`` split 70/30.

    Features: ``window_features`` at P = 2 and 3 (kernel A, one launch a
    call) and ``full_flow_features`` of both splits (one kernel-A launch
    each, W = the longest flow, k = 41 under one shared slot row).  Models
    (``trainer="torch"`` on the card): ``SYSTEM_MODELS``, the 8-bit one
    on ``quantize_features(., 8)``.  ``Engine.from_model(pdt).run`` of
    the (3, 3, 3) / k = 4 model on the test windows (one hop launch a
    partition), ``best_oneshot_for_flows(style="nb", k_grid=(6,),
    depth_grid=(13,), flows=100_000)`` on the full-flow features,
    ``estimate`` and ``recirc_bandwidth`` for both environments.  Last,
    ``examples/quickstart_torch.main([])`` on the card.  The counts are
    zeroed before the path and read after it.

    Gates (``torch.equal`` / ``np.array_equal``): kernel A's full-flow
    registers == its plain version on the whole of both splits (and ==
    what ``full_flow_features`` returned); the engine's verdicts ==
    ``pdt.predict``; an ``impl="ref"`` engine on the card == the
    ``cuda`` walk, trace included, with no hop launch; the quickstart's
    labels == its ``pdt.predict``, with its launches.  The paper's claims
    are printed, not gated (the CPU tests gate them at
    ``tests/test_system.py``'s sizes).  Kernel A's full-flow launch is
    timed (events, graph replay) beside its plain version and its
    bound."""
    import torch

    from repro_torch.core.baselines import best_oneshot_for_flows
    from repro_torch.core.inference import Engine
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.core.recirc import HADOOP, WEBSERVER, recirc_bandwidth
    from repro_torch.core.resources import estimate
    from repro_torch.core.tree import macro_f1
    from repro_torch.flows.synthetic import make_dataset
    from repro_torch.flows.windows import (
        _all_feature_rows, full_flow_features, quantize_features,
        window_features, window_packets,
    )
    from repro_torch.kernels import dt_traverse, ref
    from repro_torch.kernels import engine_hop as eh
    from repro_torch.kernels import feature_window as fw

    def zero_counts():
        fw.launches = dt_traverse.launches = eh.launches = 0

    def counts():
        return {"feature_window": fw.launches,
                "dt_traverse": dt_traverse.launches,
                "engine_hop": eh.launches}

    t_phase = time.perf_counter()
    steps = {}

    def step(name, t0):
        steps[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ds = make_dataset("d1", SYSTEM_FLOWS)
    tr, te = ds.split()
    C = ds.n_classes
    step("dataset", t0)
    out = {"flows": SYSTEM_FLOWS, "n_train": tr.n_flows,
           "n_test": te.n_flows, "n_classes": C, "steps_s": steps}

    # -- the path, counted from zero ---------------------------------------
    t0 = time.perf_counter()
    zero_counts()
    Xw2_tr, Xw2_te = window_features(tr, 2), window_features(te, 2)
    Xw3_tr, Xw3_te = window_features(tr, 3), window_features(te, 3)
    Xf_tr, Xf_te = full_flow_features(tr), full_flow_features(te)
    feat_launches = counts()
    check(feat_launches == {"feature_window": 6, "dt_traverse": 0,
                            "engine_hop": 0},
          f"system features: one kernel-A launch a call, got "
          f"{feat_launches}")
    step("features", t0)

    t0 = time.perf_counter()
    models, fit_s = {}, {}
    inputs = {"splidt": Xw2_tr, "scaling": Xw3_tr, "engine": Xw3_tr,
              "f32": Xw2_tr, "f8": quantize_features(Xw2_tr, 8)}
    for name, (sizes, kk) in SYSTEM_MODELS.items():
        t1 = time.perf_counter()
        models[name] = train_partitioned_dt(
            inputs[name], tr.labels, partition_sizes=list(sizes), k=kk, n_classes=C,
            trainer="torch", device=card)
        fit_s[name] = time.perf_counter() - t1
    step("train", t0)

    t0 = time.perf_counter()
    pdt = models["engine"]
    wp_te = window_packets(te, 3)
    eng = Engine.from_model(pdt)
    before = counts()
    res = eng.run(wp_te)
    run_launches = {k: counts()[k] - before[k] for k in before}
    check(run_launches == {"feature_window": 0, "dt_traverse": 0,
                           "engine_hop": 3},
          f"system Engine.run: one hop launch a partition, got "
          f"{run_launches}")
    path_launches = counts()
    want = pdt.predict(Xw3_te, return_trace=True)
    for name, w in zip(("labels", "recircs", "exit_partition"), want):
        check(np.array_equal(getattr(res, name), w),
              f"system Engine.run {name} == pdt.predict")
    zero_counts()
    res_ref = Engine.from_model(pdt, impl="ref").run(wp_te)
    check(counts()["engine_hop"] == 0,
          "an impl='ref' engine walks the plain hop")
    for name in ("labels", "recircs", "exit_partition"):
        check(np.array_equal(getattr(res_ref, name), getattr(res, name)),
              f"impl='ref' engine == the cuda walk: {name}")
    for p, (a, b) in enumerate(zip(res_ref.regs_trace, res.regs_trace)):
        check(np.array_equal(a.view(np.int32), b.view(np.int32)),
              f"impl='ref' engine == the cuda walk: regs hop {p}")
    step("engine", t0)

    # -- the claims (printed) ------------------------------------------------
    t0 = time.perf_counter()
    f1_splidt = macro_f1(te.labels, models["splidt"].predict(Xw2_te), C)
    _, f1_topk = best_oneshot_for_flows(
        Xf_tr, tr.labels, Xf_te, te.labels, flows=100_000, style="nb",
        n_classes=C, k_grid=(6,), depth_grid=(13,))
    step("baseline", t0)
    t0 = time.perf_counter()
    scaling = models["scaling"]
    f32 = macro_f1(te.labels, models["f32"].predict(Xw2_te), C)
    f8 = macro_f1(te.labels, models["f8"].predict(
        quantize_features(Xw2_te, 8)), C)
    c32 = estimate(models["f32"], bits=32).flow_capacity
    c8 = estimate(models["f8"], bits=8).flow_capacity
    rep = estimate(pdt, flows=100_000)
    recirc = {env.name: recirc_bandwidth(res.recircs, 1_000_000,
                                         env).fraction_of_budget
              for env in (WEBSERVER, HADOOP)}
    out["claims"] = {
        "splidt_f1": f1_splidt, "topk_f1": f1_topk,
        "splidt_beats_topk": f1_splidt > f1_topk,
        "unique_features": len(scaling.unique_features()), "k": 6,
        "unique_over_k": len(scaling.unique_features()) / 6,
        "max_features_per_subtree": scaling.max_features_per_subtree(),
        "engine_f1": macro_f1(te.labels, res.labels, C),
        "recirc_fraction": recirc,
        "recirc_under_0.05%": all(v < 5e-4 for v in recirc.values()),
        "feasible_at_100k": rep.feasible,
        "f8": f8, "f32": f32, "f8_over_f32": f8 / f32,
        "c8": c8, "c32": c32, "c8_over_c32": c8 / c32,
        "feature_density": models["splidt"].feature_density(),
        "total_depth": {n: m.total_depth for n, m in models.items()}}
    out["fit_s"] = fit_s
    step("reports", t0)

    # -- kernel A at the full-flow shape: gate and times ----------------------
    t0 = time.perf_counter()
    kernel_a = {}
    for split, d, Xf in (("train", tr, Xf_tr), ("test", te, Xf_te)):
        x = torch.from_numpy(window_packets(d, 1)).to(card)
        args = window_feature_call(x, _all_feature_rows)
        got = fw.feature_window_kernel(*args)
        check(torch.equal(got, in_slices(ref.feature_window_ref, args)),
              f"kernel A full flow == plain on the {split} split "
              f"(B={x.shape[0]}, W={x.shape[2]}, k=41, one shared row)")
        check(np.array_equal(got.cpu().numpy().view(np.int32),
                             Xf.view(np.int32)),
              f"full_flow_features({split}) == kernel A's registers")
        bound, by = feature_window_bound(x.shape[0], x.shape[2], 41,
                                         shared_rows=True)
        kernel_a[split] = {
            "shape": f"1 launch of B={x.shape[0]}, W={x.shape[2]}, k=41, "
                     "one shared row",
            "ms": cuda_ms(lambda: fw.feature_window_kernel(*args), reps=5),
            "graph_ms": graph_ms(lambda: fw.feature_window_kernel(*args), 1,
                                 reps=3),
            "plain_ms": cuda_ms(lambda: in_slices(ref.feature_window_ref,
                                                  args), reps=2, warmup=1),
            "plain_ms_in": "slices of 32,768 windows",
            "bound_ms": bound, "bound_by": by, "equal": True,
            "mean_packets": float(d.lengths.mean())}
        del x, args, got
    torch.cuda.empty_cache()
    out["kernel_a_full_flow"] = kernel_a
    step("kernel_a", t0)

    # -- the quickstart example on the card ----------------------------------
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "examples"))
    import quickstart_torch
    zero_counts()
    q = quickstart_torch.main([])
    q_launches = counts()
    check(q["device"].startswith("cuda"), "the quickstart ran on the card")
    check(q_launches == {"feature_window": 1, "dt_traverse": 0,
                         "engine_hop": 3},
          f"quickstart: one kernel-A launch and one hop launch a "
          f"partition, got {q_launches}")
    q_want = q["pdt"].predict(window_features(q["test"], 3),
                              return_trace=True)
    for name, w in zip(("labels", "recircs", "exit_partition"), q_want):
        check(np.array_equal(q[name], w),
              f"quickstart engine {name} == its pdt.predict")
    out["quickstart"] = {k: q[k] for k in (
        "f1", "mean_recircs", "unique_features", "total_depth",
        "tcam_entries", "recirc_fraction")}
    out["quickstart"]["launches"] = q_launches
    step("quickstart", t0)
    out["launches"] = path_launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.features import PKT_IAT, PKT_SIZE, PKT_TS
    from repro_torch.core.inference import (
        Engine, EngineOptions, WalkBackend, fetch, partition_walk,
    )
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.core.tree import macro_f1
    from repro_torch.flows.synthetic import (
        FlowDataset, make_dataset, make_packet_stream,
    )
    from repro_torch.flows.windows import (
        _all_feature_rows, window_features, window_packets,
    )
    from repro_torch.kernels import _build, dispatch, dt_traverse, ops, ref
    from repro_torch.kernels import engine_hop as eh
    from repro_torch.kernels import feature_window as fw
    from repro_torch.kernels import tick_step as tk
    from repro_torch.kernels.compaction import compact_perm
    from repro_torch.kernels.engine_hop import step_hop
    from repro_torch.obs import reset_spans, span_totals
    from repro_torch.serve import FlowTableServer, StreamVerdicts

    card = torch.device("cuda")
    smi = nvidia_smi()

    # -- 1. device and build ------------------------------------------------
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    for src in _build.SOURCES:
        _build.load(src)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for src in _build.SOURCES
             for ln in (out_dir / f"{pathlib.Path(src).stem}.log")
             .read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s, ptxas=ptxas,
         resources={stem: kernel_resources(out_dir, stem) for stem in (
             "engine_hop", "feature_window", "tick_step")})

    # -- 2. the main path, through the public entry points ------------------
    fw.launches = dt_traverse.launches = eh.launches = 0
    t0 = time.perf_counter()
    ds = make_dataset("d2", 6000)
    tr, te = ds.split()
    Xw = window_features(tr, 3)                         # kernel A, k = 41
    pdt = train_partitioned_dt(Xw, tr.labels, partition_sizes=[3, 3, 3],
                               k=4)
    wp_te = window_packets(te, 3)
    reps = -(-B_MAIN // wp_te.shape[0])
    wp = np.tile(wp_te, (reps, 1, 1, 1))[:B_MAIN]
    setup_s = time.perf_counter() - t0
    eng = Engine.from_model(pdt)
    fw_setup = fw.launches
    check(fw_setup == 1, f"window_features: one kernel-A launch a call, "
          f"got {fw_setup}")
    t0 = time.perf_counter()
    res = eng.run(wp)                                   # the hop kernel
    run_s = time.perf_counter() - t0
    launches = {"engine_hop": eh.launches, "feature_window": fw.launches,
                "dt_traverse": dt_traverse.launches}
    run_launches = {"engine_hop": eh.launches,
                    "feature_window": fw.launches - fw_setup,
                    "dt_traverse": dt_traverse.launches}
    S, k, T = eng.tables.dev.thresholds.shape
    L = eng.tables.dev.leaf_lo.shape[1]
    P, W = wp.shape[1], wp.shape[2]
    # the oracle sees features from the plain version, not from kernel A
    Xw_te = window_features(te, 3, device="cpu")
    labels, recircs, exit_p = pdt.predict(Xw_te, return_trace=True)
    fw_before = fw.launches
    check(np.array_equal(window_features(te, 3).view(np.int32),
                         Xw_te.view(np.int32))
          and fw.launches == fw_before + 1,
          "window_features on the card == on the CPU, one kernel-A launch")
    tile = lambda a: np.tile(a, reps)[:B_MAIN]
    main_oracle = (tile(labels), tile(recircs), tile(exit_p))
    for name, want in (("labels", labels), ("recircs", recircs),
                       ("exit_partition", exit_p)):
        got = getattr(res, name)
        check(got.shape == (B_MAIN,) and got.dtype == np.int32, name)
        check(np.array_equal(got, tile(want)), f"{name} == numpy oracle")
    check(len(res.regs_trace) == P and all(
        r.shape == (B_MAIN, k) and np.isfinite(r).all()
        for r in res.regs_trace), "register trace shape and finiteness")
    check(run_launches == {"engine_hop": P, "feature_window": 0,
                           "dt_traverse": 0},
          f"one hop-kernel launch per hop and no launch of kernel A or B, "
          f"got {run_launches}")
    f1 = macro_f1(tile(te.labels), res.labels, ds.n_classes)
    emit("main", n_train=tr.n_flows, n_test=te.n_flows, B=B_MAIN, P=P, W=W,
         S=S, k=k, T=T, L=L, launches=launches,
         window_features_launches=fw_setup,
         engine_run_launches=run_launches, macro_f1=f1,
         mean_recircs=float(res.recircs.mean()),
         n_unterminated=res.n_unterminated, setup_s=setup_s,
         first_run_s=run_s, verdicts_equal_oracle=True)

    # -- 3. kernels vs plain versions on the card, main-path shapes ---------
    x = torch.from_numpy(wp).to(card)                   # (B, P, W, 6)
    g = torch.Generator(device=card).manual_seed(0)
    sid = torch.randint(0, S, (B_MAIN,), generator=g, device=card,
                        dtype=torch.int32)
    dev = eng.tables.dev
    rows = [t[sid.long()] for t in dev[:4]]
    checks = {}

    def compare(name, got, want, log=None, nan_equal=False):
        """``torch.equal``; with ``nan_equal`` a NaN equals a NaN of any
        payload (the fold's state may hold NaN)."""
        torch.cuda.synchronize()
        same = got == want
        if nan_equal:
            same = same | (got.isnan() & want.isnan())
        equal = got.shape == want.shape and bool(same.all())
        # equal elements count 0, so matching infinities do not give NaN
        diff = torch.where(same, 0.0, (got.double() - want.double()).abs())
        err = float(diff.max()) if got.numel() else 0.0
        (checks if log is None else log)[name] = {"equal": equal,
                                                  "max_abs_err": err}
        check(equal, f"{name}: kernel == plain version")
        return err

    a_args = (x[:, 1], *rows)                           # a strided hop view
    err_a = compare("feature_window[B=2^20,W=65,k=4]",
                    fw.feature_window_kernel(*a_args),
                    ref.feature_window_ref(*a_args))
    xtr = torch.from_numpy(window_packets(tr, 3)).to(card)
    # kernel A's call in window_features of the training split
    a41_args = window_feature_call(xtr, _all_feature_rows)
    err_a = max(err_a, compare(
        f"feature_window[B={a41_args[0].shape[0]},W={xtr.shape[2]},k=41,"
        f"one shared row]", fw.feature_window_kernel(*a41_args),
        ref.feature_window_ref(*a41_args)))

    regs = fw.feature_window_kernel(*a_args)
    bb = 128
    d = dispatch.sid_dispatch(sid, n_subtrees=S, block_b=bb)
    regs_g = regs.new_zeros((d.block_sid.shape[0] * bb, k))
    regs_g[d.dest.long()] = regs[d.order.long()]
    b_args = (d.block_sid, regs_g, *dev[4:])
    err_b = compare("dt_traverse[blocks]",
                    dt_traverse.dt_traverse_kernel(*b_args, block_b=bb),
                    dt_traverse.dt_traverse_blocks_ref(*b_args, block_b=bb))
    s = sid.long()
    err_b = max(err_b, compare(
        f"dt_traverse[dispatch,S={S},k={k},T={T},L={L},bb={bb}]",
        dispatch.dispatch_dt_traverse(regs, sid, *dev[4:], block_b=bb),
        ref.dt_traverse_ref(regs, dev.thresholds[s], dev.leaf_lo[s],
                            dev.leaf_hi[s], dev.leaf_action[s],
                            dev.leaf_valid[s] > 0)))
    # kernel B's per-flow form (each flow its own subtree, no grouping)
    # from random SIDs, -1 among them (row S - 1); dispatch_dt_traverse
    # as called is one launch of it
    g_b = torch.Generator(device=card).manual_seed(0xB)
    sid_b = torch.randint(-1, S, (B_MAIN,), generator=g_b, device=card,
                          dtype=torch.int32)
    flow_args = (regs, sid_b, *dev[4:])
    want_flows = dt_traverse.dt_traverse_flows_ref(*flow_args)
    err_b = max(err_b, compare(
        f"dt_traverse[flows,S={S},k={k},T={T},L={L},SID -1]",
        dt_traverse.dt_traverse_flows_kernel(*flow_args), want_flows))
    n_b = dt_traverse.launches
    err_b = max(err_b, compare(
        "dt_traverse[dispatch as called,SID -1]",
        dispatch.dispatch_dt_traverse(regs, sid_b, *dev[4:], block_b=bb),
        want_flows))
    check(dt_traverse.launches == n_b + 1
          and int((sid_b == -1).sum()) > 0
          and int((want_flows >= 0).sum()) > 0,
          "dispatch_dt_traverse: one launch of the per-flow form, SIDs of "
          "-1 among the flows, some leaf hit")

    # the hop kernel against engine_hop_ref on every hop of a walk from
    # random SIDs (-1 among them) with a third of the flows done; the
    # kernel updates its copy of the carry in place
    n_sub = eng.tables.n_subtrees
    done0 = torch.rand(B_MAIN, generator=g, device=card) < 0.3
    carry0 = (torch.randint(-1, S, (B_MAIN,), generator=g, device=card,
                            dtype=torch.int32), done0,
              torch.where(done0, 0, -1).to(torch.int32),
              torch.zeros(B_MAIN, dtype=torch.int32, device=card),
              torch.where(done0, 0, -1).to(torch.int32))
    got_c, want_c = tuple(t.clone() for t in carry0), carry0
    err_hop = 0.0
    for p in range(P):
        regs_k = torch.empty(B_MAIN, k, device=card)
        eh.engine_hop_kernel(x[:, p], got_c, dev, p, n_subtrees=n_sub,
                             regs_out=regs_k)
        want_c, regs_w = ref.engine_hop_ref(x[:, p], want_c, dev, p, n_sub)
        err_hop = max(err_hop, compare(f"engine_hop[hop {p}].regs", regs_k,
                                       regs_w))
        for name, a, b in zip(("sid", "done", "labels", "recircs",
                               "exit_p"), got_c, want_c):
            compare(f"engine_hop[hop {p}].{name}", a, b)
    hop_walk = {"sid_minus_one": int((carry0[0] == -1).sum()),
                "done_before": int(done0.sum()),
                "done_after": int(want_c[1].sum()),
                "recirculations": int(want_c[3].sum())}
    check(hop_walk["sid_minus_one"] > 0
          and hop_walk["done_after"] > hop_walk["done_before"],
          f"the checked walk reads row S - 1 and exits flows: {hop_walk}")

    # the hop kernel's survivor mode on a random survivor subset (SID -1
    # among the survivors): the kernel in place on one copy of the carry,
    # the plain compacted hop on another, engine_hop_ref on every flow
    # for the survivors' rows; done flows keep their carry and their
    # register rows, which start at a fill no hop writes
    fill = 3.5
    rows_s, n_s = compact_perm(done0)
    got_s, plain_s = (tuple(t.clone() for t in carry0) for _ in range(2))
    regs_s = torch.full((B_MAIN, k), fill, device=card)
    regs_sp = torch.full((B_MAIN, k), fill, device=card)
    eh.engine_hop_kernel(x[:, 1], got_s, dev, 1, n_subtrees=n_sub,
                         regs_out=regs_s, rows=rows_s, n_active=n_s)
    eh.engine_hop_plain(x[:, 1], plain_s, dev, 1, n_subtrees=n_sub,
                        regs_out=regs_sp, rows=rows_s, n_active=n_s)
    dense_s, regs_sd = ref.engine_hop_ref(x[:, 1], carry0, dev, 1, n_sub)
    live0 = ~done0
    err_hop = max(err_hop, compare("engine_hop[survivors].regs", regs_s,
                                   regs_sp))
    compare("engine_hop[survivors].regs == dense on survivors",
            regs_s[live0], regs_sd[live0])
    compare("engine_hop[survivors].regs of done flows", regs_s[done0],
            torch.full_like(regs_s[done0], fill))
    carry_names = ("sid", "done", "labels", "recircs", "exit_p")
    for name, a, b, c in zip(carry_names, got_s, plain_s, dense_s):
        compare(f"engine_hop[survivors].{name}", a, b)
        compare(f"engine_hop[survivors].{name} == dense", a, c)
    # survivor inputs out of range: a count above B reads as B (every
    # position holds a flow, done ones too) and a row outside [0, B)
    # leaves its position empty; the named flows get the dense hop, the
    # dropped ones keep their carry and the fill
    dropped = torch.randperm(B_MAIN, generator=g, device=card)[:1000]
    rows_b = rows_s.clone()
    rows_b[dropped[:500]] = -7
    rows_b[dropped[500:]] = B_MAIN + 3
    named = torch.ones(B_MAIN, dtype=torch.bool, device=card)
    named[rows_s[dropped].long()] = False
    got_b = tuple(t.clone() for t in carry0)
    regs_b = torch.full((B_MAIN, k), fill, device=card)
    eh.engine_hop_kernel(
        x[:, 1], got_b, dev, 1, n_subtrees=n_sub, regs_out=regs_b,
        rows=rows_b, n_active=torch.full((1,), B_MAIN + 100,
                                         dtype=torch.int32, device=card))
    compare("engine_hop[rows out of range].regs of named flows",
            regs_b[named], regs_sd[named])
    compare("engine_hop[rows out of range].regs of dropped flows",
            regs_b[~named], torch.full_like(regs_b[~named], fill))
    for name, a, c, o in zip(carry_names, got_b, dense_s, carry0):
        compare(f"engine_hop[rows out of range].{name}", a,
                torch.where(named, c, o))
    survivor_check = {"survivors": int(n_s),
                      "sid_minus_one_among_them": int(
                          (carry0[0][live0] == -1).sum())}
    check(survivor_check["sid_minus_one_among_them"] > 0,
          f"the survivors read row S - 1: {survivor_check}")

    # subnormal packet fields (ROADMAP C.2): kernel A over every registry
    # feature and the hop kernel keep them exactly as their plain versions
    # do, so no flush-to-zero build flag can slip in unseen
    gs = torch.Generator().manual_seed(0xC2)
    sub_vals = torch.tensor([1e-40, -2e-40, 3e-41, -1e-45, 1.17e-38, -0.0])
    n_tile = 1 << 16
    x_sub = x[:n_tile].clone()
    for fld in (PKT_TS, PKT_SIZE, PKT_IAT):
        x_sub[..., fld] = sub_vals[torch.randint(
            0, sub_vals.numel(), x_sub.shape[:3], generator=gs)].to(card)
    sub41 = (x_sub[:, 0], *_all_feature_rows(1, card))
    regs41 = fw.feature_window_kernel(*sub41)
    err_a = max(err_a, compare("feature_window[subnormal,k=41]", regs41,
                               ref.feature_window_ref(*sub41)))
    tiny = regs41.abs()
    check(bool(((tiny > 0) & (tiny < torch.finfo(torch.float32).tiny))
               .any()), "subnormal registers survive kernel A")
    sub_c = tuple(t[:n_tile].clone() for t in carry0)
    sub_w = tuple(t[:n_tile] for t in carry0)
    regs_k = torch.empty(n_tile, k, device=card)
    eh.engine_hop_kernel(x_sub[:, 1], sub_c, dev, 1, n_subtrees=n_sub,
                         regs_out=regs_k)
    sub_w, regs_w = ref.engine_hop_ref(x_sub[:, 1], sub_w, dev, 1, n_sub)
    err_hop = max(err_hop, compare("engine_hop[subnormal].regs", regs_k,
                                   regs_w))
    for name, a, b in zip(("sid", "done", "labels", "recircs", "exit_p"),
                          sub_c, sub_w):
        compare(f"engine_hop[subnormal].{name}", a, b)
    del x_sub, regs41

    fused = eng.run(x, options=EngineOptions(impl="fused"))
    cuda = eng.run(x, options=EngineOptions(impl="cuda"))
    for name in ("labels", "recircs", "exit_partition"):
        check(np.array_equal(getattr(cuda, name), getattr(fused, name)),
              f"engine cuda == fused: {name}")
    for p, (a, b) in enumerate(zip(cuda.regs_trace, fused.regs_trace)):
        check(np.array_equal(a, b), f"engine cuda == fused: regs hop {p}")
    checks["engine[cuda==fused,B=2^20]"] = {"equal": True,
                                             "max_abs_err": 0.0}
    emit("check", tolerance="zero: torch.equal", comparisons=checks,
         hop_walk=hop_walk, survivor_mode=survivor_check,
         subnormal_tile={"flows": n_tile, "values": sub_vals.tolist()})

    # -- 4. times -------------------------------------------------------------
    ms_a = cuda_ms(lambda: fw.feature_window_kernel(*a_args))
    plain_a = cuda_ms(lambda: ref.feature_window_ref(*a_args))
    ms_a41 = cuda_ms(lambda: fw.feature_window_kernel(*a41_args))
    graph_a41 = graph_ms(lambda: fw.feature_window_kernel(*a41_args), 5)
    plain_a41 = cuda_ms(lambda: ref.feature_window_ref(*a41_args))
    ms_b = cuda_ms(lambda: dt_traverse.dt_traverse_kernel(*b_args,
                                                          block_b=bb))
    plain_b = cuda_ms(lambda: dt_traverse.dt_traverse_blocks_ref(
        *b_args, block_b=bb))
    ms_dispatch = cuda_ms(lambda: dispatch.dispatch_dt_traverse(
        regs, sid, *dev[4:], block_b=bb))
    # both forms and the dispatch as called, by graph replay; the call is
    # one kernel node
    flows_call = lambda: dt_traverse.dt_traverse_flows_kernel(*flow_args)
    disp_call = lambda: dispatch.dispatch_dt_traverse(regs, sid_b, *dev[4:],
                                                      block_b=bb)
    ms_flows = cuda_ms(flows_call)
    graph_flows = graph_ms(flows_call, 20)
    graph_b = graph_ms(lambda: dt_traverse.dt_traverse_kernel(
        *b_args, block_b=bb), 20)
    graph_dispatch = graph_ms(disp_call, 20)
    dispatch_nodes = graph_kernel_nodes(disp_call)
    check(dispatch_nodes == 1, f"dispatch_dt_traverse on a CUDA tensor: "
          f"one kernel node, got {dispatch_nodes}")
    plain_flows = cuda_ms(lambda: dt_traverse.dt_traverse_flows_ref(
        *flow_args))

    bound_a, by_a = feature_window_bound(B_MAIN, W, k)
    bound_a41, by_a41 = feature_window_bound(3 * tr.n_flows, xtr.shape[2],
                                             41, shared_rows=True)

    # the hop kernel at hop 1 of the main path, writing its trace row; the
    # carry is restored from carry0 before each call, outside the events
    work_c = tuple(t.clone() for t in carry0)
    regs_h = torch.empty(B_MAIN, k, device=card)

    def restore_carry():
        for dst, src in zip(work_c, carry0):
            dst.copy_(src)

    def hop_call():
        eh.engine_hop_kernel(x[:, 1], work_c, dev, 1, n_subtrees=n_sub,
                             regs_out=regs_h)

    ms_hop = cuda_ms_after(restore_carry, hop_call)
    # device time alone: restore-and-call replayed from a CUDA graph, less
    # the restore (CUDA events around a launched call also hold the host's
    # launch work while the device waits on it); then once under the warp
    # match, which WARP_MATCH_MIN_LEAVES does not pick at this L
    restore_carry_ms = graph_ms(restore_carry, 20)
    hop_graph = lambda: graph_ms(lambda: (restore_carry(), hop_call()),
                                 20) - restore_carry_ms
    graph_hop = hop_graph()
    graph_hop_warp = under_match("warp", hop_graph)
    graph_a = graph_ms(lambda: fw.feature_window_kernel(*a_args), 20)
    # a yardstick, no port of anything: one PyTorch reduction that reads
    # the same strided hop view once (what the view's layout lets a read
    # reach on this card)
    view_read_ms = cuda_ms(lambda: x[:, 1].sum())
    plain_hop = cuda_ms(lambda: ref.engine_hop_ref(x[:, 1], carry0, dev, 1,
                                                   n_sub))
    # least traffic: the windows, the carry (sid, done, labels, recircs,
    # exit_p: 17 bytes a flow) read once and written once, the registers
    # written, the tables read; operations: the window walk's 3 f32
    # multiplies and 3 adds a packet and slot, and the match's k*T + 2*L*k
    # compares a flow
    table_bytes = sum(t.numel() * t.element_size() for t in dev)
    hop_bytes = (B_MAIN * W * 6 * 4 + B_MAIN * 17 * 2 + B_MAIN * k * 4
                 + table_bytes)
    hop_ops = B_MAIN * k * W * 6 + B_MAIN * (k * T + 2 * L * k)
    bound_hop, by_hop = bound_ms(hop_bytes, hop_ops)
    nb = d.block_sid.shape[0]
    b_bytes = (nb * 4 + nb * bb * k * 4 + nb * bb * 4
               + sum(t.numel() * 4 for t in dev[4:]))
    bound_b, by_b = bound_ms(b_bytes, nb * bb * (k * T + 2 * L * k))
    # the per-flow form: registers and SIDs read, actions written, the
    # tables read once
    flows_bytes = (B_MAIN * k * 4 + B_MAIN * 4 * 2
                   + sum(t.numel() * 4 for t in dev[4:]))
    bound_flows, by_flows = bound_ms(flows_bytes,
                                     B_MAIN * (k * T + 2 * L * k))

    # the run's own peak: what it allocates above the tensors held here
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run_np_s = host_s(lambda: eng.run(wp), reps=3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    run_dev_s = host_s(lambda: eng.run(x), reps=10)
    run_dev_notrace_s = host_s(lambda: eng.run(x, with_trace=False),
                               reps=10)
    run_fused_s = host_s(lambda: eng.run(
        x, options=EngineOptions(impl="fused")), reps=3)
    # the two-kernel walk the hop kernel replaced (kernel A on SID-gathered
    # slot rows, the SID dispatch, kernel B, then the bookkeeping), behind
    # the same fetch; then each walk on the device alone and the fetch
    two_kernel = WalkBackend(name="two-kernel",
                             hop=step_hop(ops.cuda_step(bb)))
    old_dev_s = host_s(lambda: two_kernel.run(eng, x), reps=10)
    old_dev_notrace_s = host_s(lambda: two_kernel.run(eng, x,
                                                      with_trace=False),
                               reps=10)
    walk_kw = dict(n_subtrees=n_sub, n_partitions=P, with_trace=True)
    walk_ms = cuda_ms(lambda: partition_walk(x, dev, hop=eh.engine_hop_kernel,
                                             **walk_kw))
    old_walk_ms = cuda_ms(lambda: partition_walk(
        x, dev, hop=step_hop(ops.cuda_step(bb)), **walk_kw))
    buf = partition_walk(x, dev, hop=eh.engine_hop_kernel, **walk_kw)
    fetch_ms = host_s(lambda: fetch(buf), reps=10) * 1e3
    pageable_ms = host_s(lambda: buf.cpu().numpy(), reps=10) * 1e3
    emit("times", card=smi,
         engine_hop_ms=ms_hop, engine_hop_plain_ms=plain_hop,
         engine_hop_bound_ms=bound_hop, engine_hop_bound_by=by_hop,
         engine_hop_graph_ms=graph_hop, feature_window_graph_ms=graph_a,
         engine_hop_match=("warp" if L >= eh.WARP_MATCH_MIN_LEAVES
                           else "serial"),
         engine_hop_warp_match_graph_ms=graph_hop_warp,
         engine_hop_bytes=hop_bytes, engine_hop_ops=hop_ops,
         hop_view_read_ms=view_read_ms,
         feature_window_ms=ms_a, feature_window_plain_ms=plain_a,
         feature_window_bound_ms=bound_a,
         feature_window_k41_ms=ms_a41, feature_window_k41_graph_ms=graph_a41,
         feature_window_k41_plain_ms=plain_a41,
         feature_window_k41_bound_ms=bound_a41,
         dt_traverse_ms=ms_b, dt_traverse_plain_ms=plain_b,
         dt_traverse_bound_ms=bound_b, dispatch_dt_traverse_ms=ms_dispatch,
         dt_traverse_graph_ms=graph_b, dt_traverse_flows_ms=ms_flows,
         dt_traverse_flows_graph_ms=graph_flows,
         dt_traverse_flows_plain_ms=plain_flows,
         dt_traverse_flows_bound_ms=bound_flows,
         dt_traverse_flows_bytes=flows_bytes,
         dispatch_dt_traverse_graph_ms=graph_dispatch,
         dispatch_dt_traverse_kernel_nodes=dispatch_nodes,
         engine_run_from_numpy_s=run_np_s,
         engine_flows_per_s_from_numpy=B_MAIN / run_np_s,
         engine_run_from_device_s=run_dev_s,
         engine_flows_per_s_from_device=B_MAIN / run_dev_s,
         engine_run_from_device_no_trace_s=run_dev_notrace_s,
         two_kernel_run_from_device_s=old_dev_s,
         two_kernel_run_from_device_no_trace_s=old_dev_notrace_s,
         walk_device_ms=walk_ms, two_kernel_walk_device_ms=old_walk_ms,
         fetch_bytes=buf.numel() * 4, fetch_pinned_ms=fetch_ms,
         fetch_pageable_ms=pageable_ms,
         engine_fused_from_device_s=run_fused_s,
         engine_fused_flows_per_s_from_device=B_MAIN / run_fused_s,
         peak_memory_allocated_gb=peak_gb,
         engine_run_from_numpy_peak_above_held_gb=run_peak_gb)
    del buf
    emit("profile", card=smi, hop_walk=profile_run(lambda: eng.run(x)),
         two_kernel_walk=profile_run(lambda: two_kernel.run(eng, x)))

    # -- 4b. early-exit compaction on each exit profile ----------------------
    compact_out, profile_models = compact_phase(card)
    emit("compact", card=smi, **compact_out)

    # -- 4c. streaming on CUDA streams, and the router -----------------------
    # each profile's engine, its test windows tiled to B_MAIN and the
    # tiled oracle verdicts
    profiles = {prof: (Engine.from_model(p), tiled(w), [tiled(a) for a in v])
                for prof, (p, w, v) in profile_models.items()}
    stream_out = stream_phase(card, eng, wp, x, main_oracle, profiles)
    emit("stream", card=smi, **stream_out)
    tune_out = tune_phase(card, eng, wp, main_oracle, profiles, SERVE_TABLE)
    emit("tune", card=smi, **tune_out)
    del profile_models, profiles

    # -- 4d. the trainer and the DSE's batched evaluator ---------------------
    ds_s = make_dataset("d2", SERVE_FLOWS, seed=1)      # serve streams it
    fit_out = fit_phase(card, ds_s)
    emit("fit", card=smi, **fit_out)

    # -- 4e. the paper's evaluation path (tests/test_system.py) --------------
    system_out = system_phase(card)
    emit("system", card=smi, **system_out)

    # -- 5. live serving through the flow table ------------------------------
    t0 = time.perf_counter()
    stream = make_packet_stream(ds_s, seed=7, profile="steady",
                                concurrency=SERVE_CONCURRENCY)
    serve_setup_s = time.perf_counter() - t0
    srv = FlowTableServer(eng, n_buckets=SERVE_TABLE[0],
                          bucket_size=SERVE_TABLE[1], tick_engine="fused")
    check(srv._cuda and srv.tick_engine == "fused",
          "the server runs the kernels in the fused tick engine")
    ticks = list(stream.ticks(SERVE_TICK))
    profiled = len(ticks) // 2          # a steady-state tick, traced
    calls, tick_s, tick_dispatches, shapes = [], [], [], []
    torch.cuda.synchronize()
    fw.launches = fw.update_launches = fw.update_finalize_launches = 0
    dt_traverse.launches = tk.tick_launches = eh.launches = 0
    reset_spans()
    for i, batch in enumerate(ticks):
        d0 = srv.stats.dispatches
        if i == profiled:
            # host spans count the untraced calls only
            spans_before = span_totals()
            tick_prof = profile_run(lambda: calls.append(srv.ingest(batch)),
                                    warmup=False, ranges="tick/")
            reset_spans()
        else:
            t0 = time.perf_counter()
            calls.append(srv.ingest(batch))
            tick_s.append(time.perf_counter() - t0)
        tick_dispatches.append(srv.stats.dispatches - d0)
        shapes.append(srv.last_tick_shape)
    t0 = time.perf_counter()
    calls.append(srv.flush())
    flush_s = time.perf_counter() - t0
    host_spans = span_totals()
    for path, t in spans_before.items():
        merged = host_spans.setdefault(path, {"calls": 0, "s": 0.0})
        merged["calls"] += t["calls"]
        merged["s"] += t["s"]
    serve_launches = {"tick_step": tk.tick_launches,
                      "feature_update_finalize": fw.update_finalize_launches,
                      "dt_traverse": dt_traverse.launches,
                      "feature_update": fw.update_launches,
                      "feature_window": fw.launches,
                      "engine_hop": eh.launches}
    # no flow spills in this stream, so every tick folds resident flows:
    # one fused tick each, and no batch walk (the hop kernel) runs
    check(srv.stats.spilled == 0, "the serving stream spills no flow")
    check(serve_launches == {"tick_step": len(ticks),
                             "feature_update_finalize": 0, "dt_traverse": 0,
                             "feature_update": 0, "feature_window": 0,
                             "engine_hop": 0},
          f"one tick kernel launch per fused tick and no other serving "
          f"kernel, got {serve_launches} over {len(ticks)} ticks")
    v = StreamVerdicts.concat(calls)
    check(v.n_flows == SERVE_FLOWS
          and np.unique(v.flow_id).size == SERVE_FLOWS,
          "one verdict per served flow")
    order = np.argsort(v.flow_id)
    full = eng.run(window_packets(ds_s, 3), with_trace=False)  # cuda walk
    want = pdt.predict(window_features(ds_s, 3), return_trace=True)
    for name, oracle in zip(("labels", "recircs", "exit_partition"), want):
        got = getattr(v, name)[order]
        check(got.dtype == np.int32, f"serve {name} dtype")
        check(np.array_equal(got, getattr(full, name)),
              f"serve {name} == Engine.run on the rebuilt windows")
        check(np.array_equal(got, oracle), f"serve {name} == pdt.predict")
    wall_s = sum(tick_s) + flush_s      # every call but the traced tick
    prof_pkts = ticks[profiled].n_packets
    prof_verdicts = calls[profiled].n_flows
    shape_counts = {}
    for r, c in shapes:
        shape_counts[f"{r}x{c}"] = shape_counts.get(f"{r}x{c}", 0) + 1
    C_serve = max(shape_counts.items(), key=lambda kv: kv[1])[0]
    C_serve = int(C_serve.split("x")[1])
    state_bytes = sum(t.numel() * t.element_size() for t in srv._tstate)
    emit("serve", card=smi, n_flows=SERVE_FLOWS, n_packets=stream.n_packets,
         n_ticks=len(ticks), tick_packets=SERVE_TICK,
         concurrency=SERVE_CONCURRENCY, table_slots=srv.table.capacity,
         tick_state_bytes_per_slot=state_bytes / (srv.table.capacity + 1),
         setup_s=serve_setup_s, wall_s_untraced=wall_s,
         packets_per_s=(stream.n_packets - prof_pkts) / wall_s,
         verdicts_per_s=(v.n_flows - prof_verdicts) / wall_s,
         tick_ms_p50=float(np.percentile(tick_s, 50)) * 1e3,
         tick_ms_p99=float(np.percentile(tick_s, 99)) * 1e3,
         tick_ms_max=max(tick_s) * 1e3, flush_ms=flush_s * 1e3,
         dispatches_per_tick=float(np.mean(tick_dispatches)),
         dispatches_per_tick_max=max(tick_dispatches),
         launches=serve_launches,
         launches_per_tick={k: n / len(ticks)
                            for k, n in serve_launches.items()},
         rank_x_width_per_tick=shape_counts, host_spans_s=host_spans,
         host_span_share={path: t["s"] / wall_s
                          for path, t in host_spans.items()},
         stats=srv.stats.as_dict(),
         serve_recirc_overhead=srv.registry.gauge(
             "serve_recirc_overhead").value,
         n_unterminated=v.n_unterminated,
         verdicts_equal_engine_run_and_predict=True,
         reporter=reporter_check(srv.registry))

    # -- 6. fold kernels and the cuda server vs their plain versions --------
    serve_checks = {}
    st = srv._tstate

    def fold_args(C):
        """Packets of the stream and real resident state rows, with the
        slot rows of each row's SID: the fold's inputs at width C."""
        rows = torch.arange(C, device=card) % srv.table.capacity
        sid = st.sid[rows].long()
        pkt = torch.from_numpy(stream.pkts[:C]).to(card)
        return (pkt, *(t[sid] for t in dev[:4]), st.acc[rows].contiguous(),
                st.seen[rows].contiguous())

    def fold_table_args(C):
        """The table forms' inputs at width C: a copy of the resident
        state (its dummy row's acc set to -0.0 and NaN in turn), C -
        FOLD_PAD unique real rows with the stream's packets and their
        SIDs, then FOLD_PAD duplicates of the dummy row with a zero
        packet and SID 0; the engine's SID-keyed slot tables."""
        N = srv.table.capacity
        acc_t, seen_t = st.acc.clone(), st.seen.clone()
        acc_t[N] = torch.tensor([-0.0, float("nan")] * k,
                                device=card)[:k]
        gen = torch.Generator(device=card).manual_seed(C)
        slots_t = torch.full((C,), N, dtype=torch.int32, device=card)
        slots_t[:C - FOLD_PAD] = torch.randperm(
            N, generator=gen, device=card)[:C - FOLD_PAD].to(torch.int32)
        sid_t = torch.zeros(C, dtype=torch.int32, device=card)
        sid_t[:C - FOLD_PAD] = st.sid[slots_t[:C - FOLD_PAD].long()]
        pkt_t = torch.zeros(C, 6, device=card)
        pkt_t[:C - FOLD_PAD] = torch.from_numpy(
            stream.pkts[:C - FOLD_PAD]).to(card)
        return (acc_t, seen_t, slots_t, sid_t, pkt_t, *dev[:4])

    err3 = err4 = 0.0
    C_odd = C_serve - 37                # no multiple of any block size
    for C in (C_serve, C_odd):
        pkt, op, fld, prd, init, acc, seen = fold_args(C)
        for i, (got, want_) in enumerate(zip(
                fw.feature_update_kernel(pkt, op, fld, prd, acc, seen),
                ref.feature_update_ref(pkt, op, fld, prd, acc, seen))):
            err3 = max(err3, compare(f"feature_update[C={C},k={k}][{i}]",
                                     got, want_, serve_checks))
        for i, (got, want_) in enumerate(zip(
                fw.feature_update_finalize_kernel(pkt, op, fld, prd, init,
                                                  acc, seen),
                ref.feature_update_finalize_ref(pkt, op, fld, prd, init, acc,
                                                seen))):
            err4 = max(err4, compare(
                f"feature_update_finalize[C={C},k={k}][{i}]", got, want_,
                serve_checks))

    # the table forms, folded in place on a copy of the resident state:
    # C entries, the last 37 dummy-row duplicates with an invalid packet
    # and SID 0 (as _pad_slots pads a rank), the dummy row holding -0.0
    # and NaN; held to the plain version (gather, fold, scatter) and, on
    # the real rows, to the row forms
    for C in (C_serve, C_odd):
        tab_args = fold_table_args(C)
        n_real = C - FOLD_PAD
        for name, kern, plain, rows_fn in (
                ("feature_update", fw.feature_update_table_kernel,
                 fw.feature_update_table_ref, lambda a: a[5:8]),
                ("feature_update_finalize",
                 fw.feature_update_finalize_table_kernel,
                 fw.feature_update_finalize_table_ref, lambda a: a[5:9])):
            acc_t, seen_t, slots_t, sid_t, pkt_t = tab_args[:5]
            fresh = lambda: (acc_t.clone(), seen_t.clone(), slots_t, sid_t,
                             pkt_t, *rows_fn(tab_args))
            got = kern(*fresh())
            want_ = plain(*fresh())
            for i, (a_, b_) in enumerate(zip(got, want_)):
                e = compare(f"{name}[table,C={C},k={k}][{i}]", a_, b_,
                            serve_checks, nan_equal=True)
                if name == "feature_update":
                    err3 = max(err3, e)
                else:
                    err4 = max(err4, e)
            dummy = acc_t.shape[0] - 1
            for i in range(2):
                check(same_bits(got[i][dummy], want_[i][dummy]),
                      f"{name}[table,C={C}]: the dummy row bit for bit")
            # the row form on the real rows, from the same template
            r = slots_t[:n_real].long()
            sl = sid_t[:n_real].long()
            row_args = (pkt_t[:n_real], *(t[sl] for t in rows_fn(tab_args)),
                        acc_t[r], seen_t[r])
            row_out = (fw.feature_update_kernel if name == "feature_update"
                       else fw.feature_update_finalize_kernel)(*row_args)
            tab_rows = (got[0][r], got[1][r])
            if name == "feature_update_finalize":
                tab_rows += (got[2][:n_real],)
            for a_, b_ in zip(tab_rows, row_out):
                check(same_bits(a_, b_),
                      f"{name}[table,C={C}] == the row form bit for bit")
        # feature_update_at with pre-gathered rows (sid = row)
        acc_t, seen_t, slots_t, sid_t, pkt_t = tab_args[:5]
        sl = sid_t.long()
        got = fw.feature_update_at(acc_t.clone(), seen_t.clone(), slots_t,
                                   pkt_t, *(t[sl] for t in tab_args[5:8]))
        want_ = fw.feature_update_table_ref(acc_t.clone(), seen_t.clone(),
                                            slots_t, sid_t, pkt_t,
                                            *tab_args[5:8])
        for i, (a_, b_) in enumerate(zip(got, want_)):
            err3 = max(err3, compare(f"feature_update_at[C={C},k={k}][{i}]",
                                     a_, b_, serve_checks, nan_equal=True))

    sub = slice(0, CHECK_FLOWS)
    ds_p = FlowDataset(ds_s.packets[sub], ds_s.lengths[sub],
                       ds_s.labels[sub], ds_s.n_classes, ds_s.name)
    stream_p = make_packet_stream(ds_p, seed=7, profile="steady",
                                  concurrency=CHECK_CONCURRENCY)
    route_runs = {}
    orig_tick = tk.tick_step
    prefix_log = new_tick_log()
    for tick_engine in ("fused", "legacy"):
        runs = {}
        for impl in ("cuda", "fused"):
            fw.update_launches = fw.update_finalize_launches = 0
            tk.tick_launches = dt_traverse.launches = eh.launches = 0
            srv_c = FlowTableServer(
                eng, n_buckets=CHECK_TABLE[0], bucket_size=CHECK_TABLE[1],
                timeout=CHECK_TIMEOUT, tick_engine=tick_engine,
                options=EngineOptions(impl=impl))
            if tick_engine == "fused" and impl == "cuda":
                # every tick of the prefix: kernel against rank loop
                tk.tick_step = tick_vs_plain(tk, prefix_log)
            t0 = time.perf_counter()
            try:
                got_calls = ([srv_c.ingest(b)
                              for b in stream_p.ticks(CHECK_TICK)]
                             + [srv_c.flush()])
            finally:
                tk.tick_step = orig_tick
            runs[impl] = (got_calls, srv_c.stats.as_dict(), {
                "feature_update": fw.update_launches,
                "feature_update_finalize": fw.update_finalize_launches,
                "tick_step": tk.tick_launches,
                "dt_traverse": dt_traverse.launches,
                "engine_hop": eh.launches},
                time.perf_counter() - t0)
        (a_calls, a_stats, a_l, a_s), (b_calls, b_stats, b_l, b_s) = (
            runs["cuda"], runs["fused"])
        check(len(a_calls) == len(b_calls), "same number of calls")
        for j, (a, b) in enumerate(zip(a_calls, b_calls)):
            for name in ("flow_id", "labels", "recircs", "exit_partition"):
                check(np.array_equal(getattr(a, name), getattr(b, name)),
                      f"{tick_engine} server cuda == fused: call {j} {name}")
        check(a_stats == b_stats, f"{tick_engine} server stats cuda == fused")
        check(a_stats["spilled"] > 0 and a_stats["evicted"] > 0,
              f"the check run spills and evicts: {a_stats}")
        check(not any(b_l.values()),
              "the fused route launches no serving kernel")
        # spilled flows run Engine.run: the hop kernel, once a partition
        check(a_l["engine_hop"] > 0 and a_l["engine_hop"] % 3 == 0,
              f"{tick_engine} cuda server: the spill walk runs the hop "
              f"kernel, got {a_l}")
        if tick_engine == "legacy":
            check(a_l["feature_update"] > 0 and a_l["dt_traverse"] > 0
                  and a_l["tick_step"] == 0,
                  f"legacy cuda server: fold and range-match kernels, got "
                  f"{a_l}")
        else:
            check(a_l["tick_step"] == prefix_log["ticks"] > 0
                  and a_l["feature_update"] == 0
                  and a_l["feature_update_finalize"] == 0
                  and a_l["dt_traverse"] == 0,
                  f"fused cuda server: one tick kernel a tick, got {a_l} "
                  f"over {prefix_log['ticks']} ticks")
        route_runs[tick_engine] = {
            "stats": a_stats, "cuda_launches": a_l,
            "cuda_launches_per_tick": {k: n / a_stats["ticks"]
                                       for k, n in a_l.items()},
            "cuda_s": a_s, "cuda_s_per_tick": a_s / a_stats["ticks"],
            "fused_s": b_s, "verdicts_equal": True,
            "stats_equal": True}

    # the main stream on a fresh server: kernel against rank loop on the
    # last MAIN_TICKS_CHECKED ticks up to the traced steady-state tick,
    # whose inputs serve_times then replays
    main_log = new_tick_log()
    srv_m = FlowTableServer(eng, n_buckets=SERVE_TABLE[0],
                            bucket_size=SERVE_TABLE[1], tick_engine="fused")
    first_checked = profiled + 1 - MAIN_TICKS_CHECKED
    checker = tick_vs_plain(tk, main_log)
    for i, batch in enumerate(ticks[:profiled + 1]):
        if i >= first_checked:
            tk.tick_step = checker
        try:
            srv_m.ingest(batch)
        finally:
            tk.tick_step = orig_tick
    check(main_log["ticks"] == MAIN_TICKS_CHECKED,
          f"{MAIN_TICKS_CHECKED} main-stream ticks checked")
    tick_in, slots_rc, pkt_rc, tick_plain = main_log.pop("last")
    del srv_m

    # models wider than the tick kernel's register templates (k <= 8): its
    # capacity instantiations, every tick against the rank loop, on small
    # streams that spill (the spill walk runs the hop kernel at that k)
    wide = {}
    for kk in WIDE_K:
        ds_w = make_dataset("d2", WIDE_FLOWS, seed=kk)
        pdt_w = train_partitioned_dt(window_features(ds_w, 3), ds_w.labels,
                                     partition_sizes=[2, 3, 2], k=kk)
        eng_w = Engine.from_model(pdt_w)
        check(eng_w.tables.dev.slot_op.shape[1] == kk, f"a k = {kk} model")
        log = new_tick_log()
        tk.tick_launches = eh.launches = 0
        srv_w = FlowTableServer(eng_w, n_buckets=WIDE_TABLE[0],
                                bucket_size=WIDE_TABLE[1],
                                tick_engine="fused")
        stream_w = make_packet_stream(ds_w, seed=kk, profile="steady",
                                      concurrency=WIDE_CONCURRENCY)
        tk.tick_step = tick_vs_plain(tk, log)
        try:
            v_w = StreamVerdicts.concat(
                [srv_w.ingest(b) for b in stream_w.ticks(CHECK_TICK)]
                + [srv_w.flush()])
        finally:
            tk.tick_step = orig_tick
        check(tk.tick_launches == log["ticks"] > 0
              and srv_w.stats.spilled > 0 and eh.launches > 0,
              f"k = {kk}: one tick kernel a tick, spills on the hop kernel")
        order_w = np.argsort(v_w.flow_id)
        check(np.array_equal(v_w.flow_id[order_w], np.arange(WIDE_FLOWS)),
              f"k = {kk}: one verdict per flow")
        want_w = pdt_w.predict(window_features(ds_w, 3), return_trace=True)
        for name, oracle in zip(("labels", "recircs", "exit_partition"),
                                want_w):
            check(np.array_equal(getattr(v_w, name)[order_w], oracle),
                  f"k = {kk}: served {name} == pdt.predict")
        wide[f"k={kk}"] = dict(tick_log_summary(log), flows=WIDE_FLOWS,
                               stats=srv_w.stats.as_dict(),
                               hop_launches=eh.launches,
                               verdicts_equal_predict=True)
    emit("serve_check", tolerance="zero: torch.equal and np.array_equal",
         comparisons=serve_checks,
         tick_kernel_vs_rank_loop={
             "check_prefix": tick_log_summary(prefix_log),
             "main_stream": dict(tick_log_summary(main_log),
                                 ticks_from=first_checked),
             **wide},
         prefix_flows=CHECK_FLOWS,
         table_slots=CHECK_TABLE[0] * CHECK_TABLE[1],
         timeout_s=CHECK_TIMEOUT, servers=route_runs)

    # -- 7. fold kernel times at the serving width ---------------------------
    pkt, op, fld, prd, init, acc, seen = fold_args(C_serve)
    # a call of either wrapper costs more host time than its kernel costs
    # device time, so CUDA events around one call (call_ms) measure the
    # launch; the kernel's own time (ms) comes from CUDA-graph replay
    fold3 = lambda: fw.feature_update_kernel(pkt, op, fld, prd, acc, seen)
    fold4 = lambda: fw.feature_update_finalize_kernel(pkt, op, fld, prd,
                                                      init, acc, seen)
    call3 = cuda_ms(fold3, reps=50, warmup=5)
    call4 = cuda_ms(fold4, reps=50, warmup=5)
    ms3 = graph_ms(fold3, 200)
    ms4 = graph_ms(fold4, 200)
    plain3 = cuda_ms(lambda: ref.feature_update_ref(pkt, op, fld, prd, acc,
                                                    seen), reps=50, warmup=5)
    plain4 = cuda_ms(lambda: ref.feature_update_finalize_ref(
        pkt, op, fld, prd, init, acc, seen), reps=50, warmup=5)
    # least traffic: the packet row and 5 (n, k) inputs in, 2 out; the
    # finalize form reads init and writes regs too.  About 4 f32
    # operations a slot.
    n_slot = C_serve * k
    bytes3 = C_serve * 6 * 4 + n_slot * 4 * 5 + n_slot * 4 * 2
    bytes4 = bytes3 + n_slot * 4 * 2
    bound3, by3 = bound_ms(bytes3, 4 * n_slot)
    bound4, by4 = bound_ms(bytes4, 5 * n_slot)
    legacy_ticks = route_runs["legacy"]["stats"]["ticks"]
    fold_table = fold_table_times(card, fold_table_args(C_serve), stream,
                                  dev, k)

    # the tick kernel on the steady-state tick checked above: its device
    # time is the graph replay of (restore the state, one call) less the
    # replay of the restore alone; call_ms adds the host launch (CUDA
    # events around one call); the plain rank loop by CUDA events
    n_sub = eng.tables.n_subtrees
    work = tk.TickState(*(t.clone() for t in tick_in))

    def restore():
        for dst, src in zip(work, tick_in):
            dst.copy_(src)

    def kernel_call():
        return tk.tick_step_kernel(work, slots_rc, pkt_rc, dev,
                                   n_subtrees=n_sub)

    def tick_once():
        restore()
        return kernel_call()

    restore_ms = graph_ms(restore, 20)
    tick_ms = graph_ms(tick_once, 20) - restore_ms
    tick_call_ms = cuda_ms_after(restore, kernel_call, reps=20, warmup=3)
    tick_plain_ms = cuda_ms_after(restore, lambda: tk.tick_step(
        work, slots_rc, pkt_rc, dev, n_subtrees=n_sub, cuda=False),
        reps=3, warmup=1)
    tick_once()
    torch.cuda.synchronize()
    N = work.sid.shape[0] - 1
    for name in tk.TickState._fields:
        check(torch.equal(getattr(work, name)[:N],
                          getattr(tick_plain, name)[:N]),
              f"timed tick kernel == rank loop: {name}")
    # least traffic: the slot indices, the live packets, each touched
    # row's state read and written once, a bounds pair per window
    # advance, the four (N + 1,) verdict buffers written, the tables
    # read.  Operations: ~5 a slot per folded packet, k*T + 2*L*k
    # compares per hop (an advance or a verdict).
    R_t, C_t = slots_rc.shape
    real = slots_rc != N
    n_live = int(real.sum())
    n_rows = int(torch.unique(slots_rc[real]).numel())
    advances = int((tick_plain.part[:N] - tick_in.part[:N]).sum())
    finished = int((tick_plain.retired[:N] - tick_in.retired[:N]).sum())
    table_bytes = sum(t.numel() * t.element_size() for t in dev)
    tick_bytes = (slots_rc.numel() * 4 + n_live * 6 * 4
                  + n_rows * (k * 8 + 7 * 4) * 2 + advances * 8
                  + 4 * (N + 1) * 4 + table_bytes)
    tick_ops = 5 * n_live * k + (advances + finished) * (k * T + 2 * L * k)
    tick_bound, tick_by = bound_ms(tick_bytes, tick_ops)

    times_checks = {}
    # kernel B at the serving width: the steady-state tick's C columns,
    # their registers finalized from the state the tick left and their
    # SIDs, by graph replay, bare and behind the SID dispatch
    cols = slots_rc[0].long()
    sid_c = tick_plain.sid[cols].clamp(0, S - 1)
    sl = sid_c.long()
    regs_c = ref.feature_finalize_ref(tick_plain.acc[cols],
                                      tick_plain.seen[cols],
                                      dev.slot_op[sl], dev.slot_init[sl])
    d_s = dispatch.sid_dispatch(sid_c, n_subtrees=S, block_b=bb)
    regs_gs = regs_c.new_zeros((d_s.block_sid.shape[0] * bb, k))
    regs_gs[d_s.dest.long()] = regs_c[d_s.order.long()]
    bs_args = (d_s.block_sid, regs_gs, *dev[4:])
    trav = lambda: dt_traverse.dt_traverse_kernel(*bs_args, block_b=bb)
    disp = lambda: dispatch.dispatch_dt_traverse(regs_c, sid_c, *dev[4:],
                                                 block_b=bb)
    err_bs = compare(f"dt_traverse[blocks,C={C_t}]", trav(),
                     dt_traverse.dt_traverse_blocks_ref(*bs_args,
                                                        block_b=bb),
                     times_checks)
    err_bs = max(err_bs, compare(
        f"dt_traverse[dispatch,C={C_t}]", disp(),
        ref.dt_traverse_ref(regs_c, dev.thresholds[sl], dev.leaf_lo[sl],
                            dev.leaf_hi[sl], dev.leaf_action[sl],
                            dev.leaf_valid[sl] > 0), times_checks))
    flows_c = lambda: dt_traverse.dt_traverse_flows_kernel(regs_c, sid_c,
                                                           *dev[4:])
    err_bs = max(err_bs, compare(
        f"dt_traverse[flows,C={C_t}]", flows_c(),
        dt_traverse.dt_traverse_flows_ref(regs_c, sid_c, *dev[4:]),
        times_checks))
    trav_ms = graph_ms(trav, 200)
    disp_ms = graph_ms(disp, 200)
    flows_ms_c = graph_ms(flows_c, 200)
    disp_nodes_c = graph_kernel_nodes(disp)
    check(disp_nodes_c == 1, f"dispatch_dt_traverse at the serving width: "
          f"one kernel node, got {disp_nodes_c}")
    trav_plain_ms = cuda_ms(lambda: dt_traverse.dt_traverse_blocks_ref(
        *bs_args, block_b=bb), reps=20, warmup=3)
    nb_s = d_s.block_sid.shape[0]
    tables_b = sum(t.numel() * 4 for t in dev[4:])
    trav_bound, trav_by = bound_ms(
        nb_s * 4 + nb_s * bb * k * 4 + nb_s * bb * 4 + tables_b,
        nb_s * bb * (k * T + 2 * L * k))
    disp_bound, disp_by = bound_ms(C_t * k * 4 + C_t * 4 * 2 + tables_b,
                                   C_t * (k * T + 2 * L * k))
    emit("serve_times", card=smi, C=C_serve, k=k,
         tick_step=dict(
             R=R_t, C=C_t, live_cells=n_live, rows=n_rows,
             window_advances=advances, verdicts=finished, ms=tick_ms,
             call_ms=tick_call_ms, restore_ms=restore_ms,
             plain_ms=tick_plain_ms, bound_ms=tick_bound, bound_by=tick_by,
             bytes=tick_bytes, ops=tick_ops,
             launches_per_fused_tick=serve_launches["tick_step"]
             / len(ticks)),
         dt_traverse_serving=dict(
             blocks=nb_s, block_b=bb, ms=trav_ms, plain_ms=trav_plain_ms,
             bound_ms=trav_bound, bound_by=trav_by,
             flows_ms=flows_ms_c, dispatch_ms=disp_ms,
             dispatch_kernel_nodes=disp_nodes_c,
             dispatch_bound_ms=disp_bound,
             dispatch_bound_by=disp_by, max_abs_err=err_bs),
         fold_table=fold_table,
         comparisons=times_checks,
         feature_update_ms=ms3, feature_update_call_ms=call3,
         feature_update_plain_ms=plain3,
         feature_update_bound_ms=bound3, feature_update_bytes=bytes3,
         feature_update_launches_per_legacy_tick=(
             route_runs["legacy"]["cuda_launches"]["feature_update"]
             / legacy_ticks),
         feature_update_finalize_ms=ms4,
         feature_update_finalize_call_ms=call4,
         feature_update_finalize_plain_ms=plain4,
         feature_update_finalize_bound_ms=bound4,
         feature_update_finalize_bytes=bytes4,
         feature_update_finalize_launches_per_tick=(
             serve_launches["feature_update_finalize"] / len(ticks)),
         steady_state_tick=dict(index=profiled,
                                packets=prof_pkts, **tick_prof))

    lm = lm_phases(card, smi, out_dir)
    lm_dense_phase(card, smi)
    gla = lm_hybrid_phase(card, smi, out_dir)
    lm_moe_phase(card, smi)
    lm_mla_phase(card, smi)
    lm_audio_phase(card, smi)
    train_p50_s = train_phase(card, smi)
    train_long_phase(card, smi)
    dist_phase(card, smi, train_p50_s)
    # chunk_scan's row: RWKV6's bonus form (phase lm) and Zamba2's GLA
    # form (phase lm_hybrid), each path's launches counted from zero
    lm = dict(lm, launches=lm["launches"] + gla["launches"],
              launches_path=f"{lm['launches_path']}; "
                            f"{gla['launches_path']}",
              launches_by_path={"lm": lm["launches"],
                                "lm_hybrid": gla["launches"]},
              max_abs_err=max(lm["max_abs_err"], gla["max_abs_err"]),
              gla=gla)

    # -- 8. summary -----------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": "engine_hop", "route": "cuda",
         "source": "src/repro_torch/csrc/engine_hop.cu",
         "replaces": "src/repro/kernels/feature_window.py:115 and "
                     "src/repro/kernels/dt_traverse.py:58, per hop of "
                     "src/repro/core/inference.py:237 with its _hop_update",
         "launches": launches["engine_hop"],
         "launches_path": "main: Engine.run, one per partition",
         "max_abs_err": err_hop, "ms": ms_hop, "graph_ms": graph_hop,
         "plain_ms": plain_hop,
         "bound_ms": bound_hop, "bound_by": by_hop, "library_ms": None,
         "shape": f"B={B_MAIN},W={W},k={k},S={S},T={T},L={L}",
         "equal": True,
         "stream": {
             "launches_path": "stream: run_streaming(impl='cuda') of the "
                              "2^20 windows, P a chunk",
             "launches": sum(r["hop_launches"] for r in stream_out["runs"]),
             "runs": {f"mb={r['micro_batch']},inflight={r['inflight']}":
                      r["hop_launches"] for r in stream_out["runs"]},
             "compacted": {prof: {k: c[k] for k in (
                 "hop_launches", "survivor_launches")}
                 for prof, c in stream_out["compacted"].items()}},
         "survivor_mode": {
             prof: {"shape": f"B={c['B']},W={c['W']},k={c['k']},"
                             f"S={c['S']}, survivors "
                             f"{c['survivors_entering_hop'][1:]}",
                    "launches_per_compacted_run":
                        c["survivor_launches_compact"],
                    "hops": [h for h in c["hops"] if h["hop"]]}
             for prof, c in compact_out.items() if prof != "phase_s"},
         "fleet": {
             "launches_path": "fit: fleet_predict, one per model and "
                              "partition",
             "launches": fit_out["fleet"]["launches"]["engine_hop"],
             "evaluate_batch_launches":
                 fit_out["fleet"]["evaluate_batch"]["launches"]["engine_hop"],
             "bayes_search_launches":
                 fit_out["bayes_search"]["launches"]["engine_hop"],
             **{tag: {"shape": f"{t['hops']} hops of M={t['M']} models "
                               f"(P={t['P']}), B={t['B']},W={t['W']},"
                               f"S={t['S']},k={t['k']},T={t['T']},"
                               f"L={t['L']}",
                      "ms": t["hop_launches_ms"],
                      "graph_ms": t["hop_launches_graph_ms"],
                      "plain_ms": t["plain_hops_ms"],
                      "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                      "bound_windows_read_once_ms":
                          t["bound_windows_read_once_ms"],
                      "graph_over_bound":
                          t["hop_launches_graph_ms"] / t["bound_ms"],
                      "models": t["models"]}
                for tag, t in fit_out["fleet"]["times"].items()}},
         "deep_engine_run": {
             "launches_path": "fit: Engine.run of the (10, 10, 10) / k = 6 "
                              "model, one per partition",
             **{key: fit_out["deep_engine_run"][key] for key in (
                 "launches", "match", "checked", "test_split",
                 "tiled_2^20")},
             "shape": "S={S},k={k},T={T},L={L}".format(
                 **fit_out["deep_engine_run"])},
         "main_warp_match_graph_ms": graph_hop_warp,
         "system": {
             "launches_path": "system: Engine.run of the (3, 3, 3) / k = 4 "
                              "d1 model on the test windows, one per "
                              "partition; quickstart_torch, the same",
             "launches": system_out["launches"]["engine_hop"],
             "quickstart_launches":
                 system_out["quickstart"]["launches"]["engine_hop"]}},
        {"name": "feature_window", "route": "cuda",
         "source": "src/repro_torch/csrc/feature_window.cu",
         "replaces": "src/repro/kernels/feature_window.py:115",
         "launches": launches["feature_window"],
         "launches_path": "main: window_features (k = 41); Engine.run "
                          "runs the hop kernel",
         "max_abs_err": err_a,
         "ms": ms_a, "graph_ms": graph_a, "plain_ms": plain_a,
         "bound_ms": bound_a, "bound_by": by_a, "library_ms": None,
         "shape": f"B={B_MAIN},W={W},k={k}", "equal": True,
         "run_looped_launches": {
             prof: c["run_looped_launches"]
             for prof, c in compact_out.items() if prof != "phase_s"},
         "training_shape": {
             "shape": f"1 launch of window_features, {tr.n_flows} flows x "
                      f"3 windows, W={xtr.shape[2]}, k=41, one shared row",
             "launches": fw_setup, "ms": ms_a41, "graph_ms": graph_a41,
             "plain_ms": plain_a41, "bound_ms": bound_a41,
             "bound_by": by_a41},
         "fit": dict(fit_out["kernel_a"],
                     launches_path="fit: window_features of the 2^17 "
                                   "training split, 3 windows, its one "
                                   "launch"),
         "system_full_flow": {
             "launches_path": "system: full_flow_features of the d1 train "
                              "and test splits, one launch each (of the "
                              "path's 6 with window_features at P = 2 and "
                              "3)",
             "launches": system_out["launches"]["feature_window"],
             "quickstart_launches":
                 system_out["quickstart"]["launches"]["feature_window"],
             **system_out["kernel_a_full_flow"]}},
        {"name": "dt_traverse", "route": "cuda",
         "source": "src/repro_torch/csrc/dt_traverse.cu",
         "replaces": "src/repro/kernels/dt_traverse.py:58",
         "launches": route_runs["legacy"]["cuda_launches"]["dt_traverse"],
         "launches_path": "serve_check: the legacy tick engine, cuda route "
                          "(0 in Engine.run since the hop kernel)",
         "main_launches": launches["dt_traverse"], "max_abs_err": err_b,
         "run_looped_launches": {
             prof: c["run_looped_launches"]
             for prof, c in compact_out.items() if prof != "phase_s"},
         "form": "per flow (what dispatch_dt_traverse launches)",
         "ms": ms_flows, "graph_ms": graph_flows, "plain_ms": plain_flows,
         "bound_ms": bound_flows, "bound_by": by_flows, "library_ms": None,
         "shape": f"B={B_MAIN},S={S},k={k},T={T},L={L}, SIDs -1..S-1",
         "as_called": {"dispatch_ms": ms_dispatch,
                       "dispatch_graph_ms": graph_dispatch,
                       "kernel_nodes": dispatch_nodes},
         "block_form": {"shape": f"nb={nb},bb={bb}", "ms": ms_b,
                        "graph_ms": graph_b, "plain_ms": plain_b,
                        "bound_ms": bound_b, "bound_by": by_b},
         "serving_width": {"shape": f"nb={nb_s},bb={bb}", "ms": trav_ms,
                           "plain_ms": trav_plain_ms,
                           "bound_ms": trav_bound,
                           "flows_ms": flows_ms_c,
                           "dispatch_ms": disp_ms,
                           "dispatch_kernel_nodes": disp_nodes_c,
                           "dispatch_bound_ms": disp_bound,
                           "launches_in_serve": serve_launches[
                               "dt_traverse"]},
         "deep_tables": fit_out["kernel_b_deep"],
         "equal": True},
        {"name": "feature_update", "route": "cuda",
         "source": "src/repro_torch/csrc/feature_update.cu",
         "replaces": "src/repro/kernels/feature_window.py:193",
         "launches": route_runs["legacy"]["cuda_launches"]["feature_update"],
         "launches_path": "serve_check: the legacy tick engine, cuda route",
         "max_abs_err": err3, "ms": ms3, "call_ms": call3,
         "plain_ms": plain3,
         "bound_ms": bound3, "bound_by": by3, "library_ms": None,
         "shape": f"C={C_serve},k={k}, row form", "equal": True,
         "table_form": {
             "serving": fold_table["serving"],
             "rows_2^20": {key: fold_table["rows_2^20"][key] for key in (
                 "rows", "random_slots", "sorted_slots", "plain_ms",
                 "fold_bound_ms", "fold_bound_by")},
             "floor_one_op_graph_ms": fold_table["floor_one_op_graph_ms"]}},
        {"name": "feature_update_finalize", "route": "cuda",
         "source": "src/repro_torch/csrc/feature_update.cu",
         "replaces": "src/repro/kernels/feature_window.py:276",
         "launches": serve_launches["feature_update_finalize"],
         "launches_path": "serve: the fused tick engine (the tick kernel "
                          "folds in its place; timed standalone)",
         "max_abs_err": err4, "ms": ms4, "call_ms": call4,
         "plain_ms": plain4,
         "bound_ms": bound4, "bound_by": by4, "library_ms": None,
         "shape": f"C={C_serve},k={k}, row form", "equal": True,
         "table_form_rows_2^20": {
             "random_slots_graph_ms":
                 fold_table["rows_2^20"]["random_slots"][
                     "finalize_graph_ms"],
             "sorted_slots_graph_ms":
                 fold_table["rows_2^20"]["sorted_slots"][
                     "finalize_graph_ms"],
             "bound_ms": fold_table["rows_2^20"]["finalize_bound_ms"]}},
        {"name": "tick_step", "route": "cuda",
         "source": "src/repro_torch/csrc/tick_step.cu",
         "replaces": "src/repro/kernels/feature_window.py:276 and "
                     "src/repro/kernels/dt_traverse.py:58, per rank and "
                     "hop round of src/repro/kernels/tick_step.py:201",
         "launches": serve_launches["tick_step"],
         "launches_path": "serve: one per fused tick",
         "max_abs_err": 0.0, "ms": tick_ms, "call_ms": tick_call_ms,
         "plain_ms": tick_plain_ms, "bound_ms": tick_bound,
         "bound_by": tick_by, "library_ms": None,
         "shape": f"R={R_t},C={C_t},k={k},S={S},T={T},L={L}",
         "equal": True},
        lm,
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
