#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines and seconds:
  1. card   : the device's name and its nvidia-smi name and power limit;
  2. build  : nvcc builds every kernel from the sources in the checkout;
  3. kernels: the block-CSR SpMV against its plain PyTorch version, with
              and without the per-row count of real slots; the CSR
              segment-sum kernel (float32, float64, and its hub lane:
              float64 sums added into y in place) against its plain
              version on random cases and cases built round its chunks of
              2,048 edges (the hub lane's of 512 too, its counts back at
              zero after each call), run to run and lane by lane;
  4. flash  : both flash-attention kernels (the tensor-core lane for bf16
              at head dims (64, 64), (128, 128), (256, 256) or (192, 128),
              the CUDA-core lane for the rest) against their plain
              version, with and without a local window, and the CUDA-core
              lane's resident warps per SM, registers and spills; then at
              DeepSeek-V3's (Dk, Dv) = (192, 128) and with PaliGemma's
              prefix-LM mask (D in {64, 128, 256}; prefix 0, 1, a tile
              edge, past S), both lanes, bf16 and float32; then the
              backward's two lanes (flash_attention_bwd_wgmma.cu on the
              tensor cores for bf16 at (64, 64), (128, 128) and
              (256, 256), flash_attention_bwd.cu on the CUDA cores for
              the rest: dq,
              dk, dv) against their plain version over causal and not,
              S != T both ways (Whisper's cross shape 448 x 1,500 among
              them), ragged lengths, S = 1, T = 1, G in {1, 3, 8}, D in
              {64, 128, 256} and (192, 128), a window and a prefix, bf16
              and float32, each run twice for the same bits; every case
              also from the forward kernel's o and log-sum-exp (held to
              the plain one; the CUDA-core forward's o unchanged by asking
              for it); the forward's tensor-core lane at 448 x 1,500 not
              causal; the tensor-core backward timed at SmolLM-360M's and
              Yi-6B's training shapes, the CUDA-core lane in float32 at
              SmolLM-360M's and at RecurrentGemma-2B's (window 2048) and
              in bf16 at DeepSeek-V3's MLA dims (192, 128), each with and
              without the forward's lse, beside its plain version, SDPA's
              backward and the gradient's own bound; then the RG-LRU
              scan's backward (rglru_scan_bwd_kernel: du, dga, dgi,
              db_a, db_i, dlam, dh0) against its plain version over
              `kernels/rglru_scan/
              bwd_cases.py` (RecurrentGemma-2B's width at S = 1, 129,
              4096, 16384 and 32768, ragged W, h0, the clamp of m), each
              run twice for the same bits, and timed at 1 x 4096 and
              1 x 32768 x 2560 beside its plain version and its byte
              bound, each of its launches profiled, every RG-LRU
              kernel's registers, spills and blocks an SM printed; the
              flash backward at RecurrentGemma-2B's training
              shape (bf16, D = 256, window 2048: the tensor-core lane,
              given the tensor-core forward's o and lse, and without the
              lse) beside its plain version, SDPA's backward with the
              window as a mask and SDPA's causal backward without one;
              then the SSD scan's backward (ssd_scan_bwd_kernel: dx, db,
              dc, ddt, da_log, dh0) against its plain version over
              `kernels/ssd_scan/bwd_cases.py` (Mamba2-2.7B's training
              and prefill shapes, S < Q, S = Q + 1, ragged S, h0 and
              d h_last, the smoke shapes, P, N and Q off the tiles, one
              step, a steep dt), each run twice for the same bits, and
              timed at 1 x 4096 x 80 x 64 x 128 beside its plain version
              and its bound;
  5. graph  : the Stanford-Web replica (281,903 pages, 2,312,497 links)
              and its float64 scipy oracles, on the host;
  6. packing: its hub-split block-CSR layout at bm in {8, .., 128}, with
              the bytes of its real slots beside the padded layout's;
  7. main   : the static PageRank solve through the port's entry points,
              held against the oracles, with the launch counts read around
              it (the block kernel and the CSR kernel's hub lane once per
              bsr apply);
  8. timing : one apply timed with CUDA events at bm in {8, 16, 32, 64}
              and nv in {1, 8}: kernel (real slots, and all K), plain
              version, two PyTorch sparse-BSR calls (padded layout, real
              slots only), google_apply, and the bound over the real
              slots beside the layout's;
  9. main   : the bulk-synchronous shard program on Stanford-Web, p = 4
              shards on one card: the four exchange schedules on the bsr
              backend, 8 personalized lanes with freezing and compaction,
              and the segment-sum backend run twice (the same bits), each
              held against the float64 oracles, with the launch counts of
              the block and CSR kernels read around it (one launch per
              superstep for all shards);
 10. timing : the CSR segment-sum kernel at Stanford-Web (float32 and
              float64, nv in {1, 8}; the hub row alone and the rest), its
              plain version, PyTorch's sparse CSR product, the bound and the
              wrapper's host time a call; its hub lane at Stanford-Web's
              hub rows against the float64 COO side it replaced; the
              folded block launch of the shard program against four
              per-shard launches; the 8-lane bsr run repeated, each repeat
              the main path's bits;
 11. main   : the paper's experiment as a discrete-event simulation on
              Stanford-Web (Tables 1-2): `solve_des_sync` and `solve_des`
              at p in {2, 4, 6} on the card, every block update one call
              of the CSR kernel's float64 lane, printed beside the paper's
              values, each x held to top-100 tau >= 0.999 against the
              float64 oracle, and the p = 4 run on the CPU's plain path
              beside the card's;
 12. main   : the device shard transport on Stanford-Web, p = 4 shard
              programs on the card: four drains of the linear form
              (float64 segment sum; block float32 with the f32 and the
              Kahan lane; block float64), each certified by a host float64
              residual, with the launch counts read around them;
 13. main   : certified streaming updates on Stanford-Web (ROADMAP Queue
              1 items 6.2-6.5): a DeltaGraph and its float64 cold state,
              a crawl stream through update_ranks and a 1% batch whose
              fallback solve runs on the card (the fallback split into the
              P^T splice, the upload, the solve and the exact residual;
              the stream replayed on the CPU's plain path beside it), the
              sharded device drain of a further 1% batch, 16 batched
              personalized queries on both device backends, the rank
              server inline and threaded, the replay and the DES over
              StreamingBlockOperator, each certificate the host float64
              recomputation, with the device memory across versions and
              the launch counts read around it;
 14. timing : the block kernel and the CSR kernel at the batched queries'
              16 lanes (the block kernel's generic path; its ring path at
              8 beside it), their plain versions, PyTorch's sparse calls
              and the bounds;
 15. main   : the paper's asynchronous host runtime and the query tier
              (ROADMAP Queue 1 items 7-8): `update_ranks_sharded(mode=
              "async")` on worker threads and on worker processes forked
              from this process (numpy only): the JAX package's 50k
              acceptance case (a 1% delta) at p = 2 and 4 and under its
              chaos plan (a kill, 10% drops and duplicates), then a 0.1%
              batch of Stanford-Web from the streaming phase's cold state
              (threads with the observer and its Chrome trace, procpool),
              each certified and held to a float64 cold solve on the card;
              then the rank server on the process pool with the query tier
              (batcher, cache, 2 replicas) taking the crawl batches while
              8 client threads query, and a burst of 16 queries through
              the block kernel's lanes; /dev/shm and the device memory
              clean at the end;
 16. main   : Yi-6B inference at full width (random weights from --seed,
              bf16): the prefill forward through the tensor-core flash
              kernel against its plain version, ServeEngine prefill against
              the forward (bf16, then a float32 copy whose forward takes the
              CUDA-core lane), and greedy and sampled generation, with the
              launch counts of both lanes read around it;
 17. timing : each flash lane, its plain version, PyTorch's
              scaled_dot_product_attention and the bound at the Yi-6B
              shapes (the tensor-core lane in bf16, the CUDA-core lane in
              float32, both at B = 1, S = 2048 and B = 4, S = 128, and the
              CUDA-core lane in bf16 at head dim 96); forward and
              decode-step times; one warm prefill at 1 x 2048 read for
              the dry run (phase 34): its ms, the bytes allocated before
              it, its arguments' bytes, max_memory_allocated over it and
              its flash launches;
 18. main   : the paper's iteration applied to SGD (ROADMAP Queue 1 item
              9.1): run_async_training_sim at p = 4, uniform and with a
              straggler, its DES views on the card, the iterations, times,
              speedups and losses equal to the same runs on the CPU;
 19. main   : Qwen2-MoE-A2.7B at full width and depth (item 10.1; 15.1e9
              random bf16 weights from --seed): the forward of 4 x 128
              tokens through the tensor-core flash kernel in its MHA
              layout, its routing (drops at capacity factor 1.25, expert
              load, aux loss), the plain attention under the same routing
              against it, greedy generation, the decode path against the
              forward, a 2048-token prefill, the flash launches read
              around it;
 20. timing : the flash kernel at the MoE prefill shape (H = Hkv = 16)
              beside its plain version, SDPA and the bound; forward and
              decode-step times and the card's busy share;
 21. analysis: the roofline (`repro_torch.analysis`, H100 constants) of
              the MoE prefill and decode step beside their measured times;
 22. main   : Mamba2-2.7B at full width and depth (item 10.2; 2.7e9
              random bf16 weights from --seed, the MoE's freed first):
              ssd_scan against its plain version at the main path's
              shapes, then the forward of 4 x 128 and of 1 x 2048 tokens
              through ssd_scan (three launches a layer), the decode path
              (the scan at S = 1 from the cached state: the one-launch
              step kernel) and greedy generation of 32 tokens; the same
              draws in float32, whose forward is held to impl="ref" and
              whose decode to the forward (1e-4), while the bf16 forward
              is held to the float32 one no further than the bf16 plain
              versions are; the ssd_scan and step launches read around
              it;
 23. main   : RecurrentGemma-2B likewise (item 10.3; 2.9e9 weights):
              rglru_scan against its plain version, the forward of
              4 x 128 and of 1 x 4096 tokens (the window of 2048 binds)
              through rglru_scan in its 18 RG-LRU layers and the flash
              kernel at head dim 256 in its 8 local_attn layers (the
              CUDA-core lane in the float32 copy), decode through the ring
              KV cache, the launches read around it;
 24. timing : the flash kernel at B = 1, H = 10, Hkv = 1, S = T = 4096,
              D = 256 with the window and without, ssd_scan at 1 x 2048
              (bound: its split TF32 products, and beside it the
              earlier float32-FMA bound) and its decode step at 4 x 1, rglru_scan
              at 1 x 4096 and its decode step at 4 x 1 (each step over 8
              input sets in turn, its state from device memory), each
              beside its plain version, the library call where there is
              one and the bound; both models' forward and decode-step
              times and the card's busy share; the roofline of both
              prefills; a Mamba2-2.7B decode step at B = 4 on a fresh
              cache, RecurrentGemma-2B freed, read as in phase 17;
 25. main   : DeepSeek-V3 at full width cut to 4 of 61 layers (item
              10.4; its 3 dense layers and the first MoE layer, 15.1e9
              random bf16 weights from --seed, 30.2 GB): the forward of
              4 x 128 tokens through the tensor-core flash kernel at
              (Dk, Dv) = (192, 128), H = Hkv = 128 (4 launches), its
              routing (drops at capacity 1.25, C = 20), the plain
              attention under the same routing against it, greedy
              generation of 32 tokens (absorbed-matrix decode over the
              latent cache), the decode path against the forward at every
              position, a 2048-token prefill; a float32 copy cut to one
              dense MLA layer (9.75 GB) through the CUDA-core lane, held
              to impl="ref" and its decode path to 1e-4;
 26. timing : the flash kernel at the MLA prefill shape beside its plain
              version, SDPA and the bound (and the CUDA-core lane in
              float32); forward and decode-step times, the card's busy
              share and the roofline of the prefill and decode step;
 27. main   : PaliGemma-3B uncut (item 10.5; 2.5e9 weights, 5.0 GB) with a
              prefix of 256 random patch embeddings: the forward of
              4 x (256 + 128) positions through the tensor-core kernel at
              D = 256 with the prefix-LM mask against the plain attention,
              a 1 x (256 + 1792) prefill, the decode path (no prefix, as
              in the JAX package) and greedy generation of 32 tokens; a
              float32 copy (10 GB) held to impl="ref" and its decode path
              to 1e-4;
 28. timing : the flash kernel at the PaliGemma prefill shape with the
              prefix beside its plain version, SDPA given the prefix-LM
              mask and the bound; forward and decode-step times, the busy
              share and the roofline of the long prefill;
 29. main   : Whisper-base uncut (item 10.6; 70.7e6 random bf16 weights):
              ServeEngine encodes 4 requests of 1,500 random frame
              embeddings once and generates 64 tokens each through the
              cross cache; a forward of 1 x 448 tokens over 1,500 frames
              (6 encoder, 6 causal and 6 cross launches on the tensor
              cores); encode ms, tokens/s and the busy share; a float32
              copy held to impl="ref" and its decode path to its forward;
 30. main   : training SmolLM-360M uncut in bf16 through
              `repro_torch.launch.train`'s main (items 10.7-10.8): 5 steps
              at batch 8 x 2048 with a checkpoint directory, then resumed
              from its checkpoint for 2 more; the loss of each step (it
              must fall), ms a step, tokens/s, peak memory, the backward
              kernel's calls (every one on the tensor-core lane) and its
              share of a profiled step; step 3 read as in phase 17; one
              step of a 2-layer float32 copy
              with impl="cuda" (the CUDA-core backward) against impl="ref";
 31. main   : training Whisper-base uncut, 5 steps at batch 8, 448 tokens
              over 448 frames; the loss must fall;
 32. main   : training RecurrentGemma-2B uncut in bf16 (item 10.9) through
              the launcher's main, 5 steps at batch 1 x 4096 (the window
              of 2048 binds); the loss must fall; ms a step, tokens/s,
              peak memory, the RG-LRU backward's calls (18 a step) and
              the flash backward's (8 a step, every one on the
              tensor-core lane) and their shares of a
              profiled step; one step of a float32 copy cut to one cycle
              (rglru, rglru, local_attn) with impl="cuda" against
              impl="ref";
 33. main   : training Mamba2-2.7B uncut in bf16 (items 10.9 and Queue 2
              item 2) through the launcher's main, 5 steps at batch
              1 x 4096; the loss must fall; ms a step, tokens/s, peak
              memory, the SSD scan's calls (64 forwards and 64 remat
              recomputes of 3 launches, 64 backward calls a step) and the
              backward's share of a profiled step; one step of a float32
              copy cut to 2 layers with impl="cuda" against impl="ref";
 34. dry run: every (arch x shape) cell of `launch.dryrun` counted on the
              meta device in 8 worker processes (no card): a line a cell
              (status, TFLOP, GB, peak GB, fits, compute and memory ms,
              the dominant term), every cell the arch supports ok, the
              500k decode of the full-attention archs skipped, none in
              error, within 120 s; the same workers count the three steps
              read in phases 17, 24 and 30, each held to the card: its
              peak within 5% of max_memory_allocated (the card's fixed
              term added), its arguments within 512 B a storage, its
              temporaries within 5% + 1 MiB, its bookings equal to the
              launches, its ms beside its roofline bound.

It prints a JSON line describing every kernel, then, as its last line,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a machine without a CUDA device.
"""
import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# cuda_ms's device sleep before its timed calls: ~20 ms at the H100's
# 1.98 GHz boost clock
SLEEP_CYCLES = 40_000_000
BSR_SOURCE = "src/repro_torch/kernels/bsr_spmv/csrc/bsr_spmv.cu"
FLASH_SOURCE = {
    "wgmma": "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_wgmma.cu",
    "f32": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"}
# block edges and lane counts timed at Stanford-Web scale
TIMED_BM = (8, 16, 32, 64)
TIMED_NV = (1, 8)
CSR_SOURCE = "src/repro_torch/kernels/csr_spmv/csrc/csr_spmv.cu"
# the shard program on Stanford-Web: shards, and the margin of each run's
# inf-norm tolerance over the float32 spacing of the largest rank it holds
# (a looser tol misses the L1 gate: the timing phase's sweep prints it)
SPMD_P = 4
SPMD_TOL_MARGIN = 1.07
# the lanes' monitor persistence (Fig. 1's pcMax): four consecutive
# all-converged supersteps before a lane stops (with one, an inf-norm stop
# at that tol leaves a personalized lane above the L1 gate; the sweep
# prints it)
SPMD_LANE_PC_MAX = 4
# repeats of the lane run in the timing phase (the spread of its L1 error)
SPMD_LANE_REPEATS = 4
SPMD_SCHEDULES = ("allgather", "allgather_k", "ring", "sparsified")
# the paper's experiment in the DES (Tables 1-2): its configuration is the
# port's `configs.pagerank.paper_des_config`; the paper's values are those
# of benchmarks/paper_tables.py (PAPER_TABLE1, :19-27; Table 2's completed
# imports, :77), copied, since that module imports the JAX package
DES_PROCS = (2, 4, 6)
PAPER_TABLE1 = {
    2: dict(sync_iters=44, sync_t=179.2, async_iters=(68, 69),
            async_t=(86.3, 94.5), speedup=1.98),
    4: dict(sync_iters=44, sync_t=331.4, async_iters=(82, 111),
            async_t=(139.2, 153.1), speedup=2.27),
    6: dict(sync_iters=44, sync_t=402.8, async_iters=(129, 148),
            async_t=(141.7, 160.6), speedup=2.66),
}
PAPER_TABLE2_PCT = [29, 28, 41, 45]
# the device transport's drains of the linear form from the uniform start,
# p = 4 shard programs on the card: (name, DeviceShardTransport fields, the
# L1 target of the all-reduced fragment delta, the bound on the host
# float64 residual that certifies the result). The float64 segment sum
# drains to 1e-9; the block lanes read float32 views on the card (the
# float64 one too: its "f64" lane is the Kahan kernel over the views
# rounded to float32), so they drain to 1e-6, and their blocks' float32
# weights floor the residual against the float64 operator near 1e-7
TRANSPORT_P = 4
TRANSPORT_LANES = [
    ("float64 segment_sum, sparsified", dict(), 1e-9, 1e-8),
    ("bsr float32, accum f32, sparsified",
     dict(dtype="float32", backend="bsr", accum="f32"), 1e-6, 3e-6),
    ("bsr float32, accum kahan, sparsified",
     dict(dtype="float32", backend="bsr", accum="kahan"), 1e-6, 3e-6),
    ("bsr float64, accum f64, sparsified", dict(backend="bsr"), 1e-6, 3e-6),
]
# the streaming phase (ROADMAP Queue 1 items 6.2-6.5) on Stanford-Web: the
# crawl stream of benchmarks/streaming_bench.py's replay (:79-91: 24
# batches of 2 edges; seed 4 and 12 batches here, each trace taking ~2.3 s
# of host time a batch to make), its serving tol, the 1% batches' and
# the cold state's tol, the shards of the device drain, the batched
# queries (`benchmarks/query_bench.py`'s middle batch, 16) and the
# replay's clock, copied, since those modules import the JAX package
STREAM_TRACE = dict(n_batches=12, batch_edges=2, seed=4)
STREAM_TOL = 1e-6
STREAM_BULK_TOL = 1e-8
STREAM_P = 4
STREAM_PPR_NV = 16
STREAM_PPR_TOL = 1e-4
STREAM_REPLAY = dict(query_rate=500.0, delta_interval=0.25, tol=1e-5)
STREAM_SERVE_S = 2.0
# the asynchronous host runtime and the query tier (ROADMAP Queue 1 items
# 7-8): the JAX package's acceptance workload (tests/conftest.py: the 50k
# power-law graph and a seeded 1% delta, 85% inserts; its
# tests/test_transport.py and test_faults.py hold it to 1e-8 at p = 2 and
# 4, and at p = 4 under the chaos plan), a 0.1% batch of Stanford-Web drawn
# the same way, and the rank server on the process pool with the query
# tier under the traffic of the JAX package's
# benchmarks/query_bench.py::load_gen (its numbers, copied): each client
# call is router.top_k(k), k uniform in [1, 100), with probability 0.55,
# router.scores of 8 uniform ids with 0.30, and else personalized() at tol
# 1e-3 of a seed set from a pool of 32 (1-3 seeds each, generator seed 11;
# client k's generator seed 100 + k) drawn with Zipf 1.1 popularity; the
# tier at max_batch 16, max_delay 5 ms, cache capacity 64, 2 replicas,
# redirect on a stale replica, the server polling every 2 ms. Unlike
# load_gen: 8 clients (its 3), max_version_lag 1 (its 2; 1 as in
# tests/test_query_tier.py's end-to-end case), and the updater takes the
# streaming phase's crawl batches (load_gen: a 1% batch a second). Then a
# burst of 16 queries at query_bench's tol 1e-4 through the block
# kernel's lanes
ASYNC_50K = dict(n=50_000, target_nnz=400_000, n_dangling=50, seed=3)
ASYNC_TOL = 1e-8
ASYNC_CHAOS = dict(seed=7, kill={1: 40}, drop_rate=0.10, dup_rate=0.10)
ASYNC_WEB_DEN = 1000
TIER_CLIENTS = 8
TIER_MIX = (0.55, 0.85)
TIER_POOL = 32
TIER_ZIPF = 1.1
TIER_SETTINGS = dict(max_batch=16, max_delay_s=0.005, cache_capacity=64,
                     replicas=2, max_version_lag=1, on_stale="redirect")
TIER_PPR_TOL = 1e-3
TIER_SERVE_S = 6.0
TIER_TOL = 1e-4
TIER_BURST = 16
TPU_KERNEL = {"f32": "src/repro/kernels/bsr_spmv/bsr_spmv.py:36",
              "csr": "src/repro/graph/csr.py:152 (no TPU kernel: an XLA "
                     "gather + segment_sum)",
              "hub": "src/repro/kernels/bsr_spmv/ops.py:309 (no TPU "
                     "kernel: hybrid_matvec's hub gather + segment_sum)",
              "kahan": "src/repro/kernels/bsr_spmv/bsr_spmv.py:50",
              "flash": "src/repro/kernels/flash_attention/"
                       "flash_attention.py:27",
              "ssd": "src/repro/models/ssm.py:59 (no TPU kernel: _ssd_scan, "
                     "a lax.scan of einsums)",
              "rglru": "src/repro/models/rglru.py:44 (no TPU kernel: "
                       "_lru_coeffs and lax.associative_scan)",
              "ssd_step": "src/repro/models/ssm.py:172 (no TPU kernel: "
                          "ssd_step's one-step update)",
              "rglru_step": "src/repro/models/rglru.py:94 (no TPU kernel: "
                            "rglru_step's _lru_coeffs and a h + b)"}
# the Yi-6B runs: prompts of the main path, and the prefill shape timed;
# the Qwen2-MoE-A2.7B runs take the same shapes
YI_BATCH, YI_PROMPT, YI_GEN = 4, 128, 32
YI_PREFILL = (1, 2048)
MOE_ARCH = "qwen2-moe-a2.7b"
# Mamba2-2.7B and RecurrentGemma-2B (ROADMAP Queue 1 items 10.2-10.3): the
# main path's prompts and generation, each model's long prefill (2048
# tokens, and 4096 for RecurrentGemma, where its window of 2048 binds),
# and their parameter counts (the JAX package's model_defs)
RECUR_BATCH, RECUR_PROMPT, RECUR_GEN = 4, 128, 32
# the scans' decode steps are timed over this many input sets in turn, so
# that their states (10.5 MB for Mamba2-2.7B's SSD at B = 4) exceed L2
DECODE_SETS = 8
# rglru_scan is also timed at these prompt lengths (1 x S x 2560), where
# its carry crosses 256 and 512 chunks
RGLRU_LONG = (16384, 32768)
# RecurrentGemma's local attention with a window under the 128-token
# prompts, so that the decode path's ring KV cache wraps on the card
RING_WINDOW = 64
RECUR_ARCHS = {"mamba2-2.7b": dict(prefill=(1, 2048), params=2_702_296_576),
               "recurrentgemma-2b": dict(prefill=(1, 4096),
                                         params=2_894_528_000)}
# DeepSeek-V3 (ROADMAP Queue 1 item 10.4) at full width cut from 61 to 4
# layers, its 3 dense layers and the first MoE layer (15.1e9 parameters,
# 30.2 GB in bf16), and a float32 copy cut to one dense MLA layer (2.4e9,
# 9.75 GB); PaliGemma-3B (item 10.5) uncut (2.5e9, 5.0 GB; 10 GB in
# float32), its 256-position prefix ahead of 128 prompt tokens and of a
# 1792-token text in the long prefill. Parameter counts: the JAX
# package's model_defs.
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 4
MLA_PARAMS, MLA_F32_PARAMS = 15_111_101_440, 2_436_848_640
VLM_ARCH, VLM_PARAMS, VLM_LONG_TEXT = "paligemma-3b", 2_508_793_856, 1792
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
RGLRU_SOURCE = "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu"
# the paper's iteration on SGD (training/async_dp.py): p = 4 UEs at seed 0,
# uniform and with one UE at 0.3x speed (tests/test_async_dp.py)
TRAIN_CASES = (("uniform", None), ("straggler", [1, 1, 1, 0.3]))
# the dry run (launch.dryrun) on the card: its memory model held to
# torch.cuda.max_memory_allocated over one warm step at full width
# (SmolLM-360M training, the Yi-6B prefill, a decode step of
# DRY_DECODE_ARCH at B = 4): the peak within this share, the arguments
# within the allocator's granule a storage, the temporaries within this
# share of the card's plus DRY_ALLOC_SPLIT (the caching allocator hands
# out a cached block whole where less than this would be left over, so a
# step's bytes on the card may exceed its rounded requests by less than
# it); its table of every (arch x shape) cell in at most DRY_TABLE_S
# seconds with DRY_TABLE_JOBS worker processes, which count the three
# steps too
DRY_MEMORY_GAP = 0.05
DRY_ALLOC_SPLIT = 1 << 20
DRY_DECODE_ARCH = "mamba2-2.7b"
DRY_TABLE_S, DRY_TABLE_JOBS = 120.0, 8
# the steps read on the card for the dry run, by name: (config, kind,
# batch, seq, optimizer config, `memory_reading`), filled by their phases
# and held to their counts in the dry run's phase
DRY_STEPS = {}
# flash against its plain version, max over rows of ||o - r|| / ||r||,
# about twice (bf16) and seven times (float32) the largest reading of the
# sound kernels, 4.6e-3 and 1.4e-6 (PERF.md §6)
ROW_REL_LIMIT = {"bfloat16": 1e-2, "float32": 1e-5}


class _Bounds:
    """`repro_torch.analysis.bounds` (the work, bytes and bound of each LM
    kernel's call, the formulas the meta lanes book by), imported at first
    use: the tools import this script and then put another checkout's
    src/ first on the path."""

    def __getattr__(self, name):
        from repro_torch.analysis import bounds as module
        return getattr(module, name)


bounds = _Bounds()


@contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over `reps` calls after a warm-up,
    from CUDA events. The calls are queued behind a 20 ms device sleep, so
    the card runs them back to back even where a call's host time exceeds
    its device time (a kernel of ~0.02 ms behind a wrapper of ~0.03 ms
    would otherwise read the host's rate)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cycle_index(fn, n):
    """A callable that calls fn(i) with i = 0, 1, .., n - 1, 0, .. in
    turn."""
    state = {"i": 0}

    def call():
        i = state["i"] % n
        state["i"] += 1
        return fn(i)
    return call


def host_us(fn, calls=200):
    """Host microseconds a call of fn() over `calls` back-to-back calls
    (perf_counter; the card runs behind, and `calls` stays well inside the
    launch queue, so the host never waits on it)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bound(blocks, blk_count, x, y):
    """Least time (ms) for one block product on these operands, over what
    they need: the real slots' blocks and block columns, the counts, x and
    y, each moved once at the HBM rate, against the real slots' f32 FMAs at
    the CUDA-core peak. Returns (ms, bound_by, real bytes, layout bytes);
    layout bytes count the padded (nbr, K) blocks and block columns
    instead, all a kernel without the counts would read."""
    nbr, K, bm, bn = blocks.shape
    real = int(blk_count.sum())
    xy = x.numel() * x.element_size() + y.numel() * y.element_size()
    real_bytes = real * (bm * bn * 4 + 4) + nbr * 4 + xy
    layout_bytes = nbr * K * (bm * bn * 4 + 4) + xy
    flops = 2.0 * real * bm * bn * x.shape[2]
    return (*bounds.roofline_ms(flops, real_bytes, "float32"), real_bytes,
            layout_bytes)


def library_bsr_call(blocks, blk_cols, x, blk_count=None):
    """One PyTorch call computing the same f32 product: the layout viewed
    as a sparse BSR tensor times the dense iterate. Without counts it holds
    the padded layout (K blocks per block-row, padded slots zero blocks at
    column 0); with them, a compacted copy of the real slots only."""
    import torch
    nbr, K, bm, bn = blocks.shape
    nbc, _, nv = x.shape
    if blk_count is None:
        crow = torch.arange(0, nbr * K + 1, K, dtype=torch.int32,
                            device=blocks.device)
        cols, vals = blk_cols.reshape(-1), blocks.reshape(nbr * K, bm, bn)
    else:
        real = (torch.arange(K, device=blocks.device)[None, :]
                < blk_count[:, None])
        crow = torch.cat([blk_count.new_zeros(1),
                          blk_count.cumsum(0, dtype=torch.int32)])
        cols, vals = blk_cols[real], blocks[real]
    a = torch.sparse_bsr_tensor(crow, cols, vals, size=(nbr * bm, nbc * bn),
                                check_invariants=False)
    xf = x.reshape(nbc * bn, nv)
    return lambda: a @ xf


def kahan_replay_layout(n_rows=16, bm=8, real=4, pad=3, seed=0):
    """A packed layout on which Kahan's zero-product steps past the real
    slots move the sum (tests/test_torch_gpu.py has the same): one nonzero
    per block row at its diagonal, x all ones, so each slot's product is
    exact; the sequences whose float32 Kahan sum over all slots differs
    from the one over the real slots fill the first elements. Returns
    numpy (blocks, blk_cols, x, counts)."""
    import numpy as np

    def kahan32(prods):
        acc = np.zeros(prods.shape[:-1], np.float32)
        comp = np.zeros_like(acc)
        for k in range(prods.shape[-1]):
            y = prods[..., k] - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
        return acc

    rng = np.random.default_rng(seed)
    cand = (rng.standard_normal((4096, real))
            * 10.0 ** rng.integers(-4, 5, (4096, real))).astype(np.float32)
    moved = kahan32(np.pad(cand, ((0, 0), (0, pad)))) != kahan32(cand)
    seqs = np.concatenate([cand[moved], cand[~moved]])[:n_rows * bm]
    blocks = np.zeros((n_rows, real + pad, bm, bm), np.float32)
    diag = np.arange(bm)
    blocks[:, :real, diag, diag] = seqs.reshape(n_rows, bm, real).transpose(
        0, 2, 1)
    blk_cols = np.zeros((n_rows, real + pad), np.int32)
    blk_cols[:, :real] = np.arange(real)
    counts = np.full(n_rows, real, np.int32)
    return blocks, blk_cols, np.ones((real, bm, 1), np.float32), counts


def random_csr(rng, n_rows, n_cols, mean_deg, long_rows=()):
    """Row-sorted edges with an indptr (Poisson row lengths, so many empty
    rows at a small mean), then each (row, length) of `long_rows` set.
    Returns numpy (indptr, src, weights, row ids)."""
    import numpy as np
    deg = rng.poisson(mean_deg, n_rows)
    for r, length in long_rows:
        deg[r] = length
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    nnz = int(indptr[-1])
    src = rng.integers(0, n_cols, nnz).astype(np.int32)
    w = rng.random(nnz) / np.maximum(1, rng.integers(1, 50, nnz))
    return indptr, src, w, np.repeat(np.arange(n_rows), deg).astype(np.int32)


def csr_within_bound(y, y_ref, rows, src, w, x, nnz_r):
    """The CSR kernel's y against its plain version's: float64 within
    1e-12 of max |y| (at least 1e-12); float32 row by row within
    4 nnz_r 2^-24 sum |w x|, the worst case of two float32 sums of the same
    terms in two orders. Returns (ok, max |y - y_ref|)."""
    import torch
    from repro_torch.kernels.csr_spmv import csr_spmv_ref
    diff = (y.double() - y_ref.double()).abs()
    if y.dtype == torch.float64:
        ok = float(diff.max()) <= 1e-12 * max(1.0, float(y_ref.abs().max()))
    else:
        absum = csr_spmv_ref(rows, src, w.double().abs(), x.double().abs(),
                             y.shape[0])
        nnz_r = nnz_r if y.ndim == 1 else nnz_r[:, None]
        ok = bool((diff <= 4 * nnz_r * 2.0 ** -24 * absum).all())
    return ok, float(diff.max())


def ulps_apart(a, b):
    """|a - b| in units of the float32 spacing at max(|a|, |b|)."""
    import torch
    m = torch.maximum(a.abs(), b.abs())
    return (a - b).abs() / (torch.nextafter(m, torch.full_like(
        m, float("inf"))) - m)


def hub_lane_against_plain(indptr, src, w, x, row_map, y0):
    """The CSR kernel's hub lane (float64 sums added into y[row_map] in
    place) against its plain version (the float64 sum rounded to float32
    and added): (float32 ulps apart at most, max |kernel - plain|, same
    bits run to run, lane j = its 1-wide call, rows outside row_map
    untouched)."""
    import torch
    from repro_torch.kernels.csr_spmv import (csr_spmv_hub_add,
                                              csr_spmv_hub_add_ref)
    y = csr_spmv_hub_add(indptr, src, w, x, row_map, y0.clone())
    ref = csr_spmv_hub_add_ref(indptr, src, w, x, row_map, y0.clone())
    same = torch.equal(y, csr_spmv_hub_add(indptr, src, w, x, row_map,
                                           y0.clone()))
    lanes = all(torch.equal(csr_spmv_hub_add(
        indptr, src, w, x[:, j:j + 1].contiguous(), row_map,
        y0[:, j:j + 1].contiguous())[:, 0], y[:, j])
        for j in range(x.shape[1]))
    keep = torch.ones(y0.shape[0], dtype=torch.bool, device=y0.device)
    keep[row_map.long()] = False
    torch.cuda.synchronize()
    return (float(ulps_apart(y, ref).max()), float((y - ref).abs().max()),
            same, lanes, torch.equal(y[keep], y0[keep]))


# edges a block of the CSR kernel owns (csr_spmv.cu's kChunk)
CSR_E = 2048
CSR_CASES = [  # (n_rows, n_cols, mean in-degree, (row, length) overrides)
    (1, 1, 0.0, ()), (33, 50, 3.0, ()), (4000, 3000, 0.7, ()),
    (2000, 5000, 8.0, ((666, 79_727),)), (281_903, 281_903, 8.2, ()),
    # rows of exactly E edges and E - 1, E + 1 on chunk boundaries, an
    # empty row at a chunk's edge, empty rows at the end
    (12, 300, 0.0, ((0, CSR_E), (1, CSR_E - 1), (2, 1), (3, CSR_E + 1),
                    (4, CSR_E - 1), (6, CSR_E), (7, 2))),
    # rows spanning 1, 2 and 101 chunks among short ones
    (5000, 5000, 8.0, ((100, 100 * CSR_E + 17), (2000, CSR_E + 500),
                       (3000, CSR_E))),
    # an empty row at every chunk edge and at the end
    (100, 700, 0.0, tuple((r, 256) for r in range(0, 100, 2))),
    (10, 10, 0.0, ()),                                  # nnz = 0
]


def csr_against_plain(cuda):
    """The CSR segment-sum kernel against its plain version on the card,
    run to run and lane by lane, on random cases and on cases built round
    its chunks of CSR_E edges and the hub lane's of 512
    (`kernels/csr_spmv/hub_cases.py`); then its hub lane on the same
    cases. Returns the largest |kernel - plain| per lane ("f32", "f64",
    "hub")."""
    import numpy as np
    import torch
    from repro_torch.kernels.csr_spmv import (csr_spmv, csr_spmv_ref,
                                              hub_counts)
    from repro_torch.kernels.csr_spmv.hub_cases import HUB_CASES
    worst = {"f32": 0.0, "f64": 0.0, "hub": 0.0}
    for n_rows, n_cols, deg, long_rows in CSR_CASES + HUB_CASES:
        rng = np.random.default_rng(n_rows)
        indptr_np, src_np, w_np, rows_np = random_csr(rng, n_rows, n_cols,
                                                      deg, long_rows)
        indptr = torch.as_tensor(indptr_np, device=cuda)
        src = torch.as_tensor(src_np, device=cuda)
        rows = torch.as_tensor(rows_np, device=cuda)
        nnz_r = torch.as_tensor(np.diff(indptr_np), device=cuda)
        for dt, lane in ((torch.float32, "f32"), (torch.float64, "f64")):
            w = torch.as_tensor(w_np, device=cuda).to(dt)
            x8 = torch.as_tensor(rng.random((n_cols, 8)), device=cuda).to(dt)
            for nv in (1, 3, 8, 16):
                x = (x8[:, :nv].contiguous() if nv <= 8 else
                     torch.cat([x8, x8.flip(1)], 1).contiguous())
                y = csr_spmv(indptr, src, w, x, n_rows)
                y_ref = csr_spmv_ref(rows, src, w, x, n_rows)
                ok, err = csr_within_bound(y, y_ref, rows, src, w, x, nnz_r)
                same = torch.equal(y, csr_spmv(indptr, src, w, x, n_rows))
                lanes = all(torch.equal(
                    csr_spmv(indptr, src, w, x[:, j].contiguous(), n_rows),
                    y[:, j]) for j in range(nv))
                torch.cuda.synchronize()
                worst[lane] = max(worst[lane], err)
                check(ok and same and lanes,
                      f"csr {n_rows}x{n_cols} nnz={len(src_np)} "
                      f"{lane} nv={nv}: max |kernel - plain| = "
                      f"{err:.3g} ("
                      f"{'1e-12 relative' if lane == 'f64' else 'the per-row float32 reorder bound'}), "
                      f"two runs identical, each lane = its 1-wide call")
        # the hub lane: these rows added into distinct rows of a wider y
        w = torch.as_tensor(w_np, device=cuda).float()
        row_map = torch.as_tensor(np.sort(rng.choice(
            3 * n_rows + 5, n_rows, replace=False)).astype(np.int32),
            device=cuda)
        for nv in (1, 3, 8):
            x = torch.as_tensor(rng.random((n_cols, nv)), device=cuda).float()
            y0 = torch.as_tensor(rng.random((3 * n_rows + 5, nv)),
                                 device=cuda).float()
            ulps, err, same, lanes, kept = hub_lane_against_plain(
                indptr, src, w, x, row_map, y0)
            worst["hub"] = max(worst["hub"], err)
            zero = int(hub_counts(cuda).abs().sum()) == 0
            check(ulps <= 1.0 and same and lanes and kept and zero,
                  f"csr hub lane {n_rows}x{n_cols} nnz={len(src_np)} "
                  f"nv={nv}: {ulps:.3g} float32 ulps from the float64 plain "
                  f"sum (<= 1), two runs identical, each lane = its 1-wide "
                  f"call, other rows untouched, the workspace's counts back "
                  f"at zero")
    return worst


def csr_bound(dev, x, y, n_rows):
    """Least time (ms) for one CSR product: indptr, src, weights, x and y
    each moved once at the HBM rate, against 2 flops per edge and lane at
    the CUDA-core peak of x's type. Returns (ms, bound_by)."""
    nv = 1 if x.ndim == 1 else x.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in
                 (dev["indptr"], dev["src"], dev["weight"], x, y))
    flops = 2.0 * dev["src"].numel() * nv
    return bounds.roofline_ms(flops, nbytes, str(x.dtype)[6:])


def library_csr_call(dev, x, n_rows):
    """One PyTorch call computing the same product: the edge list as a
    sparse CSR tensor times the dense x (a yardstick, never the port's
    path)."""
    import torch
    a = torch.sparse_csr_tensor(dev["indptr"], dev["src"].long(),
                                dev["weight"], size=(n_rows, x.shape[0]),
                                check_invariants=False)
    xm = x if x.ndim == 2 else x[:, None]
    return lambda: a @ xm


def spmd_main_path(op, exact, exact8, v8, smi):
    """The shard program on Stanford-Web through `solve_spmd`, p = 4 shards
    on one card. Returns (results by run, launches of each kernel over the
    phase)."""
    import numpy as np
    import torch
    from repro_torch.core import SPMDConfig, kendall_tau_topk, solve_spmd
    from repro_torch.kernels.bsr_spmv import LAUNCHES
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR_LAUNCHES

    tols = {}
    for what, ref in (("global", exact), ("lanes", exact8)):
        rank = float(ref.max())
        gap = float(np.spacing(np.float32(rank)))
        tols[what] = SPMD_TOL_MARGIN * gap
        print(f"  {what}: largest rank {rank:.6g} at page "
              f"{int(ref.argmax()) % op.n}, float32 spacing {gap:.4g}: "
              f"inf-norm tol {tols[what]:.4g}")

    def held(x, ref, what):
        l1 = float(np.abs(x - ref).sum())
        tau = kendall_tau_topk(x, ref, k=100)
        check(l1 <= 1e-5 and tau >= 0.999,
              f"{what}: L1 err {l1:.3g} <= 1e-5, top-100 tau {tau:.6f} >= "
              f"0.999")

    def report(name, r):
        c = r.chunk_log
        steps = sum(x["steps"] for x in c)
        per = {k: sum(x[f"{k}_ms"] for x in c) / steps
               for k in ("wall", "apply", "exchange", "protocol", "gap")}
        print(f"  {name}: {r.supersteps} supersteps, "
              f"{per['wall']:.4f} ms per superstep (apply "
              f"{per['apply']:.4f}, exchange {per['exchange']:.4f}, "
              f"protocol {per['protocol']:.4f}, host gap {per['gap']:.4f}; "
              f"CUDA-event spans), comm_bytes_total {r.comm_bytes_total:,}, "
              f"rows_sent {r.rows_sent:,}, chunks {r.lane_chunks} [{smi}]")
        return per

    for counts in (LAUNCHES, CSR_LAUNCHES):
        for k in counts:
            counts[k] = 0
    out = {}
    for sched in SPMD_SCHEDULES:
        cfg = SPMDConfig(p=SPMD_P, schedule=sched, backend="bsr",
                         tol=tols["global"], max_supersteps=3000)
        before, hub_before = LAUNCHES["f32"], CSR_LAUNCHES["hub"]
        t0 = time.perf_counter()
        r = solve_spmd(op, cfg, observe=True)
        torch.cuda.synchronize()
        print(f"  {sched}: {time.perf_counter() - t0:.2f} s (first use "
              f"packs the shards)")
        per = report(f"bsr {sched}", r)
        check(LAUNCHES["f32"] - before == r.supersteps + 1
              == CSR_LAUNCHES["hub"] - hub_before
              and r.supersteps < 3000,
              f"bsr {sched}: the block kernel and the CSR kernel's hub lane "
              f"launched {LAUNCHES['f32'] - before} times each = "
              f"{r.supersteps} supersteps + 1 final residual, one launch "
              f"for all {SPMD_P} shards")
        held(r.x, exact, f"bsr {sched}")
        out[sched] = (r, per)
    cfg = SPMDConfig(p=SPMD_P, schedule="allgather", backend="bsr",
                     tol=tols["lanes"], max_supersteps=2000,
                     pc_max_monitor=SPMD_LANE_PC_MAX, freeze_lanes=True,
                     compact_lanes=True)
    before = LAUNCHES["f32"]
    r = solve_spmd(op, cfg, v=v8, observe=True)
    per = report(f"bsr allgather, 8 lanes, freeze + compact, monitor "
                 f"pcMax {SPMD_LANE_PC_MAX}", r)
    print(f"    lane_supersteps {r.lane_supersteps.tolist()}, chunk lanes "
          f"{[c['lanes'] for c in r.chunk_log]}")
    check(LAUNCHES["f32"] - before == r.supersteps + r.lane_chunks,
          f"lanes: {LAUNCHES['f32'] - before} block launches = "
          f"{r.supersteps} supersteps + {r.lane_chunks} chunk residuals")
    for j in range(v8.shape[1]):
        held(r.x[:, j], exact8[:, j], f"lane {j}")
    out["lanes"] = (r, per)
    runs = []
    for k in range(2):
        cfg = SPMDConfig(p=SPMD_P, schedule="allgather",
                         backend="segment_sum", tol=tols["global"],
                         max_supersteps=3000)
        before = CSR_LAUNCHES["f32"]
        r = solve_spmd(op, cfg, observe=True)
        per = report(f"segment_sum allgather f32, run {k + 1}", r)
        check(CSR_LAUNCHES["f32"] - before == r.supersteps + 1,
              f"segment_sum: the CSR kernel launched "
              f"{CSR_LAUNCHES['f32'] - before} times = {r.supersteps} "
              f"supersteps + 1")
        held(r.x, exact, f"segment_sum run {k + 1}")
        runs.append(r)
    out["segment_sum"] = (runs[0], per)
    check(runs[0].supersteps == runs[1].supersteps
          and np.array_equal(runs[0].x, runs[1].x),
          f"segment_sum float32, two runs: {runs[0].supersteps} supersteps "
          f"each, x identical bit for bit")
    launches = {"bsr_f32": LAUNCHES["f32"], "csr_f32": CSR_LAUNCHES["f32"],
                "csr_hub": CSR_LAUNCHES["hub"]}
    print(f"  shard program launches: {launches}")
    out["tol"] = tols["global"]
    return out, launches


def csr_timing(op, cuda, smi, hub_dev):
    """The CSR segment-sum kernel at Stanford-Web against its plain
    version, PyTorch's sparse CSR product and the bound, in float32 and
    float64 at nv in {1, 8}, with the wrapper's host time a call; then the
    hub row alone and the rest; then the hub lane at the main path's hub
    rows (`hub_dev`, the bm = 8 layout on the card) against the COO side it
    replaced. Returns {(lane, nv): row} and the hub lane's row under
    ("hub", 1)."""
    import numpy as np
    import torch
    from repro_torch.kernels.csr_spmv import (csr_spmv, csr_spmv_hub_add,
                                              csr_spmv_hub_add_ref,
                                              csr_spmv_ref)
    n = op.n
    rows = {}
    nnz_r = torch.as_tensor(np.diff(op.pt.indptr), device=cuda)
    for dt, lane in ((torch.float32, "f32"), (torch.float64, "f64")):
        dev = op.pt.device_arrays(dt, cuda)
        g = torch.Generator(device=cuda).manual_seed(7)
        for nv in (1, 8):
            x = torch.rand((n, nv), generator=g, device=cuda, dtype=dt)
            x = x[:, 0].contiguous() if nv == 1 else x
            args = (dev["indptr"], dev["src"], dev["weight"], x, n)
            y = csr_spmv(*args)
            y_ref = csr_spmv_ref(dev["row_ids"], dev["src"], dev["weight"],
                                 x, n)
            lib = library_csr_call(dev, x, n)
            ok, err = csr_within_bound(y, y_ref, dev["row_ids"], dev["src"],
                                       dev["weight"], x, nnz_r)
            check(ok and torch.equal(y, csr_spmv(*args)),
                  f"csr {lane} nv={nv} at Stanford-Web: max |kernel - "
                  f"plain| = {err:.3g} (" + ("1e-12 relative" if lane == "f64"
                                             else "the per-row float32 "
                                             "reorder bound") +
                  "), two runs identical")
            lib_err = float((lib().reshape(y.shape) - y_ref).abs().max())
            t = {"kernel": cuda_ms(lambda: csr_spmv(*args), 20),
                 "plain": cuda_ms(lambda: csr_spmv_ref(
                     dev["row_ids"], dev["src"], dev["weight"], x, n), 20),
                 "library": cuda_ms(lib, 20),
                 "host_us": host_us(lambda: csr_spmv(*args))}
            b_ms, b_by = csr_bound(dev, x, y, n)
            print(f"  csr {lane} nv={nv} (n={n}, nnz={dev['src'].numel()}): "
                  f"kernel {t['kernel']:.4f} ms, plain index_add_ "
                  f"{t['plain']:.4f} ms, sparse CSR call {t['library']:.4f} "
                  f"ms (|diff| {lib_err:.3g}), bound {b_ms:.4f} ms "
                  f"({b_by}); kernel at {100 * b_ms / t['kernel']:.1f}% of "
                  f"bound, max |kernel - plain| {err:.3g}; wrapper host "
                  f"{t['host_us']:.2f} us a call [{smi}]")
            rows[(lane, nv)] = dict(t, bound_ms=b_ms, bound_by=b_by, err=err)
    # the hub row (79,727 in-links, 39 chunks) against the rest of the rows
    pt = op.pt
    deg = np.diff(pt.indptr)
    hub = int(deg.argmax())
    lo, hi = int(pt.indptr[hub]), int(pt.indptr[hub + 1])
    dev = op.pt.device_arrays(torch.float32, cuda)
    x = torch.rand(n, device=cuda)
    hub_args = (torch.tensor([0, hi - lo], device=cuda),
                dev["src"][lo:hi].contiguous(),
                dev["weight"][lo:hi].contiguous(), x, 1)
    keep = np.ones(pt.nnz, bool)
    keep[lo:hi] = False
    rest_ptr = pt.indptr.copy()
    rest_ptr[hub + 1:] -= hi - lo
    rest_args = (torch.as_tensor(rest_ptr, device=cuda),
                 dev["src"][torch.as_tensor(keep, device=cuda)],
                 dev["weight"][torch.as_tensor(keep, device=cuda)], x, n)
    t_hub = cuda_ms(lambda: csr_spmv(*hub_args), 20)
    t_rest = cuda_ms(lambda: csr_spmv(*rest_args), 20)
    print(f"  csr f32 nv=1: hub row {hub} alone ({hi - lo:,} in-links, "
          f"{-(-(hi - lo) // CSR_E)} chunks) {t_hub:.4f} ms; every other row "
          f"(its in-links removed) {t_rest:.4f} ms [{smi}]")
    # the block backend's hub rows: the hub lane against the old COO side
    n_hub = hub_dev["hub_map"].numel()
    nnz_h = hub_dev["hub_cols"].numel()
    nbr, _, bm, bn = hub_dev["blocks"].shape
    out_rows = in_rows = nbr * bm     # P^T is square, and bm = bn
    # the old COO side's destination row of each edge, and the rows of x
    # the lane reads (the bound counts those, not all of x)
    hub_rows = torch.repeat_interleave(
        hub_dev["hub_map"], torch.diff(hub_dev["hub_indptr"]))
    n_src = int(torch.unique(hub_dev["hub_cols"]).numel())

    def old_side(x3, y3):
        """The hub side before the hub lane: float64 products gathered by
        column, an `index_add_` over the padded row space (atomic order
        on the card), the sums rounded to float32 and added."""
        k = y3.shape[-1]
        contrib = hub_dev["hub_vals"].double()[:, None] * x3.reshape(
            -1, k).double().index_select(0, hub_dev["hub_cols"])
        hub = contrib.new_zeros((out_rows, k)).index_add_(0, hub_rows,
                                                          contrib)
        return y3 + hub.reshape(y3.shape).to(y3.dtype)
    g = torch.Generator(device=cuda).manual_seed(11)
    for nv in (1, 8):
        x = torch.rand((in_rows, nv), generator=g, device=cuda)
        y0 = torch.rand((out_rows, nv), generator=g, device=cuda)
        args = (hub_dev["hub_indptr"], hub_dev["hub_cols"],
                hub_dev["hub_vals"], x)
        ulps, err, same, lanes, kept = hub_lane_against_plain(
            *args, hub_dev["hub_map"], y0)
        check(ulps <= 1.0 and same and lanes and kept,
              f"csr hub lane nv={nv} at Stanford-Web's {n_hub:,} hub rows "
              f"({nnz_h:,} in-links): {ulps:.3g} float32 ulps from the "
              f"float64 plain sum (<= 1), two runs identical, each lane = "
              f"its 1-wide call, other rows untouched")
        y = y0.clone()
        x3 = x.reshape(-1, bn, nv)
        y3 = y0.reshape(-1, bm, nv)
        t = {"kernel": cuda_ms(lambda: csr_spmv_hub_add(
                 *args, hub_dev["hub_map"], y), 20),
             "plain": cuda_ms(lambda: csr_spmv_hub_add_ref(
                 *args, hub_dev["hub_map"], y), 20),
             "old_side": cuda_ms(lambda: old_side(x3, y3), 20),
             "host_us": host_us(lambda: csr_spmv_hub_add(
                 *args, hub_dev["hub_map"], y))}
        each = profiled_kernels(lambda: csr_spmv_hub_add(
            *args, hub_dev["hub_map"], y))
        # indptr, cols, vals and row_map once, the rows of x the hub rows
        # name once, y's hub rows read and written
        nbytes = (sum(a.numel() * a.element_size() for a in
                      (*args[:3], hub_dev["hub_map"]))
                  + n_src * nv * x.element_size()
                  + 2 * n_hub * nv * y.element_size())
        b_ms, b_by = bounds.roofline_ms(2.0 * nnz_h * nv, nbytes, "float64")
        print(f"  csr hub lane nv={nv} ({n_hub:,} rows, {nnz_h:,} in-links "
              f"from {n_src:,} distinct rows of x, "
              f"f32 in, f64 sum, into y in place): kernel {t['kernel']:.4f} "
              f"ms, plain CSR index_add_ {t['plain']:.4f} ms, the old COO "
              f"side (f64 index_select + index_add_ over the padded rows, "
              f"cast and add) {t['old_side']:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); wrapper host {t['host_us']:.2f} us a call; "
              f"{ulps:.3g} ulps; launches a call: "
              + ", ".join(f"{k} x {v['launches']:g} ({v['ms']:.4f} ms)"
                          for k, v in each.items()) + f" [{smi}]")
        rows[("hub", nv)] = dict(t, bound_ms=b_ms, bound_by=b_by, err=err)
    return rows


def folded_timing(op, cuda, smi):
    """The shard program's one block launch over the p shards' folded
    block rows against p per-shard launches, at nv in {1, 8}."""
    import numpy as np
    import torch
    from repro_torch.core import SPMDConfig
    from repro_torch.core.partition import block_rows
    from repro_torch.core.spmd import _pack_structure
    from repro_torch.kernels.bsr_spmv import (DEFAULT_BM, bsr_spmv,
                                              bsr_spmv_ref)
    bm = DEFAULT_BM
    packed = _pack_structure(op, block_rows(op.n, SPMD_P),
                             SPMDConfig(p=SPMD_P, backend="bsr"),
                             np.dtype("float32"), bm)
    bsize, n_pad = packed["bsize"], packed["n_pad"]
    blocks = torch.as_tensor(packed["blocks"], device=cuda)
    cols = torch.as_tensor(packed["blk_cols"], device=cuda)
    count = torch.as_tensor(packed["blk_count"], device=cuda)
    nbr_l, nbc_l = bsize // bm, n_pad // bm
    out = {}
    for nv in (1, 8):
        views = torch.rand((SPMD_P * nbc_l, bm, nv), device=cuda)
        y = bsr_spmv(blocks, cols, views, blk_count=count)
        y_ref = bsr_spmv_ref(blocks, cols, views)
        err = float((y - y_ref).abs().max())
        check(err <= 1e-5 * float(y_ref.abs().max()),
              f"folded launch at nv={nv} (the shard program's layout): "
              f"kernel against plain {err:.3g}")
        shards = [(blocks[i * nbr_l:(i + 1) * nbr_l],
                   (cols[i * nbr_l:(i + 1) * nbr_l] - i * nbc_l).contiguous(),
                   views[i * nbc_l:(i + 1) * nbc_l],
                   count[i * nbr_l:(i + 1) * nbr_l])
                  for i in range(SPMD_P)]
        same = all(torch.equal(y[i * nbr_l:(i + 1) * nbr_l],
                               bsr_spmv(b, c, v, blk_count=k))
                   for i, (b, c, v, k) in enumerate(shards))
        t_fold = cuda_ms(lambda: bsr_spmv(blocks, cols, views,
                                          blk_count=count), 20)

        def per_shard():
            for b, c, v, k in shards:
                bsr_spmv(b, c, v, blk_count=k)
        t_sep = cuda_ms(per_shard, 20)
        b_ms, b_by, _, _ = bound(blocks, count, views, y)
        check(same, f"folded launch at nv={nv}: every shard's rows equal "
              f"its own launch bit for bit")
        print(f"  folded block launch p={SPMD_P} nv={nv} ({blocks.shape[0]} "
              f"block rows, K={blocks.shape[1]}): {t_fold:.4f} ms, "
              f"{SPMD_P} per-shard launches {t_sep:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) [{smi}]")
        out[nv] = (t_fold, t_sep, b_ms, err)
    return out


def spmd_tol_sweep(op, exact, exact8, v8, tol, lanes_x, smi):
    """Why the main path's tolerances: allgather at a looser inf-norm tol
    and the lanes without the monitor's persistence, held to nothing,
    their L1 errors printed beside the main path's settings; then the
    main path's lane run repeated, each repeat's worst lane L1 printed and
    its x compared with the main path's (`lanes_x`) bit for bit."""
    import numpy as np
    from repro_torch.core import SPMDConfig, solve_spmd
    for t in (1e-8, tol):
        r = solve_spmd(op, SPMDConfig(p=SPMD_P, backend="bsr", tol=t))
        print(f"  bsr allgather at tol {t:.4g}: {r.supersteps} supersteps, "
              f"L1 err {np.abs(r.x - exact).sum():.3g} [{smi}]")
    for pc, runs in ((1, 1), (SPMD_LANE_PC_MAX, SPMD_LANE_REPEATS)):
        for k in range(runs):
            r = solve_spmd(op, SPMDConfig(
                p=SPMD_P, backend="bsr", tol=SPMD_TOL_MARGIN * float(
                    np.spacing(np.float32(exact8.max()))),
                pc_max_monitor=pc, freeze_lanes=True, compact_lanes=True),
                v=v8)
            l1 = np.abs(r.x - exact8).sum(axis=0)
            print(f"  8 lanes, monitor pcMax {pc}, run {k + 1}: "
                  f"{r.supersteps} supersteps, L1 err per lane max "
                  f"{l1.max():.4g} (lane {int(l1.argmax())}) [{smi}]")
            if pc == SPMD_LANE_PC_MAX:
                check(np.array_equal(r.x, lanes_x),
                      f"8 lanes, run {k + 1}: x identical to the main "
                      f"path's bit for bit (no atomic order left on the "
                      f"bsr path)")


def reset_launches():
    """Every kernel's launch counts set to 0 (before a main path)."""
    from repro_torch.kernels.bsr_spmv import LAUNCHES
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR_LAUNCHES
    for counts in (LAUNCHES, CSR_LAUNCHES):
        for k in counts:
            counts[k] = 0


def des_main_path(op, exact, smi):
    """The paper's experiment (Tables 1-2): the discrete-event simulation on
    Stanford-Web through `AsyncFixedPoint.solve_des_sync` / `solve_des` at
    p in DES_PROCS, every block update on the card (the CSR kernel's
    float64 lane), beside the paper's values; at p = 4 the port's CPU run
    of the same configuration beside the card's. Returns the CSR kernel's
    float64 launches over the card's runs."""
    import numpy as np
    import torch
    from repro_torch.configs.pagerank import paper_des_config
    from repro_torch.core import (AsyncDES, AsyncFixedPoint,
                                  PageRankBlockOperator, kendall_tau_topk)
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR_LAUNCHES

    afp = AsyncFixedPoint(op, kind="power")
    c = paper_des_config()
    print(f"  paper_des_config(): tol {c.tol}, norm {c.norm}, "
          f"barrier_overhead {c.barrier_overhead}, seed {c.seed}; kind "
          f"power, block partition [{smi}]")

    def tau_ok(x, what):
        tau = kendall_tau_topk(x, exact, k=100)
        l1 = float(np.abs(x - exact).sum())
        check(tau >= 0.999, f"{what}: top-100 tau {tau:.6f} >= 0.999 "
              f"(L1 err {l1:.3g})")

    reset_launches()
    runs = {}
    for p in DES_PROCS:
        before = CSR_LAUNCHES["f64"]
        t0 = time.perf_counter()
        s = afp.solve_des_sync(p, paper_des_config())
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        n_sync = CSR_LAUNCHES["f64"] - before
        check(n_sync == s.iters * p,
              f"p={p} sync: the CSR kernel launched {n_sync} times = "
              f"{s.iters} iterations x {p} block updates")
        before = CSR_LAUNCHES["f64"]
        t0 = time.perf_counter()
        a = afp.solve_des(p, paper_des_config())
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        n_async = CSR_LAUNCHES["f64"] - before
        updates = int(a.iters.sum())
        check(n_async == updates,
              f"p={p} async: the CSR kernel launched {n_async} times = "
              f"{updates} block updates (iter events)")
        speedup = s.time / max(float(a.local_conv_time.max()), 1e-9)
        paper = PAPER_TABLE1[p]
        print(f"  p={p}: sync {s.iters} iters, {s.time:.1f} sim s "
              f"(paper {paper['sync_iters']}, {paper['sync_t']}) | async "
              f"iters {int(a.iters.min())}-{int(a.iters.max())} (paper "
              f"{paper['async_iters'][0]}-{paper['async_iters'][1]}), local "
              f"convergence {a.local_conv_time.min():.1f}-"
              f"{a.local_conv_time.max():.1f} sim s (paper "
              f"{paper['async_t'][0]}-{paper['async_t'][1]}) | speedup "
              f"{speedup:.2f} (paper {paper['speedup']}) | completed "
              f"imports {np.round(a.completed_import_pct).astype(int).tolist()}"
              f" % | global resid inf {a.global_resid_inf:.3g}")
        print(f"    wall: sync {wall_s:.3f} s ({s.iters * p / wall_s:.1f} "
              f"block updates/s), async {wall_a:.3f} s "
              f"({updates / wall_a:.1f} block updates/s, {updates} updates, "
              f"stop at {a.stop_time:.1f} sim s) [{smi}]")
        tau_ok(s.x, f"p={p} sync")
        tau_ok(a.x, f"p={p} async")
        runs[p] = dict(sync=s, asyn=a, wall_sync=wall_s, wall_async=wall_a)
    launches = CSR_LAUNCHES["f64"]
    print(f"  DES launches on the card: {dict(CSR_LAUNCHES)}")

    a = runs[4]["asyn"]
    mat = a.imports.copy()
    np.fill_diagonal(mat, a.iters)
    print("  Table 2, p=4 (imports; diagonal = local iterations):")
    for r in mat:
        print("    " + " ".join(f"{v:5d}" for v in r))
    print(f"  completed imports % {np.round(a.completed_import_pct, 1).tolist()}"
          f" (paper {PAPER_TABLE2_PCT})")

    t0 = time.perf_counter()
    c = afp.solve_des(4, paper_des_config(), device="cpu")
    wall_c = time.perf_counter() - t0
    l1 = float(np.abs(a.x - c.x).sum())
    print(f"  p=4 card vs CPU (plain path, {wall_c:.2f} s): iters "
          f"{a.iters.tolist()} / {c.iters.tolist()}, imports "
          f"{int(a.imports.sum())} / {int(c.imports.sum())}, attempts "
          f"{int(a.attempts.sum())} / {int(c.attempts.sum())}, stop "
          f"{a.stop_time:.6f} / {c.stop_time:.6f} sim s, L1(x_card, x_cpu) "
          f"{l1:.3g}")
    check(l1 <= 1e-6, f"p=4: L1(x_card, x_cpu) {l1:.3g} <= 1e-6")

    # the event loop alone, warm: the block operator built (and its edge
    # slices uploaded) once, and no host residual check at the end
    part = afp.make_partition(4)
    t0 = time.perf_counter()
    opr = PageRankBlockOperator(op, part, kind="power")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    des = lambda: AsyncDES(opr, part, paper_des_config()).run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = des()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    updates = int(r.iters.sum())
    check(r.iters.tolist() == a.iters.tolist(),
          f"p=4 warm event loop: the main path's iters {r.iters.tolist()}")
    print(f"  p=4 warm event loop (operator set-up {setup:.3f} s once): "
          f"{[round(w, 4) for w in walls]} s for {updates} block updates, "
          f"{updates / min(walls):.1f} updates/s at best [{smi}]")
    stats = device_breakdown(des, "AsyncDES.run p=4, warm", smi)
    if stats is not None:
        kernels, busy, wall = stats
        print(f"    {kernels / updates:.1f} kernels per block update "
              f"({updates} updates), card busy {100 * busy / wall:.1f}% "
              f"of the profiled wall")
    return launches, runs


def transport_main_path(op, smi):
    """ROADMAP Queue 1 item 6.1: `DeviceShardTransport.run` on Stanford-Web,
    p = 4 shard programs on the card, draining the linear form from the
    uniform start in four lanes, each certified by a host float64 residual
    ||x - (alpha (P^T x + w d^T x) + (1 - alpha) v)||_1. Returns the
    launches of each kernel over the drains."""
    import numpy as np
    import torch
    from repro_torch.kernels.bsr_spmv import LAUNCHES
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR_LAUNCHES
    from repro_torch.runtime import DeviceShardTransport

    x0 = np.full(op.n, 1.0 / op.n)
    reset_launches()
    out = {}
    for name, kw, target, cert in TRANSPORT_LANES:
        before = {**{f"bsr_{k}": v for k, v in LAUNCHES.items()},
                  **{f"csr_{k}": v for k, v in CSR_LAUNCHES.items()}}
        t0 = time.perf_counter()
        r = DeviceShardTransport(TRANSPORT_P, **kw).run(
            op, x0, target=target, max_supersteps=3000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = {**{f"bsr_{k}": v for k, v in LAUNCHES.items()},
                 **{f"csr_{k}": v for k, v in CSR_LAUNCHES.items()}}
        ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        resid = float(np.abs(op.apply_linear_numpy(r.x) - r.x).sum())
        print(f"  {name}: {r.supersteps} supersteps, rows_sent "
              f"{r.rows_sent:,}, fulls {r.fulls}, comm_bytes_total "
              f"{r.comm_bytes_total:,}, device resid {r.device_resid:.3g}, "
              f"{wall:.3f} s (host clock; a dtype's first drain packs the "
              f"shards), launches {ran} [{smi}]")
        check(r.converged and resid <= cert,
              f"{name}: converged at target {target:g}, host float64 "
              f"residual {resid:.3g} <= {cert:g}")
        lanes = (("csr_f64",) if kw.get("backend") is None else
                 ("bsr_f32" if kw.get("accum") == "f32" else "bsr_kahan",
                  "csr_hub"))
        check(all(ran.get(k, 0) == r.supersteps + 1 for k in lanes)
              and set(ran) == set(lanes),
              f"{name}: {' and '.join(lanes)} launched "
              f"{[ran.get(k, 0) for k in lanes]} times = {r.supersteps} "
              f"supersteps + 1 final residual, one launch for all "
              f"{TRANSPORT_P} shards, and no other kernel")
        out[name] = (r, wall)
    launches = {"bsr_f32": LAUNCHES["f32"], "bsr_kahan": LAUNCHES["kahan"],
                "csr_f64": CSR_LAUNCHES["f64"], "csr_hub": CSR_LAUNCHES["hub"]}
    print(f"  device transport launches: {launches}")
    # warm: the shards packed and uploaded by the runs above
    for name, kw, target, _ in TRANSPORT_LANES:
        run = lambda: DeviceShardTransport(TRANSPORT_P, **kw).run(
            op, x0, target=target, max_supersteps=3000)
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            r = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        steps = r.supersteps
        check(steps == out[name][0].supersteps,
              f"{name}, warm: {steps} supersteps, as on the main path")
        print(f"  {name}, warm: {[round(1e3 * w / steps, 4) for w in walls]}"
              f" ms per superstep (host clock) [{smi}]")
        if name == TRANSPORT_LANES[0][0]:
            stats = device_breakdown(run, f"device transport, {name}", smi)
            if stats is not None:
                kernels, busy, wall = stats
                print(f"    {kernels / steps:.1f} kernels per superstep, "
                      f"card busy {100 * busy / wall:.1f}% of the profiled "
                      f"wall")
    return launches, out


@contextmanager
def timed_calls(targets):
    """Wrap each (owner, attribute, label) so that its calls add their
    host seconds, ending in a synchronize, to totals[label]; the wrappers
    are taken out on exit. A measurement aid of this script only."""
    import torch
    totals = {label: 0.0 for _, _, label in targets}
    saved = []
    for owner, name, label in targets:
        raw = owner.__dict__[name]
        fn = getattr(owner, name)
        if isinstance(owner, type):
            fn = raw                     # a method: wrap the function

        def wrapped(*a, _fn=fn, _label=label, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                totals[_label] += time.perf_counter() - t0
        saved.append((owner, name, raw))
        setattr(owner, name, wrapped)
    try:
        yield totals
    finally:
        for owner, name, raw in saved:
            setattr(owner, name, raw)


def streaming_main_path(g, smi):
    """ROADMAP Queue 1 items 6.2-6.5 on Stanford-Web: a DeltaGraph, its
    certified cold state, a crawl stream through `update_ranks` and a 1%
    batch that falls back to the card's float64 solve (replayed on the
    CPU's plain path from the same cold state), the sharded device drain,
    16 batched personalized queries on both device backends (the host
    scipy path beside them), the rank server inline and threaded, the
    replay and the DES over `StreamingBlockOperator`. Every certificate is
    the host float64 recomputation. Returns the launches of each kernel
    over the card's runs, the final graph, the batched queries' seed sets,
    the cold state's (x, r) and the crawl batches."""
    import threading
    import numpy as np
    import torch
    import repro_torch.core.spmd as spmd_mod
    import repro_torch.streaming.incremental as inc_mod
    import repro_torch.streaming.sharded as sharded_mod
    from repro_torch.configs.pagerank import paper_des_config
    from repro_torch.core import AsyncDES, block_rows
    from repro_torch.core.pagerank import kendall_tau_topk
    from repro_torch.graph.google import GoogleOperator, exact_pagerank
    from repro_torch.kernels.bsr_spmv import LAUNCHES
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR_LAUNCHES
    from repro_torch.runtime import DeviceShardTransport
    from repro_torch.streaming import (DeltaGraph, EdgeDelta, RankServer,
                                       RankState, ReplayConfig,
                                       StreamingBlockOperator, cold_state,
                                       ppr_push_batched, refresh_residual,
                                       replay_trace, synth_edge_trace,
                                       update_ranks, update_ranks_sharded)

    def sync_ms(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    free_cuda()
    mem = {"start": torch.cuda.memory_allocated()}
    reset_launches()

    # 1. the cold state: linear form, float64 segment sum (the CSR kernel's
    # float64 lane once an iteration)
    dg = DeltaGraph(g)
    t0 = time.perf_counter()
    st = cold_state(dg, tol=STREAM_BULK_TOL)
    cold_ms = sync_ms(t0)
    print(f"  cold_state: {cold_ms / 1e3:.3f} s, {CSR_LAUNCHES['f64']} "
          f"iterations (CSR float64 launches), cert {st.cert:.3g} "
          f"(tol {STREAM_BULK_TOL:g}), uploads included [{smi}]")
    check(st.cert <= STREAM_BULK_TOL,
          f"cold state certified: {st.cert:.3g} <= {STREAM_BULK_TOL:g}")
    cold = (st.x.copy(), st.r.copy())
    dg_h = DeltaGraph(g)
    st_h = RankState(x=st.x.copy(), r=st.r.copy(), version=0,
                     alpha=st.alpha)

    # 2. the crawl stream, then a 1% batch that must fall back
    t0 = time.perf_counter()
    trace = synth_edge_trace(dg, **STREAM_TRACE)
    print(f"  synth_edge_trace({STREAM_TRACE}): "
          f"{time.perf_counter() - t0:.2f} s host (a scratch replica; the "
          f"snapshot CSR rebuilt a batch)")
    stream = []
    certs = []
    for k, d in enumerate(trace):
        t0 = time.perf_counter()
        st, s = update_ranks(dg, d, st, tol=STREAM_TOL)
        ms = sync_ms(t0)
        stream.append((s.path, s.pushes, s.nodes_visited))
        certs.append(s.cert <= STREAM_TOL)
        print(f"  batch {k:2d} ({d.size} edges, {d.new_nodes} new nodes): "
              f"{s.path}, pushes {s.pushes}, visited {s.nodes_visited}, "
              f"cert {s.cert:.3g}, {ms:.2f} ms")
        if k == 1:
            mem["after 2 batches"] = torch.cuda.memory_allocated()
    check(all(certs), f"{len(trace)} stream batches certified at "
          f"tol {STREAM_TOL:g} ({sum(p == 'push' for p, _, _ in stream)} "
          f"on the push path)")
    t0 = time.perf_counter()
    bulk = synth_edge_trace(dg, n_batches=1, batch_edges=dg.nnz // 100,
                            seed=5)[0]
    print(f"  the 1% batch's trace: {time.perf_counter() - t0:.2f} s host")
    before = CSR_LAUNCHES["f64"]
    with timed_calls([
            (DeltaGraph, "transition", "P^T splice"),
            (GoogleOperator, "device_arrays", "upload"),
            (inc_mod, "solve_linear", "solve"),
            (inc_mod, "_exact_residual", "exact residual")]) as parts:
        t0 = time.perf_counter()
        st, s = update_ranks(dg, bulk, st, tol=STREAM_BULK_TOL)
        ms = sync_ms(t0)
    mem["after the 1% fallback"] = torch.cuda.memory_allocated()
    rest = ms - 1e3 * sum(parts.values()) + 1e3 * parts["upload"]
    print(f"  1% batch ({bulk.size} edges, {bulk.new_nodes} new nodes): "
          f"{s.path}, {s.solver_iters} iterations ({CSR_LAUNCHES['f64'] - before}"
          f" CSR float64 launches), aborted pushes {s.pushes}, cert "
          f"{s.cert:.3g}, {ms:.1f} ms = P^T splice "
          f"{1e3 * parts['P^T splice']:.1f} + upload "
          f"{1e3 * parts['upload']:.1f} + solve "
          f"{1e3 * (parts['solve'] - parts['upload']):.1f} + exact residual "
          f"{1e3 * parts['exact residual']:.1f} (scipy P^T included) + "
          f"the rest {rest:.1f} (apply, seeding, frontier count) [{smi}]")
    check(s.path == "solve_linear" and s.cert <= STREAM_BULK_TOL
          and CSR_LAUNCHES["f64"] - before == s.solver_iters,
          f"1% batch fell back to the card's solve ({s.solver_iters} CSR "
          f"float64 launches) and certified {s.cert:.3g} <= "
          f"{STREAM_BULK_TOL:g}")
    # the same stream on the CPU's plain path from the card's cold state
    t0 = time.perf_counter()
    same = True
    for (path, pushes, visited), d in zip(stream, trace):
        st_h, s_h = update_ranks(dg_h, d, st_h, tol=STREAM_TOL, device="cpu")
        same &= (s_h.path, s_h.pushes, s_h.nodes_visited) == (path, pushes,
                                                             visited)
    st_h, s_h = update_ranks(dg_h, bulk, st_h, tol=STREAM_BULK_TOL,
                             device="cpu")
    l1 = float(np.abs(st.x - st_h.x).sum())
    print(f"  CPU replay of step 2 ({time.perf_counter() - t0:.2f} s): 1% "
          f"batch {s_h.path}, {s_h.solver_iters} iterations; L1(x_card, "
          f"x_cpu) {l1:.3g}")
    check(same and s_h.path == s.path and l1 <= 1e-9,
          f"CPU replay: every batch's path and push counts equal, "
          f"L1(x_card, x_cpu) {l1:.3g} <= 1e-9")
    del dg_h, st_h

    # 3. the sharded device drain of a further 1% batch
    t0 = time.perf_counter()
    bulk2 = synth_edge_trace(dg, n_batches=1, batch_edges=dg.nnz // 100,
                             seed=6)[0]
    print(f"  the second 1% batch's trace: {time.perf_counter() - t0:.2f} s "
          f"host")
    before = CSR_LAUNCHES["f64"]
    with timed_calls([(DeltaGraph, "transition", "P^T splice"),
                      (DeviceShardTransport, "run", "drain"),
                      (spmd_mod, "_pack_blocks", "pack"),
                      (spmd_mod, "_device_structure", "upload"),
                      (sharded_mod, "_exact_residual", "exact residual")]) \
            as parts:
        t0 = time.perf_counter()
        st, s = update_ranks_sharded(dg, bulk2, st, p=STREAM_P,
                                     mode="async", transport="device",
                                     exchange="sparsified",
                                     tol=STREAM_BULK_TOL)
        ms = sync_ms(t0)
    drain_launches = CSR_LAUNCHES["f64"] - before
    print(f"  sharded device drain, p={STREAM_P}, sparsified, 1% batch "
          f"({bulk2.size} edges): {s.path}, supersteps {s.supersteps}, "
          f"rows_sent {s.rows_sent:,}, fulls {s.fulls}, bytes "
          f"{s.bytes_moved:,}, attempts {s.attempts}, cert {s.cert:.3g}, "
          f"{ms:.1f} ms = P^T splice {1e3 * parts['P^T splice']:.1f} + "
          f"drain {1e3 * parts['drain']:.1f} (packing "
          f"{1e3 * parts['pack']:.1f}, upload {1e3 * parts['upload']:.1f}; "
          f"{1e3 * (parts['drain'] - parts['pack'] - parts['upload']) / s.supersteps:.3f}"
          f" ms a superstep) + exact residuals "
          f"{1e3 * parts['exact residual']:.1f} + the rest "
          f"{ms - 1e3 * (parts['P^T splice'] + parts['drain'] + parts['exact residual']):.1f}"
          f" (apply, seeding), CSR float64 launches {drain_launches} "
          f"[{smi}]")
    check(s.path == "sharded_push" and s.cert <= STREAM_BULK_TOL
          and drain_launches == s.supersteps + s.attempts,
          f"device drain certified {s.cert:.3g} <= {STREAM_BULK_TOL:g}, one "
          f"launch a superstep for all {STREAM_P} shards + one a drain")
    mem["after the device drain"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    exact = exact_pagerank(dg.operator(0.85), tol=1e-12)
    l1 = float(np.abs(st.x - exact).sum())
    tau = kendall_tau_topk(st.x, exact, k=100)
    print(f"  float64 oracle of version {dg.version} "
          f"({time.perf_counter() - t0:.2f} s host): L1 {l1:.3g}, top-100 "
          f"tau {tau:.6f}")
    check(l1 <= s.cert and tau >= 0.999,
          f"after steps 2-3: L1 to the oracle {l1:.3g} <= the last "
          f"certificate {s.cert:.3g}, top-100 tau {tau:.6f} >= 0.999")
    t0 = time.perf_counter()
    dg.compact()
    print(f"  compact(): {time.perf_counter() - t0:.2f} s host (the 1% "
          f"batches' overlay folded into the base; the version stays "
          f"{dg.version})")

    # 4. batched personalized PageRank: 16 lanes
    rng = np.random.default_rng(16)
    sets = [rng.choice(dg.n, size=4, replace=False)
            for _ in range(STREAM_PPR_NV)]
    for backend in ("segment_sum", "bsr", "scipy"):
        t0 = time.perf_counter()
        _, cs, bs = ppr_push_batched(dg, sets, tol=STREAM_PPR_TOL,
                                     backend=backend)
        ms = sync_ms(t0)
        print(f"  ppr_push_batched[{backend}] nv={bs.nv}: {ms:.1f} ms "
              f"({ms / bs.nv:.2f} ms a query), path {bs.path}, iters "
              f"{bs.iters}, lane_iters {bs.lane_iters.tolist()}, certs "
              f"max {cs.max():.3g} {np.round(cs / 1e-5, 2).tolist()} x 1e-5"
              f"{' (a yardstick on the host)' if backend == 'scipy' else ''}"
              f" [{smi}]")
        if backend != "scipy":
            check((cs <= STREAM_PPR_TOL).all(),
                  f"{backend}: every lane certified <= {STREAM_PPR_TOL:g}")
    print(f"  launches so far: block {dict(LAUNCHES)}, CSR "
          f"{dict(CSR_LAUNCHES)}")

    # 5. the rank server, inline, then threaded
    t0 = time.perf_counter()
    srv = RankServer(dg, tol=STREAM_TOL)
    print(f"  RankServer(tol={STREAM_TOL:g}): {sync_ms(t0):.0f} ms (its cold "
          f"state on the card)")
    for _ in range(8):
        srv.ingest(EdgeDelta.inserts(rng.integers(0, dg.n, 2),
                                     rng.integers(0, dg.n, 2)))
    t0 = time.perf_counter()
    s = srv.apply_pending()
    ms = sync_ms(t0)
    ids, _ = srv.top_k(100)
    t0 = time.perf_counter()
    _, pcert, ps = srv.personalized(sets[0])
    pms = (time.perf_counter() - t0) * 1e3
    print(f"  RankServer: 8 deltas merged, {s.path}, cert {s.cert:.3g}, "
          f"{ms:.1f} ms; top_k(100) head {ids[:5].tolist()}; personalized "
          f"cert {pcert:.3g} ({ps.pushes} pushes, {pms:.1f} ms)")
    check(len(ids) == 100 and pcert <= 1e-4 and srv.snapshot().cert
          <= STREAM_TOL, "inline server: top_k(100), a certified "
          "personalized answer and snapshot")
    seen, errors = [], []
    stop = threading.Event()

    def ingester():
        r = np.random.default_rng(18)
        while not stop.is_set():
            srv.ingest(EdgeDelta.inserts(r.integers(0, dg.n, 2),
                                         r.integers(0, dg.n, 2)))
            time.sleep(0.01)

    def reader(kind):
        r = np.random.default_rng(kind)
        try:
            while not stop.is_set():
                seen.append(srv.snapshot().cert)
                if kind == 0:
                    srv.top_k(100)
                else:
                    srv.personalized(r.choice(dg.n, 2, replace=False),
                                     tol=1e-2)
                time.sleep(0.001)       # a query stream, not a spin
        except Exception as exc:
            errors.append(exc)
            stop.set()

    applied0 = srv.batches_applied
    srv.start(poll_s=0.001)
    threads = [threading.Thread(target=ingester)] + [
        threading.Thread(target=reader, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    time.sleep(STREAM_SERVE_S)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    t0 = time.perf_counter()
    srv.stop(drain=True)
    torch.cuda.synchronize()
    h = srv.health()
    print(f"  threaded, {STREAM_SERVE_S:g} s: {srv.deltas_ingested} deltas "
          f"ingested, {srv.batches_applied - applied0} batches applied, "
          f"{srv.queries_served} queries served, {srv.fallbacks} fallbacks, "
          f"staleness {srv.staleness()}, stop(drain) "
          f"{time.perf_counter() - t0:.2f} s; health {h['status']}, "
          f"last_error {h['last_error']}, restarts {h['updater_restarts']}, "
          f"cold rebuilds {srv.cold_rebuilds}")
    check(not errors and not any(t.is_alive() for t in threads)
          and h["last_error"] is None and h["updater_restarts"] == 0
          and srv.cold_rebuilds == 0 and srv.snapshot().cert <= STREAM_TOL
          and all(c <= STREAM_TOL for c in seen)
          and srv.snapshot().version == dg.version,
          f"threaded server: no error, no restart, no cold rebuild, every "
          f"one of {len(seen)} snapshots read certified <= {STREAM_TOL:g}")

    # 6. the replay, and the DES over the streaming operator
    snap = srv.snapshot()
    st6 = RankState(x=snap.x.copy(), r=np.zeros(dg.n), version=dg.version,
                    alpha=0.85)
    refresh_residual(dg, st6)
    del srv, snap
    t0 = time.perf_counter()
    trace6 = synth_edge_trace(dg, **dict(STREAM_TRACE, seed=7))
    print(f"  the replay's trace: {time.perf_counter() - t0:.2f} s host")
    t0 = time.perf_counter()
    res = replay_trace(dg, st6, trace6, ReplayConfig(**STREAM_REPLAY))
    wall = sync_ms(t0)
    paths = [r.path for r in res.rows]
    print(f"  replay_trace, ReplayConfig({STREAM_REPLAY}): {wall:.0f} ms "
          f"host, {paths.count('push')} of {len(paths)} batches on the push "
          f"path; fresh {res.fresh_pct:.1f}%, mean age "
          f"{res.mean_age_s * 1e3:.0f} ms, p95 {res.p95_age_s * 1e3:.0f} ms,"
          f" busy {res.busy_frac:.3f}, {res.deltas_per_s:.1f} deltas/s "
          f"(simulated clock)")
    print("    " + res.table().replace("\n", "\n    "))
    check(len(res.rows) == len(trace6) and st6.cert <= STREAM_REPLAY["tol"],
          f"replay: {len(res.rows)} records, final cert {st6.cert:.3g}")
    mem["after the stream"] = torch.cuda.memory_allocated()
    part = block_rows(dg.n, STREAM_P)
    t0 = time.perf_counter()
    dg.transition()
    print(f"  P^T of version {dg.version} for the DES: "
          f"{time.perf_counter() - t0:.2f} s host")
    before = CSR_LAUNCHES["f64"]
    t0 = time.perf_counter()
    a = AsyncDES(StreamingBlockOperator(dg, part), part,
                 paper_des_config()).run()
    wall_a = sync_ms(t0)
    des_launches = CSR_LAUNCHES["f64"] - before
    t0 = time.perf_counter()
    c = AsyncDES(StreamingBlockOperator(dg, part, device="cpu"), part,
                 paper_des_config(), device="cpu").run()
    wall_c = (time.perf_counter() - t0) * 1e3
    l1 = float(np.abs(a.x - c.x).sum())
    print(f"  DES over StreamingBlockOperator, p={STREAM_P}: card "
          f"{wall_a:.0f} ms, CPU {wall_c:.0f} ms; iters {a.iters.tolist()} /"
          f" {c.iters.tolist()}, imports {int(a.imports.sum())} / "
          f"{int(c.imports.sum())}, attempts {int(a.attempts.sum())} / "
          f"{int(c.attempts.sum())}, CSR float64 launches {des_launches}; "
          f"L1(x_card, x_cpu) {l1:.3g}")
    check(a.iters.tolist() == c.iters.tolist()
          and np.array_equal(a.imports, c.imports)
          and np.array_equal(a.attempts, c.attempts) and l1 <= 1e-6
          and des_launches == int(a.iters.sum()),
          f"DES bridge: the card's iters, imports and attempts are the "
          f"CPU's, L1 {l1:.3g} <= 1e-6, one launch a block update")
    launches = {"bsr_f32": LAUNCHES["f32"], "bsr_kahan": LAUNCHES["kahan"],
                "csr_f32": CSR_LAUNCHES["f32"], "csr_f64": CSR_LAUNCHES["f64"],
                "csr_hub": CSR_LAUNCHES["hub"]}
    print(f"  streaming launches: {launches}")
    check(launches["bsr_f32"] > 0 and launches["csr_f64"] > 0
          and launches["csr_hub"] > 0,
          "the phase launched the block kernel, the CSR kernel's float64 "
          "lane and its hub lane")
    del a, c
    free_cuda()
    mem["end"] = torch.cuda.memory_allocated()
    print("  memory_allocated: " + ", ".join(
        f"{k} {v / 1e6:.1f} MB" for k, v in mem.items()))
    check(mem["after the stream"] <= 1.5 * mem["after 2 batches"],
          f"device memory after the stream "
          f"{mem['after the stream'] / 1e6:.1f} MB <= 1.5 x after two "
          f"batches ({mem['after 2 batches'] / 1e6:.1f} MB)")
    device_breakdown(lambda: ppr_push_batched(
        dg, sets, tol=STREAM_PPR_TOL, backend="segment_sum"),
        "ppr_push_batched[segment_sum] nv=16", smi)
    return launches, dg, sets, cold, trace


def nv16_timing(dg, sets, cuda, smi):
    """The block kernel (bm = 8) and the CSR kernel (float32, float64) at
    the batched queries' 16 lanes on the stream's final graph, against
    their plain versions, a PyTorch call and the bound; the block kernel's
    path at 16 lanes and at 8. Returns {lane: row}."""
    import numpy as np
    import torch
    from repro_torch.core.backend import as_spec, prepare, seed_stack
    from repro_torch.kernels.bsr_spmv import (bsr_spmv, bsr_spmv_ref,
                                              kernel_path)
    from repro_torch.kernels.csr_spmv import csr_spmv, csr_spmv_ref
    op = dg.operator(0.85)
    n = op.n
    v16 = seed_stack(n, sets)
    rows = {}
    dev, meta, _ = prepare(op, as_spec("bsr", cuda), torch.float32, v=v16)
    blocks, cols, count = dev["blocks"], dev["blk_cols"], dev["blk_count"]
    # a seeded iterate with distinct lanes and zero padding rows: a kernel
    # that gathers the wrong block columns or mixes lanes disagrees
    x = torch.rand((meta.n_pad // blocks.shape[3], blocks.shape[3], 16),
                   dtype=torch.float32, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(4))
    x.view(meta.n_pad, 16)[n:] = 0.0
    paths = {nv: kernel_path(blocks, x[..., :nv].contiguous())
             for nv in (16, 8)}
    for nv in (16, 8):
        xs = x[..., :nv].contiguous()
        y = bsr_spmv(blocks, cols, xs, blk_count=count)
        y_ref = bsr_spmv_ref(blocks, cols, xs)
        err = float((y - y_ref).abs().max())
        check(err <= 1e-5 * float(y_ref.abs().max()),
              f"block kernel nv={nv} ({paths[nv]}) against plain {err:.3g}")
        lib = library_bsr_call(blocks, cols, xs, count)
        t = {"kernel": cuda_ms(lambda: bsr_spmv(blocks, cols, xs,
                                                blk_count=count), 20),
             "plain": cuda_ms(lambda: bsr_spmv_ref(blocks, cols, xs), 3),
             "library": cuda_ms(lib, 10)}
        b_ms, b_by, _, _ = bound(blocks, count, xs, y)
        rows[("bsr", nv)] = dict(t, err=err, bound_ms=b_ms, bound_by=b_by,
                                 path=paths[nv])
        print(f"  block kernel bm=8 nv={nv} ({paths[nv]} path): "
              f"{t['kernel']:.4f} ms, plain {t['plain']:.4f}, sparse-BSR "
              f"call {t['library']:.4f}, bound {b_ms:.4f} ({b_by}; kernel "
              f"at {100 * b_ms / t['kernel']:.1f}%) [{smi}]")
    del dev, x, blocks, cols, count
    nnz_r = torch.as_tensor(np.diff(op.pt.indptr), device=cuda)
    for dt, lane in ((torch.float32, "f32"), (torch.float64, "f64")):
        d = op.pt.device_arrays(dt, cuda)
        xs = torch.rand((n, 16), dtype=dt, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(3))
        y = csr_spmv(d["indptr"], d["src"], d["weight"], xs, n)
        y_ref = csr_spmv_ref(d["row_ids"], d["src"], d["weight"], xs, n)
        ok, err = csr_within_bound(y, y_ref, d["row_ids"], d["src"],
                                   d["weight"], xs, nnz_r)
        check(ok, f"CSR kernel {lane} nv=16 against plain: max |kernel - "
              f"plain| = {err:.3g} (" + ("1e-12 relative" if lane == "f64"
                                         else "the per-row float32 reorder "
                                         "bound") + ")")
        lib = library_csr_call(d, xs, n)
        t = {"kernel": cuda_ms(lambda: csr_spmv(d["indptr"], d["src"],
                                                d["weight"], xs, n), 20),
             "plain": cuda_ms(lambda: csr_spmv_ref(d["row_ids"], d["src"],
                                                   d["weight"], xs, n), 5),
             "library": cuda_ms(lib, 10)}
        b_ms, b_by = csr_bound(d, xs, y, n)
        rows[(lane, 16)] = dict(t, err=err, bound_ms=b_ms, bound_by=b_by)
        print(f"  CSR kernel {lane} nv=16: {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f}, sparse CSR call {t['library']:.4f}, bound "
              f"{b_ms:.4f} ({b_by}; kernel at "
              f"{100 * b_ms / t['kernel']:.1f}%) [{smi}]")
    free_cuda()
    return rows


def accept_style_delta(g, den, seed):
    """tests/conftest.py::accept_delta's draw (copied): nnz // den links,
    85% inserts from random sources to the targets of random existing
    links, 15% deletions of distinct existing links."""
    import numpy as np
    from repro_torch.streaming import EdgeDelta
    rng = np.random.default_rng(seed)
    k = g.nnz // den
    n_del = k * 15 // 100
    slots = rng.choice(g.nnz, size=n_del, replace=False)
    src_of_edge = np.repeat(np.arange(g.n, dtype=np.int64),
                            np.diff(g.indptr))
    return EdgeDelta(
        add_src=rng.integers(0, g.n, k - n_del),
        add_dst=g.indices[rng.integers(0, g.nnz, k - n_del)].astype(np.int64),
        del_src=src_of_edge[slots],
        del_dst=g.indices[slots].astype(np.int64))


def async_main_path(g, cold, trace, smi):
    """ROADMAP Queue 1 items 7-8: `update_ranks_sharded(mode="async")` on
    the worker-thread and worker-process transports (the processes forked
    from this process, which holds the card's context; they run numpy
    only) on the JAX package's 50k acceptance case at p = 2 and 4 and
    under its chaos plan, then on a 0.1% batch of `g` from the streaming
    phase's cold state `cold` (threads with the observer, procpool); then
    the rank server on the process pool with the query tier attached,
    taking the crawl batches `trace` while 8 client threads send
    query_bench's load_gen mix, and a burst of 16 queries through the
    block kernel's lanes. Every
    certificate is the host float64 recomputation, every L1 is to a
    float64 cold solve on the card. Returns the launches of each kernel."""
    import json
    import tempfile
    import threading
    import numpy as np
    import torch
    from repro_torch.graph import powerlaw_webgraph
    from repro_torch.kernels.bsr_spmv import LAUNCHES
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR_LAUNCHES
    from repro_torch.runtime import (FaultPlan, live_segments,
                                     write_chrome_trace)
    from repro_torch.serving import QueryBatcher, attach_query_tier
    from repro_torch.streaming import (DeltaGraph, RankServer, RankState,
                                       cold_state, update_ranks_sharded)

    free_cuda()
    mem = {"start": torch.cuda.memory_allocated()}
    reset_launches()
    print(f"  host: {os.cpu_count()} CPU cores; shard worker processes are "
          f"forked from this process (it holds the card's context) and run "
          f"numpy only")

    def fresh(st):
        return RankState(x=st.x.copy(), r=st.r.copy(), version=0,
                         alpha=st.alpha)

    def drain(label, graph, base, delta, oracle, **kw):
        dg = DeltaGraph(graph)
        t0 = time.perf_counter()
        st, s = update_ranks_sharded(dg, delta, fresh(base), tol=ASYNC_TOL,
                                     mode="async", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        l1 = float(np.abs(st.x - oracle).sum())
        print(f"  {label}: {s.path}, pushes {s.pushes:,}, rounds "
              f"{s.supersteps:,} (the busiest worker), attempts "
              f"{s.attempts}, exchanges {s.exchanges:,}, bytes "
              f"{s.bytes_moved:,}, idle {s.idle_s:.2f} s (all workers), "
              f"recoveries {s.recoveries} ({s.recovery_s:.3f} s), cert "
              f"{s.cert:.3g}, L1 to the oracle {l1:.3g}, wall {wall:.2f} s")
        return st, s, l1

    # 1. the 50k acceptance case
    t0 = time.perf_counter()
    g50 = powerlaw_webgraph(**ASYNC_50K)
    d50 = accept_style_delta(g50, 100, 31)
    base50 = cold_state(DeltaGraph(g50), tol=5e-9)
    dgm = DeltaGraph(g50)
    dgm.apply(d50)
    oracle50 = cold_state(dgm, tol=1e-11)
    torch.cuda.synchronize()
    print(f"  50k graph ({g50.n:,} pages, {g50.nnz:,} links), its 1% delta "
          f"({d50.size:,} edges), cold state (cert {base50.cert:.3g}) and "
          f"the mutated graph's float64 oracle on the card (cert "
          f"{oracle50.cert:.3g}): {time.perf_counter() - t0:.2f} s")
    xs = {}
    for transport, p in (("procpool", 2), ("procpool", 4), ("threads", 2)):
        st, s, l1 = drain(f"50k 1% delta, {transport}, p={p}", g50, base50,
                          d50, oracle50.x, p=p, transport=transport)
        check(s.path == "sharded_push" and s.cert <= ASYNC_TOL
              and l1 <= 2 * ASYNC_TOL,
              f"50k {transport} p={p}: sharded_push, cert {s.cert:.3g} <= "
              f"{ASYNC_TOL:g}, L1 {l1:.3g} <= {2 * ASYNC_TOL:g}")
        xs[(transport, p)] = st.x
    l1 = float(np.abs(xs[("threads", 2)] - xs[("procpool", 2)]).sum())
    check(l1 <= 2 * ASYNC_TOL, f"threads and procpool at p=2 agree: L1 "
          f"{l1:.3g} <= {2 * ASYNC_TOL:g}")

    # 2. the chaos case
    st, s, l1 = drain(f"50k 1% delta, procpool, p=4, FaultPlan"
                      f"({ASYNC_CHAOS})", g50, base50, d50, oracle50.x,
                      p=4, transport="procpool",
                      faults=FaultPlan(**ASYNC_CHAOS))
    check(s.recoveries >= 1 and s.cert <= ASYNC_TOL
          and l1 <= 2 * ASYNC_TOL,
          f"chaos: {s.recoveries} recovery(ies), cert {s.cert:.3g}, L1 "
          f"{l1:.3g}")
    del g50, d50, base50, dgm, oracle50, xs, st

    # 3. a 0.1% batch of the full graph from the streaming phase's cold state
    x0, r0 = cold
    base = RankState(x=x0, r=r0, version=0, alpha=0.85)
    d_web = accept_style_delta(g, ASYNC_WEB_DEN, 32)
    t0 = time.perf_counter()
    dgm = DeltaGraph(g)
    dgm.apply(d_web)
    oracle = cold_state(dgm, tol=1e-11)
    torch.cuda.synchronize()
    print(f"  0.1% batch ({d_web.size:,} edges, {d_web.add_src.size:,} "
          f"inserts) and the mutated graph's float64 oracle on the card "
          f"(cert {oracle.cert:.3g}): {time.perf_counter() - t0:.2f} s")
    del dgm
    for transport in ("threads", "procpool"):
        observe = transport == "threads"
        st, s, l1 = drain(f"{g.n:,}-page graph, 0.1% batch, {transport}, "
                          f"p=4{', observe' if observe else ''}", g, base,
                          d_web, oracle.x, p=4, transport=transport,
                          observe=observe)
        check(s.cert <= ASYNC_TOL and l1 <= 2 * ASYNC_TOL,
              f"{transport}: {s.path}, cert {s.cert:.3g} <= {ASYNC_TOL:g}, "
              f"L1 {l1:.3g} <= {2 * ASYNC_TOL:g}")
        if observe:
            ob = s.observed
            parts = (s.pushes_first, s.pushes_local, s.pushes_boundary)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                write_chrome_trace(path, ob["events"], p=4)
                with open(path) as fh:
                    tr = json.load(fh)
                size = os.path.getsize(path)
            print(f"    pushes first/local/boundary {parts}; events "
                  f"written {ob['events_written']}, dropped "
                  f"{ob['events_dropped']}; Chrome trace "
                  f"{len(tr['traceEvents']):,} records, {size:,} bytes")
            check(sum(parts) == s.pushes and len(tr["traceEvents"]) > 4,
                  "threads observe: first + local + boundary == pushes, "
                  "and the Chrome trace loads back")
    del st, oracle, base, cold

    # 4. the rank server on the process pool, with the query tier
    t0 = time.perf_counter()
    srv = RankServer(DeltaGraph(g), tol=STREAM_TOL, updater="sharded",
                     shards=4, shard_mode="async",
                     shard_transport="procpool")
    batcher, cache, router = attach_query_tier(srv, **TIER_SETTINGS)
    torch.cuda.synchronize()
    print(f"  RankServer(updater='sharded', shard_mode='async', "
          f"shard_transport='procpool', tol={STREAM_TOL:g}) with "
          f"attach_query_tier({TIER_SETTINGS}): "
          f"{time.perf_counter() - t0:.2f} s (the cold state on the card, "
          f"the snapshot's operator)")
    rng = np.random.default_rng(11)
    pool = [rng.choice(g.n, size=int(rng.integers(1, 4)), replace=False)
            for _ in range(TIER_POOL)]
    pop = (1.0 / np.arange(1, TIER_POOL + 1)) ** TIER_ZIPF
    pop /= pop.sum()
    lat = {"top_k": [], "scores": [], "ppr": []}
    qcerts, paths, errors, seen = [], [], [], []
    stop = threading.Event()

    # the first fused solve the collector makes under this load runs in a
    # profiler window that this thread opens: the collector waits at the
    # solve's start until the window is open
    solve = batcher._solve
    window = {k: threading.Event() for k in ("ready", "go", "done")}

    def profiled_solve(batch):
        if len(batch) < 2 or window["ready"].is_set():
            return solve(batch)
        window["lanes"] = len(batch)
        window["ready"].set()
        window["go"].wait(timeout=60)
        try:
            solve(batch)
        finally:
            window["done"].set()

    batcher._solve = profiled_solve

    def client(k):
        r = np.random.default_rng(100 + k)
        try:
            while not stop.is_set():
                u = r.random()
                t = time.perf_counter()
                if u < TIER_MIX[0]:
                    _, sc = router.top_k(int(r.integers(1, 100)))
                    assert np.all(np.diff(sc) <= 0)
                    lat["top_k"].append(time.perf_counter() - t)
                elif u < TIER_MIX[1]:
                    vals = router.scores(r.integers(0, g.n, 8))
                    assert np.isfinite(vals).all()
                    lat["scores"].append(time.perf_counter() - t)
                else:
                    q = pool[int(r.choice(TIER_POOL, p=pop))]
                    _, cert, st_q = srv.personalized(q, tol=TIER_PPR_TOL)
                    lat["ppr"].append(time.perf_counter() - t)
                    qcerts.append(cert)
                    paths.append(getattr(st_q, "path", "?"))
                seen.append(srv.snapshot().cert)
        except BaseException as exc:
            errors.append(exc)
            stop.set()

    def ingester():
        for d in trace:
            if stop.is_set():
                return
            srv.ingest(d)
            time.sleep(TIER_SERVE_S / len(trace))

    srv.start(poll_s=0.002)
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(TIER_CLIENTS)] + [
        threading.Thread(target=ingester)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    prof = "no fused solve"
    try:
        if window["ready"].wait(timeout=TIER_SERVE_S):
            prof = device_breakdown(
                lambda: (window["go"].set(),
                         window["done"].wait(timeout=120)),
                f"one of the batcher's own fused solves under the load, "
                f"{window['lanes']} lanes (segment_sum, solve tol "
                f"{0.5 * TIER_PPR_TOL:g})", smi)
    except Exception as exc:   # the profiler's; the solve keeps its own
        prof = repr(exc)
    finally:
        window["go"].set()
    time.sleep(max(0.0, TIER_SERVE_S - (time.perf_counter() - t0)))
    stop.set()
    for t in threads:
        t.join(timeout=120)
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.stop(drain=True)
    torch.cuda.synchronize()
    stop_s = time.perf_counter() - t0
    _, c1, _ = srv.personalized(pool[0], tol=TIER_PPR_TOL)
    _, c2, s2 = srv.personalized(pool[0], tol=TIER_PPR_TOL)
    ids, _ = router.top_k(100)
    h = srv.health()
    bs, cs, rs = batcher.stats(), cache.stats(), router.stats()
    hit = cs["hits"] / max(cs["hits"] + cs["misses"], 1)
    n_q = sum(len(v) for v in lat.values())
    pct = ", ".join(
        f"{kind} {len(v):,} (p50 {np.percentile(v, 50) * 1e3:.3f} ms, p99 "
        f"{np.percentile(v, 99) * 1e3:.3f} ms)" if v else f"{kind} 0"
        for kind, v in lat.items())
    print(f"  served {serve_s:.1f} s: {n_q:,} queries by {TIER_CLIENTS} "
          f"clients ({n_q / serve_s:.0f} a second): {pct}; personalized "
          f"paths {dict((p, paths.count(p)) for p in set(paths))}; batcher "
          f"{bs} (mean lanes a batch {bs['mean_batch']:.2f}); cache {cs} "
          f"(hit share {hit:.3f}); router {rs['routed']} routed, "
          f"{rs['redirects']} redirects, {rs['rejects']} rejects; updater "
          f"{srv.deltas_ingested} deltas in {srv.batches_applied} batches, "
          f"{srv.fallbacks} fallbacks, stop(drain) {stop_s:.2f} s; health "
          f"{h['status']}, last_error {h['last_error']} [{smi}]")
    if not isinstance(prof, tuple):
        print(f"  the card's busy share in the batcher's solves: not "
              f"measured ({prof})")
    check(not errors and not any(t.is_alive() for t in threads)
          and len(lat["ppr"]) > 0 and max(qcerts) <= TIER_PPR_TOL
          and max(seen) <= STREAM_TOL and srv.snapshot().cert <= STREAM_TOL
          and h["status"] == "ok" and h["last_error"] is None
          and h["updater_restarts"] == 0 and srv.cold_rebuilds == 0
          and srv.batches_applied > 0
          and srv.snapshot().version == srv.dg.version,
          f"query tier: no error, every query cert <= {TIER_PPR_TOL:g} "
          f"and every snapshot cert <= {STREAM_TOL:g}, health ok, "
          f"{srv.batches_applied} certified batches on the process pool")
    check(getattr(s2, "path", None) == "cache" and c2 <= TIER_PPR_TOL
          and ids.size == 100 and bs["fused_lanes"] > 0,
          f"a repeated query answered from the cache (cert {c2:.3g}), "
          f"router.top_k(100) answered, {bs['fused_lanes']} fused lanes")
    batcher.stop()

    # the burst through the block kernel's lanes
    burst = QueryBatcher(srv, max_batch=TIER_BURST, max_delay_s=1.0,
                         backend="bsr").attach()
    sets = [rng.choice(g.n, size=3, replace=False)
            for _ in range(TIER_BURST)]
    out, errs = [None] * TIER_BURST, []
    gate = threading.Barrier(TIER_BURST)
    before = (LAUNCHES["f32"], CSR_LAUNCHES["hub"])

    def ask(k):
        gate.wait()
        try:
            out[k] = burst.submit(sets[k], None, TIER_TOL)
        except BaseException as exc:
            errs.append(exc)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=ask, args=(k,)) for k in range(TIER_BURST)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    torch.cuda.synchronize()
    burst_ms = (time.perf_counter() - t0) * 1e3
    burst.stop()
    bst = burst.stats()
    print(f"  burst of {TIER_BURST} through QueryBatcher(backend='bsr'): "
          f"{burst_ms:.0f} ms, {bst}, block launches "
          f"{LAUNCHES['f32'] - before[0]}, hub lane launches "
          f"{CSR_LAUNCHES['hub'] - before[1]}")
    check(not errs and all(o is not None and o[1] <= TIER_TOL for o in out)
          and LAUNCHES["f32"] > before[0]
          and CSR_LAUNCHES["hub"] > before[1],
          f"bsr burst: {TIER_BURST} answers certified <= {TIER_TOL:g}, the "
          f"block kernel and its hub lane launched")
    launches = {"bsr_f32": LAUNCHES["f32"], "bsr_kahan": LAUNCHES["kahan"],
                "csr_f32": CSR_LAUNCHES["f32"], "csr_f64": CSR_LAUNCHES["f64"],
                "csr_hub": CSR_LAUNCHES["hub"]}
    print(f"  phase launches: {launches}")
    check(launches["csr_f64"] > 0 and launches["bsr_f32"] > 0
          and launches["csr_hub"] > 0,
          "the phase launched the CSR kernel's float64 lane, the block "
          "kernel and its hub lane")

    # 5. clean-up: this process's segments are checked; another process's
    # (a second run on the same machine) are only listed
    del srv, batcher, solve, cache, router, burst, out
    free_cuda()
    mem["end"] = torch.cuda.memory_allocated()
    pid = str(os.getpid())
    left, others = [], []
    for nm in live_segments():
        (left if nm.split("_")[-2] == pid else others).append(nm)
    print(f"  /dev/shm segments of the port's prefix: this process's "
          f"{left}, other processes' {others}; memory_allocated "
          f"{mem['start'] / 1e6:.1f} MB at the start, "
          f"{mem['end'] / 1e6:.1f} MB at the end")
    check(not left and mem["end"] <= mem["start"],
          "no shared-memory segment left, device memory back to its start")
    return launches


def device_breakdown(fn, label, smi):
    """Run fn once under torch.profiler and print where the device time
    went: kernel time by group (the flash kernel, matrix products, the
    rest), the device's busy share of the profiled wall time, and the top
    kernels. The profiler slows the host, so the wall time here is longer
    than an unprofiled one. Returns (kernels, device busy ms, wall ms), or
    None where the profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        print(f"  {label}: the profiler recorded no device events")
        return
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    groups = {"flash": 0.0, "scan": 0.0, "matmul": 0.0, "other": 0.0}
    by_name = {}
    for e in kern:
        us = e.time_range.elapsed_us()
        name = e.name
        g = ("flash" if "flash_fwd" in name else
             "scan" if "ssd_" in name or "rglru_" in name else
             "matmul" if any(w in name.lower() for w in
                             ("gemm", "nvjet", "cutlass", "xmma", "gemv"))
             else "other")
        groups[g] += us
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"  {label} (profiled): wall {wall:.2f} ms, {len(kern)} kernels, "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / 1e3 / wall:.1f}% "
          f"of wall); flash {groups['flash'] / 1e3:.2f} ms, scans "
          f"{groups['scan'] / 1e3:.2f} ms, matmul "
          f"{groups['matmul'] / 1e3:.2f} ms, other "
          f"{groups['other'] / 1e3:.2f} ms [{smi}]")
    for name, us in top:
        print(f"    {us / 1e3:8.3f} ms  {name}")
    return len(kern), busy / 1e3, wall


def free_cuda():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_launch_counts():
    """The LM kernels' launch counts by kernel, as the meta lane books
    them (`analysis.count.Counts.kernels`)."""
    from repro_torch.kernels.flash_attention import LAUNCHES as FA
    from repro_torch.kernels.rglru_scan import LAUNCHES as LRU
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    return {"flash_attention": dict(FA), "ssd_scan": dict(SSD),
            "rglru_scan": dict(LRU)}


def memory_reading(run, args):
    """One call of run() on the card, the allocator's peak reset before
    it: (its result, {ms of run() alone on the host clock, to a
    synchronize; bytes allocated before it; the allocator's bytes of
    args' storages (the step's arguments) and their count; the peak; the
    peak before the reset, for a caller's own reading of a longer span;
    the LM kernels' launches during it})."""
    import torch
    from repro_torch.analysis.count import storage_bytes, tensors
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    held = storage_bytes(args)
    storages = len({t.untyped_storage()._cdata for t in tensors(args)})
    start = lm_launch_counts()
    prior = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = {k: {key: n - start[k][key] for key, n in v.items()
                    if n != start[k][key]}
                for k, v in lm_launch_counts().items()}
    return out, dict(ms=ms, before=before, held=held, storages=storages,
                     peak=peak, prior=prior,
                     launches={k: v for k, v in launches.items() if v})


def dry_step(what, cfg, kind, batch, seq, reading, opt_cfg=None):
    """Keep a step's card reading for the dry run's phase, which counts
    the step (`launch.dryrun.count_cell`) and holds it to the reading
    (`dry_run_against_card`)."""
    DRY_STEPS[what] = (cfg, kind, batch, seq, opt_cfg, reading)


def dry_run_against_card(what, cfg, counts, reading, smi):
    """The dry run's count of a step (`launch.dryrun.count_cell`) held to
    the card's reading of it (`memory_reading`): the predicted peak, the
    dry run's arguments and temporaries plus the card's fixed term (the
    bytes allocated before the step beyond its arguments: the cuBLAS and
    cuBLASLt workspaces, buffers a kernel keeps between calls, and what
    the phase holds besides the step), within DRY_MEMORY_GAP of
    max_memory_allocated; the arguments within ALLOC_GRANULE a storage of
    the card's; the temporaries within DRY_MEMORY_GAP of the card's (the
    peak less the bytes before the step) plus DRY_ALLOC_SPLIT; the meta
    lane's bookings equal to the kernels' launches; the step's ms beside
    the dry run's roofline bound (printed, not gated)."""
    from repro_torch.analysis.count import ALLOC_GRANULE
    from repro_torch.launch.dryrun import roofline_of
    m = counts.memory
    fixed = reading["before"] - reading["held"]
    predicted = m.peak_bytes + fixed
    gap = (predicted - reading["peak"]) / reading["peak"]
    temps = reading["peak"] - reading["before"]
    booked = {k: {key: n for key, n in b["launches"].items() if n}
              for k, b in counts.kernels.items()}
    booked = {k: v for k, v in booked.items() if v}
    roof = roofline_of(cfg, counts)
    bound_ms = roof.bound_s * 1e3
    gb = 1e9
    print(f"  dry run of {what}: {counts.flops / 1e12:.3f} TFLOP, "
          f"{counts.hbm_bytes / gb:.3f} GB moved, arguments "
          f"{m.argument_size_in_bytes / gb:.4f} GB (the card's "
          f"{reading['held'] / gb:.4f}), temporaries "
          f"{m.temp_size_in_bytes / gb:.4f} GB (the card's "
          f"{temps / gb:.4f}), the card's "
          f"fixed term {fixed / 1e6:.2f} MB; the step {reading['ms']:.2f} ms "
          f"against the bound {bound_ms:.3f} ms ({roof.dominant}-bound), "
          f"{100 * bound_ms / reading['ms']:.1f}% of it [{smi}]")
    check(abs(gap) <= DRY_MEMORY_GAP,
          f"{what}: the dry run's peak {predicted / gb:.4f} GB (its "
          f"{m.peak_bytes / gb:.4f} + the fixed term) against "
          f"max_memory_allocated {reading['peak'] / gb:.4f} GB: "
          f"{100 * gap:+.3f}% (within {100 * DRY_MEMORY_GAP:.0f}%)")
    check(abs(m.argument_size_in_bytes - reading["held"])
          <= ALLOC_GRANULE * reading["storages"],
          f"{what}: the dry run's arguments {m.argument_size_in_bytes:,} B "
          f"against the card's {reading['held']:,} B in "
          f"{reading['storages']} storages (within {ALLOC_GRANULE} B a "
          f"storage)")
    check(abs(m.temp_size_in_bytes - temps)
          <= DRY_MEMORY_GAP * temps + DRY_ALLOC_SPLIT,
          f"{what}: the dry run's temporaries {m.temp_size_in_bytes:,} B "
          f"against the card's {temps:,} B: "
          f"{100 * (m.temp_size_in_bytes - temps) / max(temps, 1):+.3f}% "
          f"(within {100 * DRY_MEMORY_GAP:.0f}% + {DRY_ALLOC_SPLIT:,} B)")
    check(booked == reading["launches"],
          f"{what}: the meta lane's bookings {booked} equal the card's "
          f"launches {reading['launches']}")
    return dict(gap=gap, ms=reading["ms"], bound_ms=bound_ms,
                peak=reading["peak"], predicted=predicted)


def dry_run_table(smi):
    """Every (arch x shape) cell counted on the meta device
    (`launch.dryrun.run_table`, DRY_TABLE_JOBS worker processes): a line
    a cell, every cell the arch supports `ok`, the others `skipped`, none
    in error, within DRY_TABLE_S seconds. The same workers count the steps
    of DRY_STEPS, each then held to its card reading
    (`dry_run_against_card`). Returns the records."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    with dryrun.worker_pool(DRY_TABLE_JOBS) as pool:
        steps = {what: pool.submit(dryrun.count_cell, cfg, kind, B, S, opt)
                 for what, (cfg, kind, B, S, opt, _) in DRY_STEPS.items()}
        recs = dryrun.run_table(pool=pool)
        steps = {what: f.result() for what, f in steps.items()}
    secs = time.perf_counter() - t0
    for rec in recs:
        print("  " + dryrun.summary(rec))
    wrong = [(r["arch"], r["shape"], r["status"], r.get("error"))
             for r in recs
             if r["status"] != ("ok" if get_config(r["arch"]).supports_shape(
                 r["shape"])[0] else "skipped")]
    n_ok = sum(r["status"] == "ok" for r in recs)
    check(not wrong and secs <= DRY_TABLE_S,
          f"the dry run's table: {n_ok} cells ok, "
          f"{len(recs) - n_ok} skipped as the arch's supports_shape says, "
          f"none in error {wrong}; {secs:.1f} s with {DRY_TABLE_JOBS} worker "
          f"processes (<= {DRY_TABLE_S:.0f} s, the {len(steps)} steps "
          f"below counted by them too), records under {dryrun.RESULTS_DIR} "
          f"[{smi}]")
    check(len(steps) == 3, f"the dry run's steps read on the card: "
                           f"{list(steps)}")
    for what, counts in steps.items():
        cfg, *_, reading = DRY_STEPS[what]
        dry_run_against_card(what, cfg, counts, reading, smi)
    return recs


def rel_err(a, b):
    """max |a - b| / max |b|, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / float(b.abs().max())


def row_rel_err(o, r):
    """max over rows of ||o - r|| / ||r||, each row one query's output."""
    o, r = o.float(), r.float()
    return float(((o - r).norm(dim=-1) / r.norm(dim=-1)).max())


def top1_report(a, b):
    """Positions whose top-1 token differs between logits a and b, and b's
    top-2 margin at each of them (printed, for the record)."""
    ta, tb = a.float().argmax(-1), b.float().argmax(-1)
    bad = (ta != tb)
    top2 = b.float().topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1])[bad]
    return int(bad.sum()), int(bad.numel()), margins.tolist()


def wgmma_attrs_spill_nothing():
    """The tensor-core forward's instantiations as compiled (registers,
    shared bytes, spilled bytes, blocks an SM), printed; every one at the
    redesigned head dims (256, 256) and (192, 128) must spill nothing."""
    from repro_torch.kernels.flash_attention import wgmma_kernel_attrs
    attrs = wgmma_kernel_attrs()
    for name, a in attrs.items():
        print(f"  wgmma forward {name}: {a['registers']} registers, "
              f"{a['local']} spill bytes, {a['shared']:,} B of shared "
              f"memory, {a['blocks']} block(s) an SM")
    spills = {n: a["local"] for n, a in attrs.items()
              if n.split()[0] in ("256x256", "192x128")}
    check(len(spills) == 8 and not any(spills.values()),
          f"the tensor-core forward at (256, 256) and (192, 128) spills "
          f"nothing: {spills}")


def lse_keeps_o(q, k, v, o, **kw):
    """The forward's log-sum-exp instantiation on these inputs: its lse's
    largest distance from the plain one, and whether its o is o's bits."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    o2, lse = flash_attention(q, k, v, return_lse=True, **kw)
    _, want = flash_attention_ref(q, k, v, return_lse=True, **kw)
    return float((lse - want).abs().max()), torch.equal(o, o2)


def flash_against_plain(cuda):
    """Both flash kernels against their plain version on the card, with and
    without a local window; at head dim 256 on the tensor-core lane also
    its log-sum-exp against the plain one, o the same bits with and
    without it. Returns the largest |kernel - plain| seen per lane
    ("wgmma", "f32") and on the tensor-core lane at head dim 256
    ("d256")."""
    import torch
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref,
                                                     kernel_info,
                                                     kernel_lane)
    from repro_torch.kernels.flash_attention.bwd_cases import LSE_LIMIT
    f32, bf16 = torch.float32, torch.bfloat16
    wgmma_attrs_spill_nothing()
    # the CUDA-core lane as compiled: resident warps per SM and spills
    for D, dt in ((128, f32), (64, f32), (96, bf16), (32, bf16), (256, f32),
                  (160, bf16)):
        info = kernel_info(D, dt)
        warps = info["blocks_per_sm"] * info["threads"] // 32
        check(info["local_bytes"] == 0 and (warps >= 8 or D != 128),
              f"flash f32 lane D={D} {str(dt)[6:]}: "
              f"{info['blocks_per_sm']} block(s) x {info['threads']} "
              f"threads = {warps} warps per SM, {info['registers']} "
              f"registers, {info['local_bytes']} spill bytes, "
              f"{info['smem_bytes']:,} B of shared memory a block")
    cases = [  # (B, H, Hkv, S, T, D, causal, dtype)
        (1, 1, 1, 128, 128, 64, True, f32),    # test_kernels_attention.py
        (2, 4, 2, 256, 256, 64, True, f32),
        (1, 8, 1, 128, 128, 128, False, f32),
        (1, 2, 2, 384, 384, 32, True, f32),
        (1, 2, 2, 128, 128, 64, True, bf16),
        (1, 4, 2, 128, 256, 128, True, f32),   # causal S != T, top-left
        (1, 4, 2, 256, 128, 128, True, f32),
        (1, 4, 2, 96, 160, 128, False, f32),
        (1, 8, 2, 40, 40, 128, True, f32),     # ragged S = T
        (1, 8, 2, 1000, 1000, 128, True, f32),
        (1, 8, 2, 1000, 1000, 128, True, bf16),
        (YI_BATCH, 32, 4, YI_PROMPT, YI_PROMPT, 128, True, bf16),  # main
        (1, 32, 4, 2048, 2048, 128, True, bf16),   # Yi-6B prefill
        # Qwen2-MoE-A2.7B: MHA, H = Hkv = 16, D = 128
        (YI_BATCH, 16, 16, YI_PROMPT, YI_PROMPT, 128, True, bf16),
        (1, 16, 16, 2048, 2048, 128, True, bf16),
        # the tensor-core lane: S = T in {64, 128, 1000, 2048}, D in
        # {64, 128}, G in {1, 4, 8}, causal S != T, ragged 1/63/65/129, B = 2
        (1, 4, 4, 64, 64, 64, False, bf16),
        (1, 8, 2, 128, 128, 64, True, bf16),
        (1, 8, 1, 1000, 1000, 64, True, bf16),
        (1, 8, 2, 2048, 2048, 64, True, bf16),
        (1, 4, 4, 64, 64, 128, True, bf16),
        (1, 8, 2, 128, 128, 128, False, bf16),
        (1, 8, 1, 1000, 1000, 128, False, bf16),
        (1, 4, 2, 128, 256, 128, True, bf16),
        (1, 4, 2, 256, 128, 128, True, bf16),
        (1, 4, 2, 128, 256, 64, True, bf16),
        (1, 4, 2, 256, 128, 64, True, bf16),
        (1, 4, 1, 1, 1, 128, True, bf16),
        (1, 4, 1, 63, 63, 64, True, bf16),
        (1, 4, 1, 65, 65, 128, True, bf16),
        (1, 4, 1, 129, 129, 64, False, bf16),
        (2, 8, 1, 129, 129, 128, True, bf16),
        (2, 4, 4, 1000, 1000, 64, True, bf16),
        # the CUDA-core lane (q tile 128 rows, kv tile 64): G = 8 over many
        # kv tiles, ragged 1/31/33/127/129/1000 S and T, causal S != T,
        # G in {1, 4, 8} at B = 2, D in {18, .., 96}, bf16 at other D
        (1, 8, 1, 2048, 2048, 128, True, f32),
        (1, 4, 1, 1, 1, 128, True, f32),
        (1, 4, 2, 31, 31, 128, True, f32),
        (1, 4, 2, 33, 33, 64, False, f32),
        (1, 4, 2, 127, 127, 128, True, f32),
        (1, 4, 2, 129, 129, 128, False, f32),
        (1, 4, 1, 1000, 1000, 64, True, f32),
        (1, 4, 2, 31, 129, 128, False, f32),
        (1, 4, 2, 1000, 33, 128, False, f32),
        (1, 4, 2, 128, 320, 128, True, f32),
        (1, 4, 2, 320, 128, 128, True, f32),
        (1, 4, 2, 129, 1000, 64, True, f32),
        (1, 4, 2, 1000, 127, 128, True, f32),
        (2, 4, 4, 200, 200, 128, True, f32),
        (2, 8, 2, 200, 200, 128, True, f32),
        (2, 8, 1, 129, 129, 128, False, f32),
        (1, 4, 2, 150, 150, 18, True, f32),
        (1, 4, 2, 150, 150, 20, True, f32),
        (1, 4, 2, 150, 150, 32, True, f32),
        (1, 4, 2, 150, 150, 64, True, f32),
        (1, 4, 2, 150, 150, 96, True, f32),
        (1, 4, 2, 150, 150, 20, True, bf16),
        (1, 4, 2, 300, 300, 32, True, bf16),
        (1, 8, 2, 1000, 1000, 96, True, bf16),
        # one element off a 16-byte boundary: the synchronous loads
        (1, 4, 2, 200, 200, 128, True, f32, "offset"),
        (1, 4, 2, 200, 200, 96, True, bf16, "offset"),
        # RecurrentGemma-2B's local_attn (H = 10, Hkv = 1, D = 256, window
        # 2048) at the main path's shapes, head dim 256 without a window,
        # and the window on both lanes: ragged, not causal, window 1, S > T
        (RECUR_BATCH, 10, 1, RECUR_PROMPT, RECUR_PROMPT, 256, True, bf16,
         2048),
        (1, 10, 1, 4096, 4096, 256, True, bf16, 2048),
        (1, 10, 1, 4096, 4096, 256, True, bf16),
        (2, 8, 2, 1000, 1000, 256, False, bf16),
        (1, 4, 1, 1, 1, 256, True, bf16),
        (1, 4, 2, 1000, 1000, 256, True, bf16, 100),
        (1, 4, 1, 300, 300, 256, False, bf16, 64),
        (1, 4, 2, 200, 200, 256, True, bf16, 1),
        (1, 8, 2, 1000, 1000, 128, True, bf16, 300),
        (1, 8, 2, 1000, 1000, 64, True, bf16, 129),
        (1, 4, 2, 256, 128, 128, True, bf16, 200),
        (1, 4, 2, 1000, 1000, 128, True, f32, 300),
        (1, 4, 2, 1000, 1000, 64, True, f32, 1),
        (1, 4, 1, 300, 300, 20, False, f32, 77),
        (1, 4, 1, 500, 500, 256, True, f32),
        (1, 4, 1, 500, 500, 256, True, f32, 130),
        (2, 4, 2, 129, 129, 200, True, f32),
        (1, 4, 1, 300, 300, 160, True, bf16, 64),
        # the overlapped schedule at D = 256 (64-row kv tiles, 2 stages):
        # loops of 1-4 kv tiles, windows whose first tile masks whole rows,
        # ragged T, causal S != T, B = 2 at G = 1 and 10
        (1, 4, 1, 64, 64, 256, False, bf16),
        (1, 4, 1, 64, 128, 256, False, bf16),
        (1, 4, 1, 64, 192, 256, False, bf16),
        (1, 4, 1, 64, 256, 256, False, bf16),
        (1, 4, 2, 256, 256, 256, True, bf16),
        (1, 4, 2, 300, 300, 256, True, bf16, 63),
        (1, 4, 2, 300, 300, 256, True, bf16, 65),
        (1, 4, 1, 257, 257, 256, True, bf16, 1),
        (1, 4, 2, 100, 333, 256, False, bf16),
        (1, 4, 2, 130, 300, 256, True, bf16),
        (1, 4, 2, 300, 130, 256, True, bf16),
        (2, 4, 4, 200, 200, 256, True, bf16),
        (2, 10, 1, 300, 300, 256, True, bf16, 100),
    ]
    worst = {"wgmma": 0.0, "f32": 0.0, "d256": 0.0}
    worst_rel = dict(worst)
    for B, H, Hkv, S, T, D, causal, dt, *extra in cases:
        offset = "offset" in extra
        window = next((e for e in extra if isinstance(e, int)), None)
        g = torch.Generator(device=cuda).manual_seed(S * 1000 + T + D)

        def draw(*shape):
            t = torch.randn(shape, generator=g, device=cuda).to(dt)
            if not offset:
                return t
            flat = torch.empty(t.numel() + 1, dtype=dt, device=cuda)
            flat[1:] = t.reshape(-1)
            return flat[1:].view(shape)
        q, k, v = draw(B, H, S, D), draw(B, Hkv, T, D), draw(B, Hkv, T, D)
        lane = kernel_lane(dt, D)
        before = dict(LAUNCHES)
        o = flash_attention(q, k, v, causal=causal, window=window)
        r = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        on_lane = (LAUNCHES["wgmma"] - before["wgmma"] == (lane == "wgmma")
                   and LAUNCHES["fwd"] - before["fwd"] == 1
                   and bool(offset) == (q.data_ptr() % 16 != 0))
        # bf16: the tensor-core lane rounds p to bf16 before p v
        tol = 1e-4 if dt == f32 else 3e-2
        diff = (o.float() - r.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol + tol * r.float().abs()).all())
        # and at the output's own scale, row by row (|o| falls like
        # T^-1/2, so at long T the elementwise bound is as large as o)
        rel, lim = row_rel_err(o, r), ROW_REL_LIMIT[str(dt)[6:]]
        check(ok and rel <= lim and on_lane and o.dtype == dt,
              f"flash {lane} ({B},{H},{Hkv},S={S},T={T},D={D}) "
              f"causal={causal} window={window} "
              f"{str(dt)[6:]}{' unaligned' if offset else ''}"
              f": max |kernel - plain| = "
              f"{err:.3g} (rtol = atol = {tol:g}), max row |kernel - "
              f"plain| / |plain| = {rel:.3g} (<= {lim:g})")
        if lane == "wgmma" and D == 256 and not offset:
            lse_err, same = lse_keeps_o(q, k, v, o, causal=causal,
                                        window=window)
            check(lse_err <= LSE_LIMIT and same,
                  f"  with its lse: within {lse_err:.3g} of the plain one "
                  f"(<= {LSE_LIMIT:g}), o the same bits: {same}")
        for key in (lane, "d256") if lane == "wgmma" and D == 256 else (lane,):
            worst[key] = max(worst[key], err)
            worst_rel[key] = max(worst_rel[key], rel)
    print(f"  largest row-relative error per lane: {worst_rel}")
    del q, k, v, o, r
    return worst


def yi_main_path(cuda, seed):
    """Yi-6B inference at full width through the port's entry points.
    Returns the launches of each flash lane counted over the run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import Transformer, count_params, model_defs
    from repro_torch.serving import ServeEngine

    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=cuda, seed=seed)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    check(n == count_params(model_defs(cfg)) == 6_061_035_520,
          f"yi-6b at full width on the card: {n:,} parameters in "
          f"{model.embed['tok'].dtype} "
          f"({time.perf_counter() - t0:.2f} s to draw)")
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (YI_BATCH, YI_PROMPT)), device=cuda)

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t0 = time.perf_counter()
    logits, aux = model(prompts, impl="cuda")
    torch.cuda.synchronize()
    print(f"  forward B={YI_BATCH} S={YI_PROMPT}: "
          f"{time.perf_counter() - t0:.3f} s (first call)")
    check(LAUNCHES["wgmma"] == LAUNCHES["fwd"] == cfg.n_layers,
          f"bf16 forward launched the tensor-core flash kernel "
          f"{LAUNCHES['wgmma']} times and the CUDA-core one "
          f"{LAUNCHES['fwd'] - LAUNCHES['wgmma']} times "
          f"(n_layers = {cfg.n_layers})")
    check(tuple(logits.shape) == (YI_BATCH, YI_PROMPT, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()) and float(aux) == 0.0,
          f"logits {tuple(logits.shape)} {logits.dtype}, finite")
    ref, _ = model(prompts, impl="ref")
    torch.cuda.synchronize()
    rel = rel_err(logits, ref)
    n_bad, n_pos, margins = top1_report(logits, ref)
    print(f"  forward cuda vs ref (bf16): max|dlogits|/max|logits| = "
          f"{rel:.3g}; top-1 differs at {n_bad} of {n_pos} positions "
          f"(ref top-2 margins there: {margins})")
    # bf16 tolerances as measured on the card (PERF.md §6): the logits
    # are bf16, so the top two are often equal or one spacing apart at a
    # 64,000-token vocabulary, and a rounding anywhere in 32 layers flips
    # them; the strict top-1 check is the float32 one below
    check(rel <= 3e-2 and n_bad <= 0.1 * n_pos,
          f"forward impl=cuda against impl=ref in bf16: relative error "
          f"{rel:.3g} <= 3e-2, top-1 agrees at {n_pos - n_bad} of {n_pos} "
          f"positions (>= 90%)")

    eng = ServeEngine(cfg, model, max_len=YI_PROMPT + YI_GEN + 1,
                      device=cuda)
    t0 = time.perf_counter()
    last, cache = eng.prefill(prompts)
    torch.cuda.synchronize()
    print(f"  ServeEngine.prefill B={YI_BATCH} S={YI_PROMPT}: "
          f"{time.perf_counter() - t0:.3f} s")
    rel = rel_err(last, logits[:, -1])
    n_bad, n_pos, margins = top1_report(last, logits[:, -1])
    print(f"  prefill vs forward[:, -1] (bf16): top-1 differs at {n_bad} "
          f"of {n_pos} (forward's top-2 margins there: {margins})")
    check(cache["length"] == YI_PROMPT and rel <= 3e-2,
          f"bf16 prefill logits against forward's last position: relative "
          f"error {rel:.3g} <= 3e-2")
    t0 = time.perf_counter()
    greedy = [eng.generate(prompts, YI_GEN, temperature=0.0)
              for _ in range(2)]
    sampled = eng.generate(prompts, YI_GEN, temperature=1.0, seed=seed)
    torch.cuda.synchronize()
    print(f"  generate x3 ({YI_BATCH} x {YI_GEN} tokens each, prefill "
          f"included): {time.perf_counter() - t0:.2f} s; greedy[0] "
          f"{greedy[0][0, :12].tolist()}")
    check(torch.equal(greedy[0], greedy[1])
          and tuple(greedy[0].shape) == (YI_BATCH, YI_GEN),
          "greedy generation repeats itself")
    check(int(sampled.min()) >= 0 and int(sampled.max()) < cfg.vocab_size,
          f"sampled tokens in [0, {cfg.vocab_size})")
    del model, eng, cache, logits, ref, last
    free_cuda()

    # the float32 copy: the same draws, kept in float32, TF32 off
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model = Transformer(cfg32, device=cuda, seed=seed)
    logits, _ = model(prompts)
    ref, _ = model(prompts, impl="ref")
    eng = ServeEngine(cfg32, model, max_len=YI_PROMPT + 1, device=cuda)
    last, _ = eng.prefill(prompts)
    torch.cuda.synchronize()
    for what, a, b in (("forward impl=cuda against impl=ref", logits, ref),
                       ("prefill logits against forward's last position",
                        last, logits[:, -1])):
        rel = rel_err(a, b)
        n_bad, n_pos, _ = top1_report(a, b)
        check(rel <= 1e-4 and n_bad == 0,
              f"f32 {what}: max|d|/max|logits| = {rel:.3g} <= 1e-4, top-1 "
              f"agrees at all {n_pos} positions")
    launches = {"wgmma": LAUNCHES["wgmma"],
                "f32": LAUNCHES["fwd"] - LAUNCHES["wgmma"]}
    check(launches == {"wgmma": cfg.n_layers, "f32": cfg.n_layers},
          f"flash launches over the main path: {launches} (the bf16 "
          f"forward on the tensor cores, the float32 one on the CUDA "
          f"cores, {cfg.n_layers} layers each)")
    del model, eng, logits, ref, last
    free_cuda()
    return launches


def yi_timing(cuda, seed, smi):
    """Times at the Yi-6B shapes; returns each flash lane's row at the Yi
    prefill shape for the JSON line (the tensor-core lane in bf16, the
    CUDA-core lane in float32). The CUDA-core lane is also timed at B = 4,
    S = 128 in float32 and in bf16 at head dim 96, which takes it."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.analysis.roofline import H100
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref,
                                                     kernel_lane)
    from repro_torch.models import Transformer, decode_step
    from repro_torch.serving import ServeEngine

    cfg = get_config("yi-6b")
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    rows = {}
    for (B, S), D, dt in (
            (YI_PREFILL, cfg.head_dim_, torch.bfloat16),
            ((YI_BATCH, YI_PROMPT), cfg.head_dim_, torch.bfloat16),
            (YI_PREFILL, cfg.head_dim_, torch.float32),
            ((YI_BATCH, YI_PROMPT), cfg.head_dim_, torch.float32),
            (YI_PREFILL, 96, torch.bfloat16)):
        g = torch.Generator(device=cuda).manual_seed(seed)
        q = torch.randn((B, H, S, D), generator=g, device=cuda).to(dt)
        k = torch.randn((B, Hkv, S, D), generator=g, device=cuda).to(dt)
        v = torch.randn((B, Hkv, S, D), generator=g, device=cuda).to(dt)
        lane = kernel_lane(dt, D)
        o = flash_attention(q, k, v, causal=True)
        r = flash_attention_ref(q, k, v, causal=True)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        err = float((o.float() - r.float()).abs().max())
        sdpa_err = float((sdpa().float() - r.float()).abs().max())
        t = {"kernel": cuda_ms(lambda: flash_attention(q, k, v, causal=True),
                               20),
             "plain": cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                          causal=True), 5),
             "sdpa": cuda_ms(sdpa, 20)}
        b_ms, b_by = bounds.attention_bound(q, k, v, True)
        f32_share = ""
        if lane == "f32":  # the CUDA-core lane's FMAs against their peak
            rate = bounds.attention_flops(q, k, True) / (t["kernel"] * 1e-3)
            f32_share = (f"{100 * rate / H100.peak_flops['float32']:.1f}% "
                         f"of the f32 peak, ")
        print(f"  flash {lane} lane B={B} H={H} Hkv={Hkv} S=T={S} D={D} "
              f"causal {str(dt)[6:]}: "
              f"kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"sdpa {t['sdpa']:.4f} ms (|diff| {sdpa_err:.3g}), bound "
              f"{b_ms:.4f} ms ({b_by}); kernel at "
              f"{100 * b_ms / t['kernel']:.1f}% of bound, {f32_share}"
              f"{t['sdpa'] / t['kernel']:.2f}x SDPA's speed [{smi}]")
        if (B, S) == YI_PREFILL and D == cfg.head_dim_:
            rows[lane] = dict(t, bound_ms=b_ms, bound_by=b_by, err=err)
            if lane == "f32":
                # the SM clock and the power drawn while the FMA-bound lane
                # runs (queued launches keep the card busy for ~1 s)
                for _ in range(int(1000 / t["kernel"])):
                    flash_attention(q, k, v, causal=True)
                load = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                     "power.draw", "--format=csv,noheader"],
                    capture_output=True, text=True, check=True).stdout
                torch.cuda.synchronize()
                print(f"  under the f32 lane's load: clocks.sm, "
                      f"clocks.max.sm, power.draw = {load.strip()}")
        del q, k, v, o, r

    model = Transformer(cfg, device=cuda, seed=seed)
    rng = np.random.default_rng(seed)
    for B, S in ((YI_BATCH, YI_PROMPT), YI_PREFILL):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device=cuda)
        model(tokens)
        torch.cuda.synchronize()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            model(tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"  forward B={B} S={S}: {ms:.2f} ms, prefill "
              f"{B * S / ms * 1e3:.0f} tokens/s [{smi}]")
        device_breakdown(lambda: model(tokens), f"forward B={B} S={S}", smi)
    # the prefill read for the dry run (int32 tokens, as launch.specs
    # makes them)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, YI_PREFILL), dtype=torch.int32,
        device=cuda)}
    params = model.param_tree()
    model(batch["tokens"])
    out, reading = memory_reading(lambda: model(batch["tokens"])[0],
                                  (params, batch))
    del out
    dry_step(f"the yi-6b prefill {YI_PREFILL}", cfg, "prefill", *YI_PREFILL,
             reading)
    del params, batch
    eng = ServeEngine(cfg, model, max_len=YI_PROMPT + 18, device=cuda)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (YI_BATCH, YI_PROMPT + 17)),
        device=cuda)
    _, cache = eng.prefill(tokens[:, :YI_PROMPT])
    decode_step(model, tokens[:, YI_PROMPT], cache)
    torch.cuda.synchronize()
    steps = 16
    t0 = time.perf_counter()
    for i in range(steps):
        decode_step(model, tokens[:, YI_PROMPT + 1 + i], cache)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"  decode_step B={YI_BATCH} at length {YI_PROMPT + 2}.."
          f"{YI_PROMPT + steps + 1}: {ms:.2f} ms per step, "
          f"{YI_BATCH / ms * 1e3:.1f} tokens/s [{smi}]")
    device_breakdown(lambda: decode_step(model, tokens[:, -1], cache),
                     f"decode_step B={YI_BATCH}", smi)
    del model, eng, cache
    free_cuda()
    return rows


def async_dp_main_path(smi):
    """The paper's asynchronous iteration applied to SGD (ROADMAP Queue 1
    item 9.1): `run_async_training_sim` at p = 4, seed 0, sync and async,
    uniform and with a straggler, with the DES views on the card (each
    block update reads its view once, takes the gradient in host numpy
    and uploads the new fragment), each run held count for count to the
    same run on the CPU."""
    import torch
    from repro_torch.core import DESConfig
    from repro_torch.training import run_async_training_sim
    for name, speeds in TRAIN_CASES:
        t0 = time.perf_counter()
        card = run_async_training_sim(p=4, ue_speed=speeds, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = run_async_training_sim(p=4, ue_speed=speeds, seed=0,
                                     device="cpu")
        wall_cpu = time.perf_counter() - t0
        print(f"  {name} (ue_speed {speeds}): sync {card.sync_iters} iters, "
              f"{card.sync_time:.4f} sim s, loss {card.sync_loss:.6f} | "
              f"async iters {card.async_iters_min}-{card.async_iters_max}, "
              f"{card.async_time:.4f} sim s, loss {card.async_loss:.6f} | "
              f"speedup {card.speedup:.4f}; wall {wall:.2f} s on the card, "
              f"{wall_cpu:.2f} s on the CPU [{smi}]")
        counts = ("sync_iters", "async_iters_min", "async_iters_max")
        check(all(getattr(card, f) == getattr(cpu, f) for f in counts),
              f"{name}: iterations on the card equal the CPU's "
              f"({[getattr(cpu, f) for f in counts]})")
        rel = max(abs(getattr(card, f) - getattr(cpu, f))
                  / abs(getattr(cpu, f))
                  for f in ("sync_time", "async_time", "speedup",
                            "sync_loss", "async_loss"))
        check(rel <= 1e-12,
              f"{name}: times, speedup and losses equal the CPU's (max "
              f"relative difference {rel:.3g} <= 1e-12)")
        check(card.speedup > 1.5 if speeds else card.speedup > 1.0,
              f"{name}: async beats sync, speedup {card.speedup:.3f}")
    # the card's share of a short run (the straggler case cut at 100
    # iterations: profiling the whole run costs ~40 s of trace handling)
    short = DESConfig(tol=2e-3, norm="l2", base_flops_rate=2e6,
                      bandwidth=2e5, msg_latency=1e-3, cancel_window=0.5,
                      max_iters=100, ue_speed=TRAIN_CASES[1][1],
                      normalize=False, seed=0)
    stats = device_breakdown(
        lambda: run_async_training_sim(p=4, cfg=short, seed=0),
        "run_async_training_sim straggler, max_iters 100 (sync + async)",
        smi)
    check(stats is not None and stats[0] > 0,
          "the training DES ran its fragment arithmetic on the card")


def moe_routing(fn, pin=None):
    """Run fn() with every MoE call of the decoder layers observed: returns
    fn()'s result and, per call, its routing (dict: assignments `n`, kept
    assignments `kept`, kept per expert `load`, `aux`, and the chosen
    experts `idx`, (B, S, K)). With `pin`, call i routes its (B, S)
    tokens to the experts pin(i, B, S) gives instead of its own top-k,
    with gate values from its own probabilities at those experts: a run
    then takes the routing decisions of another. Wraps the function the
    layers call (`models.transformer.moe_apply`) for the length of fn(),
    composing it from the port's `route` and `moe_experts` as it is."""
    import repro_torch.models.transformer as tr
    from repro_torch.models.moe import assign, moe_experts, route
    calls = []
    orig = tr.moe_apply

    def observed(p, x, cfg):
        B, S, D = x.shape
        tg = min(cfg.moe_group_size, B * S)
        xg = x.reshape((B * S) // tg, tg, D)
        probs, gates, idx = route(p, xg, cfg)
        if pin is not None:
            idx = pin(len(calls), B, S).reshape(idx.shape)
            gates = probs.gather(-1, idx)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        out, aux = moe_experts(p, xg, cfg, probs, gates, idx)
        mask, _ = assign(idx, cfg)
        calls.append(dict(n=B * S * cfg.top_k, kept=float(mask.sum()),
                          load=mask.sum(dim=(0, 1, 2)).cpu(),
                          aux=float(aux), idx=idx.reshape(B, S, -1)))
        return out.reshape(B, S, D), aux
    tr.moe_apply = observed
    try:
        return fn(), calls
    finally:
        tr.moe_apply = orig


def report_routing(calls, what, n_experts):
    """Print the drop share, the expert load and the aux loss of observed
    MoE calls; returns the drop share over all of them."""
    import torch
    total = sum(c["n"] for c in calls)
    kept = sum(c["kept"] for c in calls)
    drops = [1.0 - c["kept"] / c["n"] for c in calls]
    loads = torch.stack([c["load"] for c in calls])     # (calls, E)
    mean = loads.sum(dim=1) / n_experts
    imbalance = loads.max(dim=1).values / mean
    idle = int((loads == 0).sum())
    auxes = [c["aux"] for c in calls]
    share = 1.0 - kept / total
    print(f"  {what}: {len(calls)} MoE calls, {total:,} assignments, "
          f"dropped {100 * share:.3f}% (per layer {100 * min(drops):.3f}-"
          f"{100 * max(drops):.3f}%); expert load max/mean "
          f"{float(imbalance.min()):.2f}-{float(imbalance.max()):.2f}, "
          f"{idle} idle (layer, expert) pairs of {loads.numel()}; aux "
          f"{min(auxes):.4f}-{max(auxes):.4f} per layer, sum "
          f"{sum(auxes):.4f}")
    return share


def differing_choices(a, b):
    """How many (layer, token, k) expert choices differ between two runs'
    observed calls (as sets per token), and of how many."""
    diff = total = 0
    for ca, cb in zip(a, b):
        ia, ib = ca["idx"].sort(dim=-1).values, cb["idx"].sort(dim=-1).values
        diff += int((ia != ib).sum())
        total += ia.numel()
    return diff, total


def moe_main_path(cuda, seed, smi):
    """Qwen2-MoE-A2.7B inference at full width and depth (ROADMAP Queue 1
    item 10.1) through the port's entry points, random bf16 weights drawn
    on the card from `seed`: the forward of 4 prompts of 128 tokens
    through the tensor-core flash kernel (H = Hkv = 16, D = 128) and its
    routing (drops at capacity factor 1.25, expert load, aux loss); the
    same weights with the plain attention, held to the kernel's forward
    under the kernel run's routing decisions (routing is discontinuous:
    with its own, a bf16 rounding that moves a top-k choice or a capacity
    drop changes a token's output outright); greedy generation of 32
    tokens through ServeEngine; the decode path against the forward on
    8-token prompts; one 2048-token prefill. Returns the flash launches of
    the run and the model."""
    import numpy as np
    import torch
    from repro_torch.analysis.flops import total_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES, kernel_lane
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeEngine

    cfg = get_config(MOE_ARCH)
    L = cfg.n_layers
    check(kernel_lane(cfg.dtype(), cfg.head_dim_) == "wgmma",
          f"{MOE_ARCH} (bf16, head dim {cfg.head_dim_}) is on the "
          f"tensor-core flash lane")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=cuda, seed=seed)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    check(n == total_params(cfg) == 15_146_256_384,
          f"{MOE_ARCH} at full width on the card: {n:,} parameters "
          f"({L} layers, {cfg.n_experts} experts top-{cfg.top_k}, "
          f"{cfg.n_shared_experts} shared), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"({time.perf_counter() - t0:.2f} s to draw) [{smi}]")
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (YI_BATCH, YI_PROMPT)), device=cuda)
    long = torch.as_tensor(rng.integers(0, cfg.vocab_size, YI_PREFILL),
                           device=cuda)

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t0 = time.perf_counter()
    (logits, aux), calls = moe_routing(lambda: model(prompts, impl="cuda"))
    torch.cuda.synchronize()
    print(f"  forward B={YI_BATCH} S={YI_PROMPT}: "
          f"{time.perf_counter() - t0:.3f} s (first call, routing observed)")
    check(tuple(logits.shape) == (YI_BATCH, YI_PROMPT, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} {logits.dtype}, finite")
    share = report_routing(calls, f"routing of the forward, capacity "
                           f"factor {cfg.capacity_factor}", cfg.n_experts)
    check(len(calls) == L and 0.0 <= share < 0.5
          and abs(float(aux) - sum(c["aux"] for c in calls))
          <= 1e-4 * float(aux)
          and 0.0 < float(aux) < L * cfg.n_experts,
          f"every layer routed; {100 * share:.3f}% of assignments dropped "
          f"(< 50%); the forward's aux {float(aux):.4f} is the layers' sum")

    # the plain attention under the kernel run's routing: the Yi-6B
    # phase's bf16 tolerances
    (ref, ref_aux), pinned = moe_routing(
        lambda: model(prompts, impl="ref"),
        pin=lambda i, B, S: calls[i]["idx"])
    torch.cuda.synchronize()
    rel = rel_err(logits, ref)
    n_bad, n_pos, margins = top1_report(logits, ref)
    print(f"  forward cuda vs ref (bf16), the ref routed as the kernel "
          f"run: max|dlogits|/max|logits| = {rel:.3g}; top-1 agrees at "
          f"{n_pos - n_bad} of {n_pos} positions (ref top-2 margins where "
          f"it differs: {margins}); aux {float(aux):.6f} / "
          f"{float(ref_aux):.6f}")
    check(rel <= 3e-2 and n_bad <= 0.1 * n_pos,
          f"forward impl=cuda against impl=ref in bf16 under one routing: "
          f"relative error {rel:.3g} <= 3e-2, top-1 agrees at "
          f"{n_pos - n_bad} of {n_pos} positions (>= 90%)")
    (free, _), own = moe_routing(lambda: model(prompts, impl="ref"))
    torch.cuda.synchronize()
    diff, total = differing_choices(calls, own)
    n_bad, n_pos, _ = top1_report(logits, free)
    print(f"  for the record, the ref with its own routing: "
          f"max|dlogits|/max|logits| = {rel_err(logits, free):.3g}, top-1 "
          f"agrees at {n_pos - n_bad} of {n_pos}; {diff} of {total:,} "
          f"(layer, token, k) expert choices differ from the kernel run's")
    report_routing(own, "the ref's own routing", cfg.n_experts)
    del ref, free, pinned, own

    eng = ServeEngine(cfg, model, max_len=YI_PROMPT + YI_GEN + 1,
                      device=cuda)
    t0 = time.perf_counter()
    greedy = eng.generate(prompts, YI_GEN, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = YI_PROMPT + YI_GEN - 1
    print(f"  ServeEngine.generate {YI_BATCH} x {YI_GEN} tokens greedy "
          f"after a {YI_PROMPT}-token prompt: {wall:.2f} s for {steps} "
          f"decode steps ({wall / steps * 1e3:.1f} ms a step); greedy[0] "
          f"{greedy[0, :12].tolist()} [{smi}]")
    check(tuple(greedy.shape) == (YI_BATCH, YI_GEN)
          and int(greedy.min()) >= 0 and int(greedy.max()) < cfg.vocab_size,
          f"greedy tokens ({YI_BATCH}, {YI_GEN}) in [0, {cfg.vocab_size})")
    # decode against the forward, drop-free (8 positions route 32 tokens,
    # far below an expert's capacity of 40 a group), each decode step
    # routed as the forward routed its tokens
    short = prompts[:, :8]
    (fwd, _), fwd_calls = moe_routing(lambda: model(short))
    (last, _), _ = moe_routing(
        lambda: eng.prefill(short),
        pin=lambda i, B, S: fwd_calls[i % L]["idx"][:, i // L][:, None])
    torch.cuda.synchronize()
    rel = rel_err(last, fwd[:, -1])
    n_bad, n_pos, _ = top1_report(last, fwd[:, -1])
    check(all(c["kept"] == c["n"] for c in fwd_calls) and rel <= 3e-2
          and n_bad <= 0.1 * n_pos,
          f"8-token prompts (no assignment dropped): prefill through the "
          f"decode path against the forward's last position under one "
          f"routing, relative error {rel:.3g} <= 3e-2, top-1 agrees at "
          f"{n_pos - n_bad} of {n_pos}")

    t0 = time.perf_counter()
    (out, _), long_calls = moe_routing(lambda: model(long))
    torch.cuda.synchronize()
    print(f"  prefill forward B={YI_PREFILL[0]} S={YI_PREFILL[1]}: "
          f"{time.perf_counter() - t0:.3f} s (first call, routing observed)")
    check(bool(torch.isfinite(out).all()),
          f"{YI_PREFILL[1]}-token prefill finite")
    report_routing(long_calls, f"routing of the {YI_PREFILL[1]}-token "
                   f"prefill", cfg.n_experts)
    launches = {"wgmma": LAUNCHES["wgmma"],
                "f32": LAUNCHES["fwd"] - LAUNCHES["wgmma"]}
    # the forwards with impl "auto"/"cuda": prompts, 8-token prompts, 2048
    check(launches == {"wgmma": 3 * L, "f32": 0},
          f"flash launches over the main path: {launches} (3 forwards x "
          f"{L} layers on the tensor cores, none on the CUDA cores; decode "
          f"attends over its cache without the kernel)")
    del logits, out, fwd, last, eng, greedy, calls, fwd_calls, long_calls
    free_cuda()
    return launches, model


def moe_timing(cuda, model, seed, smi):
    """Times of Qwen2-MoE-A2.7B on the card: the flash kernel at the MoE
    prefill shape (MHA, H = Hkv = 16) beside its plain version, SDPA and
    the bound; the forward at B = 4, S = 128 and B = 1, S = 2048 (prefill
    tokens/s, the card's busy share in one forward); the decode step at
    B = 4. Returns the measured times for the roofline phase."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.models import decode_step
    from repro_torch.serving import ServeEngine

    cfg = model.cfg
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    B, S = YI_PREFILL
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((B, h, S, D), generator=g, device=cuda)
               .to(torch.bfloat16) for h in (H, Hkv, Hkv))

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    o = flash_attention(q, k, v, causal=True)
    r = flash_attention_ref(q, k, v, causal=True)
    err = float((o.float() - r.float()).abs().max())
    t = {"kernel": cuda_ms(lambda: flash_attention(q, k, v, causal=True),
                           20),
         "plain": cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                          5),
         "sdpa": cuda_ms(sdpa, 20)}
    b_ms, b_by = bounds.attention_bound(q, k, v, True)
    print(f"  flash wgmma lane B={B} H={H} Hkv={Hkv} S=T={S} D={D} causal "
          f"bf16: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
          f"sdpa {t['sdpa']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); kernel "
          f"at {100 * b_ms / t['kernel']:.1f}% of bound, "
          f"{t['sdpa'] / t['kernel']:.2f}x SDPA's speed; max |kernel - "
          f"plain| {err:.3g} [{smi}]")
    del q, k, v, o, r
    times = {"flash": dict(t, bound_ms=b_ms, bound_by=b_by, err=err)}

    rng = np.random.default_rng(seed)
    for B, S in ((YI_BATCH, YI_PROMPT), YI_PREFILL):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device=cuda)
        model(tokens)
        torch.cuda.synchronize()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            model(tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"  forward B={B} S={S}: {ms:.2f} ms, prefill "
              f"{B * S / ms * 1e3:.0f} tokens/s [{smi}]")
        stats = device_breakdown(lambda: model(tokens),
                                 f"forward B={B} S={S}", smi)
        times[("forward", B, S)] = (ms, stats)
    eng = ServeEngine(cfg, model, max_len=24, device=cuda)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (YI_BATCH, 24)),
                             device=cuda)
    _, cache = eng.prefill(tokens[:, :4])
    torch.cuda.synchronize()
    steps = 16
    t0 = time.perf_counter()
    for i in range(steps):
        decode_step(model, tokens[:, 4 + i], cache)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"  decode_step B={YI_BATCH} at length 5..{4 + steps}: {ms:.2f} ms "
          f"per step, {YI_BATCH / ms * 1e3:.1f} tokens/s [{smi}]")
    _, calls = moe_routing(
        lambda: decode_step(model, tokens[:, 4 + steps], cache))
    stats = device_breakdown(
        lambda: decode_step(model, tokens[:, 5 + steps], cache),
        f"decode_step B={YI_BATCH}", smi)
    hit = [int((c["load"] > 0).sum()) for c in calls]
    times["decode"] = (ms, stats, hit, 4 + steps)
    del eng, cache
    return times


def analysis_phase(cfg, times, smi):
    """The roofline (`repro_torch.analysis`) of one MoE prefill of 2048
    tokens and one decode step at B = 4 on one H100, from counts, beside
    the measured times. FLOPs: `model_flops_cell` (2 x active parameters
    x tokens, the JAX package's count, which takes the shared experts at
    top_k / n_experts), plus the shared experts' remainder and the
    attention's 4 D flops a (query, key) pair and head. Bytes: every
    weight the step must read, once (for decode only the experts its
    tokens were routed to, as recorded), the embedding rows, the logits
    written, and for decode the KV cache read."""
    from repro_torch.analysis import from_counts, model_flops_cell
    from repro_torch.analysis.flops import _leaf_counts
    counts = _leaf_counts(cfg)
    item = cfg.pdtype().itemsize
    router = sum(n for k, n in counts if k.endswith("moe/router"))
    routed = sum(n for k, n in counts
                 if "/moe/w_" in k and "/shared/" not in k)
    shared = sum(n for k, n in counts if "/moe/shared/" in k)
    embed_tok = dict(counts)["embed/tok"]
    rest = sum(n for _, n in counts) - routed - router - embed_tok
    H, D, L, V = cfg.n_heads, cfg.head_dim_, cfg.n_layers, cfg.padded_vocab
    per_expert = routed // (L * cfg.n_experts)

    def flops(shape, tokens, pairs):
        model = model_flops_cell(cfg, shape)
        full = model + 2.0 * tokens * shared * (
            1 - cfg.top_k / cfg.n_experts)
        return model, full + 4.0 * H * D * pairs * L

    B, S = YI_PREFILL
    ms_prefill = times[("forward", B, S)][0]
    ms_decode, _, hit, t_len = times["decode"]
    kv_read = 2 * L * YI_BATCH * cfg.n_kv_heads * t_len * D * item
    cells = [
        (f"prefill B={B} S={S}",
         *flops(dict(kind="prefill", batch=B, seq=S), B * S,
                B * S * (S + 1) // 2),
         (rest + routed) * item + router * 4
         + B * S * (cfg.d_model + V) * item, ms_prefill),
        (f"decode step B={YI_BATCH} at length {t_len} (experts hit per "
         f"layer {min(hit)}-{max(hit)} of {cfg.n_experts})",
         *flops(dict(kind="decode", batch=YI_BATCH), YI_BATCH,
                YI_BATCH * t_len),
         (rest + sum(hit) * per_expert) * item + router * 4
         + YI_BATCH * (cfg.d_model + V) * item + kv_read, ms_decode),
    ]
    for what, model, total, nbytes, ms in cells:
        r = from_counts(total, nbytes)
        print(f"  roofline of the {what}: model FLOPs (model_flops_cell) "
              f"{model / 1e12:.4f} T, with the shared experts in full and "
              f"attention {total / 1e12:.4f} T; {nbytes / 1e9:.3f} GB -> "
              f"compute {r.compute_s * 1e3:.3f} ms, memory "
              f"{r.memory_s * 1e3:.3f} ms: {r.dominant}-bound, bound "
              f"{r.bound_s * 1e3:.3f} ms; measured {ms:.2f} ms, "
              f"{100 * r.bound_s * 1e3 / ms:.1f}% of the bound [{smi}]")
        check(r.dominant in ("compute", "memory") and r.collective_s == 0.0,
              f"{what}: {r.dominant}-bound by the H100 constants, no "
              f"collective term on one card")


def scans_against_plain(arch, cuda, seed):
    """The model's scan kernel (ssd_scan for Mamba2, rglru_scan for
    RecurrentGemma) against its plain version at the main path's shapes:
    the 4 x 128 prompts, the long prefill and a decode step (B = 4, S = 1,
    from a state). Tolerances: float32 against float32 summed in other
    orders, so 1e-4 of the largest value for the SSD's y and state (bf16
    y: 1e-2, one rounding of y) and 1e-5 for the RG-LRU's h (the kernel
    steps through each chunk from its carry, the plain version is a
    log-depth tree). Returns the largest |kernel - plain| of the sequences
    ("scan") and of the decode step ("step")."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    dtype = cfg.dtype()
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=g, device=cuda) * scale).to(dt)
    shapes = [(RECUR_BATCH, RECUR_PROMPT, False),
              (*RECUR_ARCHS[arch]["prefill"], False),
              (RECUR_BATCH, 1, True)]
    worst = {"scan": 0.0, "step": 0.0}
    for B, S, with_h0 in shapes:
        key = "step" if S == 1 else "scan"
        if arch == "mamba2-2.7b":
            from repro_torch.kernels.ssd_scan import (ssd_scan_kernel,
                                                      ssd_scan_ref)
            H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
            args = (randn(B, S, H, P, dt=dtype),
                    randn(B, S, N, scale=0.3, dt=dtype),
                    randn(B, S, N, scale=0.3, dt=dtype),
                    torch.nn.functional.softplus(randn(B, S, H) - 1.0),
                    randn(H, scale=0.5), cfg.ssm_chunk)
            h0 = randn(B, H, P, N) if with_h0 else None
            y, h = ssd_scan_kernel(*args, h0=h0)
            yr, hr = ssd_scan_ref(*args, h0=h0)
            torch.cuda.synchronize()
            tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
            ey = float((y.float() - yr.float()).abs().max())
            eh = float((h - hr).abs().max())
            ok = (ey <= tol * float(yr.float().abs().max())
                  and eh <= 1e-4 * float(hr.abs().max()))
            check(ok, f"ssd_scan B={B} S={S} H={H} P={P} N={N} "
                  f"Q={cfg.ssm_chunk} {str(dtype)[6:]} h0={with_h0}: "
                  f"max |y - plain| {ey:.3g} (<= {tol:g} x max |y|), max "
                  f"|state - plain| {eh:.3g} (<= 1e-4 x max |state|)")
            worst[key] = max(worst[key], ey, eh)
        else:
            from repro_torch.kernels.rglru_scan import (rglru_scan_kernel,
                                                        rglru_scan_ref)
            W = cfg.lru_width_
            args = (randn(B, S, W, dt=dtype), randn(B, S, W),
                    randn(B, S, W), randn(W, scale=0.5), randn(W, scale=0.5),
                    randn(W) + 1.0)
            h0 = randn(B, W) if with_h0 else None
            h = rglru_scan_kernel(*args, h0=h0)
            r = rglru_scan_ref(*args, h0=h0)
            torch.cuda.synchronize()
            err = float((h - r).abs().max())
            check(err <= 1e-5 * float(r.abs().max()),
                  f"rglru_scan B={B} S={S} W={W} u {str(dtype)[6:]} "
                  f"h0={with_h0}: max |h - plain| {err:.3g} (<= 1e-5 x "
                  f"max |h|)")
            worst[key] = max(worst[key], err)
    return worst


@contextmanager
def scans_held_to_plain(held):
    """For the length of the block, every call of the SSD and RG-LRU
    layers' scans that launches its kernel (its count rises) is run again
    through the plain version on the same inputs: the main path's own
    activations. Appends to held["ssd"] (max |y - plain|, its share of
    max |y|, max |state - plain|, its share of max |state|) and to
    held["rglru"] (max |h - plain|, its share of max |h|) for each call.
    The plain calls launch nothing."""
    from repro_torch.kernels.rglru_scan import LAUNCHES as LRU
    from repro_torch.kernels.rglru_scan import rglru_scan_ref
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.kernels.ssd_scan import ssd_scan_ref
    from repro_torch.models import rglru, ssm
    ssd0, lru0 = ssm.ssd_scan, rglru.rglru_scan

    def errs(a, r):
        d = float((a.float() - r.float()).abs().max())
        return d, d / max(float(r.float().abs().max()), 1e-30)

    def ssd(x, b, c, dt, a_log, chunk, h0=None, impl="auto"):
        before = sum(SSD.values())
        y, h = ssd0(x, b, c, dt, a_log, chunk, h0=h0, impl=impl)
        if sum(SSD.values()) != before:
            yr, hr = ssd_scan_ref(x, b, c, dt, a_log, chunk, h0)
            held["ssd"].append((*errs(y, yr), *errs(h, hr)))
        return y, h

    def lru(u, ga, gi, b_a, b_i, lam, h0=None, impl="auto"):
        before = sum(LRU.values())
        h = lru0(u, ga, gi, b_a, b_i, lam, h0=h0, impl=impl)
        if sum(LRU.values()) != before:
            held["rglru"].append(errs(h, rglru_scan_ref(u, ga, gi, b_a, b_i,
                                                        lam, h0)))
        return h

    ssm.ssd_scan, rglru.rglru_scan = ssd, lru
    try:
        yield held
    finally:
        ssm.ssd_scan, rglru.rglru_scan = ssd0, lru0


def check_held_scans(held, n, dtype, what):
    """The checks of `scans_held_to_plain`'s record of one forward: one
    call per recurrent layer, each within the tolerances of
    `scans_against_plain` (SSD y 1e-2 of its largest value in bf16, 1e-4
    in float32, its state 1e-4; RG-LRU h 1e-5). Returns the largest
    absolute error."""
    import torch
    worst = 0.0
    if n["ssd"]:
        calls = held["ssd"]
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        ey, eh = (max(c[i] for c in calls) for i in (1, 3))
        check(len(calls) == n["ssd"] and ey <= tol and eh <= 1e-4,
              f"ssd_scan on the {what}'s own activations, {len(calls)} "
              f"of {n['ssd']} layers: max |y - plain| / max |y| {ey:.3g} "
              f"<= {tol:g}, max |state - plain| / max |state| {eh:.3g} "
              f"<= 1e-4")
        worst = max(max(c[0] for c in calls), max(c[2] for c in calls))
    if n["rglru"]:
        calls = held["rglru"]
        eh = max(c[1] for c in calls)
        check(len(calls) == n["rglru"] and eh <= 1e-5,
              f"rglru_scan on the {what}'s own activations, {len(calls)} "
              f"of {n['rglru']} layers: max |h - plain| / max |h| "
              f"{eh:.3g} <= 1e-5")
        worst = max(c[0] for c in calls)
    return worst


def recurrent_main_path(arch, cuda, seed, smi):
    """Mamba2-2.7B or RecurrentGemma-2B inference at full width and depth
    (ROADMAP Queue 1 items 10.2-10.3) through the port's entry points,
    random bf16 weights drawn on the card from `seed`: the forward of 4
    prompts of 128 tokens and one long prefill (2048 tokens; 4096 for
    RecurrentGemma, past its window of 2048), the decode path
    (ServeEngine.prefill through the recurrent states and the ring KV
    cache) and greedy generation of 32 tokens; then the same draws kept
    in float32 (TF32 off), whose forwards take the scans in float32 and,
    for RecurrentGemma, the CUDA-core flash lane at head dim 256.

    The checks: in float32 each scan held to its plain version on the
    forward's own activations (`scans_held_to_plain`, 1e-4), the kernels'
    forward against impl="ref" to 1e-4 of the largest logit (the Yi-6B
    copy's bound) over all positions and at the last one (Mamba2's first
    positions carry any rounding of its scans far, so the SSD kernel's
    float32 path rounds as the plain einsums do: ssd_scan.cu's note), and
    the decode path against the forward to 1e-4. In bf16, rounding is the
    larger error:
    Mamba2's 64 layers under random weights carry a one-ulp change far
    (the bf16 forward lies 0.15-0.5 of the largest logit from the float32
    one, through the kernels or the plain versions alike, measured on
    one H100), so the bf16 kernels' forward is held to the float32 forward
    no further than the bf16 plain versions' forward is (within 25% and
    1e-3), with top-1 agreement >= 90% against the plain versions; the
    scans themselves are held to their plain versions at their own
    tolerances on the bf16 forward's activations (`scans_held_to_plain`).
    For RecurrentGemma the float32 draws also decode past a window of
    RING_WINDOW (`ring_main_path`). The launches of the flash kernel,
    ssd_scan and rglru_scan are read around it all. Returns the launches,
    the scans' largest error on the activations and the bf16 model."""
    import numpy as np
    import torch
    from repro_torch.analysis.flops import total_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES as FLASH
    from repro_torch.kernels.flash_attention import kernel_lane
    from repro_torch.kernels.rglru_scan import LAUNCHES as LRU
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeEngine

    cfg = get_config(arch)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    kinds = cfg.layer_kinds()
    n = {k: kinds.count(k) for k in ("ssd", "rglru", "local_attn")}
    if n["local_attn"]:
        check(kernel_lane(cfg.dtype(), cfg.head_dim_) == "wgmma"
              and kernel_lane(cfg32.dtype(), cfg.head_dim_) == "f32",
              f"{arch}'s local attention (head dim {cfg.head_dim_}) is on "
              f"the tensor-core flash lane in bf16, the CUDA-core lane in "
              f"float32")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=cuda, seed=seed)
    torch.cuda.synchronize()
    count = sum(p.numel() for p in model.parameters())
    check(count == total_params(cfg) == RECUR_ARCHS[arch]["params"],
          f"{arch} at full width and depth on the card: {count:,} "
          f"parameters, layers {n} (window {cfg.local_window}), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"({time.perf_counter() - t0:.2f} s to draw) [{smi}]")
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (RECUR_BATCH, RECUR_PROMPT)),
        device=cuda)
    long = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        RECUR_ARCHS[arch]["prefill"]),
                           device=cuda)
    inputs = (prompts, long)

    for counts in (FLASH, SSD, LRU):
        for key in counts:
            counts[key] = 0
    bf16 = []
    held_err = 0.0
    for tokens in inputs:
        B, S = tokens.shape
        t0 = time.perf_counter()
        held = {"ssd": [], "rglru": []}
        with scans_held_to_plain(held):
            out, _ = model(tokens, impl="cuda")
        torch.cuda.synchronize()
        check(tuple(out.shape) == (B, S, cfg.padded_vocab)
              and bool(torch.isfinite(out).all()),
              f"bf16 forward B={B} S={S}: logits {tuple(out.shape)}, finite "
              f"({time.perf_counter() - t0:.3f} s, first call, each scan "
              f"also run through its plain version)")
        held_err = max(held_err, check_held_scans(
            held, n, cfg.dtype(), f"bf16 forward B={B} S={S}"))
        ref, _ = model(tokens, impl="ref")
        bf16.append((out, ref))
    eng = ServeEngine(cfg, model, max_len=RECUR_PROMPT + RECUR_GEN + 1,
                      device=cuda)
    t0 = time.perf_counter()
    last, cache = eng.prefill(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(cache["length"] == RECUR_PROMPT
          and bool(torch.isfinite(last).all()),
          f"bf16 ServeEngine.prefill B={RECUR_BATCH} S={RECUR_PROMPT} "
          f"through decode_step: {wall:.2f} s "
          f"({wall / RECUR_PROMPT * 1e3:.1f} ms a step), logits finite")
    t0 = time.perf_counter()
    greedy = eng.generate(prompts, RECUR_GEN, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = RECUR_PROMPT + RECUR_GEN - 1
    print(f"  ServeEngine.generate {RECUR_BATCH} x {RECUR_GEN} tokens greedy "
          f"after a {RECUR_PROMPT}-token prompt: {wall:.2f} s for {steps} "
          f"decode steps ({wall / steps * 1e3:.1f} ms a step); greedy[0] "
          f"{greedy[0, :12].tolist()} [{smi}]")
    check(tuple(greedy.shape) == (RECUR_BATCH, RECUR_GEN)
          and int(greedy.min()) >= 0 and int(greedy.max()) < cfg.vocab_size,
          f"greedy tokens ({RECUR_BATCH}, {RECUR_GEN}) in [0, "
          f"{cfg.vocab_size})")
    del eng, cache, greedy

    # the same draws in float32
    model32 = Transformer(cfg32, device=cuda, seed=seed)
    for tokens, (out, ref) in zip(inputs, bf16):
        B, S = tokens.shape
        held32 = {"ssd": [], "rglru": []}
        with scans_held_to_plain(held32):
            out32, _ = model32(tokens, impl="cuda")
        ref32, _ = model32(tokens, impl="ref")
        torch.cuda.synchronize()
        held_err = max(held_err, check_held_scans(
            held32, n, cfg32.dtype(), f"f32 forward B={B} S={S}"))
        rel = rel_err(out32, ref32)
        rel_last = rel_err(out32[:, -1], ref32[:, -1])
        n_bad, n_pos, _ = top1_report(out32, ref32)
        check(rel <= 1e-4 and rel_last <= 1e-4 and n_bad == 0,
              f"f32 forward B={B} S={S} impl=cuda against impl=ref: "
              f"max|d|/max|logits| = {rel:.3g} <= 1e-4, at the last "
              f"position {rel_last:.3g} <= 1e-4, top-1 agrees at all "
              f"{n_pos} positions")
        e_k, e_p = rel_err(out, ref32), rel_err(ref, ref32)
        n_bad, n_pos, margins = top1_report(out, ref)
        print(f"  bf16 forward B={B} S={S}: kernels against plain "
              f"{rel_err(out, ref):.3g}; from the float32 forward: kernels "
              f"{e_k:.3g}, plain {e_p:.3g}; top-1 differs at {n_bad} of "
              f"{n_pos} (plain top-2 margins there: {margins[:6]})")
        check(e_k <= 1.25 * e_p + 1e-3 and n_bad <= 0.1 * n_pos,
              f"bf16 forward B={B} S={S}: the kernels' distance to the "
              f"float32 forward {e_k:.3g} <= 1.25 x the plain versions' "
              f"{e_p:.3g} + 1e-3, top-1 agrees with the plain versions at "
              f"{n_pos - n_bad} of {n_pos} (>= 90%)")
        if S == RECUR_PROMPT:
            fwd32_last = out32[:, -1].clone()
            e_last = rel_err(last, fwd32_last)
            e_fwd = rel_err(out[:, -1], fwd32_last)
        del out32, ref32
    eng32 = ServeEngine(cfg32, model32, max_len=RECUR_PROMPT + 1,
                        device=cuda)
    last32, _ = eng32.prefill(prompts)
    torch.cuda.synchronize()
    rel = rel_err(last32, fwd32_last)
    n_bad, n_pos, _ = top1_report(last32, fwd32_last)
    ring = ", ring KV cache" if n["local_attn"] else ""
    check(rel <= 1e-4 and n_bad == 0,
          f"f32 decode path (recurrent states{ring}) against the forward's "
          f"last position: {rel:.3g} <= 1e-4, top-1 agrees at all {n_pos}")
    print(f"  for the record, bf16: the decode path's last logits lie "
          f"{e_last:.3g} from the float32 forward's, the bf16 forward's "
          f"{e_fwd:.3g}")
    del bf16, model32, eng32, last, last32, fwd32_last
    free_cuda()

    forwards = {"bf16": 2, "f32": 2}
    steps = {"bf16": RECUR_PROMPT + RECUR_PROMPT + RECUR_GEN - 1,
             "f32": RECUR_PROMPT}
    if n["local_attn"]:
        ring_main_path(cfg32, prompts, cuda, seed, n)
        forwards["f32 ring"], steps["f32 ring"] = 1, RECUR_PROMPT

    launches = {"flash": FLASH["wgmma"], "flash_f32": FLASH["fwd"]
                - FLASH["wgmma"], "ssd": SSD["scan"], "ssd_step": SSD["step"],
                "rglru": LRU["scan"], "rglru_step": LRU["step"]}
    # ssd_scan is three launches over a sequence (chunk states, carry, y),
    # rglru_scan one; a decode step is one launch of each step kernel
    n_fwd, n_steps = sum(forwards.values()), sum(steps.values())
    want = {"flash": forwards["bf16"] * n["local_attn"],
            "flash_f32": (n_fwd - forwards["bf16"]) * n["local_attn"],
            "ssd": 3 * n_fwd * n["ssd"], "ssd_step": n_steps * n["ssd"],
            "rglru": n_fwd * n["rglru"], "rglru_step": n_steps * n["rglru"]}
    check(launches == want,
          f"launches over the main path: {launches} ({forwards} forwards "
          f"x the layers of each kind, and {steps} decode steps x the "
          f"recurrent layers; decode attends over its ring without the "
          f"kernel)")
    return launches, held_err, model


def ring_main_path(cfg32, prompts, cuda, seed, n):
    """The decode path's ring KV cache wrapping on the card: the float32
    draws with a local window of RING_WINDOW under the 128-token prompts,
    their windowed forward (the CUDA-core flash lane) against impl="ref",
    and ServeEngine.prefill (128 decode steps through rings of
    RING_WINDOW slots) against the forward's last position, to 1e-4 of
    the largest logit as for the unwindowed float32 copy."""
    import torch
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeEngine
    cfg = dataclasses.replace(cfg32, local_window=RING_WINDOW)
    model = Transformer(cfg, device=cuda, seed=seed)
    out, _ = model(prompts, impl="cuda")
    ref, _ = model(prompts, impl="ref")
    eng = ServeEngine(cfg, model, max_len=RECUR_PROMPT + 1, device=cuda)
    last, cache = eng.prefill(prompts)
    torch.cuda.synchronize()
    rings = [c for c, kind in zip(cache["layers"], cfg.layer_kinds())
             if kind == "local_attn"]
    held = list(range(RECUR_PROMPT - RING_WINDOW, RECUR_PROMPT))
    wrapped = len(rings) == n["local_attn"] and all(
        c["k"].shape[2] == RING_WINDOW
        and sorted(c["slot_pos"].tolist()) == held for c in rings)
    e_fwd, e_dec = rel_err(out, ref), rel_err(last, out[:, -1])
    n_bad, n_pos, _ = top1_report(last, out[:, -1])
    check(wrapped and e_fwd <= 1e-4 and e_dec <= 1e-4 and n_bad == 0,
          f"f32 ring KV cache past a window of {RING_WINDOW}: "
          f"{RECUR_PROMPT} decode steps through {len(rings)} rings of "
          f"{RING_WINDOW} slots, each holding positions {held[0]}-"
          f"{held[-1]}; the windowed forward impl=cuda against impl=ref "
          f"{e_fwd:.3g} <= 1e-4, the decode path against its last position "
          f"{e_dec:.3g} <= 1e-4, top-1 agrees at all {n_pos}")
    del model, eng, cache, out, ref, last
    free_cuda()


def scan_times(cuda, seed, long_lru=()):
    """The two scan kernels and their plain versions timed (`cuda_ms`) at
    the main path's shapes, on inputs drawn on the card from `seed`:
    ssd_scan at Mamba2-2.7B's widths over 1 x 2048 bf16 ("ssd") and its
    decode step at 4 x 1 float32 from a state ("ssd_step"), rglru_scan at
    RecurrentGemma-2B's W = 2560 over 1 x 4096 bf16 ("rglru"), over
    1 x S for each S of `long_lru` ("rglru_<S>") and its decode step at
    4 x 1 from a state ("rglru_step"). The decode steps
    cycle through DECODE_SETS input sets, so that their states come from
    device memory. Each row: "kernel" and "plain" ms, "err" (max |kernel
    - plain|), "scale" (max |plain|), "launches" (the counts' rise over
    one kernel call) and "inputs" (the bound functions' arguments, on the
    meta device). Only the scans' public functions and the configs are
    imported, so tools/time_scans.py times another checkout of the port
    by the same method."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru_scan import LAUNCHES as LRU
    from repro_torch.kernels.rglru_scan import (rglru_scan_kernel,
                                                rglru_scan_ref)
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel, ssd_scan_ref

    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=cuda)).to(
            dtype)

    def meta(*ts):
        return tuple(t.to("meta") for t in ts)

    def row(kernel, plain, counts, inputs, sets=1):
        """kernel() and plain() over the first input set; with `sets`,
        each takes the set's index."""
        before = sum(counts.values())
        out = kernel(0)
        launches = sum(counts.values()) - before
        ref = plain(0)
        pairs = list(zip(*(o if isinstance(o, tuple) else (o,)
                           for o in (out, ref))))
        err = max(float((a.float() - r.float()).abs().max())
                  for a, r in pairs)
        scale = max(float(r.float().abs().max()) for _, r in pairs)
        del out, ref, pairs
        reps = 8 * sets if sets > 1 else 20
        return {"kernel": cuda_ms(cycle_index(kernel, sets), reps),
                "plain": cuda_ms(cycle_index(plain, sets),
                                 sets if sets > 1 else 3),
                "err": err, "scale": scale, "launches": launches,
                "inputs": inputs}

    times = {}
    mb = get_config("mamba2-2.7b")
    H, P, N, Q = mb.ssm_heads, mb.ssm_headdim, mb.ssm_state, mb.ssm_chunk
    bf = torch.bfloat16
    B, S = RECUR_ARCHS["mamba2-2.7b"]["prefill"]
    x = randn(B, S, H, P, dtype=bf)
    b, c = (randn(B, S, N, scale=0.3, dtype=bf) for _ in range(2))
    dt = F.softplus(randn(B, S, H) - 1.0)
    a_log = randn(H, scale=0.5)
    args = (x, b, c, dt, a_log, Q)
    times["ssd"] = row(lambda i: ssd_scan_kernel(*args),
                       lambda i: ssd_scan_ref(*args), SSD, meta(x, b, dt))
    del x, b, c, dt, args

    # the decode step (B = 4, S = 1, float32 x, b, c as ssd_step passes
    # them)
    B = RECUR_BATCH
    sets = [(randn(B, 1, H, P), randn(B, 1, N, scale=0.3),
             randn(B, 1, N, scale=0.3), F.softplus(randn(B, 1, H) - 1.0),
             a_log, Q, randn(B, H, P, N)) for _ in range(DECODE_SETS)]
    times["ssd_step"] = row(
        lambda i: ssd_scan_kernel(*sets[i][:6], h0=sets[i][6]),
        lambda i: ssd_scan_ref(*sets[i][:6], h0=sets[i][6]), SSD,
        meta(sets[0][0], sets[0][1], sets[0][6]), sets=DECODE_SETS)
    del sets
    free_cuda()

    rg = get_config("recurrentgemma-2b")
    Wd = rg.lru_width_
    b_a, b_i = (randn(Wd, scale=0.5) for _ in range(2))
    lam = randn(Wd) + 1.0
    B, S = RECUR_ARCHS["recurrentgemma-2b"]["prefill"]
    for key, S_ in [("rglru", S)] + [(f"rglru_{n}", n) for n in long_lru]:
        args = (randn(B, S_, Wd, dtype=bf), randn(B, S_, Wd),
                randn(B, S_, Wd), b_a, b_i, lam)
        times[key] = row(lambda i: rglru_scan_kernel(*args),
                         lambda i: rglru_scan_ref(*args), LRU,
                         meta(args[0]))
        del args
        free_cuda()

    B = RECUR_BATCH
    sets = [(randn(B, 1, Wd, dtype=bf), randn(B, 1, Wd), randn(B, 1, Wd),
             b_a, b_i, lam, randn(B, Wd)) for _ in range(DECODE_SETS)]
    times["rglru_step"] = row(
        lambda i: rglru_scan_kernel(*sets[i][:6], h0=sets[i][6]),
        lambda i: rglru_scan_ref(*sets[i][:6], h0=sets[i][6]), LRU,
        meta(sets[0][0], sets[0][6]), sets=DECODE_SETS)
    del sets
    free_cuda()
    return times


def recurrent_kernel_timing(cuda, seed, smi):
    """Each new kernel piece at its main-path shape beside its plain
    version, the library call where one computes the same function and the
    bound: the flash kernel at RecurrentGemma-2B's local attention (B = 1,
    H = 10, Hkv = 1, S = T = 4096, D = 256) with its window of 2048 and
    without one (SDPA with the window as a boolean mask, and causal);
    the scans by `scan_times`: ssd_scan at Mamba2-2.7B's 1 x 2048 and its
    decode step, rglru_scan at RecurrentGemma's 1 x 4096 (and, printed
    only, at the longer prompts of RGLRU_LONG, whose carry crosses more
    chunks) and its decode step (neither has a PyTorch library call).
    Returns each row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    rows = {}
    rg = get_config("recurrentgemma-2b")
    B, S = RECUR_ARCHS["recurrentgemma-2b"]["prefill"]
    H, Hkv, D, W = rg.n_heads, rg.n_kv_heads, rg.head_dim_, rg.local_window
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((B, h, S, D), generator=g, device=cuda)
               .to(torch.bfloat16) for h in (H, Hkv, Hkv))
    i = torch.arange(S, device=cuda)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
    for window in (W, None):
        def kernel():
            return flash_attention(q, k, v, causal=True, window=window)

        def plain():
            return flash_attention_ref(q, k, v, causal=True, window=window)

        def sdpa():
            if window is None:
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True)
        r = plain()
        err = float((kernel().float() - r.float()).abs().max())
        sdpa_err = float((sdpa().float() - r.float()).abs().max())
        rel = row_rel_err(kernel(), r)
        check(rel <= ROW_REL_LIMIT["bfloat16"],
              f"flash D={D} window={window}: max |kernel - plain| {err:.3g}, "
              f"max row-relative {rel:.3g} <= "
              f"{ROW_REL_LIMIT['bfloat16']:g}")
        del r
        t = {"kernel": cuda_ms(kernel, 20), "plain": cuda_ms(plain, 3),
             "sdpa": cuda_ms(sdpa, 10)}
        b_ms, b_by = bounds.attention_bound(q, k, v, True, window)
        pairs = bounds.attention_pairs(S, S, True, window)
        print(f"  flash wgmma lane B={B} H={H} Hkv={Hkv} S=T={S} D={D} "
              f"window={window} bf16 ({pairs:,} pairs a head, "
              f"{bounds.attention_flops(q, k, True, window) / 1e9:.2f} "
              f"GFLOP): "
              f"kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"sdpa {t['sdpa']:.4f} ms (|diff| {sdpa_err:.3g}), bound "
              f"{b_ms:.4f} ms ({b_by}); kernel at "
              f"{100 * b_ms / t['kernel']:.1f}% of bound, "
              f"{t['sdpa'] / t['kernel']:.2f}x SDPA's speed [{smi}]")
        rows["flash_window" if window else "flash_d256"] = dict(
            t, bound_ms=b_ms, bound_by=b_by, err=err)
    del q, k, v, band
    free_cuda()

    mb = get_config("mamba2-2.7b")
    H, P, N, Q = mb.ssm_heads, mb.ssm_headdim, mb.ssm_state, mb.ssm_chunk
    Wd = rg.lru_width_
    times = scan_times(cuda, seed, long_lru=RGLRU_LONG)

    t = times["ssd"]
    B, S = RECUR_ARCHS["mamba2-2.7b"]["prefill"]
    b_ms, b_by, split_ms, f32_ms = bounds.ssd_bound(*t["inputs"], Q)
    nc = -(-S // Q)
    nt = -(-min(Q, S) // 64)
    work = bounds.ssd_scan_work(B, S, H, P, N, Q)
    tf32 = bounds.ssd_tf32_ops(B, S, H, P, N, Q)
    print(f"  ssd_scan B={B} S={S} H={H} P={P} N={N} Q={Q} bf16 "
          f"x ({work / 1e9:.3f} GFLOP, causal halves once; "
          f"{tf32 / 1e9:.3f} GFLOP of split TF32 products): kernel "
          f"{t['kernel']:.4f} ms ({work / t['kernel'] / 1e9:.2f} TFLOP/s of "
          f"the function, {tf32 / t['kernel'] / 1e9:.2f} of split TF32), "
          f"plain {t['plain']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, the "
          f"function at TF32's 495 TFLOP/s; its split products "
          f"{split_ms:.4f} ms, as float32 FMAs {f32_ms:.4f} ms); kernel at "
          f"{100 * b_ms / t['kernel']:.1f}% of bound "
          f"({100 * split_ms / t['kernel']:.1f}% of the split bound); "
          f"{t['launches']} launches of {(H + nt * (nt + 1) // 2) * nc * B}, "
          f"{-(-B * H * P * N // 4 // 256)} and {H * nc * B} blocks; max "
          f"|kernel - plain| {t['err']:.3g} [{smi}]")
    rows["ssd"] = dict(t, sdpa=None, bound_ms=b_ms, bound_by=b_by,
                       bounds={"split_bound_ms": split_ms,
                               "f32_fma_bound_ms": f32_ms})

    t = times["ssd_step"]
    B = RECUR_BATCH
    b_ms, b_by = bounds.ssd_step_bound(*t["inputs"])
    print(f"  ssd_scan decode step B={B} S=1 H={H} P={P} N={N} float32 from "
          f"a state ({2 * B * H * P * N * 4 / 1e6:.2f} MB of state in and "
          f"out; {DECODE_SETS} input sets in turn): kernel "
          f"{1e3 * t['kernel']:.2f} us ({t['launches']} launch), plain "
          f"{1e3 * t['plain']:.2f} us, bound {1e3 * b_ms:.2f} us ({b_by}); "
          f"kernel at {100 * b_ms / t['kernel']:.1f}% of bound; max "
          f"|kernel - plain| {t['err']:.3g} [{smi}]")
    rows["ssd_step"] = dict(t, sdpa=None, bound_ms=b_ms, bound_by=b_by)

    B, S = RECUR_ARCHS["recurrentgemma-2b"]["prefill"]
    for key in ["rglru"] + [f"rglru_{S_}" for S_ in RGLRU_LONG]:
        t = times[key]
        S_ = t["inputs"][0].shape[1]
        b_ms, b_by = bounds.rglru_bound(*t["inputs"])
        print(f"  rglru_scan B={B} S={S_} W={Wd} bf16 u: kernel "
              f"{t['kernel']:.4f} ms ({t['launches']} launch, "
              f"{-(-S_ // 64) * -(-Wd // 32)} blocks), plain "
              f"{t['plain']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); kernel "
              f"at {100 * b_ms / t['kernel']:.1f}% of bound; max |kernel - "
              f"plain| {t['err']:.3g} [{smi}]")
        check(t["err"] <= 1e-5 * t["scale"],
              f"rglru_scan B={B} S={S_} W={Wd}: max |h - plain| "
              f"{t['err']:.3g} <= 1e-5 x max |h|")
        if key == "rglru":
            rows["rglru"] = dict(t, sdpa=None, bound_ms=b_ms, bound_by=b_by)

    t = times["rglru_step"]
    B = RECUR_BATCH
    b_ms, b_by = bounds.rglru_bound(*t["inputs"])
    print(f"  rglru_scan decode step B={B} S=1 W={Wd} bf16 u from a state: "
          f"kernel {1e3 * t['kernel']:.2f} us ({t['launches']} launch), "
          f"plain {1e3 * t['plain']:.2f} us, bound {1e3 * b_ms:.2f} us "
          f"({b_by}); kernel at {100 * b_ms / t['kernel']:.1f}% of bound; "
          f"max |kernel - plain| {t['err']:.3g} [{smi}]")
    rows["rglru_step"] = dict(t, sdpa=None, bound_ms=b_ms, bound_by=b_by)
    free_cuda()
    return rows


def recurrent_model_timing(cuda, model, seed, smi):
    """The decode step at B = 4 (ms a step, timed before any profiler
    runs), and the forward at B = 4, S = 128 and at the model's long
    prefill (prefill tokens/s), each then profiled once for the card's
    busy share. Returns the times for the roofline."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step
    from repro_torch.serving import ServeEngine

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    times = {}
    eng = ServeEngine(cfg, model, max_len=24, device=cuda)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (RECUR_BATCH,
                                                              24)),
                             device=cuda)
    _, cache = eng.prefill(tokens[:, :4])
    torch.cuda.synchronize()
    steps = 16
    t0 = time.perf_counter()
    for i in range(steps):
        decode_step(model, tokens[:, 4 + i], cache)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"  {cfg.name} decode_step B={RECUR_BATCH} at length 5.."
          f"{4 + steps}: {ms:.2f} ms per step, "
          f"{RECUR_BATCH / ms * 1e3:.1f} tokens/s [{smi}]")
    for B, S in ((RECUR_BATCH, RECUR_PROMPT),
                 RECUR_ARCHS[cfg.name]["prefill"]):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device=cuda)
        model(prompt)
        torch.cuda.synchronize()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            model(prompt)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"  {cfg.name} forward B={B} S={S}: {fwd_ms:.2f} ms, prefill "
              f"{B * S / fwd_ms * 1e3:.0f} tokens/s [{smi}]")
        stats = device_breakdown(lambda: model(prompt),
                                 f"{cfg.name} forward B={B} S={S}", smi)
        times[("forward", B, S)] = (fwd_ms, stats)
    stats = device_breakdown(
        lambda: decode_step(model, tokens[:, 4 + steps], cache),
        f"{cfg.name} decode_step B={RECUR_BATCH}", smi)
    times["decode"] = (ms, stats)
    del eng, cache
    if cfg.name == DRY_DECODE_ARCH:
        # the decode step read for the dry run: a cache of 24 positions
        # (no attention layer: its size is the states') as init_cache
        # makes it, int32 tokens as launch.specs makes them. A step leaves
        # each conv tail a view of a (B, 4, C) window, so the step is read
        # on a fresh cache, after a warm step on another.
        from repro_torch.models import init_cache
        cache = init_cache(cfg, RECUR_BATCH, 24, device=cuda)
        batch = {"token": torch.as_tensor(tokens[:, 4], dtype=torch.int32)}
        params = model.param_tree()
        decode_step(model, batch["token"], cache)
        cache = init_cache(cfg, RECUR_BATCH, 24, device=cuda)
        out, reading = memory_reading(
            lambda: decode_step(model, batch["token"], cache)[0],
            (params, batch, cache))
        del out
        dry_step(f"a {cfg.name} decode step at B={RECUR_BATCH}", cfg,
                 "decode", RECUR_BATCH, 24, reading)
        del cache, batch, params
    return times


def recurrent_roofline(cfg, times, smi):
    """The roofline (`repro_torch.analysis`, H100 constants) of the long
    prefill beside its measured time. FLOPs: `model_flops_cell` (2 x the
    parameters past the embedding x tokens), plus the time mixing's own
    work: the SSD scan's own operations (`bounds.ssd_scan_work`, at the TF32
    peak of the kernel's products, so counted at 989 / 495 of them in the
    bf16 compute term) or the local attention's 4 D flops a pair and head. Bytes: every weight read once,
    the embedding rows gathered and the logits written."""
    from repro_torch.analysis import from_counts, model_flops_cell
    from repro_torch.analysis.flops import total_params
    from repro_torch.analysis.roofline import H100
    B, S = RECUR_ARCHS[cfg.name]["prefill"]
    kinds = cfg.layer_kinds()
    item = cfg.pdtype().itemsize
    model = model_flops_cell(cfg, dict(kind="prefill", batch=B, seq=S))
    if cfg.name == "mamba2-2.7b":
        mix = kinds.count("ssd") * bounds.ssd_scan_work(
            B, S, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
            cfg.ssm_chunk) * (H100.peak_flops["bfloat16"]
                              / H100.peak_flops["tfloat32"])
    else:
        mix = (kinds.count("local_attn") * 4.0 * B * cfg.n_heads
               * cfg.head_dim_ * bounds.attention_pairs(S, S, True,
                                                 cfg.local_window))
    nbytes = (total_params(cfg) * item
              + B * S * (cfg.d_model + cfg.padded_vocab) * item)
    r = from_counts(model + mix, nbytes)
    ms = times[("forward", B, S)][0]
    print(f"  roofline of the {cfg.name} prefill B={B} S={S}: model FLOPs "
          f"(model_flops_cell) {model / 1e12:.4f} T, with the time mixing "
          f"{(model + mix) / 1e12:.4f} T (bf16-equivalent); "
          f"{nbytes / 1e9:.3f} GB -> compute {r.compute_s * 1e3:.3f} ms, "
          f"memory {r.memory_s * 1e3:.3f} ms: {r.dominant}-bound, bound "
          f"{r.bound_s * 1e3:.3f} ms; measured {ms:.2f} ms, "
          f"{100 * r.bound_s * 1e3 / ms:.1f}% of the bound [{smi}]")
    check(r.dominant in ("compute", "memory") and r.collective_s == 0.0,
          f"{cfg.name} prefill: {r.dominant}-bound by the H100 constants, "
          f"no collective term on one card")


def mla_prefix_against_plain(cuda):
    """The flash kernels at DeepSeek-V3's head dims (Dk = 192 over
    Dv = 128; its smoke config's 24 over 16) and with PaliGemma's prefix
    (D in {64, 128, 256}), in bf16 and float32, against their plain
    version: lengths that are no tile multiple, S != T, prefix lengths of
    0, 1, a tile edge and past S, the prefix beside a window and without
    causal (where it changes nothing), and the main paths' shapes; at
    (192, 128) the ping-pong schedule's loops of 1-4 kv tiles, windows
    whose first tile masks whole rows, B = 2 at G = 1 and 10, and on the
    tensor-core lane the log-sum-exp against the plain one with o the
    same bits. Held as `flash_against_plain` holds its cases. Returns the
    largest
    |kernel - plain| per key: "mla" (the tensor-core lane at (192, 128)),
    "prefix" (the tensor-core lane with a prefix), "f32" (the CUDA-core
    lane)."""
    import torch
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref,
                                                     kernel_info,
                                                     kernel_lane)
    from repro_torch.kernels.flash_attention.bwd_cases import LSE_LIMIT
    f32, bf16 = torch.float32, torch.bfloat16
    # the CUDA-core lane at a value head dim of its own, as compiled
    for Dk, Dv, dt in ((192, 128, f32), (24, 16, f32), (24, 16, bf16),
                       (160, 128, bf16)):
        info = kernel_info(Dk, dt, Dv)
        warps = info["blocks_per_sm"] * info["threads"] // 32
        check(info["local_bytes"] == 0 and warps >= 8,
              f"flash f32 lane (Dk, Dv) = ({Dk}, {Dv}) {str(dt)[6:]}: "
              f"{info['blocks_per_sm']} block(s) x {info['threads']} "
              f"threads = {warps} warps per SM, {info['registers']} "
              f"registers, {info['local_bytes']} spill bytes, "
              f"{info['smem_bytes']:,} B of shared memory a block")
    B4, S4 = YI_BATCH, YI_PROMPT
    cases = [  # (B, H, Hkv, S, T, Dk, Dv, causal, dtype, window, prefix)
        (1, 128, 128, 2048, 2048, 192, 128, True, bf16, None, 0),  # main
        (B4, 128, 128, S4, S4, 192, 128, True, bf16, None, 0),
        (B4, 128, 128, S4, S4, 192, 128, True, f32, None, 0),
        (1, 8, 8, 1000, 1000, 192, 128, True, bf16, None, 0),
        (1, 8, 8, 1000, 1000, 192, 128, True, f32, None, 0),
        (1, 4, 4, 129, 129, 192, 128, False, bf16, None, 0),
        (1, 4, 2, 1, 1, 192, 128, True, bf16, None, 0),
        (1, 4, 2, 128, 300, 192, 128, True, bf16, None, 0),
        (1, 4, 2, 300, 130, 192, 128, True, bf16, None, 0),
        (1, 4, 2, 300, 130, 192, 128, True, f32, None, 0),
        (2, 4, 4, 129, 129, 24, 16, True, f32, None, 0),    # smoke widths
        (1, 4, 2, 150, 150, 24, 16, True, bf16, None, 0),
        (1, 8, 1, 2048, 2048, 256, 256, True, bf16, None, 256),  # main
        (B4, 8, 1, 256 + S4, 256 + S4, 256, 256, True, bf16, None, 256),
        (B4, 8, 1, 256 + S4, 256 + S4, 256, 256, True, f32, None, 256),
        (1, 4, 2, 200, 520, 64, 64, True, bf16, None, 300),     # S < T
        (1, 4, 2, 520, 200, 128, 128, True, f32, None, 150),    # S > T
        (1, 4, 2, 300, 300, 128, 128, True, bf16, 100, 150),    # + window
        (1, 4, 2, 300, 300, 128, 128, True, f32, 100, 150),
        (1, 4, 2, 300, 300, 128, 128, False, bf16, None, 150),  # no effect
        (1, 4, 2, 300, 300, 192, 128, True, bf16, None, 150),   # MLA too
        (2, 4, 1, 40, 40, 16, 16, True, f32, None, 8),          # smoke
        # the ping-pong schedule at (192, 128), the two consumers taking
        # turns: loops of 1-4 kv tiles of 128 rows and a ragged 3
        (1, 4, 2, 128, 128, 192, 128, False, bf16, None, 0),
        (1, 4, 2, 128, 256, 192, 128, False, bf16, None, 0),
        (1, 4, 2, 128, 384, 192, 128, False, bf16, None, 0),
        (1, 4, 2, 128, 512, 192, 128, False, bf16, None, 0),
        (1, 4, 2, 128, 320, 192, 128, False, bf16, None, 0),
        (1, 4, 2, 512, 512, 192, 128, True, bf16, None, 0),
        (1, 4, 2, 300, 300, 192, 128, True, bf16, 1, 0),        # window
        (1, 4, 2, 300, 300, 192, 128, True, bf16, 63, 0),
        (1, 4, 2, 300, 300, 192, 128, True, bf16, 65, 0),
        (1, 4, 2, 100, 333, 192, 128, False, bf16, None, 0),    # ragged T
        (1, 4, 2, 300, 700, 192, 128, True, bf16, None, 0),     # S < T
        (2, 4, 4, 200, 200, 192, 128, True, bf16, None, 0),     # B = 2
        (2, 10, 1, 300, 300, 192, 128, True, bf16, None, 0),
        (1, 4, 1, 64, 192, 256, 256, True, bf16, None, 100),    # D = 256
    ]
    # prefix 0, 1, a tile edge (the tensor-core lane's kv tiles are 64
    # rows at D = 256, else 128; the CUDA-core lane's 128), one past it,
    # past S, at S = T = 300
    for D in (64, 128, 256):
        edge = 64 if D == 256 else 128
        for dt in (bf16, f32):
            for prefix in (0, 1, edge, edge + 1, 1000):
                cases.append((1, 4, 2, 300, 300, D, D, True, dt, None,
                              prefix))
    worst = {"mla": 0.0, "prefix": 0.0, "f32": 0.0}
    worst_rel = dict(worst)
    for B, H, Hkv, S, T, Dk, Dv, causal, dt, window, prefix in cases:
        g = torch.Generator(device=cuda).manual_seed(
            S * 1000 + T + Dk + Dv + prefix)
        q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dt)
                   for shape in ((B, H, S, Dk), (B, Hkv, T, Dk),
                                 (B, Hkv, T, Dv)))
        lane = kernel_lane(dt, Dk, Dv)
        before = dict(LAUNCHES)
        o = flash_attention(q, k, v, causal=causal, window=window,
                            prefix_len=prefix)
        r = flash_attention_ref(q, k, v, causal=causal, window=window,
                                prefix_len=prefix)
        torch.cuda.synchronize()
        on_lane = (LAUNCHES["wgmma"] - before["wgmma"] == (lane == "wgmma")
                   and LAUNCHES["fwd"] - before["fwd"] == 1)
        tol = 1e-4 if dt == f32 else 3e-2
        diff = (o.float() - r.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol + tol * r.float().abs()).all())
        rel, lim = row_rel_err(o, r), ROW_REL_LIMIT[str(dt)[6:]]
        check(ok and rel <= lim and on_lane and o.dtype == dt
              and tuple(o.shape) == (B, H, S, Dv),
              f"flash {lane} ({B},{H},{Hkv},S={S},T={T},Dk={Dk},Dv={Dv}) "
              f"causal={causal} window={window} prefix={prefix} "
              f"{str(dt)[6:]}: max |kernel - plain| = {err:.3g} (rtol = "
              f"atol = {tol:g}), max row |kernel - plain| / |plain| = "
              f"{rel:.3g} (<= {lim:g})")
        if lane == "wgmma" and B * H * S * T <= 1 << 26:
            lse_err, same = lse_keeps_o(q, k, v, o, causal=causal,
                                        window=window, prefix_len=prefix)
            check(lse_err <= LSE_LIMIT and same,
                  f"  with its lse: within {lse_err:.3g} of the plain one "
                  f"(<= {LSE_LIMIT:g}), o the same bits: {same}")
        key = ("f32" if lane == "f32" else
               "mla" if (Dk, Dv) == (192, 128) else "prefix")
        worst[key] = max(worst[key], err)
        worst_rel[key] = max(worst_rel[key], rel)
    print(f"  {len(cases)} cases; largest row-relative error per key: "
          f"{worst_rel}")
    return worst


def decode_logits(model, tokens, max_len):
    """The logits of every position of tokens (B, S) through the decode
    path, `decode_step` from an empty cache of max_len slots, stacked
    (B, S, padded_vocab)."""
    import torch
    from repro_torch.models import decode_step, init_cache
    cache = init_cache(model.cfg, tokens.shape[0], max_len, model.device)
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(model, tokens[:, t], cache)
        out.append(logits)
    return torch.stack(out, dim=1)


def mla_main_path(cuda, seed, smi):
    """DeepSeek-V3 inference at full width (ROADMAP Queue 1 item 10.4),
    cut from 61 to MLA_LAYERS = 4 layers (its 3 dense layers and the first
    MoE layer: 15.1e9 random bf16 weights from `seed`, 30.2 GB) through
    the port's entry points: the forward of 4 prompts of 128 tokens
    through the tensor-core flash kernel at (Dk, Dv) = (192, 128), H = Hkv
    = 128, and its routing (drops at capacity factor 1.25: groups of 512
    tokens, C = 20); the plain attention under the kernel run's routing
    against it (Qwen2-MoE's tolerances); greedy generation of 32 tokens
    (absorbed-matrix decode over the latent cache); the decode path
    against the forward at every position of 8-token prompts (drop-free),
    each step routed as the forward routed its token; one 2048-token
    prefill. Then the same draws in float32 cut to one dense MLA layer
    (2.4e9 parameters, 9.75 GB): its forward through the CUDA-core lane at
    (192, 128) against impl="ref" within 1e-4 of the largest plain logit
    over all positions, and its decode path against its forward at every
    position within 1e-4. Returns the flash launches of the run, the bf16
    model and the drop share."""
    import numpy as np
    import torch
    from repro_torch.analysis.flops import total_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES, kernel_lane
    from repro_torch.models import Transformer
    from repro_torch.models.moe import capacity
    from repro_torch.serving import ServeEngine

    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    L = cfg.n_layers
    n_moe = sum(cfg.moe_layer(i) for i in range(L))
    dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    check(kernel_lane(cfg.dtype(), dk, dv) == "wgmma"
          and kernel_lane(torch.float32, dk, dv) == "f32",
          f"{MLA_ARCH}'s attention (Dk, Dv) = ({dk}, {dv}) is on the "
          f"tensor-core flash lane in bf16, the CUDA-core lane in float32")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=cuda, seed=seed)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    check(n == total_params(cfg) == MLA_PARAMS,
          f"{MLA_ARCH} at full width, {L} of 61 layers "
          f"({cfg.first_dense_layers} dense, {n_moe} MoE: {cfg.n_experts} "
          f"experts top-{cfg.top_k}, {cfg.n_shared_experts} shared), on the "
          f"card: {n:,} parameters, {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB allocated ({time.perf_counter() - t0:.2f} s to draw) [{smi}]")
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (YI_BATCH, YI_PROMPT)), device=cuda)
    long = torch.as_tensor(rng.integers(0, cfg.vocab_size, YI_PREFILL),
                           device=cuda)

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t0 = time.perf_counter()
    (logits, aux), calls = moe_routing(lambda: model(prompts, impl="cuda"))
    torch.cuda.synchronize()
    print(f"  forward B={YI_BATCH} S={YI_PROMPT}: "
          f"{time.perf_counter() - t0:.3f} s (first call, routing observed)")
    check(tuple(logits.shape) == (YI_BATCH, YI_PROMPT, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} {logits.dtype}, finite")
    share = report_routing(calls, f"routing of the forward, capacity "
                           f"factor {cfg.capacity_factor} (groups of "
                           f"{cfg.moe_group_size} tokens, C = "
                           f"{capacity(cfg)})", cfg.n_experts)
    check(len(calls) == n_moe and 0.0 <= share < 0.5
          and abs(float(aux) - sum(c["aux"] for c in calls))
          <= 1e-4 * float(aux) and float(aux) > 0.0,
          f"the MoE layer routed; {100 * share:.3f}% of assignments "
          f"dropped (< 50%); the forward's aux {float(aux):.4f} is the "
          f"layers' sum")
    (ref, _), _ = moe_routing(lambda: model(prompts, impl="ref"),
                              pin=lambda i, B, S: calls[i]["idx"])
    torch.cuda.synchronize()
    rel = rel_err(logits, ref)
    n_bad, n_pos, margins = top1_report(logits, ref)
    print(f"  forward cuda vs ref (bf16), the ref routed as the kernel run: "
          f"max|dlogits|/max|logits| = {rel:.3g}; top-1 differs at {n_bad} "
          f"of {n_pos} (ref top-2 margins there: {margins[:6]})")
    check(rel <= 3e-2 and n_bad <= 0.1 * n_pos,
          f"forward impl=cuda against impl=ref in bf16 under one routing: "
          f"relative error {rel:.3g} <= 3e-2, top-1 agrees at "
          f"{n_pos - n_bad} of {n_pos} positions (>= 90%)")
    del ref

    eng = ServeEngine(cfg, model, max_len=YI_PROMPT + YI_GEN + 1,
                      device=cuda)
    t0 = time.perf_counter()
    greedy = eng.generate(prompts, YI_GEN, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = YI_PROMPT + YI_GEN - 1
    print(f"  ServeEngine.generate {YI_BATCH} x {YI_GEN} tokens greedy after "
          f"a {YI_PROMPT}-token prompt: {wall:.2f} s for {steps} decode "
          f"steps ({wall / steps * 1e3:.1f} ms a step); greedy[0] "
          f"{greedy[0, :12].tolist()} [{smi}]")
    check(tuple(greedy.shape) == (YI_BATCH, YI_GEN)
          and int(greedy.min()) >= 0 and int(greedy.max()) < cfg.vocab_size,
          f"greedy tokens ({YI_BATCH}, {YI_GEN}) in [0, {cfg.vocab_size})")
    # decode against the forward at every position, drop-free (8 positions
    # route 32 tokens in one group, an expert takes 20), each decode step
    # routed as the forward routed its tokens
    short = prompts[:, :8]
    (fwd, _), fwd_calls = moe_routing(lambda: model(short))
    dec, _ = moe_routing(
        lambda: decode_logits(model, short, 8),
        pin=lambda i, B, S: fwd_calls[i % n_moe]["idx"][:, i // n_moe][:,
                                                                      None])
    torch.cuda.synchronize()
    rel = rel_err(dec, fwd)
    n_bad, n_pos, _ = top1_report(dec, fwd)
    check(all(c["kept"] == c["n"] for c in fwd_calls) and rel <= 3e-2
          and n_bad <= 0.1 * n_pos,
          f"8-token prompts (no assignment dropped): the decode path "
          f"(latent cache) against the forward at all {n_pos} positions "
          f"under one routing, relative error {rel:.3g} <= 3e-2, top-1 "
          f"agrees at {n_pos - n_bad}")
    t0 = time.perf_counter()
    (out, _), long_calls = moe_routing(lambda: model(long))
    torch.cuda.synchronize()
    print(f"  prefill forward B={YI_PREFILL[0]} S={YI_PREFILL[1]}: "
          f"{time.perf_counter() - t0:.3f} s (first call, routing observed)")
    check(bool(torch.isfinite(out).all()),
          f"{YI_PREFILL[1]}-token prefill finite")
    report_routing(long_calls, f"routing of the {YI_PREFILL[1]}-token "
                   f"prefill", cfg.n_experts)
    del logits, out, fwd, dec, eng, greedy, calls, fwd_calls, long_calls
    free_cuda()

    # the float32 copy, one dense MLA layer: the CUDA-core lane
    cfg32 = dataclasses.replace(cfg, n_layers=1, first_dense_layers=1,
                                param_dtype="float32",
                                compute_dtype="float32")
    model32 = Transformer(cfg32, device=cuda, seed=seed)
    n32 = sum(p.numel() for p in model32.parameters())
    out32, _ = model32(prompts)
    ref32, _ = model32(prompts, impl="ref")
    dec32 = decode_logits(model32, prompts[:, :16], 16)
    torch.cuda.synchronize()
    check(n32 == total_params(cfg32) == MLA_F32_PARAMS,
          f"float32 copy cut to one dense MLA layer: {n32:,} parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated with "
          f"the bf16 model")
    for what, a, b in (
            ("forward impl=cuda against impl=ref", out32, ref32),
            ("decode path against the forward at every position",
             dec32, out32[:, :16])):
        rel = rel_err(a, b)
        n_bad, n_pos, _ = top1_report(a, b)
        check(rel <= 1e-4 and n_bad == 0,
              f"f32 {what}: max|d|/max|logits| = {rel:.3g} <= 1e-4, top-1 "
              f"agrees at all {n_pos} positions")
    del model32, out32, ref32, dec32
    free_cuda()
    launches = {"wgmma": LAUNCHES["wgmma"],
                "f32": LAUNCHES["fwd"] - LAUNCHES["wgmma"]}
    # the bf16 forwards with impl "auto"/"cuda": prompts, 8-token prompts,
    # 2048 tokens; the float32 forward
    check(launches == {"wgmma": 3 * L, "f32": cfg32.n_layers},
          f"flash launches over the main path: {launches} (3 bf16 "
          f"forwards x {L} layers on the tensor cores, one float32 forward "
          f"x {cfg32.n_layers} layer on the CUDA cores; decode attends over "
          f"its latent cache without the kernel)")
    return launches, model, share


def flash_row(cuda, seed, smi, shape, what, sdpa_kw, **kw):
    """The flash kernel at one main-path shape (B, H, Hkv, S = T, Dk, Dv;
    causal, with `kw`'s prefix_len), in bf16 (the tensor-core lane) and
    then in float32 (the CUDA-core lane), beside its plain version, one
    SDPA call (`sdpa_kw`: its mask) and the bound. Returns the bf16 row:
    the three times, the bound and the kernel's largest error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref,
                                                     kernel_lane)
    B, H, Hkv, S, dk, dv = shape
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=cuda).manual_seed(seed)
        q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt)
                   for s in ((B, H, S, dk), (B, Hkv, S, dk),
                             (B, Hkv, S, dv)))
        o = flash_attention(q, k, v, causal=True, **kw)
        r = flash_attention_ref(q, k, v, causal=True, **kw)
        err = float((o.float() - r.float()).abs().max())
        del o, r
        t = {"kernel": cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                                       **kw), 20),
             "plain": cuda_ms(lambda: flash_attention_ref(
                 q, k, v, causal=True, **kw), 3),
             "sdpa": cuda_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, **sdpa_kw), 20)}
        b_ms, b_by = bounds.attention_bound(q, k, v, True,
                                     prefix=kw.get("prefix_len", 0))
        print(f"  flash {kernel_lane(dt, dk, dv)} lane {what} B={B} H={H} "
              f"Hkv={Hkv} S=T={S} (Dk, Dv) = ({dk}, {dv}) {str(dt)[6:]}: "
              f"kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"sdpa {t['sdpa']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"kernel at {100 * b_ms / t['kernel']:.1f}% of bound, "
              f"{t['sdpa'] / t['kernel']:.2f}x SDPA's speed; max |kernel - "
              f"plain| {err:.3g} [{smi}]")
        rows[dt] = dict(t, bound_ms=b_ms, bound_by=b_by, err=err)
        del q, k, v
    free_cuda()
    return rows[torch.bfloat16]


def model_times(cuda, model, seed, smi, shapes, prefix=0):
    """The forward at each (B, S) of `shapes`, with `prefix` random prefix
    embeddings ahead of the S tokens, timed over 3 calls after one and
    profiled once for the card's busy share; the decode step at B = 4 over
    16 steps after a 4-token prefill, then profiled once. Returns
    {(B, S): forward ms, "decode": ms a step}."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step
    from repro_torch.serving import ServeEngine
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    times = {}
    for B, S in shapes:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device=cuda)
        pre = (torch.as_tensor(rng.standard_normal((B, prefix, cfg.d_model)),
                               dtype=cfg.dtype(), device=cuda)
               if prefix else None)
        model(tokens, prefix_embeds=pre)
        torch.cuda.synchronize()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            model(tokens, prefix_embeds=pre)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        what = f"forward B={B} S={f'{prefix}+' if prefix else ''}{S}"
        print(f"  {what}: {ms:.2f} ms, prefill "
              f"{B * (prefix + S) / ms * 1e3:.0f} positions/s [{smi}]")
        device_breakdown(lambda: model(tokens, prefix_embeds=pre), what, smi)
        times[(B, S)] = ms
    eng = ServeEngine(cfg, model, max_len=24, device=cuda)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (YI_BATCH, 24)),
                             device=cuda)
    _, cache = eng.prefill(tokens[:, :4])
    torch.cuda.synchronize()
    steps = 16
    t0 = time.perf_counter()
    for i in range(steps):
        decode_step(model, tokens[:, 4 + i], cache)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"  decode_step B={YI_BATCH} at length 5..{4 + steps}: {ms:.2f} ms "
          f"per step, {YI_BATCH / ms * 1e3:.1f} tokens/s [{smi}]")
    device_breakdown(lambda: decode_step(model, tokens[:, 4 + steps], cache),
                     f"decode_step B={YI_BATCH}", smi)
    times["decode"] = ms
    return times


def print_roofline(what, flops, nbytes, ms, smi):
    """The roofline (`repro_torch.analysis`, H100 constants) of one step
    from its counts, beside its measured time."""
    from repro_torch.analysis import from_counts
    rf = from_counts(flops, nbytes)
    print(f"  roofline of the {what}: {flops / 1e12:.4f} TFLOP, "
          f"{nbytes / 1e9:.3f} GB -> compute {rf.compute_s * 1e3:.3f} ms, "
          f"memory {rf.memory_s * 1e3:.3f} ms: {rf.dominant}-bound, bound "
          f"{rf.bound_s * 1e3:.3f} ms; measured {ms:.2f} ms, "
          f"{100 * rf.bound_s * 1e3 / ms:.1f}% of the bound [{smi}]")
    check(rf.dominant in ("compute", "memory") and rf.collective_s == 0.0,
          f"{what}: {rf.dominant}-bound by the H100 constants, no "
          f"collective term on one card")


def mla_timing(cuda, model, seed, smi):
    """Times of the DeepSeek-V3 cut on the card: the flash kernel at the
    MLA prefill shape (B = 1, H = Hkv = 128, S = T = 2048, (192, 128))
    beside its plain version, SDPA (is_causal, Dv != Dk) and the bound,
    and the CUDA-core lane there in float32; the forward at B = 4,
    S = 128 and B = 1, S = 2048 (prefill tokens/s, the card's busy share
    in one forward); the decode step at B = 4; the roofline of the prefill
    and the decode step. Returns the kernel's row."""
    from repro_torch.analysis import model_flops_cell
    from repro_torch.analysis.flops import total_params
    cfg = model.cfg
    H = cfg.n_heads
    dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    B, S = YI_PREFILL
    row = flash_row(cuda, seed, smi, (B, H, cfg.n_kv_heads, S, dk, dv),
                    "MLA prefill", dict(is_causal=True))
    times = model_times(cuda, model, seed, smi,
                        ((YI_BATCH, YI_PROMPT), YI_PREFILL))
    # model FLOPs (2 x active parameters a token) and the attention's;
    # every weight read once (the decode step's einsums read every
    # expert's), the embedding rows and the logits; for decode the latent
    # cache
    item = cfg.pdtype().itemsize
    weights = total_params(cfg) * item
    r, dr, L = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.n_layers
    t_len = 20
    print_roofline(
        f"prefill B={B} S={S}",
        model_flops_cell(cfg, dict(kind="prefill", batch=B, seq=S))
        + 2.0 * (dk + dv) * H * bounds.attention_pairs(S, S, True) * B * L,
        weights + B * S * (cfg.d_model + cfg.padded_vocab) * item,
        times[YI_PREFILL], smi)
    print_roofline(
        f"decode step B={YI_BATCH} at length {t_len}",
        model_flops_cell(cfg, dict(kind="decode", batch=YI_BATCH))
        + 2.0 * (2 * r + dr) * H * YI_BATCH * t_len * L,
        weights + YI_BATCH * (cfg.d_model + cfg.padded_vocab) * item
        + YI_BATCH * t_len * (r + dr) * item * L, times["decode"], smi)
    return row


def vlm_timing(cuda, model, seed, smi):
    """Times of PaliGemma-3B on the card: the flash kernel at its prefill
    shape with the prefix (B = 1, H = 8, Hkv = 1, D = 256, 256 + 1792
    positions) beside its plain version, SDPA given the prefix-LM mask as
    a boolean mask, and the bound, and the CUDA-core lane there in
    float32; the forward at 4 x (256 + 128) and 1 x (256 + 1792)
    (positions/s, the card's busy share); the decode step at B = 4; the
    roofline of the long prefill. Returns the kernel's row."""
    import torch
    from repro_torch.analysis import model_flops_cell
    from repro_torch.analysis.flops import total_params
    cfg = model.cfg
    H, D, P = cfg.n_heads, cfg.head_dim_, cfg.prefix_len
    S = P + VLM_LONG_TEXT
    pos = torch.arange(S, device=cuda)
    mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < P)
    row = flash_row(cuda, seed, smi, (1, H, cfg.n_kv_heads, S, D, D),
                    f"prefix {P}", dict(attn_mask=mask, enable_gqa=True),
                    prefix_len=P)
    del mask
    times = model_times(cuda, model, seed, smi,
                        ((YI_BATCH, YI_PROMPT), (1, VLM_LONG_TEXT)),
                        prefix=P)
    item = cfg.pdtype().itemsize
    print_roofline(
        f"prefill B=1 S={S}",
        model_flops_cell(cfg, dict(kind="prefill", batch=1, seq=S))
        + 4.0 * H * D * bounds.attention_pairs(S, S, True, prefix=P)
        * cfg.n_layers,
        total_params(cfg) * item + S * (cfg.d_model + cfg.padded_vocab)
        * item, times[(1, VLM_LONG_TEXT)], smi)
    return row


def vlm_main_path(cuda, seed, smi):
    """PaliGemma-3B's backbone at full width and depth (ROADMAP Queue 1
    item 10.5; 2.5e9 random bf16 weights from `seed`, 5.0 GB) through the
    port's entry points, with a prefix of 256 random patch embeddings
    (drawn from `seed`): the forward of 4 x (256 + 128) positions through
    the tensor-core flash kernel at D = 256 with the prefix-LM mask, held
    to the plain attention (bf16 tolerances); one 1 x (256 + 1792)
    prefill; the decode path (no prefix, as in the JAX package) against
    the forward's last position, and greedy generation of 32 tokens at
    B = 4. Then the same draws in float32 (10 GB): the forward with the
    prefix through the CUDA-core lane against impl="ref" within 1e-4 of
    the largest plain logit over all positions, and the decode path
    against the forward at every position of 16-token prompts within
    1e-4. Returns the flash launches of the run and the bf16 model."""
    import numpy as np
    import torch
    from repro_torch.analysis.flops import total_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES, kernel_lane
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeEngine

    cfg = get_config(VLM_ARCH)
    L, P, D = cfg.n_layers, cfg.prefix_len, cfg.head_dim_
    check(kernel_lane(cfg.dtype(), D) == "wgmma"
          and kernel_lane(torch.float32, D) == "f32",
          f"{VLM_ARCH}'s attention (MQA {cfg.n_heads} x {D} over "
          f"{cfg.n_kv_heads} kv head) is on the tensor-core flash lane in "
          f"bf16, the CUDA-core lane in float32")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=cuda, seed=seed)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    check(n == total_params(cfg) == VLM_PARAMS,
          f"{VLM_ARCH} at full width and depth on the card: {n:,} "
          f"parameters ({L} layers), {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB allocated ({time.perf_counter() - t0:.2f} s to draw) [{smi}]")
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (YI_BATCH, YI_PROMPT)), device=cuda)
    prefix = torch.as_tensor(rng.standard_normal((YI_BATCH, P, cfg.d_model)),
                             dtype=torch.float32, device=cuda)
    long = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, VLM_LONG_TEXT)), device=cuda)
    long_prefix = torch.as_tensor(rng.standard_normal((1, P, cfg.d_model)),
                                  dtype=torch.float32, device=cuda)

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t0 = time.perf_counter()
    logits, _ = model(prompts, prefix_embeds=prefix, impl="cuda")
    torch.cuda.synchronize()
    print(f"  forward B={YI_BATCH} S={P}+{YI_PROMPT}: "
          f"{time.perf_counter() - t0:.3f} s (first call)")
    check(LAUNCHES["wgmma"] == LAUNCHES["fwd"] == L,
          f"bf16 forward launched the tensor-core flash kernel "
          f"{LAUNCHES['wgmma']} times at D = {D} with the prefix and the "
          f"CUDA-core one {LAUNCHES['fwd'] - LAUNCHES['wgmma']} times "
          f"(n_layers = {L})")
    check(tuple(logits.shape) == (YI_BATCH, P + YI_PROMPT, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} {logits.dtype}, finite")
    ref, _ = model(prompts, prefix_embeds=prefix, impl="ref")
    torch.cuda.synchronize()
    rel = rel_err(logits, ref)
    n_bad, n_pos, margins = top1_report(logits, ref)
    print(f"  forward cuda vs ref (bf16): max|dlogits|/max|logits| = "
          f"{rel:.3g}; top-1 differs at {n_bad} of {n_pos} positions (ref "
          f"top-2 margins there: {margins[:6]})")
    check(rel <= 3e-2 and n_bad <= 0.1 * n_pos,
          f"forward with the prefix impl=cuda against impl=ref in bf16: "
          f"relative error {rel:.3g} <= 3e-2, top-1 agrees at "
          f"{n_pos - n_bad} of {n_pos} positions (>= 90%)")
    del logits, ref
    t0 = time.perf_counter()
    out, _ = model(long, prefix_embeds=long_prefix)
    torch.cuda.synchronize()
    print(f"  prefill forward B=1 S={P}+{VLM_LONG_TEXT}: "
          f"{time.perf_counter() - t0:.3f} s (first call)")
    check(tuple(out.shape) == (1, P + VLM_LONG_TEXT, cfg.padded_vocab)
          and bool(torch.isfinite(out).all()),
          f"{P + VLM_LONG_TEXT}-position prefill finite")
    del out
    # the decode path takes no prefix, as in the JAX package
    fwd, _ = model(prompts)
    eng = ServeEngine(cfg, model, max_len=YI_PROMPT + YI_GEN + 1,
                      device=cuda)
    last, cache = eng.prefill(prompts)
    torch.cuda.synchronize()
    rel = rel_err(last, fwd[:, -1])
    n_bad, n_pos, _ = top1_report(last, fwd[:, -1])
    check(cache["length"] == YI_PROMPT and rel <= 3e-2
          and n_bad <= 0.1 * n_pos,
          f"bf16 prefill through the decode path against the forward's last "
          f"position: relative error {rel:.3g} <= 3e-2, top-1 agrees at "
          f"{n_pos - n_bad} of {n_pos}")
    t0 = time.perf_counter()
    greedy = eng.generate(prompts, YI_GEN, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = YI_PROMPT + YI_GEN - 1
    print(f"  ServeEngine.generate {YI_BATCH} x {YI_GEN} tokens greedy after "
          f"a {YI_PROMPT}-token prompt: {wall:.2f} s for {steps} decode "
          f"steps ({wall / steps * 1e3:.1f} ms a step); greedy[0] "
          f"{greedy[0, :12].tolist()} [{smi}]")
    check(tuple(greedy.shape) == (YI_BATCH, YI_GEN)
          and int(greedy.min()) >= 0 and int(greedy.max()) < cfg.vocab_size,
          f"greedy tokens ({YI_BATCH}, {YI_GEN}) in [0, {cfg.vocab_size})")
    del fwd, eng, cache, last, greedy
    free_cuda()

    # the same draws in float32: the CUDA-core lane at D = 256
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Transformer(cfg32, device=cuda, seed=seed)
    out32, _ = model32(prompts, prefix_embeds=prefix)
    ref32, _ = model32(prompts, prefix_embeds=prefix, impl="ref")
    rel = rel_err(out32, ref32)
    n_bad, n_pos, _ = top1_report(out32, ref32)
    check(rel <= 1e-4 and n_bad == 0,
          f"f32 forward with the prefix impl=cuda against impl=ref "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated with "
          f"the bf16 model): max|d|/max|logits| = {rel:.3g} <= 1e-4, top-1 "
          f"agrees at all {n_pos} positions")
    del out32, ref32
    short = prompts[:, :16]
    fwd32, _ = model32(short)
    dec32 = decode_logits(model32, short, 16)
    torch.cuda.synchronize()
    rel = rel_err(dec32, fwd32)
    n_bad, n_pos, _ = top1_report(dec32, fwd32)
    check(rel <= 1e-4 and n_bad == 0,
          f"f32 decode path against the forward at every position: "
          f"max|d|/max|logits| = {rel:.3g} <= 1e-4, top-1 agrees at all "
          f"{n_pos} positions")
    del model32, fwd32, dec32
    free_cuda()
    launches = {"wgmma": LAUNCHES["wgmma"],
                "f32": LAUNCHES["fwd"] - LAUNCHES["wgmma"]}
    # bf16 forwards: prompts with the prefix, the long prefill, prompts
    # without; float32: prompts with the prefix, 16-token prompts
    check(launches == {"wgmma": 3 * L, "f32": 2 * L},
          f"flash launches over the main path: {launches} (3 bf16 forwards "
          f"x {L} layers on the tensor cores at D = {D}, 2 float32 "
          f"forwards on the CUDA cores; decode attends over its cache "
          f"without the kernel)")
    return launches, model


# ---------------------------------------------------------------------------
# Whisper-base and the training path (ROADMAP Queue 1 items 10.6-10.8)
# ---------------------------------------------------------------------------
# the backward's lanes: the tensor cores (bf16 at (64, 64), (128, 128),
# (256, 256)) and the CUDA cores (the rest)
FLASH_BWD_SOURCE = {
    "wgmma": ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_bwd_wgmma.cu"),
    "f32": ("src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention_bwd.cu")}
FLASH_BWD_REPLACES = ("none: the Pallas kernel (src/repro/kernels/"
                      "flash_attention/flash_attention.py:97) has no "
                      "backward; the JAX package differentiates "
                      "flash_attn_jnp (src/repro/models/attention.py:79) "
                      "with XLA's autodiff")
# the backward timed at SmolLM-360M's and Yi-6B's training shapes:
# (what, B, H, Hkv, S = T, D), causal, bf16
BWD_TIMED = (("SmolLM-360M", 8, 15, 5, 2048, 64),
             ("Yi-6B", 1, 32, 4, 2048, 128))
# the CUDA-core lane timed at its training shapes: (dtype, what, B, H, Hkv,
# S = T, Dk, Dv, window), causal: SmolLM-360M's float32 train step,
# RecurrentGemma-2B's float32 cut step (one kv head, window 2048) and
# DeepSeek-V3's MLA dims in bf16 (Dk 192 over Dv 128, 128 heads)
F32_BWD_TIMED = (
    ("float32", "SmolLM-360M", 8, 15, 5, 2048, 64, 64, None),
    ("float32", "RecurrentGemma-2B", 1, 10, 1, 4096, 256, 256, 2048),
    ("bfloat16", "DeepSeek-V3 MLA", 1, 128, 128, 2048, 192, 128, None))
WHISPER_ARCH, WHISPER_PARAMS = "whisper-base", 70_664_192
# Whisper's 30 s window is 1,500 frames; the decoder's 448-token context
WHISPER_FRAMES, WHISPER_CTX = 1500, 448
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_GEN = 4, 4, 64
WHISPER_FWD_REPS = 5            # warm forwards timed after the first
TRAIN_ARCH, TRAIN_PARAMS = "smollm-360m", 361_821_120
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_RESUME = 8, 2048, 5, 2
WHISPER_TRAIN_SEQ = 448
# the kernel-against-plain check of a train step: a float32 copy cut to 2
# layers at B = 2, S = 1024
TRAIN_CHECK = dict(n_layers=2, batch=2, seq=1024)


def flash_bwd_against_plain(cuda):
    """The backward's two lanes against their plain version on the card
    over BWD_CASES (dq, dk, dv), each case twice: from the plain forward's
    o with no lse (the lane rebuilds it), and from the forward kernel's o
    and lse (`return_lse`) as training feeds it, the lse held to the plain
    one within LSE_LIMIT and the CUDA-core forward's o equal bit for bit
    to its o without the lse; two runs compared bit for bit each time, one
    count a call on the lane `bwd_lane` names; and the forward's missing
    tensor-core case, bf16 not causal 448 x 1,500 at D = 64 (Whisper's
    cross attention). Returns the largest |kernel - plain| over the cases
    of each backward lane, and of the tensor-core lane's cases at
    (256, 256) ("d256")."""
    import torch
    from repro_torch.kernels.flash_attention import (LAUNCHES, bwd_lane,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref,
                                                     kernel_lane)
    from repro_torch.kernels.flash_attention.bwd_cases import (BWD_CASES,
                                                               BWD_LIMIT,
                                                               DTYPES,
                                                               LSE_LIMIT,
                                                               bwd_errors)

    def run(q, k, v, o, do, kw, lse=None):
        """Two calls and the plain backward: (errors, same bits, the
        largest |kernel - plain|, launches by lane)."""
        before = dict(LAUNCHES)
        got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        again = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        ref = flash_attention_bwd_ref(q, k, v, o, do, **kw)
        torch.cuda.synchronize()
        return (bwd_errors(got, ref, k.shape[2]),
                all(torch.equal(a, c) for a, c in zip(got, again)),
                max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, ref)),
                {key: LAUNCHES[key] - before[key]
                 for key in ("bwd", "bwd_wgmma")})

    worst = {"wgmma": 0.0, "f32": 0.0, "d256": 0.0}
    for B, H, Hkv, S, T, Dk, Dv, causal, dt, window, prefix in BWD_CASES:
        g = torch.Generator(device=cuda).manual_seed(S * 1000 + T + Dk)
        q, k, v = (torch.randn(s, generator=g, device=cuda).to(DTYPES[dt])
                   for s in ((B, H, S, Dk), (B, Hkv, T, Dk),
                             (B, Hkv, T, Dv)))
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        o = flash_attention_ref(q, k, v, **kw)
        do = torch.randn(o.shape, generator=g, device=cuda).to(DTYPES[dt])
        lane = bwd_lane(q.dtype, Dk, Dv)
        want = {"bwd": 2, "bwd_wgmma": 2 if lane == "wgmma" else 0}
        d256 = lane == "wgmma" and Dk == 256
        errs, same, err, counts = run(q, k, v, o, do, kw)
        worst[lane] = max(worst[lane], err)
        if d256:
            worst["d256"] = max(worst["d256"], err)
        zero = "; dq, dk are 0 exactly: absolute" if T == 1 else ""
        check(max(errs) <= BWD_LIMIT[dt] and same and counts == want,
              f"flash bwd {lane} lane ({B},{H},{Hkv},S={S},T={T},Dk={Dk},"
              f"Dv={Dv}) causal={causal} window={window} prefix={prefix} "
              f"{dt}: max |kernel - plain| / max |plain| of dq, dk, dv = "
              f"{', '.join(f'{e:.3g}' for e in errs)} (<= "
              f"{BWD_LIMIT[dt]:g}{zero}); two runs bit for bit equal; "
              f"calls {counts}")
        fwd_lane = kernel_lane(q.dtype, Dk, Dv)
        ok, lse = flash_attention(q, k, v, return_lse=True, **kw)
        _, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
        lse_err = float((lse - lse_ref).abs().max())
        o_same = (fwd_lane != "f32"
                  or torch.equal(ok, flash_attention(q, k, v, **kw)))
        errs, same, err, counts = run(q, k, v, ok, do, kw, lse=lse)
        worst[lane] = max(worst[lane], err)
        if d256:
            worst["d256"] = max(worst["d256"], err)
        check(lse_err <= LSE_LIMIT and o_same and max(errs) <= BWD_LIMIT[dt]
              and same and counts == want,
              f"  the same from the {fwd_lane} forward's o and lse (lse "
              f"within {lse_err:.3g} of the plain one, <= {LSE_LIMIT:g}"
              + ("; o the same bits without the lse" if fwd_lane == "f32"
                 else "") + f"): {', '.join(f'{e:.3g}' for e in errs)}"
              f"{zero}; two runs bit for bit equal")
        del q, k, v, o, do, ok, lse, lse_ref
    g = torch.Generator(device=cuda).manual_seed(448)
    q = torch.randn((2, 8, WHISPER_CTX, 64), generator=g,
                    device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((2, 8, WHISPER_FRAMES, 64), generator=g,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    before = dict(LAUNCHES)
    o = flash_attention(q, k, v, causal=False)
    r = flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    err, rel = float((o.float() - r.float()).abs().max()), row_rel_err(o, r)
    check(kernel_lane(torch.bfloat16, 64) == "wgmma"
          and LAUNCHES["wgmma"] == before["wgmma"] + 1
          and rel <= ROW_REL_LIMIT["bfloat16"],
          f"flash wgmma forward, Whisper's cross attention (2, 8, S = "
          f"{WHISPER_CTX}, T = {WHISPER_FRAMES}, D = 64) not causal bf16: "
          f"max |kernel - plain| = {err:.3g}, max row |kernel - plain| / "
          f"|plain| = {rel:.3g} (<= {ROW_REL_LIMIT['bfloat16']:g})")
    del q, k, v, o, r
    free_cuda()
    return worst


def flash_bwd_timing(cuda, seed, smi):
    """The backward at its training shapes, causal: the tensor-core lane in
    bf16 at BWD_TIMED's shapes, and the CUDA-core lane at F32_BWD_TIMED's
    (float32 at SmolLM-360M's and at RecurrentGemma-2B's with its window,
    bf16 at DeepSeek-V3's MLA dims); each given the forward kernel's lse as
    training gives it, and without it (rebuilt), beside its plain version,
    the backward of one scaled_dot_product_attention call (is_causal,
    enable_gqa; a window as a boolean mask) alone in the same dtype, and
    the bound at that dtype's peak. Returns {(lane, what): row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (bwd_lane,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref)
    from repro_torch.kernels.flash_attention.bwd_cases import (BWD_LIMIT,
                                                               bwd_errors)
    rows = {}
    timed = [("wgmma", torch.bfloat16, what, B, H, Hkv, S, D, D, None)
             for what, B, H, Hkv, S, D in BWD_TIMED]
    timed += [("f32", getattr(torch, dt), *shape)
              for dt, *shape in F32_BWD_TIMED]
    for lane, dtype, what, B, H, Hkv, S, Dk, Dv, window in timed:
        check(bwd_lane(dtype, Dk, Dv) == lane,
              f"{dtype} at ({Dk}, {Dv}): {lane}")
        g = torch.Generator(device=cuda).manual_seed(seed)
        q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((B, H, S, Dk), (B, Hkv, S, Dk),
                             (B, Hkv, S, Dv)))
        kw = dict(window=window)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
        got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        ref = flash_attention_bwd_ref(q, k, v, o, do, **kw)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, ref))
        errs = bwd_errors(got, ref, S)
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        shape = (f"({B},{H},{Hkv},S=T={S},Dk={Dk},Dv={Dv}) causal"
                 + (f" window {window}" if window else "") + f" {dt}")
        check(max(errs) <= BWD_LIMIT[dt],
              f"flash bwd {lane} lane at {what}'s training shape {shape}: "
              f"max |kernel - plain| / max |plain| of dq, dk, dv = "
              f"{', '.join(f'{e:.3g}' for e in errs)} (<= "
              f"{BWD_LIMIT[dt]:g})")
        del got, ref
        free_cuda()
        t = {"kernel": cuda_ms(lambda: flash_attention_bwd(
                 q, k, v, o, do, lse=lse, **kw), 5),
             "no_lse": cuda_ms(lambda: flash_attention_bwd(
                 q, k, v, o, do, **kw), 5),
             "plain": cuda_ms(lambda: flash_attention_bwd_ref(
                 q, k, v, o, do, **kw), 2)}
        if window:
            i = torch.arange(S, device=cuda)
            sdpa_kw = dict(attn_mask=(i[None, :] <= i[:, None])
                           & (i[None, :] > i[:, None] - window))
        else:
            sdpa_kw = dict(is_causal=True)
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        os_ = F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True,
                                             **sdpa_kw)
        t["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            os_, (qs, ks, vs), do, retain_graph=True), 5)
        b_ms, b_by = bounds.flash_bwd_bound(q, k, v, window=window)
        print(f"  flash bwd {lane} lane, {what} {shape}: kernel "
              f"{t['kernel']:.4f} ms given the forward's lse "
              f"({t['no_lse']:.4f} ms without, rebuilt), plain "
              f"{t['plain']:.4f} ms, SDPA backward "
              + ("(the window as a boolean mask) " if window else "")
              + f"{t['sdpa_bwd']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"kernel at {100 * b_ms / t['kernel']:.1f}% of bound, "
              f"{t['sdpa_bwd'] / t['kernel']:.3f}x SDPA's speed; max "
              f"|kernel - plain| {err:.3g} [{smi}]")
        if lane == "f32":
            for given, label in ((lse, "given the lse"),
                                 (None, "without it")):
                launch_ms = flash_bwd_launch_ms(lambda: flash_attention_bwd(
                    q, k, v, o, do, lse=given, **kw))
                print(f"  its launches {label} (profiled, device ms a "
                      f"call): " + "; ".join(
                          f"{name} {ms:.4f} ms"
                          for name, ms in launch_ms.items()) + f" [{smi}]")
        rows[(lane, what)] = dict(t, bound_ms=b_ms, bound_by=b_by, err=err)
        del q, k, v, o, do, lse, qs, ks, vs, os_
        free_cuda()
    return rows


def attention_dispatch_cost(cuda, smi, calls=200):
    """Host cost of the autograd Function `FlashAttention` against the
    direct call that `attention` makes where no input needs a gradient (the
    reason `attention` keeps both): 1 x 8 x 16 x 64 bf16 causal
    (launch-bound), `calls` calls back to back then one synchronize, in the
    order direct, Function, Function, direct. Returns (direct, Function)
    microseconds a call, the lower of each pair."""
    import torch
    from repro_torch.kernels.flash_attention import FlashAttention, attention
    g = torch.Generator(device=cuda).manual_seed(16)
    q, k, v = (torch.randn((1, 8, 16, 64), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    fns = {"direct": lambda: attention(q, k, v),
           "Function": lambda: FlashAttention.apply(q, k, v, True, None,
                                                    None, 0, "cuda")}
    us = {name: [] for name in fns}
    for name in ("direct", "Function", "Function", "direct"):
        fns[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[name]()
        torch.cuda.synchronize()
        us[name].append((time.perf_counter() - t0) * 1e6 / calls)
    direct, function = min(us["direct"]), min(us["Function"])
    print(f"  attention's dispatch, 1 x 8 x 16 x 64 bf16 causal, {calls} "
          f"calls back to back: attention (the kernel directly) {direct:.2f}"
          f" us a call, FlashAttention.apply {function:.2f} us "
          f"({function - direct:+.2f} us; a Whisper-base forward makes 18 "
          f"such calls: {18 * (function - direct) / 1e3:+.4f} ms) [{smi}]")
    return direct, function


def flash_counts():
    """The flash launch counts by lane, and the backward's calls (all, and
    the tensor-core lane's)."""
    from repro_torch.kernels.flash_attention import LAUNCHES
    return {"wgmma": LAUNCHES["wgmma"],
            "f32": LAUNCHES["fwd"] - LAUNCHES["wgmma"],
            "bwd": LAUNCHES["bwd"], "bwd_wgmma": LAUNCHES["bwd_wgmma"]}


def zero_flash_counts():
    from repro_torch.kernels.flash_attention import LAUNCHES
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def whisper_main_path(cuda, seed, smi):
    """Whisper-base uncut (ROADMAP Queue 1 item 10.6; 70.7e6 random bf16
    weights from `seed`) through the port's entry points: ServeEngine
    encodes 4 requests of 1,500 random frame embeddings each (Whisper's 30
    s window) once, then greedy generation of 64 tokens after a 4-token
    prompt through the cross cache; a forward of 1 x 448 tokens over 1,500
    frames (6 encoder launches not causal, 6 causal and 6 cross decoder
    launches, all on the tensor-core lane); the card's busy share of the
    forward and of decode steps. Then a float32 copy: its forward (the
    CUDA-core lane) held to impl="ref" within 1e-4 of the largest plain
    logit, and its decode path to its forward at every position of
    16-token prompts within 1e-4. Returns the flash launches by lane."""
    import numpy as np
    import torch
    from repro_torch.analysis.flops import total_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel_lane
    from repro_torch.models import Transformer, decode_step
    from repro_torch.serving import ServeEngine

    cfg = get_config(WHISPER_ARCH)
    L, E, D = cfg.n_layers, cfg.n_enc_layers, cfg.head_dim_
    model = Transformer(cfg, device=cuda, seed=seed)
    n = sum(p.numel() for p in model.parameters())
    check(n == total_params(cfg) == WHISPER_PARAMS
          and kernel_lane(cfg.dtype(), D) == "wgmma",
          f"{WHISPER_ARCH} at full width and depth on the card: {n:,} "
          f"parameters ({E} encoder + {L} decoder layers, {cfg.n_heads} x "
          f"{D} heads: the tensor-core flash lane in bf16) [{smi}]")
    rng = np.random.default_rng(seed)
    frames = torch.as_tensor(rng.standard_normal(
        (WHISPER_REQUESTS, WHISPER_FRAMES, cfg.d_model)),
        dtype=cfg.dtype(), device=cuda)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (WHISPER_REQUESTS, WHISPER_PROMPT)), device=cuda)
    ctx = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, WHISPER_CTX)),
                          device=cuda)

    zero_flash_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, model, max_len=WHISPER_PROMPT + WHISPER_GEN + 1,
                      device=cuda, enc_inputs=frames)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    model.encode(frames)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    check(flash_counts()["wgmma"] == 2 * E
          and tuple(eng.enc_out.shape) == (WHISPER_REQUESTS, WHISPER_FRAMES,
                                           cfg.d_model),
          f"encoder over {WHISPER_REQUESTS} x {WHISPER_FRAMES} frames: "
          f"{first:.2f} ms in the engine (first call), {enc_ms:.2f} ms "
          f"again; {E} tensor-core launches each (not causal) [{smi}]")
    t0 = time.perf_counter()
    greedy = eng.generate(prompts, WHISPER_GEN, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = WHISPER_PROMPT + WHISPER_GEN - 1
    check(tuple(greedy.shape) == (WHISPER_REQUESTS, WHISPER_GEN)
          and int(greedy.min()) >= 0 and int(greedy.max()) < cfg.vocab_size,
          f"ServeEngine.generate {WHISPER_REQUESTS} x {WHISPER_GEN} tokens "
          f"greedy after a {WHISPER_PROMPT}-token prompt over the cross "
          f"cache: {wall:.3f} s for {steps} decode steps "
          f"({wall / steps * 1e3:.2f} ms a step, "
          f"{WHISPER_REQUESTS * WHISPER_GEN / wall:.1f} generated tokens/s, "
          f"prefill included); greedy[0] {greedy[0, :12].tolist()} [{smi}]")
    cache = eng.new_cache(WHISPER_REQUESTS)
    for t in range(WHISPER_PROMPT):
        decode_step(model, prompts[:, t], cache)
    device_breakdown(lambda: [decode_step(model, greedy[:, i], cache)
                              for i in range(8)],
                     f"8 decode steps B={WHISPER_REQUESTS}", smi)
    before = flash_counts()
    t0 = time.perf_counter()
    logits, _ = model(ctx, enc_inputs=frames[:1])
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    after = flash_counts()
    warm = []
    for _ in range(WHISPER_FWD_REPS):
        t0 = time.perf_counter()
        model(ctx, enc_inputs=frames[:1])
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = sorted(warm)[len(warm) // 2]
    check(after["wgmma"] - before["wgmma"] == E + 2 * L
          and after["f32"] == before["f32"]
          and tuple(logits.shape) == (1, WHISPER_CTX, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"forward 1 x {WHISPER_CTX} tokens over {WHISPER_FRAMES} frames: "
          f"{fwd_ms:.2f} ms warm (median of {WHISPER_FWD_REPS}: "
          f"{', '.join(f'{t:.2f}' for t in warm)}; {first:.2f} ms the first "
          f"call), {E} encoder + {L} causal + {L} cross launches on the "
          f"tensor-core lane, none on the CUDA cores; logits finite [{smi}]")
    device_breakdown(lambda: model(ctx, enc_inputs=frames[:1]),
                     f"forward 1 x {WHISPER_CTX} over {WHISPER_FRAMES} "
                     f"frames", smi)
    del eng, cache, logits, greedy
    free_cuda()

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Transformer(cfg32, device=cuda, seed=seed)
    f32 = frames[:2, :300].float()
    short = prompts[:2].repeat(1, 4)                    # 16 tokens
    out32, _ = model32(short, enc_inputs=f32)
    ref32, _ = model32(short, enc_inputs=f32, impl="ref")
    rel = rel_err(out32, ref32)
    n_bad, n_pos, _ = top1_report(out32, ref32)
    check(rel <= 1e-4 and n_bad == 0,
          f"f32 forward impl=cuda against impl=ref: max|d|/max|logits| = "
          f"{rel:.3g} <= 1e-4, top-1 agrees at all {n_pos} positions")
    eng = ServeEngine(cfg32, model32, max_len=16, device=cuda,
                      enc_inputs=f32)
    cache = eng.new_cache(2)
    dec = torch.stack([decode_step(model32, short[:, t], cache)[0]
                       for t in range(short.shape[1])], dim=1)
    rel = rel_err(dec, out32)
    n_bad, n_pos, _ = top1_report(dec, out32)
    check(rel <= 1e-4 and n_bad == 0,
          f"f32 decode path through the cross cache against the forward at "
          f"every position: max|d|/max|logits| = {rel:.3g} <= 1e-4, top-1 "
          f"agrees at all {n_pos} positions")
    launches = flash_counts()
    # bf16: the engine's encoder, the timed encoder, the forward, its warm
    # runs and its profiled run; float32: one forward, the engine's encoder
    check(launches == {"wgmma": 2 * E + (2 + WHISPER_FWD_REPS) * (E + 2 * L),
                       "f32": (E + 2 * L) + E, "bwd": 0, "bwd_wgmma": 0},
          f"flash launches over the main path: {launches}")
    del model, model32, eng, cache, out32, ref32, dec
    free_cuda()
    return launches, enc_ms


def _train_step_probe(smi, profile_call=2, reading=None, measure_call=3):
    """A wrapper of `launch.train.make_train_step` that times each step on
    the host around a synchronize, and runs call `profile_call` under
    torch.profiler: the step's device time and the share of it taken by
    each group of STEP_KERNELS (the backward kernels). Where `reading` is
    a dict, call `measure_call` fills it with its `memory_reading`.
    Returns (wrapper, record)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    real = train.make_train_step
    rec = {"ms": [], "shares": dict.fromkeys(STEP_KERNELS), "profiled": None}

    def wrapped(model, opt_cfg, *a, **kw):
        step = real(model, opt_cfg, *a, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(rec["ms"]) == profile_call:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = step(state, batch)
                    torch.cuda.synchronize()
                kern = [e for e in prof.events()
                        if e.device_type == DeviceType.CUDA]
                total = sum(e.time_range.elapsed_us() for e in kern)
                us = {what: sum(e.time_range.elapsed_us() for e in kern
                                if any(n in e.name for n in names))
                      for what, names in STEP_KERNELS.items()}
                fwd = sum(e.time_range.elapsed_us() for e in kern
                          if "flash_fwd" in e.name)
                rec["shares"] = {what: (t / total if total else None)
                                 for what, t in us.items()}
                rec["profiled"] = len(rec["ms"])
                by_name = {}
                for e in kern:
                    by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                            + e.time_range.elapsed_us())
                print(f"  step {len(rec['ms'])} profiled: {len(kern)} "
                      f"kernels, {total / 1e3:.2f} ms of device time; "
                      + ", ".join(f"the {what} kernels {t / 1e3:.2f} ms "
                                  f"({100 * t / max(total, 1):.1f}%)"
                                  for what, t in us.items())
                      + f"; the flash forward {fwd / 1e3:.2f} ms "
                        f"({100 * fwd / max(total, 1):.1f}%) [{smi}]")
                for name, t in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:6]:
                    print(f"    {t / 1e3:8.3f} ms  {name}")
            elif reading is not None and len(rec["ms"]) == measure_call:
                # timed by the reading alone: its walks of the arguments
                # and the counts stay out of the step's ms
                out, r = memory_reading(lambda: step(state, batch),
                                        (state, batch))
                reading.update(r)
                rec["ms"].append(r["ms"])
                return out
            else:
                out = step(state, batch)
                torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed
    return wrapped, rec


def percent(share):
    return "(not measured)" if share is None else f"{100 * share:.1f}%"


def run_trainer(argv, smi, reading=None):
    """launch.train.main(argv) with each step timed (`_train_step_probe`;
    `reading` filled with a warm step's `memory_reading` where given).
    Returns (losses, per-step ms, the median ms of the steps after the
    first that were not profiled, the backward kernels' shares of a
    profiled step's device time by STEP_KERNELS' groups, wall s)."""
    from repro_torch.launch import train
    wrapped, rec = _train_step_probe(smi, reading=reading)
    real = train.make_train_step
    train.make_train_step = wrapped
    t0 = time.perf_counter()
    try:
        losses = train.main(argv)
    finally:
        train.make_train_step = real
    ms = rec["ms"]
    plain = sorted(t for i, t in enumerate(ms)
                   if i and i != rec["profiled"])
    steady = plain[len(plain) // 2] if plain else float("nan")
    return (losses, ms, steady, rec["shares"],
            time.perf_counter() - t0)


def train_main_path(cuda, seed, smi):
    """SmolLM-360M uncut in bf16 (361,821,120 parameters; AdamW's float32
    moments 2.9 GB) trained through `python -m repro_torch.launch.train`'s
    main: TRAIN_STEPS steps at --batch 8 --seq 2048 with a checkpoint
    directory, then resumed from its checkpoint for TRAIN_RESUME more
    steps. The loss of each step (it must fall), ms a step, tokens/s, peak
    memory, the backward kernel's calls (one per layer and step) and its
    share of a profiled step's device time. Then one step's loss and
    gradients with impl="cuda" against impl="ref" on a float32 copy cut to
    TRAIN_CHECK (2 layers at B = 2, S = 1024): the loss within 1e-5
    relative, every gradient leaf within 1e-4 of its largest element.
    Returns (flash launches by lane, row for the record)."""
    import tempfile

    import torch
    from repro_torch.analysis.flops import total_params
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens, make_batch
    from repro_torch.models import Transformer
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import lm_loss

    cfg = get_config(TRAIN_ARCH)
    check(total_params(cfg) == TRAIN_PARAMS,
          f"{TRAIN_ARCH}: {TRAIN_PARAMS:,} parameters, {cfg.n_layers} "
          f"layers, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.head_dim_}")
    common = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
              str(TRAIN_SEQ), "--seed", str(seed), "--log-every", "1",
              "--ckpt-every", str(TRAIN_STEPS)]
    zero_flash_counts()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reading = {}
    with tempfile.TemporaryDirectory() as ckpt:
        losses, ms, steady, shares, wall = run_trainer(
            common + ["--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt], smi,
            reading)
        share = shares["flash backward"]
        # the run's peak: the step read for the dry run reset the
        # allocator's, and kept the one before
        peak = (max(torch.cuda.max_memory_allocated(), reading["prior"])
                - base) / 1e9
        free_cuda()
        more, ms2, _, _, wall2 = run_trainer(
            common + ["--steps", str(TRAIN_STEPS + TRAIN_RESUME),
                      "--ckpt-dir", ckpt], smi)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"  losses {[round(x, 4) for x in losses]}, resumed "
          f"{[round(x, 4) for x in more]}; step ms {[round(x, 1) for x in ms]}"
          f" then {[round(x, 1) for x in ms2]}")
    check(len(losses) == TRAIN_STEPS and len(more) == TRAIN_RESUME
          and all(map(math.isfinite, losses + more))
          and losses[-1] < losses[0] and more[-1] < losses[0],
          f"{TRAIN_ARCH} trained {TRAIN_STEPS} steps at B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ} bf16: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"then resumed from its step-{TRAIN_STEPS} checkpoint for "
          f"{TRAIN_RESUME} more ({more[0]:.4f}, {more[-1]:.4f}); {steady:.1f}"
          f" ms a step (median of the unprofiled steps after the first; "
          f"first {ms[0]:.1f} ms), "
          f"{tokens / steady * 1e3:.0f} tokens/s; run walls {wall:.1f} s and"
          f" {wall2:.1f} s with the checkpoints; peak "
          f"{peak:.2f} GB allocated [{smi}]")
    # the card's step 3 read for the dry run's train step (the launcher's
    # batch, AdamW in float32)
    from repro_torch.training.optimizer import OptConfig
    dry_step(f"the {TRAIN_ARCH} train step {TRAIN_BATCH} x {TRAIN_SEQ}", cfg,
             "train", TRAIN_BATCH, TRAIN_SEQ, reading, OptConfig())
    launches = flash_counts()
    steps = TRAIN_STEPS + TRAIN_RESUME
    check(launches["bwd"] == cfg.n_layers * steps
          and launches["bwd_wgmma"] == launches["bwd"]
          and launches["wgmma"] == 2 * cfg.n_layers * steps
          and launches["f32"] == 0 and share is not None,
          f"flash over the runs: {launches} (each of {steps} steps: "
          f"{cfg.n_layers} forward launches, {cfg.n_layers} more "
          f"recomputed under remat, {cfg.n_layers} backward calls, every "
          f"one on the tensor-core lane); the backward kernels took "
          f"{percent(share)} of a profiled step's device time")
    free_cuda()

    cfg32 = dataclasses.replace(
        cfg, n_layers=TRAIN_CHECK["n_layers"], param_dtype="float32",
        compute_dtype="float32")
    model = Transformer(cfg32, device=cuda, seed=seed, trainable=True)
    pipe = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_CHECK["seq"],
                                      global_batch=TRAIN_CHECK["batch"],
                                      seed=seed))
    batch = make_batch(pipe, cfg32, 0, device=cuda)
    leaves = tree_leaves(model.param_tree())
    out = {}
    before = flash_counts()
    for impl in ("cuda", "ref"):
        loss, _ = lm_loss(model, batch, impl=impl)
        out[impl] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    # the float32 step's calls: the CUDA-core lanes, forward and backward
    f32_calls = {key: n - before[key] for key, n in flash_counts().items()}
    (lc, gc), (lr, gr) = out["cuda"], out["ref"]
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
                for a, b in zip(gc, gr))
    check(abs(lc - lr) <= 1e-5 * abs(lr) and worst <= 1e-4
          and f32_calls["bwd"] == cfg32.n_layers
          and f32_calls["bwd_wgmma"] == 0 and f32_calls["wgmma"] == 0,
          f"one step of {cfg32.n_layers} float32 layers at "
          f"B={TRAIN_CHECK['batch']} S={TRAIN_CHECK['seq']}, impl=cuda "
          f"against impl=ref: loss {lc:.6f} vs {lr:.6f}, every gradient "
          f"leaf within {worst:.3g} of its largest element (<= 1e-4); "
          f"flash calls {f32_calls} (the CUDA-core lanes)")
    launches = {key: n + f32_calls[key] for key, n in launches.items()}
    del model, out, gc, gr, leaves, batch
    free_cuda()
    row = dict(step_ms=steady, tokens_s=tokens / steady * 1e3,
               bwd_share=share, peak_gb=peak, losses=losses + more)
    return launches, row


def whisper_train_main_path(cuda, seed, smi):
    """Whisper-base uncut trained TRAIN_STEPS steps through the launcher's
    main at batch 8, 448 tokens over 448 frames (`enc_seq_ratio` 1.0):
    the loss must fall; ms a step; the backward kernel's calls (encoder,
    decoder self and cross attention, every layer and step)."""
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER_ARCH)
    zero_flash_counts()
    losses, ms, steady, shares, _ = run_trainer(
        ["--arch", WHISPER_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
         str(WHISPER_TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--seed",
         str(seed), "--log-every", "1"], smi)
    share = shares["flash backward"]
    calls = cfg.n_enc_layers + 2 * cfg.n_layers
    launches = flash_counts()
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses))
          and losses[-1] < losses[0]
          and launches["bwd"] == calls * TRAIN_STEPS
          and launches["bwd_wgmma"] == launches["bwd"]
          and launches["wgmma"] == 2 * calls * TRAIN_STEPS,
          f"{WHISPER_ARCH} trained {TRAIN_STEPS} steps at B={TRAIN_BATCH}, "
          f"{WHISPER_TRAIN_SEQ} tokens over {WHISPER_TRAIN_SEQ} frames: loss "
          f"{[round(x, 4) for x in losses]}; {steady:.1f} ms a step (median "
          f"of the unprofiled steps after the first; first {ms[0]:.1f} ms), "
          f"{TRAIN_BATCH * WHISPER_TRAIN_SEQ / steady * 1e3:.0f} decoder "
          f"tokens/s; the backward kernels {percent(share)} of a profiled "
          f"step's device time; flash {launches} [{smi}]")
    free_cuda()
    return launches


# ---------------------------------------------------------------------------
# the RG-LRU backward and RecurrentGemma-2B training (ROADMAP Queue 1 item
# 10.9, Queue 2 item 3)
# ---------------------------------------------------------------------------
RGLRU_BWD_REPLACES = ("none: src/repro/models/rglru.py:44-75 (_lru_coeffs "
                      "and lax.associative_scan, differentiated by XLA's "
                      "autodiff)")
RECUR_TRAIN_ARCH = "recurrentgemma-2b"
# one sequence of 4096 tokens, so that the local attention's window of
# 2048 binds
RECUR_TRAIN_BATCH, RECUR_TRAIN_SEQ = 1, 4096
# the kernel-against-plain check of a train step: one cycle of the pattern
# (rglru, rglru, local_attn) of a float32 copy at B = 1, S = 4096
RECUR_TRAIN_CHECK = dict(n_layers=3, batch=1, seq=4096)
# the RG-LRU backward timed at RecurrentGemma-2B's width over these
# lengths (bf16 u), the first its training shape
RGLRU_BWD_TIMED = (4096, 32768)
# the flash backward at RecurrentGemma-2B's local attention in training:
# (B, H, Hkv, S = T, D, window), bf16, causal: the tensor-core lane
RG_FLASH_BWD = (1, 10, 1, 4096, 256, 2048)
# the train step's kernels reported apart in a profiled step: what ->
# substrings of their kernels' names
STEP_KERNELS = {"flash backward": ("flash_bwd",),
                "RG-LRU backward": ("rglru_scan_bwd",),
                "SSD backward": ("ssd_bwd_",)}


def rglru_bwd_against_plain(cuda):
    """The RG-LRU backward kernel against its plain version on the card
    over `kernels/rglru_scan/bwd_cases.py`'s cases (the forward kernel's
    h, as training saves it): each gradient within its limit, two calls
    bit for bit equal, one count in "bwd" a call. Returns the largest
    |kernel - plain| over the cases and gradients."""
    import torch
    from repro_torch.kernels.rglru_scan import (LAUNCHES,
                                                rglru_scan_bwd_kernel,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_kernel)
    from repro_torch.kernels.rglru_scan.bwd_cases import (BWD_CASES, GRADS,
                                                          bwd_errors,
                                                          bwd_inputs,
                                                          bwd_limits)
    worst = 0.0
    for B, S, W, dt, h0, clamp in BWD_CASES:
        args, dh = bwd_inputs(B, S, W, dt, h0, clamp, cuda, S + W)
        h = rglru_scan_kernel(*args)
        before = LAUNCHES["bwd"]
        got = rglru_scan_bwd_kernel(*args[:6], h, dh, args[6])
        again = rglru_scan_bwd_kernel(*args[:6], h, dh, args[6])
        ref = rglru_scan_bwd_ref(*args[:6], h, dh, args[6])
        torch.cuda.synchronize()
        errs = bwd_errors(got, ref)
        pairs = [(n, e, lim) for n, e, lim in zip(GRADS, errs,
                                                  bwd_limits(dt))
                 if e is not None]
        same = all(a is c or torch.equal(a, c) for a, c in zip(got, again))
        worst = max([worst] + [float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, ref) if b is not None])
        check(all(e <= lim for _, e, lim in pairs) and same
              and LAUNCHES["bwd"] == before + 2,
              f"rglru bwd ({B}, S={S}, W={W}) {dt} u, h0 {h0}, clamp "
              f"{clamp}: max |kernel - plain| / max |plain| "
              + ", ".join(f"{n} {e:.3g} (<= {lim:g})" for n, e, lim in pairs)
              + "; two runs bit for bit equal")
        del args, dh, h, got, again, ref
    from repro_torch.kernels.rglru_scan import bwd_flags
    flags = bwd_flags(cuda, torch.cuda.current_stream().cuda_stream)
    check(flags is not None and bool((flags == 255).all()),
          f"rglru bwd: its {flags.numel():,} bytes of flags kept between "
          f"calls (the ticket, the composite words, the tiles' counts) all "
          f"ones again after the {len(BWD_CASES)} cases")
    free_cuda()
    return worst


def kernel_short_name(name):
    """A device kernel's name as the profiler gives it, shortened: the
    function's own name, or an elementwise kernel's functor (a fill is
    "FillFunctor")."""
    import re
    m = re.search(r"at::native::(?:\w+::)*(\w+Functor)", name)
    if m is not None:
        return m.group(1)
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def profiled_kernels(fn, calls=20):
    """Each kernel fn() launches, by `kernel_short_name`: "ms", the mean
    device ms of a launch, and "launches", its launches a call, over the
    events torch.profiler kept of `calls` calls after a warm-up (it may
    drop an event, so "launches" may read a little low); {} if it saw no
    device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms, n = out.get(kernel_short_name(e.name), (0.0, 0))
        out[kernel_short_name(e.name)] = (
            ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {k: {"ms": ms / n, "launches": n / calls}
            for k, (ms, n) in out.items()}


def rglru_bwd_times(cuda, seed, S, W=2560):
    """The RG-LRU backward kernel at 1 x S x W with bf16 u (inputs from
    `bwd_cases.bwd_inputs` at `seed` on the card, the forward kernel's h):
    "kernel" and "plain" ms (`cuda_ms`), "errs" (each gradient's error
    over its largest plain element, `bwd_errors`), "err" (the largest
    |kernel - plain| but dh0's), "within" (each error within its
    `bwd_limits`), "launches" (the "bwd" count's rise over a call),
    "kernels" (`profiled_kernels` of a call: each device kernel's ms and
    launches a call, the workspace's fill among them) and "inputs" (u on
    the meta device). Only the scan's public functions are imported, so
    tools/time_scans.py times another checkout by the same method."""
    from repro_torch.kernels.rglru_scan import (LAUNCHES,
                                                rglru_scan_bwd_kernel,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_kernel)
    from repro_torch.kernels.rglru_scan.bwd_cases import (bwd_errors,
                                                          bwd_inputs,
                                                          bwd_limits)
    args, dh = bwd_inputs(1, S, W, "bf16", False, False, cuda, seed)
    h = rglru_scan_kernel(*args)

    def kernel():
        return rglru_scan_bwd_kernel(*args[:6], h, dh)
    before = LAUNCHES["bwd"]
    got = kernel()
    launches = LAUNCHES["bwd"] - before
    ref = rglru_scan_bwd_ref(*args[:6], h, dh)
    errs = bwd_errors(got, ref)[:6]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got[:6], ref[:6]))
    within = all(e <= lim for e, lim in zip(errs, bwd_limits("bf16")))
    del got, ref
    t = {"kernel": cuda_ms(kernel, 20),
         "plain": cuda_ms(lambda: rglru_scan_bwd_ref(*args[:6], h, dh), 3),
         "kernels": profiled_kernels(kernel), "errs": errs, "err": err,
         "within": within, "launches": launches,
         "inputs": (args[0].to("meta"),)}
    del args, dh, h
    free_cuda()
    return t


def rglru_kernel_attrs():
    """Registers, shared bytes, spilled (local) bytes and resident blocks
    an SM of every RG-LRU kernel instantiation, as the card reports them
    (`rglru_scan.kernel_attrs`); {} for a checkout without that report."""
    from repro_torch.kernels import rglru_scan
    attrs = getattr(rglru_scan, "kernel_attrs", None)
    return {} if attrs is None else attrs()


def rglru_bwd_timing(cuda, seed, smi):
    """The RG-LRU backward at RecurrentGemma-2B's width, 1 x S x 2560 with
    bf16 u for each S of RGLRU_BWD_TIMED (4096: its training shape; 32768:
    512 chunks folded through group composites): the kernel, its plain
    version, each of its launches' profiled ms and the byte bound; no one
    PyTorch call computes it; then every RG-LRU kernel's registers, shared
    bytes, spills and blocks an SM. Returns {S: row}."""
    rows = {}
    for S in RGLRU_BWD_TIMED:
        t = rglru_bwd_times(cuda, seed, S)
        check(t["within"], f"rglru bwd at 1 x {S} x 2560 bf16: "
              f"{', '.join(f'{e:.3g}' for e in t['errs'])}")
        b_ms, b_by = bounds.rglru_bwd_bound(*t["inputs"])
        each = ", ".join(f"{k} {v['ms']:.4f} ms x {v['launches']:g} a "
                         f"call" for k, v in t["kernels"].items())
        print(f"  rglru bwd 1 x {S} x 2560, bf16 u: kernel "
              f"{t['kernel']:.4f} ms ({each}), plain {t['plain']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}); kernel at "
              f"{100 * b_ms / t['kernel']:.1f}% of bound; max |kernel - "
              f"plain| {t['err']:.3g} [{smi}]")
        rows[S] = dict(t, bound_ms=b_ms, bound_by=b_by)
    for name, a in rglru_kernel_attrs().items():
        print(f"  {name}: {a['registers']} registers, {a['shared']} B "
              f"shared, {a['local']} B spilled, {a['blocks']} blocks an SM")
    return rows


def flash_bwd_tile_bytes(B, H, Hkv, S, T, D, causal=True, window=None,
                         prefix=0):
    """Bytes the tensor-core backward's TMA copies bring into shared
    memory in one call given the forward's lse, by launch, from its loop
    bounds (flash_attention_bwd_wgmma.cu): launch B ("dq") loads a q tile's
    Q and dO once and K and V (64 keys each) for every kv tile from the
    window's first to the diagonal's; launch A ("dkv") loads a key tile's
    K and V once and, for each query head of its group, Q, dO (64 rows)
    and their lse and Delta for every q tile that sees the tile, twice
    where dK and dV take two passes (D >= 128). Tiles past the tensors'
    ends count as loaded (TMA fills them with zeros). Returns
    {"dq": bytes, "dkv": bytes}."""
    consumers = 1 if D == 256 else 2
    bq_b, bk_a = 64 * consumers, 64 * consumers
    passes = 2 if D >= 128 else 1
    tile = 64 * D * 2                       # one 64-row bf16 tile
    nk, nq = -(-T // 64), -(-S // 64)
    dq = 0
    for q0 in range(0, S, bq_b):
        last = max(q0 + bq_b - 1, prefix - 1)
        n_kv = min(nk, last // 64 + 1) if causal else nk
        kt0 = max(0, q0 - window + 1) // 64 if window else 0
        dq += 2 * bq_b * D * 2 + max(0, n_kv - kt0) * 2 * tile
    dkv = 0
    for k0 in range(0, T, bk_a):
        qt0 = k0 // 64 if causal and k0 >= prefix else 0
        qt1 = nq
        if window:
            qt1 = min(nq, (min(k0 + bk_a, T) - 1 + window - 1) // 64 + 1)
        dkv += (2 * bk_a * D * 2 + (H // Hkv) * max(0, qt1 - qt0) * passes
                * (2 * tile + 2 * 64 * 4))
    return {"dq": B * H * dq, "dkv": B * Hkv * dkv}


def flash_bwd_launch_ms(fn, calls=5):
    """Device ms a call of each of the backward's launches ("dq", "dkv",
    and on the tensor-core lane "sum" where the heads split), from
    torch.profiler over `calls` calls of fn after a warm-up; {} if the
    profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "flash_bwd" not in e.name:
            continue
        key = ("dq" if "flash_bwd_dq" in e.name else
               "sum" if "sum_kernel" in e.name else "dkv")
        ms[key] = ms.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return ms


def flash_bwd_window_timing(cuda, seed, smi):
    """The flash backward at RecurrentGemma-2B's local attention in
    training (RG_FLASH_BWD: bf16, D = 256, one kv head, window 2048,
    causal; the tensor-core lane), given the tensor-core forward's o and
    lse as training gives them, and again without the lse (rebuilt):
    held to its plain version, and timed beside it, beside the backward
    of one scaled_dot_product_attention call with the window as a
    boolean mask (the same function) and of one with is_causal and no
    window (a flash-backed library time over a third more pairs), and
    beside the bound of the window's pairs (4 (Dk + Dv) flops each at
    bf16's peak). Then each launch's device ms from the profiler beside
    the bytes its TMA copies bring into shared memory
    (`flash_bwd_tile_bytes`): the rate at which L2 feeds the SMs. The
    kernel must beat SDPA's masked backward. Returns the row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (LAUNCHES, bwd_lane,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref)
    from repro_torch.kernels.flash_attention.bwd_cases import (BWD_LIMIT,
                                                               bwd_errors)
    B, H, Hkv, S, D, window = RG_FLASH_BWD
    check(bwd_lane(torch.bfloat16, D) == "wgmma",
          f"bf16 at D = {D}: the tensor-core backward lane")
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    o, lse = flash_attention(q, k, v, window=window, return_lse=True)
    do = torch.randn(o.shape, generator=g, device=cuda).to(torch.bfloat16)
    before = LAUNCHES["bwd_wgmma"]
    got = flash_attention_bwd(q, k, v, o, do, window=window, lse=lse)
    rebuilt = flash_attention_bwd(q, k, v, o, do, window=window)
    ref = flash_attention_bwd_ref(q, k, v, o, do, window=window)
    torch.cuda.synchronize()
    errs = bwd_errors(got, ref, S)
    errs_rebuilt = bwd_errors(rebuilt, ref, S)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in (*zip(got, ref), *zip(rebuilt, ref)))
    check(max(errs + errs_rebuilt) <= BWD_LIMIT["bf16"]
          and LAUNCHES["bwd_wgmma"] == before + 2,
          f"flash bwd at RecurrentGemma-2B's training shape ({B},{H},{Hkv},"
          f"S=T={S},D={D}) window {window} bf16 on the tensor-core lane: "
          f"max |kernel - plain| / max |plain| of dq, dk, dv = "
          f"{', '.join(f'{e:.3g}' for e in errs)} given the forward's lse,"
          f" {', '.join(f'{e:.3g}' for e in errs_rebuilt)} without (<= "
          f"{BWD_LIMIT['bf16']:g})")
    del got, rebuilt, ref
    free_cuda()
    i = torch.arange(S, device=cuda)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    os_ = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         enable_gqa=True)
    qc, kc, vc = (x.detach().clone().requires_grad_() for x in (q, k, v))
    oc = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                        enable_gqa=True)
    t = {"kernel": cuda_ms(lambda: flash_attention_bwd(
             q, k, v, o, do, window=window, lse=lse), 5),
         "no_lse": cuda_ms(lambda: flash_attention_bwd(
             q, k, v, o, do, window=window), 5),
         "plain": cuda_ms(lambda: flash_attention_bwd_ref(
             q, k, v, o, do, window=window), 2),
         "sdpa_bwd": cuda_ms(lambda: torch.autograd.grad(
             os_, (qs, ks, vs), do, retain_graph=True), 5),
         "sdpa_causal_bwd": cuda_ms(lambda: torch.autograd.grad(
             oc, (qc, kc, vc), do, retain_graph=True), 5)}
    b_ms, b_by = bounds.flash_bwd_bound(q, k, v, window=window)
    print(f"  flash bwd wgmma lane, RecurrentGemma-2B B={B} H={H} Hkv={Hkv}"
          f" S=T={S} D={D} window {window} bf16: kernel {t['kernel']:.4f} "
          f"ms given the forward's lse ({t['no_lse']:.4f} ms without, "
          f"rebuilt), plain {t['plain']:.4f} ms, SDPA backward (the window "
          f"as a boolean mask) {t['sdpa_bwd']:.4f} ms, SDPA backward "
          f"is_causal without the window {t['sdpa_causal_bwd']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; "
          f"{bounds.attention_pairs(S, S, True, window):,} pairs a head); "
          f"kernel "
          f"at {100 * b_ms / t['kernel']:.1f}% of bound, "
          f"{t['sdpa_bwd'] / t['kernel']:.3f}x the masked SDPA's speed, "
          f"{t['sdpa_causal_bwd'] / t['kernel']:.3f}x the causal SDPA's; "
          f"max |kernel - plain| {err:.3g} [{smi}]")
    check(t["kernel"] < t["sdpa_bwd"],
          f"the tensor-core backward ({t['kernel']:.4f} ms) is faster than "
          f"SDPA's masked backward ({t['sdpa_bwd']:.4f} ms) on the same "
          f"inputs")
    launch_ms = flash_bwd_launch_ms(lambda: flash_attention_bwd(
        q, k, v, o, do, window=window, lse=lse))
    tiles = flash_bwd_tile_bytes(B, H, Hkv, S, S, D, window=window)
    print("  its launches (profiled, device ms a call): " + "; ".join(
        f"{name} {ms:.4f} ms" + (
            f", {tiles[name] / 1e9:.3f} GB of tiles into shared memory "
            f"({tiles[name] / ms / 1e9:.2f} TB/s)" if name in tiles else "")
        for name, ms in launch_ms.items()) + f" [{smi}]")
    del q, k, v, o, lse, do, qs, ks, vs, os_, qc, kc, vc, oc, mask
    free_cuda()
    return dict(t, bound_ms=b_ms, bound_by=b_by, err=err)


def zero_lru_counts():
    from repro_torch.kernels.rglru_scan import LAUNCHES
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def recurrent_train_main_path(cuda, seed, smi):
    """RecurrentGemma-2B uncut in bf16 (2,894,528,000 parameters; AdamW's
    float32 moments 23.2 GB) trained through `launch.train`'s main for
    TRAIN_STEPS steps at --batch 1 --seq 4096, where the window of 2048
    binds: the loss of each step (it must fall), ms a step, tokens/s, peak
    memory, the RG-LRU backward's calls (one per rglru layer and step) and
    the flash backward's (one per local_attn layer and step), and their
    shares of a profiled step's device time. Then one step's loss and
    gradients with impl="cuda" against impl="ref" on a float32 copy cut
    to RECUR_TRAIN_CHECK (one cycle: rglru, rglru, local_attn; B = 1,
    S = 4096): the loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest element. Returns (the RG-LRU launches, the flash
    launches by lane, row for the record)."""
    import torch
    from repro_torch.analysis.flops import total_params
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens, make_batch
    from repro_torch.kernels.rglru_scan import LAUNCHES as LRU
    from repro_torch.models import Transformer
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import lm_loss

    cfg = get_config(RECUR_TRAIN_ARCH)
    kinds = cfg.layer_kinds()
    n_lru, n_att = kinds.count("rglru"), kinds.count("local_attn")
    check(total_params(cfg) == RECUR_ARCHS[RECUR_TRAIN_ARCH]["params"]
          and cfg.remat,
          f"{RECUR_TRAIN_ARCH}: {total_params(cfg):,} parameters, {n_lru} "
          f"rglru + {n_att} local_attn layers (window {cfg.local_window}), "
          f"each recomputed in the backward (remat)")
    zero_flash_counts()
    zero_lru_counts()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, ms, steady, shares, wall = run_trainer(
        ["--arch", RECUR_TRAIN_ARCH, "--batch", str(RECUR_TRAIN_BATCH),
         "--seq", str(RECUR_TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
         "--seed", str(seed), "--log-every", "1"], smi)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    lru, flash = dict(LRU), flash_counts()
    tokens = RECUR_TRAIN_BATCH * RECUR_TRAIN_SEQ
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses))
          and losses[-1] < losses[0],
          f"{RECUR_TRAIN_ARCH} trained {TRAIN_STEPS} steps at "
          f"B={RECUR_TRAIN_BATCH} S={RECUR_TRAIN_SEQ} bf16: loss "
          f"{[round(x, 4) for x in losses]}; {steady:.1f} ms a step (median "
          f"of the unprofiled steps after the first; first {ms[0]:.1f} ms; "
          f"all {[round(x, 1) for x in ms]}), {tokens / steady * 1e3:.0f} "
          f"tokens/s; run wall {wall:.1f} s; peak {peak:.2f} GB allocated "
          f"[{smi}]")
    check(lru == {"scan": 2 * n_lru * TRAIN_STEPS, "step": 0,
                  "bwd": n_lru * TRAIN_STEPS}
          and flash == {"wgmma": 2 * n_att * TRAIN_STEPS, "f32": 0,
                        "bwd": n_att * TRAIN_STEPS,
                        "bwd_wgmma": n_att * TRAIN_STEPS}
          and None not in shares.values(),
          f"launches over the run: rglru {lru}, flash {flash} (each of "
          f"{TRAIN_STEPS} steps: {n_lru} RG-LRU forwards, {n_lru} more "
          f"recomputed under remat, {n_lru} backward calls; {n_att} flash "
          f"forwards on the tensor cores, {n_att} recomputed, {n_att} "
          f"backward calls on the tensor-core lane); of a profiled step's "
          f"device time the RG-LRU backward took "
          f"{percent(shares['RG-LRU backward'])}, the flash backward "
          f"{percent(shares['flash backward'])}")
    free_cuda()

    cfg32 = dataclasses.replace(
        cfg, n_layers=RECUR_TRAIN_CHECK["n_layers"], param_dtype="float32",
        compute_dtype="float32")
    model = Transformer(cfg32, device=cuda, seed=seed, trainable=True)
    pipe = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=RECUR_TRAIN_CHECK["seq"],
        global_batch=RECUR_TRAIN_CHECK["batch"], seed=seed))
    batch = make_batch(pipe, cfg32, 0, device=cuda)
    leaves = tree_leaves(model.param_tree())
    out = {}
    before = (dict(LRU), flash_counts())
    for impl in ("cuda", "ref"):
        loss, _ = lm_loss(model, batch, impl=impl)
        out[impl] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    f32_lru = {key: n - before[0][key] for key, n in LRU.items()}
    f32_flash = {key: n - before[1][key] for key, n in flash_counts().items()}
    (lc, gc), (lr, gr) = out["cuda"], out["ref"]
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
                for a, b in zip(gc, gr))
    kinds32 = cfg32.layer_kinds()
    check(abs(lc - lr) <= 1e-5 * abs(lr) and worst <= 1e-4
          and f32_lru["bwd"] == kinds32.count("rglru")
          and f32_flash["bwd"] == kinds32.count("local_attn")
          and f32_flash["bwd_wgmma"] == 0,
          f"one step of a float32 copy cut to {kinds32} at "
          f"B={RECUR_TRAIN_CHECK['batch']} S={RECUR_TRAIN_CHECK['seq']}, "
          f"impl=cuda against impl=ref: loss {lc:.6f} vs {lr:.6f}, every "
          f"gradient leaf within {worst:.3g} of its largest element (<= "
          f"1e-4); rglru calls {f32_lru}, flash calls {f32_flash}")
    del model, out, gc, gr, leaves, batch
    free_cuda()
    lru = {key: n + f32_lru[key] for key, n in lru.items()}
    flash = {key: n + f32_flash[key] for key, n in flash.items()}
    row = dict(step_ms=steady, tokens_s=tokens / steady * 1e3, shares=shares,
               peak_gb=peak, losses=losses)
    return lru, flash, row


# ---------------------------------------------------------------------------
# the SSD backward and Mamba2-2.7B training (ROADMAP Queue 1 item 10.9,
# Queue 2 item 2)
# ---------------------------------------------------------------------------
SSD_BWD_REPLACES = ("none: src/repro/models/ssm.py:59-110 (_ssd_scan, "
                    "differentiated by XLA's autodiff)")
SSD_TRAIN_ARCH = "mamba2-2.7b"
SSD_TRAIN_BATCH, SSD_TRAIN_SEQ = 1, 4096
# the kernel-against-plain check of a train step: a float32 copy cut to 2
# of its 64 SSD layers at B = 1, S = 4096
SSD_TRAIN_CHECK = dict(n_layers=2, batch=1, seq=4096)
# the SSD backward timed at Mamba2-2.7B's training shape, bf16:
# (B, S, H, P, N, Q)
SSD_BWD_TIMED = (1, 4096, 80, 64, 128, 256)
# the plain backward's time, host- and allocator-bound (its many small
# operations and their temporaries), is the median of this many reads
SSD_BWD_PLAIN_READS = 7
def zero_ssd_counts():
    from repro_torch.kernels.ssd_scan import LAUNCHES
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def ssd_bwd_against_plain(cuda):
    """The SSD backward kernel against its plain version on the card over
    `kernels/ssd_scan/bwd_cases.py`'s cases: each gradient within its
    limit, two calls bit for bit equal, one count in "bwd" a call. Returns
    the largest |kernel - plain| over the cases and gradients."""
    import torch
    from repro_torch.kernels.ssd_scan import (LAUNCHES, ssd_scan_bwd_kernel,
                                              ssd_scan_bwd_ref)
    from repro_torch.kernels.ssd_scan.bwd_cases import (BWD_CASES, GRADS,
                                                        bwd_errors,
                                                        bwd_inputs,
                                                        bwd_limits)
    worst = 0.0
    for B, S, H, P, N, Q, dt, h0, dhl, steep in BWD_CASES:
        args, dy, dh_last = bwd_inputs(B, S, H, P, N, dt, h0, dhl, steep,
                                       cuda, S + H)
        before = LAUNCHES["bwd"]
        got = ssd_scan_bwd_kernel(*args[:5], Q, dy, dh_last, args[5])
        again = ssd_scan_bwd_kernel(*args[:5], Q, dy, dh_last, args[5])
        ref = ssd_scan_bwd_ref(*args[:5], Q, dy, dh_last, args[5])
        torch.cuda.synchronize()
        errs = bwd_errors(got, ref)
        pairs = [(n, e, lim) for n, e, lim in zip(GRADS, errs,
                                                  bwd_limits(dt))
                 if e is not None]
        same = all(a is c or torch.equal(a, c) for a, c in zip(got, again))
        worst = max([worst] + [float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, ref) if b is not None])
        check(all(e <= lim for _, e, lim in pairs) and same
              and LAUNCHES["bwd"] == before + 2,
              f"ssd bwd ({B}, S={S}, H={H}, P={P}, N={N}, Q={Q}) {dt}, h0 "
              f"{h0}, dh_last {dhl}, steep {steep}: max |kernel - plain| / "
              f"max |plain| "
              + ", ".join(f"{n} {e:.3g} (<= {lim:g})" for n, e, lim in pairs)
              + "; two runs bit for bit equal")
        del args, dy, dh_last, got, again, ref
    free_cuda()
    return worst


def ssd_bwd_launch_ms(fn, calls=5):
    """Device ms a launch of each of the SSD backward's kernels (one a
    call), by the name between `ssd_bwd_` and `_kernel`: the mean over
    the events torch.profiler kept of `calls` calls of fn after a warm-up
    (it may drop a cycle's first event); {} if it saw no device event."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        m = re.search(r"ssd_bwd_(\w+?)_kernel", e.name)
        if e.device_type != DeviceType.CUDA or m is None:
            continue
        us.setdefault(m.group(1), []).append(e.time_range.elapsed_us())
    return {key: statistics.fmean(v) / 1e3 for key, v in us.items()}


def ssd_bwd_times(cuda, seed):
    """The SSD backward kernel at Mamba2-2.7B's training shape
    (SSD_BWD_TIMED, bf16 x; inputs from `bwd_cases.bwd_inputs` at `seed`
    on the card): "kernel" ms (`cuda_ms`), "plain" ms (the median of
    SSD_BWD_PLAIN_READS reads: host- and allocator-bound, it moves between
    reads), "errs" (dx, db, dc, ddt and da_log's error over the largest
    plain element), "err" (their largest |kernel - plain|), "launches"
    (the "bwd" count's rise over a call), "launch_ms" (each launch's
    profiled ms a call, `ssd_bwd_launch_ms`), "peak_mb" (the device memory
    a call allocates at its peak: its workspace and its results) and
    "inputs" (x, b and dt on the meta device). Only the scan's public
    functions are imported, so tools/time_scans.py times another checkout
    by the same method."""
    import torch
    from repro_torch.kernels.ssd_scan import (LAUNCHES, ssd_scan_bwd_kernel,
                                              ssd_scan_bwd_ref)
    from repro_torch.kernels.ssd_scan.bwd_cases import (bwd_errors,
                                                        bwd_inputs)
    B, S, H, P, N, Q = SSD_BWD_TIMED
    args, dy, _ = bwd_inputs(B, S, H, P, N, "bf16", False, False, False,
                             cuda, seed)

    def kernel():
        return ssd_scan_bwd_kernel(*args[:5], Q, dy)
    before = LAUNCHES["bwd"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = kernel()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    launches = LAUNCHES["bwd"] - before
    ref = ssd_scan_bwd_ref(*args[:5], Q, dy)
    errs = bwd_errors(got[:5], ref[:5])
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got[:5], ref[:5]))
    scale = max(float(b.float().abs().max()) for b in ref[:5])
    del got, ref
    t = {"kernel": cuda_ms(kernel, 10),
         "plain": statistics.median(
             cuda_ms(lambda: ssd_scan_bwd_ref(*args[:5], Q, dy), 2)
             for _ in range(SSD_BWD_PLAIN_READS)),
         "launch_ms": ssd_bwd_launch_ms(kernel),
         "errs": errs, "err": err, "scale": scale, "launches": launches,
         "peak_mb": peak_mb,
         "inputs": tuple(t.to("meta") for t in (args[0], args[1], args[3]))}
    del args, dy
    free_cuda()
    return t


def ssd_kernel_attrs(bf16=True):
    """Registers, shared bytes, spilled (local) bytes and resident blocks
    an SM of the SSD forward's chunk kernel and of each backward kernel
    with x of the given type, as the card reports them
    (`ssd_scan.kernel_attrs`); {} for a checkout without that report."""
    from repro_torch.kernels import ssd_scan
    attrs = getattr(ssd_scan, "kernel_attrs", None)
    return {} if attrs is None else attrs(bf16)


def ssd_bwd_timing(cuda, seed, smi):
    """The SSD backward at Mamba2-2.7B's training shape (SSD_BWD_TIMED,
    bf16, `ssd_bwd_times`): the kernel, its plain version, each launch's
    profiled ms, each kernel's registers, shared bytes and blocks an SM,
    and the bound; no one PyTorch call computes it. Then the float32
    lane's kernel and launches at the same shape (the lane that keeps the
    first design). Returns the row."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_kernel
    from repro_torch.kernels.ssd_scan.bwd_cases import (bwd_inputs,
                                                        bwd_limits)
    B, S, H, P, N, Q = SSD_BWD_TIMED
    t = ssd_bwd_times(cuda, seed)
    errs = t["errs"]
    check(all(e <= lim for e, lim in zip(errs, bwd_limits("bf16"))),
          f"ssd bwd at {B} x {S} x {H} x {P} x {N}, Q = {Q}, bf16: "
          f"{', '.join(f'{e:.3g}' for e in errs)}")
    b_ms, b_by = bounds.ssd_bwd_bound(*t["inputs"], Q)
    parts = bounds.ssd_bwd_work(B, S, H, P, N, Q)
    work = sum(parts.values())
    print(f"  ssd bwd {B} x {S} x {H} x {P} x {N}, Q = {Q}, bf16: kernel "
          f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms (median of "
          f"{SSD_BWD_PLAIN_READS} reads), bound "
          f"{b_ms:.4f} ms ({b_by}: {parts['bfloat16'] / 1e9:.2f} GFLOP at "
          f"bf16's peak, {parts['tfloat32'] / 1e9:.2f} at TF32's); "
          f"kernel at {100 * b_ms / t['kernel']:.1f}% of bound, "
          f"{work / t['kernel'] / 1e9:.1f} TFLOP/s; max |kernel - plain| "
          f"{t['err']:.3g}; library: none [{smi}]")
    print("  its launches (profiled ms a call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t["launch_ms"].items())
          + f"; a call allocates {t['peak_mb']:.1f} MB at its peak "
          f"(workspace and results)")
    for name, a in ssd_kernel_attrs().items():
        print(f"  {name} (bf16): {a['registers']} registers, "
              f"{a['shared']} shared bytes, {a['local']} local bytes, "
              f"{a['blocks']} blocks an SM")
    args, dy, _ = bwd_inputs(B, S, H, P, N, "f32", False, False, False,
                             cuda, seed)

    def f32():
        return ssd_scan_bwd_kernel(*args[:5], Q, dy)
    f32_ms = cuda_ms(f32, 5)
    print(f"  the float32 lane at the same shape: kernel {f32_ms:.4f} ms; "
          f"its launches (profiled ms a call): "
          + ", ".join(f"{k} {v:.4f}"
                      for k, v in ssd_bwd_launch_ms(f32, 3).items()))
    del args, dy
    free_cuda()
    return dict(t, bound_ms=b_ms, bound_by=b_by)


def mamba2_train_main_path(cuda, seed, smi):
    """Mamba2-2.7B uncut in bf16 (2,702,296,576 parameters; AdamW's float32
    moments 21.6 GB) trained through `launch.train`'s main for TRAIN_STEPS
    steps at --batch 1 --seq 4096: the loss of each step (it must fall), ms
    a step, tokens/s, peak memory, the SSD scan's calls (the forward and
    its remat recompute, three launches each, and one backward call, a
    layer a step) and the backward's share of a profiled step's device
    time. Then one step's loss and gradients with impl="cuda" against
    impl="ref" on a float32 copy cut to SSD_TRAIN_CHECK (2 layers, B = 1,
    S = 4096): the loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest element. Returns (the SSD launches, row for the
    record)."""
    import torch
    from repro_torch.analysis.flops import total_params
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens, make_batch
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.models import Transformer
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import lm_loss

    cfg = get_config(SSD_TRAIN_ARCH)
    n_ssd = cfg.layer_kinds().count("ssd")
    check(total_params(cfg) == RECUR_ARCHS[SSD_TRAIN_ARCH]["params"]
          and cfg.remat and n_ssd == cfg.n_layers,
          f"{SSD_TRAIN_ARCH}: {total_params(cfg):,} parameters, {n_ssd} ssd "
          f"layers (H = {cfg.ssm_heads}, P = {cfg.ssm_headdim}, N = "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}), each recomputed in the "
          f"backward (remat)")
    zero_ssd_counts()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, ms, steady, shares, wall = run_trainer(
        ["--arch", SSD_TRAIN_ARCH, "--batch", str(SSD_TRAIN_BATCH),
         "--seq", str(SSD_TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
         "--seed", str(seed), "--log-every", "1"], smi)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    ssd = dict(SSD)
    tokens = SSD_TRAIN_BATCH * SSD_TRAIN_SEQ
    share = shares["SSD backward"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses))
          and losses[-1] < losses[0],
          f"{SSD_TRAIN_ARCH} trained {TRAIN_STEPS} steps at "
          f"B={SSD_TRAIN_BATCH} S={SSD_TRAIN_SEQ} bf16: loss "
          f"{[round(x, 4) for x in losses]}; {steady:.1f} ms a step (median "
          f"of the unprofiled steps after the first; first {ms[0]:.1f} ms; "
          f"all {[round(x, 1) for x in ms]}), {tokens / steady * 1e3:.0f} "
          f"tokens/s; run wall {wall:.1f} s; peak {peak:.2f} GB allocated "
          f"[{smi}]")
    check(ssd == {"scan": 3 * 2 * n_ssd * TRAIN_STEPS, "step": 0,
                  "bwd": n_ssd * TRAIN_STEPS} and share is not None,
          f"ssd_scan launches over the run: {ssd} (each of {TRAIN_STEPS} "
          f"steps: {n_ssd} forwards of 3 launches, {n_ssd} more recomputed "
          f"under remat, {n_ssd} backward calls); of a profiled step's "
          f"device time the SSD backward's seven kernels took "
          f"{percent(share)}")
    free_cuda()

    cfg32 = dataclasses.replace(
        cfg, n_layers=SSD_TRAIN_CHECK["n_layers"], param_dtype="float32",
        compute_dtype="float32")
    model = Transformer(cfg32, device=cuda, seed=seed, trainable=True)
    pipe = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SSD_TRAIN_CHECK["seq"],
        global_batch=SSD_TRAIN_CHECK["batch"], seed=seed))
    batch = make_batch(pipe, cfg32, 0, device=cuda)
    leaves = tree_leaves(model.param_tree())
    out = {}
    before = dict(SSD)
    for impl in ("cuda", "ref"):
        loss, _ = lm_loss(model, batch, impl=impl)
        out[impl] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    f32_ssd = {key: n - before[key] for key, n in SSD.items()}
    (lc, gc), (lr, gr) = out["cuda"], out["ref"]
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(gc, gr)]
    worst = max(errs)
    check(abs(lc - lr) <= 1e-5 * abs(lr) and worst <= 1e-4
          and f32_ssd["bwd"] == cfg32.n_layers and f32_ssd["step"] == 0,
          f"one step of a float32 copy cut to {cfg32.n_layers} layers at "
          f"B={SSD_TRAIN_CHECK['batch']} S={SSD_TRAIN_CHECK['seq']}, "
          f"impl=cuda against impl=ref: loss {lc:.6f} vs {lr:.6f}, every "
          f"gradient leaf within {worst:.3g} of its largest element (<= "
          f"1e-4; the worst leaf {errs.index(worst)} of {len(errs)}); ssd "
          f"calls {f32_ssd}")
    del model, out, gc, gr, leaves, batch
    free_cuda()
    ssd = {key: n + f32_ssd[key] for key, n in ssd.items()}
    row = dict(step_ms=steady, tokens_s=tokens / steady * 1e3,
               bwd_share=share, peak_gb=peak, losses=losses)
    return ssd, row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the Yi-6B weights and prompts")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.analysis.roofline import H100
    from repro_torch.configs.pagerank import STANFORD
    from repro_torch.core.backend import (BackendSpec, as_spec,
                                          google_apply, prepare, seed_stack)
    from repro_torch.core.pagerank import (kendall_tau_topk, solve_linear,
                                           solve_power)
    from repro_torch.core.spmd import SPMDConfig, solve_spmd
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.google import GoogleOperator, exact_pagerank
    from repro_torch.kernels import build
    from repro_torch.kernels.bsr_spmv import (DEFAULT_BM, LAUNCHES,
                                              bsr_spmv, bsr_spmv_ref,
                                              build_bsr, hybrid_matvec,
                                              kernel_path, pad_x)
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR_LAUNCHES

    # the plain version is an einsum: full f32, not TF32, so that it is a
    # fair oracle for the kernel's f32 FMAs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    with phase("card"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(f"device: {kind} (count {torch.cuda.device_count()})")
        print(smi)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    with phase("build"):
        for name, secs in build.build_all().items():
            print(f"  {name}: {secs:.2f} s")

    max_err = {"f32": 0.0, "kahan": 0.0}
    paths = {"ring": 0, "generic": 0}

    def against_plain(blocks, blk_cols, x, counts, tol, what):
        """Both lanes against the plain version over all K, the kernel
        reading all K and reading only the real slots (`counts`)."""
        count = torch.as_tensor(counts, device=cuda)
        path = kernel_path(blocks, x)
        paths[path] += 1
        errs = []
        for accum in ("f32", "kahan"):
            y_ref = bsr_spmv_ref(blocks, blk_cols, x, accum=accum)
            scale = float(y_ref.abs().max())
            for blk_count in (None, count):
                y = bsr_spmv(blocks, blk_cols, x, accum=accum,
                             blk_count=blk_count)
                torch.cuda.synchronize()
                err = float((y - y_ref).abs().max())
                errs.append(err <= tol * (1.0 + scale))
                max_err[accum] = max(max_err[accum], err)
        check(all(errs), f"{what} ({path}): both lanes, all K and real "
              f"slots, max |kernel - plain| <= {tol:g} x (1 + max|y|)")

    def operands(bsr, x):
        return (torch.as_tensor(bsr.blocks, device=cuda),
                torch.as_tensor(bsr.blk_cols, device=cuda),
                torch.as_tensor(pad_x(x, bsr.n_cols, bsr.bn), device=cuda))

    def coo(rng, n_rows, n_cols, nnz):
        rows = rng.integers(0, n_rows, nnz)
        cols = rng.integers(0, n_cols, nnz)
        vals = rng.standard_normal(nnz)
        _, keep = np.unique(rows * n_cols + cols, return_index=True)
        return rows[keep], cols[keep], vals[keep]

    with phase("kernels against their plain version"):
        shapes = [(100, 100, 500), (257, 130, 800), (512, 512, 4000),
                  (64, 300, 600), (1000, 1000, 9000), (3000, 3000, 60000)]
        for n_rows, n_cols, nnz in shapes:
            rng = np.random.default_rng(nnz)
            rows, cols, vals = coo(rng, n_rows, n_cols, nnz)
            for bm in (8, 16, 32, 64):
                bsr = build_bsr(rows, cols, vals, n_rows, n_cols, bm=bm,
                                bn=bm)
                for nv in (1, 2, 4, 8):
                    x = rng.standard_normal((n_cols, nv)).astype(np.float32)
                    against_plain(*operands(bsr, x), bsr.counts, 1e-5,
                                  f"{n_rows}x{n_cols} nnz={nnz} bm={bm} "
                                  f"nv={nv}")
        # the generic path's shapes: bm = 6 (bn % 4 != 0), bm = 128, bm != bn
        for n_rows, n_cols, nnz, bm, bn, nv in [
                (90, 90, 400, 6, 6, 5), (512, 512, 4000, 128, 128, 8),
                (257, 130, 800, 64, 32, 4), (64, 300, 600, 16, 64, 2),
                (300, 300, 2000, 8, 8, 3)]:
            rng = np.random.default_rng(nnz)
            bsr = build_bsr(*coo(rng, n_rows, n_cols, nnz), n_rows, n_cols,
                            bm=bm, bn=bn)
            x = rng.standard_normal((n_cols, nv)).astype(np.float32)
            against_plain(*operands(bsr, x), bsr.counts, 1e-5,
                          f"{n_rows}x{n_cols} bm={bm} bn={bn} nv={nv}")
        # K = 1: one diagonal block per block-row
        bsr = build_bsr(np.arange(512), np.arange(512),
                        np.random.default_rng(1).standard_normal(512), 512,
                        512, bm=8, bn=8)
        check(bsr.K == 1, "diagonal layout has K = 1")
        against_plain(*operands(bsr, np.ones((512, 1), np.float32)),
                      bsr.counts, 1e-5, "K = 1")
        rng = np.random.default_rng(0)
        bsr = build_bsr(*coo(rng, 128, 128, 700), 128, 128, bm=32, bn=32)
        for nv in (1, 2, 8):
            blocks, blk_cols, x16 = operands(
                bsr, rng.standard_normal((128, nv)).astype(np.float16))
            against_plain(blocks, blk_cols, x16, bsr.counts, 2e-2,
                          f"f16 x nv={nv}")
        bsr = build_bsr(np.array([0, 1, 300]), np.array([5, 200, 10]),
                        np.array([1.0, 2.0, 3.0]), 4000, 256, bm=64, bn=64)
        check(int((bsr.counts == 0).sum()) == bsr.nbr - 2,
              f"{bsr.nbr - 2} of {bsr.nbr} block-rows hold no real slot")
        against_plain(*operands(bsr, np.ones((256, 1), np.float32)),
                      bsr.counts, 0.0, "fully empty block-rows")
        # deep K (test_kernels_spmv.py:88-126): the compensated lane beats
        # the f32 lane against the f64 plain lane
        rng = np.random.default_rng(42)
        nbc, bm = 128, 8
        rows = np.repeat(np.arange(bm), nbc)
        cols = np.tile(np.arange(nbc), bm) * bm + rng.integers(0, bm,
                                                                nbc * bm)
        vals = rng.standard_normal(nbc * bm) * 10.0 ** rng.integers(
            -3, 3, nbc * bm)
        bsr = build_bsr(rows, cols, vals, bm, nbc * bm, bm=bm, bn=bm)
        blocks, blk_cols, xp = operands(
            bsr, rng.standard_normal((nbc * bm, 2)).astype(np.float32))
        count = torch.as_tensor(bsr.counts, device=cuda)
        ref64 = bsr_spmv_ref(blocks, blk_cols, xp.double(), accum="f64")
        err32 = float((bsr_spmv(blocks, blk_cols, xp, blk_count=count)
                       .double() - ref64).abs().max())
        errk = float((bsr_spmv(blocks, blk_cols, xp, accum="kahan",
                               blk_count=count).double()
                      - ref64).abs().max())
        check(errk <= err32 and errk < 0.5 * err32,
              f"deep K: kahan err {errk:.3g} < 0.5 x f32 err {err32:.3g}")
        # the zero-product steps past the count move a Kahan sum: the
        # kernel replays them, reading nothing
        blocks, blk_cols, x1, counts = (
            torch.as_tensor(a, device=cuda) for a in kahan_replay_layout())
        y = bsr_spmv(blocks, blk_cols, x1, accum="kahan", blk_count=counts)
        full = bsr_spmv_ref(blocks, blk_cols, x1, accum="kahan")
        real = int(counts[0])
        stop = bsr_spmv_ref(blocks[:, :real].contiguous(),
                            blk_cols[:, :real].contiguous(), x1,
                            accum="kahan")
        moved = stop != full
        rel = float((y - full).abs().max() / full.abs().max())
        check(bool(moved.any()) and torch.equal(y[moved], full[moved])
              and rel <= 1e-6,
              f"kahan replay: {int(moved.sum())} sums that stopping at the "
              f"count would change match the plain lane over all K "
              f"exactly; max rel err {rel:.3g} <= 1e-6")
        print(f"  cases per path: {paths}")
        csr_err = csr_against_plain(cuda)

    with phase("flash attention against its plain version"):
        flash_err = flash_against_plain(cuda)

    with phase("flash attention at MLA's head dims and with a prefix, "
               "against its plain version"):
        mp_err = mla_prefix_against_plain(cuda)

    with phase("flash attention backward against its plain version"):
        bwd_err = flash_bwd_against_plain(cuda)
        print(f"  card: {smi}")
        bwd_rows = flash_bwd_timing(cuda, args.seed, smi)
        attention_dispatch_cost(cuda, smi)

    with phase("RG-LRU backward against its plain version; the backward "
               "kernels timed at RecurrentGemma-2B's training shapes"):
        lru_bwd_err = rglru_bwd_against_plain(cuda)
        print(f"  card: {smi}")
        lru_bwd_rows = rglru_bwd_timing(cuda, args.seed, smi)
        rg_flash_bwd = flash_bwd_window_timing(cuda, args.seed, smi)

    with phase("SSD backward against its plain version; the backward "
               "kernel timed at Mamba2-2.7B's training shape"):
        ssd_bwd_err = ssd_bwd_against_plain(cuda)
        print(f"  card: {smi}")
        ssd_bwd_row = ssd_bwd_timing(cuda, args.seed, smi)

    with phase("Stanford-Web graph and f64 oracles (host)"):
        t0 = time.perf_counter()
        op = STANFORD.build()
        print(f"  graph: n={op.n} nnz={op.pt.nnz} "
              f"dangling={int(op.pt.dangling.sum())} "
              f"({time.perf_counter() - t0:.2f} s host)")
        check(op.n == 281_903 and op.pt.nnz == 2_312_497
              and int(op.pt.dangling.sum()) == 172,
              "Stanford-Web replica at the paper's size")
        t0 = time.perf_counter()
        exact = exact_pagerank(op, tol=1e-12)
        rng = np.random.default_rng(0)
        seeds = [rng.choice(op.n, size=4, replace=False) for _ in range(8)]
        v8 = seed_stack(op.n, seeds)
        op8 = GoogleOperator(pt=op.pt, alpha=op.alpha, v=v8)
        pt_sp = op.to_scipy_pt()
        exact8 = np.full((op.n, 8), 1.0 / op.n)
        for _ in range(10_000):
            y = op8.apply_numpy(exact8, pt_sp)
            if np.abs(y - exact8).sum(axis=0).max() < 1e-12:
                break
            exact8 = y
        exact8 = y / y.sum(axis=0)
        print(f"  f64 scipy oracles: {time.perf_counter() - t0:.2f} s host")

    with phase("hub-split block-CSR packing (host)"):
        for bm in (8, 16, 32, 64, 128):
            t0 = time.perf_counter()
            try:
                h = op.hybrid_bsr(bm=bm, bn=bm)
            except MemoryError as e:
                check(bm == 128, f"bm={bm}: refused ({e})")
                continue
            b = h.bsr
            t_pack = time.perf_counter() - t0
            t0 = time.perf_counter()
            real = int(b.counts.sum())
            t_count = time.perf_counter() - t0
            blk_bytes = b.bm * b.bn * 4
            print(f"  bm={bm}: nbr={b.nbr} K={b.K} real slots {real:,} of "
                  f"{b.nbr * b.K:,} ({real / (b.nbr * b.K):.3f}): blocks "
                  f"{real * blk_bytes / 1e9:.3f} GB real, "
                  f"{b.blocks.nbytes / 1e9:.3f} GB layout; fill="
                  f"{b.fill_ratio:.4f} hub nnz={h.hub_rows.size} "
                  f"({h.hub_nnz_frac:.4f}) ({t_pack:.2f} s packing, "
                  f"{t_count:.2f} s slot_counts)")

    with phase("main path: Stanford-Web static solve"):
        for counts in (LAUNCHES, CSR_LAUNCHES):
            for k in counts:
                counts[k] = 0
        solves = {}
        t_main = time.perf_counter()
        for name, fn, kw in [
                ("power bsr", solve_power, dict(backend="bsr", tol=1e-6)),
                ("linear bsr", solve_linear, dict(backend="bsr", tol=1e-6)),
                ("power segment_sum f64", solve_power,
                 dict(backend="segment_sum", dtype=torch.float64,
                      tol=1e-10)),
                ("power bsr nv=8", solve_power,
                 dict(backend="bsr", tol=1e-6, v=v8))]:
            t0 = time.perf_counter()
            solves[name] = fn(op, **kw)
            torch.cuda.synchronize()
            r = solves[name]
            print(f"  {name}: iters={r.iters} resid={r.resid_l1:.3g} "
                  f"lane_iters={r.lane_iters.tolist()} "
                  f"({time.perf_counter() - t0:.2f} s, upload included "
                  f"on first bsr use)")
        spec = as_spec("bsr", cuda)
        dev, meta, x0 = prepare(op, spec, torch.float32)
        y_kahan = hybrid_matvec(dev, x0, accum="kahan")
        torch.cuda.synchronize()
        main_launches = dict(LAUNCHES)
        main_csr = dict(CSR_LAUNCHES)
        print(f"  main path: {time.perf_counter() - t_main:.2f} s, "
              f"launches {main_launches}, CSR kernel {main_csr}")
        bsr_applies = sum(solves[k].iters for k in
                          ("power bsr", "linear bsr", "power bsr nv=8"))
        check(main_csr == {"f32": 0,
                           "f64": solves["power segment_sum f64"].iters,
                           "hub": bsr_applies + 1},
              f"f64 CSR kernel launched once per segment_sum apply "
              f"({solves['power segment_sum f64'].iters}), its hub lane "
              f"once per BSR apply and the kahan apply ({bsr_applies + 1})")
        check(main_launches["f32"] == bsr_applies,
              f"f32 kernel launched once per BSR apply ({bsr_applies})")
        check(main_launches["kahan"] == 1, "kahan kernel launched once")
        for name in ("power bsr", "linear bsr"):
            x = solves[name].x
            l1 = float(np.abs(x - exact).sum())
            tau = kendall_tau_topk(x, exact, k=100)
            check(l1 <= 1e-5 and tau >= 0.999,
                  f"{name}: L1 err {l1:.3g} <= 1e-5, top-100 tau "
                  f"{tau:.6f} >= 0.999")
        err = float(np.abs(solves["power segment_sum f64"].x - exact).max())
        check(err <= 1e-10, f"segment_sum f64: max abs err {err:.3g}")
        x8 = solves["power bsr nv=8"].x
        l1 = np.abs(x8 - exact8).sum(axis=0)
        taus = [kendall_tau_topk(x8[:, j], exact8[:, j], k=100)
                for j in range(8)]
        check(l1.max() <= 1e-5 and min(taus) >= 0.999,
              f"nv=8 lanes: max L1 err {l1.max():.3g}, min top-100 tau "
              f"{min(taus):.6f}")
        y_f32 = hybrid_matvec(dev, x0, impl="ref", accum="f32")
        kerr = float((y_kahan - y_f32).abs().max())
        check(kerr <= 1e-5 * float(y_f32.abs().max()),
              f"kahan apply against the plain f32 apply: {kerr:.3g}")

    rows_out = {}
    with phase("timing at Stanford-Web scale"):
        print(f"  card: {smi}")
        for bm in TIMED_BM:
            spec = as_spec(BackendSpec(name="bsr", bm=bm), cuda)
            for nv in TIMED_NV:
                dev, meta, x = prepare(op, spec, torch.float32,
                                       v=None if nv == 1 else v8)
                check(x.shape[2] == nv, f"bm={bm}: {nv} lanes")
                blocks, blk_cols = dev["blocks"], dev["blk_cols"]
                count = dev["blk_count"]
                path = kernel_path(blocks, x)
                errs = {}
                for accum in ("f32", "kahan"):
                    y = bsr_spmv(blocks, blk_cols, x, accum=accum,
                                 blk_count=count)
                    y_ref = bsr_spmv_ref(blocks, blk_cols, x, accum=accum)
                    errs[accum] = float((y - y_ref).abs().max())
                    check(errs[accum] <= 1e-5 * float(y_ref.abs().max()),
                          f"bm={bm} nv={nv} accum={accum} ({path}): kernel "
                          f"against plain {errs[accum]:.3g}")
                y_plain = bsr_spmv_ref(blocks, blk_cols, x)
                libs = {"library_layout": library_bsr_call(blocks, blk_cols,
                                                           x),
                        "library_real": library_bsr_call(blocks, blk_cols, x,
                                                         count)}
                lib_err = max(float((f().reshape(y.shape) - y_plain).abs()
                                    .max()) for f in libs.values())
                t = {
                    "f32": cuda_ms(lambda: bsr_spmv(blocks, blk_cols, x,
                                                    blk_count=count), 20),
                    "f32_all_k": cuda_ms(lambda: bsr_spmv(blocks, blk_cols,
                                                          x), 20),
                    "kahan": cuda_ms(lambda: bsr_spmv(
                        blocks, blk_cols, x, accum="kahan", blk_count=count),
                        20),
                    "plain_f32": cuda_ms(lambda: bsr_spmv_ref(
                        blocks, blk_cols, x), 5),
                    "plain_kahan": cuda_ms(lambda: bsr_spmv_ref(
                        blocks, blk_cols, x, accum="kahan"), 3),
                    **{k: cuda_ms(f, 20) for k, f in libs.items()},
                    "apply": cuda_ms(lambda: google_apply(meta, dev, x,
                                                          False), 20),
                }
                t["library"] = min(t["library_layout"], t["library_real"])
                b_ms, b_by, real_bytes, layout_bytes = bound(blocks, count,
                                                             x, y)
                print(f"  bm={bm} nv={nv} nbr={blocks.shape[0]} "
                      f"K={blocks.shape[1]} ({path}): real bytes "
                      f"{real_bytes / 1e9:.4f} GB, layout bytes "
                      f"{layout_bytes / 1e9:.4f} GB; kernel f32 "
                      f"{t['f32']:.4f} ms (all K {t['f32_all_k']:.4f}), "
                      f"kahan {t['kahan']:.4f} ms, plain f32 "
                      f"{t['plain_f32']:.4f} ms, plain kahan "
                      f"{t['plain_kahan']:.4f} ms, sparse-BSR call "
                      f"{t['library_layout']:.4f} ms (layout) / "
                      f"{t['library_real']:.4f} ms (real slots) "
                      f"(|diff| {lib_err:.3g}), google_apply "
                      f"{t['apply']:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
                      f"layout {layout_bytes / H100.hbm_bw * 1e3:.4f} "
                      f"ms): kernel at {100 * b_ms / t['f32']:.1f}% "
                      f"(kahan {100 * b_ms / t['kahan']:.1f}%) of bound "
                      f"[{smi}]")
                rows_out[(bm, nv)] = (t, b_ms, b_by, errs)
                del dev, blocks, blk_cols, count, x, libs
            if bm != DEFAULT_BM:    # keep the main path's layout
                op._cache().pop(("bsr_dev", bm, spec.hub_quantile, cuda))
            free_cuda()
        fastest = min(TIMED_BM, key=lambda b: rows_out[(b, 1)][0]["apply"])
        print(f"  fastest warm google_apply at nv=1: bm={fastest} "
              f"({rows_out[(fastest, 1)][0]['apply']:.4f} ms); the CUDA "
              f"default is bm={DEFAULT_BM} "
              f"({rows_out[(DEFAULT_BM, 1)][0]['apply']:.4f} ms) [{smi}]")
        for name, fn in (("power bsr", solve_power),
                         ("linear bsr", solve_linear)):
            t0 = time.perf_counter()
            r = fn(op, backend="bsr", tol=1e-6)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"  warm {name}: {dt * 1e3:.2f} ms for {r.iters} applies "
                  f"({dt * 1e3 / r.iters:.4f} ms/iter) at bm={DEFAULT_BM} "
                  f"[{smi}]")
        # where a static solve's time goes: the float64 segment-sum solve
        # (one CSR kernel launch an apply) and the bsr power solve
        device_breakdown(lambda: solve_power(
            op, backend="segment_sum", dtype=torch.float64, tol=1e-10),
            "static power segment_sum f64 solve", smi)
        device_breakdown(lambda: solve_power(op, backend="bsr", tol=1e-6),
                         "static power bsr solve", smi)

    with phase(f"main path: Stanford-Web SPMD (p = {SPMD_P} shards on one "
               f"card)"):
        print(f"  card: {smi}")
        spmd_runs, spmd_launches = spmd_main_path(op, exact, exact8, v8, smi)

    with phase("timing: CSR segment-sum kernel and the folded block launch"):
        print(f"  card: {smi}")
        hub_dev, _, _ = prepare(op, as_spec("bsr", cuda), torch.float32)
        csr_rows = csr_timing(op, cuda, smi, hub_dev)
        del hub_dev
        folded = folded_timing(op, cuda, smi)
        spmd_tol_sweep(op, exact, exact8, v8, spmd_runs["tol"],
                       spmd_runs["lanes"][0].x, smi)
        device_breakdown(lambda: solve_spmd(op, SPMDConfig(
            p=SPMD_P, backend="bsr", tol=spmd_runs["tol"])),
            f"solve_spmd bsr allgather p={SPMD_P} "
            f"({spmd_runs['allgather'][0].supersteps} supersteps)", smi)

    with phase("main path: Stanford-Web DES (paper Tables 1-2)"):
        des_launches, _ = des_main_path(op, exact, smi)

    with phase(f"main path: Stanford-Web device transport (p = "
               f"{TRANSPORT_P})"):
        drain_launches, _ = transport_main_path(op, smi)

    # the crawl's graph (source rows) back from P^T, for the stream
    g = CSRGraph.from_edges(op.n, op.pt.src, op.pt.row_ids)
    del op, op8, y_kahan, y_f32    # the Stanford-Web layouts on the card
    free_cuda()

    with phase("main path: Stanford-Web streaming"):
        print(f"  card: {smi}")
        stream_launches, dg, ppr_sets, stream_cold, stream_trace = \
            streaming_main_path(g, smi)

    with phase("timing: the block and CSR kernels at 16 lanes"):
        nv16 = nv16_timing(dg, ppr_sets, cuda, smi)
        del dg
        free_cuda()

    with phase("main path: Stanford-Web asynchronous shard workers and "
               "query tier"):
        print(f"  card: {smi}")
        async_launches = async_main_path(g, stream_cold, stream_trace, smi)
        del g, stream_cold, stream_trace
        free_cuda()

    with phase("main path: Yi-6B inference"):
        flash_launches = yi_main_path(cuda, args.seed)

    with phase("timing: Yi-6B"):
        print(f"  card: {smi}")
        flash_rows = yi_timing(cuda, args.seed, smi)

    with phase("main path: asynchronous training in the DES (paper §4 on "
               "SGD)"):
        async_dp_main_path(smi)

    with phase("main path: Qwen2-MoE-A2.7B"):
        moe_launches, moe_model = moe_main_path(cuda, args.seed, smi)

    with phase("timing: Qwen2-MoE-A2.7B"):
        moe_times = moe_timing(cuda, moe_model, args.seed, smi)
        moe_cfg = moe_model.cfg
        del moe_model
        free_cuda()

    with phase("analysis"):
        analysis_phase(moe_cfg, moe_times, smi)

    recur = {}
    for arch in RECUR_ARCHS:
        with phase(f"main path: {arch}"):
            err = scans_against_plain(arch, cuda, args.seed)
            launches, held_err, model = recurrent_main_path(
                arch, cuda, args.seed, smi)
            recur[arch] = dict(err=dict(scan=max(err["scan"], held_err),
                                        step=err["step"]),
                               launches=launches, model=model)

    with phase("timing: Mamba2-2.7B and RecurrentGemma-2B"):
        recur_rows = recurrent_kernel_timing(cuda, args.seed, smi)
        # DRY_DECODE_ARCH last: its step is read for the dry run with the
        # other model freed
        for arch in sorted(recur, key=lambda a: a == DRY_DECODE_ARCH):
            model = recur[arch].pop("model")
            times = recurrent_model_timing(cuda, model, args.seed, smi)
            recurrent_roofline(model.cfg, times, smi)
            del model
            free_cuda()

    with phase(f"main path: {MLA_ARCH} ({MLA_LAYERS} of 61 layers)"):
        mla_launches, model, _ = mla_main_path(cuda, args.seed, smi)

    with phase(f"timing: {MLA_ARCH} ({MLA_LAYERS} of 61 layers)"):
        mla_row = mla_timing(cuda, model, args.seed, smi)
        del model
        free_cuda()

    with phase(f"main path: {VLM_ARCH}"):
        vlm_launches, model = vlm_main_path(cuda, args.seed, smi)

    with phase(f"timing: {VLM_ARCH}"):
        vlm_row = vlm_timing(cuda, model, args.seed, smi)
        del model
        free_cuda()

    with phase(f"main path: {WHISPER_ARCH}"):
        whisper_launches, _ = whisper_main_path(cuda, args.seed, smi)

    with phase(f"main path: training {TRAIN_ARCH}"):
        train_launches, _ = train_main_path(cuda, args.seed, smi)

    with phase(f"main path: training {WHISPER_ARCH}"):
        wtrain_launches = whisper_train_main_path(cuda, args.seed, smi)

    with phase(f"main path: training {RECUR_TRAIN_ARCH}"):
        rtrain_lru, rtrain_flash, _ = recurrent_train_main_path(
            cuda, args.seed, smi)

    with phase(f"main path: training {SSD_TRAIN_ARCH}"):
        mtrain_ssd, _ = mamba2_train_main_path(cuda, args.seed, smi)

    with phase("dry run: every (arch x shape) cell on the meta device"):
        dry_run_table(smi)
    lm_launches = {k: whisper_launches[k] + train_launches[k]
                   + wtrain_launches[k] + rtrain_flash[k]
                   for k in whisper_launches}

    t, b_ms, b_by, errs = rows_out[(DEFAULT_BM, 1)]
    kernels = []
    for accum in ("f32", "kahan"):
        kernels.append({
            "name": f"bsr_spmv_{accum}", "route": "cuda",
            "source": BSR_SOURCE, "replaces": TPU_KERNEL[accum],
            "launches": main_launches[accum] + (
                spmd_launches["bsr_f32"] if accum == "f32" else 0)
            + drain_launches[f"bsr_{accum}"]
            + stream_launches[f"bsr_{accum}"]
            + async_launches[f"bsr_{accum}"],
            "max_abs_err": max(max_err[accum], errs[accum], *(
                f[3] for f in folded.values() if accum == "f32"), *(
                nv16[("bsr", nv)]["err"] for nv in (16, 8)
                if accum == "f32")),
            "ms": t[accum], "plain_ms": t[f"plain_{accum}"], "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": t["library"] if accum == "f32" else None})
    for lane, launches in (("f32", spmd_launches["csr_f32"]
                            + stream_launches["csr_f32"]
                            + async_launches["csr_f32"]),
                           ("f64", main_csr["f64"] + des_launches
                            + drain_launches["csr_f64"]
                            + stream_launches["csr_f64"]
                            + async_launches["csr_f64"])):
        row = csr_rows[(lane, 1)]
        kernels.append({
            "name": f"csr_spmv_{lane}", "route": "cuda", "source": CSR_SOURCE,
            "replaces": TPU_KERNEL["csr"], "launches": launches,
            "max_abs_err": max(csr_err[lane], row["err"],
                               nv16[(lane, 16)]["err"]),
            "ms": row["kernel"], "plain_ms": row["plain"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library"]})
    row = csr_rows[("hub", 1)]
    kernels.append({
        "name": "csr_spmv_hub", "route": "cuda", "source": CSR_SOURCE,
        "replaces": TPU_KERNEL["hub"],
        "launches": main_csr["hub"] + spmd_launches["csr_hub"]
        + drain_launches["csr_hub"] + stream_launches["csr_hub"]
        + async_launches["csr_hub"],
        "max_abs_err": max(csr_err["hub"], row["err"]), "ms": row["kernel"],
        "plain_ms": row["plain"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None})
    for lane, name in (("wgmma", "flash_attention"),
                       ("f32", "flash_attention_f32")):
        row = flash_rows[lane]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE[lane],
            "replaces": TPU_KERNEL["flash"],
            "launches": flash_launches[lane] + moe_launches[lane] + sum(
                r["launches"]["flash" if lane == "wgmma" else "flash_f32"]
                for r in recur.values()) + mla_launches[lane]
            + vlm_launches[lane] + lm_launches[lane],
            "max_abs_err": max(flash_err[lane], row["err"],
                               mp_err["f32"] if lane == "f32" else 0.0),
            "ms": row["kernel"], "plain_ms": row["plain"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["sdpa"]})
    # head dim 256 on the tensor-core lane, at RecurrentGemma-2B's local
    # attention with its window of 2048
    row = recur_rows["flash_window"]
    kernels.append({
        "name": "flash_attention_d256", "route": "cuda",
        "source": FLASH_SOURCE["wgmma"], "replaces": TPU_KERNEL["flash"],
        "launches": recur["recurrentgemma-2b"]["launches"]["flash"]
        + rtrain_flash["wgmma"],
        "max_abs_err": max(flash_err["d256"], row["err"],
                           recur_rows["flash_d256"]["err"]),
        "ms": row["kernel"], "plain_ms": row["plain"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["sdpa"]})
    # the tensor-core lane at DeepSeek-V3's MLA prefill, (Dk, Dv) =
    # (192, 128), and at PaliGemma-3B's, D = 256 with the prefix-LM mask
    for name, row, launches, err in (
            ("flash_attention_mla", mla_row, mla_launches["wgmma"],
             mp_err["mla"]),
            ("flash_attention_prefix", vlm_row, vlm_launches["wgmma"],
             mp_err["prefix"])):
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE["wgmma"],
            "replaces": TPU_KERNEL["flash"], "launches": launches,
            "max_abs_err": max(err, row["err"]), "ms": row["kernel"],
            "plain_ms": row["plain"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["sdpa"]})
    # the backward's lanes at SmolLM-360M's training shape (the tensor
    # cores in bf16, the CUDA cores in float32); their calls over the
    # Whisper and training main paths (the CUDA-core lane's: the float32
    # train step)
    for lane, name, launches in (
            ("wgmma", "flash_attention_bwd_wgmma",
             lm_launches["bwd_wgmma"] - rtrain_flash["bwd_wgmma"]),
            ("f32", "flash_attention_bwd",
             lm_launches["bwd"] - lm_launches["bwd_wgmma"])):
        row = bwd_rows[(lane, "SmolLM-360M")]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_BWD_SOURCE[lane],
            "replaces": FLASH_BWD_REPLACES, "launches": launches,
            "max_abs_err": max(bwd_err[lane], *(
                r["err"] for (ln, _), r in bwd_rows.items() if ln == lane)),
            "ms": row["kernel"], "plain_ms": row["plain"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["sdpa_bwd"]})
    # the tensor-core lane at (256, 256), RecurrentGemma-2B's local
    # attention in training (bf16, window 2048); its bf16 calls there (the
    # float32 cut step's call is the CUDA-core lane's, counted above)
    kernels.append({
        "name": "flash_attention_bwd_d256", "route": "cuda",
        "source": FLASH_BWD_SOURCE["wgmma"], "replaces": FLASH_BWD_REPLACES,
        "launches": rtrain_flash["bwd_wgmma"],
        "max_abs_err": max(bwd_err["d256"], rg_flash_bwd["err"]),
        "ms": rg_flash_bwd["kernel"], "plain_ms": rg_flash_bwd["plain"],
        "bound_ms": rg_flash_bwd["bound_ms"],
        "bound_by": rg_flash_bwd["bound_by"],
        "library_ms": rg_flash_bwd["sdpa_bwd"]})
    row = lru_bwd_rows[RGLRU_BWD_TIMED[0]]
    kernels.append({
        "name": "rglru_scan_bwd", "route": "cuda", "source": RGLRU_SOURCE,
        "replaces": RGLRU_BWD_REPLACES, "launches": rtrain_lru["bwd"],
        "max_abs_err": max(lru_bwd_err, *(r["err"]
                                          for r in lru_bwd_rows.values())),
        "ms": row["kernel"], "plain_ms": row["plain"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None})
    kernels.append({
        "name": "ssd_scan_bwd", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_BWD_REPLACES, "launches": mtrain_ssd["bwd"],
        "max_abs_err": max(ssd_bwd_err, ssd_bwd_row["err"]),
        "ms": ssd_bwd_row["kernel"], "plain_ms": ssd_bwd_row["plain"],
        "bound_ms": ssd_bwd_row["bound_ms"],
        "bound_by": ssd_bwd_row["bound_by"], "library_ms": None})
    for name, key, source, arch in (
            ("ssd_scan", "ssd", SSD_SOURCE, "mamba2-2.7b"),
            ("ssd_scan_step", "ssd_step", SSD_SOURCE, "mamba2-2.7b"),
            ("rglru_scan", "rglru", RGLRU_SOURCE, "recurrentgemma-2b"),
            ("rglru_scan_step", "rglru_step", RGLRU_SOURCE,
             "recurrentgemma-2b")):
        row = recur_rows[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": TPU_KERNEL[key],
            "launches": recur[arch]["launches"][key]
            + (rtrain_lru["scan"] if key == "rglru" else 0)
            + (mtrain_ssd["scan"] if key == "ssd" else 0),
            "max_abs_err": max(
                recur[arch]["err"]["step" if "step" in key else "scan"],
                row["err"]),
            "ms": row["kernel"], "plain_ms": row["plain"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, **row.get("bounds", {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
