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
              2,048 edges, run to run and lane by lane;
  4. flash  : both flash-attention kernels (the tensor-core lane for bf16
              at head dim 64 or 128, the CUDA-core lane for the rest)
              against their plain version, and the CUDA-core lane's
              resident warps per SM, registers and spills;
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
              decode-step times.

It prints a JSON line describing every kernel, then, as its last line,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a machine without a CUDA device.
"""
import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside
# the tensor cores (the SpMV kernel uses full-f32 FMAs on the CUDA cores),
# and dense bf16 FLOP/s on the tensor cores (the attention bound)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_F64_FLOPS = 34e12      # float64 outside the tensor cores
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
# the paper's experiment in the DES (Tables 1-2): the configuration of
# benchmarks/paper_tables.py (des_cfg, :35-36) and the paper's values
# (PAPER_TABLE1, :19-27; Table 2's completed imports, :77), copied, since
# that module imports the JAX package
DES_PROCS = (2, 4, 6)
DES_CFG = dict(tol=1e-6, norm="l2", barrier_overhead=0.5, seed=7)
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
# batches of 2 edges; seed 4 here), its serving tol, the 1% batches' and
# the cold state's tol, the shards of the device drain, the batched
# queries (`benchmarks/query_bench.py`'s middle batch, 16) and the
# replay's clock, copied, since those modules import the JAX package
STREAM_TRACE = dict(n_batches=24, batch_edges=2, seed=4)
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
                       "flash_attention.py:27"}
# the Yi-6B runs: prompts of the main path, and the prefill shape timed
YI_BATCH, YI_PROMPT, YI_GEN = 4, 128, 32
YI_PREFILL = (1, 2048)
# flash against its plain version, max over rows of ||o - r|| / ||r||,
# about twice (bf16) and seven times (float32) the largest reading of the
# sound kernels, 4.6e-3 and 1.4e-6 (PERF.md §6)
ROW_REL_LIMIT = {"bfloat16": 1e-2, "float32": 1e-5}


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
    t_bytes, t_ops = real_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", real_bytes,
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
    its chunks of CSR_E edges; then its hub lane on the same cases. Returns
    the largest |kernel - plain| per lane ("f32", "f64", "hub")."""
    import numpy as np
    import torch
    from repro_torch.kernels.csr_spmv import csr_spmv, csr_spmv_ref
    worst = {"f32": 0.0, "f64": 0.0, "hub": 0.0}
    for n_rows, n_cols, deg, long_rows in CSR_CASES:
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
            check(ulps <= 1.0 and same and lanes and kept,
                  f"csr hub lane {n_rows}x{n_cols} nnz={len(src_np)} "
                  f"nv={nv}: {ulps:.3g} float32 ulps from the float64 plain "
                  f"sum (<= 1), two runs identical, each lane = its 1-wide "
                  f"call, other rows untouched")
    return worst


def csr_bound(dev, x, y, n_rows):
    """Least time (ms) for one CSR product: indptr, src, weights, x and y
    each moved once at the HBM rate, against 2 flops per edge and lane at
    the CUDA-core peak of x's type. Returns (ms, bound_by)."""
    import torch
    nv = 1 if x.ndim == 1 else x.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in
                 (dev["indptr"], dev["src"], dev["weight"], x, y))
    flops = 2.0 * dev["src"].numel() * nv
    peak = PEAK_F64_FLOPS if x.dtype == torch.float64 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
        # indptr, cols, vals and row_map once, the rows of x the hub rows
        # name once, y's hub rows read and written
        nbytes = (sum(a.numel() * a.element_size() for a in
                      (*args[:3], hub_dev["hub_map"]))
                  + n_src * nv * x.element_size()
                  + 2 * n_hub * nv * y.element_size())
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 2.0 * nnz_h * nv / PEAK_F64_FLOPS
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"  csr hub lane nv={nv} ({n_hub:,} rows, {nnz_h:,} in-links "
              f"from {n_src:,} distinct rows of x, "
              f"f32 in, f64 sum, into y in place): kernel {t['kernel']:.4f} "
              f"ms, plain CSR index_add_ {t['plain']:.4f} ms, the old COO "
              f"side (f64 index_select + index_add_ over the padded rows, "
              f"cast and add) {t['old_side']:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); wrapper host {t['host_us']:.2f} us a call; "
              f"{ulps:.3g} ulps [{smi}]")
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
    from repro_torch.core import (AsyncDES, AsyncFixedPoint, DESConfig,
                                  PageRankBlockOperator, kendall_tau_topk)
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR_LAUNCHES

    afp = AsyncFixedPoint(op, kind="power")
    print(f"  DESConfig({DES_CFG}), kind power, block partition [{smi}]")

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
        s = afp.solve_des_sync(p, DESConfig(**DES_CFG))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        n_sync = CSR_LAUNCHES["f64"] - before
        check(n_sync == s.iters * p,
              f"p={p} sync: the CSR kernel launched {n_sync} times = "
              f"{s.iters} iterations x {p} block updates")
        before = CSR_LAUNCHES["f64"]
        t0 = time.perf_counter()
        a = afp.solve_des(p, DESConfig(**DES_CFG))
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
    c = afp.solve_des(4, DESConfig(**DES_CFG), device="cpu")
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
    des = lambda: AsyncDES(opr, part, DESConfig(**DES_CFG)).run()
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
    from repro_torch.core import AsyncDES, DESConfig, block_rows
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
                 DESConfig(**DES_CFG)).run()
    wall_a = sync_ms(t0)
    des_launches = CSR_LAUNCHES["f64"] - before
    t0 = time.perf_counter()
    c = AsyncDES(StreamingBlockOperator(dg, part, device="cpu"), part,
                 DESConfig(**DES_CFG), device="cpu").run()
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


def attention_flops(q, k, causal):
    """The work of one attention call: 4 * D flops per allowed (query, key)
    pair and head (q k^T and p v). Causal is top-left: row i sees
    min(i + 1, T) keys."""
    import numpy as np
    B, H, S, D = q.shape
    T = k.shape[2]
    pairs = (int(np.minimum(np.arange(1, S + 1), T).sum()) if causal
             else S * T)
    return 4.0 * B * H * D * pairs


def attention_bound(q, k, v, causal):
    """Least time (ms) for one attention call on these operands: q, k, v
    read once and o written once at the HBM rate, against the work
    (`attention_flops`) at the peak for the operands' type: dense bf16 on
    the tensor cores, float32 on the CUDA cores."""
    import torch
    flops = attention_flops(q, k, causal)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    peak = PEAK_F32_FLOPS if q.dtype == torch.float32 else PEAK_BF16_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    groups = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    by_name = {}
    for e in kern:
        us = e.time_range.elapsed_us()
        name = e.name
        g = ("flash" if "flash_fwd" in name else
             "matmul" if any(w in name.lower() for w in
                             ("gemm", "nvjet", "cutlass", "xmma", "gemv"))
             else "other")
        groups[g] += us
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"  {label} (profiled): wall {wall:.2f} ms, {len(kern)} kernels, "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / 1e3 / wall:.1f}% "
          f"of wall); flash {groups['flash'] / 1e3:.2f} ms, matmul "
          f"{groups['matmul'] / 1e3:.2f} ms, other "
          f"{groups['other'] / 1e3:.2f} ms [{smi}]")
    for name, us in top:
        print(f"    {us / 1e3:8.3f} ms  {name}")
    return len(kern), busy / 1e3, wall


def free_cuda():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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


def flash_against_plain(cuda):
    """Both flash kernels against their plain version on the card; returns
    the largest |kernel - plain| seen per lane ("wgmma", "f32")."""
    import torch
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref,
                                                     kernel_info,
                                                     kernel_lane)
    f32, bf16 = torch.float32, torch.bfloat16
    # the CUDA-core lane as compiled: resident warps per SM and spills
    for D, dt in ((128, f32), (64, f32), (96, bf16), (32, bf16)):
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
    ]
    worst = {"wgmma": 0.0, "f32": 0.0}
    worst_rel = dict(worst)
    for B, H, Hkv, S, T, D, causal, dt, *offset in cases:
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
        o = flash_attention(q, k, v, causal=causal)
        r = flash_attention_ref(q, k, v, causal=causal)
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
              f"causal={causal} {str(dt)[6:]}{' unaligned' if offset else ''}"
              f": max |kernel - plain| = "
              f"{err:.3g} (rtol = atol = {tol:g}), max row |kernel - "
              f"plain| / |plain| = {rel:.3g} (<= {lim:g})")
        worst[lane] = max(worst[lane], err)
        worst_rel[lane] = max(worst_rel[lane], rel)
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
        b_ms, b_by = attention_bound(q, k, v, True)
        f32_share = ""
        if lane == "f32":  # the CUDA-core lane's FMAs against their peak
            rate = attention_flops(q, k, True) / (t["kernel"] * 1e-3)
            f32_share = f"{100 * rate / PEAK_F32_FLOPS:.1f}% of the f32 peak, "
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
                      f"layout {layout_bytes / PEAK_BYTES_PER_S * 1e3:.4f} "
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
            "replaces": TPU_KERNEL["flash"], "launches": flash_launches[lane],
            "max_abs_err": max(flash_err[lane], row["err"]),
            "ms": row["kernel"], "plain_ms": row["plain"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["sdpa"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
