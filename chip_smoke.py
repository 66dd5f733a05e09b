#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines and seconds:
  1. card   : the device's name and its nvidia-smi name and power limit;
  2. build  : nvcc builds every kernel from the sources in the checkout;
  3. kernels: the block-CSR SpMV against its plain PyTorch version, with
              and without the per-row count of real slots;
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
              it;
  8. timing : one apply timed with CUDA events at bm in {8, 16, 32, 64}
              and nv in {1, 8}: kernel (real slots, and all K), plain
              version, two PyTorch sparse-BSR calls (padded layout, real
              slots only), google_apply, and the bound over the real
              slots beside the layout's;
  9. main   : Yi-6B inference at full width (random weights from --seed,
              bf16): the prefill forward through the tensor-core flash
              kernel against its plain version, ServeEngine prefill against
              the forward (bf16, then a float32 copy whose forward takes the
              CUDA-core lane), and greedy and sampled generation, with the
              launch counts of both lanes read around it;
 10. timing : each flash lane, its plain version, PyTorch's
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
BSR_SOURCE = "src/repro_torch/kernels/bsr_spmv/csrc/bsr_spmv.cu"
FLASH_SOURCE = {
    "wgmma": "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_wgmma.cu",
    "f32": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"}
# block edges and lane counts timed at Stanford-Web scale
TIMED_BM = (8, 16, 32, 64)
TIMED_NV = (1, 8)
TPU_KERNEL = {"f32": "src/repro/kernels/bsr_spmv/bsr_spmv.py:36",
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
    from CUDA events."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    than an unprofiled one."""
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
    from repro_torch.graph.google import GoogleOperator, exact_pagerank
    from repro_torch.kernels import build
    from repro_torch.kernels.bsr_spmv import (DEFAULT_BM, LAUNCHES,
                                              bsr_spmv, bsr_spmv_ref,
                                              build_bsr, hybrid_matvec,
                                              kernel_path, pad_x)

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
        for k in LAUNCHES:
            LAUNCHES[k] = 0
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
        print(f"  main path: {time.perf_counter() - t_main:.2f} s, "
              f"launches {main_launches}")
        bsr_applies = sum(solves[k].iters for k in
                          ("power bsr", "linear bsr", "power bsr nv=8"))
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

    del op, op8, y_kahan, y_f32    # the Stanford-Web layouts on the card
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
            "launches": main_launches[accum],
            "max_abs_err": max(max_err[accum], errs[accum]),
            "ms": t[accum], "plain_ms": t[f"plain_{accum}"], "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": t["library"] if accum == "f32" else None})
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
