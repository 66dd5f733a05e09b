#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:
  1. card   : the device's name and its nvidia-smi name and power limit;
  2. build  : nvcc builds every kernel from the sources in the checkout;
  3. kernels: each kernel against its plain PyTorch version on the card;
  4. graph  : the Stanford-Web replica (281,903 pages, 2,312,497 links)
              and its float64 scipy oracles, on the host;
  5. packing: its hub-split block-CSR layout at bm in {8, .., 128};
  6. main   : the static PageRank solve through the port's entry points,
              held against the oracles, with the launch counts read around
              it;
  7. timing : one apply timed with CUDA events at bm in {16, 32}: kernel,
              plain version, one PyTorch sparse-BSR call, and the bound.

It prints a JSON line describing every kernel, then, as its last line,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a machine without a CUDA device.
"""
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores (the kernel uses full-f32 FMAs on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
BSR_SOURCE = "src/repro_torch/kernels/bsr_spmv/csrc/bsr_spmv.cu"
TPU_KERNEL = {"f32": "src/repro/kernels/bsr_spmv/bsr_spmv.py:36",
              "kahan": "src/repro/kernels/bsr_spmv/bsr_spmv.py:50"}


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


def bound(blocks, blk_cols, x, y):
    """Least time (ms) for one block product on these operands: each input
    read once and the output written once at the HBM rate, against the
    f32 FMAs at the CUDA-core peak."""
    nbr, K, bm, bn = blocks.shape
    nbytes = sum(t.numel() * t.element_size()
                 for t in (blocks, blk_cols, x, y))
    flops = 2.0 * nbr * K * bm * bn * x.shape[2]
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_bsr_call(blocks, blk_cols, x):
    """One PyTorch call computing the same f32 product: the padded layout
    viewed as a sparse BSR tensor (each block-row holds K blocks, padded
    slots are zero blocks at column 0) times the dense iterate."""
    import torch
    nbr, K, bm, bn = blocks.shape
    nbc, _, nv = x.shape
    crow = torch.arange(0, nbr * K + 1, K, dtype=torch.int32,
                        device=blocks.device)
    a = torch.sparse_bsr_tensor(crow, blk_cols.reshape(-1),
                                blocks.reshape(nbr * K, bm, bn),
                                size=(nbr * bm, nbc * bn),
                                check_invariants=False)
    xf = x.reshape(nbc * bn, nv)
    return lambda: a @ xf


def main():
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
    from repro_torch.kernels.bsr_spmv import (LAUNCHES, bsr_spmv,
                                              bsr_spmv_ref, build_bsr,
                                              hybrid_matvec, pad_x)

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

    def against_plain(blocks, blk_cols, x, tol, what):
        for accum in ("f32", "kahan"):
            y = bsr_spmv(blocks, blk_cols, x, accum=accum)
            y_ref = bsr_spmv_ref(blocks, blk_cols, x, accum=accum)
            torch.cuda.synchronize()
            err = float((y - y_ref).abs().max()) if y.numel() else 0.0
            scale = float(y_ref.abs().max()) if y.numel() else 0.0
            check(err <= tol * (1.0 + scale),
                  f"{what} accum={accum}: max |kernel - plain| = {err:.3g}")
            max_err[accum] = max(max_err[accum], err)

    def operands(bsr, x):
        return (torch.as_tensor(bsr.blocks, device=cuda),
                torch.as_tensor(bsr.blk_cols, device=cuda),
                torch.as_tensor(pad_x(x, bsr.n_cols, bsr.bn), device=cuda))

    with phase("kernels against their plain version"):
        shapes = [(100, 100, 500), (257, 130, 800), (512, 512, 4000),
                  (64, 300, 600)]
        for n_rows, n_cols, nnz in shapes:
            rng = np.random.default_rng(nnz)
            rows = rng.integers(0, n_rows, nnz)
            cols = rng.integers(0, n_cols, nnz)
            vals = rng.standard_normal(nnz)
            _, keep = np.unique(rows * n_cols + cols, return_index=True)
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
            for bm in (8, 16, 32, 64):
                bsr = build_bsr(rows, cols, vals, n_rows, n_cols, bm=bm,
                                bn=bm)
                for nv in (1, 4, 8):
                    x = rng.standard_normal((n_cols, nv)).astype(np.float32)
                    against_plain(*operands(bsr, x), 1e-5,
                                  f"{n_rows}x{n_cols} nnz={nnz} bm={bm} "
                                  f"nv={nv}")
        rng = np.random.default_rng(0)
        rows, cols = rng.integers(0, 128, 700), rng.integers(0, 128, 700)
        _, keep = np.unique(rows * 128 + cols, return_index=True)
        bsr = build_bsr(rows[keep], cols[keep],
                        rng.standard_normal(700)[keep], 128, 128, bm=32,
                        bn=32)
        blocks, blk_cols, x16 = operands(
            bsr, rng.standard_normal((128, 2)).astype(np.float16))
        for accum in ("f32", "kahan"):
            err = float((bsr_spmv(blocks, blk_cols, x16, accum=accum)
                         - bsr_spmv_ref(blocks, blk_cols, x16,
                                        accum=accum)).abs().max())
            check(err <= 2e-2, f"f16 x accum={accum}: max err {err:.3g}")
        bsr = build_bsr(np.array([0, 1, 300]), np.array([5, 200, 10]),
                        np.array([1.0, 2.0, 3.0]), 400, 256, bm=64, bn=64)
        against_plain(*operands(bsr, np.ones((256, 1), np.float32)), 0.0,
                      "fully empty block-rows")
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
        ref64 = bsr_spmv_ref(blocks, blk_cols, xp.double(), accum="f64")
        err32 = float((bsr_spmv(blocks, blk_cols, xp).double()
                       - ref64).abs().max())
        errk = float((bsr_spmv(blocks, blk_cols, xp, accum="kahan").double()
                      - ref64).abs().max())
        check(errk <= err32 and errk < 0.5 * err32,
              f"deep K: kahan err {errk:.3g} < 0.5 x f32 err {err32:.3g}")

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
            print(f"  bm={bm}: nbr={b.nbr} K={b.K} blocks="
                  f"{b.blocks.nbytes / 1e9:.3f} GB fill={b.fill_ratio:.4f} "
                  f"hub nnz={h.hub_rows.size} ({h.hub_nnz_frac:.4f}) "
                  f"({time.perf_counter() - t0:.2f} s)")
            if bm not in (16, 32):      # keep only the layouts timed below
                op._cache().pop(("hybrid", bm, bm, 0.99))

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
        for bm in (16, 32):
            spec = as_spec(BackendSpec(name="bsr", bm=bm), cuda)
            for nv, v in ((1, None), (8, v8)):
                dev, meta, x = prepare(op, spec, torch.float32, v=v)
                blocks, blk_cols = dev["blocks"], dev["blk_cols"]
                errs = {}
                for accum in ("f32", "kahan"):
                    y = bsr_spmv(blocks, blk_cols, x, accum=accum)
                    y_ref = bsr_spmv_ref(blocks, blk_cols, x, accum=accum)
                    errs[accum] = float((y - y_ref).abs().max())
                    check(errs[accum] <= 1e-5 * float(y_ref.abs().max()),
                          f"bm={bm} nv={nv} accum={accum}: kernel against "
                          f"plain {errs[accum]:.3g}")
                lib = library_bsr_call(blocks, blk_cols, x)
                lib_err = float((lib().reshape(y.shape)
                                 - bsr_spmv_ref(blocks, blk_cols, x)
                                 ).abs().max())
                t = {
                    "f32": cuda_ms(lambda: bsr_spmv(blocks, blk_cols, x), 20),
                    "kahan": cuda_ms(lambda: bsr_spmv(blocks, blk_cols, x,
                                                      accum="kahan"), 20),
                    "plain_f32": cuda_ms(lambda: bsr_spmv_ref(
                        blocks, blk_cols, x), 5),
                    "plain_kahan": cuda_ms(lambda: bsr_spmv_ref(
                        blocks, blk_cols, x, accum="kahan"), 3),
                    "library": cuda_ms(lib, 20),
                    "apply": cuda_ms(lambda: google_apply(meta, dev, x,
                                                          False), 20),
                }
                b_ms, b_by = bound(blocks, blk_cols, x, y)
                print(f"  bm={bm} nv={nv} nbr={blocks.shape[0]} "
                      f"K={blocks.shape[1]} blocks="
                      f"{blocks.numel() * 4 / 1e9:.3f} GB: "
                      f"kernel f32 {t['f32']:.4f} ms, kahan "
                      f"{t['kahan']:.4f} ms, plain f32 "
                      f"{t['plain_f32']:.4f} ms, plain kahan "
                      f"{t['plain_kahan']:.4f} ms, "
                      f"sparse-BSR call {t['library']:.4f} ms "
                      f"(|diff| {lib_err:.3g}), google_apply "
                      f"{t['apply']:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
                      f" [{smi}]")
                rows_out[(bm, nv)] = (t, b_ms, b_by, errs)
                del dev, blocks, blk_cols, x
            if bm != 32:    # keep the main path's layout for warm solves
                op._cache().pop(("bsr_dev", bm, spec.hub_quantile, cuda))
        for name, fn in (("power bsr", solve_power),
                         ("linear bsr", solve_linear)):
            t0 = time.perf_counter()
            r = fn(op, backend="bsr", tol=1e-6)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"  warm {name}: {dt * 1e3:.2f} ms for {r.iters} applies "
                  f"({dt * 1e3 / r.iters:.4f} ms/iter) "
                  f"[{smi}]")

    t, b_ms, b_by, errs = rows_out[(32, 1)]
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
