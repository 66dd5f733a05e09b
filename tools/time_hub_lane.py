"""Time the CSR kernel's lanes and the block backend's Google-operator
apply on the Stanford-Web replica (281,903 pages), on the CUDA card, by
chip_smoke.py's own method (`chip_smoke.cuda_ms`), for a checkout of the
port given by its src/ directory.

    python tools/time_hub_lane.py [--src DIR]

repro_torch is imported from DIR (default: this checkout's src/), so the
same script times another checkout, for example a parent commit unpacked
with `git archive` into a directory that .gitignore lists; its kernels
build into that checkout's build/. Run it for two checkouts in one call to
compare them on one card. At nv in {1, 8} it times the hub lane
(`csr_spmv_hub_add`) over the block layout's hub rows at bm = 8 (the
main path's `DEFAULT_BM`), the whole bsr `google_apply` at bm = 8 (the
block kernel, the hub lane and the elementwise terms), and the CSR
kernel's float32 and float64 lanes over all of P^T. Prints one JSON line:
by what, the milliseconds a call, each device kernel's profiled
milliseconds and launches a call (`chip_smoke.profiled_kernels`), the hub
lane's float32 ulps from its float64 plain version and whether two calls
gave the same bits; the hub side's rows and in-links; the card's name and
power limit from nvidia-smi.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke           # puts this checkout's src/ on the path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("time_hub_lane: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np
    import repro_torch
    from repro_torch.configs.pagerank import STANFORD
    from repro_torch.core.backend import (BackendSpec, as_spec,
                                          google_apply, prepare, seed_stack)
    from repro_torch.kernels.bsr_spmv import DEFAULT_BM
    from repro_torch.kernels.csr_spmv import (csr_spmv, csr_spmv_hub_add,
                                              csr_spmv_hub_add_ref)
    cuda = torch.device("cuda")
    op = STANFORD.build()
    rng = np.random.default_rng(0)
    v8 = seed_stack(op.n, [rng.choice(op.n, size=4, replace=False)
                           for _ in range(8)])
    spec = as_spec(BackendSpec(name="bsr", bm=DEFAULT_BM), cuda)
    out = {}
    for nv in (1, 8):
        dev, meta, x = prepare(op, spec, torch.float32,
                               v=None if nv == 1 else v8)
        xf = x.reshape(-1, nv)
        hub = (dev["hub_indptr"], dev["hub_cols"], dev["hub_vals"], xf,
               dev["hub_map"])
        y0 = torch.rand((xf.shape[0], nv), device=cuda)
        ulps, _, same, lanes, kept = chip_smoke.hub_lane_against_plain(
            *hub, y0)
        y = y0.clone()

        def lane():
            return csr_spmv_hub_add(*hub, y)

        def apply():
            return google_apply(meta, dev, x, False)
        out[f"hub_nv{nv}"] = {
            "ms": chip_smoke.cuda_ms(lane, 20),
            "plain_ms": chip_smoke.cuda_ms(
                lambda: csr_spmv_hub_add_ref(*hub, y), 20),
            "kernels": chip_smoke.profiled_kernels(lane),
            "ulps": ulps, "same_bits": same, "lanes": lanes, "kept": kept,
            "rows": int(dev["hub_map"].numel()),
            "in_links": int(dev["hub_cols"].numel())}
        out[f"apply_bm{DEFAULT_BM}_nv{nv}"] = {
            "ms": chip_smoke.cuda_ms(apply, 20),
            "kernels": chip_smoke.profiled_kernels(apply)}
        del dev, meta, x, xf, hub, y0, y
        torch.cuda.empty_cache()
    for dt, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        dev = op.pt.device_arrays(dt, cuda)
        for nv in (1, 8):
            xs = torch.rand((op.n, nv), device=cuda, dtype=dt)
            xs = xs[:, 0].contiguous() if nv == 1 else xs

            def call():
                return csr_spmv(dev["indptr"], dev["src"], dev["weight"],
                                xs, op.n)
            out[f"csr_{name}_nv{nv}"] = {
                "ms": chip_smoke.cuda_ms(call, 20),
                "kernels": chip_smoke.profiled_kernels(call)}
        del dev
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "src": os.path.dirname(os.path.abspath(repro_torch.__file__)),
        "times": out, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
