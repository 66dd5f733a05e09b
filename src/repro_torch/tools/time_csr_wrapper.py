"""Time the host side of the CSR segment-sum kernel's wrapper, at the
Stanford-Web replica's P^T (281,903 rows, 2,312,497 edges) on the CUDA card.

    python src/repro_torch/tools/time_csr_wrapper.py [--src DIR]

repro_torch is imported from DIR (default: this checkout's src/), so the
same script times another checkout of the port, for example a parent
commit unpacked with `git archive` into a directory that .gitignore lists.
For float32 and float64 at nv in {1, 8}, `csr_spmv` is called 200 times
back to back after a warm-up, in 5 batches: the host's perf_counter around
a batch (the wrapper's checks, allocation and launch, while the card runs
behind) gives the host microseconds a call. The card's time a call is not
measured here: chip_smoke.py times it with the calls queued behind a sleep
on the card. The plain version (`csr_spmv_ref`: `index_select`, a product,
`new_zeros`, `index_add_`), the path the kernel replaced, is timed the same
way beside it. Host times on a shared machine spread widely, so the minimum
and the median over the batches are both printed. Prints one JSON line and
the card's name and power limit from nvidia-smi.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CALLS = 200
BATCHES = 5


def timed(torch, fn, args):
    """Host microseconds a call of fn(*args), the minimum and the median
    over the batches."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    host = []
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn(*args)
        host.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return {"host_us_per_call_min": min(host),
            "host_us_per_call_median": statistics.median(host)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("time_csr_wrapper: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.pagerank import STANFORD
    from repro_torch.kernels.csr_spmv import csr_spmv, csr_spmv_ref

    op = STANFORD.build()
    cuda = torch.device("cuda")
    out = {"src": os.path.abspath(args.src)}
    for dt, lane in ((torch.float32, "f32"), (torch.float64, "f64")):
        dev = op.pt.device_arrays(dt, cuda)
        for nv in (1, 8):
            x = torch.rand((op.n, nv), device=cuda, dtype=dt)
            x = x[:, 0].contiguous() if nv == 1 else x
            for name, fn, args in (
                    ("kernel", csr_spmv,
                     (dev["indptr"], dev["src"], dev["weight"], x, op.n)),
                    ("plain", csr_spmv_ref,
                     (dev["row_ids"], dev["src"], dev["weight"], x,
                      op.n))):
                out[f"{lane}_nv{nv}_{name}"] = timed(torch, fn, args)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
