"""Time the port's static float64 segment-sum PageRank solve on the
Stanford-Web replica (281,903 pages), on the CUDA card.

    python tools/time_static_solve.py [--src DIR] [--reps N]

repro_torch is imported from DIR (default: this checkout's src/), so the
same script times another checkout of the port, for example a parent
commit unpacked with `git archive` into a directory that .gitignore lists.
The solve is `solve_power(op, backend="segment_sum", dtype=float64,
tol=1e-10)`, run once to warm up and then `--reps` times; each solve is
timed with CUDA events from its call to its return (the host read of the
residual each iteration included). Prints one JSON line: the milliseconds
of every timed solve, their median, the iterations, and the card's name
and power limit from nvidia-smi.
"""
import argparse
import json
import os
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("time_static_solve: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.configs.pagerank import STANFORD
    from repro_torch.core.pagerank import solve_power

    op = STANFORD.build()

    def solve():
        return solve_power(op, backend="segment_sum", dtype=torch.float64,
                           tol=1e-10)

    r = solve()
    ms = []
    for _ in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = solve()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"src": os.path.abspath(args.src), "iters": r.iters,
                      "solve_ms": ms, "median_ms": sorted(ms)[len(ms) // 2],
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
