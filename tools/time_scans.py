"""Time the port's two scan kernels at the main path's shapes, on the CUDA
card, by chip_smoke.py's own method (`chip_smoke.scan_times`: its inputs,
its `cuda_ms`), for a checkout of the port given by its src/ directory.

    python tools/time_scans.py [--src DIR] [--seed N]

repro_torch is imported from DIR (default: this checkout's src/), so the
same script times another checkout, for example a parent commit unpacked
with `git archive` into a directory that .gitignore lists; its kernels
build into that checkout's build/. Run it for two checkouts in one call to
compare them on one card. Shapes: `ssd_scan` at Mamba2-2.7B's widths over
1 x 2048 bf16 and its decode step at 4 x 1; `rglru_scan` at
RecurrentGemma-2B's W = 2560 over 1 x 4096, 1 x 16384 and 1 x 32768 bf16
and its decode step at 4 x 1; the SSD backward at Mamba2-2.7B's training
shape, 1 x 4096 bf16 (`chip_smoke.SSD_BWD_TIMED`). Prints one JSON line:
by shape, the kernel's and the plain version's milliseconds a call, the
kernel's largest error against the plain version and its launches a call
(for the backward also each of its launches' profiled milliseconds and
the device memory a call allocates at its peak), the
registers, shared bytes and blocks an SM of the SSD's chunk and backward
kernels where the checkout reports them, with the card's name and power
limit from nvidia-smi.
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke           # puts this checkout's src/ on the path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("time_scans: no CUDA device is available", file=sys.stderr)
        return 1
    import repro_torch
    cuda = torch.device("cuda")
    times = chip_smoke.scan_times(cuda, args.seed,
                                  long_lru=chip_smoke.RGLRU_LONG)
    times["ssd_bwd"] = chip_smoke.ssd_bwd_times(cuda, args.seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "src": os.path.dirname(os.path.abspath(repro_torch.__file__)),
        "times": {k: {f: v[f] for f in ("kernel", "plain", "err",
                                        "launches", "launch_ms", "peak_mb")
                     if f in v}
                  for k, v in times.items()},
        "attrs": chip_smoke.ssd_kernel_attrs(),
        "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
