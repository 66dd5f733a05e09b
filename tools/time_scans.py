"""Time the port's two scan kernels at the main path's shapes, on the CUDA
card, by chip_smoke.py's own method (`chip_smoke.scan_times`: its inputs,
its `cuda_ms`), for a checkout of the port given by its src/ directory.

    python tools/time_scans.py [--src DIR] [--seed N] [--only GROUPS]

repro_torch is imported from DIR (default: this checkout's src/), so the
same script times another checkout, for example a parent commit unpacked
with `git archive` into a directory that .gitignore lists; its kernels
build into that checkout's build/. Run it for two checkouts in one call to
compare them on one card. Groups (`--only`, comma-separated; default all):
"scans", `ssd_scan` at Mamba2-2.7B's widths over 1 x 2048 bf16 and its
decode step at 4 x 1, `rglru_scan` at RecurrentGemma-2B's W = 2560 over
1 x 4096, 1 x 16384 and 1 x 32768 bf16 and its decode step at 4 x 1;
"ssd_bwd", the SSD backward at Mamba2-2.7B's training shape, 1 x 4096 bf16
(`chip_smoke.SSD_BWD_TIMED`); "rglru_bwd", the RG-LRU backward at
1 x 4096 and 1 x 32768 x 2560 bf16 (`chip_smoke.RGLRU_BWD_TIMED`). Prints
one JSON line: by shape, the kernel's and the plain version's milliseconds
a call, the kernel's largest error against the plain version and its
launches a call (for the backwards also each of their launches' profiled
milliseconds, and for the SSD's the device memory a call allocates at its
peak); the registers, shared bytes and blocks an SM of the SSD's chunk
and backward kernels and of every RG-LRU kernel where the checkout
reports them; nvcc's register and spill report of each RG-LRU kernel
where this run built the library; the card's name and power limit from
nvidia-smi.
"""
import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("scans", "ssd_bwd", "rglru_bwd")


def ptxas_report(log):
    """nvcc's -Xptxas -v log by entry function (demangled where c++filt
    is found): registers, spill stores and spill loads in bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
        return dict(zip(names, out.values()))
    except (OSError, subprocess.CalledProcessError):
        return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(GROUPS))
    args = ap.parse_args(argv)
    groups = args.only.split(",")
    if not set(groups) <= set(GROUPS):
        ap.error(f"--only takes groups of {GROUPS}")
    sys.path.insert(0, ROOT)
    import chip_smoke           # puts this checkout's src/ on the path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("time_scans: no CUDA device is available", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import build
    cuda = torch.device("cuda")
    ptxas = ptxas_report(build.build("rglru_scan"))
    times = {}
    if "scans" in groups:
        times = chip_smoke.scan_times(cuda, args.seed,
                                      long_lru=chip_smoke.RGLRU_LONG)
    if "ssd_bwd" in groups:
        times["ssd_bwd"] = chip_smoke.ssd_bwd_times(cuda, args.seed)
    if "rglru_bwd" in groups:
        for S in chip_smoke.RGLRU_BWD_TIMED:
            times[f"rglru_bwd_{S}"] = chip_smoke.rglru_bwd_times(
                cuda, args.seed, S)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "src": os.path.dirname(os.path.abspath(repro_torch.__file__)),
        "times": {k: {f: v[f] for f in ("kernel", "plain", "err",
                                        "launches", "launch_ms", "kernels",
                                        "peak_mb")
                     if f in v}
                  for k, v in times.items()},
        "attrs": chip_smoke.ssd_kernel_attrs(),
        "rglru_attrs": chip_smoke.rglru_kernel_attrs(),
        "rglru_ptxas": ptxas,
        "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
