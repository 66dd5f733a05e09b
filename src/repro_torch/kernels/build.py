"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each build unit is one `.cu` file under a kernel's `csrc/` that exports a
plain C interface. At first use it is compiled for Hopper into a shared
library under `build/` at the repository root, named by a hash of every
file under its `csrc/` (the `.cu` files and the headers they include) and
the nvcc flags, so an edited source or header builds anew and an unchanged
tree is loaded as it is. Nothing here runs at import time: the CPU tests
import every module on machines without nvcc.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Mapping, Sequence

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_KERNELS = Path(__file__).parent
SOURCES: Dict[str, Path] = {
    "bsr_spmv": _KERNELS / "bsr_spmv" / "csrc" / "bsr_spmv.cu",
    # the segment-sum backend's P^T x, in a fixed order
    "csr_spmv": _KERNELS / "csr_spmv" / "csrc" / "csr_spmv.cu",
    # the CUDA-core lane (float32, and bf16 at other head dims)
    "flash_attention": (_KERNELS / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
    # the tensor-core lane (bf16, head dim 64 or 128)
    "flash_attention_wgmma": (_KERNELS / "flash_attention" / "csrc"
                              / "flash_attention_wgmma.cu"),
}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str, sources: Mapping[str, Path] = SOURCES,
                 flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """build/lib<name>-<hash>.so, the hash taken over every file under the
    source's directory (path and bytes) and the flags, include paths among
    them (the kernels need none beyond the toolkit's and their own
    csrc/)."""
    csrc = sources[name].parent
    h = hashlib.sha256()
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(f.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile kernel `name` unless its library is current; return nvcc's
    report (registers, shared memory and spills per kernel; empty when the
    library was already built)."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def build_all() -> Dict[str, float]:
    """Build every kernel, one nvcc per source, all started together.
    Returns each kernel's wall seconds and prints nvcc's reports."""
    def timed(name):
        t0 = time.perf_counter()
        log = build(name)
        return time.perf_counter() - t0, log

    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(timed, name) for name in SOURCES}
        results = {name: f.result() for name, f in futures.items()}
    for name, (_, log) in results.items():
        if log:
            print(f"[build] {name}:\n{log.rstrip()}")
    return {name: secs for name, (secs, _) in results.items()}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built at first use (callers keep the
    handle: each kernel's wrapper loads once)."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
