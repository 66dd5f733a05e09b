"""ctypes wrapper of the hand-written block-CSR SpMV CUDA kernel
(csrc/bsr_spmv.cu), the paper's per-iteration hot spot.

The kernel replaces the JAX package's Pallas `_kernel` / `_kernel_kahan`
(repro/kernels/bsr_spmv/bsr_spmv.py): one template, switched on the
accumulation lane and on the type of x, that streams each block-row's real
slots through a shared-memory ring of bulk copies and skips the padded
ones (`blk_count`). The wrapper only launches; the
dispatch between the kernel and its plain version (ref.py) is in
`kernels.resolve_impl`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import build

# The block edge on the card: the fastest warm google_apply at nv = 1 on
# the Stanford-Web replica (core/backend.py has the table).
DEFAULT_BM = 8
DEFAULT_BN = 8

# Launches per accumulation lane: one added where the kernel is launched,
# and nowhere else (chip_smoke.py reads them to show the solve ran here).
LAUNCHES = {"f32": 0, "kahan": 0}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("bsr_spmv")
    lib.bsr_spmv_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.bsr_spmv_launch.restype = ctypes.c_int
    lib.bsr_spmv_ring_path.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    lib.bsr_spmv_ring_path.restype = ctypes.c_int
    lib.bsr_spmv_error_string.argtypes = [ctypes.c_int]
    lib.bsr_spmv_error_string.restype = ctypes.c_char_p
    return lib


def kernel_path(blocks: torch.Tensor, x: torch.Tensor) -> str:
    """"ring" where the bulk-copy ring kernel serves these operands (bm = bn
    in {8, 16, 32, 64}, nv in {1, 2, 4, 8}, 16-byte-aligned blocks and x),
    "generic" where the one-thread-per-output path does; the rule is the
    kernel library's own."""
    _, _, bm, bn = blocks.shape
    ring = _lib().bsr_spmv_ring_path(bm, bn, x.shape[2], blocks.data_ptr(),
                                     x.data_ptr())
    return "ring" if ring else "generic"


def bsr_spmv(blocks: torch.Tensor, blk_cols: torch.Tensor, x: torch.Tensor,
             accum: str = "f32",
             blk_count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[i] = sum_k blocks[i, k] @ x[blk_cols[i, k]] on the card.

    blocks:    (nbr, K, bm, bn) float32, contiguous
    blk_cols:  (nbr, K) int32 in [0, nbc); padded slots point at a valid
               column (0) with an all-zero block, as `build_bsr` packs them
    x:         (nbc, bn, nv) float32 or float16, contiguous
    accum:     "f32" (plain f32 accumulate) or "kahan" (compensated across
               the K slots)
    blk_count: (nbr,) int32, the real slots of each block-row
               (`ops.slot_counts`); the kernel reads no slot past it and
               returns what the full K slots give. None reads all K.
    returns    (nbr, bm, nv) float32
    """
    if accum not in LAUNCHES:
        raise ValueError(f"unknown accum {accum!r}; the kernel renders "
                         f"{tuple(LAUNCHES)}")
    operands = [("blocks", blocks), ("blk_cols", blk_cols), ("x", x)]
    if blk_count is not None:
        operands.append(("blk_count", blk_count))
    for name, t in operands:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if blocks.dtype != torch.float32:
        raise TypeError(f"blocks must be float32, got {blocks.dtype}")
    if blk_cols.dtype != torch.int32:
        raise TypeError(f"blk_cols must be int32, got {blk_cols.dtype}")
    if x.dtype not in (torch.float32, torch.float16):
        raise TypeError(f"x must be float32 or float16, got {x.dtype}")
    if blocks.ndim != 4 or blk_cols.ndim != 2 or x.ndim != 3:
        raise ValueError("expected blocks (nbr,K,bm,bn), blk_cols (nbr,K), "
                         "x (nbc,bn,nv)")
    nbr, K, bm, bn = blocks.shape
    if tuple(blk_cols.shape) != (nbr, K) or x.shape[1] != bn:
        raise ValueError(f"shape mismatch: blocks {tuple(blocks.shape)}, "
                         f"blk_cols {tuple(blk_cols.shape)}, "
                         f"x {tuple(x.shape)}")
    if blk_count is not None and (blk_count.dtype != torch.int32
                                  or tuple(blk_count.shape) != (nbr,)):
        raise ValueError(f"blk_count must be int32 of shape ({nbr},), got "
                         f"{blk_count.dtype} {tuple(blk_count.shape)}")
    nv = x.shape[2]
    y = torch.empty((nbr, bm, nv), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bsr_spmv_launch(
            blocks.data_ptr(), blk_cols.data_ptr(),
            None if blk_count is None else blk_count.data_ptr(),
            x.data_ptr(), y.data_ptr(), nbr, K, bm, bn, nv,
            int(x.dtype == torch.float16), int(accum == "kahan"), stream)
    if err != 0:
        msg = lib.bsr_spmv_error_string(err).decode()
        raise RuntimeError(f"bsr_spmv launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES[accum] += 1
    return y
