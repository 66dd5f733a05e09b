"""ctypes wrapper of the hand-written CSR segment-sum CUDA kernel
(csrc/csr_spmv.cu): y = P^T x over a row-sorted edge list with an indptr,
one warp per row, in a fixed order.

The JAX package has no TPU kernel here: it computes the product as an XLA
gather plus `jax.ops.segment_sum` (repro/graph/csr.py:152-161). The port's
plain version (ref.py) is `index_select` plus `index_add_`, which on the
card adds in atomic order; the kernel adds in an order fixed by the edge
positions, so two runs give the same bits, and lane j of an nv-wide call
gives the bits of the 1-wide call on lane j. The wrapper only launches; the
dispatch between the kernel and its plain version is in
`kernels.resolve_impl` (graph/csr.py::pt_matvec).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

# Launches per dtype: one added where the kernel is launched, and nowhere
# else (chip_smoke.py reads them to show a solve ran here).
LAUNCHES = {"f32": 0, "f64": 0}
_LANE = {torch.float32: "f32", torch.float64: "f64"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("csr_spmv")
    lib.csr_spmv_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p])
    lib.csr_spmv_launch.restype = ctypes.c_int
    lib.csr_spmv_error_string.argtypes = [ctypes.c_int]
    lib.csr_spmv_error_string.restype = ctypes.c_char_p
    return lib


def csr_spmv(indptr: torch.Tensor, src: torch.Tensor, weight: torch.Tensor,
             x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """y[r] = sum_{e in indptr[r]:indptr[r+1]} weight[e] * x[src[e]] on the
    card.

    indptr: (n_rows + 1,) int64, ascending from 0 to nnz
    src:    (nnz,) int32 in [0, x.shape[0])
    weight: (nnz,) float32 or float64, x's dtype
    x:      (n_cols,) or (n_cols, nv), contiguous
    returns (n_rows,) or (n_rows, nv) in x's dtype
    """
    for name, t in (("indptr", indptr), ("src", src), ("weight", weight),
                    ("x", x)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _LANE:
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if weight.dtype != x.dtype:
        raise TypeError(f"weight must be {x.dtype} like x, got "
                        f"{weight.dtype}")
    if indptr.dtype != torch.int64 or src.dtype != torch.int32:
        raise TypeError(f"indptr must be int64 and src int32, got "
                        f"{indptr.dtype} and {src.dtype}")
    if (x.ndim not in (1, 2) or indptr.shape != (n_rows + 1,)
            or src.ndim != 1 or weight.shape != src.shape):
        raise ValueError(f"shape mismatch: indptr {tuple(indptr.shape)} for "
                         f"{n_rows} rows, src {tuple(src.shape)}, weight "
                         f"{tuple(weight.shape)}, x {tuple(x.shape)}")
    nv = 1 if x.ndim == 1 else x.shape[1]
    y = torch.empty((n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.csr_spmv_launch(
            indptr.data_ptr(), src.data_ptr(), weight.data_ptr(),
            x.data_ptr(), y.data_ptr(), n_rows, nv,
            int(x.dtype == torch.float64), stream)
    if err != 0:
        msg = lib.csr_spmv_error_string(err).decode()
        raise RuntimeError(f"csr_spmv launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES[_LANE[x.dtype]] += 1
    return y
