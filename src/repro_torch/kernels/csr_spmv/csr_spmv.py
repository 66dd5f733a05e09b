"""ctypes wrapper of the hand-written CSR segment-sum CUDA kernel
(csrc/csr_spmv.cu): y = P^T x over a row-sorted edge list with an indptr,
balanced by edges, in a fixed order.

Two entry points, three lanes of one design:
  * `csr_spmv`: float32 or float64, summed in x's type, y returned; blocks
    of 2,048 consecutive edges, the rows crossing a block's end added by a
    second small launch;
  * `csr_spmv_hub_add`: the block backend's hub rows, float32 operands
    whose products and sum are float64, rounded once and added into the
    block kernel's float32 y in place; one launch, blocks of 512 edges,
    the rows crossing a block's end added by the last of their blocks to
    finish, found through counts kept at zero in a workspace that outlives
    the call (one for each device and stream, so that calls on two streams
    never share one; calls on one stream run one after another).

The JAX package has no TPU kernel here: it computes the product as an XLA
gather plus `jax.ops.segment_sum` (repro/graph/csr.py:152-161). The plain
versions (ref.py) are `index_select` plus `index_add_`, which on the card
add in atomic order; the kernel adds in an order fixed by the edge
positions, so two runs give the same bits, and lane j of an nv-wide call
gives the bits of the 1-wide call on lane j. The wrappers only launch; the
dispatch between the kernel and its plain version is in
`kernels.resolve_impl` (graph/csr.py::pt_matvec, bsr_spmv/ops.py).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import build

# Launches per lane: one added where the kernel is launched, and nowhere
# else (chip_smoke.py reads them to show a solve ran here). An f32 or f64
# call is one launch of the chunk kernel and, where there is more than one
# chunk, one of the small kernel that adds the crossing rows' chunk
# totals; a hub call is one launch.
LAUNCHES = {"f32": 0, "f64": 0, "hub": 0}
_LANE = {torch.float32: 0, torch.float64: 1}
# the hub lane's workspaces by (device index, raw stream): (chunks,
# columns, the buffer), its counts zero between calls
_HUB_WORK: dict = {}
_HUB_LOCK = threading.Lock()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("csr_spmv")
    lib.csr_spmv_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.csr_spmv_launch.restype = ctypes.c_int
    lib.csr_spmv_hub_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.csr_spmv_hub_launch.restype = ctypes.c_int
    lib.csr_spmv_error_string.argtypes = [ctypes.c_int]
    lib.csr_spmv_error_string.restype = ctypes.c_char_p
    lib.csr_spmv_workspace_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_int]
    lib.csr_spmv_workspace_bytes.restype = ctypes.c_longlong
    lib.csr_spmv_hub_chunks.argtypes = [ctypes.c_longlong]
    lib.csr_spmv_hub_chunks.restype = ctypes.c_longlong
    lib.csr_spmv_hub_workspace_bytes.argtypes = [ctypes.c_longlong,
                                                 ctypes.c_int]
    lib.csr_spmv_hub_workspace_bytes.restype = ctypes.c_longlong
    return lib


def _check(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(index: int) -> int:
    """The raw handle of the current stream on device `index` (not a
    torch.cuda.Stream object a call: the static solve's loop is
    host-bound)."""
    if index == torch.cuda.current_device():
        return torch._C._cuda_getCurrentRawStream(index)
    with torch.cuda.device(index):
        return torch._C._cuda_getCurrentRawStream(index)


def _raise(what: str, err: int) -> None:
    if err != 0:
        msg = _lib().csr_spmv_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _launch(lane: int, indptr, src, weight, x, y, n_rows: int) -> None:
    nnz = src.shape[0]
    nv = 1 if x.ndim == 1 else x.shape[1]
    lib = _lib()
    # the workspace layout (the chunks' crossing rows and partial sums) is
    # the library's own
    nbytes = lib.csr_spmv_workspace_bytes(nnz, nv, lane)
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    vec = int((src.data_ptr() | weight.data_ptr()) % 16 == 0)
    _raise("csr_spmv", lib.csr_spmv_launch(
        indptr.data_ptr(), src.data_ptr(), weight.data_ptr(), x.data_ptr(),
        y.data_ptr(), work.data_ptr(), nbytes, n_rows, nnz, nv, lane, vec,
        _stream(x.device.index)))


def _hub_workspace(device: torch.device, stream: int, chunks: int,
                  nv: int) -> tuple:
    """(chunks, columns, buffer) of the hub lane's workspace on `device`
    for the raw stream `stream`, at least `chunks` chunks and `nv`
    columns wide: kept between calls, its counts zero (a new buffer is
    zeroed on the stream, once, when a call needs a wider one)."""
    key = (device.index, stream)
    with _HUB_LOCK:
        have = _HUB_WORK.get(key)
        if have is None or have[0] < chunks or have[1] < nv:
            if have is not None:
                chunks, nv = max(chunks, have[0]), max(nv, have[1])
            nbytes = _lib().csr_spmv_hub_workspace_bytes(chunks, nv)
            have = (chunks, nv, torch.zeros(nbytes, dtype=torch.uint8,
                                            device=device))
            _HUB_WORK[key] = have
        return have


def hub_counts(device: torch.device) -> "torch.Tensor | None":
    """The counts of the hub lane's workspace for the current stream on
    `device` (int32, one for each chunk it holds room for; zero between
    calls), or None before the first hub call there."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    have = _HUB_WORK.get((index, _stream(index)))
    return None if have is None else have[2][:4 * have[0]].view(torch.int32)


def csr_spmv(indptr: torch.Tensor, src: torch.Tensor, weight: torch.Tensor,
             x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """y[r] = sum_{e in indptr[r]:indptr[r+1]} weight[e] * x[src[e]] on the
    card, summed in x's type.

    indptr: (n_rows + 1,) int64, ascending from 0 to nnz
    src:    (nnz,) int32 in [0, x.shape[0])
    weight: (nnz,) float32 or float64, x's dtype
    x:      (n_cols,) or (n_cols, nv), contiguous
    returns (n_rows,) or (n_rows, nv) in x's dtype
    """
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
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    _check(x.device, indptr=indptr, src=src, weight=weight, x=x)
    y = torch.empty((n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    _launch(_LANE[x.dtype], indptr, src, weight, x, y, n_rows)
    LAUNCHES["f32" if x.dtype == torch.float32 else "f64"] += 1
    return y


def csr_spmv_hub_add(indptr: torch.Tensor, src: torch.Tensor,
                     weight: torch.Tensor, x: torch.Tensor,
                     row_map: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y[row_map[i]] += float32(sum_{e in indptr[i]:indptr[i+1]}
    weight[e] * x[src[e]]), each product and the sum in float64, on the
    card. Updates y IN PLACE and returns it.

    indptr:  (n_hub + 1,) int64, ascending from 0 to nnz
    src:     (nnz,) int32 in [0, x.shape[0])
    weight:  (nnz,) float32
    x:       (n_cols, nv) float32, contiguous
    row_map: (n_hub,) int32, distinct rows of y
    y:       (n_out, nv) float32, contiguous
    """
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError(f"x and weight must be float32, got {x.dtype} and "
                        f"{weight.dtype}")
    if y.dtype != torch.float32:
        raise TypeError(f"y must be float32, got {y.dtype}")
    if (indptr.dtype != torch.int64 or src.dtype != torch.int32
            or row_map.dtype != torch.int32):
        raise TypeError(f"indptr must be int64, src and row_map int32, got "
                        f"{indptr.dtype}, {src.dtype} and {row_map.dtype}")
    n_hub = row_map.shape[0]
    if (x.ndim != 2 or y.ndim != 2 or y.shape[1] != x.shape[1]
            or row_map.ndim != 1 or indptr.shape != (n_hub + 1,)
            or src.ndim != 1 or weight.shape != src.shape):
        raise ValueError(f"shape mismatch: indptr {tuple(indptr.shape)}, "
                         f"row_map {tuple(row_map.shape)}, src "
                         f"{tuple(src.shape)}, weight {tuple(weight.shape)}, "
                         f"x {tuple(x.shape)}, y {tuple(y.shape)}")
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    _check(x.device, indptr=indptr, src=src, weight=weight, x=x,
           row_map=row_map, y=y)
    if n_hub == 0 or y.shape[1] == 0:
        return y
    lib = _lib()
    nnz, nv = src.shape[0], x.shape[1]
    stream = _stream(x.device.index)
    chunks, width, work = _hub_workspace(x.device, stream,
                                        lib.csr_spmv_hub_chunks(nnz), nv)
    vec = int((src.data_ptr() | weight.data_ptr()) % 16 == 0)
    _raise("csr_spmv_hub_add", lib.csr_spmv_hub_launch(
        indptr.data_ptr(), src.data_ptr(), weight.data_ptr(), x.data_ptr(),
        y.data_ptr(), row_map.data_ptr(), work.data_ptr(), chunks, width,
        n_hub, nnz, nv, vec, stream))
    LAUNCHES["hub"] += 1
    return y
