"""ctypes wrapper of the hand-written SSD chunked-scan CUDA kernel
(csrc/ssd_scan.cu), Mamba-2's time mixing, and the dispatch between it and
its plain version (ref.py).

The JAX package has no TPU kernel here: its `_ssd_scan`
(repro/models/ssm.py:59-110) is a `lax.scan` of einsums that XLA compiles.
The kernel computes the same function chunk-parallel: one launch forms
C B^T of every chunk once for all heads and each chunk's own state, a
second carries the state across the chunks in order, a third forms y of
every chunk from its incoming state. With bf16 x its products run on the
tensor cores in split TF32 (float32 accuracy); with float32 x on the CUDA
cores, summed in the order of the plain version's float32 products. At S = 1 (a decode step) one launch moves
the state a step, with no workspace. Each launch adds one to its count:
"scan" three a call, "step" one a decode step.

`impl`: "cuda" launches the kernel and needs CUDA tensors; "ref" runs the
plain version on any device; "auto" picks "cuda" for CUDA tensors and
"ref" for CPU tensors. A CUDA tensor under "auto" always goes to the
kernel, and a failed build or launch raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import build, resolve_impl
from .ref import ssd_scan_ref

# Launches: one added for each kernel launch, where it is launched, and
# nowhere else (chip_smoke.py reads it to show a model ran here).
LAUNCHES = {"scan": 0, "step": 0}
MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_workspace_bytes.argtypes = [ctypes.c_int] * 6
    lib.ssd_scan_workspace_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_kernel(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    dt: torch.Tensor, a_log: torch.Tensor, chunk: int,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan on the card; the arguments and results of
    `ssd_scan_ref`. x: (B, S, H, P) float32 or bfloat16 with P <= 64; b, c:
    (B, S, N) in x's dtype with N <= 128; dt: (B, S, H) and a_log: (H,)
    float32; h0: (B, H, P, N) float32 or None; chunks of min(chunk, S) <=
    256 steps. All contiguous on one CUDA device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"b and c must be {x.dtype} like x, got {b.dtype} "
                        f"and {c.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32 or (
            h0 is not None and h0.dtype != torch.float32):
        raise TypeError("dt, a_log and h0 must be float32")
    if x.ndim != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if (b.shape != (B, S, N) or c.shape != (B, S, N)
            or dt.shape != (B, S, H) or a_log.shape != (H,)
            or (h0 is not None and h0.shape != (B, H, P, N))):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, dt "
                         f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)}"
                         + ("" if h0 is None else
                            f", h0 {tuple(h0.shape)}"))
    Q = min(chunk, S) if S else chunk
    if not (1 <= P <= MAX_HEAD_DIM and 1 <= N <= MAX_STATE
            and 1 <= Q <= MAX_CHUNK):
        raise ValueError(f"head dim {P}, state {N} and chunk {Q} must lie "
                         f"in [1, {MAX_HEAD_DIM}], [1, {MAX_STATE}] and "
                         f"[1, {MAX_CHUNK}]")
    tensors = dict(x=x, b=b, c=c, dt=dt, a_log=a_log)
    if h0 is not None:
        tensors["h0"] = h0
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty_like(x)
    if B == 0 or S == 0 or H == 0:
        return y, (torch.zeros((B, H, P, N), dtype=torch.float32,
                               device=x.device) if h0 is None
                   else h0.clone())
    if S > 1 and (P % 8 or N % 8):
        # the chunk kernels read 16-byte vectors of rows of P and N values:
        # zero columns add nothing, so pad to multiples of 8 and cut back
        dp, dn = -P % 8, -N % 8
        y, h = ssd_scan_kernel(
            F.pad(x, (0, dp)), F.pad(b, (0, dn)), F.pad(c, (0, dn)), dt,
            a_log, chunk, None if h0 is None else F.pad(h0, (0, dn, 0, dp)))
        return y[..., :P].contiguous(), h[:, :, :P, :N].contiguous()
    if S > 1:                   # and on 16-byte boundaries
        x, b, c = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (x, b, c))
        if h0 is not None and h0.data_ptr() % 16:
            h0 = h0.clone()
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    nbytes = lib.ssd_scan_workspace_bytes(B, S, H, P, N, Q)
    work = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            if nbytes else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), None if h0 is None else h0.data_ptr(),
            None if work is None else work.data_ptr(), y.data_ptr(),
            h.data_ptr(), B, S, H, P, N, Q, int(x.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"({lib.ssd_scan_error_string(err).decode()})")
    if S == 1:
        LAUNCHES["step"] += 1               # the decode step
    else:
        LAUNCHES["scan"] += 3               # chunk states, carry, y
    return y, h


def ssd_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             dt: torch.Tensor, a_log: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None, impl: str = "auto"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, S, H, P) in x's dtype and the final state (B, H, P, N) float32
    of the chunked SSD scan (`ssd_scan_ref` for the arguments), through
    the kernel ("cuda") or the plain version ("ref")."""
    if resolve_impl(impl, x) == "cuda":
        return ssd_scan_kernel(x, b, c, dt, a_log, chunk, h0)
    return ssd_scan_ref(x, b, c, dt, a_log, chunk, h0)
