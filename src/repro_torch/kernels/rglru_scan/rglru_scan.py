"""ctypes wrapper of the hand-written RG-LRU CUDA kernel
(csrc/rglru_scan.cu): RecurrentGemma's gates and linear recurrence in one
kernel, and the dispatch between it and its plain version (ref.py).

The JAX package has no TPU kernel here: `_lru_coeffs` and
`jax.lax.associative_scan` (repro/models/rglru.py:44-75) are XLA ops. The
kernel computes the gates and h_t = a_t h_{t-1} + b_t in float32 in one
pass: a block holds a chunk of 64 steps of 32 channels in its registers,
publishes the chunk's composite, and runs its steps from h0 folded
through the composites of the earlier chunks (past 64 chunks, of the
groups of ceil(sqrt(chunks)) chunks before the last group, then of each
chunk since) in a fixed order, so the inputs are read once, h is written
once and the bits are the same on every call. A
call is one launch, and adds one to the count "scan"; at S = 1 a step
kernel with no workspace, counted in "step".

`impl`: "cuda" launches the kernel and needs CUDA tensors; "ref" runs the
plain version on any device; "auto" picks "cuda" for CUDA tensors and
"ref" for CPU tensors. A CUDA tensor under "auto" always goes to the
kernel, and a failed build or launch raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import build, resolve_impl
from .ref import rglru_scan_ref

# Launches: one added for each kernel launch, where it is launched, and
# nowhere else (chip_smoke.py reads it to show a model ran here).
LAUNCHES = {"scan": 0, "step": 0}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_workspace_bytes.argtypes = [ctypes.c_int] * 3
    lib.rglru_scan_workspace_bytes.restype = ctypes.c_longlong
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan_kernel(u: torch.Tensor, ga: torch.Tensor, gi: torch.Tensor,
                      b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                      h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The RG-LRU on the card; the arguments and result of
    `rglru_scan_ref`. u: (B, S, W) float32 or bfloat16; ga, gi: (B, S, W)
    float32; b_a, b_i, lam: (W,) float32; h0: (B, W) float32 or None. All
    contiguous on one CUDA device. Returns h (B, S, W) float32."""
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    f32 = dict(ga=ga, gi=gi, b_a=b_a, b_i=b_i, lam=lam)
    if h0 is not None:
        f32["h0"] = h0
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if u.ndim != 3:
        raise ValueError(f"u must be (B, S, W), got {tuple(u.shape)}")
    B, S, W = u.shape
    if (ga.shape != u.shape or gi.shape != u.shape
            or any(t.shape != (W,) for t in (b_a, b_i, lam))
            or (h0 is not None and h0.shape != (B, W))):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, ga "
                         f"{tuple(ga.shape)}, gi {tuple(gi.shape)}, b_a/b_i/"
                         f"lam {[tuple(t.shape) for t in (b_a, b_i, lam)]}"
                         + ("" if h0 is None else
                            f", h0 {tuple(h0.shape)}"))
    for name, t in dict(u=u, **f32).items():
        if not t.is_cuda or t.device != u.device:
            raise ValueError(f"{name} must be a CUDA tensor on {u.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((B, S, W), dtype=torch.float32, device=u.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    nbytes = lib.rglru_scan_workspace_bytes(B, S, W)
    work = None
    if nbytes:
        # the ticket and the chunks' composites, all ones: unset
        work = torch.full((nbytes,), 255, dtype=torch.uint8, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.rglru_scan_launch(
            u.data_ptr(), ga.data_ptr(), gi.data_ptr(), b_a.data_ptr(),
            b_i.data_ptr(), lam.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            None if work is None else work.data_ptr(), out.data_ptr(), B, S,
            W, int(u.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err} "
                           f"({lib.rglru_scan_error_string(err).decode()})")
    LAUNCHES["step" if S == 1 else "scan"] += 1
    return out


def rglru_scan(u: torch.Tensor, ga: torch.Tensor, gi: torch.Tensor,
               b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               impl: str = "auto") -> torch.Tensor:
    """h (B, S, W) float32 of the RG-LRU (`rglru_scan_ref` for the
    arguments), through the kernel ("cuda") or the plain version
    ("ref")."""
    if resolve_impl(impl, u) == "cuda":
        return rglru_scan_kernel(u, ga, gi, b_a, b_i, lam, h0)
    return rglru_scan_ref(u, ga, gi, b_a, b_i, lam, h0)
