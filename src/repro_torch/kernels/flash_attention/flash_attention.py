"""ctypes wrapper of the hand-written flash-attention CUDA kernel
(csrc/flash_attention.cu), the prefill forward's attention.

The kernel replaces the JAX package's Pallas `_kernel`
(repro/kernels/flash_attention/flash_attention.py): online-softmax
attention with GQA read in place and top-left causal masking, extended to
any S and T. The wrapper only launches; the dispatch between the kernel and
its plain version (ref.py) is in `ops.attention`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import build

MAX_HEAD_DIM = 128

# Launches of the forward kernel: one added where it is launched, and
# nowhere else (chip_smoke.py reads it to show the model ran here).
LAUNCHES = {"fwd": 0}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention on the card.

    q: (B, H, S, D); k, v: (B, Hkv, T, D) with H % Hkv == 0, all float32 or
    all bfloat16, contiguous, on one CUDA device; 1 <= D <= 128, any S and T.
    causal masks top-left (row i sees columns j <= i). scale defaults to
    D ** -0.5. Returns (B, H, S, D) in q's dtype.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype: {name} is "
                            f"{t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-D (B, heads, seq, D)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, S, D = q.shape
    _, Hkv, T, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or tuple(v.shape) != tuple(k.shape)
            or Hkv == 0 or H % Hkv):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    if T == 0:
        return o.zero_()
    vec_elems = 16 // q.element_size()
    vec = D % vec_elems == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, o))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hkv,
            S, T, D, D ** -0.5 if scale is None else float(scale),
            int(causal), int(q.dtype == torch.bfloat16), int(vec), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["fwd"] += 1
    return o
