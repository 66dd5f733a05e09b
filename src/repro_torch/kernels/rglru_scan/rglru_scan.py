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

The backward (`rglru_scan_bwd_kernel`, the same file) runs the forward's
chunks and fold in reverse: the gradient's carry a_{t+1} g_{t+1} is an
affine map of the later chunk's, as h is of the earlier one's, so the
chunks' composites are published and folded as in the forward, from the
last chunk to the first. Its blocks own 32 channels of a chunk and stage
the tile in shared memory by cp.async (ga and dh first, for the chunk's
composite; u, gi and the forward's h_{t-1} land during the fold); each
writes du, dga and dgi and its partial sums of db_a, db_i and dlam, which
the last block of each channel tile adds in a fixed order in the same
launch. No atomics add a value, so the bits are the same on every call. A
call is one launch and adds one to "bwd": its flags (the ticket, the
composite words, the tiles' counts) are kept for each device and stream
(`bwd_flags`), all ones between calls, since each call leaves them as it
found them. `kernel_attrs` reports every instantiation's registers,
spills, shared bytes and blocks an SM. `RGLRUScan` is the torch.autograd.Function over
the forward and the backward.

`impl`: "cuda" launches the kernel and needs CUDA tensors; "ref" runs the
plain version on any device; "auto" picks "cuda" for CUDA tensors, "ref"
for CPU tensors and "meta" for meta tensors (the dry run's counting lane:
the kernel's wrapper on meta tensors, which books its launch in place of
launching it). A CUDA tensor under "auto" always goes to the kernel, and
a failed build or launch raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from .. import book, build, resolve_impl
from .ref import rglru_scan_bwd_ref, rglru_scan_ref

# Launches: one added for each kernel call, where it is launched, and
# nowhere else (chip_smoke.py reads it to show a model ran here); a
# backward call ("bwd") is one launch.
LAUNCHES = {"scan": 0, "step": 0, "bwd": 0}
# the backward's flags by (device index, raw stream): kept between calls
_BWD_FLAGS: dict = {}
_FLAGS_LOCK = threading.Lock()


def _check_operands(u, ga, gi, b_a, b_i, lam, h0, **more):
    """Raise on operands the kernels do not take: u (B, S, W) float32 or
    bfloat16; ga, gi and every (B, S, W) tensor of `more` float32, the
    rest float32 of their shapes; all contiguous on u's device, a CUDA one
    or the meta device."""
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    f32 = dict(ga=ga, gi=gi, b_a=b_a, b_i=b_i, lam=lam, **more)
    if h0 is not None:
        f32["h0"] = h0
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if u.ndim != 3:
        raise ValueError(f"u must be (B, S, W), got {tuple(u.shape)}")
    B, S, W = u.shape
    if (any(t.shape != u.shape for t in (ga, gi, *more.values()))
            or any(t.shape != (W,) for t in (b_a, b_i, lam))
            or (h0 is not None and h0.shape != (B, W))):
        raise ValueError(
            f"shape mismatch: u {tuple(u.shape)}, "
            + ", ".join(f"{n} {tuple(t.shape)}" for n, t in f32.items()))
    meta = u.is_meta
    for name, t in dict(u=u, **f32).items():
        if not (t.is_meta if meta else t.is_cuda) or t.device != u.device:
            raise ValueError(f"{name} must be a {'meta' if meta else 'CUDA'}"
                             f" tensor on {u.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# the kernels' steps a chunk, channels a block, chunks a fold batch of the
# forward's segment count (kChunk, kCw, kG * kFold in rglru_scan.cu) and
# the ticket's bytes (kTicketBytes)
CHUNK, TILE_W, FOLD_CHUNKS, TICKET_BYTES = 64, 32, 64, 16


def _chunks(S: int) -> tuple:
    """(chunks, chunks a group, groups) of a sequence of S steps: chunks
    of CHUNK steps, and past FOLD_CHUNKS chunks groups of ceil(sqrt(chunks))
    (`group_size` in rglru_scan.cu)."""
    nch = -(-S // CHUNK)
    G = nch if nch <= FOLD_CHUNKS else math.isqrt(nch - 1) + 1
    return nch, G, -(-nch // G)


def scan_workspace_bytes(B: int, S: int, W: int) -> int:
    """Bytes of the workspace a forward call allocates and fills with
    ones: the ticket, then the chunks' and the groups' 64-bit composites
    (B x (chunks + groups) x W); none at S = 1. The formula of
    rglru_scan_workspace_bytes in rglru_scan.cu, for both lanes."""
    if S <= 1:
        return 0
    nch, _, ngr = _chunks(S)
    return TICKET_BYTES + 8 * B * (nch + ngr) * W


def bwd_part_bytes(B: int, S: int, W: int) -> int:
    """Bytes of the backward's partial sums a call allocates, (3, B,
    chunks, W) float32 (rglru_scan_bwd_part_bytes), for both lanes."""
    return 12 * B * -(-S // CHUNK) * W


def bwd_flag_bytes(B: int, S: int, W: int) -> int:
    """Bytes of the backward's flags, kept between calls (`bwd_flags`):
    the ticket, the composites and the channel tiles' counts
    (rglru_scan_bwd_flag_bytes)."""
    nch, _, ngr = _chunks(S)
    tiles = -(-W // TILE_W)
    return TICKET_BYTES + 8 * B * (nch + ngr) * W + (4 * tiles + 15) // 16 * 16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_workspace_bytes.argtypes = [ctypes.c_int] * 3
    lib.rglru_scan_workspace_bytes.restype = ctypes.c_longlong
    lib.rglru_scan_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.rglru_scan_bwd_launch.restype = ctypes.c_int
    for fn in (lib.rglru_scan_bwd_part_bytes,
               lib.rglru_scan_bwd_flag_bytes):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
    lib.rglru_scan_kernel_attrs.argtypes = [ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
    lib.rglru_scan_kernel_attrs.restype = ctypes.c_char_p
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def kernel_attrs() -> dict:
    """By kernel instantiation (the forward, the step and the backward,
    with float32 and bf16 u): its "registers", "shared" bytes, "local"
    (spilled) bytes and resident "blocks" an SM, as the CUDA runtime
    reports them. Needs the card; launches nothing."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    attrs, i = {}, 0
    while (name := lib.rglru_scan_kernel_attrs(i, out)):
        attrs[name.decode()] = dict(zip(
            ("registers", "shared", "local", "blocks"), out))
        i += 1
    return attrs


def rglru_scan_kernel(u: torch.Tensor, ga: torch.Tensor, gi: torch.Tensor,
                      b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                      h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The RG-LRU on the card; the arguments and result of
    `rglru_scan_ref`. u: (B, S, W) float32 or bfloat16; ga, gi: (B, S, W)
    float32; b_a, b_i, lam: (W,) float32; h0: (B, W) float32 or None. All
    contiguous on one CUDA device. Returns h (B, S, W) float32. On meta
    tensors (the meta lane) it checks and allocates as on the card and
    books its launch ("step" at S = 1, else "scan", with
    `analysis.bounds.rglru_cost`) in place of launching it."""
    _check_operands(u, ga, gi, b_a, b_i, lam, h0)
    B, S, W = u.shape
    out = torch.empty((B, S, W), dtype=torch.float32, device=u.device)
    if out.numel() == 0:
        return out
    nbytes = scan_workspace_bytes(B, S, W)
    work = None
    if nbytes:
        # the ticket and the chunks' composites, all ones: unset
        work = torch.full((nbytes,), 255, dtype=torch.uint8, device=u.device)
    if u.is_meta:
        from ...analysis.bounds import rglru_cost
        book("rglru_scan", {"step" if S == 1 else "scan": 1},
             *rglru_cost(B, S, W, u.element_size(), h0 is not None))
        return out
    lib = _lib()
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
    fn = (rglru_scan_ref if resolve_impl(impl, u) == "ref"
          else rglru_scan_kernel)
    return fn(u, ga, gi, b_a, b_i, lam, h0)


def bwd_flags(device: torch.device, stream: int,
              nbytes: int = 0) -> Optional[torch.Tensor]:
    """The backward's flags on `device` for the raw stream `stream` (the
    ticket, the chunks' composites and the channel tiles' counts), at
    least `nbytes` long, or, with nbytes 0, those kept so far (None before
    the first call there). All ones between calls: a new buffer is filled
    with ones on the stream, once, when a call needs a longer one, and
    every call leaves what it used as it found it."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    key = (device.index, stream)
    with _FLAGS_LOCK:
        flags = _BWD_FLAGS.get(key)
        if nbytes and (flags is None or flags.numel() < nbytes):
            flags = torch.full((nbytes,), 255, dtype=torch.uint8,
                               device=device)
            _BWD_FLAGS[key] = flags
        return flags


def rglru_scan_bwd_kernel(u: torch.Tensor, ga: torch.Tensor,
                          gi: torch.Tensor, b_a: torch.Tensor,
                          b_i: torch.Tensor, lam: torch.Tensor,
                          h: torch.Tensor, dh: torch.Tensor,
                          h0: Optional[torch.Tensor] = None
                          ) -> Tuple[Optional[torch.Tensor], ...]:
    """The RG-LRU's gradient on the card; the arguments and results of
    `rglru_scan_bwd_ref`: the forward's operands (as `rglru_scan_kernel`
    takes them), its output h and the output's gradient dh, both (B, S,
    W) float32 and contiguous. Returns (du in u's dtype, dga, dgi, db_a,
    db_i, dlam, dh0 or None). One launch, one count in "bwd". On meta
    tensors the call allocates its partial sums (not its flags, which the
    card keeps between calls, `bwd_flags`) and is booked ("bwd",
    `analysis.bounds.rglru_bwd_cost`) in place of launched."""
    _check_operands(u, ga, gi, b_a, b_i, lam, h0, h=h, dh=dh)
    B, S, W = u.shape
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty_like(u)
    dga, dgi = torch.empty((B, S, W), **f32), torch.empty((B, S, W), **f32)
    d_ba, d_bi, d_lam = (torch.empty((W,), **f32) for _ in range(3))
    dh0 = None if h0 is None else torch.empty((B, W), **f32)
    part = torch.empty((bwd_part_bytes(B, S, W),), dtype=torch.uint8,
                       device=u.device)
    if u.is_meta:
        from ...analysis.bounds import rglru_bwd_cost
        book("rglru_scan", {"bwd": 1},
             *rglru_bwd_cost(B, S, W, u.element_size(), h0 is not None))
        return du, dga, dgi, d_ba, d_bi, d_lam, dh0
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        flags = bwd_flags(u.device, stream, bwd_flag_bytes(B, S, W))
        err = lib.rglru_scan_bwd_launch(
            *(t.data_ptr() for t in (u, ga, gi, b_a, b_i, lam)),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            dh.data_ptr(), flags.data_ptr(), part.data_ptr(),
            *(t.data_ptr() for t in (du, dga, dgi, d_ba, d_bi, d_lam)),
            None if dh0 is None else dh0.data_ptr(), B, S, W,
            int(u.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"rglru_scan backward launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["bwd"] += 1
    return du, dga, dgi, d_ba, d_bi, d_lam, dh0


def rglru_scan_bwd(u: torch.Tensor, ga: torch.Tensor, gi: torch.Tensor,
                   b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                   h: torch.Tensor, dh: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, impl: str = "auto"
                   ) -> Tuple[Optional[torch.Tensor], ...]:
    """The RG-LRU's gradient (`rglru_scan_bwd_ref` for the arguments and
    results), through the kernel ("cuda") or the plain version ("ref")."""
    fn = (rglru_scan_bwd_ref if resolve_impl(impl, u) == "ref"
          else rglru_scan_bwd_kernel)
    return fn(u, ga, gi, b_a, b_i, lam, h, dh, h0)


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU with its gradient: apply(u, ga, gi, b_a, b_i, lam, h0,
    impl) with impl already resolved to "cuda", "ref" or "meta". Saves the
    operands and the output h, which the backward reads for h_{t-1}; the
    backward is the kernel under "cuda" and the plain backward under
    "ref", and returns a gradient for every tensor input (dh0 None
    without h0)."""

    @staticmethod
    def forward(ctx, u, ga, gi, b_a, b_i, lam, h0, impl):
        h = rglru_scan(u, ga, gi, b_a, b_i, lam, h0, impl=impl)
        ctx.save_for_backward(u, ga, gi, b_a, b_i, lam, h0, h)
        ctx.impl = impl
        return h

    @staticmethod
    def backward(ctx, dh):
        u, ga, gi, b_a, b_i, lam, h0, h = ctx.saved_tensors
        grads = rglru_scan_bwd(u, ga, gi, b_a, b_i, lam, h,
                               dh.float().contiguous(), h0, impl=ctx.impl)
        return (*grads, None)
