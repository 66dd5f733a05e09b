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

The backward (`ssd_scan_bwd_kernel`, the same file) computes the
gradient of that function, which the JAX package takes by XLA's autodiff:
it recomputes the chunk states and carry (as the forward's first two
launches do, with each chunk's sum_t exp(cum_t) dy_t^T C_t beside them),
carries the state's gradient from the last chunk to the first, forms the
Q x Q score gradient summed over the heads on chip (no head's own array
in device memory), forms dx, ddt and da_log's parts a block per (b, chunk,
head), dB and dC, and adds their pieces and da_log over the chunks, in
seven launches with every sum in a fixed order (no atomics), so two calls
give the same bits. With bf16 x its products run on the tensor cores as
bf16 mma.sync (float32 operands split into bf16 parts) fed by cp.async
rings. A call adds one to "bwd".
`SSDScan` is the torch.autograd.Function over the forward and the
backward.

`impl`: "cuda" launches the kernel and needs CUDA tensors; "ref" runs the
plain version on any device; "auto" picks "cuda" for CUDA tensors, "ref"
for CPU tensors and "meta" for meta tensors (the dry run's counting lane:
the kernel's wrapper on meta tensors, which books its launches in place
of launching them). A CUDA tensor under "auto" always goes to the
kernel, and a failed build or launch raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import book, build, resolve_impl
from .ref import ssd_scan_bwd_ref, ssd_scan_ref

# Launches: one added for each kernel launch, where it is launched, and
# nowhere else (chip_smoke.py reads it to show a model ran here).
LAUNCHES = {"scan": 0, "step": 0, "bwd": 0}
MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_workspace_bytes.argtypes = [ctypes.c_int] * 6
    lib.ssd_scan_workspace_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.ssd_scan_bwd_launch.restype = ctypes.c_int
    lib.ssd_scan_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 6
    lib.ssd_scan_bwd_workspace_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    lib.ssd_scan_kernel_attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.ssd_scan_kernel_attrs.restype = ctypes.c_char_p
    return lib


def kernel_attrs(bf16: bool = True) -> dict:
    """By kernel name (the forward's chunk kernel, then the backward's in
    launch order, with bf16 or float32 x): its "registers", "shared" bytes
    (static and a launch's dynamic), "local" (spilled) bytes and resident
    "blocks" an SM, as the CUDA runtime reports them. Needs the card;
    launches nothing."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    attrs, i = {}, 0
    while (name := lib.ssd_scan_kernel_attrs(i, int(bf16), out)):
        attrs[name.decode()] = dict(zip(
            ("registers", "shared", "local", "blocks"), out))
        i += 1
    return attrs


def _check_operands(x, b, c, dt, a_log, chunk, h0, dy=None,
                    dh_last=None) -> int:
    """Raise on operands the kernels do not take (`ssd_scan_kernel`'s
    docstring, and the backward's dy in x's dtype and shape, dh_last
    float32 in h0's; each may be None), all on x's device, a CUDA one or
    the meta device. Returns the chunk length Q."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"b and c must be {x.dtype} like x, got {b.dtype} "
                        f"and {c.dtype}")
    if dy is not None and dy.dtype != x.dtype:
        raise TypeError(f"dy must be {x.dtype} like x, got {dy.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32 or any(
            t is not None and t.dtype != torch.float32
            for t in (h0, dh_last)):
        raise TypeError("dt, a_log, h0 and dh_last must be float32")
    if x.ndim != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if (b.shape != (B, S, N) or c.shape != (B, S, N)
            or dt.shape != (B, S, H) or a_log.shape != (H,)
            or (h0 is not None and h0.shape != (B, H, P, N))
            or (dy is not None and dy.shape != x.shape)
            or (dh_last is not None and dh_last.shape != (B, H, P, N))):
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
    meta = x.is_meta
    tensors = dict(x=x, b=b, c=c, dt=dt, a_log=a_log, h0=h0, dy=dy,
                   dh_last=dh_last)
    for name, t in tensors.items():
        if t is None:
            continue
        if not (t.is_meta if meta else t.is_cuda) or t.device != x.device:
            raise ValueError(f"{name} must be a {'meta' if meta else 'CUDA'}"
                             f" tensor on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return Q


# the chunk kernels' rows of a chunk: Q rounded up to this (kPanel in
# ssd_scan.cu); the backward's score-gradient head groups (kDcbGroups) and
# heads a piece of its dB, dC launch (kDbcHeads)
Q_PANEL, DCB_GROUPS, DBC_HEADS = 32, 2, 20


def _q_stride(Q: int) -> int:
    return -(-Q // Q_PANEL) * Q_PANEL


def scan_workspace_bytes(B: int, S: int, H: int, P: int, N: int,
                         Q: int) -> int:
    """Bytes of the workspace a forward call allocates (P and N as the
    kernel takes them, padded to multiples of 8): float32 chunk states
    B x nc x H x P x N, C B^T B x nc x Qs x Qs and cum B x nc x H x Qs (Qs
    the chunk rounded up to 32); none for the decode step (S = 1). The
    formula of ssd_scan_workspace_bytes in ssd_scan.cu, for both lanes."""
    if S <= 1:
        return 0
    nc, Qs = -(-S // Q), _q_stride(Q)
    return 4 * B * nc * (H * P * N + Qs * Qs + H * Qs)


def bwd_workspace_bytes(B: int, S: int, H: int, P: int, N: int,
                        Q: int) -> int:
    """Bytes of the backward's workspace, float32: the chunk states and
    h_in (B x nc x H x P x N each), C B^T (B x nc x Qs x Qs), cum, dinter
    and dtail (B x nc x H x Qs each), the score gradient's head groups
    (DCB_GROUPS x B x nc x Qs x Qs), the dB, dC pieces (2 x pieces x B x S
    x N, a piece of DBC_HEADS heads and one more) and the chunks' parts of
    da_log (B x nc x H). The formula of ssd_scan_bwd_workspace_bytes, for
    both lanes."""
    nc, Qs = -(-S // Q), _q_stride(Q)
    pieces = 1 + -(-H // DBC_HEADS)
    floats = (2 * B * nc * H * P * N + B * nc * Qs * Qs + 3 * B * nc * H * Qs
              + DCB_GROUPS * B * nc * Qs * Qs + 2 * pieces * B * S * N
              + B * nc * H)
    return 4 * floats


# where each of a tensor's last axes lies, for `_tiled` and `_untiled`: P,
# N, or (P, N) as a state's last two
_PAD = {"P": lambda dp, dn: (0, dp), "N": lambda dp, dn: (0, dn),
        "PN": lambda dp, dn: (0, dn, 0, dp)}
_CUT = {"P": lambda P, N: (..., slice(P)), "N": lambda P, N: (..., slice(N)),
        "PN": lambda P, N: (..., slice(P), slice(N))}


def _tiled(P, N, axes, *tensors):
    """The operands as the chunk kernels read them: rows of P and N values
    as 16-byte vectors, from 16-byte boundaries. Each tensor (or None) is
    padded with zero columns to multiples of 8 on the axes that `axes`
    names for it ("P", "N" or "PN"), where P or N is not one, and else
    cloned where it does not start on a 16-byte boundary. Zero columns add
    nothing and take no gradient; `_untiled` cuts the results back."""
    dp, dn = -P % 8, -N % 8
    return [t if t is None
            else F.pad(t, _PAD[ax](dp, dn)) if dp or dn
            else t if t.data_ptr() % 16 == 0 else t.clone()
            for ax, t in zip(axes, tensors)]


def _untiled(P, N, axes, *tensors):
    """The results of `_tiled` operands cut back to P and N on the axes
    that `axes` names for each (None for none)."""
    if not (P % 8 or N % 8):
        return list(tensors)
    return [t if t is None or ax is None
            else t[_CUT[ax](P, N)].contiguous()
            for ax, t in zip(axes, tensors)]


def ssd_scan_kernel(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    dt: torch.Tensor, a_log: torch.Tensor, chunk: int,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan on the card; the arguments and results of
    `ssd_scan_ref`. x: (B, S, H, P) float32 or bfloat16 with P <= 64; b, c:
    (B, S, N) in x's dtype with N <= 128; dt: (B, S, H) and a_log: (H,)
    float32; h0: (B, H, P, N) float32 or None; chunks of min(chunk, S) <=
    256 steps. All contiguous on one CUDA device.

    On meta tensors (the meta lane) it checks, pads and allocates as on
    the card and books its launches (`kernels.book`: at S = 1 one "step"
    with `analysis.bounds.ssd_step_cost`, else three "scan" with
    `ssd_scan_cost`) in place of launching them."""
    Q = _check_operands(x, b, c, dt, a_log, chunk, h0)
    B, S, H, P = x.shape
    N = b.shape[-1]
    if B == 0 or S == 0 or H == 0:
        return torch.empty_like(x), (
            torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
            if h0 is None else h0.clone())
    if S > 1:                   # the decode step reads single values
        x, b, c, h0 = _tiled(P, N, ("P", "N", "N", "PN"), x, b, c, h0)
    Pk, Nk = x.shape[-1], b.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((B, H, Pk, Nk), dtype=torch.float32, device=x.device)
    nbytes = scan_workspace_bytes(B, S, H, Pk, Nk, Q)
    work = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            if nbytes else None)
    if x.is_meta:
        _book_scan(B, S, H, P, N, Q, x)
        return (y, h) if S == 1 else tuple(_untiled(P, N, ("P", "PN"), y, h))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), None if h0 is None else h0.data_ptr(),
            None if work is None else work.data_ptr(), y.data_ptr(),
            h.data_ptr(), B, S, H, Pk, Nk, Q,
            int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"({lib.ssd_scan_error_string(err).decode()})")
    if S == 1:
        LAUNCHES["step"] += 1               # the decode step
        return y, h
    LAUNCHES["scan"] += 3                   # chunk states, carry, y
    y, h = _untiled(P, N, ("P", "PN"), y, h)
    return y, h


def _book_scan(B, S, H, P, N, Q, x) -> None:
    """Book a forward call on the meta lane as the card counts it."""
    from ...analysis.bounds import ssd_scan_cost, ssd_step_cost
    if S == 1:
        book("ssd_scan", {"step": 1},
             *ssd_step_cost(B, H, P, N, x.element_size()))
    else:
        book("ssd_scan", {"scan": 3},
             *ssd_scan_cost(B, S, H, P, N, Q, x.element_size(),
                            x.dtype == torch.bfloat16))


def ssd_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             dt: torch.Tensor, a_log: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None, impl: str = "auto"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, S, H, P) in x's dtype and the final state (B, H, P, N) float32
    of the chunked SSD scan (`ssd_scan_ref` for the arguments), through
    the kernel ("cuda") or the plain version ("ref")."""
    fn = (ssd_scan_ref if resolve_impl(impl, x) == "ref"
          else ssd_scan_kernel)
    return fn(x, b, c, dt, a_log, chunk, h0)


def ssd_scan_bwd_kernel(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        dt: torch.Tensor, a_log: torch.Tensor, chunk: int,
                        dy: torch.Tensor,
                        dh_last: Optional[torch.Tensor] = None,
                        h0: Optional[torch.Tensor] = None
                        ) -> Tuple[Optional[torch.Tensor], ...]:
    """The SSD scan's gradient on the card; the arguments and results of
    `ssd_scan_bwd_ref`: the forward's operands (as `ssd_scan_kernel` takes
    them), dy (B, S, H, P) in x's dtype and dh_last (B, H, P, N) float32
    or None, all contiguous. Returns (dx, db, dc, ddt, da_log, dh0 or
    None). Seven launches (the chunk states and C B^T again, their carry,
    the state gradient's carry, the heads' score gradient, dx and ddt, dB
    and dC, their pieces' sum and da_log), one count in "bwd". On meta
    tensors the call is booked ("bwd", `analysis.bounds.ssd_bwd_cost`) in
    place of launched, as `ssd_scan_kernel` does."""
    Q = _check_operands(x, b, c, dt, a_log, chunk, h0, dy=dy,
                        dh_last=dh_last)
    B, S, H, P = x.shape
    N = b.shape[-1]
    if B == 0 or S == 0 or H == 0:
        return (torch.zeros_like(x), torch.zeros_like(b),
                torch.zeros_like(c), torch.zeros_like(dt),
                torch.zeros_like(a_log),
                None if h0 is None else torch.zeros_like(h0))
    x, b, c, dy, h0, dh_last = _tiled(
        P, N, ("P", "N", "N", "P", "PN", "PN"), x, b, c, dy, h0, dh_last)
    Pk, Nk = x.shape[-1], b.shape[-1]
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    ddt, da = torch.empty_like(dt), torch.empty_like(a_log)
    dh0 = None if h0 is None else torch.empty_like(h0)
    work = torch.empty(bwd_workspace_bytes(B, S, H, Pk, Nk, Q),
                       dtype=torch.uint8, device=x.device)
    if x.is_meta:
        from ...analysis.bounds import ssd_bwd_cost
        book("ssd_scan", {"bwd": 1},
             *ssd_bwd_cost(B, S, H, P, N, Q, x.element_size(),
                           x.dtype == torch.bfloat16))
        return tuple(_untiled(P, N, ("P", "N", "N", None, None, "PN"),
                              dx, db, dc, ddt, da, dh0))
    lib = _lib()

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_bwd_launch(
            *(ptr(t) for t in (x, b, c, dt, a_log, h0, dy, dh_last, work, dx,
                               db, dc, ddt, da, dh0)),
            B, S, H, Pk, Nk, Q, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan backward launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["bwd"] += 1
    return tuple(_untiled(P, N, ("P", "N", "N", None, None, "PN"),
                          dx, db, dc, ddt, da, dh0))


def ssd_scan_bwd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 dt: torch.Tensor, a_log: torch.Tensor, chunk: int,
                 dy: torch.Tensor, dh_last: Optional[torch.Tensor] = None,
                 h0: Optional[torch.Tensor] = None, impl: str = "auto"
                 ) -> Tuple[Optional[torch.Tensor], ...]:
    """The SSD scan's gradient (`ssd_scan_bwd_ref` for the arguments and
    results), through the kernel ("cuda") or the plain version ("ref")."""
    fn = (ssd_scan_bwd_ref if resolve_impl(impl, x) == "ref"
          else ssd_scan_bwd_kernel)
    return fn(x, b, c, dt, a_log, chunk, dy, dh_last, h0)


class SSDScan(torch.autograd.Function):
    """The SSD scan with its gradient: apply(x, b, c, dt, a_log, h0, chunk,
    impl) -> (y, h_last), impl already resolved to "cuda", "ref" or
    "meta". Saves
    the operands only (the backward recomputes the chunk states); the
    backward is the kernel under "cuda" and the plain backward under
    "ref", takes dy and d h_last (None where unused), and returns a
    gradient for every tensor input (dh0 None without h0)."""

    @staticmethod
    def forward(ctx, x, b, c, dt, a_log, h0, chunk, impl):
        y, h = ssd_scan(x, b, c, dt, a_log, chunk, h0, impl=impl)
        ctx.save_for_backward(x, b, c, dt, a_log, h0)
        ctx.chunk, ctx.impl = chunk, impl
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, b, c, dt, a_log, h0 = ctx.saved_tensors
        dy = (torch.zeros_like(x) if dy is None
              else dy.to(x.dtype).contiguous())
        if dh_last is not None:
            dh_last = dh_last.float().contiguous()
        grads = ssd_scan_bwd(x, b, c, dt, a_log, ctx.chunk, dy, dh_last, h0,
                             impl=ctx.impl)
        return (*grads, None, None)
