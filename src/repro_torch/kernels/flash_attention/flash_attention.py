"""ctypes wrapper of the hand-written flash-attention CUDA kernels, the
prefill forward's attention. Two lanes, both hand-written for sm_90a:

* "wgmma" (csrc/flash_attention_wgmma.cu): bf16 with (key, value) head
  dims (64, 64), (128, 128), (256, 256) or (192, 128) (DeepSeek-V3's
  multi-head latent attention), every full-width config the port serves.
  q k^T and p v run on the tensor cores (wgmma, p rounded to bf16), k and
  v arrive by TMA into a shared-memory ring, one producer and two
  consumer warpgroups on a 128-row q tile, kv tiles of 128 rows. At head
  dim 256 (RecurrentGemma-2B, PaliGemma-3B) one consumer warpgroup on a
  64-row q tile, whose threads may then hold O's 128 floats in registers,
  and kv tiles of 64 rows, since two stages of 128 would not fit in
  shared memory. At (192, 128) q and k are three 64-column panels and v
  two: 208 KB of shared memory with two consumers and 128-row kv tiles.
* "f32" (csrc/flash_attention.cu): float32, and bf16 at any other pair
  of head dims (the smoke configs' 12-32): the arithmetic in f32 FMAs on
  the CUDA cores. One block of 256 threads (8 warps) per 128-row q tile
  (64 rows at head dims above 128), kv tiles of 128 keys streamed as
  32 KB chunks (k in 64-column slices, then v in 64-key slices, 32 above
  128) through a two-buffer ring by 16-byte cp.async, each chunk copied
  while the one before is computed on; one block barrier per chunk; 8 x 8
  scores and outputs per thread, p in shared memory per half-warp.
  227,328 bytes of shared memory at D = 128 in float32: one block per
  SM. `kernel_info` reports its occupancy, registers and spills as
  compiled; `wgmma_kernel_attrs` the tensor-core lane's.

Both lanes return each row's base-2 log-sum-exp when asked
(`return_lse=True`), for the backward.

`kernel_lane` picks the lane from the dtype and the two head dims alone.
This is dispatch between two kernels, not a fallback: a bf16 tensor whose
head dims are one of the tensor-core pairs only ever goes to the
tensor-core kernel, and a failed build or launch raises.

Both lanes take the JAX package's `_mask` (models/attention.py): an
optional local window (RecurrentGemma's `local_attn` layers: row i keeps
columns j > i - window besides the causal j <= i) and a prefix
(PaliGemma's prefix-LM: with causal, every row also sees the columns
j < prefix_len), and a value head dim of its own (MLA: Dk = 192 over
Dv = 128). A q tile starts its kv loop at the first tile its window
reaches, ends it at the last tile that holds a column it sees (its own
last row or the prefix's last column, whichever is later), and masks
only the tiles that cross the window's lower edge, the diagonal past the
prefix or the kv tail; window=None and prefix_len=0 run the causal path
as it was.

The kernels replace the JAX package's Pallas `_kernel`
(repro/kernels/flash_attention/flash_attention.py): online-softmax
attention with GQA read in place and top-left causal masking, extended to
any S and T. The wrapper only launches; the dispatch between the kernels
and their plain version (ref.py) is in `ops.attention`.

`flash_attention_bwd` is the gradient of both lanes' function, dq, dk and
dv, with no atomics (repeats agree bit for bit), in two lanes that
`bwd_lane` picks from the dtype and the head dims alone:

* "wgmma" (csrc/flash_attention_bwd_wgmma.cu): bf16 at (64, 64),
  (128, 128) and (256, 256), every training path of the port
  (RecurrentGemma-2B's local attention at 256). dq first (one block a
  128-row q tile, K and V through a TMA ring; it also forms each row's
  Delta), then dk and dv (one block a 128-key tile, Q and dO through a
  TMA ring over the group's heads; at D = 128 and 256 in two passes, dK
  then dV, so that a thread never holds both), every product by `wgmma`;
  at D = 256 one consumer warpgroup a block on 64-row q tiles and 64-key
  tiles, whose threads may then hold a 64 x 256 float32 accumulator.
  With few kv heads the group's heads split over blocks whose float32
  partials a third launch adds in a fixed order. Given the forward's
  log-sum-exp (`flash_attention(..., return_lse=True)`), the dq launch
  uses it; without it the launch rebuilds it first, one q k^T product a
  pair. A window skips the tiles wholly outside it in both launches.
* "f32" (csrc/flash_attention_bwd.cu): float32, and bf16 at other head
  dims up to 256 ((192, 128), the smoke configs'), on the CUDA cores in
  f32, with the forward lane's design: 8 x 8 register tiles of scores
  where the head dims allow, inputs in their own type in shared memory
  fed by 16-byte cp.async one chunk ahead. dq first (a block a q tile of
  128 rows, 64 above head dim 64; it reads the forward's log-sum-exp, or
  rebuilds it in a first pass over the keys when none is given, and forms
  Delta), then dk and dv (a block a kv tile of 128, 64 or 32 keys over
  the group's heads' q tiles).

The Pallas kernel has no backward; `ops.attention` reaches these through a
torch.autograd.Function.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import book, build
from .ref import check_prefix, check_window

MAX_HEAD_DIM = 256
# the tensor-core lane's (key, value) head dims
WGMMA_HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))

# the tensor-core backward lane's (key, value) head dims
WGMMA_BWD_HEAD_DIMS = ((64, 64), (128, 128), (256, 256))

# Launches: "fwd" counts every forward launch of either lane, "wgmma" those
# of the tensor-core lane, "bwd" every call of the backward (its two or
# three launches) on either lane, "bwd_wgmma" those of the tensor-core
# backward; one added where a kernel is launched, and nowhere else
# (chip_smoke.py reads them to show the model ran here).
LAUNCHES = {"fwd": 0, "wgmma": 0, "bwd": 0, "bwd_wgmma": 0}


def kernel_lane(dtype: torch.dtype, head_dim: int,
                v_head_dim: Optional[int] = None) -> str:
    """"wgmma" for bfloat16 whose (key, value) head dims are in
    WGMMA_HEAD_DIMS = (64, 64), (128, 128), (256, 256), (192, 128) (the
    tensor-core kernel; one consumer warpgroup and 64-row tiles at 256),
    else "f32" (the CUDA-core kernel: 256 threads per 128-row q tile,
    64-row above head dim 128, k and v by cp.async, f32 FMAs).
    v_head_dim defaults to head_dim."""
    dv = head_dim if v_head_dim is None else v_head_dim
    if dtype == torch.bfloat16 and (head_dim, dv) in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "f32"


def bwd_lane(dtype: torch.dtype, head_dim: int,
             v_head_dim: Optional[int] = None) -> str:
    """The backward's lane: "wgmma" for bfloat16 whose (key, value) head
    dims are in WGMMA_BWD_HEAD_DIMS = (64, 64), (128, 128), (256, 256)
    (the tensor-core kernel), else "f32" (the CUDA-core kernel: float32,
    and bf16 at other head dims up to 256, (192, 128) among them).
    v_head_dim defaults to head_dim."""
    dv = head_dim if v_head_dim is None else v_head_dim
    if dtype == torch.bfloat16 and (head_dim, dv) in WGMMA_BWD_HEAD_DIMS:
        return "wgmma"
    return "f32"


def _vec(Dk: int, Dv: int, *tensors: torch.Tensor) -> bool:
    """Whether the CUDA-core kernels may copy rows by 16-byte cp.async: Dk
    and Dv whole 16-byte chunks of the dtype, every tensor on a 16-byte
    boundary (else they take synchronous loads)."""
    n = 16 // tensors[0].element_size()
    return (Dk % n == 0 and Dv % n == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def check_aligned(**tensors: torch.Tensor) -> None:
    """The tensor-core lane reads and writes through TMA, which needs every
    base address on a 16-byte boundary; raise for one that is not."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the tensor-core lane (address "
                             f"{t.data_ptr():#x})")


def _check_tensors(q: torch.Tensor, named) -> None:
    """Each (name, tensor) of `named` on q's device (a CUDA one, or the
    meta device), float32 or bfloat16 like q, 4-D and contiguous; raise
    for one that is not."""
    meta = q.is_meta
    kind = "meta" if meta else "CUDA"
    for name, t in named:
        if not (t.is_meta if meta else t.is_cuda) or t.device != q.device:
            raise ValueError(f"{name} must be a {kind} tensor on "
                             f"{q.device}, got {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must share q's dtype: {name} is "
                            f"{t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-D (B, heads, seq, D)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_dims(Dk: int, Dv: int) -> None:
    for d in (Dk, Dv):
        if not 1 <= d <= MAX_HEAD_DIM:
            raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")


def _check_fwd(q, k, v):
    """The forward's operand checks (`flash_attention`'s docstring);
    returns (B, H, S, Dk, Hkv, T, Dv)."""
    _check_tensors(q, (("q", q), ("k", k), ("v", v)))
    B, H, S, Dk = q.shape
    _, Hkv, T, _ = k.shape
    Dv = v.shape[3]
    if (k.shape[0] != B or k.shape[3] != Dk
            or tuple(v.shape[:3]) != tuple(k.shape[:3])
            or Hkv == 0 or H % Hkv):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_dims(Dk, Dv)
    return B, H, S, Dk, Hkv, T, Dv


def _check_bwd(q, k, v, o, do, lse):
    """The backward's operand checks (`flash_attention_bwd`'s docstring);
    returns (B, H, S, Dk, Hkv, T, Dv)."""
    _check_tensors(q, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)))
    B, H, S, Dk = q.shape
    _, Hkv, T, _ = k.shape
    Dv = v.shape[3]
    if (k.shape[0] != B or k.shape[3] != Dk
            or tuple(v.shape[:3]) != tuple(k.shape[:3])
            or Hkv == 0 or H % Hkv
            or tuple(o.shape) != (B, H, S, Dv) or do.shape != o.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}")
    if lse is not None and (lse.device != q.device
                            or lse.dtype != torch.float32
                            or tuple(lse.shape) != (B, H, S)
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 (B, H, S) = "
                         f"{(B, H, S)} tensor on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    _check_dims(Dk, Dv)
    return B, H, S, Dk, Hkv, T, Dv


# the tensor-core backward's workspace: each head's rows (lse, then Delta)
# padded to a multiple of this (kRowPad in flash_attention_bwd_wgmma.cu)
BWD_ROW_PAD = 128
# the SMs of an H100 SXM, for the workspace of a call counted on the meta
# device (on the card the device's own count)
H100_SMS = 132


def bwd_head_splits(B: int, Hkv: int, G: int, T: int, D: int,
                    sms: int) -> int:
    """The tensor-core backward's head splits of its dk / dv launch
    (`head_splits` in flash_attention_bwd_wgmma.cu): the least divisor s of
    the group size G with at least two blocks an SM over the key tiles of
    64 x consumers keys, else G."""
    bk = 64 * (1 if D == 256 else 2)
    tiles = -(-T // bk) * B * Hkv
    for s in range(1, G):
        if G % s == 0 and tiles * s >= 2 * sms:
            return s
    return G


def bwd_workspace_numel(B: int, H: int, Hkv: int, S: int, T: int, Dk: int,
                        Dv: int, lane: str,
                        sms: Optional[int] = H100_SMS) -> int:
    """float32 elements of the workspace `flash_attention_bwd` allocates on
    `lane` (`bwd_lane`), both lanes' one formula: on the tensor-core lane
    each row's lse and Delta (B H rows of S padded to BWD_ROW_PAD) and,
    where the group's heads split over blocks, 2 x splits x B Hkv T Dk
    float32 partials of dk and dv (flash_attention_bwd_wgmma_workspace_bytes
    / 4, `sms` the card's SMs); on the CUDA-core lane each row's lse and
    Delta, 2 B H S."""
    if lane == "wgmma":
        s_pad = -(-S // BWD_ROW_PAD) * BWD_ROW_PAD
        n = 2 * B * H * s_pad
        nsplit = bwd_head_splits(B, Hkv, H // Hkv, T, Dk, sms)
        if nsplit > 1:
            n += 2 * nsplit * B * Hkv * T * Dk
        return n
    return 2 * B * H * S


@functools.cache
def _sm_count(device: torch.device) -> int:
    """The SMs of a card, or of an H100 SXM on the meta device."""
    if device.type == "meta":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_kernel_info.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_kernel_info.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def kernel_info(head_dim: int, dtype: torch.dtype,
                v_head_dim: Optional[int] = None) -> dict:
    """The CUDA-core lane's kernel for these head dims (v_head_dim defaults
    to head_dim) and dtype, as compiled and placed on the current CUDA
    device: resident blocks per SM, threads per block, registers per
    thread, local (spill) bytes per thread and dynamic shared memory per
    block."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"float32 or bfloat16, got {dtype}")
    dv = head_dim if v_head_dim is None else v_head_dim
    for d in (head_dim, dv):
        if not 1 <= d <= MAX_HEAD_DIM:
            raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    lib = _lib()
    out = (ctypes.c_int * 5)()
    err = lib.flash_attention_kernel_info(
        head_dim, dv, int(dtype == torch.bfloat16), out)
    if err != 0:
        raise RuntimeError(f"flash_attention_kernel_info failed: error {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    keys = ("blocks_per_sm", "threads", "registers", "local_bytes",
            "smem_bytes")
    return dict(zip(keys, out))


@functools.cache
def _wgmma_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_wgmma")
    lib.flash_attention_wgmma_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.flash_attention_wgmma_launch.restype = ctypes.c_int
    lib.flash_attention_wgmma_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_wgmma_error_string.restype = ctypes.c_char_p
    lib.flash_attention_wgmma_kernel_attrs.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_wgmma_kernel_attrs.restype = ctypes.c_char_p
    return lib


def wgmma_kernel_attrs() -> dict:
    """The tensor-core lane's instantiations as compiled, by name: "DkxDv"
    for inference, with " prefix" (PaliGemma's prefix-LM mask) and " lse"
    (training's log-sum-exp) where compiled with them, e.g. "256x256
    prefix lse". Each maps to its "registers" a thread, "shared" bytes a
    block (static and a launch's dynamic), "local" (spilled) bytes a
    thread and resident "blocks" an SM, as the CUDA runtime reports them.
    Needs the card; launches nothing."""
    lib = _wgmma_lib()
    out = (ctypes.c_int * 4)()
    attrs, i = {}, 0
    while (name := lib.flash_attention_wgmma_kernel_attrs(i, out)):
        attrs[name.decode()] = dict(zip(
            ("registers", "shared", "local", "blocks"), out))
        i += 1
    return attrs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    prefix_len: int = 0, return_lse: bool = False):
    """Attention on the card.

    q: (B, H, S, Dk); k: (B, Hkv, T, Dk); v: (B, Hkv, T, Dv) with
    H % Hkv == 0, all float32 or all bfloat16, contiguous, on one CUDA
    device; 1 <= Dk, Dv <= 256, any S and T. causal masks top-left (row i
    sees columns j <= i) and, with prefix_len > 0, lets every row see the
    columns j < prefix_len as well (without causal the prefix changes
    nothing); window (None, or >= 1 with S <= T + window - 1 so that every
    row sees a column) keeps columns j > i - window. scale defaults to
    Dk ** -0.5. Returns (B, H, S, Dv) in q's dtype. The lane is
    `kernel_lane(q.dtype, Dk, Dv)`; the tensor-core lane also needs q, k
    and v on 16-byte boundaries. return_lse=True (either lane) returns
    (o, lse) with lse (B, H, S) float32, each row's base-2 log-sum-exp of
    its scaled scores, log2(sum_j exp2(scale log2(e) q_i . k_j)), for the
    backward; o is the same, bit for bit, with and without it.

    On meta tensors (the meta lane) it checks and allocates as on the card
    and books its launch (`kernels.book`: "fwd", and "wgmma" on the
    tensor-core lane, with `analysis.bounds.attention_cost`'s FLOPs and
    bytes) in place of launching it.
    """
    B, H, S, Dk, Hkv, T, Dv = _check_fwd(q, k, v)
    check_prefix(prefix_len)
    lane = kernel_lane(q.dtype, Dk, Dv)
    o = q.new_empty((B, H, S, Dv))
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0 or T == 0:
        o.zero_()
        return (o, lse.zero_()) if return_lse else o
    check_window(S, T, window)
    scale = Dk ** -0.5 if scale is None else float(scale)
    win = 0 if window is None else int(window)  # 0: no window
    # the prefix only widens the causal mask
    prefix = min(int(prefix_len), T) if causal else 0
    if q.is_meta:
        from ...analysis.bounds import attention_cost, dtype_name
        book("flash_attention", {"fwd": 1, "wgmma": int(lane == "wgmma")},
             *attention_cost(B, H, S, T, Dk, Dv, Hkv, q.element_size(),
                             dtype_name(q.dtype), causal, window, prefix))
        return (o, lse) if return_lse else o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if lane == "wgmma":
            check_aligned(q=q, k=k, v=v, o=o)
            lib = _wgmma_lib()
            err = lib.flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), B, H, Hkv, S, T, Dk,
                Dv, scale, int(causal), win, prefix, stream)
            error_string = lib.flash_attention_wgmma_error_string
        else:
            vec = _vec(Dk, Dv, q, k, v, o)
            lib = _lib()
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), B, H, Hkv, S, T, Dk,
                Dv, scale, int(causal), win, prefix,
                int(q.dtype == torch.bfloat16), int(vec), stream)
            error_string = lib.flash_attention_error_string
    if err != 0:
        raise RuntimeError(f"flash_attention ({lane} lane) launch failed: "
                           f"error {err} ({error_string(err).decode()})")
    LAUNCHES["fwd"] += 1
    if lane == "wgmma":
        LAUNCHES["wgmma"] += 1
    return (o, lse) if return_lse else o


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    lib.flash_attention_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_wgmma_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd_wgmma")
    lib.flash_attention_bwd_wgmma_workspace_bytes.argtypes = (
        [ctypes.c_int] * 7)
    lib.flash_attention_bwd_wgmma_workspace_bytes.restype = ctypes.c_longlong
    lib.flash_attention_bwd_wgmma_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.flash_attention_bwd_wgmma_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_wgmma_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_wgmma_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        window: Optional[int] = None, prefix_len: int = 0,
                        lse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `flash_attention` on the card: (dq, dk, dv) in the
    inputs' dtype and shapes, given its inputs, its output o and dO, the
    gradient of the loss with respect to o (B, H, S, Dv). The same
    arguments and checks as `flash_attention`, o and dO of q's dtype and
    contiguous too. lse: None, or the forward's (B, H, S) float32 from
    `flash_attention(..., return_lse=True)`, which either lane reads in
    place of rebuilding it. The lane is `bwd_lane(q.dtype, Dk, Dv)`;
    counted once in LAUNCHES["bwd"] (and in LAUNCHES["bwd_wgmma"] on the
    tensor-core lane), whatever its launches; a float32 workspace from
    torch.empty (`bwd_workspace_numel`). On meta tensors the call
    allocates as on the card (the workspace at an H100's SMs) and is
    booked ("bwd", and "bwd_wgmma" on the tensor-core lane, with
    `analysis.bounds.flash_bwd_cost`) in place of launched."""
    B, H, S, Dk, Hkv, T, Dv = _check_bwd(q, k, v, o, do, lse)
    check_prefix(prefix_len)
    if B == 0 or S == 0 or T == 0:
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    check_window(S, T, window)
    scale = Dk ** -0.5 if scale is None else float(scale)
    win = 0 if window is None else int(window)
    prefix = min(int(prefix_len), T) if causal else 0
    lane = bwd_lane(q.dtype, Dk, Dv)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # the SMs size the tensor-core lane's head splits only
    sms = _sm_count(q.device) if lane == "wgmma" else None
    work = torch.empty(bwd_workspace_numel(B, H, Hkv, S, T, Dk, Dv, lane,
                                           sms),
                       dtype=torch.float32, device=q.device)
    if q.is_meta:
        from ...analysis.bounds import dtype_name, flash_bwd_cost
        book("flash_attention", {"bwd": 1, "bwd_wgmma": int(lane == "wgmma")},
             *flash_bwd_cost(B, H, S, T, Dk, Dv, Hkv, q.element_size(),
                             dtype_name(q.dtype), causal, window, prefix))
        return dq, dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if lane == "wgmma":
            check_aligned(q=q, k=k, v=v, o=o, do=do)
            lib = _bwd_wgmma_lib()
            err = lib.flash_attention_bwd_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), None if lse is None else lse.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
                B, H, Hkv, S, T, Dk, Dv, scale, int(causal), win, prefix,
                stream)
            error_string = lib.flash_attention_bwd_wgmma_error_string
        else:
            vec = _vec(Dk, Dv, q, k, v, o, do)
            lib = _bwd_lib()
            err = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), None if lse is None else lse.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
                B, H, Hkv, S, T, Dk, Dv, scale, int(causal), win, prefix,
                int(q.dtype == torch.bfloat16), int(vec), stream)
            error_string = lib.flash_attention_bwd_error_string
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd ({lane} lane) launch "
                           f"failed: error {err} "
                           f"({error_string(err).decode()})")
    LAUNCHES["bwd"] += 1
    if lane == "wgmma":
        LAUNCHES["bwd_wgmma"] += 1
    return dq, dk, dv

