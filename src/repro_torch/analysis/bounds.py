"""The work and the bytes of one call of each LM kernel, and its bound on
one H100: the one copy of these formulas. `chip_smoke.py` holds each
kernel's time against the bound computed here, and each kernel's meta lane
books a call's FLOPs and bytes by the same functions, so the kernel table's
bound and the dry run's count are one piece of code.

A call's bytes are its inputs read once and its outputs written once; its
work is the function's own operations (not what a kernel's design adds,
such as the SSD's split TF32 products), by the rate it is priced at:
"bfloat16" on the tensor cores, "tfloat32" for products with a float32
operand on the tensor cores, "float32" on the CUDA cores. A bound is the
larger of the bytes at the HBM rate and the work at its peak
(`roofline.from_counts`).

    attention  2 (Dk + Dv) FLOP a (query, key) pair the mask allows, a head
    flash bwd  4 (Dk + Dv) FLOP a pair (dP = dO v^T, dS k, dS^T q, P^T dO)
    ssd scan   its four products, causal halves once (`ssd_products`)
    ssd bwd    the products of SSD_BWD_PRODUCTS by operand type
    ssd step   3 float32 multiply-adds a state element
    rglru      RGLRU_FLOPS_PER_ELEMENT (forward and step) and
               RGLRU_BWD_FLOPS_PER_ELEMENT float32 operations an element
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np

from .roofline import H100_HBM_BW, H100_PEAK_FLOPS, from_counts

Cost = Tuple[Dict[str, float], float]    # ({dtype: FLOPs}, bytes)


def roofline_ms(flops: float, nbytes: float,
                dtype: str) -> Tuple[float, str]:
    """Least time (ms) for work of `flops` operations of `dtype` moving
    `nbytes` on one H100, the larger of the two terms of the port's
    roofline (NVIDIA's data-sheet peaks), and which term it is:
    (ms, "bytes" | "operations")."""
    r = from_counts(flops, nbytes, dtype=dtype)
    return (r.bound_s * 1e3,
            "bytes" if r.memory_s >= r.compute_s else "operations")


def cost_ms(cost: Cost) -> Tuple[float, str]:
    """The bound (ms, "bytes" | "operations") of a cost whose work is
    priced by type, each group after the other."""
    work, nbytes = cost
    ops_s = sum(f / H100_PEAK_FLOPS[dt] for dt, f in work.items())
    bytes_s = nbytes / H100_HBM_BW
    return max(ops_s, bytes_s) * 1e3, ("bytes" if bytes_s >= ops_s
                                       else "operations")


def dtype_name(dtype) -> str:
    """"bfloat16", "float32", ... of a torch dtype."""
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------- attention
@functools.lru_cache(maxsize=256)
def attention_pairs(S: int, T: int, causal: bool,
                    window: Optional[int] = None, prefix: int = 0) -> int:
    """The allowed (query, key) pairs of one head: row i sees keys j < T
    with j <= i or j < prefix where causal (top-left; a prefix-LM's prefix
    is seen by every row), and j > i - window where a window is given."""
    i = np.arange(S)
    hi = (np.minimum(np.maximum(i + 1, prefix), T) if causal
          else np.full(S, T))
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(S, int)
    return int(np.maximum(hi - lo, 0).sum())


def attention_cost(B: int, H: int, S: int, T: int, Dk: int, Dv: int,
                   Hkv: int, itemsize: int, dtype: str, causal: bool,
                   window: Optional[int] = None, prefix: int = 0) -> Cost:
    """One attention call: q (B, H, S, Dk), k (B, Hkv, T, Dk) and v (B, Hkv,
    T, Dv) read once, o (B, H, S, Dv) written once; 2 (Dk + Dv) FLOP an
    allowed pair and head, at `dtype`'s rate."""
    flops = 2.0 * B * H * (Dk + Dv) * attention_pairs(S, T, causal, window,
                                                      prefix)
    nbytes = (B * H * S * Dk + B * Hkv * T * (Dk + Dv)
              + B * H * S * Dv) * itemsize
    return {dtype: flops}, float(nbytes)


def attention_flops(q, k, causal, window=None, prefix=0, dv=None) -> float:
    """The work of one attention call on these operands: 2 (Dk + Dv) flops
    per allowed (query, key) pair and head (q k^T and p v; 4 D where
    Dv = Dk)."""
    B, H, S, D = q.shape
    dv = D if dv is None else dv
    return 2.0 * B * H * (D + dv) * attention_pairs(S, k.shape[2], causal,
                                                    window, prefix)


def attention_bound(q, k, v, causal, window=None, prefix=0):
    """Least time (ms) for one attention call on these operands
    (`attention_cost`): dense bf16 on the tensor cores, float32 on the CUDA
    cores."""
    B, H, S, Dk = q.shape
    _, Hkv, T, _ = k.shape
    cost = attention_cost(B, H, S, T, Dk, v.shape[-1], Hkv,
                          q.element_size(), dtype_name(q.dtype), causal,
                          window, prefix)
    return roofline_ms(sum(cost[0].values()), cost[1], dtype_name(q.dtype))


def flash_bwd_cost(B: int, H: int, S: int, T: int, Dk: int, Dv: int,
                   Hkv: int, itemsize: int, dtype: str, causal: bool = True,
                   window: Optional[int] = None, prefix: int = 0) -> Cost:
    """One backward call: q, k, v, o and dO read and dq, dk, dv written
    once; 4 (Dk + Dv) FLOP an allowed pair and head, at `dtype`'s rate."""
    flops = 4.0 * B * H * (Dk + Dv) * attention_pairs(S, T, causal, window,
                                                      prefix)
    nbytes = 2 * (B * H * S * Dk + B * Hkv * T * (Dk + Dv)) * itemsize + \
        2 * B * H * S * Dv * itemsize
    return {dtype: flops}, float(nbytes)


def flash_bwd_bound(q, k, v, causal=True, window=None, prefix=0):
    """Least time (ms) for one backward call on these operands
    (`flash_bwd_cost`)."""
    B, H, S, Dk = q.shape
    _, Hkv, T, _ = k.shape
    cost = flash_bwd_cost(B, H, S, T, Dk, v.shape[-1], Hkv,
                          q.element_size(), dtype_name(q.dtype), causal,
                          window, prefix)
    return roofline_ms(sum(cost[0].values()), cost[1], dtype_name(q.dtype))


# ----------------------------------------------------------------- SSD scan
def ssd_products(B, S, H, P, N, Q) -> Dict[str, int]:
    """Multiply-adds of each of the SSD scan's four products, causal halves
    counted once: per chunk of q steps, C B^T below the diagonal
    (q (q + 1) / 2 N), y's intra-chunk term (q (q + 1) / 2 H P), y's
    inter-chunk term and the chunk states (q N H P each)."""
    full, rest = divmod(S, Q)
    mac = dict(cb=0, intra=0, inter=0, state=0)
    for q, n in ((Q, full), (rest, 1 if rest else 0)):
        tri = q * (q + 1) // 2
        mac["cb"] += n * B * tri * N
        mac["intra"] += n * B * tri * H * P
        mac["inter"] += n * B * q * N * H * P
        mac["state"] += n * B * q * N * H * P
    return mac


def ssd_scan_work(B, S, H, P, N, Q) -> float:
    """Float32 operations of one SSD scan (`ssd_products`), 2 flops a
    multiply-add."""
    return 2.0 * sum(ssd_products(B, S, H, P, N, Q).values())


# TF32 tensor-core products the SSD kernel runs for each of its products
# with bf16 x, b, c (ssd_scan.cu's note): the float32 operand of a product
# is split in two, so 2 products where the other operand is bf16 (exact in
# TF32), 1 for C B^T; with float32 x the kernel runs on the CUDA cores
SSD_SPLIT = dict(cb=1, intra=2, inter=2, state=2)


def ssd_tf32_ops(B, S, H, P, N, Q) -> float:
    """TF32 operations of the SSD kernel's split products, bf16 x."""
    return 2.0 * sum(SSD_SPLIT[k] * m
                     for k, m in ssd_products(B, S, H, P, N, Q).items())


def ssd_scan_cost(B, S, H, P, N, Q, itemsize: int, bf16: bool) -> Cost:
    """One SSD scan over S > 1 steps: x, b, c, dt and a_log read once and y
    and the final state written once; the function's own operations at the
    tensor cores' TF32 rate with bf16 x (the rate of the kernel's
    products), on the CUDA cores with float32 x."""
    nbytes = (2 * B * S * H * P * itemsize + 2 * B * S * N * itemsize
              + B * S * H * 4 + H * 4 + B * H * P * N * 4)
    return ({"tfloat32" if bf16 else "float32": ssd_scan_work(B, S, H, P, N,
                                                             Q)},
            float(nbytes))


def ssd_bound(x, b, dt, chunk):
    """Least time (ms) of one SSD scan with bf16 x (`ssd_scan_cost`).
    Returns (ms, "bytes" | "operations", split_ms, f32_ms): split_ms the
    bound of the kernel's split products (`ssd_tf32_ops`, the cost of its
    float32 accuracy), f32_ms that of the function as float32 FMAs on the
    CUDA cores (the earlier, CUDA-core design's bound)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    work, nbytes = ssd_scan_cost(B, S, H, P, N, Q, x.element_size(), True)
    ms, by = roofline_ms(work["tfloat32"], nbytes, "tfloat32")
    split_ms, _ = roofline_ms(ssd_tf32_ops(B, S, H, P, N, Q), nbytes,
                              "tfloat32")
    f32_ms, _ = roofline_ms(work["tfloat32"], nbytes, "float32")
    return ms, by, split_ms, f32_ms


def ssd_step_cost(B, H, P, N, itemsize: int) -> Cost:
    """One SSD decode step (S = 1): the state read and written once
    (2 x B H P N x 4 bytes), x, b, c, dt and a_log read and y written,
    against 3 float32 multiply-adds a state element."""
    nbytes = (2 * B * H * P * N * 4 + 2 * B * H * P * itemsize
              + 2 * B * N * itemsize + B * H * 4 + H * 4)
    return {"float32": 6.0 * B * H * P * N}, float(nbytes)


def ssd_step_bound(x, b, h0):
    """Least time (ms) of one SSD decode step (`ssd_step_cost`)."""
    B, _, H, P = x.shape
    work, nbytes = ssd_step_cost(B, H, P, b.shape[-1], x.element_size())
    return roofline_ms(work["float32"], nbytes, "float32")


# the products the backward needs, in ssd_products' units, by the type of
# their operands. Both operands bf16 (the tensor cores' bf16 rate): C B^T
# again (cb) and dW = dy x^T (intra). An operand float32 (TF32's rate, the
# tensor cores' rate for 32-bit operands): dB and dC's
# intra-chunk terms dCB B and dCB^T C (cb each); W^T dy (intra); z = dy
# h_in^T, whose sums with C and over the heads give both y's inter-chunk
# term's dcum and dC's term (q N H more), and u = g B (inter each); the
# chunk states again, r = sum_t exp(cum_t) dy_t^T C_t and x^T g for dB's
# term over the heads (state each)
SSD_BWD_PRODUCTS = {"bfloat16": dict(cb=1, intra=1),
                    "tfloat32": dict(cb=2, intra=1, inter=2, state=3)}


def ssd_bwd_work(B, S, H, P, N, Q) -> Dict[str, float]:
    """Operations of one SSD backward by the rate they are priced at
    ("bfloat16", "tfloat32"), 2 flops a multiply-add: the products of
    SSD_BWD_PRODUCTS over `ssd_products`' causal counts."""
    mac = ssd_products(B, S, H, P, N, Q)
    return {dtype: 2.0 * sum(n * mac[k] for k, n in counts.items())
            for dtype, counts in SSD_BWD_PRODUCTS.items()}


def ssd_bwd_cost(B, S, H, P, N, Q, itemsize: int, bf16: bool) -> Cost:
    """One SSD backward: x, b, c, dt, a_log and dy read once and dx, db,
    dc, ddt and da_log written once; the backward's own operations
    (`ssd_bwd_work`) by the rate of their operands with bf16 x, all on the
    CUDA cores with float32 x."""
    nbytes = (3 * B * S * H * P * itemsize + 4 * B * S * N * itemsize
              + 2 * B * S * H * 4 + 2 * H * 4)
    work = ssd_bwd_work(B, S, H, P, N, Q)
    if not bf16:
        work = {"float32": sum(work.values())}
    return work, float(nbytes)


def ssd_bwd_bound(x, b, dt, chunk):
    """Least time (ms) of one SSD backward with bf16 x (`ssd_bwd_cost`),
    each group of products at its own peak, one group after the other.
    Returns (ms, "bytes" | "operations")."""
    B, S, H, P = x.shape
    return cost_ms(ssd_bwd_cost(B, S, H, P, b.shape[-1], min(chunk, S),
                                x.element_size(), True))


# ------------------------------------------------------------------ RG-LRU
# float32 operations of the RG-LRU per element: two sigmoids (add, exp,
# add, divide), log_a (two multiplies), exp, exp(2 log_a), 1 - ., max,
# sqrt, three multiplies and the recurrence's fma; log_sigmoid(lam) is per
# channel
RGLRU_FLOPS_PER_ELEMENT = 20
# float32 operations of the RG-LRU backward per element: the gates again
# (two sigmoids, log a, a, a^2, m, dm/d(log a): ~18), the carry (2),
# d(log a) (6), dga and dgi (10), du (2), the sums (4), the composites (3)
RGLRU_BWD_FLOPS_PER_ELEMENT = 45


def rglru_cost(B, S, W, itemsize: int, h0: bool) -> Cost:
    """One RG-LRU scan (or step, S = 1): u (its dtype), the two float32
    gate inputs and the float32 h out moved once, 14 bytes an element with
    bf16 u, b_a, b_i and lam read (and h0, where given), against
    RGLRU_FLOPS_PER_ELEMENT float32 operations an element."""
    n = B * S * W
    nbytes = n * (itemsize + 4 + 4 + 4) + 3 * W * 4 + (B * W * 4 if h0
                                                        else 0)
    return {"float32": float(RGLRU_FLOPS_PER_ELEMENT * n)}, float(nbytes)


def rglru_bound(u, h0=None):
    """Least time (ms) of one RG-LRU scan (`rglru_cost`)."""
    B, S, W = u.shape
    work, nbytes = rglru_cost(B, S, W, u.element_size(), h0 is not None)
    return roofline_ms(work["float32"], nbytes, "float32")


def rglru_bwd_cost(B, S, W, itemsize: int, h0: bool) -> Cost:
    """One RG-LRU backward: u, ga, gi, h and dh read and du, dga and dgi
    written once (28 bytes an element with bf16 u), b_a, b_i and lam read
    and their gradients written (and h0 read, dh0 written, where given),
    against RGLRU_BWD_FLOPS_PER_ELEMENT float32 operations an element."""
    n = B * S * W
    nbytes = 2 * n * (itemsize + 4 + 4) + 2 * n * 4 + 6 * W * 4 + (
        2 * B * W * 4 if h0 else 0)
    return ({"float32": float(RGLRU_BWD_FLOPS_PER_ELEMENT * n)},
            float(nbytes))


def rglru_bwd_bound(u, h0=None):
    """Least time (ms) of one RG-LRU backward (`rglru_bwd_cost`)."""
    B, S, W = u.shape
    work, nbytes = rglru_bwd_cost(B, S, W, u.element_size(), h0 is not None)
    return roofline_ms(work["float32"], nbytes, "float32")
