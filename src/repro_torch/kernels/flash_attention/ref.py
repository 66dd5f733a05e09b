"""Plain PyTorch versions of the flash-attention kernels: the forward and
its gradient, each in one pass over the full score matrix."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
LOG2E = math.log2(math.e)


def check_window(S: int, T: int, window: Optional[int]) -> None:
    """Raise for a window the kernels do not take: window < 1, or one so
    narrow that a row sees no column (row i sees j > i - window, j < T, so
    every row sees one only while S <= T + window - 1)."""
    if window is None:
        return
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if S > T + window - 1:
        raise ValueError(f"window {window} leaves rows >= {T + window - 1} "
                         f"of S = {S} without a column (T = {T})")


def check_prefix(prefix_len: int) -> None:
    """Raise for a negative prefix length."""
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """float64 for float64 inputs (gradcheck), else float32."""
    return torch.promote_types(t.dtype, torch.float32)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, scale: float,
            window: Optional[int], prefix_len: int) -> torch.Tensor:
    """The masked scores scale q k^T (B, Hkv, G, S, T) in the compute
    dtype, masked entries -1e30."""
    B, H, S, Dk = q.shape
    _, Hkv, T, _ = k.shape
    cd = _compute_dtype(q)
    qg = q.to(cd).reshape(B, Hkv, H // Hkv, S, Dk)
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.to(cd)) * scale
    if causal or window is not None:
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
        if causal:
            ok = cols <= rows
            if prefix_len:
                ok = ok | (cols < prefix_len)
        if window is not None:
            ok = ok & (cols > rows - window)
        s = s.masked_fill(~ok, NEG_INF)
    return s


def _softmax_parts(s: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Of scores s: each row's max m, exp(s - m), and its row sums l (a
    sum of 0 replaced by 1), all with a kept last axis."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return m, p, torch.where(l == 0.0, torch.ones_like(l), l)


def _lse2(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Each row's base-2 log-sum-exp from its max and sum, the quantity
    the tensor-core kernels save: (m + ln l) log2(e)."""
    return (m + torch.log(l)) * LOG2E


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        window: Optional[int] = None,
                        prefix_len: int = 0, return_lse: bool = False):
    """q: (B, H, S, Dk); k: (B, Hkv, T, Dk); v: (B, Hkv, T, Dv) with
    H % Hkv == 0; query head h reads kv head h // (H // Hkv). Math in
    float32 (float64 for float64 inputs). The mask is the JAX package's
    `_mask`: causal keeps `cols <= rows` (aligned top-left for any S and
    T) or, with a prefix, `cols < prefix_len` too (a prefix-LM: the prefix
    attends both ways); a window then keeps only `cols > rows - window`;
    without causal the prefix changes nothing. Masked scores are -1e30 and
    a row whose denominator is 0 divides by 1. Returns (B, H, S, Dv) in
    q's dtype; with return_lse, (o, lse) and lse (B, H, S) in the compute
    dtype, each row's base-2 log-sum-exp of its masked scaled scores (as
    the tensor-core kernel returns it; 0 where T = 0)."""
    B, H, S, Dk = q.shape
    _, Hkv, T, _ = k.shape
    Dv = v.shape[-1]
    scale = Dk ** -0.5 if scale is None else scale
    check_prefix(prefix_len)
    if T == 0:
        o = q.new_zeros((B, H, S, Dv))
        lse = torch.zeros((B, H, S), dtype=_compute_dtype(q),
                          device=q.device)
        return (o, lse) if return_lse else o
    check_window(S, T, window)
    m, p, l = _softmax_parts(_scores(q, k, causal, scale, window,
                                     prefix_len))
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(p.dtype)) / l
    o = o.reshape(B, H, S, Dv).to(q.dtype)
    if return_lse:
        return o, _lse2(m, l).reshape(B, H, S)
    return o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, causal: bool = True,
                            scale: Optional[float] = None,
                            window: Optional[int] = None,
                            prefix_len: int = 0,
                            lse: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradient of `flash_attention_ref` written out in closed form
    over the full score matrix, in float32 (float64 for float64 inputs):
    given its inputs, its output o and do = dL/do (B, H, S, Dv),

        P = exp2(log2(e) scale q k^T - lse) (masked: softmax(scale q k^T)),
        dP = do v^T, Delta = rowsum(do o), dS = P (dP - Delta),
        dq = scale dS k, dk = scale dS^T q, dv = P^T do,

    dk and dv of a kv head summed over its G query heads; lse (B, H, S),
    each row's base-2 log-sum-exp, is the given one (the forward's
    `return_lse`) or, when None, rebuilt as the forward forms it, so that
    the forward's lse gives the same bits as none. Returns (dq, dk, dv) in
    the dtypes of q, k and v. The plain version of the backward kernels
    (`flash_attention_bwd`)."""
    B, H, S, Dk = q.shape
    _, Hkv, T, _ = k.shape
    Dv = v.shape[-1]
    G = H // Hkv
    scale = Dk ** -0.5 if scale is None else scale
    check_prefix(prefix_len)
    if T == 0 or S == 0:
        return q.new_zeros(q.shape), k.new_zeros(k.shape), v.new_zeros(v.shape)
    check_window(S, T, window)
    s = _scores(q, k, causal, scale, window, prefix_len)
    cd = s.dtype
    if lse is None:
        m, _, l = _softmax_parts(s)
        lse2 = _lse2(m, l)
    else:
        lse2 = lse.to(cd).reshape(B, Hkv, G, S, 1)
    p = torch.exp2(s * LOG2E - lse2)
    qg = q.to(cd).reshape(B, Hkv, G, S, Dk)
    dog = do.to(cd).reshape(B, Hkv, G, S, Dv)
    delta = (dog * o.to(cd).reshape(B, Hkv, G, S, Dv)).sum(-1, keepdim=True)
    dp = torch.einsum("bhgsd,bhtd->bhgst", dog, v.to(cd))
    ds = p * (dp - delta)
    dq = torch.einsum("bhgst,bhtd->bhgsd", ds, k.to(cd)) * scale
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds, qg) * scale
    dv = torch.einsum("bhgst,bhgsd->bhtd", p, dog)
    return (dq.reshape(B, H, S, Dk).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
