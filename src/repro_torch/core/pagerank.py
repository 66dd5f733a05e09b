"""PageRank solvers (paper §3): synchronous power method (eq. 4) and the
linear-system Jacobi/Richardson iteration derived from eq. (2), in PyTorch.

The per-iteration operator apply is delegated to a backend (core.backend):
`segment_sum` or `bsr` (hub-split block-CSR through the hand-written CUDA
kernel). Both solvers accept (n, nv) teleport/initial stacks, solving nv
personalized PageRank problems in one fused loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.google import GoogleOperator
from .backend import (BackendMeta, BackendSpec, as_lane_tol, as_spec,
                      from_layout, google_apply, l1_residual, prepare,
                      take_lanes)


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray                 # (n,) or (n, nv) normalized iterate(s)
    iters: int
    resid_l1: float               # max over lanes
    resid_per_vec: Optional[np.ndarray] = None  # (nv,) when nv > 1
    lane_iters: Optional[np.ndarray] = None     # (nv,) iterations per lane
                                                # (differs under freezing)


def _solve_loop(dev: dict, x: torch.Tensor, tol: np.ndarray,
                meta: BackendMeta, linear: bool, max_iters: int):
    """Fixed-point loop: the iterate never leaves the backend layout (for
    bsr that is the padded (nbr, bm, nv) block layout). Runs while any
    lane's residual exceeds its `tol` (compared in the iterate's dtype, as
    the JAX package's while_loop compares), at most `max_iters` applies.

    The per-lane residual is read back to the host after every apply, so
    the iteration count matches the JAX package's exactly; that sync is
    the loop's price on the card.
    """
    tol_t = torch.as_tensor(tol, device=x.device).to(x.dtype)
    resid = torch.full((meta.nv,), float("inf"), dtype=x.dtype,
                       device=x.device)
    it = 0
    while it < max_iters and bool((resid > tol_t).any()):
        y = google_apply(meta, dev, x, linear)
        resid = l1_residual(y, x)
        x = y
        it += 1
    return x, resid, it


def _pow2(k: int) -> int:
    return 1 << max(k - 1, 0).bit_length()


# recheck cadences the adaptive driver may pick (the JAX package bounds its
# jit cache with this menu; the port keeps it so both pick the same chunks)
_CHUNK_MENU = (8, 16, 32, 64, 128, 256)


def _adapt_chunk(prev_resid, resid, it: int, tol, fallback: int) -> int:
    """Next recheck cadence from the observed per-lane convergence spread.

    Each surviving lane's geometric decay rate over the last chunk
    extrapolates to a predicted iterations-to-tol; the next host recheck
    lands just past the *fastest* survivor's predicted crossing — the
    earliest moment a freeze (and possibly a pow2 compaction) can pay.
    `tol` may be a scalar or the survivors' per-lane threshold array.
    """
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        rate = (resid / prev_resid) ** (1.0 / max(it, 1))
        need = np.log(tol / resid) / np.log(rate)
    need = need[np.isfinite(need) & (need > 0)]
    if need.size == 0:              # stalled / non-contracting estimates
        return fallback
    k = 1.25 * float(need.min()) + 1.0   # margin: rates drift chunk-to-chunk
    for c in _CHUNK_MENU:
        if c >= k:
            return c
    return _CHUNK_MENU[-1]


def _solve_frozen(dev, x_dev, meta: BackendMeta, linear: bool,
                  tol: np.ndarray, max_iters: int, chunk):
    """Chunked driver that freezes converged lanes out of the fused apply.

    The fused loop only guarantees each lane's residual <= tol (it stops at
    max-over-lanes), so freezing a lane once its residual crosses tol keeps
    the solver contract — fast lanes stop paying for the slowest one. Lanes
    are compacted at power-of-two stack widths (padding duplicates an
    active lane).

    `chunk` is the host recheck cadence: an int pins a fixed count, "auto"
    adapts it to the observed per-lane iteration spread (see
    `_adapt_chunk`) — the first chunk is a fixed probe, every later one is
    scheduled at the fastest survivor's predicted tol crossing.
    """
    nv = meta.nv
    n = meta.n
    adaptive = chunk == "auto"
    cur = 32 if adaptive else max(int(chunk), 1)
    x_out = np.empty((n, nv))
    resid_out = np.full(nv, np.inf)
    lane_iters = np.zeros(nv, dtype=np.int64)
    active = np.arange(nv)          # lane ids at stack positions 0..k-1
    width = _pow2(nv)
    stack_tol = tol.copy()          # per-lane threshold at stack positions
    if width > nv:
        pad = np.concatenate([np.arange(nv),
                              np.zeros(width - nv, np.int64)])
        dev, meta, x_dev = take_lanes(meta, dev, x_dev, pad)
        stack_tol = stack_tol[pad]
    it_total = 0
    prev_resid = None               # survivors' residuals a chunk ago
    while True:
        step = min(cur, max_iters - it_total)
        x_dev, resid_dev, it = _solve_loop(dev, x_dev, stack_tol, meta,
                                           linear, step)
        it_total += it
        lane_iters[active] += it
        resid_np = resid_dev.cpu().numpy().astype(np.float64)[:active.size]
        done = resid_np <= tol[active]
        if done.all() or it_total >= max_iters:
            x_np = from_layout(meta, x_dev)
            x_out[:, active] = x_np[:, :active.size]
            resid_out[active] = resid_np
            break
        if adaptive and it > 0:
            if prev_resid is not None:
                cur = _adapt_chunk(prev_resid[~done], resid_np[~done],
                                   it, tol[active][~done], cur)
            prev_resid = resid_np
        new_width = _pow2(int((~done).sum()))
        if done.any() and new_width < width:
            # freeze + compact: record the converged lanes, keep the rest
            frozen = active[done]
            x_np = from_layout(meta, x_dev)
            x_out[:, frozen] = x_np[:, :active.size][:, done]
            resid_out[frozen] = resid_np[done]
            keep_pos = np.flatnonzero(~done)
            active = active[~done]
            if prev_resid is not None:
                prev_resid = prev_resid[~done]
            idx = np.concatenate([keep_pos,
                                  np.full(new_width - keep_pos.size,
                                          keep_pos[0], np.int64)])
            dev, meta, x_dev = take_lanes(meta, dev, x_dev, idx)
            stack_tol = stack_tol[idx]
            width = new_width
        # lanes at <= tol that do not trigger a compaction stay in the
        # stack (their slots exist anyway) and keep improving for free
    return x_out, resid_out, it_total, lane_iters


def solve_power(op: GoogleOperator, x0: Optional[np.ndarray] = None,
                tol: float = 1e-9, max_iters: int = 1000,
                dtype: torch.dtype = torch.float64,
                backend: Union[str, BackendSpec] = "segment_sum",
                v: Optional[np.ndarray] = None,
                reorder: Optional[str] = None,
                freeze_lanes: Union[bool, str] = "auto",
                freeze_chunk: Union[int, str] = "auto",
                device: DeviceLike = None) -> SolveResult:
    """Normalization-free power method x <- G x (eq. 4).

    No per-step normalization is needed: G is column-stochastic so ||x||_1
    is invariant (paper §3).

    `device=None` runs on the CUDA card and raises without one. `dtype` is
    the segment_sum working dtype; `backend="bsr"` (alias "bsr_pallas") is
    float32 end to end (L1 residuals floor near 1e-7). `v`/`x0` may be
    (n, nv) stacks — nv personalized PageRank problems share every operator
    load. `reorder` ("rcm" | "indeg") solves in a block-densifying page
    permutation and maps the answer back. `tol` may be a scalar or an (nv,)
    per-lane array.

    `freeze_lanes` masks already-converged lanes out of the fused apply
    (chunked driver, power-of-two lane compaction); "auto" enables it from
    nv >= 8. Every lane still stops at residual <= tol. `freeze_chunk` sets
    the host recheck cadence: an int pins a fixed count, "auto" adapts it
    to the observed per-lane iteration spread.
    """
    return _solve(op, x0, tol, max_iters, linear=False, dtype=dtype,
                  backend=backend, v=v, reorder=reorder,
                  freeze_lanes=freeze_lanes, freeze_chunk=freeze_chunk,
                  device=device)


def solve_linear(op: GoogleOperator, x0: Optional[np.ndarray] = None,
                 tol: float = 1e-9, max_iters: int = 1000,
                 dtype: torch.dtype = torch.float64,
                 backend: Union[str, BackendSpec] = "segment_sum",
                 v: Optional[np.ndarray] = None,
                 reorder: Optional[str] = None,
                 freeze_lanes: Union[bool, str] = "auto",
                 freeze_chunk: Union[int, str] = "auto",
                 device: DeviceLike = None) -> SolveResult:
    """Jacobi/Richardson on (I - R) x = b (eq. 2 / eq. 7 sync form); the
    arguments are those of `solve_power`."""
    return _solve(op, x0, tol, max_iters, linear=True, dtype=dtype,
                  backend=backend, v=v, reorder=reorder,
                  freeze_lanes=freeze_lanes, freeze_chunk=freeze_chunk,
                  device=device)


def _reordered(op: GoogleOperator, method: str):
    """Memoized (reordered op, perm) so repeated solves do not re-permute
    the graph or re-pack its BSR blocks."""
    from ..graph.reorder import reorder_operator
    cache = op._cache()
    key = ("reorder", method)
    if key not in cache:
        cache[key] = reorder_operator(op, method)
    return cache[key]


def _solve(op, x0, tol, max_iters, linear, dtype, backend="segment_sum",
           v=None, reorder=None, freeze_lanes="auto", freeze_chunk="auto",
           device=None) -> SolveResult:
    device = resolve_device(device)
    spec = as_spec(backend, device)
    squeeze = ((x0 is None or np.ndim(x0) == 1)
               and (v is None or np.ndim(v) == 1)
               and (v is not None or op.v is None or np.ndim(op.v) == 1))

    perm = None
    if reorder is not None:
        op, perm = _reordered(op, reorder)
        if v is not None:
            v = np.asarray(v, dtype=np.float64)
            vp = np.empty_like(v)
            vp[perm] = v
            v = vp
        if x0 is not None:
            x0 = np.asarray(x0, dtype=np.float64)
            xp = np.empty_like(x0)
            xp[perm] = x0
            x0 = xp

    dev, meta, x0_dev = prepare(op, spec, dtype=dtype, v=v, x0=x0,
                                device=device)
    tol_vec = as_lane_tol(tol, meta.nv)
    freeze = (meta.nv >= 8 if freeze_lanes == "auto"
              else bool(freeze_lanes)) and meta.nv > 1
    if freeze:
        x, resid, iters, lane_iters = _solve_frozen(
            dev, x0_dev, meta, linear, tol_vec, max_iters, freeze_chunk)
    else:
        x_dev, resid_dev, iters = _solve_loop(dev, x0_dev, tol_vec, meta,
                                              linear, max_iters)
        x = from_layout(meta, x_dev)
        resid = resid_dev.cpu().numpy().astype(np.float64)
        lane_iters = np.full(meta.nv, iters, dtype=np.int64)

    if perm is not None:
        x = x[perm]
    s = x.sum(axis=0)
    x = np.where(s > 0, x / np.where(s > 0, s, 1.0), x)
    nv = x.shape[1]
    if squeeze and nv == 1:
        x = x[:, 0]
    return SolveResult(x=x, iters=int(iters), resid_l1=float(resid.max()),
                       resid_per_vec=resid if nv > 1 else None,
                       lane_iters=lane_iters)


def rank_of(x: np.ndarray) -> np.ndarray:
    """Page ranking (descending PageRank value) — what matters for
    retrieval (paper §5.2: 'what is important are not the accurate values
    ... but their relative ranking')."""
    return np.argsort(-x, kind="stable")


def kendall_tau_topk(x: np.ndarray, y: np.ndarray, k: int = 1000) -> float:
    """Kendall-tau-b between two rankings restricted to the union of their
    top-k pages."""
    import scipy.stats as st
    top = np.union1d(rank_of(x)[:k], rank_of(y)[:k])
    tau, _ = st.kendalltau(x[top], y[top])
    return float(tau)
