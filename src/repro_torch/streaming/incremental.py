"""Incremental PageRank: push-based residual diffusion on evolving graphs
(the JAX package's streaming/incremental.py; the pushes, the seeding and
the exact residual are its numpy, copied, and the solves run on the port's
backends, on the card unless the caller passes `device="cpu"`).

The linear form of the paper (eq. 2) solves (I - alpha S) x = b with
b = (1 - alpha) v and S = P^T + w d^T column-stochastic.  For any iterate x
define the residual

    r = b + alpha S x - x        (so  x* = x + (I - alpha S)^{-1} r).

Since ||S||_1 = 1, the certification bound

    ||x - x*||_1  <=  ||r||_1 / (1 - alpha)                       (cert)

holds unconditionally — every state this module returns carries it.

A graph delta perturbs only the transition *columns* of sources whose
out-row changed, so the residual of the previous solution against the new
operator is the previous residual plus a sparse seed:

    r_new = r_prev + alpha * sum_{u touched} x[u] (col_new(u) - col_old(u))
            [+ uniform terms when n or the dangling set changes]

`update_ranks` seeds exactly those rows and drains the residual with
Gauss-Southwell/queue pushes (Hong et al., 1501.06350 "D-Iteration"; the
randomized-order convergence is Ishii & Tempo, 1203.6599): popping node u
moves r_u into x_u and diffuses alpha*r_u/deg(u) to its out-neighbors.
Each push shrinks ||r||_1 by at least (1-alpha)|r_u|, so draining every
|r_u| >= eps = (1-alpha)*tol/n certifies ||x - x*||_1 <= tol without ever
touching the untouched part of the graph.  When the frontier exceeds a
fraction of n the batch is no longer local and the updater falls back to a
warm-started `solve_linear`/`solve_power` through `core.backend` (either
backend), then recovers the exact residual with one host-side apply.

What runs where.  The push path (`_push`, `_seed_delta`, the rescale
identity) and the certificate (`_exact_residual`, a host float64 scipy
apply) are host numpy: equal inputs give the reference's pushes, path and
bits, and the published certificate is the same recomputation.  The
device does the solves: `cold_state`, the fallback of `update_ranks` and
the lane solve of `ppr_push_batched` call the port's `solve_linear` /
`solve_power` with `device`, which on the card run the CSR segment-sum
kernel (`backend="segment_sum"`, float64 by default) or the block-CSR
kernel and its hub lane (`backend="bsr"`, alias "bsr_pallas").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..core.backend import as_lane_tol, seed_stack
from ..core.pagerank import solve_linear, solve_power
from ..device import DeviceLike, resolve_device
from ..graph.google import GoogleOperator
from ..runtime.schedule import make_schedule
from .delta import DeltaGraph, EdgeDelta


@dataclasses.dataclass
class RankState:
    """Mutable incremental-solver state: the rank estimate, its exactly
    maintained residual, and the graph version both are consistent with."""

    x: np.ndarray                    # (n,) float64 rank estimate
    r: np.ndarray                    # (n,) float64 residual b + aSx - x
    version: int
    alpha: float
    v: Optional[np.ndarray] = None   # None = uniform teleport

    @property
    def resid_l1(self) -> float:
        return float(np.abs(self.r).sum())

    @property
    def cert(self) -> float:
        """Certified L1 distance to the exact fixed point."""
        return self.resid_l1 / (1.0 - self.alpha)


@dataclasses.dataclass
class UpdateStats:
    path: str                 # "push" | "solve_linear" | "solve_power"
    pushes: int               # frontier pops (work of the push phase)
    nodes_visited: int        # distinct nodes popped
    frontier_peak: int
    seed_l1: float            # ||r||_1 right after seeding
    resid_l1: float           # ||r||_1 on return
    cert: float               # resid_l1 / (1 - alpha)
    solver_iters: int = 0     # fallback iterations (0 on the push path)
    # single-updater push decomposition (mirrors the sharded updater's
    # first/local/boundary attribution; with one shard there is no
    # boundary, so pops split into first visits and sweep re-pushes)
    pushes_first: int = 0     # distinct rows popped (== nodes_visited)
    pushes_repeat: int = 0    # re-pushes from the sweep order


def _exact_residual(dg: DeltaGraph, x: np.ndarray, alpha: float,
                    v: Optional[np.ndarray]) -> np.ndarray:
    """r = b + alpha S x - x via one host-side O(nnz) apply (scipy P^T is
    memoized per version on the DeltaGraph)."""
    op = dg.operator(alpha, v=v)
    y = op.apply_linear_numpy(x, pt_sp=dg.scipy_pt())
    return y - x


def _check_cert(resid_l1: float, tol: float, alpha: float,
                where: str) -> None:
    """The certificate is recomputed exactly, so a solver that stalled
    (e.g. bsr_pallas's f32 residual floor ~1e-7 asked for a tighter
    target) cannot silently violate the contract — it warns instead."""
    if resid_l1 > (1.0 - alpha) * tol:
        import warnings
        cert = resid_l1 / (1.0 - alpha)
        warnings.warn(
            f"{where} missed the residual target: certified L1 error "
            f"{cert:.2e} > tol {tol:.2e} (for bsr_pallas ask tol >= ~1e-5, "
            f"or raise solver_max_iters)", RuntimeWarning, stacklevel=3)


def cold_state(dg: DeltaGraph, alpha: float = 0.85,
               v: Optional[np.ndarray] = None, tol: float = 1e-9,
               backend: str = "segment_sum", method: str = "linear",
               max_iters: int = 2000, device: DeviceLike = None
               ) -> RankState:
    """Full solve on the current graph, returning a certified RankState.

    `tol` is the certified L1 error: the solver is driven to residual
    (1 - alpha) * tol, then the residual is recovered exactly. The solve
    runs on `device` (None: the CUDA card, raising without one)."""
    device = resolve_device(device)
    op = dg.operator(alpha, v=v)
    solver = solve_linear if method == "linear" else solve_power
    # 0.5x headroom: the solver renormalizes on exit, which perturbs the
    # residual by O(resid); the exact recomputation below must still land
    # under (1 - alpha) * tol.
    res = solver(op, tol=0.5 * (1.0 - alpha) * tol, max_iters=max_iters,
                 backend=backend, device=device)
    x = np.asarray(res.x, dtype=np.float64)
    r = _exact_residual(dg, x, alpha, v)
    _check_cert(float(np.abs(r).sum()), tol, alpha,
                f"cold_state[{backend}]")
    return RankState(x=x, r=r, version=dg.version, alpha=alpha, v=v)


def refresh_residual(dg: DeltaGraph, state: RankState) -> RankState:
    """Re-derive the residual exactly (drops any accumulated float error
    from long incremental chains)."""
    if state.version != dg.version:
        raise ValueError("state is stale; apply pending deltas through "
                         "update_ranks first")
    state.r = _exact_residual(dg, state.x, state.alpha, state.v)
    return state


# ---------------------------------------------------------------------------
# the push kernel (shared by update_ranks, ppr_push and the sharded updater)
# ---------------------------------------------------------------------------
def _group_sums(dst: np.ndarray, val: np.ndarray, n: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Group duplicate indices of a contribution list: returns ``(uq,
    sums)`` — sorted unique indices and their summed values.  Dense
    `bincount` when the list is a sizable fraction of n, stable
    argsort + `reduceat` otherwise (the JAX package's grouped-scatter
    heuristic; shared by `_push` and `sharded._scatter_add`)."""
    if dst.size >= n // 4:
        adds = np.bincount(dst, weights=val, minlength=n)
        uq = np.flatnonzero(adds)
        return uq, adds[uq]
    order = np.argsort(dst, kind="stable")
    ds, vs = dst[order], val[order]
    head = np.ones(ds.size, dtype=bool)
    head[1:] = ds[1:] != ds[:-1]
    uq = ds[head]
    return uq, np.add.reduceat(vs, np.flatnonzero(head))


def _view_arrays(view) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray,
                                np.ndarray, np.ndarray, np.ndarray]:
    """Normalize a graph view (DeltaGraph or FrozenGraphView) to the arrays
    the batched sweep gathers from: (base_indptr, base_indices, base_n,
    dirty_rows, out_deg, dirty_indptr, dirty_indices).  `dirty_rows`
    (sorted) are sources with overlay edits; their merged out-rows are
    materialized *once* here as a packed CSR (`dirty_indptr`/
    `dirty_indices`, indexed by position in `dirty_rows`), so every sweep
    gathers dirty contributions with the same bucketed vector path as
    clean rows — no per-node python merges on the hot path (a 1% delta
    dirties thousands of rows, and the sharded drains re-sweep them every
    exchange generation).  Everything else gathers straight from the base
    CSR."""
    live = hasattr(view, "_base")
    base = view._base if live else view.base
    deg = view._out_deg if live else view.out_deg
    # overlay-free rows appended by node arrivals are dangling (deg 0) and
    # never gathered, so the base CSR covers every clean non-dangling row
    #
    # the dirty-row scan and merge are memoized per (view, version):
    # overlays only change when apply() bumps the version, and compact()
    # folds the overlay without changing any row's value — so repeated
    # drains at one version (and every ppr_push served against one frozen
    # snapshot) pay the python set/merge work once, not per call
    version = view.version
    cached = getattr(view, "_dirty_csr", None)
    if cached is not None and cached[0] == version:
        dirty_rows, dirty_indptr, dirty_indices = cached[1:]
    else:
        if live:                        # live DeltaGraph
            dirty = {u for u, s in view._add.items() if s} \
                | {u for u, s in view._del.items() if s}
        else:                           # FrozenGraphView
            dirty = {u for u, a in view.add.items() if a.size} \
                | {u for u, d in view.dels.items() if d.size}
        dirty_rows = np.fromiter(dirty, np.int64, len(dirty))
        dirty_rows.sort()
        if dirty_rows.size:
            merged = [view.out_neighbors(int(u)) for u in dirty_rows]
            dirty_indptr = np.zeros(dirty_rows.size + 1, dtype=np.int64)
            np.cumsum([m.size for m in merged], out=dirty_indptr[1:])
            dirty_indices = (np.concatenate(merged).astype(np.int64)
                             if dirty_indptr[-1] else np.empty(0, np.int64))
        else:
            dirty_indptr = np.zeros(1, dtype=np.int64)
            dirty_indices = np.empty(0, np.int64)
        # works for the live DeltaGraph and the frozen snapshot dataclass
        object.__setattr__(view, "_dirty_csr",
                           (version, dirty_rows, dirty_indptr,
                            dirty_indices))
    return (base.indptr, base.indices, base.n, dirty_rows, deg,
            dirty_indptr, dirty_indices)


def _frontier_contrib(arrays, frontier: np.ndarray, moved: np.ndarray,
                      alpha: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Out-neighbor contributions of one batched sweep: every frontier node
    u with out-degree d > 0 sends alpha*moved[u]/d to each out-neighbor —
    one bucketed gather straight from the base CSR for clean rows, and the
    same bucketed gather from the pre-merged dirty CSR (`_view_arrays`)
    for overlay-dirty rows.  Dangling mass is returned as a scalar for the
    caller's uniform-column handling.

    Returns (dst, val, dangling_mass): parallel contribution arrays plus
    the total mass moved out of dangling frontier nodes."""
    indptr, indices, base_n, dirty_rows, deg, d_indptr, d_indices = arrays
    fdeg = deg[frontier]
    dang = fdeg == 0
    clean = ~dang
    if dirty_rows.size:
        slot = np.searchsorted(dirty_rows, frontier)
        is_dirty = (slot < dirty_rows.size) \
            & (dirty_rows[np.minimum(slot, dirty_rows.size - 1)] == frontier)
        clean &= ~is_dirty
        dirty_here = np.flatnonzero(is_dirty & ~dang)
    else:
        slot = None
        dirty_here = np.empty(0, np.int64)

    # clean rows: one bucketed gather straight from the base CSR
    cf = frontier[clean]
    cnt = fdeg[clean]
    starts = indptr[cf]
    total = int(cnt.sum())
    pos = np.repeat(starts - np.concatenate([[0], np.cumsum(cnt)[:-1]]),
                    cnt) + np.arange(total)
    dst = indices[pos].astype(np.int64)
    val = np.repeat(alpha * moved[clean] / np.maximum(cnt, 1), cnt)
    # dirty rows: the same bucketed gather, from the pre-merged dirty CSR
    if dirty_here.size:
        rows = slot[dirty_here]
        cnt_d = d_indptr[rows + 1] - d_indptr[rows]
        starts_d = d_indptr[rows]
        total_d = int(cnt_d.sum())
        pos_d = np.repeat(
            starts_d - np.concatenate([[0], np.cumsum(cnt_d)[:-1]]),
            cnt_d) + np.arange(total_d)
        dst = np.concatenate([dst, d_indices[pos_d]])
        val = np.concatenate([
            val, np.repeat(alpha * moved[dirty_here] / np.maximum(cnt_d, 1),
                           cnt_d)])
    return dst, val, float(moved[dang].sum())


def _push(view, x: np.ndarray, r: np.ndarray, alpha: float,
          l1_target: float, visit_cap: int, max_pushes: int,
          c_holder: Optional[list] = None,
          order=None) -> Tuple[bool, int, int, int]:
    """Gauss-Southwell pushes against `view` (a DeltaGraph or
    FrozenGraphView) until ||r||_1 <= l1_target.  Mutates x and r in place.

    The drain is a *batched frontier sweep*: every node with |r_u| >= eps
    is pushed at once — x[frontier] += r, r[frontier] = 0, and the diffused
    mass alpha*r_u/deg(u) lands on out-neighbors through one bucketed CSR
    gather (clean rows straight from the base CSR arrays; the few
    overlay-dirty rows merged per node) followed by a grouped scatter-add.
    Mass a frontier node receives from its peers in the same sweep is
    pushed in the next sweep (Jacobi-style batching — each push is an exact
    linear transformation, so ordering affects only the schedule, never the
    certificate).  Sweeps run a coarse-to-fine threshold ladder (largest
    mass first — the Gauss-Southwell order, batched; no per-node heap);
    eps bottoms out at l1_target/n, where an empty frontier implies
    ||r||_1 < n * eps = l1_target.

    ||r||_1 is maintained incrementally (each sweep adjusts it by the exact
    change on the touched slice) and re-derived exactly before the loop
    ever reports success, so float drift can shift work but never the
    certificate.

    A push from a dangling node diffuses uniformly (column = e/n).  With
    `c_holder` (a one-element list; uniform-teleport problems only) that
    mass accumulates into the scalar c — the caller resolves c exactly via
    the rescale identity, see update_ranks — keeping the push local.
    Without it the uniform mass is added densely.

    `order` (a `runtime.schedule.DrainOrder` over all n rows) refines each
    sweep's frontier — D-Iteration retention may empty a ladder level (the
    ladder descends; retained fluid waits for the level where it matters)
    but is released at eps_floor, so the empty-at-the-floor certificate
    argument above holds under every schedule.

    Returns (certified, pushes, distinct_visited, frontier_peak);
    certified=False when a work cap fired first (callers fall back to a
    full solve; x and r stay a consistent pair — sweeps are atomic).
    """
    n = view.n
    arrays = _view_arrays(view)
    l1 = float(np.abs(r).sum())
    eps_floor = l1_target / max(n, 1)
    eps = max(l1 / max(n, 1), eps_floor)
    visited = np.zeros(n, dtype=bool)
    n_visited = 0
    pushes = 0
    peak = 0
    cand: Optional[np.ndarray] = None   # None => full rescan at current eps
    if order is not None:
        order.begin_round()
    while True:
        if l1 <= l1_target:
            l1 = float(np.abs(r).sum())      # exact before reporting success
            if l1 <= l1_target:
                break
        if cand is None:
            frontier = np.flatnonzero(np.abs(r) >= eps)
        else:
            frontier = cand[np.abs(r[cand]) >= eps]
        if order is not None and frontier.size:
            frontier = order.refine(np.abs(r[frontier]), frontier, eps,
                                    eps <= eps_floor)
        if frontier.size == 0:
            if cand is not None:
                cand = None                  # level drained: full rescan
                continue
            l1 = float(np.abs(r).sum())
            if l1 <= l1_target or eps <= eps_floor:
                break   # empty at the floor => l1 < n*eps_floor = target
            eps = max(eps / 8.0, eps_floor)
            continue
        peak = max(peak, int(frontier.size))
        # caps are checked at sweep boundaries (sweeps are atomic), so the
        # final sweep may overshoot — same semantics as the scalar drain,
        # which aborted on the (cap+1)-th visit
        if n_visited > visit_cap:
            return False, pushes, n_visited, peak
        if pushes > max_pushes:
            return False, pushes, n_visited, peak
        fresh = frontier[~visited[frontier]]
        visited[fresh] = True
        n_visited += int(fresh.size)
        pushes += int(frontier.size)
        if order is not None:
            order.note_drained(frontier)

        moved = r[frontier].copy()
        x[frontier] += moved
        r[frontier] = 0.0
        l1 -= float(np.abs(moved).sum())

        dst, val, dmass = _frontier_contrib(arrays, frontier, moved, alpha)
        if dst.size:
            uq, sums = _group_sums(dst, val, n)
            old = r[uq]
            new = old + sums
            l1 += float(np.abs(new).sum() - np.abs(old).sum())
            r[uq] = new
            cand = uq          # only touched rows can (re)cross eps
        else:
            cand = np.empty(0, np.int64)

        if dmass != 0.0:
            if c_holder is not None:
                # uniform mass goes to the scalar; resolved by rescale
                c_holder[0] += alpha * dmass / n
            else:
                # dangling column = e/n: a dense uniform push, then a
                # rescan (a uniform shift can lift anything over eps)
                r += alpha * dmass / n
                l1 = float(np.abs(r).sum())
                cand = None
    return True, pushes, n_visited, peak


# ---------------------------------------------------------------------------
# residual seeding (shared by update_ranks and streaming.sharded)
# ---------------------------------------------------------------------------
def _seed_delta(dg: DeltaGraph, rcpt, state: RankState) -> float:
    """Seed ``state.r`` with the exact residual perturbation of one applied
    delta (its receipt), growing x/r on node arrivals.  Returns the uniform
    component c: for uniform-teleport states the dense uniform terms (a
    shrinking 1/n, uniform dangling columns) fold into this scalar — the
    caller resolves it via the rescale identity (see update_ranks) or adds
    it densely (the sharded updater).  Custom-teleport states get every
    dense term folded into r here and c comes back 0.
    """
    alpha = state.alpha
    n0, n1 = rcpt.n_old, rcpt.n_new
    if n1 != n0:
        state.x = np.concatenate([state.x, np.zeros(n1 - n0)])
        state.r = np.concatenate([state.r, np.zeros(n1 - n0)])
    x, r = state.x, state.r
    uniform = state.v is None
    c = 0.0

    if n1 != n0:
        # teleport b = (1-alpha) e/n changed for every old node and exists
        # for the arrivals; the dangling jump w = e/n of every *untouched*
        # dangling source shrank too.  Touched sources are excluded here —
        # the per-column seeds below use their exact old/new columns.
        # Untouched nodes kept their degree, so the current (post-apply)
        # dangling mask restricted to untouched old nodes is the old one.
        untouched_dangling = dg.dangling_mask[:n0].copy()
        old_touched = rcpt.touched[rcpt.touched < n0]
        untouched_dangling[old_touched] = False
        dm = float(x[:n0][untouched_dangling].sum())
        amp = (1.0 - alpha) + alpha * dm
        shift = (1.0 / n1 - 1.0 / n0)
        # amp*shift on old nodes + amp/n1 on arrivals, decomposed as
        # amp*shift uniformly everywhere + amp*(1/n1 - shift) on arrivals
        c += amp * shift
        r[n0:] += amp * (1.0 / n1 - shift)

    for u, d0, d1, row0, row1 in zip(rcpt.touched, rcpt.old_deg,
                                     rcpt.new_deg, rcpt.old_rows,
                                     rcpt.new_rows):
        xu = x[int(u)]
        if xu == 0.0:
            continue
        if d0 > 0:
            r[row0] -= alpha * xu / d0
        else:
            # old uniform column spans the old nodes only: uniformly
            # -alpha*xu/n0 everywhere, corrected back on the arrivals
            c -= alpha * xu / n0
            r[n0:] += alpha * xu / n0
        if d1 > 0:
            r[row1] += alpha * xu / d1
        else:
            c += alpha * xu / n1

    if not uniform and c != 0.0:
        r += c          # dense fold-in; no rescale identity without e/n
        c = 0.0
    state.version = dg.version
    return c


# ---------------------------------------------------------------------------
# the updater
# ---------------------------------------------------------------------------
def update_ranks(dg: DeltaGraph, delta: EdgeDelta, state: RankState, *,
                 tol: float = 1e-8, backend: str = "segment_sum",
                 method: str = "linear", push_frontier_frac: float = 0.25,
                 max_push_factor: float = 20.0,
                 solver_max_iters: int = 1000,
                 schedule=None, device: DeviceLike = None
                 ) -> Tuple[RankState, UpdateStats]:
    """Apply `delta` to `dg` and bring `state` to a certified solution of
    the mutated graph.

    Small, local deltas take the batched frontier-push path (sub-linear:
    only rows the residual actually reaches are visited, and whole
    frontiers are pushed per numpy sweep).  When the seeded frontier or the
    visited set exceeds ``push_frontier_frac * n``, the batch is global and
    the updater falls back to a warm-started `solve_linear` (or
    `solve_power`, per ``method``) on the requested backend; the exact
    residual is then recovered with one O(nnz) apply.  (The vectorized
    sweep moved the push/fallback crossover: ~1e6 pushes/s on a 50k-node
    host graph vs ~1e5 for the old per-node drain, so the default locality
    cap is 0.25 where it used to be 0.10.)

    On return ``state.cert <= tol`` (certified ||x - x*||_1) whenever the
    drain or fallback reached its target; a fallback solver that stalls —
    e.g. bsr_pallas's f32 residual floor (~1e-7) asked for a tighter
    target — emits a RuntimeWarning and the true (larger) certificate is
    reported in ``state.cert``/``stats.cert``.  `state` is mutated in
    place and also returned.

    ``schedule`` (None, a name from `runtime.schedule.SCHEDULES`, or a
    `ScheduleSpec`) selects the drain ordering for the push path —
    ``"priority"`` (D-Iteration fluid retention) and ``"randomized"``
    (seeded Ishii-Tempo subsetting) reorder the ladder's sweeps; the
    boundary-batched rendering is exchange-side and a no-op here.  Every
    schedule certifies identically: the exact residual recompute above is
    schedule-independent.

    The fallback solve runs on `device` (None: the CUDA card). The device
    is resolved after the argument checks and before the graph changes,
    so a machine without a card fails at once, on the push path too.
    """
    if state.version != dg.version:
        raise ValueError(
            f"state at version {state.version} but graph at {dg.version}; "
            "states must track every delta (or be rebuilt via cold_state)")
    if method not in ("linear", "power"):
        raise ValueError(f"unknown method {method!r}")
    if delta.new_nodes and state.v is not None:
        # checked BEFORE mutating the graph: raising after dg.apply would
        # leave dg permanently ahead of every state tracking it
        raise NotImplementedError(
            "node arrivals with a custom teleport vector are not "
            "supported incrementally; rebuild via cold_state")
    device = resolve_device(device)
    alpha = state.alpha
    rcpt = dg.apply(delta)
    n1 = rcpt.n_new

    # ---- seed ---------------------------------------------------------
    # Uniform residual components (a shrinking 1/n, uniform dangling
    # columns) would be dense.  For the uniform-teleport problem they fold
    # into a scalar c instead, resolved exactly at the end by the rescale
    # identity: for any x with residual r = r_sparse + c e,
    #     r(x / gamma) = r_sparse / gamma,   gamma = 1 - c n / (1 - alpha)
    # (the teleport term of the residual regenerates exactly -c e under the
    # rescale).  So pushes drain only r_sparse and stay local even for node
    # arrivals and dangling sources.  Custom-teleport states take the dense
    # route (c stays 0).
    uniform = state.v is None
    c = _seed_delta(dg, rcpt, state)
    x, r = state.x, state.r
    seed_l1 = float(np.abs(r).sum()) + abs(c) * n1

    # ---- push or fall back -------------------------------------------
    n = n1
    l1_target = (1.0 - alpha) * tol
    visit_cap = max(int(push_frontier_frac * n), 1)
    max_pushes = int(max_push_factor * n)
    # worst-case frontier (count at the floor threshold); if even that is
    # only modestly above the cap, attempting the push is cheap — _push
    # aborts at visit_cap and the partial pushes still warm the fallback
    frontier0 = int(np.count_nonzero(np.abs(r) >= l1_target / max(n, 1)))

    if frontier0 <= 4 * visit_cap:
        holder = [c] if uniform else None
        spec = make_schedule(schedule)
        order = (spec.order(n) if spec.drain_kind != "default" else None)
        drained, pushes, visited, peak = _push(
            dg, x, r, alpha, 0.9 * l1_target, visit_cap, max_pushes,
            c_holder=holder, order=order)
        if holder is not None:
            c = holder[0]
        gamma = 1.0 - c * n / (1.0 - alpha)
        if drained and abs(1.0 - gamma) < 0.5:
            if c != 0.0:
                # resolve the uniform component exactly (see above)
                np.divide(x, gamma, out=x)
                np.divide(r, gamma, out=r)
            resid = float(np.abs(r).sum())
            if resid <= l1_target:
                return state, UpdateStats(
                    path="push", pushes=pushes, nodes_visited=visited,
                    frontier_peak=peak, seed_l1=seed_l1, resid_l1=resid,
                    cert=resid / (1.0 - alpha), pushes_first=visited,
                    pushes_repeat=pushes - visited)
        elif c != 0.0:
            r += c      # partial push aborted: fold c back before fallback
    else:
        pushes, visited, peak = 0, 0, frontier0

    # ---- warm-started full solve -------------------------------------
    op = dg.operator(alpha, v=state.v)
    solver = solve_linear if method == "linear" else solve_power
    res = solver(op, x0=state.x, tol=0.5 * (1.0 - alpha) * tol,
                 max_iters=solver_max_iters, backend=backend, device=device)
    state.x = np.asarray(res.x, dtype=np.float64)
    state.r = _exact_residual(dg, state.x, alpha, state.v)
    resid = state.resid_l1
    _check_cert(resid, tol, alpha, f"solve_{method}[{backend}]")
    return state, UpdateStats(
        path=f"solve_{method}", pushes=pushes, nodes_visited=visited,
        frontier_peak=peak, seed_l1=seed_l1, resid_l1=resid,
        cert=resid / (1.0 - alpha), solver_iters=res.iters)


# ---------------------------------------------------------------------------
# personalized queries (serve-side): approximate PPR by the same pushes
# ---------------------------------------------------------------------------
def validate_seeds(n: int, seeds, weights=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Validate one personalized query's (seeds, weights) against an
    n-node graph and return the canonical pair: seed ids sorted ascending
    with the matching L1-normalized weight for each.

    Raises ValueError for every input that would previously produce a
    silent wrong answer: duplicate seed ids (the old `np.add.at` scatter
    summed them, skewing the teleport), out-of-range ids (negative or
    >= n: garbage pushes or an IndexError deep in the sweep), and
    non-normalizable weights (length mismatch, non-finite entries,
    negative entries, or total mass <= 0 — dividing by that sum yields
    NaN/sign-flipped teleports)."""
    seeds = np.asarray(seeds, dtype=np.int64).ravel()
    if seeds.size == 0:
        raise ValueError("personalized query needs at least one seed")
    if seeds.min() < 0 or seeds.max() >= n:
        raise ValueError(
            f"seed ids must be in [0, {n}); got "
            f"[{seeds.min()}, {seeds.max()}]")
    order = np.argsort(seeds, kind="stable")
    seeds = seeds[order]
    if np.any(seeds[1:] == seeds[:-1]):
        raise ValueError("duplicate seed ids in personalized query; "
                         "merge their weights instead")
    if weights is None:
        return seeds, np.full(seeds.size, 1.0 / seeds.size)
    w = np.asarray(weights, dtype=np.float64).ravel()
    if w.shape != order.shape:
        raise ValueError(f"{w.size} weights for {seeds.size} seeds")
    if not np.all(np.isfinite(w)):
        raise ValueError("seed weights must be finite")
    if np.any(w < 0):
        raise ValueError("seed weights must be >= 0")
    s = w.sum()
    if s <= 0:
        raise ValueError("seed weights are not normalizable (sum <= 0)")
    return seeds, w[order] / s


def ppr_push(view, seeds, weights=None, alpha: float = 0.85,
             tol: float = 1e-4, max_push_factor: float = 200.0
             ) -> Tuple[np.ndarray, float, UpdateStats]:
    """Personalized PageRank with teleport concentrated on `seeds`, solved
    from scratch by residual pushes against a (frozen) graph view — the
    serving-path analogue of `update_ranks` (localized seeds stay local).

    Returns (x, cert, stats) with ||x - x*||_1 <= cert <= tol when the
    push budget sufficed (cert is inf otherwise — the scores are still a
    usable localized approximation, just uncertified).  Serving tolerances
    are intentionally loose: draining single-seed mass by a factor f costs
    about log(f)/log(1/alpha) frontier sweeps, so tol=1e-6-grade answers
    are full solves in disguise — ask `solve_linear` (or the batched
    lane solve `ppr_push_batched`) for those.
    """
    n = view.n
    seeds, w = validate_seeds(n, seeds, weights)
    x = np.zeros(n)
    r = np.zeros(n)
    r[seeds] = (1.0 - alpha) * w
    drained, pushes, visited, peak = _push(
        view, x, r, alpha, l1_target=(1.0 - alpha) * tol, visit_cap=n,
        max_pushes=int(max_push_factor * n))
    resid = float(np.abs(r).sum())
    cert = resid / (1.0 - alpha)
    if not drained:
        cert = float("inf")
    return x, cert, UpdateStats(
        path="push", pushes=pushes, nodes_visited=visited,
        frontier_peak=peak, seed_l1=1.0 - alpha, resid_l1=resid, cert=cert,
        pushes_first=visited, pushes_repeat=pushes - visited)


@dataclasses.dataclass
class BatchedPPRStats:
    """Stats of one fused multi-seed personalized solve."""
    path: str                 # "batched_linear" | "batched_power" |
                              # "batched_host"
    nv: int                   # lanes (queries) in the batch
    iters: int                # fused-loop iterations (max over lanes)
    lane_iters: np.ndarray    # (nv,) per-lane iterations under freezing
    certs: np.ndarray         # (nv,) exact per-lane certificates
    tol: np.ndarray           # (nv,) per-lane requested tolerances


def _host_stack_solve(pt_sp, dangling_idx: np.ndarray, alpha: float,
                      v_stack: np.ndarray, tol_res: np.ndarray,
                      max_iters: int
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Richardson iteration x <- alpha S x + b on an (n, nv) host stack
    through one scipy CSR spmm per step, with per-lane stopping and lane
    compaction (a finished lane's column leaves the spmm).

    This is the CPU fast path for batched personalized solves: a scipy
    spmm over a dense lane stack runs the same nnz*nv multiply-adds as
    the segment-sum gather but without materializing the (nnz, nv)
    gather buffer — on a small-core host that buffer is the whole cost.
    Runs on the card take the device lane backends (`backend=` below).
    """
    n, nv = v_stack.shape
    b = (1.0 - alpha) * v_stack
    x = np.full((n, nv), 1.0 / n)
    out = np.empty((n, nv))
    lane_iters = np.zeros(nv, dtype=np.int64)
    active = np.arange(nv)
    it = 0
    while active.size and it < max_iters:
        y = alpha * (pt_sp @ x)
        y += (alpha / n) * x[dangling_idx].sum(axis=0)[None, :]
        y += b[:, active]
        resid = np.abs(y - x).sum(axis=0)
        x = y
        it += 1
        lane_iters[active] += 1
        done = resid <= tol_res[active]
        if done.any():
            out[:, active[done]] = x[:, done]
            x = x[:, ~done]
            active = active[~done]
    if active.size:                      # max_iters hit: flush as-is
        out[:, active] = x
    return out, lane_iters, it


def ppr_push_batched(view, seed_sets, weight_sets=None, *,
                     alpha: float = 0.85, tol=1e-4, op=None, pt_sp=None,
                     backend: str = "auto", method: str = "linear",
                     max_iters: int = 2000,
                     freeze_lanes="auto", freeze_chunk="auto",
                     device: DeviceLike = None
                     ) -> Tuple[np.ndarray, np.ndarray, BatchedPPRStats]:
    """Batched personalized PageRank: nv concurrent queries fused into
    multi-vector (n, nv) lanes — one solve over a seed-stacked teleport,
    so every sparse-structure load is amortized across all queries
    instead of each seed paying its own push cascade.

    `tol` may be a scalar or per-query sequence: mixed-tolerance batches
    run as one solve with per-lane thresholds, and finished lanes drop
    out of the iteration (host compaction, or `freeze_lanes`/
    `freeze_chunk` on the device backends).

    `backend` picks the lane engine: "scipy" iterates the (n, nv) stack
    through host CSR spmms (`_host_stack_solve` — the fast path on
    CPU-only hosts), "segment_sum"/"bsr" (alias "bsr_pallas") run the
    fused loops of `core.backend` on `device` (on the card the CSR
    kernel, or the block kernel and its hub lane, every lane sharing
    each edge or block load), and "auto" resolves to "scipy" when the
    resolved device is the CPU and `method == "linear"`, and to
    "segment_sum" otherwise. `device=None` means the CUDA card, and is
    resolved (raising without one) whatever the backend.

    `view` is the graph (DeltaGraph, or a FrozenGraphView when `op` — a
    `GoogleOperator` of the *same version* — is supplied, e.g. captured on
    a `RankSnapshot` by the serving tier).  `pt_sp` (host scipy P^T)
    feeds the host path and the exact certification; it is derived from
    `op`/`view` when omitted.

    Returns (X, certs, stats): X is the (n, nv) column-per-query result,
    and each certs[i] = ||x_i - x*_i||_1 bound is recomputed *exactly*
    (one host spmm over all lanes) — never the solver's own residual — so
    the published certificates match `update_ranks`' contract.  A lane
    whose cert misses its tol (e.g. the bsr_pallas f32 floor) warns via
    `_check_cert` and reports the true, larger bound.
    """
    if method not in ("linear", "power"):
        raise ValueError(f"unknown method {method!r}")
    device = resolve_device(device)
    if backend == "auto":
        backend = ("scipy" if device.type == "cpu"
                   and method == "linear" else "segment_sum")
    if backend == "scipy" and method != "linear":
        raise ValueError("backend='scipy' implements the linear form "
                         "only; use a device backend for method='power'")
    n = view.n if view is not None else op.n
    seed_sets = list(seed_sets)
    nv = len(seed_sets)
    if weight_sets is not None and len(weight_sets) != nv:
        raise ValueError(f"{len(weight_sets)} weight sets for {nv} "
                         "seed sets")
    pairs = [validate_seeds(n, s, None if weight_sets is None
                            else weight_sets[i])
             for i, s in enumerate(seed_sets)]
    tol_vec = as_lane_tol(tol, nv)

    if op is None:
        if not isinstance(view, DeltaGraph):
            raise ValueError(
                "ppr_push_batched needs op= (a GoogleOperator of the "
                "view's version) when view is not a DeltaGraph — the "
                "serving tier captures it on each RankSnapshot")
        op = view.operator(alpha)
        if pt_sp is None:
            pt_sp = view.scipy_pt()
    if pt_sp is None:
        pt_sp = op.to_scipy_pt()

    v_stack = seed_stack(n, [s for s, _ in pairs], [w for _, w in pairs])
    op_b = GoogleOperator(pt=op.pt, alpha=alpha, v=v_stack)
    # same 0.5x headroom convention as cold_state: the exact recompute
    # below must land under (1 - alpha) * tol after solver exit
    tol_res = 0.5 * (1.0 - alpha) * tol_vec
    if backend == "scipy":
        x, lane_iters, iters = _host_stack_solve(
            pt_sp, np.flatnonzero(op.pt.dangling), alpha, v_stack,
            tol_res, max_iters)
        path = "batched_host"
    else:
        solver = solve_linear if method == "linear" else solve_power
        res = solver(op_b, tol=tol_res, max_iters=max_iters,
                     backend=backend, freeze_lanes=freeze_lanes,
                     freeze_chunk=freeze_chunk, device=device)
        x = np.asarray(res.x, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        lane_iters, iters = res.lane_iters, res.iters
        path = f"batched_{method}"
    r = op_b.apply_linear_numpy(x, pt_sp=pt_sp) - x
    resid = np.abs(r).sum(axis=0)
    certs = resid / (1.0 - alpha)
    worst = int(np.argmax(certs / tol_vec))
    _check_cert(float(resid[worst]), float(tol_vec[worst]), alpha,
                f"ppr_push_batched[{backend}] lane {worst}")
    return x, certs, BatchedPPRStats(
        path=path, nv=nv, iters=int(iters),
        lane_iters=np.asarray(lane_iters), certs=certs, tol=tol_vec)
