"""Edge-stream replay: freshness vs throughput for the streaming stack
(the JAX package's streaming/scenario.py; the trace, the clock and the
accounting are its numpy, copied, and the updater's solves and the block
updates run on `device`).

Discrete-event scenario in the style of `core.des`: one updater UE with a
calibrated work-rate model processes crawl delta batches while a Poisson
query stream is answered from whatever snapshot is currently published.
The per-batch accounting mirrors the paper's Table 2 — where the paper
reports *completed imports* per UE (how much of the data a UE should have
seen actually arrived), the replay reports *fresh serves* per interval
(how many queries were answered from a snapshot that matched the live
graph) next to queue delay, service time and the push/fallback split.

`StreamingBlockOperator` adapts the evolving graph to the `core.des`
`BlockOperator` protocol (the port's `runtime.LocalSolver`: block updates
always read the freshest snapshot, on the device), so the same DES engine
that reproduces the paper's async tables can iterate against a mutating
graph.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.partition import Partition
from ..device import DeviceLike, resolve_device
from ..runtime.local import BlockLocalSolver
from .delta import DeltaGraph, EdgeDelta
from .incremental import RankState, UpdateStats, update_ranks


# ---------------------------------------------------------------------------
# synthetic crawl traces
# ---------------------------------------------------------------------------
def synth_edge_trace(dg: DeltaGraph, n_batches: int, batch_edges: int,
                     p_delete: float = 0.15, p_new_node: float = 0.02,
                     seed: int = 0) -> List[EdgeDelta]:
    """A crawl-like delta stream against the *current* state of `dg`.

    Insertions pick sources uniformly and targets by sampling an existing
    edge's destination (popularity-proportional, preferential-attachment
    flavored) with a uniform escape; deletions sample existing edges.  The
    stream is generated against a scratch replica so every deletion refers
    to an edge that actually exists when its batch is applied; `dg` itself
    is left untouched.
    """
    rng = np.random.default_rng(seed)
    scratch = DeltaGraph(dg.graph(), compact_frac=dg.compact_frac)
    trace: List[EdgeDelta] = []
    for _ in range(n_batches):
        n = scratch.n
        g = scratch.graph()
        n_del = int(round(batch_edges * p_delete))
        n_add = batch_edges - n_del
        new_nodes = int(rng.random() < p_new_node)

        # deletions: sample existing edge slots
        ds, dd = [], []
        if n_del and g.nnz:
            slots = rng.choice(g.nnz, size=min(n_del, g.nnz), replace=False)
            src_of_edge = np.repeat(np.arange(g.n, dtype=np.int64),
                                    np.diff(g.indptr))
            ds = src_of_edge[slots]
            dd = g.indices[slots].astype(np.int64)

        # insertions: uniform source, popularity-biased target
        n_tot = n + new_nodes
        a_src = rng.integers(0, n_tot, size=n_add)
        if g.nnz:
            pick = rng.integers(0, g.nnz, size=n_add)
            a_dst = g.indices[pick].astype(np.int64)
        else:
            a_dst = rng.integers(0, n, size=n_add)
        uni = rng.random(n_add) < 0.2
        a_dst[uni] = rng.integers(0, n_tot, size=int(uni.sum()))
        if new_nodes:
            # wire each arrival in (one in-link) so it is reachable
            a_src = np.concatenate([a_src, rng.integers(0, n, size=1)])
            a_dst = np.concatenate([a_dst,
                                    np.arange(n, n_tot, dtype=np.int64)])

        d = EdgeDelta(add_src=np.asarray(a_src, np.int64),
                      add_dst=np.asarray(a_dst, np.int64),
                      del_src=np.asarray(ds, np.int64),
                      del_dst=np.asarray(dd, np.int64),
                      new_nodes=new_nodes)
        scratch.apply(d)
        trace.append(d)
    return trace


# ---------------------------------------------------------------------------
# BlockOperator adapter (core.des protocol) over an evolving graph
# ---------------------------------------------------------------------------
class StreamingBlockOperator:
    """Eq. (6)/(7) restricted to partition blocks, against the *current*
    version of a `DeltaGraph`, on `device` (None: the CUDA card).

    Per version it holds a `runtime.BlockLocalSolver` over
    `dg.operator(alpha)` and hands it every block update: one
    `graph.csr.pt_matvec_block`, the CSR kernel's float64 lane on the
    card, its plain version (a gather and an `index_add_` in edge order,
    scipy's bits) on the CPU.  A DES run whose graph mutates between
    events so always iterates on the freshest snapshot; the previous
    version's solver, and its device tensors, are dropped before the next
    is built.  Node arrivals are not supported: the partition is fixed at
    construction."""

    def __init__(self, dg: DeltaGraph, part: Partition,
                 alpha: float = 0.85, kind: str = "power",
                 device: DeviceLike = None):
        if kind not in ("power", "linear"):
            raise ValueError(f"unknown kind {kind!r}")
        self.device = resolve_device(device)
        self.dg = dg
        self.part = part
        self.alpha = alpha
        self.kind = kind
        self.n = dg.n
        self._version = -1
        self._solver: Optional[BlockLocalSolver] = None

    def _local(self) -> BlockLocalSolver:
        if self._version != self.dg.version:
            if self.dg.n != self.part.n:
                raise ValueError("node arrivals changed n; rebuild the "
                                 "partition and operator")
            self._version, self._solver = -1, None   # free the old first
            self._solver = BlockLocalSolver(
                self.dg.operator(self.alpha), self.part, kind=self.kind,
                device=self.device)
            self._version = self.dg.version
        return self._solver

    def update_block(self, i: int, x_full: torch.Tensor) -> torch.Tensor:
        """The new fragment of block i, a fresh (e - s,) float64 tensor on
        x_full's device."""
        return self._local().update_block(i, x_full)

    def block_work(self, i: int) -> float:
        return self._local().block_work(i)


# ---------------------------------------------------------------------------
# the replay
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ReplayConfig:
    """Clock model for the single-updater replay (rates in the spirit of
    DESConfig's calibrated edge-ops/s accounting).  The defaults are the
    JAX package's, calibrated on its CPU host: ~1.2e6 pushes/s on the
    batched-frontier host push path, ~2e7 edge-ops/s through its backend
    solver.  They are a simulated clock, not a measurement of this port;
    they stay the reference's so that a replay gives its records."""

    query_rate: float = 200.0        # Poisson queries per sim second
    delta_interval: float = 0.25     # mean seconds between batch arrivals
    push_rate: float = 1.2e6         # pushes the updater sustains per second
    solve_edge_rate: float = 2e7     # edge-ops/s for fallback sweeps
    update_overhead: float = 2e-3    # per-batch fixed cost (s)
    tol: float = 1e-5                # serving-grade certificate
    backend: str = "segment_sum"
    push_frontier_frac: float = 0.25  # crossover for the batched sweep
    seed: int = 0


@dataclasses.dataclass
class BatchRecord:
    """One row of the freshness table (the Table-2 mirror)."""

    batch: int
    arrival: float
    start: float
    done: float
    queue_delay: float
    service: float
    path: str
    pushes: int
    visited_frac: float
    version_lag_at_done: int       # batches that arrived while serving this
    fresh_queries: int             # queries served fresh since last publish
    stale_queries: int


@dataclasses.dataclass
class ReplayResult:
    rows: List[BatchRecord]
    queries: int
    fresh_pct: float               # % of queries served with zero lag
    mean_age_s: float              # mean snapshot age at query time
    p95_age_s: float
    mean_lag_batches: float        # mean published-version lag at query time
    busy_frac: float               # updater utilization
    us_per_delta_edge: float       # sim service time per delta edge
    deltas_per_s: float            # sustained capacity 1/mean service

    def table(self) -> str:
        hdr = (f"{'batch':>5} {'arr':>8} {'q-delay':>8} {'service':>8} "
               f"{'path':>12} {'pushes':>7} {'visit%':>7} {'lag':>4} "
               f"{'fresh/stale':>12}")
        lines = [hdr]
        for r in self.rows:
            lines.append(
                f"{r.batch:>5} {r.arrival:>8.3f} {r.queue_delay:>8.4f} "
                f"{r.service:>8.4f} {r.path:>12} {r.pushes:>7} "
                f"{100 * r.visited_frac:>6.2f}% {r.version_lag_at_done:>4} "
                f"{r.fresh_queries:>5}/{r.stale_queries:<6}")
        return "\n".join(lines)


def replay_trace(dg: DeltaGraph, state: RankState,
                 trace: Sequence[EdgeDelta],
                 cfg: Optional[ReplayConfig] = None,
                 device: DeviceLike = None) -> ReplayResult:
    """Replay an edge-stream trace through the incremental updater under a
    DES clock: batches queue while the updater is busy, queries are served
    from the last published snapshot, and every batch contributes one
    accounting row.  Mutates `dg`/`state` (they end at the trace's final
    version).  The updater's fallback solves run on `device` (None: the
    CUDA card)."""
    device = resolve_device(device)
    cfg = cfg or ReplayConfig()
    rng = np.random.default_rng(cfg.seed)
    n_batches = len(trace)

    arrivals = np.cumsum(rng.exponential(cfg.delta_interval,
                                         size=n_batches))
    events: list = []   # (time, seq, kind, payload)
    seq = 0

    def push_evt(t, kind, payload):
        nonlocal seq
        heapq.heappush(events, (t, seq, kind, payload))
        seq += 1

    for b, t in enumerate(arrivals):
        push_evt(float(t), "delta", b)
    horizon = float(arrivals[-1]) + 1.0
    t_q = float(rng.exponential(1.0 / cfg.query_rate))
    while t_q < horizon:
        push_evt(t_q, "query", None)
        t_q += float(rng.exponential(1.0 / cfg.query_rate))

    pending: List[int] = []      # queued batch ids
    busy_until = 0.0
    busy_time = 0.0
    applied_version = 0          # batches applied (live graph)
    published_version = 0        # batches reflected in the served snapshot
    publish_time = 0.0
    fresh = stale = 0
    interval_fresh = interval_stale = 0
    ages: List[float] = []
    lags: List[int] = []
    rows: List[BatchRecord] = []
    edges_total = 0

    def service_time(stats: UpdateStats, delta: EdgeDelta) -> float:
        if stats.path == "push":
            work = stats.pushes / cfg.push_rate
        else:
            work = stats.solver_iters * dg.nnz / cfg.solve_edge_rate
        return cfg.update_overhead + work

    def start_next(t: float) -> None:
        nonlocal busy_until, busy_time, applied_version, edges_total, \
            interval_fresh, interval_stale, state
        b = pending.pop(0)
        delta = trace[b]
        edges_total += delta.size
        state, stats = update_ranks(
            dg, delta, state, tol=cfg.tol, backend=cfg.backend,
            push_frontier_frac=cfg.push_frontier_frac, device=device)
        svc = service_time(stats, delta)
        busy_until = t + svc
        busy_time += svc
        applied_version += 1
        rows.append(BatchRecord(
            batch=b, arrival=float(arrivals[b]), start=t,
            done=busy_until, queue_delay=t - float(arrivals[b]),
            service=svc, path=stats.path, pushes=stats.pushes,
            visited_frac=stats.nodes_visited / max(dg.n, 1),
            version_lag_at_done=len(pending),
            fresh_queries=interval_fresh,
            stale_queries=interval_stale))
        interval_fresh = interval_stale = 0
        push_evt(busy_until, "done", None)

    while events:
        t, _, kind, payload = heapq.heappop(events)
        if kind == "query":
            if published_version == applied_version and not pending:
                fresh += 1
                interval_fresh += 1
            else:
                stale += 1
                interval_stale += 1
            ages.append(t - publish_time)
            lags.append(applied_version + len(pending) - published_version)
        elif kind == "delta":
            pending.append(payload)
            if t >= busy_until:
                start_next(t)
        elif kind == "done":
            published_version = applied_version
            publish_time = t
            if pending:
                start_next(t)

    total_q = max(fresh + stale, 1)
    services = [r.service for r in rows]
    mean_svc = float(np.mean(services)) if services else 0.0
    return ReplayResult(
        rows=rows, queries=fresh + stale,
        fresh_pct=100.0 * fresh / total_q,
        mean_age_s=float(np.mean(ages)) if ages else 0.0,
        p95_age_s=float(np.percentile(ages, 95)) if ages else 0.0,
        mean_lag_batches=float(np.mean(lags)) if lags else 0.0,
        busy_frac=busy_time / max(rows[-1].done if rows else 1.0, 1e-9),
        us_per_delta_edge=1e6 * mean_svc * len(rows) / max(edges_total, 1),
        deltas_per_s=1.0 / mean_svc if mean_svc > 0 else float("inf"),
    )
