"""Update-while-serve rank server (the JAX package's streaming/server.py;
the queue, the locks and the snapshots are its host code, copied, and the
updater's solves run on `device`, the CUDA card unless the caller passes
`device="cpu"`).

The ROADMAP's north star is a system that "serves heavy traffic from
millions of users" while the graph keeps changing underneath it.  The
`RankServer` realizes that over the streaming stack:

  * two rank buffers: queries are answered from the **stable** snapshot
    while the updater drains crawl deltas into the **working** state;
  * publishing is an atomic reference swap (CPython reference assignment):
    the working state is frozen into an immutable `RankSnapshot` (rank
    vector copy marked read-only + a frozen graph view + staleness
    metadata) and becomes the new stable buffer — readers never lock, never
    block, and never observe a torn vector;
  * every snapshot carries its certification bound (`cert`, the L1 distance
    to the exact ranks of its own graph version) and staleness metadata
    (graph version, publish time, deltas that were pending when it was
    cut), so a caller can always tell *how* stale an answer is.

Queries:
    top_k(k)            — highest-rank pages from the stable buffer.
    scores(ids)         — rank values for explicit pages.
    personalized(seeds) — approximate personalized PageRank, computed by
                          residual pushes against the snapshot's frozen
                          graph view (localized, serve-side work only).

The updater can run inline (`apply_pending()`, deterministic — what the
tests drive) or as a daemon thread (`start()`/`stop()`) that drains the
ingest queue in merged batches, the update-while-serve mode.  The daemon
thread launches its device solves on the same device and the default
stream as the caller's thread; it sets no device of its own.

The query tier (`repro_torch.serving.attach_query_tier`) plugs into the
hooks `_ppr_batcher` and `_ppr_cache`: with it, concurrent `personalized`
calls fuse into one lane solve on the batcher's device, and repeats are
answered from a certified cache; without it `personalized` answers with a
host push (`ppr_push`).  With `shard_mode="async"` on the "procpool"
transport, the updater thread forks (or spawns) numpy-only worker
processes for every batch.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..runtime.observe import render_prometheus
from ..runtime.schedule import make_schedule
from .delta import DeltaGraph, EdgeDelta, FrozenGraphView, merge_deltas
from .incremental import (RankState, UpdateStats, _exact_residual,
                          cold_state, ppr_push, refresh_residual,
                          update_ranks)
from .sharded import update_ranks_sharded


@dataclasses.dataclass(frozen=True)
class RankSnapshot:
    """Immutable published view: the stable buffer queries read from."""

    x: np.ndarray               # (n,) read-only rank vector
    view: FrozenGraphView       # the graph this vector certifies against
    version: int                # graph version of the vector
    cert: float                 # certified ||x - x*||_1 for that version
    published_at: float         # wall-clock publish time
    pending_at_publish: int     # deltas still queued when this was cut
    seq: int                    # publish sequence number
    op: Optional[object] = None     # GoogleOperator of `version` (only when
                                    # the server runs with snapshot_ops on:
                                    # the batched-PPR lane solve needs it)
    pt_sp: Optional[object] = None  # host scipy P^T of `version` (exact
                                    # certification spmm for batched PPR)

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    def _order_cache(self) -> dict:
        # the snapshot is frozen but not slotted: hang the memo off
        # __dict__ (same pattern as GoogleOperator._cache); races between
        # query threads are benign (both compute the same array)
        cache = self.__dict__.get("_topk_memo")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_topk_memo", cache)
        return cache

    def top_k(self, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        k = min(k, self.n)
        if k <= 0:
            # np.argpartition(-x, k - 1) would partition on the *last*
            # element for k == 0 (kth=-1 wraps around) — return explicit
            # empties instead
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=self.x.dtype))
        # memoize the expensive argpartition per power-of-two ceiling K:
        # hot top-k traffic under load re-slices one cached order instead
        # of re-partitioning the full rank vector per call.  Ties break
        # deterministically (descending score, then ascending id) so a
        # k-prefix of the K-order equals a direct top-k.
        K = self.n if k >= self.n else min(1 << (k - 1).bit_length(),
                                           self.n)
        cache = self._order_cache()
        order = cache.get(K)
        if order is None:
            # any cached superset order is already sorted: its k-prefix
            # IS the answer — re-slice it instead of re-partitioning
            bigger = [Kc for Kc in cache if Kc >= k]
            if bigger:
                order = cache[min(bigger)]
            else:
                if K >= self.n:
                    order = np.lexsort((np.arange(self.n), -self.x))
                else:
                    part = np.argpartition(-self.x, K - 1)[:K]
                    order = part[np.lexsort((part, -self.x[part]))]
                order = order.astype(np.int64, copy=False)
                cache[K] = order
        top = order[:k]
        return top, self.x[top]

    def scores(self, ids) -> np.ndarray:
        return self.x[np.asarray(ids, dtype=np.int64)]


class RankServer:
    """Double-buffered PageRank serving over an evolving `DeltaGraph`."""

    def __init__(self, dg: DeltaGraph, alpha: float = 0.85,
                 tol: float = 1e-8, backend: str = "segment_sum",
                 method: str = "linear",
                 push_frontier_frac: float = 0.25,
                 refresh_every: int = 64,
                 cold_tol: Optional[float] = None,
                 updater: str = "incremental",
                 shards: int = 4,
                 exchange: str = "allgather",
                 shard_mode: str = "superstep",
                 shard_transport: str = "threads",
                 shard_workers: Optional[int] = None,
                 drain_schedule=None,
                 snapshot_ops: bool = False,
                 device: DeviceLike = None):
        if updater not in ("incremental", "sharded"):
            raise ValueError(f"unknown updater {updater!r}; expected "
                             "'incremental' or 'sharded'")
        if shard_mode not in ("superstep", "async"):
            raise ValueError(f"unknown shard_mode {shard_mode!r}; expected "
                             "'superstep' or 'async'")
        if shard_transport not in ("threads", "procpool", "device"):
            raise ValueError(f"unknown shard_transport {shard_transport!r};"
                             " expected 'threads', 'procpool' or 'device'")
        if shard_transport in ("procpool", "device") \
                and shard_mode != "async":
            raise ValueError(f"shard_transport={shard_transport!r} "
                             "requires shard_mode='async'")
        # every solve of this server (the cold one, the updaters'
        # fallbacks and device drains) runs here; None is the CUDA card
        self.device = resolve_device(device)
        self.dg = dg
        self.alpha = alpha
        self.tol = tol
        self.backend = backend
        self.method = method
        self.push_frontier_frac = push_frontier_frac
        self.refresh_every = refresh_every
        # updater="sharded": drain deltas with the Partition-sharded
        # runtime-layer updater (streaming.sharded) — p shards exchanging
        # boundary residual under `exchange` ("allgather" | "sparsified"),
        # certificate via the Fig. 1 TerminationDriver.  shard_mode="async"
        # runs the drains with no superstep barrier on `shard_transport`:
        # "threads" (AsyncShardExecutor worker threads), "procpool"
        # (worker processes over a shared-memory ShardArena,
        # `shard_workers` sizing the pool), or "device" (p shard programs
        # on `device`, runtime/device.py).
        self.updater = updater
        self.shards = shards
        self.exchange = exchange
        self.shard_mode = shard_mode
        self.shard_transport = shard_transport
        self.shard_workers = shard_workers
        # DrainSchedule (runtime/schedule.py): None, a SCHEDULES name, or
        # a full ScheduleSpec — normalized once and threaded into every
        # batch the updater applies (both updaters accept it; the
        # certificate every snapshot publishes is schedule-independent)
        self.drain_schedule = make_schedule(drain_schedule)

        # query-tier hooks (repro_torch.serving): a QueryBatcher fuses
        # concurrent personalized() calls into one (n, nv) lane solve, a
        # PPRCache short-circuits repeats under a certified drift bound,
        # and subscribe() fans each publish out to router read-replicas.
        # snapshot_ops=True captures the per-version GoogleOperator +
        # host P^T on every snapshot (what the batched solve consumes);
        # off by default — it fronts the O(nnz) per-version transition
        # build that pure push/serve paths never need.
        self.snapshot_ops = bool(snapshot_ops)
        self._ppr_batcher = None
        self._ppr_cache = None
        self._subscribers: List = []

        # working buffer (updater-owned) + cold certification
        self._state: RankState = cold_state(
            dg, alpha=alpha, tol=cold_tol if cold_tol is not None else tol,
            backend=backend, method=method, device=self.device)
        self._queue: "queue.Queue[EdgeDelta]" = queue.Queue()
        self._seq = 0
        self._batches_since_refresh = 0
        self._snapshot: RankSnapshot = self._cut_snapshot()

        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()   # serializes updater entry points
        self._stat_lock = threading.Lock()  # telemetry counters (any thread)

        # counters (telemetry; read-only for callers)
        self.deltas_ingested = 0
        self.batches_applied = 0
        self.fallbacks = 0
        self.queries_served = 0
        self.state_recoveries = 0   # _recover_state entries (any path)
        self.cold_rebuilds = 0      # ...that took the cold_state resort
        self.last_stats = None   # UpdateStats | ShardedUpdateStats

        # degrade-gracefully state: a daemon-updater failure no
        # longer dies silently — it is captured here, the working state is
        # re-materialized, and the loop retries with backoff while queries
        # keep answering from the last certified snapshot
        self.last_error: Optional[Dict[str, object]] = None
        self.consecutive_failures = 0
        self.updater_restarts = 0
        self._REQUEUE_CAP = 3
        self._requeue_budget = self._REQUEUE_CAP

    # ------------------------------------------------------------------
    # the swap protocol
    # ------------------------------------------------------------------
    def _cut_snapshot(self) -> RankSnapshot:
        x = self._state.x.copy()
        x.setflags(write=False)
        self._seq += 1
        op = pt_sp = None
        if self.snapshot_ops:
            # memoized per version on the DeltaGraph: the first cut of a
            # version pays the transition build, later cuts are pointer
            # copies — batched PPR and exact certification read these
            op = self.dg.operator(self.alpha)
            pt_sp = self.dg.scipy_pt()
        snap = RankSnapshot(
            x=x, view=self.dg.freeze(), version=self._state.version,
            cert=self._state.cert, published_at=time.time(),
            pending_at_publish=self._queue.qsize(), seq=self._seq,
            op=op, pt_sp=pt_sp)
        self._snapshot = snap   # atomic reference swap — the publish
        for cb in list(self._subscribers):
            # publish fan-out (router read-replicas): subscriber errors
            # must never kill the updater — drop them on the floor, the
            # replica just stays a publish behind
            try:
                cb(snap)
            except Exception:
                pass
        return snap

    def snapshot(self) -> RankSnapshot:
        """The stable buffer (immutable; hold it as long as you like)."""
        return self._snapshot

    def subscribe(self, callback) -> None:
        """Register a publish listener: `callback(snap)` runs on every
        `_cut_snapshot` (updater thread) with the freshly published
        `RankSnapshot`.  This is the router's atomic fan-out channel —
        replicas install the reference, they never copy the vector."""
        self._subscribers.append(callback)
        callback(self._snapshot)   # catch the replica up immediately

    def enable_snapshot_ops(self) -> None:
        """Switch on per-snapshot operator capture and re-publish so the
        current snapshot carries `op`/`pt_sp` too (the query batcher
        calls this when it attaches)."""
        if self.snapshot_ops and self._snapshot.op is not None:
            return
        self.snapshot_ops = True
        with self._lock:
            self._cut_snapshot()

    # ------------------------------------------------------------------
    # ingest + update
    # ------------------------------------------------------------------
    def ingest(self, delta: EdgeDelta) -> None:
        """Enqueue a crawl delta (any thread)."""
        with self._stat_lock:
            self.deltas_ingested += 1
        self._queue.put(delta)

    def _drain(self) -> List[EdgeDelta]:
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                return out

    def apply_pending(self) -> Optional[UpdateStats]:
        """Drain the queue, apply one merged batch, publish. Inline and
        deterministic (the non-threaded mode); returns the update stats or
        None when the queue was empty."""
        with self._lock:
            batch = self._drain()
            if not batch:
                return None
            merged = merge_deltas(batch)
            ver0 = self.dg.version
            try:
                if self.updater == "sharded":
                    self._state, stats = update_ranks_sharded(
                        self.dg, merged, self._state, tol=self.tol,
                        p=self.shards, exchange=self.exchange,
                        mode=self.shard_mode,
                        transport=self.shard_transport,
                        n_workers=self.shard_workers,
                        backend=self.backend, method=self.method,
                        schedule=self.drain_schedule, device=self.device)
                else:
                    self._state, stats = update_ranks(
                        self.dg, merged, self._state, tol=self.tol,
                        backend=self.backend, method=self.method,
                        push_frontier_frac=self.push_frontier_frac,
                        schedule=self.drain_schedule, device=self.device)
            except BaseException:
                # the batch is only safe to retry when the graph did NOT
                # advance (a failure after dg.apply means the delta is
                # already in the graph — re-enqueueing would double-apply
                # it); a bounded retry budget keeps a poisoned batch from
                # cycling forever
                if self.dg.version == ver0 and self._requeue_budget > 0:
                    self._requeue_budget -= 1
                    self._queue.put(merged)
                raise
            self._requeue_budget = self._REQUEUE_CAP
            fell_back = stats.path not in ("push", "sharded_push")
            self._batches_since_refresh += 1
            if fell_back:
                self._batches_since_refresh = 0
            elif self._batches_since_refresh >= self.refresh_every:
                # long pure-push chains re-derive the residual exactly so
                # float drift never silently erodes the certificate
                refresh_residual(self.dg, self._state)
                self._batches_since_refresh = 0
            # all telemetry lives under _stat_lock (concurrent query
            # threads read these counters; _lock only serializes updaters)
            with self._stat_lock:
                self.batches_applied += 1
                if fell_back:
                    self.fallbacks += 1
                self.last_stats = stats
            cache = self._ppr_cache
            if cache is not None:
                # advance the cache's certified drift accounting BEFORE
                # publishing, so a query against the new snapshot can
                # already hit entries whose bound survived this delta
                cache.note_update(self.dg._last_receipt)
            self._cut_snapshot()
            return stats

    # ------------------------------------------------------------------
    # async updater (update-while-serve)
    # ------------------------------------------------------------------
    def start(self, poll_s: float = 0.01, backoff_base_s: float = 0.05,
              backoff_cap_s: float = 2.0) -> None:
        """Run the updater as a daemon thread.  An unhandled updater
        exception does not kill the thread silently (a dead updater would
        serve forever-stale data with no signal): it is captured into
        `last_error`, the working state is
        re-materialized (`_recover_state`), and the loop retries with
        capped exponential backoff — queries keep answering from the
        last certified snapshot throughout.  `health()` surfaces all of
        it."""
        if self._thread is not None:
            raise RuntimeError("updater already running")
        self._stop_evt.clear()

        def run():
            import traceback
            while not self._stop_evt.is_set():
                if self._queue.empty():
                    self._stop_evt.wait(poll_s)
                    continue
                try:
                    self.apply_pending()
                except Exception as exc:
                    with self._stat_lock:
                        self.consecutive_failures += 1
                        self.updater_restarts += 1
                        self.last_error = dict(
                            time=time.time(), error=repr(exc),
                            traceback=traceback.format_exc())
                        fails = self.consecutive_failures
                    try:
                        self._recover_state()
                    except Exception:   # pragma: no cover - last resort
                        pass            # keep serving; next pass retries
                    self._stop_evt.wait(min(
                        backoff_base_s * (2.0 ** (fails - 1)),
                        backoff_cap_s))
                else:
                    with self._stat_lock:
                        self.consecutive_failures = 0

        self._thread = threading.Thread(
            target=run, name="rank-updater", daemon=True)
        self._thread.start()

    def _recover_state(self) -> None:
        """Re-materialize a consistent working state after an updater
        failure.  A failure *before* `dg.apply` leaves the state valid
        (just re-derive the residual exactly); a failure *after* leaves
        the state a version behind the graph — pad the iterate to the new
        node count and rebuild the exact residual against the current
        graph, falling back to a cold solve if even that fails.  The
        stable snapshot is untouched: it stays the last *certified*
        publish, and the recovered state only reaches readers after the
        next successful (certified) update."""
        with self._lock:
            st = self._state
            n = self.dg.n
            cold = False
            try:
                if st.v is not None and (st.x.shape[0] != n
                                         or st.version != self.dg.version):
                    # a custom teleport vector cannot be padded to new
                    # nodes meaningfully — rebuild from scratch
                    raise ValueError("custom-v state behind the graph")
                if st.x.shape[0] != n or st.version != self.dg.version:
                    x = np.zeros(n)
                    m = min(int(st.x.shape[0]), n)
                    x[:m] = st.x[:m]
                    self._state = RankState(
                        x=x, r=_exact_residual(self.dg, x, self.alpha,
                                               st.v),
                        version=self.dg.version, alpha=st.alpha, v=st.v)
                else:
                    # same version/shape: the iterate is fine, only the
                    # maintained residual is suspect — re-derive it
                    refresh_residual(self.dg, st)
            except Exception:
                cold = True
                self._state = cold_state(
                    self.dg, alpha=self.alpha, tol=self.tol,
                    backend=self.backend, method=self.method,
                    device=self.device)
            self._batches_since_refresh = 0
            self._note_state_recovery(cold)

    def _note_state_recovery(self, cold: bool) -> None:
        """The one place recovery telemetry reconciles, under
        `_stat_lock`.  The cold-fallback path used to move *no* counters:
        a cold rebuild re-certifies through a full solver pass — a
        fallback in every sense `fallbacks` counts — yet the counter (and
        any recovery signal) stayed stale across it, so `metrics()`
        readers saw an "all pushes" server that had in fact been rebuilt
        from scratch."""
        with self._stat_lock:
            self.state_recoveries += 1
            if cold:
                self.cold_rebuilds += 1
                self.fallbacks += 1

    def health(self) -> Dict[str, object]:
        """Liveness + degradation signal for operators/load-balancers.

        status: "ok" (serving, updater healthy), "degraded" (serving
        from the last certified snapshot while the updater recovers from
        failures), "dead" (updater thread exited unexpectedly — should
        be unreachable, the run loop traps exceptions)."""
        snap = self._snapshot
        started = self._thread is not None
        alive = bool(started and self._thread.is_alive())
        with self._stat_lock:
            last_error = self.last_error
            fails = self.consecutive_failures
            restarts = self.updater_restarts
        if started and not alive and not self._stop_evt.is_set():
            status = "dead"
        elif fails > 0:
            status = "degraded"
        else:
            status = "ok"
        return dict(
            status=status, updater_started=started, updater_alive=alive,
            last_error=last_error, consecutive_failures=fails,
            updater_restarts=restarts, snapshot_seq=int(snap.seq),
            snapshot_cert=float(snap.cert),
            version_lag=int(max(self.dg.version - snap.version, 0)),
            pending_deltas=int(self._queue.qsize()))

    def metrics(self) -> Dict[str, object]:
        """One reconciled snapshot of every counter the server keeps,
        plus the serving-freshness gauges (staleness, certificate bound,
        snapshot seq, updater restarts) — the machine-readable companion
        of `health()` and the source for `metrics_text()`.  Counters are
        read together under `_stat_lock`, so a concurrent updater can
        never yield a snapshot where e.g. `cold_rebuilds` moved but
        `fallbacks` did not."""
        stale = self.staleness()
        snap = self._snapshot
        started = self._thread is not None
        alive = bool(started and self._thread.is_alive())
        with self._stat_lock:
            m: Dict[str, object] = dict(
                deltas_ingested=int(self.deltas_ingested),
                batches_applied=int(self.batches_applied),
                fallbacks=int(self.fallbacks),
                queries_served=int(self.queries_served),
                state_recoveries=int(self.state_recoveries),
                cold_rebuilds=int(self.cold_rebuilds),
                consecutive_failures=int(self.consecutive_failures),
                updater_restarts=int(self.updater_restarts),
            )
        m.update(
            updater_started=started, updater_alive=alive,
            snapshot_seq=int(snap.seq), snapshot_cert=float(snap.cert),
            version_lag=int(stale["version_lag"]),
            pending_deltas=int(stale["pending_deltas"]),
            snapshot_age_s=float(stale["age_s"]))
        return m

    def metrics_text(self) -> str:
        """Prometheus text exposition of `metrics()` (rendered by
        `runtime.observe.render_prometheus`; scrape-ready)."""
        m = self.metrics()
        fams = [(k, "counter", m[k]) for k in (
            "deltas_ingested", "batches_applied", "fallbacks",
            "queries_served", "state_recoveries", "cold_rebuilds",
            "updater_restarts")]
        fams += [(k, "gauge", float(m[k])) for k in (  # type: ignore
            "consecutive_failures", "snapshot_seq", "snapshot_cert",
            "version_lag", "pending_deltas", "snapshot_age_s",
            "updater_alive")]
        return render_prometheus(fams, prefix="repro_rank_server")

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        if self._thread is None:
            return
        if drain:
            deadline = time.time() + timeout
            while not self._queue.empty() and time.time() < deadline:
                time.sleep(0.005)
        self._stop_evt.set()
        self._thread.join(timeout=timeout)
        self._thread = None
        if drain and not self._queue.empty():
            self.apply_pending()

    # ------------------------------------------------------------------
    # queries (stable buffer only)
    # ------------------------------------------------------------------
    def top_k(self, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        with self._stat_lock:
            self.queries_served += 1
        return self._snapshot.top_k(k)

    def scores(self, ids) -> np.ndarray:
        with self._stat_lock:
            self.queries_served += 1
        return self._snapshot.scores(ids)

    def personalized(self, seeds, weights=None, tol: float = 1e-4):
        """Approximate personalized PageRank served against the stable
        snapshot's frozen graph.  Returns (x, cert, stats); cert bounds
        ||x - x*||_1 against the snapshot's own graph version.

        Plain servers answer with a per-query Gauss-Southwell push solve
        (push-local; never blocks the updater).  With a `QueryBatcher`
        attached (serving.attach_query_tier) concurrent calls fuse into
        one (n, nv) lane solve; with a `PPRCache` attached, repeats whose
        certified drift bound still clears `tol` return without solving.
        """
        with self._stat_lock:
            self.queries_served += 1
        snap = self._snapshot
        cache = self._ppr_cache
        if cache is not None:
            hit = cache.get(snap, seeds, weights, tol)
            if hit is not None:
                return hit
        # with a cache attached, solve misses to half the query tol: a
        # push stops just under its target, so a tol-solved entry would
        # enter the cache with no headroom and die on the first delta
        # that moves any of its mass — half-tol entries survive real
        # version drift (see serving/ppr_cache.py)
        solve_tol = 0.5 * tol if cache is not None else tol
        batcher = self._ppr_batcher
        if batcher is not None:
            x, cert, stats, snap = batcher.submit(seeds, weights,
                                                  solve_tol)
        else:
            x, cert, stats = ppr_push(snap.view, seeds, weights=weights,
                                      alpha=self.alpha, tol=solve_tol)
        if cache is not None and np.isfinite(cert):
            cache.put(snap, seeds, weights, tol, x, cert)
        return x, cert, stats

    def staleness(self) -> Dict[str, float]:
        """How far behind the stable buffer is, right now.

        Seqlock-style read: the graph version is captured *with* the
        snapshot (re-read until the snapshot reference is stable around
        the version read), so a daemon updater mid-`dg.apply`/publish
        cannot produce a lag computed against a snapshot from a different
        instant.  Lag is clamped at 0: `dg.version` is bumped before the
        matching snapshot publishes, never after."""
        for _ in range(8):
            snap = self._snapshot
            version = self.dg.version
            if self._snapshot is snap:
                break
        return dict(
            version_lag=float(max(version - snap.version, 0)),
            pending_deltas=float(self._queue.qsize()),
            age_s=float(time.time() - snap.published_at),
            cert=float(snap.cert),
            seq=float(snap.seq),
        )
