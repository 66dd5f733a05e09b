"""Certified-staleness PPR result cache (the JAX package's
serving/ppr_cache.py, copied: host numpy, so its hits, evictions, flushes
and bounds equal the reference's decision for decision).

A personalized query is a pure function of (seed set, weights, alpha,
graph version) — but invalidating on every version bump throws away
almost every entry in the update-while-serve steady state, where a small
delta barely moves the mass near most seed sets.  This cache keeps an
entry *across* graph versions by maintaining the one thing that certifies
it: the entry's exact linear-system residual

    r = b + alpha S x - x,      ||x - x*||_1 <= ||r||_1 / (1 - alpha)

against the CURRENT graph.  A graph delta perturbs only the transition
columns of sources whose out-row changed, so the residual advances by the
same sparse seeding rule `update_ranks` uses on the global rank state:

    r += alpha * sum_{u touched, x[u] != 0}
             x[u] * (col_new(u) - col_old(u))

— O(degree) work per touched source that actually carries cached mass,
and the resulting bound is *exact*, not a drift estimate: an entry
survives any number of versions whose deltas never touch its mass, and
dies precisely when real drift pushes ||r||_1/(1-alpha) past its tol.
(A naive Lipschitz drift bound ||x*_new - x*_old||_1 <=
2 alpha/(1-alpha) * sum_T |x*_old[u]| compounds its own slack by
~12x per version at alpha=0.85 and evicts everything after one update —
maintaining the residual is what makes cross-version caching work.)

Eviction/flush rules: node-count changes and version gaps (deltas the
cache never saw) flush everything; a touched source that flips dangling
status while carrying cached mass evicts that entry (its column change
is dense — not worth the correction); an entry whose bound exceeds its
own solve tol is dropped eagerly.

`note_update(receipt)` runs on the updater thread (under the server's
update lock, BEFORE the new snapshot publishes); `get`/`put` run on
query threads.  One internal lock serializes the table.  Memory is two
dense (n,) float64 vectors per entry — size `capacity` accordingly
(64 entries * 50k nodes ~ 50 MB).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from ..streaming.incremental import validate_seeds


@dataclasses.dataclass
class CacheHitStats:
    """Stats stand-in for a personalized() answer served from cache."""
    path: str            # "cache"
    cert: float          # the exact residual bound returned as cert
    solved_version: int  # graph version the entry was solved at
    served_version: int  # graph version it was served at (certified gap)


@dataclasses.dataclass
class _Entry:
    x: np.ndarray        # (n,) read-only PPR vector
    r: np.ndarray        # (n,) exact residual vs the CURRENT graph
    bound: float         # ||r||_1 / (1 - alpha), kept in sync with r
    tol: float           # tol it was solved at (eager-eviction threshold)
    solved_version: int


class PPRCache:
    """LRU cache of personalized PageRank results with exact
    residual-maintained certification across graph versions (see module
    docstring)."""

    def __init__(self, alpha: float = 0.85, capacity: int = 64):
        self.alpha = float(alpha)
        self.capacity = int(capacity)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._version: Optional[int] = None
        self._n: Optional[int] = None
        self._lock = threading.Lock()
        # telemetry
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.drift_rejects = 0   # entry present but bound > query tol
        self.evictions = 0
        self.flushes = 0
        self.survivals = 0       # entry crossed a version and stayed valid

    # ------------------------------------------------------------------
    @staticmethod
    def _key(n: int, seeds, weights) -> bytes:
        s, w = validate_seeds(n, seeds, weights)
        return s.tobytes() + b"|" + w.tobytes()

    def _flush_locked(self) -> None:
        if self._entries:
            self.flushes += 1
        self._entries.clear()

    # ------------------------------------------------------------------
    def note_update(self, receipt) -> None:
        """Advance every entry's exact residual across one applied delta
        (`DeltaReceipt`).  Called by the updater before it publishes the
        new snapshot, so fresh-snapshot queries can already hit."""
        if receipt is None:
            return
        alpha = self.alpha
        with self._lock:
            if receipt.n_new != receipt.n_old or (
                    self._version is not None
                    and receipt.version != self._version + 1):
                # shape change, or a version gap we never accounted for:
                # no certificate survives an unobserved delta
                self._flush_locked()
            elif self._entries:
                touched = receipt.touched
                dead = []
                for key, e in self._entries.items():
                    xt = e.x[touched]
                    live = np.flatnonzero(xt)
                    ok = True
                    for i in live:
                        xu = xt[i]
                        od, nd = receipt.old_deg[i], receipt.new_deg[i]
                        if od == 0 or nd == 0:
                            # dangling flip under cached mass: the
                            # column change is dense — evict
                            ok = False
                            break
                        e.r[receipt.old_rows[i]] -= alpha * xu / od
                        e.r[receipt.new_rows[i]] += alpha * xu / nd
                    if not ok:
                        dead.append(key)
                        continue
                    if live.size:
                        e.bound = float(np.abs(e.r).sum()) / (1.0 - alpha)
                    if e.bound > e.tol:
                        # it can never again answer the query it was
                        # solved for — drop now instead of at lookup
                        dead.append(key)
                    else:
                        self.survivals += 1
                for key in dead:
                    del self._entries[key]
                    self.evictions += 1
            self._version = receipt.version
            self._n = receipt.n_new

    # ------------------------------------------------------------------
    def get(self, snap, seeds, weights, tol: float
            ) -> Optional[Tuple[np.ndarray, float, CacheHitStats]]:
        """Certified lookup against snapshot `snap`: returns
        (x, bound, stats) only when the entry's exact residual bound
        clears `tol` at the snapshot's version, else None."""
        key = self._key(snap.n, seeds, weights)
        with self._lock:
            if self._version is not None and snap.version != self._version:
                self.misses += 1
                return None
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            if e.bound > tol:
                self.drift_rejects += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e.x, float(e.bound), CacheHitStats(
                path="cache", cert=float(e.bound),
                solved_version=e.solved_version,
                served_version=int(snap.version))

    def put(self, snap, seeds, weights, tol: float,
            x: np.ndarray, cert: float) -> bool:
        """Insert a freshly solved result, deriving its exact residual
        from the snapshot's captured operator (one host spmv).  Rejected
        (returns False) when the snapshot carries no operator
        (`snapshot_ops` off) or is not at the cache's accounted version —
        a result solved against a version whose deltas we already
        advanced past cannot be re-certified."""
        if snap.op is None or snap.pt_sp is None:
            return False
        s, w = validate_seeds(snap.n, seeds, weights)
        key = s.tobytes() + b"|" + w.tobytes()
        x = np.asarray(x, dtype=np.float64)
        from ..graph.google import GoogleOperator
        v = np.zeros(snap.n)
        v[s] = w
        op = GoogleOperator(pt=snap.op.pt, alpha=self.alpha, v=v)
        r = op.apply_linear_numpy(x, pt_sp=snap.pt_sp) - x
        bound = float(np.abs(r).sum()) / (1.0 - self.alpha)
        with self._lock:
            if self._version is None:
                self._version = int(snap.version)
                self._n = int(snap.n)
            if snap.version != self._version or snap.n != self._n \
                    or bound > tol:
                return False
            xr = x.copy()
            xr.setflags(write=False)
            self._entries[key] = _Entry(
                x=xr, r=r, bound=bound, tol=float(tol),
                solved_version=int(snap.version))
            self._entries.move_to_end(key)
            self.puts += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
            return True

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return dict(
                entries=len(self._entries), hits=self.hits,
                misses=self.misses, puts=self.puts,
                drift_rejects=self.drift_rejects,
                evictions=self.evictions, flushes=self.flushes,
                survivals=self.survivals,
                version=self._version)
