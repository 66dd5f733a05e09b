"""Replica router: staleness-bounded reads over snapshot fan-out (the JAX
package's serving/router.py, copied: host code, so its admissions and
redirects equal the reference's).

Scaling reads means many holders of the stable buffer, and the
`RankSnapshot` is built for that: immutable, certified, version-stamped.
A `ReadReplica` is nothing but an atomic reference to the latest snapshot
it received — replicas never copy the rank vector, never lock, and serve
`top_k`/`scores`/`personalized` straight off their reference.  The
updating `RankServer` fans each publish out through `subscribe()`
(`_cut_snapshot` → every replica's `install`), so replica installs are
reference swaps on the updater thread.

The `QueryRouter` fronts N replicas with *staleness-bounded reads*: a
replica may answer only while its snapshot is admissible against the
bounds —

    version lag  <= max_version_lag   (graph versions behind dg.version)
    cert         <= max_cert          (published L1 certificate), optional
    age          <= max_age_s         (wall-clock since publish), optional

A read landing on an inadmissible replica either raises
`StalenessBoundExceeded` (on_stale="reject") or is redirected to the
freshest admissible replica (on_stale="redirect", the default) and only
raises when no replica qualifies.  Replicas can be `pause()`d (stop
installing publishes) to simulate a partitioned or lagging holder — the
router routes around it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..streaming.incremental import ppr_push


class StalenessBoundExceeded(RuntimeError):
    """No admissible replica could serve the read within the bounds."""


class ReadReplica:
    """An atomic holder of the latest installed `RankSnapshot`."""

    def __init__(self, name: str):
        self.name = name
        self._snap = None
        self._paused = False
        self.installs = 0
        self.served = 0

    def install(self, snap) -> None:
        """Publish fan-out target (runs on the updater thread)."""
        if not self._paused:
            self._snap = snap    # atomic reference swap
            self.installs += 1

    def pause(self) -> None:
        """Stop accepting installs (simulates a partitioned replica)."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    @property
    def snapshot(self):
        return self._snap


class QueryRouter:
    """Round-robin router with staleness-bounded reads over replicas."""

    def __init__(self, server, replicas: int = 2, *,
                 max_version_lag: int = 0,
                 max_cert: Optional[float] = None,
                 max_age_s: Optional[float] = None,
                 on_stale: str = "redirect"):
        if replicas < 1:
            raise ValueError("need at least one replica")
        if on_stale not in ("redirect", "reject"):
            raise ValueError(f"unknown on_stale {on_stale!r}; expected "
                             "'redirect' or 'reject'")
        self.server = server
        self.max_version_lag = int(max_version_lag)
        self.max_cert = max_cert
        self.max_age_s = max_age_s
        self.on_stale = on_stale
        self.replicas: List[ReadReplica] = [
            ReadReplica(f"replica-{i}") for i in range(replicas)]
        for rep in self.replicas:
            server.subscribe(rep.install)
        self._rr = 0
        self._lock = threading.Lock()
        # telemetry
        self.routed = 0
        self.redirects = 0
        self.rejects = 0

    # ------------------------------------------------------------------
    def _admissible(self, snap) -> bool:
        if snap is None:
            return False
        lag = self.server.dg.version - snap.version
        if lag > self.max_version_lag:
            return False
        if self.max_cert is not None and snap.cert > self.max_cert:
            return False
        if self.max_age_s is not None \
                and time.time() - snap.published_at > self.max_age_s:
            return False
        return True

    def _pick(self) -> "tuple[ReadReplica, object]":
        """Round-robin pick, then enforce the staleness bound: redirect
        to the freshest admissible replica or raise."""
        with self._lock:
            rep = self.replicas[self._rr % len(self.replicas)]
            self._rr += 1
            self.routed += 1
        snap = rep.snapshot
        if self._admissible(snap):
            rep.served += 1
            return rep, snap
        if self.on_stale == "reject":
            with self._lock:
                self.rejects += 1
            raise StalenessBoundExceeded(
                f"{rep.name} snapshot (version "
                f"{None if snap is None else snap.version}) violates the "
                f"staleness bound (graph at {self.server.dg.version})")
        best, best_snap = None, None
        for cand in self.replicas:
            s = cand.snapshot
            if self._admissible(s) and (
                    best_snap is None or s.version > best_snap.version
                    or (s.version == best_snap.version
                        and s.seq > best_snap.seq)):
                best, best_snap = cand, s
        if best is None:
            with self._lock:
                self.rejects += 1
            raise StalenessBoundExceeded(
                "no replica within the staleness bound "
                f"(graph at version {self.server.dg.version})")
        with self._lock:
            self.redirects += 1
        best.served += 1
        return best, best_snap

    # ------------------------------------------------------------------
    # staleness-bounded reads
    # ------------------------------------------------------------------
    def top_k(self, k: int = 10):
        _, snap = self._pick()
        return snap.top_k(k)

    def scores(self, ids) -> np.ndarray:
        _, snap = self._pick()
        return snap.scores(ids)

    def personalized(self, seeds, weights=None, tol: float = 1e-4):
        """Replica-local PPR: pushed against the chosen replica's frozen
        view, so the certificate is against that snapshot's version (the
        one the staleness bound just admitted)."""
        _, snap = self._pick()
        return ppr_push(snap.view, seeds, weights=weights,
                        alpha=self.server.alpha, tol=tol)

    def stats(self) -> Dict[str, object]:
        return dict(
            routed=self.routed, redirects=self.redirects,
            rejects=self.rejects,
            replicas=[dict(name=r.name, installs=r.installs,
                           served=r.served, paused=r._paused,
                           version=(None if r.snapshot is None
                                    else int(r.snapshot.version)))
                      for r in self.replicas])
