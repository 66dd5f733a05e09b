"""Query batcher: fuse concurrent personalized() calls into lane solves
(the JAX package's serving/batcher.py; the lane solves run on `device`).

One personalized query is a push solve that walks the graph alone; nv
concurrent queries through `ppr_push_batched` share every CSR/BSR block
load across the (n, nv) teleport lanes of `core.backend` — on the card the
CSR kernel's float64 lanes (backend "auto" or "segment_sum") or the block
kernel and its hub lane ("bsr"), pointed at the query path.  The batcher is the admission window that turns independent
callers into those lanes:

  * callers enqueue and block on a per-query event;
  * a collector thread dispatches a batch when either `max_batch` queries
    are waiting or the oldest has waited `max_delay_s` (the classic
    size-or-deadline window: bounded added latency, unbounded fusion
    opportunity under load);
  * the batch is solved against ONE snapshot (the stable buffer at
    dispatch), so every answer in a batch certifies against the same
    graph version — mixed per-query tolerances ride the solver's
    per-lane tol, and lane freezing keeps loose queries from paying for
    tight ones;
  * a single waiting query skips the lane solve and takes the plain
    push path (localized seeds beat a full-vector solve at nv=1);
  * an error in a batch's solve is handed to every waiter of that batch
    and raised in its caller's thread: nothing is swallowed, and nothing
    falls back.

The collector thread launches the lane solves on `device` from its own
thread, on the default stream, beside the rank server's updater thread;
it sets no device of its own.

Attach with `QueryBatcher(server).attach()` (or
`serving.attach_query_tier`): attaching flips the server to
`snapshot_ops=True` so every published snapshot carries the
GoogleOperator + host P^T the fused solve and its exact certification
consume.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..streaming.incremental import ppr_push, ppr_push_batched, validate_seeds


@dataclasses.dataclass
class _Pending:
    seeds: np.ndarray
    weights: np.ndarray
    tol: float
    done: threading.Event
    result: Optional[tuple] = None
    error: Optional[BaseException] = None


class QueryBatcher:
    """Size-or-deadline admission window over `ppr_push_batched`, whose
    lane solves run on `device` (None: the CUDA card, raising without
    one)."""

    def __init__(self, server, max_batch: int = 16,
                 max_delay_s: float = 0.002,
                 backend: str = "auto", method: str = "linear",
                 freeze_lanes="auto", freeze_chunk="auto",
                 device: DeviceLike = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = resolve_device(device)
        self.server = server
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.backend = backend
        self.method = method
        self.freeze_lanes = freeze_lanes
        self.freeze_chunk = freeze_chunk
        self._pending: List[_Pending] = []
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # telemetry
        self.queries = 0
        self.batches = 0
        self.fused_lanes = 0     # queries that went through a >1 batch
        self.max_batch_seen = 0

    # ------------------------------------------------------------------
    def attach(self) -> "QueryBatcher":
        """Register on the server (personalized() starts routing here)
        and start the collector."""
        self.server.enable_snapshot_ops()
        self.server._ppr_batcher = self
        self.start()
        return self

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="ppr-batcher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Detach from the server, dispatch whatever is still waiting,
        and stop the collector."""
        if self.server._ppr_batcher is self:
            self.server._ppr_batcher = None
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    # ------------------------------------------------------------------
    def submit(self, seeds, weights, tol: float) -> tuple:
        """Block until the batch containing this query is solved; returns
        (x, cert, stats, snapshot_used).  Validation errors raise here,
        synchronously, in the caller's thread."""
        n = self.server.snapshot().n
        s, w = validate_seeds(n, seeds, weights)
        item = _Pending(seeds=s, weights=w, tol=float(tol),
                        done=threading.Event())
        with self._cv:
            if self._stop or self._thread is None:
                raise RuntimeError("QueryBatcher is not running")
            self._pending.append(item)
            self.queries += 1
            self._cv.notify_all()
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def flush(self) -> None:
        """Dispatch anything currently waiting without waiting out the
        delay window (tests and shutdown)."""
        with self._cv:
            batch = self._pending
            self._pending = []
        if batch:
            self._solve(batch)

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop and not self._pending:
                    return
                deadline = time.monotonic() + self.max_delay_s
                while (len(self._pending) < self.max_batch
                       and not self._stop):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                batch = self._pending[:self.max_batch]
                self._pending = self._pending[self.max_batch:]
            if batch:
                self._solve(batch)

    def _solve(self, batch: List[_Pending]) -> None:
        snap = self.server.snapshot()
        try:
            if len(batch) == 1 or snap.op is None:
                # nv=1 (or an op-less snapshot from before attach):
                # localized pushes win — no reason to touch every node
                for it in batch:
                    x, cert, stats = ppr_push(
                        snap.view, it.seeds, weights=it.weights,
                        alpha=self.server.alpha, tol=it.tol)
                    it.result = (x, cert, stats, snap)
            else:
                X, certs, stats = ppr_push_batched(
                    snap.view, [it.seeds for it in batch],
                    [it.weights for it in batch],
                    alpha=self.server.alpha,
                    tol=np.array([it.tol for it in batch]),
                    op=snap.op, pt_sp=snap.pt_sp,
                    backend=self.backend, method=self.method,
                    freeze_lanes=self.freeze_lanes,
                    freeze_chunk=self.freeze_chunk, device=self.device)
                for i, it in enumerate(batch):
                    it.result = (X[:, i], float(certs[i]), stats, snap)
                self.fused_lanes += len(batch)
        except BaseException as exc:   # wake every waiter, never deadlock
            for it in batch:
                it.error = exc
        finally:
            self.batches += 1
            self.max_batch_seen = max(self.max_batch_seen, len(batch))
            for it in batch:
                it.done.set()

    def stats(self) -> dict:
        return dict(queries=self.queries, batches=self.batches,
                    fused_lanes=self.fused_lanes,
                    max_batch_seen=self.max_batch_seen,
                    mean_batch=(self.queries / self.batches
                                if self.batches else 0.0))
