"""AsyncShardExecutor — the eq. (5) cycle over real worker threads (the
JAX package's runtime/executor.py, copied).

The DES engine simulates asynchrony event by event, the shard program
batches it into supersteps, and the superstep streaming loop runs its p
shard drains one after another on one host thread.  This executor makes
the asynchrony real: each shard's local drain runs on its own worker thread and the three
synchronizing phases of the paper's cycle are gone —

  * no exchange barrier: residual mass a shard diffuses into rows another
    shard owns moves through a per-(src, dst) **mailbox** (a lock-protected
    accumulator).  The sender deposits whenever its `ExchangePlan` says so
    (`wants`/`gate_mass` consulted after every local update, `note_sent`
    advancing the §6 refresh clock — including on empty-outbox epochs, so
    quiet pairs never accumulate forced-refresh debt); the receiver folds
    its incoming mailboxes into its own rows whenever it next looks.
  * no reduction barrier: termination runs the Fig. 1 protocol in its
    **message rendering** (`TerminationDriver.ue_step`/`monitor_recv`).
    After each local update a shard evaluates its own residual value
    against its share of the target and the edge-triggered CONVERGE /
    DIVERGE messages are delivered to the monitor under the driver lock —
    the all-reduce of the superstep rendering is never formed.
  * no termination barrier: STOP is a shared event workers observe at the
    top of their loop; nobody waits for anybody's round to finish.

Soundness rests on the same mass-conservation invariant as the superstep
loop, now stated per *data structure* instead of per superstep: every unit
of residual mass lives in exactly one place at any instant — some shard's
own rows (`r[s:e]`), the sender's undelivered outbox, a mailbox in flight,
or the pending uniform scalar — and each structure is counted in exactly
one shard's reported value: own rows + own outbox + *mailbox mass this
shard put in flight* + the uniform share of its rows.  In-flight mass is
deliberately counted by the sender: it leaves the sender's books only
after the receiver has folded it into rows the receiver itself counts, so
a deposit can never be unreported at the instant the monitor evaluates
STOP — the handoff can transiently *double*-count (sender's value is
stale while the receiver drains), which is sound: over-counts delay
convergence, they never fake it.  The one remaining under-count window
(a shard whose value predates a peer's uniform-scalar add) is covered by
the Fig. 1 persistence counters and by the caller: `run()` folds every
structure back into `r` before returning, so the caller can recompute the
exact residual and re-enter the drain if a race let STOP fire early (see
`streaming/sharded.py`, which publishes only exactly-recomputed
certificates in async mode).

Determinism caveat: thread scheduling makes the async schedule — rounds,
exchange epochs, push counts — run-to-run nondeterministic.  The superstep
loop is the deterministic golden reference; the *results* of both agree to
within the certified tolerance.

The cycle itself — intake, hysteresis-gated drain, §6-gated exchange,
Fig. 1 report — lives in `runtime/transport.py` (`shard_worker_loop`),
written once against the `TransportContext` seam.  This class is the
thread rendering (`ThreadedShardTransport` under the hood);
`transport.ProcPoolShardExecutor` is the shared-memory process-pool
rendering whose raw wall-clock escapes the GIL.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.partition import Partition
from .driver import TerminationDriver
from .exchange import ExchangePlan
from .faults import FaultPlan, FaultState
from .observe import ShardObserver
from .schedule import DEFAULT_SCHEDULE, ScheduleSpec
from .transport import (AsyncRunResult, DrainFn, PairMailbox,  # noqa: F401
                        ThreadedShardTransport, UniformAccumulator,
                        WorkerConfig)


class AsyncShardExecutor:
    """Run p shard drains concurrently, one worker thread per shard, with
    mailbox exchange and message-rendered Fig. 1 termination (see module
    docstring for the protocol and its soundness argument).

    The executor owns the concurrency plumbing — mailboxes, the uniform
    scalar, the driver lock, stop propagation, telemetry — and is handed
    the actual local update as a `DrainFn`, so it stays independent of the
    problem being iterated (the streaming updater passes its
    Gauss-Southwell sweep; tests pass synthetic kernels).
    """

    def __init__(self, part: Partition, plan: ExchangePlan,
                 driver: TerminationDriver, *, l1_target: float,
                 bytes_per_entry: int = 8, max_rounds: int = 1_000_000,
                 max_total_pushes: Optional[int] = None,
                 idle_sleep: float = 2e-4, drain_frac: float = 0.05,
                 hysteresis: float = 2.0,
                 faults: Optional[FaultPlan] = None,
                 fault_state: Optional[FaultState] = None,
                 max_restarts: Optional[int] = None,
                 observe: Optional[ShardObserver] = None,
                 schedule: ScheduleSpec = DEFAULT_SCHEDULE):
        if driver.p != part.p or plan.p != part.p:
            raise ValueError(f"partition ({part.p}), plan ({plan.p}) and "
                             f"driver ({driver.p}) disagree on p")
        self.part = part
        self.p = part.p
        self.plan = plan
        self.driver = driver
        self.l1_target = float(l1_target)
        self.bytes_per_entry = int(bytes_per_entry)
        self.max_rounds = int(max_rounds)
        self.max_total_pushes = max_total_pushes
        self.idle_sleep = float(idle_sleep)
        self.drain_frac = float(drain_frac)
        self.hysteresis = float(hysteresis)
        self.faults = faults if (faults is not None and faults.active) \
            else None
        self.fault_state = fault_state
        self.max_restarts = max_restarts
        # an armed ShardObserver (runtime/observe.py) traces the run;
        # None keeps the zero-cost default
        self.observe = observe
        # DrainSchedule spec: the worker loop builds its exchange gate
        # from this (the drain-order half lives in the caller's DrainFn)
        self.schedule = schedule

    def run(self, drain_fn: DrainFn, r: np.ndarray) -> AsyncRunResult:
        """Drive the drains until STOP or a cap; on return every mailbox,
        outbox and pending uniform delta has been folded back into `r`, so
        `r` is again the one exactly-maintained residual.

        The transport is built here, not in __init__, so the knob
        attributes stay live until run() — callers (and tests) may tune
        `ex.max_rounds` etc. after construction.
        """
        transport = ThreadedShardTransport(
            self.part, self.plan, self.driver, WorkerConfig(
                l1_target=float(self.l1_target),
                bytes_per_entry=int(self.bytes_per_entry),
                max_rounds=int(self.max_rounds),
                max_total_pushes=self.max_total_pushes,
                idle_sleep=float(self.idle_sleep),
                drain_frac=float(self.drain_frac),
                hysteresis=float(self.hysteresis),
                schedule=self.schedule),
            faults=self.faults, fault_state=self.fault_state,
            max_restarts=self.max_restarts, observe=self.observe)
        return transport.run(drain_fn, r)
