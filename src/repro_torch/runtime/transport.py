"""Transport-agnostic shard workers — the eq. (5) cycle behind one seam —
and the reduction seam of the shard runtime (the JAX package's
runtime/transport.py; the host transports are its numpy, copied).

The paper's asynchrony, made real on the host: each shard's drain runs in
its own worker (a thread, or an OS process over shared memory), with
per-pair mailboxes, no barrier of any kind, and Fig. 1 termination by
routed messages.  This module splits the executor into the parts that ARE
the paper's cycle and the parts that are merely one rendering of it:

  `shard_worker_loop`   — one shard's intake / hysteresis-gated local
                          update / §6-gated exchange / Fig. 1 report cycle,
                          written once against the `TransportContext`
                          protocol.  Every rendering runs this exact loop.
  `Channel`             — the boundary-residual conduit protocol: deposits
                          on the sender side, folds on the owner side, and
                          a stale-readable in-flight L1 for the sender-side
                          mass accounting.  `PairMailbox` is the
                          shared-address-space rendering; `ShmRing` is the
                          cross-process one (an SPSC ring of sparse payload
                          records over `multiprocessing.shared_memory`).
  `TransportContext`    — everything the loop needs from its substrate:
                          stop/cap flags, intake folding, uniform scalar,
                          value table, telemetry, and Fig. 1 routing.
                          `ThreadContext` renders it over locks + Events;
                          `ProcContext` renders it over a `ShardArena`
                          control block + rings, with the monitor machine
                          pumped by the parent.
  `ThreadedShardTransport` / `ProcPoolShardExecutor`
                        — the two host executors.  The third rendering, p
                          shard programs on one device, is
                          `runtime.device.DeviceShardTransport`.

The reduction seam of the bulk-synchronous renderings lives here too:

  HostAllReduce : a plain float64 sum on the host (the all-reduced value
                  rendering of `TerminationDriver.allreduce_step`).
  mesh_psum     : the one-card rendering of a psum over the shard mesh. The
                  shard program holds every shard's arrays on one leading
                  `p` axis, so the all-reduce is a sum over that axis, kept
                  as a size-1 axis so that it broadcasts back to every
                  shard, as a psum leaves the total on every shard.

Worker processes run numpy only.  They are forked where the platform can
(the parent may hold a CUDA context and torch's CPU thread pools, which a
forked child must never touch: a torch call in one fails on CUDA and can
hang on the CPU), so nothing a worker runs — the loop, the rings, the
fault wrapper, the caller's drain — calls torch.  `start_method="spawn"`
works as well: the worker re-imports the package (and with it torch) and
rebuilds its drain from a picklable `DrainFactory`.

Soundness is transport-independent (see runtime/executor.py's module
docstring for the full argument): every unit of residual mass lives in
exactly one structure and is counted in exactly one shard's reported
value; in-flight mass is counted by the *sender* until the receiver has
folded it into rows the receiver itself counts.  The procpool rendering
keeps the sender-side invariant with a pair of single-writer cumulative L1
counters (`sent_abs` bumped *before* the ring push, `recv_abs` bumped
*after* the fold), so the reported value can transiently over-count but
never under-count.  The procpool Fig. 1 messages ride SPSC rings to the
parent's monitor machine, which adds delivery latency the thread
rendering doesn't have — the premature-STOP races this allows are covered
by the caller's exact-recompute-and-re-enter loop (streaming/sharded.py
publishes only exactly recomputed certificates in async mode, under
either transport).

Memory-model note: the SPSC rings rely on release/acquire-ish ordering of
aligned 8-byte stores (data written before the tail bump, tail read before
the data).  CPython's eval loop plus x86-TSO give this for free; exotic
weakly-ordered hosts would need explicit fences.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from typing import TYPE_CHECKING

from ..core.partition import Partition
from ..core.termination import ComputingUEState, Msg
from .exchange import ExchangePlan
from .faults import FaultPlan, FaultState, FaultyContext, InjectedWorkerKill
from .observe import (C_CAPPED, C_CONVERGES, C_DIVERGES, C_DRAIN_MASS,
                      C_DRAIN_ROWS, C_DRAINS, C_EXCHANGE_BYTES,
                      C_EXCHANGE_ROWS, C_EXCHANGES, C_INTAKES, C_RECOVERIES,
                      C_STOPS, C_UNIFORM_FOLDS, DEFAULT_EVENT_CAP, EV_CAPPED,
                      EV_CONVERGE, EV_DIVERGE, EV_DRAIN, EV_EXCHANGE,
                      EV_INTAKE, EV_RECOVERY, EV_STOP, ShardObserver,
                      obs_ctl_entries)
from .schedule import DEFAULT_SCHEDULE, ScheduleSpec
from .state import ARENA_PREFIX, ArenaHandle, ShardArena
from .supervisor import BackoffPolicy, ShardSupervisor

if TYPE_CHECKING:      # annotation-only: runtime/driver.py -> core ->
    from .driver import TerminationDriver   # runtime cycle

# drain_fn(i, s, e, step_target, outbox) -> (pushes, dangling_mass):
# drain shard i's own rows [s, e) until their L1 is <= step_target,
# accumulating foreign-row contributions into `outbox` (addressed by
# global row id) and returning any mass destined for the dense uniform
# column as `dangling_mass` (the transport owns the shared scalar).
DrainFn = Callable[[int, int, int, float, np.ndarray], Tuple[int, float]]

# DrainFactory builds a DrainFn *inside a worker process* from the shared
# views of a ShardArena (key -> ndarray).  It must be picklable (a
# module-level class or function) when the start method is "spawn"; under
# "fork" closures also work.
DrainFactory = Callable[[Dict[str, np.ndarray]], DrainFn]


# ---------------------------------------------------------------------------
# Channel protocol + shared-address-space rendering
# ---------------------------------------------------------------------------
class Channel(Protocol):
    """One (src, dst) boundary-residual conduit: the sender deposits, the
    owner folds, and `l1()` is a stale-readable view of the mass currently
    in flight (stale reads may over-count mass just drained, never
    under-count mass deposited before the last deposit returned)."""

    def drain_into(self, r: np.ndarray, s: int, e: int) -> float: ...

    def l1(self) -> float: ...


class PairMailbox:
    """Lock-protected boundary-residual accumulator for one (src, dst)
    pair — the shared-address-space Channel.  Deposits add the sender's
    outbox block; the owner folds the buffer into its own rows.  `l1()` is
    a lock-free read of the last computed mass (stale reads only ever
    *over*-count mass that was just drained, never under-count mass that
    was deposited before the last `deposit` returned — deposits publish
    the new l1 under the lock).

    Deposits may carry a sender-assigned sequence number: a deposit whose
    seq is <= the highest already folded is a duplicated (or reordered
    stale) delivery and is dropped — the idempotent-intake hardening that
    lets `FaultPlan.dup_rate` re-deliver payloads at the wire level
    without ever minting residual mass.  Unsequenced deposits (seq=None,
    the default) keep the original always-fold semantics."""

    __slots__ = ("lock", "buf", "_l1", "_last_seq")

    def __init__(self, block_size: int):
        self.lock = threading.Lock()
        self.buf = np.zeros(block_size)
        self._l1 = 0.0
        self._last_seq = 0

    def deposit(self, block: np.ndarray, seq: Optional[int] = None) -> None:
        with self.lock:
            if seq is not None:
                if seq <= self._last_seq:
                    return              # duplicate/stale redelivery
                self._last_seq = seq
            self.buf += block
            self._l1 = float(np.abs(self.buf).sum())

    def drain_into(self, r: np.ndarray, s: int, e: int,
                   mark: Optional[np.ndarray] = None) -> float:
        """Fold the buffer into r[s:e] (the owner's rows); returns the L1
        mass moved (0.0 on the lock-free empty fast path).  When `mark`
        (a full-length uint8 row-flag array) is given, rows that received
        foreign mass are flagged — the push-inflation attribution's
        "boundary re-activation" marker (runtime/observe.py)."""
        if self._l1 == 0.0:
            return 0.0
        with self.lock:
            moved = self._l1
            if moved != 0.0:
                r[s:e] += self.buf
                if mark is not None:
                    mark[s:e][self.buf != 0.0] = 1
                self.buf[:] = 0.0
                self._l1 = 0.0
        return moved

    def l1(self) -> float:
        return self._l1


class UniformAccumulator:
    """The shared uniform-column scalar (dangling pushes smear column e/n).

    Senders `add` mass as they drain; each shard `take`s the delta since it
    last looked and applies it densely to its own rows only — the dense
    fold is sharded too, so no thread ever touches foreign rows.  Pending
    (added but not yet taken) mass is part of the sender-side residual
    accounting: `pending(i) * block_size` joins shard i's reported value.
    """

    def __init__(self, p: int):
        self._lock = threading.Lock()
        self._total = 0.0
        self._seen = np.zeros(p)

    def add(self, v: float) -> None:
        if v != 0.0:
            with self._lock:
                self._total += v

    def take(self, i: int) -> float:
        with self._lock:
            d = self._total - float(self._seen[i])
            self._seen[i] = self._total
        return d

    def pending(self, i: int) -> float:
        return self._total - float(self._seen[i])


# ---------------------------------------------------------------------------
# the cross-process Channel: an SPSC ring of sparse payload records
# ---------------------------------------------------------------------------
class ShmRing:
    """Single-producer single-consumer ring of (rows, values) payload
    records over shared-memory views.  Lock-free by construction: the
    producer owns `tail`, the consumer owns `head`, and a record's data is
    fully written before the tail bump publishes it.

    `head`/`tail` are (1,)-shaped int64 views; `cnt` is (depth,) int64;
    `idx`/`val` are (depth, cap) payload slots.  Row ids are local to the
    consumer's block.

    Optionally sequence-numbered (`seq` a (depth,) int64 slot array,
    `next_seq`/`last_seq` (1,)-shaped producer/consumer counters, all
    shared-memory views so they survive a worker restart): the producer
    stamps every record with a monotonically increasing seq, a duplicated
    delivery (`push(..., dup=True)`) re-publishes the *same* seq, and
    `pop_into` folds each seq at most once — the idempotent-intake
    hardening that makes `FaultPlan.dup_rate` and crash-replayed folds
    safe.  The five-argument form (no seq views) keeps the original
    always-fold semantics."""

    __slots__ = ("head", "tail", "cnt", "idx", "val", "depth", "cap",
                 "seq", "next_seq", "last_seq")

    def __init__(self, head, tail, cnt, idx, val, seq=None, next_seq=None,
                 last_seq=None):
        self.head, self.tail = head, tail
        self.cnt, self.idx, self.val = cnt, idx, val
        self.depth = int(cnt.shape[0])
        self.cap = int(idx.shape[1])
        self.seq, self.next_seq, self.last_seq = seq, next_seq, last_seq

    def push(self, rows: np.ndarray, vals: np.ndarray,
             dup: bool = False) -> bool:
        """Publish one record; False when the ring is full (the caller
        keeps the mass in its outbox and retries on a later update).
        `dup=True` re-publishes the previous record's sequence number (a
        wire-level duplicate the consumer will drop)."""
        h, t = int(self.head[0]), int(self.tail[0])
        if t - h >= self.depth:
            return False
        k = int(rows.size)
        slot = t % self.depth
        self.cnt[slot] = k
        self.idx[slot, :k] = rows
        self.val[slot, :k] = vals
        if self.seq is not None:
            s = int(self.next_seq[0])
            if s == 0:
                s = 1               # seq 0 is the consumer's "nothing
                # folded yet" sentinel; a zero-initialized producer
                # counter starts at 1 (single-writer, so lazy-init races
                # with nobody)
            if dup:
                s -= 1              # same seq as the record just pushed
            self.seq[slot] = s
            if not dup:
                self.next_seq[0] = s + 1
        self.tail[0] = t + 1        # publish AFTER the data is in place
        return True

    def pop_into(self, out: np.ndarray,
                 mark: Optional[np.ndarray] = None) -> float:
        """Fold every pending record into `out` (the owner's block view);
        returns the |payload| L1 folded.  Sequence-numbered records are
        folded at most once (duplicates and crash-replays are skipped);
        `last_seq` advances *before* the fold, so a consumer killed
        mid-fold can at worst lose one record (a bounded under-count the
        caller's exact recompute covers) but never double-fold.  `mark`
        (a block-shaped uint8 flag view) tags every row that received
        foreign mass — the push-inflation attribution's boundary
        re-activation marker (runtime/observe.py)."""
        moved = 0.0
        h, t = int(self.head[0]), int(self.tail[0])
        dedupe = self.seq is not None
        while h < t:
            slot = h % self.depth
            if dedupe:
                s = int(self.seq[slot])
                if s <= int(self.last_seq[0]):
                    h += 1
                    self.head[0] = h
                    continue
                self.last_seq[0] = s
            k = int(self.cnt[slot])
            ix = self.idx[slot, :k]
            v = self.val[slot, :k]
            out[ix] += v            # rows within one record are unique
            if mark is not None:
                mark[ix] = 1
            moved += float(np.abs(v).sum())
            h += 1
            self.head[0] = h        # free the slot before the next read
        return moved

    def pending_l1(self) -> float:
        """|payload| L1 of the records the consumer has not folded yet
        (seq-deduped view), WITHOUT consuming them — the supervisor's
        ground truth when it reconciles the in-flight ledgers after a
        worker death (see ShardSupervisor._recover_shard)."""
        total = 0.0
        h, t = int(self.head[0]), int(self.tail[0])
        last = int(self.last_seq[0]) if self.seq is not None else None
        while h < t:
            slot = h % self.depth
            if last is None or int(self.seq[slot]) > last:
                k = int(self.cnt[slot])
                total += float(np.abs(self.val[slot, :k]).sum())
                if last is not None:
                    last = int(self.seq[slot])  # count dups once
            h += 1
        return total

    def empty(self) -> bool:
        return int(self.tail[0]) == int(self.head[0])


# ---------------------------------------------------------------------------
# run transcript + worker configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AsyncRunResult:
    """Transcript of one transport run (telemetry only — the residual
    itself is folded back into `r` before run() returns)."""

    stopped: bool                   # the monitor issued STOP
    capped: bool                    # a round/push cap fired first
    rounds_per_shard: np.ndarray    # local updates each worker executed
    pushes_per_shard: np.ndarray
    exchanges: int                  # channel deposits that actually shipped
    bytes_moved: int                # modeled payload bytes ((idx, value))
    stop_round: int                 # issuing shard's round at STOP (-1)
    idle_s_per_shard: np.ndarray    # time spent parked waiting for mail
    wall_s: float
    recoveries: int = 0             # supervised worker restarts
    recovery_s: float = 0.0         # total death-detection -> respawned
    observed: Optional[dict] = None  # ShardObserver.observed() payload
    # (events + counters + attribution) when the run was traced; None
    # when observability was off (the zero-cost default)


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    """Per-run knobs of the shard worker loop (transport-independent).

    `drain_frac` sets the sliding per-round drain target
    (drain_frac * reported_total / p) and `hysteresis` how far above it
    own mass must rise before a drain fires.  Their product is bounded:
    with balanced shards each holds ~total/p, so
    ``hysteresis * drain_frac >= 1`` means no shard can ever clear its
    own gate — a livelock (every worker parks until the round cap).
    Rejected here.

    `schedule` is the DrainSchedule spec (runtime/schedule.py): the loop
    builds its boundary-batched exchange gate from it, and because the
    config is pickled into procpool workers whole, the same spec reaches
    every incarnation of every worker unchanged.  (The drain-order half of
    a spec lives in the DrainFn — built by the caller's drain factory —
    not here: the loop never looks inside a drain.)
    """

    l1_target: float
    bytes_per_entry: int = 8
    max_rounds: int = 1_000_000
    max_total_pushes: Optional[int] = None
    idle_sleep: float = 2e-4
    drain_frac: float = 0.05
    hysteresis: float = 2.0
    schedule: ScheduleSpec = DEFAULT_SCHEDULE

    def __post_init__(self):
        if self.hysteresis * self.drain_frac >= 1.0:
            raise ValueError(
                f"hysteresis ({self.hysteresis}) * drain_frac "
                f"({self.drain_frac}) >= 1: balanced shards could never "
                "clear the drain gate (livelock)")


# ---------------------------------------------------------------------------
# TransportContext — what one shard's loop needs from its substrate
# ---------------------------------------------------------------------------
class TransportContext(Protocol):
    """The seam between the paper's cycle and its execution substrate.
    All methods are called from the worker that owns shard `i` only,
    except where noted; implementations decide what is a lock, a shared
    Event, or a shared-memory cell."""

    def stopped(self) -> bool: ...

    def note_capped(self) -> None: ...

    def outbox(self, i: int) -> np.ndarray: ...

    def intake_ready(self, i: int) -> bool: ...

    def retract(self, i: int) -> None: ...

    def fold_intake(self, i: int, r: np.ndarray, s: int, e: int) -> bool: ...

    def uniform_add(self, i: int, v: float) -> None: ...

    def uniform_pending(self, i: int) -> float: ...

    def values_total(self) -> float: ...

    def publish_value(self, i: int, v: float) -> None: ...

    def add_pushes(self, i: int, k: int) -> None: ...

    def total_pushes(self) -> int: ...

    def send(self, i: int, d: int, box: np.ndarray) -> int: ...

    def note_exchange(self, i: int, nz: int) -> None: ...

    def inflight_l1(self, i: int) -> float: ...

    def report(self, i: int, verdict: bool, it: int) -> bool: ...

    def idle_wait(self, seconds: float) -> None: ...

    def record_rounds(self, i: int, it: int) -> None: ...

    def record_idle(self, i: int, seconds: float) -> None: ...


# ---------------------------------------------------------------------------
# the shard worker loop — the cycle itself, written once
# ---------------------------------------------------------------------------
def shard_worker_loop(i: int, r: np.ndarray, part: Partition,
                      plan: ExchangePlan, cfg: WorkerConfig,
                      ctx: TransportContext, drain_fn: DrainFn,
                      obs: Optional[ShardObserver] = None) -> None:
    """One round = one intake + (gated) local update + one Fig. 1
    checkConvergence().  The ExchangePlan runs on its own clock of *local
    updates*: drain rounds tick it, idle-converged spin rounds do not (a
    spin-round clock would force-ship every withheld sub-threshold
    payload within `refresh_every * idle_sleep`, defeating the §6 gate),
    and a round parked *above* the convergence target with the plan
    withholding still ticks — that keeps the forced-refresh bound live,
    so significant parked mass always ships within `refresh_every` local
    updates.  Converged shards may withhold sub-threshold mass
    indefinitely: it is counted in their reported value, so the
    certificate stays sound.

    `obs` arms the observability layer (runtime/observe.py): structured
    events at every cycle seam (intake / drain / exchange / Fig. 1
    verdict flips / STOP / caps) plus the per-shard counter slots.  The
    default None is the zero-cost path — every hook is one predictable
    branch.

    The round body itself lives in `step.HostShardStep` — the host
    rendering of the per-shard step (the tensor rendering of the same
    cycle drives `core.spmd` and the device transport, see
    runtime/step.py).  This function is the thin host driver: construct
    the step, spin rounds until an exit path fires, record telemetry.
    """
    from .step import HostShardStep
    step = HostShardStep(i, r, part, plan, cfg, ctx, drain_fn, obs)
    try:
        while step.round():
            pass
    finally:
        ctx.record_rounds(i, step.it)
        ctx.record_idle(i, step.idle_total)


# ---------------------------------------------------------------------------
# thread rendering
# ---------------------------------------------------------------------------
class ThreadContext:
    """TransportContext over locks, Events and in-process numpy buffers."""

    def __init__(self, part: Partition, driver: TerminationDriver,
                 cfg: WorkerConfig,
                 obs: Optional[ShardObserver] = None):
        p = part.p
        self.part = part
        self.driver = driver
        self.cfg = cfg
        self._obs = obs
        self.mail = [[PairMailbox(part.block(d)[1] - part.block(d)[0])
                      if d != i else None for d in range(p)]
                     for i in range(p)]
        self.outboxes = [np.zeros(part.n) for _ in range(p)]
        self.uniform = UniformAccumulator(p)
        self.driver_lock = threading.Lock()
        self.stat_lock = threading.Lock()
        self.stop_evt = threading.Event()
        self.rounds = np.zeros(p, dtype=np.int64)
        self.pushes = np.zeros(p, dtype=np.int64)
        self.idle_s = np.zeros(p)
        self.last_values = np.zeros(p)
        self.shared = dict(exchanges=0, bytes_moved=0, stop_round=-1,
                           capped=False)
        self._inboxes = [[self.mail[j][i] for j in range(p) if j != i]
                         for i in range(p)]
        # per-pair delivery sequence (writer: shard i only) — lets the
        # mailboxes drop wire-level duplicates; survives worker restarts
        # because the context outlives its workers
        self._next_seq = np.ones((p, p), dtype=np.int64)

    # -- stop/caps -------------------------------------------------------
    def stopped(self) -> bool:
        return self.stop_evt.is_set()

    def note_capped(self) -> None:
        self.shared["capped"] = True
        self.stop_evt.set()

    # -- structures ------------------------------------------------------
    def outbox(self, i: int) -> np.ndarray:
        return self.outboxes[i]

    def intake_ready(self, i: int) -> bool:
        return (self.uniform.pending(i) != 0.0
                or any(mb.l1() != 0.0 for mb in self._inboxes[i]))

    def retract(self, i: int) -> None:
        with self.driver_lock:
            if not self.driver.stopped:
                msg = self.driver.ue_step(i, False)
                if msg is not None:
                    self.driver.monitor_recv(i, msg)

    def fold_intake(self, i: int, r: np.ndarray, s: int, e: int) -> bool:
        progressed = False
        obs = self._obs
        mark = obs.foreign if (obs is not None
                               and obs.foreign is not None) else None
        for mb in self._inboxes[i]:
            if mb.drain_into(r, s, e, mark=mark) != 0.0:
                progressed = True
        dc = self.uniform.take(i)
        if dc != 0.0:
            r[s:e] += dc
            if obs is not None:
                obs.ctr[i, C_UNIFORM_FOLDS] += 1
            progressed = True
        return progressed

    def uniform_add(self, i: int, v: float) -> None:
        self.uniform.add(v)

    def uniform_pending(self, i: int) -> float:
        return self.uniform.pending(i)

    def values_total(self) -> float:
        return float(self.last_values.sum())

    def publish_value(self, i: int, v: float) -> None:
        self.last_values[i] = v

    def add_pushes(self, i: int, k: int) -> None:
        self.pushes[i] += k

    def total_pushes(self) -> int:
        return int(self.pushes.sum())

    def send(self, i: int, d: int, box: np.ndarray,
             dup: bool = False) -> int:
        nz = int(np.count_nonzero(box))
        seq = int(self._next_seq[i, d])
        self._next_seq[i, d] = seq + 1
        mb = self.mail[i][d]
        mb.deposit(box, seq=seq)
        if dup:
            mb.deposit(box, seq=seq)    # wire duplicate: deduped intake
        box[:] = 0.0
        return nz

    def note_exchange(self, i: int, nz: int) -> None:
        with self.stat_lock:
            self.shared["exchanges"] += 1
            self.shared["bytes_moved"] += nz * (4 + self.cfg.bytes_per_entry)

    def inflight_l1(self, i: int) -> float:
        return sum(self.mail[i][d].l1() for d in range(self.part.p)
                   if d != i)

    def report(self, i: int, verdict: bool, it: int) -> bool:
        with self.driver_lock:
            if not self.driver.stopped:
                msg = self.driver.ue_step(i, verdict)
                if msg is not None and self.driver.monitor_recv(i, msg):
                    self.shared["stop_round"] = it
                    self.stop_evt.set()
                    return True
        return False

    def idle_wait(self, seconds: float) -> None:
        self.stop_evt.wait(seconds)

    def record_rounds(self, i: int, it: int) -> None:
        self.rounds[i] = it

    def record_idle(self, i: int, seconds: float) -> None:
        self.idle_s[i] = seconds


class ThreadedShardTransport:
    """Run p shard drains concurrently, one worker thread per shard — a
    thin shell around `shard_worker_loop` + `ThreadContext`
    (AsyncShardExecutor delegates here)."""

    def __init__(self, part: Partition, plan: ExchangePlan,
                 driver: TerminationDriver, cfg: WorkerConfig,
                 faults: Optional[FaultPlan] = None,
                 fault_state: Optional[FaultState] = None,
                 max_restarts: Optional[int] = None,
                 restart_backoff: BackoffPolicy = BackoffPolicy(),
                 observe: Optional[ShardObserver] = None):
        if driver.p != part.p or plan.p != part.p:
            raise ValueError(f"partition ({part.p}), plan ({plan.p}) and "
                             f"driver ({driver.p}) disagree on p")
        self.part = part
        self.plan = plan
        self.driver = driver
        self.cfg = cfg
        self.faults = faults
        self.fault_state = fault_state
        self.max_restarts = (2 * part.p if max_restarts is None
                             else int(max_restarts))
        self.restart_backoff = restart_backoff
        self.observe = observe

    def run(self, drain_fn: DrainFn, r: np.ndarray) -> AsyncRunResult:
        """Drive the drains until STOP or a cap; on return every mailbox,
        outbox and pending uniform delta has been folded back into `r`, so
        `r` is again the one exactly-maintained residual.

        An `InjectedWorkerKill` (FaultPlan kill schedule) is supervised,
        not propagated: the shard re-enters Fig. 1 conservatively
        (`driver.restart_shard` — DIVERGE until its value recomputes) and
        its loop restarts after capped exponential backoff, drawing from a
        global restart budget.  Real exceptions fail fast: the first one
        is re-raised after the fold-back."""
        p, part = self.part.p, self.part
        t0 = time.perf_counter()
        obs = self.observe
        ctx = ThreadContext(part, self.driver, self.cfg, obs=obs)
        ctx.last_values[:] = [float(np.abs(r[s:e]).sum())
                              for s, e in (part.block(i) for i in range(p))]
        wctx: TransportContext = ctx
        if self.faults is not None:
            fstate = self.fault_state or self.faults.state(p)
            wctx = FaultyContext(ctx, self.faults, part,
                                 fired=fstate.fired, kill_mode="thread",
                                 obs=obs)
        errors: List[Optional[BaseException]] = [None] * p
        budget = [self.max_restarts]
        recovery = dict(n=0, s=0.0)

        def worker(i: int) -> None:
            attempt = 0
            while True:
                try:
                    shard_worker_loop(i, r, part, self.plan, self.cfg,
                                      wctx, drain_fn, obs=obs)
                    return
                except InjectedWorkerKill:
                    with ctx.stat_lock:
                        ok = budget[0] > 0
                        if ok:
                            budget[0] -= 1
                            recovery["n"] += 1
                    if not ok:
                        errors[i] = RuntimeError(
                            f"shard worker {i} killed with the restart "
                            f"budget ({self.max_restarts}) exhausted")
                        ctx.stop_evt.set()
                        return
                    if ctx.stopped():
                        return
                    t_rec = time.perf_counter()
                    with ctx.driver_lock:
                        if not self.driver.stopped:
                            self.driver.restart_shard(i)
                    time.sleep(self.restart_backoff.delay(attempt))
                    attempt += 1
                    dt_rec = time.perf_counter() - t_rec
                    with ctx.stat_lock:
                        recovery["s"] += dt_rec
                    if obs is not None:
                        # shard i's own (restarting) worker writes its own
                        # ring — the single-writer invariant holds
                        obs.ctr[i, C_RECOVERIES] += 1
                        obs.emit(EV_RECOVERY, i, t_rec, dur=dt_rec,
                                 a=float(i))
                except BaseException as exc:  # pragma: no cover - reraised
                    errors[i] = exc
                    ctx.stop_evt.set()
                    return

        threads = [threading.Thread(target=worker, args=(i,),
                                    name=f"shard-drain-{i}", daemon=True)
                   for i in range(p)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        # fold every in-flight structure back into r: the caller's r is
        # again the exactly-maintained residual (mass conservation)
        for i in range(p):
            for d in range(p):
                if d != i:
                    sd, ed = part.block(d)
                    ctx.mail[i][d].drain_into(r, sd, ed)
            box = ctx.outboxes[i]
            nzr = np.flatnonzero(box)
            if nzr.size:
                r[nzr] += box[nzr]
            s, e = part.block(i)
            dc = ctx.uniform.take(i)
            if dc != 0.0:
                r[s:e] += dc

        for exc in errors:
            if exc is not None:
                raise exc

        return AsyncRunResult(
            stopped=self.driver.stopped and not ctx.shared["capped"],
            capped=ctx.shared["capped"], rounds_per_shard=ctx.rounds,
            pushes_per_shard=ctx.pushes, exchanges=ctx.shared["exchanges"],
            bytes_moved=ctx.shared["bytes_moved"],
            stop_round=ctx.shared["stop_round"],
            idle_s_per_shard=ctx.idle_s,
            wall_s=time.perf_counter() - t0,
            recoveries=recovery["n"], recovery_s=recovery["s"],
            observed=obs.observed() if obs is not None else None)


# ---------------------------------------------------------------------------
# procpool rendering — workers as processes over a ShardArena
# ---------------------------------------------------------------------------
# control-block flag indices
_F_STOP, _F_CAPPED, _F_STOP_ROUND = 0, 1, 2

_MSG_RING_DEPTH = 256


def _ctl_spec(p: int, n: int, part: Partition, ring_depth: int,
              payload_cap: int, observe: bool = False,
              obs_event_cap: int = DEFAULT_EVENT_CAP) -> Dict:
    """Layout of the transport control block: flags, per-shard telemetry,
    the uniform scalar ledger, the in-flight L1 ledgers, the outboxes and
    both ring families (mail payloads, Fig. 1 messages).

    Mail-ring slots hold at most `payload_cap` (idx, value) pairs — a
    larger boundary payload is split across records by `ProcContext.send`
    — so the reservation scales O(p^2 * depth * payload_cap), not
    O(p * depth * n): a dense-block slot layout would reserve hundreds of
    MB of /dev/shm at p=8, n~1e6 and SIGBUS a worker in containers with
    the Docker-default 64 MB tmpfs.

    `observe=True` appends the observability slots (event rings, counter
    registry, attribution flags — runtime/observe.py): putting them in
    the control segment is what makes worker-side metrics survive the
    process boundary and supervisor respawns without locks (the segment
    outlives every worker incarnation, and every slot is single-writer).
    They are only *allocated* when observing — /dev/shm stays small on
    the default path."""
    cap = min(int(part.sizes().max()), int(payload_cap))
    spec = {
        "flags": ((3,), np.int64),          # stop / capped / stop_round
        "err": ((p,), np.int64),
        "values": ((p,), np.float64),
        "rounds": ((p,), np.int64),
        "pushes": ((p,), np.int64),
        "idle_s": ((p,), np.float64),
        "exchanges": ((p,), np.int64),
        "bytes_moved": ((p,), np.int64),
        "uni_add": ((p,), np.float64),      # cumulative adds, writer = i
        "uni_seen": ((p,), np.float64),     # cumulative takes, writer = i
        "sent_abs": ((p, p), np.float64),   # |payload| shipped, writer = src
        "recv_abs": ((p, p), np.float64),   # |payload| folded, writer = dst
        "send_intent": ((p, p), np.float64),  # in-window |payload|: written
        # before the sent_abs bump, cleared after the push — the supervisor
        # rolls an uncleared intent back so a worker killed inside the
        # window can't strand a phantom in-flight payload (livelock)
        "outbox": ((p, n), np.float64),
        "mail_head": ((p, p), np.int64),    # writer = consumer (dst)
        "mail_tail": ((p, p), np.int64),    # writer = producer (src)
        "mail_cnt": ((p, p, ring_depth), np.int64),
        "mail_idx": ((p, p, ring_depth, cap), np.int32),
        "mail_val": ((p, p, ring_depth, cap), np.float64),
        "mail_seq": ((p, p, ring_depth), np.int64),   # record seqs
        "mail_next_seq": ((p, p), np.int64),  # writer = producer (src)
        "mail_last_seq": ((p, p), np.int64),  # writer = consumer (dst)
        "msg_head": ((p,), np.int64),       # consumer = parent pump
        "msg_tail": ((p,), np.int64),       # producer = shard i
        "msg_buf": ((p, _MSG_RING_DEPTH), np.int64),
        # --- self-healing state (supervisor.py) ---
        "busy": ((p,), np.int64),           # 1 while shard i is mid-sweep
        "fault_fired": ((2, p), np.int64),  # FaultPlan kill/hang gates
        "ckpt_seq": ((p,), np.int64),       # seqlock (odd = mid-write)
        "ckpt_r": ((n,), np.float64),       # per-shard residual checkpoint
        "ckpt_x": ((n,), np.float64),       # per-shard iterate checkpoint
        "restarts": ((p,), np.int64),       # writer = parent supervisor
    }
    if observe:
        spec.update(obs_ctl_entries(p, n, event_cap=obs_event_cap))
    return spec


def _ctl_ring(ctl: ShardArena, i: int, d: int) -> ShmRing:
    """The (src=i, dst=d) mail ring over the control arena, sequence-
    numbered: producer/consumer counters live in the arena too, so
    dedupe state survives a worker restart (both sides single-writer)."""
    return ShmRing(
        ctl["mail_head"][i, d:d + 1], ctl["mail_tail"][i, d:d + 1],
        ctl["mail_cnt"][i, d], ctl["mail_idx"][i, d],
        ctl["mail_val"][i, d], seq=ctl["mail_seq"][i, d],
        next_seq=ctl["mail_next_seq"][i, d:d + 1],
        last_seq=ctl["mail_last_seq"][i, d:d + 1])


class ProcContext:
    """TransportContext over a ShardArena control block: flags and
    telemetry are single-writer shared-memory cells, boundary mass moves
    through per-pair `ShmRing`s, and the Fig. 1 computing-UE machines run
    *inside* the workers with their edge-triggered messages ringed to the
    parent's monitor."""

    def __init__(self, ctl: ShardArena, part: Partition, cfg: WorkerConfig,
                 pc_max_compute: int, r: Optional[np.ndarray] = None,
                 x: Optional[np.ndarray] = None,
                 checkpoint_every: int = 0,
                 obs: Optional[ShardObserver] = None):
        self.ctl = ctl
        self.part = part
        self.cfg = cfg
        self._r = r
        self._x = x
        self._ckpt_every = int(checkpoint_every)
        self._obs = obs
        p = part.p
        self._ues = {i: ComputingUEState(pc_max=pc_max_compute)
                     for i in range(p)}
        self._mail = {}
        for i in range(p):
            for d in range(p):
                if d != i:
                    self._mail[(i, d)] = _ctl_ring(ctl, i, d)

    # -- stop/caps -------------------------------------------------------
    def stopped(self) -> bool:
        return self.ctl["flags"][_F_STOP] != 0

    def note_capped(self) -> None:
        self.ctl["flags"][_F_CAPPED] = 1
        self.ctl["flags"][_F_STOP] = 1

    # -- structures ------------------------------------------------------
    def outbox(self, i: int) -> np.ndarray:
        return self.ctl["outbox"][i]

    def intake_ready(self, i: int) -> bool:
        if self.uniform_pending(i) != 0.0:
            return True
        return any(not self._mail[(j, i)].empty()
                   for j in range(self.part.p) if j != i)

    def retract(self, i: int) -> None:
        self._ues[i], msg = self._ues[i].step(False)
        if msg is not None:
            self._post_msg(i, msg)

    def fold_intake(self, i: int, r: np.ndarray, s: int, e: int) -> bool:
        progressed = False
        own = r[s:e]
        obs = self._obs
        mark = (obs.foreign[s:e] if obs is not None
                and obs.foreign is not None else None)
        for j in range(self.part.p):
            if j == i:
                continue
            moved = self._mail[(j, i)].pop_into(own, mark=mark)
            if moved != 0.0:
                # the fold leaves the sender's books only now: recv_abs
                # is bumped AFTER the rows it covers are counted in our
                # own r (sender-side invariant, see module docstring)
                self.ctl["recv_abs"][j, i] += moved
                progressed = True
        total = float(self.ctl["uni_add"].sum())
        dc = total - float(self.ctl["uni_seen"][i])
        if dc != 0.0:
            r[s:e] += dc
            self.ctl["uni_seen"][i] = total
            if obs is not None:
                obs.ctr[i, C_UNIFORM_FOLDS] += 1
            progressed = True
        return progressed

    def uniform_add(self, i: int, v: float) -> None:
        if v != 0.0:
            self.ctl["uni_add"][i] += v

    def uniform_pending(self, i: int) -> float:
        return float(self.ctl["uni_add"].sum()
                     - self.ctl["uni_seen"][i])

    def values_total(self) -> float:
        return float(self.ctl["values"].sum())

    def publish_value(self, i: int, v: float) -> None:
        self.ctl["values"][i] = v

    def add_pushes(self, i: int, k: int) -> None:
        self.ctl["pushes"][i] += k

    def total_pushes(self) -> int:
        return int(self.ctl["pushes"].sum())

    def send(self, i: int, d: int, box: np.ndarray,
             dup: bool = False) -> int:
        rows = np.flatnonzero(box)
        ring = self._mail[(i, d)]
        cap = ring.cap
        intent = self.ctl["send_intent"]
        shipped = 0
        for lo in range(0, int(rows.size), cap):
            chunk = rows[lo:lo + cap]
            vals = box[chunk]
            mass = float(np.abs(vals).sum())
            # record intent, then bump sent_abs BEFORE the push: the mass
            # must be on the sender's books at every instant it could be
            # folded by the receiver.  If this worker is killed anywhere
            # inside the window, the supervisor rolls the uncleared
            # intent back out of sent_abs — over-counting is sound only
            # transiently; a *permanent* phantom in-flight payload would
            # hold this shard's value above target forever.
            intent[i, d] = mass
            self.ctl["sent_abs"][i, d] += mass
            if not ring.push(chunk.astype(np.int32), vals):
                # ring full: roll this record's ledger back (the receiver
                # never saw it).  Already-pushed chunks stay shipped; the
                # remainder stays in the outbox — the caller sees
                # backpressure, leaves its cached outbox L1 stale-high
                # (a sound transient over-count) and retries on a later
                # update.
                self.ctl["sent_abs"][i, d] -= mass
                intent[i, d] = 0.0
                return -1
            if dup:
                # wire-level duplicate: same payload, same seq, no ledger
                # bump — the receiver's seq-deduped fold drops it (best
                # effort; a full ring just loses the duplicate)
                ring.push(chunk.astype(np.int32), vals, dup=True)
            box[chunk] = 0.0
            intent[i, d] = 0.0
            shipped += int(chunk.size)
        return shipped

    def note_exchange(self, i: int, nz: int) -> None:
        self.ctl["exchanges"][i] += 1
        self.ctl["bytes_moved"][i] += nz * (4 + self.cfg.bytes_per_entry)

    def inflight_l1(self, i: int) -> float:
        d = (self.ctl["sent_abs"][i] - self.ctl["recv_abs"][i])
        return float(np.maximum(d, 0.0).sum())

    def report(self, i: int, verdict: bool, it: int) -> bool:
        self.ctl["rounds"][i] = it      # live, so the pump can stamp STOP
        if self._ckpt_every and self._r is not None \
                and it % self._ckpt_every == 0:
            self._checkpoint(i)
        self._ues[i], msg = self._ues[i].step(verdict)
        if msg is not None:
            self._post_msg(i, msg)
        return self.stopped()

    def _checkpoint(self, i: int) -> None:
        """Seqlock'd per-shard (r, x) checkpoint, written at report time —
        never mid-sweep, so `busy[i] == 1` implies the checkpoint is
        committed.  The supervisor restores from it when this worker dies
        inside a drain."""
        s, e = self.part.block(i)
        cs = self.ctl["ckpt_seq"]
        cs[i] += 1                      # odd: write in progress
        self.ctl["ckpt_r"][s:e] = self._r[s:e]
        if self._x is not None:
            self.ctl["ckpt_x"][s:e] = self._x[s:e]
        cs[i] += 1                      # even: committed

    def idle_wait(self, seconds: float) -> None:
        time.sleep(seconds)

    def record_rounds(self, i: int, it: int) -> None:
        self.ctl["rounds"][i] = it

    def record_idle(self, i: int, seconds: float) -> None:
        self.ctl["idle_s"][i] = seconds

    # -- Fig. 1 message ring --------------------------------------------
    def _post_msg(self, i: int, msg: Msg) -> None:
        head, tail = self.ctl["msg_head"], self.ctl["msg_tail"]
        buf = self.ctl["msg_buf"]
        while int(tail[i]) - int(head[i]) >= _MSG_RING_DEPTH:
            if self.stopped():          # pragma: no cover - pump died
                return
            time.sleep(1e-4)
        t = int(tail[i])
        buf[i, t % _MSG_RING_DEPTH] = msg.value
        tail[i] = t + 1


def _procpool_worker_main(shard_ids, data_handle: ArenaHandle,
                          ctl_handle: ArenaHandle, part: Partition,
                          plan: ExchangePlan, cfg: WorkerConfig,
                          drain_factory: DrainFactory,
                          pc_max_compute: int, r_key: str,
                          x_key: Optional[str] = None,
                          faults: Optional[FaultPlan] = None,
                          checkpoint_every: int = 0,
                          observe: bool = False) -> None:
    """Worker-process entry: attach both arenas, rebuild the drain from
    the factory, and run one `shard_worker_loop` per owned shard (several
    shards share a process when p exceeds the pool — they interleave on
    threads, which only serializes shards that were going to share a core
    anyway).

    Crash semantics changed with the supervisor: an exception bumps the
    shard's `err` counter and hard-exits the *process* (exit code 70) —
    it does NOT stamp STOP.  The parent decides whether to restart (the
    default) or give up; sibling shard threads die with the process and
    are restored from their checkpoints exactly like a SIGKILL, so one
    policy covers both."""
    import traceback
    data = ShardArena.attach(data_handle)
    ctl = ShardArena.attach(ctl_handle)
    try:
        views = {k: data[k] for k in data.keys()}
        r = views[r_key]
        x = views.get(x_key) if x_key else None
        drain_fn = drain_factory(views)
        # the worker-side observer wraps the control arena's obs_* views:
        # counters and events land in shared memory, so they survive this
        # process being SIGKILL'd and respawned
        obs = ShardObserver.from_views(ctl) if observe else None
        if obs is not None and hasattr(drain_fn, "set_observer"):
            drain_fn.set_observer(obs)   # arm push-inflation attribution
        ctx: TransportContext = ProcContext(
            ctl, part, cfg, pc_max_compute, r=r, x=x,
            checkpoint_every=checkpoint_every, obs=obs)
        if faults is not None:
            ctx = FaultyContext(ctx, faults, part,
                                fired=ctl["fault_fired"],
                                kill_mode="process", obs=obs)
        busy = ctl["busy"]

        def guarded(i, s, e, t, outbox):
            # busy flag brackets the sweep: the supervisor restores this
            # shard from its checkpoint only when the worker died with
            # the flag up (mid-sweep (x, r) may be torn); a clean-point
            # death keeps the live rows
            busy[i] = 1
            try:
                return drain_fn(i, s, e, t, outbox)
            finally:
                busy[i] = 0

        def run_one(i: int) -> None:
            try:
                shard_worker_loop(i, r, part, plan, cfg, ctx, guarded,
                                  obs=obs)
            except BaseException:
                traceback.print_exc()
                ctl["err"][i] += 1
                # hard exit: siblings checkpoint-restore like a SIGKILL
                os._exit(70)

        if len(shard_ids) == 1:
            run_one(shard_ids[0])
        else:
            ts = [threading.Thread(target=run_one, args=(i,), daemon=True)
                  for i in shard_ids]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
    except BaseException:               # pragma: no cover - defensive
        import traceback
        traceback.print_exc()
        for i in shard_ids:
            ctl["err"][i] += 1
        os._exit(70)
    finally:
        # drop views before detaching the mappings (no unlink: the parent
        # owns both segments)
        views = None
        ctx = None
        data.close(unlink=False)
        ctl.close(unlink=False)


def default_pool_size(p: int) -> int:
    """Worker-pool sizing: min(p, cores).  More processes than cores buys
    nothing (the drains are CPU-bound) and oversubscribes small
    containers."""
    return max(1, min(p, os.cpu_count() or 1))


class ProcPoolShardExecutor:
    """The procpool rendering: shard workers as OS processes over a
    `ShardArena`, mailboxes and Fig. 1 messages over lock-free shared
    rings — the first transport whose raw wall-clock escapes the GIL.

    The caller supplies the shard fragments (r, x, CSR, ...) in a data
    arena plus a picklable `DrainFactory`; the executor owns the control
    arena (flags, ledgers, outboxes, rings), the worker pool
    (`n_workers` defaults to min(p, cores) and is capped at p; asking
    for more than the machine's cores warns — the oversubscription
    guard — but the explicit request is honored, since one process per
    parked-heavy shard can kernel-schedule better than co-residence),
    and the parent-side supervisor.  On return every ring, outbox and
    pending uniform delta has been folded back into the arena's residual.

    A worker crash or kill does not abort the solve: a
    `ShardSupervisor` restarts the dead worker (checkpoint-restored
    rows, reconciled ledgers, conservative Fig. 1 re-entry — see
    supervisor.py) and only an exhausted restart budget raises, with the
    control arena released either way (nothing leaks in /dev/shm; the
    data arena belongs to the caller).  Pass `faults=FaultPlan(...)` to
    inject deterministic kill/hang/drop/dup/delay/slow schedules at the
    transport seam.
    """

    # Coarser drain scheduling than the thread rendering: cross-process
    # exchange has real latency, and deeper per-round drains mean fewer
    # boundary-payload generations — measured ~15-25% fewer total pushes
    # on the 50k drain-dominated bench than the thread defaults
    # (hysteresis * drain_frac stays well under the livelock bound 1.0).
    DRAIN_FRAC = 0.25
    HYSTERESIS = 2.5
    # A parked shard's wake-up checks (ring scans, the uniform ledger)
    # briefly take its process's GIL away from a busy process-mate when
    # shards share a worker; 1 ms wake-ups cut that tax ~5x vs the thread
    # rendering's 0.2 ms with no measurable staleness cost.
    IDLE_SLEEP = 1e-3

    def __init__(self, part: Partition, plan: ExchangePlan,
                 driver: TerminationDriver, *, l1_target: float,
                 bytes_per_entry: int = 8, max_rounds: int = 1_000_000,
                 max_total_pushes: Optional[int] = None,
                 idle_sleep: float = IDLE_SLEEP,
                 drain_frac: float = DRAIN_FRAC,
                 hysteresis: float = HYSTERESIS,
                 n_workers: Optional[int] = None,
                 ring_depth: int = 8,
                 ring_payload_cap: int = 4096,
                 start_method: Optional[str] = None,
                 faults: Optional[FaultPlan] = None,
                 fault_state: Optional[FaultState] = None,
                 max_restarts: Optional[int] = None,
                 restart_backoff: BackoffPolicy = BackoffPolicy(),
                 checkpoint_every: int = 32,
                 observe: bool = False,
                 observe_event_cap: int = DEFAULT_EVENT_CAP,
                 schedule: ScheduleSpec = DEFAULT_SCHEDULE):
        if driver.p != part.p or plan.p != part.p:
            raise ValueError(f"partition ({part.p}), plan ({plan.p}) and "
                             f"driver ({driver.p}) disagree on p")
        self.part = part
        self.p = part.p
        self.plan = plan
        self.driver = driver
        self.cfg = WorkerConfig(
            l1_target=float(l1_target), bytes_per_entry=int(bytes_per_entry),
            max_rounds=int(max_rounds), max_total_pushes=max_total_pushes,
            idle_sleep=float(idle_sleep), drain_frac=float(drain_frac),
            hysteresis=float(hysteresis), schedule=schedule)
        cores = os.cpu_count() or 1
        if n_workers is None:
            n_workers = default_pool_size(self.p)
        elif n_workers > cores:
            # oversubscription guard: honor the explicit request (the
            # kernel can still schedule busy workers onto idle cores —
            # sometimes a win when shards idle unevenly) but say so
            warnings.warn(
                f"procpool n_workers={n_workers} oversubscribes "
                f"{cores} cores; the default is min(p, cores) = "
                f"{default_pool_size(self.p)}", RuntimeWarning,
                stacklevel=2)
        self.n_workers = max(1, min(int(n_workers), self.p))
        self.ring_depth = int(ring_depth)
        self.ring_payload_cap = int(ring_payload_cap)
        self.start_method = start_method
        self.faults = faults if (faults is not None and faults.active) \
            else None
        self.fault_state = fault_state
        self.max_restarts = (2 * self.p if max_restarts is None
                             else int(max_restarts))
        self.restart_backoff = restart_backoff
        self.checkpoint_every = int(checkpoint_every)
        self.observe = bool(observe)
        self.observe_event_cap = int(observe_event_cap)

    # ------------------------------------------------------------------
    def run(self, drain_factory: DrainFactory, data: ShardArena,
            r_key: str = "r", x_key: Optional[str] = None
            ) -> AsyncRunResult:
        """Drive the drains until STOP or a cap.  `data` must hold the
        residual under `r_key` (and the iterate under `x_key` when the
        drain maintains one — required for mid-sweep checkpoint restore
        of x); the factory rebuilds the DrainFn from the attached views
        inside each worker."""
        import multiprocessing as mp

        p, part = self.p, self.part
        r = data[r_key]
        if r.shape != (part.n,):
            raise ValueError(f"data arena {r_key!r} has shape {r.shape}, "
                             f"expected ({part.n},)")
        x = data[x_key] if x_key else None
        t0 = time.perf_counter()
        method = self.start_method or (
            "fork" if "fork" in mp.get_all_start_methods() else "spawn")
        mpctx = mp.get_context(method)
        ctl = ShardArena.create(_ctl_spec(p, part.n, part, self.ring_depth,
                                          self.ring_payload_cap,
                                          observe=self.observe,
                                          obs_event_cap=(
                                              self.observe_event_cap)),
                                prefix=ARENA_PREFIX + "_ctl")
        sup: Optional[ShardSupervisor] = None
        procs: List = []
        died = False
        try:
            # seq 0 is the "nothing folded yet" sentinel on the consumer
            # side, so producers must start stamping at 1
            ctl["mail_next_seq"][:] = 1
            for i in range(p):
                s, e = part.block(i)
                ctl["values"][i] = float(np.abs(r[s:e]).sum())
            if self.faults is not None and self.fault_state is not None:
                # kill/hang schedules fire once per *update*: carry the
                # fired flags across executor runs through the caller's
                # FaultState
                ctl["fault_fired"][:] = self.fault_state.fired
            # checkpoint zero: a worker killed before its first report
            # restores to the initial rows, not to garbage
            ctl["ckpt_r"][:] = r
            if x is not None:
                ctl["ckpt_x"][:] = x
            assign = [ids for ids in
                      ([i for i in range(p) if i % self.n_workers == w]
                       for w in range(self.n_workers)) if ids]

            def spawn(w: int):
                pr = mpctx.Process(
                    target=_procpool_worker_main,
                    args=(assign[w], data.handle(), ctl.handle(), part,
                          self.plan, self.cfg, drain_factory,
                          self.driver.pc_max_compute, r_key, x_key,
                          self.faults, self.checkpoint_every,
                          self.observe),
                    name=f"shard-worker-{w}", daemon=True)
                with warnings.catch_warnings():
                    # Python warns that forking a multithreaded parent
                    # (torch's thread pools, a rank server's threads) may
                    # deadlock the child; the workers are numpy-only and
                    # never call torch, so the fork is safe — callers who
                    # want belt-and-braces can pass start_method="spawn"
                    # (slower: workers re-import the package and torch)
                    warnings.filterwarnings(
                        "ignore", message=r".*use of fork\(\) may lead "
                        r"to deadlocks.*", category=DeprecationWarning)
                    pr.start()
                return pr

            # the parent-side observer reads/writes the same arena slots:
            # supervisor recoveries land in the dead shard's ring while no
            # worker incarnation is alive (single-writer preserved), and
            # the final observed payload is read out before the arena is
            # unlinked
            pobs = (ShardObserver.from_views(ctl) if self.observe
                    else None)
            sup = ShardSupervisor(
                part, self.driver, ctl, r, x, assign, spawn,
                max_restarts=self.max_restarts,
                backoff=self.restart_backoff, obs=pobs)
            procs = [spawn(w) for w in range(len(assign))]
            died = sup.supervise(procs)
            for pr in sup.all_procs:
                pr.join()

            # fold every in-flight structure back into r (mass
            # conservation — even after a crash, whatever mass survives
            # is back in one place)
            flags = ctl["flags"]
            for i in range(p):
                for d in range(p):
                    if d != i:
                        sd, ed = part.block(d)
                        _ctl_ring(ctl, i, d).pop_into(r[sd:ed])
                box = ctl["outbox"][i]
                nzr = np.flatnonzero(box)
                if nzr.size:
                    r[nzr] += box[nzr]
            total = float(ctl["uni_add"].sum())
            for i in range(p):
                s, e = part.block(i)
                dc = total - float(ctl["uni_seen"][i])
                if dc != 0.0:
                    r[s:e] += dc
                    ctl["uni_seen"][i] = total

            if self.faults is not None and self.fault_state is not None:
                self.fault_state.fired[:] = ctl["fault_fired"]

            if died:
                # restart budget exhausted: raise with surviving mass
                # folded back and /dev/shm released.
                # (`err` counts are telemetry now: a *recovered* crash
                # must not raise.)
                errs = np.flatnonzero(ctl["err"])
                detail = (f"; shard worker(s) {errs.tolist()} raised — "
                          "see worker stderr" if errs.size else "")
                raise RuntimeError(
                    "procpool shard worker died mid-drain and the "
                    f"restart budget ({self.max_restarts}) is exhausted"
                    f"{detail}; surviving mass has been folded back "
                    "into r")

            return AsyncRunResult(
                stopped=self.driver.stopped and not bool(flags[_F_CAPPED]),
                capped=bool(flags[_F_CAPPED]),
                rounds_per_shard=ctl["rounds"].copy(),
                pushes_per_shard=ctl["pushes"].copy(),
                exchanges=int(ctl["exchanges"].sum()),
                bytes_moved=int(ctl["bytes_moved"].sum()),
                stop_round=int(flags[_F_STOP_ROUND]),
                idle_s_per_shard=ctl["idle_s"].copy(),
                wall_s=time.perf_counter() - t0,
                recoveries=sup.recoveries,
                recovery_s=sup.recovery_s,
                observed=pobs.observed() if pobs is not None else None)
        finally:
            for pr in (sup.all_procs if sup is not None and sup.all_procs
                       else procs):
                if pr.is_alive():
                    pr.terminate()
                pr.join(timeout=5.0)
            ctl.close(unlink=True)


# ---------------------------------------------------------------------------
# reduction channel — the bulk-synchronous seam
# ---------------------------------------------------------------------------
class ReductionChannel(Protocol):
    """How per-shard scalars become the global verdict: a host sum for the
    superstep/streaming renderings, a sum over the shard axis for the
    shard program."""

    def all_reduce(self, values): ...


class HostAllReduce:
    """Plain numpy sum — the host rendering (TerminationDriver's
    allreduce_step and the superstep streaming loop)."""

    def all_reduce(self, values):
        return float(np.asarray(values, dtype=np.float64).sum())


def mesh_psum(dim: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The shard-axis all-reduce, shaped for
    `TerminationDriver.bits_step(psum=...)`: a sum over the leading shard
    axis `dim`, kept as a size-1 axis."""

    def _psum(a: torch.Tensor) -> torch.Tensor:
        return a.sum(dim=dim, keepdim=True, dtype=a.dtype)
    return _psum
