"""FaultPlan — deterministic fault injection at the TransportContext seam
(the JAX package's runtime/faults.py, copied: host numpy, the same
per-link generators and draw order, so a plan yields the reference's fault
schedule draw for draw).

The paper's case for asynchronous iteration is made on *unreliable*
platforms: workers die, links drop or duplicate messages, some machines
are simply slow.  Asynchronous fixed-point theory absorbs all of it under
bounded-delay assumptions (eq. 5's tau tables don't care why a view is
stale), and Ishii–Tempo's randomized PageRank shows convergence survives
unreliable per-link communication — so the runtime must be able to
*inject* these faults on demand, deterministically, in every transport.

`FaultyContext` wraps any `TransportContext` by delegation — the
`shard_worker_loop` happy path is untouched; the wrapper intercepts the
seam calls where each fault class physically lives:

  kill   — `report()`: at the scheduled round the worker dies for real
           (SIGKILL of its own process in the procpool rendering; an
           `InjectedWorkerKill` raise in the thread rendering).  A shared
           fired-flag array keeps a restarted worker from re-firing.
  hang   — `report()`: one blocking sleep; peers keep iterating (the
           bounded-delay tolerance the paper claims), recovery is just
           the hung worker waking up.
  slow   — `add_pushes()`: a pushes/second throttle, the heterogeneous-
           platform knob.
  drop   — `send()`: the payload never leaves the sender.  Modeled as the
           channel's existing backpressure result (-1), so the mass stays
           in the outbox, stays counted in the sender's reported value,
           and retries on a later update: a *lossy link with sender
           retention*.  With drop_rate < 1 every payload eventually
           delivers — mass conservation and the certificate survive any
           drop schedule.
  dup    — `send()`: the payload is delivered twice at the wire level
           with the same sequence number; the receiving Channel
           (`PairMailbox` / `ShmRing`) folds it exactly once (seq-deduped
           intake), so duplication never mints residual mass.
  delay  — `send()`: the payload is diverted into a held buffer (counted
           via the sender's `inflight_l1`, so values never under-count)
           and delivered at least `max_delay_rounds` rounds later —
           genuinely reordered against younger payloads.

All randomness is drawn from per-(src, dst) `numpy` generators seeded by
`(seed, src, dst)`: a given plan produces the same per-link fault
schedule regardless of thread/process interleaving.

Soundness note: every injected fault
leaves the maintained residual either exact or *approximate in a bounded
way* (a killed worker can lose held/mid-sweep mass).  The streaming
caller therefore re-derives the residual with an exact O(nnz) recompute
whenever faults were injected or recoveries happened, and re-enters the
drain until the exact residual meets the target — published certificates
are always sound.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .observe import C_HANGS, C_KILLS, EV_HANG, EV_KILL, ShardObserver


class InjectedWorkerKill(Exception):
    """Raised inside a thread-rendered shard worker at its scheduled kill
    round (the procpool rendering SIGKILLs the worker process instead).
    The supervising transport treats it as a crash to recover from, not
    an error to propagate."""

    def __init__(self, shard: int):
        super().__init__(f"injected kill of shard worker {shard}")
        self.shard = shard


class FaultState:
    """Mutable fired-flags shared across drain attempts of one update (a
    kill/hang schedule fires once per *update*, not once per executor
    run).  Row 0 gates kills, row 1 gates hangs.  The procpool executor
    mirrors it through the control arena so restarted workers see it."""

    __slots__ = ("fired",)

    def __init__(self, p: int):
        self.fired = np.zeros((2, p), dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic seeded fault schedule (picklable; crosses into
    procpool workers).

    kill:  shard -> round at which its worker dies (>= that round, once).
    hang:  shard -> (round, seconds) one blocking stall.
    slow:  shard -> sustained pushes/second throttle.
    drop_rate / dup_rate / delay_rate: per-send probabilities, drawn from
    a per-(src, dst) seeded stream; their sum must stay < 1 so some sends
    deliver (drop_rate < 1 is the Ishii–Tempo condition for eventual
    delivery under sender retention).
    """

    seed: int = 0
    kill: Mapping[int, int] = dataclasses.field(default_factory=dict)
    hang: Mapping[int, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)
    slow: Mapping[int, float] = dataclasses.field(default_factory=dict)
    drop_rate: float = 0.0
    dup_rate: float = 0.0
    delay_rate: float = 0.0
    max_delay_rounds: int = 8

    def __post_init__(self):
        for nm in ("drop_rate", "dup_rate", "delay_rate"):
            v = float(getattr(self, nm))
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{nm}={v} must be in [0, 1)")
        if self.drop_rate + self.dup_rate + self.delay_rate >= 1.0:
            raise ValueError(
                "drop_rate + dup_rate + delay_rate must sum < 1: some "
                "sends must actually deliver or mass can never move")
        for i, rate in self.slow.items():
            if rate <= 0:
                raise ValueError(f"slow[{i}]={rate}: pushes/s must be > 0")
        for i, (rnd, secs) in self.hang.items():
            if secs < 0:
                raise ValueError(f"hang[{i}] seconds must be >= 0")
        if self.max_delay_rounds < 1:
            raise ValueError("max_delay_rounds must be >= 1")

    @property
    def active(self) -> bool:
        return bool(self.kill or self.hang or self.slow or self.drop_rate
                    or self.dup_rate or self.delay_rate)

    def state(self, p: int) -> FaultState:
        return FaultState(p)


class FaultyContext:
    """TransportContext wrapper injecting a FaultPlan at the seam.

    Pure delegation except at the call sites listed in the module
    docstring; thread-safe the same way the inner context is (each shard
    worker touches only its own (i, *) fault state)."""

    def __init__(self, inner, plan: FaultPlan, part, fired: np.ndarray,
                 kill_mode: str, obs: Optional[ShardObserver] = None):
        if kill_mode not in ("process", "thread"):
            raise ValueError(f"unknown kill_mode {kill_mode!r}")
        self.inner = inner
        self.plan = plan
        self.part = part
        self.fired = fired              # (2, p), shared across restarts
        self.kill_mode = kill_mode
        self._obs = obs                 # KILL/HANG instants when tracing
        p = part.p
        self._rng: Dict[Tuple[int, int], np.random.Generator] = {}
        self._held: Dict[Tuple[int, int], np.ndarray] = {}
        self._held_l1 = np.zeros((p, p))
        self._held_round = np.zeros((p, p), dtype=np.int64)
        self._round = np.zeros(p, dtype=np.int64)
        for i in range(p):
            for d in range(p):
                if d != i:
                    self._rng[(i, d)] = np.random.default_rng(
                        [int(plan.seed) & 0x7FFFFFFF, i, d])
                    sd, ed = part.block(d)
                    self._held[(i, d)] = np.zeros(ed - sd)

    # -- the intercepted seam calls -------------------------------------
    def send(self, i: int, d: int, box: np.ndarray, dup: bool = False
             ) -> int:
        plan = self.plan
        if self._held_l1[i, d] != 0.0:
            # a younger payload caught up with the held one: merge so the
            # delayed mass rides the next delivery decision
            box += self._held[(i, d)]
            self._held[(i, d)][:] = 0.0
            self._held_l1[i, d] = 0.0
        u = float(self._rng[(i, d)].random())
        if u < plan.drop_rate:
            # lossy link with sender retention: the loop sees channel
            # backpressure, keeps the mass in the outbox (still counted
            # in this shard's value) and retries on a later update
            return -1
        u -= plan.drop_rate
        if u < plan.dup_rate:
            return self.inner.send(i, d, box, dup=True)
        u -= plan.dup_rate
        if u < plan.delay_rate:
            nz = int(np.count_nonzero(box))
            self._held[(i, d)][:] = box
            self._held_l1[i, d] = float(np.abs(box).sum())
            self._held_round[i, d] = self._round[i]
            box[:] = 0.0        # held mass is counted via inflight_l1
            return nz
        return self.inner.send(i, d, box, dup=dup)

    def _flush_due(self, i: int, it: int, force: bool = False) -> None:
        for d in range(self.part.p):
            if d == i or self._held_l1[i, d] == 0.0:
                continue
            if force or it - self._held_round[i, d] \
                    >= self.plan.max_delay_rounds:
                held = self._held[(i, d)]
                if self.inner.send(i, d, held) >= 0:
                    self._held_l1[i, d] = 0.0
                else:
                    # channel backpressure mid-flush: recount whatever a
                    # partial push left behind and try again next round
                    self._held_l1[i, d] = float(np.abs(held).sum())

    def report(self, i: int, verdict: bool, it: int) -> bool:
        self._round[i] = it
        ka = self.plan.kill.get(i)
        if ka is not None and it >= ka and not self.fired[0, i]:
            if self._obs is not None:
                # the event must be in the (shared) ring before the
                # process SIGKILLs itself — it survives the incarnation
                self._obs.ctr[i, C_KILLS] += 1
                self._obs.emit(EV_KILL, i, self._obs.now(), a=float(it))
            self.fired[0, i] = 1    # shared store lands before the kill
            if self.kill_mode == "process":
                os.kill(os.getpid(), signal.SIGKILL)
            raise InjectedWorkerKill(i)
        ha = self.plan.hang.get(i)
        if ha is not None and it >= ha[0] and not self.fired[1, i]:
            self.fired[1, i] = 1
            if self._obs is not None:
                self._obs.ctr[i, C_HANGS] += 1
                self._obs.emit(EV_HANG, i, self._obs.now(), a=float(ha[1]))
            time.sleep(float(ha[1]))
        self._flush_due(i, it)
        return self.inner.report(i, verdict, it)

    def add_pushes(self, i: int, k: int) -> None:
        rate = self.plan.slow.get(i)
        if rate:
            time.sleep(min(k / float(rate), 0.05))
        self.inner.add_pushes(i, k)

    def inflight_l1(self, i: int) -> float:
        return (self.inner.inflight_l1(i)
                + float(self._held_l1[i].sum()))

    def record_rounds(self, i: int, it: int) -> None:
        # final flush: delayed payloads must not evaporate at loop exit.
        # If the channel refuses even now (full ring at teardown), park
        # the remainder in the outbox — the transport's fold-back
        # conserves outbox mass.
        self._flush_due(i, it, force=True)
        if float(self._held_l1[i].sum()) != 0.0:
            box = self.inner.outbox(i)
            for d in range(self.part.p):
                if d != i and self._held_l1[i, d] != 0.0:
                    sd, ed = self.part.block(d)
                    box[sd:ed] += self._held[(i, d)]
                    self._held[(i, d)][:] = 0.0
                    self._held_l1[i, d] = 0.0
        self.inner.record_rounds(i, it)

    # -- pure delegation -------------------------------------------------
    def stopped(self) -> bool:
        return self.inner.stopped()

    def note_capped(self) -> None:
        self.inner.note_capped()

    def outbox(self, i: int) -> np.ndarray:
        return self.inner.outbox(i)

    def intake_ready(self, i: int) -> bool:
        return self.inner.intake_ready(i)

    def retract(self, i: int) -> None:
        self.inner.retract(i)

    def fold_intake(self, i: int, r: np.ndarray, s: int, e: int) -> bool:
        return self.inner.fold_intake(i, r, s, e)

    def uniform_add(self, i: int, v: float) -> None:
        self.inner.uniform_add(i, v)

    def uniform_pending(self, i: int) -> float:
        return self.inner.uniform_pending(i)

    def values_total(self) -> float:
        return self.inner.values_total()

    def publish_value(self, i: int, v: float) -> None:
        self.inner.publish_value(i, v)

    def total_pushes(self) -> int:
        return self.inner.total_pushes()

    def note_exchange(self, i: int, nz: int) -> None:
        self.inner.note_exchange(i, nz)

    def idle_wait(self, seconds: float) -> None:
        self.inner.idle_wait(seconds)

    def record_idle(self, i: int, seconds: float) -> None:
        self.inner.record_idle(i, seconds)
