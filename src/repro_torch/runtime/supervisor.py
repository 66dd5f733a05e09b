"""ShardSupervisor — self-healing for the procpool shard runtime (the JAX
package's runtime/supervisor.py, copied: host numpy in the parent).

Without it a dead or crashing worker would stamp STOP and the whole solve
would raise; this module turns detection into recovery.  The parent
already owns everything a restart needs — the data
arena (r, x, CSR fragments) and the control arena (outboxes, rings,
ledgers, telemetry) both outlive any worker, because workers only
*attach* — so a worker death costs one respawn, not a solve:

  * the parent pump (subsumed here) watches liveness while delivering
    Fig. 1 messages; an unexpected exit (SIGKILL, a crash that
    `os._exit`s after flagging `err`) triggers recovery instead of STOP;
  * for every shard the dead worker hosted:
      - stale Fig. 1 claims from the dead incarnation are discarded and
        `TerminationDriver.restart_shard` re-enters the protocol
        conservatively (fresh computing machine + a DIVERGE to the
        monitor): the restarted shard reports DIVERGE until its value
        recomputes, so a stale CONVERGE flag can never ride into STOP;
      - if the worker died *mid-sweep* (`busy` flag set), the shard's
        (r, x) rows are re-materialized from the last seqlock'd per-shard
        checkpoint (workers refresh it at report time every
        `checkpoint_every` rounds; the parent writes checkpoint zero
        before spawning); otherwise the live rows are consistent and are
        re-checkpointed as the new baseline;
      - the in-flight ledgers are reconciled on both sides: a
        `send_intent` cell written before the `sent_abs` bump is rolled
        back if the worker died inside the bump-push window, and
        `recv_abs` is re-derived from the rings' actual pending mass
        (a kill can land between a fold and its `recv_abs` bump on any
        co-hosted shard), so a phantom in-flight payload can never hold
        `inflight_l1` above zero forever (the livelock that would
        otherwise block termination);
  * restarts take capped exponential backoff (per worker) and draw from
    a global restart budget; an exhausted budget stamps STOP and the
    executor raises.

What recovery *cannot* restore exactly — mail folded between the
checkpoint and the kill, outbox rows scattered mid-sweep, held duplicate
payloads — leaves the maintained residual approximate in a bounded way.
That is why the streaming caller re-derives the residual with an exact
O(nnz) recompute whenever `AsyncRunResult.recoveries > 0` and re-enters
the drain: certificates stay sound across any number of restarts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core.termination import Msg
from .observe import C_RECOVERIES, EV_RECOVERY, ShardObserver


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Capped exponential restart backoff: delay(k) for a worker's k-th
    restart."""

    base_s: float = 0.02
    factor: float = 2.0
    cap_s: float = 0.5

    def delay(self, k: int) -> float:
        return float(min(self.base_s * (self.factor ** k), self.cap_s))


@dataclasses.dataclass(frozen=True)
class RestartEvent:
    """One recovery, for telemetry/benchmarks."""

    worker: int                 # pool slot that died
    shards: Tuple[int, ...]     # shards it hosted
    exitcode: Optional[int]     # SIGKILL => -9, flagged crash => 70
    restart_index: int          # global restart counter value
    mid_sweep: Tuple[int, ...]  # shards restored from checkpoint
    recovery_s: float           # detection -> respawned


class ShardSupervisor:
    """Parent-side monitor pump + worker liveness + restart policy for
    `ProcPoolShardExecutor` (see module docstring).

    `spawn(w)` must return a *started* replacement Process for pool slot
    `w`; `assign[w]` lists the shards that slot hosts.  `r`/`x` are the
    parent's views of the data arena (x may be None for synthetic
    drains without an iterate)."""

    def __init__(self, part, driver, ctl, r: np.ndarray,
                 x: Optional[np.ndarray], assign: List[List[int]],
                 spawn: Callable, *, max_restarts: int,
                 backoff: BackoffPolicy = BackoffPolicy(),
                 obs: Optional[ShardObserver] = None):
        self.part = part
        self.driver = driver
        self.ctl = ctl
        self.r = r
        self.x = x
        self.assign = assign
        self.spawn = spawn
        self.max_restarts = int(max_restarts)
        self.backoff = backoff
        self.obs = obs          # RECOVERY events + counters when tracing
        self.recoveries = 0
        self.recovery_s = 0.0
        self.events: List[RestartEvent] = []
        self.all_procs: List = []       # every incarnation, for cleanup
        self._per_worker_restarts = np.zeros(len(assign), dtype=np.int64)

    # ------------------------------------------------------------------
    def _drain_msgs(self) -> bool:
        """Deliver pending ringed Fig. 1 messages to the monitor machine
        (drained but not delivered once STOP is stamped); True when
        anything moved."""
        from .transport import _F_STOP, _F_STOP_ROUND, _MSG_RING_DEPTH
        ctl = self.ctl
        flags = ctl["flags"]
        head, tail, buf = ctl["msg_head"], ctl["msg_tail"], ctl["msg_buf"]
        moved = False
        for i in range(self.part.p):
            h, t = int(head[i]), int(tail[i])
            while h < t:
                code = int(buf[i, h % _MSG_RING_DEPTH])
                h += 1
                head[i] = h
                moved = True
                if flags[_F_STOP]:
                    continue
                if self.driver.monitor_recv(i, Msg(code)):
                    flags[_F_STOP_ROUND] = int(ctl["rounds"][i])
                    flags[_F_STOP] = 1
        return moved

    # ------------------------------------------------------------------
    def _recover_shard(self, i: int) -> bool:
        """Re-enter shard i after its worker died; True when its rows
        were restored from the mid-sweep checkpoint."""
        from .transport import _MSG_RING_DEPTH  # noqa: F401  (layout dep)
        ctl = self.ctl
        part = self.part
        s, e = part.block(i)

        # 1. discard the dead incarnation's undelivered Fig. 1 claims and
        #    re-enter the protocol conservatively (DIVERGE until the
        #    restarted shard republishes a value)
        ctl["msg_head"][i] = ctl["msg_tail"][i]
        if not self.driver.stopped:
            self.driver.restart_shard(i)

        # 2. sender-side ledger reconciliation: an intent written but not
        #    cleared means the worker died inside the sent_abs-bump /
        #    ring-push window — roll the bump back.  If the push did land,
        #    the receiver's fold makes recv_abs overtake sent_abs and the
        #    clamped inflight reads zero: a bounded under-count the
        #    caller's exact recompute covers, instead of a phantom
        #    in-flight payload blocking termination forever.
        for d in range(part.p):
            if d != i and ctl["send_intent"][i, d] != 0.0:
                ctl["sent_abs"][i, d] -= ctl["send_intent"][i, d]
                ctl["send_intent"][i, d] = 0.0

        # 2b. receiver-side ledger reconciliation: the worker may have
        #     been killed between a ring fold and its recv_abs bump (on
        #     a shared-core pool the SIGKILL lands at arbitrary points
        #     in the *co-hosted* shards, not just at the killed shard's
        #     report), leaving recv_abs permanently behind what actually
        #     left the wire — a phantom in-flight mass that would hold
        #     this pair's inflight_l1 above zero forever and block
        #     termination.  Re-derive from ground truth: whatever the
        #     sender shipped that is not still pending in the ring has
        #     left the channel (folded into r, or lost with the
        #     incarnation — either way the caller's exact recompute
        #     covers the rows; the *books* must not block STOP).  The
        #     ring is scanned BEFORE sent_abs is read so a concurrent
        #     push by a live sender biases recv_abs high — a clamped
        #     under-count (sound), never a phantom.
        from .transport import _ctl_ring
        for j in range(part.p):
            if j == i:
                continue
            pending = _ctl_ring(ctl, j, i).pending_l1()
            ctl["recv_abs"][j, i] = ctl["sent_abs"][j, i] - pending

        # 3. rows: mid-sweep death restores the checkpoint; a clean-point
        #    death keeps the live rows and re-baselines the checkpoint.
        #    `busy` implies the checkpoint is committed (workers only
        #    checkpoint at report time, outside the drain), so a torn
        #    (odd-seq) checkpoint can only belong to a non-busy shard —
        #    normalize it from the live rows.
        mid_sweep = bool(ctl["busy"][i])
        if mid_sweep:
            self.r[s:e] = ctl["ckpt_r"][s:e]
            if self.x is not None:
                self.x[s:e] = ctl["ckpt_x"][s:e]
        else:
            ctl["ckpt_r"][s:e] = self.r[s:e]
            if self.x is not None:
                ctl["ckpt_x"][s:e] = self.x[s:e]
        if ctl["ckpt_seq"][i] % 2:
            ctl["ckpt_seq"][i] += 1
        ctl["busy"][i] = 0
        ctl["restarts"][i] += 1

        # 4. republish a fresh (stale-high is fine) value so peers' sliding
        #    drain targets don't ride a dead shard's last word
        ctl["values"][i] = (float(np.abs(self.r[s:e]).sum())
                            + float(np.abs(ctl["outbox"][i]).sum()))
        return mid_sweep

    # ------------------------------------------------------------------
    def supervise(self, procs: List) -> bool:
        """Pump messages and supervise liveness until every pool slot has
        exited; returns True when a worker stayed dead (restart budget
        exhausted) — the executor then raises after the fold-back."""
        from .transport import _F_STOP, _F_STOP_ROUND
        flags = self.ctl["flags"]
        flags[_F_STOP_ROUND] = -1
        self.all_procs = list(procs)
        slots: List = list(procs)       # None = slot finished for good
        died = False
        while True:
            moved = self._drain_msgs()
            for w, pr in enumerate(slots):
                if pr is None or pr.is_alive():
                    continue
                ec = pr.exitcode
                if ec == 0 or flags[_F_STOP]:
                    # clean exit, or any exit during normal teardown
                    slots[w] = None
                    continue
                # unexpected death while the run is live
                if self.recoveries >= self.max_restarts:
                    died = True
                    flags[_F_STOP] = 1
                    slots[w] = None
                    continue
                t0 = time.perf_counter()
                self.recoveries += 1
                k = int(self._per_worker_restarts[w])
                self._per_worker_restarts[w] += 1
                restored = tuple(i for i in self.assign[w]
                                 if self._recover_shard(i))
                if self.obs is not None:
                    # written between death detection and respawn: no
                    # worker incarnation is alive, so the parent is the
                    # shard ring's only writer right now
                    for i in self.assign[w]:
                        self.obs.ctr[i, C_RECOVERIES] += 1
                        self.obs.emit(
                            EV_RECOVERY, i, t0,
                            dur=time.perf_counter() - t0, a=float(w),
                            b=float(ec if ec is not None else 0),
                            c=float(i in restored))
                time.sleep(self.backoff.delay(k))
                repl = self.spawn(w)
                self.all_procs.append(repl)
                slots[w] = repl
                dt = time.perf_counter() - t0
                self.recovery_s += dt
                self.events.append(RestartEvent(
                    worker=w, shards=tuple(self.assign[w]), exitcode=ec,
                    restart_index=self.recoveries, mid_sweep=restored,
                    recovery_s=dt))
            if all(pr is None for pr in slots):
                self._drain_msgs()      # late messages are not stranded
                return died
            if not moved:
                time.sleep(5e-4)
