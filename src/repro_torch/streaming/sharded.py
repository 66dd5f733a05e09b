"""Partition-sharded certified streaming updates (runtime-layer rendering;
the JAX package's streaming/sharded.py, its host drains copied as numpy).

The single-updater `update_ranks` drains the whole residual from one
thread.  This module shards the drain over a row Partition — the streaming
rendering of the paper's eq. (5) cycle, built directly on the port's
`runtime` layer:

  * each shard runs Gauss-Southwell pushes on its *own* rows (the batched
    frontier sweep of `incremental._push`, restricted to the shard's row
    range — the LocalSolver role);
  * residual mass a push diffuses into rows another shard owns is
    *boundary residual*: it accumulates in a per-shard outbox and moves to
    its owner through a `runtime.ExchangePlan` — every epoch under
    "allgather", or §6-targeted under "sparsified" (an outbox ships only
    when its L1 mass exceeds a threshold, with a forced delivery every
    `refresh_every` sender epochs so delays stay bounded; epochs with an
    *empty* outbox still advance the refresh clock — nothing was withheld,
    so quiet pairs bank no forced-refresh debt);
  * the global certificate comes from the Fig. 1 protocol, not from a
    centralized residual sum.  Because every unit of residual mass is
    counted by exactly one shard at any instant (own rows, mailbox in
    flight, or the sender's undelivered outbox), the reduced sum
    upper-bounds the true ||r||_1 and the certificate
    ||x - x*||_1 <= sum_i ||r_i||_1 / (1 - alpha) is sound at STOP time.

Two execution modes (`mode=`):

  "superstep" (default) — the sequential host loop: all p drains, then
    the exchange, then one `TerminationDriver.allreduce_step` per
    superstep.  Deterministic; numpy on the host, so it equals the JAX
    package's loop bit for bit.
  "async" — no barrier of any kind, on one of three transports:
    "threads" (`runtime.AsyncShardExecutor` worker threads with per-pair
    mailboxes) and "procpool" (worker processes over a shared-memory
    `runtime.ShardArena` with lock-free rings) run the host drains, the
    plan consulted after every local update and termination driven
    through the driver's message rendering (`ue_step` / `monitor_recv`);
    "device" runs the p shard programs of `runtime.DeviceShardTransport`
    on one device (the card's CSR kernel, float64), warm-started from the
    current iterate.  The host schedules are nondeterministic: after STOP
    the exact residual is recomputed from the folded-back state
    (`_exact_residual`, host float64), and the drain is re-entered if an
    in-flight race let STOP fire before the target was truly met — the
    published certificate is always exact.  The worker processes run the
    drain below (numpy only, no torch call: they may be forked from a
    parent that holds a CUDA context).

The dense uniform terms a dangling push would smear (column = e/n) fold
into a scalar that all shards share and apply at epoch boundaries, so
pushes stay local.  When a batch is too global to drain (work caps), the
updater falls back to the same warm-started backend solve as
`update_ranks`, on `device`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core.pagerank import solve_linear, solve_power
from ..core.partition import Partition, block_rows
from ..device import DeviceLike, resolve_device
from ..runtime.device import DeviceShardTransport
from ..runtime.driver import TerminationDriver
from ..runtime.exchange import AllToAllPlan, ExchangePlan, SparsifiedPlan
from ..runtime.executor import AsyncShardExecutor
from ..runtime.faults import FaultPlan
from ..runtime.observe import ShardObserver, attribute_frontier
from ..runtime.schedule import ScheduleSpec, make_schedule
from ..runtime.state import ShardArena
from ..runtime.transport import ProcPoolShardExecutor
from .delta import DeltaGraph, EdgeDelta
from .incremental import (RankState, _check_cert, _exact_residual,
                          _frontier_contrib, _group_sums, _seed_delta,
                          _view_arrays)


@dataclasses.dataclass
class ShardedUpdateStats:
    """What one sharded update did (the Fig. 1 transcript included)."""

    path: str                  # "sharded_push" | "solve_linear" | "solve_power"
    p: int
    supersteps: int            # supersteps, or busiest worker's rounds (async)
    pushes: int                # frontier pops over all shards
    pushes_per_shard: np.ndarray
    exchanges: int             # outbox deliveries that actually shipped
    bytes_moved: int           # modeled payload bytes ((idx, value) pairs)
    seed_l1: float
    resid_l1: float            # driver's reduced sum (superstep) or the
                               # exact post-fold ||r||_1 (async)
    cert: float                # resid_l1 / (1 - alpha) — the Fig. 1 bound
    stop_superstep: int = -1   # superstep/round at which STOP was issued
    solver_iters: int = 0
    mode: str = "superstep"    # "superstep" | "async"
    idle_s: float = 0.0        # total worker idle time (async mode only)
    attempts: int = 1          # async drain entries (>1 = STOP raced mass
                               # in flight and the drain was re-entered)
    transport: str = "threads"  # "threads" | "procpool" (async mode only)
    recoveries: int = 0        # supervised worker restarts (faults/crashes)
    recovery_s: float = 0.0    # total detection -> respawned time
    schedule: str = "default"  # DrainSchedule rendering the drain ran under
    # push-inflation attribution (observe=True, async mode): every
    # frontier pop is exactly one of these, so first+local+boundary ==
    # pushes on a fault-free run (a kill can lose counted-but-uncredited
    # pops, leaving the sum a bounded over-count of `pushes`)
    pushes_first: int = 0      # rows pushed for the first time this update
    pushes_local: int = 0      # re-pushes from the shard's own sweep order
    pushes_boundary: int = 0   # re-pushes re-activated by foreign mass
    observed: Optional[dict] = None  # ShardObserver.observed() payload
    # device transport only: the §6 sparsified collective counters
    rows_sent: int = 0         # sparse payload rows shipped in-loop
    fulls: int = 0             # forced full refreshes (bounded-delay)
    device_resid: float = 0.0  # final device-visible delta L1 (telemetry;
    #                          # the published cert is the exact recompute)


def _scatter_add(out: np.ndarray, idx: np.ndarray,
                 val: np.ndarray) -> None:
    """``out[idx] += val`` with duplicate indices — the grouped-scatter
    path (`np.add.at` is the slow buffered ufunc path), via the
    `_group_sums` heuristic shared with `incremental._push`.  Equal to
    `np.add.at(out, idx, val)` up to float summation order."""
    if idx.size == 0:
        return
    uq, sums = _group_sums(idx, val, out.size)
    out[uq] += sums


def _drain_shard(arrays, x: np.ndarray, r: np.ndarray,
                 outbox: np.ndarray, s: int, e: int, alpha: float,
                 local_target: float, eps_floor: float,
                 c_holder: list, attr=None, order=None) -> int:
    """Drain shard rows [s, e) to ||r[s:e]||_1 <= local_target with batched
    frontier sweeps.  Contributions to own rows feed back into r (and keep
    draining); contributions to foreign rows accumulate into `outbox`
    (addressed by global row id); dangling mass accumulates into the shared
    uniform scalar `c_holder[0]`.  Returns the number of pushes.

    `attr=(pushed, foreign, cnt)` arms push-inflation attribution: each
    frontier is classified first/local/boundary into `cnt` (the shard's
    (3,) row) before its flags advance (runtime/observe.py).

    `order` (a `runtime.schedule.DrainOrder`, local coords [0, e-s)) lets
    a DrainSchedule refine each sweep's frontier — priority retention may
    empty a ladder level (the ladder then descends: the retained rows wait
    for the level where their fluid matters) but never the floor, so an
    empty frontier at eps_floor still certifies the remaining mass is
    below bs * eps_floor, schedule or not."""
    n = r.shape[0]
    pushes = 0
    bs = e - s
    if bs <= 0:
        return 0
    if order is not None:
        order.begin_round()
    while True:
        r_own = r[s:e]
        l1_own = float(np.abs(r_own).sum())
        if l1_own <= local_target:
            return pushes
        eps = max(l1_own / bs, eps_floor)
        while True:
            frontier = np.flatnonzero(np.abs(r_own) >= eps)
            if order is not None and frontier.size:
                frontier = order.refine(np.abs(r_own[frontier]), frontier,
                                        eps, eps <= eps_floor)
            if frontier.size:
                break
            if eps <= eps_floor:
                return pushes
            eps = max(eps / 8.0, eps_floor)
        if order is not None:
            order.note_drained(frontier)
        frontier = frontier + s
        if attr is not None:
            attribute_frontier(attr[0], attr[1], attr[2], frontier)
        pushes += int(frontier.size)
        moved = r[frontier].copy()
        x[frontier] += moved
        r[frontier] = 0.0
        dst, val, dmass = _frontier_contrib(arrays, frontier, moved, alpha)
        if dmass != 0.0:
            c_holder[0] += alpha * dmass / n
        if dst.size:
            own = (dst >= s) & (dst < e)
            if own.any():
                r[s:e] += np.bincount(dst[own] - s, weights=val[own],
                                      minlength=bs)
            foreign = ~own
            if foreign.any():
                _scatter_add(outbox, dst[foreign], val[foreign])


def _exchange_epoch(plan: ExchangePlan, part: Partition, r: np.ndarray,
                    outboxes: List[np.ndarray], step: int,
                    bytes_per_entry: int, gates=None,
                    step_target: float = 0.0) -> Tuple[int, int]:
    """One boundary-residual exchange epoch over every (src, dst) pair:
    consult the plan, deliver gated outboxes into the owners' rows of `r`,
    and return ``(exchanges, bytes_moved)`` for the payloads that actually
    shipped.

    An epoch whose outbox is *empty* still advances the plan's refresh
    clock (`note_sent`): nothing was withheld from the receiver, so the
    pair is as refreshed as a full delivery would make it.  Without this,
    `SparsifiedPlan.last_full` never advances for quiet pairs,
    `refresh_due` goes permanently true, and the §6 mass-threshold gate is
    defeated — every later sub-threshold payload ships as a "forced
    refresh".  Empty epochs ship nothing and count nothing:
    `exchanges`/`bytes_moved` attribute only real payloads.

    `gates` (per-shard `runtime.schedule.ExchangeGate`, boundary-batched
    schedule) coalesces a pair's mass across epochs in front of the plan:
    withheld mass stays in the outbox (still counted in the sender's
    value) and the gate force-opens within `batch_updates` epochs, so the
    bounded-delay argument composes additively with the plan's."""
    exchanges = 0
    bytes_moved = 0
    for i in range(part.p):
        gate = gates[i] if gates is not None else None
        for d in range(part.p):
            if d == i or not plan.wants(i, d, step):
                continue
            s, e = part.block(d)
            box = outboxes[i][s:e]
            mass = float(np.abs(box).sum())
            if mass == 0.0:
                plan.note_sent(i, d, step)
                if gate is not None:
                    gate.note_quiet(d, step)
                continue
            if gate is not None and not gate.ready(d, step, mass,
                                                   step_target):
                continue
            if not plan.gate_mass(i, d, step, mass):
                continue
            nz = int(np.count_nonzero(box))
            r[s:e] += box
            box[:] = 0.0
            plan.note_sent(i, d, step)
            plan.on_result(i, d, True)
            if gate is not None:
                gate.note_sent(d, step)
            exchanges += 1
            bytes_moved += nz * (4 + bytes_per_entry)
    return exchanges, bytes_moved


def _make_plan(exchange: str, p: int, l1_target: float,
               sparsify_thresh: Optional[float],
               sparsify_refresh_every: int) -> ExchangePlan:
    if exchange == "sparsified":
        thresh = (sparsify_thresh if sparsify_thresh is not None
                  else 0.1 * l1_target / p)
        return SparsifiedPlan(p, thresh=thresh,
                              refresh_every=sparsify_refresh_every)
    return AllToAllPlan(p)


class _ShardDrain:
    """The drain `_ShardDrainFactory` builds inside each worker (and the
    threads transport binds to the in-process arrays), as an object so
    that the observing worker can wire attribution through
    `set_observer` (`_procpool_worker_main` duck-types for it).  Numpy
    only: it runs in forked worker processes, which must never call
    torch."""

    def __init__(self, arrays, x: np.ndarray, r: np.ndarray,
                 alpha: float, eps_floor: float,
                 spec: Optional[ScheduleSpec] = None):
        self.arrays = arrays
        self.x = x
        self.r = r
        self.alpha = alpha
        self.eps_floor = eps_floor
        self.spec = spec
        self._orders: dict = {}   # shard id -> DrainOrder (lazy: a worker
        #                         # only ever drains the shards it owns)
        self.obs: Optional[ShardObserver] = None

    def set_observer(self, obs: Optional[ShardObserver]) -> None:
        # attribution needs the per-row flags; a counters-only observer
        # (synthetic drains) leaves the drain untouched
        self.obs = obs if (obs is not None and obs.pushed is not None) \
            else None

    def _order(self, i, s, e):
        if self.spec is None:
            return None
        if i not in self._orders:
            self._orders[i] = self.spec.order(e - s, shard=i)
        return self._orders[i]

    def __call__(self, i, s, e, step_target, outbox):
        holder = [0.0]
        obs = self.obs
        attr = ((obs.pushed, obs.foreign, obs.attr[i])
                if obs is not None else None)
        got = _drain_shard(self.arrays, self.x, self.r, outbox, s, e,
                           self.alpha, step_target, self.eps_floor,
                           holder, attr, self._order(i, s, e))
        return got, holder[0]


class _ShardDrainFactory:
    """Picklable procpool DrainFactory: rebuilds the batched
    Gauss-Southwell sweep inside each worker process from the arena views
    (`runtime.transport.DrainFactory` contract; a spawned worker unpickles
    it, importing this module).  The ScheduleSpec rides
    along (frozen dataclass, picklable); each worker incarnation builds
    fresh per-shard DrainOrder state from it — retention and RNG state are
    schedule heuristics, so losing them to a worker restart is sound."""

    def __init__(self, alpha: float, eps_floor: float, base_n: int,
                 spec: Optional[ScheduleSpec] = None):
        self.alpha = alpha
        self.eps_floor = eps_floor
        self.base_n = base_n
        self.spec = spec

    def __call__(self, views):
        arrays = (views["base_indptr"], views["base_indices"], self.base_n,
                  views["dirty_rows"], views["out_deg"],
                  views["dirty_indptr"], views["dirty_indices"])
        return _ShardDrain(arrays, views["x"], views["r"],
                           self.alpha, self.eps_floor, self.spec)


def _device_update(dg: DeltaGraph, state: RankState, *, p: int,
                   exchange: str, tol: float, l1_target: float,
                   seed_l1: float, sparsify_thresh: Optional[float],
                   sparsify_refresh_every: int, pc_max_compute: int,
                   pc_max_monitor: int, max_supersteps: int, backend: str,
                   method: str, solver_max_iters: int, schedule_name: str,
                   device
                   ) -> Tuple[RankState, ShardedUpdateStats]:
    """The device-transport drain: warm-start the linear form (eq. 7) from
    the current iterate as p shard programs (runtime/device.py, on
    `device`: one launch of the CSR kernel's float64 lane a superstep for
    all shards on the card), then certify with the host-side exact
    recompute.  A new transport is built per call, so it packs the
    shards of this version's operator anew.

    The device loop's own termination sees only the all-reduced fragment
    delta (||r||_1 up to view staleness), so the drain target starts at
    half the l1 target and tightens 4x on every re-entry — the published
    certificate is always `_exact_residual`, never the device criterion,
    matching the other async transports' contract."""
    alpha = state.alpha
    x, r = state.x, state.r
    dev = DeviceShardTransport(
        p, exchange=exchange,
        sparsify_thresh=(float(sparsify_thresh)
                         if sparsify_thresh is not None else 0.0),
        sparsify_refresh_every=sparsify_refresh_every,
        pc_max_compute=pc_max_compute, pc_max_monitor=pc_max_monitor,
        device=device)
    op = dg.operator(alpha, v=state.v)
    target = 0.5 * l1_target
    supersteps = rows = fulls = 0
    bytes_total = 0
    attempts = 0
    device_resid = 0.0
    resid = float(np.abs(r).sum())
    while (attempts == 0 or resid > l1_target) and attempts < 4:
        attempts += 1
        res = dev.run(op, x, target=target, max_supersteps=max_supersteps)
        x[:] = res.x
        supersteps += res.supersteps
        rows += res.rows_sent
        fulls += res.fulls
        bytes_total += res.comm_bytes_total
        device_resid = res.device_resid
        # re-derive the maintained residual exactly from the new iterate
        # (one O(nnz) host apply) — both the re-entry decision and the
        # published certificate stand on it
        r[:] = _exact_residual(dg, x, alpha, state.v)
        resid = float(np.abs(r).sum())
        target *= 0.25
    pps = np.zeros(p, dtype=np.int64)
    if resid <= l1_target:
        return state, ShardedUpdateStats(
            path="sharded_push", p=p, supersteps=supersteps, pushes=0,
            pushes_per_shard=pps, exchanges=rows + fulls,
            bytes_moved=bytes_total, seed_l1=seed_l1, resid_l1=resid,
            cert=resid / (1.0 - alpha), stop_superstep=supersteps,
            mode="async", attempts=attempts, transport="device",
            rows_sent=rows, fulls=fulls, device_resid=device_resid,
            schedule=schedule_name)
    return _solver_fallback(
        dg, state, alpha=alpha, tol=tol, method=method, backend=backend,
        solver_max_iters=solver_max_iters, device=device,
        stats_kw=dict(p=p, supersteps=supersteps, pushes=0,
                      pushes_per_shard=pps, exchanges=rows + fulls,
                      bytes_moved=bytes_total, seed_l1=seed_l1,
                      mode="async", attempts=max(attempts, 1),
                      transport="device", rows_sent=rows, fulls=fulls,
                      device_resid=device_resid, schedule=schedule_name))


def update_ranks_sharded(
        dg: DeltaGraph, delta: EdgeDelta, state: RankState, *,
        p: int = 4, tol: float = 1e-8, exchange: str = "allgather",
        mode: str = "superstep", transport: str = "threads",
        n_workers: Optional[int] = None,
        sparsify_thresh: Optional[float] = None,
        sparsify_refresh_every: int = 4,
        pc_max_compute: int = 1, pc_max_monitor: int = 1,
        max_supersteps: int = 10_000, max_push_factor: float = 40.0,
        backend: str = "segment_sum", method: str = "linear",
        solver_max_iters: int = 1000,
        bytes_per_entry: int = 8,
        faults: Optional[FaultPlan] = None,
        observe: bool = False,
        schedule=None,
        device: DeviceLike = None
        ) -> Tuple[RankState, ShardedUpdateStats]:
    """Apply `delta` and certify the updated ranks with p shards.

    Mirrors `update_ranks` (same RankState in/out, same exact residual
    bookkeeping, same warm-started fallback) but runs the drain as the
    runtime-layer cycle described in the module docstring, either as the
    deterministic superstep loop (``mode="superstep"``) or with zero
    inter-drain barriers (``mode="async"``) on the selected transport:
    ``transport="threads"`` (worker threads), ``transport="procpool"``
    (worker *processes* over a shared-memory ShardArena — the rendering
    whose raw wall-clock escapes the GIL; ``n_workers`` sizes the pool,
    default min(p, cores)), or ``transport="device"`` (p shard programs
    on `device`; faults, observe and custom drain schedules are host-seam
    features and raise; the device counters land on ``stats.rows_sent`` /
    ``stats.fulls`` / ``stats.bytes_moved``).  On success ``stats.cert``
    is sound and ``state.cert <= stats.cert`` (state.r is the
    exactly-maintained residual; the superstep bound is the driver's
    all-reduced sum, the async bound is the exact post-fold recompute —
    under every transport).  The arguments are checked as the JAX package
    checks them, in its order and with its ValueErrors.

    `faults=FaultPlan(...)` (async mode, host transports) injects a
    deterministic seeded fault schedule — worker kill/hang, exchange
    drop/dup/delay, slow shards — at the transport seam
    (runtime/faults.py); an inactive plan injects nothing and is accepted
    in every mode.  Killed procpool workers are restarted by the
    `ShardSupervisor` (threads restart the worker loop in place);
    whenever faults were injected or recoveries happened, the residual is
    re-derived with the exact O(nnz) recompute and the drain re-entered
    until the *exact* residual meets the target, so the published
    certificate stays sound across any recovered schedule.  Only an
    exhausted restart budget raises RuntimeError — with the shared
    segments released and the surviving mass folded back; after such an
    abort re-certify via `refresh_residual` (or rebuild via `cold_state`)
    before trusting the state.

    `observe=True` (async mode, host transports) arms the runtime observer
    (runtime/observe.py): per-shard metrics, a ring-buffered event trace
    at the cycle seams, and push-inflation attribution — the
    `pushes_first` / `pushes_local` / `pushes_boundary` decomposition on
    the stats, with the full payload in `stats.observed` and a
    Perfetto-loadable export via
    `runtime.observe.write_chrome_trace(path, stats.observed["events"])`.

    `schedule=` selects the DrainSchedule rendering (a name or a
    `runtime.schedule.ScheduleSpec`): "default", "priority" (D-Iteration
    fluid retention), "boundary" / "boundary-batched" (exchange
    coalescing), "randomized" (seeded Ishii-Tempo control arm), or
    "priority+boundary".  Schedules reorder and delay pushes/shipments
    only — retained fluid stays in r, batched mass stays in the counted
    outbox — so certificates are schedule-independent.

    `device` (None: the CUDA card, raising without one) runs the device
    drain and the fallback solve of every transport; it is resolved after
    the argument checks and before the graph changes.  The host drains
    never touch it.
    """
    if state.version != dg.version:
        raise ValueError(
            f"state at version {state.version} but graph at {dg.version}; "
            "states must track every delta (or be rebuilt via cold_state)")
    if method not in ("linear", "power"):
        raise ValueError(f"unknown method {method!r}")
    if exchange not in ("allgather", "sparsified"):
        raise ValueError(f"unknown exchange {exchange!r}")
    if mode not in ("superstep", "async"):
        raise ValueError(f"unknown mode {mode!r}; expected 'superstep' "
                         "or 'async'")
    if transport not in ("threads", "procpool", "device"):
        raise ValueError(f"unknown transport {transport!r}; expected "
                         "'threads', 'procpool' or 'device'")
    if transport in ("procpool", "device") and mode != "async":
        raise ValueError(f"transport={transport!r} requires mode='async' "
                         "(the superstep loop is a host loop)")
    faulty = faults is not None and faults.active
    if faulty and mode != "async":
        raise ValueError("faults= requires mode='async' (the superstep "
                         "loop has no transport seam to inject at)")
    if observe and mode != "async":
        raise ValueError("observe=True requires mode='async' (the "
                         "superstep loop has no worker cycle to trace)")
    if transport == "device":
        # the device rendering is one program: no worker seam to inject
        # faults at or trace
        if faulty:
            raise ValueError("faults= is not supported on "
                             "transport='device' (no host worker seam)")
        if observe:
            raise ValueError("observe=True is not supported on "
                             "transport='device'; the device counters "
                             "(rows_sent/fulls/bytes) land on the stats")
    spec = make_schedule(schedule)
    if transport == "device" and spec.name != "default":
        raise ValueError("schedule= renderings are host-drain heuristics; "
                         "transport='device' supports only the default")
    # the zero-cost contract: a spec whose drain rendering is the default
    # ladder passes order=None straight through (every hook skipped)
    drain_spec = spec if spec.drain_kind != "default" else None
    if delta.new_nodes and state.v is not None:
        raise NotImplementedError(
            "node arrivals with a custom teleport vector are not "
            "supported incrementally; rebuild via cold_state")
    device = resolve_device(device)
    alpha = state.alpha
    rcpt = dg.apply(delta)
    c = _seed_delta(dg, rcpt, state)
    x, r = state.x, state.r
    n = rcpt.n_new
    seed_l1 = float(np.abs(r).sum()) + abs(c) * n

    # the sharded drain keeps no per-shard rescale state, so the uniform
    # component folds densely up front (exact; O(n) once per batch)
    if c != 0.0:
        r += c

    part = block_rows(n, p)
    l1_target = (1.0 - alpha) * tol
    eps_floor = l1_target / max(n, 1)
    max_pushes = int(max_push_factor * n)

    if transport == "device":
        # --- device-program drain: p shard programs on one device run
        # the shard program's superstep (runtime/device.py); the
        # published certificate is the host-side exact recompute
        return _device_update(
            dg, state, p=p, exchange=exchange, tol=tol,
            l1_target=l1_target, seed_l1=seed_l1,
            sparsify_thresh=sparsify_thresh,
            sparsify_refresh_every=sparsify_refresh_every,
            pc_max_compute=pc_max_compute, pc_max_monitor=pc_max_monitor,
            max_supersteps=max_supersteps, backend=backend, method=method,
            solver_max_iters=solver_max_iters, schedule_name=spec.name,
            device=device)

    arrays = _view_arrays(dg)

    if mode == "async":
        # --- truly asynchronous drain: shard workers on the selected
        # transport (threads: per-pair mailboxes in-process; procpool:
        # worker processes over a shared-memory ShardArena with lock-free
        # rings), plan consulted per local update, Fig. 1 by routed
        # messages.  STOP can race mass in flight, so the exact residual
        # is recomputed after every fold-back and the drain is re-entered
        # (with fresh protocol state) until it truly holds — the
        # published certificate is always the exact recompute.
        arena = None
        # observe=True arms the runtime observer: threads share one
        # in-process ShardObserver across every attempt; procpool grows
        # each run's control arena with the obs_* slots (observe=True on
        # the executor) and hands the payload back via res.observed
        obs = (ShardObserver.alloc(p, n)
               if observe and transport == "threads" else None)
        if transport == "procpool":
            # shard fragments move to shared memory once per update
            # batch; workers rebuild the drain from the arena views
            arena = ShardArena.from_arrays({
                "r": r, "x": x,
                "base_indptr": arrays[0], "base_indices": arrays[1],
                "dirty_rows": arrays[3], "out_deg": arrays[4],
                "dirty_indptr": arrays[5], "dirty_indices": arrays[6],
            })
            factory = _ShardDrainFactory(alpha=alpha, eps_floor=eps_floor,
                                         base_n=int(arrays[2]),
                                         spec=drain_spec)
            r_run = arena["r"]
        else:
            # the same drain object the procpool factory builds, bound to
            # the in-process arrays: per-shard DrainOrder state persists
            # across drain attempts (retention/RNG are heuristics; the
            # certificate never depends on them)
            drain_fn = _ShardDrain(arrays, x, r, alpha, eps_floor,
                                   drain_spec)
            drain_fn.set_observer(obs)
            r_run = r

        pushes_per_shard = np.zeros(p, dtype=np.int64)
        exchanges = bytes_moved = 0
        step = 0
        stop_round = -1
        idle_s = 0.0
        capped = False
        attempts = 0
        recoveries = 0
        recovery_s = 0.0
        observed = None
        attr_tot = np.zeros(3, dtype=np.int64)
        # kill/hang schedules fire once per *update*, so the fired flags
        # live here and cross every drain attempt (and, in procpool,
        # every worker restart via the control arena)
        fstate = faults.state(p) if faulty else None
        try:
            resid = float(np.abs(r_run).sum())
            # always enter at least once (even an already-converged
            # residual gets its STOP from a routed Fig. 1 transcript, not
            # a shortcut)
            while (attempts == 0 or resid > l1_target) \
                    and not capped and attempts < 4:
                attempts += 1
                plan = _make_plan(exchange, p, l1_target, sparsify_thresh,
                                  sparsify_refresh_every)
                driver = TerminationDriver(p, pc_max_compute=pc_max_compute,
                                           pc_max_monitor=pc_max_monitor)
                # 2x push headroom vs the superstep budget: the
                # fine-grained schedule pushes a row per *arrival* where
                # the superstep loop batches a whole exchange generation
                # into one push — same mass drained, more (cheaper) pops
                push_budget = (2 * max_pushes
                               - int(pushes_per_shard.sum()))

                # spec.drain_frac overrides the transport's drain-call
                # granularity, clamped to keep hysteresis * drain_frac
                # under the livelock bound 1.0 (WorkerConfig rejects it)
                def _df_kw(hysteresis: float) -> dict:
                    if spec.drain_frac is None:
                        return {}
                    return dict(drain_frac=min(float(spec.drain_frac),
                                               0.95 / hysteresis))

                if transport == "procpool":
                    ex = ProcPoolShardExecutor(
                        part, plan, driver, l1_target=l1_target,
                        bytes_per_entry=bytes_per_entry,
                        max_rounds=100 * max_supersteps,
                        max_total_pushes=push_budget, n_workers=n_workers,
                        faults=faults, fault_state=fstate,
                        observe=observe, schedule=spec,
                        **_df_kw(ProcPoolShardExecutor.HYSTERESIS))
                    res = ex.run(factory, arena, x_key="x")
                else:
                    ex = AsyncShardExecutor(
                        part, plan, driver, l1_target=l1_target,
                        bytes_per_entry=bytes_per_entry,
                        max_rounds=100 * max_supersteps,
                        max_total_pushes=push_budget,
                        faults=faults, fault_state=fstate, observe=obs,
                        schedule=spec,
                        **_df_kw(2.0))
                    res = ex.run(drain_fn, r_run)
                if res.observed is not None:
                    # threads reuse one observer, so the last payload is
                    # already cumulative; procpool arenas are per-attempt,
                    # so attribution totals accumulate here (the trace in
                    # `observed` covers the final attempt)
                    observed = res.observed
                    if transport == "procpool":
                        a = res.observed.get("attribution")
                        if a is not None:
                            attr_tot += np.array(
                                [a["first"], a["local"], a["boundary"]],
                                dtype=np.int64)
                pushes_per_shard += res.pushes_per_shard
                exchanges += res.exchanges
                bytes_moved += res.bytes_moved
                step = max(step, int(res.rounds_per_shard.max()))
                stop_round = res.stop_round
                idle_s += float(res.idle_s_per_shard.sum())
                capped = res.capped
                recoveries += res.recoveries
                recovery_s += res.recovery_s
                if faulty or res.recoveries:
                    # faults (and checkpoint-restored restarts) leave the
                    # maintained residual only *boundedly* approximate:
                    # re-derive it exactly from the iterate, so both the
                    # re-entry decision and the published certificate
                    # stand on the exact O(nnz) recompute
                    x_cur = arena["x"] if arena is not None else x
                    r_run[:] = _exact_residual(dg, x_cur, alpha, state.v)
                resid = float(np.abs(r_run).sum())
        finally:
            if arena is not None:
                # bring the fragments home, then release the segment
                # (nothing survives in /dev/shm even on a worker crash)
                r[:] = arena["r"]
                x[:] = arena["x"]
                r_run = None
                arena.close()

        if obs is not None:
            # threads: one observer covered every attempt
            observed = obs.observed()
            if obs.attr is not None:
                attr_tot = obs.attr.sum(axis=0)

        pushes = int(pushes_per_shard.sum())
        if resid <= l1_target and not capped:
            return state, ShardedUpdateStats(
                path="sharded_push", p=p, supersteps=step, pushes=pushes,
                pushes_per_shard=pushes_per_shard, exchanges=exchanges,
                bytes_moved=bytes_moved, seed_l1=seed_l1, resid_l1=resid,
                cert=resid / (1.0 - alpha), stop_superstep=stop_round,
                mode=mode, idle_s=idle_s, attempts=attempts,
                transport=transport, recoveries=recoveries,
                recovery_s=recovery_s, pushes_first=int(attr_tot[0]),
                pushes_local=int(attr_tot[1]),
                pushes_boundary=int(attr_tot[2]), observed=observed,
                schedule=spec.name)
        return _solver_fallback(
            dg, state, alpha=alpha, tol=tol, method=method,
            backend=backend, solver_max_iters=solver_max_iters,
            device=device,
            stats_kw=dict(p=p, supersteps=step, pushes=pushes,
                          pushes_per_shard=pushes_per_shard,
                          exchanges=exchanges, bytes_moved=bytes_moved,
                          seed_l1=seed_l1, mode=mode, idle_s=idle_s,
                          attempts=max(attempts, 1), transport=transport,
                          recoveries=recoveries, recovery_s=recovery_s,
                          pushes_first=int(attr_tot[0]),
                          pushes_local=int(attr_tot[1]),
                          pushes_boundary=int(attr_tot[2]),
                          observed=observed, schedule=spec.name))

    local_target = l1_target / (2.0 * p)
    plan = _make_plan(exchange, p, l1_target, sparsify_thresh,
                      sparsify_refresh_every)
    driver = TerminationDriver(p, pc_max_compute=pc_max_compute,
                               pc_max_monitor=pc_max_monitor)

    # DrainSchedule state for the superstep rendering: per-shard frontier
    # orders, per-shard exchange gates, and (randomized) a seeded
    # per-superstep shard permutation — all deterministic given the spec,
    # so this mode stays the replayable golden reference
    orders = ([drain_spec.order(part.block(i)[1] - part.block(i)[0],
                                shard=i) for i in range(p)]
              if drain_spec is not None else [None] * p)
    gates = ([spec.gate(p) for _ in range(p)]
             if spec.batch_exchange else None)
    shard_rng = (np.random.default_rng(
        np.random.SeedSequence(entropy=int(spec.seed), spawn_key=(p,)))
        if spec.drain_kind == "randomized" else None)

    outboxes = [np.zeros(n) for _ in range(p)]
    c_pending = [0.0]
    pushes_per_shard = np.zeros(p, dtype=np.int64)
    exchanges = 0
    bytes_moved = 0
    total = float("inf")
    stop_superstep = -1
    step = 0
    capped = False

    prev_total = max(seed_l1, l1_target)
    while stop_superstep < 0 and step < max_supersteps:
        # ---- local drains (each shard's own rows) ----------------------
        # Each superstep drains to a *sliding* target: a fraction of the
        # previous all-reduced total (no point draining own rows orders of
        # magnitude below the mass peers are about to export here), floored
        # at the final per-shard share of the certificate target.  Mass
        # decays geometrically across supersteps and the total push count
        # stays proportional to log(seed/target).
        step_target = max(local_target, 0.05 * prev_total / p)
        shard_order = (shard_rng.permutation(p) if shard_rng is not None
                       else range(p))
        for i in shard_order:
            s, e = part.block(i)
            pushes_per_shard[i] += _drain_shard(
                arrays, x, r, outboxes[i], s, e, alpha,
                step_target, eps_floor, c_pending, order=orders[i])
        if int(pushes_per_shard.sum()) > max_pushes:
            capped = True
            break

        # ---- boundary-residual exchange (ExchangePlan) -----------------
        sent, moved = _exchange_epoch(plan, part, r, outboxes, step,
                                      bytes_per_entry, gates=gates,
                                      step_target=step_target)
        exchanges += sent
        bytes_moved += moved
        # the uniform scalar is shared state: fold it densely once all
        # shards have accumulated into it (an all-reduced scalar, 0 bytes
        # of payload in the model)
        if c_pending[0] != 0.0:
            r += c_pending[0]
            c_pending[0] = 0.0

        # ---- Fig. 1 over all-reduced per-shard ||r_i||_1 ---------------
        values = np.empty(p)
        for i in range(p):
            s, e = part.block(i)
            values[i] = (float(np.abs(r[s:e]).sum())
                         + float(np.abs(outboxes[i]).sum()))
        total, issued = driver.allreduce_step(values, l1_target)
        prev_total = max(total, l1_target)
        step += 1
        if issued:
            stop_superstep = step

    # fold whatever is still undelivered back into r: state.r stays the
    # exact residual, and the certified total already counted this mass
    for box in outboxes:
        nz = np.flatnonzero(box)
        if nz.size:
            r[nz] += box[nz]
    if c_pending[0] != 0.0:
        r += c_pending[0]

    pushes = int(pushes_per_shard.sum())
    if stop_superstep > 0 and not capped:
        return state, ShardedUpdateStats(
            path="sharded_push", p=p, supersteps=step, pushes=pushes,
            pushes_per_shard=pushes_per_shard, exchanges=exchanges,
            bytes_moved=bytes_moved, seed_l1=seed_l1, resid_l1=total,
            cert=total / (1.0 - alpha), stop_superstep=stop_superstep,
            schedule=spec.name)

    return _solver_fallback(
        dg, state, alpha=alpha, tol=tol, method=method, backend=backend,
        solver_max_iters=solver_max_iters, device=device,
        stats_kw=dict(p=p, supersteps=step, pushes=pushes,
                      pushes_per_shard=pushes_per_shard,
                      exchanges=exchanges, bytes_moved=bytes_moved,
                      seed_l1=seed_l1, schedule=spec.name))


def _solver_fallback(dg: DeltaGraph, state: RankState, *, alpha: float,
                     tol: float, method: str, backend: str,
                     solver_max_iters: int, device, stats_kw: dict
                     ) -> Tuple[RankState, ShardedUpdateStats]:
    """Warm-started full solve (same contract as update_ranks): drive the
    backend solver on `device` from the current iterate, recover the exact
    residual with one host-side apply, and certify."""
    op = dg.operator(alpha, v=state.v)
    solver = solve_linear if method == "linear" else solve_power
    res = solver(op, x0=state.x, tol=0.5 * (1.0 - alpha) * tol,
                 max_iters=solver_max_iters, backend=backend, device=device)
    state.x = np.asarray(res.x, dtype=np.float64)
    state.r = _exact_residual(dg, state.x, alpha, state.v)
    resid = state.resid_l1
    _check_cert(resid, tol, alpha, f"solve_{method}[{backend}]")
    return state, ShardedUpdateStats(
        path=f"solve_{method}", resid_l1=resid,
        cert=resid / (1.0 - alpha), solver_iters=res.iters, **stats_kw)
