"""DrainSchedule — pluggable update ordering for the eq. (5) drain cycle
(the JAX package's runtime/schedule.py, copied: numpy only, the same
numpy Generator and the same draw order, so a seeded schedule replays the
reference's drains bit for bit).

The paper's free-steering iteration leaves the update order entirely open,
and the JAX package's push-inflation attribution measured order as the
first lever on the host transports: fine-grained async at p >= 4 inflates
pushes 1.2-1.6x over p=1 (its observer's `inflation` counters, on the
CPU).  The tax splits by transport — threads lose
half-or-more to *local* cadence (GIL-interleaved drains re-cross the
threshold ladder), procpool ~90% to *boundary* re-activation (every
exchange generation re-lifts the same foreign rows over eps).  This module
is the schedule seam that attacks each regime without touching the mass
accounting: a `ScheduleSpec` selects how the three drain hot paths order
work —

  * ``priority`` — D-Iteration-style drains (Hong et al.,
    arXiv:1501.06350): the coarse-to-fine ladder already pops
    largest-residual-first in bucketed sweeps; this rendering adds the
    *fluid retention* half of the algorithm.  A sweep at level eps drains
    only rows whose fluid clears ``retain_boost * eps``; a row below the
    bar retains the sub-threshold mass its neighbors diffuse back and
    re-enters when the ladder descends far enough for its fluid to
    matter, so the local cadence tax (re-pushing a row for an eps/10
    trickle) collapses into one bigger push per level.  Targets the
    *threads* regime.
  * ``boundary`` (alias ``boundary-batched``) — exchange-cadence
    coalescing: boundary mass destined for one foreign row accumulates
    (folds) in the sender's outbox across ``batch_updates`` local updates
    before the pair ships, so the receiver sees one folded record per
    (pair, row) per generation instead of one re-activation per trickle.
    Significant mass (>= ``batch_mass_frac`` of the sender's sliding
    drain target) ships immediately, and the gate force-opens every
    ``batch_updates`` local updates, so the §6 bounded-delay guarantee
    survives with the bound ``batch_updates + refresh_every`` (the two
    delays compose additively; tests/test_schedule.py pins it).  Targets
    the *procpool* regime.
  * ``randomized`` — seeded Ishii-Tempo random orders (arXiv:1203.6599):
    each sweep drains a uniformly chosen subset of the threshold frontier
    (never empty when the frontier is not), and the superstep loop visits
    shards in a per-step seeded permutation.  Expected convergence follows
    from every sweep still moving >= 1 row with |r| >= eps; this is the
    control arm the priority/boundary wins are measured against.
  * ``priority+boundary`` — both levers at once (the drain-order state
    and the exchange gate are independent).

Soundness is untouched by construction: a schedule only *reorders or
delays* pushes and shipments — retained fluid stays in ``r`` (counted by
its shard), batched boundary mass stays in the sender's outbox (counted in
the sender's published value) — so the mass-conservation invariant and the
exact post-fold certificate recompute are schedule-independent.  The win
must show up in the attribution counters (reduced ``pushes_local`` /
``pushes_boundary``), which is what `benchmarks/check_schedule_inflation.py`
gates.

Wiring in the port: `streaming.update_ranks(schedule=)` /
`streaming.update_ranks_sharded(schedule=)` / `transport.WorkerConfig
.schedule` / `streaming.RankServer(drain_schedule=)`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

#: the selectable renderings (aliases: "boundary-batched" -> "boundary")
SCHEDULES = ("default", "priority", "boundary", "randomized",
             "priority+boundary")

_ALIASES = {
    "boundary-batched": "boundary",
    "boundary_batched": "boundary",
    "priority-boundary": "priority+boundary",
}


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """A drain schedule and its knobs — frozen, hashable and picklable, so
    it rides `WorkerConfig` across the procpool fork/spawn boundary
    unchanged."""

    name: str = "default"
    # --- priority (D-Iteration fluid retention) ---
    retain_boost: float = 2.0   # a sweep at ladder level eps drains only
    #                           # rows with |r| >= retain_boost*eps; rows
    #                           # below the bar retain their fluid until a
    #                           # finer level (boost=2 measured best on
    #                           # the 50k acceptance workload, on the CPU)
    retain_rounds: int = 0      # 0 (default): the boost bar applies to
    #                           # every row (bucket sharpening); > 0: it
    #                           # applies only to rows drained within the
    #                           # last retain_rounds drain calls (the
    #                           # classic per-row retention rendering)
    # --- boundary-batched exchange coalescing ---
    batch_updates: int = 4      # local updates a pair's boundary mass
    #                           # coalesces before the gate force-opens
    batch_mass_frac: float = 0.5  # ship early when the pair's mass
    #                             # reaches this fraction of the sliding
    #                             # drain target (big mass must not wait)
    # --- randomized (Ishii-Tempo) ---
    seed: int = 0
    select_frac: float = 0.5    # expected fraction of the threshold
    #                           # frontier drained per sweep
    # --- drain-call granularity (any schedule, async transports) ---
    drain_frac: Optional[float] = None  # override the executor's sliding
    #                           # per-call drain target fraction
    #                           # (drain_frac * total / p); None keeps the
    #                           # transport default (threads 0.05,
    #                           # procpool 0.25).  Coarser calls re-cross
    #                           # the threshold ladder fewer times — the
    #                           # #1 local-cadence lever on threads
    #                           # (on the CPU) — at the cost of staler
    #                           # exchange/termination checks between
    #                           # calls.  Clamped by the caller to keep
    #                           # hysteresis * drain_frac < 1 (livelock
    #                           # guard).

    def __post_init__(self):
        name = _ALIASES.get(self.name, self.name)
        if name not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.name!r}; expected "
                             f"one of {SCHEDULES} (or alias "
                             f"{tuple(_ALIASES)})")
        object.__setattr__(self, "name", name)
        if self.batch_updates < 1:
            raise ValueError("batch_updates must be >= 1")
        if not (0.0 < self.select_frac <= 1.0):
            raise ValueError("select_frac must be in (0, 1]")
        if self.retain_boost < 1.0:
            raise ValueError("retain_boost must be >= 1 (a boost below 1 "
                             "would re-push below the current level)")
        if self.drain_frac is not None and not (0.0 < self.drain_frac <= 1.0):
            raise ValueError("drain_frac must be in (0, 1] (or None for "
                             "the transport default)")

    # -- which seams this spec actually activates ----------------------
    @property
    def drain_kind(self) -> str:
        """Frontier-selection rendering: default | priority | randomized."""
        if self.name in ("priority", "priority+boundary"):
            return "priority"
        if self.name == "randomized":
            return "randomized"
        return "default"

    @property
    def batch_exchange(self) -> bool:
        """Whether the boundary exchange gate is armed."""
        return self.name in ("boundary", "priority+boundary")

    def order(self, m: int, shard: int = 0) -> Optional["DrainOrder"]:
        """Per-shard frontier-selection state over `m` local rows, or None
        when this spec leaves the default ladder untouched (the zero-cost
        path: callers skip every hook on None)."""
        kind = self.drain_kind
        if kind == "priority":
            return PriorityOrder(self, m)
        if kind == "randomized":
            return RandomizedOrder(self, m, shard)
        return None

    def gate(self, p: int) -> Optional["ExchangeGate"]:
        """Per-shard exchange-coalescing state over `p` peers, or None
        when the spec ships on the plan's own cadence."""
        return ExchangeGate(self, p) if self.batch_exchange else None


DEFAULT_SCHEDULE = ScheduleSpec()


def make_schedule(schedule: Union[None, str, ScheduleSpec]) -> ScheduleSpec:
    """Normalize a user-facing ``schedule=`` value (None, a name, or a
    full spec) to a ScheduleSpec."""
    if schedule is None:
        return DEFAULT_SCHEDULE
    if isinstance(schedule, ScheduleSpec):
        return schedule
    return ScheduleSpec(name=str(schedule))


# ---------------------------------------------------------------------------
# frontier-selection state (one per shard per drain site)
# ---------------------------------------------------------------------------
class DrainOrder:
    """How one shard's coarse-to-fine ladder picks its next sweep.

    The contract with the drain hot paths (`incremental._push`,
    `sharded._drain_shard`):

      * ``begin_round()`` once per drain call (the retention clock);
      * ``refine(absr, frontier, eps, at_floor)`` maps the raw threshold
        frontier (all local rows with |r| >= eps; `absr` aligned with it)
        to the rows this sweep actually drains.  May return an *empty*
        selection at eps above the floor (the ladder then descends one
        level — that is how retention defers a row to the level where its
        fluid matters), but with ``at_floor=True`` a non-empty input must
        stay non-empty: an empty frontier at the floor is the drain's
        certificate that nothing above eps_floor remains, and no schedule
        is allowed to fake it;
      * ``note_drained(frontier)`` after the sweep moved the mass.

    Orderings only reorder/defer pushes; they never touch x/r themselves.
    """

    def begin_round(self) -> None:  # pragma: no cover - trivial default
        pass

    def refine(self, absr: np.ndarray, frontier: np.ndarray, eps: float,
               at_floor: bool) -> np.ndarray:
        return frontier

    def note_drained(self, frontier: np.ndarray) -> None:
        pass


class PriorityOrder(DrainOrder):
    """D-Iteration largest-fluid-first: a sweep at ladder level eps drains
    only rows whose fluid clears ``retain_boost * eps`` — rows below the
    bar *retain* their fluid and re-enter when the ladder descends to the
    level where it matters (or sooner, if neighbors re-fill them past the
    bar).  An empty refined sweep just descends the ladder, so with /8
    level steps the boost is a sub-level offset of the threshold grid
    (boost 8 reproduces the default grid exactly); boost 2 halves the
    small-trickle re-pushes that dominate the threads-regime local
    cadence tax (on the CPU).  At the floor every row >= eps_floor drains
    unconditionally — deferral there would break the certificate.

    ``retain_rounds > 0`` switches to the classic per-row rendering: the
    boost bar applies only to rows drained within the last
    ``retain_rounds`` drain calls (everyone else drains at eps).  Measured
    worse here — deferring exactly the hottest rows is anti-greedy — but
    kept as the comparison arm the docs discuss."""

    def __init__(self, spec: ScheduleSpec, m: int):
        self.boost = float(spec.retain_boost)
        self.keep_rounds = int(spec.retain_rounds)
        # round index of the last drain per local row; -inf sentinel means
        # "never drained" (always eligible)
        self.last = np.full(m, np.iinfo(np.int64).min, dtype=np.int64)
        self.round = 0

    def begin_round(self) -> None:
        self.round += 1

    def refine(self, absr, frontier, eps, at_floor):
        if at_floor or frontier.size == 0:
            return frontier
        keep = absr >= self.boost * eps
        if self.keep_rounds > 0:
            # comparison, not subtraction: the never-drained sentinel is
            # int64.min and `round - last` would wrap
            recent = self.last[frontier] >= self.round - self.keep_rounds
            keep |= ~recent
        return frontier[keep]

    def note_drained(self, frontier) -> None:
        self.last[frontier] = self.round


class RandomizedOrder(DrainOrder):
    """Seeded Ishii-Tempo subsetting: each sweep drains a uniform random
    subset of the threshold frontier (never empty when the input is not,
    so every sweep makes progress and the expected-convergence argument
    goes through).  The stream is a deterministic function of (seed,
    shard, call sequence): the superstep mode replays bit-for-bit."""

    def __init__(self, spec: ScheduleSpec, m: int, shard: int = 0):
        self.frac = float(spec.select_frac)
        self.rng = np.random.default_rng(
            np.random.SeedSequence(entropy=int(spec.seed),
                                   spawn_key=(int(shard),)))

    def refine(self, absr, frontier, eps, at_floor):
        if frontier.size <= 1 or self.frac >= 1.0:
            return frontier
        keep = self.rng.random(frontier.size) < self.frac
        if not keep.any():
            keep[int(self.rng.integers(frontier.size))] = True
        return frontier[keep]


# ---------------------------------------------------------------------------
# exchange-coalescing state (one per shard; peers indexed 0..p-1)
# ---------------------------------------------------------------------------
class ExchangeGate:
    """The boundary-batched shipping gate, consulted *in front of* the
    ExchangePlan: a pair ships only when its coalesced mass is significant
    or the pair's batch window expired.  Sits strictly on the sender side
    — withheld mass stays in the outbox, which the sender's published
    value already counts, so the certificate never sees the gate.

    Bounded delay: ``ready`` is monotone in `updates` and force-opens at
    ``batch_updates`` updates past the last shipment (or past the last
    time the pair was empty — an empty pair "ships" vacuously), so the
    §6 forced-refresh bound degrades additively, never breaks."""

    def __init__(self, spec: ScheduleSpec, p: int):
        self.every = int(spec.batch_updates)
        self.mass_frac = float(spec.batch_mass_frac)
        # last update at which the pair was shipped-or-empty; batching
        # windows are measured from here
        self.last = np.zeros(p, dtype=np.int64)

    def ready(self, d: int, updates: int, mass: float,
              step_target: float) -> bool:
        if updates - self.last[d] >= self.every:
            return True
        return mass >= self.mass_frac * step_target

    def note_sent(self, d: int, updates: int) -> None:
        self.last[d] = updates

    def note_quiet(self, d: int, updates: int) -> None:
        # nothing pending for this pair: restart the window so the first
        # trickle of a new generation coalesces for a full batch_updates
        self.last[d] = updates
