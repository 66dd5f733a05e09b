"""Runtime observability of the port: metrics registry, event tracing,
push-inflation attribution (the JAX package's runtime/observe.py, copied:
host numpy, so the rings, the counters and every rendering equal the
reference's bit for bit).

Three pieces, all built on plain numpy arrays so the *same* code runs
over in-process arrays (threads transport) and over `ShardArena` views
(procpool transport, where worker-written slots must survive the
process boundary and supervisor respawns):

  * a lock-cheap **metrics registry** — a fixed schema of per-shard
    counter slots (`OBS_COUNTERS`) plus one fixed-bucket histogram
    (drain seconds).  Every slot is single-writer (shard i writes row i;
    the parent/supervisor writes only while no worker incarnation is
    alive), so there are no locks anywhere on the hot path — one float
    add per count, exactly the idiom the control arena already uses for
    `rounds`/`pushes`.

  * **structured event tracing** — per-shard ring buffers of fixed-width
    monotonic-clock records emitted at the eq. (5) cycle seams of
    `shard_worker_loop` (intake, drain with rows + pre-drain mass +
    attribution deltas, exchange with rows/bytes/generation, Fig. 1
    CONVERGE/DIVERGE/STOP transitions, fault injections, supervisor
    recoveries).  `time.perf_counter()` is CLOCK_MONOTONIC on Linux and
    therefore comparable across the procpool's processes.  Rings
    overwrite oldest-first; the cumulative write counter makes drops
    explicit.  `chrome_trace()` exports the stream as Chrome
    `trace_event` JSON (one track per shard, instant events for
    termination/fault/recovery) loadable in Perfetto / chrome://tracing.

  * **push-inflation attribution** — per-row `pushed`/`foreign` flags
    (uint8, disjoint row ownership keeps them single-writer) classify
    every drained row as a *first* push, a *local* re-push (the row's
    own sweep order re-crossed the threshold), or a *boundary* re-push
    (foreign mass folded at intake re-activated it).  Intake folds mark
    `foreign`; the drain clears both flags and bumps a per-shard
    (first, local, boundary) count row.  DRAIN events carry the deltas
    together with the exchange generation, so a run's push inflation
    splits into exchange cadence vs drain order vs boundary
    re-activation.

Everything is **zero-cost when off**: the observer default is `None`
and every hook is behind an `if obs is not None` — no registry object,
no ring allocation, no arena slots (the control-arena spec only grows
when observing).  `render_prometheus` also renders the rank server's
metrics text.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# event schema
# ---------------------------------------------------------------------------
# fixed-width record: t, dur, kind, shard, gen, a, b, c, d, spare
EV_WIDTH = 10

EV_INTAKE = 1     # a = progressed (0/1)
EV_DRAIN = 2      # a = rows pushed, b = pre-drain own |r|_1 (pushed mass
                  # upper bound), c = local re-push delta, d = boundary
                  # re-push delta; gen = exchange generation (updates)
EV_EXCHANGE = 3   # a = destination shard, b = rows shipped, c = bytes
EV_CONVERGE = 4   # local verdict flipped to converged (Fig. 1)
EV_DIVERGE = 5    # local verdict flipped to diverged (Fig. 1)
EV_STOP = 6       # shard observed the global STOP and exited
EV_KILL = 7       # fault injection: kill fired (a = round)
EV_HANG = 8       # fault injection: hang fired (a = seconds)
EV_RECOVERY = 9   # supervisor recovery (a = pool slot / worker,
                  # b = exitcode, c = restored-from-checkpoint (0/1);
                  # dur = detection -> recovered seconds)
EV_CAPPED = 10    # push budget hit (a = round)
EV_CHUNK = 11     # SPMD compact-lanes chunk (a = lanes, b = steps,
                  # c = rows, d = bytes)

EV_NAMES = {
    EV_INTAKE: "INTAKE", EV_DRAIN: "DRAIN", EV_EXCHANGE: "EXCHANGE",
    EV_CONVERGE: "CONVERGE", EV_DIVERGE: "DIVERGE", EV_STOP: "STOP",
    EV_KILL: "KILL", EV_HANG: "HANG", EV_RECOVERY: "RECOVERY",
    EV_CAPPED: "CAPPED", EV_CHUNK: "CHUNK",
}

# events rendered as Chrome "X" (complete, with duration) vs "i" (instant)
_EV_SPAN = (EV_INTAKE, EV_DRAIN, EV_EXCHANGE)

DEFAULT_EVENT_CAP = 2048

# ---------------------------------------------------------------------------
# metrics registry schema (per-shard counter slots, single writer per row)
# ---------------------------------------------------------------------------
OBS_COUNTERS = (
    "intakes", "uniform_folds",
    "drains", "drain_rows", "drain_mass",
    "exchanges", "exchange_rows", "exchange_bytes",
    "converges", "diverges", "stops", "capped",
    "kills", "hangs", "recoveries",
)
OBS_NC = len(OBS_COUNTERS)
_CIDX = {name: k for k, name in enumerate(OBS_COUNTERS)}

# hot-path integer indices (shard_worker_loop uses these directly:
# `obs.ctr[i, C_DRAINS] += 1` is the whole registry write path)
C_INTAKES = _CIDX["intakes"]
C_UNIFORM_FOLDS = _CIDX["uniform_folds"]
C_DRAINS = _CIDX["drains"]
C_DRAIN_ROWS = _CIDX["drain_rows"]
C_DRAIN_MASS = _CIDX["drain_mass"]
C_EXCHANGES = _CIDX["exchanges"]
C_EXCHANGE_ROWS = _CIDX["exchange_rows"]
C_EXCHANGE_BYTES = _CIDX["exchange_bytes"]
C_CONVERGES = _CIDX["converges"]
C_DIVERGES = _CIDX["diverges"]
C_STOPS = _CIDX["stops"]
C_CAPPED = _CIDX["capped"]
C_KILLS = _CIDX["kills"]
C_HANGS = _CIDX["hangs"]
C_RECOVERIES = _CIDX["recoveries"]

# drain-duration histogram: fixed upper bounds in seconds, +inf last
HIST_BOUNDS = (1e-4, 1e-3, 1e-2, 1e-1, 1.0)
OBS_NB = len(HIST_BOUNDS) + 1


def obs_ctl_entries(p: int, n: int, event_cap: int = DEFAULT_EVENT_CAP,
                    attribution: bool = True) -> Dict[str, Tuple]:
    """Arena-spec entries for the observability slots (merged into the
    control-arena spec by `_ctl_spec(..., observe=True)`; allocated as
    plain numpy by `ShardObserver.alloc` for the threads transport)."""
    spec = {
        "obs_buf": ((p, int(event_cap), EV_WIDTH), np.float64),
        "obs_n": ((p,), np.int64),
        "obs_ctr": ((p, OBS_NC), np.float64),
        "obs_hist": ((p, OBS_NB), np.float64),
    }
    if attribution:
        spec.update({
            "obs_pushed": ((n,), np.uint8),
            "obs_foreign": ((n,), np.uint8),
            "obs_attr": ((p, 3), np.int64),   # first / local / boundary
        })
    return spec


class ShardObserver:
    """Bundle of the registry + trace + attribution arrays for one run.

    Arrays may be plain numpy (threads transport, allocated by `alloc`)
    or `ShardArena` views (procpool: the executor adds the `obs_*` slots
    to the control segment and each side wraps its own views) — the
    observer itself holds no locks and no process state.  `pushed` /
    `foreign` / `attr` are optional: synthetic drains that don't do
    attribution leave them None.
    """

    __slots__ = ("p", "cap", "buf", "n_ev", "ctr", "hist",
                 "pushed", "foreign", "attr")

    def __init__(self, buf: np.ndarray, n_ev: np.ndarray, ctr: np.ndarray,
                 hist: Optional[np.ndarray] = None,
                 pushed: Optional[np.ndarray] = None,
                 foreign: Optional[np.ndarray] = None,
                 attr: Optional[np.ndarray] = None):
        self.buf = buf
        self.n_ev = n_ev
        self.ctr = ctr
        self.hist = hist
        self.pushed = pushed
        self.foreign = foreign
        self.attr = attr
        self.p = int(buf.shape[0])
        self.cap = int(buf.shape[1])

    # -- construction ------------------------------------------------------
    @classmethod
    def alloc(cls, p: int, n: Optional[int] = None,
              event_cap: int = DEFAULT_EVENT_CAP) -> "ShardObserver":
        """Plain-numpy observer (threads / in-process).  Attribution
        arrays are allocated when `n` is given."""
        obs = cls(
            buf=np.zeros((p, int(event_cap), EV_WIDTH)),
            n_ev=np.zeros(p, dtype=np.int64),
            ctr=np.zeros((p, OBS_NC)),
            hist=np.zeros((p, OBS_NB)),
        )
        if n is not None:
            obs.pushed = np.zeros(int(n), dtype=np.uint8)
            obs.foreign = np.zeros(int(n), dtype=np.uint8)
            obs.attr = np.zeros((p, 3), dtype=np.int64)
        return obs

    @classmethod
    def from_views(cls, views) -> "ShardObserver":
        """Wrap arena (or dict) views produced from `obs_ctl_entries`;
        attribution arrays picked up when present."""
        ks = set(views.keys())

        def get(k):
            return views[k] if k in ks else None
        return cls(buf=views["obs_buf"], n_ev=views["obs_n"],
                   ctr=views["obs_ctr"], hist=get("obs_hist"),
                   pushed=get("obs_pushed"), foreign=get("obs_foreign"),
                   attr=get("obs_attr"))

    # -- hot path ----------------------------------------------------------
    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def emit(self, kind: int, shard: int, t: float, dur: float = 0.0,
             gen: float = 0.0, a: float = 0.0, b: float = 0.0,
             c: float = 0.0, d: float = 0.0) -> None:
        """Append one record to shard's ring (single writer per shard)."""
        k = int(self.n_ev[shard])
        rec = self.buf[shard, k % self.cap]
        rec[0] = t
        rec[1] = dur
        rec[2] = kind
        rec[3] = shard
        rec[4] = gen
        rec[5] = a
        rec[6] = b
        rec[7] = c
        rec[8] = d
        self.n_ev[shard] = k + 1    # count bumped after the record lands

    def inc(self, name: str, shard: int, v: float = 1.0) -> None:
        self.ctr[shard, _CIDX[name]] += v

    def observe_drain_s(self, shard: int, seconds: float) -> None:
        if self.hist is None:
            return
        for k, ub in enumerate(HIST_BOUNDS):
            if seconds <= ub:
                self.hist[shard, k] += 1.0
                return
        self.hist[shard, OBS_NB - 1] += 1.0

    # -- read-back (parent side, after/outside the hot loop) ---------------
    def events(self) -> List[dict]:
        """Decode all rings into dicts, globally sorted by time.  Within
        one shard the order is exactly the writer's program order (one
        monotonic clock per writer)."""
        out: List[dict] = []
        for i in range(self.p):
            n = int(self.n_ev[i])
            for k in range(max(0, n - self.cap), n):
                rec = self.buf[i, k % self.cap]
                kind = int(rec[2])
                out.append({
                    "t": float(rec[0]), "dur": float(rec[1]),
                    "kind": kind, "name": EV_NAMES.get(kind, str(kind)),
                    "shard": int(rec[3]), "gen": float(rec[4]),
                    "a": float(rec[5]), "b": float(rec[6]),
                    "c": float(rec[7]), "d": float(rec[8]),
                })
        out.sort(key=lambda ev: ev["t"])
        return out

    def counters(self) -> Dict[str, List[float]]:
        return {name: [float(v) for v in self.ctr[:, k]]
                for k, name in enumerate(OBS_COUNTERS)}

    def attribution(self) -> Optional[Dict[str, object]]:
        if self.attr is None:
            return None
        tot = self.attr.sum(axis=0)
        return {
            "first": int(tot[0]), "local": int(tot[1]),
            "boundary": int(tot[2]),
            "per_shard": [[int(v) for v in row] for row in self.attr],
        }

    def snapshot(self) -> Dict[str, object]:
        """JSON-friendly roll-up: counters + histogram + ring accounting
        + attribution (when armed).  This is what lands in
        `AsyncRunResult.observed` / `ShardedUpdateStats.observed`."""
        written = [int(v) for v in self.n_ev]
        snap: Dict[str, object] = {
            "counters": self.counters(),
            "events_written": written,
            "events_dropped": [max(0, w - self.cap) for w in written],
            "event_cap": self.cap,
        }
        if self.hist is not None:
            snap["drain_s_hist"] = {
                "bounds": list(HIST_BOUNDS) + ["+inf"],
                "counts": [[float(v) for v in row] for row in self.hist],
            }
        attr = self.attribution()
        if attr is not None:
            snap["attribution"] = attr
        return snap

    def observed(self) -> Dict[str, object]:
        """snapshot() + the decoded event stream (the full payload)."""
        out = self.snapshot()
        out["events"] = self.events()
        return out


# ---------------------------------------------------------------------------
# push-inflation attribution (called from the drain, frontier in hand)
# ---------------------------------------------------------------------------
def attribute_frontier(pushed: np.ndarray, foreign: np.ndarray,
                       cnt: np.ndarray, frontier: np.ndarray) -> None:
    """Classify one drained frontier (global row ids) into first /
    local re-push / boundary re-push counts (`cnt` is the shard's
    (3,) int64 row — single writer) and advance the per-row flags:
    every pushed row becomes `pushed`, and its `foreign` mark — set by
    intake folds since the last push — is consumed."""
    if frontier.size == 0:
        return
    first = pushed[frontier] == 0
    nf = int(first.sum())
    nb = int((~first & (foreign[frontier] != 0)).sum())
    cnt[0] += nf
    cnt[2] += nb
    cnt[1] += frontier.size - nf - nb
    pushed[frontier] = 1
    foreign[frontier] = 0


# ---------------------------------------------------------------------------
# Chrome trace_event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------
def chrome_trace(events: Sequence[dict], p: Optional[int] = None,
                 pid_name: str = "async-shard-runtime") -> Dict[str, object]:
    """Render a decoded event stream (from `ShardObserver.events()` or
    `observed["events"]`) as a Chrome `trace_event` JSON object: one
    track (tid) per shard, "X" complete events for the spans (intake /
    drain / exchange), "i" instant events for Fig. 1 transitions,
    faults and recoveries.  Timestamps are microseconds relative to the
    earliest event."""
    shards = sorted({int(ev["shard"]) for ev in events})
    if p is not None:
        shards = sorted(set(shards) | set(range(int(p))))
    t0 = min((ev["t"] for ev in events), default=0.0)
    tev: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": pid_name}},
    ]
    for i in shards:
        tev.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": i,
                    "args": {"name": "shard %d" % i}})
    for ev in events:
        kind = int(ev["kind"])
        name = EV_NAMES.get(kind, str(kind))
        args = {"gen": ev["gen"], "a": ev["a"], "b": ev["b"],
                "c": ev["c"], "d": ev["d"]}
        base = {"name": name, "pid": 0, "tid": int(ev["shard"]),
                "ts": (ev["t"] - t0) * 1e6, "cat": "runtime", "args": args}
        if kind in _EV_SPAN:
            base["ph"] = "X"
            base["dur"] = max(ev["dur"], 0.0) * 1e6
        else:
            base["ph"] = "i"
            base["s"] = "t"     # thread-scoped instant
        tev.append(base)
    return {"traceEvents": tev, "displayTimeUnit": "ms"}


def write_chrome_trace(path, events: Sequence[dict],
                       p: Optional[int] = None) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace(events, p=p), fh)


# ---------------------------------------------------------------------------
# Prometheus text exposition (shared by RankServer.metrics_text and tools)
# ---------------------------------------------------------------------------
def render_prometheus(families: Sequence[Tuple[str, str, object]],
                      prefix: str = "repro") -> str:
    """Render `(name, type, value)` families in the Prometheus text
    format.  `value` is a scalar, or a dict of `labels-dict -> scalar`
    (labels rendered sorted, values escaped), e.g.::

        render_prometheus([
            ("queries_served", "counter", 12),
            ("shard_pushes", "counter",
             {(("shard", "0"),): 41, (("shard", "1"),): 7}),
        ])
    """
    def fmt(v) -> str:
        f = float(v)
        if f == int(f) and abs(f) < 1e15:
            return str(int(f))
        return repr(f)

    lines: List[str] = []
    for name, typ, value in families:
        full = "%s_%s" % (prefix, name) if prefix else name
        lines.append("# TYPE %s %s" % (full, typ))
        if isinstance(value, dict):
            for labels, v in value.items():
                lab = ",".join(
                    '%s="%s"' % (k, str(lv).replace("\\", r"\\")
                                 .replace('"', r'\"').replace("\n", r"\n"))
                    for k, lv in labels)
                lines.append("%s{%s} %s" % (full, lab, fmt(v)))
        else:
            lines.append("%s %s" % (full, fmt(value)))
    return "\n".join(lines) + "\n"


def counters_to_families(counters: Dict[str, List[float]]
                         ) -> List[Tuple[str, str, object]]:
    """Per-shard counter dict (from `ShardObserver.counters()`) ->
    Prometheus families with a `shard` label."""
    return [
        (name, "counter",
         {(("shard", str(i)),): v for i, v in enumerate(vals)})
        for name, vals in counters.items()
    ]
