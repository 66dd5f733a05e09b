"""The port's asynchronous host runtime (runtime/state.py ShardArena,
transport.py, executor.py, faults.py, supervisor.py, observe.py) against
the JAX package's, on the CPU.

The deterministic parts are host numpy copied from the JAX package, so the
same inputs must give the same bits: the SPSC rings (FIFO order,
backpressure, sequence dedupe, pending L1), the pair mailboxes and the
uniform accumulator, the procpool control block's ledgers, FaultPlan's
validation errors, FaultyContext's per-link fault schedule for the plans
of tests/test_faults.py, the restart backoff, the push-inflation
attribution, the observer's ring overwrite and drop accounting, and the
Prometheus and Chrome-trace renderings of one synthetic event stream.

The executors' schedules are not deterministic, so the executor tests hold
results on synthetic drains (tests/_torch_async_drains.py): the run
terminates and conserves mass; the round and push caps report `capped`; a
crashing worker raises and releases its segments; a killed worker is
restarted and leaves no segment behind. Every run has a round cap and runs
under `within`, a wall-clock deadline that fails the test instead of
hanging it. Segments are counted by the creating pid, so other test files
running beside this one (xdist) never disturb the count.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import repro.core  # noqa: F401  (resolves the JAX package's import cycle)
import repro.runtime as J
import repro_torch.runtime as T
from repro.core.partition import block_rows as j_block_rows
from repro.runtime import faults as j_faults
from repro.runtime import observe as j_obs
from repro.runtime import transport as j_tr
from repro_torch.core.partition import block_rows as t_block_rows
from repro_torch.runtime import faults as t_faults
from repro_torch.runtime import observe as t_obs
from repro_torch.runtime import transport as t_tr

from _torch_async_drains import (AbsorbDrain, Crasher, NeverConverges,
                                 absorb, own_segments, within)


# the JAX package's at-fork hook warns whenever this process forks; the
# port's procpool workers run numpy only and never enter JAX
pytestmark = pytest.mark.filterwarnings(
    r"ignore:os\.fork\(\) was called:RuntimeWarning")

# ---------------------------------------------------------------------------
# rings, mailboxes, the uniform accumulator, the control block
# ---------------------------------------------------------------------------
def ring_arrays(depth, cap, seq):
    a = dict(head=np.zeros(1, np.int64), tail=np.zeros(1, np.int64),
             cnt=np.zeros(depth, np.int64),
             idx=np.zeros((depth, cap), np.int32),
             val=np.zeros((depth, cap), np.float64))
    if seq:
        a.update(seq=np.zeros(depth, np.int64),
                 next_seq=np.zeros(1, np.int64),
                 last_seq=np.zeros(1, np.int64))
    return a


@pytest.mark.parametrize("seq", [False, True], ids=["plain", "sequenced"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shm_ring_script_matches_reference(seed, seq):
    """One seeded script of pushes (duplicates included), folds with and
    without row marks, and pending-mass reads through both packages' rings:
    every return value, the folded block, the marks and every slot equal,
    bit for bit — FIFO order, backpressure, dedupe and pending_l1."""
    depth, cap, n = 4, 6, 10
    rings, outs, marks = [], [], []
    for mod in (j_tr, t_tr):
        a = ring_arrays(depth, cap, seq)
        rings.append((a, mod.ShmRing(**a)))
        outs.append(np.zeros(n))
        marks.append(np.zeros(n, np.uint8))
    rng = np.random.default_rng(seed)
    log = ([], [])
    for step in range(120):
        op = rng.integers(0, 4)
        k = int(rng.integers(1, cap + 1))
        rows = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
        vals = rng.standard_normal(k)
        dup = bool(rng.integers(0, 2)) and seq
        mark = bool(rng.integers(0, 2))
        for side, (_, ring) in enumerate(rings):
            if op <= 1:
                got = ring.push(rows, vals, dup=dup)
            elif op == 2:
                got = ring.pop_into(outs[side],
                                    mark=marks[side] if mark else None)
            else:
                got = (ring.pending_l1(), ring.empty())
            log[side].append(got)
    assert log[0] == log[1]
    assert any(v is False for v in log[0])          # backpressure hit
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(marks[0], marks[1])
    for k in rings[0][0]:
        np.testing.assert_array_equal(rings[0][0][k], rings[1][0][k],
                                      err_msg=k)


def test_pair_mailbox_and_uniform_accumulator_match_reference():
    """Seeded deposits (sequenced, duplicated, stale and unsequenced)
    and folds through both packages' mailboxes, and adds and takes
    through their uniform accumulators: equal bits throughout."""
    rng = np.random.default_rng(9)
    mbs = [J.PairMailbox(6), T.PairMailbox(6)]
    unis = [J.UniformAccumulator(3), T.UniformAccumulator(3)]
    rs = [np.zeros(12), np.zeros(12)]
    marks = [np.zeros(12, np.uint8), np.zeros(12, np.uint8)]
    log = ([], [])
    seq = 0
    for _ in range(200):
        op = rng.integers(0, 5)
        block = rng.standard_normal(6) * (rng.random(6) < 0.5)
        if op == 0:
            seq += 1
        s = (None if op == 3 else seq if op < 2
             else max(1, seq - int(rng.integers(0, 3))))
        v = float(rng.standard_normal())
        i = int(rng.integers(0, 3))
        for side in (0, 1):
            if op <= 3:
                mbs[side].deposit(block, seq=s)
                got = mbs[side].l1()
            else:
                got = (mbs[side].drain_into(rs[side], 3, 9,
                                            mark=marks[side]),
                       unis[side].take(i))
            unis[side].add(v)
            log[side].append((got, unis[side].pending(i)))
    assert log[0] == log[1]
    np.testing.assert_array_equal(rs[0], rs[1])
    np.testing.assert_array_equal(marks[0], marks[1])
    np.testing.assert_array_equal(mbs[0].buf, mbs[1].buf)


def ctl_dict(mod, p, n, part, observe):
    spec = mod._ctl_spec(p, n, part, ring_depth=4, payload_cap=3,
                         observe=observe, obs_event_cap=16)
    return {k: np.zeros(shape, dtype) for k, (shape, dtype) in spec.items()}


@pytest.mark.parametrize("observe", [False, True])
def test_proc_context_ledgers_match_reference(observe):
    """The procpool control block driven through both packages'
    ProcContext: sends split into records of at most 3 rows, wire
    duplicates, ring backpressure, folds, uniform adds, values, Fig. 1
    messages and checkpoints — every control array equal, bit for bit,
    and the in-flight ledgers net to zero after the last fold."""
    p, n = 3, 18
    rng = np.random.default_rng(4)
    runs = []
    for mod, br in ((j_tr, j_block_rows), (t_tr, t_block_rows)):
        part = br(n, p)
        ctl = ctl_dict(mod, p, n, part, observe)
        ctl["mail_next_seq"][:] = 1
        r = np.zeros(n)
        obs = (mod.ShardObserver.from_views(ctl) if observe else None)
        ctx = mod.ProcContext(ctl, part, mod.WorkerConfig(l1_target=1e-9),
                              pc_max_compute=1, r=r, x=np.zeros(n),
                              checkpoint_every=2, obs=obs)
        runs.append((ctx, ctl, r, part))
    log = ([], [])
    draws = [(int(rng.integers(0, 3)), int(rng.integers(0, p)),
              int(rng.integers(1, p)), rng.standard_normal(n),
              bool(rng.integers(0, 2)), float(rng.standard_normal()))
             for _ in range(150)]
    for it, (op, i, off, vals, dup, v) in enumerate(draws):
        d = (i + off) % p
        for side, (ctx, ctl, r, part) in enumerate(runs):
            sd, ed = part.block(d)
            s, e = part.block(i)
            if op == 0:
                box = ctx.outbox(i)
                box[sd:ed] += vals[sd:ed] * (np.abs(vals[sd:ed]) > 0.5)
                got = ctx.send(i, d, box[sd:ed], dup=dup)
            elif op == 1:
                got = (ctx.fold_intake(i, r, s, e), ctx.intake_ready(i))
                ctx.uniform_add(i, v)
            else:
                ctx.publish_value(i, abs(v))
                got = (ctx.report(i, v > 0, it), ctx.inflight_l1(i),
                       ctx.uniform_pending(i), ctx.values_total())
            log[side].append(got)
    assert log[0] == log[1]
    for side, (ctx, ctl, r, part) in enumerate(runs):
        for i in range(p):
            s, e = part.block(i)
            ctx.fold_intake(i, r, s, e)
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k],
                                      err_msg=k)
    np.testing.assert_array_equal(runs[0][2], runs[1][2])
    ctx = runs[1][0]
    assert all(ctx.inflight_l1(i) == pytest.approx(0.0, abs=1e-12)
               for i in range(p))


# ---------------------------------------------------------------------------
# faults, backoff
# ---------------------------------------------------------------------------
BAD_PLANS = [dict(drop_rate=1.0), dict(dup_rate=-0.1),
             dict(delay_rate=1.5),
             dict(drop_rate=0.5, dup_rate=0.3, delay_rate=0.2),
             dict(slow={1: 0.0}), dict(hang={0: (2, -1.0)}),
             dict(max_delay_rounds=0)]


@pytest.mark.parametrize("kw", BAD_PLANS, ids=[str(k) for k in BAD_PLANS])
def test_fault_plan_validation_matches_reference(kw):
    msgs = []
    for mod in (J, T):
        with pytest.raises(ValueError) as exc:
            mod.FaultPlan(**kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_fault_plan_active_matches_reference():
    for kw in ({}, dict(seed=3), dict(drop_rate=0.2), dict(kill={0: 3}),
               dict(hang={1: (2, 0.0)}), dict(slow={0: 1.0}),
               dict(delay_rate=0.1)):
        assert J.FaultPlan(**kw).active == T.FaultPlan(**kw).active, kw


class _Recorder:
    """The inner TransportContext of a FaultyContext: records what reaches
    the wire."""

    def __init__(self, n, p):
        self.log = []
        self.boxes = [np.zeros(n) for _ in range(p)]

    def send(self, i, d, box, dup=False):
        nz = int(np.count_nonzero(box))
        self.log.append(("send", i, d, dup, box.tobytes()))
        box[:] = 0.0
        return nz

    def report(self, i, verdict, it):
        self.log.append(("report", i, verdict, it))
        return False

    def add_pushes(self, i, k):
        self.log.append(("pushes", i, k))

    def inflight_l1(self, i):
        return 0.0

    def outbox(self, i):
        return self.boxes[i]

    def record_rounds(self, i, it):
        self.log.append(("rounds", i, it))


# the five plans of tests/test_faults.py's recovery tests
FAULT_PLANS = {
    "kill": dict(seed=1, kill={0: 4, 2: 9}),
    "drop_dup_delay": dict(seed=2, drop_rate=0.15, dup_rate=0.10,
                           delay_rate=0.10, max_delay_rounds=4),
    "hang_slow": dict(seed=3, hang={1: (3, 0.05)}, slow={0: 5e5}),
    "procpool_kill": dict(seed=4, kill={1: 5}),
    "drop_dup": dict(seed=5, drop_rate=0.10, dup_rate=0.10),
}


@pytest.mark.parametrize("name", sorted(FAULT_PLANS))
def test_faulty_context_link_schedule_matches_reference(name):
    """Both packages' FaultyContext (thread kill mode) over a recording
    inner context, p = 3, driven through 30 rounds of reports, pushes and
    seeded sends on every link: the same kills and hangs at the same
    rounds, the same drop/dup/delay decisions per link, the same held and
    flushed payloads, the same fired flags."""
    p, n = 3, 12
    logs, fired = [], []
    for mod, fmod, br in ((J, j_faults, j_block_rows),
                          (T, t_faults, t_block_rows)):
        plan = mod.FaultPlan(**FAULT_PLANS[name])
        inner = _Recorder(n, p)
        state = plan.state(p)
        fc = fmod.FaultyContext(inner, plan, br(n, p), fired=state.fired,
                                kill_mode="thread")
        rng = np.random.default_rng(77)
        out = []
        for it in range(1, 31):
            for i in range(p):
                try:
                    out.append(("r", fc.report(i, it % 3 == 0, it)))
                except fmod.InjectedWorkerKill as exc:
                    out.append(("killed", exc.shard, it))
                fc.add_pushes(i, 10)
                for d in range(p):
                    if d == i:
                        continue
                    box = rng.standard_normal(4) * (rng.random(4) < 0.7)
                    got = fc.send(i, d, box)
                    out.append(("s", got, box.tobytes(), fc.inflight_l1(i)))
        for i in range(p):
            fc.record_rounds(i, 31)
        out.append([b.tobytes() for b in inner.boxes])
        logs.append((out, inner.log))
        fired.append(state.fired.copy())
    assert logs[0] == logs[1]
    np.testing.assert_array_equal(fired[0], fired[1])
    if "kill" in name:
        assert any(o[0] == "killed" for o in logs[0][0])


@pytest.mark.parametrize("kw", [{}, dict(base_s=0.001, factor=3.0,
                                         cap_s=0.1),
                                dict(base_s=0.5, factor=1.5, cap_s=0.4)])
def test_backoff_policy_matches_reference(kw):
    a, b = J.BackoffPolicy(**kw), T.BackoffPolicy(**kw)
    assert [a.delay(k) for k in range(16)] == [b.delay(k) for k in range(16)]


# ---------------------------------------------------------------------------
# observer: attribution, ring accounting, renderings
# ---------------------------------------------------------------------------
def test_attribute_frontier_matches_reference():
    rng = np.random.default_rng(12)
    n = 64
    state = []
    for mod in (j_obs, t_obs):
        state.append((np.zeros(n, np.uint8), np.zeros(n, np.uint8),
                      np.zeros(3, np.int64), mod))
    for _ in range(40):
        frontier = np.unique(rng.integers(0, n, int(rng.integers(0, 20))))
        foreign_rows = rng.integers(0, n, 5)
        for pushed, foreign, cnt, mod in state:
            foreign[foreign_rows] = 1
            mod.attribute_frontier(pushed, foreign, cnt, frontier)
    for a, b in zip(state[0][:3], state[1][:3]):
        np.testing.assert_array_equal(a, b)
    assert state[1][2].sum() > 0


def synthetic_observer(mod, p=3, cap=8):
    """One observer per package, fed the same seeded event stream: more
    events than the ring holds on shard 0 (overwrite), every kind, counter
    bumps and drain-time histogram entries."""
    obs = mod.ShardObserver.alloc(p, n=20, event_cap=cap)
    rng = np.random.default_rng(5)
    kinds = sorted(mod.EV_NAMES)
    for k in range(40):
        i = 0 if k % 2 else int(rng.integers(0, p))
        obs.emit(int(kinds[k % len(kinds)]), i, 10.0 + 1e-3 * k,
                 dur=float(rng.random()) * 1e-3, gen=float(k),
                 a=float(rng.standard_normal()), b=float(k % 5),
                 c=float(rng.random()), d=float(-k))
        obs.inc(mod.OBS_COUNTERS[k % len(mod.OBS_COUNTERS)], i,
                float(rng.integers(1, 4)))
        obs.observe_drain_s(i, float(10.0 ** rng.uniform(-5, 0.5)))
    mod.attribute_frontier(obs.pushed, obs.foreign, obs.attr[1],
                           np.arange(0, 20, 3))
    return obs


def test_observer_ring_and_snapshot_match_reference():
    a, b = synthetic_observer(j_obs), synthetic_observer(t_obs)
    for f in ("buf", "n_ev", "ctr", "hist", "pushed", "foreign", "attr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    sa, sb = a.observed(), b.observed()
    assert sa == sb
    assert sb["events_dropped"][0] > 0              # shard 0 overwrote
    assert len(sb["events"]) == sum(min(w, b.cap)
                                    for w in sb["events_written"])


def test_renderings_match_reference(tmp_path):
    """render_prometheus of the counters and of a mixed family list, and
    the Chrome trace of the same event stream, byte for byte; the trace
    file loads back as JSON."""
    a, b = synthetic_observer(j_obs), synthetic_observer(t_obs)
    fams = [("queries_served", "counter", 12), ("cert", "gauge", 3.5e-9),
            ("lag", "gauge", {(("replica", 'a"b\\c\n'),): 2})]
    for prefix in ("repro", "", "repro_rank_server"):
        assert j_obs.render_prometheus(fams, prefix=prefix) \
            == t_obs.render_prometheus(fams, prefix=prefix)
    assert j_obs.render_prometheus(j_obs.counters_to_families(
        a.counters())) == t_obs.render_prometheus(
        t_obs.counters_to_families(b.counters()))
    assert j_obs.chrome_trace(a.events(), p=4) \
        == t_obs.chrome_trace(b.events(), p=4)
    j_obs.write_chrome_trace(tmp_path / "j.json", a.events(), p=3)
    t_obs.write_chrome_trace(tmp_path / "t.json", b.events(), p=3)
    assert (tmp_path / "j.json").read_bytes() \
        == (tmp_path / "t.json").read_bytes()
    trace = json.loads((tmp_path / "t.json").read_text())
    assert {ev["ph"] for ev in trace["traceEvents"]} == {"M", "X", "i"}


# ---------------------------------------------------------------------------
# the arena
# ---------------------------------------------------------------------------
def test_arena_lifecycle_and_prefix():
    """Create, attach, write through either mapping, close without and
    with unlink; the segment carries the port's prefix and this pid."""
    arena = T.ShardArena.from_arrays(dict(
        r=np.arange(7, dtype=np.float64),
        idx=np.arange(12, dtype=np.int32).reshape(3, 4)))
    name = arena.name
    assert name.startswith(T.ARENA_PREFIX + "_%d_" % os.getpid())
    assert not name.startswith("repro_arena")
    assert own_segments() == [name]
    other = T.ShardArena.attach(arena.handle())
    other["r"][2] = 99.0
    assert arena["r"][2] == 99.0
    np.testing.assert_array_equal(other["idx"], np.arange(12).reshape(3, 4))
    other.close()
    assert own_segments() == [name]
    view = arena["r"]
    arena.close()
    arena.close()
    assert own_segments() == []
    assert view.shape == (7,)


def test_sweep_reclaims_dead_creators_only():
    """A segment stamped with a dead pid is reclaimed; one stamped with a
    live pid (ours) and one of another prefix are left alone."""
    from multiprocessing import shared_memory
    dead = subprocess.run([sys.executable, "-c",
                           "import os; print(os.getpid())"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    names = [f"{T.ARENA_PREFIX}_ctl_{dead}_0badc0de",
             f"{T.ARENA_PREFIX}_{os.getpid()}_0badc0de",
             f"repro_torch_other_{dead}_0badc0de"]
    segs = [shared_memory.SharedMemory(name=nm, create=True, size=64)
            for nm in names]
    try:
        # another test process's sweep may reclaim the dead one first, so
        # hold the outcome, not this call's count
        T.sweep_stale_segments()
        left = set(os.listdir("/dev/shm"))
        assert names[0] not in left
        assert names[1] in left and names[2] in left
    finally:
        from multiprocessing import resource_tracker
        for s in segs:
            s.close()
            try:
                s.unlink()
            except FileNotFoundError:     # swept: drop our registration
                resource_tracker.unregister(s._name, "shared_memory")


# ---------------------------------------------------------------------------
# executors on synthetic drains
# ---------------------------------------------------------------------------
def executor(kind, p, n, target, **kw):
    part = t_block_rows(n, p)
    args = (part, T.AllToAllPlan(p), T.TerminationDriver(p))
    if kind == "threads":
        return T.AsyncShardExecutor(*args, l1_target=target, **kw)
    return T.ProcPoolShardExecutor(*args, l1_target=target, **kw)


def run_executor(kind, ex, factory, r0):
    """Run `ex` on a drain built from `factory` over a copy of r0; returns
    (result, final residual)."""
    if kind == "threads":
        r = r0.copy()
        res = within(ex.run, factory({"r": r}), r)
        return res, r
    with T.ShardArena.from_arrays(dict(r=r0)) as arena:
        try:
            res = within(ex.run, factory, arena)
        finally:
            r = arena["r"].copy()
    return res, r


@pytest.mark.parametrize("kind,kw", [
    ("threads", {}), ("procpool", {}),
    ("procpool", dict(n_workers=1)),
    ("procpool", dict(start_method="spawn"))],
    ids=["threads", "procpool", "procpool-1worker", "procpool-spawn"])
def test_executor_terminates_and_conserves_mass(kind, kw):
    p, n, target = 3, 30, 1e-6
    r0 = np.random.default_rng(0).random(n)
    ex = executor(kind, p, n, target, max_rounds=100_000, **kw)
    res, r = run_executor(kind, ex, AbsorbDrain(n, p), r0)
    assert res.stopped and not res.capped
    assert res.exchanges > 0 and res.bytes_moved > 0
    assert (res.rounds_per_shard >= 1).all() and res.stop_round >= 1
    assert float(np.abs(r).sum()) <= 2.0 * target
    assert res.recoveries == 0 and res.observed is None
    assert own_segments() == []


@pytest.mark.parametrize("kind", ["threads", "procpool"])
@pytest.mark.parametrize("cap", ["rounds", "pushes"])
def test_executor_caps_report_capped_and_conserve(kind, cap):
    p, n = 2, 10
    kw = (dict(max_rounds=50) if cap == "rounds"
          else dict(max_rounds=100_000, max_total_pushes=40))
    ex = executor(kind, p, n, 1e-12, **kw)
    res, r = run_executor(kind, ex, NeverConverges(), np.ones(n))
    assert res.capped and not res.stopped
    assert float(np.abs(r).sum()) == pytest.approx(n)
    if cap == "rounds":
        assert res.rounds_per_shard.max() <= 50
    else:
        assert res.pushes_per_shard.sum() > 40
    assert own_segments() == []


@pytest.mark.parametrize("kind", ["threads", "procpool"])
def test_crashing_worker_raises_and_releases(kind):
    ex = executor(kind, 2, 12, 1e-12, max_rounds=10_000)
    err = ValueError if kind == "threads" else RuntimeError
    with pytest.raises(err, match="synthetic|worker"):
        run_executor(kind, ex, Crasher(), np.ones(12))
    assert own_segments() == []


@pytest.mark.parametrize("kind", ["threads", "procpool"])
def test_killed_worker_restarts_and_certifies(kind):
    """A FaultPlan kill at round 3 (the procpool worker SIGKILLs its own
    process): the supervisor restarts it, the run stops with the residual
    under its target, and no segment is left behind."""
    p, n, target = 2, 40, 1e-9
    ex = executor(kind, p, n, target, max_rounds=1_000_000,
                  faults=T.FaultPlan(kill={0: 3}))
    res, r = run_executor(kind, ex, AbsorbDrain(n, p), np.ones(n))
    assert res.recoveries >= 1 and res.stopped
    assert float(np.abs(r).sum()) <= 2 * target
    assert own_segments() == []


@pytest.mark.parametrize("kind", ["threads", "procpool"])
def test_restart_budget_exhaustion_raises(kind):
    ex = executor(kind, 2, 40, 1e-12, max_rounds=1_000_000,
                  faults=T.FaultPlan(kill={1: 2}), max_restarts=0)
    with pytest.raises(RuntimeError, match="budget"):
        run_executor(kind, ex, AbsorbDrain(40, 2), np.ones(40))
    assert own_segments() == []


@pytest.mark.parametrize("kind", ["threads", "procpool"])
def test_observed_run_traces_every_shard(kind):
    """observe on: every shard's stream ends in one STOP, the counters
    reconcile with the transcript, the payload renders."""
    p, n = 3, 30
    if kind == "threads":
        obs = T.ShardObserver.alloc(p)
        ex = executor(kind, p, n, 1e-6, max_rounds=100_000, observe=obs)
    else:
        ex = executor(kind, p, n, 1e-6, max_rounds=100_000, observe=True)
    r0 = np.random.default_rng(1).random(n)
    res, _ = run_executor(kind, ex, AbsorbDrain(n, p), r0)
    ob = res.observed
    stops = ob["counters"]["stops"]
    assert res.stopped and stops == [1.0] * p
    assert sum(ob["counters"]["exchanges"]) == res.exchanges
    last = {}
    for ev in ob["events"]:
        last[ev["shard"]] = ev["name"]
    assert set(last.values()) == {"STOP"}
    assert T.chrome_trace(ob["events"], p=p)["traceEvents"]


def test_oversubscription_guard_and_pool_size():
    part = t_block_rows(10, 2)
    cores = os.cpu_count() or 1
    with pytest.warns(RuntimeWarning, match="oversubscribes"):
        ex = T.ProcPoolShardExecutor(part, T.AllToAllPlan(2),
                                     T.TerminationDriver(2), l1_target=1e-6,
                                     n_workers=cores + 7)
    assert ex.n_workers <= 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ex2 = T.ProcPoolShardExecutor(part, T.AllToAllPlan(2),
                                      T.TerminationDriver(2),
                                      l1_target=1e-6)
    assert ex2.n_workers == min(2, cores)
    assert T.default_pool_size(64) == J.default_pool_size(64)


def test_executor_rejects_p_disagreement():
    part = t_block_rows(10, 2)
    for cls in (T.AsyncShardExecutor, T.ProcPoolShardExecutor):
        with pytest.raises(ValueError, match="disagree"):
            cls(part, T.SparsifiedPlan(3, thresh=0.1),
                T.TerminationDriver(2), l1_target=1e-6)
    with pytest.raises(ValueError, match="livelock"):
        T.WorkerConfig(l1_target=1e-6, drain_frac=0.5, hysteresis=2.0)


def test_absorb_drain_is_the_reference_drain():
    """The synthetic drain (nothing shipped) moves mass the same way on
    both packages' threads transport when one worker runs alone (p = 1:
    no peers, so the schedule is deterministic): the same STOP, rounds,
    pushes, and bits."""
    n = 16
    outs = []
    for mod, br in ((J, j_block_rows), (T, t_block_rows)):
        r = np.linspace(0.1, 1.0, n)
        ex = mod.AsyncShardExecutor(br(n, 1), mod.AllToAllPlan(1),
                                    mod.TerminationDriver(1),
                                    l1_target=1e-8, max_rounds=10_000)
        res = within(ex.run, absorb(r, [(0, n)], ship=0.0), r)
        assert res.stopped
        outs.append((res.rounds_per_shard.tolist(),
                     res.pushes_per_shard.tolist(), r.tobytes()))
    assert outs[0] == outs[1]
