"""repro_torch's query tier (serving/ppr_cache.py, router.py, batcher.py,
`attach_query_tier`) against the JAX package's, on the CPU.

The cache and the router are host code copied from the JAX package, so the
same inputs give the same decisions: one stream of solved entries and
delta receipts into both packages' `PPRCache` yields the same hits,
misses, evictions, flushes, survivals and certified bounds, bit for bit;
the same publishes and reads through both packages' `QueryRouter` yield
the same admissions, redirects and rejections. The batcher's fused lane
answers (the port's `ppr_push_batched` on `device="cpu"`: the host scipy
path for backend "auto", the plain versions of the device lanes for
"segment_sum" and "bsr") lie within tol of the JAX package's `ppr_push` on
the same graph; an error in a batch reaches every caller of it; and the
whole tier runs end to end on a rank server. Every wait runs under
`within`, a wall-clock deadline.
"""
import threading
import types

import numpy as np
import pytest

import repro.serving as JS
import repro.streaming as J
import repro_torch.serving as TS
import repro_torch.streaming as T
from repro_torch.interop import csr_graph_from_arrays, edge_delta_from_arrays

from _torch_async_drains import within
from _torch_parity import delta_arrays, graph_arrays


# the JAX package's at-fork hook warns whenever this process forks; the
# port's procpool workers run numpy only and never enter JAX
pytestmark = pytest.mark.filterwarnings(
    r"ignore:os\.fork\(\) was called:RuntimeWarning")

CPU = "cpu"
ALPHA = 0.85


def t_graph(g):
    return T.DeltaGraph(csr_graph_from_arrays(graph_arrays(g)))


def t_delta(d):
    return edge_delta_from_arrays(delta_arrays(d))


def snap_of(dg):
    """The fields of a RankSnapshot the cache reads, at the graph's
    current version."""
    return types.SimpleNamespace(n=dg.n, version=dg.version,
                                 op=dg.operator(ALPHA), pt_sp=dg.scipy_pt())


# ---------------------------------------------------------------------------
# PPRCache: the same receipts, the same decisions
# ---------------------------------------------------------------------------
def cache_script(small_graph, tols):
    """One event stream for both caches: puts of entries solved by the
    JAX package's push (at the version they are put at), delta receipts
    (links near cached mass, a node arrival that changes n, a cached node
    turning dangling and back), lookups of every entry after each delta,
    and a version gap."""
    jd = J.DeltaGraph(small_graph)
    rng = np.random.default_rng(41)
    sets = [rng.choice(2000, size=int(rng.integers(1, 4)), replace=False)
            for _ in range(6)]

    def puts(idx):
        return [("put", k, J.ppr_push(jd, sets[k], alpha=ALPHA,
                                      tol=1e-6)[0], tols[k]) for k in idx]

    def delta(d):
        jd.apply(d)
        return [("delta", d), ("get",)]

    ev = puts(range(6))
    ev += delta(J.EdgeDelta.inserts(rng.integers(0, 2000, 3),
                                    rng.integers(0, 2000, 3)))
    ev += delta(J.EdgeDelta.inserts([int(sets[1][0])], [int(sets[2][0])]))
    ev += puts([5, 0])
    ev += delta(J.EdgeDelta.empty(new_nodes=1))          # n changes
    ev += puts([1, 2, 3])
    hub = int(sets[3][0])
    row = jd.out_neighbors(hub)
    ev += delta(J.EdgeDelta.deletes(np.full(row.size, hub), row))
    ev += puts([4])
    ev += delta(J.EdgeDelta.inserts(np.full(row.size, hub), row))
    ev += delta(J.EdgeDelta.inserts(rng.integers(0, 2000, 40),
                                    rng.integers(0, 2000, 40)))
    ev += puts([0, 1])
    ev.append(("gap",))
    return sets, ev


def drive_cache(cache_mod, dg, sets, events, to_delta):
    cache = cache_mod.PPRCache(alpha=ALPHA, capacity=4)
    log = []
    for e in events:
        if e[0] == "put":
            _, k, x, tol = e
            log.append(("put", k, cache.put(snap_of(dg), sets[k], None,
                                            tol, x, cert=0.0)))
        elif e[0] == "delta":
            dg.apply(to_delta(e[1]))
            cache.note_update(dg._last_receipt)
        elif e[0] == "get":
            snap = snap_of(dg)
            for k, s in enumerate(sets):
                hit = cache.get(snap, s, None, 1e-2)
                log.append(("get", k, None if hit is None else (
                    hit[0].tobytes(), hit[1], hit[2].path, hit[2].cert,
                    hit[2].solved_version, hit[2].served_version)))
            log.append(("entries", [(key, en.bound, en.tol,
                                     en.solved_version, en.r.tobytes())
                                    for key, en in cache._entries.items()]))
        else:      # a version the cache never saw flushes everything
            cache.note_update(types.SimpleNamespace(
                version=dg.version + 5, n_old=dg.n, n_new=dg.n))
        log.append(("stats", cache.stats()))
    return log


@pytest.mark.parametrize("tols", [(1e-2,) * 6,
                                  (1e-5, 1e-3, 2e-3, 1e-2, 5e-3, 1e-6)],
                         ids=["uniform", "mixed"])
def test_ppr_cache_decisions_match_reference(small_graph, tols):
    sets, events = cache_script(small_graph, tols)
    a = drive_cache(JS, J.DeltaGraph(small_graph), sets, events,
                    lambda d: d)
    b = drive_cache(TS, t_graph(small_graph), sets, events, t_delta)
    assert a == b
    final = a[-1][1]
    assert final["hits"] > 0 and final["survivals"] > 0
    assert final["flushes"] >= 2 and final["evictions"] > 0


# ---------------------------------------------------------------------------
# QueryRouter: the same publishes, the same routing
# ---------------------------------------------------------------------------
class _Server:
    """What a router reads of a RankServer: the graph version and the
    publish fan-out."""

    def __init__(self):
        self.dg = types.SimpleNamespace(version=0)
        self.alpha = ALPHA
        self.subs = []
        self.snap = None

    def subscribe(self, cb):
        self.subs.append(cb)
        if self.snap is not None:
            cb(self.snap)

    def publish(self, snap):
        self.snap = snap
        for cb in self.subs:
            cb(snap)


def stub_snap(version, seq, cert, age_s):
    x = np.linspace(1.0, 0.0, 16) + version
    return types.SimpleNamespace(
        version=version, seq=seq, cert=cert, published_at=age_s,
        top_k=lambda k, x=x: (np.arange(k), x[:k]),
        scores=lambda ids, x=x: x[np.asarray(ids)])


def drive_router(serving, kw, script):
    srv = _Server()
    srv.publish(stub_snap(0, 1, 1e-9, 1e18))
    router = serving.QueryRouter(srv, 3, **kw)
    log = []
    for op, arg in script:
        if op == "publish":
            srv.publish(stub_snap(*arg))
        elif op == "bump":
            srv.dg.version += arg
        elif op == "pause":
            router.replicas[arg].pause()
        elif op == "resume":
            router.replicas[arg].resume()
        else:
            try:
                ids, vals = router.top_k(4) if op == "top_k" \
                    else (None, router.scores([1, 3]))
                log.append((op, vals.tolist()))
            except serving.StalenessBoundExceeded as exc:
                log.append((op, "stale", str(exc)))
    log.append(router.stats())
    return log


ROUTER_SCRIPT = [
    ("top_k", None), ("top_k", None), ("scores", None),
    ("pause", 1), ("bump", 1), ("top_k", None),
    ("publish", (1, 2, 1e-9, 1e18)), ("top_k", None), ("top_k", None),
    ("scores", None), ("bump", 1), ("publish", (2, 3, 5e-6, 1e18)),
    ("top_k", None), ("top_k", None), ("pause", 0), ("pause", 2),
    ("bump", 2), ("top_k", None), ("resume", 0),
    ("publish", (4, 4, 1e-9, 1e18)), ("top_k", None), ("scores", None),
    ("top_k", None), ("publish", (4, 5, 1e-9, 0.0)), ("top_k", None),
]


@pytest.mark.parametrize("kw", [
    dict(max_version_lag=0), dict(max_version_lag=1),
    dict(max_version_lag=0, on_stale="reject"),
    dict(max_version_lag=2, max_cert=1e-6),
    dict(max_version_lag=1, max_age_s=60.0)],
    ids=["lag0", "lag1", "reject", "cert", "age"])
def test_query_router_decisions_match_reference(kw):
    a = drive_router(JS, kw, ROUTER_SCRIPT)
    b = drive_router(TS, kw, ROUTER_SCRIPT)
    assert a == b
    st = a[-1]
    assert st["routed"] == 14 and st["rejects"] > 0
    assert st["redirects"] > 0 or kw.get("on_stale") == "reject"


def test_query_router_rejects_bad_arguments_like_reference():
    for kw in (dict(replicas=0), dict(replicas=2, on_stale="ignore")):
        msgs = []
        for serving in (JS, TS):
            with pytest.raises(ValueError) as exc:
                serving.QueryRouter(_Server(), **kw)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------
def concurrent(fn, args_list):
    """Call fn(*args) from one thread each, all released together;
    returns the results (or exceptions) in order."""
    out = [None] * len(args_list)
    gate = threading.Barrier(len(args_list))

    def run(k):
        gate.wait()
        try:
            out[k] = fn(*args_list[k])
        except BaseException as exc:
            out[k] = exc
    ts = [threading.Thread(target=run, args=(k,), daemon=True)
          for k in range(len(args_list))]
    for t in ts:
        t.start()
    for t in ts:
        within(t.join)
    return out


@pytest.fixture(scope="module")
def served(small_graph):
    """A port rank server on the CPU and the JAX package's graph beside
    it (the server's cold solve runs the CPU's plain path)."""
    srv = T.RankServer(t_graph(small_graph), alpha=ALPHA, tol=1e-6,
                       device=CPU)
    return srv, J.DeltaGraph(small_graph)


@pytest.mark.parametrize("backend", ["auto", "segment_sum", "bsr"])
def test_batcher_fused_answers_match_reference_push(served, backend):
    """Eight concurrent queries fuse into lane solves whose answers lie
    within tol (L1) of the JAX package's push on the same graph, each
    certified at its own tol."""
    srv, jd = served
    tol = 1e-4
    b = TS.QueryBatcher(srv, max_batch=8, max_delay_s=0.5, backend=backend,
                        device=CPU).attach()
    try:
        rng = np.random.default_rng(51)
        sets = [rng.choice(2000, size=int(rng.integers(1, 4)),
                           replace=False) for _ in range(8)]
        res = concurrent(lambda s: b.submit(s, None, tol),
                         [(s,) for s in sets])
    finally:
        within(b.stop)
    st = b.stats()
    assert st["queries"] == 8 and st["batches"] < 8 and st["fused_lanes"] > 0
    for s, r in zip(sets, res):
        assert not isinstance(r, BaseException), r
        x, cert, stats, snap = r
        assert cert <= tol and snap.version == 0
        xj, cj, _ = J.ppr_push(jd, s, alpha=ALPHA, tol=tol / 10)
        assert float(np.abs(x - xj).sum()) <= tol
    assert srv._ppr_batcher is None


def test_batcher_error_reaches_every_caller(served, monkeypatch):
    srv, _ = served
    import repro_torch.serving.batcher as bmod

    def boom(*a, **k):
        raise RuntimeError("lane solve failed")
    monkeypatch.setattr(bmod, "ppr_push_batched", boom)
    b = TS.QueryBatcher(srv, max_batch=4, max_delay_s=0.5,
                        device=CPU).attach()
    try:
        res = concurrent(lambda s: b.submit(s, None, 1e-3),
                         [([k + 1],) for k in range(4)])
    finally:
        within(b.stop)
    assert all(isinstance(r, RuntimeError) and "lane solve failed"
               in str(r) for r in res), res
    with pytest.raises(RuntimeError, match="not running"):
        b.submit([1], None, 1e-3)
    with pytest.raises(ValueError):
        TS.QueryBatcher(srv, max_batch=0, device=CPU)


# ---------------------------------------------------------------------------
# the whole tier
# ---------------------------------------------------------------------------
def test_attach_query_tier_end_to_end(small_graph):
    """attach_query_tier on a sharded asynchronous server (worker
    threads): a personalized answer, its repeat from the cache, the
    router's staleness-bounded top-k, a certified update whose receipt
    the cache advances across, and a clean stop."""
    srv = T.RankServer(t_graph(small_graph), alpha=ALPHA, tol=1e-6,
                       updater="sharded", shards=2, shard_mode="async",
                       device=CPU)
    batcher, cache, router = TS.attach_query_tier(
        srv, max_batch=8, max_delay_s=0.005, cache_capacity=8,
        replicas=2, max_version_lag=1, device=CPU)
    try:
        assert srv._ppr_batcher is batcher and srv._ppr_cache is cache
        x1, c1, _ = within(srv.personalized, [10, 20], tol=1e-3)
        assert c1 <= 1e-3
        x2, c2, s2 = within(srv.personalized, [10, 20], tol=1e-3)
        assert getattr(s2, "path", None) == "cache" and c2 <= 1e-3
        np.testing.assert_array_equal(x1, x2)
        ids, scores = router.top_k(5)
        assert ids.size == 5 and np.all(np.diff(scores) <= 0)
        srv.ingest(T.EdgeDelta.inserts([1, 2], [3, 4]))
        stats = within(srv.apply_pending)
        assert stats.path == "sharded_push" and srv.snapshot().cert <= 1e-6
        assert cache.stats()["version"] == srv.snapshot().version == 1
        _, c3, _ = within(srv.personalized, [10, 20], tol=1e-3)
        assert c3 <= 1e-3
        router.top_k(3)
        assert router.stats()["rejects"] == 0
        assert [r["version"] for r in router.stats()["replicas"]] == [1, 1]
        assert srv.health()["status"] == "ok"
    finally:
        within(batcher.stop)
    assert srv._ppr_batcher is None
