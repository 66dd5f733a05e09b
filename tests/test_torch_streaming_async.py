"""repro_torch's asynchronous sharded streaming updater
(`update_ranks_sharded(mode="async")` on the "threads" and "procpool"
transports, with faults and the observer) and the rank server on it,
against the JAX package, on the CPU.

The asynchronous schedules differ from run to run, so these tests hold
results, not transcripts: every update certifies at `cert <= tol` (the
exact host float64 recompute), and the final ranks lie within 2 tol in L1
of the JAX package's cold float64 solve of the same mutated graph (conftest's
2,000-page graph, a short crawl with node arrivals, then deletions). The
argument checks, and the superstep loop under an inactive FaultPlan, equal
the JAX package's exactly. Every run goes through `within`, a wall-clock
deadline, and leaves no shared-memory segment behind.
"""
import json

import numpy as np
import pytest

import repro.runtime as JR
import repro.streaming as J
import repro_torch.runtime as TR
import repro_torch.streaming as T
from repro.graph.google import exact_pagerank as j_exact
from repro.streaming.incremental import _exact_residual as j_exact_residual
from repro_torch.interop import (csr_graph_from_arrays,
                                 edge_delta_from_arrays,
                                 rank_state_from_arrays)

from _torch_async_drains import own_segments, within
from _torch_parity import (delta_arrays, graph_arrays, ref_x64,  # noqa: F401
                           state_arrays)


# the JAX package's at-fork hook warns whenever this process forks; the
# port's procpool workers run numpy only and never enter JAX
pytestmark = pytest.mark.filterwarnings(
    r"ignore:os\.fork\(\) was called:RuntimeWarning")

CPU = "cpu"
TOL = 1e-7


def t_delta(d):
    return edge_delta_from_arrays(delta_arrays(d))


def t_state(s):
    return rank_state_from_arrays(state_arrays(s))


def t_graph(g):
    return T.DeltaGraph(csr_graph_from_arrays(graph_arrays(g)))


def j_copy(s):
    return J.RankState(x=s.x.copy(), r=s.r.copy(), version=s.version,
                       alpha=s.alpha, v=s.v)


@pytest.fixture(scope="module")
def stream(small_graph):
    """The JAX package's cold state of the 2,000-page graph, a delta
    sequence (two crawl batches with node arrivals, then part of the
    largest out-row deleted), and the JAX package's cold float64 solve of
    the graph they leave."""
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda: jax.enable_x64(True), raising=False)
        jd = J.DeltaGraph(small_graph)
        cold = J.cold_state(jd, tol=1e-10)
        deltas = J.synth_edge_trace(jd, n_batches=2, batch_edges=4,
                                    seed=81, p_new_node=0.5)
        assert any(d.new_nodes for d in deltas)
        for d in deltas:
            jd.apply(d)
        u = int(np.argmax(jd.out_degree))
        row = jd.out_neighbors(u)[:6]
        dels = J.EdgeDelta.deletes(np.full(row.size, u), row)
        jd.apply(dels)
        deltas.append(dels)
        ref = J.cold_state(jd, tol=1e-11)
    assert ref.cert <= 1e-11
    return cold, deltas, ref.x


@pytest.mark.parametrize("exchange", ["allgather", "sparsified"])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("transport", ["threads", "procpool"])
def test_async_stream_certifies_against_reference(small_graph, stream,
                                                  transport, p, exchange):
    cold, deltas, x_ref = stream
    td, ts = t_graph(small_graph), t_state(cold)
    paths = []
    for d in deltas:
        ts, s = within(T.update_ranks_sharded, td, t_delta(d), ts, p=p,
                       tol=TOL, mode="async", transport=transport,
                       exchange=exchange, n_workers=min(p, 2), device=CPU)
        assert (s.mode, s.transport, s.p) == ("async", transport, p)
        assert s.cert <= TOL and ts.cert <= TOL
        assert ts.version == td.version and ts.x.shape == (td.n,)
        paths.append(s.path)
    assert "sharded_push" in paths
    assert float(np.abs(ts.x - x_ref).sum()) <= 2 * TOL
    # the maintained residual is the exact one after the last update
    r_inc = ts.r.copy()
    T.refresh_residual(td, ts)
    assert float(np.abs(r_inc - ts.r).max()) < 1e-12
    assert own_segments() == []


# the five plans of tests/test_faults.py's recovery tests, with the
# transport each runs on and whether it must record a recovery
FAULT_CASES = {
    "threads-kill": ("threads", dict(seed=1, kill={0: 4, 2: 9}), True),
    "threads-drop_dup_delay": ("threads", dict(
        seed=2, drop_rate=0.15, dup_rate=0.10, delay_rate=0.10,
        max_delay_rounds=4), False),
    "threads-hang_slow": ("threads", dict(seed=3, hang={1: (3, 0.05)},
                                          slow={0: 5e5}), None),
    "procpool-kill": ("procpool", dict(seed=4, kill={1: 5}), True),
    "procpool-drop_dup": ("procpool", dict(seed=5, drop_rate=0.10,
                                           dup_rate=0.10), False),
}


@pytest.fixture(scope="module")
def fault_graph():
    """tests/test_faults.py's recovery workload: a 1,500-page graph, its
    cold state, ten inserted links, and the float64 oracle after them."""
    from repro.graph.generate import powerlaw_webgraph
    g = powerlaw_webgraph(n=1500, target_nnz=11000, n_dangling=8, seed=17)
    rng = np.random.default_rng(18)
    d = J.EdgeDelta.inserts(rng.integers(0, 1500, 10),
                            rng.integers(0, 1500, 10))
    jd = J.DeltaGraph(g)
    jd.apply(d)
    return g, d, j_exact(jd.operator(0.85), tol=1e-14)


@pytest.mark.parametrize("name", sorted(FAULT_CASES))
def test_fault_plans_certify(fault_graph, name):
    transport, kw, recovers = FAULT_CASES[name]
    g, d, x_ref = fault_graph
    tol = 1e-7
    td = t_graph(g)
    st = T.cold_state(td, tol=1e-9, device=CPU)
    st, s = within(T.update_ranks_sharded, td, t_delta(d), st, p=3, tol=tol,
                   mode="async", transport=transport,
                   faults=TR.FaultPlan(**kw), device=CPU)
    assert s.cert <= tol, s
    r_exact = _t_exact_residual(td, st)
    assert float(np.abs(r_exact).sum()) / (1.0 - st.alpha) <= tol * 1.01
    assert float(np.abs(st.x - x_ref).sum()) <= 2 * tol
    if recovers is True:
        assert s.recoveries >= 1 and s.recovery_s >= 0.0
    elif recovers is False:
        assert s.recoveries == 0
    assert own_segments() == []


def _t_exact_residual(td, st):
    from repro_torch.streaming.incremental import _exact_residual
    return _exact_residual(td, st.x, st.alpha, st.v)


@pytest.mark.parametrize("transport", ["threads", "procpool"])
def test_observe_payload_decomposes_pushes(small_graph, stream, transport,
                                           tmp_path):
    """observe=True: first + local + boundary re-pushes add up to the
    pushes (a fault-free run), every shard's stream ends in STOP, and the
    event stream exports as a Chrome trace that loads back."""
    cold = stream[0]
    td, ts = t_graph(small_graph), t_state(cold)
    rng = np.random.default_rng(84)
    d = T.EdgeDelta.inserts(rng.integers(0, 2000, 10),
                            rng.integers(0, 2000, 10))
    ts, s = within(T.update_ranks_sharded, td, d, ts, p=4, tol=TOL,
                   mode="async", transport=transport, observe=True,
                   n_workers=2, device=CPU)
    assert s.path == "sharded_push" and s.cert <= TOL
    assert s.pushes_first + s.pushes_local + s.pushes_boundary == s.pushes
    assert s.pushes_first > 0
    ob = s.observed
    assert ob["counters"]["stops"] == [1.0] * 4
    assert sum(ob["attribution"]["per_shard"][i][0] for i in range(4)) > 0
    names = {ev["name"] for ev in ob["events"]}
    assert {"DRAIN", "STOP"} <= names
    TR.write_chrome_trace(tmp_path / "trace.json", ob["events"], p=4)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert len(trace["traceEvents"]) >= len(ob["events"])
    assert own_segments() == []


@pytest.mark.parametrize("transport", ["threads", "procpool"])
def test_rank_server_async_certifies(transport):
    """RankServer(updater="sharded", shard_mode="async") on either host
    transport, inline and then threaded: every published snapshot within
    tol, the ranks within 2 tol of the oracle, health clean."""
    from repro.graph.generate import powerlaw_webgraph
    g = powerlaw_webgraph(n=1200, target_nnz=9000, n_dangling=6, seed=21)
    jd = J.DeltaGraph(g)
    srv = T.RankServer(t_graph(g), tol=1e-7, updater="sharded", shards=2,
                       shard_mode="async", shard_transport=transport,
                       device=CPU)
    rng = np.random.default_rng(3)
    for _ in range(4):
        d = J.EdgeDelta.inserts(rng.integers(0, 1200, 2),
                                rng.integers(0, 1200, 2))
        jd.apply(d)
        srv.ingest(t_delta(d))
    stats = within(srv.apply_pending)
    assert stats.transport == transport and stats.mode == "async"
    assert srv.snapshot().cert <= 1e-7
    srv.start(poll_s=0.001)
    try:
        for _ in range(3):
            d = J.EdgeDelta.inserts(rng.integers(0, 1200, 2),
                                    rng.integers(0, 1200, 2))
            jd.apply(d)
            srv.ingest(t_delta(d))
    finally:
        within(srv.stop, drain=True)
    h = srv.health()
    assert h["last_error"] is None and h["updater_restarts"] == 0
    snap = srv.snapshot()
    assert snap.version == srv.dg.version and snap.cert <= 1e-7
    x_ref = j_exact(jd.operator(0.85), tol=1e-14)
    assert float(np.abs(snap.x - x_ref).sum()) <= 2e-7
    ids, vals = srv.top_k(5)
    assert len(ids) == 5 and np.all(np.diff(vals) <= 0)
    assert own_segments() == []


def plans(mod):
    return dict(active=mod.FaultPlan(drop_rate=0.1),
                kill=mod.FaultPlan(kill={0: 1}))


BAD_ASYNC = [
    dict(mode="superstep", faults="active"),
    dict(faults="kill"),
    dict(mode="async", transport="device", faults="active"),
    dict(mode="async", transport="device", observe=True),
    dict(mode="superstep", transport="procpool"),
    dict(mode="superstep", observe=True),
    dict(mode="async", transport="rpc"),
    dict(mode="async", transport="procpool", exchange="ring"),
    dict(mode="async", transport="threads", method="newton"),
]


@pytest.mark.parametrize("kw", BAD_ASYNC, ids=[str(k) for k in BAD_ASYNC])
def test_async_argument_errors_match_reference(small_graph, stream, kw):
    """The same exception type and message, before the graph moves."""
    cold = stream[0]
    jd, td = J.DeltaGraph(small_graph), t_graph(small_graph)
    errs = []
    for fn, dg, st, mod, extra in (
            (J.update_ranks_sharded, jd, j_copy(cold), JR, {}),
            (T.update_ranks_sharded, td, t_state(cold), TR,
             dict(device=CPU))):
        args = dict(kw)
        if "faults" in args:
            args["faults"] = plans(mod)[args["faults"]]
        empty = (J if fn is J.update_ranks_sharded else T).EdgeDelta.empty()
        with pytest.raises(Exception) as exc:
            fn(dg, empty, st, **args, **extra)
        errs.append((type(exc.value), str(exc.value)))
    assert errs[0] == errs[1]
    assert jd.version == td.version == 0


@pytest.mark.parametrize("exchange", ["allgather", "sparsified"])
def test_inactive_fault_plan_runs_like_reference(small_graph, stream,
                                                 exchange):
    """An inactive FaultPlan injects nothing, so both packages take it in
    superstep mode (where an active plan raises) and run the same loop,
    bit for bit."""
    cold = stream[0]
    jd, td = J.DeltaGraph(small_graph), t_graph(small_graph)
    js, ts = j_copy(cold), t_state(cold)
    assert not JR.FaultPlan().active and not TR.FaultPlan().active
    rng = np.random.default_rng(83)
    for _ in range(2):
        d = J.EdgeDelta.inserts(rng.integers(0, 2000, 4),
                                rng.integers(0, 2000, 4))
        js, a = J.update_ranks_sharded(jd, d, js, p=3, tol=1e-7,
                                       exchange=exchange,
                                       faults=JR.FaultPlan(seed=9))
        ts, b = T.update_ranks_sharded(td, t_delta(d), ts, p=3, tol=1e-7,
                                       exchange=exchange,
                                       faults=TR.FaultPlan(seed=9),
                                       device=CPU)
        assert a.path == b.path == "sharded_push"
        for f in ("supersteps", "pushes", "exchanges", "bytes_moved",
                  "stop_superstep", "cert", "mode"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(js.x, ts.x)
        np.testing.assert_array_equal(js.r, ts.r)


def test_async_fallback_solves_on_device(small_graph, stream, ref_x64):
    """A push budget too small for the batch: the async drain caps and
    falls back to the warm-started float64 solve on `device` (here the
    CPU's plain path), which certifies; the JAX package falls back too."""
    cold, deltas, _ = stream
    d = J.synth_edge_trace(J.DeltaGraph(small_graph), n_batches=1,
                           batch_edges=30, seed=62, p_new_node=0.0)[0]
    jd, td = J.DeltaGraph(small_graph), t_graph(small_graph)
    _, a = J.update_ranks_sharded(jd, d, j_copy(cold), p=2, tol=TOL,
                                  mode="async", max_push_factor=0.05)
    ts, b = within(T.update_ranks_sharded, td, t_delta(d), t_state(cold),
                   p=2, tol=TOL, mode="async", max_push_factor=0.05,
                   device=CPU)
    assert a.path == b.path == "solve_linear"
    assert b.cert <= TOL and b.solver_iters > 0 and b.mode == "async"
    r = j_exact_residual(jd, ts.x, 0.85, None)
    assert float(np.abs(r).sum()) / 0.15 <= TOL
