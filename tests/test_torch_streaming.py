"""Parity of repro_torch's streaming package (`streaming/{delta,
incremental,server,scenario}.py`) with the JAX package's, on the CPU.

Both packages run in this process on the same base graph and the same
deltas: the port's are carried across as numpy arrays by `interop.
csr_graph_from_arrays`, `edge_delta_from_arrays` and
`rank_state_from_arrays`, and the port runs on `device="cpu"` (its
kernels' plain versions). The JAX package's float64 solves need
`jax.experimental.enable_x64`, which `_torch_parity.ref_x64` supplies.

Tolerances, and why:
  * DeltaGraph (receipts, degrees, dangling mask, graph snapshots, the
    spliced and the rebuilt P^T), the push path of `update_ranks`,
    `ppr_push`, `ppr_push_batched` on "scipy" and `synth_edge_trace`:
    equal, bit for bit — this code is the JAX package's numpy, copied;
  * `cold_state` and every fallback solve (float64 segment sum): the same
    path and solver iterations, x within L1 1e-12 (the port's solver sums
    in another order than XLA's); the replay's records, equal;
  * `ppr_push_batched` on "segment_sum": equal lane iterations, each lane
    within L1 1e-10;
  * the float32 block backend ("bsr", the JAX package's "bsr_pallas"):
    every certificate <= its tol on both sides, at tol >= 1e-4 (its
    residual floors near 1e-7);
  * the DES bridge (`StreamingBlockOperator`): a block update within rtol
    1e-12 of the JAX package's scipy one, and a DES run over it with equal
    counts and x within L1 1e-12.
"""
import dataclasses
import gc
import threading
import time
import weakref

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.streaming as J
import repro_torch.streaming as T
from repro.core import AsyncDES as JAsyncDES
from repro.core import DESConfig as JDESConfig
from repro.core.partition import block_rows as j_block_rows
from repro.graph.csr import TransitionT as JTransitionT
from repro.graph.generate import powerlaw_webgraph as j_powerlaw
from repro.graph.google import exact_pagerank as j_exact
from repro.streaming.incremental import _view_arrays as j_view_arrays
from repro_torch.core import AsyncDES as TAsyncDES
from repro_torch.core import DESConfig as TDESConfig
from repro_torch.core.partition import block_rows as t_block_rows
from repro_torch.graph.csr import TransitionT as TTransitionT
from repro_torch.interop import (csr_graph_from_arrays,
                                 edge_delta_from_arrays,
                                 rank_state_from_arrays)
from repro_torch.streaming.incremental import _view_arrays as t_view_arrays

from _torch_parity import (delta_arrays, graph_arrays, ref_x64,  # noqa: F401
                           state_arrays)

CPU = "cpu"


def t_graph(g):
    return csr_graph_from_arrays(graph_arrays(g))


def t_delta(d):
    return edge_delta_from_arrays(delta_arrays(d))


def t_state(s):
    return rank_state_from_arrays(state_arrays(s))


def j_copy(s):
    return J.RankState(x=s.x.copy(), r=s.r.copy(), version=s.version,
                       alpha=s.alpha, v=s.v)


def pair(g, **kw):
    """The JAX package's DeltaGraph over `g` and the port's over the same
    arrays."""
    return J.DeltaGraph(g, **kw), T.DeltaGraph(t_graph(g), **kw)


@pytest.fixture(scope="module")
def ref_cold(small_graph):
    """The JAX package's certified cold state on conftest's 2,000-page
    graph (tol 1e-9): both packages start their streams from its bits."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda: jax.enable_x64(True), raising=False)
        return J.cold_state(J.DeltaGraph(small_graph), tol=1e-9)


# ---------------------------------------------------------------------------
# DeltaGraph
# ---------------------------------------------------------------------------
def _same_csr(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype
    assert a.indices.dtype == b.indices.dtype


def _same_transition(a, b):
    assert a.n == b.n
    for f in ("indptr", "src", "weight", "row_ids", "dangling"):
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(x, y, err_msg=f)
        assert x.dtype == y.dtype, f


def _same_receipt(a, b):
    for f in ("version", "n_old", "n_new", "n_added", "n_deleted",
              "dangling_changed"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("touched", "old_deg", "new_deg"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for ra, rb in zip(a.old_rows + a.new_rows, b.old_rows + b.new_rows):
        np.testing.assert_array_equal(ra, rb)


def _step_delta(jd, rng, step):
    """One JAX-package EdgeDelta against the live graph: random inserts,
    deletions of existing edges, a node arrival every fifth step, a whole
    out-row deleted every sixth (a dangling flip), and no-op mutations (an
    existing edge inserted, a missing one deleted) every seventh."""
    gg = jd.graph()
    nn = int(step % 5 == 2)
    k = int(rng.integers(1, 12))
    soe = np.repeat(np.arange(gg.n, dtype=np.int64), np.diff(gg.indptr))
    slots = rng.choice(gg.nnz, size=max(k // 2, 1), replace=False)
    d_s, d_d = soe[slots], gg.indices[slots].astype(np.int64)
    a_s = rng.integers(0, jd.n + nn, k)
    a_d = rng.integers(0, jd.n + nn, k)
    if step % 6 == 3:
        live = np.flatnonzero(jd.out_degree > 0)
        u = int(live[rng.integers(live.size)])
        row = jd.out_neighbors(u)
        d_s = np.concatenate([d_s, np.full(row.size, u)])
        d_d = np.concatenate([d_d, row])
    if step % 7 == 5:
        u = int(soe[slots[0]])
        a_s = np.concatenate([a_s, [u]])
        a_d = np.concatenate([a_d, [int(gg.indices[slots[0]])]])
        d_s = d_s[1:]
        d_d = d_d[1:]
        missing = [(s, t) for s, t in zip(rng.integers(0, jd.n, 8),
                                          rng.integers(0, jd.n, 8))
                   if not jd.has_edge(int(s), int(t))]
        if missing:
            d_s = np.concatenate([d_s, [missing[0][0]]])
            d_d = np.concatenate([d_d, [missing[0][1]]])
    return J.EdgeDelta(add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d,
                       new_nodes=nn)


@pytest.mark.parametrize("compact_frac", [0.02, 0.25])
def test_delta_graph_matches_reference(compact_frac):
    """After every delta: the receipt, the log, degrees, the dangling mask,
    the graph snapshot, the spliced P^T and the rebuilt one, bit for bit;
    the port's splice equals its rebuild; frozen views and the dirty-row
    CSR the pushes gather from are the reference's."""
    g = j_powerlaw(n=300, target_nnz=2400, n_dangling=4, seed=1)
    jd, td = pair(g, compact_frac=compact_frac)
    rng = np.random.default_rng(2)
    spliced = 0
    for step in range(24):
        jd.transition()             # memoize v-1 so the splice path runs
        pt_prev = td.transition()
        d = _step_delta(jd, rng, step)
        _same_receipt(jd.apply(d), td.apply(t_delta(d)))
        assert (jd.n, jd.nnz, jd.version, jd._log_edges) == (
            td.n, td.nnz, td.version, td._log_edges)
        np.testing.assert_array_equal(jd.out_degree, td.out_degree)
        np.testing.assert_array_equal(jd.dangling_mask, td.dangling_mask)
        _same_csr(jd.graph(), td.graph())
        pt = td.transition()
        spliced += pt is not pt_prev
        _same_transition(jd.transition(), pt)
        _same_transition(JTransitionT.from_graph(jd.graph()),
                         TTransitionT.from_graph(td.graph()))
        _same_transition(pt, TTransitionT.from_graph(td.graph()))
        jv, tv = jd.freeze(), td.freeze()
        for a, b in zip(j_view_arrays(jv), t_view_arrays(tv)):
            np.testing.assert_array_equal(a, b)
        for u in rng.integers(0, jd.n, 5):
            np.testing.assert_array_equal(jv.out_neighbors(int(u)),
                                          tv.out_neighbors(int(u)))
            assert jd.has_edge(int(u), 7) == td.has_edge(int(u), 7)
    assert spliced > 0
    for bad in (J.EdgeDelta.inserts([jd.n + 5], [0]),):
        with pytest.raises(ValueError):
            jd.apply(bad)
        with pytest.raises(ValueError):
            td.apply(t_delta(bad))


def test_merge_deltas_matches_reference():
    rng = np.random.default_rng(3)
    batch = []
    for i in range(6):
        k = int(rng.integers(0, 6))
        batch.append(J.EdgeDelta(
            add_src=rng.integers(0, 9, k), add_dst=rng.integers(0, 9, k),
            del_src=rng.integers(0, 9, 3), del_dst=rng.integers(0, 9, 3),
            new_nodes=i % 2))
    for sub in (batch, batch[:1], [], batch[::-1]):
        a = J.merge_deltas(sub)
        b = T.merge_deltas([t_delta(d) for d in sub])
        for f, x in delta_arrays(a).items():
            np.testing.assert_array_equal(x, getattr(b, f), err_msg=f)


def test_views_memoized_and_dropped_with_their_tensors():
    """Operator views are memoized per version; `_gc_views` drops a version
    two behind, and its transition's device tensors go with it."""
    g = j_powerlaw(n=300, target_nnz=2400, n_dangling=4, seed=19)
    _, td = pair(g)
    op0 = td.operator(0.85)
    assert td.operator(0.85) is op0 and td.transition() is op0.pt
    v = np.full(td.n, 1.0 / td.n)
    assert td.operator(0.85, v=v).pt is op0.pt
    weight = op0.pt.device_arrays(torch.float64, torch.device(CPU))["weight"]
    ref_pt, ref_w = weakref.ref(op0.pt), weakref.ref(weight)
    del op0, weight
    rng = np.random.default_rng(20)
    for step in range(3):
        td.apply(T.EdgeDelta.inserts(rng.integers(0, td.n, 3),
                                     rng.integers(0, td.n, 3)))
        assert td.operator(0.85) is td.operator(0.85)
    gc.collect()
    assert ref_pt() is None and ref_w() is None
    assert sorted(td._pt) == [1, 2, 3]      # keep=2: versions >= 3 - 2


# ---------------------------------------------------------------------------
# cold_state and update_ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["linear", "power"])
def test_cold_state_matches_reference(small_graph, ref_x64, method):
    jd, td = pair(small_graph)
    js = J.cold_state(jd, tol=1e-9, method=method)
    ts = T.cold_state(td, tol=1e-9, method=method, device=CPU)
    assert float(np.abs(js.x - ts.x).sum()) <= 1e-12
    assert js.cert <= 1e-9 and ts.cert <= 1e-9
    assert ts.version == js.version == 0 and ts.v is None


@pytest.mark.parametrize("schedule", [None, "priority", "randomized"])
def test_update_ranks_push_path_matches_reference(small_graph, ref_cold,
                                                  schedule):
    """A crawl stream (inserts, deletions, node arrivals) drained by pushes
    at tol 1e-5: every batch's path, counts, x and r are the reference's,
    bit for bit, under each drain schedule."""
    jd, td = pair(small_graph)
    js, ts = j_copy(ref_cold), t_state(ref_cold)
    trace = J.synth_edge_trace(jd, n_batches=8, batch_edges=3, seed=5,
                               p_new_node=0.3)
    assert any(d.new_nodes for d in trace)
    for d in trace:
        js, a = J.update_ranks(jd, d, js, tol=1e-5, push_frontier_frac=1.0,
                               schedule=schedule)
        ts, b = T.update_ranks(td, t_delta(d), ts, tol=1e-5,
                               push_frontier_frac=1.0, schedule=schedule,
                               device=CPU)
        assert a.path == b.path == "push"
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        np.testing.assert_array_equal(js.x, ts.x)
        np.testing.assert_array_equal(js.r, ts.r)
        assert ts.version == js.version and b.cert <= 1e-5


@pytest.mark.parametrize("method", ["linear", "power"])
def test_update_ranks_fallback_matches_reference(small_graph, ref_cold,
                                                 ref_x64, method):
    """Batches too global for the push cap fall back to the warm-started
    float64 solve: the same path, aborted-push counts and solver
    iterations, x within L1 1e-12, certificates within tol."""
    jd, td = pair(small_graph)
    js, ts = j_copy(ref_cold), t_state(ref_cold)
    trace = J.synth_edge_trace(jd, n_batches=3, batch_edges=4, seed=6,
                               p_new_node=0.0)
    for d in trace:
        js, a = J.update_ranks(jd, d, js, tol=1e-7, method=method)
        ts, b = T.update_ranks(td, t_delta(d), ts, tol=1e-7, method=method,
                               device=CPU)
        assert a.path == b.path == f"solve_{method}"
        for f in ("pushes", "nodes_visited", "frontier_peak",
                  "solver_iters"):
            assert getattr(a, f) == getattr(b, f), f
        assert float(np.abs(js.x - ts.x).sum()) <= 1e-12
        assert a.cert <= 1e-7 and b.cert <= 1e-7


def test_update_ranks_bsr_fallback_certifies(small_graph, ref_cold):
    """The float32 block backend's fallback (the JAX package's
    "bsr_pallas" as the port's alias): the same path, both certificates
    within tol 1e-4."""
    jd, td = pair(small_graph)
    js, ts = j_copy(ref_cold), t_state(ref_cold)
    for d in J.synth_edge_trace(jd, n_batches=2, batch_edges=20, seed=8,
                                p_new_node=0.0):
        js, a = J.update_ranks(jd, d, js, tol=1e-4, backend="bsr_pallas",
                               push_frontier_frac=0.05)
        ts, b = T.update_ranks(td, t_delta(d), ts, tol=1e-4,
                               backend="bsr_pallas", push_frontier_frac=0.05,
                               device=CPU)
        assert a.path == b.path == "solve_linear"
        assert a.cert <= 1e-4 and b.cert <= 1e-4
        assert float(np.abs(js.x - ts.x).sum()) <= 1e-4


def test_update_ranks_rejects_like_reference(small_graph, ref_cold):
    jd, td = pair(small_graph)
    js, ts = j_copy(ref_cold), t_state(ref_cold)
    js.version = ts.version = -1
    for fn, dg, st, kw in ((J.update_ranks, jd, js, {}),
                           (T.update_ranks, td, ts, dict(device=CPU))):
        with pytest.raises(ValueError):
            fn(dg, J.EdgeDelta.empty() if fn is J.update_ranks
               else T.EdgeDelta.empty(), st, **kw)
    js.version = ts.version = 0
    js.v = ts.v = np.full(jd.n, 1.0 / jd.n)
    arrival = J.EdgeDelta.empty(new_nodes=1)
    with pytest.raises(NotImplementedError):
        J.update_ranks(jd, arrival, js)
    with pytest.raises(NotImplementedError):
        T.update_ranks(td, t_delta(arrival), ts, device=CPU)
    assert jd.version == td.version == 0        # neither graph moved
    with pytest.raises(ValueError):
        T.update_ranks(td, T.EdgeDelta.empty(), ts, method="newton",
                       device=CPU)


def test_refresh_residual_matches_reference(small_graph, ref_cold):
    jd, td = pair(small_graph)
    js, ts = j_copy(ref_cold), t_state(ref_cold)
    js.r[:] = 0.0
    ts.r[:] = 0.0
    J.refresh_residual(jd, js)
    T.refresh_residual(td, ts)
    np.testing.assert_array_equal(js.r, ts.r)
    np.testing.assert_array_equal(ts.r, ref_cold.r)


# ---------------------------------------------------------------------------
# personalized queries
# ---------------------------------------------------------------------------
def _mutated_pair(g):
    jd, td = pair(g)
    for d in J.synth_edge_trace(jd, n_batches=3, batch_edges=6, seed=9):
        jd.apply(d)
        td.apply(t_delta(d))
    return jd, td


def test_ppr_push_matches_reference(small_graph):
    jd, td = _mutated_pair(small_graph)
    for jv, tv in ((jd, td), (jd.freeze(), td.freeze())):
        for seeds, w in (([42, 99], None), ([5], None),
                         ([11, 3, 7], [1.0, 2.0, 3.0])):
            jx, jc, js = J.ppr_push(jv, seeds, weights=w, tol=1e-3)
            tx, tc, ts = T.ppr_push(tv, seeds, weights=w, tol=1e-3)
            np.testing.assert_array_equal(jx, tx)
            assert jc == tc <= 1e-3
            assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    for bad in (([3, 3], None), ([-1], None), ([1, 2], [1.0, -1.0]),
                ([1], [0.0]), ([], None)):
        with pytest.raises(ValueError):
            J.validate_seeds(jd.n, *bad)
        with pytest.raises(ValueError):
            T.validate_seeds(td.n, *bad)


def _seed_sets(n, nv=16, seed=10):
    rng = np.random.default_rng(seed)
    return [rng.choice(n, size=int(rng.integers(1, 5)), replace=False)
            for _ in range(nv)]


def test_ppr_push_batched_scipy_matches_reference(small_graph):
    jd, td = _mutated_pair(small_graph)
    sets = _seed_sets(jd.n)
    tol = np.r_[np.full(8, 1e-4), np.full(8, 1e-6)]
    jx, jc, js = J.ppr_push_batched(jd, sets, tol=tol, backend="scipy")
    for backend in ("scipy", "auto"):       # "auto" on the CPU is scipy
        tx, tc, ts = T.ppr_push_batched(td, sets, tol=tol, backend=backend,
                                        device=CPU)
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jc, tc)
        assert ts.path == js.path == "batched_host"
        np.testing.assert_array_equal(js.lane_iters, ts.lane_iters)
        assert (tc <= tol).all()


def test_ppr_push_batched_segment_sum_matches_reference(small_graph,
                                                        ref_x64):
    """16 lanes with per-lane tols through the float64 segment sum, lanes
    freezing out: equal lane iterations, each lane within L1 1e-10."""
    jd, td = _mutated_pair(small_graph)
    sets = _seed_sets(jd.n)
    tol = np.r_[np.full(8, 1e-4), np.full(8, 1e-6)]
    jx, jc, js = J.ppr_push_batched(jd, sets, tol=tol,
                                    backend="segment_sum")
    tx, tc, ts = T.ppr_push_batched(td, sets, tol=tol,
                                    backend="segment_sum", device=CPU)
    assert ts.path == js.path == "batched_linear" and ts.nv == 16
    np.testing.assert_array_equal(js.lane_iters, ts.lane_iters)
    assert js.iters == ts.iters
    assert np.abs(jx - tx).sum(axis=0).max() <= 1e-10
    assert (jc <= tol).all() and (tc <= tol).all()
    # a frozen view with the version's operator, as the serving tier calls
    op = td.operator(0.85)
    ux, uc, _ = T.ppr_push_batched(td.freeze(), sets, tol=tol, op=op,
                                   backend="segment_sum", device=CPU)
    np.testing.assert_array_equal(ux, tx)
    with pytest.raises(ValueError):
        T.ppr_push_batched(td.freeze(), sets, device=CPU)


def test_ppr_push_batched_bsr_certifies(small_graph):
    jd, td = _mutated_pair(small_graph)
    sets = _seed_sets(jd.n)
    jx, jc, js = J.ppr_push_batched(jd, sets, tol=1e-4,
                                    backend="bsr_pallas")
    tx, tc, ts = T.ppr_push_batched(td, sets, tol=1e-4, backend="bsr",
                                    device=CPU)
    assert ts.path == js.path == "batched_linear" and ts.nv == 16
    assert (jc <= 1e-4).all() and (tc <= 1e-4).all()
    assert np.abs(jx - tx).sum(axis=0).max() <= 2e-4


# ---------------------------------------------------------------------------
# the rank server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tol,frac,path", [(1e-7, 0.6, "solve_linear"),
                                           (1e-5, 1.0, "push")])
def test_rank_server_inline_matches_reference(ref_x64, tol, frac, path):
    """The same ingests through both servers inline: equal versions, paths,
    counters, top-k and personalized answers, snapshot x within L1 1e-12
    and every certificate within tol (on this 1,500-page graph a drain at
    tol 1e-7 reaches past the cap and falls back; at 1e-5 with no cap it
    stays on the push path)."""
    g = j_powerlaw(n=1500, target_nnz=12000, n_dangling=8, seed=21)
    js = J.RankServer(J.DeltaGraph(g), tol=tol, push_frontier_frac=frac)
    ts = T.RankServer(T.DeltaGraph(t_graph(g)), tol=tol,
                      push_frontier_frac=frac, device=CPU)
    rng = np.random.default_rng(22)

    def same_snapshots():
        a, b = js.snapshot(), ts.snapshot()
        assert (a.version, a.seq, a.pending_at_publish) == (
            b.version, b.seq, b.pending_at_publish)
        assert float(np.abs(a.x - b.x).sum()) <= 1e-12
        assert a.cert <= tol and b.cert <= tol
        assert not b.x.flags.writeable
        np.testing.assert_array_equal(js.top_k(10)[0], ts.top_k(10)[0])
        np.testing.assert_array_equal(a.top_k(a.n)[0], b.top_k(b.n)[0])

    same_snapshots()
    paths = []
    for k in (3, 2, 40, 1):
        for _ in range(2):
            d = J.EdgeDelta.inserts(rng.integers(0, 1500, k),
                                    rng.integers(0, 1500, k))
            js.ingest(d)
            ts.ingest(t_delta(d))
        a, b = js.apply_pending(), ts.apply_pending()
        assert a.path == b.path
        paths.append(b.path)
        same_snapshots()
    assert set(paths) == {path}
    for f in ("deltas_ingested", "batches_applied", "fallbacks",
              "queries_served", "state_recoveries", "cold_rebuilds"):
        assert getattr(js, f) == getattr(ts, f), f
    jx, jc, _ = js.personalized([42, 99], tol=1e-3)
    tx, tc, _ = ts.personalized([42, 99], tol=1e-3)
    np.testing.assert_array_equal(jx, tx)
    assert jc == tc
    assert js.apply_pending() is None and ts.apply_pending() is None
    names = lambda txt: [ln.split()[0] for ln in txt.splitlines()
                         if not ln.startswith("#")]
    assert names(js.metrics_text()) == names(ts.metrics_text())
    assert js.health().keys() == ts.health().keys()
    assert js.staleness().keys() == ts.staleness().keys()
    snaps = []
    ts.subscribe(snaps.append)
    ts.enable_snapshot_ops()
    assert snaps[-1].op is ts.dg.operator(0.85) and snaps[-1].pt_sp is not None


def test_rank_server_threaded_with_concurrent_queries():
    """The daemon updater under two query threads: every snapshot a reader
    sees is certified, the health is clean after stop(drain=True), and
    the final ranks agree with the JAX package's float64 oracle of the
    final graph (built by the JAX package from the same deltas)."""
    g = j_powerlaw(n=1200, target_nnz=9000, n_dangling=6, seed=26)
    tol = 1e-6
    srv = T.RankServer(T.DeltaGraph(t_graph(g)), tol=tol,
                       push_frontier_frac=0.6, device=CPU)
    errors, seen = [], []
    stop = threading.Event()

    def reader(kind):
        rng = np.random.default_rng(kind)
        try:
            while not stop.is_set():
                snap = srv.snapshot()
                seen.append((snap.seq, snap.cert))
                if kind == 0:
                    ids, scores = srv.top_k(int(rng.integers(1, 20)))
                    assert np.all(np.diff(scores) <= 0)
                else:
                    x, cert, _ = srv.personalized(
                        rng.choice(1200, 2, replace=False), tol=1e-2)
                    assert np.isfinite(x).all() and cert <= 1e-2
        except BaseException as exc:
            errors.append(exc)
            stop.set()

    jd = J.DeltaGraph(g)
    rng = np.random.default_rng(27)
    srv.start(poll_s=0.001)
    threads = [threading.Thread(target=reader, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 1.5
        while time.time() < deadline and not stop.is_set():
            d = J.EdgeDelta.inserts(rng.integers(0, 1200, 2),
                                    rng.integers(0, 1200, 2))
            jd.apply(d)
            srv.ingest(t_delta(d))
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        srv.stop(drain=True)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    h = srv.health()
    assert h["last_error"] is None and h["updater_restarts"] == 0
    assert srv.cold_rebuilds == 0 and h["status"] == "ok"
    assert h["version_lag"] == 0 and h["pending_deltas"] == 0
    assert srv.batches_applied >= 1 and srv.queries_served > 0
    assert all(c <= tol for _, c in seen)
    snap = srv.snapshot()
    _same_csr(srv.dg.graph(), jd.graph())
    x_ref = j_exact(jd.operator(0.85), tol=1e-13)
    assert snap.cert <= tol
    assert float(np.abs(snap.x - x_ref).sum()) <= tol


def test_rank_server_rejects_like_reference():
    g = j_powerlaw(n=200, target_nnz=1500, n_dangling=2, seed=3)
    _, td = pair(g)
    for kw in (dict(updater="telepathic"), dict(shard_mode="psychic"),
               dict(shard_transport="pigeon"),
               dict(shard_transport="device")):
        with pytest.raises(ValueError):
            J.RankServer(J.DeltaGraph(g), **kw)
        with pytest.raises(ValueError):
            T.RankServer(td, device=CPU, **kw)
    for transport in ("threads", "procpool"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            T.RankServer(td, updater="sharded", shard_mode="async",
                         shard_transport=transport, device=CPU)


# ---------------------------------------------------------------------------
# the replay and the DES bridge
# ---------------------------------------------------------------------------
def test_replay_trace_matches_reference(ref_x64):
    g = j_powerlaw(n=1000, target_nnz=8000, n_dangling=5, seed=31)
    jd, td = pair(g)
    js = J.cold_state(jd, tol=1e-6)
    ts = t_state(js)
    jtrace = J.synth_edge_trace(jd, n_batches=8, batch_edges=3, seed=32)
    ttrace = T.synth_edge_trace(td, n_batches=8, batch_edges=3, seed=32)
    assert jd.version == td.version == 0
    for a, b in zip(jtrace, ttrace):
        for f, x in delta_arrays(a).items():
            np.testing.assert_array_equal(x, getattr(b, f), err_msg=f)
    kw = dict(query_rate=60.0, delta_interval=0.3, tol=1e-5,
              push_frontier_frac=0.6, seed=33)
    a = J.replay_trace(jd, js, jtrace, J.ReplayConfig(**kw))
    b = T.replay_trace(td, ts, ttrace, T.ReplayConfig(**kw), device=CPU)
    assert [dataclasses.asdict(r) for r in a.rows] == [
        dataclasses.asdict(r) for r in b.rows]
    for f in ("queries", "fresh_pct", "mean_age_s", "p95_age_s",
              "mean_lag_batches", "busy_frac", "us_per_delta_edge",
              "deltas_per_s"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.table() == b.table()
    assert td.version == 8 and float(np.abs(js.x - ts.x).sum()) <= 1e-10


def test_streaming_block_operator_matches_reference():
    g = j_powerlaw(n=600, target_nnz=4500, n_dangling=3, seed=41)
    jd, td = pair(g)
    rng = np.random.default_rng(42)
    x = rng.random(600)
    xt = torch.as_tensor(x)
    for kind in ("power", "linear"):
        jop = J.StreamingBlockOperator(jd, j_block_rows(600, 3), kind=kind)
        top = T.StreamingBlockOperator(td, t_block_rows(600, 3), kind=kind,
                                       device=CPU)
        ys = []
        for _ in range(2):
            ya = np.concatenate([jop.update_block(i, x) for i in range(3)])
            yb = torch.cat([top.update_block(i, xt) for i in range(3)])
            assert yb.dtype == torch.float64
            np.testing.assert_allclose(yb.numpy(), ya, rtol=1e-12,
                                       atol=1e-15)
            assert [jop.block_work(i) for i in range(3)] == [
                top.block_work(i) for i in range(3)]
            ys.append(yb)
            d = J.EdgeDelta.inserts(rng.integers(0, 600, 5),
                                    rng.integers(0, 600, 5))
            jd.apply(d)
            td.apply(t_delta(d))
        assert float((ys[0] - ys[1]).abs().max()) > 0   # followed the graph
    arrival = J.EdgeDelta.empty(new_nodes=1)
    jd.apply(arrival)
    td.apply(t_delta(arrival))
    with pytest.raises(ValueError):
        jop.update_block(0, np.ones(601))
    with pytest.raises(ValueError):
        top.update_block(0, torch.ones(601, dtype=torch.float64))
    with pytest.raises(ValueError):
        T.StreamingBlockOperator(td, t_block_rows(601, 3), kind="newton",
                                 device=CPU)


def test_des_over_streaming_operator_matches_reference(small_graph):
    """The DES engine iterating the streaming operator after a delta: the
    same decisions as the JAX package's run, so equal counts, and x within
    L1 1e-12."""
    jd, td = pair(small_graph)
    d = J.synth_edge_trace(jd, n_batches=1, batch_edges=20, seed=43,
                           p_new_node=0.0)[0]
    jd.apply(d)
    td.apply(t_delta(d))
    cfg = dict(tol=1e-7, norm="inf", base_flops_rate=1e5, bandwidth=1e6,
               msg_latency=1e-3, cancel_window=1.0, max_iters=3000, seed=9)
    jp, tp = j_block_rows(jd.n, 4), t_block_rows(td.n, 4)
    a = JAsyncDES(J.StreamingBlockOperator(jd, jp), jp,
                  JDESConfig(**cfg)).run()
    b = TAsyncDES(T.StreamingBlockOperator(td, tp, device=CPU), tp,
                  TDESConfig(**cfg), device=CPU).run()
    for f in ("iters", "imports", "attempts", "local_conv_iter"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.stop_time == b.stop_time
    assert float(np.abs(a.x - b.x).sum()) <= 1e-12
