"""Parity of repro_torch's sharded streaming updater
(`streaming/sharded.py::update_ranks_sharded`) with the JAX package's, on
the CPU.

The superstep loop is the JAX package's host numpy, copied, so both run
in this process from the same certified state (the JAX package's cold
state on conftest's 2,000-page graph, carried across by `interop`) and
must agree bit for bit: path, supersteps, STOP superstep, pushes per
shard, exchanges, bytes moved, the certificate, x and r.

The device drain (`mode="async", transport="device"`) needs one JAX device
per shard, so a module fixture runs the JAX package's drains in ONE
subprocess with four forced host devices (`_subproc`, with the
`enable_x64` shim its float64 drain needs) and writes its cold state, the
deltas and the results to an .npz; the port then drains the same delta
from the same state in this process on `device="cpu"`, the four shards on
one leading tensor axis. Equal supersteps, rows sent, full refreshes,
bytes and attempts; x within L1 1e-12 (the two programs take the same
decisions and differ only in the order of a few float64 sums); both
certificates (host float64 recomputes) within tol.
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest

import repro.streaming as J
import repro_torch.streaming as T
from repro.graph.google import exact_pagerank as j_exact
from repro_torch.interop import (csr_graph_from_arrays,
                                 edge_delta_from_arrays,
                                 rank_state_from_arrays)

from _subproc import run_with_devices
from _torch_parity import (delta_arrays, graph_arrays, ref_x64,  # noqa: F401
                           state_arrays)

CPU = "cpu"
COUNTS = ("path", "p", "supersteps", "pushes", "exchanges", "bytes_moved",
          "seed_l1", "resid_l1", "cert", "stop_superstep", "solver_iters",
          "mode", "attempts", "transport", "schedule", "rows_sent", "fulls")


def t_delta(d):
    return edge_delta_from_arrays(delta_arrays(d))


def t_state(s):
    return rank_state_from_arrays(state_arrays(s))


def j_copy(s):
    return J.RankState(x=s.x.copy(), r=s.r.copy(), version=s.version,
                       alpha=s.alpha, v=s.v)


def pair(g):
    return J.DeltaGraph(g), T.DeltaGraph(csr_graph_from_arrays(
        graph_arrays(g)))


@pytest.fixture(scope="module")
def ref_cold(small_graph):
    """The JAX package's certified cold state on the 2,000-page graph."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda: jax.enable_x64(True), raising=False)
        return J.cold_state(J.DeltaGraph(small_graph), tol=1e-9)


def same_stats(a, b):
    for f in COUNTS:
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.pushes_per_shard, b.pushes_per_shard)


@pytest.mark.parametrize("schedule", [None, "priority+boundary",
                                      "randomized"])
@pytest.mark.parametrize("exchange", ["allgather", "sparsified"])
def test_superstep_stream_matches_reference(small_graph, ref_cold, exchange,
                                            schedule):
    """A crawl stream (node arrivals included) drained by the superstep
    loop at p = 4, tol 1e-6: every batch equal to the JAX package's, bit
    for bit, under both exchanges and the drain schedules."""
    jd, td = pair(small_graph)
    js, ts = j_copy(ref_cold), t_state(ref_cold)
    trace = J.synth_edge_trace(jd, n_batches=4, batch_edges=4, seed=61,
                               p_new_node=0.5)
    assert any(d.new_nodes for d in trace)
    for d in trace:
        js, a = J.update_ranks_sharded(jd, d, js, p=4, tol=1e-6,
                                       exchange=exchange, schedule=schedule)
        ts, b = T.update_ranks_sharded(td, t_delta(d), ts, p=4, tol=1e-6,
                                       exchange=exchange, schedule=schedule,
                                       device=CPU)
        assert b.path == "sharded_push" and b.stop_superstep > 0
        same_stats(a, b)
        np.testing.assert_array_equal(js.x, ts.x)
        np.testing.assert_array_equal(js.r, ts.r)
        assert b.cert <= 1e-6 and ts.cert <= b.cert + 1e-15


def test_superstep_deletions_and_dangling_match_reference(small_graph,
                                                          ref_cold):
    """p = 3, tol 1e-6: a hub's whole out-row deleted (it turns dangling,
    the uniform scalar path) and restored, bit for bit."""
    jd, td = pair(small_graph)
    js, ts = j_copy(ref_cold), t_state(ref_cold)
    u = int(np.argmax(jd.out_degree))
    row = jd.out_neighbors(u)
    for d in (J.EdgeDelta.deletes(np.full(row.size, u), row),
              J.EdgeDelta.inserts(np.full(row.size, u), row)):
        js, a = J.update_ranks_sharded(jd, d, js, p=3, tol=1e-6)
        ts, b = T.update_ranks_sharded(td, t_delta(d), ts, p=3, tol=1e-6,
                                       device=CPU)
        assert b.path == "sharded_push"
        same_stats(a, b)
        np.testing.assert_array_equal(js.x, ts.x)
        assert bool(td.dangling_mask[u]) == bool(jd.dangling_mask[u])


def test_superstep_fallback_matches_reference(small_graph, ref_cold,
                                              ref_x64):
    """A push budget too small for the batch: both loops cap at the same
    superstep and fall back to the warm-started float64 solve with the
    same iterations; x within L1 1e-12."""
    jd, td = pair(small_graph)
    js, ts = j_copy(ref_cold), t_state(ref_cold)
    d = J.synth_edge_trace(jd, n_batches=1, batch_edges=30, seed=62,
                           p_new_node=0.0)[0]
    js, a = J.update_ranks_sharded(jd, d, js, p=4, tol=1e-8,
                                   max_push_factor=0.05)
    ts, b = T.update_ranks_sharded(td, t_delta(d), ts, p=4, tol=1e-8,
                                   max_push_factor=0.05, device=CPU)
    assert a.path == b.path == "solve_linear"
    for f in COUNTS:
        if f not in ("resid_l1", "cert"):
            assert getattr(a, f) == getattr(b, f), f
    assert float(np.abs(js.x - ts.x).sum()) <= 1e-12
    assert a.cert <= 1e-8 and b.cert <= 1e-8


BAD_ARGS = [
    dict(exchange="carrier-pigeon"), dict(mode="psychic"),
    dict(transport="pigeon"), dict(method="newton"),
    dict(transport="device"), dict(transport="procpool"),
    dict(observe=True), dict(mode="async", transport="device",
                             observe=True),
    dict(mode="async", transport="device", schedule="priority"),
]


@pytest.mark.parametrize("kw", BAD_ARGS, ids=[str(k) for k in BAD_ARGS])
def test_bad_arguments_raise_like_reference(small_graph, ref_cold, kw):
    """The same ValueError, with the same message, before the graph
    moves."""
    jd, td = pair(small_graph)
    msgs = []
    for fn, dg, st, extra in ((J.update_ranks_sharded, jd, j_copy(ref_cold),
                               {}),
                              (T.update_ranks_sharded, td, t_state(ref_cold),
                               dict(device=CPU))):
        with pytest.raises(ValueError) as exc:
            fn(dg, J.EdgeDelta.empty() if dg is jd else T.EdgeDelta.empty(),
               st, **kw, **extra)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert jd.version == td.version == 0


@pytest.mark.parametrize("kw", [dict(mode="async"),
                                dict(mode="async", transport="procpool"),
                                dict(mode="async", observe=True)])
def test_host_async_transports_raise_not_ported(small_graph, ref_cold, kw):
    _, td = pair(small_graph)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        T.update_ranks_sharded(td, T.EdgeDelta.empty(), t_state(ref_cold),
                               device=CPU, **kw)
    assert td.version == 0


def test_rank_server_sharded_superstep_matches_reference(ref_x64):
    from repro.graph.generate import powerlaw_webgraph
    g = powerlaw_webgraph(n=1500, target_nnz=12000, n_dangling=8, seed=64)
    kw = dict(tol=1e-7, updater="sharded", shards=3, exchange="sparsified")
    js = J.RankServer(J.DeltaGraph(g), **kw)
    ts = T.RankServer(T.DeltaGraph(csr_graph_from_arrays(graph_arrays(g))),
                      device=CPU, **kw)
    rng = np.random.default_rng(65)
    for _ in range(2):
        d = J.EdgeDelta.inserts(rng.integers(0, 1500, 3),
                                rng.integers(0, 1500, 3))
        js.ingest(d)
        ts.ingest(t_delta(d))
        a, b = js.apply_pending(), ts.apply_pending()
        assert b.p == 3 and a.path == b.path == "sharded_push"
        # the servers' cold solves differ within 1e-12, so the seeds'
        # and residuals' sums do in their last bits; every count is equal
        for f in COUNTS:
            if f in ("seed_l1", "resid_l1", "cert"):
                assert getattr(b, f) == pytest.approx(getattr(a, f),
                                                      rel=1e-6), f
            else:
                assert getattr(a, f) == getattr(b, f), f
        assert float(np.abs(js.snapshot().x - ts.snapshot().x).sum()) \
            <= 1e-12
        assert ts.snapshot().cert <= 1e-7


# ---------------------------------------------------------------------------
# the device drain against the JAX package's, four host devices
# ---------------------------------------------------------------------------
REF_CODE = r'''
import sys
import numpy as np
import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
import repro.core  # noqa: F401  (resolves the runtime<->core import cycle)
from repro.graph.generate import powerlaw_webgraph
from repro.streaming import (DeltaGraph, cold_state, synth_edge_trace,
                             update_ranks_sharded)

g = powerlaw_webgraph(n=2000, target_nnz=16000, n_dangling=10, seed=7)
out = {}
dg = DeltaGraph(g)
st0 = cold_state(dg, tol=1e-9)
out["cold_x"], out["cold_r"] = st0.x, st0.r
trace = synth_edge_trace(dg, n_batches=2, batch_edges=20, seed=71,
                         p_new_node=0.0)
for k, d in enumerate(trace):
    for f in ("add_src", "add_dst", "del_src", "del_dst"):
        out[f"delta{k}_{f}"] = getattr(d, f)
for name, (exchange, tol) in CASES.items():
    dg = DeltaGraph(g)
    st = type(st0)(x=st0.x.copy(), r=st0.r.copy(), version=0,
                   alpha=st0.alpha)
    for k, d in enumerate(trace):
        st, s = update_ranks_sharded(dg, d, st, p=4, tol=tol,
                                     mode="async", transport="device",
                                     exchange=exchange)
        out[f"{name}_{k}_x"] = st.x.copy()     # the drain writes x in place
        for f in FIELDS:
            out[f"{name}_{k}_{f}"] = np.asarray(getattr(s, f))
np.savez(sys.argv[1], **out)
print("reference device drains done")
'''

DRAIN_CASES = {"sparsified": ("sparsified", 1e-8),
               "allgather": ("allgather", 1e-8)}
DRAIN_FIELDS = ("path", "supersteps", "rows_sent", "fulls", "bytes_moved",
                "exchanges", "attempts", "stop_superstep", "cert",
                "device_resid")


@pytest.fixture(scope="module")
def ref_drains(tmp_path_factory):
    """Every reference device drain, from one subprocess with 4 host
    devices."""
    path = tmp_path_factory.mktemp("stream_device_ref") / "ref.npz"
    code = ("import sys\nsys.argv = ['ref', %r]\n" % str(path)
            + f"CASES = {DRAIN_CASES!r}\nFIELDS = {DRAIN_FIELDS!r}\n"
            + REF_CODE)
    out = run_with_devices(code, n_devices=4, timeout=600)
    assert "reference device drains done" in out
    data = np.load(path)
    return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", sorted(DRAIN_CASES))
def test_device_drain_matches_reference(small_graph, ref_drains, name):
    exchange, tol = DRAIN_CASES[name]
    _, td = pair(small_graph)
    ts = rank_state_from_arrays(dict(x=ref_drains["cold_x"],
                                     r=ref_drains["cold_r"], version=0,
                                     alpha=0.85, v=None))
    for k in range(2):
        d = edge_delta_from_arrays(dict(
            **{f: ref_drains[f"delta{k}_{f}"] for f in
               ("add_src", "add_dst", "del_src", "del_dst")}, new_nodes=0))
        ts, b = T.update_ranks_sharded(td, d, ts, p=4, tol=tol, mode="async",
                                       transport="device", exchange=exchange,
                                       device=CPU)
        ref = {f: ref_drains[f"{name}_{k}_{f}"].item() for f in DRAIN_FIELDS}
        assert b.path == ref["path"] == "sharded_push"
        assert (b.mode, b.transport) == ("async", "device")
        for f in ("supersteps", "rows_sent", "fulls", "bytes_moved",
                  "exchanges", "attempts", "stop_superstep"):
            assert getattr(b, f) == ref[f], f
        assert float(np.abs(ts.x - ref_drains[f"{name}_{k}_x"]).sum()) \
            <= 1e-12
        assert b.cert <= tol and ref["cert"] <= tol
        assert b.device_resid == pytest.approx(ref["device_resid"],
                                               rel=1e-6)


def test_rank_server_device_drains_certify(small_graph, ref_cold):
    """A server whose sharded updater drains on the device transport
    (here the CPU's plain path): every published snapshot within tol, and
    the final ranks within it of the float64 oracle."""
    srv = T.RankServer(T.DeltaGraph(csr_graph_from_arrays(
        graph_arrays(small_graph))), tol=1e-8, updater="sharded", shards=4,
        exchange="sparsified", shard_mode="async", shard_transport="device",
        cold_tol=1e-9, device=CPU)
    jd = J.DeltaGraph(small_graph)
    for d in J.synth_edge_trace(jd, n_batches=2, batch_edges=5, seed=72,
                                p_new_node=0.0):
        jd.apply(d)
        srv.ingest(t_delta(d))
        stats = srv.apply_pending()
        assert (stats.path, stats.transport) == ("sharded_push", "device")
        assert srv.snapshot().cert <= 1e-8
    x_ref = j_exact(jd.operator(0.85), tol=1e-14)
    assert float(np.abs(srv.snapshot().x - x_ref).sum()) <= 1e-8
    assert dataclasses.asdict(stats)["schedule"] == "default"
