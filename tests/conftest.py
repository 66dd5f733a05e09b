# NOTE: do NOT set XLA_FLAGS / device counts here — smoke tests and benches
# must see the real single CPU device. Multi-device tests spawn subprocesses
# with their own XLA_FLAGS (tests/_subproc.py).
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device (skips without one)")


@pytest.fixture(scope="session")
def small_graph():
    from repro.graph.generate import powerlaw_webgraph
    return powerlaw_webgraph(n=2000, target_nnz=16000, n_dangling=10, seed=7)


@pytest.fixture(scope="session")
def small_op(small_graph):
    from repro.graph.csr import TransitionT
    from repro.graph.google import GoogleOperator
    return GoogleOperator(pt=TransitionT.from_graph(small_graph), alpha=0.85)


@pytest.fixture(scope="session")
def exact_x(small_op):
    from repro.graph.google import exact_pagerank
    return exact_pagerank(small_op, tol=1e-14)


# ---------------------------------------------------------------------------
# the 50k acceptance workload (shared by test_streaming / test_transport —
# session-scoped so the expensive graph build and cold solves happen once)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="session")
def accept_graph():
    from repro.graph.generate import powerlaw_webgraph
    return powerlaw_webgraph(n=50_000, target_nnz=400_000, n_dangling=50,
                             seed=3)


@pytest.fixture(scope="session")
def accept_delta(accept_graph):
    """A random ~1% edge delta (85% inserts / 15% deletes of existing)."""
    from repro.streaming import EdgeDelta
    g = accept_graph
    rng = np.random.default_rng(31)
    k = g.nnz // 100
    n_del = k * 15 // 100
    slots = rng.choice(g.nnz, size=n_del, replace=False)
    src_of_edge = np.repeat(np.arange(g.n, dtype=np.int64),
                            np.diff(g.indptr))
    return EdgeDelta(
        add_src=rng.integers(0, g.n, k - n_del),
        add_dst=g.indices[rng.integers(0, g.nnz, k - n_del)].astype(np.int64),
        del_src=src_of_edge[slots],
        del_dst=g.indices[slots].astype(np.int64))


@pytest.fixture(scope="session")
def accept_cold(accept_graph, accept_delta):
    """Cold solve_power on the mutated graph, far tighter than any tol the
    backends are asked for (error <= 1e-9/0.15 ~ 7e-9 L1)."""
    from repro.core.pagerank import solve_power
    from repro.streaming import DeltaGraph
    dg = DeltaGraph(accept_graph)
    dg.apply(accept_delta)
    return solve_power(dg.operator(0.85), tol=1e-9, max_iters=2000).x


@pytest.fixture(scope="session")
def accept_base(accept_graph):
    """Certified cold state on the UN-mutated 50k graph (the warm start
    the sharded-transport acceptance drains from)."""
    from repro.streaming import DeltaGraph, cold_state
    return cold_state(DeltaGraph(accept_graph), tol=5e-9)
