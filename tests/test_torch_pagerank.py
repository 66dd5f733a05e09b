"""Parity of repro_torch's static PageRank solve with the JAX package's, on
the CPU, on the session fixtures' n=2000 graph.

Tolerances:
  * segment_sum in float64: the same iteration count and max abs diff
    <= 1e-12 (only summation order differs);
  * bsr (float32) at bm=8 against the JAX package's bsr_pallas at bm=8:
    iterations within +-1 (a residual may cross tol one apply earlier or
    later under another summation order) and max abs diff < 1e-6.
"""
import numpy as np
import pytest
import torch

import repro.core.backend as jb
import repro.core.pagerank as jp
import repro_torch.core.backend as tb
import repro_torch.core.pagerank as tp
from repro.graph.google import exact_pagerank as j_exact
from repro_torch.graph.google import exact_pagerank as t_exact
from repro_torch.interop import operator_from_arrays

from _torch_parity import op_arrays, ref_x64  # noqa: F401  (fixture)

SOLVERS = {"power": (jp.solve_power, tp.solve_power),
           "linear": (jp.solve_linear, tp.solve_linear)}


@pytest.fixture(scope="module")
def port_op(small_op):
    return operator_from_arrays(op_arrays(small_op))


def seeds8(n):
    rng = np.random.default_rng(17)
    return [rng.choice(n, size=3, replace=False) for _ in range(8)]


@pytest.mark.parametrize("kind", ["power", "linear"])
def test_segment_sum_f64_matches(small_op, port_op, ref_x64, kind):
    j_solve, t_solve = SOLVERS[kind]
    rj = j_solve(small_op, tol=1e-12, max_iters=2000)
    rt = t_solve(port_op, tol=1e-12, max_iters=2000, device="cpu")
    assert rt.iters == rj.iters
    assert rt.x.shape == rj.x.shape == (small_op.n,)
    assert np.abs(rt.x - rj.x).max() <= 1e-12
    assert rt.resid_l1 == pytest.approx(rj.resid_l1, rel=1e-3, abs=1e-15)


@pytest.mark.parametrize("kind", ["power", "linear"])
def test_bsr_f32_matches(small_op, port_op, kind):
    j_solve, t_solve = SOLVERS[kind]
    rj = j_solve(small_op, tol=1e-6, max_iters=500,
                 backend=jb.BackendSpec(name="bsr_pallas", bm=8, impl="ref"))
    rt = t_solve(port_op, tol=1e-6, max_iters=500,
                 backend=tb.BackendSpec(name="bsr", bm=8, impl="ref"),
                 device="cpu")
    assert abs(rt.iters - rj.iters) <= 1
    assert np.abs(rt.x - rj.x).max() < 1e-6
    assert rt.resid_l1 <= 1e-6


def test_bsr_alias_and_cpu_default_block(port_op):
    """"bsr_pallas" names the same backend; bm=0 is 8 on the CPU."""
    spec = tb.as_spec("bsr_pallas", torch.device("cpu"))
    assert (spec.name, spec.bm, spec.impl) == ("bsr", 8, "auto")
    a = tp.solve_power(port_op, tol=1e-6, backend="bsr_pallas", device="cpu")
    b = tp.solve_power(port_op, tol=1e-6, backend="bsr", device="cpu")
    np.testing.assert_array_equal(a.x, b.x)
    with pytest.raises(ValueError, match="backend"):
        tb.as_spec("csr", torch.device("cpu"))


@pytest.mark.parametrize("backend", ["segment_sum", "bsr"])
def test_frozen_lanes_match(small_op, port_op, ref_x64, backend):
    """An 8-lane personalized stack with mixed per-lane tolerances: lanes
    freeze and compact at pow2 widths in both packages."""
    v = jb.seed_stack(small_op.n, seeds8(small_op.n))
    if backend == "segment_sum":
        tol = np.array([1e-12] * 4 + [1e-8] * 4)
        rj = jp.solve_power(small_op, tol=tol, v=v)
        rt = tp.solve_power(port_op, tol=tol, v=v, device="cpu")
        np.testing.assert_array_equal(rt.lane_iters, rj.lane_iters)
        assert rt.iters == rj.iters
        assert np.abs(rt.x - rj.x).max() <= 1e-12
    else:
        tol = np.array([1e-6] * 4 + [1e-4] * 4)
        rj = jp.solve_power(small_op, tol=tol, v=v, backend=jb.BackendSpec(
            name="bsr_pallas", bm=8, impl="ref"))
        rt = tp.solve_power(port_op, tol=tol, v=v, backend="bsr",
                            device="cpu")
        assert np.abs(rt.lane_iters - rj.lane_iters).max() <= 1
        assert np.abs(rt.x - rj.x).max() < 1e-6
    assert rt.x.shape == (small_op.n, 8)
    assert rt.lane_iters.min() < rt.lane_iters.max()    # lanes froze
    assert np.all(rt.resid_per_vec <= tol)


@pytest.mark.parametrize("chunk", [5, "auto"])
def test_freeze_chunk_and_unfrozen_agree(port_op, chunk):
    v = tb.seed_stack(port_op.n, seeds8(port_op.n))
    frozen = tp.solve_linear(port_op, tol=1e-10, v=v, device="cpu",
                             freeze_chunk=chunk)
    fused = tp.solve_linear(port_op, tol=1e-10, v=v, device="cpu",
                            freeze_lanes=False)
    assert np.all(frozen.lane_iters <= fused.iters)
    assert np.abs(frozen.x - fused.x).max() < 1e-9


@pytest.mark.parametrize("method", ["rcm", "indeg"])
def test_reordered_solve_matches(small_op, ref_x64, method):
    # a fresh operator per package: both memoize the permutation on it
    port_op = operator_from_arrays(op_arrays(small_op))
    rj = jp.solve_power(small_op, tol=1e-12, reorder=method)
    rt = tp.solve_power(port_op, tol=1e-12, reorder=method, device="cpu")
    assert rt.iters == rj.iters
    assert np.abs(rt.x - rj.x).max() <= 1e-12
    rb = tp.solve_power(port_op, tol=1e-6, reorder=method, backend="bsr",
                        device="cpu")
    assert np.abs(rb.x - rj.x).max() < 1e-5


def test_seed_stack_and_lane_tol_match():
    sets = [[0, 5, 9], [3], [7, 7 + 1]]
    weights = [None, [2.0], [1.0, 3.0]]
    np.testing.assert_array_equal(tb.seed_stack(20, sets, weights),
                                  jb.seed_stack(20, sets, weights))
    np.testing.assert_array_equal(tb.as_lane_tol(1e-6, 3),
                                  jb.as_lane_tol(1e-6, 3))
    for bad in ([1e-6, 1e-6], [0.0, 1.0, 1.0], [np.inf, 1, 1]):
        with pytest.raises(ValueError):
            tb.as_lane_tol(bad, 3)
    with pytest.raises(ValueError):
        tb.seed_stack(20, [])


def test_prepare_lane_broadcast_and_errors(port_op):
    n = port_op.n
    cpu = torch.device("cpu")
    spec = tb.as_spec("segment_sum", cpu)
    v3 = np.full((n, 3), 1.0 / n)
    dev, meta, x0 = tb.prepare(port_op, spec, torch.float64, v=v3,
                               x0=np.full(n, 1.0 / n), device=cpu)
    assert meta.nv == 3 and x0.shape == (n, 3) and dev["v"].shape == (n, 3)
    dev, meta, x0 = tb.prepare(port_op, spec, torch.float64,
                               x0=np.full((n, 2), 1.0 / n), device=cpu)
    assert meta.nv == 2 and dev["v"].shape == (n, 2)
    with pytest.raises(ValueError, match="lanes"):
        tb.prepare(port_op, spec, torch.float64, v=v3,
                   x0=np.full((n, 2), 1.0 / n), device=cpu)
    with pytest.raises(ValueError, match="rows"):
        tb.prepare(port_op, spec, torch.float64, v=np.ones(n + 1),
                   device=cpu)
    bsr = tb.as_spec(tb.BackendSpec(name="bsr", bm=16), cpu)
    dev, meta, x0 = tb.prepare(port_op, bsr, torch.float32, device=cpu)
    assert x0.shape == (meta.n_pad // 16, 16, 1)
    assert x0.dtype == dev["blocks"].dtype == torch.float32
    np.testing.assert_allclose(tb.from_layout(meta, x0)[:, 0], 1.0 / n,
                               rtol=1e-6)


def test_adapt_chunk_matches():
    rng = np.random.default_rng(3)
    for _ in range(50):
        prev = rng.random(5) * 10.0 ** -rng.integers(1, 6, 5)
        cur = prev * rng.random(5)
        it = int(rng.integers(1, 64))
        tol = 10.0 ** -rng.integers(4, 12)
        assert tp._adapt_chunk(prev, cur, it, tol, 32) == jp._adapt_chunk(
            prev, cur, it, tol, 32)


def test_rank_utilities_match(exact_x):
    np.testing.assert_array_equal(tp.rank_of(exact_x), jp.rank_of(exact_x))
    noisy = exact_x * (1 + 1e-9 * np.random.default_rng(0)
                       .standard_normal(len(exact_x)))
    assert tp.kendall_tau_topk(exact_x, noisy, k=100) == \
        jp.kendall_tau_topk(exact_x, noisy, k=100)
    assert tp.kendall_tau_topk(exact_x, exact_x, k=50) == pytest.approx(1.0)


def test_configs_match():
    from repro.configs.pagerank import SMALL as JS, STANFORD as JST
    from repro_torch.configs.pagerank import SMALL as TS, STANFORD as TST
    import dataclasses
    assert dataclasses.asdict(TST) == dataclasses.asdict(JST)
    assert dataclasses.asdict(TS) == dataclasses.asdict(JS)


def test_slice_end_to_end(small_graph, small_op, port_op, exact_x, ref_x64):
    """The whole slice at n=2000 through both packages: the graph built by
    each, the f64 oracle, and every backend's solve, held to each other and
    to the oracle."""
    from repro_torch.configs.pagerank import PageRankConfig
    cfg = PageRankConfig(name="slice", n=2000, nnz=16000, n_dangling=10,
                         seed=7)
    op = cfg.build()
    np.testing.assert_array_equal(op.pt.src, small_op.pt.src)
    np.testing.assert_array_equal(op.pt.weight, small_op.pt.weight)
    x_t = t_exact(op, tol=1e-14)
    np.testing.assert_array_equal(x_t, exact_x)
    np.testing.assert_array_equal(t_exact(op, tol=1e-10),
                                  j_exact(small_op, tol=1e-10))
    for kind, (j_solve, t_solve) in SOLVERS.items():
        seg = t_solve(op, tol=1e-12, device="cpu")
        bsr = t_solve(op, tol=1e-6, backend="bsr", device="cpu")
        ref = j_solve(small_op, tol=1e-12)
        assert np.abs(seg.x - exact_x).max() < 1e-10, kind
        assert np.abs(seg.x - ref.x).max() <= 1e-12, kind
        assert np.abs(bsr.x - exact_x).sum() < 1e-5, kind
        assert tp.kendall_tau_topk(bsr.x, exact_x, k=100) > 0.99, kind
