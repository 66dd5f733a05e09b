"""Parity of repro_torch's discrete-event simulation (`core/des.py`,
`AsyncFixedPoint.solve_des` / `solve_des_sync`) and the host runtime under
it (`ShardState`, the host `ExchangePlan`s, `BlockLocalSolver`) with the
JAX package's, on the CPU.

Both engines run in this process on the same operator (the port's built
from the JAX package's arrays, `interop.operator_from_arrays`) and draw from
one numpy Generator per run in the same order, so a run is fixed by its
decisions: which UE converged, which pair passed the mass gate, which rows
a top-k payload ships. The port's block update sums P^T x in edge order
(the CSR kernel's plain version gives scipy's bits) and its dangling and
total masses with torch sums, which may differ from numpy's in the last
bit; no decision of these runs sits that close to a threshold, so:

  * matvec "csr": iters, imports, attempts, local_conv_iter,
    local_conv_time, max_staleness, stop_time and the Table 2 percentages
    are equal, and x within L1 1e-13 (a few float64 ulps summed over
    2,000 pages);
  * matvec "bsr": the JAX package's scipy BSR sums in another order
    (up to 1.25e-16 a block update on these graphs) while the port runs
    the same CSR product, so the counts are equal and x within L1 1e-12;
  * solve_des_sync: equal iters and simulated time, x within L1 1e-13.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as j_core
import repro.runtime as j_rt
import repro_torch.core as t_core
import repro_torch.runtime as t_rt
from repro.core.partition import block_rows as j_block_rows
from repro.graph.csr import TransitionT as JTransitionT
from repro.graph.generate import powerlaw_webgraph as j_powerlaw
from repro.graph.google import GoogleOperator as JGoogleOperator
from repro_torch.core.partition import block_rows as t_block_rows
from repro_torch.interop import operator_from_arrays

from _torch_parity import op_arrays

GOLDEN_DES = {
    # tests/test_runtime.py's pins of the JAX package's DES on the seeded
    # 5,000-page graph
    "power": dict(iters=[24, 27, 31, 27], imports=318, attempts=327,
                  stop_time=3.613048),
    "linear": dict(iters=[53, 60, 69, 61], imports=725, attempts=729,
                   stop_time=8.070206),
}
GOLDEN_CFG = dict(tol=1e-7, norm="inf", base_flops_rate=1e5, bandwidth=1e6,
                  msg_latency=1e-3, cancel_window=1.0, max_iters=3000,
                  seed=9)
# tests/test_des.py's fast network: staleness stays small
FAST = dict(tol=1e-9, norm="inf", base_flops_rate=1e5, bandwidth=1e9,
            msg_latency=1e-4, cancel_window=None, max_iters=5000, seed=1)

# name -> (kind, partition, p, DESConfig fields): the policies, clocks,
# partitions and stops of tests/test_des.py and tests/test_runtime.py
CASES = {
    "all_to_all_power": ("power", "block", 4, FAST),
    "all_to_all_linear": ("linear", "block", 4, FAST),
    # ring never STOPs on this graph in either package (tests/test_des.py's
    # ring case runs all 5,000 iterations): capped at 400 here
    "ring": ("linear", "block", 4, dict(FAST, comm_policy="ring",
                                        pc_max_compute=8, pc_max_monitor=8,
                                        max_iters=400)),
    "adaptive": ("power", "block", 4, dict(FAST, comm_policy="adaptive",
                                           bandwidth=1e6,
                                           cancel_window=0.2)),
    "sparsified": ("power", "block", 4, dict(
        FAST, comm_policy="sparsified", sparsify_thresh=1e-4,
        sparsify_refresh_every=4)),
    "sparsified_top64": ("power", "block", 4, dict(
        FAST, comm_policy="sparsified", sparsify_thresh=1e-7,
        sparsify_refresh_every=4, sparsify_top_k=64)),
    "sparsified_adaptive_k": ("power", "block", 4, dict(
        FAST, comm_policy="sparsified", sparsify_thresh=1e-7,
        sparsify_refresh_every=4, sparsify_top_k="adaptive")),
    "heterogeneous": ("power", "block", 4, dict(
        FAST, ue_speed=[1.0, 0.25, 1.5, 0.7])),
    "balanced_nnz": ("power", "balanced_nnz", 4, FAST),
    "p3": ("power", "block", 3, dict(FAST, tol=1e-7)),
    "saturated_table2": ("power", "block", 4, dict(
        tol=1e-5, norm="inf", base_flops_rate=1e5, bandwidth=2e4,
        msg_latency=1e-3, cancel_window=0.5, max_iters=3000, seed=3)),
    "local_tol_l1": ("power", "block", 4, dict(
        tol=1e-6, norm="l1", base_flops_rate=1e5, bandwidth=1e5,
        msg_latency=1e-3, cancel_window=1.0, max_iters=3000, seed=5)),
    "rank_stop_l2": ("power", "block", 4, dict(
        tol=1e-8, norm="l2", base_flops_rate=1e5, bandwidth=1e6,
        msg_latency=1e-3, cancel_window=1.0, max_iters=3000, seed=11,
        rank_stop_k=50, rank_stop_tau=0.999, rank_stop_interval=0.25,
        rank_stop_patience=2)),
}
BSR_CASES = ("all_to_all_power", "sparsified_top64", "saturated_table2")
SYNC_CASES = {
    "fast_power": ("power", dict(FAST)),
    "fast_linear_l2": ("linear", dict(FAST, norm="l2")),
    # paper Table 1's clock (DESConfig defaults, barrier overhead 0.5 s)
    "table1_clock": ("power", dict(tol=1e-6, norm="l2",
                                   barrier_overhead=0.5, seed=7)),
}


def assert_same_run(r_t, r_j, x_l1):
    for f in ("iters", "imports", "attempts", "local_conv_iter",
              "local_conv_time", "completed_import_pct"):
        np.testing.assert_array_equal(getattr(r_t, f), getattr(r_j, f),
                                      err_msg=f)
    assert r_t.max_staleness == r_j.max_staleness
    assert r_t.stop_time == r_j.stop_time
    assert (r_t.rank_stop_time == r_j.rank_stop_time
            or (np.isnan(r_t.rank_stop_time)
                and np.isnan(r_j.rank_stop_time)))
    assert float(np.abs(r_t.x - r_j.x).sum()) <= x_l1
    assert r_t.global_resid_l1 == pytest.approx(r_j.global_resid_l1,
                                                rel=1e-6, abs=1e-15)


@pytest.fixture(scope="module")
def t_small(small_op):
    return operator_from_arrays(op_arrays(small_op))


@pytest.fixture(scope="module")
def golden_ops():
    g = j_powerlaw(n=5000, target_nnz=40000, n_dangling=20, seed=9)
    op = JGoogleOperator(pt=JTransitionT.from_graph(g), alpha=0.85)
    return op, operator_from_arrays(op_arrays(op))


@pytest.mark.parametrize("kind", ["power", "linear"])
def test_golden_des_counts(golden_ops, kind):
    """The port's CPU run reproduces the JAX package's golden DES pins
    exactly, and the JAX package's own run of the same configuration."""
    j_op, t_op = golden_ops
    r_t = t_core.AsyncFixedPoint(t_op, kind=kind).solve_des(
        p=4, cfg=t_core.DESConfig(**GOLDEN_CFG), device="cpu")
    gold = GOLDEN_DES[kind]
    assert r_t.iters.tolist() == gold["iters"]
    assert int(r_t.imports.sum()) == gold["imports"]
    assert int(r_t.attempts.sum()) == gold["attempts"]
    assert r_t.stop_time == pytest.approx(gold["stop_time"], abs=1e-6)
    r_j = j_core.AsyncFixedPoint(j_op, kind=kind).solve_des(
        p=4, cfg=j_core.DESConfig(**GOLDEN_CFG))
    assert_same_run(r_t, r_j, 1e-13)


@pytest.mark.parametrize("case", sorted(CASES))
def test_des_matches_reference(small_op, t_small, case):
    kind, partition, p, fields = CASES[case]
    r_j = j_core.AsyncFixedPoint(small_op, kind=kind,
                                 partition=partition).solve_des(
        p=p, cfg=j_core.DESConfig(**fields))
    r_t = t_core.AsyncFixedPoint(t_small, kind=kind,
                                 partition=partition).solve_des(
        p=p, cfg=t_core.DESConfig(**fields), device="cpu")
    assert_same_run(r_t, r_j, 1e-13)


def test_des_cases_reach_their_paths(small_op, t_small, exact_x):
    """The cases above exercise what they are named for: top-k payloads,
    canceled sends and stale imports, the rank-stability stop, a slow UE,
    ring relays, and convergence to the exact ranks on the fast
    network."""
    def run(case):
        kind, partition, p, fields = CASES[case]
        return t_core.AsyncFixedPoint(t_small, kind=kind,
                                      partition=partition).solve_des(
            p=p, cfg=t_core.DESConfig(**fields), device="cpu")
    r = run("all_to_all_power")
    assert np.abs(r.x - exact_x).max() < 1e-6
    assert run("sparsified_top64").attempts.sum() < r.attempts.sum()
    r = run("saturated_table2")
    assert r.completed_import_pct.mean() < 60 and r.max_staleness >= 1
    r = run("heterogeneous")
    assert r.iters[1] < r.iters[2]
    assert np.isfinite(run("rank_stop_l2").rank_stop_time)
    r = run("ring")
    assert r.imports.sum() > r.attempts.sum()      # relays import too


@pytest.mark.parametrize("case", BSR_CASES)
def test_des_bsr_flavor(small_op, t_small, case):
    """backend "bsr_pallas" picks the JAX package's scipy BSR block update;
    the port runs its CSR product for it: equal counts, x within 1e-12."""
    kind, partition, p, fields = CASES[case]
    r_j = j_core.AsyncFixedPoint(small_op, kind=kind,
                                 backend="bsr_pallas").solve_des(
        p=p, cfg=j_core.DESConfig(**fields))
    r_t = t_core.AsyncFixedPoint(t_small, kind=kind,
                                 backend="bsr_pallas").solve_des(
        p=p, cfg=t_core.DESConfig(**fields), device="cpu")
    assert t_core.AsyncFixedPoint(t_small, backend="bsr")._des_matvec() \
        == "bsr"
    assert_same_run(r_t, r_j, 1e-12)


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_des_sync_matches_reference(small_op, t_small, case):
    kind, fields = SYNC_CASES[case]
    r_j = j_core.AsyncFixedPoint(small_op, kind=kind).solve_des_sync(
        p=4, cfg=j_core.DESConfig(**fields))
    r_t = t_core.AsyncFixedPoint(t_small, kind=kind).solve_des_sync(
        p=4, cfg=t_core.DESConfig(**fields), device="cpu")
    assert r_t.iters == r_j.iters
    assert r_t.time == r_j.time
    assert float(np.abs(r_t.x - r_j.x).sum()) <= 1e-13
    assert r_t.global_resid_l1 == pytest.approx(r_j.global_resid_l1,
                                                rel=1e-6, abs=1e-15)


@pytest.mark.parametrize("kind", ["power", "linear"])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_block_update_matches_reference(small_op, t_small, kind, p):
    """Every block update of BlockLocalSolver against the JAX package's,
    from a seeded view: within 1e-18 (the P^T product is scipy's bits;
    the masses may differ in their last bit)."""
    j_s = j_rt.BlockLocalSolver(small_op, j_block_rows(small_op.n, p),
                                kind=kind)
    t_s = t_rt.BlockLocalSolver(t_small, t_block_rows(small_op.n, p),
                                kind=kind, device="cpu")
    x = np.random.default_rng(p).random(small_op.n) / small_op.n
    for i in range(p):
        y_j = j_s.update_block(i, x)
        y_t = t_s.update_block(i, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-18)
        assert t_s.block_work(i) == j_s.block_work(i)


def test_shard_state_matches_reference():
    """ShardState against the JAX package's, call by call: versions,
    counters, accept/reject and the view."""
    j_part, t_part = j_block_rows(10, 2), t_block_rows(10, 2)
    x0 = np.linspace(0.0, 0.9, 10)
    j_sh = j_rt.ShardState.create(1, j_part, x0)
    t_sh = t_rt.ShardState.create(1, t_part, x0)
    assert t_sh.view.dtype == torch.float64 and t_sh.rows == j_sh.rows
    calls = [
        ("publish", (np.ones(5),)),
        ("import_fragment", (0, np.full(5, 2.0), 0, 0, 5)),
        ("import_fragment", (0, np.full(5, 2.0), 3, 0, 5)),
        ("import_fragment", (0, np.full(5, 9.0), 2, 0, 5)),
        ("import_rows", (0, np.array([1, 2]), np.array([7.0, 8.0]), 5)),
        ("import_rows", (0, np.array([3]), np.array([1.0]), 5)),
        ("publish", (np.full(5, 4.0),)),
        ("import_rows", (0, np.array([0, 4]), np.array([5.0, 6.0]), 6)),
    ]
    for name, args in calls:
        assert getattr(t_sh, name)(*args) == getattr(j_sh, name)(*args)
        np.testing.assert_array_equal(t_sh.view.numpy(), j_sh.view)
        np.testing.assert_array_equal(t_sh.fragment().numpy(),
                                      j_sh.fragment())
        np.testing.assert_array_equal(t_sh.frag_version, j_sh.frag_version)
        assert (t_sh.produced, t_sh.iters) == (j_sh.produced, j_sh.iters)
    for owner in range(2):
        assert t_sh.staleness_of(owner, 9) == j_sh.staleness_of(owner, 9)


PLAN_KW = dict(cancel_limit=2, max_backoff=8, thresh=0.05, refresh_every=3)


@pytest.mark.parametrize("policy,top_k", [
    ("all_to_all", None), ("ring", None), ("adaptive", None),
    ("sparsified", None), ("sparsified", 5), ("sparsified", "adaptive")])
def test_plans_match_reference(policy, top_k):
    """Each host plan against the JAX package's, driven by one seeded
    script of gates, payloads and send results: every answer equal, the
    payload rows included (ties among |delta| included)."""
    p = 4
    j_plan = j_rt.make_plan(policy, p, top_k=top_k, **PLAN_KW)
    t_plan = t_rt.make_plan(policy, p, top_k=top_k, **PLAN_KW)
    assert t_plan.name == j_plan.name
    assert type(t_plan).__name__ == type(j_plan).__name__
    rng = np.random.default_rng(3)
    for it in range(1, 40):
        for i in range(p):
            # quantized deltas: many exact ties
            delta = np.round(rng.random(23) ** 3, 2)
            if it % 7 == 0:
                delta[:] = 0.0
            for d in rng.permutation(p):
                d = int(d)
                if d == i:
                    continue
                mass = float(rng.random() * 0.1)
                ans = [(pl.wants(i, d, it), pl.gate_mass(i, d, it, mass),
                        pl.refresh_due(i, d, it)) for pl in (t_plan, j_plan)]
                assert ans[0] == ans[1]
                rows = [pl.payload_rows(delta, i, d)
                        for pl in (t_plan, j_plan)]
                assert (rows[0] is None) == (rows[1] is None)
                if rows[0] is not None:
                    np.testing.assert_array_equal(rows[0], rows[1])
                ok = bool(rng.random() < 0.6)
                for pl in (t_plan, j_plan):
                    pl.on_result(i, d, ok)
                    pl.note_sent(i, d, it, full=rows[1] is None)
    for attr in ("backoff", "consec_cancels", "last_full", "_k_ewma"):
        if hasattr(j_plan, attr):
            np.testing.assert_array_equal(getattr(t_plan, attr),
                                          getattr(j_plan, attr))
    with pytest.raises(ValueError):
        t_rt.make_plan("warp", p)


def test_des_needs_a_card_unless_told(t_small, monkeypatch):
    """device=None means the CUDA card: without one the DES raises rather
    than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    afp = t_core.AsyncFixedPoint(t_small)
    for solve in (afp.solve_des, afp.solve_des_sync):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve(p=2, cfg=t_core.DESConfig(max_iters=3))


def test_des_config_fields_match_reference():
    """DESConfig carries the JAX package's fields and defaults."""
    j_f = {f.name: f.default for f in dataclasses.fields(j_core.DESConfig)}
    t_f = {f.name: f.default for f in dataclasses.fields(t_core.DESConfig)}
    assert t_f == j_f


@pytest.mark.parametrize("seed", [7, 3])
def test_paper_des_config_matches_reference(seed):
    """The paper's DES testbed (Tables 1-2) equals the JAX package's,
    field for field."""
    from repro.configs.pagerank import paper_des_config as j_paper
    from repro_torch.configs.pagerank import paper_des_config
    cfg = paper_des_config(seed)
    assert isinstance(cfg, t_core.DESConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_paper(seed))
    assert dataclasses.asdict(paper_des_config()) == dataclasses.asdict(
        j_paper())
