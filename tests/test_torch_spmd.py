"""Parity of repro_torch's bulk-synchronous shard program (`solve_spmd`)
with the JAX package's, on the CPU.

The JAX package's `solve_spmd` needs one device per shard, so a module
fixture runs every reference case once, in ONE subprocess with four forced
host devices (`_subproc`; about 15 s), and writes the results to an .npz in
tmp_path. The port then runs the same cases in this process on
`device="cpu"` (its kernels' plain versions), the p = 4 shards on one
leading tensor axis. The graphs are the reference tests' own: the seeded
5,000-page graph of `test_golden_spmd_supersteps_4dev` and the 800-page
graph of `test_spmd_adaptive_k_and_lane_compaction_4dev`.

Tolerances, and why:
  * float64 (segment_sum, tol 1e-10): every schedule, delivery drops,
    adaptive sparsified, lane freezing and compaction give exactly the
    reference's supersteps, comm bytes, rows sent, lane supersteps and
    chunks, and x within 1e-12. Rounding cannot move a decision there, so
    this is where the two programs are held to be the same program.
  * float32 at the reference tests' tol 1e-7: the counts are set by
    float32 rounding. Near the end the largest pages' deltas sit at
    1-2e-7, the noise of their float32 sums, and a sum taken in another
    order moves them by ~10%. The port differs from the reference in two
    sums on purpose: the total and dangling masses over a view are
    `runtime.step.tree_sum`s (XLA's reduction order depends on the lane
    count), and the bsr hub rows sum in float64 (the reference's sum in
    float32). With the reference's arithmetic for those two sums (a
    test-side patch: `jnp.sum` and a float32 hub sum) the port gives
    exactly the golden 26 / 48 / 64 / 77 (allgather / allgather_k / ring /
    ring at delivery 0.7) on both backends. As shipped, segment_sum gives
    26 / 48 / 61 / 77: ring at delivery 1 ends on a flip between 61 and 64
    that both programs show (each gives 61 at tol x 1.2 and 64 at
    tol / 1.2); bsr is held to +-2 (24 against 26, 65 against 64).
    Comm bytes are exact, x within 1e-6 of the reference's and 5e-6 of
    the float64 oracle. The reference's own float32 bits depend on how XLA
    compiles its update (jitted and eager differ), so no port can be held
    to them bit for bit.
  * float32 sparsified: x within 5e-6 of the oracle, at most half of
    allgather's bytes, rows shipped, and supersteps within +-10% of the
    reference's: its top-k choice reacts to rounding, as the reference's
    own two backends show (36 supersteps and 21,216 rows on segment_sum,
    32 and 18,840 on bsr_pallas, from one graph).
  * float32 lanes (tol 1e-8 on 800 pages, 1e-7 on 5,000): lane
    supersteps within 3 of the reference's, since the reference's own two
    backends differ by up to 2 on the same lanes; on 800 pages tol is
    under two float32 spacings of the largest rank, so a lane stops when
    its top page moves by one ulp rather than two. pow2 lane compaction
    gives the masked run's x bit for bit and the same lane supersteps (on
    bsr with the float32 hub sum: with the port's float64 sum the eight
    lanes all stop within one superstep, and nothing is left to compact).
"""
import dataclasses

import numpy as np
import pytest

from _subproc import run_with_devices

from repro_torch.core import (AsyncFixedPoint, SPMDConfig, solve_linear,
                              solve_power, solve_spmd)
from repro_torch.graph import (GoogleOperator, TransitionT, exact_pagerank,
                               powerlaw_webgraph)

REF_CODE = r'''
import sys
import numpy as np
from repro.graph.generate import powerlaw_webgraph
from repro.graph.csr import TransitionT
from repro.graph.google import GoogleOperator
from repro.core import SPMDConfig, solve_spmd

out = {}


def keep(name, r):
    out[name + "__x"] = np.asarray(r.x)
    for k in ("supersteps", "comm_bytes_total", "rows_sent", "lane_chunks"):
        out[name + "__" + k] = np.asarray(getattr(r, k))
    if r.lane_supersteps is not None:
        out[name + "__lane_supersteps"] = np.asarray(r.lane_supersteps)


g = powerlaw_webgraph(n=5000, target_nnz=40000, n_dangling=20, seed=9)
op = GoogleOperator(pt=TransitionT.from_graph(g), alpha=0.85)
base = dict(p=4, tol=1e-7, dtype="float32", max_supersteps=3000, seed=9,
            sync_every=4)
for backend in ("segment_sum", "bsr_pallas"):
    for sched, q in (("allgather", 1.0), ("allgather_k", 1.0),
                     ("ring", 1.0), ("ring", 0.7), ("sparsified", 1.0)):
        keep(f"g5_{backend}_{sched}_{q}", solve_spmd(op, SPMDConfig(
            schedule=sched, delivery_prob=q, backend=backend, **base)))
    keep(f"g5_{backend}_adaptive", solve_spmd(op, SPMDConfig(
        schedule="sparsified", backend=backend, sparsify_adaptive=True,
        sparsify_cover_frac=0.8, **base)))
# ring at delivery 1 on either side of its flip
for f in RING_TOL_FACTORS:
    keep(f"g5_segment_sum_ring_tolx{f:.4f}", solve_spmd(op, SPMDConfig(
        schedule="ring", **dict(base, tol=base["tol"] * f))))
rng = np.random.default_rng(0)
V = rng.random((op.n, 4))
V /= V.sum(axis=0)
keep("g5_lanes_linear", solve_spmd(op, SPMDConfig(
    schedule="allgather", kind="linear", freeze_lanes=True, **base), v=V))

g = powerlaw_webgraph(n=800, target_nnz=6000, n_dangling=5, seed=3)
op = GoogleOperator(pt=TransitionT.from_graph(g), alpha=0.85)
small = dict(p=4, tol=1e-8, max_supersteps=500, sparsify_refresh_every=8)
keep("g8_fixed", solve_spmd(op, SPMDConfig(schedule="sparsified", **small)))
keep("g8_adaptive", solve_spmd(op, SPMDConfig(
    schedule="sparsified", sparsify_adaptive=True, sparsify_cover_frac=0.8,
    **small)))
rng = np.random.default_rng(0)
V = np.abs(rng.random((g.n, 8)))
V = V / V.sum(0)
lanes = dict(p=4, schedule="allgather", tol=1e-8, max_supersteps=600,
             freeze_lanes=True)
for backend in ("segment_sum", "bsr_pallas"):
    keep(f"g8_{backend}_masked", solve_spmd(op, SPMDConfig(
        backend=backend, **lanes), v=V))
    keep(f"g8_{backend}_compact", solve_spmd(op, SPMDConfig(
        backend=backend, compact_lanes=True, **lanes), v=V))
# float64: the same program where rounding cannot move a decision
import jax
jax.config.update("jax_enable_x64", True)
g = powerlaw_webgraph(n=5000, target_nnz=40000, n_dangling=20, seed=9)
op = GoogleOperator(pt=TransitionT.from_graph(g), alpha=0.85)
f64 = dict(p=4, tol=1e-10, dtype="float64", max_supersteps=3000, seed=9,
           sync_every=4)
for sched, q in F64_CASES:
    keep(f"f64_{sched}_{q}", solve_spmd(op, SPMDConfig(
        schedule=sched, delivery_prob=q, **f64)))
keep("f64_adaptive", solve_spmd(op, SPMDConfig(
    schedule="sparsified", sparsify_adaptive=True, sparsify_cover_frac=0.8,
    **f64)))
V = f64_lanes(g.n)
lanes = dict(f64, schedule="allgather", freeze_lanes=True)
keep("f64_masked", solve_spmd(op, SPMDConfig(**lanes), v=V))
keep("f64_compact", solve_spmd(op, SPMDConfig(compact_lanes=True, **lanes),
                               v=V))
keep("f64_linear", solve_spmd(op, SPMDConfig(kind="linear", **lanes),
                              v=V[:, 4:]))
np.savez(sys.argv[1], **out)
print("reference cases done")
'''

F64_CASES = [("allgather", 1.0), ("allgather_k", 1.0), ("ring", 1.0),
             ("ring", 0.7), ("sparsified", 1.0), ("sparsified", 0.7)]
RING_TOL_FACTORS = (1.2, 1 / 1.2)


def f64_lanes(n):
    """Eight lanes that finish at different supersteps: four spread
    teleports and four concentrated on 1, 2, 5 and 20 seed pages."""
    rng = np.random.default_rng(0)
    v = np.abs(rng.random((n, 8)))
    v /= v.sum(0)
    v[:, 4:] = 0.0
    for j, k in enumerate((1, 2, 5, 20)):
        v[rng.choice(n, size=k, replace=False), 4 + j] = 1.0 / k
    return v


G5 = dict(p=4, tol=1e-7, dtype="float32", max_supersteps=3000, seed=9,
          sync_every=4)
G8_SPARSE = dict(p=4, tol=1e-8, max_supersteps=500, sparsify_refresh_every=8)
G8_LANES = dict(p=4, schedule="allgather", tol=1e-8, max_supersteps=600,
                freeze_lanes=True)
BACKENDS = ("segment_sum", "bsr_pallas")
DENSE = [("allgather", 1.0), ("allgather_k", 1.0), ("ring", 1.0),
         ("ring", 0.7)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference case, from one subprocess with 4 host devices."""
    path = tmp_path_factory.mktemp("spmd_ref") / "ref.npz"
    import inspect
    code = ("import sys\nsys.argv = ['ref', %r]\n" % str(path)
            + f"F64_CASES = {F64_CASES!r}\n"
            + f"RING_TOL_FACTORS = {RING_TOL_FACTORS!r}\n"
            + inspect.getsource(f64_lanes)
            + REF_CODE)
    out = run_with_devices(code, n_devices=4, timeout=600)
    assert "reference cases done" in out
    data = np.load(path)
    return {k: data[k] for k in data.files}


def _op(n, target_nnz, n_dangling, seed):
    g = powerlaw_webgraph(n=n, target_nnz=target_nnz, n_dangling=n_dangling,
                          seed=seed)
    return GoogleOperator(pt=TransitionT.from_graph(g), alpha=0.85)


@pytest.fixture(scope="module")
def g5():
    op = _op(5000, 40000, 20, 9)
    return op, exact_pagerank(op, tol=1e-13)


@pytest.fixture(scope="module")
def g8():
    op = _op(800, 6000, 5, 3)
    return op, exact_pagerank(op, tol=1e-13)


def _lanes(n, nv, rng):
    v = np.abs(rng.random((n, nv)))
    return v / v.sum(0)


F64 = dict(p=4, tol=1e-10, dtype="float64", max_supersteps=3000, seed=9,
           sync_every=4)


def _same_run(r, ref, name, x_atol):
    assert r.supersteps == int(ref[name + "__supersteps"])
    assert r.comm_bytes_total == int(ref[name + "__comm_bytes_total"])
    assert r.rows_sent == int(ref[name + "__rows_sent"])
    assert r.lane_chunks == int(ref[name + "__lane_chunks"])
    assert np.abs(r.x - ref[name + "__x"]).max() <= x_atol


@pytest.mark.parametrize("sched,q", F64_CASES + [("adaptive", 1.0)])
def test_f64_exact(ref, g5, sched, q):
    op, xref = g5
    if sched == "adaptive":
        name = "f64_adaptive"
        cfg = SPMDConfig(schedule="sparsified", sparsify_adaptive=True,
                         sparsify_cover_frac=0.8, **F64)
    else:
        name = f"f64_{sched}_{q}"
        cfg = SPMDConfig(schedule=sched, delivery_prob=q, **F64)
    r = solve_spmd(op, cfg, device="cpu")
    _same_run(r, ref, name, 1e-12)
    assert np.abs(r.x - xref).max() < 1e-9
    if sched in ("sparsified", "adaptive"):
        assert r.rows_sent > 0


@pytest.mark.parametrize("run", ["masked", "compact", "linear"])
def test_f64_lanes_exact(ref, g5, run):
    op, _ = g5
    V = f64_lanes(op.n)
    cfg = SPMDConfig(schedule="allgather", freeze_lanes=True,
                     compact_lanes=run == "compact",
                     kind="linear" if run == "linear" else "power", **F64)
    r = solve_spmd(op, cfg, v=V[:, 4:] if run == "linear" else V,
                   device="cpu")
    name = f"f64_{run}"
    _same_run(r, ref, name, 1e-12)
    np.testing.assert_array_equal(r.lane_supersteps,
                                  ref[name + "__lane_supersteps"])
    assert r.lane_supersteps.max() == r.supersteps
    if run == "compact":
        assert r.lane_chunks > 1
        assert len(set(r.lane_supersteps.tolist())) > 1


@pytest.fixture
def f32_hub(monkeypatch):
    """The bsr hub rows summed in float32, as the JAX package sums them
    (the port sums them in float64)."""
    import torch

    from repro_torch.kernels.bsr_spmv.ops import bsr_matvec
    from repro_torch.runtime import step

    def f32_hub_matvec(dev, x, impl="auto", accum="f32"):
        y = bsr_matvec(dev["blocks"], dev["blk_cols"], x, impl=impl,
                       accum=accum, device=x.device,
                       blk_count=dev["blk_count"])
        nbr, bm, nv = y.shape
        contrib = dev["hub_vals"].float()[:, None] * x.reshape(
            -1, nv).index_select(0, dev["hub_cols"])
        rows = torch.repeat_interleave(dev["hub_map"].long(),
                                       torch.diff(dev["hub_indptr"]))
        return y + contrib.new_zeros((nbr * bm, nv)).index_add_(
            0, rows, contrib).reshape(nbr, bm, nv)

    monkeypatch.setattr(step, "hybrid_matvec", f32_hub_matvec)


@pytest.fixture
def reference_arithmetic(f32_hub, monkeypatch):
    """The port with the JAX package's arithmetic for the two sums it
    takes differently: the bsr hub rows in float32 (`f32_hub`), and the
    masses over a view by XLA's `jnp.sum`, whose order depends on the lane
    count (the port's `tree_sum` fixes it)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro_torch.runtime import step

    colsum = jax.jit(lambda a: jnp.sum(a, axis=0))

    def xla_sum(a):
        return torch.stack([torch.as_tensor(np.array(colsum(s.numpy())))
                            for s in a])

    monkeypatch.setattr(step, "tree_sum", xla_sum)


def _dense_f32(ref, xref, r, name):
    """A dense schedule's float32 run against the reference's, apart from
    its superstep count."""
    want = int(ref[name + "__supersteps"])
    # the dense schedules' bytes are a per-superstep model
    assert r.comm_bytes_total * want == int(
        ref[name + "__comm_bytes_total"]) * r.supersteps
    assert r.rows_sent == 0
    assert np.abs(r.x - ref[name + "__x"]).max() <= 1e-6
    assert np.abs(r.x - xref).max() < 5e-6
    assert np.abs(ref[name + "__x"] - xref).max() < 5e-6


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("sched,q", DENSE)
def test_dense_schedules_f32(ref, g5, reference_arithmetic, backend, sched,
                             q):
    """With the reference's sum orders and hub precision, the golden
    counts exactly, on both backends."""
    op, xref = g5
    name = f"g5_{backend}_{sched}_{q}"
    r = solve_spmd(op, SPMDConfig(schedule=sched, delivery_prob=q,
                                  backend=backend, **G5), device="cpu")
    assert r.supersteps == int(ref[name + "__supersteps"])
    _dense_f32(ref, xref, r, name)


@pytest.mark.parametrize("sched,q", DENSE)
def test_segment_sum_tree_sums(ref, g5, sched, q):
    """The port as shipped on segment_sum: the golden counts, but for ring
    at delivery 1, which ends on a flip. There the port's counts at
    tol x 1.2 and tol / 1.2 equal the reference's at the same tols, and
    each program's count at tol is one of the two."""
    op, xref = g5
    name = f"g5_segment_sum_{sched}_{q}"
    cfg = SPMDConfig(schedule=sched, delivery_prob=q, **G5)
    r = solve_spmd(op, cfg, device="cpu")
    want = int(ref[name + "__supersteps"])
    if (sched, q) == ("ring", 1.0):
        sides = []
        for f in RING_TOL_FACTORS:
            got = solve_spmd(op, dataclasses.replace(cfg, tol=cfg.tol * f),
                             device="cpu").supersteps
            assert got == int(
                ref[f"g5_segment_sum_ring_tolx{f:.4f}__supersteps"]), f
            sides.append(got)
        assert sides[0] < sides[1]
        assert want in sides and r.supersteps in sides
    else:
        assert r.supersteps == want
    _dense_f32(ref, xref, r, name)


def test_reference_f32_bits_depend_on_compilation():
    """Why float32 parity is held to counts, not bits: the JAX package's
    own local update, jitted and run op by op on the same view, differs in
    the last bits (XLA fuses the update's elementwise chain)."""
    import jax
    import jax.numpy as jnp

    from repro.core.partition import block_rows, slice_transition
    from repro.core.spmd import col_map_seg
    from repro.graph.csr import TransitionT as RefTransitionT
    from repro.graph.generate import powerlaw_webgraph as ref_graph
    from repro.runtime import step as ref_step

    n, p = 5000, 4
    pt = RefTransitionT.from_graph(ref_graph(n=n, target_nnz=40000,
                                             n_dangling=20, seed=9))
    part = block_rows(n, p)
    bsize = int(part.sizes().max())
    b = slice_transition(pt, part, 0)
    op_slice = (jnp.asarray(col_map_seg(part, bsize, b["src"])),
                jnp.asarray(np.asarray(b["weight"], np.float32)),
                jnp.asarray(b["row_ids"].astype(np.int32)))
    update = ref_step.shard_local_update(
        ref_step.shard_pt_apply(op_slice, use_bsr=False, bsize=bsize, nv=1),
        alpha=0.85, linear=False, n=n,
        vb=jnp.full((bsize, 1), 1.0 / n, jnp.float32),
        val=jnp.ones(bsize, jnp.float32), dang=jnp.asarray(pt.dangling))
    view = jnp.full((n, 1), 1.0 / n, jnp.float32)
    jitted = np.asarray(jax.jit(update)(view))
    eager = np.asarray(update(view))
    assert np.abs(jitted - eager).max() <= 1e-6 * np.abs(eager).max()
    assert (jitted != eager).any()


def test_golden_supersteps(ref):
    """The reference's own golden counts (test_runtime.py:299-321) hold in
    the reference run the parity tests compare against."""
    for backend in BACKENDS:
        for (sched, q), want in zip(DENSE, (26, 48, 64, 77)):
            got = int(ref[f"g5_{backend}_{sched}_{q}__supersteps"])
            assert got == want, (backend, sched, q, got)


@pytest.mark.parametrize("sched,q", DENSE)
def test_bsr_f64_hub_close(ref, g5, sched, q):
    """The port's default float64 hub sum: the same answer, and supersteps
    within 2 of the reference's float32-noise-set counts."""
    op, xref = g5
    name = f"g5_bsr_pallas_{sched}_{q}"
    r = solve_spmd(op, SPMDConfig(schedule=sched, delivery_prob=q,
                                  backend="bsr", **G5), device="cpu")
    assert abs(r.supersteps - int(ref[name + "__supersteps"])) <= 2
    assert np.abs(r.x - ref[name + "__x"]).max() <= 1e-6
    assert np.abs(r.x - xref).max() < 5e-6


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("adaptive", [False, True])
def test_sparsified(ref, g5, backend, adaptive):
    op, xref = g5
    name = (f"g5_{backend}_adaptive" if adaptive
            else f"g5_{backend}_sparsified_1.0")
    extra = (dict(sparsify_adaptive=True, sparsify_cover_frac=0.8)
             if adaptive else {})
    r = solve_spmd(op, SPMDConfig(schedule="sparsified", backend=backend,
                                  **G5, **extra),
                   device="cpu")
    ag = int(ref[f"g5_{backend}_allgather_1.0__comm_bytes_total"])
    assert np.abs(r.x - xref).max() < 5e-6
    assert r.comm_bytes_total <= 0.5 * ag
    assert r.rows_sent > 0
    want = int(ref[name + "__supersteps"])
    assert abs(r.supersteps - want) <= 0.1 * want, (r.supersteps, want)


def test_sparsified_adaptive_ships_fewer_rows(ref, g8):
    """The reference test's adaptive case (800 pages, refresh every 8,
    cover 0.8): adaptive ships fewer rows and bytes than the fixed
    budget."""
    op, xref = g8
    fixed = solve_spmd(op, SPMDConfig(schedule="sparsified", **G8_SPARSE),
                       device="cpu")
    adapt = solve_spmd(op, SPMDConfig(schedule="sparsified",
                                      sparsify_adaptive=True,
                                      sparsify_cover_frac=0.8, **G8_SPARSE),
                       device="cpu")
    for r, name in ((fixed, "g8_fixed"), (adapt, "g8_adaptive")):
        assert np.abs(r.x - xref).max() < 5e-6
        want = int(ref[name + "__supersteps"])
        assert abs(r.supersteps - want) <= 0.1 * want, (name, r.supersteps)
        assert r.supersteps < G8_SPARSE["max_supersteps"]
    assert 0 < adapt.rows_sent < fixed.rows_sent
    assert adapt.comm_bytes_total < fixed.comm_bytes_total
    assert int(ref["g8_adaptive__rows_sent"]) < int(
        ref["g8_fixed__rows_sent"])


def test_sparsified_under_drops(g5):
    """The forced refresh is delivery-reliable, so sparsified reaches the
    fixed point under delivery_prob < 1."""
    op, xref = g5
    r = solve_spmd(op, SPMDConfig(schedule="sparsified", delivery_prob=0.7,
                                  **dict(G5, tol=1e-8, max_supersteps=4000)),
                   device="cpu")
    assert r.supersteps < 4000
    assert np.abs(r.x - xref).max() < 5e-6


def test_lanes_linear_freeze(ref, g5):
    op, _ = g5
    V = np.random.default_rng(0).random((op.n, 4))
    V /= V.sum(axis=0)
    r = solve_spmd(op, SPMDConfig(schedule="allgather", kind="linear",
                                  freeze_lanes=True, **G5), v=V,
                   device="cpu")
    assert r.x.shape == (op.n, 4)
    want = ref["g5_lanes_linear__lane_supersteps"]
    assert np.abs(r.lane_supersteps - want).max() <= 3, (
        r.lane_supersteps, want)
    assert r.lane_supersteps.max() == r.supersteps
    assert r.comm_bytes_total == r.supersteps * int(
        ref["g5_lanes_linear__comm_bytes_total"]) // int(
        ref["g5_lanes_linear__supersteps"])
    for j in range(4):
        want_x = solve_linear(op, tol=1e-12, v=V[:, j], device="cpu").x
        assert np.abs(r.x[:, j] - want_x).max() < 5e-6, j


@pytest.mark.parametrize("backend", BACKENDS)
def test_lane_compaction(ref, g8, backend, request):
    op, xref = g8
    if backend == "bsr_pallas":
        # with the port's float64 hub sum the eight lanes all stop at
        # supersteps 22-23, which leaves compaction nothing to shrink; with
        # the reference's float32 hub sum they spread as in its own run
        request.getfixturevalue("f32_hub")
    V = _lanes(op.n, 8, np.random.default_rng(0))
    cfg = SPMDConfig(backend=backend, **G8_LANES)
    masked = solve_spmd(op, cfg, v=V, device="cpu")
    compact = solve_spmd(op, dataclasses.replace(cfg, compact_lanes=True),
                         v=V, device="cpu", observe=True)
    for r, name in ((masked, "masked"), (compact, "compact")):
        key = f"g8_{backend}_{name}"
        want = ref[key + "__lane_supersteps"]
        assert np.abs(r.lane_supersteps - want).max() <= 3, (
            name, r.lane_supersteps, want)
        assert np.abs(r.x - ref[key + "__x"]).max() <= 1e-6
    # rounding sets these counts: the reference's own backends disagree on
    # them, and tol is under two float32 spacings of the largest rank
    a, b = (ref[f"g8_{be}_masked__lane_supersteps"] for be in BACKENDS)
    assert (a != b).any()
    assert G8_LANES["tol"] < 2 * np.spacing(np.float32(compact.x.max()))
    assert int(ref[f"g8_{backend}_compact__lane_chunks"]) > 1
    assert masked.lane_chunks == 1 and compact.lane_chunks > 1
    # the CSR product's, the block product's and the lane sums' order does
    # not depend on the lane count on the CPU, so compaction gives the
    # masked run's bits (on the card, tests/test_torch_gpu.py)
    np.testing.assert_array_equal(masked.lane_supersteps,
                                  compact.lane_supersteps)
    assert np.abs(masked.x - compact.x).max() == 0.0
    assert compact.comm_bytes_total < masked.comm_bytes_total
    for j in range(8):
        want_x = solve_power(op, tol=1e-13, v=V[:, j], device="cpu").x
        assert np.abs(compact.x[:, j] - want_x).max() < 5e-6, j
    # the observe contract: the chunk log sums to the totals
    log = compact.chunk_log
    assert len(log) == compact.lane_chunks and log[0]["lanes"] == 8
    assert sum(c["bytes"] for c in log) == compact.comm_bytes_total
    assert sum(c["rows"] for c in log) == compact.rows_sent
    assert sum(c["steps"] for c in log) == compact.supersteps
    for c in log:
        assert c["wall_ms"] > 0 and c["apply_ms"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_observe_chunk_log(g8, backend):
    op, _ = g8
    r = solve_spmd(op, SPMDConfig(schedule="sparsified", backend=backend,
                                  **G8_SPARSE), device="cpu", observe=True)
    (c,) = r.chunk_log
    assert c["bytes"] == r.comm_bytes_total and c["rows"] == r.rows_sent
    assert c["steps"] == r.supersteps and c["lanes"] == 1
    assert set(c) >= {"apply_ms", "exchange_ms", "protocol_ms", "gap_ms",
                      "wall_ms"}
    assert solve_spmd(op, SPMDConfig(schedule="sparsified", **G8_SPARSE),
                      device="cpu").chunk_log is None


def test_segment_sum_repeats_itself(g8):
    op, _ = g8
    cfg = SPMDConfig(schedule="ring", delivery_prob=0.7, **G8_SPARSE)
    a = solve_spmd(op, cfg, device="cpu")
    b = solve_spmd(op, cfg, device="cpu")
    assert a.supersteps == b.supersteps
    np.testing.assert_array_equal(a.x, b.x)


def test_config_errors(g8):
    op, _ = g8
    with pytest.raises(ValueError, match="freeze_lanes"):
        solve_spmd(op, SPMDConfig(p=4, compact_lanes=True), device="cpu")
    with pytest.raises(ValueError, match="compact_exit"):
        solve_spmd(op, SPMDConfig(p=4, compact_exit=1.5), device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        solve_spmd(op, SPMDConfig(p=4, schedule="gossip"), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        solve_spmd(op, SPMDConfig(p=4, backend="dense"), device="cpu")
    with pytest.raises(ValueError, match="rows"):
        solve_spmd(op, SPMDConfig(p=4), v=np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        solve_spmd(op, SPMDConfig(p=4, backend="bsr", bsr_impl="cuda"),
                   device="cpu")


@pytest.mark.parametrize("compact_exit", [0.25, 1.0])
def test_compact_exit_fractions(g8, compact_exit):
    """Fractional exits: the stack shrinks at other boundaries, the lanes
    finish at the masked run's supersteps."""
    op, _ = g8
    V = _lanes(op.n, 8, np.random.default_rng(0))
    cfg = SPMDConfig(**G8_LANES)
    masked = solve_spmd(op, cfg, v=V, device="cpu")
    r = solve_spmd(op, dataclasses.replace(cfg, compact_lanes=True,
                                           compact_exit=compact_exit),
                   v=V, device="cpu")
    np.testing.assert_array_equal(r.lane_supersteps, masked.lane_supersteps)
    assert np.abs(r.x - masked.x).max() == 0.0


def test_facade_matches_the_functions_it_wraps(g8):
    op, _ = g8
    afp = AsyncFixedPoint(op, kind="linear", backend="bsr_pallas")
    cfg = SPMDConfig(schedule="ring", delivery_prob=0.7, **G8_SPARSE)
    a = afp.solve_spmd(cfg, device="cpu")
    b = solve_spmd(op, dataclasses.replace(cfg, kind="linear",
                                           backend="bsr_pallas"),
                   device="cpu")
    assert a.supersteps == b.supersteps
    np.testing.assert_array_equal(a.x, b.x)
    s = AsyncFixedPoint(op).solve_sync(tol=1e-12, device="cpu")
    t = solve_power(op, tol=1e-12, dtype=__import__("torch").float64,
                    device="cpu")
    assert s.iters == t.iters
    np.testing.assert_array_equal(s.x, t.x)
    s32 = AsyncFixedPoint(op, kind="linear", backend="bsr").solve_sync(
        tol=1e-6, dtype="float32", device="cpu")
    t32 = solve_linear(op, tol=1e-6, backend="bsr", device="cpu")
    np.testing.assert_array_equal(s32.x, t32.x)
    part = AsyncFixedPoint(op, partition="balanced_nnz").make_partition(4)
    assert part.p == 4 and part.ends[-1] == op.n
    assert AsyncFixedPoint(op).make_partition(3).sizes().tolist() == [
        267, 267, 266]


def test_facade_des_not_ported(g8, monkeypatch):
    """The facade's DES flavors (once NotImplementedError, now ported:
    tests/test_torch_des.py holds them to the JAX package) run the engine
    on the facade's partition and kind, and need the card unless told the
    CPU."""
    from repro_torch.core import AsyncDES, DESConfig, PageRankBlockOperator
    op, _ = g8
    cfg = DESConfig(tol=1e-8, max_iters=400, seed=3)
    afp = AsyncFixedPoint(op, kind="linear", partition="balanced_nnz")
    part = afp.make_partition(4)
    def direct():
        opr = PageRankBlockOperator(op, part, kind="linear", device="cpu")
        return AsyncDES(opr, part, cfg, check_operator=op, device="cpu")
    a, b = afp.solve_des(4, cfg, device="cpu"), direct().run()
    assert a.iters.tolist() == b.iters.tolist() and a.stop_time == b.stop_time
    np.testing.assert_array_equal(a.x, b.x)
    a, b = afp.solve_des_sync(4, cfg, device="cpu"), direct().run_sync()
    assert (a.iters, a.time) == (b.iters, b.time)
    np.testing.assert_array_equal(a.x, b.x)
    monkeypatch.setattr(__import__("torch").cuda, "is_available",
                        lambda: False)
    for call in (lambda: afp.solve_des(4), lambda: afp.solve_des_sync(4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
