"""Parity of repro_torch's graph layer with the JAX package's, on the CPU.

The same seeded inputs go through both packages; the port runs with
device="cpu". Graph generation, CSR/transition packing and reorderings are
numpy on both sides and must agree exactly; the float64 torch matvecs must
agree with the JAX ones to 1e-12 (only the summation order may differ).
"""
import numpy as np
import pytest
import torch

import repro.graph.csr as jcsr
import repro.graph.generate as jgen
import repro.graph.google as jgoogle
import repro.graph.reorder as jreorder
import repro_torch.graph.csr as tcsr
import repro_torch.graph.generate as tgen
import repro_torch.graph.google as tgoogle
import repro_torch.graph.reorder as treorder
from repro_torch.interop import operator_from_arrays

from _torch_parity import op_arrays, x64

CPU = torch.device("cpu")


def assert_same_transition(a, b):
    assert a.n == b.n
    for name in ("indptr", "src", "weight", "row_ids", "dangling"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(n=500, target_nnz=3000, n_dangling=2, seed=2),
    dict(n=2000, target_nnz=16000, n_dangling=10, seed=7),
    dict(n=3000, target_nnz=2000, n_dangling=5, seed=11),   # scale < 1
    dict(n=1000, target_nnz=9000, n_dangling=0, locality=0.0, seed=3),
    dict(n=1200, target_nnz=10000, n_dangling=4, locality=0.93,
         site_size=256, seed=0),
])
def test_powerlaw_webgraph_byte_identical(kw):
    a, b = jgen.powerlaw_webgraph(**kw), tgen.powerlaw_webgraph(**kw)
    assert a.n == b.n
    assert a.indptr.tobytes() == b.indptr.tobytes()
    assert a.indices.tobytes() == b.indices.tobytes()
    assert a.indptr.dtype == b.indptr.dtype
    assert a.indices.dtype == b.indices.dtype


@pytest.mark.parametrize("make", [
    lambda m: m.small_test_graph(),
    lambda m: m.small_test_graph(n=200, avg_deg=4, n_dangling=7, seed=3),
    lambda m: m.cycle_graph(17),
])
def test_small_generators_identical(make):
    a, b = make(jgen), make(tgen)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


def test_stanford_statistics_match():
    assert (tgen.STANFORD_N, tgen.STANFORD_NNZ, tgen.STANFORD_DANGLING) == (
        jgen.STANFORD_N, jgen.STANFORD_NNZ, jgen.STANFORD_DANGLING)


def test_transition_and_graph_views_equal(small_graph):
    g = tcsr.CSRGraph(n=small_graph.n, indptr=small_graph.indptr,
                      indices=small_graph.indices)
    np.testing.assert_array_equal(g.out_degree, small_graph.out_degree)
    np.testing.assert_array_equal(g.dangling_mask, small_graph.dangling_mask)
    assert_same_transition(tcsr.TransitionT.from_graph(g),
                           jcsr.TransitionT.from_graph(small_graph))
    assert (g.to_scipy() != small_graph.to_scipy()).nnz == 0
    b = tcsr.CSRGraph.from_scipy(small_graph.to_scipy())
    np.testing.assert_array_equal(b.indices, small_graph.indices)


def test_from_edges_dedups_like_reference():
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    a = jcsr.CSRGraph.from_edges(50, src, dst)
    b = tcsr.CSRGraph.from_edges(50, src, dst)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("nv", [0, 1, 3])
def test_pt_matvec_f64_matches_reference(small_op, nv):
    """nv = 0 is a single (n,) vector; otherwise an (n, nv) stack."""
    pt = small_op.pt
    rng = np.random.default_rng(nv)
    x = rng.random(pt.n if nv == 0 else (pt.n, nv))
    with x64():
        import jax.numpy as jnp
        y_ref = np.asarray(jcsr.pt_matvec(pt.device_arrays(jnp.float64),
                                          jnp.asarray(x), pt.n))
    op = operator_from_arrays(op_arrays(small_op))
    dev = op.pt.device_arrays(torch.float64, CPU)
    y = tcsr.pt_matvec(dev, torch.as_tensor(x), pt.n).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(y, pt.to_scipy() @ x, rtol=0, atol=1e-12)


def test_pt_matvec_block_matches_reference(small_op):
    pt = small_op.pt
    lo, hi = 300, 700
    e0, e1 = pt.indptr[lo], pt.indptr[hi]
    sl = dict(src=pt.src[e0:e1], weight=pt.weight[e0:e1],
              row_ids=pt.row_ids[e0:e1] - lo)
    x = np.random.default_rng(1).random(pt.n)
    with x64():
        import jax.numpy as jnp
        y_ref = np.asarray(jcsr.pt_matvec_block(
            {k: jnp.asarray(a) for k, a in sl.items()}, jnp.asarray(x),
            hi - lo, lo))
    y = tcsr.pt_matvec_block({k: torch.as_tensor(a) for k, a in sl.items()},
                             torch.as_tensor(x), hi - lo, lo).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-12)


def test_device_arrays_memoized(small_op):
    op = operator_from_arrays(op_arrays(small_op))
    a = op.pt.device_arrays(torch.float64, CPU)
    b = op.pt.device_arrays(torch.float64, CPU)
    c = op.pt.device_arrays(torch.float32, CPU)
    assert a["src"] is b["src"] and a["weight"] is b["weight"]
    assert c["weight"].dtype == torch.float32
    assert a["src"].dtype == torch.int32


@pytest.mark.parametrize("method", ["rcm", "indeg"])
def test_reorder_permutations_equal(small_op, small_graph, method):
    fn = {"rcm": "rcm_permutation", "indeg": "degree_sort_permutation"}
    g = tcsr.CSRGraph(n=small_graph.n, indptr=small_graph.indptr,
                      indices=small_graph.indices)
    np.testing.assert_array_equal(getattr(treorder, fn[method])(g),
                                  getattr(jreorder, fn[method])(small_graph))
    op_j, perm_j = jreorder.reorder_operator(small_op, method)
    op_t, perm_t = treorder.reorder_operator(
        operator_from_arrays(op_arrays(small_op)), method)
    np.testing.assert_array_equal(perm_t, perm_j)
    assert_same_transition(op_t.pt, op_j.pt)
    np.testing.assert_array_equal(treorder.invert(perm_t),
                                  jreorder.invert(perm_j))


def test_google_numpy_oracle_and_torch_apply(small_op):
    op = operator_from_arrays(op_arrays(small_op))
    rng = np.random.default_rng(0)
    x = rng.random(op.n)
    x /= x.sum()
    X = rng.random((op.n, 3))
    np.testing.assert_array_equal(op.apply_numpy(x), small_op.apply_numpy(x))
    np.testing.assert_array_equal(op.apply_linear_numpy(X),
                                  small_op.apply_linear_numpy(X))
    with x64():
        import jax.numpy as jnp
        dev_j = small_op.device_arrays(jnp.float64)
        yj = np.asarray(small_op.apply_jax(dev_j, jnp.asarray(x)))
        ylj = np.asarray(small_op.apply_linear_jax(dev_j, jnp.asarray(x)))
    dev = op.device_arrays(torch.float64, CPU)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(op.apply_torch(dev, xt).numpy(), yj,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(op.apply_linear_torch(dev, xt).numpy(), ylj,
                               rtol=0, atol=1e-12)


def test_exact_pagerank_equal(small_op, exact_x):
    op = operator_from_arrays(op_arrays(small_op))
    np.testing.assert_array_equal(tgoogle.exact_pagerank(op, tol=1e-14),
                                  exact_x)
    np.testing.assert_array_equal(
        tgoogle.exact_pagerank(op, tol=1e-8),
        jgoogle.exact_pagerank(small_op, tol=1e-8))


def test_hybrid_bsr_memoized(small_op):
    op = operator_from_arrays(op_arrays(small_op))
    a = op.hybrid_bsr(bm=16, bn=16)
    assert op.hybrid_bsr(bm=16, bn=16) is a
    assert op.hybrid_bsr(bm=8, bn=8) is not a
