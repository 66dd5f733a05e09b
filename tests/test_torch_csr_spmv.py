"""The CSR segment-sum kernel's plain version and its dispatch, on the CPU.

`kernels/csr_spmv` computes y = P^T x over the row-sorted edge list with an
indptr. Its plain version (`index_select` + `index_add_`) is held against
the JAX package's gather + `segment_sum` (`repro.graph.csr.pt_matvec`) on
the session fixture's 2,000-page operator: float64 to 1e-12 (only the order
of the adds differs), float32 to 1e-6 relative to the largest entry (the
same, at float32's spacing). The kernel itself runs only on the card
(tests/test_torch_gpu.py): here its wrapper must refuse CPU tensors, and
"auto" must take the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph.csr as jcsr
from repro_torch.graph import csr as tcsr
from repro_torch.interop import operator_from_arrays
from repro_torch.kernels.csr_spmv import LAUNCHES, csr_spmv, csr_spmv_ref

from _torch_parity import op_arrays, x64

CPU = torch.device("cpu")
TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


@pytest.fixture(scope="module")
def port_op(small_op):
    return operator_from_arrays(op_arrays(small_op))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nv", [1, 3, 8])
def test_plain_matches_reference(small_op, port_op, dtype, nv):
    pt = small_op.pt
    x = np.random.default_rng(nv).random((pt.n, nv))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with x64():
        y_ref = np.asarray(jcsr.pt_matvec(pt.device_arrays(jdt),
                                          jnp.asarray(x, jdt), pt.n))
    dev = port_op.pt.device_arrays(dtype, CPU)
    xt = torch.as_tensor(x).to(dtype)
    y = csr_spmv_ref(dev["row_ids"], dev["src"], dev["weight"], xt, pt.n)
    assert y.dtype == dtype and y.shape == (pt.n, nv)
    scale = np.abs(y_ref).max()
    assert np.abs(y.numpy() - y_ref).max() <= TOL[dtype] * scale
    # pt_matvec dispatches CPU tensors to the plain version
    before = dict(LAUNCHES)
    np.testing.assert_array_equal(tcsr.pt_matvec(dev, xt, pt.n).numpy(),
                                  y.numpy())
    assert LAUNCHES == before
    # a lane of the plain version alone gives the same bits (CPU order)
    y1 = csr_spmv_ref(dev["row_ids"], dev["src"], dev["weight"],
                      xt[:, nv - 1].contiguous(), pt.n)
    np.testing.assert_array_equal(y1.numpy(), y[:, nv - 1].numpy())


def test_device_arrays_upload_indptr(port_op):
    dev = port_op.pt.device_arrays(torch.float32, CPU)
    assert dev["indptr"].dtype == torch.int64
    np.testing.assert_array_equal(dev["indptr"].numpy(), port_op.pt.indptr)
    assert dev["indptr"].shape == (port_op.n + 1,)


def test_block_dispatch_matches_full(port_op):
    pt = port_op.pt
    lo, hi = 300, 700
    e0, e1 = pt.indptr[lo], pt.indptr[hi]
    block = dict(src=torch.as_tensor(pt.src[e0:e1]),
                 weight=torch.as_tensor(pt.weight[e0:e1]),
                 row_ids=torch.as_tensor(pt.row_ids[e0:e1] - lo))
    x = torch.as_tensor(np.random.default_rng(1).random((pt.n, 2)))
    full = tcsr.pt_matvec(pt.device_arrays(torch.float64, CPU), x, pt.n)
    y = tcsr.pt_matvec_block(block, x, hi - lo, lo)
    np.testing.assert_allclose(y.numpy(), full[lo:hi].numpy(), rtol=0,
                               atol=1e-15)


def test_kernel_refuses_cpu_tensors(port_op):
    dev = port_op.pt.device_arrays(torch.float32, CPU)
    x = torch.ones(port_op.n)
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmv(dev["indptr"], dev["src"], dev["weight"], x, port_op.n)
    with pytest.raises(ValueError, match="CUDA"):
        tcsr.pt_matvec(dev, x, port_op.n, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        tcsr.pt_matvec(dev, x, port_op.n, impl="pallas")


def test_hub_lane_refuses_cpu_and_mistyped_operands():
    """The hub lane's wrapper launches on CUDA tensors only, and refuses
    operands of another type before it looks at their device."""
    from repro_torch.kernels.csr_spmv import csr_spmv_hub_add
    indptr = torch.tensor([0, 1, 2])
    src = torch.tensor([0, 1], dtype=torch.int32)
    w, x = torch.ones(2), torch.ones((2, 1))
    row_map = torch.tensor([1, 3], dtype=torch.int32)
    y = torch.zeros((4, 1))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmv_hub_add(indptr, src, w, x, row_map, y)
    for bad in [(indptr, src, w.double(), x, row_map, y),
                (indptr, src, w, x.double(), row_map, y),
                (indptr, src, w, x, row_map, y.double()),
                (indptr, src, w, x, row_map.long(), y),
                (indptr, src.long(), w, x, row_map, y),
                (indptr.int(), src, w, x, row_map, y)]:
        with pytest.raises(TypeError):
            csr_spmv_hub_add(*bad)
    with pytest.raises(ValueError, match="shape"):
        csr_spmv_hub_add(indptr, src, w, x, row_map[:1], y)
    assert LAUNCHES == before and y.abs().sum() == 0


@pytest.mark.parametrize("nv", [1, 2, 5])
@pytest.mark.parametrize("lengths", [(1,), (3, 1, 40), (0,)],
                         ids=["one-edge", "three-rows", "no-rows"])
def test_hub_add_plain_rounds_float64_sum_once(lengths, nv):
    """The hub lane's plain version adds float32(the float64 sum of each
    row's float64 products) into y[row_map] in place, and leaves y's other
    rows as they were."""
    from repro_torch.kernels.csr_spmv import csr_spmv_hub_add_ref
    lengths = [n for n in lengths if n]
    rng = np.random.default_rng(len(lengths) * 10 + nv)
    n_cols, n_out = 50, 12
    indptr = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])
    src = rng.integers(0, n_cols, indptr[-1]).astype(np.int32)
    w = rng.random(indptr[-1]).astype(np.float32)
    x = rng.random((n_cols, nv)).astype(np.float32)
    row_map = np.sort(rng.choice(n_out, len(lengths),
                                 replace=False)).astype(np.int32)
    y0 = rng.random((n_out, nv)).astype(np.float32)
    expect = y0.copy()
    for i, r in enumerate(row_map):
        acc = np.zeros(nv)
        for e in range(indptr[i], indptr[i + 1]):
            acc += np.float64(w[e]) * x[src[e]].astype(np.float64)
        expect[r] = y0[r] + acc.astype(np.float32)
    y = torch.as_tensor(y0.copy())
    out = csr_spmv_hub_add_ref(*(torch.as_tensor(a) for a in
                                 (indptr, src, w, x, row_map)), y)
    assert out is y
    np.testing.assert_array_equal(y.numpy(), expect)
