"""The CSR segment-sum kernel's plain version and its dispatch, on the CPU.

`kernels/csr_spmv` computes y = P^T x over the row-sorted edge list with an
indptr. Its plain version (`index_select` + `index_add_`) is held against
the JAX package's gather + `segment_sum` (`repro.graph.csr.pt_matvec`) on
the session fixture's 2,000-page operator: float64 to 1e-12 (only the order
of the adds differs), float32 to 1e-6 relative to the largest entry (the
same, at float32's spacing). The kernel itself runs only on the card
(tests/test_torch_gpu.py): here its wrapper must refuse CPU tensors, and
"auto" must take the plain version. The hub lane's order (its blocks of
512 edges, their scan and the in-launch combine of the rows crossing a
block's end) is rendered in plain float64 (`hub_kernel_sums`) and held
within a float32 ulp of the lane's plain version.
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


def hub_kernel_sums(indptr, src, w, x, chunk=512, threads=128):
    """The hub lane's float64 row sums in the order of its kernel
    (csrc/csr_spmv.cu, `csr_hub_kernel`), in plain numpy: blocks of
    `chunk` consecutive edges, a thread chunk / threads of them; a thread
    walks its edges in order, a multiply-add each (exact float32 products,
    one rounding) into its row's piece from 0; the pieces still open at a
    thread's end joined by the block's segmented inclusive scan (doubling
    steps of 1 to 16 within a warp, then the warps' totals in warp order);
    a row crossing a block's end leaves a piece a block, and the block that
    completes it adds them in block order as 32 contiguous ranges of
    ceil(n / 32), each from its first piece left to right, then the ranges
    left to right. Returns (sums (n_rows, nv), whether each row has
    edges)."""
    per_t = chunk // threads
    n_rows, nnz, nv = len(indptr) - 1, int(indptr[-1]), x.shape[1]
    prod = w.astype(np.float64)[:, None] * x.astype(np.float64)[src]
    sums = np.zeros((n_rows, nv))
    n_chunks = max(1, -(-nnz // chunk))
    part_in = np.zeros((n_chunks, nv))
    part_out = np.zeros((n_chunks, nv))
    for c in range(n_chunks):
        e0, e1 = c * chunk, min((c + 1) * chunk, nnz)
        if e1 <= e0:
            break
        v = np.zeros((threads, nv))
        f = np.ones(threads, bool)
        state = [None] * threads      # (open, rs, r, deferred)
        for t in range(threads):
            es = e0 + t * per_t
            ne = max(0, min(per_t, e1 - es))
            if ne == 0:
                continue
            r = int(np.searchsorted(indptr, es, "right")) - 1
            rs, re = indptr[r], indptr[r + 1]
            acc, deferred = np.zeros(nv), None

            def close():
                nonlocal acc, deferred
                if rs < es:
                    deferred = (r, rs, acc)
                else:
                    sums[r] = acc
                acc = np.zeros(nv)
            for e in range(es, es + ne):
                if e >= re:
                    close()
                    while e >= re:
                        r, rs, re = r + 1, re, indptr[r + 2]
                acc = acc + prod[e]
            is_open = re > es + ne
            if not is_open:
                close()
            f[t], v[t] = (not is_open) or rs >= es, acc
            state[t] = (is_open, rs, r, deferred)
        for wp in range(threads // 32):
            lo = wp * 32
            for off in (1, 2, 4, 8, 16):
                vv, ff = v[lo:lo + 32].copy(), f[lo:lo + 32].copy()
                for lane in range(off, 32):
                    if not ff[lane]:
                        v[lo + lane] = vv[lane - off] + vv[lane]
                    f[lo + lane] = ff[lane] or ff[lane - off]
        wv, wf = v[31::32].copy(), f[31::32].copy()
        ex = np.zeros((threads, nv))
        for t in range(threads):
            wp = t // 32
            pre = wv[0]
            for u in range(1, wp):
                pre = wv[u] if wf[u] else pre + wv[u]
            if wp > 0 and not f[t]:
                v[t] = pre + v[t]
            if t % 32 == 0:
                ex[t] = pre
        for t in range(threads):
            if t % 32:
                ex[t] = v[t - 1]
            if state[t] is None or state[t][3] is None:
                continue
            d_row, d_start, first = state[t][3]
            tot = first if t == 0 else ex[t] + first
            if d_start < e0:
                part_in[c] = tot
            else:
                sums[d_row] = tot
        last = (e1 - 1 - e0) // per_t
        is_open, rs, r, _ = state[last]
        if is_open:
            if rs < e0:
                part_in[c] = v[last]
            else:
                part_out[c] = v[last]
    for r in range(n_rows):
        c0, c1 = indptr[r] // chunk, (indptr[r + 1] - 1) // chunk
        if indptr[r + 1] == indptr[r] or c0 == c1:
            continue
        pieces = [part_out[c0]] + [part_in[cc] for cc in range(c0 + 1,
                                                               c1 + 1)]
        per = -(-len(pieces) // 32)
        ranges = []
        for q0 in range(0, len(pieces), per):
            s = pieces[q0]
            for p in pieces[q0 + 1:q0 + per]:
                s = s + p
            ranges.append(s)
        tot = ranges[0]
        for s in ranges[1:]:
            tot = tot + s
        sums[r] = tot
    return sums, np.diff(indptr) > 0


def _ulps(a, b):
    m = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.abs(a.astype(np.float64) - b) / (
        np.nextafter(m, np.float32(np.inf)) - m)


@pytest.mark.parametrize("nv", [1, 3, 8])
@pytest.mark.parametrize("lengths", [
    (5, 40 * 512 + 3, 9, 2 * 512, 512 + 7, 1),
    (512, 511, 1, 513, 511, 0, 512, 2),
    (768,) * 12,
], ids=["row-over-40-blocks", "rows-on-block-edges", "block-and-a-half"])
def test_hub_kernel_order_within_one_ulp(lengths, nv):
    """The hub lane's chunk-and-combine order (`hub_kernel_sums`, the
    kernel's blocks of 512 edges, its scan and its in-launch combine in
    plain float64) rounded to float32 and added into y: within 1 float32
    ulp of the plain version `csr_spmv_hub_add_ref` (a float64 scatter-add
    in edge order) on a row over 40 blocks, rows ending on block edges
    (and an empty one) and rows of a block and a half, the other rows of
    y untouched; the model's rows and the float64 sums in edge order
    within twice the worst rounding of either (n units of 2^-53 of a row
    of n terms)."""
    from repro_torch.kernels.csr_spmv import csr_spmv_hub_add_ref
    rng = np.random.default_rng(sum(lengths) + nv)
    n_rows, n_cols = len(lengths), 700
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])
    src = rng.integers(0, n_cols, indptr[-1]).astype(np.int32)
    w = (rng.random(indptr[-1]) / rng.integers(1, 50, indptr[-1])).astype(
        np.float32)
    x = rng.random((n_cols, nv)).astype(np.float32)
    n_out = 2 * n_rows + 3
    row_map = np.sort(rng.choice(n_out, n_rows, replace=False)).astype(
        np.int32)
    y0 = rng.random((n_out, nv)).astype(np.float32)
    sums, has = hub_kernel_sums(indptr, src, w, x)
    model = y0.copy()
    model[row_map[has]] = y0[row_map[has]] + sums[has].astype(np.float32)
    ref = csr_spmv_hub_add_ref(*(torch.as_tensor(a) for a in
                                 (indptr, src, w, x, row_map)),
                               torch.as_tensor(y0.copy())).numpy()
    assert _ulps(model, ref.astype(np.float64)).max() <= 1.0
    keep = np.ones(n_out, bool)
    keep[row_map] = False
    np.testing.assert_array_equal(model[keep], y0[keep])
    exact = np.zeros((n_rows, nv))
    rows = np.repeat(np.arange(n_rows), lengths)
    np.add.at(exact, rows, w.astype(np.float64)[:, None]
              * x.astype(np.float64)[src])
    # two float64 sums of the same positive terms in two orders: each
    # within (terms - 1) float64 units of roundoff of the true sum
    bound = 2 * np.asarray(lengths)[:, None] * 2.0 ** -53 * exact
    assert (np.abs(sums - exact) <= bound).all()
