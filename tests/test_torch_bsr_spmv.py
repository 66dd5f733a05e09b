"""Parity of repro_torch's block-CSR SpMV layer with the JAX package's, on
the CPU.

Packing is numpy on both sides and must give equal arrays. The port's plain
PyTorch version is held against the JAX package's plain version and its
Pallas kernel in interpret mode over every case of test_kernels_spmv.py:
rtol/atol 1e-5 in f32 (summation order differs), 2e-2 with f16 x. The
count of real slots per block-row (`slot_counts`, where the CUDA kernel
stops) is held to the packing, and the plain lanes are shown to give the
same sums when the slots past it are skipped (f32) or replayed as zero
products (Kahan), exactly.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.kernels.bsr_spmv as jk
import repro_torch.kernels.bsr_spmv as tk
from repro.graph.csr import TransitionT as JTransitionT
from repro.graph.generate import powerlaw_webgraph
from repro_torch.interop import bsr_from_arrays, operator_from_arrays

from _torch_parity import hybrid_arrays, op_arrays, x64
from test_torch_gpu import kahan_replay_layout

CPU = torch.device("cpu")
SHAPES = [
    (100, 100, 500, 32, 32, 1),
    (257, 130, 800, 64, 32, 4),
    (512, 512, 4000, 128, 128, 8),
    (64, 300, 600, 16, 64, 2),
]


def random_coo(rng, n_rows, n_cols, nnz):
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.standard_normal(nnz)
    _, idx = np.unique(rows * n_cols + cols, return_index=True)
    return rows[idx], cols[idx], vals[idx]


def assert_same_bsr(a, b):
    assert (a.n_rows, a.n_cols, a.bm, a.bn) == (b.n_rows, b.n_cols, b.bm,
                                                 b.bn)
    assert a.blocks.dtype == b.blocks.dtype == np.float32
    assert a.blk_cols.dtype == b.blk_cols.dtype == np.int32
    np.testing.assert_array_equal(a.blocks, b.blocks)
    np.testing.assert_array_equal(a.blk_cols, b.blk_cols)
    assert a.fill_ratio == b.fill_ratio


@pytest.mark.parametrize("n_rows,n_cols,nnz,bm,bn,nv", SHAPES)
def test_build_bsr_equal(n_rows, n_cols, nnz, bm, bn, nv):
    rng = np.random.default_rng(nnz)
    rows, cols, vals = random_coo(rng, n_rows, n_cols, nnz)
    assert_same_bsr(tk.build_bsr(rows, cols, vals, n_rows, n_cols, bm, bn),
                    jk.build_bsr(rows, cols, vals, n_rows, n_cols, bm, bn))
    # duplicate (row, col) pairs accumulate the same way
    r2, c2 = np.concatenate([rows, rows[:50]]), np.concatenate([cols,
                                                                cols[:50]])
    v2 = np.concatenate([vals, vals[:50]])
    assert_same_bsr(tk.build_bsr(r2, c2, v2, n_rows, n_cols, bm, bn),
                    jk.build_bsr(r2, c2, v2, n_rows, n_cols, bm, bn))


@pytest.mark.parametrize("bm", [8, 16])
def test_hybrid_packing_equal(small_op, bm):
    h_j = small_op.hybrid_bsr(bm=bm, bn=bm)
    op = operator_from_arrays(op_arrays(small_op))
    h_t = op.hybrid_bsr(bm=bm, bn=bm)
    assert_same_bsr(h_t.bsr, h_j.bsr)
    for name in ("hub_rows", "hub_cols", "hub_vals"):
        a, b = getattr(h_t, name), getattr(h_j, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert h_t.hub_nnz_frac == h_j.hub_nnz_frac > 0
    assert_same_bsr(tk.bsr_from_transition(op.pt, bm, bm),
                    jk.bsr_from_transition(small_op.pt, bm, bm))
    # the reference's packed arrays carried across give the same layout
    h_x = bsr_from_arrays(hybrid_arrays(h_j))
    assert_same_bsr(h_x.bsr, h_t.bsr)


def test_bsr_from_arrays_rejects_out_of_range_columns(small_op):
    d = hybrid_arrays(small_op.hybrid_bsr(bm=8, bn=8))
    d["blk_cols"] = d["blk_cols"].copy()
    d["blk_cols"][0, 0] = d["blk_cols"].max() + 10_000
    with pytest.raises(ValueError, match="blk_cols"):
        bsr_from_arrays(d)
    with pytest.raises(KeyError):
        bsr_from_arrays({k: v for k, v in d.items() if k != "hub_vals"})


def _both(bsr_j, x):
    """(port plain version, JAX plain version, JAX Pallas interpret) on the
    same padded operand."""
    xp = jk.pad_x(x, bsr_j.n_cols, bsr_j.bn)
    blocks, blk_cols = bsr_j.device()
    y_t = tk.bsr_spmv_ref(torch.as_tensor(bsr_j.blocks),
                          torch.as_tensor(bsr_j.blk_cols),
                          torch.as_tensor(xp)).numpy()
    y_r = np.asarray(jk.bsr_spmv_ref(blocks, blk_cols, jnp.asarray(xp)))
    y_k = np.asarray(jk.spmv(bsr_j, jnp.asarray(xp), interpret=True))
    return y_t, y_r, y_k


@pytest.mark.parametrize("n_rows,n_cols,nnz,bm,bn,nv", SHAPES)
def test_plain_matches_reference_shapes(n_rows, n_cols, nnz, bm, bn, nv):
    rng = np.random.default_rng(nnz)
    rows, cols, vals = random_coo(rng, n_rows, n_cols, nnz)
    bsr = jk.build_bsr(rows, cols, vals, n_rows, n_cols, bm=bm, bn=bn)
    x = rng.standard_normal((n_cols, nv)).astype(np.float32)
    y_t, y_r, y_k = _both(bsr, x)
    assert y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_t, y_k, rtol=1e-5, atol=1e-5)
    # the dispatching entry point takes the plain version on CPU tensors
    y_s = tk.spmv(tk.build_bsr(rows, cols, vals, n_rows, n_cols, bm, bn),
                  tk.pad_x(x, n_cols, bn), device="cpu").numpy()
    np.testing.assert_array_equal(y_s, y_t)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_dtypes(dtype):
    rng = np.random.default_rng(0)
    rows, cols, vals = random_coo(rng, 128, 128, 700)
    bsr = jk.build_bsr(rows, cols, vals, 128, 128, bm=32, bn=32)
    x = rng.standard_normal((128, 2)).astype(dtype)
    y_t, y_r, y_k = _both(bsr, x)
    assert y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_r, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(y_t, y_k, rtol=2e-2, atol=2e-2)


def test_plain_vs_scipy_on_webgraph():
    g = powerlaw_webgraph(n=800, target_nnz=6000, n_dangling=4, seed=5)
    pt = JTransitionT.from_graph(g)
    bsr = tk.bsr_from_transition(pt, bm=64, bn=64)
    x = np.random.default_rng(1).random((g.n, 3)).astype(np.float32)
    y = tk.spmv(bsr, tk.pad_x(x, g.n, 64), device="cpu").numpy()
    np.testing.assert_allclose(tk.unpad_y(y, g.n),
                               pt.to_scipy() @ x.astype(np.float64),
                               rtol=1e-4, atol=1e-5)


def test_empty_rows_and_padding():
    bsr = tk.build_bsr(np.array([0, 1, 300]), np.array([5, 200, 10]),
                       np.array([1.0, 2.0, 3.0]), 400, 256, bm=64, bn=64)
    xp = tk.pad_x(np.ones((256, 1), np.float32), 256, 64)
    for accum in ("f32", "kahan"):
        y = tk.unpad_y(tk.spmv(bsr, xp, accum=accum, device="cpu").numpy(),
                       400)
        assert y[0, 0] == pytest.approx(1.0)
        assert y[1, 0] == pytest.approx(2.0)
        assert y[300, 0] == pytest.approx(3.0)
        assert np.abs(y).sum() == pytest.approx(6.0)


def test_fill_ratio_reported():
    g = powerlaw_webgraph(n=500, target_nnz=3000, n_dangling=2, seed=2)
    pt = JTransitionT.from_graph(g)
    bsr = tk.bsr_from_transition(pt)
    assert 0 < bsr.fill_ratio <= 1
    assert bsr.fill_ratio == jk.bsr_from_transition(
        pt, bm=tk.DEFAULT_BM, bn=tk.DEFAULT_BN).fill_ratio


def _deep_bsr(rng, nbc=64, bm=8):
    n_rows, n_cols = bm, nbc * bm
    rows = np.repeat(np.arange(bm), nbc)
    cols = (np.tile(np.arange(nbc), bm) * bm
            + rng.integers(0, bm, nbc * bm))
    vals = rng.standard_normal(nbc * bm) * 10.0 ** rng.integers(
        -3, 3, nbc * bm)
    return tk.build_bsr(rows, cols, vals, n_rows, n_cols, bm=bm, bn=bm)


def test_kahan_loop_beats_f32_on_deep_k():
    """The plain compensated loop lands nearer the f64 lane than the plain
    f32 lane on a 128-slot chain (test_kernels_spmv.py's acceptance), and
    agrees with the Pallas kahan kernel in interpret mode."""
    rng = np.random.default_rng(42)
    bsr = _deep_bsr(rng, nbc=128, bm=8)
    x = rng.standard_normal((bsr.n_cols, 2)).astype(np.float32)
    xp = torch.as_tensor(tk.pad_x(x, bsr.n_cols, 8))
    blocks = torch.as_tensor(bsr.blocks)
    cols = torch.as_tensor(bsr.blk_cols)
    ref64 = tk.bsr_spmv_ref(blocks, cols, xp.double(), accum="f64")
    assert ref64.dtype == torch.float64
    y32 = tk.bsr_spmv_ref(blocks, cols, xp, accum="f32")
    yk = tk.bsr_spmv_ref(blocks, cols, xp, accum="kahan")
    assert yk.dtype == torch.float32
    err32 = (y32.double() - ref64).abs().max().item()
    errk = (yk.double() - ref64).abs().max().item()
    assert errk <= err32
    assert errk < 0.5 * err32, (errk, err32)
    yj = np.asarray(jk.bsr_spmv(jnp.asarray(bsr.blocks),
                                jnp.asarray(bsr.blk_cols),
                                jnp.asarray(xp.numpy()), interpret=True,
                                accum="kahan"))
    np.testing.assert_allclose(yk.numpy(), yj, rtol=1e-5, atol=1e-5)


def test_ref_accum_lanes():
    rng = np.random.default_rng(5)
    bsr = _deep_bsr(rng, nbc=32, bm=8)
    x = rng.standard_normal((bsr.n_cols, 1)).astype(np.float32)
    xp = tk.pad_x(x, bsr.n_cols, 8)
    blocks, cols = torch.as_tensor(bsr.blocks), torch.as_tensor(bsr.blk_cols)
    lanes = {a: tk.bsr_spmv_ref(blocks, cols, torch.as_tensor(xp), accum=a)
             for a in ("f32", "kahan", "kahan_limit", "f64")}
    for a, y in lanes.items():
        assert y.dtype == torch.float32, a
        np.testing.assert_allclose(y.numpy(), lanes["f32"].numpy(),
                                   rtol=1e-5, atol=1e-5)
    # kahan_limit is the JAX plain "kahan" lane: f64 accumulate cast to f32
    with x64():
        y_lim = np.asarray(jk.bsr_spmv_ref(
            bsr.blocks.astype(np.float64), bsr.blk_cols,
            xp.astype(np.float64), accum="kahan"))
    np.testing.assert_array_equal(lanes["kahan_limit"].numpy(), y_lim)
    with pytest.raises(ValueError, match="accum"):
        tk.bsr_spmv_ref(blocks, cols, torch.as_tensor(xp), accum="f16")


def test_resolve_impl_dispatch():
    x = torch.zeros(2, 8, 1)
    assert tk.resolve_impl("auto", x) == "ref"
    assert tk.resolve_impl("ref", x) == "ref"
    with pytest.raises(ValueError, match="CUDA"):
        tk.resolve_impl("cuda", x)
    with pytest.raises(ValueError):
        tk.resolve_impl("pallas", x)


def test_cuda_impl_on_cpu_tensors_raises():
    rng = np.random.default_rng(9)
    rows, cols, vals = random_coo(rng, 128, 128, 700)
    bsr = tk.build_bsr(rows, cols, vals, 128, 128, bm=32, bn=32)
    xp = tk.pad_x(rng.standard_normal((128, 2)).astype(np.float32), 128, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tk.spmv(bsr, xp, impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tk.bsr_spmv(torch.as_tensor(bsr.blocks),
                    torch.as_tensor(bsr.blk_cols), torch.as_tensor(xp))


@pytest.mark.parametrize("accum", ["f32", "kahan"])
@pytest.mark.parametrize("nv", [1, 3])
def test_hybrid_matvec_matches_reference(small_op, accum, nv):
    bm = 8
    h_j = small_op.hybrid_bsr(bm=bm, bn=bm)
    h_t = bsr_from_arrays(hybrid_arrays(h_j))
    x = np.random.default_rng(nv).random((small_op.n, nv)).astype(np.float32)
    xp = jk.pad_x(x, small_op.n, bm)
    with x64():
        y_j = np.asarray(jk.hybrid_matvec(h_j.device(), jnp.asarray(xp),
                                          impl="ref", accum=accum))
    y_t = tk.hybrid_matvec(h_t.device(CPU), torch.as_tensor(xp),
                           accum=accum).numpy()
    assert y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-6)
    y_s = small_op.pt.to_scipy() @ x.astype(np.float64)
    np.testing.assert_allclose(tk.unpad_y(y_t, small_op.n), y_s, rtol=1e-5,
                               atol=1e-6)


def test_hub_side_keeps_tiny_in_links():
    """A hub row summing one large in-link and 1e5 in-links far below half
    an ulp of it (a personalized teleport on the Stanford-Web replica):
    the hub side accumulates in float64, so their mass is not dropped, as
    an f32 scatter-add drops it."""
    n_tiny = 100_000
    cols = np.arange(n_tiny + 1, dtype=np.int32)
    d = dict(n_rows=n_tiny + 1, n_cols=n_tiny + 1, bm=8, bn=8,
             blocks=np.zeros((-(-(n_tiny + 1) // 8), 1, 8, 8), np.float32),
             blk_cols=np.zeros((-(-(n_tiny + 1) // 8), 1), np.int32),
             fill_ratio=0.0, hub_rows=np.zeros(n_tiny + 1, np.int32),
             hub_cols=cols, hub_vals=np.ones(n_tiny + 1, np.float32),
             hub_nnz_frac=1.0)
    h = bsr_from_arrays(d)
    x = np.full(n_tiny + 1, 1e-10, np.float32)
    x[0] = 0.04
    y = tk.hybrid_matvec(h.device(CPU),
                         torch.as_tensor(tk.pad_x(x, n_tiny + 1, 8)))
    expect = 0.04 + n_tiny * float(np.float32(1e-10))
    # the tiny in-links are 2.5e-4 of the row; sequential f32 adds drop all
    assert y[0, 0, 0].item() == pytest.approx(expect, rel=1e-7)


# --------------------------------------------------------------------------
# Real slots per block-row: the CUDA kernel reads no slot past the count
# --------------------------------------------------------------------------
LAYOUTS = ["shape0", "shape1", "shape2", "shape3", "hybrid8", "hybrid16",
           "interop8"]


def _layout(request, case):
    """(packed layout, expected count): the count is np.bincount of the
    block-rows of the unique (block-row, block-column) pairs the packing
    was given."""
    kind = case.rstrip("0123456789")
    num = int(case[len(kind):])
    if kind == "shape":
        n_rows, n_cols, nnz, bm, bn, _ = SHAPES[num]
        rows, cols, vals = random_coo(np.random.default_rng(nnz), n_rows,
                                      n_cols, nnz)
        b = jk.build_bsr(rows, cols, vals, n_rows, n_cols, bm, bn)
    else:
        small_op = request.getfixturevalue("small_op")
        h = small_op.hybrid_bsr(bm=num, bn=num)
        if kind == "interop":
            h = bsr_from_arrays(hybrid_arrays(h))
        b = h.bsr
        # the hub rows' edges went to the COO side, the rest were blocked
        keep = ~np.isin(small_op.pt.row_ids, h.hub_rows)
        rows, cols = small_op.pt.row_ids[keep], small_op.pt.src[keep]
    nbc = -(-b.n_cols // b.bn)
    pairs = np.unique(rows.astype(np.int64) // b.bm * nbc + cols // b.bn)
    return b, np.bincount(pairs // nbc, minlength=b.nbr)


@pytest.mark.parametrize("case", LAYOUTS)
def test_slot_counts_match_packing(request, case):
    b, expect = _layout(request, case)
    got = tk.slot_counts(b.blk_cols, b.blocks)
    assert got.dtype == np.int32 and got.shape == (b.nbr,)
    np.testing.assert_array_equal(got, expect)
    assert got.max() == b.K
    if isinstance(b, tk.BSRMatrix):
        # the port's container uploads the same count beside its blocks
        np.testing.assert_array_equal(b.counts, expect)
        blocks, blk_cols, blk_count = b.device(CPU)
        assert blk_count.dtype == torch.int32
        np.testing.assert_array_equal(blk_count.numpy(), expect)


@pytest.mark.parametrize("fault", ["nonzero_past_count", "not_ascending"])
def test_slot_counts_refuse_broken_padding(fault):
    rng = np.random.default_rng(3)
    rows, cols, vals = random_coo(rng, 100, 100, 500)
    b = tk.build_bsr(rows, cols, vals, 100, 100, bm=16, bn=16)
    counts = tk.slot_counts(b.blk_cols, b.blocks)
    i = int(np.flatnonzero((counts >= 2) & (counts < b.K))[0])
    blocks, blk_cols = b.blocks.copy(), b.blk_cols.copy()
    if fault == "nonzero_past_count":
        blocks[i, counts[i], 3, 5] = 1.0
    else:
        blocks[i, [0, 1]] = blocks[i, [1, 0]]
        blk_cols[i, [0, 1]] = blk_cols[i, [1, 0]]
    with pytest.raises(ValueError, match=f"block-row {i} .*past the row"):
        tk.slot_counts(blk_cols, blocks)
    d = dict(n_rows=100, n_cols=100, bm=16, bn=16, blocks=blocks,
             blk_cols=blk_cols, fill_ratio=b.fill_ratio,
             hub_rows=np.zeros(0, np.int32), hub_cols=np.zeros(0, np.int32),
             hub_vals=np.zeros(0, np.float32), hub_nnz_frac=0.0)
    with pytest.raises(ValueError, match="past the row"):
        bsr_from_arrays(d)


def _counted_plain(blocks, blk_cols, x, counts, accum, replay=True):
    """The sum the CUDA kernel forms, slot by slot in plain PyTorch: each
    row's real slots only (f32), or its real slots then, with `replay`,
    the zero-product Kahan steps of the slots past them (kahan)."""
    xg = x[blk_cols.long()]
    acc = blocks.new_zeros(blocks.shape[0], blocks.shape[2], x.shape[2])
    comp = torch.zeros_like(acc)
    for k in range(blocks.shape[1]):
        real = (k < counts)[:, None, None]
        prod = torch.bmm(blocks[:, k], xg[:, k])
        if accum == "f32":
            acc = torch.where(real, acc + prod, acc)
            continue
        prod = torch.where(real, prod, 0.0)
        y = prod - comp
        t = acc + y
        step = real | replay
        comp = torch.where(step, (t - acc) - y, comp)
        acc = torch.where(step, t, acc)
    return acc


@pytest.mark.parametrize("accum", ["f32", "kahan"])
@pytest.mark.parametrize("case", LAYOUTS)
def test_plain_unchanged_past_count(request, case, accum):
    """The plain version with every slot past the count zeroed equals
    itself over all K exactly; the kernel's schedule (skip the padding in
    f32, replay it as zero products in Kahan) gives the sums of a slot
    loop over all K exactly."""
    b, _ = _layout(request, case)
    counts = tk.slot_counts(b.blk_cols, b.blocks)
    past = np.arange(b.K)[None, :] >= counts[:, None]
    blocks, blk_cols = b.blocks.copy(), b.blk_cols.copy()
    blocks[past] = 0.0
    blk_cols[past] = 0
    rng = np.random.default_rng(b.nbr)
    x = torch.as_tensor(jk.pad_x(
        rng.standard_normal((b.n_cols, 2)).astype(np.float32), b.n_cols,
        b.bn))
    full = (torch.as_tensor(b.blocks), torch.as_tensor(b.blk_cols))
    y = tk.bsr_spmv_ref(*full, x, accum=accum)
    zeroed = tk.bsr_spmv_ref(torch.as_tensor(blocks),
                             torch.as_tensor(blk_cols), x, accum=accum)
    assert torch.equal(zeroed, y)
    t_counts = torch.as_tensor(counts)
    all_k = torch.full_like(t_counts, b.K)
    counted = _counted_plain(*full, x, t_counts, accum)
    loop = (y if accum == "kahan"
            else _counted_plain(*full, x, all_k, accum))
    assert torch.equal(counted, loop)


def test_kahan_zero_steps_move_the_sum():
    """A Kahan step on a zero product folds the compensation into the sum,
    so stopping at the count is not the reference's function: the Pallas
    kahan kernel and the plain lane step through every padded slot. The
    replay of those steps gives their sums exactly."""
    blocks, blk_cols, x, counts = kahan_replay_layout()
    np.testing.assert_array_equal(tk.slot_counts(blk_cols, blocks), counts)
    b, c, xt, n = (torch.as_tensor(a) for a in (blocks, blk_cols, x, counts))
    full = tk.bsr_spmv_ref(b, c, xt, accum="kahan")
    stop = _counted_plain(b, c, xt, n, "kahan", replay=False)
    moved = stop != full
    assert moved.sum() >= 8
    assert torch.equal(_counted_plain(b, c, xt, n, "kahan"), full)
    pallas = np.asarray(jk.bsr_spmv(jnp.asarray(blocks),
                                    jnp.asarray(blk_cols), jnp.asarray(x),
                                    interpret=True, accum="kahan"))
    np.testing.assert_array_equal(pallas, full.numpy())


# --------------------------------------------------------------------------
# The hub side's CSR form, which the CSR kernel's hub lane reads on the card
# --------------------------------------------------------------------------
HUB_FORMS = ["hybrid", "shuffled", "spmd"]


def _coo_hub_side(coo, x, y):
    """The hub side as the port computed it before its CSR form, over the
    COO arrays: float64 products gathered by `hub_cols`, an `index_add_`
    over the padded row space by `hub_rows` (edge order on the CPU), and
    the sums rounded to y's dtype and added: y + hub. x (nbc, bn, nv), y
    (nbr, bm, nv)."""
    nbr, bm, nv = y.shape
    coo = {k: torch.as_tensor(v) for k, v in coo.items()}
    contrib = coo["hub_vals"].double()[:, None] * x.reshape(
        -1, nv).double().index_select(0, coo["hub_cols"])
    hub = contrib.new_zeros((nbr * bm, nv)).index_add_(
        0, coo["hub_rows"], contrib)
    return y + hub.reshape(nbr, bm, nv).to(y.dtype)


def _in_links(rows, cols, vals):
    """{row: (its cols, its vals) in the order the arrays give them}."""
    return {int(r): (cols[rows == r], vals[rows == r])
            for r in np.unique(rows)}


def _hub_form(small_op, which):
    """(the hub side's device dict on the CPU, the same side as the COO
    arrays it was built from, {padded row: its in-links in input order},
    padded rows, padded columns) for a HybridBSR, the same with its COO
    arrays shuffled, or the shard program's folded dict (p = 4)."""
    op = operator_from_arrays(op_arrays(small_op))
    pt = op.pt
    if which == "spmd":
        from repro_torch.core.partition import block_rows
        from repro_torch.core.spmd import (SPMDConfig, _pack_structure,
                                           col_map_seg)
        part = block_rows(op.n, 4)
        packed = _pack_structure(op, part, SPMDConfig(p=4, backend="bsr"),
                                 np.dtype("float32"), 8)
        bsize, n_pad = packed["bsize"], packed["n_pad"]
        hub = {k: packed[k] for k in ("hub_cols", "hub_vals",
                                      "hub_indptr", "hub_map")}
        # each hub row's in-links in the operator's edge order
        expect = {}
        for i in range(4):
            s, t = part.block(i)
            for g in range(s, t):
                e0, e1 = pt.indptr[g], pt.indptr[g + 1]
                r = i * bsize + g - s
                if r in set(hub["hub_map"].tolist()):
                    expect[r] = (col_map_seg(part, bsize, pt.src[e0:e1])
                                 + i * n_pad,
                                 np.asarray(pt.weight[e0:e1], np.float32))
        # the packer concatenates the shards' hub rows in order, so the COO
        # arrays it held are the CSR form's rows repeated by their counts
        coo = dict(hub_rows=np.repeat(hub["hub_map"],
                                      np.diff(hub["hub_indptr"])),
                   hub_cols=hub["hub_cols"], hub_vals=hub["hub_vals"])
        return ({k: torch.as_tensor(v) for k, v in hub.items()}, coo, expect,
                4 * bsize, 4 * n_pad)
    h = op.hybrid_bsr(bm=8, bn=8)
    coo = dict(hub_rows=h.hub_rows, hub_cols=h.hub_cols,
               hub_vals=h.hub_vals)
    if which == "shuffled":
        order = np.random.default_rng(3).permutation(h.hub_rows.size)
        coo = {k: v[order] for k, v in coo.items()}
        h = h.__class__(bsr=h.bsr, hub_nnz_frac=h.hub_nnz_frac, **coo)
    expect = _in_links(coo["hub_rows"], coo["hub_cols"], coo["hub_vals"])
    dev = h.device(CPU)
    return (dev, coo, expect, h.bsr.nbr * 8, h.bsr.nbc * 8)


@pytest.mark.parametrize("which", HUB_FORMS)
def test_hub_csr_form_covers_every_edge_in_order(small_op, which):
    """`hub_csr` (built in `HybridBSR.device` and the shard program's
    packing): the CSR rows are the hub rows, distinct and ascending; each
    holds all its in-links once, in the order its input gave them (a
    stable sort where the COO arrays were not sorted by row)."""
    dev, coo, expect, _, _ = _hub_form(small_op, which)
    indptr = dev["hub_indptr"].numpy()
    hub_map = dev["hub_map"].numpy()
    cols, vals = dev["hub_cols"].numpy(), dev["hub_vals"].numpy()
    assert dev["hub_indptr"].dtype == torch.int64
    assert dev["hub_map"].dtype == dev["hub_cols"].dtype == torch.int32
    assert hub_map.size > 0 and np.all(np.diff(hub_map) > 0)
    assert indptr[0] == 0 and indptr[-1] == cols.size == coo["hub_cols"].size
    assert np.all(np.diff(indptr) > 0)
    assert set(dev) >= {"hub_indptr", "hub_map", "hub_cols", "hub_vals"}
    assert "hub_rows" not in dev
    assert sorted(expect) == hub_map.tolist()
    for i, r in enumerate(hub_map):
        np.testing.assert_array_equal(cols[indptr[i]:indptr[i + 1]],
                                      expect[r][0])
        np.testing.assert_array_equal(vals[indptr[i]:indptr[i + 1]],
                                      expect[r][1])


@pytest.mark.parametrize("nv", [1, 3])
@pytest.mark.parametrize("which", HUB_FORMS)
def test_hub_csr_plain_equals_coo(small_op, which, nv):
    """The hub lane's plain version through the CSR form gives, bit for
    bit, what the COO gather + scatter-add gives over the arrays as they
    came (float64 sums in each row's edge order on the CPU, rounded to
    float32 and added to y)."""
    from repro_torch.kernels.csr_spmv import csr_spmv_hub_add_ref
    dev, coo, _, n_rows, n_cols = _hub_form(small_op, which)
    rng = np.random.default_rng(nv)
    x = torch.as_tensor(rng.random((n_cols // 8, 8, nv)).astype(np.float32))
    y0 = torch.as_tensor(rng.random((n_rows // 8, 8, nv)).astype(np.float32))
    want = _coo_hub_side(coo, x, y0)
    got = csr_spmv_hub_add_ref(dev["hub_indptr"], dev["hub_cols"],
                               dev["hub_vals"], x.reshape(-1, nv),
                               dev["hub_map"], y0.clone().reshape(-1, nv))
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1, nv).numpy())
    # and hybrid_matvec's CPU path is that COO side after the block side
    if which == "hybrid":
        h = operator_from_arrays(op_arrays(small_op)).hybrid_bsr(bm=8, bn=8)
        y = tk.hybrid_matvec(h.device(CPU), x)
        blk = tk.bsr_spmv_ref(*(torch.as_tensor(a) for a in
                                (h.bsr.blocks, h.bsr.blk_cols)), x)
        np.testing.assert_array_equal(y.numpy(),
                                      _coo_hub_side(coo, x, blk).numpy())


@pytest.mark.parametrize("rows,order", [
    ([], []),
    ([5], [0]),
    ([7, 7, 7, 7], [0, 1, 2, 3]),
    ([2, 2, 4, 9, 9, 9], [0, 1, 2, 3, 4, 5]),
    ([9, 2, 4, 2, 9, 9, 0], [6, 1, 3, 2, 0, 4, 5]),
], ids=["empty", "one-edge", "one-row", "sorted", "unsorted-ties"])
def test_hub_csr_of_hand_made_arrays(rows, order):
    """`hub_csr` alone: rows sorted stably (ties keep their input order),
    indptr over the distinct rows, `hub_map` those rows; sorted input comes
    back as it was."""
    rows = np.asarray(rows, np.int32)
    cols = np.arange(rows.size, dtype=np.int32) * 3 + 1
    vals = np.arange(rows.size, dtype=np.float32) / 8
    hub = tk.hub_csr(rows, cols, vals)
    assert sorted(hub) == ["hub_cols", "hub_indptr", "hub_map", "hub_vals"]
    np.testing.assert_array_equal(hub["hub_cols"], cols[order])
    np.testing.assert_array_equal(hub["hub_vals"], vals[order])
    distinct, counts = np.unique(rows, return_counts=True)
    np.testing.assert_array_equal(hub["hub_map"], distinct)
    np.testing.assert_array_equal(hub["hub_indptr"],
                                  np.concatenate([[0], np.cumsum(counts)]))
    assert hub["hub_indptr"].dtype == np.int64
    assert hub["hub_map"].dtype == hub["hub_cols"].dtype == np.int32
    assert hub["hub_vals"].dtype == np.float32
