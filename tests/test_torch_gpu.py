"""The CUDA kernels of repro_torch against their plain PyTorch versions, on
the card. Marked `gpu`; each test skips without a CUDA device. Run them on a
machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bsr_spmv import (LAUNCHES, bsr_matvec, bsr_spmv,
                                          bsr_spmv_ref, build_bsr,
                                          kernel_path, pad_x)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain version is an einsum: hold it to full f32, not TF32, so it
    # is a fair oracle for the kernel's f32 FMAs
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def random_coo(rng, n_rows, n_cols, nnz):
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.standard_normal(nnz)
    _, idx = np.unique(rows * n_cols + cols, return_index=True)
    return rows[idx], cols[idx], vals[idx]


def _operands(bsr, x, device):
    return (torch.as_tensor(bsr.blocks, device=device),
            torch.as_tensor(bsr.blk_cols, device=device),
            torch.as_tensor(pad_x(x, bsr.n_cols, bsr.bn), device=device))


def _kahan32(prods):
    """float32 Kahan sum over the last axis, step by step in numpy."""
    acc = np.zeros(prods.shape[:-1], np.float32)
    comp = np.zeros_like(acc)
    for k in range(prods.shape[-1]):
        y = prods[..., k] - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc


def kahan_replay_layout(n_rows=16, bm=8, real=4, pad=3, seed=0):
    """A packed layout on which Kahan's zero-product steps past the real
    slots move the sum: every block-row has `real` real slots (columns
    0..real-1) and `pad` padded ones. Block (i, k) holds one nonzero per
    row m, at column m, and x is all ones, so slot k's product at (i, m) is
    that entry exactly, whatever order a dot sums in. The entries span nine
    decades; the sequences whose float32 Kahan sum over all slots differs
    from the sum over the real slots alone (about 1 in 100) fill the first
    elements. Returns numpy (blocks, blk_cols, x, counts)."""
    rng = np.random.default_rng(seed)
    cand = (rng.standard_normal((4096, real))
            * 10.0 ** rng.integers(-4, 5, (4096, real))).astype(np.float32)
    moved = _kahan32(np.pad(cand, ((0, 0), (0, pad)))) != _kahan32(cand)
    seqs = np.concatenate([cand[moved], cand[~moved]])[:n_rows * bm]
    K = real + pad
    blocks = np.zeros((n_rows, K, bm, bm), np.float32)
    diag = np.arange(bm)
    blocks[:, :real, diag, diag] = seqs.reshape(n_rows, bm, real).transpose(
        0, 2, 1)
    blk_cols = np.zeros((n_rows, K), np.int32)
    blk_cols[:, :real] = np.arange(real)
    counts = np.full(n_rows, real, np.int32)
    return blocks, blk_cols, np.ones((real, bm, 1), np.float32), counts


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("accum", ["f32", "kahan"])
@pytest.mark.parametrize("n_rows,n_cols,nnz,bm,bn,nv", [
    (100, 100, 500, 32, 32, 1),
    (257, 130, 800, 64, 32, 4),
    (512, 512, 4000, 128, 128, 8),   # bm = 128: the generic path
    (64, 300, 600, 16, 64, 2),
    (300, 300, 2000, 8, 8, 3),
    (90, 90, 400, 6, 6, 5),        # bn % 4 != 0: the generic path
    # the ring path: bm = bn in {8, 16, 32, 64}, nv in {1, 2, 4, 8}
    (1000, 1000, 9000, 8, 8, 1),
    (1000, 1000, 9000, 16, 16, 8),
    (1000, 1000, 9000, 32, 32, 2),
    (1000, 1000, 9000, 64, 64, 4),
    (3000, 3000, 60000, 32, 32, 8),  # more block-rows than one wave
    (4000, 256, 30, 64, 64, 1),    # rows with 0 real slots
    (512, 512, 512, 8, 8, 1),      # K = 1 (one block per row)
])
def test_kernel_matches_plain(cuda, n_rows, n_cols, nnz, bm, bn, nv, accum,
                              counted):
    """Against the plain version over all K slots; with `counted`, the
    kernel reads only each row's real slots (`slot_counts`: rows with
    none, rows full to K)."""
    rng = np.random.default_rng(nnz)
    rows, cols, vals = random_coo(rng, n_rows, n_cols, nnz)
    if nnz == n_rows == n_cols:
        rows = cols = np.arange(n_rows)
        vals = rng.standard_normal(n_rows)
    bsr = build_bsr(rows, cols, vals, n_rows, n_cols, bm=bm, bn=bn)
    x = rng.standard_normal((n_cols, nv)).astype(np.float32)
    blocks, blk_cols, xp = _operands(bsr, x, cuda)
    count = torch.as_tensor(bsr.counts, device=cuda) if counted else None
    if nnz == 30:
        assert (bsr.counts == 0).any() and (bsr.counts == bsr.K).any()
    if nnz == n_rows:
        assert bsr.K == 1
    before = LAUNCHES[accum]
    y = bsr_spmv(blocks, blk_cols, xp, accum=accum, blk_count=count)
    torch.cuda.synchronize()
    assert LAUNCHES[accum] == before + 1
    y_ref = bsr_spmv_ref(blocks, blk_cols, xp, accum=accum)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)


def test_kahan_replays_padded_slots(cuda):
    """With counts, the Kahan lane reads only the real slots yet matches
    the plain lane over all K, which also steps through the padded
    (zero-product) slots; a plain loop that stops at the count differs."""
    blocks, blk_cols, x, counts = kahan_replay_layout()
    b, c, xt, n = (torch.as_tensor(a, device=cuda)
                   for a in (blocks, blk_cols, x, counts))
    assert kernel_path(b, xt) == "ring"
    y = bsr_spmv(b, c, xt, accum="kahan", blk_count=n)
    full = bsr_spmv_ref(b, c, xt, accum="kahan")
    real = counts[0]
    stop = bsr_spmv_ref(b[:, :real].contiguous(), c[:, :real].contiguous(),
                        xt, accum="kahan")
    torch.cuda.synchronize()
    torch.testing.assert_close(y, full, rtol=1e-6, atol=0)
    moved = stop != full
    assert moved.any()
    assert torch.equal(y[moved], full[moved])
    # the generic path replays the same steps
    y6 = bsr_spmv(b[..., :6, :6].contiguous(), c, xt[:, :6].contiguous(),
                  accum="kahan", blk_count=n)
    full6 = bsr_spmv_ref(b[..., :6, :6].contiguous(), c,
                         xt[:, :6].contiguous(), accum="kahan")
    torch.testing.assert_close(y6, full6, rtol=1e-6, atol=0)


@pytest.mark.parametrize("nv", [1, 2, 8])
@pytest.mark.parametrize("accum", ["f32", "kahan"])
def test_kernel_half_x(cuda, accum, nv):
    rng = np.random.default_rng(0)
    rows, cols, vals = random_coo(rng, 128, 128, 700)
    bsr = build_bsr(rows, cols, vals, 128, 128, bm=32, bn=32)
    x = rng.standard_normal((128, nv)).astype(np.float16)
    blocks, blk_cols, xp = _operands(bsr, x, cuda)
    y = bsr_spmv(blocks, blk_cols, xp, accum=accum,
                 blk_count=torch.as_tensor(bsr.counts, device=cuda))
    assert y.dtype == torch.float32
    torch.testing.assert_close(
        y, bsr_spmv_ref(blocks, blk_cols, xp, accum=accum), rtol=2e-2,
        atol=2e-2)


def test_kernel_empty_block_rows(cuda):
    bsr = build_bsr(np.array([0, 1, 300]), np.array([5, 200, 10]),
                    np.array([1.0, 2.0, 3.0]), 400, 256, bm=64, bn=64)
    blocks, blk_cols, xp = _operands(bsr, np.ones((256, 1), np.float32),
                                     cuda)
    expect = np.zeros(400, np.float32)
    expect[[0, 1, 300]] = [1.0, 2.0, 3.0]
    for count in (None, torch.as_tensor(bsr.counts, device=cuda)):
        y = bsr_spmv(blocks, blk_cols, xp, blk_count=count)
        np.testing.assert_array_equal(y.reshape(-1)[:400].cpu().numpy(),
                                      expect)


def test_kahan_beats_f32_on_deep_k(cuda):
    """On a 128-slot chain the compensated lane lands nearer the f64 plain
    lane than the f32 lane does."""
    rng = np.random.default_rng(42)
    nbc, bm = 128, 8
    rows = np.repeat(np.arange(bm), nbc)
    cols = np.tile(np.arange(nbc), bm) * bm + rng.integers(0, bm, nbc * bm)
    vals = rng.standard_normal(nbc * bm) * 10.0 ** rng.integers(
        -3, 3, nbc * bm)
    bsr = build_bsr(rows, cols, vals, bm, nbc * bm, bm=bm, bn=bm)
    x = rng.standard_normal((bsr.n_cols, 2)).astype(np.float32)
    blocks, blk_cols, xp = _operands(bsr, x, cuda)
    ref64 = bsr_spmv_ref(blocks, blk_cols, xp.double(), accum="f64")
    err32 = (bsr_spmv(blocks, blk_cols, xp).double() - ref64).abs().max()
    errk = (bsr_spmv(blocks, blk_cols, xp, accum="kahan").double()
            - ref64).abs().max()
    assert errk <= err32
    assert errk < 0.5 * err32, (errk, err32)


def test_wrapper_refuses_bad_operands(cuda):
    blocks = torch.zeros((2, 1, 8, 8), device=cuda)
    cols = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    x = torch.zeros((2, 8, 1), device=cuda)
    with pytest.raises(TypeError):
        bsr_spmv(blocks, cols.long(), x)
    with pytest.raises(TypeError):
        bsr_spmv(blocks.double(), cols, x)
    with pytest.raises(ValueError):
        bsr_spmv(blocks, cols, x.cpu())
    with pytest.raises(ValueError):
        bsr_spmv(blocks, cols, x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):
        bsr_spmv(blocks, cols[:1], x)
    count = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="blk_count"):
        bsr_spmv(blocks, cols, x, blk_count=count.long())
    with pytest.raises(ValueError, match="blk_count"):
        bsr_spmv(blocks, cols, x, blk_count=count[:1])
    with pytest.raises(ValueError, match="blk_count"):
        bsr_spmv(blocks, cols, x, blk_count=count.cpu())


def test_auto_dispatch_launches_kernel(cuda):
    rng = np.random.default_rng(3)
    rows, cols, vals = random_coo(rng, 64, 64, 300)
    bsr = build_bsr(rows, cols, vals, 64, 64, bm=16, bn=16)
    blocks, blk_cols, xp = _operands(
        bsr, rng.standard_normal((64, 1)).astype(np.float32), cuda)
    before = LAUNCHES["f32"]
    y = bsr_matvec(blocks, blk_cols, xp)
    assert LAUNCHES["f32"] == before + 1
    torch.testing.assert_close(y, bsr_spmv_ref(blocks, blk_cols, xp),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("linear", [False, True])
def test_bsr_solve_on_card_matches_cpu(cuda, linear):
    from repro_torch.graph import powerlaw_webgraph, TransitionT
    from repro_torch.graph import GoogleOperator
    from repro_torch.core import solve_linear, solve_power
    g = powerlaw_webgraph(n=2000, target_nnz=16000, n_dangling=10, seed=7)
    op = GoogleOperator(pt=TransitionT.from_graph(g), alpha=0.85)
    solve = solve_linear if linear else solve_power
    before = LAUNCHES["f32"]
    r_gpu = solve(op, tol=1e-6, backend="bsr", device=cuda)
    assert LAUNCHES["f32"] == before + r_gpu.iters
    r_cpu = solve(op, tol=1e-6, backend="bsr", device="cpu")
    assert abs(r_gpu.iters - r_cpu.iters) <= 1
    assert np.abs(r_gpu.x - r_cpu.x).max() < 1e-6


def test_frozen_stack_and_f64_on_card_match_cpu(cuda):
    """An 8-lane personalized stack (lane freezing, pow2 compaction through
    the kernel) and the f64 segment-sum solve agree with the CPU path."""
    from repro_torch.graph import powerlaw_webgraph, TransitionT
    from repro_torch.graph import GoogleOperator
    from repro_torch.core import BackendSpec, seed_stack, solve_power
    g = powerlaw_webgraph(n=2000, target_nnz=16000, n_dangling=10, seed=7)
    op = GoogleOperator(pt=TransitionT.from_graph(g), alpha=0.85)
    rng = np.random.default_rng(17)
    v = seed_stack(op.n, [rng.choice(op.n, 3, replace=False)
                          for _ in range(8)])
    tol = np.array([1e-6] * 4 + [1e-4] * 4)
    bsr8 = BackendSpec(name="bsr", bm=8)
    before = LAUNCHES["f32"]
    r_gpu = solve_power(op, tol=tol, v=v, backend=bsr8, device=cuda)
    assert LAUNCHES["f32"] == before + r_gpu.iters
    r_cpu = solve_power(op, tol=tol, v=v, backend=bsr8, device="cpu")
    # lanes freeze at chunk boundaries picked from observed residuals, so
    # the counts may move by a chunk; the answers may not
    assert r_gpu.lane_iters.min() < r_gpu.lane_iters.max()
    assert np.abs(r_gpu.x - r_cpu.x).max() < 1e-6
    assert np.all(r_gpu.resid_per_vec <= tol)
    s_gpu = solve_power(op, tol=1e-12, device=cuda)
    s_cpu = solve_power(op, tol=1e-12, device="cpu")
    assert s_gpu.iters == s_cpu.iters
    assert np.abs(s_gpu.x - s_cpu.x).max() <= 1e-12


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def _qkv(rng, B, H, Hkv, S, T, D, dtype, device):
    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device)
    return t(B, H, S, D), t(B, Hkv, T, D), t(B, Hkv, T, D)


BF16 = torch.bfloat16
# flash against its plain version: max over rows of ||o - r|| / ||r||
# (the sound kernels read at most 4.6e-3 in bf16, 1.4e-6 in float32)
ROW_REL_LIMIT = {torch.float32: 1e-5, BF16: 1e-2}


F32 = torch.float32
# the CUDA-core lane's edges: its q tile is 128 rows and its kv tile 64
F32_LANE_CASES = [
    (1, 8, 1, 2048, 2048, 128, True, F32),            # G = 8, many kv tiles
    (1, 4, 1, 1, 1, 128, True, F32),                  # ragged 1
    (1, 4, 2, 31, 31, 128, True, F32),                # ragged 31
    (1, 4, 2, 33, 33, 64, False, F32),                # ragged 33
    (1, 4, 2, 127, 127, 128, True, F32),              # ragged 127
    (1, 4, 2, 129, 129, 128, False, F32),             # ragged 129
    (1, 4, 1, 1000, 1000, 64, True, F32),             # ragged 1000
    (1, 4, 2, 31, 129, 128, False, F32),              # S != T, ragged
    (1, 4, 2, 1000, 33, 128, False, F32),
    (1, 4, 2, 128, 320, 128, True, F32),              # causal S < T
    (1, 4, 2, 320, 128, 128, True, F32),              # causal S > T
    (1, 4, 2, 129, 1000, 64, True, F32),              # causal S < T, ragged
    (1, 4, 2, 1000, 127, 128, True, F32),             # causal S > T, ragged
    (2, 4, 4, 200, 200, 128, True, F32),              # B = 2, G = 1
    (2, 8, 2, 200, 200, 128, True, F32),              # B = 2, G = 4
    (2, 8, 1, 129, 129, 128, False, F32),             # B = 2, G = 8
    (1, 4, 2, 150, 150, 18, True, F32),               # D in {18, .., 96}
    (1, 4, 2, 150, 150, 20, True, F32),
    (1, 4, 2, 150, 150, 32, True, F32),
    (1, 4, 2, 150, 150, 64, True, F32),
    (1, 4, 2, 150, 150, 96, True, F32),
    (1, 4, 2, 150, 150, 20, True, BF16),              # bf16, other D
    (1, 4, 2, 300, 300, 32, True, BF16),
    (1, 8, 2, 1000, 1000, 96, True, BF16),
]


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,dtype", [
    (1, 1, 1, 128, 128, 64, True, torch.float32),
    (2, 4, 2, 256, 256, 64, True, torch.float32),
    (1, 8, 1, 128, 128, 128, False, torch.float32),
    (1, 2, 2, 384, 384, 32, True, torch.float32),
    (1, 2, 2, 128, 128, 64, True, torch.bfloat16),
    (1, 4, 2, 128, 256, 64, True, torch.float32),     # causal S < T
    (1, 4, 2, 256, 128, 64, True, torch.float32),     # causal S > T
    (2, 4, 4, 96, 160, 64, False, torch.float32),
    (1, 4, 1, 40, 40, 128, True, torch.float32),      # ragged S = T
    (1, 4, 2, 1000, 1000, 128, True, torch.bfloat16),
    (2, 3, 1, 37, 37, 20, True, torch.float32),       # smollm-smoke D
    (2, 3, 1, 37, 37, 18, True, torch.float32),       # D % 4 != 0
    (1, 2, 1, 33, 70, 12, True, torch.bfloat16),      # D % 8 != 0 in bf16
    # the tensor-core lane: bf16 at D in {64, 128}
    (1, 4, 4, 64, 64, 64, False, BF16),               # G = 1
    (1, 4, 4, 64, 64, 128, True, BF16),
    (1, 8, 2, 128, 128, 64, True, BF16),              # G = 4
    (1, 8, 2, 128, 128, 128, False, BF16),
    (1, 8, 1, 1000, 1000, 64, True, BF16),            # G = 8
    (1, 8, 1, 1000, 1000, 128, False, BF16),
    (1, 8, 2, 2048, 2048, 64, True, BF16),
    (1, 8, 2, 2048, 2048, 128, True, BF16),
    (1, 4, 2, 128, 256, 128, True, BF16),             # causal S < T
    (1, 4, 2, 256, 128, 128, True, BF16),             # causal S > T
    (1, 4, 2, 128, 256, 64, True, BF16),
    (1, 4, 2, 256, 128, 64, True, BF16),
    (1, 4, 1, 1, 1, 128, True, BF16),                 # ragged 1
    (1, 4, 1, 63, 63, 64, True, BF16),                # ragged 63
    (1, 4, 1, 65, 65, 128, True, BF16),               # ragged 65
    (1, 4, 1, 129, 129, 64, False, BF16),             # ragged 129
    (2, 8, 1, 129, 129, 128, True, BF16),             # B = 2, G = 8
    (2, 4, 4, 1000, 1000, 64, True, BF16),            # B = 2, G = 1
    (2, 32, 4, 128, 128, 128, True, BF16),            # yi-6b, B = 2
    *F32_LANE_CASES,
])
def test_flash_kernel_matches_plain(cuda, B, H, Hkv, S, T, D, causal,
                                    dtype):
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref,
                                                     kernel_lane)
    rng = np.random.default_rng(S * 1000 + T + D)
    q, k, v = _qkv(rng, B, H, Hkv, S, T, D, dtype, cuda)
    before = dict(LAUNCHES)
    o = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["fwd"] == before["fwd"] + 1
    tensor_cores = kernel_lane(dtype, D) == "wgmma"
    assert tensor_cores == (dtype == BF16 and D in (64, 128))
    assert LAUNCHES["wgmma"] == before["wgmma"] + int(tensor_cores)
    assert o.dtype == dtype and o.shape == q.shape
    # bf16: q, k, v and o are rounded to bf16, and the tensor-core lane
    # also rounds p to bf16 before p v, against the f32 math of the plain
    # version; float32: the f32 lane differs only in summation order
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    r = flash_attention_ref(q, k, v, causal=causal).float()
    torch.testing.assert_close(o.float(), r, rtol=tol, atol=tol)
    # and at the output's own scale, row by row: |o| falls like T^-1/2, so
    # at long T the elementwise bound is as large as o (PERF.md §6)
    rel = float(((o.float() - r).norm(dim=-1) / r.norm(dim=-1)).max())
    assert rel <= ROW_REL_LIMIT[dtype], (
        f"max row |kernel - plain| / |plain| = {rel:.3g}")


@pytest.mark.parametrize("D,dtype", [(128, F32), (96, BF16)])
def test_flash_f32_lane_unaligned(cuda, D, dtype):
    """Operands one element off a 16-byte boundary take the CUDA-core
    lane's synchronous loads and agree with the plain version."""
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref)
    rng = np.random.default_rng(D)

    def off_by_one(*shape):
        n = int(np.prod(shape))
        flat = torch.empty(n + 1, dtype=dtype, device=cuda)
        flat[1:] = torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                   device=cuda)
        return flat[1:].view(shape)
    B, H, Hkv, S, T = 1, 4, 2, 200, 200
    q = off_by_one(B, H, S, D)
    k, v = off_by_one(B, Hkv, T, D), off_by_one(B, Hkv, T, D)
    assert q.data_ptr() % 16 and q.is_contiguous()
    before = dict(LAUNCHES)
    o = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert LAUNCHES["fwd"] == before["fwd"] + 1
    assert LAUNCHES["wgmma"] == before["wgmma"]
    tol = 1e-4 if dtype == F32 else 3e-2
    r = flash_attention_ref(q, k, v, causal=True).float()
    torch.testing.assert_close(o.float(), r, rtol=tol, atol=tol)
    rel = float(((o.float() - r).norm(dim=-1) / r.norm(dim=-1)).max())
    assert rel <= ROW_REL_LIMIT[dtype], (
        f"max row |kernel - plain| / |plain| = {rel:.3g}")


@pytest.mark.parametrize("D,dtype", [(128, F32), (64, F32), (96, BF16)])
def test_flash_f32_lane_occupancy(cuda, D, dtype):
    """The CUDA-core lane keeps 8 warps resident per SM and spills
    nothing."""
    from repro_torch.kernels.flash_attention import kernel_info
    info = kernel_info(D, dtype)
    assert info["blocks_per_sm"] * info["threads"] // 32 >= 8, info
    assert info["local_bytes"] == 0, info


def test_flash_wrapper_refuses_bad_operands(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    kv = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError):
        flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError):
        flash_attention(q, kv.cpu(), kv)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), kv, kv)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 3, 8, 16), device=cuda),
                        torch.zeros((1, 3, 8, 16), device=cuda))
    with pytest.raises(ValueError):
        big = torch.zeros((1, 1, 8, 256), device=cuda)
        flash_attention(big, big, big)


@pytest.mark.parametrize("arch", ["yi-6b", "smollm-360m", "qwen1.5-4b",
                                  "minitron-4b"])
def test_smoke_forward_through_kernel(cuda, arch):
    """A smoke-size model's forward launches the kernel once per layer and
    agrees with the plain version, and the engine's prefill agrees with the
    forward's last position (f32, no TF32). A float32 model takes the
    CUDA-core lane: the tensor-core kernel is never launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import LAUNCHES, kernel_lane
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeEngine
    cfg = get_smoke_config(arch)
    model = Transformer(cfg, device=cuda, seed=0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 70)), device=cuda)
    assert kernel_lane(cfg.dtype(), cfg.head_dim_) == "f32"
    before = dict(LAUNCHES)
    logits, _ = model(tokens)
    torch.cuda.synchronize()
    assert LAUNCHES["fwd"] == before["fwd"] + cfg.n_layers
    assert LAUNCHES["wgmma"] == before["wgmma"]
    ref, _ = model(tokens, impl="ref")
    assert LAUNCHES["fwd"] == before["fwd"] + cfg.n_layers
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-4)
    eng = ServeEngine(cfg, model, max_len=80, device=cuda)
    last, cache = eng.prefill(tokens)
    torch.testing.assert_close(last, logits[:, -1], rtol=1e-4, atol=1e-4)
    a = eng.generate(tokens[:, :8], 6, temperature=0.0)
    assert torch.equal(a, eng.generate(tokens[:, :8], 6, temperature=0.0))
