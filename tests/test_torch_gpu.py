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
from repro_torch.kernels.flash_attention.bwd_cases import (
    BWD_CASES, BWD_LIMIT, DTYPES, F32_BWD_CASES, LSE_LIMIT, WGMMA_BWD_CASES,
    bwd_errors)
from repro_torch.kernels.csr_spmv import hub_cases
from repro_torch.kernels.rglru_scan import bwd_cases as lru_bwd
from repro_torch.kernels.ssd_scan import bwd_cases as ssd_bwd

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


@pytest.mark.parametrize("D,dtype", [(128, F32), (64, F32), (96, BF16),
                                     (256, F32), (160, BF16)])
def test_flash_f32_lane_occupancy(cuda, D, dtype):
    """The CUDA-core lane keeps 8 warps resident per SM and spills
    nothing (its 64-row q tiles at head dims above 128 too)."""
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
        big = torch.zeros((1, 1, 8, 257), device=cuda)
        flash_attention(big, big, big)
    with pytest.raises(ValueError):   # rows 4.. would see no column
        flash_attention(q, kv[:, :, :2], kv[:, :, :2], window=3)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv, window=0)


# the local window (RecurrentGemma's local_attn) on both lanes, and head
# dim 256 (its D): the tensor-core lane's 64-row kv tiles in bf16, the
# CUDA-core lane's 64-row q tiles in float32 and in bf16 at D in (128, 256)
WINDOW_CASES = [  # (B, H, Hkv, S, T, D, causal, dtype, window)
    (1, 10, 1, 4096, 4096, 256, True, BF16, 2048),    # recurrentgemma-2b
    (1, 10, 1, 4096, 4096, 256, True, BF16, None),
    (2, 10, 1, 128, 128, 256, True, BF16, None),
    (1, 4, 2, 1000, 1000, 256, True, BF16, 100),      # ragged
    (1, 4, 1, 300, 300, 256, False, BF16, 64),        # window, not causal
    (1, 4, 2, 200, 200, 256, True, BF16, 1),          # the diagonal only
    (1, 4, 2, 200, 200, 256, True, BF16, 199),
    (1, 8, 2, 1000, 1000, 128, True, BF16, 300),
    (1, 8, 2, 1000, 1000, 64, True, BF16, 129),
    (1, 4, 2, 256, 128, 128, True, BF16, 200),        # causal S > T
    (1, 4, 2, 128, 256, 64, True, BF16, 16),          # causal S < T
    (1, 4, 2, 40, 40, 32, True, F32, 16),             # CUDA-core lane
    (1, 4, 2, 1000, 1000, 128, True, F32, 300),
    (1, 4, 2, 1000, 1000, 64, True, F32, 1),
    (1, 4, 1, 300, 300, 20, False, F32, 77),
    (1, 4, 1, 500, 500, 256, True, F32, None),        # D = 256, f32
    (1, 4, 1, 500, 500, 256, True, F32, 130),
    (2, 4, 2, 129, 129, 200, True, F32, None),        # D = 200 pads to 256
    (1, 4, 1, 300, 300, 160, True, BF16, 64),         # bf16 on the f32 lane
    (1, 2, 1, 1, 1, 256, True, BF16, 5),              # ragged 1
    # the overlapped schedule at D = 256 (64-row kv tiles, a 2-stage ring,
    # K and V freed apart): loops of 1, 2, 3 and 4 kv tiles, the prologue,
    # the drain and the ring's wraps
    (1, 4, 1, 64, 64, 256, False, BF16, None),
    (1, 4, 1, 64, 128, 256, False, BF16, None),
    (1, 4, 1, 64, 192, 256, False, BF16, None),
    (1, 4, 1, 64, 256, 256, False, BF16, None),
    (1, 4, 2, 256, 256, 256, True, BF16, None),       # 1-4 tiles a q tile
    (1, 4, 2, 300, 300, 256, True, BF16, 63),         # whole rows masked
    (1, 4, 2, 300, 300, 256, True, BF16, 65),
    (1, 4, 1, 257, 257, 256, True, BF16, 1),
    (1, 4, 2, 100, 333, 256, False, BF16, None),      # ragged T
    (1, 4, 2, 130, 300, 256, True, BF16, None),       # causal S < T
    (1, 4, 2, 300, 130, 256, True, BF16, None),       # causal S > T
    (2, 4, 4, 200, 200, 256, True, BF16, None),       # B = 2, G = 1
    (2, 10, 1, 300, 300, 256, True, BF16, 100),       # B = 2, G = 10
]


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,dtype,window", WINDOW_CASES)
def test_flash_window_and_d256_match_plain(cuda, B, H, Hkv, S, T, D, causal,
                                           dtype, window):
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref,
                                                     kernel_lane)
    rng = np.random.default_rng(S * 1000 + T + D + (window or 0))
    q, k, v = _qkv(rng, B, H, Hkv, S, T, D, dtype, cuda)
    before = dict(LAUNCHES)
    o = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tensor_cores = kernel_lane(dtype, D) == "wgmma"
    assert tensor_cores == (dtype == BF16 and D in (64, 128, 256))
    assert LAUNCHES["fwd"] == before["fwd"] + 1
    assert LAUNCHES["wgmma"] == before["wgmma"] + int(tensor_cores)
    # the tolerances of test_flash_kernel_matches_plain
    tol = 1e-4 if dtype == F32 else 3e-2
    r = flash_attention_ref(q, k, v, causal=causal, window=window).float()
    torch.testing.assert_close(o.float(), r, rtol=tol, atol=tol)
    rel = float(((o.float() - r).norm(dim=-1) / r.norm(dim=-1)).max())
    assert rel <= ROW_REL_LIMIT[dtype], (
        f"max row |kernel - plain| / |plain| = {rel:.3g}")


def test_flash_window_none_keeps_causal_bits(cuda):
    """window=None runs the causal path as before: the same bits as a
    window wider than the sequence, which masks nothing but takes the
    window's loop bounds and tests."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(7)
    for D, dtype in ((128, BF16), (256, BF16), (128, F32)):
        q, k, v = _qkv(rng, 1, 8, 2, 700, 700, D, dtype, cuda)
        a = flash_attention(q, k, v, causal=True)
        b = flash_attention(q, k, v, causal=True, window=4096)
        assert torch.equal(a, b), D


# MLA's value head dim (DeepSeek-V3: Dk = 192, Dv = 128; its smoke config
# 24, 16) and the prefix-LM mask (PaliGemma-3B: H = 8, Hkv = 1, D = 256, a
# prefix of 256) on both lanes
MLA_PREFIX_CASES = [  # (B, H, Hkv, S, T, Dk, Dv, causal, dtype, window, prefix)
    (1, 128, 128, 2048, 2048, 192, 128, True, BF16, None, 0),  # deepseek-v3
    (4, 128, 128, 128, 128, 192, 128, True, BF16, None, 0),
    (1, 4, 2, 1000, 1000, 192, 128, True, BF16, None, 0),   # ragged
    (1, 4, 4, 129, 129, 192, 128, False, BF16, None, 0),
    (1, 4, 1, 1, 1, 192, 128, True, BF16, None, 0),          # ragged 1
    (1, 4, 2, 128, 256, 192, 128, True, BF16, None, 0),      # causal S < T
    (1, 4, 2, 256, 130, 192, 128, True, BF16, None, 0),      # causal S > T
    (1, 4, 2, 300, 300, 192, 128, True, F32, None, 0),       # CUDA-core lane
    (1, 4, 2, 129, 1000, 192, 128, True, F32, None, 0),
    (2, 4, 4, 129, 129, 24, 16, True, F32, None, 0),         # smoke dims
    (1, 4, 2, 150, 150, 24, 16, True, BF16, None, 0),
    (1, 8, 1, 2048, 2048, 256, 256, True, BF16, None, 256),  # paligemma-3b
    (4, 8, 1, 384, 384, 256, 256, True, BF16, None, 256),
    (1, 4, 1, 300, 300, 256, 256, True, BF16, None, 1),
    (1, 4, 1, 300, 300, 256, 256, True, BF16, None, 64),     # a tile edge
    (1, 4, 1, 300, 300, 256, 256, True, BF16, None, 129),
    (1, 4, 1, 300, 300, 256, 256, True, BF16, None, 1000),   # past S
    (1, 4, 2, 300, 300, 128, 128, True, BF16, None, 128),    # a tile edge
    (1, 4, 2, 300, 300, 128, 128, True, BF16, None, 200),
    (1, 4, 2, 1000, 1000, 64, 64, True, BF16, None, 77),
    (1, 4, 2, 200, 520, 64, 64, True, BF16, None, 300),      # S < T
    (1, 4, 2, 300, 300, 192, 128, True, BF16, None, 150),    # MLA + prefix
    (1, 4, 2, 300, 300, 128, 128, True, BF16, 100, 150),     # + window
    (1, 4, 2, 300, 300, 128, 128, False, BF16, None, 150),   # no effect
    (1, 4, 1, 300, 300, 256, 256, True, F32, None, 129),     # CUDA-core lane
    (1, 4, 2, 300, 300, 128, 128, True, F32, None, 128),
    (1, 4, 2, 1000, 1000, 64, 64, True, F32, None, 77),
    (2, 4, 1, 40, 40, 16, 16, True, F32, None, 8),           # smoke dims
    (1, 4, 2, 300, 300, 128, 128, True, F32, 100, 150),
    (1, 4, 2, 300, 300, 192, 128, True, F32, None, 150),
    # the ping-pong schedule at (192, 128), the two consumers taking
    # turns: loops of 1, 2, 3 and 4 kv tiles of 128 rows (their first and
    # last turns), a ragged 3
    (1, 4, 2, 128, 128, 192, 128, False, BF16, None, 0),
    (1, 4, 2, 128, 256, 192, 128, False, BF16, None, 0),
    (1, 4, 2, 128, 384, 192, 128, False, BF16, None, 0),
    (1, 4, 2, 128, 512, 192, 128, False, BF16, None, 0),
    (1, 4, 2, 128, 320, 192, 128, False, BF16, None, 0),
    (1, 4, 2, 512, 512, 192, 128, True, BF16, None, 0),   # 1-4 a q tile
    (1, 4, 2, 300, 300, 192, 128, True, BF16, 1, 0),      # window: whole
    (1, 4, 2, 300, 300, 192, 128, True, BF16, 63, 0),     # rows masked
    (1, 4, 2, 300, 300, 192, 128, True, BF16, 65, 0),
    (1, 4, 2, 100, 333, 192, 128, False, BF16, None, 0),  # ragged T
    (1, 4, 2, 300, 700, 192, 128, True, BF16, None, 0),   # causal S < T
    (2, 4, 4, 200, 200, 192, 128, True, BF16, None, 0),   # B = 2, G = 1
    (2, 10, 1, 300, 300, 192, 128, True, BF16, None, 0),  # B = 2, G = 10
    (1, 4, 1, 64, 192, 256, 256, True, BF16, None, 100),  # 3 tiles, prefix
]


def _qkv_dv(rng, B, H, Hkv, S, T, Dk, Dv, dtype, device):
    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device)
    return t(B, H, S, Dk), t(B, Hkv, T, Dk), t(B, Hkv, T, Dv)


@pytest.mark.parametrize("B,H,Hkv,S,T,Dk,Dv,causal,dtype,window,prefix",
                         MLA_PREFIX_CASES)
def test_flash_mla_and_prefix_match_plain(cuda, B, H, Hkv, S, T, Dk, Dv,
                                          causal, dtype, window, prefix):
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref,
                                                     kernel_lane)
    rng = np.random.default_rng(S * 1000 + T + Dk + Dv + prefix)
    q, k, v = _qkv_dv(rng, B, H, Hkv, S, T, Dk, Dv, dtype, cuda)
    before = dict(LAUNCHES)
    o = flash_attention(q, k, v, causal=causal, window=window,
                        prefix_len=prefix)
    torch.cuda.synchronize()
    tensor_cores = kernel_lane(dtype, Dk, Dv) == "wgmma"
    assert tensor_cores == (dtype == BF16 and (Dk, Dv) in (
        (64, 64), (128, 128), (256, 256), (192, 128)))
    assert LAUNCHES["fwd"] == before["fwd"] + 1
    assert LAUNCHES["wgmma"] == before["wgmma"] + int(tensor_cores)
    assert o.shape == (B, H, S, Dv) and o.dtype == dtype
    # the tolerances of test_flash_kernel_matches_plain
    tol = 1e-4 if dtype == F32 else 3e-2
    r = flash_attention_ref(q, k, v, causal=causal, window=window,
                            prefix_len=prefix).float()
    torch.testing.assert_close(o.float(), r, rtol=tol, atol=tol)
    rel = float(((o.float() - r).norm(dim=-1) / r.norm(dim=-1)).max())
    assert rel <= ROW_REL_LIMIT[dtype], (
        f"max row |kernel - plain| / |plain| = {rel:.3g}")


def test_flash_prefix_one_keeps_causal_bits(cuda):
    """Every causal row sees column 0, so a prefix of 1 masks as none does:
    the same bits on both lanes, and a binding prefix changes them."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(8)
    for Dk, Dv, dtype in ((256, 256, BF16), (192, 128, BF16),
                          (128, 128, F32)):
        q, k, v = _qkv_dv(rng, 1, 4, 2, 500, 500, Dk, Dv, dtype, cuda)
        a = flash_attention(q, k, v, causal=True)
        assert torch.equal(a, flash_attention(q, k, v, causal=True,
                                               prefix_len=1)), Dk
        b = flash_attention(q, k, v, causal=True, prefix_len=200)
        assert not torch.equal(a, b) and torch.equal(a[:, :, 200:],
                                                     b[:, :, 200:]), Dk


# the tensor-core forward's log-sum-exp (its LSE instantiations) at the
# redesigned schedules' head dims: the plain lse's, and o unchanged
WGMMA_LSE_CASES = [  # (B, H, Hkv, S, T, Dk, Dv, causal, window, prefix)
    (1, 10, 1, 4096, 4096, 256, 256, True, 2048, 0),  # recurrentgemma-2b
    (1, 4, 1, 64, 192, 256, 256, False, None, 0),
    (1, 4, 2, 300, 300, 256, 256, True, 63, 0),
    (2, 10, 1, 300, 130, 256, 256, True, None, 0),
    (1, 4, 1, 300, 300, 256, 256, True, None, 129),
    (1, 16, 16, 1024, 1024, 192, 128, True, None, 0),  # deepseek-v3 heads
    (1, 4, 2, 128, 320, 192, 128, False, None, 0),
    (1, 4, 2, 300, 300, 192, 128, True, 65, 0),
    (2, 10, 1, 300, 700, 192, 128, True, None, 150),
]


@pytest.mark.parametrize("B,H,Hkv,S,T,Dk,Dv,causal,window,prefix",
                         WGMMA_LSE_CASES)
def test_flash_wgmma_lse_matches_plain(cuda, B, H, Hkv, S, T, Dk, Dv,
                                       causal, window, prefix):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    rng = np.random.default_rng(S * 1000 + T + Dk + Dv + prefix + 2)
    q, k, v = _qkv_dv(rng, B, H, Hkv, S, T, Dk, Dv, BF16, cuda)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    _, want = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert lse.dtype == F32 and lse.shape == (B, H, S)
    assert float((lse - want).abs().max()) <= LSE_LIMIT
    assert torch.equal(o, flash_attention(q, k, v, **kw))


def test_flash_wgmma_attrs_spill_nothing(cuda):
    """The tensor-core forward as compiled: every instantiation at the
    redesigned head dims, (256, 256) (one consumer, its products
    overlapped) and (192, 128) (two consumers taking turns), with and
    without the prefix and the log-sum-exp, spills no register and fits
    one block an SM."""
    from repro_torch.kernels.flash_attention import wgmma_kernel_attrs
    attrs = wgmma_kernel_attrs()
    assert len(attrs) == 16, sorted(attrs)
    for name, a in attrs.items():
        assert a["blocks"] >= 1, (name, a)
        if name.split()[0] in ("256x256", "192x128"):
            assert a["local"] == 0, (name, a)


@pytest.mark.parametrize("Dk,Dv,dtype", [(192, 128, F32), (24, 16, F32),
                                         (160, 128, BF16)])
def test_flash_f32_lane_occupancy_dv(cuda, Dk, Dv, dtype):
    """The CUDA-core lane at a value head dim of its own (MLA's (192, 128)
    in float32, its smoke config's (24, 16)) keeps 8 warps resident per SM
    and spills nothing."""
    from repro_torch.kernels.flash_attention import kernel_info
    info = kernel_info(Dk, dtype, Dv)
    assert info["blocks_per_sm"] * info["threads"] // 32 >= 8, info
    assert info["local_bytes"] == 0, info


def test_flash_wrapper_refuses_bad_dv_and_prefix(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros((1, 4, 8, 24), device=cuda)
    k = torch.zeros((1, 2, 8, 24), device=cuda)
    with pytest.raises(ValueError):      # v's T differs from k's
        flash_attention(q, k, torch.zeros((1, 2, 7, 16), device=cuda))
    with pytest.raises(ValueError):      # Dv past 256
        flash_attention(q, k, torch.zeros((1, 2, 8, 257), device=cuda))
    with pytest.raises(ValueError):
        flash_attention(q, k, torch.zeros((1, 2, 8, 16), device=cuda),
                        prefix_len=-1)
    o = flash_attention(q, k, torch.zeros((1, 2, 8, 16), device=cuda))
    assert o.shape == (1, 4, 8, 16)
    # B * H past 65,535: the grid is 1-D
    many = torch.zeros((65536, 1, 1, 16), device=cuda)
    assert flash_attention(many, many, many).shape == many.shape


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "paligemma-3b"])
def test_mla_and_prefix_smoke_forward_through_kernel(cuda, arch):
    """The DeepSeek-V3 smoke model (MLA at Dk = 24, Dv = 16; a dense layer,
    then MoE) and the PaliGemma smoke model with a prefix of 8 embeddings:
    the forward launches the flash kernel once per layer on the CUDA-core
    lane and agrees with the plain version (float32, no TF32), and the
    engine's prefill through the decode path (MLA's latent cache) agrees
    with the forward's last position where no prefix is given (8-token
    prompts, which the MoE routes without drops in both)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeEngine
    cfg = get_smoke_config(arch)
    model = Transformer(cfg, device=cuda, seed=0)
    rng = np.random.default_rng(0)
    # 64 tokens: two of the smoke MoE's groups of 32
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                             device=cuda)
    prefix = None
    if cfg.prefix_len:
        prefix = torch.as_tensor(rng.standard_normal(
            (2, cfg.prefix_len, cfg.d_model)), dtype=torch.float32,
            device=cuda)
    for pre in (prefix, None):
        before = dict(LAUNCHES)
        logits, _ = model(tokens, prefix_embeds=pre)
        torch.cuda.synchronize()
        assert LAUNCHES["fwd"] == before["fwd"] + cfg.n_layers
        assert LAUNCHES["wgmma"] == before["wgmma"]
        ref, _ = model(tokens, prefix_embeds=pre, impl="ref")
        torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-4)
    # 8-token prompts: 16 tokens route drop-free in the forward too
    eng = ServeEngine(cfg, model, max_len=40, device=cuda)
    last, _ = eng.prefill(tokens[:, :8])
    torch.testing.assert_close(last, model(tokens[:, :8])[0][:, -1],
                               rtol=1e-4, atol=1e-4)
    a = eng.generate(tokens[:, :8], 6, temperature=0.0)
    assert torch.equal(a, eng.generate(tokens[:, :8], 6, temperature=0.0))


# ---------------------------------------------------------------------------
# the SSD and RG-LRU scans
# ---------------------------------------------------------------------------
def _ssd_inputs(rng, B, S, H, P, N, dtype, device, h0=False):
    def t(*shape, scale=1.0, dt=dtype):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=dt,
                               device=device)
    x, b, c = t(B, S, H, P), t(B, S, N, scale=0.3), t(B, S, N, scale=0.3)
    dt = torch.nn.functional.softplus(t(B, S, H, dt=F32) - 1.0)
    a_log = t(H, scale=0.5, dt=F32)
    return x, b, c, dt, a_log, (t(B, H, P, N, dt=F32) if h0 else None)


SSD_CASES = [  # (B, S, H, P, N, Q, dtype, h0)
    (1, 2048, 80, 64, 128, 256, BF16, False),         # mamba2-2.7b
    (4, 128, 80, 64, 128, 256, BF16, False),          # S < Q
    (1, 1, 80, 64, 128, 256, BF16, True),             # a decode step
    (1, 1, 80, 64, 128, 256, F32, True),
    (4, 1, 80, 64, 128, 256, BF16, True),             # the decode shape
    (4, 1, 80, 64, 128, 256, F32, True),
    (4, 2048, 80, 64, 128, 256, BF16, True),          # h0 across 8 chunks
    (1, 257, 80, 64, 128, 256, BF16, False),          # S = Q + 1
    (2, 257, 8, 64, 128, 256, F32, True),
    (1, 600, 8, 64, 128, 256, F32, False),            # ragged S % Q
    (2, 300, 4, 64, 128, 128, F32, True),             # h0 carry
    (2, 21, 8, 16, 16, 8, F32, False),                # mamba2 smoke shapes
    (2, 37, 3, 40, 100, 16, F32, True),               # P, N, Q not tiles
    (3, 1, 3, 40, 100, 16, F32, True),                # N % 4: scalar step
]


@pytest.mark.parametrize("B,S,H,P,N,Q,dtype,h0", SSD_CASES)
def test_ssd_scan_matches_plain(cuda, B, S, H, P, N, Q, dtype, h0):
    """The kernel against its plain version on the same inputs: its
    products in split TF32 (float32 accuracy) and the plain version's in
    float32, summed in other orders (chunk-parallel, the state carried by
    a second launch, y's two terms in one accumulator), so within 1e-4 of
    y's and the state's largest value; bf16 rounds y once more (2^-8
    relative). Three launches a call, counted in "scan"; one at S = 1
    (the decode step), counted in "step"."""
    from repro_torch.kernels.ssd_scan import (LAUNCHES, ssd_scan_kernel,
                                              ssd_scan_ref)
    rng = np.random.default_rng(S + H + N)
    args = _ssd_inputs(rng, B, S, H, P, N, dtype, cuda, h0)
    before = dict(LAUNCHES)
    y, h = ssd_scan_kernel(*args[:5], Q, h0=args[5])
    torch.cuda.synchronize()
    assert LAUNCHES == (dict(before, step=before["step"] + 1) if S == 1
                        else dict(before, scan=before["scan"] + 3))
    yr, hr = ssd_scan_ref(*args[:5], Q, h0=args[5])
    assert y.dtype == dtype and h.dtype == F32
    tol = 1e-4 if dtype == F32 else 1e-2
    assert float((y.float() - yr.float()).abs().max()) <= \
        tol * float(yr.float().abs().max())
    assert float((h - hr).abs().max()) <= 1e-4 * float(hr.abs().max())


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ssd_scan_rising_cum_matches_plain(cuda, dtype):
    """With some dt < 0, cum rises inside a chunk and the kernel forms
    every W element with its own exp (the factored form below a panel
    needs cum never to rise): still the plain version's result, at the
    tolerances of `test_ssd_scan_matches_plain`."""
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel, ssd_scan_ref
    rng = np.random.default_rng(13)
    x, b, c, _, a_log, h0 = _ssd_inputs(rng, 2, 300, 8, 64, 128, dtype,
                                        cuda, True)
    dt = torch.as_tensor(0.1 * rng.standard_normal((2, 300, 8)), dtype=F32,
                         device=cuda)
    assert bool((dt < 0).any())
    y, h = ssd_scan_kernel(x, b, c, dt, a_log, 256, h0=h0)
    yr, hr = ssd_scan_ref(x, b, c, dt, a_log, 256, h0=h0)
    tol = 1e-4 if dtype == F32 else 1e-2
    assert float((y.float() - yr.float()).abs().max()) <= \
        tol * float(yr.float().abs().max())
    assert float((h - hr).abs().max()) <= 1e-4 * float(hr.abs().max())


@pytest.mark.parametrize("B,S,dtype", [(1, 2048, BF16), (4, 2048, F32),
                                       (4, 1, BF16), (4, 1, F32)])
def test_ssd_scan_repeats_bit_for_bit(cuda, B, S, dtype):
    """Every sum of the kernel runs in a fixed order: the same inputs give
    the same bits, call after call (Mamba2-2.7B's widths, prefill and the
    decode step)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    rng = np.random.default_rng(11)
    args = _ssd_inputs(rng, B, S, 80, 64, 128, dtype, cuda, True)
    y, h = ssd_scan_kernel(*args[:5], 256, h0=args[5])
    for _ in range(3):
        y2, h2 = ssd_scan_kernel(*args[:5], 256, h0=args[5])
        assert torch.equal(y, y2) and torch.equal(h, h2)


def test_ssd_scan_refuses_bad_operands(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_kernel
    rng = np.random.default_rng(0)
    x, b, c, dt, a_log, _ = _ssd_inputs(rng, 1, 8, 2, 16, 16, F32, cuda)
    with pytest.raises(TypeError):
        ssd_scan_kernel(x.half(), b, c, dt, a_log, 4)
    with pytest.raises(ValueError):                     # P > 64
        wide = _ssd_inputs(rng, 1, 8, 2, 80, 16, F32, cuda)
        ssd_scan_kernel(*wide[:5], 4)
    with pytest.raises(ValueError):
        ssd_scan_kernel(x, b.cpu(), c, dt, a_log, 4)
    with pytest.raises(ValueError):
        ssd_scan_kernel(x.transpose(2, 3), b, c, dt, a_log, 4)
    with pytest.raises(ValueError):
        ssd_scan(x.cpu(), b.cpu(), c.cpu(), dt.cpu(), a_log.cpu(), 4,
                 impl="cuda")


def _lru_inputs(rng, B, S, W, dtype, device, h0=False):
    def t(*shape, dt=F32, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=dt,
                               device=device)
    return (t(B, S, W, dt=dtype), t(B, S, W), t(B, S, W), t(W, scale=0.5),
            t(W, scale=0.5), t(W) + 1.0, t(B, W) if h0 else None)


LRU_CASES = [  # (B, S, W, dtype, h0)
    (1, 4096, 2560, BF16, False),                     # recurrentgemma-2b
    (4, 128, 2560, BF16, False),
    (4, 1, 2560, BF16, True),                         # a decode step
    (4, 1, 2560, F32, True),
    (2, 129, 2560, BF16, True),                       # one window + 1
    (1, 16384, 256, F32, True),                       # 128 windows
    (1, 32768, 2560, BF16, True),                     # 512 chunks in groups
    (2, 1000, 300, F32, True),                        # ragged W, h0 carry
    (3, 65, 64, F32, False),                          # smoke width
    (1, 7, 5, F32, True),
]


@pytest.mark.parametrize("B,S,W,dtype,h0", LRU_CASES)
def test_rglru_scan_matches_plain(cuda, B, S, W, dtype, h0):
    """The fused kernel against the plain gates and doubling scan: both in
    float32; the kernel runs the recurrence step by step from each
    segment's carry and the plain version as a log-depth tree, and expf
    and the sigmoids round apart from PyTorch's by an ulp, so h agrees
    within 1e-5 of its largest value. One launch a call ("step" at
    S = 1)."""
    from repro_torch.kernels.rglru_scan import (LAUNCHES, rglru_scan_kernel,
                                                rglru_scan_ref)
    rng = np.random.default_rng(S + W)
    args = _lru_inputs(rng, B, S, W, dtype, cuda, h0)
    before = dict(LAUNCHES)
    h = rglru_scan_kernel(*args)
    torch.cuda.synchronize()
    key = "step" if S == 1 else "scan"
    assert LAUNCHES == dict(before, **{key: before[key] + 1})
    r = rglru_scan_ref(*args)
    assert h.dtype == F32 and h.shape == (B, S, W)
    assert float((h - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("B,S,dtype", [(1, 4096, BF16), (4, 1, BF16),
                                       (1, 16384, F32)])
def test_rglru_scan_repeats_bit_for_bit(cuda, B, S, dtype):
    """The windows' folds run in a fixed order: the same inputs give the
    same bits, call after call (RecurrentGemma-2B's width)."""
    from repro_torch.kernels.rglru_scan import rglru_scan_kernel
    rng = np.random.default_rng(12)
    args = _lru_inputs(rng, B, S, 2560 if S < 16384 else 256, dtype, cuda,
                       True)
    h = rglru_scan_kernel(*args)
    for _ in range(3):
        assert torch.equal(h, rglru_scan_kernel(*args))


def test_rglru_scan_refuses_bad_operands(cuda):
    from repro_torch.kernels.rglru_scan import rglru_scan_kernel
    rng = np.random.default_rng(0)
    u, ga, gi, b_a, b_i, lam, _ = _lru_inputs(rng, 1, 8, 16, F32, cuda)
    with pytest.raises(TypeError):
        rglru_scan_kernel(u, ga.bfloat16(), gi, b_a, b_i, lam)
    with pytest.raises(ValueError):
        rglru_scan_kernel(u, ga[:, :4], gi, b_a, b_i, lam)
    with pytest.raises(ValueError):
        rglru_scan_kernel(u, ga, gi, b_a, b_i, lam.cpu())
    with pytest.raises(ValueError):
        rglru_scan_kernel(u, ga, gi, b_a, b_i, lam,
                          h0=torch.zeros((2, 16), device=cuda))


@pytest.mark.parametrize("B,S,W,dtype,h0,clamp", lru_bwd.BWD_CASES)
def test_rglru_scan_bwd_matches_plain(cuda, B, S, W, dtype, h0, clamp):
    """The backward kernel against the plain backward on the same inputs
    and the forward kernel's h (as training saves it): each gradient
    within its limit (`bwd_cases.bwd_limits`), two calls bit for bit
    equal (no atomics add a value), one count in "bwd" a call."""
    from repro_torch.kernels.rglru_scan import (LAUNCHES,
                                                rglru_scan_bwd_kernel,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_kernel)
    args, dh = lru_bwd.bwd_inputs(B, S, W, dtype, h0, clamp, cuda, S + W)
    h = rglru_scan_kernel(*args)
    before = dict(LAUNCHES)
    got = rglru_scan_bwd_kernel(*args[:6], h, dh, args[6])
    again = rglru_scan_bwd_kernel(*args[:6], h, dh, args[6])
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, bwd=before["bwd"] + 2)
    ref = rglru_scan_bwd_ref(*args[:6], h, dh, args[6])
    for name, a, b, c, err, limit in zip(
            lru_bwd.GRADS, got, ref, again, lru_bwd.bwd_errors(got, ref),
            lru_bwd.bwd_limits(dtype)):
        if b is None:
            assert a is None and c is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, c), f"{name} differs between two runs"
        assert err <= limit, f"{name}: {err:.3g}"


def test_rglru_scan_bwd_flags_left_all_ones(cuda):
    """The backward's flags (the ticket, the composite words, the channel
    tiles' counts), kept between calls for each stream, are all ones after
    every call, over one group and in groups, B > 1 and ragged W; so a
    call after calls of other shapes gives the bits of the first."""
    from repro_torch.kernels.rglru_scan import (bwd_flags,
                                                rglru_scan_bwd_kernel,
                                                rglru_scan_kernel)
    stream = torch.cuda.current_stream().cuda_stream
    first = None
    for B, S, W in ((1, 4096, 2560), (3, 4097, 200), (2, 100, 70),
                    (1, 4096, 2560)):
        args, dh = lru_bwd.bwd_inputs(B, S, W, "bf16", True, False, cuda, 7)
        h = rglru_scan_kernel(*args)
        got = rglru_scan_bwd_kernel(*args[:6], h, dh, args[6])
        torch.cuda.synchronize()
        flags = bwd_flags(cuda, stream)
        assert flags is not None and bool((flags == 255).all()), (B, S, W)
        if first is None:
            first = got
        elif S == 4096:
            assert all(torch.equal(a, b) for a, b in zip(got, first))


def test_rglru_kernel_attrs_spill_nothing(cuda):
    """The runtime's report of every RG-LRU kernel (`kernel_attrs`): the
    backward's four instantiations spill nothing and keep four blocks of
    256 threads an SM, the forward without groups spills nothing."""
    from repro_torch.kernels.rglru_scan import kernel_attrs
    attrs = kernel_attrs()
    bwd = {k: a for k, a in attrs.items() if "bwd" in k}
    assert len(bwd) == 4 and len(attrs) == 10
    for name, a in bwd.items():
        assert a["local"] == 0 and a["blocks"] >= 4, (name, a)
    for name in ("rglru_scan_kernel<float>", "rglru_scan_kernel<bf16>"):
        assert attrs[name]["local"] == 0, (name, attrs[name])


def test_rglru_scan_bwd_refuses_bad_operands(cuda):
    from repro_torch.kernels.rglru_scan import (rglru_scan_bwd,
                                                rglru_scan_bwd_kernel)
    rng = np.random.default_rng(0)
    u, ga, gi, b_a, b_i, lam, _ = _lru_inputs(rng, 1, 8, 16, F32, cuda)
    h, dh = torch.zeros_like(ga), torch.ones_like(ga)
    with pytest.raises(TypeError):
        rglru_scan_bwd_kernel(u, ga, gi, b_a, b_i, lam, h, dh.bfloat16())
    with pytest.raises(ValueError):
        rglru_scan_bwd_kernel(u, ga, gi, b_a, b_i, lam, h[:, :4], dh)
    with pytest.raises(ValueError):
        rglru_scan_bwd_kernel(u, ga, gi, b_a, b_i, lam, h, dh.cpu())
    with pytest.raises(ValueError):
        rglru_scan_bwd_kernel(u, ga, gi, b_a, b_i, lam, h,
                              torch.ones((1, 16, 8), device=cuda)
                              .transpose(1, 2))
    with pytest.raises(ValueError):
        rglru_scan_bwd_kernel(u, ga, gi, b_a, b_i, lam, h, dh,
                              h0=torch.zeros((2, 16), device=cuda))
    with pytest.raises(ValueError):
        rglru_scan_bwd(*(t.cpu() for t in (u, ga, gi, b_a, b_i, lam, h,
                                           dh)), impl="cuda")


@pytest.mark.parametrize("B,S,H,P,N,Q,dtype,h0,dh_last,steep",
                         ssd_bwd.BWD_CASES)
def test_ssd_scan_bwd_matches_plain(cuda, B, S, H, P, N, Q, dtype, h0,
                                    dh_last, steep):
    """The SSD backward kernel against the plain backward on the same
    inputs: each gradient within its limit (`bwd_cases.bwd_limits`), two
    calls bit for bit equal (no atomics add a value), one count in "bwd" a
    call."""
    from repro_torch.kernels.ssd_scan import (LAUNCHES, ssd_scan_bwd_kernel,
                                              ssd_scan_bwd_ref)
    args, dy, dhl = ssd_bwd.bwd_inputs(B, S, H, P, N, dtype, h0, dh_last,
                                       steep, cuda, S + H)
    before = dict(LAUNCHES)
    got = ssd_scan_bwd_kernel(*args[:5], Q, dy, dhl, args[5])
    again = ssd_scan_bwd_kernel(*args[:5], Q, dy, dhl, args[5])
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, bwd=before["bwd"] + 2)
    ref = ssd_scan_bwd_ref(*args[:5], Q, dy, dhl, args[5])
    for name, a, b, c, err, limit in zip(
            ssd_bwd.GRADS, got, ref, again, ssd_bwd.bwd_errors(got, ref),
            ssd_bwd.bwd_limits(dtype)):
        if b is None:
            assert a is None and c is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, c), f"{name} differs between two runs"
        assert err <= limit, f"{name}: {err:.3g}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_scan_function_matches_autograd(cuda, dtype):
    """SSDScan on the card (the forward and backward kernels) against
    torch.autograd through the plain forward, with h0 and a gradient on
    the final state: every input's gradient within the cases' limits.
    Chunks of 32 keep cum above -88 inside a chunk: past that, autograd
    through the plain forward gives ddt NaN (exp of the masked upper
    triangle overflows; 0 x inf through the where), which the closed-form
    backward never forms."""
    from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan_ref
    args, dy, dhl = ssd_bwd.bwd_inputs(2, 300, 8, 64, 128, dtype, True,
                                       True, False, cuda, 5)
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = SSDScan.apply(*leaves, 32, "cuda")
    got = torch.autograd.grad((y.float() * dy.float()).sum()
                              + (h * dhl).sum(), leaves)
    leaves = [t.clone().requires_grad_() for t in args]
    yr, hr = ssd_scan_ref(*leaves[:5], 32, h0=leaves[5])
    ref = torch.autograd.grad((yr.float() * dy.float()).sum()
                              + (hr * dhl).sum(), leaves)
    for name, err, limit in zip(ssd_bwd.GRADS, ssd_bwd.bwd_errors(got, ref),
                                ssd_bwd.bwd_limits(dtype)):
        assert err <= limit, f"{name}: {err:.3g}"


def test_ssd_kernel_attrs_keep_their_occupancy(cuda):
    """The CUDA runtime's report of the SSD kernels (`kernel_attrs`): the
    bf16 forward's chunk kernel keeps 3 blocks an SM, which its speed
    needs (2 blocks cost it 2.5%); the bf16 backward's main and dB, dC
    kernels keep 2 blocks an SM and its score-gradient kernel 3; every
    kernel of both lanes reports at least one block."""
    from repro_torch.kernels.ssd_scan import kernel_attrs
    bf, f32 = kernel_attrs(True), kernel_attrs(False)
    assert len(bf) == len(f32) == 8
    assert bf["ssd_chunk_kernel"]["blocks"] == 3
    assert bf["ssd_bwd_main_kernel"]["blocks"] >= 2
    assert bf["ssd_bwd_dbc_kernel"]["blocks"] >= 2
    assert bf["ssd_bwd_dcb_kernel"]["blocks"] >= 3
    assert all(a["blocks"] >= 1 for a in (*bf.values(), *f32.values()))


def test_ssd_scan_bwd_refuses_bad_operands(cuda):
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd,
                                              ssd_scan_bwd_kernel)
    args, dy, dhl = ssd_bwd.bwd_inputs(1, 8, 2, 16, 16, "f32", True, True,
                                       False, cuda, 0)
    x, b, c, dt, a_log, h0 = args
    with pytest.raises(TypeError):                      # dy not x's dtype
        ssd_scan_bwd_kernel(x, b, c, dt, a_log, 4, dy.bfloat16())
    with pytest.raises(TypeError):                      # dh_last float32
        ssd_scan_bwd_kernel(x, b, c, dt, a_log, 4, dy, dhl.double())
    with pytest.raises(ValueError):
        ssd_scan_bwd_kernel(x, b, c, dt, a_log, 4, dy[:, :4])
    with pytest.raises(ValueError):
        ssd_scan_bwd_kernel(x, b, c, dt, a_log, 4, dy, dhl[:, :1])
    with pytest.raises(ValueError):
        ssd_scan_bwd_kernel(x, b, c, dt, a_log, 4, dy.cpu())
    with pytest.raises(ValueError):
        ssd_scan_bwd_kernel(x, b, c, dt, a_log, 4,
                            dy.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError):
        ssd_scan_bwd(*(t.cpu() for t in (x, b, c, dt, a_log)), 4, dy.cpu(),
                     impl="cuda")


def test_mamba2_smoke_train_step_kernels_match_plain(cuda):
    """One step of the smoke Mamba2's loss and gradients through the SSD
    scan's forward and backward kernels against impl="ref" on the same
    weights (float32): the loss within 1e-5 relative, every gradient leaf
    within 1e-4 of its largest element; one backward call per SSD
    layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticTokens, make_batch
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.models import Transformer
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import lm_loss
    cfg = get_smoke_config("mamba2-2.7b")
    model = Transformer(cfg, device=cuda, seed=0, trainable=True)
    pipe = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=100,
                                      global_batch=2))
    batch = make_batch(pipe, cfg, 0, device=cuda)
    leaves = tree_leaves(model.param_tree())
    out = {}
    for impl in ("cuda", "ref"):
        before = SSD["bwd"]
        loss, _ = lm_loss(model, batch, impl=impl)
        out[impl] = (loss.detach(), torch.autograd.grad(loss, leaves))
        assert SSD["bwd"] - before == (impl == "cuda") * cfg.layer_kinds(
            ).count("ssd")
    (lc, gc), (lr, gr) = out["cuda"], out["ref"]
    assert float(lc) == pytest.approx(float(lr), rel=1e-5)
    for a, b in zip(gc, gr):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_recurrent_smoke_train_step_kernels_match_plain(cuda):
    """One step of the smoke RecurrentGemma's loss and gradients through
    the kernels (the RG-LRU forward and backward, the flash forward and
    backward with the window) against impl="ref" on the same weights
    (float32): the loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest element; one backward call per layer of each
    kind."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticTokens, make_batch
    from repro_torch.kernels.flash_attention import LAUNCHES as FLASH
    from repro_torch.kernels.rglru_scan import LAUNCHES as LRU
    from repro_torch.models import Transformer
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import lm_loss
    cfg = get_smoke_config("recurrentgemma-2b")
    kinds = cfg.layer_kinds()
    model = Transformer(cfg, device=cuda, seed=0, trainable=True)
    pipe = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=100,
                                      global_batch=2))
    batch = make_batch(pipe, cfg, 0, device=cuda)
    leaves = tree_leaves(model.param_tree())
    out = {}
    for impl in ("cuda", "ref"):
        before = (FLASH["bwd"], LRU["bwd"])
        loss, _ = lm_loss(model, batch, impl=impl)
        out[impl] = (loss.detach(), torch.autograd.grad(loss, leaves))
        on = impl == "cuda"
        assert (FLASH["bwd"] - before[0], LRU["bwd"] - before[1]) == (
            on * kinds.count("local_attn"), on * kinds.count("rglru"))
    (lc, gc), (lr, gr) = out["cuda"], out["ref"]
    assert float(lc) == pytest.approx(float(lr), rel=1e-5)
    for a, b in zip(gc, gr):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_recurrent_smoke_forward_through_kernels(cuda, arch):
    """A smoke Mamba2 / RecurrentGemma forward launches the SSD scan's three
    kernels once per SSD layer, the RG-LRU's one per RG-LRU layer and the
    flash kernel once per local_attn layer,
    agrees with the plain versions, and its decode path (the scans at
    S = 1 from the cached states) agrees with the forward past the
    window's ring (float32, no TF32)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import LAUNCHES as FLASH
    from repro_torch.kernels.rglru_scan import LAUNCHES as LRU
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeEngine
    cfg = get_smoke_config(arch)
    kinds = cfg.layer_kinds()
    model = Transformer(cfg, device=cuda, seed=0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)), device=cuda)
    before = (FLASH["fwd"], SSD["scan"], LRU["scan"])
    logits, _ = model(tokens)
    torch.cuda.synchronize()
    assert (FLASH["fwd"], SSD["scan"], LRU["scan"]) == (
        before[0] + kinds.count("local_attn"),
        before[1] + 3 * kinds.count("ssd"),
        before[2] + kinds.count("rglru"))
    ref, _ = model(tokens, impl="ref")
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-4)
    eng = ServeEngine(cfg, model, max_len=48, device=cuda)
    last, cache = eng.prefill(tokens)
    torch.testing.assert_close(last, logits[:, -1], rtol=1e-4, atol=1e-4)


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


# ---------------------------------------------------------------------------
# CSR segment sum and the shard program
# ---------------------------------------------------------------------------
def random_csr(rng, n_rows, n_cols, mean_deg, long_rows=()):
    """Row-sorted edges with an indptr: Poisson row lengths (many empty
    rows at a small mean), then each (row, length) of `long_rows` set."""
    deg = rng.poisson(mean_deg, n_rows)
    for r, length in long_rows:
        deg[r] = length
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    nnz = int(indptr[-1])
    src = rng.integers(0, n_cols, nnz).astype(np.int32)
    w = rng.random(nnz) / np.maximum(1, rng.integers(1, 50, nnz))
    rows = np.repeat(np.arange(n_rows), deg).astype(np.int32)
    return indptr, src, w, rows


def _csr_dev(arrays, dtype, device):
    indptr, src, w, rows = arrays
    return (torch.as_tensor(indptr, device=device),
            torch.as_tensor(src, device=device),
            torch.as_tensor(w, device=device).to(dtype),
            torch.as_tensor(rows, device=device))


E = 2048    # edges a block of the kernel owns (csr_spmv.cu's kChunk)
CSR_CASES = [  # (n_rows, n_cols, mean in-degree, (row, length) overrides)
    (1, 1, 0.0, ()), (33, 50, 3.0, ()), (1000, 1000, 8.0, ()),
    (4000, 3000, 0.7, ()), (2000, 5000, 8.0, ((666, 79_727),)),
    (70_000, 70_000, 8.0, ()),
    # rows of exactly E edges and of E - 1, E + 1 on chunk boundaries, an
    # empty row at a chunk's edge, empty rows at the end
    (12, 300, 0.0, ((0, E), (1, E - 1), (2, 1), (3, E + 1), (4, E - 1),
                    (6, E), (7, 2))),
    # rows spanning 1, 2 and 101 chunks among short ones
    (5000, 5000, 8.0, ((100, 100 * E + 17), (2000, E + 500), (3000, E))),
    # an empty row at every chunk edge and at the end
    (100, 700, 0.0, tuple((r, 256) for r in range(0, 100, 2))),
    (10, 10, 0.0, ()),                                  # nnz = 0
]


def _csr_case(case, nv, dtype, device):
    n_rows, n_cols, deg, long_rows = case
    rng = np.random.default_rng(n_rows + nv)
    arrays = random_csr(rng, n_rows, n_cols, deg, long_rows)
    x = torch.as_tensor(rng.random((n_cols, nv)), device=device).to(dtype)
    return arrays, _csr_dev(arrays, dtype, device), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nv", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("case", CSR_CASES)
def test_csr_kernel_matches_plain(cuda, case, nv, dtype):
    """The kernel against its plain version. float64: 1e-12 relative to
    the largest |y|. float32: each row within the bound of two float32
    sums of the same terms in two orders, 4 * nnz_r * 2^-24 * sum|w x|
    (each recursive sum errs by at most ~nnz_r units of roundoff). Two runs
    give the same bits, and each lane the bits of its 1-wide call."""
    from repro_torch.kernels.csr_spmv import LAUNCHES, csr_spmv, csr_spmv_ref
    n_rows = case[0]
    arrays, (indptr, src, w, rows), x = _csr_case(case, nv, dtype, cuda)
    before = dict(LAUNCHES)
    y = csr_spmv(indptr, src, w, x, n_rows)
    lane = "f32" if dtype == torch.float32 else "f64"
    assert LAUNCHES[lane] == before[lane] + 1
    y_ref = csr_spmv_ref(rows, src, w, x, n_rows)
    torch.cuda.synchronize()
    assert y.shape == (n_rows, nv) and y.dtype == dtype
    diff = (y.double() - y_ref.double()).abs()
    if dtype == torch.float64:
        assert float(diff.max()) <= 1e-12 * max(1.0, float(y_ref.abs().max()))
    else:
        absum = csr_spmv_ref(rows, src, w.double().abs(), x.double().abs(),
                             n_rows)
        nnz_r = torch.as_tensor(np.diff(arrays[0]), device=cuda)[:, None]
        assert bool((diff <= 4 * nnz_r * 2.0 ** -24 * absum).all())
    assert torch.equal(y, csr_spmv(indptr, src, w, x, n_rows))
    for j in range(nv):
        y1 = csr_spmv(indptr, src, w, x[:, j].contiguous(), n_rows)
        assert torch.equal(y1, y[:, j]), j


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_kernel_fixed_order(cuda, dtype):
    """Two runs give the same bits, and lane j of an nv-wide call gives the
    bits of the 1-wide call on lane j (the kernel's order depends on the
    edge positions alone); the plain version's index_add_ promises
    neither on the card."""
    from repro_torch.kernels.csr_spmv import csr_spmv
    rng = np.random.default_rng(5)
    arrays = random_csr(rng, 20_000, 20_000, 8.0, ((6666, 30_000),))
    indptr, src, w, _ = _csr_dev(arrays, dtype, cuda)
    for nv in (1, 2, 3, 8, 11, 16):
        x = torch.as_tensor(rng.random((20_000, nv)), device=cuda).to(dtype)
        y = csr_spmv(indptr, src, w, x, 20_000)
        assert torch.equal(y, csr_spmv(indptr, src, w, x, 20_000))
        for j in range(nv):
            y1 = csr_spmv(indptr, src, w, x[:, j].contiguous(), 20_000)
            assert torch.equal(y1, y[:, j]), (nv, j)


def _ulps_apart(a, b):
    """|a - b| in units of the float32 spacing at max(|a|, |b|)."""
    m = torch.maximum(a.abs(), b.abs())
    ulp = torch.nextafter(m, torch.full_like(m, float("inf"))) - m
    return (a - b).abs() / ulp


@pytest.mark.parametrize("nv", [1, 3, 8])
@pytest.mark.parametrize("case", CSR_CASES[1:] + hub_cases.HUB_CASES)
def test_csr_hub_lane_within_one_ulp(cuda, case, nv):
    """The hub lane (float32 operands, float64 products and sum, added
    into y[row_map] in place) against its plain version, the float64 sum
    rounded to float32 and added: within 1 float32 ulp per element (the two
    float64 sums differ by ~1e-16 relative, so their roundings are at most
    one apart), rows outside row_map untouched, the same bits run to run
    and lane by lane; also over rows built round the lane's own blocks of
    512 edges (`hub_cases`: a row over 1,000 blocks, rows ending on a
    block's edge, every block ending inside a row)."""
    from repro_torch.kernels.csr_spmv import (LAUNCHES, csr_spmv_hub_add,
                                              csr_spmv_hub_add_ref)
    n_rows = case[0]
    _, (indptr, src, w, _), x = _csr_case(case, nv, torch.float32, cuda)
    rng = np.random.default_rng(nv)
    n_out = 3 * n_rows + 5
    row_map = torch.as_tensor(np.sort(rng.choice(n_out, n_rows, False))
                              .astype(np.int32), device=cuda)
    y0 = torch.as_tensor(rng.random((n_out, nv)), device=cuda).float()
    before = LAUNCHES["hub"]
    y = csr_spmv_hub_add(indptr, src, w, x, row_map, y0.clone())
    assert LAUNCHES["hub"] == before + 1
    ref = csr_spmv_hub_add_ref(indptr, src, w, x, row_map, y0.clone())
    torch.cuda.synchronize()
    assert float(_ulps_apart(y, ref).max()) <= 1.0
    untouched = torch.ones(n_out, dtype=torch.bool, device=cuda)
    untouched[row_map.long()] = False
    assert torch.equal(y[untouched], y0[untouched])
    assert torch.equal(y, csr_spmv_hub_add(indptr, src, w, x, row_map,
                                           y0.clone()))
    for j in range(nv):
        y1 = csr_spmv_hub_add(indptr, src, w, x[:, j:j + 1].contiguous(),
                              row_map, y0[:, j:j + 1].contiguous())
        assert torch.equal(y1[:, 0], y[:, j]), j


def test_csr_hub_lane_counts_back_at_zero(cuda):
    """The hub lane's counts (the workspace kept between calls) are zero
    after a call, so that a second call, a call on copies of the operands
    and a call on another stream (a workspace of its own) give the same
    bits."""
    from repro_torch.kernels.csr_spmv import csr_spmv_hub_add, hub_counts
    case = hub_cases.HUB_CASES[1]
    _, (indptr, src, w, _), x = _csr_case(case, 3, torch.float32, cuda)
    row_map = torch.arange(case[0], dtype=torch.int32, device=cuda)
    y0 = torch.rand((case[0], 3), device=cuda)
    y = csr_spmv_hub_add(indptr, src, w, x, row_map, y0.clone())
    torch.cuda.synchronize()
    counts = hub_counts(cuda)
    assert counts is not None and counts.numel() >= len(src) // 512
    assert int(counts.abs().sum()) == 0
    again = csr_spmv_hub_add(indptr, src, w, x, row_map, y0.clone())
    fresh = csr_spmv_hub_add(*(t.clone() for t in (indptr, src, w, x,
                                                   row_map)), y0.clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = csr_spmv_hub_add(indptr, src, w, x, row_map, y0.clone())
        assert int(hub_counts(cuda).abs().sum()) == 0
    torch.cuda.synchronize()
    assert int(hub_counts(cuda).abs().sum()) == 0
    for z in (again, fresh, other):
        assert torch.equal(z, y)


def test_csr_hub_lane_refuses_bad_operands(cuda):
    from repro_torch.kernels.csr_spmv import csr_spmv_hub_add
    indptr = torch.tensor([0, 1, 2], device=cuda)
    src = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    w = torch.ones(2, device=cuda)
    x = torch.ones((2, 1), device=cuda)
    row_map = torch.tensor([1, 3], dtype=torch.int32, device=cuda)
    y = torch.zeros((4, 1), device=cuda)
    with pytest.raises(TypeError):
        csr_spmv_hub_add(indptr, src, w.double(), x.double(), row_map, y)
    with pytest.raises(TypeError):
        csr_spmv_hub_add(indptr, src, w, x, row_map, y.double())
    with pytest.raises(TypeError):
        csr_spmv_hub_add(indptr, src, w, x, row_map.long(), y)
    with pytest.raises(ValueError):
        csr_spmv_hub_add(indptr, src, w, x, row_map, y.cpu())
    with pytest.raises(ValueError):
        csr_spmv_hub_add(indptr, src, w, x, row_map[:1], y)
    with pytest.raises(ValueError):
        csr_spmv_hub_add(indptr, src, w, torch.ones((2, 2), device=cuda),
                         row_map, torch.zeros((2, 4), device=cuda).t())
    csr_spmv_hub_add(indptr, src, w, x, row_map, y)
    assert y[:, 0].tolist() == [0.0, 1.0, 0.0, 1.0]


def test_hybrid_matvec_on_card_matches_cpu(cuda):
    """`hybrid_matvec` on CUDA tensors launches the block kernel and the
    CSR kernel's hub lane, once each and nothing else for the edge sums,
    and agrees with its CPU plain version (the block side within 1e-5
    relative, the hub rows within a float32 ulp); two runs give the same
    bits, the hub's float64 sum being in a fixed order."""
    from repro_torch.kernels.bsr_spmv import hybrid_matvec
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    op = _spmd_graph(n=20_000, nnz=200_000, dangling=20, seed=4)
    h = op.hybrid_bsr(bm=8, bn=8)
    assert h.hub_rows.size > 0
    x = np.random.default_rng(0).random((op.n, 3)).astype(np.float32)
    xp = torch.as_tensor(pad_x(x, op.n, 8))
    dev_cuda, dev_cpu = h.device(cuda), h.device(torch.device("cpu"))
    before, hub_before = dict(LAUNCHES), CSR["hub"]
    y = hybrid_matvec(dev_cuda, xp.to(cuda))
    assert LAUNCHES["f32"] == before["f32"] + 1
    assert CSR["hub"] == hub_before + 1
    y_cpu = hybrid_matvec(dev_cpu, xp)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-5, atol=1e-6)
    assert torch.equal(y, hybrid_matvec(dev_cuda, xp.to(cuda)))
    # the hub rows alone (the block side's rows there are zero)
    rows = torch.as_tensor(np.unique(h.hub_rows).astype(np.int64))
    yh, yh_cpu = y.reshape(-1, 3).cpu()[rows], y_cpu.reshape(-1, 3)[rows]
    assert float(_ulps_apart(yh, yh_cpu).max()) <= 1.0


def test_csr_wrapper_refuses_bad_operands(cuda):
    from repro_torch.kernels.csr_spmv import csr_spmv
    indptr = torch.tensor([0, 1, 2], device=cuda)
    src = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    w = torch.ones(2, device=cuda)
    x = torch.ones((2, 1), device=cuda)
    with pytest.raises(TypeError):
        csr_spmv(indptr, src, w.double(), x, 2)
    with pytest.raises(TypeError):
        csr_spmv(indptr, src.long(), w, x, 2)
    with pytest.raises(TypeError):
        csr_spmv(indptr.int(), src, w, x, 2)
    with pytest.raises(TypeError):
        csr_spmv(indptr, src, w.half(), x.half(), 2)
    with pytest.raises(ValueError):
        csr_spmv(indptr, src, w, x.cpu(), 2)
    with pytest.raises(ValueError):
        csr_spmv(indptr, src, w, x, 3)
    with pytest.raises(ValueError):
        csr_spmv(indptr, src, w, torch.ones((2, 2), device=cuda).t(), 2)
    assert csr_spmv(indptr, src, w, x, 2).tolist() == [[1.0], [1.0]]


def test_pt_matvec_dispatches_to_csr_kernel(cuda):
    from repro_torch.graph import GoogleOperator, TransitionT
    from repro_torch.graph import powerlaw_webgraph
    from repro_torch.graph.csr import pt_matvec, pt_matvec_block
    from repro_torch.kernels.csr_spmv import LAUNCHES
    g = powerlaw_webgraph(n=2000, target_nnz=16000, n_dangling=10, seed=7)
    op = GoogleOperator(pt=TransitionT.from_graph(g), alpha=0.85)
    x = torch.rand((2000, 3), dtype=torch.float64, device=cuda)
    dev = op.pt.device_arrays(torch.float64, cuda)
    before = LAUNCHES["f64"]
    y = pt_matvec(dev, x, 2000)
    assert LAUNCHES["f64"] == before + 1
    y_ref = pt_matvec(dev, x, 2000, impl="ref")
    torch.testing.assert_close(y, y_ref, rtol=1e-12, atol=1e-15)
    pt = op.pt
    lo, hi = 300, 700
    e0, e1 = pt.indptr[lo], pt.indptr[hi]
    block = dict(src=torch.as_tensor(pt.src[e0:e1], device=cuda),
                 weight=torch.as_tensor(pt.weight[e0:e1], device=cuda),
                 row_ids=torch.as_tensor(pt.row_ids[e0:e1] - lo,
                                         device=cuda))
    yb = pt_matvec_block(block, x, hi - lo, lo)
    assert LAUNCHES["f64"] == before + 2
    torch.testing.assert_close(yb, y[lo:hi], rtol=1e-12, atol=1e-15)


def _spmd_graph(n=5000, nnz=40000, dangling=20, seed=9):
    from repro_torch.graph import (GoogleOperator, TransitionT,
                                   powerlaw_webgraph)
    g = powerlaw_webgraph(n=n, target_nnz=nnz, n_dangling=dangling,
                          seed=seed)
    return GoogleOperator(pt=TransitionT.from_graph(g), alpha=0.85)


@pytest.mark.parametrize("nv", [1, 8])
def test_folded_block_launch_equals_per_shard(cuda, nv):
    """The shard program's one launch over the shards' folded block rows
    gives every shard the bits of its own launch."""
    from repro_torch.core.partition import block_rows
    from repro_torch.core.spmd import SPMDConfig, _pack_structure
    op = _spmd_graph()
    p = 4
    packed = _pack_structure(op, block_rows(op.n, p),
                             SPMDConfig(p=p, backend="bsr"),
                             np.dtype("float32"), 8)
    bsize, n_pad = packed["bsize"], packed["n_pad"]
    blocks = torch.as_tensor(packed["blocks"], device=cuda)
    cols = torch.as_tensor(packed["blk_cols"], device=cuda)
    count = torch.as_tensor(packed["blk_count"], device=cuda)
    views = torch.rand((p * n_pad // 8, 8, nv), device=cuda)
    before = LAUNCHES["f32"]
    y = bsr_spmv(blocks, cols, views, blk_count=count)
    assert LAUNCHES["f32"] == before + 1
    nbr_l, nbc_l = bsize // 8, n_pad // 8
    for i in range(p):
        rows = slice(i * nbr_l, (i + 1) * nbr_l)
        yi = bsr_spmv(blocks[rows], (cols[rows] - i * nbc_l).contiguous(),
                      views[i * nbc_l:(i + 1) * nbc_l].contiguous(),
                      blk_count=count[rows].contiguous())
        assert torch.equal(y[rows], yi), i
    torch.testing.assert_close(y, bsr_spmv_ref(blocks, cols, views),
                               rtol=1e-5, atol=1e-6)


def test_spmd_on_card_matches_cpu(cuda):
    """float64 segment sum: the card's supersteps and x are the CPU's; the
    CSR kernel runs once per superstep for all shards, plus the final
    residual's apply. float32: two runs on the card give the same bits."""
    from repro_torch.core import SPMDConfig, solve_spmd
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    op = _spmd_graph()
    for sched, q in (("allgather", 1.0), ("ring", 0.7), ("sparsified", 1.0)):
        cfg = SPMDConfig(p=4, schedule=sched, delivery_prob=q, tol=1e-10,
                         dtype="float64", seed=9, max_supersteps=3000)
        before = CSR["f64"]
        a = solve_spmd(op, cfg, device=cuda)
        assert CSR["f64"] == before + a.supersteps + 1
        b = solve_spmd(op, cfg, device="cpu")
        assert a.supersteps == b.supersteps, sched
        assert a.rows_sent == b.rows_sent
        assert np.abs(a.x - b.x).max() <= 1e-12
    cfg = SPMDConfig(p=4, schedule="allgather", tol=1e-7, seed=9)
    a, b = (solve_spmd(op, cfg, device=cuda) for _ in range(2))
    assert a.supersteps == b.supersteps
    np.testing.assert_array_equal(a.x, b.x)


@pytest.mark.parametrize("backend", ["segment_sum", "bsr"])
def test_spmd_lanes_on_card(cuda, backend):
    """Eight float32 lanes with freezing: the block kernel launches once
    per superstep for all shards; compaction gives the masked run's bits on
    the segment-sum backend (the CSR kernel's and the lane sums' order
    ignores the lane count), and on the bsr backend agrees to 1e-6 (the
    block kernel stages its lanes by nv)."""
    import dataclasses
    from repro_torch.core import SPMDConfig, solve_spmd
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    op = _spmd_graph(800, 6000, 5, 3)
    V = np.abs(np.random.default_rng(0).random((op.n, 8)))
    V /= V.sum(0)
    cfg = SPMDConfig(p=4, schedule="allgather", tol=1e-8, max_supersteps=600,
                     freeze_lanes=True, backend=backend)
    counter = LAUNCHES if backend == "bsr" else CSR
    before = counter["f32"]
    masked = solve_spmd(op, cfg, v=V, device=cuda)
    assert counter["f32"] == before + masked.supersteps + 1
    before = counter["f32"]
    compact = solve_spmd(op, dataclasses.replace(cfg, compact_lanes=True),
                         v=V, device=cuda)
    assert counter["f32"] == (before + compact.supersteps
                              + compact.lane_chunks)
    if backend == "segment_sum":
        np.testing.assert_array_equal(masked.lane_supersteps,
                                      compact.lane_supersteps)
        assert np.abs(masked.x - compact.x).max() == 0.0
    else:
        assert np.abs(masked.lane_supersteps
                      - compact.lane_supersteps).max() <= 3
        assert np.abs(masked.x - compact.x).max() <= 1e-6


@pytest.mark.parametrize("kind,policy", [("power", "all_to_all"),
                                         ("linear", "sparsified")])
def test_des_on_card_matches_cpu(cuda, kind, policy):
    """The DES with its block updates on the card (the CSR kernel's float64
    lane, once per update) against the port's CPU run on the seeded
    5,000-page graph: the same decisions, so equal counts and times, and x
    within L1 1e-12 (the kernel adds in its own fixed order)."""
    from repro_torch.core import AsyncFixedPoint, DESConfig
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    op = _spmd_graph()
    cfg = DESConfig(tol=1e-7, norm="inf", base_flops_rate=1e5,
                    bandwidth=1e6, msg_latency=1e-3, cancel_window=1.0,
                    max_iters=3000, seed=9, comm_policy=policy,
                    sparsify_top_k=64 if policy == "sparsified" else None)
    afp = AsyncFixedPoint(op, kind=kind)
    before = CSR["f64"]
    a = afp.solve_des(4, cfg, device=cuda)
    assert CSR["f64"] == before + int(a.iters.sum())
    b = afp.solve_des(4, cfg, device="cpu")
    for f in ("iters", "imports", "attempts", "local_conv_iter"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.stop_time, a.max_staleness) == (b.stop_time, b.max_staleness)
    assert float(np.abs(a.x - b.x).sum()) <= 1e-12
    before = CSR["f64"]
    s = afp.solve_des_sync(4, cfg, device=cuda)
    assert CSR["f64"] == before + 4 * s.iters
    c = afp.solve_des_sync(4, cfg, device="cpu")
    assert (s.iters, s.time) == (c.iters, c.time)
    assert float(np.abs(s.x - c.x).sum()) <= 1e-12


DRAINS = {
    # name: (DeviceShardTransport fields, L1 target)
    "f64_allgather": (dict(exchange="allgather"), 1e-10),
    "f64_ring": (dict(exchange="ring"), 1e-10),
    "f64_sparsified": (dict(), 1e-10),
    "f32_bsr_f32": (dict(dtype="float32", backend="bsr", accum="f32"), 1e-6),
    "f32_bsr_kahan": (dict(dtype="float32", backend="bsr", accum="kahan"),
                      1e-6),
    "f64_bsr": (dict(backend="bsr"), 1e-6),
}


@pytest.mark.parametrize("name", sorted(DRAINS))
def test_device_transport_on_card_matches_cpu(cuda, name):
    """Each drain on the card against its CPU run on the seeded 5,000-page
    graph, each launching its lane once per superstep for all four shards
    (+ the final residual's apply). float64 segment sum: equal counts and
    x within L1 1e-12. The block lanes read float32 views on the card (the
    "f64" lane too: its kernel is the Kahan one over the views rounded to
    float32, where the CPU's plain lane sums in float64): the same
    verdict, supersteps within 2, x within L1 2e-6 of the CPU's, and a
    host float64 residual within 3x the target."""
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    from repro_torch.runtime import DeviceShardTransport
    op = _spmd_graph()
    kw, target = DRAINS[name]
    x0 = np.full(op.n, 1.0 / op.n)
    lane = ((CSR, "f64") if "backend" not in kw else
            (LAUNCHES, "f32" if kw.get("accum") == "f32" else "kahan"))
    before = lane[0][lane[1]]
    a = DeviceShardTransport(4, device=cuda, **kw).run(op, x0,
                                                       target=target)
    assert lane[0][lane[1]] == before + a.supersteps + 1
    b = DeviceShardTransport(4, device="cpu", **kw).run(op, x0,
                                                        target=target)
    assert a.converged and b.converged
    if "backend" not in kw:
        for f in ("supersteps", "rows_sent", "fulls", "comm_bytes_total"):
            assert getattr(a, f) == getattr(b, f), f
        assert float(np.abs(a.x - b.x).sum()) <= 1e-12
    else:
        assert abs(a.supersteps - b.supersteps) <= 2
        assert float(np.abs(a.x - b.x).sum()) <= 2e-6
    resid = float(np.abs(op.apply_linear_numpy(a.x) - a.x).sum())
    assert resid <= 3 * target


def test_f64_bsr_drain_reaches_the_kernels(cuda):
    """A float64 bsr drain on the card: the views are rounded to float32
    for the Kahan block kernel and the CSR kernel's hub lane (which take
    float32 x only), and the result comes back float64."""
    from repro_torch.core.partition import block_rows
    from repro_torch.core.spmd import SPMDConfig, _device_structure, \
        _pack_blocks
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    from repro_torch.runtime.step import shard_pt_apply
    op = _spmd_graph()
    p, bm = 4, 8
    cfg = SPMDConfig(p=p, backend="bsr")
    packed = _pack_blocks(op, block_rows(op.n, p), np.float64, cfg,
                          op.teleport()[:, None], bm)
    dev = _device_structure(op, packed, True, cuda)
    n_pad, bsize = packed["n_pad"], packed["bsize"]
    view = torch.rand((p, n_pad, 1), dtype=torch.float64, device=cuda)
    apply = shard_pt_apply(dev["op_dev"], use_bsr=True, bsize=bsize, nv=1,
                           n_pad=n_pad, bm=bm, accum="f64")
    before = (LAUNCHES["kahan"], CSR["hub"])
    y = apply(view)
    assert (LAUNCHES["kahan"], CSR["hub"]) == (before[0] + 1, before[1] + 1)
    assert y.dtype == torch.float64 and y.shape == (p, bsize, 1)
    dev_cpu = _device_structure(op, packed, True, torch.device("cpu"))
    ref = shard_pt_apply(dev_cpu["op_dev"], use_bsr=True, bsize=bsize, nv=1,
                         n_pad=n_pad, bm=bm, accum="f64")(view.cpu())
    torch.testing.assert_close(y.cpu(), ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# streaming: certified updates, batched personalized PageRank, the sharded
# device drain, the rank server and the DES bridge, on the card against the
# port's CPU run
# ---------------------------------------------------------------------------
def _stream_graph():
    from repro_torch.graph import powerlaw_webgraph
    return powerlaw_webgraph(n=2000, target_nnz=16000, n_dangling=10,
                             seed=7)


def _stream_pair(cuda):
    """The same graph as two DeltaGraphs, with the card's cold state and
    its copy for the CPU side."""
    from repro_torch.streaming import DeltaGraph, RankState, cold_state
    g = _stream_graph()
    dg_c, dg_h = DeltaGraph(g), DeltaGraph(g)
    st_c = cold_state(dg_c, tol=1e-9, device=cuda)
    st_h = RankState(x=st_c.x.copy(), r=st_c.r.copy(), version=0,
                     alpha=st_c.alpha)
    return dg_c, dg_h, st_c, st_h


def test_update_ranks_stream_on_card_matches_cpu(cuda):
    """A crawl stream: the push batches (host numpy) give the CPU's counts
    and bits; the fallbacks run the CSR kernel's float64 lane once per
    solver iteration and give the CPU's path and iterations, x within L1
    1e-12."""
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    from repro_torch.streaming import (DeltaGraph, cold_state,
                                       synth_edge_trace, update_ranks)
    g = _stream_graph()
    a = cold_state(DeltaGraph(g), tol=1e-9, device=cuda)
    b = cold_state(DeltaGraph(g), tol=1e-9, device="cpu")
    assert float(np.abs(a.x - b.x).sum()) <= 1e-12 and a.cert <= 1e-9
    dg_c, dg_h, st_c, st_h = _stream_pair(cuda)
    trace = synth_edge_trace(dg_c, n_batches=6, batch_edges=3, seed=5,
                             p_new_node=0.3)
    fallbacks = 0
    for k, d in enumerate(trace):
        kw = (dict(tol=1e-5, push_frontier_frac=1.0) if k % 2 == 0 else
              dict(tol=1e-7, push_frontier_frac=0.25))
        before = CSR["f64"]
        st_c, s_c = update_ranks(dg_c, d, st_c, device=cuda, **kw)
        st_h, s_h = update_ranks(dg_h, d, st_h, device="cpu", **kw)
        assert s_c.path == s_h.path
        assert (s_c.pushes, s_c.nodes_visited, s_c.solver_iters) == (
            s_h.pushes, s_h.nodes_visited, s_h.solver_iters)
        assert CSR["f64"] == before + s_c.solver_iters
        assert float(np.abs(st_c.x - st_h.x).sum()) <= 1e-12
        assert s_c.cert <= kw["tol"] and s_h.cert <= kw["tol"]
        fallbacks += s_c.path != "push"
        st_h.x[:] = st_c.x          # the next batch from the same bits
        st_h.r[:] = st_c.r
    assert 0 < fallbacks < len(trace)


@pytest.mark.parametrize("backend", ["segment_sum", "bsr"])
def test_ppr_push_batched_16_lanes_on_card(cuda, backend):
    """16 lanes (off the block kernel's ring path: its first chunk runs the
    generic path, until freezing compacts the stack to 8): every
    certificate within tol on the card, lane iterations within one of the
    CPU's and each lane within L1 1e-9 of it on the float64 segment sum,
    the kernel launched."""
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    from repro_torch.streaming import DeltaGraph, ppr_push_batched
    dg = DeltaGraph(_stream_graph())
    rng = np.random.default_rng(10)
    sets = [rng.choice(dg.n, size=3, replace=False) for _ in range(16)]
    counter = LAUNCHES if backend == "bsr" else CSR
    lane = "f32" if backend == "bsr" else "f64"
    before = counter[lane]
    xa, ca, sa = ppr_push_batched(dg, sets, tol=1e-4, backend=backend,
                                  device=cuda)
    assert counter[lane] > before and sa.nv == 16
    xb, cb, sb = ppr_push_batched(dg, sets, tol=1e-4, backend=backend,
                                  device="cpu")
    assert (ca <= 1e-4).all() and (cb <= 1e-4).all()
    if backend == "segment_sum":
        assert np.abs(sa.lane_iters - sb.lane_iters).max() <= 1
        assert np.abs(xa - xb).sum(axis=0).max() <= 1e-9
    else:
        assert np.abs(xa - xb).sum(axis=0).max() <= 2e-4
    x16 = torch.zeros((8, 8, 16), device=cuda)
    assert kernel_path(torch.zeros((8, 2, 8, 8), device=cuda), x16) \
        == "generic"


def test_sharded_device_drain_on_card_matches_cpu(cuda):
    """The sharded updater's device drain on the card: one CSR float64
    launch a superstep for all four shards (+ the final residual's apply a
    drain), the CPU's supersteps, rows and refreshes, x within L1 1e-12."""
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    from repro_torch.streaming import synth_edge_trace, update_ranks_sharded
    dg_c, dg_h, st_c, st_h = _stream_pair(cuda)
    for d in synth_edge_trace(dg_c, n_batches=2, batch_edges=20, seed=71,
                              p_new_node=0.0):
        kw = dict(p=4, tol=1e-8, mode="async", transport="device",
                  exchange="sparsified")
        before = CSR["f64"]
        st_c, a = update_ranks_sharded(dg_c, d, st_c, device=cuda, **kw)
        assert CSR["f64"] == before + a.supersteps + a.attempts
        st_h, b = update_ranks_sharded(dg_h, d, st_h, device="cpu", **kw)
        assert a.path == b.path == "sharded_push"
        for f in ("supersteps", "rows_sent", "fulls", "bytes_moved",
                  "attempts"):
            assert getattr(a, f) == getattr(b, f), f
        assert float(np.abs(st_c.x - st_h.x).sum()) <= 1e-12
        assert a.cert <= 1e-8 and b.cert <= 1e-8
        st_h.x[:] = st_c.x
        st_h.r[:] = st_c.r


def test_rank_server_threaded_on_card(cuda):
    """The daemon updater launches its fallback solves from its own thread
    while two threads query: every snapshot the readers see is certified,
    the kernel ran from the updater thread, and after stop(drain=True) the
    health is clean (no swallowed error, no restart, no cold rebuild) and
    the ranks agree with the CPU's float64 oracle of the final graph."""
    import threading
    import time
    from repro_torch.graph.google import exact_pagerank
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    from repro_torch.streaming import DeltaGraph, EdgeDelta, RankServer
    tol = 1e-7
    srv = RankServer(DeltaGraph(_stream_graph()), tol=tol,
                     push_frontier_frac=0.25, device=cuda)
    seen, errors = [], []
    stop = threading.Event()

    def reader(kind):
        rng = np.random.default_rng(kind)
        try:
            while not stop.is_set():
                snap = srv.snapshot()
                seen.append(snap.cert)
                if kind == 0:
                    srv.top_k(10)
                else:
                    x, cert, _ = srv.personalized(
                        rng.choice(2000, 2, replace=False), tol=1e-2)
                    assert cert <= 1e-2
        except BaseException as exc:
            errors.append(exc)
            stop.set()

    before = CSR["f64"]
    srv.start(poll_s=0.001)
    threads = [threading.Thread(target=reader, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    rng = np.random.default_rng(27)
    try:
        for _ in range(20):
            srv.ingest(EdgeDelta.inserts(rng.integers(0, 2000, 2),
                                         rng.integers(0, 2000, 2)))
            time.sleep(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        srv.stop(drain=True)
    assert not errors, errors[0]
    assert srv.last_error is None and srv.updater_restarts == 0
    assert srv.cold_rebuilds == 0 and srv.health()["status"] == "ok"
    assert srv.fallbacks >= 1 and CSR["f64"] > before
    assert all(c <= tol for c in seen)
    snap = srv.snapshot()
    assert snap.version == srv.dg.version and snap.cert <= tol
    x_ref = exact_pagerank(srv.dg.operator(0.85), tol=1e-13)
    assert float(np.abs(snap.x - x_ref).sum()) <= tol


def test_streaming_des_bridge_on_card_matches_cpu(cuda):
    """StreamingBlockOperator's block updates (one CSR float64 launch each)
    against the CPU's within 1e-12, and the DES over it with the CPU's
    counts."""
    from repro_torch.core import AsyncDES, DESConfig
    from repro_torch.core.partition import block_rows
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    from repro_torch.streaming import (DeltaGraph, StreamingBlockOperator,
                                       synth_edge_trace)
    dg = DeltaGraph(_stream_graph())
    dg.apply(synth_edge_trace(dg, n_batches=1, batch_edges=20, seed=43,
                              p_new_node=0.0)[0])
    part = block_rows(dg.n, 4)
    x = torch.rand(dg.n, dtype=torch.float64)
    ops = {d: StreamingBlockOperator(dg, part, device=d)
           for d in (cuda, "cpu")}
    before = CSR["f64"]
    y = torch.cat([ops[cuda].update_block(i, x.to(cuda)) for i in range(4)])
    assert CSR["f64"] == before + 4
    ref = torch.cat([ops["cpu"].update_block(i, x) for i in range(4)])
    torch.testing.assert_close(y.cpu(), ref, rtol=1e-12, atol=1e-15)
    cfg = DESConfig(tol=1e-7, norm="inf", base_flops_rate=1e5,
                    bandwidth=1e6, msg_latency=1e-3, cancel_window=1.0,
                    max_iters=3000, seed=9)
    a = AsyncDES(ops[cuda], part, cfg, device=cuda).run()
    b = AsyncDES(ops["cpu"], part, cfg, device="cpu").run()
    for f in ("iters", "imports", "attempts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert float(np.abs(a.x - b.x).sum()) <= 1e-12


# ---------------------------------------------------------------------------
# the asynchronous host transports and the query tier, beside the card
# ---------------------------------------------------------------------------
def test_procpool_after_cuda_certifies(cuda):
    """Worker processes forked from a parent that holds a CUDA context and
    has launched kernels (the cold solve): the async updates
    certify, the ranks match the CPU's float64 oracle, and no segment of
    the port's prefix is left in /dev/shm."""
    from _torch_async_drains import own_segments, within
    from repro_torch.graph.google import exact_pagerank
    from repro_torch.streaming import EdgeDelta, update_ranks_sharded
    dg, _, st, _ = _stream_pair(cuda)           # cold solve on the card
    torch.cuda.synchronize()
    rng = np.random.default_rng(91)
    for _ in range(2):
        d = EdgeDelta.inserts(rng.integers(0, 2000, 10),
                              rng.integers(0, 2000, 10))
        st, s = within(update_ranks_sharded, dg, d, st, p=4, tol=1e-7,
                       mode="async", transport="procpool", n_workers=2,
                       seconds=120.0)
        assert s.transport == "procpool" and s.cert <= 1e-7
    x_ref = exact_pagerank(dg.operator(0.85), tol=1e-13)
    assert float(np.abs(st.x - x_ref).sum()) <= 2e-7
    assert own_segments() == []


def test_procpool_spawn_executor_after_cuda(cuda):
    """The process pool spawned (the start method that re-imports the
    package and torch in each worker) from a parent holding a CUDA
    context: a synthetic drain terminates, conserves mass and releases
    its segment."""
    from _torch_async_drains import AbsorbDrain, own_segments, within
    from repro_torch.core.partition import block_rows
    from repro_torch.runtime import (AllToAllPlan, ProcPoolShardExecutor,
                                     ShardArena, TerminationDriver)
    torch.zeros(1, device=cuda)
    p, n = 3, 30
    ex = ProcPoolShardExecutor(block_rows(n, p), AllToAllPlan(p),
                               TerminationDriver(p), l1_target=1e-6,
                               max_rounds=100_000, start_method="spawn")
    with ShardArena.from_arrays(dict(r=np.linspace(0.1, 1.0, n))) as arena:
        res = within(ex.run, AbsorbDrain(n, p), arena, seconds=120.0)
        assert res.stopped and float(np.abs(arena["r"]).sum()) <= 2e-6
    assert own_segments() == []


def test_threads_async_fallback_solves_on_card(cuda):
    """A threads async update whose push budget is too small falls back
    to the warm-started float64 solve on the card: one CSR float64 launch
    an iteration (+ one for the final residual check), certified."""
    from _torch_async_drains import within
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    from repro_torch.streaming import synth_edge_trace, update_ranks_sharded
    dg, _, st, _ = _stream_pair(cuda)
    d = synth_edge_trace(dg, n_batches=1, batch_edges=30, seed=62,
                         p_new_node=0.0)[0]
    before = CSR["f64"]
    st, s = within(update_ranks_sharded, dg, d, st, p=2, tol=1e-8,
                   mode="async", transport="threads", max_push_factor=0.05)
    assert s.path == "solve_linear" and s.transport == "threads"
    assert s.cert <= 1e-8 and s.solver_iters > 0
    assert CSR["f64"] - before >= s.solver_iters


@pytest.mark.parametrize("backend", ["segment_sum", "bsr"])
def test_batcher_lanes_on_card_match_cpu(cuda, backend):
    """Eight concurrent personalized queries fused by a QueryBatcher on
    the card (the CSR kernel's float64 lanes, or the block kernel and its
    hub lane) against the same batcher on the CPU: each answer certified
    and within tol of the CPU's in L1; the kernels ran from the
    batcher's collector thread."""
    import threading
    from _torch_async_drains import within
    from repro_torch.kernels.csr_spmv import LAUNCHES as CSR
    from repro_torch.serving import QueryBatcher
    from repro_torch.streaming import DeltaGraph, RankServer
    tol = 1e-4
    g = _stream_graph()
    rng = np.random.default_rng(93)
    sets = [rng.choice(2000, size=3, replace=False) for _ in range(8)]
    answers = {}
    for dev in (cuda, "cpu"):
        srv = RankServer(DeltaGraph(g), tol=1e-7, device=dev)
        b = QueryBatcher(srv, max_batch=8, max_delay_s=0.5,
                         backend=backend, device=dev).attach()
        out = [None] * 8
        gate = threading.Barrier(8)

        def ask(k):
            gate.wait()
            out[k] = b.submit(sets[k], None, tol)
        launches = (dict(CSR), LAUNCHES["f32"])
        ts = [threading.Thread(target=ask, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            within(t.join)
        within(b.stop)
        assert all(o is not None and o[1] <= tol for o in out)
        assert b.stats()["fused_lanes"] > 0
        answers[str(dev)] = out
        if dev is cuda:
            key = "f64" if backend == "segment_sum" else "hub"
            assert CSR[key] > launches[0][key]
            if backend == "bsr":
                assert LAUNCHES["f32"] > launches[1]
    for a, c in zip(answers[str(cuda)], answers["cpu"]):
        assert float(np.abs(a[0] - c[0]).sum()) <= tol


# ---------------------------------------------------------------------------
# Asynchronous training and the mixture of experts
# ---------------------------------------------------------------------------
def test_async_dp_straggler_on_card_matches_cpu(cuda):
    """The training DES with its views on the card: the straggler case
    (p = 4, one UE at 0.3x speed) gives the CPU run's counts, and its
    times, speedup and losses to 1e-12 relative."""
    from repro_torch.training import run_async_training_sim
    card = run_async_training_sim(p=4, ue_speed=[1, 1, 1, 0.3], seed=0)
    cpu = run_async_training_sim(p=4, ue_speed=[1, 1, 1, 0.3], seed=0,
                                 device="cpu")
    assert (card.sync_iters, card.async_iters_min, card.async_iters_max) \
        == (cpu.sync_iters, cpu.async_iters_min, cpu.async_iters_max) \
        == (866, 545, 1136)
    for f in ("sync_time", "async_time", "speedup", "sync_loss",
              "async_loss"):
        assert getattr(card, f) == pytest.approx(getattr(cpu, f), rel=1e-12)


def test_local_sgd_step_on_card_matches_cpu(cuda):
    from repro_torch.training import make_local_sgd_step

    def loss_fn(p, batch):
        x, y = batch
        return torch.mean((x @ p["w"] - y) ** 2)
    step = make_local_sgd_step(loss_fn, lr=0.05, sync_every=4, n_shards=4)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 1)).astype(np.float32)
    xs = rng.standard_normal((4, 4, 16, 3)).astype(np.float32)
    ys = rng.standard_normal((4, 4, 16, 1)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        out[dev.type] = step({"w": torch.as_tensor(w, device=dev)},
                             (torch.as_tensor(xs, device=dev),
                              torch.as_tensor(ys, device=dev)))["w"]
    assert out["cuda"].is_cuda
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=1e-5,
                               atol=1e-6)


def _moe_smoke(capacity_factor=None):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


@pytest.mark.parametrize("capacity_factor", [1.25, 0.01, 64.0])
def test_moe_layer_on_card_matches_cpu(cuda, capacity_factor):
    """`moe_apply` on the card against its CPU run over the same float32
    weights and tokens (TF32 off): the same assignments are kept, the
    output agrees within 1e-5 of its scale and the aux loss within 1e-6
    relative."""
    from repro_torch.models.moe import assign, moe_apply, moe_defs, route
    from repro_torch.models.param import init_params
    cfg = _moe_smoke(capacity_factor)
    cpu = torch.device("cpu")
    p = init_params(moe_defs(cfg), torch.Generator().manual_seed(0), cpu)
    pc = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
              if isinstance(v, dict) else v.to(cuda)) for k, v in p.items()}
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 32, cfg.d_model)), dtype=torch.float32)
    out, aux = moe_apply(pc, x.to(cuda), cfg)
    ref, ref_aux = moe_apply(p, x, cfg)
    assert out.is_cuda and out.dtype == torch.float32
    for xg in (x[:1], x[1:]):
        idx_c = route(pc, xg.to(cuda), cfg)[2].cpu()
        idx = route(p, xg, cfg)[2]
        assert torch.equal(idx_c, idx)
        assert torch.equal(assign(idx_c, cfg)[0], assign(idx, cfg)[0])
    scale = float(ref.abs().max())
    assert float((out.cpu() - ref).abs().max()) <= 1e-5 * scale
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-6)


def test_moe_smoke_model_on_card(cuda):
    """The Qwen2-MoE smoke model on the card (float32, drop-free): the
    forward launches the flash kernel once per layer and agrees with the
    CPU's over the same weights, and the engine's prefill through the
    decode path gives the forward's last position."""
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import Transformer, model_defs
    from repro_torch.models.param import init_params
    from repro_torch.serving import ServeEngine
    cfg = _moe_smoke(64.0)
    cpu = torch.device("cpu")
    params = init_params(model_defs(cfg), torch.Generator().manual_seed(0),
                         cpu)
    model = Transformer(cfg, params, device=cuda)
    model_cpu = Transformer(cfg, params, device=cpu)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    before = dict(LAUNCHES)
    logits, aux = model(torch.as_tensor(tokens, device=cuda))
    torch.cuda.synchronize()
    assert LAUNCHES["fwd"] == before["fwd"] + cfg.n_layers
    ref, ref_aux = model_cpu(torch.as_tensor(tokens))
    torch.testing.assert_close(logits.cpu(), ref, rtol=1e-4, atol=1e-4)
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-5)
    eng = ServeEngine(cfg, model, max_len=40, device=cuda)
    last, _ = eng.prefill(torch.as_tensor(tokens, device=cuda))
    torch.testing.assert_close(last, logits[:, -1], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training: the flash backward kernel, Whisper, a train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,Hkv,S,T,Dk,Dv,causal,dtype,window,prefix",
                         BWD_CASES)
def test_flash_bwd_matches_plain(cuda, B, H, Hkv, S, T, Dk, Dv, causal,
                                 dtype, window, prefix):
    """dq, dk and dv of the backward kernel against the plain backward on
    the same inputs (o from the plain forward, no lse: either lane
    rebuilds it), one count a call on the lane `bwd_lane` names, and a
    second call gives the same bits (no atomics)."""
    from repro_torch.kernels.flash_attention import (LAUNCHES, bwd_lane,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref)
    limit, dtype = BWD_LIMIT[dtype], DTYPES[dtype]
    rng = np.random.default_rng(S * 1000 + T + Dk + Dv + prefix)
    q, k, v = _qkv_dv(rng, B, H, Hkv, S, T, Dk, Dv, dtype, cuda)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o = flash_attention_ref(q, k, v, **kw)
    do = torch.as_tensor(rng.standard_normal(o.shape), dtype=dtype,
                         device=cuda)
    before = dict(LAUNCHES)
    got = flash_attention_bwd(q, k, v, o, do, **kw)
    again = flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["bwd"] == before["bwd"] + 2
    wgmma = bwd_lane(dtype, Dk, Dv) == "wgmma"
    assert LAUNCHES["bwd_wgmma"] == before["bwd_wgmma"] + 2 * wgmma
    ref = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    for name, a, b, c, err in zip("qkv", got, ref, again,
                                  bwd_errors(got, ref, T)):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(a, c), f"d{name} differs between two runs"
        assert err <= limit, f"d{name}: {err:.3g}"


@pytest.mark.parametrize("B,H,Hkv,S,T,Dk,Dv,causal,dtype,window,prefix",
                         WGMMA_BWD_CASES)
def test_flash_bwd_wgmma_with_forward_lse(cuda, B, H, Hkv, S, T, Dk, Dv,
                                          causal, dtype, window, prefix):
    """The tensor-core lane fed as training feeds it: o and lse from the
    tensor-core forward (`return_lse`), the lse within LSE_LIMIT of the
    plain forward's; the gradients against the plain backward over the
    same o within the bf16 limit, two runs bit for bit."""
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref)
    rng = np.random.default_rng(S * 1000 + T + Dk + Dv + prefix + 1)
    q, k, v = _qkv_dv(rng, B, H, Hkv, S, T, Dk, Dv, BF16, cuda)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = dict(LAUNCHES)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    _, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    assert float((lse - lse_ref).abs().max()) <= LSE_LIMIT
    do = torch.as_tensor(rng.standard_normal(o.shape), dtype=BF16,
                         device=cuda)
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    again = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["wgmma"] == before["wgmma"] + 1
    assert LAUNCHES["bwd_wgmma"] == before["bwd_wgmma"] + 2
    ref = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    for name, a, c, err in zip("qkv", got, again, bwd_errors(got, ref, T)):
        assert torch.equal(a, c), f"d{name} differs between two runs"
        assert err <= BWD_LIMIT["bf16"], f"d{name}: {err:.3g}"


def test_flash_return_lse_needs_tensor_core_lane(cuda):
    """return_lse no longer needs the tensor-core lane: the CUDA-core
    forward (float32, or bf16 at head dims the tensor cores do not take)
    returns each row's lse too, within LSE_LIMIT of the plain one, with o
    the same bits as without it; a bad lse for the backward is
    refused."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_ref,
                                                     kernel_lane)
    rng = np.random.default_rng(8)
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    for dtype, d in ((F32, 64), (BF16, 32)):
        qr = torch.as_tensor(rng.standard_normal((1, 2, 70, d)), dtype=dtype,
                             device=cuda)
        assert kernel_lane(dtype, d) == "f32"
        o, lse = flash_attention(qr, qr, qr, return_lse=True)
        _, want = flash_attention_ref(qr, qr, qr, return_lse=True)
        assert lse.dtype == F32 and lse.shape == (1, 2, 70)
        assert float((lse - want).abs().max()) <= LSE_LIMIT
        assert torch.equal(o, flash_attention(qr, qr, qr))
    qb = q.bfloat16()
    o, lse = flash_attention(qb, qb, qb, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(qb, qb, qb, o, o, lse=lse[:, :1])
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(qb, qb, qb, o, o, lse=lse.double())


@pytest.mark.parametrize("B,H,Hkv,S,T,Dk,Dv,causal,dtype,window,prefix",
                         F32_BWD_CASES)
def test_flash_bwd_f32_with_forward_lse(cuda, B, H, Hkv, S, T, Dk, Dv,
                                        causal, dtype, window, prefix):
    """The CUDA-core lane fed as training feeds it: o and lse from the
    forward kernel (`return_lse`; the CUDA-core forward but for bf16 at
    (192, 128), the tensor-core one), the lse within LSE_LIMIT of the plain
    forward's and the CUDA-core forward's o the same bits as without it;
    the gradients against the plain backward over the same o within the
    dtype's limit, two runs bit for bit, one call counted on this lane."""
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref,
                                                     kernel_lane)
    limit, dtype = BWD_LIMIT[dtype], DTYPES[dtype]
    rng = np.random.default_rng(S * 1000 + T + Dk + Dv + prefix + 2)
    q, k, v = _qkv_dv(rng, B, H, Hkv, S, T, Dk, Dv, dtype, cuda)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    _, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    assert float((lse - lse_ref).abs().max()) <= LSE_LIMIT
    if kernel_lane(dtype, Dk, Dv) == "f32":
        assert torch.equal(o, flash_attention(q, k, v, **kw))
    do = torch.as_tensor(rng.standard_normal(o.shape), dtype=dtype,
                         device=cuda)
    before = dict(LAUNCHES)
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    again = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["bwd"] == before["bwd"] + 2
    assert LAUNCHES["bwd_wgmma"] == before["bwd_wgmma"]
    ref = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    for name, a, c, err in zip("qkv", got, again, bwd_errors(got, ref, T)):
        assert torch.equal(a, c), f"d{name} differs between two runs"
        assert err <= limit, f"d{name}: {err:.3g}"


def test_flash_cross_shape_forward_bf16(cuda):
    """Whisper's cross attention on the tensor-core lane: bf16, not
    causal, 448 decoder rows over 1,500 encoder frames at D = 64."""
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref)
    rng = np.random.default_rng(448)
    q, k, v = _qkv_dv(rng, 2, 8, 8, 448, 1500, 64, 64, BF16, cuda)
    before = dict(LAUNCHES)
    o = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert LAUNCHES["wgmma"] == before["wgmma"] + 1
    r = flash_attention_ref(q, k, v, causal=False).float()
    torch.testing.assert_close(o.float(), r, rtol=3e-2, atol=3e-2)
    rel = float(((o.float() - r).norm(dim=-1) / r.norm(dim=-1)).max())
    assert rel <= ROW_REL_LIMIT[BF16]


def test_flash_bwd_refuses_bad_operands(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    k = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError):          # o of the wrong shape
        flash_attention_bwd(q, k, k, k, k)
    with pytest.raises(TypeError):           # dtypes differ
        flash_attention_bwd(q, k, k, q, q.bfloat16())
    with pytest.raises(ValueError):          # not contiguous
        flash_attention_bwd(q, k, k, q.transpose(2, 3).contiguous()
                            .transpose(2, 3), q)
    dq, dk, dv = flash_attention_bwd(q, k, k, q, q)
    assert float(dq.abs().max()) == float(dk.abs().max()) == 0.0


def test_whisper_smoke_model_on_card(cuda):
    """The Whisper smoke model (float32): the forward with frame
    embeddings launches the flash kernel twice per decoder layer (self,
    cross) and once per encoder layer and agrees with the plain version;
    decode through the cross cache agrees with the forward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import Transformer, decode_step
    from repro_torch.serving import ServeEngine
    cfg = get_smoke_config("whisper-base")
    model = Transformer(cfg, device=cuda, seed=0)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)),
                             device=cuda)
    frames = torch.as_tensor(rng.standard_normal((2, 40, cfg.d_model)),
                             dtype=torch.float32, device=cuda)
    before = dict(LAUNCHES)
    logits, _ = model(tokens, enc_inputs=frames)
    torch.cuda.synchronize()
    assert LAUNCHES["fwd"] == before["fwd"] + 2 * cfg.n_layers \
        + cfg.n_enc_layers
    ref, _ = model(tokens, enc_inputs=frames, impl="ref")
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-4)
    eng = ServeEngine(cfg, model, max_len=16, device=cuda,
                      enc_inputs=frames)
    cache = eng.new_cache(2)
    for t in range(12):
        out, cache = decode_step(model, tokens[:, t], cache)
        torch.testing.assert_close(out, logits[:, t], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-base"])
def test_smoke_train_step_kernel_matches_plain(cuda, arch):
    """One step of the smoke model's loss and gradients through the flash
    kernels (forward and backward) against impl="ref" on the same weights
    (float32): the loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest element; the backward kernel runs once per
    attention call."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticTokens, make_batch
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import Transformer
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import lm_loss
    cfg = get_smoke_config(arch)
    model = Transformer(cfg, device=cuda, seed=0, trainable=True)
    pipe = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=2))
    batch = make_batch(pipe, cfg, 0, device=cuda)
    leaves = tree_leaves(model.param_tree())
    grads = {}
    for impl in ("cuda", "ref"):
        before = LAUNCHES["bwd"]
        loss, _ = lm_loss(model, batch, impl=impl)
        grads[impl] = (loss.detach(), torch.autograd.grad(loss, leaves))
        calls = cfg.n_layers * (2 if cfg.is_encdec else 1) + cfg.n_enc_layers
        assert LAUNCHES["bwd"] - before == (calls if impl == "cuda" else 0)
    (lc, gc), (lr, gr) = grads["cuda"], grads["ref"]
    assert float(lc) == pytest.approx(float(lr), rel=1e-5)
    for a, b in zip(gc, gr):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-4 * scale


# ------------------------------------------------------ the dry run's lanes
# the caching allocator hands out a cached block whole where less than
# this would be left over (kSmallSize): a call's bytes on the card may
# exceed the sum of its rounded requests by less than this
ALLOC_SPLIT = 1 << 20


def _meta_growth(fn, *args, **kw):
    """The live bytes the call adds on the meta lane at its peak over its
    arguments (outputs, padded operands and workspaces), counted by
    `analysis.count.StepCounter` as the card's allocator rounds them."""
    from repro_torch.analysis.count import StepCounter
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    kw = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
          for k, v in kw.items()}
    counter = StepCounter()
    counter.hold(meta, kw)
    with counter:
        out = fn(*meta, **kw)
    del out
    return counter.peak - counter.arguments


def _card_growth(fn, *args, **kw):
    """The bytes a call allocates on the card at its peak over what was
    allocated before it, after a warm call (kept buffers made, the
    allocator's blocks cached)."""
    out = fn(*args, **kw)
    del out
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return peak - before


def _same_growth(fn, *args, **kw):
    """A wrapper allocates on the meta lane what it allocates on the
    card."""
    card = _card_growth(fn, *args, **kw)
    meta = _meta_growth(fn, *args, **kw)
    assert 0 <= card - meta < ALLOC_SPLIT, (card, meta)
    return card, meta


@pytest.mark.parametrize("dtype,B,H,Hkv,S,dk,dv", [
    (torch.bfloat16, 2, 6, 2, 300, 64, 64),
    (torch.bfloat16, 1, 10, 1, 1024, 256, 256),     # heads split 10 ways
    (torch.bfloat16, 1, 4, 4, 200, 192, 128),       # the CUDA-core bwd
    (torch.float32, 2, 4, 2, 257, 64, 64)])
def test_flash_meta_lane_allocates_as_the_card(cuda, dtype, B, H, Hkv, S,
                                               dk, dv):
    """The forward's and the backward's meta lanes allocate what their
    calls allocate on the card: o and lse; dq, dk, dv and the backward's
    workspace (its head splits' partials where the heads split)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_bwd)
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, H, S, dk), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Hkv, S, dk), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Hkv, S, dv), generator=g, device=cuda).to(dtype)
    _same_growth(flash_attention, q, k, v, return_lse=True)
    o, lse = flash_attention(q, k, v, return_lse=True)
    do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
    _same_growth(flash_attention_bwd, q, k, v, o, do, lse=lse)


@pytest.mark.parametrize("dtype,S,P,N,bwd", [
    (torch.bfloat16, 300, 64, 128, True), (torch.float32, 300, 12, 10, True),
    (torch.bfloat16, 1, 64, 128, False)])
def test_ssd_meta_lane_allocates_as_the_card(cuda, dtype, S, P, N, bwd):
    """The SSD scan's meta lanes allocate what its calls allocate on the
    card: the outputs, the operands padded to multiples of 8, the
    forward's and the backward's workspaces (none for the step)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import (
        ssd_scan_bwd_kernel, ssd_scan_kernel)
    B, H, Q = 2, 4, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((B, S, H, P), generator=g, device=cuda).to(dtype)
    b = torch.randn((B, S, N), generator=g, device=cuda).to(dtype)
    c = torch.randn((B, S, N), generator=g, device=cuda).to(dtype)
    dt = torch.rand((B, S, H), generator=g, device=cuda) * 0.1
    a_log = torch.randn((H,), generator=g, device=cuda)
    h0 = torch.randn((B, H, P, N), generator=g, device=cuda)
    _same_growth(ssd_scan_kernel, x, b, c, dt, a_log, Q, h0)
    if bwd:
        dy = torch.randn(x.shape, generator=g, device=cuda).to(dtype)
        _same_growth(ssd_scan_bwd_kernel, x, b, c, dt, a_log, Q, dy, None,
                     h0)


@pytest.mark.parametrize("dtype,S", [(torch.bfloat16, 4200),
                                     (torch.float32, 129),
                                     (torch.bfloat16, 1)])
def test_rglru_meta_lane_allocates_as_the_card(cuda, dtype, S):
    """The RG-LRU's meta lanes allocate what its calls allocate on the
    card: h and the forward's workspace of composites; the gradients and
    the backward's partial sums (its flags are kept between calls, made
    by the warm call)."""
    from repro_torch.kernels.rglru_scan.rglru_scan import (
        rglru_scan_bwd_kernel, rglru_scan_kernel)
    B, W = 2, 160
    g = torch.Generator(device=cuda).manual_seed(2)
    u = torch.randn((B, S, W), generator=g, device=cuda).to(dtype)
    ga, gi = (torch.randn((B, S, W), generator=g, device=cuda)
              for _ in range(2))
    b_a, b_i, lam = (torch.randn((W,), generator=g, device=cuda)
                     for _ in range(3))
    h0 = torch.randn((B, W), generator=g, device=cuda)
    _same_growth(rglru_scan_kernel, u, ga, gi, b_a, b_i, lam, h0)
    h = rglru_scan_kernel(u, ga, gi, b_a, b_i, lam, h0)
    dh = torch.randn(h.shape, generator=g, device=cuda)
    _same_growth(rglru_scan_bwd_kernel, u, ga, gi, b_a, b_i, lam, h, dh, h0)


def test_workspace_formulas_equal_the_libraries(cuda):
    """Each wrapper's workspace formula, the one source of its buffer's
    size on both lanes, is the library's own at the main paths' shapes
    and round them."""
    import importlib
    fa, lru, ssd = (importlib.import_module(f"repro_torch.kernels.{m}.{m}")
                    for m in ("flash_attention", "rglru_scan", "ssd_scan"))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    lib = fa._bwd_wgmma_lib()
    for B, H, Hkv, S, D in ((8, 15, 5, 2048, 64), (1, 32, 4, 2048, 128),
                            (1, 10, 1, 4096, 256), (4, 8, 8, 448, 64),
                            (1, 8, 1, 2048, 256), (3, 12, 4, 77, 128)):
        assert 4 * fa.bwd_workspace_numel(B, H, Hkv, S, S, D, D, "wgmma",
                                          sms) == \
            lib.flash_attention_bwd_wgmma_workspace_bytes(B, H, Hkv, S, S,
                                                          D, D)
    lib = ssd._lib()
    for B, S, H, P, N, Q in ((1, 4096, 80, 64, 128, 256),
                             (4, 128, 80, 64, 128, 256),
                             (1, 2048, 80, 64, 128, 256),
                             (2, 300, 4, 16, 16, 64),
                             (4, 1, 80, 64, 128, 256), (1, 257, 3, 8, 8, 32)):
        assert ssd.scan_workspace_bytes(B, S, H, P, N, Q) == \
            lib.ssd_scan_workspace_bytes(B, S, H, P, N, Q)
        assert ssd.bwd_workspace_bytes(B, S, H, P, N, Q) == \
            lib.ssd_scan_bwd_workspace_bytes(B, S, H, P, N, Q)
    lib = lru._lib()
    for B, S, W in ((1, 4096, 2560), (1, 32768, 2560), (4, 128, 2560),
                    (4, 1, 2560), (2, 4161, 160), (1, 16384, 2560)):
        assert lru.scan_workspace_bytes(B, S, W) == \
            lib.rglru_scan_workspace_bytes(B, S, W)
        assert lru.bwd_part_bytes(B, S, W) == \
            lib.rglru_scan_bwd_part_bytes(B, S, W)
        assert lru.bwd_flag_bytes(B, S, W) == \
            lib.rglru_scan_bwd_flag_bytes(B, S, W)
