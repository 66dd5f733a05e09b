"""Host-side BSR construction and the dispatching SpMV entry points.

Two host containers (numpy, packed exactly as the JAX package packs them):

  * BSRMatrix   — the kernel's fixed-budget block-CSR layout (every block-row
                  padded to K slots: its real blocks at strictly ascending
                  block columns, then all-zero blocks at column 0, which
                  the CUDA kernel skips by `slot_counts`).
  * HybridBSR   — solve-grade layout for real web graphs: rows whose in-links
                  span many block columns ("hub" pages, the in-degree tail)
                  are split out into a COO side structure evaluated with
                  gather + scatter-add, and only the site-local remainder is
                  blocked. Without the split one hub row drives K up to the
                  full number of block columns and the dense-block array
                  explodes.

Kernel dispatch (`impl`): "cuda" launches the hand-written kernel and needs
CUDA tensors; "ref" runs the plain PyTorch version on any device; "auto"
picks "cuda" for CUDA tensors and "ref" for CPU tensors. A CUDA tensor under
"auto" always goes to the kernel: there is no fallback.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...graph.csr import TransitionT
from .. import resolve_impl
from .bsr_spmv import DEFAULT_BM, DEFAULT_BN, bsr_spmv
from .ref import bsr_spmv_ref


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Host container: block-CSR with a fixed blocks-per-row budget."""
    n_rows: int                 # logical (unpadded) rows
    n_cols: int
    bm: int
    bn: int
    blocks: np.ndarray          # (nbr, K, bm, bn) float32
    blk_cols: np.ndarray        # (nbr, K) int32
    fill_ratio: float           # nnz / dense-block capacity actually used

    @property
    def nbr(self) -> int:
        return self.blocks.shape[0]

    @property
    def nbc(self) -> int:
        return -(-self.n_cols // self.bn)

    @property
    def K(self) -> int:
        return self.blocks.shape[1]

    @functools.cached_property
    def counts(self) -> np.ndarray:
        """(nbr,) int32 real slots per block-row (`slot_counts`), derived
        and checked once per layout."""
        return slot_counts(self.blk_cols, self.blocks)

    def device(self, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(blocks, blk_cols, blk_count) on `device`."""
        return (torch.as_tensor(self.blocks, device=device),
                torch.as_tensor(self.blk_cols, device=device),
                torch.as_tensor(self.counts, device=device))


def slot_counts(blk_cols: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """The real slots of each block-row, from the packing rule.

    `build_bsr` puts a row's real blocks first, at strictly ascending block
    columns (`np.unique` keys in stable slots), and pads the rest of the K
    slots with all-zero blocks at column 0. So the count is the length of
    the strictly ascending prefix of `blk_cols[i]`, less one where that
    prefix is a lone all-zero block at column 0 (an empty row). Every slot
    at or past the count is checked to be such padding, and a layout that
    breaks the rule raises ValueError: the kernel stops at the count, so a
    real block past it would be dropped from the sum. Returns int32 (nbr,).
    """
    blk_cols = np.asarray(blk_cols)
    blocks = np.asarray(blocks)
    nbr, K = blk_cols.shape
    if blocks.shape[:2] != (nbr, K):
        raise ValueError(f"blocks {blocks.shape} do not match blk_cols "
                         f"{blk_cols.shape}")
    if K == 0:
        return np.zeros(nbr, np.int32)
    # length of the strictly ascending prefix: one past the first step
    # that does not ascend (a sentinel step closes every row at K)
    steps = np.concatenate([np.diff(blk_cols.astype(np.int64), axis=1) > 0,
                            np.zeros((nbr, 1), bool)], axis=1)
    prefix = np.argmin(steps, axis=1) + 1
    nonzero = np.any(blocks.reshape(nbr, K, -1), axis=2)
    empty = (prefix == 1) & (blk_cols[:, 0] == 0) & ~nonzero[:, 0]
    counts = np.where(empty, 0, prefix)
    past = np.arange(K)[None, :] >= counts[:, None]
    bad = past & ((blk_cols != 0) | nonzero)
    if bad.any():
        i, k = np.argwhere(bad)[0]
        raise ValueError(
            f"block-row {i} slot {k} lies past the row's {counts[i]} real "
            f"slots but is not padding (column {blk_cols[i, k]}, "
            f"{'nonzero' if nonzero[i, k] else 'zero'} block): real block "
            f"columns must ascend strictly, padding is all-zero blocks at "
            f"column 0")
    return counts.astype(np.int32)


def _ravel_index(blocks, ub_row, slot, inv, rows, cols, bm, bn):
    K = blocks.shape[1]
    # one base offset per unique block (tiny array), then a single gather
    # per edge; bit-masked intra-block coordinates for power-of-two blocks
    base = (ub_row * K + slot) * (bm * bn)
    r = rows & (bm - 1) if (bm & (bm - 1)) == 0 else rows % bm
    c = cols & (bn - 1) if (bn & (bn - 1)) == 0 else cols % bn
    return base[inv] + r * bn + c


def _scatter_blocks(blocks, ub_row, slot, inv, rows, cols, vals, bm, bn,
                    unique_pairs):
    """Scatter COO values through a raveled index into the blocks buffer.

    unique_pairs=True (every (row, col) occurs once, as for the edges of a
    TransitionT): one vectorized fancy assignment. Otherwise duplicates are
    accumulated with np.bincount over the compacted raveled-index domain."""
    flat = _ravel_index(blocks, ub_row, slot, inv, rows, cols, bm, bn)
    bf = blocks.reshape(-1)
    if unique_pairs:
        bf[flat] = np.asarray(vals, dtype=np.float32)
        return
    uniq_flat, inv2 = np.unique(flat, return_inverse=True)
    sums = np.bincount(inv2, weights=vals.astype(np.float64),
                       minlength=len(uniq_flat))
    bf[uniq_flat] = sums.astype(np.float32)


def build_bsr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              n_rows: int, n_cols: int, bm: int = DEFAULT_BM,
              bn: int = DEFAULT_BN, k_budget: Optional[int] = None,
              unique_pairs: bool = False) -> BSRMatrix:
    """Pack COO triplets into the fixed-budget BSR layout.

    If a block-row holds more distinct nonzero block-columns than k_budget,
    the budget is raised to the max (the layout needs one K for all rows).
    Set unique_pairs=True when no (row, col) repeats (graph edge lists).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    nbr = -(-n_rows // bm)
    nbc = -(-n_cols // bn)
    brow = rows // bm
    bcol = cols // bn
    key = brow * nbc + bcol
    uniq, inv = np.unique(key, return_inverse=True)
    ub_row = (uniq // nbc).astype(np.int64)
    ub_col = (uniq % nbc).astype(np.int32)

    per_row = np.bincount(ub_row, minlength=nbr)
    K = int(per_row.max()) if k_budget is None else max(k_budget,
                                                        int(per_row.max()))
    K = max(K, 1)

    # slot of each unique block within its block-row
    order = np.argsort(ub_row, kind="stable")
    slot_sorted = np.arange(len(uniq)) - np.concatenate(
        [[0], np.cumsum(per_row)])[ub_row[order]]
    slot = np.empty(len(uniq), dtype=np.int64)
    slot[order] = slot_sorted

    est = nbr * K * bm * bn * 4
    if est > 8 << 30:
        raise MemoryError(
            f"BSR dense-block array would be {est/1e9:.1f} GB "
            f"(K={K}); use build_hybrid_bsr (hub split), reordering, or "
            f"smaller blocks")
    blocks = np.zeros((nbr, K, bm, bn), dtype=np.float32)
    blk_cols = np.zeros((nbr, K), dtype=np.int32)
    blk_cols[ub_row, slot] = ub_col
    _scatter_blocks(blocks, ub_row, slot, inv, rows, cols, vals, bm, bn,
                    unique_pairs)
    # len(uniq) == 0 is reachable (the hub split can route every edge to
    # the COO side); an all-zero-block BSR with fill 0 is the right answer
    fill = len(rows) / float(len(uniq) * bm * bn) if len(uniq) else 0.0
    return BSRMatrix(n_rows=n_rows, n_cols=n_cols, bm=bm, bn=bn,
                     blocks=blocks, blk_cols=blk_cols, fill_ratio=fill)


# --------------------------------------------------------------------------
# Hub-split hybrid layout (solve-grade)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HybridBSR:
    """BSR over site-local mass + COO over hub rows (in-degree tail).

    The COO side is evaluated as gather + scatter-add over the *padded* row
    space, so a fused Google-apply stays entirely in the kernel's
    (n_blocks, block, nv) layout.
    """
    bsr: BSRMatrix
    hub_rows: np.ndarray      # int32 (hub_nnz,) destination row of each edge
    hub_cols: np.ndarray      # int32 (hub_nnz,) source column
    hub_vals: np.ndarray      # float32 (hub_nnz,)
    hub_nnz_frac: float       # fraction of nnz routed through the COO side

    @property
    def n_rows(self) -> int:
        return self.bsr.n_rows

    @property
    def n_cols(self) -> int:
        return self.bsr.n_cols

    def device(self, device: torch.device) -> dict:
        blocks, blk_cols, blk_count = self.bsr.device(device)
        return dict(blocks=blocks, blk_cols=blk_cols, blk_count=blk_count,
                    hub_rows=torch.as_tensor(self.hub_rows, device=device),
                    hub_cols=torch.as_tensor(self.hub_cols, device=device),
                    hub_vals=torch.as_tensor(self.hub_vals, device=device))


def build_hybrid_bsr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     n_rows: int, n_cols: int, bm: int = DEFAULT_BM,
                     bn: int = DEFAULT_BN, hub_quantile: float = 0.99,
                     k_budget: Optional[int] = None,
                     unique_pairs: bool = False) -> HybridBSR:
    """Split rows above the `hub_quantile` of row-nnz into the COO side and
    block the remainder. hub_quantile=1.0 disables the split."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    row_nnz = np.bincount(rows, minlength=n_rows)
    if hub_quantile < 1.0 and len(rows):
        cut = np.quantile(row_nnz, hub_quantile)
        hub_mask_row = row_nnz > cut
    else:
        hub_mask_row = np.zeros(n_rows, dtype=bool)
    is_hub = hub_mask_row[rows]
    keep = ~is_hub
    bsr = build_bsr(rows[keep], cols[keep], vals[keep], n_rows, n_cols,
                    bm=bm, bn=bn, k_budget=k_budget,
                    unique_pairs=unique_pairs)
    return HybridBSR(
        bsr=bsr,
        hub_rows=rows[is_hub].astype(np.int32),
        hub_cols=cols[is_hub].astype(np.int32),
        hub_vals=vals[is_hub].astype(np.float32),
        hub_nnz_frac=float(is_hub.mean()) if len(rows) else 0.0,
    )


def bsr_from_transition(pt: TransitionT, bm: int = DEFAULT_BM,
                        bn: int = DEFAULT_BN) -> BSRMatrix:
    """BSR of P^T (rows = destination pages, cols = source pages)."""
    return build_bsr(rows=pt.row_ids.astype(np.int64),
                     cols=pt.src.astype(np.int64),
                     vals=np.asarray(pt.weight, dtype=np.float32),
                     n_rows=pt.n, n_cols=pt.n, bm=bm, bn=bn,
                     unique_pairs=True)


def hybrid_from_transition(pt: TransitionT, bm: int = DEFAULT_BM,
                           bn: int = DEFAULT_BN,
                           hub_quantile: float = 0.99) -> HybridBSR:
    """Solve-grade hybrid layout of P^T."""
    return build_hybrid_bsr(rows=pt.row_ids.astype(np.int64),
                            cols=pt.src.astype(np.int64),
                            vals=np.asarray(pt.weight, dtype=np.float32),
                            n_rows=pt.n, n_cols=pt.n, bm=bm, bn=bn,
                            hub_quantile=hub_quantile, unique_pairs=True)


def pad_x(x: np.ndarray, n_cols: int, bn: int) -> np.ndarray:
    """(n, nv) or (n,) -> (nbc, bn, nv) padded block layout."""
    if x.ndim == 1:
        x = x[:, None]
    n, nv = x.shape
    nbc = -(-n_cols // bn)
    xp = np.zeros((nbc * bn, nv), dtype=x.dtype)
    xp[:n] = x
    return xp.reshape(nbc, bn, nv)


def unpad_y(y: np.ndarray, n_rows: int) -> np.ndarray:
    """(nbr, bm, nv) -> (n_rows, nv)."""
    nbr, bm, nv = y.shape
    return y.reshape(nbr * bm, nv)[:n_rows]


def bsr_matvec(blocks, blk_cols, x, impl: str = "auto", accum: str = "f32",
               device: DeviceLike = None, blk_count=None) -> torch.Tensor:
    """Dispatch the block multiply to the CUDA kernel or its plain version.

    Inputs (tensors or numpy arrays) are moved to `device` (None = the CUDA
    card). `accum` is "f32", "kahan", "f64" or "kahan_limit" (see
    `bsr_spmv_ref`); the kernel renders every lane but "f32" as "kahan",
    having no f64 arithmetic on its path. `blk_count` (`slot_counts`) lets
    the kernel skip the padded slots; the plain version sums all K, which
    gives the same result.
    """
    dev = resolve_device(device)
    blocks = torch.as_tensor(blocks, device=dev)
    blk_cols = torch.as_tensor(blk_cols, device=dev)
    x = torch.as_tensor(x, device=dev)
    if resolve_impl(impl, x) == "cuda":
        if blk_count is not None:
            blk_count = torch.as_tensor(blk_count, device=dev)
        return bsr_spmv(blocks, blk_cols, x,
                        accum="f32" if accum == "f32" else "kahan",
                        blk_count=blk_count)
    return bsr_spmv_ref(blocks, blk_cols, x, accum=accum)


def hybrid_matvec(dev: dict, x: torch.Tensor, impl: str = "auto",
                  accum: str = "f32") -> torch.Tensor:
    """y = PT @ x in the padded block layout for a `HybridBSR.device` dict,
    on the device where x lies.

    x: (nbc, bn, nv) -> y: (nbr, bm, nv). The hub COO side is a gather +
    scatter-add over the padded row space, accumulated in float64 for every
    lane: a hub row sums up to ~1e5 in-links (Stanford-Web replica), and
    under a personalized teleport most of them are far below half an ulp
    of the row's f32 sum, so an f32 scatter-add drops them — about 5e-6 of
    mass per apply, which stalls f32 solves above tol 1e-6. `accum` selects
    the block side's lane.
    """
    y = bsr_matvec(dev["blocks"], dev["blk_cols"], x, impl=impl,
                   accum=accum, device=x.device,
                   blk_count=dev["blk_count"])
    nbr, bm, nv = y.shape
    xf = x.reshape(-1, nv).double()
    contrib = dev["hub_vals"].double()[:, None] * xf.index_select(
        0, dev["hub_cols"])
    hub = contrib.new_zeros((nbr * bm, nv)).index_add_(
        0, dev["hub_rows"], contrib)
    return y + hub.reshape(nbr, bm, nv).to(y.dtype)


def spmv(bsr: BSRMatrix, x, impl: str = "auto", accum: str = "f32",
         device: DeviceLike = None) -> torch.Tensor:
    """y = PT @ x in the padded block layout, from the host container."""
    dev = resolve_device(device)
    blocks, blk_cols, blk_count = bsr.device(dev)
    return bsr_matvec(blocks, blk_cols, x, impl=impl, accum=accum,
                      device=dev, blk_count=blk_count)
