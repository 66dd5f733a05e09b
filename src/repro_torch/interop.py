"""Carrying state across from the JAX package as plain numpy arrays.

The port imports nothing of the JAX package; a caller that holds its
operator or packed layout reads the arrays off it and hands them here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .graph.csr import TransitionT
from .graph.google import GoogleOperator
from .kernels.bsr_spmv.ops import BSRMatrix, HybridBSR

OPERATOR_KEYS = ("n", "indptr", "src", "weight", "row_ids", "dangling",
                 "alpha", "v")
HYBRID_KEYS = ("n_rows", "n_cols", "bm", "bn", "blocks", "blk_cols",
               "fill_ratio", "hub_rows", "hub_cols", "hub_vals",
               "hub_nnz_frac")


def _check_keys(d: Mapping, keys, what: str) -> None:
    missing = [k for k in keys if k not in d]
    if missing:
        raise KeyError(f"{what} arrays lack {missing}")


def operator_from_arrays(d: Mapping) -> GoogleOperator:
    """GoogleOperator from `n`, `indptr`, `src`, `weight`, `row_ids`,
    `dangling`, `alpha` and `v` (None for the uniform teleport)."""
    _check_keys(d, OPERATOR_KEYS, "operator")
    n = int(d["n"])
    pt = TransitionT(
        n=n,
        indptr=np.asarray(d["indptr"], dtype=np.int64),
        src=np.asarray(d["src"], dtype=np.int32),
        weight=np.asarray(d["weight"]),
        row_ids=np.asarray(d["row_ids"], dtype=np.int32),
        dangling=np.asarray(d["dangling"], dtype=bool))
    if (pt.indptr.shape != (n + 1,) or pt.dangling.shape != (n,)
            or not pt.src.shape == pt.weight.shape == pt.row_ids.shape
            or pt.indptr[-1] != pt.nnz):
        raise ValueError("inconsistent operator arrays")
    v = None if d["v"] is None else np.asarray(d["v"], dtype=np.float64)
    return GoogleOperator(pt=pt, alpha=float(d["alpha"]), v=v)


def bsr_from_arrays(d: Mapping) -> HybridBSR:
    """HybridBSR from its packed arrays (`n_rows`, `n_cols`, `bm`, `bn`,
    `blocks`, `blk_cols`, `fill_ratio`, `hub_rows`, `hub_cols`, `hub_vals`,
    `hub_nnz_frac`). Block columns are checked against the column count,
    since the kernel trusts them."""
    _check_keys(d, HYBRID_KEYS, "hybrid BSR")
    bsr = BSRMatrix(
        n_rows=int(d["n_rows"]), n_cols=int(d["n_cols"]), bm=int(d["bm"]),
        bn=int(d["bn"]),
        blocks=np.ascontiguousarray(d["blocks"], dtype=np.float32),
        blk_cols=np.ascontiguousarray(d["blk_cols"], dtype=np.int32),
        fill_ratio=float(d["fill_ratio"]))
    nbr, K, bm, bn = bsr.blocks.shape
    if (bm, bn) != (bsr.bm, bsr.bn) or bsr.blk_cols.shape != (nbr, K):
        raise ValueError("inconsistent BSR arrays")
    if bsr.blk_cols.size and (bsr.blk_cols.min() < 0
                              or bsr.blk_cols.max() >= bsr.nbc):
        raise ValueError(f"blk_cols outside [0, {bsr.nbc})")
    return HybridBSR(
        bsr=bsr,
        hub_rows=np.asarray(d["hub_rows"], dtype=np.int32),
        hub_cols=np.asarray(d["hub_cols"], dtype=np.int32),
        hub_vals=np.asarray(d["hub_vals"], dtype=np.float32),
        hub_nnz_frac=float(d["hub_nnz_frac"]))
