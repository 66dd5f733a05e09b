"""Row partitioning of the iterate across UEs (numpy; the JAX package's
core/partition.py, copied so that the port imports nothing of it).

The paper distributes blocks of consecutive ceil(n/p) rows (§5.2). We also
provide a balanced-nnz partitioner (equalizes per-UE SpMV work, which the
paper's uniform block scheme does not) — used by the beyond-paper
experiments.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..graph.csr import TransitionT


@dataclasses.dataclass(frozen=True)
class Partition:
    n: int
    starts: np.ndarray  # (p,) int64
    ends: np.ndarray    # (p,) int64

    @property
    def p(self) -> int:
        return len(self.starts)

    def block(self, i: int) -> Tuple[int, int]:
        return int(self.starts[i]), int(self.ends[i])

    def sizes(self) -> np.ndarray:
        return self.ends - self.starts

    def owner_of(self, row: int) -> int:
        return int(np.searchsorted(self.ends, row, side="right"))


def block_rows(n: int, p: int) -> Partition:
    """Paper's scheme: blocks of consecutive ceil(n/p) rows."""
    size = -(-n // p)
    starts = np.arange(p, dtype=np.int64) * size
    ends = np.minimum(starts + size, n)
    starts = np.minimum(starts, n)
    return Partition(n=n, starts=starts, ends=ends)


def balanced_nnz(pt: TransitionT, p: int) -> Partition:
    """Split rows of P^T so each UE gets ~nnz/p in-edges (work balance)."""
    nnz_per_row = np.diff(pt.indptr)
    cum = np.concatenate([[0], np.cumsum(nnz_per_row)])
    total = cum[-1]
    targets = (np.arange(1, p, dtype=np.float64) * total / p)
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [pt.n]]).astype(np.int64)
    # guarantee monotone non-decreasing bounds
    bounds = np.maximum.accumulate(bounds)
    return Partition(n=pt.n, starts=bounds[:-1], ends=bounds[1:])


def slice_transition(pt: TransitionT, part: Partition, i: int) -> dict:
    """Edge slice of P^T for UE i's rows, with row ids rebased to the block.

    The returned dict feeds graph.csr.pt_matvec_block; everything is numpy
    (the DES engine) — callers move to device as needed.
    """
    s, e = part.block(i)
    lo, hi = pt.indptr[s], pt.indptr[e]
    return dict(
        src=pt.src[lo:hi],
        weight=pt.weight[lo:hi],
        row_ids=(pt.row_ids[lo:hi] - s).astype(np.int32),
        block_size=int(e - s),
        row_offset=int(s),
    )
