"""CSR web-graph containers and the torch sparse matvec.

The adjacency matrix A (A[i, j] = 1 iff page i links to page j) is stored in
CSR over *rows* (out-links). PageRank iterates with P^T (in-links weighted by
1/outdeg), so the transpose is materialized in CSR form once. Both
containers stay numpy on the host; `TransitionT.device_arrays` uploads the
edge arrays as torch tensors, and the per-iteration matvec is a gather
(`index_select`) plus a scatter-add (`index_add_`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Unweighted directed graph in CSR (row = source page, col = target)."""

    n: int
    indptr: np.ndarray   # int64 (n + 1,)
    indices: np.ndarray  # int32 (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @property
    def dangling_mask(self) -> np.ndarray:
        """d_i = 1 iff deg(i) == 0 (the paper's dangling index vector)."""
        return (self.out_degree == 0)

    def to_scipy(self) -> sp.csr_matrix:
        data = np.ones(self.nnz, dtype=np.float64)
        return sp.csr_matrix((data, self.indices, self.indptr),
                             shape=(self.n, self.n))

    @staticmethod
    def from_scipy(m: sp.spmatrix) -> "CSRGraph":
        m = m.tocsr().astype(bool).astype(np.int8)
        m.sum_duplicates()
        return CSRGraph(
            n=m.shape[0],
            indptr=np.asarray(m.indptr, dtype=np.int64),
            indices=np.asarray(m.indices, dtype=np.int32),
        )

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray) -> "CSRGraph":
        """Build from an edge list.

        Duplicate (src, dst) pairs are collapsed to a single edge. Self-loops
        are kept: the transition weight 1/outdeg then counts that link."""
        key = src.astype(np.int64) * n + dst.astype(np.int64)
        key = np.unique(key)
        src_u = (key // n).astype(np.int64)
        dst_u = (key % n).astype(np.int32)
        counts = np.bincount(src_u, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(n=n, indptr=indptr, indices=dst_u)


@dataclasses.dataclass(frozen=True)
class TransitionT:
    """P^T in CSR over rows (row j = in-links of page j, weighted 1/outdeg).

    This is the per-iteration operator of the paper: (P^T x)_j aggregates the
    rank mass flowing into page j.
    """

    n: int
    indptr: np.ndarray    # int64 (n + 1,)
    src: np.ndarray       # int32 (nnz,) source page per in-edge
    weight: np.ndarray    # float (nnz,) = 1 / outdeg(src)
    row_ids: np.ndarray   # int32 (nnz,) destination page per in-edge
    dangling: np.ndarray  # bool (n,)

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    @staticmethod
    def from_graph(g: CSRGraph, dtype=np.float64) -> "TransitionT":
        deg = g.out_degree
        src_of_edge = np.repeat(np.arange(g.n, dtype=np.int64), deg)
        dst_of_edge = g.indices.astype(np.int64)
        w = 1.0 / deg[src_of_edge]
        # sort edges by destination -> CSR of P^T
        order = np.argsort(dst_of_edge, kind="stable")
        dst_sorted = dst_of_edge[order]
        counts = np.bincount(dst_sorted, minlength=g.n)
        indptr = np.zeros(g.n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return TransitionT(
            n=g.n,
            indptr=indptr,
            src=src_of_edge[order].astype(np.int32),
            weight=w[order].astype(dtype),
            row_ids=dst_sorted.astype(np.int32),
            dangling=g.dangling_mask,
        )

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix(
            (np.asarray(self.weight, dtype=np.float64), self.src, self.indptr),
            shape=(self.n, self.n),
        )

    def device_arrays(self, dtype: torch.dtype,
                      device: torch.device) -> dict:
        """Edge tensors for `pt_matvec`, memoized per (dtype, device) so
        repeated solves reuse the uploaded buffers (TransitionT is
        immutable). Index tensors stay int32, which `index_select` and
        `index_add_` take as they are."""
        key = (dtype, torch.device(device))
        cache = self.__dict__.get("_dev_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_dev_cache", cache)
        hit = cache.get(key)
        if hit is None:
            hit = dict(
                src=torch.as_tensor(self.src, device=device),
                weight=torch.as_tensor(self.weight, device=device).to(dtype),
                row_ids=torch.as_tensor(self.row_ids, device=device),
            )
            cache[key] = hit
        return dict(hit)


def pt_matvec(dev: dict, x: torch.Tensor, n: int) -> torch.Tensor:
    """y = P^T x as gather + scatter-add.

    x may be a single vector (n,) or an (n, nv) stack of iterates (nv
    personalized PageRank problems sharing every edge gather).
    dev comes from `TransitionT.device_arrays`.
    """
    w = dev["weight"] if x.ndim == 1 else dev["weight"][:, None]
    contrib = w * x.index_select(0, dev["src"])
    y = x.new_zeros((n,) + tuple(x.shape[1:]))
    return y.index_add_(0, dev["row_ids"], contrib)


def pt_matvec_block(dev_block: dict, x: torch.Tensor, block_size: int,
                    row_offset: int) -> torch.Tensor:
    """(P^T x) restricted to rows [row_offset, row_offset + block_size).

    dev_block holds the edge slice for those rows with row_ids already
    rebased to the block.
    """
    contrib = dev_block["weight"] * x.index_select(0, dev_block["src"])
    y = x.new_zeros((block_size,) + tuple(x.shape[1:]))
    return y.index_add_(0, dev_block["row_ids"], contrib)
