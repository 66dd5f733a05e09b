"""Page-ID permutations that densify the BSR blocks (paper §6 future work:
"use of suitable permutations (cf. [11])" — Choi & Szyld, threshold
partitioning for Markov chains).

The block-CSR SpMV kernel streams dense (bm, bn) blocks from device
memory; its efficiency is the block fill ratio. Raw crawl orderings
scatter each page's in-links across block columns. Two classical
reorderings:

  * reverse Cuthill-McKee on the symmetrized adjacency — clusters connected
    pages, concentrating mass near the diagonal;
  * in-degree sort — packs hub columns together so their dense columns
    share blocks.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse.csgraph import reverse_cuthill_mckee

from .csr import CSRGraph, TransitionT
from .google import GoogleOperator


def apply_permutation(g: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """Relabel pages: new_id = perm[old_id]."""
    deg = g.out_degree
    src_old = np.repeat(np.arange(g.n, dtype=np.int64), deg)
    dst_old = g.indices.astype(np.int64)
    return CSRGraph.from_edges(g.n, perm[src_old], perm[dst_old])


def invert(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def rcm_permutation(g: CSRGraph) -> np.ndarray:
    """Reverse Cuthill-McKee over A + A^T (bandwidth-minimizing)."""
    a = g.to_scipy()
    sym = ((a + a.T) > 0).astype(np.int8).tocsr()
    order = np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True))
    # order[k] = old id placed at position k  ->  perm[old] = k
    return invert(order.astype(np.int64))


def degree_sort_permutation(g: CSRGraph) -> np.ndarray:
    """Pages sorted by in-degree (descending): hub columns share blocks."""
    indeg = np.bincount(g.indices, minlength=g.n)
    order = np.argsort(-indeg, kind="stable").astype(np.int64)
    return invert(order)


def reorder_operator(op, method: str = "indeg"):
    """Permute a GoogleOperator's page ids to densify BSR blocks.

    method: "rcm" | "indeg", or a precomputed permutation array with
    perm[old_id] = new_id. Returns (op_perm, perm); the teleportation vector
    rides along (v_perm[perm] = v, lane-wise for (n, nv) stacks). A solution
    x_perm in the permuted space maps back as x = x_perm[perm].
    """
    g = CSRGraph.from_edges(op.n, op.pt.src.astype(np.int64),
                            op.pt.row_ids.astype(np.int64))
    if isinstance(method, np.ndarray):
        perm = method.astype(np.int64)
    elif method == "rcm":
        perm = rcm_permutation(g)
    elif method == "indeg":
        perm = degree_sort_permutation(g)
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    g2 = apply_permutation(g, perm)
    v2 = None
    if op.v is not None:
        v = np.asarray(op.v, dtype=np.float64)
        v2 = np.empty_like(v)
        v2[perm] = v
    op2 = GoogleOperator(pt=TransitionT.from_graph(g2), alpha=op.alpha, v=v2)
    return op2, perm
