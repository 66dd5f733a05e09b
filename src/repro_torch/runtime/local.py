"""LocalSolver — the f_i of eq. (5): update one owned fragment from a
(stale) full view (the JAX package's runtime/local.py:33-102).

The DES engine (core/des.py) calls it from its "iter" events and from the
barrier-synchronous baseline. `BlockLocalSolver` is the PageRank block
update: eq. (6) power form or eq. (7) linear form restricted to the rows of
a partition block. Each block's slice of P^T (`core.partition.
slice_transition`) lives on the run's device, and the block's P^T x is
`graph.csr.pt_matvec_block`: the CSR segment-sum kernel's float64 lane on
the card, its plain version (a gather and an `index_add_` in edge order,
which gives scipy's bits) on the CPU.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Protocol, runtime_checkable

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.csr import pt_matvec_block
from ..graph.google import GoogleOperator

if TYPE_CHECKING:
    from ..core.partition import Partition


@runtime_checkable
class LocalSolver(Protocol):
    """f_i of eq. (5): update one fragment from a (stale) full view."""

    def update_block(self, i: int, x_full: torch.Tensor) -> torch.Tensor: ...

    def block_work(self, i: int) -> float:
        """Relative compute cost of block i (for clock models)."""
        ...


class BlockLocalSolver:
    """Eq. (6) power form (`kind='power'`) or eq. (7) linear form
    (`kind='linear'`) restricted to rows of a partition block, in float64
    on `device` (None: the CUDA card).

    `matvec` keeps the JAX package's two names. There "bsr" stores each
    block's rows in scipy BSR with (bm, bm) dense blocks, a host layout
    choice whose sums come out in another order than "csr"'s. Here both
    run the same float64 CSR product (the port has no float64 block
    kernel), so `bm` is accepted and unused; the two flavors give the same
    bits.
    """

    def __init__(self, op: GoogleOperator, part: "Partition",
                 kind: str = "power", matvec: str = "csr", bm: int = 32,
                 device: DeviceLike = None):
        from ..core.partition import slice_transition
        if kind not in ("power", "linear"):
            raise ValueError(f"unknown kind {kind!r}")
        if matvec not in ("csr", "bsr"):
            raise ValueError(f"unknown matvec {matvec!r}")
        dev = resolve_device(device)
        self.op = op
        self.part = part
        self.kind = kind
        self.matvec = matvec
        self.device = dev
        self.n = op.n
        pt = op.pt
        v = op.teleport()
        self._alpha = float(op.alpha)
        self._blocks = []
        for i in range(part.p):
            s, e = part.block(i)
            sl = slice_transition(pt, part, i)
            indptr = pt.indptr[s:e + 1] - pt.indptr[s]
            v_blk = torch.as_tensor(v[s:e], dtype=torch.float64, device=dev)
            self._blocks.append(dict(
                pt_rows=dict(
                    indptr=torch.as_tensor(indptr, device=dev),
                    src=torch.as_tensor(sl["src"], device=dev),
                    weight=torch.as_tensor(sl["weight"], dtype=torch.float64,
                                           device=dev),
                    row_ids=torch.as_tensor(sl["row_ids"], device=dev)),
                v=v_blk,
                # the linear form's constant term, (1 - alpha) v
                b=(1.0 - self._alpha) * v_blk,
                rows=(s, e),
                nnz=int(indptr[-1]),
            ))
        self._dangling = torch.as_tensor(np.flatnonzero(pt.dangling),
                                         device=dev)

    def update_block(self, i: int, x_full: torch.Tensor) -> torch.Tensor:
        """The new fragment of block i, a fresh (e - s,) float64 tensor."""
        blk = self._blocks[i]
        s, e = blk["rows"]
        dangling_mass = x_full.index_select(0, self._dangling).sum()
        y = pt_matvec_block(blk["pt_rows"], x_full, e - s, s)
        y.mul_(self._alpha)
        y += self._alpha * dangling_mass / self.n
        if self.kind == "power":
            y += (1.0 - self._alpha) * x_full.sum() * blk["v"]
        else:
            y += blk["b"]
        return y

    def block_work(self, i: int) -> float:
        return float(max(self._blocks[i]["nnz"], 1))
