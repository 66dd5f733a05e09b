"""Google-matrix pipeline: A -> P -> S -> G (paper §2), matrix-free.

G = alpha * S + (1 - alpha) * v e^T,   S = P^T + w d^T,  w = e/n.

We never form S or G: the iteration applies
    G x = alpha * P^T x + alpha * w (d^T x) + (1 - alpha) * v (e^T x)
and the linear-system (Jacobi/Richardson) form
    R x + b = alpha * (P^T x + w (d^T x)) + b,   b = (1 - alpha) * v.
Both preserve ||x||_1 = 1 for the power form when x0 is a distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from .csr import TransitionT, pt_matvec

DEFAULT_ALPHA = 0.85


@dataclasses.dataclass(frozen=True)
class GoogleOperator:
    """Matrix-free Google matrix over a web graph."""

    pt: TransitionT
    alpha: float = DEFAULT_ALPHA
    v: Optional[np.ndarray] = None  # teleportation (personalization) vector

    @property
    def n(self) -> int:
        return self.pt.n

    def teleport(self) -> np.ndarray:
        if self.v is not None:
            return np.asarray(self.v, dtype=np.float64)
        return np.full(self.n, 1.0 / self.n, dtype=np.float64)

    def _cache(self) -> dict:
        cache = self.__dict__.get("_op_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_op_cache", cache)
        return cache

    def hybrid_bsr(self, bm: int, bn: int, hub_quantile: float = 0.99):
        """Solve-grade hub-split BSR of P^T, built once per layout and
        memoized on the operator (the host-side packing is the expensive
        part of a BSR solve; repeated solves must not repeat it)."""
        from ..kernels.bsr_spmv.ops import hybrid_from_transition
        key = ("hybrid", bm, bn, hub_quantile)
        cache = self._cache()
        if key not in cache:
            cache[key] = hybrid_from_transition(
                self.pt, bm=bm, bn=bn, hub_quantile=hub_quantile)
        return cache[key]

    # ---------------- numpy/scipy reference path ------------------------
    def to_scipy_pt(self) -> sp.csr_matrix:
        return self.pt.to_scipy()

    def apply_numpy(self, x: np.ndarray, pt_sp: Optional[sp.csr_matrix] = None
                    ) -> np.ndarray:
        """y = G x (dense vector or (n, nv) lane stack, matrix-free)."""
        pt_sp = self.to_scipy_pt() if pt_sp is None else pt_sp
        v = self.teleport()
        if x.ndim == 2 and v.ndim == 1:
            v = v[:, None]
        dangling_mass = x[self.pt.dangling].sum(axis=0)
        y = self.alpha * (pt_sp @ x)
        y += self.alpha * dangling_mass / self.n  # w = e/n
        y += (1.0 - self.alpha) * x.sum(axis=0) * v
        return y

    def apply_linear_numpy(self, x: np.ndarray,
                           pt_sp: Optional[sp.csr_matrix] = None) -> np.ndarray:
        """y = R x + b with R = alpha S, b = (1 - alpha) v (x may be an
        (n, nv) stack against a lane-stacked teleport v)."""
        pt_sp = self.to_scipy_pt() if pt_sp is None else pt_sp
        v = self.teleport()
        if x.ndim == 2 and v.ndim == 1:
            v = v[:, None]
        dangling_mass = x[self.pt.dangling].sum(axis=0)
        y = self.alpha * (pt_sp @ x)
        y += self.alpha * dangling_mass / self.n
        y += (1.0 - self.alpha) * v
        return y

    # ---------------- torch path ----------------------------------------
    def device_arrays(self, dtype: torch.dtype,
                      device: torch.device) -> dict:
        """Tensors for the segment-sum apply, memoized per (dtype, device)
        so repeated solves reuse the uploaded buffers."""
        key = ("dev", dtype, torch.device(device))
        cache = self._cache()
        hit = cache.get(key)
        if hit is None:
            hit = self.pt.device_arrays(dtype=dtype, device=device)
            hit["dangling"] = torch.as_tensor(self.pt.dangling, device=device)
            hit["v"] = torch.as_tensor(self.teleport(), device=device
                                       ).to(dtype)
            cache[key] = hit
        return dict(hit)

    def apply_torch(self, dev: dict, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        y = self.alpha * pt_matvec(dev, x, n)
        dangling_mass = torch.where(dev["dangling"], x, 0.0).sum()
        y = y + self.alpha * dangling_mass / n
        y = y + (1.0 - self.alpha) * x.sum() * dev["v"]
        return y

    def apply_linear_torch(self, dev: dict, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        y = self.alpha * pt_matvec(dev, x, n)
        dangling_mass = torch.where(dev["dangling"], x, 0.0).sum()
        y = y + self.alpha * dangling_mass / n
        y = y + (1.0 - self.alpha) * dev["v"]
        return y


def exact_pagerank(op: GoogleOperator, tol: float = 1e-12,
                   maxiter: int = 10_000) -> np.ndarray:
    """High-precision reference PageRank (double precision power method on
    the host; the oracle every device solve is held against)."""
    pt_sp = op.to_scipy_pt()
    n = op.n
    x = np.full(n, 1.0 / n, dtype=np.float64)
    for _ in range(maxiter):
        y = op.apply_numpy(x, pt_sp)
        if np.abs(y - x).sum() < tol:
            return y
        x = y
    return x
