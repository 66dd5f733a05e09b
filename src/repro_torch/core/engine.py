"""AsyncFixedPoint — the public facade of the paper's contribution.

One object, three execution flavors in the JAX package:

  solve_sync()  : eq. (4) — synchronous power method / Jacobi on device.
  solve_des()   : eq. (5) — faithful asynchronous message-level simulation
                  (heterogeneous UEs, Fig. 1 termination, import accounting).
  solve_spmd()  : the bounded-staleness shard program with sparsified
                  exchange schedules (the deployable form).

The port runs all three. solve_des and solve_des_sync keep the event
logic on the host and the fragments on the device (`device=None`: the
CUDA card, where every block update is the CSR kernel's float64 lane).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..graph.google import GoogleOperator
from .des import (AsyncDES, AsyncResult, DESConfig, PageRankBlockOperator,
                  SyncResult)
from .pagerank import SolveResult, solve_linear, solve_power
from .partition import Partition, balanced_nnz, block_rows
from .spmd import SPMDConfig, SPMDResult, solve_spmd


@dataclasses.dataclass
class AsyncFixedPoint:
    op: GoogleOperator
    kind: str = "power"            # power (eq. 6) | linear (eq. 7)
    partition: str = "block"       # block (paper) | balanced_nnz
    backend: str = "segment_sum"   # segment_sum | bsr_pallas (alias bsr)

    def make_partition(self, p: int) -> Partition:
        if self.partition == "balanced_nnz":
            return balanced_nnz(self.op.pt, p)
        return block_rows(self.op.n, p)

    def solve_sync(self, tol: float = 1e-9, max_iters: int = 1000,
                   dtype="float64", **kw) -> SolveResult:
        """The synchronous solve (`core.pagerank`); `device` and the other
        keywords pass through (device=None is the CUDA card)."""
        dt = torch.float64 if dtype == "float64" else torch.float32
        fn = solve_power if self.kind == "power" else solve_linear
        return fn(self.op, tol=tol, max_iters=max_iters, dtype=dt,
                  backend=self.backend, **kw)

    def solve_des(self, p: int, cfg: Optional[DESConfig] = None,
                  device: DeviceLike = None) -> AsyncResult:
        """The asynchronous DES run of eq. (5) (`core.des.AsyncDES.run`)
        with p UEs; device=None is the CUDA card."""
        return self._des(p, cfg, device).run()

    def solve_des_sync(self, p: int, cfg: Optional[DESConfig] = None,
                       device: DeviceLike = None) -> SyncResult:
        """The barrier-synchronous DES baseline (`AsyncDES.run_sync`) under
        the same clock and network models; device=None is the CUDA card."""
        return self._des(p, cfg, device).run_sync()

    def _des(self, p: int, cfg: Optional[DESConfig],
             device: DeviceLike) -> AsyncDES:
        cfg = cfg or DESConfig()
        dev = resolve_device(device)
        part = self.make_partition(p)
        opr = PageRankBlockOperator(self.op, part, kind=self.kind,
                                    matvec=self._des_matvec(), device=dev)
        return AsyncDES(opr, part, cfg, check_operator=self.op, device=dev)

    def _des_matvec(self) -> str:
        # the JAX package's name for the block flavor; the port's block
        # update runs the same float64 CSR product either way
        # (runtime/local.py)
        return "bsr" if self.backend in ("bsr_pallas", "bsr") else "csr"

    def solve_spmd(self, cfg: SPMDConfig,
                   device: DeviceLike = None) -> SPMDResult:
        """The shard program (`core.spmd.solve_spmd`) with this facade's
        kind and backend; device=None is the CUDA card."""
        cfg = dataclasses.replace(cfg, kind=self.kind,
                                  backend=self.backend)
        return solve_spmd(self.op, cfg, device=device)
