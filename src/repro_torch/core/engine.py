"""AsyncFixedPoint — the public facade of the paper's contribution.

One object, three execution flavors in the JAX package:

  solve_sync()  : eq. (4) — synchronous power method / Jacobi on device.
  solve_des()   : eq. (5) — faithful asynchronous message-level simulation
                  (heterogeneous UEs, Fig. 1 termination, import accounting).
  solve_spmd()  : the bounded-staleness shard program with sparsified
                  exchange schedules (the deployable form).

The port runs solve_sync and solve_spmd; the discrete-event simulation
(core/des.py and the host runtime under it) is ROADMAP Queue 1 item 5.2,
and solve_des / solve_des_sync raise until it is ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import DeviceLike
from ..graph.google import GoogleOperator
from .pagerank import SolveResult, solve_linear, solve_power
from .partition import Partition, balanced_nnz, block_rows
from .spmd import SPMDConfig, SPMDResult, solve_spmd

_DES = ("the discrete-event simulation (core/des.py) is not ported yet: "
        "ROADMAP Queue 1 item 5.2")


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

    def solve_des(self, p: int, cfg=None):
        raise NotImplementedError(_DES)

    def solve_des_sync(self, p: int, cfg=None):
        raise NotImplementedError(_DES)

    def solve_spmd(self, cfg: SPMDConfig,
                   device: DeviceLike = None) -> SPMDResult:
        """The shard program (`core.spmd.solve_spmd`) with this facade's
        kind and backend; device=None is the CUDA card."""
        cfg = dataclasses.replace(cfg, kind=self.kind,
                                  backend=self.backend)
        return solve_spmd(self.op, cfg, device=device)
