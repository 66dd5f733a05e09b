"""The reduction seam of the shard runtime, in its two bulk-synchronous
renderings: how per-shard values become the global verdict.

  HostAllReduce : a plain float64 sum on the host (the all-reduced value
                  rendering of `TerminationDriver.allreduce_step`).
  mesh_psum     : the one-card rendering of a psum over the shard mesh. The
                  shard program holds every shard's arrays on one leading
                  `p` axis, so the all-reduce is a sum over that axis, kept
                  as a size-1 axis so that it broadcasts back to every
                  shard, as a psum leaves the total on every shard.

The host transports (threads, worker processes) are not ported yet
(ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class HostAllReduce:
    """Plain numpy sum — the host rendering (TerminationDriver's
    allreduce_step and the superstep streaming loop)."""

    def all_reduce(self, values):
        return float(np.asarray(values, dtype=np.float64).sum())


def mesh_psum(dim: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The shard-axis all-reduce, shaped for
    `TerminationDriver.bits_step(psum=...)`: a sum over the leading shard
    axis `dim`, kept as a size-1 axis."""

    def _psum(a: torch.Tensor) -> torch.Tensor:
        return a.sum(dim=dim, keepdim=True, dtype=a.dtype)
    return _psum
