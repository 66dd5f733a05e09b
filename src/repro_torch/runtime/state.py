"""ShardState — one shard's owned fragment plus versioned stale views (the
JAX package's runtime/state.py:36-94).

ShardState is the per-UE state of eq. (5): shard i owns fragment x_i and
holds a full-length *stale* copy of every other fragment, tagged with the
version it last imported (the tau_j^i(t) table of the paper). The DES
engine (core/des.py) keeps one ShardState per simulated UE.

The view is a float64 tensor on the run's device, so a block update reads
it where the kernel runs; the version table and counters are host numbers,
since every decision on them is the engine's. The shared-memory arena the
JAX package keeps beside it (ShardArena, for its worker processes) belongs
to the host transports, which are not ported yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..core.partition import Partition


@dataclasses.dataclass
class ShardState:
    """Owned fragment + versioned stale views for shard `i` of `part`."""

    i: int
    part: "Partition"
    view: torch.Tensor             # (n,) float64 full-length stale view
    frag_version: np.ndarray       # (p,) version of each fragment held
    produced: int = 0              # own fragment version counter
    iters: int = 0                 # local updates executed
    stopped: bool = False

    @staticmethod
    def create(i: int, part: "Partition", x0) -> "ShardState":
        """A shard whose view is a float64 copy of `x0`: on x0's device for
        a tensor, on the CPU for an array."""
        view = torch.as_tensor(x0, dtype=torch.float64).clone()
        return ShardState(i=i, part=part, view=view,
                          frag_version=np.zeros(part.p, dtype=np.int64))

    @property
    def rows(self) -> Tuple[int, int]:
        return self.part.block(self.i)

    def fragment(self) -> torch.Tensor:
        """The owned rows of the view (a view of it, not a copy)."""
        s, e = self.rows
        return self.view[s:e]

    def publish(self, new_frag) -> int:
        """Install this shard's freshly computed fragment into its own view
        and bump the produced-version counter."""
        s, e = self.rows
        self.view[s:e] = torch.as_tensor(new_frag, dtype=self.view.dtype,
                                         device=self.view.device)
        self.iters += 1
        self.produced += 1
        self.frag_version[self.i] = self.produced
        return self.produced

    def import_fragment(self, owner: int, frag, version: int, s: int,
                        e: int) -> bool:
        """Accept a (possibly relayed) fragment owned by `owner` iff it is
        fresher than the copy currently held. Returns True on accept."""
        if version <= self.frag_version[owner]:
            return False
        self.view[s:e] = torch.as_tensor(frag, dtype=self.view.dtype,
                                         device=self.view.device)
        self.frag_version[owner] = version
        return True

    def import_rows(self, owner: int, rows, vals, version: int) -> bool:
        """Sparsified payload: refresh only `rows` (global ids) of `owner`'s
        fragment. The version table still advances — a row subset is a
        legitimate (partial) refresh under bounded-delay semantics; the
        plan's forced full refresh bounds how long the untouched rows can
        stay stale."""
        if version <= self.frag_version[owner]:
            return False
        dev = self.view.device
        self.view[torch.as_tensor(rows, device=dev)] = torch.as_tensor(
            vals, dtype=self.view.dtype, device=dev)
        self.frag_version[owner] = version
        return True

    def staleness_of(self, owner: int, produced_by_owner: int) -> int:
        return int(produced_by_owner - self.frag_version[owner])
