"""Shard runtime of the port — the bulk-synchronous shard program's pieces
(see repro/runtime in the JAX package for the whole runtime):

  exchange  — `spmd_exchange`, the four exchange schedules over a leading
              shard axis;
  driver    — `TerminationDriver`, the Fig. 1 protocol in its message,
              all-reduced value and all-reduced bit renderings;
  transport — `HostAllReduce` and `mesh_psum`, the reduction seam;
  step      — the superstep builders and `comm_bytes_model`.

Not ported yet (ROADMAP Queue 1 items 5.2 and 7): ShardState, the local
solvers, the host ExchangePlans, the threads and worker-process transports,
the executor, faults, supervisor, observer and schedules.
"""
from .driver import TerminationDriver
from .exchange import SPMD_SCHEDULES, spmd_exchange
from .step import (Spans, comm_bytes_model, hash_uniform, init_carry,
                   shard_local_update, shard_pt_apply, shard_superstep_fns)
from .transport import HostAllReduce, mesh_psum

__all__ = [
    "TerminationDriver", "SPMD_SCHEDULES", "spmd_exchange", "Spans",
    "comm_bytes_model", "hash_uniform", "init_carry", "shard_local_update",
    "shard_pt_apply", "shard_superstep_fns", "HostAllReduce", "mesh_psum",
]
