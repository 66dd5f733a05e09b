"""Shard runtime of the port — the substrate-independent core of the
paper's asynchronous iteration (see repro/runtime in the JAX package for
the whole runtime):

  state     — `ShardState`: one shard's owned fragment + versioned stale
              views (a float64 tensor on the run's device);
  local     — the `LocalSolver` protocol and `BlockLocalSolver`, the
              eq. (6)/(7) block update the DES engine runs;
  exchange  — the host `ExchangePlan`s (all_to_all, ring, adaptive,
              sparsified; `make_plan`) and `spmd_exchange`, the four
              exchange schedules over a leading shard axis;
  driver    — `TerminationDriver`, the Fig. 1 protocol in its message,
              all-reduced value and all-reduced bit renderings;
  transport — `HostAllReduce` and `mesh_psum`, the reduction seam;
  step      — the superstep builders and `comm_bytes_model`;
  device    — `DeviceShardTransport`: the p shard programs on one card,
              draining the linear form to an all-reduced L1 target;
  schedule  — the drain schedules (`ScheduleSpec`, `make_schedule`) the
              streaming drains order their sweeps by;
  observe   — `render_prometheus`, the rank server's metrics text.

Not ported yet (ROADMAP Queue 1 item 7): ShardArena, the threads and
worker-process transports, the executor, faults, supervisor and the
observer itself.
"""
from .device import DeviceRunResult, DeviceShardTransport
from .driver import TerminationDriver
from .exchange import (SPMD_SCHEDULES, AdaptivePlan, AllToAllPlan,
                       ExchangePlan, RingPlan, SparsifiedPlan, make_plan,
                       spmd_exchange)
from .local import BlockLocalSolver, LocalSolver
from .schedule import SCHEDULES, ScheduleSpec, make_schedule
from .state import ShardState
from .step import (Spans, comm_bytes_model, hash_uniform, init_carry,
                   shard_local_update, shard_pt_apply, shard_superstep_fns)
from .transport import HostAllReduce, mesh_psum

__all__ = [
    "ShardState", "LocalSolver", "BlockLocalSolver",
    "ExchangePlan", "AllToAllPlan", "RingPlan", "AdaptivePlan",
    "SparsifiedPlan", "make_plan",
    "TerminationDriver", "SPMD_SCHEDULES", "spmd_exchange", "Spans",
    "comm_bytes_model", "hash_uniform", "init_carry", "shard_local_update",
    "shard_pt_apply", "shard_superstep_fns", "HostAllReduce", "mesh_psum",
    "DeviceShardTransport", "DeviceRunResult",
    "SCHEDULES", "ScheduleSpec", "make_schedule",
]
