"""Shard runtime of the port — the substrate-independent core of the
paper's asynchronous iteration (the JAX package's runtime/, module for
module):

  state     — `ShardState`: one shard's owned fragment + versioned stale
              views (a float64 tensor on the run's device); `ShardArena`,
              the shared-memory segment the worker processes attach to;
  local     — the `LocalSolver` protocol and `BlockLocalSolver`, the
              eq. (6)/(7) block update the DES engine runs;
  exchange  — the host `ExchangePlan`s (all_to_all, ring, adaptive,
              sparsified; `make_plan`) and `spmd_exchange`, the four
              exchange schedules over a leading shard axis;
  driver    — `TerminationDriver`, the Fig. 1 protocol in its message,
              all-reduced value and all-reduced bit renderings;
  transport — the shard worker loop behind the `TransportContext` seam in
              its two host renderings (threads over `PairMailbox`es,
              worker processes over a `ShardArena` and `ShmRing`s), and
              the reduction seam (`HostAllReduce`, `mesh_psum`);
  executor  — `AsyncShardExecutor`, the thread rendering's public face;
  faults    — `FaultPlan` / `FaultyContext`: seeded kill, hang, slow,
              drop, dup and delay schedules at the transport seam;
  supervisor— `ShardSupervisor`: restarts of dead worker processes with
              capped backoff, checkpoint restore and ledger reconciliation;
  step      — `HostShardStep` (one round of the worker loop), the
              superstep builders and `comm_bytes_model`;
  device    — `DeviceShardTransport`: the p shard programs on one card,
              draining the linear form to an all-reduced L1 target;
  schedule  — the drain schedules (`ScheduleSpec`, `make_schedule`) the
              streaming drains order their sweeps by;
  observe   — `ShardObserver`: per-shard counters, event rings, the
              push-inflation attribution, the Chrome trace and
              `render_prometheus`.

What a worker process runs — `shard_worker_loop`, `HostShardStep`, the
rings and the arena, `FaultyContext`, the observer — is host numpy and
calls no torch, so the workers may be forked from a parent that holds a
CUDA context.
"""
from .device import DeviceRunResult, DeviceShardTransport
from .driver import TerminationDriver
from .exchange import (SPMD_SCHEDULES, AdaptivePlan, AllToAllPlan,
                       ExchangePlan, RingPlan, SparsifiedPlan, make_plan,
                       spmd_exchange)
from .faults import (FaultPlan, FaultState, FaultyContext,
                     InjectedWorkerKill)
from .local import BlockLocalSolver, LocalSolver
from .observe import (EV_NAMES, OBS_COUNTERS, ShardObserver,
                      attribute_frontier, chrome_trace, render_prometheus,
                      write_chrome_trace)
from .schedule import (DEFAULT_SCHEDULE, SCHEDULES, DrainOrder,
                       ExchangeGate, PriorityOrder, RandomizedOrder,
                       ScheduleSpec, make_schedule)
from .state import (ARENA_PREFIX, ArenaHandle, ShardArena, ShardState,
                    live_segments, sweep_stale_segments)
from .step import (HostShardStep, Spans, comm_bytes_model, hash_uniform,
                   init_carry, shard_local_update, shard_pt_apply,
                   shard_superstep_fns)
from .supervisor import BackoffPolicy, RestartEvent, ShardSupervisor
from .transport import (AsyncRunResult, Channel, HostAllReduce,
                        PairMailbox, ProcPoolShardExecutor,
                        ReductionChannel, ShmRing, ThreadedShardTransport,
                        TransportContext, UniformAccumulator, WorkerConfig,
                        default_pool_size, mesh_psum, shard_worker_loop)
from .executor import AsyncShardExecutor

__all__ = [
    "ShardState", "ShardArena", "ArenaHandle", "ARENA_PREFIX",
    "sweep_stale_segments", "live_segments",
    "LocalSolver", "BlockLocalSolver",
    "ExchangePlan", "AllToAllPlan", "RingPlan", "AdaptivePlan",
    "SparsifiedPlan", "make_plan",
    "TerminationDriver", "SPMD_SCHEDULES", "spmd_exchange",
    "FaultPlan", "FaultState", "FaultyContext", "InjectedWorkerKill",
    "BackoffPolicy", "RestartEvent", "ShardSupervisor",
    "ShardObserver", "EV_NAMES", "OBS_COUNTERS", "attribute_frontier",
    "chrome_trace", "write_chrome_trace", "render_prometheus",
    "SCHEDULES", "ScheduleSpec", "DEFAULT_SCHEDULE", "make_schedule",
    "DrainOrder", "PriorityOrder", "RandomizedOrder", "ExchangeGate",
    "Channel", "TransportContext", "WorkerConfig", "shard_worker_loop",
    "ThreadedShardTransport", "ProcPoolShardExecutor", "ShmRing",
    "default_pool_size", "ReductionChannel", "HostAllReduce", "mesh_psum",
    "HostShardStep", "Spans", "comm_bytes_model", "hash_uniform",
    "init_carry", "shard_local_update", "shard_pt_apply",
    "shard_superstep_fns",
    "DeviceShardTransport", "DeviceRunResult",
    "AsyncRunResult", "AsyncShardExecutor", "PairMailbox",
    "UniformAccumulator",
]
