"""Streaming PageRank on the port: incremental push-based updates on
evolving graphs and an update-while-serve rank server (the JAX package's
streaming/, module for module, with the same names).

Layers:
  delta        — EdgeDelta / DeltaGraph: COO delta log over a CSR base with
                 periodic compaction and per-version operator views (host
                 numpy; a version's device tensors live on its memos).
  incremental  — update_ranks: Gauss-Southwell residual pushes seeded at
                 touched rows (host), warm-started backend-solver fallback
                 on the device, L1 certification bound (host float64).
  sharded      — update_ranks_sharded: the Partition-sharded rendering on
                 the runtime layer.  mode="superstep" is the deterministic
                 host loop; mode="async" with transport="device" drains on
                 the p shard programs of runtime.DeviceShardTransport.  The
                 threads and worker-process transports wait for ROADMAP
                 Queue 1 item 7.
  server       — RankServer: double-buffered snapshots, atomic publish,
                 top_k/scores/personalized queries with staleness metadata.
  scenario     — edge-stream replay (freshness vs throughput, the Table-2
                 mirror) and the block-operator bridge into core.des.

Every entry point that can reach the device (`cold_state`, `update_ranks`,
`ppr_push_batched`, `update_ranks_sharded`, `RankServer`, `replay_trace`,
`StreamingBlockOperator`) takes `device=None`, the CUDA card, and raises
without one; the tests pass `device="cpu"`.
"""
from .delta import (CSRGraph, DeltaGraph, DeltaReceipt, EdgeDelta,
                    FrozenGraphView, merge_deltas)
from .incremental import (BatchedPPRStats, RankState, UpdateStats,
                          cold_state, ppr_push, ppr_push_batched,
                          refresh_residual, update_ranks, validate_seeds)
from .sharded import ShardedUpdateStats, update_ranks_sharded
from .server import RankServer, RankSnapshot
from .scenario import (BatchRecord, ReplayConfig, ReplayResult,
                       StreamingBlockOperator, replay_trace,
                       synth_edge_trace)

__all__ = [
    "DeltaGraph", "DeltaReceipt", "EdgeDelta", "FrozenGraphView",
    "merge_deltas",
    "BatchedPPRStats", "RankState", "UpdateStats", "cold_state",
    "ppr_push", "ppr_push_batched", "refresh_residual", "update_ranks",
    "validate_seeds",
    "ShardedUpdateStats", "update_ranks_sharded",
    "RankServer", "RankSnapshot",
    "BatchRecord", "ReplayConfig", "ReplayResult",
    "StreamingBlockOperator", "replay_trace", "synth_edge_trace",
]
