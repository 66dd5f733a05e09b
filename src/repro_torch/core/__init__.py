"""Core: the static PageRank solve on pluggable matvec backends, the
bulk-synchronous shard program (SPMD), the discrete-event simulation of
the asynchronous iteration (DES) and the facade over them."""
from .backend import (BACKENDS, BackendMeta, BackendSpec, as_lane_tol,
                      as_spec, from_layout, google_apply, l1_residual,
                      prepare, seed_stack, take_lanes)
from .des import (AsyncDES, AsyncResult, DESConfig, PageRankBlockOperator,
                  SyncResult)
from .engine import AsyncFixedPoint
from .pagerank import (SolveResult, kendall_tau_topk, rank_of, solve_linear,
                       solve_power)
from .partition import Partition, balanced_nnz, block_rows
from .spmd import SPMDConfig, SPMDResult, solve_spmd
from .termination import (CentralizedProtocol, ComputingUEState,
                          MonitorState, Msg, TreeNodeState, TreeProtocol)

__all__ = [
    "AsyncFixedPoint", "BackendSpec", "BACKENDS", "BackendMeta",
    "as_lane_tol", "as_spec", "from_layout", "google_apply", "l1_residual",
    "prepare", "seed_stack", "take_lanes",
    "AsyncDES", "DESConfig", "AsyncResult", "SyncResult",
    "PageRankBlockOperator", "Partition", "block_rows", "balanced_nnz",
    "solve_power", "solve_linear", "SolveResult", "rank_of",
    "kendall_tau_topk", "solve_spmd", "SPMDConfig", "SPMDResult",
    "ComputingUEState", "MonitorState", "Msg", "CentralizedProtocol",
    "TreeProtocol", "TreeNodeState",
]
