"""Core: the static PageRank solve on pluggable matvec backends, the
bulk-synchronous shard program (SPMD) and the facade over both."""
from .backend import (BACKENDS, BackendMeta, BackendSpec, as_lane_tol,
                      as_spec, from_layout, google_apply, l1_residual,
                      prepare, seed_stack, take_lanes)
from .engine import AsyncFixedPoint
from .pagerank import (SolveResult, kendall_tau_topk, rank_of, solve_linear,
                       solve_power)
from .partition import Partition, balanced_nnz, block_rows
from .spmd import SPMDConfig, SPMDResult, solve_spmd
from .termination import (CentralizedProtocol, ComputingUEState,
                          MonitorState, Msg, TreeNodeState, TreeProtocol)
