"""Core: the static PageRank solve on pluggable matvec backends."""
from .backend import (BACKENDS, BackendMeta, BackendSpec, as_lane_tol,
                      as_spec, from_layout, google_apply, l1_residual,
                      prepare, seed_stack, take_lanes)
from .pagerank import (SolveResult, kendall_tau_topk, rank_of, solve_linear,
                       solve_power)
