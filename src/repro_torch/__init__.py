"""PyTorch port of the asynchronous-PageRank system for NVIDIA Hopper.

Ported so far:
  * the static PageRank solve (graph layer, Google operator, hub-split
    block-CSR packing, segment-sum and BSR backends, power and linear
    solvers with lane freezing), with the block-CSR SpMV as a hand-written
    CUDA kernel;
  * the bulk-synchronous shard program (solve_spmd) with every shard on
    one card, the Fig. 1 termination protocol and the AsyncFixedPoint
    facade, with the segment-sum backend's SpMV as a hand-written CUDA
    kernel in a fixed order;
  * inference for the dense decoders of the LM scaffold (Yi-6B, SmolLM,
    Qwen1.5, Minitron): the prefill forward, with the flash-attention
    kernel as a hand-written CUDA kernel, the KV-cache decode step and the
    batched ServeEngine.

Entry points run on the CUDA card unless given `device="cpu"`.
"""
from .configs import get_config, get_smoke_config
from .configs.pagerank import SMALL, STANFORD, PageRankConfig
from .core.backend import BackendSpec, prepare, seed_stack
from .core.engine import AsyncFixedPoint
from .core.spmd import SPMDConfig, SPMDResult, solve_spmd
from .core.pagerank import (SolveResult, kendall_tau_topk, rank_of,
                            solve_linear, solve_power)
from .device import resolve_device
from .graph.google import GoogleOperator, exact_pagerank
from .models import ModelConfig, Transformer, decode_step, init_cache
from .serving import ServeEngine
