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
  * the paper's discrete-event simulation (Tables 1-2) and the device
    shard transport;
  * certified streaming updates (the `streaming` package: the delta log,
    the incremental and sharded updaters, batched personalized PageRank,
    the rank server and the replay), with its solves, lane stacks, device
    drains and block updates on the CSR and block-CSR kernels;
  * inference for the dense decoders of the LM scaffold (Yi-6B, SmolLM,
    Qwen1.5, Minitron) and the mixture-of-experts Qwen2-MoE-A2.7B: the
    prefill forward, with the flash-attention kernel as a hand-written
    CUDA kernel, the KV-cache decode step and the batched ServeEngine;
  * the paper's iteration applied to SGD (`training`: asynchronous
    parameter-sharded SGD on the DES, and the local-SGD step), and the
    roofline and parameter/FLOP accounting (`analysis`);
  * the rest of the LM scaffold: Mamba2 and RecurrentGemma (hand kernels
    for their scans), DeepSeek-V3's latent attention, PaliGemma's
    prefix-LM and Whisper's encoder-decoder with its cross cache; and
    training (AdamW, the train step, the data pipeline, checkpoints and
    `launch.train`), every attention's gradient through a hand-written
    flash backward kernel.

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
