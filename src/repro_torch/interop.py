"""Carrying state across from the JAX package as plain numpy arrays.

The port imports nothing of the JAX package; a caller that holds its
operator, packed layout or model parameters reads the arrays off it and
hands them here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .graph.csr import CSRGraph, TransitionT
from .graph.google import GoogleOperator
from .kernels.bsr_spmv.ops import BSRMatrix, HybridBSR
from .models.config import ModelConfig
from .models.param import match_defs
from .models.transformer import encoder_config, model_defs, stack_plan
from .streaming.delta import EdgeDelta
from .streaming.incremental import RankState

OPERATOR_KEYS = ("n", "indptr", "src", "weight", "row_ids", "dangling",
                 "alpha", "v")
GRAPH_KEYS = ("n", "indptr", "indices")
DELTA_KEYS = ("add_src", "add_dst", "del_src", "del_dst", "new_nodes")
STATE_KEYS = ("x", "r", "version", "alpha", "v")
HYBRID_KEYS = ("n_rows", "n_cols", "bm", "bn", "blocks", "blk_cols",
               "fill_ratio", "hub_rows", "hub_cols", "hub_vals",
               "hub_nnz_frac")


def _check_keys(d: Mapping, keys, what: str) -> None:
    missing = [k for k in keys if k not in d]
    if missing:
        raise KeyError(f"{what} arrays lack {missing}")


def operator_from_arrays(d: Mapping) -> GoogleOperator:
    """GoogleOperator from `n`, `indptr`, `src`, `weight`, `row_ids`,
    `dangling`, `alpha` and `v` (None for the uniform teleport)."""
    _check_keys(d, OPERATOR_KEYS, "operator")
    n = int(d["n"])
    pt = TransitionT(
        n=n,
        indptr=np.asarray(d["indptr"], dtype=np.int64),
        src=np.asarray(d["src"], dtype=np.int32),
        weight=np.asarray(d["weight"]),
        row_ids=np.asarray(d["row_ids"], dtype=np.int32),
        dangling=np.asarray(d["dangling"], dtype=bool))
    if (pt.indptr.shape != (n + 1,) or pt.dangling.shape != (n,)
            or not pt.src.shape == pt.weight.shape == pt.row_ids.shape
            or pt.indptr[-1] != pt.nnz):
        raise ValueError("inconsistent operator arrays")
    v = None if d["v"] is None else np.asarray(d["v"], dtype=np.float64)
    return GoogleOperator(pt=pt, alpha=float(d["alpha"]), v=v)


def csr_graph_from_arrays(d: Mapping) -> CSRGraph:
    """CSRGraph (source rows, target columns) from `n`, `indptr` and
    `indices`, as a DeltaGraph's base takes it."""
    _check_keys(d, GRAPH_KEYS, "graph")
    n = int(d["n"])
    g = CSRGraph(n=n, indptr=np.asarray(d["indptr"], dtype=np.int64),
                 indices=np.asarray(d["indices"], dtype=np.int32))
    if (g.indptr.shape != (n + 1,) or g.indptr[0] != 0
            or g.indptr[-1] != g.nnz or np.any(np.diff(g.indptr) < 0)
            or (g.nnz and (g.indices.min() < 0 or g.indices.max() >= n))):
        raise ValueError("inconsistent graph arrays")
    return g


def edge_delta_from_arrays(d: Mapping) -> EdgeDelta:
    """EdgeDelta from `add_src`, `add_dst`, `del_src`, `del_dst` (node
    ids) and `new_nodes`."""
    _check_keys(d, DELTA_KEYS, "delta")
    ids = {k: np.asarray(d[k], dtype=np.int64).ravel()
           for k in DELTA_KEYS[:4]}
    return EdgeDelta(**ids, new_nodes=int(d["new_nodes"]))


def rank_state_from_arrays(d: Mapping) -> RankState:
    """RankState from `x`, `r` (float64), `version`, `alpha` and `v` (None
    for the uniform teleport); x and r are copied, since the updaters
    change them in place."""
    _check_keys(d, STATE_KEYS, "rank state")
    x = np.array(d["x"], dtype=np.float64)
    r = np.array(d["r"], dtype=np.float64)
    v = None if d["v"] is None else np.array(d["v"], dtype=np.float64)
    if x.ndim != 1 or r.shape != x.shape or (v is not None
                                             and v.shape != x.shape):
        raise ValueError("inconsistent rank state arrays")
    return RankState(x=x, r=r, version=int(d["version"]),
                     alpha=float(d["alpha"]), v=v)


def bsr_from_arrays(d: Mapping) -> HybridBSR:
    """HybridBSR from its packed arrays (`n_rows`, `n_cols`, `bm`, `bn`,
    `blocks`, `blk_cols`, `fill_ratio`, `hub_rows`, `hub_cols`, `hub_vals`,
    `hub_nnz_frac`). Block columns are checked against the column count,
    and the padding against `slot_counts`' rule, since the kernel trusts
    both."""
    _check_keys(d, HYBRID_KEYS, "hybrid BSR")
    bsr = BSRMatrix(
        n_rows=int(d["n_rows"]), n_cols=int(d["n_cols"]), bm=int(d["bm"]),
        bn=int(d["bn"]),
        blocks=np.ascontiguousarray(d["blocks"], dtype=np.float32),
        blk_cols=np.ascontiguousarray(d["blk_cols"], dtype=np.int32),
        fill_ratio=float(d["fill_ratio"]))
    nbr, K, bm, bn = bsr.blocks.shape
    if (bm, bn) != (bsr.bm, bsr.bn) or bsr.blk_cols.shape != (nbr, K):
        raise ValueError("inconsistent BSR arrays")
    if bsr.blk_cols.size and (bsr.blk_cols.min() < 0
                              or bsr.blk_cols.max() >= bsr.nbc):
        raise ValueError(f"blk_cols outside [0, {bsr.nbc})")
    # the kernel stops at each block-row's real slots: derive and check
    # them now (ValueError where the padding rule is broken)
    bsr.counts
    return HybridBSR(
        bsr=bsr,
        hub_rows=np.asarray(d["hub_rows"], dtype=np.int32),
        hub_cols=np.asarray(d["hub_cols"], dtype=np.int32),
        hub_vals=np.asarray(d["hub_vals"], dtype=np.float32),
        hub_nnz_frac=float(d["hub_nnz_frac"]))


def _tensor(a) -> torch.Tensor:
    """numpy array -> CPU tensor; bfloat16 arrays (ml_dtypes, as JAX hands
    them out) are reinterpreted bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _stacked_layers(cfg: ModelConfig, group: Mapping, n_layers: int,
                    first_dense: int, where: str) -> list:
    """The layers of one of the JAX package's scanned stacks ({"head",
    "stack", "tail"}) in order. Raises on a layer left over."""
    plan = stack_plan(cfg, n_layers, first_dense)
    group = dict(group)
    layers = [None] * n_layers
    head, stack, tail = (dict(group.pop(g, {})) for g in
                         ("head", "stack", "tail"))
    for i in plan.head + plan.tail:
        layers[i] = (head if i in plan.head else tail).pop(f"layer{i}")
    for j in plan.pattern:
        stacked = stack.pop(f"pos{j}")
        for r in range(plan.repeats):
            layers[len(plan.head) + r * len(plan.pattern) + j] = _index(
                stacked, r)
    left = [f"{where}/{g}/{k}" for g, d in
            (("head", head), ("stack", stack), ("tail", tail)) for k in d]
    left += [f"{where}/{k}" for k in group]
    if left:
        raise KeyError(f"parameters left over: {left}")
    return layers


def lm_params_from_arrays(cfg: ModelConfig, tree: Mapping) -> dict:
    """The port's parameter tree (the shape of `models.model_defs(cfg)`,
    CPU tensors of the arrays' dtypes) from the JAX package's LM parameter
    tree with numpy leaves.

    `decoder/stack/pos{j}` leaves carry a leading repeat axis: element r is
    layer len(head) + r * len(pattern) + j of `stack_plan`.
    `decoder/head/layer{i}` and `decoder/tail/layer{i}` are layer i
    (DeepSeek-V3's `first_dense_layers` are head layers, its MoE layers
    stacked); `embed/tok`, `embed/out` and `final_norm` map as they are.
    An encoder-decoder's `encoder` is laid out as `decoder` is (over
    `n_enc_layers`, no dense head) and its `enc_norm` maps as it is; its
    decoder layers carry `norm_cross` and `cross/{wq, wk, wv, wo}`.
    A layer's leaves keep their names: MLA's `attn/{w_dq, q_norm, w_uq,
    w_dkv, kv_norm, w_kr, w_ukv, wo}` as GQA's `attn/{wq, wk, wv, wo}`.
    Raises on a leaf that is missing, left over or of the wrong shape."""
    defs = model_defs(cfg)
    tree = dict(tree)
    ours = {"embed": tree.pop("embed"),
            "layers": _stacked_layers(cfg, tree.pop("decoder"),
                                      cfg.n_layers, cfg.first_dense_layers,
                                      "decoder"),
            "final_norm": tree.pop("final_norm")}
    if cfg.is_encdec:
        ours["encoder"] = _stacked_layers(
            encoder_config(cfg), tree.pop("encoder"), cfg.n_enc_layers, 0,
            "encoder")
        ours["enc_norm"] = tree.pop("enc_norm")
    if tree:
        raise KeyError(f"parameters left over: {sorted(tree)}")
    return match_defs(defs, ours, lambda d, a: _tensor(a))


def opt_state_from_arrays(cfg: ModelConfig, tree: Mapping) -> dict:
    """The port's AdamW state (`training.optimizer.init_opt_state`'s
    shape: {"m", "v"} trees shaped like `models.model_defs(cfg)`, "step"
    an int32 scalar) from the JAX package's, with numpy leaves: its moment
    trees are laid out as its parameters are (`lm_params_from_arrays`)."""
    _check_keys(tree, ("m", "v", "step"), "optimizer state")
    return {"m": lm_params_from_arrays(cfg, tree["m"]),
            "v": lm_params_from_arrays(cfg, tree["v"]),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32)}


def _index(tree, r: int):
    if isinstance(tree, Mapping):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]
