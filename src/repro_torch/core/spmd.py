"""Bounded-staleness PageRank as a bulk-synchronous shard program, with
all p shards on one card (the JAX package's core/spmd.py, beyond-paper
form).

The JAX package runs one program per device under `shard_map` and renders
the paper's asynchrony as bounded staleness over sparsified collective
schedules (§6: "the flexibility of asynchronous iterations gives us a
choice on the targets of produced messages"). This port keeps that
meaning exactly, superstep for superstep, with the p shards on one leading
axis of every per-shard tensor (runtime/exchange.py has the table of
collectives and their tensor renderings):

  schedule="allgather"    : all-gather every superstep (eq. 4 distributed).
  schedule="allgather_k"  : all-gather every k supersteps; local iterations
                            in between use stale fragments.
  schedule="ring"         : one relay stage per superstep — each shard
                            refreshes exactly one peer fragment per step.
  schedule="sparsified"   : each shard ships only the top-k rows whose
                            |delta| since the last send exceeds a
                            threshold, as (idx, value) pairs, with a forced
                            full refresh every `sparsify_refresh_every`
                            supersteps.
  delivery_prob < 1       : a rejected delivery keeps the stale copy (the
                            draws are the JAX package's hash, bit for bit).

Each shard keeps its own stale view, so the views are one (p, n_pad, nv)
tensor (36 MB at Stanford-Web, p = 4, nv = 8, float32). Every superstep
applies P^T for all shards in one kernel launch: the block-CSR kernel over
the shards' block rows folded into one layout (backend "bsr_pallas" or
"bsr"), or the CSR segment-sum kernel over the shards' edge slices
concatenated into one CSR ("segment_sum", which needs no padded edges and
adds in a fixed order, so a float32 run repeats itself bit for bit). The
hub rows' side path sums in float64, as the port's static solve does.

The loop is a host `while` with a Python superstep counter; its condition
reads the lanes' done bits once a superstep. Termination is the Fig. 1
protocol over all-reduced bits (`runtime.TerminationDriver.bits_step`).
The teleport may be an (n, nv) stack of personalized lanes with per-lane
termination, lane freezing (`freeze_lanes`) and pow2 lane compaction
between chunks (`compact_lanes`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.google import GoogleOperator
from ..kernels.bsr_spmv.ops import build_bsr, hub_csr, slot_counts
from ..runtime import step as _runtime_step
from ..runtime.exchange import spmd_exchange
from .backend import BackendSpec
from .partition import Partition, block_rows, slice_transition

SPMD_BACKENDS = ("segment_sum", "bsr_pallas", "bsr")


@dataclasses.dataclass
class SPMDConfig:
    p: int                       # number of shards (UEs)
    schedule: str = "allgather"  # allgather | allgather_k | ring | sparsified
    sync_every: int = 4          # k for allgather_k
    delivery_prob: float = 1.0   # per-fragment acceptance probability
    tol: float = 1e-6            # local convergence threshold (inf-norm)
    pc_max_compute: int = 1
    pc_max_monitor: int = 1
    max_supersteps: int = 2000
    kind: str = "power"          # power (eq. 6) | linear (eq. 7)
    dtype: str = "float32"
    seed: int = 0
    backend: str = "segment_sum"  # segment_sum | bsr_pallas (alias bsr)
    bsr_bm: int = 0               # block edge; 0 = auto (8 on CUDA and CPU)
    bsr_impl: str = "auto"        # auto | cuda | ref (kernels.resolve_impl)
    hub_quantile: float = 0.99    # rows above this row-nnz quantile -> COO
    freeze_lanes: bool = False    # freeze lanes whose monitor counter fired
    compact_lanes: bool = False   # pow2 lane compaction between chunks
    #                             # (requires freeze_lanes): exit the loop
    #                             # once enough lanes are frozen, shrink the
    #                             # stack to the unfinished lanes padded to
    #                             # the next pow2 and re-enter
    compact_exit: Union[str, float] = "auto"
    #                             # a float f exits once done lanes
    #                             # >= ceil(f * lanes); "auto" exits at the
    #                             # earliest count that can shrink the pow2
    #                             # stack and, when the previous chunk's lane
    #                             # completions clustered, runs to all-done
    # --- sparsified schedule (§6 targeting) ---
    sparsify_k: int = 0           # max rows per payload; 0 = auto (bsize/8)
    sparsify_thresh: float = 0.0  # per-row |delta| floor (0 = any change)
    sparsify_refresh_every: int = 16  # forced full refresh cadence
    sparsify_adaptive: bool = False   # pick k from the row-delta profile
    sparsify_cover_frac: float = 0.9  # |delta| mass the payload must cover
    sparsify_ewma: float = 0.5        # new-observation EWMA weight


@dataclasses.dataclass
class SPMDResult:
    x: np.ndarray                # (n,) — or (n, nv) for teleport stacks
    supersteps: int
    local_resid: np.ndarray      # (p,) final per-shard residuals
                                 # ((p, nv) for teleport stacks)
    comm_bytes_per_step: int     # payload bytes moved per superstep (model)
    comm_bytes_total: int = 0    # payload bytes over the whole run (model)
    rows_sent: int = 0           # sparsified: sparse payload rows shipped
    lane_supersteps: Optional[np.ndarray] = None  # (nv,) first-done step
    lane_chunks: int = 1         # chunks run (compact_lanes)
    # observe=True: one dict per chunk (lanes/steps/rows/fulls/bytes, and
    # the chunk's milliseconds: apply_ms, exchange_ms, protocol_ms, gap_ms
    # from `runtime.step.Spans`, wall_ms on the host clock). The counters
    # restart at zero every chunk, so comm_bytes_total == sum(c["bytes"])
    # and rows_sent == sum(c["rows"]) across the log
    chunk_log: Optional[List[dict]] = None


def _resolve_bsr(cfg: SPMDConfig, device: torch.device) -> Tuple[int, str]:
    """The block edge and impl, by the static solve's policy
    (BackendSpec.resolved)."""
    spec = BackendSpec(name="bsr", impl=cfg.bsr_impl,
                       bm=cfg.bsr_bm).resolved(device)
    return spec.bm, spec.impl


def _pack_structure(op: GoogleOperator, part: Partition, cfg: SPMDConfig,
                    dtype: np.dtype, bm: int) -> dict:
    """The shards' operator slices in one launch's layout (numpy), memoized
    on the operator.

    bsr         : per-shard hub-split BSR as the JAX package packs it (a
                  global hub mask from the row-nnz quantile, one K budget
                  shared by the shards), then folded: blocks
                  (p * nbr_l, K, bm, bm), block columns offset by
                  i * n_pad / bm, each shard's real-slot counts from
                  `slot_counts` on its own packing, and the hub COO sides
                  concatenated with rows offset by i * bsize and columns by
                  i * n_pad, in CSR form (`hub_csr`: `hub_indptr`,
                  `hub_map`, `hub_cols`, `hub_vals`) for the CSR kernel's
                  hub lane.
    segment_sum : the shards' edge slices as one CSR over the p * bsize
                  packed rows (padding rows hold no edge), sources offset
                  by i * n_pad into the stacked views; no padded edges.
    Always: bsize (block-aligned under bsr), n_pad = p * bsize, the valid-
    row mask and the dangling rows in packed-view coordinates.
    """
    use_bsr = cfg.backend != "segment_sum"
    key = ("spmd_pack", part.p, use_bsr, bm, cfg.hub_quantile, dtype.str)
    cache = op._cache()
    if key in cache:
        return cache[key]
    p, n = part.p, part.n
    bsize = int(part.sizes().max())
    if use_bsr:
        bsize = -(-bsize // bm) * bm       # block-align every fragment
    n_pad = p * bsize
    pt = op.pt

    valid = np.zeros((p, bsize), dtype=dtype)
    dang = np.zeros((n_pad,), dtype=bool)
    for i in range(p):
        s, t = part.block(i)
        valid[i, : t - s] = 1.0
        dang[i * bsize: i * bsize + (t - s)] = pt.dangling[s:t]
    packed = dict(key=key, valid=valid, dang=np.flatnonzero(dang),
                  bsize=bsize, n_pad=n_pad)
    blocks = [slice_transition(pt, part, i) for i in range(p)]

    if use_bsr:
        row_nnz = np.diff(pt.indptr)
        if cfg.hub_quantile < 1.0:
            hub_row = row_nnz > np.quantile(row_nnz, cfg.hub_quantile)
        else:
            hub_row = np.zeros(n, dtype=bool)
        shard = []
        for i, b in enumerate(blocks):
            s, _ = part.block(i)
            rows = b["row_ids"].astype(np.int64)
            cols = col_map_seg(part, bsize, b["src"]).astype(np.int64)
            vals = np.asarray(b["weight"], dtype=np.float32)
            is_hub = hub_row[rows + s]
            shard.append(dict(rows=rows[~is_hub], cols=cols[~is_hub],
                              vals=vals[~is_hub], h_rows=rows[is_hub],
                              h_cols=cols[is_hub], h_vals=vals[is_hub]))
        # one K budget across shards
        nbc_g = n_pad // bm
        K = 1
        for sh in shard:
            key_ = np.unique((sh["rows"] // bm) * nbc_g + sh["cols"] // bm)
            if len(key_):
                per = np.bincount((key_ // nbc_g).astype(np.int64),
                                  minlength=bsize // bm)
                K = max(K, int(per.max()))
        nbr_l = bsize // bm
        blk = np.zeros((p, nbr_l, K, bm, bm), dtype=np.float32)
        bcols = np.zeros((p, nbr_l, K), dtype=np.int32)
        counts = np.zeros((p, nbr_l), dtype=np.int32)
        fills = []
        for i, sh in enumerate(shard):
            b = build_bsr(sh["rows"], sh["cols"], sh["vals"],
                          n_rows=bsize, n_cols=n_pad, bm=bm, bn=bm,
                          k_budget=K, unique_pairs=True)
            blk[i] = b.blocks
            bcols[i] = b.blk_cols
            counts[i] = slot_counts(b.blk_cols, b.blocks)
            fills.append(b.fill_ratio)
        # fold the shard axis into the block rows: shard i reads its view,
        # block columns i * n_pad / bm onward of the stacked views
        bcols += (np.arange(p, dtype=np.int32) * nbc_g)[:, None, None]
        packed.update(
            blocks=blk.reshape(p * nbr_l, K, bm, bm),
            blk_cols=bcols.reshape(p * nbr_l, K),
            blk_count=counts.reshape(-1),
            **hub_csr(
                np.concatenate([sh["h_rows"] + i * bsize
                                for i, sh in enumerate(shard)]),
                np.concatenate([sh["h_cols"] + i * n_pad
                                for i, sh in enumerate(shard)]),
                np.concatenate([sh["h_vals"] for sh in shard])),
            K=K, bm=bm, fill_ratio=float(np.mean(fills)))
    else:
        indptr = np.zeros(p * bsize + 1, dtype=np.int64)
        src, wgt, rid = [], [], []
        off = 0
        for i, b in enumerate(blocks):
            s, t = part.block(i)
            e = b["src"].shape[0]
            local = pt.indptr[s:t + 1] - pt.indptr[s]
            indptr[i * bsize + 1: i * bsize + (t - s) + 1] = off + local[1:]
            indptr[i * bsize + (t - s) + 1: (i + 1) * bsize + 1] = off + e
            # sources live in packed-view coordinates of the stacked views
            src.append(col_map_seg(part, bsize, b["src"]) + i * n_pad)
            wgt.append(np.asarray(b["weight"], dtype=dtype))
            rid.append(b["row_ids"] + i * bsize)
            off += e
        packed.update(indptr=indptr,
                      src=np.concatenate(src).astype(np.int32),
                      weight=np.concatenate(wgt),
                      row_ids=np.concatenate(rid).astype(np.int32),
                      emax=max(b["src"].shape[0] for b in blocks))
    cache[key] = packed
    return packed


def _pack_blocks(op: GoogleOperator, part: Partition, dtype, cfg: SPMDConfig,
                 v_stack: np.ndarray, bm: int = 0) -> dict:
    """The packed shard state: `_pack_structure` plus the per-shard
    teleport fragments `vblk` ((p, bsize, nv) lanes)."""
    dtype = np.dtype(dtype)
    packed = dict(_pack_structure(op, part, cfg, dtype, bm))
    p, bsize, nv = part.p, packed["bsize"], v_stack.shape[1]
    vblk = np.zeros((p, bsize, nv), dtype=dtype)
    for i in range(p):
        s, t = part.block(i)
        vblk[i, : t - s] = v_stack[s:t]
    packed["vblk"] = vblk
    return packed


def col_map_seg(part: Partition, bsize: int, cols: np.ndarray) -> np.ndarray:
    """Map global column ids into packed-view coordinates (identity when
    fragments are unpadded, shifted when block-aligned)."""
    out = np.empty(len(cols), dtype=np.int32)
    owners = np.searchsorted(np.asarray(part.ends), cols, side="right")
    starts = np.asarray(part.starts)
    out[:] = owners * bsize + (cols - starts[owners])
    return out


def _device_structure(op: GoogleOperator, packed: dict, use_bsr: bool,
                      device: torch.device) -> dict:
    """The structural tensors on `device`, memoized on the operator beside
    the host packing."""
    key = packed["key"] + (device,)
    cache = op._cache()
    if key in cache:
        return cache[key]
    names = (("blocks", "blk_cols", "blk_count", "hub_indptr", "hub_map",
              "hub_cols", "hub_vals") if use_bsr else
             ("indptr", "src", "weight", "row_ids"))
    dev = dict(op_dev={k: torch.as_tensor(packed[k], device=device)
                       for k in names},
               valid=torch.as_tensor(packed["valid"], device=device),
               dang=torch.as_tensor(packed["dang"], device=device))
    cache[key] = dev
    return dev


def solve_spmd(op: GoogleOperator, cfg: SPMDConfig,
               device: DeviceLike = None, v: Optional[np.ndarray] = None,
               observe: bool = False) -> SPMDResult:
    """Run the shard program to Fig. 1 termination (or `max_supersteps`).

    `device=None` means the CUDA card, and raises without one; pass
    `device="cpu"` for the plain PyTorch versions of the kernels. The JAX
    package's `mesh=` argument has no counterpart: the p shards are one
    leading tensor axis on one device, not a device mesh. `v` is an (n,)
    teleport or an (n, nv) stack of personalized lanes (None: the
    operator's). `observe=True` fills `chunk_log`.
    """
    if cfg.compact_lanes and not cfg.freeze_lanes:
        raise ValueError("compact_lanes=True requires freeze_lanes=True "
                         "(compaction shrinks the stack to unfrozen lanes)")
    ce = cfg.compact_exit
    if not (ce == "auto" or (isinstance(ce, (int, float))
                             and not isinstance(ce, bool)
                             and 0.0 < float(ce) <= 1.0)):
        raise ValueError(f"compact_exit must be 'auto' or a fraction in "
                         f"(0, 1], got {ce!r}")
    if cfg.backend not in SPMD_BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; expected one of "
                         f"{SPMD_BACKENDS}")
    device = resolve_device(device)
    p = cfg.p
    n = op.n
    np_dtype = np.dtype(cfg.dtype)

    v_stack = np.asarray(op.teleport() if v is None else v,
                         dtype=np.float64)
    if v_stack.ndim == 1:
        v_stack = v_stack[:, None]
    if v_stack.shape[0] != n:
        raise ValueError(f"teleport v has {v_stack.shape[0]} rows, "
                         f"operator has {n}")
    nv = v_stack.shape[1]

    use_bsr = cfg.backend != "segment_sum"
    bm, impl = _resolve_bsr(cfg, device) if use_bsr else (0, "auto")
    # uniform blocks (the paper's ceil(n/p) scheme) padded to p * bsize
    part = block_rows(n, p)
    packed = _pack_blocks(op, part, np_dtype, cfg, v_stack, bm)
    bsize = packed["bsize"]
    n_pad = packed["n_pad"]
    dev = _device_structure(op, packed, use_bsr, device)

    alpha = float(op.alpha)
    linear = cfg.kind == "linear"

    init_comm, comm = spmd_exchange(
        cfg.schedule, p=p, bsize=bsize, n_pad=n_pad,
        sync_every=cfg.sync_every, sparsify_k=cfg.sparsify_k,
        sparsify_row_thresh=cfg.sparsify_thresh,
        sparsify_refresh_every=cfg.sparsify_refresh_every,
        sparsify_adaptive=cfg.sparsify_adaptive,
        sparsify_cover_frac=cfg.sparsify_cover_frac,
        sparsify_ewma=cfg.sparsify_ewma,
        # endgame guard: a delta mass at the tolerance scale ships full
        # payloads so the persistence counters can settle
        sparsify_endgame_mass=cfg.tol * bsize * nv)

    x0_blocks = (np.full((p, bsize, nv), 1.0 / n, dtype=np_dtype)
                 * packed["valid"][:, :, None])

    def run_chunk(vblk_np, x0_np, max_steps, compact_exit, exit_k=0):
        """One loop over the lanes of `vblk_np` ((p, bsize, nv_c) teleport
        blocks) from iterate `x0_np`. With `compact_exit` the loop also
        exits once `exit_k` lanes are done (the pow2-compaction hook)."""
        nv_c = vblk_np.shape[2]
        vb = torch.as_tensor(np.ascontiguousarray(vblk_np), device=device)
        x0 = torch.as_tensor(np.ascontiguousarray(x0_np), device=device)
        pt_apply = _runtime_step.shard_pt_apply(
            dev["op_dev"], use_bsr=use_bsr, bsize=bsize, nv=nv_c,
            n_pad=n_pad, bm=bm, impl=impl)
        local_update = _runtime_step.shard_local_update(
            pt_apply, alpha=alpha, linear=linear, n=n, vb=vb,
            val=dev["valid"], dang=dev["dang"])
        spans = _runtime_step.Spans(device) if observe else None
        superstep, cond = _runtime_step.shard_superstep_fns(
            local_update, comm, p=p, tol=cfg.tol,
            pc_max_compute=cfg.pc_max_compute,
            pc_max_monitor=cfg.pc_max_monitor, seed=cfg.seed,
            q=cfg.delivery_prob, freeze_lanes=cfg.freeze_lanes,
            max_steps=max_steps, compact_exit=compact_exit, exit_k=exit_k,
            spans=spans)
        carry = _runtime_step.init_carry(x0, init_comm, nv=nv_c,
                                         n_pad=n_pad)
        t0 = time.perf_counter()
        while cond(carry):
            carry = superstep(carry)
        wall_ms = (time.perf_counter() - t0) * 1e3
        (view, frag, _, step, _, _, _, lane_step, rows_sent,
         fulls) = carry
        resid = (local_update(view) - frag).abs().amax(dim=1)
        timing = None
        if spans is not None:
            timing = {f"{k}_ms": ms for k, ms in spans.totals().items()}
            timing["wall_ms"] = wall_ms
        return (frag.double().cpu().numpy(), step, resid.cpu().numpy(),
                lane_step.cpu().numpy().astype(np.int64).max(axis=0),
                int(rows_sent.sum()), int(fulls.sum()), timing)

    def chunk_bytes(nv_c, steps_c, rows_c, fulls_c):
        return _runtime_step.comm_bytes_model(
            cfg.schedule, p=p, bsize=bsize, itemsize=np_dtype.itemsize,
            nv=nv_c, steps=steps_c, rows=rows_c, fulls=fulls_c,
            sync_every=cfg.sync_every)

    def log_chunk(chunk, lanes, steps, rows, fulls, nbytes, timing):
        if chunk_log is not None:
            chunk_log.append(dict(chunk=chunk, lanes=lanes, steps=steps,
                                  rows=rows, fulls=fulls, bytes=nbytes,
                                  **(timing or {})))

    compact = bool(cfg.compact_lanes and cfg.freeze_lanes and nv > 1)
    vblk_full = packed["vblk"]
    chunk_log: Optional[List[dict]] = [] if observe else None
    if not compact:
        (frag_mat, supersteps, resid_mat, lane_out, rows_total, fulls_total,
         timing) = run_chunk(vblk_full, x0_blocks, cfg.max_supersteps, False)
        comm_total = chunk_bytes(nv, supersteps, rows_total, fulls_total)
        chunks = 1
        log_chunk(0, nv, supersteps, rows_total, fulls_total, comm_total,
                  timing)
    else:
        # ---- pow2 lane compaction between chunks ------------------------
        # Run until enough active lanes are frozen (compact_exit), then
        # shrink the (bsize, nv) stack to the survivors padded to the next
        # pow2 (padding duplicates a survivor so the Fig. 1 bits of every
        # carried lane are real) and re-enter with the current fragments as
        # x0. Frozen lanes stop costing flops and exchange bytes; their
        # results are recorded at the chunk boundary.
        frag_mat = np.zeros((p, bsize, nv))
        resid_mat = np.zeros((p, nv), dtype=np_dtype)
        lane_out = np.full(nv, -1, dtype=np.int64)
        active = list(range(nv))            # real lane id per position
        real = [True] * nv                  # padding positions are False
        cur_v, cur_x0 = vblk_full, x0_blocks
        steps_done = 0
        comm_total = 0
        rows_total = fulls_total = 0
        chunks = 0
        prev_done_rel = None    # last chunk's lane-completion steps
        prev_st = 0
        while True:
            chunks += 1
            budget = cfg.max_supersteps - steps_done
            nv_c = cur_v.shape[2]
            if ce != "auto":
                exit_k = max(1, int(np.ceil(float(ce) * nv_c)))
            else:
                # the earliest done-count at which the pow2 stack width
                # can shrink (on pow2 widths the half rule)
                half = (1 << max(nv_c - 1, 0).bit_length()) // 2
                exit_k = max(1, nv_c - half)
                # when the previous chunk's lane completions clustered
                # inside a quarter of the chunk, run this chunk to
                # all-done instead of paying a compaction boundary
                if (prev_done_rel is not None and prev_done_rel.size >= 2
                        and prev_st > 0
                        and float(prev_done_rel.max() - prev_done_rel.min())
                        <= 0.25 * prev_st):
                    exit_k = nv_c + 1
            fr, st, rs, ls, rows_c, fulls_c, timing = run_chunk(
                cur_v, cur_x0, budget, True, exit_k)
            prev_done_rel = ls[np.asarray(real) & (ls >= 0)]
            prev_st = st
            steps_done += st
            cb = chunk_bytes(len(active), st, rows_c, fulls_c)
            # the in-loop counters restarted at zero with this chunk, so
            # the totals accumulate here
            comm_total += cb
            rows_total += rows_c
            fulls_total += fulls_c
            log_chunk(chunks - 1, len(active), st, rows_c, fulls_c, cb,
                      timing)
            done_pos = ls >= 0
            for pos, lane in enumerate(active):
                if not real[pos]:
                    continue
                finished = bool(done_pos[pos])
                if finished or steps_done >= cfg.max_supersteps \
                        or np.all(done_pos):
                    frag_mat[:, :, lane] = fr[:, :, pos]
                    resid_mat[:, lane] = rs[:, pos]
                    if finished:
                        lane_out[lane] = steps_done - st + int(ls[pos])
            survivors = [active[pos] for pos in range(len(active))
                         if real[pos] and not done_pos[pos]]
            if not survivors or steps_done >= cfg.max_supersteps:
                break
            nv_next = 1 << (len(survivors) - 1).bit_length()
            pad = nv_next - len(survivors)
            pos_of = {lane: pos for pos, lane in enumerate(active)}
            keep_pos = [pos_of[ln] for ln in survivors] \
                + [pos_of[survivors[0]]] * pad
            cur_v = np.ascontiguousarray(cur_v[:, :, keep_pos])
            cur_x0 = np.ascontiguousarray(
                fr[:, :, keep_pos].astype(np_dtype))
            active = survivors + [survivors[0]] * pad
            real = [True] * len(survivors) + [False] * pad
        supersteps = steps_done

    # un-pack: drop each fragment's block-alignment padding
    x = np.empty((n, nv), dtype=np.float64)
    for i in range(p):
        s, t = part.block(i)
        x[s:t] = frag_mat[i, : t - s]
    s_ = x.sum(axis=0)
    x = np.where(s_ > 0, x / np.where(s_ > 0, s_, 1.0), x)

    comm_step = comm_total // max(supersteps, 1)
    resid_out = np.asarray(resid_mat)                   # (p, nv)
    if nv == 1:
        x = x[:, 0]
        resid_out = resid_out[:, 0]
    return SPMDResult(x=x, supersteps=supersteps,
                      local_resid=resid_out,
                      comm_bytes_per_step=int(comm_step),
                      comm_bytes_total=int(comm_total),
                      rows_sent=int(rows_total),
                      lane_supersteps=lane_out if nv > 1 else None,
                      lane_chunks=chunks, chunk_log=chunk_log)
