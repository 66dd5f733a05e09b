"""The shard program's superstep — the eq. (5) cycle for all p shards at
once, on one card.

The JAX package builds one shard's traced superstep and runs p copies of it
under `shard_map` (repro/runtime/step.py:362-550). Here every per-shard
array carries a leading `p` axis and one function steps every shard:

  hash_uniform        the delivery draws, computed on the host in numpy
                      uint32 (which wraps as XLA's does), one per shard;
  shard_pt_apply      P^T over every shard's operator slice in ONE launch:
                      the block-CSR kernel over the shards' block rows
                      folded into one layout, or the CSR segment-sum kernel
                      over the shards' edge slices concatenated into one
                      CSR (on CPU tensors, their plain versions);
  shard_local_update  f_i, the new own fragments from the stale views;
  shard_superstep_fns the superstep (local update, `exchange.spmd_exchange`,
                      and the Fig. 1 protocol over the all-reduced bits,
                      `TerminationDriver.bits_step` with
                      `transport.mesh_psum`) and the loop condition, which
                      reads the lanes' done bits on the host once a
                      superstep;
  init_carry          the carry at superstep 0;
  comm_bytes_model    the payload bytes of a loop segment.

The superstep counter is a Python int, and the protocol counters are int32
tensors, as in the JAX package's carry. The shard program (`core.spmd`)
and the device transport (`runtime.device`) assemble their loops from
these builders. The host rendering of a shard's cycle (`HostShardStep`) is
not ported yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..graph.csr import pt_matvec
from ..kernels import resolve_impl
from ..kernels.bsr_spmv.ops import hybrid_matvec
from .driver import TerminationDriver
from .transport import mesh_psum


def hash_uniform(seed: int, step, lane) -> np.ndarray:
    """Counter-based uniform in [0, 1) (numpy float32): a SplitMix-style
    integer mix of (seed, superstep, shard) in uint32 arithmetic that wraps
    as the JAX package's does, so the draws are the same bits."""
    step = np.asarray(step).astype(np.uint32)
    lane = np.asarray(lane).astype(np.uint32)
    with np.errstate(over="ignore"):
        z = (step * np.uint32(0x9E3779B9) + lane * np.uint32(0x85EBCA6B)
             + np.uint32(seed & 0xFFFFFFFF))
        z = (z ^ (z >> np.uint32(16))) * np.uint32(0x7FEB352D)
        z = (z ^ (z >> np.uint32(15))) * np.uint32(0x846CA68B)
    z = z ^ (z >> np.uint32(16))
    return z.astype(np.float32) * np.float32(2.0 ** -32)


def shard_pt_apply(op_dev: dict, *, use_bsr: bool, bsize: int, nv: int,
                   n_pad: int = 0, bm: int = 0, impl: str = "auto",
                   accum: str = "f32"):
    """Every shard's P^T apply over its operator slice, as one launch.

    op_dev for the BSR backend: the shards' block rows folded into one
    `HybridBSR.device`-style dict (`blocks` (p * nbr_l, K, bm, bm), block
    columns offset by i * n_pad / bm for shard i, `blk_count`, and the hub
    rows' side offset likewise, in CSR form), read against the
    stacked views as (p * n_pad / bm, bm, nv), the hub rows summed in
    float64 (`hybrid_matvec`: on the card the CSR kernel's hub lane, in a
    fixed order; the JAX package sums them in float32). For the
    segment-sum backend: one CSR over the p * bsize packed rows (`indptr`,
    `src` offset by i * n_pad into the stacked views, `weight`,
    `row_ids`), summed in the views' dtype. Returns
    pt_apply(view) -> (p, bsize, nv) in the views' dtype.

    The numerics of each block lane (`accum`):
      "f32"   the views rounded to float32, the block sums in float32;
      "kahan" the views rounded to float32, the block sums
              Kahan-compensated over the K slots;
      "f64"   on the CPU the views' own dtype with float64 block sums (the
              plain version); on the card the views rounded to float32 for
              the Kahan block kernel and the hub lane (the kernels take
              float32 x, as the JAX package's kernel paths render "f64" as
              "kahan"), the float32 result widened to the views' dtype.
    """
    if use_bsr:
        def pt_apply(view):
            p = view.shape[0]
            # the kernels read float32 x; only the CPU's plain "f64" lane
            # keeps a float64 view as it is
            narrow = accum != "f64" or resolve_impl(impl, view) == "cuda"
            cast = view.float() if narrow else view
            xb = cast.reshape(p * n_pad // bm, bm, nv)
            y = hybrid_matvec(op_dev, xb, impl=impl, accum=accum)
            return y.reshape(p, bsize, nv).to(view.dtype)
        return pt_apply

    def pt_apply(view):
        p = view.shape[0]
        y = pt_matvec(op_dev, view.reshape(p * n_pad, nv), p * bsize,
                      impl=impl)
        return y.reshape(p, bsize, nv)
    return pt_apply


def tree_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 of a (p, rows, nv) tensor as a halving tree of
    elementwise adds: the rows are zero-padded to a power of two, and each
    level adds the second half onto the first. PyTorch's own reductions
    pick their order from the tensor's shape (summing (p, rows, nv) over
    rows adds lane j in another order at nv = 1 than at nv = 8, and the
    card splits rows by shape); here every lane is added in the same
    order on every device, in log2(rows) launches. Returns (p, nv)."""
    rows = a.shape[1]
    if rows <= 1:
        return a.sum(dim=1)
    half = 1 << ((rows - 1).bit_length() - 1)      # the padded size / 2
    out = a[:, :half].clone()
    out[:, : rows - half] += a[:, half:]
    while out.shape[1] > 1:
        half = out.shape[1] // 2
        out = out[:, :half] + out[:, half:]
    return out[:, 0]


def shard_local_update(pt_apply, *, alpha: float, linear: bool, n: int,
                       vb, val, dang):
    """f_i for every shard: the new own fragments from the (stale) views,
    per lane. The scalar dangling/teleport corrections are masked so
    block-aligned padding rows stay exactly zero. `vb` (p, bsize, nv)
    teleport fragments, `val` (p, bsize) valid-row masks, `dang` the
    dangling rows' indices in packed-view coordinates.

    The two sums over a view's rows (the dangling mass and, in the power
    form, the total mass) are `tree_sum`s, whose order is fixed by the row
    positions alone: lane j's bits do not depend on the lane count, so
    lane compaction gives the masked run's bits, on the CPU and on the
    card."""

    def local_update(view):
        y = alpha * pt_apply(view)
        dmass = tree_sum(view.index_select(1, dang))
        y = y + alpha * dmass[:, None, :] / n * val[:, :, None]
        if linear:
            y = y + (1.0 - alpha) * vb
        else:
            y = y + (1.0 - alpha) * tree_sum(view)[:, None, :] * vb
        return y * val[:, :, None]
    return local_update


class Spans:
    """Time marks around a superstep's phases: CUDA events on the card,
    read once at the end of a loop, or the host clock on the CPU.
    `totals()` sums the time from each mark to the next under the later
    mark's label; the time from a superstep's last mark to the next one's
    first (the host's read of the done bits and its turnaround) goes under
    "gap"."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, label: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((label, ev))
        else:
            self.marks.append((label, time.perf_counter()))

    def totals(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (_, a), (label, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            key = "gap" if label == "start" else label
            out[key] = out.get(key, 0.0) + ms
        return out


def shard_superstep_fns(local_update, comm, *, p: int, tol: float,
                        pc_max_compute: int, pc_max_monitor: int,
                        seed: int, q: float, freeze_lanes: bool,
                        max_steps, compact_exit: bool = False,
                        exit_k: int = 0, conv: str = "linf",
                        spans: Optional[Spans] = None):
    """The superstep body and the loop condition, over the carry

      (view, frag, comm_state, step, pc, mon_pc, lane_done, lane_step,
       rows_sent, fulls)

    with `step` a Python int, `fulls` a (p,) numpy int array and the rest
    tensors with a leading p axis. `conv` picks when a shard has converged
    on a lane: "linf", the inf-norm of its fragment's change under `tol`
    (the shard program); "l1_psum", the all-reduced L1 of every shard's
    fragment change at most `tol` — for the linear form ||r||_1 of the
    previous iterate up to view staleness, the same verdict on every shard
    (the device transport). Both run through the same `bits_step`
    persistence counters. The condition reads the lanes' done bits to the
    host: one sync a superstep. `spans`, when given, is marked around the
    phases.
    """
    if conv not in ("linf", "l1_psum"):
        raise ValueError(f"unknown convergence test {conv!r}")
    psum = mesh_psum(0)
    shards = np.arange(p)
    mark = spans.mark if spans is not None else (lambda label: None)
    tol_of = {}     # tol in the iterate's dtype, uploaded once

    def tol_like(t):
        key = (t.dtype, t.device)
        if key not in tol_of:
            tol_of[key] = torch.tensor(tol, dtype=t.dtype, device=t.device)
        return tol_of[key]

    def superstep(carry):
        (view, frag, comm_state, step, pc, mon_pc, lane_done,
         lane_step, rows_sent, fulls) = carry
        mark("start")
        newfrag = local_update(view)
        if freeze_lanes:
            # frozen lanes keep their fragment — the monitor already
            # observed persistent global convergence
            newfrag = torch.where(lane_done[:, None, :], frag, newfrag)
        delta = (newfrag - frag).abs()
        if conv == "linf":
            locally_conv = delta.amax(dim=1) < tol_like(delta)    # (p, nv)
        else:
            total = psum(tree_sum(delta))                         # (1, nv)
            locally_conv = (total <= tol_like(total)).expand(
                p, total.shape[1])
        mark("apply")

        # ---- communication (ExchangePlan, bulk-sync) ---------------------
        accept = hash_uniform(seed, step, shards) < np.float32(q)
        view, comm_state, nsent, nfull = comm(view, newfrag, comm_state,
                                              step, accept)
        mark("exchange")

        # ---- Fig. 1 over the all-reduced bits ---------------------------
        pc, mon_pc, done_now = TerminationDriver.bits_step(
            locally_conv, pc, mon_pc, p=p, pc_max_compute=pc_max_compute,
            pc_max_monitor=pc_max_monitor, psum=psum)
        done_now = done_now.expand_as(lane_done)
        lane_step = torch.where(done_now & (lane_step < 0),
                                torch.full_like(lane_step, step + 1),
                                lane_step)
        mark("protocol")
        return (view, newfrag, comm_state, step + 1, pc, mon_pc, done_now,
                lane_step, rows_sent + nsent, fulls + nfull)

    def cond(carry):
        step, lane_done = carry[3], carry[6]
        if step >= max_steps:
            return False
        done = lane_done[0].cpu().numpy()
        keep = not done.all()
        if compact_exit:
            # the pow2-compaction hook: once exit_k lanes are frozen, hand
            # control back to the host so the stack can shrink instead of
            # masking dead lanes
            keep = keep and int(done.sum()) < exit_k
        return keep

    return superstep, cond


def init_carry(myx: torch.Tensor, init_comm, *, nv: int, n_pad: int):
    """The loop carry at superstep 0: every shard's view is the gathered
    fragments `myx` (p, bsize, nv); fresh protocol counters, zeroed comm
    telemetry."""
    p = myx.shape[0]
    dev = myx.device
    view0 = myx.reshape(1, n_pad, nv).expand(p, n_pad, nv).contiguous()
    zeros = torch.zeros((p, nv), dtype=torch.int32, device=dev)
    return (view0, myx, init_comm(myx), 0, zeros, zeros,
            torch.zeros((p, nv), dtype=torch.bool, device=dev),
            torch.full((p, nv), -1, dtype=torch.int32, device=dev),
            torch.zeros(p, dtype=torch.int64, device=dev),
            np.zeros(p, np.int64))


def comm_bytes_model(schedule: str, *, p: int, bsize: int, itemsize: int,
                     nv: int, steps: int, rows: int, fulls: int,
                     sync_every: int = 4) -> int:
    """Payload bytes moved by one loop segment — the single byte-accounting
    model for every exchange schedule (the static schedules scale with the
    lane count; sparsified uses the in-loop (rows, fulls) counters)."""
    frag_bytes = bsize * itemsize
    if schedule == "ring":
        return p * frag_bytes * nv * steps
    if schedule == "allgather_k":
        return (p * (p - 1) * frag_bytes * nv // sync_every) * steps
    if schedule == "sparsified":
        # (idx, value-lanes) pairs to p-1 peers per sparse payload row,
        # plus the forced full refreshes (each due step is one full
        # all-gather)
        entry = 4 + itemsize * nv
        return (rows * (p - 1) * entry
                + fulls * (p - 1) * frag_bytes * nv)
    return p * (p - 1) * frag_bytes * nv * steps
