"""DeviceShardTransport — the eq. (5) cycle as p shard programs on one card
(the JAX package's runtime/device.py:47-284).

The third rendering of the shard transport seam (the host threads and
worker-process transports are not ported yet, ROADMAP Queue 1 item 7): the
per-shard cycle runs as the shard program, built from the SAME superstep
builders the SPMD solver runs (runtime/step.py), with the p shards on one
leading tensor axis of one device, as `core.spmd` holds them:

  drain     — `shard_local_update` of the linear form over the shards'
              operator slices, packed by `core.spmd` (`_pack_blocks`,
              `_device_structure`): the block kernel with its f32 and
              Kahan lanes over the shards' folded block rows, or the CSR
              kernel's float64 (or float32) lane over their edge slices.
  exchange  — an `exchange.spmd_exchange` schedule: the ring relay, the
              (strided) all-gathers, or the §6 sparsified plan (top-k
              |delta| rows as (idx, value) payloads with the forced full
              refresh, the bounded-delay escape hatch).
  report    — the all-reduced Fig. 1 bits (`TerminationDriver.bits_step`
              over `transport.mesh_psum`), fed by the *value* criterion:
              the all-reduced L1 of the fragment delta, which for the
              linear form (eq. 7) is ||r||_1 of the previous iterate up to
              view staleness (`shard_superstep_fns(conv="l1_psum")`).

Numerics: `dtype="float64"` (the default) runs the segment-sum drain in
float64 end to end, for certificates at 1e-8 scales below the float32
floor (~n * eps32). The block backend keeps its blocks in float32; its
`accum` lane is "f32", "kahan" (compensated over the K slots) or, the
default for a float64 run, "f64": float64 sums on the CPU's plain path,
and on the card the Kahan kernel over the views rounded to float32
(`step.shard_pt_apply` has each lane's numerics).

The bytes moved come from `step.comm_bytes_model` over the in-loop (rows,
fulls) counters — the accounting the SPMD solver uses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .exchange import SPMD_SCHEDULES

ACCUMS = ("f32", "kahan", "f64")


@dataclasses.dataclass
class DeviceRunResult:
    """One device-program drain: the new iterate plus honest telemetry."""
    x: np.ndarray                # (n,) float64, NOT renormalized
    supersteps: int
    rows_sent: int               # sparsified: sparse payload rows shipped
    fulls: int                   # full-fragment refreshes (shard-steps)
    comm_bytes_total: int        # via step.comm_bytes_model
    device_resid: float          # final all-reduced fragment-delta L1
    converged: bool              # in-loop Fig. 1 fired before the step cap
    p: int = 0
    schedule: str = ""


class DeviceShardTransport:
    """p shard programs on one device, one superstep for all of them.

    This rendering is bulk-synchronous inside, so "async" means what §6
    says it means: sparsified, delayed, bounded-staleness exchange — not
    unblocked threads. Determinism follows: a run is a function of
    (operator, x0, config).

    Parameters mirror the SPMD solver's exchange/backend knobs. The JAX
    package's `mesh` (the first p devices by default) has no single-card
    counterpart: `device` takes its place (None: the CUDA card, raising
    without one; "cpu" runs the kernels' plain versions).
    """

    def __init__(self, p: int, *, exchange: str = "sparsified",
                 dtype: str = "float64", backend: str = "segment_sum",
                 bsr_bm: int = 0, bsr_impl: str = "auto",
                 accum: Optional[str] = None, sync_every: int = 4,
                 sparsify_k: int = 0, sparsify_thresh: float = 0.0,
                 sparsify_refresh_every: int = 4,
                 sparsify_adaptive: bool = False,
                 pc_max_compute: int = 1, pc_max_monitor: int = 1,
                 seed: int = 0, device: DeviceLike = None):
        from ..core.spmd import SPMD_BACKENDS
        if exchange not in SPMD_SCHEDULES:
            raise ValueError(f"unknown exchange schedule {exchange!r}")
        if backend not in SPMD_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype {dtype!r}")
        # the accumulation lane: wide whenever the run itself is wide, the
        # plain f32 contract otherwise (callers may pin "kahan")
        accum = accum if accum is not None else (
            "f64" if dtype == "float64" else "f32")
        if accum not in ACCUMS:
            raise ValueError(f"unknown accum {accum!r}")
        self.p = int(p)
        self.exchange = exchange
        self.dtype = dtype
        self.backend = backend
        self.bsr_bm = bsr_bm
        self.bsr_impl = bsr_impl
        self.accum = accum
        self.sync_every = sync_every
        self.sparsify_k = sparsify_k
        self.sparsify_thresh = sparsify_thresh
        self.sparsify_refresh_every = sparsify_refresh_every
        self.sparsify_adaptive = sparsify_adaptive
        self.pc_max_compute = pc_max_compute
        self.pc_max_monitor = pc_max_monitor
        self.seed = seed
        self.device = device

    def run(self, op, x0: np.ndarray, *, target: float,
            max_supersteps: int = 2000,
            v: Optional[np.ndarray] = None) -> DeviceRunResult:
        """Drain `op`'s linear form (eq. 7) from warm start `x0` until the
        all-reduced fragment-delta L1 holds <= `target` for the Fig. 1
        persistence window, or `max_supersteps` elapse.

        `target` is an *absolute* L1 threshold on the device-visible
        delta; a caller that publishes a certificate computes it on the
        host from the returned x (an exact residual), never from this
        loop's own criterion.
        """
        from ..core.partition import block_rows
        from ..core.spmd import (SPMDConfig, _device_structure,
                                 _pack_blocks, _resolve_bsr)
        from . import step as _step
        from .exchange import spmd_exchange

        device = resolve_device(self.device)
        p = self.p
        n = op.n
        alpha = float(op.alpha)
        np_dtype = np.dtype(self.dtype)

        v_stack = np.asarray(op.teleport() if v is None else v,
                             dtype=np.float64)
        if v_stack.ndim == 1:
            v_stack = v_stack[:, None]
        if v_stack.shape != (n, 1):
            raise ValueError(f"device transport is single-lane; teleport "
                             f"has shape {v_stack.shape}")
        x0 = np.asarray(x0, dtype=np.float64)
        if x0.shape != (n,):
            raise ValueError(f"x0 has shape {x0.shape}, expected ({n},)")

        # the SPMD packer verbatim (one packing layout to maintain); only
        # its schedule/backend fields are read
        cfg = SPMDConfig(p=p, schedule=self.exchange, dtype=self.dtype,
                         backend=self.backend, bsr_bm=self.bsr_bm,
                         bsr_impl=self.bsr_impl)
        use_bsr = self.backend != "segment_sum"
        bm, impl = _resolve_bsr(cfg, device) if use_bsr else (0, "auto")
        part = block_rows(n, p)
        packed = _pack_blocks(op, part, np_dtype, cfg, v_stack, bm)
        bsize, n_pad = packed["bsize"], packed["n_pad"]
        dev = _device_structure(op, packed, use_bsr, device)

        x0_blocks = np.zeros((p, bsize, 1), dtype=np_dtype)
        for i in range(p):
            s, t = part.block(i)
            x0_blocks[i, : t - s, 0] = x0[s:t]

        init_comm, comm = spmd_exchange(
            self.exchange, p=p, bsize=bsize, n_pad=n_pad,
            sync_every=self.sync_every, sparsify_k=self.sparsify_k,
            sparsify_row_thresh=self.sparsify_thresh,
            sparsify_refresh_every=self.sparsify_refresh_every,
            sparsify_adaptive=self.sparsify_adaptive,
            # endgame guard at the drain target's scale: near-converged
            # delta mass ships full payloads so the persistence window
            # can settle
            sparsify_endgame_mass=target)

        pt_apply = _step.shard_pt_apply(
            dev["op_dev"], use_bsr=use_bsr, bsize=bsize, nv=1, n_pad=n_pad,
            bm=bm, impl=impl, accum=self.accum)
        local_update = _step.shard_local_update(
            pt_apply, alpha=alpha, linear=True, n=n,
            vb=torch.as_tensor(packed["vblk"], device=device),
            val=dev["valid"], dang=dev["dang"])
        superstep, cond = _step.shard_superstep_fns(
            local_update, comm, p=p, tol=target,
            pc_max_compute=self.pc_max_compute,
            pc_max_monitor=self.pc_max_monitor, seed=self.seed, q=1.0,
            freeze_lanes=False, max_steps=max_supersteps, conv="l1_psum")
        carry = _step.init_carry(torch.as_tensor(x0_blocks, device=device),
                                 init_comm, nv=1, n_pad=n_pad)
        while cond(carry):
            carry = superstep(carry)
        (view, frag, _, supersteps, _, _, lane_done, _, rows_sent,
         fulls) = carry
        # final device-visible delta L1 (telemetry only — a caller
        # certifies with a host-side exact residual)
        dl1 = float((local_update(view) - frag).abs().sum())

        frag_mat = frag.double().cpu().numpy()
        x = np.empty(n, dtype=np.float64)
        for i in range(p):
            s, t = part.block(i)
            x[s:t] = frag_mat[i, : t - s, 0]
        rows_total = int(rows_sent.sum())
        fulls_total = int(fulls.sum())
        comm_total = _step.comm_bytes_model(
            self.exchange, p=p, bsize=bsize, itemsize=np_dtype.itemsize,
            nv=1, steps=supersteps, rows=rows_total, fulls=fulls_total,
            sync_every=self.sync_every)
        return DeviceRunResult(
            x=x, supersteps=supersteps, rows_sent=rows_total,
            fulls=fulls_total, comm_bytes_total=comm_total,
            device_resid=dl1, converged=bool(lane_done.all()),
            p=p, schedule=self.exchange)
