"""Discrete-event simulation of asynchronous iterative computation (eq. 5),
the JAX package's core/des.py with its fragments on the run's device.

This is the *faithful* reproduction layer: per-UE clocks with heterogeneous
compute rates, a shared-medium network with per-message service times and
send-cancellation windows (the paper cancels send()/recv() threads that do
not complete in time, §6), the exact Fig. 1 termination protocol routed
through latency channels, and import accounting that reproduces the paper's
Table 2 (completed-imports percentages).

The substrate-independent pieces live in `repro_torch.runtime`: per-UE
state is a `runtime.ShardState` (owned fragment + versioned stale views),
the block update is a `runtime.LocalSolver` (`BlockLocalSolver` for
PageRank), message targeting is a `runtime.ExchangePlan` (all_to_all /
ring / adaptive plus the §6 `sparsified` residual-mass targeting), and
Fig. 1 is driven by a `runtime.TerminationDriver` in its message-passing
rendering. This engine owns what is DES-specific: the event queue, the
clock and shared-medium models, and the Table-2 accounting.

Where things live. The event heap, the clocks, the medium, the plans, the
protocol and the accounting are host logic, as in the JAX package; the
views, fragments and payloads are float64 tensors on the device, and every
block update is one P^T product there (the CSR kernel's float64 lane on
the card). The host reads back only what a decision needs: per "iter"
event the local norm and ||delta||_1 together (one read), the fragment's
|delta| only when a top-k payload is built, the owners' fragments at a
rank-stability assembly, and the final iterate. The random draws come
from one numpy Generator seeded with `cfg.seed`, in the JAX package's
order (lognormal per iteration, a permutation of targets, the jitter of
each accepted send), so equal decisions give equal counts and times.

Semantics map (paper -> here):
  UE i owns fragment x_{i}                -> Partition block i
  x_{j}(tau_j^i(t)) stale imports         -> ShardState.view + version table
  compute phase                           -> "iter" events, duration ~ rate_i
  send threads (may be canceled)          -> Channel.send with cancel_window
  CONVERGE/DIVERGE/STOP (Fig. 1)          -> ctrl messages through the medium
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.google import GoogleOperator
# submodule reference, not `from ..runtime.driver import TerminationDriver`:
# runtime.driver itself imports core.termination (which runs this package's
# __init__), so during an `import repro_torch.runtime` the class attribute
# does not exist yet — the module object in sys.modules always does
from ..runtime import driver as _runtime_driver
from ..runtime.exchange import make_plan
from ..runtime.local import BlockLocalSolver as PageRankBlockOperator
from ..runtime.local import LocalSolver as BlockOperator
from ..runtime.state import ShardState
from .partition import Partition

__all__ = ["AsyncDES", "DESConfig", "AsyncResult", "SyncResult",
           "BlockOperator", "PageRankBlockOperator"]


# --------------------------------------------------------------------------
# Config / result containers
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DESConfig:
    tol: float = 1e-6
    norm: str = "inf"                 # local-convergence norm: inf | l1 | l2
    max_iters: int = 100_000
    # --- clock model ---
    # Calibrated to the paper's testbed (900 MHz Pentium, Java/MTJ SpMV).
    # Back-solved from Table 1: async p=2 runs ~68 iters in ~90 s on a
    # 1.16M-nnz half-block => ~9e5 edge-ops/s; with the shared-medium
    # exchange model this also reproduces the sync column (4.1/7.5/9.2 s
    # per iteration at p=2/4/6).
    base_flops_rate: float = 9e5      # "useful edge-ops per second" per UE
    ue_speed: Optional[List[float]] = None  # relative speeds (len p)
    jitter_sigma: float = 0.1         # lognormal per-iteration jitter
    # --- network model (shared medium, paper used 10 Mbps Ethernet) ---
    bandwidth: float = 1.25e6         # bytes/s on the shared medium
    msg_latency: float = 2e-3         # per message propagation latency (s)
    bytes_per_entry: int = 8
    ctrl_bytes: int = 64
    cancel_window: Optional[float] = 1.0  # cancel sends not started in time
    # --- per-UE message-handling costs (on the compute thread) ---
    # The paper's Java system serializes fragments into send buffers and
    # deserializes imports on arrival; back-solved from Table 1 this adds
    # ~0.8 s/iter at p=4 on top of 0.64 s of SpMV. Modeled as per-byte costs.
    send_cost_per_byte: float = 2e-7   # ~5 MB/s serialize
    recv_cost_per_byte: float = 2e-7   # ~5 MB/s deserialize
    iter_overhead: float = 0.02        # thread-pool/GC per-iteration cost
    # --- protocol ---
    pc_max_compute: int = 1
    pc_max_monitor: int = 1
    # --- ranking-aware termination (beyond-paper; operationalizes the
    # paper's §5.2 open question). The monitor periodically assembles the
    # owner fragments and STOPs once the top-k ordering is stable —
    # typically far earlier than a value-accuracy threshold. The assembly
    # channel is modeled out-of-band.
    rank_stop_k: Optional[int] = None
    rank_stop_tau: float = 0.999
    rank_stop_interval: float = 5.0   # sim seconds between assemblies
    rank_stop_patience: int = 2
    # --- communication policy (runtime.ExchangePlan) ---
    comm_policy: str = "all_to_all"   # all_to_all | ring | adaptive
    #                                 # | sparsified (§6 mass targeting)
    adaptive_cancel_limit: int = 3    # consecutive cancels before backoff
    adaptive_max_backoff: int = 16
    sparsify_thresh: float = 0.0      # L1 mass gate; 0 = auto (= tol)
    sparsify_refresh_every: int = 8   # forced full send every k local iters
    sparsify_top_k: Union[int, str, None] = None
    #                                 # rows per mass-gated payload: an
    #                                 # int, None (full fragments), or
    #                                 # "adaptive" (k picked from the
    #                                 # observed row-delta distribution,
    #                                 # EWMA-smoothed per pair; forced
    #                                 # refreshes always ship in full)
    # --- barrier model for the synchronous run ---
    barrier_overhead: float = 5e-3
    # power-form PageRank converges up to scale and is renormalized on
    # assembly; generic operators must not be.
    normalize: bool = True
    seed: int = 0


@dataclasses.dataclass
class AsyncResult:
    p: int
    iters: np.ndarray                 # (p,) iterations executed at STOP
    local_conv_iter: np.ndarray       # (p,) iteration index of local conv.
    local_conv_time: np.ndarray       # (p,) sim time of local convergence
    stop_time: float                  # sim time STOP fully delivered
    imports: np.ndarray               # (p, p) delivered fragment counts
    attempts: np.ndarray              # (p, p) attempted sends
    completed_import_pct: np.ndarray  # (p,) row-average delivered/expected
    x: np.ndarray                     # assembled final iterate (normalized)
    global_resid_l1: float            # ||G x - x||_1 of the assembled vector
    global_resid_inf: float
    max_staleness: int                # max observed version lag (iterations)
    rank_stop_time: float = float("nan")  # when rank-stability fired


@dataclasses.dataclass
class SyncResult:
    p: int
    iters: int
    time: float
    x: np.ndarray
    global_resid_l1: float
    global_resid_inf: float


def _resid(delta: torch.Tensor, norm: str) -> torch.Tensor:
    """The local-convergence norm of a fragment's change, a 0-d tensor on
    delta's device (read by the caller with the other numbers it needs)."""
    if norm == "inf":
        return delta.abs().max()
    if norm == "l2":
        return torch.sqrt((delta * delta).sum())
    return delta.abs().sum()


# --------------------------------------------------------------------------
# The simulator
# --------------------------------------------------------------------------
class AsyncDES:
    """Asynchronous run of eq. (5) under the DESConfig models, with the
    views on `device` (None: the CUDA card)."""

    def __init__(self, operator: BlockOperator, part: Partition,
                 cfg: DESConfig, x0: Optional[np.ndarray] = None,
                 check_operator: Optional[GoogleOperator] = None,
                 device: DeviceLike = None):
        self.opr = operator
        self.part = part
        self.cfg = cfg
        self.p = part.p
        self.n = part.n
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        x0 = (np.full(self.n, 1.0 / self.n) if x0 is None
              else np.asarray(x0, dtype=np.float64))
        self.x0 = torch.as_tensor(x0, dtype=torch.float64,
                                  device=self.device)
        self.check_operator = check_operator

        speeds = cfg.ue_speed if cfg.ue_speed is not None else [1.0] * self.p
        if len(speeds) != self.p:
            raise ValueError(f"ue_speed has {len(speeds)} entries for "
                             f"{self.p} UEs")
        self._compute_time = [
            operator.block_work(i) / (cfg.base_flops_rate * speeds[i])
            for i in range(self.p)
        ]

    # -- clock / network models ------------------------------------------
    def _iter_duration(self, i: int) -> float:
        j = self.rng.lognormal(mean=0.0, sigma=self.cfg.jitter_sigma)
        return self._compute_time[i] * j

    def _frag_bytes(self, i: int) -> int:
        return int(self.part.sizes()[i]) * self.cfg.bytes_per_entry

    def _make_plan(self):
        cfg = self.cfg
        thresh = cfg.sparsify_thresh if cfg.sparsify_thresh > 0 else cfg.tol
        return make_plan(cfg.comm_policy, self.p,
                         cancel_limit=cfg.adaptive_cancel_limit,
                         max_backoff=cfg.adaptive_max_backoff,
                         thresh=thresh,
                         refresh_every=cfg.sparsify_refresh_every,
                         top_k=cfg.sparsify_top_k)

    def _residuals(self, x: np.ndarray):
        if self.check_operator is None:
            return np.nan, np.nan
        r = np.abs(self.check_operator.apply_numpy(x) - x)
        return float(r.sum()), float(r.max())

    # -- main loop ----------------------------------------------------------
    def run(self) -> AsyncResult:
        cfg, p, n = self.cfg, self.p, self.n
        part = self.part
        dev = self.device

        # runtime substrate: per-UE shard state, exchange plan, Fig. 1 driver
        shards = [ShardState.create(i, part, self.x0) for i in range(p)]
        plan = self._make_plan()
        # only a top-k payload reads the rows' |delta| on the host
        rows_payloads = getattr(plan, "top_k", None) is not None
        driver = _runtime_driver.TerminationDriver(
            p, pc_max_compute=cfg.pc_max_compute,
            pc_max_monitor=cfg.pc_max_monitor)

        iters = np.zeros(p, dtype=np.int64)
        local_conv_iter = np.full(p, -1, dtype=np.int64)
        local_conv_time = np.full(p, np.inf)
        imports = np.zeros((p, p), dtype=np.int64)
        attempts = np.zeros((p, p), dtype=np.int64)
        max_staleness = 0
        # unsent residual mass per (src, dst) pair (sparsified targeting);
        # an upper bound on ||frag_now - frag_last_sent||_1 by triangle ineq.
        pending_mass = np.zeros((p, p), dtype=np.float64)

        # message-handling time accrued on each UE's compute thread since its
        # last iteration (serialize on send, deserialize on import)
        handling = np.zeros(p, dtype=np.float64)

        medium_free = 0.0  # shared-medium FIFO
        events: list = []  # (time, seq, kind, payload)
        seq = 0

        def push(t, kind, payload):
            nonlocal seq
            heapq.heappush(events, (t, seq, kind, payload))
            seq += 1

        def send(t, src, dst, kind, payload, nbytes):
            """Route a message through the shared medium. Returns True if
            the send was accepted (not canceled)."""
            nonlocal medium_free
            start = max(t, medium_free)
            if (cfg.cancel_window is not None
                    and kind == "data"
                    and start - t > cfg.cancel_window):
                return False  # canceled: queueing delay exceeded the window
            medium_free = start + nbytes / cfg.bandwidth
            # small random propagation jitter decorrelates arrival order
            jit = cfg.msg_latency * (1.0 + self.rng.random())
            push(medium_free + jit, kind, (src, dst, payload))
            return True

        # bootstrap: all UEs start computing at t=0
        for i in range(p):
            push(self._iter_duration(i), "iter", i)

        stop_time = np.inf
        pending_stop_sent = False

        # ranking-aware termination state
        last_asm = None
        rank_stable = 0
        rank_stop_time = np.nan
        if cfg.rank_stop_k:
            push(cfg.rank_stop_interval, "assemble", None)

        def assemble_now() -> np.ndarray:
            xa = torch.empty(n, dtype=torch.float64, device=dev)
            for j in range(p):
                sj, ej = part.block(j)
                xa[sj:ej] = shards[j].view[sj:ej]
            return xa.cpu().numpy()

        while events:
            t, _, kind, payload = heapq.heappop(events)

            if kind == "iter":
                i = payload
                sh = shards[i]
                if sh.stopped:
                    continue
                s, e = part.block(i)
                new_frag = self.opr.update_block(i, sh.view)
                delta = new_frag - sh.fragment()
                version = sh.publish(new_frag)
                iters[i] = sh.iters
                delta_abs = delta.abs()
                # one read: the local norm and ||delta||_1
                resid, mass = torch.stack(
                    [_resid(delta, cfg.norm), delta_abs.sum()]).tolist()
                pending_mass[i, :] += mass
                delta_host = None

                locally_conv = resid < cfg.tol
                if locally_conv and local_conv_iter[i] < 0:
                    local_conv_iter[i] = iters[i]
                    local_conv_time[i] = t
                elif not locally_conv:
                    local_conv_iter[i] = -1
                    local_conv_time[i] = np.inf

                # Fig. 1 computing-UE machine (message rendering)
                msg = driver.ue_step(i, locally_conv)
                if msg is not None:
                    send(t, i, -1, "ctrl", msg, cfg.ctrl_bytes)

                # data sends to peers (random target order per iteration —
                # a fixed order lets low-id receivers capture the medium)
                targets = self.rng.permutation(p)
                for d in targets:
                    d = int(d)
                    if d == i:
                        continue
                    if not plan.wants(i, d, iters[i]):
                        continue
                    if not plan.gate_mass(i, d, iters[i],
                                          pending_mass[i, d]):
                        continue
                    attempts[i, d] += 1
                    # mass-gated sparsified sends ship only the top-k rows
                    # by this iteration's |delta| ((idx, value) pairs);
                    # forced refreshes — the bounded-delay guarantee —
                    # always ship the full fragment
                    rows_l = None
                    if rows_payloads and not plan.refresh_due(i, d,
                                                              iters[i]):
                        if delta_host is None:
                            delta_host = delta_abs.cpu().numpy()
                        rows_l = plan.payload_rows(delta_host, i, d)
                    if rows_l is None:
                        nbytes = self._frag_bytes(i)
                        # new_frag is never written again: payloads share it
                        payload = ("full", new_frag, version, s, e, i)
                    else:
                        nbytes = int(rows_l.size) * (cfg.bytes_per_entry + 4)
                        idx = torch.as_tensor(rows_l, device=dev)
                        payload = ("rows", idx + s, new_frag[idx], version,
                                   i)
                    # serialize cost is paid whether or not the send later
                    # cancels (the buffer is built before the pool submit)
                    handling[i] += nbytes * cfg.send_cost_per_byte
                    ok = send(t, i, d, "data", payload, nbytes)
                    plan.on_result(i, d, ok)
                    if ok:
                        plan.note_sent(i, d, iters[i], full=rows_l is None)
                        if rows_l is None:
                            pending_mass[i, d] = 0.0
                        else:
                            # only the shipped rows' mass was communicated
                            pending_mass[i, d] = max(
                                0.0, pending_mass[i, d]
                                - float(delta_host[rows_l].sum()))

                if iters[i] < cfg.max_iters:
                    dur = (self._iter_duration(i) + cfg.iter_overhead
                           + handling[i])
                    handling[i] = 0.0
                    push(t + dur, "iter", i)

            elif kind == "data":
                # version bookkeeping is keyed by the fragment OWNER (ring
                # relays deliver fragments the message sender does not own)
                src, dst, body = payload
                sh = shards[dst]
                if sh.stopped:
                    continue
                if body[0] == "rows":
                    # sparsified partial payload: refresh only the shipped
                    # rows (the plan's forced full refresh bounds how long
                    # the others stay stale)
                    _, rows_g, vals, version, owner = body
                    if sh.import_rows(owner, rows_g, vals, version):
                        lag = int(shards[owner].produced - version)
                        max_staleness = max(max_staleness, lag)
                        imports[dst, owner] += 1
                        handling[dst] += rows_g.numel() \
                            * (cfg.bytes_per_entry + 4) \
                            * cfg.recv_cost_per_byte
                    continue
                _, frag, version, s, e, owner = body
                if sh.import_fragment(owner, frag, version, s, e):
                    lag = int(shards[owner].produced - version)
                    max_staleness = max(max_staleness, lag)
                    imports[dst, owner] += 1
                    handling[dst] += (e - s) * cfg.bytes_per_entry \
                        * cfg.recv_cost_per_byte
                    # Ring relay: a freshly-accepted fragment is forwarded one
                    # hop, so each version circulates the ring once (<= p-1
                    # hops) and staleness stays O(p) without all-to-all sends.
                    if plan.name == "ring":
                        nxt = (dst + 1) % p
                        if nxt != owner:
                            send(t, dst, nxt, "data",
                                 ("full", frag, version, s, e, owner),
                                 self._frag_bytes(owner))

            elif kind == "assemble":
                xa = assemble_now()
                if last_asm is not None:
                    k = cfg.rank_stop_k
                    top_new = np.argsort(-xa)[:k]
                    top_old = np.argsort(-last_asm)[:k]
                    union = np.union1d(top_new, top_old)
                    import scipy.stats as _st
                    tau, _ = _st.kendalltau(xa[union], last_asm[union])
                    if np.isfinite(tau) and tau >= cfg.rank_stop_tau:
                        rank_stable += 1
                    else:
                        rank_stable = 0
                    if (rank_stable >= cfg.rank_stop_patience
                            and not pending_stop_sent):
                        pending_stop_sent = True
                        rank_stop_time = t
                        for d in range(p):
                            send(t, -1, d, "stop", None, cfg.ctrl_bytes)
                last_asm = xa
                if not pending_stop_sent:
                    push(t + cfg.rank_stop_interval, "assemble", None)

            elif kind == "ctrl":
                src, _, msg = payload
                issue_stop = driver.monitor_recv(src, msg)
                if issue_stop and not pending_stop_sent:
                    pending_stop_sent = True
                    for d in range(p):
                        send(t, -1, d, "stop", None, cfg.ctrl_bytes)

            elif kind == "stop":
                _, d, _ = payload
                shards[d].stopped = True
                driver.stop_shard(d)
                if all(sh.stopped for sh in shards):
                    stop_time = t
                    break

        # assemble the final vector from each owner's freshest fragment
        x = assemble_now()
        norm1 = x.sum()
        if self.cfg.normalize and norm1 > 0:
            x_assembled = x / norm1  # power form converges up to scale [21]
        else:
            x_assembled = x
        resid_l1, resid_inf = self._residuals(x_assembled)

        # UEs that were mid-divergence when STOP arrived (the race the
        # persistence counters mitigate): credit them with the stop time.
        final_stop = float(stop_time if np.isfinite(stop_time)
                           else local_conv_time[np.isfinite(local_conv_time)].max()
                           if np.isfinite(local_conv_time).any() else 0.0)
        local_conv_time = np.where(np.isfinite(local_conv_time),
                                   local_conv_time, final_stop)
        local_conv_iter = np.where(local_conv_iter >= 0, local_conv_iter,
                                   iters)

        expected = np.maximum(iters[None, :].repeat(p, 0), 1)  # sender iters
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = imports / expected
        off_diag = ~np.eye(p, dtype=bool)
        completed_pct = np.array([
            100.0 * pct[r][off_diag[r]].mean() for r in range(p)
        ])

        return AsyncResult(
            p=p, iters=iters, local_conv_iter=local_conv_iter,
            local_conv_time=local_conv_time,
            stop_time=float(stop_time if np.isfinite(stop_time) else
                            local_conv_time.max()),
            imports=imports, attempts=attempts,
            completed_import_pct=completed_pct,
            x=x_assembled, global_resid_l1=resid_l1,
            global_resid_inf=resid_inf, max_staleness=max_staleness,
            rank_stop_time=float(rank_stop_time),
        )

    # -- synchronous baseline ------------------------------------------------
    def run_sync(self) -> SyncResult:
        """Barrier-synchronous run under the same clock/network models.

        Per iteration: all UEs compute (barrier waits for the slowest), then
        the all-to-all fragment exchange is serialized over the shared
        medium (p*(p-1) messages), plus a barrier overhead. The host reads
        the iteration's norm once.
        """
        cfg, p = self.cfg, self.p
        part = self.part
        x = self.x0.clone()
        t = 0.0
        total_bytes = sum(self._frag_bytes(i) for i in range(p)) * (p - 1)
        exchange = total_bytes / cfg.bandwidth + 2 * cfg.msg_latency

        # per-iteration serialize/deserialize on the slowest UE
        handling = max(
            (p - 1) * self._frag_bytes(i) * cfg.send_cost_per_byte
            + sum(self._frag_bytes(j) for j in range(p) if j != i)
            * cfg.recv_cost_per_byte
            for i in range(p))

        iters = 0
        while iters < cfg.max_iters:
            compute = max(self._iter_duration(i) for i in range(p))
            y = torch.empty_like(x)
            for i in range(p):
                s, e = part.block(i)
                y[s:e] = self.opr.update_block(i, x)
            iters += 1
            t += compute + exchange + handling + cfg.barrier_overhead
            conv = float(_resid(y - x, cfg.norm)) < cfg.tol
            x = y
            if conv:
                break

        x = x.cpu().numpy()
        norm1 = x.sum()
        x_out = x / norm1 if (self.cfg.normalize and norm1 > 0) else x
        resid_l1, resid_inf = self._residuals(x_out)
        return SyncResult(p=p, iters=iters, time=t, x=x_out,
                          global_resid_l1=resid_l1, global_resid_inf=resid_inf)
