"""TerminationDriver — the Fig. 1 protocol over every transport rendering.

The protocol itself lives in `core.termination` as pure state machines
(ComputingUEState / MonitorState).  This driver owns p computing-shard
machines plus the monitor and exposes three renderings:

  message-passing (DES)     : `ue_step` returns the edge-triggered
                              CONVERGE/DIVERGE message for the caller to
                              route through its latency channels;
                              `monitor_recv` ingests it at delivery time.
  all-reduced value         : `allreduce_step` takes per-shard scalars
  (sharded streaming)         (e.g. ||r_i||_1), forms the global sum — the
                              all-reduce — and runs every shard machine
                              against the shared verdict in one superstep.
  all-reduced bits (SPMD)   : `bits_step` is the tensor rendering
                              (persistence counters over all-reduced
                              convergence bits) that the shard program runs
                              every superstep; pass `psum` as
                              `transport.mesh_psum()` (a sum over the
                              leading shard axis) or `lambda a: a.sum()`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.termination import ComputingUEState, MonitorState, Msg


class TerminationDriver:
    """p computing-shard Fig. 1 machines + one monitor."""

    def __init__(self, p: int, pc_max_compute: int = 1,
                 pc_max_monitor: int = 1):
        self.p = p
        self.pc_max_compute = pc_max_compute
        self.pc_max_monitor = pc_max_monitor
        self.ues: List[ComputingUEState] = [
            ComputingUEState(pc_max=pc_max_compute) for _ in range(p)]
        self.monitor = MonitorState.create(p, pc_max=pc_max_monitor)
        self.stopped = False

    # -- message-passing rendering (DES) --------------------------------
    def ue_step(self, i: int, locally_converged: bool) -> Optional[Msg]:
        """One checkConvergence() on shard i; returns the CONVERGE/DIVERGE
        message to route to the monitor (None if no edge fired)."""
        self.ues[i], msg = self.ues[i].step(locally_converged)
        return msg

    def monitor_recv(self, src: int, msg: Msg) -> bool:
        """Deliver a routed message to the monitor; True iff STOP fires."""
        self.monitor = self.monitor.recv(src, msg)
        self.monitor, issue_stop = self.monitor.step()
        if issue_stop:
            self.stopped = True
        return issue_stop

    def stop_shard(self, i: int) -> None:
        self.ues[i] = self.ues[i].stop()

    def restart_shard(self, i: int) -> None:
        """Conservative Fig. 1 re-entry for a recovered shard worker: a
        fresh computing machine plus a DIVERGE delivered on its behalf,
        so a stale CONVERGE flag from the dead incarnation can never ride
        into STOP while the shard re-derives its value.  (DIVERGE clears
        the monitor's flag and resets its persistence counter; the
        follow-up step can therefore never issue STOP.)"""
        self.ues[i] = ComputingUEState(pc_max=self.pc_max_compute)
        self.monitor = self.monitor.recv(i, Msg.DIVERGE)
        self.monitor, _ = self.monitor.step()

    # -- all-reduced value rendering (sharded streaming) -----------------
    def allreduce_step(self, values, target: float) -> Tuple[float, bool]:
        """One superstep of the value rendering: all-reduce the per-shard
        scalars, evaluate the shared convergence verdict (sum <= target) on
        every shard machine, deliver the emitted messages to the monitor
        immediately (the all-reduce IS the channel), and report whether the
        monitor issued STOP.  Persistence counters on both sides still gate
        the stop, so mass still in flight between shards (counted in its
        sender's value) gets time to land and retract convergence."""
        values = np.asarray(values, dtype=np.float64)
        if values.shape != (self.p,):
            raise ValueError(f"expected {self.p} per-shard values, got "
                             f"shape {values.shape}")
        total = float(values.sum())          # the all-reduce
        verdict = total <= target
        for i in range(self.p):
            msg = self.ue_step(i, verdict)
            if msg is not None:
                self.monitor = self.monitor.recv(i, msg)
        # unlike the message rendering (where the monitor evaluates on
        # every arrival), the monitor rides the all-reduce: its persistence
        # counter advances once per superstep while all flags hold — the
        # same cadence as the SPMD bit rendering's mon_pc
        self.monitor, issue_stop = self.monitor.step()
        if issue_stop:
            self.stopped = True
        return total, issue_stop

    # -- all-reduced bit rendering (SPMD, tensors) -----------------------
    @staticmethod
    def bits_step(locally_conv, pc, mon_pc, *, p: int, pc_max_compute: int,
                  pc_max_monitor: int, psum: Callable):
        """Pure-function rendering of one Fig. 1 superstep over all-reduced
        convergence bits, on tensors (numpy arrays and Python scalars are
        taken as tensors).  Shapes broadcast, so `locally_conv`/`pc`/
        `mon_pc` may be scalars, (nv,) lanes or (p, nv) shards by lanes.
        `psum` must reduce across shards and give every shard the total
        (`transport.mesh_psum()` on a leading shard axis; a plain sum when
        the caller holds one shard's bits).  Counters are int32, as in the
        JAX package's loop carry."""
        locally_conv = torch.as_tensor(locally_conv, dtype=torch.bool)
        pc = torch.as_tensor(pc, dtype=torch.int32,
                             device=locally_conv.device)
        mon_pc = torch.as_tensor(mon_pc, dtype=torch.int32,
                                 device=locally_conv.device)
        pc = torch.where(locally_conv, pc + 1, torch.zeros_like(pc))
        flag = pc >= pc_max_compute
        nconv = psum(flag.to(torch.int32))
        all_conv = nconv == p
        mon_pc = torch.where(all_conv, mon_pc + 1, torch.zeros_like(mon_pc))
        done = mon_pc >= pc_max_monitor
        return pc, mon_pc, done
