"""Termination detection (paper §4.2, Figure 1).

Centralized protocol. Computing UEs run the left-column state machine and
emit edge-triggered CONVERGE / DIVERGE messages to a monitor UE, which runs
the right-column machine and broadcasts STOP once *persistent* global
convergence is observed. Persistence counters (pc, pcMax) on both sides give
in-flight messages time to arrive and destroy premature convergence.

The state machines below are pure functions over immutable dataclasses so
they can be unit- and property-tested in isolation, then driven by either
the DES event loop (message semantics) or the SPMD in-loop variant
(all-reduced convergence bits stand in for the messages).

Pure Python: the JAX package's core/termination.py, copied so that the port
imports nothing of it.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class Msg(enum.Enum):
    CONVERGE = 1
    DIVERGE = 2
    STOP = 3


@dataclasses.dataclass(frozen=True)
class ComputingUEState:
    """Left column of Fig. 1."""
    converged: bool = False
    pc: int = 0
    pc_max: int = 1
    stopped: bool = False

    def step(self, locally_converged: bool) -> Tuple["ComputingUEState", Optional[Msg]]:
        """One checkConvergence() evaluation after a local iteration.

        Returns (new state, message to send to monitor or None).

        Mirrors Fig. 1:
            if checkConvergence():
                if not converged: converged = True
                pc += 1
                if pc == pcMax: send(CONVERGE, monitor)
            else:
                if converged:
                    converged = False; send(DIVERGE, monitor); pc = 0
        """
        if self.stopped:
            return self, None
        if locally_converged:
            pc = self.pc + 1
            msg = Msg.CONVERGE if pc == self.pc_max else None
            return dataclasses.replace(self, converged=True, pc=pc), msg
        else:
            if self.converged:
                return dataclasses.replace(self, converged=False, pc=0), Msg.DIVERGE
            return dataclasses.replace(self, pc=0), None

    def stop(self) -> "ComputingUEState":
        return dataclasses.replace(self, stopped=True)


@dataclasses.dataclass(frozen=True)
class MonitorState:
    """Right column of Fig. 1. Tracks per-UE convergence flags; its own
    checkConvergence() is `all(flags)` with its own persistence counter."""
    flags: Tuple[bool, ...]
    converged: bool = False
    pc: int = 0
    pc_max: int = 1
    stop_issued: bool = False

    @staticmethod
    def create(p: int, pc_max: int = 1) -> "MonitorState":
        return MonitorState(flags=tuple([False] * p), pc_max=pc_max)

    def recv(self, ue: int, msg: Msg) -> "MonitorState":
        flags = list(self.flags)
        if msg == Msg.CONVERGE:
            flags[ue] = True
        elif msg == Msg.DIVERGE:
            flags[ue] = False
        return dataclasses.replace(self, flags=tuple(flags))

    def step(self) -> Tuple["MonitorState", bool]:
        """Evaluate monitor-side checkConvergence(); returns
        (new state, issue_stop)."""
        if self.stop_issued:
            return self, False
        if all(self.flags):
            pc = self.pc + 1
            if pc == self.pc_max:
                return dataclasses.replace(self, converged=True, pc=pc,
                                           stop_issued=True), True
            return dataclasses.replace(self, converged=True, pc=pc), False
        else:
            if self.converged:
                return dataclasses.replace(self, converged=False, pc=0), False
            return dataclasses.replace(self, pc=0), False


@dataclasses.dataclass
class CentralizedProtocol:
    """Convenience wrapper wiring p computing-UE machines to one monitor,
    with *immediate* message delivery. The DES engine instead routes the
    emitted messages through latency channels (the realistic case)."""

    p: int
    pc_max_compute: int = 1
    pc_max_monitor: int = 1

    def __post_init__(self):
        self.ues: List[ComputingUEState] = [
            ComputingUEState(pc_max=self.pc_max_compute) for _ in range(self.p)]
        self.monitor = MonitorState.create(self.p, pc_max=self.pc_max_monitor)
        self.stopped = False

    def report(self, ue: int, locally_converged: bool) -> bool:
        """UE `ue` finished an iteration; returns True iff STOP was issued."""
        if self.stopped:
            return True
        new_state, msg = self.ues[ue].step(locally_converged)
        self.ues[ue] = new_state
        if msg is not None:
            self.monitor = self.monitor.recv(ue, msg)
            self.monitor, issue_stop = self.monitor.step()
            if issue_stop:
                self.stopped = True
                self.ues = [s.stop() for s in self.ues]
                return True
        return False


# ---------------------------------------------------------------------------
# Decentralized (tree) termination detection — the paper's §4.2 alternative
# ("distributed protocols ... typically assume a specific underlying
# communication topology", e.g. the tree/leader-election scheme of [6]).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TreeNodeState:
    """One UE in a binary-tree overlay. A node reports SUBTREE_CONVERGED to
    its parent once its own persistent flag and both children's reports are
    true; any local divergence (or a child's DIVERGE) retracts the report
    immediately. The root issues STOP, propagated down the tree."""
    ue: ComputingUEState
    child_ok: Tuple[bool, ...]          # one slot per child
    reported: bool = False              # last report sent upward

    @staticmethod
    def create(n_children: int, pc_max: int = 1) -> "TreeNodeState":
        return TreeNodeState(ue=ComputingUEState(pc_max=pc_max),
                             child_ok=tuple([False] * n_children))

    @property
    def subtree_ok(self) -> bool:
        return self.ue.converged and self.ue.pc >= self.ue.pc_max \
            and all(self.child_ok)

    def on_local_check(self, locally_converged: bool):
        """Returns (state, report) with report in {None, True, False}:
        True = send SUBTREE_CONVERGED up, False = send DIVERGE up."""
        new_ue, _ = self.ue.step(locally_converged)
        st = dataclasses.replace(self, ue=new_ue)
        return st._maybe_report()

    def on_child_report(self, child: int, ok: bool):
        ch = list(self.child_ok)
        ch[child] = ok
        st = dataclasses.replace(self, child_ok=tuple(ch))
        return st._maybe_report()

    def _maybe_report(self):
        ok = self.subtree_ok
        if ok and not self.reported:
            return dataclasses.replace(self, reported=True), True
        if not ok and self.reported:
            return dataclasses.replace(self, reported=False), False
        return self, None


class TreeProtocol:
    """p UEs on a binary tree (node i's children: 2i+1, 2i+2). Immediate
    message delivery; the DES engine can route the reports through its
    latency channels the same way it does for the centralized protocol."""

    def __init__(self, p: int, pc_max: int = 1):
        self.p = p
        kids = lambda i: [c for c in (2 * i + 1, 2 * i + 2) if c < p]
        self.children = {i: kids(i) for i in range(p)}
        self.parent = {c: i for i in range(p) for c in self.children[i]}
        self.nodes = {i: TreeNodeState.create(len(self.children[i]),
                                              pc_max=pc_max)
                      for i in range(p)}
        self.stopped = False

    def _route_up(self, i: int, report) -> bool:
        """Propagate a report from node i toward the root; True if the
        root observes full-tree convergence (STOP)."""
        while report is not None:
            if i == 0:
                return report is True and self.nodes[0].subtree_ok
            par = self.parent[i]
            slot = self.children[par].index(i)
            self.nodes[par], report = \
                self.nodes[par].on_child_report(slot, report is True)
            i = par
        return False

    def report(self, ue: int, locally_converged: bool) -> bool:
        if self.stopped:
            return True
        self.nodes[ue], rep = self.nodes[ue].on_local_check(locally_converged)
        if self._route_up(ue, rep):
            self.stopped = True
        return self.stopped
