"""Dynamic web graphs: batched edge/node deltas over a frozen CSR base
(the JAX package's streaming/delta.py, copied: the log, the splice and the
memos are numpy on the host, so the port's graphs and transitions equal the
reference's bit for bit).

The paper's premise (§1, §6) is that the Web graph is too large and too
alive for synchronized recomputation.  Every solver in this repo consumes an
immutable `CSRGraph`; this module supplies the evolving-graph layer above
it:

  * `EdgeDelta`     — one batch of edge insertions/deletions plus node
                      arrivals (COO arrays, the unit of the crawl stream);
  * `DeltaGraph`    — a `CSRGraph` base plus a COO overlay log of pending
                      deltas.  Out-degrees and the dangling mask are
                      maintained incrementally (O(touched) per batch, never
                      an O(n) recompute), neighbor queries merge the base
                      row with the overlay, and the log is periodically
                      compacted back into a fresh CSR base;
  * `FrozenGraphView` — an immutable point-in-time view (base ref + overlay
                      copy) that query threads can hold while the updater
                      keeps mutating the live graph.

Operator-view consistency and precise cache invalidation
--------------------------------------------------------
`DeltaGraph.operator()` materializes a `GoogleOperator` for the *current*
version and memoizes everything per version:

  * the CSR snapshot, `TransitionT`, and scipy P^T are built at most once
    per version and shared by every view of that version — so repeated
    fallback solves at one version reuse the operator's device/BSR caches
    instead of re-packing (the caches are invalidated when the graph
    actually changes, not wholesale on every call);
  * views that differ only in alpha or teleport share the *same*
    `TransitionT` instance, so its device edge arrays (memoized on the
    transition itself) carry across — a teleport change never invalidates
    edge state;
  * `compact()` folds the overlay into the base without bumping the
    version: the graph value is unchanged, so every memoized snapshot,
    transition and operator cache survives compaction untouched.

Device memory.  A version's tensors live on its memos: `TransitionT.
device_arrays` (the segment-sum edge arrays) on the transition, the
hub-split block layout and its upload on the uniform-teleport operator
(`GoogleOperator._cache`).  `_gc_views` drops the memos of versions older
than the last two, and their device tensors go with them; only a caller
that still holds such an operator (a `RankSnapshot` cut with
`snapshot_ops`) keeps its tensors alive.

Within one `EdgeDelta`, deletions are applied before insertions (an edge
both deleted and inserted in the same batch ends up present).
`merge_deltas` preserves those semantics across a queue of batches by
keeping only the last operation per (src, dst) pair.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..graph.csr import CSRGraph, TransitionT
from ..graph.google import GoogleOperator


def _splice_transition(prev: TransitionT, rcpt: "DeltaReceipt",
                       out_deg: np.ndarray,
                       dangling: np.ndarray) -> TransitionT:
    """Patch P^T from version v-1 to v by row-splicing only the entries of
    touched sources, instead of the O(nnz log nnz) full rebuild.

    P^T is CSR over destinations with sources ascending within each row
    (the canonical order `TransitionT.from_graph` produces).  A source u
    whose out-row changed contributes three edit sets: entries to delete
    ((j, u) for j removed from u's row), entries to insert (j added, weight
    1/new_deg), and surviving entries whose weight must refresh to
    1/new_deg.  All three are O(touched) against the previous arrays —
    membership tests via (row, src) keys, insertion points via one merge
    `searchsorted` on the kept keys — so the whole patch is O(nnz) copies
    with no sort over the full edge list.
    """
    n_new = rcpt.n_new
    indptr = prev.indptr
    if n_new > prev.n:
        indptr = np.concatenate(
            [indptr, np.full(n_new - prev.n, indptr[-1], dtype=np.int64)])

    add_r, add_s, del_r, del_s = [], [], [], []
    for u, row0, row1 in zip(rcpt.touched, rcpt.old_rows, rcpt.new_rows):
        adds = np.setdiff1d(row1, row0, assume_unique=True)
        dels = np.setdiff1d(row0, row1, assume_unique=True)
        add_r.append(adds)
        add_s.append(np.full(adds.size, u, dtype=np.int64))
        del_r.append(dels)
        del_s.append(np.full(dels.size, u, dtype=np.int64))
    add_r = np.concatenate(add_r) if add_r else np.empty(0, np.int64)
    add_s = np.concatenate(add_s) if add_s else np.empty(0, np.int64)
    del_r = np.concatenate(del_r) if del_r else np.empty(0, np.int64)
    del_s = np.concatenate(del_s) if del_s else np.empty(0, np.int64)

    keys = prev.row_ids.astype(np.int64) * n_new + prev.src.astype(np.int64)
    keep = np.ones(prev.nnz, dtype=bool)
    if del_r.size:
        keep &= ~np.isin(keys, del_r * n_new + del_s)
    src_k = prev.src[keep]
    row_k = prev.row_ids[keep]
    w_k = np.asarray(prev.weight[keep], dtype=np.float64).copy()
    # surviving entries of touched sources: refresh to 1/new_deg
    upd = np.isin(src_k, rcpt.touched)
    if upd.any():
        w_k[upd] = 1.0 / out_deg[src_k[upd].astype(np.int64)]

    if add_r.size:
        ins_keys = add_r * n_new + add_s
        order = np.argsort(ins_keys, kind="stable")   # O(touched) only
        ins_keys = ins_keys[order]
        add_r, add_s = add_r[order], add_s[order]
        pos = np.searchsorted(keys[keep], ins_keys)
        src_f = np.insert(src_k, pos, add_s.astype(np.int32))
        row_f = np.insert(row_k, pos, add_r.astype(np.int32))
        w_f = np.insert(w_k, pos, 1.0 / out_deg[add_s])
    else:
        src_f, row_f, w_f = src_k, row_k, w_k

    delta_cnt = (np.bincount(add_r, minlength=n_new)
                 - np.bincount(del_r, minlength=n_new))
    indptr_f = indptr + np.concatenate(
        [[0], np.cumsum(delta_cnt, dtype=np.int64)])
    return TransitionT(n=n_new, indptr=indptr_f, src=src_f, weight=w_f,
                       row_ids=row_f, dangling=dangling)


def _as_ids(a) -> np.ndarray:
    arr = np.asarray(a, dtype=np.int64).ravel()
    if arr.size and arr.min() < 0:
        raise ValueError("negative node id in delta")
    return arr


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """One batch of graph mutations in COO form.

    `new_nodes` appends that many fresh ids to the id space *before* the
    edge arrays are applied, so edges may reference the arriving nodes.
    """

    add_src: np.ndarray
    add_dst: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray
    new_nodes: int = 0

    @staticmethod
    def empty(new_nodes: int = 0) -> "EdgeDelta":
        z = np.empty(0, dtype=np.int64)
        return EdgeDelta(z, z, z, z, new_nodes=new_nodes)

    @staticmethod
    def inserts(src, dst, new_nodes: int = 0) -> "EdgeDelta":
        z = np.empty(0, dtype=np.int64)
        return EdgeDelta(_as_ids(src), _as_ids(dst), z, z,
                         new_nodes=new_nodes)

    @staticmethod
    def deletes(src, dst) -> "EdgeDelta":
        z = np.empty(0, dtype=np.int64)
        return EdgeDelta(z, z, _as_ids(src), _as_ids(dst))

    @property
    def size(self) -> int:
        return int(self.add_src.size + self.del_src.size)

    def __post_init__(self):
        if self.add_src.size != self.add_dst.size:
            raise ValueError("add_src/add_dst length mismatch")
        if self.del_src.size != self.del_dst.size:
            raise ValueError("del_src/del_dst length mismatch")
        if self.new_nodes < 0:
            raise ValueError("new_nodes must be >= 0")


def merge_deltas(deltas: Sequence[EdgeDelta]) -> EdgeDelta:
    """Collapse a queue of batches into one equivalent batch.

    Sequential semantics are preserved by keeping, per (src, dst) pair, only
    the *last* operation in the flattened [del_0, add_0, del_1, add_1, ...]
    sequence (within each batch deletions precede insertions).
    """
    deltas = list(deltas)
    if not deltas:
        return EdgeDelta.empty()
    if len(deltas) == 1:
        return deltas[0]
    srcs, dsts, ops = [], [], []  # op 0 = delete, 1 = insert
    for d in deltas:
        srcs += [d.del_src, d.add_src]
        dsts += [d.del_dst, d.add_dst]
        ops += [np.zeros(d.del_src.size, np.int8),
                np.ones(d.add_src.size, np.int8)]
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    op = np.concatenate(ops)
    n_hint = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    key = src * max(n_hint, 1) + dst
    # stable sort by key; the last occurrence within each key group wins
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    last = np.ones(key_s.size, dtype=bool)
    last[:-1] = key_s[:-1] != key_s[1:]
    pick = order[last]
    keep_op = op[pick]
    return EdgeDelta(
        add_src=src[pick][keep_op == 1], add_dst=dst[pick][keep_op == 1],
        del_src=src[pick][keep_op == 0], del_dst=dst[pick][keep_op == 0],
        new_nodes=int(sum(d.new_nodes for d in deltas)),
    )


@dataclasses.dataclass(frozen=True)
class DeltaReceipt:
    """What one `DeltaGraph.apply()` actually changed — the exact inputs the
    incremental solver needs to seed residuals (old vs new out-rows of every
    source whose transition column changed)."""

    version: int                 # graph version AFTER the apply
    n_old: int
    n_new: int
    touched: np.ndarray          # (t,) sources whose out-row changed
    old_deg: np.ndarray          # (t,) out-degree before
    new_deg: np.ndarray          # (t,) out-degree after
    old_rows: Tuple[np.ndarray, ...]   # out-neighbors before, per touched
    new_rows: Tuple[np.ndarray, ...]   # out-neighbors after, per touched
    n_added: int                 # effective insertions (no-ops excluded)
    n_deleted: int               # effective deletions (no-ops excluded)

    @property
    def dangling_changed(self) -> bool:
        return bool(np.any((self.old_deg == 0) != (self.new_deg == 0))) \
            or self.n_new != self.n_old


class DeltaGraph:
    """A `CSRGraph` plus a COO overlay of pending edge mutations.

    The overlay is a per-source pair of sets (`_add`, `_del`) kept disjoint
    from each other and consistent with the base row:

        row(u) = (base_row(u) \\ _del[u]) ∪ _add[u]

    `apply()` routes each mutation to the right set (re-inserting an
    overlay-deleted edge just clears the tombstone, deleting an
    overlay-added edge just drops it), so no-op mutations never inflate the
    log.  Once the log exceeds ``compact_frac`` of the base nnz the overlay
    is folded into a fresh CSR base (`compact()`), which preserves the
    version and therefore every per-version memoized operator view.
    """

    def __init__(self, base: CSRGraph, compact_frac: float = 0.25):
        self._base = base
        self.n = base.n
        self.compact_frac = float(compact_frac)
        self._add: Dict[int, set] = {}
        self._del: Dict[int, set] = {}
        self._out_deg = base.out_degree.copy()
        self._log_edges = 0
        self.version = 0
        self._last_receipt: Optional[DeltaReceipt] = None
        # per-version memoized views: version -> object
        self._snap: Dict[int, CSRGraph] = {0: base}
        self._pt: Dict[int, TransitionT] = {}
        self._pt_sp: Dict[int, object] = {}
        self._ops: Dict[Tuple[int, float], GoogleOperator] = {}

    # ------------------------------------------------------------------
    # graph-shaped read API
    # ------------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self._out_deg.sum())

    @property
    def out_degree(self) -> np.ndarray:
        """Incrementally-maintained out-degrees (view; do not mutate)."""
        return self._out_deg

    @property
    def dangling_mask(self) -> np.ndarray:
        return self._out_deg == 0

    def _base_row(self, u: int) -> np.ndarray:
        if u >= self._base.n:
            return np.empty(0, dtype=np.int64)
        s, e = self._base.indptr[u], self._base.indptr[u + 1]
        return self._base.indices[s:e].astype(np.int64)

    def out_neighbors(self, u: int) -> np.ndarray:
        """Current out-row of `u`: base row minus tombstones plus overlay
        additions, sorted. O(base_deg(u) + overlay(u))."""
        row = self._base_row(u)
        dels = self._del.get(u)
        if dels:
            row = row[~np.isin(row, np.fromiter(dels, np.int64, len(dels)))]
        adds = self._add.get(u)
        if adds:
            row = np.concatenate(
                [row, np.fromiter(adds, np.int64, len(adds))])
            row.sort()
        return row

    def _in_base_row(self, u: int, j: int) -> bool:
        if u >= self._base.n:
            return False
        s, e = self._base.indptr[u], self._base.indptr[u + 1]
        k = np.searchsorted(self._base.indices[s:e], j)
        return bool(k < e - s and self._base.indices[s + k] == j)

    def has_edge(self, u: int, j: int) -> bool:
        adds = self._add.get(u)
        if adds and j in adds:
            return True
        dels = self._del.get(u)
        if dels and j in dels:
            return False
        return self._in_base_row(u, j)

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def apply(self, delta: EdgeDelta) -> DeltaReceipt:
        """Apply one batch (deletions first, then insertions). Returns the
        receipt the incremental solver seeds residuals from."""
        n_old = self.n
        n_new = n_old + delta.new_nodes
        hi = int(max(delta.add_src.max(initial=-1),
                     delta.add_dst.max(initial=-1),
                     delta.del_src.max(initial=-1),
                     delta.del_dst.max(initial=-1)))
        if hi >= n_new:
            raise ValueError(f"delta references node {hi} but the graph has "
                             f"only {n_new} nodes after arrivals")
        if delta.new_nodes:
            self.n = n_new
            self._out_deg = np.concatenate(
                [self._out_deg, np.zeros(delta.new_nodes, np.int64)])

        cand = np.unique(np.concatenate([delta.del_src, delta.add_src])) \
            if delta.size else np.empty(0, np.int64)
        old_rows = {int(u): self.out_neighbors(int(u)) for u in cand}

        n_deleted = 0
        for u, j in zip(delta.del_src, delta.del_dst):
            u, j = int(u), int(j)
            adds = self._add.get(u)
            if adds is not None and j in adds:
                adds.discard(j)
                self._log_edges -= 1
                n_deleted += 1
            elif self._in_base_row(u, j) and j not in self._del.get(u, ()):
                self._del.setdefault(u, set()).add(j)
                self._log_edges += 1
                n_deleted += 1

        n_added = 0
        for u, j in zip(delta.add_src, delta.add_dst):
            u, j = int(u), int(j)
            dels = self._del.get(u)
            if dels is not None and j in dels:
                dels.discard(j)
                self._log_edges -= 1
                n_added += 1
            elif not self._in_base_row(u, j) and \
                    j not in self._add.get(u, ()):
                self._add.setdefault(u, set()).add(j)
                self._log_edges += 1
                n_added += 1

        touched, o_deg, n_deg, o_rows, n_rows = [], [], [], [], []
        for u in cand:
            u = int(u)
            new_row = self.out_neighbors(u)
            old_row = old_rows[u]
            if new_row.size == old_row.size and \
                    np.array_equal(new_row, old_row):
                continue
            touched.append(u)
            o_deg.append(old_row.size)
            n_deg.append(new_row.size)
            o_rows.append(old_row)
            n_rows.append(new_row)
            self._out_deg[u] = new_row.size

        self.version += 1
        rcpt = DeltaReceipt(
            version=self.version, n_old=n_old, n_new=n_new,
            touched=np.asarray(touched, dtype=np.int64),
            old_deg=np.asarray(o_deg, dtype=np.int64),
            new_deg=np.asarray(n_deg, dtype=np.int64),
            old_rows=tuple(o_rows), new_rows=tuple(n_rows),
            n_added=n_added, n_deleted=n_deleted,
        )
        self._last_receipt = rcpt   # feeds the P^T row-splice (transition)
        if self._log_edges > self.compact_frac * max(self._base.nnz, 1):
            self.compact()
        self._gc_views()
        return rcpt

    def compact(self) -> None:
        """Fold the overlay into a fresh CSR base. The graph value is
        unchanged, so the version — and every per-version memoized
        operator view — is preserved."""
        if not self._add and not self._del and self.n == self._base.n:
            return
        self._base = self.graph()
        self._add.clear()
        self._del.clear()
        self._log_edges = 0

    def _gc_views(self, keep: int = 2) -> None:
        """Drop memoized views older than the last `keep` versions (their
        device/BSR caches go with them)."""
        floor = self.version - keep
        for d in (self._snap, self._pt, self._pt_sp):
            for k in [k for k in d if k < floor]:
                del d[k]
        for k in [k for k in self._ops if k[0] < floor]:
            del self._ops[k]

    # ------------------------------------------------------------------
    # materialized views (memoized per version)
    # ------------------------------------------------------------------
    def graph(self) -> CSRGraph:
        """Immutable CSR snapshot of the current version."""
        g = self._snap.get(self.version)
        if g is not None:
            return g
        keep = np.ones(self._base.nnz, dtype=bool)
        for u, dels in self._del.items():
            if not dels:
                continue
            s, e = self._base.indptr[u], self._base.indptr[u + 1]
            keep[s:e] &= ~np.isin(
                self._base.indices[s:e],
                np.fromiter(dels, np.int64, len(dels)))
        src_b = np.repeat(np.arange(self._base.n, dtype=np.int64),
                          np.diff(self._base.indptr))[keep]
        dst_b = self._base.indices[keep].astype(np.int64)
        add_s, add_d = [], []
        for u, adds in self._add.items():
            if adds:
                add_s.append(np.full(len(adds), u, np.int64))
                add_d.append(np.fromiter(adds, np.int64, len(adds)))
        src = np.concatenate([src_b] + add_s) if add_s else src_b
        dst = np.concatenate([dst_b] + add_d) if add_d else dst_b
        g = CSRGraph.from_edges(self.n, src, dst)
        self._snap[self.version] = g
        return g

    def transition(self) -> TransitionT:
        """P^T of the current version (shared by every operator view of
        this version, so device edge arrays upload once).

        When the previous version's P^T is memoized and the last receipt is
        one step behind, the new transition is *row-spliced* from it
        (O(touched) edits + O(nnz) copies) instead of rebuilt with the full
        O(nnz log nnz) destination sort.  Keys stay per-version, and
        `compact()` never bumps the version, so the splice inputs — the
        previous P^T and the receipt, neither of which references the base
        CSR — survive compaction unchanged."""
        pt = self._pt.get(self.version)
        if pt is None:
            pt = self._patched_transition()
            if pt is None:
                pt = TransitionT.from_graph(self.graph())
            self._pt[self.version] = pt
        return pt

    def _patched_transition(self) -> Optional[TransitionT]:
        """Row-splice P^T from version-1 when cheap; None => full rebuild."""
        rcpt = self._last_receipt
        prev = self._pt.get(self.version - 1)
        if rcpt is None or prev is None or rcpt.version != self.version:
            return None
        if rcpt.touched.size == 0 and rcpt.n_new == prev.n:
            return prev          # value-identical: share the instance (and
            #                      its memoized device edge arrays)
        edits = int(sum(r.size for r in rcpt.old_rows)
                    + sum(r.size for r in rcpt.new_rows))
        if edits > 0.25 * max(prev.nnz, 1):
            return None          # batch too global: the rebuild is cheaper
        return _splice_transition(prev, rcpt, self._out_deg,
                                  self.dangling_mask)

    def scipy_pt(self):
        """scipy CSR of P^T for host-side exact residuals, per version."""
        m = self._pt_sp.get(self.version)
        if m is None:
            m = self.transition().to_scipy()
            self._pt_sp[self.version] = m
        return m

    def operator(self, alpha: float = 0.85,
                 v: Optional[np.ndarray] = None) -> GoogleOperator:
        """GoogleOperator view of the current version.

        The uniform-teleport view is memoized per (version, alpha) — its
        device/BSR caches persist across every fallback solve at this
        version.  Personalized views are built fresh but share this
        version's `TransitionT`, so the edge device arrays still carry.
        """
        if v is not None:
            return GoogleOperator(pt=self.transition(), alpha=alpha, v=v)
        key = (self.version, float(alpha))
        op = self._ops.get(key)
        if op is None:
            op = GoogleOperator(pt=self.transition(), alpha=alpha)
            self._ops[key] = op
        return op

    def freeze(self) -> "FrozenGraphView":
        """Immutable point-in-time view for concurrent readers (copies only
        the overlay and the degree array, never the base CSR)."""
        return FrozenGraphView(
            base=self._base, n=self.n,
            add={u: np.fromiter(s, np.int64, len(s))
                 for u, s in self._add.items() if s},
            dels={u: np.fromiter(s, np.int64, len(s))
                  for u, s in self._del.items() if s},
            out_deg=self._out_deg.copy(),
            version=self.version,
        )


@dataclasses.dataclass(frozen=True)
class FrozenGraphView:
    """Read-only (base + overlay copy) view; safe to query from any thread
    while the live `DeltaGraph` keeps mutating."""

    base: CSRGraph
    n: int
    add: Dict[int, np.ndarray]
    dels: Dict[int, np.ndarray]
    out_deg: np.ndarray
    version: int

    @property
    def dangling_mask(self) -> np.ndarray:
        return self.out_deg == 0

    def out_neighbors(self, u: int) -> np.ndarray:
        if u < self.base.n:
            s, e = self.base.indptr[u], self.base.indptr[u + 1]
            row = self.base.indices[s:e].astype(np.int64)
        else:
            row = np.empty(0, dtype=np.int64)
        d = self.dels.get(u)
        if d is not None:
            row = row[~np.isin(row, d)]
        a = self.add.get(u)
        if a is not None:
            row = np.concatenate([row, a])
            row.sort()
        return row
