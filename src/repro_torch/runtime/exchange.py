"""The bulk-synchronous rendering of an ExchangePlan, with every shard on
one card: who refreshes which fragment of whose view after a superstep.

The JAX package runs one shard program per device under `shard_map`, each
holding its own (n_pad, nv) stale view, and exchanges fragments with
collectives on the "ue" mesh axis. Here the p shards share one card and
every per-shard array carries a leading `p` axis: the views are one
(p, n_pad, nv) tensor and the new fragments one (p, bsize, nv) tensor. The
collectives become tensor operations on that axis:

  all_gather(newfrag) -> view   newfrag.reshape(n_pad, nv), written into
                                every shard's view
  ppermute(ring, j -> j + 1)    torch.roll(ring, 1, dims=0)
  axis_index                    torch.arange(p)
  lax.cond(due, full, sparse)   a Python `if`: `due` and `do_sync` depend
                                only on the superstep, a host int
  lax.top_k(delta, k)           a stable descending sort of each shard's
                                row deltas, first k (ties go to the lower
                                row, as top_k breaks them)
  dynamic_update_slice / .at[]  indexed writes on the shards' views

The delivery draws (`accept`) come from the host as well
(`step.hash_uniform`), so which shards take a payload is known before any
tensor is touched and the exchange never reads the card. The views are
updated in place: the superstep reads them only before its exchange.

The host renderings of the plans (`ExchangePlan`, `make_plan`) are not
ported yet (ROADMAP Queue 1 item 5.2).
"""
from __future__ import annotations

import numpy as np
import torch

SPMD_SCHEDULES = ("allgather", "allgather_k", "ring", "sparsified")


def spmd_exchange(schedule: str, *, p: int, bsize: int, n_pad: int,
                  sync_every: int = 4, sparsify_k: int = 0,
                  sparsify_row_thresh: float = 0.0,
                  sparsify_refresh_every: int = 16,
                  sparsify_adaptive: bool = False,
                  sparsify_cover_frac: float = 0.9,
                  sparsify_ewma: float = 0.5,
                  sparsify_endgame_mass: float = 0.0):
    """Build the exchange of one shard-program loop.

    Returns ``(init_state, comm)``:

      init_state(myfrag) -> comm_state carried through the loop, from the
          (p, bsize, nv) fragments (ring: the relay buffer; sparsified: the
          last-sent fragments, and with `sparsify_adaptive` the (p,) EWMA
          of the payload size; otherwise an empty tuple);
      comm(view, newfrag, comm_state, step, accept)
          -> (view, comm_state, rows_sent, full_sent)
          where `view` is the (p, n_pad, nv) stale views after this
          superstep's exchange (updated in place), `step` the superstep (a
          Python int), `accept` the (p,) numpy bools of the delivery draws,
          `rows_sent` a (p,) int32 tensor of the sparse payload rows each
          shard shipped (zeros for the dense schedules, whose byte model is
          static), and `full_sent` a (p,) numpy int array, 1 where a shard
          took a full-fragment refresh.

    The schedules are the JAX package's (repro/runtime/exchange.py:230),
    each written for all shards at once: allgather every superstep;
    allgather_k every `sync_every` supersteps, fragments kept stale in
    between; ring, one relay stage a superstep; and sparsified, the top-k
    rows by per-row |delta| (summed over lanes) above
    `sparsify_row_thresh`, shipped as (idx, value) pairs, with a forced full
    refresh every `sparsify_refresh_every` supersteps that no delivery draw
    can drop (the bounded-delay guarantee). With ``sparsify_adaptive=True``
    the payload is the smallest m whose top rows cover
    `sparsify_cover_frac` of the shard's |delta| mass, EWMA-smoothed in
    float32 (`sparsify_ewma` is the new observation's weight) within the
    budget `sparsify_k` (auto: ~bsize/8); once a shard's |delta| mass falls
    to `sparsify_endgame_mass` the payload reverts to the full budget.
    """
    if schedule not in SPMD_SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; expected one of "
                         f"{SPMD_SCHEDULES}")
    shards = np.arange(p)
    no_rows = {}

    def zeros_rows(view):
        key = view.device
        if key not in no_rows:
            no_rows[key] = torch.zeros(p, dtype=torch.int32, device=key)
        return no_rows[key]

    def place_own(view, newfrag):
        # every shard's own slot holds its fresh fragment
        ar = torch.arange(p, device=view.device)
        view.view(p, p, bsize, -1)[ar, ar] = newfrag
        return view

    def gather_into(view, newfrag, recv):
        """The all-gathered fragments, written into the views of the
        shards `recv` (numpy bools)."""
        full = newfrag.reshape(1, n_pad, -1)
        if recv.all():
            view.copy_(full.expand_as(view))
        elif recv.any():
            idx = torch.as_tensor(np.flatnonzero(recv), device=view.device)
            view[idx] = full
        return view

    if schedule == "allgather":
        def init_state(myfrag):
            return ()

        def comm(view, newfrag, state, step, accept):
            view = gather_into(view, newfrag, np.ones(p, bool))
            return view, state, zeros_rows(view), np.ones(p, np.int64)
        return init_state, comm

    if schedule == "allgather_k":
        def init_state(myfrag):
            return ()

        def comm(view, newfrag, state, step, accept):
            do_sync = step % sync_every == sync_every - 1
            sync_ok = np.asarray(accept, bool) & do_sync
            if not sync_ok.all():
                view = place_own(view, newfrag)
            view = gather_into(view, newfrag, sync_ok)
            return view, state, zeros_rows(view), sync_ok.astype(np.int64)
        return init_state, comm

    if schedule == "ring":
        def init_state(myfrag):
            return myfrag

        def comm(view, newfrag, ring, step, accept):
            ring_in = torch.roll(ring, 1, dims=0)
            # at superstep s (0-based), shard i's incoming fragment belongs
            # to shard (i - s - 1) mod p: Python's %, never a truncating
            # remainder, since i - s - 1 is negative
            owner = (shards - step - 1) % p
            view = place_own(view, newfrag)
            take = np.asarray(accept, bool) & (owner != shards)
            if take.any():
                idx = np.flatnonzero(take)
                view.view(p, p, bsize, -1)[
                    torch.as_tensor(idx, device=view.device),
                    torch.as_tensor(owner[idx], device=view.device)] = \
                    ring_in[torch.as_tensor(idx, device=view.device)]
            # forward own fragment afresh every p steps, else relay
            ring = newfrag if (step + 1) % p == 0 else ring_in
            return view, ring, zeros_rows(view), np.ones(p, np.int64)
        return init_state, comm

    # ---- sparsified -----------------------------------------------------
    k = int(sparsify_k) if sparsify_k > 0 else max(min(bsize, 128),
                                                   bsize // 8)
    k = min(k, bsize)
    refresh = max(int(sparsify_refresh_every), 1)
    cover = float(sparsify_cover_frac)
    ewma_w = float(sparsify_ewma)

    def init_state(myfrag):
        if sparsify_adaptive:
            # (last-shipped fragments, EWMA of the mass-coverage count,
            # started at the full budget)
            return (myfrag, torch.full((p,), float(k), dtype=torch.float32,
                                       device=myfrag.device))
        return myfrag            # the fragments as last shipped to peers

    def comm(view, newfrag, state, step, accept):
        if sparsify_adaptive:
            last_sent, k_ewma = state
        else:
            last_sent, k_ewma = state, None
        dev, dt = view.device, newfrag.dtype
        delta = (newfrag - last_sent).abs().sum(dim=-1)        # (p, bsize)
        srt = torch.sort(delta, dim=1, descending=True, stable=True)
        top_vals, top_idx = srt.values[:, :k], srt.indices[:, :k]  # (p, k)
        row_ok = top_vals > torch.tensor(sparsify_row_thresh, dtype=dt,
                                         device=dev)
        if sparsify_adaptive:
            # the smallest m whose top rows cover `cover` of the shard's
            # |delta| mass; the EWMA is float32, as in the JAX package's
            # carry (its ceil flips if it is kept in float64)
            total = delta.sum(dim=1)                            # (p,)
            csum = torch.cumsum(top_vals, dim=1)
            m_now = (csum < cover * total[:, None]).sum(
                dim=1, dtype=torch.int32) + 1
            m_now = torch.clamp(m_now, max=k).float()
            k_ewma = torch.where(total > 0,
                                 ewma_w * m_now + (1.0 - ewma_w) * k_ewma,
                                 k_ewma)
            m_eff = torch.ceil(k_ewma).to(torch.int32)
            # endgame: a tolerance-scale delta mass ships at full budget
            endgame = torch.tensor(sparsify_endgame_mass, dtype=dt,
                                   device=dev)
            m_eff = torch.where(total <= endgame, k, m_eff)
            row_ok = row_ok & (torch.arange(k, device=dev)[None, :]
                               < m_eff[:, None])
        nrows = row_ok.sum(dim=1, dtype=torch.int32)
        due = step % refresh == refresh - 1

        view = place_own(view, newfrag)
        if due:
            # the forced refresh is delivery-reliable: a dropped sparse
            # payload advanced its sender's last_sent, and only this
            # unconditional refresh repairs the receiver
            view = gather_into(view, newfrag, np.ones(p, bool))
            last_sent = newfrag
        else:
            ar = torch.arange(p, device=dev)[:, None]
            vals = newfrag[ar, top_idx]                         # (p, k, nv)
            recv = np.flatnonzero(np.asarray(accept, bool))
            if recv.size:
                flat = (top_idx + ar * bsize).reshape(-1)       # (p * k,)
                r = torch.as_tensor(recv, device=dev)[:, None]
                cur = view[r, flat[None, :]]                # (R, p * k, nv)
                view[r, flat[None, :]] = torch.where(
                    row_ok.reshape(1, -1, 1),
                    vals.reshape(1, p * k, -1), cur)
            last_sent = last_sent.index_put(
                (ar, top_idx),
                torch.where(row_ok[..., None], vals, last_sent[ar, top_idx]))
        rows_sent = zeros_rows(view) if due else nrows
        state = (last_sent, k_ewma) if sparsify_adaptive else last_sent
        return view, state, rows_sent, np.full(p, int(due), np.int64)
    return init_state, comm
