"""Plain PyTorch version of the SSD chunked scan: the JAX package's
`_ssd_scan` (repro/models/ssm.py:59-110) line for line, its `lax.scan`
over chunks a Python loop, with an optional initial state."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_scan_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 dt: torch.Tensor, a_log: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: (B, S, H, P); b, c: (B, S, N), shared by the heads;
    dt: (B, S, H) after softplus; a_log: (H,), A = -exp(a_log); h0: (B, H,
    P, N) float32 or None (zeros). Chunks of Q = min(chunk, S) steps; a
    ragged tail is padded with zeros, which leave the state as it is.
    Everything past x's own values is float32. Returns y (B, S, H, P) in
    x's dtype and the final state (B, H, P, N) float32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    A = -torch.exp(a_log.float())                             # (H,)

    xq = x.reshape(B, nc, Q, H, P)
    bq = b.reshape(B, nc, Q, N).float()
    cq = c.reshape(B, nc, Q, N).float()
    dtq = dt.reshape(B, nc, Q, H).float()
    cum = torch.cumsum(dtq * A, dim=2)                        # (B,nc,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))

    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for i in range(nc):
        xc, bc, cc = xq[:, i].float(), bq[:, i], cq[:, i]
        dtc, cumc = dtq[:, i], cum[:, i]
        # intra-chunk: scores[t,s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s
        seg = cumc[:, :, None, :] - cumc[:, None, :, :]       # (B,Q,Q,H)
        decay = torch.where(tri[None, :, :, None], torch.exp(seg),
                            torch.zeros((), device=x.device))
        cb = torch.einsum("btn,bsn->bts", cc, bc)             # (B,Q,Q)
        w = cb[..., None] * decay * dtc[:, None, :, :]        # (B,Q,Q,H)
        y_intra = torch.einsum("btsh,bshp->bthp", w, xc)
        # inter-chunk: y_t += C_t . h_in * exp(cum_t)
        y_inter = torch.einsum("btn,bhpn,bth->bthp", cc, h, torch.exp(cumc))
        # h_out = h_in exp(cum_Q) + sum_s exp(cum_Q - cum_s) dt_s x_s B_s
        tail = torch.exp(cumc[:, -1:, :] - cumc) * dtc        # (B,Q,H)
        dh = torch.einsum("bsh,bshp,bsn->bhpn", tail, xc, bc)
        h = h * torch.exp(cumc[:, -1, :])[:, :, None, None] + dh
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    return y[:, :S_orig].to(x.dtype), h
