"""Plain PyTorch version of the SSD chunked scan: the JAX package's
`_ssd_scan` (repro/models/ssm.py:59-110) line for line, its `lax.scan`
over chunks a Python loop, with an optional initial state; and its
gradient in closed form (`ssd_scan_bwd_ref`), which the JAX package takes
by XLA's autodiff."""
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


def ssd_scan_bwd_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     dt: torch.Tensor, a_log: torch.Tensor, chunk: int,
                     dy: torch.Tensor, dh_last: Optional[torch.Tensor] = None,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of `ssd_scan_ref` for the arguments of the forward, the
    gradient dy (B, S, H, P) of y (in x's dtype) and dh_last (B, H, P, N)
    float32 of the final state (None: zero). Returns (dx in x's dtype, db
    and dc in b's dtype, ddt (B, S, H) float32, da_log (H,) float32, dh0
    (B, H, P, N) float32 or None without h0).

    Per chunk, with cum the in-chunk cumsum of dt A (A = -exp(a_log)), L
    its last step, h_in and h_out the chunk's incoming and outgoing
    states, W[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, and
    g the gradient of h_out (dh_last or 0 for the last chunk):
      g_in = exp(cum_L) g + sum_t exp(cum_t) dy_t^T C_t, the next (earlier)
        chunk's g; dh0 = g_in of the first chunk;
      dx_s = sum_{t >= s} W[t, s] dy_t + tail_s u_s, with
        tail_s = exp(cum_L - cum_s) dt_s and u_s = g B_s;
      dW[t, s] = dy_t . x_s; dCB[t, s] = sum_h dW exp(cum_t - cum_s) dt_s
        (B and C are shared by the heads, so their gradients sum over
        them); dC_t = sum_s dCB[t, s] B_s + sum_h exp(cum_t) dy_t h_in;
        dB_s = sum_t dCB[t, s] C_t + sum_h tail_s x_s^T g;
      dcum_t = sum_s dW W[t, s] - sum_{t'} dW W[t', t]
        + exp(cum_t) dy_t . (h_in C_t) - tail_t (x_t . u_t), and at L also
        + sum_s tail_s (x_s . u_s) + exp(cum_L) sum (g h_in);
      d(dt A)_s = sum_{t >= s} dcum_t (cum's reverse cumsum);
      ddt_s = sum_t dW (C_t . B_s) exp(cum_t - cum_s)
        + exp(cum_L - cum_s) (x_s . u_s) + d(dt A)_s A;
      da_log = sum_s d(dt A)_s dt_s A (A = -exp(a_log) is its own
        derivative) = sum_t dcum_t cum_t, summed per chunk as
        sum_{s <= t} dW W[t, s] (cum_t - cum_s) + sum_t dinter_t cum_t
        + sum_s tail_s (x_s . u_s) (cum_L - cum_s)
        + exp(cum_L) sum (g h_in) cum_L, dinter_t the inter-chunk term of
        dcum_t. Each weight is small where its term is not: sum_t dcum_t
        cum_t itself cancels terms of |cum| up to hundreds (its intra-chunk
        part sums to zero), which in float32 left da_log 1.3e-4 of its
        largest element from the float64 value with cum near -1000; this
        form, 6e-6.
    exp(cum_t - cum_s) is never factored into exp(cum_t) exp(-cum_s): cum
    reaches -100 to -250 inside a chunk, where exp(-cum_s) overflows. The
    ragged tail is padded with zeros, as in the forward. Every product is
    in float32, in the split of the CUDA kernel (csrc/ssd_scan.cu): the
    per-head terms of dcum, dx and ddt per (b, chunk, head), dCB summed
    over the heads before its products with B and C, da_log summed over
    each chunk and then over the chunks."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dy = F.pad(dy, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    A = -torch.exp(a_log.float())                             # (H,)

    xq = x.reshape(B, nc, Q, H, P).float()
    dyq = dy.reshape(B, nc, Q, H, P).float()
    bq = b.reshape(B, nc, Q, N).float()
    cq = c.reshape(B, nc, Q, N).float()
    dtq = dt.reshape(B, nc, Q, H).float()
    cum = torch.cumsum(dtq * A, dim=2)                        # (B,nc,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))

    # the forward again, for each chunk's incoming state (as ssd_scan_ref)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for i in range(nc):
        h_in.append(h)
        cumc, dtc = cum[:, i], dtq[:, i]
        tail = torch.exp(cumc[:, -1:, :] - cumc) * dtc
        dh = torch.einsum("bsh,bshp,bsn->bhpn", tail, xq[:, i], bq[:, i])
        h = h * torch.exp(cumc[:, -1, :])[:, :, None, None] + dh

    g = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if dh_last is None else dh_last.float())
    dx, db, dc = torch.empty_like(xq), torch.empty_like(bq), \
        torch.empty_like(cq)
    ddt = torch.empty_like(dtq)
    part = torch.empty((B, nc, H), dtype=torch.float32, device=x.device)
    for i in reversed(range(nc)):
        xc, bc, cc, dyc = xq[:, i], bq[:, i], cq[:, i], dyq[:, i]
        dtc, cumc, hin = dtq[:, i], cum[:, i], h_in[i]
        # intra-chunk: W[t, s] = (C_t . B_s) L[t, s] dt_s
        seg = cumc[:, :, None, :] - cumc[:, None, :, :]       # (B,Q,Q,H)
        L = torch.where(tri[None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=x.device))
        cb = torch.einsum("btn,bsn->bts", cc, bc)             # (B,Q,Q)
        Ld = L * dtc[:, None, :, :]
        W = cb[..., None] * Ld
        dW = torch.einsum("bthp,bshp->btsh", dyc, xc)
        M = dW * W
        dcum = M.sum(2) - M.sum(1)                            # (B,Q,H)
        pa = (M * seg).sum((1, 2))                            # (B,H)
        dcb = (dW * Ld).sum(-1)                               # (B,Q,Q)
        ddtc = (dW * cb[..., None] * L).sum(1)
        dxc = torch.einsum("btsh,bthp->bshp", W, dyc)
        # inter-chunk: y_t += exp(cum_t) C_t . h_in
        ecum = torch.exp(cumc)
        v = torch.einsum("btn,bhpn->bthp", cc, hin)
        dinter = ecum * (dyc * v).sum(-1)
        dcum = dcum + dinter
        pa = pa + (dinter * cumc).sum(1)
        ey = ecum[..., None] * dyc
        dc[:, i] = (torch.einsum("bts,bsn->btn", dcb, bc)
                    + torch.einsum("bthp,bhpn->btn", ey, hin))
        # the state: h_out = exp(cum_L) h_in + sum_s tail_s x_s B_s^T
        tail_e = torch.exp(cumc[:, -1:, :] - cumc)
        tail = tail_e * dtc
        u = torch.einsum("bsn,bhpn->bshp", bc, g)
        dtail = (xc * u).sum(-1)                              # (B,Q,H)
        dx[:, i] = dxc + tail[..., None] * u
        db[:, i] = (torch.einsum("bts,btn->bsn", dcb, cc)
                    + torch.einsum("bshp,bhpn->bsn", tail[..., None] * xc,
                                   g))
        ddtc = ddtc + tail_e * dtail
        dcum = dcum - tail * dtail
        dcum[:, -1] += ((tail * dtail).sum(1)
                        + torch.exp(cumc[:, -1]) * (g * hin).sum((-2, -1)))
        dl = dcum.flip(1).cumsum(1).flip(1)                   # d(dt A)
        ddt[:, i] = ddtc + dl * A
        part[:, i] = (pa + (tail * dtail * (cumc[:, -1:] - cumc)).sum(1)
                      + torch.exp(cumc[:, -1]) * (g * hin).sum((-2, -1))
                      * cumc[:, -1])
        g = (g * torch.exp(cumc[:, -1, :])[:, :, None, None]
             + torch.einsum("bthp,btn->bhpn", ey, cc))

    def out(t, shape, dtype):
        return t.reshape(shape)[:, :S_orig].to(dtype)
    return (out(dx, (B, S, H, P), x.dtype), out(db, (B, S, N), b.dtype),
            out(dc, (B, S, N), c.dtype), out(ddt, (B, S, H), torch.float32),
            part.sum((0, 1)), None if h0 is None else g)
