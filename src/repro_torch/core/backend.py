"""Pluggable matvec backends for the Google-operator hot path.

The paper's per-iteration cost is one application of

    G x = alpha P^T x + alpha w (d^T x) + (1 - alpha) v (e^T x)

and every solver funnels through it. Two backends implement it:

  segment_sum : gather + scatter-add over the CSR edge list (exact in any
                dtype; float64 is the oracle-grade lane).
  bsr         : hub-split block-CSR (kernels.bsr_spmv). The site-local mass
                runs as dense (bm, bn) block multiplies in the hand-written
                CUDA kernel (its plain PyTorch version on the CPU), and the
                in-degree-tail rows go through a scatter-add side path. The
                iterate stays in the padded (nbr, bm, nv) block layout for
                the whole solve, and nv teleport lanes share every block
                load (batched personalized PageRank). "bsr_pallas", the JAX
                package's name, is accepted as an alias.

Layout contract (bsr):
  * square blocks (bm == bn) so y has the same layout as x;
  * padded rows/cols beyond n are exactly zero and stay zero: blocks and
    the hub COO never touch them, the teleport vector and the scalar
    dangling-mass correction are masked by `valid`;
  * arithmetic is float32 end to end — L1 residuals bottom out around 1e-7;
    ask segment_sum in float64 for tighter tolerances.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.csr import pt_matvec
from ..graph.google import GoogleOperator
from ..kernels.bsr_spmv.bsr_spmv import DEFAULT_BM
from ..kernels import IMPLS
from ..kernels.bsr_spmv.ops import hybrid_matvec, pad_x

BACKENDS = ("segment_sum", "bsr")
ALIASES = {"bsr_pallas": "bsr"}

# Auto block edge on CUDA: DEFAULT_BM = 8. The Stanford-Web replica
# (281,903 pages, 2,312,497 links) after the 99th-percentile hub split,
# with the block kernel's and one warm google_apply's time at nv = 1
# (chip_smoke.py packing and timing phases, NVIDIA H100 80GB HBM3, 700 W):
#
#   bm = bn   nbr      K    real slots   blocks real / layout   kernel   apply
#   8         35,238   42   1,031,630    264 MB / 379 MB        0.094    0.307
#   16        17,619   33     385,698    395 MB / 595 MB        0.141    0.356
#   32         8,810   33     173,677    711 MB / 1.19 GB       0.250    0.465
#   64         4,405   44     118,964    1.95 GB / 3.18 GB      0.642    0.864
#   128        -       70   refused by build_bsr (10.1 GB)
#
# (ms.) The kernel reads only the real slots and is bound by their bytes,
# so the smallest edge, with the fewest bytes of zeros inside its blocks,
# is the fastest; the TPU's 128 cannot pack this graph at all. The CPU
# keeps 8 as well, the JAX package's CPU choice, so the port's CPU path
# packs the same layout as the reference.
CPU_BM = 8


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Hashable backend selector."""
    name: str = "segment_sum"
    impl: str = "auto"          # bsr only: auto | cuda | ref
    bm: int = 0                 # block edge; 0 = auto (DEFAULT_BM or CPU_BM)
    hub_quantile: float = 0.99  # rows above this row-nnz quantile bypass BSR

    def resolved(self, device: torch.device) -> "BackendSpec":
        name = ALIASES.get(self.name, self.name)
        if name not in BACKENDS:
            raise ValueError(f"unknown backend {self.name!r}; expected one "
                             f"of {BACKENDS + tuple(ALIASES)}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; expected one of "
                             f"{IMPLS}")
        bm = self.bm or (DEFAULT_BM if device.type == "cuda" else CPU_BM)
        return dataclasses.replace(self, name=name, bm=bm)


def as_spec(backend, device: torch.device) -> BackendSpec:
    """Coerce a user-facing backend argument (str or spec) to a resolved
    BackendSpec for `device`."""
    if not isinstance(backend, BackendSpec):
        backend = BackendSpec(name=str(backend))
    return backend.resolved(torch.device(device))


# --------------------------------------------------------------------------
# Preparation: operator -> device state + layout metadata
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BackendMeta:
    """Static layout info threaded through the solver loop."""
    spec: BackendSpec
    n: int
    nv: int
    n_pad: int                  # nbr * bm for bsr, == n for segment_sum
    alpha: float


def _as_stack(a: np.ndarray, n: int, what: str) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 1:
        a = a[:, None]
    if a.shape[0] != n:
        raise ValueError(f"{what} has {a.shape[0]} rows, operator has {n}")
    return a


def seed_stack(n: int, seed_sets, weight_sets=None) -> np.ndarray:
    """Build an (n, nv) personalized-teleport stack from nv seed sets.

    Each column is a probability vector concentrated on that query's seeds
    (uniform over the set unless `weight_sets[i]` gives explicit weights,
    which are L1-normalized). One fused solve over the stack amortizes every
    edge/block load across all nv personalized problems.
    """
    seed_sets = list(seed_sets)
    nv = len(seed_sets)
    if nv == 0:
        raise ValueError("seed_stack needs at least one seed set")
    v = np.zeros((n, nv), dtype=np.float64)
    for i, seeds in enumerate(seed_sets):
        seeds = np.asarray(seeds, dtype=np.int64).ravel()
        w = None if weight_sets is None else weight_sets[i]
        if w is None:
            v[seeds, i] = 1.0 / seeds.size
        else:
            w = np.asarray(w, dtype=np.float64).ravel()
            v[seeds, i] = w / w.sum()
    return v


def as_lane_tol(tol, nv: int) -> np.ndarray:
    """Coerce a scalar-or-per-lane tolerance to a validated (nv,) array:
    each lane stops (and may freeze out of the apply) at its own
    threshold."""
    t = np.asarray(tol, dtype=np.float64).ravel()
    if t.size == 1:
        t = np.full(nv, float(t[0]))
    if t.size != nv:
        raise ValueError(f"tol has {t.size} entries for {nv} lanes")
    if not np.all(np.isfinite(t)) or np.any(t <= 0):
        raise ValueError("per-lane tol entries must be finite and > 0")
    return t


def prepare(op: GoogleOperator, spec: BackendSpec, dtype: torch.dtype,
            v: Optional[np.ndarray] = None,
            x0: Optional[np.ndarray] = None,
            device: DeviceLike = None
            ) -> Tuple[dict, BackendMeta, torch.Tensor]:
    """Build (device state, meta, x0 in backend layout) for a solve.

    `spec` is a resolved BackendSpec (see `as_spec`); `device=None` means
    the CUDA card. `dtype` is the segment_sum working dtype; the bsr path
    is float32 end to end. `v`/`x0` may be (n,) vectors or (n, nv) stacks;
    lanes broadcast against each other. Structural state (edges, blocks,
    masks) is memoized on the operator; only the teleport stack and x0 are
    uploaded per call.
    """
    device = resolve_device(device)
    n = op.n
    v_stack = _as_stack(op.teleport() if v is None else v, n, "teleport v")
    nv = v_stack.shape[1]
    if x0 is None:
        x0_stack = np.full((n, nv), 1.0 / n, dtype=np.float64)
    else:
        x0_stack = _as_stack(x0, n, "x0")
    if x0_stack.shape[1] != nv:
        if x0_stack.shape[1] == 1:
            x0_stack = np.broadcast_to(x0_stack, (n, nv)).copy()
        elif nv == 1:
            v_stack = np.broadcast_to(v_stack, (n, x0_stack.shape[1])).copy()
            nv = v_stack.shape[1]
        else:
            raise ValueError(
                f"x0 has {x0_stack.shape[1]} lanes, v has {nv}")

    if spec.name == "segment_sum":
        dev = op.device_arrays(dtype=dtype, device=device)
        dev["v"] = torch.as_tensor(v_stack, device=device).to(dtype)
        meta = BackendMeta(spec=spec, n=n, nv=nv, n_pad=n,
                           alpha=float(op.alpha))
        return dev, meta, torch.as_tensor(x0_stack, device=device).to(dtype)

    # ---- bsr -----------------------------------------------------------
    bm = spec.bm
    hyb = op.hybrid_bsr(bm=bm, bn=bm, hub_quantile=spec.hub_quantile)
    cache = op._cache()
    key = ("bsr_dev", bm, spec.hub_quantile, device)
    dev_struct = cache.get(key)
    if dev_struct is None:
        dev_struct = hyb.device(device)
        nbr = hyb.bsr.nbr
        valid = np.zeros((nbr * bm, 1), dtype=np.float32)
        valid[:n] = 1.0
        dang = np.zeros((nbr * bm, 1), dtype=np.float32)
        dang[:n, 0] = op.pt.dangling.astype(np.float32)
        dev_struct["valid"] = torch.as_tensor(valid.reshape(nbr, bm, 1),
                                              device=device)
        dev_struct["dang"] = torch.as_tensor(dang.reshape(nbr, bm, 1),
                                             device=device)
        cache[key] = dev_struct
    dev = dict(dev_struct)
    nbr = hyb.bsr.nbr
    dev["v"] = torch.as_tensor(pad_x(v_stack.astype(np.float32), n, bm),
                               device=device)
    meta = BackendMeta(spec=spec, n=n, nv=nv, n_pad=nbr * bm,
                       alpha=float(op.alpha))
    x0_dev = torch.as_tensor(pad_x(x0_stack.astype(np.float32), n, bm),
                             device=device)
    return dev, meta, x0_dev


def from_layout(meta: BackendMeta, x_dev: torch.Tensor) -> np.ndarray:
    """Backend layout -> (n, nv) float64 numpy."""
    x = x_dev.detach().cpu().numpy().astype(np.float64)
    if meta.spec.name == "segment_sum":
        return x
    return x.reshape(meta.n_pad, meta.nv)[:meta.n]


# --------------------------------------------------------------------------
# The fused apply
# --------------------------------------------------------------------------
def google_apply(meta: BackendMeta, dev: dict, x: torch.Tensor,
                 linear: bool) -> torch.Tensor:
    """One application of G (or R x + b for the linear form) in the
    backend's resident layout. Padding rows stay exactly zero."""
    alpha, n = meta.alpha, meta.n
    if meta.spec.name == "segment_sum":
        y = alpha * pt_matvec(dev, x, n)
        dmass = torch.where(dev["dangling"][:, None], x, 0.0).sum(dim=0)
        y = y + alpha * dmass[None, :] / n
        if linear:
            y = y + (1.0 - alpha) * dev["v"]
        else:
            y = y + (1.0 - alpha) * x.sum(dim=0)[None, :] * dev["v"]
        return y

    # bsr: x is (nbr, bm, nv)
    y = alpha * hybrid_matvec(dev, x, impl=meta.spec.impl)
    dmass = (x * dev["dang"]).sum(dim=(0, 1))                  # (nv,)
    y = y + (alpha / n) * dmass[None, None, :] * dev["valid"]
    if linear:
        y = y + (1.0 - alpha) * dev["v"]
    else:
        s = (x * dev["valid"]).sum(dim=(0, 1))                 # (nv,)
        y = y + (1.0 - alpha) * s[None, None, :] * dev["v"]
    return y.to(x.dtype)


def l1_residual(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-lane L1 residual ||y - x||_1, shape (nv,). Padding rows are zero
    in both layouts so no masking is needed."""
    d = (y - x).abs()
    return d.sum(dim=tuple(range(d.ndim - 1)))


def take_lanes(meta: BackendMeta, dev: dict, x: torch.Tensor,
               idx: np.ndarray) -> Tuple[dict, BackendMeta, torch.Tensor]:
    """Slice the lane (last) axis of the per-solve state down to `idx`.

    Used by the per-lane-freezing driver: converged lanes are compacted out
    of the fused apply so the remaining lanes stop paying for them. Only
    the teleport stack and the iterate carry a lane axis; the structural
    device state (edges, blocks, masks) is lane-invariant and shared.
    `index_select` returns new contiguous tensors, as the kernel takes them.
    """
    idx_t = torch.as_tensor(np.asarray(idx, dtype=np.int64),
                            device=x.device)
    dev = dict(dev)
    dev["v"] = dev["v"].index_select(-1, idx_t)
    meta = dataclasses.replace(meta, nv=int(idx_t.numel()))
    return dev, meta, x.index_select(-1, idx_t)
