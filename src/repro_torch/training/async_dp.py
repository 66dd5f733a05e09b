"""The paper's asynchronous iteration applied to TRAINING (the JAX
package's training/async_dp.py).

Mapping eq. (5) onto SGD: the global state is the parameter vector w,
block-partitioned across UEs exactly like the PageRank iterate; UE i owns
w_{i} and repeats
    w_{i}(t+1) = w_{i}(t) - eta * grad_i L(w(tau^i(t)); minibatch_i)
using *stale* imports of the other fragments. This is asynchronous
parameter-sharded SGD (Hogwild-with-fragments), the direct analogue of the
paper's scheme, and it runs on the port's DES engine (`core.des.AsyncDES`)
with the same clock and network models and the Fig. 1 termination
protocol.

Two flavors:
  * DES (faithful): `TrainStaleOperator` plugs into `AsyncDES`. Sync DP
    waits for the slowest UE, async iterates through it. The DES keeps
    each UE's view as a float64 tensor on the run's device and hands it
    to `update_block`. The model has 544 parameters, so the gradient is
    taken in host numpy, as in the JAX package: one read of the view per
    update, then one upload of the new fragment. The minibatch indices are
    drawn from the operator's numpy Generator in the JAX package's order,
    so the sync and async runs match its counts, times and losses.
  * Local SGD (deployable): each data shard runs `sync_every` local SGD
    steps between parameter averages (bounded staleness k), cutting DP
    collective bytes by k. The JAX package maps the shards over a device
    mesh with `shard_map`; here they are a leading tensor axis on one
    device, as the port's shard program keeps its shards.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..core.des import AsyncDES, DESConfig
from ..core.partition import Partition, block_rows
from ..device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# DES flavor: a small two-layer MLP regression, parameters as the iterate
# ---------------------------------------------------------------------------
class MLPTask:
    """y = W2 tanh(W1 x); squared loss on a fixed synthetic dataset."""

    def __init__(self, d_in=16, d_hidden=32, n_data=2048, seed=0,
                 noise=0.01):
        rng = np.random.default_rng(seed)
        self.d_in, self.d_h = d_in, d_hidden
        w1t = rng.standard_normal((d_hidden, d_in)) / np.sqrt(d_in)
        w2t = rng.standard_normal((1, d_hidden)) / np.sqrt(d_hidden)
        self.X = rng.standard_normal((n_data, d_in))
        self.Y = (np.tanh(self.X @ w1t.T) @ w2t.T
                  + noise * rng.standard_normal((n_data, 1)))
        self.n_params = d_hidden * d_in + d_hidden

    def unpack(self, w: np.ndarray):
        k = self.d_h * self.d_in
        w1 = w[:k].reshape(self.d_h, self.d_in)
        w2 = w[k:].reshape(1, self.d_h)
        return w1, w2

    def loss(self, w: np.ndarray) -> float:
        w1, w2 = self.unpack(w)
        pred = np.tanh(self.X @ w1.T) @ w2.T
        return float(np.mean((pred - self.Y) ** 2))

    def grad(self, w: np.ndarray, batch_idx: np.ndarray) -> np.ndarray:
        w1, w2 = self.unpack(w)
        X, Y = self.X[batch_idx], self.Y[batch_idx]
        h = np.tanh(X @ w1.T)                      # (b, H)
        pred = h @ w2.T                            # (b, 1)
        e = 2.0 * (pred - Y) / len(batch_idx)      # (b, 1)
        g2 = e.T @ h                               # (1, H)
        dh = (e @ w2) * (1 - h * h)                # (b, H)
        g1 = dh.T @ X                              # (H, in)
        return np.concatenate([g1.reshape(-1), g2.reshape(-1)])


class TrainStaleOperator:
    """LocalSolver over the parameter vector: f_i = SGD on block i.

    lr decays 1/(1 + t/t0) per-UE so the weight-delta convergence criterion
    (the paper's local threshold) is meaningful under minibatch noise."""

    def __init__(self, task: MLPTask, part: Partition, lr: float = 0.2,
                 batch: int = 256, lr_decay_t0: float = 150.0,
                 seed: int = 0):
        self.task = task
        self.part = part
        self.lr = lr
        self.batch = batch
        self.t0 = lr_decay_t0
        self.rng = np.random.default_rng(seed)
        self._t = np.zeros(part.p, dtype=np.int64)

    def update_block(self, i: int, w_full: torch.Tensor) -> torch.Tensor:
        """The new fragment of block i from the (stale) view `w_full`, a
        float64 tensor on the run's device; returned on that device."""
        s, e = self.part.block(i)
        w = w_full.cpu().numpy()
        idx = self.rng.integers(0, len(self.task.X), size=self.batch)
        g = self.task.grad(w, idx)
        lr = self.lr / (1.0 + self._t[i] / self.t0)
        self._t[i] += 1
        return torch.as_tensor(w[s:e] - lr * g[s:e], dtype=torch.float64,
                               device=w_full.device)

    def block_work(self, i: int) -> float:
        # gradient cost is the full model per UE (data-parallel-like cost)
        return float(self.task.n_params * self.batch) / self.part.p


@dataclasses.dataclass
class AsyncTrainResult:
    sync_loss: float
    sync_time: float
    sync_iters: int
    async_loss: float
    async_time: float
    async_iters_min: int
    async_iters_max: int
    speedup: float


def run_async_training_sim(p: int = 4, tol: float = 2e-3,
                           ue_speed: Optional[list] = None,
                           cfg: Optional[DESConfig] = None,
                           seed: int = 0,
                           device: DeviceLike = None) -> AsyncTrainResult:
    """Sync vs async parameter-sharded SGD under the paper's models, with
    the DES views on `device` (None: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    task = MLPTask(seed=seed)
    part = block_rows(task.n_params, p)
    cfg = cfg or DESConfig(
        tol=tol, norm="l2", base_flops_rate=2e6, bandwidth=2e5,
        msg_latency=1e-3, cancel_window=0.5, max_iters=3000,
        ue_speed=ue_speed, normalize=False, seed=seed)
    w0 = np.random.default_rng(seed + 1).standard_normal(
        task.n_params) * 0.3

    opr = TrainStaleOperator(task, part, seed=seed)
    sync = AsyncDES(opr, part, cfg, x0=w0, device=dev).run_sync()
    opr2 = TrainStaleOperator(task, part, seed=seed)
    res = AsyncDES(opr2, part, cfg, x0=w0, device=dev).run()

    return AsyncTrainResult(
        sync_loss=task.loss(sync.x),
        sync_time=sync.time, sync_iters=sync.iters,
        async_loss=task.loss(res.x),
        async_time=float(res.local_conv_time.max()),
        async_iters_min=int(res.iters.min()),
        async_iters_max=int(res.iters.max()),
        speedup=float(sync.time / max(res.local_conv_time.max(), 1e-9)),
    )


# ---------------------------------------------------------------------------
# Local-SGD flavor: local-update DP (bounded staleness k), shards on an axis
# ---------------------------------------------------------------------------
def make_local_sgd_step(loss_fn: Callable, lr: float, sync_every: int,
                        n_shards: int):
    """Returns step(params, batches) running `sync_every` local SGD steps on
    each data shard then averaging parameters over the shards — the
    deployable bounded-staleness form: DP collective volume drops by
    sync_every.

    loss_fn(params, batch) -> 0-d tensor, written with torch ops that
    `torch.func` can transform; params: a dict of tensors, the same on
    every shard; batches: a tree of tensors with leading dims
    (n_shards, sync_every, ...).

    The JAX package takes a `Mesh` and an axis name and runs one shard per
    device under `shard_map`, averaging with `pmean`. One card has no mesh:
    `n_shards` takes their place, the shards are a leading tensor axis
    (`torch.func.vmap` of `torch.func.grad`), and the average is a mean
    over that axis."""
    grad_fn = torch.func.grad(loss_fn)

    def shard_body(params, batches):
        for t in range(sync_every):
            g = grad_fn(params, tree_map(lambda b: b[t], batches))
            params = {k: w - lr * g[k] for k, w in params.items()}
        return params

    mapped = torch.func.vmap(shard_body)

    def step(params, batches):
        for b in tree_leaves(batches):
            if tuple(b.shape[:2]) != (n_shards, sync_every):
                raise ValueError(
                    f"batches lead with {tuple(b.shape[:2])}, expected "
                    f"(n_shards, sync_every) = {(n_shards, sync_every)}")
        # params enter replicated: one copy per shard on the leading axis
        tiled = {k: w.expand((n_shards,) + tuple(w.shape))
                 for k, w in params.items()}
        out = mapped(tiled, batches)
        # parameter average == gradient sync with staleness <= sync_every
        return {k: w.mean(dim=0) for k, w in out.items()}

    return step
