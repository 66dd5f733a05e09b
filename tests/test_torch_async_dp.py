"""Parity of repro_torch's asynchronous training (`training/async_dp.py`)
with the JAX package's, on the CPU.

The DES flavor takes its gradients in host numpy and draws its minibatches
from the operator's numpy Generator in the JAX package's order, so the
sync and async runs equal the reference's: iterations exactly, simulated
times and losses to 1e-12 relative (p = 4, seed 0: sync 866 iterations,
async 536-538 and speedup 3.888; with one UE at 0.3x speed async 545-1136
and speedup 2.614). The local-SGD step keeps the shards on a leading tensor
axis: at one shard it equals the JAX package's step on a one-device mesh
(rtol 1e-5, float32), and at four it equals a numpy rendering of the mean
of four local SGD runs (rtol 1e-5) and meets the reference's convergence
claim (max error < 0.05 after 30 steps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.async_dp import MLPTask as JMLPTask
from repro.training.async_dp import make_local_sgd_step as j_local_sgd
from repro.training.async_dp import run_async_training_sim as j_run
from repro_torch.training import (MLPTask, TrainStaleOperator,
                                  make_local_sgd_step,
                                  run_async_training_sim)

STRAGGLER = [1, 1, 1, 0.3]
CASES = {"uniform": None, "straggler": STRAGGLER}


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs at p = 4, seed 0, once per case."""
    cache = {}

    def get(case):
        if case not in cache:
            us = CASES[case]
            cache[case] = (
                j_run(p=4, ue_speed=us, seed=0),
                run_async_training_sim(p=4, ue_speed=us, seed=0,
                                       device="cpu"))
        return cache[case]
    return get


def test_mlp_task_grad_correct():
    """Analytic grad vs finite differences."""
    task = MLPTask(d_in=4, d_hidden=3, n_data=32, seed=1)
    rng = np.random.default_rng(0)
    w = rng.standard_normal(task.n_params) * 0.3
    idx = np.arange(32)
    g = task.grad(w, idx)

    def loss_at(w):
        w1, w2 = task.unpack(w)
        pred = np.tanh(task.X @ w1.T) @ w2.T
        return np.mean((pred - task.Y) ** 2)

    eps = 1e-6
    for k in rng.choice(task.n_params, 5, replace=False):
        wp = w.copy(); wp[k] += eps
        wm = w.copy(); wm[k] -= eps
        fd = (loss_at(wp) - loss_at(wm)) / (2 * eps)
        assert abs(fd - g[k]) < 1e-5


def test_mlp_task_matches_reference():
    task, jtask = MLPTask(seed=3), JMLPTask(seed=3)
    np.testing.assert_array_equal(task.X, jtask.X)
    np.testing.assert_array_equal(task.Y, jtask.Y)
    w = np.random.default_rng(4).standard_normal(task.n_params)
    idx = np.random.default_rng(5).integers(0, 2048, 256)
    np.testing.assert_array_equal(task.grad(w, idx), jtask.grad(w, idx))
    assert task.loss(w) == jtask.loss(w) and task.n_params == 544


def test_update_block_returns_fragment_on_view_device():
    from repro_torch.core.partition import block_rows
    task = MLPTask()
    part = block_rows(task.n_params, 4)
    opr = TrainStaleOperator(task, part)
    w = torch.zeros(task.n_params, dtype=torch.float64)
    out = opr.update_block(2, w)
    s, e = part.block(2)
    assert out.dtype == torch.float64 and out.device == w.device
    assert out.shape == (e - s,) and opr._t.tolist() == [0, 0, 1, 0]


def test_async_training_reaches_comparable_loss(runs):
    _, r = runs("uniform")
    assert r.async_loss < 2.0 * max(r.sync_loss, 1e-3)
    assert r.speedup > 1.0


def test_straggler_mitigation(runs):
    """One 0.3x-speed UE: sync pays the full straggler tax every iteration;
    async keeps the fast UEs productive."""
    _, r = runs("straggler")
    assert r.speedup > 1.5
    assert r.async_iters_min < r.async_iters_max  # UEs decoupled


@pytest.mark.parametrize("case", list(CASES))
def test_async_training_matches_reference(runs, case):
    ref, r = runs(case)
    for f in ("sync_iters", "async_iters_min", "async_iters_max"):
        assert getattr(r, f) == getattr(ref, f), f
    for f in ("sync_time", "async_time", "speedup", "sync_loss",
              "async_loss"):
        assert getattr(r, f) == pytest.approx(getattr(ref, f), rel=1e-12), f
    golden = {"uniform": (866, 536, 538, 3.888),
              "straggler": (866, 545, 1136, 2.614)}[case]
    assert (r.sync_iters, r.async_iters_min, r.async_iters_max) == golden[:3]
    assert round(r.speedup, 3) == golden[3]


def test_training_sim_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_async_training_sim(p=2, seed=0)


def _lsq_loss(p, batch):
    x, y = batch
    return torch.mean((x @ p["w"] - y) ** 2)


def _j_lsq_loss(p, batch):
    x, y = batch
    return jnp.mean((x @ p["w"] - y) ** 2)


def test_local_sgd_step_single_shard_matches_sgd():
    """sync_every local steps on ONE shard == plain SGD (the mean is a
    no-op)."""
    step = make_local_sgd_step(_lsq_loss, lr=0.1, sync_every=4, n_shards=1)
    rng = np.random.default_rng(0)
    w0 = {"w": torch.as_tensor(rng.standard_normal((3, 1)),
                               dtype=torch.float32)}
    xs = torch.as_tensor(rng.standard_normal((1, 4, 8, 3)),
                         dtype=torch.float32)
    ys = torch.as_tensor(rng.standard_normal((1, 4, 8, 1)),
                         dtype=torch.float32)
    out = step(w0, (xs, ys))

    w_ref = w0
    for t in range(4):
        g = torch.func.grad(_lsq_loss)(w_ref, (xs[0, t], ys[0, t]))
        w_ref = {k: w - 0.1 * g[k] for k, w in w_ref.items()}
    np.testing.assert_allclose(out["w"].numpy(), w_ref["w"].numpy(),
                               rtol=1e-5)


def test_local_sgd_single_shard_matches_reference():
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((3, 1)).astype(np.float32)
    xs = rng.standard_normal((1, 4, 8, 3)).astype(np.float32)
    ys = rng.standard_normal((1, 4, 8, 1)).astype(np.float32)
    mesh = jax.make_mesh((1,), ("data",))
    jstep = j_local_sgd(_j_lsq_loss, lr=0.1, sync_every=4, mesh=mesh)
    ref = jstep({"w": jnp.asarray(w0)}, (jnp.asarray(xs), jnp.asarray(ys)))
    step = make_local_sgd_step(_lsq_loss, lr=0.1, sync_every=4, n_shards=1)
    out = step({"w": torch.from_numpy(w0)},
               (torch.from_numpy(xs), torch.from_numpy(ys)))
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(ref["w"]),
                               rtol=1e-5)


def _numpy_local_sgd(w, xs, ys, lr):
    """The mean over shards of `sync_every` SGD steps each, in float64."""
    outs = []
    for s in range(xs.shape[0]):
        ws = w.astype(np.float64)
        for t in range(xs.shape[1]):
            x, y = xs[s, t].astype(np.float64), ys[s, t].astype(np.float64)
            ws = ws - lr * 2.0 * x.T @ (x @ ws - y) / y.size
        outs.append(ws)
    return np.mean(outs, axis=0)


def test_local_sgd_four_shards_matches_numpy():
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((3, 1)).astype(np.float32)
    xs = rng.standard_normal((4, 4, 16, 3)).astype(np.float32)
    ys = rng.standard_normal((4, 4, 16, 1)).astype(np.float32)
    step = make_local_sgd_step(_lsq_loss, lr=0.05, sync_every=4, n_shards=4)
    out = step({"w": torch.from_numpy(w0)},
               (torch.from_numpy(xs), torch.from_numpy(ys)))
    np.testing.assert_allclose(out["w"].numpy(),
                               _numpy_local_sgd(w0, xs, ys, 0.05),
                               rtol=1e-5)


def test_local_sgd_converges_four_shards():
    """The reference's claim at p = 4 (tests/test_spmd_multidevice.py::
    test_local_sgd_reduces_comm_4dev): 30 averaged rounds of 4 local steps
    recover the least-squares weights within 0.05."""
    step = make_local_sgd_step(_lsq_loss, lr=0.05, sync_every=4, n_shards=4)
    rng = np.random.default_rng(0)
    wt = rng.standard_normal((3, 1))
    w = {"w": torch.zeros((3, 1), dtype=torch.float32)}
    for _ in range(30):
        xs = rng.standard_normal((4, 4, 16, 3)).astype(np.float32)
        ys = np.einsum("sbnd,df->sbnf", xs, wt).astype(np.float32)
        w = step(w, (torch.from_numpy(xs), torch.from_numpy(ys)))
    err = float(np.abs(w["w"].numpy() - wt).max())
    assert err < 0.05, err


def test_local_sgd_checks_batch_shape():
    step = make_local_sgd_step(_lsq_loss, lr=0.1, sync_every=4, n_shards=2)
    xs = torch.zeros((1, 4, 8, 3))
    with pytest.raises(ValueError, match="n_shards"):
        step({"w": torch.zeros((3, 1))}, (xs, xs[..., :1]))
