"""Parity of repro_torch's device shard transport (`runtime/device.py`,
`DeviceShardTransport.run`) with the JAX package's, on the CPU.

The JAX package's transport needs one device per shard, so a module fixture
runs every reference drain once, in ONE subprocess with four forced host
devices (`_subproc`), and writes the results to an .npz in tmp_path; its
float64 drains scope x64 with `jax.experimental.enable_x64`, which JAX 0.9
removed, so the subprocess supplies it first (as `_torch_parity.ref_x64`
does in-process). The port then drains the same operator in this process
on `device="cpu"` (its kernels' plain versions), the p = 4 shards on one
leading tensor axis. The operator is conftest's `small_op` graph (2,000
pages), rebuilt from its seed in the subprocess.

Tolerances, and why:
  * float64 segment sum, each schedule (and the adaptive sparsified
    payload, and the float64 block drain, whose plain lane sums in
    float64): equal supersteps, rows sent, full refreshes, bytes and
    verdict, x within L1 1e-12 — the two programs take the same decisions
    and differ only in the order of a few float64 sums;
  * float32 block drains, "f32" and "kahan" lanes, at target 1e-6: the
    same verdict, supersteps within 2, and x within L1 2e-6 of the
    reference's (the views are float32, and the port's hub rows sum in
    float64 where the reference's sum in float32) and within 1e-5 of the
    float64 oracle (the target leaves up to target / (1 - alpha) of
    iteration error).
"""
import numpy as np
import pytest
import torch

from _subproc import run_with_devices

from repro_torch.interop import operator_from_arrays
from repro_torch.runtime import DeviceShardTransport, comm_bytes_model

from _torch_parity import op_arrays

REF_CODE = r'''
import sys
import numpy as np
import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
import repro.core  # noqa: F401  (resolves the runtime<->core import cycle)
from repro.graph.csr import TransitionT
from repro.graph.generate import powerlaw_webgraph
from repro.graph.google import GoogleOperator
from repro.runtime import DeviceShardTransport

g = powerlaw_webgraph(n=2000, target_nnz=16000, n_dangling=10, seed=7)
op = GoogleOperator(pt=TransitionT.from_graph(g), alpha=0.85)
x0 = np.full(op.n, 1.0 / op.n)
out = {}
for name, (kw, target) in CASES.items():
    r = DeviceShardTransport(4, **kw).run(op, x0, target=target)
    out[name + "__x"] = r.x
    for k in ("supersteps", "rows_sent", "fulls", "comm_bytes_total",
              "converged", "device_resid"):
        out[name + "__" + k] = np.asarray(getattr(r, k))
np.savez(sys.argv[1], **out)
print("reference drains done")
'''

F64 = 1e-9          # the float64 drains' L1 target
F32 = 1e-6          # the float32 block drains'
CASES = {
    **{f"f64_{s}": (dict(exchange=s), F64)
       for s in ("allgather", "allgather_k", "ring", "sparsified")},
    "f64_sparsified_adaptive": (dict(exchange="sparsified",
                                     sparsify_adaptive=True), F64),
    "f64_bsr": (dict(backend="bsr_pallas", bsr_bm=8), F64),
    **{f"f32_bsr_{a}_{s}": (dict(exchange=s, dtype="float32",
                                 backend="bsr_pallas", bsr_bm=8, accum=a),
                            F32)
       for a in ("f32", "kahan") for s in ("sparsified", "allgather")},
}
EXACT = [k for k in CASES if k.startswith("f64")]
F32_CASES = [k for k in CASES if k.startswith("f32")]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference drain, from one subprocess with 4 host devices."""
    path = tmp_path_factory.mktemp("device_ref") / "ref.npz"
    code = ("import sys\nsys.argv = ['ref', %r]\n" % str(path)
            + f"CASES = {CASES!r}\n" + REF_CODE)
    out = run_with_devices(code, n_devices=4, timeout=600)
    assert "reference drains done" in out
    data = np.load(path)
    return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def t_op(small_op):
    return operator_from_arrays(op_arrays(small_op))


def drain(t_op, name):
    kw, target = CASES[name]
    x0 = np.full(t_op.n, 1.0 / t_op.n)
    return DeviceShardTransport(4, device="cpu", **kw).run(t_op, x0,
                                                           target=target)


def exact_residual(op, x):
    """||x - (alpha (P^T x + w d^T x) + (1 - alpha) v)||_1 on the host in
    float64: the linear form's residual."""
    return float(np.abs(op.apply_linear_numpy(x) - x).sum())


@pytest.mark.parametrize("name", EXACT)
def test_f64_drains_match_reference(ref, t_op, name):
    r = drain(t_op, name)
    for k in ("supersteps", "rows_sent", "fulls", "comm_bytes_total",
              "converged"):
        assert getattr(r, k) == ref[f"{name}__{k}"].item(), k
    assert r.converged
    assert float(np.abs(r.x - ref[f"{name}__x"]).sum()) <= 1e-12
    assert r.device_resid == pytest.approx(
        ref[f"{name}__device_resid"].item(), rel=1e-6)
    # the drain's own verdict is no certificate; the host residual is.
    # The block drain's blocks are float32 weights (a relative error up to
    # 2^-24 each), which floors its residual against the float64 operator
    # near 5e-8
    floor = 1e-7 if name == "f64_bsr" else 10 * CASES[name][1]
    assert exact_residual(t_op, r.x) <= floor


@pytest.mark.parametrize("name", F32_CASES)
def test_f32_block_drains_match_reference(ref, t_op, small_op, exact_x,
                                          name):
    r = drain(t_op, name)
    assert r.converged == bool(ref[f"{name}__converged"]) is True
    assert abs(r.supersteps - int(ref[f"{name}__supersteps"])) <= 2
    x_j = ref[f"{name}__x"]
    assert float(np.abs(r.x - x_j).sum()) <= 2e-6
    # a delta L1 of `target` leaves up to target / (1 - alpha) = 6.7e-6 of
    # iteration error, plus the float32 rounding
    assert float(np.abs(r.x / r.x.sum() - exact_x).sum()) <= 1e-5
    assert r.comm_bytes_total == comm_bytes_model(
        CASES[name][0]["exchange"], p=4, bsize=504, itemsize=4, nv=1,
        steps=r.supersteps, rows=r.rows_sent, fulls=r.fulls)


def test_kahan_lane_is_a_lane(t_op):
    """The "kahan" drain runs the compensated plain lane, not the f32 one:
    same verdict, different bits."""
    a = drain(t_op, "f32_bsr_f32_allgather")
    b = drain(t_op, "f32_bsr_kahan_allgather")
    assert a.converged and b.converged
    assert not np.array_equal(a.x, b.x)


def test_transport_validation(t_op, monkeypatch):
    with pytest.raises(ValueError, match="schedule"):
        DeviceShardTransport(2, exchange="gossip")
    with pytest.raises(ValueError, match="backend"):
        DeviceShardTransport(2, backend="cusparse")
    with pytest.raises(ValueError, match="accum"):
        DeviceShardTransport(2, accum="f16")
    t = DeviceShardTransport(2, device="cpu")
    with pytest.raises(ValueError, match="x0 has shape"):
        t.run(t_op, np.ones(3), target=1e-6)
    with pytest.raises(ValueError, match="single-lane"):
        t.run(t_op, np.ones(t_op.n), target=1e-6,
              v=np.ones((t_op.n, 2)) / t_op.n)
    # device=None is the CUDA card: without one, raise (no CPU fallback)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceShardTransport(2).run(t_op, np.ones(t_op.n) / t_op.n,
                                    target=1e-6)
