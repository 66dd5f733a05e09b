"""Parity of the port's shared shard-program pieces with the JAX package's,
in this process: the Fig. 1 state machines (`core.termination`), the
`TerminationDriver` renderings, the partitions, the delivery-draw hash, the
byte model and the reduction seam. All of it is exact: the same inputs give
the same transitions, integers and float32 bits.

The state machines are driven by scripts (the cases of
tests/test_termination.py and tests/test_termination_edges.py, then seeded
random ones) that run once against each package's module and record every
transition; the two transcripts must be equal.
"""
import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.partition as j_part
import repro.core.termination as j_term
import repro.runtime.driver as j_driver
import repro.runtime.step as j_step
import repro.runtime.transport as j_transport
import repro_torch.core.partition as t_part
import repro_torch.core.termination as t_term
import repro_torch.runtime.driver as t_driver
import repro_torch.runtime.step as t_step
import repro_torch.runtime.transport as t_transport
from repro_torch.interop import operator_from_arrays

from _torch_parity import op_arrays


def _plain(obj):
    """A transcript entry: dataclasses as tuples, enums by name."""
    if isinstance(obj, enum.Enum):
        return obj.name
    if dataclasses.is_dataclass(obj):
        return tuple((f.name, _plain(getattr(obj, f.name)))
                     for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_plain(o) for o in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, _plain(v)) for k, v in obj.items()))
    return obj


# ---- scripts: each takes a termination module and returns a transcript --
def ue_script(pc_max, checks, stop_at=None):
    def run(term):
        s, out = term.ComputingUEState(pc_max=pc_max), []
        for i, c in enumerate(checks):
            if i == stop_at:
                s = s.stop()
            s, m = s.step(c)
            out.append((_plain(s), _plain(m)))
        return out
    return run


def monitor_script(p, pc_max, ops):
    """ops: ("recv", ue, "CONVERGE" | "DIVERGE") or ("step",)."""
    def run(term):
        mon, out = term.MonitorState.create(p, pc_max=pc_max), []
        for op in ops:
            if op[0] == "recv":
                mon = mon.recv(op[1], term.Msg[op[2]])
                out.append(_plain(mon))
            else:
                mon, stop = mon.step()
                out.append((_plain(mon), stop))
        return out
    return run


def protocol_script(p, pc_c, pc_m, events):
    def run(term):
        proto, out = term.CentralizedProtocol(p, pc_c, pc_m), []
        for ue, conv in events:
            out.append((proto.report(ue, conv), _plain(proto.ues),
                        _plain(proto.monitor)))
        return out
    return run


def tree_script(p, pc_max, events):
    def run(term):
        proto, out = term.TreeProtocol(p, pc_max=pc_max), []
        for ue, conv in events:
            out.append((proto.report(ue, conv),
                        _plain([proto.nodes[i] for i in range(p)])))
        return out
    return run


def _random_events(seed, p, n, bias):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(p)), bool(rng.random() < bias))
            for _ in range(n)]


FIXED = {
    "converge_after_pcmax": ue_script(3, [True] * 5),
    "diverge_resets": ue_script(1, [True, False, True]),
    "diverge_persistence": ue_script(
        3, [True] * 3 + [False, True, False, True, True, True]),
    "pc_beyond_pcmax": ue_script(2, [True] * 6),
    "stopped_ue_ignores_checks": ue_script(1, [True, False, True], 1),
    "monitor_stop_requires_all": monitor_script(3, 1, [
        ("recv", 0, "CONVERGE"), ("step",), ("recv", 1, "CONVERGE"),
        ("step",), ("recv", 2, "CONVERGE"), ("step",)]),
    "monitor_diverge_cancels": monitor_script(2, 2, [
        ("recv", 0, "CONVERGE"), ("recv", 1, "CONVERGE"), ("step",),
        ("recv", 0, "DIVERGE"), ("step",)]),
    "monitor_pcmax_persistence": monitor_script(2, 3, [
        ("recv", 0, "CONVERGE"), ("recv", 1, "CONVERGE"), ("step",),
        ("step",), ("recv", 1, "DIVERGE"), ("step",),
        ("recv", 1, "CONVERGE"), ("step",), ("step",), ("step",)]),
    "stop_races_in_flight_converge": monitor_script(2, 1, [
        ("recv", 0, "CONVERGE"), ("recv", 1, "CONVERGE"), ("step",),
        ("recv", 1, "DIVERGE"), ("step",), ("recv", 1, "CONVERGE"),
        ("step",)]),
    "protocol_end_to_end": protocol_script(3, 2, 1, [
        (ue, ue < 2 or t != 1) for t in range(6) for ue in range(3)]),
    "protocol_stop_latches": protocol_script(
        2, 1, 1, [(0, True), (1, True), (0, False), (1, True)]),
    "protocol_no_stop_without_coverage": protocol_script(
        3, 2, 3, [(ue, ue != 2) for _ in range(20) for ue in range(3)]),
    "tree_stop_requires_all": tree_script(7, 1, [
        (ue, not (ue == 3 and t < 2)) for t in range(4) for ue in range(7)]),
    "tree_diverge_retracts_subtree": tree_script(3, 1, [
        (1, True), (2, True), (1, False), (0, True), (1, True), (0, True)]),
}
RANDOM = {}
for seed in range(6):
    RANDOM[f"ue_random_{seed}"] = ue_script(
        1 + seed % 4, [bool(b) for b in
                       np.random.default_rng(seed).random(60) < 0.7])
    RANDOM[f"protocol_random_{seed}"] = protocol_script(
        4, 1 + seed % 3, 1 + seed % 2, _random_events(seed, 4, 150, 0.8))
    RANDOM[f"tree_random_{seed}"] = tree_script(
        3 + seed, 1 + seed % 3, _random_events(seed, 3 + seed, 150, 0.8))
    ops = []
    rng = np.random.default_rng(100 + seed)
    for _ in range(80):
        if rng.random() < 0.6:
            ops.append(("recv", int(rng.integers(3)),
                        "CONVERGE" if rng.random() < 0.7 else "DIVERGE"))
        else:
            ops.append(("step",))
    RANDOM[f"monitor_random_{seed}"] = monitor_script(3, 1 + seed % 3, ops)


@pytest.mark.parametrize("name", sorted({**FIXED, **RANDOM}))
def test_state_machines_match(name):
    script = {**FIXED, **RANDOM}[name]
    assert script(t_term) == script(j_term)


@pytest.mark.parametrize("seed", range(4))
def test_driver_renderings_match(seed):
    """TerminationDriver's message and value renderings, with restarts and
    stops, over one seeded script."""
    p = 3 + seed % 2
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(120):
        r = rng.random()
        if r < 0.5:
            script.append(("ue_step", int(rng.integers(p)),
                           bool(rng.random() < 0.75)))
        elif r < 0.8:
            script.append(("allreduce", rng.random(p) * 2e-3))
        elif r < 0.9:
            script.append(("restart", int(rng.integers(p))))
        else:
            script.append(("stop", int(rng.integers(p))))

    def run(driver_mod):
        d = driver_mod.TerminationDriver(p, pc_max_compute=1 + seed % 2,
                                         pc_max_monitor=1 + seed % 3)
        out = []
        for op in script:
            if op[0] == "ue_step":
                msg = d.ue_step(op[1], op[2])
                stop = d.monitor_recv(op[1], msg) if msg is not None else None
                out.append((_plain(msg), stop))
            elif op[0] == "allreduce":
                out.append(d.allreduce_step(op[1], target=2.5e-3))
            elif op[0] == "restart":
                d.restart_shard(op[1])
            else:
                d.stop_shard(op[1])
            out.append((_plain(d.ues), _plain(d.monitor), d.stopped))
        return out
    assert run(t_driver) == run(j_driver)
    with pytest.raises(ValueError, match="per-shard"):
        t_driver.TerminationDriver(3).allreduce_step([1.0, 2.0], 1.0)


@pytest.mark.parametrize("pc_c,pc_m", [(1, 1), (2, 1), (1, 3), (3, 2)])
def test_bits_step_matches(pc_c, pc_m):
    """bits_step over a (p, nv) bit sequence: the port's with a sum over
    the leading shard axis, the reference's with the same sum in jnp."""
    p, nv, steps = 4, 3, 40
    bits = np.random.default_rng(pc_c * 10 + pc_m).random((steps, p, nv))
    bits = bits < 0.85
    pc_t = mon_t = torch.zeros((p, nv), dtype=torch.int32)
    pc_j = mon_j = jnp.zeros((p, nv), jnp.int32)
    for s in range(steps):
        pc_t, mon_t, done_t = t_driver.TerminationDriver.bits_step(
            bits[s], pc_t, mon_t, p=p, pc_max_compute=pc_c,
            pc_max_monitor=pc_m, psum=t_transport.mesh_psum())
        pc_j, mon_j, done_j = j_driver.TerminationDriver.bits_step(
            jnp.asarray(bits[s]), pc_j, mon_j, p=p, pc_max_compute=pc_c,
            pc_max_monitor=pc_m,
            psum=lambda a: jnp.sum(a, axis=0, keepdims=True))
        np.testing.assert_array_equal(pc_t.numpy(), np.asarray(pc_j))
        np.testing.assert_array_equal(mon_t.numpy(),
                                      np.broadcast_to(np.asarray(mon_j),
                                                      (p, nv)))
        np.testing.assert_array_equal(
            np.broadcast_to(done_t.numpy(), (p, nv)),
            np.broadcast_to(np.asarray(done_j), (p, nv)))
        assert pc_t.dtype == torch.int32 and mon_t.dtype == torch.int32
    # one shard's bits with a plain sum, as the host tests pass it
    pc, mon, done = t_driver.TerminationDriver.bits_step(
        np.array([True, False]), np.array([1, 0]), np.array([0, 0]), p=1,
        pc_max_compute=2, pc_max_monitor=1, psum=lambda a: a)
    assert pc.tolist() == [2, 0] and done.tolist() == [True, False]


def test_hash_uniform_matches_bit_for_bit():
    steps = np.arange(0, 3000, 7)
    for seed in (0, 9, 12345, 2 ** 31 + 5, 2 ** 40 + 3):
        for shard in range(8):
            want = np.asarray(j_step.hash_uniform(
                seed, jnp.asarray(steps, jnp.int32),
                jnp.asarray(shard, jnp.int32)))
            got = t_step.hash_uniform(seed, steps, shard)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
    # the drop draws compare in float32: 0.7 is 0.699999988 there
    d = t_step.hash_uniform(9, 5, np.arange(4))
    assert np.array_equal(d < np.float32(0.7),
                          np.asarray(j_step.hash_uniform(
                              9, jnp.int32(5), jnp.arange(4)) < 0.7))


@pytest.mark.parametrize("schedule", ["allgather", "allgather_k", "ring",
                                      "sparsified"])
def test_comm_bytes_model_matches(schedule):
    rng = np.random.default_rng(len(schedule))
    for _ in range(50):
        kw = dict(p=int(rng.integers(1, 9)), bsize=int(rng.integers(1, 10**5)),
                  itemsize=int(rng.choice([4, 8])),
                  nv=int(rng.integers(1, 17)), steps=int(rng.integers(0, 999)),
                  rows=int(rng.integers(0, 10**6)),
                  fulls=int(rng.integers(0, 99)),
                  sync_every=int(rng.integers(1, 9)))
        got = t_step.comm_bytes_model(schedule, **kw)
        assert got == j_step.comm_bytes_model(schedule, **kw)
        assert isinstance(got, int)
    # the issue's Stanford-scale reading: 1,560,000 vs 1,567,488 bytes for
    # 26 allgather supersteps of the 5,000-page graph (bsize 1250 vs 1256)
    for bsize, want in ((1250, 1_560_000), (1256, 1_567_488)):
        assert t_step.comm_bytes_model("allgather", p=4, bsize=bsize,
                                       itemsize=4, nv=1, steps=26, rows=0,
                                       fulls=0) == want


@pytest.mark.parametrize("p", [1, 3, 4, 7, 16])
def test_partitions_match(small_op, p):
    pt_j = small_op.pt
    op_t = operator_from_arrays(op_arrays(small_op))
    for fn in ("block_rows", "balanced_nnz"):
        arg_j = pt_j.n if fn == "block_rows" else pt_j
        arg_t = op_t.n if fn == "block_rows" else op_t.pt
        a = getattr(j_part, fn)(arg_j, p)
        b = getattr(t_part, fn)(arg_t, p)
        np.testing.assert_array_equal(a.starts, b.starts)
        np.testing.assert_array_equal(a.ends, b.ends)
        assert a.n == b.n and a.p == b.p
        for row in (0, pt_j.n // 2, pt_j.n - 1):
            assert a.owner_of(row) == b.owner_of(row)
        for i in range(p):
            sa = j_part.slice_transition(pt_j, a, i)
            sb = t_part.slice_transition(op_t.pt, b, i)
            assert sa.keys() == sb.keys()
            for k in sa:
                np.testing.assert_array_equal(sa[k], sb[k])


def test_reduction_seam():
    vals = [1e-3, 2.5e-4, 3.0]
    assert t_transport.HostAllReduce().all_reduce(vals) == \
        j_transport.HostAllReduce().all_reduce(vals)
    a = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    s = t_transport.mesh_psum()(a)
    assert s.shape == (1, 3) and s.dtype == torch.int32
    assert s.tolist() == [[18, 22, 26]]
