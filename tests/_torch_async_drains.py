"""Synthetic shard drains and run guards for the tests of the port's
asynchronous executors (tests/test_torch_runtime_async.py,
test_torch_streaming_async.py, test_torch_query_tier.py, test_torch_gpu.py).

The drains are numpy only: the procpool worker processes build them from
the arena views (pickled factories under "spawn"), and a worker must never
call torch. The block bounds travel with the factory, so importing this
module imports neither package.

`within` runs a call under a wall-clock deadline and fails the test past
it (the tests have no pytest-timeout: a hung worker must not eat the
suite's time limit). `own_segments` lists the port's live /dev/shm
segments created by this process (segment names carry the creator's pid,
so other test files running beside this one never disturb the count).
"""
import os
import threading
import time

import numpy as np

DEADLINE_S = 60.0


def within(fn, *args, seconds=DEADLINE_S, **kw):
    """fn(*args, **kw) on a daemon thread; fails the test when it has not
    returned after `seconds`, and re-raises what it raised."""
    import pytest
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as exc:      # re-raised in the test's thread
            out["error"] = exc
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"{getattr(fn, '__name__', fn)} did not finish within "
                    f"{seconds} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def own_segments():
    """This process's live port segments."""
    from repro_torch.runtime import live_segments
    pid = str(os.getpid())
    return [nm for nm in live_segments() if nm.split("_")[-2] == pid]


def blocks(n, p):
    """The row blocks of `core.partition.block_rows(n, p)`: consecutive
    ceil(n/p) rows."""
    size = -(-n // p)
    return [(min(i * size, n), min((i + 1) * size, n)) for i in range(p)]


def absorb(r, bounds, ship=0.2):
    """Keep 30% of a shard's own mass, ship `ship` of it to its
    successor's rows, absorb the rest."""
    p = len(bounds)

    def drain_fn(i, s, e, step_target, outbox):
        own = r[s:e]
        if float(np.abs(own).sum()) <= step_target:
            return 0, 0.0
        moved = own.copy()
        own[:] = 0.0
        ns, _ = bounds[(i + 1) % p]
        outbox[ns:ns + moved.size] += ship * moved
        r[s:e] += 0.3 * moved
        return moved.size, 0.0
    return drain_fn


class AbsorbDrain:
    """Picklable DrainFactory over `absorb`."""

    def __init__(self, n, p):
        self.bounds = blocks(n, p)

    def __call__(self, views):
        return absorb(views["r"], self.bounds)


class NeverConverges:
    """Claims a push a round and removes no mass: only a cap ends it."""

    def __call__(self, views):
        def drain_fn(i, s, e, step_target, outbox):
            return 1, 0.0
        return drain_fn


class Crasher:
    """Shard 0 raises on its third drain."""

    def __call__(self, views):
        calls = [0]
        lock = threading.Lock()

        def drain_fn(i, s, e, step_target, outbox):
            if i == 0:
                with lock:
                    calls[0] += 1
                    if calls[0] > 2:
                        raise ValueError("synthetic shard failure")
            time.sleep(0.001)
            return 1, 0.0
        return drain_fn
