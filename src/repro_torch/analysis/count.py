"""The dry run's counter: a step run on the meta device, counted op by op.

It stands in for what the JAX package reads from a compiled XLA program
(`compiled.cost_analysis()` and `compiled.memory_analysis()`,
repro/launch/dryrun.py): the port has no compiled program, so
`StepCounter`, a TorchDispatchMode, watches every aten op of the step as
it runs on tensors that hold no data, and the LM kernels' meta lanes book
their launches to it (`kernels.book`). It records:

* FLOPs: the aten ops' by `torch.utils.flop_counter`'s own formulas (the
  products: mm, bmm, addmm, baddbmm and those einsum becomes; elementwise
  work is not counted), plus each kernel booking's, by the formulas of
  `analysis.bounds`;
* HBM bytes: each aten op's operand and result bytes (device tensors
  only), and each kernel booking's. This is the port's count, not XLA's
  fused one: an eager program reads its operands and writes its results
  at every op. Views and ops that only allocate (empty) move nothing and
  count nothing;
* memory, under the JAX record's field names (`Memory`): the step's
  arguments, its results, the peak of live storage bytes (each storage
  held from its first appearance until it is freed, through a weak
  reference whose callback subtracts it), the temporaries above the
  arguments, and the state the step updates in place. Live bytes are
  counted as the card's caching allocator counts them, each storage
  rounded up to ALLOC_GRANULE bytes;
* the kernel bookings, by kernel: calls, launches by the kernel's own
  LAUNCHES keys, FLOPs by type and bytes.

A storage that an op allocates and frees inside itself (a temporary of a
native kernel) is not seen: only the ops' results are.

The meta device's kernels are mostly Python, and they dominate a count's
time. A functional op's results on the meta device depend only on its
operands' shapes, strides and dtypes and its other arguments, so the
counter keeps, for each such signature, the results' shapes, strides and
dtypes, its FLOPs and its bytes, and makes later results of it with
`torch.empty_strided`: the same tensors, op by op, counted the same
(`tests/test_torch_launch.py` holds a count with the memo to one
without). Views, in-place ops and ops whose results are not fresh
storages always run.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import BOOKING_SINKS

# the CUDA caching allocator's block granularity: every allocation is
# rounded up to a multiple of it, and torch.cuda.memory_allocated counts
# the rounded size
ALLOC_GRANULE = 512

aten = torch.ops.aten
# ops that allocate without reading or writing memory
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten.lift_fresh.default,
             aten.detach.default}


class _Unmemoized(Exception):
    pass


def _signature(x):
    """A hashable key of an op's argument, or _Unmemoized."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Unmemoized
        return (x.shape, x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_signature(v) for v in x))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.memory_format,
                                   torch.layout)):
        return (type(x), x)
    raise _Unmemoized


def _fresh_results(out, args) -> Optional[tuple]:
    """(is_tuple, (shape, stride, dtype) of each result) where every
    result is a tensor in a storage of its own that empty_strided would
    make (offset 0, no operand's storage), else None."""
    results = out if isinstance(out, (tuple, list)) else (out,)
    taken = {t.untyped_storage()._cdata for t in tensors(args)}
    metas = []
    for t in results:
        if not isinstance(t, torch.Tensor) or not t.is_meta:
            return None
        st = t.untyped_storage()
        extent = (1 + sum((n - 1) * d for n, d in zip(t.shape, t.stride()))
                  if t.numel() else 0)
        if (t.storage_offset() or st._cdata in taken
                or st.nbytes() != extent * t.element_size()):
            return None
        taken.add(st._cdata)
        metas.append((t.shape, t.stride(), t.dtype))
    return isinstance(out, (tuple, list)), tuple(metas)


# signature -> (results, FLOPs, bytes), or None where the op always runs
_MEMO: Dict[tuple, Optional[tuple]] = {}


def block_bytes(nbytes: int) -> int:
    """Bytes the card's allocator holds for a storage of `nbytes`."""
    return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE


def tensors(tree) -> Iterable[torch.Tensor]:
    """The device tensors among a tree's leaves (dicts, lists, tuples):
    host (CPU) tensors, such as a scalar made to be read with .item(),
    hold no device memory and are left out."""
    return (t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.device.type != "cpu")


def storage_bytes(tree) -> int:
    """The allocator's bytes of the distinct storages of a tree's
    tensors."""
    seen: Dict[int, int] = {}
    for t in tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = block_bytes(st.nbytes())
    return sum(seen.values())


@dataclasses.dataclass
class Memory:
    """A step's memory, under the names of the JAX record's
    `memory_analysis()` fields, each in bytes of the card's allocator:

    argument_size_in_bytes  the tensors the step is given (parameters,
                            optimizer state, batch, cache), live before it
    output_size_in_bytes    the tensors it returns, state it updated in
                            place included (as XLA counts aliased outputs)
    temp_size_in_bytes      the peak of live bytes during the step less
                            the arguments: its activations, gradients,
                            workspaces and temporaries at their worst
    alias_size_in_bytes     the state it updates in place: the parameters
                            and moments of a train step, the cache of a
                            decode step (0 for a prefill)
    peak_bytes              arguments + temporaries at the peak
    """
    argument_size_in_bytes: int = 0
    output_size_in_bytes: int = 0
    temp_size_in_bytes: int = 0
    alias_size_in_bytes: int = 0
    peak_bytes: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Counts:
    """What one counted step came to: FLOPs and bytes (aten ops and kernel
    bookings together, and apart), the memory, the kernel bookings by
    kernel and the aten ops run."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    aten_flops: float = 0.0
    aten_bytes: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    ops: int = 0
    memory: Memory = dataclasses.field(default_factory=Memory)
    kernels: Dict[str, dict] = dataclasses.field(default_factory=dict)


def _new_booking() -> dict:
    return {"calls": 0, "launches": {}, "flops": {}, "bytes": 0.0}


class StepCounter(TorchDispatchMode):
    """Counts what runs under it (module docstring). Use:

        counter = StepCounter()
        counter.hold(args)              # the arguments, live before
        with counter:
            out = step(*args)
        counts = counter.counts(out, alias=state)
    """

    def __init__(self):
        super().__init__()
        self.aten_flops = 0.0
        self.aten_bytes = 0.0
        self.ops = 0
        self.kernels: Dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self.arguments = 0
        self._storages: Dict[int, weakref.ref] = {}

    # --------------------------------------------------------------- memory
    def _track(self, t: torch.Tensor) -> int:
        """Hold t's storage as live from now until it is freed; the bytes
        it adds (0 for one already held)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        nbytes = block_bytes(st.nbytes())

        def freed(_, key=key, nbytes=nbytes):
            self.live -= nbytes
            self._storages.pop(key, None)
        self._storages[key] = weakref.ref(st, freed)
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        return nbytes

    def hold(self, *trees) -> int:
        """Hold the tensors of `trees` as the step's arguments, live from
        before it; returns the bytes they add."""
        added = sum(self._track(t) for t in tensors(trees))
        self.arguments += added
        return added

    # ---------------------------------------------------------- dispatching
    def _book(self, kernel: str, launches: Dict[str, int],
              flops: Dict[str, float], nbytes: float) -> None:
        b = self.kernels.setdefault(kernel, _new_booking())
        b["calls"] += 1
        for k, n in launches.items():
            b["launches"][k] = b["launches"].get(k, 0) + n
        for dt, f in flops.items():
            b["flops"][dt] = b["flops"].get(dt, 0.0) + f
        b["bytes"] += nbytes

    def __enter__(self):
        BOOKING_SINKS.append(self._book)
        return super().__enter__()

    def __exit__(self, *exc):
        BOOKING_SINKS.remove(self._book)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        try:
            key = (func, _signature(args), _signature(tuple(kwargs.items())))
        except _Unmemoized:
            key = None
        memo = _MEMO.get(key) if key is not None else None
        if memo is not None:
            (is_tuple, metas), flops, nbytes = memo
            results = [torch.empty_strided(shape, stride, dtype=dtype,
                                           device="meta")
                       for shape, stride, dtype in metas]
            out = tuple(results) if is_tuple else results[0]
        else:
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            flops = (0 if formula is None
                     else formula(*args, **kwargs, out_val=out))
            results = list(tensors(out))
            nbytes = (0 if func in _NO_BYTES or func.is_view
                      else sum(t.numel() * t.element_size() for t in
                               (*tensors((args, kwargs)), *results)))
            if key is not None and key not in _MEMO:
                fresh = (None if func.is_view or func._schema.is_mutable
                         else _fresh_results(out, (args, kwargs)))
                _MEMO[key] = (None if fresh is None
                              else (fresh, flops, nbytes))
        self.aten_flops += flops
        self.aten_bytes += nbytes
        for t in results:
            self._track(t)
        return out

    # -------------------------------------------------------------- results
    def counts(self, out: Any = None, alias: Any = None) -> Counts:
        """The counts so far: `out` the step's results, `alias` the state
        it updated in place."""
        kflops = sum(f for b in self.kernels.values()
                     for f in b["flops"].values())
        kbytes = sum(b["bytes"] for b in self.kernels.values())
        mem = Memory(argument_size_in_bytes=self.arguments,
                     output_size_in_bytes=storage_bytes(out),
                     temp_size_in_bytes=self.peak - self.arguments,
                     alias_size_in_bytes=storage_bytes(alias),
                     peak_bytes=self.peak)
        return Counts(flops=self.aten_flops + kflops,
                      hbm_bytes=self.aten_bytes + kbytes,
                      aten_flops=self.aten_flops, aten_bytes=self.aten_bytes,
                      kernel_flops=kflops, kernel_bytes=kbytes, ops=self.ops,
                      memory=mem,
                      kernels={k: dict(v, launches=dict(v["launches"]),
                                       flops=dict(v["flops"]))
                               for k, v in self.kernels.items()})


def count_step(step, args: tuple, alias: Optional[Any] = None,
               grad: bool = False) -> Counts:
    """Run step(*args) once under a fresh `StepCounter`, args held as its
    arguments, with autograd on or off (`grad`), and return its counts
    (`alias` the state it updates in place)."""
    counter = StepCounter()
    counter.hold(args)
    with torch.set_grad_enabled(grad), counter:
        out = step(*args)
    return counter.counts(out, alias)


def combine(terms) -> Counts:
    """The counts sum_i w_i c_i of (w_i, c_i) pairs, field by field (the
    kernel bookings too; the memory's fields likewise, which the caller
    sets where a sum means nothing)."""
    out = Counts()
    for w, c in terms:
        for f in ("flops", "hbm_bytes", "aten_flops", "aten_bytes",
                  "kernel_flops", "kernel_bytes"):
            setattr(out, f, getattr(out, f) + w * getattr(c, f))
        out.ops += w * c.ops
        for f in dataclasses.fields(Memory):
            setattr(out.memory, f.name, getattr(out.memory, f.name)
                    + w * getattr(c.memory, f.name))
        for name, b in c.kernels.items():
            o = out.kernels.setdefault(name, _new_booking())
            o["calls"] += w * b["calls"]
            o["bytes"] += w * b["bytes"]
            for k, n in b["launches"].items():
                o["launches"][k] = o["launches"].get(k, 0) + w * n
            for dt, f in b["flops"].items():
                o["flops"][dt] = o["flops"].get(dt, 0.0) + w * f
    return out
