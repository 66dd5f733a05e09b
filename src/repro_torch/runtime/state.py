"""ShardState — one shard's owned fragment plus versioned stale views — and
ShardArena, the shared-memory allocator those fragments live in when shard
workers are separate processes (the JAX package's runtime/state.py).

ShardState is the per-UE state of eq. (5): shard i owns fragment x_i and
holds a full-length *stale* copy of every other fragment, tagged with the
version it last imported (the tau_j^i(t) table of the paper). The DES
engine (core/des.py) keeps one ShardState per simulated UE.

The view is a float64 tensor on the run's device, so a block update reads
it where the kernel runs; the version table and counters are host numbers,
since every decision on them is the engine's.

ShardArena packs a set of named numpy arrays into ONE
`multiprocessing.shared_memory` segment so the procpool transport
(runtime/transport.py) can hand every worker process zero-copy views of the
residual, the iterate, the packed CSR and the transport control block.  One
segment = one create/attach/unlink lifecycle, so a crashed run can never
strand a partial set of segments.  It is host numpy, the JAX package's
code copied, under its own segment prefix (`ARENA_PREFIX`,
"repro_torch_arena"): the two packages' arenas and their stale-segment
sweeps never touch each other's segments.  Worker processes only attach
and never call torch.
"""
from __future__ import annotations

import dataclasses
import os
import secrets
from typing import TYPE_CHECKING, Dict, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..core.partition import Partition


@dataclasses.dataclass
class ShardState:
    """Owned fragment + versioned stale views for shard `i` of `part`."""

    i: int
    part: "Partition"
    view: torch.Tensor             # (n,) float64 full-length stale view
    frag_version: np.ndarray       # (p,) version of each fragment held
    produced: int = 0              # own fragment version counter
    iters: int = 0                 # local updates executed
    stopped: bool = False

    @staticmethod
    def create(i: int, part: "Partition", x0) -> "ShardState":
        """A shard whose view is a float64 copy of `x0`: on x0's device for
        a tensor, on the CPU for an array."""
        view = torch.as_tensor(x0, dtype=torch.float64).clone()
        return ShardState(i=i, part=part, view=view,
                          frag_version=np.zeros(part.p, dtype=np.int64))

    @property
    def rows(self) -> Tuple[int, int]:
        return self.part.block(self.i)

    def fragment(self) -> torch.Tensor:
        """The owned rows of the view (a view of it, not a copy)."""
        s, e = self.rows
        return self.view[s:e]

    def publish(self, new_frag) -> int:
        """Install this shard's freshly computed fragment into its own view
        and bump the produced-version counter."""
        s, e = self.rows
        self.view[s:e] = torch.as_tensor(new_frag, dtype=self.view.dtype,
                                         device=self.view.device)
        self.iters += 1
        self.produced += 1
        self.frag_version[self.i] = self.produced
        return self.produced

    def import_fragment(self, owner: int, frag, version: int, s: int,
                        e: int) -> bool:
        """Accept a (possibly relayed) fragment owned by `owner` iff it is
        fresher than the copy currently held. Returns True on accept."""
        if version <= self.frag_version[owner]:
            return False
        self.view[s:e] = torch.as_tensor(frag, dtype=self.view.dtype,
                                         device=self.view.device)
        self.frag_version[owner] = version
        return True

    def import_rows(self, owner: int, rows, vals, version: int) -> bool:
        """Sparsified payload: refresh only `rows` (global ids) of `owner`'s
        fragment. The version table still advances — a row subset is a
        legitimate (partial) refresh under bounded-delay semantics; the
        plan's forced full refresh bounds how long the untouched rows can
        stay stale."""
        if version <= self.frag_version[owner]:
            return False
        dev = self.view.device
        self.view[torch.as_tensor(rows, device=dev)] = torch.as_tensor(
            vals, dtype=self.view.dtype, device=dev)
        self.frag_version[owner] = version
        return True

    def staleness_of(self, owner: int, produced_by_owner: int) -> int:
        return int(produced_by_owner - self.frag_version[owner])


# ---------------------------------------------------------------------------
# ShardArena — one shared-memory segment holding named arrays
# ---------------------------------------------------------------------------
ARENA_PREFIX = "repro_torch_arena"   # every segment the port creates
_ALIGN = 64          # cache-line align every array inside the segment
_SHM_DIR = "/dev/shm"


def sweep_stale_segments(prefix: str = ARENA_PREFIX) -> int:
    """Unlink orphaned `/dev/shm/<prefix>_<pid>_<hex>` segments whose
    creating process is gone; returns how many were reclaimed.

    Segment names are pid-stamped at create time precisely so this sweep
    can tell "crashed parent's leftover" from "concurrent run's live
    arena": `os.kill(pid, 0)` distinguishes a dead pid
    (ProcessLookupError -> reclaim) from one we merely can't signal
    (PermissionError -> alive, leave it).  Our own segments are skipped —
    they are live by definition.  Called from `ShardArena.create`, so a
    box that accumulates kill-9'd runs can't exhaust /dev/shm; best-
    effort on every syscall because another sweep (or the owner's exit
    handler) may race us to the unlink."""
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:                  # non-Linux / no tmpfs: nothing to do
        return 0
    own = os.getpid()
    reclaimed = 0
    for nm in names:
        if not nm.startswith(prefix + "_"):
            continue
        tokens = nm.split("_")
        if len(tokens) < 3:
            continue
        try:
            pid = int(tokens[-2])    # "<prefix>_<pid>_<hex>" — prefix may
        except ValueError:           # itself contain underscores
            continue
        if pid == own:
            continue
        try:
            os.kill(pid, 0)
            continue                 # delivered: creator is alive
        except ProcessLookupError:
            pass                     # creator is gone: stale segment
        except OSError:
            continue                 # EPERM etc.: alive under another uid
        try:
            os.unlink(os.path.join(_SHM_DIR, nm))
            reclaimed += 1
        except OSError:
            pass
    return reclaimed


def live_segments(prefix: str = ARENA_PREFIX) -> list:
    """Names of the `/dev/shm` segments of `prefix` that exist right now
    (the leak check of the tests and the smoke run)."""
    try:
        return sorted(nm for nm in os.listdir(_SHM_DIR)
                      if nm.startswith(prefix + "_"))
    except OSError:
        return []


def _attach_untracked(name: str):
    """`SharedMemory(name=...)` without resource-tracker registration.

    The arena owner is the single point of unlink.  A worker that merely
    *attaches* must not register the segment with a resource tracker: a
    spawn-started worker's own tracker would unlink it at worker exit,
    and a fork-started worker shares the parent's tracker, so an
    unregister-after-the-fact would erase the parent's registration
    (KeyError noise at the real unlink).  Python < 3.13 has no
    `track=False`, so suppress the register call for the duration of the
    attach (worker startup is single-threaded)."""
    from multiprocessing import resource_tracker, shared_memory
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


@dataclasses.dataclass(frozen=True)
class ArenaHandle:
    """Picklable description of an arena: segment name + array layout.
    `ShardArena.attach(handle)` maps the same arrays in another process."""

    name: str
    layout: Tuple[Tuple[str, Tuple[int, ...], str, int], ...]
    # (key, shape, dtype-str, byte offset) per array
    size: int


class ShardArena:
    """Named numpy arrays packed into one shared-memory segment.

    Lifecycle contract:

      * the creator (`ShardArena.create`) OWNS the segment: it must call
        `close(unlink=True)` (or use the arena as a context manager) —
        everything else, including worker crashes, leaks nothing because
        there is nothing else to leak;
      * workers `attach(handle)` and `close()` (no unlink); attaching
        unregisters the segment from the worker's resource tracker so a
        worker exit neither unlinks nor warns;
      * views returned by `arena[key]` alias the segment directly — any
        process's write is every process's read.
    """

    def __init__(self, shm, layout, *, owner: bool):
        self._shm = shm
        self._layout = layout
        self._owner = owner
        self._views: Dict[str, np.ndarray] = {}
        for key, shape, dt, off in layout:
            arr = np.ndarray(shape, dtype=np.dtype(dt),
                             buffer=shm.buf, offset=off)
            self._views[key] = arr

    # -- construction ----------------------------------------------------
    @classmethod
    def create(cls, spec: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
               prefix: str = ARENA_PREFIX) -> "ShardArena":
        """Allocate one segment holding an array per `spec` entry
        (key -> (shape, dtype)), zero-initialized.  Creating an arena
        also sweeps orphaned segments left by crashed/killed parents
        (`sweep_stale_segments`) so repeated kill-9'd runs on one box
        can't exhaust /dev/shm."""
        from multiprocessing import shared_memory
        sweep_stale_segments(ARENA_PREFIX)
        layout = []
        off = 0
        for key, (shape, dtype) in spec.items():
            dt = np.dtype(dtype)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            layout.append((key, tuple(int(s) for s in shape), dt.str, off))
            off += -(-max(nbytes, 1) // _ALIGN) * _ALIGN
        name = f"{prefix}_{os.getpid()}_{secrets.token_hex(4)}"
        # POSIX shm_open + ftruncate pages are zero-filled by the kernel;
        # an explicit memset would double transient memory and fault
        # every page eagerly
        shm = shared_memory.SharedMemory(name=name, create=True,
                                         size=max(off, _ALIGN))
        return cls(shm, tuple(layout), owner=True)

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray],
                    prefix: str = ARENA_PREFIX) -> "ShardArena":
        """Create an arena sized to `arrays` and copy each one in."""
        spec = {k: (a.shape, a.dtype) for k, a in arrays.items()}
        arena = cls.create(spec, prefix=prefix)
        for k, a in arrays.items():
            arena[k][...] = a
        return arena

    @classmethod
    def attach(cls, handle: ArenaHandle) -> "ShardArena":
        shm = _attach_untracked(handle.name)
        return cls(shm, handle.layout, owner=False)

    # -- access ----------------------------------------------------------
    def __getitem__(self, key: str) -> np.ndarray:
        return self._views[key]

    def keys(self):
        return self._views.keys()

    def handle(self) -> ArenaHandle:
        return ArenaHandle(name=self._shm.name, layout=self._layout,
                           size=self._shm.size)

    @property
    def name(self) -> str:
        return self._shm.name

    # -- lifecycle -------------------------------------------------------
    def close(self, unlink: bool = None) -> None:
        """Release this process's mapping; the owner also unlinks the
        segment (idempotent)."""
        if self._shm is None:
            return
        self._views = {}
        unlink = self._owner if unlink is None else unlink
        try:
            self._shm.close()
        except BufferError:
            # a caller still holds a view; the mapping lives until that
            # view is collected, but the segment must not outlive us —
            # fall through to unlink so /dev/shm stays clean
            pass
        finally:
            if unlink:
                try:
                    self._shm.unlink()
                except FileNotFoundError:
                    pass
            self._shm = None

    def __enter__(self) -> "ShardArena":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):            # last-resort leak guard (owner only)
        try:
            self.close()
        except Exception:         # pragma: no cover - interpreter teardown
            pass
