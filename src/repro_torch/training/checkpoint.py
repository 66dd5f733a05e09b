"""Checkpointing: atomic, async, last-k retention, restore onto a template.

The JAX package's contract:
  * atomic    — write to step_NNN.tmp/, then rename; a crash mid-write
                never corrupts the latest checkpoint.
  * async     — a writer thread drains a depth-1 queue so the train loop
                never blocks on disk (newer snapshots supersede queued
                ones); `save` copies the state to the host before it
                returns, so training may go on updating it in place.
  * last-k    — bounded disk usage; restart picks the newest *complete*
                checkpoint (manifest written last).
  * restore   — state is saved with its tree structure (paths of dict keys
                and list indices) and a dtype/shape manifest; `restore`
                fills a template tree, each leaf on the template leaf's
                device and in its dtype.

numpy has no bfloat16: a bf16 leaf is stored as its raw 16-bit words
(int16 .npy) with "bfloat16" in the manifest, and read back bit for bit.
(The JAX package's elastic resharding onto another mesh has no
counterpart: one card.)
"""
from __future__ import annotations

import json
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .optimizer import tree_leaves, tree_map, tree_unflatten

_SEP = "/"


def _paths(tree, prefix: str = "") -> List[str]:
    """The leaves' paths in tree order: dict keys and list indices joined
    by "/"."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _paths(v, f"{prefix}{k}{_SEP}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}{_SEP}")]
    return [prefix[:-len(_SEP)]]


def _flatten(tree) -> Dict[str, Any]:
    return dict(zip(_paths(tree), tree_leaves(tree)))


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of a leaf (a copy even on the CPU: training updates the
    original in place)."""
    return t.detach().to("cpu", copy=True)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name to record): bf16 as raw int16 words."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save ---
    def save(self, step: int, state, blocking: bool = False) -> None:
        """Snapshot `state` (a tree of tensors, dicts and lists) to the
        host now and write it as checkpoint `step`: here (blocking, or
        async_write=False) or on the writer thread."""
        host_state = tree_map(_to_host, state)
        if not self.async_write or blocking:
            self._write(step, host_state)
            return
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        # depth-1 queue: a newer snapshot supersedes an unqueued older one
        try:
            self._q.put_nowait((step, host_state))
        except queue.Full:
            try:
                self._q.get_nowait()
                self._q.task_done()  # the discarded item, or wait() hangs
            except queue.Empty:
                pass
            self._q.put_nowait((step, host_state))

    def wait(self) -> None:
        """Block until every queued snapshot is written; raise the writer's
        error, if it had one."""
        self._q.join()
        if self._error:
            raise self._error

    def _drain(self) -> None:
        while True:
            step, state = self._q.get()
            try:
                self._write(step, state)
            except BaseException as e:  # surfaced on wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host_state) -> None:
        flat = _flatten(host_state)
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {}
        for i, (key, t) in enumerate(sorted(flat.items())):
            arr, dtype = _to_numpy(t)
            fname = f"arr_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest[key] = dict(file=fname, shape=list(arr.shape),
                                 dtype=dtype)
        # the manifest is written LAST: its presence marks completeness
        (tmp / "manifest.json").write_text(json.dumps(
            dict(step=step, time=time.time(), leaves=manifest)))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore ---
    def all_steps(self) -> List[int]:
        steps = []
        for d in self.dir.glob("step_*"):
            if d.suffix == ".tmp" or not (d / "manifest.json").exists():
                continue  # incomplete (crashed mid-write): ignored
            steps.append(int(d.name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """(a tree shaped like `template` holding checkpoint `step`, the
        newest complete one by default, step). Each leaf is placed on its
        template leaf's device and cast to its dtype. Raises
        FileNotFoundError without a checkpoint and KeyError for a leaf the
        checkpoint lacks."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())["leaves"]
        leaves = []
        for key, like in zip(_paths(template), tree_leaves(template)):
            if key not in manifest:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            meta = manifest[key]
            t = _from_numpy(np.load(d / meta["file"]), meta["dtype"])
            leaves.append(t.to(device=like.device, dtype=like.dtype))
        return tree_unflatten(template, leaves), step
