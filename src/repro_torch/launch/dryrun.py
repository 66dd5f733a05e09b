"""Dry run: every (arch x shape) cell's step counted on the meta device
(after the JAX package's launch/dryrun.py), on one H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --jobs 8

It needs no card: the parameters, the optimizer state, the batch and the
cache are meta tensors (`launch.specs`), the step runs on them as it would
on the card, and `analysis.count.StepCounter` counts its aten ops' FLOPs,
bytes and live memory while the LM kernels' meta lanes book their
launches. Each cell's record (`run_cell`) goes to RESULTS_DIR, one JSON
file a cell: its status, FLOPs and bytes, its memory under the JAX
record's names, the kernels' bookings, the roofline on an H100 at the
cell's compute dtype, and whether argument + temp bytes fit the card.

The JAX module compiles each cell for a 256- or 512-chip mesh and reads
XLA's counts, correcting them for the loop bodies XLA counts once
(`scan_corrections`); the port runs its layers and micro-batches in
Python loops, so nothing is counted once, and its dry run's time grows
with the repeats instead. Where a cell takes gradient accumulation
(DeepSeek-V3's 8 micro-batches of 61 layers), `count_cell` counts the
step at two cuts of the repeated layers (1 and 2 repeats of the stack's
pattern, the unrolled head and tail kept) and of the micro-batches (2 and
3 of the cell's micro-batch shape) and extends the counts bilinearly to
the full step: exact where every count is a sum of identical bodies'
(`tests/test_torch_launch.py` holds it to the full count at a small
config). The peak is not multiplied by the micro-batches, whose
activations are freed one after the other: it is the cut counts' peak
extended linearly in the layer repeats (each adds its parameters,
gradients, moments and accumulators and its saved layer input).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from ..analysis import roofline as rl
from ..analysis.count import Counts, combine, count_step, storage_bytes
from ..configs import ARCH_NAMES, get_config
from ..models.config import ModelConfig
from ..models.decode import decode_step
from ..models.transformer import stack_plan
from ..training.optimizer import OptConfig
from ..training.train_step import make_train_step
from .mesh import make_mesh
from .specs import (SHAPES, batch_for, cache_for, meta_model,
                    params_specs_only, state_specs)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
# the device memory of an H100 80GB HBM3 as torch reports it
# (torch.cuda.get_device_properties(0).total_memory), for a dry run where no
# card is present to ask
H100_MEMORY_BYTES = 85_017_493_504
# a worker's card memory, read once by the process that made the pool
# (`worker_pool`): the workers touch no card
_DEVICE_MEMORY: Optional[int] = None


def opt_config_for(cfg: ModelConfig) -> OptConfig:
    # 671B: bf16 moments, bf16 grad accumulation over 8 microbatches
    # (activation peak /8)
    if "671b" in cfg.name:
        return OptConfig(opt_dtype="bfloat16", accum_steps=8,
                         accum_dtype="bfloat16")
    return OptConfig()


def device_memory_bytes() -> int:
    """The card's memory, or H100_MEMORY_BYTES without a card."""
    if _DEVICE_MEMORY is not None:
        return _DEVICE_MEMORY
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_MEMORY_BYTES


def input_specs(arch: str, shape_name: str, kind: Optional[str] = None):
    """(model, args, alias) of one cell's step on the meta device
    (`step_specs` at the cell's kind, B and S)."""
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    return step_specs(cfg, kind or sh["kind"], sh["batch"], sh["seq"])


def step_specs(cfg: ModelConfig, kind: str, batch: int, seq: int,
               opt_cfg: Optional[OptConfig] = None):
    """(model, args, alias) of one step on the meta device: a meta model
    (the step runs through it: the port's model holds its parameters) and
    the step's arguments, train (state, batch), prefill (params, batch) or
    decode (params, batch, cache), with the state the step updates in
    place (train: the parameters and moments; decode: the cache).
    `batch` x `seq` may differ from the SHAPES cells."""
    b = batch_for(cfg, kind, batch, seq)
    if kind == "train":
        state = state_specs(cfg, opt_cfg or opt_config_for(cfg))
        model = meta_model(cfg, state["params"], trainable=True)
        state["params"] = model.param_tree()
        return model, (state, b), state
    model = meta_model(cfg, params_specs_only(cfg))
    params = model.param_tree()
    if kind == "prefill":
        return model, (params, b), None
    cache = cache_for(cfg, batch, seq, model)
    return model, (params, b, cache), cache


def step_fn(cfg: ModelConfig, kind: str, model,
            opt_cfg: Optional[OptConfig] = None):
    """The step of `kind` over `model`'s parameters: train
    (`make_train_step` on the trainable model), prefill (the forward with
    enc_inputs and prefix_embeds as the JAX package's prefill passes them,
    returning the logits) or decode (`decode_step`, the cache updated in
    place)."""
    if kind == "train":
        return make_train_step(model, opt_cfg or opt_config_for(cfg))
    if kind == "prefill":
        def prefill(params, batch):
            kw = {}
            if cfg.is_encdec:
                kw["enc_inputs"] = batch["enc_inputs"]
            if cfg.prefix_len:
                kw["prefix_embeds"] = batch["prefix_embeds"]
            logits, _ = model(batch["tokens"], **kw)
            return logits
        return prefill

    def serve(params, batch, cache):
        return decode_step(model, batch["token"], cache)
    return serve


def _count_once(cfg: ModelConfig, kind: str, batch: int, seq: int,
                opt_cfg: OptConfig) -> Counts:
    model, args, alias = step_specs(cfg, kind, batch, seq, opt_cfg)
    return count_step(step_fn(cfg, kind, model, opt_cfg), args, alias,
                      grad=kind == "train")


def _cut(cfg: ModelConfig, repeats: int) -> ModelConfig:
    """cfg with its stack's pattern repeated `repeats` times, the unrolled
    head and tail kept (`stack_plan`)."""
    plan = stack_plan(cfg, cfg.n_layers, cfg.first_dense_layers)
    return dataclasses.replace(
        cfg, n_layers=(len(plan.head) + repeats * len(plan.pattern)
                       + len(plan.tail)))


def multiplies(kind: str, opt_cfg: OptConfig) -> bool:
    """Whether `count_cell` counts a step at cuts and extends the counts:
    where it accumulates gradients over micro-batches."""
    return kind == "train" and opt_cfg.accum_steps > 1


def count_cell(cfg: ModelConfig, kind: str, batch: int, seq: int,
               opt_cfg: Optional[OptConfig] = None,
               multiply: Optional[bool] = None) -> Counts:
    """The counts of one step of `kind` at batch x seq. multiply=None
    multiplies where `multiplies` says (the module docstring); True or
    False forces either."""
    opt_cfg = opt_cfg or opt_config_for(cfg)
    if multiply is None:
        multiply = multiplies(kind, opt_cfg)
    if not multiply:
        return _count_once(cfg, kind, batch, seq, opt_cfg)
    A = opt_cfg.accum_steps
    R = stack_plan(cfg, cfg.n_layers, cfg.first_dense_layers).repeats
    if kind != "train" or A < 2 or R < 1 or cfg.is_encdec:
        raise ValueError(f"{cfg.name} {kind}: multiplied counts need a "
                         f"train step with micro-batches and a scanned "
                         f"decoder stack")
    mb = batch // A
    c = {(r, a): _count_once(_cut(cfg, r), kind, a * mb, seq,
                             dataclasses.replace(opt_cfg, accum_steps=a))
         for r in (1, 2) for a in (2, 3)}
    # f(R, A) = f(1, 2) + (R - 1) dR + (A - 2) dA + (R - 1)(A - 2) dRA
    out = combine([
        (1, c[1, 2]),
        (R - 1, c[2, 2]), (-(R - 1), c[1, 2]),
        (A - 2, c[1, 3]), (-(A - 2), c[1, 2]),
        ((R - 1) * (A - 2), c[2, 3]), (-(R - 1) * (A - 2), c[2, 2]),
        (-(R - 1) * (A - 2), c[1, 3]), ((R - 1) * (A - 2), c[1, 2])])
    def in_repeats(field):      # linear in R, at any count of micro-batches
        one, two = (getattr(c[r, 2].memory, field) for r in (1, 2))
        return one + (R - 1) * (two - one)

    _, args, alias = step_specs(cfg, kind, batch, seq, opt_cfg)
    mem = out.memory
    mem.argument_size_in_bytes = storage_bytes(args)
    mem.alias_size_in_bytes = storage_bytes(alias)
    mem.peak_bytes = in_repeats("peak_bytes")
    mem.temp_size_in_bytes = mem.peak_bytes - mem.argument_size_in_bytes
    mem.output_size_in_bytes = in_repeats("output_size_in_bytes")
    return out


def roofline_of(cfg: ModelConfig, counts: Counts) -> rl.Roofline:
    """The step's roofline on one H100 at the cell's compute dtype."""
    return rl.from_counts(counts.flops, counts.hbm_bytes, rl.H100,
                          cfg.compute_dtype)


def run_cell(arch: str, shape_name: str, out_dir: Path = RESULTS_DIR,
             verbose: bool = True) -> dict:
    """Count one cell and write its record to out_dir (see the module
    docstring); returns the record."""
    cfg = get_config(arch)
    mesh = make_mesh()
    rec = dict(arch=arch, shape=shape_name, mesh=mesh.tag)
    ok, why = cfg.supports_shape(shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return _save(rec, out_dir)
    sh = SHAPES[shape_name]
    t0 = time.perf_counter()
    try:
        opt_cfg = opt_config_for(cfg)
        counts = count_cell(cfg, sh["kind"], sh["batch"], sh["seq"],
                            opt_cfg)
        roof = roofline_of(cfg, counts)
        mem = counts.memory
        capacity = device_memory_bytes()
        rec.update(
            status="ok", chips=mesh.size, kind=sh["kind"],
            seconds_count=round(time.perf_counter() - t0, 2),
            multiplied=multiplies(sh["kind"], opt_cfg),
            memory=mem.as_dict(),
            flops_per_device=counts.flops, bytes_per_device=counts.hbm_bytes,
            aten_flops=counts.aten_flops, aten_bytes=counts.aten_bytes,
            kernel_flops=counts.kernel_flops,
            kernel_bytes=counts.kernel_bytes, aten_ops=counts.ops,
            kernels=counts.kernels, roofline=roof.as_dict(),
            device_memory_bytes=capacity,
            fits=(mem.argument_size_in_bytes + mem.temp_size_in_bytes
                  <= capacity))
        if verbose:
            print(f"  {summary(rec)}")
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"  ERROR {type(e).__name__}: {e}")
    return _save(rec, out_dir)


def summary(rec: dict) -> str:
    """One line of a cell's record."""
    head = f"{rec['arch']:<20} {rec['shape']:<12} {rec['status']:<7}"
    if rec["status"] != "ok":
        return head + " " + rec.get("reason", rec.get("error", ""))
    r, m = rec["roofline"], rec["memory"]
    return (f"{head} {rec['flops_per_device'] / 1e12:12.3f} TFLOP "
            f"{rec['bytes_per_device'] / 1e9:12.3f} GB, peak "
            f"{m['peak_bytes'] / 1e9:10.3f} GB, fits {str(rec['fits']):<5}, "
            f"compute {r['compute_s'] * 1e3:12.3f} ms, memory "
            f"{r['memory_s'] * 1e3:12.3f} ms, {r['dominant']}-bound "
            f"({rec['seconds_count']:.1f} s)")


def _save(rec: dict, out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=1, default=str))
    return rec


def _run_quiet(arch: str, shape: str, out_dir: str) -> dict:
    return run_cell(arch, shape, Path(out_dir), verbose=False)


def _init_worker(device_memory: int) -> None:
    global _DEVICE_MEMORY
    _DEVICE_MEMORY = device_memory
    torch.set_num_threads(1)


def worker_pool(jobs: int):
    """An executor of `jobs` worker processes for `run_table`, which a
    caller may give more work. They are forked from a fork server that
    imported this module once (none imports torch anew, and none inherits
    a CUDA context), and touch no card: the card's memory is read here."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ProcessPoolExecutor(jobs, mp_context=ctx,
                               initializer=_init_worker,
                               initargs=(device_memory_bytes(),))


def run_table(archs=None, shapes=None, out_dir: Path = RESULTS_DIR,
              jobs: int = 1, skip_existing: bool = False,
              pool=None) -> list:
    """Every (arch x shape) cell, in `jobs` worker processes
    (`worker_pool`) or in `pool`, one the caller holds; the training cells
    (the longest to count) handed out first; returns the records in cell
    order."""
    cells = []
    for arch in archs or ARCH_NAMES:
        for shape in shapes or list(SHAPES):
            out = out_dir / f"{arch}_{shape}_{make_mesh().tag}.json"
            if skip_existing and out.exists():
                prev = json.loads(out.read_text())
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[skip] {arch} {shape}")
                    continue
            cells.append((arch, shape))
    if pool is None and jobs <= 1:
        return [run_cell(a, s, out_dir, verbose=False) for a, s in cells]
    first = sorted(cells, key=lambda c: SHAPES[c[1]]["kind"] != "train")
    own = pool is None
    pool = worker_pool(jobs) if own else pool
    try:
        futures = {c: pool.submit(_run_quiet, *c, str(out_dir))
                   for c in first}
        return [futures[c].result() for c in cells]
    finally:
        if own:
            pool.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description="one-card dry run on the meta "
                                             "device")
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_NAMES} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (cells in parallel)")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    t0 = time.perf_counter()
    recs = run_table(archs, shapes, Path(args.out), args.jobs,
                     args.skip_existing)
    for rec in recs:
        print(summary(rec))
    print(f"{len(recs)} cells in {time.perf_counter() - t0:.1f} s, records "
          f"under {args.out}")
    return recs


if __name__ == "__main__":
    main()
