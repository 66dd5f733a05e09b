"""End-to-end training launcher with fault tolerance, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 200 --batch 8 --seq 2048 --ckpt-dir /tmp/ckpt

--device cpu runs the plain path on the CPU (use it with --smoke). The
weights are random, drawn from --seed; the data is the synthetic token
stream of `data.pipeline`, batch t a function of (seed, t).

What it exercises, as the JAX package's launcher does:
  * auto-resume from the newest complete checkpoint under --ckpt-dir
    (crash-restart safe);
  * the async checkpoint writer every --ckpt-every steps and last-k
    retention, the last save blocking;
  * the paper's persistence-counter protocol (`core.termination.
    ComputingUEState`) on |loss change| < --loss-tol as a convergence
    monitor that stops the run.
A checkpoint is labelled with the number of steps it holds, and a resumed
run starts with the next step's batch, so an interrupted run resumed
repeats the uninterrupted one. (The JAX package labels its periodic
checkpoints one step short, so its resume repeats a batch.)
"""
from __future__ import annotations

import argparse
import time

from ..configs import get_config, get_smoke_config
from ..core.termination import ComputingUEState
from ..data.pipeline import DataConfig, SyntheticTokens, make_batch
from ..device import resolve_device
from ..models.transformer import Transformer
from ..training.checkpoint import CheckpointManager
from ..training.optimizer import OptConfig, init_opt_state, tree_copy_
from ..training.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--loss-tol", type=float, default=0.0,
                    help="early-stop when |dloss| < tol persistently "
                         "(paper's termination protocol on the loss)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=20,
                        total_steps=args.steps)

    model = Transformer(cfg, device=dev, seed=args.seed, trainable=True)
    params = model.param_tree()
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    pipe = SyntheticTokens(dcfg)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            restored, start_step = mgr.restore(state)
            tree_copy_(state, restored)
            del restored
            print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    step_fn = make_train_step(model, opt_cfg)

    # paper's Fig.1 persistence machinery as a training health monitor
    monitor = ComputingUEState(pc_max=5)
    prev_loss = None

    t0 = time.time()
    losses = []
    done = start_step
    for step in range(start_step, args.steps):
        batch = make_batch(pipe, cfg, step, dev)
        state, metrics = step_fn(state, batch)
        done = step + 1
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({(time.time()-t0):.1f}s)")
        if mgr and done % args.ckpt_every == 0 and done < args.steps:
            mgr.save(done, state)
        if args.loss_tol > 0 and prev_loss is not None:
            monitor, msg = monitor.step(abs(prev_loss - loss) < args.loss_tol)
            if msg is not None and msg.name == "CONVERGE":
                print(f"[monitor] persistent convergence at step {step}")
                break
        prev_loss = loss

    if mgr:
        mgr.save(done, state, blocking=True)
        mgr.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
              f"{done - start_step} steps in {time.time()-t0:.1f}s")
    return losses


if __name__ == "__main__":
    main()
