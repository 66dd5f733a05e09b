"""Trace the first steps of Mamba2-2.7B's training on the CUDA card, as
`launch.train` takes them, and at each step's weights hold the gradient
through the SSD scan's kernels against the gradient through its plain
version.

    python tools/ssd_train_trace.py [--src DIR] [--steps N] [--seed N]

repro_torch is imported from DIR (default: this checkout's src/), so the
same script traces another checkout, for example a parent commit unpacked
with `git archive` into a directory that .gitignore lists; run it for two
checkouts in one call to compare them on one card. The model, batch and
sequence are chip_smoke.py's Mamba2-2.7B training run's. Each step draws
the batch that `launch.train` draws (--seed, the step), takes the loss
and every gradient twice at the same weights, with impl="ref" (the SSD
scan's plain forward and backward, everything else as it is) and with
impl="cuda" (the kernels, as training runs), and then takes AdamW's step
with the kernels' gradient, with `launch.train`'s schedule. The first
step also takes the gradient of a float32 copy of the same weights
through the plain versions and holds both bf16 gradients against it.
Prints a JSON line a step: both losses, both global gradient norms,
AdamW's own norm, the norm of their difference over the plain one's, the
largest error of a leaf (over that leaf's largest plain element) and
which leaf, the three leaves of the largest norm and, at the first step,
the float32 copy's loss and norm and each bf16 gradient's distance from
it over that norm, with the card's name and power limit from nvidia-smi.
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_LR = 3e-3              # launch.train's default --lr


def named_leaves(tree, path=""):
    """(name, leaf) in `training.optimizer.tree_leaves`' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def slices(t):
    """A leaf of 3 or more dims slice by slice over its leading axis, so
    that no whole-leaf float32 copy is made."""
    return list(t) if t.ndim >= 3 else [t]


def sq_norm(t):
    return sum(float(s.float().square().sum()) for s in slices(t))


def diff_stats(a, b):
    """(squared norm of a - b, max |a - b|, max |b|) over a leaf."""
    sq = big = ref = 0.0
    for x, y in zip(slices(a), slices(b)):
        d = x.float() - y.float()
        sq += float(d.square().sum())
        big = max(big, float(d.abs().max()))
        ref = max(ref, float(y.float().abs().max()))
    return sq, big, ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke           # puts this checkout's src/ on the path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("ssd_train_trace: no CUDA device is available",
              file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                           make_batch)
    from repro_torch.models.transformer import Transformer
    from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                                init_opt_state, tree_copy_,
                                                tree_leaves, tree_unflatten)
    from repro_torch.training.train_step import lm_loss
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config(chip_smoke.SSD_TRAIN_ARCH)
    # launch.train's optimizer and schedule
    opt_cfg = OptConfig(peak_lr=PEAK_LR, warmup_steps=20,
                        total_steps=args.steps)
    model = Transformer(cfg, device=dev, seed=args.seed, trainable=True)
    params = model.param_tree()
    opt = None          # made at the first update: the float32 copy first
    pipe = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=chip_smoke.SSD_TRAIN_SEQ,
        global_batch=chip_smoke.SSD_TRAIN_BATCH, seed=args.seed))
    names = [n for n, _ in named_leaves(params)]
    for step in range(args.steps):
        batch = make_batch(pipe, cfg, step, dev)
        leaves = tree_leaves(params)
        out = {}
        for impl in ("ref", "cuda"):
            loss, _ = lm_loss(model, batch, impl=impl)
            grads = torch.autograd.grad(loss, leaves)
            out[impl] = (float(loss.detach()), grads)
            del loss, grads
        (l_ref, g_ref), (l_cuda, g_cuda) = out["ref"], out["cuda"]
        del out
        n_ref = [sq_norm(g) for g in g_ref]
        n_cuda = [sq_norm(g) for g in g_cuda]
        stats = [diff_stats(a, b) for a, b in zip(g_cuda, g_ref)]
        errs = [big / max(ref, 1e-30) for _, big, ref in stats]
        worst = max(range(len(errs)), key=errs.__getitem__)
        top = sorted(range(len(names)), key=lambda i: -n_cuda[i])[:3]
        f32 = None
        if step == 0:
            cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                        compute_dtype="float32")
            m32 = Transformer(cfg32, device=dev, seed=args.seed,
                              trainable=True)
            tree_copy_(m32.param_tree(), params)
            loss32, _ = lm_loss(m32, batch, impl="ref")
            g32 = torch.autograd.grad(loss32,
                                      tree_leaves(m32.param_tree()))
            n32 = sum(sq_norm(g) for g in g32)

            def off(gs):
                return math.sqrt(sum(diff_stats(a, b)[0]
                                     for a, b in zip(gs, g32)) / n32)
            f32 = {"loss": float(loss32.detach()), "gnorm": math.sqrt(n32),
                   "cuda_off": off(g_cuda), "ref_off": off(g_ref)}
            del m32, loss32, g32
        del g_ref
        if opt is None:
            opt = init_opt_state(params, opt_cfg)
        _, opt, met = adamw_update(params, tree_unflatten(params,
                                                          list(g_cuda)),
                                   opt, opt_cfg)
        del g_cuda
        print(json.dumps({
            "src": os.path.dirname(os.path.abspath(repro_torch.__file__)),
            "step": step, "loss_cuda": l_cuda, "loss_ref": l_ref,
            "gnorm_cuda": math.sqrt(sum(n_cuda)),
            "gnorm_ref": math.sqrt(sum(n_ref)),
            "gnorm_adamw": float(met["grad_norm"]),
            "lr": float(met["lr"]),
            "diff_over_ref": math.sqrt(sum(s for s, _, _ in stats)
                                       / max(sum(n_ref), 1e-30)),
            "worst_leaf": names[worst], "worst_leaf_err": errs[worst],
            "top_leaves": {names[i]: [math.sqrt(n_cuda[i]),
                                      math.sqrt(n_ref[i])] for i in top},
            "float32": f32, "card": smi}), flush=True)
        del batch, leaves
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
