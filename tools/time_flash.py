"""Time the port's flash-attention kernels at the main paths' prefill
shapes, on the CUDA card, by chip_smoke.py's own method (its `cuda_ms`:
CUDA events over 20 calls queued behind a device sleep), for a checkout of
the port given by its src/ directory.

    python tools/time_flash.py [--src DIR] [--seed N]

repro_torch is imported from DIR (default: this checkout's src/), so the
same script times another checkout, for example a parent commit unpacked
with `git archive` into a directory that .gitignore lists; its kernels
build into that checkout's build/. Run it for two checkouts in one call to
compare them on one card. Shapes (B, H, Hkv, S = T, Dk, Dv; causal):
Yi-6B (1, 32, 4, 2048, 128, 128) in bf16 and float32, Qwen2-MoE-A2.7B
(1, 16, 16, 2048, 128, 128), RecurrentGemma-2B (1, 10, 1, 4096, 256, 256)
with its window of 2048 and without, DeepSeek-V3's MLA (1, 128, 128, 2048,
192, 128) in bf16 and float32, and PaliGemma-3B (1, 8, 1, 2048, 256, 256)
with its prefix of 256 in bf16 and float32. Then the backward
(`flash_attention_bwd`, dq, dk, dv), causal, at chip_smoke's training
shapes: in bf16 on the tensor-core lane at SmolLM-360M's (8, 15, 5, 2048,
64), Yi-6B's (1, 32, 4, 2048, 128) and RecurrentGemma-2B's (1, 10, 1,
4096, 256) with its window of 2048; on the CUDA-core lane in float32 at
SmolLM-360M's and RecurrentGemma-2B's, and in bf16 at DeepSeek-V3's MLA
dims (1, 128, 128, 2048, Dk 192, Dv 128). Each is given the forward's
log-sum-exp where the checkout's forward returns one for that lane
(`return_lse`), as training calls it; the CUDA-core lane is also timed
without it ("no_lse"). A shape the checkout does not take (no value head
dim of its own, no prefix) is skipped. Prints one JSON line: by shape,
the kernel's milliseconds a call and its largest error against the plain
version, and for the bf16 forwards without a window or a prefix one
causal `scaled_dot_product_attention` call's ("sdpa", the yardstick; the
port never calls it); the tensor-core forward's instantiations as compiled (registers,
shared and spilled bytes, blocks an SM; `wgmma_kernel_attrs`, skipped for
a checkout without it); the card's name and power limit from nvidia-smi.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {  # name: (B, H, Hkv, S, Dk, Dv, dtype, keyword arguments)
    "yi_bf16": (1, 32, 4, 2048, 128, 128, "bfloat16", {}),
    "yi_f32": (1, 32, 4, 2048, 128, 128, "float32", {}),
    "moe_bf16": (1, 16, 16, 2048, 128, 128, "bfloat16", {}),
    "rg_window_bf16": (1, 10, 1, 4096, 256, 256, "bfloat16",
                       {"window": 2048}),
    "rg_bf16": (1, 10, 1, 4096, 256, 256, "bfloat16", {}),
    "mla_bf16": (1, 128, 128, 2048, 192, 128, "bfloat16", {}),
    "mla_f32": (1, 128, 128, 2048, 192, 128, "float32", {}),
    "prefix_bf16": (1, 8, 1, 2048, 256, 256, "bfloat16",
                    {"prefix_len": 256}),
    "prefix_f32": (1, 8, 1, 2048, 256, 256, "float32",
                   {"prefix_len": 256}),
}
# the backward's shapes: name: (B, H, Hkv, S = T, Dk, Dv, dtype, keyword
# arguments), causal
BWD_SHAPES = {
    "smollm_bwd_bf16": (8, 15, 5, 2048, 64, 64, "bfloat16", {}),
    "yi_bwd_bf16": (1, 32, 4, 2048, 128, 128, "bfloat16", {}),
    "rg_window_bwd_bf16": (1, 10, 1, 4096, 256, 256, "bfloat16",
                           {"window": 2048}),
    "smollm_bwd_f32": (8, 15, 5, 2048, 64, 64, "float32", {}),
    "rg_window_bwd_f32": (1, 10, 1, 4096, 256, 256, "float32",
                          {"window": 2048}),
    "mla_bwd_bf16": (1, 128, 128, 2048, 192, 128, "bfloat16", {}),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke           # puts this checkout's src/ on the path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("time_flash: no CUDA device is available", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    import repro_torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref)
    try:
        from repro_torch.kernels.flash_attention import wgmma_kernel_attrs
        attrs = wgmma_kernel_attrs()
    except ImportError:  # a checkout without the attribute export
        attrs = "skipped: not exported by this checkout"
    cuda = torch.device("cuda")
    times = {}
    for name, (B, H, Hkv, S, dk, dv, dt, kw) in SHAPES.items():
        g = torch.Generator(device=cuda).manual_seed(args.seed)
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                   for shape in ((B, H, S, dk), (B, Hkv, S, dk),
                                 (B, Hkv, S, dv)))
        try:
            o = flash_attention(q, k, v, causal=True, **kw)
        except (TypeError, ValueError) as e:
            times[name] = f"skipped: {e}"
            continue
        r = flash_attention_ref(q, k, v, causal=True, **kw)
        err = float((o.float() - r.float()).abs().max())
        del o, r
        times[name] = {"kernel": chip_smoke.cuda_ms(
            lambda: flash_attention(q, k, v, causal=True, **kw), 20),
            "err": err}
        if dt == "bfloat16" and not kw:
            times[name]["sdpa"] = chip_smoke.cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 20)
        del q, k, v
        torch.cuda.empty_cache()
    for name, (B, H, Hkv, S, dk, dv, dt, kw) in BWD_SHAPES.items():
        g = torch.Generator(device=cuda).manual_seed(args.seed)
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                   for shape in ((B, H, S, dk), (B, Hkv, S, dk),
                                 (B, Hkv, S, dv)))
        try:
            o, lse = flash_attention(q, k, v, causal=True, return_lse=True,
                                     **kw)
            given = {"lse": lse}
        except (TypeError, ValueError):  # no lse from this checkout's lane
            o, given = flash_attention(q, k, v, causal=True, **kw), {}
        do = torch.randn(o.shape, generator=g, device=cuda).to(o.dtype)
        got = flash_attention_bwd(q, k, v, o, do, **given, **kw)
        ref = flash_attention_bwd_ref(q, k, v, o, do, **kw)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, ref))
        del got, ref
        torch.cuda.empty_cache()
        times[name] = {"kernel": chip_smoke.cuda_ms(
            lambda: flash_attention_bwd(q, k, v, o, do, **given, **kw), 10),
            "err": err, "lse_given": bool(given)}
        if dt == "float32" or (dk, dv) == (192, 128):
            times[name]["no_lse"] = chip_smoke.cuda_ms(
                lambda: flash_attention_bwd(q, k, v, o, do, **kw), 10)
        del q, k, v, o, do, given
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "src": os.path.dirname(os.path.abspath(repro_torch.__file__)),
        "times": times, "wgmma_attrs": attrs, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
