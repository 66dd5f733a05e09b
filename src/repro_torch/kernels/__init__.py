"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: bsr_spmv (the paper's block SpMV), csr_spmv (the
segment-sum backend's SpMV, in a fixed order), flash_attention (the LM
prefill's attention, local windows included), ssd_scan (Mamba-2's chunked
scan) and rglru_scan (RecurrentGemma's gated recurrence). Built by
`kernels.build` at first use.

The LM kernels (flash_attention, ssd_scan, rglru_scan) have a third lane,
"meta", for tensors on the meta device, which hold no data: the dry run
(`launch.dryrun`) counts a step there. The lane returns empty results of
the kernel's shapes and dtypes, allocates the workspaces the kernel's
wrapper allocates on the card, and books each launch, with its FLOPs and
bytes by the formulas of `analysis.bounds`, to every counter listening
(`book`). It launches nothing and computes nothing.
"""
from typing import Callable, Dict, List

import torch

IMPLS = ("auto", "cuda", "ref")

# the counters the meta lane books to (`analysis.count.StepCounter` adds
# itself while it counts): sink(kernel, launches, flops by dtype, bytes)
BOOKING_SINKS: List[Callable[[str, Dict[str, int], Dict[str, float],
                              float], None]] = []

def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """"auto" -> "cuda" for a CUDA tensor, "meta" for a meta tensor (the
    counting lane of the LM kernels), "ref" for a CPU tensor; "cuda" on
    any other tensor raises; "ref" runs the plain version where x lies.
    "meta", as an autograd Function hands a resolved lane on, passes for a
    meta tensor only."""
    if impl == "meta":
        if not x.is_meta:
            raise ValueError(f"impl='meta' needs meta tensors; x is on "
                             f"{x.device}")
        return impl
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "meta" if x.is_meta else "ref"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; x is on "
                         f"{x.device}")
    return impl


def book(kernel: str, launches: Dict[str, int], flops: Dict[str, float],
         nbytes: float) -> None:
    """Book one call of `kernel` on the meta lane to every listening
    counter: `launches` as the kernel's LAUNCHES would count them on the
    card, `flops` its operations by the dtype whose peak prices them,
    `nbytes` the bytes it moves."""
    for sink in BOOKING_SINKS:
        sink(kernel, launches, flops, nbytes)
