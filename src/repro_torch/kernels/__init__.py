"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: bsr_spmv (the paper's block SpMV), csr_spmv (the
segment-sum backend's SpMV, in a fixed order), flash_attention (the LM
prefill's attention, local windows included), ssd_scan (Mamba-2's chunked
scan) and rglru_scan (RecurrentGemma's gated recurrence). Built by
`kernels.build` at first use."""
import torch

IMPLS = ("auto", "cuda", "ref")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """"auto" -> "cuda" for a CUDA tensor, "ref" for a CPU tensor; "cuda"
    on a CPU tensor raises; "ref" runs the plain version where x lies."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "ref"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; x is on "
                         f"{x.device}")
    return impl
