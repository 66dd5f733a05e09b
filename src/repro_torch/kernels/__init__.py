"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: bsr_spmv (the paper's SpMV). Built by `kernels.build` at
first use."""
