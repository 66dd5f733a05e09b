from .csr_spmv import LAUNCHES, csr_spmv, csr_spmv_hub_add, hub_counts
from .ref import csr_spmv_hub_add_ref, csr_spmv_ref
