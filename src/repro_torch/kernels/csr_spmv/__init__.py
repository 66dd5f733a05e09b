from .csr_spmv import LAUNCHES, csr_spmv
from .ref import csr_spmv_ref
