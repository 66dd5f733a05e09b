from .ops import (BSRMatrix, HybridBSR, build_bsr, build_hybrid_bsr,
                  bsr_from_transition, hybrid_from_transition, pad_x,
                  unpad_y, slot_counts, spmv, bsr_matvec, hybrid_matvec,
                  hub_csr)
from .. import resolve_impl
from .bsr_spmv import (bsr_spmv, kernel_path, DEFAULT_BM, DEFAULT_BN,
                       LAUNCHES)
from .ref import bsr_spmv_ref
