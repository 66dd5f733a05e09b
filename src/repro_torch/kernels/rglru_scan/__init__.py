from .ref import (linear_scan, lru_coeffs, rglru_gate_grads,
                  rglru_scan_bwd_ref, rglru_scan_ref)
from .rglru_scan import (LAUNCHES, RGLRUScan, bwd_flags, kernel_attrs,
                         rglru_scan, rglru_scan_bwd, rglru_scan_bwd_kernel,
                         rglru_scan_kernel)
