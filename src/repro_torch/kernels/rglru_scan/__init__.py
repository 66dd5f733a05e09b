from .ref import linear_scan, lru_coeffs, rglru_scan_ref
from .rglru_scan import LAUNCHES, rglru_scan, rglru_scan_kernel
