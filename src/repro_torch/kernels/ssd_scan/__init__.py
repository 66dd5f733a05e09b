from .ref import ssd_scan_bwd_ref, ssd_scan_ref
from .ssd_scan import (LAUNCHES, SSDScan, kernel_attrs, ssd_scan,
                       ssd_scan_bwd, ssd_scan_bwd_kernel, ssd_scan_kernel)
