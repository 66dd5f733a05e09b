from .ref import ssd_scan_ref
from .ssd_scan import LAUNCHES, ssd_scan, ssd_scan_kernel
