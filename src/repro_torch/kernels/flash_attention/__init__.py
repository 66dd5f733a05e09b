from .flash_attention import (LAUNCHES, MAX_HEAD_DIM, WGMMA_HEAD_DIMS,
                              check_aligned, flash_attention, kernel_info,
                              kernel_lane)
from .ops import attention
from .ref import flash_attention_ref
