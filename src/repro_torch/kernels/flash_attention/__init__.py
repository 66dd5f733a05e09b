from .flash_attention import (LAUNCHES, MAX_HEAD_DIM, WGMMA_BWD_HEAD_DIMS,
                              WGMMA_HEAD_DIMS, bwd_lane, check_aligned,
                              flash_attention, flash_attention_bwd,
                              kernel_info, kernel_lane,
                              wgmma_kernel_attrs)
from .ops import FlashAttention, attention
from .ref import flash_attention_bwd_ref, flash_attention_ref
