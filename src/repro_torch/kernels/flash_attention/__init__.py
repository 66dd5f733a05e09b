from .flash_attention import LAUNCHES, MAX_HEAD_DIM, flash_attention
from .ops import attention
from .ref import flash_attention_ref
