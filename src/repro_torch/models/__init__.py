"""The dense decoder-only transformer of the LM scaffold (inference):
config, parameters, blocks, attention, the prefill forward and decode."""
from .config import ModelConfig
from .decode import decode_step, init_cache
from .param import ParamDef, count_params, init_params
from .transformer import Transformer, model_defs, stack_plan
