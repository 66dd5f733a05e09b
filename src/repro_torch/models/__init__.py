"""The decoder-only transformer of the LM scaffold (inference), dense or
mixture-of-experts: config, parameters, blocks, attention, the experts,
the prefill forward and decode."""
from .config import ModelConfig
from .decode import decode_step, init_cache
from .param import ParamDef, count_params, init_params
from .transformer import Transformer, model_defs, stack_plan
