"""The transformer of the LM scaffold: config, parameters, blocks,
attention, the experts and the recurrent layers, the forward (decoder-only
or encoder-decoder; trainable) and decode."""
from .config import ModelConfig
from .decode import decode_step, init_cache
from .param import ParamDef, count_params, init_params
from .transformer import Transformer, model_defs, stack_plan
