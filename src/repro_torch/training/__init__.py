"""Training: the paper's asynchronous iteration applied to SGD
(`async_dp`), and the LM's training path: AdamW (`optimizer`), the loss
and train step (`train_step`) and checkpoints (`checkpoint`)."""
from .async_dp import (AsyncTrainResult, MLPTask, TrainStaleOperator,
                       make_local_sgd_step, run_async_training_sim)
from .checkpoint import CheckpointManager
from .optimizer import (OptConfig, adamw_update, global_norm,
                        init_opt_state, lr_schedule)
from .train_step import lm_loss, make_eval_step, make_train_step

__all__ = ["AsyncTrainResult", "MLPTask", "TrainStaleOperator",
           "make_local_sgd_step", "run_async_training_sim",
           "CheckpointManager", "OptConfig", "adamw_update", "global_norm",
           "init_opt_state", "lr_schedule", "lm_loss", "make_eval_step",
           "make_train_step"]
