"""Training: the paper's asynchronous iteration applied to SGD
(`async_dp`). The optimizer, the train step and checkpoints are not ported
yet (ROADMAP.md, Queue 1 item 10)."""
from .async_dp import (AsyncTrainResult, MLPTask, TrainStaleOperator,
                       make_local_sgd_step, run_async_training_sim)

__all__ = ["AsyncTrainResult", "MLPTask", "TrainStaleOperator",
           "make_local_sgd_step", "run_async_training_sim"]
