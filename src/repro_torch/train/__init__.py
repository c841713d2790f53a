"""Training substrate: step builders, loop, checkpointing (the port of
the reference's ``repro.train``)."""

from .checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                         save_checkpoint)
from .loop import LoopConfig, TrainLoop
from .sharded import make_sharded_train_step, shard_train_state
from .step import (chunked_cross_entropy, cross_entropy, init_train_state,
                   loss_fn, make_eval_step, make_train_step)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint", "LoopConfig", "TrainLoop",
           "chunked_cross_entropy", "cross_entropy", "init_train_state",
           "loss_fn", "make_eval_step", "make_train_step",
           "make_sharded_train_step", "shard_train_state"]
