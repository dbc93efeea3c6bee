"""Training of the port (the port of ``repro/train``): AdamW with fp32
master weights, the train step with microbatch accumulation, int8
gradient compression, and atomic, asynchronous checkpoints."""
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, cosine_lr)
from repro_torch.train.train_step import make_train_step, init_train_state
from repro_torch.train.checkpointing import (
    save_checkpoint, restore_checkpoint, AsyncCheckpointer, latest_step,
)
from repro_torch.train import grad_compression

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "make_train_step", "init_train_state", "save_checkpoint",
           "restore_checkpoint", "AsyncCheckpointer", "latest_step",
           "grad_compression"]
