"""Training steps: data parallelism on one device or across ranks
(the JAX package's ``parallel/dp.py``), its collectives, and ZeRO-1,
composable (``parallel/zero1.py``) and fused (``parallel/zero1_fused.py``,
through the fused Adam kernel)."""

from .dp import (TrainState, guard_sentinel, local_grads, make_eval_step,
                 make_train_step, make_train_step_shardmap, module_loss_fn,
                 sync_model_state)
from .zero1 import (make_train_step_zero1, make_train_step_zero1_shardmap,
                    per_device_state_bytes, zero1_optimizer, zero1_state)
from .zero1_fused import (fused_adam_update, make_train_step_zero1_fused,
                          pack_tree, packed_size, unpack_tree,
                          zero1_fused_state)

__all__ = ["TrainState", "fused_adam_update", "guard_sentinel",
           "local_grads", "make_eval_step", "make_train_step",
           "make_train_step_shardmap", "make_train_step_zero1",
           "make_train_step_zero1_fused", "make_train_step_zero1_shardmap",
           "module_loss_fn", "sync_model_state",
           "pack_tree", "packed_size", "per_device_state_bytes",
           "unpack_tree", "zero1_fused_state", "zero1_optimizer",
           "zero1_state"]
