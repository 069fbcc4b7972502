"""Training steps: data parallelism on one device or across ranks
(the JAX package's ``parallel/dp.py``), its collectives, ZeRO-1,
composable (``parallel/zero1.py``) and fused (``parallel/zero1_fused.py``,
through the fused Adam update), FSDP (``parallel/fsdp.py``), Megatron
tensor parallelism (``parallel/tp.py``), the sharding rules engine
(``parallel/rules.py``) and the dp x fsdp x tp layouts
(``parallel/layout.py``)."""

from . import fsdp, layout, rules, tp
from .dp import (TrainState, guard_sentinel, local_grads, make_eval_step,
                 make_train_step, make_train_step_shardmap, module_loss_fn,
                 sync_model_state)
from .fsdp import (fsdp_specs, hybrid_fsdp_tp_specs, make_eval_step_fsdp,
                   make_train_step_fsdp)
from .layout import Layout, LayoutError, layout_candidates, resolve_layout
from .rules import (RULE_TABLES, ShardLargest, match_partition_rules,
                    rules_for_model, with_fsdp)
from .tp import (lm_tp_rules, make_train_step_tp, param_specs, shard_state,
                 tensor_parallel, vit_tp_rules)
from .zero1 import (make_train_step_zero1, make_train_step_zero1_shardmap,
                    per_device_state_bytes, zero1_ema_params,
                    zero1_optimizer, zero1_state)
from .zero1_fused import (fused_adam_update, make_train_step_zero1_fused,
                          pack_tree, packed_size, unpack_tree,
                          zero1_fused_state)

__all__ = ["Layout", "LayoutError", "RULE_TABLES", "ShardLargest",
           "TrainState", "fsdp", "fsdp_specs", "fused_adam_update",
           "guard_sentinel", "hybrid_fsdp_tp_specs", "layout",
           "layout_candidates", "lm_tp_rules", "local_grads",
           "make_eval_step", "make_eval_step_fsdp", "make_train_step",
           "make_train_step_fsdp", "make_train_step_shardmap",
           "make_train_step_tp", "make_train_step_zero1",
           "make_train_step_zero1_fused", "make_train_step_zero1_shardmap",
           "match_partition_rules", "module_loss_fn", "pack_tree",
           "packed_size", "param_specs", "per_device_state_bytes",
           "resolve_layout", "rules", "rules_for_model", "shard_state",
           "sync_model_state", "tensor_parallel", "tp", "unpack_tree",
           "vit_tp_rules", "with_fsdp", "zero1_ema_params",
           "zero1_fused_state", "zero1_optimizer", "zero1_state"]
