"""Training orchestration: ``prepare_training``, ``train``, ``evaluate``,
checkpoints and resume (:mod:`.checkpoint`, ``restore_training``,
``resume_training``), the anomaly guard (:mod:`.guard`), model
selection (:mod:`.model_selection`), the loggers and the CLI (``python
-m fluxdistributed_tpu_torch.train``)."""

from .checkpoint import (clear_resume_manifest, latest_step, load_checkpoint,
                         load_checkpoint_elastic, read_resume_manifest,
                         save_checkpoint, wait_for_pending,
                         write_resume_manifest)
from .guard import GuardConfig, GuardHalt, TrainGuard, replay_item
from .logging import (ConsoleLogger, Logger, NullLogger, WandbLogger,
                      current_logger, with_logger)
from .model_selection import (SelectionTask, prepare_model_selection,
                              train_model_selection)
from .trainer import (TrainTask, evaluate, prepare_training, restore_training,
                      resume_training, train)

__all__ = ["ConsoleLogger", "GuardConfig", "GuardHalt", "Logger",
           "NullLogger", "SelectionTask", "TrainGuard", "TrainTask",
           "WandbLogger", "clear_resume_manifest", "current_logger",
           "evaluate", "latest_step", "load_checkpoint",
           "load_checkpoint_elastic", "prepare_model_selection",
           "prepare_training", "read_resume_manifest", "replay_item",
           "restore_training", "resume_training", "save_checkpoint",
           "train", "train_model_selection", "wait_for_pending",
           "with_logger", "write_resume_manifest"]
