"""Training orchestration: ``prepare_training``, ``train``, ``evaluate``,
checkpoints and resume (:mod:`.checkpoint`, ``restore_training``,
``resume_training``) and the CLI (``python -m
fluxdistributed_tpu_torch.train``)."""

from .checkpoint import (clear_resume_manifest, latest_step, load_checkpoint,
                         load_checkpoint_elastic, read_resume_manifest,
                         save_checkpoint, wait_for_pending,
                         write_resume_manifest)
from .logging import ConsoleLogger, NullLogger
from .trainer import (TrainTask, evaluate, prepare_training, restore_training,
                      resume_training, train)

__all__ = ["ConsoleLogger", "NullLogger", "TrainTask",
           "clear_resume_manifest", "evaluate", "latest_step",
           "load_checkpoint", "load_checkpoint_elastic", "prepare_training",
           "read_resume_manifest", "restore_training", "resume_training",
           "save_checkpoint", "train", "wait_for_pending",
           "write_resume_manifest"]
