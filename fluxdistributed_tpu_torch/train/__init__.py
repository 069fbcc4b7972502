"""Training orchestration: ``prepare_training``, ``train``, ``evaluate``
and the CLI (``python -m fluxdistributed_tpu_torch.train``)."""

from .logging import ConsoleLogger, NullLogger
from .trainer import TrainTask, evaluate, prepare_training, train

__all__ = ["ConsoleLogger", "NullLogger", "TrainTask", "evaluate",
           "prepare_training", "train"]
