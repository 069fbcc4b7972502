"""Training steps: the one-device data-parallel step (the JAX package's
``parallel/dp.py``)."""

from .dp import TrainState, guard_sentinel, make_eval_step, make_train_step

__all__ = ["TrainState", "guard_sentinel", "make_eval_step",
           "make_train_step"]
