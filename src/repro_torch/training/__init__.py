from .checkpoint import load_checkpoint, save_checkpoint
from .optimizer import AdamW, AdamWState
from .train import TrainState, make_train_step, train_loop

__all__ = ["AdamW", "AdamWState", "TrainState", "make_train_step",
           "train_loop", "save_checkpoint", "load_checkpoint"]
