"""Training layer of the port: the head-stage loss, optimizer and trainer."""

from .losses import binary_entropy, head_loss
from .trainer import Trainer, build_optimizer

__all__ = ["binary_entropy", "head_loss", "Trainer", "build_optimizer"]
