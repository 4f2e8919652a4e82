"""Training layer of the port: the losses, optimizer, trainer and
checkpoints."""

from .checkpoint import import_torch_checkpoint, latest_checkpoint, load_checkpoint, \
    merge_imported, save_checkpoint
from .losses import binary_entropy, head_loss, torso_loss
from .trainer import Trainer, build_optimizer

__all__ = ["binary_entropy", "head_loss", "torso_loss", "Trainer", "build_optimizer",
           "import_torch_checkpoint", "latest_checkpoint", "load_checkpoint",
           "merge_imported", "save_checkpoint"]
