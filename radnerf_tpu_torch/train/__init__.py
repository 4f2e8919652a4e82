"""Training layer of the port: the losses, optimizer, trainer, metrics and
checkpoints."""

from .checkpoint import import_torch_checkpoint, latest_checkpoint, load_checkpoint, \
    merge_imported, restore_opt_state, save_checkpoint
from .losses import binary_entropy, head_loss, torso_loss
from .metrics import LMDMeter, LPIPS, LPIPSMeter, PSNRMeter
from .trainer import Trainer, build_optimizer

__all__ = ["binary_entropy", "head_loss", "torso_loss", "Trainer", "build_optimizer",
           "LMDMeter", "LPIPS", "LPIPSMeter", "PSNRMeter",
           "import_torch_checkpoint", "latest_checkpoint", "load_checkpoint",
           "merge_imported", "restore_opt_state", "save_checkpoint"]
