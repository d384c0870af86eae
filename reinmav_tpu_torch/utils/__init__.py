"""Training utilities of the PyTorch port: checkpoints (:mod:`.checkpoint`,
:mod:`.ckpt_manager`) and the metrics logger (:mod:`.metrics`)."""

from . import checkpoint, ckpt_manager, metrics
from .ckpt_manager import CheckpointManager
from .metrics import MetricsLogger

__all__ = ["checkpoint", "ckpt_manager", "metrics", "CheckpointManager", "MetricsLogger"]
