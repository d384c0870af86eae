"""Training utilities of the PyTorch port: checkpoints (:mod:`.checkpoint`,
:mod:`.ckpt_manager`), the metrics logger (:mod:`.metrics`) and the
profiling helpers (:mod:`.profiling`)."""

from . import checkpoint, ckpt_manager, metrics, profiling
from .ckpt_manager import CheckpointManager
from .metrics import MetricsLogger

__all__ = ["checkpoint", "ckpt_manager", "metrics", "profiling", "CheckpointManager",
           "MetricsLogger"]
