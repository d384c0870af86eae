"""Classical controllers of the PyTorch port, as plain functions on tensors."""

from . import geometric, pd2d, rpy_pid

__all__ = ["geometric", "pd2d", "rpy_pid"]
