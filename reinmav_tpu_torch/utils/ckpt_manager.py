"""Rotating checkpoint manager: periodic saves, keep-last-N, latest-resume.

The counterpart of :mod:`reinmav_tpu.utils.ckpt_manager`, on
:mod:`reinmav_tpu_torch.utils.checkpoint`, single-process.  Checkpoints
are the directories ``step_<n>`` under one directory.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

from . import checkpoint as ckpt

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, save_interval: int = 1):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.save_interval = max(1, save_interval)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dirs(self):
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def save(self, step: int, tree, force: bool = False) -> bool:
        """Save if due (``step % save_interval == 0``, or ``force``); the
        checkpoints beyond the newest ``keep`` are deleted."""
        if not force and step % self.save_interval != 0:
            return False
        ckpt.save(os.path.join(self.directory, f"step_{step}"), tree)
        for _, path in self._step_dirs()[: -self.keep]:
            shutil.rmtree(path, ignore_errors=True)
        return True

    def restore_latest(self, target):
        """``(tree, step)``: the newest checkpoint in ``target``'s
        structure, or ``(target, None)`` when there is none."""
        step = self.latest_step()
        if step is None:
            return target, None
        return ckpt.restore(os.path.join(self.directory, f"step_{step}"), target), step
