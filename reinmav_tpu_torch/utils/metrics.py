"""Training scalars to stdout, JSONL and CSV.

The counterpart of :mod:`reinmav_tpu.utils.metrics`: in a multi-rank run
only rank 0 writes (:func:`reinmav_tpu_torch.parallel.distributed.is_main`,
the reference's MPI rank-0 gate).  The device scalars of a log call come
to the host in one transfer (:func:`to_host`), not one ``float()`` each.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional

import torch

from ..parallel import distributed


def to_host(metrics: Mapping[str, object]) -> dict:
    """``metrics`` with every tensor value as a Python float, read in ONE
    device-to-host copy (``torch.stack(...).cpu()``); other values kept.
    The copy waits for the work that produced the tensors."""
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = dict(metrics)
    if names:
        device = metrics[names[0]].device
        host = torch.stack([metrics[k].detach().reshape(()).to(device=device, dtype=torch.float64)
                            for k in names]).cpu().tolist()
        out.update(zip(names, host))
    return out


class MetricsLogger:
    """Write training scalars to stdout / JSONL / CSV (rank 0 only).  With
    ``log_dir`` and ``config``, the first JSONL line is ``{"config":
    {...}}``, the run's flags."""

    def __init__(
        self,
        log_dir: Optional[str] = None,
        stdout: bool = True,
        jsonl: bool = True,
        csv: bool = False,
        config: Optional[Mapping[str, object]] = None,
    ):
        self.is_main = distributed.is_main()
        self.log_dir = log_dir
        self.stdout = stdout
        self._jsonl = None
        self._csv = None
        self._csv_keys = None
        self._t0 = time.perf_counter()
        if self.is_main and log_dir:
            os.makedirs(log_dir, exist_ok=True)
            if jsonl:
                self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
                if config is not None:
                    self._jsonl.write(json.dumps({"config": dict(config)}, default=str) + "\n")
                    self._jsonl.flush()
            if csv:
                self._csv = open(os.path.join(log_dir, "metrics.csv"), "a")

    def log(self, step: int, metrics: Mapping[str, object]) -> None:
        if not self.is_main:
            return
        row = {"step": int(step), "wall_s": round(time.perf_counter() - self._t0, 3)}
        for name, val in to_host(metrics).items():
            try:
                row[name] = float(val)
            except (TypeError, ValueError):
                row[name] = str(val)
        if self.stdout:
            print(json.dumps(row), flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(row) + "\n")
            self._jsonl.flush()
        if self._csv:
            if self._csv_keys is None:
                self._csv_keys = list(row)
                self._csv.write(",".join(self._csv_keys) + "\n")
            self._csv.write(",".join(str(row.get(k, "")) for k in self._csv_keys) + "\n")
            self._csv.flush()

    def close(self) -> None:
        for f in (self._jsonl, self._csv):
            if f:
                f.close()
