"""Logging / observability.

Port of ``flnerf_tpu/core/logging_utils.py``:
  * python logging with the nerf++ formatter style (ddp_train_nerf.py:34-51);
  * optional TensorBoard scalars/images through tensorboardX when it is
    importable (plenoxels opt.py:70,420-440; ngp utils.py:607-608), a no-op
    writer otherwise;
  * per-phase host timers (the ``time_record`` dict and ``Timing`` context
    manager analogs, opt.py:44-59 / svox2/utils.py:611-632).
"""

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np


def setup_logger(name: str = "flnerf", logfile: Optional[str] = None) -> logging.Logger:
    """An INFO logger to stdout (and ``logfile``); a logger that already has
    handlers is returned as it is."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SummaryWriterWrapper:
    """TensorBoard writer that degrades to a no-op when tensorboardX or a
    writable directory is unavailable."""

    def __init__(self, logdir: Optional[str]):
        self._w = None
        if logdir is not None:
            try:
                from tensorboardX import SummaryWriter  # type: ignore

                self._w = SummaryWriter(logdir)
            except Exception:
                self._w = None

    def add_scalar(self, tag, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def add_image(self, tag, img_hwc, step):
        if self._w is not None:
            self._w.add_image(tag, np.asarray(img_hwc), int(step), dataformats="HWC")

    def close(self):
        if self._w is not None:
            self._w.close()


class PhaseTimers:
    """Named wall-clock accumulators (the reference's time_record dict)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = [
            f"{k}: {v:.2f}s ({self.counts[k]}x)"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
