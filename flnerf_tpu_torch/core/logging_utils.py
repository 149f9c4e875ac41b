"""Logging / observability.

Port of ``flnerf_tpu/core/logging_utils.py``:
  * python logging with the nerf++ formatter style (ddp_train_nerf.py:34-51);
  * optional TensorBoard scalars/images through tensorboardX when it is
    importable (plenoxels opt.py:70,420-440; ngp utils.py:607-608), a no-op
    writer otherwise;
  * per-phase host timers (the ``time_record`` dict and ``Timing`` context
    manager analogs, opt.py:44-59 / svox2/utils.py:611-632), grown into the
    program's span and counter recorder, ``RECORDER``.
"""

from __future__ import annotations

import contextlib
import functools
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
    """Named wall-clock accumulators (the reference's time_record dict), and
    the program's span and counter recorder.

    ``phase(name)`` always times its block into ``totals`` and ``counts``.
    The rest records only between ``enable()`` and ``disable()``; off, a
    span or a count costs one boolean check.  ``span(name)`` then times its
    block as ``phase`` does, marks it in any active ``torch.profiler``
    timeline (``record_function``) and appends ``(name, parent, start_ns,
    end_ns)`` to ``spans``, stamped by ``time.time_ns()``: the Unix-epoch
    clock of the profiler's CPU events, so that a span lines up with the
    device trace.  ``self_s`` holds each name's seconds less its child
    spans'.  ``count(name, n)`` adds to a host counter; ``count_device(name,
    t)`` sums ``t`` into a device scalar, which the program reads at a
    transfer it makes anyway (``take_device``, then ``add_counts``), so a
    device count adds no sync."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.on = False
        self._open: list = []    # the spans entered and not yet left
        self.reset()

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

    # -- the recorder ----------------------------------------------------
    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def reset(self) -> None:
        """Forget every span, timer and counter; the on/off state and the
        spans still open stay."""
        self.totals.clear()
        self.counts.clear()
        self.self_s: Dict[str, float] = {}
        self.spans: list = []
        self.counters: Dict[str, float] = {}
        self._dev: dict = {}

    def snapshot(self) -> dict:
        """Copies of the spans, timers and host counters recorded so far."""
        return {"spans": list(self.spans), "totals": dict(self.totals),
                "counts": dict(self.counts), "self_s": dict(self.self_s),
                "counters": dict(self.counters)}

    def span(self, name: str):
        """A context manager that records its block as ``name``; off, one
        shared no-op."""
        if not self.on:
            return _OFF
        return _Span(self, name)

    def spanned(self, name: str):
        """Decorator: each call of the function is a ``span(name)``."""
        def wrap(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                if not self.on:
                    return fn(*args, **kwargs)
                with _Span(self, name):
                    return fn(*args, **kwargs)
            return inner
        return wrap

    def count(self, name: str, n=1) -> None:
        if self.on:
            self.counters[name] = self.counters.get(name, 0) + n

    def count_device(self, name: str, t) -> None:
        """Add ``t``'s sum to the device scalar ``name`` (float64)."""
        if not self.on:
            return
        import torch

        s = torch.sum(t.detach(), dtype=torch.float64)
        acc = self._dev.get(name)
        if acc is None:
            self._dev[name] = s
        else:
            acc.add_(s)

    def take_device(self) -> dict:
        """The device scalars summed since the last take, by name, which
        are then cleared; an empty dict when there are none."""
        dev = self._dev
        if dev:
            self._dev = {}
        return dev

    @contextmanager
    def detached(self):
        """Record the block into a fresh recorder that is on, then put back
        the state from before, on or off, with nothing of the block in it.
        Yields a dict that holds, after the block, its host counters: what
        code run for its launches alone records (a CUDA graph's capture,
        which runs nothing on the device) without its spans, so that each
        replay can add them."""
        saved = (self.on, self.totals, self.counts, self.self_s, self.spans,
                 self.counters, self._dev, self._open)
        self.totals, self.counts, self._open = {}, {}, []
        self.reset()
        self.on = True
        got: Dict[str, float] = {}
        try:
            yield got
        finally:
            got.update(self.counters)
            (self.on, self.totals, self.counts, self.self_s, self.spans,
             self.counters, self._dev, self._open) = saved

    def add_counts(self, counts: dict) -> None:
        """Add values read from the device (``take_device``) to the host
        counters, whether or not the recorder is still on."""
        for name, n in counts.items():
            self.counters[name] = self.counters.get(name, 0) + n


_OFF = contextlib.nullcontext()


class _Span:
    """One recorded span of a ``PhaseTimers`` that is on."""

    __slots__ = ("rec", "name", "parent", "mark", "t0", "children")

    def __init__(self, rec: PhaseTimers, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        import torch

        rec = self.rec
        self.parent = rec._open[-1].name if rec._open else None
        rec._open.append(self)
        self.children = 0
        self.mark = torch.profiler.record_function(self.name)
        self.mark.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.mark.__exit__(*exc)
        rec = self.rec
        rec._open.pop()
        dur = t1 - self.t0
        if rec._open:
            rec._open[-1].children += dur
        rec.spans.append((self.name, self.parent, self.t0, t1))
        rec.totals[self.name] = rec.totals.get(self.name, 0.0) + dur / 1e9
        rec.counts[self.name] = rec.counts.get(self.name, 0) + 1
        rec.self_s[self.name] = rec.self_s.get(self.name, 0.0) + (dur - self.children) / 1e9
        return False


# the program's recorder: its trainers' and ray budget's spans and counters
RECORDER = PhaseTimers()
