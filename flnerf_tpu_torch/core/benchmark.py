"""Time-to-PSNR benchmark recorder — the paper's headline metric, first-class.

Port of ``flnerf_tpu/core/benchmark.py`` (pure Python, kept as this
package's own copy).  The reference measures wall-clock-to-quality ad hoc
(per-epoch prints at run_nerf.py:546, plenoxels time_mins.txt at
opt.py:529-530, per-epoch ray counts at utils.py:905).  Here every trainer
appends (wall_s, step/epoch, train_psnr, rays) samples; eval hooks append
held-out PSNR; ``time_to_psnr`` interpolates the first crossing of a target,
and ``save`` writes a benchmark JSON that runs can be compared by.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional


class BenchRecorder:
    def __init__(self, meta: Optional[dict] = None):
        self.t0 = time.time()
        self.samples: List[dict] = []
        self.meta = meta or {}

    def record(self, **kwargs) -> None:
        """Append a sample; wall_s is stamped automatically if absent."""
        kwargs.setdefault("wall_s", time.time() - self.t0)
        self.samples.append(kwargs)

    def time_to_psnr(self, target: float, key: str = "psnr") -> Optional[float]:
        """Seconds until ``key`` first reaches ``target`` (linear interp
        between the bracketing samples); None if never reached."""
        prev = None
        for s in self.samples:
            if key not in s:
                continue
            if s[key] >= target:
                if prev is None:
                    return s["wall_s"]
                dp = s[key] - prev[key]
                if dp <= 0:
                    return s["wall_s"]
                f = (target - prev[key]) / dp
                return prev["wall_s"] + f * (s["wall_s"] - prev["wall_s"])
            prev = s
        return None

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"meta": self.meta, "samples": self.samples}, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "BenchRecorder":
        with open(path) as f:
            d = json.load(f)
        r = cls(d.get("meta"))
        r.samples = d["samples"]
        return r
