"""A kernel's share of its roofline, for the ``<kernel>_roofline`` readers:
the least seconds the driver counted for the traced window's launches of
the kernel, over the device seconds those launches took in the trace.
Nothing when the trace holds no launch or nothing was counted."""

from __future__ import annotations

import sys


def roofline_pct(ctx, key: str, patterns: tuple):
    """``key``: the kernel's entry in the driver's work counts;
    ``patterns``: substrings every trace name of the kernel holds."""
    tr, work = ctx["trace"], ctx["work"]
    if tr is None or work is None or not work.get(key, {}).get("launches"):
        return None
    hits = [(c, s) for n, (c, s) in tr["kernels"].items() if all(p in n for p in patterns)]
    launches = sum(c for c, _ in hits)
    if not launches:
        return None
    if launches != work[key]["launches"]:
        print(f"portbench: {key}: {launches} launches traced, {work[key]['launches']} counted",
              file=sys.stderr)
    return 100.0 * work[key]["least_s"] / sum(s for _, s in hits)
