"""One run of one cell: set-up, a measured window, the evaluation, the
check against the plain reference, and the result.

Everything that belongs to a configuration, a cell or a per-layer metric is
a file found by its name: ``configs/<config>.json`` (which names its
driver, ``drivers/<driver>.py``), ``workloads/<cell>.json`` and
``metrics/<metric>.py``.  Which metrics a cell reports is BENCHMARK.json's:
a metric with a ``workloads`` list is reported in the cells it names, one
without in every cell.  A driver builds the program's trainer as its CLI
does and offers ``setup``, ``call`` (one unit of training that ends in a
host sync), ``budget_calls``, ``trace_begin`` and ``trace_end`` (around the
traced window, whose launches' work it records), ``evaluate``,
``work_counts`` (the least seconds of the traced launches), ``free`` and
``reference``; see drivers/plenoxels.py.

The window: ``call`` repeats until ``seconds`` have passed; the rate is
every ray trained over the window's whole wall time.  With ``trace`` the
run adds spans around the ray-budget calls, then a second window of the
cell's ``trace_seconds`` under ``torch.profiler``, from which the device's
busy time, the kernels' times and the idle gaps are read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from collections import defaultdict

import torch

from portbench.reference.common import training_gaps

HERE = os.path.dirname(os.path.abspath(__file__))
_last_log = [time.perf_counter()]


def log(what: str) -> None:
    """A set-up phase on standard error, with the seconds since the last."""
    now = time.perf_counter()
    print(f"portbench: {what} ({now - _last_log[0]:.2f} s)", file=sys.stderr, flush=True)
    _last_log[0] = now


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_cell(cell: str):
    """(workload, configuration, driver class) of a cell, by name."""
    work = load_json("workloads", cell)
    cfg = load_json("configs", work["config"])
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}").Driver
    return work, cfg, driver


def bench_metrics(cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json at the
    checkout's root that this cell reports: those without a ``workloads``
    list, and those whose list names the cell."""
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    pick = lambda ms: [m for m in ms if cell in m.get("workloads", [cell])]
    return pick(bench["end_to_end"]), pick(bench["per_layer"])


def metric_reader(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, or for a
    quantity split by cells (``<base>.<part>``) ``metrics/<base>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spans:
    """Host wall time of wrapped calls, by label, while ``on``; each call
    also marks the profiler's timeline (``record_function``)."""

    def __init__(self):
        self.times = defaultdict(list)
        self.on = False

    def wrap(self, obj, method: str, label: str) -> None:
        inner = getattr(obj, method)

        def spanned(*a, **kw):
            t = time.perf_counter()
            with torch.profiler.record_function(label):
                out = inner(*a, **kw)
            if self.on:
                self.times[label].append(time.perf_counter() - t)
            return out

        setattr(obj, method, spanned)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(drv, seconds: float, device) -> dict:
    """Repeat ``drv.call`` for ``seconds``; the rate over the whole wall."""
    rays = steps = failed = 0
    sync(device)
    t0 = time.perf_counter()
    ends = []
    while True:
        r, s, f = drv.call()
        rays, steps, failed = rays + r, steps + s, failed + f
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    sync(device)
    calls = [b - a for a, b in zip([0.0] + ends, ends)]
    # the calls' spread, for a look at where a rate's noise comes from
    log(f"window {len(calls)} calls: median {statistics.median(calls):.4f} s, max "
        f"{max(calls):.4f} s, first half {sum(1 for e in ends if e < seconds / 2)} calls")
    return {"seconds": time.perf_counter() - t0, "rays": rays, "steps": steps, "failed": failed}


def read_trace(prof, label: str) -> dict:
    """Device activity of a profiled window: busy seconds (the union of the
    device's intervals), the window's length (the ``label`` annotation), the
    kernels' count and time by name, and the idle gaps by the innermost
    ``portbench.`` annotation the host was in."""
    gpu, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        annotation = getattr(e, "is_user_annotation", lambda: False)() or e.name().startswith("portbench.")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not annotation:
                gpu.append((t0, t1, e.name()))
        elif e.name().startswith("portbench."):
            cpu.append((t0, t1, e.name()))
    win = [(a, b) for a, b, n in cpu if n == label]
    w0, w1 = (win[0] if win else (min(a for a, _, _ in gpu), max(b for _, b, _ in gpu)))
    kernels = defaultdict(lambda: [0, 0.0])
    busy, cur_a, cur_b, gaps = 0, None, None, defaultdict(float)
    inner = sorted((a, b, n) for a, b, n in cpu if n != label)

    def label_at(t):
        best = None
        for a, b, n in inner:
            if a > t:
                break
            if b >= t and (best is None or a >= best[0]):
                best = (a, n)
        return best[1] if best else "portbench.other"

    def gap(a, b):
        if b > a:
            gaps[label_at((a + b) // 2)] += (b - a) / 1e9

    prev_end = w0
    for a, b, n in sorted(gpu):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernels[n][0] += 1
        kernels[n][1] += (b - a) / 1e9
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            gap(prev_end if cur_b is None else cur_b, a)
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        prev_end = cur_b
    if cur_b is not None:
        busy += cur_b - cur_a
        gap(cur_b, w1)
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels": {n: (c, s) for n, (c, s) in kernels.items()}, "gaps": dict(gaps)}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             tweak=None) -> dict:
    """One run; returns the result object (without printing it).  ``tweak``,
    for tests, is called with the cell's (workload, configuration) dicts
    before the driver is built."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work, cfg, Driver = load_cell(cell)
    if tweak is not None:
        tweak(work, cfg)
    drv = Driver(cfg, work, seed, device)
    drv.setup()
    spans = Spans()
    if trace:
        for obj, method in drv.budget_calls():
            spans.wrap(obj, method, f"portbench.raygen.{method}")
    setup_s = time.perf_counter() - t_start
    spans.on = True
    win = window(drv, seconds, device)
    spans.on = False
    traced = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        call = drv.call
        drv.call = lambda: _marked(call)
        drv.trace_begin()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("portbench.trace_window"):
                window(drv, work["trace_seconds"], device)
        drv.trace_end()
        drv.call = call
        traced = read_trace(prof, "portbench.trace_window") if device.type == "cuda" else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = win["failed"] if drv.finite_state() else win["steps"]
    psnr = drv.evaluate()
    ctx = {"window": win, "spans": dict(spans.times), "trace": traced,
           "work": drv.work_counts() if trace else None}
    if trace:
        log(f"work counts {json.dumps(ctx['work'])}")
    prog = drv.readings
    drv.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = drv.reference()
    log(f"reference gradient norms by leaf {ref['grad']}")
    checks = compare(prog, ref, work["limits"])
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": win["steps"], "failed": failed, "metrics": {}}
    end_to_end, per_layer = bench_metrics(cell)
    if not trace:
        # an end-to-end metric split by cells (<base>.<part>) is its base
        values = {"train_rays_per_s": win["rays"] / win["seconds"], "psnr_db": psnr,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"].split(".")[0]],
                                            "unit": m["unit"]}
    else:
        for m in per_layer:
            v = metric_reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["device"] = device_info(device, peak, traced)
    if traced is not None:
        ops = sorted(traced["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
        # names cut to their first 200 characters: C++ template names run to
        # thousands, and the head names the kernel
        result["breakdown"] = {
            "device_ops": [[n[:200], s] for n, (_, s) in ops],
            "idle_gaps": sorted(([n, s] for n, s in traced["gaps"].items()), key=lambda x: -x[1])[:10]}
    result["checks"] = checks
    return result


def _marked(call):
    with torch.profiler.record_function("portbench.call"):
        return call()


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """Each compared number beside its limit."""
    nums = training_gaps(prog, ref)
    for k in ("rows_bad", "probmap_gap"):
        if k in prog:
            nums[k] = prog[k]
    return {k: {"value": v if math.isfinite(v) else float("inf"), "limit": limits[k]}
            for k, v in nums.items()}


def device_info(device, peak: int, traced) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if traced is not None:
        info["busy_s"] = traced["busy_s"]
        info["window_s"] = traced["window_s"]
    return info
