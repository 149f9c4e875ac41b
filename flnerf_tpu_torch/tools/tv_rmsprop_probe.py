"""The dense TV + RMSProp sweep (``ops/csrc/tv_rmsprop.cu``) timed on the card
at the main path's grid, beside its bound, its plain version and the autograd
``tv_loss`` + ``_rmsprop`` passes it replaced.

    python -m flnerf_tpu_torch.tools.tv_rmsprop_probe [--reso 256] [--reps 20]

For density ([R, R, R]) and SH ([R, R, R, 27]) with svox2 ``syn.json``'s TV
weights and the first step's learning rates, on an all-alive grid (the
trainer's start) and on one with 10% of its cells dead: the kernel by CUDA
events over ``reps`` launches that swap their output and parameter buffers as
the trainer does, the same with a TV weight of 0 (RMSProp alone: no
neighbour read), ``tv_rmsprop_plain`` on the card, and the replaced path
(autograd of ``lambda * tv_loss``, the gradients' sum, ``_rmsprop``); and
``live_pairs``, which the step runs once for both fields.  The kernel runs
with the rate by value and with the rate read from a device table, as the
trainer's CUDA graph replays give it (``tv_rmsprop_kernel<C, true>``).  The
bound is the sweep's bytes (p, g and rms read, rms and the new p written, the
pairs read once) over 3.35 TB/s; the pairs' bound, the alive mask read and
the pairs written.  Checks the kernel, in both forms, against its plain
version bit for bit on the same inputs, at the field's TV weight and at 0,
and ``live_pairs`` against ``live_pairs_plain``.  Prints one JSON line.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from types import SimpleNamespace

import torch

from flnerf_tpu_torch.models.voxel_sh import tv_loss
from flnerf_tpu_torch.ops import tv_rmsprop as tr
from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainer

HBM_BYTES_PER_S = 3.35e12
BETA = 0.95
# syn.json's TV weights and the first step's learning rates (expon_lr at 0)
FIELDS = {"density": (0, 1e-5, 0.3), "sh": (27, 1e-3, 1e-2)}


def _events_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls by CUDA events,
    after 3 warm-up calls."""
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def probe_field(name: str, reso: int, alive_frac: float, reps: int, seed: int = 0) -> dict:
    c, lam, lr = FIELDS[name]
    dev = torch.device("cuda")
    shape = (reso,) * 3 + (() if c == 0 else (c,))
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randn(shape, device=dev, generator=gen)
    g = 1e-3 * torch.randn(shape, device=dev, generator=gen)
    rms = 1e-6 * torch.rand(shape, device=dev, generator=gen)
    alive = torch.rand((reso,) * 3, device=dev, generator=gen) < alive_frac
    out = torch.empty_like(p)
    bufs = [p.clone(), out]

    # the rate as the trainer's graph replays give it: one float32 of a
    # [K, 2] device table of (density, SH) rates, the rest NaN
    lr_table = torch.full((8, 2), float("nan"), device=dev)
    lr_table[5, int(c > 0)] = lr
    lr_t = lr_table[5, int(c > 0)]

    # the bit-for-bit checks first, on one step from the same inputs, at
    # the field's TV weight and at 0 (RMSProp alone), with the rate by
    # value and read from the table
    pairs = tr.live_pairs(alive)
    pairs_plain = tr.live_pairs_plain(alive)
    pairs_exact = bool(torch.equal(pairs, pairs_plain))
    exact, max_abs_err = {}, 0.0
    p_out = torch.empty_like(p)
    for weight in (0.0, lam):
        r_p = rms.clone()
        tr.tv_rmsprop_plain(p, g, r_p, pairs_plain, weight, lr, BETA, p_out)
        for rate in (lr, lr_t):
            r_k = rms.clone()
            k_out = tr.tv_rmsprop(p, g, r_k, pairs, weight, rate, BETA, out=out)
            torch.cuda.synchronize()
            exact[weight, rate is lr_t] = bool(torch.equal(k_out, p_out)
                                               and torch.equal(r_k, r_p))
            max_abs_err = max(max_abs_err, float((k_out - p_out).abs().max()),
                              float((r_k - r_p).abs().max()))
    del p_out, r_p, pairs_plain

    def sweep(weight, rate=lr):
        def run():
            tr.tv_rmsprop(bufs[0], g, r_k, pairs, weight, rate, BETA, out=bufs[1])
            bufs.reverse()
        return run

    kernel_ms = _events_ms(sweep(lam), reps)
    kernel_lr_table_ms = _events_ms(sweep(lam, lr_t), reps)
    rmsprop_only_ms = _events_ms(sweep(0.0), reps)
    pairs_ms = _events_ms(lambda: tr.live_pairs(alive), reps)
    pairs_plain_ms = _events_ms(lambda: tr.live_pairs_plain(alive), max(2, reps // 4))
    del bufs[:]
    plain_ms = _events_ms(lambda: tr.tv_rmsprop_plain(p, g, r_k, pairs, lam, lr, BETA, out),
                          max(2, reps // 4))
    holder = SimpleNamespace(cfg=SimpleNamespace(rms_beta=BETA))

    def replaced():
        leaf = p.detach().requires_grad_(True)
        (r,) = torch.autograd.grad(lam * tv_loss(leaf, alive), [leaf])
        gg = g.clone()          # the trainer adds into K2's fresh gradient
        PlenoxelsTrainer._rmsprop(holder, out, r_k, gg.add_(r), lr)

    replaced_ms = _events_ms(replaced, max(2, reps // 4))
    n = p.numel()
    nbytes = 20 * n + alive.numel()
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"field": name, "shape": list(shape), "alive_frac": alive_frac,
            "exact": exact[lam, False], "exact_weight0": exact[0.0, False],
            "exact_lr_table": exact[lam, True], "exact_lr_table_weight0": exact[0.0, True],
            "max_abs_err": max_abs_err, "pairs_exact": pairs_exact,
            "kernel_ms": kernel_ms, "kernel_lr_table_ms": kernel_lr_table_ms, "bound_ms": bound_ms, "bytes": nbytes,
            "roofline_pct": 100.0 * bound_ms / kernel_ms,
            "achieved_tb_s": nbytes / (kernel_ms * 1e-3) / 1e12,
            "rmsprop_only_ms": rmsprop_only_ms, "plain_ms": plain_ms,
            "replaced_ms": replaced_ms, "pairs_ms": pairs_ms, "pairs_plain_ms": pairs_plain_ms,
            "pairs_bound_ms": 2 * alive.numel() / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reso", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tv_rmsprop_probe needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rows = [probe_field(name, args.reso, frac, args.reps)
            for name in FIELDS for frac in (1.0, 0.9)]
    out = {"card": card, "torch": torch.__version__, "rows": rows,
           "step_kernel_ms": sum(r["kernel_ms"] for r in rows if r["alive_frac"] == 1.0)
           + rows[0]["pairs_ms"],
           "step_replaced_ms": sum(r["replaced_ms"] for r in rows if r["alive_frac"] == 1.0),
           "ok": all(r["exact"] and r["exact_weight0"] and r["exact_lr_table"]
                     and r["exact_lr_table_weight0"] and r["pairs_exact"] for r in rows)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
