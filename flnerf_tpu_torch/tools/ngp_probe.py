"""Two NGP probes on the card, beside ``chip_smoke.py``.

    python -m flnerf_tpu_torch.tools.ngp_probe kernels
        K3/K4 on uniform random points at full width (16 levels x 2^15,
        393,216 points, a U(-1, 1) table): agreement with the plain version
        and CUDA-event times.
    python -m flnerf_tpu_torch.tools.ngp_probe plateau [--iters 2048] [--seeds 0 1 2]
        ``main_nerf synthetic -O`` for each seed: the mean train loss of
        every chunk and the test PSNR.

Both need a CUDA device and print the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import subprocess
import tempfile

import torch


def _ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernels(n: int = 393216) -> None:
    from flnerf_tpu_torch.ops import hash_kernel as hk
    dev = torch.device("cuda")
    spec = hk.make_packed_spec(desired_resolution=4096)
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((16, spec.t_cap, 2), generator=g, device=dev) * 2 - 1
    x = torch.rand((n, 3), generator=g, device=dev)
    grad = torch.randn((n, spec.output_dim), generator=g, device=dev)
    out = hk.hash_encode_forward(x, table, spec)
    ref = hk.hash_encode_plain(x, table, spec)
    gk = hk.hash_encode_backward(x, grad, spec)
    t = table.clone().requires_grad_(True)
    (gp,) = torch.autograd.grad(hk.hash_encode_plain(x, t, spec), [t], grad)
    print(f"K3 max_err {float((out - ref).abs().max()):.3e} "
          f"(largest {float(ref.abs().max()):.4f}); "
          f"K4 max_err {float((gk - gp).abs().max()):.3e} (largest {float(gp.abs().max()):.4f})")
    print(f"K3 {_ms(lambda: hk.hash_encode_forward(x, table, spec)):.4f} ms, "
          f"K4 {_ms(lambda: hk.hash_encode_backward(x, grad, spec)):.4f} ms "
          f"({n} uniform random points, zero-fill included)")


def plateau(iters: int, seeds) -> None:
    from flnerf_tpu_torch.cli import main_nerf
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            res = main_nerf.main(["synthetic", "-O", "--iters", str(iters), "--workspace", tmp,
                                  "--seed", str(seed)])
        losses = [round(h["chunk_loss"], 4) for h in res["history"]]
        print(f"seed {seed}: test PSNR {res['psnr']:.3f}; mean loss per chunk {losses}",
              flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("probe", choices=("kernels", "plateau"))
    parser.add_argument("--iters", type=int, default=2048)
    parser.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ngp_probe needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.probe == "kernels":
        kernels()
    else:
        plateau(args.iters, args.seeds)


if __name__ == "__main__":
    main()
