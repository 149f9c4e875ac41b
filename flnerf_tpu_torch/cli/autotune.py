"""Hyper-parameter search / multi-run launcher (opt/autotune.py analog).

Parity with plenoxels-ours/opt/autotune.py:34-323: reads a task JSON with a
base config + grid/random search space, launches one training subprocess per
variant, skips variants whose ``test_psnr.txt`` already exists (:48-50), and
writes a leaderboard sorted by PSNR.  The reference farms runs across GPUs
via CUDA_VISIBLE_DEVICES; variants here run one after another.

Port of ``flnerf_tpu/cli/autotune.py``; the default entry is the port's own
``flnerf_tpu_torch.cli.opt``.

Task JSON:
{
  "entry": "flnerf_tpu_torch.cli.opt",
  "base_args": ["synthetic", "--n_epochs", "2"],
  "train_root": "/tmp/tune",
  "grid": {"lr_sigma": [10, 30], "lambda_tv": [1e-5, 1e-4]},
  "random_samples": 0
}
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import random
import subprocess
import sys

DEFAULT_ENTRY = "flnerf_tpu_torch.cli.opt"


def expand_grid(grid: dict):
    keys = sorted(grid.keys())
    for combo in itertools.product(*(grid[k] for k in keys)):
        yield dict(zip(keys, combo))


def sample_random(space: dict, n: int, seed: int = 0):
    rng = random.Random(seed)
    for _ in range(n):
        yield {k: rng.choice(v) for k, v in sorted(space.items())}


def variant_name(params: dict) -> str:
    return "_".join(f"{k}{v}" for k, v in sorted(params.items())) or "base"


def run_variant(entry: str, base_args, train_dir: str, params: dict) -> bool:
    done_marker = os.path.join(train_dir, "test_psnr.txt")
    if os.path.exists(done_marker):
        print(f"skip finished: {train_dir}")
        return True
    os.makedirs(train_dir, exist_ok=True)
    cmd = [sys.executable, "-m", entry] + list(base_args) + ["-t", train_dir]
    for k, v in params.items():
        cmd += [f"--{k}", str(v)]
    print("launch:", " ".join(cmd))
    res = subprocess.run(cmd)
    return res.returncode == 0 and os.path.exists(done_marker)


def leaderboard(train_root: str):
    rows = []
    for name in sorted(os.listdir(train_root)):
        marker = os.path.join(train_root, name, "test_psnr.txt")
        if os.path.exists(marker):
            with open(marker) as f:
                rows.append((float(f.read().split()[0]), name))
    rows.sort(reverse=True)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("task_json", type=str)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    with open(args.task_json) as f:
        task = json.load(f)
    entry = task.get("entry", DEFAULT_ENTRY)
    base_args = task.get("base_args", [])
    train_root = task["train_root"]
    os.makedirs(train_root, exist_ok=True)

    variants = list(expand_grid(task.get("grid", {})))
    n_rand = int(task.get("random_samples", 0))
    if n_rand:
        variants += list(sample_random(task.get("random_space", {}), n_rand, args.seed))
    if not variants:
        variants = [{}]

    for params in variants:
        run_variant(entry, base_args, os.path.join(train_root, variant_name(params)), params)

    rows = leaderboard(train_root)
    print("\n=== leaderboard (test PSNR) ===")
    for psnr, name in rows:
        print(f"{psnr:8.3f}  {name}")
    with open(os.path.join(train_root, "leaderboard.txt"), "w") as f:
        for psnr, name in rows:
            f.write(f"{psnr}\t{name}\n")
    return rows


if __name__ == "__main__":
    main()
