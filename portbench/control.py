"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and those of the control (the reference computed in the
precision below the configured one, put in the program's place) and of
planted faults, on a few.  No measured window: set-up and its checked steps
only.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... --control 3

prints one JSON line per seed: ``program`` (the program against the
float32 reference), and for the first ``--control`` seeds ``control``, and
``half`` (half of each batch left out, the mean over the rest), each
against the reference.  A state left unchanged reads 1 on ``change_gap``
by construction and needs no run.
"""

import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import scene
    from portbench.harness import compare, load_cell
    from portbench.reference.common import training_gaps

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene.make_scene = functools.lru_cache(maxsize=1)(scene.make_scene)
    work, cfg, Driver = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        drv = Driver(cfg, work, seed, dev)
        drv.setup()
        prog = drv.readings
        uniform = None
        if "probmap_gap" in prog:
            import numpy as np
            hw = drv.images.shape[1] * drv.images.shape[2]
            probs = drv.sampler.image_probs
            uniform = float(np.max(np.abs(1.0 / hw - probs) / probs.max(1, keepdims=True)))
        drv.free()
        torch.cuda.empty_cache()
        ref = drv.reference()
        out = {"seed": seed, "program": compare(prog, ref, work["limits"]), "uniform_probmap_gap": uniform}
        if i < args.control:
            out["control"] = training_gaps(drv.reference(control=True), ref)
            out["half"] = training_gaps(drv.reference(fault="half"), ref)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
