"""CCNeRF training and composition CLI (ngp-ours/main_CCNeRF.py analog).

Port of ``flnerf_tpu/cli/main_ccnerf.py``, with ``--device`` (default
``cuda``; with no card it raises unless ``--device cpu``).  Two modes, as in
the reference (main_CCNeRF.py:170-228):
  * train (default): rank-residual training.  The supervised truncation
    level cycles K, K-1, ..., 1 every ``steps_per_level`` steps through the
    field's ``level`` (the parameters are shared); then every level is
    evaluated (the "compress" sweep, :217-227) and the object is written to
    ``object.pkl`` in the reference's layout (a numpy params tree and
    ``cfg._asdict()``), so either package loads the other's objects;
  * ``--compose obj1.pkl obj2.pkl ...``: the finalized objects, with
    optional per-object ``--offsets x,y,z`` and ``--scales``, baked into one
    field (network_cc.py:296-334); the occupancy grid from 4 refreshes of
    the same jitter, as the reference draws them all from PRNGKey(0); one
    PNG per test view through ``data/png.py`` (the reference's imageio is
    not on the card's machine).

Not ported yet: ``--gui`` (raises ``NotImplementedError``; ROADMAP.md M19).

Usage:
  python -m flnerf_tpu_torch.cli.main_ccnerf synthetic -O --iters 256
  python -m flnerf_tpu_torch.cli.main_ccnerf synthetic -O --compose a.pkl b.pkl \\
      --offsets 0,0,0 0.5,0,0
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np

from flnerf_tpu_torch.cli.main_nerf import load_ngp_dataset, make_parser
from flnerf_tpu_torch.cli.main_tensorf import parse_o, render_train_configs


def make_ccnerf_parser():
    parser = make_parser()
    parser.add_argument("--rank_vec_density", type=int, nargs="*", default=[8, 16, 24])
    parser.add_argument("--rank_mat_density", type=int, nargs="*", default=[2, 4, 6])
    parser.add_argument("--rank_vec", type=int, nargs="*", default=[8, 16, 24])
    parser.add_argument("--rank_mat", type=int, nargs="*", default=[2, 4, 6])
    parser.add_argument("--resolution0", type=int, default=128)
    parser.add_argument("--compose", type=str, nargs="*", default=None,
                        help="object .pkl checkpoints to compose")
    parser.add_argument("--offsets", type=str, nargs="*", default=None,
                        help="per-object world offsets 'x,y,z'")
    parser.add_argument("--scales", type=float, nargs="*", default=None)
    return parser


def save_object(path, field) -> None:
    """``_save_object`` (main_CCNeRF.py analog): the params as the
    reference's numpy tree and the config as a dict."""
    from flnerf_tpu_torch.core.convert import tensorf_params_to_numpy

    with open(path, "wb") as f:
        pickle.dump({"params": tensorf_params_to_numpy(field), "cfg": field.cfg._asdict()}, f)


def load_object(path, compute_dtype=None, device="cpu"):
    """An ``object.pkl`` of either package -> a ``CCNeRFField`` (at full K).
    Reads a pickle: load only objects this system wrote."""
    import torch

    from flnerf_tpu_torch.core.convert import tensorf_tree_from_numpy
    from flnerf_tpu_torch.models.tensorf_variants import CCNeRFConfig, CCNeRFField

    with open(path, "rb") as f:
        d = pickle.load(f)
    cfg = dict(d["cfg"])
    for k in ("resolution", "rank_vec_density", "rank_mat_density", "rank_vec", "rank_mat"):
        cfg[k] = tuple(cfg[k])
    return CCNeRFField(CCNeRFConfig(**cfg), compute_dtype or torch.bfloat16,
                       params=tensorf_tree_from_numpy(d["params"], device))


def compose(args, images, poses, hwf, K, i_test, compute_dtype, device):
    """Render the composed scene of ``args.compose`` at the test views."""
    import torch

    from flnerf_tpu_torch.data.png import imwrite
    from flnerf_tpu_torch.models.tensorf_variants import ComposedField, ComposedObject
    from flnerf_tpu_torch.render.ngp import init_occupancy, ngp_render_image, update_occupancy

    H, W, _ = hwf
    rcfg, _ = render_train_configs(args)
    objects = []
    for i, path in enumerate(args.compose):
        off = None
        if args.offsets and i < len(args.offsets):
            off = np.asarray([float(v) for v in args.offsets[i].split(",")], np.float32)
        sc = args.scales[i] if args.scales and i < len(args.scales) else 1.0
        objects.append(ComposedObject(load_object(path, compute_dtype, device), None, sc, off))
    field = ComposedField(objects)
    occ = init_occupancy(rcfg, device)
    for _ in range(4):   # bake the composed density into the grid
        occ = update_occupancy(occ, field, rcfg,
                               generator=torch.Generator(device=device).manual_seed(0))
    psnrs = []
    for i in i_test:
        rgb, _ = ngp_render_image(field, occ, rcfg, H, W, K, poses[i][:3, :4],
                                  chunk=args.max_ray_batch)
        imwrite(os.path.join(args.workspace, f"compose_{i:03d}.png"),
                (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        mse = float(np.mean((rgb - images[i][..., :3]) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
    print(f"composed scene: {len(args.compose)} objects, PSNR vs frames {np.mean(psnrs):.2f}")
    return {"psnr": float(np.mean(psnrs)), "n_objects": len(args.compose)}


def main(argv=None):
    import torch

    from flnerf_tpu_torch.core.device import resolve_device
    from flnerf_tpu_torch.models.tensorf_variants import CCNeRFConfig, CCNeRFField
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler, NGPTrainer

    args = parse_o(make_ccnerf_parser(), argv)
    device = resolve_device(args.device)
    os.makedirs(args.workspace, exist_ok=True)
    images, poses, hwf, K, i_split = load_ngp_dataset(args)
    H, W, _ = hwf
    i_train, _, i_test = i_split
    compute_dtype = torch.bfloat16 if args.fp16 else torch.float32
    if args.compose:
        return compose(args, images, poses, hwf, K, i_test, compute_dtype, device)

    cfg = CCNeRFConfig(resolution=(args.resolution0,) * 3,
                       rank_vec_density=tuple(args.rank_vec_density),
                       rank_mat_density=tuple(args.rank_mat_density),
                       rank_vec=tuple(args.rank_vec), rank_mat=tuple(args.rank_mat),
                       bound=args.bound)
    rcfg, tcfg = render_train_configs(args)
    tcfg = tcfg._replace(use_error_map=False)
    field = CCNeRFField(cfg, compute_dtype, torch.Generator().manual_seed(args.seed))
    trainer = NGPTrainer(field, rcfg, tcfg, device=device)
    steps_per_level = max(args.iters // (cfg.K * 4), tcfg.steps_per_chunk)

    if not args.test:
        sampler = NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=args.seed)
        t0 = time.time()
        done, li = 0, cfg.K - 1
        while done < args.iters:
            # cfg.max_steps stays the total, so the lr decays over the run
            trainer.field.level = li + 1
            trainer.fit(sampler, verbose=False, n_steps=steps_per_level)
            done += steps_per_level
            li = (li - 1) % cfg.K
        with open(os.path.join(args.workspace, "time_mins.txt"), "w") as f:
            f.write(f"{(time.time() - t0) / 60:.3f}\n")
        save_object(os.path.join(args.workspace, "object.pkl"), trainer.field)

    results = {}
    for k in range(cfg.K, 0, -1):
        trainer.field.level = k
        psnr, ssim = trainer.eval_images(poses[i_test], images[i_test], H, W, K,
                                         chunk=args.max_ray_batch)
        name = (f"{cfg.rank_vec_density[k-1]}_{cfg.rank_mat_density[k-1]}-"
                f"{cfg.rank_vec[k-1]}_{cfg.rank_mat[k-1]}")
        print(f"level {k} ({name}): PSNR {psnr:.3f} SSIM {ssim:.4f}")
        results[name] = psnr
    with open(os.path.join(args.workspace, "results.txt"), "w") as f:
        for name, p in results.items():
            f.write(f"{name}: PSNR {p}\n")
    return results


if __name__ == "__main__":
    main()
