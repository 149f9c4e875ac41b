"""Plenoxels cells: ``cli/opt.py``'s trainer on the quadtree budget.

Set-up builds the scene, the ``RayBudgeter`` and the ``PlenoxelsTrainer`` as
``cli/opt.py`` builds them, gives the trainer the seeded carved density
(``start.py``), draws the first epoch (``gen_rays``) and puts it in the
trainer's own coherence order (``coherence_order`` with the trainer's rng),
as ``run_epoch_rays`` would for the whole epoch.  The first
``checked_steps`` batches go through ``run_epoch_rays`` one at a time (the
checked steps), a whole slice warms up, and each window call then trains
``run_epoch_rays`` on the next slice of ``slice_rays`` rays: whole 64-ray
blocks of the ordered epoch, so each slice's batches are blocks the whole
epoch's path forms.  Past the epoch's last whole slice the window starts
over at its first, so no rate runs it out.  Every call ends in the
trainer's host transfer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import roofline, scene as scene_mod, start
from portbench.harness import log
from portbench.reference import plenoxels as ref


def _opt_configs(cfg: dict, seed: int, device):
    """(VoxelGridConfig, PlenoxelsTrainConfig, args) as cli/opt.py builds
    them for a blender scene from the configuration's flags."""
    import json

    from flnerf_tpu_torch.cli import opt
    from flnerf_tpu_torch.models.voxel_sh import VoxelGridConfig
    from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainConfig

    argv = ["synthetic", "--seed", str(seed), "--device", str(device)]
    for k, v in cfg["args"].items():
        argv += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
    args = opt.parse_arguments(argv)
    reso = json.loads(args.reso)
    radius = tuple(cfg["radius"])
    gcfg = VoxelGridConfig(
        reso=tuple(reso[0]), basis_dim=args.basis_dim, radius=radius,
        init_sigma=args.init_sigma, step_size=args.step_size, sigma_thresh=args.sigma_thresh,
        stop_thresh=args.stop_thresh, background_brightness=args.background_brightness,
        max_steps=int(3.5 * max(reso[0]) / args.step_size), backend=args.renderer_backend,
        background_nlayers=args.background_nlayers, background_reso=args.background_reso)
    n_up = len(reso) - 1
    tcfg = PlenoxelsTrainConfig(
        n_epoch=args.n_epochs, batch_size=args.batch_size, lr_sigma=args.lr_sigma,
        lr_sigma_final=args.lr_sigma_final, lr_sigma_delay_steps=args.lr_sigma_delay_steps,
        lr_sigma_delay_mult=args.lr_sigma_delay_mult, lr_sh=args.lr_sh,
        lr_sh_final=args.lr_sh_final, rms_beta=args.rms_beta, lambda_tv=args.lambda_tv,
        lambda_tv_sh=args.lambda_tv_sh, subdivide_every=args.subdivide_every,
        subdivide_thres=args.subdivide_thres, rand_samp_perc=args.randSamp_perc,
        steps_per_chunk=args.steps_per_chunk,
        upsample_epochs=tuple(int(args.n_epochs * (i + 1) / (n_up + 1)) for i in range(n_up)),
        seed=args.seed)
    return gcfg, tcfg, args


class Driver:
    def __init__(self, cfg: dict, work: dict, seed: int, device):
        self.cfg, self.work, self.seed, self.device = cfg, work, seed, torch.device(device)

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from flnerf_tpu_torch.rays.quadtree import RayBudgeter
        from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainer, coherence_order

        sc = self.cfg["scene"]
        s = dict(scene_mod.make_scene(sc["n_train"], sc["n_test"], sc["H"], sc["W"], self.device))
        n = sc["n_train"]
        self.scene = s
        host = {k: s[k][:n].cpu().numpy() for k in ("images", "origins", "dirs")}
        self.test_gt = s["images"][n:]
        s.pop("origins"), s.pop("dirs")
        log("scene")
        self.gcfg, self.tcfg, args = _opt_configs(self.cfg, self.seed, self.device)
        self.budgeter = RayBudgeter(host["images"], host["origins"], host["dirs"],
                                    init_level=args.init_level, seed=args.seed)
        self.trainer = PlenoxelsTrainer(self.gcfg, self.tcfg, device=self.device)
        density0 = self._density0()
        self.trainer.state.grid.density.copy_(density0)
        log("budgeter and trainer")
        tc = self.tcfg
        epoch = self.budgeter.gen_rays(down_scale=1, prob=tc.prob_sampling,
                                       rand_samp_perc=tc.rand_samp_perc, last_epoch=False)
        if self.trainer.use_kernel:
            order = coherence_order(epoch.px, epoch.py, epoch.img, self.trainer._order_rng)
            epoch = epoch._replace(**{k: getattr(epoch, k)[order] for k in
                                      ("origins", "dirs", "rgb", "leaf_id", "px", "py", "img")})
        log("gen_rays and the coherence order")
        self.epoch = epoch
        self.host = host
        B = tc.batch_size
        self.slice_rays = self.work["slice_rays"]
        if self.slice_rays % (B * tc.steps_per_chunk):
            raise ValueError("slice_rays must be a whole number of chunks")
        # the checked steps, one batch a call
        self.n_slices = epoch.origins.shape[0] // self.slice_rays
        st = self.trainer.state
        self.readings = {"loss": [], "leaf": []}
        for k in range(self.work["checked_steps"]):
            stat, mse = self.trainer.run_epoch_rays(self._part(k * B, (k + 1) * B))
            self.readings["loss"].append(float(mse))
            self.readings["leaf"].append(torch.from_numpy(np.asarray(stat, np.float64)))
            if k == 0:
                st = self.trainer.state
                self.readings["grad"] = [
                    math.sqrt(float(torch.sum(r.double())) / (1.0 - tc.rms_beta))
                    for r in (st.rms_density, st.rms_sh)]
        st = self.trainer.state
        self.readings["change"] = [
            float(torch.linalg.vector_norm((st.grid.density - density0).double())),
            float(torch.linalg.vector_norm(st.grid.sh.double()))]
        k = self.work["checked_steps"]
        self.batches = [tuple(torch.from_numpy(a[i * B:(i + 1) * B].copy()) for a in
                              (epoch.origins, epoch.dirs, epoch.rgb,
                               epoch.leaf_id.astype(np.int64))) for i in range(k)]
        self.n_leaves = epoch.n_leaves
        del density0
        self.readings["rows_bad"] = self._rows_bad(k * B)
        log("checked steps")
        # the first whole slice past the checked rows warms up
        self.cursor = -(-k * B // self.slice_rays)
        self.traced = None
        self.call()
        log("warm-up")

    def _density0(self):
        g = self.gcfg
        return start.plenoxels_density(g.reso, g.radius, g.init_sigma, self.cfg["start"],
                                       self.seed, self.device)

    def _part(self, a: int, b: int):
        e = self.epoch
        return e._replace(**{k: getattr(e, k)[a:b] for k in
                             ("origins", "dirs", "rgb", "leaf_id", "px", "py", "img")})

    def _rows_bad(self, n: int) -> int:
        """Rows of the checked batches that are not their pixel's ray and
        colour, or lie outside their leaf, plus leaves whose ray count is not
        their area (the first epoch gives each pixel of a leaf one ray on
        average: area x 1)."""
        e, h = self.epoch, self.host
        img, px, py = e.img[:n], e.px[:n], e.py[:n]
        bad = ~(np.all(e.rgb[:n] == h["images"][img, px, py], -1)
                & np.all(e.origins[:n] == h["origins"][img, px, py], -1)
                & np.all(e.dirs[:n] == h["dirs"][img, px, py], -1))
        box = self.budgeter.forest.boxes[e.leaf_id[:n]]
        bad |= (px < np.floor(box[:, 0])) | (px >= np.ceil(box[:, 2])) | \
               (py < np.floor(box[:, 1])) | (py >= np.ceil(box[:, 3]))
        counts = np.bincount(e.leaf_id, minlength=e.n_leaves)
        areas = self.budgeter.forest.areas()
        return int(bad.sum()) + int(np.sum(counts != np.round(areas).astype(np.int64)))

    # -- the window -----------------------------------------------------
    def call(self):
        """Train the next slice; returns (rays, steps, failed steps)."""
        a = (self.cursor % self.n_slices) * self.slice_rays
        self.cursor += 1
        if self.traced is not None:
            # the grid each traced slice starts from, for its work counts
            self.traced.append((a, self.trainer.state.grid.density.clone()))
        _, mse = self.trainer.run_epoch_rays(self._part(a, a + self.slice_rays))
        steps = self.slice_rays // self.tcfg.batch_size
        return self.slice_rays, steps, 0 if math.isfinite(mse) else steps

    def budget_calls(self) -> list:
        """The ray-budget layer's methods, spanned in a traced run."""
        return [(self.budgeter, "gen_rays"), (self.budgeter, "adjust")]

    def trace_begin(self) -> None:
        self.traced = []

    def trace_end(self) -> None:
        self.traced, self.traced_slices = None, self.traced

    # -- after the window -----------------------------------------------
    def evaluate(self) -> float:
        from flnerf_tpu_torch.train.plenoxels_trainer import render_grid_image

        s, n = self.scene, self.cfg["scene"]["n_train"]
        psnrs = []
        for i, gt in enumerate(self.test_gt):
            rgb = render_grid_image(self.trainer.state.grid, self.trainer.gcfg, s["H"], s["W"],
                                    s["K"], s["poses"][n + i][:3, :4])
            mse = float(torch.mean((torch.from_numpy(rgb).to(gt.device) - gt) ** 2))
            psnrs.append(-10.0 * math.log10(max(mse, 1e-12)))
        return float(np.mean(psnrs))

    def finite_state(self) -> bool:
        g = self.trainer.state.grid
        return bool(torch.isfinite(g.density).all()) and bool(torch.isfinite(g.sh).all())

    def work_counts(self) -> dict:
        """The least seconds of the traced window's K1 and K2 launches and
        whole steps, summed (roofline.py): each batch of each traced slice,
        counted on the grid its slice started from."""
        B = self.tcfg.batch_size
        e, rc = self.epoch, self.ref_cfg()
        out = {k: {"least_s": 0.0, "launches": 0} for k in ("k1", "k2", "step")}
        for a, density in self.traced_slices:
            for b in range(a, a + self.slice_rays, B):
                o, d = (torch.from_numpy(x[b:b + B]).to(self.device) for x in (e.origins, e.dirs))
                k = roofline.voxel_counts(density, rc, o, d)
                for name, w in (("k1", roofline.k1_work(k, B)), ("k2", roofline.k2_work(k, B)),
                                ("step", roofline.plenoxels_step_work(k, B, density.numel(),
                                                                      3 * rc["basis_dim"]))):
                    out[name]["least_s"] += roofline.least_seconds(
                        w["bytes"], w.get("f32_flops", 0.0), w.get("bf16_flops", 0.0))
                    out[name]["launches"] += 1
        self.traced_slices = None
        return out

    def free(self) -> None:
        del self.trainer, self.budgeter, self.epoch, self.host
        self.scene = None
        self.test_gt = None

    # -- the reference ----------------------------------------------------
    def ref_cfg(self) -> dict:
        g, t = self.gcfg, self.tcfg
        return {"reso": list(g.reso), "radius": list(g.radius), "step_size": g.step_size,
                "max_steps": g.max_steps, "sigma_thresh": g.sigma_thresh,
                "basis_dim": g.basis_dim, "init_sigma": g.init_sigma,
                "background_brightness": g.background_brightness,
                "train": {k: getattr(t, k) for k in (
                    "lambda_tv", "lambda_tv_sh", "lr_sigma", "lr_sigma_final", "lr_sigma_delay_steps",
                    "lr_sigma_delay_mult", "lr_sh", "lr_sh_final", "lr_decay_steps", "rms_beta")}}

    def reference(self, control: bool = False, fault=None) -> dict:
        """The reference's readings on the checked batches from the seeded
        start, made again here: float32 as configured, or the control (grid
        and optimiser state in bfloat16)."""
        store = torch.bfloat16 if control else torch.float32
        batches = [tuple(t.to(self.device) for t in b) for b in self.batches]
        return ref.train(self.ref_cfg(), self._density0(), batches, self.n_leaves, self.device,
                         store=store, fault=fault)
