"""Instant-NGP cells: ``cli/main_nerf.py``'s trainer and sampler.

Set-up builds the scene, then the trainer exactly as ``main_nerf.build``
does from the configuration's and the cell's flags, and an ``NGPSampler``
on the training views (poses scaled as ``load_ngp_dataset`` scales a
blender scene).  The benchmark draws the field's initial weights from the
seed on the device (the program's distributions: tables U(-1e-4, 1e-4),
each [in, out] weight U(-1/sqrt(in), 1/sqrt(in))), carves them
(``start.py``: empty space outside the kept balls) and hands the same to the
program and the reference.  The first ``fit`` chunk holds the checked steps,
``fit`` then warms up to ``warmup_steps`` (the full occupancy refreshes);
the warm-up's last call holds the first partial refresh, which is checked
by itself.  Each window call is ``fit(sampler, n_steps=steps_per_call)``,
which ends in the trainer's one host transfer.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import roofline, scene as scene_mod, start
from portbench.harness import log
from portbench.reference import ngp as ref


class Driver:
    def __init__(self, cfg: dict, work: dict, seed: int, device):
        self.cfg, self.work, self.seed, self.device = cfg, work, seed, torch.device(device)

    def _args(self):
        from flnerf_tpu_torch.cli import main_nerf

        argv = ["synthetic", "--seed", str(self.seed), "--device", str(self.device)]
        for flags in (self.cfg["args"], self.work.get("args", {})):
            for k, v in flags.items():
                if v is True:
                    argv.append(f"--{k}" if len(k) > 1 else f"-{k}")
                else:
                    argv += [f"--{k}", str(v)]
        return main_nerf.parse_args(argv)

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from flnerf_tpu_torch.cli import main_nerf
        from flnerf_tpu_torch.train.ngp_trainer import NGPSampler

        sc = self.cfg["scene"]
        s = dict(scene_mod.make_scene(sc["n_train"], sc["n_test"], sc["H"], sc["W"], self.device))
        n = sc["n_train"]
        s.pop("origins"), s.pop("dirs")
        self.scene = s
        images = s["images"][:n].cpu().numpy()
        self.test_gt = s["images"][n:]
        log("scene")
        self.args = args = self._args()
        trainer, self.fcfg, self.rcfg, self.tcfg = main_nerf.build(args)
        poses = s["poses"].copy()
        poses[:, :3, 3] = poses[:, :3, 3] * args.scale + np.asarray(args.offset, np.float32)
        self.poses = poses
        self.init = self._init_weights(trainer.params)
        with torch.no_grad():
            for e, p in zip(trainer.ema or [], trainer.params):
                e.copy_(p)
        self.trainer = trainer
        self.sampler = NGPSampler(images, poses[:n], s["K"], self.tcfg, seed=self.seed)
        self.images = images
        log("trainer and sampler")
        self._checked_chunk()
        log("checked steps")
        done = self.trainer.step
        if self.work["warmup_steps"] > done:
            self.trainer.fit(self.sampler, verbose=False, n_steps=self.work["warmup_steps"] - done)
        self._recorded_refresh()
        log("warm-up")

    def _init_weights(self, params) -> list:
        """Draw the field's weights from the seed on the device into
        ``params``, carve them, and return a copy of each on the host."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        with torch.no_grad():
            for i, p in enumerate(params):
                u = torch.rand(p.shape, generator=gen, device=self.device)
                # the two tables first, then the [in, out] MLP weights
                b = 1e-4 if i < 2 else 1.0 / math.sqrt(p.shape[0])
                p.copy_(u * (2 * b) - b)
            lv0 = ref.levels(self.ref_cfg())[0]
            start.carve_ngp(params, lv0["scale"], lv0["S"], self.fcfg.bound, self.cfg["start"],
                            self.seed)
        return [p.detach().cpu().clone() for p in params]

    def _recorded_refresh(self) -> None:
        """One window call, whose first refresh (the first partial one past
        the warm-up) is recorded: its inputs (the grid, the weights, the
        generator's state) and the densities it wrote in its class."""
        tr, rec = self.trainer, {}
        inner = tr.refresh_occupancy

        def refresh(partial, *a, **kw):
            if partial and not rec:
                rec.update(state=tr.gen.get_state(), density=tr.occ.density.cpu().clone(),
                           params=[p.detach().cpu().clone() for p in tr.params])
                out = inner(partial, *a, **kw)
                rec["after"] = tr.occ.density.cpu().clone()
                return out
            return inner(partial, *a, **kw)

        tr.refresh_occupancy = refresh
        try:
            self.call()
        finally:
            del tr.refresh_occupancy
        if not rec:
            raise RuntimeError("the warm-up's last call made no partial refresh")
        self.refresh_rec = rec
        # the program's densities in the class its draws picked
        gen = torch.Generator(device=self.device)
        gen.set_state(rec["state"])
        pts = ref.refresh_draws(self.ref_cfg(), gen, True, self.device).long().cpu()
        g = self.ref_cfg()["grid_size"]
        cells = (pts[:, 0] * g + pts[:, 1]) * g + pts[:, 2]
        self.readings["refresh"] = rec.pop("after").reshape(-1)[cells]

    def _checked_chunk(self) -> None:
        """The first chunk, with the first ``checked_steps`` steps' batches,
        draws, losses, first gradient and change recorded."""
        tr, k_max = self.trainer, self.work["checked_steps"]
        rec = {"steps": [], "loss": []}
        inner_step, inner_refresh = tr.train_step, tr.refresh_occupancy

        def refresh(*a, **kw):
            rec.setdefault("refresh_state", tr.gen.get_state())
            return inner_refresh(*a, **kw)

        def step(origins, dirs, rgb, *a, **kw):
            k = len(rec["steps"])
            if k < k_max:
                rec["steps"].append((origins.cpu(), dirs.cpu(), rgb.cpu(), tr.gen.get_state()))
            loss, per_ray = inner_step(origins, dirs, rgb, *a, **kw)
            if k < k_max:
                rec["loss"].append(loss.clone())
            if k == 0:
                # Adam's first moment after one step is (1 - b1) g, b1 = 0.9
                rec["grad"] = [float(torch.linalg.vector_norm(m.double())) / (1.0 - 0.9)
                               for m in tr.mu]
            if k == k_max - 1:
                rec["change"] = [float(torch.linalg.vector_norm((p.detach().cpu() - i).double()))
                                 for p, i in zip(tr.params, self.init)]
                rec["ema"] = [float(torch.linalg.vector_norm((e.cpu() - i).double()))
                              for e, i in zip(tr.ema, self.init)]
            return loss, per_ray

        tr.train_step, tr.refresh_occupancy = step, refresh
        try:
            tr.fit(self.sampler, verbose=False, n_steps=tr.cfg.steps_per_chunk)
        finally:
            del tr.train_step, tr.refresh_occupancy
        self.rec = rec
        self.readings = {"loss": [float(l) for l in rec["loss"]], "grad": rec["grad"],
                         "change": rec["change"], "ema": rec["ema"], "rows_bad": self._rows_bad()}
        if self.sampler.image_probs is not None:
            self.readings["probmap_gap"] = self._probmap_gap()

    def _rows_bad(self) -> int:
        """Rays of the checked batches that are not a pixel's ray of their
        view (step k draws from view k) with that pixel's colour."""
        s = self.scene
        K = s["K"]
        bad = 0
        for k, (o, d, rgb, _) in enumerate(self.rec["steps"]):
            c2w = self.poses[k % self.cfg["scene"]["n_train"]]
            cam = d.double().numpy() @ c2w[:3, :3].astype(np.float64)
            u = K[0, 2] + K[0, 0] * cam[:, 0] / -cam[:, 2]
            v = K[1, 2] - K[1, 1] * cam[:, 1] / -cam[:, 2]
            i, j = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)
            inside = (i >= 0) & (i < s["W"]) & (j >= 0) & (j < s["H"])
            i, j = np.clip(i, 0, s["W"] - 1), np.clip(j, 0, s["H"] - 1)
            ok = (inside & (np.abs(u - i) < 1e-3) & (np.abs(v - j) < 1e-3)
                  & np.all(rgb.numpy() == self.images[k % len(self.images), j, i], -1)
                  & np.all(np.abs(o.numpy() - c2w[:3, 3]) < 1e-5, -1))
            bad += int((~ok).sum())
        return bad

    def _probmap_gap(self) -> float:
        """Largest gap between the sampler's pixel probabilities and the
        reference's (3x3 local standard deviation, mirrored borders, BT.601
        luma, + 1e-6, normalised per view), over the largest probability."""
        worst = 0.0
        for i0 in range(0, len(self.images), 10):
            x = torch.from_numpy(self.images[i0:i0 + 10]).to(self.device).double().permute(0, 3, 1, 2)
            box = lambda t: F.avg_pool2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), 3, stride=1)
            std = torch.sqrt(torch.abs(box(x * x) - box(x) ** 2))
            g = 0.299 * std[:, 0] + 0.587 * std[:, 1] + 0.114 * std[:, 2]
            p = g.reshape(g.shape[0], -1) + 1e-6
            p = p / p.sum(-1, keepdim=True)
            prog = torch.from_numpy(self.sampler.image_probs[i0:i0 + 10]).to(self.device)
            worst = max(worst, float((prog - p).abs().max() / p.max()))
        return worst

    # -- the window -----------------------------------------------------
    def call(self):
        """``fit`` for ``steps_per_call`` steps; returns (rays, steps, failed)."""
        tr = self.trainer
        h0 = len(tr.history)
        tr.fit(self.sampler, verbose=False, n_steps=self.work["steps_per_call"])
        spc = tr.cfg.steps_per_chunk
        failed = sum(spc for h in tr.history[h0:] if not math.isfinite(h["chunk_loss"]))
        steps = len(tr.history[h0:]) * spc
        return steps * tr.cfg.batch_rays, steps, failed

    def budget_calls(self) -> list:
        return [(self.sampler, "sample_chunk"), (self.sampler, "update_error_map")]

    def trace_begin(self) -> None:
        """Record what each traced launch of K6 and K7 works on: each step's
        rays, occupancy and generator state (its march's perturbation), each
        refresh's generator state (its cells' jitter)."""
        tr, self.traced = self.trainer, {"steps": [], "refresh": []}
        inner_step, inner_refresh = tr.train_step, tr.refresh_occupancy

        def step(origins, dirs, rgb, *a, **kw):
            self.traced["steps"].append((origins, dirs, tr.occ, tr.gen.get_state()))
            return inner_step(origins, dirs, rgb, *a, **kw)

        def refresh(partial, *a, **kw):
            self.traced["refresh"].append((partial, tr.gen.get_state()))
            return inner_refresh(partial, *a, **kw)

        tr.train_step, tr.refresh_occupancy = step, refresh

    def trace_end(self) -> None:
        del self.trainer.train_step, self.trainer.refresh_occupancy

    # -- after the window -----------------------------------------------
    def evaluate(self) -> float:
        from flnerf_tpu_torch.render.ngp import ngp_render_image

        s, n = self.scene, self.cfg["scene"]["n_train"]
        tr = self.trainer
        psnrs = []
        # with the EMA weights, as torch-ngp evaluates (-O keeps an EMA)
        with tr.ema_weights(True):
            views = [ngp_render_image(tr.field, tr.occ, tr.rcfg, s["H"], s["W"], s["K"],
                                      self.poses[n + i][:3, :4], chunk=self.args.max_ray_batch,
                                      bg_fn=tr.bg_fn)[0] for i in range(len(self.test_gt))]
        for rgb, gt in zip(views, self.test_gt):
            mse = float(torch.mean((torch.from_numpy(rgb).to(gt.device) - gt) ** 2))
            psnrs.append(-10.0 * math.log10(max(mse, 1e-12)))
        return float(np.mean(psnrs))

    def finite_state(self) -> bool:
        return all(bool(torch.isfinite(p).all()) for p in self.trainer.params)

    def work_counts(self) -> dict:
        """The least seconds of the traced window's K6 and K7 launches and
        whole steps, summed (roofline.py): each step's kept samples marched
        again from its rays, occupancy and perturbation, and each refresh's
        jittered cells, one K6 launch per field call of 2^16 of them."""
        rc = self.ref_cfg()
        n_params = sum(p.numel() for p in self.trainer.params)
        gen = torch.Generator(device=self.device)
        out = {k: {"least_s": 0.0, "launches": 0} for k in ("k6", "k7", "step")}

        def add(name, w):
            out[name]["least_s"] += roofline.least_seconds(
                w["bytes"], w.get("f32_flops", 0.0), w.get("bf16_flops", 0.0))
            out[name]["launches"] += 1

        with torch.no_grad():
            for o, d, occ, state in self.traced["steps"]:
                gen.set_state(state)
                occupied = occ.density.reshape(-1) > torch.clamp(occ.mean_density,
                                                                 max=rc["density_thresh"])
                _, mk, xyzk, _ = ref.march(occupied, o, d, rc, gen)
                x01 = torch.clamp((xyzk.reshape(-1, 3) / rc["bound"] + 1.0) * 0.5, 0.0, 1.0)
                enc = roofline.lattice_counts(x01, mk.reshape(-1), rc)
                add("k6", roofline.k6_work(enc))
                add("k7", roofline.k7_work(enc))
                add("step", roofline.ngp_step_work(enc, rc, n_params))
            for partial, state in self.traced["refresh"]:
                gen.set_state(state)
                x01 = ref.refresh_draws(rc, gen, partial, self.device) / rc["grid_size"]
                for i in range(0, x01.shape[0], 1 << 16):
                    pts = x01[i:i + (1 << 16)]
                    add("k6", roofline.k6_work(roofline.lattice_counts(
                        pts, torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device), rc)))
        self.traced = None
        return out

    def free(self) -> None:
        del self.trainer, self.sampler, self.images
        self.scene = None
        self.test_gt = None

    # -- the reference ----------------------------------------------------
    def ref_cfg(self) -> dict:
        f, r, t = self.fcfg, self.rcfg, self.tcfg
        return {"num_levels": f.num_levels, "base_resolution": f.base_resolution,
                "desired_resolution": f.desired_resolution, "bound": f.bound,
                "log2_hashmap_size": f.log2_hashmap_size, "split_min_size": f.split_min_size,
                "num_layers": f.num_layers, "sh_degree": f.sh_degree,
                "grid_size": r.grid_size, "density_thresh": r.density_thresh,
                "n_candidates": r.n_candidates, "n_keep": r.n_keep, "min_near": r.min_near,
                "bg_color": r.bg_color, "decay": r.decay, "lr": t.lr, "max_steps": t.max_steps,
                "ema_decay": t.ema_decay}

    def reference(self, control: bool = False, fault=None) -> dict:
        """The reference's readings on the checked steps, and on the partial
        refresh from the program's state before it: MLP operands in bfloat16
        as configured, or in float8 (e4m3) for the control."""
        operand = "fp8" if control else "bf16"
        out = ref.train(self.ref_cfg(), self.init, self.rec["steps"], self.rec["refresh_state"],
                        self.device, operand=operand, fault=fault)
        r = self.refresh_rec
        new = ref.partial_refresh(self.ref_cfg(), r["params"], r["density"], r["state"],
                                  self.device, operand=operand)
        out["refresh"], out["refresh_decayed"] = new["density"], new["decayed"]
        return out
