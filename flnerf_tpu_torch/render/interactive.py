"""Headless interactive train/render session: the GUI logic of
ngp-ours/nerf/gui.py and dnerf/gui.py without a display.

Port of ``flnerf_tpu/render/interactive.py``:
  * ``OrbitCamera`` (gui.py:10-52): orbit, scale and pan in the ngp pose
    convention (numpy, as the reference computes it);
  * budgeted train stepping (utils.py:696-755 train_gui, gui.py:94-111):
    train N steps a UI frame, N adapted to a wall-clock budget (500 ms a
    frame, N in [4, 16], +-20% hysteresis);
  * dynamic-resolution preview (utils.py:758-806 test_gui, gui.py:123-148):
    render at a downscale picked so a frame stays under ~200 ms,
    nearest-upsample to the view size, accumulate spp frames while the
    camera holds still.

The reference's static-shape deltas are kept: train steps a frame are whole
multiples of the trainer's ``steps_per_chunk`` (``NGPTrainer.fit`` runs in
chunks) and downscales snap to {1, 1/2, 1/4}.  The trainer is
``train/ngp_trainer.NGPTrainer``; its step counter and loss history live on
the host.  A frame's wall time is read after ``torch.cuda.synchronize`` on
the trainer's device, so the budget rule reads the work, not its launch.
The preview renders with the EMA weights when the trainer keeps them,
swapped in and the live weights restored exactly (``ema_weights``).

``run_dearpygui`` attaches a window when dearpygui is importable and raises
``ImportError`` otherwise; the CLIs then drive the session headlessly.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

DOWNSCALES = (1.0, 0.5, 0.25)


def _rotvec_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation about a unit axis (scipy-free R.from_rotvec)."""
    k = np.asarray(axis, np.float64)
    n = np.linalg.norm(k)
    if n < 1e-12:
        return np.eye(3)
    k = k / n
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)


class OrbitCamera:
    """gui.py:10-52: an orbit camera in the ngp pose convention."""

    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        # R.from_quat([1, 0, 0, 0]): 180 deg about x
        self.rot = np.diag([1.0, -1.0, -1.0])
        self.up = np.array([0.0, 1.0, 0.0], np.float32)

    @property
    def pose(self) -> np.ndarray:
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * math.tan(math.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2])

    def orbit(self, dx: float, dy: float):
        side = self.rot[:3, 0]
        self.rot = (
            _rotvec_matrix(self.up, math.radians(-0.1 * dx))
            @ _rotvec_matrix(side, math.radians(-0.1 * dy))
            @ self.rot
        )

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 0.0005 * (self.rot @ np.array([dx, dy, dz]))


def _snap_downscale(d: float) -> float:
    """The closest of the downscale buckets."""
    return min(DOWNSCALES, key=lambda v: abs(v - d))


class InteractiveSession:
    """NeRFGUI's stepping engine (gui.py NeRFGUI without dearpygui): an
    ``NGPTrainer``, an ``NGPSampler`` and an ``OrbitCamera``, interleaving
    budgeted training with dynamic-resolution preview rendering."""

    def __init__(self, trainer, sampler, W: int = 256, H: int = 256,
                 radius: float = 2.0, fovy: float = 60.0,
                 train_budget_ms: float = 500.0,
                 render_budget_ms: float = 200.0, max_spp: int = 64,
                 mode: str = "image", time: Optional[float] = None):
        self.trainer = trainer
        self.sampler = sampler
        self.W, self.H = W, H
        self.cam = OrbitCamera(W, H, r=radius, fovy=fovy)
        self.training = False
        self.mode = mode                      # 'image' | 'depth'
        self.time = time                      # D-NeRF slider (dnerf/gui.py)
        self.train_budget_ms = train_budget_ms
        self.render_budget_ms = render_budget_ms
        self.max_spp = max_spp

        spc = trainer.cfg.steps_per_chunk
        self.train_steps = min(16, max(spc, 16 // spc * spc))
        self.downscale = 1.0
        self.dynamic_resolution = True
        self.need_update = True
        self.spp = 1
        self.render_buffer = np.zeros((H, W, 3), np.float32)
        self.step = 0

    def _sync(self):
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)

    # -- train side ------------------------------------------------------
    def train_frame(self) -> dict:
        """train_gui (utils.py:696-755) and the dynamic train-step rule
        (gui.py:106-111): run ~train_steps steps, return loss and lr, adapt
        the per-frame step count to the wall-clock budget."""
        cfg = self.trainer.cfg
        spc = cfg.steps_per_chunk
        n = max(spc, self.train_steps // spc * spc)

        t0 = time.perf_counter()
        self.trainer.fit(self.sampler, verbose=False, n_steps=n)
        self._sync()
        t = (time.perf_counter() - t0) * 1e3

        self.step = int(self.trainer.step)
        self.need_update = True

        # dynamic train steps: max ~train_budget_ms a frame, 4..16 steps
        full_t = t / n * 16
        want = min(16, max(4, int(16 * self.train_budget_ms / max(full_t, 1e-3))))
        if want > self.train_steps * 1.2 or want < self.train_steps * 0.8:
            self.train_steps = want

        loss = self.trainer.history[-1]["loss"] if self.trainer.history else 0.0
        lr = cfg.lr * 0.1 ** (self.step / cfg.max_steps)
        # the steps run this frame (chunk-quantised n), not the adapted
        # next-frame target
        return {"loss": float(loss), "lr": float(lr), "time_ms": t,
                "train_steps": n}

    # -- render side -----------------------------------------------------
    def _render(self, downscale: float):
        """test_gui (utils.py:758-806): the orbit camera's view at a
        downscaled resolution with the EMA weights when present, then
        nearest-upsampled to the full view size."""
        from flnerf_tpu_torch.rays.camera import intrinsics_matrix
        from flnerf_tpu_torch.render.ngp import ngp_render_image

        tr = self.trainer
        rH, rW = int(self.H * downscale), int(self.W * downscale)
        fx, fy, cx, cy = self.cam.intrinsics * downscale
        # K from fx alone, centred, as the reference builds it
        K = intrinsics_matrix(rH, rW, fx)
        with tr.ema_weights():                                  # ema.copy_to()
            rgb, depth = ngp_render_image(tr.field, tr.occ, tr.rcfg, rH, rW, K,
                                          self.cam.pose[:3, :4], chunk=min(8192, rH * rW),
                                          time=self.time, bg_fn=tr.bg_fn)
        if downscale != 1.0:
            ry = (np.arange(self.H) * rH // self.H).clip(0, rH - 1)
            rx = (np.arange(self.W) * rW // self.W).clip(0, rW - 1)
            rgb = rgb[ry][:, rx]
            depth = depth[ry][:, rx]
        return rgb, depth

    def render_frame(self) -> dict:
        """test_step (gui.py:123-153): dynamic-resolution preview and spp
        accumulation while the camera holds still."""
        if not (self.need_update or self.spp < self.max_spp):
            return {"image": self.render_buffer, "spp": self.spp,
                    "downscale": self.downscale, "time_ms": 0.0}

        t0 = time.perf_counter()
        rgb, depth = self._render(self.downscale)
        self._sync()
        t = (time.perf_counter() - t0) * 1e3

        if self.dynamic_resolution:
            # max ~render_budget_ms a frame (gui.py:136-140)
            full_t = t / (self.downscale ** 2)
            want = min(1.0, max(0.25, math.sqrt(self.render_budget_ms / max(full_t, 1e-3))))
            if want > self.downscale * 1.2 or want < self.downscale * 0.8:
                self.downscale = _snap_downscale(want)

        frame = (rgb if self.mode == "image"
                 else np.repeat(depth[..., None], 3, -1))
        if self.need_update:
            self.render_buffer = frame
            self.spp = 1
            self.need_update = False
        else:
            self.render_buffer = (
                self.render_buffer * self.spp + frame) / (self.spp + 1)
            self.spp += 1
        return {"image": self.render_buffer, "spp": self.spp,
                "downscale": self.downscale, "time_ms": t}

    # -- interaction -----------------------------------------------------
    def orbit(self, dx, dy):
        self.cam.orbit(dx, dy)
        self.need_update = True

    def pan(self, dx, dy, dz=0.0):
        self.cam.pan(dx, dy, dz)
        self.need_update = True

    def zoom(self, delta):
        self.cam.scale(delta)
        self.need_update = True

    def set_time(self, t: float):
        """D-NeRF time slider (dnerf/gui.py): re-render at time t."""
        self.time = float(t)
        self.need_update = True

    def frame(self) -> dict:
        """One UI frame: train (if enabled), then render; the dearpygui
        render-loop body (gui.py:283-292)."""
        out = {}
        if self.training:
            out["train"] = self.train_frame()
        out["render"] = self.render_frame()
        return out


def run_dearpygui(session: InteractiveSession):  # pragma: no cover
    """Attach a dearpygui window when the package is importable; raises
    ImportError without it (drive the session headlessly then)."""
    try:
        import dearpygui.dearpygui as dpg
    except ImportError as e:
        raise ImportError(
            "dearpygui is not installed; drive InteractiveSession "
            "headlessly (frame()/orbit()/zoom()) instead") from e

    dpg.create_context()
    with dpg.texture_registry(show=False):
        dpg.add_raw_texture(session.W, session.H, session.render_buffer,
                            format=dpg.mvFormat_Float_rgb, tag="_texture")
    with dpg.window(tag="_primary", width=session.W, height=session.H):
        dpg.add_image("_texture")
    dpg.create_viewport(title="flnerf-tpu", width=session.W,
                        height=session.H)
    dpg.setup_dearpygui()
    dpg.show_viewport()
    while dpg.is_dearpygui_running():
        out = session.frame()
        dpg.set_value("_texture", out["render"]["image"])
        dpg.render_dearpygui_frame()
    dpg.destroy_context()
