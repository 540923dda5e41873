"""Interactive viewer and trainer (counterpart of
dreamfusion_tpu/apps/gui.py; reference nerf/gui.py).

``NeRFGUICore`` is the headless part: the orbit camera, train bursts with
the reference's adaptive burst size (<= 500 ms a 16-step burst), preview
frames with its adaptive resolution (<= 200 ms a frame) and progressive
accumulation up to cfg.max_spp samples a pixel. A burst runs
``Trainer.advance`` (train_step with the occupancy refreshes and budget
re-picks of Trainer.train, as the reference's train_gui refreshes the grid);
a preview renders through ``Trainer._get_eval_render(H, W)`` (on the grid
renderer the staged eval) with the GUI's shading, light direction and
background. ``NeRFGUI`` mounts the dearpygui window on top; the dpg module
is injectable, so the widget tree and its callbacks run without a display.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from dreamfusion_torch import cameras
from dreamfusion_torch.models.networks import (SHADING_ALBEDO,
                                               SHADING_LAMBERTIAN,
                                               SHADING_NORMAL,
                                               SHADING_TEXTURELESS)

SHADING_CODES = {"albedo": SHADING_ALBEDO, "lambertian": SHADING_LAMBERTIAN,
                 "textureless": SHADING_TEXTURELESS, "normal": SHADING_NORMAL}
# the reference GUI's camera (nerf/gui.py:58-63: radius 3, fovy 60)
GUI_RADIUS = 3.0
GUI_FOVY = 60.0


class OrbitCamera:
    """Quaternion orbit / pan / scale camera (reference nerf/gui.py:10-52)."""

    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.rot = R.from_quat([1, 0, 0, 0])
        self.up = np.array([0, 1, 0], np.float32)

    @property
    def pose(self) -> np.ndarray:
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot.as_matrix()
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * np.tan(np.deg2rad(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2])

    def orbit(self, dx: float, dy: float):
        side = self.rot.as_matrix()[:3, 0]
        rotvec_x = self.up * np.deg2rad(-0.1 * dx)
        rotvec_y = side * np.deg2rad(-0.1 * dy)
        self.rot = R.from_rotvec(rotvec_x) * R.from_rotvec(rotvec_y) * self.rot

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 0.0005 * self.rot.as_matrix()[:3, :3] @ np.array(
            [dx, dy, dz])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class NeRFGUICore:
    """Headless GUI logic: train bursts and progressive previews with the
    reference's adaptive budgets (gui.py:88-152)."""

    def __init__(self, cfg, trainer, train_budget_ms: float = 500.0,
                 infer_budget_ms: float = 200.0):
        self.cfg = cfg
        self.trainer = trainer
        self.cam = OrbitCamera(cfg.W, cfg.H, r=GUI_RADIUS, fovy=GUI_FOVY)
        self.train_steps = 16
        self.downscale = 1.0
        self.dynamic_resolution = True
        self.spp = 1
        self.need_update = True
        self.render_buffer: Optional[np.ndarray] = None
        self.mode = "image"       # or "depth"
        self.bg_color = None      # [3] in [0, 1] (used when bg_radius <= 0)
        self.shading = "albedo"   # albedo | lambertian | textureless | normal
        self.ambient_ratio = 1.0
        self.light_dir = [60.0, 0.0]   # (theta, phi) degrees (gui.py:72-77)
        self.training = False
        self.step = 0
        self.train_budget_ms = train_budget_ms
        self.infer_budget_ms = infer_budget_ms
        self._last_metrics = None

    # -- training burst (gui.py:88-110) -----------------------------------------

    def train_step(self) -> Dict:
        """train_steps steps, timed to the device's end of the last one;
        then the burst size for the 500 ms budget."""
        t0 = time.perf_counter()
        for _ in range(self.train_steps):
            self._last_metrics = self.trainer.advance(self._last_metrics)
        _sync(self.trainer.device)
        t = (time.perf_counter() - t0) * 1000.0
        self.step += self.train_steps
        self.need_update = True

        full_t = t / self.train_steps * 16
        steps = min(16, max(4, int(16 * self.train_budget_ms
                                   / max(full_t, 1e-3))))
        if steps > self.train_steps * 1.2 or steps < self.train_steps * 0.8:
            self.train_steps = steps
        return {"loss": float(self._last_metrics["loss"]), "time_ms": t,
                "train_steps": self.train_steps, "step": self.step}

    def reset(self) -> None:
        """The reset button (gui.py:221-233): Trainer.reset_weights, and the
        burst count and metrics start over."""
        self.trainer.reset_weights()
        self._last_metrics = None
        self.step = 0
        self.need_update = True

    # -- preview rendering (gui.py:120-152) -----------------------------------------

    def render_view(self, H: int, W: int) -> Dict[str, torch.Tensor]:
        """One frame of the current view at H x W with the GUI's shading,
        light direction and background."""
        tr = self.trainer
        dev = tr.device
        pose = torch.from_numpy(self.cam.pose)[None].to(dev)
        intr = (self.cam.intrinsics * self.downscale).astype(np.float32)
        fx, fy = float(intr[0]), float(intr[1])
        rays_o, rays_d = cameras.get_rays(pose, (fx, fy, W / 2, H / 2), H, W)
        th, ph = np.deg2rad(self.light_dir[0]), np.deg2rad(self.light_dir[1])
        light_d = torch.tensor([np.sin(th) * np.sin(ph), np.cos(th),
                                np.sin(th) * np.cos(ph)], dtype=torch.float32,
                               device=dev)
        kw = dict(shading_code=SHADING_CODES[self.shading],
                  ambient_ratio=self.ambient_ratio, light_d=light_d)
        if self.bg_color is not None:
            kw["bg_color"] = torch.as_tensor(np.asarray(self.bg_color),
                                             dtype=torch.float32, device=dev)
        return tr._get_eval_render(H, W)(rays_o[0], rays_d[0], tr.grid_state,
                                         **kw)

    def test_step(self) -> Dict:
        if not (self.need_update or self.spp < self.cfg.max_spp):
            return {"skipped": True}
        t0 = time.perf_counter()
        W = max(8, int(self.cam.W * self.downscale))
        H = max(8, int(self.cam.H * self.downscale))
        out = self.render_view(H, W)
        img = (out["image"] if self.mode == "image"
               else out["depth"][..., None].expand(H, W, 3))
        buf = img.float().cpu().numpy()
        t = (time.perf_counter() - t0) * 1000.0

        if self.dynamic_resolution:     # <= 200 ms a frame at full size
            full_t = t / (self.downscale ** 2)
            ds = min(1.0, max(0.25, math.sqrt(self.infer_budget_ms
                                              / max(full_t, 1e-3))))
            if ds > self.downscale * 1.2 or ds < self.downscale * 0.8:
                self.downscale = ds

        if self.need_update:
            self.render_buffer = buf
            self.spp = 1
            self.need_update = False
        else:
            self.render_buffer = ((self.render_buffer * self.spp + buf)
                                  / (self.spp + 1))
            self.spp += 1
        return {"time_ms": t, "resolution": (H, W), "spp": self.spp}


def resize_nearest(buf: np.ndarray, H: int, W: int) -> np.ndarray:
    """[h, w, C] -> [H, W, C], each output pixel taking the input pixel
    under its centre (jax.image.resize's "nearest")."""
    h, w = buf.shape[:2]
    ys = np.minimum(((np.arange(H) + 0.5) * h / H).astype(np.int64), h - 1)
    xs = np.minimum(((np.arange(W) + 0.5) * w / W).astype(np.int64), w - 1)
    return buf[ys[:, None], xs[None, :]]


class NeRFGUI(NeRFGUICore):
    """The dearpygui window over the headless core (reference
    nerf/gui.py:155-468). ``register_dpg`` and ``render_frame_once`` take
    the dpg module as an argument, so a test can drive them with a fake;
    ``render()`` imports dearpygui when none is given."""

    def _import_dpg(self):
        try:
            import dearpygui.dearpygui as dpg
        except ImportError as e:
            raise ImportError(
                "NeRFGUI needs dearpygui (pip install dearpygui); the "
                "headless core (NeRFGUICore.train_step / test_step) works "
                "without it") from e
        return dpg

    def _set_cfg(self, **kw):
        """Replace config fields, for the trainer too (its eval renderer is
        rebuilt at the next frame)."""
        self.cfg = self.cfg.replace(**kw)
        self.trainer.set_config(self.cfg)
        self.need_update = True

    def register_dpg(self, dpg):
        """Build the widget tree (gui.py:155-468): the render texture, the
        control window (train / reset / checkpoint / mesh buttons; dynamic
        resolution, mode, background, fovy, dt_gamma, max_steps, light,
        ambient, shading and the inference box), and the orbit / scale / pan
        mouse handlers."""
        cfg = self.cfg
        W, H = self.cam.W, self.cam.H
        self.render_buffer = np.zeros((H, W, 3), np.float32)

        with dpg.texture_registry(show=False):
            dpg.add_raw_texture(W, H, self.render_buffer,
                                format=dpg.mvFormat_Float_rgb, tag="_texture")

        with dpg.window(tag="_primary_window", width=W, height=H):
            dpg.add_image("_texture")
        dpg.set_primary_window("_primary_window", True)

        with dpg.window(label="Control", tag="_control_window",
                        width=400, height=300):
            if cfg.text is not None:
                dpg.add_text("text: " + cfg.text, tag="_log_prompt_text")
            if cfg.negative:
                dpg.add_text("negative text: " + cfg.negative,
                             tag="_log_prompt_negative_text")

            with dpg.group(horizontal=True):
                dpg.add_text("Train time: ")
                dpg.add_text("no data", tag="_log_train_time")
            with dpg.group(horizontal=True):
                dpg.add_text("Infer time: ")
                dpg.add_text("no data", tag="_log_infer_time")
            with dpg.group(horizontal=True):
                dpg.add_text("SPP: ")
                dpg.add_text("1", tag="_log_spp")

            with dpg.collapsing_header(label="Train", default_open=True):
                with dpg.group(horizontal=True):
                    dpg.add_text("Train: ")

                    def callback_train(sender, app_data):
                        self.training = not self.training
                        dpg.configure_item(
                            "_button_train",
                            label="stop" if self.training else "start")

                    dpg.add_button(label="start", tag="_button_train",
                                   callback=callback_train)

                    dpg.add_button(label="reset", tag="_button_reset",
                                   callback=lambda sender, app_data:
                                   self.reset())

                with dpg.group(horizontal=True):
                    dpg.add_text("Checkpoint: ")

                    def callback_save(sender, app_data):
                        import os

                        path = self.trainer.save_checkpoint()
                        dpg.set_value("_log_ckpt",
                                      "saved " + os.path.basename(path))

                    dpg.add_button(label="save", tag="_button_save",
                                   callback=callback_save)
                    dpg.add_text("", tag="_log_ckpt")

                with dpg.group(horizontal=True):
                    dpg.add_text("Marching Cubes: ")

                    def callback_mesh(sender, app_data):
                        self.trainer.save_mesh(resolution=256)
                        dpg.set_value("_log_mesh", "saved mesh")

                    dpg.add_button(label="mesh", tag="_button_mesh",
                                   callback=callback_mesh)
                    dpg.add_text("", tag="_log_mesh")

            with dpg.collapsing_header(label="Options", default_open=True):
                def callback_set_dynamic_resolution(sender, app_data):
                    self.dynamic_resolution = not self.dynamic_resolution
                    if not self.dynamic_resolution:
                        self.downscale = 1.0
                    self.need_update = True

                with dpg.group(horizontal=True):
                    dpg.add_checkbox(label="dynamic resolution",
                                     default_value=self.dynamic_resolution,
                                     callback=callback_set_dynamic_resolution)
                    dpg.add_text(f"{W}x{H}", tag="_log_resolution")

                def callback_change_mode(sender, app_data):
                    self.mode = app_data
                    self.need_update = True

                dpg.add_combo(("image", "depth"), label="mode",
                              default_value=self.mode,
                              callback=callback_change_mode)

                def callback_change_bg(sender, app_data):
                    self.bg_color = np.asarray(app_data[:3], np.float32)
                    self.need_update = True

                dpg.add_color_edit((255, 255, 255), label="Background Color",
                                   width=200, tag="_color_editor",
                                   no_alpha=True, callback=callback_change_bg)

                def callback_set_fovy(sender, app_data):
                    self.cam.fovy = app_data
                    self.need_update = True

                dpg.add_slider_int(label="FoV (vertical)", min_value=1,
                                   max_value=120, format="%d deg",
                                   default_value=int(self.cam.fovy),
                                   callback=callback_set_fovy)

                def callback_set_dt_gamma(sender, app_data):
                    self._set_cfg(dt_gamma=app_data)

                dpg.add_slider_float(label="dt_gamma", min_value=0,
                                     max_value=0.1, format="%.5f",
                                     default_value=cfg.dt_gamma,
                                     callback=callback_set_dt_gamma)

                def callback_set_max_steps(sender, app_data):
                    self._set_cfg(max_steps=int(app_data))

                dpg.add_slider_int(label="max steps", min_value=1,
                                   max_value=1024, format="%d",
                                   default_value=cfg.max_steps,
                                   callback=callback_set_max_steps)

                def callback_set_light_dir(sender, app_data, user_data):
                    self.light_dir[user_data] = app_data
                    self.need_update = True

                dpg.add_separator()
                dpg.add_text("Plane Light Direction:")
                with dpg.group(horizontal=True):
                    dpg.add_slider_float(
                        label="theta", min_value=0, max_value=180,
                        format="%.2f", default_value=self.light_dir[0],
                        callback=callback_set_light_dir, user_data=0)
                with dpg.group(horizontal=True):
                    dpg.add_slider_float(
                        label="phi", min_value=0, max_value=360,
                        format="%.2f", default_value=self.light_dir[1],
                        callback=callback_set_light_dir, user_data=1)

                def callback_set_abm_ratio(sender, app_data):
                    self.ambient_ratio = app_data
                    self.need_update = True

                dpg.add_slider_float(label="ambient", min_value=0,
                                     max_value=1.0, format="%.5f",
                                     default_value=self.ambient_ratio,
                                     callback=callback_set_abm_ratio)

                def callback_change_shading(sender, app_data):
                    self.shading = app_data
                    self.need_update = True

                dpg.add_combo(tuple(SHADING_CODES), label="shading",
                              default_value=self.shading,
                              callback=callback_change_shading)

                # the inference box per axis (gui.py:319-345): aabb_infer
                # only, the train box is untouched
                b = float(cfg.bound)
                self._aabb = (list(cfg.aabb_infer) if cfg.aabb_infer
                              else [-b, -b, -b, b, b, b])

                def callback_set_aabb(sender, app_data, user_data):
                    self._aabb[user_data] = float(app_data)
                    self._set_cfg(aabb_infer=tuple(self._aabb))

                dpg.add_separator()
                dpg.add_text("Axis-aligned bounding box:")
                for axis, name in enumerate("xyz"):
                    with dpg.group(horizontal=True):
                        dpg.add_slider_float(
                            label=name, width=150, min_value=-b, max_value=0,
                            format="%.2f", default_value=self._aabb[axis],
                            tag=f"_aabb_min_{name}",
                            callback=callback_set_aabb, user_data=axis)
                        dpg.add_slider_float(
                            label="", width=150, min_value=0, max_value=b,
                            format="%.2f", default_value=self._aabb[axis + 3],
                            tag=f"_aabb_max_{name}",
                            callback=callback_set_aabb, user_data=axis + 3)

        def callback_camera_drag_rotate(sender, app_data):
            if not dpg.is_item_focused("_primary_window"):
                return
            self.cam.orbit(app_data[1], app_data[2])
            self.need_update = True

        def callback_camera_wheel_scale(sender, app_data):
            if not dpg.is_item_focused("_primary_window"):
                return
            self.cam.scale(app_data)
            self.need_update = True

        def callback_camera_drag_pan(sender, app_data):
            if not dpg.is_item_focused("_primary_window"):
                return
            self.cam.pan(app_data[1], app_data[2])
            self.need_update = True

        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left,
                                       callback=callback_camera_drag_rotate)
            dpg.add_mouse_wheel_handler(callback=callback_camera_wheel_scale)
            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Middle,
                                       callback=callback_camera_drag_pan)

        dpg.create_viewport(title="dreamfusion-torch", width=W, height=H,
                            resizable=False)
        dpg.setup_dearpygui()
        dpg.show_viewport()

    def render_frame_once(self, dpg):
        """One main-loop iteration (gui.py:461-468): a train burst when
        training, then a preview frame into the texture."""
        if self.training:
            stats = self.train_step()
            dpg.set_value("_log_train_time", f"{stats['time_ms']:.1f} ms "
                                             f"({stats['train_steps']} steps)")
        stats = self.test_step()
        if not stats.get("skipped"):
            dpg.set_value("_log_infer_time", f"{stats['time_ms']:.1f} ms")
            dpg.set_value("_log_spp", str(self.spp))
            dpg.set_value("_log_resolution",
                          f"{stats['resolution'][1]}x{stats['resolution'][0]}")
            buf = self.render_buffer
            if buf.shape[:2] != (self.cam.H, self.cam.W):
                buf = resize_nearest(buf, self.cam.H, self.cam.W)
            dpg.set_value("_texture", buf.astype(np.float32))

    def render(self, dpg=None):
        dpg = dpg or self._import_dpg()
        dpg.create_context()
        self.register_dpg(dpg)
        while dpg.is_dearpygui_running():
            self.render_frame_once(dpg)
            dpg.render_dearpygui_frame()
        dpg.destroy_context()
