"""The port's GUI and gradio apps (apps/gui.py, apps/gradio_app.py), the
trainer's reset_weights and the eval's aabb_infer, on the CPU:

- OrbitCamera's pose and intrinsics after orbit / scale / pan equal JAX's
  (the same scipy rotations; float32 poses bitwise);
- one NeRFGUICore.test_step frame at 32 x 32 (the GUI's camera, shading,
  light direction and background) equals the JAX GUI core's frame on the
  same params and grid, with and without an aabb_infer box. The JAX core
  renders through JAX's direct full-K render_grid (a stand-in trainer),
  the port's through its staged eval: rtol 1e-4 / atol 1e-5 with the f32
  table, the staged-against-direct tolerance of tests/test_torch_eval.py;
- reset_weights: step 0, a fresh optimizer (no state) and grid, budgets
  and EMA restarted, params equal to a fresh init from the same generator
  state, and the next step equal to a new Trainer's step from the same
  weights and generators (Adam and Shampoo: no stale optimizer state);
- the dearpygui wiring through the fake dpg module of
  tests/test_gui_dpg.py, the render loop, and main(--gui);
- submit_generator yields previews, then the orbit; build_app raises an
  ImportError that names gradio.
"""

import functools
import importlib.util
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.apps import gui as jgui
from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.models.networks import make_field_fns as j_field_fns
from dreamfusion_tpu.ops import marching as jmarch

from dreamfusion_torch.apps import gui as tgui
from dreamfusion_torch.config import Config as TConfig
from dreamfusion_torch.models.networks import build_model
from dreamfusion_torch.training import trainer as ttrainer
from dreamfusion_torch.weights import from_jax_grid_state

from test_gui_dpg import FakeDpg
from test_torch_marching import _nerf_pair
from test_torch_mesh import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _cam_moves(cam):
    cam.orbit(120.0, -35.0)
    cam.scale(1.5)
    cam.pan(80.0, -40.0, 10.0)
    cam.orbit(-20.0, 60.0)


def test_orbit_camera_matches_jax():
    jc, tc = jgui.OrbitCamera(48, 32, r=2.5, fovy=50.0), \
        tgui.OrbitCamera(48, 32, r=2.5, fovy=50.0)
    np.testing.assert_array_equal(tc.pose, jc.pose)
    _cam_moves(jc)
    _cam_moves(tc)
    assert tc.pose.dtype == np.float32
    np.testing.assert_array_equal(tc.pose, jc.pose)
    np.testing.assert_array_equal(tc.intrinsics, jc.intrinsics)
    np.testing.assert_array_equal(tc.center, jc.center)
    assert tc.radius == jc.radius


class _JaxStandIn:
    """What JAX's NeRFGUICore.test_step reads of a Trainer, rendering
    through JAX's direct full-K render_grid."""

    def __init__(self, jcfg, jm, params, gs):
        self.renderer, self.mesh, self.grid_state = "grid", None, gs
        self.state = type("S", (), {"params": params})()
        self.cfg, self.jm = jcfg, jm

    def _get_eval_render(self, H, W):
        cfg, jm = self.cfg, self.jm

        @functools.partial(jax.jit, static_argnames="code")
        def direct(params, o, d, gs, light_d, bg_color, ambient_ratio, code):
            fns = j_field_fns(jm, params)._replace(normal=None)
            return jmarch.render_grid(
                jax.random.PRNGKey(0), fns, gs, o, d, bound=cfg.bound,
                min_near=cfg.min_near, max_steps=cfg.max_steps, K=cfg.grid_K,
                bg_radius=cfg.bg_radius, light_d=light_d,
                ambient_ratio=ambient_ratio, shading_code=code,
                bg_color=(None if bg_color is None else
                          jnp.broadcast_to(bg_color, (o.shape[0], 3))),
                perturb=False,
                aabb=(None if cfg.aabb_infer is None
                      else jnp.asarray(cfg.aabb_infer, jnp.float32)))

        def render(params, o, d, gs, shading_code=0, ambient_ratio=1.0,
                   light_d=None, bg_color=None):
            out = direct(params, o, d, gs, light_d, bg_color, ambient_ratio,
                         code=int(shading_code))
            return {k: v.reshape((H, W) + v.shape[1:]) for k, v in out.items()
                    if k in ("image", "depth", "weights_sum")}

        return render


def _gui_pair(aabb_infer=None, bg_radius=1.4):
    kw = dict(text="x", grid_ray=True, fp16=False, grid_size=32,
              max_steps=64, grid_K=32, H=32, W=32, bg_radius=bg_radius,
              eval_table_bf16=False, aabb_infer=aabb_infer)
    jcfg = JConfig(**kw)
    jm, params, tm = _nerf_pair(2)
    if bg_radius <= 0:
        params = {"params": {k: v for k, v in params["params"].items()
                             if k != "bg_net"}}
    gs = jmarch.init_grid_state(jcfg.cascade, jcfg.grid_size)
    gs = jmarch.make_update_extra_state(jcfg, jm.clone(bg_radius=bg_radius))(
        params, gs, jax.random.PRNGKey(2))
    tcfg = TConfig(**kw, max_ray_batch=64, guidance="none", device="cpu",
                   workspace="unused")
    return jcfg, jm.clone(bg_radius=bg_radius), params, gs, tcfg, tm


@pytest.mark.parametrize("shading,aabb,bg", [
    ("albedo", None, None),
    ("albedo", (-0.6, -1.0, -0.4, 1.0, 0.5, 1.0), None),
    ("lambertian", None, (0.2, 0.4, 0.9))],
    ids=["albedo", "aabb_infer", "lambertian_bg_color"])
def test_gui_frame_matches_jax(tmp_path, shading, aabb, bg):
    bg_radius = 1.4 if bg is None else 0.0
    jcfg, jm, params, gs, tcfg, tm = _gui_pair(aabb, bg_radius)
    tr = ttrainer.Trainer("t", tcfg.replace(workspace=str(tmp_path)),
                          use_checkpoint="scratch")
    sd = tm.state_dict()
    if bg_radius <= 0:
        sd = {k: v for k, v in sd.items() if not k.startswith("bg_net")}
    tr.model.load_state_dict(sd)
    tr.grid_state = from_jax_grid_state(gs, CPU)
    jcore = jgui.NeRFGUICore(jcfg, _JaxStandIn(jcfg, jm, params, gs))
    tcore = tgui.NeRFGUICore(tcfg, tr)
    for core in (jcore, tcore):
        _cam_moves(core.cam)
        core.shading = shading
        core.light_dir = [35.0, 120.0]
        core.ambient_ratio = 0.3
        core.bg_color = None if bg is None else np.asarray(bg, np.float32)
        core.dynamic_resolution = False
    js, ts = jcore.test_step(), tcore.test_step()
    assert ts["resolution"] == js["resolution"] == (32, 32)
    ref = np.asarray(jcore.render_buffer)
    got = tcore.render_buffer
    assert got.shape == (32, 32, 3) and ref.shape == (32, 32, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert ref.std() > 1e-3                       # the frame has content
    # the depth view of the same frame
    jcore.mode = tcore.mode = "depth"
    jcore.need_update = tcore.need_update = True
    jcore.test_step()
    tcore.test_step()
    np.testing.assert_allclose(tcore.render_buffer,
                               np.asarray(jcore.render_buffer), rtol=1e-4,
                               atol=1e-5)


def test_aabb_infer_changes_the_eval_only(tmp_path):
    """A narrow aabb_infer box removes content from the eval frame; the
    train step's rays keep the +-bound box (same loss either way)."""
    _, _, _, gs, tcfg, tm = _gui_pair()
    cfgs = [tcfg.replace(workspace=str(tmp_path / "a")),
            tcfg.replace(workspace=str(tmp_path / "b"),
                         aabb_infer=(-0.2, -0.2, -0.2, 0.2, 0.2, 0.2))]
    frames, losses = [], []
    for cfg in cfgs:
        tr = ttrainer.Trainer("t", cfg.replace(h=8, w=8),
                              use_checkpoint="scratch")
        tr.model.load_state_dict(tm.state_dict())
        tr.grid_state = from_jax_grid_state(gs, CPU)
        frames.append(tr._render_orbit_frame(0, 4, 32, 32)["weights_sum"])
        g = torch.Generator().manual_seed(0)
        tr.step_gen, tr.step_host_gen = g, torch.Generator().manual_seed(0)
        losses.append(float(tr.train_step()["loss"]))
    assert float(frames[1].sum()) < float(frames[0].sum())
    assert losses[0] == losses[1]


def _tiny_cfg(tmp_path, **kw):
    base = dict(text="a cube", guidance="none", grid_ray=True, dir_text=True,
                h=8, w=8, grid_size=8, max_steps=32, iters=20, H=12, W=12,
                update_extra_interval=2, device="cpu",
                workspace=str(tmp_path))
    base.update(kw)
    return TConfig(**base)


@pytest.mark.parametrize("optimizer,backbone", [("adam", "grid"),
                                                ("shampoo", "vanilla")])
def test_reset_weights_is_a_fresh_start(tmp_path, optimizer, backbone):
    """-O with Adam on the grid field; Shampoo on the vanilla field (the
    stratified renderer, no grid), whose small blocks keep the CPU's
    preconditioner roots cheap."""
    cfg = _tiny_cfg(tmp_path, optimizer=optimizer, ema_decay=0.9,
                    backbone=backbone, grid_ray=backbone == "grid",
                    num_steps=8, upsample_steps=8).finalize()
    tr = ttrainer.Trainer("t", cfg, use_checkpoint="scratch")
    tr.train(max_steps=1, log_interval=10 ** 9, checkpoint_at_end=False)
    assert len(tr.opt.state) > 0
    before = tr.gen.get_state()
    tr.reset_weights()
    assert tr.step == 0 and len(tr.opt.state) == 0
    assert tr.lr_sched.last_epoch == 0
    if backbone == "grid":
        assert not bool(tr.grid_state.occ.any())
        assert float(tr.grid_state.density_grid.abs().max()) == 0.0
    assert (tr._cur_grid_K, tr._cur_compact_M) == (cfg.grid_K, None)
    fresh = build_model(cfg, CPU, torch.Generator().manual_seed(0))
    gen = torch.Generator()
    gen.set_state(before)
    fresh.reset_parameters(gen)
    for (k, a), b in zip(tr.model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    for k, p in tr.model.named_parameters():
        assert torch.equal(tr.ema[k], p.float()), k
    # a new Trainer from the same weights and generator states takes the
    # same first step, bit for bit (Shampoo builds its preconditioners at
    # that step): nothing of the old optimizer survives the reset
    other = ttrainer.Trainer("t", cfg.replace(workspace=str(tmp_path / "o")),
                             use_checkpoint="scratch")
    other.model.load_state_dict(tr.model.state_dict())
    for k in other.ema:
        other.ema[k].copy_(tr.ema[k])
    other.gen.set_state(tr.gen.get_state())
    other.host_gen.set_state(tr.host_gen.get_state())
    for t in (tr, other):
        t.train(max_steps=1, log_interval=10 ** 9, checkpoint_at_end=False)
    for (k, a), b in zip(tr.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.fixture
def gui(tmp_path):
    cfg = _tiny_cfg(tmp_path, H=16, W=16)
    return tgui.NeRFGUI(cfg, ttrainer.Trainer("gui", cfg,
                                              use_checkpoint="scratch"))


def test_widget_tree_and_callbacks(gui):
    dpg = FakeDpg()
    gui.register_dpg(dpg)
    for tag in ("_texture", "_button_train", "_button_reset", "_button_save",
                "_button_mesh", "_color_editor", "_log_infer_time",
                "_viewport", "_aabb_min_x", "_aabb_max_z"):
        assert tag in dpg.items, tag
    dpg.fire("_button_train")
    assert gui.training and dpg.items["_button_train"]["label"] == "stop"
    dpg.fire("_button_train")
    assert not gui.training
    dpg.fire("shading", "lambertian")
    dpg.fire("mode", "depth")
    dpg.fire("FoV (vertical)", 90)
    dpg.fire("ambient", 0.25)
    dpg.fire("theta", 45.0)
    dpg.fire("phi", 90.0)
    dpg.fire("_color_editor", (0.5, 0.25, 0.125, 1.0))
    assert (gui.shading, gui.mode, gui.cam.fovy, gui.ambient_ratio) == \
        ("lambertian", "depth", 90, 0.25)
    assert gui.light_dir == [45.0, 90.0]
    np.testing.assert_allclose(gui.bg_color, [0.5, 0.25, 0.125])
    gui.trainer._get_eval_render(16, 16)
    dpg.fire("max steps", 16)
    assert gui.cfg.max_steps == gui.trainer.cfg.max_steps == 16
    assert gui.trainer._eval_render is None
    dpg.fire("dt_gamma", 0.01)
    assert gui.trainer.cfg.dt_gamma == 0.01
    dpg.fire("_aabb_min_x", -0.5)
    dpg.fire("_aabb_max_z", 0.25)
    assert gui.trainer.cfg.aabb_infer == (-0.5, -1.0, -1.0, 1.0, 1.0, 0.25)
    gui.need_update = True
    stats = gui.test_step()
    assert stats["resolution"] == (16, 16)
    assert np.isfinite(gui.render_buffer).all()
    # the mouse handlers move the camera
    pose0 = gui.cam.pose.copy()
    fired = 0
    for tag, (cb, _) in list(dpg.callbacks.items()):
        if "mouse" in tag:
            cb(None, (0, 30.0, 10.0) if "drag" in tag else 2.0)
            fired += 1
    assert fired == 3 and not np.allclose(gui.cam.pose, pose0)


def test_render_loop_reset_save_and_mesh_buttons(gui, tmp_path):
    """Two frames of the main loop while training (a burst, a preview into
    the texture), the reset button, the save button and the mesh button."""
    dpg = FakeDpg()
    dpg.running_frames = 2
    gui.training = True
    gui.train_steps = 2
    gui.train_budget_ms = 1e-3     # the budget's smallest burst: 4 steps
    gui.render(dpg=dpg)
    assert gui.step == gui.trainer.step == 6        # bursts of 2, then 4
    assert "ms (" in dpg.values["_log_train_time"]
    assert dpg.values["_texture"].shape == (16, 16, 3)
    assert dpg.values["_log_resolution"].count("x") == 1
    # a preview at a lower resolution is resized to the texture
    gui.downscale, gui.need_update = 0.5, True
    gui.training = False
    gui.render_frame_once(dpg)
    assert dpg.values["_log_resolution"] == "8x8"
    assert dpg.values["_texture"].shape == (16, 16, 3)
    dpg.fire("_button_save")
    assert dpg.values["_log_ckpt"].startswith("saved step_")
    dpg.fire("_button_reset")
    assert gui.step == 0 and gui.trainer.step == 0 and gui.need_update
    gui.training = True
    dpg.running_frames = 1
    gui.render(dpg=dpg)
    assert gui.trainer.step == gui.train_steps


def test_mesh_button_exports(gui, monkeypatch):
    calls = []
    monkeypatch.setattr(gui.trainer, "save_mesh",
                        lambda resolution: calls.append(resolution))
    dpg = FakeDpg()
    gui.register_dpg(dpg)
    dpg.fire("_button_mesh")
    assert calls == [256] and dpg.values["_log_mesh"] == "saved mesh"


def test_resize_nearest_matches_jax_image_resize():
    buf = np.random.default_rng(0).uniform(size=(8, 12, 3)).astype(np.float32)
    for H, W in ((16, 16), (13, 29), (4, 5)):
        want = np.asarray(jax.image.resize(jnp.asarray(buf), (H, W, 3),
                                           "nearest"))
        np.testing.assert_array_equal(tgui.resize_nearest(buf, H, W), want)


def test_main_gui_flag_launches_nerfgui(tmp_path, monkeypatch):
    """--gui through main, with the fake module installed as dearpygui;
    with no dearpygui the window raises an ImportError that names it."""
    from dreamfusion_torch.main import main

    dpg = FakeDpg()
    dpg.running_frames = 0
    package = types.ModuleType("dearpygui")
    package.dearpygui = dpg
    monkeypatch.setitem(sys.modules, "dearpygui", package)
    monkeypatch.setitem(sys.modules, "dearpygui.dearpygui", dpg)
    gui = main(["-O", "--text", "a cube", "--guidance", "none", "--gui",
                "--h", "8", "--w", "8", "--grid_size", "8", "--max_steps",
                "32", "--W", "16", "--H", "16", "--device", "cpu",
                "--ckpt", "scratch", "--workspace", str(tmp_path / "ws")])
    assert isinstance(gui, tgui.NeRFGUI)
    assert "_button_train" in dpg.items and gui.trainer.step == 0
    monkeypatch.setitem(sys.modules, "dearpygui", None)
    monkeypatch.delitem(sys.modules, "dearpygui.dearpygui")
    with pytest.raises(ImportError, match="dearpygui"):
        gui.render()


def test_submit_generator_yields_previews_then_the_orbit(tmp_path):
    from dreamfusion_torch.apps.gradio_app import submit_generator

    out = list(submit_generator(
        "a cube", iters=4, seed=0, workspace=str(tmp_path / "g"),
        preview_every=2,
        cfg_overrides=dict(guidance="none", device="cpu", h=8, w=8, W=12,
                           H=12, num_steps=8, upsample_steps=8,
                           max_ray_batch=256)))
    assert len(out) >= 2
    for img, msg in out[:-1]:
        # the preview's size follows the 200 ms budget: 12^2 down to 8^2
        assert img.shape[2] == 3 and 8 <= img.shape[0] == img.shape[1] <= 12
        assert np.isfinite(img).all() and msg.startswith("step ")
    assert out[0][1].startswith("step 2/4")     # the first burst's size
    assert int(out[-2][1].split()[1].split("/")[0]) >= 4
    img, msg = out[-1]
    assert img.shape == (12, 12, 3) and img.dtype == np.uint8
    assert msg.startswith("done: 36-frame orbit")


def test_build_app_names_gradio():
    from dreamfusion_torch.apps.gradio_app import build_app

    if importlib.util.find_spec("gradio") is not None:
        pytest.skip("gradio is installed; the check is for hosts without it")
    with pytest.raises(ImportError, match="gradio"):
        build_app()
