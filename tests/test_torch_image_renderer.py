"""The port's image renderer and metrics (training/image_renderer.py,
training/metrics.py, models/zoo.py) against the JAX package, on the CPU:

- look_at_to_c2w and cord_spherical equal;
- one small orbit frame, a snap_shot and renderViews of the same DVGO
  field (coarse, and fine with a residual colour MLP), chunked: 1e-5;
- rgb_psnr and rgb_ssim to 1e-6, clip_r_precision equal;
- the registry's base entries; the CLI renders a .dvgo file into a GIF, or
  into PNG frames (said so) when imageio cannot be imported.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from dreamfusion_tpu.models import dvgo as jd
from dreamfusion_tpu.training import image_renderer as jir
from dreamfusion_tpu.training import metrics as jm

from dreamfusion_torch.models import zoo
from dreamfusion_torch.training import dvgo_trainer as tt
from dreamfusion_torch.training import image_renderer as tir
from dreamfusion_torch.training import metrics as tm
from dreamfusion_torch.weights import from_jax_dvgo

CPU = torch.device("cpu")


def _pair(fine):
    kw = dict(world_size=(8, 9, 10), alpha_init=1e-2)
    kw.update(dict(k0_dim=4, rgbnet_name="resmlp", rgbnet_width=16,
                   posbase_pe=2, viewbase_pe=2) if fine else dict(k0_dim=3))
    jf = jd.DVGOField(**kw)
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.array([[0.0, 0, 1.0]], np.float32), (4, 1))
    params = jax.tree.map(np.asarray, jf.init(
        jax.random.PRNGKey(1), o, d, d, near=0.1, far=6.0, bg=1.0,
        n_samples=jf.n_render_samples(6.0), method=jf.render))
    params["params"]["density"] = params["params"]["density"] * 3 + 1
    tf = zoo.get_field("dvgo_fine" if fine else "dvgo_coarse", **kw)
    tf.load_state_dict(from_jax_dvgo(params))
    return jf, params, tf.eval()


def test_pose_builders_match():
    for C, p in (([0, 0, 3.0], [0, 0, 0]), ([1.0, -2, 0.5], [0.2, 0.1, 0])):
        np.testing.assert_array_equal(
            tir.look_at_to_c2w(np.array(C), np.array(p)),
            jir.look_at_to_c2w(np.array(C), np.array(p)))
    for args in ((2.0, 60.0, 30.0), (1.5, 10.0, 275.0)):
        np.testing.assert_array_equal(tir.cord_spherical(*args),
                                      jir.cord_spherical(*args))


@pytest.mark.parametrize("fine", [False, True])
def test_orbit_frame_snap_shot_and_views_match(fine):
    jf, params, tf = _pair(fine)
    jr = jir.ImageRenderer(jf, params, near=0.1, far=6.0, batch_size=100)
    tr = tir.ImageRenderer(tf, near=0.1, far=6.0, batch_size=100)
    ref = jir.render_round_views(jr, 12, 10, 14.0, num_imgs=2, dis=3.0)
    got = tir.render_round_views(tr, 12, 10, 14.0, num_imgs=2, dis=3.0)
    assert got[0].shape == (12, 10, 3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert max(np.abs(f - 1.0).max() for f in ref) > 0.05   # not all bg
    np.testing.assert_allclose(
        tir.snap_shot(tr, 8, 8, 10.0, position=[0, 0.5, 3.0]),
        jir.snap_shot(jr, 8, 8, 10.0, position=[0, 0.5, 3.0]), atol=1e-5)
    K = np.array([[9.0, 0, 4], [0, 9.0, 3], [0, 0, 1]], np.float32)
    pose = tir.look_at_to_c2w(np.array([2.0, 1.0, 2.0]), np.zeros(3))
    for a, b in zip(tr.renderViews([(6, 8)], [K], [pose]),
                    jr.renderViews([(6, 8)], [K], [pose])):
        np.testing.assert_allclose(a, b, atol=1e-5)
    depth = tir.ImageRenderer(tf, near=0.1, far=6.0, key="depths")
    assert depth.renderView(6, 8, K, pose).shape == (6, 8, 1)


def test_psnr_ssim_and_r_precision_match():
    rng = np.random.RandomState(0)
    a = rng.rand(32, 40, 3)
    noisy = np.clip(a + rng.randn(32, 40, 3) * 0.1, 0, 1)
    for x, y in ((a, a), (a, noisy)):
        np.testing.assert_allclose(tm.rgb_psnr(x, y), jm.rgb_psnr(x, y),
                                   atol=1e-6)
        np.testing.assert_allclose(tm.rgb_ssim(x, y), jm.rgb_ssim(x, y),
                                   atol=1e-6)
    np.testing.assert_allclose(tm.rgb_ssim(a, noisy, return_map=True),
                               jm.rgb_ssim(a, noisy, return_map=True),
                               atol=1e-6)
    txt = rng.randn(5, 16)
    img = txt[[0, 1, 2]] + rng.randn(3, 16) * 0.5
    for R in (1, 2):
        for idx in ([0, 1, 2], [4, 1, 0]):
            assert tm.clip_r_precision(img, txt, idx, R) == \
                jm.clip_r_precision(img, txt, idx, R)
    with pytest.raises(ImportError, match="lpips"):
        tm.rgb_lpips(a, a)


def test_zoo_registers_the_base_fields():
    """The base entries are DVGOField itself; the zoo's variants (and, once
    an "osr" name is asked for, the OSR fields) subclass it."""
    from dreamfusion_torch.models.dvgo import DVGOField

    assert {"dvgo_coarse", "dvgo_fine"} <= set(zoo.field_registry)
    assert zoo.field_registry["dvgo_fine"] is DVGOField
    assert zoo.get_field("dvgo_coarse", world_size=(4, 4, 4)).rgbnet is None
    ffl = zoo.get_field("ffl_fine", world_size=(4, 4, 4))
    assert isinstance(ffl, DVGOField) and type(ffl) is not DVGOField


@pytest.mark.parametrize("imageio_present", [True, False])
def test_cli_renders_a_dvgo_file(tmp_path, monkeypatch, capsys,
                                 imageio_present):
    """A .dvgo written by DVGOTrainer.save_dvgo renders through the CLI:
    a GIF of the orbit, or without imageio one PNG a frame."""
    _, _, field = _pair(fine=True)
    tr = tt.DVGOTrainer(field, tt.DVGOStageConfig(), near=0.1, far=6.0,
                        device=CPU)
    path = tr.save_dvgo(str(tmp_path / "scene.dvgo"))
    out = str(tmp_path / "orbit.gif")
    if not imageio_present:
        monkeypatch.setitem(sys.modules, "imageio", None)
    paths = tir.main([path, "--out", out, "--num_imgs", "2", "--H", "6",
                      "--W", "6", "--focal", "8", "--device", "cpu"])
    said = capsys.readouterr().out
    if imageio_present:
        assert paths == [out] and f"wrote {out}" in said
        import imageio.v2 as imageio

        frames = imageio.mimread(out)
        assert len(frames) == 2 and frames[0].shape[:2] == (6, 6)
    else:
        assert "imageio is not installed" in said and len(paths) == 2
        from dreamfusion_torch.datasets.loaders import read_png

        assert read_png(paths[1]).shape == (6, 6, 3)
