"""Parity of the port's -O2 path (the stratified renderer, path A) with the
JAX package, on the CPU, at a small size (16 x 16 renders, 12 + 12 samples
a ray, fp16=False so JAX takes its f32 scatter and einsum attention):

- the config: -O2's preset and finalize() (the vanilla backbone's loss
  weights), field by field against the JAX package's parse_config;
- one whole train step, make_grads_fn against JAX's make_grads_fn(renderer=
  "stratified") on one camera batch, every other draw reproduced from the
  JAX key tree (trainer.py:84, renderer.py:84), on a lambertian step: the
  grid backbone (finite-difference normals) under a fixed projection of
  the image as its guidance, and BASELINE config 1, the vanilla backbone
  with CLIP random-tiny (autograd normals with their second-order term);
  same loss (rel 1e-4) and gradient per parameter leaf (1e-3 of the leaf's
  largest entry, the tolerance of tests/test_torch_train.py, or the grid
  step's rounding control; see the test);
- one stratified eval frame against JAX's make_eval_render(renderer=
  "stratified"), in chunks that need padding (1e-5 / 1e-4);
- a stratified Trainer through train, evaluate, test and a checkpoint.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu import cameras as jcam
from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.config import parse_config as j_parse
from dreamfusion_tpu.guidance import Guidance as JGuidance
from dreamfusion_tpu.training import trainer as jtrainer

from dreamfusion_torch import cameras as tcam
from dreamfusion_torch.config import Config as TConfig
from dreamfusion_torch.config import parse_config as t_parse
from dreamfusion_torch.guidance import Guidance as TGuidance
from dreamfusion_torch.guidance import none_guidance
from dreamfusion_torch.training import trainer as ttrainer
from dreamfusion_torch.weights import from_jax_params

from test_torch_clip import _clip_pair
from test_torch_marching import _close, _nerf_pair, _t
from test_torch_train import concrete_shading  # noqa: F401
from test_torch_vanilla import _vanilla_pair

# -O2 at a small size; albedo_iters 0 so that a step may shade
O2_SMALL = dict(text="a red cube", h=16, w=16, dir_text=True, fp16=False,
                num_steps=12, upsample_steps=12, albedo_iters=0,
                lambda_orient=1e-2, iters=100)


@pytest.mark.parametrize("argv", [
    ["-O2", "--text", "a hamburger"],
    ["-O2", "--backbone", "vanilla", "--guidance", "clip",
     "--clip_weights", "random-tiny", "--text", "x"],
    ["-O", "--text", "a hamburger", "--num_steps", "32"],
    ["--backbone", "vanilla", "--upsample_steps", "0"]])
def test_config_presets_and_finalize_match_jax(argv):
    """Every field the port's Config shares with the JAX package's has the
    same value after parse_config (presets, then finalize)."""
    t, j = t_parse(argv), j_parse(argv)
    shared = set(TConfig.__dataclass_fields__) & set(JConfig.__dataclass_fields__)
    assert {"num_steps", "upsample_steps", "clip_weights"} <= shared
    assert {k: getattr(t, k) for k in shared} == {k: getattr(j, k) for k in shared}
    if "vanilla" in argv:
        assert (t.lambda_entropy, t.lambda_opacity) == (0.0, 1e-3)
    assert t.grid_ray == ("-O" in argv)


def _step_draws(key, cfg_kw):
    """The JAX stratified grads_fn key tree (trainer.py:84, renderer.py:84)
    as the port's draws; the camera batch is fixed (fixed_cameras)."""
    jcfg = JConfig(**cfg_kw)
    N = jcfg.batch_size * jcfg.h * jcfg.w
    T, U = jcfg.num_steps, jcfg.upsample_steps
    _, k_shade, k_bg, k_render, _ = jax.random.split(key, 5)
    k_light, k_perturb, k_pdf, _ = jax.random.split(k_render, 4)
    return dict(shade_u=float(jax.random.uniform(k_shade)),
                bg=_t(jax.random.uniform(k_bg, (N, 3))),
                light_n=_t(jax.random.normal(k_light, (3,))),
                perturb_u=_t(jax.random.uniform(k_perturb, (N, T))),
                pdf_u=_t(jax.random.uniform(k_pdf, (N, U))))


def _lambertian_key(start):
    """The first key from PRNGKey(start) on whose shading draw the schedule
    picks lambertian (u <= 0.4), so that the step runs the normals."""
    i = start
    while True:
        key = jax.random.PRNGKey(i)
        if float(jax.random.uniform(jax.random.split(key, 5)[1])) <= 0.4:
            return key
        i += 1


@pytest.fixture
def fixed_cameras(monkeypatch):
    """Both packages' sample_train_batch return one camera batch, the JAX
    package's for a given key (set(key, cfg_kw)); scale(s) multiplies the
    port's ray directions by s. The cameras' own parity is
    tests/test_torch_ops.py's: their f32 trig differs by ulps, which moves
    the background MLP's inputs (a frequency encoding up to 2^5 x) enough
    to flip a ReLU of a random MLP now and then."""
    from dreamfusion_tpu import cameras as jcam_mod

    from dreamfusion_torch import cameras as tcam_mod

    batch, sample = {}, jcam_mod.sample_train_batch

    def set_(key, cfg_kw):
        k_batch = jax.random.split(key, 5)[0]
        b = sample(k_batch, JConfig(**cfg_kw))
        batch["j"] = b
        batch["t"] = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    def scale(s):
        batch["t"] = dict(batch["t"], rays_d=batch["t"]["rays_d"] * s)

    monkeypatch.setattr(jcam_mod, "sample_train_batch",
                        lambda key, cfg: batch["j"])
    monkeypatch.setattr(tcam_mod, "sample_train_batch",
                        lambda cfg, generator=None, device=None, draws=None:
                        dict(batch["t"]))
    return set_, scale


def _projection_pair(cfg_kw):
    """A guidance whose loss is a fixed random projection of the image, on
    both sides (SDS's own parity in a whole step is tests/test_torch_train.py's)."""
    G = np.random.default_rng(9).normal(
        size=(1, cfg_kw["h"], cfg_kw["w"], 3)).astype(np.float32)
    jg = JGuidance(name="projection", params={}, get_text_embeds=None,
                   loss=lambda p, tz, rgb, key: jnp.mean(rgb * G))
    tg = TGuidance(name="projection", modules={}, get_text_embeds=None,
                   loss=lambda tz, rgb, draws=None, gen=None:
                   (rgb * torch.from_numpy(G)).mean())
    return jg, tg


def _grads(tm):
    return {k: p.grad.clone() for k, p in tm.named_parameters()}


@pytest.mark.parametrize("backbone", ["grid", "vanilla"],
                         ids=["grid", "vanilla, CLIP (config 1)"])
def test_o2_train_step_matches_jax(concrete_shading, fixed_cameras, backbone):
    """One lambertian -O2 step on one camera batch with the JAX key tree's
    other draws injected: the loss and the orient loss (rel 1e-4), and
    every parameter leaf's gradient within 1e-3 of the leaf's largest
    entry or, where that is larger, 3x the most that two control steps of
    the port alone move it when the ray directions change by 2^-24 (the
    grid field's finite-difference normals divide differences of sigma by
    2e-2 and normalise gradients that may be small, so at initialisation a
    rounding-sized move of the samples moves the hidden layers' gradients
    by up to ~1e-2). The vanilla step (autograd normals) holds 1e-3 on
    every leaf; its entropy weight is finalize()'s 0, its opacity 1e-3."""
    set_cameras, scale_cameras = fixed_cameras
    if backbone == "grid":
        cfg_kw = dict(O2_SMALL)
        jm, params, tm = _nerf_pair(4)
        jg, tg = _projection_pair(cfg_kw)
        text_z = np.zeros((6, 1), np.float32)
    else:
        cfg_kw = dict(O2_SMALL, backbone="vanilla", guidance="clip",
                      clip_weights="random-tiny")
        jm, params, tm = _vanilla_pair(4)
        jg, tg = _clip_pair()
        prompts = [f"a red cube, {d} view" for d in tcam.DIR_TEXTS]
        text_z = np.asarray(jg.get_text_embeds(prompts, [""] * 6))
        _close(tg.get_text_embeds(prompts, [""] * 6), text_z, 1e-5)
    jcfg, tcfg = JConfig(**cfg_kw).finalize(), TConfig(**cfg_kw).finalize()
    key = _lambertian_key(7)
    set_cameras(key, cfg_kw)
    jfn = jtrainer.make_grads_fn(jcfg, jm, jg, "stratified")
    jloss, jmet, jgrads = jfn(params, jnp.int32(1), jg.params,
                              jnp.asarray(text_z), key, None)
    tfn = ttrainer.make_grads_fn(tcfg, tm, tg)
    draws = _step_draws(key, cfg_kw)
    tloss, tmet = tfn(1, _t(text_z), None, draws=draws)
    assert tmet["shading_code"] == int(jmet["shading_code"]) == 1
    _close(tloss, jloss, 1e-4)
    _close(tmet["loss_orient"], jmet["loss_orient"], 1e-4)
    assert set(tmet) - {"n_field_samples"} >= set(jmet) - {"loss"}
    got = _grads(tm)
    ctrl = {k: torch.zeros(()) for k in got}
    if backbone == "grid":
        for s in (1 + 2.0 ** -24, 1 - 2.0 ** -24):
            scale_cameras(s)
            tfn(1, _t(text_z), None, draws=draws)
            for k, g in _grads(tm).items():
                ctrl[k] = torch.maximum(ctrl[k], (g - got[k]).abs().max())
            scale_cameras(1 / s)
    flat = from_jax_params(jax.tree.map(np.asarray, jgrads))
    assert set(flat) == set(got)
    for k, g in flat.items():
        tol = max(1e-3 * float(g.abs().max()), 3 * float(ctrl[k]))
        assert float((got[k] - g).abs().max()) <= tol, k


def test_o2_eval_frame_matches_jax():
    """A 16 x 16 orbit frame (frame 1 of 5) through the stratified eval in
    chunks of 96 rays (the last one padded): image and weights_sum 1e-5,
    depth 1e-4 (the normalized depth of the chunk's rays)."""
    cfg_kw = dict(O2_SMALL, H=16, W=16, max_ray_batch=96, test_size=5)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    jm, params, tm = _nerf_pair(6)
    b = jcam.sample_test_batch(1, 5, jcfg, H=16, W=16)
    tb = tcam.sample_test_batch(1, 5, tcfg, H=16, W=16,
                                device=torch.device("cpu"))
    _close(tb["rays_o"], b["rays_o"], 1e-5)
    ref = jtrainer.make_eval_render(jcfg, jm, 16, 16, chunk=96,
                                    renderer="stratified")(
        params, b["rays_o"][0], b["rays_d"][0])
    got = ttrainer.make_eval_render(tcfg, tm, 16, 16)(tb["rays_o"][0],
                                                      tb["rays_d"][0])
    for k, rel in (("image", 1e-5), ("weights_sum", 1e-5), ("depth", 1e-4)):
        assert got[k].shape == ref[k].shape
        _close(got[k], ref[k], rel)
    assert float(got["weights_sum"].max()) > 0.5


def test_o2_trainer_trains_evaluates_tests_and_reloads(tmp_path):
    """A stratified Trainer (no grid state) at a tiny size: two steps move
    the parameters, evaluate and test write frames, and a second Trainer
    resumes from the checkpoint at step 2 with the same parameters."""
    cfg = TConfig(**dict(O2_SMALL, h=8, w=8, num_steps=8, upsample_steps=8,
                         H=12, W=12, test_size=2, val_size=1,
                         max_ray_batch=64, device="cpu",
                         workspace=str(tmp_path / "ws")))
    tr = ttrainer.Trainer("t", cfg, guidance=none_guidance("cpu"),
                          use_checkpoint="scratch")
    assert tr.renderer == "stratified" and tr.grid_state is None
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.train(max_steps=2, log_interval=1)
    assert max(float((v - p0[k]).abs().max())
               for k, v in tr.model.state_dict().items()) > 0
    tr.evaluate(step=2)
    frames = tr.test()
    assert len(frames) == 2 and frames[0].shape == (12, 12, 3)
    assert os.path.exists(os.path.join(tr.workspace, "validation",
                                       "t_000002_0000_rgb.png"))
    tr2 = ttrainer.Trainer("t", cfg, guidance=none_guidance("cpu"))
    assert tr2.step == 2 and tr2.grid_state is None
    for k, v in tr.model.state_dict().items():
        assert torch.equal(tr2.model.state_dict()[k], v)
