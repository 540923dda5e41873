"""Parity of the port's txt2img path with the JAX package, on the CPU: the
VAE decode (nano and tiny), each sampler step over consecutive timesteps
on the same eps, and prompt_to_img at random-tiny widths against JAX's
produce_latents + decode_latents with JAX's latents and text_z injected.

Both sides run in f32 with the GroupNorm output pinned to f32 (the
f32_groupnorm fixture of tests/test_torch_sd.py). Tolerance: rtol 1e-4 of
the reference's largest entry (two libraries' convolution and matmul sums
in f32). The whole denoising chain is held to 1e-4 or, where that is
larger, 3x the most that JAX's own chain moves when its starting latents
change by 2^-24 (CFG at 7.5 amplifies each UNet evaluation's rounding,
and the full PNDM makes 13 evaluations in 4 steps); the uint8 images may
differ by one level where a value lies within that of a rounding
boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance.sd import pipeline as jpipe
from dreamfusion_tpu.guidance.sd import scheduler as jsched
from dreamfusion_tpu.guidance.sd import unet as junet
from dreamfusion_tpu.guidance.sd import vae as jvae

from dreamfusion_torch.guidance.sd import pipeline as tpipe
from dreamfusion_torch.guidance.sd import scheduler as tsched
from dreamfusion_torch.guidance.sd import sds as tsds
from dreamfusion_torch.guidance.sd import unet as tunet
from dreamfusion_torch.guidance.sd import vae as tvae
from dreamfusion_torch.weights import from_jax_params

from test_torch_mesh import one_torch_thread  # noqa: F401
from test_torch_sd import (RTOL, _close, _t, f32_groupnorm,  # noqa: F401
                           random_params)

CPU = torch.device("cpu")


def _vae_pair(jvae_fn, tvae_fn, size, seed):
    jv = jvae_fn()
    k = jax.random.PRNGKey(0)
    jp = random_params(lambda: jv.init(k, jnp.zeros((1, size, size, 3)), k),
                       seed)
    tv = tvae_fn().eval().requires_grad_(False)
    tv.load_state_dict(from_jax_params(jp), strict=True)
    return jv, jp, tv


@pytest.fixture(scope="module")
def tiny_models():
    """JAX tiny UNet + VAE params and the port's modules with the same
    weights (64 px images, 8x8 latents)."""
    ju = junet.tiny_unet()
    k = jax.random.PRNGKey(0)
    jpu = random_params(lambda: ju.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 32))), 10)
    tu = tunet.tiny_unet().eval().requires_grad_(False)
    tu.load_state_dict(from_jax_params(jpu), strict=True)
    jv, jpv, tv = _vae_pair(jvae.tiny_vae, tvae.tiny_vae, 64, 11)
    return ju, jpu, tu, jv, jpv, tv


@pytest.mark.parametrize("which", ["nano", "tiny"])
def test_vae_decode_matches_jax(which, tiny_models, f32_groupnorm):
    if which == "nano":     # one upsampler: 32^2 latents -> 64 px
        jv, jp, tv = _vae_pair(jvae.nano_vae, tvae.nano_vae, 64, 3)
        shape = (2, 32, 32, 4)
    else:                   # three upsamplers: 8^2 latents -> 64 px
        jv, jp, tv = tiny_models[3:]
        shape = (2, 8, 8, 4)
    z = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    ref = jv.apply(jp, jnp.asarray(z), method=jv.decode)
    got = tv.decode(_t(z))
    assert got.dtype == torch.float32
    assert got.shape == (2, 64, 64, 3) == ref.shape
    _close(got, ref)


def test_vae_roundtrip_keys():
    """The port's VAE holds the decoder and post_quant_conv: a JAX VAE tree
    fills it, and nothing is left over."""
    jv = jvae.nano_vae()
    k = jax.random.PRNGKey(0)
    jp = random_params(lambda: jv.init(k, jnp.zeros((1, 64, 64, 3)), k), 5)
    sd = from_jax_params(jp)
    assert any(k.startswith("decoder.") for k in sd)
    assert "post_quant_conv.weight" in sd
    tv = tvae.nano_vae()
    assert set(sd) == set(tv.state_dict())


def _eps_seq(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


STEPS = 6       # consecutive sampler steps compared one by one


def test_ddim_timesteps_match_jax():
    for n in (3, 6, 10, 50):
        np.testing.assert_array_equal(tsched.ddim_timesteps(1000, n),
                                      jsched.ddim_timesteps(1000, n))


def test_ddim_steps_match_jax():
    js, ts_ = jsched.make_schedule(), tsched.make_schedule(device=CPU)
    ts = jsched.ddim_timesteps(1000, STEPS)
    x = np.random.default_rng(0).normal(size=(1, 8, 8, 4)).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    for i, eps in enumerate(_eps_seq(STEPS, x.shape, 1)):
        t = int(ts[i])
        t_prev = int(ts[i + 1]) if i + 1 < STEPS else -1
        jx = jsched.ddim_step(js, jnp.asarray(eps), t, t_prev, jx)
        tx = tsched.ddim_step(ts_, _t(eps), t, t_prev, tx)
        _close(tx, jx)


def test_plms_steps_match_jax():
    """Every step from an empty history, through the 1-, 2- and 3-step
    warm-up weights into the 4-step PLMS, to the t_prev = -1 end."""
    js, ts_ = jsched.make_schedule(), tsched.make_schedule(device=CPU)
    ts = jsched.ddim_timesteps(1000, STEPS)
    x = np.random.default_rng(2).normal(size=(1, 8, 8, 4)).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    jst = jsched.PNDMState(ets=(), cur_sample=jx, counter=0)
    tst = tsched.PNDMState(ets=(), cur_sample=tx, counter=0)
    for i, eps in enumerate(_eps_seq(STEPS, x.shape, 3)):
        t = int(ts[i])
        t_prev = int(ts[i + 1]) if i + 1 < STEPS else -1
        jx, jst = jsched.pndm_plms_step(js, jnp.asarray(eps), t, t_prev, jx,
                                        jst)
        tx, tst = tsched.pndm_plms_step(ts_, _t(eps), t, t_prev, tx, tst)
        _close(tx, jx)
        assert tst.counter == jst.counter == i + 1
        assert len(tst.ets) == len(jst.ets) == min(i + 1, 4)
        _close(tst.cur_sample, jst.cur_sample)


def test_prk_steps_match_jax():
    """Full PNDM: the three pseudo Runge-Kutta transfers (the eps_fn of
    both sides is the same fixed linear map, so the four evaluations a
    transfer see the samples each side produced), then PLMS; each step
    compared, with the history the PRK steps seeded."""
    js, ts_ = jsched.make_schedule(), tsched.make_schedule(device=CPU)
    ts = jsched.ddim_timesteps(1000, STEPS)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    A = (rng.normal(size=(4, 4)) / 2).astype(np.float32)
    calls = {"jax": [], "torch": []}

    def j_eps(v, t):
        calls["jax"].append(int(t))
        return v @ jnp.asarray(A) + 1e-3 * t

    def t_eps(v, t):
        calls["torch"].append(int(t))
        return v @ _t(A) + 1e-3 * t

    jx, tx = jnp.asarray(x), _t(x)
    jst = jsched.PNDMState(ets=(), cur_sample=jx, counter=0)
    tst = tsched.PNDMState(ets=(), cur_sample=tx, counter=0)
    for i in range(STEPS):
        t = int(ts[i])
        t_prev = int(ts[i + 1]) if i + 1 < STEPS else -1
        if i < tpipe.PRK_WARMUP:
            jx, jst = jsched.pndm_prk_step(js, j_eps, jx, t, t_prev, jst)
            tx, tst = tsched.pndm_prk_step(ts_, t_eps, tx, t, t_prev, tst)
        else:
            jx, jst = jsched.pndm_plms_step(js, j_eps(jx, t), t, t_prev, jx,
                                            jst)
            tx, tst = tsched.pndm_plms_step(ts_, t_eps(tx, t), t, t_prev, tx,
                                            tst)
        _close(tx, jx)
        for a, b in zip(tst.ets, jst.ets):
            _close(a, b)
        assert tst.counter == jst.counter == i + 1
    assert calls["torch"] == calls["jax"]
    assert len(calls["torch"]) == 4 * tpipe.PRK_WARMUP + STEPS - tpipe.PRK_WARMUP


@pytest.mark.parametrize("sampler,steps", [("plms", 4), ("pndm", 4),
                                           ("ddim", 3)])
def test_prompt_to_img_matches_jax(sampler, steps, tiny_models,
                                   f32_groupnorm):
    """The port's prompt_to_img (random-tiny widths, 64^2, CFG 7.5) with
    JAX's starting latents and text_z injected, against JAX's
    produce_latents + decode_latents on the same weights."""
    ju, jpu, tu, jv, jpv, tv = tiny_models
    rng = np.random.default_rng(7)
    text_z = rng.normal(size=(1, 2, 77, 32)).astype(np.float32)
    lat0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 8, 8, 4)))

    def jax_chain(start):
        return np.asarray(jpipe.produce_latents(
            ju, jpu, jsched.make_schedule(), jnp.asarray(text_z), height=64,
            width=64, num_inference_steps=steps, guidance_scale=7.5,
            latents=jnp.asarray(start), sampler=sampler))

    def gap(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    jlat = jax_chain(lat0)
    ref = jpipe.decode_latents(jv, jpv, jnp.asarray(jlat))
    ctl_lat = ctl_img = 0.0
    for seed in (1, 2):
        sign = np.sign(np.random.default_rng(seed).normal(size=lat0.shape))
        c = jax_chain((lat0 * (1 + 2.0 ** -24 * sign)).astype(np.float32))
        ctl_lat = max(ctl_lat, gap(c, jlat))
        ctl_img = max(ctl_img, gap(jpipe.decode_latents(
            jv, jpv, jnp.asarray(c)), ref))
    g = tsds.sd_guidance(tu, tv, latent_size=8, guidance_scale=7.5)
    tlat = tpipe.produce_latents(tu, tsched.make_schedule(device=CPU),
                                 _t(text_z), height=64, width=64,
                                 num_inference_steps=steps,
                                 guidance_scale=7.5, latents=_t(lat0),
                                 sampler=sampler)
    _close(tlat, jlat, max(RTOL, 3.0 * ctl_lat))
    img = tpipe.prompt_to_img("a tiny test", height=512, width=512,
                              num_inference_steps=steps, sampler=sampler,
                              latents=_t(lat0), text_z=_t(text_z),
                              guidance=g, device="cpu")
    assert img.shape == (1, 64, 64, 3) and img.dtype == np.uint8   # 64 cap
    want = np.round(np.asarray(ref) * 255)
    assert np.abs(img.astype(np.float64) - want).max() <= 1.0
    _close(tpipe.decode_latents(tv, tlat), ref, max(RTOL, 3.0 * ctl_img))


def test_cli_writes_png(tmp_path):
    """The CLI at random-tiny on the CPU: one 64x64 PNG (the tiny cap)."""
    out = tmp_path / "img.png"
    path = tpipe.main(["a corgi", "--sd_weights", "random-tiny", "-H", "512",
                       "-W", "512", "--steps", "2", "--sampler", "ddim",
                       "--device", "cpu", "--out", str(out)])
    assert path == str(out)
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8


def test_build_sd_guidance_refuses_a_directory(tmp_path):
    """A directory without the text encoder and tokenizer (unet/ and vae/
    only, which the probe accepts) is refused before any module is built;
    a name that is no directory raises too (a hub name needs the network)."""
    for sub in ("unet", "vae"):
        (tmp_path / sub).mkdir()
    with pytest.raises(FileNotFoundError, match="text_encoder/, tokenizer/"):
        tsds.build_sd_guidance(str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="hub name"):
        tsds.build_sd_guidance("runwayml/stable-diffusion-v1-5",
                               device="cpu")


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="sampler"):
        tpipe.produce_latents(None, tsched.make_schedule(device=CPU),
                              torch.zeros(1, 2, 77, 4), sampler="euler")
