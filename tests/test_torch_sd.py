"""Parity of the port's SD guidance with the JAX package, on the CPU:
the nano UNet, the VAE encode (values and input gradient) and the SDS loss
(value and gradient), with weights carried over by
``weights.from_jax_params`` and every draw injected.

Both sides run in f32 with the GroupNorm output pinned to f32 (the JAX
oracle tests pin it the same way, tests/test_sd.py). Tolerance: rtol 1e-4
(two libraries' convolution and matmul sums in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance.sd import layers as jlayers
from dreamfusion_tpu.guidance.sd import scheduler as jsched
from dreamfusion_tpu.guidance.sd import sds as jsds
from dreamfusion_tpu.guidance.sd import unet as junet
from dreamfusion_tpu.guidance.sd import vae as jvae

from dreamfusion_torch.guidance.sd import layers as tlayers
from dreamfusion_torch.guidance.sd import scheduler as tsched
from dreamfusion_torch.guidance.sd import sds as tsds
from dreamfusion_torch.guidance.sd import unet as tunet
from dreamfusion_torch.guidance.sd import vae as tvae
from dreamfusion_torch.weights import from_jax_params

RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rtol=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rtol * np.abs(b).max())


@pytest.fixture
def f32_groupnorm(monkeypatch):
    monkeypatch.setattr(jlayers, "GN_DTYPE", "f32")
    monkeypatch.setattr(tlayers, "GN_DTYPE", "f32")


def random_params(init_fn, seed):
    """A flax params tree of init_fn's shapes (jax.eval_shape, no init
    run), filled from numpy: kernels ~ N(0, 1/fan_in), norm scales near 1,
    biases small and nonzero so every converted leaf matters."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(path[-1])
        if "kernel" in leaf:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in leaf:
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn))


@pytest.fixture(scope="module")
def nano_models():
    """JAX nano UNet + VAE params and the port's modules holding the same
    weights (the nano VAE downsamples once: 64 px images, 32^2 latents)."""
    ju, jv = junet.nano_unet(), jvae.nano_vae()
    k = jax.random.PRNGKey(0)
    jp = {"unet": random_params(lambda: ju.init(
              k, jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,), jnp.int32),
              jnp.zeros((1, 77, 16))), 0),
          "vae": random_params(lambda: jv.init(
              k, jnp.zeros((1, 64, 64, 3)), k), 1)}
    tu, tv = tunet.nano_unet().eval(), tvae.nano_vae().eval()
    tu.load_state_dict(from_jax_params(jp["unet"]), strict=True)
    tv.load_state_dict(from_jax_params(jp["vae"]), strict=True)
    for m in (tu, tv):
        m.requires_grad_(False)
    return ju, jv, jp, tu, tv


def test_nano_unet_matches_jax(nano_models, f32_groupnorm):
    ju, _, jp, tu, _ = nano_models
    rng = np.random.default_rng(1)
    lat = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    t = np.array([20, 917], np.int32)
    ctx = rng.normal(size=(2, 77, 16)).astype(np.float32)
    ref = ju.apply(jp["unet"], lat, t, ctx)
    with torch.no_grad():
        got = tu(_t(lat), _t(t).long(), _t(ctx))
    assert got.shape == (2, 32, 32, 4)
    _close(got, ref)


def test_nano_vae_encode_and_grad_match_jax(nano_models, f32_groupnorm):
    _, jv, jp, _, tv = nano_models
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (1, 32, 32, 4)))
    g = rng.normal(size=(1, 32, 32, 4)).astype(np.float32)

    def lj(x_):
        return jnp.sum(jv.apply(jp["vae"], x_, key, method=jv.encode) * g)

    gref = jax.grad(lj)(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    z = tv.encode(xt, eps=_t(eps))
    (z * _t(g)).sum().backward()
    _close(z, jv.apply(jp["vae"], x, key, method=jv.encode))
    _close(xt.grad, gref)


def test_sds_loss_matches_jax(nano_models, f32_groupnorm):
    """sds_loss with the JAX draws injected (sds.py:105 key tree): value
    and d loss / d pred_rgb, which runs through the bilinear resize and the
    VAE encode."""
    ju, jv, jp, tu, tv = nano_models
    rng = np.random.default_rng(3)
    pred = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    text_z = rng.normal(size=(1, 2, 77, 16)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    k_enc, k_t, k_noise = jax.random.split(key, 3)
    draws = {"vae_eps": _t(jax.random.normal(k_enc, (1, 32, 32, 4))),
             "t": _t(jax.random.randint(k_t, (1,), 20, 981)),
             "noise": _t(jax.random.normal(k_noise, (1, 32, 32, 4)))}
    js = jsched.make_schedule()

    def lj(p):
        return jsds.sds_loss(ju, jv, js, jp, jnp.asarray(text_z), p, key,
                             latent_size=8)

    ref, gref = jax.value_and_grad(lj)(jnp.asarray(pred))
    pt = _t(pred).requires_grad_(True)
    loss = tsds.sds_loss(tu, tv, tsched.make_schedule(device=torch.device("cpu")), _t(text_z), pt,
                         latent_size=8, draws=draws)
    loss.backward()
    _close(loss, ref)
    _close(pt.grad, gref)
    np.testing.assert_allclose(
        tsched.make_schedule(device=torch.device("cpu")).alphas_cumprod.numpy(),
        np.asarray(js.alphas_cumprod), rtol=1e-6)


def test_bilinear_upsample_matches_jax_resize():
    """The 8x bilinear resize (64 -> 512 on the main path, 16 -> 64 here)
    equals jax.image.resize(..., "bilinear") to 1e-6."""
    x = np.random.default_rng(4).uniform(size=(1, 16, 16, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 128, 128, 3), "bilinear")
    got = torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), size=(128, 128), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_groupnorm_bf16_output_mode(monkeypatch):
    """GN_DTYPE bf16 (the default, as in the JAX package): f32 statistics,
    bf16 output within bf16 rounding of the f32 output."""
    gn = tlayers.GroupNorm(64, 32, 1e-6)
    x = torch.randn(2, 64, 8, 8, generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(tlayers, "GN_DTYPE", "f32")
    ref = gn(x)
    monkeypatch.setattr(tlayers, "GN_DTYPE", "bf16")
    got = gn(x)
    assert ref.dtype == torch.float32 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               ref.detach().numpy(), atol=0.05, rtol=0.02)
