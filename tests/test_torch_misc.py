"""Parity of the port's small ops (dreamfusion_torch/ops/misc.py) with the
JAX package's, on the CPU: the background-sphere (u, v) of a ray, the sRGB
transfer functions, and error-map pixel sampling with the JAX key tree's
draws injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamfusion_tpu.ops import misc as jmisc

from dreamfusion_torch.ops import misc as tmisc


def _t(x):
    return torch.from_numpy(np.array(x))


def test_sph_from_ray_matches_jax():
    """Rays from inside the sphere of radius 1.4 (and one on its surface):
    (u, v) within 2e-6."""
    rng = np.random.default_rng(0)
    o = rng.uniform(-0.9, 0.9, (500, 3)).astype(np.float32)
    o[0] = [0.0, 0.0, 1.4]
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = jmisc.sph_from_ray(jnp.asarray(o), jnp.asarray(d), 1.4)
    got = tmisc.sph_from_ray(_t(o), _t(d), 1.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)
    assert (got.abs() <= 1.0).all()


def test_srgb_transfer_functions_match_jax_and_invert():
    """Both branches of each function (1e-6 relative), and
    srgb_to_linear(linear_to_srgb(x)) ~ x (1e-4, the 0.41666 exponent)."""
    x = np.concatenate([np.linspace(0.0, 0.01, 50),
                        np.linspace(0.01, 1.0, 200)]).astype(np.float32)
    for jf, tf in ((jmisc.linear_to_srgb, tmisc.linear_to_srgb),
                   (jmisc.srgb_to_linear, tmisc.srgb_to_linear)):
        np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(x)),
                                   rtol=1e-6, atol=1e-7)
    back = tmisc.srgb_to_linear(tmisc.linear_to_srgb(_t(x)))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)


def test_sample_rays_with_error_map_matches_jax_with_injected_draws():
    """The JAX key tree (k_cell, k_jx, k_jy) as draws: the same pixel and
    cell indices at 800 x 800 and at a size that does not divide by 128;
    without draws, the indices lie in range and follow the map (a cell of
    zero error is never drawn)."""
    rng = np.random.default_rng(1)
    err = rng.uniform(size=(128, 128)).astype(np.float32)
    err[:, :64] = 0.0
    key = jax.random.PRNGKey(2)
    N = 4096
    for H, W in ((800, 800), (300, 200)):
        inds, coarse = jmisc.sample_rays_with_error_map(key, jnp.asarray(err),
                                                        N, H, W)
        k_cell, k_jx, k_jy = jax.random.split(key, 3)
        jitter = np.stack([np.asarray(jax.random.uniform(k_jx, (N,))),
                           np.asarray(jax.random.uniform(k_jy, (N,)))])
        got, got_c = tmisc.sample_rays_with_error_map(
            _t(err), N, H, W, cells=_t(np.asarray(coarse)), jitter=_t(jitter))
        assert np.array_equal(got_c.numpy(), np.asarray(coarse))
        assert np.array_equal(got.numpy(), np.asarray(inds))
    got, cells = tmisc.sample_rays_with_error_map(
        _t(err), N, 300, 200, generator=torch.Generator().manual_seed(0))
    assert int(got.min()) >= 0 and int(got.max()) < 300 * 200
    assert ((cells % 128) >= 64).all()
