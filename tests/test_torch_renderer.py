"""Parity of the port's stratified renderer (path A) with the JAX package,
on the CPU: the linspace grids, sample_pdf (deterministic and with the
JAX draws injected), render_stratified on a toy field with perturbation,
normal losses and every draw of the JAX key tree injected (values and the
gradient of the toy field's parameters), and render_rays_chunked with
padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu import renderer as jrend
from dreamfusion_tpu.cameras import safe_normalize as j_normalize
from dreamfusion_tpu.ops import composite as jcomp

from dreamfusion_torch import renderer as trend
from dreamfusion_torch.cameras import safe_normalize as t_normalize
from dreamfusion_torch.models.networks import FieldFns as TFieldFns
from dreamfusion_torch.ops import composite as tcomp


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rel):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("n", [7, 12, 64, 128])
def test_linspace_grids(n):
    """The unit grid of the coarse samples equals jnp.linspace's bit for bit
    (torch.linspace does not at some entries); sample_pdf's deterministic
    grid lies within one ulp of it."""
    got = tcomp.linspace(0.0, 1.0, n).numpy()
    assert np.array_equal(got, np.asarray(jnp.linspace(0.0, 1.0, n)))
    lo, hi = 0.5 / n, 1.0 - 0.5 / n
    ref = np.asarray(jnp.linspace(lo, hi, n))
    got = tcomp.linspace(lo, hi, n).numpy()
    assert np.abs(got - ref).max() <= np.spacing(np.float32(1.0))
    assert got[0] == np.float32(lo) and got[-1] == np.float32(hi)


@pytest.mark.parametrize("det", [True, False], ids=["det", "injected u"])
def test_sample_pdf_matches_jax(det):
    """Inverse-CDF samples from the same bins and weights (some rays with
    all-zero weights, where the 1e-5 floor makes the pdf uniform), with the
    deterministic grid or with JAX's uniform draws injected; 1e-5 of the
    largest bin."""
    rng = np.random.default_rng(0)
    N, T, S = 64, 12, 12
    bins = np.sort(rng.uniform(0.1, 3.0, (N, T)), -1).astype(np.float32)
    w = (rng.uniform(size=(N, T - 1)) ** 4).astype(np.float32)
    w[:5] = 0.0
    key = jax.random.PRNGKey(1)
    ref = jcomp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), S, det=det)
    u = None if det else _t(jax.random.uniform(key, (N, S)))
    got = tcomp.sample_pdf(_t(bins), _t(w), S, det=det, u=u)
    _close(got, ref, 1e-5)


# a toy field with three parameters a: a density blob of height 20 a0 and
# width a1, colour sigmoid(a2 x + d), normal x / |x| (+-0.5 bumps so the
# normals differ from the view directions)
def _j_fns(a):
    def density(x):
        return {"sigma": 20.0 * a[0] * jnp.exp(-jnp.sum(x * x, -1) / a[1])}

    def normal(x):
        return j_normalize(x + 0.5 * jnp.sin(3.0 * x))

    def field(x, d, light_d, ratio, code):
        s = density(x)["sigma"]
        n = normal(x)
        lam = ratio + (1.0 - ratio) * jnp.clip(n @ light_d, 0.0, None)
        return s, jax.nn.sigmoid(a[2] * x + d) * lam[:, None], n

    return jrend.FieldFns(field=field, density=density,
                          background=lambda d: jax.nn.sigmoid(d * a[2]),
                          normal=normal)


def _t_fns(a):
    def density(x):
        return {"sigma": 20.0 * a[0] * torch.exp(-(x * x).sum(-1) / a[1])}

    def normal(x):
        return t_normalize(x + 0.5 * torch.sin(3.0 * x))

    def field(x, d, light_d, ratio, code):
        s = density(x)["sigma"]
        n = normal(x)
        lam = ratio + (1.0 - ratio) * torch.clamp(n @ light_d, min=0.0)
        return s, torch.sigmoid(a[2] * x + d) * lam[:, None], n

    return TFieldFns(field=field, density=density,
                     background=lambda d: torch.sigmoid(d * a[2]),
                     normal=normal)


def _rays(N, seed):
    """Origins at radius 1.2-1.8 looking at points near the centre; of the
    last eight rays, four look away from the box (near > far) and four
    pass beside it along z (misses of the slab test: near = far = 1e9)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(N, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * rng.uniform(1.2, 1.8, (N, 1))
    d = rng.uniform(-0.3, 0.3, (N, 3)) - o
    d[-8:-4] = o[-8:-4]
    o[-4:] = [[3.0, 3.0, -2.0], [-3.0, 2.0, 0.0], [2.5, -3.0, 1.0],
              [-2.0, -2.0, 2.0]]
    d[-4:] = [0.0, 0.0, 1.0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_render_stratified_matches_jax_with_injected_draws():
    """Perturbed stratified + importance sampling, lambertian toy shading,
    orient and smooth losses, the JAX key tree's draws injected: outputs
    1e-5 of their largest entry, the toy parameters' gradient of a random
    projection of the image plus both losses 1e-4; the slab test's misses
    (near = far = 1e9) render the background with depth 0, not 0 / 0."""
    N, T, U = 128, 12, 12
    o, d = _rays(N, 2)
    a0 = np.array([1.0, 0.15, 2.0], np.float32)
    g_img = np.random.default_rng(3).normal(size=(N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(num_steps=T, upsample_steps=U, ambient_ratio=0.1,
              shading_code=1, perturb=True, compute_normal_losses=True)

    def lj(a):
        out = jrend.render_stratified(key, _j_fns(a), jnp.asarray(o),
                                      jnp.asarray(d), **kw)
        return (jnp.sum(out["image"] * g_img) + out["loss_orient"]
                + out["loss_smooth"]), out

    (_, ref), jgrad = jax.jit(jax.value_and_grad(lj, has_aux=True))(
        jnp.asarray(a0))
    k_light, k_perturb, k_pdf, k_smooth = jax.random.split(key, 4)
    a = _t(a0).requires_grad_(True)
    out = trend.render_stratified(
        _t_fns(a), _t(o), _t(d), **kw,
        light_n=_t(jax.random.normal(k_light, (3,))),
        perturb_u=_t(jax.random.uniform(k_perturb, (N, T))),
        pdf_u=_t(jax.random.uniform(k_pdf, (N, U))),
        smooth_n=_t(jax.random.normal(k_smooth, (N, T + U, 3))))
    for k in ("image", "depth", "weights_sum", "loss_orient", "loss_smooth"):
        _close(out[k], ref[k], 1e-5)
    assert np.array_equal(out["mask"].numpy(), np.asarray(ref["mask"]))
    assert not out["mask"][-8:].any() and out["mask"][:-8].all()
    assert (out["depth"][-4:] == 0).all()
    assert (out["weights_sum"][-4:] == 0).all()
    assert torch.isfinite(out["depth"]).all()
    (torch.sum(out["image"] * _t(g_img)) + out["loss_orient"]
     + out["loss_smooth"]).backward()
    _close(a.grad, jgrad, 1e-4)


def test_render_stratified_without_upsampling_or_perturbation():
    """upsample_steps = 0 and perturb off (the fixed grid), albedo
    shading, a given bg colour and no background net: 1e-5."""
    N, T = 64, 16
    o, d = _rays(N, 5)
    a0 = np.array([0.7, 0.3, -1.0], np.float32)
    bg = np.random.default_rng(6).uniform(size=(N, 3)).astype(np.float32)
    kw = dict(num_steps=T, upsample_steps=0, bg_radius=0.0,
              light_d=np.array([0.0, 0.0, 1.0], np.float32))
    ref = jax.jit(lambda a: jrend.render_stratified(
        jax.random.PRNGKey(0), _j_fns(a)._replace(background=None),
        jnp.asarray(o), jnp.asarray(d), bg_color=jnp.asarray(bg),
        **{**kw, "light_d": jnp.asarray(kw["light_d"])}))(jnp.asarray(a0))
    got = trend.render_stratified(
        _t_fns(_t(a0))._replace(background=None), _t(o), _t(d),
        bg_color=_t(bg), **{**kw, "light_d": _t(kw["light_d"])})
    for k in ("image", "depth", "weights_sum"):
        _close(got[k], ref[k], 1e-5)


def test_render_rays_chunked_pads_like_jax():
    """37 rays in chunks of 16 (padded to 48): the same rays as one direct
    call, and the JAX package's chunked render, 1e-5."""
    N = 37
    o, d = _rays(N, 7)
    a0 = np.array([1.0, 0.2, 1.0], np.float32)
    kw = dict(num_steps=12, upsample_steps=12,
              light_d=np.array([0.0, 1.0, 0.0], np.float32))

    def tf(oo, dd):
        return trend.render_stratified(_t_fns(_t(a0)), oo, dd,
                                       **{**kw, "light_d": _t(kw["light_d"])})

    def jf(oo, dd):
        return jrend.render_stratified(
            jax.random.PRNGKey(0), _j_fns(jnp.asarray(a0)), oo, dd,
            **{**kw, "light_d": jnp.asarray(kw["light_d"])})

    got = trend.render_rays_chunked(tf, _t(o), _t(d), chunk=16)
    direct = tf(_t(o), _t(d))
    ref = jrend.render_rays_chunked(jf, jnp.asarray(o), jnp.asarray(d),
                                    chunk=16)
    for k in ("image", "depth", "weights_sum"):
        assert got[k].shape[0] == N
        _close(got[k], direct[k].numpy(), 1e-6)
        _close(got[k], ref[k], 1e-5)
