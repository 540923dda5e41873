"""Parity of the port's vanilla backbone (NeRFVanillaNetwork: frequency
encoding, a 5 x 128 ResMLP with LayerNorm, autograd normals) with the JAX
package, on the CPU, with the flax parameters carried over: ``common``,
``normal`` and the background, and the parameter gradients of a shaded
render under both renderers, where the autograd normal carries its
second-order term to the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu import renderer as jrend
from dreamfusion_tpu.models.networks import NeRFVanillaNetwork as JVanilla
from dreamfusion_tpu.models.networks import make_field_fns as j_field_fns
from dreamfusion_tpu.ops import marching as jmarch

from dreamfusion_torch import renderer as trend
from dreamfusion_torch.models.networks import NeRFVanillaNetwork as TVanilla
from dreamfusion_torch.models.networks import build_model
from dreamfusion_torch.models.networks import make_field_fns as t_field_fns
from dreamfusion_torch.ops import marching as tmarch
from dreamfusion_torch.weights import from_jax_params

from test_torch_marching import SMALL, _close, _compare_grads, _rays, _refresh, _t
from test_torch_sd import random_params


def _vanilla_pair(seed=0):
    """JAX vanilla NeRF (f32) + numpy-filled params and the port's copy.
    The density output's bias is lowered by 4, so that the field is thin
    outside the gaussian blob, as a young field is: where every ray is
    opaque, the background's gradient is a sum of 1 - weights_sum terms of
    ~1e-4, each known only to f32 rounding of weights_sum."""
    jm = JVanilla(compute_dtype=jnp.float32)
    params = random_params(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)),
        method=jm.init_all), seed)
    params["params"]["sigma_net"]["dense_out"]["bias"][0] -= 4.0
    tm = TVanilla()
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


def test_state_dict_names_follow_the_flax_tree():
    """block_0 has the bias-free skip (39 -> 128), blocks 1-3 none; the
    LayerNorm epsilon is flax's 1e-6; build_model("vanilla") builds it."""
    _, params, tm = _vanilla_pair()
    names = set(tm.state_dict())
    assert names == set(from_jax_params(params))
    assert "sigma_net.block_0.skip.weight" in names
    assert not any(f"block_{i}.skip" in n for n in names for i in (1, 2, 3))
    assert "sigma_net.block_0.skip.bias" not in names
    assert tm.sigma_net.block_0.norm.eps == 1e-6
    from dreamfusion_torch.config import Config

    m = build_model(Config(backbone="vanilla"), torch.device("cpu"),
                    torch.Generator().manual_seed(0))
    assert isinstance(m, TVanilla)
    assert m.sigma_net.dense_out.weight.dtype == torch.float32


def test_common_normal_and_background_match_jax():
    """sigma, albedo (1e-5 of the largest entry), the autograd normal (1e-4)
    and the background (1e-5) on random points and directions."""
    jm, params, tm = _vanilla_pair(1)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js, ja, jn, jb = jax.jit(lambda p, x, d: (
        *jm.apply(p, x, method=jm.common), jm.apply(p, x, method=jm.normal),
        jm.apply(p, d, method=jm.background)))(params, x, d)
    ts, ta = tm.common(_t(x))
    _close(ts, js, 1e-5)
    _close(ta, ja, 1e-5)
    with torch.no_grad():                     # the eval's mode
        tn = tm.normal(_t(x))
    assert not tn.requires_grad
    _close(tn, jn, 1e-4)
    _close(tm.background(_t(d)), jb, 1e-5)


@pytest.mark.parametrize("renderer", ["stratified", "grid"])
def test_shaded_render_parameter_gradients_match_jax(renderer):
    """A lambertian render (autograd normals, orient loss) on 16 x 16 rays;
    the gradient of a random projection of the image plus the orient loss
    with respect to every parameter leaf, 1e-4 of the leaf's largest entry,
    the JAX side by jax.value_and_grad through the normal's nn.vjp. Both
    renderers: the stratified one (12 + 12 samples) and the grid one after
    an occupancy refresh (K = 16)."""
    jm, params, tm = _vanilla_pair(2)
    cfg_kw = dict(SMALL, backbone="vanilla")
    o, d, _ = _rays(jax.random.PRNGKey(3), cfg_kw)
    N = o.shape[0]
    g_img = np.random.default_rng(4).normal(size=(N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(ambient_ratio=0.1, shading_code=1, perturb=True,
              compute_normal_losses=True)
    if renderer == "stratified":
        T = U = 12

        def render_j(p):
            return jrend.render_stratified(
                key, j_field_fns(jm, p)._replace(normal=None), o, d,
                num_steps=T, upsample_steps=U, **kw)

        k_light, k_perturb, k_pdf, _ = jax.random.split(key, 4)
        draws = dict(light_n=_t(jax.random.normal(k_light, (3,))),
                     perturb_u=_t(jax.random.uniform(k_perturb, (N, T))),
                     pdf_u=_t(jax.random.uniform(k_pdf, (N, U))))

        def render_t():
            return trend.render_stratified(
                t_field_fns(tm)._replace(normal=None), _t(o), _t(d),
                num_steps=T, upsample_steps=U, **kw, **draws)
    else:
        jstate = jmarch.init_grid_state(1, 16)
        tstate = tmarch.init_grid_state(1, 16, torch.device("cpu"))
        jstate, tstate = _refresh(jm, params, tm, cfg_kw, jstate, tstate,
                                  jax.random.PRNGKey(6), 0)

        def render_j(p):
            return jmarch.render_grid(
                key, j_field_fns(jm, p)._replace(normal=None), jstate, o, d,
                max_steps=64, K=16, pallas_composite=False, **kw)

        k_light, k_march, _ = jax.random.split(key, 3)
        draws = dict(light_n=_t(jax.random.normal(k_light, (3,))),
                     perturb_u=_t(jax.random.uniform(k_march, (N,))))

        def render_t():
            return tmarch.render_grid(
                t_field_fns(tm)._replace(normal=None), tstate, _t(o), _t(d),
                max_steps=64, K=16, **kw, **draws)

    def lj(p):
        out = render_j(p)
        return jnp.sum(out["image"] * g_img) + out["loss_orient"], out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(lj, has_aux=True))(params)
    out = render_t()
    ((out["image"] * _t(g_img)).sum() + out["loss_orient"]).backward()
    for k in ("image", "weights_sum", "depth", "loss_orient"):
        _close(out[k], ref[k], 1e-5)
    assert float(ref["loss_orient"]) > 0
    _compare_grads(jgrads, tm, 1e-4)
