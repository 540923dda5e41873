"""Parity of the port's occupancy-grid renderer with the JAX package, on
the CPU, at a small -O-shaped size: the occupancy refresh (density grid and
occupancy), and ``render_grid`` with K and M pinned (per-ray truncation at
K and in proportion at M), FD normals, orient loss and parameter gradients.
The helpers here also serve tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.models.networks import NeRFGridNetwork as JNeRF
from dreamfusion_tpu.models.networks import make_field_fns as j_field_fns
from dreamfusion_tpu.ops import marching as jmarch

from dreamfusion_torch.models.networks import NeRFGridNetwork as TNeRF
from dreamfusion_torch.models.networks import make_field_fns as t_field_fns
from dreamfusion_torch.ops import marching as tmarch
from dreamfusion_torch.weights import from_jax_params

from test_torch_sd import random_params

# -O at a small size; albedo_iters stays at its default (1000), so the
# train steps shade albedo as every -O run does for its first 1000 steps
SMALL = dict(text="a red cube", h=16, w=16, grid_ray=True, dir_text=True,
             fp16=False, grid_size=16, max_steps=64, grid_K=48,
             lambda_orient=1e-2, sd_weights="random-nano", iters=100)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rel):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-30))


def _nerf_pair(seed=0):
    """JAX grid NeRF (f32) + its params (numpy-filled at the flax shapes,
    table U(-0.1, 0.1) so the encoder matters) and the port's copy."""
    jm = JNeRF(compute_dtype=jnp.float32)
    params = random_params(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)),
        method=jm.init_all), seed)
    rng = np.random.default_rng(seed)
    emb = params["params"]["embeddings"]
    params["params"]["embeddings"] = rng.uniform(
        -0.1, 0.1, emb.shape).astype(np.float32)
    tm = TNeRF(compute_dtype=torch.float32)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


def _leaf_grads(tm):
    return {k: p.grad for k, p in tm.named_parameters()}


def _compare_grads(jgrads, tm, rel):
    flat = from_jax_params(jax.tree.map(np.asarray, jgrads))
    tg = _leaf_grads(tm)
    assert set(flat) == set(tg)
    for k, g in flat.items():
        assert tg[k] is not None, k
        _close(tg[k], g.numpy(), rel)


def _jitter(key, cascade, n):
    return _t(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, c), (n, 3))) for c in range(cascade)]))


def _refresh(jm, params, tm, cfg_kw, jstate, tstate, key, idx):
    """One occupancy refresh on both sides with the JAX jitter injected."""
    jcfg = JConfig(**cfg_kw)
    jstate = jmarch.make_update_extra_state(jcfg, jm)(params, jstate, key, idx)
    part = tmarch.refresh_partial(idx)
    n = jcfg.grid_size ** 3 // (part[1] if part else 1)
    tstate = tmarch.update_grid(tm.density, tstate, bound=jcfg.bound,
                                density_thresh=jcfg.density_thresh,
                                decay=jcfg.grid_decay, partial=part,
                                jitter=_jitter(key, jcfg.cascade, n))
    _close(tstate.density_grid, jstate.density_grid, 1e-5)
    assert np.array_equal(tstate.occ.numpy(), np.asarray(jstate.occ))
    return jstate, tstate


def _rays(key, cfg_kw):
    from dreamfusion_tpu import cameras as jcam

    from test_torch_ops import _pose_draws

    jcfg = JConfig(**cfg_kw)
    b = jcam.sample_train_batch(key, jcfg)
    return (b["rays_o"].reshape(-1, 3), b["rays_d"].reshape(-1, 3),
            _pose_draws(key, jcfg.batch_size, jcfg))


def test_render_grid_matches_jax_with_K_and_M_pinned():
    """K = 8 truncates per ray and M ~ 40% of the kept samples truncates in
    proportion; lambertian shading runs the FD normals and the orient loss.
    Values 1e-5, gradients 1e-4 of each leaf's largest entry."""
    jm, params, tm = _nerf_pair(0)
    N, K = 256, 8
    cfg_kw = dict(SMALL)
    jstate = jmarch.init_grid_state(1, 16)
    tstate = tmarch.init_grid_state(1, 16, torch.device("cpu"))
    jstate, tstate = _refresh(jm, params, tm, cfg_kw, jstate, tstate,
                              jax.random.PRNGKey(1), 0)
    o, d, _ = _rays(jax.random.PRNGKey(2), cfg_kw)
    key = jax.random.PRNGKey(3)
    k_light, k_march, _ = jax.random.split(key, 3)
    counts = np.asarray(jmarch.march_rays(
        k_march, jstate.occ, o, d, *jmarch.near_far_from_aabb(
            o, d, jnp.array([-1.0] * 3 + [1.0] * 3), 0.1),
        bound=1.0, max_steps=64, K=K, perturb=True).counts)
    # ~40% of the kept samples, off the exact fraction: floor(c * M / total)
    # must not sit on an integer, where f32 division order decides it
    M = int(0.4 * np.minimum(counts, K).sum()) + 1
    assert (counts > K).any() and M < np.minimum(counts, K).sum()
    rng = np.random.default_rng(0)
    g_img = rng.normal(size=(N, 3)).astype(np.float32)

    def lj(p):
        out = jmarch.render_grid(
            key, j_field_fns(jm, p)._replace(normal=None), jstate, o, d,
            max_steps=64, K=K, ambient_ratio=0.1, shading_code=1,
            perturb=True, pallas_composite=True,
            compute_normal_losses=True, compact_M=M)
        return jnp.sum(out["image"] * g_img) + out["loss_orient"], out

    (_, ref), jgrads = jax.value_and_grad(lj, has_aux=True)(params)
    out = tmarch.render_grid(
        t_field_fns(tm)._replace(normal=None), tstate, _t(o), _t(d),
        max_steps=64, K=K, ambient_ratio=0.1, shading_code=1, perturb=True,
        compute_normal_losses=True, compact_M=M,
        light_n=_t(jax.random.normal(k_light, (3,))),
        perturb_u=_t(jax.random.uniform(k_march, (N,))))
    ((out["image"] * _t(g_img)).sum() + out["loss_orient"]).backward()
    for k in ("image", "weights_sum", "depth", "loss_orient", "mean_count",
              "count_q95", "live_q95"):
        _close(out[k], ref[k], 1e-5)
    _compare_grads(jgrads, tm, 1e-4)
