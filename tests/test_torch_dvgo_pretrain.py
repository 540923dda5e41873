"""DVGO pretraining in the port (models/dvgo.py, training/dvgo_trainer.py,
training/schedules.py, training/nerf_pipeline.py) against the JAX
package, on the CPU, with the JAX parameters carried over by
weights.from_jax_dvgo and every draw injected:

- sample_ray, render (coarse and fine, jitter and density noise),
  dvgo_losses with every weight on and their gradients, total_variation,
  metric_loss (the JAX permutations), MaskCacheData and scale_volume_grid:
  f32, 1e-5 (gradients 1e-5 of their largest entry);
- make_lr_schedule at each scheduler name (rtol 1e-5: optax computes in
  f32, the port in f64) and make_module_optimizer's SGD and Adam steps
  (1e-5).

The trainer, voxel_count_views and the pipeline are held in
tests/test_torch_dvgo_trainer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreamfusion_tpu.models import dvgo as jd
from dreamfusion_tpu.training import schedules as jsched

from dreamfusion_torch.models import dvgo as td
from dreamfusion_torch.training import schedules as tsched
from dreamfusion_torch.weights import from_jax_dvgo

CPU = torch.device("cpu")
NEAR, FAR = 0.5, 5.0


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, rel=1e-5):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-30))


def _rays(n=48, seed=0):
    rng = np.random.default_rng(seed)
    o = (np.array([[0.1, 0.2, 3.0]]) + 0.1 * rng.normal(size=(n, 3))
         ).astype(np.float32)
    d = (np.array([[0.0, 0.0, -1.0]]) + 0.2 * rng.normal(size=(n, 3))
         ).astype(np.float32)
    return o, d, d / np.linalg.norm(d, axis=-1, keepdims=True)


FIELDS = {
    "coarse": dict(world_size=(10, 9, 8), k0_dim=3, alpha_init=1e-2,
                   density_noise=0.5),
    "fine": dict(world_size=(10, 9, 8), k0_dim=4, rgbnet_name="resmlp",
                 rgbnet_width=16, posbase_pe=2, viewbase_pe=2,
                 alpha_init=1e-2, density_noise=0.5),
    "fine_mlp": dict(world_size=(7, 8, 9), k0_dim=4, rgbnet_name="mlp",
                     rgbnet_width=16, rgbnet_depth=4, posbase_pe=2,
                     viewbase_pe=0, alpha_init=1e-2),
}


def _field_pair(kind, seed=0):
    """The JAX field with params (its init, density scaled so rays hit
    something) and the port's field holding the same values."""
    kw = FIELDS[kind]
    jf = jd.DVGOField(**kw)
    o, d, vd = _rays(4)
    params = jf.init(jax.random.PRNGKey(seed), o, d, vd, near=NEAR, far=FAR,
                     bg=1.0, n_samples=jf.n_render_samples(FAR),
                     method=jf.render)
    params = jax.tree.map(np.asarray, params)
    params["params"]["density"] = params["params"]["density"] * 3 + 2
    tf = td.DVGOField(**kw)
    tf.load_state_dict(from_jax_dvgo(params))
    return jf, params, tf


def test_sample_ray_matches():
    o, d, _ = _rays()
    d[0] = [0.0, 0.0, -1.0]          # axis-aligned: the 1e-6 guard
    jit = np.random.default_rng(1).uniform(size=(len(o), 1)).astype(np.float32)
    mins, maxs = np.array([-1, -1, -1.0]), np.array([1, 1, 0.8])
    for j in (None, jit):
        ref_p, ref_m = jd.sample_ray(
            jnp.asarray(o), jnp.asarray(d), near=NEAR, far=FAR,
            xyz_min=jnp.asarray(mins, jnp.float32),
            xyz_max=jnp.asarray(maxs, jnp.float32), voxel_size=0.07,
            stepsize=0.5, n_samples=90,
            key=None if j is None else jax.random.PRNGKey(0))
        if j is not None:
            j = np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                            (len(o), 1)))
        pts, m = td.sample_ray(
            torch.from_numpy(o), torch.from_numpy(d), near=NEAR, far=FAR,
            xyz_min=torch.tensor(mins, dtype=torch.float32),
            xyz_max=torch.tensor(maxs, dtype=torch.float32), voxel_size=0.07,
            stepsize=0.5, n_samples=90,
            jitter=None if j is None else torch.from_numpy(j))
        _close(pts, ref_p)
        assert np.array_equal(_np(m), np.asarray(ref_m))


@pytest.mark.parametrize("kind", ["coarse", "fine", "fine_mlp"])
def test_render_losses_and_gradients_match(kind):
    """render with jitter and density noise, then dvgo_losses with every
    weight on (depth too), plus TV of the activated density and of k0:
    each output and the loss 1e-5, every parameter's gradient 1e-5."""
    jf, params, tf = _field_pair(kind)
    o, d, vd = _rays()
    S = jf.n_render_samples(FAR)
    assert tf.n_render_samples(FAR) == S
    key = jax.random.PRNGKey(3)
    k_ray, k_noise = jax.random.split(key)
    draws = dict(jitter=torch.from_numpy(np.array(
        jax.random.uniform(k_ray, (len(o), 1)))))
    if FIELDS[kind].get("density_noise"):
        draws["noise"] = torch.from_numpy(np.array(
            jax.random.normal(k_noise, (len(o), S))))
    rng = np.random.default_rng(4)
    tgt = rng.uniform(size=(len(o), 3)).astype(np.float32)
    tdepth = rng.uniform(2.0, 4.0, size=len(o)).astype(np.float32)
    wts = dict(weight_entropy_last=0.01, weight_rgbper=0.1,
               entropy_weight=0.01, weight_depth=0.05)

    def lj(p):
        out = jf.apply(p, o, d, vd, near=NEAR, far=FAR,
                       bg=jnp.array([1.0, 0.5, 0.0]), n_samples=S, key=key,
                       method=jf.render)
        loss, logs = jd.dvgo_losses(out, tgt, target_depth=tdepth, **wts)
        act = jf.apply(p, p["params"]["density"], method=jf.activate_density)
        loss = loss + 0.1 * jd.total_variation(act) \
            + 0.1 * jd.total_variation(p["params"]["k0"])
        return loss, (out, logs)

    (jloss, (jout, jlogs)), jgrad = jax.jit(
        jax.value_and_grad(lj, has_aux=True))(params)
    out = tf.render(torch.from_numpy(o), torch.from_numpy(d),
                    torch.from_numpy(vd), near=NEAR, far=FAR,
                    bg=torch.tensor([1.0, 0.5, 0.0]), n_samples=S, **draws)
    loss, logs = td.dvgo_losses(out, torch.from_numpy(tgt),
                                target_depth=torch.from_numpy(tdepth), **wts)
    loss = loss + 0.1 * td.total_variation(tf.activate_density(tf.density)) \
        + 0.1 * td.total_variation(tf.k0)
    loss.backward()
    for k in jout:
        _close(out[k], jout[k])
    for k in jlogs:
        _close(logs[k], jlogs[k])
    _close(loss, jloss)
    grads = from_jax_dvgo(jax.tree.map(np.asarray, jgrad))
    for name, p in tf.named_parameters():
        _close(p.grad, grads[name])


def test_render_of_rays_that_miss_the_box_matches():
    """Rays that miss the box select no sample for the colour MLP: the
    background and the far depth, as in the JAX package."""
    jf, params, tf = _field_pair("fine")
    o = np.tile(np.array([[5.0, 5.0, 5.0]], np.float32), (6, 1))
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (6, 1))
    S = jf.n_render_samples(FAR)
    ref = jf.apply(params, o, d, d, near=NEAR, far=FAR, bg=0.25,
                   n_samples=S, method=jf.render)
    with torch.no_grad():
        out = tf.render(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(d), near=NEAR, far=FAR, bg=0.25,
                        n_samples=S)
    for k in ("rgb_marched", "depths", "raw_rgb", "weights"):
        _close(out[k], ref[k])
    assert float(out["rgb_marched"].max()) == 0.25


def test_tv_metric_loss_mask_cache_and_scaling_match():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3, 6, 7, 5)).astype(np.float32)
    mask = rng.uniform(size=(1, 6, 7, 5)) > 0.3
    key = jax.random.PRNGKey(7)
    k1, k2, k3 = jax.random.split(key, 3)
    perms = [torch.from_numpy(np.asarray(jax.random.permutation(k, n)))
             for k, n in ((k1, 6), (k2, 7), (k3, 5))]
    for m in (None, mask):
        tm = None if m is None else torch.from_numpy(m)
        tv = jd.total_variation(jnp.asarray(v), m)
        _close(td.total_variation(torch.from_numpy(v), tm), tv)
        # TV minus a contrast of the same size: 1e-5 of the TV term
        got = td.metric_loss(torch.from_numpy(v), perms, tm)
        ref = jd.metric_loss(jnp.asarray(v), key, m)
        assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(tv))
    dens = (rng.normal(size=(1, 8, 7, 6)) * 4).astype(np.float32)
    jmc = jd.MaskCacheData((-1, -1, -1), (1, 1, 1), dens, -4.0, 1.0, 1e-3)
    tmc = td.MaskCacheData((-1, -1, -1), (1, 1, 1), torch.from_numpy(dens),
                           -4.0, 1.0, 1e-3)
    _close(tmc.density, jmc.density)
    xyz = rng.uniform(-1.2, 1.2, size=(500, 3)).astype(np.float32)
    assert np.array_equal(_np(tmc(torch.from_numpy(xyz))),
                          np.asarray(jmc(jnp.asarray(xyz))))
    jf, params, tf = _field_pair("fine")
    new = jd.scale_volume_grid(params, (13, 11, 9))
    td.scale_volume_grid(tf, (13, 11, 9))
    assert tf.world_size == (13, 11, 9)
    _close(tf.density, new["params"]["density"])
    _close(tf.k0, new["params"]["k0"])


@pytest.mark.parametrize("name", ["ExpLR_step", "StepLR_step",
                                  "StepAutoLR_step", "OneCycLR"])
def test_schedules_and_module_optimizers_match(name):
    p = dict(lr_scheduler=name, steps_per_epoch=9, num_epochs=3,
             decay_steps=7, step_decay=0.9, max_lr=0.05)
    js, ts = jsched.make_lr_schedule(p), tsched.make_lr_schedule(p)
    np.testing.assert_allclose([ts(s) for s in range(45)],
                               [float(js(s)) for s in range(45)], rtol=1e-5)
    rng = np.random.default_rng(6)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    for opt in ("SGD", "Adam"):
        q = dict(p, optimizer=opt)
        tx = jsched.make_module_optimizer(q)
        jw, state = jnp.asarray(w), tx.init(jnp.asarray(w))
        tw = torch.from_numpy(w.copy())
        topt = tsched.make_module_optimizer(q)
        for g in grads:
            upd, state = tx.update(jnp.asarray(g), state, jw)
            jw = optax.apply_updates(jw, upd)
            topt.step([tw], [torch.from_numpy(g)])
        _close(tw, jw)


