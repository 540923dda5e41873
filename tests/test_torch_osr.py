"""The port's OSR relighting fields (dreamfusion_torch/models/osr.py)
against the JAX package's (dreamfusion_tpu/models/osr.py), on the CPU.

The (field, decoder) pairs of tests/test_osr.py:39-47 (and V5), each
initialised by the JAX package at world_size (8, 8, 8), k0 4, width 16
and loaded into the port's field with strict=True; the JAX key's draws
rebuilt (OSR_Fine and V2: the jitter from k_ray, the shadow jitter
normal(k_jit); V3-V6 and RGI: the jitter from the key). Compared on 8
rays: every output of render (normal_marched, shadow_marched, irradiance,
raw_shadow, raw_rg among them) at 1e-5 of its largest entry, and every
parameter's gradient of an MSE loss at 1e-4 of the leaf's largest entry
(the normals' second-order term included). OSR_Fine and V2 also render and
evaluate under no_grad (their normals in a local enable_grad) as the JAX
package does without a key. illuminate_vec and AnnealingPosEmbedder
against JAX's; grid_sample_3d's position gradient on a face of the box
(which the normals read). The trainer's steps, the shadow options and the
.dvgo writer's refusal are in tests/test_torch_osr_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.models import osr as josr
from dreamfusion_tpu.training import dvgo_trainer as jt

from dreamfusion_torch.models import osr as tosr
from dreamfusion_torch.training import dvgo_trainer as tt
from dreamfusion_torch.weights import from_jax_params

from test_torch_dvgo_pretrain import CPU, _np, _rays
from test_torch_dvgo_trainer import _batches
from test_torch_zoo import (FAR, NEAR, N_RAYS, close, field_pair,
                            render_and_grad_parity)

W16 = dict(k0_dim=4, rgbnet_width=16, rgbnet_depth=3)
PE2 = dict(posbase_pe=2, viewbase_pe=2)
OSR_CASES = {
    "osr_fine": dict(rgbnet_name="shadowmlp", **W16),
    "osr_v2_fine": dict(rgbnet_name="shadowmlp", **W16),
    "osr_v3_fine": dict(rgbnet_name="basicmlp", **PE2, **W16),
    "osr_v4_fine": dict(rgbnet_name="separateshadowmlp", **PE2, **W16),
    "osr_v5_fine": dict(rgbnet_name="basicmlp", **PE2, **W16),
    "osr_v6_fine": dict(rgbnet_name="basicmlp", **PE2, **W16),
    "osr_rgi_fine": dict(rgbnet_name="basicmlp", **PE2, **W16),
}


@pytest.mark.parametrize("name", sorted(OSR_CASES))
def test_params_load_strictly(name):
    _, params, tf = field_pair(name, OSR_CASES[name])
    assert isinstance(tf, tosr.DVGOField)
    if name in ("osr_fine", "osr_v2_fine"):
        assert tuple(tf.env.shape) == (9, 3)
        # the rgbnet sees k0 and the 9 grey SH coefficients
        assert tf.rgbnet.shadow_0.in_features == 4 + 9


@pytest.mark.parametrize("name", sorted(OSR_CASES))
def test_render_and_gradients_match(name):
    out, jout, _ = render_and_grad_parity(name, OSR_CASES[name])
    if name in ("osr_fine", "osr_v2_fine"):
        assert {"normal_marched", "shadow_marched"} <= set(out)
    if name == "osr_v3_fine":          # the shadow floor
        s = _np(out["raw_shadow"])
        assert s[s != 1.0].min() >= 0.2 - 1e-5


@pytest.mark.parametrize("name", ["osr_fine", "osr_v2_fine"])
def test_eval_under_no_grad_gives_the_jax_image(name):
    """The render without draws, under no_grad, and the trainer's
    evaluate (the mean of its batches' PSNR) equal the JAX package's."""
    jf, params, tf = field_pair(name, OSR_CASES[name])
    S = jf.n_render_samples(FAR)
    def render(p, o, d, v):        # eagerly, as render_and_grad_parity
        return jf.apply(p, o, d, v, near=NEAR, far=FAR, bg=1.0, n_samples=S,
                        method=jf.render)

    o, d, vd = _rays(N_RAYS)
    ref = render(params, o, d, vd)
    with torch.no_grad():
        got = tf.render(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(vd), near=NEAR, far=FAR, bg=1.0,
                        n_samples=S)
    assert not got["rgb_marched"].requires_grad
    for k in ref:
        close(got[k], ref[k], err_msg=k)

    _, batches = _batches(2, n=N_RAYS)
    want = np.mean([float(jt.psnr(render(params, ro, rd, v)["rgb_marched"],
                                  tgt)) for rd, ro, v, tgt in batches])
    ttr = tt.DVGOTrainer(tf, tt.DVGOStageConfig(), near=NEAR, far=FAR,
                         device=CPU)
    tf.load_state_dict(from_jax_params(params))
    have = ttr.evaluate(batches)
    assert np.isfinite(have) and abs(have - want) <= 1e-4 * abs(want)


def test_illuminate_vec_matches():
    rng = np.random.default_rng(0)
    env = rng.normal(size=(9, 3)).astype(np.float32)
    for shape in ((16, 3), (4, 5, 3)):
        n = rng.normal(size=shape).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        close(tosr.illuminate_vec(torch.from_numpy(n), torch.from_numpy(env)),
              josr.illuminate_vec(jnp.asarray(n), jnp.asarray(env)))
    dc = np.zeros((9, 3), np.float32)
    dc[0] = [1.0, 2.0, 3.0]
    irr = _np(tosr.illuminate_vec(torch.tensor([[0.0, 0, 1.0], [1.0, 0, 0]]),
                                  torch.from_numpy(dc)))
    np.testing.assert_allclose(irr[0], 0.282095 * np.array([1, 2, 3]),
                               rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(n_freqs=4, N_anneal=100),
    dict(n_freqs=6, N_anneal=80, N_anneal_min_freq=2, max_freq_log2=3),
    dict(n_freqs=3, N_anneal=10, use_annealing=False, include_input=False),
])
def test_annealing_pos_embedder_matches(kw):
    x = np.random.default_rng(1).uniform(-1, 1, (5, 3)).astype(np.float32)
    jemb, temb = josr.AnnealingPosEmbedder(**kw), tosr.AnnealingPosEmbedder(**kw)
    for step in (0, kw["N_anneal"] // 2, kw["N_anneal"]):
        ref = jemb.apply({}, jnp.asarray(x), step)
        close(temb(torch.from_numpy(x), step), ref, err_msg=str(step))
    if kw.get("use_annealing", True) and not kw.get("N_anneal_min_freq"):
        np.testing.assert_allclose(_np(temb(torch.from_numpy(x), 0))[:, 3:],
                                   0.0, atol=1e-6)


def test_grid_sample_position_gradient_on_the_border_matches():
    """A sample on a face of the box (x01 exactly 0 or 1 on an axis: the
    first sample of a ray that enters there) takes half the position
    gradient at the clip's tie in the JAX package; the OSR normal reads it."""
    from dreamfusion_tpu.ops.grid_sample import grid_sample_3d as jgs

    from dreamfusion_torch.ops.grid_sample import grid_sample_3d as tgs

    rng = np.random.default_rng(3)
    grid = rng.normal(size=(2, 5, 6, 7)).astype(np.float32)
    x = rng.uniform(0.05, 0.95, (6, 3)).astype(np.float32)
    x[0, 2], x[1, 0], x[2, 1], x[3, 2] = 0.0, 1.0, 0.0, 1.0
    cot = rng.normal(size=(6, 2)).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(jgs(jnp.asarray(grid), v) * cot))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tgs(torch.from_numpy(grid), xt) * torch.from_numpy(cot)).sum().backward()
    close(xt.grad, ref)
