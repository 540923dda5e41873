"""The port's DVGO trainer, view counts and two-stage pipeline
(training/dvgo_trainer.py, training/nerf_pipeline.py) against the JAX
package, on the CPU, with the JAX parameters carried over by
weights.from_jax_dvgo and the JAX draws injected:

- three DVGOTrainer steps with per-voxel factors and a pg_scale milestone
  on the same batches and draws: every parameter to 1e-4 of its largest
  entry or 3x the JAX run's own move when one batch's targets move by one
  ulp (Adam on tiny gradients turns with their rounding);
- voxel_count_views exactly;
- train_nerf_models on the synthetic ball scene of
  tests/test_dvgo_pipeline.py:18, 3 iterations a stage, in both packages;
  the port's .dvgo read by the JAX package and the JAX package's read by
  the port, tensors equal.
"""

import jax
import numpy as np
import torch

from dreamfusion_tpu.datasets.rays import gather_training_rays
from dreamfusion_tpu.models import dvgo as jd
from dreamfusion_tpu.training import dvgo_trainer as jt

from dreamfusion_torch.models import dvgo as td
from dreamfusion_torch.training import dvgo_trainer as tt
from dreamfusion_torch.weights import from_jax_dvgo

from test_dvgo_pipeline import _synthetic_scene
from test_torch_dvgo_pretrain import CPU, _np, _rays


def _batches(n_batches, n=40, seed=0):
    data = _synthetic_scene()
    rgb, ro, rd, vd, _ = gather_training_rays(data, {}, "i_train", "random")
    rng = np.random.default_rng(seed)
    idx = [rng.choice(len(rgb), n, replace=False) for _ in range(n_batches)]
    return data, [(rd[i], ro[i], vd[i], rgb[i]) for i in idx]


def _jax_steps(field, stage, params, factors, batches, base):
    """The JAX trainer's fit, batch by batch, from `params`; returns the
    final params and the step keys' jitter draws."""
    tr = jt.DVGOTrainer(field, stage, near=1.0, far=5.0,
                        pervoxel_factors=factors)
    tr.params = params
    tr.opt_state = tr.tx.init(params)
    tr.fit(batches, num_voxels_base=base)
    return tr


def test_trainer_steps_match_with_pervoxel_factors_and_pg_scale():
    """Three steps (pg_scale at step 1: the grids re-interpolated, the
    optimizer rebuilt without factors, its state reset) from the same
    parameters, batches and jitter draws."""
    kw = dict(k0_dim=4, rgbnet_name="resmlp", rgbnet_width=16, posbase_pe=2,
              viewbase_pe=2, alpha_init=1e-2)
    base = 6 * 6 * 6
    ws = jt.world_size_for((-1, -1, -1), (1, 1, 1), base)
    stage = jt.DVGOStageConfig(n_iters=3, lr_density=0.1, lr_k0=0.1,
                               lr_rgbnet=1e-2, batch_size=40,
                               weight_entropy_last=0.01, weight_rgbper=0.1,
                               weight_tv_density=0.01, weight_tv_k0=0.01,
                               pg_scale=(1,))
    jf = jd.DVGOField(world_size=ws, **kw)
    o, d, vd = _rays(4)
    params = jax.tree.map(np.asarray, jf.init(
        jax.random.PRNGKey(0), o, d, vd, near=1.0, far=5.0, bg=1.0,
        n_samples=jf.n_render_samples(5.0), method=jf.render))
    params["params"]["density"] = params["params"]["density"] + 1.0
    data, batches = _batches(3)
    count = np.asarray(jt.voxel_count_views(jf, params, data, {}, 0.5))
    fac = (0.5 + count / max(count.max(), 1.0)).astype(np.float32)
    factors = jax.tree_util.tree_map_with_path(
        lambda p, _: fac if str(p[-1].key) in ("density", "k0") else None,
        params)
    ref = _jax_steps(jf, stage, params, factors, batches, base)
    ctl_batches = [list(b) for b in batches]
    ctl_batches[0][3] = np.nextafter(ctl_batches[0][3], np.float32(2))
    ctl = _jax_steps(jf, stage, params, factors, ctl_batches, base)

    tf = td.DVGOField(world_size=ws, **kw)
    tr = tt.DVGOTrainer(tf, tt.DVGOStageConfig(**vars(stage)), near=1.0,
                        far=5.0, pervoxel_factors={
                            "density": torch.from_numpy(fac),
                            "k0": torch.from_numpy(fac)}, device=CPU)
    tf.load_state_dict(from_jax_dvgo(params))
    key = jax.random.split(jax.random.PRNGKey(0))[0]
    draws = []
    for _ in range(3):
        key, k = jax.random.split(key)
        draws.append({"jitter": torch.from_numpy(np.asarray(
            jax.random.uniform(jax.random.split(k)[0], (40, 1))))})
    tr.fit(batches, num_voxels_base=base, draws=lambda it: draws[it])
    assert tf.world_size == jt.world_size_for((-1, -1, -1), (1, 1, 1),
                                              2 * base)
    assert tr.opt.count == 2 and not tr.opt.factors
    got = tf.state_dict()
    want = from_jax_dvgo(ref.params)
    move = from_jax_dvgo(ctl.params)
    for k, w in want.items():
        tol = max(1e-4 * float(w.abs().max()),
                  3 * float((move[k] - w).abs().max()))
        np.testing.assert_allclose(_np(got[k]), _np(w), atol=tol, err_msg=k)


def test_voxel_count_views_matches_exactly():
    data = _synthetic_scene()
    jf = jd.DVGOField(world_size=(9, 10, 11), k0_dim=3,
                      xyz_min=(-1, -1, -1), xyz_max=(1, 1, 1))
    o, d, vd = _rays(4)
    params = jf.init(jax.random.PRNGKey(0), o, d, vd, near=1.0, far=5.0,
                     bg=1.0, n_samples=jf.n_render_samples(5.0),
                     method=jf.render)
    tf = td.DVGOField(world_size=(9, 10, 11), k0_dim=3)
    for down in (1, 2):
        ref = np.asarray(jt.voxel_count_views(jf, params, data, {}, 0.5,
                                              downrate=down))
        got = _np(tt.voxel_count_views(tf, data, {}, 0.5, downrate=down))
        assert ref.sum() > 0
        np.testing.assert_array_equal(got, ref)


def test_train_nerf_models_and_dvgo_files_both_ways(tmp_path):
    """Both packages' pipelines on the synthetic ball, 3 iterations a
    stage: finite test PSNR, the same coarse box; each package's .dvgo is
    read by the other (grids and rgbnet equal)."""
    from dreamfusion_tpu.models.kailu import (load_dvgo_state_into_params,
                                              peek_dvgo_checkpoint)
    from dreamfusion_tpu.training.nerf_pipeline import \
        train_nerf_models as j_train

    from dreamfusion_torch.models.kailu import peek_dvgo_checkpoint as tpeek
    from dreamfusion_torch.training.image_renderer import load_dvgo_field
    from dreamfusion_torch.training.nerf_pipeline import \
        train_nerf_models as t_train

    data = _synthetic_scene()
    params = {
        "cfg_data": None, "data_dict": data, "batch_size": 48,
        "coarse_model": {"num_voxels": 12 ** 3, "alpha_init": 1e-2},
        "coarse_train": {"n_iters": 3, "lr_density": 0.3, "lr_k0": 0.3},
        "fine_model": {"num_voxels": 14 ** 3, "alpha_init": 1e-2,
                       "k0_dim": 4, "rgbnet_width": 16, "rgbnet_depth": 3,
                       "posbase_pe": 2, "viewbase_pe": 2,
                       "bbox_thres": 1e-4},
        "fine_train": {"n_iters": 3, "lr_density": 0.3, "lr_k0": 0.1,
                       "lr_rgbnet": 1e-2},
        "max_test_batches": 1,
    }
    quiet = lambda *a: None  # noqa: E731
    jout = j_train(dict(params, save_name=str(tmp_path / "j.dvgo")),
                   log_fn=quiet)
    tout = t_train(dict(params, save_name=str(tmp_path / "t.dvgo")),
                   log_fn=quiet, device=CPU)
    assert np.isfinite(tout["test_psnr"]) and np.isfinite(jout["test_psnr"])
    assert tout["coarse_trainer"].field.xyz_min == \
        jout["coarse_trainer"].field.xyz_min
    # port file -> JAX reader
    meta = peek_dvgo_checkpoint(tout["save_path"])
    assert meta == tpeek(tout["save_path"])
    f = tout["fine_trainer"].field
    jfine = jd.DVGOField(world_size=meta["world_size"], k0_dim=4,
                         rgbnet_name="resmlp", rgbnet_width=16,
                         posbase_pe=2, viewbase_pe=2)
    o, d, vd = _rays(4)
    tpl = jfine.init(jax.random.PRNGKey(0), o, d, vd, near=1.0, far=5.0,
                     bg=1.0, n_samples=8, method=jfine.render)
    loaded = load_dvgo_state_into_params({"params": {"main": tpl["params"]}},
                                         tout["save_path"], scope="main")
    back = from_jax_dvgo({"params": loaded["params"]["main"]})
    for k, v in f.state_dict().items():
        assert torch.equal(back[k], v), k
    # JAX file -> the port's reader
    tfield = load_dvgo_field(jout["save_path"], device=CPU)
    want = from_jax_dvgo(jout["fine_trainer"].params)
    for k, v in tfield.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert tfield.alpha_init == 1e-2
