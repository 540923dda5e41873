"""The port's data parallelism (dreamfusion_torch/parallel) on the CPU: two
gloo processes, against the single-process port and the JAX package's
mesh path (dreamfusion_tpu/parallel/sharding.py on the virtual CPU mesh).

The ranks run jobs of dreamfusion_torch/parallel/jobs.py through
sharding.spawn, so they import the port alone. Each group meets through a
file under tmp_path (no TCP port), every collective times out after 60 s
and the spawn's join after 240 s, so a hang fails the test.

- Gradients: the averaged gradients equal the mean of the ranks' own
  (rel 1e-6: one f32 sum of two terms and a halving), and the JAX spec,
  the mean of grads_fn at fold_in(k, 0) and fold_in(k, 1)
  (tests/test_dp_grad_equality.py:22-64), with those draws injected per
  rank, at the -O step's tolerances (loss rel 1e-4, gradients 1e-3 of each
  leaf's largest entry, tests/test_torch_train.py).
- Trainer: after each of 2 steps the ranks hold the same bits (parameters
  and occupancy grid); the first step's averaged gradients are the mean of
  the ranks' local ones (1e-6).
- The ray-sharded eval frame equals the single-process direct
  render_grid (1e-6) and JAX make_eval_render(mesh=make_mesh(2))
  (1e-4 / 1e-5, the staged eval's tolerances).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.guidance import none_guidance as j_none_guidance
from dreamfusion_tpu.ops import marching as jmarch
from dreamfusion_tpu.parallel.sharding import make_mesh
from dreamfusion_tpu.training import trainer as jtrainer

from dreamfusion_torch import cameras as tcam
from dreamfusion_torch.config import parse_config
from dreamfusion_torch.models.networks import make_field_fns as t_field_fns
from dreamfusion_torch.ops import marching as tmarch
from dreamfusion_torch.parallel import jobs, sharding
from dreamfusion_torch.training import trainer as ttrainer
from dreamfusion_torch.weights import from_jax_params

from test_torch_eval import _eval_setup, _np
from test_torch_marching import (SMALL, _close, _compare_grads, _nerf_pair,
                                 _refresh, _t)
from test_torch_train import _step_draws, concrete_shading  # noqa: F401

CPU = torch.device("cpu")


def _spawn(tmp_path, job, args):
    return sharding.spawn(job, args, [CPU, CPU], "gloo",
                          init_method=f"file://{tmp_path}/pg_init",
                          timeout_s=60.0, join_timeout_s=240.0)


def test_dp_grads_are_the_mean_of_the_ranks_and_the_jax_spec(
        tmp_path, concrete_shading):
    """Two ranks, each with the draws of JAX's fold_in(k, rank): the
    averaged gradients against the ranks' own and against JAX's spec."""
    cfg_kw = dict(SMALL, guidance="none", lambda_opacity=1e-3)
    jcfg = JConfig(**cfg_kw)
    jm, params, tm = _nerf_pair(2)
    jstate = jmarch.init_grid_state(1, 16)
    tstate = tmarch.init_grid_state(1, 16, CPU)
    jstate, tstate = _refresh(jm, params, tm, cfg_kw, jstate, tstate,
                              jax.random.PRNGKey(4), 0)
    text_z = np.zeros((6, 1), np.float32)
    k = jax.random.PRNGKey(11)
    jfn = jtrainer.make_grads_fn(jcfg, jm, j_none_guidance(), "grid")
    per_dev = [jfn(params, jnp.int32(1), {}, jnp.asarray(text_z),
                   jax.random.fold_in(k, r), jstate) for r in range(2)]
    jloss = np.mean([float(l) for l, _, _ in per_dev])
    jgrads = jax.tree.map(lambda *g: jnp.mean(jnp.stack(g), 0),
                          *[g for _, _, g in per_dev])
    draws = [_step_draws(jax.random.fold_in(k, r), cfg_kw) for r in range(2)]
    res = _spawn(tmp_path, jobs.grads_job,
                 (cfg_kw, from_jax_params(params), tstate, draws,
                  _t(text_z), 1))
    for key, g in res[0]["dp"].items():
        assert torch.equal(g, res[1]["dp"][key]), key
        mean = (res[0]["local"][key] + res[1]["local"][key]) / 2
        _close(g, mean.numpy(), 1e-6)
    assert not torch.equal(res[0]["local"]["embeddings"],
                           res[1]["local"]["embeddings"])
    _close(res[0]["dp_loss"], float(res[0]["local_loss"]
                                    + res[1]["local_loss"]) / 2, 1e-6)
    _close(res[0]["dp_loss"], jloss, 1e-4)
    for name, p in tm.named_parameters():
        p.grad = res[0]["dp"][name]
    _compare_grads(jgrads, tm, 1e-3)
    assert float(res[0]["metrics"]["count_q95"]) == float(
        res[1]["metrics"]["count_q95"])


def test_dp_trainer_ranks_hold_the_same_bits(tmp_path):
    """A 2-rank Trainer (-O, cone stepping, jitter, EMA) for 2 steps: the
    same parameter and grid bits on both ranks after every step, the first
    step's averaged gradients the mean of the ranks' own, and a
    ray-sharded 12 x 12 frame equal to rank 0's direct render_grid."""
    argv = ["-O", "--text", "x", "--guidance", "none", "--h", "8", "--w",
            "8", "--grid_size", "8", "--max_steps", "32", "--H", "12", "--W",
            "12", "--device", "cpu", "--workspace", str(tmp_path / "ws"),
            "--iters", "2", "--dt_gamma", "0.02", "--jitter_pose",
            "--ema_decay", "0.9", "--lambda_opacity", "1e-3"]
    res = _spawn(tmp_path, jobs.train_job, (argv, 2, 1))
    assert res[0]["digests"] == res[1]["digests"]
    assert len(set(res[0]["digests"])) == 2          # the step moved them
    assert res[0]["allreduces"] == res[1]["allreduces"] == 2
    for key, g in res[0]["averaged"].items():
        mean = (res[0]["local"][key] + res[1]["local"][key]) / 2
        _close(g, mean.numpy(), 1e-6)
    assert not torch.equal(res[0]["local"]["embeddings"],
                           res[1]["local"]["embeddings"])
    for k in ("image", "depth", "weights_sum"):
        _close(res[0]["frame"][k], res[0]["direct"][k].numpy(), 1e-6)
    assert (tmp_path / "ws" / "log_dp.jsonl").exists()


def test_sharded_frame_matches_direct_render_and_jax_mesh(tmp_path):
    """Orbit frame 1 at 16 x 16 over two ranks (pad-free: 256 rays) through
    make_eval_render: against one process's direct render_grid (1e-6) and
    JAX make_eval_render(renderer="grid", mesh=make_mesh(2)) (1e-4 /
    1e-5)."""
    jcfg, jm, params, gs, tcfg, tm, tgs = _eval_setup(1.0, "f32")
    b = tcam.sample_test_batch(1, 10, tcfg, device=CPU)
    o, d = b["rays_o"][0], b["rays_d"][0]
    res = _spawn(tmp_path, jobs.frame_job,
                 (dataclasses.asdict(tcfg), tm.state_dict(), tgs, 1, 10))
    for k in res[0]:
        assert torch.equal(res[0][k], res[1][k])
    fns = t_field_fns(tm)._replace(normal=None)
    with torch.no_grad():
        direct = tmarch.render_grid(
            fns, tgs, o, d, bound=1.0, min_near=tcfg.min_near,
            max_steps=tcfg.max_steps, K=tcfg.grid_K, bg_radius=tcfg.bg_radius,
            light_d=tcam.safe_normalize(o[0]), perturb=False)
    jrender = jtrainer.make_eval_render(jcfg, jm, 16, 16, chunk=128,
                                        renderer="grid", mesh=make_mesh(2))
    ref = jrender(params, jnp.asarray(_np(o)), jnp.asarray(_np(d)), gs)
    for k in ("image", "depth", "weights_sum"):
        got = res[0][k].reshape(direct[k].shape)
        _close(got, _np(direct[k]), 1e-6)
        np.testing.assert_allclose(_np(res[0][k]), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-5)
    assert float(res[0]["weights_sum"].max()) > 1e-3


def test_n_devices_beyond_the_visible_cards_raises(tmp_path):
    """More ranks than cards raise on cuda (trainer.py:998-1003), as does a
    Trainer asked for several ranks without a process group."""
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA devices visible"):
            sharding.world_size(2, torch.device("cuda"))
    with pytest.raises(ValueError, match="visible"):
        sharding.world_size(max(torch.cuda.device_count() + 1, 2),
                            torch.device("cuda"))
    assert sharding.world_size(3, CPU) == 3
    assert sharding.world_size(0, CPU) == 1
    cfg = parse_config(["-O", "--text", "x", "--guidance", "none",
                        "--device", "cpu", "--n_devices", "2",
                        "--workspace", str(tmp_path)])
    with pytest.raises(ValueError, match="one process per rank"):
        ttrainer.Trainer("t", cfg, use_checkpoint="scratch")
