"""Parity of the port's train step with the JAX package, on the CPU, at
a small -O-shaped size: one whole train step (h = w = 16, SD random-nano,
grid backbone, fp16=False so JAX takes the f32 XLA scatter and the einsum
attention; albedo shading, where the orient loss is 0 and JAX's plain
compositor gives the fused one's loss and gradients) with the weights
carried over and every draw reproduced from the JAX key tree
(trainer.py:84, cameras.py:92,194, sds.py:105): same loss (rel 1e-4) and
same gradient per parameter leaf (1e-3 of the leaf's largest entry); then
a second step after an occupancy refresh, at the (K, M) budgets both
trainers' pickers choose from the first step's statistics.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.config import Config as JConfig
from dreamfusion_tpu.guidance import Guidance as JGuidance
from dreamfusion_tpu.guidance.sd import layers as jlayers
from dreamfusion_tpu.guidance.sd import scheduler as jsched
from dreamfusion_tpu.guidance.sd import sds as jsds
from dreamfusion_tpu.guidance.sd import unet as junet
from dreamfusion_tpu.guidance.sd import vae as jvae
from dreamfusion_tpu.ops import marching as jmarch
from dreamfusion_tpu.training import trainer as jtrainer
from dreamfusion_tpu.training.optimizers import build_optimizer as j_build_opt

from dreamfusion_torch.config import Config as TConfig
from dreamfusion_torch.guidance.sd import layers as tlayers
from dreamfusion_torch.guidance.sd import sds as tsds
from dreamfusion_torch.guidance.sd import unet as tunet
from dreamfusion_torch.guidance.sd import vae as tvae
from dreamfusion_torch.ops import marching as tmarch
from dreamfusion_torch.training import trainer as ttrainer
from dreamfusion_torch.training.optimizers import build_optimizer as t_build_opt
from dreamfusion_torch.weights import from_jax_params

from test_torch_marching import (SMALL, _close, _compare_grads, _nerf_pair,
                                 _rays, _refresh, _t)
from test_torch_sd import random_params


@pytest.fixture
def f32_groupnorm(monkeypatch):
    monkeypatch.setattr(jlayers, "GN_DTYPE", "f32")
    monkeypatch.setattr(tlayers, "GN_DTYPE", "f32")


def _sd_pair():
    ju, jv = junet.nano_unet(), jvae.nano_vae()
    k = jax.random.PRNGKey(0)
    gp = {"unet": random_params(lambda: ju.init(
              k, jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,), jnp.int32),
              jnp.zeros((1, 77, 16))), 10),
          "vae": random_params(lambda: jv.init(
              k, jnp.zeros((1, 64, 64, 3)), k), 11)}
    js = jsched.make_schedule()
    jg = JGuidance(name="stable-diffusion", params=gp,
                   get_text_embeds=None,
                   loss=lambda p, tz, rgb, key: jsds.sds_loss(
                       ju, jv, js, p, tz, rgb, key, latent_size=8))
    tu, tv = tunet.nano_unet().eval(), tvae.nano_vae().eval()
    tu.load_state_dict(from_jax_params(gp["unet"]))
    tv.load_state_dict(from_jax_params(gp["vae"]))
    for m in (tu, tv):
        m.requires_grad_(False)
    return jg, tsds.sd_guidance(tu, tv, latent_size=8)


def _step_draws(key, cfg_kw):
    """The JAX grads_fn key tree (trainer.py:84) as the port's draws."""
    jcfg = JConfig(**cfg_kw)
    N = jcfg.batch_size * jcfg.h * jcfg.w
    k_batch, k_shade, k_bg, k_render, k_guid = jax.random.split(key, 5)
    k_light, k_march, _ = jax.random.split(k_render, 3)
    k_enc, k_t, k_noise = jax.random.split(k_guid, 3)
    lat = (jcfg.batch_size, 32, 32, 4)
    _, _, draws = _rays(k_batch, cfg_kw)
    draws.update(
        shade_u=float(jax.random.uniform(k_shade)),
        bg=_t(jax.random.uniform(k_bg, (N, 3))),
        light_n=_t(jax.random.normal(k_light, (3,))),
        perturb_u=_t(jax.random.uniform(k_march, (N,))),
        vae_eps=_t(jax.random.normal(k_enc, lat)),
        t=_t(jax.random.randint(k_t, (jcfg.batch_size,), 20, 981)),
        noise=_t(jax.random.normal(k_noise, lat)))
    return draws


def _pick(cls, cfg, metrics, cur_K, ema_holder):
    stub = types.SimpleNamespace(cfg=cfg, _mean_count_ema=ema_holder[0])
    K = cls._pick_grid_K_live(stub, float(metrics["live_q95"]),
                              float(metrics["count_q95"]), cur_K)
    M = cls._pick_compact_M(stub, float(metrics["mean_count"]), K)
    ema_holder[0] = stub._mean_count_ema
    return K, M


@pytest.fixture
def concrete_shading(monkeypatch):
    """Evaluate the JAX shading schedule eagerly and hand make_field_fns a
    Python int: it then dispatches statically (networks.py:267) instead of
    through lax.cond, whose branches eager JAX recompiles on every call.
    The code and ratio are the schedule's own values."""
    orig = jtrainer._shading_schedule

    def concrete(key, step, albedo_iters):
        code, ratio = orig(key, step, albedo_iters)
        return int(code), ratio

    monkeypatch.setattr(jtrainer, "_shading_schedule", concrete)


def test_train_step_matches_jax_and_after_refresh(f32_groupnorm,
                                                  concrete_shading):
    """Step 1 (dense, K = grid_K) and step 2 after a refresh at the picked
    (K, M): loss rel 1e-4, gradients rel 1e-3 per leaf. Between the steps
    both sides continue from the JAX parameters after its Adam update (the
    port's Adam applied to the JAX gradients must land on the same
    parameters, 1e-6), so step 2 compares like with like: Adam's first step
    moves every parameter by about lr * sign(g), which would turn grad
    noise of 1e-7 into parameter differences of a full step."""
    cfg_kw = dict(SMALL)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    jm, params, tm = _nerf_pair(4)
    jg, tg = _sd_pair()
    text_z = np.random.default_rng(5).normal(size=(6, 2, 77, 16)).astype(np.float32)
    jstate = jmarch.init_grid_state(1, 16)
    tstate = tmarch.init_grid_state(1, 16, torch.device("cpu"))
    jstate, tstate = _refresh(jm, params, tm, cfg_kw, jstate, tstate,
                              jax.random.PRNGKey(6), 0)

    def step(K, M, key, step_idx):
        jfn = jtrainer.make_grads_fn(jcfg, jm, jg, "grid", grid_K=K,
                                     compact_M=M)
        jloss, jmet, jgrads = jfn(params, jnp.int32(step_idx), jg.params,
                                  jnp.asarray(text_z), key, jstate)
        tfn = ttrainer.make_grads_fn(tcfg, tm, tg, grid_K=K, compact_M=M)
        tloss, tmet = tfn(step_idx, _t(text_z), tstate,
                          draws=_step_draws(key, cfg_kw))
        assert tmet["shading_code"] == int(jmet["shading_code"])
        _close(tloss, jloss, 1e-4)
        _compare_grads(jgrads, tm, 1e-3)
        for k in ("count_q95", "live_q95", "mean_count"):
            _close(tmet[k], jmet[k], 1e-5)
        return jmet, jgrads

    jmet, jgrads = step(cfg_kw["grid_K"], None, jax.random.PRNGKey(7), 0)

    # one Adam update: optax on the JAX side, torch.optim on the port's
    tx = j_build_opt(jcfg, params)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
    opt, sched = t_build_opt(tcfg, tm)
    jflat = from_jax_params(jax.tree.map(np.asarray, jgrads))
    for k, p in tm.named_parameters():
        p.grad = jflat[k].clone()
    opt.step()
    sched.step()
    got = {k: v.detach() for k, v in tm.state_dict().items()}
    for k, v in from_jax_params(jax.tree.map(np.asarray, params)).items():
        _close(got[k], v.numpy(), 1e-6)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))

    jstate, tstate = _refresh(jm, params, tm, cfg_kw, jstate, tstate,
                              jax.random.PRNGKey(8), 1)
    jK, jM = _pick(jtrainer.Trainer, jcfg, jmet, cfg_kw["grid_K"], [None])
    tK, tM = _pick(ttrainer.Trainer, tcfg, jmet, cfg_kw["grid_K"], [None])
    assert (tK, tM) == (jK, jM)
    step(tK, tM, jax.random.PRNGKey(9), 1)
