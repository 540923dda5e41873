"""The OSR fields in the port's DVGO trainer against the JAX package's, on
the CPU (the renders are held in tests/test_torch_osr.py):

- two DVGOTrainer steps of OSR_Fine (its shadow draws and the normal's
  second-order term in the step) across a pg_scale milestone, against the
  JAX trainer with the same parameters, batches and draws: every
  parameter (env included) to 1e-4 of its largest entry; the milestone
  keeps the subclass and its env;
- the trainer's initialisation of each variant (OSR's env drawn, V6's k0
  zero) and the draws it takes from the field's draw_spec;
- use_shadow=False and use_shadow_jitter=False renders and gradients;
- the .dvgo writer refuses an OSR field in both packages.
"""

import pytest

from dreamfusion_tpu.training import dvgo_trainer as jt

from dreamfusion_torch.models import osr as tosr
from dreamfusion_torch.training import dvgo_trainer as tt

from test_torch_dvgo_pretrain import CPU
from test_torch_osr import OSR_CASES, PE2, W16
from test_torch_zoo import (FAR, NEAR, field_pair, render_and_grad_parity,
                            trainer_steps_parity)


def test_trainer_steps_across_pg_scale_match():
    """OSR_Fine: the shadow draws and the second-order normal in the step;
    the milestone keeps the subclass and its env."""
    tr = trainer_steps_parity("osr_fine", OSR_CASES["osr_fine"])
    assert isinstance(tr.field, tosr.OSR_Fine)


def test_trainer_init_extends_reset_parameters():
    tr = tt.DVGOTrainer(tosr.OSR_Fine_V6(world_size=(4, 4, 4), **PE2, **W16),
                        tt.DVGOStageConfig(), near=1.0, far=3.0, device=CPU)
    assert float(tr.field.k0.abs().max()) == 0.0
    tr = tt.DVGOTrainer(tosr.OSR_Fine(world_size=(4, 4, 4),
                                      rgbnet_name="shadowmlp", **W16),
                        tt.DVGOStageConfig(), near=1.0, far=3.0, device=CPU,
                        seed=1)
    env = tr.field.env.detach()
    assert env.shape == (9, 3) and 0.3 < float(env.std()) < 2.0
    spec = tr.field.draw_spec(5, 7)
    assert spec == {"jitter": ((5, 1), "uniform"),
                    "shadow_jitter": ((5, 7, 9), "normal")}
    d = tr._draws(5, None)
    assert d["shadow_jitter"].shape == (5, tr.n_samples, 9)


def test_shadow_off_and_jitter_off_match():
    """use_shadow=False (albedo only) and use_shadow_jitter=False (no
    shadow draw: the key still splits, as in the JAX package)."""
    for name in ("osr_fine", "osr_v2_fine"):
        render_and_grad_parity(name, dict(OSR_CASES[name], use_shadow=False,
                                          use_shadow_jitter=False))
    render_and_grad_parity("osr_v3_fine", dict(OSR_CASES["osr_v3_fine"],
                                               use_shadow=False))


def test_dvgo_writer_refuses_an_osr_field_in_both(tmp_path):
    """The .dvgo layout knows ResMLP and BasicMLP only (and no env): the
    JAX package's writer fails on the ShadowMLP tree, the port's raises."""
    jf, params, tf = field_pair("osr_fine", OSR_CASES["osr_fine"])
    jtr = object.__new__(jt.DVGOTrainer)     # the writer reads these two
    jtr.field, jtr.params = jf, params
    with pytest.raises(KeyError):
        jtr.save_dvgo(str(tmp_path / "j.dvgo"))
    ttr = tt.DVGOTrainer(tf, tt.DVGOStageConfig(), near=NEAR, far=FAR,
                         device=CPU)
    with pytest.raises(ValueError, match="ResMLP or a BasicMLP"):
        ttr.save_dvgo(str(tmp_path / "t.dvgo"))
    assert not (tmp_path / "t.dvgo").exists()
