"""Each cell's run, with the look for a chip skipped, on the CPU at a
small size (tiny.py): sound, it comes out correct; with the timed path
broken underneath, by each fault the cell can have, `correct` comes out
false.

- a step that returns its state unchanged (the training cells);
- half of the batch left out: half of the rays left out of the render
  (SDS: their pixels white, their opacity 0), or each step trained on half
  of its rays (pretraining);
- an answer altered where it is produced: a row of each written frame
  inverted (the orbit).

One chip: no exchange between chips to leave out."""

import contextlib
import time

import pytest

from benchkit import harness
from dfref.steps import leave_out_half

from tiny import tiny_cell

SDS_CELLS = ("grid_sd15.sds_train", "dvgo_sd15.edit_sds")


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@pytest.fixture(autouse=True)
def f32_group_norm():
    from dreamfusion_torch.guidance.sd import layers

    with patched(layers, "GN_DTYPE", "f32"):
        yield


def run(name):
    res, checks = harness.run(name, 20260417, 0.5, False, time.perf_counter(),
                              device="cpu", cell=tiny_cell(name))
    return res, checks


def state_unchanged_sds():
    from dreamfusion_torch.training.trainer import Trainer

    orig = Trainer.train_step

    def step(self, draws=None):
        saved = {k: v.detach().clone()
                 for k, v in self.model.state_dict().items()}
        metrics = orig(self, draws)
        self.model.load_state_dict(saved)
        return metrics

    return patched(Trainer, "train_step", step)


def half_batch_sds():
    from dreamfusion_torch.training import trainer

    orig = trainer.render_grid

    def render(*args, **kw):
        out = dict(orig(*args, **kw))
        out["image"], out["weights_sum"] = leave_out_half(
            out["image"], out["weights_sum"])
        return out

    return patched(trainer, "render_grid", render)


def state_unchanged_pretrain():
    from dreamfusion_torch.training.dvgo_trainer import GroupAdam

    def step(self, module):
        self.count += 1

    return patched(GroupAdam, "step", step)


def half_batch_pretrain():
    from dreamfusion_torch.training.dvgo_trainer import DVGOTrainer

    orig = DVGOTrainer.step

    def step(self, batch, draws=None):
        h = len(batch[0]) // 2
        return orig(self, tuple(b[:h] for b in batch),
                    {k: v[:h] for k, v in (draws or {}).items()})

    return patched(DVGOTrainer, "step", step)


def altered_frame():
    from dreamfusion_torch.training.trainer import Trainer

    orig = Trainer._save_frame

    def save(self, out, path_rgb, path_depth=None):
        out = dict(out)
        img = out["image"].clone()
        img[0] = 1.0 - img[0]
        out["image"] = img
        return orig(self, out, path_rgb, path_depth)

    return patched(Trainer, "_save_frame", save)


FAULTS = [(c, f) for c in SDS_CELLS
          for f in (state_unchanged_sds, half_batch_sds)] + [
    ("dvgo_sd15.pretrain_fine", state_unchanged_pretrain),
    ("dvgo_sd15.pretrain_fine", half_batch_pretrain),
    ("grid_sd15.eval_orbit", altered_frame)]


@pytest.mark.parametrize("name", SDS_CELLS + ("dvgo_sd15.pretrain_fine",
                                              "grid_sd15.eval_orbit"))
def test_a_sound_run_is_correct(name):
    res, checks = run(name)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_fails(name, fault):
    with fault():
        res, checks = run(name)
    assert not res["correct"], checks


@pytest.mark.parametrize("name", SDS_CELLS)
def test_the_window_steps_on_the_programs_own_draws(name):
    """Only the checked steps take the benchmark's draws: from then on
    Trainer.advance reaches the Trainer's own train_step, whose draws come
    from the generators seeded by the run's seed."""
    from runners import sds

    r = sds.Run(tiny_cell(name), 2 ** 40 + 3, device="cpu")
    try:
        assert "train_step" not in vars(r.trainer)
        assert r.trainer.cfg.seed == 2 ** 40 + 3
        a = r.trainer.step_gen.get_state()
        r.steps(n=1)
        assert not (a == r.trainer.step_gen.get_state()).all()
    finally:
        r.release()
        r.close()


@pytest.mark.parametrize("name", SDS_CELLS + ("grid_sd15.eval_orbit",))
def test_the_asset_is_the_same_for_every_seed(name):
    """The asset that a cell trains or renders comes from the
    configuration's asset_seed, not from the run's seed."""
    from benchkit import cells

    cell = tiny_cell(name)
    mod = cells.runner(cell.mix["runner"])
    states = []
    for seed in (11, 12):
        r = mod.Run(cell, seed, device="cpu")
        states.append(r.init_state)
        r.release()
        r.close()
    assert states[0].keys() == states[1].keys()
    assert all(torch_equal(states[0][k], states[1][k]) for k in states[0])


def torch_equal(a, b):
    import torch

    return bool(torch.equal(a, b))


def test_the_edit_control_computes_the_rgbnet_in_float8():
    """The editing cell's control lowers the one module that the cell
    trains, the DVGO rgbnet, as -O states half precision for the field."""
    import torch

    from benchkit import lowp
    from dfref.models.dvgo import DVGOField

    field = DVGOField(world_size=(8, 8, 8), k0_dim=12, rgbnet_name="resmlp",
                      rgbnet_width=16, rgbnet_depth=3)
    field.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(64, field.rgbnet_in_dim(),
                    generator=torch.Generator().manual_seed(1))
    plain = field.rgbnet(x).detach()
    lowp.fp8_linears(field.rgbnet)
    low = field.rgbnet(x)
    assert not torch.equal(plain, low)
    assert torch.allclose(plain, low, atol=0.2 * float(plain.abs().max()))
    low.sum().backward()
    assert all(p.grad is not None for p in field.rgbnet.parameters())
