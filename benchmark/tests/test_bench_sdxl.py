"""The cells dvgo_sdxl.edit_sds_1024 and dvgo_sd15.edit_orbit on the CPU
at a small size (SDXL's structure at tiny widths, in float32), their
operation count and their readers: a sound SDXL run comes out correct and
each fault the cell can have makes it false; the orbit renders the
editing cell's scene and an altered frame fails it; the SDXL step counts
SDXL's operations; the new readers read the span and the kernel they
name, and nothing where those are missing."""

import copy
import time
from types import SimpleNamespace

import pytest

from benchkit import cells, harness, trace
from test_bench_faults import (altered_frame, half_batch_sds, patched,
                               state_unchanged_sds, torch_equal)
from tiny import tiny_cell

SEED = 20260417


@pytest.fixture(autouse=True)
def f32_group_norm():
    from dreamfusion_torch.guidance.sd import layers

    with patched(layers, "GN_DTYPE", "f32"):
        yield


def tiny_sdxl() -> cells.Cell:
    """dvgo_sdxl.edit_sds_1024 with tiny.py's field and trainer sizes and
    SDXL's structure at CPU widths: three levels, level 0 without
    attention, stacks 0 / 1 / 2 deep, 8-wide heads, a 32-wide context and
    pooled embedding, 8-wide time ids; latents 8^2."""
    from runners.sdxl import _sd_modules

    cell = copy.deepcopy(cells.load_cell("dvgo_sdxl.edit_sds_1024"))
    conf = cell.config
    conf["trainer"].update(fp16=False, h=16, w=16, H=24, W=24, max_steps=64,
                           grid_size=16, grid_K=32, max_ray_batch=192)
    conf["edit_scene"].update(world=24, rgbnet_width=16)
    sd = conf["sd"]
    sd.update(latent_size=8, dtype="float32")
    sd["unet"].update(block_out_channels=[32, 32, 64], layers_per_block=1,
                      attention_head_dim=[4, 4, 8],
                      transformer_layers_per_block=[0, 1, 2],
                      cross_attention_dim=32, addition_time_embed_dim=8,
                      projection_class_embeddings_input_dim=32 + 6 * 8)
    sd["vae"].update(block_out_channels=[32, 32, 32, 32], layers_per_block=1)
    unet, vae = _sd_modules("dfref.sd", sd, "cpu")
    sd["unet"]["n_params"] = sum(p.numel() for p in unet.parameters())
    sd["vae"]["n_params"] = sum(p.numel() for p in vae.parameters())
    cell.mix.update(warmup_steps=4)
    return cell


def run(cell):
    return harness.run(cell.name, SEED, 0.5, False, time.perf_counter(),
                       device="cpu", cell=cell)


def test_a_sound_sdxl_run_is_correct():
    res, checks = run(tiny_sdxl())
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"]["sds_steps_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [state_unchanged_sds, half_batch_sds],
                         ids=lambda f: f.__name__)
def test_a_fault_fails_the_sdxl_cell(fault):
    with fault():
        res, checks = run(tiny_sdxl())
    assert not res["correct"], checks


def test_the_sdxl_trainer_holds_the_pooled_embedding():
    from runners import sdxl

    r = sdxl.Run(tiny_sdxl(), 2 ** 40 + 3, device="cpu")
    try:
        tz = r.trainer.text_z
        assert set(tz) == {"context", "pooled"}
        assert tz["context"].shape == (6, 2, 77, 32)
        assert tz["pooled"].shape == (6, 2, 32)
        assert r.trainer.guidance.modules["vae"].scaling_factor == 0.13025
    finally:
        r.release()
        r.close()


def test_the_edit_orbit_renders_the_editing_cells_scene():
    """The orbit's field is the one dvgo_sd15.edit_sds trains: the same
    asset_seed writes the same .dvgo and initialises the same field."""
    from runners import edit_orbit, sds

    states = []
    for mod, name in ((edit_orbit, "dvgo_sd15.edit_orbit"),
                      (sds, "dvgo_sd15.edit_sds")):
        r = mod.Run(tiny_cell(name), 11, device="cpu")
        states.append(r.init_state)
        r.release()
        r.close()
    assert states[0].keys() == states[1].keys()
    assert all(torch_equal(states[0][k], states[1][k]) for k in states[0])


def test_an_altered_frame_fails_the_edit_orbit_cell():
    with altered_frame():
        res, checks = run(tiny_cell("dvgo_sd15.edit_orbit"))
    assert not res["correct"], checks


def test_sdxl_step_flops_at_the_published_widths():
    """13.52 TFLOP of UNet CFG forward at 128^2 latents and 10.31 of VAE
    encoder forward and input gradient at 1024^2."""
    from runners.sdxl import sdxl_step_flops

    sd = cells.load_cell("dvgo_sdxl.edit_sds_1024").config["sd"]
    assert sdxl_step_flops(sd) == pytest.approx(23.83e12, rel=0.01)


def _rec(events, sd, units=2):
    return SimpleNamespace(summary=trace.summarize(events, 1e-3),
                           unit="sds_step", units=units,
                           extra={"sd": sd})


def test_the_sdxl_readers():
    from benchkit.counts import attention_bytes, attention_flops
    from benchkit.device import H100_BF16_FLOPS, least_seconds

    def ev(name, start, end, device, dev_total=0.0):
        return SimpleNamespace(
            name=name,
            device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
            time_range=SimpleNamespace(start=start, end=end),
            device_time_total=dev_total)

    sdxl = cells.load_cell("dvgo_sdxl.edit_sds_1024").config["sd"]
    sd15 = cells.load_cell("dvgo_sd15.edit_sds").config["sd"]
    events = [ev("step/guidance/unet/transformer", 0, 500, False, 300.0),
              ev("step/guidance/unet/transformer", 500, 900, False, 100.0),
              ev("void attn_fwd_narrow<4>(CUtensorMap)", 10, 110, True),
              ev("void attn_fwd_narrow<4>(CUtensorMap)", 600, 700, True)]
    ms = cells.metric_reader("transformer_device_ms.sdxl")
    roof = cells.metric_reader("attn_fwd_roofline.sdxl")
    assert ms(_rec(events, sdxl)) == pytest.approx(0.2)
    # level 1 of SDXL: B 2, N 64^2, 10 heads of 64, over 200 us
    least = least_seconds(attention_flops(2, 10, 4096, 64),
                          attention_bytes(2, 10, 4096, 64), H100_BF16_FLOPS)
    assert roof(_rec(events, sdxl)) == pytest.approx(100 * 2 * least / 2e-4)
    # SD v1.5's configuration, and a trace without the span or the kernel
    assert roof(_rec(events, sd15)) is None
    assert ms(_rec(events[2:], sdxl)) is None
    assert roof(_rec(events[:2], sdxl)) is None
