"""The cells at a size a CPU test run holds: the same configurations,
mixes and limits with smaller widths and frames, SD and the field in
float32 (the program's GroupNorm too), so that a sound run reads the
reference to rounding and a planted fault shows alone."""

import copy

from benchkit import cells
from benchkit.counts import sd_unet_kwargs, sd_vae_kwargs


def _tiny_sd(sd):
    from dfref.sd.unet import UNet2DCondition
    from dfref.sd.vae import AutoencoderKL

    sd.update(latent_size=8, dtype="float32")
    sd["unet"].update(block_out_channels=[32, 64, 64, 64], layers_per_block=1,
                      attention_head_dim=2, cross_attention_dim=32)
    sd["vae"].update(block_out_channels=[32, 32, 32, 32], layers_per_block=1)
    sd["unet"]["n_params"] = sum(p.numel() for p in UNet2DCondition(
        **sd_unet_kwargs(sd["unet"])).parameters())
    sd["vae"]["n_params"] = sum(p.numel() for p in AutoencoderKL(
        **sd_vae_kwargs(sd["vae"])).parameters())


def tiny_cell(name: str) -> cells.Cell:
    cell = copy.deepcopy(cells.load_cell(name))
    conf, mix = cell.config, cell.mix
    if "trainer" in conf:
        conf["trainer"].update(fp16=False, h=16, w=16, H=24, W=24,
                               max_steps=64, grid_size=16, grid_K=32,
                               max_ray_batch=192)
    if "sd" in conf:
        _tiny_sd(conf["sd"])
    if "edit_scene" in conf:
        conf["edit_scene"].update(world=24, rgbnet_width=16)
    if "fine_model" in conf:
        conf["fine_model"].update(num_voxels=24 ** 3, rgbnet_width=16)
        conf["fine_train"].update(batch_size=256)
        conf["scene"].update(size=40, views=10)
    mix.update({k: 8 for k in ("feed_batches",) if k in mix})
    mix.update({k: 4 for k in ("orbit",) if k in mix})
    mix.update({k: 4 for k in ("warmup_steps",) if k in mix})
    return cell
