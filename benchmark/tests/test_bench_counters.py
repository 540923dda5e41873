"""The work counters against hand counts."""

import pytest

from benchkit import counts

SD15 = {"unet": {"in_channels": 4, "out_channels": 4,
                 "block_out_channels": [320, 640, 1280, 1280],
                 "layers_per_block": 2, "attention_head_dim": 8,
                 "cross_attention_dim": 768},
        "vae": {"block_out_channels": [128, 256, 512, 512],
                "layers_per_block": 2, "latent_channels": 4},
        "latent_size": 64}


def test_sd15_flops_match_the_hand_counts():
    # torch.utils.flop_counter over SD v1.5's UNet and VAE on `meta`:
    # 1.607 TFLOP for the UNet's CFG forward at B=2 (64^2 latents), 1.117
    # for the VAE encoder's forward at 512^2, 2.268 with its input
    # gradient; held to 0.1% (the counts are exact for the shapes; the
    # tolerance covers the hand counts' rounding to 4 digits)
    unet, enc, enc_grad = counts.sd_flops(SD15)
    assert unet == pytest.approx(1.607e12, rel=1e-3)
    assert enc == pytest.approx(1.117e12, rel=1e-3)
    assert enc_grad == pytest.approx(2.268e12, rel=1e-3)
    assert counts.sd_step_flops(SD15) == pytest.approx(3.875e12, rel=1e-3)


def test_attention_counts():
    # the UNet's 64^2 self-attention under CFG: B=2, H=8, N=4,096, D=40
    assert counts.attention_flops(2, 8, 4096, 40) == 4 * 2 * 8 * 4096 ** 2 * 40
    assert counts.attention_bytes(2, 8, 4096, 40) == 4 * 2 * 8 * 4096 * 40 * 2


def test_dvgo_step_work_by_hand():
    # one ray, 10 samples inside, 4 alive; 2 voxels, k0 3, a 5 -> 4 -> 4
    # -> 3 MLP (depth 3: one 4 x 4 residual layer)
    flops, nbytes = counts.dvgo_step_work(
        n_rays=1, n_inside=10, n_alive=4, n_voxels=2, k0_dim=3, rgb_in=5,
        width=4, depth=3)
    mlp = 5 * 4 + 4 * 4 + 4 * 3
    assert flops == 3 * 2 * mlp * 4 + 3 * 2 * 8 * (10 + 4 * 3)
    params = 2 * 4 + mlp + 4 * 2 + 3
    assert nbytes == 2 * 3 * 4 * params + 12 * 4
