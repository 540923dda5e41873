"""SDXL base 1.0 as SDS guidance in the port, on the CPU: the UNet and the
SDS loss against the plain reference benchmark/dfref/sd/sdxl.py (loaded by
path; it imports nothing of the port) at a tiny SDXL geometry in float32,
two Trainer.advance steps with ``--sd_weights random-xl-tiny`` on the DVGO
editing field, the published parameter counts on the ``meta`` device, and
SD v1.5's modules as they were.

The tiny geometry is SDXL's structure at small widths (unet.tiny_xl_unet):
three levels, level 0 without attention, stacks 0 / 1 / 2 deep, 8-wide
heads, linear projections, the text-time embedding, a 32-wide context and
pooled embedding."""

import importlib
import importlib.util
import os
import sys

import pytest
import torch

from dreamfusion_torch.config import parse_config
from dreamfusion_torch.guidance.sd import layers as tlayers
from dreamfusion_torch.guidance.sd import sds as tsds
from dreamfusion_torch.guidance.sd import unet as tunet
from dreamfusion_torch.guidance.sd import vae as tvae
from dreamfusion_torch.guidance.sd.convert import diffusers_names
from dreamfusion_torch.guidance.sd.scheduler import make_schedule
from dreamfusion_torch.training import trainer as ttrainer

from test_sd_layout_parity import sd15_unet_state_dict_shapes
from test_torch_edit import _write_dvgo

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)       # dfref's own imports


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(BENCH, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("dfref_sd_sdxl", "dfref/sd/sdxl.py")
# the modules the reference's own imports loaded
ref_layers, ref_vae, ref_sched = (importlib.import_module(f"dfref.sd.{m}")
                                  for m in ("layers", "vae", "scheduler"))

CPU = torch.device("cpu")
SDXL_UNET_PARAMS = 2_567_463_684     # diffusers' count for unet/config.json
SD_VAE_PARAMS = 83_653_863
TINY = dict(block_out_channels=(32, 32, 64), layers_per_block=1,
            attention_heads=(4, 4, 8), cross_attention_dim=32,
            transformer_layers_per_block=(0, 1, 2), addition_time_embed_dim=8,
            pooled_dim=32)
# Both sides run the same float32 operations in the same order on the same
# weights; the tolerance leaves room only for a CPU kernel that sums in
# another order (seen: exact equality).
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def f32_groupnorm(monkeypatch):
    monkeypatch.setattr(tlayers, "GN_DTYPE", "f32")
    monkeypatch.setattr(ref_layers, "GN_DTYPE", "f32")


def _seeded(module, seed):
    """Every weight N(0, 1/fan_in) and every bias and norm parameter
    N(0, 0.1) from the seed, so that the text-time path and the norms'
    affine parts all carry signal."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            fan = p[0].numel() if p.ndim > 1 else 1
            scale = fan ** -0.5 if p.ndim > 1 else 0.1
            p.copy_(torch.randn(p.shape, generator=g) * scale
                    + (1.0 if name.endswith("norm.weight") else 0.0))
    return module


def _unet_pair(seed):
    port = _seeded(tunet.tiny_xl_unet(), seed).eval()
    plain = ref.UNet2DConditionXL(**TINY).eval()
    plain.load_state_dict(port.state_dict(), strict=True)
    return port, plain


@pytest.mark.parametrize("seed,size", [(0, 64), (1, 1024), (2, 512)])
def test_tiny_unet_matches_the_reference(f32_groupnorm, seed, size):
    port, plain = _unet_pair(seed)
    g = torch.Generator().manual_seed(100 + seed)
    x = torch.randn(2, 8, 8, 4, generator=g)
    t = torch.tensor([20, 977])
    ctx = torch.randn(2, 77, 32, generator=g)
    pooled = torch.randn(2, 32, generator=g)
    ids = ref.sdxl_time_ids(size, 2)
    with torch.no_grad():
        a = port(x, t, ctx, text_embeds=pooled, time_ids=ids)
        b = plain(x, t, ctx, pooled, ids)
        # the pooled embedding and the time ids reach the output
        c = port(x, t, ctx, text_embeds=pooled + 1.0, time_ids=ids)
    torch.testing.assert_close(a, b, **TOL)
    assert (a - c).abs().max() > 1e-3


def test_tiny_unet_builds_the_same_modules_in_the_same_order():
    """A seeded fill in module order (the benchmark's fill_lecun) gives
    both sides the same weights."""
    port, plain = tunet.tiny_xl_unet(), ref.UNet2DConditionXL(**TINY)
    kinds = (torch.nn.Linear, torch.nn.Conv2d)
    shapes = [[tuple(m.weight.shape) for m in u.modules()
               if isinstance(m, kinds)] for u in (port, plain)]
    assert shapes[0] == shapes[1]
    assert [k for k in port.state_dict()] == [k for k in plain.state_dict()]


def test_published_widths_count_diffusers_parameters():
    with torch.device("meta"):
        port, plain = tunet.sdxl_unet(), ref.UNet2DConditionXL()
        vae = tvae.sdxl_vae()
    for u in (port, plain):
        assert sum(p.numel() for p in u.parameters()) == SDXL_UNET_PARAMS
    assert sum(p.numel() for p in vae.parameters()) == SD_VAE_PARAMS
    assert vae.scaling_factor == ref.LATENT_SCALE == 0.13025
    n_blocks = sum(1 for m in port.modules()
                   if isinstance(m, tunet.BasicTransformerBlock))
    assert n_blocks == 70


def test_sd15_modules_are_unchanged():
    """SD v1.5 keeps its diffusers inventory (every key and shape), 1x1
    convolutions in and out of one-block stacks, no text-time embedding,
    and the VAE's latent scale 0.18215."""
    with torch.device("meta"):
        u, v = tunet.sd15_unet(), tvae.sd15_vae()
    names = diffusers_names(u.state_dict())
    ref_shapes = sd15_unet_state_dict_shapes()
    assert set(names) == set(ref_shapes)
    assert all(tuple(t.shape) == tuple(ref_shapes[k])
               for k, t in names.items())
    assert u.addition_time_embed_dim == 0
    assert not hasattr(u, "add_embedding")
    stacks = [m for m in u.modules() if isinstance(m, tunet.Transformer2D)]
    assert len(stacks) == 16
    assert all(s.depth == 1 and not s.linear
               and isinstance(s.proj_in, tunet.Conv2d) for s in stacks)
    assert v.scaling_factor == 0.18215


@pytest.mark.parametrize("seed", [0, 1])
def test_sds_loss_matches_the_reference(f32_groupnorm, seed):
    """The port's sds_loss with SDXL's dict of context and pooled embedding
    (time ids of the 8 x latent image by default) against the reference's,
    value and gradient into the render."""
    port, plain = _unet_pair(seed)
    tv = _seeded(tvae.tiny_vae(ref.LATENT_SCALE), 10 + seed).eval()
    rv = ref_vae.AutoencoderKL(block_out_channels=(32, 32, 64, 64),
                               layers_per_block=1).eval()
    rv.load_state_dict(tv.state_dict(), strict=True)
    for m in (port, plain, tv, rv):
        m.requires_grad_(False)
    g = torch.Generator().manual_seed(200 + seed)
    B, L = 2, 8
    ctx = torch.randn(B, 2, 77, 32, generator=g)
    pooled = torch.randn(B, 2, 32, generator=g)
    draws = {"vae_eps": torch.randn(B, L, L, 4, generator=g),
             "t": torch.tensor([25, 900]),
             "noise": torch.randn(B, L, L, 4, generator=g)}
    rgb = torch.rand(B, 16, 16, 3, generator=g)
    outs = []
    for fn in (
            lambda x: tsds.sds_loss(port, tv, make_schedule(device=CPU),
                                    {"context": ctx, "pooled": pooled}, x,
                                    guidance_scale=100.0, latent_size=L,
                                    draws=dict(draws)),
            lambda x: ref.sds_loss(plain, rv, ref_sched.make_schedule(), ctx,
                                   pooled, x, draws, guidance_scale=100.0,
                                   latent_size=L)):
        x = rgb.clone().requires_grad_(True)
        loss = fn(x)
        loss.backward()
        outs.append((loss.detach(), x.grad))
    torch.testing.assert_close(outs[0][0], outs[1][0], **TOL)
    torch.testing.assert_close(outs[0][1], outs[1][1], **TOL)
    assert outs[0][1].abs().max() > 0


def test_random_xl_tiny_guidance_carries_the_pooled_embedding():
    guid = tsds.build_sd_guidance("random-xl-tiny", device=CPU,
                                  generator=torch.Generator().manual_seed(0))
    z = guid.get_text_embeds(["a cat, front view", "b"], ["", "ugly"])
    assert set(z) == {"context", "pooled"}
    assert z["context"].shape == (2, 2, 77, 32)
    assert z["pooled"].shape == (2, 2, 32)
    again = guid.get_text_embeds(["a cat, front view"], [""])
    assert torch.equal(again["pooled"][0], z["pooled"][0])
    # the context is drawn as SD v1.5's stand-in is, the pooled next
    assert torch.equal(z["context"][0, 1],
                       tsds.pseudo_text_embeds(["a cat, front view"], 32,
                                               CPU)[0])
    assert guid.modules["vae"].scaling_factor == 0.13025
    with pytest.raises(NotImplementedError, match="random-xl"):
        tsds.build_sd_guidance("no-such-weights", device=CPU)


def test_two_edit_steps_with_random_xl_tiny(tmp_path):
    """Trainer.advance on the DVGO editing field with SDXL's tiny
    guidance: the per-direction text_z carries the pooled embedding, the
    SDS term reaches the colour MLP, the grids stay frozen."""
    path = str(tmp_path / "scene.dvgo")
    _write_dvgo(path)
    cfg = parse_config(["-O", "--backbone", "dvgo", "--pretrained_dvgo", path,
                        "--text", "a cube", "--sd_weights", "random-xl-tiny"])
    cfg = cfg.replace(h=8, w=8, grid_size=8, max_steps=32, iters=2,
                      albedo_iters=10, bg_radius=0.0, device="cpu",
                      workspace=str(tmp_path / "ws"))
    tr = ttrainer.Trainer("e", cfg, use_checkpoint="scratch")
    assert set(tr.text_z) == {"context", "pooled"}
    assert tr.text_z["context"].shape == (6, 2, 77, 32)
    assert tr.text_z["pooled"].shape == (6, 2, 32)
    before = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    last = None
    for _ in range(2):
        last = tr.advance(last)
        assert torch.isfinite(last["loss"]) and last["loss_guidance"] != 0
    after = tr.model.state_dict()
    assert torch.equal(after["main.density"], before["main.density"])
    assert torch.equal(after["main.k0"], before["main.k0"])
    moved = [k for k in after if k.startswith("main.rgbnet")
             and not torch.equal(after[k], before[k])]
    assert moved and tr.step == 2
