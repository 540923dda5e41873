"""Loading diffusers-layout SD weights into the port (guidance/sd/convert.py),
on the CPU:

- the SD v1.5 diffusers inventory of tests/test_sd_layout_parity.py (every
  key and shape, generated there from the published architecture) maps 1:1
  onto the port's sd15_unet() / sd15_vae(), built on the meta device: no
  missing key, no unmatched key, equal shapes, and the published totals;
- a tiny UNet and VAE loaded from one seeded diffusers-layout dict, through
  JAX's convert_state_dict and through the port's loader, give the same
  output (rtol 1e-4 of the reference's largest entry, f32 GroupNorm); the
  VAE's dict uses the old attention names (query / key / value /
  proj_attn, 1x1 convolutions);
- a .safetensors file written by hand reads back exactly, and a .bin too;
- missing, unmatched and mis-shaped tensors raise, naming them.
"""

import json
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance.sd import convert as jconvert
from dreamfusion_tpu.guidance.sd import unet as junet
from dreamfusion_tpu.guidance.sd import vae as jvae

from dreamfusion_torch.guidance.sd import convert as tconvert
from dreamfusion_torch.guidance.sd import unet as tunet
from dreamfusion_torch.guidance.sd import vae as tvae

from test_sd_layout_parity import (sd15_unet_state_dict_shapes,
                                   sd15_vae_state_dict_shapes)
from test_torch_mesh import one_torch_thread  # noqa: F401
from test_torch_sd import _close, _t, f32_groupnorm  # noqa: F401


def _zeros(shapes):
    """name -> a read-only zero array of the shape, holding no memory."""
    return {k: np.broadcast_to(np.float32(0), s) for k, s in shapes.items()}


@pytest.mark.parametrize("which,total", [("unet", 859_520_964),
                                         ("vae", 83_653_863)])
def test_sd15_inventory_maps_one_to_one(which, total):
    shapes = (sd15_unet_state_dict_shapes() if which == "unet"
              else sd15_vae_state_dict_shapes())
    assert sum(int(np.prod(s)) for s in shapes.values()) == total
    with torch.device("meta"):
        module = tunet.sd15_unet() if which == "unet" else tvae.sd15_vae()
    template = module.state_dict()
    assert sum(t.numel() for t in template.values()) == total
    conv = tconvert.convert_state_dict(_zeros(shapes), template)
    assert set(conv) == set(template)
    assert len(conv) == len(shapes)
    for k, v in conv.items():
        assert tuple(v.shape) == tuple(template[k].shape), k


def _diffusers_name(port_key: str) -> str:
    """down_blocks_0_resnets_1.conv1.weight -> down_blocks.0.resnets.1.
    conv1.weight (diffusers nests with dots where the port uses _)."""
    name = re.sub(r"_(\d+)_", r".\1.", port_key)
    name = re.sub(r"_(\d+)(?=\.|$)", r".\1", name)
    return name.replace("mid_block_", "mid_block.")


OLD_VAE_ATTN = {"to_q": "query", "to_k": "key", "to_v": "value",
                "to_out.0": "proj_attn"}


def _seeded_dict(module, seed, old_vae_attn=False):
    """A diffusers-layout state dict at the port module's shapes: weights
    ~ N(0, 1/fan_in), norm scales near 1, biases small."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in module.state_dict().items():
        shape = tuple(t.shape)
        if k.endswith("weight") and len(shape) >= 2:
            arr = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith("weight"):
            arr = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            arr = 0.1 * rng.normal(size=shape)
        name = _diffusers_name(k)
        if old_vae_attn and "attentions.0." in name:
            for new, old in OLD_VAE_ATTN.items():
                if f".{new}." in name:
                    name = name.replace(f".{new}.", f".{old}.")
                    if arr.ndim == 2:
                        arr = arr[:, :, None, None]
        out[name] = arr.astype(np.float32)
    return out


def _jax_template(init_fn):
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        jax.eval_shape(init_fn))


def test_tiny_unet_from_diffusers_matches_jax(f32_groupnorm):
    sd = _seeded_dict(tunet.tiny_unet(), 0)
    assert "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0.weight" in sd
    ju = junet.tiny_unet()
    k = jax.random.PRNGKey(0)
    tpl = _jax_template(lambda: ju.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 32))))
    jp, skipped = jconvert.convert_state_dict(sd, tpl)
    assert skipped == []
    tu = tconvert.load_converted(tunet.tiny_unet().eval(), sd)
    rng = np.random.default_rng(1)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ctx = rng.normal(size=(2, 77, 32)).astype(np.float32)
    ref = ju.apply(jp, lat, t, ctx)
    with torch.no_grad():
        got = tu(_t(lat), _t(t).long(), _t(ctx))
    _close(got, ref)


def test_tiny_vae_from_old_diffusers_names_matches_jax(f32_groupnorm):
    sd = _seeded_dict(tvae.tiny_vae(), 2, old_vae_attn=True)
    assert sd["decoder.mid_block.attentions.0.query.weight"].ndim == 4
    jv = jvae.tiny_vae()
    k = jax.random.PRNGKey(0)
    tpl = _jax_template(lambda: jv.init(k, jnp.zeros((1, 64, 64, 3)), k))
    jp, skipped = jconvert.convert_state_dict(sd, tpl)
    assert skipped == []
    tv = tconvert.load_converted(tvae.tiny_vae().eval(), sd)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        _close(tv.decode(_t(z)), jv.apply(jp, jnp.asarray(z),
                                          method=jv.decode))
        mean, logvar = tv.moments(_t(x))
    jmean, jlogvar = jv.apply(jp, jnp.asarray(x), method=jv.moments)
    _close(mean, jmean)
    _close(logvar, jlogvar)


def test_convert_raises_naming_the_keys():
    module = tvae.nano_vae()
    sd = _seeded_dict(module, 4)
    bad = dict(sd)
    bad.pop("decoder.conv_out.bias")
    with pytest.raises(ValueError, match=r"missing.*decoder\.conv_out\.bias"):
        tconvert.convert_state_dict(bad, module.state_dict())
    bad = dict(sd, **{"decoder.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match=r"match no parameter.*decoder\.extra"):
        tconvert.convert_state_dict(bad, module.state_dict())
    bad = dict(sd, **{"quant_conv.bias": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match=r"shape mismatches.*quant_conv\.bias"):
        tconvert.convert_state_dict(bad, module.state_dict())


def _write_safetensors(path, tensors):
    """The safetensors layout by hand: u64 header length, JSON header of
    dtype / shape / data_offsets, then the raw little-endian bytes."""
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, (dtype, arr) in tensors.items():
        raw = arr.tobytes()
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def test_safetensors_reads_back_exactly(tmp_path):
    rng = np.random.default_rng(5)
    f32 = rng.normal(size=(3, 4, 2)).astype("<f4")
    f16 = rng.normal(size=(5,)).astype("<f2")
    bf16_vals = rng.normal(size=(2, 3)).astype(np.float32)
    bf16_bits = (bf16_vals.view(np.uint32) >> 16).astype("<u2")
    i64 = rng.integers(-2 ** 40, 2 ** 40, size=(4,)).astype("<i8")
    d = tmp_path / "vae"
    d.mkdir()
    _write_safetensors(d / "diffusion_pytorch_model.safetensors",
                       {"a.weight": ("F32", f32), "b": ("F16", f16),
                        "c": ("BF16", bf16_bits), "n": ("I64", i64)})
    got = tconvert.load_module_dir(str(d))
    assert set(got) == {"a.weight", "b", "c", "n"}
    np.testing.assert_array_equal(got["a.weight"], f32)
    np.testing.assert_array_equal(got["b"], f16)
    assert got["b"].dtype == np.float16
    np.testing.assert_array_equal(
        got["c"], (bf16_bits.astype(np.uint32) << 16).view(np.float32))
    np.testing.assert_array_equal(got["n"], i64)


def test_bin_reads_back_exactly(tmp_path):
    sd = {"w": torch.randn(3, 2, generator=torch.Generator().manual_seed(0))}
    d = tmp_path / "unet"
    d.mkdir()
    torch.save(sd, d / "diffusion_pytorch_model.bin")
    got = tconvert.load_module_dir(str(d))
    np.testing.assert_array_equal(got["w"], sd["w"].numpy())
    with pytest.raises(FileNotFoundError):
        tconvert.load_module_dir(str(tmp_path))
