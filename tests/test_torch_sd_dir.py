"""Local SD checkpoint directories in the port, against the JAX package,
on the CPU:

- the probe (guidance/sd/probe.py): the cases of
  tests/test_sd_real_weights.py:22-34, as the JAX package's probe;
- a tiny SD directory (UNet and VAE under diffusers names, a transformers
  CLIPTextModel, the synthetic BPE tokenizer files): the port's
  load_sd_dir against the JAX package's load_sd_params: ids exactly, text
  embeddings rtol 1e-5, one sds_loss with the JAX draws injected to 1e-4
  (its gradient to 1e-4 or 3x JAX's own one-ulp move, see the test);
- the text encoder's loader raises on a missing, extra or mis-shaped
  tensor;
- repair: build_guidance's dispatch (the probe first, None builds
  random-tiny), as the JAX package's.

The tokenizer files come from chip_smoke.synthetic_bpe (a greedy BPE on a
small corpus); tests/test_torch_clip_dir.py writes them through
write_tokenizer here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance.sd import convert as jconvert
from dreamfusion_tpu.guidance.sd import probe as jprobe
from dreamfusion_tpu.guidance.sd import scheduler as jsched
from dreamfusion_tpu.guidance.sd import sds as jsds
from dreamfusion_tpu.guidance.sd import unet as junet
from dreamfusion_tpu.guidance.sd import vae as jvae

from dreamfusion_torch.config import Config
from dreamfusion_torch.guidance import build_guidance
from dreamfusion_torch.guidance import clip as tclip
from dreamfusion_torch.guidance.sd import convert as tconvert
from dreamfusion_torch.guidance.sd import probe as tprobe
from dreamfusion_torch.guidance.sd import sds as tsds
from dreamfusion_torch.guidance.sd import unet as tunet
from dreamfusion_torch.guidance.sd import vae as tvae

from chip_smoke import synthetic_bpe
from test_torch_convert import _seeded_dict, _write_safetensors
from test_torch_sd import _close, _t, f32_groupnorm  # noqa: F401

CPU = torch.device("cpu")
CORPUS = ("a photo of a red cube on the table, it's the dog's toy. a DSLR "
          "photo of a corgi wearing a hat 42 times; a hamburger on a plate "
          "café naïve über 猫 ") * 3
PROMPTS = [
    "a photo of a red cube",
    "A DSLR photo, of a CORGI!! wearing a hat...",
    "it's the dog's toy; 1234 times 3.5",
    "café naïve über Zoë",                      # accents, one out of vocab
    "猫cat 猫 a猫b",                             # CJK beside letters
    "",
    "  \t tabs\nand  newlines ",
    "word " * 80,                               # longer than 75 tokens
    "<|endoftext|> inside <|startoftext|>text",
    "it'S I'LL we'RE",
    "emoji 🙂 and ½ ² Ⅻ",
    "\x00nul\x07bell​zero a-b_c/d\\e",
]


def write_tokenizer(path, pad=None, **kw):
    """chip_smoke.synthetic_bpe's vocabulary on CORPUS (two symbols left
    out, so that they map to the unknown token) as tokenizer files."""
    kw.setdefault("drop", ("é</w>", "ë"))
    os.makedirs(path, exist_ok=True)
    vocab, merges = synthetic_bpe(kw.pop("corpus", CORPUS), **kw)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("\n".join(merges) + "\n")
    if pad is not None:
        with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
            json.dump({"pad_token": pad}, f)
    return vocab


# -- probe ---------------------------------------------------------------------

def test_probe_cases_match_the_jax_package(tmp_path, monkeypatch):
    """tests/test_sd_real_weights.py:22-34 for the port's probe, and the
    same answer as the JAX package's probe in each case."""
    real = jprobe.find_sd_weights(verbose=False)
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("SD_WEIGHTS_DIR", str(empty))
    assert tprobe.find_sd_weights(verbose=False) in (None, real)
    assert tprobe.find_sd_weights(False) == jprobe.find_sd_weights(False)
    sd = tmp_path / "sd"
    for sub in ("unet", "vae"):
        (sd / sub).mkdir(parents=True)
        (sd / sub / "diffusion_pytorch_model.bin").write_bytes(b"x")
    monkeypatch.setenv("SD_WEIGHTS_DIR", str(sd))
    assert tprobe.find_sd_weights(verbose=False) == str(sd)
    assert jprobe.find_sd_weights(verbose=False) == str(sd)


# -- a tiny SD directory ---------------------------------------------------------

def write_sd_dir(root, text_hidden=32, seed=0):
    """unet/ (safetensors) and vae/ (.bin) at the tiny widths under
    diffusers names, text_encoder/ (a random transformers CLIPTextModel,
    save_pretrained) and tokenizer/ (the synthetic BPE files)."""
    from transformers import CLIPTextConfig, CLIPTextModel

    os.makedirs(root / "unet")
    os.makedirs(root / "vae")
    unet_sd = _seeded_dict(tunet.tiny_unet(), seed)
    _write_safetensors(root / "unet" / "diffusion_pytorch_model.safetensors",
                       {k: ("F32", v) for k, v in unet_sd.items()})
    vae_sd = _seeded_dict(tvae.tiny_vae(), seed + 1)
    torch.save({k: torch.from_numpy(v) for k, v in vae_sd.items()},
               root / "vae" / "diffusion_pytorch_model.bin")
    vocab = write_tokenizer(root / "tokenizer")
    torch.manual_seed(seed)
    cfg = CLIPTextConfig(vocab_size=len(vocab), hidden_size=text_hidden,
                         intermediate_size=48, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=77,
                         bos_token_id=vocab["<|startoftext|>"],
                         eos_token_id=vocab["<|endoftext|>"],
                         pad_token_id=vocab["<|endoftext|>"])
    model = CLIPTextModel(cfg)
    with torch.no_grad():          # larger than the 0.02 init, so that the
        for p in model.parameters():   # layers' outputs are not ~constant
            if p.ndim == 2:
                p.normal_(0.0, 0.3)
    model.save_pretrained(root / "text_encoder")
    return unet_sd, vae_sd


@pytest.fixture(scope="module")
def sd_dir_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd15")
    write_sd_dir(root)
    ju, jv = junet.tiny_unet(), jvae.tiny_vae()
    jparams, jencode = jconvert.load_sd_params(str(root), ju, jv)
    unet, vae, text_model, tencode = tconvert.load_sd_dir(
        str(root), tunet.tiny_unet().eval(), tvae.tiny_vae().eval(),
        device=CPU)
    for m in (unet, vae):
        m.requires_grad_(False)
    return root, (ju, jv, jparams, jencode), (unet, vae, text_model, tencode)


SD_PROMPTS = ["a DSLR photo of a corgi", "it's a hamburger, 42 times!", ""]


def test_sd_dir_ids_and_text_embeddings_match(sd_dir_pair):
    """Ids exactly (CLIPTokenizer of tokenizer/), the [n, 77, 32] last
    hidden states rtol 1e-5 of their largest entry."""
    from transformers import CLIPTokenizer

    root, (_, _, _, jencode), (_, _, text_model, tencode) = sd_dir_pair
    ref_ids = CLIPTokenizer.from_pretrained(str(root / "tokenizer"))(
        SD_PROMPTS, padding="max_length", max_length=77, truncation=True,
        return_tensors="np").input_ids
    np.testing.assert_array_equal(tencode.tokenizer(SD_PROMPTS), ref_ids)
    got = tencode(SD_PROMPTS)
    assert got.shape == (3, 77, 32) and got.dtype == torch.float32
    assert not any(p.requires_grad for p in text_model.parameters())
    _close(got, jencode(SD_PROMPTS), 1e-5)


def test_sd_dir_tensors_and_sds_loss_match(sd_dir_pair, f32_groupnorm):
    """Every UNet and VAE tensor equals the file's; the guidance's text
    embeddings 1e-5; one sds_loss on the loaded UNet and VAE with the JAX
    package's embeddings and draws: the value to 1e-4, d loss / d pred_rgb
    to 1e-4 of its largest entry or 3x the JAX gradient's own move when
    pred_rgb moves by one ulp (CFG at scale 100 multiplies the two UNets'
    rounding by 100: 1.6e-3 of 15.6 against a control of 1.4e-3)."""
    root, (ju, jv, jparams, jencode), (unet, vae, _, tencode) = sd_dir_pair
    for m, name in ((unet, "unet"), (vae, "vae")):
        src = tconvert.load_module_dir(str(root / name))
        conv = tconvert.convert_state_dict(src, m.state_dict())
        for k, v in m.state_dict().items():
            assert torch.equal(v, torch.from_numpy(np.array(conv[k]))), k
    rng = np.random.default_rng(3)
    pred = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    jz = jnp.stack([jencode([""]), jencode(["a DSLR photo of a corgi"])], 1)
    g = tsds.sd_guidance(unet, vae, 8, text_encode=tencode)
    _close(g.get_text_embeds(["a DSLR photo of a corgi"], [""]), jz, 1e-5)
    key = jax.random.PRNGKey(9)
    k_enc, k_t, k_noise = jax.random.split(key, 3)
    draws = {"vae_eps": _t(jax.random.normal(k_enc, (1, 8, 8, 4))),
             "t": _t(jax.random.randint(k_t, (1,), 20, 981)),
             "noise": _t(jax.random.normal(k_noise, (1, 8, 8, 4)))}
    js = jsched.make_schedule()
    vg = jax.value_and_grad(lambda p: jsds.sds_loss(
        ju, jv, js, jparams, jz, p, key, latent_size=8))
    ref, gref = vg(jnp.asarray(pred))
    _, gctl = vg(jnp.asarray(np.nextafter(pred, np.float32(2))))
    pt = _t(pred).requires_grad_(True)
    loss = g.loss(_t(jz), pt, draws=draws)
    loss.backward()
    _close(loss, ref)
    gref, gctl = np.asarray(gref), np.asarray(gctl)
    tol = max(1e-4 * np.abs(gref).max(), 3 * np.abs(gctl - gref).max())
    np.testing.assert_allclose(pt.grad.numpy(), gref, atol=tol)


def test_sd_dir_loader_raises_on_a_bad_text_encoder(tmp_path):
    """A text-encoder tensor missing or mis-shaped raises, naming it."""
    from dreamfusion_torch.weights import from_hf_clip

    model = tclip.CLIPTextTransformer(dict(
        vocab_size=40, hidden_size=8, intermediate_size=16,
        num_hidden_layers=1, num_attention_heads=2,
        max_position_embeddings=77))
    hf = {f"text_model.{k.replace('_embedding.embedding', '_embedding.weight')}":
          v.numpy() for k, v in model.state_dict().items()}
    hf["text_model.embeddings.position_ids"] = np.arange(77)[None]
    assert set(from_hf_clip(hf, model.state_dict(), "text_model.")) == \
        set(model.state_dict())
    bad = dict(hf)
    bad.pop("text_model.final_layer_norm.bias")
    with pytest.raises(ValueError, match="missing.*final_layer_norm.bias"):
        from_hf_clip(bad, model.state_dict(), "text_model.")
    bad = dict(hf, **{"text_model.encoder.layers.0.mlp.fc1.bias":
                      np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape mismatches.*fc1.bias"):
        from_hf_clip(bad, model.state_dict(), "text_model.")
    bad = dict(hf, **{"text_model.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="match no parameter.*extra"):
        from_hf_clip(bad, model.state_dict(), "text_model.")


# -- the repairs -----------------------------------------------------------------

@pytest.mark.parametrize("sd_weights,probe_hit,expect", [
    (None, False, None), ("random-full", False, "random-full"),
    (None, True, "dir"), ("random-full", True, "dir"),
    ("random-tiny", True, "random-tiny")])
def test_build_guidance_probes_like_the_jax_package(
        tmp_path, monkeypatch, sd_weights, probe_hit, expect):
    """None and random-full probe first and load a found directory; else
    None builds random-tiny, random-full random-full; random-tiny never
    probes (the JAX package's guidance/__init__.py:50-66)."""
    from dreamfusion_torch.guidance.sd import sds as sds_mod

    sd = tmp_path / "sd"
    for sub in ("unet", "vae"):
        (sd / sub).mkdir(parents=True)
        (sd / sub / "diffusion_pytorch_model.bin").write_bytes(b"x")
    if probe_hit:
        monkeypatch.setenv("SD_WEIGHTS_DIR", str(sd))
    else:
        monkeypatch.setenv("SD_WEIGHTS_DIR", str(tmp_path / "missing"))
        monkeypatch.setattr(tprobe, "_CANDIDATE_GLOBS", ())
    seen = []
    monkeypatch.setattr(sds_mod, "build_sd_guidance",
                        lambda w, **kw: seen.append(w) or "built")
    cfg = Config(text="x", guidance="stable-diffusion", sd_weights=sd_weights)
    assert build_guidance(cfg, CPU) == "built"
    assert seen == [str(sd) if expect == "dir" else expect]


def test_build_guidance_default_is_random_tiny(monkeypatch, tmp_path):
    """With no directory found, sd_weights None builds the tiny UNet (its
    first block 32 wide), not the SD v1.5-sized one (320)."""
    monkeypatch.setenv("SD_WEIGHTS_DIR", str(tmp_path / "missing"))
    monkeypatch.setattr(tprobe, "_CANDIDATE_GLOBS", ())
    g = build_guidance(Config(text="x", guidance="stable-diffusion"), CPU,
                       torch.Generator().manual_seed(0))
    assert g.modules["unet"].conv_in.weight.shape[0] == 32
    assert g.modules["latent_size"] == 8




def test_diffusers_names_and_safetensors_writer(tmp_path):
    """diffusers_names gives the SD v1.5 diffusers inventory exactly (the
    names of tests/test_sd_layout_parity.py); write_safetensors writes a
    file the safetensors package and the port's reader read back
    exactly."""
    from safetensors.numpy import load_file

    from test_sd_layout_parity import (sd15_unet_state_dict_shapes,
                                       sd15_vae_state_dict_shapes)

    with torch.device("meta"):
        u, v = tunet.sd15_unet(), tvae.sd15_vae()
    for m, ref in ((u, sd15_unet_state_dict_shapes()),
                   (v, sd15_vae_state_dict_shapes())):
        names = tconvert.diffusers_names(m.state_dict())
        assert set(names) == set(ref)
        assert all(tuple(t.shape) == tuple(ref[k]) for k, t in names.items())
    rng = np.random.default_rng(0)
    tensors = {"a.weight": rng.normal(size=(3, 4)).astype(np.float16),
               "b": rng.normal(size=5).astype(np.float32),
               "c": np.arange(4, dtype=np.int64)}
    path = str(tmp_path / "x.safetensors")
    tconvert.write_safetensors(path, tensors)
    for got in (load_file(path), tconvert.read_safetensors(path)):
        assert set(got) == set(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype
            np.testing.assert_array_equal(got[k], t)
