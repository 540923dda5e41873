"""The CLIP BPE tokenizer and local CLIP checkpoint directories in the
port, against transformers and the JAX package, on the CPU:

- the port's BPE tokenizer (guidance/tokenizer.py) gives exactly the ids of
  transformers.CLIPTokenizer without ftfy, on a synthetic vocab.json and
  merges.txt (chip_smoke.synthetic_bpe); its word split
  equals the ``regex`` pattern's over every assigned code point below
  U+3000 and a CJK sample;
- a local CLIP directory (a random transformers CLIPModel saved in torch
  and in Flax form): text embeddings and one loss 1e-5, and
  clip_r_precision_from_renders equal, with eos_token_id 2 (the legacy
  argmax pooling) and with the vocabulary's own end-of-text id; without
  tokenizer files both packages take the md5 fallback tokenizer;
- repairs: the CLIP towers' eos_token_id / hidden_act / layer_norm_eps
  read from the config (1e-5 against Flax), and Guidance.encode_images.
"""

import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance import clip as jclip
from dreamfusion_tpu.training import metrics as jmetrics

from dreamfusion_torch.config import Config
from dreamfusion_torch.guidance import build_guidance
from dreamfusion_torch.guidance import clip as tclip
from dreamfusion_torch.guidance import tokenizer as ttok
from dreamfusion_torch.training import metrics as tmetrics
from dreamfusion_torch.weights import from_jax_params

from test_torch_sd import _close
from test_torch_sd_dir import CPU, PROMPTS, write_tokenizer


# -- tokenizer -------------------------------------------------------------------

@pytest.mark.parametrize("pad", [None, "!"])
def test_tokenizer_ids_equal_clip_tokenizer(tmp_path, pad):
    """Exact ids, 77 wide, for every prompt of PROMPTS; pad None is SD
    v1.5's <|endoftext|>, "!" SD 2.x's pad token."""
    from transformers import CLIPTokenizer

    write_tokenizer(tmp_path, pad=pad)
    ref = CLIPTokenizer.from_pretrained(str(tmp_path))
    ids = ref(PROMPTS, padding="max_length", max_length=77, truncation=True,
              return_tensors="np").input_ids
    got = ttok.CLIPBPETokenizer.from_dir(str(tmp_path))(PROMPTS)
    assert got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, ids)
    # the long prompt keeps 75 tokens; out-of-vocabulary symbols are unk
    assert got[7, -1] == ref.eos_token_id
    assert (got[3] == ref.unk_token_id).any()


def test_word_split_equals_the_regex_pattern():
    """split_words against the regex module's compiled CLIP pattern, for
    every assigned character below U+3000 and a CJK stride, alone and
    inside letters, digits and an apostrophe."""
    import regex

    pat = regex.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|"
                        r"'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
                        regex.IGNORECASE)
    cps = list(range(0x3000)) + list(range(0x3000, 0x30000, 97))
    bad = []
    for cp in cps:
        ch = chr(cp)
        if 0xD800 <= cp <= 0xDFFF or unicodedata.category(ch).startswith("C"):
            continue          # basic_clean drops these before the split
        for text in (ch, f"a{ch}1", f"{ch}{ch} x", f"'{ch}", f"{ch}'s"):
            if regex.findall(pat, text) != ttok.split_words(text):
                bad.append(hex(cp))
    assert not bad, bad[:20]


# -- a local CLIP directory -------------------------------------------------------

def write_clip_dir(root, eos_mode, tokenizer=True):
    """A random transformers CLIPModel (text 32 wide, vision 32 wide at
    224 px with 32 px patches, projection 16), its torch weights
    (model.safetensors) and its Flax weights (flax_model.msgpack), and the
    tokenizer files, whose special tokens sit at ids 3 and 4 so that the
    legacy argmax pooling picks another position than the end token.
    Without tokenizer files the text vocabulary is CLIP's 49,408 ids (the
    fallback tokenizer's range) and the end token 49407."""
    from transformers import CLIPConfig, CLIPModel, FlaxCLIPModel

    if tokenizer:
        vocab = write_tokenizer(root, specials_first=True)
        n_vocab, eos = len(vocab), vocab["<|endoftext|>"]
    else:
        n_vocab, eos = 49408, 49407
    if eos_mode == "legacy":
        eos = 2
    cfg = CLIPConfig(
        text_config=dict(vocab_size=n_vocab, hidden_size=32,
                         intermediate_size=48, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=77,
                         eos_token_id=eos),
        vision_config=dict(hidden_size=32, intermediate_size=48,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=224, patch_size=32),
        projection_dim=16)
    torch.manual_seed(1)
    model = CLIPModel(cfg)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 2:
                p.normal_(0.0, 0.3)
    model.save_pretrained(root)
    FlaxCLIPModel.from_pretrained(str(root), from_pt=True).save_pretrained(
        str(root))


CLIP_PROMPTS = ["a photo of a red cube", "a corgi wearing a hat",
                "a hamburger on a plate"]


@pytest.mark.parametrize("eos_mode", ["legacy", "vocab"])
def test_clip_dir_matches_the_jax_package(tmp_path, eos_mode):
    """Ids (CLIPTokenizerFast, which the JAX package loads) exactly; text
    embeddings 1e-5; the loss on two 64 x 64 renders 1e-5;
    clip_r_precision_from_renders equal."""
    from transformers import CLIPTokenizerFast

    write_clip_dir(tmp_path, eos_mode)
    jg = jclip.build_clip_guidance(str(tmp_path))
    tg = tclip.build_clip_guidance(str(tmp_path), device=CPU)
    ids = CLIPTokenizerFast.from_pretrained(str(tmp_path))(
        CLIP_PROMPTS, padding="max_length", max_length=77, truncation=True,
        return_tensors="np").input_ids
    np.testing.assert_array_equal(
        ttok.CLIPBPETokenizer.from_dir(str(tmp_path))(CLIP_PROMPTS), ids)
    jz = jg.get_text_embeds(CLIP_PROMPTS, [""] * 3)
    tz = tg.get_text_embeds(CLIP_PROMPTS, [""] * 3)
    _close(tz, jz, 1e-5)
    rgb = np.random.default_rng(2).uniform(
        size=(3, 64, 64, 3)).astype(np.float32)
    jloss = jg.loss(jg.params, jz, jnp.asarray(rgb), jax.random.PRNGKey(0))
    _close(tg.loss(tz, torch.from_numpy(rgb)), jloss, 1e-5)
    r_j = jmetrics.clip_r_precision_from_renders(jg, rgb, CLIP_PROMPTS,
                                                 [0, 1, 2])
    r_t = tmetrics.clip_r_precision_from_renders(tg, rgb, CLIP_PROMPTS,
                                                 [0, 1, 2])
    assert r_t == r_j


def test_clip_dir_without_tokenizer_uses_the_fallback(tmp_path):
    """No vocab.json / merges.txt: both packages tokenize by the md5
    fallback; text embeddings 1e-5."""
    write_clip_dir(tmp_path, "vocab", tokenizer=False)
    jg = jclip.build_clip_guidance(str(tmp_path))
    tg = tclip.build_clip_guidance(str(tmp_path), device=CPU)
    _close(tg.get_text_embeds(CLIP_PROMPTS, [""] * 3),
           jg.get_text_embeds(CLIP_PROMPTS, [""] * 3), 1e-5)


# -- the repairs of the CLIP towers and the guidance -------------------------

# token ids without 49407: the legacy argmax, the config's own end token
# and a pooling fixed at 49407 (which then takes position 0) pick three
# different positions
CONFIG_IDS = np.full((2, 77), 3, np.int32)
CONFIG_IDS[:, :5] = [[5, 10, 49000, 7, 3], [5, 7, 20, 48000, 3]]


@pytest.mark.parametrize("variant", ["legacy_eos", "own_eos", "gelu",
                                     "ln_eps"])
def test_clip_towers_read_their_config(variant):
    """Pooling by eos_token_id 2 (argmax) or by the config's own end token
    (7), hidden_act gelu and layer_norm_eps 1e-3: the port's towers follow
    the config as Flax does (text and image features 1e-5)."""
    from transformers import CLIPConfig, FlaxCLIPModel

    text = dict(jclip._TINY_TEXT)
    vision = dict(jclip._TINY_VISION)
    if variant == "legacy_eos":
        text["eos_token_id"] = 2
    elif variant == "own_eos":
        text["eos_token_id"] = 7
    elif variant == "gelu":
        text["hidden_act"] = vision["hidden_act"] = "gelu"
    else:
        text["layer_norm_eps"] = vision["layer_norm_eps"] = 1e-3
    fm = FlaxCLIPModel(CLIPConfig(text_config=text, vision_config=vision,
                                  projection_dim=16), seed=0)
    params = jax.tree.map(np.asarray, fm.params)
    model = tclip.CLIPModel(text, vision, 16)
    model.load_state_dict(from_jax_params(params))
    ref = fm.get_text_features(CONFIG_IDS, params=fm.params)
    with torch.no_grad():
        got = model.get_text_features(torch.from_numpy(CONFIG_IDS).long())
    _close(got, ref, 1e-5)
    px = np.random.default_rng(0).normal(size=(2, 3, 224, 224)).astype(
        np.float32)
    with torch.no_grad():
        _close(model.get_image_features(torch.from_numpy(px)),
               fm.get_image_features(px, params=fm.params), 1e-5)


def test_clip_guidance_exposes_encode_images():
    """Guidance.encode_images: the unit image features the JAX package's
    encode_images gives (1e-5), from the same weights."""
    jg = jclip.build_clip_guidance("random-tiny")
    model = tclip.tiny_clip()
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jg.params)))
    tg = tclip.clip_guidance(model.eval())
    rgb = np.random.default_rng(4).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = tg.encode_images(torch.from_numpy(rgb))
    _close(got, jg.encode_images(jg.params, jnp.asarray(rgb)), 1e-5)
    assert build_guidance(Config(text="x", guidance="none"),
                          CPU).encode_images is None
