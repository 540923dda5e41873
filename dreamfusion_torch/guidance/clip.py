"""CLIP (dreamfields-style) guidance (counterpart of
dreamfusion_tpu/guidance/clip.py; reference nerf/clip.py:18-46).

The loss is -mean(cos(image_features, text_features)) of the rendered frame
resized to 224 and CLIP-normalized; the negative prompt is ignored, as in
the reference (nerf/clip.py:28).

The model is the port's own CLIP in PyTorch, written after transformers'
FlaxCLIPModel (modeling_flax_clip.py), whose parameter names it carries,
so weights.from_jax_params converts a Flax CLIP tree and
weights.from_hf_clip a transformers state dict:
- text tower: token and position embeddings, pre-LN blocks under a causal
  mask, a final LayerNorm, pooling at the end-of-text token, a bias-free
  projection;
- vision tower: a bias-free patch convolution, the class embedding,
  position embeddings, ``pre_layrnorm``, the blocks, ``post_layernorm`` on
  the class token and a bias-free projection.
Each tower reads its config's ``hidden_act`` (quick_gelu or gelu) and
``layer_norm_eps``; the text tower pools at the first ``eos_token_id``, or,
for a config whose eos_token_id is 2 (the openai configs' value), at
``ids.argmax(-1)``, as Flax does (modeling_flax_clip.py:554-565). The
defaults are CLIPConfig's.

``build_clip_guidance`` builds ``random-tiny`` (the JAX package's
_TINY_TEXT / _TINY_VISION sizes, projection 16) or loads a local CLIP
directory (``config.json`` with text_config, vision_config and
projection_dim; ``model.safetensors`` or ``pytorch_model.bin``). A prompt is
tokenized by the directory's BPE vocabulary (guidance/tokenizer.py) where
one loads, and otherwise by ``_fallback_tokenize``, as the JAX package
does. The CLIP forward runs no hand-written kernel: in the JAX package it
reaches no Pallas kernel either.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.guidance import Guidance

_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_BOS, _EOS = 49406, 49407

_TINY_TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2, vocab_size=49408,
                  max_position_embeddings=77)
_TINY_VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                    num_attention_heads=2, image_size=224, patch_size=32)
_TINY_PROJECTION = 16
# CLIPTextConfig's / CLIPVisionConfig's defaults for what a config omits
_TEXT_DEFAULTS = dict(vocab_size=49408, hidden_size=512,
                      intermediate_size=2048, num_hidden_layers=12,
                      num_attention_heads=8, max_position_embeddings=77,
                      hidden_act="quick_gelu", layer_norm_eps=1e-5,
                      eos_token_id=_EOS)
_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072,
                        num_hidden_layers=12, num_attention_heads=12,
                        image_size=224, patch_size=32,
                        hidden_act="quick_gelu", layer_norm_eps=1e-5)


def clip_preprocess(pred_rgb: torch.Tensor, image_size: int = 224
                    ) -> torch.Tensor:
    """[B,H,W,3] in [0,1] -> CLIP pixel values [B,3,S,S]: a bilinear resize
    (half-pixel centres, no antialiasing: jax.image.resize's upsampling, as
    in guidance/sd/sds.py) and the CLIP normalization (nerf/clip.py:18-21)."""
    x = F.interpolate(pred_rgb.permute(0, 3, 1, 2).float(),
                      size=(image_size, image_size), mode="bilinear",
                      align_corners=False)
    mean = torch.tensor(_CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(_CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


def _fallback_tokenize(prompts, vocab_size: int, length: int = 77
                       ) -> np.ndarray:
    """Deterministic hash tokenizer for random-weight runs (not a BPE): the
    JAX package's, word for word."""
    out = np.zeros((len(prompts), length), np.int32)
    for i, p in enumerate(prompts):
        ids = [_BOS]
        for w in p.lower().split()[: length - 2]:
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(h % (vocab_size - 2) + 1)
        ids.append(_EOS)
        out[i, : len(ids)] = ids
        out[i, len(ids):] = _EOS
    return out


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


# transformers' ACT2FN entries a CLIP config may name (Flax's "gelu" is
# the exact erf form)
_ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


def _activation(name: str):
    if name not in _ACTIVATIONS:
        raise NotImplementedError(
            f"CLIP hidden_act {name!r}: the port takes "
            f"{', '.join(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, causal: bool):
        super().__init__()
        self.heads, self.causal = heads, causal
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(hidden, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        hd = D // self.heads
        q, k, v = (getattr(self, n)(x).reshape(B, S, self.heads, hd)
                   .transpose(1, 2) for n in ("q_proj", "k_proj", "v_proj"))
        logits = (q * hd ** -0.5) @ k.transpose(-1, -2)
        if self.causal:
            keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
        out = torch.softmax(logits, -1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, S, D))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int,
                 act: str = "quick_gelu"):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)
        self.act = _activation(act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, intermediate: int, heads: int,
                 causal: bool, act: str = "quick_gelu", eps: float = 1e-5):
        super().__init__()
        self.self_attn = CLIPAttention(hidden, heads, causal)
        self.layer_norm1 = nn.LayerNorm(hidden, eps=eps)
        self.mlp = CLIPMLP(hidden, intermediate, act)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: dict, causal: bool):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg["hidden_size"], cfg["intermediate_size"],
                             cfg["num_attention_heads"], causal,
                             cfg["hidden_act"], cfg["layer_norm_eps"])
            for _ in range(cfg["num_hidden_layers"]))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _Embed(nn.Module):
    """An embedding table whose parameter is named ``embedding``, as flax's
    nn.Embed names it."""

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n, dim))

    def forward(self, ids):
        return self.embedding[ids]


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.token_embedding = _Embed(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = _Embed(cfg["max_position_embeddings"],
                                         cfg["hidden_size"])

    def forward(self, ids):
        pos = torch.arange(ids.shape[-1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


def text_config(cfg: Optional[dict] = None) -> dict:
    """A text tower's config: `cfg` over CLIPTextConfig's defaults."""
    return {**_TEXT_DEFAULTS, **(cfg or {})}


def vision_config(cfg: Optional[dict] = None) -> dict:
    """A vision tower's config: `cfg` over CLIPVisionConfig's defaults."""
    return {**_VISION_DEFAULTS, **(cfg or {})}


class CLIPTextTransformer(nn.Module):
    """The text tower (FlaxCLIPTextTransformer); also SD's text encoder,
    whose output is ``last_hidden_state``."""

    def __init__(self, cfg: dict):
        super().__init__()
        cfg = text_config(cfg)
        self.eos_token_id = int(cfg["eos_token_id"])
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg, causal=True)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"],
                                             eps=cfg["layer_norm_eps"])

    def last_hidden_state(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, S] ids -> [B, S, D] after final_layer_norm
        (FlaxCLIPTextModel(...)[0])."""
        return self.final_layer_norm(self.encoder(self.embeddings(ids)))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """The pooled output: the hidden state at the first end-of-text
        token, or at ids.argmax(-1) under the legacy eos_token_id 2."""
        h = self.last_hidden_state(ids)
        if self.eos_token_id == 2:
            eos = ids.argmax(-1)
        else:
            eos = (ids == self.eos_token_id).int().argmax(-1)
        return h[torch.arange(h.shape[0], device=h.device), eos]


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        D, P = cfg["hidden_size"], cfg["patch_size"]
        self.class_embedding = nn.Parameter(torch.empty(D))
        self.patch_embedding = nn.Conv2d(3, D, P, stride=P, bias=False)
        n = (cfg["image_size"] // P) ** 2 + 1
        self.position_embedding = _Embed(n, D)

    def forward(self, pixel_values):
        p = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(p.shape[0], 1, -1)
        return torch.cat([cls, p], 1) + self.position_embedding.embedding[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        cfg = vision_config(cfg)
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg["hidden_size"],
                                         eps=cfg["layer_norm_eps"])
        self.encoder = CLIPEncoder(cfg, causal=False)
        self.post_layernorm = nn.LayerNorm(cfg["hidden_size"],
                                           eps=cfg["layer_norm_eps"])

    def forward(self, pixel_values):
        h = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return self.post_layernorm(h[:, 0])


class CLIPModel(nn.Module):
    """Text and vision towers with their projections (FlaxCLIPModule)."""

    def __init__(self, text_cfg: dict, vision_cfg: dict, projection_dim: int):
        super().__init__()
        text_cfg, vision_cfg = text_config(text_cfg), vision_config(vision_cfg)
        self.text_cfg, self.vision_cfg = text_cfg, vision_cfg
        self.text_model = CLIPTextTransformer(text_cfg)
        self.vision_model = CLIPVisionTransformer(vision_cfg)
        self.visual_projection = nn.Linear(vision_cfg["hidden_size"],
                                           projection_dim, bias=False)
        self.text_projection = nn.Linear(text_cfg["hidden_size"],
                                         projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """transformers' Flax initializers: normal(0.02) for the class
        embedding and the projections, normal(0.01) for the attention and
        MLP kernels, normal(1) for the embeddings and the patch kernel,
        zero biases, unit LayerNorms."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if name == "logit_scale":
                    p.fill_(math.log(1 / 0.07))
                elif leaf == "bias":
                    p.zero_()
                elif "norm" in name.rsplit(".", 2)[-2]:
                    p.fill_(1.0)
                elif leaf == "embedding" or "patch_embedding" in name:
                    p.normal_(0.0, 1.0, generator=generator)
                elif "projection" in name or leaf == "class_embedding":
                    p.normal_(0.0, 0.02, generator=generator)
                else:
                    p.normal_(0.0, 0.01, generator=generator)

    def get_text_features(self, ids: torch.Tensor) -> torch.Tensor:
        return self.text_projection(self.text_model(ids))

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixel_values))


def tiny_clip() -> CLIPModel:
    """The random-tiny CLIP of the JAX package (its sizes, projection 16)."""
    return CLIPModel(_TINY_TEXT, _TINY_VISION, _TINY_PROJECTION)


def clip_guidance(model: CLIPModel, image_size: int = 224,
                  tokenizer=None) -> Guidance:
    """Guidance over a built CLIP model (frozen here). tokenizer: a
    guidance/tokenizer.CLIPBPETokenizer, or None for _fallback_tokenize."""
    model.requires_grad_(False)
    vocab = model.text_cfg["vocab_size"]

    def get_text_embeds(prompts, negatives):
        # negatives ignored (reference: nerf/clip.py:28)
        ids = (tokenizer(list(prompts)) if tokenizer is not None
               else _fallback_tokenize(list(prompts), vocab))
        dev = next(model.parameters()).device
        with torch.no_grad():
            z = model.get_text_features(torch.from_numpy(ids).long().to(dev))
        return z / z.norm(dim=-1, keepdim=True)

    def encode_images(pred_rgb):
        """[B, H, W, 3] in [0, 1] -> unit image features [B, P]."""
        z = model.get_image_features(clip_preprocess(pred_rgb, image_size))
        return z / z.norm(dim=-1, keepdim=True)

    def loss(text_z, pred_rgb, draws=None, gen=None):
        """-cos(image_z, text_z), mean over the batch (nerf/clip.py:37-46);
        it draws nothing."""
        return -(encode_images(pred_rgb) * text_z).sum(-1).mean()

    return Guidance(name="clip", modules={"clip": model},
                    get_text_embeds=get_text_embeds, loss=loss,
                    encode_images=encode_images)


def load_clip_dir(path: str, device: Optional[torch.device] = None
                  ) -> CLIPModel:
    """A local CLIP directory (transformers' CLIPModel.save_pretrained
    layout) -> the port's CLIPModel in f32 on `device`; raises on a
    missing, extra or mis-shaped tensor."""
    from dreamfusion_torch.guidance.sd.convert import load_module_dir
    from dreamfusion_torch.weights import load_hf_clip

    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    model = CLIPModel(cfg.get("text_config") or {},
                      cfg.get("vision_config") or {},
                      int(cfg.get("projection_dim", 512)))
    load_hf_clip(model, load_module_dir(path))
    return model.to(resolve_device(device)).eval()


def build_clip_guidance(weights: Optional[str] = None,
                        device: Optional[torch.device] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Guidance:
    """random-tiny (or None): the tiny CLIP, initialised from `generator`;
    a local CLIP directory: its weights, and its BPE tokenizer where
    vocab.json and merges.txt are there. Any other name raises: a hub name
    would need the network."""
    from dreamfusion_torch.guidance.tokenizer import CLIPBPETokenizer

    if weights in (None, "random-tiny"):
        model = tiny_clip().to(resolve_device(device))
        model.reset_parameters(generator)
        return clip_guidance(model.eval())
    if not os.path.isdir(weights):
        raise NotImplementedError(
            f"clip_weights {weights!r} is not a local CLIP directory: the "
            "port builds random-tiny or loads a directory; a hub name "
            "would need the network")
    has_bpe = all(os.path.isfile(os.path.join(weights, f))
                  for f in ("vocab.json", "merges.txt"))
    tokenizer = CLIPBPETokenizer.from_dir(weights) if has_bpe else None
    return clip_guidance(load_clip_dir(weights, device), tokenizer=tokenizer)
