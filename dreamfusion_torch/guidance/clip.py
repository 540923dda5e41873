"""CLIP (dreamfields-style) guidance (counterpart of
dreamfusion_tpu/guidance/clip.py; reference nerf/clip.py:18-46).

The loss is -mean(cos(image_features, text_features)) of the rendered frame
resized to 224 and CLIP-normalized; the negative prompt is ignored, as in
the reference (nerf/clip.py:28).

The model is the port's own small CLIP in PyTorch, written after
transformers' FlaxCLIPModel (modeling_flax_clip.py), whose parameter
names it carries, so weights.from_jax_params converts a Flax CLIP tree:
- text tower: token and position embeddings, pre-LN blocks under a causal
  mask, a final LayerNorm, pooling at the first end-of-text token, a
  bias-free projection;
- vision tower: a bias-free patch convolution, the class embedding,
  position embeddings, ``pre_layrnorm``, the blocks, ``post_layernorm`` on
  the class token and a bias-free projection.
Blocks use quick_gelu and LayerNorm epsilon 1e-5 (CLIPConfig's defaults).

Only ``random-tiny`` (the JAX package's _TINY_TEXT / _TINY_VISION sizes,
projection 16) can be built: no CLIP checkpoint or tokenizer vocabulary
is in the repository, so a prompt is tokenized by ``_fallback_tokenize``.
The CLIP forward runs no hand-written kernel: in the JAX package it
reaches no Pallas kernel either.
"""

from __future__ import annotations

import hashlib
import math
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
_LN_EPS = 1e-5


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
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, intermediate: int, heads: int,
                 causal: bool):
        super().__init__()
        self.self_attn = CLIPAttention(hidden, heads, causal)
        self.layer_norm1 = nn.LayerNorm(hidden, eps=_LN_EPS)
        self.mlp = CLIPMLP(hidden, intermediate)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=_LN_EPS)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: dict, causal: bool):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg["hidden_size"], cfg["intermediate_size"],
                             cfg["num_attention_heads"], causal)
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


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg, causal=True)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"], eps=_LN_EPS)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        h = self.final_layer_norm(self.encoder(self.embeddings(ids)))
        # the first end-of-text token (modeling_flax_clip.py, eos_token_id
        # 49407; with the fallback tokenizer it is also ids.argmax(-1))
        eos = (ids == _EOS).int().argmax(-1)
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
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg["hidden_size"], eps=_LN_EPS)
        self.encoder = CLIPEncoder(cfg, causal=False)
        self.post_layernorm = nn.LayerNorm(cfg["hidden_size"], eps=_LN_EPS)

    def forward(self, pixel_values):
        h = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return self.post_layernorm(h[:, 0])


class CLIPModel(nn.Module):
    """Text and vision towers with their projections (FlaxCLIPModule)."""

    def __init__(self, text_cfg: dict, vision_cfg: dict, projection_dim: int):
        super().__init__()
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


def clip_guidance(model: CLIPModel, image_size: int = 224) -> Guidance:
    """Guidance over a built CLIP model (frozen here)."""
    model.requires_grad_(False)
    vocab = model.text_cfg["vocab_size"]

    def get_text_embeds(prompts, negatives):
        ids = torch.from_numpy(_fallback_tokenize(list(prompts), vocab)).long()
        dev = next(model.parameters()).device
        with torch.no_grad():
            z = model.get_text_features(ids.to(dev))
        return z / z.norm(dim=-1, keepdim=True)

    def encode_images(pred_rgb):
        z = model.get_image_features(clip_preprocess(pred_rgb, image_size))
        return z / z.norm(dim=-1, keepdim=True)

    def loss(text_z, pred_rgb, draws=None, gen=None):
        """-cos(image_z, text_z), mean over the batch (nerf/clip.py:37-46);
        it draws nothing."""
        return -(encode_images(pred_rgb) * text_z).sum(-1).mean()

    return Guidance(name="clip", modules={"clip": model},
                    get_text_embeds=get_text_embeds, loss=loss)


def build_clip_guidance(weights: Optional[str] = None,
                        device: Optional[torch.device] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Guidance:
    """random-tiny (or None): the tiny CLIP, initialised from `generator`.
    A checkpoint path or hub name raises: no CLIP weights or tokenizer
    vocabulary are in the repository."""
    if weights not in (None, "random-tiny"):
        raise NotImplementedError(
            f"clip_weights {weights!r}: the port builds only random-tiny; "
            "loading CLIP ViT-B/16 weights and its BPE vocabulary waits "
            "until those files are in the repository")
    model = tiny_clip().to(resolve_device(device))
    model.reset_parameters(generator)
    return clip_guidance(model.eval())
