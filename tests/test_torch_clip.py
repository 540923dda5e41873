"""Parity of the port's CLIP guidance (its own PyTorch CLIP) with the JAX
package's FlaxCLIPModel guidance at the random-tiny sizes (_TINY_TEXT /
_TINY_VISION, projection 16), on the CPU, with the Flax parameters carried
over by weights.from_jax_params: the tokenizer, text features, image
features, the preprocess, the loss -mean(cos) and its gradient with
respect to the rendered image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance import clip as jclip

from dreamfusion_torch.config import Config
from dreamfusion_torch.guidance import build_guidance
from dreamfusion_torch.guidance import clip as tclip
from dreamfusion_torch.weights import from_jax_params


def _close(a, b, rel):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-30))


def _clip_pair():
    """The JAX package's random-tiny CLIP guidance and the port's, with the
    Flax parameters converted."""
    jg = jclip.build_clip_guidance("random-tiny")
    model = tclip.tiny_clip()
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jg.params)))
    return jg, tclip.clip_guidance(model.eval())


@pytest.fixture(scope="module")
def pair():
    return _clip_pair()


PROMPTS = ["a red cube, front view", "A hamburger on a plate, overhead view"]


def test_tokenizer_and_text_features_match(pair):
    """The hash tokenizer bit for bit; normalized text features 1e-5 of
    their largest entry (the pooled token is the first end-of-text)."""
    jg, tg = pair
    ids = jclip._fallback_tokenize(PROMPTS, 49408)
    assert np.array_equal(tclip._fallback_tokenize(PROMPTS, 49408), ids)
    ref = jg.get_text_embeds(PROMPTS, ["", ""])
    _close(tg.get_text_embeds(PROMPTS, ["", ""]), ref, 1e-5)


def test_image_features_and_preprocess_match(pair):
    """A 64 x 64 render resized to 224 and normalized (1e-5), then the
    vision tower's normalized features (1e-5)."""
    jg, tg = pair
    rgb = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    _close(tclip.clip_preprocess(torch.from_numpy(rgb)),
           jclip.clip_preprocess(jnp.asarray(rgb)), 1e-5)
    ref = jg.encode_images(jg.params, jnp.asarray(rgb))
    model = tg.modules["clip"]
    got = model.get_image_features(tclip.clip_preprocess(torch.from_numpy(rgb)))
    _close(got / got.norm(dim=-1, keepdim=True), ref, 1e-5)


def test_loss_and_image_gradient_match(pair):
    """loss = -mean(cos(image_z, text_z)) (1e-5) and its gradient with
    respect to pred_rgb [2, 64, 64, 3] (1e-4 of its largest entry)."""
    jg, tg = pair
    rgb = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jz = jg.get_text_embeds(PROMPTS, ["", ""])
    jloss, jgrad = jax.value_and_grad(
        lambda x: jg.loss(jg.params, jz, x, jax.random.PRNGKey(0)))(
            jnp.asarray(rgb))
    tz = tg.get_text_embeds(PROMPTS, ["", ""])
    x = torch.from_numpy(rgb).requires_grad_(True)
    loss = tg.loss(tz, x)
    loss.backward()
    _close(loss, jloss, 1e-5)
    _close(x.grad, jgrad, 1e-4)
    # the model is frozen: only the image receives a gradient
    assert all(p.grad is None for p in tg.modules["clip"].parameters())


def test_build_guidance_dispatches_clip_and_refuses_real_weights():
    """cfg.guidance "clip" builds the random-tiny model; a checkpoint name
    raises, since no CLIP weights are in the repository."""
    cfg = Config(text="x", guidance="clip", clip_weights="random-tiny")
    g = build_guidance(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    assert g.name == "clip"
    z = g.get_text_embeds(["x"], [""])
    assert z.shape == (1, 16)
    torch.testing.assert_close(z.norm(dim=-1), torch.ones(1))
    with pytest.raises(NotImplementedError, match="random-tiny"):
        build_guidance(cfg.replace(clip_weights="openai/clip-vit-base-patch16"),
                       torch.device("cpu"))
