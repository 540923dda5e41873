"""Image quality metrics: PSNR, SSIM (mipnerf-style), CLIP R-precision,
LPIPS (gated). The port's copy of dreamfusion_tpu/training/metrics.py;
``clip_r_precision_from_renders`` runs the port's CLIP guidance.

Rebuilds frameworks/nerf/utils.py:193-262 (rgb_ssim — the mipnerf SSIM port —
and rgb_lpips). LPIPS requires the `lpips` torch package + weights; it is
gated behind availability like the reference's lazy import.
"""

from __future__ import annotations

import numpy as np


def rgb_psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((pred - gt) ** 2))
    return -10.0 * np.log10(max(mse, 1e-10))


def rgb_ssim(img0: np.ndarray, img1: np.ndarray, max_val: float = 1.0,
             filter_size: int = 11, filter_sigma: float = 1.5,
             k1: float = 0.01, k2: float = 0.03,
             return_map: bool = False):
    """SSIM with a separable Gaussian filter (the mipnerf implementation the
    reference ports at frameworks/nerf/utils.py:198-244)."""
    assert img0.shape == img1.shape and img0.ndim == 3
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)

    hw = filter_size // 2
    shift = np.arange(-hw, hw + 1)
    f_i = ((shift / filter_sigma) ** 2) / 2
    filt = np.exp(-f_i)
    filt /= np.sum(filt)

    def convolve2d(z, f):
        return np.stack([
            _conv2d_sep(z[..., i], f) for i in range(z.shape[-1])], -1)

    def _conv2d_sep(z, f):
        from numpy.lib.stride_tricks import sliding_window_view

        pad = len(f) // 2
        zp = np.pad(z, ((pad, pad), (0, 0)), mode="symmetric")
        z1 = np.einsum("ijk,k->ij",
                       sliding_window_view(zp, len(f), axis=0), f)
        zp = np.pad(z1, ((0, 0), (pad, pad)), mode="symmetric")
        return np.einsum("ijk,k->ij",
                         sliding_window_view(zp, len(f), axis=1), f)

    mu0 = convolve2d(img0, filt)
    mu1 = convolve2d(img1, filt)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = convolve2d(img0 ** 2, filt) - mu00
    sigma11 = convolve2d(img1 ** 2, filt) - mu11
    sigma01 = convolve2d(img0 * img1, filt) - mu01

    sigma00 = np.maximum(0.0, sigma00)
    sigma11 = np.maximum(0.0, sigma11)
    sigma01 = np.sign(sigma01) * np.minimum(np.sqrt(sigma00 * sigma11),
                                            np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))


def clip_r_precision(image_features: np.ndarray, text_features: np.ndarray,
                     true_idx: np.ndarray, R: int = 1) -> float:
    """CLIP R-precision: fraction of images whose true prompt ranks in the
    top-R by cosine similarity against all candidate prompts (the
    DreamFusion/DreamFields eval metric; BASELINE.md's parity metric).

    image_features [N, D], text_features [M, D] (both any norm — normalized
    here), true_idx [N] the index of each image's ground-truth prompt.
    """
    img = image_features / np.linalg.norm(image_features, axis=-1,
                                          keepdims=True)
    txt = text_features / np.linalg.norm(text_features, axis=-1, keepdims=True)
    sims = img @ txt.T                                   # [N, M]
    rank = np.argsort(-sims, axis=-1)[:, :R]             # top-R prompt ids
    hits = (rank == np.asarray(true_idx)[:, None]).any(-1)
    return float(hits.mean())


def clip_r_precision_from_renders(guidance, renders: np.ndarray,
                                  prompts, true_idx, R: int = 1) -> float:
    """Convenience: encode renders [N, H, W, 3] and prompts with a CLIP
    guidance (guidance/clip.py, which exposes encode_images) and compute
    R-precision. The renders go to the device of the text embeddings."""
    import torch

    assert guidance.encode_images is not None, \
        "guidance must expose encode_images (use the CLIP guidance)"
    with torch.no_grad():
        txt = guidance.get_text_embeds(list(prompts), [""] * len(prompts))
        img = guidance.encode_images(torch.as_tensor(
            np.asarray(renders), dtype=torch.float32, device=txt.device))
    return clip_r_precision(img.float().cpu().numpy(),
                            txt.float().cpu().numpy(), true_idx, R=R)


_lpips_models = {}


def rgb_lpips(np_gt: np.ndarray, np_im: np.ndarray, net_name: str = "alex",
              device: str = "cpu") -> float:
    """LPIPS via the torch `lpips` package (frameworks/nerf/utils.py:247-262).
    Raises ImportError with a pointer when lpips isn't installed."""
    try:
        import lpips  # type: ignore
        import torch
    except ImportError as e:
        raise ImportError(
            "rgb_lpips needs the `lpips` package (pip install lpips) and its "
            "pretrained weights; unavailable in this environment") from e
    if net_name not in _lpips_models:
        _lpips_models[net_name] = lpips.LPIPS(net=net_name, version="0.1")
    model = _lpips_models[net_name]
    gt = torch.from_numpy(np_gt.astype(np.float32)).permute(2, 0, 1)[None]
    im = torch.from_numpy(np_im.astype(np.float32)).permute(2, 0, 1)[None]
    return float(model(gt, im, normalize=True).item())
