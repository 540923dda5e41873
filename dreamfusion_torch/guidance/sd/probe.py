"""Probe for a mounted Stable Diffusion v1.5 directory (the port's copy
of dreamfusion_tpu/guidance/sd/probe.py).

Weights arrive as a mounted diffusers-format directory, never by download.
``find_sd_weights()`` looks at $SD_WEIGHTS_DIR first, then a depth-bounded
list of mount globs, and logs which way it went; ``build_guidance`` calls
it when ``sd_weights`` is None or ``random-full``, and
``guidance/sd/convert.load_sd_dir`` loads what it finds (reference:
nerf/sd.py:39-50 loads runwayml/stable-diffusion-v1-5 from the HF cache).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

# well-known mount points, most specific first. Depth-bounded patterns only:
# a recursive ** walk over a large data mount could stall startup.
_CANDIDATE_GLOBS = tuple(
    f"{root}{depth}stable-diffusion*"
    for root in ("/data/", "/mnt/", "/models/")
    for depth in ("", "*/", "*/*/")
) + (
    os.path.expanduser("~/.cache/huggingface/hub/"
                       "models--runwayml--stable-diffusion-v1-5/snapshots/*"),
)


def _looks_like_sd_dir(path: str) -> bool:
    """A diffusers-format SD directory has unet/ and vae/ subdirs with
    weight files (reference layout: nerf/sd.py:44-50)."""
    if not os.path.isdir(path):
        return False
    for sub in ("unet", "vae"):
        d = os.path.join(path, sub)
        if not os.path.isdir(d):
            return False
        if not (glob.glob(os.path.join(d, "*.bin"))
                + glob.glob(os.path.join(d, "*.safetensors"))):
            return False
    return True


def find_sd_weights(verbose: bool = True) -> Optional[str]:
    """Return a usable SD v1.5 weights directory, or None.

    $SD_WEIGHTS_DIR wins; otherwise the well-known mount list is scanned.
    Always says clearly which way it went (the log line is the round's
    evidence that the probe ran)."""
    env = os.environ.get("SD_WEIGHTS_DIR")
    if env:
        if _looks_like_sd_dir(env):
            if verbose:
                print(f"[sd-probe] real SD weights: $SD_WEIGHTS_DIR={env}")
            return env
        if verbose:
            print(f"[sd-probe] $SD_WEIGHTS_DIR={env} set but not a "
                  "diffusers-format SD dir (need unet/ + vae/ weights)")
    for pat in _CANDIDATE_GLOBS:
        for hit in sorted(glob.glob(pat)):
            if _looks_like_sd_dir(hit):
                if verbose:
                    print(f"[sd-probe] real SD weights found: {hit}")
                return hit
    if verbose:
        print("[sd-probe] no real SD weights mounted (searched "
              "$SD_WEIGHTS_DIR, /data, /mnt, /models, HF cache); "
              "running with random weights of identical shape")
    return None
