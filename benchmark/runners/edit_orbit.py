"""The runner of orbit mixes over an edited DVGO scene: runners/orbit.py's
``Trainer.test`` orbit (the staged grid eval, an 8-bit PNG a frame), with
the field the configuration's editing field (``--backbone dvgo``) on the
seeded ``.dvgo`` of its ``edit_scene``, as runners/sds.py writes it for
``dvgo_sd15.edit_sds``: the same asset_seed gives the same scene.

Set-up, window and comparison are orbit.Run's. The reference renders the
sampled frames with dfref's ``DVGOEditNetwork`` in float32 (TF32 off);
the control computes it in float8 e4m3, the next precision below the
configuration's half-precision field: the density and k0 grids rounded
once, each rgbnet layer's weight and input rounded, one scale a tensor."""

from __future__ import annotations

import os
import shutil
import tempfile
from types import SimpleNamespace

import torch

from benchkit import inputs, lowp
from runners import orbit

UNIT = orbit.UNIT


def fp8_edit_field(model) -> None:
    """The editing field computed in float8: its grids rounded once, its
    rgbnet as lowp.fp8_linears."""
    with torch.no_grad():
        for grid in (model.main.density, model.main.k0):
            grid.copy_(lowp.fp8(grid))
    lowp.fp8_linears(model.main.rgbnet)


class Run(orbit.Run):
    unit = UNIT

    def __init__(self, cell, seed: int, device="cuda"):
        self.scene_dir = tempfile.mkdtemp(prefix="bench_scene_")
        super().__init__(cell, seed, device)

    def _ref_field(self, generator=None):
        """The reference's editing field read from the scene file; the
        first call, with the asset's generator, writes the file (the
        grids, then the field's own initialisation, from that generator, as
        runners/sds.py draws them)."""
        from dfref.models.kailu import DVGOEditNetwork

        f = self.fields
        if "pretrained_dvgo" not in f:
            f["pretrained_dvgo"] = os.path.join(self.scene_dir, "scene.dvgo")
            inputs.write_dvgo(f["pretrained_dvgo"],
                              self.cell.config["edit_scene"], generator,
                              self.dev)
        ref = DVGOEditNetwork.from_config(SimpleNamespace(**f))
        ref.to(self.dev).reset_parameters(generator)
        ref.load_pretrained()
        return ref

    @torch.no_grad()
    def reference(self, precision: str = "f32", fault=None):
        """orbit.Run.reference, its float8 control lowered as
        fp8_edit_field."""
        saved = lowp.fp8_field
        lowp.fp8_field = fp8_edit_field
        try:
            return super().reference(precision, fault)
        finally:
            lowp.fp8_field = saved

    def close(self) -> None:
        """Remove the scene file once no reference needs it."""
        shutil.rmtree(self.scene_dir, ignore_errors=True)


readings = orbit.readings
