"""The DVGO model-zoo registry (counterpart of the registry of
dreamfusion_tpu/models/zoo.py; reference frameworks/nerf/modules/
__init__.py:12-43).

Only the base entries are ported: ``dvgo_coarse`` and ``dvgo_fine``, both
models/dvgo.DVGOField (coarse when rgbnet_name is None). The variants
(DVGO_Plus, NeRFWoNN, FFL, FastFFL, DVGO360) and the OSR fields subclass
that field and are not ported yet; ``get_field`` raises for them.
"""

from __future__ import annotations

from dreamfusion_torch.models.dvgo import DVGOField

field_registry = {
    "dvgo_coarse": DVGOField,
    "dvgo_fine": DVGOField,
}


def get_field(name: str, **kwargs) -> DVGOField:
    if name not in field_registry:
        raise NotImplementedError(
            f"field {name!r}: the port registers {sorted(field_registry)}; "
            "the zoo's variants and the OSR fields are not ported yet")
    return field_registry[name](**kwargs)
