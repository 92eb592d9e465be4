"""Multi-device batch runtime: :mod:`.mesh` (port of
``pylinac_tpu/parallel/__init__.py``, with its ``__all__``)."""

from .mesh import (
    QABatchRunner,
    sharded_ct_localization,
    sharded_field_analysis,
    sharded_gamma_2d,
    sharded_picket_fence,
    sharded_wl_centroids,
)

__all__ = [
    "QABatchRunner",
    "sharded_field_analysis",
    "sharded_ct_localization",
    "sharded_gamma_2d",
    "sharded_picket_fence",
    "sharded_wl_centroids",
]
