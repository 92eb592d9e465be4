"""pylinac-tpu-torch: the PyTorch and CUDA port of pylinac-tpu.

The JAX package ``pylinac_tpu`` stays the reference. This package mirrors
its layout (``ops/``, ``core/``, ``metrics/``, ``imggen/``,
``picketfence.py``, ``ct.py``), imports ``torch`` and never ``jax``, and runs
its device work on an NVIDIA card through hand-written kernels (``csrc/``).
Ported so far: the batched picket fence (``PicketFenceBatch``,
``analyze_batch``), the CatPhan 503/504/600/604 analyses, single scan and
batched (``CatPhan504``, ``CatPhanBatch``), the Winston-Lutz analyses
(``WinstonLutz``, ``WinstonLutz2D``), the gamma index (``gamma_2d``,
``gamma_2d_batch``, ``gamma_1d``, ``gamma_geometric``, ``gamma_bakai``) and
the field analyses (``FieldAnalysis``, ``DeviceFieldAnalysis``,
``FieldAnalysisBatch``, ``analyze_field_batch``).
"""

from .core.profile import Centering, Edge, Interpolation, Normalization
from .core.scale import MachineScale
from .ct import CatPhan503, CatPhan504, CatPhan600, CatPhan604, CatPhanBatch
from .field_analysis import (DeviceFieldAnalysis, FieldAnalysis, FieldAnalysisBatch, Protocol,
                             analyze_field_batch)
from .ops.gamma import gamma_1d, gamma_2d, gamma_2d_batch, gamma_bakai, gamma_geometric
from .picketfence import MLC, MLCArrangement, Orientation, PFResult, PicketFenceBatch, analyze_batch
from .version import __version__
from .winston_lutz import BBArrangement, WinstonLutz, WinstonLutz2D

__all__ = ["BBArrangement", "CatPhan503", "CatPhan504", "CatPhan600", "CatPhan604",
           "CatPhanBatch", "Centering", "DeviceFieldAnalysis", "Edge", "FieldAnalysis",
           "FieldAnalysisBatch", "Interpolation", "MLC", "MLCArrangement", "MachineScale",
           "Normalization", "Orientation", "PFResult", "PicketFenceBatch", "Protocol",
           "WinstonLutz", "WinstonLutz2D", "analyze_batch", "analyze_field_batch", "gamma_1d",
           "gamma_2d", "gamma_2d_batch", "gamma_bakai", "gamma_geometric", "__version__"]
