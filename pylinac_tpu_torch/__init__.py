"""pylinac-tpu-torch: the PyTorch and CUDA port of pylinac-tpu.

The JAX package ``pylinac_tpu`` stays the reference. This package mirrors
its layout (``ops/``, ``core/``, ``metrics/``, ``imggen/``,
``picketfence.py``, ``ct.py``), imports ``torch`` and never ``jax``, and runs
its device work on an NVIDIA card through hand-written kernels (``csrc/``).
Ported so far: the batched picket fence (``PicketFenceBatch``,
``analyze_batch``) and the CatPhan 503/504/600/604 analyses, single scan
and batched (``CatPhan504``, ``CatPhanBatch``).
"""

from .ct import CatPhan503, CatPhan504, CatPhan600, CatPhan604, CatPhanBatch
from .picketfence import MLC, MLCArrangement, Orientation, PFResult, PicketFenceBatch, analyze_batch
from .version import __version__

__all__ = ["CatPhan503", "CatPhan504", "CatPhan600", "CatPhan604", "CatPhanBatch",
           "MLC", "MLCArrangement", "Orientation", "PFResult", "PicketFenceBatch",
           "analyze_batch", "__version__"]
