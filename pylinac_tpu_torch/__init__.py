"""pylinac-tpu-torch: the PyTorch and CUDA port of pylinac-tpu.

The JAX package ``pylinac_tpu`` stays the reference. This package mirrors
its layout (``ops/``, ``core/``, ``imggen/``, ``picketfence.py``), imports
``torch`` and never ``jax``, and runs its device work on an NVIDIA card
through hand-written kernels (``csrc/``). Ported so far: the batched
picket fence, ``PicketFenceBatch`` and ``analyze_batch``.
"""

from .picketfence import MLC, MLCArrangement, Orientation, PFResult, PicketFenceBatch, analyze_batch
from .version import __version__

__all__ = ["MLC", "MLCArrangement", "Orientation", "PFResult", "PicketFenceBatch",
           "analyze_batch", "__version__"]
