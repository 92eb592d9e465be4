"""QA plan generation, the port of ``pylinac_tpu/plan_generator/__init__.py``."""

from .dicom import (
    FluenceMode,
    GantryDirection,
    HalcyonBeam,
    HalcyonPlanGenerator,
    OvertravelError,
    PlanGenerator,
    Stack,
    TrueBeamBeam,
    TrueBeamPlanGenerator,
)
from .fluence import generate_fluences, plot_fluences
from .mlc import MLCShaper
