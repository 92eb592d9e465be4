"""pylinac-tpu-torch: the PyTorch and CUDA port of pylinac-tpu.

The JAX package ``pylinac_tpu`` stays the reference. This package mirrors
its layout (``ops/``, ``core/``, ``metrics/``, ``imggen/``,
``picketfence.py``, ``ct.py``), imports ``torch`` and never ``jax``, and runs
its device work on an NVIDIA card through hand-written kernels (``csrc/``).
Its host codecs for compressed DICOM are C++ (``native/``), built with
``g++`` at first use. Ported so far: the picket fence, single image and
batched (``PicketFence``, ``PicketFenceBatch``, ``analyze_batch``), the
CatPhan 503/504/600/604/700 analyses, single scan and batched, from folders
or zips (``CatPhan504``, ``CatPhan700``, ``CatPhanBatch``), the
Winston-Lutz analyses (``WinstonLutz``, also from zips and CBCT scans,
``WinstonLutz2D``, ``WinstonLutzMultiTargetMultiField``), the gamma index (``gamma_2d``, ``gamma_2d_batch``,
``gamma_1d``, ``gamma_geometric``, ``gamma_bakai``), the field analyses
(``FieldAnalysis``, ``DeviceFieldAnalysis``, ``FieldAnalysisBatch``,
``analyze_field_batch``), the starshot analyses (``Starshot``,
``StarshotBatch``, ``analyze_star_batch``), the VMAT tests (``DRGS``,
``DRMLC``, ``DRCS``), the dosimetric leaf gap (``DLG``), the Quart DVT
(``QuartDVT``, ``HypersightQuartDVT``), the ACR CT and MRI phantoms
(``ACRCT``, ``ACRMRILarge``), the cheese phantoms (``TomoCheese``,
``CIRS062M``), the GE Helios daily QA (``GEHeliosCTDaily``), Varian
.xim images (``XIM``), the profile-plugin field analysis
(``FieldProfileAnalysis``) and the planar imaging phantoms (Leeds TOR, the
Standard Imaging QC-3, QC-kV and FC-2, Las Vegas, PTW EPID QC, IBA Primus
A, the SNC kV and MV phantoms, the Doselab MC2 and RLf, IMT L-Rad, PTW
Iso-Align, SNC FSQA and the ACR digital mammography phantom), the machine
log analyzer (``Dynalog``, ``TrajectoryLog``, ``MachineLogs``,
``load_log``), the nuclear-medicine suite (``nuclear``: ``MaxCountRate``,
``PlanarUniformity``, ``CenterOfRotation``, ``TomographicResolution``,
``SimpleSensitivity``, ``FourBarResolution``, ``QuadrantResolution``,
``TomographicUniformity``, ``TomographicContrast``, ``Nuclide``), stage timing
(``profiling``), QA plan generation with its fluence maps
(``TrueBeamPlanGenerator``, ``HalcyonPlanGenerator``, ``MLCShaper``,
``generate_fluences``, ``assign2machine``), the contributed jaw
orthogonality and Quasar analyses (``contrib``), the TG-51 and TRS-398
calibration worksheets with their PDF reports (``tg51``, ``trs398``),
the ``core`` helper modules (``decorators``, ``mask``), the multi-device
runtime (``parallel``: a batch sharded over a ``Mesh`` of devices, the
``mesh=`` of ``PicketFenceBatch``, ``CatPhanBatch``, ``FieldAnalysisBatch``
and ``gamma_2d_batch``), the display ``settings`` and the reports of the
picket fence, the CatPhan family and its siblings (Quart, ACR, cheese,
Helios), Winston-Lutz, field analysis, starshots, VMAT and DLG
(``publish_pdf``, ``to_quaac``, ``plotly_analyzed_images`` through
``core.plotly_utils``, the matplotlib plots).
"""

from .acr import ACRCT, ACRMRILarge
from .calibration import tg51, trs398
from .cheese import CIRS062M, TomoCheese
from .core import decorators, geometry, image, io, mask, profile, roi, utilities
from .core.image import XIM
from .core.profile import Centering, Edge, Interpolation, Normalization
from .core.scale import MachineScale
from .core.utilities import assign2machine
from .ct import CatPhan503, CatPhan504, CatPhan600, CatPhan604, CatPhan700, CatPhanBatch
from .dlg import DLG
from .helios import GEHeliosCTDaily
from .log_analyzer import Dynalog, MachineLogs, TrajectoryLog, load_log
from .field_analysis import (Device, DeviceFieldAnalysis, FieldAnalysis, FieldAnalysisBatch,
                             Protocol, analyze_field_batch)
from .field_profile_analysis import FieldProfileAnalysis
from .nuclear import (CenterOfRotation, FourBarResolution, MaxCountRate, Nuclide,
                      PlanarUniformity, QuadrantResolution, SimpleSensitivity, TomographicContrast,
                      TomographicResolution, TomographicUniformity)
from .plan_generator import HalcyonPlanGenerator, MLCShaper, TrueBeamPlanGenerator, generate_fluences
from .planar_imaging import (PTWEPIDQC, SNCFSQA, SNCMV, SNCMV12510, ACRDigitalMammography,
                             DoselabMC2kV, DoselabMC2MV, DoselabRLf, ElektaLasVegas, IBAPrimusA,
                             IMTLRad, IsoAlign, LasVegas, LeedsTOR, LeedsTORBlue, SNCkV,
                             StandardImagingFC2, StandardImagingQC3, StandardImagingQCkV)
from .ops.gamma import gamma_1d, gamma_2d, gamma_2d_batch, gamma_bakai, gamma_geometric
from .starshot import Starshot, StarshotBatch, StarshotResults, analyze_star_batch
from .picketfence import (MLC, MLCArrangement, Orientation, PFResult, PicketFence,
                          PicketFenceBatch, analyze_batch)
from .quart import HypersightQuartDVT, QuartDVT
from .version import __version__
from .vmat import DRCS, DRGS, DRMLC
from .winston_lutz import (BBArrangement, BBConfig, WinstonLutz, WinstonLutz2D,
                           WinstonLutzMultiTargetMultiField, WinstonLutzMultiTargetMultiFieldResult)

__all__ = ["ACRCT", "ACRDigitalMammography", "ACRMRILarge", "BBArrangement", "BBConfig", "CIRS062M", "CatPhan503", "CatPhan504", "CatPhan600", "CatPhan604",
           "CatPhan700", "CatPhanBatch", "CenterOfRotation", "Centering", "DLG", "DRCS", "DRGS",
           "DRMLC", "Device", "DeviceFieldAnalysis", "DoselabMC2MV", "Dynalog", "DoselabMC2kV", "DoselabRLf", "Edge",
           "ElektaLasVegas", "FieldAnalysis", "FieldAnalysisBatch", "FieldProfileAnalysis",
           "FourBarResolution", "GEHeliosCTDaily", "HalcyonPlanGenerator", "IBAPrimusA", "IMTLRad", "IsoAlign", "LasVegas", "LeedsTOR",
           "LeedsTORBlue", "PTWEPIDQC", "SNCFSQA", "SNCMV", "SNCMV12510", "SNCkV",
           "StandardImagingFC2", "StandardImagingQC3", "StandardImagingQCkV",
           "HypersightQuartDVT", "Interpolation", "MLC", "MLCArrangement", "MLCShaper", "MachineLogs",
           "MachineScale", "MaxCountRate",
           "Normalization", "Nuclide", "Orientation", "PFResult", "PicketFence", "PicketFenceBatch", "PlanarUniformity", "Protocol",
           "QuadrantResolution", "QuartDVT", "SimpleSensitivity", "Starshot", "StarshotBatch", "StarshotResults", "TomoCheese", "TomographicContrast",
           "TomographicResolution", "TomographicUniformity", "TrajectoryLog",
           "TrueBeamPlanGenerator",
           "WinstonLutz",
           "WinstonLutz2D",
           "WinstonLutzMultiTargetMultiField", "WinstonLutzMultiTargetMultiFieldResult",
           "analyze_batch", "analyze_field_batch", "assign2machine", "decorators", "analyze_star_batch", "gamma_1d",
           "gamma_2d", "gamma_2d_batch", "gamma_bakai", "gamma_geometric", "generate_fluences",
           "geometry", "image", "io", "load_log", "mask", "profile", "roi", "tg51", "trs398",
           "utilities", "XIM",
           "__version__"]
