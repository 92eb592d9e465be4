"""Winston-Lutz isocentre QA on the card.

Port of ``pylinac_tpu/winston_lutz.py``: the rotation helpers (``:59-85``),
``BBConfig`` (``:91``, a dataclass), ``BBArrangement.ISO`` (``:107``),
``BBFieldMatch`` (``:132``), ``BB3D`` (``:179``), ``Axis`` (``:215``), the
result models (``:228-261``, dataclasses), ``bb_projection_with_rotation``
(``:286``), ``straight_ray`` (``:304``), the Low et al. solvers
(``:318-349``), the field-centroid fills (``:432-494``),
``_wl_detect_packed`` (``:500``), ``WLBaseImage`` (``:534``),
``WinstonLutz2D`` (``:723``) and ``WinstonLutz`` (``:785``, with
``from_zip`` ``:846``, ``from_cbct_zip`` ``:857`` and ``from_cbct``
``:864-903``); and the
multi-target analysis: ``BBArrangement.SNC_MULTIMET``, ``DEMO`` and
``to_human`` (``:112-130``), ``WinstonLutzMultiTargetMultiFieldResult``
(``:264``), ``max_distance_to_lines`` (``:280``),
``conventional_to_euler_notation`` (``:352``),
``_euler_extrinsic_decompose`` (``:357``), ``align_points`` (``:374``),
``WinstonLutzMultiTargetMultiFieldImage`` (``:1523``) and
``WinstonLutzMultiTargetMultiField`` (``:1571``).

Device work runs on the ``device`` given to ``analyze`` (``None`` means
CUDA, and raises without it):

* the batched detection (``WinstonLutz.analyze``) thresholds the staged
  frames, fills the field masks and takes their centroids, then scans the
  central BB windows of every frame at 52 thresholds through one batched
  region-property pass (:func:`pylinac_tpu_torch.metrics.batch_find.
  bb_scan_core`, the CCL kernel ``csrc/ccl.cu`` 4-connected in label and
  hole modes), and fetches one packed array;
* the single image (``WinstonLutz2D.analyze``, and ``WinstonLutz`` when
  the batch declines: custom detection conditions, mixed dpmm or frame
  shapes) fills its field mask with :func:`pylinac_tpu_torch.ops.label.
  fill_holes` (the border-flood kernel ``csrc/flood.cu``) and finds the BB
  with :class:`~pylinac_tpu_torch.metrics.image.SizedDiskLocator` (the CCL
  kernel at B = 1, one threshold at a time).

The environment variable ``PYLINAC_TPU_FLOOD`` selects the batched field
fill where the JAX class reads it (``:463``, ``:1067``), with its values:
unset or ``""`` runs the convex fill (four cumulative scans, exact for a
convex field) in plain PyTorch, as JAX runs it in plain XLA; ``"xla"``
fills each frame exactly through the border-flood kernel
(:func:`~pylinac_tpu_torch.ops.flood.flood_from_border_batch`); ``"packed"``
runs the flood kernel's centroid entry
(:func:`~pylinac_tpu_torch.ops.flood.filled_centroid_batch`). Both exact
modes run hand kernels on the card; no value routes to a plain twin. The
port has no VMEM limit, so unlike JAX (``:492``) ``"packed"`` never falls
back to the convex fill for a large frame.

The isocentre fits (``_minimize_axis``) run Nelder-Mead on CPU tensors:
a 3-parameter minimax over a dozen rays, where the card would only add
launches and syncs (:mod:`pylinac_tpu_torch.ops.optimize`).

The multi-target class finds each image's fields with
:class:`~pylinac_tpu_torch.metrics.image.GlobalSizedFieldLocator` over the
whole frame (the CCL kernel 8-connected, one threshold at a time) and each
BB with a :class:`~pylinac_tpu_torch.metrics.image.SizedDiskLocator` window
around its projection. As in the JAX class, ``WinstonLutz._load_image``
gives every image the collection's detection conditions, so the image
class's own ``[is_round, is_modest_size, is_symmetric]`` is never used.

A CBCT scan of a BB (``WinstonLutz.from_cbct``) becomes four maximum
intensity projections on the host, as in the JAX package; ``analyze`` then
forces a low-density BB and an open field: no field fill, and the four
views' BB windows go through the batched scan (``bb_scan_core``, the CCL
kernel 4-connected).

``WinstonLutz2D``, ``WinstonLutz`` and ``WinstonLutzMultiTargetMultiField``
capture the warnings their own methods raise into
``results_data().warnings`` (``capture_warnings``, as in the JAX package).

The reports (``WLBaseImage.plot`` ``:707``, ``WinstonLutz`` ``:1333-1520``
and the multi-target QuAAC ``:1685``): ``publish_pdf`` through
:mod:`.core.pdf`, ``to_quaac`` and ``plotly_analyzed_images`` need no
matplotlib; the plots and the saved images import it inside, and raise
``ModuleNotFoundError`` where it is missing. As in JAX, ``plot_location``
and ``plotly_analyzed_images`` of the multi-target class read a
``measured_position`` that ``BB3D`` has not, and raise ``AttributeError``.

Not ported: URL and demo loading (``from_url``, ``from_demo_images``,
``run_demo``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import math
import os
import os.path as osp
import statistics
import tempfile
from functools import cached_property
from itertools import zip_longest
from pathlib import Path
from types import SimpleNamespace
from typing import Iterable, Sequence

import numpy as np
import torch

from .core import dcm, image
from .core.array_utils import array_to_dicom
from .core.geometry import Line, Point, Vector, cos, sin
from .core.io import TemporaryZipDirectory
from .core.scale import MachineScale, convert
from .core.utilities import (DataModel, QuaacDatum, QuaacMixin, ResultBase, ResultsDataMixin,
                             convert_to_enum, resolve_device)
from .core.warnings import capture_warnings
from .metrics.batch_find import batched_bb_windows, bb_scan_core, reference_cutoffs
from .metrics.features import (
    is_modest_size,
    is_near_center,
    is_right_circumference,
    is_right_size_bb,
    is_right_square_size,
    is_round,
    is_solid,
    is_square,
    is_symmetric,
)
from .metrics.image import GlobalSizedFieldLocator, SizedDiskLocator
from .ops.flood import filled_centroid_batch, flood_from_border_batch
from .ops.label import fill_holes
from .ops.optimize import nelder_mead
from .ops.stats import fma_f32

__all__ = ["Axis", "BB3D", "BBArrangement", "BBConfig", "BBFieldMatch", "WLBaseImage",
           "WinstonLutz", "WinstonLutz2D", "WinstonLutz2DResult",
           "WinstonLutzMultiTargetMultiField", "WinstonLutzMultiTargetMultiFieldImage",
           "WinstonLutzMultiTargetMultiFieldResult",
           "WinstonLutzResult", "align_points", "bb_projection_with_rotation", "is_modest_size",
           "is_near_center", "is_right_square_size", "is_square", "max_distance_to_lines",
           "solve_3d_position_from_2d_planes", "solve_3d_shift_vector_from_2d_planes",
           "straight_ray"]

BB_ERROR_MESSAGE = (
    "The BB could not be detected. Please check the image for the BB and adjust "
    "analysis parameters (e.g. bb_size_mm) as needed.")


# --------------------------------------------------------------------------
# Rotation helpers (in place of scipy.spatial.transform.Rotation)
# --------------------------------------------------------------------------
def _rot_x(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _euler_xyz_extrinsic(ax: float, ay: float, az: float) -> np.ndarray:
    """scipy Rotation.from_euler('xyz', [ax, ay, az]), extrinsic: Rz·Ry·Rx."""
    return _rot_z(az) @ _rot_y(ay) @ _rot_x(ax)


def is_close_degrees(angle1: float, angle2: float, delta: float = 1.0) -> bool:
    """Whether two angles are within ``delta`` degrees, with wrap-around."""
    diff = abs((angle1 - angle2 + 180) % 360 - 180)
    return diff <= delta


# --------------------------------------------------------------------------
# BB configuration
# --------------------------------------------------------------------------
@dataclasses.dataclass
class BBConfig(DataModel):
    """One BB of an arrangement; the offsets and sizes are floats, as the
    JAX model coerces them."""

    name: str
    offset_left_mm: float
    offset_up_mm: float
    offset_in_mm: float
    bb_size_mm: float
    rad_size_mm: float

    def to_human(self) -> str:
        lr = "Left" if self.offset_left_mm >= 0 else "Right"
        ud = "Up" if self.offset_up_mm >= 0 else "Down"
        io = "In" if self.offset_in_mm >= 0 else "Out"
        return (f"{lr} {abs(self.offset_left_mm)}mm, {ud} {abs(self.offset_up_mm)}mm, "
                f"{io} {abs(self.offset_in_mm)}mm")


class BBArrangement:
    """Preset BB arrangements: the single BB at the isocentre and the SNC
    MultiMet phantom's six (the demo arrangement)."""

    ISO = (BBConfig(name="Iso", offset_left_mm=0, offset_up_mm=0, offset_in_mm=0,
                    bb_size_mm=5, rad_size_mm=20),)
    SNC_MULTIMET = (
        BBConfig(name="Iso", offset_left_mm=0, offset_up_mm=0, offset_in_mm=0, bb_size_mm=5,
                 rad_size_mm=20),
        BBConfig(name="1", offset_left_mm=0, offset_up_mm=0, offset_in_mm=30, bb_size_mm=5,
                 rad_size_mm=20),
        BBConfig(name="2", offset_left_mm=-30, offset_up_mm=0, offset_in_mm=15, bb_size_mm=5,
                 rad_size_mm=20),
        BBConfig(name="3", offset_left_mm=0, offset_up_mm=0, offset_in_mm=-30, bb_size_mm=5,
                 rad_size_mm=20),
        BBConfig(name="4", offset_left_mm=30, offset_up_mm=0, offset_in_mm=-50, bb_size_mm=5,
                 rad_size_mm=20),
        BBConfig(name="5", offset_left_mm=0, offset_up_mm=0, offset_in_mm=-70, bb_size_mm=5,
                 rad_size_mm=20),
    )
    DEMO = SNC_MULTIMET

    @staticmethod
    def to_human(arrangement: dict) -> str:
        a = arrangement
        lr = "Left" if a["offset_left_mm"] >= 0 else "Right"
        ud = "Up" if a["offset_up_mm"] >= 0 else "Down"
        io = "In" if a["offset_in_mm"] >= 0 else "Out"
        return (f"'{a['name']}': {lr} {abs(a['offset_left_mm'])}mm, "
                f"{ud} {abs(a['offset_up_mm'])}mm, {io} {abs(a['offset_in_mm'])}mm")


@dataclasses.dataclass
class BBFieldMatch:
    """A matched BB and field of one image, with the EPID centre."""

    epid: Point
    field: Point
    bb: Point
    dpmm: float
    gantry_angle: float
    couch_angle: float
    sad: float

    @property
    def field_epid_vector_mm(self) -> Vector:
        v = (self.field - self.epid) / self.dpmm
        v.y = -v.y
        return v

    @property
    def bb_field_vector_mm(self) -> Vector:
        v = (self.bb - self.field) / self.dpmm
        v.y = -v.y
        return v

    @property
    def bb_epid_vector_mm(self) -> Vector:
        v = (self.bb - self.epid) / self.dpmm
        v.y = -v.y
        return v

    @property
    def bb_field_distance_mm(self) -> float:
        return self.field.distance_to(self.bb) / self.dpmm

    @property
    def bb_epid_distance_mm(self) -> float:
        return self.epid.distance_to(self.bb) / self.dpmm

    @property
    def field_epid_distance_mm(self) -> float:
        return self.epid.distance_to(self.field) / self.dpmm

    @property
    def bb_to_field_projection(self) -> Line:
        return straight_ray(self.bb_field_vector_mm, self.gantry_angle)


class BB3D:
    """A BB in 3D space, reconstructed from its 2D projections."""

    def __init__(self, bb_config: BBConfig, bb_matches: Sequence[BBFieldMatch],
                 scale: MachineScale):
        self.bb_config = bb_config
        self.matches = bb_matches
        self.scale = scale

    @cached_property
    def measured_bb_position(self) -> Point:
        v = solve_3d_position_from_2d_planes(
            xs=[m.bb_epid_vector_mm.x for m in self.matches],
            ys=[m.bb_epid_vector_mm.y for m in self.matches],
            thetas=[m.gantry_angle for m in self.matches],
            phis=[m.couch_angle for m in self.matches],
            scale=self.scale)
        return Point(x=v.x, y=v.y, z=v.z)

    @cached_property
    def nominal_bb_position(self) -> Point:
        return Point(x=-self.bb_config.offset_left_mm, y=self.bb_config.offset_in_mm,
                     z=self.bb_config.offset_up_mm)

    @cached_property
    def measured_field_position(self) -> Point:
        v = solve_3d_position_from_2d_planes(
            xs=[m.field_epid_vector_mm.x for m in self.matches],
            ys=[m.field_epid_vector_mm.y for m in self.matches],
            thetas=[m.gantry_angle for m in self.matches],
            phis=[m.couch_angle for m in self.matches],
            scale=self.scale)
        return Point(x=v.x, y=v.y, z=v.z)


class Axis(enum.Enum):
    GANTRY = "Gantry"  #:
    COLLIMATOR = "Collimator"  #:
    COUCH = "Couch"  #:
    GB_COMBO = "GB Combo"  #:
    GBP_COMBO = "GBP Combo"  #:
    EPID = "Epid"  #:
    REFERENCE = "Reference"  #:


# --------------------------------------------------------------------------
# Result models
# --------------------------------------------------------------------------
@dataclasses.dataclass(kw_only=True)
class WinstonLutz2DResult(ResultBase):
    variable_axis: str
    cax2epid_vector: dict
    cax2epid_distance: float
    cax2bb_distance: float
    cax2bb_vector: dict
    bb_location: dict
    field_cax: dict


@dataclasses.dataclass(kw_only=True)
class WinstonLutzResult(ResultBase):
    max_2d_cax_to_bb_mm: float
    median_2d_cax_to_bb_mm: float
    mean_2d_cax_to_bb_mm: float
    max_2d_cax_to_epid_mm: float
    median_2d_cax_to_epid_mm: float
    mean_2d_cax_to_epid_mm: float
    gantry_3d_iso_diameter_mm: float
    coll_2d_iso_diameter_mm: float
    couch_2d_iso_diameter_mm: float
    gantry_coll_3d_iso_diameter_mm: float
    num_total_images: int
    num_gantry_images: int
    num_coll_images: int
    num_couch_images: int
    num_gantry_coll_images: int
    max_gantry_rms_deviation_mm: float
    max_epid_rms_deviation_mm: float
    max_coll_rms_deviation_mm: float
    max_couch_rms_deviation_mm: float
    bb_shift_vector: dict
    image_details: list[WinstonLutz2DResult]
    keyed_image_details: dict[str, WinstonLutz2DResult]


@dataclasses.dataclass(kw_only=True)
class WinstonLutzMultiTargetMultiFieldResult(ResultBase):
    num_total_images: int
    max_2d_field_to_bb_mm: float
    mean_2d_field_to_bb_mm: float
    median_2d_field_to_bb_mm: float
    bb_arrangement: tuple[BBConfig, ...]
    bb_maxes: dict[str, float]
    bb_shift_vector: dict
    bb_shift_yaw: float
    bb_shift_pitch: float
    bb_shift_roll: float


# --------------------------------------------------------------------------
# 3D solvers
# --------------------------------------------------------------------------
def max_distance_to_lines(p, lines: Iterable[Line]) -> float:
    """The largest distance from the point (x, y, z) ``p`` to any of the
    lines."""
    point = Point(p[0], p[1], p[2])
    return max(line.distance_to(point) for line in lines)


def bb_projection_with_rotation(offset_left: float, offset_up: float, offset_in: float,
                                gantry: float, couch: float, sad: float = 1000,
                                machine_scale: MachineScale = MachineScale.IEC61217,
                                ) -> tuple[float, float]:
    """EPID isoplane projection of a 3D BB position: (left-right,
    superior-inferior) in mm."""
    bb_positions = np.array([offset_up, offset_left, offset_in])
    gantry_rot, _, couch_rot = convert(
        input_scale=machine_scale, output_scale=MachineScale.IEC61217,
        gantry=gantry, collimator=0, rotation=couch)
    rotation_matrix = _euler_xyz_extrinsic(-couch_rot, 0, gantry_rot)
    rotated = rotation_matrix @ bb_positions
    bb_magnification = sad / (sad - rotated[0])
    projection = np.array([rotated[1], rotated[2]]) * bb_magnification
    return -projection[0], projection[1]


def straight_ray(vector: Vector, gantry_angle: float) -> Line:
    """The straight line through the BB-field vector at the gantry angle."""
    p1 = Point()
    p2 = Point()
    p1.x = vector.x * cos(gantry_angle) + 20 * sin(gantry_angle)
    p1.z = vector.x * -sin(gantry_angle) + 20 * cos(gantry_angle)
    p1.y = vector.y
    p2.x = vector.x * cos(gantry_angle) - 20 * sin(gantry_angle)
    p2.z = vector.x * -sin(gantry_angle) - 20 * cos(gantry_angle)
    p2.y = vector.y
    return Line(p1, p2)


def _max_ray_distance(p1: torch.Tensor, d: torch.Tensor):
    """The isocentre fit's objective: the largest distance |d x (p - p1)|
    from a point to the (R, 3) rays through ``p1`` along unit ``d``, as
    XLA compiles JAX's ``jnp.cross(d, -w)`` and ``jnp.linalg.norm`` inside
    the Nelder-Mead loop on the CPU: each cross component ``a * b - c * e``
    with ``a * b`` fused and ``c * e`` rounded (the negation of ``w`` folds
    away), the squares added in a chain of fused multiply-adds, and the
    square root taken in float64 and rounded, since torch's float32 CPU
    ``sqrt`` is not always correctly rounded and XLA's is. (JAX evaluates
    the initial simplex op by op, where the other product is the rounded
    one; over 184 seeded ray sets that moved no fit.)"""
    d0, d1, d2 = d.unbind(1)

    def f(p: torch.Tensor) -> torch.Tensor:
        w0, w1, w2 = (p[None, :] - p1).unbind(1)
        c0, c1, c2 = (fma_f32(a, b, -(c * e))
                      for a, b, c, e in ((d2, w1, d1, w2), (d0, w2, d2, w0), (d1, w0, d0, w1)))
        sq = fma_f32(c2, c2, fma_f32(c1, c1, c0 * c0))
        return torch.sqrt(sq.to(torch.float64)).to(torch.float32).max()

    return f


def solve_3d_shift_vector_from_2d_planes(xs: Sequence[float], ys: Sequence[float],
                                         thetas: Sequence[float], phis: Sequence[float],
                                         scale: MachineScale) -> Vector:
    """Low et al. generalised equations 6, 7 and 9: the least-squares shift
    from the 2D planes."""
    if not (len(xs) == len(ys) == len(thetas) == len(phis)):
        raise ValueError("The x, y, theta, and phi arrays must all be the same length.")
    n = len(xs)
    f_thetas, f_phis = [], []
    for theta, phi in zip(thetas, phis):
        g, _, c = convert(scale, MachineScale.VARIAN_STANDARD, gantry=theta,
                          collimator=0, rotation=phi)
        f_thetas.append(g)
        f_phis.append(c)
    A = np.zeros((2 * n, 3))
    xi = np.zeros(2 * n)
    for i in range(n):
        A[2 * i, :] = [-cos(f_phis[i]), -sin(f_phis[i]), 0]
        A[2 * i + 1, :] = [-cos(f_thetas[i]) * sin(f_phis[i]),
                           cos(f_thetas[i]) * cos(f_phis[i]),
                           -sin(f_thetas[i])]
        xi[2 * i] = ys[i]
        xi[2 * i + 1] = -xs[i]
    B = np.linalg.pinv(A)
    long, lat, vert = B.dot(xi).squeeze()
    return Vector(x=lat, y=-long, z=vert)


def solve_3d_position_from_2d_planes(xs, ys, thetas, phis, scale) -> Vector:
    """The 3D position: the inverse of the shift vector."""
    return -solve_3d_shift_vector_from_2d_planes(xs, ys, thetas, phis, scale)


def conventional_to_euler_notation(axes_resolution: str) -> str:
    """"roll,pitch,yaw" and the like as the Euler axis letters ("yxz")."""
    euler = {"pitch": "x", "yaw": "z", "roll": "y"}
    return "".join(euler[a.strip()] for a in axes_resolution.split(","))


def _euler_extrinsic_decompose(R: np.ndarray, order: str) -> tuple[float, float, float]:
    """The extrinsic Euler angles (a, b, c) in degrees of R = Rz(c) Rx(b)
    Ry(a), the one order ``"yxz"`` that :func:`align_points` takes."""
    if order == "yxz":
        b = math.degrees(math.asin(np.clip(R[2, 1], -1, 1)))
        a = math.degrees(math.atan2(-R[2, 0], R[2, 2]))
        c = math.degrees(math.atan2(-R[0, 1], R[1, 1]))
        return a, b, c
    raise ValueError(f"Unsupported euler order {order}")


def align_points(measured_points: Sequence[Point], ideal_points: Sequence[Point],
                 axes_order: str = "roll,pitch,yaw") -> tuple[Vector, float, float, float]:
    """The rigid motion that takes the measured points onto the ideal ones
    (Kabsch, by SVD in float64): (translation, yaw, pitch, roll), the
    angles in degrees."""
    measured_array = np.array([[p.x, p.y, p.z] for p in measured_points])
    ideal_array = np.array([[p.x, p.y, p.z] for p in ideal_points])
    measured_centroid = np.mean(measured_array, axis=0)
    ideal_centroid = np.mean(ideal_array, axis=0)
    H = (measured_array - measured_centroid).T @ (ideal_array - ideal_centroid)
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt[2, :] *= -1
        R = Vt.T @ U.T
    roll, pitch, yaw = _euler_extrinsic_decompose(R, conventional_to_euler_notation(axes_order))
    translation = ideal_centroid - R @ measured_centroid
    return Vector(*translation), yaw, pitch, roll


# --------------------------------------------------------------------------
# Field centroids and the batched detection
# --------------------------------------------------------------------------
def _mass_centroids(filled: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool → (B, 2) float32 (row, col) centre of mass, float32
    sums, the mass clamped to at least 1. The sums are integers, exact in
    any order below 2**24."""
    b, h, w = filled.shape
    f = filled.to(torch.float32)
    yy = torch.arange(h, dtype=torch.float32, device=filled.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=filled.device)[None, None, :]
    mass = f.sum(dim=(1, 2)).clamp(min=1.0)
    return torch.stack([(f * yy).sum(dim=(1, 2)) / mass,
                        (f * xx).sum(dim=(1, 2)) / mass], dim=-1)


def _filled_centroid(arr: torch.Tensor, threshold: float) -> torch.Tensor:
    """(row, col) centre of mass of the hole-filled threshold mask of one
    (H, W) frame: ``fill_holes`` launches the border-flood kernel on the
    card."""
    return _mass_centroids(fill_holes(arr >= threshold)[None])[0]


def _convex_fill_centroids(masks: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool → (B, 2) centroids of the convex-filled masks: a pixel
    is inside iff a set pixel lies in all four axis directions, which equals
    ``fill_holes`` for a convex region (a field, rotated or not)."""
    m = masks.to(torch.int32)
    left = torch.cumsum(m, dim=2) > 0
    right = torch.cumsum(m.flip(2), dim=2).flip(2) > 0
    top = torch.cumsum(m, dim=1) > 0
    bottom = torch.cumsum(m.flip(1), dim=1).flip(1) > 0
    return _mass_centroids(left & right & top & bottom)


@contextlib.contextmanager
def flood_selector(mode: str):
    """Run a block with ``PYLINAC_TPU_FLOOD`` set to ``mode``, then restore
    the variable as it was."""
    old = os.environ.get("PYLINAC_TPU_FLOOD")
    os.environ["PYLINAC_TPU_FLOOD"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["PYLINAC_TPU_FLOOD"]
        else:
            os.environ["PYLINAC_TPU_FLOOD"] = old


def _filled_centroid_batch(arrs: torch.Tensor, thrs: torch.Tensor, mode: str) -> torch.Tensor:
    """Field centroids of a (B, H, W) stack at per-frame thresholds, by the
    fill that ``mode`` (``PYLINAC_TPU_FLOOD``) selects: ``"xla"`` the exact
    fill of the flood kernel, ``"packed"`` the flood kernel's centroid
    entry, anything else the convex fill."""
    masks = (arrs >= thrs[:, None, None]).contiguous()
    if mode == "xla":
        return _mass_centroids(masks | (flood_from_border_batch(masks) == 0))
    if mode == "packed":
        return filled_centroid_batch(masks)
    return _convex_fill_centroids(masks)


def _wl_detect_packed(arrs: torch.Tensor, thrs: torch.Tensor, *,
                      win: tuple[int, int, int, int], K: int, dpmm: float,
                      bb_radius_mm: float, tolerance_mm: float, invert_bb: bool,
                      mode: str) -> torch.Tensor:
    """The whole detection of a staged (B, H, W) stack on its device: field
    centroids and the windowed multi-threshold BB scan, packed (B, 2 + 1 +
    3K) so that the host fetches once. The BB half crops the central window
    ``win`` = (top, bottom, left, right), inverts it (max + min - w) when
    ``invert_bb``, stretches it to [0, 1] and runs
    :func:`~pylinac_tpu_torch.metrics.batch_find.bb_scan_core`."""
    cents = _filled_centroid_batch(arrs, thrs, mode)
    top, bottom, left, right = win
    w = arrs[:, top:bottom, left:right].to(torch.float32)
    wmin = w.amin(dim=(1, 2), keepdim=True)
    wmax = w.amax(dim=(1, 2), keepdim=True)
    if invert_bb:
        w = (wmax + wmin) - w
    # stretch(min=0, max=1): a constant window gives an all-zero window,
    # whose masks are empty: "not found", as on the host path
    w = (w - w.amin(dim=(1, 2), keepdim=True)) / torch.clamp(wmax - wmin, min=1e-30)
    cutoffs = torch.from_numpy(reference_cutoffs()).to(arrs.device)
    bb = bb_scan_core(w.contiguous(), cutoffs, K=K, dpmm=dpmm, bb_radius_mm=bb_radius_mm,
                      tolerance_mm=tolerance_mm)
    return torch.cat([cents, bb], dim=1)


# --------------------------------------------------------------------------
# Images
# --------------------------------------------------------------------------
def _zoom_z(arr2d: np.ndarray, ratio: float) -> np.ndarray:
    """Linear resample of the second axis by ``ratio`` (``scipy.ndimage.zoom``
    with ``grid_mode=True``), as ``from_cbct``'s ``zoom_z``
    (``pylinac_tpu/winston_lutz.py:879``)."""
    n_in = arr2d.shape[1]
    n_out = int(round(n_in * ratio))
    x = np.clip((np.arange(n_out) + 0.5) / ratio - 0.5, 0, n_in - 1)
    x0 = np.floor(x).astype(int)
    x1 = np.minimum(x0 + 1, n_in - 1)
    f = x - x0
    return arr2d[:, x0] * (1 - f) + arr2d[:, x1] * f


class WLBaseImage(image.LinacDicomImage):
    """A Winston-Lutz image: find the field CAX and the BB, match them to
    the nominal BB position."""

    detection_conditions: list = [is_right_size_bb, is_round, is_right_circumference,
                                  is_symmetric, is_solid]

    def __init__(self, file, use_filenames: bool = False, **kwargs):
        if conditions := kwargs.pop("detection_conditions", False):
            self.detection_conditions = conditions
        kwargs.setdefault("missing_axis_value", "raise")
        super().__init__(file, use_filenames=use_filenames, **kwargs)
        self._is_analyzed = False
        self._device = None

    def analyze(self, bb_arrangement: tuple[BBConfig, ...],
                is_open_field: bool = False, is_low_density: bool = False,
                shift_vector: Vector | None = None, snap_tolerance: float = 3,
                gantry_reference: float = 0, collimator_reference: float = 0,
                couch_reference: float = 0, bb_proximity_mm: float = 20,
                machine_scale: MachineScale = MachineScale.IEC61217,
                device=None) -> None:
        if snap_tolerance < 0:
            raise ValueError("Snap tolerance must be >= 0")
        self._device = resolve_device(device, f"{type(self).__name__}.analyze")
        self._snap_tolerance = snap_tolerance
        self._gantry_reference = gantry_reference
        self._collimator_reference = collimator_reference
        self._couch_reference = couch_reference
        self.machine_scale = machine_scale
        self._preprocess()
        self.bb_arrangement = bb_arrangement
        field_caxs = self.find_field_centroids(is_open_field=is_open_field)
        field_matches = self.find_field_matches(field_caxs, bb_proximity_mm=bb_proximity_mm)
        detected_bb_points = self.find_bb_centroids(
            bb_diameter_mm=bb_arrangement[0].bb_size_mm, low_density=is_low_density)
        if shift_vector:
            lat, sup_inf = bb_projection_with_rotation(
                offset_left=-shift_vector.x, offset_up=shift_vector.z,
                offset_in=shift_vector.y, sad=self.sad, gantry=self.gantry_angle,
                couch=self.couch_angle, machine_scale=machine_scale)
            for p in detected_bb_points:
                p.x += lat * self.dpmm
                p.y -= sup_inf * self.dpmm
        bb_matches = self.find_bb_matches(detected_points=detected_bb_points,
                                          bb_proximity_mm=bb_proximity_mm)
        if len(bb_matches) != len(field_matches):
            raise ValueError("The number of detected fields and BBs do not match")
        if not field_matches:
            raise ValueError("No fields were detected")
        if not bb_matches:
            raise ValueError(BB_ERROR_MESSAGE)
        self.arrangement_matches = {
            bb_name: BBFieldMatch(epid=self.cax, field=field_matches[bb_name], bb=bb_match,
                                  dpmm=self.dpmm, gantry_angle=self.gantry_angle,
                                  couch_angle=self.couch_angle, sad=self.sad)
            for bb_name, bb_match in bb_matches.items()}
        self._is_analyzed = True

    def _preprocess(self) -> None:
        """The WL preprocessing chain, once: histogram inversion check,
        noisy-edge crop, ground, normalise."""
        if not getattr(self, "_wl_preprocessed", False):
            self.check_inversion_by_histogram(percentiles=(0.01, 50, 99.99))
            self._clean_edges()
            self.ground()
            self.normalize()
            self._wl_preprocessed = True

    def find_field_centroids(self, is_open_field: bool) -> list[Point]:
        """Open field: the EPID centre. Otherwise the centre of mass of the
        hole-filled 50 % threshold mask, on the image's device."""
        if is_open_field:
            return [self.cax]
        pre = getattr(self, "_precomputed_field_centroid", None)
        if pre is not None:
            return [pre]
        vmin, vmax = np.percentile(self.array, [5, 99.9])
        arr = torch.from_numpy(np.asarray(self.array, np.float32)).to(self._device)
        cy, cx = _filled_centroid(arr, float(np.float32((vmax - vmin) / 2 + vmin))).tolist()
        return [Point(x=cx, y=cy)]

    def find_field_matches(self, detected_points: list[Point],
                           bb_proximity_mm: float) -> dict[str, Point]:
        return self.find_bb_matches(detected_points, bb_proximity_mm=bb_proximity_mm)

    def find_bb_centroids(self, bb_diameter_mm: float, low_density: bool) -> list[Point]:
        pre = getattr(self, "_precomputed_bb_points", None)
        if pre is not None:
            if not pre:
                raise ValueError(
                    "Couldn't find the minimum number of disks in the image. "
                    "Found 0; required: 1")
            # fresh copies: a virtual shift moves the points
            return [Point(x=p.x, y=p.y) for p in pre]
        bb_tolerance_mm = self._calculate_bb_tolerance(bb_diameter_mm)
        return self.compute(metrics=SizedDiskLocator.from_center_physical(
            expected_position_mm=(0, 0),
            search_window_mm=(40 + bb_diameter_mm, 40 + bb_diameter_mm),
            radius_mm=bb_diameter_mm / 2, radius_tolerance_mm=bb_tolerance_mm,
            invert=not low_density, detection_conditions=self.detection_conditions,
            name="BB", device=self._device))

    def find_bb_matches(self, detected_points: list[Point],
                        bb_proximity_mm: float) -> dict[str, Point]:
        bbs = {}
        for bb_arng in self.bb_arrangement:
            nominal = self.nominal_bb_position(bb_arng)
            distances = [nominal.distance_to(p) for p in detected_points]
            if not distances:
                continue
            min_distance = min(distances)
            idx = distances.index(min_distance)
            if min_distance < bb_proximity_mm * self.dpmm:
                bbs[bb_arng.name] = detected_points[idx]
        return bbs

    def nominal_bb_position(self, bb_config: BBConfig) -> Point:
        shift_x_mm, shift_y_mm = bb_projection_with_rotation(
            offset_left=bb_config.offset_left_mm, offset_up=bb_config.offset_up_mm,
            offset_in=bb_config.offset_in_mm, sad=self.sad, gantry=self.gantry_angle,
            couch=self.couch_angle, machine_scale=self.machine_scale)
        return Point(x=self.epid.x + shift_x_mm * self.dpmm,
                     y=self.epid.y - shift_y_mm * self.dpmm)

    def field_to_bb_distances(self) -> list[float]:
        return [m.bb_field_distance_mm for m in self.arrangement_matches.values()]

    def epid_to_bb_distances(self) -> list[float]:
        return [m.bb_epid_distance_mm for m in self.arrangement_matches.values()]

    @property
    def epid(self) -> Point:
        return self.cax

    def _calculate_bb_tolerance(self, bb_diameter: float) -> float:
        return float(np.interp(bb_diameter, (1.5, 30), (2, 4)))

    def to_axes(self) -> str:
        return (f"Gantry={self.gantry_angle:.1f}, Coll={self.collimator_angle:.1f}, "
                f"Couch={self.couch_angle:.1f}")

    @property
    def variable_axis(self) -> Axis:
        G0 = is_close_degrees(self.gantry_angle, self._gantry_reference, delta=self._snap_tolerance)
        B0 = is_close_degrees(self.collimator_angle, self._collimator_reference,
                              delta=self._snap_tolerance)
        P0 = is_close_degrees(self.couch_angle, self._couch_reference, delta=self._snap_tolerance)
        if G0 and B0 and not P0:
            return Axis.COUCH
        elif G0 and P0 and not B0:
            return Axis.COLLIMATOR
        elif P0 and B0 and not G0:
            return Axis.GANTRY
        elif P0 and B0 and G0:
            return Axis.REFERENCE
        elif P0:
            return Axis.GB_COMBO
        return Axis.GBP_COMBO

    def _clean_edges(self, window_size: int = 2) -> None:
        """Crop until the edges are near the background."""

        def has_noise():
            near_min, near_max = np.percentile(self.array, [5, 99.5])
            img_range = near_max - near_min
            edge = np.concatenate((
                self.array[:window_size, :].flatten(),
                self.array[:, :window_size].flatten(),
                self.array[-window_size:, :].flatten(),
                self.array[:, -window_size:].flatten()))
            return (edge.min() < (near_min - img_range / 10)
                    or edge.max() > (near_max + img_range / 10))

        safety_stop = np.min(self.shape) / 10
        while has_noise() and safety_stop > 0:
            self.crop(window_size)
            safety_stop -= 1

    def plot(self, ax=None, show: bool = True, clear_fig: bool = False, **kwargs):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        ax.imshow(self.array, cmap="gray")
        if getattr(self, "_is_analyzed", False):
            for match in self.arrangement_matches.values():
                ax.plot(match.field.x, match.field.y, "gs", ms=8, fillstyle="none")
                ax.plot(match.bb.x, match.bb.y, "ro", ms=8, fillstyle="none")
        if show:
            plt.show()
        return ax


@capture_warnings
class WinstonLutz2D(WLBaseImage, ResultsDataMixin):
    """A single Winston-Lutz EPID image."""

    def analyze(self, bb_size_mm: float = 5, low_density_bb: bool = False,
                open_field: bool = False, shift_vector: Vector | None = None,
                snap_tolerance: float = 3, gantry_reference: float = 0,
                collimator_reference: float = 0, couch_reference: float = 0,
                bb_proximity_mm: float = 20,
                machine_scale: MachineScale = MachineScale.IEC61217,
                device: str | torch.device | None = None) -> None:
        """Find the field centre and the BB on ``device`` (``None`` means
        CUDA)."""
        bb_config = BBArrangement.ISO
        bb_config[0].bb_size_mm = bb_size_mm
        super().analyze(bb_arrangement=bb_config, is_open_field=open_field,
                        is_low_density=low_density_bb, shift_vector=shift_vector,
                        snap_tolerance=snap_tolerance, gantry_reference=gantry_reference,
                        collimator_reference=collimator_reference,
                        couch_reference=couch_reference, bb_proximity_mm=bb_proximity_mm,
                        machine_scale=machine_scale, device=device)
        self.bb_arrangement = bb_config
        self.field_cax = self.arrangement_matches["Iso"].field
        self.bb = self.arrangement_matches["Iso"].bb

    def __repr__(self):
        return (f"WLImage(gantry={self.gantry_angle:.1f}, "
                f"coll={self.collimator_angle:.1f}, couch={self.couch_angle:.1f})")

    @property
    def cax2bb_vector(self) -> Vector:
        dist = (self.bb - self.field_cax) / self.dpmm
        return Vector(dist.x, dist.y, dist.z)

    @property
    def cax2bb_distance(self) -> float:
        return self.field_cax.distance_to(self.bb) / self.dpmm

    @property
    def cax2epid_vector(self) -> Vector:
        dist = (self.epid - self.field_cax) / self.dpmm
        return Vector(dist.x, dist.y, dist.z)

    @property
    def cax2epid_distance(self) -> float:
        return self.field_cax.distance_to(self.epid) / self.dpmm

    def _generate_results_data(self) -> WinstonLutz2DResult:
        if not self._is_analyzed:
            raise ValueError("The image is not analyzed. Use .analyze() first.")
        return WinstonLutz2DResult(
            variable_axis=self.variable_axis.value,
            cax2bb_vector=self.cax2bb_vector.dict(),
            cax2epid_vector=self.cax2epid_vector.dict(),
            cax2bb_distance=self.cax2bb_distance,
            cax2epid_distance=self.cax2epid_distance,
            bb_location=self.bb.dict(),
            field_cax=self.field_cax.dict(),
        )


@capture_warnings
class WinstonLutz(ResultsDataMixin, QuaacMixin):
    """Winston-Lutz analysis of a set of images."""

    images: list[WinstonLutz2D]
    image_type = WinstonLutz2D
    is_from_cbct: bool = False
    _virtual_shift: str | None = None
    detection_conditions: list = [is_right_size_bb, is_round, is_right_circumference,
                                  is_symmetric, is_solid]

    def __init__(self, directory, use_filenames: bool = False,
                 axis_mapping: dict | None = None, axes_precision: int | None = None,
                 dpi: float | None = None, sid: float | None = None,
                 missing_axis_value="raise"):
        self.images = []
        if axis_mapping and not use_filenames:
            for filename, (gantry, coll, couch) in axis_mapping.items():
                self.images.append(self._load_image(
                    Path(directory) / filename, sid=sid, dpi=dpi, gantry=gantry,
                    coll=coll, couch=couch, axes_precision=axes_precision,
                    missing_axis_value=missing_axis_value))
        elif isinstance(directory, list):
            for file in directory:
                self.images.append(self._load_image(
                    file, dpi=dpi, sid=sid, use_filenames=use_filenames,
                    axes_precision=axes_precision, missing_axis_value=missing_axis_value))
        elif not osp.isdir(directory):
            raise ValueError("Invalid directory passed.")
        else:
            files = sorted(p for p in Path(directory).rglob("*") if p.is_file())
            for file in files:
                try:
                    self.images.append(self._load_image(
                        file, dpi=dpi, sid=sid, use_filenames=use_filenames,
                        axes_precision=axes_precision, missing_axis_value=missing_axis_value))
                except Exception:
                    continue  # not a WL DICOM image: skipped, as in the JAX class
        if len(self.images) < 2:
            raise ValueError("<2 valid WL images were found in the folder/file.")
        self.images.sort(key=lambda i: (i.gantry_angle, i.collimator_angle, i.couch_angle))
        self._is_analyzed = False
        self._device = None
        self._axis_fits: dict = {}

    def _load_image(self, file, sid, dpi, **kwargs) -> WinstonLutz2D:
        extra = {}
        if sid is not None:
            extra["sid"] = sid
        if dpi is not None:
            extra["dpi"] = dpi
        img = self.image_type(str(file), **kwargs, **extra)
        img.detection_conditions = self.detection_conditions
        return img

    @classmethod
    def from_zip(cls, zfile, **kwargs):
        """The image set in a zip archive (extracted to a temporary folder
        while the images load)."""
        with TemporaryZipDirectory(zfile) as tmpz:
            return cls(tmpz, **kwargs)

    @classmethod
    def from_cbct_zip(cls, file, raw_pixels: bool = False, **kwargs):
        """:meth:`from_cbct` of a zipped CBCT series."""
        with TemporaryZipDirectory(file) as tmpz:
            return cls.from_cbct(tmpz, raw_pixels=raw_pixels, **kwargs)

    @classmethod
    def from_cbct(cls, directory, raw_pixels: bool = False, **kwargs):
        """A four-view test from a CBCT scan of a BB: maximum intensity
        projections seen from the left, top, right and bottom (gantry 270,
        0, 90 and 180), the z axis resampled to the pixel spacing, built on
        the host. Sets ``is_from_cbct``, so that :meth:`analyze` takes a
        low-density BB in an open field."""
        stack = image.DicomImageStack(directory, min_number=10, raw_pixels=raw_pixels)
        np_stack = np.stack([im.array for im in stack.images], axis=-1)
        ratio = float(stack.metadata.SliceThickness) / float(stack.metadata.PixelSpacing[0])
        left_arr = np.rot90(_zoom_z(np_stack.max(axis=0), ratio), k=1)
        top_arr = np.rot90(_zoom_z(np_stack.max(axis=1), ratio), k=1)
        right_arr = np.fliplr(left_arr)
        bottom_arr = np.fliplr(top_arr)
        dpi = 25.4 / float(stack.metadata.PixelSpacing[0])
        with tempfile.TemporaryDirectory() as dicom_dir:
            for array, gantry in zip((left_arr, top_arr, right_arr, bottom_arr),
                                     (270, 0, 90, 180)):
                ds = array_to_dicom(np.ascontiguousarray(array), sid=1000, gantry=gantry,
                                    coll=0, couch=0, dpi=dpi)
                dcm.dcmwrite(Path(dicom_dir) / f"G={gantry}.dcm", ds)
            instance = cls(dicom_dir, **kwargs)
        instance.is_from_cbct = True
        return instance

    def analyze(self, bb_size_mm: float = 5,
                machine_scale: MachineScale = MachineScale.IEC61217,
                low_density_bb: bool = False, open_field: bool = False,
                apply_virtual_shift: bool = False, snap_tolerance: float = 3,
                gantry_reference: float = 0, collimator_reference: float = 0,
                couch_reference: float = 0, bb_proximity_mm: float = 20,
                device: str | torch.device | None = None) -> None:
        """Analyse the image set on ``device`` (``None`` means CUDA). A set
        made from a CBCT scan always takes a low-density BB in an open
        field."""
        self._device = resolve_device(device, "WinstonLutz.analyze")
        self.machine_scale = machine_scale
        self._axis_fits = {}
        if self.is_from_cbct:
            low_density_bb = True
            open_field = True
        if not (not open_field and self._batch_detect(bb_size_mm, low_density_bb)):
            if not open_field:
                self._batch_field_centroids()
            self._batch_bb_centroids(bb_size_mm=bb_size_mm, low_density=low_density_bb)
        image_kwargs = dict(bb_size_mm=bb_size_mm, low_density_bb=low_density_bb,
                            open_field=open_field, snap_tolerance=snap_tolerance,
                            gantry_reference=gantry_reference,
                            collimator_reference=collimator_reference,
                            couch_reference=couch_reference, machine_scale=machine_scale,
                            device=self._device)
        for img in self.images:
            img.analyze(bb_proximity_mm=bb_proximity_mm, **image_kwargs)
        bb_config = BBArrangement.ISO[0]
        bb_config.bb_size_mm = bb_size_mm
        self.bb = BB3D(bb_config=bb_config,
                       bb_matches=[img.arrangement_matches["Iso"] for img in self.images],
                       scale=self.machine_scale)
        if apply_virtual_shift:
            shift = self.bb_shift_vector
            self._virtual_shift = self.bb_shift_instructions()
            for img in self.images:
                img.analyze(shift_vector=shift, **image_kwargs)
            self.bb = BB3D(bb_config=bb_config,
                           bb_matches=[img.arrangement_matches["Iso"] for img in self.images],
                           scale=self.machine_scale)
        self._is_analyzed = True
        self._bb_diameter = bb_size_mm

    def _stage(self, groups: list[list[WinstonLutz2D]]) -> list:
        """Stage each group's preprocessed frames as one (B, H, W) float32
        tensor, with their field thresholds, on the analysis device; kept in
        ``_field_stage_cache`` while the device stays the same."""
        staged = []
        for shaped in groups:
            arrs, thrs = [], []
            for img in shaped:
                vmin, vmax = np.percentile(img.array, [5, 99.9])
                arrs.append(np.asarray(img.array, np.float32))
                thrs.append((vmax - vmin) / 2 + vmin)
            staged.append((shaped, torch.from_numpy(np.stack(arrs)).to(self._device),
                           torch.tensor(thrs, dtype=torch.float32, device=self._device)))
        self._field_stage_cache = staged
        self._field_stage_device = self._device
        return staged

    def _staged(self):
        if getattr(self, "_field_stage_device", None) != self._device:
            return None
        return getattr(self, "_field_stage_cache", None)

    def _batch_field_centroids(self) -> None:
        """Preprocess every image, then compute all field centroids in one
        batched fill per frame shape on the device (the fill that
        ``PYLINAC_TPU_FLOOD`` selects). The preprocessed frames and their
        thresholds are staged once."""
        self._ensure_preprocessed()
        staged = self._staged()
        if staged is None:
            groups: dict[tuple, list] = {}
            for img in self.images:
                groups.setdefault(tuple(img.array.shape), []).append(img)
            staged = self._stage(list(groups.values()))
        mode = os.environ.get("PYLINAC_TPU_FLOOD", "")
        for shaped, stack, thrs in staged:
            cents = _filled_centroid_batch(stack, thrs, mode).cpu().numpy()
            for img, c in zip(shaped, cents):
                img._precomputed_field_centroid = Point(x=float(c[1]), y=float(c[0]))

    def _ensure_preprocessed(self) -> None:
        """Apply the per-image preprocessing chain once (the batched passes
        and ``WLBaseImage.analyze`` share this state)."""
        for img in self.images:
            img._preprocess()

    def _batch_detect(self, bb_size_mm: float, low_density: bool) -> bool:
        """The whole detection, field centroids and BB scan, for the image
        set in one pass on the device and one fetch
        (:func:`_wl_detect_packed`). Returns False when the set cannot be
        batched (custom detection conditions, mixed dpmm or frame shapes);
        the caller then takes the two separate passes."""
        default = WLBaseImage.detection_conditions
        if any(list(img.detection_conditions) != list(default) for img in self.images):
            return False
        dpmms = {round(float(img.dpmm), 6) for img in self.images}
        if len(dpmms) != 1:
            return False
        self._ensure_preprocessed()
        shapes = {tuple(img.array.shape) for img in self.images}
        if len(shapes) != 1:
            return False
        cache_key = (round(float(bb_size_mm), 6), bool(low_density))
        cached = getattr(self, "_bb_scan_cache", None)
        if cached is not None and cached[0] == cache_key:
            # the BB detections are cached; only the field half runs
            for img, pts in zip(self.images, cached[1]):
                img._precomputed_bb_points = pts
            self._batch_field_centroids()
            return True
        staged = self._staged()
        if staged is None:
            staged = self._stage([list(self.images)])
        if len(staged) != 1 or len(staged[0][0]) != len(self.images):
            return False
        _, stack, thrs = staged[0]
        H, W = stack.shape[1:]
        dpmm = float(self.images[0].dpmm)
        # the window of SizedDiskRegion.calculate (centre, expected (0, 0)),
        # clamped to the frame
        sw = (40 + bb_size_mm) * dpmm
        left = max(math.floor(W / 2 - sw / 2), 0)
        right = min(math.ceil(W / 2 + sw / 2), W)
        top = max(math.floor(H / 2 - sw / 2), 0)
        bottom = min(math.ceil(H / 2 + sw / 2), H)
        K = 24
        tol_mm = self.images[0]._calculate_bb_tolerance(bb_size_mm)
        packed = _wl_detect_packed(
            stack, thrs, win=(top, bottom, left, right), K=K, dpmm=dpmm,
            bb_radius_mm=float(bb_size_mm) / 2, tolerance_mm=float(tol_mm),
            invert_bb=not low_density,
            mode=os.environ.get("PYLINAC_TPU_FLOOD", "")).cpu().numpy()
        all_pts = []
        for img, row in zip(self.images, packed):
            img._precomputed_field_centroid = Point(x=float(row[1]), y=float(row[0]))
            bb = row[2:]
            kept = bb[1:1 + K].astype(bool)
            wr = bb[1 + K:1 + 2 * K]
            wc = bb[1 + 2 * K:1 + 3 * K]
            pts = ([Point(x=float(c) + left, y=float(r) + top)
                    for r, c, k in zip(wr, wc, kept) if k]
                   if bool(bb[0]) else [])
            img._precomputed_bb_points = pts
            all_pts.append(pts)
        self._bb_scan_cache = (cache_key, all_pts)
        return True

    def _batch_bb_centroids(self, bb_size_mm: float, low_density: bool) -> None:
        """The windowed multi-threshold BB search for all images in one
        batched scan per window shape
        (:func:`~pylinac_tpu_torch.metrics.batch_find.batched_bb_windows`);
        the results are cached on each image. Custom detection conditions
        and mixed dpmm take the per-image search instead."""
        default = WLBaseImage.detection_conditions
        if any(list(img.detection_conditions) != list(default) for img in self.images):
            return
        dpmms = {round(float(img.dpmm), 6) for img in self.images}
        if len(dpmms) != 1:
            return
        cache_key = (round(float(bb_size_mm), 6), bool(low_density))
        cached = getattr(self, "_bb_scan_cache", None)
        if cached is not None and cached[0] == cache_key:
            # detections do not depend on a virtual shift (it moves copies)
            for img, pts in zip(self.images, cached[1]):
                img._precomputed_bb_points = pts
            return
        self._ensure_preprocessed()
        dpmm = float(self.images[0].dpmm)
        windows, offsets = [], []
        for img in self.images:
            # the window of SizedDiskRegion.calculate, not clamped to the
            # frame's far edges (the slice clamps)
            sw = (40 + bb_size_mm) * dpmm
            cx = img.shape[1] / 2
            cy = img.shape[0] / 2
            left = max(math.floor(cx - sw / 2), 0)
            right = math.ceil(cx + sw / 2)
            top = max(math.floor(cy - sw / 2), 0)
            bottom = math.ceil(cy + sw / 2)
            windows.append(np.asarray(img.array)[top:bottom, left:right])
            offsets.append((top, left))
        tol_mm = self.images[0]._calculate_bb_tolerance(bb_size_mm)
        found = batched_bb_windows(windows, dpmm, bb_size_mm / 2, tol_mm,
                                   invert=not low_density, device=self._device)
        all_pts = []
        for img, pts, (top, left) in zip(self.images, found, offsets):
            img._precomputed_bb_points = [Point(x=c + left, y=r + top) for r, c in pts]
            all_pts.append(img._precomputed_bb_points)
        self._bb_scan_cache = (cache_key, all_pts)

    def _minimize_axis(self, axes=(Axis.GANTRY,)):
        """The point of least maximum distance to the BB-field rays of the
        images of ``axes`` (and the reference), by Nelder-Mead on CPU
        tensors; cached until the next ``analyze``."""
        if isinstance(axes, Axis):
            axes = (axes,)
        key = tuple(axes)
        if key in self._axis_fits:
            return self._axis_fits[key]
        rays = [img.arrangement_matches["Iso"].bb_to_field_projection
                for img in self.images
                if img.variable_axis in (axes + (Axis.REFERENCE,))]
        if len(rays) <= 1:
            raise ValueError(
                "Not enough images of the given type to identify the axis isocenter")
        p1 = np.array([[ln.point1.x, ln.point1.y, ln.point1.z] for ln in rays], np.float32)
        p2 = np.array([[ln.point2.x, ln.point2.y, ln.point2.z] for ln in rays], np.float32)
        d = p2 - p1
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p1t = torch.from_numpy(p1)
        dt = torch.from_numpy(d)
        x, fx = nelder_mead(_max_ray_distance(p1t, dt), torch.zeros(3, dtype=torch.float32),
                            xatol=1e-5, fatol=1e-6, max_iter=600)
        result = SimpleNamespace(x=x.numpy(), fun=float(fx))
        self._axis_fits[key] = result
        return result

    @property
    def gantry_iso_size(self) -> float:
        num = self._get_images((Axis.GANTRY, Axis.REFERENCE))[0]
        if num > 1:
            return self._minimize_axis(Axis.GANTRY).fun * 2
        return 0

    @property
    def gantry_coll_iso_size(self) -> float:
        num = self._get_images((Axis.GANTRY, Axis.COLLIMATOR, Axis.GB_COMBO, Axis.REFERENCE))[0]
        if num > 1:
            return self._minimize_axis((Axis.GANTRY, Axis.COLLIMATOR, Axis.GB_COMBO)).fun * 2
        return 0

    @staticmethod
    def _find_max_distance_between_points(images) -> float:
        points = [Point(img.cax2bb_vector.x, img.cax2bb_vector.y) for img in images]
        return max(p1.distance_to(p2) for p1 in points for p2 in points)

    @property
    def collimator_iso_size(self) -> float:
        num, imgs = self._get_images((Axis.COLLIMATOR, Axis.REFERENCE))
        if num > 1:
            return self._find_max_distance_between_points(imgs)
        return 0

    @property
    def couch_iso_size(self) -> float:
        num, imgs = self._get_images((Axis.COUCH, Axis.REFERENCE))
        if num > 1:
            return self._find_max_distance_between_points(imgs)
        return 0

    def _get_images(self, axis=(Axis.GANTRY,)) -> tuple[int, list]:
        if isinstance(axis, Axis):
            axis = (axis,)
        images = [img for img in self.images if img.variable_axis in axis]
        return len(images), images

    @property
    def bb_shift_vector(self) -> Vector:
        return self.bb.measured_field_position - self.bb.measured_bb_position

    def bb_shift_instructions(self, couch_vrt: float | None = None,
                              couch_lng: float | None = None,
                              couch_lat: float | None = None) -> str:
        sv = self.bb_shift_vector
        x_dir = "LEFT" if sv.x < 0 else "RIGHT"
        y_dir = "IN" if sv.y > 0 else "OUT"
        z_dir = "UP" if sv.z > 0 else "DOWN"
        move = (f"{x_dir} {abs(sv.x):2.2f}mm; {y_dir} {abs(sv.y):2.2f}mm; "
                f"{z_dir} {abs(sv.z):2.2f}mm")
        if all(v is not None for v in [couch_vrt, couch_lat, couch_lng]):
            new_lat = round(couch_lat + sv.x / 10, 2)
            new_vrt = round(couch_vrt + sv.z / 10, 2)
            new_lng = round(couch_lng + sv.y / 10, 2)
            move += (f"\nNew couch coordinates (cm): VRT: {new_vrt:3.2f}; "
                     f"LNG: {new_lng:3.2f}; LAT: {new_lat:3.2f}")
        return move

    def axis_rms_deviation(self, axis=Axis.GANTRY, value: str = "all"):
        if isinstance(axis, Iterable) and not isinstance(axis, (str, Axis)):
            axis = tuple(convert_to_enum(ax, Axis) for ax in axis)
        else:
            axis = convert_to_enum(axis, Axis)
        if axis != Axis.EPID:
            attr = "cax2bb_vector"
        else:
            attr = "cax2epid_vector"
            axis = (Axis.GANTRY, Axis.COLLIMATOR, Axis.REFERENCE)
        imgs = self._get_images(axis=axis)[1]
        if len(imgs) <= 1:
            return (0,)
        rms = [getattr(img, attr).as_scalar() for img in imgs]
        if value == "range":
            rms = max(rms) - min(rms)
        return rms

    def cax2bb_distance(self, metric: str = "max") -> float:
        distances = []
        for img in self.images:
            distances.extend(img.field_to_bb_distances())
        if metric == "max":
            return max(distances)
        elif metric == "median":
            return statistics.median(distances)
        elif metric == "mean":
            return statistics.mean(distances)
        raise ValueError(f"Unknown metric {metric}")

    def cax2epid_distance(self, metric: str = "max") -> float:
        distances = [img.cax2epid_distance for img in self.images]
        if metric == "max":
            return max(distances)
        elif metric == "median":
            return statistics.median(distances)
        elif metric == "mean":
            return statistics.mean(distances)
        raise ValueError(f"Unknown metric {metric}")

    def results(self, as_list: bool = False) -> str | list[str]:
        num_gantry = self._get_images((Axis.GANTRY, Axis.REFERENCE))[0]
        num_coll = self._get_images((Axis.COLLIMATOR, Axis.REFERENCE))[0]
        num_couch = self._get_images((Axis.COUCH, Axis.REFERENCE))[0]
        results = [
            "Winston-Lutz Analysis",
            "=====================",
            f"Number of images: {len(self.images)}",
            f"Maximum 2D CAX->BB distance: {self.cax2bb_distance('max'):.2f}mm",
            f"Median 2D CAX->BB distance: {self.cax2bb_distance('median'):.2f}mm",
            f"Mean 2D CAX->BB distance: {self.cax2bb_distance('mean'):.2f}mm",
            f"Shift to iso: facing gantry, move BB: {self.bb_shift_instructions()}",
            f"Gantry 3D isocenter diameter: {self.gantry_iso_size:.2f}mm ({num_gantry}/{len(self.images)} images considered)",
            f"Maximum Gantry RMS deviation (mm): {max(self.axis_rms_deviation(Axis.GANTRY)):.2f}mm",
            f"Maximum EPID RMS deviation (mm): {max(self.axis_rms_deviation(Axis.EPID)):.2f}mm",
            f"Gantry+Collimator 3D isocenter diameter: {self.gantry_coll_iso_size:.2f}mm",
            f"Collimator 2D isocenter diameter: {self.collimator_iso_size:.2f}mm ({num_coll}/{len(self.images)} images considered)",
            f"Maximum Collimator RMS deviation (mm): {max(self.axis_rms_deviation(Axis.COLLIMATOR)):.2f}",
            f"Couch 2D isocenter diameter: {self.couch_iso_size:.2f}mm ({num_couch}/{len(self.images)} images considered)",
            f"Maximum Couch RMS deviation (mm): {max(self.axis_rms_deviation(Axis.COUCH)):.2f}",
        ]
        if self._virtual_shift:
            results.insert(3, f"Virtual shift applied: {self._virtual_shift}")
        if not as_list:
            return "\n".join(results)
        return results

    def _generate_results_data(self) -> WinstonLutzResult:
        num_gantry = self._get_images((Axis.GANTRY, Axis.REFERENCE))[0]
        num_coll = self._get_images((Axis.COLLIMATOR, Axis.REFERENCE))[0]
        num_couch = self._get_images((Axis.COUCH, Axis.REFERENCE))[0]
        num_gantry_coll = self._get_images(
            (Axis.GANTRY, Axis.COLLIMATOR, Axis.GB_COMBO, Axis.REFERENCE))[0]
        individual_results = [img._generate_results_data() for img in self.images]
        keyed = {
            f"G{img.gantry_angle:g}B{img.collimator_angle:g}P{img.couch_angle:g}": res
            for img, res in zip(self.images, individual_results)}
        return WinstonLutzResult(
            num_total_images=len(self.images),
            num_gantry_images=num_gantry,
            num_coll_images=num_coll,
            num_couch_images=num_couch,
            num_gantry_coll_images=num_gantry_coll,
            max_2d_cax_to_bb_mm=self.cax2bb_distance("max"),
            median_2d_cax_to_bb_mm=self.cax2bb_distance("median"),
            mean_2d_cax_to_bb_mm=self.cax2bb_distance("mean"),
            max_2d_cax_to_epid_mm=self.cax2epid_distance("max"),
            median_2d_cax_to_epid_mm=self.cax2epid_distance("median"),
            mean_2d_cax_to_epid_mm=self.cax2epid_distance("mean"),
            coll_2d_iso_diameter_mm=self.collimator_iso_size,
            couch_2d_iso_diameter_mm=self.couch_iso_size,
            gantry_3d_iso_diameter_mm=self.gantry_iso_size,
            gantry_coll_3d_iso_diameter_mm=self.gantry_coll_iso_size,
            max_gantry_rms_deviation_mm=max(self.axis_rms_deviation(Axis.GANTRY)),
            max_coll_rms_deviation_mm=max(self.axis_rms_deviation(Axis.COLLIMATOR)),
            max_couch_rms_deviation_mm=max(self.axis_rms_deviation(Axis.COUCH)),
            max_epid_rms_deviation_mm=max(self.axis_rms_deviation(Axis.EPID)),
            bb_shift_vector=self.bb_shift_vector.dict(),
            image_details=individual_results,
            keyed_image_details=keyed,
        )

    # -- reports (JAX winston_lutz.py:1333-1520) -----------------------------
    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        return {
            "Max 2D CAX->BB distance": QuaacDatum(value=self.cax2bb_distance("max"), unit="mm"),
            "Median 2D CAX->BB distance": QuaacDatum(value=self.cax2bb_distance("median"), unit="mm"),
            "Gantry 3D isocenter diameter": QuaacDatum(value=self.gantry_iso_size, unit="mm"),
            "Collimator 2D isocenter diameter": QuaacDatum(value=self.collimator_iso_size, unit="mm"),
            "Couch 2D isocenter diameter": QuaacDatum(value=self.couch_iso_size, unit="mm"),
        }

    def plot_images(self, show: bool = True, **kwargs):
        """Every image with its field and BB marks, four to a row."""
        import matplotlib.pyplot as plt

        n = len(self.images)
        cols = min(4, n)
        rows = int(np.ceil(n / cols))
        fig, axes = plt.subplots(rows, cols, figsize=(cols * 3, rows * 3))
        for ax, img in zip_longest(np.atleast_1d(axes).ravel(), self.images):
            if img is None:
                ax.axis("off")
                continue
            img.plot(ax=ax, show=False)
        if show:
            plt.show()
        return fig, axes

    def plot_summary(self, show: bool = True, **kwargs):
        return self.plot_images(show=show, **kwargs)

    def plot_axis_images(self, axis=Axis.GANTRY, show: bool = True, ax=None):
        """The first image of ``axis`` with the BB and field marks of every
        image of that axis (and the reference images) over it."""
        import matplotlib.pyplot as plt

        axis = convert_to_enum(axis, Axis)
        images = [img for img in self.images
                  if img.variable_axis in (axis, Axis.REFERENCE)]
        if not images:
            raise ValueError(f"No images found for axis {axis}")
        if ax is None:
            _, ax = plt.subplots()
        images[0].plot(ax=ax, show=False)
        for img in images:
            for match in img.arrangement_matches.values():
                ax.plot(match.bb.x, match.bb.y, "r+", markersize=8)
                ax.plot(match.field.x, match.field.y, "bx", markersize=8)
        ax.set_title(f"{axis.value} images")
        if show:
            plt.show()
        return ax

    def plot_location(self, show: bool = True, viewbox_mm: float | None = None,
                      plot_bb: bool = True, plot_isocenter_sphere: bool = True,
                      plot_couch_iso: bool = True, plot_coll_iso: bool = True,
                      show_legend: bool = True):
        """The BBs and the gantry isocentre sphere in 3D, the isocentre at
        the origin."""
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        limit = viewbox_mm or max(3.0, 2 * self.cax2bb_distance("max") + 2)
        if plot_bb:
            for bb in getattr(self, "bbs", []):
                m = bb.measured_position
                ax.scatter(m.x, m.y, m.z, color="green", label="BB")
        if plot_isocenter_sphere:
            u, v = np.mgrid[0: 2 * np.pi: 20j, 0: np.pi: 10j]
            try:
                r = self.gantry_iso_size / 2
            except NotImplementedError:
                r = 0
            ax.plot_wireframe(r * np.cos(u) * np.sin(v), r * np.sin(u) * np.sin(v),
                              r * np.cos(v), color="blue", alpha=0.3,
                              label="Gantry iso")
        ax.set_xlim(-limit, limit)
        ax.set_ylim(-limit, limit)
        ax.set_zlim(-limit, limit)
        ax.set_xlabel("X (mm), LEFT (+)")
        ax.set_ylabel("Y (mm), IN (+)")
        ax.set_zlabel("Z (mm), UP (+)")
        if show_legend:
            ax.legend()
        if show:
            plt.show()
        return fig, ax

    def plotly_analyzed_images(self, show: bool = True, show_colorbar: bool = True,
                               show_legend: bool = True, **kwargs):
        """Plotly-schema figures (:mod:`.core.plotly_utils`): one per image
        with its field and BB marks, and the isocentre in 3D:
        ``{name: Figure}``."""
        from .core import plotly_utils as pu

        if not self._is_analyzed:
            raise RuntimeError("The images must be analyzed first. Use .analyze().")
        figs: dict[str, pu.Figure] = {}
        for idx, img in enumerate(self.images):
            fig = pu.image_figure(img.array, title=str(img.to_axes()),
                                  show_colorbar=show_colorbar, **kwargs)
            for match in img.arrangement_matches.values():
                fig.add_trace(pu.marker_trace(
                    [match.field.x], [match.field.y], name="Field CAX",
                    symbol="square-open", color="green", showlegend=show_legend))
                fig.add_trace(pu.marker_trace(
                    [match.bb.x], [match.bb.y], name="BB",
                    symbol="circle-open", color="red", showlegend=show_legend))
            figs[f"{idx} - {img.to_axes()}"] = fig

        iso_fig = pu.Figure()
        for bb in getattr(self, "bbs", []):
            m = bb.measured_position
            iso_fig.add_trace({
                "type": "scatter3d", "x": [m.x], "y": [m.y], "z": [m.z],
                "mode": "markers", "name": "BB",
                "marker": {"color": "green", "size": 4}})
        try:
            r = self.gantry_iso_size / 2
            u, v = np.mgrid[0:2 * np.pi:20j, 0:np.pi:10j]
            iso_fig.add_trace({
                "type": "surface",
                "x": r * np.cos(u) * np.sin(v),
                "y": r * np.sin(u) * np.sin(v),
                "z": r * np.cos(v),
                "opacity": 0.2, "showscale": False, "name": "Isocenter sphere"})
        except (NotImplementedError, ValueError):
            pass
        pu.add_title(iso_fig, "Isocenter Visualization")
        iso_fig.update_layout(showlegend=show_legend)
        figs["Isocenter Visualization"] = iso_fig
        if show:
            for f in figs.values():
                f.show()
        return figs

    def save_images(self, prefix: str = "", **kwargs) -> list[str]:
        """Each image's plot as a PNG file named by its file name (or the
        image's ``id`` where it has none); the names written."""
        import matplotlib.pyplot as plt

        names = []
        for img in self.images:
            fig, ax = plt.subplots()
            img.plot(ax=ax, show=False)
            name = f"{prefix}{img.base_path if hasattr(img, 'base_path') else id(img)}.png"
            fig.savefig(name, **kwargs)
            plt.close(fig)
            names.append(name)
        return names

    def save_images_to_stream(self, **kwargs) -> dict:
        """Each image's plot as PNG in a ``BytesIO``, keyed by its axes and
        index."""
        import io as _io

        import matplotlib.pyplot as plt

        streams = {}
        for idx, img in enumerate(self.images):
            fig, ax = plt.subplots()
            img.plot(ax=ax, show=False)
            stream = _io.BytesIO()
            fig.savefig(stream, **kwargs)
            plt.close(fig)
            title = (f"G{img.gantry_angle:.0f}, C{img.collimator_angle:.0f}, "
                     f"P{img.couch_angle:.0f} ({idx})")
            streams[title] = stream
        return streams

    def save_summary(self, filename, **kwargs) -> None:
        """The summary plot written to ``filename``."""
        import matplotlib.pyplot as plt

        fig, _ = self.plot_summary(show=False)
        fig.savefig(filename, **kwargs)
        plt.close(fig)

    def publish_pdf(self, filename, notes=None, open_file: bool = False,
                    metadata: dict | None = None, logo=None) -> None:
        """The results as a one-page PDF (:mod:`.core.pdf`); needs no
        matplotlib."""
        from .core import pdf

        canvas = pdf.PylinacCanvas(filename, page_title="Winston-Lutz Analysis",
                                   metadata=metadata, logo=logo)
        canvas.add_text(text=self.results(as_list=True), location=(2, 25.5), font_size=11)
        if notes is not None:
            canvas.add_text(text=notes, location=(2, 4))
        canvas.finish()


class WinstonLutzMultiTargetMultiFieldImage(WLBaseImage):
    """A Winston-Lutz image of several fields and BBs."""

    detection_conditions = [is_round, is_modest_size, is_symmetric]

    def find_field_centroids(self, is_open_field: bool) -> list[Point]:
        """Every field at once, by one :class:`GlobalSizedFieldLocator`
        sized to the mean of the arrangement's largest and smallest field,
        its tolerance spanning their range (at least 10 % of that size)."""
        if is_open_field:
            return [self.cax]
        sizes = [bb.rad_size_mm for bb in self.bb_arrangement]
        mean_size = (max(sizes) + min(sizes)) / 2
        tolerance = max((max(sizes) - min(sizes)) * 1.2, 0.1 * mean_size)
        return self.compute(metrics=GlobalSizedFieldLocator.from_physical(
            field_width_mm=mean_size, field_height_mm=mean_size,
            field_tolerance_mm=tolerance, max_number=len(self.bb_arrangement),
            device=self._device))

    def find_bb_centroids(self, bb_diameter_mm: float, low_density: bool) -> list[Point]:
        """Each BB of the arrangement searched in a window of 40 mm plus its
        size around its projection (no machine scale, as in the JAX class);
        a BB not found is skipped."""
        centers = []
        for bb in self.bb_arrangement:
            bb_tolerance_mm = self._calculate_bb_tolerance(bb.bb_size_mm)
            left, sup = bb_projection_with_rotation(
                offset_left=bb.offset_left_mm, offset_up=bb.offset_up_mm,
                offset_in=bb.offset_in_mm, gantry=self.gantry_angle,
                couch=self.couch_angle, sad=self.sad)
            try:
                centers.extend(self.compute(metrics=SizedDiskLocator.from_center_physical(
                    # -sup: image rows run down, the WL superior axis up
                    expected_position_mm=Point(x=left, y=-sup),
                    search_window_mm=(40 + bb.bb_size_mm, 40 + bb.bb_size_mm),
                    radius_mm=bb.bb_size_mm / 2, radius_tolerance_mm=bb_tolerance_mm / 2,
                    invert=not low_density, detection_conditions=self.detection_conditions,
                    device=self._device)))
            except ValueError:
                pass
        return centers


@capture_warnings
class WinstonLutzMultiTargetMultiField(WinstonLutz):
    """Winston-Lutz analysis of a phantom of several BBs, each in its own
    field. Each image finds its fields over the whole frame and its BBs in
    windows around their projections; a BB seen in at least two images
    gets a 3D position."""

    image_type = WinstonLutzMultiTargetMultiFieldImage
    bb_arrangement: tuple[BBConfig, ...]
    bbs: list[BB3D]

    def analyze(self, bb_arrangement: tuple[BBConfig, ...], is_open_field: bool = False,
                is_low_density: bool = False,
                machine_scale: MachineScale = MachineScale.IEC61217,
                snap_tolerance: float = 3,
                device: str | torch.device | None = None) -> None:
        """Analyse the images on ``device`` (``None`` means CUDA)."""
        self._device = resolve_device(device, f"{type(self).__name__}.analyze")
        self.machine_scale = machine_scale
        self.bb_arrangement = bb_arrangement
        for img in self.images:
            img.analyze(bb_arrangement=bb_arrangement, is_open_field=is_open_field,
                        is_low_density=is_low_density, snap_tolerance=snap_tolerance,
                        machine_scale=machine_scale, device=self._device)
        self.bbs = []
        for arrangement in bb_arrangement:
            matches = [img.arrangement_matches[arrangement.name] for img in self.images
                       if arrangement.name in img.arrangement_matches]
            if len(matches) >= 2:
                self.bbs.append(BB3D(bb_config=arrangement, bb_matches=matches,
                                     scale=machine_scale))
        self._is_analyzed = True

    def max_bb_deviation_2d(self, bb_name: str) -> float:
        for bb in self.bbs:
            if bb.bb_config.name == bb_name:
                return max(m.bb_field_distance_mm for m in bb.matches)
        raise ValueError(f"No BB arrangement named {bb_name}")

    @property
    def bb_maxes(self) -> dict[str, float]:
        return {bb.bb_config.name: self.max_bb_deviation_2d(bb.bb_config.name)
                for bb in self.bbs}

    @property
    def bb_shift_vector(self) -> tuple[Vector, float, float, float]:
        """The phantom's 6DOF alignment: the measured BB positions onto the
        measured field positions, as (translation, yaw, pitch, roll)."""
        measured = [bb.measured_bb_position for bb in self.bbs]
        ideal = [bb.measured_field_position for bb in self.bbs]
        return align_points(measured, ideal)

    def bb_shift_instructions(self) -> str:
        vector, yaw, _, _ = self.bb_shift_vector
        x_dir = "LEFT" if vector.x < 0 else "RIGHT"
        y_dir = "IN" if vector.y > 0 else "OUT"
        z_dir = "UP" if vector.z > 0 else "DOWN"
        return (f"{x_dir} {abs(vector.x):2.2f}mm; {y_dir} {abs(vector.y):2.2f}mm; "
                f"{z_dir} {abs(vector.z):2.2f}mm; Rotation {yaw:2.2f}°")

    def results(self, as_list: bool = False) -> str | list[str]:
        results = [
            "Winston-Lutz Multi-Target Multi-Field Analysis",
            "==============================================",
            f"Number of images: {len(self.images)}",
            "",
            "2D distances",
            "============",
            f"Max 2D distance of any BB->Field: {self.cax2bb_distance('max'):.2f} mm",
            f"Mean 2D distance of any BB->Field: {self.cax2bb_distance('mean'):.2f} mm",
            f"Median 2D distance of any BB->Field: {self.cax2bb_distance('median'):.2f} mm",
        ]
        for name, value in self.bb_maxes.items():
            results.append(f"Max 2D distance of BB {name}: {value:.2f} mm")
        return results if as_list else "\n".join(results)

    def _generate_results_data(self) -> WinstonLutzMultiTargetMultiFieldResult:
        vector, yaw, pitch, roll = self.bb_shift_vector
        return WinstonLutzMultiTargetMultiFieldResult(
            num_total_images=len(self.images),
            max_2d_field_to_bb_mm=self.cax2bb_distance("max"),
            mean_2d_field_to_bb_mm=self.cax2bb_distance("mean"),
            median_2d_field_to_bb_mm=self.cax2bb_distance("median"),
            bb_arrangement=self.bb_arrangement,
            bb_maxes=self.bb_maxes,
            bb_shift_vector=vector.dict(),
            bb_shift_yaw=yaw,
            bb_shift_pitch=pitch,
            bb_shift_roll=roll,
        )

    def _quaac_datapoints(self) -> dict[str, QuaacDatum]:
        return {
            "Max 2D BB->Field distance": QuaacDatum(value=self.cax2bb_distance("max"), unit="mm"),
            "Mean 2D BB->Field distance": QuaacDatum(value=self.cax2bb_distance("mean"), unit="mm"),
        }
