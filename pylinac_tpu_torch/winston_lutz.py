"""Winston-Lutz isocentre QA on the card.

Port of ``pylinac_tpu/winston_lutz.py``: the rotation helpers (``:59-85``),
``BBConfig`` (``:91``, a dataclass), ``BBArrangement.ISO`` (``:107``),
``BBFieldMatch`` (``:132``), ``BB3D`` (``:179``), ``Axis`` (``:215``), the
result models (``:228-261``, dataclasses), ``bb_projection_with_rotation``
(``:286``), ``straight_ray`` (``:304``), the Low et al. solvers
(``:318-349``), the field-centroid fills (``:432-494``),
``_wl_detect_packed`` (``:500``), ``WLBaseImage`` (``:534``),
``WinstonLutz2D`` (``:723``) and ``WinstonLutz`` (``:785``).

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

Not ported: ``WinstonLutzMultiTargetMultiField`` and its image class,
``align_points`` and the multi-BB arrangements; ``from_cbct``,
``from_cbct_zip``, zip, URL and demo loading; plots, the PDF, plotly and
QuAAC; warning capture into ``results_data().warnings``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import math
import os
import os.path as osp
import statistics
from functools import cached_property
from pathlib import Path
from types import SimpleNamespace
from typing import Iterable, Sequence

import numpy as np
import torch

from .core import image
from .core.geometry import Line, Point, Vector, cos, sin
from .core.scale import MachineScale, convert
from .core.utilities import DataModel, ResultBase, convert_to_enum, resolve_device
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
from .metrics.image import SizedDiskLocator
from .ops.flood import filled_centroid_batch, flood_from_border_batch
from .ops.label import fill_holes
from .ops.optimize import nelder_mead

__all__ = ["Axis", "BB3D", "BBArrangement", "BBConfig", "BBFieldMatch", "WLBaseImage",
           "WinstonLutz", "WinstonLutz2D", "WinstonLutz2DResult", "WinstonLutzResult",
           "bb_projection_with_rotation", "is_modest_size", "is_near_center",
           "is_right_square_size", "is_square", "solve_3d_position_from_2d_planes",
           "solve_3d_shift_vector_from_2d_planes", "straight_ray"]

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
    """Preset BB arrangements: the single BB at the isocentre."""

    ISO = (BBConfig(name="Iso", offset_left_mm=0, offset_up_mm=0, offset_in_mm=0,
                    bb_size_mm=5, rad_size_mm=20),)


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


# --------------------------------------------------------------------------
# 3D solvers
# --------------------------------------------------------------------------
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


class WinstonLutz2D(WLBaseImage):
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

    def results_data(self, as_dict: bool = False, as_json: bool = False):
        """The typed :class:`WinstonLutz2DResult`; ``as_dict`` gives the
        JSON-compatible dict the JAX package returns, ``as_json`` JSON."""
        return self._generate_results_data().output(as_dict, as_json)


class WinstonLutz:
    """Winston-Lutz analysis of a set of images."""

    images: list[WinstonLutz2D]
    image_type = WinstonLutz2D
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

    def analyze(self, bb_size_mm: float = 5,
                machine_scale: MachineScale = MachineScale.IEC61217,
                low_density_bb: bool = False, open_field: bool = False,
                apply_virtual_shift: bool = False, snap_tolerance: float = 3,
                gantry_reference: float = 0, collimator_reference: float = 0,
                couch_reference: float = 0, bb_proximity_mm: float = 20,
                device: str | torch.device | None = None) -> None:
        """Analyse the image set on ``device`` (``None`` means CUDA)."""
        self._device = resolve_device(device, "WinstonLutz.analyze")
        self.machine_scale = machine_scale
        self._axis_fits = {}
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

        def objective(p):
            cross = torch.linalg.cross(dt, -(p[None, :] - p1t), dim=1)
            return torch.linalg.norm(cross, dim=1).max()

        x, fx = nelder_mead(objective, torch.zeros(3, dtype=torch.float32), xatol=1e-5,
                            fatol=1e-6, max_iter=600)
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

    def results_data(self, as_dict: bool = False, as_json: bool = False):
        """The typed :class:`WinstonLutzResult`; ``as_dict`` gives the
        JSON-compatible dict the JAX package returns, ``as_json`` JSON."""
        return self._generate_results_data().output(as_dict, as_json)
